"""Stream sinks: collection, CSV file, print, latency-measuring and the
exactly-once transactional sinks.

Counterparts of the reference's result sinks: StringResultCollectorSink
(sncb/tests/MobilityQueryRunner.java), per-query CSV file sinks
(MobilityRunner.java:40-66), and the Kafka latency sinks
(HelperClass.LatencySink*, HelperClass.java:455-529). Host code only, the
JAX package's ``streams/sinks.py`` line for line: ``TransactionalFileSink``
commits through the ``sink.write`` fault point (``partial_write``
included), ``MultiSink`` through ``dag.commit``.
"""

from __future__ import annotations

import os
import time
from typing import Any, Callable, Dict, List, Optional

from spatialflink_tpu_torch.faults import InjectedFault, faults


class CollectSink:
    """Collect results in memory (tests and runners)."""

    def __init__(self):
        self.items: List[Any] = []

    def __call__(self, item: Any):
        self.items.append(item)

    def __len__(self):
        return len(self.items)


class PrintSink:
    def __init__(self, prefix: str = ""):
        self.prefix = prefix
        self.count = 0

    def __call__(self, item: Any):
        print(f"{self.prefix}{item}")
        self.count += 1


class CsvFileSink:
    """Write one formatted line per record, flushing each write (the
    reference's file sinks flush per record for benchmark fidelity,
    com/mn/sinks/CountingLatencyFileSink.java:23-70)."""

    def __init__(
        self,
        path: str,
        formatter: Callable[[Any], str] = str,
        header: Optional[str] = None,
        flush_every: int = 1,
    ):
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        self.path = path
        self.formatter = formatter
        self.flush_every = max(1, flush_every)
        self._f = open(path, "w")
        if header:
            self._f.write(header.rstrip("\n") + "\n")
        self.count = 0

    def __call__(self, item: Any):
        self._f.write(self.formatter(item) + "\n")
        self.count += 1
        if self.count % self.flush_every == 0:
            self._f.flush()

    def close(self):
        self._f.flush()
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class TransactionalFileSink:
    """Exactly-once epoch egress — the sink half of the pipeline
    checkpoint (driver.py).

    The reference inherits Flink's two-phase-commit sinks but never
    enables checkpointing (SURVEY §5), so its egress is effectively
    fire-and-forget. Here records **stage in memory** per window epoch
    (``stage``/``__call__``) and become durable only at ``commit()``:
    one append + flush + fsync, after which the committed byte/record
    marker is returned for the driver to embed in the SAME checkpoint as
    the operator/ingest snapshot. The recovery invariant that makes this
    exactly-once rather than at-least-once:

    - a crash BEFORE commit loses only staged records — the resumed run
      replays their windows and regenerates them;
    - a crash DURING/AFTER the append but BEFORE the checkpoint publish
      leaves a tail past the last checkpointed marker — ``restore()``
      truncates it, and the replay regenerates those records too;

    so the concatenated egress of any kill/resume sequence is
    byte-identical to an uninterrupted run: no gap, no duplicate, at the
    sink and not just the source (``tests/test_torch_driver.py`` asserts
    this for every threaded injection point).

    ``reset()`` starts a fresh file (+ optional header); ``restore()``
    resumes from a checkpointed marker. One of them must run before the
    first commit — the driver picks based on whether a checkpoint was
    loaded; standalone users get an implicit ``reset()``.
    """

    def __init__(self, path: str, formatter: Callable[[Any], str] = str,
                 header: Optional[str] = None):
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        self.path = path
        self.formatter = formatter
        self.header = header
        self._pending: List[str] = []
        self.committed_bytes = 0
        self.committed_records = 0
        self.commits = 0
        self._initialized = False

    # -- staging ---------------------------------------------------------------

    def stage(self, record: Any) -> None:
        """Buffer one record for the NEXT commit (nothing touches disk)."""
        self._pending.append(self.formatter(record))

    __call__ = stage  # drop-in for the repo's callable-sink convention

    @property
    def pending(self) -> int:
        return len(self._pending)

    # -- epoch lifecycle -------------------------------------------------------

    def reset(self) -> None:
        """Fresh run: truncate to empty, write the header, fsync."""
        with open(self.path, "wb") as f:
            if self.header:
                f.write(self.header.rstrip("\n").encode() + b"\n")
            f.flush()
            os.fsync(f.fileno())
            self.committed_bytes = f.tell()
        self.committed_records = 0
        self._pending = []
        self._initialized = True

    def restore(self, state: Dict[str, Any]) -> None:
        """Resume from a checkpointed marker: any bytes past it are an
        uncommitted tail from a crashed epoch — truncate them (the replay
        regenerates those records). A file SHORTER than the marker means
        committed egress was lost out-of-band: corrupt, fail loudly."""
        from spatialflink_tpu_torch.checkpoint import CheckpointCorruptError

        committed = int(state["bytes"])
        try:
            size = os.path.getsize(self.path)
        except OSError:
            size = -1
        if size == -1 and committed == 0:
            # Nothing was ever committed and the file is gone — an empty
            # epoch crashed before its first commit. Recreate empty.
            open(self.path, "wb").close()
            size = 0
        if size < committed:
            raise CheckpointCorruptError(
                self.path,
                f"egress file with >= {committed} committed bytes",
                f"{size if size >= 0 else 'no file'} — committed sink "
                "output was deleted or truncated out-of-band",
            )
        if size > committed:
            with open(self.path, "r+b") as f:
                f.truncate(committed)
                f.flush()
                os.fsync(f.fileno())
        self.committed_bytes = committed
        self.committed_records = int(state.get("records", 0))
        self._pending = []
        self._initialized = True

    def commit(self) -> Dict[str, int]:
        """Durably append every staged record; return the new committed
        marker (for the driver's checkpoint). Crash-safe at any instant:
        the marker only advances after the fsync returns, and a torn
        append past an OLD marker is exactly what ``restore()`` repairs.
        """
        if not self._initialized:
            # The implicit fresh start of a standalone sink keeps the
            # records staged before it (the JAX sink's reset() drops
            # them: ROADMAP Queue C6).
            staged = self._pending
            self.reset()
            self._pending = staged
        data = b"".join(line.encode() + b"\n" for line in self._pending)
        with open(self.path, "r+b") as f:
            f.seek(self.committed_bytes)
            if faults.armed:  # chaos injection point (faults.py)
                action = faults.hit("sink.write")
                if action == "partial_write":
                    # Cooperative torn append: half the bytes land (and
                    # are even fsync'd — durably torn), then the crash.
                    f.write(data[: max(len(data) // 2, 1)])
                    f.truncate()
                    f.flush()
                    os.fsync(f.fileno())
                    raise InjectedFault("sink.write", "partial_write")
            f.write(data)
            f.truncate()  # clear any stale tail from a repaired crash
            f.flush()
            os.fsync(f.fileno())
        self.committed_bytes += len(data)
        self.committed_records += len(self._pending)
        self.commits += 1
        self._pending = []
        return self.state()

    def state(self) -> Dict[str, int]:
        """The committed marker embedded in pipeline checkpoints."""
        return {"bytes": self.committed_bytes,
                "records": self.committed_records}

    def close(self) -> None:
        """Commit any staged tail (a convenience for non-checkpointed
        use; checkpointed drivers commit through their own cadence)."""
        if self._pending:
            self.commit()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        # Deliberately NOT committing on an exception path: staged
        # records of a failed epoch must be lost, not published.
        if exc[0] is None:
            self.close()


class MultiSink:
    """N named :class:`TransactionalFileSink`\\ s committed as ONE unit —
    the egress half of the DAG's atomic unit checkpoint (``dag.py``).

    Each node of a composed dataflow stages into its own sub-sink;
    ``commit()`` durably appends every sub-sink's staged records IN NAME
    ORDER and returns the combined marker map, which the driver embeds
    in the SAME checkpoint as every node's operator state. A crash
    between two sub-commits (the ``dag.commit`` injection point fires
    before EACH sub-append) leaves the earlier sinks with a tail past
    their last checkpointed marker and the later ones without —
    ``restore()`` truncates the former and leaves the latter, and the
    replay regenerates both, so kill-anywhere still yields byte-
    identical egress on EVERY sink. A sink file SHORTER than its marker
    (committed egress lost out-of-band, or a marker from a FUTURE
    checkpoint generation) stays loud: the sub-sink's restore raises
    ``CheckpointCorruptError`` naming the file.
    """

    def __init__(self, sinks: "Dict[str, TransactionalFileSink]"):
        #: name → sub-sink, committed in sorted-name order (the
        #: deterministic order the between-commit cut contract rides).
        self.sinks = dict(sinks)

    def __getitem__(self, name: str) -> TransactionalFileSink:
        return self.sinks[name]

    def stage(self, name: str, record: Any) -> None:
        self.sinks[name].stage(record)

    @property
    def pending(self) -> int:
        return sum(s.pending for s in self.sinks.values())

    def reset(self) -> None:
        for name in sorted(self.sinks):
            self.sinks[name].reset()

    def restore(self, state: Dict[str, Any]) -> None:
        """Resume every sub-sink from the checkpointed marker map. A
        sink the checkpoint has no marker for (a node added since) gets
        a fresh ``reset()`` — its whole history replays."""
        markers = state["sinks"]
        for name in sorted(self.sinks):
            if name in markers:
                self.sinks[name].restore(markers[name])
            else:
                self.sinks[name].reset()

    def commit(self) -> Dict[str, Any]:
        """The unit commit: every sub-sink's staged records append
        durably, in sorted-name order, each behind the ``dag.commit``
        injection point — then the combined marker map returns for the
        driver's checkpoint. Any crash mid-sequence is repaired by
        ``restore()`` exactly like a single sink's torn append."""
        out: Dict[str, Any] = {}
        for name in sorted(self.sinks):
            if faults.armed:  # chaos injection point (faults.py)
                faults.hit("dag.commit")
            out[name] = self.sinks[name].commit()
        return {"sinks": out}

    def state(self) -> Dict[str, Any]:
        return {"sinks": {name: s.state()
                          for name, s in sorted(self.sinks.items())}}

    def close(self) -> None:
        for name in sorted(self.sinks):
            self.sinks[name].close()


class LatencySink:
    """Record per-item latency = now − event/ingestion time.

    ``time_fn(item)`` extracts the reference instant in seconds.
    The reference's Kafka latency sinks compute now − ingestionTime
    (HelperClass.java:455-529)."""

    def __init__(self, time_fn: Callable[[Any], float]):
        self.time_fn = time_fn
        self.latencies_ms: List[float] = []

    def __call__(self, item: Any):
        t = self.time_fn(item)
        if t is not None:
            self.latencies_ms.append((time.time() - t) * 1000.0)

    def percentile(self, q: float) -> float:
        if not self.latencies_ms:
            return 0.0
        import numpy as np

        return float(np.percentile(self.latencies_ms, q))
