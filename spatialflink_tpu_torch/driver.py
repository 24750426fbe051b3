"""Self-healing windowed-dataflow driver: the one shared run loop.

The operators' ``run`` loops go through this driver, which owns:

- **window iteration** over the operator's event-time assembler (object
  windows through ``_assembler()``, SoA windows through a supplied
  assembler), with the checkpoint hooks of ``operators/base.py``
  (``_adopt_assembler``) wired in;
- **auto-checkpoint cadence**: every ``checkpoint_every`` fired windows
  the transactional sink's staged records are durably appended first,
  then the operator, assembler and source position and the sink's
  committed marker publish atomically as one checkpoint
  (``checkpoint.py``'s framed format): the exactly-once egress protocol
  (``streams/sinks.py:TransactionalFileSink``);
- **bounded retry with backoff** on transient device and ingest errors
  (``RetryPolicy``), each retry a ``driver_retry`` telemetry instant;
- **graceful degradation**: when retries run out and a ``fallback``
  window processor exists (the numpy twins of the range, kNN, join and
  tStats operators), the driver fails over for the rest of the run,
  emitting a ``failover`` instant and counting it in
  ``telemetry.snapshot()["driver"]``. The twins compute op by op on the
  same centred float32 coordinates, so results do not change across the
  switch;
- **pipelined windows**: a device process that offers the split protocol
  (``pipeline_compute`` / ``pipeline_fetch``) overlaps window N+1's
  ship with window N's fetch under a ``pipeline.PipelinePolicy``,
  drained to a consistent frontier before every checkpoint;
- **overload control** (``overload=``, an
  ``overload.OverloadController``): bounded admission with backpressure
  or counted shedding on every pulled item, the device-path circuit
  breaker (whole windows to the twin while it is open, a half-open probe
  on a bounded schedule, the device path back when it succeeds), and the
  controller's state published with each checkpoint, so a resume replays
  the exact shed schedule. ``None`` (the default) changes nothing.

Resume contract: each checkpoint records ``events_consumed``; a resume
with a replayable source (a file or a collection: the same record
sequence again) skips that many events and continues mid-window from the
restored assembler state. The concatenated egress of kill → resume is
byte-identical to an uninterrupted run, and to the JAX package's driver
over the same stream (``tests/test_torch_driver.py``).

``python -m spatialflink_tpu_torch.driver --chaos-smoke`` is the
self-test: a toy pipeline run clean, then killed by an armed ``abort``
fault (``os._exit(137)``, the SIGKILL analog) and resumed, with the
egress of the two compared byte for byte. It runs on the card unless
``--device cpu`` is given.
"""

from __future__ import annotations

import contextlib
import itertools
import os
import time
from collections import deque
from dataclasses import dataclass
from typing import Any, Callable, Dict, Iterable, Iterator, Optional

from spatialflink_tpu_torch.checkpoint import (
    CheckpointCorruptError,
    load_checkpoint,
    operator_state,
    restore_operator,
    save_checkpoint,
)
from spatialflink_tpu_torch.faults import faults
from spatialflink_tpu_torch.telemetry import telemetry


@dataclass(frozen=True)
class RetryPolicy:
    """Bounded retry with backoff for a failed window processor.

    ``max_retries`` extra attempts after the first failure; the backoff
    sleeps ``backoff_s * multiplier**attempt`` between them. Retries are
    for transient device and ingest errors; a deterministic error uses
    up the budget fast and moves on to failover or the crash path.

    ``sleep`` is the injectable clock: ``None`` means ``time.sleep``; a
    test passes a recorder to pin the backoff schedule without sleeping.
    """

    max_retries: int = 2
    backoff_s: float = 0.05
    multiplier: float = 2.0
    sleep: Optional[Callable[[float], None]] = None

    def do_sleep(self, seconds: float) -> None:
        (self.sleep if self.sleep is not None else time.sleep)(seconds)


def _dial_timeout_exit(code: int) -> None:
    """The dial watchdog's process kill (a test seam). A real timeout
    must ``os._exit``: the card may be wedged inside a call that neither
    an exception nor atexit can interrupt."""
    os._exit(code)  # pragma: no cover - replaced by tests


DIAL_TIMEOUT_EXIT_CODE = 3  # the bench's dial-failure exit code


def _seal_stream_dial_timeout(label: str) -> None:
    """Seal an armed ledger stream with reason ``dial_timeout`` without
    ever blocking the watchdog. A thread hung inside a device call does
    not hold telemetry's lock, so the seal goes through telemetry's own
    writer; if the lock is held (a host-side wedge, say a dead filesystem
    mid-flush) the bounded acquire gives up and the epilogue is appended
    to the stream file directly. Best effort either way: a dying process
    must exit, sealed or not."""
    import json

    got = telemetry._lock.acquire(timeout=2.0)
    try:
        if got:
            telemetry.seal_stream("dial_timeout")
            return
        path = telemetry.stream_path
        if not path or not os.path.exists(path) \
                or getattr(telemetry, "_stream_sealed", False):
            return
        with open(path, "a") as f:
            f.write(json.dumps({
                "t": "epilogue", "unix": time.time(),
                "reason": "dial_timeout",
                "sealed_by": "driver-watchdog", "label": label,
            }) + "\n")
            f.flush()
            os.fsync(f.fileno())
    except Exception:  # the seal is best effort on a dying process
        pass
    finally:
        if got:
            telemetry._lock.release()


def resolve_dial_deadline_s(explicit=None) -> float:
    """The driver's dial budget: an explicit construction value wins, else
    ``SFT_DIAL_DEADLINE_S`` when set, else disabled (0), so a test never
    races a global timer."""
    if explicit is not None:
        return float(explicit)
    spec = os.environ.get("SFT_DIAL_DEADLINE_S")
    return float(spec) if spec else 0.0


def strict_driver() -> "WindowedDataflowDriver":
    """The driver an operator constructs when the caller passes none: no
    retries, no failover, no checkpoint. Its windows and its errors are
    the plain loop's: a device-path exception propagates at once and
    nothing completes on the numpy twin. Self-healing is opt-in: pass a
    configured :class:`WindowedDataflowDriver` to ``run(..., driver=)``."""
    return WindowedDataflowDriver(
        retry=RetryPolicy(max_retries=0), failover=False,
    )


class WindowedDataflowDriver:
    """The shared run loop. Typical construction::

        driver = WindowedDataflowDriver(
            checkpoint_path="ckpt.bin", checkpoint_every=4, sink=txn_sink
        )
        for res in op.run(stream, ..., driver=driver):  # operator binds
            for line in render(res):
                txn_sink.stage(line)   # commits with the NEXT checkpoint

    Operators bind themselves with :meth:`bind` (``run`` does it).
    Constructing a driver yourself is the opt-in to self-healing:
    retries default to 2 and failover to on.
    """

    def __init__(self, *, checkpoint_path: Optional[str] = None,
                 checkpoint_every: int = 1,
                 sink=None,
                 retry: Optional[RetryPolicy] = None,
                 extra_state: Optional[Callable[[], Dict[str, Any]]] = None,
                 skip_on_resume: bool = True,
                 flush_at_end: bool = True,
                 failover: bool = True,
                 overload=None,
                 source_pausable: Optional[bool] = None,
                 pipeline=None,
                 dial_deadline_s: Optional[float] = None):
        self.checkpoint_path = checkpoint_path
        self.checkpoint_every = max(1, int(checkpoint_every))
        self.sink = sink
        self.retry = retry if retry is not None else RetryPolicy()
        self.extra_state = extra_state
        self.skip_on_resume = skip_on_resume
        self.flush_at_end = flush_at_end
        #: ``failover=False`` is strict mode: retries still apply, but a
        #: dead device path crashes (for a resume) instead of degrading.
        self.failover = failover
        #: Optional ``overload.OverloadController``: admission on every
        #: item this driver pulls, the circuit breaker in
        #: ``_process_window`` and its state in each checkpoint. ``None``
        #: (the default, ``strict_driver`` included) changes nothing.
        self.overload = overload
        #: Whether the source can absorb backpressure (its data is safe
        #: at the source). ``None`` follows ``skip_on_resume``: replayable
        #: sources pause, the others shed.
        self.source_pausable = (bool(skip_on_resume)
                                if source_pausable is None
                                else bool(source_pausable))
        #: Optional ``pipeline.PipelinePolicy``: overlapped processing for
        #: device processes with the split protocol, up to ``fetch_lag``
        #: windows in flight, drained before every checkpoint. ``None``
        #: falls back to the module policy (``SFT_PIPELINE``); with
        #: neither, the loop is synchronous.
        self.pipeline = pipeline
        #: The bounded first device touch: the first device-path window
        #: after construction or resume runs under a watchdog that kills
        #: the process (sealing the ledger stream ``dial_timeout``) when
        #: it outlasts the deadline.
        self.dial_deadline_s = resolve_dial_deadline_s(dial_deadline_s)
        self._dialed = False
        self.op = None
        self._node_label: Optional[str] = None  # set by bind()
        self.process: Optional[Callable] = None
        self.fallback: Optional[Callable] = None
        self.backend = "device"
        self.loaded_checkpoint: Optional[Dict[str, Any]] = None
        self.stats = {
            "windows": 0, "events": 0, "retries": 0, "failovers": 0,
            "checkpoints": 0, "resumed": False,
        }
        self._since_ckpt = 0
        self._consumed = 0
        self._skip = 0
        # Window ends finished since the last commit: the "commit" stage
        # stamps them when the sink or checkpoint publishes. Only kept
        # while a sink or checkpoint exists.
        self._pending_commit: list = []

    # -- binding / resume ------------------------------------------------------

    def attach(self, op) -> "WindowedDataflowDriver":
        """Attach the operator and load and restore an existing checkpoint
        (operator state, assembler, egress marker, resume position,
        backend). Callable before any device staging: an operator reads
        ``self.backend`` afterwards and skips building the device path
        when the restored run had already failed over."""
        if self.op is not op:
            self.op = op
            self._load()
        return self

    def bind(self, op, process: Optional[Callable],
             fallback: Optional[Callable] = None
             ) -> "WindowedDataflowDriver":
        """Attach (if :meth:`attach` has not) and set the per-window
        processors: ``process`` the device path (None when the restored
        backend is the fallback and the caller skipped building it),
        ``fallback`` the numpy route used after a failover."""
        self.attach(op)
        self._node_label = (getattr(op, "telemetry_node", None)
                            or type(op).__name__)
        self.process = process
        self.fallback = fallback if self.failover else None
        if self.backend == "fallback" and self.fallback is None:
            raise ValueError(
                f"checkpoint {self.checkpoint_path!r} was taken after a "
                "failover to the fallback backend, but this driver has "
                "no fallback bound (failover=False, or the operator "
                "provides none) — resume with a failover-enabled driver "
                "on a fallback-capable operator, or delete the "
                "checkpoint to recompute from the source"
            )
        if self.backend == "device" and self.process is None:
            raise ValueError("bind() needs a device process while "
                             "backend == 'device'")
        return self

    def _load(self) -> None:
        if not (self.checkpoint_path and os.path.exists(self.checkpoint_path)):
            # Fresh run: the sink's truncate-and-restart waits until the
            # loop starts, so a driver rejected before running leaves a
            # previous run's committed egress alone.
            self._sink_fresh = True
            return
        ck = load_checkpoint(self.checkpoint_path)
        restore_operator(self.op, ck["op"])
        drv = ck.get("driver", {})
        if self.skip_on_resume:
            self._skip = int(drv.get("events_consumed", 0))
        self._consumed = int(drv.get("events_consumed", 0))
        self.stats["windows"] = int(drv.get("windows", 0))
        self.backend = drv.get("backend", "device")
        if self.sink is not None and hasattr(self.sink, "restore"):
            if "egress" in ck:
                self.sink.restore(ck["egress"])
            else:
                self.sink.reset()
        if self.overload is not None and "overload" in ck:
            # Shed decisions are a function of the controller state and
            # the stream: the restored state replays the shed schedule of
            # an uninterrupted run past the skip point.
            self.overload.restore(ck["overload"])
        self.stats["resumed"] = True
        self.loaded_checkpoint = ck

    # -- the loop --------------------------------------------------------------

    def run(self, source: Iterable) -> Iterator:
        """Drive ``source`` through the operator's event-time assembler;
        yield one result per fired window. Checkpoints fall at window
        boundaries between events; a crash anywhere resumes from the last
        published checkpoint."""
        asm = self.op._adopt_assembler(self.op._assembler())
        yield from self._drive(source, asm.feed,
                               asm.flush if self.flush_at_end else None)

    def run_soa(self, chunks: Iterable, asm) -> Iterator:
        """SoA form of :meth:`run`: ``chunks`` feed the supplied
        ``streams/soa.py`` assembler (point or ragged); positions count
        chunks."""
        self.op._adopt_soa_assembler(asm)
        yield from self._drive(chunks, asm.feed,
                               asm.flush if self.flush_at_end else None)

    def run_windows(self, windows: Iterable) -> Iterator:
        """Pre-built window batches (count windows): retry and failover
        apply, but there is no event position to checkpoint, so a
        configured ``checkpoint_path`` is rejected."""
        if self.checkpoint_path:
            raise ValueError(
                "run_windows cannot checkpoint (no event-stream position "
                "to record) — use run()/run_soa() for resumable pipelines"
            )
        self._reset_fresh_sink()
        with self._installed_controller():
            pipe = self._pipeline_state()
            for win in windows:
                yield from self._pipe_process(pipe, win)
            yield from self._pipe_drain(pipe)
            self._commit_sink_only()

    def _reset_fresh_sink(self) -> None:
        if getattr(self, "_sink_fresh", False):
            self._sink_fresh = False
            if self.sink is not None and hasattr(self.sink, "reset"):
                self.sink.reset()

    def run_precomputed(self, windows: Iterable) -> Iterator:
        """Deterministically recomputable window items (the pane-scan
        engines, ``TJoinQuery.run_soa_panes``): the checkpointed position
        counts windows, and a resume, after the caller recomputes the
        upstream scan over the replayed bounded stream, skips the
        committed prefix. Admission control does not apply: these items
        are fired windows, not ingest, and shedding one would drop
        results, not load."""
        yield from self._drive(windows, lambda w: [w], None, admit=False)

    @contextlib.contextmanager
    def _installed_controller(self):
        """The driver's controller is the process-global one for the run
        (the fire-site hooks and rung getters read the module slot). A
        controller installed before the run is put back when the loop
        ends; otherwise the driver's stays installed, so the ledger seal
        and a post-run SLO verdict read the run's real counters."""
        from spatialflink_tpu_torch import overload as overload_mod

        prev = overload_mod.controller()
        if self.overload is not None and prev is not self.overload:
            overload_mod.install(self.overload)
        try:
            yield
        finally:
            if (self.overload is not None and prev is not None
                    and prev is not self.overload):
                overload_mod.install(prev)

    def _drive(self, source, feed, flush, admit: bool = True) -> Iterator:
        self._reset_fresh_sink()
        with self._installed_controller():
            # A source may declare its own backpressure capability; the
            # driver's setting is the fallback.
            pausable = getattr(source, "pausable", None)
            if pausable is None:
                pausable = self.source_pausable
            it = iter(source)
            if self._skip:
                # Resume: the first `events_consumed` records are already
                # in the restored assembler and operator state.
                next(itertools.islice(it, self._skip - 1, self._skip), None)
                self._skip = 0
            pipe = self._pipeline_state()
            for item in it:
                if faults.armed:  # fault injection point (faults.py)
                    faults.hit("source.stall")
                self._consumed += 1
                self.stats["events"] += 1
                if admit and self.overload is not None and not \
                        self.overload.admit_item(item, pausable=pausable):
                    # Shed: the item never reaches the assembler but
                    # counts as consumed, so a resume sheds the same items.
                    self.stats["shed"] = self.stats.get("shed", 0) + 1
                    continue
                fired = feed(item)
                for win in fired:
                    yield from self._pipe_process(pipe, win)
                if fired and self._since_ckpt >= self.checkpoint_every:
                    # Drain to a consistent frontier first: every in-flight
                    # window is yielded (its egress staged) before the
                    # checkpoint counts it, so after a crash a window is
                    # committed or replayed, never half.
                    yield from self._pipe_drain(pipe)
                    self._commit()
            if flush is not None:
                for win in flush():
                    yield from self._pipe_process(pipe, win)
            yield from self._pipe_drain(pipe)
            self._commit(final=True)

    # -- bounded first device touch (the dial watchdog) ------------------------

    @contextlib.contextmanager
    def _dial_guard(self, device_path: bool):
        """A bounded watchdog around the run's first device-path window.
        On the deadline it seals an armed ledger stream with reason
        ``dial_timeout`` and kills the process with the dial exit code.
        Disarmed (no deadline, already dialed, fallback path) it costs an
        attribute check."""
        import threading

        if not device_path or self._dialed or self.dial_deadline_s <= 0:
            yield
            return
        ok = threading.Event()
        deadline = float(self.dial_deadline_s)

        def _watchdog():
            if not ok.wait(deadline):
                if ok.is_set():  # lost the race at the boundary
                    return
                _seal_stream_dial_timeout("driver first device window")
                import sys

                print(
                    "driver: first device window hung > "
                    f"{float(deadline):.0f} s (SFT_DIAL_DEADLINE_S) — "
                    "device unreachable; ledger stream sealed "
                    "dial_timeout", file=sys.stderr,
                )
                sys.stderr.flush()
                _dial_timeout_exit(DIAL_TIMEOUT_EXIT_CODE)

        t = threading.Thread(target=_watchdog, daemon=True)
        t.start()
        try:
            yield
            self._dialed = True
        finally:
            ok.set()

    # -- pipelined window processing (pipeline.py) -----------------------------

    def _pipeline_state(self) -> Optional[Dict[str, Any]]:
        """Pipelined processing applies only when a policy is armed
        (``pipeline=`` or the module slot), the bound device process has
        the split protocol and is idempotent (a failed in-flight window
        is recomputed synchronously). Otherwise ``None``: the synchronous
        loop."""
        from spatialflink_tpu_torch import pipeline as pipeline_mod

        pol = self.pipeline if self.pipeline is not None \
            else pipeline_mod.policy()
        if pol is None or int(pol.fetch_lag) < 1:
            return None
        proc = self.process
        if self.backend != "device" or proc is None:
            return None
        compute = getattr(proc, "pipeline_compute", None)
        fetch = getattr(proc, "pipeline_fetch", None)
        if compute is None or fetch is None:
            return None
        if not getattr(proc, "idempotent", True):
            return None
        return {"pol": pol, "compute": compute, "fetch": fetch,
                "inflight": deque()}

    def _pipe_process(self, pipe, win) -> Iterator:
        """Process one window, possibly deferring its fetch; yields the
        results whose lagged fetch came due. The synchronous
        ``_process_window`` (retry → failover → crash) stays the error
        path: a failed pipelined dispatch or fetch drains the healthy
        in-flight prefix and reprocesses the failed window through it."""
        from spatialflink_tpu_torch.pipeline import breaker_collapsed

        if telemetry.enabled:
            # Stage "assemble": the window fired at the source clock.
            end = getattr(win, "end", None)
            if end is not None:
                telemetry.record_e2e(end, "assemble",
                                     node=self._node_label)
        if pipe is None:
            yield self._process_window(win)
            return
        if self.backend != "device":
            # A failover mid-overlap must not reorder egress: drain the
            # in-flight prefix before this window.
            yield from self._pipe_drain(pipe)
            yield self._process_window(win)
            return
        if breaker_collapsed():
            # Circuit open: stack no windows onto a dead device path;
            # drain and hand the window to the breaker's routing.
            yield from self._pipe_drain(pipe)
            if not pipe.get("collapsed"):
                pipe["collapsed"] = True
                telemetry.record_pipeline(collapses=1)
                telemetry.emit_instant("pipeline_collapsed",
                                       label="driver")
                telemetry.maybe_flush_stream(force=True)
            result = self._process_window(win)
            telemetry.record_pipeline(windows=1, sync=1)
            yield result
            return
        if pipe.get("collapsed"):
            pipe["collapsed"] = False
            telemetry.record_pipeline(resumes=1)
            telemetry.emit_instant("pipeline_resumed", label="driver")
            telemetry.maybe_flush_stream(force=True)
        try:
            # The injection point sits inside the dial guard; the scope
            # covers the dispatch only, never a yield.
            with telemetry.scope(self._node_label), \
                    self._dial_guard(True):
                if faults.armed:  # fault injection point (faults.py)
                    faults.hit("pipeline.ship")
                work = pipe["compute"](win)
        except (KeyboardInterrupt, SystemExit):
            raise
        except CheckpointCorruptError:
            raise
        except Exception:
            yield from self._pipe_drain(pipe)
            yield self._process_window(win)
            return
        if telemetry.enabled:
            # Stage "ship": the host→device copy and the launches returned.
            end = getattr(win, "end", None)
            if end is not None:
                telemetry.record_e2e(end, "ship", node=self._node_label)
        pipe["inflight"].append((win, work))
        while len(pipe["inflight"]) > int(pipe["pol"].fetch_lag):
            yield from self._pipe_fetch_one(pipe)

    def _pipe_fetch_one(self, pipe) -> Iterator:
        win, work = pipe["inflight"].popleft()
        ctrl = self.overload
        breaker = ctrl.breaker if ctrl is not None else None
        try:
            with telemetry.scope(self._node_label):
                if faults.armed:  # fault injection point (faults.py)
                    faults.hit("pipeline.fetch")
                result = pipe["fetch"](work)
        except (KeyboardInterrupt, SystemExit):
            raise
        except CheckpointCorruptError:
            raise
        except Exception:
            # The in-flight handle is dead: recompute this window
            # synchronously through the retry/failover ladder.
            yield self._process_window(win)
            return
        if breaker is not None:
            breaker.record_success()
        telemetry.record_pipeline(windows=1, overlapped=1)
        if telemetry.enabled:
            # Stage "fetch": the lagged device→host copy returned.
            end = getattr(win, "end", None)
            if end is not None:
                telemetry.record_e2e(end, "fetch", node=self._node_label)
        # Never degraded: computed and fetched on the device path, even
        # when the backend flipped after its dispatch.
        yield self._finish_window(result, degraded=False, win=win)

    def _pipe_drain(self, pipe) -> Iterator:
        """Fetch every in-flight window now: the consistent frontier every
        checkpoint commit (and the end of the stream) requires."""
        if pipe is None:
            return
        if pipe["inflight"]:
            telemetry.record_pipeline(drains=1)
        while pipe["inflight"]:
            yield from self._pipe_fetch_one(pipe)

    # -- per-window processing (retry → failover → crash) ----------------------

    def _process_window(self, win):
        # Everything in the ladder (device bytes, kernel rows, fault
        # hits) is tagged with the bound operator's label.
        with telemetry.scope(self._node_label):
            return self._process_window_inner(win)

    def _process_window_inner(self, win):
        ctrl = self.overload
        breaker = ctrl.breaker if ctrl is not None else None
        # The circuit breaker generalises the permanent failover below:
        # with one configured and a fallback bound, whole windows route
        # to the twin while the circuit is open, and a half-open probe
        # tries the device path on a bounded schedule.
        use_breaker = (breaker is not None and self.backend == "device"
                       and self.fallback is not None)
        single_attempt = False
        if use_breaker:
            route = breaker.route()
            if route == "fallback":
                return self._finish_window(self.fallback(win),
                                           degraded=True, win=win)
            single_attempt = route == "probe"
        policy = self.retry
        attempt = 0
        delay = policy.backoff_s
        proc = self.process if self.backend == "device" else self.fallback
        while True:
            try:
                with self._dial_guard(proc is self.process):
                    if self.backend == "device" and proc is self.process \
                            and faults.armed:
                        faults.hit("driver.window")  # fault injection point
                    result = proc(win)
                if use_breaker and proc is self.process:
                    breaker.record_success()
                break
            except (KeyboardInterrupt, SystemExit):
                raise
            except CheckpointCorruptError:
                raise  # never retry integrity failures
            except Exception as e:
                if not getattr(proc, "idempotent", True):
                    # A stateful processor (the realtime tStats walk) may
                    # have half-applied the window; re-running it would
                    # double-count. Crash and resume is the only safe way.
                    raise
                start = getattr(win, "start", 0)
                if not single_attempt and attempt < policy.max_retries:
                    attempt += 1
                    self.stats["retries"] += 1
                    telemetry.record_driver_retry(start, attempt, repr(e))
                    policy.do_sleep(delay)
                    delay *= policy.multiplier
                    continue
                if use_breaker and proc is self.process:
                    # Count the failed window (opening the circuit at the
                    # threshold) and answer it on the twin, with no
                    # permanent switch: the next probe may win back the
                    # device path.
                    breaker.record_failure(start, repr(e))
                    return self._finish_window(self.fallback(win),
                                               degraded=True, win=win)
                if self.backend == "device" and self.fallback is not None:
                    # Graceful degradation: the device path is gone; the
                    # numpy route takes the rest of the run.
                    self.backend = "fallback"
                    self.stats["failovers"] += 1
                    telemetry.record_driver_failover(start, repr(e))
                    proc = self.fallback
                    attempt = 0
                    delay = policy.backoff_s
                    continue
                raise
        return self._finish_window(result,
                                   degraded=self.backend != "device",
                                   win=win)

    def _finish_window(self, result, degraded: bool = False, win=None):
        self.stats["windows"] += 1
        self._since_ckpt += 1
        if degraded and self.overload is not None:
            # A window answered off the device path: the SLO
            # degraded_window_budget counts these.
            self.overload.count_degraded_window()
        if telemetry.enabled and win is not None:
            end = getattr(win, "end", None)
            if end is not None:
                # Stage "compute": the window's result is on the host
                # (sync path: the processor returned; pipelined path: its
                # ordered fetch, an upper bound on the compute's end).
                telemetry.record_e2e(end, "compute",
                                     node=self._node_label)
                if self.sink is not None or \
                        self.checkpoint_path is not None:
                    self._pending_commit.append(end)
        return result

    # -- checkpoint commit -----------------------------------------------------

    def _commit(self, final: bool = False) -> None:
        """The exactly-once commit point, between source events:
        1. staged egress appends durably (fsync) and the marker advances;
        2. operator, assembler, driver position and that marker publish
           atomically as one checkpoint.
        A crash between 1 and 2 leaves a tail past the old marker, which
        the sink's ``restore`` truncates: resumed egress never gaps or
        duplicates."""
        if self.checkpoint_path is None:
            if final:
                self._commit_sink_only()
            return
        egress = None
        if self.sink is not None and hasattr(self.sink, "commit"):
            egress = self.sink.commit()
        components: Dict[str, Any] = {
            "op": operator_state(self.op),
            "driver": {
                "events_consumed": self._consumed,
                "windows": self.stats["windows"],
                "backend": self.backend,
            },
        }
        if egress is not None:
            components["egress"] = egress
        if self.overload is not None:
            components["overload"] = self.overload.state()
        if self.extra_state is not None:
            components.update(self.extra_state())
        save_checkpoint(self.checkpoint_path, **components)
        self.stats["checkpoints"] += 1
        self._since_ckpt = 0
        self._stamp_committed()

    def _commit_sink_only(self) -> None:
        if self.sink is not None and hasattr(self.sink, "commit") \
                and getattr(self.sink, "pending", 0):
            self.sink.commit()
        self._stamp_committed()

    def _stamp_committed(self) -> None:
        """Stage "commit": every window finished since the last commit is
        durably published (egress appended, checkpoint framed). Closes
        each window's open lineage entry."""
        if not self._pending_commit:
            return
        if telemetry.enabled:
            for end in self._pending_commit:
                telemetry.record_e2e(end, "commit",
                                     node=self._node_label)
        self._pending_commit = []


# ---------------------------------------------------------------------------
# Chaos smoke: the kill/resume round trip.


def _toy_pipeline(n_events: int = 120):
    """A tiny deterministic range-query pipeline over a synthetic point
    stream (the JAX package's, event for event): the chaos harness of the
    CLI smoke and the tests. Returns (grid, conf, source_factory,
    query_point)."""
    import numpy as np

    from spatialflink_tpu_torch.grid import UniformGrid
    from spatialflink_tpu_torch.models.objects import Point
    from spatialflink_tpu_torch.operators.query_config import (
        QueryConfiguration,
        QueryType,
    )

    grid = UniformGrid(8, 0.0, 8.0, 0.0, 8.0)
    conf = QueryConfiguration(QueryType.WindowBased, window_size=2.0,
                              slide_step=1.0)
    rng = np.random.default_rng(7)
    xs = rng.uniform(0.0, 8.0, n_events)
    ys = rng.uniform(0.0, 8.0, n_events)

    def source():
        for i in range(n_events):
            yield Point(obj_id=f"o{i % 13}", timestamp=100 * i,
                        x=float(xs[i]), y=float(ys[i]))

    query = Point(obj_id="q", x=4.0, y=4.0)
    return grid, conf, source, query


def render_range_result(res) -> Iterator[str]:
    """The streaming job's option-1 egress line format."""
    for p, d in zip(res.objects, res.dists):
        yield (f"{res.start},{res.end},{p.obj_id},{float(p.x)!r},"
               f"{float(p.y)!r},{float(d)!r}")


def run_chaos_child(workdir: str, device="cuda") -> int:
    """One (possibly fault-armed) pipeline run: range query → exactly-once
    CSV egress and a checkpoint under ``workdir``, resumed automatically
    when the checkpoint exists. Faults arm through ``SFT_FAULT_PLAN``
    (read at import by ``faults.py``)."""
    from spatialflink_tpu_torch.operators.range_query import (
        PointPointRangeQuery,
    )
    from spatialflink_tpu_torch.streams.sinks import TransactionalFileSink

    # A stream-armed child records its capture: the abort leg's kill then
    # leaves a recoverable stream and a <stream>.blackbox.json dump.
    stream = os.environ.get("SFT_LEDGER_STREAM")
    if stream:
        telemetry.enable(stream_path=stream)
    grid, conf, source, query = _toy_pipeline()
    sink = TransactionalFileSink(os.path.join(workdir, "egress.csv"))
    driver = WindowedDataflowDriver(
        checkpoint_path=os.path.join(workdir, "ckpt.bin"),
        checkpoint_every=2, sink=sink,
        retry=RetryPolicy(max_retries=1, backoff_s=0.0),
        failover=False,  # chaos wants crash and resume, not degradation
    )
    op = PointPointRangeQuery(conf, grid, device=device)
    n = 0
    for res in op.run(source(), [query], 1.5, driver=driver):
        for line in render_range_result(res):
            sink.stage(line)
            n += 1
    if stream:
        telemetry.seal_stream("complete")
    return n


def run_chaos_sharded_child(workdir: str, device="cuda") -> int:
    """One (possibly fault-armed) grid-partitioned pipeline run on an
    eight-shard mesh of ``device`` (``data_mesh(8, devices=[device] *
    8)``): ``run_partitioned`` (the ``parallel/halo.py`` halo exchange) →
    exactly-once CSV egress and a checkpoint under ``workdir``, the
    partition plan riding the framed unit publish. The
    ``shard.exchange`` fault point fires once a window inside the halo
    wrapper, so an armed abort kills the process mid-exchange; a resume
    re-dispatches onto the checkpointed placement and converges byte for
    byte. The JAX package's pipeline, event for event."""
    import numpy as np

    from spatialflink_tpu_torch.grid import UniformGrid
    from spatialflink_tpu_torch.models.objects import Point
    from spatialflink_tpu_torch.operators.query_config import (
        QueryConfiguration,
        QueryType,
    )
    from spatialflink_tpu_torch.operators.range_query import (
        PointPointRangeQuery,
    )
    from spatialflink_tpu_torch.parallel.mesh import data_mesh
    from spatialflink_tpu_torch.streams.sinks import TransactionalFileSink

    # A finer grid than _toy_pipeline's 8 x 8: each of the 8 shards must
    # span at least the halo width in flat cells (partition.py's
    # single-hop contract).
    grid = UniformGrid(128, 0.0, 8.0, 0.0, 8.0)
    conf = QueryConfiguration(QueryType.WindowBased, window_size=2.0,
                              slide_step=1.0)
    n_events = 160
    rng = np.random.default_rng(7)
    xs = rng.uniform(0.0, 8.0, n_events)
    ys = rng.uniform(0.0, 8.0, n_events)

    def source():
        for i in range(n_events):
            yield Point(obj_id=f"o{i % 13}", timestamp=100 * i,
                        x=float(xs[i]), y=float(ys[i]))

    queries = [Point(obj_id="q0", x=4.0, y=4.0),
               Point(obj_id="q1", x=1.0, y=6.5)]
    sink = TransactionalFileSink(os.path.join(workdir, "egress.csv"))
    driver = WindowedDataflowDriver(
        checkpoint_path=os.path.join(workdir, "ckpt.bin"),
        checkpoint_every=2, sink=sink,
        retry=RetryPolicy(max_retries=1, backoff_s=0.0),
        failover=False,  # chaos wants crash and resume, not degradation
    )
    op = PointPointRangeQuery(conf, grid, device=device)
    mesh = data_mesh(8, devices=[device] * 8)
    n = 0
    for res in op.run_partitioned(source(), queries, 0.9, mesh,
                                  driver=driver):
        for line in render_range_result(res):
            sink.stage(line)
            n += 1
    return n


def chaos_smoke(device="cuda") -> int:
    """Clean run vs (killed by an ``abort`` fault → resumed) run: the
    egress must be byte-identical. Exit 0 on equality. Each leg is a
    fresh subprocess on ``device``: the abort kind ``os._exit``\\ s, and
    crash consistency only means something across processes."""
    import json
    import subprocess
    import sys
    import tempfile

    env_base = dict(os.environ)
    env_base.pop("SFT_FAULT_PLAN", None)
    # Ambient capture paths would point every leg's stream at one file
    # (the kill leg arms its own below).
    env_base.pop("SFT_LEDGER_STREAM", None)
    env_base.pop("SFT_LEDGER_PATH", None)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

    def child(workdir, plan=None, stream=None):
        env = dict(env_base)
        if plan is not None:
            env["SFT_FAULT_PLAN"] = json.dumps(plan)
        if stream is not None:
            env["SFT_LEDGER_STREAM"] = stream
        return subprocess.run(
            [sys.executable, "-m", "spatialflink_tpu_torch.driver",
             "--chaos-child", workdir, "--device", str(device)],
            env=env, capture_output=True, text=True, timeout=600,
            cwd=root,
        )

    with tempfile.TemporaryDirectory(prefix="sft_chaos_") as tmp:
        clean_dir = os.path.join(tmp, "clean")
        chaos_dir = os.path.join(tmp, "chaos")
        os.makedirs(clean_dir)
        os.makedirs(chaos_dir)
        p = child(clean_dir)
        if p.returncode != 0:
            print("chaos-smoke: clean run failed\n" + p.stderr[-2000:])
            return 1
        # The kill -9 analog mid-run: the abort fires on the 2nd sink
        # commit, after durable state exists and before the run ends. The
        # kill leg streams its capture, so the abort leaves a flight-
        # recorder dump beside it (record_fault dumps before os._exit).
        stream = os.path.join(chaos_dir, "stream.jsonl")
        p = child(chaos_dir,
                  plan=[{"point": "sink.write", "kind": "abort", "at": 2}],
                  stream=stream)
        if p.returncode != 137:
            print(f"chaos-smoke: expected the armed child to die with "
                  f"exit 137, got {p.returncode}\n" + p.stderr[-2000:])
            return 1
        bb_path = stream + ".blackbox.json"
        if not os.path.exists(bb_path):
            print("chaos-smoke: the killed child left no flight-recorder "
                  f"dump at {bb_path}")
            return 1
        try:
            with open(bb_path) as f:
                bb = json.load(f)
        except ValueError as e:
            print(f"chaos-smoke: blackbox dump unparseable: {e!r}")
            return 1
        if bb.get("blackbox_version") != 1 \
                or not str(bb.get("reason", "")).startswith("fault:") \
                or not bb.get("ring"):
            print("chaos-smoke: blackbox dump malformed "
                  f"(version={bb.get('blackbox_version')!r}, "
                  f"reason={bb.get('reason')!r}, "
                  f"ring entries={len(bb.get('ring') or [])})")
            return 1
        p = child(chaos_dir)  # resume from the published checkpoint
        if p.returncode != 0:
            print("chaos-smoke: resume run failed\n" + p.stderr[-2000:])
            return 1
        with open(os.path.join(clean_dir, "egress.csv"), "rb") as f:
            clean = f.read()
        with open(os.path.join(chaos_dir, "egress.csv"), "rb") as f:
            recovered = f.read()
        if clean != recovered:
            print(f"chaos-smoke: egress mismatch after kill/resume "
                  f"(clean {len(clean)} B, recovered {len(recovered)} B)")
            return 1
        if not clean:
            print("chaos-smoke: clean egress is empty (vacuous pass)")
            return 1
    print(f"chaos-smoke: kill/resume egress byte-identical on {device} — OK")
    return 0


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        prog="python -m spatialflink_tpu_torch.driver",
        description="windowed-dataflow driver chaos self-test",
    )
    ap.add_argument("--chaos-smoke", action="store_true",
                    help="run the kill/resume egress-equality smoke")
    ap.add_argument("--chaos-child", metavar="DIR", default=None,
                    help="internal: one pipeline run rooted at DIR")
    ap.add_argument("--chaos-sharded-child", metavar="DIR", default=None,
                    help="internal: one grid-partitioned pipeline run "
                         "rooted at DIR on an eight-shard mesh")
    ap.add_argument("--device", default="cuda",
                    help="where the pipeline runs: cuda (the default) or "
                         "cpu")
    args = ap.parse_args(argv)
    if args.chaos_child:
        n = run_chaos_child(args.chaos_child, device=args.device)
        print(f"chaos-child: {n} records staged")
        return 0
    if args.chaos_sharded_child:
        n = run_chaos_sharded_child(args.chaos_sharded_child,
                                    device=args.device)
        print(f"chaos-sharded-child: {n} records staged")
        return 0
    if args.chaos_smoke:
        return chaos_smoke(device=args.device)
    ap.error("pass --chaos-smoke (or internal --chaos-child)")
    return 2


if __name__ == "__main__":
    import sys

    sys.exit(main())
