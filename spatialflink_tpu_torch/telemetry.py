"""Runtime telemetry: spans, host↔card boundary accounting, the per-kernel
dispatch table, watermark-lag and late-drop gauges, event-time
end-to-end latency, and the run ledger.

The reference instruments its pipelines with Flink/NES metrics
(``com/mn/``, ported in ``mn/``). This module adds the layer between the
host and the card:

- host→device and device→host bytes, counted at the operators' ship
  (``operators/base.py:ship``) and fetch (:meth:`Telemetry.fetch`) sites;
- the dispatch table: calls and host dispatch wall-ns per (kernel
  label, abstract signature), fed by :func:`instrument_jit`;
- windows firing late and events dropped: watermark-lag and late-drop
  gauges fed by the ``streams/`` assemblers;
- window latency: spans named ``window.*`` feed a ``FixedBucketLatency``
  histogram (NES buckets), and :meth:`Telemetry.record_e2e` stamps a
  window's event-time staleness at each pipeline stage.

Contract: **disabled by default and free when disabled** (operator hot
paths do one ``telemetry.enabled`` attribute check per window or pane,
nothing per event); when enabled, instrumentation adds **no device sync**
beyond the operator's own: byte accounting reads host-array ``nbytes``
before shipping, and ``fetch`` REPLACES the operator's own device→host
copy, never adds one.

On the card kernel launches are asynchronous, so the dispatch table
holds HOST DISPATCH wall-ns (the time to enqueue a window's kernels),
never kernel time; kernel time comes from CUDA events or a profiler
trace.

Spans go out as Chrome-trace/Perfetto complete events (``"ph": "X"``,
microsecond ts/dur) in JSON lines; ``load_trace`` wraps a trace file into
the standard ``{"traceEvents": [...]}`` document. ``write_ledger``
exports one schema-versioned JSON document (``tools/sfprof`` reads it),
and ``stream_path`` keeps an append-only ledger stream that survives a
crash.
"""

from __future__ import annotations

import json
import os
import sys
import threading
import time
import warnings
from collections import deque
from typing import Any, Dict, Optional, Tuple

from spatialflink_tpu_torch.ablation import ablation
from spatialflink_tpu_torch.faults import faults
from spatialflink_tpu_torch.mn.metrics import FixedBucketLatency, json_safe
from spatialflink_tpu_torch.precision import x64_enabled


#: Run-ledger schema version; the JAX package's, which
#: ``tools/sfprof/ledger.py`` validates. v2: per-node attribution and
#: collective accounting; v3: the event-time end-to-end ``e2e`` block.
LEDGER_VERSION = 3

#: Ledger-STREAM record-layout version (``tools/sfprof/stream.py``).
STREAM_VERSION = 3

#: The cost block every dispatch-table row carries: the port's kernels
#: are hand-written CUDA with no ahead-of-time cost analysis.
NO_COST_ANALYSIS = {"error": "cost analysis unavailable on this backend"}


def _sanitize_nonfinite(value):
    """(sanitized, count): every non-finite float (NaN/±Inf) anywhere in
    the structure becomes ``None``, counted, so a NaN at the end of a run
    keeps the artifact and makes the corruption visible."""
    if isinstance(value, float):
        if value != value or value in (float("inf"), float("-inf")):
            return None, 1
        return value, 0
    if isinstance(value, dict):
        n = 0
        out = {}
        for k, v in value.items():
            out[k], dn = _sanitize_nonfinite(v)
            n += dn
        return out, n
    if isinstance(value, (list, tuple)):
        n = 0
        out = []
        for v in value:
            sv, dn = _sanitize_nonfinite(v)
            out.append(sv)
            n += dn
        return out, n
    return value, 0


class RecompileWarning(UserWarning):
    """One kernel crossed the distinct-abstract-shape threshold: bucket
    churn or an accidentally dynamic shape."""


def _arg_signature(a):
    """One argument's part of the abstract signature. Tensors and arrays
    give (shape, dtype); tuples, lists and dicts recurse (never a repr,
    which would copy a tensor to the host); other leaves give only their
    type name."""
    shape = getattr(a, "shape", None)
    dtype = getattr(a, "dtype", None)
    if shape is not None and dtype is not None:
        return (tuple(shape), str(dtype))
    if isinstance(a, (tuple, list)):
        return (type(a).__name__, tuple(_arg_signature(x) for x in a))
    if isinstance(a, dict):
        return ("dict", tuple(
            (str(k), _arg_signature(v)) for k, v in sorted(a.items())
        ))
    return type(a).__name__


def abstract_signature(args: tuple, kwargs: Optional[dict] = None) -> Tuple:
    """Hashable key of one call's abstract shape.

    Over tensors and arrays it keys on (shape, dtype), never on values:
    positional arguments go through ``_arg_signature`` (containers
    recurse); keyword arguments holding tensors or containers of them do
    too, while every other keyword argument contributes (name,
    repr(value)), since scalar and string keyword arguments in this
    package are statics (bucket sizes, ``k``, ``num_segments``) whose
    VALUE picks the program.
    """
    parts = [_arg_signature(a) for a in args]
    for k in sorted(kwargs or ()):
        v = kwargs[k]
        shape = getattr(v, "shape", None)
        dtype = getattr(v, "dtype", None)
        if shape is not None and dtype is not None:
            parts.append((k, (tuple(shape), str(dtype))))
        elif isinstance(v, (tuple, list, dict)):
            parts.append((k, _arg_signature(v)))
        else:
            parts.append((k, repr(v)))
    return tuple(parts)


def _to_host(x):
    """(host tree, bytes) of a tree of tensors: every tensor leaf becomes
    a numpy array through ``.cpu()`` and counts ``numel * element_size``;
    numpy leaves count their ``nbytes``; tuples, lists, NamedTuples and
    dicts recurse; anything else passes through uncounted."""
    if hasattr(x, "element_size") and hasattr(x, "numel"):
        return x.detach().cpu().numpy(), x.numel() * x.element_size()
    if isinstance(x, (tuple, list)):
        parts, nbytes = [], 0
        for v in x:
            p, n = _to_host(v)
            parts.append(p)
            nbytes += n
        if hasattr(x, "_fields"):
            return type(x)(*parts), nbytes
        return type(x)(parts), nbytes
    if isinstance(x, dict):
        out, nbytes = {}, 0
        for k, v in x.items():
            out[k], n = _to_host(v)
            nbytes += n
        return out, nbytes
    return x, int(getattr(x, "nbytes", 0) or 0)


class _NullSpan:
    """No-op context manager returned while telemetry is disabled: one
    shared instance, so the disabled cost is a truthiness check."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


class _Span:
    __slots__ = ("_tel", "name", "args", "_t0")

    def __init__(self, tel: "Telemetry", name: str, args: Dict[str, Any]):
        self._tel = tel
        self.name = name
        self.args = args

    def __enter__(self):
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self._tel._emit_span(
            self.name, self._t0, time.perf_counter_ns() - self._t0, self.args
        )
        return False


class _Scope:
    """Node-attribution scope: pushes a node name onto the emitting
    thread's scope stack for the ``with`` block; the innermost wins."""

    __slots__ = ("_tel", "node")

    def __init__(self, tel: "Telemetry", node: str):
        self._tel = tel
        self.node = node

    def __enter__(self):
        tls = self._tel._tls
        stack = getattr(tls, "stack", None)
        if stack is None:
            stack = tls.stack = []
        stack.append(self.node)
        return self

    def __exit__(self, *exc):
        self._tel._tls.stack.pop()
        return False


class Telemetry:
    """Process-global telemetry registry (the ``ops/counters.py`` idiom:
    one module singleton, ``enable()`` to opt in)."""

    def __init__(self, max_events: int = 262_144):
        self.enabled = False
        self.max_events = max_events
        self.recompile_warn_threshold = 8
        self.trace_path: Optional[str] = None
        self._trace_file = None
        # Append-only ledger stream: JSONL segments — a versioned
        # prologue, window-boundary checkpoint and span-batch flushes, a
        # sealing epilogue. tools/sfprof recover rebuilds a ledger from a
        # truncated stream.
        self.stream_path: Optional[str] = None
        self._stream_file = None
        self._stream_sealed = False
        self.stream_flush_interval_s = 1.0
        # Callbacks the later runtime layers install (the SLO verdict,
        # the overload controller, the standing-query registry and the
        # composed dataflow); snapshot()/write_ledger embed their blocks.
        self.slo_provider = None
        self.overload_provider = None
        self.qserve_provider = None
        self.dag_provider = None
        self._lock = threading.RLock()
        # Node-attribution scope stack: thread-confined, so concurrent
        # operator threads never cross-tag each other.
        self._tls = threading.local()
        self._reset_state()

    def _reset_state(self):
        self.events: list = []
        self.dropped_events = 0
        self._since_flush = 0
        self.h2d_bytes = 0
        self.h2d_transfers = 0
        self.d2h_bytes = 0
        self.d2h_transfers = 0
        self.compile_events: list = []  # (kernel, signature), append order
        self._shapes_seen: Dict[str, set] = {}
        self._warned_kernels: set = set()
        self.max_watermark_lag_ms = 0
        self.late_drops = 0
        self.window_latency = FixedBucketLatency()
        # The watermark-lag distribution, not just its maximum.
        self.watermark_lag = FixedBucketLatency()
        # LinkProbe samples (bounded); snapshot() exports p50/last.
        self._link_samples: list = []
        # Ledger-stream bookkeeping.
        self._stream_pending: list = []
        self._stream_seq = 0
        self._stream_last_flush = time.monotonic()
        self.nonfinite_values = 0
        # Injected-fault firings per point and the driver's retries and
        # failovers (A11.2 records them).
        self.fault_fires: Dict[str, int] = {}
        self.driver_retries = 0
        self.driver_failovers = 0
        # engine → {capacity bucket → {"picks", "max_live"}}: the
        # compaction control plane's picks (ops/compaction.py).
        self._compaction: Dict[str, Dict[int, Dict[str, int]]] = {}
        # (kernel, signature, node) → {"calls", "dispatch_ns",
        # "first_call_ns", "cost"}: the dispatch table.
        self._kernel_stats: Dict[Tuple[str, Tuple, Optional[str]],
                                 Dict[str, Any]] = {}
        # Wire-codec gauges (account_wire): raw vs coded bytes per pane.
        self.wire_raw_bytes = 0
        self.wire_coded_bytes = 0
        self.wire_panes = 0
        # Pipelined-executor counters (pipeline.py, record_pipeline).
        self._pipeline: Dict[str, int] = {}
        # tids already named by a ph:"M" thread_name metadata event.
        self._named_tids: set = set()
        # Per-node attribution buckets: node (None = unscoped) → counter
        # dict; every accounting site updates exactly one bucket, so the
        # buckets sum to the globals.
        self._node_acct: Dict[Optional[str], Dict[str, Any]] = {}
        # Collective accounting (parallel/ calls it): kind → {"calls",
        # "bytes"}, per-axis bytes, halo boundary-state bytes, and the
        # per-shard event-time high-water marks.
        self._collectives: Dict[str, Dict[str, int]] = {}
        self._collective_axes: Dict[str, int] = {}
        self._halo_state_bytes = 0
        self._shard_watermarks: Dict[int, int] = {}
        # Overload shed accounting (overload.py calls it).
        self.shed_events = 0
        self.shed_bytes = 0
        # Event-time end-to-end latency (record_e2e): one histogram per
        # stage, globally and per (node, stage); open per-window entries
        # are bounded (E2E_OPEN_MAX, evictions counted). The anchor maps
        # event time onto the wall clock at the first stamp.
        self._e2e_anchor: Optional[Tuple[float, float]] = None
        self._e2e_open: Dict[int, Dict[str, float]] = {}
        self._e2e_evicted = 0
        self._e2e_stages: Dict[str, FixedBucketLatency] = {}
        self._e2e_nodes: Dict[str, Dict[str, FixedBucketLatency]] = {}
        # Flight recorder: a bounded ring of the last window-span
        # summaries and instants, dumped beside the stream on a fault and
        # at every seal. SFT_BLACKBOX sizes the ring; "0" disables it.
        try:
            bb_n = int(os.environ.get("SFT_BLACKBOX", "64"))
        except ValueError:
            bb_n = 64
        self._blackbox: Optional[deque] = (
            deque(maxlen=bb_n) if bb_n > 0 else None
        )

    # -- lifecycle ------------------------------------------------------------

    def enable(self, trace_path: Optional[str] = None,
               recompile_warn_threshold: int = 8,
               stream_path: Optional[str] = None,
               stream_flush_interval_s: Optional[float] = None):
        """Reset all state and start recording. ``trace_path``: optional
        Chrome-trace JSON-lines file (events also buffer in memory, capped
        at ``max_events``). ``stream_path``: optional append-only ledger
        stream — a prologue now, checkpoint and span-batch segments at
        window boundaries (paced by ``stream_flush_interval_s``, default
        1 s or ``SFT_LEDGER_STREAM_INTERVAL_S``), an epilogue at
        ``write_ledger``/``disable``."""
        with self._lock:
            self.disable()
            self._reset_state()
            self.recompile_warn_threshold = int(recompile_warn_threshold)
            self.trace_path = trace_path
            self.stream_path = stream_path
            self._stream_sealed = False
            if stream_path:
                if stream_flush_interval_s is None:
                    stream_flush_interval_s = float(os.environ.get(
                        "SFT_LEDGER_STREAM_INTERVAL_S", "1.0"))
                self.stream_flush_interval_s = float(stream_flush_interval_s)
                d = os.path.dirname(os.path.abspath(stream_path))
                os.makedirs(d, exist_ok=True)
                self._stream_file = open(stream_path, "w")
                # The prologue's env names no device: enable() must not
                # touch the card; the ledger's env block names it.
                self._write_stream({
                    "t": "prologue",
                    "stream_version": STREAM_VERSION,
                    "ledger_version": LEDGER_VERSION,
                    "created_unix": time.time(),
                    "env": {
                        "python": sys.version.split()[0],
                        "pid": os.getpid(),
                        "argv0": os.path.basename(sys.argv[0] or "python"),
                    },
                })
                self._stream_file.flush()
            if trace_path:
                d = os.path.dirname(os.path.abspath(trace_path))
                os.makedirs(d, exist_ok=True)
                self._trace_file = open(trace_path, "w")
                # Name the process once; threads are named at their first
                # event (_emit).
                self._write_trace({
                    "name": "process_name", "ph": "M", "pid": os.getpid(),
                    "args": {"name": "spatialflink_tpu_torch:"
                             + os.path.basename(sys.argv[0] or "python")},
                })
            self.enabled = True
        # A plan armed before telemetry came up (SFT_FAULT_PLAN at import)
        # still records its schedule.
        if faults.armed:
            self.emit_instant(
                "fault_armed", plan=[r.to_dict() for r in faults.rules]
            )
        # A fresh capture's ablation taint reflects this capture only.
        ablation.reset_counters()
        if ablation.armed:
            self.emit_instant(
                "ablation_armed", kernels=sorted(ablation.kernels)
            )

    def disable(self):
        """Stop recording and seal both sinks: the ledger stream gets its
        epilogue and the trace file is flushed before it closes."""
        with self._lock:
            self.enabled = False
            self.seal_stream("disabled")
            if self._trace_file is not None:
                self._trace_file.flush()
                self._since_flush = 0
                self._trace_file.close()
                self._trace_file = None

    FLUSH_EVERY = 256

    def flush_trace(self):
        """Drain the buffered trace writer now (before a timed region)."""
        with self._lock:
            if self._trace_file is not None:
                self._trace_file.flush()
                self._since_flush = 0

    def _write_trace(self, event: dict):
        """Buffered trace write (caller holds the lock); the buffer drains
        every FLUSH_EVERY events and on disable()."""
        self._trace_file.write(json.dumps(event) + "\n")
        self._since_flush += 1
        if self._since_flush >= self.FLUSH_EVERY:
            self._trace_file.flush()
            self._since_flush = 0

    # -- ledger stream ---------------------------------------------------------

    def _write_stream(self, record: dict):
        """One JSONL stream record (caller holds the lock). Non-finite
        floats become null and are counted."""
        record, n = _sanitize_nonfinite(json_safe(record))
        if n:
            self.nonfinite_values += n
        self._stream_file.write(json.dumps(record, allow_nan=False) + "\n")

    def maybe_flush_stream(self, force: bool = False):
        """Window-boundary stream flush: a span batch (events since the
        last flush) and a checkpoint (snapshot + dispatch table), paced by
        ``stream_flush_interval_s``; ``force=True`` flushes regardless."""
        with self._lock:
            if self._stream_file is None or self._stream_sealed:
                return
            now = time.monotonic()
            if (not force and now - self._stream_last_flush
                    < self.stream_flush_interval_s):
                return
            self._stream_last_flush = now
            self._flush_stream_locked()

    def _flush_stream_locked(self):
        self._stream_seq += 1
        seq = self._stream_seq
        if self._stream_pending:
            self._write_stream({
                "t": "spans", "seq": seq, "events": self._stream_pending,
            })
            self._stream_pending = []
        ck = {
            "t": "checkpoint", "seq": seq, "unix": time.time(),
            "snapshot": self.snapshot(), "kernels": self.kernel_table(),
        }
        if self.nonfinite_values:
            ck["nonfinite_values"] = self.nonfinite_values
        self._write_stream(ck)
        self._stream_file.flush()

    def seal_stream(self, reason: str, bench: Optional[dict] = None,
                    slo: Optional[dict] = None):
        """Terminal stream segment: the last span batch and checkpoint,
        then the epilogue with ``reason`` (and the bench record and SLO
        verdict when the run completed). Idempotent: the first seal
        wins."""
        with self._lock:
            if self._stream_file is None or self._stream_sealed:
                return
            bb = self.dump_blackbox(reason)
            if bb is not None and self.enabled:
                self.emit_instant("blackbox_dumped",
                                  reason=str(reason), path=bb)
            self._flush_stream_locked()
            if slo is None and self.slo_provider is not None:
                try:
                    slo = self.slo_provider()
                except Exception:  # a broken verdict must not block the seal
                    slo = None
            ep = {
                "t": "epilogue", "seq": self._stream_seq,
                "unix": time.time(), "reason": str(reason),
            }
            if bench is not None:
                ep["bench"] = bench
            if slo is not None:
                ep["slo"] = slo
            if self.nonfinite_values:
                ep["nonfinite_values"] = self.nonfinite_values
            self._write_stream(ep)
            self._stream_file.flush()
            self._stream_file.close()
            self._stream_file = None
            self._stream_sealed = True

    # -- node-attribution scope ------------------------------------------------

    def scope(self, node: Optional[str]):
        """Tag everything THIS thread emits inside the ``with`` block with
        ``node``. ``None`` is a no-op."""
        if node is None:
            return _NULL_SPAN
        return _Scope(self, str(node))

    def current_node(self) -> Optional[str]:
        """The innermost active scope's node name on this thread."""
        stack = getattr(self._tls, "stack", None)
        return stack[-1] if stack else None

    def _node_bucket(self, node: Optional[str]) -> Dict[str, Any]:
        """This node's accounting bucket (caller holds the lock)."""
        b = self._node_acct.get(node)
        if b is None:
            b = self._node_acct[node] = {
                "spans": 0, "span_us": 0, "windows": 0, "events": 0,
                "window_latency": FixedBucketLatency(),
                "h2d_bytes": 0, "h2d_transfers": 0,
                "d2h_bytes": 0, "d2h_transfers": 0,
                "wire_raw_bytes": 0, "wire_coded_bytes": 0,
                "wire_panes": 0,
                "compiles": 0, "instants": 0, "fault_fires": 0,
                "shed_events": 0, "shed_bytes": 0,
                "collective_calls": 0, "collective_bytes": 0,
                "dispatch_ns": 0, "kernel_calls": 0,
            }
        return b

    def node_rollup(self) -> Dict[str, Dict[str, Any]]:
        """Per-node counter rollup (the snapshot ``nodes`` block); empty
        while no real node has been scoped."""
        with self._lock:
            if not any(k is not None for k in self._node_acct):
                return {}
            out: Dict[str, Dict[str, Any]] = {}
            for node, b in self._node_acct.items():
                lat = b["window_latency"]
                p50 = lat.percentile(0.50)
                p95 = lat.percentile(0.95)
                row = {k: v for k, v in b.items()
                       if k != "window_latency"}
                row["window_latency_p50_ms"] = None if p50 != p50 else p50
                row["window_latency_p95_ms"] = None if p95 != p95 else p95
                out[node if node is not None else "(unscoped)"] = row
        return json_safe(out)

    # -- spans ----------------------------------------------------------------

    def span(self, name: str, **args):
        """Context manager timing one phase. Nesting renders in Chrome
        tracing (same tid, contained ts/dur). ``window.*`` spans also
        feed the window-latency histogram."""
        if not self.enabled:
            return _NULL_SPAN
        return _Span(self, name, args)

    def _emit_span(self, name, t0_ns, dur_ns, args):
        if not self.enabled:  # disabled mid-span
            return
        node = self.current_node()
        ev = {
            "name": name,
            "cat": "telemetry",
            "ph": "X",
            "ts": t0_ns // 1000,
            "dur": dur_ns // 1000,
            "pid": os.getpid(),
            "tid": threading.get_ident(),
        }
        if node is not None:
            args = dict(args or ())
            args.setdefault("node", node)
        if args:
            ev["args"] = json_safe(args)
        self._emit(ev)
        with self._lock:
            b = self._node_bucket(node)
            b["spans"] += 1
            b["span_us"] += dur_ns // 1000
            if name.startswith("node."):
                # Per-node container spans (the composed dataflow).
                b["windows"] += 1
                ev_n = (args or {}).get("events")
                if isinstance(ev_n, (int, float)):
                    b["events"] += int(ev_n)
                b["window_latency"].observe(dur_ns / 1e6)
        if name.startswith("window"):
            with self._lock:
                self.window_latency.observe(dur_ns / 1e6)
                self._blackbox_append({
                    "t": "window", "name": name, "ts": ev["ts"],
                    "dur_us": ev["dur"], "args": ev.get("args", {}),
                })
            # A window boundary is the stream's flush point.
            self.maybe_flush_stream()

    def emit_instant(self, name: str, **args):
        """Structured instant event (``ph:"i"``) into the buffer, the
        trace file and the ledger stream."""
        if not self.enabled:
            return
        node = self.current_node()
        if node is not None:
            args = dict(args)
            args.setdefault("node", node)
        ts = time.perf_counter_ns() // 1000
        safe_args = json_safe(args)
        with self._lock:
            self._node_bucket(node)["instants"] += 1
            self._blackbox_append({"t": "instant", "name": name,
                                   "ts": ts, "args": safe_args})
        self._emit({
            "name": name, "cat": "telemetry", "ph": "i",
            "ts": ts, "pid": os.getpid(),
            "tid": threading.get_ident(), "s": "t",
            "args": safe_args,
        })

    def _emit(self, event: dict):
        with self._lock:
            if len(self.events) < self.max_events:
                self.events.append(event)
            else:
                self.dropped_events += 1
            if self._stream_file is not None and not self._stream_sealed:
                # The stream and the trace file keep every event: the cap
                # bounds memory, not the artifact.
                self._stream_pending.append(event)
            if self._trace_file is not None:
                tid = event.get("tid")
                if tid is not None and tid not in self._named_tids:
                    self._named_tids.add(tid)
                    self._write_trace({
                        "name": "thread_name", "ph": "M",
                        "pid": event.get("pid", os.getpid()), "tid": tid,
                        "args": {"name": threading.current_thread().name},
                    })
                self._write_trace(event)

    # -- device-boundary accounting -------------------------------------------

    def account_h2d(self, nbytes: int):
        """Bytes about to ship host→device (read from the host array
        before the copy)."""
        if not self.enabled:
            return
        with self._lock:
            self.h2d_bytes += int(nbytes)
            self.h2d_transfers += 1
            b = self._node_bucket(self.current_node())
            b["h2d_bytes"] += int(nbytes)
            b["h2d_transfers"] += 1
            if self._trace_file is not None:
                self._write_trace({
                    "name": "h2d_bytes", "ph": "C",
                    "ts": time.perf_counter_ns() // 1000,
                    "pid": os.getpid(), "args": {"bytes": self.h2d_bytes},
                })

    def account_d2h(self, nbytes: int):
        """Bytes fetched device→host (counted at ``fetch``), with the
        same ``ph:"C"`` counter event as ``account_h2d``."""
        if not self.enabled:
            return
        with self._lock:
            self.d2h_bytes += int(nbytes)
            self.d2h_transfers += 1
            b = self._node_bucket(self.current_node())
            b["d2h_bytes"] += int(nbytes)
            b["d2h_transfers"] += 1
            if self._trace_file is not None:
                self._write_trace({
                    "name": "d2h_bytes", "ph": "C",
                    "ts": time.perf_counter_ns() // 1000,
                    "pid": os.getpid(), "args": {"bytes": self.d2h_bytes},
                })

    def fetch(self, x):
        """Device→host fetch of a tree of tensors, with timing and byte
        accounting: every tensor becomes a host numpy array through
        ``.cpu()``, which waits for the kernels that produce it — the one
        true sync. Use it IN PLACE OF the operator's own ``.cpu()`` copy
        (never beside it); it never adds a ``torch.cuda.synchronize()``.
        Bytes are ``numel * element_size`` of each tensor."""
        if faults.armed:  # fault injection point (faults.py)
            faults.hit("device.fetch")
        if not self.enabled:
            return _to_host(x)[0]
        t0 = time.perf_counter_ns()
        out, nbytes = _to_host(x)
        dur_ns = time.perf_counter_ns() - t0
        self.account_d2h(nbytes)
        fetch_args: Dict[str, Any] = {"bytes": int(nbytes)}
        node = self.current_node()
        if node is not None:
            fetch_args["node"] = node
        self._emit({
            "name": "fetch", "cat": "telemetry", "ph": "X",
            "ts": t0 // 1000, "dur": dur_ns // 1000,
            "pid": os.getpid(), "tid": threading.get_ident(),
            "args": fetch_args,
        })
        return out

    # -- distinct-shape detection ---------------------------------------------

    def record_jit_call(self, kernel: str, signature: Tuple) -> bool:
        """Record a call into an instrumented kernel. A signature not
        seen before for this kernel is a new shape (a ``compile:<kernel>``
        instant; on the card, a new launch configuration and often a new
        allocation). Crossing ``recompile_warn_threshold`` distinct
        signatures warns once. Returns True iff the signature is new."""
        if not self.enabled:
            return False
        node = self.current_node()
        warn_n = None
        with self._lock:
            seen = self._shapes_seen.setdefault(kernel, set())
            if signature in seen:
                return False
            seen.add(signature)
            self.compile_events.append((kernel, signature))
            self._node_bucket(node)["compiles"] += 1
            if (len(seen) >= self.recompile_warn_threshold
                    and kernel not in self._warned_kernels):
                self._warned_kernels.add(kernel)
                warn_n = len(seen)
        compile_args: Dict[str, Any] = {"signature": repr(signature)}
        if node is not None:
            compile_args["node"] = node
        self._emit({
            "name": f"compile:{kernel}", "cat": "telemetry", "ph": "i",
            "ts": time.perf_counter_ns() // 1000, "pid": os.getpid(),
            "tid": threading.get_ident(), "s": "t",
            "args": compile_args,
        })
        if warn_n is not None:
            warnings.warn(
                f"kernel '{kernel}' has run at {warn_n} distinct abstract "
                f"shapes (threshold {self.recompile_warn_threshold}): "
                "check for bucket-size churn or an un-bucketed dynamic "
                "dimension",
                RecompileWarning,
                stacklevel=3,
            )
        return True

    @property
    def compile_count(self) -> int:
        return len(self.compile_events)

    def distinct_shapes(self, kernel: str) -> int:
        with self._lock:
            return len(self._shapes_seen.get(kernel, ()))

    # -- the dispatch table -----------------------------------------------------

    def record_kernel_time(self, kernel: str, signature: Tuple,
                           dur_ns: int):
        """One dispatch into an instrumented kernel: call count and host
        dispatch wall-ns per (kernel, signature, node); the first call's
        duration is kept apart (it includes first-use set-up: a kernel
        build or load, allocations)."""
        if not self.enabled:
            return
        node = self.current_node()
        with self._lock:
            key = (kernel, signature, node)
            st = self._kernel_stats.get(key)
            if st is None:
                st = self._kernel_stats[key] = {
                    "calls": 0,
                    "dispatch_ns": 0,
                    "first_call_ns": int(dur_ns),
                    "cost": None,
                }
            st["calls"] += 1
            st["dispatch_ns"] += int(dur_ns)
            b = self._node_bucket(node)
            b["kernel_calls"] += 1
            b["dispatch_ns"] += int(dur_ns)

    def capture_costs(self):
        """Fill each row's cost block. The port's kernels are hand-written
        CUDA with no ahead-of-time cost analysis, so every row records
        ``{"error": "cost analysis unavailable on this backend"}``, the
        JAX package's own answer for such a backend. Idempotent."""
        with self._lock:
            for st in self._kernel_stats.values():
                if st["cost"] is None:
                    st["cost"] = dict(NO_COST_ANALYSIS)

    def kernel_table(self) -> list:
        """Per-(kernel, signature) rows: calls, cumulative host dispatch
        wall-ns, the first call's ns, ``steady_ns`` (cumulative minus the
        first call) and the cost block. Heaviest steady dispatch first."""
        with self._lock:
            rows = []
            for (kernel, sig, node), st in self._kernel_stats.items():
                row = {
                    "kernel": kernel,
                    "signature": repr(sig),
                    "calls": st["calls"],
                    "dispatch_ns": st["dispatch_ns"],
                    "first_call_ns": st["first_call_ns"],
                    "steady_ns": max(
                        st["dispatch_ns"] - st["first_call_ns"], 0
                    ),
                    "cost": st["cost"],
                }
                if node is not None:
                    row["node"] = node
                rows.append(row)
        rows.sort(key=lambda r: (-r["steady_ns"], -r["dispatch_ns"],
                                 r["kernel"]))
        return json_safe(rows)

    # -- run ledger ------------------------------------------------------------

    def write_ledger(self, path: str, bench: Optional[dict] = None,
                     mesh=None, capture_costs: bool = True) -> str:
        """One schema-versioned JSON run ledger: environment (python,
        torch, backend, devices, the float64 mode's ``x64``),
        ``snapshot()``, the dispatch table, the buffered events and the
        caller's bench record. Strict JSON: a
        NaN/Inf is sanitized to null and counted (``nonfinite_values``).
        Seals the ledger stream (``reason: complete``). ``mesh`` (a
        ``{axis: size}`` mapping) lands in the env block."""
        import torch

        if capture_costs:
            self.capture_costs()
        cuda = torch.cuda.is_available()
        env = {
            "python": sys.version.split()[0],
            "torch": torch.__version__,
            "cuda": torch.version.cuda,
            "backend": "cuda" if cuda else "cpu",
            "device_count": torch.cuda.device_count() if cuda else 1,
            "devices": ([torch.cuda.get_device_name(i) for i in
                         range(min(torch.cuda.device_count(), 8))]
                        if cuda else ["cpu"]),
            "x64": x64_enabled(),
            "pid": os.getpid(),
            "argv0": os.path.basename(sys.argv[0] or "python"),
        }
        if mesh is not None:
            shape = getattr(mesh, "shape", mesh)
            env["mesh"] = {str(k): int(v) for k, v in dict(shape).items()}
        with self._lock:
            events = list(self.events)
        slo_block = None
        if self.slo_provider is not None:
            try:
                slo_block = json_safe(self.slo_provider())
            except Exception:  # a broken verdict must not block the ledger
                slo_block = None
        doc = {
            "ledger_version": LEDGER_VERSION,
            "created_unix": time.time(),
            "env": env,
            "snapshot": self.snapshot(),
            "kernels": self.kernel_table(),
            "events": events,
            "bench": json_safe(bench) if bench is not None else None,
        }
        if slo_block is not None:
            doc["slo"] = slo_block
        taint = ablation.taint_block()
        if taint is not None:
            # Top-level mirror of the snapshot taint.
            doc["tainted"] = taint
        doc, nonfinite = _sanitize_nonfinite(doc)
        if nonfinite:
            doc["nonfinite_values"] = nonfinite
        d = os.path.dirname(os.path.abspath(path))
        os.makedirs(d, exist_ok=True)
        with open(path, "w") as f:
            json.dump(doc, f, allow_nan=False)
            f.write("\n")
        self.seal_stream("complete", bench=doc["bench"], slo=slo_block)
        return path

    # -- compaction bucket accounting -----------------------------------------

    def record_compaction(self, engine: str, capacity: int, live: int):
        """One host-side bucket pick (``ops/compaction.py``,
        ``ops/wire_codec.py``): ``engine`` ran at static capacity
        ``capacity`` for a live occupancy of ``live``."""
        if not self.enabled:
            return
        with self._lock:
            d = self._compaction.setdefault(engine, {}).setdefault(
                int(capacity), {"picks": 0, "max_live": 0}
            )
            d["picks"] += 1
            d["max_live"] = max(d["max_live"], int(live))
        self._emit({
            "name": f"compaction:{engine}", "cat": "telemetry", "ph": "i",
            "ts": time.perf_counter_ns() // 1000, "pid": os.getpid(),
            "tid": threading.get_ident(), "s": "t",
            "args": {"capacity": int(capacity), "live": int(live)},
        })

    def compaction_buckets(self, engine: str) -> Dict[int, Dict[str, int]]:
        with self._lock:
            return {
                k: dict(v)
                for k, v in self._compaction.get(engine, {}).items()
            }

    # -- pipelined ingest (pipeline.py) ----------------------------------------

    def account_wire(self, raw_bytes: int, coded_bytes: int):
        """One encoded wire pane: what the raw 6 B/pt wire would have
        shipped vs what the codec shipped (header included); the ship
        site's ``account_h2d`` keeps counting the true shipped bytes."""
        if not self.enabled:
            return
        with self._lock:
            self.wire_raw_bytes += int(raw_bytes)
            self.wire_coded_bytes += int(coded_bytes)
            self.wire_panes += 1
            b = self._node_bucket(self.current_node())
            b["wire_raw_bytes"] += int(raw_bytes)
            b["wire_coded_bytes"] += int(coded_bytes)
            b["wire_panes"] += 1

    def record_pipeline(self, **counts: int):
        """Accumulate pipelined-executor counters (``snapshot()
        ["pipeline"]``)."""
        if not self.enabled:
            return
        with self._lock:
            for key, n in counts.items():
                self._pipeline[key] = self._pipeline.get(key, 0) + int(n)

    def pipeline_counters(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._pipeline)

    def wire_codec_gauges(self) -> Optional[Dict[str, Any]]:
        """Compression summary (None before the first encoded pane)."""
        with self._lock:
            if not self.wire_panes:
                return None
            return {
                "panes": self.wire_panes,
                "raw_bytes": self.wire_raw_bytes,
                "coded_bytes": self.wire_coded_bytes,
                "ratio": (self.wire_raw_bytes / self.wire_coded_bytes
                          if self.wire_coded_bytes else None),
            }

    # -- collective accounting (parallel/ calls these) -------------------------

    def account_collective(self, kind: str, nbytes: int,
                           axis: Optional[str] = None,
                           calls: int = 1):
        """Logical bytes one multi-card collective moves, counted on the
        host from static shapes."""
        if not self.enabled:
            return
        with self._lock:
            st = self._collectives.setdefault(
                kind, {"calls": 0, "bytes": 0}
            )
            st["calls"] += int(calls)
            st["bytes"] += int(nbytes)
            if axis is not None:
                self._collective_axes[axis] = (
                    self._collective_axes.get(axis, 0) + int(nbytes)
                )
            b = self._node_bucket(self.current_node())
            b["collective_calls"] += int(calls)
            b["collective_bytes"] += int(nbytes)

    def account_halo_state(self, nbytes: int):
        """Unpadded boundary-state bytes one halo exchange shipped."""
        if not self.enabled:
            return
        with self._lock:
            self._halo_state_bytes += int(nbytes)

    def collective_gauges(self) -> Optional[Dict[str, Any]]:
        """Collective summary (None before the first collective)."""
        with self._lock:
            if not self._collectives:
                return None
            out = {
                "calls": sum(s["calls"]
                             for s in self._collectives.values()),
                "bytes": sum(s["bytes"]
                             for s in self._collectives.values()),
                "by_kind": {k: dict(s)
                            for k, s in self._collectives.items()},
                "by_axis": dict(self._collective_axes),
            }
            if self._halo_state_bytes:
                out["halo_state_bytes"] = self._halo_state_bytes
            return json_safe(out)

    # -- overload shed accounting (overload.py calls it) -----------------------

    def record_shed(self, n_events: int, nbytes: int = 0):
        """Events an overload controller shed before an assembler."""
        if not self.enabled:
            return
        with self._lock:
            self.shed_events += int(n_events)
            self.shed_bytes += int(nbytes)
            b = self._node_bucket(self.current_node())
            b["shed_events"] += int(n_events)
            b["shed_bytes"] += int(nbytes)

    # -- watermark / lateness gauges ------------------------------------------

    def record_watermark_lag(self, lag_ms: int):
        """Event-time ms between a fired window's end and the watermark at
        fire time. Feeds the max gauge and the lag histogram."""
        if not self.enabled:
            return
        with self._lock:
            self.watermark_lag.observe(float(lag_ms))
            if lag_ms > self.max_watermark_lag_ms:
                self.max_watermark_lag_ms = int(lag_ms)

    def record_shard_watermark(self, shard: int, watermark_ms: int):
        """Per-shard event-time high-water mark on the grid-partitioned
        path (``parallel/halo.py`` feeds it from each window's owned
        rows); the merged min over shards is the safe watermark."""
        if not self.enabled:
            return
        with self._lock:
            prev = self._shard_watermarks.get(int(shard))
            if prev is None or int(watermark_ms) > prev:
                self._shard_watermarks[int(shard)] = int(watermark_ms)

    def shard_watermark_gauges(self) -> Optional[Dict[str, Any]]:
        with self._lock:
            if not self._shard_watermarks:
                return None
            return json_safe({
                "per_shard": {
                    str(s): self._shard_watermarks[s]
                    for s in sorted(self._shard_watermarks)
                },
                "merged_min": min(self._shard_watermarks.values()),
                "shards": len(self._shard_watermarks),
            })

    # -- link-health probe gauges ----------------------------------------------

    LINK_SAMPLES_MAX = 256

    def record_link_sample(self, latency_ms: float, roundtrip_mbps: float,
                           payload_bytes: int):
        """One LinkProbe round trip: bounded rolling gauges, an instant
        event and a paced stream flush."""
        if not self.enabled:
            return
        sample = {
            "unix": time.time(),
            "latency_ms": float(latency_ms),
            "roundtrip_mbps": float(roundtrip_mbps),
            "payload_bytes": int(payload_bytes),
        }
        with self._lock:
            self._link_samples.append(sample)
            if len(self._link_samples) > self.LINK_SAMPLES_MAX:
                del self._link_samples[0]
        self.emit_instant("link_probe", latency_ms=float(latency_ms),
                          roundtrip_mbps=float(roundtrip_mbps))
        self.maybe_flush_stream()

    def link_gauges(self) -> Optional[Dict[str, Any]]:
        """Rolling link summary (None before the first sample)."""
        with self._lock:
            samples = list(self._link_samples)
        if not samples:
            return None
        lat = sorted(s["latency_ms"] for s in samples)
        bw = sorted(s["roundtrip_mbps"] for s in samples)
        mid = len(samples) // 2
        return json_safe({
            "samples": len(samples),
            "latency_ms_p50": lat[mid],
            "latency_ms_last": samples[-1]["latency_ms"],
            "roundtrip_mbps_p50": bw[mid],
            "roundtrip_mbps_last": samples[-1]["roundtrip_mbps"],
            "payload_bytes": samples[-1]["payload_bytes"],
        })

    def record_late_drop(self, n: int = 1):
        if not self.enabled:
            return
        with self._lock:
            self.late_drops += int(n)

    # -- event-time end-to-end latency -----------------------------------------

    #: Stage vocabulary, pipeline order: ``assemble`` = window fired at
    #: the source clock; ``ship``/``compute``/``fetch`` = the pipelined
    #: boundary crossings; ``commit`` = the sink's append.
    E2E_STAGES = ("assemble", "ship", "compute", "fetch", "commit")

    #: Open per-window entries are bounded; the oldest window end evicts
    #: first, and evictions are counted.
    E2E_OPEN_MAX = 4096

    def record_e2e(self, win_end_ms, stage: str,
                   node: Optional[str] = None) -> Optional[float]:
        """One stage boundary of one window's latency lineage.

        The first stamp of a window anchors it: its ``assemble`` latency
        is wall-now minus the *virtual* wall time of the window's end,
        where the capture-wide anchor (the first stamp ever) maps event
        time onto the wall clock. Every later stage records the assemble
        latency plus the wall time since the window's first stamp, so
        stage differences are real wall durations. ``commit`` closes the
        entry. Returns the latency in ms (None while disabled)."""
        if not self.enabled:
            return None
        now_mono = time.monotonic()
        with self._lock:
            key = int(win_end_ms)
            entry = self._e2e_open.get(key)
            if entry is None:
                wall = time.time()
                if self._e2e_anchor is None:
                    self._e2e_anchor = (float(wall), float(win_end_ms))
                a_wall, a_ev = self._e2e_anchor
                virtual_wall = a_wall + (float(win_end_ms) - a_ev) / 1e3
                entry = {
                    "assemble_ms": max((wall - virtual_wall) * 1e3, 0.0),
                    "t0": now_mono,
                }
                if len(self._e2e_open) >= self.E2E_OPEN_MAX:
                    self._e2e_open.pop(min(self._e2e_open))
                    self._e2e_evicted += 1
                self._e2e_open[key] = entry
            if stage == "assemble":
                lat_ms = entry["assemble_ms"]
            else:
                lat_ms = (entry["assemble_ms"]
                          + (now_mono - entry["t0"]) * 1e3)
            self._e2e_bucket(None, stage).observe(lat_ms)
            if node is None:
                node = self.current_node()
            if node is not None:
                self._e2e_bucket(node, stage).observe(lat_ms)
            if stage == "commit":
                self._e2e_open.pop(key, None)
        return float(lat_ms)

    def _e2e_bucket(self, node: Optional[str],
                    stage: str) -> FixedBucketLatency:
        """The (node, stage) histogram (caller holds the lock)."""
        d = (self._e2e_stages if node is None
             else self._e2e_nodes.setdefault(str(node), {}))
        b = d.get(stage)
        if b is None:
            b = d[stage] = FixedBucketLatency()
        return b

    def e2e_stage_percentiles(self, stage: str,
                              node: Optional[str] = None):
        """(p50_ms, p99_ms) of one stage — global when ``node`` is None;
        (None, None) before the first observation."""
        with self._lock:
            d = (self._e2e_stages if node is None
                 else self._e2e_nodes.get(str(node), {}))
            lat = d.get(stage)
            if lat is None or not lat.count:
                return (None, None)
            p50 = lat.percentile(0.50)
            p99 = lat.percentile(0.99)
        return (None if p50 != p50 else float(p50),
                None if p99 != p99 else float(p99))

    def e2e_gauges(self) -> Optional[Dict[str, Any]]:
        """The snapshot ``e2e`` block (None before the first stamp)."""
        with self._lock:
            if not self._e2e_stages and not self._e2e_nodes:
                return None

            def block(d: Dict[str, FixedBucketLatency]) -> Dict[str, Any]:
                out = {}
                for stage, lat in d.items():
                    p50 = lat.percentile(0.50)
                    p99 = lat.percentile(0.99)
                    out[stage] = {
                        "count": lat.count,
                        "sum_ms": lat.sum_ms,
                        "p50_ms": None if p50 != p50 else p50,
                        "p99_ms": None if p99 != p99 else p99,
                    }
                return out

            out: Dict[str, Any] = {"stages": block(self._e2e_stages)}
            if self._e2e_nodes:
                out["nodes"] = {n: block(d)
                                for n, d in self._e2e_nodes.items()}
            if self._e2e_anchor is not None:
                out["anchor"] = {"wall_unix": self._e2e_anchor[0],
                                 "event_ms": self._e2e_anchor[1]}
            out["open_windows"] = len(self._e2e_open)
            if self._e2e_evicted:
                out["evicted"] = self._e2e_evicted
        return json_safe(out)

    # -- flight recorder -------------------------------------------------------

    def dump_blackbox(self, reason: str) -> Optional[str]:
        """Write the flight-recorder ring beside the ledger stream as
        ``<stream>.blackbox.json`` (the last window summaries and
        instants, and a counter snapshot). No-op without a ring or a
        stream path; an OSError is swallowed, never raised into the crash
        path that triggered the dump."""
        with self._lock:
            if self._blackbox is None or self.stream_path is None:
                return None
            path = self.stream_path + ".blackbox.json"
            doc = {
                "blackbox_version": 1,
                "reason": str(reason),
                "unix": time.time(),
                "stream": self.stream_path,
                "ring": list(self._blackbox),
                "counters": {
                    "events": len(self.events),
                    "dropped_events": self.dropped_events,
                    "h2d_bytes": self.h2d_bytes,
                    "d2h_bytes": self.d2h_bytes,
                    "compiles": len(self.compile_events),
                    "late_drops": self.late_drops,
                    "fault_fires": dict(self.fault_fires),
                    "driver_retries": self.driver_retries,
                    "driver_failovers": self.driver_failovers,
                },
            }
            e2e = self.e2e_gauges()
            if e2e is not None:
                doc["e2e"] = e2e
            doc, _ = _sanitize_nonfinite(json_safe(doc))
            try:
                with open(path, "w") as f:
                    json.dump(doc, f, allow_nan=False)
                    f.write("\n")
            except OSError:
                return None
        return path

    def _blackbox_append(self, rec: Dict[str, Any]):
        """Ring append (caller holds the lock)."""
        if self._blackbox is not None:
            self._blackbox.append(rec)

    # -- fault tolerance -------------------------------------------------------

    def record_fault(self, point: str, kind: str = "raise", hit: int = 0):
        """One injected fault fired. The instant is force-flushed and the
        black box dumped: a fault is the record that must survive the
        crash it is about to cause."""
        if not self.enabled:
            return
        with self._lock:
            self.fault_fires[point] = self.fault_fires.get(point, 0) + 1
            self._node_bucket(self.current_node())["fault_fires"] += 1
        self.emit_instant(f"fault_fired:{point}", kind=kind, hit=int(hit))
        self.maybe_flush_stream(force=True)
        bb = self.dump_blackbox(f"fault:{point}")
        if bb is not None:
            self.emit_instant("blackbox_dumped",
                              reason=f"fault:{point}", path=bb)
            self.maybe_flush_stream(force=True)

    def record_driver_retry(self, window_start: int, attempt: int,
                            error: str):
        """A driver retried a failed window on the same backend."""
        if not self.enabled:
            return
        with self._lock:
            self.driver_retries += 1
        self.emit_instant("driver_retry", window_start=int(window_start),
                          attempt=int(attempt), error=str(error)[:200])

    def record_driver_failover(self, window_start: int, error: str):
        """A driver switched backends mid-stream (force-flushed)."""
        if not self.enabled:
            return
        with self._lock:
            self.driver_failovers += 1
        self.emit_instant("failover", window_start=int(window_start),
                          to="fallback", error=str(error)[:200])
        self.maybe_flush_stream(force=True)

    # -- export ---------------------------------------------------------------

    def register_metrics(self, registry):
        """Wire the telemetry gauges into an ``mn.metrics.MetricRegistry``
        so its ``snapshot()`` (NES reporter lines, sink registries)
        carries them."""
        registry.gauge("watermark_lag_ms_max",
                       lambda: self.max_watermark_lag_ms)
        registry.gauge("late_dropped_total", lambda: self.late_drops)
        registry.gauge("telemetry_compiles_total",
                       lambda: len(self.compile_events))
        registry.gauge("h2d_bytes_total", lambda: self.h2d_bytes)
        registry.gauge("d2h_bytes_total", lambda: self.d2h_bytes)
        registry.gauge(
            "compaction_buckets_total",
            lambda: sum(len(v) for v in self._compaction.values()),
        )

    def summary(self) -> Dict[str, Any]:
        """The bench block: strict JSON (numpy scalars → builtins, NaN
        percentiles → None)."""
        with self._lock:
            p50 = self.window_latency.percentile(0.50)
            p95 = self.window_latency.percentile(0.95)
            lag99 = self.watermark_lag.percentile(0.99)
            out = {
                "compiles": len(self.compile_events),
                "bytes_h2d": self.h2d_bytes,
                "bytes_d2h": self.d2h_bytes,
                "window_latency_p50_ms": None if p50 != p50 else p50,
                "window_latency_p95_ms": None if p95 != p95 else p95,
                "max_watermark_lag_ms": self.max_watermark_lag_ms,
                "watermark_lag_p99_ms": None if lag99 != lag99 else lag99,
                "late_dropped": self.late_drops,
            }
        return json_safe(out)

    def snapshot(self) -> Dict[str, Any]:
        """Full JSON-safe state dump (summary + transfer/trace counts and
        the additive blocks once their producers ran)."""
        out = self.summary()
        with self._lock:
            out.update(
                h2d_transfers=self.h2d_transfers,
                d2h_transfers=self.d2h_transfers,
                events=len(self.events),
                dropped_events=self.dropped_events,
                kernels={k: len(v) for k, v in self._shapes_seen.items()},
                compaction={
                    eng: {str(cap): dict(st) for cap, st in caps.items()}
                    for eng, caps in self._compaction.items()
                },
                # Always present, so consumers gate on zero, not absence.
                driver={
                    "retries": self.driver_retries,
                    "failovers": self.driver_failovers,
                },
            )
            if self.fault_fires:
                out["faults"] = dict(self.fault_fires)
            if self.shed_events or self.shed_bytes:
                out["shed"] = {"events": self.shed_events,
                               "bytes": self.shed_bytes}
            if self._pipeline:
                out["pipeline"] = dict(self._pipeline)
            if self.wire_panes:
                out["wire_codec"] = {
                    "panes": self.wire_panes,
                    "raw_bytes": self.wire_raw_bytes,
                    "coded_bytes": self.wire_coded_bytes,
                    "ratio": (
                        self.wire_raw_bytes / self.wire_coded_bytes
                        if self.wire_coded_bytes else None
                    ),
                }
        for key, provider in (("overload", self.overload_provider),
                              ("qserve", self.qserve_provider),
                              ("dag", self.dag_provider)):
            if provider is not None:
                try:
                    out[key] = json_safe(provider())
                except Exception:  # a broken provider must not break snapshots
                    pass
        link = self.link_gauges()
        if link is not None:
            out["link_probe"] = link
        e2e = self.e2e_gauges()
        if e2e is not None:
            out["e2e"] = e2e
        nodes = self.node_rollup()
        if nodes:
            out["nodes"] = nodes
        coll = self.collective_gauges()
        if coll is not None:
            out["collectives"] = coll
        shard_wm = self.shard_watermark_gauges()
        if shard_wm is not None:
            out["shard_watermarks"] = shard_wm
        # The ablation taint rides every snapshot, stream checkpoints
        # included.
        taint = ablation.taint_block()
        if taint is not None:
            out["tainted"] = taint
        return json_safe(out)


telemetry = Telemetry()


def enable(trace_path: Optional[str] = None, recompile_warn_threshold: int = 8):
    telemetry.enable(trace_path, recompile_warn_threshold)


def disable():
    telemetry.disable()


def span(name: str, **args):
    return telemetry.span(name, **args)


def scope(node: Optional[str]):
    return telemetry.scope(node)


def fetch(x):
    return telemetry.fetch(x)


def write_ledger(path: str, bench: Optional[dict] = None, mesh=None,
                 capture_costs: bool = True) -> str:
    return telemetry.write_ledger(path, bench=bench, mesh=mesh,
                                  capture_costs=capture_costs)


class LinkProbe:
    """Host↔device link probe: a tiny fixed-shape round trip for latency
    (8 floats) and one fixed payload (default 256 KiB) shipped out and
    copied back for bandwidth. The copy back (``.cpu()``) is the sync, so
    the round trip is what is timed; bandwidth is the round-trip
    aggregate ``2·payload/elapsed``.

    Call ``sample()`` at phase boundaries, never inside a window span.
    Samples feed the rolling gauges (the snapshot's ``link_probe``
    block)."""

    def __init__(self, device=None, payload_bytes: int = 262_144,
                 tel: Optional[Telemetry] = None):
        import torch

        self.device = torch.device("cuda" if device is None else device)
        self.payload_bytes = int(payload_bytes)
        self._tel = tel
        # Fixed shapes, allocated once (pinned on a card, so the copies
        # are real DMA transfers).
        pin = self.device.type == "cuda"
        self._tiny = torch.zeros(8, dtype=torch.float32, pin_memory=pin)
        self._payload = torch.zeros(max(self.payload_bytes // 4, 1),
                                    dtype=torch.float32, pin_memory=pin)

    def sample(self) -> Dict[str, float]:
        """One probe round trip; records into the telemetry gauges (when
        enabled) and returns the raw sample."""
        t0 = time.perf_counter()
        self._tiny.to(self.device).cpu()
        latency_ms = (time.perf_counter() - t0) * 1e3
        t1 = time.perf_counter()
        got = self._payload.to(self.device).cpu()
        dt = max(time.perf_counter() - t1, 1e-9)
        nbytes = got.numel() * got.element_size()
        roundtrip_mbps = 2.0 * float(nbytes) / dt / 1e6
        tel = self._tel if self._tel is not None else telemetry
        tel.record_link_sample(latency_ms, roundtrip_mbps, int(nbytes))
        return {
            "latency_ms": float(latency_ms),
            "roundtrip_mbps": float(roundtrip_mbps),
            "payload_bytes": int(nbytes),
        }


def instrument_jit(fn, name: Optional[str] = None):
    """Wrap a window or pane program (any callable) with, in order:

    1. the ``device.dispatch`` fault injection point;
    2. the ablation substitution (``ablation.py``), outside the table;
    3. when telemetry is enabled, the abstract signature (distinct-shape
       detection) and the dispatch table.

    The name keeps the JAX package's, so a label means the same kernel in
    both packages. On the card launches are asynchronous: the time
    recorded is HOST DISPATCH wall-ns, never kernel time. Disabled cost:
    one attribute check per call (calls here are per window or pane,
    never per record). Attributes of the wrapped callable pass through.
    """
    label = name or getattr(fn, "__name__", repr(fn))

    class _Instrumented:
        __slots__ = ()

        def __call__(self, *args, **kwargs):
            if faults.armed:  # fault injection point (faults.py)
                faults.hit("device.dispatch")
            if ablation.armed and ablation.matches(label):
                # Profiling only: cached zeros after one learning call;
                # outside the table, and the capture is tainted.
                return ablation.dispatch(label, fn, args, kwargs)
            if not telemetry.enabled:
                return fn(*args, **kwargs)
            sig = abstract_signature(args, kwargs)
            telemetry.record_jit_call(label, sig)
            t0 = time.perf_counter_ns()
            out = fn(*args, **kwargs)
            telemetry.record_kernel_time(
                label, sig, time.perf_counter_ns() - t0)
            return out

        def __getattr__(self, attr):
            return getattr(fn, attr)

    return _Instrumented()


def load_trace(path: str) -> Dict[str, Any]:
    """Read a JSON-lines trace file into the Chrome-trace document
    ``{"traceEvents": [...]}`` (chrome://tracing, Perfetto)."""
    events = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                events.append(json.loads(line))
    return {"traceEvents": events}
