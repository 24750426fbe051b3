"""Runtime telemetry in the PyTorch port (``spatialflink_tpu_torch/
telemetry.py``): spans and the Chrome trace, the distinct-shape detector
and dispatch table, host↔device byte accounting, the watermark and
late-drop gauges, the metric-registry export, the ledger and its stream,
and parity with the JAX package's telemetry on the same seeded streams.

One case for each case of ``tests/test_telemetry.py`` (23) and of
``tests/test_ledger_stream.py`` (13); all apply. The port's counterparts
of jitted JAX functions are plain callables and tensors; the
attribute-passthrough case reads an attribute of a callable object
instead of ``jax.jit``'s ``lower``.

Then the ``tools/sfprof`` tools on the port's artifacts (the ledger
validates, every instant name the port emits is classified), and parity:
the same seeded CPU stream through a JAX operator with the JAX telemetry
on and through the port's with the port's on. Equal: the span names and
their nesting per window, late drops, the max watermark lag and its
histogram, compaction buckets, wire raw and coded bytes, fetch counts and
d2h bytes, the NES reporter line's lag and late-drop columns, and
``MetricsSink(include_telemetry=True)``'s columns. Differing by design,
and asserted as such: the port counts the flag table's h2d bytes (it
ships it through ``ship``; the JAX operators through a bare
``jnp.asarray``). Both operators' ``run`` go through their strict
drivers, which stamp the same e2e stages.

Every test leaves both packages' ``telemetry``, ``faults`` and
``ablation`` singletons disarmed, disabled and reset, and ``max_events``
restored.
"""

import json
import threading
import warnings

import jax
import numpy as np
import pytest
import torch

from spatialflink_tpu import ablation as j_ablation_mod
from spatialflink_tpu import faults as j_faults_mod
from spatialflink_tpu import pipeline as jpipeline
from spatialflink_tpu import telemetry as j_tel_mod
from spatialflink_tpu.grid import UniformGrid as JGrid
from spatialflink_tpu.mn import MetricRegistry as JRegistry
from spatialflink_tpu.mn import NESFileReporter as JReporter
from spatialflink_tpu.models.objects import Point as JPoint
from spatialflink_tpu.operators import PointPointKNNQuery as JKnn
from spatialflink_tpu.operators import PointPointRangeQuery as JRangeQ
from spatialflink_tpu.operators import QueryConfiguration as JConf
from spatialflink_tpu.operators import QueryType as JQT
from spatialflink_tpu.sncb.metrics import MetricsSink as JMetricsSink
from spatialflink_tpu.streams.wire import WireFormat as JWireFormat

from spatialflink_tpu_torch import pipeline as tpipeline
from spatialflink_tpu_torch.ablation import ablation
from spatialflink_tpu_torch.faults import faults
from spatialflink_tpu_torch.grid import UniformGrid
from spatialflink_tpu_torch.mn import MetricRegistry, NESFileReporter
from spatialflink_tpu_torch.models.objects import Point
from spatialflink_tpu_torch.operators import (
    PointPointKNNQuery,
    PointPointRangeQuery,
    QueryConfiguration,
    QueryType,
)
from spatialflink_tpu_torch.operators import base as base_mod
from spatialflink_tpu_torch.sncb.metrics import MetricsSink
from spatialflink_tpu_torch.streams.soa import SoaWindowAssembler
from spatialflink_tpu_torch.streams.wire import WireFormat, wire_panes
from spatialflink_tpu_torch.streams.windows import (
    TumblingEventTimeWindows,
    WindowAssembler,
)
from spatialflink_tpu_torch.telemetry import (
    LEDGER_VERSION,
    STREAM_VERSION,
    LinkProbe,
    RecompileWarning,
    abstract_signature,
    instrument_jit,
    load_trace,
    telemetry,
)
from tools.sfprof import events as events_mod
from tools.sfprof import ledger as ledger_mod
from tools.sfprof import stream as stream_mod
from tools.sfprof.cli import main as sfprof_main

GRID = UniformGrid(20, 0.0, 10.0, 0.0, 10.0)
JGRID = JGrid(20, 0.0, 10.0, 0.0, 10.0)


def reset_runtime_singletons():
    """Disarm, disable and reset both packages' runtime singletons (the
    ``tests/test_ledger_stream.py`` idiom: enable() resets every counter,
    disable() seals)."""
    for fl, ab, tel in (
            (faults, ablation, telemetry),
            (j_faults_mod.faults, j_ablation_mod.ablation,
             j_tel_mod.telemetry)):
        fl.disarm()
        ab.disarm()
        tel.enable()
        tel.disable()
        ab.reset_counters()


@pytest.fixture(autouse=True)
def _runtime_off():
    caps = (telemetry.max_events, j_tel_mod.telemetry.max_events)
    yield
    telemetry.max_events, j_tel_mod.telemetry.max_events = caps
    reset_runtime_singletons()


# -- disabled-by-default contract ---------------------------------------------


def test_disabled_by_default_and_free():
    assert telemetry.enabled is False
    # The disabled span is ONE shared null object.
    assert telemetry.span("window.x") is telemetry.span("window.y")
    telemetry.account_h2d(4096)
    telemetry.account_d2h(4096)
    telemetry.record_late_drop()
    telemetry.record_watermark_lag(17)
    telemetry.record_jit_call("k", ((4,),))
    assert telemetry.h2d_bytes == 0
    assert telemetry.d2h_bytes == 0
    assert telemetry.late_drops == 0
    assert telemetry.max_watermark_lag_ms == 0
    assert telemetry.compile_count == 0


def test_fetch_passthrough_when_disabled():
    out = telemetry.fetch(torch.arange(8))
    np.testing.assert_array_equal(np.asarray(out), np.arange(8))
    assert isinstance(out, np.ndarray)
    assert telemetry.d2h_transfers == 0


def test_enable_resets_state():
    telemetry.enable()
    telemetry.account_h2d(100)
    telemetry.record_watermark_lag(9)
    telemetry.enable()
    assert telemetry.h2d_bytes == 0
    assert telemetry.max_watermark_lag_ms == 0


# -- spans / Chrome trace -----------------------------------------------------


def test_spans_nest_and_trace_is_chrome_loadable(tmp_path):
    path = tmp_path / "trace.jsonl"
    telemetry.enable(trace_path=str(path))
    with telemetry.span("window.test", events=3):
        with telemetry.span("assemble"):
            pass
        with telemetry.span("compute"):
            pass
    telemetry.disable()

    doc = load_trace(str(path))
    json.dumps(doc)
    assert set(doc) == {"traceEvents"}
    spans = [e for e in doc["traceEvents"] if e["ph"] == "X"]
    meta = [e for e in doc["traceEvents"] if e["ph"] == "M"]
    assert {m["name"] for m in meta} == {"process_name", "thread_name"}
    evs = {e["name"]: e for e in spans}
    assert set(evs) == {"window.test", "assemble", "compute"}
    for e in spans:
        assert isinstance(e["ts"], int) and isinstance(e["dur"], int)
        assert "pid" in e and "tid" in e
    win = evs["window.test"]
    assert win["args"] == {"events": 3}
    for child in ("assemble", "compute"):
        c = evs[child]
        assert win["ts"] <= c["ts"]
        assert c["ts"] + c["dur"] <= win["ts"] + win["dur"] + 1


def test_window_spans_feed_latency_histogram():
    telemetry.enable()
    with telemetry.span("window.knn"):
        pass
    with telemetry.span("assemble"):  # not a window: no latency
        pass
    assert telemetry.window_latency.count == 1
    s = telemetry.summary()
    assert s["window_latency_p50_ms"] is not None
    assert s["window_latency_p95_ms"] is not None


def test_event_buffer_caps_and_counts_drops():
    telemetry.enable()
    telemetry.max_events = 4
    for i in range(6):
        with telemetry.span(f"s{i}"):
            pass
    assert len(telemetry.events) == 4
    assert telemetry.dropped_events == 2


def test_trace_file_roundtrip_and_drop_counter_pinned(tmp_path):
    path = tmp_path / "cap.jsonl"
    telemetry.enable(trace_path=str(path))
    telemetry.max_events = 2
    for i in range(5):
        with telemetry.span(f"s{i}"):
            pass
    assert len(telemetry.events) == 2
    assert telemetry.dropped_events == 3
    assert telemetry.snapshot()["dropped_events"] == 3
    telemetry.disable()

    doc = load_trace(str(path))
    spans = [e for e in doc["traceEvents"] if e["ph"] == "X"]
    assert [e["name"] for e in spans] == [f"s{i}" for i in range(5)]
    assert spans[:2] == telemetry.events


def test_disable_mid_span_exit_is_silent(tmp_path):
    telemetry.enable(trace_path=str(tmp_path / "mid.jsonl"))
    sp = telemetry.span("window.mid")
    sp.__enter__()
    telemetry.disable()
    assert sp.__exit__(None, None, None) is False
    assert all(e.get("name") != "window.mid" for e in telemetry.events)
    assert telemetry.window_latency.count == 0


def test_trace_metadata_names_process_and_threads(tmp_path):
    path = tmp_path / "meta.jsonl"
    telemetry.enable(trace_path=str(path))
    with telemetry.span("window.a"):
        pass
    with telemetry.span("window.b"):
        pass

    def emit():
        with telemetry.span("window.worker"):
            pass

    t = threading.Thread(target=emit, name="op-worker")
    t.start()
    t.join(timeout=30)
    assert not t.is_alive()
    telemetry.disable()

    evs = load_trace(str(path))["traceEvents"]
    procs = [e for e in evs if e["ph"] == "M"
             and e["name"] == "process_name"]
    threads = [e for e in evs if e["ph"] == "M"
               and e["name"] == "thread_name"]
    assert len(procs) == 1
    assert procs[0]["args"]["name"].startswith("spatialflink_tpu_torch:")
    assert len(threads) == 2
    names = {e["tid"]: e["args"]["name"] for e in threads}
    assert "op-worker" in names.values()
    for tid in names:
        first_meta = next(i for i, e in enumerate(evs)
                          if e["ph"] == "M" and e.get("tid") == tid)
        first_span = next(i for i, e in enumerate(evs)
                          if e["ph"] == "X" and e.get("tid") == tid)
        assert first_meta < first_span


def test_account_d2h_emits_counter_event_like_h2d(tmp_path):
    path = tmp_path / "counters.jsonl"
    telemetry.enable(trace_path=str(path))
    telemetry.account_h2d(64)
    telemetry.account_d2h(128)
    telemetry.account_d2h(128)
    telemetry.disable()
    counters = [e for e in load_trace(str(path))["traceEvents"]
                if e["ph"] == "C"]
    assert [e["args"]["bytes"] for e in counters
            if e["name"] == "h2d_bytes"] == [64]
    assert [e["args"]["bytes"] for e in counters
            if e["name"] == "d2h_bytes"] == [128, 256]


# -- distinct-shape detection ---------------------------------------------------


def test_recompile_detector_two_bucket_sizes_two_events():
    telemetry.enable()
    f = instrument_jit(lambda x: x * 2, name="double")
    f(torch.ones(64))
    f(torch.ones(64))  # same abstract shape: no new event
    assert telemetry.compile_count == 1
    f(torch.ones(128))  # bucket growth: a second shape
    assert telemetry.compile_count == 2
    assert telemetry.distinct_shapes("double") == 2
    assert [k for k, _ in telemetry.compile_events] == ["double", "double"]


def test_recompile_threshold_warns_once():
    telemetry.enable(recompile_warn_threshold=3)
    f = instrument_jit(lambda x: x + 1, name="churny")
    with warnings.catch_warnings():
        warnings.simplefilter("error", RecompileWarning)
        f(torch.ones(8))
        f(torch.ones(16))
    with pytest.warns(RecompileWarning, match="churny"):
        f(torch.ones(32))
    with warnings.catch_warnings():
        warnings.simplefilter("error", RecompileWarning)
        f(torch.ones(64))  # warned already: once per kernel


def test_recompile_detector_sees_tuple_arg_shape_churn():
    telemetry.enable()
    f = instrument_jit(lambda xs, bases: sum(xs) + bases, name="merge")
    small = tuple(torch.ones(64) for _ in range(2))
    grown = tuple(torch.ones(128) for _ in range(2))
    bases = torch.zeros(())
    f(small, bases)
    f(small, bases)
    assert telemetry.compile_count == 1
    f(grown, bases)
    assert telemetry.compile_count == 2
    assert telemetry.distinct_shapes("merge") == 2


def test_abstract_signature_statics_and_dtypes():
    a32 = torch.zeros((4, 2), dtype=torch.float32)
    assert abstract_signature((a32,)) == abstract_signature(
        (torch.ones((4, 2), dtype=torch.float32),))  # values don't key it
    assert abstract_signature((a32,)) != abstract_signature(
        (torch.zeros((4, 2), dtype=torch.float64),))  # dtype does
    # numpy arrays key the same way
    assert abstract_signature((np.zeros(3, np.int32),)) == \
        abstract_signature((np.ones(3, np.int32),))
    assert abstract_signature((), {"k": 5}) != abstract_signature(
        (), {"k": 6})
    t1 = (torch.zeros((8, 4), dtype=torch.int32),
          torch.zeros((8, 4), dtype=torch.bool))
    t2 = (torch.ones((8, 4), dtype=torch.int32),
          torch.ones((8, 4), dtype=torch.bool))
    assert abstract_signature((), {"e": t1}) == abstract_signature(
        (), {"e": t2})
    assert abstract_signature((), {"e": t1}) != abstract_signature(
        (), {"e": (torch.zeros((4, 4), dtype=torch.int32),
                   torch.zeros((4, 4), dtype=torch.bool))})


def test_instrument_jit_passes_attributes_through():
    class Prog:
        launches = 3

        def __call__(self, x):
            return x + 1

    prog = Prog()
    f = instrument_jit(prog, name="attrs")
    assert f.launches == 3 and f(1) == 2


# -- device-boundary accounting -----------------------------------------------


def test_fetch_accounts_bytes_and_emits_event():
    telemetry.enable()
    x = torch.arange(1024, dtype=torch.float32)
    out = telemetry.fetch((x, x))
    np.testing.assert_array_equal(out[0], np.arange(1024, dtype=np.float32))
    assert telemetry.d2h_transfers == 1
    assert telemetry.d2h_bytes == 2 * 1024 * 4
    (ev,) = [e for e in telemetry.events if e["name"] == "fetch"]
    assert ev["args"]["bytes"] == 2 * 1024 * 4


def test_operator_ship_path_accounts_h2d():
    telemetry.enable()
    conf = QueryConfiguration(QueryType.WindowBased, window_size=10,
                              slide_step=5)
    op = PointPointRangeQuery(conf, GRID, device="cpu")
    op.device_q(np.zeros((16, 2)))
    assert telemetry.h2d_transfers == 1
    assert telemetry.h2d_bytes == 16 * 2 * 4  # float32 after centring
    base_mod.ship(np.ones(16, bool), np.zeros(16, np.int32), None,
                  device=torch.device("cpu"))
    assert telemetry.h2d_transfers == 2  # one a ship call
    assert telemetry.h2d_bytes == 16 * 2 * 4 + 16 + 16 * 4


# -- watermark / lateness gauges ----------------------------------------------


def _soa_chunk(*ts):
    a = np.asarray(ts, np.int64)
    return {"ts": a, "x": np.zeros(len(a)), "y": np.zeros(len(a)),
            "oid": np.zeros(len(a), np.int32)}


def test_soa_assembler_feeds_gauges():
    telemetry.enable()
    asm = SoaWindowAssembler(10, 5)
    asm.feed(_soa_chunk(1, 3, 9))
    asm.feed(_soa_chunk(27))  # fires [0,10) at wm=27 → lag 17
    assert telemetry.max_watermark_lag_ms == 17
    asm.feed(_soa_chunk(2))  # older than every live window
    asm.feed(_soa_chunk(38))  # the next consolidation counts the drop
    assert asm.dropped_late == 1
    assert telemetry.late_drops == 1
    assert telemetry.max_watermark_lag_ms == 17
    asm.flush()  # the artificial end-of-stream watermark: no lag spike
    assert telemetry.max_watermark_lag_ms == 17


def test_object_assembler_feeds_gauges():
    telemetry.enable()
    asm = WindowAssembler(TumblingEventTimeWindows(10),
                          timestamp_fn=lambda e: e.timestamp)
    asm.feed(Point(obj_id="a", timestamp=1, x=0.0, y=0.0))
    fired = asm.feed(Point(obj_id="a", timestamp=25, x=0.0, y=0.0))
    assert len(fired) == 1
    assert telemetry.max_watermark_lag_ms == 15
    asm.feed(Point(obj_id="a", timestamp=2, x=0.0, y=0.0))  # late
    assert telemetry.late_drops == 1


# -- telemetry must never change results --------------------------------------


def _points(cls, n=400, seed=0, late_every=0):
    """A seeded point stream; every ``late_every``-th event is sent 20 s
    late (dropped), when set."""
    rng = np.random.default_rng(seed)
    xy = rng.uniform(0, 10, (n, 2))
    out = []
    for i in range(n):
        ts = int(i * 75)
        if late_every and i % late_every == late_every - 1:
            ts = max(ts - 20_000, 0)
        out.append(cls(obj_id=f"d{i % 7}", timestamp=ts,
                       x=float(xy[i, 0]), y=float(xy[i, 1])))
    return out


def test_range_query_results_identical_with_telemetry(tmp_path):
    conf = QueryConfiguration(QueryType.WindowBased, window_size=10,
                              slide_step=5)
    pts = _points(Point)
    q = Point(x=5.0, y=5.0)

    def run():
        return [(r.start, r.end, sorted(id(o) for o in r.objects))
                for r in PointPointRangeQuery(conf, GRID, device="cpu").run(
                    iter(pts), [q], 2.0)]

    baseline = run()
    telemetry.enable(trace_path=str(tmp_path / "range_trace.jsonl"))
    instrumented = run()
    telemetry.disable()
    assert instrumented == baseline

    doc = load_trace(str(tmp_path / "range_trace.jsonl"))
    names = [e["name"] for e in doc["traceEvents"]]
    assert "window.range" in names
    for phase in ("assemble", "ship", "compute", "fetch"):
        assert phase in names, phase
    assert telemetry.window_latency.count == names.count("window.range")
    fetch_spans = [e for e in doc["traceEvents"]
                   if e["name"] == "fetch" and "bytes" not in e.get("args", {})]
    assert telemetry.d2h_transfers == len(fetch_spans)
    assert telemetry.h2d_bytes > 0 and telemetry.d2h_bytes > 0


# -- export ------------------------------------------------------------------


def test_summary_is_json_safe_and_has_bench_fields():
    telemetry.enable()
    telemetry.account_h2d(np.int64(4096))
    telemetry.record_watermark_lag(np.int32(12))
    s = telemetry.summary()
    json.dumps(s)
    assert set(s) >= {
        "compiles", "bytes_h2d", "bytes_d2h", "window_latency_p50_ms",
        "window_latency_p95_ms", "max_watermark_lag_ms", "late_dropped",
    }
    assert type(s["bytes_h2d"]) is int and s["bytes_h2d"] == 4096
    assert s["max_watermark_lag_ms"] == 12
    assert s["window_latency_p50_ms"] is None
    assert "NaN" not in json.dumps(s)
    json.dumps(telemetry.snapshot())


def test_register_metrics_exports_gauges():
    telemetry.enable()
    telemetry.record_watermark_lag(33)
    telemetry.record_late_drop(2)
    telemetry.account_h2d(128)
    reg = MetricRegistry()
    telemetry.register_metrics(reg)
    snap = reg.snapshot()
    assert snap["watermark_lag_ms_max"] == 33
    assert snap["late_dropped_total"] == 2
    assert snap["h2d_bytes_total"] == 128
    json.dumps(snap)


def test_reporter_line_gains_telemetry_columns(tmp_path):
    telemetry.enable()
    telemetry.record_watermark_lag(21)
    telemetry.record_late_drop(3)
    rep = NESFileReporter(MetricRegistry(), "qtel", out_dir=str(tmp_path))
    line = rep.report(now=1_700_000_000.0)
    assert "watermark_lag_ms_max=21" in line
    assert "late_dropped_total=3" in line
    assert "compiles_total=0" in line
    telemetry.disable()
    line = rep.report(now=1_700_000_001.0)
    assert "watermark_lag_ms_max" not in line


# -- the ledger stream (tests/test_ledger_stream.py) ---------------------------


def _run_stream(tmp_path, name="s.jsonl", windows=3, seal="ledger"):
    """A small instrumented run writing a stream; returns its path."""
    path = str(tmp_path / name)
    telemetry.enable(stream_path=path, stream_flush_interval_s=0.0)
    f = instrument_jit(lambda x: x * 2, name="double")
    for w in range(windows):
        with telemetry.span("window.demo", window=w):
            f(torch.ones(8))
    if seal == "ledger":
        telemetry.write_ledger(str(tmp_path / (name + ".ledger.json")),
                               bench={"value": 10.0})
        telemetry.disable()
    elif seal == "disable":
        telemetry.disable()
    return path


def _records(path):
    with open(path) as f:
        return [json.loads(ln) for ln in f if ln.strip()]


def test_stream_version_constants_in_sync():
    assert stream_mod.STREAM_VERSION == STREAM_VERSION == 3
    assert ledger_mod.LEDGER_VERSION == LEDGER_VERSION == 3


def test_stream_grammar_prologue_segments_epilogue(tmp_path):
    recs = _records(_run_stream(tmp_path))
    assert recs[0]["t"] == "prologue"
    assert recs[0]["stream_version"] == STREAM_VERSION
    assert recs[0]["ledger_version"] == LEDGER_VERSION
    assert recs[0]["created_unix"] > 0
    kinds = [r["t"] for r in recs]
    assert kinds[-1] == "epilogue"
    assert "checkpoint" in kinds and "spans" in kinds
    cks = [r for r in recs if r["t"] == "checkpoint"]
    assert len(cks) >= 3
    assert [c["seq"] for c in cks] == sorted(c["seq"] for c in cks)
    for c in cks:
        assert set(c["snapshot"]) >= {"compiles", "bytes_h2d",
                                      "late_dropped", "kernels"}
    streamed = [e for r in recs if r["t"] == "spans" for e in r["events"]]
    assert [e["name"] for e in streamed
            if e["name"].startswith("window.")] == ["window.demo"] * 3
    ep = recs[-1]
    assert ep["reason"] == "complete"
    assert ep["bench"]["value"] == 10.0


def test_flush_interval_paces_checkpoints(tmp_path):
    path = str(tmp_path / "paced.jsonl")
    telemetry.enable(stream_path=path, stream_flush_interval_s=3600.0)
    for w in range(10):
        with telemetry.span("window.demo", window=w):
            pass
    telemetry.disable()
    recs = _records(path)
    assert sum(r["t"] == "checkpoint" for r in recs) == 1
    batches = [r for r in recs if r["t"] == "spans"]
    assert len(batches) == 1 and len(batches[0]["events"]) == 10


def test_disable_seals_stream_and_flushes_trace(tmp_path):
    trace = tmp_path / "t.jsonl"
    stream = tmp_path / "s.jsonl"
    telemetry.enable(trace_path=str(trace), stream_path=str(stream),
                     stream_flush_interval_s=3600.0)
    n = 5
    assert n < telemetry.FLUSH_EVERY
    for w in range(n):
        with telemetry.span("window.demo", window=w):
            pass
    telemetry.disable()
    recs = _records(str(stream))
    assert recs[-1]["t"] == "epilogue"
    assert recs[-1]["reason"] == "disabled"
    assert len([ln for ln in trace.read_text().splitlines()
                if '"window.demo"' in ln]) == n
    doc, info = stream_mod.recover(str(stream))
    assert ledger_mod.validate(doc) == []
    assert info["sealed"] and info["reason"] == "disabled"


def test_stream_sanitizes_nonfinite_values(tmp_path):
    path = str(tmp_path / "nan.jsonl")
    telemetry.enable(stream_path=path, stream_flush_interval_s=0.0)
    with telemetry.span("window.demo", bad=float("nan")):
        pass
    telemetry.disable()
    ep = _records(path)[-1]
    assert ep["nonfinite_values"] >= 1
    doc, _ = stream_mod.recover(path)
    assert ledger_mod.validate(doc) == []
    assert doc["nonfinite_values"] >= 1


def test_recover_complete_stream_matches_ledger(tmp_path):
    stream = _run_stream(tmp_path)
    doc, info = stream_mod.recover(stream)
    assert ledger_mod.validate(doc) == []
    assert info["sealed"] is True and info["truncated"] is False
    assert info["loss_bound"].startswith("none")
    ledger = ledger_mod.load(stream + ".ledger.json")
    for key in ("compiles", "bytes_h2d", "bytes_d2h", "late_dropped"):
        assert doc["snapshot"][key] == ledger["snapshot"][key]
    assert doc["bench"]["value"] == ledger["bench"]["value"]
    assert [e["name"] for e in doc["events"]
            if e["name"].startswith("window.")] == \
        [e["name"] for e in ledger["events"]
         if e["name"].startswith("window.")]


def test_recover_truncated_stream_loses_at_most_one_interval(tmp_path):
    full = _run_stream(tmp_path, windows=4, seal=None)
    telemetry.maybe_flush_stream(force=True)
    raw = open(full, "rb").read()
    telemetry.disable()
    trunc = tmp_path / "trunc.jsonl"
    trunc.write_bytes(raw[: len(raw) - 25])
    doc, info = stream_mod.recover(str(trunc))
    assert ledger_mod.validate(doc) == []
    assert info["sealed"] is False
    assert info["truncated"] is True and info["partial_tail"] is True
    assert "one flush interval" in info["loss_bound"]
    assert doc["bench"] is None
    assert doc["recovery"]["checkpoints"] >= 3
    assert len([e for e in doc["events"]
                if e["name"].startswith("window.")]) >= 3


def test_recover_stream_killed_before_first_checkpoint(tmp_path):
    path = tmp_path / "young.jsonl"
    telemetry.enable(stream_path=str(path), stream_flush_interval_s=3600)
    with telemetry.span("window.demo"):
        pass
    raw = open(path, "rb").read()
    telemetry.disable()
    young = tmp_path / "young_cut.jsonl"
    young.write_bytes(raw)
    doc, info = stream_mod.recover(str(young))
    assert ledger_mod.validate(doc) == []
    assert info["snapshot_synthesized"] is True
    assert doc["snapshot"]["synthesized"] is True
    assert info["checkpoints"] == 0 and info["sealed"] is False


def test_recover_honors_epilogue_past_partial_tail(tmp_path):
    full = _run_stream(tmp_path, windows=2, seal=None)
    telemetry.maybe_flush_stream(force=True)
    raw = open(full, "rb").read()
    telemetry.disable()
    cut = tmp_path / "sealed_after_cut.jsonl"
    cut.write_bytes(
        raw[: len(raw) - 20]
        + b"\n" + json.dumps({"t": "spans", "seq": 9, "events": [
            {"name": "window.fake", "ph": "X", "ts": 0, "dur": 1,
             "pid": 1, "tid": 1}]}).encode() + b"\n"
        + json.dumps({"t": "epilogue", "unix": 9.0,
                      "reason": "terminated (SIGTERM)",
                      "sealed_by": "supervisor"}).encode() + b"\n"
    )
    doc, info = stream_mod.recover(str(cut))
    assert ledger_mod.validate(doc) == []
    assert info["sealed"] is True
    assert info["sealed_by"] == "supervisor"
    assert info["reason"] == "terminated (SIGTERM)"
    assert info["partial_tail"] is True and info["truncated"] is True
    assert info["skipped_lines"] == 1
    assert all(e["name"] != "window.fake" for e in doc["events"])


def test_supervisor_seal_on_clean_boundary_still_truncated(tmp_path):
    full = _run_stream(tmp_path, windows=2, seal=None)
    telemetry.maybe_flush_stream(force=True)
    raw = open(full, "rb").read()
    telemetry.disable()
    crashed = tmp_path / "crashed.jsonl"
    crashed.write_bytes(raw + json.dumps(
        {"t": "epilogue", "unix": 9.0, "reason": "deadline",
         "sealed_by": "supervisor"}).encode() + b"\n")
    _, info = stream_mod.recover(str(crashed))
    assert info["sealed"] is True and info["truncated"] is True
    assert info["sealed_by"] == "supervisor"
    assert "one flush interval" in info["loss_bound"]
    complete = _run_stream(tmp_path, name="done.jsonl", seal="disable")
    _, info = stream_mod.recover(complete)
    assert info["sealed_by"] == "telemetry"
    assert info["truncated"] is False


def test_recover_rejects_non_stream_files(tmp_path):
    not_stream = tmp_path / "x.json"
    not_stream.write_text('{"hello": 1}\n')
    with pytest.raises(ValueError, match="record|prologue"):
        stream_mod.recover(str(not_stream))
    assert sfprof_main(["recover", str(not_stream)]) == 2
    assert sfprof_main(["recover", str(tmp_path / "absent.jsonl")]) == 2


def test_recover_cli_roundtrips_into_health(tmp_path, capsys):
    stream = _run_stream(tmp_path)
    out = tmp_path / "recovered.json"
    assert sfprof_main(["recover", stream, "-o", str(out)]) == 0
    printed = capsys.readouterr().out
    assert "sealed: yes" in printed and "valid" in printed
    assert "np." not in printed
    assert sfprof_main(["health", str(out)]) == 0
    assert sfprof_main(["report", str(out)]) == 0


def test_recover_cli_reports_truncation_honestly(tmp_path, capsys):
    full = _run_stream(tmp_path, windows=3, seal=None)
    telemetry.maybe_flush_stream(force=True)
    raw = open(full, "rb").read()
    telemetry.disable()
    trunc = tmp_path / "cut.jsonl"
    trunc.write_bytes(raw[: len(raw) - 10])
    out = tmp_path / "rec.json"
    assert sfprof_main(["recover", str(trunc), "-o", str(out)]) == 0
    printed = capsys.readouterr().out
    assert "sealed: NO" in printed
    assert "truncated: yes" in printed
    assert "half-written tail" in printed
    assert sfprof_main(["health", str(out)]) == 0


# -- the sfprof tools on the port's artifacts ----------------------------------


def _knn_run(tmp_path, stream_path=None):
    """A port kNN ``run`` with telemetry on, a trace and a stream, a fault
    armed and fired, a link probe, e2e stamps and an ablation armed."""
    telemetry.enable(trace_path=str(tmp_path / "t.jsonl"),
                     stream_path=stream_path, stream_flush_interval_s=0.0)
    conf = QueryConfiguration(QueryType.WindowBased, window_size=10,
                              slide_step=5)
    op = PointPointKNNQuery(conf, GRID, device="cpu")
    out = list(op.run(iter(_points(Point, late_every=40)),
                      Point(x=5.0, y=5.0), 2.0, 3))
    faults.arm([{"point": "device.fetch", "at": 1}])
    with pytest.raises(Exception):
        telemetry.fetch(torch.zeros(2))
    faults.disarm()
    LinkProbe(device="cpu", payload_bytes=4096).sample()
    telemetry.record_e2e(10_000, "assemble")
    telemetry.record_e2e(10_000, "commit")
    ablation.arm(["nothing_here"])
    telemetry.emit_instant("blackbox_dumped", reason="test", path="x")
    return out


def test_port_ledger_validates_and_recovers(tmp_path):
    stream = str(tmp_path / "s.jsonl")
    _knn_run(tmp_path, stream)
    path = telemetry.write_ledger(str(tmp_path / "ledger.json"),
                                  bench={"value": 1.0})
    doc = ledger_mod.load(path)
    assert ledger_mod.validate(doc) == []
    assert doc["ledger_version"] == 3
    assert doc["env"]["backend"] in ("cpu", "cuda")
    rows = doc["kernels"]
    assert {r["kernel"] for r in rows} == {"knn_points_fused"}
    for r in rows:
        assert r["cost"] == {
            "error": "cost analysis unavailable on this backend"}
    assert doc["snapshot"]["link_probe"]["samples"] == 1
    assert doc["snapshot"]["e2e"]["stages"]["commit"]["count"] == 1
    rec, info = stream_mod.recover(stream)
    assert ledger_mod.validate(rec) == []
    assert info["sealed"] is True and info["reason"] == "complete"


def test_every_instant_the_port_emits_is_classified(tmp_path):
    """Every ``emit_instant`` name is in the sfprof consumer registry
    (``compile:<kernel>`` and ``compaction:<engine>`` are instrumentation
    instants outside it, in both packages)."""
    _knn_run(tmp_path, str(tmp_path / "s.jsonl"))
    instants = {e["name"] for e in telemetry.events if e["ph"] == "i"}
    assert {"fault_armed", "fault_fired:device.fetch", "link_probe",
            "ablation_armed", "blackbox_dumped"} <= instants
    assert any(n.startswith("compile:") for n in instants)
    def known(name):
        return name in events_mod.INSTANT_EVENTS or name.startswith(
            events_mod.INSTANT_EVENT_PREFIXES)

    for name in instants:
        if name.startswith(("compile:", "compaction:")):
            continue
        assert known(name), name
    # The emit sites in the port's sources name no other instant.
    import pathlib
    import re

    root = pathlib.Path(__file__).resolve().parents[1] / \
        "spatialflink_tpu_torch"
    heads = set()
    for src in root.rglob("*.py"):
        heads |= set(re.findall(r'emit_instant\(\s*f?"([a-z_]+:?)',
                                src.read_text()))
    assert {"fault_armed", "fault_fired:", "ablation_armed",
            "link_probe", "blackbox_dumped", "driver_retry",
            "failover", "circuit_open", "circuit_half_open",
            "circuit_closed", "pipeline_collapsed", "pipeline_resumed",
            "slo_violation:", "slo_recovered:", "qserve_registered",
            "qserve_unregistered", "qserve_evicted", "qserve_rung:",
            "dag_node_failover:"} == heads
    for head in heads:
        assert known(head + ("x" if head.endswith(":") else "")), head


# -- parity with the JAX package's telemetry ------------------------------------


def _window_children(events):
    """Per ``window.*`` span, in order: its (name, args) and the names of
    the spans that closed inside it (exit order), the byte-carrying fetch
    events marked. Both strict drivers scope their windows by operator,
    so the ``node`` argument is compared too."""
    out, pending = [], []
    for e in events:
        if e.get("ph") != "X":
            continue
        name = e["name"]
        if name.startswith("window."):
            out.append((name, dict(e.get("args") or {}), pending))
            pending = []
        else:
            pending.append(name + ("+bytes" if "bytes" in e.get("args", {})
                                   else ""))
    return out


def _both(run_port, run_jax):
    """Each package's run with its own telemetry on; returns the two
    telemetry singletons' captures (events, snapshot) and the results."""
    telemetry.enable()
    got = run_port()
    port = (list(telemetry.events), telemetry.snapshot(), telemetry)
    j_tel = j_tel_mod.telemetry
    j_tel.enable()
    want = run_jax()
    jax_ = (list(j_tel.events), j_tel.snapshot(), j_tel)
    return got, want, port, jax_


def test_parity_range_run_spans_gauges_and_fetches(tmp_path):
    conf = QueryConfiguration(QueryType.WindowBased, window_size=10,
                              slide_step=5)
    jconf = JConf(JQT.WindowBased, window_size=10, slide_step=5)
    port_sink = MetricsSink("p", include_telemetry=True)
    jax_sink = JMetricsSink("j", include_telemetry=True)

    got, want, (pev, psnap, ptel), (jev, jsnap, jtel) = _both(
        lambda: list(PointPointRangeQuery(conf, GRID, device="cpu").run(
            iter(_points(Point, late_every=25)), [Point(x=5.0, y=5.0)],
            2.0)),
        lambda: list(JRangeQ(jconf, JGRID).run(
            iter(_points(JPoint, late_every=25)), [JPoint(x=5.0, y=5.0)],
            2.0, dtype=np.float32)))
    assert [(r.start, r.end, len(r.objects)) for r in got] == \
        [(r.start, r.end, len(r.objects)) for r in want]
    assert _window_children(pev) == _window_children(jev)
    assert _window_children(pev)[0][2] == [
        "assemble", "ship", "compute", "fetch+bytes", "fetch"]
    assert ptel.late_drops == jtel.late_drops > 0
    assert ptel.max_watermark_lag_ms == jtel.max_watermark_lag_ms
    assert ptel.watermark_lag.buckets == jtel.watermark_lag.buckets
    assert ptel.watermark_lag.count == jtel.watermark_lag.count > 0
    assert ptel.window_latency.count == jtel.window_latency.count == len(got)
    assert psnap["d2h_transfers"] == jsnap["d2h_transfers"] == len(got)
    assert psnap["bytes_d2h"] == jsnap["bytes_d2h"]
    flags_bytes = base_mod.flags_for_queries(
        GRID, 2.0, [Point(x=5.0, y=5.0)]).nbytes
    assert psnap["bytes_h2d"] == jsnap["bytes_h2d"] + flags_bytes
    # Both strict drivers stamp the e2e stages, once a window a stage.
    stages = ("assemble", "compute")
    assert {s: psnap["e2e"]["stages"][s]["count"] for s in stages} == \
        {s: jsnap["e2e"]["stages"][s]["count"] for s in stages} == \
        {s: len(got) for s in stages}

    # The NES reporter's and the SNCB sink's telemetry columns.
    cols = ("watermark_lag_ms_max", "late_dropped_total")
    pline = NESFileReporter(MetricRegistry(), "p",
                            out_dir=str(tmp_path)).report(now=1.0)
    jline = JReporter(JRegistry(), "j", out_dir=str(tmp_path)).report(now=1.0)
    for c in cols:
        pv = [w for w in pline.split() if w.startswith(c + "=")]
        jv = [w for w in jline.split() if w.startswith(c + "=")]
        assert pv == jv and pv
    port_sink.record(n=3)
    jax_sink.record(n=3)
    port_sink._flush_interval(port_sink._interval_start + 1.0)
    jax_sink._flush_interval(jax_sink._interval_start + 1.0)
    assert port_sink.rows[-1].split(",")[-2:] == \
        jax_sink.rows[-1].split(",")[-2:]
    assert int(port_sink.rows[-1].split(",")[-1]) == ptel.late_drops


def test_parity_knn_query_panes_spans_and_compaction():
    conf = QueryConfiguration(QueryType.WindowBased, window_size=10,
                              slide_step=5)
    jconf = JConf(JQT.WindowBased, window_size=10, slide_step=5)
    got, want, (pev, psnap, ptel), (jev, jsnap, jtel) = _both(
        lambda: list(PointPointKNNQuery(conf, GRID, device="cpu")
                     .query_panes(iter(_points(Point)), Point(x=5.0, y=5.0),
                                  2.0, 3)),
        lambda: list(JKnn(jconf, JGRID).query_panes(
            iter(_points(JPoint)), JPoint(x=5.0, y=5.0), 2.0, 3,
            dtype=np.float32)))
    assert [(r.start, r.end, [n[0] for n in r.neighbors]) for r in got] == \
        [(r.start, r.end, [n[0] for n in r.neighbors]) for r in want]
    assert _window_children(pev) == _window_children(jev)
    assert [e["args"] for e in pev if e["name"] == "pane.digest"] == \
        [e["args"] for e in jev if e["name"] == "pane.digest"]
    assert ptel.compaction_buckets("knn_pane_digest") == \
        jtel.compaction_buckets("knn_pane_digest") != {}
    assert psnap["d2h_transfers"] == jsnap["d2h_transfers"] == 2 * len(got)


BEIJING = dict(num_partitions=100, min_x=115.5, max_x=117.6, min_y=39.6,
               max_y=41.1)
NSEG, K, RADIUS = 256, 5, 0.5
Q = (116.4, 40.19)


def _stream_panes(seed=42, n=9000):
    """Variable-size panes with an event-time gap (as the wire kNN
    tests make them)."""
    rng = np.random.default_rng(seed)
    ts = np.sort(rng.integers(0, 6_000, n)).astype(np.int64)
    ts[ts > 3_500] += 3_000
    ts = np.sort(ts)
    ch = {"ts": ts, "x": rng.uniform(115.5, 117.6, n),
          "y": rng.uniform(39.6, 41.1, n), "oid": rng.integers(0, NSEG, n)}
    return list(wire_panes([ch], WireFormat.for_grid(UniformGrid(**BEIJING)),
                           1000, 0))


@pytest.mark.parametrize("policy", [
    None, {"depth": 2, "fetch_lag": 1}, {"depth": 2, "fetch_lag": 1,
                                         "codec": "delta"}])
def test_parity_wire_panes_compaction_wire_bytes_and_fetches(policy):
    panes = _stream_panes()
    conf = dict(window_size=2.0, slide_step=1.0)

    def port():
        tpipeline.uninstall()
        if policy is not None:
            tpipeline.install(tpipeline.PipelinePolicy(**policy))
        try:
            return list(PointPointKNNQuery(
                QueryConfiguration(**conf), UniformGrid(**BEIJING),
                device="cpu").run_wire_panes(
                    panes, Point(x=Q[0], y=Q[1]), RADIUS, K, NSEG,
                    WireFormat.for_grid(UniformGrid(**BEIJING))))
        finally:
            tpipeline.uninstall()

    def jax_():
        jpipeline.uninstall()
        if policy is not None:
            jpipeline.install(jpipeline.PipelinePolicy(**policy))
        # x64 off, as on the accelerator: num_valid is int32 on both
        # sides (the test session turns x64 on).
        try:
            with jax.enable_x64(False):
                return [(s, e, np.asarray(o), np.asarray(d), nv)
                        for s, e, o, d, nv in JKnn(
                            JConf(**conf), JGrid(**BEIJING)).run_wire_panes(
                            panes, JPoint(x=Q[0], y=Q[1]), RADIUS, K, NSEG,
                            JWireFormat.for_grid(JGrid(**BEIJING)))]
        finally:
            jpipeline.uninstall()

    got, want, (pev, psnap, ptel), (jev, jsnap, jtel) = _both(port, jax_)
    assert [(w[0], w[1], w[4]) for w in got] == \
        [(w[0], w[1], w[4]) for w in want]
    for engine in ("wire_pane_digest", "wire_codec_words"):
        assert ptel.compaction_buckets(engine) == \
            jtel.compaction_buckets(engine)
    assert psnap.get("wire_codec") == jsnap.get("wire_codec")
    if policy and policy.get("codec"):
        assert psnap["wire_codec"]["panes"] > 0
    assert psnap["d2h_transfers"] == jsnap["d2h_transfers"]
    assert psnap["bytes_d2h"] == jsnap["bytes_d2h"]
    assert psnap.get("pipeline") == jsnap.get("pipeline")
    # No window spans on this path in either package (JAX label
    # "wire_panes", spans off).
    assert _window_children(pev) == _window_children(jev) == []
