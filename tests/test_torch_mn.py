"""Parity of the port's MobilityNebula instrumentation layer
(``spatialflink_tpu_torch.mn``) with the JAX package's.

One case for each case of ``tests/test_mn.py``: the same inputs go
through the JAX function and its port (``device="cpu"`` where the zone
test runs), and the outputs must be equal, in order. Wall-clock values
are held to their format, not their value: ingest stamps, latencies and
their histogram, and the NES reporter's rates and timestamps (the
instrumented queries' result files, counters and the reporter's counter
fields are equal). Both packages' sinks also register the runtime
telemetry gauges (their parity is in ``tests/test_torch_telemetry.py``).
"""

import json
import math
import re
import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest

from spatialflink_tpu import mn as jmn
from spatialflink_tpu.mn import metrics as jmetrics
from spatialflink_tpu.mn import queries as jqueries
from spatialflink_tpu.ops import counters as jcounters

from spatialflink_tpu_torch import mn as tmn
from spatialflink_tpu_torch.mn import metrics as tmetrics
from spatialflink_tpu_torch.mn import queries as tqueries
from spatialflink_tpu_torch.ops import counters as tcounters

JAX = SimpleNamespace(mn=jmn, metrics=jmetrics, q=jqueries, oc=jcounters,
                      dev={})
PORT = SimpleNamespace(mn=tmn, metrics=tmetrics, q=tqueries, oc=tcounters,
                       dev={"device": "cpu"})
# Registry keys the sinks add from the telemetry layer.
TELEMETRY_GAUGES = {"watermark_lag_ms_max", "late_dropped_total",
                    "telemetry_compiles_total", "h2d_bytes_total",
                    "d2h_bytes_total", "compaction_buckets_total"}
STATS_LINE = re.compile(
    r"METRICS ts=\S+ eps_in_avg=\d+\.\d\d eps_out_avg=\d+\.\d\d "
    r"selectivity_e2e=(nan|\d+\.\d{4}) throughput_mb_s=\d+\.\d{4}$")


def _csv_lines(n=3000, near_every=3):
    lines = []
    for i in range(n):
        if i % near_every == 0:
            lon, lat = 4.3658, 50.6456
        elif i % near_every == 1:
            lon, lat = 4.35 + (i % 7) * 0.01, 50.85 + (i % 5) * 0.01
        else:
            lon, lat = 5.9, 51.9
        lines.append(
            f"{i*10},dev{i%5},z,4.{i%10},5.{i%3},a,b,c,d,e,f,{30+(i%20)},"
            f"{lat},{lon}")
    return lines


def _counter_metrics(metrics):
    """The registry snapshot without wall-clock values: latency sums,
    buckets and percentiles, and the telemetry gauges."""
    return {k: v for k, v in metrics.items()
            if k not in TELEMETRY_GAUGES and not (
                k.startswith("latency_") and k != "latency_count")}


def _instrumented(p, tmp_path, query, lines):
    props = {"output.file": str(tmp_path / f"{query}.txt"),
             "stats.dir": str(tmp_path)}
    if query == "q1":
        props["tolerance.meters"] = "2000.0"
    kw = p.dev if query == "q5" else {}
    rep = p.q.INSTRUMENTED[query](iter(lines), props, **kw)
    assert STATS_LINE.match(rep.stats_lines[0]), rep.stats_lines[0]
    for pct in (rep.p50_ms, rep.p95_ms, rep.p99_ms):
        assert pct in [float(b) for b in p.metrics.BUCKETS_MS]
    stats = (tmp_path / f"EngineStats_mn_{query}_proc.stats").read_text()
    assert stats.count("\n") == 1
    return (rep.query_id, rep.results, _counter_metrics(rep.metrics),
            (tmp_path / f"{query}.txt").read_text())


# -- one case for each case of tests/test_mn.py -------------------------------


def _buckets(p, tmp_path):
    return p.mn.BUCKETS_MS


def _histogram(p, tmp_path):
    h = p.mn.FixedBucketLatency()
    for v in [0, 1, 3, 100, 70_000, 2.5, 512, 513]:
        h.observe(v)
    reg = p.mn.MetricRegistry()
    h2 = p.mn.FixedBucketLatency(reg, prefix="x_")
    for v in range(0, 3000, 37):
        h2.observe(v)
    return (h.buckets, h.count, h.sum_ms,
            [h.percentile(q) for q in (0.5, 0.95, 0.99, 1.0)],
            math.isnan(p.mn.FixedBucketLatency().percentile(0.5)),
            reg.snapshot())


def _counting_stage(p, tmp_path):
    reg = p.mn.MetricRegistry()
    stage = p.mn.CountingStage("6_range", reg)
    out = list(stage.around(range(10), lambda it: (x for x in it
                                                   if x % 2 == 0)))
    return out, reg.snapshot_counters()


def _parse_and_stamp(p, tmp_path):
    reg = p.mn.MetricRegistry()
    parse = p.mn.CsvParseAndStamp(lambda ln: int(ln), reg, 1000, 64)
    out = list(parse(["1", "x", "2", "", "7"]))
    stamps = [s.ingest_ns for s in out]
    assert stamps == sorted(stamps)
    return [s.value for s in out], reg.snapshot()


def _reporter_format(p, tmp_path):
    reg = p.mn.MetricRegistry()
    rep = p.mn.NESFileReporter(reg, "qx", out_dir=str(tmp_path),
                               interval_s=5)
    rep._last_time = 1_699_999_995.0  # a fixed first interval of 5 s
    reg.inc(p.metrics.MetricNames.SOURCE_IN, 100)
    reg.inc(p.metrics.MetricNames.SINK_OUT, 25)
    reg.inc(p.metrics.MetricNames.OUT_BYTES, 12_500)
    lines = [rep.report(now=1_700_000_000.0),
             rep.report(now=1_700_000_005.0)]
    return lines, (tmp_path / "EngineStats_qx_proc.stats").read_text()


def _instrumented_q1(p, tmp_path):
    return _instrumented(p, tmp_path, "q1", _csv_lines())


def _instrumented_q2(p, tmp_path):
    return _instrumented(p, tmp_path, "q2", _csv_lines(2000))


def _all_instrumented(p, tmp_path):
    return [_instrumented(p, tmp_path, q, _csv_lines(1500))
            for q in ("q1", "q2", "q3", "q4", "q5")]


def _registry_concurrency(p, tmp_path):
    reg = p.mn.MetricRegistry()
    reg.gauge("g", lambda: 1.0)
    errors, stop = [], threading.Event()

    def snapshotter():
        while not stop.is_set():
            try:
                reg.snapshot_counters()
                reg.snapshot()
            except Exception as e:  # pragma: no cover - the failure mode
                errors.append(e)
                return

    def incrementer():
        for i in range(4_000):
            reg.inc(f"c{i % 8}")

    snap = threading.Thread(target=snapshotter)
    snap.start()
    threads = [threading.Thread(target=incrementer) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    stop.set()
    snap.join(timeout=60)
    assert not errors and not snap.is_alive()
    return reg.snapshot()


def _json_safe(p, tmp_path):
    safe = p.metrics.json_safe({
        "f32": np.float32(1.5), "i64": np.int64(7), "b": np.bool_(True),
        "arr": np.arange(3, dtype=np.float32), "u8": np.uint8(3),
        "nested": {"t": (np.float64(2.5), "s", None)},
        "c": np.complex64(1 + 2j)})
    json.dumps({k: v for k, v in safe.items() if k != "c"})
    return {k: (type(v).__name__, v) for k, v in safe.items()}


def _registry_json_safe(p, tmp_path):
    reg = p.mn.MetricRegistry()
    reg.inc("n", 3)
    reg.gauge("npval", lambda: np.float32(0.25))
    snap = reg.snapshot()
    json.dumps(snap)
    return {k: (type(v).__name__, v) for k, v in snap.items()}


def _kernel_counters_json_safe(p, tmp_path):
    kc = p.oc.KernelCounters(enabled=True)
    kc.record_window(np.int64(100), np.int32(40), np.int64(40))
    kc.record_candidates(np.int64(5), np.int64(9))
    snap = kc.snapshot()
    json.dumps(snap)
    snap.pop("throughput_eps")
    return {k: (type(v).__name__, v) for k, v in snap.items()}


def _reporter_thread(p, tmp_path):
    reg = p.mn.MetricRegistry()
    rep = p.mn.NESFileReporter(reg, "qthr", out_dir=str(tmp_path),
                               interval_s=0.05)
    path = tmp_path / "EngineStats_qthr_proc.stats"
    rep.start()
    first = rep._thread
    rep.start()
    assert rep._thread is first and first.is_alive()
    reg.inc(p.metrics.MetricNames.SOURCE_IN, 10)
    deadline = time.time() + 10
    while time.time() < deadline:
        if path.exists() and path.read_text().count("\n") >= 2:
            break
        time.sleep(0.02)
    rep.stop()
    rep.stop()
    assert rep._thread is None and not first.is_alive()
    lines = path.read_text().splitlines()
    n = len(lines)
    time.sleep(0.15)
    assert path.read_text().count("\n") == n
    return n >= 2, all(STATS_LINE.match(ln) for ln in lines)


MN_CASES = {
    "bucket_boundaries_are_nes": _buckets,
    "histogram_bucketing_and_percentiles": _histogram,
    "counting_stage_selectivity": _counting_stage,
    "parse_and_stamp_counts_and_skips": _parse_and_stamp,
    "reporter_line_format": _reporter_format,
    "instrumented_q1_end_to_end": _instrumented_q1,
    "instrumented_q2_variance": _instrumented_q2,
    "all_instrumented_queries_run": _all_instrumented,
    "registry_concurrent_inc_and_snapshot": _registry_concurrency,
    "json_safe_converts_numpy_at_the_boundary": _json_safe,
    "registry_snapshot_is_json_safe": _registry_json_safe,
    "kernel_counters_snapshot_is_json_safe": _kernel_counters_json_safe,
    "reporter_timer_thread_lifecycle": _reporter_thread,
}


@pytest.mark.parametrize("case", list(MN_CASES))
def test_mn_case_equals_jax(case, tmp_path):
    for side in ("port", "jax"):
        (tmp_path / side).mkdir()
    got = MN_CASES[case](PORT, tmp_path / "port")
    want = MN_CASES[case](JAX, tmp_path / "jax")
    assert got == want
    assert got


def test_instrumented_results_are_not_vacuous(tmp_path):
    out = _all_instrumented(PORT, tmp_path)
    for query_id, results, metrics, text in out:
        assert results > 0 and text.count("\n") == results, query_id
        assert metrics["source_in_total"] == 1500
        assert metrics["sink_out_total"] == results
        assert metrics["latency_count"] == results
    q5 = out[-1]
    assert q5[2]["pipe_4_fence_out_total"] < q5[2]["pipe_4_fence_in_total"]


def test_reporter_appends_the_port_counters(tmp_path):
    rep = tmn.NESFileReporter(tmn.MetricRegistry(), "qc",
                              out_dir=str(tmp_path))
    tcounters.enable()
    try:
        tcounters.counters.record_candidates(3, 11)
        line = rep.report()
    finally:
        tcounters.disable()
    assert line.endswith(" dist_comp_total=11 candidate_lanes_total=3")
    assert "dist_comp_total" not in rep.report()


def test_unported_telemetry_column_raises():
    """The telemetry columns, once unported (a raise), now exist: the
    header gains ``wmLagMs,lateDrops`` as the JAX sink's does (their
    values' parity is in ``tests/test_torch_telemetry.py``)."""
    from spatialflink_tpu.sncb.metrics import MetricsSink as JaxSink
    from spatialflink_tpu_torch.sncb.metrics import MetricsSink

    sink = MetricsSink("t", include_telemetry=True)
    assert sink.HEADER == JaxSink("t", include_telemetry=True).HEADER
    assert sink.HEADER.endswith(",wmLagMs,lateDrops")
