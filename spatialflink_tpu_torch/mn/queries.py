"""Fully-instrumented MN query pipelines (``com/mn/queries/
InstrumentedMN_Q1..Q5.java``).

Each pipeline is: source lines → parse+stamp (``source_in_total``) →
counted stages (stable ids ``pipe_0_source`` … ``pipe_99_sink``) → query
logic → counting latency file sink + NES stats reporter. Configuration via
a properties dict with the reference's ``-D`` system-property names and
defaults (rows.per.sec=20000, tcp.host/port, query.lon/lat, output.file —
InstrumentedMN_Q1.java:86-95).

Latency semantics: window results carry the MIN ingest stamp of their
contributing events (InstrumentedMN_Q1.java:205-216) — e2e latency is
measured from the oldest event in the window.

``instrumented_mn_q5``'s geofence test runs on ``device``
(``BufferedZone.contains_batch``), the card unless the caller asks for
the CPU; the other four queries are host-only.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, Iterable, Iterator, List, Optional, Tuple

import numpy as np

from spatialflink_tpu_torch.mn.metrics import FixedBucketLatency, MetricRegistry
from spatialflink_tpu_torch.mn.operators import CountingStage, CsvParseAndStamp, Stamped
from spatialflink_tpu_torch.mn.reporter import NESFileReporter
from spatialflink_tpu_torch.mn.sinks import CountingLatencyFileSink
from spatialflink_tpu_torch.device import resolve_device
from spatialflink_tpu_torch.sncb.common import (
    BufferedZone,
    GpsEvent,
    csv_to_gps_event,
)
from spatialflink_tpu_torch.sncb.ops import traj_speed, trajectory_wkt, variance
from spatialflink_tpu_torch.streams.windows import SlidingEventTimeWindows, WindowAssembler

# The reference's -D system-property names and defaults
# (InstrumentedMN_Q1.java:86-95, InstrumentedMN_Q5.java:79-83).
_DEFAULTS = {
    "rows.per.sec": "20000",
    "tcp.host": "localhost",
    "tcp.port": "32323",
    "query.lon": "4.3658",
    "query.lat": "50.6456",
    # tolerance.meters has per-query defaults: Q1 = 100.0 (true meters via
    # the x111320 conversion), Q5 = 0.001 (degree-space, the reference's
    # "degrees approximation" — InstrumentedMN_Q5.java:83).
    "output.file": "metrics/mn_instrumented_results.txt",
    "stats.dir": "metrics",
    "bytes.per.input": "128",
}


@dataclass
class InstrumentedReport:
    query_id: str
    results: int
    metrics: Dict[str, float]
    p50_ms: float
    p95_ms: float
    p99_ms: float
    stats_lines: List[str] = field(default_factory=list)


def _props(overrides: Optional[Dict[str, str]]) -> Dict[str, str]:
    p = dict(_DEFAULTS)
    if overrides:
        p.update(overrides)
    return p


def _stamped_windows(stamped: Iterable[Stamped[GpsEvent]], size_ms: int,
                     slide_ms: int, lateness_ms: int = 2000):
    asm = WindowAssembler(
        SlidingEventTimeWindows(size_ms, slide_ms),
        timestamp_fn=lambda s: s.value.ts,
        max_out_of_orderness_ms=lateness_ms,
    )
    yield from asm.stream(stamped)


def _run(
    query_id: str,
    lines: Iterable[str],
    props: Optional[Dict[str, str]],
    pipeline: Callable[[Iterator[Stamped[GpsEvent]], MetricRegistry, Dict[str, str]],
                       Iterator[Tuple[object, Optional[int]]]],
    formatter: Callable[[object], str] = str,
) -> InstrumentedReport:
    p = _props(props)
    registry = MetricRegistry()
    hist = FixedBucketLatency(registry)
    parse = CsvParseAndStamp(
        lambda ln: csv_to_gps_event(ln),
        registry,
        theoretical_rows_per_sec=int(p["rows.per.sec"]),
        bytes_per_record=int(p["bytes.per.input"]),
    )
    reporter = NESFileReporter(registry, query_id, out_dir=p["stats.dir"])
    src_count = CountingStage("0_source", registry)
    sink_count = CountingStage("99_sink", registry)

    n_results = 0
    with CountingLatencyFileSink(
        p["output.file"], registry, formatter=formatter, histogram=hist
    ) as sink:
        stamped = parse(src_count.count_out(lines))
        for result, ingest_ns in pipeline(stamped, registry, p):
            registry.inc(sink_count.in_name)
            sink(result, ingest_ns)
            registry.inc(sink_count.out_name)
            n_results += 1
    line = reporter.report()
    return InstrumentedReport(
        query_id=query_id,
        results=n_results,
        metrics=registry.snapshot(),
        p50_ms=hist.percentile(0.50),
        p95_ms=hist.percentile(0.95),
        p99_ms=hist.percentile(0.99),
        stats_lines=[line],
    )


# ---------------------------------------------------------------------------


def instrumented_mn_q1(lines: Iterable[str],
                       props: Optional[Dict[str, str]] = None) -> InstrumentedReport:
    """Q1: proximity count. The range stage applies the degree→meter
    (×111320) Euclidean check — the only meters-true threshold in the
    reference (InstrumentedMN_Q1.java:176-190)."""

    def pipeline(stamped, registry, p):
        lon, lat = float(p["query.lon"]), float(p["query.lat"])
        tol_m = float(p.get("tolerance.meters", "100.0"))
        rng_count = CountingStage("6_range", registry)
        win_count = CountingStage("8_window", registry)

        def in_range(items):
            for s in items:
                registry.inc("range_queries")
                d_m = np.hypot(s.value.lon - lon, s.value.lat - lat) * 111_320.0
                if d_m <= tol_m:
                    yield s

        for win in _stamped_windows(rng_count.around(stamped, in_range),
                                    5000, 5000):
            registry.inc(win_count.in_name, len(win.events))
            ingest = min((s.ingest_ns for s in win.events), default=None)
            registry.inc(win_count.out_name)
            yield (win.start, win.end, len(win.events)), ingest

    return _run("mn_q1", lines, props, pipeline,
                formatter=lambda r: f"{r[0]},{r[1]},{r[2]}")


def instrumented_mn_q2(lines: Iterable[str],
                       props: Optional[Dict[str, str]] = None) -> InstrumentedReport:
    """Q2: global FA/FF variance, 10s/200ms sliding, spatial exclusion box
    (InstrumentedMN_Q2.java:216-217)."""

    def pipeline(stamped, registry, p):
        excl = CountingStage("3_exclude", registry)

        def exclude_box(items):
            for s in items:
                e = s.value
                if not (4.0 <= e.lon <= 4.6 and 50.0 <= e.lat <= 50.8):
                    yield s

        for win in _stamped_windows(excl.around(stamped, exclude_box),
                                    10_000, 200):
            n, var_fa, var_ff = variance([s.value for s in win.events])
            ingest = min((s.ingest_ns for s in win.events), default=None)
            yield (win.start, win.end, var_fa, var_ff, n), ingest

    return _run("mn_q2", lines, props, pipeline,
                formatter=lambda r: ",".join(map(str, r)))


def instrumented_mn_q3(lines: Iterable[str],
                       props: Optional[Dict[str, str]] = None) -> InstrumentedReport:
    """Q3: global trajectory, 3s/1s sliding windows."""

    def pipeline(stamped, registry, p):
        for win in _stamped_windows(stamped, 3000, 1000):
            wkt = trajectory_wkt([s.value for s in win.events])
            ingest = min((s.ingest_ns for s in win.events), default=None)
            yield (win.start, win.end, "ALL", wkt), ingest

    return _run("mn_q3", lines, props, pipeline,
                formatter=lambda r: ",".join(map(str, r)))


def instrumented_mn_q4(lines: Iterable[str],
                       props: Optional[Dict[str, str]] = None) -> InstrumentedReport:
    """Q4: Brussels-bbox-restricted global trajectory, 3s/1s windows
    (InstrumentedMN_Q4.java:99-101, :152)."""

    def pipeline(stamped, registry, p):
        flt = CountingStage("2_filter", registry)

        def bbox_time(items):
            for s in items:
                e = s.value
                # Brussels bounds (InstrumentedMN_Q4.java:99-101).
                if 4.287 <= e.lon <= 4.419 and 50.773 <= e.lat <= 50.896:
                    yield s

        for win in _stamped_windows(flt.around(stamped, bbox_time), 3000, 1000):
            wkt = trajectory_wkt([s.value for s in win.events])
            ingest = min((s.ingest_ns for s in win.events), default=None)
            yield (win.start, win.end, "ALL", wkt), ingest

    return _run("mn_q4", lines, props, pipeline,
                formatter=lambda r: ",".join(map(str, r)))


def instrumented_mn_q5(lines: Iterable[str],
                       props: Optional[Dict[str, str]] = None,
                       device="cuda") -> InstrumentedReport:
    """Q5: buffered geofence + per-device 20s/2s traj+speed thresholds
    (InstrumentedMN_Q5.java:220-221); the fence test runs on ``device``."""
    device = resolve_device(device)

    def pipeline(stamped, registry, p):
        # Reference fence: {4.3,50.8} {4.4,50.8} {4.4,50.9} {4.3,50.9}
        # with configurable degree-space tolerance
        # (InstrumentedMN_Q5.java:83-87).
        fence_ring = [[4.3, 50.8], [4.4, 50.8], [4.4, 50.9], [4.3, 50.9],
                      [4.3, 50.8]]
        fence = BufferedZone(
            rings_metric=[np.asarray(fence_ring, float)],
            buffer_m=float(p.get("tolerance.meters", "0.001")),
        )
        fence_count = CountingStage("4_fence", registry)

        def in_fence(items):
            buf: List[Stamped[GpsEvent]] = []
            for s in items:
                buf.append(s)
                if len(buf) >= 4096:
                    keep = fence.contains_batch(
                        np.array([[b.value.lon, b.value.lat] for b in buf]),
                        device=device,
                    )
                    yield from (b for b, k in zip(buf, keep) if k)
                    buf = []
            if buf:
                keep = fence.contains_batch(
                    np.array([[b.value.lon, b.value.lat] for b in buf]),
                    device=device,
                )
                yield from (b for b, k in zip(buf, keep) if k)

        for win in _stamped_windows(fence_count.around(stamped, in_fence),
                                    20_000, 2000):
            by_dev: Dict[str, List[Stamped[GpsEvent]]] = {}
            for s in win.events:
                by_dev.setdefault(s.value.device_id, []).append(s)
            for dev in sorted(by_dev):
                evs = [s.value for s in by_dev[dev]]
                wkt, avg_speed, min_speed = traj_speed(evs)
                if avg_speed < 100.0 or (min_speed == min_speed and min_speed < 20.0):
                    ingest = min(s.ingest_ns for s in by_dev[dev])
                    yield (win.start, win.end, dev, avg_speed, min_speed, wkt), ingest

    return _run("mn_q5", lines, props, pipeline,
                formatter=lambda r: ",".join(map(str, r)))


INSTRUMENTED = {
    "q1": instrumented_mn_q1,
    "q2": instrumented_mn_q2,
    "q3": instrumented_mn_q3,
    "q4": instrumented_mn_q4,
    "q5": instrumented_mn_q5,
}
