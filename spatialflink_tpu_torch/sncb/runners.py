"""SNCB test/benchmark runners (``GeoFlink/sncb/tests/``).

- ``local_test_runner``: handcrafted fixture events with per-query
  expectations (LocalTestRunner.java:21-115);
- ``benchmark_runner``: seeded synthetic GPS load at a target EPS with
  per-second metrics (BenchmarkRunner.java:22-105 + SyntheticGpsSource);
- ``mobility_query_runner``: CSV replay of the MN_Q1..Q5 suite with an
  execution-stats report (MobilityQueryRunner.java:33-150).
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Dict, Iterable, List, Optional

from spatialflink_tpu_torch.device import resolve_device
from spatialflink_tpu_torch.ops.counters import counters as opcounters
from spatialflink_tpu_torch.sncb import mobility
from spatialflink_tpu_torch.sncb.common import GpsEvent, PolygonLoader
from spatialflink_tpu_torch.sncb.metrics import MetricsSink
from spatialflink_tpu_torch.sncb.queries import (
    q1_high_risk,
    q2_brake_monitor,
    q3_trajectory,
    q5_traj_speed_fence,
)
from spatialflink_tpu_torch.streams.sources import SyntheticGpsSource

# Brussels-area bbox used by the synthetic benchmark source
# (BenchmarkRunner.java:35: lon 4.25..4.50, lat 50.75..50.95).
BRUSSELS_BBOX = (4.25, 4.50, 50.75, 50.95)


def sample_gps_events() -> List[GpsEvent]:
    """The reference's own golden fixture, verbatim data
    (LocalTestRunner.sampleData, LocalTestRunner.java:86-115), against the
    reference's own bundled zones (src/main/resources). The Java comments
    encode the expectations asserted in tests/test_sncb.py:

      A — inside the high-risk zone (Q1 hits);
      B — outside the maintenance area, varFA 0.7 > 0.6, varFF 0.2 ≤ 0.5
          (Q2 alert; A's FA/FF spreads qualify too);
      C/D — simple two-device trajectories (Q3/Q4);
      E — inside the Q5 fence, avg speed 51.7 > 50, min 40 > 20.

    t0 is fixed (the reference uses wall-clock currentTimeMillis).
    """
    t0 = 1_700_000_000_000
    return [
        GpsEvent("A", 4.352, 50.852, t0 + 1000, 10.0, 0.1, 0.1),
        GpsEvent("A", 4.355, 50.855, t0 + 2000, 11.0, 0.2, 0.2),
        GpsEvent("A", 4.358, 50.858, t0 + 3000, 12.0, 0.8, 0.4),
        GpsEvent("B", 4.370, 50.852, t0 + 1100, 8.0, 0.1, 0.5),
        GpsEvent("B", 4.372, 50.853, t0 + 2100, 8.5, 0.8, 0.4),
        GpsEvent("B", 4.374, 50.854, t0 + 3100, 9.0, 0.7, 0.3),
        GpsEvent("C", 4.40, 50.10, t0 + 1200, 15.0, None, None),
        GpsEvent("C", 4.41, 50.11, t0 + 2200, 15.5, None, None),
        GpsEvent("C", 4.42, 50.12, t0 + 3200, 16.0, None, None),
        GpsEvent("D", 4.31, 50.20, t0 + 1300, 17.0, None, None),
        GpsEvent("D", 4.33, 50.22, t0 + 2300, 18.0, None, None),
        GpsEvent("D", 4.35, 50.24, t0 + 3300, 19.0, None, None),
        GpsEvent("E", 4.405, 50.855, t0 + 1400, 60.0, None, None),
        GpsEvent("E", 4.406, 50.856, t0 + 2400, 55.0, None, None),
        GpsEvent("E", 4.407, 50.857, t0 + 3400, 40.0, None, None),
    ]


def local_test_runner(verbose: bool = False,
                      device="cuda") -> Dict[str, list]:
    """Run Q1/Q2/Q3/Q5 over the fixture; return per-query results. The
    zone tests of Q1, Q2 and Q5 run on ``device``."""
    risk = PolygonLoader.load_geojson_buffered("high_risk_zones.geojson", 20.0)
    maint = PolygonLoader.load_geojson_buffered("maintenance_areas.geojson", 0.0)
    fence = PolygonLoader.load_wkt_buffered("q5_fence.wkt", 20.0)

    out = {
        "q1": list(q1_high_risk(iter(sample_gps_events()), risk,
                                device=device)),
        "q2": list(
            q2_brake_monitor(iter(sample_gps_events()), maint, slide_ms=500,
                             device=device)
        ),
        "q3": list(q3_trajectory(iter(sample_gps_events()), slide_ms=1000)),
        "q5": list(q5_traj_speed_fence(iter(sample_gps_events()), fence,
                                       device=device)),
    }
    if verbose:
        for q, res in out.items():
            print(f"{q}: {len(res)} results")
            for r in res[:5]:
                print("  ", r)
    return out


@dataclass
class BenchmarkReport:
    query: str
    events: int
    duration_s: float
    eps: float
    results: int
    source_metrics: List[str]
    sink_metrics: List[str]


def benchmark_runner(
    query: str = "q1",
    target_eps: int = 20_000,
    duration_ms: int = 30_000,
    num_devices: int = 10,
    out_dir: Optional[str] = None,
    device="cuda",
) -> BenchmarkReport:
    """BenchmarkRunner.main analog: synthetic load through one query with
    1 s CSV metrics at source and sink (BenchmarkRunner.java:22-105). The
    zone tests of q1, q2 and q5 run on ``device``."""
    device = resolve_device(device)
    min_x, max_x, min_y, max_y = BRUSSELS_BBOX
    src = SyntheticGpsSource(
        min_x, max_x, min_y, max_y,
        target_eps=target_eps, duration_ms=duration_ms,
        num_devices=num_devices, seed=42,
        start_ts=1_700_000_000_000,
        make_event=lambda device_id, x, y, timestamp, speed: GpsEvent(
            device_id, x, y, timestamp, speed, 5.0, 5.0
        ),
    )
    source_sink = MetricsSink(
        "source", f"{out_dir}/source.csv" if out_dir else None
    )
    # The sink CSV gains a distComp column when the kernel counter registry
    # is on (ops/counters.enable()) — the distCompCounter analog.
    result_sink = MetricsSink(
        f"sink-{query}", f"{out_dir}/sink-{query}.csv" if out_dir else None,
        include_opcounters=opcounters.enabled,
    )

    def counted(it):
        for e in it:
            source_sink.record(e.ts)
            yield e

    risk = PolygonLoader.load_geojson_buffered("high_risk_zones.geojson", 20.0)
    maint = PolygonLoader.load_geojson_buffered("maintenance_areas.geojson", 0.0)
    fence = PolygonLoader.load_wkt_buffered("q5_fence.wkt", 20.0)

    t0 = time.time()
    n_results = 0
    if query == "q1":
        it = q1_high_risk(counted(src), risk, device=device)
    elif query == "q2":
        it = q2_brake_monitor(counted(src), maint, slide_ms=1000,
                              device=device)
    elif query == "q3":
        it = q3_trajectory(counted(src), slide_ms=1000)
    elif query == "q5":
        it = q5_traj_speed_fence(counted(src), fence, device=device)
    else:
        raise ValueError(query)
    for res in it:
        ts = getattr(res, "win_end", None)
        if ts is None and hasattr(res, "raw"):
            ts = res.raw.ts
        result_sink.record(ts)
        n_results += 1
    dt = time.time() - t0
    source_sink.close()
    result_sink.close()
    n_events = src.total_events
    return BenchmarkReport(
        query=query, events=n_events, duration_s=dt, eps=n_events / dt,
        results=n_results, source_metrics=source_sink.rows,
        sink_metrics=result_sink.rows,
    )


def mobility_query_runner(
    csv_path: str, queries: Iterable[str] = ("q1", "q2", "q3", "q4", "q5"),
    limit: Optional[int] = None,
    device="cuda",
) -> Dict[str, BenchmarkReport]:
    """CSV replay of MN_Q1..Q5 (MobilityQueryRunner.java:33-150):
    14-column schema, per-query timing + result counts; q5's fence test
    runs on ``device``."""
    reports = {}
    for q in queries:
        with open(csv_path) as f:
            lines = [ln for ln in f if ln.strip()]
        if limit:
            lines = lines[:limit]
        t0 = time.time()
        rows = mobility.mobility_runner(q, iter(lines), device=device)
        dt = time.time() - t0
        reports[q] = BenchmarkReport(
            query=q, events=len(lines), duration_s=dt,
            eps=len(lines) / dt if dt > 0 else 0.0,
            results=len(rows), source_metrics=[], sink_metrics=[],
        )
    return reports
