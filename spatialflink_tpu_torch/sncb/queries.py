"""SNCB domain queries Q1–Q5 (``GeoFlink/sncb/queries/``).

Each ``build(events, ...)`` consumes an iterable of GpsEvents and yields
result records, mirroring the reference's ``Q*.build(env, events, …)``
DataStream pipelines. All use event-time windows with 5 s
bounded-out-of-orderness (each reference query assigns
``BoundedOutOfOrdernessTimestampExtractor(Time.seconds(5))``).

CRS note: the reference mixes metric (EPSG:25831-buffered) polygons with
raw lon/lat points inside a single degree-based grid (Q1_HighRisk.java:52-78
feeds metric PreparedGeometry rings into a WGS84 UniformGrid) — geometrically
inconsistent. This build does what the query *means*: points are enriched
to metric coordinates (vectorized UTM on device) and all zone containment /
proximity tests run in meters.

Device: every query that tests zones (Q1, Q2, Q5, the Q2 batch replay and
the window cores ``q1_window``, ``q2_window``, ``q5_window``) takes
``device``, a keyword after the JAX parameters: the zone test runs there
(``common.contains_any_zone``), the card unless the caller asks for the
CPU; a missing card raises. Q3 and Q4 are host-only.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterable, Iterator, List, Sequence

import numpy as np

from spatialflink_tpu_torch.device import resolve_device
from spatialflink_tpu_torch.ops.counters import counters
from spatialflink_tpu_torch.sncb.common import (
    BufferedZone,
    CRSUtils,
    EnrichedEvent,
    GpsEvent,
    contains_any_zone,
    contains_any_zone_np,
)
from spatialflink_tpu_torch.sncb.ops import (
    TrajOut,
    TrajSpeedOut,
    VarOut,
    traj_speed,
    trajectory_wkt,
    variation,
)
from spatialflink_tpu_torch.streams.panes import sliding_aggregate
from spatialflink_tpu_torch.streams.windows import (
    SlidingEventTimeWindows,
    WindowAssembler,
)
from spatialflink_tpu_torch.utils.interning import Interner

_LATENESS_MS = 5_000  # Time.seconds(5) in every Q*.build


def _windows(events, size_ms, slide_ms, lateness_ms=_LATENESS_MS):
    asm = WindowAssembler(
        SlidingEventTimeWindows(size_ms, slide_ms),
        timestamp_fn=lambda e: e.timestamp,
        max_out_of_orderness_ms=lateness_ms,
    )
    yield from asm.stream(events)


def keyed_windows(events, size_ms, slide_ms, key_fn, lateness_ms=_LATENESS_MS):
    """keyBy(key).window(...) analog: per fired window, per key present."""
    for win in _windows(events, size_ms, slide_ms, lateness_ms):
        groups: Dict[str, List] = {}
        for e in win.events:
            groups.setdefault(key_fn(e), []).append(e)
        for key in sorted(groups):
            yield key, win.start, win.end, groups[key]


def _zone_filter(events: Sequence[GpsEvent], zones, keep_inside: bool,
                 backend: str = "device", device="cuda") -> List[GpsEvent]:
    """Batched zone containment filter over metric coordinates, on
    ``device``. ``backend="numpy"`` routes the host twin
    (contains_any_zone_np) when the caller asks for it; nothing falls
    back to it."""
    if backend != "numpy":
        device = resolve_device(device)
    if not events:
        return []
    if counters.enabled:
        # Each event is distance/containment-tested against every zone —
        # the distCompCounter analog for the SNCB zone kernels.
        counters.record_candidates(len(events), len(events) * len(zones))
    xy = CRSUtils.enrich_batch(events)
    if backend == "numpy":
        inside = contains_any_zone_np(zones, xy)
    else:
        inside = contains_any_zone(zones, xy, device=device)
    keep = inside if keep_inside else ~inside
    return [e for e, k in zip(events, keep) if k]


def q1_high_risk(
    events: Iterable[GpsEvent],
    high_risk_zones: Sequence[BufferedZone],
    radius_m: float = 20.0,
    window_s: int = 10,
    device="cuda",
) -> Iterator[EnrichedEvent]:
    """Q1: events near buffered high-risk polygons, re-emitted per 10 s
    tumbling window (Q1_HighRisk.java:30-105; the range query at :73-78).

    ``radius_m`` is the proximity radius in meters (the reference's
    0.001-degree radius against metric polygons is the CRS inconsistency
    described in the module docstring; 0.001° ≈ tens of meters at Brussels
    latitudes, hence the 20 m default).
    """
    device = resolve_device(device)
    zones = buffer_q1_zones(high_risk_zones, radius_m)
    for win in _windows(events, window_s * 1000, window_s * 1000):
        yield from q1_window(win.events, zones, device=device)


def q2_brake_monitor(
    events: Iterable[GpsEvent],
    maintenance_zones: Sequence[BufferedZone],
    window_s: float = 10.0,
    slide_ms: int = 10,
    var_fa_min: float = 0.6,
    var_ff_max: float = 0.5,
    device="cuda",
) -> Iterator[VarOut]:
    """Q2: exclude maintenance areas → per-device 10s/10ms sliding windows →
    brake-pressure variation filter varFA > 0.6 ∧ varFF ≤ 0.5
    (Q2_BrakeMonitor.java:25-103).

    Parity note: the reference's Point→EnrichedEvent remap drops the FA/FF
    fields before VariationAgg reads them (Q2_BrakeMonitor.java maps a fresh
    GpsEvent carrying only id/ts/lon/lat), so upstream every window computes
    variation of nothing. This build keeps the fields — the behavior the
    query obviously intends.
    """
    filtered = _batchwise_zone_exclude(events, maintenance_zones,
                                       device=resolve_device(device))
    for dev, start, end, evs in keyed_windows(
        filtered, int(window_s * 1000), slide_ms, key_fn=lambda e: e.device_id
    ):
        var_fa, var_ff = variation(evs)
        if var_fa > var_fa_min and var_ff <= var_ff_max:
            yield VarOut(dev, var_fa, var_ff, start, end, len(evs))


def _batchwise_zone_exclude(events, zones, chunk=8192, device="cuda"):
    """Stream-preserving batched exclude filter (PolygonExcludeFn analog)."""
    buf: List[GpsEvent] = []
    for e in events:
        buf.append(e)
        if len(buf) >= chunk:
            yield from _zone_filter(buf, zones, keep_inside=False,
                                    device=device)
            buf = []
    if buf:
        yield from _zone_filter(buf, zones, keep_inside=False, device=device)


def _batchwise_zone_include(events, zones, chunk=8192, device="cuda"):
    buf: List[GpsEvent] = []
    for e in events:
        buf.append(e)
        if len(buf) >= chunk:
            yield from _zone_filter(buf, zones, keep_inside=True,
                                    device=device)
            buf = []
    if buf:
        yield from _zone_filter(buf, zones, keep_inside=True, device=device)


def q3_trajectory(
    events: Iterable[GpsEvent], window_s: float = 10.0, slide_ms: int = 10
) -> Iterator[TrajOut]:
    """Q3: per-device sliding-window trajectory WKT
    (Q3_Trajectory.java:17-58)."""
    for dev, start, end, evs in keyed_windows(
        events, int(window_s * 1000), slide_ms, key_fn=lambda e: e.device_id
    ):
        yield TrajOut(dev, trajectory_wkt(evs), start, end)


def q4_trajectory_restricted(
    events: Iterable[GpsEvent],
    min_lon: float, max_lon: float, min_lat: float, max_lat: float,
    t_min: int, t_max: int,
    window_s: float = 10.0, slide_ms: int = 10,
) -> Iterator[TrajOut]:
    """Q4: Q3 with bbox/time-range predicate pushdown
    (Q4_TrajectoryRestricted.java:18-70)."""
    filtered = (
        e for e in events
        if min_lon <= e.lon <= max_lon and min_lat <= e.lat <= max_lat
        and t_min <= e.ts <= t_max
    )
    yield from q3_trajectory(filtered, window_s, slide_ms)


def q5_traj_speed_fence(
    events: Iterable[GpsEvent],
    fence_zones: Sequence[BufferedZone],
    avg_threshold: float = 50.0,
    min_threshold: float = 20.0,
    window_s: float = 45.0,
    slide_s: float = 5.0,
    device="cuda",
) -> Iterator[TrajSpeedOut]:
    """Q5: geofence include → per-device 45s/5s windows → trajectory + speed
    stats, threshold filter avg > a ∨ min > m (Q5_TrajAndSpeedFence.java:25-104)."""
    fenced = _batchwise_zone_include(events, fence_zones,
                                     device=resolve_device(device))
    for dev, start, end, evs in keyed_windows(
        fenced, int(window_s * 1000), int(slide_s * 1000),
        key_fn=lambda e: e.device_id,
    ):
        wkt, avg_speed, min_speed = traj_speed(evs)
        if avg_speed > avg_threshold or (
            min_speed == min_speed and min_speed > min_threshold
        ):
            yield TrajSpeedOut(dev, wkt, avg_speed, min_speed, start, end)


def q2_brake_monitor_batch(
    events: Sequence[GpsEvent],
    maintenance_zones: Sequence[BufferedZone],
    window_s: float = 10.0,
    slide_ms: int = 10,
    var_fa_min: float = 0.6,
    var_ff_max: float = 0.5,
    device="cuda",
) -> List[VarOut]:
    """Vectorized replay of Q2 over a bounded stream: identical outputs to
    ``q2_brake_monitor`` but computed via pane decomposition
    (streams/panes.py) — O(events) instead of O(events × overlap). This is
    what makes the reference's 10s/10ms window config (1000× overlap)
    tractable at benchmark rates. The zone test runs on ``device``; the
    pane aggregates are host numpy.
    """
    events = list(events)
    filtered = _zone_filter(events, maintenance_zones, keep_inside=False,
                            device=device)
    if not filtered:
        return []
    interner = Interner()
    key = interner.intern_many(e.device_id for e in filtered)
    ts = np.array([e.ts for e in filtered], np.int64)
    fa = np.array([e.fa if e.fa is not None else np.nan for e in filtered])
    ff = np.array([e.ff if e.ff is not None else np.nan for e in filtered])
    # None fields are skipped by the reference accumulator: use ±inf-neutral
    # values (NaN-safe min/max via masking).
    fa_min_in = np.where(np.isnan(fa), np.inf, fa)
    fa_max_in = np.where(np.isnan(fa), -np.inf, fa)
    ff_min_in = np.where(np.isnan(ff), np.inf, ff)
    ff_max_in = np.where(np.isnan(ff), -np.inf, ff)

    win = sliding_aggregate(
        ts, key, interner.num_segments,
        int(window_s * 1000), slide_ms,
        min_fields={"fa_min": fa_min_in, "ff_min": ff_min_in},
        max_fields={"fa_max": fa_max_in, "ff_max": ff_max_in},
    )
    var_fa = win.maxs["fa_max"] - win.mins["fa_min"]
    var_ff = win.maxs["ff_max"] - win.mins["ff_min"]
    hit = (win.count > 0) & (var_fa > var_fa_min) & (var_ff <= var_ff_max)
    out: List[VarOut] = []
    size_ms = int(window_s * 1000)
    for w, k in zip(*np.nonzero(hit)):
        out.append(
            VarOut(
                interner.lookup(int(k)), float(var_fa[w, k]), float(var_ff[w, k]),
                int(win.starts[w]), int(win.starts[w]) + size_ms,
                int(win.count[w, k]),
            )
        )
    out.sort(key=lambda o: (o.win_start, o.device_id))
    return out


# ---------------------------------------------------------------------------
# Window-scoped query cores — one fired window's events in, result
# records out: the node bodies of the composed SNCB DAG (``dag.py``),
# which shares ONE window clock across all
# queries (PARITY.md "Composed dataflow"). ``backend`` routes the zone
# test: "device" (contains_any_zone on ``device``) or "numpy"
# (contains_any_zone_np), as the caller chooses; results match to float
# ulps.


def _by_device(events: Sequence[GpsEvent]) -> Dict[str, List[GpsEvent]]:
    groups: Dict[str, List[GpsEvent]] = {}
    for e in events:
        groups.setdefault(e.device_id, []).append(e)
    return groups


def buffer_q1_zones(high_risk_zones: Sequence[BufferedZone],
                    radius_m: float = 20.0) -> List[BufferedZone]:
    """Q1's proximity widening (build once, not per window)."""
    return [
        BufferedZone(z.rings_metric, z.buffer_m + radius_m, z.name)
        for z in high_risk_zones
    ]


def q1_window(events: Sequence[GpsEvent],
              zones: Sequence[BufferedZone],
              backend: str = "device", device="cuda") -> List[EnrichedEvent]:
    """Q1 core: events near the (pre-buffered) high-risk zones,
    enriched to metric coords (Q1_HighRisk.java:73-78)."""
    return [
        CRSUtils.enrich(e)
        for e in _zone_filter(events, zones, keep_inside=True,
                              backend=backend, device=device)
    ]


def q2_window(events: Sequence[GpsEvent],
              maintenance_zones: Sequence[BufferedZone],
              start: int, end: int,
              var_fa_min: float = 0.6, var_ff_max: float = 0.5,
              backend: str = "device", device="cuda") -> List[VarOut]:
    """Q2 core: maintenance-zone exclude → per-device brake-pressure
    variation → varFA > a ∧ varFF ≤ b filter (Q2_BrakeMonitor.java)."""
    kept = _zone_filter(events, maintenance_zones, keep_inside=False,
                        backend=backend, device=device)
    out: List[VarOut] = []
    for dev in sorted(groups := _by_device(kept)):
        evs = groups[dev]
        var_fa, var_ff = variation(evs)
        if var_fa > var_fa_min and var_ff <= var_ff_max:
            out.append(VarOut(dev, var_fa, var_ff, start, end, len(evs)))
    return out


def q3_window(events: Sequence[GpsEvent],
              start: int, end: int) -> List[TrajOut]:
    """Q3 core: per-device window trajectory WKT (Q3_Trajectory.java)."""
    groups = _by_device(events)
    return [
        TrajOut(dev, trajectory_wkt(groups[dev]), start, end)
        for dev in sorted(groups)
    ]


def q4_window(events: Sequence[GpsEvent], start: int, end: int,
              min_lon: float, max_lon: float,
              min_lat: float, max_lat: float,
              t_min: int, t_max: int) -> List[TrajOut]:
    """Q4 core: Q3 with bbox/time-range predicate pushdown
    (Q4_TrajectoryRestricted.java)."""
    return q3_window(
        [e for e in events
         if min_lon <= e.lon <= max_lon and min_lat <= e.lat <= max_lat
         and t_min <= e.ts <= t_max],
        start, end,
    )


def q5_window(events: Sequence[GpsEvent],
              fence_zones: Sequence[BufferedZone],
              start: int, end: int,
              avg_threshold: float = 50.0, min_threshold: float = 20.0,
              backend: str = "device", device="cuda") -> List[TrajSpeedOut]:
    """Q5 core: geofence include → per-device trajectory + speed stats,
    avg > a ∨ min > m filter (Q5_TrajAndSpeedFence.java)."""
    fenced = _zone_filter(events, fence_zones, keep_inside=True,
                          backend=backend, device=device)
    out: List[TrajSpeedOut] = []
    for dev in sorted(groups := _by_device(fenced)):
        wkt, avg_speed, min_speed = traj_speed(groups[dev])
        if avg_speed > avg_threshold or (
            min_speed == min_speed and min_speed > min_threshold
        ):
            out.append(
                TrajSpeedOut(dev, wkt, avg_speed, min_speed, start, end)
            )
    return out


# Class-style aliases mirroring the reference entry points.
class Q1_HighRisk:
    build = staticmethod(q1_high_risk)


class Q2_BrakeMonitor:
    build = staticmethod(q2_brake_monitor)


class Q3_Trajectory:
    build = staticmethod(q3_trajectory)


class Q4_TrajectoryRestricted:
    build = staticmethod(q4_trajectory_restricted)


class Q5_TrajAndSpeedFence:
    build = staticmethod(q5_traj_speed_fence)
