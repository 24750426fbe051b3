"""SNCB window aggregations — counterparts of ``GeoFlink/sncb/ops/``.

The reference implements these as Flink AggregateFunction + ProcessWindow
pairs (VariationAgg/VariationWindowFn, VarianceAgg, TrajectoryAgg,
TrajSpeedAgg — sncb/ops/*.java). Here each is a pure function over a
window's event list plus a mergeable accumulator form used by the
vectorized pane engine (streams/panes.py).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Sequence

from spatialflink_tpu_torch.sncb.common import GpsEvent


@dataclass
class VarOut:
    """VariationWindowFn.VarOut / VarianceWindowFn.VarOut."""

    device_id: str
    var_fa: float
    var_ff: float
    win_start: int
    win_end: int
    count: int = 0


@dataclass
class TrajOut:
    """TrajectoryWindowFn.TrajOut: per device-window WKT trajectory."""

    device_id: str
    wkt: str
    win_start: int
    win_end: int


@dataclass
class TrajSpeedOut:
    """TrajSpeedWindowFn.TrajSpeedOut."""

    device_id: str
    wkt: str
    avg_speed: float
    min_speed: float
    win_start: int
    win_end: int


def variation(events: Sequence[GpsEvent]) -> tuple:
    """max−min range of FA and FF over the window (VariationAgg.java:6-47);
    None values skipped; empty → -inf ranges like the untouched accumulator."""
    min_fa = min_ff = math.inf
    max_fa = max_ff = -math.inf
    for e in events:
        if e.fa is not None:
            min_fa = min(min_fa, e.fa)
            max_fa = max(max_fa, e.fa)
        if e.ff is not None:
            min_ff = min(min_ff, e.ff)
            max_ff = max(max_ff, e.ff)
    var_fa = max_fa - min_fa if max_fa >= min_fa else -math.inf
    var_ff = max_ff - min_ff if max_ff >= min_ff else -math.inf
    return var_fa, var_ff


def variance(events: Sequence[GpsEvent]) -> tuple:
    """Population variance of FA/FF via sum/sumSq (VarianceAgg.java:6-44).
    Parity detail: ``n`` counts every event (the reference increments n
    unconditionally), while sums skip None fields."""
    n = 0
    sum_fa = sum_sq_fa = sum_ff = sum_sq_ff = 0.0
    for e in events:
        if e.fa is not None:
            sum_fa += e.fa
            sum_sq_fa += e.fa * e.fa
        if e.ff is not None:
            sum_ff += e.ff
            sum_sq_ff += e.ff * e.ff
        n += 1
    return n, _variance(n, sum_fa, sum_sq_fa), _variance(n, sum_ff, sum_sq_ff)


def _variance(n: int, s: float, sq: float) -> float:
    """VarianceAgg.variance (VarianceAgg.java:38-43): 0 for n<=1, clamped."""
    if n <= 1:
        return 0.0
    mean = s / n
    return max(0.0, sq / n - mean * mean)


def trajectory_wkt(events: Sequence[GpsEvent]) -> str:
    """Window trajectory as WKT, points sorted by timestamp
    (TrajectoryAgg/TrajectoryWindowFn: POINT EMPTY / POINT / LINESTRING)."""
    pts = sorted(events, key=lambda e: e.ts)
    if not pts:
        return "POINT EMPTY"
    # float() wraps: event coords may be numpy scalars (SoA decode), and
    # numpy ≥2 would print np.float64(…) into the WKT (sfcheck
    # fstring-numpy).
    if len(pts) == 1:
        return f"POINT ({float(pts[0].lon):g} {float(pts[0].lat):g})"
    return ("LINESTRING ("
            + ", ".join(f"{float(e.lon):g} {float(e.lat):g}" for e in pts)
            + ")")


def traj_speed(events: Sequence[GpsEvent]) -> tuple:
    """(wkt, avg_speed, min_speed) — TrajSpeedAgg/TrajSpeedWindowFn:
    avg 0.0 and min NaN when no speeds present."""
    wkt = trajectory_wkt(events)
    speeds = [e.gps_speed for e in events if e.gps_speed is not None]
    if speeds:
        return wkt, sum(speeds) / len(speeds), min(speeds)
    return wkt, 0.0, math.nan
