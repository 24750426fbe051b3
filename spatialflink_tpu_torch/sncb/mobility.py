"""MobilityNebula-compatible queries MN_Q1–MN_Q5 (``GeoFlink/sncb/mobility/``)
and the MobilityRunner CLI.

These are the socket/CSV variants of the five SNCB queries with hardcoded
Brussels parameters and 2 s watermark lateness. They operate on raw WGS84
coordinates with no CRS transform, exactly like the reference (including
its quirk of treating the MN_Q1 ``tol_meters`` argument as a *degree*
radius — MN_Q1.java:36-79 passes it straight into the range query; the
instrumented variants in ``mn/`` apply the ×111320 degree→meter fix,
InstrumentedMN_Q1.java:176-190).

MN_Q5's geofence test runs on ``device`` (``BufferedZone.contains_batch``),
the card unless the caller asks for the CPU; ``mobility_runner`` and
``main`` pass their ``device`` on to it. MN_Q1–Q4 are host-only.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterable, Iterator, List, Optional, Sequence

import numpy as np

from spatialflink_tpu_torch.device import resolve_device
from spatialflink_tpu_torch.sncb.common import (
    BufferedZone,
    GpsEvent,
    csv_to_gps_event,
)
from spatialflink_tpu_torch.sncb.ops import (
    TrajOut,
    TrajSpeedOut,
    VarOut,
    traj_speed,
    trajectory_wkt,
    variance,
)
from spatialflink_tpu_torch.sncb.queries import keyed_windows, _windows

_MN_LATENESS_MS = 2_000  # Time.seconds(2) in every MN_Q*


@dataclass
class CountOut:
    """MN_Q1.CountOut (MN_Q1.java:37-46)."""

    start: int
    end: int
    cnt: int


def mn_q1(
    events: Iterable[GpsEvent],
    lon: float = 4.3658,
    lat: float = 50.6456,
    tol: float = 2.0,
    window_s: int = 5,
) -> Iterator[CountOut]:
    """MN_Q1: count points within ``tol`` of the query point per 5 s
    tumbling window (MN_Q1.java:36-79). ``tol`` is in the stream's
    coordinate units — degrees, reproducing the reference's
    tolMeters-as-degrees behavior. Defaults are MobilityRunner's
    (MobilityRunner.java q1 case: 4.3658, 50.6456, 2.0)."""
    for win in _windows(events, window_s * 1000, window_s * 1000, _MN_LATENESS_MS):
        if not win.events:
            continue
        xy = np.array([[e.lon, e.lat] for e in win.events])
        d = np.hypot(xy[:, 0] - lon, xy[:, 1] - lat)
        yield CountOut(win.start, win.end, int((d <= tol).sum()))


def mn_q2(
    events: Iterable[GpsEvent],
    window_s: float = 10.0,
    slide_ms: int = 200,
) -> Iterator[VarOut]:
    """MN_Q2: global ("ALL"-keyed) FA/FF variance over 10s/200ms sliding
    windows, excluding the 4.0–4.6 × 50.0–50.8 degree box
    (MN_Q2.java: exclude polygon + keyBy "ALL" + VarianceAgg)."""
    filtered = (
        e for e in events
        if not (4.0 <= e.lon <= 4.6 and 50.0 <= e.lat <= 50.8)
    )
    for _, start, end, evs in keyed_windows(
        filtered, int(window_s * 1000), slide_ms, key_fn=lambda e: "ALL",
        lateness_ms=_MN_LATENESS_MS,
    ):
        n, var_fa, var_ff = variance(evs)
        yield VarOut("ALL", var_fa, var_ff, start, end, n)


def mn_q3(
    events: Iterable[GpsEvent], window_s: float = 3.0, slide_s: float = 1.0
) -> Iterator[TrajOut]:
    """MN_Q3: global 3s/1s sliding-window trajectory (MN_Q3.java)."""
    for _, start, end, evs in keyed_windows(
        events, int(window_s * 1000), int(slide_s * 1000),
        key_fn=lambda e: "ALL", lateness_ms=_MN_LATENESS_MS,
    ):
        yield TrajOut("ALL", trajectory_wkt(evs), start, end)


def mn_q4(
    events: Iterable[GpsEvent],
    min_lon: float, min_lat: float, max_lon: float, max_lat: float,
    t_min: int, t_max: int,
    window_s: float = 20.0, slide_s: float = 2.0,
) -> Iterator[TrajOut]:
    """MN_Q4: bbox/time filter → global 20s/2s trajectory (MN_Q4.java)."""
    filtered = (
        e for e in events
        if min_lon <= e.lon <= max_lon and min_lat <= e.lat <= max_lat
        and t_min <= e.ts <= t_max
    )
    yield from mn_q3(filtered, window_s, slide_s)


def mn_q5(
    events: Iterable[GpsEvent],
    poly_lonlat: Sequence[Sequence[float]],
    tol: float,
    window_s: float = 20.0, slide_s: float = 2.0,
    avg_below: float = 100.0, min_below: float = 20.0,
    device="cuda",
) -> Iterator[TrajSpeedOut]:
    """MN_Q5: degree-space buffered geofence include → per-device 20s/2s
    trajectory+speed, filter avg < 100 ∨ min < 20 (MN_Q5.java — including
    the degree-units ``buffer(tolMeters)`` quirk: containment = inside the
    polygon or within ``tol`` coordinate units of its boundary). The
    fence test runs on ``device``."""
    device = resolve_device(device)
    # Degree-space buffered fence (rings in lon/lat, buffer in degrees —
    # the reference's unit quirk).
    fence = BufferedZone(rings_metric=[np.asarray(poly_lonlat, float)], buffer_m=tol)

    def in_fence(evs: List[GpsEvent]) -> List[GpsEvent]:
        if not evs:
            return []
        xy = np.array([[e.lon, e.lat] for e in evs])
        keep = fence.contains_batch(xy, device=device)
        return [e for e, k in zip(evs, keep) if k]

    def fenced():
        buf: List[GpsEvent] = []
        for e in events:
            buf.append(e)
            if len(buf) >= 8192:
                yield from in_fence(buf)
                buf = []
        yield from in_fence(buf)

    for dev, start, end, evs in keyed_windows(
        fenced(), int(window_s * 1000), int(slide_s * 1000),
        key_fn=lambda e: e.device_id, lateness_ms=_MN_LATENESS_MS,
    ):
        wkt, avg_speed, min_speed = traj_speed(evs)
        if avg_speed < avg_below or (min_speed == min_speed and min_speed < min_below):
            yield TrajSpeedOut(dev, wkt, avg_speed, min_speed, start, end)


# Class-style aliases.
class MN_Q1:
    CountOut = CountOut
    build = staticmethod(mn_q1)


class MN_Q2:
    build = staticmethod(mn_q2)


class MN_Q3:
    build = staticmethod(mn_q3)


class MN_Q4:
    build = staticmethod(mn_q4)


class MN_Q5:
    build = staticmethod(mn_q5)


# Default Q5 fence used by MobilityRunner (a central-Brussels quadrilateral).
Q5_FENCE = [[4.405, 50.846], [4.418, 50.846], [4.418, 50.858], [4.405, 50.858]]


def mobility_runner(
    query: str,
    source: Iterable[str],
    out_path: Optional[str] = None,
    delimiter: str = ",",
    collect: bool = True,
    device="cuda",
):
    """MobilityRunner.main analog (MobilityRunner.java:14-73): CSV lines →
    GpsEvents → query q1..q5 → CSV rows (returned, and written if
    ``out_path`` given). ``collect=False`` streams to the file only and
    returns the row count — O(1) memory for unbounded socket feeds.
    ``device``: where q5's fence test runs."""
    events = (csv_to_gps_event(ln, delimiter) for ln in source if ln.strip())
    q = query.lower()
    if q == "q1":
        rows = (f"{o.start},{o.end},{o.cnt}" for o in mn_q1(events, 4.3658, 50.6456, 2.0))
    elif q == "q2":
        rows = (
            f"{o.win_start},{o.win_end},{o.var_fa},{o.var_ff},{o.count}"
            for o in mn_q2(events)
        )
    elif q == "q3":
        rows = (f"{o.win_start},{o.win_end},{o.device_id},{o.wkt}" for o in mn_q3(events))
    elif q == "q4":
        rows = (
            f"{o.win_start},{o.win_end},{o.device_id},{o.wkt}"
            for o in mn_q4(events, 4.0, 50.0, 5.0, 51.0, 0, 2**62)
        )
    elif q == "q5":
        rows = (
            f"{o.win_start},{o.win_end},{o.device_id},{o.avg_speed},{o.min_speed},{o.wkt}"
            for o in mn_q5(events, Q5_FENCE, 0.001, device=device)
        )
    else:
        raise ValueError(f"unknown query {query!r}")

    sink = open(out_path, "w") if out_path else None
    collected = [] if collect else None
    n = 0
    try:
        for row in rows:
            n += 1
            if collected is not None:
                collected.append(row)
            if sink:
                sink.write(row + "\n")
    finally:
        if sink:
            sink.close()
    return collected if collected is not None else n


def main(argv=None, device="cuda"):
    """MobilityRunner.main CLI parity (MobilityRunner.java:14-73):
    ``python -m spatialflink_tpu_torch.sncb.mobility [q1..q5] [host] [port]
    [outDir]`` — socket text stream → CSV parse → query → per-query CSV
    file; q5's fence test runs on ``device``.

    Documented deviation: defaults are host ``localhost`` and outDir
    ``Output`` (the reference defaults to ``host.docker.internal`` and
    ``/workspace/Output`` — container-specific paths that don't apply
    here)."""
    import os
    import sys

    from spatialflink_tpu_torch.streams.sources import socket_source

    args = list(sys.argv[1:] if argv is None else argv)
    q = (args[0] if args else "q1").lower()
    host = args[1] if len(args) > 1 else "localhost"
    port = int(args[2]) if len(args) > 2 else 32323
    out_dir = args[3] if len(args) > 3 else "Output"
    os.makedirs(out_dir, exist_ok=True)
    lines = socket_source(host, port, parser=lambda s: s)
    out_path = os.path.join(out_dir, f"output_query{q[1:]}.csv")
    n = mobility_runner(q, lines, out_path=out_path, collect=False,
                        device=device)
    print(f"{q}: {n} rows -> {out_path}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
