"""StayTime app: per-cell dwell-time heatmaps (``GeoFlink/apps/
StayTime.java``), as in the JAX package's ``apps/staytime.py``.

Three queries, matching StayTime.java:35-150:
  - ``cell_stay_time``: per trajectory per window, walk ts-ordered points
    and attribute each consecutive time gap to the earlier point's grid
    cell; then sum per cell (CellStayTimeWinFunction :216-396 +
    CellStayTimeAggregateWinFunction :433-447). Output per window:
    {cellName: totalStayTimeMs}.
  - ``cell_sensor_range_intersection``: per window, count sensor polygons
    whose geometry intersects each cell's boundary box
    (CellSensorIntersectionWinFunction :398-430).
  - ``normalized_cell_stay_time``: join on cell:
    (stayTime/1000 / sensorCount) * windowSize
    (normalizedCellStayTimeWinFunction :189-213).

``cell_stay_time_soa`` computes the first from SoA chunks with one
``ops/trajectory.py:stay_time_cells_kernel`` call a window on a device
(int64 sums, so exact there too); the sensor intersection tests cell
corners with ``ops/polygon.py:points_in_polygon`` on a device.
"""

from __future__ import annotations

from typing import Dict, Iterable, Iterator, Optional, Set, Tuple

import numpy as np

import torch

from spatialflink_tpu_torch.device import resolve_device
from spatialflink_tpu_torch.grid import UniformGrid
from spatialflink_tpu_torch.models.objects import Point, Polygon
from spatialflink_tpu_torch.ops.polygon import points_in_polygon
from spatialflink_tpu_torch.ops.trajectory import stay_time_cells_kernel
from spatialflink_tpu_torch.streams.soa import SoaWindowAssembler
from spatialflink_tpu_torch.streams.windows import (
    SlidingEventTimeWindows,
    WindowAssembler,
)
from spatialflink_tpu_torch.utils.padding import next_bucket


def _windows(events, window_s: int, slide_s: int, lateness_s: int):
    asm = WindowAssembler(
        SlidingEventTimeWindows(window_s * 1000, slide_s * 1000),
        timestamp_fn=lambda e: e.timestamp,
        max_out_of_orderness_ms=lateness_s * 1000,
    )
    yield from asm.stream(events)


def _any_edge_hits_rect(p: np.ndarray, q: np.ndarray,
                        x1: float, y1: float, x2: float, y2: float) -> bool:
    """True if any segment p[i]→q[i] intersects the axis-aligned rectangle
    (Liang–Barsky clip, vectorized over segments)."""
    if len(p) == 0:
        return False
    d = q - p
    t0 = np.zeros(len(p))
    t1 = np.ones(len(p))
    ok = np.ones(len(p), bool)
    for dim, lo, hi in ((0, x1, x2), (1, y1, y2)):
        dd = d[:, dim]
        pp = p[:, dim]
        with np.errstate(divide="ignore", invalid="ignore"):
            tlo = (lo - pp) / dd
            thi = (hi - pp) / dd
        enter = np.where(dd >= 0, tlo, thi)
        exit_ = np.where(dd >= 0, thi, tlo)
        par = dd == 0
        ok &= ~(par & ((pp < lo) | (pp > hi)))
        t0 = np.where(par, t0, np.maximum(t0, enter))
        t1 = np.where(par, t1, np.minimum(t1, exit_))
    return bool((ok & (t0 <= t1)).any())


def cell_stay_time(
    points: Iterable[Point],
    traj_ids: Set[str],
    allowed_lateness_s: int,
    window_s: int,
    slide_s: int,
    grid: UniformGrid,
) -> Iterator[Tuple[int, int, Dict[str, float]]]:
    """Yield (winStart, winEnd, {cellName: stayTimeMs}) per fired window.

    Consecutive-point time gaps are attributed to the earlier point's cell
    (vectorized with numpy over the ts-sorted per-trajectory arrays — the
    same walk as CellStayTimeWinFunction's loop)."""
    for win in _windows(points, window_s, slide_s, allowed_lateness_s):
        evs = [p for p in win.events if not traj_ids or p.obj_id in traj_ids]
        if not evs:
            continue
        yield (win.start, win.end, stay_time_window(evs, grid))


def stay_time_window(evs, grid: UniformGrid) -> Dict[str, float]:
    """One window's {cellName: stayTimeMs}: the host walk of
    ``cell_stay_time``. ``evs`` carry ``obj_id``/``timestamp``/``x``/``y``
    attributes (Points, or events adapted by the caller)."""
    per_cell: Dict[str, float] = {}
    by_obj: Dict[str, list] = {}
    for p in evs:
        by_obj.setdefault(p.obj_id, []).append(p)
    for pts in by_obj.values():
        pts.sort(key=lambda p: p.timestamp)
        if len(pts) < 2:
            continue
        ts = np.array([p.timestamp for p in pts], np.int64)
        cells = grid.assign_cells_np(
            np.array([[p.x, p.y] for p in pts], float)
        )
        gaps = ts[1:] - ts[:-1]
        for cell, gap in zip(cells[:-1], gaps):
            name = grid.cell_name(int(cell)) if cell < grid.num_cells else "out"
            per_cell[name] = per_cell.get(name, 0.0) + float(gap)
    return per_cell


def cell_stay_time_soa(
    chunks,
    window_s: int,
    slide_s: int,
    grid: UniformGrid,
    allowed_lateness_s: int = 0,
    oid_allow: Optional[np.ndarray] = None,
    device="cuda",
) -> Iterator[Tuple[int, int, np.ndarray, np.ndarray]]:
    """The SoA path of ``cell_stay_time``: point chunks {"ts", "x", "y",
    "oid"} (dense int oids) → per window (start, end, cell_ids,
    dwell_ms), one ``stay_time_cells_kernel`` call a window on ``device``
    (the card unless ``"cpu"``) in place of the per-trajectory walk
    (apps/StayTime.java:216-396). ``cell_ids`` may include
    ``grid.num_cells``, the object path's "out" bucket. ``oid_allow``: an
    optional bool mask over the dense oids (the trajIdSet filter); the
    points it drops are removed before pairing, as the object path's
    pre-filter does (masking them would pair the rest differently)."""
    dev = resolve_device(device)
    asm = SoaWindowAssembler(
        window_s * 1000, slide_s * 1000, ooo_ms=allowed_lateness_s * 1000,
    )
    for win in asm.stream(chunks):
        ts = np.asarray(win.arrays["ts"], np.int64)[:win.count]
        oid = np.asarray(win.arrays["oid"], np.int64)[:win.count]
        xy = np.stack(
            [np.asarray(win.arrays["x"], np.float64)[:win.count],
             np.asarray(win.arrays["y"], np.float64)[:win.count]],
            axis=1,
        )
        if oid_allow is not None:
            keep = oid_allow[oid]
            ts, oid, xy = ts[keep], oid[keep], xy[keep]
        if len(ts) == 0:
            # As the object path: a window with no event left does not
            # fire; one with events but no pairs fires empty.
            continue
        hit, dwell = stay_time_window_soa(ts, oid, xy, grid, device=dev)
        yield (win.start, win.end, hit, dwell)


def stay_time_window_soa(ts, oid, xy, grid: UniformGrid, kernel=None, *,
                         device="cuda"):
    """One window's (cell_ids, dwell_ms) through ``kernel`` on
    ``device``. ``ts``/``oid`` int64 arrays, ``xy`` (N, 2) float64; the
    points are sorted by (oid, ts) and padded here. ``kernel`` stands in
    the JAX position: a function with ``stay_time_cells_kernel``'s
    signature, ``None`` for ``stay_time_cells_kernel`` itself."""
    if len(ts) < 2:
        return np.empty(0, np.int32), np.empty(0, np.int64)
    dev = resolve_device(device)
    order = np.lexsort((ts, oid))
    cells = grid.assign_cells_np(xy[order])
    nb = next_bucket(len(ts), minimum=8)
    pad = nb - len(ts)
    t_rel = ts[order] - int(ts.min())
    tp = np.concatenate([t_rel, np.zeros(pad, np.int64)])
    op_ = np.concatenate([oid[order], np.full(pad, -1, np.int64)])
    cp = np.concatenate([cells, np.full(pad, grid.num_cells, np.int64)])
    vp = np.concatenate([np.ones(len(ts), bool), np.zeros(pad, bool)])
    lanes = [torch.from_numpy(a).to(dev) for a in (tp, cp, op_, vp)]
    kernel = stay_time_cells_kernel if kernel is None else kernel
    dwell, cnt = kernel(*lanes, num_cells=grid.num_cells)
    dwell = dwell.cpu().numpy()
    hit = np.nonzero(cnt.cpu().numpy())[0].astype(np.int32)
    return hit, dwell[hit]


def cell_sensor_range_intersection(
    polygons: Iterable[Polygon],
    traj_ids: Set[str],
    allowed_lateness_s: int,
    window_s: int,
    slide_s: int,
    grid: UniformGrid,
    device="cuda",
) -> Iterator[Tuple[int, int, Dict[str, int]]]:
    """Yield (winStart, winEnd, {cellName: intersectingSensorCount}).

    A sensor-range polygon counts for every cell of its bbox that it
    intersects: a cell corner inside the polygon (``points_in_polygon``
    on ``device``), a polygon vertex inside the cell, or a polygon edge
    crossing the cell's rectangle (a thin strip through the cell with
    neither). The reference replicates each polygon to its gridIDsSet and
    tests it against the cell's boundary polygon."""
    dev = resolve_device(device)
    for win in _windows(polygons, window_s, slide_s, allowed_lateness_s):
        evs = [p for p in win.events if not traj_ids or p.obj_id in traj_ids]
        per_cell: Dict[str, int] = {}
        for poly in evs:
            verts, ev = poly.packed()
            verts_d = torch.from_numpy(verts).to(dev)
            ev_d = torch.from_numpy(ev).to(dev)
            pv = np.concatenate(poly.rings, axis=0)
            for cell in poly.grid_cells(grid):
                xi, yi = divmod(int(cell), grid.n)
                x1 = grid.min_x + xi * grid.cell_length
                y1 = grid.min_y + yi * grid.cell_length
                x2, y2 = x1 + grid.cell_length, y1 + grid.cell_length
                corners = torch.tensor(
                    [[x1, y1], [x2, y1], [x2, y2], [x1, y2]],
                    dtype=torch.float64, device=dev)
                corner_in = bool(
                    points_in_polygon(corners, verts_d, ev_d).any())
                vert_in = bool(
                    ((pv[:, 0] >= x1) & (pv[:, 0] <= x2)
                     & (pv[:, 1] >= y1) & (pv[:, 1] <= y2)).any()
                )
                if corner_in or vert_in or _any_edge_hits_rect(
                        verts[:-1][ev], verts[1:][ev], x1, y1, x2, y2):
                    name = grid.cell_name(int(cell))
                    per_cell[name] = per_cell.get(name, 0) + 1
        yield (win.start, win.end, per_cell)


def normalized_cell_stay_time(
    points: Iterable[Point],
    traj_ids_point: Set[str],
    polygons: Iterable[Polygon],
    traj_ids_sensor: Set[str],
    allowed_lateness_s: int,
    window_s: int,
    slide_s: int,
    grid: UniformGrid,
    device="cuda",
) -> Iterator[Tuple[str, int, int, float]]:
    """Join stay time with sensor coverage per (cell, window):
    normalized = (stayTimeMs/1000 / sensorCount) * windowSize
    (normalizedCellStayTimeWinFunction, StayTime.java:199-211).
    Yields (cellName, winStart, winEnd, normalizedStayTime); the sensor
    intersection runs on ``device``."""
    stay = {
        (s, e): cells
        for s, e, cells in cell_stay_time(
            points, traj_ids_point, allowed_lateness_s, window_s, slide_s, grid
        )
    }
    sensors = {
        (s, e): cells
        for s, e, cells in cell_sensor_range_intersection(
            polygons, traj_ids_sensor, allowed_lateness_s, window_s, slide_s,
            grid, device=device,
        )
    }
    for span in sorted(set(stay) & set(sensors)):
        for cell, st in sorted(stay[span].items()):
            cnt = sensors[span].get(cell)
            if cnt:
                yield (cell, span[0], span[1], (st / 1000.0 / cnt) * window_s)
