"""Range queries: the point-stream classes ``PointPointRangeQuery``,
``PointPolygonRangeQuery`` and ``PointLineStringRangeQuery``, and the
geometry-stream classes ``Polygon{Point,Polygon,LineString}RangeQuery``
and ``LineString{Point,Polygon,LineString}RangeQuery``.

``run(stream, query_set, radius)`` yields one ``RangeResult`` per fired
window of objects; ``run_soa(chunks, query_set, radius)`` is the
high-rate path over SoA chunks (ragged boundary chains for the geometry
streams). The GeoFlink pruning is kept: an object in a guaranteed cell is
emitted, one in a candidate cell is emitted when its exact distance is
within the radius (range/RangeQuery.java:37-145); a polygon or
linestring takes the highest flag over the cells its bbox overlaps. The
kernels are ``ops/range.py``'s; every point→edge distance of the polygon
and linestring paths, and both directions of every geometry-stream
distance, run through B4 on the card. Window results equal the JAX
package's ``operators/range_query.py``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterable, Iterator, List, Optional

import numpy as np

from spatialflink_tpu_torch.models.batch import (
    GeometryBatch,
    flag_prefix_planes,
)
from spatialflink_tpu_torch.models.objects import Point, SpatialObject
from spatialflink_tpu_torch.operators.base import (
    SpatialOperator,
    center_coords,
    flags_for_queries,
    pack_query_geometries,
    pack_query_points,
    ship,
    soa_point_batches,
)
from spatialflink_tpu_torch.ops.range import (
    geometry_range_query_kernel,
    range_points_fused,
    range_polygons_fused,
    range_polygons_pruned_compact_fused,
    range_polygons_pruned_fused,
    range_polylines_fused,
)
from spatialflink_tpu_torch.streams.soa import RaggedSoaWindowAssembler


@dataclass
class RangeResult:
    """One fired window's matches."""

    start: int
    end: int
    objects: List[SpatialObject]
    dists: np.ndarray
    window_count: int  # events in the window before filtering


class _PointStreamRangeQuery(SpatialOperator):
    """Point stream vs a {point, polygon, linestring} query set.

    ``ncand`` and ``cand_budget``: the pruned polygon paths' starting
    candidate count and candidate-lane budget (the JAX operator's
    ``_ncand`` and ``_cand_budget``, which grow on overflow and persist
    across windows and runs); pass a JAX operator's grown values, e.g.
    through ``state.range_state_from_jax``, to compute from the same
    start. None takes the JAX defaults (8 and 4,096) at first use."""

    query_kind = "point"

    def __init__(self, conf, grid, device="cuda", mesh=None,
                 ncand: Optional[int] = None,
                 cand_budget: Optional[int] = None):
        if mesh is not None:
            raise NotImplementedError(
                "mesh= (multi-GPU range) is not ported yet: ROADMAP A12")
        super().__init__(conf, grid, device=device)
        if ncand is not None:
            self._ncand = int(ncand)
        if cand_budget is not None:
            self._cand_budget = int(cand_budget)

    def _window_evaluator(self, query_set, flags, radius):
        """``eval(common) -> (keep, dist)`` for this family's query kind,
        ``common = (xy, valid, cell, flags_table)`` on the device: the one
        place of kernel selection, query packing and the pruned paths'
        overflow retries (shared by ``run`` and ``run_soa``).

        Polygons: exact-mode sets of 64 or more take bbox-candidate
        pruning; with a flag occupancy under 25% the candidate lanes are
        compacted first. Approximate mode stays dense: its keep set ignores
        distances, so pruned minima would differ on kept lanes."""
        approx = self.conf.approximate_query
        if self.query_kind == "point":
            q = self.device_q(pack_query_points(query_set))
            return lambda common: range_points_fused(
                *common, q, radius, approximate=approx)

        verts, ev = pack_query_geometries(query_set)
        qv = self.device_q(verts)
        (qe,) = ship(ev, device=self.device).arrive()
        if self.query_kind == "linestring":
            return lambda common: range_polylines_fused(
                *common, qv, qe, radius, approximate=approx)

        nq = len(query_set)
        if nq < 64 or approx:
            return lambda common: range_polygons_fused(
                *common, qv, qe, radius, approximate=approx)

        use_compact = float((flags > 0).mean()) < 0.25
        if use_compact and not hasattr(self, "_cand_budget"):
            self._cand_budget = 4096  # persists across windows
        if not hasattr(self, "_ncand"):
            self._ncand = 8  # persists: dense data pays the retry once

        def ev_pruned(common):
            # One wait per try for the overflow counts, as the JAX loop.
            while True:
                if use_compact:
                    keep, dist, c_over, b_over = \
                        range_polygons_pruned_compact_fused(
                            *common, qv, qe, radius,
                            budget=self._cand_budget, cand=self._ncand)
                else:
                    keep, dist, c_over = range_polygons_pruned_fused(
                        *common, qv, qe, radius, cand=self._ncand)
                    b_over = 0
                grew = False
                if int(b_over) > 0:
                    need = self._cand_budget + int(b_over)
                    self._cand_budget = int(2 ** np.ceil(np.log2(need)))
                    grew = True
                if int(c_over) > 0 and self._ncand < nq:
                    self._ncand = min(self._ncand * 2, nq)
                    grew = True
                if not grew:
                    return keep, dist

        return ev_pruned

    def run(self, stream: Iterable[Point], query_set, radius: float,
            dtype=np.float64, mesh=None, driver=None
            ) -> Iterator[RangeResult]:
        """One ``RangeResult`` per fired window (WindowBased, RealTime
        micro-batches, CountBased): the JAX operator's plain window loop,
        errors propagating. ``dtype`` is accepted for the JAX signature:
        the port computes in float32."""
        if driver is not None:
            raise NotImplementedError(
                "driver= (checkpointing, retry, failover) is not ported "
                "yet: ROADMAP A11")
        if mesh is not None:
            raise NotImplementedError(
                "mesh= (multi-GPU range) is not ported yet: ROADMAP A12")
        if not isinstance(query_set, (list, tuple)):
            query_set = [query_set]
        flags = flags_for_queries(self.grid, radius, query_set)
        (flags_d,) = ship(flags, device=self.device).arrive()
        evaluate = self._window_evaluator(query_set, flags, radius)
        for win in self.windows(stream):
            batch = self.point_batch(win.events)
            xy_d, valid_d, cell_d = ship(
                center_coords(self.grid, batch.xy), batch.valid, batch.cell,
                device=self.device).arrive()
            keep, dist = evaluate((xy_d, valid_d, cell_d, flags_d))
            keep, dist = keep.cpu().numpy(), dist.cpu().numpy()
            idx = np.nonzero(keep)[0]
            yield RangeResult(win.start, win.end,
                              [win.events[i] for i in idx], dist[idx],
                              len(win.events))

    def run_partitioned(self, *args, **kwargs):
        raise NotImplementedError(
            "run_partitioned (grid-partitioned multi-GPU range) is not "
            "ported yet: ROADMAP A12")

    def run_soa(self, chunks, query_set, radius: float, dtype=np.float64):
        """High-rate SoA path: chunks of {"ts", "x", "y", ...} arrays → per
        window ``(start, end, matched_arrays, dists)``, ``matched_arrays``
        the window's arrays sliced to its matches, with ``run``'s kernel
        selection (the pruned and compact paths included)."""
        if not isinstance(query_set, (list, tuple)):
            query_set = [query_set]
        flags = flags_for_queries(self.grid, radius, query_set)
        (flags_d,) = ship(flags, device=self.device).arrive()
        evaluate = self._window_evaluator(query_set, flags, radius)
        for win, xy, valid, cell, _ in soa_point_batches(self.grid, chunks,
                                                         self.conf):
            lanes = ship(xy, valid, cell, device=self.device).arrive()
            keep, dist = evaluate((*lanes, flags_d))
            n = win.count
            keep = keep[:n].cpu().numpy()
            dist = dist[:n].cpu().numpy()
            idx = np.nonzero(keep)[0]
            matched = {k: np.asarray(v)[idx] for k, v in win.arrays.items()}
            yield win.start, win.end, matched, dist[idx]


class PointPointRangeQuery(_PointStreamRangeQuery):
    """range/PointPointRangeQuery.java (realtime :44-108, window
    :111-187)."""

    query_kind = "point"

    def query_incremental(self, stream: Iterable[Point], query_point: Point,
                          radius: float, dtype=np.float64
                          ) -> Iterator[RangeResult]:
        """Incremental sliding windows (PointPointRangeQuery.java:195-296):
        results that qualified in earlier windows are re-emitted from the
        carry; only the newest slide pane (ts >= end - slide) is
        evaluated. Equal to ``run`` on in-order streams; a non-zero
        allowed lateness is rejected (late refires would emit carried
        results twice)."""
        if self.conf.allowed_lateness_ms > 0:
            raise ValueError(
                "query_incremental does not support allowed_lateness "
                "(late-window refires would double-emit carried results); "
                "use run() for late-tolerant streams")
        flags = flags_for_queries(self.grid, radius, [query_point])
        (flags_d,) = ship(flags, device=self.device).arrive()
        q = self.device_q([[query_point.x, query_point.y]])
        slide_ms = self.conf.slide_step_ms
        approx = self.conf.approximate_query
        carry: List[tuple] = []  # (event, dist)
        for win in self.windows(stream):
            objects: List[SpatialObject] = []
            dists: List[float] = []
            next_carry = []
            for ev, d in carry:
                if win.start <= ev.timestamp < win.end:
                    objects.append(ev)
                    dists.append(d)
                    if ev.timestamp >= win.start + slide_ms:
                        next_carry.append((ev, d))
            new_events = [e for e in win.events
                          if e.timestamp >= win.end - slide_ms]
            if new_events:
                batch = self.point_batch(new_events)
                xy_d, valid_d, cell_d = ship(
                    center_coords(self.grid, batch.xy), batch.valid,
                    batch.cell, device=self.device).arrive()
                keep, dist = range_points_fused(
                    xy_d, valid_d, cell_d, flags_d, q, radius,
                    approximate=approx)
                keep, dist = keep.cpu().numpy(), dist.cpu().numpy()
                for i in np.nonzero(keep)[0]:
                    ev, d = new_events[i], float(dist[i])
                    objects.append(ev)
                    dists.append(d)
                    if ev.timestamp >= win.start + slide_ms:
                        next_carry.append((ev, d))
            carry = next_carry
            yield RangeResult(win.start, win.end, objects, np.asarray(dists),
                              len(win.events))


class PointPolygonRangeQuery(_PointStreamRangeQuery):
    """range/PointPolygonRangeQuery.java:31-160 (the bbox-approximate mode
    of :76-80 is the ``approximate_query`` flag)."""

    query_kind = "polygon"


class PointLineStringRangeQuery(_PointStreamRangeQuery):
    """range/PointLineStringRangeQuery.java."""

    query_kind = "linestring"


class _GeometryStreamRangeQuery(SpatialOperator):
    """Polygon or linestring stream vs a {point, polygon, linestring}
    query set: per object the min over the queries of
    ``ops/range.py:geometry_pair_distance`` (0 on containment), flagged by
    the highest flag over the cells its bbox overlaps."""

    query_kind = "point"
    stream_polygonal = True

    def __init__(self, conf, grid, device="cuda", mesh=None):
        if mesh is not None:
            raise NotImplementedError(
                "mesh= (multi-GPU range) is not ported yet: ROADMAP A12")
        super().__init__(conf, grid, device=device)

    def _kernel_statics(self):
        return dict(
            approximate=self.conf.approximate_query,
            obj_polygonal=self.stream_polygonal,
            query_polygonal=self.query_kind == "polygon",
        )

    def _query_arrays(self, query_set):
        """(qverts, qev) of the packed query set; a point packs as a
        degenerate 2-vertex polyline."""
        if self.query_kind == "point":
            q = pack_query_points(query_set)
            return (np.repeat(q[:, None, :], 2, axis=1),
                    np.ones((len(query_set), 1), bool))
        return pack_query_geometries(query_set)

    def _window_evaluator(self, query_set, radius):
        """``eval(batch) -> (keep, dist)`` host arrays for a
        ``GeometryBatch``: the query set packed and shipped once, the
        per-object flags from the prefix planes of its flag table (shared
        by ``run`` and ``run_soa``)."""
        flags = flags_for_queries(self.grid, radius, query_set)
        prefix = flag_prefix_planes(self.grid, flags)
        qverts, qev = self._query_arrays(query_set)
        qv = self.device_verts(qverts)
        (qe,) = ship(qev, device=self.device).arrive()
        statics = self._kernel_statics()

        def evaluate(batch: GeometryBatch):
            oflags = batch.any_cell_flagged(self.grid, flags, prefix=prefix)
            ev_d, valid_d, oflags_d = ship(
                batch.edge_valid, batch.valid, oflags,
                device=self.device).arrive()
            keep, dist = geometry_range_query_kernel(
                self.device_verts(batch.verts), ev_d, valid_d, oflags_d,
                qv, qe, radius, **statics)
            return keep.cpu().numpy(), dist.cpu().numpy()

        return evaluate

    def run(self, stream: Iterable, query_set, radius: float,
            dtype=np.float64, mesh=None) -> Iterator[RangeResult]:
        """One ``RangeResult`` per fired window of ``Polygon`` or
        ``LineString`` objects (WindowBased, RealTime micro-batches,
        CountBased). ``dtype`` is accepted for the JAX signature: the port
        computes in float32."""
        if mesh is not None:
            raise NotImplementedError(
                "mesh= (multi-GPU range) is not ported yet: ROADMAP A12")
        if not isinstance(query_set, (list, tuple)):
            query_set = [query_set]
        evaluate = self._window_evaluator(query_set, radius)
        for win in self.windows(stream):
            keep, dist = evaluate(self.geometry_batch(win.events))
            idx = np.nonzero(keep)[0]
            yield RangeResult(win.start, win.end,
                              [win.events[i] for i in idx], dist[idx],
                              len(win.events))

    def run_soa(self, chunks, query_set, radius: float, dtype=np.float64):
        """Ragged-SoA path: geometry chunks ``{"ts", "oid", "lengths",
        "verts"}`` (and optionally ``"edge_valid"``, multi-ring seams
        False; dense int32 oids) → per window ``(start, end,
        kept_indices, kept_oids, dists, window_count)``, through the same
        kernel as ``run`` with no per-object Python."""
        if not isinstance(query_set, (list, tuple)):
            query_set = [query_set]
        evaluate = self._window_evaluator(query_set, radius)
        asm = RaggedSoaWindowAssembler(
            self.conf.window_size_ms, self.conf.slide_step_ms,
            ooo_ms=self.conf.allowed_lateness_ms)
        for win in asm.stream(chunks):
            keep, dist = evaluate(GeometryBatch.from_ragged(
                win.ts, win.oid, win.lengths, win.verts,
                edge_valid_flat=win.edge_valid, dtype=np.float64))
            idx = np.nonzero(keep)[0]
            yield (win.start, win.end, idx, win.oid[idx], dist[idx],
                   win.count)


class PolygonPointRangeQuery(_GeometryStreamRangeQuery):
    """range/PolygonPointRangeQuery.java."""

    query_kind = "point"


class PolygonPolygonRangeQuery(_GeometryStreamRangeQuery):
    """range/PolygonPolygonRangeQuery.java."""

    query_kind = "polygon"


class PolygonLineStringRangeQuery(_GeometryStreamRangeQuery):
    """range/PolygonLineStringRangeQuery.java."""

    query_kind = "linestring"


class LineStringPointRangeQuery(_GeometryStreamRangeQuery):
    """range/LineStringPointRangeQuery.java."""

    query_kind = "point"
    stream_polygonal = False


class LineStringPolygonRangeQuery(_GeometryStreamRangeQuery):
    """range/LineStringPolygonRangeQuery.java."""

    query_kind = "polygon"
    stream_polygonal = False


class LineStringLineStringRangeQuery(_GeometryStreamRangeQuery):
    """range/LineStringLineStringRangeQuery.java."""

    query_kind = "linestring"
    stream_polygonal = False
