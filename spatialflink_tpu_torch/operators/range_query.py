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

Every class honours ``dtype`` by the JAX package's rule
(``precision.py``): with ``dtype`` float64 and the float64 mode on, the
lanes (points, or the vertices of the geometry streams and of the query
set) are raw float64 coordinates and the kernels (B4's float64
instantiation on the card) compare the radius and return distances in
float64; otherwise centred float32, as before. A mesh run takes the same
lanes as the unsharded one, each shard through the same kernels.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterable, Iterator, List, Optional, Sequence

import numpy as np

from spatialflink_tpu_torch.models.batch import (
    GeometryBatch,
    flag_prefix_planes,
)
from spatialflink_tpu_torch.models.objects import Point, SpatialObject
from spatialflink_tpu_torch.operators.base import (
    SpatialOperator,
    center_coords,
    count_window_batches,
    flags_for_queries,
    jitted,
    pack_query_geometries,
    pack_query_points,
    ship,
    soa_point_batches,
    window_program,
)
from spatialflink_tpu_torch.operators.query_config import QueryType
from spatialflink_tpu_torch.parallel.mesh import require_mesh
from spatialflink_tpu_torch.ops.counters import count_candidates, counters
from spatialflink_tpu_torch.ops.range import (
    geometry_range_query_kernel,
    range_points_fused,
    range_polygons_fused,
    range_polygons_pruned_compact_fused,
    range_polygons_pruned_fused,
    range_polylines_fused,
)
from spatialflink_tpu_torch.streams.soa import RaggedSoaWindowAssembler
from spatialflink_tpu_torch.telemetry import telemetry


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
        super().__init__(conf, grid, device=device, mesh=mesh)
        if ncand is not None:
            self._ncand = int(ncand)
        if cand_budget is not None:
            self._cand_budget = int(cand_budget)

    def _window_evaluator(self, query_set, flags, radius, mesh=None,
                          dtype=np.float32):
        """``eval(common) -> (keep, dist)`` for this family's query kind,
        ``common = (xy, valid, cell, flags_table)`` on the device: the one
        place of kernel selection, query packing and the pruned paths'
        overflow retries (shared by ``run`` and ``run_soa``). The query
        lanes are ``center_coords`` of ``dtype``, as the point lanes must
        be.

        Polygons: exact-mode sets of 64 or more take bbox-candidate
        pruning; with a flag occupancy under 25% the candidate lanes are
        compacted first. Approximate mode stays dense: its keep set ignores
        distances, so pruned minima would differ on kept lanes. On a
        ``mesh`` every kind runs its dense kernel sharded over the points
        (``window_program``), as in the JAX package."""
        approx = self.conf.approximate_query
        if self.query_kind == "point":
            q = self.device_q(pack_query_points(query_set), dtype)
            pk = window_program(mesh, range_points_fused, (0, 1, 2), 6,
                                approximate=approx)
            return lambda common: pk(*common, q, radius)

        verts, ev = pack_query_geometries(query_set)
        qv = self.device_q(verts, dtype)
        (qe,) = ship(ev, device=self.device).arrive()
        if self.query_kind == "linestring":
            lk = window_program(mesh, range_polylines_fused, (0, 1, 2), 7,
                                approximate=approx)
            return lambda common: lk(*common, qv, qe, radius)

        nq = len(query_set)
        if nq < 64 or approx or mesh is not None:
            polyk = window_program(mesh, range_polygons_fused, (0, 1, 2), 7,
                                   approximate=approx)
            return lambda common: polyk(*common, qv, qe, radius)

        use_compact = float((flags > 0).mean()) < 0.25
        if use_compact and not hasattr(self, "_cand_budget"):
            self._cand_budget = 4096  # persists across windows
        if not hasattr(self, "_ncand"):
            self._ncand = 8  # persists: dense data pays the retry once
        prunedk = jitted(range_polygons_pruned_compact_fused if use_compact
                         else range_polygons_pruned_fused)

        def ev_pruned(common):
            # One wait per try for the overflow counts, as the JAX loop.
            while True:
                if use_compact:
                    keep, dist, c_over, b_over = prunedk(
                        *common, qv, qe, radius,
                        budget=self._cand_budget, cand=self._ncand)
                else:
                    keep, dist, c_over = prunedk(
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
        micro-batches, CountBased), through the dataflow driver
        (``driver.py``): pass ``driver=`` to opt into checkpoints, retry
        with backoff and, for a point query set, failover to the numpy
        twin (polygon and linestring sets have none and stay strict).
        Without one, ``strict_driver()`` gives the plain window loop:
        errors propagate, nothing retries or degrades. ``dtype`` float64
        with the float64 mode on computes in float64 (the module's note),
        float32 otherwise. ``mesh`` (default the operator's): the window
        kernels run sharded over its ``data`` axis, with the unsharded
        results, in float64 as in float32."""
        mesh = self.run_mesh(mesh)
        if not isinstance(query_set, (list, tuple)):
            query_set = [query_set]
        flags = flags_for_queries(self.grid, radius, query_set)
        from spatialflink_tpu_torch.driver import strict_driver

        # Attach (load any checkpoint) before touching the device: a run
        # resumed after a failover must not stage on the dead device path.
        drv = driver if driver is not None else strict_driver()
        drv.attach(self)
        evaluate = flags_d = None
        if drv.backend == "device":
            (flags_d,) = ship(flags, device=self.device).arrive()
            evaluate = self._window_evaluator(query_set, flags, radius,
                                              mesh, dtype)

        def dispatch(win):
            # assemble → ship → compute phase spans (see knn_query.run).
            with telemetry.span("assemble"):
                batch = self.point_batch(win.events)
                if counters.enabled:
                    cand = count_candidates(flags, batch.cell,
                                            len(win.events))
                    counters.record_window(len(win.events), cand,
                                           cand * len(query_set))
            with telemetry.span("ship"):
                xy_d, valid_d, cell_d = ship(
                    center_coords(self.grid, batch.xy, dtype), batch.valid,
                    batch.cell, device=self.device).arrive()
            with telemetry.span("compute"):
                return evaluate((xy_d, valid_d, cell_d, flags_d))

        def decode(win, keep, dist) -> RangeResult:
            with telemetry.span("fetch"):
                keep, dist = telemetry.fetch((keep, dist))
            idx = np.nonzero(keep)[0]
            return RangeResult(win.start, win.end,
                               [win.events[i] for i in idx], dist[idx],
                               len(win.events))

        def process(win) -> RangeResult:
            # The yield stays outside the window span.
            with telemetry.span("window.range", start=win.start,
                                events=len(win.events)):
                return decode(win, *dispatch(win))

        def pipeline_compute(win):
            """The split protocol's dispatch (``pipeline.py``): assemble,
            ship and launch without the wait; ``pipeline_fetch`` copies
            the result back up to ``fetch_lag`` windows later. The same
            kernels in the same order, so results equal ``process``'s."""
            with telemetry.span("window.range", start=win.start,
                                events=len(win.events)):
                return (win, *dispatch(win))

        def pipeline_fetch(staged) -> RangeResult:
            return decode(*staged)

        process.pipeline_compute = pipeline_compute
        process.pipeline_fetch = pipeline_fetch
        fallback = None
        if self.query_kind == "point":
            fallback = self._numpy_window_process(query_set, flags, radius,
                                                  dtype)
        drv.bind(self, process if drv.backend == "device" else None,
                 fallback=fallback)
        if self.conf.query_type == QueryType.CountBased:
            yield from drv.run_windows(count_window_batches(
                stream, self.conf.count_window_size,
                self.conf.count_window_size))
        else:
            yield from drv.run(stream)

    def _numpy_window_process(self, query_set, flags, radius,
                              dtype=np.float32):
        """The numpy twin of the point-kind device path: the driver's
        failover route. ``range_points_fused``'s arithmetic op by op on
        the same coordinates (``center_coords`` of ``dtype``), squares
        summed and rooted in their dtype as the plain version and the card
        do, so a backend switch mid-stream changes no result."""
        q_host = center_coords(self.grid, pack_query_points(query_set),
                               dtype)
        approx = self.conf.approximate_query

        def process(win) -> RangeResult:
            batch = self.point_batch(win.events)
            n = len(win.events)
            xy = center_coords(self.grid, batch.xy[:n], dtype)
            d = xy[:, None, :] - q_host[None, :, :]
            min_dist = np.sqrt(np.sum(d * d, axis=-1)).min(axis=1)
            f = flags[batch.cell[:n]]
            hit = (f == 1) if approx else ((f == 1) & (min_dist <= radius))
            keep = batch.valid[:n] & ((f == 2) | hit)
            idx = np.nonzero(keep)[0]
            return RangeResult(win.start, win.end,
                               [win.events[i] for i in idx], min_dist[idx],
                               n)

        return process

    def run_partitioned(self, stream: Iterable[Point],
                        query_set: Sequence[SpatialObject], radius: float,
                        mesh, dtype=np.float64, driver=None
                        ) -> Iterator[RangeResult]:
        """Grid-partitioned scale-out route (``parallel/halo.py``): window
        state lives sharded by contiguous flat-cell range and only
        boundary-cell query panes halo-exchange, with no per-window
        broadcast of the query set. Point query sets only (the per-pair
        layer math needs a cell a query lane).

        The partition plan is placed on the operator before the driver
        attaches, so a checkpoint resume restores the checkpointed plan
        (``checkpoint.py`` checks the shard count) and re-dispatches onto
        the same placement. Results decode as ``run``'s; distances come
        from the per-pair kernel on the raw (uncentred) coordinates cast
        to ``dtype``, as in the JAX package, and differ from the
        flag-table path only where an inactive pair ties the radius
        exactly (``ops/halo.py``). ``mesh``'s devices must be of the
        operator's device type."""
        if self.query_kind != "point":
            raise ValueError(
                "run_partitioned supports point query sets only "
                f"(operator query_kind is {self.query_kind!r})"
            )
        from spatialflink_tpu_torch.driver import strict_driver
        from spatialflink_tpu_torch.parallel.halo import sharded_range_halo
        from spatialflink_tpu_torch.parallel.partition import plan_partition

        mesh = self.check_mesh(require_mesh(mesh))
        if not isinstance(query_set, (list, tuple)):
            query_set = [query_set]
        n_shards = int(mesh.shape["data"])
        self.partition_plan = plan_partition(self.grid, n_shards, radius)
        drv = driver if driver is not None else strict_driver()
        drv.attach(self)  # may adopt a checkpointed plan (same shards)
        plan = self.partition_plan
        q_xy = pack_query_points(query_set)
        q_cell = self.grid.assign_cells_np(q_xy)
        q_valid = np.ones(len(query_set), bool)
        approx = self.conf.approximate_query

        def process(win) -> RangeResult:
            with telemetry.span("window.range_halo", start=win.start,
                                events=len(win.events)):
                batch = self.point_batch(win.events)
                n = len(win.events)
                ts = np.fromiter((e.timestamp for e in win.events), np.int64,
                                 count=n)
                keep, dist = sharded_range_halo(
                    mesh, plan, batch.xy[:n].astype(dtype),
                    batch.valid[:n], batch.cell[:n], q_xy.astype(dtype),
                    q_cell, q_valid, radius, approximate=approx, ts=ts)
                idx = np.nonzero(keep)[0]
                return RangeResult(win.start, win.end,
                                   [win.events[i] for i in idx], dist[idx],
                                   n)

        drv.bind(self, process)
        yield from drv.run(stream)

    def run_soa(self, chunks, query_set, radius: float, dtype=np.float64):
        """High-rate SoA path: chunks of {"ts", "x", "y", ...} arrays → per
        window ``(start, end, matched_arrays, dists)``, ``matched_arrays``
        the window's arrays sliced to its matches, with ``run``'s kernel
        selection (the pruned and compact paths included) and ``run``'s
        ``dtype`` rule."""
        if not isinstance(query_set, (list, tuple)):
            query_set = [query_set]
        flags = flags_for_queries(self.grid, radius, query_set)
        (flags_d,) = ship(flags, device=self.device).arrive()
        evaluate = self._window_evaluator(query_set, flags, radius,
                                          dtype=dtype)
        for win, xy, valid, cell, _ in soa_point_batches(self.grid, chunks,
                                                         self.conf, dtype):
            if counters.enabled:
                cand = count_candidates(flags, cell, win.count)
                counters.record_candidates(cand, cand * len(query_set))
            lanes = ship(xy, valid, cell, device=self.device).arrive()
            keep, dist = evaluate((*lanes, flags_d))
            # The whole padded lanes, as the JAX path fetches them.
            keep, dist = telemetry.fetch((keep, dist))
            idx = np.nonzero(keep[:win.count])[0]
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
        evaluated. Equal to ``run`` on in-order streams, with its ``dtype``
        rule; a non-zero allowed lateness is rejected (late refires would
        emit carried results twice)."""
        if self.conf.allowed_lateness_ms > 0:
            raise ValueError(
                "query_incremental does not support allowed_lateness "
                "(late-window refires would double-emit carried results); "
                "use run() for late-tolerant streams")
        flags = flags_for_queries(self.grid, radius, [query_point])
        (flags_d,) = ship(flags, device=self.device).arrive()
        q = self.device_q([[query_point.x, query_point.y]], dtype)
        slide_ms = self.conf.slide_step_ms
        approx = self.conf.approximate_query
        pk = jitted(range_points_fused)
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
                    center_coords(self.grid, batch.xy, dtype), batch.valid,
                    batch.cell, device=self.device).arrive()
                keep, dist = pk(xy_d, valid_d, cell_d, flags_d, q, radius,
                                approximate=approx)
                keep, dist = telemetry.fetch((keep, dist))
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
        super().__init__(conf, grid, device=device, mesh=mesh)

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

    def _window_evaluator(self, query_set, radius, mesh=None,
                          dtype=np.float32):
        """``eval(batch) -> (keep, dist)`` host arrays for a
        ``GeometryBatch``: the query set packed and shipped once, the
        per-object flags from the prefix planes of its flag table (shared
        by ``run`` and ``run_soa``); on a ``mesh`` the objects shard over
        its ``data`` axis. Both sides' vertices ship as ``center_coords``
        of ``dtype`` gives them."""
        flags = flags_for_queries(self.grid, radius, query_set)
        prefix = flag_prefix_planes(self.grid, flags)
        qverts, qev = self._query_arrays(query_set)
        qv = self.device_verts(qverts, dtype)
        (qe,) = ship(qev, device=self.device).arrive()
        gk = window_program(mesh, geometry_range_query_kernel, (0, 1, 2, 3),
                            7, **self._kernel_statics())

        def evaluate(batch: GeometryBatch):
            oflags = batch.any_cell_flagged(self.grid, flags, prefix=prefix)
            ev_d, valid_d, oflags_d = ship(
                batch.edge_valid, batch.valid, oflags,
                device=self.device).arrive()
            keep, dist = gk(self.device_verts(batch.verts, dtype), ev_d,
                            valid_d, oflags_d, qv, qe, radius)
            return telemetry.fetch((keep, dist))

        return evaluate

    def run(self, stream: Iterable, query_set, radius: float,
            dtype=np.float64, mesh=None) -> Iterator[RangeResult]:
        """One ``RangeResult`` per fired window of ``Polygon`` or
        ``LineString`` objects (WindowBased, RealTime micro-batches,
        CountBased). ``dtype`` float64 with the float64 mode on computes
        in float64 (the module's note), float32 otherwise. ``mesh``
        (default the operator's): the objects shard over its ``data``
        axis, with the unsharded results."""
        mesh = self.run_mesh(mesh)
        if not isinstance(query_set, (list, tuple)):
            query_set = [query_set]
        evaluate = self._window_evaluator(query_set, radius, mesh, dtype)
        for win in self.windows(stream):
            with telemetry.span("window.range_geometry", start=win.start,
                                events=len(win.events)):
                keep, dist = evaluate(self.geometry_batch(win.events,
                                                          mesh=mesh))
                idx = np.nonzero(keep)[0]
                out = RangeResult(win.start, win.end,
                                  [win.events[i] for i in idx], dist[idx],
                                  len(win.events))
            yield out

    def run_soa(self, chunks, query_set, radius: float, dtype=np.float64):
        """Ragged-SoA path: geometry chunks ``{"ts", "oid", "lengths",
        "verts"}`` (and optionally ``"edge_valid"``, multi-ring seams
        False; dense int32 oids) → per window ``(start, end,
        kept_indices, kept_oids, dists, window_count)``, through the same
        kernel as ``run`` with no per-object Python, and ``run``'s
        ``dtype`` rule."""
        if not isinstance(query_set, (list, tuple)):
            query_set = [query_set]
        evaluate = self._window_evaluator(query_set, radius, dtype=dtype)
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
