"""Continuous kNN: the point-stream classes ``PointPointKNNQuery``,
``PointPolygonKNNQuery`` and ``PointLineStringKNNQuery``, and the
geometry-stream classes ``Polygon{Point,Polygon,LineString}KNNQuery`` and
``LineString{Point,Polygon,LineString}KNNQuery``.

The reference's per-cell heap → ``windowAll`` merge
(knn/PointPointKNNQuery.java:132-201 + KNNQuery.java:204-308) becomes one
window kernel (``ops/knn.py``): masked distance → per-object minimum →
top-k. ``run(stream, query_obj, radius, k)`` yields one
``KnnWindowResult`` per fired window; a polygon or linestring query's
distances go through B4, and so do both directions of every
geometry-stream distance. ``run_soa`` is the high-rate path over SoA
chunks (ragged boundary chains for the geometry streams); ``run_multi``
answers a batch of query points per window. The pane-carry paths digest
each slide pane once and merge the window's digests: ``query_panes``
over objects, ``run_soa_panes`` over SoA chunks, and the headline
``run_wire_panes`` over wire panes, one B1 digest a pane
(``ops/wire_knn.py``). Window results equal the JAX package's
``operators/knn_query.py``.

Every entry point with a ``dtype`` honours it by the JAX package's rule
(``precision.py``): with ``dtype`` float64 and the float64 mode on, raw
float64 lanes (points, vertices, query boxes), float64 digests, pane
carries and distances (B4's float64 instantiation for a polygon or
linestring query and for both directions of a geometry stream);
otherwise centred float32, as before; a mesh run takes the same lanes.
``run_wire_panes`` takes no ``dtype``: its u16
wire planes dequantize to float32 in either mode, as in the JAX
package.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterable, Iterator, List, Sequence, Tuple

import numpy as np
import torch

from spatialflink_tpu_torch.models.batch import (
    GeometryBatch,
    flag_prefix_planes,
)
from spatialflink_tpu_torch.models.objects import (
    LineString,
    Point,
    Polygon,
    SpatialObject,
)
from spatialflink_tpu_torch.operators.base import (
    SpatialOperator,
    center_coords,
    check_oid_range,
    count_window_batches,
    device_point_args,
    flags_for_queries,
    jitted,
    pack_query_geometries,
    ship,
    soa_point_batches,
    window_program,
)
from spatialflink_tpu_torch.operators.join_query import _centered_bbox
from spatialflink_tpu_torch.operators.query_config import QueryType
from spatialflink_tpu_torch.ops import wire_codec as wc
from spatialflink_tpu_torch.ops.compaction import wire_pane_bucket
from spatialflink_tpu_torch.ops.counters import count_candidates, counters
from spatialflink_tpu_torch.ops.knn import (
    I32_BIG,
    KnnResult,
    absent_dist,
    check_k,
    empty_digest,
    knn_geometry_bbox_kernel,
    knn_geometry_query_kernel,
    knn_merge_digest_list,
    knn_multi_query_kernel,
    knn_pane_digest_compact,
    knn_pane_digest_geometry_compact,
    knn_points_fused,
    knn_polygon_fused,
    knn_polyline_fused,
)
from spatialflink_tpu_torch.precision import effective_f64
from spatialflink_tpu_torch.ops.wire_knn import (
    WIRE_DIGEST_LABELS,
    check_cand,
    check_interpret,
    select_wire_digest_step,
)
from spatialflink_tpu_torch.streams.soa import (
    RaggedSoaWindowAssembler,
    SoaWindowAssembler,
)
from spatialflink_tpu_torch.utils.padding import next_bucket, pad_to_bucket
from spatialflink_tpu_torch import overload
from spatialflink_tpu_torch import pipeline as pipeline_mod
from spatialflink_tpu_torch.telemetry import instrument_jit, telemetry


def _digest_dtype(dtype) -> torch.dtype:
    """The distance dtype of a run's digests for a request of ``dtype``:
    float64 in the float64 mode (``precision.effective_f64``), else
    float32, the dtype of the lanes ``center_coords`` gives."""
    return torch.float64 if effective_f64(dtype) else torch.float32


@dataclass
class KnnWindowResult:
    """Ordered top-k of one window (ascending distance, one entry per
    objID)."""

    start: int
    end: int
    neighbors: List[Tuple[str, float, SpatialObject]]  # (objID, dist, obj)
    window_count: int


@dataclass
class MultiKnnWindowResult:
    """One window's top-k for every query point of a batched query set."""

    start: int
    end: int
    results: List[KnnWindowResult]  # index-aligned with the query batch
    window_count: int


class _PointStreamKNNQuery(SpatialOperator):
    """Point stream; query = point, polygon or linestring."""

    query_kind = "point"

    def __init__(self, conf, grid, device="cuda", mesh=None):
        super().__init__(conf, grid, device=device, mesh=mesh)

    def _packed_query(self, query_obj):
        """Query vertices and edge mask for the distance evaluation.

        In approximate mode a polygon query becomes its closed bbox ring:
        0 inside the rectangle, else the min edge distance, the
        reference's getPointPolygonBBoxMinEuclideanDistance
        (knn/PointPolygonKNNQuery.java:132-146). A linestring query is
        not replaced: the reference's approximate branch calls the exact
        point-to-segments distance (DistanceFunctions.java:87-90), so
        approximate equals exact there (quirk kept, PARITY.md). A point
        query has no approximate branch. The cell flags always come from
        the original geometry."""
        if self.conf.approximate_query and self.query_kind == "polygon":
            x0, y0, x1, y1 = query_obj.bbox()
            ring = np.asarray(
                [[x0, y0], [x1, y0], [x1, y1], [x0, y1], [x0, y0]],
                np.float64)
            return ring, np.ones(4, bool)
        verts, ev = pack_query_geometries([query_obj])
        return verts[0], ev[0]

    def run(self, stream: Iterable[Point], query_obj: SpatialObject,
            radius: float, k: int, dtype=np.float64, mesh=None,
            driver=None) -> Iterator[KnnWindowResult]:
        """One ``KnnWindowResult`` per fired window (WindowBased, RealTime
        micro-batches, CountBased), through the dataflow driver
        (``driver.py``): pass ``driver=`` to opt into checkpoints, retry
        with backoff and, for a point query, failover to the numpy twin
        (polygon and linestring queries have none). Without one,
        ``strict_driver()`` gives the plain window loop, errors
        propagating. A window's segment count is the interned objIDs so
        far, bucketed to a power of two of at least 64; ``k`` above it
        raises ``ValueError`` in that window, as the reference's top-k
        does. ``dtype`` float64 with the float64 mode on computes in
        float64 (the module's note), float32 otherwise. ``mesh`` (default
        the operator's): each window's points shard over its ``data``
        axis, each shard digests its points and the digests merge before
        the one top-k, with the unsharded result."""
        mesh = self.run_mesh(mesh)
        flags = flags_for_queries(self.grid, radius, [query_obj])
        from spatialflink_tpu_torch.driver import strict_driver

        # Attach (load any checkpoint) before touching the device: a run
        # resumed after a failover must not stage on the dead device path.
        drv = driver if driver is not None else strict_driver()
        drv.attach(self)
        process = None
        if drv.backend == "device":
            (flags_d,) = ship(flags, device=self.device).arrive()
            if self.query_kind == "point":
                query = (self.device_q([query_obj.x, query_obj.y], dtype),)
                fused = knn_points_fused
            else:
                verts, ev = self._packed_query(query_obj)
                query = (self.device_verts(verts, dtype),
                         *ship(ev, device=self.device).arrive())
                fused = (knn_polygon_fused if self.query_kind == "polygon"
                         else knn_polyline_fused)
            kernel = jitted(fused)

            def compute(lanes, nseg):
                if mesh is None:
                    return kernel(*lanes, *query, radius, k, nseg)
                return window_program(
                    mesh, fused, (0, 1, 2, 4), 6 + len(query), topk=True,
                    k=k, num_segments=nseg)(*lanes, *query, radius)

            def process(win) -> KnnWindowResult:
                # Telemetry phases per window: assemble (host batch) →
                # ship → compute (kernel launches) → fetch (the one
                # wait); the yield stays outside the window span.
                with telemetry.span("window.knn", start=win.start,
                                    events=len(win.events)):
                    with telemetry.span("assemble"):
                        batch = self.point_batch(win.events)
                        if counters.enabled:
                            cand = count_candidates(flags, batch.cell,
                                                    len(win.events))
                            counters.record_window(len(win.events), cand,
                                                   cand)
                        nseg = next_bucket(
                            max(self.interner.num_segments, 1), minimum=64)
                    with telemetry.span("ship"):
                        xy_d, valid_d, cell_d, oid_d = ship(
                            center_coords(self.grid, batch.xy, dtype),
                            batch.valid, batch.cell, batch.oid,
                            device=self.device).arrive()
                    with telemetry.span("compute"):
                        res = compute((xy_d, valid_d, cell_d, flags_d,
                                       oid_d), nseg)
                    return self._decode(win, res)

        fallback = None
        if self.query_kind == "point":
            fallback = self._numpy_window_process(query_obj, flags, radius,
                                                  k, dtype)
        drv.bind(self, process, fallback=fallback)
        if self.conf.query_type == QueryType.CountBased:
            yield from drv.run_windows(count_window_batches(
                stream, self.conf.count_window_size,
                self.conf.count_window_size))
        else:
            yield from drv.run(stream)

    def _numpy_window_process(self, query_obj, flags, radius, k,
                              dtype=np.float32):
        """The numpy twin of the point-query device path: the driver's
        failover route. The same coordinates (``center_coords`` of
        ``dtype``), the same masked per-object minimum and representative
        (the lowest index at the minimum) and the same top-k order (a
        stable sort over the minima puts equal distances in ascending
        segment order), so a backend switch mid-stream changes no
        winner."""
        q_host = center_coords(
            self.grid, np.asarray([[query_obj.x, query_obj.y]],
                                  np.float64), dtype)[0]

        def process(win) -> KnnWindowResult:
            batch = self.point_batch(win.events)
            n = len(win.events)
            nseg = next_bucket(max(self.interner.num_segments, 1),
                               minimum=64)
            check_k(k, nseg)
            xy = center_coords(self.grid, batch.xy[:n], dtype)
            d = xy - q_host[None, :]
            dist = np.sqrt(np.sum(d * d, axis=-1))
            f = flags[batch.cell[:n]]
            mask = batch.valid[:n] & (f > 0) & (dist <= radius)
            big = np.finfo(dist.dtype).max
            masked = np.where(mask, dist, big).astype(dist.dtype)
            oid = np.asarray(batch.oid[:n], np.int64)
            seg_min = np.full(nseg, big, dist.dtype)
            np.minimum.at(seg_min, oid, masked)
            rep = np.full(nseg, np.iinfo(np.int32).max, np.int64)
            winner = mask & (masked == seg_min[oid])
            np.minimum.at(rep, oid[winner],
                          np.arange(n, dtype=np.int64)[winner])
            order = np.argsort(seg_min, kind="stable")
            nv = min(int((seg_min < big).sum()), k)
            neighbors = [
                (self.interner.lookup(int(s)), float(seg_min[s]),
                 win.events[int(rep[s])])
                for s in order[:nv]
            ]
            return KnnWindowResult(win.start, win.end, neighbors, n)

        return process

    def _decode(self, win, res: KnnResult) -> KnnWindowResult:
        # telemetry.fetch is the operator's own copy to the host, with
        # its bytes counted; it never adds one.
        with telemetry.span("fetch"):
            nv = int(telemetry.fetch(res.num_valid))
            segs, dists, idxs = telemetry.fetch(
                (res.segment[:nv], res.dist[:nv], res.index[:nv]))
        neighbors = [
            (self.interner.lookup(int(s)), float(d), win.events[int(i)])
            for s, d, i in zip(segs, dists, idxs)
        ]
        return KnnWindowResult(win.start, win.end, neighbors,
                               len(win.events))


    def query_panes(self, stream: Iterable[Point], query_obj: SpatialObject,
                    radius: float, k: int, dtype=np.float64,
                    flush_at_end: bool = True
                    ) -> Iterator[KnnWindowResult]:
        """Sliding-window kNN through a pane-digest carry: each
        ``slide``-wide pane is digested once into per-object (min
        distance, representative) arrays, and every window's result is a
        merge and top-k over its ``size/slide`` carried digests
        (range/PointPointRangeQuery.java:195-296's ListState carry applied
        to the kNN merge). Equal to ``run()`` for in-order streams; a
        non-zero ``allowed_lateness`` is rejected, since late refires
        would double-count carried panes.

        The digests skip the cell flags: for in-grid points the radius
        test subsumes the pruning of one query. Out-of-extent points
        (cell ``num_cells``, whose flag is 0) are masked out of ``valid``
        on the host. ``self._pane_carry`` (pane start → (nseg, seg_min,
        rep, events), or None for an empty pane) is operator-owned state,
        its representatives pane-local and offset per window in the
        merge; ``state.pane_carry_from_jax`` fills it from a JAX
        operator. ``flush_at_end`` False leaves the open windows in
        ``self.checkpoint_assembler``. ``dtype``: ``run``'s rule; in the
        float64 mode the digests, the carry and the distances are
        float64, and an empty pane merges as ``finfo(float64).max``."""
        conf = self.conf
        if conf.query_type == QueryType.CountBased:
            raise ValueError("query_panes requires time-based sliding windows")
        if conf.allowed_lateness_ms > 0:
            raise ValueError(
                "query_panes does not support allowed_lateness (late-window "
                "refires would double-count carried panes); use run()")
        size, slide = conf.window_size_ms, conf.slide_step_ms
        if conf.query_type in (QueryType.RealTime, QueryType.RealTimeNaive):
            size = slide = conf.realtime_batch_ms
        if size % slide != 0:
            raise ValueError("query_panes requires size % slide == 0")
        dev = self.device
        merge = jitted(knn_merge_digest_list)
        if self.query_kind == "point":
            q = self.device_q([query_obj.x, query_obj.y], dtype)
            digest_fn = jitted(knn_pane_digest_compact)

            def digest(xy_d, valid_d, oid_d, nseg):
                return digest_fn(xy_d, valid_d, None, None, oid_d, q,
                                 radius, 0, nseg)
        else:
            verts, ev = self._packed_query(query_obj)
            qv = self.device_verts(verts, dtype)
            (qe,) = ship(ev, device=dev).arrive()
            polygonal = self.query_kind == "polygon"
            digest_fn = jitted(knn_pane_digest_geometry_compact)

            def digest(xy_d, valid_d, oid_d, nseg):
                return digest_fn(xy_d, valid_d, None, None, oid_d, qv, qe,
                                 radius, 0, nseg, polygonal)

        if getattr(self, "_pane_carry", None) is None:
            self._pane_carry = {}
        panes: dict = self._pane_carry

        def grow(entry, nseg):
            # Re-pad when the interned-id bucket grows (log2 many times
            # in a stream, not per window).
            e_nseg, sm, rp, evs = entry
            pad = nseg - e_nseg
            return (nseg,
                    torch.cat([sm, torch.full((pad,),
                                              absent_dist(sm.dtype),
                                              dtype=sm.dtype,
                                              device=sm.device)]),
                    torch.cat([rp, torch.full((pad,), I32_BIG,
                                              dtype=rp.dtype,
                                              device=rp.device)]),
                    evs)

        for win in self._checkpointable_windows(stream, flush_at_end):
            starts = range(win.start, win.end, slide)
            for ps in starts:
                if ps in panes:
                    continue
                evs = [e for e in win.events if ps <= e.timestamp < ps + slide]
                if not evs:
                    panes[ps] = None
                    continue
                with telemetry.span("pane.digest", pane=ps, events=len(evs)):
                    batch = self.point_batch(evs)
                    # The pane-capacity bucket's occupancy.
                    telemetry.record_compaction(
                        "knn_pane_digest", batch.capacity, len(evs))
                    nseg = next_bucket(max(self.interner.num_segments, 1),
                                       minimum=64)
                    in_grid = batch.valid & (batch.cell < self.grid.num_cells)
                    xy_d, in_grid_d, oid_d = ship(
                        center_coords(self.grid, batch.xy, dtype), in_grid,
                        batch.oid, device=dev).arrive()
                    d = digest(xy_d, in_grid_d, oid_d, nseg)
                    panes[ps] = (nseg, d.seg_min, d.rep, evs)
            for ps in [p for p in panes if p < win.start]:
                del panes[ps]

            with telemetry.span("window.knn_panes", start=win.start,
                                events=len(win.events)):
                nseg = max(p[0] for p in panes.values() if p is not None)
                for ps in starts:
                    if panes[ps] is not None and panes[ps][0] < nseg:
                        panes[ps] = grow(panes[ps], nseg)
                live = [panes[ps] for ps in starts]
                emt = empty_digest(nseg, dev, _digest_dtype(dtype))
                bases, acc = [], 0
                for p in live:
                    bases.append(acc)
                    acc += 0 if p is None else len(p[3])
                res = merge(
                    [emt.seg_min if p is None else p[1] for p in live],
                    [emt.rep if p is None else p[2] for p in live], bases, k)
                spans = [(b, p[3]) for b, p in zip(bases, live)
                         if p is not None]
                nv = int(telemetry.fetch(res.num_valid))
                segs, dists, idxs = telemetry.fetch(
                    (res.segment[:nv], res.dist[:nv], res.index[:nv]))
                neighbors = []
                for s, d, gi in zip(segs, dists, idxs):
                    ev = None
                    for base, evs in spans:
                        if base <= gi < base + len(evs):
                            ev = evs[gi - base]
                            break
                    neighbors.append((self.interner.lookup(int(s)), float(d),
                                      ev))
                out = KnnWindowResult(win.start, win.end, neighbors,
                                      len(win.events))
            yield out


class PointPointKNNQuery(_PointStreamKNNQuery):
    """Point stream, point query: continuous kNN
    (knn/PointPointKNNQuery.java)."""

    query_kind = "point"

    def run_soa(self, chunks, query_point: Point, radius: float, k: int,
                num_segments: int, dtype=np.float64):
        """High-rate SoA path: chunks of ``{"ts", "x", "y", "oid"}`` arrays
        → per window ``(start, end, oids, dists, num_valid)``. ``oid``
        must already be dense ids in [0, num_segments); narrow integer
        types are widened to int32 on the host. ``dtype``: ``run``'s
        rule."""
        dev = self.device
        flags = flags_for_queries(self.grid, radius, [query_point])
        (flags_d,) = ship(flags, device=dev).arrive()
        q = self.device_q([query_point.x, query_point.y], dtype)
        kp = jitted(knn_points_fused)
        for win, xy, valid, cell, oid in soa_point_batches(
                self.grid, chunks, self.conf, dtype):
            with telemetry.span("window.knn_soa", start=win.start,
                                events=win.count):
                check_oid_range(oid[:win.count], num_segments)
                if counters.enabled:
                    cand = count_candidates(flags, cell, win.count)
                    counters.record_candidates(cand, cand)
                xy_d, valid_d, cell_d, oid_d = ship(xy, valid, cell, oid,
                                                    device=dev).arrive()
                res = kp(xy_d, valid_d, cell_d, flags_d, oid_d, q, radius, k,
                         num_segments)
                nv = int(telemetry.fetch(res.num_valid))
                segs, dists = telemetry.fetch(
                    (res.segment[:nv], res.dist[:nv]))
            yield (win.start, win.end, segs, dists, nv)

    def run_multi(self, stream: Iterable[Point],
                  query_points: Sequence[Point], radius: float, k: int,
                  dtype=np.float64, mesh=None
                  ) -> Iterator[MultiKnnWindowResult]:
        """Batched multi-query kNN: one ``knn_multi_query_kernel`` call a
        window answers the whole query set. Each query prunes by its own
        flag table, so each query's result equals ``run()`` with that
        query alone. The batch is padded to ``next_bucket(nq, minimum=8)``
        queries with zero flag tables (empty results, dropped) and taken
        in chunks of ``min(padded, 32)``.

        ``mesh=`` (default the operator's): points shard over ``data``; a
        2-D mesh also splits the query batch and its flag tables over
        ``query`` (``parallel/sharded.py:sharded_knn_multi``), with the
        unsharded results; the padded batch rounds up to a multiple of
        the query axis. ``dtype``: ``run``'s rule."""
        mesh = self.run_mesh(mesh)
        nq = len(query_points)
        if nq == 0:
            return
        tables = np.stack([flags_for_queries(self.grid, radius, [q])
                           for q in query_points])
        qb = next_bucket(nq, minimum=8)
        if mesh is not None:
            # The padded query count must divide by the query axis (which
            # need not be a power of two: round up to a multiple).
            qa = int(mesh.shape.get("query", 1))
            if qb % qa:
                qb = ((qb // qa) + 1) * qa
        block = min(qb, 32)
        tables = pad_to_bucket(tables, qb)
        qxy = pad_to_bucket(
            np.asarray([[q.x, q.y] for q in query_points], np.float64), qb)
        (tables_d,) = ship(tables, device=self.device).arrive()
        q_d = self.device_q(qxy, dtype)
        kernel = jitted(knn_multi_query_kernel)
        for win in self.windows(stream):
            batch = self.point_batch(win.events)
            nseg = next_bucket(max(self.interner.num_segments, 1),
                               minimum=64)
            xy_d, valid_d, cell_d, oid_d = ship(
                center_coords(self.grid, batch.xy, dtype), batch.valid,
                batch.cell,
                batch.oid, device=self.device).arrive()
            if mesh is not None:
                from spatialflink_tpu_torch.parallel.sharded import (
                    sharded_knn_multi,
                )

                res = sharded_knn_multi(mesh, xy_d, valid_d, cell_d,
                                        tables_d, oid_d, q_d, radius, k=k,
                                        num_segments=nseg)
            else:
                res = kernel(xy_d, valid_d, cell_d, tables_d, oid_d, q_d,
                             radius, k, nseg, query_block=block)
            segs, dists, idxs, nvs = telemetry.fetch(  # (Q, k) bulk fetches
                (res.segment, res.dist, res.index, res.num_valid))
            per_query = []
            for qi in range(nq):
                neighbors = [
                    (self.interner.lookup(int(segs[qi, i])),
                     float(dists[qi, i]), win.events[int(idxs[qi, i])])
                    for i in range(int(nvs[qi]))
                ]
                per_query.append(KnnWindowResult(win.start, win.end,
                                                 neighbors, len(win.events)))
            yield MultiKnnWindowResult(win.start, win.end, per_query,
                                       len(win.events))

    def run_soa_panes(self, chunks, query_point: Point, radius: float,
                      k: int, num_segments: int, dtype=np.float64,
                      flush_at_end: bool = True):
        """SoA pane-digest carry: ``run_soa``'s contract (per window
        ``(start, end, oids, dists, num_valid)``) with one digest a slide
        pane, the pane sliced from the window by its timestamps, and a
        merge of the window's digests. ``self._pane_carry_soa`` (pane
        start → (seg_min, rep), or None) is operator-owned state; the
        same in-order, no-lateness caveats as ``query_panes``. ``dtype``:
        ``run``'s rule; in the float64 mode the digests, the carry and the
        distances are float64."""
        conf = self.conf
        if conf.allowed_lateness_ms > 0:
            raise ValueError(
                "run_soa_panes does not support allowed_lateness; use run_soa")
        size, slide = conf.window_size_ms, conf.slide_step_ms
        if size % slide != 0:
            raise ValueError("run_soa_panes requires size % slide == 0")
        dev = self.device
        q = self.device_q([query_point.x, query_point.y], dtype)
        digest = jitted(knn_pane_digest_compact)
        merge = jitted(knn_merge_digest_list)
        no_bases = np.zeros(size // slide, np.int32)  # indices unused here
        if getattr(self, "_pane_carry_soa", None) is None:
            self._pane_carry_soa = {}
        panes: dict = self._pane_carry_soa
        emt = empty_digest(num_segments, dev, _digest_dtype(dtype))
        asm = SoaWindowAssembler(size, slide, ooo_ms=0)
        for win in self._checkpointable_soa_windows(asm, chunks,
                                                    flush_at_end):
            ts = np.asarray(win.arrays["ts"], np.int64)
            for ps in range(win.start, win.end, slide):
                if ps in panes:
                    continue
                lo = int(np.searchsorted(ts, ps, side="left"))
                hi = int(np.searchsorted(ts, ps + slide, side="left"))
                if hi <= lo:
                    panes[ps] = None
                    continue
                # Each pane is checked once, when it is first digested.
                check_oid_range(win.arrays["oid"][lo:hi], num_segments)
                xy64 = np.stack(
                    [np.asarray(win.arrays["x"][lo:hi], np.float64),
                     np.asarray(win.arrays["y"][lo:hi], np.float64)], axis=1)
                xy_p, valid_p, cell_p, oid_p = device_point_args(
                    self.grid, xy64, win.arrays["oid"][lo:hi], dtype)
                in_grid = valid_p & (cell_p < self.grid.num_cells)
                xy_d, in_grid_d, oid_d = ship(xy_p, in_grid, oid_p,
                                              device=dev).arrive()
                d = digest(xy_d, in_grid_d, None, None, oid_d, q, radius, 0,
                           num_segments)
                panes[ps] = (d.seg_min, d.rep)
            for ps in [p for p in panes if p < win.start]:
                del panes[ps]
            live = [panes[ps] for ps in range(win.start, win.end, slide)]
            res = merge(
                [emt.seg_min if p is None else p[0] for p in live],
                [emt.rep if p is None else p[1] for p in live], no_bases, k)
            nv = int(telemetry.fetch(res.num_valid))
            segs, dists = telemetry.fetch((res.segment[:nv], res.dist[:nv]))
            yield (win.start, win.end, segs, dists, nv)

    def restore_wire_pane_carry(self, carry: dict) -> None:
        """Resume ``run_wire_panes`` from a checkpoint carry (this
        operator's ``_wire_pane_carry``, or ``state.carry_from_jax`` of
        the JAX operator's). Consumed by the NEXT ``run_wire_panes`` call
        only: the carry is pane-INDEX based, so resuming it on an
        ordinary second call would silently time-shift every window."""
        self._wire_pane_carry = carry
        self._wire_pane_restored = True

    def run_wire_panes(
        self,
        slides,
        query_point: Point,
        radius: float,
        k: int,
        num_segments: int,
        wire_format,
        start_ms: int = 0,
        strategy: str = "auto",
        cand: int = 8192,
        interpret: bool = False,
        flush_at_end: bool = True,
    ):
        """Wire-plane pane-carry kNN: the headline program.

        ``slides``: iterable of (3, n_i) uint16 PLANE-MAJOR pane arrays
        in the 6 B/pt wire format (``streams/wire.py``), rows x_q, y_q
        and interned-int16-oid bits, one array per ``slide_step`` pane in
        event-time order. Pane i covers [start_ms + i·slide,
        start_ms + (i+1)·slide); every window OVERLAPPING a received
        NON-EMPTY pane fires, including the leading partial windows
        and, with ``flush_at_end``, the trailing partials. Windows whose
        every pane held zero events (gap windows) are suppressed. Yields
        (start, end, oids, dists, num_valid) per window, oids and dists
        as numpy arrays. Variable pane sizes are padded to
        ``wire_pane_bucket`` lanes and masked by ``n_valid``. ``k`` above
        ``num_segments`` raises ``ValueError`` before the first pane.

        ``strategy``: "auto", or the device's own digest step ("cuda" on
        a card, "torch" on the CPU). On a card the first pane is digested
        by the kernel and its plain version, and a mismatch raises. The
        chosen kind lands on ``self.last_wire_digest_kind``.

        ``cand`` and ``interpret`` stand where the JAX signature has them,
        so a positional call binds as there: ``cand`` must be a positive
        int and changes nothing (the kernel has no candidate buffer);
        ``interpret=True`` is accepted on the CPU, where it changes
        nothing, and raises ``ValueError`` on a card, which always runs
        the hand kernels.

        **Pipelined mode** (``SFT_PIPELINE`` / ``pipeline.install``):
        the same per-pane kernels run through the bounded
        ship/compute/fetch executor (pane N+1 copies on a side stream
        while window N computes, window N−1's fetch lags), optionally
        with the delta-bitpacked codec shrinking the shipped bytes.
        Results are bit-identical to the synchronous loop, and the
        checkpoint carry advances only with YIELDED windows. The codec
        kind lands on ``self.last_wire_codec_kind``. The executor owns
        the fetch batching there, so an overload ``batch_slides`` rung
        applies to the synchronous loop only.
        """
        conf = self.conf
        if conf.query_type == QueryType.CountBased:
            raise ValueError(
                "run_wire_panes requires time-based sliding windows"
            )
        check_k(k, num_segments)
        check_cand(cand)
        check_interpret(interpret, self.device.type)
        size, slide_ms = conf.window_size_ms, conf.slide_step_ms
        if conf.query_type in (QueryType.RealTime, QueryType.RealTimeNaive):
            size = slide_ms = conf.realtime_batch_ms
        if size % slide_ms != 0:
            raise ValueError("run_wire_panes requires size % slide == 0")
        ppw = size // slide_ms
        dev = self.device

        q = np.asarray([query_point.x, query_point.y], np.float32)
        scale, origin = wire_format.scale, wire_format.origin
        r32 = np.float32(radius)
        step = None
        merge = jitted(knn_merge_digest_list)
        self.last_wire_digest_kind = None
        self.last_wire_codec_kind = None
        empty = empty_digest(num_segments, dev)

        # Operator-owned, checkpointable state: the live digest ring, the
        # per-pane event counts and the next logical pane index. Consumed
        # only right after restore_wire_pane_carry.
        saved = None
        if getattr(self, "_wire_pane_restored", False):
            saved = getattr(self, "_wire_pane_carry", None)
        self._wire_pane_restored = False
        codec_state = None
        if saved is not None:
            pane0 = int(saved["next_pane"])
            digests = [(s.to(dev), r.to(dev)) for s, r in saved["digests"]]
            # Snapshots without the count ring: assume the carried panes
            # were non-empty (their windows fire).
            counts = [int(c) for c in saved.get(
                "counts", [1] * len(digests)
            )]
            codec_state = saved.get("codec")
        else:
            pane0 = 0
            # Seed the ring with ppw-1 empty digests so the LEADING
            # partial windows fire.
            digests = [empty] * (ppw - 1)
            counts = [0] * (ppw - 1)
        self._wire_pane_carry = {
            "next_pane": pane0, "digests": list(digests),
            "counts": list(counts),
        }

        def digest_pane(wire_d, n):
            nonlocal step
            if step is None:
                kind, fn = select_wire_digest_step(
                    wire_d, n, q, scale, origin, r32,
                    num_segments=num_segments, cand=cand,
                    interpret=interpret, strategy=strategy,
                )
                self.last_wire_digest_kind = kind
                # A per-run closure: wrapped here, not in jitted's cache.
                step = instrument_jit(fn, name=WIRE_DIGEST_LABELS[kind])
            return step(wire_d, n)

        def merge_window(pane_i):
            # Gap-window suppression: event count, NOT digest liveness,
            # decides; a window of events all out of radius still fires
            # (nv = 0).
            if not any(counts):
                return None
            res = merge(
                [s for s, _ in digests], [r for _, r in digests], None, k,
            )
            return (start_ms + (pane_i - ppw + 1) * slide_ms, res)

        def fetch_one(w_start, res):
            nv = int(telemetry.fetch(res.num_valid))
            segs, dists = telemetry.fetch((res.segment[:nv], res.dist[:nv]))
            return (w_start, w_start + size, segs, dists, nv)

        def carry_now(next_pane):
            return {
                "next_pane": next_pane, "digests": list(digests),
                "counts": list(counts),
            }

        pending: list = []

        def flush_pending():
            # One device→host copy for the whole batch: each window's
            # count, objIDs and distance bits packed into one int32 row on
            # the device, sliced by num_valid on the host. The values are
            # the per-window fetch's, bit for bit.
            if not pending:
                return
            host = telemetry.fetch(torch.stack([
                torch.cat([r.num_valid.reshape(1), r.segment,
                           r.dist.view(torch.int32)])
                for (_w, r), _c in pending]))
            kk = (host.shape[1] - 1) // 2
            for ((w_start, _r), carry), row in zip(pending, host):
                # Publish the ring state as of this window's pane BEFORE
                # yielding it: a checkpoint taken at any yield never
                # counts a still-pending window as emitted.
                self._wire_pane_carry = carry
                nv = int(row[0])
                yield (w_start, w_start + size, row[1:1 + nv].copy(),
                       row[1 + kk:1 + kk + nv].view(np.float32).copy(), nv)
            del pending[:]

        def emit(pane_i, carry):
            """This pane's window, if any. Under an overload
            ``batch_slides`` rung (``overload.py``) the results of N
            windows go to the host in one copy (``flush_pending``): on
            this path the device→host round trip a window is the overload
            cost. Width 1 keeps the fetch-a-window sequence exactly,
            carry included; while a batch is open the carry stays at the
            last YIELDED window's pane."""
            out = merge_window(pane_i)
            if out is None:
                if not pending:
                    self._wire_pane_carry = carry
                return
            width = overload.batch_slides()
            if width <= 1 and not pending:
                # Publish the ring state as of this pane BEFORE yielding
                # its window: a checkpoint at the yield counts it emitted.
                self._wire_pane_carry = carry
                yield fetch_one(*out)
                return
            pending.append((out, carry))
            if len(pending) >= max(width, 1):
                yield from flush_pending()

        def check_pane(wire_p):
            if (wire_p.ndim != 2 or wire_p.shape[0] != 3
                    or wire_p.dtype != np.uint16):
                raise ValueError(
                    "run_wire_panes expects (3, n) uint16 plane-major "
                    f"panes, got {wire_p.dtype} {wire_p.shape}"
                )
            check_oid_range(wire_p[2].view(np.int16), num_segments)

        def padded(wire_p):
            n = wire_p.shape[1]
            nb = wire_pane_bucket(n)
            if nb != n:
                wire_p = np.concatenate(
                    [wire_p, np.zeros((3, nb - n), np.uint16)], axis=1
                )
            return wire_p

        def push(d, n):
            digests.append((d.seg_min, d.rep))
            counts.append(n)
            del digests[:-ppw]
            del counts[:-ppw]

        def _pipelined(pol):
            """ship(N+1)/compute(N)/fetch(N−1) through the executor
            (``pipeline.py``), with the delta codec on the wire when the
            policy arms it. The checkpoint carry publishes per YIELDED
            window, so a kill mid-overlap replays the in-flight windows.
            Codec predictor state restarts at zero unless the restored
            carry holds a ``codec`` state (``state.carry_from_jax``);
            either way results cannot change, only compression."""
            use_codec = pol.codec == "delta"
            side = torch.cuda.Stream(dev) if dev.type == "cuda" else None
            encoder = wc.WirePaneEncoder(num_segments) if use_codec \
                else None
            dec = {"px": None, "py": None,
                   "step": jitted(wc.decode_wire_pane, "wire_pane_decode")}
            if use_codec:
                if codec_state is not None:
                    encoder.restore(codec_state)
                # ship copies the tables: the encoder updates its own in
                # place on every encode.
                dec["px"], dec["py"] = ship(
                    encoder.pred_x, encoder.pred_y, device=dev
                ).arrive()
            state = {"last_i": pane0 - 1,
                     "last_carry": self._wire_pane_carry}

            def items():
                for i, wire_p in enumerate(slides, start=pane0):
                    state["last_i"] = i
                    yield (i, np.asarray(wire_p))
                if flush_at_end and (state["last_i"] >= pane0
                                     or pane0 > 0):
                    for j in range(1, ppw):
                        yield (state["last_i"] + j, None)

            def ship_stage(item):
                _i, wire_p = item
                if wire_p is None:  # synthetic trailing flush pane
                    return None
                check_pane(wire_p)
                n = wire_p.shape[1]
                if use_codec:
                    enc = encoder.encode(wire_p)
                    nb = wire_pane_bucket(n)
                    wb = wc.wire_word_bucket(len(enc.words), nb)
                    # Charge the PADDED bucket: the bytes that ship (the
                    # ship site's account_h2d agrees).
                    telemetry.account_wire(enc.raw_bytes,
                                           4 * wb + wc.HEADER_BYTES)
                    words = wc.pad_words(enc.words, wb).view(np.int32)
                    return ("coded", ship(words, device=dev, stream=side),
                            n, nb, enc.bx, enc.by, enc.bo)
                return ("raw", ship(padded(wire_p), device=dev,
                                    stream=side), n)

            def compute_stage(item, staged):
                i, _ = item
                if staged is None:
                    push(empty, 0)
                else:
                    if staged[0] == "coded":
                        _, st, n, nb, bx, by, bo = staged
                        (words_d,) = st.arrive()
                        args = (words_d, n, bx, by, bo, dec["px"],
                                dec["py"])
                        if self.last_wire_codec_kind is None:
                            self.last_wire_codec_kind, _ = \
                                wc.select_wire_decoder(
                                    pol.codec_strategy,
                                    interpret=interpret, sample_args=args,
                                    n=nb, num_segments=num_segments,
                                )
                        pane_d, dec["px"], dec["py"] = dec["step"](
                            *args, n=nb, num_segments=num_segments,
                        )
                    else:
                        _, st, n = staged
                        (pane_d,) = st.arrive()
                    push(digest_pane(pane_d, n), n)
                    # Synthetic panes never advance the carry: entries
                    # keep the last REAL pane's ring.
                    state["last_carry"] = carry_now(i + 1)
                out = merge_window(i)
                if out is None:
                    return None
                return (out, state["last_carry"])

            def fetch_stage(works):
                # One fetch per drain batch: the full (k,) lanes, sliced
                # on the host by num_valid. Carries ride OUT with their
                # windows, unpublished: a multi-window drain must not
                # advance the carry past windows the consumer has not
                # received yet.
                fetched = telemetry.fetch([
                    (r.num_valid, r.segment, r.dist)
                    for (_w, r), _c in works])
                out = []
                for ((w_start, _r), carry), (nv_a, seg_a, dist_a) in zip(
                        works, fetched):
                    nv = int(nv_a)
                    out.append((carry, (w_start, w_start + size,
                                        seg_a[:nv], dist_a[:nv], nv)))
                return out

            ex = pipeline_mod.PipelinedExecutor(
                pol, ship=ship_stage, compute=compute_stage,
                fetch=fetch_stage, label="wire_panes",
            )
            for carry, out in ex.run(items()):
                self._wire_pane_carry = carry
                yield out
            # End-of-call invariant: every consumed REAL pane is in the
            # carry, emitted or not.
            self._wire_pane_carry = state["last_carry"]

        pol = pipeline_mod.policy()
        if pol is not None:
            yield from _pipelined(pol)
            return

        i = pane0 - 1
        last_carry = self._wire_pane_carry
        for i, wire_p in enumerate(slides, start=pane0):
            wire_p = np.asarray(wire_p)
            check_pane(wire_p)
            n = wire_p.shape[1]
            (wire_d,) = ship(padded(wire_p), device=dev).arrive()
            push(digest_pane(wire_d, n), n)
            last_carry = carry_now(i + 1)
            yield from emit(i, last_carry)
        # Flush iff ≥1 REAL pane exists in the logical stream: consumed
        # this call or before the checkpoint (pane0 > 0).
        if flush_at_end and (i >= pane0 or pane0 > 0):
            # Trailing partial windows: panes shift out, empties in.
            # Synthetic panes never advance the carry.
            for j in range(1, ppw):
                push(empty, 0)
                yield from emit(i + j, last_carry)
        yield from flush_pending()
        # End-of-call invariant: every consumed REAL pane is in the
        # carry, whether or not its window was emitted.
        self._wire_pane_carry = last_carry


class PointPolygonKNNQuery(_PointStreamKNNQuery):
    """knn/PointPolygonKNNQuery.java: JTS distance, 0 inside the query."""

    query_kind = "polygon"


class PointLineStringKNNQuery(_PointStreamKNNQuery):
    """knn/PointLineStringKNNQuery.java: the min edge distance."""

    query_kind = "linestring"


class _GeometryStreamKNNQuery(SpatialOperator):
    """Polygon or linestring stream; query point, polygon or linestring.

    The distance per object is ``ops/range.py:geometry_pair_distance`` at
    the one query (``ops/knn.py:knn_geometry_query_kernel``): the JTS
    ``getDistance`` of the reference's Polygon and LineString kNN loops
    (DistanceFunctions.java:15-54), 0 on containment, including a query
    point inside a polygonal object. A point query packs as a degenerate
    one-edge boundary. Approximate mode ranks by bbox↔bbox distance
    (``knn_geometry_bbox_kernel``). Objects take the highest flag over the
    cells their bbox overlaps."""

    stream_polygonal = True  # Polygon* classes; LineString* override

    def __init__(self, conf, grid, device="cuda", mesh=None):
        super().__init__(conf, grid, device=device, mesh=mesh)

    def _device_query_bbox(self, query_obj, dtype=np.float32):
        """The query's bbox as ``center_coords`` of ``dtype`` gives it
        (centred float32, or raw float64), on the device, for approximate
        mode
        (a point query's is [x, y, x, y], which reduces bbox↔bbox to the
        reference's point↔bbox cases, knn/PolygonPointKNNQuery.java:95).
        Unpadded: this box is a distance operand."""
        bb = np.asarray([query_obj.bbox()], np.float64)
        return ship(_centered_bbox(self.grid, bb, dtype, pad=False)[0],
                    device=self.device).arrive()[0]

    def _query_arrays(self, query_obj):
        """(qverts, qev, query_polygonal); a point query packs as a
        degenerate one-edge boundary."""
        if isinstance(query_obj, Point):
            qverts = np.asarray(
                [[query_obj.x, query_obj.y], [query_obj.x, query_obj.y]],
                np.float64)
            return qverts, np.asarray([True], bool), False
        verts, ev = pack_query_geometries([query_obj])
        return verts[0], ev[0], isinstance(query_obj, Polygon)

    def _window_evaluator(self, query_obj, radius, k, mesh=None,
                          dtype=np.float32):
        """``eval(batch, nseg) -> KnnResult`` for a ``GeometryBatch``: the
        query packed and shipped once, the per-object flags from the
        prefix planes of its flag table (shared by ``run`` and
        ``run_soa``); on a ``mesh`` the objects shard over its ``data``
        axis (``window_program``). Vertices and boxes ship as
        ``center_coords`` of ``dtype`` gives them."""
        dev = self.device
        flags = flags_for_queries(self.grid, radius, [query_obj])
        prefix = flag_prefix_planes(self.grid, flags)
        approx = self.conf.approximate_query
        if approx:
            qbb = self._device_query_bbox(query_obj, dtype)
        else:
            qverts, qev, query_polygonal = self._query_arrays(query_obj)
            qv = self.device_verts(qverts, dtype)
            (qe,) = ship(qev, device=dev).arrive()

        def evaluate(batch: GeometryBatch, nseg: int) -> KnnResult:
            oflags = batch.any_cell_flagged(self.grid, flags, prefix=prefix)
            if approx:
                bb_d, valid_d, oflags_d, oid_d = ship(
                    _centered_bbox(self.grid, batch.bbox, dtype, pad=False),
                    batch.valid, oflags, batch.oid, device=dev).arrive()
                return window_program(
                    mesh, knn_geometry_bbox_kernel, (0, 1, 2, 3), 6,
                    topk=True, k=k, num_segments=nseg,
                )(bb_d, valid_d, oflags_d, oid_d, qbb, radius)
            ev_d, valid_d, oflags_d, oid_d = ship(
                batch.edge_valid, batch.valid, oflags, batch.oid,
                device=dev).arrive()
            return window_program(
                mesh, knn_geometry_query_kernel, (0, 1, 2, 3, 4), 8,
                topk=True, k=k, num_segments=nseg,
                obj_polygonal=self.stream_polygonal,
                query_polygonal=query_polygonal,
            )(self.device_verts(batch.verts, dtype), ev_d, valid_d,
              oflags_d, oid_d, qv, qe, radius)

        return evaluate

    def run(self, stream: Iterable[Polygon | LineString],
            query_obj: SpatialObject, radius: float, k: int,
            dtype=np.float64, mesh=None) -> Iterator[KnnWindowResult]:
        """One ``KnnWindowResult`` per fired window of ``Polygon`` or
        ``LineString`` objects (WindowBased, RealTime micro-batches,
        CountBased). A window's segment count is the interned objIDs so
        far, bucketed to a power of two of at least 64; ``k`` above it
        raises ``ValueError`` in that window, as the reference's top-k
        does. ``mesh`` (default the operator's): the objects shard over
        its ``data`` axis, with the unsharded result. ``dtype``: the
        module's rule."""
        mesh = self.run_mesh(mesh)
        evaluate = self._window_evaluator(query_obj, radius, k, mesh, dtype)
        for win in self.windows(stream):
            batch = self.geometry_batch(win.events, mesh=mesh)
            nseg = next_bucket(max(self.interner.num_segments, 1),
                               minimum=64)
            res = evaluate(batch, nseg)
            nv = int(telemetry.fetch(res.num_valid))
            segs, dists, idxs = telemetry.fetch(
                (res.segment[:nv], res.dist[:nv], res.index[:nv]))
            neighbors = [
                (self.interner.lookup(int(s)), float(d), win.events[int(i)])
                for s, d, i in zip(segs, dists, idxs)
            ]
            yield KnnWindowResult(win.start, win.end, neighbors,
                                  len(win.events))

    def run_soa(self, chunks, query_obj: SpatialObject, radius: float, k: int,
                num_segments: int, dtype=np.float64):
        """Ragged-SoA path: geometry chunks ``{"ts", "oid", "lengths",
        "verts"}`` (and optionally ``"edge_valid"``, multi-ring seams
        False; dense int32 oids) → per window ``(start, end, oids, dists,
        num_valid)``, through the same kernel as ``run`` with no
        per-object Python, and ``run``'s ``dtype`` rule."""
        evaluate = self._window_evaluator(query_obj, radius, k, dtype=dtype)
        asm = RaggedSoaWindowAssembler(
            self.conf.window_size_ms, self.conf.slide_step_ms,
            ooo_ms=self.conf.allowed_lateness_ms)
        for win in asm.stream(chunks):
            check_oid_range(win.oid[:win.count], num_segments)
            res = evaluate(GeometryBatch.from_ragged(
                win.ts, win.oid, win.lengths, win.verts,
                edge_valid_flat=win.edge_valid, dtype=np.float64),
                num_segments)
            nv = int(telemetry.fetch(res.num_valid))
            segs, dists = telemetry.fetch((res.segment[:nv], res.dist[:nv]))
            yield (win.start, win.end, segs, dists, nv)


class PolygonPointKNNQuery(_GeometryStreamKNNQuery):
    """knn/PolygonPointKNNQuery.java."""


class PolygonPolygonKNNQuery(_GeometryStreamKNNQuery):
    """knn/PolygonPolygonKNNQuery.java."""


class PolygonLineStringKNNQuery(_GeometryStreamKNNQuery):
    """knn/PolygonLineStringKNNQuery.java."""


class LineStringPointKNNQuery(_GeometryStreamKNNQuery):
    """knn/LineStringPointKNNQuery.java."""

    stream_polygonal = False


class LineStringPolygonKNNQuery(_GeometryStreamKNNQuery):
    """knn/LineStringPolygonKNNQuery.java."""

    stream_polygonal = False


class LineStringLineStringKNNQuery(_GeometryStreamKNNQuery):
    """knn/LineStringLineStringKNNQuery.java."""

    stream_polygonal = False
