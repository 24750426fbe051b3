"""Per-object kNN digests, their window merge and the top-k.

The reference computes kNN as a size-k heap per grid cell and a single
``windowAll`` merge that keeps each object's minimum distance
(KNNQuery.java:204-308). Here, as in the JAX package's ``ops/knn.py``:

  masked distance → segment-min over the interned objID → top-k.

A pane's digest is the per-object (min distance, lowest index at that
minimum); a sliding window's result merges the digests of its panes.
Absent objects carry the ``finfo(float32).max`` distance and the
``int32`` max representative.

The window kernels (``knn_kernel`` and its polygon and linestring
forms) take the whole window in one call. A polygon or linestring
query's point→edge distances go through B4
(``ops/polyline_kernel.py:polyline_min_dist``), dense over the one query
boundary; a point inside a polygon query is at 0
(``ops/polygon.py:points_in_polygon``). The pane digests
(``knn_pane_digest*``) are the carryable unit of the pane-carry paths,
merged per window by ``knn_merge_digests``; a batch of query points
takes ``knn_multi_query_kernel``. Geometry streams take
``knn_geometry_query_kernel`` (``ops/range.py:geometry_pair_distance``
at one query, B4 both ways) or, in approximate mode,
``knn_geometry_bbox_kernel``.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np
import torch

from spatialflink_tpu_torch.ops.cells import gather_cell_flags
from spatialflink_tpu_torch.ops.distances import (
    bbox_bbox_min_distance,
    point_point_distance,
)
from spatialflink_tpu_torch.ops.polygon import points_in_polygon
from spatialflink_tpu_torch.ops.polyline_kernel import polyline_min_dist
from spatialflink_tpu_torch.ops.range import (
    MAX_BLOCK_OBJECTS,
    PAIR_BLOCK,
    geometry_pair_distance,
)

F32_BIG = torch.finfo(torch.float32).max
I32_BIG = torch.iinfo(torch.int32).max


class KnnResult(NamedTuple):
    """Top-k objects by min distance. Padded slots have dist = f32 max,
    segment = -1, index = -1."""

    dist: torch.Tensor  # (k,) ascending min-distance per winning object
    segment: torch.Tensor  # (k,) interned objID (-1 = padding)
    index: torch.Tensor  # (k,) index of the winning point
    num_valid: torch.Tensor  # () number of distinct objects within radius


class KnnPaneDigest(NamedTuple):
    """Per-object minima for one slide pane: the carryable unit of the
    incremental sliding-window kNN."""

    seg_min: torch.Tensor  # (num_segments,) f32 min dist; F32_BIG absent
    rep: torch.Tensor  # (num_segments,) i32 lowest index at the min


def empty_digest(num_segments: int, device) -> KnnPaneDigest:
    """The digest of a pane with no point in radius."""
    return KnnPaneDigest(
        torch.full((num_segments,), F32_BIG, dtype=torch.float32,
                   device=device),
        torch.full((num_segments,), I32_BIG, dtype=torch.int32,
                   device=device),
    )


def _digest_from_point_dists(dist, valid, flags, oid, radius,
                             num_segments: int,
                             index_base=None) -> KnnPaneDigest:
    """Masked distances → per-object (min distance, representative).

    The mask is ``valid & (dist <= radius) & (flags > 0)``; ``flags``
    None skips the cell-flag test (a single point query's radius test
    subsumes it). The representative is the lowest index achieving the
    object's min distance (the reference's PQ keeps the first-seen of
    equal distances, KNNQuery.java:221-268), offset by ``index_base``
    when given. Ids at or above ``num_segments`` are dropped, as the JAX
    segment reductions drop them.
    """
    mask = valid & (dist <= radius) & (oid < num_segments)
    if flags is not None:
        mask = mask & (flags > 0)
    o = oid[mask].to(torch.int64)
    d = dist[mask]
    idx = torch.nonzero(mask).flatten().to(torch.int32)
    if index_base is not None:
        idx = idx + int(index_base)
    seg_min = torch.full((num_segments,), F32_BIG, dtype=dist.dtype,
                         device=dist.device)
    seg_min.scatter_reduce_(0, o, d, reduce="amin", include_self=True)
    win = d == seg_min[o]
    rep = torch.full((num_segments,), I32_BIG, dtype=torch.int32,
                     device=dist.device)
    rep.scatter_reduce_(0, o[win], idx[win], reduce="amin",
                        include_self=True)
    return KnnPaneDigest(seg_min, rep)


def check_k(k: int, num_segments: int) -> None:
    """The reference's ``lax.top_k`` raises when ``k`` exceeds the
    segments it selects from; so does every top-k of the port, rather
    than return fewer slots than ``k``."""
    if k > num_segments:
        raise ValueError(
            f"k argument to top_k must be no larger than size along axis; "
            f"got k={k} with num_segments={num_segments}")


def _finish_topk(seg_min, rep, k: int) -> KnnResult:
    """k smallest per-object minima, ascending. Equal distances keep the
    lowest segment id first, as ``lax.top_k`` does in the reference; a
    stable sort gives that order, ``torch.topk`` promises none.
    ``k`` above the segment count raises (``check_k``)."""
    check_k(k, seg_min.shape[0])
    vals, seg_ids = torch.sort(seg_min, stable=True)
    top_dist = vals[:k]
    seg_ids = seg_ids[:k]
    found = top_dist < F32_BIG
    seg_out = torch.where(found, seg_ids.to(torch.int32), -1)
    idx_out = torch.where(found, rep[seg_ids], -1)
    num_valid = torch.clamp((seg_min < F32_BIG).sum(), max=k)
    return KnnResult(top_dist, seg_out, idx_out, num_valid.to(torch.int32))


def knn_merge_digests(seg_min_stack, rep_stack, k: int,
                      bases=None) -> KnnResult:
    """(P, num_segments) stacked pane digests → window top-k.

    Per-object window minimum = min over panes; the representative is the
    lowest index among the panes achieving that minimum.

    ``bases``: optional (P,) window-local offsets added to each pane's
    local representatives (digests made with ``index_base`` 0), so the
    carried digests' indices never grow with the stream. Absent objects
    (the int32 max sentinel) stay at the sentinel.
    """
    if bases is not None:
        b = (bases if isinstance(bases, torch.Tensor)
             else torch.from_numpy(np.asarray(bases, np.int32)))
        b = b.to(device=rep_stack.device, dtype=torch.int32)
        rep_stack = torch.where(rep_stack == I32_BIG, I32_BIG,
                                rep_stack + b[:, None])
    gmin = seg_min_stack.min(dim=0).values
    qual = seg_min_stack <= gmin[None, :]
    rep = torch.where(qual, rep_stack, I32_BIG).min(dim=0).values
    return _finish_topk(gmin, rep, k)


def knn_merge_digest_list(seg_mins: Sequence[torch.Tensor],
                          reps: Sequence[torch.Tensor], bases,
                          k: int) -> KnnResult:
    """Sequence-of-digests form of ``knn_merge_digests`` (the JAX
    signature; ``bases`` None adds no offset)."""
    return knn_merge_digests(torch.stack(list(seg_mins)),
                             torch.stack(list(reps)), k, bases=bases)


def _topk_from_point_dists(dist, valid, flags, oid, radius, k: int,
                           num_segments: int) -> KnnResult:
    """Masked per-point distances → the window's top-k objects."""
    d = _digest_from_point_dists(dist, valid, flags, oid, radius,
                                 num_segments)
    return _finish_topk(d.seg_min, d.rep, k)


def knn_pane_digest(xy, valid, cell, flags_table, oid, query_xy, radius,
                    index_base, num_segments: int) -> KnnPaneDigest:
    """One slide pane → its carryable per-object minima (point query):
    the cell-flag gather, the distance and the segment-min. A sliding
    window's result is ``knn_merge_digests`` over its panes' digests."""
    dist = point_point_distance(xy, query_xy[None, :])
    return _digest_from_point_dists(
        dist, valid, gather_cell_flags(cell, flags_table), oid, radius,
        num_segments, index_base=index_base)


_SELECTIONS = ("auto", "blocked", "topk")


def _digest_from_point_dists_compact(dist, valid, flags, oid, radius,
                                     num_segments: int, index_base=None,
                                     cand: int = 4096,
                                     selection: str = "auto"
                                     ) -> KnnPaneDigest:
    """The JAX package's top-``cand``-compacted digest, whose contract is
    bit-identity with the scatter digest; ``cand`` and ``selection`` only
    choose a TPU or CPU selection strategy there. The card needs no
    compaction (the scatter digest reads the in-radius lanes once), so
    the port computes the scatter digest itself; ``selection`` is still
    checked, as in the JAX package."""
    if selection not in _SELECTIONS:
        raise ValueError(
            f"selection must be 'auto', 'blocked' or 'topk', "
            f"got {selection!r}")
    del cand
    return _digest_from_point_dists(dist, valid, flags, oid, radius,
                                    num_segments, index_base=index_base)


def knn_pane_digest_compact(xy, valid, cell, flags_table, oid, query_xy,
                            radius, index_base, num_segments: int,
                            cand: int = 4096,
                            selection: str = "auto") -> KnnPaneDigest:
    """``knn_pane_digest`` through ``_digest_from_point_dists_compact``.
    ``cell``/``flags_table`` None skip the flag gather: for one point
    query the radius test subsumes the grid pruning of in-grid points."""
    dist = point_point_distance(xy, query_xy[None, :])
    flags = (None if flags_table is None
             else gather_cell_flags(cell, flags_table))
    return _digest_from_point_dists_compact(
        dist, valid, flags, oid, radius, num_segments,
        index_base=index_base, cand=cand, selection=selection)


def _boundary_dist(xy, query_verts, query_edge_valid) -> torch.Tensor:
    """(N,) min distance from each point to the one query boundary
    (``query_verts`` (V, 2), ``query_edge_valid`` (V-1,)): one dense B4
    launch at G = 1."""
    return polyline_min_dist(xy, query_verts[None],
                             query_edge_valid[None])[:, 0]


def _geometry_query_dists(xy, query_verts, query_edge_valid,
                          query_polygonal: bool) -> torch.Tensor:
    """(N,) distance from each point to one query geometry: B4 at G = 1,
    0 inside a polygonal query."""
    edge_d = _boundary_dist(xy, query_verts, query_edge_valid)
    if query_polygonal:
        inside = points_in_polygon(xy, query_verts, query_edge_valid)
        return torch.where(inside, torch.zeros((), dtype=edge_d.dtype,
                                               device=edge_d.device), edge_d)
    return edge_d


def knn_pane_digest_geometry(xy, valid, cell, flags_table, oid, query_verts,
                             query_edge_valid, radius, index_base,
                             num_segments: int,
                             query_polygonal: bool) -> KnnPaneDigest:
    """Pane digest for a polygon (containment → 0) or open-polyline
    query."""
    dist = _geometry_query_dists(xy, query_verts, query_edge_valid,
                                 query_polygonal)
    return _digest_from_point_dists(
        dist, valid, gather_cell_flags(cell, flags_table), oid, radius,
        num_segments, index_base=index_base)


def knn_pane_digest_geometry_compact(xy, valid, cell, flags_table, oid,
                                     query_verts, query_edge_valid, radius,
                                     index_base, num_segments: int,
                                     query_polygonal: bool, cand: int = 4096,
                                     selection: str = "auto"
                                     ) -> KnnPaneDigest:
    """``knn_pane_digest_geometry`` through the compact digest's contract;
    ``cell``/``flags_table`` None skip the flag gather (the candidate
    cells cover every point within the radius of the geometry)."""
    dist = _geometry_query_dists(xy, query_verts, query_edge_valid,
                                 query_polygonal)
    flags = (None if flags_table is None
             else gather_cell_flags(cell, flags_table))
    return _digest_from_point_dists_compact(
        dist, valid, flags, oid, radius, num_segments,
        index_base=index_base, cand=cand, selection=selection)


def knn_kernel(xy, valid, flags, oid, query_xy, radius, k: int,
               num_segments: int) -> KnnResult:
    """Point-stream kNN around one query point: ``xy`` (N, 2), ``valid``
    (N,) bool, ``flags`` (N,) uint8, ``oid`` (N,) int32 interned ids in
    [0, num_segments), ``query_xy`` (2,) → ``KnnResult``
    (knn/PointPointKNNQuery.java:132-201 with the merge of
    KNNQuery.java:204-308)."""
    dist = point_point_distance(xy, query_xy[None, :])
    return _topk_from_point_dists(dist, valid, flags, oid, radius, k,
                                  num_segments)


def knn_polygon_query_kernel(xy, valid, flags, oid, query_verts,
                             query_edge_valid, radius, k: int,
                             num_segments: int) -> KnnResult:
    """Point-stream kNN around a polygon query, JTS distance: 0 inside
    (knn/PointPolygonKNNQuery.java:67-88)."""
    dist = _geometry_query_dists(xy, query_verts, query_edge_valid, True)
    return _topk_from_point_dists(dist, valid, flags, oid, radius, k,
                                  num_segments)


def knn_polyline_query_kernel(xy, valid, flags, oid, query_verts,
                              query_edge_valid, radius, k: int,
                              num_segments: int) -> KnnResult:
    """Point-stream kNN around an open linestring query: the min edge
    distance and no containment, since an open polyline encloses nothing
    (knn/PointLineStringKNNQuery.java)."""
    dist = _geometry_query_dists(xy, query_verts, query_edge_valid, False)
    return _topk_from_point_dists(dist, valid, flags, oid, radius, k,
                                  num_segments)


# Fused variants: the cell-flag gather and the kNN in one call, the
# signatures of the JAX package's ``knn_*_fused`` programs.


def knn_points_fused(xy, valid, cell, flags_table, oid, query_xy, radius,
                     k: int, num_segments: int) -> KnnResult:
    return knn_kernel(xy, valid, gather_cell_flags(cell, flags_table), oid,
                      query_xy, radius, k, num_segments)


def knn_polygon_fused(xy, valid, cell, flags_table, oid, query_verts,
                      query_edge_valid, radius, k: int,
                      num_segments: int) -> KnnResult:
    return knn_polygon_query_kernel(
        xy, valid, gather_cell_flags(cell, flags_table), oid, query_verts,
        query_edge_valid, radius, k, num_segments)


def knn_polyline_fused(xy, valid, cell, flags_table, oid, query_verts,
                       query_edge_valid, radius, k: int,
                       num_segments: int) -> KnnResult:
    return knn_polyline_query_kernel(
        xy, valid, gather_cell_flags(cell, flags_table), oid, query_verts,
        query_edge_valid, radius, k, num_segments)


def knn_multi_query_kernel(xy, valid, cell, flags_tables, oid, query_xy,
                           radius, k: int, num_segments: int,
                           query_block: int = 32) -> KnnResult:
    """kNN for a batch of query points in one call: ``query_xy`` (Q, 2),
    ``flags_tables`` (Q, num_cells + 1), one table a query (each prunes by
    its own candidate cells, PointPointKNNQuery.java:134-150). Returns a
    ``KnnResult`` whose fields carry a leading Q axis.

    Queries go in chunks of ``query_block`` (Q must divide into them, as
    in the JAX package): per chunk, the (q, N) distances, one scatter-min
    digest over ``q · num_segments + oid`` and a stable sort along each
    query's segments, so equal distances keep the lowest segment first
    as ``_finish_topk`` does."""
    q_total = query_xy.shape[0]
    if q_total % query_block != 0:
        raise ValueError("pad query batch to a multiple of query_block")
    check_k(k, num_segments)
    n = xy.shape[0]
    dev = xy.device
    ok = valid & (oid < num_segments)
    idx = torch.arange(n, dtype=torch.int32, device=dev)
    cell_l = cell.long()
    parts = []
    for q0 in range(0, q_total, query_block):
        qs = query_xy[q0:q0 + query_block]
        nq = qs.shape[0]
        dist = point_point_distance(xy[None, :, :], qs[:, None, :])
        flags = flags_tables[q0:q0 + query_block][:, cell_l]
        mask = ok[None, :] & (dist <= radius) & (flags > 0)
        qi, pi = torch.nonzero(mask, as_tuple=True)
        key = qi * num_segments + oid[pi].to(torch.int64)
        d = dist[qi, pi]
        seg_min = torch.full((nq * num_segments,), F32_BIG,
                             dtype=dist.dtype, device=dev)
        seg_min.scatter_reduce_(0, key, d, reduce="amin", include_self=True)
        win = d == seg_min[key]
        rep = torch.full((nq * num_segments,), I32_BIG, dtype=torch.int32,
                         device=dev)
        rep.scatter_reduce_(0, key[win], idx[pi[win]], reduce="amin",
                            include_self=True)
        seg_min = seg_min.view(nq, num_segments)
        rep = rep.view(nq, num_segments)
        vals, seg_ids = torch.sort(seg_min, dim=1, stable=True)
        top = vals[:, :k]
        seg_ids = seg_ids[:, :k]
        found = top < F32_BIG
        parts.append(KnnResult(
            top,
            torch.where(found, seg_ids.to(torch.int32), -1),
            torch.where(found, torch.gather(rep, 1, seg_ids), -1),
            torch.clamp((seg_min < F32_BIG).sum(dim=1), max=k)
            .to(torch.int32)))
    return KnnResult(*(torch.cat(f) for f in zip(*parts)))


def knn_geometry_query_kernel(obj_verts, obj_edge_valid, valid, flags, oid,
                              query_verts, query_edge_valid, radius, k: int,
                              num_segments: int, obj_polygonal: bool = False,
                              query_polygonal: bool = False) -> KnnResult:
    """Geometry-stream kNN: ``obj_verts`` (N, V, 2), ``obj_edge_valid``
    (N, V-1), ``valid`` (N,), ``flags`` (N,) per-object, ``oid`` (N,),
    one query boundary ``query_verts`` (Vq, 2) / ``query_edge_valid``
    (Vq-1,). The distance per object is ``ops/range.py:
    geometry_pair_distance`` at one query (0 on containment, the JTS
    ``getDistance`` of the reference's Polygon and LineString kNN loops,
    DistanceFunctions.java:15-54; crossing edges keep the reference's
    vertex distance, ROADMAP C2). A point query is a degenerate one-edge
    boundary. Objects go in the blocks ``geometry_range_query_kernel``
    takes: one B4 launch a direction at 131,072 objects of 16 vertices."""
    n, v = obj_verts.shape[:2]
    vq = query_verts.shape[0]
    qv, qe = query_verts[None], query_edge_valid[None]
    per = max(1, min(PAIR_BLOCK // max(v, vq), MAX_BLOCK_OBJECTS))
    parts = [
        geometry_pair_distance(obj_verts[i0:i0 + per],
                               obj_edge_valid[i0:i0 + per], qv, qe,
                               obj_polygonal, query_polygonal)[:, 0]
        for i0 in range(0, n, per)
    ]
    dist = torch.cat(parts) if parts else torch.empty(
        0, dtype=torch.float32, device=obj_verts.device)
    return _topk_from_point_dists(dist, valid, flags, oid, radius, k,
                                  num_segments)


def knn_geometry_bbox_kernel(obj_bbox, valid, flags, oid, query_bbox, radius,
                             k: int, num_segments: int) -> KnnResult:
    """Geometry-stream kNN in approximate mode: the distance per object is
    the min distance between its bbox and the query's
    (``bbox_bbox_min_distance``), the reference's approximateQuery
    branches (knn/LineStringLineStringKNNQuery.java:95-110,
    knn/PolygonPointKNNQuery.java:95). ``obj_bbox`` (N, 4) centred as the
    vertex lanes; ``query_bbox`` (4,), a point query's [x, y, x, y]."""
    dist = bbox_bbox_min_distance(obj_bbox, query_bbox[None, :])
    return _topk_from_point_dists(dist, valid, flags, oid, radius, k,
                                  num_segments)
