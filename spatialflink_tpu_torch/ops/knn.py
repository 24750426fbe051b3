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
(``ops/polygon.py:points_in_polygon``).
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import torch

from spatialflink_tpu_torch.ops.cells import gather_cell_flags
from spatialflink_tpu_torch.ops.distances import point_point_distance
from spatialflink_tpu_torch.ops.polygon import points_in_polygon
from spatialflink_tpu_torch.ops.polyline_kernel import polyline_min_dist

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
                             num_segments: int) -> KnnPaneDigest:
    """Masked distances → per-object (min distance, representative).

    The mask is ``valid & (dist <= radius) & (flags > 0)``; ``flags``
    None skips the cell-flag test (a single point query's radius test
    subsumes it). The representative is the lowest index achieving the
    object's min distance (the reference's PQ keeps the first-seen of
    equal distances, KNNQuery.java:221-268). Ids at or above
    ``num_segments`` are dropped, as the JAX segment reductions drop
    them.
    """
    mask = valid & (dist <= radius) & (oid < num_segments)
    if flags is not None:
        mask = mask & (flags > 0)
    o = oid[mask].to(torch.int64)
    d = dist[mask]
    idx = torch.nonzero(mask).flatten().to(torch.int32)
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


def knn_merge_digests(seg_min_stack, rep_stack, k: int) -> KnnResult:
    """(P, num_segments) stacked pane digests → window top-k.

    Per-object window minimum = min over panes; the representative is the
    lowest index among the panes achieving that minimum.
    """
    gmin = seg_min_stack.min(dim=0).values
    qual = seg_min_stack <= gmin[None, :]
    rep = torch.where(qual, rep_stack, I32_BIG).min(dim=0).values
    return _finish_topk(gmin, rep, k)


def knn_merge_digest_list(seg_mins: Sequence[torch.Tensor],
                          reps: Sequence[torch.Tensor], k: int) -> KnnResult:
    """Sequence-of-digests form of ``knn_merge_digests``."""
    return knn_merge_digests(torch.stack(list(seg_mins)),
                             torch.stack(list(reps)), k)


def _topk_from_point_dists(dist, valid, flags, oid, radius, k: int,
                           num_segments: int) -> KnnResult:
    """Masked per-point distances → the window's top-k objects."""
    d = _digest_from_point_dists(dist, valid, flags, oid, radius,
                                 num_segments)
    return _finish_topk(d.seg_min, d.rep, k)


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


def _boundary_dist(xy, query_verts, query_edge_valid) -> torch.Tensor:
    """(N,) min distance from each point to the one query boundary
    (``query_verts`` (V, 2), ``query_edge_valid`` (V-1,)): one dense B4
    launch at G = 1."""
    return polyline_min_dist(xy, query_verts[None],
                             query_edge_valid[None])[:, 0]


def knn_polygon_query_kernel(xy, valid, flags, oid, query_verts,
                             query_edge_valid, radius, k: int,
                             num_segments: int) -> KnnResult:
    """Point-stream kNN around a polygon query, JTS distance: 0 inside
    (knn/PointPolygonKNNQuery.java:67-88)."""
    edge_d = _boundary_dist(xy, query_verts, query_edge_valid)
    inside = points_in_polygon(xy, query_verts, query_edge_valid)
    dist = torch.where(inside, torch.zeros((), dtype=edge_d.dtype,
                                           device=edge_d.device), edge_d)
    return _topk_from_point_dists(dist, valid, flags, oid, radius, k,
                                  num_segments)


def knn_polyline_query_kernel(xy, valid, flags, oid, query_verts,
                              query_edge_valid, radius, k: int,
                              num_segments: int) -> KnnResult:
    """Point-stream kNN around an open linestring query: the min edge
    distance and no containment, since an open polyline encloses nothing
    (knn/PointLineStringKNNQuery.java)."""
    dist = _boundary_dist(xy, query_verts, query_edge_valid)
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
