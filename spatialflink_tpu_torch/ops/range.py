"""Range-query kernels: the port of the JAX package's ``ops/range.py``.

Per window: gather each point's cell flag → guaranteed cells emit,
candidate cells emit when the exact distance is within the radius
(range/PointPointRangeQuery.java:152-186), computed for every lane and
masked, not compacted. ``approximate`` emits candidate cells with no
distance test (PointPolygonRangeQuery.java:76-80); distances are still
reported.

Every point→edge distance of the polygon and linestring paths goes
through B4 (``ops/polyline_kernel.py:polyline_min_dist``): one launch per
evaluation, dense over the query set or gathered over each point's
bbox candidates. Containment (``ops/polygon.py:points_in_polygons``) and
the min over geometries are plain PyTorch.

Every kernel here computes in its inputs' dtype: centred float32 lanes
by default, raw float64 ones in the float64 mode (``precision.py``),
where the radius is compared in float64, the no-distance sentinels are
``finfo(float64).max`` and B4 runs its float64 instantiation, as the JAX
package's kernels do under x64.

Geometry streams (polygons, linestrings) against a query set take
``geometry_range_query_kernel``: per (object, query) the vertex→boundary
distances both ways, each direction one dense B4 launch over the whole
window, and vertex containment (``geometry_pair_distance``).
"""

from __future__ import annotations

import numpy as np
import torch

from spatialflink_tpu_torch.ops.cells import gather_cell_flags
from spatialflink_tpu_torch.ops.distances import pairwise_distance, sqrt_rn
from spatialflink_tpu_torch.ops.polygon import points_in_polygons
from spatialflink_tpu_torch.ops.polyline_kernel import polyline_min_dist

#: Output entries (points × boundaries) one geometry-path B4 launch may
#: write: 512 MB of float32 distances, 1 GB in the float64 mode, and
#: every index of the launch below 2^31.
PAIR_BLOCK = 1 << 27

#: Objects one geometry-path block takes at most: B4's dense mode takes
#: up to 65,535 × 32 boundaries a launch (one grid row per 32).
MAX_BLOCK_OBJECTS = 1 << 20


def _radius(radius, like: torch.Tensor) -> torch.Tensor:
    """The radius as a scalar of ``like``'s dtype and device: the JAX
    kernels compare against a weakly typed radius, i.e. in the distances'
    dtype (rounded to float32 for float32 distances, float64 in the
    float64 mode)."""
    return torch.tensor(float(radius), dtype=like.dtype, device=like.device)


def _big(like: torch.Tensor) -> float:
    """``finfo(like.dtype).max``: the no-distance value of ``like``'s
    dtype."""
    return torch.finfo(like.dtype).max


def _emit_mask(valid, flags, min_dist, radius, approximate: bool):
    guaranteed = flags == 2
    candidate = flags == 1
    if approximate:
        hit = candidate
    else:
        hit = candidate & (min_dist <= _radius(radius, min_dist))
    return valid & (guaranteed | hit)


def range_query_kernel(xy, valid, flags, query_xy, radius,
                       approximate: bool = False):
    """Point stream vs point query set: ``xy`` (N, 2), ``valid`` (N,)
    bool, ``flags`` (N,) uint8, ``query_xy`` (Q, 2) → (keep (N,) bool,
    min_dist (N,)); the distance is exact for every lane."""
    min_dist = pairwise_distance(xy, query_xy).min(dim=1).values
    return _emit_mask(valid, flags, min_dist, radius, approximate), min_dist


def _chunked_min_over_geoms(xy, edge_d, verts, edge_valid, chunk: int):
    """min over polygons (columns of ``edge_d`` (N, P)) of the distance,
    0 for a point inside, with containment evaluated in blocks of
    ``chunk`` polygons."""
    p = edge_d.shape[1]
    out = None
    for g0 in range(0, p, chunk):
        g1 = min(p, g0 + chunk)
        inside = points_in_polygons(xy, verts[g0:g1], edge_valid[g0:g1])
        m = torch.where(inside, 0.0, edge_d[:, g0:g1]).min(dim=1).values
        out = m if out is None else torch.minimum(out, m)
    return out


def range_query_polygons_kernel(xy, valid, flags, poly_verts,
                                poly_edge_valid, radius,
                                approximate: bool = False,
                                poly_chunk: int = 32):
    """Point stream vs polygon query set, JTS semantics (0 inside):
    ``poly_verts`` (P, V, 2), ``poly_edge_valid`` (P, V-1). The edge
    distances to all P polygons come from one B4 launch; containment and
    the min run in ``poly_chunk``-polygon blocks."""
    edge_d = polyline_min_dist(xy, poly_verts, poly_edge_valid)
    min_dist = _chunked_min_over_geoms(xy, edge_d, poly_verts,
                                       poly_edge_valid, poly_chunk)
    return _emit_mask(valid, flags, min_dist, radius, approximate), min_dist


def range_query_polylines_kernel(xy, valid, flags, line_verts,
                                 line_edge_valid, radius,
                                 approximate: bool = False):
    """Point stream vs linestring query set: the min edge distance over
    all lines, from one B4 launch."""
    min_dist = polyline_min_dist(xy, line_verts,
                                 line_edge_valid).min(dim=1).values
    return _emit_mask(valid, flags, min_dist, radius, approximate), min_dist


def _vert_valid(edge_valid: torch.Tensor) -> torch.Tensor:
    """(..., V-1) edge mask → (..., V) vertex mask (a vertex is real if it
    bounds a real edge)."""
    ev = edge_valid.bool()
    z = torch.zeros(ev.shape[:-1] + (1,), dtype=torch.bool, device=ev.device)
    return torch.cat([ev, z], dim=-1) | torch.cat([z, ev], dim=-1)


def bbox_candidates(xy, lanes, poly_verts, poly_edge_valid, radius,
                    cand: int, point_chunk: int):
    """The bbox pass of the pruned kernel, in blocks of ``point_chunk``
    points: per point, the ``cand`` polygons nearest by bbox distance
    (ties to the lower index, as ``jax.lax.top_k``) as (N, cand) int32,
    and the candidate overflow: over flagged ``lanes``, the count of
    polygon bboxes within the radius beyond ``cand``.

    The bbox distance is the float32 ``hypot`` of the clamped offsets,
    its root taken in float64 and rounded to float32 (``sqrt_rn``: the
    same bits on the CPU and the card). The selection keys on (distance
    bits << 32 | index), which has no ties, so it is deterministic on
    every device. In float64 the distance is the float64 root of the
    float64 squares, and the selection is a stable sort of the distances,
    the same (distance, index) order: a float64's bits do not fit beside
    an index in 64."""
    n = xy.shape[0]
    p = poly_verts.shape[0]
    f64 = xy.dtype == torch.float64
    big = _big(xy)
    vmask = _vert_valid(poly_edge_valid)
    vx, vy = poly_verts[..., 0], poly_verts[..., 1]
    minx = torch.where(vmask, vx, big).min(dim=1).values
    maxx = torch.where(vmask, vx, -big).max(dim=1).values
    miny = torch.where(vmask, vy, big).min(dim=1).values
    maxy = torch.where(vmask, vy, -big).max(dim=1).values
    dead = ~vmask.any(dim=1)
    r = _radius(radius, xy)
    pidx = torch.arange(p, dtype=torch.int64, device=xy.device)
    idx = torch.empty((n, cand), dtype=torch.int32, device=xy.device)
    over = torch.zeros((), dtype=torch.int64, device=xy.device)
    for i0 in range(0, n, point_chunk):
        i1 = min(n, i0 + point_chunk)
        x, y = xy[i0:i1, 0:1], xy[i0:i1, 1:2]
        dx = torch.clamp(torch.maximum(minx[None, :] - x, x - maxx[None, :]),
                         min=0.0)
        dy = torch.clamp(torch.maximum(miny[None, :] - y, y - maxy[None, :]),
                         min=0.0)
        dx64, dy64 = dx.to(torch.float64), dy.to(torch.float64)
        hyp = sqrt_rn(dx64 * dx64 + dy64 * dy64, xy.dtype)
        bbox_d = torch.where(dead[None, :], big, hyp)
        if f64:
            sel = torch.sort(bbox_d, dim=1, stable=True).indices[:, :cand]
        else:
            key = (bbox_d.view(torch.int32).to(torch.int64) << 32) | pidx
            sel = torch.topk(key, cand, dim=1, largest=False,
                             sorted=True).indices
        idx[i0:i1] = sel.to(torch.int32)
        within = (bbox_d <= r).sum(dim=1)
        over += torch.where(lanes[i0:i1], torch.clamp(within - cand, min=0),
                            0).sum()
    return idx, over


def range_query_polygons_pruned_kernel(xy, valid, flags, poly_verts,
                                       poly_edge_valid, radius,
                                       cand: int = 8,
                                       point_chunk: int = 8192,
                                       approximate: bool = False):
    """Large-query-set point–polygon range via bbox-candidate pruning:
    a (N, P) bbox-distance pass, each point's ``cand`` nearest polygons
    by bbox, and exact distances for those only (one gathered B4 launch
    and a gathered containment). Returns (keep, min_dist, overflow).

    Exactness, as in the JAX package: the bbox distance bounds the exact
    one from below, so every polygon within the radius is a candidate
    unless more than ``cand`` bboxes are, which ``overflow`` counts. With
    ``overflow == 0`` the kept lanes are exact; a dropped lane reports
    the min over its candidates only."""
    p = poly_verts.shape[0]
    cand = min(cand, p)
    lanes = valid & (flags > 0)
    sel, over = bbox_candidates(xy, lanes, poly_verts, poly_edge_valid,
                                radius, cand, point_chunk)
    edge_d = polyline_min_dist(xy, poly_verts, poly_edge_valid, sel)
    inside = points_in_polygons(xy, poly_verts, poly_edge_valid, sel)
    min_d = torch.where(inside, 0.0, edge_d).min(dim=1).values
    keep = _emit_mask(valid, flags, min_d, radius, approximate)
    return keep, min_d, over


def range_query_polygons_pruned_compact_kernel(xy, valid, flags, poly_verts,
                                               poly_edge_valid, radius,
                                               budget: int, cand: int = 8,
                                               point_chunk: int = 8192):
    """The pruned kernel on the flagged lanes only: the first ``budget``
    lanes with ``valid & flags > 0`` (ascending, as ``jnp.nonzero(size=
    budget)``) are gathered, evaluated and scattered back through their
    own indices (no padding lane exists to clip). Lanes not evaluated get
    ``finfo.max`` of the coordinates' dtype. Returns (keep, min_dist,
    cand_overflow, budget_overflow), the last a host int (``nonzero`` has
    already waited for the device); both overflows 0 ⇒ the kept lanes are
    exact."""
    n = xy.shape[0]
    lanes = valid & (flags > 0)
    idx = torch.nonzero(lanes).flatten()
    n_cand = idx.numel()
    idx = idx[:budget]
    keep_c, dist_c, cand_over = range_query_polygons_pruned_kernel(
        xy[idx], torch.ones_like(idx, dtype=torch.bool), flags[idx],
        poly_verts, poly_edge_valid, radius, cand=cand,
        point_chunk=point_chunk,
    )
    keep = torch.zeros(n, dtype=torch.bool, device=xy.device)
    dist = torch.full((n,), _big(xy), dtype=xy.dtype, device=xy.device)
    keep[idx] = keep_c
    dist[idx] = dist_c
    return keep, dist, cand_over, max(n_cand - budget, 0)


def _vertex_min(d, ok, groups: int, per: int):
    """(groups·per, C) vertex distances → (groups, C) min over each
    group's ``per`` vertices, invalid vertices (``ok`` False, e.g. the
    padding of a short boundary) at ``finfo.max`` of the distances' dtype
    so they never win."""
    d = torch.where(ok.reshape(-1, 1), d, _big(d))
    return d.reshape(groups, per, -1).amin(dim=1)


def _vertex_in(xy, ok, verts, edge_valid, groups: int, per: int):
    """(groups, G) bool: any valid vertex of the group inside polygon g
    (``verts`` (G, V, 2)); invalid vertices never count."""
    inside = points_in_polygons(xy, verts, edge_valid) & ok.reshape(-1, 1)
    return inside.reshape(groups, per, -1).any(dim=1)


def geometry_pair_distance(averts, aev, bverts, bev,
                           a_polygonal: bool = False,
                           b_polygonal: bool = False) -> torch.Tensor:
    """(N, Q) distance between N packed boundaries ``averts`` (N, Va, 2) /
    ``aev`` (N, Va-1) and Q packed boundaries ``bverts`` (Q, Vb, 2) /
    ``bev`` (Q, Vb-1): the JAX package's ``geometry_pair_distance``
    (``ops/range.py:371-401``), batched over all pairs.

    The min over each side's valid vertices of the distance to the other
    side's boundary, both ways; 0 where a valid vertex of one lies inside
    the other and that other is polygonal (JTS gives 0 when geometries
    intersect). Each direction is one dense B4 launch: a→b takes the N·Va
    vertices as points against the Q boundaries, b→a the Q·Vb vertices
    against the N boundaries. Padding vertices (``_vert_valid`` False)
    reach no min and no ``any``.

    As in the reference, and unlike JTS, geometries whose edges cross
    with no vertex of either inside the other are not at 0: the X of the
    open linestrings (−1, 0)–(1, 0) and (0, −1)–(0, 1) is at 1.0, the plus
    of a 4×1 and a 1×4 rectangle at 1.5. The port's contract is the JAX
    package's result sets, so it keeps that value (ROADMAP Queue C, C2).
    """
    n, va = averts.shape[:2]
    q, vb = bverts.shape[:2]
    a_ok, b_ok = _vert_valid(aev), _vert_valid(bev)
    a_xy = averts.reshape(n * va, 2)
    b_xy = bverts.reshape(q * vb, 2)
    d = torch.minimum(
        _vertex_min(polyline_min_dist(a_xy, bverts, bev), a_ok, n, va),
        _vertex_min(polyline_min_dist(b_xy, averts, aev), b_ok, q, vb).T)
    if b_polygonal:
        d = torch.where(_vertex_in(a_xy, a_ok, bverts, bev, n, va), 0.0, d)
    if a_polygonal:
        d = torch.where(_vertex_in(b_xy, b_ok, averts, aev, q, vb).T, 0.0,
                        d)
    return d


def tile_lanes(averts, bverts, gids):
    """The two gathered B4 launches of ``geometry_pair_distance_tiles``:
    (a_xy (NB·B·Va, 2) every left vertex, sel_ab (NB·B·Va, C) its tile's
    candidates; b_xy (NB·C·Vb, 2) every candidate's vertices, sel_ba
    (NB·C·Vb, B) its tile's member rows)."""
    nb, c = gids.shape
    nbb, va = averts.shape[:2]
    b = nbb // nb
    vb = bverts.shape[1]
    a_xy = averts.reshape(nbb * va, 2)
    sel_ab = gids[:, None, :].expand(nb, b * va, c).reshape(nbb * va, c)
    b_xy = bverts[gids.long()].reshape(nb * c * vb, 2)
    members = torch.arange(nbb, dtype=torch.int32,
                           device=averts.device).view(nb, b)
    sel_ba = members[:, None, :].expand(nb, c * vb, b).reshape(nb * c * vb, b)
    return a_xy, sel_ab, b_xy, sel_ba


def geometry_pair_distance_tiles(averts, aev, bverts, bev, gids,
                                 a_polygonal: bool = False,
                                 b_polygonal: bool = False) -> torch.Tensor:
    """``geometry_pair_distance`` at each tile's candidates: (NB, B, C)
    distance between left boundary t·B + m (``averts`` (NB·B, Va, 2) /
    ``aev``, tile-major, B members a tile) and right boundary
    ``gids[t, c]`` (``bverts`` (M, Vb, 2) / ``bev``; ``gids`` (NB, C)
    int32, every entry in [0, M)): the pruned geometry join's step.

    Each direction is one gathered B4 launch. a→b: every left vertex
    against its tile's C candidate boundaries (``sel`` the tile's
    candidate list). b→a: every vertex of each tile's candidates against
    the tile's B member boundaries (``sel`` the member rows, all in
    range). Containment runs gathered with the same ``sel`` both ways.
    The vertex minima and ``_vert_valid`` masks are the dense form's, so
    crossing edges with no vertex inside keep the reference's value
    (ROADMAP C2)."""
    nb, c = gids.shape
    nbb, va = averts.shape[:2]
    b = nbb // nb
    vb = bverts.shape[1]
    a_ok = _vert_valid(aev)  # (NB·B, Va)
    cb_ok = _vert_valid(bev)[gids.long()]  # (NB, C, Vb)
    a_xy, sel_ab, b_xy, sel_ba = tile_lanes(averts, bverts, gids)
    d_ab = _vertex_min(polyline_min_dist(a_xy, bverts, bev, sel_ab), a_ok,
                       nbb, va).view(nb, b, c)
    d_ba = _vertex_min(polyline_min_dist(b_xy, averts, aev, sel_ba), cb_ok,
                       nb * c, vb).view(nb, c, b).transpose(1, 2)
    d = torch.minimum(d_ab, d_ba)
    if b_polygonal:
        a_in = points_in_polygons(a_xy, bverts, bev, sel_ab) \
            & a_ok.reshape(-1, 1)
        d = torch.where(a_in.view(nbb, va, c).any(dim=1).view(nb, b, c),
                        0.0, d)
    if a_polygonal:
        b_in = points_in_polygons(b_xy, averts, aev, sel_ba) \
            & cb_ok.reshape(-1, 1)
        d = torch.where(b_in.view(nb, c, vb, b).any(dim=2).transpose(1, 2),
                        0.0, d)
    return d


def geometry_range_query_kernel(obj_verts, obj_edge_valid, valid, flags,
                                query_verts, query_edge_valid, radius,
                                approximate: bool = False,
                                obj_polygonal: bool = False,
                                query_polygonal: bool = False):
    """Geometry stream (polygons or linestrings) vs a packed query set:
    ``obj_verts`` (N, V, 2), ``obj_edge_valid`` (N, V-1), ``valid`` (N,),
    ``flags`` (N,) per-object uint8 → (keep (N,), min over queries of
    ``geometry_pair_distance`` (N,)): the batched window loop of e.g.
    PolygonPolygonRangeQuery. A point query is a degenerate one-edge
    boundary. Objects go in blocks that keep each B4 output under
    ``PAIR_BLOCK`` entries: one block, so one launch a direction, at a
    window of 131,072 objects of 16 vertices against 32 queries."""
    n, v = obj_verts.shape[:2]
    q, vq = query_verts.shape[:2]
    per = max(1, min(PAIR_BLOCK // max(1, q * max(v, vq)),
                     MAX_BLOCK_OBJECTS))
    parts = [
        geometry_pair_distance(
            obj_verts[i0:i0 + per], obj_edge_valid[i0:i0 + per],
            query_verts, query_edge_valid, obj_polygonal,
            query_polygonal).amin(dim=1)
        for i0 in range(0, n, per)
    ]
    min_dist = torch.cat(parts) if parts else torch.empty(
        0, dtype=obj_verts.dtype, device=obj_verts.device)
    return _emit_mask(valid, flags, min_dist, radius, approximate), min_dist


# Fused variants: the cell-flag gather and the query in one call, the
# signatures of the JAX package's ``*_fused`` programs.


def range_points_fused(xy, valid, cell, flags_table, query_xy, radius,
                       approximate: bool = False):
    return range_query_kernel(xy, valid, gather_cell_flags(cell, flags_table),
                              query_xy, radius, approximate=approximate)


def range_polygons_fused(xy, valid, cell, flags_table, poly_verts,
                         poly_edge_valid, radius, approximate: bool = False):
    return range_query_polygons_kernel(
        xy, valid, gather_cell_flags(cell, flags_table), poly_verts,
        poly_edge_valid, radius, approximate=approximate)


def range_polylines_fused(xy, valid, cell, flags_table, line_verts,
                          line_edge_valid, radius, approximate: bool = False):
    return range_query_polylines_kernel(
        xy, valid, gather_cell_flags(cell, flags_table), line_verts,
        line_edge_valid, radius, approximate=approximate)


def range_polygons_pruned_fused(xy, valid, cell, flags_table, poly_verts,
                                poly_edge_valid, radius, cand: int = 8,
                                point_chunk: int = 8192,
                                approximate: bool = False):
    return range_query_polygons_pruned_kernel(
        xy, valid, gather_cell_flags(cell, flags_table), poly_verts,
        poly_edge_valid, radius, cand=cand, point_chunk=point_chunk,
        approximate=approximate)


def range_polygons_pruned_compact_fused(xy, valid, cell, flags_table,
                                        poly_verts, poly_edge_valid, radius,
                                        budget: int, cand: int = 8,
                                        point_chunk: int = 8192):
    return range_query_polygons_pruned_compact_kernel(
        xy, valid, gather_cell_flags(cell, flags_table), poly_verts,
        poly_edge_valid, radius, budget=budget, cand=cand,
        point_chunk=point_chunk)
