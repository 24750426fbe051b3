"""Spatial-join building blocks: result types, bucket planes, the naive
cross join.

The reference joins two streams by replicating each query object to its
neighbour cells, equi-joining on the cell id over a window and filtering
by distance (JoinQuery.java:73-137, PointPointJoinQuery.java:124-183).
Here both sides scatter into dense ``(grid_n, grid_n, cap)`` bucket planes
(``bucketize_planes``) and the grid-hash join kernel
(``ops/join_kernel.py``) tests each left bucket against its neighbour
buckets: no replication. ``cross_join_kernel`` is the RealTimeNaive
all-pairs path (PointPointJoinQuery.java:186-243), plain PyTorch as the
JAX package leaves it to XLA.

The geometry joins (a point or geometry stream against a polygon or
linestring stream) take the pruned kernels: the left side, sorted for
locality by the caller, goes in tiles; each tile's bbox is tested
against every right geometry's bbox grown by the radius, and the first
``cand`` overlapping geometries (ascending id) are the tile's
candidates; exact distances run for those only, and each left item keeps
its first ``pair_cap`` matches. Every point→edge distance goes through
B4's gathered mode, one launch a direction, with the tile's candidate
list as each point's ``sel``. The dense kernels are the oracles.

Every kernel computes in its inputs' dtype: centred float32 lanes and
boxes by default, raw float64 ones in the float64 mode (``precision.py``),
where boxes, radius compares and returned distances are float64 and B4
runs its float64 instantiation, as the JAX package's kernels do under
x64.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from spatialflink_tpu_torch.ops.distances import (
    bbox_bbox_min_distance,
    bbox_point_min_distance,
    point_point_distance,
)
from spatialflink_tpu_torch.ops.polygon import points_in_polygons
from spatialflink_tpu_torch.ops.polyline_kernel import polyline_min_dist
from spatialflink_tpu_torch.ops.range import (
    _radius,
    geometry_pair_distance,
    geometry_pair_distance_tiles,
)
from spatialflink_tpu_torch.ops.select import first_k_prefix_indices


class JoinResult(NamedTuple):
    """Dense join output: ``pair_mask`` (N, M) bool, ``right_index`` (N, M)
    int32 index into the right batch, ``dist`` (N, M), ``overflow`` ()
    int32 (0: the join is exact)."""

    pair_mask: torch.Tensor
    right_index: torch.Tensor
    dist: torch.Tensor
    overflow: torch.Tensor


class CompactJoinResult(NamedTuple):
    """Compacted join output. ``left_index``/``right_index``:
    (max_pairs,) int32 batch indices, −1 padding; ``dist``: (max_pairs,)
    in the lanes' dtype (float32, or float64 in the float64 mode), +inf
    padding; ``count``: () int32 true number of pairs
    (> max_pairs means truncation: retry with a larger budget);
    ``overflow``: () in-grid points dropped past a bucket's capacity
    (0: the join is exact)."""

    left_index: torch.Tensor
    right_index: torch.Tensor
    dist: torch.Tensor
    count: torch.Tensor
    overflow: torch.Tensor


def bucketize_planes(xy: torch.Tensor, valid: torch.Tensor,
                     cells: torch.Tensor, grid_n: int, cap: int):
    """Scatter a cell-assigned point batch into dense (grid_n, grid_n, cap)
    bucket planes: x, y, original index (−1 = empty slot), and the count
    of in-grid points dropped past ``cap`` (overflow).

    The rank within a cell comes from a stable sort, so slot order is the
    input order, as in the JAX package. Invalid and out-of-grid points
    (cell >= grid_n²) go to a discard slot and count as no overflow: they
    never join (the reference's key semantics)."""
    num_cells = grid_n * grid_n
    dev = xy.device
    n = xy.shape[0]
    cells = torch.where(valid, cells.to(torch.int64),
                        torch.full_like(cells, num_cells, dtype=torch.int64))
    sorted_cells, order = torch.sort(cells, stable=True)
    # Rank within cell = position − first position of that cell.
    first = torch.searchsorted(sorted_cells, sorted_cells, side="left")
    rank = torch.arange(n, device=dev) - first
    in_grid = sorted_cells < num_cells
    ok = in_grid & (rank < cap)
    overflow = (in_grid & (rank >= cap)).sum().to(torch.int32)
    slot = torch.where(ok, sorted_cells * cap + rank,
                       torch.full_like(rank, num_cells * cap))
    size = num_cells * cap + 1
    bx = torch.zeros(size, dtype=xy.dtype, device=dev)
    by = torch.zeros(size, dtype=xy.dtype, device=dev)
    bidx = torch.full((size,), -1, dtype=torch.int32, device=dev)
    # Only the discard slot receives duplicate writes, and it is cut off.
    bx[slot] = xy[order, 0]
    by[slot] = xy[order, 1]
    bidx[slot] = order.to(torch.int32)
    shape = (grid_n, grid_n, cap)
    return (bx[:-1].reshape(shape), by[:-1].reshape(shape),
            bidx[:-1].reshape(shape), overflow)


def cross_join_kernel(left_xy: torch.Tensor, left_valid: torch.Tensor,
                      right_xy: torch.Tensor, right_valid: torch.Tensor,
                      radius) -> JoinResult:
    """Naive all-pairs join (RealTimeNaive): the (N, M) distance matrix,
    masked by validity and ``dist <= radius``."""
    d = point_point_distance(left_xy[:, None, :], right_xy[None, :, :])
    pair = left_valid[:, None] & right_valid[None, :] & (d <= radius)
    m = right_xy.shape[0]
    right_idx = torch.arange(m, dtype=torch.int32,
                             device=d.device)[None, :].expand(d.shape)
    return JoinResult(pair, right_idx, d,
                      torch.zeros((), dtype=torch.int32, device=d.device))


class PrunedJoinPairs(NamedTuple):
    """Output of the pruned geometry joins: ``left_index``/``right_index``
    (max_pairs,) int32, −1 padding; ``dist`` (max_pairs,) in the lanes'
    dtype (float32, or float64 in the float64 mode), +inf padding;
    ``count`` () int32, every left item's matches before the
    ``pair_cap`` cut (> max_pairs: retry with a larger budget); and the
    two exactness counters of the retry contract, ``cand_overflow`` (a
    tile had more than ``cand`` bbox-overlapping geometries: grow
    ``cand``) and ``pair_overflow`` (a left item matched more than
    ``pair_cap`` geometries: grow ``pair_cap``). Exact iff both are 0."""

    left_index: torch.Tensor
    right_index: torch.Tensor
    dist: torch.Tensor
    count: torch.Tensor
    cand_overflow: torch.Tensor
    pair_overflow: torch.Tensor


def point_geometry_join_kernel(pxy, pvalid, gverts, gev, gvalid, radius,
                               polygonal: bool = True):
    """Dense point batch ⋈ geometry batch: (mask, dist), both (M, N), for
    every (geometry, point) pair; JTS semantics, 0 inside a polygonal
    geometry. The edge distances are one dense B4 launch. The oracle of
    the pruned kernel: the grid prune of the reference is a shuffle
    optimisation, and the distance filter decides membership."""
    d = polyline_min_dist(pxy, gverts, gev)
    if polygonal:
        d = torch.where(points_in_polygons(pxy, gverts, gev), 0.0, d)
    d = d.T
    mask = (d <= _radius(radius, d)) & pvalid[None, :] & gvalid[:, None]
    return mask, d


def geometry_geometry_join_kernel(averts, aev, avalid, bverts, bev, bvalid,
                                  radius, a_polygonal: bool = True,
                                  b_polygonal: bool = True):
    """Dense geometry ⋈ geometry: (mask, dist), both (L, R), with
    ``ops/range.py:geometry_pair_distance`` (0 on containment; crossing
    edges keep the reference's vertex distance, ROADMAP C2)."""
    d = geometry_pair_distance(averts, aev, bverts, bev, a_polygonal,
                               b_polygonal)
    mask = (d <= _radius(radius, d)) & avalid[:, None] & bvalid[None, :]
    return mask, d


def _block_candidates(block_bbox, gbbox, gvalid, radius, cand: int):
    """Tile-level bbox pruning and the tile's candidate list.

    ``block_bbox`` (NB, 4) minx, miny, maxx, maxy per tile (±finfo.max
    when the tile is empty), ``gbbox`` (M, 4) per geometry. A geometry is
    a candidate of a tile iff the boxes overlap once the geometry's is
    grown by ``radius``. Returns (gids (NB, cand) int32, the first
    ``cand`` candidates ascending, in-range ids past the count; cvalid
    (NB, cand) bool; overflow () int32, the candidates dropped beyond
    ``cand``: the selection is exact iff it is 0)."""
    r = _radius(radius, gbbox)
    gx0, gy0 = gbbox[:, 0] - r, gbbox[:, 1] - r
    gx1, gy1 = gbbox[:, 2] + r, gbbox[:, 3] + r
    ov = ((block_bbox[:, 0:1] <= gx1[None, :])
          & (block_bbox[:, 2:3] >= gx0[None, :])
          & (block_bbox[:, 1:2] <= gy1[None, :])
          & (block_bbox[:, 3:4] >= gy0[None, :])
          & gvalid[None, :])
    gids, ncand, overflow = first_k_prefix_indices(ov, cand)
    slots = torch.arange(cand, dtype=torch.int32, device=gids.device)
    cvalid = slots[None, :] < torch.clamp(ncand, max=cand)[:, None]
    return gids, cvalid, overflow


def _masked_block_bbox(x, y, valid):
    """(NB, B) coordinates and validity → (NB, 4) bbox over valid lanes."""
    big = torch.finfo(x.dtype).max
    return torch.stack([
        torch.where(valid, x, big).amin(dim=1),
        torch.where(valid, y, big).amin(dim=1),
        torch.where(valid, x, -big).amax(dim=1),
        torch.where(valid, y, -big).amax(dim=1),
    ], dim=1)


def _compact_pairs(mask, dmat, borig, gids, pair_cap: int, max_pairs: int):
    """(NB, cand, B) mask and distances → flat pairs, through each left
    item's first ``pair_cap`` matches (ascending candidate slot).

    The order is the JAX package's: tile-major, then member, then slot.
    The first ``max_pairs`` live slots in that order are written through
    their prefix-sum positions (no ``nonzero``, so nothing waits for the
    device). Returns (left (max_pairs,) int32 from ``borig``, −1 padding;
    right int32 from ``gids``, −1 padding; dist in ``dmat``'s dtype, +inf
    padding;
    count () int32, every item's matches before the ``pair_cap`` cut;
    pair_overflow () int32, the matches beyond it)."""
    nb, _, b = mask.shape
    dev = mask.device
    mask_t = mask.transpose(1, 2)  # (NB, B, cand)
    dmat_t = dmat.transpose(1, 2)
    csel, per_item, pair_overflow = first_k_prefix_indices(mask_t, pair_cap)
    csel = csel.long()
    gsel = gids[:, None, :].expand(mask_t.shape).gather(-1, csel)
    dsel = dmat_t.gather(-1, csel)
    slots = torch.arange(pair_cap, dtype=torch.int32, device=dev)
    svalid = slots < torch.clamp(per_item, max=pair_cap)[..., None]
    flat = svalid.reshape(-1)
    count = per_item.sum(dtype=torch.int32)
    pos = torch.cumsum(flat, dim=0) - 1
    keep = flat & (pos < max_pairs)
    hit = torch.full((max_pairs + 1,), -1, dtype=torch.int64, device=dev)
    # Only the dump slot max_pairs takes duplicate writes, and it is cut.
    hit[torch.where(keep, pos, max_pairs)] = torch.arange(
        flat.numel(), device=dev)
    hit = hit[:max_pairs]
    found = hit >= 0
    h = torch.clamp(hit, min=0)
    left = torch.where(found, borig.reshape(-1)[h // pair_cap], -1)
    right = torch.where(found, gsel.reshape(-1)[h], -1)
    dist = torch.where(found, dsel.reshape(-1)[h], float("inf"))
    return (left.to(torch.int32), right.to(torch.int32), dist, count,
            pair_overflow)


def _tiles(n: int, block: int, device):
    """(tile count, padding, borig (NB, block) int32: each member's input
    position, −1 on padding)."""
    nb = -(-n // block)
    pad = nb * block - n
    borig = torch.full((nb * block,), -1, dtype=torch.int32, device=device)
    borig[:n] = torch.arange(n, dtype=torch.int32, device=device)
    return nb, pad, borig.view(nb, block)


def point_tiles(pxy, pvalid, gbbox, gvalid, radius, block: int, cand: int):
    """The point kernel's prune: points (in the caller's locality order)
    padded into tiles of ``block``, each tile's bbox over its valid
    points, and its first ``cand`` candidates. Returns (padded points
    (NB·block, 2), validity (NB, block), borig (NB, block), gids, cvalid,
    cand_overflow)."""
    n = pxy.shape[0]
    nb, pad, borig = _tiles(n, block, pxy.device)
    sx = torch.nn.functional.pad(pxy, (0, 0, 0, pad))
    bvalid = torch.nn.functional.pad(pvalid, (0, pad)).view(nb, block)
    bx = sx.view(nb, block, 2)
    bbox = _masked_block_bbox(bx[:, :, 0], bx[:, :, 1], bvalid)
    gids, cvalid, overflow = _block_candidates(bbox, gbbox, gvalid, radius,
                                               cand)
    return sx, bvalid, borig, gids, cvalid, overflow


def geometry_tiles(abbox, avalid, bbbox, bvalid, radius, block: int,
                   cand: int):
    """The geometry kernel's prune: left boxes (in the caller's locality
    order) padded into tiles of ``block``, each tile's bbox the union of
    its valid members', and its first ``cand`` candidates. Returns
    (member boxes (NB, block, 4), validity (NB, block), borig (NB,
    block), gids, cvalid, cand_overflow)."""
    la = abbox.shape[0]
    nb, pad, borig = _tiles(la, block, abbox.device)
    t_bbox = torch.nn.functional.pad(abbox, (0, 0, 0, pad)).view(nb, block, 4)
    bval = torch.nn.functional.pad(avalid, (0, pad)).view(nb, block)
    big = torch.finfo(t_bbox.dtype).max
    tile_bbox = torch.stack([
        torch.where(bval, t_bbox[:, :, 0], big).amin(dim=1),
        torch.where(bval, t_bbox[:, :, 1], big).amin(dim=1),
        torch.where(bval, t_bbox[:, :, 2], -big).amax(dim=1),
        torch.where(bval, t_bbox[:, :, 3], -big).amax(dim=1),
    ], dim=1)
    gids, cvalid, overflow = _block_candidates(tile_bbox, bbbox, bvalid,
                                               radius, cand)
    return t_bbox, bval, borig, gids, cvalid, overflow


class PrunedJoinMasks(NamedTuple):
    """A pruned join before its compaction: ``mask`` and ``dist`` (NB,
    block, cand), item-major (each left item's row over its tile's
    candidate slots), ``borig`` (NB, block), ``gids`` (NB, cand) and
    ``cand_overflow`` (). A retry that grows only ``pair_cap`` or
    ``max_pairs`` recompacts it (``compact_pruned``); the distances do
    not depend on either."""

    mask: torch.Tensor
    dist: torch.Tensor
    borig: torch.Tensor
    gids: torch.Tensor
    cand_overflow: torch.Tensor


def compact_pruned(m: PrunedJoinMasks, pair_cap: int,
                   max_pairs: int) -> PrunedJoinPairs:
    """``_compact_pairs`` of a ``PrunedJoinMasks``: each left item's first
    ``pair_cap`` matches (at most the candidate width), the first
    ``max_pairs`` pairs in order."""
    pair_cap = min(pair_cap, m.gids.shape[1])
    left, right, dist, count, pair_over = _compact_pairs(
        m.mask.transpose(1, 2), m.dist.transpose(1, 2), m.borig, m.gids,
        pair_cap, max_pairs)
    return PrunedJoinPairs(left, right, dist, count, m.cand_overflow,
                           pair_over)


def point_geometry_join_masks(pxy, pvalid, gverts, gev, gvalid, gbbox,
                              radius, polygonal: bool, block: int,
                              cand: int, approx: bool = False
                              ) -> PrunedJoinMasks:
    """The distance step of ``point_geometry_join_pruned_kernel``: the
    tiles, their candidates and each (point, candidate) distance and
    match."""
    cand = min(cand, gbbox.shape[0])
    sx, bvalid, borig, gids, cvalid, overflow = point_tiles(
        pxy, pvalid, gbbox, gvalid, radius, block, cand)
    nb = bvalid.shape[0]
    if approx:
        cgb = gbbox[gids.long()]  # (NB, cand, 4)
        dmat = bbox_point_min_distance(sx.view(nb, block, 1, 2),
                                       cgb[:, None, :, :])
    else:
        sel = gids.repeat_interleave(block, dim=0)  # (NB·block, cand)
        d = polyline_min_dist(sx, gverts, gev, sel)
        if polygonal:
            d = torch.where(points_in_polygons(sx, gverts, gev, sel), 0.0, d)
        dmat = d.view(nb, block, cand)
    mask = ((dmat <= _radius(radius, dmat)) & bvalid[:, :, None]
            & cvalid[:, None, :])
    return PrunedJoinMasks(mask, dmat, borig, gids, overflow)


def point_geometry_join_pruned_kernel(pxy, pvalid, gverts, gev, gvalid,
                                      gbbox, radius, polygonal: bool,
                                      block: int, cand: int, max_pairs: int,
                                      pair_cap: int = 8,
                                      approx: bool = False
                                      ) -> PrunedJoinPairs:
    """Grid-pruned point ⋈ geometry join (the device form of the
    reference's gridIDsSet replication, join/JoinQuery.java:73-137).

    The caller sorts the points for locality (by cell, on the host);
    ``left_index`` refers to input positions. Points go in tiles of
    ``block``; each tile's bbox is tested against every geometry's bbox
    grown by the radius, and its first ``cand`` candidates are kept.
    Exact mode: one gathered B4 launch, each point against its tile's
    candidate list (``sel``), and 0 inside a polygonal candidate
    (gathered containment). Approximate mode: the point → candidate-bbox
    distance (``bbox_point_min_distance``; ``gverts``/``gev`` unused and
    may be None). Exact iff both overflow counters are 0; the pair set is
    then the dense kernel's."""
    return compact_pruned(point_geometry_join_masks(
        pxy, pvalid, gverts, gev, gvalid, gbbox, radius, polygonal, block,
        cand, approx), pair_cap, max_pairs)


def geometry_geometry_join_masks(averts, aev, avalid, abbox, bverts, bev,
                                 bvalid, bbbox, radius, a_polygonal: bool,
                                 b_polygonal: bool, block: int, cand: int,
                                 approx: bool = False) -> PrunedJoinMasks:
    """The distance step of ``geometry_geometry_join_pruned_kernel``."""
    cand = min(cand, bbbox.shape[0])
    t_bbox, bval, borig, gids, cvalid, overflow = geometry_tiles(
        abbox, avalid, bbbox, bvalid, radius, block, cand)
    if approx:
        cbb = bbbox[gids.long()]  # (NB, cand, 4)
        dmat = bbox_bbox_min_distance(t_bbox[:, :, None, :],
                                      cbb[:, None, :, :])
    else:
        # Padding rows have no valid edge: every tile member id is in
        # range for B4's unchecked ``sel``, and padding never matches.
        pad = borig.numel() - abbox.shape[0]
        sav = torch.nn.functional.pad(averts, (0, 0, 0, 0, 0, pad))
        sae = torch.nn.functional.pad(aev, (0, 0, 0, pad))
        dmat = geometry_pair_distance_tiles(sav, sae, bverts, bev, gids,
                                            a_polygonal, b_polygonal)
    mask = ((dmat <= _radius(radius, dmat)) & bval[:, :, None]
            & cvalid[:, None, :])
    return PrunedJoinMasks(mask, dmat, borig, gids, overflow)


def geometry_geometry_join_pruned_kernel(averts, aev, avalid, abbox, bverts,
                                         bev, bvalid, bbbox, radius,
                                         a_polygonal: bool,
                                         b_polygonal: bool, block: int,
                                         cand: int, max_pairs: int,
                                         pair_cap: int = 8,
                                         approx: bool = False
                                         ) -> PrunedJoinPairs:
    """Grid-pruned geometry ⋈ geometry join: the point kernel's tiles over
    the left geometries (sorted for locality by the caller), each tile's
    bbox the union of its members'. Exact mode: the tiled
    ``geometry_pair_distance`` (B4 gathered both ways, containment both
    ways). Approximate mode: the bbox ↔ bbox distance
    (``bbox_bbox_min_distance``; the vertex arguments unused and may be
    None). Exact iff both overflow counters are 0."""
    return compact_pruned(geometry_geometry_join_masks(
        averts, aev, avalid, abbox, bverts, bev, bvalid, bbbox, radius,
        a_polygonal, b_polygonal, block, cand, approx), pair_cap, max_pairs)
