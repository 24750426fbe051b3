"""Grid-partitioned probe kernels: per-pair flag activity from flat cells.

The port of the JAX package's ``ops/halo.py``. The flag-table kernels
(``ops/range.py``, ``ops/query_registry.py``) need a (num_cells + 1,)
uint8 table a query, which is exactly the state the replicated mesh path
must broadcast. The grid-partitioned path derives the same layer math
per (point, query) pair from the two flat cell ids alone::

    xi = cell // n,  yi = cell % n
    cheb = max(|dxi|, |dyi|)
    pair candidate  <=>  cheb <= L_c        (grid.candidate_layers)
    pair guaranteed <=>  cheb <= L_g        (grid.guaranteed_layers; -1: none)

so a shard holding only its own rows plus its neighbours' boundary-cell
pane lanes (``parallel/partition.py``'s halo math) evaluates every
active pair with no table and no broadcast. Reductions mask inactive
pairs to the dtype's max, so the reduced values do not depend on lane
order or count: the mesh wrappers (``parallel/halo.py``) are bit-equal
to these kernels.

Deliberate deviation from the table kernels, as in the JAX package: the
table path's candidate check uses the min distance over all query
lanes, the per-pair path over active pairs only. An inactive pair sits
at least L_c cells, so at least the radius, away, and the two differ
only when an inactive pair ties the radius exactly, a measure-zero
boundary case.

Every kernel is plain PyTorch on its inputs' device (the JAX package's
are plain ``jnp``, no Pallas kernel), fixed-shape and mask-don't-compact:
the join's compaction is a prefix-sum selection (``ops/select.py``), so
no call waits for the host.
"""

from __future__ import annotations

import numpy as np
import torch

from spatialflink_tpu_torch.ops.distances import point_point_distance
from spatialflink_tpu_torch.ops.select import first_k_prefix_indices

__all__ = [
    "pair_layers",
    "range_partitioned_kernel",
    "join_partitioned_kernel",
    "registry_bucket_partitioned_kernel",
]


def _operand(value, like: torch.Tensor):
    """A compare operand promoting as it does in the JAX package: a
    Python number stays weak (the distances' dtype); a numpy scalar or
    array or a tensor is strong, so it becomes a 1-d tensor (a 0-d
    tensor would not promote the distances)."""
    if isinstance(value, (bool, int, float)):
        return value
    if not isinstance(value, torch.Tensor):
        value = torch.from_numpy(np.array(value, copy=True))
    return value.to(like.device).reshape(-1)


def pair_layers(cell_a: torch.Tensor, cell_b: torch.Tensor, grid_n: int):
    """Chebyshev ring number between two flat cell ids, broadcasting: the
    vectorised HelperClass.getCellLayerWRTQueryCell (``grid.py:
    cell_layer``). Out-of-grid sentinel cells (== n²) give garbage
    layers; callers mask them with the in-grid check."""
    ax = torch.div(cell_a, grid_n, rounding_mode="floor")
    ay = torch.remainder(cell_a, grid_n)
    bx = torch.div(cell_b, grid_n, rounding_mode="floor")
    by = torch.remainder(cell_b, grid_n)
    return torch.maximum((ax - bx).abs(), (ay - by).abs())


def _pair_active(cell, valid, q_cell, q_valid, grid_n: int, layers: int):
    """(N, Q) bool: the pair within ``layers`` Chebyshev rings, both lanes
    live and in-grid."""
    num_cells = grid_n * grid_n
    cell = cell.to(torch.int32)
    q_cell = q_cell.to(torch.int32)
    cheb = pair_layers(cell[:, None], q_cell[None, :], grid_n)
    return (valid[:, None] & q_valid[None, :]
            & (cell[:, None] < num_cells) & (q_cell[None, :] < num_cells)
            & (cheb <= layers))


def range_partitioned_kernel(xy, valid, cell, query_xy, query_cell,
                             query_valid, radius, *, grid_n: int,
                             layers: int, guaranteed: int,
                             approximate: bool = False):
    """Point stream against a point query set, per-pair grid pruning.

    ``xy``: (N, 2); ``cell``: (N,) flat ids; ``query_xy``: (Q, 2) with
    per-lane cells and validity (padding lanes are simply inactive).
    Returns (keep (N,) bool, dist (N,)), ``dist`` the min over active
    pairs (the dtype's max when none). Guaranteed pairs emit with no
    distance check, candidate pairs iff within ``radius``;
    ``approximate`` drops the distance check (the reference's
    approximateQuery flag)."""
    d = point_point_distance(xy[:, None, :], query_xy[None, :, :])
    cand = _pair_active(cell, valid, query_cell, query_valid, grid_n, layers)
    big = torch.finfo(d.dtype).max
    if approximate:
        keep = valid & cand.any(dim=1)
    else:
        hit = (cand & (d <= _operand(radius, d))).any(dim=1)
        if guaranteed >= 0:
            hit = _pair_active(cell, valid, query_cell, query_valid, grid_n,
                               guaranteed).any(dim=1) | hit
        keep = valid & hit
    dist = torch.where(cand, d, big).amin(dim=1)
    return keep, dist


def join_partitioned_kernel(left_xy, left_valid, left_cell, right_xy,
                            right_valid, right_cell, radius, *, grid_n: int,
                            layers: int, budget: int):
    """Grid-pruned point ⋈ point join over flat cells.

    Every (left, right) pair within ``layers`` Chebyshev rings and
    within ``radius``, the first ``budget`` of them in row-major order,
    −1 padding. Returns (left_idx, right_idx, dist, count, overflow):
    int32 local lane indices (the mesh wrapper maps them through its
    global-id panes), ``inf`` in an empty slot's distance, ``count`` the
    true hit count and ``overflow = max(count − budget, 0)``, the
    caller's retry-with-a-doubled-budget contract."""
    d = point_point_distance(left_xy[:, None, :], right_xy[None, :, :])
    act = _pair_active(left_cell, left_valid, right_cell, right_valid,
                       grid_n, layers)
    flat = (act & (d <= _operand(radius, d))).reshape(-1)
    dev = d.device
    budget = int(budget)
    if flat.numel() == 0:
        count = torch.zeros((), dtype=torch.int32, device=dev)
        hc = torch.zeros(budget, dtype=torch.int64, device=dev)
        found = torch.zeros(budget, dtype=torch.bool, device=dev)
        dflat = torch.zeros(1, dtype=d.dtype, device=dev)
    else:
        ci, count, _ = first_k_prefix_indices(flat, budget)
        found = torch.arange(budget, device=dev) < count
        hc = ci.long()
        dflat = d.reshape(-1)
    m = right_xy.shape[0]
    left_idx = torch.where(found, torch.div(hc, max(m, 1),
                                            rounding_mode="floor"),
                           -1).to(torch.int32)
    right_idx = torch.where(found, torch.remainder(hc, max(m, 1)),
                            -1).to(torch.int32)
    dist = torch.where(found, dflat[torch.where(found, hc, 0)],
                       torch.inf)
    count = count.to(torch.int32)
    overflow = torch.clamp(count - budget, min=0)
    return left_idx, right_idx, dist, count, overflow


def registry_bucket_partitioned_kernel(xy, valid, cell, oid, query_xy,
                                       query_cell, radius, query_valid, *,
                                       grid_n: int, layers: int, k: int,
                                       num_segments: int,
                                       query_block: int = 32):
    """Standing-query bucket (qserve) with per-pair grid pruning.

    Per query lane: the per-object min distance over active pairs within
    the query's radius (a scatter-min into a (num_segments,) table: the
    canonical segment indexing makes lane order irrelevant, so the mesh
    wrapper's own-plus-halo lane set reduces to the same table bitwise),
    then the top-k of the table, equal distances lowest segment first (a
    stable sort, as ``lax.top_k`` orders them). ``layers`` is the
    bucket's radius-class ceiling. Returns (dist (Q, k), segment (Q, k)
    int32, −1 beyond ``within``, num_valid (Q,), within (Q,)).

    Queries go in blocks of 32, 16, ..., 1 (the largest dividing Q), so
    peak memory is O(block × N)."""
    q_total = int(query_xy.shape[0])
    dev = xy.device
    big = torch.finfo(xy.dtype).max
    seg = torch.clamp(oid.to(torch.int32), 0, num_segments - 1).long()
    radius = _operand(radius, xy)
    block = next(b for b in (query_block, 16, 8, 4, 2, 1)
                 if q_total % b == 0)
    dists, segs, nvs, wins = [], [], [], []
    for q0 in range(0, q_total, block):
        q1 = q0 + block
        d = point_point_distance(xy[None, :, :], query_xy[q0:q1, None, :])
        act = _pair_active(cell, valid, query_cell[q0:q1],
                           query_valid[q0:q1], grid_n, layers).T
        dm = torch.where(act & (d <= radius[q0:q1, None]), d,
                         torch.tensor(big, dtype=d.dtype, device=dev))
        key = (torch.arange(block, device=dev)[:, None] * num_segments
               + seg[None, :]).reshape(-1)
        table = torch.full((block * num_segments,), big, dtype=dm.dtype,
                           device=dev)
        table.scatter_reduce_(0, key, dm.reshape(-1), reduce="amin",
                              include_self=True)
        table = table.view(block, num_segments)
        vals, idx = torch.sort(table, dim=1, stable=True)
        top_d = vals[:, :k]
        dists.append(top_d)
        segs.append(torch.where(top_d < big, idx[:, :k].to(torch.int32), -1))
        within = (table < big).sum(dim=1, dtype=torch.int32)
        nvs.append(torch.clamp(within, max=k))
        wins.append(within)
    return (torch.cat(dists), torch.cat(segs), torch.cat(nvs),
            torch.cat(wins))
