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
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from spatialflink_tpu_torch.ops.distances import point_point_distance


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
    float32, +inf padding; ``count``: () int32 true number of pairs
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
