"""Bucketed standing-query evaluation: the device half of the standing-
query server (``qserve.py``).

Every registered query of a bucket is evaluated in one fixed-shape
program a window. This generalises ``ops/knn.py:knn_multi_query_kernel``
along the two axes a registry needs, as the JAX package's
``ops/query_registry.py`` does:

- **per-query radius**: the radius is a ``(Q,)`` tensor compared lane by
  lane, so queries of different radii share one program and churn across
  radii changes no shape;
- **padded query lanes**: a bucket is padded to a power-of-two capacity
  rung (``ops/compaction.py``'s ladder, picked on the host from the live
  count), and ``query_valid`` empties the padded lanes. Padding never
  changes a live lane's result.

One result shape serves both query kinds: per query, the top-``k``
distinct objects by min distance within that query's radius (the
segment-min and top-k of ``ops/knn.py``, the reference's PQ and HashSet
merge, KNNQuery.java:204-308). A kNN query reads its first ``k_q <= k``
rows; a range query reads its ``num_valid`` rows with ``within``, the
unclamped count of distinct in-radius objects, as its exactness counter
(``range_bucket_overflow``).

A live lane's result equals ``ops/knn.py:knn_points_fused`` for that
query alone with its own flag table and radius: the same elementwise
distance, the same lowest-index representative and the same stable
top-k order (equal distances keep the lowest segment first). The radius
is compared in its own dtype when it is the wider one: a float64 radius
against float32 distances compares in float64, as the JAX package does
under x64.

The program is plain PyTorch on the card: the JAX program is a vmapped
``jnp`` program under ``lax.map`` and reaches no ``pallas_call``.
Queries go in blocks of ``query_block``, so peak memory is
O(``query_block`` x N). The scatter-min runs over every (query, point)
lane of a block, the masked ones at the absent distance, so a window
waits for the host nowhere; it is the body ``knn_multi_query_kernel``
runs, on every device alike.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from spatialflink_tpu_torch.ops.cells import gather_cell_flags
from spatialflink_tpu_torch.ops.distances import point_point_distance
from spatialflink_tpu_torch.ops.knn import (
    _digest_from_point_dists,
    _finish_topk,
    _multi_query_topk,
    absent_dist,
)

__all__ = [
    "RegistryBucketResult",
    "registry_bucket_query",
    "registry_bucket_kernel",
    "range_bucket_overflow",
]


class RegistryBucketResult(NamedTuple):
    """Per-query top-k over a bucket. Leading axis = query lane; padded
    lanes (``query_valid`` False) carry dist = the dtype's max,
    segment = index = -1 and counts 0."""

    dist: torch.Tensor  # (Q, k) ascending min-distance per winning object
    segment: torch.Tensor  # (Q, k) interned objID (-1 = padding)
    index: torch.Tensor  # (Q, k) winning point's index in the window batch
    num_valid: torch.Tensor  # (Q,) min(within, k)
    within: torch.Tensor  # (Q,) distinct objects within radius, unclamped


def _lane_radius(radius, dist):
    """``radius`` as a compare operand: a tensor becomes 1-d, so that a
    float64 radius promotes float32 distances (a 0-d tensor would be
    cast down to the distances' dtype); a Python number stays as is."""
    if isinstance(radius, torch.Tensor):
        return radius.to(dist.device).reshape(1)
    return radius


def registry_bucket_query(xy, valid, cell, flags_table, oid, q_xy, radius,
                          q_ok, k: int, num_segments: int):
    """One standing query against the window batch: (dist, segment,
    index, num_valid, within). ``q_ok`` False empties the lane. For a
    live lane this is ``knn_points_fused``'s digest and top-k, with the
    radius compared in the wider of its dtype and the distances'."""
    dist = point_point_distance(xy, q_xy[None, :])
    flags = gather_cell_flags(cell, flags_table)
    q_ok = torch.as_tensor(q_ok, dtype=torch.bool, device=xy.device)
    d = _digest_from_point_dists(dist, valid & q_ok, flags, oid,
                                 _lane_radius(radius, dist), num_segments)
    within = (d.seg_min < absent_dist(d.seg_min.dtype)).sum().to(
        torch.int32)
    res = _finish_topk(d.seg_min, d.rep, k)
    return res.dist, res.segment, res.index, res.num_valid, within


def registry_bucket_kernel(xy: torch.Tensor, valid: torch.Tensor,
                           cell: torch.Tensor, flags_tables: torch.Tensor,
                           oid: torch.Tensor, query_xy: torch.Tensor,
                           radius: torch.Tensor, query_valid: torch.Tensor,
                           k: int, num_segments: int,
                           query_block: int = 32) -> RegistryBucketResult:
    """One bucket of standing queries in one program a window.

    ``query_xy`` (Q, 2); ``flags_tables`` (Q, num_cells + 1) per-query
    neighbour-cell tables; ``radius`` (Q,) per-query radii; ``query_valid``
    (Q,) bool, False on the padded rung lanes. ``k`` is the bucket's
    result-capacity rung and ``num_segments`` the interner bucket. Q must
    divide into ``query_block`` (the rung is a power of two of at least
    8, so any power-of-two block up to Q divides); ``k`` above
    ``num_segments`` raises, as the reference's top-k does. The body is
    ``ops/knn.py``'s blocked multi-query top-k, which
    ``knn_multi_query_kernel`` runs too."""
    res, within = _multi_query_topk(xy, valid, cell, flags_tables, oid,
                                    query_xy, radius, query_valid, k,
                                    num_segments, query_block)
    return RegistryBucketResult(*res, within)


def range_bucket_overflow(within: torch.Tensor, k: int) -> torch.Tensor:
    """Distinct in-radius objects the rung could not return across a
    bucket: the range-query exactness counter (0: every range result in
    the bucket is complete; otherwise climb the result-cap rung)."""
    return torch.clamp(within - k, min=0).sum()
