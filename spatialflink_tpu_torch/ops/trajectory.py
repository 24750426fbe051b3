"""Trajectory segment ops: per-trajectory reductions over a window.

The reference's trajectory operators keep per-objID state in Flink keyed
state and walk it record by record (tStats/TStatsQuery.java:44-145,
tAggregate/TAggregateQuery.java:53-250). Here, as in the JAX package's
``ops/trajectory.py``, a window's points are sorted by (objID, ts) and
every per-trajectory statistic is a segment reduction over the interned
objID, on the points' device. None of these reaches a TPU kernel in the
JAX package (plain XLA there), so plain PyTorch is their port; tJoin's
point pairs come from B3 (``ops/join_kernel.py``) before
``traj_pair_dedup_kernel`` reduces them.

Sums on the card: ``index_add_`` on CUDA adds floats in an arbitrary
order, so spatial lengths may differ from the CPU's in the last bits,
within ``spatial_sum_bound``. Counts and temporal sums are integers and
exact on every device. Minima and maxima (``scatter_reduce``) are exact.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from spatialflink_tpu_torch.ops.distances import point_point_distance, sqrt_rn
from spatialflink_tpu_torch.ops.polygon import points_in_polygons
from spatialflink_tpu_torch.ops.select import first_k_prefix_indices


def spatial_sum_bound(n_terms, magnitude):
    """The most two float32 sums of the same nonnegative terms can differ
    when added in different orders: each is within (n − 1)·2⁻²⁴ of the
    terms' total magnitude of the exact sum (recursive summation, every
    partial sum at most that magnitude), so two are within
    2·n·2⁻²⁴·magnitude. ``n_terms`` counts every addition on a value's
    longest path (terms, cumulative sums, corrections); ``magnitude``
    bounds every partial sum (the row's sum of |terms|). Works
    elementwise on numpy arrays."""
    return 2.0 * n_terms * 2.0 ** -24 * magnitude


class TrajStats(NamedTuple):
    """Per-segment (per-objID) statistics of a window: TStatsQuery's
    (objID, spatialLength, temporalLength, spatial/temporal) tuple
    (TStatsQuery.java:137-144). ``temporal_length`` is int64 ms, exact."""

    spatial_length: torch.Tensor  # (U,)
    temporal_length: torch.Tensor  # (U,) int64 ms
    count: torch.Tensor  # (U,) int32 points per trajectory
    avg_speed: torch.Tensor  # (U,) spatial/temporal, 0 where temporal == 0


def traj_stats_kernel(xy, ts, oid, valid, num_segments: int) -> TrajStats:
    """Inputs sorted by (oid, ts); padding lanes are masked by ``valid``.
    Consecutive-point distances and time gaps of each trajectory are
    summed onto the later point's objID; equal timestamps contribute as
    in the reference's window walk."""
    same = (oid[1:] == oid[:-1]) & valid[1:] & valid[:-1]
    seg_d = point_point_distance(xy[1:], xy[:-1])
    seg_t = ts[1:].long() - ts[:-1].long()
    later = oid[1:].long()
    spatial = torch.zeros(num_segments, dtype=seg_d.dtype, device=xy.device)
    spatial.index_add_(0, later, torch.where(same, seg_d, 0.0))
    temporal = torch.zeros(num_segments, dtype=torch.int64, device=xy.device)
    temporal.index_add_(0, later, torch.where(same, seg_t, 0))
    count = torch.zeros(num_segments, dtype=torch.int32, device=xy.device)
    count.index_add_(0, oid.long(), valid.to(torch.int32))
    pos = temporal > 0
    speed = torch.where(pos, spatial / torch.where(pos, temporal, 1), 0.0)
    return TrajStats(spatial, temporal, count, speed)


def sort_by_oid_ts(ts, oid, valid, num_segments: int) -> torch.Tensor:
    """The permutation of ``jnp.lexsort((ts, oid_sort))``: two stable
    sorts, by ``ts`` and then by ``oid`` (invalid lanes forced past every
    real id, so they sort to the end). Ties keep their lane order."""
    oid_sort = torch.where(valid, oid.long(), num_segments)
    by_ts = torch.sort(ts, stable=True).indices
    return by_ts[torch.sort(oid_sort[by_ts], stable=True).indices]


def traj_stats_sorted_fused(xy, ts, oid, valid,
                            num_segments: int) -> TrajStats:
    """``traj_stats_kernel`` over an unsorted batch: the (oid, ts) sort
    happens on the device, so SoA windows need no host sort."""
    order = sort_by_oid_ts(ts, oid, valid, num_segments)
    return traj_stats_kernel(xy[order], ts[order], oid[order], valid[order],
                             num_segments)


class TrajPaneStats(NamedTuple):
    """The pane engine's (num_oids, n_starts) matrices, oid-major;
    ``temporal`` and ``count`` int64, exact."""

    spatial: torch.Tensor
    temporal: torch.Tensor
    count: torch.Tensor


def traj_stats_pane_kernel(ts_rel, x, y, oid, valid, num_oids: int,
                           slide_ms: int, ppw: int,
                           n_panes: int) -> TrajPaneStats:
    """Sliding-window tStats by pane decomposition, on the inputs'
    device: the port of the JAX package's ``traj_stats_pane_kernel``.

    Inputs sorted by (oid, ts), padding at the end (``valid`` False).
    ``ts_rel`` is int32 time rebased by the caller to the first pane, so
    epoch-ms values fit. Per (oid, pane): the point count and the sums
    of each consecutive segment's length and time gap, binned at its
    later point. Window sums are differences of one cumulative sum over
    panes, read at the window's first and last pane. A segment whose
    earlier point lies before a window's start must not count there
    (the reference truncates trajectories at the window start,
    TStatsQuery.java:148-189): an interval subtraction through a
    difference array and one more cumulative sum removes it from
    exactly those windows."""
    k = num_oids
    dev = x.device
    n_starts = n_panes + ppw - 1
    nflat = k * n_panes
    ts_rel = ts_rel.to(torch.int32)
    oid = oid.long()
    pane = torch.clamp(torch.div(ts_rel, slide_ms, rounding_mode="floor"),
                       0, n_panes - 1).long()
    ids_pt = torch.where(valid, oid * n_panes + pane, nflat)

    def flat_sum(vals, ids, n, dtype):
        out = torch.zeros(n + 1, dtype=dtype, device=dev)
        out.index_add_(0, ids, vals)
        return out[:n]

    cnt = flat_sum(valid.long(), ids_pt, nflat, torch.int64).reshape(k, n_panes)
    same = (oid[1:] == oid[:-1]) & valid[1:] & valid[:-1]
    dx = x[1:] - x[:-1]
    dy = y[1:] - y[:-1]
    seg_d = torch.where(same, sqrt_rn(dx * dx + dy * dy), 0.0)
    seg_dt = torch.where(same, (ts_rel[1:] - ts_rel[:-1]).long(), 0)
    ids_seg = ids_pt[1:]  # the later point's id; non-segments add zeros
    pane_d = flat_sum(seg_d, ids_seg, nflat, x.dtype).reshape(k, n_panes)
    pane_dt = flat_sum(seg_dt, ids_seg, nflat,
                       torch.int64).reshape(k, n_panes)

    row = torch.arange(n_starts, device=dev) - (ppw - 1)
    row_hi = torch.clamp(row + ppw, 0, n_panes)
    row_lo = torch.clamp(row, 0, n_panes)

    def rolling(a):
        c = torch.cat([torch.zeros((k, 1), dtype=a.dtype, device=dev),
                       torch.cumsum(a, dim=1, dtype=a.dtype)], dim=1)
        return c[:, row_hi] - c[:, row_lo]

    w_d = rolling(pane_d)
    w_dt = rolling(pane_dt)
    w_cnt = rolling(cnt)

    # Start-boundary corrections; t_prev_eff keeps ids monotone across
    # trajectory breaks (those lanes carry zeros).
    t_prev_eff = torch.where(same, ts_rel[:-1], ts_rel[1:])
    seg_pane = torch.div(ts_rel[1:], slide_ms, rounding_mode="floor").long()
    first_b = torch.maximum(
        torch.div(t_prev_eff, slide_ms, rounding_mode="floor").long() + 1,
        seg_pane - ppw + 1)
    base = -(ppw - 1)  # rebased window-start pane of start index 0
    si0 = torch.clamp(first_b - base, 0, n_starts)
    si1 = torch.clamp(seg_pane - base + 1, 0, n_starts)
    has = same & (si0 < si1) & valid[1:]
    d_corr = torch.where(has, seg_d, 0.0)
    t_corr = torch.where(has, seg_dt, 0)
    stride = n_starts + 1
    oid_b = oid[1:] * stride
    nstr = k * stride
    ids0 = torch.where(valid[1:], oid_b + si0, nstr)
    ids1 = torch.where(valid[1:], oid_b + si1, nstr)

    def interval(vals, dtype):
        return (flat_sum(vals, ids0, nstr, dtype)
                - flat_sum(vals, ids1, nstr, dtype)).reshape(k, stride)

    diff_d = interval(d_corr, x.dtype)
    diff_t = interval(t_corr, torch.int64)
    w_d = w_d - torch.cumsum(diff_d, dim=1, dtype=x.dtype)[:, :n_starts]
    w_dt = w_dt - torch.cumsum(diff_t, dim=1)[:, :n_starts]
    return TrajPaneStats(w_d, w_dt, w_cnt)


def stay_time_cells_kernel(ts, cell, oid, valid, num_cells: int):
    """Per-cell dwell time of one window: each consecutive
    same-trajectory time gap attributed to the earlier point's cell
    (apps/StayTime.java:216-396 and :433-447). Inputs sorted by (oid,
    ts), padding at the end; out-of-grid points carry ``num_cells``.
    Returns ((num_cells + 1,) int64 ms sums, (num_cells + 1,) int64 pair
    counts): a count tells a cell of zero-length gaps from a cell with no
    pairs."""
    same = (oid[1:] == oid[:-1]) & valid[1:] & valid[:-1]
    gaps = torch.where(same, ts[1:].long() - ts[:-1].long(), 0)
    key = torch.where(same & valid[:-1], cell[:-1].long(), num_cells + 1)
    dwell = torch.zeros(num_cells + 2, dtype=torch.int64, device=ts.device)
    dwell.index_add_(0, key, gaps)
    count = torch.zeros(num_cells + 2, dtype=torch.int64, device=ts.device)
    count.index_add_(0, key, same.long())
    return dwell[:num_cells + 1], count[:num_cells + 1]


class TrajPairs(NamedTuple):
    """Distinct (trajectory, trajectory) pairs of a window.

    ``pair_key`` (max_tpairs,) int64 ``left_local * num_right +
    right_local`` ascending, −1 padding; ``dist`` the pair's min point
    distance (``finfo.max`` padding); ``count`` () the distinct pairs
    (above ``max_tpairs``: grow the budget and rerun)."""

    pair_key: torch.Tensor
    dist: torch.Tensor
    count: torch.Tensor


def traj_pair_dedup_kernel(left_index, right_index, dist, left_local,
                           right_local, num_left: int, num_right: int,
                           max_tpairs: int) -> TrajPairs:
    """A join's point pairs → distinct trajectory pairs with their min
    distance: a scatter-min over window-local pair keys and a prefix-sum
    compaction of the keys hit, in ascending key order (the JAX
    ``jnp.nonzero(size=max_tpairs, fill_value=-1)``). Replaces the
    reference's per-record dedup map (tJoin/TJoinQuery.java:60-154).

    ``left_index``/``right_index``/``dist``: a ``CompactJoinResult``'s
    arrays (−1 padding); ``left_local``/``right_local``: each batch
    lane's window-local trajectory rank."""
    ok = left_index >= 0
    key = (left_local[torch.clamp(left_index, min=0).long()].long()
           * num_right
           + right_local[torch.clamp(right_index, min=0).long()].long())
    n_keys = num_left * num_right
    key = torch.where(ok, key, n_keys)
    big = torch.finfo(dist.dtype).max
    best = torch.full((n_keys + 1,), big, dtype=dist.dtype,
                      device=dist.device)
    best.scatter_reduce_(0, key, torch.where(ok, dist, big), reduce="amin")
    best = best[:n_keys]
    ci, count, _ = first_k_prefix_indices(best < big, max_tpairs)
    found = torch.arange(max_tpairs, device=dist.device) < count
    pair_key = torch.where(found, ci.long(), -1)
    pair_dist = torch.where(found, best[ci.long()], big)
    return TrajPairs(pair_key, pair_dist, count)


class TrajAggregate(NamedTuple):
    """Per-(cell, objID) timestamp span for the heatmap aggregate."""

    min_ts: torch.Tensor  # (P,)
    max_ts: torch.Tensor  # (P,)


def traj_cell_spans_kernel(ts, pair_id, valid,
                           num_pairs: int) -> TrajAggregate:
    """Min and max timestamp per dense (cell, objID) pair id: the batched
    form of TAggregateQuery's MapState tracking
    (TAggregateQuery.java:150-250). Pair ids are interned on the host;
    an id with no valid lane keeps the dtype's max and min."""
    info = torch.iinfo(ts.dtype)
    pid = pair_id.long()
    mn = torch.full((num_pairs,), info.max, dtype=ts.dtype, device=ts.device)
    mn.scatter_reduce_(0, pid, torch.where(valid, ts, info.max),
                       reduce="amin")
    mx = torch.full((num_pairs,), info.min, dtype=ts.dtype, device=ts.device)
    mx.scatter_reduce_(0, pid, torch.where(valid, ts, info.min),
                       reduce="amax")
    return TrajAggregate(mn, mx)


def traj_hits_kernel(inside_any, oid, valid, num_segments: int):
    """(U,) bool: does any valid point of each trajectory satisfy the
    predicate? tRange's rule: a trajectory qualifies when one of its
    window points lies in a query polygon
    (tRange/PointPolygonTRangeQuery.java:53-177)."""
    hit = (inside_any & valid).to(torch.int32)
    seg = torch.zeros(num_segments, dtype=torch.int32, device=hit.device)
    seg.scatter_reduce_(0, oid.long(), hit, reduce="amax")
    return seg > 0


def traj_range_hits_fused(xy, valid, oid, query_verts, query_edge_valid,
                          num_segments: int):
    """tRange's window program: containment of every point in the query
    polygon set (dense, ``points_in_polygons``), then the per-trajectory
    any-hit."""
    inside = points_in_polygons(xy, query_verts, query_edge_valid)
    return traj_hits_kernel(inside.any(dim=1), oid, valid, num_segments)
