"""Grid-partitioned mesh wrappers: a halo exchange replaces replication.

The port of the JAX package's ``parallel/halo.py``. Window rows
partition by owning shard (contiguous flat-cell ranges,
``parallel/partition.py``), and each wrapper ships only the
boundary-cell pane lanes to the two adjacent shards. The JAX package's
two open-chain ``lax.ppermute``\\ s become copies of the neighbours'
host panes onto each shard's device::

    shard s receives  the RIGHT pane of s-1   (JAX's perm [(i, i+1)])
                      the LEFT  pane of s+1   (JAX's perm [(i, i-1)])

The chain ends receive an all-invalid pane of the same shape (JAX's zero
fill: xy 0, ok False, cell 0, gid 0), and each shard concatenates its
own lanes, then those from the left, then those from the right, in
JAX's order: under a join budget overflow the lane order decides which
pairs the compaction keeps.

Every wrapper here

- has a bit-equal single-device counterpart in ``ops/halo.py`` (its
  reductions mask inactive pairs, so lane order and count do not move
  a bit);
- passes the ``shard.exchange`` fault point once, before dispatch;
- feeds ``telemetry.account_collective`` from the pane stacks' shapes
  and ``telemetry.account_halo_state`` with the unpadded boundary-row
  bytes, with the JAX package's pane dtypes, so the gauges equal the
  JAX package's byte for byte;
- records per-shard watermarks when given event times.

Host in, host out: the wrappers take numpy arrays, partition on the host,
run each shard's kernel on the mesh device of that shard, and scatter the
results back to the original row order, so callers never see the
placement. On a mesh spanning processes every process holds the whole
input, runs its own shards and all-gathers their parts
(``mesh.map_shards``).

The per-pair path and the flag-table path (``parallel/sharded.py:
sharded_range_query``) differ only where an inactive pair ties the
radius exactly, a measure-zero case (``ops/halo.py``).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from spatialflink_tpu_torch.faults import faults
from spatialflink_tpu_torch.ops.halo import (
    join_partitioned_kernel,
    range_partitioned_kernel,
    registry_bucket_partitioned_kernel,
)
from spatialflink_tpu_torch.parallel.mesh import (
    map_shards,
    payload_nbytes,
    require_mesh,
)
from spatialflink_tpu_torch.parallel.partition import (
    PartitionPlan,
    gather_rows,
    scatter_rows,
    shard_layout,
)
from spatialflink_tpu_torch.parallel.sharded import _data_devices
from spatialflink_tpu_torch.telemetry import instrument_jit, telemetry

__all__ = [
    "sharded_range_halo",
    "sharded_join_halo",
    "sharded_tjoin_panes_halo",
    "sharded_registry_bucket_halo",
]


def _check_plan(mesh, plan: PartitionPlan):
    n_shards = int(require_mesh(mesh).shape["data"])
    if n_shards != plan.n_shards:
        raise ValueError(
            f"partition plan is for {plan.n_shards} shard(s) but the "
            f"mesh data axis has {n_shards}"
        )
    return n_shards


def _on(dev, stacks, s):
    """Shard ``s``'s rows of the host pane ``stacks`` as tensors on
    ``dev``."""
    return tuple(torch.from_numpy(np.ascontiguousarray(a[s])).to(dev)
                 for a in stacks)


def _with_halo(mesh, s, own, left, right):
    """Shard ``s``'s lanes: its own pane (host stacks ``own``), then the
    right pane of ``s - 1``, then the left pane of ``s + 1``, each field
    copied from the host panes onto shard ``s``'s device and concatenated
    there. Past a chain end the pane is all-invalid (zeros, as
    ``ppermute`` fills)."""
    devs = _data_devices(mesh)
    dev = devs[s]
    n = len(devs)
    mine = _on(dev, own, s)
    if n == 1:
        return mine
    from_left = _on(dev, right, s - 1) if s > 0 else tuple(
        torch.zeros_like(a) for a in _on(dev, right, s))
    from_right = _on(dev, left, s + 1) if s < n - 1 else tuple(
        torch.zeros_like(a) for a in _on(dev, left, s))
    return tuple(torch.cat(f) for f in zip(mine, from_left, from_right))


def _host(parts, i):
    """Field ``i`` of every shard's part, stacked on the host."""
    return np.stack([p[i].cpu().numpy() for p in parts])


def _record_shard_watermarks(plan: PartitionPlan, cells, valid, ts):
    """Per-shard watermark gauges from one window's event times (host
    side, telemetry only)."""
    if not telemetry.enabled or ts is None:
        return
    live = np.asarray(valid, bool)
    if not live.any():
        return
    t = np.asarray(ts)[live]
    sh = plan.shard_of(np.asarray(cells)[live])
    for s in np.unique(sh):
        telemetry.record_shard_watermark(int(s), int(t[sh == s].max()))


# Each wrapper accounts its own exchange inline, as the JAX package's do:
# the ppermute payload is the padded pane stacks (static shapes); the
# halo-state bytes are the unpadded boundary rows, the state the exchange
# exists to move (the replication-ratio denominator).


# -- range --------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _cached_range_halo(mesh, grid_n, layers, guaranteed, approximate):
    devs = _data_devices(mesh)

    def program(own_p, own_q, left_q, right_q, radius):
        def shard(s):
            pxy, pok, pcell = _on(devs[s], own_p, s)
            q_xy, q_ok, q_cell = _with_halo(mesh, s, own_q, left_q,
                                            right_q)
            return range_partitioned_kernel(
                pxy, pok, pcell, q_xy, q_cell, q_ok, radius,
                grid_n=grid_n, layers=layers, guaranteed=guaranteed,
                approximate=approximate)

        parts = map_shards(mesh, shard)
        return _host(parts, 0), _host(parts, 1)

    return instrument_jit(program, name="sharded:range_halo")


def sharded_range_halo(mesh, plan: PartitionPlan, xy: np.ndarray,
                       valid: np.ndarray, cell: np.ndarray,
                       query_xy: np.ndarray, query_cell: np.ndarray,
                       query_valid: np.ndarray, radius,
                       approximate: bool = False, ts=None):
    """Grid-partitioned range query: points and queries partition by
    cell; only boundary-cell query panes halo-exchange (the query side
    is what the replicated path broadcasts whole). Bit-equal to
    ``ops/halo.py:range_partitioned_kernel`` on the full arrays. Returns
    numpy (keep, dist) in original row order."""
    n_shards = _check_plan(mesh, plan)
    xy = np.asarray(xy)
    n = xy.shape[0]
    lp = shard_layout(plan, cell, valid)
    lq = shard_layout(plan, query_cell, query_valid)
    sentinel = plan.num_cells

    def pane(index_map, src_xy, src_cell):
        return (
            gather_rows(index_map, src_xy, 0.0),
            index_map >= 0,
            gather_rows(index_map, src_cell, sentinel).astype(np.int32),
        )

    own_p = pane(lp.own, xy, cell)
    own_q = pane(lq.own, query_xy, query_cell)
    left_q = pane(lq.left, query_xy, query_cell)
    right_q = pane(lq.right, query_xy, query_cell)
    if faults.armed:
        faults.hit("shard.exchange")
    if n_shards > 1:
        panes = left_q + right_q
        telemetry.account_collective(
            "ppermute", payload_nbytes(*panes), axis="data",
            calls=len(panes),
        )
        row_bytes = 2 * xy.dtype.itemsize + 4 + 1
        telemetry.account_halo_state(lq.live_boundary_rows * row_bytes)
    _record_shard_watermarks(plan, cell, valid, ts)
    fn = _cached_range_halo(mesh, plan.grid_n, plan.layers,
                            plan.guaranteed, approximate)
    keep2, dist2 = fn(own_p, own_q, left_q, right_q, radius)
    # Unassigned rows take the kernel's no-active-pair fill: the result
    # dtype's max.
    big = np.finfo(dist2.dtype).max
    keep = scatter_rows(lp.own, keep2, n, False)
    dist = scatter_rows(lp.own, dist2, n, big)
    return keep, dist


# -- join ---------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _cached_join_halo(mesh, grid_n, layers, budget):
    devs = _data_devices(mesh)

    def program(own_l, own_r, left_r, right_r, radius):
        def shard(s):
            lxy, lok, lcell, lgid = _on(devs[s], own_l, s)
            r_xy, r_ok, r_cell, r_gid = _with_halo(mesh, s, own_r, left_r,
                                                   right_r)
            li, ri, dist, count, over = join_partitioned_kernel(
                lxy, lok, lcell, r_xy, r_ok, r_cell, radius,
                grid_n=grid_n, layers=layers, budget=budget)
            lg = torch.where(li >= 0, lgid[li.clamp(min=0).long()], -1)
            rg = torch.where(ri >= 0, r_gid[ri.clamp(min=0).long()], -1)
            return lg, rg, dist, count, over

        parts = map_shards(mesh, shard)
        return tuple(_host(parts, i) for i in range(5))

    return instrument_jit(program, name="sharded:join_halo")


def sharded_join_halo(mesh, plan: PartitionPlan, left_xy: np.ndarray,
                      left_valid: np.ndarray, left_cell: np.ndarray,
                      right_xy: np.ndarray, right_valid: np.ndarray,
                      right_cell: np.ndarray, radius, max_pairs: int,
                      ts=None):
    """Grid-partitioned point ⋈ point join: both sides partition by
    cell; only the right side's boundary-cell panes halo-exchange (the
    side the replicated join broadcasts whole), with global row ids
    riding the panes. Returns numpy (left_idx, right_idx, dist) of the
    found pairs sorted by (left, right), the order the single-device
    ``ops/halo.py:join_partitioned_kernel`` pairs sort to, and the
    (count, overflow) totals. ``max_pairs`` is each shard's budget."""
    n_shards = _check_plan(mesh, plan)
    left_xy = np.asarray(left_xy)
    right_xy = np.asarray(right_xy)
    ll = shard_layout(plan, left_cell, left_valid)
    lr = shard_layout(plan, right_cell, right_valid)
    sentinel = plan.num_cells

    def pane(index_map, src_xy, src_cell):
        return (
            gather_rows(index_map, src_xy, 0.0),
            index_map >= 0,
            gather_rows(index_map, src_cell, sentinel).astype(np.int32),
            index_map.astype(np.int32),  # global row id (−1 padding)
        )

    lp = pane(ll.own, left_xy, left_cell)
    rp = pane(lr.own, right_xy, right_cell)
    blp = pane(lr.left, right_xy, right_cell)
    brp = pane(lr.right, right_xy, right_cell)
    if faults.armed:
        faults.hit("shard.exchange")
    if n_shards > 1:
        telemetry.account_collective(
            "ppermute", payload_nbytes(*(blp + brp)), axis="data",
            calls=len(blp + brp),
        )
        row_bytes = 2 * right_xy.dtype.itemsize + 4 + 1 + 4
        telemetry.account_halo_state(lr.live_boundary_rows * row_bytes)
    _record_shard_watermarks(plan, left_cell, left_valid, ts)
    fn = _cached_join_halo(mesh, plan.grid_n, plan.layers, int(max_pairs))
    lg, rg, dist, count, over = fn(lp, rp, blp, brp, radius)
    found = lg.reshape(-1) >= 0
    li = lg.reshape(-1)[found]
    ri = rg.reshape(-1)[found]
    dv = dist.reshape(-1)[found]
    order = np.lexsort((ri, li))
    return (li[order], ri[order], dv[order], int(count.sum()),
            int(over.sum()))


def sharded_tjoin_panes_halo(mesh, plan: PartitionPlan, ts, left_panes,
                             right_panes, radius, ppw: int, max_pairs: int):
    """Grid-partitioned tJoin pane scan: per slide, the sliding window
    (the last ``ppw`` panes a side) joins through
    :func:`sharded_join_halo`, boundary panes halo-exchanged instead of
    the replicated scan's all-gather of every pane field.
    ``left_panes``/``right_panes`` are sequences of ``(xy, valid,
    cell)`` host pane arrays, ``ts`` the per-slide window-end times
    (the per-shard watermark gauges). Returns the per-slide list of
    ``sharded_join_halo`` results."""
    ts = np.asarray(ts)
    results = []
    for i in range(ts.shape[0]):
        lo = max(0, i - int(ppw) + 1)
        lxy, lok, lcell = (
            np.concatenate([p[j] for p in left_panes[lo: i + 1]], axis=0)
            for j in range(3)
        )
        rxy, rok, rcell = (
            np.concatenate([p[j] for p in right_panes[lo: i + 1]], axis=0)
            for j in range(3)
        )
        slide_ts = np.full(lcell.shape[0], int(ts[i]), np.int64)
        results.append(sharded_join_halo(
            mesh, plan, lxy, lok, lcell, rxy, rok, rcell, radius,
            max_pairs, ts=slide_ts,
        ))
    return results


# -- registry bucket (qserve) -------------------------------------------------


@functools.lru_cache(maxsize=None)
def _cached_registry_halo(mesh, grid_n, layers, k, num_segments):
    devs = _data_devices(mesh)

    def program(own_p, left_p, right_p, own_q):
        def shard(s):
            p_xy, p_ok, p_cell, p_oid = _with_halo(mesh, s, own_p, left_p,
                                                   right_p)
            qxy, qok, qcell, rad = _on(devs[s], own_q, s)
            return registry_bucket_partitioned_kernel(
                p_xy, p_ok, p_cell, p_oid, qxy, qcell, rad, qok,
                grid_n=grid_n, layers=layers, k=k,
                num_segments=num_segments)

        parts = map_shards(mesh, shard)
        return tuple(_host(parts, i) for i in range(4))

    return instrument_jit(program, name="sharded:registry_halo")


def sharded_registry_bucket_halo(mesh, plan: PartitionPlan, xy: np.ndarray,
                                 valid: np.ndarray, cell: np.ndarray,
                                 oid: np.ndarray, query_xy: np.ndarray,
                                 query_cell: np.ndarray, radius: np.ndarray,
                                 query_valid: np.ndarray, k: int,
                                 num_segments: int):
    """Grid-partitioned standing-query bucket (qserve): queries partition
    by cell (per-query output ownership), and the point side's
    boundary-cell panes halo-exchange, so each query is answered on its
    owner shard alone, with no broadcast of the standing bucket and its
    flag tables and no per-lane reduction. ``plan`` is built for the
    bucket's radius-class ceiling. Bit-equal to
    ``ops/halo.py:registry_bucket_partitioned_kernel`` on the full
    arrays; returns numpy (dist (Q, k), segment (Q, k), num_valid (Q,),
    within (Q,)) in original query order."""
    n_shards = _check_plan(mesh, plan)
    xy = np.asarray(xy)
    q = np.asarray(query_xy).shape[0]
    lp = shard_layout(plan, cell, valid)
    lq = shard_layout(plan, query_cell, query_valid)
    sentinel = plan.num_cells

    def ppane(index_map):
        return (
            gather_rows(index_map, xy, 0.0),
            index_map >= 0,
            gather_rows(index_map, cell, sentinel).astype(np.int32),
            gather_rows(index_map, oid, 0).astype(np.int32),
        )

    pp = ppane(lp.own)
    blp = ppane(lp.left)
    brp = ppane(lp.right)
    qp = (
        gather_rows(lq.own, query_xy, 0.0),
        lq.own >= 0,
        gather_rows(lq.own, query_cell, sentinel).astype(np.int32),
        gather_rows(lq.own, radius, 0.0),
    )
    if faults.armed:
        faults.hit("shard.exchange")
    if n_shards > 1:
        telemetry.account_collective(
            "ppermute", payload_nbytes(*(blp + brp)), axis="data",
            calls=len(blp + brp),
        )
        row_bytes = 2 * xy.dtype.itemsize + 4 + 1 + 4
        telemetry.account_halo_state(lp.live_boundary_rows * row_bytes)
    fn = _cached_registry_halo(mesh, plan.grid_n, plan.layers, int(k),
                               int(num_segments))
    dist2, seg2, nv2, win2 = fn(pp, blp, brp,
                                (qp[0], qp[1], qp[2], qp[3]))
    big = np.finfo(dist2.dtype).max
    return (
        scatter_rows(lq.own, dist2, q, big),
        scatter_rows(lq.own, seg2, q, -1),
        scatter_rows(lq.own, nv2, q, 0),
        scatter_rows(lq.own, win2, q, 0),
    )
