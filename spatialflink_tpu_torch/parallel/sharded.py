"""Sharded window programs over a device mesh: the port of the JAX
package's ``parallel/sharded.py`` (``shard_map`` programs).

Execution is single-process: the counterpart of ``shard_map`` with
``P("data")``/``P()`` specs is ``_shards``, which splits each data-axis
argument along dim 0 into contiguous equal slices (a dim 0 that does
not divide raises, as it does under ``shard_map``), ships slice *i* to
``mesh`` device *i* and copies each replicated argument once per
distinct device. Every shard runs its local program, then the results
reduce on the mesh's first device. No shard writes into its inputs: on a
mesh that repeats a device a slice is a view of the caller's tensor.

The collectives become explicit phases:

  - **range**: points sharded over ``data``; the per-shard outputs
    concatenate (no reduction). On a 2-D mesh the query set also splits
    over ``query`` and the per-point minima reduce by min (JAX's
    ``pmin``).
  - **kNN**: each shard digests its points into per-object (min
    distance, lowest global index) tables; the tables reduce by one
    lexicographic (distance, index) minimum and one top-k runs on the
    result (``ops/knn.py:knn_merge_digests``). This equals JAX's two
    ``pmin``s: the global representative is the lowest index at the
    global minimum, which only shards whose local minimum equals it can
    hold. The per-shard kernels are the unsharded ones, so the mesh
    result is bit-equal to the unsharded run.
  - **join**: the left side shards over ``data``, the right side
    replicates; each shard runs the port's ``join_window`` (B3 on the
    card) or the pruned geometry kernels (B4 gathered) on its slice.
  - **trajectories**: segment reductions sum over shards; the pane
    engine shards contiguous oid blocks with no collective; the
    pane-carry tJoin probes its pane slices per shard and all shards
    apply the gathered contributions.

Every program accounts its collective footprint host-side from static
shapes (``telemetry.account_collective``), with the JAX package's kinds
and byte counts, so a ledger reads alike in both packages.

On a mesh spanning processes (``parallel/multihost.py``), 1-D or 2-D,
every caller holds the whole input; each process runs only the tiles it
owns, and ``mesh.gather_parts`` all-gathers the per-tile parts over the
group before the finish phase, which every process runs alike on its
home device, so every rank's result is bit-equal to the same program on
a mesh in one process. Two programs gather less: the multi-query kNN
merges its own tiles' digests first and gathers one table a process,
and the pane-carry tJoin scan gathers each slide's probe contributions
and applies them to a carry replica on every process.
"""

from __future__ import annotations

import functools
from typing import Callable, Dict, List, Sequence

import numpy as np
import torch

from spatialflink_tpu_torch.parallel.mesh import (
    Mesh,
    all_gather_tensor,
    gather_parts,
    home_device,
    local_shards,
    local_tiles,
    make_mesh,
    map_shards,
    payload_nbytes,
    require_mesh,
    spans_processes,
)
from spatialflink_tpu_torch.parallel.mesh import itemsize as _itemsize
from spatialflink_tpu_torch.telemetry import telemetry


def mesh_from_config(shape, device="cuda"):
    """The runtime mesh of the config's ``deviceMesh`` list (config.py:
    Params.device_mesh, the ``parallelism`` analog of
    conf/geoflink-conf.yml:55). 1-D → ("data",); 2-D → ("data",
    "query"). A product of 1 means unsharded: returns None.

    The data axis must be a power of two: window batches pad to
    power-of-two buckets (utils/padding.py), so only power-of-two axes
    divide every batch. ``device`` is the job's backend: ``cpu`` lists
    the CPU once per shard (the JAX tests' forced host device count);
    ``cuda`` lists the visible cards and raises above their count.

    Inside a joined ``torch.distributed`` group of more than one process
    the mesh spans the group (``multihost.global_mesh``), as the JAX
    package's spans every host's chips after ``jax.distributed.
    initialize``: each process lists its visible cards, or for ``cpu``
    its share of prod(shape), and the device count is the group's."""
    shape = [int(s) for s in shape]
    total = int(np.prod(shape)) if shape else 1
    if total <= 1:
        return None
    if shape[0] & (shape[0] - 1):
        raise ValueError(
            f"deviceMesh data axis must be a power of two (window batches "
            f"are padded to power-of-two buckets); got {shape[0]}"
        )
    names = ("data",) if len(shape) == 1 else ("data", "query")
    cpu = torch.device(device).type == "cpu"
    world = _group_size()
    if world > 1:
        from spatialflink_tpu_torch.parallel.multihost import global_mesh

        local = (["cpu"] * -(-total // world) if cpu else
                 [torch.device("cuda", i)
                  for i in range(torch.cuda.device_count())])
        return global_mesh(local, tuple(shape), names[: len(shape)])
    devices = ["cpu"] * total if cpu else None
    return make_mesh(tuple(shape), names[: len(shape)], devices=devices)


def _group_size() -> int:
    """The joined ``torch.distributed`` group's size, 1 without one."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


# -- the executor: the shard_map counterpart ----------------------------------


def _to(a, dev):
    """A tensor on ``dev`` (no copy when it is there already); anything
    else (scalars, None) as is."""
    if isinstance(a, torch.Tensor):
        return a.to(dev, non_blocking=True)
    return a


def _data_devices(mesh: Mesh) -> List[torch.device]:
    """The devices along the ``data`` axis (the first column of a 2-D
    mesh); ``TypeError`` for anything but a ``Mesh``."""
    d = require_mesh(mesh).devices
    return list(d.reshape(d.shape[0], -1)[:, 0])


def _split(t: torch.Tensor, n: int) -> List[torch.Tensor]:
    """``n`` contiguous equal slices of dim 0 (views)."""
    if t.shape[0] % n:
        raise ValueError(
            f"dim 0 ({t.shape[0]}) of a sharded argument must divide by "
            f"the mesh axis ({n})")
    s = t.shape[0] // n
    return [t[i * s:(i + 1) * s] for i in range(n)]


def _shards(devices: Sequence[torch.device], args: Sequence,
            data_idx: Sequence[int], only: Sequence[int] = None):
    """Per shard (its index, its device, its argument tuple): the
    arguments at ``data_idx`` sliced, the others replicated (one copy a
    distinct device). ``only``: the shards to yield (by default all)."""
    n = len(devices)
    only = range(n) if only is None else only
    pieces = {i: _split(args[i], n) for i in data_idx}
    reps: Dict[torch.device, tuple] = {}
    for s in only:
        dev = devices[s]
        if dev not in reps:
            reps[dev] = tuple(None if i in pieces else _to(a, dev)
                              for i, a in enumerate(args))
        yield s, dev, tuple(_to(pieces[i][s], dev) if i in pieces
                            else reps[dev][i] for i in range(len(args)))


def _shard_parts(mesh, args, data_idx, fn) -> list:
    """``fn(s, dev, sargs)`` over the shards of ``_shards`` that this
    process owns, gathered into a list in shard order
    (``mesh.gather_parts``)."""
    devs = _data_devices(mesh)
    return gather_parts(mesh, {
        s: fn(s, dev, sargs) for s, dev, sargs in _shards(
            devs, args, data_idx, only=local_shards(mesh))}, range(len(devs)))


def _gather(parts: Sequence, dev: torch.device):
    """Shard outputs concatenated along dim 0 on ``dev`` (the tiled
    all-gather); tuples and named tuples field by field."""
    first = parts[0]
    if isinstance(first, torch.Tensor):
        return torch.cat([p.to(dev) for p in parts])
    fields = [_gather([p[i] for p in parts], dev) for i in range(len(first))]
    return type(first)(*fields) if hasattr(first, "_fields") else tuple(
        fields)


def _stack(parts: Sequence[torch.Tensor], dev: torch.device) -> torch.Tensor:
    return torch.stack([p.to(dev) for p in parts])


def _merge_digests(seg_mins, reps, dev):
    """Per-shard (seg_min, rep) tables → the mesh's (seg_min, rep): the
    lexicographic (distance, index) minimum over shards, i.e. JAX's
    ``pmin`` of the minima, then of the representatives at the global
    minimum."""
    from spatialflink_tpu_torch.ops.knn import I32_BIG

    seg = _stack(seg_mins, dev)
    rep = _stack(reps, dev)
    gmin = seg.min(dim=0).values
    qual = seg <= gmin[None]
    return gmin, torch.where(qual, rep, I32_BIG).min(dim=0).values


def _combine_hits(parts):
    return functools.reduce(torch.logical_or, parts)


def _combine_spans(parts):
    from spatialflink_tpu_torch.ops.trajectory import TrajAggregate

    return TrajAggregate(
        functools.reduce(torch.minimum, [p.min_ts for p in parts]),
        functools.reduce(torch.maximum, [p.max_ts for p in parts]))


#: The finish phase of each segment-reduction window kernel (``reduce``
#: programs): how its per-shard tables combine. The JAX kernels reduce
#: in-body through their ``axis_name`` hook (``pmax`` of the hit flags,
#: ``pmin``/``pmax`` of the spans).
_REDUCERS: Dict[str, Callable] = {
    "traj_range_hits_fused": _combine_hits,
    "traj_cell_spans_kernel": _combine_spans,
}


class _ShardedWindow:
    """One fused window kernel over a mesh's ``data`` axis: the
    arguments at ``data_idx`` shard, the rest replicate.

    ``topk``: the kNN window kernels. Each shard calls the kernel with
    ``index_base`` (its slice's offset), which makes it return its
    per-object digest; the digests merge (``_merge_digests``) and one
    top-k runs on the mesh's first device. ``reduce``: a segment
    reduction, its shard tables combined by ``_REDUCERS``. Otherwise
    the outputs stay sharded: they concatenate in shard order."""

    def __init__(self, mesh, kernel, data_idx, topk, reduce, statics):
        self.mesh = mesh
        self.kernel = kernel
        self.data_idx = tuple(data_idx)
        self.topk = topk
        self.reduce = reduce
        self.statics = statics
        if reduce and kernel.__name__ not in _REDUCERS:
            raise ValueError(
                f"no mesh reduction is defined for {kernel.__name__}")

    def __call__(self, *args):
        n = len(_data_devices(self.mesh))
        dev0 = home_device(self.mesh)

        def part(s, _dev, sargs):
            if self.topk:
                base = s * int(args[self.data_idx[0]].shape[0]) // n
                return self.kernel(*sargs, **self.statics, index_base=base)
            return self.kernel(*sargs, **self.statics)

        parts = _shard_parts(self.mesh, args, self.data_idx, part)
        if self.topk:
            from spatialflink_tpu_torch.ops.knn import _finish_topk

            gmin, rep = _merge_digests([p.seg_min for p in parts],
                                       [p.rep for p in parts], dev0)
            return _finish_topk(gmin, rep, self.statics["k"])
        if self.reduce:
            return _REDUCERS[self.kernel.__name__](
                [_to(p, dev0) if isinstance(p, torch.Tensor)
                 else type(p)(*(_to(f, dev0) for f in p)) for p in parts])
        return _gather(parts, dev0)


def sharded_window_kernel(mesh, kernel, data_idx, n_args, topk=False,
                          reduce=False, **statics):
    """A fused window kernel over a mesh's ``data`` axis: the same
    per-window program the unsharded path runs, with the stream-axis
    arguments (positions ``data_idx``) split over ``data`` and the rest
    replicated, the moral equivalent of the reference's keyBy
    partitioning (StreamingJob.java:177, parallelism default 15 at
    conf/geoflink-conf.yml:55) without the shuffle.

    ``topk=False``: elementwise kernels, outputs (keep, dist) sharded
    (concatenated). ``topk=True``: kNN kernels, per-object digests
    merged across shards, outputs replicated. ``reduce=True``: segment
    reductions combined across shards. ``n_args`` is the JAX
    signature's argument count."""
    del n_args
    return _AccountedProgram(
        _ShardedWindow(mesh, kernel, data_idx, topk, reduce, statics),
        tuple(data_idx), topk, reduce, dict(statics))


class _AccountedProgram:
    """Accounts the generic mesh program's collective footprint at call
    time (host-side, from the arguments' shapes), then calls it:
    topk → a ``pmin`` of the per-object minima and representative
    tables ((num_segments,) each); reduce → a ``psum`` of the segment
    table; elementwise → no collective, so the replicated operands'
    broadcast is the traffic. The JAX package's kinds and bytes."""

    __slots__ = ("_fn", "_data_idx", "_topk", "_reduce", "_statics")

    def __init__(self, fn, data_idx, topk, reduce, statics):
        self._fn = fn
        self._data_idx = frozenset(data_idx)
        self._topk = topk
        self._reduce = reduce
        self._statics = statics

    def __call__(self, *args, **kwargs):
        if telemetry.enabled:
            rep = payload_nbytes(*(
                a for i, a in enumerate(args) if i not in self._data_idx
            ))
            if self._topk or self._reduce:
                nseg = int(self._statics.get("num_segments", 0))
                ref = (args[min(self._data_idx)]
                       if self._data_idx and args else None)
                elem = (_itemsize(ref.dtype)
                        if ref is not None and hasattr(ref, "dtype") else 8)
                table = 2 * nseg * elem if nseg else max(rep, elem)
                telemetry.account_collective(
                    "pmin" if self._topk else "psum", table, axis="data"
                )
            if rep:
                telemetry.account_collective("broadcast", rep, axis="data")
        return self._fn(*args, **kwargs)

    def __getattr__(self, attr):
        return getattr(self._fn, attr)


# -- range --------------------------------------------------------------------


def sharded_range_query(mesh, xy, valid, flags, query_xy, radius,
                        approximate: bool = False):
    """Data-parallel range query. ``xy``/``valid``/``flags`` shard over
    ``data``; the query set replicates. Returns (keep, min_dist)
    concatenated in shard order, equal to ``range_query_kernel``."""
    from spatialflink_tpu_torch.ops.range import range_query_kernel

    # Fully local compute: the replicated query set's broadcast is the
    # only cross-device traffic.
    telemetry.account_collective(
        "broadcast", payload_nbytes(query_xy), axis="data"
    )
    parts = _shard_parts(
        mesh, (xy, valid, flags, query_xy), (0, 1, 2),
        lambda _s, _d, a: range_query_kernel(*a, radius,
                                             approximate=approximate))
    return _gather(parts, home_device(mesh))


def sharded_range_query_2d(mesh, xy, valid, flags, query_xy, radius,
                           approximate: bool = False):
    """2-D sharded range query: points over ``data``, the query set over
    ``query``. Each (data, query) tile takes its per-point minimum over
    its query slice; the minima reduce over the ``query`` axis (JAX's
    ``pmin``; a min of mins is exact) and each data tile emits its keep
    mask. Returns (keep, min_dist) over ``data``. On a mesh spanning
    processes each process computes its own tiles' minima, and the
    minima gather by tile before every process reduces them."""
    from spatialflink_tpu_torch.ops.distances import pairwise_distance
    from spatialflink_tpu_torch.ops.range import _emit_mask

    # pmin of each data tile's per-point min-dist vector across the
    # query axis (one lane per point).
    telemetry.account_collective(
        "pmin", int(xy.shape[0]) * _itemsize(xy.dtype), axis="query"
    )
    grid = require_mesh(mesh).devices.reshape(mesh.devices.shape[0], -1)
    nd, nq = grid.shape
    qs = _split(query_xy, nq)
    xs, vs, fs = (_split(a, nd) for a in (xy, valid, flags))
    mins = gather_parts(mesh, {
        (i, j): pairwise_distance(xs[i].to(grid[i, j]),
                                  qs[j].to(grid[i, j])).min(dim=1).values
        for i, j in local_tiles(mesh)},
        [(i, j) for i in range(nd) for j in range(nq)])
    home = home_device(mesh)
    span = spans_processes(mesh)
    keeps, dists = [], []
    for i in range(nd):
        # Each data row finishes on its first device, or on a mesh
        # spanning processes every row on this process's home device.
        dev = home if span else grid[i, 0]
        min_dist = functools.reduce(
            torch.minimum, [m.to(dev) for m in mins[i * nq:(i + 1) * nq]])
        keeps.append(_emit_mask(_to(vs[i], dev), _to(fs[i], dev), min_dist,
                                radius, approximate))
        dists.append(min_dist)
    return _gather(keeps, home), _gather(dists, home)


# -- kNN ----------------------------------------------------------------------


def sharded_knn(mesh, xy, valid, flags, oid, query_xy, radius, k: int,
                num_segments: int):
    """Multi-device kNN: a per-object digest a shard → the lexicographic
    minimum over shards → one top-k. Object ids are global dense ints
    (host interning), so the (num_segments,) tables are the only
    cross-device traffic: one all-reduce instead of the reference's
    windowAll re-shuffle of every candidate."""
    from spatialflink_tpu_torch.ops.distances import point_point_distance
    from spatialflink_tpu_torch.ops.knn import (
        _digest_from_point_dists,
        _finish_topk,
    )

    # Two (num_segments,) pmin tables (minima + packed representatives)
    # plus the replicated query point's broadcast.
    telemetry.account_collective(
        "pmin", 2 * int(num_segments) * _itemsize(xy.dtype), axis="data"
    )
    telemetry.account_collective(
        "broadcast", payload_nbytes(query_xy), axis="data"
    )
    n_loc = int(xy.shape[0]) // len(_data_devices(mesh))

    def digest(s, _dev, sargs):
        xy_l, valid_l, flags_l, oid_l, q = sargs
        dist = point_point_distance(xy_l, q[None, :])
        return _digest_from_point_dists(
            dist, valid_l, flags_l, oid_l, radius, num_segments,
            index_base=s * n_loc)

    digests = _shard_parts(mesh, (xy, valid, flags, oid, query_xy),
                           (0, 1, 2, 3), digest)
    gmin, rep = _merge_digests([d.seg_min for d in digests],
                               [d.rep for d in digests], home_device(mesh))
    return _finish_topk(gmin, rep, k)


def _multi_query_mesh(mesh, xy, valid, cell, flags_tables, oid, query_xy,
                      radius, query_valid, k: int, num_segments: int):
    """The per-query top-k of a query batch over a 1-D or (data, query)
    mesh: each (data, query) tile digests its query slice against its
    point shard, block by block of at most 32 queries; each block's
    digests merge over ``data`` and finish (top-k and the unclamped
    ``within`` count, from the merged table) on the query column's first
    device. Returns (``KnnResult`` with a leading Q axis, ``within``).

    On a mesh spanning processes each process digests only its own
    tiles and merges them, then the block's tables all-gather, one a
    process (``_merge_over_group``), and merge again before the finish
    on its home device. The merge is a lexicographic (distance, index)
    minimum, so the grouping changes no bit. Every rank makes the same
    collectives in the same order: one a column and block."""
    from spatialflink_tpu_torch.ops.knn import (
        KnnResult,
        _multi_query_digest,
        _multi_query_finish,
        _multi_query_lanes,
        check_k,
    )

    check_k(k, num_segments)
    grid = require_mesh(mesh).devices.reshape(mesh.devices.shape[0], -1)
    nd, nq = grid.shape
    q_total = int(query_xy.shape[0])
    if q_total % nq:
        raise ValueError(
            f"the query batch ({q_total}) must divide by the mesh query "
            f"axis ({nq})")
    q_loc = q_total // nq
    block = next(b for b in (32, 16, 8, 4, 2, 1) if q_loc % b == 0)
    n_loc = int(xy.shape[0]) // nd
    span = spans_processes(mesh)
    mine = set(local_tiles(mesh))
    home = home_device(mesh)
    dtype = torch.promote_types(xy.dtype, query_xy.dtype)
    cols = []
    for j in range(nq):
        devs = list(grid[:, j])
        fin = home if span else devs[0]
        q0 = j * q_loc
        # (index base, lanes, xy, cell, tables, queries, radii, validity)
        # per data shard this process owns, each on its tile's device.
        tiles = []
        for s, dev, (xy_l, valid_l, cell_l, oid_l) in _shards(
                devs, (xy, valid, cell, oid), (0, 1, 2, 3),
                only=[s for s in range(nd) if (s, j) in mine]):
            tiles.append((
                _multi_query_lanes(valid_l, oid_l, num_segments, block,
                                   index_base=s * n_loc),
                xy_l, cell_l.long(),
                flags_tables[q0:q0 + q_loc].to(dev),
                query_xy[q0:q0 + q_loc].to(dev),
                radius[q0:q0 + q_loc].to(dev),
                query_valid[q0:q0 + q_loc].to(dev)))
        parts, withins = [], []
        for b0 in range(0, q_loc, block):
            b1 = b0 + block
            digests = [
                _multi_query_digest(lanes, xy_l, cell_l, ft[b0:b1],
                                    qx[b0:b1], rad[b0:b1], qv[b0:b1],
                                    num_segments)
                for lanes, xy_l, cell_l, ft, qx, rad, qv in tiles]
            if span:
                gmin, rep = _merge_over_group(
                    digests, fin, (block, num_segments), dtype)
            else:
                gmin, rep = _merge_digests([d[0] for d in digests],
                                           [d[1] for d in digests], fin)
            res, within = _multi_query_finish(gmin, rep, k)
            parts.append(res)
            withins.append(within)
        cols.append((KnnResult(*(torch.cat(f) for f in zip(*parts))),
                     torch.cat(withins)))
    return (_gather([c[0] for c in cols], home),
            _gather([c[1] for c in cols], home))


def _merge_over_group(digests, dev, shape, dtype):
    """This process's (seg_min, rep) digests of one block merged, then
    all-gathered over the group as one byte table a process (the minima
    then the representatives, one gloo collective) and merged again on
    ``dev``. A process that owns no tile of the column sends the
    merge's identity: every minimum absent, every representative
    ``I32_BIG``."""
    from spatialflink_tpu_torch.ops.knn import I32_BIG, absent_dist

    if digests:
        gmin, rep = _merge_digests([d[0] for d in digests],
                                   [d[1] for d in digests], dev)
    else:
        gmin = torch.full(shape, absent_dist(dtype), dtype=dtype,
                          device=dev)
        rep = torch.full(shape, I32_BIG, dtype=torch.int32, device=dev)
    split = gmin.numel() * gmin.element_size()
    table = torch.cat([gmin.contiguous().view(torch.uint8).reshape(-1),
                       rep.contiguous().view(torch.uint8).reshape(-1)])
    tables = [t.to(dev) for t in all_gather_tensor(table)]
    return _merge_digests(
        [t[:split].view(dtype).view(shape) for t in tables],
        [t[split:].view(torch.int32).view(shape) for t in tables], dev)


def sharded_knn_multi(mesh, xy, valid, cell, flags_tables, oid, query_xy,
                      radius, k: int, num_segments: int):
    """Sharded multi-query kNN: points over ``data``; on a 2-D mesh the
    query batch (and its per-query flag tables) also splits over
    ``query``. Each (data[, query]) tile answers its query slice against
    its point shard; per-object digests reduce over ``data``, one
    reduction a query lane, and the (Q, k) results gather over
    ``query``. The scale-out form of ``ops/knn.py:
    knn_multi_query_kernel``, equal to it row for row. On a 2-D mesh Q
    must divide by the query-axis size."""
    query_sharded = "query" in mesh.shape
    # One batched pmin per query lane (two (num_segments,) tables each);
    # on 1-D meshes the query batch + flag tables replicate (broadcast).
    lanes = int(query_xy.shape[0])
    telemetry.account_collective(
        "pmin", 2 * lanes * int(num_segments) * _itemsize(xy.dtype),
        axis="data", calls=lanes,
    )
    if not query_sharded:
        telemetry.account_collective(
            "broadcast", payload_nbytes(query_xy, flags_tables),
            axis="data",
        )
    dtype = torch.result_type(xy, query_xy)
    radii = torch.as_tensor(radius, device=xy.device).to(dtype).expand(lanes)
    live = torch.ones(lanes, dtype=torch.bool, device=xy.device)
    res, _ = _multi_query_mesh(mesh, xy, valid, cell, flags_tables, oid,
                               query_xy, radii, live, k, num_segments)
    return res


def sharded_registry_bucket(mesh, xy, valid, cell, flags_tables, oid,
                            query_xy, radius, query_valid, k: int,
                            num_segments: int):
    """Sharded standing-query bucket (qserve): points over ``data``, the
    query bucket (coords, per-query radii, flag tables, validity lanes)
    replicated. Per-object digests reduce over ``data`` as in
    ``sharded_knn_multi``, and the ``within`` exactness counter is
    computed on the reduced table, so the results (top-k rows, counts,
    overflow) equal the unsharded ``registry_bucket_kernel``'s."""
    from spatialflink_tpu_torch.ops.query_registry import (
        RegistryBucketResult,
    )

    # Same batched-pmin shape as sharded_knn_multi; the whole standing
    # bucket (coords, radii, flag tables, validity) replicates.
    lanes = int(query_xy.shape[0])
    telemetry.account_collective(
        "pmin", 2 * lanes * int(num_segments) * _itemsize(xy.dtype),
        axis="data", calls=lanes,
    )
    telemetry.account_collective(
        "broadcast",
        payload_nbytes(query_xy, radius, flags_tables, query_valid),
        axis="data",
    )
    res, within = _multi_query_mesh(mesh, xy, valid, cell, flags_tables,
                                    oid, query_xy, radius, query_valid, k,
                                    num_segments)
    return RegistryBucketResult(*res, within)


# -- trajectories -------------------------------------------------------------


def sharded_traj_stats(mesh, xy, ts, oid, valid, num_segments: int):
    """Sequence-parallel trajectory statistics with a halo exchange.

    The (oid, ts)-sorted point sequence shards over ``data``; each shard
    computes its consecutive-point contributions, and the one pair that
    straddles each shard boundary is recovered by handing every shard
    its left neighbour's last point (JAX's ``ppermute`` ring; shard 0
    has no predecessor). Per-object partials then sum over shards.
    Counts and temporal sums equal ``traj_stats_kernel``'s exactly;
    spatial sums reassociate (``ops/trajectory.py:spatial_sum_bound``).
    Returns (spatial, temporal, count, speed)."""
    from spatialflink_tpu_torch.ops.distances import point_point_distance

    devs = _data_devices(mesh)
    # Ring halo (every shard ships its last xy/ts/oid/valid row) plus
    # three (num_segments,) psum tables (spatial, temporal, count).
    ndev = len(devs)
    halo = ndev * (2 * _itemsize(xy.dtype) + _itemsize(ts.dtype)
                   + _itemsize(oid.dtype) + 1)
    telemetry.account_collective("ppermute", halo, axis="data", calls=4)
    telemetry.account_collective(
        "psum", int(num_segments) * (2 * _itemsize(xy.dtype) + 4),
        axis="data", calls=3,
    )
    dev0 = home_device(mesh)
    args = (xy, ts, oid, valid)

    def part(s, dev, sargs):
        xy_l, ts_l, oid_l, valid_l = sargs
        if s:
            halo_row = [_to(_split(a, ndev)[s - 1][-1:], dev) for a in args]
        else:
            halo_row = [xy_l[-1:], ts_l[-1:], oid_l[-1:],
                        torch.zeros_like(valid_l[-1:])]
        xy_e = torch.cat([halo_row[0], xy_l])
        ts_e = torch.cat([halo_row[1], ts_l])
        oid_e = torch.cat([halo_row[2], oid_l])
        valid_e = torch.cat([halo_row[3], valid_l])
        same = (oid_e[1:] == oid_e[:-1]) & valid_e[1:] & valid_e[:-1]
        seg_d = point_point_distance(xy_e[1:], xy_e[:-1])
        seg_t = ts_e[1:].long() - ts_e[:-1].long()
        later = oid_l.long()
        spatial = torch.zeros(num_segments, dtype=seg_d.dtype, device=dev)
        spatial.index_add_(0, later, torch.where(same, seg_d, 0.0))
        temporal = torch.zeros(num_segments, dtype=torch.int64, device=dev)
        temporal.index_add_(0, later, torch.where(same, seg_t, 0))
        count = torch.zeros(num_segments, dtype=torch.int32, device=dev)
        count.index_add_(0, later, valid_l.to(torch.int32))
        return spatial, temporal, count

    parts = _shard_parts(mesh, args, (0, 1, 2, 3), part)
    spatial, temporal, count = (
        functools.reduce(torch.add, [_to(p[i], dev0) for p in parts])
        for i in range(3))
    pos = temporal > 0
    speed = torch.where(pos, spatial / torch.where(pos, temporal, 1), 0.0)
    return spatial, temporal, count, speed


def sharded_traj_stats_pane(mesh, ts_rel, x, y, oid, valid, num_oids: int,
                            slide_ms: int, ppw: int, n_panes: int):
    """Trajectory-parallel pane tStats: the mesh execution of
    ``ops/trajectory.py:traj_stats_pane_kernel``.

    The sharding axis is trajectories, not points: every per-pane
    quantity of the kernel is per-oid independent, so contiguous oid
    blocks shard over ``data`` with no collective, and each block's rows
    equal the unsharded kernel's (the trajectory analog of the
    reference's keyBy(objID); SURVEY §2.2). Inputs are the unsharded
    kernel's host arrays, sorted by (oid, ts) with the padding at the end
    (``valid`` False); they re-partition here into per-shard contiguous
    slices padded to a common bucket. ``num_oids`` must divide by the
    ``data`` axis."""
    # Deliberately no account_collective: per-oid blocks are independent,
    # so the accounted bytes are exactly zero.
    from spatialflink_tpu_torch.ops.trajectory import (
        TrajPaneStats,
        traj_stats_pane_kernel,
    )
    from spatialflink_tpu_torch.utils.padding import next_bucket

    devs = _data_devices(mesh)
    ndev = len(devs)
    if num_oids % ndev:
        raise ValueError(
            f"num_oids ({num_oids}) must divide by the data axis ({ndev})"
        )
    kb = num_oids // ndev
    tp, xp, yp, op_, vp = (np.asarray(a) for a in (ts_rel, x, y, oid, valid))
    live = vp.astype(bool)
    shard_of = op_[live] // kb
    counts = np.bincount(shard_of, minlength=ndev)
    nmax = next_bucket(max(int(counts.max()), 1), minimum=8)
    sh = (ndev, nmax)
    t2 = np.zeros(sh, tp.dtype)
    x2 = np.zeros(sh, xp.dtype)
    y2 = np.zeros(sh, yp.dtype)
    o2 = np.zeros(sh, np.int32)
    v2 = np.zeros(sh, bool)
    tl, xl, yl, ol = tp[live], xp[live], yp[live], op_[live]
    start = 0
    for s in range(ndev):
        c = int(counts[s])
        sl = slice(start, start + c)  # oid-sorted ⇒ contiguous block
        t2[s, :c] = tl[sl]
        x2[s, :c] = xl[sl]
        y2[s, :c] = yl[sl]
        o2[s, :c] = ol[sl] - s * kb
        v2[s, :c] = True
        o2[s, c:] = kb - 1  # local padding stays in-shard
        start += c
    def part(s):
        lanes = [torch.from_numpy(np.ascontiguousarray(a[s])).to(devs[s])
                 for a in (t2, x2, y2, o2, v2)]
        return traj_stats_pane_kernel(*lanes, num_oids=kb, slide_ms=slide_ms,
                                      ppw=ppw, n_panes=n_panes)

    return TrajPaneStats(*_gather(map_shards(mesh, part), home_device(mesh)))


def sharded_tjoin_pane_scan(mesh, carry, ts, lps, rps, radius,
                            lps_expire=None, rps_expire=None, *,
                            grid_n: int, cap_w: int, layers: int, ppw: int,
                            num_ids: int, pair_sel: int, cap_c: int = 0):
    """Accounted mesh entry for ``ops/tjoin_panes.tjoin_pane_scan``.

    Probe-parallel: pane points shard over ``data``; per slide each
    shard probes its slice against the replicated window planes, then
    the contributions of both probe directions gather and every carry
    replica applies the identical digest scatter and pane insert; the
    four overflow counters sum. Equal to the unsharded scan. On a mesh
    spanning processes each process probes its own shards, the
    contributions all-gather over the group and every process's carry
    replicas apply them (``ops/tjoin_panes.py:_scan_mesh``); the carry
    lives on each process's home device.

    The collective footprint is computed here, host-side from static
    shapes, per scan: per slide, both panes' fields (x, y at the field
    dtype; xi/yi/cell/rank/oid int32; valid bool) plus ``2·PC·
    pair_sel`` gathered contribution lanes, and four int32 psums."""
    from spatialflink_tpu_torch.ops.tjoin_panes import tjoin_pane_scan

    n_slides = int(ts.shape[0]) if hasattr(ts, "shape") else len(ts)
    pc = int(lps[0].shape[1])
    fb = _itemsize(lps[0].dtype)
    per_side = pc * (2 * fb + 5 * 4 + 1)
    contrib = 2 * pc * pair_sel * (4 + fb)
    telemetry.account_collective(
        "all_gather", n_slides * (2 * per_side + contrib), axis="data",
        calls=n_slides * 20,
    )
    telemetry.account_collective(
        "psum", n_slides * 16, axis="data", calls=n_slides * 4,
    )
    return tjoin_pane_scan(
        carry, ts, lps, rps, radius, grid_n, cap_w, layers, ppw, num_ids,
        pair_sel, cap_c, lps_expire=lps_expire, rps_expire=rps_expire,
        mesh=mesh)


# -- joins --------------------------------------------------------------------


def _left_cells(left_cell_xy_idx, left_valid, grid_n: int):
    """Flat cells ``xi·n + yi`` of the left side's (xi, yi) indices, the
    out-of-grid cell ``n²`` where ``left_valid`` is False (the callers'
    in-grid mask)."""
    ci = left_cell_xy_idx.long()
    flat = ci[:, 0] * grid_n + ci[:, 1]
    return torch.where(left_valid, flat, grid_n * grid_n).to(torch.int32)


def _layers(neighbor_offsets) -> int:
    """The candidate layers of a (K, 2) neighbour-offset table."""
    off = torch.as_tensor(neighbor_offsets)
    return int(off.abs().max()) if off.numel() else 0


def sharded_join_window_compact(mesh, left_xy, left_valid, left_cell_xy_idx,
                                right_xy, right_valid, right_cells,
                                neighbor_offsets, grid_n: int, radius,
                                cap: int, max_pairs: int):
    """Multi-device grid-hash join for the operator layer: the left side
    sharded over ``data``, the right side replicated, pairs compacted per
    shard (the same ``CompactJoinResult`` and retry contract as the
    unsharded ``join_window``). Each shard runs ``join_window`` (B3 on
    the card) on its slice with a local budget of ``max_pairs /
    n_shards``; ``max_pairs`` rounds up to a multiple of the shard count.

    ``count = max(total, max_local · n_shards)``: a shard past its share
    drops pairs even when the total fits, and the inflated count makes
    the caller's doubling retry fire. ``overflow`` sums over the shards.
    ``left_valid`` is the left side's in-grid mask, as in the JAX
    signature."""
    from spatialflink_tpu_torch.ops.join import CompactJoinResult
    from spatialflink_tpu_torch.ops.join_kernel import join_window

    devs = _data_devices(mesh)
    n_shards = len(devs)
    max_pairs = int(max_pairs) + (-int(max_pairs)) % n_shards
    local_budget = max_pairs // n_shards
    # Replicated right side broadcast once per window; the compaction
    # protocol all-reduces three int32 scalars (total, max_local, over).
    telemetry.account_collective(
        "broadcast",
        payload_nbytes(right_xy, right_valid, right_cells,
                       neighbor_offsets),
        axis="data",
    )
    telemetry.account_collective("psum", 8, axis="data", calls=2)
    telemetry.account_collective("pmax", 4, axis="data")
    layers = _layers(neighbor_offsets)
    left_cells = _left_cells(left_cell_xy_idx, left_valid, grid_n)
    dev0 = home_device(mesh)
    n_loc = int(left_xy.shape[0]) // n_shards

    def part(s, _dev, sargs):
        res = join_window(*sargs, grid_n=grid_n, layers=layers,
                          radius=radius, cap_left=cap, cap_right=cap,
                          max_pairs=local_budget)
        li = res.left_index[:local_budget]
        return (torch.where(li >= 0, li + s * n_loc, -1),
                res.right_index[:local_budget], res.dist[:local_budget],
                res.count, res.overflow)

    lis, ris, dds, counts, overs = zip(*_shard_parts(
        mesh, (left_xy, left_valid, left_cells, right_xy, right_valid,
               right_cells), (0, 1, 2), part))
    left_idx = _gather(lis, dev0)
    count = _stack(counts, dev0)
    total = count.sum(dtype=torch.int32)
    max_local = count.max()
    # Shard outputs concatenate with per-shard padding tails; compact the
    # valid pairs to the front so the caller's [:count] slice works.
    perm = torch.sort((left_idx < 0).to(torch.int8), stable=True).indices
    return CompactJoinResult(
        left_idx[perm], _gather(ris, dev0)[perm], _gather(dds, dev0)[perm],
        torch.maximum(total, max_local * n_shards).to(torch.int32),
        _stack(overs, dev0).sum(dtype=torch.int32))


def sharded_join(mesh, left_xy, left_valid, left_cell_xy_idx,
                 right_xy_sorted, right_valid_sorted, right_cells_sorted,
                 right_order, neighbor_offsets, grid_n: int, radius,
                 cap: int):
    """Grid-hash join with the left side sharded over ``data`` and the
    (smaller) cell-sorted right side replicated, as a dense
    ``JoinResult``: ``pair_mask``/``dist`` (N, M) over the sorted right
    side, ``right_index`` (N, M) each column's original right index
    (``right_order``), ``overflow`` summed over the shards. Each shard
    runs ``join_window`` (B3 on the card) with a budget that grows to
    its pair count; the JAX gather join (``join_kernel``) has no port."""
    from spatialflink_tpu_torch.ops.join import JoinResult
    from spatialflink_tpu_torch.ops.join_kernel import join_window

    # Replicated right-side broadcast + the overflow-scalar psum.
    telemetry.account_collective(
        "broadcast",
        payload_nbytes(right_xy_sorted, right_valid_sorted,
                       right_cells_sorted, right_order, neighbor_offsets),
        axis="data",
    )
    telemetry.account_collective("psum", 4, axis="data")
    layers = _layers(neighbor_offsets)
    left_cells = _left_cells(left_cell_xy_idx, left_valid, grid_n)
    m = int(right_xy_sorted.shape[0])

    def part(_s, dev, sargs):
        lxy, lv, lc, rxy, rv, rc = sargs
        budget = 1024
        while True:
            res = join_window(lxy, lv, lc, rxy, rv, rc, grid_n=grid_n,
                              layers=layers, radius=radius, cap_left=cap,
                              cap_right=cap, max_pairs=budget)
            count = int(res.count)
            if count <= budget:
                break
            budget = count
        li = res.left_index[:count].long()
        ri = res.right_index[:count].long()
        mask = torch.zeros((lxy.shape[0], m), dtype=torch.bool, device=dev)
        dist = torch.full((lxy.shape[0], m), float("inf"),
                          dtype=res.dist.dtype, device=dev)
        mask[li, ri] = True
        dist[li, ri] = res.dist[:count]
        return mask, dist, res.overflow

    masks, dists, overs = zip(*_shard_parts(
        mesh, (left_xy, left_valid, left_cells, right_xy_sorted,
               right_valid_sorted, right_cells_sorted), (0, 1, 2), part))
    dev0 = home_device(mesh)
    pair_mask = _gather(masks, dev0)
    right_index = right_order.to(dev0, torch.int32)[None, :].expand(
        pair_mask.shape[0], m)
    return JoinResult(pair_mask, right_index, _gather(dists, dev0),
                      _stack(overs, dev0).sum(dtype=torch.int32))


def _pruned_pairs(mesh, kernel, data_idx, args, kwargs):
    """A pruned join kernel per shard (the left side sliced at
    ``data_idx``): ``left_index`` offset to global input positions,
    ``count`` stacked into a per-shard (n_shards,) vector (``max_pairs``
    is per shard), both overflow counters summed."""
    from spatialflink_tpu_torch.ops.join import PrunedJoinPairs

    dev0 = home_device(mesh)
    n_loc = int(args[data_idx[0]].shape[0]) // len(_data_devices(mesh))

    def part(s, _dev, sargs):
        res = kernel(*sargs, **kwargs)
        return res._replace(left_index=torch.where(
            res.left_index >= 0, res.left_index + s * n_loc, -1))

    parts = _shard_parts(mesh, args, data_idx, part)
    return PrunedJoinPairs(
        _gather([p.left_index for p in parts], dev0),
        _gather([p.right_index for p in parts], dev0),
        _gather([p.dist for p in parts], dev0),
        _stack([p.count for p in parts], dev0),
        _stack([p.cand_overflow for p in parts], dev0).sum(
            dtype=torch.int32),
        _stack([p.pair_overflow for p in parts], dev0).sum(
            dtype=torch.int32))


def sharded_point_geometry_join_pruned(mesh, pxy, pvalid, gverts, gev,
                                       gvalid, gbbox, radius,
                                       polygonal: bool, block: int,
                                       cand: int, max_pairs: int,
                                       pair_cap: int = 8,
                                       approx: bool = False):
    """Multi-device grid-pruned point ⋈ geometry join: the (host-locality-
    sorted) point side shards over ``data``, the geometry batch
    replicates; each shard runs ``point_geometry_join_pruned_kernel``
    (B4 gathered on the card) on its contiguous slice (contiguous shards
    keep the sorted order, so tile locality survives) and compacts its
    own pairs.

    ``left_index`` entries are global input positions; ``count`` comes
    back as a per-shard (n_shards,) vector (``max_pairs`` is per shard:
    a shard truncates when its own count exceeds it); both overflow
    counters are summed. The pair set equals the unsharded kernel's."""
    from spatialflink_tpu_torch.ops.join import (
        point_geometry_join_pruned_kernel,
    )

    # Replicated geometry batch broadcast + two overflow-scalar psums.
    telemetry.account_collective(
        "broadcast", payload_nbytes(gverts, gev, gvalid, gbbox),
        axis="data",
    )
    telemetry.account_collective("psum", 8, axis="data", calls=2)
    return _pruned_pairs(
        mesh, point_geometry_join_pruned_kernel, (0, 1),
        (pxy, pvalid, gverts, gev, gvalid, gbbox, radius),
        dict(polygonal=polygonal, block=block, cand=cand,
             max_pairs=max_pairs, pair_cap=pair_cap, approx=approx))


def sharded_geometry_geometry_join_pruned(mesh, averts, aev, avalid, abbox,
                                          bverts, bev, bvalid, bbbox,
                                          radius, a_polygonal: bool,
                                          b_polygonal: bool, block: int,
                                          cand: int, max_pairs: int,
                                          pair_cap: int = 8,
                                          approx: bool = False):
    """Multi-device grid-pruned geometry ⋈ geometry join: the left side
    (host-locality-sorted) sharded over ``data``, the right side
    replicated; the contracts of ``sharded_point_geometry_join_pruned``.
    The approximate mode's vertex arguments may be None."""
    from spatialflink_tpu_torch.ops.join import (
        geometry_geometry_join_pruned_kernel,
    )

    # Replicated right geometry batch broadcast + two overflow psums.
    telemetry.account_collective(
        "broadcast", payload_nbytes(bverts, bev, bvalid, bbbox),
        axis="data",
    )
    telemetry.account_collective("psum", 8, axis="data", calls=2)
    data_idx = tuple(i for i, a in enumerate((averts, aev, avalid, abbox))
                     if a is not None)
    return _pruned_pairs(
        mesh, geometry_geometry_join_pruned_kernel, data_idx,
        (averts, aev, avalid, abbox, bverts, bev, bvalid, bbbox, radius),
        dict(a_polygonal=a_polygonal, b_polygonal=b_polygonal, block=block,
             cand=cand, max_pairs=max_pairs, pair_cap=pair_cap,
             approx=approx))
