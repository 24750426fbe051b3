"""Trajectory-stream operators: tRange, tKnn, tJoin, tAggregate, tStats,
tFilter (the reference's ``spatialOperators/t*`` families) as segment
reductions over windowed batches on the operator's device.

The classes, results and signatures are the JAX package's
(``spatialflink_tpu/operators/trajectory.py``), with the concrete Point*
aliases. Output objects mirror the reference's tuples: windowed
sub-trajectory LineStrings, per-cell aggregates, per-trajectory stats.

- ``TJoinQuery``: the point pairs of both ``run`` and ``run_soa`` come
  from the grid-hash join through B3 (``ops/join_kernel.py``), the
  per-trajectory-pair minimum from ``traj_pair_dedup_kernel``; the pair
  budget and the trajectory-pair budget grow to the next power of two
  and persist, as in the JAX operator. ``run_soa_panes`` keeps the window
  on the device in the pane-carry engine (``ops/tjoin_panes.py``, plain
  PyTorch as the JAX engine is plain ``jnp``), for extreme-overlap
  windows.
- ``TRangeQuery`` (dense containment), ``TKNNQuery``
  (``ops/knn.py:knn_points_fused``), ``TStatsQuery`` (segment sums; the
  SoA path sorts on the device) and ``TAggregateQuery`` (per-(cell,
  objID) timestamp spans on the device, the MapState analog in host
  numpy) run their window programs on the device; ``TFilterQuery`` is
  host code.

Every entry point takes ``dtype`` (float64 by default) under the
JAX package's rule (``precision.effective_f64``): with ``dtype``
float64 and the float64 mode on, coordinates go to the device raw and
uncentred in float64, and every distance, radius test, sentinel, carry
and returned distance is float64, B3 running its float64 instantiation;
otherwise the lanes are centred float32 (``operators/base.py:
center_coords``). A ``mesh=`` run takes the same lanes as the unsharded
one.

``TStatsQuery.run`` and ``TJoinQuery.run_soa_panes`` go through the
dataflow driver (``driver.py``), as the JAX operators do;
``run_soa_panes(backend="native")`` runs the JAX package's C++ engine
(``native.py:tjoin_panes_native``) on the host. ``mesh=`` runs each
family's window program sharded (``parallel/sharded.py``): tRange's hit
flags and tAggregate's spans combine across shards, tKnn merges
per-object digests, tStats exchanges a one-point halo, tJoin's point
join shards its left side and the pane-carry tJoin probes its panes in
slices. The JAX
``run_soa``'s ``join_window_bucketed`` branch and its 524,288-pair cap
are TPU VMEM fallbacks and have no counterpart: on the card B3 writes
to HBM.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterable, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from spatialflink_tpu_torch import pipeline
from spatialflink_tpu_torch.models.batch import PointBatch
from spatialflink_tpu_torch.models.objects import LineString, Point, Polygon
from spatialflink_tpu_torch.operators.base import (
    SpatialOperator,
    center_coords,
    check_oid_range,
    count_window_batches,
    flags_for_queries,
    jitted,
    pack_query_geometries,
    ship,
    soa_point_batches,
    window_program,
)
from spatialflink_tpu_torch.operators.join_query import (
    JOIN_LABEL,
    _TaggedEvent,
    _aligned_soa_windows,
    grid_hash_join_batches,
    merge_by_timestamp,
)
from spatialflink_tpu_torch.operators.query_config import QueryType
from spatialflink_tpu_torch.ops.compaction import (
    max_window_cell_count,
    pick_capacity,
)
from spatialflink_tpu_torch.ops.counters import counters
from spatialflink_tpu_torch.ops.join_kernel import join_window
from spatialflink_tpu_torch.ops.knn import knn_points_fused
from spatialflink_tpu_torch.ops.trajectory import (
    traj_cell_spans_kernel,
    traj_pair_dedup_kernel,
    traj_range_hits_fused,
    traj_stats_kernel,
    traj_stats_sorted_fused,
)
from spatialflink_tpu_torch.precision import effective_f64
from spatialflink_tpu_torch.ops.tjoin_panes import (
    pane_cell_ranks,
    tjoin_pane_init,
    tjoin_pane_scan,
)
from spatialflink_tpu_torch.streams.soa import SoaWindowAssembler
from spatialflink_tpu_torch.telemetry import telemetry
from spatialflink_tpu_torch.utils.padding import next_bucket, pad_to_bucket


def _grown(count: int) -> int:
    """The next power of two at or above ``count``: a budget's growth."""
    return int(2 ** np.ceil(np.log2(count)))


def tjoin_pane_fields(grid, ts: np.ndarray, x: np.ndarray, y: np.ndarray,
                      oid: np.ndarray, slide_ms: int, p_first: int,
                      n_slides: int, mesh=None, dtype=np.float32):
    """One side's events → the engine's per-pane fields on the host.

    Events go to pane ``ts // slide_ms - p_first`` (rebased to 0: absolute
    epoch-ms pane indices overflow int32), stable in input order within a
    pane, padded to a power-of-two pane capacity of at least 8. Returns
    ((x, y, xi, yi, cell, rank, oid, valid), each (n_slides, PC): the
    coordinates ``center_coords`` gives for ``dtype`` (centred float32,
    or raw float64 in the float64 mode), int32 cell indices and
    ``pane_cell_ranks``, out-of-grid events invalid in cell 0; the event
    count of each pane; (pane, cell) of the in-grid events, the input of
    ``ops/compaction.py:max_window_cell_count``). Under a ``mesh`` the
    capacity rounds up to a multiple of its ``data`` axis, over which
    the pane points shard."""
    pane = (ts // slide_ms - p_first).astype(np.int64)
    order = np.argsort(pane, kind="stable")
    pane_s = pane[order]
    counts = np.bincount(pane_s, minlength=n_slides).astype(np.int64)
    pc = int(next_bucket(max(int(counts.max()) if len(counts) else 1, 1),
                         minimum=8))
    if mesh is not None:
        nd = int(mesh.shape["data"])
        pc = -(-pc // nd) * nd
    starts = np.concatenate([[0], np.cumsum(counts)])
    lane = np.arange(len(ts)) - starts[pane_s]
    cxy = center_coords(grid, np.stack([x, y], axis=1), dtype)
    xi = np.floor((x - grid.min_x) / grid.cell_length).astype(np.int64)
    yi = np.floor((y - grid.min_y) / grid.cell_length).astype(np.int64)
    ing = (xi >= 0) & (xi < grid.n) & (yi >= 0) & (yi < grid.n)
    cell = np.where(ing, xi * grid.n + yi, 0).astype(np.int32)[order]
    ing = ing[order]
    out = []
    for vals, dt in ((cxy[order, 0], cxy.dtype), (cxy[order, 1], cxy.dtype),
                     (xi[order], np.int32), (yi[order], np.int32),
                     (cell, np.int32),
                     (pane_cell_ranks(pane_s, cell, valid=ing), np.int32),
                     (oid[order], np.int32), (ing, bool)):
        f = np.zeros((n_slides, pc), dt)
        f[pane_s, lane] = vals
        out.append(f)
    return tuple(out), counts, (pane_s[ing], cell[ing])


def sub_trajectory(events: Sequence[Point], obj_id: str,
                   win_start: int) -> LineString:
    """Windowed sub-trajectory LineString: one objID's points sorted by
    ts, a stable sort (GenerateWindowedTrajectory,
    tJoin/TJoinQuery.java:165-192)."""
    pts = sorted(events, key=lambda p: p.timestamp)
    coords = np.array([[p.x, p.y] for p in pts], float)
    return LineString(obj_id=obj_id, timestamp=win_start, coords=coords)


def group_by_oid(events: Sequence[Point]) -> Dict[str, List[Point]]:
    groups: Dict[str, List[Point]] = {}
    for p in events:
        groups.setdefault(p.obj_id, []).append(p)
    return groups


class _TrajectoryOperator(SpatialOperator):
    def __init__(self, conf, grid, device="cuda", mesh=None):
        super().__init__(conf, grid, device=device, mesh=mesh)

    def _window_lanes(self, batch: PointBatch, dtype):
        """A point batch's xy, valid, cell and oid lanes on the device, xy
        as ``center_coords`` gives it for ``dtype`` (centred float32, or
        raw float64 in the float64 mode)."""
        return ship(center_coords(self.grid, batch.xy, dtype), batch.valid,
                    batch.cell, batch.oid, device=self.device).arrive()


# ---------------------------------------------------------------------------
# tRange


@dataclass
class TRangeResult:
    start: int
    end: int
    trajectories: List[LineString]  # one windowed sub-trajectory per hit
    window_count: int


class TRangeQuery(_TrajectoryOperator):
    """Trajectory range against a polygon set: a trajectory qualifies
    when any of its window points lies inside any query polygon
    (tRange/TRangeQuery.java:33-63, PointPolygonTRangeQuery.java:53-177).
    Containment is dense over the query set."""

    def _queries(self, query_polygons, dtype):
        verts, ev = pack_query_geometries(query_polygons)
        return (self.device_verts(verts, dtype),
                *ship(ev, device=self.device).arrive())

    def run(self, stream: Iterable[Point], query_polygons: Sequence[Polygon],
            dtype=np.float64, mesh=None) -> Iterator[TRangeResult]:
        """One ``TRangeResult`` per fired window; the containment runs in
        the lanes of ``dtype`` (float64 in the float64 mode). ``mesh``
        (default the operator's): the points shard over its ``data``
        axis and the per-trajectory hit flags combine (JAX's ``pmax``)."""
        mesh = self.run_mesh(mesh)
        qv, qe = self._queries(query_polygons, dtype)
        for win in self.windows(stream):
            batch = self.point_batch(win.events)
            nseg = next_bucket(max(self.interner.num_segments, 1),
                               minimum=64)
            xy, valid, _, oid = self._window_lanes(batch, dtype)
            hits = telemetry.fetch(window_program(
                mesh, traj_range_hits_fused, (0, 1, 2), 5, reduce=True,
                num_segments=nseg)(xy, valid, oid, qv, qe))
            out = [
                sub_trajectory(evs, oid_str, win.start)
                for oid_str, evs in group_by_oid(win.events).items()
                if hits[self.interner.intern(oid_str)]
            ]
            yield TRangeResult(win.start, win.end, out, len(win.events))

    def run_soa(self, chunks, query_polygons: Sequence[Polygon],
                num_segments: int, dtype=np.float64):
        """SoA path: point chunks ``{"ts", "x", "y", "oid"}`` (dense int32
        oids in [0, num_segments)) → per window ``(start, end, hit_oids,
        window_count)``, with no per-object Python; ``dtype`` as in
        ``run``."""
        qv, qe = self._queries(query_polygons, dtype)
        for win, xy, valid, _, oid in soa_point_batches(self.grid, chunks,
                                                        self.conf, dtype):
            check_oid_range(oid[:win.count], num_segments)
            xy_d, valid_d, oid_d = ship(xy, valid, oid,
                                        device=self.device).arrive()
            hits = telemetry.fetch(jitted(traj_range_hits_fused)(
                xy_d, valid_d, oid_d, qv, qe, num_segments))
            yield (win.start, win.end, np.flatnonzero(hits), win.count)


class PointPolygonTRangeQuery(TRangeQuery):
    """tRange/PointPolygonTRangeQuery.java."""


# ---------------------------------------------------------------------------
# tKnn


@dataclass
class TKnnResult:
    start: int
    end: int
    neighbors: List[Tuple[str, float, LineString]]  # (objID, minDist, traj)
    window_count: int


class TKNNQuery(_TrajectoryOperator):
    """The k trajectories nearest a query point: each objID's minimum
    distance over the window, the top k, each as its windowed
    sub-trajectory (tKnn/TKNNQuery.java:50-163,
    PointPointTKNNQuery.java:181-310). ``k`` above the window's bucketed
    segment count raises ``ValueError``, as the reference's top-k does."""

    def _query(self, query_point, radius, dtype):
        flags = flags_for_queries(self.grid, radius, [query_point])
        (flags_d,) = ship(flags, device=self.device).arrive()
        return flags_d, self.device_q([query_point.x, query_point.y], dtype)

    def run(self, stream: Iterable[Point], query_point: Point, radius: float,
            k: int, dtype=np.float64, mesh=None) -> Iterator[TKnnResult]:
        """One ``TKnnResult`` per fired window, distances computed in the
        lanes of ``dtype`` (float64 in the float64 mode). ``mesh``
        (default the operator's): the points shard over its ``data`` axis
        and the per-trajectory digests merge before the top-k."""
        mesh = self.run_mesh(mesh)
        flags_d, q = self._query(query_point, radius, dtype)
        for win in self.windows(stream):
            batch = self.point_batch(win.events)
            nseg = next_bucket(max(self.interner.num_segments, 1),
                               minimum=64)
            xy, valid, cell, oid = self._window_lanes(batch, dtype)
            res = window_program(
                mesh, knn_points_fused, (0, 1, 2, 4), 7, topk=True, k=k,
                num_segments=nseg)(xy, valid, cell, flags_d, oid, q, radius)
            nv = int(telemetry.fetch(res.num_valid))
            segs, dists = telemetry.fetch((res.segment[:nv], res.dist[:nv]))
            groups = group_by_oid(win.events)
            out = []
            for s, d in zip(segs, dists):
                oid_str = self.interner.lookup(int(s))
                out.append((oid_str, float(d),
                            sub_trajectory(groups[oid_str], oid_str,
                                           win.start)))
            yield TKnnResult(win.start, win.end, out, len(win.events))

    def run_soa(self, chunks, query_point: Point, radius: float, k: int,
                num_segments: int, dtype=np.float64):
        """SoA path: per window, the k nearest trajectories as ``(start,
        end, oids, min_dists, num_valid)`` arrays: the kNN's per-objID
        segment-min is the per-trajectory minimum distance; the distances
        are float64 in the float64 mode."""
        flags_d, q = self._query(query_point, radius, dtype)
        for win, xy, valid, cell, oid in soa_point_batches(self.grid, chunks,
                                                           self.conf, dtype):
            xy_d, valid_d, cell_d, oid_d = ship(
                xy, valid, cell, oid, device=self.device).arrive()
            res = jitted(knn_points_fused)(xy_d, valid_d, cell_d, flags_d,
                                           oid_d, q, radius, k, num_segments)
            nv = int(telemetry.fetch(res.num_valid))
            segs, dists = telemetry.fetch((res.segment[:nv], res.dist[:nv]))
            yield (win.start, win.end, segs, dists, nv)


class PointPointTKNNQuery(TKNNQuery):
    """tKnn/PointPointTKNNQuery.java."""


# ---------------------------------------------------------------------------
# tJoin


@dataclass
class TJoinResult:
    start: int
    end: int
    pairs: List[Tuple[LineString, LineString, float]]  # (traj, qTraj, dist)
    window_count: int


def _local_ranks(oid: np.ndarray, count: int):
    """Window-local dense trajectory ranks of a padded oid lane: the
    window's distinct ids, each lane's rank among them (0 on padding),
    and the rank space bucketed to a power of two of at least 16."""
    uniq, inv = np.unique(oid[:count], return_inverse=True)
    loc = np.zeros(len(oid), np.int32)
    loc[:count] = inv
    return uniq, loc, int(next_bucket(max(len(uniq), 1), minimum=16))


_SOA_COLUMNS = (("ts", np.int64), ("x", np.float64), ("y", np.float64),
                ("oid", np.int32))


def _collect_chunks(chunks):
    """SoA chunks ``{"ts", "x", "y", "oid"}`` → one (ts int64, x float64,
    y float64, oid int32) array each."""
    chunks = list(chunks)
    return tuple(
        np.concatenate([np.asarray(c[k], dt) for c in chunks]) if chunks
        else np.zeros(0, dt) for k, dt in _SOA_COLUMNS)


class _PaneScan:
    """The pane-carry engine's scans of one stream (``run_soa_panes``'s
    retry scans it again with other budgets): each call starts a fresh
    carry on ``device`` and returns the three counters, read once, and
    the (n_slides, K²) window minima.

    With no ``pipeline`` policy installed, the fields are shipped once
    and one scan runs over every slide. Under a policy the slides run in
    segments through ``pipeline.PipelinedExecutor``: segment N+1's fields
    copy on a side stream while segment N computes, and segment N-1's
    minima come back. Segments chain the carry, all have one length
    (trailing pad panes are empty: they cannot fire, overflow or touch
    the ring) and each gets its expiring panes from the whole stream (a
    continued carry is not empty, so a segment's own panes would expire
    the wrong ones); the rows equal the one scan's."""

    def __init__(self, device, lfields, rfields, radius, grid_n: int,
                 layers: int, ppw: int, num_ids: int, mesh, dtype):
        # A mesh scan keeps its carry on the mesh's home device: its first
        # device, or this process's first on a mesh spanning processes.
        if mesh is not None:
            from spatialflink_tpu_torch.parallel.mesh import home_device

            device = home_device(mesh)
        self.device = device
        self.mesh = mesh
        self.fields = (lfields, rfields)
        self.n_slides = lfields[0].shape[0]
        self.radius, self.grid_n, self.layers = radius, grid_n, layers
        self.ppw, self.num_ids = ppw, num_ids
        self.dtype = dtype
        self.pol = pipeline.policy()
        self._shipped = None

    def run(self, cap_w: int, pair_sel: int, cap_c: int):
        carry = tjoin_pane_init(self.grid_n * self.grid_n, cap_w, self.ppw,
                                self.num_ids, self.dtype, device=self.device)
        args = (self.radius, self.grid_n, cap_w, self.layers, self.ppw,
                self.num_ids, pair_sel, cap_c)
        if self.pol is None or self.n_slides <= 1 or self.mesh is not None:
            # A mesh scan is one monolithic probe-parallel scan, as in
            # the JAX package.
            if self._shipped is None:
                self._shipped = [ship(*f, device=self.device).arrive()
                                 for f in self.fields]
            if self.mesh is not None:
                from spatialflink_tpu_torch.parallel.sharded import (
                    sharded_tjoin_pane_scan,
                )

                carry, wmins = sharded_tjoin_pane_scan(
                    self.mesh, carry, range(self.n_slides), *self._shipped,
                    self.radius, grid_n=self.grid_n, cap_w=cap_w,
                    layers=self.layers, ppw=self.ppw, num_ids=self.num_ids,
                    pair_sel=pair_sel, cap_c=cap_c)
            else:
                carry, wmins = jitted(tjoin_pane_scan)(
                    carry, range(self.n_slides), *self._shipped, *args)
            wmins = telemetry.fetch(wmins)
        else:
            carry, wmins = self._segmented(carry, args)  # fetched there
        counters = torch.stack([carry.cap_overflow, carry.sel_overflow,
                                carry.cmp_overflow]).tolist()
        return (*counters, wmins)

    def _segmented(self, carry, args):
        n, ppw, dev = self.n_slides, self.ppw, self.device
        n_seg = min(n, max(2, 2 * int(self.pol.depth)))
        seg_len = -(-n // n_seg)
        n_seg = -(-n // seg_len)
        total = n_seg * seg_len
        lf, rf = (tuple(np.concatenate(
            [a, np.zeros((total - n,) + a.shape[1:], a.dtype)]) for a in f)
            for f in self.fields)
        side = torch.cuda.Stream(dev) if dev.type == "cuda" else None
        state = {"carry": carry}

        def expiring(fields, s0):
            # (cell, valid) of pane s - ppw for each slide s of the
            # segment; zeros while the window fills.
            idx = np.arange(s0, s0 + seg_len) - ppw
            take = idx >= 0
            out = []
            for a in (fields[4], fields[7]):
                e = np.zeros((seg_len,) + a.shape[1:], a.dtype)
                e[take] = a[idx[take]]
                out.append(e)
            return out

        def ship_stage(seg):
            s0 = seg * seg_len
            return s0, [ship(*f, device=dev, stream=side) for f in (
                [a[s0:s0 + seg_len] for a in lf],
                [a[s0:s0 + seg_len] for a in rf],
                expiring(lf, s0), expiring(rf, s0))]

        def compute_stage(seg, staged):
            s0, parts = staged
            lfd, rfd, lxd, rxd = (p.arrive() for p in parts)
            state["carry"], w = jitted(tjoin_pane_scan)(
                state["carry"], range(s0, s0 + seg_len), lfd, rfd, *args,
                lps_expire=lxd, rps_expire=rxd)
            return w

        def fetch_stage(works):
            return list(telemetry.fetch(works))  # one wait per batch

        ex = pipeline.PipelinedExecutor(
            self.pol, ship=ship_stage, compute=compute_stage,
            fetch=fetch_stage, label="tjoin_scan")
        rows = np.concatenate(list(ex.run(range(n_seg))))
        return state["carry"], rows[:n]


class TJoinQuery(_TrajectoryOperator):
    """Trajectory join: trajectory pairs whose points come within r in a
    window, each pair once, as paired windowed sub-trajectories
    (tJoin/TJoinQuery.java:60-154, PointPointTJoinQuery.java:183+). A
    pair's distance is its minimum point distance in the window (the
    JAX package's documented deviation from the reference's latest
    pair: same pair set). ``run_single`` self-joins one stream.

    Results are exact iff no cell exceeds ``cap`` (``overflow == 0``).
    ``pair_budget`` and ``tpair_budget`` start the point-pair and
    trajectory-pair budgets (the JAX operator's ``_max_pairs`` and
    ``_max_tpairs``), for a port operator that resumes a JAX one
    (``state.trajectory_state_from_jax``).

    After ``run_soa_panes``, ``pane_occupancy`` holds the planned live
    occupancy (None when ``cap_c`` was given) and ``pane_scans`` one
    ``(cap_w, pair_sel, cap_c, cap_overflow, sel_overflow,
    cmp_overflow)`` a scan of the stream, the retries included: what the
    JAX operator records in its telemetry."""

    def __init__(self, conf, grid, cap: int = 64, device="cuda",
                 pair_budget: int = 0, tpair_budget: int = 256, mesh=None):
        super().__init__(conf, grid, device=device, mesh=mesh)
        self.cap = cap
        self._max_pairs = int(pair_budget)
        self._max_tpairs = int(tpair_budget)
        self.pane_occupancy: Optional[int] = None
        self.pane_scans: List[Tuple[int, ...]] = []

    def _dedup(self, res, l_loc, r_loc, num_l: int, num_r: int):
        """The window's distinct trajectory pairs, rerun with the next
        power of two of their count when it exceeds the budget (which
        persists across windows)."""
        while True:
            tp = jitted(traj_pair_dedup_kernel)(
                res.left_index, res.right_index, res.dist, l_loc, r_loc,
                num_l, num_r, self._max_tpairs)
            count = int(tp.count)
            if count <= self._max_tpairs:
                return tp
            self._max_tpairs = _grown(count)

    def run(self, stream: Iterable[Point], query_stream: Iterable[Point],
            radius: float, dtype=np.float64,
            mesh=None) -> Iterator[TJoinResult]:
        """One ``TJoinResult`` per fired window of the two merged streams,
        pairs sorted by (left objID, right objID, distance). The point
        join runs in the lanes of ``dtype``: float64 in the float64 mode,
        through B3's float64 instantiation on the card, its distances
        float64. ``mesh`` (default the operator's): the point join shards
        the left side over its ``data`` axis (``grid_hash_join_batches``)."""
        mesh = self.run_mesh(mesh)
        merged = (
            _TaggedEvent(ev.timestamp, tag, ev)
            for tag, ev in merge_by_timestamp(stream, query_stream)
        )
        for win in self.windows(merged):
            left_ev = [t.event for t in win.events if t.tag == 0]
            right_ev = [t.event for t in win.events if t.tag == 1]
            if not left_ev or not right_ev:
                yield TJoinResult(win.start, win.end, [], len(win.events))
                continue
            lb = self.point_batch(left_ev)
            rb = self.point_batch(right_ev)
            self._max_pairs = max(
                self._max_pairs, 1024, min(4 * lb.capacity, 262_144)
            )
            while True:
                res = grid_hash_join_batches(
                    self.grid, lb, rb, radius, self.cap, self._max_pairs,
                    self.device, mesh=mesh, dtype=dtype)
                count = int(res.count)
                if count <= self._max_pairs:
                    break
                self._max_pairs = _grown(count)
            l_uniq, l_loc, num_l = _local_ranks(lb.oid, len(left_ev))
            r_uniq, r_loc, num_r = _local_ranks(rb.oid, len(right_ev))
            l_loc_d, r_loc_d = ship(l_loc, r_loc, device=self.device).arrive()
            tp = self._dedup(res, l_loc_d, r_loc_d, num_l, num_r)
            keys, tdist = telemetry.fetch((tp.pair_key, tp.dist))
            hit = keys >= 0
            kk = keys[hit]
            dists = tdist[hit]
            found = sorted(
                (self.interner.lookup(int(a)), self.interner.lookup(int(b)),
                 float(d))
                for a, b, d in zip(l_uniq[kk // num_r], r_uniq[kk % num_r],
                                   dists)
            )
            # Each trajectory is built once a window, however many pairs
            # it is in.
            lgroups = group_by_oid(left_ev)
            rgroups = group_by_oid(right_ev)
            ltraj = {a: sub_trajectory(lgroups[a], a, win.start)
                     for a in {a for a, _, _ in found}}
            rtraj = {b: sub_trajectory(rgroups[b], b, win.start)
                     for b in {b for _, b, _ in found}}
            pairs = [(ltraj[a], rtraj[b], d) for a, b, d in found]
            yield TJoinResult(win.start, win.end, pairs, len(win.events))

    def run_single(self, stream, radius, dtype=np.float64):
        """Self-join: pairs within one stream, identity pairs excluded
        (PointPointTJoinQuery.runSingle:57); ``dtype`` as in ``run``."""
        events = list(stream)
        for res in self.run(iter(events), iter(list(events)), radius,
                            dtype=dtype):
            res.pairs = [
                (a, b, d) for a, b, d in res.pairs if a.obj_id != b.obj_id
            ]
            yield res

    def run_soa(self, left_chunks, right_chunks, radius: float,
                num_segments: int, max_pairs: int = 262_144,
                dtype=np.float64):
        """SoA path: two point chunk streams ``{"ts", "x", "y", "oid"}``
        (dense int32 oids in [0, num_segments)) → per window ``(start,
        end, left_oids, right_oids, min_dists, count, overflow)``: the
        point join through B3 and the trajectory-pair dedup on the
        device; the host relabels window-local ranks (one ``np.unique`` a
        side) and decodes the pair list, in ascending pair-key order.
        Exact iff ``overflow == 0``. The lanes, the join through B3 and
        the distances are float64 in the float64 mode, float32 otherwise.
        Windows align on the shared slide grid; a one-sided window yields
        empty arrays (distances of that dtype) and zeros. The point-pair
        budget starts at ``max_pairs`` and grows within the run."""
        layers = self.grid.candidate_layers(radius)
        gen_l = soa_point_batches(self.grid, left_chunks, self.conf, dtype)
        gen_r = soa_point_batches(self.grid, right_chunks, self.conf, dtype)
        no_dist = np.empty(0, np.float64 if effective_f64(dtype)
                           else np.float32)
        budget = max_pairs
        for kind, wl, wr in _aligned_soa_windows(
            gen_l, gen_r, lambda w: w[0].start, lambda w: w[0].start
        ):
            if kind != "both":
                w = wl[0] if kind == "left" else wr[0]
                yield (w.start, w.end, np.empty(0, np.int32),
                       np.empty(0, np.int32), no_dist.copy(), 0, 0)
                continue
            win, lxy, lvalid, lcell, loid = wl
            rwin, rxy, rvalid, rcell, roid = wr
            check_oid_range(loid[:win.count], num_segments)
            check_oid_range(roid[:rwin.count], num_segments)
            l_uniq, l_loc, num_l = _local_ranks(loid, win.count)
            r_uniq, r_loc, num_r = _local_ranks(roid, rwin.count)
            # Shipped once; every retry reuses the device lanes.
            *lanes, l_loc_d, r_loc_d = ship(
                lxy, lvalid, lcell, rxy, rvalid, rcell, l_loc, r_loc,
                device=self.device).arrive()
            while True:
                res = jitted(join_window, JOIN_LABEL)(
                    *lanes, grid_n=self.grid.n, layers=layers, radius=radius,
                    cap_left=self.cap, cap_right=self.cap, max_pairs=budget)
                count = int(res.count)
                if count <= budget:
                    break
                budget = _grown(count)
            tp = self._dedup(res, l_loc_d, r_loc_d, num_l, num_r)
            keys, tdist = telemetry.fetch((tp.pair_key, tp.dist))
            hit = keys >= 0
            kk = keys[hit]
            yield (
                win.start, win.end,
                l_uniq[kk // num_r].astype(np.int32),
                r_uniq[kk % num_r].astype(np.int32),
                tdist[hit], int(hit.sum()),
                int(res.overflow),
            )

    def _device_pane_scan(self, lfields, rfields, locc, rocc, radius,
                          layers, ppw, num_segments, cap_w, pair_sel,
                          cap_c, mesh, dtype):
        """``run_soa_panes``' device engine: the compacted probe's
        capacity planned on the host (``cap_c=None``), then the scan,
        again with a grown budget whenever a counter overflowed. Records
        ``pane_occupancy`` and ``pane_scans``; returns the (n_slides, K²)
        window minima."""
        occ = None
        if cap_c is None:
            # The host reads the exact live occupancy and picks the rung:
            # the device program only ever sees the fixed capacity.
            with telemetry.span("compaction.plan", engine="tjoin_pane_scan"):
                occ = max(max_window_cell_count(*locc, ppw),
                          max_window_cell_count(*rocc, ppw))
                cap_c = pick_capacity(occ, cap_w)
            telemetry.record_compaction("tjoin_pane_scan", cap_c, occ)
        self.pane_occupancy, self.pane_scans = occ, []
        scan = _PaneScan(self.device, lfields, rfields, radius, self.grid.n,
                         layers, ppw, num_segments, mesh, dtype)
        while True:
            cap_over, sel_over, cmp_over, wmins = scan.run(
                cap_w, pair_sel, cap_c)
            self.pane_scans.append((cap_w, pair_sel, cap_c, cap_over,
                                    sel_over, cmp_over))
            if cap_over == 0 and sel_over == 0 and cmp_over == 0:
                return wmins
            # Grow whichever budget overflowed and scan again.
            if cap_over:
                cap_w *= 2
                if occ is not None:  # re-pick under the new cap
                    cap_c = pick_capacity(occ, cap_w)
            if sel_over:
                pair_sel *= 2
            if cmp_over and cap_c:
                # Only a forced or stale cap_c can be too small: climb.
                # The occupancy was not measured, only that it exceeded
                # the old rung: that lower bound is what is recorded.
                live_floor = cap_c + 1
                cap_c = min(max(cap_c * 2, cap_c + 1), cap_w)
                telemetry.record_compaction("tjoin_pane_scan", cap_c,
                                            live_floor)

    def run_soa_panes(self, left_chunks, right_chunks, radius: float,
                      num_segments: int, cap_w: int = 64, pair_sel: int = 16,
                      dtype=np.float64, mesh=None, backend: str = "auto",
                      cap_c: Optional[int] = None, driver=None):
        """Extreme-overlap sliding tJoin through the pane-carry engine
        (``ops/tjoin_panes.py``): the window state stays on the device in
        ring-buffer planes and each slide joins only the new pane, so 10 s
        windows sliding by 10 ms (ppw = 1000) do not pay ``run_soa``'s
        full-window join a slide. Yields ``run_soa``'s per-window tuples
        ``(start, end, left_oids, right_oids, min_dists, count, overflow)``
        with the same pair sets and minimum distances, pairs in ascending
        flat-key order (left id, then right id) and distances float64,
        empty windows included.

        Bounded streams of in-order events: when a counter of the engine
        overflows, the whole stream is scanned again with ``cap_w`` or
        ``pair_sel`` doubled or ``cap_c`` one rung up, so the result is
        exact. A window fires when it holds an event on either side. The
        digest ring takes ppw·num_segments²·4 bytes and the stacked
        window minima n_slides·num_segments²·4; past 2 GB either raises
        ``ValueError``.

        ``cap_c``: the compacted probe's capacity. None always plans the
        compacted probe, its capacity taken on the host from the stream's
        exact per-cell window occupancy (``ops/compaction.py``); 0 forces
        the full-ring probe; a positive value seeds the ladder, which the
        retry still climbs.

        ``backend``: "device" runs the engine on the operator's device;
        "native" the JAX package's C++ engine (``native/sfnative.cpp:
        sf_tjoin_panes``) on the host, exact by construction: no ranks,
        no ``pick_capacity``, no retry, a dense (n_slides, K²) minimum
        matrix computed in float64 from the pane fields' coordinates
        (centred float32, or raw float64 in the float64 mode); it raises
        ``RuntimeError`` when the native library is unavailable. "auto"
        follows the JAX rule with the card in the
        TPU's place: the native engine when the library is available
        and either the overload ``pane_backend`` rung says "native" or
        the operator's device is not CUDA, else the device engine (a
        rung never becomes a crash). Under an installed ``pipeline``
        policy the device engine's scan
        runs in segments that ship ahead of their compute, each segment
        given its expiring panes, with results equal to the one scan.
        ``dtype``: the JAX rule (``precision.effective_f64``); in the
        float64 mode the pane fields are raw float64 coordinates and the
        device engine's carry, radius test and minima float64. The
        digest guard stays the JAX package's ppw·K²·4 bytes in either
        dtype. ``mesh`` (default the operator's): probe-parallel device
        scans (``parallel/sharded.py:sharded_tjoin_pane_scan``), the pane
        capacity a multiple of its ``data`` axis; "auto" then takes the
        device engine and "native" raises ``ValueError``. Windows go out
        through the dataflow driver's ``run_precomputed``: with
        ``driver=`` a checkpoint counts the windows emitted, and a resume
        over the replayed bounded chunks rescans and skips the committed
        prefix."""
        mesh = self.run_mesh(mesh)
        conf = self.conf
        size, slide = conf.window_size_ms, conf.slide_step_ms
        if size % slide != 0:
            raise ValueError("run_soa_panes requires size % slide == 0")
        if conf.allowed_lateness_ms > 0:
            raise ValueError(
                "run_soa_panes does not support allowed_lateness; use "
                "run_soa()")
        ppw = size // slide
        g = self.grid
        budget = ppw * num_segments * num_segments * 4
        if budget > 2 << 30:
            raise ValueError(
                f"pane digest memory ppw·K² = {budget / 1e9:.1f} GB "
                "exceeds the 2 GB guard; reduce num_segments or overlap")
        lt, lx, ly, lo = _collect_chunks(left_chunks)
        rt, rx, ry, ro = _collect_chunks(right_chunks)
        check_oid_range(lo, num_segments)
        check_oid_range(ro, num_segments)
        if len(lt) == 0 and len(rt) == 0:
            return
        all_t = np.concatenate([lt, rt])
        p_first = int(all_t.min() // slide)
        # Trailing empty panes flush the windows that still hold the last
        # events (the assembler's end-of-stream flush).
        n_slides = int(all_t.max() // slide) - p_first + 1 + ppw - 1
        out_bytes = n_slides * num_segments * num_segments * 4
        if out_bytes > 2 << 30:
            raise ValueError(
                f"pane scan output n_slides·K² = {out_bytes / 1e9:.1f} GB "
                f"exceeds the 2 GB guard ({n_slides} slides); feed the "
                "stream in shorter bounded chunks or reduce num_segments")
        if backend not in ("auto", "device", "native"):
            raise ValueError(f"unknown tjoin panes backend {backend!r}")
        use_native = False
        if backend == "native" and mesh is not None:
            raise ValueError("backend='native' cannot run on a mesh")
        if backend != "device" and mesh is None:
            from spatialflink_tpu_torch import native as _native
            from spatialflink_tpu_torch import overload as _overload

            native_ok = _native.available()
            if backend == "native":
                if not native_ok:
                    raise RuntimeError(
                        "backend='native' was forced but the native library "
                        "is unavailable (build native/ with make); refusing "
                        "to run the device engine in its place")
                use_native = True
            else:
                # An active pane_backend "native" rung biases auto toward
                # the native engine, freeing the device; a missing library
                # keeps the device engine: a rung never becomes a crash.
                use_native = native_ok and (
                    _overload.pane_backend() == "native"
                    or self.device.type != "cuda")
        lfields, lcounts, locc = tjoin_pane_fields(
            g, lt, lx, ly, lo, slide, p_first, n_slides, mesh, dtype)
        rfields, rcounts, rocc = tjoin_pane_fields(
            g, rt, rx, ry, ro, slide, p_first, n_slides, mesh, dtype)
        layers = g.candidate_layers(radius)
        if use_native:
            def flat(fields):
                fx, fy, _xi, _yi, fcell, _rank, fo, fv = fields
                m = fv.ravel()
                pane = np.repeat(np.arange(fv.shape[0], dtype=np.int32),
                                 fv.shape[1])[m]
                return (pane, fx.ravel()[m], fy.ravel()[m],
                        fcell.ravel()[m], fo.ravel()[m])

            self.pane_occupancy, self.pane_scans = None, []
            wmins = _native.tjoin_panes_native(
                *flat(lfields), *flat(rfields),
                n_slides, g.n, layers, ppw, num_segments, radius)
        else:
            wmins = self._device_pane_scan(
                lfields, rfields, locc, rocc, radius, layers, ppw,
                num_segments, cap_w, pair_sel, cap_c, mesh, dtype)

        def rolling(counts):
            cc = np.concatenate([[0], np.cumsum(counts)])
            lo_i = np.maximum(np.arange(n_slides) - ppw + 1, 0)
            return cc[np.arange(n_slides) + 1] - cc[lo_i]

        fires = (rolling(lcounts) != 0) | (rolling(rcounts) != 0)

        def decode(s) -> tuple:
            start = (p_first + s - ppw + 1) * slide
            row = wmins[s]
            hit = np.flatnonzero(np.isfinite(row))
            return (start, start + size,
                    (hit // num_segments).astype(np.int32),
                    (hit % num_segments).astype(np.int32),
                    row[hit].astype(np.float64), int(len(hit)), 0)

        # Window emission through the dataflow driver: the scan above is
        # deterministic over the bounded, replayed chunks, so a resumed
        # run recomputes it and the driver skips the windows already
        # committed (run_precomputed's contract).
        from spatialflink_tpu_torch.driver import strict_driver

        drv = driver if driver is not None else strict_driver()
        drv.attach(self)
        drv.bind(self, decode)
        yield from drv.run_precomputed(int(s) for s in np.flatnonzero(fires))


class PointPointTJoinQuery(TJoinQuery):
    """tJoin/PointPointTJoinQuery.java."""


# ---------------------------------------------------------------------------
# tAggregate


@dataclass
class TAggregateResult:
    """Per-cell heatmap entry: (cellName, count, {objID: temporalLen} or
    {'': aggregate}), the reference's Tuple4<gridID, count, map,
    latency> (TAggregateQuery.java:150-250)."""

    start: int
    end: int
    cells: Dict[str, Tuple[int, Dict[str, int]]]
    window_count: int


class TAggregateQuery(_TrajectoryOperator):
    """Per-cell trajectory temporal-length heatmap with ALL / SUM / AVG /
    MIN / MAX aggregates and inactive-trajectory deletion
    (tAggregate/TAggregateQuery.java:53-250, PointTAggregateQuery.java:63+).

    The continuous state (the reference's MapState) is carried across
    windows as sorted host arrays keyed by ``cell << 32 | objID``; each
    window's (cell, objID) timestamp spans come from one device segment
    reduction. ``aggregate_state``: ``(keys, min_ts, max_ts)`` to start
    from (``state.trajectory_state_from_jax``)."""

    def __init__(self, conf, grid, aggregate: str = "SUM",
                 inactive_threshold_ms: int = 0, device="cuda",
                 aggregate_state=None, mesh=None):
        super().__init__(conf, grid, device=device, mesh=mesh)
        if aggregate.upper() not in ("ALL", "SUM", "AVG", "MIN", "MAX"):
            raise ValueError(f"bad aggregate {aggregate!r}")
        self.aggregate = aggregate.upper()
        self.inactive_threshold_ms = inactive_threshold_ms
        if aggregate_state is None:
            aggregate_state = (np.empty(0, np.int64),) * 3
        self._skeys, self._smin, self._smax = (
            np.array(a, np.int64, copy=True) for a in aggregate_state)

    def run(self, stream: Iterable[Point], dtype=np.float64,
            mesh=None) -> Iterator[TAggregateResult]:
        """One ``TAggregateResult`` per fired window. The spans are
        integers, which no coordinate reaches: ``dtype`` changes
        nothing. ``mesh`` (default the
        operator's): the points shard over its ``data`` axis and the
        (cell, objID) spans combine by min and max."""
        mesh = self.run_mesh(mesh)
        for win in self.windows(stream):
            batch = self.point_batch(win.events)
            self._ingest_window(batch.ts, batch.cell, batch.oid, batch.valid,
                                len(win.events), mesh)
            yield self._aggregate_state(win)

    def _ingest_window(self, ts_p, cell_p, oid_p, valid_p, n, mesh=None):
        """One window's (cell, objID) spans merged into the state,
        including the inactive-trajectory deletion."""
        key64 = (cell_p[:n].astype(np.int64) << 32) | oid_p[:n].astype(
            np.int64)
        uniq_keys, inverse = np.unique(key64, return_inverse=True)
        pair_id = np.zeros(len(valid_p), np.int32)
        pair_id[:n] = inverse.astype(np.int32)
        num_pairs = next_bucket(len(uniq_keys), minimum=64)
        ts_d, pid_d, valid_d = ship(np.asarray(ts_p, np.int64), pair_id,
                                    valid_p, device=self.device).arrive()
        spans = window_program(mesh, traj_cell_spans_kernel, (0, 1, 2), 3,
                               reduce=True, num_pairs=num_pairs)(
            ts_d, pid_d, valid_d)
        mn, mx = telemetry.fetch((spans.min_ts, spans.max_ts))
        mn, mx = mn[:len(uniq_keys)], mx[:len(uniq_keys)]
        self._merge_state(uniq_keys, mn, mx)
        if self.inactive_threshold_ms > 0 and len(mx):
            horizon = max(int(mx.max()), 0) - self.inactive_threshold_ms
            keep = self._smax >= horizon
            self._skeys = self._skeys[keep]
            self._smin = self._smin[keep]
            self._smax = self._smax[keep]

    def run_soa(self, chunks, dtype=np.float64):
        """SoA path: point chunks ``{"ts", "x", "y", "oid"}`` (dense int32
        oids) → per window a ``TAggregateResult`` with the same state
        carry as ``run``; in ALL mode the trajectory keys are the dense
        ids as strings; ``dtype`` as in ``run``."""
        for win, _, valid, cell, oid in soa_point_batches(self.grid, chunks,
                                                          self.conf, dtype):
            ts_p = pad_to_bucket(np.asarray(win.arrays["ts"], np.int64),
                                 len(valid))
            self._ingest_window(ts_p, cell, oid, valid, win.count)
            yield self._aggregate_state(win, lookup=str)

    def _merge_state(self, keys: np.ndarray, mn: np.ndarray, mx: np.ndarray):
        """Min/max-merge the window's (key, span) table into the sorted
        state arrays (``searchsorted`` and masks)."""
        pos = np.searchsorted(self._skeys, keys)
        in_range = pos < len(self._skeys)
        hit = np.zeros(len(keys), bool)
        hit[in_range] = self._skeys[pos[in_range]] == keys[in_range]
        hp = pos[hit]
        np.minimum.at(self._smin, hp, mn[hit])
        np.maximum.at(self._smax, hp, mx[hit])
        if (~hit).any():
            order_keys = np.concatenate([self._skeys, keys[~hit]])
            order = np.argsort(order_keys, kind="stable")
            self._skeys = order_keys[order]
            self._smin = np.concatenate([self._smin, mn[~hit]])[order]
            self._smax = np.concatenate([self._smax, mx[~hit]])[order]

    def _aggregate_state(self, win, lookup=None) -> TAggregateResult:
        lookup = lookup if lookup is not None else self.interner.lookup
        count = len(win.events) if hasattr(win, "events") else win.count
        out: Dict[str, Tuple[int, Dict[str, int]]] = {}
        if not len(self._skeys):
            return TAggregateResult(win.start, win.end, out, count)
        cells = (self._skeys >> 32).astype(np.int64)
        oids = (self._skeys & 0xFFFFFFFF).astype(np.int64)
        lens = self._smax - self._smin
        # The state is key-sorted, so cells are grouped in runs.
        starts = np.flatnonzero(np.r_[True, cells[1:] != cells[:-1]])
        ends = np.r_[starts[1:], len(cells)]
        for s, e in zip(starts, ends):
            cell = int(cells[s])
            name = (self.grid.cell_name(cell)
                    if cell < self.grid.num_cells else "out")
            cnt = int(e - s)
            seg = lens[s:e]
            if self.aggregate == "ALL":
                out[name] = (cnt, {
                    lookup(int(o)): int(v) for o, v in zip(oids[s:e], seg)
                })
            elif self.aggregate == "SUM":
                out[name] = (cnt, {"": int(seg.sum())})
            elif self.aggregate == "AVG":
                out[name] = (cnt, {"": round(float(seg.sum()) / cnt)})
            elif self.aggregate == "MIN":
                i = int(np.argmin(seg))
                out[name] = (cnt, {lookup(int(oids[s + i])): int(seg[i])})
            else:  # MAX
                i = int(np.argmax(seg))
                out[name] = (cnt, {lookup(int(oids[s + i])): int(seg[i])})
        return TAggregateResult(win.start, win.end, out, count)


class PointTAggregateQuery(TAggregateQuery):
    """tAggregate/PointTAggregateQuery.java."""


# ---------------------------------------------------------------------------
# tStats


@dataclass
class TStatsResult:
    """Per-trajectory stats of a window: the reference's
    Tuple4<objID, spatialLength, temporalLength, spatial/temporal>
    (TStatsQuery.java:137-144)."""

    start: int
    end: int
    stats: Dict[str, Tuple[float, int, float]]  # objID → (sp, temporal, ratio)
    window_count: int


class TStatsQuery(_TrajectoryOperator):
    """Spatial and temporal length and average speed per trajectory
    (tStats/TStatsQuery.java:44-189).

    WindowBased and CountBased recompute each window (the WFunction
    variant). RealTime carries running totals across micro-batches like
    the ValueState flatmap, dropping out-of-order points (only a
    timestamp strictly greater than the last seen advances the state).
    ``running``: the realtime state to start from, ``{objID: (spatial,
    temporal, last_ts, last_x, last_y)}``
    (``state.trajectory_state_from_jax``)."""

    def __init__(self, conf, grid, device="cuda", running=None, mesh=None):
        super().__init__(conf, grid, device=device, mesh=mesh)
        self._running: Dict[str, Tuple[float, int, int, float, float]] = (
            dict(running) if running is not None else {})

    def run(self, stream: Iterable[Point], dtype=np.float64, mesh=None,
            driver=None) -> Iterator[TStatsResult]:
        """One ``TStatsResult`` per fired window, through the dataflow
        driver (``driver.py``): pass ``driver=`` to opt into checkpoints,
        retry with backoff and, for windowed queries, failover to the
        numpy twin. The realtime walk mutates its running state as it
        goes, so it is never retried and has no twin. Without a driver,
        ``strict_driver()`` gives the plain window loop, errors
        propagating. The segment lengths and spatial sums are float64 in
        the float64 mode (``dtype`` float64, x64 on), float32 from the
        centred lanes otherwise; the numpy twin follows the same rule.
        ``mesh`` (default the operator's): the (objID, ts)-sorted points
        shard over its ``data`` axis with a one-point halo
        (``parallel/sharded.py:sharded_traj_stats``): counts and temporal
        sums exact, spatial sums reassociated within
        ``ops/trajectory.py:spatial_sum_bound``."""
        mesh = self.run_mesh(mesh)
        from spatialflink_tpu_torch.driver import strict_driver

        realtime = self.conf.query_type in (QueryType.RealTime,
                                            QueryType.RealTimeNaive)

        def process(win) -> TStatsResult:
            if realtime:
                # Arrival order matters: the ValueState flatmap drops
                # out-of-order tuples as they arrive (TStatsQuery.java:118).
                return self._realtime_update(win, win.events)
            with telemetry.span("window.tstats", start=win.start,
                                events=len(win.events)):
                events = sorted(win.events,
                                key=lambda p: (p.obj_id, p.timestamp))
                batch = PointBatch.from_points(events, interner=self.interner,
                                               dtype=np.float64)
                nseg = next_bucket(max(self.interner.num_segments, 1),
                                   minimum=64)
                xy, ts, oid, valid = ship(
                    center_coords(self.grid, batch.xy, dtype), batch.ts,
                    batch.oid, batch.valid, device=self.device).arrive()
                if mesh is not None:
                    from spatialflink_tpu_torch.parallel.sharded import (
                        sharded_traj_stats,
                    )

                    sp, tp, cnt, _speed = sharded_traj_stats(
                        mesh, xy, ts, oid, valid, num_segments=nseg)
                else:
                    res = jitted(traj_stats_kernel)(xy, ts, oid, valid,
                                                    nseg)
                    sp, tp, cnt = (res.spatial_length, res.temporal_length,
                                   res.count)
                return self._decode_window(win, events, *telemetry.fetch(
                    (sp, tp, cnt)))

        if realtime:
            # A half-applied window must not re-run (double counting): a
            # configured driver never retries it and there is no twin.
            process.idempotent = False
        fallback = None if realtime else self._numpy_window_process(dtype)
        drv = driver if driver is not None else strict_driver()
        drv.bind(self, process, fallback=fallback)
        if self.conf.query_type == QueryType.CountBased:
            yield from drv.run_windows(count_window_batches(
                stream, self.conf.count_window_size,
                self.conf.count_window_size))
        else:
            yield from drv.run(stream)

    def _numpy_window_process(self, dtype=np.float32):
        """The numpy twin of the windowed device path: the driver's
        failover route. The same (objID, ts) sort, the same coordinates
        (``center_coords`` of ``dtype``: centred float32, or raw float64
        in the float64 mode) and the same per-segment sums (spatial
        lengths in that dtype within ``ops/trajectory.py:
        spatial_sum_bound`` of the device's, counts and int64 temporal
        sums exact)."""

        def process(win) -> TStatsResult:
            events = sorted(win.events, key=lambda p: (p.obj_id, p.timestamp))
            batch = PointBatch.from_points(events, interner=self.interner,
                                           dtype=np.float64)
            nseg = next_bucket(max(self.interner.num_segments, 1), minimum=64)
            n = len(events)
            xy = center_coords(self.grid, batch.xy[:n], dtype)
            oid = np.asarray(batch.oid[:n], np.int64)
            ts = np.asarray(batch.ts[:n], np.int64)
            spatial = np.zeros(nseg, xy.dtype)
            temporal = np.zeros(nseg, np.int64)
            count = np.bincount(oid, minlength=nseg) if n else \
                np.zeros(nseg, np.int64)
            if n > 1:
                same = oid[1:] == oid[:-1]
                d = xy[1:] - xy[:-1]
                seg_d = np.sqrt(np.sum(d * d, axis=-1))
                np.add.at(spatial, oid[1:], np.where(same, seg_d, 0))
                np.add.at(temporal, oid[1:],
                          np.where(same, ts[1:] - ts[:-1], 0))
            return self._decode_window(win, events, spatial, temporal, count)

        return process

    def _decode_window(self, win, events, spatial, temporal,
                       count) -> TStatsResult:
        stats = {}
        for oid_str in {p.obj_id for p in events}:
            i = self.interner.intern(oid_str)
            if count[i] > 0:
                t = int(temporal[i])
                stats[oid_str] = (
                    float(spatial[i]), t,
                    float(spatial[i] / t) if t > 0 else 0.0,
                )
        return TStatsResult(win.start, win.end, stats, len(win.events))

    def run_soa(self, chunks, num_segments: int, dtype=np.float64):
        """SoA path: chunks ``{"ts", "x", "y", "oid"}`` → per window
        ``(start, end, spatial, temporal, count)`` arrays indexed by dense
        oid (float32, or float64 in the float64 mode; int64 ms; int32).
        The (oid, ts) sort happens on the device
        (``traj_stats_sorted_fused``); this path does not go through the
        device pane engine and follows ``dtype``, not the mode alone."""
        for win, xy, valid, _, oid in soa_point_batches(self.grid, chunks,
                                                        self.conf, dtype):
            if counters.enabled and win.count > 1:
                # One candidate distance per adjacent lane pair of the
                # sorted window (masked across trajectory breaks).
                counters.record_candidates(win.count - 1, win.count - 1)
            ts = np.zeros(len(valid), np.int64)
            ts[:win.count] = np.asarray(win.arrays["ts"], np.int64)
            lanes = ship(xy, ts, oid, valid, device=self.device).arrive()
            res = jitted(traj_stats_sorted_fused)(*lanes, num_segments)
            spatial, temporal, count = telemetry.fetch(
                (res.spatial_length, res.temporal_length, res.count))
            yield (win.start, win.end, spatial, temporal, count)

    def _realtime_update(self, win, events) -> TStatsResult:
        stats = {}
        for p in events:
            st = self._running.get(p.obj_id)
            if st is None:
                self._running[p.obj_id] = (0.0, 0, p.timestamp, p.x, p.y)
            else:
                spatial, temporal, last_ts, lx, ly = st
                if p.timestamp > last_ts:  # TStatsQuery.java:118
                    spatial += float(np.hypot(p.x - lx, p.y - ly))
                    temporal += p.timestamp - last_ts
                    self._running[p.obj_id] = (spatial, temporal,
                                               p.timestamp, p.x, p.y)
            spatial, temporal, *_ = self._running[p.obj_id]
            stats[p.obj_id] = (
                spatial, temporal, spatial / temporal if temporal > 0 else 0.0
            )
        return TStatsResult(win.start, win.end, stats, len(events))


class PointTStatsQuery(TStatsQuery):
    """tStats windowed/realtime variants for point streams."""


# ---------------------------------------------------------------------------
# tFilter


@dataclass
class TFilterResult:
    start: int
    end: int
    trajectories: List[LineString]
    window_count: int


class TFilterQuery(_TrajectoryOperator):
    """Keep only the given trajectory IDs and emit their windowed
    sub-trajectories (tFilter/PointTFilterQuery.java:50-122). Host
    control plane: there is no geometry to compute."""

    def run(self, stream: Iterable[Point],
            traj_ids: Sequence[str]) -> Iterator[TFilterResult]:
        wanted = set(traj_ids)
        for win in self.windows(stream):
            groups = group_by_oid([p for p in win.events
                                   if p.obj_id in wanted])
            out = [sub_trajectory(evs, oid, win.start)
                   for oid, evs in sorted(groups.items())]
            yield TFilterResult(win.start, win.end, out, len(win.events))

    def run_soa(self, chunks, traj_ids: Sequence[int]):
        """SoA path: per window, the selected trajectories as arrays
        ``(start, end, oids (m,), ts (m,), xy (m, 2), count)``, rows
        sorted by (oid, ts). ``traj_ids`` are dense int ids."""
        wanted = np.asarray(sorted(traj_ids), np.int32)
        asm = SoaWindowAssembler(
            self.conf.window_size_ms, self.conf.slide_step_ms,
            ooo_ms=self.conf.allowed_lateness_ms,
        )
        for win in asm.stream(chunks):
            if counters.enabled:
                counters.record_window(win.count, 0, 0)
            oid = np.asarray(win.arrays["oid"], np.int32)
            keep = np.isin(oid, wanted)
            # Mask before the float64 conversion: filters keep little.
            ts = np.asarray(win.arrays["ts"][keep], np.int64)
            xy = np.stack(
                [np.asarray(win.arrays["x"][keep], np.float64),
                 np.asarray(win.arrays["y"][keep], np.float64)],
                axis=1,
            )
            o = oid[keep]
            order = np.lexsort((ts, o))
            yield (win.start, win.end, o[order], ts[order], xy[order],
                   win.count)


class PointTFilterQuery(TFilterQuery):
    """tFilter/PointTFilterQuery.java."""
