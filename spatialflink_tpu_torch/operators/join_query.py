"""Spatial joins of two streams: the ``spatialOperators/join/`` matrix.

``run(ordinary, query_stream, radius)`` joins two object streams per
window; ``run_soa(left_chunks, right_chunks, radius)`` is the high-rate
path over SoA chunks. The reference replicates each query object to its
neighbour cells, shuffles both sides by cell and distance-filters the
equi-join (JoinQuery.java:73-137, PointPointJoinQuery.java:124-183).

- ``PointPointJoinQuery``: both sides scatter into bucket planes and the
  grid-hash join kernel (``ops/join_kernel.py``, a hand CUDA kernel on
  the card) tests each left bucket against its neighbour buckets.
  RealTimeNaive runs the all-pairs join
  (PointPointJoinQuery.java:186-243). ``query_panes`` carries the join
  of every (left pane, right pane) block across the windows that share
  it.
- The eight geometry joins (``Point{Polygon,LineString}``,
  ``{Polygon,LineString}Point``, ``{Polygon,LineString}{Polygon,
  LineString}``): the left side in locality-sorted tiles, each tile
  pruned to its bbox candidates, exact distances through B4's gathered
  mode (``ops/join.py``'s pruned kernels), with the overflow retry of
  ``_PrunedGeomJoinRetry``.

Two-stream windowing: both sources are merged by event time on the host
and windows fire when the merged watermark passes their end. Window
results equal the JAX package's ``operators/join_query.py``.

Every entry point honours ``dtype`` by the JAX package's rule
(``precision.py``): with ``dtype`` float64 and the float64 mode on, raw
float64 points, vertices and boxes, and float64 distances (B3's and B4's
float64 instantiations on the card); otherwise centred float32. A mesh
run takes the same lanes, each shard through the same kernels.
"""

from __future__ import annotations

import heapq
from dataclasses import dataclass
from typing import Iterable, Iterator, List, Optional, Tuple

import numpy as np
import torch

from spatialflink_tpu_torch.models.batch import GeometryBatch
from spatialflink_tpu_torch.models.objects import (
    LineString,
    Point,
    Polygon,
    SpatialObject,
)
from spatialflink_tpu_torch.operators.base import (
    SpatialOperator,
    center_coords,
    count_window_batches,
    soa_point_batches,
    ship,
    jitted,
)
from spatialflink_tpu_torch.operators.query_config import QueryType
from spatialflink_tpu_torch.ops.counters import (
    count_join_candidates,
    counters,
)
from spatialflink_tpu_torch.ops.join import (
    compact_pruned,
    cross_join_kernel,
    geometry_geometry_join_masks,
    point_geometry_join_masks,
)
from spatialflink_tpu_torch.ops.join_kernel import join_window
from spatialflink_tpu_torch.precision import effective_f64
from spatialflink_tpu_torch.state import soa_assembler_from_jax
from spatialflink_tpu_torch.streams.soa import RaggedSoaWindowAssembler
from spatialflink_tpu_torch.telemetry import telemetry

#: The JAX package's label for the grid join on the accelerator (B3's
#: ``join_window_pallas``), under which the port's ``join_window`` runs.
JOIN_LABEL = "join_window_pallas"

#: ``join_backend`` values per device. None takes the device's own: the
#: hand kernel on the card, its plain version on the CPU.
JOIN_BACKENDS = {"cuda": (None, "cuda"), "cpu": (None, "torch")}


def check_join_backend(join_backend, device_type: str) -> None:
    """Raise ``ValueError`` for a backend ``device_type`` cannot run: the
    plain version on the card, the kernel on the CPU, or the JAX
    package's TPU-only values (``"xla"``, ``"pallas*"``)."""
    if join_backend not in JOIN_BACKENDS[device_type]:
        raise ValueError(
            f"join_backend {join_backend!r} is not available on "
            f"{device_type} (choose from {JOIN_BACKENDS[device_type]})"
        )


def _centered_bbox(grid, bbox: np.ndarray, dtype=np.float32,
                   pad: bool = True) -> np.ndarray:
    """A (N, 4) minx, miny, maxx, maxy array as ``center_coords`` of
    ``dtype`` gives the device coordinates (centred float32, or raw
    float64 in the float64 mode), so boxes compare in the frame of the
    vertex and point lanes.

    ``pad``: in float32 each corner moves one ulp outward. The corners
    round on their own, apart from the vertices, so a box shrunk by the
    cast could prune a geometry exactly at the radius that the exact
    kernel keeps; the padded box is a superset. Float64 boxes are the
    host's own corners, with no rounding to cover, and stay unpadded, as
    in the JAX package. Approximate mode passes ``pad=False``: there the
    boxes are the distance operands, and padding would bias every
    reported distance low."""
    mins = center_coords(grid, bbox[:, 0:2], dtype)
    maxs = center_coords(grid, bbox[:, 2:4], dtype)
    if pad and mins.dtype != np.float64:
        mins = np.nextafter(mins, np.float32(-np.inf))
        maxs = np.nextafter(maxs, np.float32(np.inf))
    return np.concatenate([mins, maxs], axis=1)


@dataclass
class JoinWindowResult:
    start: int
    end: int
    pairs: List[Tuple[SpatialObject, SpatialObject, float]]
    overflow: int
    window_count: int  # left+right events in window


def merge_by_timestamp(left: Iterable, right: Iterable):
    """Merge two timestamped streams into (tag, event), event-time order."""
    def tagged(it, tag):
        for ev in it:
            yield (ev.timestamp, tag, ev)

    for ts, tag, ev in heapq.merge(tagged(left, 0), tagged(right, 1)):
        yield tag, ev


class _TaggedEvent:
    __slots__ = ("timestamp", "tag", "event")

    def __init__(self, timestamp, tag, event):
        self.timestamp = timestamp
        self.tag = tag
        self.event = event


def grid_hash_join_batches(grid, left_batch, right_batch, radius, cap,
                           max_pairs, device, filter_radius=None, mesh=None,
                           dtype=np.float32):
    """The grid-hash join of two cell-assigned ``PointBatch``es on
    ``device``: the lanes of ``dtype`` (``center_coords``: centred
    float32, or raw float64 in the float64 mode) shipped, bucketed and
    joined (``join_window``). ``filter_radius`` (default ``radius``) is the
    distance predicate; approximate joins pass ``inf`` while the
    candidate neighbourhood stays that of the true radius. ``mesh``: the
    left side shards over its ``data`` axis and the right side
    replicates (``parallel/sharded.py:sharded_join_window_compact``,
    the same result contract: a shard past its share of the budget
    inflates ``count``, so the caller's retry fires)."""
    fr = radius if filter_radius is None else filter_radius
    if mesh is not None:
        from spatialflink_tpu_torch.parallel.sharded import (
            sharded_join_window_compact,
        )

        left_in_grid = left_batch.valid & (left_batch.cell < grid.num_cells)
        lanes = ship(
            center_coords(grid, left_batch.xy, dtype), left_in_grid,
            grid.cell_xy_indices_np(left_batch.xy),
            center_coords(grid, right_batch.xy, dtype), right_batch.valid,
            right_batch.cell, device=device,
        ).arrive()
        return sharded_join_window_compact(
            mesh, *lanes, grid.neighbor_offsets(radius), grid_n=grid.n,
            radius=fr, cap=cap, max_pairs=max_pairs)
    lxy, lv, lc, rxy, rv, rc = ship(
        center_coords(grid, left_batch.xy, dtype), left_batch.valid,
        left_batch.cell, center_coords(grid, right_batch.xy, dtype),
        right_batch.valid, right_batch.cell, device=device,
    ).arrive()
    return jitted(join_window, JOIN_LABEL)(
        lxy, lv, lc, rxy, rv, rc, grid_n=grid.n,
        layers=grid.candidate_layers(radius), radius=fr,
        cap_left=cap, cap_right=cap, max_pairs=max_pairs,
    )


class PointPointJoinQuery(SpatialOperator):
    """join/PointPointJoinQuery.java (windowBased :124-183, naive :186-243).

    ``cap`` is the per-cell point capacity on BOTH sides; a window's
    result is exact iff its ``overflow == 0`` (raise ``cap`` for dense
    data). Out-of-grid points never join, as in the reference.

    ``join_backend``: None runs the hand kernel on the card and its plain
    version on the CPU; ``"cuda"``/``"torch"`` name them explicitly, and
    a value the device cannot run raises (``check_join_backend``).
    ``pair_budget``: the starting pair budget of ``run`` (the JAX
    operator's ``_max_pairs``), for a port operator that resumes a JAX one.
    ``soa_state``: ``(left, right)`` JAX assembler snapshots
    (``checkpoint.soa_assembler_state`` dicts), restored through
    ``state.soa_assembler_from_jax`` by the next ``run_soa``.
    """

    def __init__(self, conf, grid, cap: int = 64,
                 join_backend: Optional[str] = None, device="cuda",
                 pair_budget: int = 0, soa_state=None, mesh=None):
        super().__init__(conf, grid, device=device, mesh=mesh)
        check_join_backend(join_backend, self.device.type)
        self.cap = cap
        self.join_backend = join_backend
        self._max_pairs = int(pair_budget)  # grown budget persists
        self._soa_state = soa_state

    def _filter_radius(self, radius):
        """Distance-predicate radius: in approximate mode every grid
        candidate is emitted (the reference's "all the candidate
        neighbors are sent to output", PointPointJoinQuery.java:164-166
        and :216), as an infinite filter radius; the candidate
        neighbourhood stays that of the true radius, and reported
        distances remain the real point distances."""
        return np.inf if self.conf.approximate_query else radius

    def run(
        self,
        ordinary: Iterable[Point],
        query_stream: Iterable[Point],
        radius: float,
        dtype=np.float64,
        mesh=None,
        driver=None,
    ) -> Iterator[JoinWindowResult]:
        """One ``JoinWindowResult`` per fired window of the two merged
        streams, through the dataflow driver (``driver.py``): pass
        ``driver=`` to opt into checkpoints, retry with backoff and, in
        RealTimeNaive mode, failover to the numpy twin (the grid join's
        pair order is the kernel's output order, so it has no twin and
        stays strict). Without one, ``strict_driver()`` gives the plain
        window loop: errors propagate, nothing retries or degrades. The
        driver consumes the timestamp-merged stream, so resume positions
        count merged events (both sides must replay). Pairs are (left
        point, right point, distance), in the kernel's output order for
        the grid join and left-major for RealTimeNaive. The distances are
        float32 from centred lanes, or float64 from raw float64 lanes
        when ``dtype`` is float64 and the float64 mode is on
        (``precision.py``, the JAX package's rule). ``mesh`` (default the
        operator's): the grid join shards the left side over its ``data``
        axis (each shard through B3 on the card); the pairs are the
        unsharded run's as a set."""
        mesh = self.run_mesh(mesh)
        merged = (
            _TaggedEvent(ev.timestamp, tag, ev)
            for tag, ev in merge_by_timestamp(ordinary, query_stream)
        )
        from spatialflink_tpu_torch.driver import strict_driver

        naive = self.conf.query_type == QueryType.RealTimeNaive
        fr = self._filter_radius(radius)
        ck = jitted(cross_join_kernel)
        drv = driver if driver is not None else strict_driver()
        drv.attach(self)

        def process(win) -> JoinWindowResult:
            left_ev = [t.event for t in win.events if t.tag == 0]
            right_ev = [t.event for t in win.events if t.tag == 1]
            if not left_ev or not right_ev:
                return JoinWindowResult(win.start, win.end, [], 0,
                                        len(win.events))
            with telemetry.span("window.join", start=win.start,
                                events=len(win.events)):
                lb = self.point_batch(left_ev)
                rb = self.point_batch(right_ev)
                if counters.enabled:
                    if naive:
                        cand = len(left_ev) * len(right_ev)
                    else:
                        cand = count_join_candidates(
                            self.grid, lb.cell, len(left_ev), rb.cell,
                            len(right_ev), self.grid.candidate_layers(radius))
                    counters.record_window(len(win.events), cand, cand)
                if naive:
                    lxy, lv, rxy, rv = ship(
                        center_coords(self.grid, lb.xy, dtype), lb.valid,
                        center_coords(self.grid, rb.xy, dtype), rb.valid,
                        device=self.device,
                    ).arrive()
                    res = ck(lxy, lv, rxy, rv, fr)
                    li, ri = torch.nonzero(res.pair_mask, as_tuple=True)
                    li, ri, dd = telemetry.fetch((li, ri, res.dist[li, ri]))
                    overflow = int(res.overflow)
                else:
                    li, ri, dd, overflow = self._compact_block(
                        lb, rb, radius, mesh, dtype)
                pairs = [(left_ev[int(a)], right_ev[int(b)], float(d))
                         for a, b, d in zip(li, ri, dd)]
                return JoinWindowResult(win.start, win.end, pairs, overflow,
                                        len(win.events))

        fallback = self._numpy_window_process(radius, dtype) if naive \
            else None
        drv.bind(self, process, fallback=fallback)
        if self.conf.query_type == QueryType.CountBased:
            yield from drv.run_windows(count_window_batches(
                merged, self.conf.count_window_size,
                self.conf.count_window_size))
        else:
            yield from drv.run(merged)

    def _numpy_window_process(self, radius, dtype=np.float32):
        """The numpy twin of the RealTimeNaive cross join: the driver's
        failover route. The same coordinates (``center_coords`` of
        ``dtype``), squares summed and rooted in their dtype as the plain
        version and the card do, and the device decode's pair order
        (ascending left index, then ascending right index), so a backend
        switch mid-stream changes no pair."""
        fr = self._filter_radius(radius)

        def process(win) -> JoinWindowResult:
            left_ev = [t.event for t in win.events if t.tag == 0]
            right_ev = [t.event for t in win.events if t.tag == 1]
            if not left_ev or not right_ev:
                return JoinWindowResult(win.start, win.end, [], 0,
                                        len(win.events))
            lxy = center_coords(
                self.grid, np.asarray([[p.x, p.y] for p in left_ev],
                                      np.float64), dtype)
            rxy = center_coords(
                self.grid, np.asarray([[p.x, p.y] for p in right_ev],
                                      np.float64), dtype)
            d = lxy[:, None, :] - rxy[None, :, :]
            dist = np.sqrt(np.sum(d * d, axis=-1))
            li, ri = np.nonzero(dist <= fr)
            pairs = [(left_ev[int(a)], right_ev[int(b)], float(dist[a, b]))
                     for a, b in zip(li, ri)]
            return JoinWindowResult(win.start, win.end, pairs, 0,
                                    len(win.events))

        return process

    def _compact_block(self, lb, rb, radius, mesh=None, dtype=np.float32):
        """One bucketed join with the persistent-budget retry: a window
        whose pair count exceeds the budget reruns once with the next
        power of two of its count, and the grown budget persists across
        windows. Returns host (left_idx, right_idx, dist, overflow)."""
        self._max_pairs = max(
            self._max_pairs, 1024, min(4 * lb.capacity, 262_144)
        )
        while True:
            res = grid_hash_join_batches(
                self.grid, lb, rb, radius, self.cap, self._max_pairs,
                self.device, filter_radius=self._filter_radius(radius),
                mesh=mesh, dtype=dtype,
            )
            count = int(res.count)
            if count <= self._max_pairs:
                break
            self._max_pairs = int(2 ** np.ceil(np.log2(count)))
        li, ri, dd = telemetry.fetch((res.left_index[:count],
                                      res.right_index[:count],
                                      res.dist[:count]))
        keep = li >= 0
        return li[keep], ri[keep], dd[keep], int(res.overflow)

    def query_panes(
        self,
        ordinary: Iterable[Point],
        query_stream: Iterable[Point],
        radius: float,
        dtype=np.float64,
        flush_at_end: bool = True,
    ) -> Iterator[JoinWindowResult]:
        """Sliding-window join through a pane-block carry: a window's pairs
        are the union over its (left pane, right pane) blocks, and a slide
        computes only the blocks of the new pane (one bucketed join each,
        through B3); every other block is carried from earlier windows
        (the join's ListState carry, range/PointPointRangeQuery.java:
        195-296).

        Pairs come block-major, (p, q) over the window's pane starts. With
        ``overflow == 0`` a window's pairs equal ``run``'s as a multiset;
        the overflow is the sum over the window's blocks (``cap`` applies
        per pane). The carry is ``self._join_pane_carry = {"panes":
        {start: (left events, right events, left batch, right batch)},
        "blocks": {(p, q): (pairs, overflow)}}``, one stream pair per
        operator; ``flush_at_end`` False treats the end of the sources as
        a cut and leaves the open windows in the assembler. In-order
        streams, WindowBased windows and ``size % slide == 0`` only, as
        in the JAX package. ``dtype``: ``run``'s rule, each block's join
        on float64 lanes through B3's float64 instantiation in the
        float64 mode."""
        if self.conf.allowed_lateness_ms > 0:
            raise ValueError(
                "query_panes does not support allowed_lateness; use run()")
        if self.conf.query_type != QueryType.WindowBased:
            raise ValueError(
                "query_panes requires WindowBased time-sliding windows")
        size = self.conf.window_size_ms
        slide = self.conf.slide_step_ms
        if size % slide != 0:
            raise ValueError("query_panes requires size % slide == 0")
        merged = (
            _TaggedEvent(ev.timestamp, tag, ev)
            for tag, ev in merge_by_timestamp(ordinary, query_stream)
        )
        if getattr(self, "_join_pane_carry", None) is None:
            self._join_pane_carry = {"panes": {}, "blocks": {}}
        panes: dict = self._join_pane_carry["panes"]
        blocks: dict = self._join_pane_carry["blocks"]

        for win in self._checkpointable_windows(merged, flush_at_end):
            starts = list(range(win.start, win.end, slide))
            fresh = {ps for ps in starts if ps not in panes}
            if fresh:
                # One pass over the window buckets every new pane.
                grouped = {ps: ([], []) for ps in fresh}
                for t in win.events:
                    ps = win.start + ((t.timestamp - win.start) // slide) \
                        * slide
                    if ps in grouped:
                        grouped[ps][t.tag].append(t.event)
                for ps, (left_ev, right_ev) in grouped.items():
                    panes[ps] = (
                        left_ev, right_ev,
                        self.point_batch(left_ev) if left_ev else None,
                        self.point_batch(right_ev) if right_ev else None,
                    )
            for ps in [p for p in panes if p < win.start]:
                del panes[ps]
            for key in [k for k in blocks
                        if k[0] < win.start or k[1] < win.start]:
                del blocks[key]
            for p in starts:
                for q in starts:
                    if (p, q) in blocks:
                        continue
                    lev, _, lb, _ = panes[p]
                    _, rev, _, rb = panes[q]
                    if lb is None or rb is None:
                        blocks[(p, q)] = ([], 0)
                        continue
                    li, ri, dd, over = self._compact_block(lb, rb, radius,
                                                           dtype=dtype)
                    blocks[(p, q)] = (
                        [(lev[int(a)], rev[int(b)], float(d))
                         for a, b, d in zip(li, ri, dd)],
                        over,
                    )
            pairs: list = []
            overflow = 0
            for p in starts:
                for q in starts:
                    bp, bo = blocks[(p, q)]
                    pairs.extend(bp)
                    overflow += bo
            yield JoinWindowResult(win.start, win.end, pairs, overflow,
                                   len(win.events))

    def _soa_assemblers(self):
        """The left and right SoA assemblers of the next ``run_soa``:
        fresh (None), or resumed from ``soa_state`` (consumed once)."""
        state, self._soa_state = self._soa_state, None
        if state is None:
            return None, None
        conf = self.conf
        return tuple(
            soa_assembler_from_jax(s, conf.window_size_ms,
                                   conf.slide_step_ms,
                                   conf.allowed_lateness_ms)
            for s in state
        )

    def run_soa(
        self,
        left_chunks,
        right_chunks,
        radius: float,
        max_pairs: int = 262_144,
        dtype=np.float64,
    ):
        """High-rate SoA path: two chunk streams of {"ts", "x", "y", ...}
        arrays → per window ``(start, end, left_index, right_index, dist,
        count, overflow)``: host arrays padded with −1, −1 and +inf to the
        pair budget (indices into each side's window arrays), the true
        pair count and the bucket overflow. Windows of the two sides
        align on their shared slide grid; a window present on one side
        only yields empty arrays and zeros. The budget starts at
        ``max_pairs`` (pass a JAX run's grown budget to resume it), grows
        to the next power of two of a window's count when that exceeds
        it, and persists across windows. The distances are float32 from
        centred lanes, or float64 from raw float64 lanes when ``dtype`` is
        float64 and the float64 mode is on (B3's float64 instantiation on
        the card)."""
        layers = self.grid.candidate_layers(radius)
        fr = self._filter_radius(radius)
        asm_l, asm_r = self._soa_assemblers()
        gen_l = soa_point_batches(self.grid, left_chunks, self.conf, dtype,
                                  asm=asm_l)
        gen_r = soa_point_batches(self.grid, right_chunks, self.conf, dtype,
                                  asm=asm_r)
        no_dist = np.float64 if effective_f64(dtype) else np.float32
        budget = max_pairs
        jk = jitted(join_window, JOIN_LABEL)
        for kind, wl, wr in _aligned_soa_windows(
            gen_l, gen_r, lambda w: w[0].start, lambda w: w[0].start
        ):
            if kind != "both":
                w = wl[0] if kind == "left" else wr[0]
                yield (w.start, w.end, np.empty(0, np.int32),
                       np.empty(0, np.int32), np.empty(0, no_dist), 0, 0)
                continue
            win, lxy, lvalid, lcell, _ = wl
            _, rxy, rvalid, rcell, _ = wr
            if counters.enabled:
                cand = count_join_candidates(
                    self.grid, lcell, int(lvalid.sum()), rcell,
                    int(rvalid.sum()), layers)
                counters.record_candidates(cand, cand)
            # Shipped once; every budget retry reuses the device lanes.
            lanes = ship(lxy, lvalid, lcell, rxy, rvalid, rcell,
                         device=self.device).arrive()
            while True:
                res = jk(
                    *lanes, grid_n=self.grid.n, layers=layers, radius=fr,
                    cap_left=self.cap, cap_right=self.cap, max_pairs=budget,
                )
                count = int(res.count)
                if count <= budget:
                    break
                budget = int(2 ** np.ceil(np.log2(count)))
            li, ri, dd = telemetry.fetch(
                (res.left_index, res.right_index, res.dist))
            yield (win.start, win.end, li, ri, dd, count, int(res.overflow))


def _aligned_soa_windows(gen_l, gen_r, start_l, start_r):
    """Align two per-window generator streams on their shared slide grid.
    Yields ('left', wl, None) / ('right', None, wr) for one-sided windows
    and ('both', wl, wr) for aligned ones; ``start_l``/``start_r``
    extract a window's start from each generator's item."""
    wl = next(gen_l, None)
    wr = next(gen_r, None)
    while wl is not None or wr is not None:
        if wr is None or (wl is not None and start_l(wl) < start_r(wr)):
            yield "left", wl, None
            wl = next(gen_l, None)
        elif wl is None or start_r(wr) < start_l(wl):
            yield "right", None, wr
            wr = next(gen_r, None)
        else:
            yield "both", wl, wr
            wl = next(gen_l, None)
            wr = next(gen_r, None)


class _PrunedGeomJoinRetry:
    """The pruned geometry joins' retry state: ``_cand`` (a tile's
    candidate width) grows on ``cand_overflow``, ``_pair_cap`` (matches
    a left item keeps) on ``pair_overflow``, ``_geom_max_pairs`` on a
    count past the budget; all three persist across windows, and grow in
    the JAX package's order (budget, then ``cand``, then ``pair_cap``),
    so a port operator ends a run at the JAX operator's values."""

    _cand = 32
    _pair_cap = 8
    _geom_max_pairs = 4096

    def _pruned_block_pairs(self, masks_at, m_cap: int):
        """``masks_at(cand)`` → ``PrunedJoinMasks``; returns host
        (left_idx, right_idx, dist), exact: at ``cand == m_cap`` the prune
        keeps every geometry, and ``pair_cap == cand`` bounds any item's
        matches. Only a grown ``cand`` recomputes the distances; a grown
        budget or ``pair_cap`` recompacts them."""
        masks, masks_cand = None, None
        while True:
            cand = min(self._cand, m_cap)
            pair_cap = min(self._pair_cap, cand)
            if masks_cand != cand:
                masks, masks_cand = masks_at(cand), cand
            res = compact_pruned(masks, pair_cap, self._geom_max_pairs)
            count, cand_over, pair_over = torch.stack(
                [res.count, res.cand_overflow, res.pair_overflow]).tolist()
            if count > self._geom_max_pairs:
                self._geom_max_pairs = int(2 ** np.ceil(np.log2(count)))
                continue
            if cand_over > 0 and cand < m_cap:
                self._cand = min(self._cand * 2, m_cap)
                continue
            if pair_over > 0 and pair_cap < cand:
                self._pair_cap = min(self._pair_cap * 2, m_cap)
                continue
            break
        li, ri, dd = telemetry.fetch((res.left_index[:count],
                                      res.right_index[:count],
                                      res.dist[:count]))
        keep = li >= 0
        return li[keep], ri[keep], dd[keep]

    def _sharded_block_pairs(self, call, m_cap: int):
        """The mesh form of ``_pruned_block_pairs``, the JAX package's
        loop: ``call(cand, pair_cap, max_pairs)`` → the sharded
        ``PrunedJoinPairs``, whose ``count`` is a per-shard vector
        (``max_pairs`` is per shard). The same three budgets grow in the
        same order; returns host (left_idx, right_idx, dist), the
        −1-padded tails of the per-shard segments dropped."""
        while True:
            cand = min(self._cand, m_cap)
            pair_cap = min(self._pair_cap, cand)
            res = call(cand, pair_cap, self._geom_max_pairs)
            worst, cand_over, pair_over = torch.stack(
                [res.count.max(), res.cand_overflow,
                 res.pair_overflow]).tolist()
            if worst > self._geom_max_pairs:
                self._geom_max_pairs = int(2 ** np.ceil(np.log2(worst)))
                continue
            if cand_over > 0 and cand < m_cap:
                self._cand = min(self._cand * 2, m_cap)
                continue
            if pair_over > 0 and pair_cap < cand:
                self._pair_cap = min(self._pair_cap * 2, m_cap)
                continue
            break
        li, ri, dd = telemetry.fetch((res.left_index, res.right_index,
                                      res.dist))
        keep = li >= 0
        return li[keep], ri[keep], dd[keep]


def _empty_soa():
    """A one-sided window's arrays, as the JAX package yields them."""
    return np.empty(0, np.int32), np.empty(0, np.int32), np.empty(0)


def _ragged_windows(conf, chunks):
    """The fired windows of a ragged geometry chunk stream."""
    asm = RaggedSoaWindowAssembler(conf.window_size_ms, conf.slide_step_ms,
                                   ooo_ms=conf.allowed_lateness_ms)
    return asm.stream(chunks)


def _ragged_batch(w) -> GeometryBatch:
    """A ragged window as a float64 host ``GeometryBatch``."""
    return GeometryBatch.from_ragged(w.ts, w.oid, w.lengths, w.verts,
                                     edge_valid_flat=w.edge_valid,
                                     dtype=np.float64)


class _PointGeometryJoinQuery(SpatialOperator, _PrunedGeomJoinRetry):
    """Point stream ⋈ geometry (polygon or linestring) stream within the
    radius (join/PointPolygonJoinQuery.java).

    The reference replicates each geometry to its neighbour cells and
    joins on the cell id; here the replication is the pruned kernel's
    tile prune (``ops/join.py:point_geometry_join_pruned_kernel``):
    points sorted by cell on the host into tiles of ``_point_block``,
    each tile's bbox tested against the geometries' grown bboxes, exact
    distances (B4 gathered; 0 inside a polygon) for a tile's first
    ``cand`` candidates only, pairs compacted on the device.

    Approximate mode depends on which stream is the points in the
    reference: the point-ordinary classes emit every grid candidate
    (join/PointPolygonJoinQuery.java:131, "all the candidate neighbors
    are sent to output"), and the geometry-ordinary ones
    (``PolygonPointJoinQuery``, ``LineStringPointJoinQuery``) keep the
    point → geometry-bbox distance within the radius."""

    polygonal = True
    _point_block = 256
    approx_emit_all = True

    def __init__(self, conf, grid, device="cuda", mesh=None):
        super().__init__(conf, grid, device=device, mesh=mesh)

    def _approx_cell_space(self, cells_sorted, valid_sorted, gb, radius,
                           dtype=np.float32):
        """Kernel inputs of the emit-all mode: the points' (xi, yi) cell
        indices as coordinates, each geometry's bbox-cell rectangle grown
        by ``candidate_layers(radius)`` as its box, and radius 0 (a point
        in the box ⇔ bbox distance 0): the reference's candidate set is
        cell membership. Reported distances are 0, of the lanes' dtype
        (float64 in the float64 mode); out-of-grid points never join.
        Cell indices are exact in float32 (< 2^24)."""
        lane = np.float64 if effective_f64(dtype) else np.float32
        g = self.grid
        cells = np.asarray(cells_sorted)
        xi = (cells // g.n).astype(np.float64)
        yi = (cells % g.n).astype(np.float64)
        pxy = np.stack([xi, yi], axis=1).astype(lane)
        pvalid = np.asarray(valid_sorted) & (cells < g.num_cells)
        layers = g.candidate_layers(radius)
        bb = np.asarray(gb.bbox, np.float64)
        gbbox = np.stack([
            np.floor((bb[:, 0] - g.min_x) / g.cell_length) - layers,
            np.floor((bb[:, 1] - g.min_y) / g.cell_length) - layers,
            np.floor((bb[:, 2] - g.min_x) / g.cell_length) + layers,
            np.floor((bb[:, 3] - g.min_y) / g.cell_length) + layers,
        ], axis=1).astype(lane)
        return pxy, pvalid, gbbox

    def _point_side_args(self, pxy_fn, pvalid, pcell, gb, radius,
                         dtype=np.float32):
        """(kernel arguments on the device, the kernel's radius): the one
        home of the approximate routing, shared by ``run`` and
        ``run_soa``. ``pxy_fn`` gives the locality-sorted point lanes of
        ``dtype``, lazily: the emit-all mode does not need them. Both
        approximate modes read bboxes only, so no vertex is shipped.
        Exact mode pads float32 pruning boxes one ulp outward
        (``_centered_bbox``); the approximate bbox mode does not (its
        boxes are the distance operands)."""
        approx = self.conf.approximate_query
        dev = self.device
        if approx and self.approx_emit_all:
            pxy, pv, gbbox = self._approx_cell_space(pcell, pvalid, gb,
                                                     radius, dtype)
            pxy, pv, gvalid, gbbox = ship(pxy, pv, gb.valid, gbbox,
                                          device=dev).arrive()
            return (pxy, pv, None, None, gvalid, gbbox), 0.0
        bbox = _centered_bbox(self.grid, gb.bbox, dtype, pad=not approx)
        if approx:
            pxy, pv, gvalid, gbbox = ship(pxy_fn(), pvalid, gb.valid, bbox,
                                          device=dev).arrive()
            return (pxy, pv, None, None, gvalid, gbbox), radius
        pxy, pv, gev, gvalid, gbbox = ship(
            pxy_fn(), pvalid, gb.edge_valid, gb.valid, bbox,
            device=dev).arrive()
        return (pxy, pv, self.device_verts(gb.verts, dtype), gev, gvalid,
                gbbox), radius

    def _pairs(self, args, r_call, capacity: int, mesh=None):
        approx = self.conf.approximate_query
        if mesh is not None:
            from spatialflink_tpu_torch.parallel.sharded import (
                sharded_point_geometry_join_pruned,
            )

            return self._sharded_block_pairs(
                lambda cand, pair_cap, mp: sharded_point_geometry_join_pruned(
                    mesh, *args, r_call, polygonal=self.polygonal,
                    block=self._point_block, cand=cand, max_pairs=mp,
                    pair_cap=pair_cap, approx=approx),
                capacity)
        return self._pruned_block_pairs(
            lambda cand: point_geometry_join_masks(
                *args, r_call, polygonal=self.polygonal,
                block=self._point_block, cand=cand, approx=approx),
            capacity)

    def run(
        self,
        ordinary: Iterable[Point],
        query_stream: Iterable[Polygon | LineString],
        radius: float,
        dtype=np.float64,
        mesh=None,
    ) -> Iterator[JoinWindowResult]:
        """One ``JoinWindowResult`` per fired window: (point, geometry,
        distance) pairs, each point's matches by ascending geometry index,
        the points in cell order; the distances float32, or float64 in the
        float64 mode (the module's note). ``mesh`` (default the
        operator's): the cell-sorted points shard contiguously over its
        ``data`` axis, the geometries replicate
        (``sharded_point_geometry_join_pruned``); the pairs are the
        unsharded run's as a set, each shard's in its own order."""
        mesh = self.run_mesh(mesh)
        merged = (
            _TaggedEvent(ev.timestamp, tag, ev)
            for tag, ev in merge_by_timestamp(ordinary, query_stream)
        )
        for win in self.windows(merged):
            left_ev = [t.event for t in win.events if t.tag == 0]
            right_ev = [t.event for t in win.events if t.tag == 1]
            if not left_ev or not right_ev:
                yield JoinWindowResult(win.start, win.end, [], 0,
                                       len(win.events))
                continue
            lb = self.point_batch(left_ev)
            gb = self.geometry_batch(right_ev)
            # Locality sort on the host; kernel indices map back via ho.
            ho = np.argsort(lb.cell, kind="stable")
            args, r_call = self._point_side_args(
                lambda: center_coords(self.grid, lb.xy[ho], dtype),
                lb.valid[ho], lb.cell[ho], gb, radius, dtype)
            li, ri, dd = self._pairs(args, r_call, gb.capacity, mesh)
            pairs = [(left_ev[int(ho[int(a)])], right_ev[int(b)], float(d))
                     for a, b, d in zip(li, ri, dd)]
            yield JoinWindowResult(win.start, win.end, pairs, 0,
                                   len(win.events))

    def run_soa(self, point_chunks, geom_chunks, radius: float,
                dtype=np.float64):
        """Ragged-SoA path: point chunks {"ts", "x", "y", "oid"} ⋈ geometry
        chunks {"ts", "oid", "lengths", "verts"[, "edge_valid"]} → per
        window ``(start, end, point_idx, geom_idx, dist, count)``, indices
        into each side's window arrays, no per-pair Python. Windows align
        on the shared slide grid; a one-sided window yields empty arrays
        (int32, int32, float64) and count 0. ``dtype``: ``run``'s rule."""
        gen_l = soa_point_batches(self.grid, point_chunks, self.conf, dtype)
        gen_r = _ragged_windows(self.conf, geom_chunks)
        for kind, wl, wr in _aligned_soa_windows(
            gen_l, gen_r, lambda w: w[0].start, lambda w: w.start
        ):
            if kind != "both":
                w = wl[0] if kind == "left" else wr
                yield (w.start, w.end, *_empty_soa(), 0)
                continue
            win, lxy, lvalid, lcell, _ = wl
            gb = _ragged_batch(wr)
            ho = np.argsort(lcell, kind="stable")
            args, r_call = self._point_side_args(
                lambda: lxy[ho], lvalid[ho], lcell[ho], gb, radius, dtype)
            li, ri, dd = self._pairs(args, r_call, gb.capacity)
            yield (win.start, win.end, ho[li].astype(np.int32), ri, dd,
                   len(li))


class PointPolygonJoinQuery(_PointGeometryJoinQuery):
    """join/PointPolygonJoinQuery.java."""

    polygonal = True


class PointLineStringJoinQuery(_PointGeometryJoinQuery):
    """join/PointLineStringJoinQuery.java."""

    polygonal = False


class _GeometryGeometryJoinQuery(SpatialOperator, _PrunedGeomJoinRetry):
    """Geometry ⋈ geometry within the radius, JTS distances with 0 on
    containment (``ops/range.py:geometry_pair_distance``; crossing edges
    keep the reference's vertex distance, ROADMAP C2).

    Runs ``ops/join.py:geometry_geometry_join_pruned_kernel``: the left
    geometries sorted on the host by their quantized bbox centres into
    tiles of ``_geom_block``, each tile pruned to its bbox candidates on
    the right, exact distances (B4 gathered both ways, containment both
    ways) for those only. Approximate mode: the bbox ↔ bbox distance
    (join/LineStringLineStringJoinQuery.java:173-180)."""

    left_polygonal = True
    right_polygonal = True
    _geom_block = 32

    def __init__(self, conf, grid, device="cuda", mesh=None):
        super().__init__(conf, grid, device=device, mesh=mesh)

    def _window_args(self, la, ra, dtype=np.float32):
        """(ho, kernel arguments on the device): the host locality sort of
        the left side by quantized bbox centre (the JAX key), and both
        sides' lanes of ``dtype`` in that order. Exact mode pads float32
        pruning boxes one ulp outward (``_centered_bbox``); approximate
        mode does not (there the boxes are the distance operands) and
        ships no vertex."""
        cx = (la.bbox[:, 0] + la.bbox[:, 2]) * 0.5
        cy = (la.bbox[:, 1] + la.bbox[:, 3]) * 0.5
        with np.errstate(invalid="ignore", divide="ignore"):
            vx = cx[la.valid]
            vy = cy[la.valid]
            x0, x1 = (vx.min(), vx.max()) if len(vx) else (0.0, 1.0)
            y0, y1 = (vy.min(), vy.max()) if len(vy) else (0.0, 1.0)
            qx = np.clip((cx - x0) / max(x1 - x0, 1e-30) * 1023, 0, 1023)
            qy = np.clip((cy - y0) / max(y1 - y0, 1e-30) * 1023, 0, 1023)
        key = np.where(la.valid,
                       qy.astype(np.int64) * 1024 + qx.astype(np.int64),
                       np.int64(1) << 40)
        ho = np.argsort(key, kind="stable")
        approx = self.conf.approximate_query
        abox = _centered_bbox(self.grid, la.bbox[ho], dtype, pad=not approx)
        bbox = _centered_bbox(self.grid, ra.bbox, dtype, pad=not approx)
        if approx:
            av, ab, bv, bb = ship(la.valid[ho], abox, ra.valid, bbox,
                                  device=self.device).arrive()
            return ho, (None, None, av, ab, None, None, bv, bb)
        aev, av, ab, bev, bv, bb = ship(
            la.edge_valid[ho], la.valid[ho], abox, ra.edge_valid, ra.valid,
            bbox, device=self.device).arrive()
        return ho, (self.device_verts(la.verts[ho], dtype), aev, av, ab,
                    self.device_verts(ra.verts, dtype), bev, bv, bb)

    def _window_pairs(self, la, ra, radius, mesh=None, dtype=np.float32):
        """The pruned kernel over one window's batches; returns input-index
        pairs (left_idx int32, right_idx, dist). With ``mesh``, the
        sorted left side shards contiguously over ``data`` (locality
        kept), the right side replicates."""
        ho, args = self._window_args(la, ra, dtype)
        approx = self.conf.approximate_query
        if mesh is not None:
            from spatialflink_tpu_torch.parallel.sharded import (
                sharded_geometry_geometry_join_pruned,
            )

            li, ri, dd = self._sharded_block_pairs(
                lambda cand, pair_cap, mp:
                sharded_geometry_geometry_join_pruned(
                    mesh, *args, radius, a_polygonal=self.left_polygonal,
                    b_polygonal=self.right_polygonal,
                    block=self._geom_block, cand=cand, max_pairs=mp,
                    pair_cap=pair_cap, approx=approx),
                ra.capacity)
            return ho[li].astype(np.int32), ri, dd
        li, ri, dd = self._pruned_block_pairs(
            lambda cand: geometry_geometry_join_masks(
                *args, radius, a_polygonal=self.left_polygonal,
                b_polygonal=self.right_polygonal, block=self._geom_block,
                cand=cand, approx=approx),
            ra.capacity)
        return ho[li].astype(np.int32), ri, dd

    def run(
        self,
        ordinary: Iterable[Polygon | LineString],
        query_stream: Iterable[Polygon | LineString],
        radius: float,
        dtype=np.float64,
        mesh=None,
    ) -> Iterator[JoinWindowResult]:
        """One ``JoinWindowResult`` per fired window: (left, right,
        distance) pairs, the distances float32, or float64 in the float64
        mode (the module's note). ``mesh`` (default the operator's): the
        left side shards over its ``data`` axis; the pairs are the
        unsharded run's as a set."""
        mesh = self.run_mesh(mesh)
        merged = (
            _TaggedEvent(ev.timestamp, tag, ev)
            for tag, ev in merge_by_timestamp(ordinary, query_stream)
        )
        for win in self.windows(merged):
            left_ev = [t.event for t in win.events if t.tag == 0]
            right_ev = [t.event for t in win.events if t.tag == 1]
            if not left_ev or not right_ev:
                yield JoinWindowResult(win.start, win.end, [], 0,
                                       len(win.events))
                continue
            li, ri, dd = self._window_pairs(
                self.geometry_batch(left_ev, mesh=mesh),
                self.geometry_batch(right_ev), radius, mesh, dtype)
            pairs = [(left_ev[int(a)], right_ev[int(b)], float(d))
                     for a, b, d in zip(li, ri, dd)]
            yield JoinWindowResult(win.start, win.end, pairs, 0,
                                   len(win.events))

    def run_soa(self, left_chunks, right_chunks, radius: float,
                dtype=np.float64):
        """Ragged-SoA path: both sides ragged geometry chunk streams
        ({"ts", "oid", "lengths", "verts"[, "edge_valid"]}) → per window
        ``(start, end, left_idx, right_idx, dist, count)``; a one-sided
        window yields empty arrays (int32, int32, float64) and count 0.
        ``dtype``: ``run``'s rule."""
        gen_l = _ragged_windows(self.conf, left_chunks)
        gen_r = _ragged_windows(self.conf, right_chunks)
        for kind, wl, wr in _aligned_soa_windows(
            gen_l, gen_r, lambda w: w.start, lambda w: w.start
        ):
            if kind != "both":
                w = wl if kind == "left" else wr
                yield (w.start, w.end, *_empty_soa(), 0)
                continue
            li, ri, dd = self._window_pairs(_ragged_batch(wl),
                                            _ragged_batch(wr), radius,
                                            dtype=dtype)
            yield (wl.start, wl.end, li, ri, dd, len(li))


class PolygonPointJoinQuery(_PointGeometryJoinQuery):
    """join/PolygonPointJoinQuery.java: a polygon stream ⋈ point queries.
    ``run(ordinary, query_stream)`` takes the polygons first and swaps
    the streams and the pairs; ``run_soa`` is inherited unswapped (point
    chunks first), as in the JAX package. Approximate mode keeps the
    point → polygon-bbox distance within the radius
    (getPointPolygonBBoxMinEuclideanDistance), not emit-all."""

    polygonal = True
    approx_emit_all = False

    def run(self, ordinary, query_stream, radius, dtype=np.float64,
            mesh=None):
        for res in super().run(query_stream, ordinary, radius, dtype=dtype,
                               mesh=mesh):
            res.pairs = [(b, a, d) for (a, b, d) in res.pairs]
            yield res


class PolygonPolygonJoinQuery(_GeometryGeometryJoinQuery):
    """join/PolygonPolygonJoinQuery.java."""

    left_polygonal = True
    right_polygonal = True


class PolygonLineStringJoinQuery(_GeometryGeometryJoinQuery):
    """join/PolygonLineStringJoinQuery.java."""

    left_polygonal = True
    right_polygonal = False


class LineStringPointJoinQuery(PolygonPointJoinQuery):
    """join/LineStringPointJoinQuery.java."""

    polygonal = False


class LineStringPolygonJoinQuery(_GeometryGeometryJoinQuery):
    """join/LineStringPolygonJoinQuery.java."""

    left_polygonal = False
    right_polygonal = True


class LineStringLineStringJoinQuery(_GeometryGeometryJoinQuery):
    """join/LineStringLineStringJoinQuery.java."""

    left_polygonal = False
    right_polygonal = False
