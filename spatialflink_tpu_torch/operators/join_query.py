"""Point–point spatial join of two streams: ``PointPointJoinQuery``.

``run(ordinary, query_stream, radius)`` joins two streams of ``Point``
objects per window; ``run_soa(left_chunks, right_chunks, radius)`` is the
high-rate path over SoA chunks. The reference replicates each query
object to its neighbour cells, shuffles both sides by cell and
distance-filters the equi-join (JoinQuery.java:73-137,
PointPointJoinQuery.java:124-183); here both sides scatter into bucket
planes and the grid-hash join kernel (``ops/join_kernel.py``, a hand
CUDA kernel on the card) tests each left bucket against its neighbour
buckets. RealTimeNaive runs the all-pairs join
(PointPointJoinQuery.java:186-243).

Two-stream windowing: both sources are merged by event time on the host
and windows fire when the merged watermark passes their end. Window
results equal the JAX package's ``operators/join_query.py``.
"""

from __future__ import annotations

import heapq
from dataclasses import dataclass
from typing import Iterable, Iterator, List, Optional, Tuple

import numpy as np
import torch

from spatialflink_tpu_torch.models.objects import Point, SpatialObject
from spatialflink_tpu_torch.operators.base import (
    SpatialOperator,
    center_coords,
    soa_point_batches,
    ship,
)
from spatialflink_tpu_torch.operators.query_config import QueryType
from spatialflink_tpu_torch.ops.join import cross_join_kernel
from spatialflink_tpu_torch.ops.join_kernel import join_window
from spatialflink_tpu_torch.state import soa_assembler_from_jax

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
    """A (N, 4) minx, miny, maxx, maxy array centred and cast to float32
    as the device coordinates are (``center_coords``), so boxes compare
    in the frame of the vertex and point lanes. ``dtype`` is accepted for
    the JAX signature.

    ``pad``: each corner moves one float32 ulp outward. The corners round
    on their own, apart from the vertices, so a box shrunk by the cast
    could prune a geometry exactly at the radius that the exact kernel
    keeps; the padded box is a superset. Approximate mode passes
    ``pad=False``: there the boxes are the distance operands, and padding
    would bias every reported distance low."""
    mins = center_coords(grid, bbox[:, 0:2], dtype)
    maxs = center_coords(grid, bbox[:, 2:4], dtype)
    if pad:
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
                           max_pairs, device, filter_radius=None):
    """The grid-hash join of two cell-assigned ``PointBatch``es on
    ``device``: centred float32 lanes shipped, bucketed and joined
    (``join_window``). ``filter_radius`` (default ``radius``) is the
    distance predicate; approximate joins pass ``inf`` while the
    candidate neighbourhood stays that of the true radius."""
    fr = radius if filter_radius is None else filter_radius
    lxy, lv, lc, rxy, rv, rc = ship(
        center_coords(grid, left_batch.xy), left_batch.valid,
        left_batch.cell, center_coords(grid, right_batch.xy),
        right_batch.valid, right_batch.cell, device=device,
    ).arrive()
    return join_window(
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
        if mesh is not None:
            raise NotImplementedError(
                "mesh= (multi-GPU join) is not ported yet: ROADMAP A12")
        super().__init__(conf, grid, device=device)
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
        streams: the JAX operator's plain window loop (errors propagate,
        nothing retries or degrades). Pairs are (left point, right point,
        float32 distance), in the kernel's output order for the grid join
        and left-major for RealTimeNaive. ``dtype`` is accepted for the
        JAX signature: the port computes in float32."""
        if driver is not None:
            raise NotImplementedError(
                "driver= (checkpointing, retry, failover) is not ported "
                "yet: ROADMAP A11")
        if mesh is not None:
            raise NotImplementedError(
                "mesh= (multi-GPU join) is not ported yet: ROADMAP A12")
        merged = (
            _TaggedEvent(ev.timestamp, tag, ev)
            for tag, ev in merge_by_timestamp(ordinary, query_stream)
        )
        naive = self.conf.query_type == QueryType.RealTimeNaive
        fr = self._filter_radius(radius)
        for win in self.windows(merged):
            left_ev = [t.event for t in win.events if t.tag == 0]
            right_ev = [t.event for t in win.events if t.tag == 1]
            if not left_ev or not right_ev:
                yield JoinWindowResult(win.start, win.end, [], 0,
                                       len(win.events))
                continue
            lb = self.point_batch(left_ev)
            rb = self.point_batch(right_ev)
            if naive:
                lxy, lv, rxy, rv = ship(
                    center_coords(self.grid, lb.xy), lb.valid,
                    center_coords(self.grid, rb.xy), rb.valid,
                    device=self.device,
                ).arrive()
                res = cross_join_kernel(lxy, lv, rxy, rv, fr)
                li, ri = torch.nonzero(res.pair_mask, as_tuple=True)
                dd = res.dist[li, ri]
                li, ri, dd = (t.cpu().numpy() for t in (li, ri, dd))
                overflow = int(res.overflow)
            else:
                li, ri, dd, overflow = self._compact_block(lb, rb, radius)
            pairs = [(left_ev[int(a)], right_ev[int(b)], float(d))
                     for a, b, d in zip(li, ri, dd)]
            yield JoinWindowResult(win.start, win.end, pairs, overflow,
                                   len(win.events))

    def _compact_block(self, lb, rb, radius):
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
            )
            count = int(res.count)
            if count <= self._max_pairs:
                break
            self._max_pairs = int(2 ** np.ceil(np.log2(count)))
        li = res.left_index[:count].cpu().numpy()
        ri = res.right_index[:count].cpu().numpy()
        dd = res.dist[:count].cpu().numpy()
        keep = li >= 0
        return li[keep], ri[keep], dd[keep], int(res.overflow)

    def query_panes(self, *args, **kwargs):
        raise NotImplementedError(
            "query_panes (incremental pane-carry join) is not ported yet: "
            "ROADMAP A7")

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
        it, and persists across windows. ``dtype`` is accepted for the
        JAX signature: the port computes in float32."""
        layers = self.grid.candidate_layers(radius)
        fr = self._filter_radius(radius)
        asm_l, asm_r = self._soa_assemblers()
        gen_l = soa_point_batches(self.grid, left_chunks, self.conf, asm=asm_l)
        gen_r = soa_point_batches(self.grid, right_chunks, self.conf,
                                  asm=asm_r)
        budget = max_pairs
        for kind, wl, wr in _aligned_soa_windows(
            gen_l, gen_r, lambda w: w[0].start, lambda w: w[0].start
        ):
            if kind != "both":
                w = wl[0] if kind == "left" else wr[0]
                yield (w.start, w.end, np.empty(0, np.int32),
                       np.empty(0, np.int32), np.empty(0, np.float32), 0, 0)
                continue
            win, lxy, lvalid, lcell, _ = wl
            _, rxy, rvalid, rcell, _ = wr
            # Shipped once; every budget retry reuses the device lanes.
            lanes = ship(lxy, lvalid, lcell, rxy, rvalid, rcell,
                         device=self.device).arrive()
            while True:
                res = join_window(
                    *lanes, grid_n=self.grid.n, layers=layers, radius=fr,
                    cap_left=self.cap, cap_right=self.cap, max_pairs=budget,
                )
                count = int(res.count)
                if count <= budget:
                    break
                budget = int(2 ** np.ceil(np.log2(count)))
            yield (
                win.start, win.end,
                res.left_index.cpu().numpy(), res.right_index.cpu().numpy(),
                res.dist.cpu().numpy(), count, int(res.overflow),
            )


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
