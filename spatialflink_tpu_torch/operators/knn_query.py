"""Continuous kNN over a point stream: ``PointPointKNNQuery``,
``PointPolygonKNNQuery`` and ``PointLineStringKNNQuery``.

The reference's per-cell heap → ``windowAll`` merge
(knn/PointPointKNNQuery.java:132-201 + KNNQuery.java:204-308) becomes one
window kernel (``ops/knn.py``): masked distance → per-object minimum →
top-k. ``run(stream, query_obj, radius, k)`` yields one
``KnnWindowResult`` per fired window of ``Point`` objects; a polygon or
linestring query's distances go through B4. ``run_wire_panes`` is the
headline program: per slide pane one digest kernel
(``ops/wire_knn.py``), per window a merge of the window's pane digests
plus a top-k. Window results equal the JAX package's
``operators/knn_query.py``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterable, Iterator, List, Tuple

import numpy as np
import torch

from spatialflink_tpu_torch.models.objects import Point, SpatialObject
from spatialflink_tpu_torch.operators.base import (
    SpatialOperator,
    center_coords,
    check_oid_range,
    flags_for_queries,
    pack_query_geometries,
    ship,
)
from spatialflink_tpu_torch.operators.query_config import QueryType
from spatialflink_tpu_torch.ops import wire_codec as wc
from spatialflink_tpu_torch.ops.compaction import wire_pane_bucket
from spatialflink_tpu_torch.ops.knn import (
    KnnResult,
    check_k,
    empty_digest,
    knn_merge_digest_list,
    knn_points_fused,
    knn_polygon_fused,
    knn_polyline_fused,
)
from spatialflink_tpu_torch.ops.wire_knn import select_wire_digest_step
from spatialflink_tpu_torch.utils.padding import next_bucket
from spatialflink_tpu_torch import pipeline as pipeline_mod


@dataclass
class KnnWindowResult:
    """Ordered top-k of one window (ascending distance, one entry per
    objID)."""

    start: int
    end: int
    neighbors: List[Tuple[str, float, SpatialObject]]  # (objID, dist, obj)
    window_count: int


class _PointStreamKNNQuery(SpatialOperator):
    """Point stream; query = point, polygon or linestring."""

    query_kind = "point"

    def __init__(self, conf, grid, device="cuda", mesh=None):
        if mesh is not None:
            raise NotImplementedError(
                "mesh= (multi-GPU kNN) is not ported yet: ROADMAP A12")
        super().__init__(conf, grid, device=device)

    def _packed_query(self, query_obj):
        """Query vertices and edge mask for the distance evaluation.

        In approximate mode a polygon query becomes its closed bbox ring:
        0 inside the rectangle, else the min edge distance, the
        reference's getPointPolygonBBoxMinEuclideanDistance
        (knn/PointPolygonKNNQuery.java:132-146). A linestring query is
        not replaced: the reference's approximate branch calls the exact
        point-to-segments distance (DistanceFunctions.java:87-90), so
        approximate equals exact there (quirk kept, PARITY.md). A point
        query has no approximate branch. The cell flags always come from
        the original geometry."""
        if self.conf.approximate_query and self.query_kind == "polygon":
            x0, y0, x1, y1 = query_obj.bbox()
            ring = np.asarray(
                [[x0, y0], [x1, y0], [x1, y1], [x0, y1], [x0, y0]],
                np.float64)
            return ring, np.ones(4, bool)
        verts, ev = pack_query_geometries([query_obj])
        return verts[0], ev[0]

    def run(self, stream: Iterable[Point], query_obj: SpatialObject,
            radius: float, k: int, dtype=np.float64, mesh=None,
            driver=None) -> Iterator[KnnWindowResult]:
        """One ``KnnWindowResult`` per fired window (WindowBased, RealTime
        micro-batches, CountBased): the JAX operator's plain window loop,
        errors propagating. A window's segment count is the interned
        objIDs so far, bucketed to a power of two of at least 64; ``k``
        above it raises ``ValueError`` in that window, as the reference's
        top-k does. ``dtype`` is accepted for the JAX signature: the port
        computes in float32."""
        if driver is not None:
            raise NotImplementedError(
                "driver= (checkpointing, retry, failover) is not ported "
                "yet: ROADMAP A11")
        if mesh is not None:
            raise NotImplementedError(
                "mesh= (multi-GPU kNN) is not ported yet: ROADMAP A12")
        flags = flags_for_queries(self.grid, radius, [query_obj])
        (flags_d,) = ship(flags, device=self.device).arrive()
        if self.query_kind == "point":
            query = (self.device_q([query_obj.x, query_obj.y]),)
            kernel = knn_points_fused
        else:
            verts, ev = self._packed_query(query_obj)
            query = (self.device_verts(verts),
                     *ship(ev, device=self.device).arrive())
            kernel = knn_polygon_fused if self.query_kind == "polygon" \
                else knn_polyline_fused
        for win in self.windows(stream):
            batch = self.point_batch(win.events)
            nseg = next_bucket(max(self.interner.num_segments, 1),
                               minimum=64)
            xy_d, valid_d, cell_d, oid_d = ship(
                center_coords(self.grid, batch.xy), batch.valid, batch.cell,
                batch.oid, device=self.device).arrive()
            res = kernel(xy_d, valid_d, cell_d, flags_d, oid_d, *query,
                         radius, k, nseg)
            yield self._decode(win, res)

    def _decode(self, win, res: KnnResult) -> KnnWindowResult:
        nv = int(res.num_valid)
        segs = res.segment[:nv].cpu().numpy()
        dists = res.dist[:nv].cpu().numpy()
        idxs = res.index[:nv].cpu().numpy()
        neighbors = [
            (self.interner.lookup(int(s)), float(d), win.events[int(i)])
            for s, d, i in zip(segs, dists, idxs)
        ]
        return KnnWindowResult(win.start, win.end, neighbors,
                               len(win.events))


class PointPointKNNQuery(_PointStreamKNNQuery):
    """Point stream, point query: continuous kNN
    (knn/PointPointKNNQuery.java)."""

    query_kind = "point"

    def restore_wire_pane_carry(self, carry: dict) -> None:
        """Resume ``run_wire_panes`` from a checkpoint carry (this
        operator's ``_wire_pane_carry``, or ``state.carry_from_jax`` of
        the JAX operator's). Consumed by the NEXT ``run_wire_panes`` call
        only: the carry is pane-INDEX based, so resuming it on an
        ordinary second call would silently time-shift every window."""
        self._wire_pane_carry = carry
        self._wire_pane_restored = True

    def run_wire_panes(
        self,
        slides,
        query_point: Point,
        radius: float,
        k: int,
        num_segments: int,
        wire_format,
        start_ms: int = 0,
        strategy: str = "auto",
        flush_at_end: bool = True,
    ):
        """Wire-plane pane-carry kNN: the headline program.

        ``slides``: iterable of (3, n_i) uint16 PLANE-MAJOR pane arrays
        in the 6 B/pt wire format (``streams/wire.py``), rows x_q, y_q
        and interned-int16-oid bits, one array per ``slide_step`` pane in
        event-time order. Pane i covers [start_ms + i·slide,
        start_ms + (i+1)·slide); every window OVERLAPPING a received
        NON-EMPTY pane fires, including the leading partial windows
        and, with ``flush_at_end``, the trailing partials. Windows whose
        every pane held zero events (gap windows) are suppressed. Yields
        (start, end, oids, dists, num_valid) per window, oids and dists
        as numpy arrays. Variable pane sizes are padded to
        ``wire_pane_bucket`` lanes and masked by ``n_valid``. ``k`` above
        ``num_segments`` raises ``ValueError`` before the first pane.

        ``strategy``: "auto", or the device's own digest step ("cuda" on
        a card, "torch" on the CPU). On a card the first pane is digested
        by the kernel and its plain version, and a mismatch raises. The
        chosen kind lands on ``self.last_wire_digest_kind``.

        **Pipelined mode** (``SFT_PIPELINE`` / ``pipeline.install``):
        the same per-pane kernels run through the bounded
        ship/compute/fetch executor (pane N+1 copies on a side stream
        while window N computes, window N−1's fetch lags), optionally
        with the delta-bitpacked codec shrinking the shipped bytes.
        Results are bit-identical to the synchronous loop, and the
        checkpoint carry advances only with YIELDED windows. The codec
        kind lands on ``self.last_wire_codec_kind``.
        """
        conf = self.conf
        if conf.query_type == QueryType.CountBased:
            raise ValueError(
                "run_wire_panes requires time-based sliding windows"
            )
        check_k(k, num_segments)
        size, slide_ms = conf.window_size_ms, conf.slide_step_ms
        if conf.query_type in (QueryType.RealTime, QueryType.RealTimeNaive):
            size = slide_ms = conf.realtime_batch_ms
        if size % slide_ms != 0:
            raise ValueError("run_wire_panes requires size % slide == 0")
        ppw = size // slide_ms
        dev = self.device

        q = np.asarray([query_point.x, query_point.y], np.float32)
        scale, origin = wire_format.scale, wire_format.origin
        r32 = np.float32(radius)
        step = None
        self.last_wire_digest_kind = None
        self.last_wire_codec_kind = None
        empty = empty_digest(num_segments, dev)

        # Operator-owned, checkpointable state: the live digest ring, the
        # per-pane event counts and the next logical pane index. Consumed
        # only right after restore_wire_pane_carry.
        saved = None
        if getattr(self, "_wire_pane_restored", False):
            saved = getattr(self, "_wire_pane_carry", None)
        self._wire_pane_restored = False
        codec_state = None
        if saved is not None:
            pane0 = int(saved["next_pane"])
            digests = [(s.to(dev), r.to(dev)) for s, r in saved["digests"]]
            # Snapshots without the count ring: assume the carried panes
            # were non-empty (their windows fire).
            counts = [int(c) for c in saved.get(
                "counts", [1] * len(digests)
            )]
            codec_state = saved.get("codec")
        else:
            pane0 = 0
            # Seed the ring with ppw-1 empty digests so the LEADING
            # partial windows fire.
            digests = [empty] * (ppw - 1)
            counts = [0] * (ppw - 1)
        self._wire_pane_carry = {
            "next_pane": pane0, "digests": list(digests),
            "counts": list(counts),
        }

        def digest_pane(wire_d, n):
            nonlocal step
            if step is None:
                self.last_wire_digest_kind, step = select_wire_digest_step(
                    wire_d, n, q, scale, origin, r32,
                    num_segments=num_segments, strategy=strategy,
                )
            return step(wire_d, n)

        def merge_window(pane_i):
            # Gap-window suppression: event count, NOT digest liveness,
            # decides; a window of events all out of radius still fires
            # (nv = 0).
            if not any(counts):
                return None
            res = knn_merge_digest_list(
                [s for s, _ in digests], [r for _, r in digests], k,
            )
            return (start_ms + (pane_i - ppw + 1) * slide_ms, res)

        def fetch_one(w_start, res):
            nv = int(res.num_valid)
            segs = res.segment[:nv].cpu().numpy()
            dists = res.dist[:nv].cpu().numpy()
            return (w_start, w_start + size, segs, dists, nv)

        def carry_now(next_pane):
            return {
                "next_pane": next_pane, "digests": list(digests),
                "counts": list(counts),
            }

        def emit(pane_i, carry):
            out = merge_window(pane_i)
            # Publish the ring state as of this pane BEFORE yielding its
            # window: a checkpoint taken at the yield counts it emitted.
            self._wire_pane_carry = carry
            if out is not None:
                yield fetch_one(*out)

        def check_pane(wire_p):
            if (wire_p.ndim != 2 or wire_p.shape[0] != 3
                    or wire_p.dtype != np.uint16):
                raise ValueError(
                    "run_wire_panes expects (3, n) uint16 plane-major "
                    f"panes, got {wire_p.dtype} {wire_p.shape}"
                )
            check_oid_range(wire_p[2].view(np.int16), num_segments)

        def padded(wire_p):
            n = wire_p.shape[1]
            nb = wire_pane_bucket(n)
            if nb != n:
                wire_p = np.concatenate(
                    [wire_p, np.zeros((3, nb - n), np.uint16)], axis=1
                )
            return wire_p

        def push(d, n):
            digests.append((d.seg_min, d.rep))
            counts.append(n)
            del digests[:-ppw]
            del counts[:-ppw]

        def _pipelined(pol):
            """ship(N+1)/compute(N)/fetch(N−1) through the executor
            (``pipeline.py``), with the delta codec on the wire when the
            policy arms it. The checkpoint carry publishes per YIELDED
            window, so a kill mid-overlap replays the in-flight windows.
            Codec predictor state restarts at zero unless the restored
            carry holds a ``codec`` state (``state.carry_from_jax``);
            either way results cannot change, only compression."""
            use_codec = pol.codec == "delta"
            side = torch.cuda.Stream(dev) if dev.type == "cuda" else None
            encoder = wc.WirePaneEncoder(num_segments) if use_codec \
                else None
            dec = {"px": None, "py": None}
            if use_codec:
                if codec_state is not None:
                    encoder.restore(codec_state)
                # ship copies the tables: the encoder updates its own in
                # place on every encode.
                dec["px"], dec["py"] = ship(
                    encoder.pred_x, encoder.pred_y, device=dev
                ).arrive()
            state = {"last_i": pane0 - 1,
                     "last_carry": self._wire_pane_carry}

            def items():
                for i, wire_p in enumerate(slides, start=pane0):
                    state["last_i"] = i
                    yield (i, np.asarray(wire_p))
                if flush_at_end and (state["last_i"] >= pane0
                                     or pane0 > 0):
                    for j in range(1, ppw):
                        yield (state["last_i"] + j, None)

            def ship_stage(item):
                _i, wire_p = item
                if wire_p is None:  # synthetic trailing flush pane
                    return None
                check_pane(wire_p)
                n = wire_p.shape[1]
                if use_codec:
                    enc = encoder.encode(wire_p)
                    nb = wire_pane_bucket(n)
                    wb = wc.wire_word_bucket(len(enc.words), nb)
                    words = wc.pad_words(enc.words, wb).view(np.int32)
                    return ("coded", ship(words, device=dev, stream=side),
                            n, nb, enc.bx, enc.by, enc.bo)
                return ("raw", ship(padded(wire_p), device=dev,
                                    stream=side), n)

            def compute_stage(item, staged):
                i, _ = item
                if staged is None:
                    push(empty, 0)
                else:
                    if staged[0] == "coded":
                        _, st, n, nb, bx, by, bo = staged
                        (words_d,) = st.arrive()
                        args = (words_d, n, bx, by, bo, dec["px"],
                                dec["py"])
                        if self.last_wire_codec_kind is None:
                            self.last_wire_codec_kind, _ = \
                                wc.select_wire_decoder(
                                    pol.codec_strategy, sample_args=args,
                                    n=nb, num_segments=num_segments,
                                )
                        pane_d, dec["px"], dec["py"] = wc.decode_wire_pane(
                            *args, n=nb, num_segments=num_segments,
                        )
                    else:
                        _, st, n = staged
                        (pane_d,) = st.arrive()
                    push(digest_pane(pane_d, n), n)
                    # Synthetic panes never advance the carry: entries
                    # keep the last REAL pane's ring.
                    state["last_carry"] = carry_now(i + 1)
                out = merge_window(i)
                if out is None:
                    return None
                return (out, state["last_carry"])

            def fetch_stage(works):
                # Carries ride OUT with their windows, unpublished: a
                # multi-window drain must not advance the carry past
                # windows the consumer has not received yet.
                return [(carry, fetch_one(*out)) for out, carry in works]

            ex = pipeline_mod.PipelinedExecutor(
                pol, ship=ship_stage, compute=compute_stage,
                fetch=fetch_stage,
            )
            for carry, out in ex.run(items()):
                self._wire_pane_carry = carry
                yield out
            # End-of-call invariant: every consumed REAL pane is in the
            # carry, emitted or not.
            self._wire_pane_carry = state["last_carry"]

        pol = pipeline_mod.policy()
        if pol is not None:
            yield from _pipelined(pol)
            return

        i = pane0 - 1
        last_carry = self._wire_pane_carry
        for i, wire_p in enumerate(slides, start=pane0):
            wire_p = np.asarray(wire_p)
            check_pane(wire_p)
            n = wire_p.shape[1]
            (wire_d,) = ship(padded(wire_p), device=dev).arrive()
            push(digest_pane(wire_d, n), n)
            last_carry = carry_now(i + 1)
            yield from emit(i, last_carry)
        # Flush iff ≥1 REAL pane exists in the logical stream: consumed
        # this call or before the checkpoint (pane0 > 0).
        if flush_at_end and (i >= pane0 or pane0 > 0):
            # Trailing partial windows: panes shift out, empties in.
            # Synthetic panes never advance the carry.
            for j in range(1, ppw):
                push(empty, 0)
                yield from emit(i + j, last_carry)
        # End-of-call invariant: every consumed REAL pane is in the
        # carry, whether or not its window was emitted.
        self._wire_pane_carry = last_carry


class PointPolygonKNNQuery(_PointStreamKNNQuery):
    """knn/PointPolygonKNNQuery.java: JTS distance, 0 inside the query."""

    query_kind = "polygon"


class PointLineStringKNNQuery(_PointStreamKNNQuery):
    """knn/PointLineStringKNNQuery.java: the min edge distance."""

    query_kind = "linestring"
