"""Shared operator machinery: configuration, device, window planning,
batching and the host→device ship.

Per window an operator assembles its events into a padded batch on the
host (``models/batch.py``), centres the coordinates in float64 and casts
them to float32 (``center_coords``), ships the lanes to its device and
runs its kernels there. Query sets are packed once per run
(``pack_query_points``, ``pack_query_geometries``) with the flag table of
their cells (``flags_for_queries``). RealTime query types run as
tumbling micro-batches of ``realtime_batch_ms``; CountBased uses count
windows.
"""

from __future__ import annotations

import contextlib
from typing import Iterable, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from spatialflink_tpu_torch.device import resolve_device
from spatialflink_tpu_torch.grid import UniformGrid
from spatialflink_tpu_torch.models.batch import GeometryBatch, PointBatch
from spatialflink_tpu_torch.models.objects import LineString, Point, Polygon
from spatialflink_tpu_torch.operators.query_config import (
    QueryConfiguration,
    QueryType,
)
from spatialflink_tpu_torch.streams.soa import SoaWindowAssembler
from spatialflink_tpu_torch.streams.windows import (
    CountWindows,
    SlidingEventTimeWindows,
    TumblingEventTimeWindows,
    WindowAssembler,
    WindowBatch,
)
from spatialflink_tpu_torch.utils.interning import Interner
from spatialflink_tpu_torch.utils.padding import next_bucket, pad_to_bucket


def window_assigner_for(conf: QueryConfiguration) -> SlidingEventTimeWindows:
    if conf.query_type in (QueryType.RealTime, QueryType.RealTimeNaive):
        return TumblingEventTimeWindows(conf.realtime_batch_ms)
    return SlidingEventTimeWindows(conf.window_size_ms, conf.slide_step_ms)


def count_window_batches(
    events: Iterable, size: int, slide: int
) -> Iterator[WindowBatch]:
    """CountBased mode: fixed-count windows over arrival order. A
    window's span is the event-time extent of its slice."""
    cw = CountWindows(size, slide)
    buf: list = []
    for ev in events:
        for slice_ in cw.feed(buf, ev):
            yield WindowBatch(slice_[0].timestamp, slice_[-1].timestamp + 1,
                              list(slice_))
    if buf:
        yield WindowBatch(buf[0].timestamp, buf[-1].timestamp + 1, list(buf))


class SpatialOperator:
    """Base: holds the query configuration, the grid, the object-id
    interner and the device the operator's kernels run on (``cuda``
    unless the caller asks for the CPU; a missing card raises, see
    ``device.py``)."""

    def __init__(self, conf: QueryConfiguration, grid: UniformGrid,
                 device="cuda"):
        self.conf = conf
        self.grid = grid
        self.device = resolve_device(device)
        self.interner = Interner()

    def _assembler(self) -> WindowAssembler:
        return WindowAssembler(
            window_assigner_for(self.conf),
            timestamp_fn=lambda e: e.timestamp,
            max_out_of_orderness_ms=self.conf.allowed_lateness_ms,
            allowed_lateness_ms=self.conf.allowed_lateness_ms,
        )

    def windows(self, stream: Iterable) -> Iterator[WindowBatch]:
        if self.conf.query_type == QueryType.CountBased:
            yield from count_window_batches(
                stream, self.conf.count_window_size,
                self.conf.count_window_size,
            )
        else:
            yield from self._assembler().stream(stream)

    def _checkpointable_windows(self, stream, flush_at_end: bool = True):
        """Event-time windows for the pane-carry paths: the assembler is
        exposed as ``self.checkpoint_assembler``, and ``flush_at_end``
        False treats the end of the source as a cut (open windows stay
        buffered in the assembler) rather than the end of the stream."""
        asm = self._assembler()
        self.checkpoint_assembler = asm
        for ev in stream:
            yield from asm.feed(ev)
        if flush_at_end:
            yield from asm.flush()

    def _checkpointable_soa_windows(self, asm, chunks,
                                    flush_at_end: bool = True):
        """SoA form of ``_checkpointable_windows``: the caller's assembler
        (``streams/soa.py``) is exposed as
        ``self.checkpoint_soa_assembler``."""
        self.checkpoint_soa_assembler = asm
        for chunk in chunks:
            yield from asm.feed(chunk)
        if flush_at_end:
            yield from asm.flush()

    def point_batch(self, events: Sequence[Point]) -> PointBatch:
        # Host batches stay float64; the float32 cast happens after
        # centring (center_coords), so ~116° magnitudes lose nothing.
        batch = PointBatch.from_points(events, interner=self.interner,
                                       dtype=np.float64)
        return batch.with_cells(self.grid)

    def geometry_batch(self, events: Sequence[Polygon | LineString],
                       mesh=None) -> GeometryBatch:
        """A window's polygons or linestrings as a float64 host batch
        (centring and the float32 cast happen at ``device_verts``)."""
        if mesh is not None:
            raise NotImplementedError(
                "mesh= (multi-GPU geometry batches) is not ported yet: "
                "ROADMAP A12")
        return GeometryBatch.from_objects(events, interner=self.interner,
                                          dtype=np.float64)

    def device_q(self, coords) -> torch.Tensor:
        """Coordinates (any (..., 2) array-like: query points, packed
        boundary vertices) centred and cast to float32 (``center_coords``)
        and shipped to the operator's device."""
        host = center_coords(self.grid, np.asarray(coords, np.float64))
        return ship(host, device=self.device).arrive()[0]

    def device_verts(self, verts: np.ndarray) -> torch.Tensor:
        """Packed boundary vertices ((..., 2) arrays) on the device:
        ``device_q`` under the name the geometry paths use."""
        return self.device_q(verts)


def query_cells_of(grid: UniformGrid, query_obj) -> List[int]:
    """Flat cells a query object overlaps: a point's cell, a polygon's or
    linestring's bbox cells (the reference's gridIDsSet)."""
    if hasattr(query_obj, "grid_cells"):
        return list(query_obj.grid_cells(grid))
    raise TypeError(type(query_obj).__name__)


def flags_for_queries(grid: UniformGrid, radius: float,
                      query_objs: Sequence) -> np.ndarray:
    """The union flag table over all query objects (guaranteed wins)."""
    cells: List[int] = []
    for q in query_objs:
        cells.extend(query_cells_of(grid, q))
    return grid.neighbor_flags(radius, cells)


def pack_query_points(query_objs: Sequence[Point]) -> np.ndarray:
    """(Q, 2) float64 query coordinates."""
    return np.array([[q.x, q.y] for q in query_objs], np.float64)


def pack_query_geometries(query_objs: Sequence
                          ) -> Tuple[np.ndarray, np.ndarray]:
    """(Q, V, 2) float64 vertices + (Q, V-1) edge_valid, padded to a
    shared V (a power of two, at least 8)."""
    vmax = max(q.num_vertices_packed() for q in query_objs)
    v = next_bucket(vmax, minimum=8)
    verts = np.zeros((len(query_objs), v, 2), np.float64)
    ev = np.zeros((len(query_objs), v - 1), bool)
    for i, q in enumerate(query_objs):
        verts[i], ev[i] = q.packed(pad_to=v)
    return verts, ev


def center_coords(grid: UniformGrid, xy, dtype=np.float32) -> np.ndarray:
    """Coordinates minus the grid centre, taken in float64, then cast to
    float32.

    Degree-scale values (~116°) have float32 ulps of ~7.6e-6°, so nearby
    points would lose metres to cancellation; centred values have
    magnitudes of the extent's span, with ulps of ~1e-7°. Distances are
    translation-invariant; cells come from the original coordinates.
    The port always computes in float32 on the device, as the JAX package
    does on its accelerator (x64 off), so ``dtype`` is accepted only for
    the JAX signature and does not change the result."""
    del dtype
    cx = (grid.min_x + grid.max_x) / 2.0
    cy = (grid.min_y + grid.max_y) / 2.0
    return (np.asarray(xy, np.float64) - np.array([cx, cy])).astype(np.float32)


def device_point_args(grid: UniformGrid, xy64: np.ndarray, oid):
    """One SoA point slice → host-padded (xy, valid, cell, oid) lanes.

    Bucket padding, float64 centring before the float32 cast, and invalid
    lanes in the out-of-grid cell ``grid.num_cells``: the same lanes as
    ``PointBatch.from_arrays(...).with_cells(grid)``."""
    n = len(xy64)
    b = next_bucket(n)
    cell = grid.assign_cells_np(xy64)
    return (
        pad_to_bucket(center_coords(grid, xy64), b),
        pad_to_bucket(np.ones(n, bool), b, fill=False),
        pad_to_bucket(cell, b, fill=grid.num_cells),
        None if oid is None else pad_to_bucket(np.asarray(oid, np.int32), b,
                                               fill=0),
    )


def soa_point_batches(grid: UniformGrid, chunks, conf: QueryConfiguration,
                      asm=None):
    """SoA chunks → (window, xy, valid, cell, oid) per fired window, the
    lanes padded per ``device_point_args``. ``asm``: the sliding
    assembler to feed (a resumed one); a fresh one by default."""
    if asm is None:
        asm = SoaWindowAssembler(conf.window_size_ms, conf.slide_step_ms,
                                 ooo_ms=conf.allowed_lateness_ms)
    for win in asm.stream(chunks):
        xy64 = np.stack(
            [np.asarray(win.arrays["x"], np.float64),
             np.asarray(win.arrays["y"], np.float64)],
            axis=1,
        )
        yield (win, *device_point_args(grid, xy64, win.arrays.get("oid")))


def check_oid_range(oid, num_segments: int) -> None:
    """Dense-id contract guard: ids >= num_segments would be silently
    dropped by the digest; fail loudly at the batch boundary instead."""
    if len(oid) and int(np.max(oid)) >= num_segments:
        raise ValueError(
            f"oid {int(np.max(oid))} >= num_segments {num_segments}: "
            f"out-of-range ids would be silently dropped"
        )


class Staged:
    """Tensors whose host→device copy was started on a side stream, with
    the event that marks its end. ``arrive()`` makes the current stream
    wait for that event and returns the tensors ready to use there."""

    def __init__(self, tensors: Tuple[Optional[torch.Tensor], ...],
                 event: Optional[torch.cuda.Event]):
        self._tensors = tensors
        self._event = event

    def arrive(self) -> Tuple[Optional[torch.Tensor], ...]:
        if self._event is not None:
            cur = torch.cuda.current_stream()
            cur.wait_event(self._event)
            for t in self._tensors:
                if t is not None:
                    # Allocated on the side stream, used on this one: the
                    # caching allocator must not hand the memory back to
                    # the side stream while this stream still reads it.
                    t.record_stream(cur)
        return self._tensors


def ship(*arrays, device: torch.device,
         stream: Optional[torch.cuda.Stream] = None) -> Staged:
    """Host numpy arrays → device tensors (``None`` passes through).

    Every array is COPIED before it becomes a tensor: ``torch.from_numpy``
    shares the caller's memory, and a caller that later mutates its array
    (the codec encoder updates its predictor tables in place) must not
    change what was shipped. On a card the copy lands in pinned host
    memory and goes to the device with a non-blocking copy, on ``stream``
    when given (the pipeline's side stream) and on the current stream
    otherwise; call ``arrive()`` on the result before using it."""
    cuda = device.type == "cuda"
    side = cuda and stream is not None
    ctx = torch.cuda.stream(stream) if side else contextlib.nullcontext()
    out = []
    with ctx:
        for a in arrays:
            if a is None:
                out.append(None)
                continue
            a = np.asarray(a)
            if cuda:
                host = torch.empty(a.shape, dtype=_torch_dtype(a.dtype),
                                   pin_memory=True)
                host.numpy()[...] = a
                out.append(host.to(device, non_blocking=True))
            else:
                out.append(torch.from_numpy(np.array(a, copy=True)))
        event = None
        if side:
            event = torch.cuda.Event()
            event.record(stream)
    return Staged(tuple(out), event)


def _torch_dtype(np_dtype) -> torch.dtype:
    return torch.from_numpy(np.empty(0, np_dtype)).dtype
