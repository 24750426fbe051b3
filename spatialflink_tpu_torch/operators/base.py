"""Shared operator machinery: configuration, device, window planning,
batching and the host→device ship.

Per window an operator assembles its events into a padded batch on the
host (``models/batch.py``), centres the coordinates in float64 and casts
them to float32 (``center_coords``), ships the lanes to its device and
runs its kernels there. In the float64 mode (``precision.py``: x64 on and
``dtype`` float64) the coordinates ship raw in float64 instead. Query
sets are packed once per run (``pack_query_points``,
``pack_query_geometries``) with the flag table of their cells
(``flags_for_queries``). RealTime query types run as
tumbling micro-batches of ``realtime_batch_ms``; CountBased uses count
windows.

Every window and pane program an operator runs goes through ``jitted``,
which wraps it in ``telemetry.instrument_jit`` under the JAX package's
label for the same program (its ``device.dispatch`` fault point, its
ablation, its dispatch table), and every host→device copy through
``ship`` (the ``device.ship`` fault point and the h2d byte count).
"""

from __future__ import annotations

import contextlib
import functools
from typing import Iterable, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from spatialflink_tpu_torch.device import resolve_device
from spatialflink_tpu_torch.faults import faults
from spatialflink_tpu_torch.grid import UniformGrid
from spatialflink_tpu_torch.models.batch import GeometryBatch, PointBatch
from spatialflink_tpu_torch.models.objects import LineString, Point, Polygon
from spatialflink_tpu_torch.ops.counters import counters
from spatialflink_tpu_torch.parallel.mesh import require_mesh
from spatialflink_tpu_torch.precision import effective_f64
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
from spatialflink_tpu_torch.telemetry import instrument_jit, telemetry
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
    ``device.py``).

    ``mesh``: an optional ``parallel/mesh.py:Mesh`` with a ``data`` axis.
    When set (or passed to ``run``), window kernels run sharded over it
    (``parallel/sharded.py``), the runtime analog of the reference's
    parallel execution (env.setParallelism, StreamingJob.java:177; conf
    default 15 at conf/geoflink-conf.yml:55), with the unsharded
    results: elementwise kernels split the stream axis, kNN merges the
    shards' per-object digests. Point batches pad to power-of-two
    buckets (at least 256), so any power-of-two ``data`` axis up to 256
    divides them (``mesh_from_config`` enforces power-of-two); geometry
    batches raise their bucket floor to the data-axis size in
    ``geometry_batch``. Every mesh device must be of the operator's
    device type (``check_mesh``): a card operator never runs a shard on
    the CPU."""

    def __init__(self, conf: QueryConfiguration, grid: UniformGrid,
                 device="cuda", mesh=None):
        self.conf = conf
        self.grid = grid
        self.device = resolve_device(device)
        self.mesh = self.check_mesh(mesh)
        self.interner = Interner()

    def check_mesh(self, mesh):
        """``mesh`` (None passes), raising ``TypeError`` for anything but
        a ``parallel/mesh.py:Mesh`` and ``ValueError`` when one of its
        devices is not of the operator's device type."""
        if mesh is not None:
            require_mesh(mesh)
            bad = [str(d) for d in mesh.devices.flat
                   if d.type != self.device.type]
            if bad:
                raise ValueError(
                    f"mesh devices {bad} are not {self.device.type} "
                    f"devices, the operator's")
        return mesh

    def run_mesh(self, mesh):
        """The mesh a run executes on: its ``mesh=`` argument, checked,
        else the operator's. A mesh run takes the unsharded run's lanes,
        float64 ones in the float64 mode included (``precision.py``)."""
        return self.check_mesh(mesh) if mesh is not None else self.mesh

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

    def _adopt_assembler(self, asm) -> WindowAssembler:
        """The restore-and-expose protocol of an assembler (the dataflow
        driver's too, ``driver.py``): a state restored by
        ``checkpoint.restore_operator`` is consumed before the first
        event, and the assembler is exposed as
        ``self.checkpoint_assembler`` for ``checkpoint.operator_state``."""
        if getattr(self, "_restored_assembler", None):
            from spatialflink_tpu_torch.checkpoint import restore_assembler

            restore_assembler(asm, self._restored_assembler)
            self._restored_assembler = None
        self.checkpoint_assembler = asm
        return asm

    def _adopt_soa_assembler(self, asm):
        """SoA form of ``_adopt_assembler`` (the point and the ragged
        assemblers both snapshot through
        ``checkpoint.soa_assembler_state``)."""
        if getattr(self, "_restored_soa_assembler", None):
            from spatialflink_tpu_torch.checkpoint import (
                restore_soa_assembler,
            )

            restore_soa_assembler(asm, self._restored_soa_assembler)
            self._restored_soa_assembler = None
        self.checkpoint_soa_assembler = asm
        return asm

    def _checkpointable_windows(self, stream, flush_at_end: bool = True):
        """Event-time windows for the pane-carry paths, through
        ``_adopt_assembler`` (a restored state is consumed before the
        first event); ``flush_at_end`` False treats the end of the source
        as a cut (open windows stay buffered in the assembler) rather
        than the end of the stream."""
        asm = self._adopt_assembler(self._assembler())
        for ev in stream:
            yield from asm.feed(ev)
        if flush_at_end:
            yield from asm.flush()

    def _checkpointable_soa_windows(self, asm, chunks,
                                    flush_at_end: bool = True):
        """SoA form of ``_checkpointable_windows``: the caller's assembler
        (``streams/soa.py``) goes through ``_adopt_soa_assembler``."""
        self._adopt_soa_assembler(asm)
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
        (centring and the float32 cast happen at ``device_verts``). The
        bucket floor is 8; under a mesh (``mesh``, else the operator's)
        the object axis must divide by the data-axis size, so the floor
        rises to it (buckets are floor·2^k, so they divide by it)."""
        mesh = self.run_mesh(mesh)
        bucket = None
        if mesh is not None:
            data = mesh.shape.get("data", 1)
            bucket = next_bucket(len(events), minimum=max(8, int(data)))
        return GeometryBatch.from_objects(events, interner=self.interner,
                                          dtype=np.float64, bucket=bucket)

    def device_q(self, coords, dtype=np.float32) -> torch.Tensor:
        """Coordinates (any (..., 2) array-like: query points, packed
        boundary vertices) as ``center_coords`` gives them for ``dtype``
        (centred float32, or raw float64 in the float64 mode), shipped to
        the operator's device."""
        host = center_coords(self.grid, np.asarray(coords, np.float64), dtype)
        return ship(host, device=self.device).arrive()[0]

    def device_xy(self, batch: PointBatch, dtype=np.float32) -> torch.Tensor:
        """A point batch's coordinates on the device: ``device_q`` of
        ``batch.xy``."""
        return self.device_q(batch.xy, dtype)

    def device_verts(self, verts: np.ndarray, dtype=np.float32
                     ) -> torch.Tensor:
        """Packed boundary vertices ((..., 2) arrays) on the device:
        ``device_q`` under the name the geometry paths use."""
        return self.device_q(verts, dtype)


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


def pack_query_points(query_objs: Sequence[Point],
                      dtype=np.float64) -> np.ndarray:
    """(Q, 2) query coordinates in ``dtype`` (float64 by default: the
    host keeps float64, ``center_coords`` makes the device lanes)."""
    return np.array([[q.x, q.y] for q in query_objs], dtype)


def pack_query_geometries(query_objs: Sequence, dtype=np.float64
                          ) -> Tuple[np.ndarray, np.ndarray]:
    """(Q, V, 2) vertices in ``dtype`` (float64 by default) + (Q, V-1)
    edge_valid, padded to a shared V (a power of two, at least 8)."""
    vmax = max(q.num_vertices_packed() for q in query_objs)
    v = next_bucket(vmax, minimum=8)
    verts = np.zeros((len(query_objs), v, 2), dtype)
    ev = np.zeros((len(query_objs), v - 1), bool)
    for i, q in enumerate(query_objs):
        verts[i], ev[i] = q.packed(pad_to=v)
    return verts, ev


def center_coords(grid: UniformGrid, xy, dtype=np.float32) -> np.ndarray:
    """The device lanes of coordinates ``xy`` for a request of ``dtype``.

    The rule is the JAX package's: with ``dtype`` float64 and the float64
    mode on (``precision.effective_f64``), the coordinates come back raw,
    uncentred, in float64, and the kernels compute in float64. Otherwise
    they come back minus the grid centre, taken in float64, then cast to
    float32: degree-scale values (~116°) have float32 ulps of ~7.6e-6°,
    so nearby points would lose metres to cancellation; centred values
    have magnitudes of the extent's span, with ulps of ~1e-7°. Distances
    are translation-invariant; cells come from the original coordinates.
    The default ``dtype`` is float32, so a caller that passes none gets
    the centred float32 lanes whatever the mode."""
    if effective_f64(dtype):
        return np.asarray(xy, np.float64)
    cx = (grid.min_x + grid.max_x) / 2.0
    cy = (grid.min_y + grid.max_y) / 2.0
    return (np.asarray(xy, np.float64) - np.array([cx, cy])).astype(np.float32)


def device_point_args(grid: UniformGrid, xy64: np.ndarray, oid,
                      dtype=np.float32):
    """One SoA point slice → host-padded (xy, valid, cell, oid) lanes.

    Bucket padding, ``center_coords`` of ``dtype`` (float64 centring
    before the float32 cast, or raw float64 in the float64 mode), and
    invalid lanes in the out-of-grid cell ``grid.num_cells``: the same
    lanes as ``PointBatch.from_arrays(...).with_cells(grid)``."""
    n = len(xy64)
    b = next_bucket(n)
    cell = grid.assign_cells_np(xy64)
    return (
        pad_to_bucket(center_coords(grid, xy64, dtype), b),
        pad_to_bucket(np.ones(n, bool), b, fill=False),
        pad_to_bucket(cell, b, fill=grid.num_cells),
        None if oid is None else pad_to_bucket(np.asarray(oid, np.int32), b,
                                               fill=0),
    )


def soa_point_batches(grid: UniformGrid, chunks, conf: QueryConfiguration,
                      dtype=np.float32, asm=None):
    """SoA chunks → (window, xy, valid, cell, oid) per fired window, the
    lanes padded per ``device_point_args`` for ``dtype``. ``asm``: the
    sliding assembler to feed (a resumed one); a fresh one by default.
    While ``ops/counters.py`` is enabled each window counts its points
    there (the throughput meter); the caller, which owns the flags, counts
    the candidates."""
    if asm is None:
        asm = SoaWindowAssembler(conf.window_size_ms, conf.slide_step_ms,
                                 ooo_ms=conf.allowed_lateness_ms)
    for win in asm.stream(chunks):
        if counters.enabled:
            counters.record_window(win.count, 0, 0)
        xy64 = np.stack(
            [np.asarray(win.arrays["x"], np.float64),
             np.asarray(win.arrays["y"], np.float64)],
            axis=1,
        )
        yield (win, *device_point_args(grid, xy64, win.arrays.get("oid"),
                                       dtype))


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


@functools.lru_cache(maxsize=None)
def jitted(fn, label: Optional[str] = None):
    """``fn`` (a window or pane program) wrapped by
    ``telemetry.instrument_jit`` under ``label``, by default its
    ``__name__``: the label the JAX package's ``jitted`` gives the same
    program, so an ablation spec or a ledger names one kernel in both
    packages. Cached, so each program has one wrapper."""
    return instrument_jit(fn, name=label or fn.__name__)


def window_program(mesh, kernel, data_idx, n_args, topk=False, reduce=False,
                   label: Optional[str] = None, **statics):
    """Mesh-or-single dispatch for a fused window kernel: a callable of
    the kernel's positional arguments.

    With a mesh: the same kernel sharded over the ``data`` axis
    (``parallel/sharded.py:sharded_window_kernel``; topk kernels merge
    per-object digests, reduce kernels combine their segment tables,
    elementwise kernels stay sharded), instrumented as
    ``sharded:<kernel>``, the JAX package's label. Without: ``jitted``
    under ``label`` (by default the kernel's name) with the statics
    bound. Every operator's mesh path goes through here, so an
    execution mode lands in one place."""
    if mesh is not None:
        from spatialflink_tpu_torch.parallel.sharded import (
            sharded_window_kernel,
        )

        prog = sharded_window_kernel(mesh, kernel, data_idx, n_args,
                                     topk=topk, reduce=reduce, **statics)
        return instrument_jit(prog, name=f"sharded:{kernel.__name__}")
    return functools.partial(jitted(kernel, label), **statics)


def ship(*arrays, device: torch.device,
         stream: Optional[torch.cuda.Stream] = None) -> Staged:
    """Host numpy arrays → device tensors (``None`` passes through).

    Every array is COPIED before it becomes a tensor: ``torch.from_numpy``
    shares the caller's memory, and a caller that later mutates its array
    (the codec encoder updates its predictor tables in place) must not
    change what was shipped. On a card the copy lands in pinned host
    memory and goes to the device with a non-blocking copy, on ``stream``
    when given (the pipeline's side stream) and on the current stream
    otherwise; call ``arrive()`` on the result before using it.

    This is the ``device.ship`` fault point, and the one place the h2d
    bytes are counted: one ``account_h2d`` a call, of the host arrays'
    ``nbytes`` read before the copy (``None`` lanes uncounted), on the
    side stream as on the current one."""
    if faults.armed:  # fault injection point (faults.py)
        faults.hit("device.ship")
    if telemetry.enabled:
        telemetry.account_h2d(
            sum(np.asarray(a).nbytes for a in arrays if a is not None))
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
