"""Shared operator machinery: configuration, device and the host→device
ship."""

from __future__ import annotations

import contextlib
from typing import Optional, Tuple

import numpy as np
import torch

from spatialflink_tpu_torch.device import resolve_device
from spatialflink_tpu_torch.grid import UniformGrid
from spatialflink_tpu_torch.operators.query_config import QueryConfiguration


class SpatialOperator:
    """Base: holds the query configuration, the grid and the device the
    operator's kernels run on (``cuda`` unless the caller asks for the
    CPU; a missing card raises, see ``device.py``)."""

    def __init__(self, conf: QueryConfiguration, grid: UniformGrid,
                 device="cuda"):
        self.conf = conf
        self.grid = grid
        self.device = resolve_device(device)


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
