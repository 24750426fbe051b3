"""Device meshes: the port's counterpart of ``jax.sharding.Mesh``.

The reference scales by Flink keyBy-hash partitioning over a cluster
(``env.setParallelism(n)``, StreamingJob.java:177; conf default 15). The
JAX package shards a window over a mesh of accelerator chips: the stream
axis splits over a ``data`` axis (hash partitioning without the shuffle:
the grid prune is a flag gather, not a key exchange) and query sets may
split over a second ``query`` axis.

Here a mesh is an array of ``torch.device``s in one process: shard *i*
of a window runs on ``devices[i]``, and the collectives are explicit
device copies and reductions (``parallel/sharded.py``). A mesh may list
one device more than once: ``["cuda:0"] * 4`` runs four shards on one
card, ``["cpu"] * 8`` eight on the CPU (the JAX tests' eight virtual
CPU devices). No device falls back to another: a mesh that names
``cuda`` on a machine without a card raises (``device.py``).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch

from spatialflink_tpu_torch.device import resolve_device


class Mesh:
    """A logical device grid.

    ``devices``: an object array of ``torch.device`` in the mesh's shape;
    ``axis_names``: one name an axis; ``shape``: name → size, read as the
    JAX code reads it (``mesh.shape.get("data", 1)``); ``size``: the
    device count. Equal meshes hash alike, so programs cache per mesh."""

    __slots__ = ("devices", "axis_names", "shape", "size", "_key")

    def __init__(self, devices: np.ndarray, axis_names: Sequence[str]):
        devices = np.asarray(devices, dtype=object)
        axis_names = tuple(axis_names)
        if devices.ndim != len(axis_names):
            raise ValueError(
                f"mesh of {devices.ndim} axes given {len(axis_names)} names")
        self.devices = devices
        self.axis_names = axis_names
        self.shape: Dict[str, int] = dict(zip(axis_names, devices.shape))
        self.size = int(devices.size)
        self._key = (axis_names, devices.shape,
                     tuple(str(d) for d in devices.flat))

    def __eq__(self, other) -> bool:
        return isinstance(other, Mesh) and self._key == other._key

    def __hash__(self) -> int:
        return hash(self._key)

    def __repr__(self) -> str:
        return (f"Mesh({self.shape}, "
                f"devices={[str(d) for d in self.devices.flat]})")


def require_mesh(mesh) -> Mesh:
    """``mesh`` itself, or ``TypeError`` when it is not a ``Mesh``."""
    if not isinstance(mesh, Mesh):
        raise TypeError(
            f"mesh must be a spatialflink_tpu_torch.parallel.mesh.Mesh, "
            f"got {type(mesh).__name__}")
    return mesh


def _visible_cards() -> list:
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_mesh(shape: Sequence[int], axis_names: Sequence[str],
              devices=None) -> Mesh:
    """A mesh of the given logical shape over the first prod(shape)
    devices: by default the visible cards ``cuda:0..n-1``. An explicit
    ``devices`` list may repeat a device."""
    devices = list(devices) if devices is not None else _visible_cards()
    n = int(np.prod(shape))
    if len(devices) < n:
        raise ValueError(f"need {n} devices, have {len(devices)}")
    arr = np.empty(n, dtype=object)
    for i, d in enumerate(devices[:n]):
        arr[i] = resolve_device(d)
    return Mesh(arr.reshape(tuple(shape)), axis_names)


def data_mesh(num_devices: Optional[int] = None, devices=None) -> Mesh:
    """1-D data-parallel mesh over all (or the first N) devices."""
    devices = list(devices) if devices is not None else _visible_cards()
    n = num_devices if num_devices is not None else len(devices)
    return make_mesh((n,), ("data",), devices)


def itemsize(dtype) -> int:
    """Bytes an element of a numpy or torch ``dtype``."""
    if isinstance(dtype, torch.dtype):
        return dtype.itemsize
    return int(np.dtype(dtype).itemsize)


def payload_nbytes(*arrays) -> int:
    """Logical payload bytes of the given arrays (numpy or torch), from
    their shape and dtype only: never a device read, so it is safe in
    per-window host paths (the ``telemetry.account_collective`` feeder;
    a replicated operand's bytes are its broadcast payload)."""
    total = 0
    for a in arrays:
        shape = getattr(a, "shape", None)
        dtype = getattr(a, "dtype", None)
        if shape is None or dtype is None:
            continue
        total += int(np.prod(tuple(shape), dtype=np.int64)) * itemsize(dtype)
    return total
