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

A mesh may also span processes (``parallel/multihost.py:
global_data_mesh``): each shard then carries the rank of the process
that owns it, every process runs only its own shards, and
``gather_shard_parts`` all-gathers the per-shard parts over the
``torch.distributed`` group, in shard order, before the finish phase
that every process runs alike. A mesh built in one process carries no
ranks and behaves as it always has.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from spatialflink_tpu_torch.device import resolve_device


class Mesh:
    """A logical device grid.

    ``devices``: an object array of ``torch.device`` in the mesh's shape;
    ``axis_names``: one name an axis; ``shape``: name → size, read as the
    JAX code reads it (``mesh.shape.get("data", 1)``); ``size``: the
    device count; ``ranks``: None in one process, else an int array in
    the mesh's shape, the rank of the process owning each device. Equal
    meshes hash alike, so programs cache per mesh."""

    __slots__ = ("devices", "axis_names", "shape", "size", "ranks", "_key")

    def __init__(self, devices: np.ndarray, axis_names: Sequence[str],
                 ranks=None):
        devices = np.asarray(devices, dtype=object)
        axis_names = tuple(axis_names)
        if devices.ndim != len(axis_names):
            raise ValueError(
                f"mesh of {devices.ndim} axes given {len(axis_names)} names")
        if ranks is not None:
            ranks = np.asarray(ranks, dtype=np.int64).reshape(devices.shape)
        self.devices = devices
        self.axis_names = axis_names
        self.shape: Dict[str, int] = dict(zip(axis_names, devices.shape))
        self.size = int(devices.size)
        self.ranks = ranks
        self._key = (axis_names, devices.shape,
                     tuple(str(d) for d in devices.flat),
                     None if ranks is None else tuple(ranks.flat))

    def __eq__(self, other) -> bool:
        return isinstance(other, Mesh) and self._key == other._key

    def __hash__(self) -> int:
        return hash(self._key)

    def __repr__(self) -> str:
        ranks = "" if self.ranks is None else \
            f", ranks={[int(r) for r in self.ranks.flat]}"
        return (f"Mesh({self.shape}, "
                f"devices={[str(d) for d in self.devices.flat]}{ranks})")


def require_mesh(mesh) -> Mesh:
    """``mesh`` itself, or ``TypeError`` when it is not a ``Mesh``."""
    if not isinstance(mesh, Mesh):
        raise TypeError(
            f"mesh must be a spatialflink_tpu_torch.parallel.mesh.Mesh, "
            f"got {type(mesh).__name__}")
    return mesh


def spans_processes(mesh) -> bool:
    """Whether ``mesh`` spans processes (it carries ranks)."""
    return getattr(mesh, "ranks", None) is not None


def require_one_process(mesh, what: str):
    """``ValueError`` when ``mesh`` spans processes: ``what`` runs its
    shards in one process only (ROADMAP A12.3)."""
    if spans_processes(mesh):
        raise ValueError(
            f"{what} runs on a mesh in one process only; this mesh spans "
            f"processes (ROADMAP A12.3)")


def _data_ranks(mesh: Mesh) -> np.ndarray:
    return mesh.ranks.reshape(mesh.ranks.shape[0], -1)[:, 0]


def local_shards(mesh: Mesh) -> List[int]:
    """The ``data``-axis shards this process runs: all of them on a mesh
    in one process, else those its rank owns."""
    n = int(mesh.devices.shape[0])
    if not spans_processes(mesh):
        return list(range(n))
    import torch.distributed as dist

    me = dist.get_rank()
    return [s for s, r in enumerate(_data_ranks(mesh)) if int(r) == me]


def home_device(mesh: Mesh) -> torch.device:
    """Where the finish phase runs: the mesh's first device, or on a mesh
    spanning processes the first device this process owns."""
    first = mesh.devices.reshape(mesh.devices.shape[0], -1)[:, 0]
    return first[local_shards(mesh)[0]]


def _tree_to(part, dev):
    """A shard part (a tensor, numpy array, scalar or a tuple / named
    tuple of them) with its tensors on ``dev``."""
    if isinstance(part, torch.Tensor):
        return part.to(dev)
    if isinstance(part, tuple):
        fields = [_tree_to(p, dev) for p in part]
        return type(part)(*fields) if hasattr(part, "_fields") else tuple(
            fields)
    return part


def gather_shard_parts(mesh: Mesh, parts: Dict[int, object]) -> list:
    """Per-shard parts, ``{shard: part}`` for this process's shards, as a
    list in shard order. On a mesh in one process that is every shard
    already. On a mesh spanning processes the parts all-gather over the
    ``torch.distributed`` group: each is copied to the host before the
    collective (gloo moves tensors only through host memory, and no CUDA
    tensor must reach it) and to this process's home device after it."""
    if not spans_processes(mesh):
        return [parts[s] for s in range(len(parts))]
    import torch.distributed as dist

    host = {s: _tree_to(p, torch.device("cpu")) for s, p in parts.items()}
    everyone = [None] * dist.get_world_size()
    dist.all_gather_object(everyone, host)
    merged = {}
    for got in everyone:
        merged.update(got)
    n = int(mesh.devices.shape[0])
    if sorted(merged) != list(range(n)):
        raise RuntimeError(f"shard parts {sorted(merged)} do not cover the "
                           f"{n} shards of {mesh}")
    home = home_device(mesh)
    return [_tree_to(merged[s], home) for s in range(n)]


def map_shards(mesh: Mesh, fn: Callable[[int], object]) -> list:
    """``[fn(s) for s in shards]`` over the ``data`` axis, with ``fn`` run
    only on this process's shards and the parts gathered in shard order
    (``gather_shard_parts``)."""
    return gather_shard_parts(mesh, {s: fn(s) for s in local_shards(mesh)})


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
