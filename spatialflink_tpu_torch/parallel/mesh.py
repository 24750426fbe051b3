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

A mesh may also span processes (``parallel/multihost.py:global_mesh``),
in either shape: each device then carries the rank of the process that
owns it, every process runs only the tiles it owns (``local_tiles``;
a 1-D program runs data shard *s* on the first device of row *s*,
``local_shards``), and ``gather_parts`` all-gathers the per-tile parts
over the ``torch.distributed`` group before the finish phase, which
every process runs alike on its ``home_device``. A mesh built in one
process carries no ranks and behaves as it always has. Every gloo
collective the gathers make is counted (``gloo_traffic``).
"""

from __future__ import annotations

import pickle
from typing import Callable, Dict, List, Optional, Sequence, Tuple

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


def _tile_grid(a: np.ndarray) -> np.ndarray:
    """A mesh-shaped array as (data, rest): a 1-D mesh's tiles are
    (s, 0)."""
    return a.reshape(a.shape[0], -1)


def local_tiles(mesh: Mesh) -> List[Tuple[int, int]]:
    """The (data, query) tiles this process runs, row by row: every tile
    of a mesh in one process, else those whose device its rank owns.
    A 1-D mesh's tiles are (s, 0)."""
    nd, nq = _tile_grid(mesh.devices).shape
    tiles = [(i, j) for i in range(nd) for j in range(nq)]
    if not spans_processes(mesh):
        return tiles
    import torch.distributed as dist

    me = dist.get_rank()
    ranks = _tile_grid(mesh.ranks)
    return [(i, j) for i, j in tiles if int(ranks[i, j]) == me]


def local_shards(mesh: Mesh) -> List[int]:
    """The ``data``-axis shards this process runs: a 1-D program runs
    shard *s* on the first device of row *s*, so those rows whose first
    tile it owns (all of them on a mesh in one process)."""
    return [i for i, j in local_tiles(mesh) if j == 0]


def home_device(mesh: Mesh) -> torch.device:
    """Where the finish phase runs: the mesh's first device, or on a mesh
    spanning processes the first device this process owns anywhere in
    the mesh (a process may own no tile of column 0)."""
    if not spans_processes(mesh):
        return mesh.devices.flat[0]
    tiles = local_tiles(mesh)
    if not tiles:
        import torch.distributed as dist

        raise ValueError(f"rank {dist.get_rank()} owns no device of {mesh}")
    return _tile_grid(mesh.devices)[tiles[0]]


def _tree_map(part, fn):
    """A part (a tensor, numpy array, scalar, None or a tuple / named
    tuple of them) with ``fn`` applied to its tensors."""
    if isinstance(part, torch.Tensor):
        return fn(part)
    if isinstance(part, tuple):
        fields = [_tree_map(p, fn) for p in part]
        return type(part)(*fields) if hasattr(part, "_fields") else tuple(
            fields)
    return part


def _host_copy(t: torch.Tensor) -> torch.Tensor:
    """``t`` on the host, owning exactly its elements: a view pickles its
    whole storage, so one is copied out."""
    h = t.detach().to("cpu")
    if h.untyped_storage().nbytes() != h.numel() * h.element_size():
        h = h.clone()
    return h


#: The gloo collectives this process has made through ``all_gather_host``
#: and ``all_gather_tensor``, and the bytes they delivered to it (every
#: rank's payload, its own included, as gloo pads it).
_GLOO = {"collectives": 0, "bytes": 0}


def gloo_traffic() -> Dict[str, int]:
    """A copy of this process's gloo tally: ``collectives`` and
    ``bytes``."""
    return dict(_GLOO)


def reset_gloo_traffic() -> None:
    _GLOO.update(collectives=0, bytes=0)


def all_gather_tensor(t: torch.Tensor) -> List[torch.Tensor]:
    """``t`` from every rank of the group, in rank order, as host
    tensors: one gloo ``all_gather`` of equal shapes. ``t`` is copied to
    the host first; no CUDA tensor reaches gloo."""
    import torch.distributed as dist

    host = t.detach().to("cpu").contiguous()
    out = [torch.empty_like(host) for _ in range(dist.get_world_size())]
    dist.all_gather(out, host)
    _GLOO["collectives"] += 1
    _GLOO["bytes"] += len(out) * host.numel() * host.element_size()
    return out


def all_gather_host(obj) -> list:
    """One picklable object from every rank of the group, in rank order.
    Its tensors must lie on the host. ``dist.all_gather_object``'s
    protocol, made here so that its bytes are counted: two collectives,
    the pickled sizes, then the payloads padded to the largest."""
    raw = pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)
    size = torch.tensor([len(raw)], dtype=torch.int64)
    sizes = all_gather_tensor(size)
    top = max(int(s) for s in sizes)
    buf = torch.zeros(top, dtype=torch.uint8)
    buf[:len(raw)] = torch.frombuffer(bytearray(raw), dtype=torch.uint8)
    return [pickle.loads(b[:int(s)].numpy().tobytes())
            for b, s in zip(all_gather_tensor(buf), sizes)]


def gather_parts(mesh: Mesh, parts: Dict[object, object],
                 keys: Sequence) -> list:
    """Per-tile (or per-shard) parts, ``{key: part}`` for this process's
    tiles, as a list in the order of ``keys``. On a mesh in one process
    that is every part already, where it lies. On a mesh spanning
    processes the parts all-gather over the group (``all_gather_host``):
    each is copied to the host before the collective (gloo moves tensors
    only through host memory, and no CUDA tensor must reach it) and to
    this process's home device after it. Every rank must call it, with
    the same ``keys``, whether or not it holds a part."""
    if not spans_processes(mesh):
        return [parts[k] for k in keys]
    host = {k: _tree_map(p, _host_copy) for k, p in parts.items()}
    merged = {}
    for got in all_gather_host(host):
        merged.update(got)
    if sorted(merged) != sorted(keys):
        raise RuntimeError(f"parts {sorted(merged)} do not cover the tiles "
                           f"{sorted(keys)} of {mesh}")
    home = home_device(mesh)
    return [_tree_map(merged[k], lambda t: t.to(home)) for k in keys]


def map_shards(mesh: Mesh, fn: Callable[[int], object]) -> list:
    """``[fn(s) for s in shards]`` over the ``data`` axis, with ``fn`` run
    only on this process's shards and the parts gathered in shard order
    (``gather_parts``)."""
    return gather_parts(mesh, {s: fn(s) for s in local_shards(mesh)},
                        range(int(mesh.devices.shape[0])))


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
