"""Multi-process initialisation: the scale-out seam over
``torch.distributed``.

The reference scales out through Flink's network stack and Kafka
(StreamingJob.java:188-191; conf parallelism 15 at
geoflink-conf.yml:55). The JAX package joins a multi-host job through
``jax.distributed.initialize``, after which one ``Mesh`` spans every
host's chips. Here a process joins a ``torch.distributed`` group
(``initialize_distributed``), then ``global_mesh`` lays one mesh, 1-D
or (data, query), over every process's devices, each device carrying
its owning rank (``global_data_mesh`` is its 1-D case, and
``sharded.py:mesh_from_config`` builds it inside a group): every
sharded program in ``parallel/sharded.py`` and ``parallel/halo.py``
runs its own tiles and all-gathers the per-tile parts over the group
(``mesh.gather_parts``), so the operator layer does not change.

The group uses the gloo backend, which moves tensors through host
memory: NCCL refuses two ranks on one card, and a machine may hold
one. The arguments default from torch's launcher variables
(``MASTER_ADDR``/``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``), where the
JAX package reads ``JAX_COORDINATOR_ADDRESS``, ``JAX_NUM_PROCESSES``
and ``JAX_PROCESS_ID``.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from spatialflink_tpu_torch.device import resolve_device
from spatialflink_tpu_torch.parallel.mesh import Mesh


def _env_address():
    addr = os.environ.get("MASTER_ADDR")
    port = os.environ.get("MASTER_PORT")
    if addr and port:
        return f"{addr}:{port}"
    return addr or None


def initialize_distributed(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
) -> bool:
    """Join a multi-process job; a no-op for single-process runs.

    The arguments default from torch's launcher variables
    (``MASTER_ADDR`` and ``MASTER_PORT`` for the coordinator's
    ``host:port``, ``WORLD_SIZE``, ``RANK``). Returns True when a
    multi-process group was joined; then build the mesh with
    ``global_mesh`` or ``sharded.mesh_from_config``."""
    addr = coordinator_address or _env_address()
    nproc = num_processes if num_processes is not None else int(
        os.environ.get("WORLD_SIZE", "1"))
    if not addr and nproc <= 1:
        return False
    if not addr or nproc <= 1:
        # A half-configured job must not silently run in one process.
        raise ValueError(
            "partial multi-host config: need BOTH a coordinator address "
            f"and num_processes > 1 (got address={addr!r}, "
            f"num_processes={nproc})"
        )
    pid_env = os.environ.get("RANK")
    if process_id is None and pid_env is None:
        raise ValueError(
            "multi-host config without a process id: set RANK (unique "
            "per process) or pass process_id — defaulting every process "
            "to 0 would deadlock the coordinator barrier"
        )
    pid = process_id if process_id is not None else int(pid_env)
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=f"tcp://{addr}",
                            world_size=int(nproc), rank=int(pid))
    return True


def global_mesh(local_devices, shape=None, axis_names=("data",)) -> Mesh:
    """One mesh over every process's devices, each device carrying its
    owning rank: this process's ``local_devices`` resolved, the other
    processes' learned with one ``all_gather_object``, listed in rank
    order and reshaped to ``shape`` over the first prod(shape) of them,
    as the JAX package's ``make_mesh`` reshapes the process-ordered
    ``jax.devices()`` (by default one ``data`` axis over all of them).
    Raises "need N devices, have M" counted over the group, and when a
    process would own no device of the mesh. Call it on every process of
    the group."""
    import torch.distributed as dist

    mine = [str(resolve_device(d)) for d in local_devices]
    everyone = [None] * dist.get_world_size()
    dist.all_gather_object(everyone, mine)
    devices, ranks = [], []
    for rank, names in enumerate(everyone):
        devices += [torch.device(name) for name in names]
        ranks += [rank] * len(names)
    shape = (len(devices),) if shape is None else tuple(
        int(s) for s in shape)
    n = int(np.prod(shape))
    if len(devices) < n:
        raise ValueError(f"need {n} devices, have {len(devices)}")
    idle = sorted(set(range(len(everyone))) - set(ranks[:n]))
    if idle:
        raise ValueError(f"ranks {idle} would own no device of a mesh of "
                         f"{n} over {len(devices)} devices")
    arr = np.empty(n, dtype=object)
    arr[:] = devices[:n]
    return Mesh(arr.reshape(shape), axis_names, ranks=ranks[:n])


def global_data_mesh(local_devices) -> Mesh:
    """One 1-D ``data`` mesh over every process's devices, in rank order
    (``global_mesh``'s default shape). Call it on every process of the
    group."""
    return global_mesh(local_devices)
