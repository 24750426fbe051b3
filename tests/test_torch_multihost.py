"""Multi-process runs of the port (``parallel/multihost.py``,
``parallel/multihost_dryrun.py``), on the CPU.

Mirrors ``tests/test_multihost.py`` and ``tests/test_parallel.py``'s
``initialize_distributed`` case on torch's launcher variables
(``MASTER_ADDR``/``MASTER_PORT``, ``WORLD_SIZE``, ``RANK`` where the JAX
package reads ``JAX_COORDINATOR_ADDRESS``, ``JAX_NUM_PROCESSES``,
``JAX_PROCESS_ID``): the single-process no-op, the refusals of a
half-configured job with the JAX package's texts, and the two-process
dry run over gloo, in which both children run ``sharded_knn`` on one
mesh spanning their four shards and equal the single-device kernel.
"""

import inspect
import os
import socket
import subprocess
import sys
from pathlib import Path

import pytest

from spatialflink_tpu.parallel import multihost as jmultihost
from spatialflink_tpu.parallel import multihost_dryrun as jdryrun

from spatialflink_tpu_torch.parallel import multihost_dryrun as tdryrun
from spatialflink_tpu_torch.parallel.multihost import initialize_distributed
from spatialflink_tpu_torch.parallel.multihost_dryrun import (
    OK_TAG,
    run_dryrun,
)

_VARS = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK")
REPO = Path(__file__).resolve().parents[1]

#: One rank of the spanning-mesh case: it joins from torch's launcher
#: variables alone, then holds the routed programs on the mesh spanning
#: both ranks against the same programs on a mesh in this process, and
#: builds ``mesh_from_config``'s mesh over the group.
_RANK_CHILD = """
import numpy as np, torch
from spatialflink_tpu_torch.grid import UniformGrid
from spatialflink_tpu_torch.parallel import mesh as tmesh, sharded as tsh
from spatialflink_tpu_torch.parallel.halo import sharded_range_halo
from spatialflink_tpu_torch.parallel.multihost import (
    global_data_mesh, initialize_distributed)
from spatialflink_tpu_torch.parallel.partition import plan_partition

assert initialize_distributed()
span = global_data_mesh(["cpu"] * 2)
one = tmesh.data_mesh(4, devices=["cpu"] * 4)
assert span.size == 4 and span.ranks.tolist() == [0, 0, 1, 1]
rng = np.random.default_rng(3)
xy = torch.from_numpy(rng.uniform(0, 1, (512, 2)))
ok = torch.ones(512, dtype=torch.bool)
flags = torch.from_numpy(rng.integers(0, 3, 512).astype(np.uint8))
q = torch.from_numpy(rng.uniform(0, 1, (8, 2)))
for a, b in zip(tsh.sharded_range_query(span, xy, ok, flags, q, 0.1),
                tsh.sharded_range_query(one, xy, ok, flags, q, 0.1)):
    assert torch.equal(a, b)
oid = torch.from_numpy(np.sort(rng.integers(0, 16, 512)).astype(np.int32))
ts = torch.arange(512, dtype=torch.int64)
for a, b in zip(tsh.sharded_traj_stats(span, xy, ts, oid, ok, 16),
                tsh.sharded_traj_stats(one, xy, ts, oid, ok, 16)):
    assert torch.equal(a, b)
grid = UniformGrid(64, 0.0, 1.0, 0.0, 1.0)
plan = plan_partition(grid, 4, 0.012)
cell = grid.assign_cells_np(xy.numpy())
args = (xy.numpy(), ok.numpy(), cell, q.numpy(),
        grid.assign_cells_np(q.numpy()), np.ones(8, bool), 0.05)
for a, b in zip(sharded_range_halo(span, plan, *args),
                sharded_range_halo(one, plan, *args)):
    assert np.array_equal(a, b)
tables = torch.from_numpy(np.stack(
    [grid.neighbor_flags(0.1, [grid.flat_cell(*p)]) for p in q.numpy()]))
for a, b in zip(
        tsh.sharded_knn_multi(span, xy, ok, torch.from_numpy(cell), tables,
                              oid, q, 0.1, k=2, num_segments=16),
        tsh.sharded_knn_multi(one, xy, ok, torch.from_numpy(cell), tables,
                              oid, q, 0.1, k=2, num_segments=16)):
    assert torch.equal(a, b)
# Inside the group, mesh_from_config lays the mesh over both ranks.
cfg = tsh.mesh_from_config([4], device="cpu")
assert cfg.ranks.tolist() == [0, 0, 1, 1] and cfg.axis_names == ("data",)
print("SPAN_OK", torch.distributed.get_rank(), flush=True)
torch.distributed.destroy_process_group()
"""


@pytest.fixture
def no_launcher_env(monkeypatch):
    for name in _VARS:
        monkeypatch.delenv(name, raising=False)
    return monkeypatch


def test_two_process_mesh_program_end_to_end():
    out = run_dryrun(num_processes=2, local_devices=2, timeout=120.0,
                     device="cpu")
    assert out.count(OK_TAG) == 2
    assert "procs=2" in out and "devices=4" in out
    assert "pid=0" in out and "pid=1" in out


def test_routed_programs_on_a_process_spanning_mesh():
    """Two ranks joined from ``MASTER_ADDR``/``MASTER_PORT``,
    ``WORLD_SIZE`` and ``RANK``: the range, trajectory, halo and
    multi-query kNN programs on the mesh spanning them equal the same
    programs on a mesh in one process, and ``mesh_from_config`` inside
    the group spans both ranks."""
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    procs = [subprocess.Popen(
        [sys.executable, "-c", _RANK_CHILD], cwd=REPO,
        env={**os.environ, "MASTER_ADDR": "127.0.0.1",
             "MASTER_PORT": str(port), "WORLD_SIZE": "2",
             "RANK": str(rank)},
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for rank in range(2)]
    try:
        outs = [p.communicate(timeout=120)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert [p.returncode for p in procs] == [0, 0], "\n".join(outs)
    assert "SPAN_OK 0" in outs[0] and "SPAN_OK 1" in outs[1]


def test_initialize_distributed_single_process_noop(no_launcher_env):
    assert initialize_distributed(None, 1, None) is False
    assert initialize_distributed() is False


def test_initialize_distributed_rejects_partial_config(no_launcher_env):
    with pytest.raises(ValueError, match="partial multi-host config"):
        initialize_distributed("127.0.0.1:1234", 1, 0)
    with pytest.raises(ValueError, match="partial multi-host config"):
        initialize_distributed(None, 4, 0)
    with pytest.raises(ValueError, match="process id"):
        initialize_distributed("127.0.0.1:1234", 2, None)


def test_initialize_distributed_noop_single_process(no_launcher_env):
    """``tests/test_parallel.py``'s case on torch's variables."""
    assert initialize_distributed() is False
    # Half-configured jobs fail loudly, not silently in one process.
    no_launcher_env.setenv("MASTER_ADDR", "h")
    no_launcher_env.setenv("MASTER_PORT", "1234")
    no_launcher_env.setenv("WORLD_SIZE", "1")
    with pytest.raises(ValueError, match="partial multi-host") as e:
        initialize_distributed()
    assert "'h:1234'" in str(e.value)
    no_launcher_env.delenv("MASTER_ADDR")
    no_launcher_env.delenv("MASTER_PORT")
    no_launcher_env.setenv("WORLD_SIZE", "4")
    with pytest.raises(ValueError, match="partial multi-host"):
        initialize_distributed()
    no_launcher_env.setenv("MASTER_ADDR", "h")
    no_launcher_env.setenv("MASTER_PORT", "1234")
    with pytest.raises(ValueError, match="RANK"):
        initialize_distributed()


def test_refusal_texts_are_the_jax_packages(no_launcher_env, monkeypatch):
    for name in ("JAX_COORDINATOR_ADDRESS", "JAX_NUM_PROCESSES",
                 "JAX_PROCESS_ID"):
        monkeypatch.delenv(name, raising=False)
    for args in (("127.0.0.1:1234", 1, 0), (None, 4, 0)):
        with pytest.raises(ValueError) as t:
            initialize_distributed(*args)
        with pytest.raises(ValueError) as j:
            jmultihost.initialize_distributed(*args)
        assert str(t.value) == str(j.value)


def test_signatures_keep_the_jax_order():
    def params(fn):
        return [(p.name, p.default)
                for p in inspect.signature(fn).parameters.values()]

    assert params(initialize_distributed) == \
        params(jmultihost.initialize_distributed)
    for name in ("child_main", "run_dryrun"):
        j, t = params(getattr(jdryrun, name)), params(getattr(tdryrun, name))
        assert t[:len(j)] == j and [p[0] for p in t[len(j):]] == ["device"]
    assert tdryrun.OK_TAG == jdryrun.OK_TAG
