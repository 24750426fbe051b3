"""Two-process ``torch.distributed`` dry run: proof the scale-out seam
runs.

The reference scales out to a 15-task Flink cluster
(conf/geoflink-conf.yml:55); this package's scale-out is a
``torch.distributed`` group and a mesh spanning its processes
(``parallel/multihost.py``). This module drives that seam end to end on
one machine:

- ``run_dryrun()`` spawns ``num_processes`` child interpreters, each
  with ``local_devices`` shards of ``device`` (the CPU, or the card
  listed once a shard);
- every child joins the group through ``initialize_distributed`` (the
  production entry point, gloo over ``127.0.0.1``), builds one
  ``global_data_mesh`` over all processes' shards, and runs a real
  package program, ``parallel/sharded.py:sharded_knn``, over it: each
  process digests its own shards and the digests all-gather over the
  group;
- each child asserts the distributed result equals the single-device
  ``ops/knn.py:knn_kernel`` on its full copy (``num_valid == k``,
  segments, distance bits and indices), then prints an OK line the
  parent verifies.

Run: ``python -m spatialflink_tpu_torch.parallel.multihost_dryrun
[--device cuda|cpu]``.
"""

from __future__ import annotations

import os
import signal
import subprocess
import sys

OK_TAG = "MULTIHOST_DRYRUN_OK"


def child_main(process_id: int, port: int, num_processes: int,
               local_devices: int, device: str = "cuda") -> None:
    import numpy as np
    import torch
    import torch.distributed as dist

    from spatialflink_tpu_torch.parallel.multihost import (
        global_data_mesh,
        initialize_distributed,
    )

    joined = initialize_distributed(
        f"127.0.0.1:{port}", num_processes, process_id
    )
    assert joined, "initialize_distributed returned False for a 2-proc job"
    try:
        from spatialflink_tpu_torch.device import resolve_device
        from spatialflink_tpu_torch.grid import UniformGrid
        from spatialflink_tpu_torch.ops.cells import gather_cell_flags
        from spatialflink_tpu_torch.ops.knn import knn_kernel
        from spatialflink_tpu_torch.parallel.sharded import sharded_knn

        mesh = global_data_mesh([device] * local_devices)
        n_global = num_processes * local_devices
        assert mesh.size == n_global, mesh
        assert dist.get_rank() == process_id

        dev = resolve_device(device)
        grid = UniformGrid(20, 0.0, 10.0, 0.0, 10.0)
        rng = np.random.default_rng(5)  # identical stream on every process
        n, nseg, k, radius = 4096, 64, 8, np.float64(3.0)
        xy = rng.uniform(0, 10, (n, 2))
        oid = rng.integers(0, nseg, n).astype(np.int32)
        cell = grid.assign_cells_np(xy)
        table = grid.neighbor_flags(float(radius),
                                    [grid.flat_cell(5.0, 5.0)])
        flags = gather_cell_flags(torch.from_numpy(cell).to(dev),
                                  torch.from_numpy(table).to(dev))
        q = torch.tensor([5.0, 5.0], dtype=torch.float64, device=dev)
        xy_d = torch.from_numpy(xy).to(dev)
        ok = torch.ones(n, dtype=torch.bool, device=dev)
        oid_d = torch.from_numpy(oid).to(dev)

        res = sharded_knn(mesh, xy_d, ok, flags, oid_d, q, radius, k=k,
                          num_segments=nseg)
        ref = knn_kernel(xy_d, ok, flags, oid_d, q, radius, k=k,
                         num_segments=nseg)

        nv = int(res.num_valid)
        assert nv == int(ref.num_valid), (nv, int(ref.num_valid))
        assert nv == k, f"degenerate dryrun: top-k underfilled ({nv})"
        for got, want in ((res.segment, ref.segment), (res.dist, ref.dist),
                          (res.index, ref.index)):
            np.testing.assert_array_equal(got[:nv].cpu().numpy(),
                                          want[:nv].cpu().numpy())
        print(f"{OK_TAG} pid={process_id} devices={n_global} "
              f"procs={num_processes} k={nv} device={dev}", flush=True)
    finally:
        dist.destroy_process_group()


def run_dryrun(num_processes: int = 2, local_devices: int = 2,
               timeout: float = 240.0, port: int = 0,
               device: str = "cuda") -> str:
    """Spawn the children, wait, and return their combined stdout.

    Raises RuntimeError (with every child's output) unless every child
    printed its OK line and exited 0; on a timeout every child is killed
    and drained."""
    import socket

    if port == 0:
        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
        s.close()
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env = dict(os.environ)
    env["PYTHONPATH"] = root + os.pathsep + env.get("PYTHONPATH", "")
    procs = [
        subprocess.Popen(
            [sys.executable, "-m",
             "spatialflink_tpu_torch.parallel.multihost_dryrun",
             "--child", str(pid), str(port), str(num_processes),
             str(local_devices), "--device", str(device)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True, cwd=root,
        )
        for pid in range(num_processes)
    ]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=timeout)
            outs.append(out)
    except subprocess.TimeoutExpired:
        # Kill and drain every child: a hung child's partial output is
        # the diagnostic (which side of the rendezvous it reached), and
        # unreaped children would leak processes and pipes.
        drained = []
        for p in procs:
            p.kill()
            try:
                out, _ = p.communicate(timeout=10)
            except Exception:
                out = "<unreadable>"
            drained.append(f"[child rc={p.returncode}]\n{out}")
        raise RuntimeError(
            "multihost dryrun timed out\n" + "\n".join(drained)
        )
    finally:
        # Interrupted (SIGTERM in ``main``, Ctrl-C): no rank outlives
        # this process.
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    combined = "\n".join(outs)
    rcs = [p.returncode for p in procs]
    if any(rcs) or combined.count(OK_TAG) != num_processes:
        raise RuntimeError(
            f"multihost dryrun failed (rcs={rcs}):\n{combined}"
        )
    return combined


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    device = "cuda"
    if "--device" in argv:
        i = argv.index("--device")
        device = argv[i + 1]
        del argv[i:i + 2]
    if argv[:1] == ["--child"]:
        child_main(int(argv[1]), int(argv[2]), int(argv[3]), int(argv[4]),
                   device=device)
        return 0
    signal.signal(signal.SIGTERM, lambda signum, _f: sys.exit(128 + signum))
    out = run_dryrun(device=device)
    sys.stdout.write(out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
