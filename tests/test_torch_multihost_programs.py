"""Every sharded program of the port on a mesh that spans two processes
(``parallel/multihost.py:global_mesh``), on the CPU.

Two gloo ranks, joined from ``MASTER_ADDR``/``MASTER_PORT``,
``WORLD_SIZE`` and ``RANK`` and owning two CPU devices each, run
``run_programs`` once (this file run as a script) on meshes that span
them: the 2-D range and the multi-query kNN on a (2, 2) mesh, a data row
a rank, and on a (1, 4) mesh whose one row straddles both ranks; the
multi-query kNN, the registry bucket and the pane-carry tJoin scan on a
1-D mesh of 4; ``sharded_knn`` on the straddling (1, 4) mesh (each
process's home device is the first it owns anywhere); and
``PointPointKNNQuery.run_multi(mesh=)`` and ``TJoinQuery``'s pane carry
with ``mesh=`` at toy size. Each rank writes its outputs to an ``.npz``.

Contracts held:
- both ranks' outputs are equal, and each is bit-equal to the same
  programs on one-process meshes of ``["cpu"] * 4``, which
  ``tests/test_torch_parallel.py`` holds to the JAX package;
- where that file compares with the JAX ``shard_map`` program, so does
  this one, on the (2, 2), (1, 4) and 4-device JAX meshes: keep masks,
  ids, indices and counts equal, float32 distances within 1 ulp;
- the tJoin inputs hold a slide in which one rank's slices are all empty
  on each side, and one empty on both sides: the ranks gather in the same
  slides and do not deadlock;
- ``mesh_from_config`` inside the group spans both ranks; without one it
  is unchanged;
- each spanning program made gloo collectives, the same number on both
  ranks;
- the float64 mode (``precision.x64(True)``, ``run_programs64``): the
  four programs on float64 coordinates, radii and carries (the tJoin
  scan at a radius float32 cannot hold), ``run_multi``, the tJoin pane
  carry operator and every other ``mesh=`` entry point with
  ``run_partitioned`` (``site_runs``) on both ranks bit-equal to their
  one-process float64 runs; the four programs against the JAX programs
  at x64 within 1 float64 ulp; the multi-query kNN's merge moves 8-byte
  minima through the group.

The children import only torch, numpy and the port; the JAX package is
imported by the tests that compare with it.
"""

import ast
import os
import re
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
LAYOUTS = {"2x2": (2, 2), "1x4": (1, 4), "4": (4,)}
NAMES = ("data", "query")
R_RANGE, R_MULTI, K_MULTI, NSEG = 1.5, 2.5, 5, 128
#: The float64 tJoin scan's radius: one float32 cannot hold.
R_TJOIN64 = 0.8
PANE_KW = dict(grid_n=10, cap_w=32, layers=1, ppw=6, num_ids=8, pair_sel=16)
S_PANES, PC = 24, 64
#: The tJoin slides whose valid points lie in one rank's slices only (on
#: the left side the other rank's, on the right this one's), and the
#: slide empty on both sides.
ONE_RANK_EMPTY = {"left": (3, 0), "right": (5, 1)}
BOTH_EMPTY = 7


def _grid():
    from spatialflink_tpu_torch.grid import UniformGrid

    return UniformGrid(20, 0.0, 10.0, 0.0, 10.0)


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _batch(rng, n=1000, bucket=1024, dtype=np.float32):
    from spatialflink_tpu_torch.models.batch import PointBatch

    xy = rng.uniform(0, 10, size=(n, 2))
    oid = rng.integers(0, 100, n).astype(np.int32)
    b = PointBatch.from_arrays(xy, None, oid, bucket=bucket).with_cells(
        _grid())
    b.xy = b.xy.astype(dtype)
    return b


def range_inputs(dtype=np.float32):
    """(xy, valid, per-point flags, queries) of the 2-D range, numpy, the
    coordinates in ``dtype``."""
    from spatialflink_tpu_torch.ops.cells import gather_cell_flags

    grid = _grid()
    b = _batch(np.random.default_rng(31), dtype=dtype)
    q = np.random.default_rng(32).uniform(0, 10, (8, 2)).astype(dtype)
    table = grid.neighbor_flags(R_RANGE, [grid.flat_cell(*p) for p in q])
    flags = gather_cell_flags(t(b.cell), t(table)).numpy()
    return b.xy, b.valid, flags, q


def multi_inputs(nq=8, seed=33, dtype=np.float32):
    """(xy, valid, cell, flag tables, oid, queries) of the multi-query
    kNN and the registry bucket, numpy, the coordinates in ``dtype``."""
    grid = _grid()
    rng = np.random.default_rng(seed)
    b = _batch(rng, dtype=dtype)
    qxy = rng.uniform(0, 10, (nq, 2)).astype(dtype)
    tables = np.stack([grid.neighbor_flags(R_MULTI, [grid.flat_cell(*p)])
                       for p in qxy])
    return b.xy, b.valid, b.cell, tables, b.oid, qxy


def registry_extra():
    """The registry bucket's per-query float64 radii and validity."""
    radius = np.random.default_rng(34).uniform(0.5, 3.0, 16)
    qvalid = np.ones(16, bool)
    qvalid[[3, 11, 12]] = False
    return radius, qvalid


def knn_inputs():
    """(xy, valid, per-point flags, oid, query) of ``sharded_knn``."""
    from spatialflink_tpu_torch.ops.cells import gather_cell_flags

    grid = _grid()
    b = _batch(np.random.default_rng(35))
    q = np.array([5.0, 5.0], np.float32)
    table = grid.neighbor_flags(3.0, [grid.flat_cell(*q)])
    flags = gather_cell_flags(t(b.cell), t(table)).numpy()
    return b.xy, b.valid, flags, b.oid, q


def _pane_side(rng, empty_slide, empty_half, dtype=np.float32):
    """One side's (S, PC) pane fields; in ``empty_slide`` the points of
    pane half ``empty_half`` (shards 2h and 2h + 1 of four: one rank's)
    are invalid, and slide ``BOTH_EMPTY`` holds none. The coordinates are
    centred float32, or raw float64 as the float64 mode ships them."""
    from spatialflink_tpu_torch.ops.tjoin_panes import pane_cell_ranks

    gn, extent = PANE_KW["grid_n"], 10.0
    xy = rng.uniform(-0.3, extent + 0.3, (S_PANES * PC, 2))
    cl = extent / gn
    xi = np.floor(xy[:, 0] / cl).astype(np.int64)
    yi = np.floor(xy[:, 1] / cl).astype(np.int64)
    ing = (xi >= 0) & (xi < gn) & (yi >= 0) & (yi < gn)
    valid = (ing & (rng.random(S_PANES * PC) > 0.05)).reshape(S_PANES, PC)
    half = PC // 2
    valid[empty_slide, empty_half * half:(empty_half + 1) * half] = False
    valid[BOTH_EMPTY] = False
    valid = valid.reshape(-1)
    cell = np.where(ing, xi * gn + yi, 0).astype(np.int32)
    rank = pane_cell_ranks(np.repeat(np.arange(S_PANES), PC), cell,
                           valid=valid)
    c = (xy - extent / 2).astype(np.float32) if dtype == np.float32 \
        else xy.copy()
    arrs = (c[:, 0], c[:, 1], xi.astype(np.int32), yi.astype(np.int32),
            cell, rank.astype(np.int32),
            rng.integers(0, PANE_KW["num_ids"], S_PANES * PC).astype(
                np.int32), valid)
    return tuple(a.reshape(S_PANES, PC) for a in arrs)


def pane_inputs(dtype=np.float32):
    """The left and right pane fields of the tJoin scan, numpy."""
    rng = np.random.default_rng(36)
    return (_pane_side(rng, *ONE_RANK_EMPTY["left"], dtype=dtype),
            _pane_side(rng, *ONE_RANK_EMPTY["right"], dtype=dtype))


def _points(seed, n, n_obj=64):
    from spatialflink_tpu_torch.models.objects import Point

    rng = np.random.default_rng(seed)
    xy = rng.uniform(0.0, 10.0, (n, 2))
    return [Point(obj_id=f"d{i % n_obj}", timestamp=int(i * 20_000 / n),
                  x=float(xy[i, 0]), y=float(xy[i, 1])) for i in range(n)]


def tjoin_streams():
    rng = np.random.default_rng(37)

    def mk(shift):
        n = 1_500
        return {"ts": np.sort(rng.integers(0, 2_000, n)).astype(np.int64),
                "x": rng.uniform(2 + shift, 8 + shift, n),
                "y": rng.uniform(2, 8, n),
                "oid": rng.integers(0, 8, n).astype(np.int32)}

    return mk(0.0), mk(0.2)


def _squares(seed, m, size=0.2, tag="z"):
    from spatialflink_tpu_torch.models.objects import Polygon

    rng = np.random.default_rng(seed)
    out = []
    for i in range(m):
        cx, cy = rng.uniform(1, 9, 2)
        out.append(Polygon(obj_id=f"{tag}{i}", timestamp=int(i * 20_000 / m),
                           rings=[np.array([[cx - size, cy - size],
                                            [cx + size, cy - size],
                                            [cx + size, cy + size],
                                            [cx - size, cy + size],
                                            [cx - size, cy - size]])]))
    return out


def site_runs(mesh):
    """Every ``mesh=`` entry point not run above, and ``run_partitioned``,
    on tiny streams on ``mesh`` in the caller's precision: per call its
    windows as a ``repr`` (a float64's ``repr`` round-trips, so equal
    strings are equal bits)."""
    from spatialflink_tpu_torch import operators as tops
    from spatialflink_tpu_torch import qserve as tqs
    from spatialflink_tpu_torch.grid import UniformGrid
    from spatialflink_tpu_torch.models.objects import Point, Polygon

    grid = _grid()
    conf = tops.QueryConfiguration(tops.QueryType.WindowBased,
                                   window_size=10, slide_step=10)
    pts, other = _points(41, 1_000), _points(42, 600, n_obj=32)
    polys, rects = _squares(43, 40), _squares(44, 30, tag="b")
    q, qpoly = Point(x=5.0, y=5.0), _squares(45, 1, size=0.5)[0]
    ring = np.array([[3, 3], [6, 3], [6, 6], [3, 6], [3, 3]], float)

    def op(cls, **kw):
        return getattr(tops, cls)(conf, grid, device="cpu", **kw)

    def pairs(res):
        return [(w.start, w.end, sorted((str(a.obj_id), a.timestamp,
                                         str(b.obj_id), d)
                                        for a, b, d in w.pairs))
                for w in res]

    def knn(res):
        return [(w.start, w.end, [(o, d) for o, d, _ in w.neighbors])
                for w in res]

    def objs(res):
        return [(w.start, w.end, [o.obj_id for o in w.objects],
                 np.asarray(w.dists).tolist()) for w in res]

    def served():
        sqs = [tqs.QServeCommand(
            timestamp=0, action="register", uid=f"u{i}",
            query=tqs.StandingQuery(
                qid=f"q{i}", tenant="t", kind=("range", "knn")[i % 2],
                x=1.0 + i, y=2.0 + i % 5, radius=0.8, k=4))
            for i in range(8)]
        try:
            return [(w.start, w.end, sorted(w.rows)) for w in
                    tqs.QServeOperator(conf, grid, device="cpu").run(
                        iter(sqs + pts), mesh=mesh)]
        finally:
            tqs.uninstall()

    calls = {
        "range": lambda: objs(op("PointPointRangeQuery").run(
            iter(pts), [q], 0.9, mesh=mesh)),
        "range_geometry": lambda: objs(op("PolygonPolygonRangeQuery").run(
            iter(polys), [qpoly], 1.0, mesh=mesh)),
        "knn": lambda: knn(op("PointPolygonKNNQuery").run(
            iter(pts), qpoly, 2.0, 5, mesh=mesh)),
        "knn_geometry": lambda: knn(op("PolygonPointKNNQuery").run(
            iter(polys), q, 4.0, 5, mesh=mesh)),
        "join": lambda: pairs(op("PointPointJoinQuery", cap=16).run(
            iter(pts), iter(other), 0.3, mesh=mesh)),
        "join_point_geometry": lambda: pairs(op("PointPolygonJoinQuery").run(
            iter(pts), iter(rects), 0.1, mesh=mesh)),
        "join_geometry": lambda: pairs(op("PolygonPolygonJoinQuery").run(
            iter(polys), iter(rects), 0.1, mesh=mesh)),
        "trange": lambda: [(w.start, w.end, sorted(
            tr.obj_id for tr in w.trajectories)) for w in op(
                "TRangeQuery").run(iter(pts), [Polygon(rings=[ring])],
                                   mesh=mesh)],
        "tknn": lambda: knn(op("TKNNQuery").run(iter(pts), q, 2.0, 5,
                                                mesh=mesh)),
        "tjoin": lambda: pairs(op("TJoinQuery", cap=32).run(
            iter(pts), iter(other), 0.1, mesh=mesh)),
        "taggregate": lambda: [(w.start, w.end, sorted(w.cells.items()))
                               for w in op("TAggregateQuery").run(
                                   iter(pts), mesh=mesh)],
        "tstats": lambda: [(w.start, w.end, sorted(w.stats.items()))
                           for w in op("TStatsQuery").run(iter(pts),
                                                          mesh=mesh)],
        "qserve": served,
        "partitioned": lambda: objs(tops.PointPointRangeQuery(
            conf, UniformGrid(64, 0.0, 10.0, 0.0, 10.0),
            device="cpu").run_partitioned(iter(pts), [q], 0.9, mesh)),
    }
    return {name: repr(call()) for name, call in calls.items()}


def run_programs(mesh_for):
    """Every program on the meshes ``mesh_for(shape, names)`` builds:
    a dict of numpy arrays, and per spanning program the gloo
    collectives it made (``gloo_<name>``)."""
    from spatialflink_tpu_torch import operators as tops
    from spatialflink_tpu_torch.models.objects import Point
    from spatialflink_tpu_torch.operators import trajectory as ttraj
    from spatialflink_tpu_torch.ops import tjoin_panes as ttp
    from spatialflink_tpu_torch.parallel import mesh as tmesh
    from spatialflink_tpu_torch.parallel import sharded as tsh

    out = {}

    def tally(name, fn):
        tmesh.reset_gloo_traffic()
        res = fn()
        g = tmesh.gloo_traffic()
        out[f"gloo_{name}"] = np.array([g["collectives"], g["bytes"]])
        return res

    def put(name, res):
        for i, a in enumerate(res):
            out[f"{name}_{i}"] = a.cpu().numpy()

    meshes = {k: mesh_for(v, NAMES[:len(v)]) for k, v in LAYOUTS.items()}
    rng_args = [t(a) for a in range_inputs()]
    for lay in ("2x2", "1x4"):
        put(f"range_{lay}", tally(f"range_{lay}", lambda: (
            tsh.sharded_range_query_2d(meshes[lay], *rng_args, R_RANGE))))
    margs = [t(a) for a in multi_inputs()]
    for lay in LAYOUTS:
        put(f"multi_{lay}", tally(f"multi_{lay}", lambda: (
            tsh.sharded_knn_multi(meshes[lay], *margs, R_MULTI, k=K_MULTI,
                                  num_segments=NSEG))))
    rargs = [t(a) for a in (*multi_inputs(16, seed=38), *registry_extra())]
    put("registry", tally("registry", lambda: tsh.sharded_registry_bucket(
        meshes["4"], *rargs, k=8, num_segments=NSEG)))
    kargs = [t(a) for a in knn_inputs()]
    put("knn_1x4", tally("knn_1x4", lambda: tsh.sharded_knn(
        meshes["1x4"], *kargs, 3.0, 5, num_segments=NSEG)))
    lf, rf = pane_inputs()
    kw = PANE_KW
    for cap_c in (0, 8):
        def scan():
            carry = ttp.tjoin_pane_init(
                kw["grid_n"] ** 2, kw["cap_w"], kw["ppw"], kw["num_ids"],
                device=tmesh.home_device(meshes["4"]))
            return tsh.sharded_tjoin_pane_scan(
                meshes["4"], carry, torch.arange(S_PANES),
                tuple(map(t, lf)), tuple(map(t, rf)), 0.8, **kw,
                cap_c=cap_c)

        carry, wmins = tally(f"tjoin_{cap_c}", scan)
        out[f"tjoin_{cap_c}_wmins"] = wmins.numpy()
        put(f"tjoin_{cap_c}_carry", carry)
    pts = _points(6, 3_000)
    qs = [Point(x=x, y=y) for x, y in ((2.0, 2.0), (5.0, 5.0), (8.0, 7.0))]
    windows = tally("run_multi", lambda: [
        (res.start, res.end,
         [[(o, float(d)) for o, d, _ in r.neighbors] for r in res.results])
        for res in tops.PointPointKNNQuery(
            tops.QueryConfiguration(tops.QueryType.WindowBased,
                                    window_size=10, slide_step=10),
            _grid(), device="cpu").run_multi(iter(pts), qs, 1.5, 6,
                                             mesh=meshes["2x2"])])
    out["run_multi"] = np.array(repr(windows))
    left, right = tjoin_streams()
    conf = tops.QueryConfiguration(tops.QueryType.WindowBased,
                                   window_size=1, slide_step=0.1)
    windows = tally("tjoin_op", lambda: [
        (s, e, list(map(int, lo)), list(map(int, ro)),
         [float(d) for d in dd], int(c), int(ov))
        for s, e, lo, ro, dd, c, ov in ttraj.TJoinQuery(
            conf, _grid(), device="cpu").run_soa_panes(
            iter([dict(left)]), iter([dict(right)]), 0.4, num_segments=8,
            mesh=meshes["4"], backend="device")])
    out["tjoin_op"] = np.array(repr(windows))
    from spatialflink_tpu_torch import precision

    with precision.x64(True):
        run_programs64(meshes, tally, put, out)
    return out


def run_programs64(meshes, tally, put, out):
    """The four gathering programs, ``run_multi``, the tJoin pane carry
    operator and every other ``mesh=`` entry point in the float64 mode:
    float64 coordinates, radii, minima and carries (``<name>64``
    outputs)."""
    from spatialflink_tpu_torch import operators as tops
    from spatialflink_tpu_torch.models.objects import Point
    from spatialflink_tpu_torch.operators import trajectory as ttraj
    from spatialflink_tpu_torch.ops import tjoin_panes as ttp
    from spatialflink_tpu_torch.parallel import mesh as tmesh
    from spatialflink_tpu_torch.parallel import sharded as tsh

    f64 = np.float64
    rng_args = [t(a) for a in range_inputs(f64)]
    for lay in ("2x2", "1x4"):
        put(f"range64_{lay}", tally(f"range64_{lay}", lambda: (
            tsh.sharded_range_query_2d(meshes[lay], *rng_args, R_RANGE))))
    margs = [t(a) for a in multi_inputs(dtype=f64)]
    for lay in LAYOUTS:
        put(f"multi64_{lay}", tally(f"multi64_{lay}", lambda: (
            tsh.sharded_knn_multi(meshes[lay], *margs, R_MULTI, k=K_MULTI,
                                  num_segments=NSEG))))
    rargs = [t(a) for a in (*multi_inputs(16, seed=38, dtype=f64),
                            *registry_extra())]
    put("registry64", tally("registry64", lambda: tsh.sharded_registry_bucket(
        meshes["4"], *rargs, k=8, num_segments=NSEG)))
    lf, rf = pane_inputs(f64)
    kw = PANE_KW
    for cap_c in (0, 8):
        def scan():
            carry = ttp.tjoin_pane_init(
                kw["grid_n"] ** 2, kw["cap_w"], kw["ppw"], kw["num_ids"],
                f64, device=tmesh.home_device(meshes["4"]))
            return tsh.sharded_tjoin_pane_scan(
                meshes["4"], carry, torch.arange(S_PANES),
                tuple(map(t, lf)), tuple(map(t, rf)), R_TJOIN64, **kw,
                cap_c=cap_c)

        carry, wmins = tally(f"tjoin64_{cap_c}", scan)
        out[f"tjoin64_{cap_c}_wmins"] = wmins.numpy()
        put(f"tjoin64_{cap_c}_carry", carry)
    pts = _points(6, 3_000)
    qs = [Point(x=x, y=y) for x, y in ((2.0, 2.0), (5.0, 5.0), (8.0, 7.0))]
    conf = tops.QueryConfiguration(tops.QueryType.WindowBased,
                                   window_size=10, slide_step=10)
    out["run_multi64"] = np.array(repr(tally("run_multi64", lambda: [
        (res.start, res.end,
         [[(o, d) for o, d, _ in r.neighbors] for r in res.results])
        for res in tops.PointPointKNNQuery(conf, _grid(), device="cpu")
        .run_multi(iter(pts), qs, 1.5, 6, mesh=meshes["2x2"])])))
    left, right = tjoin_streams()
    pconf = tops.QueryConfiguration(tops.QueryType.WindowBased,
                                    window_size=1, slide_step=0.1)
    out["tjoin_op64"] = np.array(repr(tally("tjoin_op64", lambda: [
        (s, e, list(map(int, lo)), list(map(int, ro)), dd.tolist(), int(c),
         int(ov))
        for s, e, lo, ro, dd, c, ov in ttraj.TJoinQuery(
            pconf, _grid(), device="cpu").run_soa_panes(
            iter([dict(left)]), iter([dict(right)]), 0.4, num_segments=8,
            mesh=meshes["4"], backend="device")])))
    sites = tally("sites64", lambda: site_runs(meshes["4"]))
    for name, text in sites.items():
        out[f"site64_{name}"] = np.array(text)


def _child(path):
    """One rank: join from the launcher variables, run every program on
    meshes spanning both ranks, write the outputs to ``path``."""
    from spatialflink_tpu_torch.parallel import sharded as tsh
    from spatialflink_tpu_torch.parallel.multihost import (
        global_mesh,
        initialize_distributed,
    )

    torch.set_num_threads(1)
    assert initialize_distributed()
    import torch.distributed as dist

    out = run_programs(lambda shape, names: global_mesh(["cpu"] * 2, shape,
                                                        names))
    for shape in ([4], [2, 2], [1, 4], [8]):
        m = tsh.mesh_from_config(shape, device="cpu")
        out[f"config_{'x'.join(map(str, shape))}"] = m.ranks
    np.savez(path, **out)
    dist.destroy_process_group()


# -- the two-rank run and the one-process run ---------------------------------


@pytest.fixture(scope="module")
def spanning(tmp_path_factory):
    """Both ranks' outputs, from one two-process run."""
    tmp = tmp_path_factory.mktemp("spanning")
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    procs = [subprocess.Popen(
        [sys.executable, __file__, str(tmp / f"rank{rank}.npz")], cwd=REPO,
        env={**os.environ, "MASTER_ADDR": "127.0.0.1",
             "MASTER_PORT": str(port), "WORLD_SIZE": "2",
             "RANK": str(rank)},
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for rank in range(2)]
    try:
        outs = [p.communicate(timeout=240)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert [p.returncode for p in procs] == [0, 0], "\n".join(outs)
    return [dict(np.load(tmp / f"rank{r}.npz")) for r in range(2)]


@pytest.fixture(scope="module")
def one_process():
    from spatialflink_tpu_torch.parallel import make_mesh

    n = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        return run_programs(lambda shape, names: make_mesh(
            shape, names, devices=["cpu"] * 4))
    finally:
        torch.set_num_threads(n)


def _same(spanning, one_process, rank, prefix):
    got = spanning[rank]
    keys = [k for k in one_process if k.startswith(prefix)
            and not k.startswith("gloo_")]
    assert keys
    for k in keys:
        a, b = got[k], one_process[k]
        assert a.dtype == b.dtype and a.shape == b.shape, k
        assert a.tobytes() == b.tobytes(), k


RANKS = pytest.mark.parametrize("rank", [0, 1])


def test_both_ranks_agree_and_gather_alike(spanning):
    a, b = spanning
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].tobytes() == b[k].tobytes(), k


@RANKS
@pytest.mark.parametrize("layout", ["2x2", "1x4"])
def test_range_2d_spanning_equals_one_process(spanning, one_process, rank,
                                              layout):
    _same(spanning, one_process, rank, f"range_{layout}_")
    assert spanning[rank][f"range_{layout}_0"].any()


@RANKS
@pytest.mark.parametrize("layout", ["2x2", "1x4", "4"])
def test_knn_multi_spanning_equals_one_process(spanning, one_process, rank,
                                               layout):
    _same(spanning, one_process, rank, f"multi_{layout}_")
    assert spanning[rank][f"multi_{layout}_3"].sum() > 0


@RANKS
def test_registry_bucket_spanning_equals_one_process(spanning, one_process,
                                                     rank):
    _same(spanning, one_process, rank, "registry_")
    assert spanning[rank]["registry_4"].sum() > 0  # within


@RANKS
@pytest.mark.parametrize("cap_c", [0, 8])
def test_tjoin_pane_scan_spanning_equals_one_process(spanning, one_process,
                                                     rank, cap_c):
    """Every slide's window minima, the whole carry (the four counters
    among it) on both ranks."""
    _same(spanning, one_process, rank, f"tjoin_{cap_c}_")
    assert np.isfinite(spanning[rank][f"tjoin_{cap_c}_wmins"]).sum() > 50


def test_tjoin_inputs_hold_a_slide_with_one_rank_empty(spanning):
    """Slide 3's left pane holds points only in rank 1's slices, slide
    5's right pane only in rank 0's, slide 7 none: the ranks still
    gathered alike (equal outputs and collective counts) and finished."""
    lf, rf = pane_inputs()
    for fields, (slide, half) in ((lf, ONE_RANK_EMPTY["left"]),
                                  (rf, ONE_RANK_EMPTY["right"])):
        halves = fields[7][slide].reshape(2, PC // 2).any(axis=1)
        assert not halves[half] and halves[1 - half]
        assert not fields[7][BOTH_EMPTY].any()
    a, b = spanning
    for cap_c in (0, 8):
        assert a[f"gloo_tjoin_{cap_c}"][0] == b[f"gloo_tjoin_{cap_c}"][0] > 0
        assert np.isfinite(a[f"tjoin_{cap_c}_wmins"][[3, 5]]).any()


@RANKS
def test_sharded_knn_on_a_straddling_mesh(spanning, one_process, rank):
    """The 1-D program on the (1, 4) mesh: rank 1 owns no tile of column
    0, runs no shard and finishes on its own first device."""
    from spatialflink_tpu_torch.ops import knn as tknn

    _same(spanning, one_process, rank, "knn_1x4_")
    args = [t(a) for a in knn_inputs()]
    want = tknn.knn_kernel(*args, 3.0, 5, NSEG)
    for i, w in enumerate(want):
        assert spanning[rank][f"knn_1x4_{i}"].tobytes() == \
            w.numpy().tobytes()


@RANKS
def test_run_multi_operator_on_a_spanning_mesh(spanning, one_process, rank):
    _same(spanning, one_process, rank, "run_multi")
    windows = ast.literal_eval(str(spanning[rank]["run_multi"]))
    assert windows and all(len(r) == 6 for w in windows for r in w[2])


@RANKS
def test_tjoin_pane_carry_operator_on_a_spanning_mesh(spanning, one_process,
                                                      rank):
    _same(spanning, one_process, rank, "tjoin_op")
    windows = ast.literal_eval(str(spanning[rank]["tjoin_op"]))
    assert sum(len(w[2]) for w in windows) > 0


@RANKS
def test_mesh_from_config_inside_a_group(spanning, rank):
    got = spanning[rank]
    assert got["config_4"].tolist() == [0, 0, 1, 1]
    assert got["config_2x2"].tolist() == [[0, 0], [1, 1]]
    assert got["config_1x4"].tolist() == [[0, 0, 1, 1]]
    assert got["config_8"].tolist() == [0] * 4 + [1] * 4


def test_mesh_from_config_without_a_group_is_unchanged():
    from spatialflink_tpu_torch.parallel import sharded as tsh

    m = tsh.mesh_from_config([2, 2], device="cpu")
    assert m.ranks is None and m.axis_names == NAMES
    if not torch.cuda.is_available():
        with pytest.raises(ValueError, match="^need 4 devices, have 0$"):
            tsh.mesh_from_config([4], device="cuda")


def test_every_spanning_program_made_gloo_collectives(spanning):
    got = spanning[0]
    names = {k for k in got if k.startswith("gloo_")}
    assert names == {f"gloo_{n}" for n in (
        "range_2x2", "range_1x4", "multi_2x2", "multi_1x4", "multi_4",
        "registry", "knn_1x4", "tjoin_0", "tjoin_8", "run_multi",
        "tjoin_op", "range64_2x2", "range64_1x4", "multi64_2x2",
        "multi64_1x4", "multi64_4", "registry64", "tjoin64_0", "tjoin64_8",
        "run_multi64", "tjoin_op64", "sites64")}
    for k in names:
        calls, nbytes = got[k]
        assert calls > 0 and nbytes > 0, k


# -- the float64 mode ------------------------------------------------------------

#: The float64 outputs (``run_programs64``), by the prefix of their keys.
F64 = ["range64_2x2_", "range64_1x4_", "multi64_2x2_", "multi64_1x4_",
       "multi64_4_", "registry64_", "tjoin64_0_", "tjoin64_8_",
       "run_multi64", "tjoin_op64"]
#: The other ``mesh=`` entry points and ``run_partitioned`` (``site_runs``).
SITES = ["range", "range_geometry", "knn", "knn_geometry", "join",
         "join_point_geometry", "join_geometry", "trange", "tknn", "tjoin",
         "taggregate", "tstats", "qserve", "partitioned"]


@RANKS
@pytest.mark.parametrize("prefix", F64)
def test_float64_programs_spanning_equal_one_process(spanning, one_process,
                                                     rank, prefix):
    """Each float64 program on both ranks, bit-equal to its one-process
    float64 run; its float outputs are float64."""
    _same(spanning, one_process, rank, prefix)
    floats = [a for k, a in spanning[rank].items()
              if k.startswith(prefix) and a.dtype.kind == "f"]
    assert all(a.dtype == np.float64 for a in floats)
    if prefix.startswith(("range64", "multi64", "registry64", "tjoin64")):
        assert floats


@RANKS
@pytest.mark.parametrize("site", SITES)
def test_float64_entry_points_on_a_spanning_mesh(spanning, one_process,
                                                 rank, site):
    """Every other ``mesh=`` entry point and ``run_partitioned`` in the
    float64 mode on a mesh spanning both ranks: the one-process run's
    windows, bit for bit (``repr`` of float64 round-trips)."""
    _same(spanning, one_process, rank, f"site64_{site}")
    text = str(spanning[rank][f"site64_{site}"])
    assert len(text) > 40
    if site not in ("trange", "taggregate"):
        floats = [float(v) for v in re.findall(r"\d+\.\d{9,}", text)]
        assert any(float(np.float32(v)) != v for v in floats), site


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_float64_knn_merge_moves_8_byte_minima(spanning, layout):
    """The multi-query kNN's merge over the group (``_merge_over_group``)
    moves one table a rank, query lane and segment: an 8-byte float64
    minimum and a 4-byte representative (4 + 4 in float32), from each of
    the two ranks."""
    world, nq = 2, 8
    for name, per in ((f"multi64_{layout}", 8 + 4), (f"multi_{layout}",
                                                     4 + 4)):
        calls, nbytes = spanning[0][f"gloo_{name}"]
        assert nbytes == world * nq * NSEG * per, name
        assert calls == spanning[1][f"gloo_{name}"][0] > 0


def _ulp64(got, want):
    """Both float64; equal at the float64 max sentinel, else within 1
    float64 ulp (a jitted JAX program may contract a multiply-add)."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype == np.float64, (got.dtype, want.dtype)
    big = want == np.finfo(np.float64).max
    return (np.array_equal(got == np.finfo(np.float64).max, big)
            and bool(np.all(np.abs(got[~big] - want[~big]) <= np.spacing(
                np.abs(want[~big])))))


@pytest.mark.parametrize("program", ["range_2x2", "range_1x4", "multi_2x2",
                                     "multi_1x4", "multi_4", "registry",
                                     "tjoin_0", "tjoin_8"])
def test_float64_programs_match_jax(spanning, program):
    """The four programs in float64 on the spanning mesh against the JAX
    ``shard_map`` programs at x64 on the same layout: masks, ids, indices
    and counts equal, float64 distances within 1 ulp."""
    import jax.numpy as jnp

    from spatialflink_tpu.ops import tjoin_panes as jtp
    from spatialflink_tpu.parallel import sharded as jsh

    got = spanning[0]
    kind, _, lay = program.partition("_")
    if kind == "range":
        jk, jd = jsh.sharded_range_query_2d(
            _jmesh(lay), *map(jnp.asarray, range_inputs(np.float64)),
            R_RANGE)
        assert np.array_equal(got[f"range64_{lay}_0"], np.asarray(jk))
        assert _ulp64(got[f"range64_{lay}_1"], jd)
    elif kind in ("multi", "registry"):
        if kind == "multi":
            jr = jsh.sharded_knn_multi(
                _jmesh(lay), *map(jnp.asarray, multi_inputs(dtype=np.float64)),
                R_MULTI, k=K_MULTI, num_segments=NSEG)
            name, idx = f"multi64_{lay}", (1, 2, 3)
        else:
            args = [jnp.asarray(a) for a in (
                *multi_inputs(16, seed=38, dtype=np.float64),
                *registry_extra())]
            jr = jsh.sharded_registry_bucket(_jmesh("4"), *args, k=8,
                                             num_segments=NSEG)
            name, idx = "registry64", (1, 2, 3, 4)
        assert _ulp64(got[f"{name}_0"], jr.dist)
        for i in idx:
            assert np.array_equal(got[f"{name}_{i}"], np.asarray(jr[i]))
    else:
        lf, rf = pane_inputs(np.float64)
        kw = PANE_KW
        j0 = jtp.tjoin_pane_init(kw["grid_n"] ** 2, kw["cap_w"], kw["ppw"],
                                 kw["num_ids"], jnp.float64)
        jc, jw = jsh.sharded_tjoin_pane_scan(
            _jmesh("4"), j0, jnp.arange(S_PANES, dtype=jnp.int32),
            tuple(map(jnp.asarray, lf)), tuple(map(jnp.asarray, rf)),
            R_TJOIN64, **kw, cap_c=int(lay))
        jw = np.asarray(jw)
        tw = got[f"tjoin64_{lay}_wmins"]
        fin = np.isfinite(jw)
        assert np.array_equal(np.isfinite(tw), fin) and fin.sum() > 50
        assert _ulp64(tw[fin], jw[fin])


# -- against the JAX shard_map programs ---------------------------------------


def _ulp(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    big = want >= np.finfo(np.float32).max
    return (np.array_equal(got >= np.finfo(np.float32).max, big)
            and bool(np.all(np.abs(got[~big] - want[~big]) <= np.spacing(
                np.abs(want[~big]).astype(np.float32)))))


def _jmesh(layout):
    from spatialflink_tpu import parallel as jpar

    shape = LAYOUTS[layout]
    return jpar.make_mesh(shape, NAMES[:len(shape)])


@pytest.mark.parametrize("layout", ["2x2", "1x4"])
def test_range_2d_matches_jax(spanning, layout):
    import jax.numpy as jnp

    from spatialflink_tpu.parallel import sharded as jsh

    jk, jd = jsh.sharded_range_query_2d(
        _jmesh(layout), *map(jnp.asarray, range_inputs()), R_RANGE)
    got = spanning[0]
    assert np.array_equal(got[f"range_{layout}_0"], np.asarray(jk))
    assert _ulp(got[f"range_{layout}_1"], jd)


@pytest.mark.parametrize("layout", ["2x2", "1x4", "4"])
def test_knn_multi_matches_jax(spanning, layout):
    import jax.numpy as jnp

    from spatialflink_tpu.parallel import sharded as jsh

    jr = jsh.sharded_knn_multi(
        _jmesh(layout), *map(jnp.asarray, multi_inputs()), R_MULTI,
        k=K_MULTI, num_segments=NSEG)
    got = spanning[0]
    assert _ulp(got[f"multi_{layout}_0"], jr.dist)
    for i in (1, 2, 3):
        assert np.array_equal(got[f"multi_{layout}_{i}"], np.asarray(jr[i]))


def test_registry_bucket_matches_jax(spanning):
    import jax.numpy as jnp

    from spatialflink_tpu.parallel import sharded as jsh

    args = [jnp.asarray(a) for a in (*multi_inputs(16, seed=38),
                                     *registry_extra())]
    jr = jsh.sharded_registry_bucket(_jmesh("4"), *args, k=8,
                                     num_segments=NSEG)
    got = spanning[0]
    assert _ulp(got["registry_0"], jr.dist)
    for i in (1, 2, 3, 4):
        assert np.array_equal(got[f"registry_{i}"], np.asarray(jr[i]))


@pytest.mark.parametrize("cap_c", [0, 8])
def test_tjoin_pane_scan_matches_jax(spanning, cap_c):
    import jax
    import jax.numpy as jnp

    from spatialflink_tpu.ops import tjoin_panes as jtp
    from spatialflink_tpu.parallel import sharded as jsh

    lf, rf = pane_inputs()
    kw = PANE_KW
    with jax.enable_x64(False):
        j0 = jtp.tjoin_pane_init(kw["grid_n"] ** 2, kw["cap_w"], kw["ppw"],
                                 kw["num_ids"], jnp.float32)
        jc, jw = jsh.sharded_tjoin_pane_scan(
            _jmesh("4"), j0, jnp.arange(S_PANES, dtype=jnp.int32),
            tuple(map(jnp.asarray, lf)), tuple(map(jnp.asarray, rf)),
            np.float32(0.8), **kw, cap_c=cap_c)
        jw = np.asarray(jw)
    got = spanning[0]
    tw = got[f"tjoin_{cap_c}_wmins"]
    assert np.array_equal(np.isfinite(tw), np.isfinite(jw))
    assert _ulp(tw[np.isfinite(jw)], jw[np.isfinite(jw)])
    from spatialflink_tpu_torch.ops.tjoin_panes import TJoinPaneCarry

    counters = ("cap_overflow", "sel_overflow", "cmp_overflow")
    assert [int(got[f"tjoin_{cap_c}_carry_"
                    f"{TJoinPaneCarry._fields.index(c)}"])
            for c in counters] == [int(getattr(jc, c)) for c in counters]


if __name__ == "__main__":
    sys.path.insert(0, str(REPO))
    _child(sys.argv[1])
