"""The port's operators on a mesh (``mesh=``) against their unsharded runs
and against the JAX operators on the JAX package's eight-device CPU mesh
(``tests/test_parallel_operators.py`` is the oracle), on the CPU.

The port's mesh lists the CPU eight times; streams are at most 16,384
points (the JAX tests' 120,000 cut to keep the file fast). The JAX
operators run with ``dtype=np.float32`` (they centre in float64 and
cast, as the port always does).

Contracts held, per fired window:
- the port's mesh run equals its unsharded run: the same objects and
  bit-equal distances for range, kNN (winners, their order and ties),
  run_multi (1-D and the 2-D data × query mesh), the geometry streams,
  tRange, tKnn, tAggregate, the pane engines and qserve; joins as the
  same pair set with equal distances; tStats counts and temporal sums
  exact, spatial sums within ``spatial_sum_bound``;
- against the JAX mesh run: the same objects, ids and pairs; float32
  distances within 1 ulp (the port's contract with the JAX kernels);
- the mesh refusals: the pane engine's bad configs (as JAX), a card
  mesh on a CPU operator (no fallback), ``backend="native"`` on a mesh;
- the streaming job with ``deviceMesh: [8]`` on ``backend: cpu`` writes
  the unsharded job's output, and the DAG smoke's mesh child accounts
  collective bytes.
"""

import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from spatialflink_tpu.grid import UniformGrid as JGrid
from spatialflink_tpu.models.objects import Point as JPoint
from spatialflink_tpu.models.objects import Polygon as JPolygon
from spatialflink_tpu import operators as jops
from spatialflink_tpu.operators import trajectory as jtraj
from spatialflink_tpu.parallel import data_mesh as j_data_mesh
from spatialflink_tpu.parallel import make_mesh as j_make_mesh
from spatialflink_tpu.streams import panes as jpanes

from spatialflink_tpu_torch import operators as tops
from spatialflink_tpu_torch.grid import UniformGrid
from spatialflink_tpu_torch.models.objects import Point, Polygon
from spatialflink_tpu_torch.operators import trajectory as ttraj
from spatialflink_tpu_torch.ops.trajectory import spatial_sum_bound
from spatialflink_tpu_torch.parallel import data_mesh, make_mesh
from spatialflink_tpu_torch.parallel.mesh import Mesh
from spatialflink_tpu_torch.streams import panes as tpanes

REPO = Path(__file__).resolve().parents[1]
GRID = UniformGrid(20, 0.0, 10.0, 0.0, 10.0)
JGRID = JGrid(20, 0.0, 10.0, 0.0, 10.0)
W = tops.QueryConfiguration(tops.QueryType.WindowBased, window_size=10,
                            slide_step=10)
JW = jops.QueryConfiguration(jops.QueryType.WindowBased, window_size=10,
                             slide_step=10)
CPU8 = ["cpu"] * 8
F32 = np.float32


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Two intra-op threads while this module runs: its shards are many
    small ops, and the whole suite's workers share the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def mesh():
    return data_mesh(8, devices=CPU8)


@pytest.fixture(scope="module")
def jmesh():
    assert len(jax.devices()) >= 8, "conftest must provide 8 devices"
    return j_data_mesh(8)


def _points(seed, n, n_obj=512, t_span=20_000, lo=0.0, hi=10.0, tag="d"):
    """The same stream as port and JAX ``Point``s: 2 windows of W."""
    rng = np.random.default_rng(seed)
    xy = rng.uniform(lo, hi, (n, 2))
    ts = [int(i * t_span / n) for i in range(n)]
    port = [Point(obj_id=f"{tag}{i % n_obj}", timestamp=ts[i],
                  x=float(xy[i, 0]), y=float(xy[i, 1])) for i in range(n)]
    jx = [JPoint(obj_id=f"{tag}{i % n_obj}", timestamp=ts[i],
                 x=float(xy[i, 0]), y=float(xy[i, 1])) for i in range(n)]
    return port, jx


def _squares(seed, m, size=0.25, span=20_000, tag="z"):
    rng = np.random.default_rng(seed)
    rings = []
    for _ in range(m):
        cx, cy = rng.uniform(1, 9, 2)
        rings.append(np.array([[cx - size, cy - size], [cx + size, cy - size],
                               [cx + size, cy + size], [cx - size, cy + size],
                               [cx - size, cy - size]]))
    ts = [int(i * span / m) for i in range(m)]
    return ([Polygon(obj_id=f"{tag}{i}", timestamp=ts[i], rings=[r])
             for i, r in enumerate(rings)],
            [JPolygon(obj_id=f"{tag}{i}", timestamp=ts[i], rings=[r])
             for i, r in enumerate(rings)])


def _ulp_close(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return got.shape == want.shape and bool(np.all(
        np.abs(got - want) <= np.spacing(np.abs(want).astype(np.float32))))


# -- range ----------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["point", "polygon"])
def test_range_operator_mesh_matches_single_and_jax(mesh, jmesh, kind):
    pts, jpts = _points(1, 12_000)
    if kind == "point":
        q, jq = [Point(x=5.0, y=5.0)], [JPoint(x=5.0, y=5.0)]
        cls, jcls, r = tops.PointPointRangeQuery, jops.PointPointRangeQuery, 0.5
    else:
        # 70 polygons: the unsharded run takes the pruned path, the mesh
        # the dense kernel (as in JAX); the results agree.
        q, jq = _squares(2, 70, size=0.1)
        cls, jcls, r = (tops.PointPolygonRangeQuery,
                        jops.PointPolygonRangeQuery, 0.05)

    def run(m):
        return [(res.start, res.end,
                 [(o.obj_id, o.timestamp) for o in res.objects], res.dists)
                for res in cls(W, GRID, device="cpu").run(iter(pts), q, r,
                                                          mesh=m)]

    single, sharded = run(None), run(mesh)
    assert [s[:3] for s in sharded] == [s[:3] for s in single]
    assert all(np.array_equal(a[3], b[3]) for a, b in zip(sharded, single))
    assert sum(len(s[2]) for s in single) > 50
    jres = list(jcls(JW, JGRID).run(iter(jpts), jq, r, dtype=F32,
                                    mesh=jmesh))
    assert [(j.start, j.end, [(o.obj_id, o.timestamp) for o in j.objects])
            for j in jres] == [s[:3] for s in sharded]
    assert all(_ulp_close(s[3], j.dists) for s, j in zip(sharded, jres))


def test_geometry_stream_operators_mesh(mesh, jmesh):
    """Geometry-stream range and kNN on the mesh: the object axis shards
    (the batch bucket rises to the data axis)."""
    polys, jpolys = _squares(3, 300)
    q, jq = Point(x=5.0, y=5.0), JPoint(x=5.0, y=5.0)

    def run_range(m):
        return [(res.start, res.end, [o.obj_id for o in res.objects],
                 res.dists)
                for res in tops.PolygonPointRangeQuery(
                    W, GRID, device="cpu", mesh=m).run(iter(polys), [q], 1.5)]

    single, sharded = run_range(None), run_range(mesh)
    assert [s[:3] for s in sharded] == [s[:3] for s in single]
    assert all(np.array_equal(a[3], b[3]) for a, b in zip(sharded, single))
    jres = list(jops.PolygonPointRangeQuery(JW, JGRID).run(
        iter(jpolys), [jq], 1.5, dtype=F32, mesh=jmesh))
    assert [[o.obj_id for o in j.objects] for j in jres] == [
        s[2] for s in sharded]

    def run_knn(m):
        return [(res.start, res.end,
                 [(o, d, obj.obj_id) for o, d, obj in res.neighbors])
                for res in tops.PolygonPointKNNQuery(
                    W, GRID, device="cpu").run(iter(polys), q, 5.0, 10,
                                               mesh=m)]

    single, sharded = run_knn(None), run_knn(mesh)
    assert sharded == single and all(len(w[2]) == 10 for w in single)
    jres = list(jops.PolygonPointKNNQuery(JW, JGRID).run(
        iter(jpolys), jq, 5.0, 10, dtype=F32, mesh=jmesh))
    for s, j in zip(sharded, jres):
        assert [n[0] for n in s[2]] == [n[0] for n in j.neighbors]
        assert _ulp_close([n[1] for n in s[2]], [n[1] for n in j.neighbors])


# -- kNN ------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["point", "polygon"])
def test_knn_operator_mesh_bit_matches_single_and_jax(mesh, jmesh, kind):
    pts, jpts = _points(4, 12_000)
    if kind == "point":
        q, jq = Point(x=5.0, y=5.0), JPoint(x=5.0, y=5.0)
        cls, jcls = tops.PointPointKNNQuery, jops.PointPointKNNQuery
    else:
        (q,), (jq,) = _squares(5, 1, size=0.4)
        cls, jcls = tops.PointPolygonKNNQuery, jops.PointPolygonKNNQuery

    def run(m):
        op = cls(W, GRID, device="cpu", mesh=m)  # mesh via constructor
        return [(res.start, res.end,
                 [(oid, d, obj.obj_id, obj.timestamp)
                  for oid, d, obj in res.neighbors])
                for res in op.run(iter(pts), q, 2.0, 50)]

    single, sharded = run(None), run(mesh)
    assert sharded == single  # bit-identical, tie-breaks included
    assert all(len(w[2]) == 50 for w in single)
    jres = list(jcls(JW, JGRID, mesh=jmesh).run(iter(jpts), jq, 2.0, 50,
                                                dtype=F32))
    for s, j in zip(sharded, jres):
        assert [(n[0], n[2].timestamp) for n in j.neighbors] == [
            (n[0], n[3]) for n in s[2]]
        assert _ulp_close([n[1] for n in s[2]], [n[1] for n in j.neighbors])


@pytest.mark.parametrize("shape", [(8,), (4, 2)], ids=["1d", "2d"])
def test_run_multi_mesh_matches_single_and_jax(shape):
    names = ("data", "query")[:len(shape)]
    m = make_mesh(shape, names, devices=CPU8)
    pts, jpts = _points(6, 12_000, n_obj=256)
    qxy = [(2.0, 2.0), (5.0, 5.0), (8.0, 7.0)]

    def run(mm):
        return [(res.start, res.end,
                 [[(o, d) for o, d, _ in r.neighbors] for r in res.results])
                for res in tops.PointPointKNNQuery(W, GRID, device="cpu")
                .run_multi(iter(pts), [Point(x=x, y=y) for x, y in qxy],
                           1.5, 6, mesh=mm)]

    single, sharded = run(None), run(m)
    assert sharded == single
    jres = list(jops.PointPointKNNQuery(JW, JGRID).run_multi(
        iter(jpts), [JPoint(x=x, y=y) for x, y in qxy], 1.5, 6, dtype=F32,
        mesh=j_make_mesh(shape, names)))
    for s, j in zip(sharded, jres):
        for sq, jr in zip(s[2], j.results):
            assert [o for o, _ in sq] == [n[0] for n in jr.neighbors]
            assert _ulp_close([d for _, d in sq],
                              [n[1] for n in jr.neighbors])
    assert all(len(r) == 6 for w in single for r in w[2])


# -- joins ----------------------------------------------------------------------


def test_join_operator_mesh_matches_single_and_jax(mesh, jmesh):
    """The grid join on a finer grid (no cell past ``cap``: overflow 0,
    so the per-shard joins and the unsharded one are all exact), with
    more pairs a window than the starting budget of 1,024, so the
    doubling retry fires on both runs."""
    grid_j = UniformGrid(64, 0.0, 10.0, 0.0, 10.0)
    left, jleft = _points(7, 4_000)
    right, jright = _points(8, 1_000, tag="q")
    r = 0.25

    def pairs(results):
        out = []
        for res in results:
            assert res.overflow == 0
            out.append((res.start, res.end, sorted(
                (a.obj_id, a.timestamp, b.obj_id, b.timestamp, d)
                for a, b, d in res.pairs)))
        return out

    single = pairs(tops.PointPointJoinQuery(
        W, grid_j, cap=16, device="cpu").run(iter(left), iter(right), r))
    op = tops.PointPointJoinQuery(W, grid_j, cap=16, device="cpu",
                                  mesh=mesh)
    sharded = pairs(op.run(iter(left), iter(right), r))
    assert sharded == single
    assert min(len(w[2]) for w in single) > 1024
    assert op._max_pairs > 1024  # the retry grew the budget
    jres = pairs(jops.PointPointJoinQuery(
        JW, JGrid(64, 0.0, 10.0, 0.0, 10.0), cap=16, mesh=jmesh).run(
        iter(jleft), iter(jright), r, dtype=F32))
    for s, j in zip(sharded, jres):
        assert [p[:4] for p in s[2]] == [p[:4] for p in j[2]]
        assert _ulp_close([p[4] for p in s[2]], [p[4] for p in j[2]])


@pytest.mark.parametrize("approx", [False, True])
def test_point_geometry_join_mesh_matches_single_and_jax(mesh, jmesh,
                                                         approx):
    pts, jpts = _points(9, 6_000)
    polys, jpolys = _squares(10, 40, size=0.2)
    conf = tops.QueryConfiguration(tops.QueryType.WindowBased,
                                   window_size=10, slide_step=10,
                                   approximate_query=approx)
    jconf = jops.QueryConfiguration(jops.QueryType.WindowBased,
                                    window_size=10, slide_step=10,
                                    approximate_query=approx)

    def run(m):
        return [(res.start, res.end, sorted(
            (a.obj_id, a.timestamp, b.obj_id, d) for a, b, d in res.pairs))
            for res in tops.PointPolygonJoinQuery(
                conf, GRID, device="cpu", mesh=m).run(iter(pts),
                                                      iter(polys), 0.1)]

    single, sharded = run(None), run(mesh)
    assert sharded == single and sum(len(w[2]) for w in single) > 20
    jres = [(res.start, res.end, sorted(
        (a.obj_id, a.timestamp, b.obj_id, d) for a, b, d in res.pairs))
        for res in jops.PointPolygonJoinQuery(jconf, JGRID, mesh=jmesh).run(
            iter(jpts), iter(jpolys), 0.1, dtype=F32)]
    for s, j in zip(sharded, jres):
        assert [p[:3] for p in s[2]] == [p[:3] for p in j[2]]
        assert _ulp_close([p[3] for p in s[2]], [p[3] for p in j[2]])


def test_geometry_geometry_join_mesh_matches_single_and_jax(mesh, jmesh):
    left, jleft = _squares(11, 200, size=0.2, tag="a")
    right, jright = _squares(12, 100, size=0.2, tag="b")

    def run(m):
        return [(res.start, res.end, sorted(
            (a.obj_id, b.obj_id, d) for a, b, d in res.pairs))
            for res in tops.PolygonPolygonJoinQuery(
                W, GRID, device="cpu", mesh=m).run(iter(left), iter(right),
                                                   0.1)]

    single, sharded = run(None), run(mesh)
    assert sharded == single and sum(len(w[2]) for w in single) > 5
    jres = [(res.start, res.end, sorted(
        (a.obj_id, b.obj_id, d) for a, b, d in res.pairs))
        for res in jops.PolygonPolygonJoinQuery(JW, JGRID, mesh=jmesh).run(
            iter(jleft), iter(jright), 0.1, dtype=F32)]
    for s, j in zip(sharded, jres):
        assert [p[:2] for p in s[2]] == [p[:2] for p in j[2]]
        assert _ulp_close([p[2] for p in s[2]], [p[2] for p in j[2]])


# -- trajectories ---------------------------------------------------------------


def test_tstats_operator_mesh_matches_single_and_jax(mesh, jmesh):
    pts, jpts = _points(13, 12_000, n_obj=256)

    def run(m):
        return [(res.start, res.end, res.stats)
                for res in ttraj.TStatsQuery(W, GRID, device="cpu",
                                             mesh=m).run(iter(pts))]

    single, sharded = run(None), run(mesh)
    jres = [(res.start, res.end, res.stats)
            for res in jtraj.TStatsQuery(JW, JGRID, mesh=jmesh).run(
                iter(jpts), dtype=F32)]
    assert len(sharded) == len(single) == len(jres) == 2
    for s, g, j in zip(single, sharded, jres):
        assert s[:2] == g[:2] == j[:2]
        assert s[2].keys() == g[2].keys() == j[2].keys()
        for k in s[2]:
            sp, tp, _ = s[2][k]
            assert g[2][k][1] == tp == j[2][k][1]  # temporal: exact
            bound = spatial_sum_bound(60, sp)
            assert abs(g[2][k][0] - sp) <= bound
            assert abs(g[2][k][0] - j[2][k][0]) <= 2 * bound


def test_trange_tknn_taggregate_mesh_match_single_and_jax(mesh, jmesh):
    pts, jpts = _points(14, 12_000, n_obj=256)
    rings = [np.array([[3, 3], [4.5, 3], [4.5, 4.5], [3, 4.5], [3, 3]], float),
             np.array([[6, 6], [8, 6], [8, 8], [6, 8], [6, 6]], float)]
    polys = [Polygon(rings=[r]) for r in rings]
    jpolys = [JPolygon(rings=[r]) for r in rings]

    def trange(m):
        return [(res.start, res.end, sorted(t.obj_id for t in res.trajectories))
                for res in ttraj.TRangeQuery(W, GRID, device="cpu").run(
                    iter(pts), polys, mesh=m)]

    assert trange(mesh) == trange(None)
    assert trange(mesh) == [
        (res.start, res.end, sorted(t.obj_id for t in res.trajectories))
        for res in jtraj.TRangeQuery(JW, JGRID).run(iter(jpts), jpolys,
                                                    dtype=F32, mesh=jmesh)]

    def tknn(m):
        return [(res.start, res.end, [(o, d) for o, d, _ in res.neighbors])
                for res in ttraj.TKNNQuery(W, GRID, device="cpu").run(
                    iter(pts), Point(x=5.0, y=5.0), 2.0, 7, mesh=m)]

    single = tknn(None)
    assert tknn(mesh) == single
    jres = list(jtraj.TKNNQuery(JW, JGRID).run(
        iter(jpts), JPoint(x=5.0, y=5.0), 2.0, 7, dtype=F32, mesh=jmesh))
    for s, j in zip(single, jres):
        assert [o for o, _ in s[2]] == [n[0] for n in j.neighbors]
        assert _ulp_close([d for _, d in s[2]], [n[1] for n in j.neighbors])

    def tagg(m):
        return [(res.start, res.end, sorted(res.cells.items()))
                for res in ttraj.TAggregateQuery(
                    W, GRID, aggregate="SUM", device="cpu").run(iter(pts),
                                                                mesh=m)]

    assert tagg(mesh) == tagg(None) == [
        (res.start, res.end, sorted(res.cells.items()))
        for res in jtraj.TAggregateQuery(JW, JGRID, aggregate="SUM").run(
            iter(jpts), mesh=jmesh)]


def test_tjoin_operator_mesh_matches_single(mesh, jmesh):
    left, jleft = _points(15, 3_000, n_obj=64)
    right, jright = _points(16, 2_000, n_obj=48, tag="q")

    def run(m):
        return [(res.start, res.end, sorted(
            (a.obj_id, b.obj_id, d) for a, b, d in res.pairs))
            for res in ttraj.TJoinQuery(W, GRID, cap=32, device="cpu",
                                        mesh=m).run(iter(left), iter(right),
                                                    0.05)]

    single = run(None)
    assert run(mesh) == single and sum(len(w[2]) for w in single) > 0
    jres = [(res.start, res.end, sorted(
        (a.obj_id, b.obj_id, d) for a, b, d in res.pairs))
        for res in jtraj.TJoinQuery(JW, JGRID, cap=32, mesh=jmesh).run(
            iter(jleft), iter(jright), 0.05, dtype=F32)]
    for s, j in zip(single, jres):
        assert [p[:2] for p in s[2]] == [p[:2] for p in j[2]]
        assert _ulp_close([p[2] for p in s[2]], [p[2] for p in j[2]])


def _tstats_stream(n=16_000, n_obj=64, seed=17):
    rng = np.random.default_rng(seed)
    ts = np.sort(rng.integers(0, 30_000, n)).astype(np.int64)
    xy = rng.uniform(0, 10, (n, 2))
    oid = rng.integers(0, n_obj, n).astype(np.int64)
    return ts, xy, oid, n_obj


def test_tstats_pane_engine_mesh_matches_single_and_jax(mesh, jmesh):
    ts, xy, oid, n_obj = _tstats_stream()
    single = tpanes.traj_stats_sliding(ts, xy, oid, n_obj, 10_000, 100,
                                       backend="device", device="cpu")
    meshed = tpanes.traj_stats_sliding(ts, xy, oid, n_obj, 10_000, 100,
                                       backend="device", device="cpu",
                                       mesh=mesh)
    np.testing.assert_array_equal(single.starts, meshed.starts)
    np.testing.assert_array_equal(single.temporal, meshed.temporal)
    np.testing.assert_array_equal(single.count, meshed.count)
    assert single.spatial.any()
    bound = spatial_sum_bound(3 * len(ts), np.abs(single.spatial).max() * 4)
    assert np.all(np.abs(single.spatial - meshed.spatial) <= bound)
    with jax.enable_x64(False):
        jm = jpanes.traj_stats_sliding(ts, xy, oid, n_obj, 10_000, 100,
                                       backend="device", mesh=jmesh)
    np.testing.assert_array_equal(jm.starts, meshed.starts)
    np.testing.assert_array_equal(jm.temporal, meshed.temporal)
    np.testing.assert_array_equal(jm.count, meshed.count)
    assert np.all(np.abs(jm.spatial - meshed.spatial) <= bound)


def test_tstats_pane_mesh_rejects_bad_config(mesh, jmesh):
    ts = np.arange(100, dtype=np.int64)
    xy = np.zeros((100, 2))
    oid = np.zeros(100, np.int64)
    for fn, m, kw in ((tpanes.traj_stats_sliding, mesh, {"device": "cpu"}),
                      (jpanes.traj_stats_sliding, jmesh, {})):
        with pytest.raises(ValueError, match="divide"):
            fn(ts, xy, oid, 12, 1_000, 100, backend="device", mesh=m, **kw)
        with pytest.raises(ValueError, match="device backend"):
            fn(ts, xy, oid, 16, 1_000, 100, backend="numpy", mesh=m, **kw)


def test_tjoin_pane_engine_mesh_matches_single_and_jax(mesh, jmesh):
    conf = tops.QueryConfiguration(tops.QueryType.WindowBased,
                                   window_size=1, slide_step=0.1)
    jconf = jops.QueryConfiguration(jops.QueryType.WindowBased,
                                    window_size=1, slide_step=0.1)
    rng = np.random.default_rng(18)
    n, n_obj = 4_000, 16

    def mk(shift):
        return {"ts": np.sort(rng.integers(0, 4_000, n)).astype(np.int64),
                "x": rng.uniform(2 + shift, 8 + shift, n),
                "y": rng.uniform(2, 8, n),
                "oid": rng.integers(0, n_obj, n).astype(np.int32)}

    left, right = mk(0.0), mk(0.2)

    def run(m, **kw):
        return [(s, e, list(map(int, lo)), list(map(int, ro)),
                 [float(d) for d in dd], c, ov)
                for s, e, lo, ro, dd, c, ov in ttraj.TJoinQuery(
                    conf, GRID, device="cpu").run_soa_panes(
                    iter([dict(left)]), iter([dict(right)]), 0.4,
                    num_segments=n_obj, mesh=m, backend="device", **kw)]

    single = run(None)
    assert run(mesh) == single
    assert run(mesh, cap_c=0) == single
    assert sum(len(r[2]) for r in single) > 0
    with jax.enable_x64(False):
        jres = list(jtraj.TJoinQuery(jconf, JGRID).run_soa_panes(
            iter([dict(left)]), iter([dict(right)]), 0.4,
            num_segments=n_obj, mesh=jmesh, backend="device", dtype=F32))
    assert [r[:4] for r in single] == [
        (s, e, list(map(int, lo)), list(map(int, ro)))
        for s, e, lo, ro, *_ in jres]
    for s, j in zip(single, jres):
        assert _ulp_close(s[4], j[4])
    with pytest.raises(ValueError, match="native"):
        list(ttraj.TJoinQuery(conf, GRID, device="cpu").run_soa_panes(
            iter([dict(left)]), iter([dict(right)]), 0.4,
            num_segments=n_obj, mesh=mesh, backend="native"))


# -- serving, the entry points, no fallback ------------------------------------


def test_qserve_mesh_matches_single_and_jax(mesh, jmesh):
    from spatialflink_tpu import qserve as jqs

    from spatialflink_tpu_torch import qserve as tqs

    pts, jpts = _points(19, 12_000, n_obj=128)

    def stream(qs_mod, points, point_cls):
        cmds = [qs_mod.QServeCommand(
            timestamp=0, action="register", uid=f"u{i}",
            query=qs_mod.StandingQuery(
                qid=f"q{i}", tenant=f"t{i % 3}", kind=("range", "knn")[i % 2],
                x=1.0 + i % 8, y=1.0 + (i * 3) % 8,
                radius=0.3 + 0.1 * (i % 4), k=5))
            for i in range(24)]
        return iter(cmds + list(points))

    def rows(results):
        return [(r.start, r.end, sorted(r.rows)) for r in results]

    def port_run(m):
        out = rows(tqs.QServeOperator(W, GRID, mesh=m, device="cpu").run(
            stream(tqs, pts, Point)))
        tqs.uninstall()
        return out

    single, sharded = port_run(None), port_run(mesh)
    assert sharded == single and sum(len(w[2]) for w in single) > 50
    jres = rows(jqs.QServeOperator(JW, JGRID, mesh=jmesh).run(
        stream(jqs, jpts, JPoint), dtype=F32))
    jqs.uninstall()
    for s, j in zip(sharded, jres):
        assert [r[:4] for r in s[2]] == [r[:4] for r in j[2]]
        assert _ulp_close([r[4] for r in s[2]], [r[4] for r in j[2]])


def test_streaming_job_device_mesh_config(tmp_path):
    """yml ``deviceMesh: [8]`` on ``backend: cpu`` → the job runs on an
    8-shard CPU mesh with output identical to the unsharded job; on
    ``backend: cuda`` a mesh above the visible cards raises."""
    from spatialflink_tpu_torch.streaming_job import main

    rng = np.random.default_rng(9)
    csv = tmp_path / "in.csv"
    csv.write_text("\n".join(
        f"dev{i % 5},{i * 300},{rng.uniform(0, 10)},{rng.uniform(0, 10)}"
        for i in range(500)))

    def run(device_mesh, option, backend="cpu"):
        conf = tmp_path / f"conf{device_mesh}_{option}.yml"
        conf.write_text(f"""
inputStream1:
  topicName: t
  format: CSV
  csvTsvSchemaAttr: [0, 1, 2, 3]
  gridBBox: [0.0, 0.0, 10.0, 10.0]
  numGridCells: 20
  delimiter: ","
query:
  option: {option}
  radius: 2.0
  k: 3
  queryPoints:
    - [5.0, 5.0]
window:
  type: "TIME"
  interval: 10
  step: 10
deviceMesh: [{device_mesh}]
backend: {backend}
""")
        out = tmp_path / f"out{device_mesh}_{option}.csv"
        rc = main(["--config", str(conf), "--source", f"csv:{csv}",
                   "--output", str(out)])
        assert rc == 0
        return out.read_text()

    for option in (1, 3):
        got = run(8, option)
        assert got == run(1, option) and got
    # tStats (option 6): counts and temporal sums exact, the spatial sums
    # reassociated over the shards within spatial_sum_bound.
    got = [ln.split(",") for ln in run(8, 6).splitlines()]
    want = [ln.split(",") for ln in run(1, 6).splitlines()]
    assert [g[:3] + g[4:5] for g in got] == [w[:3] + w[4:5] for w in want]
    for g, w in zip(got, want):
        assert abs(float(g[3]) - float(w[3])) <= spatial_sum_bound(
            100, float(w[3]))
    if not torch.cuda.is_available():
        with pytest.raises(ValueError, match="need 4 devices, have 0"):
            run(4, 1, backend="cuda")


def test_card_mesh_on_a_cpu_operator_raises():
    """No fallback: a mesh of card devices given to a CPU operator is an
    error, never a CPU run (the mesh is built directly: ``make_mesh``
    would already refuse the card here)."""
    cards = Mesh(np.array([torch.device("cuda", 0)] * 2, dtype=object),
                 ("data",))
    with pytest.raises(ValueError, match="not cpu devices"):
        tops.PointPointKNNQuery(W, GRID, device="cpu", mesh=cards)
    op = tops.PointPointRangeQuery(W, GRID, device="cpu")
    with pytest.raises(ValueError, match="not cpu devices"):
        list(op.run(iter([]), [Point()], 0.1, mesh=cards))


def test_dag_mesh_child_accounts_collective_bytes(tmp_path):
    """The DAG smoke's mesh leg, in process and as the smoke's child on an
    8-shard CPU mesh: exit 0 with collective bytes in its sealed stream."""
    from spatialflink_tpu_torch import dag
    from spatialflink_tpu_torch.telemetry import telemetry

    stream = tmp_path / "mesh.jsonl"
    env = dict(os.environ, SFT_LEDGER_STREAM=str(stream))
    p = subprocess.run(
        [sys.executable, "-m", "spatialflink_tpu_torch.dag", "--mesh-child",
         "--device", "cpu"], env=env, capture_output=True, text=True,
        timeout=300, cwd=REPO)
    assert p.returncode == 0, p.stderr[-2000:]
    assert "dag-mesh-child: collective bytes" in p.stdout
    assert int(p.stdout.split("collective bytes ")[1].split()[0]) > 0
    if str(REPO) not in sys.path:
        sys.path.insert(0, str(REPO))
    from tools.sfprof import stream as stream_mod

    records, _ = stream_mod.read_records(str(stream))
    snaps = [r for r in records if r.get("t") == "checkpoint"]
    assert int(snaps[-1]["snapshot"]["collectives"]["bytes"]) > 0
    try:
        os.environ["SFT_LEDGER_STREAM"] = str(tmp_path / "inproc.jsonl")
        assert dag.run_mesh_child(device="cpu") == 0
    finally:
        del os.environ["SFT_LEDGER_STREAM"]
        telemetry.enable()
        telemetry.disable()
