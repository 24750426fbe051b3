"""The port's float64 mode on a mesh against its unsharded float64 runs and
against the JAX package's ``shard_map`` programs at x64, on the CPU.

The port's mesh lists the CPU eight times (``["cpu"] * 8``); the JAX
package's is the conftest's eight CPU devices. Each port run is inside
``precision.x64(True)`` at its default ``dtype`` (float64); each JAX
operator runs at its default ``dtype`` under the session's x64, so both
ship raw float64 lanes to every shard. ``tests/test_parallel_operators.py``,
``tests/test_partition.py`` and ``tests/test_tjoin_panes.py`` are the
oracles; the streams are toy size.

Contracts held:
- every call site of ``SpatialOperator.run_mesh`` (the point-stream
  range and kNN ``run`` for point, polygon and linestring query sets,
  the geometry-stream range and kNN ``run``, ``run_multi`` on the 1-D
  and the 2-D data × query mesh, the three join families' ``run``, the
  five trajectory operators' ``run``, tJoin's ``run_soa_panes``,
  ``QServeOperator.run`` and ``serve_window``), ``run_partitioned`` and
  ``tjoin_pane_scan(mesh=)`` equal the port's unsharded float64 run: the
  same objects, pairs and winners in the same order (joins as the
  unsharded run's pair set), distances bit for bit; tStats counts and
  temporal sums exact, its spatial sums within the float64
  ``spatial_sum_bound`` (``pane_spatial_bound`` for the pane engine);
- against the JAX mesh run: the same ids, pairs and counts; distances
  float64 and within 1 ulp (``x64._within``: the jitted JAX programs may
  contract a multiply-add), or within ``x64.GEOM_ATOL`` for polygon and
  linestring distances;
- every float array a run returns is float64, and its distances hold
  values no float32 holds;
- the mesh scan of the pane-carry tJoin at r = 0.1, a radius float32
  cannot hold, with a pair between 0.1 and ``float32(0.1)``: the pair is
  dropped as on one device and in the JAX scan;
- a float64 ``run_partitioned`` killed at ``shard.exchange`` and
  resumed from its checkpoint writes the uninterrupted run's bytes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_parallel_operators as TPO
import test_torch_x64 as TX
import test_torch_x64_trajectory as TXT
from spatialflink_tpu import operators as jops
from spatialflink_tpu import qserve as jqs
from spatialflink_tpu.grid import UniformGrid as JGrid
from spatialflink_tpu.models.objects import LineString as JLineString
from spatialflink_tpu.models.objects import Point as JPoint
from spatialflink_tpu.operators import trajectory as jtraj
from spatialflink_tpu.ops import tjoin_panes as jtp
from spatialflink_tpu.parallel import data_mesh as j_data_mesh
from spatialflink_tpu.parallel import make_mesh as j_make_mesh
from spatialflink_tpu.streams import panes as jpanes

from spatialflink_tpu_torch import operators as tops
from spatialflink_tpu_torch import qserve as tqs
from spatialflink_tpu_torch.grid import UniformGrid
from spatialflink_tpu_torch.models.objects import LineString, Point
from spatialflink_tpu_torch.operators import trajectory as ttraj
from spatialflink_tpu_torch.ops import tjoin_panes as ttp
from spatialflink_tpu_torch.ops.trajectory import spatial_sum_bound
from spatialflink_tpu_torch.parallel import data_mesh, make_mesh
from spatialflink_tpu_torch.streams import panes as tpanes

GRID, JGRID, W, JW = TPO.GRID, TPO.JGRID, TPO.W, TPO.JW
CPU8 = ["cpu"] * 8
x64 = TX.x64  # the fixture: the port's float64 mode on
_within = TX._within
GEOM_ATOL = 2 * float(np.spacing(10.0))


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
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


def _f64(values):
    """Float64, non-empty, and holding a value no float32 holds."""
    a = np.asarray(values)
    assert a.dtype == np.float64 and a.size, a.dtype
    return TXT._not_f32(a.ravel())


def _lines(m, tag="l"):
    """``m`` three-vertex linestrings (port and JAX) from ``_squares``."""
    polys, _ = TPO._squares(21, m, size=0.2, tag=tag)
    coords = [p.rings[0][:3] for p in polys]
    return ([LineString(obj_id=p.obj_id, timestamp=p.timestamp, coords=c)
             for p, c in zip(polys, coords)],
            [JLineString(obj_id=p.obj_id, timestamp=p.timestamp, coords=c)
             for p, c in zip(polys, coords)])


def _queries(kind):
    """(port query, JAX query, radius) of a point-stream query kind."""
    if kind == "point":
        return Point(x=5.0, y=5.0), JPoint(x=5.0, y=5.0), 0.7
    if kind == "polygon":
        (q,), (jq,) = TPO._squares(5, 1, size=0.4)
        return q, jq, 0.5
    if kind == "polygons_70":
        q, jq = TPO._squares(2, 70, size=0.1)
        return q, jq, 0.05
    (q,), (jq,) = _lines(1)
    return q, jq, 0.5


def _atol(kind):
    return 0.0 if kind == "point" else GEOM_ATOL


# -- range ----------------------------------------------------------------------

_RANGE = {"point": (tops.PointPointRangeQuery, jops.PointPointRangeQuery),
          "polygon": (tops.PointPolygonRangeQuery,
                      jops.PointPolygonRangeQuery),
          # 70 polygons: one device takes the pruned path (B4 gathered),
          # the mesh the dense kernel (B4 dense a shard), as in JAX.
          "polygons_70": (tops.PointPolygonRangeQuery,
                          jops.PointPolygonRangeQuery),
          "linestring": (tops.PointLineStringRangeQuery,
                         jops.PointLineStringRangeQuery)}


@pytest.mark.parametrize("kind", list(_RANGE))
def test_range_run_on_a_mesh(mesh, jmesh, kind, x64):
    pts, jpts = TPO._points(31, 3_000)
    q, jq, r = _queries(kind)
    q, jq = (q, jq) if isinstance(q, list) else ([q], [jq])
    cls, jcls = _RANGE[kind]

    def run(m):
        return [(w.start, w.end, [(o.obj_id, o.timestamp) for o in w.objects],
                 w.dists)
                for w in cls(W, GRID, device="cpu").run(iter(pts), q, r,
                                                        mesh=m)]

    single, sharded = run(None), run(mesh)
    assert [s[:3] for s in sharded] == [s[:3] for s in single]
    assert all(np.array_equal(a[3], b[3]) for a, b in zip(sharded, single))
    assert sum(len(s[2]) for s in single) > 20
    assert _f64(np.concatenate([s[3] for s in sharded]))
    jres = list(jcls(JW, JGRID).run(iter(jpts), jq, r, mesh=jmesh))
    assert [(j.start, j.end, [(o.obj_id, o.timestamp) for o in j.objects])
            for j in jres] == [s[:3] for s in sharded]
    for s, j in zip(sharded, jres):
        assert _within(s[3], j.dists, _atol(kind))


@pytest.mark.parametrize("qkind", ["point", "polygon"])
def test_geometry_stream_range_and_knn_run_on_a_mesh(mesh, jmesh, qkind,
                                                     x64):
    """The geometry-stream ``run``s (range and kNN): the objects shard;
    a polygon query set reaches B4 in both directions on each shard."""
    polys, jpolys = TPO._squares(3, 200)
    if qkind == "point":
        q, jq = Point(x=5.0, y=5.0), JPoint(x=5.0, y=5.0)
        rcls, kcls = tops.PolygonPointRangeQuery, tops.PolygonPointKNNQuery
        jrcls, jkcls = jops.PolygonPointRangeQuery, jops.PolygonPointKNNQuery
    else:
        (q,), (jq,) = TPO._squares(6, 1, size=0.5)
        rcls, kcls = (tops.PolygonPolygonRangeQuery,
                      tops.PolygonPolygonKNNQuery)
        jrcls, jkcls = (jops.PolygonPolygonRangeQuery,
                        jops.PolygonPolygonKNNQuery)

    def run_range(m):
        return [(w.start, w.end, [o.obj_id for o in w.objects], w.dists)
                for w in rcls(W, GRID, device="cpu", mesh=m).run(
                    iter(polys), [q], 1.5)]

    single, sharded = run_range(None), run_range(mesh)
    assert [s[:3] for s in sharded] == [s[:3] for s in single]
    assert all(np.array_equal(a[3], b[3]) for a, b in zip(sharded, single))
    assert _f64(np.concatenate([s[3] for s in sharded]))
    jres = list(jrcls(JW, JGRID).run(iter(jpolys), [jq], 1.5, mesh=jmesh))
    assert [[o.obj_id for o in j.objects] for j in jres] == [
        s[2] for s in sharded]
    for s, j in zip(sharded, jres):
        assert _within(s[3], j.dists, GEOM_ATOL)

    def run_knn(m):
        return [(w.start, w.end, [(o, d) for o, d, _ in w.neighbors])
                for w in kcls(W, GRID, device="cpu").run(
                    iter(polys), q, 5.0, 10, mesh=m)]

    single, sharded = run_knn(None), run_knn(mesh)
    assert sharded == single and all(len(w[2]) == 10 for w in single)
    assert _f64([d for w in sharded for _, d in w[2]])
    jres = list(jkcls(JW, JGRID).run(iter(jpolys), jq, 5.0, 10, mesh=jmesh))
    for s, j in zip(sharded, jres):
        assert [n[0] for n in s[2]] == [n[0] for n in j.neighbors]
        assert _within(np.array([n[1] for n in s[2]]),
                       np.array([n[1] for n in j.neighbors]), GEOM_ATOL)


# -- kNN ------------------------------------------------------------------------

_KNN = {"point": (tops.PointPointKNNQuery, jops.PointPointKNNQuery),
        "polygon": (tops.PointPolygonKNNQuery, jops.PointPolygonKNNQuery),
        "linestring": (tops.PointLineStringKNNQuery,
                       jops.PointLineStringKNNQuery)}


@pytest.mark.parametrize("kind", list(_KNN))
def test_knn_run_on_a_mesh(mesh, jmesh, kind, x64):
    pts, jpts = TPO._points(32, 3_000, n_obj=256)
    q, jq, _ = _queries(kind)
    cls, jcls = _KNN[kind]

    def run(m):
        return [(w.start, w.end, [(o, d, obj.obj_id, obj.timestamp)
                                  for o, d, obj in w.neighbors])
                for w in cls(W, GRID, device="cpu", mesh=m).run(
                    iter(pts), q, 2.0, 20)]

    single, sharded = run(None), run(mesh)
    assert sharded == single  # winners, order and ties, distances' bits
    assert all(len(w[2]) == 20 for w in single)
    assert _f64([n[1] for w in sharded for n in w[2]])
    jres = list(jcls(JW, JGRID, mesh=jmesh).run(iter(jpts), jq, 2.0, 20))
    for s, j in zip(sharded, jres):
        assert [(n[0], n[2].timestamp) for n in j.neighbors] == [
            (n[0], n[3]) for n in s[2]]
        assert _within(np.array([n[1] for n in s[2]]),
                       np.array([n[1] for n in j.neighbors]), _atol(kind))


@pytest.mark.parametrize("shape", [(8,), (4, 2)], ids=["1d", "2d"])
def test_run_multi_on_a_mesh(shape, x64):
    names = ("data", "query")[:len(shape)]
    m = make_mesh(shape, names, devices=CPU8)
    pts, jpts = TPO._points(33, 3_000, n_obj=256)
    qxy = [(2.0, 2.0), (5.0, 5.0), (8.0, 7.0)]

    def run(mm):
        return [(w.start, w.end,
                 [[(o, d) for o, d, _ in r.neighbors] for r in w.results])
                for w in tops.PointPointKNNQuery(W, GRID, device="cpu")
                .run_multi(iter(pts), [Point(x=x, y=y) for x, y in qxy],
                           1.5, 6, mesh=mm)]

    single, sharded = run(None), run(m)
    assert sharded == single
    assert all(len(r) == 6 for w in single for r in w[2])
    assert _f64([d for w in sharded for r in w[2] for _, d in r])
    jres = list(jops.PointPointKNNQuery(JW, JGRID).run_multi(
        iter(jpts), [JPoint(x=x, y=y) for x, y in qxy], 1.5, 6,
        mesh=j_make_mesh(shape, names)))
    for s, j in zip(sharded, jres):
        for sq, jr in zip(s[2], j.results):
            assert [o for o, _ in sq] == [n[0] for n in jr.neighbors]
            assert _within(np.array([d for _, d in sq]),
                           np.array([n[1] for n in jr.neighbors]))


# -- joins ----------------------------------------------------------------------


def _pairs(results, *fields):
    return [(w.start, w.end, sorted(
        tuple(f(a, b) for f in fields) + (d,) for a, b, d in w.pairs))
        for w in results]


def _ids(a, b):
    return (a.obj_id, a.timestamp, b.obj_id, b.timestamp)


def _same_pairs(sharded, single, jres, atol=0.0, exact=True):
    """The mesh run's windows are the unsharded run's; the JAX run's
    pairs are theirs, distances within ``atol`` or 1 ulp. ``exact``:
    the distances are exact ones (an approximate join emits 0)."""
    assert sharded == single
    assert sum(len(w[2]) for w in single) > 5
    dists = [p[-1] for w in sharded for p in w[2]]
    assert _f64(dists) if exact else not any(dists)
    assert [w[:2] for w in jres] == [w[:2] for w in sharded]
    for s, j in zip(sharded, jres):
        assert [p[:-1] for p in s[2]] == [p[:-1] for p in j[2]]
        assert _within(np.array([p[-1] for p in s[2]], np.float64),
                       np.array([p[-1] for p in j[2]], np.float64), atol)


def test_point_point_join_run_on_a_mesh(mesh, jmesh, x64):
    """The grid join through B3 on each shard, with more pairs than the
    starting budget, so the doubling retry fires on both runs."""
    grid_j = UniformGrid(64, 0.0, 10.0, 0.0, 10.0)
    left, jleft = TPO._points(34, 2_500)
    right, jright = TPO._points(35, 800, tag="q")

    def run(m):
        op = tops.PointPointJoinQuery(W, grid_j, cap=16, device="cpu",
                                      mesh=m)
        res = list(op.run(iter(left), iter(right), 0.25))
        assert all(w.overflow == 0 for w in res) and op._max_pairs > 1024
        return _pairs(res, _ids)

    jres = _pairs(jops.PointPointJoinQuery(
        JW, JGrid(64, 0.0, 10.0, 0.0, 10.0), cap=16, mesh=jmesh).run(
        iter(jleft), iter(jright), 0.25), _ids)
    _same_pairs(run(mesh), run(None), jres)


@pytest.mark.parametrize("approx", [False, True])
def test_point_geometry_join_run_on_a_mesh(mesh, jmesh, approx, x64):
    pts, jpts = TPO._points(36, 3_000)
    polys, jpolys = TPO._squares(37, 40, size=0.2)
    conf = tops.QueryConfiguration(tops.QueryType.WindowBased,
                                   window_size=10, slide_step=10,
                                   approximate_query=approx)
    jconf = jops.QueryConfiguration(jops.QueryType.WindowBased,
                                    window_size=10, slide_step=10,
                                    approximate_query=approx)

    def ids(a, b):
        return (a.obj_id, a.timestamp, b.obj_id)

    def run(m):
        return _pairs(tops.PointPolygonJoinQuery(
            conf, GRID, device="cpu", mesh=m).run(iter(pts), iter(polys),
                                                  0.1), ids)

    jres = _pairs(jops.PointPolygonJoinQuery(jconf, JGRID, mesh=jmesh).run(
        iter(jpts), iter(jpolys), 0.1), ids)
    _same_pairs(run(mesh), run(None), jres, GEOM_ATOL, exact=not approx)


@pytest.mark.parametrize("right", ["polygon", "linestring"])
def test_geometry_geometry_join_run_on_a_mesh(mesh, jmesh, right, x64):
    left, jleft = TPO._squares(38, 120, size=0.2, tag="a")
    if right == "polygon":
        rgt, jrgt = TPO._squares(39, 60, size=0.2, tag="b")
        cls, jcls = tops.PolygonPolygonJoinQuery, jops.PolygonPolygonJoinQuery
    else:
        rgt, jrgt = _lines(60, tag="b")
        cls, jcls = (tops.PolygonLineStringJoinQuery,
                     jops.PolygonLineStringJoinQuery)

    def ids(a, b):
        return (a.obj_id, b.obj_id)

    def run(m):
        return _pairs(cls(W, GRID, device="cpu", mesh=m).run(
            iter(left), iter(rgt), 0.1), ids)

    jres = _pairs(jcls(JW, JGRID, mesh=jmesh).run(iter(jleft), iter(jrgt),
                                                 0.1), ids)
    _same_pairs(run(mesh), run(None), jres, GEOM_ATOL)


# -- trajectories ---------------------------------------------------------------


def test_tstats_run_on_a_mesh(mesh, jmesh, x64):
    pts, jpts = TPO._points(40, 3_000, n_obj=64)

    def run(m):
        return [(w.start, w.end, w.stats)
                for w in ttraj.TStatsQuery(W, GRID, device="cpu",
                                           mesh=m).run(iter(pts))]

    single, sharded = run(None), run(mesh)
    jres = [(w.start, w.end, w.stats)
            for w in jtraj.TStatsQuery(JW, JGRID, mesh=jmesh).run(iter(jpts))]
    assert len(sharded) == len(single) == len(jres) == 2
    for s, g, j in zip(single, sharded, jres):
        assert s[:2] == g[:2] == j[:2]
        assert s[2].keys() == g[2].keys() == j[2].keys()
        for k in s[2]:
            sp, tp, _ = s[2][k]
            assert g[2][k][1] == tp == j[2][k][1]  # temporal: exact
            bound = spatial_sum_bound(60, sp, np.float64)
            assert abs(g[2][k][0] - sp) <= bound
            assert abs(g[2][k][0] - j[2][k][0]) <= 2 * bound
    assert TXT._not_f32([v[0] for w in sharded for v in w[2].values()])


def test_trange_tknn_taggregate_run_on_a_mesh(mesh, jmesh, x64):
    pts, jpts = TPO._points(41, 3_000, n_obj=128)
    rings = [np.array([[3, 3], [4.5, 3], [4.5, 4.5], [3, 4.5], [3, 3]],
                      float),
             np.array([[6, 6], [8, 6], [8, 8], [6, 8], [6, 6]], float)]
    polys = [TPO.Polygon(rings=[r]) for r in rings]
    jpolys = [TPO.JPolygon(rings=[r]) for r in rings]

    def trange(m):
        return [(w.start, w.end, sorted(t.obj_id for t in w.trajectories))
                for w in ttraj.TRangeQuery(W, GRID, device="cpu").run(
                    iter(pts), polys, mesh=m)]

    got = trange(mesh)
    assert got == trange(None) and sum(len(w[2]) for w in got) > 10
    assert got == [
        (w.start, w.end, sorted(t.obj_id for t in w.trajectories))
        for w in jtraj.TRangeQuery(JW, JGRID).run(iter(jpts), jpolys,
                                                  mesh=jmesh)]

    def tknn(m):
        return [(w.start, w.end, [(o, d) for o, d, _ in w.neighbors])
                for w in ttraj.TKNNQuery(W, GRID, device="cpu").run(
                    iter(pts), Point(x=5.0, y=5.0), 2.0, 7, mesh=m)]

    single = tknn(None)
    assert tknn(mesh) == single
    assert _f64([d for w in single for _, d in w[2]])
    jres = list(jtraj.TKNNQuery(JW, JGRID).run(
        iter(jpts), JPoint(x=5.0, y=5.0), 2.0, 7, mesh=jmesh))
    for s, j in zip(single, jres):
        assert [o for o, _ in s[2]] == [n[0] for n in j.neighbors]
        assert _within(np.array([d for _, d in s[2]]),
                       np.array([n[1] for n in j.neighbors]))

    def tagg(m):
        return [(w.start, w.end, sorted(w.cells.items()))
                for w in ttraj.TAggregateQuery(
                    W, GRID, aggregate="SUM", device="cpu").run(iter(pts),
                                                                mesh=m)]

    assert tagg(mesh) == tagg(None) == [
        (w.start, w.end, sorted(w.cells.items()))
        for w in jtraj.TAggregateQuery(JW, JGRID, aggregate="SUM").run(
            iter(jpts), mesh=jmesh)]


def test_tjoin_run_on_a_mesh(mesh, jmesh, x64):
    """tJoin's grid join on each shard through B3 at the operator's cap."""
    left, jleft = TPO._points(42, 1_500, n_obj=64)
    right, jright = TPO._points(43, 1_000, n_obj=48, tag="q")

    def ids(a, b):
        return (a.obj_id, b.obj_id)

    def run(m):
        return _pairs(ttraj.TJoinQuery(W, GRID, cap=32, device="cpu",
                                       mesh=m).run(iter(left), iter(right),
                                                   0.05), ids)

    jres = _pairs(jtraj.TJoinQuery(JW, JGRID, cap=32, mesh=jmesh).run(
        iter(jleft), iter(jright), 0.05), ids)
    _same_pairs(run(mesh), run(None), jres)


def _tjoin_chunks(seed, n=1_500, n_obj=16):
    rng = np.random.default_rng(seed)

    def mk(shift):
        return {"ts": np.sort(rng.integers(0, 3_000, n)).astype(np.int64),
                "x": rng.uniform(2 + shift, 8 + shift, n),
                "y": rng.uniform(2, 8, n),
                "oid": rng.integers(0, n_obj, n).astype(np.int32)}

    return mk(0.0), mk(0.2)


def test_tjoin_run_soa_panes_on_a_mesh(mesh, jmesh, x64):
    """The pane-carry tJoin's mesh scan under the operator, both probe
    forms, at a radius float32 cannot hold."""
    conf = tops.QueryConfiguration(tops.QueryType.WindowBased,
                                   window_size=1, slide_step=0.1)
    jconf = jops.QueryConfiguration(jops.QueryType.WindowBased,
                                    window_size=1, slide_step=0.1)
    left, right = _tjoin_chunks(44)

    def run(m, **kw):
        return [(s, e, list(map(int, lo)), list(map(int, ro)), dd, c, ov)
                for s, e, lo, ro, dd, c, ov in ttraj.TJoinQuery(
                    conf, GRID, device="cpu").run_soa_panes(
                    iter([dict(left)]), iter([dict(right)]), 0.3,
                    num_segments=16, mesh=m, backend="device", **kw)]

    def key(res):
        return [(*w[:4], w[4].tobytes(), w[5], w[6]) for w in res]

    single = run(None)
    assert key(run(mesh)) == key(single)
    assert key(run(mesh, cap_c=0)) == key(single)
    assert _f64(np.concatenate([w[4] for w in single]))
    jres = list(jtraj.TJoinQuery(jconf, JGRID).run_soa_panes(
        iter([dict(left)]), iter([dict(right)]), 0.3, num_segments=16,
        mesh=jmesh, backend="device"))
    assert [w[:4] for w in single] == [
        (s, e, list(map(int, lo)), list(map(int, ro)))
        for s, e, lo, ro, *_ in jres]
    for s, j in zip(single, jres):
        assert _within(s[4], np.asarray(j[4]))


def test_tstats_pane_engine_on_a_mesh(mesh, jmesh, x64):
    """The tStats pane engine on a mesh follows x64 alone: float64 lanes,
    counts and temporal sums exact, spatial sums within the float64
    ``pane_spatial_bound``."""
    ts, xy, oid, n_obj = TPO._tstats_stream(n=6_000)
    args = (ts, xy, oid, n_obj, 10_000, 100)
    single = tpanes.traj_stats_sliding(*args, backend="device", device="cpu")
    meshed = tpanes.traj_stats_sliding(*args, backend="device", device="cpu",
                                       mesh=mesh)
    jm = jpanes.traj_stats_sliding(*args, backend="device", mesh=jmesh)
    for got in (meshed, jm):
        np.testing.assert_array_equal(got.starts, single.starts)
        np.testing.assert_array_equal(got.temporal, single.temporal)
        np.testing.assert_array_equal(got.count, single.count)
    assert meshed.spatial.dtype == single.spatial.dtype == np.float64
    assert _f64(meshed.spatial[meshed.spatial != 0])
    bound = tpanes.pane_spatial_bound(*args)[None, :]
    assert np.all(np.abs(meshed.spatial - single.spatial) <= bound)
    assert np.all(np.abs(np.asarray(jm.spatial) - meshed.spatial) <= bound)


# -- serving ----------------------------------------------------------------------


def _serve_stream(qs_mod, points):
    cmds = [qs_mod.QServeCommand(
        timestamp=0, action="register", uid=f"u{i}",
        query=qs_mod.StandingQuery(
            qid=f"q{i}", tenant=f"t{i % 3}", kind=("range", "knn")[i % 2],
            x=1.0 + i % 8, y=1.0 + (i * 3) % 8,
            radius=0.3 + 0.1 * (i % 4), k=5))
        for i in range(24)]
    return iter(cmds + list(points))


def _rows(results):
    return [(r.start, r.end, sorted(r.rows)) for r in results]


@pytest.mark.parametrize("entry", ["run", "serve_window"])
def test_qserve_on_a_mesh(mesh, jmesh, entry, x64):
    """``QServeOperator.run`` and ``serve_window``: every bucket through
    the sharded registry program, float64 lanes and radii on each shard."""
    from spatialflink_tpu_torch.ops.query_registry import (
        registry_bucket_kernel,
    )

    pts, jpts = TPO._points(45, 3_000, n_obj=128)

    def port_run(m):
        op = tqs.QServeOperator(W, GRID, mesh=m, device="cpu")
        try:
            if entry == "run":
                return _rows(op.run(_serve_stream(tqs, pts)))
            return _rows(op.serve_window(win, registry_bucket_kernel, mesh=m)
                         for win in op.windows(_serve_stream(tqs, pts)))
        finally:
            tqs.uninstall()

    single, sharded = port_run(None), port_run(mesh)
    assert sharded == single and sum(len(w[2]) for w in single) > 50
    assert _f64([r[4] for w in sharded for r in w[2]])
    try:
        jres = _rows(jqs.QServeOperator(JW, JGRID, mesh=jmesh).run(
            _serve_stream(jqs, jpts)))
    finally:
        jqs.uninstall()
    for s, j in zip(sharded, jres):
        assert [r[:4] for r in s[2]] == [r[:4] for r in j[2]]
        assert _within(np.array([r[4] for r in s[2]]),
                       np.array([r[4] for r in j[2]]))


# -- run_partitioned ----------------------------------------------------------------


def _partitioned_events():
    rng = np.random.default_rng(46)
    xy = rng.uniform(0.0, 10.0, (3_000, 2))
    return [(f"o{i % 31}", 10 * i, float(x), float(y))
            for i, (x, y) in enumerate(xy)]


def test_run_partitioned_in_float64(x64):
    """The halo route on eight CPU shards against the port's ``run`` on one
    device and the JAX ``run_partitioned`` on its eight devices."""
    grid = UniformGrid(256, 0.0, 10.0, 0.0, 10.0)
    conf = tops.QueryConfiguration(tops.QueryType.WindowBased,
                                   window_size=10, slide_step=5)
    jconf = jops.QueryConfiguration(jops.QueryType.WindowBased,
                                    window_size=10, slide_step=5)
    events = _partitioned_events()
    queries = [(5.0, 5.0), (2.0, 7.5), (8.5, 1.5)]
    got = list(tops.PointPointRangeQuery(conf, grid, device="cpu")
               .run_partitioned(
                   iter([Point(obj_id=o, timestamp=t, x=x, y=y)
                         for o, t, x, y in events]),
                   [Point(x=x, y=y) for x, y in queries], 0.4,
                   data_mesh(8, devices=CPU8)))
    want = list(tops.PointPointRangeQuery(conf, grid, device="cpu").run(
        iter([Point(obj_id=o, timestamp=t, x=x, y=y)
              for o, t, x, y in events]),
        [Point(x=x, y=y) for x, y in queries], 0.4))
    jres = list(jops.PointPointRangeQuery(
        jconf, JGrid(256, 0.0, 10.0, 0.0, 10.0)).run_partitioned(
        iter([JPoint(obj_id=o, timestamp=t, x=x, y=y)
              for o, t, x, y in events]),
        [JPoint(x=x, y=y) for x, y in queries], 0.4, j_data_mesh(8)))

    def key(res):
        return [(r.start, r.end, r.window_count,
                 [(p.obj_id, p.timestamp) for p in r.objects]) for r in res]

    assert key(got) == key(want) == key(jres)
    assert sum(len(r.objects) for r in got) > 50
    for a, b, j in zip(got, want, jres):
        assert np.asarray(a.dists).dtype == np.float64
        # The per-pair kernel and the flag-table kernel take one root of
        # the same float64 sum at every kept point.
        assert np.array_equal(a.dists, b.dists)
        assert _within(np.asarray(a.dists), np.asarray(j.dists))
    assert _f64(np.concatenate([r.dists for r in got]))


def _partitioned_leg(workdir, fault_plan=None):
    """A float64 ``run_partitioned`` through the driver with a checkpoint
    and exactly-once egress under ``workdir``; ``fault_plan`` arms the
    fault points for the run."""
    from spatialflink_tpu_torch.driver import (
        RetryPolicy,
        WindowedDataflowDriver,
        render_range_result,
    )
    from spatialflink_tpu_torch.faults import faults
    from spatialflink_tpu_torch.streams.sinks import TransactionalFileSink

    grid = UniformGrid(128, 0.0, 8.0, 0.0, 8.0)
    conf = tops.QueryConfiguration(tops.QueryType.WindowBased,
                                   window_size=2.0, slide_step=1.0)
    rng = np.random.default_rng(47)
    xy = rng.uniform(0.0, 8.0, (160, 2))
    sink = TransactionalFileSink(str(workdir / "egress.csv"))
    driver = WindowedDataflowDriver(
        checkpoint_path=str(workdir / "ckpt.bin"), checkpoint_every=2,
        sink=sink, retry=RetryPolicy(max_retries=0, backoff_s=0.0),
        failover=False)
    op = tops.PointPointRangeQuery(conf, grid, device="cpu")
    if fault_plan is not None:
        faults.arm(fault_plan)
    try:
        for res in op.run_partitioned(
                (Point(obj_id=f"o{i % 13}", timestamp=100 * i,
                       x=float(x), y=float(y))
                 for i, (x, y) in enumerate(xy)),
                [Point(obj_id="q0", x=4.0, y=4.0),
                 Point(obj_id="q1", x=1.0, y=6.5)], 0.9,
                data_mesh(8, devices=CPU8), driver=driver):
            assert np.asarray(res.dists).dtype == np.float64
            for line in render_range_result(res):
                sink.stage(line)
    finally:
        faults.disarm()
    return (workdir / "egress.csv").read_bytes()


def test_run_partitioned_resumes_in_float64(tmp_path, x64):
    """Killed at the fifth ``shard.exchange`` (a raised fault, no retry)
    and resumed from its checkpoint: the egress bytes of the
    uninterrupted run, float64 distances in them."""
    from spatialflink_tpu_torch.faults import InjectedFault

    clean_dir, work = tmp_path / "clean", tmp_path / "killed"
    clean_dir.mkdir()
    work.mkdir()
    clean = _partitioned_leg(clean_dir)
    with pytest.raises(InjectedFault):
        _partitioned_leg(work, [{"point": "shard.exchange", "at": 5}])
    assert 0 < len((work / "egress.csv").read_bytes()) < len(clean)
    assert _partitioned_leg(work) == clean
    assert clean and any(
        float(np.float32(v)) != v
        for v in (float(ln.split(",")[-1])
                  for ln in clean.decode().splitlines()))


# -- the pane-carry tJoin's mesh scan ---------------------------------------------

#: The radius float32 cannot hold, and pairs either side of it: ``NEAR``
#: within 0.1, ``FAR`` past 0.1 but within ``float32(0.1)``.
R_EDGE = 0.1
NEAR = 0.0999999995
FAR = 0.1000000005


def _edge_fields(seed):
    """Left and right (S, PC) float64 pane fields of random points (oids
    0–3) and, in slide 2, two planted pairs: left oid 4 and right oid 5
    ``FAR`` apart, left oid 6 and right oid 7 ``NEAR`` apart."""
    rng = np.random.default_rng(seed)
    s, pc, gn, k = 12, 64, 10, 8
    lf = [np.array(a) for a in TXT._tp_fields64(rng, s, pc, gn, 4)]
    rf = [np.array(a) for a in TXT._tp_fields64(rng, s, pc, gn, 4)]
    assert 0.5 * FAR > float(np.float32(R_EDGE)) - R_EDGE
    for side, pts in ((lf, [(4, 5.3, 5.3), (6, 3.3, 3.3)]),
                      (rf, [(5, 5.3 + FAR, 5.3), (7, 3.3 + NEAR, 3.3)])):
        for lane, (oid, x, y) in zip((0, 1), pts):
            xi, yi = int(x), int(y)
            side[0][2, lane], side[1][2, lane] = x, y
            side[2][2, lane], side[3][2, lane] = xi, yi
            side[4][2, lane] = xi * gn + yi
            side[6][2, lane], side[7][2, lane] = oid, True
        side[5][:] = jtp.pane_cell_ranks(np.repeat(np.arange(s), pc),
                                         side[4].ravel(),
                                         valid=side[7].ravel()).reshape(
                                             s, pc)
    assert np.float64(5.3 + FAR) - 5.3 > R_EDGE
    assert np.float64(5.3 + FAR) - 5.3 <= float(np.float32(R_EDGE))
    return tuple(lf), tuple(rf), dict(grid_n=gn, cap_w=32, layers=1, ppw=4,
                                      num_ids=k, pair_sel=64)


@pytest.mark.parametrize("cap_c", [0, 16])
def test_tjoin_pane_scan_mesh_holds_a_radius_float32_cannot(mesh, jmesh,
                                                            cap_c, x64):
    """r = 0.1 on eight shards: the window minima and the whole carry
    equal the unsharded float64 scan's bit for bit, the FAR pair is
    absent and the NEAR pair present, as in the JAX scan on one device
    and on its mesh."""
    lf, rf, kw = _edge_fields(48 + cap_c)
    s = lf[0].shape[0]
    kw["cap_c"] = cap_c
    k = kw["num_ids"]

    def port(m):
        carry = ttp.tjoin_pane_init(kw["grid_n"] ** 2, kw["cap_w"],
                                    kw["ppw"], k, np.float64, device="cpu")
        return ttp.tjoin_pane_scan(carry, range(s), TXT.TTP._tensors(lf),
                                   TXT.TTP._tensors(rf), R_EDGE, **kw,
                                   mesh=m)

    (sc, sw), (mc, mw) = port(None), port(mesh)
    assert mw.dtype == torch.float64
    assert np.array_equal(mw.numpy().view(np.int64),
                          sw.numpy().view(np.int64))
    for name, a, b in zip(ttp.TJoinPaneCarry._fields, mc, sc):
        assert a.dtype == b.dtype and torch.equal(a, b), name
    far, near = 4 * k + 5, 6 * k + 7
    assert not np.isfinite(sw[2:, far].numpy()).any() or \
        float(sw[2:, far].min()) > 1.0
    assert float(sw[2, near]) == np.float64(3.3 + NEAR) - 3.3
    j0 = jtp.tjoin_pane_init(kw["grid_n"] ** 2, kw["cap_w"], kw["ppw"], k,
                             jnp.float64)
    jargs = (jnp.arange(s, dtype=jnp.int32), tuple(map(jnp.asarray, lf)),
             tuple(map(jnp.asarray, rf)), R_EDGE)
    for jm in (None, jmesh):
        jc, jw = jtp.tjoin_pane_scan(j0, *jargs, **kw, mesh=jm)
        jw = np.asarray(jw)
        assert jw.dtype == np.float64
        fin = np.isfinite(jw)
        assert np.array_equal(np.isfinite(mw.numpy()), fin)
        assert _within(mw.numpy()[fin], jw[fin])
        TXT._assert_carry64(mc, jc)
    assert np.isfinite(sw.numpy()).sum() > 30
