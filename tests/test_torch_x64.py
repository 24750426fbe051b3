"""The port's float64 mode (``spatialflink_tpu_torch/precision.py``)
against the JAX package's x64 mode.

The test session runs JAX with x64 on (``tests/conftest.py``), as the
JAX package's own suite does, and here the JAX operators are called at
their DEFAULT ``dtype`` (float64), so they ship raw float64 coordinates
and compute in float64 (``operators/base.py:center_coords``). The port
runs inside ``precision.x64(True)`` at its default ``dtype`` (float64),
on the CPU, where B3's and B4's wrappers take their plain PyTorch
versions in float64.

Contracts held:
- a point exactly at the radius's edge: the port keeps exactly the
  points the JAX package keeps, where the centred float32 route keeps
  others;
- every entry point of the point-stream slice (the point-stream range's
  three classes through ``run`` in every window mode and ``run_soa``,
  and ``query_incremental``; point-stream kNN ``run`` for point, polygon
  and linestring queries and ``run_soa``; ``PointPointJoinQuery.run``
  and ``run_soa``) equals its JAX counterpart on random data: windows,
  matched ids and counts exact, distances float64 and within 1 float64
  ulp (``ULPS``), or within ``GEOM_ATOL`` for polygon and linestring
  distances (the jitted JAX point→segment distance may contract a
  multiply-add, which moves the closest point by up to a coordinate
  ulp);
- so does every entry point of the geometry and pane-carry slice: the
  six geometry-stream range and kNN classes (``run`` in every window
  mode, ``run_soa``, approximate and multi-ring), the eight point ⋈
  geometry and geometry ⋈ geometry joins (``run``, ``run_soa``, the
  approximate modes, the overflow retry, and their dense and pruned
  kernels on float64 lanes), the kNN ``query_panes`` (point, polygon,
  linestring queries), ``run_soa_panes`` and ``run_multi``, and
  ``PointPointJoinQuery.query_panes``;
- each geometry family at the radius: objects a few float64 ulps either
  side of it keep exactly the JAX objects, distances bit for bit;
- the sentinels: an object with no valid vertex, an empty window and a
  pane carry across an empty pane are float64 at ``finfo(float64).max``;
- a float64 ``query_panes`` or ``run_soa_panes`` killed and resumed
  through ``checkpoint.py`` equals the uninterrupted run, its carry
  float64, and a JAX float64 carry imported through ``state.py`` stays
  float64;
- B4's and B3's plain float64 versions against the JAX functions run
  eagerly (op by op, so nothing is contracted): bit for bit, including
  ``finfo(float64).max`` for a boundary with no valid edge;
- the numpy failover twins compute in float64 as the device path does;
- x64 off, or ``dtype=np.float32``: today's float32 results, bit for
  bit;
- x64 on: all 65 entry points that raised before the geometry slice run
  in float64 on a tiny stream: the 45 it ports, the 16 of the trajectory
  and serving slice and the 4 of ROADMAP item A14.2c (the mesh runs and
  ``run_partitioned``, each equal to its unsharded run; the trajectory
  slice's parity with the JAX package is
  ``tests/test_torch_x64_trajectory.py``, the mesh's
  ``tests/test_torch_x64_mesh.py``);
- the switch itself, and the telemetry ledger's ``x64`` field.
"""

from collections import Counter, defaultdict

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_geometry_range as TGR
import test_torch_join as TJ
import test_torch_join_geometry as TJG
import test_torch_join_panes as TJP
import test_torch_knn_geometry as TKG
import test_torch_knn_panes as TKP
import test_torch_knn_run as TK
import test_torch_range as TR
from spatialflink_tpu.models.objects import Point as JPoint
from spatialflink_tpu.ops import distances as jd
from spatialflink_tpu.ops.join import join_window_bucketed
from spatialflink_tpu.ops.polygon import points_in_polygon as j_pip

from spatialflink_tpu_torch import precision
from spatialflink_tpu_torch.grid import UniformGrid
from spatialflink_tpu_torch.models.objects import (
    LineString,
    Point,
    Polygon,
)
from spatialflink_tpu_torch.operators import (
    PointPointJoinQuery,
    PointPointKNNQuery,
    PointPointRangeQuery,
    QueryConfiguration,
    QueryType,
)
from spatialflink_tpu_torch.operators.base import flags_for_queries
from spatialflink_tpu_torch.ops.join_kernel import join_window
from spatialflink_tpu_torch.ops.polygon import pack_rings, points_in_polygons
from spatialflink_tpu_torch.ops.polyline_kernel import (
    polyline_min_dist,
    polyline_min_dist_plain,
)

BEIJING = TR.BEIJING
#: Float64 ulps the distances may differ by: both packages round each
#: operation once in the same order; the jitted JAX program may contract
#: the last multiply-add of d·d, which moves the root by at most 1 ulp.
ULPS = 1
#: The polygon and linestring distances' absolute allowance: two ulps of
#: a coordinate of the extent (the closest point on a segment moves by up
#: to one where the jitted JAX projection contracts a multiply-add).
GEOM_ATOL = 2 * float(np.spacing(117.6))


@pytest.fixture
def x64():
    """The port's float64 mode on, beside the session's JAX x64."""
    assert jax.config.jax_enable_x64
    with precision.x64(True):
        yield


def _within(a, b, atol=0.0):
    """Both float64, equal within ``ULPS`` ulps of the values, or within
    ``atol``."""
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype == np.float64, (a.dtype, b.dtype)
    if a.shape != b.shape:
        return False
    ulp = np.spacing(np.maximum(np.abs(a), np.abs(b)))
    return bool(np.all(np.abs(a - b) <= np.maximum(ULPS * ulp, atol)))


def _bits(a):
    return np.asarray(a, np.float64).view(np.int64)


# ---------------------------------------------------------------------------
# The switch


def test_the_switch_mirrors_jax_enable_x64():
    assert not precision.x64_enabled()
    assert not precision.effective_f64(np.float64)
    with precision.x64(True):
        assert precision.x64_enabled()
        assert precision.effective_f64(np.float64)
        assert not precision.effective_f64(np.float32)
        with precision.x64(False):
            assert not precision.x64_enabled()
        assert precision.x64_enabled()
        with pytest.raises(RuntimeError):
            with precision.x64(False):
                raise RuntimeError("restored on the way out")
        assert precision.x64_enabled()
    assert not precision.x64_enabled()
    try:
        precision.enable_x64(True)
        assert precision.x64_enabled()
    finally:
        precision.enable_x64(False)
    assert not precision.x64_enabled()


def test_center_coords_follows_the_jax_rule(x64):
    from spatialflink_tpu.grid import UniformGrid as JGrid
    from spatialflink_tpu.operators.base import center_coords as j_center

    from spatialflink_tpu_torch.operators.base import center_coords

    g, jg = UniformGrid(**BEIJING), JGrid(**BEIJING)
    xy = np.random.default_rng(0).uniform(116, 117, (50, 2))
    for dt in (np.float64, np.float32):
        got, want = center_coords(g, xy, dt), j_center(jg, xy, dt)
        assert got.dtype == want.dtype
        assert np.array_equal(got, want)
    assert center_coords(g, xy).dtype == np.float32  # the helper's default


def test_telemetry_ledger_records_x64(tmp_path):
    import json

    from spatialflink_tpu_torch.telemetry import write_ledger

    def env(name):
        path = write_ledger(str(tmp_path / name), capture_costs=False)
        with open(path) as f:
            return json.load(f)["env"]

    assert env("off.json")["x64"] is False
    with precision.x64(True):
        assert env("on.json")["x64"] is True


# ---------------------------------------------------------------------------
# The radius's edge

#: Offsets from the radius (0.02) of the six points, as in the report
#: that found the fault: centred float32 lanes round all of them one way.
EDGE_EPS = np.array([-6e-10, -3e-10, 0.0, 3e-10, 6e-10, 1e-9])
EDGE_Q = np.array([116.40, 40.19])


def _edge_chunks():
    xy = np.stack([EDGE_Q[0] + 0.02 + EDGE_EPS,
                   np.full(len(EDGE_EPS), EDGE_Q[1])], axis=1)
    return [{"ts": np.arange(len(xy), dtype=np.int64), "x": xy[:, 0],
             "y": xy[:, 1], "oid": np.arange(len(xy), dtype=np.int32)}]


def _edge_runs(family, dtype=None):
    """(port windows, JAX windows) of one family's run_soa on the six
    points; the JAX side at its default dtype."""
    kw = {} if dtype is None else {"dtype": dtype}
    if family == "range":
        op, jop, _, _ = TR._ops("point", dict(window_size=1.0,
                                              slide_step=1.0))
        got = [(w[2]["oid"], w[3]) for w in op.run_soa(
            _edge_chunks(), [Point(x=EDGE_Q[0], y=EDGE_Q[1])], 0.02, **kw)]
        want = [(w[2]["oid"], w[3]) for w in jop.run_soa(
            _edge_chunks(), [JPoint(x=EDGE_Q[0], y=EDGE_Q[1])], 0.02)]
    elif family == "knn":
        op, jop = TK._ops("point", dict(window_size=1.0, slide_step=1.0))
        got = [(w[2], w[3]) for w in op.run_soa(
            _edge_chunks(), Point(x=EDGE_Q[0], y=EDGE_Q[1]), 0.02, 6, 64,
            **kw)]
        want = [(w[2], w[3]) for w in jop.run_soa(
            _edge_chunks(), JPoint(x=EDGE_Q[0], y=EDGE_Q[1]), 0.02, 6, 64)]
    else:
        conf = dict(window_size=1.0, slide_step=1.0)
        right = [{"ts": np.zeros(1, np.int64), "x": EDGE_Q[:1],
                  "y": EDGE_Q[1:], "oid": np.zeros(1, np.int32)}]
        op = PointPointJoinQuery(QueryConfiguration(**conf),
                                 UniformGrid(**BEIJING), device="cpu")
        jop = TJ.JJoin(TJ.JConf(**conf), TJ.JGrid(**BEIJING))

        def pairs(w):
            keep = w[2] >= 0
            order = np.argsort(w[2][keep], kind="stable")
            return w[2][keep][order], w[4][keep][order]

        got = [pairs(w) for w in op.run_soa(_edge_chunks(), right, 0.02,
                                            **kw)]
        want = [pairs(w) for w in jop.run_soa(_edge_chunks(), right, 0.02)]
    return got, want


@pytest.mark.parametrize("family", ["range", "knn", "join"])
def test_points_at_the_radius_keep_exactly_the_jax_points(family, x64):
    got, want = _edge_runs(family)
    assert len(got) == len(want) == 1
    (gi, gd), (wi, wd) = got[0], want[0]
    assert sorted(gi.tolist()) == sorted(wi.tolist())
    assert 0 < len(wi) < len(EDGE_EPS)
    assert _within(gd, wd)
    # The centred float32 route the same call takes with dtype float32
    # decides the edge points otherwise: the fault the mode fixes.
    f32, _ = _edge_runs(family, dtype=np.float32)
    assert f32[0][1].dtype == np.float32
    assert sorted(f32[0][0].tolist()) != sorted(wi.tolist())


# ---------------------------------------------------------------------------
# The slice's entry points against the JAX package under x64


@pytest.mark.parametrize("kind", TR.SOA_KINDS)
def test_range_run_soa_matches_jax(kind, x64):
    rng = np.random.default_rng(21)
    op, jop, qs, jqs = TR._ops(kind, dict(window_size=1.0, slide_step=1.0))
    near = qs if kind.startswith("polygons") else TR._polys(30)
    xy64 = TR._points_near(rng, 3 * 2000, near)
    if kind.endswith("cluster"):
        xy64[::9] = qs[0].rings[0][0] + rng.uniform(-1e-3, 1e-3, (667, 2))
    if kind == "point":
        xy64[::7] = np.array([116.40, 40.19]) + rng.normal(0, 0.01, (858, 2))
    r = 0.02 if kind in ("point", "linestring") else TR.R
    got = list(op.run_soa(TR._chunks(xy64, 3, 2000), qs, r))
    want = list(jop.run_soa(TR._chunks(xy64, 3, 2000), jqs, r))
    assert len(got) == len(want) == 3
    hits = 0
    for g, w in zip(got, want):
        assert g[:2] == w[:2] and g[2].keys() == w[2].keys()
        for k in g[2]:
            assert np.array_equal(g[2][k], w[2][k])
        assert _within(g[3], w[3], GEOM_ATOL * (kind != "point"))
        hits += len(g[3])
    assert hits > 0
    assert getattr(op, "_ncand", None) == getattr(jop, "_ncand", None)
    assert getattr(op, "_cand_budget", None) == \
        getattr(jop, "_cand_budget", None)


@pytest.mark.parametrize("kind,conf_kw", TR.RUN_CASES,
                         ids=[f"{k}-{i}" for i, (k, _) in
                              enumerate(TR.RUN_CASES)])
def test_range_run_matches_jax(kind, conf_kw, x64):
    rng = np.random.default_rng(22)
    op, jop, qs, jqs = TR._ops(kind, conf_kw)
    near = qs if kind.startswith("polygons") else TR._polys(30)
    xy64 = TR._points_near(rng, 1400, near)
    if kind == "point":
        xy64[::5] = np.array([116.40, 40.19]) + rng.normal(0, 0.01, (280, 2))
    r = 0.02 if kind in ("point", "linestring") else TR.R
    got = list(op.run(iter(TR._objects(xy64, 700, Point)), qs, r))
    want = list(jop.run(iter(TR._objects(xy64, 700, JPoint)), jqs, r))
    assert len(got) == len(want) and got
    for g, w in zip(got, want):
        assert (g.start, g.end, g.window_count) == (w.start, w.end,
                                                    w.window_count)
        assert [(o.obj_id, o.timestamp) for o in g.objects] == \
            [(o.obj_id, o.timestamp) for o in w.objects]
        assert _within(g.dists, w.dists, GEOM_ATOL * (kind != "point"))
    assert sum(len(g.objects) for g in got) > 0


def test_range_query_incremental_matches_jax(x64):
    rng = np.random.default_rng(23)
    conf = dict(query_type=QueryType.WindowBased, window_size=1.0,
                slide_step=0.5)
    op, jop, _, _ = TR._ops("point", conf)
    xy64 = np.array([116.40, 40.19]) + rng.normal(0, 0.02, (1500, 2))
    got = list(op.query_incremental(iter(TR._objects(xy64, 600, Point)),
                                    Point(x=116.40, y=40.19), 0.02))
    want = list(jop.query_incremental(
        iter(TR._objects(xy64, 600, JPoint)), JPoint(x=116.40, y=40.19),
        0.02))
    assert len(got) == len(want) and got
    for g, w in zip(got, want):
        assert [(o.obj_id, o.timestamp) for o in g.objects] == \
            [(o.obj_id, o.timestamp) for o in w.objects]
        assert _within(g.dists, w.dists)
    assert sum(len(g.objects) for g in got) > 0


@pytest.mark.parametrize("kind,conf_kw,k", TK.RUN_CASES,
                         ids=[f"{kd}-{i}" for i, (kd, _, _) in
                              enumerate(TK.RUN_CASES)])
def test_knn_run_matches_jax(kind, conf_kw, k, x64):
    rng = np.random.default_rng(31)
    xy = TK._xy(rng, 600)
    op, jop = TK._ops(kind, conf_kw)
    q, jq = TK._query(kind)
    pts, jpts = TK._points(xy, 200)
    got = list(op.run(iter(pts), q, TK.R, k))
    want = list(jop.run(iter(jpts), jq, TK.R, k))
    assert len(got) == len(want) and got
    for g, w in zip(got, want):
        assert (g.start, g.end, g.window_count) == (w.start, w.end,
                                                    w.window_count)
        assert [n[0] for n in g.neighbors] == [n[0] for n in w.neighbors]
        assert [(n[2].obj_id, n[2].timestamp) for n in g.neighbors] == \
            [(n[2].obj_id, n[2].timestamp) for n in w.neighbors]
        dg = np.array([n[1] for n in g.neighbors], np.float64)
        dw = np.array([n[1] for n in w.neighbors], np.float64)
        assert np.array_equal(dg == 0, dw == 0)
        assert _within(dg, dw, GEOM_ATOL * (kind != "point"))
    assert sum(len(g.neighbors) for g in got) > 0


def test_knn_run_soa_matches_jax(x64):
    rng = np.random.default_rng(5)
    xy = TK._xy(rng, 3000)
    chunks = [{"ts": np.arange(s, s + 1000, dtype=np.int64),
               "x": xy[s:s + 1000, 0], "y": xy[s:s + 1000, 1],
               "oid": (np.arange(s, s + 1000) % 200).astype(np.int32)}
              for s in range(0, 3000, 1000)]
    op, jop = TK._ops("point", dict(window_size=1.0, slide_step=1.0))
    q, jq = TK._query("point")
    got = list(op.run_soa(chunks, q, TK.R, 10, 256))
    want = list(jop.run_soa(chunks, jq, TK.R, 10, 256))
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert g[:2] == w[:2] and g[4] == w[4] == 10
        assert np.array_equal(g[2], w[2])
        assert _within(g[3], w[3])


@pytest.mark.parametrize("max_pairs", [262_144, 1024])
def test_join_run_soa_matches_jax(max_pairs, x64):
    left, right = TJ._join_streams()
    op = PointPointJoinQuery(QueryConfiguration(**TJ.SOA_CONF),
                             UniformGrid(**TJ.COARSE), cap=TJ.CAP,
                             device="cpu")
    got = list(op.run_soa(left, right, TJ.R, max_pairs=max_pairs))
    jop = TJ.JJoin(TJ.JConf(**TJ.SOA_CONF), TJ.JGrid(**TJ.COARSE),
                   cap=TJ.CAP)
    want = list(jop.run_soa(left, right, TJ.R, max_pairs=max_pairs))
    assert [w[:2] for w in got] == [w[:2] for w in want]
    for g, w in zip(got, want):
        assert (g[5], g[6]) == (w[5], w[6])
        assert len(g[2]) == len(w[2]) and g[4].dtype == np.float64
        pg = {(int(a), int(b)): d for a, b, d in zip(*g[2:5]) if a >= 0}
        pw = {(int(a), int(b)): d for a, b, d in zip(*w[2:5]) if a >= 0}
        assert pg.keys() == pw.keys() and len(pg) == min(g[5], len(g[2]))
        keys = sorted(pg)
        assert _within([pg[k] for k in keys], [pw[k] for k in keys])
    assert got[0][5] == 0 and min(w[5] for w in got[1:]) > 1024


@pytest.mark.parametrize("case", list(TJ.RUN_CASES))
def test_join_run_matches_jax(case, x64):
    conf_kw, n = TJ.RUN_CASES[case]
    conf_kw = dict(conf_kw)
    qt = conf_kw.pop("query_type")
    streams = TJ._point_streams(n, 21)
    mk = [[Point(obj_id=o, timestamp=t, x=x, y=y) for o, t, x, y in s]
          for s in streams]
    jmk = [[JPoint(obj_id=o, timestamp=t, x=x, y=y) for o, t, x, y in s]
           for s in streams]
    op = PointPointJoinQuery(
        QueryConfiguration(query_type=QueryType[qt], **conf_kw),
        UniformGrid(**TJ.COARSE), cap=TJ.CAP, device="cpu")
    jop = TJ.JJoin(TJ.JConf(query_type=TJ.JQT[qt], **conf_kw),
                   TJ.JGrid(**TJ.COARSE), cap=TJ.CAP)
    got = list(op.run(mk[0], mk[1], TJ.R))
    want = list(jop.run(jmk[0], jmk[1], TJ.R))
    assert len(got) == len(want) >= 2
    n_pairs = 0
    for g, w in zip(got, want):
        assert (g.start, g.end, g.overflow, g.window_count) == \
            (w.start, w.end, w.overflow, w.window_count)
        pg, pw = defaultdict(list), defaultdict(list)
        for res, out in ((g, pg), (w, pw)):
            for a, b, d in res.pairs:
                out[(a.obj_id, a.timestamp, b.obj_id, b.timestamp)].append(d)
        assert Counter({k: len(v) for k, v in pg.items()}) == \
            Counter({k: len(v) for k, v in pw.items()})
        for k in pg:
            assert _within(sorted(pg[k]), sorted(pw[k]))
        n_pairs += len(g.pairs)
    assert n_pairs > 200


def test_numpy_twins_compute_in_float64(x64):
    """The driver's failover twins take the float64 lanes too: the same
    windows as the device path (the plain versions here)."""
    rng = np.random.default_rng(24)
    xy64 = np.array([116.40, 40.19]) + rng.normal(0, 0.02, (900, 2))
    pts = TR._objects(xy64, 600, Point)
    q = Point(x=116.40, y=40.19)
    grid = UniformGrid(**BEIJING)
    flags = flags_for_queries(grid, 0.02, [q])
    conf = QueryConfiguration(window_size=1.0, slide_step=1.0)
    rop = PointPointRangeQuery(conf, grid, device="cpu")
    twin = rop._numpy_window_process([q], flags, 0.02, np.float64)
    dev = list(rop.run(iter(pts), [q], 0.02))
    wins = list(rop.windows(iter(pts)))
    assert len(wins) == len(dev) == 2
    for win, d in zip(wins, dev):
        t = twin(win)
        assert [o.obj_id for o in t.objects] == [o.obj_id for o in d.objects]
        assert t.dists.dtype == d.dists.dtype == np.float64
        assert np.array_equal(_bits(t.dists), _bits(d.dists))
    kop = PointPointKNNQuery(conf, grid, device="cpu")
    ktwin = kop._numpy_window_process(q, flags, 0.02, 10, np.float64)
    kdev = list(kop.run(iter(pts), q, 0.02, 10))
    for win, d in zip(kop.windows(iter(pts)), kdev):
        t = ktwin(win)
        assert [(n[0], n[2].obj_id) for n in t.neighbors] == \
            [(n[0], n[2].obj_id) for n in d.neighbors]
        assert np.array_equal(_bits([n[1] for n in t.neighbors]),
                              _bits([n[1] for n in d.neighbors]))
    jop = PointPointJoinQuery(
        QueryConfiguration(query_type=QueryType.RealTimeNaive,
                           realtime_batch_ms=500), grid, device="cpu")
    other = TR._objects(xy64[::-1].copy(), 600, Point, prefix="r")
    jdev = list(jop.run(iter(pts), iter(other), 0.02))
    jtwin = jop._numpy_window_process(0.02, np.float64)
    from spatialflink_tpu_torch.operators.join_query import (
        _TaggedEvent,
        merge_by_timestamp,
    )

    merged = [_TaggedEvent(e.timestamp, tag, e)
              for tag, e in merge_by_timestamp(pts, other)]
    n = 0
    for win, d in zip(jop.windows(iter(merged)), jdev):
        t = jtwin(win)
        assert [(a.obj_id, b.obj_id, float(x)) for a, b, x in t.pairs] == \
            [(a.obj_id, b.obj_id, float(x)) for a, b, x in d.pairs]
        n += len(t.pairs)
    assert n > 0




# ---------------------------------------------------------------------------
# A14.2a: the geometry operators and the pane-carry point paths against
# the JAX package under x64


def _f64_geom(got, want):
    """Geometry distances: float64 both, 0 exactly where the reference is
    0, the rest within ``GEOM_ATOL``."""
    g, w = np.asarray(got), np.asarray(want)
    assert g.dtype == w.dtype == np.float64, (g.dtype, w.dtype)
    assert np.array_equal(g == 0, w == 0)
    return _within(g, w, GEOM_ATOL)


GEOM_SOA_CASES = [(s, q, False, True) for (s, q) in TGR.CLASSES] + [
    ("polygon", "polygon", True, False), ("linestring", "point", True,
                                          False)]


@pytest.mark.parametrize("stream_kind,query_kind,approx,multi_ring",
                         GEOM_SOA_CASES)
def test_geometry_range_run_soa_matches_jax(stream_kind, query_kind, approx,
                                            multi_ring, x64):
    rng = np.random.default_rng(81)
    op, jop, polygonal = TGR._ops(stream_kind, query_kind,
                                  dict(window_size=1.0, slide_step=1.0,
                                       approximate_query=approx))
    qs, jqs, centres = TGR._queries(query_kind, rng)
    objs, _ = TGR._objects(TGR._object_rings(rng, 300, centres), polygonal,
                           100, holes=multi_ring and polygonal)
    chunks = TGR._ragged_chunks(objs, n_chunks=5, edges=multi_ring)
    got = list(op.run_soa(chunks, qs, TGR.R))
    want = list(jop.run_soa(chunks, jqs, TGR.R))
    assert len(got) == len(want) == 3
    kept = 0
    for g, w in zip(got, want):
        assert (g[0], g[1], g[5]) == (w[0], w[1], w[5])
        assert np.array_equal(g[2], w[2]) and np.array_equal(g[3], w[3])
        assert _f64_geom(g[4], w[4])
        kept += len(g[2])
    assert kept > 0


@pytest.mark.parametrize("stream_kind,query_kind,conf_kw", TGR.RUN_CASES,
                         ids=[f"{s}-{q}-{i}" for i, (s, q, _) in
                              enumerate(TGR.RUN_CASES)])
def test_geometry_range_run_matches_jax(stream_kind, query_kind, conf_kw,
                                        x64):
    rng = np.random.default_rng(82)
    op, jop, polygonal = TGR._ops(stream_kind, query_kind, conf_kw)
    qs, jqs, centres = TGR._queries(query_kind, rng)
    objs, jobjs = TGR._objects(TGR._object_rings(rng, 210, centres),
                               polygonal, 70, holes=True)
    got = list(op.run(iter(objs), qs, TGR.R))
    want = list(jop.run(iter(jobjs), jqs, TGR.R))
    assert len(got) == len(want) and got
    for g, w in zip(got, want):
        assert (g.start, g.end, g.window_count) == (w.start, w.end,
                                                    w.window_count)
        assert [(o.obj_id, o.timestamp) for o in g.objects] == \
            [(o.obj_id, o.timestamp) for o in w.objects]
        assert _f64_geom(g.dists, w.dists)
    assert sum(len(g.objects) for g in got) > 0


GEOM_KNN_SOA_CASES = [(s, q, False, False) for (s, q) in TKG.CLASSES] + [
    ("polygon", "polygon", True, False), ("linestring", "point", True,
                                          False),
    ("polygon", "point", False, True)]


@pytest.mark.parametrize("stream_kind,query_kind,approx,multi_ring",
                         GEOM_KNN_SOA_CASES)
def test_geometry_knn_run_soa_matches_jax(stream_kind, query_kind, approx,
                                          multi_ring, x64):
    rng = np.random.default_rng(83)
    op, jop = TKG._ops(stream_kind, query_kind,
                       dict(window_size=1.0, slide_step=1.0,
                            approximate_query=approx))
    q, jq = TKG._query(query_kind, rng)
    objs, _ = TKG._objects(TKG._object_rings(rng, 300),
                           stream_kind == "polygon", 100, holes=multi_ring)
    chunks = TKG._ragged_chunks(objs, n_chunks=5, edges=multi_ring)
    got = list(op.run_soa(chunks, q, TKG.R, TKG.K, TKG.NSEG))
    want = list(jop.run_soa(chunks, jq, TKG.R, TKG.K, TKG.NSEG))
    assert len(got) == len(want) == 3
    full = 0
    for g, w in zip(got, want):
        assert (g[0], g[1], g[4]) == (w[0], w[1], w[4])
        assert np.array_equal(g[2], w[2])
        assert _f64_geom(g[3], w[3])
        full += g[4] == TKG.K
    assert full > 0


@pytest.mark.parametrize("stream_kind,query_kind,conf_kw", TKG.RUN_CASES,
                         ids=[f"{s}-{q}-{i}" for i, (s, q, _) in
                              enumerate(TKG.RUN_CASES)])
def test_geometry_knn_run_matches_jax(stream_kind, query_kind, conf_kw, x64):
    rng = np.random.default_rng(84)
    op, jop = TKG._ops(stream_kind, query_kind, conf_kw)
    q, jq = TKG._query(query_kind, rng)
    objs, jobjs = TKG._objects(TKG._object_rings(rng, 200),
                               stream_kind == "polygon", 100, holes=True)
    got = list(op.run(iter(objs), q, TKG.R, TKG.K))
    want = list(jop.run(iter(jobjs), jq, TKG.R, TKG.K))
    assert len(got) == len(want) >= 2
    for g, w in zip(got, want):
        assert (g.start, g.end, g.window_count) == (w.start, w.end,
                                                    w.window_count)
        assert [n[0] for n in g.neighbors] == [n[0] for n in w.neighbors]
        assert [(n[2].obj_id, n[2].timestamp) for n in g.neighbors] == \
            [(n[2].obj_id, n[2].timestamp) for n in w.neighbors]
        assert _f64_geom([n[1] for n in g.neighbors],
                         [n[1] for n in w.neighbors])
    assert sum(len(g.neighbors) for g in got) > 0


def _join_pairs(res):
    """A join window's pairs → {(left key, right key): sorted distances}
    (the two packages may order a window's pairs differently)."""
    out = defaultdict(list)
    for a, b, d in res.pairs:
        out[(a.obj_id, a.timestamp, b.obj_id, b.timestamp)].append(d)
    return {k: sorted(v) for k, v in out.items()}


def _same_join_windows(got, want, geom=True):
    assert len(got) == len(want) >= 2
    n = 0
    for g, w in zip(got, want):
        assert (g.start, g.end, g.overflow, g.window_count) == \
            (w.start, w.end, w.overflow, w.window_count)
        pg, pw = _join_pairs(g), _join_pairs(w)
        assert pg.keys() == pw.keys()
        keys = sorted(pg)
        dg = np.array([d for k in keys for d in pg[k]], np.float64)
        dw = np.array([d for k in keys for d in pw[k]], np.float64)
        assert (_f64_geom(dg, dw) if geom else _within(dg, dw))
        n += len(g.pairs)
    return n


JOIN_NAMES = TJG.POINT_CLASSES + TJG.GEOM_CLASSES


@pytest.mark.parametrize("name", JOIN_NAMES)
def test_geometry_join_run_matches_jax(name, x64):
    left, right, jleft, jright = TJG._streams(name, 85, holes=True)
    op, jop = TJG._ops(name)
    got = list(op.run(iter(left), iter(right), TJG.R))
    want = list(jop.run(iter(jleft), iter(jright), TJG.R))
    assert _same_join_windows(got, want) > 20
    # The pruned kernel's route keeps the JAX pair order within a window.
    for g, w in zip(got, want):
        assert [(a.obj_id, b.obj_id) for a, b, _ in g.pairs] == \
            [(a.obj_id, b.obj_id) for a, b, _ in w.pairs]


@pytest.mark.parametrize("name", JOIN_NAMES)
def test_geometry_join_run_soa_matches_jax(name, x64):
    left, right, _, _ = TJG._streams(name, 86, holes=True)
    op, jop = TJG._ops(name)

    def chunks(objs):
        if isinstance(objs[0], Point):
            return TJG._point_chunks(objs)
        return TJG._ragged_chunks(objs, edges=True)

    if name in TJG.POINT_CLASSES and not name.startswith("Point"):
        left, right = right, left
    got = list(op.run_soa(chunks(left), chunks(right), TJG.R))
    want = list(jop.run_soa(chunks(left), chunks(right), TJG.R))
    assert len(got) == len(want) >= 3
    for g, w in zip(got, want):
        assert g[:2] == w[:2] and g[5] == w[5]
        assert np.array_equal(g[2], w[2]) and np.array_equal(g[3], w[3])
        assert _f64_geom(g[4], w[4])
    assert sum(g[5] for g in got) > 20


@pytest.mark.parametrize("name", ["PointPolygon", "PolygonPoint",
                                  "PointLineString", "LineStringPoint",
                                  "PolygonPolygon", "LineStringLineString"])
def test_geometry_join_approximate_modes_match_jax(name, x64):
    """Emit-all (cell space, distance 0), point → bbox and bbox ↔ bbox,
    the boxes float64 and unpadded as the JAX package's."""
    left, right, jleft, jright = TJG._streams(name, 87, n=300, m=25)
    op, jop = TJG._ops(name, approx=True)
    got = list(op.run(iter(left), iter(right), TJG.R))
    want = list(jop.run(iter(jleft), iter(jright), TJG.R))
    assert _same_join_windows(got, want, geom=False) > 20
    dists = [d for w in got for *_, d in w.pairs]
    if name.startswith("Point"):
        assert set(dists) == {0.0}
    else:
        assert 0 < max(dists) <= TJG.R
        assert any(float(np.float32(d)) != d for d in dists)  # float64 values


@pytest.mark.parametrize("name,attr,start", [
    ("PointPolygon", "_cand", 1), ("PointLineString", "_pair_cap", 1),
    ("PolygonPolygon", "_cand", 1), ("LineStringPolygon", "_pair_cap", 1),
    ("LineStringPoint", "_geom_max_pairs", 4),
])
def test_geometry_join_retries_grow_as_jax(name, attr, start, x64):
    """The overflow retry in float64: a forced retry reaches the JAX
    result, and both operators end at the same budgets."""
    left, right, jleft, jright = TJG._streams(name, 88, n=600, m=40)
    op, jop = TJG._ops(name)
    setattr(op, attr, start)
    setattr(jop, attr, start)
    got = list(op.run(iter(left), iter(right), TJG.R))
    want = list(jop.run(iter(jleft), iter(jright), TJG.R))
    assert _same_join_windows(got, want) > 20
    state = [(o._cand, o._pair_cap, o._geom_max_pairs) for o in (op, jop)]
    assert state[0] == state[1] and getattr(op, attr) > start


def _f64_lanes(geoms):
    """A geometry batch's float64 kernel lanes (raw coordinates): (verts,
    edge_valid, valid, bbox)."""
    from spatialflink_tpu_torch.models.batch import GeometryBatch
    from spatialflink_tpu_torch.operators.base import center_coords
    from spatialflink_tpu_torch.operators.join_query import _centered_bbox

    grid = UniformGrid(**TJG.GRID16)
    gb = GeometryBatch.from_objects(geoms)
    bbox = _centered_bbox(grid, gb.bbox, np.float64)
    assert bbox.dtype == np.float64
    assert np.array_equal(bbox, _centered_bbox(grid, gb.bbox, np.float64,
                                               pad=False))
    return (center_coords(grid, gb.verts, np.float64), gb.edge_valid,
            gb.valid, bbox)


def _jit(fn, **statics):
    return jax.jit(fn, static_argnames=tuple(statics))


@pytest.mark.parametrize("kind", ["polygon", "linestring"])
@pytest.mark.parametrize("route", ["dense", "pruned", "cand_overflow"])
def test_point_geometry_join_kernels_match_jax(kind, route, x64):
    """The dense and the pruned (tile) point ⋈ geometry kernels on float64
    lanes against the JAX kernels on the same lanes: masks, pairs and
    overflow counters exact, distances float64."""
    from spatialflink_tpu.ops import join as jjoin

    from spatialflink_tpu_torch.ops import join as tjoin

    rng = np.random.default_rng(89)
    pts, _ = TJG._point_objs(rng, 700)
    geoms, _ = TJG._geom_objs(rng, 40, kind, holes=kind == "polygon")
    xy = np.array([[p.x, p.y] for p in pts])
    pxy = xy[np.argsort(xy[:, 0])]
    pvalid = np.ones(len(pxy), bool)
    pvalid[::13] = False
    verts, ev, gvalid, gbbox = _f64_lanes(geoms)
    poly = kind == "polygon"
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))  # noqa: E731
    if route == "dense":
        args = (pxy, pvalid, verts, ev, gvalid)
        got = tjoin.point_geometry_join_kernel(*map(t, args), TJG.R,
                                               polygonal=poly)
        want = _jit(jjoin.point_geometry_join_kernel, polygonal=poly)(
            *map(jnp.asarray, args), TJG.R, polygonal=poly)
        assert np.array_equal(got[0].numpy(), np.asarray(want[0]))
        live = pvalid[None, :] & gvalid[:, None]
        assert _f64_geom(got[1].numpy()[live], np.asarray(want[1])[live])
        assert got[0].sum() > 20
        return
    cand = 2 if route == "cand_overflow" else 32
    args = (pxy, pvalid, verts, ev, gvalid, gbbox)
    st = dict(polygonal=poly, block=256, cand=cand, max_pairs=4096,
              pair_cap=8, approx=False)
    got = tjoin.point_geometry_join_pruned_kernel(*map(t, args), TJG.R,
                                                  **st)
    want = _jit(jjoin.point_geometry_join_pruned_kernel, **st)(
        *map(jnp.asarray, args), TJG.R, **st)
    for a, b in zip(got[:2], want[:2]):
        assert np.array_equal(a.numpy(), np.asarray(b))
    n = int(want.count)
    assert got.dist.dtype == torch.float64
    assert _f64_geom(got.dist.numpy()[:n], np.asarray(want.dist)[:n])
    assert np.all(np.isinf(got.dist.numpy()[n:]))
    for a, b in zip(got[3:], want[3:]):
        assert int(a) == int(b)
    assert (int(got.cand_overflow) > 0) == (route == "cand_overflow")


@pytest.mark.parametrize("pair", list(TJG.KINDS))
@pytest.mark.parametrize("route", ["dense", "pruned"])
def test_geometry_geometry_join_kernels_match_jax(pair, route, x64):
    from spatialflink_tpu.ops import join as jjoin

    from spatialflink_tpu_torch.ops import join as tjoin

    akind, bkind = TJG.KINDS[pair]
    rng = np.random.default_rng(90)
    a, _ = TJG._geom_objs(rng, 120, akind, r_max=0.004, prefix="a")
    a.sort(key=lambda o: o.bbox()[0])
    b, _ = TJG._geom_objs(rng, 40, bkind, holes=bkind == "polygon",
                          prefix="b")
    av, ae, avalid, abox = _f64_lanes(a)
    bv, be, bvalid, bbox = _f64_lanes(b)
    avalid = avalid.copy()
    avalid[5] = False
    ap, bp = akind == "polygon", bkind == "polygon"
    t = lambda x: torch.from_numpy(np.ascontiguousarray(x))  # noqa: E731
    if route == "dense":
        args = (av, ae, avalid, bv, be, bvalid)
        st = dict(a_polygonal=ap, b_polygonal=bp)
        got = tjoin.geometry_geometry_join_kernel(*map(t, args), TJG.R,
                                                  **st)
        want = _jit(jjoin.geometry_geometry_join_kernel, **st)(
            *map(jnp.asarray, args), TJG.R, **st)
        assert np.array_equal(got[0].numpy(), np.asarray(want[0]))
        live = avalid[:, None] & bvalid[None, :]
        assert _f64_geom(got[1].numpy()[live], np.asarray(want[1])[live])
        assert got[0].sum() > 5
        return
    args = (av, ae, avalid, abox, bv, be, bvalid, bbox)
    st = dict(a_polygonal=ap, b_polygonal=bp, block=32, cand=32,
              max_pairs=4096, pair_cap=8, approx=False)
    got = tjoin.geometry_geometry_join_pruned_kernel(*map(t, args), TJG.R,
                                                     **st)
    want = _jit(jjoin.geometry_geometry_join_pruned_kernel, **st)(
        *map(jnp.asarray, args), TJG.R, **st)
    for x, y in zip(got[:2], want[:2]):
        assert np.array_equal(x.numpy(), np.asarray(y))
    n = int(want.count)
    assert n > 5 and got.dist.dtype == torch.float64
    assert _f64_geom(got.dist.numpy()[:n], np.asarray(want.dist)[:n])
    for x, y in zip(got[3:], want[3:]):
        assert int(x) == int(y)


@pytest.mark.parametrize("kind,conf_kw", TKP.PANE_CASES,
                         ids=[f"{kd}-{i}" for i, (kd, _) in
                              enumerate(TKP.PANE_CASES)])
def test_knn_query_panes_matches_jax(kind, conf_kw, x64):
    rng = np.random.default_rng(91)
    xy = TKP._xy(rng, 700)
    pts, jpts = TKP._points(xy, 200)
    q, jq = TKP._query(kind)
    op, jop = TKP._ops(kind, conf_kw)
    got = list(op.query_panes(iter(pts), q, TKP.R, 10))
    want = list(jop.query_panes(iter(jpts), jq, TKP.R, 10))
    assert len(got) == len(want) and got
    for g, w in zip(got, want):
        assert (g.start, g.end, g.window_count) == (w.start, w.end,
                                                    w.window_count)
        assert [(n[0], n[2].obj_id, n[2].timestamp) for n in g.neighbors] \
            == [(n[0], n[2].obj_id, n[2].timestamp) for n in w.neighbors]
        dg = np.array([n[1] for n in g.neighbors], np.float64)
        dw = np.array([n[1] for n in w.neighbors], np.float64)
        assert np.array_equal(dg == 0, dw == 0)
        assert _within(dg, dw, GEOM_ATOL * (kind != "point"))
    assert any(len(w.neighbors) == 10 for w in got)
    live = [e for e in op._pane_carry.values() if e is not None]
    assert live and all(e[1].dtype == torch.float64 for e in live)
    # And bit for bit the port's own float64 run().
    run_op, _ = TKP._ops(kind, conf_kw)
    run = list(run_op.run(iter(pts), q, TKP.R, 10))
    assert [[(n[0], n[1]) for n in w.neighbors] for w in got] == \
        [[(n[0], n[1]) for n in w.neighbors] for w in run]


@pytest.mark.parametrize("conf_kw", TKP.SOA_CASES,
                         ids=["1s-0.5s", "2s-0.5s", "1s-1s"])
def test_knn_run_soa_panes_matches_jax(conf_kw, x64):
    rng = np.random.default_rng(92)
    _, chunks = TKP._soa_chunks(rng, 900, 300)
    op, jop = TKP._ops("point", conf_kw)
    q, jq = TKP._query("point")
    got = list(op.run_soa_panes(chunks, q, TKP.R, 10, TKP.NSEG))
    want = list(jop.run_soa_panes(chunks, jq, TKP.R, 10, TKP.NSEG))
    soa, _ = TKP._ops("point", conf_kw)
    same = list(soa.run_soa(chunks, q, TKP.R, 10, TKP.NSEG))
    assert len(got) == len(want) == len(same) and got
    for g, w, s in zip(got, want, same):
        assert (g[0], g[1], g[4]) == (w[0], w[1], w[4]) == (s[0], s[1], s[4])
        assert np.array_equal(g[2], w[2]) and np.array_equal(g[2], s[2])
        assert _within(g[3], np.asarray(w[3]))
        assert np.array_equal(_bits(g[3]), _bits(s[3]))
    assert any(w[4] == 10 for w in got)
    live = [e for e in op._pane_carry_soa.values() if e is not None]
    assert live and all(e[0].dtype == torch.float64 for e in live)


@pytest.mark.parametrize("nq", [5, 40], ids=["pad8", "two_blocks"])
def test_knn_run_multi_matches_jax(nq, x64):
    rng = np.random.default_rng(93 + nq)
    xy = TKP._xy(rng, 500)
    qs, jqs, _ = TKP._multi_queries(rng, nq)
    pts, jpts = TKP._points(xy, 250)
    conf = dict(window_size=1.0, slide_step=0.5)
    op, jop = TKP._ops("point", conf)
    got = list(op.run_multi(iter(pts), qs, TKP.R, 6))
    want = list(jop.run_multi(iter(jpts), jqs, TKP.R, 6))
    assert len(got) == len(want) == 5
    for m, jm in zip(got, want):
        assert (m.start, m.end, m.window_count) == (jm.start, jm.end,
                                                    jm.window_count)
        for g, w in zip(m.results, jm.results):
            assert [(n[0], n[2].obj_id, n[2].timestamp)
                    for n in g.neighbors] == \
                [(n[0], n[2].obj_id, n[2].timestamp) for n in w.neighbors]
            assert _within([n[1] for n in g.neighbors],
                           [n[1] for n in w.neighbors])
    # Each query equals the port's float64 run() with that query alone.
    for qi in (0, nq - 2):
        one, _ = TKP._ops("point", conf)
        alone = list(one.run(iter(pts), qs[qi], TKP.R, 6))
        assert [[(n[0], n[1]) for n in m.results[qi].neighbors]
                for m in got] == \
            [[(n[0], n[1]) for n in w.neighbors] for w in alone]
    assert sum(len(r.neighbors) for m in got for r in m.results) > nq


def test_join_query_panes_matches_jax(x64):
    left, right, jleft, jright = TJP._streams(94)
    op = PointPointJoinQuery(QueryConfiguration(**TJP.PANES),
                             UniformGrid(**TJP.COARSE), cap=TJP.CAP,
                             device="cpu")
    jop = TJ.JJoin(TJ.JConf(**TJP.PANES), TJ.JGrid(**TJP.COARSE),
                   cap=TJP.CAP)
    got = list(op.query_panes(iter(left), iter(right), TJP.R))
    want = list(jop.query_panes(iter(jleft), iter(jright), TJP.R))
    assert _same_join_windows(got, want, geom=False) > 500
    assert all(w.overflow == 0 for w in got)
    assert sorted(op._join_pane_carry["blocks"]) == \
        sorted(jop._join_pane_carry["blocks"])
    assert any(float(np.float32(d)) != d for w in got for *_, d in w.pairs)


# ---------------------------------------------------------------------------
# Each geometry family at the radius

#: The query point and the radius of the edge cases; ``EDGE_X`` are
#: x coordinates a few float64 ulps either side of ``EDGE_Q.x + EDGE_R``.
#: A vertical edge at such an x is at ``|EDGE_Q.x - x|`` from the query
#: (exact in float64, Sterbenz), so whether it lies within the radius is
#: decided by the last ulp, identically with or without a contracted
#: multiply-add.
EDGE_R = 0.002
EDGE_X = np.array([np.float64(EDGE_Q[0] + EDGE_R)]) + np.arange(-3, 4) * \
    np.spacing(EDGE_Q[0])
EDGE_H = 0.0005


def _square(x0, x1, cls, **meta):
    ring = np.array([[x0, EDGE_Q[1] - EDGE_H], [x1, EDGE_Q[1] - EDGE_H],
                     [x1, EDGE_Q[1] + EDGE_H], [x0, EDGE_Q[1] + EDGE_H],
                     [x0, EDGE_Q[1] - EDGE_H]])
    return cls(rings=[ring], **meta)


def _edge_family(family, port: bool):
    """(kept ids, float64 distances) of one family's run on the objects
    at the radius's edge, through the port (inside the float64 mode) or
    the JAX package at its default dtype."""
    from spatialflink_tpu import operators as jops
    from spatialflink_tpu.models.objects import Polygon as JPolygon

    from spatialflink_tpu_torch import operators as tops

    P, Poly = (Point, Polygon) if port else (JPoint, JPolygon)
    grid = UniformGrid(**BEIJING) if port else TJ.JGrid(**BEIJING)
    conf_kw = dict(window_size=1.0, slide_step=1.0)
    conf = (QueryConfiguration(**conf_kw) if port
            else TJ.JConf(**conf_kw))

    def op(name, **kw):
        if port:
            return getattr(tops, name)(conf, grid, device="cpu", **kw)
        return getattr(jops, name)(conf, grid, **kw)

    q = P(obj_id="q", timestamp=0, x=EDGE_Q[0], y=EDGE_Q[1])
    squares = [_square(x, x + 0.001, Poly, obj_id=f"s{i}", timestamp=i)
               for i, x in enumerate(EDGE_X)]
    near = [P(obj_id=f"s{i}", timestamp=i, x=x, y=EDGE_Q[1])
            for i, x in enumerate(EDGE_X)]
    left_sq = _square(EDGE_Q[0] - 0.001, EDGE_Q[0], Poly, obj_id="a",
                      timestamp=0)
    if family == "geometry_range":
        (w,) = op("PolygonPointRangeQuery").run(iter(squares), [q], EDGE_R)
        return [o.obj_id for o in w.objects], list(w.dists)
    if family == "geometry_knn":
        (w,) = op("PolygonPointKNNQuery").run(iter(squares), q, EDGE_R, 7)
        return [n[0] for n in w.neighbors], [n[1] for n in w.neighbors]
    if family == "knn_query_panes":
        (w,) = op("PointPolygonKNNQuery").query_panes(iter(near), left_sq,
                                                      EDGE_R, 7)
        return [n[0] for n in w.neighbors], [n[1] for n in w.neighbors]
    if family == "point_polygon_join":
        (w,) = op("PointPolygonJoinQuery").run(iter([q]), iter(squares),
                                               EDGE_R)
    elif family == "polygon_polygon_join":
        (w,) = op("PolygonPolygonJoinQuery").run(iter([left_sq]),
                                                 iter(squares), EDGE_R)
    else:  # the pane-carry point join
        (w,) = op("PointPointJoinQuery", cap=8).query_panes(
            iter([q]), iter(near), EDGE_R)
    pairs = sorted((b.obj_id, d) for _, b, d in w.pairs)
    return [p[0] for p in pairs], [p[1] for p in pairs]


EDGE_FAMILIES = ["geometry_range", "geometry_knn", "knn_query_panes",
                 "point_polygon_join", "polygon_polygon_join",
                 "join_query_panes"]


@pytest.mark.parametrize("family", EDGE_FAMILIES)
def test_geometry_families_at_the_radius_keep_the_jax_objects(family, x64):
    got_ids, got_d = _edge_family(family, port=True)
    want_ids, want_d = _edge_family(family, port=False)
    assert sorted(got_ids) == sorted(want_ids)
    assert 0 < len(want_ids) < len(EDGE_X)
    assert np.array_equal(_bits(sorted(got_d)), _bits(sorted(want_d)))


# ---------------------------------------------------------------------------
# Sentinels: float64, at finfo(float64).max


def test_an_object_with_no_valid_vertex_is_at_the_float64_max(x64):
    from spatialflink_tpu.ops import knn as jknn
    from spatialflink_tpu.ops import range as jr

    from spatialflink_tpu_torch.ops import knn as tknn
    from spatialflink_tpu_torch.ops import range as tr

    rng = np.random.default_rng(95)
    rings = [TGR._ring(rng, TGR.CENTRE + rng.uniform(-0.01, 0.01, 2), 0.01,
                       6) for _ in range(8)]
    packed = [pack_rings([r], pad_to=16) for r in rings]
    verts = np.stack([v for v, _ in packed])
    ev = np.stack([e for _, e in packed])
    ev[3] = False  # object 3: no valid edge, so no valid vertex
    qv, qe = pack_rings([TGR._ring(rng, TGR.CENTRE, 0.02, 5)], pad_to=8)
    args = (verts, ev, np.ones(8, bool), np.ones(8, np.uint8), qv[None],
            qe[None])
    keep, dist = tr.geometry_range_query_kernel(
        *(torch.from_numpy(a) for a in args), 0.05, obj_polygonal=True,
        query_polygonal=True)
    jkeep, jdist = jr.geometry_range_query_kernel(
        *(jnp.asarray(a) for a in args), 0.05, obj_polygonal=True,
        query_polygonal=True)
    big = np.finfo(np.float64).max
    assert dist.dtype == torch.float64 and dist[3] == big
    assert np.array_equal(keep.numpy(), np.asarray(jkeep)) and not keep[3]
    assert np.asarray(jdist)[3] == big
    live = np.arange(8) != 3
    assert _f64_geom(dist.numpy()[live], np.asarray(jdist)[live])
    oid = np.arange(8, dtype=np.int32)
    res = tknn.knn_geometry_query_kernel(
        *(torch.from_numpy(a) for a in (verts, ev, np.ones(8, bool),
                                        np.ones(8, np.uint8), oid, qv, qe)),
        0.05, 8, 64, obj_polygonal=True, query_polygonal=True)
    jres = jknn.knn_geometry_query_kernel(
        *(jnp.asarray(a) for a in (verts, ev, np.ones(8, bool),
                                   np.ones(8, np.uint8), oid, qv, qe)),
        0.05, k=8, num_segments=64, obj_polygonal=True,
        query_polygonal=True)
    assert res.dist.dtype == torch.float64 and int(res.num_valid) == 7
    assert np.array_equal(res.segment.numpy(), np.asarray(jres.segment))
    assert res.dist[7] == np.asarray(jres.dist)[7] == big


def test_an_empty_window_is_float64(x64):
    from spatialflink_tpu_torch.ops import knn as tknn
    from spatialflink_tpu_torch.ops import range as tr

    z = torch.zeros((0, 8, 2), dtype=torch.float64)
    ze = torch.zeros((0, 7), dtype=torch.bool)
    qv = torch.zeros((1, 2, 2), dtype=torch.float64)
    qe = torch.ones((1, 1), dtype=torch.bool)
    flags = torch.zeros(0, dtype=torch.uint8)
    keep, dist = tr.geometry_range_query_kernel(
        z, ze, torch.zeros(0, dtype=torch.bool), flags, qv, qe, 0.01)
    assert dist.dtype == torch.float64 and keep.shape == dist.shape == (0,)
    res = tknn.knn_geometry_query_kernel(
        z, ze, torch.zeros(0, dtype=torch.bool), flags,
        torch.zeros(0, dtype=torch.int32), qv[0], qe[0], 0.01, 4, 64)
    assert res.dist.dtype == torch.float64 and int(res.num_valid) == 0
    assert torch.all(res.dist == torch.finfo(torch.float64).max)
    # An empty window of the operators: the JAX empties.
    from spatialflink_tpu_torch.operators import PolygonPolygonRangeQuery

    op = PolygonPolygonRangeQuery(QueryConfiguration(), UniformGrid(
        **BEIJING), device="cpu")
    assert list(op.run_soa([], [Polygon(obj_id="q", rings=[
        np.array([[116.3, 40.1], [116.5, 40.1], [116.5, 40.3],
                  [116.3, 40.1]])])], 0.01)) == []


def test_a_pane_carry_across_an_empty_pane_is_float64(x64):
    """An empty pane merges as ``finfo(float64).max`` (the JAX float64
    empty digest), so padding slots and absent objects stay at the
    float64 sentinel; the operator across a gap equals the JAX one."""
    from spatialflink_tpu.ops import knn as jknn

    from spatialflink_tpu_torch.ops.knn import (
        empty_digest,
        knn_merge_digest_list,
    )

    big = np.finfo(np.float64).max
    emt = empty_digest(64, "cpu", torch.float64)
    assert emt.seg_min.dtype == torch.float64
    assert torch.all(emt.seg_min == big)
    rng = np.random.default_rng(96)
    live = np.full(64, big)
    live[rng.choice(64, 5, replace=False)] = rng.uniform(0, 0.01, 5)
    rep = np.where(live < big, np.arange(64), np.iinfo(np.int32).max
                   ).astype(np.int32)
    got = knn_merge_digest_list(
        [emt.seg_min, torch.from_numpy(live)],
        [emt.rep, torch.from_numpy(rep)], None, 8)
    want = jknn.knn_merge_digest_list(
        (jnp.full(64, big, jnp.float64), jnp.asarray(live)),
        (jnp.full(64, np.iinfo(np.int32).max, jnp.int32), jnp.asarray(rep)),
        np.zeros(2, np.int32), k=8)
    assert got.dist.dtype == torch.float64
    assert np.array_equal(_bits(got.dist.numpy()), _bits(want.dist))
    assert np.array_equal(got.segment.numpy(), np.asarray(want.segment))
    assert got.dist[5:].eq(big).all()
    # The operator over a stream with a gap: empty panes in the carry.
    xy = TKP._xy(rng, 400)
    pts, jpts = TKP._points(xy, 200)
    keep = [i for i, p in enumerate(pts) if not 500 <= p.timestamp < 1500]
    pts = [pts[i] for i in keep]
    jpts = [jpts[i] for i in keep]
    conf = dict(window_size=2.0, slide_step=0.5)
    op, jop = TKP._ops("polygon", conf)
    q, jq = TKP._query("polygon")
    got = list(op.query_panes(iter(pts), q, TKP.R, 10))
    want = list(jop.query_panes(iter(jpts), jq, TKP.R, 10))
    assert len(got) == len(want) and got
    for g, w in zip(got, want):
        assert [n[0] for n in g.neighbors] == [n[0] for n in w.neighbors]
        assert _within([n[1] for n in g.neighbors],
                       [n[1] for n in w.neighbors], GEOM_ATOL)
    assert None in op._pane_carry.values() or any(
        not w.neighbors for w in got)


def test_float64_merge_keeps_the_jax_tie_order(x64):
    """Equal float64 minima across panes and segments: the merge's top-k
    puts the lowest segment first, as the JAX ``lax.top_k`` does, with
    the lowest representative at each minimum."""
    from spatialflink_tpu.ops import knn as jknn

    from spatialflink_tpu_torch.ops.knn import knn_merge_digest_list

    rng = np.random.default_rng(100)
    big = np.finfo(np.float64).max
    ties = np.float64(0.01) + np.spacing(0.01) * rng.integers(0, 3, (3, 64))
    seg = np.where(rng.random((3, 64)) < 0.7, ties, big)
    rep = np.where(seg < big, rng.integers(0, 500, (3, 64)),
                   np.iinfo(np.int32).max).astype(np.int32)
    bases = np.array([0, 500, 1000], np.int32)
    got = knn_merge_digest_list([torch.from_numpy(a) for a in seg],
                                [torch.from_numpy(a) for a in rep], bases,
                                20)
    want = jknn.knn_merge_digest_list(tuple(jnp.asarray(a) for a in seg),
                                      tuple(jnp.asarray(a) for a in rep),
                                      bases, k=20)
    for g, w in zip(got, want):
        assert np.array_equal(np.asarray(g), np.asarray(w))
    assert got.dist.dtype == torch.float64
    assert len(set(got.dist.numpy().tolist())) < 20  # ties were there


# ---------------------------------------------------------------------------
# Resume: the float64 pane carries through checkpoint.py and state.py


def _resume_roundtrip(op, path):
    from spatialflink_tpu_torch.checkpoint import (
        load_checkpoint,
        operator_state,
        save_checkpoint,
    )

    save_checkpoint(path, op=operator_state(op))
    return load_checkpoint(path)["op"]


def test_knn_query_panes_resumes_in_float64(x64, tmp_path):
    from spatialflink_tpu_torch.checkpoint import restore_operator

    rng = np.random.default_rng(97)
    pts, _ = TKP._points(TKP._xy(rng, 900), 200)
    q, _ = TKP._query("polygon")
    conf = dict(window_size=2.0, slide_step=0.5)

    def key(res):
        return [(w.start, w.end, [(n[0], n[1], n[2].obj_id)
                                  for n in w.neighbors]) for w in res]

    base_op, _ = TKP._ops("polygon", conf)
    baseline = key(base_op.query_panes(iter(pts), q, TKP.R, 10))
    op1, _ = TKP._ops("polygon", conf)
    part1 = key(op1.query_panes(iter(pts[:500]), q, TKP.R, 10,
                                flush_at_end=False))
    state = _resume_roundtrip(op1, str(tmp_path / "knn.ckpt"))
    saved = [v[1] for v in state["knn_pane_carry"].values()
             if v is not None]
    assert saved and all(s.dtype == np.float64 for s in saved)
    op2, _ = TKP._ops("polygon", conf)
    restore_operator(op2, state)
    assert all(e[1].dtype == torch.float64
               for e in op2._pane_carry.values() if e is not None)
    part2 = key(op2.query_panes(iter(pts[500:]), q, TKP.R, 10))
    assert part1 and part2 and part1 + part2 == baseline


def test_knn_run_soa_panes_resumes_in_float64(x64, tmp_path):
    from spatialflink_tpu_torch.checkpoint import restore_operator

    rng = np.random.default_rng(98)
    _, chunks = TKP._soa_chunks(rng, 900, 300, n_chunks=6)
    q, _ = TKP._query("point")
    conf = dict(window_size=1.0, slide_step=0.5)

    def key(res):
        return [(w[0], w[1], w[2].tolist(), _bits(w[3]).tolist(), w[4])
                for w in res]

    base_op, _ = TKP._ops("point", conf)
    baseline = key(base_op.run_soa_panes(chunks, q, TKP.R, 10, TKP.NSEG))
    op1, _ = TKP._ops("point", conf)
    part1 = key(op1.run_soa_panes(chunks[:3], q, TKP.R, 10, TKP.NSEG,
                                  flush_at_end=False))
    state = _resume_roundtrip(op1, str(tmp_path / "soa.ckpt"))
    op2, _ = TKP._ops("point", conf)
    restore_operator(op2, state)
    assert all(e[0].dtype == torch.float64
               for e in op2._pane_carry_soa.values() if e is not None)
    part2 = key(op2.run_soa_panes(chunks[3:], q, TKP.R, 10, TKP.NSEG))
    assert part1 and part2 and part1 + part2 == baseline


def test_a_jax_float64_carry_stays_float64(x64):
    """A JAX ``query_panes`` run in float64 (its default dtype under x64)
    cut with ``flush_at_end=False``; its carry moved to a port operator
    through ``state.pane_carry_from_jax`` stays float64, bit for bit, and
    continues the JAX windows."""
    from spatialflink_tpu_torch.state import (
        interner_from_jax,
        pane_carry_from_jax,
    )

    rng = np.random.default_rng(99)
    pts, jpts = TKP._points(TKP._xy(rng, 1000), 200)
    conf = dict(window_size=2.0, slide_step=1.0)
    q, jq = TKP._query("polygon")
    _, full_op = TKP._ops("polygon", conf)
    full = list(full_op.query_panes(iter(jpts), jq, TKP.R, 10))
    _, jop = TKP._ops("polygon", conf)
    head = list(jop.query_panes(iter([p for p in jpts if p.timestamp < 3200]),
                                jq, TKP.R, 10, flush_at_end=False))
    assert [w.end for w in head] == [1000, 2000, 3000]
    op, _ = TKP._ops("polygon", conf)
    op.interner = interner_from_jax(jop)
    op._pane_carry, _ = pane_carry_from_jax(jop, device="cpu")
    _, sm, _, _ = op._pane_carry[1000]
    assert sm.dtype == torch.float64
    assert np.array_equal(_bits(sm.numpy()),
                          _bits(np.asarray(jop._pane_carry[1000][1])))
    got = list(op.query_panes(iter([p for p in pts if p.timestamp >= 2000]),
                              q, TKP.R, 10))
    tail = [w for w in full if w.start >= 2000]
    assert len(got[1:]) == len(tail) and tail
    for g, w in zip(got[1:], tail):
        assert [n[0] for n in g.neighbors] == [n[0] for n in w.neighbors]
        assert _within([n[1] for n in g.neighbors],
                       [n[1] for n in w.neighbors], GEOM_ATOL)


# ---------------------------------------------------------------------------
# B4's and B3's plain float64 versions against the JAX functions, eager


def test_b4_plain_float64_equals_jax_eager():
    """``polyline_min_dist_plain`` in float64, dense and gathered, bit for
    bit against the JAX ``point_polyline_distance`` of each boundary run
    op by op; ``finfo(float64).max`` for a boundary with no valid edge;
    and the float64 containment against the JAX ``points_in_polygon``."""
    rng = np.random.default_rng(40)
    boundaries = []
    for k in range(6):
        rings = [116.3 + rng.uniform(0, 0.2, (int(rng.integers(4, 9)), 2))
                 * np.array([1.0, 0.6]) + np.array([0, 40.0])]
        if k % 2:
            rings.append(rings[0][:4] * 0.5 + rings[0].mean(axis=0) * 0.5)
        boundaries.append(pack_rings(rings, pad_to=32))
    verts = np.stack([v for v, _ in boundaries])
    ev = np.stack([e for _, e in boundaries])
    verts[2, 5] = verts[2, 4]  # a zero-length edge
    ev[5] = False  # no valid edge
    pts = np.stack([rng.uniform(116.25, 116.55, 2500),
                    rng.uniform(39.95, 40.2, 2500)], axis=1)
    pts[:20] = verts[0, :20]  # on vertices
    dense = polyline_min_dist_plain(torch.from_numpy(pts),
                                    torch.from_numpy(verts),
                                    torch.from_numpy(ev)).numpy()
    assert dense.dtype == np.float64
    for g in range(len(verts)):
        want = np.asarray(jd.point_polyline_distance(
            jnp.asarray(pts), jnp.asarray(verts[g]), jnp.asarray(ev[g])))
        assert want.dtype == np.float64
        assert np.array_equal(_bits(dense[:, g]), _bits(want)), g
    assert np.all(dense[:, 5] == np.finfo(np.float64).max)
    sel = rng.integers(0, len(verts), (len(pts), 3)).astype(np.int32)
    gathered = polyline_min_dist(torch.from_numpy(pts),
                                 torch.from_numpy(verts),
                                 torch.from_numpy(ev),
                                 torch.from_numpy(sel)).numpy()
    assert np.array_equal(_bits(gathered),
                          _bits(np.take_along_axis(dense, sel, axis=1)))
    inside = points_in_polygons(torch.from_numpy(pts),
                                torch.from_numpy(verts),
                                torch.from_numpy(ev)).numpy()
    for g in range(len(verts)):
        assert np.array_equal(inside[:, g], np.asarray(j_pip(
            jnp.asarray(pts), jnp.asarray(verts[g]), jnp.asarray(ev[g]))))
    assert 0 < inside.sum() < inside.size


@pytest.mark.parametrize("radius,layers", [(0.05, 1), (0.12, 2)])
def test_b3_plain_float64_equals_jax_eager(radius, layers):
    """``join_window`` on float64 lanes (B3's plain version) against the
    JAX ``join_window_bucketed`` run op by op on the same float64 lanes:
    the same pairs, count and overflow, distances bit for bit (the two
    order pairs differently: cell-major and neighbour-major)."""
    grid = UniformGrid(**TJ.COARSE)
    rng = np.random.default_rng(41)
    sides = []
    for n in (900, 700):
        xy = np.stack([rng.uniform(115.5, 117.6, n),
                       rng.uniform(39.6, 41.1, n)], axis=1)
        valid = rng.random(n) > 0.1
        sides.append((xy, valid, grid.assign_cells_np(xy).astype(np.int32)))
    # Right points at exactly the radius from left ones (on the 2^-36
    # lattice, so the offset is exact): d² == r² in float64 both sides.
    lat = 2.0 ** -36
    snap = [np.round(s[0] / lat) * lat for s in sides]
    r = np.round(radius / lat) * lat
    snap[1][:100] = snap[0][:100] + np.array([r, 0.0])
    sides = [(xy, v, grid.assign_cells_np(xy).astype(np.int32))
             for xy, (_, v, _) in zip(snap, sides)]
    args = [a for s in sides for a in s]
    cap = 24
    got = join_window(*[torch.from_numpy(a) for a in args], grid.n, layers,
                      float(r), cap, cap, 1 << 16)
    want = join_window_bucketed(*[jnp.asarray(a) for a in args],
                                grid_n=grid.n, layers=layers,
                                radius=float(r), cap_left=cap,
                                cap_right=cap, max_pairs=1 << 16)
    assert int(got.count) == int(want.count) > 100
    assert int(got.overflow) == int(want.overflow)
    assert got.dist.dtype == torch.float64

    def pairs(li, ri, dd):
        li, ri, dd = (np.asarray(a) for a in (li, ri, dd))
        keep = li >= 0
        return {(int(a), int(b)): d
                for a, b, d in zip(li[keep], ri[keep], dd[keep])}

    pg = pairs(got.left_index, got.right_index, got.dist)
    pw = pairs(want.left_index, want.right_index, want.dist)
    assert pg.keys() == pw.keys()
    keys = sorted(pg)
    assert np.array_equal(_bits([pg[k] for k in keys]),
                          _bits([pw[k] for k in keys]))
    on = [k for k in keys if k[0] == k[1] and k[0] < 100]
    assert on and all(pg[k] == r for k in on)


# ---------------------------------------------------------------------------
# x64 off, or float32 asked for: today's float32 results


def _slice_runs(dtype=None):
    """The range, kNN and join run_soa of one stream, each with
    ``dtype`` (the default when None)."""
    kw = {} if dtype is None else {"dtype": dtype}
    rng = np.random.default_rng(50)
    op, _, qs, _ = TR._ops("polygons_70", dict(window_size=1.0,
                                               slide_step=1.0))
    xy64 = TR._points_near(rng, 2 * 2000, qs)
    chunks = TR._chunks(xy64, 2, 2000)
    rng_out = [w[3] for w in op.run_soa(chunks, qs, TR.R, **kw)]
    kop, _ = TK._ops("polygon", dict(window_size=1.0, slide_step=1.0))
    q, _ = TK._query("polygon")
    pts, _ = TK._points(TK._xy(rng, 600), 200)
    knn_out = [np.array([n[1] for n in w.neighbors])
               for w in kop.run(iter(pts), q, TK.R, 10, **kw)]
    left, right = TJ._join_streams()
    jop = PointPointJoinQuery(QueryConfiguration(**TJ.SOA_CONF),
                              UniformGrid(**TJ.COARSE), cap=TJ.CAP,
                              device="cpu")
    join_out = [w[4] for w in jop.run_soa(left, right, TJ.R, **kw)]
    return rng_out, knn_out, join_out


def test_x64_off_or_float32_gives_todays_float32_results():
    off = _slice_runs()
    with precision.x64(True):
        f32 = _slice_runs(np.float32)
        f64 = _slice_runs()
    for a, b, c in zip(off, f32, f64):
        assert len(a) == len(b) == len(c) > 0
        for x, y in zip(a, b):
            assert np.array_equal(x, y)
    # kNN neighbours carry Python floats; the range and join arrays keep
    # their dtype: float32 off or asked for, float64 in the mode.
    for fam in (0, 2):
        assert all(x.dtype == np.float32 for x in off[fam] + f32[fam])
        assert all(z.dtype == np.float64 for z in f64[fam])


# ---------------------------------------------------------------------------
# The 65 entry points that raised in float64 before A14.2a: the 45 it
# ports, the 16 of A14.2b and the 4 of A14.2c run in float64


def _a14_2_calls():
    """(label, call) of every entry point whose float64 route was ROADMAP
    item A14.2, each called as a user would on empty streams."""
    from spatialflink_tpu_torch import operators as ops
    from spatialflink_tpu_torch.ops.tjoin_panes import tjoin_pane_init
    from spatialflink_tpu_torch.parallel.mesh import make_mesh
    from spatialflink_tpu_torch.qserve import QServeOperator
    from spatialflink_tpu_torch.streams.panes import traj_stats_sliding

    grid = UniformGrid(**BEIJING)
    conf = QueryConfiguration(window_size=1.0, slide_step=1.0)
    ring = np.array([[116.3, 40.1], [116.5, 40.1], [116.5, 40.3],
                     [116.3, 40.3], [116.3, 40.1]])
    poly = Polygon(obj_id="q", rings=[ring])
    line = LineString(obj_id="l", coords=ring[:3])
    pt = Point(obj_id="p", x=116.4, y=40.2)
    queries = {"Point": pt, "Polygon": poly, "LineString": line}
    calls = []

    def op(cls, **kw):
        return getattr(ops, cls)(conf, grid, device="cpu", **kw)

    for s in ("Polygon", "LineString"):
        for q, qobj in queries.items():
            rcls, kcls = f"{s}{q}RangeQuery", f"{s}{q}KNNQuery"
            calls += [
                (f"{rcls}.run", lambda c=rcls, o=qobj: list(
                    op(c).run(iter([]), [o], 0.01))),
                (f"{rcls}.run_soa", lambda c=rcls, o=qobj: list(
                    op(c).run_soa([], [o], 0.01))),
                (f"{kcls}.run", lambda c=kcls, o=qobj: list(
                    op(c).run(iter([]), o, 0.01, 5))),
                (f"{kcls}.run_soa", lambda c=kcls, o=qobj: list(
                    op(c).run_soa([], o, 0.01, 5, 64))),
            ]
    for jcls in ("PointPolygonJoinQuery", "PointLineStringJoinQuery",
                 "PolygonPointJoinQuery", "LineStringPointJoinQuery",
                 "PolygonPolygonJoinQuery", "PolygonLineStringJoinQuery",
                 "LineStringPolygonJoinQuery",
                 "LineStringLineStringJoinQuery"):
        calls += [
            (f"{jcls}.run", lambda c=jcls: list(
                op(c).run(iter([]), iter([]), 0.01))),
            (f"{jcls}.run_soa", lambda c=jcls: list(
                op(c).run_soa([], [], 0.01))),
        ]
    mesh = make_mesh((2,), ("data",), devices=["cpu", "cpu"])
    calls += [
        ("PointPointJoinQuery.query_panes", lambda: list(
            op("PointPointJoinQuery").query_panes(iter([]), iter([]),
                                                  0.01))),
        ("PointPointKNNQuery.query_panes", lambda: list(
            op("PointPointKNNQuery").query_panes(iter([]), pt, 0.01, 5))),
        ("PointPolygonKNNQuery.query_panes", lambda: list(
            op("PointPolygonKNNQuery").query_panes(iter([]), poly, 0.01,
                                                   5))),
        ("PointPointKNNQuery.run_soa_panes", lambda: list(
            op("PointPointKNNQuery").run_soa_panes([], pt, 0.01, 5, 64))),
        ("PointPointKNNQuery.run_multi", lambda: list(
            op("PointPointKNNQuery").run_multi(iter([]), [pt], 0.01, 5))),
        ("PointPointRangeQuery.run(mesh=)", lambda: list(
            op("PointPointRangeQuery").run(iter([]), [pt], 0.01,
                                           mesh=mesh))),
        ("PointPolygonKNNQuery.run(mesh=)", lambda: list(
            op("PointPolygonKNNQuery").run(iter([]), poly, 0.01, 5,
                                           mesh=mesh))),
        ("PointPointJoinQuery.run(mesh=)", lambda: list(
            op("PointPointJoinQuery").run(iter([]), iter([]), 0.01,
                                          mesh=mesh))),
        ("PointPointRangeQuery.run_partitioned", lambda: list(
            op("PointPointRangeQuery").run_partitioned(iter([]), [pt], 0.01,
                                                       mesh))),
        ("TRangeQuery.run", lambda: list(
            op("TRangeQuery").run(iter([]), [poly]))),
        ("TRangeQuery.run_soa", lambda: list(
            op("TRangeQuery").run_soa([], [poly], 64))),
        ("TKNNQuery.run", lambda: list(
            op("TKNNQuery").run(iter([]), pt, 0.01, 5))),
        ("TKNNQuery.run_soa", lambda: list(
            op("TKNNQuery").run_soa([], pt, 0.01, 5, 64))),
        ("TJoinQuery.run", lambda: list(
            op("TJoinQuery").run(iter([]), iter([]), 0.01))),
        ("TJoinQuery.run_single", lambda: list(
            op("TJoinQuery").run_single(iter([]), 0.01))),
        ("TJoinQuery.run_soa", lambda: list(
            op("TJoinQuery").run_soa([], [], 0.01, 64))),
        ("TJoinQuery.run_soa_panes", lambda: list(
            op("TJoinQuery").run_soa_panes([], [], 0.01, 64))),
        ("TAggregateQuery.run", lambda: list(
            op("TAggregateQuery").run(iter([])))),
        ("TAggregateQuery.run_soa", lambda: list(
            op("TAggregateQuery").run_soa([]))),
        ("TStatsQuery.run", lambda: list(op("TStatsQuery").run(iter([])))),
        ("TStatsQuery.run_soa", lambda: list(
            op("TStatsQuery").run_soa([], 64))),
        ("traj_stats_sliding (tStats panes)", lambda: traj_stats_sliding(
            np.arange(4, dtype=np.int64), np.zeros((4, 2)),
            np.zeros(4, np.int64), 1, 100, 10, backend="device",
            device="cpu")),
        ("tjoin_pane_init", lambda: tjoin_pane_init(
            4, 8, 2, 2, dtype=np.float64, device="cpu")),
        ("QServeOperator.run", lambda: list(
            QServeOperator(conf, grid, device="cpu").run(iter([])))),
        ("QServeOperator.serve_window", lambda: QServeOperator(
            conf, grid, device="cpu").serve_window(None, None)),
    ]
    return calls


A14_2_CALLS = _a14_2_calls()
#: The radius of the float64 runs of the slice's calls on tiny streams.
TINY_R = 0.2


def _tiny_data():
    """Tiny non-empty streams for the slice's calls: three polygons and
    three linestrings 0.003 right of the query square's and the query
    line's right edge, three points beside them, all in one window."""
    xs = 116.503 + 0.001 * np.arange(3)
    sq = [np.array([[x, 40.199], [x + 4e-4, 40.199], [x + 4e-4, 40.201],
                    [x, 40.201], [x, 40.199]]) for x in xs]
    meta = [dict(obj_id=f"g{i}", timestamp=100 * i) for i in range(3)]
    geoms = {
        "Polygon": [Polygon(rings=[r], **m) for r, m in zip(sq, meta)],
        "LineString": [LineString(coords=r[:3], **m)
                       for r, m in zip(sq, meta)],
    }
    points = [Point(obj_id=f"p{i}", timestamp=100 * i + 50, x=x, y=40.2003)
              for i, x in enumerate(xs)]
    return geoms, points


def _ragged(objs):
    rows = [(o.timestamp, i, *o.packed()) for i, o in enumerate(objs)]
    return [{"ts": np.array([r[0] for r in rows], np.int64),
             "oid": np.array([r[1] for r in rows], np.int32),
             "lengths": np.array([len(r[2]) for r in rows], np.int64),
             "verts": np.concatenate([r[2] for r in rows]),
             "edge_valid": np.concatenate([r[3] for r in rows])}]


def _pts_chunks(points):
    return [{"ts": np.array([p.timestamp for p in points], np.int64),
             "x": np.array([p.x for p in points]),
             "y": np.array([p.y for p in points]),
             "oid": np.arange(len(points), dtype=np.int32)}]


def _a14_2a_runs():
    """(label, call) of every entry point this slice ports, each run as a
    user would on a tiny non-empty stream; a call returns its windows'
    distances: arrays where the path yields arrays, Python floats where
    it yields objects."""
    from spatialflink_tpu_torch import operators as ops

    grid = UniformGrid(**BEIJING)
    conf = QueryConfiguration(window_size=1.0, slide_step=1.0)
    ring = np.array([[116.3, 40.1], [116.5, 40.1], [116.5, 40.3],
                     [116.3, 40.3], [116.3, 40.1]])
    queries = {"Point": Point(obj_id="p", x=116.4, y=40.2),
               "Polygon": Polygon(obj_id="q", rings=[ring]),
               "LineString": LineString(obj_id="l", coords=ring[:3])}
    geoms, points = _tiny_data()
    r = TINY_R

    def op(cls, **kw):
        return getattr(ops, cls)(conf, grid, device="cpu", **kw)

    def range_d(res):
        return [d for w in res for d in w.dists]

    def knn_d(res):
        return [n[1] for w in res for n in w.neighbors]

    def join_d(res):
        return [d for w in res for *_, d in w.pairs]

    runs = []
    for s in ("Polygon", "LineString"):
        for q, qobj in queries.items():
            rcls, kcls = f"{s}{q}RangeQuery", f"{s}{q}KNNQuery"
            runs += [
                (f"{rcls}.run", lambda c=rcls, o=qobj, g=geoms[s]: range_d(
                    op(c).run(iter(g), [o], r))),
                (f"{rcls}.run_soa", lambda c=rcls, o=qobj, g=geoms[s]:
                 np.concatenate([w[4] for w in op(c).run_soa(
                     _ragged(g), [o], r)])),
                (f"{kcls}.run", lambda c=kcls, o=qobj, g=geoms[s]: knn_d(
                    op(c).run(iter(g), o, r, 3))),
                (f"{kcls}.run_soa", lambda c=kcls, o=qobj, g=geoms[s]:
                 np.concatenate([w[3] for w in op(c).run_soa(
                     _ragged(g), o, r, 3, 64)])),
            ]
    for jcls in ("PointPolygonJoinQuery", "PointLineStringJoinQuery",
                 "PolygonPointJoinQuery", "LineStringPointJoinQuery",
                 "PolygonPolygonJoinQuery", "PolygonLineStringJoinQuery",
                 "LineStringPolygonJoinQuery",
                 "LineStringLineStringJoinQuery"):
        kinds = [k for k in ("Point", "Polygon", "LineString")
                 if jcls.startswith(k)]
        left = kinds[0]
        right = jcls[len(left):-len("JoinQuery")]
        side = {"Point": points, **geoms}
        # run_soa takes the point chunks first in every point class.
        soa = [left, right] if left == "Point" or right != "Point" \
            else [right, left]

        def chunks(kind):
            return _pts_chunks(points) if kind == "Point" \
                else _ragged(geoms[kind])

        runs += [
            (f"{jcls}.run", lambda c=jcls, a=side[left], b=side[right]:
             join_d(op(c).run(iter(a), iter(b), r))),
            (f"{jcls}.run_soa", lambda c=jcls, a=soa[0], b=soa[1]:
             np.concatenate([w[4] for w in op(c).run_soa(
                 chunks(a), chunks(b), r)])),
        ]
    other = [Point(obj_id=f"o{i}", timestamp=p.timestamp, x=p.x + 0.01,
                   y=p.y) for i, p in enumerate(points)]
    runs += [
        # One neighbour layer: the grid join's plain version tests every
        # slot pair of its planes, costly on the CPU at TINY_R's layers.
        ("PointPointJoinQuery.query_panes", lambda: join_d(
            op("PointPointJoinQuery", cap=8).query_panes(
                iter(points), iter(other), 0.02))),
        ("PointPointKNNQuery.query_panes", lambda: knn_d(
            op("PointPointKNNQuery").query_panes(iter(points),
                                                 queries["Point"], r, 3))),
        ("PointPolygonKNNQuery.query_panes", lambda: knn_d(
            op("PointPolygonKNNQuery").query_panes(
                iter(points), queries["Polygon"], r, 3))),
        ("PointPointKNNQuery.run_soa_panes", lambda: np.concatenate(
            [w[3] for w in op("PointPointKNNQuery").run_soa_panes(
                _pts_chunks(points), queries["Point"], r, 3, 64)])),
        ("PointPointKNNQuery.run_multi", lambda: [
            n[1] for m in op("PointPointKNNQuery").run_multi(
                iter(points), [queries["Point"]], r, 3)
            for w in m.results for n in w.neighbors]),
    ]
    return runs


A14_2A = _a14_2a_runs()
def _lanes_spy(monkeypatch):
    """The dtypes of every coordinate lane ``center_coords`` makes, read
    through the module names the trajectory operators and the server
    call it by."""
    from spatialflink_tpu_torch import qserve
    from spatialflink_tpu_torch.operators import base
    from spatialflink_tpu_torch.operators import trajectory as ttraj

    seen = []
    inner = base.center_coords

    def spy(*args, **kw):
        out = inner(*args, **kw)
        seen.append(out.dtype)
        return out

    for mod in (base, ttraj, qserve):
        monkeypatch.setattr(mod, "center_coords", spy)
    return seen


def _a14_2b_runs():
    """(label, call) of the 16 calls of ROADMAP item A14.2b, under the
    labels of ``A14_2_CALLS``, each run as a user would on a tiny
    non-empty stream; a call returns (its results, the float arrays it
    returned)."""
    from spatialflink_tpu_torch import operators as ops
    from spatialflink_tpu_torch import qserve
    from spatialflink_tpu_torch.ops.query_registry import (
        registry_bucket_kernel,
    )
    from spatialflink_tpu_torch.ops.tjoin_panes import tjoin_pane_init
    from spatialflink_tpu_torch.streams.panes import traj_stats_sliding

    grid = UniformGrid(**BEIJING)
    conf = QueryConfiguration(window_size=1.0, slide_step=1.0)
    ring = np.array([[116.3, 40.1], [116.5, 40.1], [116.5, 40.3],
                     [116.3, 40.3], [116.3, 40.1]])
    poly = Polygon(obj_id="q", rings=[ring])
    _, points = _tiny_data()
    points = points + [Point(obj_id="p0", timestamp=900, x=116.4003,
                             y=40.2001)]
    other = [Point(obj_id=f"o{i}", timestamp=p.timestamp, x=p.x + 0.01,
                   y=p.y) for i, p in enumerate(points)]
    chunks = _pts_chunks(points)
    chunks[0]["oid"] = np.array([0, 1, 2, 0], np.int32)
    ochunks = _pts_chunks(other)
    q = Point(obj_id="p", x=116.4, y=40.2)
    r = TINY_R

    def op(cls, **kw):
        return getattr(ops, cls)(conf, grid, device="cpu", **kw)

    def pair_d(res):
        return [np.array([d for *_, d in w.pairs]) for w in res]

    def served(run):
        try:
            rows = run()
        finally:
            qserve.uninstall()
        return rows, [np.array([row[4] for row in rows])]

    def serve_stream():
        sq = qserve.StandingQuery(qid="q", tenant="t", kind="knn", x=116.4,
                                  y=40.2, radius=r, k=3)
        return [qserve.QServeCommand(timestamp=0, action="register",
                                     uid="u", query=sq)] + points

    def serve_window():
        sop = qserve.QServeOperator(conf, grid, device="cpu")
        kernel = registry_bucket_kernel
        return [row for win in sop.windows(iter(serve_stream()))
                for row in sop.serve_window(win, kernel).rows]

    def tstats_panes():
        ts = np.array([p.timestamp for p in points], np.int64)
        xy = np.array([[p.x, p.y] for p in points])
        oid = np.array([0, 1, 2, 0], np.int64)
        res = traj_stats_sliding(ts, xy, oid, 3, 1000, 100,
                                 backend="device", device="cpu")
        return res.starts, [res.spatial]

    def tagg(res):
        return res, []

    return [
        ("TRangeQuery.run", lambda: (list(op("TRangeQuery").run(
            iter(points), [poly])), [])),
        ("TRangeQuery.run_soa", lambda: (list(op("TRangeQuery").run_soa(
            chunks, [poly], 64)), [])),
        ("TKNNQuery.run", lambda: (lambda res: (res, [np.array(
            [n[1] for w in res for n in w.neighbors])]))(list(
                op("TKNNQuery").run(iter(points), q, r, 2)))),
        ("TKNNQuery.run_soa", lambda: (lambda res: (res, [w[3] for w in res]))(
            list(op("TKNNQuery").run_soa(chunks, q, r, 2, 64)))),
        ("TJoinQuery.run", lambda: (lambda res: (res, pair_d(res)))(list(
            op("TJoinQuery", cap=8).run(iter(points), iter(other), 0.02)))),
        ("TJoinQuery.run_single", lambda: (lambda res: (res, pair_d(res)))(
            list(op("TJoinQuery", cap=8).run_single(iter(points + other),
                                                     0.02)))),
        ("TJoinQuery.run_soa", lambda: (lambda res: (
            res, [w[4] for w in res]))(list(op("TJoinQuery", cap=8).run_soa(
                chunks, ochunks, 0.02, 64)))),
        ("TJoinQuery.run_soa_panes", lambda: (lambda res: (
            res, [w[4] for w in res]))(list(op("TJoinQuery").run_soa_panes(
                chunks, ochunks, 0.02, 8, backend="device")))),
        ("TAggregateQuery.run", lambda: tagg(list(
            op("TAggregateQuery").run(iter(points))))),
        ("TAggregateQuery.run_soa", lambda: tagg(list(
            op("TAggregateQuery").run_soa(chunks)))),
        ("TStatsQuery.run", lambda: (lambda res: (res, [np.array(
            [s[0] for w in res for s in w.stats.values()])]))(list(
                op("TStatsQuery").run(iter(points))))),
        ("TStatsQuery.run_soa", lambda: (lambda res: (
            res, [w[2] for w in res]))(list(op("TStatsQuery").run_soa(
                chunks, 64)))),
        ("traj_stats_sliding (tStats panes)", tstats_panes),
        ("tjoin_pane_init", lambda: (lambda c: ([c], [
            c.lwx.numpy(), c.digests.numpy()]))(tjoin_pane_init(
                4, 8, 2, 2, dtype=np.float64, device="cpu"))),
        ("QServeOperator.run", lambda: served(lambda: [
            row for res in qserve.QServeOperator(conf, grid, device="cpu")
            .run(iter(serve_stream())) for row in res.rows])),
        ("QServeOperator.serve_window", lambda: served(serve_window)),
    ]


A14_2B = _a14_2b_runs()


def _a14_2c_runs():
    """(label, call) of the 4 calls of ROADMAP item A14.2c, under the
    labels of ``A14_2_CALLS``, each run as a user would on a tiny
    non-empty stream on a two-shard CPU mesh; a call returns (the mesh
    run's distances, the unsharded run's), an array each."""
    from spatialflink_tpu_torch import operators as ops
    from spatialflink_tpu_torch.parallel.mesh import make_mesh

    grid = UniformGrid(**BEIJING)
    conf = QueryConfiguration(window_size=1.0, slide_step=1.0)
    ring = np.array([[116.3, 40.1], [116.5, 40.1], [116.5, 40.3],
                     [116.3, 40.3], [116.3, 40.1]])
    pt = Point(obj_id="p", x=116.4, y=40.2)
    poly = Polygon(obj_id="q", rings=[ring])
    _, points = _tiny_data()
    other = [Point(obj_id=f"o{i}", timestamp=p.timestamp, x=p.x + 0.01,
                   y=p.y) for i, p in enumerate(points)]
    mesh = make_mesh((2,), ("data",), devices=["cpu", "cpu"])
    r = TINY_R

    def op(cls, **kw):
        return getattr(ops, cls)(conf, grid, device="cpu", **kw)

    def both(run):
        return tuple(np.array(run(m), np.float64) for m in (mesh, None))

    return [
        ("PointPointRangeQuery.run(mesh=)", lambda: both(lambda m: [
            d for w in op("PointPointRangeQuery").run(
                iter(points), [pt], r, mesh=m) for d in w.dists])),
        ("PointPolygonKNNQuery.run(mesh=)", lambda: both(lambda m: [
            n[1] for w in op("PointPolygonKNNQuery").run(
                iter(points), poly, r, 3, mesh=m) for n in w.neighbors])),
        # One neighbour layer, as A14_2A's query_panes: the plain grid
        # join tests every slot pair of its planes.
        ("PointPointJoinQuery.run(mesh=)", lambda: both(lambda m: sorted(
            d for w in op("PointPointJoinQuery", cap=8).run(
                iter(points), iter(other), 0.02, mesh=m)
            for *_, d in w.pairs))),
        # The halo route against the flag-table route on one device: one
        # root of the same float64 sum at every kept point.
        ("PointPointRangeQuery.run_partitioned", lambda: (
            np.concatenate([w.dists for w in op(
                "PointPointRangeQuery").run_partitioned(
                    iter(points), [pt], r, mesh)]),
            np.concatenate([w.dists for w in op("PointPointRangeQuery")
                            .run(iter(points), [pt], r)]))),
    ]


A14_2C = _a14_2c_runs()


def test_the_65_calls_split_61_and_4():
    """The 65 calls that raised in float64 before A14.2a are the 45 it
    ported, the 16 of A14.2b and the 4 of A14.2c, and every one of them
    runs in float64 (the tests below)."""
    labels = [c[0] for c in A14_2_CALLS]
    assert len(labels) == len(set(labels)) == 65
    assert len(A14_2A) == 45 and len(A14_2B) == 16 and len(A14_2C) == 4
    ported = [lb for lb, _ in A14_2A + A14_2B + A14_2C]
    assert len(ported) == len(set(ported)) and set(ported) == set(labels)


@pytest.mark.parametrize("label,call", A14_2C, ids=[c[0] for c in A14_2C])
def test_entry_points_outside_the_slice_raise_in_float64(label, call, x64):
    """The 4 calls of A14.2c, refused in float64 before it, on a tiny
    non-empty stream on a two-shard CPU mesh: they run, their distances
    are float64 and hold a value no float32 holds, and they equal the
    unsharded run's bit for bit (the join's as a set)."""
    got, want = call()
    assert got.size > 0, label
    assert np.array_equal(got.view(np.int64), want.view(np.int64)), label
    assert any(float(np.float32(d)) != d for d in got if d != 0), label


@pytest.mark.parametrize("label,call", A14_2B, ids=[c[0] for c in A14_2B])
def test_entry_points_of_a14_2b_run_in_float64(label, call, x64,
                                               monkeypatch):
    """Each of the 16 calls on a tiny non-empty stream in the float64
    mode: it runs and returns results; every float array it returns is
    float64 (and its distances hold a value no float32 holds), and every
    coordinate lane it made is float64 (``TAggregateQuery.run`` makes
    none: its spans are integers, which no coordinate reaches)."""
    lanes = _lanes_spy(monkeypatch)
    results, floats = call()
    assert len(results) > 0, label
    assert all(a.dtype == np.float64 for a in floats), label
    values = [v for a in floats for v in np.ravel(a)
              if v != 0 and np.isfinite(v) and label != "tjoin_pane_init"]
    if values:
        assert any(float(np.float32(v)) != v for v in values), label
    assert all(dt == np.float64 for dt in lanes), (label, lanes)
    assert lanes or floats or label == "TAggregateQuery.run", label


@pytest.mark.parametrize("label,call", A14_2A, ids=[c[0] for c in A14_2A])
def test_entry_points_of_the_slice_run_in_float64(label, call, x64):
    """Each call ported by A14.2a, on a tiny non-empty stream in the
    float64 mode: it runs, and its distances are float64 (an array's
    dtype; for Python floats, some non-zero distance that no float32
    holds)."""
    out = call()
    if isinstance(out, np.ndarray):
        assert out.dtype == np.float64 and out.size > 0, label
    else:
        nonzero = [d for d in out if d != 0]
        assert nonzero, label
        assert any(float(np.float32(d)) != d for d in nonzero), label


def test_they_run_as_before_with_x64_off(monkeypatch):
    """All 65 calls, x64 off: none raises (an empty stream, no windows),
    apart from the ones that need their real arguments; and the 16 of
    A14.2b on their tiny streams compute in float32, as before."""
    needs_args = ("QServeOperator.serve_window", "PointPointRangeQuery."
                  "run_partitioned", "traj_stats_sliding (tStats panes)",
                  "tjoin_pane_init")
    ran = 0
    for label, call in A14_2_CALLS:
        if label in needs_args:
            continue
        out = call()
        assert out == [] or out is None, label
        ran += 1
    assert ran > 60
    lanes = _lanes_spy(monkeypatch)
    for label, call in A14_2B:
        call()
    assert lanes and all(dt == np.float32 for dt in lanes)
