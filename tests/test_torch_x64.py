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
- every entry point of the slice (the point-stream range's three classes
  through ``run`` in every window mode and ``run_soa``, and
  ``query_incremental``; point-stream kNN ``run`` for point, polygon and
  linestring queries and ``run_soa``; ``PointPointJoinQuery.run`` and
  ``run_soa``) equals its JAX counterpart on random data: windows,
  matched ids and counts exact, distances float64 and within 1 float64
  ulp (``ULPS``), or within ``GEOM_ATOL`` for polygon and linestring
  distances (the jitted JAX point→segment distance may contract a
  multiply-add, which moves the closest point by up to a coordinate
  ulp);
- B4's and B3's plain float64 versions against the JAX functions run
  eagerly (op by op, so nothing is contracted): bit for bit, including
  ``finfo(float64).max`` for a boundary with no valid edge;
- the numpy failover twins compute in float64 as the device path does;
- x64 off, or ``dtype=np.float32``: today's float32 results, bit for
  bit;
- x64 on: every entry point outside the slice raises
  ``NotImplementedError`` naming ROADMAP item A14.2;
- the switch itself, and the telemetry ledger's ``x64`` field.
"""

from collections import Counter, defaultdict

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_join as TJ
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
# x64 on: every entry point outside the slice raises, naming A14.2


def _a14_2_calls():
    """(label, call) of every entry point whose float64 route is ROADMAP
    item A14.2, each called as a user would (streams empty: the refusal
    comes first)."""
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


A14_2 = _a14_2_calls()


@pytest.mark.parametrize("label,call", A14_2, ids=[c[0] for c in A14_2])
def test_entry_points_outside_the_slice_raise_in_float64(label, call, x64):
    with pytest.raises(NotImplementedError, match=r"A14\.2"):
        call()


def test_they_run_as_before_with_x64_off():
    """The same calls, x64 off: none raises (an empty stream, no
    windows), apart from the two that need their real arguments."""
    needs_args = ("QServeOperator.serve_window", "PointPointRangeQuery."
                  "run_partitioned", "traj_stats_sliding (tStats panes)",
                  "tjoin_pane_init")
    ran = 0
    for label, call in A14_2:
        if label in needs_args:
            continue
        out = call()
        assert out == [] or out is None, label
        ran += 1
    assert ran > 60
