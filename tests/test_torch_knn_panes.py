"""Parity of the PyTorch port's pane-carry and SoA kNN paths with the JAX
package: ``query_panes``, ``PointPointKNNQuery.run_soa``,
``run_soa_panes`` and ``run_multi``, the pane digests and their merge,
and ``state.pane_carry_from_jax``.

The same inputs, made with numpy from a seed, go through the JAX function
and its port counterpart; the port runs on the CPU, where B4's wrapper
takes its plain PyTorch version. The JAX operators are called with
``dtype=np.float32`` (the test configuration turns x64 on), so they
centre in float64 and cast, as the port always does.

Contracts held:
- against the JAX package: the same windows, objIDs in order,
  representatives and ``num_valid``; point distances within 1 ulp (the
  JAX jitted distance contracts ``dx * dx + dy * dy`` into an FMA, the
  ``digests_agree`` rule), polygon and linestring distances within
  ``LINE_ATOL`` (ROADMAP Queue C, "Linestring distances") and exactly 0
  inside a polygon query. The data keep every point more than
  ``LINE_ATOL`` from the radius and every two reported minima of a
  window more than ``LINE_ATOL`` apart (each case asserts it), so neither
  the in-radius set nor the order can flip on that rounding;
- within the port: ``query_panes`` equals ``run`` and ``run_soa_panes``
  equals ``run_soa`` bit for bit, and every ``run_multi`` query equals
  ``run`` with that query alone; the compact digests are the scatter
  digests, bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spatialflink_tpu.grid import UniformGrid as JGrid
from spatialflink_tpu.models.objects import LineString as JLineString
from spatialflink_tpu.models.objects import Point as JPoint
from spatialflink_tpu.models.objects import Polygon as JPolygon
from spatialflink_tpu.operators import PointLineStringKNNQuery as JLineKnn
from spatialflink_tpu.operators import PointPointKNNQuery as JPointKnn
from spatialflink_tpu.operators import PointPolygonKNNQuery as JPolyKnn
from spatialflink_tpu.operators import QueryConfiguration as JConf
from spatialflink_tpu.operators import QueryType as JQT
from spatialflink_tpu.ops import knn as jknn

from spatialflink_tpu_torch.grid import UniformGrid
from spatialflink_tpu_torch.models.objects import LineString, Point, Polygon
from spatialflink_tpu_torch.operators import (
    MultiKnnWindowResult,
    PointLineStringKNNQuery,
    PointPointKNNQuery,
    PointPolygonKNNQuery,
    QueryConfiguration,
    QueryType,
)
from spatialflink_tpu_torch.operators.base import center_coords
from spatialflink_tpu_torch.ops import knn as tknn
from spatialflink_tpu_torch.ops.distances import (
    pairwise_distance,
    point_polyline_distance,
)
from spatialflink_tpu_torch.ops.polygon import point_polygon_distance
from spatialflink_tpu_torch.state import interner_from_jax, pane_carry_from_jax

GRID16 = dict(num_partitions=16, min_x=115.5, max_x=117.6, min_y=39.6,
              max_y=41.1)
QXY = (116.40, 40.19)
R = 0.03
NSEG = 64
LINE_ATOL = 2 * float(np.spacing(np.float32(1.05)))
#: A star-shaped polygon query about ``QXY``; its outline, opened, is the
#: linestring query.
QRING = np.array(QXY) + 0.01 * np.array(
    [[1.0, 0.0], [0.4, 0.9], [-0.8, 0.6], [-1.0, -0.3], [-0.2, -1.0],
     [0.7, -0.7], [1.0, 0.0]])

OPS = {"point": (PointPointKNNQuery, JPointKnn),
       "polygon": (PointPolygonKNNQuery, JPolyKnn),
       "linestring": (PointLineStringKNNQuery, JLineKnn)}


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _query(kind):
    if kind == "point":
        return Point(obj_id="q", x=QXY[0], y=QXY[1]), \
            JPoint(obj_id="q", x=QXY[0], y=QXY[1])
    if kind == "polygon":
        return Polygon(obj_id="q", rings=[QRING]), \
            JPolygon(obj_id="q", rings=[QRING])
    return LineString(obj_id="q", coords=QRING[:-1]), \
        JLineString(obj_id="q", coords=QRING[:-1])


def _conf(conf_kw):
    jconf = dict(conf_kw)
    if "query_type" in jconf:
        jconf["query_type"] = JQT[jconf["query_type"].name]
    return QueryConfiguration(**conf_kw), JConf(**jconf)


def _ops(kind, conf_kw):
    conf, jconf = _conf(conf_kw)
    port_cls, j_cls = OPS[kind]
    return (port_cls(conf, UniformGrid(**GRID16), device="cpu"),
            j_cls(jconf, JGrid(**GRID16)))


def _xy(rng, n):
    """Points about the query, a fifth of them inside the polygon."""
    xy = np.array(QXY) + rng.normal(0, 0.02, (n, 2))
    xy[::5] = np.array(QXY) + rng.uniform(-0.004, 0.004, (len(xy[::5]), 2))
    return xy


def _points(xy, per_sec, ids=None, t0=0):
    """(port, JAX) ``Point`` streams; objIDs ``o{ids[i]}`` (61 objects by
    default)."""
    if ids is None:
        ids = np.arange(len(xy)) % 61
    ts = t0 + (np.arange(len(xy), dtype=np.int64) * 1000) // per_sec
    return ([Point(obj_id=f"o{i}", timestamp=int(t), x=x, y=y)
             for i, t, (x, y) in zip(ids, ts, xy)],
            [JPoint(obj_id=f"o{i}", timestamp=int(t), x=x, y=y)
             for i, t, (x, y) in zip(ids, ts, xy)])


def _port_dists(kind, xy, approx=False):
    """Every point's distance to the query, as the port computes it."""
    g = UniformGrid(**GRID16)
    p = _t(center_coords(g, xy))
    if kind == "point":
        return pairwise_distance(p, _t(center_coords(g, [QXY]))).numpy()[:, 0]
    ring = QRING
    if approx and kind == "polygon":
        (x0, y0), (x1, y1) = QRING.min(axis=0), QRING.max(axis=0)
        ring = np.array([[x0, y0], [x1, y0], [x1, y1], [x0, y1], [x0, y0]])
    v = _t(center_coords(g, ring if kind == "polygon" else ring[:-1]))
    ev = torch.ones(v.shape[0] - 1, dtype=torch.bool)
    if kind == "polygon":
        return point_polygon_distance(p, v, ev).numpy()
    return point_polyline_distance(p, v, ev).numpy()


def _assert_margin(kind, xy, approx=False):
    """No point within ``LINE_ATOL`` of the radius."""
    d = _port_dists(kind, xy, approx).astype(np.float64)
    assert np.all(np.abs(d - np.float32(R)) > LINE_ATOL)


def _key(n):
    ev = n[2]
    return (n[0], ev.obj_id, ev.timestamp, ev.x, ev.y)


def _same_windows(got, want, atol, counts=True):
    """Window for window: spans (and window counts), objIDs and
    representative events in order; distances within ``max(1 ulp,
    atol)``, 0 exactly where the reference is 0, and the reference's
    non-zero minima more than ``atol`` apart (so the order is decided).
    Returns the number of neighbours compared."""
    assert len(got) == len(want) and got
    for g, w in zip(got, want):
        assert (g.start, g.end) == (w.start, w.end)
        if counts:
            assert g.window_count == w.window_count
        assert [_key(n) for n in g.neighbors] == [_key(n) for n in w.neighbors]
        dg = np.array([n[1] for n in g.neighbors], np.float32)
        dw = np.array([n[1] for n in w.neighbors], np.float32)
        assert np.array_equal(dg == 0, dw == 0)
        ulp = np.spacing(np.maximum(np.abs(dg), np.abs(dw)))
        assert np.all(np.abs(dg - dw) <= np.maximum(ulp, atol))
        assert np.all(np.diff(dw[dw > 0].astype(np.float64)) > atol)
    return sum(len(g.neighbors) for g in got)


def _identical(got, want):
    """Bit-equal windows of one package: distances as floats, and the very
    same representative objects."""
    assert len(got) == len(want) and got
    for g, w in zip(got, want):
        assert (g.start, g.end, g.window_count) == (w.start, w.end,
                                                    w.window_count)
        assert [(n[0], n[1]) for n in g.neighbors] == \
            [(n[0], n[1]) for n in w.neighbors]
        assert all(a[2] is b[2] for a, b in zip(g.neighbors, w.neighbors))


def _atol(kind):
    return 0.0 if kind == "point" else LINE_ATOL


# ---------------------------------------------------------------------------
# Digests and their merge


def test_merge_digests_with_bases_matches_jax():
    """Pane-local representatives offset by window bases; the sentinel
    stays at int32 max; the lowest window-local index wins a tie across
    panes."""
    rng = np.random.default_rng(61)
    big = np.finfo(np.float32).max
    sm = rng.choice(np.float32([0.1, 0.2, 0.25, big]), (4, NSEG))
    rp = np.where(sm < big, rng.integers(0, 500, (4, NSEG)),
                  np.iinfo(np.int32).max).astype(np.int32)
    bases = np.array([0, 500, 1100, 1300], np.int32)
    for k in (10, NSEG):
        got = tknn.knn_merge_digest_list(list(_t(sm)), list(_t(rp)), bases, k)
        want = jknn.knn_merge_digests(jnp.asarray(sm), jnp.asarray(rp), k,
                                      bases=jnp.asarray(bases))
        for a, b in zip(got, want):
            assert np.array_equal(a.numpy(), np.asarray(b))
        assert np.array_equal(
            tknn.knn_merge_digests(_t(sm), _t(rp), k, bases=_t(bases)).index,
            got.index)
    live = got.index[got.index >= 0].numpy()
    assert live.max() >= 1100 and live.min() < 500
    none = tknn.knn_merge_digest_list(list(_t(sm)), list(_t(rp)), None, 10)
    zero = tknn.knn_merge_digest_list(list(_t(sm)), list(_t(rp)),
                                      np.zeros(4, np.int32), 10)
    for a, b in zip(none, zero):
        assert torch.equal(a, b)


DIGEST_CASES = [("point", "auto"), ("point", "topk"), ("point", "blocked"),
                ("polygon", "topk"), ("linestring", "auto")]


@pytest.mark.parametrize("kind,selection", DIGEST_CASES)
def test_compact_digest_is_the_scatter_digest(kind, selection):
    """The port's compact digests equal its scatter digests bit for bit,
    with and without the flag gather, and agree with the JAX compact
    digest (cand 64 below the pane, so the JAX side compacts) by
    ``digests_agree``, within ``LINE_ATOL`` for the geometry queries."""
    rng = np.random.default_rng(62)
    g, jg = UniformGrid(**GRID16), JGrid(**GRID16)
    xy = _xy(rng, 700)
    _assert_margin(kind, xy)
    q, _ = _query(kind)
    flags = g.neighbor_flags(R, q.grid_cells(g))
    cell = g.assign_cells_np(xy)
    oid = rng.integers(0, NSEG, 700).astype(np.int32)
    valid = rng.random(700) > 0.1
    base = np.int32(17)
    xy_c = center_coords(g, xy)
    if kind == "point":
        qa = (center_coords(g, [QXY])[0],)
        scatter, compact = tknn.knn_pane_digest, tknn.knn_pane_digest_compact
        jcompact = jknn.knn_pane_digest_compact
        statics = {}
    else:
        ring = QRING if kind == "polygon" else QRING[:-1]
        qa = (center_coords(g, ring), np.ones(len(ring) - 1, bool))
        scatter = tknn.knn_pane_digest_geometry
        compact = tknn.knn_pane_digest_geometry_compact
        jcompact = jknn.knn_pane_digest_geometry_compact
        statics = dict(query_polygonal=kind == "polygon")
    args = (xy_c, valid, cell, flags, oid)
    ref = scatter(*map(_t, args), *map(_t, qa), R, base, NSEG, **statics)
    got = compact(*map(_t, args), *map(_t, qa), R, base, NSEG,
                  selection=selection, **statics)
    for a, b in zip(got, ref):
        assert torch.equal(a, b)
    in_grid = valid & (cell < g.num_cells)
    noflag = compact(_t(xy_c), _t(in_grid), None, None, _t(oid),
                     *map(_t, qa), R, base, NSEG, selection=selection,
                     **statics)
    for a, b in zip(noflag, ref):
        assert torch.equal(a, b)
    assert (ref.seg_min < tknn.F32_BIG).sum() > 10
    assert int(ref.rep[ref.rep < tknn.I32_BIG].min()) >= base
    jk = jax.jit(jcompact, static_argnames=("num_segments", "cand",
                                            "selection", *statics))
    want = jk(*map(jnp.asarray, args), *map(jnp.asarray, qa), R, base,
              num_segments=NSEG, cand=64, selection="topk", **statics)
    sa, sb = got.seg_min.numpy(), np.asarray(want.seg_min)
    assert np.array_equal(sa < tknn.F32_BIG, sb < np.finfo(np.float32).max)
    live = sa < tknn.F32_BIG
    tol = np.maximum(np.spacing(np.abs(sb[live])), _atol(kind))
    assert np.all(np.abs(sa[live] - sb[live]) <= tol)
    exact = live & (sa == sb)
    assert np.array_equal(got.rep.numpy()[exact], np.asarray(want.rep)[exact])
    with pytest.raises(ValueError, match="selection"):
        compact(*map(_t, args), *map(_t, qa), R, base, NSEG,
                selection="sorted", **statics)
    with pytest.raises(ValueError, match="selection"):
        jk(*map(jnp.asarray, args), *map(jnp.asarray, qa), R, base,
           num_segments=NSEG, cand=64, selection="sorted", **statics)


# ---------------------------------------------------------------------------
# query_panes


PANE_CASES = [
    ("point", dict(window_size=1.0, slide_step=0.5)),
    ("polygon", dict(window_size=2.0, slide_step=0.5)),
    ("linestring", dict(window_size=1.0, slide_step=1.0)),
    ("polygon", dict(window_size=1.0, slide_step=0.5,
                     approximate_query=True)),
    ("point", dict(query_type=QueryType.RealTime, realtime_batch_ms=250)),
]


@pytest.mark.parametrize("kind,conf_kw", PANE_CASES,
                         ids=[f"{kd}-{i}" for i, (kd, _) in
                              enumerate(PANE_CASES)])
def test_query_panes_matches_jax_and_run(kind, conf_kw):
    """Point, polygon, linestring and approximate polygon queries, sliding
    and RealTime windows: equal to the JAX ``query_panes`` and, bit for
    bit with the same representative objects, to the port's ``run``."""
    rng = np.random.default_rng(63)
    xy = _xy(rng, 700)
    approx = conf_kw.get("approximate_query", False)
    _assert_margin(kind, xy, approx)
    pts, jpts = _points(xy, 200)
    q, jq = _query(kind)
    op, jop = _ops(kind, conf_kw)
    got = list(op.query_panes(iter(pts), q, R, 10))
    want = list(jop.query_panes(iter(jpts), jq, R, 10, dtype=np.float32))
    assert _same_windows(got, want, _atol(kind)) > 0
    run_op, _ = _ops(kind, conf_kw)
    _identical(got, list(run_op.run(iter(pts), q, R, 10)))
    assert any(len(w.neighbors) == 10 for w in got)
    assert op.checkpoint_assembler is not None


def test_query_panes_with_empty_panes():
    """A gap in the stream leaves whole panes empty (None in the carry);
    merged windows still equal the JAX package and ``run``."""
    rng = np.random.default_rng(64)
    xy = _xy(rng, 300)
    _assert_margin("point", xy)
    head, jhead = _points(xy[:150], 50)
    tail, jtail = _points(xy[150:], 50, t0=9_000)
    conf = dict(window_size=4.0, slide_step=1.0)
    op, jop = _ops("point", conf)
    q, jq = _query("point")
    got, empty_merged = [], 0
    for w in op.query_panes(iter(head + tail), q, R, 8):
        got.append(w)
        live = [op._pane_carry[ps] for ps in range(w.start, w.end, 1000)]
        empty_merged += any(p is None for p in live) and bool(w.neighbors)
    want = list(jop.query_panes(iter(jhead + jtail), jq, R, 8,
                                dtype=np.float32))
    _same_windows(got, want, 0.0)
    run_op, _ = _ops("point", conf)
    _identical(got, list(run_op.run(iter(head + tail), q, R, 8)))
    assert empty_merged >= 4
    assert all(d < 1.0 for w in got for _, d, _ in w.neighbors)


def test_query_panes_regrows_digests_when_ids_pass_64():
    """The interned objIDs pass 64 in mid-stream: digests made at 64
    segments are re-padded to 128 before the merge, and windows straddling
    the growth equal the JAX package and ``run``."""
    rng = np.random.default_rng(65)
    xy = _xy(rng, 800)
    _assert_margin("polygon", xy)
    ids = np.where(np.arange(800) < 400, np.arange(800) % 40,
                   np.arange(800) % 100)
    pts, jpts = _points(xy, 200, ids=ids)
    conf = dict(window_size=2.0, slide_step=1.0)
    op, jop = _ops("polygon", conf)
    q, jq = _query("polygon")
    got, first_nseg, grown = [], {}, set()
    for w in op.query_panes(iter(pts), q, R, 60):
        got.append(w)
        for ps, e in op._pane_carry.items():
            if e is not None:
                first_nseg.setdefault(ps, e[0])
                if e[0] != first_nseg[ps]:
                    grown.add((ps, first_nseg[ps], e[0]))
    want = list(jop.query_panes(iter(jpts), jq, R, 60, dtype=np.float32))
    _same_windows(got, want, LINE_ATOL)
    run_op, _ = _ops("polygon", conf)
    _identical(got, list(run_op.run(iter(pts), q, R, 60)))
    assert op.interner.num_segments == 100
    assert grown == {(1000, 64, 128)}
    ids_seen = {int(n[0][1:]) for w in got for n in w.neighbors}
    assert max(ids_seen) >= 64 and min(ids_seen) < 40


def test_query_panes_excludes_out_of_extent_points():
    """As tests/test_operators.py:406: points outside the grid extent lie
    within the radius of a query near the edge, but their cell's flag is
    0, so neither ``run`` nor ``query_panes`` reports them."""
    grid = dict(num_partitions=20, min_x=0.0, max_x=10.0, min_y=0.0,
                max_y=10.0)
    rng = np.random.default_rng(66)
    inside = np.stack([rng.uniform(8, 10, 200), rng.uniform(3, 7, 200)], 1)
    outside = np.stack([10.2 + 0.01 * np.arange(20), np.full(20, 5.0)], 1)
    xy = np.concatenate([inside, outside])
    ts = np.concatenate([np.arange(200) * 50, np.arange(20) * 400])
    order = np.argsort(ts, kind="stable")
    names = [f"d{i % 7}" for i in range(200)] + [f"out{i}" for i in range(20)]
    pts = [Point(obj_id=names[i], timestamp=int(ts[i]), x=xy[i, 0],
                 y=xy[i, 1]) for i in order]
    jpts = [JPoint(obj_id=names[i], timestamp=int(ts[i]), x=xy[i, 0],
                   y=xy[i, 1]) for i in order]
    conf = QueryConfiguration(window_size=10.0, slide_step=5.0)
    jconf = JConf(window_size=10.0, slide_step=5.0)
    q, jq = Point(x=9.9, y=5.0), JPoint(x=9.9, y=5.0)
    op = PointPointKNNQuery(conf, UniformGrid(**grid), device="cpu")
    got = list(op.query_panes(iter(pts), q, 2.0, 8))
    want = list(JPointKnn(jconf, JGrid(**grid)).query_panes(
        iter(jpts), jq, 2.0, 8, dtype=np.float32))
    assert len(got) == len(want) and got
    for g, w in zip(got, want):
        assert [n[0] for n in g.neighbors] == [n[0] for n in w.neighbors]
    run = list(PointPointKNNQuery(conf, UniformGrid(**grid),
                                  device="cpu").run(iter(pts), q, 2.0, 8))
    _identical(got, run)
    assert not any(n[0].startswith("out") for w in got for n in w.neighbors)
    assert any(w.neighbors for w in got)


PANE_ERRORS = [
    dict(window_size=1.0, slide_step=0.5, allowed_lateness=0.2),
    dict(query_type=QueryType.CountBased, count_window_size=50),
    dict(window_size=1.0, slide_step=0.3),
]


@pytest.mark.parametrize("conf_kw", PANE_ERRORS,
                         ids=["lateness", "count_based", "size_mod_slide"])
def test_query_panes_rejects_what_the_reference_rejects(conf_kw):
    op, jop = _ops("point", conf_kw)
    q, jq = _query("point")
    pts, jpts = _points(_xy(np.random.default_rng(67), 50), 100)
    with pytest.raises(ValueError) as e:
        next(op.query_panes(iter(pts), q, R, 5))
    with pytest.raises(ValueError) as je:
        next(jop.query_panes(iter(jpts), jq, R, 5, dtype=np.float32))
    assert str(e.value) == str(je.value)


# ---------------------------------------------------------------------------
# run_soa, run_soa_panes


def _soa_chunks(rng, n, per_sec, n_chunks=6, narrow=False):
    xy = _xy(rng, n)
    ts = (np.arange(n, dtype=np.int64) * 1000) // per_sec
    oid = rng.integers(0, NSEG, n).astype(np.uint16 if narrow else np.int32)
    bounds = np.linspace(0, n, n_chunks + 1).astype(int)
    return xy, [{"ts": ts[a:b], "x": xy[a:b, 0], "y": xy[a:b, 1],
                 "oid": oid[a:b]} for a, b in zip(bounds[:-1], bounds[1:])]


def _same_soa(got, want, exact):
    assert len(got) == len(want) and got
    for g, w in zip(got, want):
        assert (g[0], g[1], g[4]) == (w[0], w[1], w[4])
        assert np.array_equal(g[2], w[2])
        if exact:
            assert np.array_equal(g[3].view(np.uint32), w[3].view(np.uint32))
        else:
            ulp = np.spacing(np.maximum(np.abs(g[3]), np.abs(w[3])))
            assert np.all(np.abs(g[3] - w[3]) <= ulp)
            assert np.all(np.diff(w[3].astype(np.float64)) > 0)
    return sum(g[4] for g in got)


SOA_CASES = [dict(window_size=1.0, slide_step=0.5),
             dict(window_size=2.0, slide_step=0.5),
             dict(window_size=1.0, slide_step=1.0)]


@pytest.mark.parametrize("conf_kw", SOA_CASES, ids=["1s-0.5s", "2s-0.5s",
                                                    "1s-1s"])
@pytest.mark.parametrize("narrow", [False, True], ids=["int32", "uint16"])
def test_run_soa_and_run_soa_panes_match_jax(conf_kw, narrow):
    """``run_soa`` and ``run_soa_panes`` equal the JAX package's (1 ulp);
    the port's ``run_soa_panes`` equals its ``run_soa`` bit for bit (the
    same windows, leading and trailing partials included). ``uint16``
    oids are widened on the host."""
    rng = np.random.default_rng(68)
    xy, chunks = _soa_chunks(rng, 900, 300, narrow=narrow)
    _assert_margin("point", xy)
    op, jop = _ops("point", conf_kw)
    q, jq = _query("point")
    soa = list(op.run_soa(chunks, q, R, 10, NSEG))
    jsoa = list(jop.run_soa(chunks, jq, R, 10, NSEG, dtype=np.float32))
    assert _same_soa(soa, jsoa, exact=False) > 0
    pane_op, _ = _ops("point", conf_kw)
    panes = list(pane_op.run_soa_panes(chunks, q, R, 10, NSEG))
    jpanes = list(jop.run_soa_panes(chunks, jq, R, 10, NSEG,
                                    dtype=np.float32))
    _same_soa(panes, soa, exact=True)
    _same_soa(panes, jpanes, exact=False)
    assert pane_op.checkpoint_soa_assembler is not None
    assert any(w[4] == 10 for w in soa)


def test_run_soa_errors_match_jax():
    """An oid at ``num_segments`` raises in both; so does ``k`` above it
    (in the first window); ``run_soa_panes`` rejects lateness and
    ``size % slide != 0`` as the JAX operator does."""
    rng = np.random.default_rng(69)
    _, chunks = _soa_chunks(rng, 300, 300)
    q, jq = _query("point")
    op, jop = _ops("point", dict(window_size=1.0, slide_step=0.5))
    bad = [dict(c, oid=c["oid"].copy()) for c in chunks]
    bad[0]["oid"][3] = NSEG
    with pytest.raises(ValueError, match="num_segments"):
        next(op.run_soa(bad, q, R, 10, NSEG))
    with pytest.raises(ValueError, match="num_segments"):
        next(jop.run_soa(bad, jq, R, 10, NSEG, dtype=np.float32))
    with pytest.raises(ValueError, match="k"):
        next(op.run_soa(chunks, q, R, 100, NSEG))
    with pytest.raises(ValueError):
        next(jop.run_soa(chunks, jq, R, 100, NSEG, dtype=np.float32))
    for kw in (dict(window_size=1.0, slide_step=0.5, allowed_lateness=0.1),
               dict(window_size=1.0, slide_step=0.3)):
        op, jop = _ops("point", kw)
        with pytest.raises(ValueError) as e:
            next(op.run_soa_panes(chunks, q, R, 10, NSEG))
        with pytest.raises(ValueError) as je:
            next(jop.run_soa_panes(chunks, jq, R, 10, NSEG, dtype=np.float32))
        assert str(e.value) == str(je.value)


# ---------------------------------------------------------------------------
# run_multi


def _multi_queries(rng, n):
    """``n`` query points: most about ``QXY``, the last in a far corner of
    the extent (an empty result)."""
    qxy = np.array(QXY) + rng.uniform(-0.03, 0.03, (n, 2))
    qxy[-1] = (117.55, 41.05)
    return ([Point(obj_id=f"q{i}", x=x, y=y) for i, (x, y) in enumerate(qxy)],
            [JPoint(obj_id=f"q{i}", x=x, y=y)
             for i, (x, y) in enumerate(qxy)], qxy)


@pytest.mark.parametrize("nq", [5, 11, 40], ids=["pad8", "pad16",
                                                 "two_blocks"])
def test_run_multi_matches_run_and_jax(nq):
    """Each query of ``run_multi`` equals ``run`` with that query alone
    (bit for bit, the same representative objects) and the JAX
    ``run_multi`` (1 ulp); the batch pads to 8, 16 and 64 queries (the
    last in two blocks of 32)."""
    rng = np.random.default_rng(70 + nq)
    xy = _xy(rng, 500)
    qs, jqs, qxy = _multi_queries(rng, nq)
    g = UniformGrid(**GRID16)
    d = pairwise_distance(_t(center_coords(g, xy)),
                          _t(center_coords(g, qxy))).numpy()
    # Point distances agree within 1 ulp: keep every pair 2 ulps of the
    # radius away from it.
    margin = 2 * float(np.spacing(np.float32(R)))
    assert np.all(np.abs(d.astype(np.float64) - np.float32(R)) > margin)
    pts, jpts = _points(xy, 250)
    conf = dict(window_size=1.0, slide_step=0.5)
    op, jop = _ops("point", conf)
    got = list(op.run_multi(iter(pts), qs, R, 6))
    want = list(jop.run_multi(iter(jpts), jqs, R, 6, dtype=np.float32))
    assert len(got) == len(want) == 5
    assert all(isinstance(m, MultiKnnWindowResult) for m in got)
    for m, jm in zip(got, want):
        assert (m.start, m.end, m.window_count) == (jm.start, jm.end,
                                                    jm.window_count)
        assert len(m.results) == nq
        _same_windows(m.results, jm.results, 0.0)
        assert not m.results[-1].neighbors
    for qi, q in enumerate(qs):
        one, _ = _ops("point", conf)
        _identical([m.results[qi] for m in got],
                   list(one.run(iter(pts), q, R, 6)))
    assert sum(len(r.neighbors) for m in got for r in m.results) > nq


def test_multi_query_kernel_rejects_a_partial_block():
    """Q not a multiple of ``query_block`` raises in both packages."""
    xy = np.zeros((16, 2), np.float32)
    args = (xy, np.ones(16, bool), np.zeros(16, np.int32),
            np.ones((12, 257), np.uint8), np.zeros(16, np.int32),
            np.zeros((12, 2), np.float32))
    with pytest.raises(ValueError, match="query_block"):
        tknn.knn_multi_query_kernel(*map(_t, args), R, 4, NSEG,
                                    query_block=8)
    with pytest.raises(ValueError, match="query_block"):
        jknn.knn_multi_query_kernel(*map(jnp.asarray, args), R, 4, NSEG,
                                    query_block=8)
    res = tknn.knn_multi_query_kernel(*map(_t, args), R, 4, NSEG,
                                      query_block=4)
    assert res.dist.shape == (12, 4) and res.num_valid.shape == (12,)


# ---------------------------------------------------------------------------
# State carried across


def test_pane_carry_from_jax_continues_the_jax_windows():
    """A JAX ``query_panes`` run cut at 3.2 s with ``flush_at_end=False``
    leaves its open windows' digests in ``_pane_carry``. Moved to a port
    operator with the interner, the carry is reused: fed the stream from
    the earliest open window's start, the port yields the windows the JAX
    run would have yielded (equal to the uncut JAX run), and their
    representatives from the carried panes are the carried objects."""
    rng = np.random.default_rng(75)
    xy = _xy(rng, 1000)
    _assert_margin("polygon", xy)
    pts, jpts = _points(xy, 200)
    conf = dict(window_size=2.0, slide_step=1.0)
    q, jq = _query("polygon")
    _, full_op = _ops("polygon", conf)
    full = list(full_op.query_panes(iter(jpts), jq, R, 10, dtype=np.float32))
    _, jop = _ops("polygon", conf)
    head = list(jop.query_panes(iter([p for p in jpts if p.timestamp < 3200]),
                                jq, R, 10, dtype=np.float32,
                                flush_at_end=False))
    assert [w.end for w in head] == [1000, 2000, 3000]
    assert sorted(jop._pane_carry) == [1000, 2000]
    op, _ = _ops("polygon", conf)
    op.interner = interner_from_jax(jop)
    op._pane_carry, soa = pane_carry_from_jax(jop, device="cpu")
    assert soa is None
    carried = {id(ev) for ev in op._pane_carry[2000][3]}
    nseg, sm, rp, evs = op._pane_carry[1000]
    assert nseg == jop._pane_carry[1000][0] and len(evs) == 200
    assert np.array_equal(sm.numpy(), np.asarray(jop._pane_carry[1000][1]))
    assert np.array_equal(rp.numpy(), np.asarray(jop._pane_carry[1000][2]))
    got = list(op.query_panes(iter([p for p in pts if p.timestamp >= 2000]),
                              q, R, 10))
    # The re-fired [1000, 3000) window: the JAX head emitted it already;
    # its neighbours come from the two carried panes.
    assert (got[0].start, got[0].end) == (1000, 3000)
    _same_windows(got[:1], [head[-1]], LINE_ATOL, counts=False)
    tail = [w for w in full if w.start >= 2000]
    _same_windows(got[1:], tail, LINE_ATOL)
    _same_windows(head, full[:3], 0.0)
    assert any(id(n[2]) in carried for n in got[1].neighbors)
