"""Parity of the PyTorch port's point-stream kNN ``run`` with the JAX
package, for point, polygon and linestring queries.

The same ``Point`` objects, made with numpy from a seed, go through the
JAX operator and the port's; the port runs on the CPU, where B4's wrapper
takes its plain PyTorch version. The JAX operators are called with
``dtype=np.float32`` (the test configuration turns x64 on), so they
centre in float64 and cast, as the port always does.

Contracts held, per window: starts, ends and window counts exact; the
same objIDs in the same order with the same representative events;
distances within 1 ulp for point queries and within ``LINE_ATOL`` for
polygon and linestring queries (the JAX jitted point→segment distance
contracts multiply-adds, ROADMAP Queue C), and exactly 0 inside a polygon
query. The data keep every point more than ``LINE_ATOL`` from the radius
and every two objects' minima more than ``LINE_ATOL`` apart, outside the
case of exactly equal distances (each case asserts it), so neither the
in-radius sets nor the order can flip on that rounding. Equal distances
go to the lowest segment first. ``k`` above a window's bucketed segment
count raises ``ValueError`` in the window where the JAX ``run`` raises,
and ``run_wire_panes`` raises before its first pane.
"""

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
from spatialflink_tpu.streams.wire import WireFormat as JWireFormat

from spatialflink_tpu_torch.grid import UniformGrid
from spatialflink_tpu_torch.models.objects import LineString, Point, Polygon
from spatialflink_tpu_torch.operators import (
    PointLineStringKNNQuery,
    PointPointKNNQuery,
    PointPolygonKNNQuery,
    QueryConfiguration,
    QueryType,
)
from spatialflink_tpu_torch.operators.base import center_coords
from spatialflink_tpu_torch.ops import knn as tknn
from spatialflink_tpu_torch.ops.distances import pairwise_distance
from spatialflink_tpu_torch.ops.polygon import point_polygon_distance
from spatialflink_tpu_torch.ops.distances import point_polyline_distance
from spatialflink_tpu_torch.state import interner_from_jax
from spatialflink_tpu_torch.streams.wire import WireFormat

GRID16 = dict(num_partitions=16, min_x=115.5, max_x=117.6, min_y=39.6,
              max_y=41.1)
QXY = (116.40, 40.19)
R = 0.03
LINE_ATOL = 2 * float(np.spacing(np.float32(1.05)))
#: A star-shaped polygon query about ``QXY``; its outline, opened, is the
#: linestring query.
QRING = np.array(QXY) + 0.01 * np.array(
    [[1.0, 0.0], [0.4, 0.9], [-0.8, 0.6], [-1.0, -0.3], [-0.2, -1.0],
     [0.7, -0.7], [1.0, 0.0]])

OPS = {"point": (PointPointKNNQuery, JPointKnn),
       "polygon": (PointPolygonKNNQuery, JPolyKnn),
       "linestring": (PointLineStringKNNQuery, JLineKnn)}


def _query(kind):
    if kind == "point":
        return Point(obj_id="q", x=QXY[0], y=QXY[1]), \
            JPoint(obj_id="q", x=QXY[0], y=QXY[1])
    if kind == "polygon":
        return Polygon(obj_id="q", rings=[QRING]), \
            JPolygon(obj_id="q", rings=[QRING])
    return LineString(obj_id="q", coords=QRING[:-1]), \
        JLineString(obj_id="q", coords=QRING[:-1])


def _ops(kind, conf_kw):
    jconf = dict(conf_kw)
    if "query_type" in jconf:
        jconf["query_type"] = JQT[jconf["query_type"].name]
    port_cls, j_cls = OPS[kind]
    return (port_cls(QueryConfiguration(**conf_kw), UniformGrid(**GRID16),
                     device="cpu"),
            j_cls(JConf(**jconf), JGrid(**GRID16)))


def _xy(rng, n):
    """Points about the query, a fifth of them inside the polygon."""
    xy = np.array(QXY) + rng.normal(0, 0.02, (n, 2))
    xy[::5] = np.array(QXY) + rng.uniform(-0.004, 0.004, (len(xy[::5]), 2))
    return xy


def _points(xy, per_sec, n_ids=61):
    ts = (np.arange(len(xy), dtype=np.int64) * 1000) // per_sec
    return ([Point(obj_id=f"o{i % n_ids}", timestamp=int(t), x=x, y=y)
             for i, (t, (x, y)) in enumerate(zip(ts, xy))],
            [JPoint(obj_id=f"o{i % n_ids}", timestamp=int(t), x=x, y=y)
             for i, (t, (x, y)) in enumerate(zip(ts, xy))])


def _port_dists(kind, xy, approx=False):
    """Every point's distance to the query, as the port computes it."""
    g = UniformGrid(**GRID16)
    p = torch.from_numpy(center_coords(g, xy))
    if kind == "point":
        return pairwise_distance(p, torch.from_numpy(
            center_coords(g, [QXY]))).numpy()[:, 0]
    ring = QRING
    if approx and kind == "polygon":
        (x0, y0), (x1, y1) = QRING.min(axis=0), QRING.max(axis=0)
        ring = np.array([[x0, y0], [x1, y0], [x1, y1], [x0, y1], [x0, y0]])
    v = torch.from_numpy(center_coords(g, ring if kind == "polygon"
                                       else ring[:-1]))
    ev = torch.ones(v.shape[0] - 1, dtype=torch.bool)
    if kind == "polygon":
        return point_polygon_distance(p, v, ev).numpy()
    return point_polyline_distance(p, v, ev).numpy()


def _assert_margin(kind, xy, approx=False):
    """No point within ``LINE_ATOL`` of the radius."""
    d = _port_dists(kind, xy, approx).astype(np.float64)
    assert np.all(np.abs(d - np.float32(R)) > LINE_ATOL)


def _same_windows(got, want, atol, ties=False):
    """Window for window equal; unless ``ties``, the reference's minima
    of a window more than ``atol`` apart, where they are not 0 (so the
    order cannot flip on the rounding ``atol`` allows)."""
    assert len(got) == len(want) and got
    for g, w in zip(got, want):
        assert (g.start, g.end, g.window_count) == (w.start, w.end,
                                                    w.window_count)
        assert [n[0] for n in g.neighbors] == [n[0] for n in w.neighbors]
        assert [(n[2].obj_id, n[2].timestamp, n[2].x, n[2].y)
                for n in g.neighbors] == \
            [(n[2].obj_id, n[2].timestamp, n[2].x, n[2].y)
             for n in w.neighbors]
        dg = np.array([n[1] for n in g.neighbors], np.float32)
        dw = np.array([n[1] for n in w.neighbors], np.float32)
        assert np.array_equal(dg == 0, dw == 0)
        ulp = np.spacing(np.maximum(np.abs(dg), np.abs(dw)))
        assert np.all(np.abs(dg - dw) <= np.maximum(ulp, atol))
        if not ties:
            assert np.all(np.diff(dw[dw > 0]) > atol)
    return sum(len(g.neighbors) for g in got)


RUN_CASES = [
    ("point", dict(query_type=QueryType.WindowBased, window_size=1.0,
                   slide_step=0.5), 10),
    ("polygon", dict(query_type=QueryType.WindowBased, window_size=1.0,
                     slide_step=0.5), 10),
    ("linestring", dict(query_type=QueryType.WindowBased, window_size=1.0,
                        slide_step=1.0), 10),
    ("polygon", dict(query_type=QueryType.RealTime, realtime_batch_ms=250),
     5),
    ("linestring", dict(query_type=QueryType.CountBased,
                        count_window_size=150), 10),
    ("point", dict(query_type=QueryType.CountBased, count_window_size=150),
     10),
    ("polygon", dict(query_type=QueryType.WindowBased, window_size=1.0,
                     slide_step=1.0, approximate_query=True), 10),
    ("linestring", dict(query_type=QueryType.WindowBased, window_size=1.0,
                        slide_step=1.0, approximate_query=True), 10),
    ("polygon", dict(query_type=QueryType.WindowBased, window_size=1.0,
                     slide_step=1.0), 64),
]


@pytest.mark.parametrize("kind,conf_kw,k", RUN_CASES,
                         ids=[f"{kd}-{i}" for i, (kd, _, _) in
                              enumerate(RUN_CASES)])
def test_run_matches_jax(kind, conf_kw, k):
    """Sliding, RealTime and CountBased windows; approximate mode (the
    polygon's closed bbox ring; a linestring unchanged); ``k`` = 64 above
    the 61 objects of the stream (fewer results than ``k``)."""
    rng = np.random.default_rng(31)
    xy = _xy(rng, 600)
    approx = conf_kw.get("approximate_query", False)
    _assert_margin(kind, xy, approx)
    op, jop = _ops(kind, conf_kw)
    q, jq = _query(kind)
    pts, jpts = _points(xy, 200)
    got = list(op.run(iter(pts), q, R, k))
    want = list(jop.run(iter(jpts), jq, R, k, dtype=np.float32))
    atol = 0.0 if kind == "point" else LINE_ATOL
    assert _same_windows(got, want, atol) > 0
    full = [len(g.neighbors) == k for g in got]
    assert any(full) == (k < 61)
    if kind == "polygon" and not approx:
        assert any(n[1] == 0 for g in got for n in g.neighbors)


def test_approximate_modes_follow_the_reference():
    """As tests/test_approximate.py:240 and :265 hold for the JAX package:
    an approximate polygon query ranks by the distance to the query's
    bbox (0 inside it); an approximate linestring query equals the exact
    one."""
    rng = np.random.default_rng(32)
    xy = np.array(QXY) + rng.normal(0, 0.02, (300, 2))
    pts, _ = _points(xy, 300)
    conf = dict(window_size=1.0, slide_step=1.0)
    poly, _ = _ops("polygon", dict(conf, approximate_query=True))
    (res,) = list(poly.run(iter(pts), _query("polygon")[0], R, 64))
    (x0, y0), (x1, y1) = QRING.min(axis=0), QRING.max(axis=0)
    best = {}
    for p in pts:
        d = np.hypot(max(x0 - p.x, 0, p.x - x1), max(y0 - p.y, 0, p.y - y1))
        if d <= R:
            best[p.obj_id] = min(best.get(p.obj_id, np.inf), d)
    expect = sorted(best.values())
    assert len(res.neighbors) == len(expect) and expect[0] == 0 < expect[-1]
    for (o, dg, _), de in zip(res.neighbors, expect):
        assert dg == pytest.approx(de, abs=1e-6)
        assert dg == pytest.approx(best[o], abs=1e-6)
    exact, _ = _ops("linestring", conf)
    approx, _ = _ops("linestring", dict(conf, approximate_query=True))
    q = _query("linestring")[0]
    assert [[(o, d) for o, d, _ in r.neighbors]
            for r in exact.run(iter(pts), q, R, 20)] == \
        [[(o, d) for o, d, _ in r.neighbors]
         for r in approx.run(iter(pts), q, R, 20)]


def test_linestring_query_has_no_phantom_containment():
    """As tests/test_operators.py:249: a point 'enclosed' by an open
    linestring is at its edge distance, not 0."""
    conf = dict(window_size=30.0, slide_step=30.0)
    grid = dict(num_partitions=20, min_x=0.0, max_x=10.0, min_y=0.0,
                max_y=10.0)
    ls = np.array([[0, 0], [4, 0], [0, 4]], float)
    pts = [Point(obj_id="inside", timestamp=100, x=1.0, y=1.0),
           Point(obj_id="near", timestamp=200, x=4.1, y=0.0),
           Point(obj_id="push", timestamp=40_000, x=9.9, y=9.9)]
    op = PointLineStringKNNQuery(QueryConfiguration(**conf),
                                 UniformGrid(**grid), device="cpu")
    first = next(op.run(iter(pts), LineString(coords=ls), 5.0, 2))
    assert [n[0] for n in first.neighbors] == ["near", "inside"]
    assert first.neighbors[0][1] == pytest.approx(0.1, abs=1e-6)
    assert first.neighbors[1][1] > 0.9
    jop = JLineKnn(JConf(**conf), JGrid(**grid))
    jpts = [JPoint(obj_id=p.obj_id, timestamp=p.timestamp, x=p.x, y=p.y)
            for p in pts]
    want = next(jop.run(iter(jpts), JLineString(coords=ls), 5.0, 2,
                        dtype=np.float32))
    _same_windows([first], [want], LINE_ATOL)


@pytest.mark.parametrize("kind", ["point", "polygon"])
def test_equal_distances_lowest_segment_first(kind):
    """Objects at exactly equal distances (the same coordinates) come out
    lowest segment first, in both packages, whatever their arrival
    order; the point query's brute-force oracle of
    tests/test_operators.py:132 agrees."""
    rng = np.random.default_rng(33)
    spots = np.array(QXY) + np.array([[0.012, 0.003], [-0.006, 0.014],
                                      [0.0, -0.02]])
    xy = spots[rng.integers(0, 3, 240)]
    _assert_margin(kind, xy)
    ids = rng.permutation(240) % 40
    ts = np.arange(240) * 4
    pts = [Point(obj_id=f"o{i}", timestamp=int(t), x=x, y=y)
           for i, t, (x, y) in zip(ids, ts, xy)]
    jpts = [JPoint(obj_id=f"o{i}", timestamp=int(t), x=x, y=y)
            for i, t, (x, y) in zip(ids, ts, xy)]
    conf = dict(window_size=1.0, slide_step=1.0)
    op, jop = _ops(kind, conf)
    q, jq = _query(kind)
    got = list(op.run(iter(pts), q, R, 25))
    want = list(jop.run(iter(jpts), jq, R, 25, dtype=np.float32))
    _same_windows(got, want, LINE_ATOL, ties=True)
    for res in got:
        d = [n[1] for n in res.neighbors]
        segs = [op.interner._to_int[n[0]] for n in res.neighbors]
        assert d == sorted(d)
        for a in range(len(d) - 1):
            if d[a] == d[a + 1]:
                assert segs[a] < segs[a + 1]
        assert len(set(d)) < len(d)
    if kind == "point":
        for res in got:
            best = {}
            for p in pts:
                if res.start <= p.timestamp < res.end:
                    dd = float(np.hypot(p.x - QXY[0], p.y - QXY[1]))
                    if dd <= R:
                        best[p.obj_id] = min(best.get(p.obj_id, np.inf), dd)
            assert {n[0] for n in res.neighbors} <= set(best)
            assert len(res.neighbors) == min(25, len(best))


@pytest.mark.parametrize("kind", ["point", "linestring"])
def test_k_above_segments_raises_in_the_same_window(kind):
    """C1: with fewer than 64 objIDs interned the bucketed segment count
    is 64, so k = 100 raises ``ValueError`` in the first window of both
    packages; with 70 objIDs (128 segments) it does not."""
    rng = np.random.default_rng(34)
    xy = _xy(rng, 400)
    conf = dict(window_size=1.0, slide_step=1.0)
    q, jq = _query(kind)
    for n_ids, raises in ((30, True), (70, False)):
        pts, jpts = _points(xy, 200, n_ids=n_ids)
        op, jop = _ops(kind, conf)
        got, want = op.run(iter(pts), q, R, 100), \
            jop.run(iter(jpts), jq, R, 100, dtype=np.float32)
        if raises:
            with pytest.raises(ValueError, match="k"):
                next(got)
            with pytest.raises(ValueError, match="k"):
                next(want)
        else:
            _same_windows(list(got), list(want), LINE_ATOL, ties=True)
    with pytest.raises(ValueError):
        tknn._finish_topk(torch.zeros(64), torch.zeros(64, dtype=torch.int32),
                          100)


def test_run_wire_panes_raises_at_entry_for_k_above_segments():
    """C1: ``run_wire_panes`` raises before it takes a pane, where the
    JAX operator raises too."""
    bj = dict(num_partitions=100, min_x=115.5, max_x=117.6, min_y=39.6,
              max_y=41.1)
    wf = WireFormat.for_grid(UniformGrid(**bj))
    rng = np.random.default_rng(35)
    xy = np.array(QXY) + rng.normal(0, 0.01, (500, 2))
    pane = np.ascontiguousarray(np.concatenate(
        [wf.quantize(xy), rng.integers(0, 64, (500, 1)).astype(np.uint16)],
        axis=1).T)
    taken = []

    def slides():
        taken.append(1)
        yield pane

    conf = dict(window_size=1.0, slide_step=1.0)
    op = PointPointKNNQuery(QueryConfiguration(**conf), UniformGrid(**bj),
                            device="cpu")
    with pytest.raises(ValueError, match="k"):
        next(op.run_wire_panes(slides(), Point(x=QXY[0], y=QXY[1]), 0.05,
                               100, 64, wf))
    assert not taken
    jop = JPointKnn(JConf(**conf), JGrid(**bj))
    with pytest.raises(ValueError):
        list(jop.run_wire_panes([pane], JPoint(x=QXY[0], y=QXY[1]), 0.05,
                                100, 64, JWireFormat.for_grid(JGrid(**bj))))
    got = list(op.run_wire_panes([pane], Point(x=QXY[0], y=QXY[1]), 0.05,
                                 64, 64, wf))
    assert len(got) == 1 and got[0][4] > 0


def test_unported_options_raise():
    conf = QueryConfiguration()
    g = UniformGrid(**GRID16)
    with pytest.raises(NotImplementedError, match="A12"):
        PointPolygonKNNQuery(conf, g, device="cpu", mesh=object())
    op = PointLineStringKNNQuery(conf, g, device="cpu")
    q = _query("linestring")[0]
    with pytest.raises(NotImplementedError, match="A11"):
        next(op.run(iter([]), q, R, 5, driver=object()))
    with pytest.raises(NotImplementedError, match="A12"):
        next(op.run(iter([]), q, R, 5, mesh=object()))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            PointPolygonKNNQuery(conf, g)


def test_interner_from_jax_round_trips():
    """A port operator given the JAX operator's interner maps every objID
    to the JAX segment, so a stream continued on the port ties as the JAX
    operator's continuation does."""
    rng = np.random.default_rng(36)
    xy = _xy(rng, 600)
    pts, jpts = _points(xy[::-1].copy(), 200)
    conf = dict(window_size=1.0, slide_step=1.0)
    op, jop = _ops("polygon", conf)
    q, jq = _query("polygon")
    head = list(jop.run(iter(jpts[:300]), jq, R, 10, dtype=np.float32))
    assert head
    op.interner = interner_from_jax(jop)
    assert op.interner._to_key == jop.interner._to_key
    assert all(op.interner.intern(k) == jop.interner._to_int[k]
               for k in jop.interner._to_key)
    assert interner_from_jax(jop.interner)._to_key == jop.interner._to_key
    got = list(op.run(iter(pts[300:]), q, R, 10))
    want = list(jop.run(iter(jpts[300:]), jq, R, 10, dtype=np.float32))
    _same_windows(got, want, LINE_ATOL, ties=True)
