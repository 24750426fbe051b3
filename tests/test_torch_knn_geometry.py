"""Parity of the PyTorch port's geometry-stream kNN with the JAX package.

The same inputs, made with numpy from a seed, go through the JAX function
and its port counterpart; the port runs on the CPU, where B4's wrapper
takes its plain PyTorch version. The JAX operators are called with
``dtype=np.float32`` (the test configuration turns x64 on), so they
centre in float64 and cast, as the port always does.

Contracts held:
- ``_centered_bbox`` (``pad`` True and False): bit-equal;
  ``bbox_bbox_min_distance``: bit-equal to the JAX function run eagerly,
  within 1 ulp of it jitted (XLA:CPU contracts ``dx * dx + dy * dy``
  into an FMA), so approximate mode too holds distances to
  ``LINE_ATOL``;
- ``knn_geometry_query_kernel``, ``knn_geometry_bbox_kernel`` and the six
  classes' ``run_soa`` and ``run``, exact and approximate: the same
  objIDs in the same order, the same representatives and ``num_valid``;
  distances within ``LINE_ATOL``, since the JAX jitted point→segment
  distance contracts multiply-adds (ROADMAP Queue C, "Linestring
  distances"), and exactly 0 where containment decides. The data keep
  every object's distance more than ``LINE_ATOL`` from the radius and
  every two reported non-zero minima more than ``LINE_ATOL`` apart (each
  case asserts both), so neither the in-radius set nor the order can
  flip on that rounding; equal distances (0 on overlap) go to the lowest
  segment first in both;
- the reference's value where edges cross with no vertex inside (ROADMAP
  C2), through the kNN kernel: the X of two open linestrings at 1.0, the
  plus of two rectangles at 1.5;
- ``k`` above the segment count raises ``ValueError`` in the same window
  as the JAX operator.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spatialflink_tpu import operators as jops
from spatialflink_tpu.grid import UniformGrid as JGrid
from spatialflink_tpu.models.objects import LineString as JLineString
from spatialflink_tpu.models.objects import Point as JPoint
from spatialflink_tpu.models.objects import Polygon as JPolygon
from spatialflink_tpu.operators import QueryConfiguration as JConf
from spatialflink_tpu.operators import QueryType as JQT
from spatialflink_tpu.operators.join_query import _centered_bbox as j_cbbox
from spatialflink_tpu.ops import distances as jd
from spatialflink_tpu.ops import knn as jknn

from spatialflink_tpu_torch import operators as tops
from spatialflink_tpu_torch.grid import UniformGrid
from spatialflink_tpu_torch.models import batch as tbatch
from spatialflink_tpu_torch.models.objects import LineString, Point, Polygon
from spatialflink_tpu_torch.operators import QueryConfiguration, QueryType
from spatialflink_tpu_torch.operators.base import center_coords
from spatialflink_tpu_torch.operators.join_query import _centered_bbox
from spatialflink_tpu_torch.ops import distances as td
from spatialflink_tpu_torch.ops import knn as tknn
from spatialflink_tpu_torch.ops import range as tr
from spatialflink_tpu_torch.ops.polygon import pack_polyline, pack_rings

# The Beijing extent on a 16 x 16 grid (cells of 0.13 deg).
GRID16 = dict(num_partitions=16, min_x=115.5, max_x=117.6, min_y=39.6,
              max_y=41.1)
CENTRE = np.array([116.55, 40.35])
R = 0.02
K = 10
NSEG = 64
#: As tests/test_torch_range.py:122: two coordinate ulps of the centred
#: float32 values (below 1.05 on this extent), the FMA freedom of the
#: JAX jitted point→segment distance.
LINE_ATOL = 2 * float(np.spacing(np.float32(1.05)))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _ring(rng, centre, r_max, m):
    """A closed star-shaped ring of ``m`` distinct vertices."""
    ang = np.sort(rng.uniform(0, 2 * np.pi, m))
    rad = rng.uniform(0.3, 1.0, m) * r_max
    ring = centre + np.stack([rad * np.cos(ang), rad * np.sin(ang)], axis=1)
    return np.concatenate([ring, ring[:1]])


def _object_rings(rng, n, spread=0.05):
    """``n`` rings of 4-11 distinct vertices, radii up to 0.006 deg,
    centred within ``spread`` of the query centre."""
    return [_ring(rng, CENTRE + rng.uniform(-spread, spread, 2), 0.006,
                  int(rng.integers(4, 12))) for _ in range(n)]


def _query(kind, rng):
    """(port, JAX) query objects of ``kind`` about the centre."""
    if kind == "point":
        x, y = CENTRE + rng.uniform(-0.003, 0.003, 2)
        return Point(obj_id="q", x=x, y=y), JPoint(obj_id="q", x=x, y=y)
    ring = _ring(rng, CENTRE, 0.012, 7)
    if kind == "polygon":
        return (Polygon(obj_id="q", rings=[ring]),
                JPolygon(obj_id="q", rings=[ring]))
    return (LineString(obj_id="q", coords=ring[:-1]),
            JLineString(obj_id="q", coords=ring[:-1]))


def _objects(rings, polygonal, per_sec, holes=False, n_ids=61):
    """(port, JAX) object streams, ``per_sec`` objects a second, objIDs
    over ``n_ids`` objects. ``holes``: every third polygon gets a hole."""
    port, jax_ = [], []
    for i, ring in enumerate(rings):
        meta = dict(obj_id=f"g{i % n_ids}", timestamp=(i * 1000) // per_sec)
        if polygonal:
            rs = [ring]
            if holes and i % 3 == 0:
                c = ring[:-1].mean(axis=0)
                rs.append(c + 0.3 * (ring - c))
            port.append(Polygon(rings=rs, **meta))
            jax_.append(JPolygon(rings=rs, **meta))
        else:
            port.append(LineString(coords=ring[:-1], **meta))
            jax_.append(JLineString(coords=ring[:-1], **meta))
    return port, jax_


def _ragged_chunks(objs, n_chunks=4, edges=False):
    """Objects → ragged SoA chunks of their packed chains, dense oids;
    ``edges`` adds the flat edge masks."""
    rows = [(o.timestamp, int(o.obj_id[1:]), *o.packed()) for o in objs]
    bounds = np.linspace(0, len(rows), n_chunks + 1).astype(int)
    out = []
    for a, b in zip(bounds[:-1], bounds[1:]):
        part = rows[a:b]
        chunk = {
            "ts": np.array([r[0] for r in part], np.int64),
            "oid": np.array([r[1] for r in part], np.int32),
            "lengths": np.array([len(r[2]) for r in part], np.int64),
            "verts": np.concatenate([r[2] for r in part]),
        }
        if edges:
            chunk["edge_valid"] = np.concatenate([r[3] for r in part])
        out.append(chunk)
    return out


def _assert_margin(dist, valid):
    """No object within ``LINE_ATOL`` of the radius."""
    d = np.asarray(dist, np.float64)[np.asarray(valid)]
    assert np.all(np.abs(d - np.float32(R)) > LINE_ATOL)


def _assert_same_topk(got_d, want_d):
    """Distances of one window's top-k: 0 exactly where the reference is
    0, the rest within ``LINE_ATOL``, and the reference's non-zero minima
    more than ``LINE_ATOL`` apart."""
    g = np.asarray(got_d, np.float32)
    w = np.asarray(want_d, np.float32)
    assert g.shape == w.shape
    assert np.array_equal(g == 0, w == 0)
    assert np.all(np.abs(g.astype(np.float64) - w) <= LINE_ATOL)
    assert np.all(np.diff(w[w > 0].astype(np.float64)) > LINE_ATOL)


def _stream_dists(op, objs, query):
    """Every object's exact distance to the query, as the port computes
    it (for the margin assertions)."""
    batch = tbatch.GeometryBatch.from_objects(objs)
    qv, qe, qpoly = op._query_arrays(query)
    d = tr.geometry_pair_distance(
        _t(center_coords(op.grid, batch.verts)), _t(batch.edge_valid),
        _t(center_coords(op.grid, qv))[None], _t(qe)[None],
        op.stream_polygonal, qpoly)[:, 0]
    return d.numpy(), batch.valid


# ---------------------------------------------------------------------------
# The distance helpers


def test_bbox_bbox_min_distance_matches_jax():
    """Disjoint, touching, overlapping and degenerate (point) boxes at
    float32: bit-equal to the JAX function run eagerly, and within 1 ulp
    of it jitted, where XLA:CPU contracts ``dx * dx + dy * dy`` into
    ``fma(dx, dx, dy * dy)`` (35 of these 500 lanes differ by 1 ulp)."""
    rng = np.random.default_rng(41)
    lo = rng.uniform(-1, 1, (500, 2))
    a = np.concatenate([lo, lo + rng.uniform(0, 0.3, (500, 2))], axis=1)
    lo = rng.uniform(-1, 1, (500, 2))
    b = np.concatenate([lo, lo + rng.uniform(0, 0.3, (500, 2))], axis=1)
    b[:50, 2:] = b[:50, :2]  # point boxes
    b[50:60] = a[50:60]  # identical boxes
    b[60:70, 0] = a[60:70, 2]  # touching in x
    a, b = a.astype(np.float32), b.astype(np.float32)
    got = td.bbox_bbox_min_distance(_t(a), _t(b)).numpy()
    eager = np.asarray(jd.bbox_bbox_min_distance(jnp.asarray(a),
                                                 jnp.asarray(b)))
    jitted = np.asarray(jax.jit(jd.bbox_bbox_min_distance)(jnp.asarray(a),
                                                           jnp.asarray(b)))
    assert got.dtype == eager.dtype == jitted.dtype == np.float32
    assert np.array_equal(got.view(np.uint32), eager.view(np.uint32))
    assert np.all(np.abs(got.view(np.int32) - jitted.view(np.int32)) <= 1)
    assert np.all(got[50:60] == 0) and (got > 0).sum() > 300


@pytest.mark.parametrize("pad", [True, False])
def test_centered_bbox_matches_jax(pad):
    """Padded outward by one float32 ulp a corner, or not at all."""
    rng = np.random.default_rng(42)
    lo = CENTRE + rng.uniform(-1, 1, (200, 2))
    bb = np.concatenate([lo, lo + rng.uniform(0, 0.02, (200, 2))], axis=1)
    g, jg = UniformGrid(**GRID16), JGrid(**GRID16)
    got = _centered_bbox(g, bb, np.float32, pad=pad)
    want = j_cbbox(jg, bb, np.float32, pad=pad)
    assert got.dtype == want.dtype == np.float32
    assert np.array_equal(got, want)
    plain = np.concatenate([center_coords(g, bb[:, :2]),
                            center_coords(g, bb[:, 2:])], axis=1)
    if pad:
        assert np.all(got[:, :2] < plain[:, :2])
        assert np.all(got[:, 2:] > plain[:, 2:])
    else:
        assert np.array_equal(got, plain)


# ---------------------------------------------------------------------------
# The window kernels


KERNEL_CASES = [(p, q) for p in (True, False)
                for q in ("point", "polygon", "linestring")]


def _kernel_inputs(obj_polygonal, query_kind, seed):
    rng = np.random.default_rng(seed)
    q, _ = _query(query_kind, rng)
    objs, _ = _objects(_object_rings(rng, 200), obj_polygonal, 10,
                       holes=True)
    g = UniformGrid(**GRID16)
    cls = tops.PolygonPointKNNQuery if obj_polygonal \
        else tops.LineStringPointKNNQuery
    op = cls(QueryConfiguration(), g, device="cpu")
    qverts, qev, qpoly = op._query_arrays(q)
    batch = tbatch.GeometryBatch.from_objects(objs)
    flags = batch.any_cell_flagged(g, g.neighbor_flags(R, q.grid_cells(g)))
    oid = batch.oid.copy()
    oid[batch.valid] = np.arange(batch.valid.sum()) % 61
    return op, q, objs, batch, flags, oid, qverts, qev, qpoly


@pytest.mark.parametrize("obj_polygonal,query_kind", KERNEL_CASES)
def test_knn_geometry_query_kernel_matches_jax(obj_polygonal, query_kind):
    op, q, objs, batch, flags, oid, qverts, qev, qpoly = _kernel_inputs(
        obj_polygonal, query_kind, 43)
    g = op.grid
    args = (center_coords(g, batch.verts), batch.edge_valid, batch.valid,
            flags, oid, center_coords(g, qverts), qev)
    statics = dict(k=K, num_segments=NSEG, obj_polygonal=obj_polygonal,
                   query_polygonal=qpoly)
    got = tknn.knn_geometry_query_kernel(*map(_t, args), R, **statics)
    jk = jax.jit(jknn.knn_geometry_query_kernel,
                 static_argnames=tuple(statics))
    want = jk(*map(jnp.asarray, args), R, **statics)
    _assert_margin(*_stream_dists(op, objs, q))
    nv = int(want.num_valid)
    assert int(got.num_valid) == nv and 0 < nv
    assert np.array_equal(got.segment.numpy(), np.asarray(want.segment))
    assert np.array_equal(got.index.numpy(), np.asarray(want.index))
    _assert_same_topk(got.dist.numpy()[:nv], np.asarray(want.dist)[:nv])
    if qpoly:
        assert float(got.dist[0]) == 0.0


@pytest.mark.parametrize("query_kind", ["point", "polygon", "linestring"])
def test_knn_geometry_bbox_kernel_matches_jax(query_kind):
    """Approximate mode: unpadded centred boxes on both sides."""
    op, q, objs, batch, flags, oid, *_ = _kernel_inputs(True, query_kind, 44)
    g, jg = op.grid, JGrid(**GRID16)
    bb = _centered_bbox(g, batch.bbox, pad=False)
    qbb = _centered_bbox(g, np.asarray([q.bbox()]), pad=False)[0]
    assert np.array_equal(qbb, j_cbbox(jg, np.asarray([q.bbox()]),
                                       np.float32, pad=False)[0])
    assert np.array_equal(op._device_query_bbox(q).numpy(), qbb)
    args = (bb, batch.valid, flags, oid, qbb)
    got = tknn.knn_geometry_bbox_kernel(*map(_t, args), R, K, NSEG)
    jk = jax.jit(jknn.knn_geometry_bbox_kernel,
                 static_argnames=("k", "num_segments"))
    want = jk(*map(jnp.asarray, args), R, k=K, num_segments=NSEG)
    d = td.bbox_bbox_min_distance(_t(bb), _t(qbb)[None]).numpy()
    _assert_margin(d, batch.valid)
    nv = int(want.num_valid)
    assert int(got.num_valid) == nv and 0 < nv
    assert np.array_equal(got.segment.numpy(), np.asarray(want.segment))
    assert np.array_equal(got.index.numpy(), np.asarray(want.index))
    _assert_same_topk(got.dist.numpy()[:nv], np.asarray(want.dist)[:nv])


def test_c2_crossing_geometries_keep_the_reference_value():
    """ROADMAP C2 through the kNN kernel: edges that cross with no vertex
    inside the other give the vertex distances, not JTS's 0, in both
    packages."""
    x1 = pack_polyline([np.array([[-1, 0], [1, 0.0]])], pad_to=8)
    x2 = pack_polyline([np.array([[0, -1], [0, 1.0]])], pad_to=8)
    r1 = pack_rings([np.array([[-2, -.5], [2, -.5], [2, .5], [-2, .5]])],
                    pad_to=8)
    r2 = pack_rings([np.array([[-.5, -2], [.5, -2], [.5, 2], [-.5, 2]])],
                    pad_to=8)
    for a, b, poly, want in ((x1, x2, False, 1.0), (r1, r2, True, 1.5)):
        args = (a[0][None].astype(np.float32), a[1][None], np.ones(1, bool),
                np.ones(1, np.uint8), np.zeros(1, np.int32),
                b[0].astype(np.float32), b[1])
        statics = dict(k=1, num_segments=NSEG, obj_polygonal=poly,
                       query_polygonal=poly)
        got = tknn.knn_geometry_query_kernel(*map(_t, args), 2.0, **statics)
        ref = jax.jit(jknn.knn_geometry_query_kernel,
                      static_argnames=tuple(statics))(
            *map(jnp.asarray, args), 2.0, **statics)
        assert float(got.dist[0]) == float(ref.dist[0]) == want
        assert int(got.segment[0]) == int(ref.segment[0]) == 0


# ---------------------------------------------------------------------------
# Operators

CLASSES = {
    ("polygon", "point"): "PolygonPointKNNQuery",
    ("polygon", "polygon"): "PolygonPolygonKNNQuery",
    ("polygon", "linestring"): "PolygonLineStringKNNQuery",
    ("linestring", "point"): "LineStringPointKNNQuery",
    ("linestring", "polygon"): "LineStringPolygonKNNQuery",
    ("linestring", "linestring"): "LineStringLineStringKNNQuery",
}


def _ops(stream_kind, query_kind, conf_kw):
    name = CLASSES[(stream_kind, query_kind)]
    jconf = dict(conf_kw)
    if "query_type" in jconf:
        jconf["query_type"] = JQT[jconf["query_type"].name]
    op = getattr(tops, name)(QueryConfiguration(**conf_kw),
                             UniformGrid(**GRID16), device="cpu")
    jop = getattr(jops, name)(JConf(**jconf), JGrid(**GRID16))
    return op, jop


SOA_CASES = [(s, q, False, False) for (s, q) in CLASSES] + [
    ("polygon", "polygon", True, False), ("linestring", "point", True, False),
    ("polygon", "linestring", True, False),
    ("polygon", "point", False, True)]


@pytest.mark.parametrize("stream_kind,query_kind,approx,multi_ring",
                         SOA_CASES)
def test_run_soa_matches_jax(stream_kind, query_kind, approx, multi_ring):
    """Each class's ``run_soa`` on ragged chunks (a multi-ring stream
    carries its edge masks), exact and approximate: the same windows,
    objIDs in order and ``num_valid``; distances as the module states."""
    rng = np.random.default_rng(53)
    op, jop = _ops(stream_kind, query_kind,
                   dict(window_size=1.0, slide_step=1.0,
                        approximate_query=approx))
    q, jq = _query(query_kind, rng)
    objs, _ = _objects(_object_rings(rng, 300), stream_kind == "polygon",
                       100, holes=multi_ring)
    chunks = _ragged_chunks(objs, n_chunks=5, edges=multi_ring)
    got = list(op.run_soa(chunks, q, R, K, NSEG))
    want = list(jop.run_soa(chunks, jq, R, K, NSEG, dtype=np.float32))
    assert len(got) == len(want) == 3
    full = 0
    for g, w in zip(got, want):
        assert (g[0], g[1], g[4]) == (w[0], w[1], w[4])
        assert np.array_equal(g[2], w[2])
        _assert_same_topk(g[3], w[3])
        full += g[4] == K
    assert full > 0
    if approx:
        batch = tbatch.GeometryBatch.from_objects(objs)
        d = td.bbox_bbox_min_distance(
            _t(_centered_bbox(op.grid, batch.bbox, pad=False)),
            op._device_query_bbox(q)[None]).numpy()
        _assert_margin(d, batch.valid)
    else:
        _assert_margin(*_stream_dists(op, objs, q))


RUN_CASES = [
    ("polygon", "point", dict(query_type=QueryType.WindowBased,
                              window_size=1.0, slide_step=0.5)),
    ("polygon", "polygon", dict(query_type=QueryType.RealTime,
                                realtime_batch_ms=500)),
    ("polygon", "linestring", dict(query_type=QueryType.CountBased,
                                   count_window_size=70)),
    ("linestring", "point", dict(query_type=QueryType.CountBased,
                                 count_window_size=70)),
    ("linestring", "polygon", dict(query_type=QueryType.WindowBased,
                                   window_size=1.0, slide_step=0.5)),
    ("linestring", "linestring", dict(query_type=QueryType.RealTime,
                                      realtime_batch_ms=500)),
    ("polygon", "polygon", dict(query_type=QueryType.WindowBased,
                                window_size=1.0, slide_step=1.0,
                                approximate_query=True)),
    ("linestring", "point", dict(query_type=QueryType.WindowBased,
                                 window_size=1.0, slide_step=1.0,
                                 approximate_query=True)),
]


@pytest.mark.parametrize("stream_kind,query_kind,conf_kw", RUN_CASES,
                         ids=[f"{s}-{q}-{i}" for i, (s, q, _) in
                              enumerate(RUN_CASES)])
def test_run_matches_jax(stream_kind, query_kind, conf_kw):
    """``run`` on ``Polygon`` and ``LineString`` objects: sliding,
    RealTime and CountBased windows, exact and approximate; the same
    spans and window counts, objIDs and representative objects in order,
    distances as the module states."""
    rng = np.random.default_rng(46)
    op, jop = _ops(stream_kind, query_kind, conf_kw)
    q, jq = _query(query_kind, rng)
    objs, jobjs = _objects(_object_rings(rng, 200),
                           stream_kind == "polygon", 100, holes=True)
    got = list(op.run(iter(objs), q, R, K))
    want = list(jop.run(iter(jobjs), jq, R, K, dtype=np.float32))
    assert len(got) == len(want) >= 2
    approx = conf_kw.get("approximate_query", False)
    found = 0
    for g, w in zip(got, want):
        assert (g.start, g.end, g.window_count) == (w.start, w.end,
                                                    w.window_count)
        assert [n[0] for n in g.neighbors] == [n[0] for n in w.neighbors]
        assert [(n[2].obj_id, n[2].timestamp) for n in g.neighbors] == \
            [(n[2].obj_id, n[2].timestamp) for n in w.neighbors]
        _assert_same_topk([n[1] for n in g.neighbors],
                          [n[1] for n in w.neighbors])
        found += len(g.neighbors)
    assert found > 0
    if not approx:
        _assert_margin(*_stream_dists(op, objs, q))


@pytest.mark.parametrize("stream_kind", ["polygon", "linestring"])
def test_k_above_segments_raises_in_the_same_window(stream_kind):
    """C1: with fewer than 64 objIDs interned the bucketed segment count
    is 64, so k = 100 raises ``ValueError`` in the first window of both
    packages' ``run``; with 70 objIDs (128 segments) it does not.
    ``run_soa`` raises with ``num_segments`` 64 in both."""
    rng = np.random.default_rng(47)
    conf = dict(window_size=1.0, slide_step=1.0)
    rings = _object_rings(rng, 200)
    for n_ids, raises in ((30, True), (70, False)):
        op, jop = _ops(stream_kind, "polygon", conf)
        q, jq = _query("polygon", np.random.default_rng(48))
        objs, jobjs = _objects(rings, stream_kind == "polygon", 100,
                               n_ids=n_ids)
        got = op.run(iter(objs), q, R, 100)
        want = jop.run(iter(jobjs), jq, R, 100, dtype=np.float32)
        if raises:
            with pytest.raises(ValueError, match="k"):
                next(got)
            with pytest.raises(ValueError, match="k"):
                next(want)
        else:
            g, w = list(got), list(want)
            assert len(g) == len(w) == 2
            for a, b in zip(g, w):
                assert [n[0] for n in a.neighbors] == \
                    [n[0] for n in b.neighbors]
    objs, _ = _objects(rings, stream_kind == "polygon", 100, n_ids=30)
    chunks = _ragged_chunks(objs, n_chunks=2)
    op, jop = _ops(stream_kind, "point", conf)
    q, jq = _query("point", np.random.default_rng(49))
    with pytest.raises(ValueError, match="k"):
        next(op.run_soa(chunks, q, R, 100, NSEG))
    with pytest.raises(ValueError):
        next(jop.run_soa(chunks, jq, R, 100, NSEG, dtype=np.float32))


def test_unported_options_raise():
    conf = QueryConfiguration()
    g = UniformGrid(**GRID16)
    with pytest.raises(NotImplementedError, match="A12"):
        tops.PolygonPolygonKNNQuery(conf, g, device="cpu", mesh=object())
    op = tops.LineStringPolygonKNNQuery(conf, g, device="cpu")
    q, _ = _query("polygon", np.random.default_rng(50))
    with pytest.raises(NotImplementedError, match="A12"):
        next(op.run(iter([]), q, R, 5, mesh=object()))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            tops.PolygonPointKNNQuery(conf, g)
