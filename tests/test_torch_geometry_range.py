"""Parity of the PyTorch port's geometry-stream range queries with the JAX
package.

The same inputs, made with numpy from a seed, go through the JAX function
and its port counterpart; the port runs on the CPU, where B4's wrapper
takes its plain PyTorch version. The JAX operators are called with
``dtype=np.float32`` (the test configuration turns x64 on), so they
centre in float64 and cast, as the port always does.

Contracts held:
- ``GeometryBatch`` (``from_ragged`` with and without a multi-ring edge
  mask, ``from_objects``, ``centroid_cells``), ``flag_prefix_planes`` and
  ``any_cell_flagged``: array-equal;
- ``RaggedSoaWindowAssembler``: the same windows (spans, rows, chains,
  edge masks), the same late drops and the same errors;
- ``geometry_pair_distance``, ``geometry_range_query_kernel`` and the six
  classes' ``run_soa`` and ``run``, exact and approximate: keep masks and
  kept sets equal; distances within ``LINE_ATOL``, since the JAX jitted
  point→segment distance contracts multiply-adds (ROADMAP Queue C,
  "Linestring distances"), and exactly 0 where containment decides. The
  data keep every object's distance more than ``LINE_ATOL`` from the
  radius (each case asserts it), so the keep decisions cannot flip on
  that rounding;
- the reference's value where edges cross with no vertex inside (ROADMAP
  C2): the X of two open linestrings is at 1.0, the plus of two
  rectangles at 1.5, in both packages.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spatialflink_tpu import operators as jops
from spatialflink_tpu.grid import UniformGrid as JGrid
from spatialflink_tpu.models import batch as jbatch
from spatialflink_tpu.models.objects import LineString as JLineString
from spatialflink_tpu.models.objects import Point as JPoint
from spatialflink_tpu.models.objects import Polygon as JPolygon
from spatialflink_tpu.operators import QueryConfiguration as JConf
from spatialflink_tpu.operators import QueryType as JQT
from spatialflink_tpu.ops import range as jr
from spatialflink_tpu.streams import soa as jsoa

from spatialflink_tpu_torch import operators as tops
from spatialflink_tpu_torch.grid import UniformGrid
from spatialflink_tpu_torch.models import batch as tbatch
from spatialflink_tpu_torch.models.objects import LineString, Point, Polygon
from spatialflink_tpu_torch.operators import QueryConfiguration, QueryType
from spatialflink_tpu_torch.ops import range as tr
from spatialflink_tpu_torch.ops.polygon import pack_polyline, pack_rings
from spatialflink_tpu_torch.streams import soa as tsoa

# The Beijing extent on a 16 x 16 grid (cells of 0.13 deg).
GRID16 = dict(num_partitions=16, min_x=115.5, max_x=117.6, min_y=39.6,
              max_y=41.1)
CENTRE = np.array([116.55, 40.35])
R = 0.004
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


def _query_centres(rng, n):
    return CENTRE + rng.uniform(-0.25, 0.25, (n, 2))


def _object_rings(rng, n, centres):
    """``n`` rings of 4-11 distinct vertices (lengths 5-12), radii up to
    0.01 deg: half about the query centres, half uniform near them."""
    out = []
    for i in range(n):
        if i % 2:
            c = centres[i % len(centres)] + rng.uniform(-0.02, 0.02, 2)
        else:
            c = CENTRE + rng.uniform(-0.3, 0.3, 2)
        out.append(_ring(rng, c, 0.01, int(rng.integers(4, 12))))
    return out


def _queries(kind, rng, n=4):
    """(port, JAX) query sets of ``kind`` and their centres."""
    centres = _query_centres(rng, n)
    if kind == "point":
        return ([Point(obj_id=f"q{i}", x=x, y=y)
                 for i, (x, y) in enumerate(centres)],
                [JPoint(obj_id=f"q{i}", x=x, y=y)
                 for i, (x, y) in enumerate(centres)], centres)
    rings = [_ring(rng, c, 0.03, int(rng.integers(4, 9))) for c in centres]
    if kind == "polygon":
        return ([Polygon(obj_id=f"q{i}", rings=[r])
                 for i, r in enumerate(rings)],
                [JPolygon(obj_id=f"q{i}", rings=[r])
                 for i, r in enumerate(rings)], centres)
    return ([LineString(obj_id=f"q{i}", coords=r[:-1])
             for i, r in enumerate(rings)],
            [JLineString(obj_id=f"q{i}", coords=r[:-1])
             for i, r in enumerate(rings)], centres)


def _objects(rings, polygonal, per_sec, holes=False):
    """(port, JAX) object streams, ``per_sec`` objects a second, objIDs
    over 61 objects. ``holes``: every third polygon gets a hole (two
    rings, a seam between them)."""
    port, jax_ = [], []
    for i, ring in enumerate(rings):
        meta = dict(obj_id=f"g{i % 61}", timestamp=(i * 1000) // per_sec)
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


def _ragged_chunks(objs, n_chunks=4, edges=False, order=None):
    """Objects → ragged SoA chunks of their packed chains (each object's
    own ``packed()``), dense oids; ``edges`` adds the flat edge masks."""
    rows = []
    for i, o in enumerate(objs):
        pv, pe = o.packed()
        rows.append((o.timestamp, i % 61, pv, pe))
    if order is not None:
        rows = [rows[i] for i in order]
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


def _assert_dists(got, want, keep=None):
    """Within ``LINE_ATOL``, and 0 exactly where the reference is 0."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    if keep is not None:
        got, want = got[keep], want[keep]
    assert got.shape == want.shape
    assert np.array_equal(got == 0, want == 0)
    assert np.all(np.abs(got - want) <= LINE_ATOL)


def _assert_margin(dist, valid, radius):
    """No object within ``LINE_ATOL`` of the radius: the keep decisions
    cannot depend on the reference's multiply-add contraction."""
    d = np.asarray(dist, np.float64)[np.asarray(valid)]
    assert np.all(np.abs(d - np.float32(radius)) > LINE_ATOL)


# ---------------------------------------------------------------------------
# GeometryBatch, flag planes, the ragged assembler


@pytest.mark.parametrize("case", ["single_chain", "multi_ring", "buckets"])
def test_geometry_batch_from_ragged_matches_jax(case):
    rng = np.random.default_rng(1)
    rings = _object_rings(rng, 37, _query_centres(rng, 4))
    objs, _ = _objects(rings, True, 10, holes=case == "multi_ring")
    (chunk,) = _ragged_chunks(objs, n_chunks=1, edges=case == "multi_ring")
    kw = dict(edge_valid_flat=chunk.get("edge_valid"), dtype=np.float64)
    if case == "buckets":
        kw.update(bucket=64, vert_bucket=32)
    args = (chunk["ts"], chunk["oid"], chunk["lengths"], chunk["verts"])
    got = tbatch.GeometryBatch.from_ragged(*args, **kw)
    want = jbatch.GeometryBatch.from_ragged(*args, **kw)
    for f in ("verts", "edge_valid", "bbox", "ts", "oid", "valid"):
        assert np.array_equal(getattr(got, f), getattr(want, f)), f
    if case == "multi_ring":  # a seam inside every holed chain only
        for i, n in enumerate(chunk["lengths"]):
            assert got.edge_valid[i, :n - 1].all() == (i % 3 != 0)
    g, jg = UniformGrid(**GRID16), JGrid(**GRID16)
    assert np.array_equal(got.centroid_cells(g), want.centroid_cells(jg))
    with pytest.raises(ValueError):
        tbatch.GeometryBatch.from_ragged(*args, vert_bucket=4)
    with pytest.raises(ValueError):
        tbatch.GeometryBatch.from_ragged(
            chunk["ts"][:1], chunk["oid"][:1], np.array([1]),
            chunk["verts"][:1])


def test_geometry_batch_from_objects_matches_jax():
    rng = np.random.default_rng(2)
    rings = _object_rings(rng, 29, _query_centres(rng, 3))
    from spatialflink_tpu.utils.interning import Interner as JInterner

    from spatialflink_tpu_torch.utils.interning import Interner

    for polygonal in (True, False):
        objs, jobjs = _objects(rings, polygonal, 10, holes=True)
        got = tbatch.GeometryBatch.from_objects(objs, interner=Interner())
        want = jbatch.GeometryBatch.from_objects(jobjs,
                                                 interner=JInterner())
        for f in ("verts", "edge_valid", "bbox", "ts", "oid", "valid"):
            assert np.array_equal(getattr(got, f), getattr(want, f)), f
        assert got.capacity == want.capacity == 32


@pytest.mark.parametrize("r", [0.0, 0.004, 0.1, 0.3])
def test_any_cell_flagged_and_prefix_planes_match_jax(r):
    rng = np.random.default_rng(3)
    g, jg = UniformGrid(**GRID16), JGrid(**GRID16)
    cells = list(rng.integers(0, g.num_cells, 3))
    flags = g.neighbor_flags(r, cells)
    assert np.array_equal(flags, jg.neighbor_flags(r, cells))
    for a, b in zip(tbatch.flag_prefix_planes(g, flags),
                    jbatch.flag_prefix_planes(jg, flags)):
        assert np.array_equal(a, b)
    # Objects inside, across the edge of and outside the grid.
    centres = np.concatenate([
        CENTRE + rng.uniform(-1.2, 1.2, (60, 2)),
        np.array([[115.45, 40.0], [117.65, 41.15], [114.0, 38.0]])])
    rings = [_ring(rng, c, 0.2, 6) for c in centres]
    objs, jobjs = _objects(rings, True, 10)
    got = tbatch.GeometryBatch.from_objects(objs)
    want = jbatch.GeometryBatch.from_objects(jobjs)
    f_got = got.any_cell_flagged(g, flags)
    assert np.array_equal(f_got, want.any_cell_flagged(jg, flags))
    assert np.array_equal(f_got, got.any_cell_flagged(
        g, flags, prefix=tbatch.flag_prefix_planes(g, flags)))
    if r > 0:
        assert set(np.unique(f_got[:60])) >= {0, 1}


def _windows_equal(got, want):
    assert len(got) == len(want) and got
    for g, w in zip(got, want):
        assert (g.start, g.end, g.count) == (w.start, w.end, w.count)
        for f in ("ts", "oid", "lengths", "verts"):
            assert np.array_equal(getattr(g, f), getattr(w, f)), f
        assert (g.edge_valid is None) == (w.edge_valid is None)
        if g.edge_valid is not None:
            assert np.array_equal(g.edge_valid, w.edge_valid)


RAGGED_CASES = ["in_order", "out_of_order", "gaps", "edge_valid"]


@pytest.mark.parametrize("case", RAGGED_CASES)
def test_ragged_assembler_fires_as_jax(case):
    """As tests/test_soa.py:224 drives the JAX assembler: sliding windows
    over ragged chunks, in order, out of order within the lateness bound
    and beyond it (late drops), with gaps of empty windows, and with the
    multi-ring edge masks riding along."""
    rng = np.random.default_rng(4)
    rings = _object_rings(rng, 120, _query_centres(rng, 4))
    objs, _ = _objects(rings, True, 40, holes=case == "edge_valid")
    order = None
    ooo = 0
    if case == "out_of_order":
        order = np.argsort(np.arange(120) + rng.uniform(-80, 80, 120))
        ooo = 500
    if case == "gaps":
        for o in objs[40:]:
            o.timestamp += 7000  # seven empty seconds
    chunks = _ragged_chunks(objs, n_chunks=6, edges=case == "edge_valid",
                            order=order)
    t_asm = tsoa.RaggedSoaWindowAssembler(1000, 500, ooo_ms=ooo)
    j_asm = jsoa.RaggedSoaWindowAssembler(1000, 500, ooo_ms=ooo)
    got = list(t_asm.stream(chunks))
    want = list(j_asm.stream(chunks))
    _windows_equal(got, want)
    assert t_asm.dropped_late == j_asm.dropped_late
    if case == "out_of_order":
        strict = tsoa.RaggedSoaWindowAssembler(1000, 500, ooo_ms=0)
        j_strict = jsoa.RaggedSoaWindowAssembler(1000, 500, ooo_ms=0)
        _windows_equal(list(strict.stream(chunks)),
                       list(j_strict.stream(chunks)))
        assert strict.dropped_late == j_strict.dropped_late > 0


RAGGED_ERRORS = ["row_mismatch", "verts_mismatch", "edge_mismatch",
                 "edge_mode_on_to_off", "edge_mode_off_to_on"]


@pytest.mark.parametrize("case", RAGGED_ERRORS)
def test_ragged_assembler_errors_match_jax(case):
    rng = np.random.default_rng(5)
    objs, _ = _objects(_object_rings(rng, 20, _query_centres(rng, 2)),
                       True, 10)
    a, b = _ragged_chunks(objs, n_chunks=2, edges=True)
    if case == "row_mismatch":
        a["oid"] = a["oid"][:-1]
        seq = [a]
    elif case == "verts_mismatch":
        a["verts"] = a["verts"][:-1]
        seq = [a]
    elif case == "edge_mismatch":
        a["edge_valid"] = a["edge_valid"][:-1]
        seq = [a]
    elif case == "edge_mode_on_to_off":
        del b["edge_valid"]
        seq = [a, b]
    else:
        del a["edge_valid"]
        seq = [a, b]
    for cls in (tsoa.RaggedSoaWindowAssembler,
                jsoa.RaggedSoaWindowAssembler):
        asm = cls(1000, 1000)
        with pytest.raises(ValueError):
            for c in seq:
                asm.feed(dict(c))


# ---------------------------------------------------------------------------
# The kernels


def test_c2_crossing_geometries_keep_the_reference_value():
    """ROADMAP C2: edges that cross with no vertex inside the other give
    the vertex distances, not JTS's 0, in both packages."""
    x1 = pack_polyline([np.array([[-1, 0], [1, 0.0]])], pad_to=8)
    x2 = pack_polyline([np.array([[0, -1], [0, 1.0]])], pad_to=8)
    r1 = pack_rings([np.array([[-2, -.5], [2, -.5], [2, .5], [-2, .5]])],
                    pad_to=8)
    r2 = pack_rings([np.array([[-.5, -2], [.5, -2], [.5, 2], [-.5, 2]])],
                    pad_to=8)
    for a, b, poly, want in ((x1, x2, False, 1.0), (r1, r2, True, 1.5)):
        av, bv = a[0].astype(np.float32), b[0].astype(np.float32)
        got = tr.geometry_pair_distance(_t(av[None]), _t(a[1][None]),
                                        _t(bv[None]), _t(b[1][None]),
                                        poly, poly)
        ref = jr.geometry_pair_distance(jnp.asarray(av), jnp.asarray(a[1]),
                                        jnp.asarray(bv), jnp.asarray(b[1]),
                                        poly, poly)
        assert got.shape == (1, 1)
        assert float(got[0, 0]) == float(ref) == want


CLASSES = {
    ("polygon", "point"): ("PolygonPointRangeQuery", True),
    ("polygon", "polygon"): ("PolygonPolygonRangeQuery", True),
    ("polygon", "linestring"): ("PolygonLineStringRangeQuery", True),
    ("linestring", "point"): ("LineStringPointRangeQuery", False),
    ("linestring", "polygon"): ("LineStringPolygonRangeQuery", False),
    ("linestring", "linestring"): ("LineStringLineStringRangeQuery", False),
}


def _assert_stream_margin(jobjs, jqs, jop):
    """``_assert_margin`` over the reference's distance of every object
    of a stream to the query set."""
    from spatialflink_tpu.operators.base import center_coords as jcenter

    batch = jbatch.GeometryBatch.from_objects(jobjs)
    qv, qe = jop._query_arrays(jqs)
    st = jop._kernel_statics()
    jk = jax.jit(jr.geometry_range_query_kernel, static_argnames=tuple(st))
    _, d = jk(jcenter(jop.grid, batch.verts, np.float32), batch.edge_valid,
              batch.valid, np.ones(batch.capacity, np.uint8),
              jcenter(jop.grid, qv, np.float32), qe, R, **st)
    _assert_margin(d, batch.valid, R)


KERNEL_CASES = [(p, q, a) for p in (True, False)
                for q in ("point", "polygon", "linestring")
                for a in (False,)] + [(True, "polygon", True),
                                      (False, "point", True)]


@pytest.mark.parametrize("obj_polygonal,query_kind,approx", KERNEL_CASES)
def test_geometry_range_kernel_matches_jax(obj_polygonal, query_kind,
                                           approx):
    from spatialflink_tpu_torch.operators.base import center_coords

    rng = np.random.default_rng(6)
    qs, _, centres = _queries(query_kind, rng)
    objs, _ = _objects(_object_rings(rng, 200, centres), obj_polygonal, 10,
                       holes=True)
    g = UniformGrid(**GRID16)
    name = CLASSES[("polygon" if obj_polygonal else "linestring",
                    query_kind)][0]
    qverts, qev = getattr(tops, name)(QueryConfiguration(), g,
                                      device="cpu")._query_arrays(qs)
    batch = tbatch.GeometryBatch.from_objects(objs)
    flags = batch.any_cell_flagged(
        g, g.neighbor_flags(R, [c for q in qs for c in q.grid_cells(g)]))

    args = (center_coords(g, batch.verts), batch.edge_valid, batch.valid,
            flags, center_coords(g, qverts), qev)
    statics = dict(approximate=approx, obj_polygonal=obj_polygonal,
                   query_polygonal=query_kind == "polygon")
    keep, dist = tr.geometry_range_query_kernel(*map(_t, args), R, **statics)
    jk = jax.jit(jr.geometry_range_query_kernel,
                 static_argnames=tuple(statics))
    jkeep, jdist = jk(*map(jnp.asarray, args), R, **statics)
    _assert_margin(jdist, batch.valid, R)
    assert np.array_equal(keep.numpy(), np.asarray(jkeep))
    assert 0 < keep.sum() < batch.valid.sum()
    _assert_dists(dist.numpy(), jdist, batch.valid)
    if approx:
        assert keep.sum() > (np.asarray(jdist) <= R)[batch.valid].sum()


@pytest.mark.parametrize("query_polygonal", [True, False])
def test_padding_vertices_reach_no_min_and_no_any(query_polygonal):
    """``from_ragged`` writes 0.0 into padding vertices, a real coordinate
    once the grid is centred on the origin. Here they lie inside the
    query square (or on the query line), the objects' real vertices ~3
    away: both packages report the real distance, never 0."""
    rng = np.random.default_rng(9)
    rings = [_ring(rng, np.array([3.0, 3.0]), 0.5, int(m))
             for m in rng.integers(4, 12, 20)]
    lengths = np.array([len(r) for r in rings])
    batch = tbatch.GeometryBatch.from_ragged(
        np.zeros(20, np.int64), np.arange(20, dtype=np.int32), lengths,
        np.concatenate(rings), dtype=np.float32)
    assert np.all(batch.verts[~tr._vert_valid(_t(batch.edge_valid)).numpy()]
                  == 0)
    sq = np.array([[-1, -1], [1, -1], [1, 1], [-1, 1], [-1, -1.0]])
    qv, qe = (pack_rings([sq], pad_to=8) if query_polygonal
              else pack_polyline([sq[:2]], pad_to=8))
    args = (batch.verts, batch.edge_valid, batch.valid,
            np.ones(batch.capacity, np.uint8), qv[None].astype(np.float32),
            qe[None])
    statics = dict(obj_polygonal=True, query_polygonal=query_polygonal)
    keep, dist = tr.geometry_range_query_kernel(*map(_t, args), 1.0,
                                                **statics)
    jk = jax.jit(jr.geometry_range_query_kernel,
                 static_argnames=tuple(statics))
    jkeep, jdist = jk(*map(jnp.asarray, args), 1.0, **statics)
    assert not keep.any() and not np.asarray(jkeep).any()
    d = dist.numpy()[batch.valid]
    assert np.all(d > 2.0)
    _assert_dists(d, np.asarray(jdist)[batch.valid])


# ---------------------------------------------------------------------------
# Operators

def _ops(stream_kind, query_kind, conf_kw):
    name, polygonal = CLASSES[(stream_kind, query_kind)]
    jconf = dict(conf_kw)
    if "query_type" in jconf:
        jconf["query_type"] = JQT[jconf["query_type"].name]
    op = getattr(tops, name)(QueryConfiguration(**conf_kw),
                             UniformGrid(**GRID16), device="cpu")
    jop = getattr(jops, name)(JConf(**jconf), JGrid(**GRID16))
    return op, jop, polygonal


SOA_CASES = [(s, q, a, False) for (s, q) in CLASSES for a in (False,)] + [
    ("polygon", "polygon", True, False), ("linestring", "point", True, False),
    ("polygon", "point", False, True)]


@pytest.mark.parametrize("stream_kind,query_kind,approx,multi_ring",
                         SOA_CASES)
def test_run_soa_matches_jax(stream_kind, query_kind, approx, multi_ring):
    """Each class's ``run_soa`` on ragged chunks (a multi-ring stream
    carries its edge masks): the same windows, kept indices and oids,
    distances within ``LINE_ATOL`` and 0 where contained."""
    rng = np.random.default_rng(7)
    op, jop, polygonal = _ops(stream_kind, query_kind,
                              dict(window_size=1.0, slide_step=1.0,
                                   approximate_query=approx))
    qs, jqs, centres = _queries(query_kind, rng)
    objs, jobjs = _objects(_object_rings(rng, 300, centres), polygonal, 100,
                           holes=multi_ring)
    chunks = _ragged_chunks(objs, n_chunks=5, edges=multi_ring)
    got = list(op.run_soa(chunks, qs, R))
    want = list(jop.run_soa(chunks, jqs, R, dtype=np.float32))
    assert len(got) == len(want) == 3
    kept = 0
    for g, w in zip(got, want):
        assert (g[0], g[1], g[5]) == (w[0], w[1], w[5])
        assert np.array_equal(g[2], w[2]) and np.array_equal(g[3], w[3])
        _assert_dists(g[4], w[4])
        kept += len(g[2])
    assert kept > 0
    _assert_stream_margin(jobjs, jqs, jop)


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
]


@pytest.mark.parametrize("stream_kind,query_kind,conf_kw", RUN_CASES,
                         ids=[f"{s}-{q}-{i}" for i, (s, q, _) in
                              enumerate(RUN_CASES)])
def test_run_matches_jax(stream_kind, query_kind, conf_kw):
    """``run`` on Polygon or LineString objects (holed polygons
    included): the same windows, window counts and kept objects in order,
    distances within ``LINE_ATOL`` and 0 where contained."""
    rng = np.random.default_rng(8)
    op, jop, polygonal = _ops(stream_kind, query_kind, conf_kw)
    qs, jqs, centres = _queries(query_kind, rng)
    objs, jobjs = _objects(_object_rings(rng, 210, centres), polygonal, 70,
                           holes=True)
    got = list(op.run(iter(objs), qs, R))
    want = list(jop.run(iter(jobjs), jqs, R, dtype=np.float32))
    assert len(got) == len(want) and got
    kept = 0
    for g, w in zip(got, want):
        assert (g.start, g.end, g.window_count) == (w.start, w.end,
                                                    w.window_count)
        assert [(o.obj_id, o.timestamp) for o in g.objects] == \
            [(o.obj_id, o.timestamp) for o in w.objects]
        _assert_dists(g.dists, w.dists)
        kept += len(g.objects)
    assert kept > 0
    _assert_stream_margin(jobjs, jqs, jop)


def test_polygon_stream_point_query_brute_force():
    """As tests/test_operators.py:103 holds for the JAX package: square
    polygons against a point query keep exactly the squares within the
    radius by the bbox distance (0 inside), on a 20 x 20 grid of the unit
    square scaled by 10."""
    rng = np.random.default_rng(41)
    grid = UniformGrid(20, 0.0, 10.0, 0.0, 10.0)
    polys = []
    for i in range(40):
        cx, cy = rng.uniform(1, 9), rng.uniform(1, 9)
        polys.append(Polygon(obj_id=f"poly{i}", timestamp=i * 100, rings=[
            np.array([[cx - .3, cy - .3], [cx + .3, cy - .3],
                      [cx + .3, cy + .3], [cx - .3, cy + .3],
                      [cx - .3, cy - .3]])]))
    op = tops.PolygonPointRangeQuery(
        QueryConfiguration(window_size=30, slide_step=30), grid,
        device="cpu")
    got = {p.obj_id for r in op.run(iter(polys), [Point(x=5.0, y=5.0)], 1.0)
           for p in r.objects}
    expect = set()
    for p in polys:
        b = p.bbox()
        dx = max(b[0] - 5.0, 0, 5.0 - b[2])
        dy = max(b[1] - 5.0, 0, 5.0 - b[3])
        if np.hypot(dx, dy) <= 1.0:
            expect.add(p.obj_id)
    assert got == expect and got


def test_run_soa_equals_the_object_path():
    """As tests/test_soa.py:224 holds for the JAX package: ``run_soa`` on
    ragged chunks of the objects' own packed chains keeps, window for
    window, the objects and distances ``run`` keeps (sliding windows)."""
    rng = np.random.default_rng(42)
    qs, _, centres = _queries("point", rng)
    objs, _ = _objects(_object_rings(rng, 240, centres), True, 40)
    conf = QueryConfiguration(window_size=2.0, slide_step=1.0)
    grid = UniformGrid(**GRID16)
    by_obj = {
        (r.start, r.end): sorted((o.obj_id, float(d))
                                 for o, d in zip(r.objects, r.dists))
        for r in tops.PolygonPointRangeQuery(conf, grid, device="cpu").run(
            iter(objs), qs, R)}
    by_soa = {
        (s, e): sorted((f"g{o}", float(d)) for o, d in zip(oids, dists))
        for s, e, _, oids, dists, _ in tops.PolygonPointRangeQuery(
            conf, grid, device="cpu").run_soa(_ragged_chunks(objs), qs, R)}
    assert by_obj == by_soa and any(by_obj.values())


def test_unported_options_raise():
    conf = QueryConfiguration()
    g = UniformGrid(**GRID16)
    # ``mesh=`` is ported (tests/test_torch_parallel_operators.py): a
    # value that is not a mesh raises.
    with pytest.raises(TypeError, match="must be a spatialflink_tpu_torch.parallel.mesh.Mesh"):
        tops.PolygonPolygonRangeQuery(conf, g, device="cpu", mesh=object())
    op = tops.LineStringPointRangeQuery(conf, g, device="cpu")
    with pytest.raises(TypeError, match="must be a spatialflink_tpu_torch.parallel.mesh.Mesh"):
        list(op.run(iter([]), [Point()], 0.1, mesh=object()))
    with pytest.raises(TypeError, match="must be a spatialflink_tpu_torch.parallel.mesh.Mesh"):
        op.geometry_batch([], mesh=object())
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            tops.PolygonPointRangeQuery(conf, g)
