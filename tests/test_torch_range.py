"""Parity of the PyTorch port's point-stream range queries with the JAX
package.

The same inputs, made with numpy from a seed, go through the JAX function
and its port counterpart. The JAX side runs the Pallas point→polyline
kernel in interpret mode and its range kernels and operators on the CPU;
the port runs on the CPU, where the B4 wrapper takes its plain PyTorch
version. Float32 is pinned on both sides (the test configuration turns
x64 on): the JAX kernels get float32 arrays and the JAX operators are
called with ``dtype=np.float32``, so they centre in float64 and cast, as
the port always does.

Contracts held:
- grid flags, bbox cells, cell assignment, packing, containment and the
  query-polygon generator: exact;
- ``polyline_min_dist_plain`` against ``point_polyline_min_dist_pallas(
  interpret=True)`` within the 2e-6 of ``tests/test_pallas.py``, and
  against ``point_polyline_distance`` within 1 ulp; a boundary with no
  valid edge gives ``finfo(float32).max``;
- every range kernel (dense, chunked, polylines, pruned, compact,
  approximate) against its JAX twin: keep masks equal, overflows equal,
  distances of kept lanes within 1 ulp. Only kept lanes are compared:
  a dropped lane of the pruned paths reports the min over its candidates,
  which depends on which of several tied candidates a top-k picks;
- the three operators' ``run_soa`` and ``run`` (WindowBased, RealTime,
  CountBased, approximate) per window: starts, ends and window counts
  exact, the same matched events, distances within 1 ulp; the pruned
  paths' retries grow ``_ncand`` and ``_cand_budget`` as the JAX
  operator's do; the same from a JAX operator's state.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spatialflink_tpu.grid import UniformGrid as JGrid
from spatialflink_tpu.models.objects import LineString as JLineString
from spatialflink_tpu.models.objects import MultiLineString as JMultiLine
from spatialflink_tpu.models.objects import MultiPolygon as JMultiPolygon
from spatialflink_tpu.models.objects import Point as JPoint
from spatialflink_tpu.models.objects import Polygon as JPolygon
from spatialflink_tpu.operators import PointLineStringRangeQuery as JLineQ
from spatialflink_tpu.operators import PointPointRangeQuery as JPointQ
from spatialflink_tpu.operators import PointPolygonRangeQuery as JPolyQ
from spatialflink_tpu.operators import QueryConfiguration as JConf
from spatialflink_tpu.operators import QueryType as JQT
from spatialflink_tpu.operators.base import flags_for_queries as j_flags
from spatialflink_tpu.operators.base import pack_query_geometries as j_pack
from spatialflink_tpu.ops import distances as jd
from spatialflink_tpu.ops import range as jr
from spatialflink_tpu.ops.cells import assign_cells as j_assign
from spatialflink_tpu.ops.pallas_kernels import point_polyline_min_dist_pallas
from spatialflink_tpu.ops.polygon import pack_polyline as j_pack_polyline
from spatialflink_tpu.ops.polygon import pack_rings as j_pack_rings
from spatialflink_tpu.ops.polygon import point_polygon_distance as j_ppoly
from spatialflink_tpu.ops.polygon import points_in_polygon as j_pip
from spatialflink_tpu.utils.helper import generate_query_polygons as j_gen

from spatialflink_tpu_torch.grid import UniformGrid
from spatialflink_tpu_torch.models.objects import LineString, Point, Polygon
from spatialflink_tpu_torch.operators import (
    PointLineStringRangeQuery,
    PointPointRangeQuery,
    PointPolygonRangeQuery,
    QueryConfiguration,
    QueryType,
)
from spatialflink_tpu_torch.operators.base import (
    center_coords,
    flags_for_queries,
    pack_query_geometries,
)
from spatialflink_tpu_torch.ops import distances as td
from spatialflink_tpu_torch.ops import range as tr
from spatialflink_tpu_torch.ops.cells import assign_cells, gather_cell_flags
from spatialflink_tpu_torch.ops.polygon import (
    pack_polyline,
    pack_rings,
    point_polygon_distance,
    points_in_polygon,
    points_in_polygons,
)
from spatialflink_tpu_torch.ops.polyline_kernel import (
    polyline_min_dist,
    polyline_min_dist_plain,
)
from spatialflink_tpu_torch.state import range_state_from_jax
from spatialflink_tpu_torch.utils.helper import generate_query_polygons

EXTENT = (115.5, 39.6, 117.6, 41.1)
BEIJING = dict(num_partitions=100, min_x=115.5, max_x=117.6, min_y=39.6,
               max_y=41.1)
# A coarse grid makes the flag table of 64+ polygons dense (the pruned
# path without compaction).
COARSE = dict(BEIJING, num_partitions=16)
R = 0.002
BIG = np.finfo(np.float32).max


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _within_ulp(a, b, atol=0.0):
    """Equal within 1 ulp of the values, or within ``atol``."""
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    if a.shape != b.shape:
        return False
    same = a == b
    ulp = np.spacing(np.maximum(np.abs(a[~same]), np.abs(b[~same])))
    return bool(np.all(np.abs(a[~same] - b[~same]) <= np.maximum(ulp, atol)))


#: Linestring distances against jitted JAX: XLA contracts multiply-adds
#: of the projection into FMAs, which moves the closest point by up to a
#: coordinate ulp, and ``p - closest`` carries that absolute error into a
#: small distance (thousands of its ulps). Centred coordinates
#: stay below 1.05, so two of their ulps bound it. Axis-aligned polygons
#: project exactly and are held to 1 ulp.
LINE_ATOL = 2 * float(np.spacing(np.float32(1.05)))


def _polys(n, seed=3):
    return generate_query_polygons(n, *EXTENT, grid_size=100, seed=seed)


def _jpolys(n, seed=3):
    return j_gen(n, *EXTENT, grid_size=100, seed=seed)


def _lines(n, seed=5):
    """Random 2–6-vertex linestrings about the extent's middle."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        k = int(rng.integers(2, 7))
        c = rng.uniform([116.2, 40.0], [116.9, 40.7])
        out.append(c + np.cumsum(rng.normal(0, 0.01, (k, 2)), axis=0))
    return out


def _points_near(rng, n, polys):
    """Half uniform over the extent, half jittered about polygon
    vertices, so that distances within and around the radius occur."""
    u = np.stack([rng.uniform(115.5, 117.6, n - n // 2),
                  rng.uniform(39.6, 41.1, n - n // 2)], axis=1)
    verts = np.concatenate([p.rings[0] if hasattr(p, "rings") else p.coords
                            for p in polys])
    near = verts[rng.integers(0, len(verts), n // 2)] \
        + rng.uniform(-0.004, 0.004, (n // 2, 2))
    xy = np.concatenate([u, near])
    return xy[rng.permutation(n)]


# ---------------------------------------------------------------------------
# Grid, packing, containment, distances


@pytest.mark.parametrize("r", [0.0, 0.002, 0.021, 0.06, 0.5])
def test_grid_flags_match_jax(r):
    g, jg = UniformGrid(**BEIJING), JGrid(**BEIJING)
    rng = np.random.default_rng(11)
    cells = list(rng.integers(0, g.num_cells, 9)) + [0, g.num_cells - 1,
                                                      g.num_cells, -1]
    assert g.guaranteed_layers(r) == jg.guaranteed_layers(r)
    assert np.array_equal(g.neighbor_flags(r, cells),
                          jg.neighbor_flags(r, cells))
    for only in (False, True):
        assert np.array_equal(g.neighbor_cells(r, cells, only),
                              jg.neighbor_cells(r, cells, only))
    for box in ((116.0, 40.0, 116.1, 40.05), (115.0, 39.0, 115.6, 39.7),
                (118.0, 42.0, 119.0, 43.0), (116.3, 40.3, 116.3, 40.3)):
        assert np.array_equal(g.bbox_cells(*box), jg.bbox_cells(*box))
    for x, y in ((115.5, 39.6), (117.6, 41.1), (116.4, 40.19), (115.4, 40)):
        assert g.flat_cell(x, y) == jg.flat_cell(x, y)
        assert g.cell_indices(x, y) == jg.cell_indices(x, y)


def test_query_objects_and_flags_match_jax():
    polys, jpolys = _polys(40), _jpolys(40)
    g, jg = UniformGrid(**BEIJING), JGrid(**BEIJING)
    for p, jp in zip(polys, jpolys):
        assert p.obj_id == jp.obj_id
        assert np.array_equal(p.rings[0], jp.rings[0])
        assert p.bbox() == jp.bbox()
        assert p.grid_cells(g) == jp.grid_cells(jg)
        assert p.num_vertices_packed() == jp.num_vertices_packed()
    assert np.array_equal(flags_for_queries(g, R, polys),
                          j_flags(jg, R, jpolys))
    for a, b in zip(pack_query_geometries(polys), j_pack(jpolys)):
        assert np.array_equal(a, b)
    rings = [np.array([[0, 0], [4, 0], [4, 4], [0, 4]], float),
             np.array([[1, 1], [2, 1], [2, 2], [1, 1]], float)]
    parts = [np.array([[0, 0], [1, 1], [2, 0]], float),
             np.array([[3, 3], [4, 4]], float)]
    for pad in (None, 12):
        for a, b in zip(pack_rings(rings, pad), j_pack_rings(rings, pad)):
            assert np.array_equal(a, b)
        for a, b in zip(pack_polyline(parts, pad),
                        j_pack_polyline(parts, pad)):
            assert np.array_equal(a, b)
    with pytest.raises(ValueError):
        pack_rings(rings, pad_to=3)


@pytest.mark.parametrize("seed", [0, 1])
def test_points_in_polygon_matches_jax(seed):
    rng = np.random.default_rng(seed)
    rings = [rng.uniform(0, 10, (13, 2)), rng.uniform(2, 6, (5, 2))]
    verts, ev = pack_rings(rings, pad_to=32)
    verts = verts.astype(np.float32)
    pts = rng.uniform(-1, 11, (3000, 2)).astype(np.float32)
    pts[:20] = verts[:20]  # on vertices
    want = np.asarray(j_pip(jnp.asarray(pts), jnp.asarray(verts),
                            jnp.asarray(ev)))
    got = points_in_polygon(_t(pts), _t(verts), _t(ev)).numpy()
    assert np.array_equal(got, want) and 0 < want.sum() < len(pts)
    # Batched, dense and gathered, against per-polygon JAX calls.
    vs = np.stack([verts, verts[::-1].copy(), verts + 3])
    es = np.stack([ev, ev[::-1].copy(), ev])
    dense = points_in_polygons(_t(pts), _t(vs), _t(es)).numpy()
    for j in range(3):
        assert np.array_equal(dense[:, j], np.asarray(j_pip(
            jnp.asarray(pts), jnp.asarray(vs[j]), jnp.asarray(es[j]))))
    sel = rng.integers(0, 3, (len(pts), 5)).astype(np.int32)
    gathered = points_in_polygons(_t(pts), _t(vs), _t(es), _t(sel)).numpy()
    assert np.array_equal(gathered, np.take_along_axis(dense, sel, axis=1))


def test_distances_match_jax():
    rng = np.random.default_rng(4)
    a = rng.uniform(-1, 1, (500, 2)).astype(np.float32)
    b = rng.uniform(-1, 1, (300, 2)).astype(np.float32)
    s2 = b + rng.uniform(-0.3, 0.3, b.shape).astype(np.float32)
    s2[:30] = b[:30]  # degenerate segments
    ja, jb, js2 = jnp.asarray(a), jnp.asarray(b), jnp.asarray(s2)
    assert _within_ulp(td.pairwise_distance(_t(a), _t(b)).numpy(),
                       jd.pairwise_distance(ja, jb))
    assert _within_ulp(
        td.point_segment_distance(_t(a[:300]), _t(b), _t(s2)).numpy(),
        jd.point_segment_distance(ja[:300], jb, js2))
    boxes = np.concatenate([np.minimum(b, s2), np.maximum(b, s2)], axis=1)
    boxes = boxes[:, [0, 1, 2, 3]]
    assert _within_ulp(
        td.bbox_point_min_distance(_t(a[:300]), _t(boxes)).numpy(),
        jd.bbox_point_min_distance(ja[:300], jnp.asarray(boxes)))
    verts, ev = pack_rings([rng.uniform(-1, 1, (9, 2))], pad_to=16)
    verts = verts.astype(np.float32)
    jv, je = jnp.asarray(verts), jnp.asarray(ev)
    assert _within_ulp(
        td.point_polyline_distance(_t(a), _t(verts), _t(ev)).numpy(),
        jd.point_polyline_distance(ja, jv, je))
    got = point_polygon_distance(_t(a), _t(verts), _t(ev)).numpy()
    want = np.asarray(j_ppoly(ja, jv, je))
    assert _within_ulp(got, want) and 0 < (got == 0).sum() < len(a)


def test_assign_cells_and_gather_match_jax():
    rng = np.random.default_rng(8)
    g = UniformGrid(**BEIJING)
    xy = np.stack([rng.uniform(115.0, 118.0, 4000),
                   rng.uniform(39.0, 42.0, 4000)], axis=1).astype(np.float32)
    args = (g.min_x, g.min_y, g.cell_length, g.n)
    got = assign_cells(_t(xy), *args)
    want = np.asarray(j_assign(jnp.asarray(xy), *args))
    assert got.dtype == torch.int32 and np.array_equal(got.numpy(), want)
    flags = g.neighbor_flags(0.05, [1234, 5678])
    assert np.array_equal(gather_cell_flags(got, _t(flags)).numpy(),
                          flags[want])


# ---------------------------------------------------------------------------
# B4's plain version


def _b4_case(name, rng):
    if name == "ring":
        verts, ev = pack_rings([rng.uniform(0, 10, (37, 2))], pad_to=64)
        pts = rng.uniform(-2, 12, (3000, 2))
    elif name == "multi_ring_seams":
        verts, ev = pack_rings([rng.uniform(0, 5, (9, 2)),
                                rng.uniform(5, 10, (7, 2))], pad_to=32)
        pts = rng.uniform(0, 10, (500, 2))
    else:  # degenerate edges and points on edges
        ring = rng.uniform(0, 10, (12, 2))
        ring[3] = ring[2]
        ring[7] = ring[6]
        verts, ev = pack_rings([ring], pad_to=16)
        pts = np.concatenate([ring, (ring[:-1] + ring[1:]) / 2,
                              rng.uniform(-2, 12, (400, 2))])
    return verts.astype(np.float32), ev, pts.astype(np.float32)


@pytest.mark.parametrize("name", ["ring", "multi_ring_seams", "degenerate"])
def test_polyline_min_dist_plain_matches_pallas_and_jax(name):
    rng = np.random.default_rng(7)
    verts, ev, pts = _b4_case(name, rng)
    got = polyline_min_dist_plain(_t(pts), _t(verts[None]),
                                  _t(ev[None]))[:, 0].numpy()
    pallas = np.asarray(point_polyline_min_dist_pallas(
        jnp.asarray(pts), jnp.asarray(verts), jnp.asarray(ev),
        interpret=True))
    np.testing.assert_allclose(got, pallas, atol=2e-6)
    ref = np.asarray(jd.point_polyline_distance(
        jnp.asarray(pts), jnp.asarray(verts), jnp.asarray(ev)))
    assert ref.dtype == np.float32 and _within_ulp(got, ref)
    plain_one = td.point_polyline_distance(_t(pts), _t(verts), _t(ev))
    assert np.array_equal(got, plain_one.numpy())


def _b4_batch(name, rng):
    """Boundary sets for the kernel's redesigned modes: G not a multiple
    of the 32 boundaries a dense block takes, invalid edges between valid
    ones, and a gathered C that is not a multiple of 4."""
    g = 33 if name == "dense_g33" else 40
    verts = np.stack([pack_rings([rng.uniform(0, 10, (7, 2))], pad_to=8)[0]
                      for _ in range(g)]).astype(np.float32)
    ev = np.ones((g, 7), bool)
    if name != "dense_g33":
        ev[::2, 1] = False  # edges 0, 2.. valid around an invalid one
        ev[1::3, 3] = False
        ev[2::5, 1:3] = False
    pts = rng.uniform(-2, 12, (400, 2)).astype(np.float32)
    sel = rng.integers(0, g, (400, 3)).astype(np.int32) \
        if name == "gathered_c3" else None
    return pts, verts, ev, sel


@pytest.mark.parametrize("name", ["dense_g33", "invalid_mid_edges",
                                  "gathered_c3"])
def test_polyline_min_dist_plain_batched_matches_pallas(name):
    """The batched plain version, column for column, against the Pallas
    kernel run per boundary (within ``tests/test_pallas.py``'s 2e-6) and
    against ``point_polyline_distance`` (within 1 ulp)."""
    rng = np.random.default_rng(10)
    pts, verts, ev, sel = _b4_batch(name, rng)
    got = polyline_min_dist_plain(_t(pts), _t(verts), _t(ev),
                                  None if sel is None else _t(sel)).numpy()
    assert (ev[:, 0] & ~ev[:, 1] & ev[:, 2]).any() or name == "dense_g33"
    for j in range(got.shape[1]):
        col = np.full(len(pts), j) if sel is None else sel[:, j]
        for b in np.unique(col):
            at = col == b
            pallas = np.asarray(point_polyline_min_dist_pallas(
                jnp.asarray(pts[at]), jnp.asarray(verts[b]),
                jnp.asarray(ev[b]), interpret=True))
            np.testing.assert_allclose(got[at, j], pallas, atol=2e-6)
            ref = np.asarray(jd.point_polyline_distance(
                jnp.asarray(pts[at]), jnp.asarray(verts[b]),
                jnp.asarray(ev[b])))
            assert _within_ulp(got[at, j], ref)


def test_polyline_min_dist_batched_modes_and_sentinel():
    """Dense over G boundaries, gathered through ``sel``, the per-boundary
    function, and FLT_MAX (not the Pallas kernel's +inf) for a boundary
    with no valid edge."""
    rng = np.random.default_rng(9)
    g, v, n = 6, 16, 700
    verts = rng.uniform(-3, 3, (g, v, 2)).astype(np.float32)
    ev = rng.random((g, v - 1)) > 0.3
    ev[2] = False  # all-invalid boundary
    pts = rng.uniform(-4, 4, (n, 2)).astype(np.float32)
    dense = polyline_min_dist(_t(pts), _t(verts), _t(ev))
    assert dense.shape == (n, g) and polyline_min_dist.launches == 0
    for j in range(g):
        one = td.point_polyline_distance(_t(pts), _t(verts[j]), _t(ev[j]))
        assert torch.equal(dense[:, j], one)
    assert torch.all(dense[:, 2] == BIG)
    sel = rng.integers(0, g, (n, 3)).astype(np.int32)
    gathered = polyline_min_dist(_t(pts), _t(verts), _t(ev.astype(np.uint8)),
                                 _t(sel))
    assert torch.equal(gathered, torch.gather(dense, 1, _t(sel).long()))
    pallas = np.asarray(point_polyline_min_dist_pallas(
        jnp.asarray(pts), jnp.asarray(verts[2]), jnp.asarray(ev[2]),
        interpret=True))
    assert np.all(np.isinf(pallas))  # the TPU kernel's sentinel differs
    for bad in ((pts.astype(np.float64), verts, ev, None),
                (pts, verts[:, :, 0], ev, None),
                (pts, verts, ev[:, :-1], None),
                (pts, verts, ev, sel.astype(np.int64))):
        with pytest.raises(ValueError):
            polyline_min_dist(*(None if a is None else _t(a) for a in bad))


# ---------------------------------------------------------------------------
# ops/range.py kernels


def _scene(n_polys, n=3000, grid=BEIJING, seed=12, cluster=0, r=R,
           lines=False):
    """Centred float32 lanes and a packed polygon (or linestring) set, for
    both packages. ``cluster`` extra copies of polygon 0, shifted by up to
    1e-4, make more than ``cand`` bboxes lie within the radius of its
    points."""
    rng = np.random.default_rng(seed)
    polys = _polys(n_polys)
    if lines:
        polys = [LineString(coords=c) for c in _lines(n_polys)]
    if cluster:
        base = polys[0].rings[0]
        for k in range(cluster):
            polys.append(type(polys[0])(obj_id=f"c{k}", rings=[
                base + rng.uniform(-1e-4, 1e-4, 2)]))
    g = UniformGrid(**grid)
    xy64 = _points_near(rng, n, polys)
    if cluster:
        xy64[:200] = polys[0].rings[0][0] + rng.uniform(-1e-3, 1e-3, (200, 2))
    xy = center_coords(g, xy64)
    valid = rng.random(n) > 0.05
    flags = g.neighbor_flags(r, [c for p in polys for c in p.grid_cells(g)])
    cell = g.assign_cells_np(xy64)
    verts, ev = pack_query_geometries(polys)
    qv = center_coords(g, verts)
    return xy, valid, flags, cell, qv, ev


def _check_kernel(got, want, n_over=0, atol=0.0):
    keep = got[0].numpy()
    assert np.array_equal(keep, np.asarray(want[0]))
    assert keep.sum() > 0
    assert _within_ulp(got[1].numpy()[keep], np.asarray(want[1])[keep],
                       atol)
    for a, b in zip(got[2:2 + n_over], want[2:2 + n_over]):
        assert int(a) == int(b)


RANGE_CASES = {
    "points": 0, "polygons_dense": 20, "polygons_chunked": 70,
    "polylines": 40, "pruned": 70, "pruned_overflow": 70,
    "compact": 70, "compact_budget_overflow": 70, "approximate": 70,
}


@pytest.mark.parametrize("case", sorted(RANGE_CASES))
def test_range_kernels_match_jax(case):
    cluster = 12 if case == "pruned_overflow" else 0
    lines = case == "polylines"
    xy, valid, flags, cell, qv, ev = _scene(
        max(RANGE_CASES[case], 20), cluster=cluster, lines=lines,
        r=0.01 if lines else R)
    f = flags[cell]
    T = (_t(xy), _t(valid), _t(f))
    J = (jnp.asarray(xy), jnp.asarray(valid), jnp.asarray(f))
    tq, jq = (_t(qv), _t(ev)), (jnp.asarray(qv), jnp.asarray(ev))
    if case == "points":
        q = xy[:5].copy()
        _check_kernel(tr.range_query_kernel(*T, _t(q), 0.01),
                      jr.range_query_kernel(*J, jnp.asarray(q), 0.01))
    elif case in ("polygons_dense", "polygons_chunked", "approximate"):
        approx = case == "approximate"
        _check_kernel(
            tr.range_query_polygons_kernel(*T, *tq, R, approximate=approx),
            jr.range_query_polygons_kernel(*J, *jq, R, approximate=approx))
    elif case == "polylines":
        _check_kernel(tr.range_query_polylines_kernel(*T, *tq, 0.01),
                      jr.range_query_polylines_kernel(*J, *jq, 0.01),
                      atol=LINE_ATOL)
    elif case.startswith("pruned"):
        got = tr.range_query_polygons_pruned_kernel(*T, *tq, R, cand=8,
                                                    point_chunk=512)
        want = jr.range_query_polygons_pruned_kernel(*J, *jq, R, cand=8)
        _check_kernel(got, want, n_over=1)
        assert (int(got[2]) > 0) == (case == "pruned_overflow")
    else:
        budget = 64 if case == "compact_budget_overflow" else 4096
        got = tr.range_query_polygons_pruned_compact_kernel(
            *T, *tq, R, budget=budget, cand=8)
        want = jr.range_query_polygons_pruned_compact_kernel(
            *J, *jq, R, budget=budget, cand=8)
        _check_kernel(got, want, n_over=2)
        assert (int(got[3]) > 0) == (budget == 64)
        assert np.array_equal(got[1].numpy() == BIG,
                              np.asarray(want[1]) == BIG)


def test_fused_variants_gather_flags():
    xy, valid, flags, cell, qv, ev = _scene(70)
    T = (_t(xy), _t(valid), _t(cell), _t(flags), _t(qv), _t(ev), R)
    f = _t(flags[cell])
    for fused, plain, kw in (
            (tr.range_polygons_fused, tr.range_query_polygons_kernel, {}),
            (tr.range_polylines_fused, tr.range_query_polylines_kernel, {}),
            (tr.range_polygons_pruned_fused,
             tr.range_query_polygons_pruned_kernel, {}),
            (tr.range_polygons_pruned_compact_fused,
             tr.range_query_polygons_pruned_compact_kernel,
             {"budget": 512})):
        got = fused(*T, **kw)
        want = plain(T[0], T[1], f, *T[4:], **kw)
        assert all(torch.equal(torch.as_tensor(a), torch.as_tensor(b))
                   for a, b in zip(got, want))


# ---------------------------------------------------------------------------
# Operators


def _chunks(xy64, n_win, per_win):
    ts = (np.arange(n_win * per_win, dtype=np.int64) * 1000) // per_win
    step = per_win // 2
    return [{"ts": ts[s:s + step], "x": xy64[s:s + step, 0],
             "y": xy64[s:s + step, 1],
             "oid": np.arange(s, s + step, dtype=np.int32)}
            for s in range(0, n_win * per_win, step)]


def _query_sets(kind):
    """(port, JAX) query sets and the grid of an operator case."""
    if kind == "point":
        pts = [(116.40, 40.19), (116.1, 39.9)]
        return ([Point(x=x, y=y) for x, y in pts],
                [JPoint(x=x, y=y) for x, y in pts], BEIJING)
    if kind == "linestring":
        ls = _lines(12)
        return ([LineString(coords=c) for c in ls],
                [JLineString(coords=c) for c in ls], BEIJING)
    n = int(kind.split("_")[1])
    grid = COARSE if kind.endswith("pruned") else BEIJING
    qs, jqs = _polys(n), _jpolys(n)
    if kind.endswith("cluster"):
        # Twelve copies of polygon 0 a hair apart: points near it have
        # more than 8 bboxes within the radius, so ``_ncand`` must grow.
        for k, d in enumerate(np.linspace(-1e-4, 1e-4, 12)):
            ring = qs[0].rings[0] + d
            qs.append(type(qs[0])(obj_id=f"c{k}", rings=[ring]))
            jqs.append(JPolygon(obj_id=f"c{k}", rings=[ring]))
    return qs, jqs, grid


OPS = {"point": (PointPointRangeQuery, JPointQ),
       "linestring": (PointLineStringRangeQuery, JLineQ)}


def _ops(kind, conf_kw, **kw):
    port_cls, j_cls = OPS.get(kind, (PointPolygonRangeQuery, JPolyQ))
    qs, jqs, grid = _query_sets(kind)
    op = port_cls(QueryConfiguration(**conf_kw), UniformGrid(**grid),
                  device="cpu", **kw)
    jconf = dict(conf_kw)
    if "query_type" in jconf:
        jconf["query_type"] = JQT[jconf["query_type"].name]
    jop = j_cls(JConf(**jconf), JGrid(**grid))
    return op, jop, qs, jqs


SOA_KINDS = ["point", "linestring", "polygons_20", "polygons_70",
             "polygons_70_pruned", "polygons_60_cluster"]


@pytest.mark.parametrize("kind", SOA_KINDS)
def test_run_soa_matches_jax(kind):
    rng = np.random.default_rng(21)
    op, jop, qs, jqs = _ops(kind, dict(window_size=1.0, slide_step=1.0))
    near = qs if kind.startswith("polygons") else _polys(30)
    xy64 = _points_near(rng, 3 * 2000, near)
    if kind.endswith("cluster"):
        xy64[::9] = qs[0].rings[0][0] + rng.uniform(-1e-3, 1e-3, (667, 2))
    if kind == "point":
        xy64[::7] = np.array([116.40, 40.19]) + rng.normal(0, 0.01, (858, 2))
    r = 0.02 if kind in ("point", "linestring") else R
    got = list(op.run_soa(_chunks(xy64, 3, 2000), qs, r))
    want = list(jop.run_soa(_chunks(xy64, 3, 2000), jqs, r,
                            dtype=np.float32))
    assert len(got) == len(want) == 3
    hits = 0
    for g, w in zip(got, want):
        assert g[:2] == w[:2]
        assert g[2].keys() == w[2].keys()
        for k in g[2]:
            assert np.array_equal(g[2][k], w[2][k])
        assert _within_ulp(g[3], w[3], LINE_ATOL * (kind == "linestring"))
        hits += len(g[3])
    assert hits > 0
    if kind == "polygons_70":
        assert op._cand_budget == jop._cand_budget == 4096  # compact path
    if kind == "polygons_70_pruned":
        assert not hasattr(op, "_cand_budget")
        assert not hasattr(jop, "_cand_budget")
        assert op._ncand == jop._ncand == 8
    if kind == "polygons_60_cluster":
        assert op._ncand == jop._ncand == 16


def _objects(xy64, per_sec, cls, prefix="p"):
    ts = (np.arange(len(xy64), dtype=np.int64) * 1000) // per_sec
    return [cls(obj_id=f"{prefix}{i % 97}", timestamp=int(t), x=float(x),
                y=float(y)) for i, (t, (x, y)) in enumerate(zip(ts, xy64))]


def _same_results(got, want, atol=0.0):
    assert len(got) == len(want) and got
    for g, w in zip(got, want):
        assert (g.start, g.end, g.window_count) == (w.start, w.end,
                                                    w.window_count)
        assert [(o.obj_id, o.timestamp) for o in g.objects] == \
            [(o.obj_id, o.timestamp) for o in w.objects]
        assert _within_ulp(g.dists, w.dists, atol)
    return sum(len(g.objects) for g in got)


RUN_CASES = [
    ("point", dict(query_type=QueryType.WindowBased, window_size=1.0,
                   slide_step=0.5)),
    ("point", dict(query_type=QueryType.RealTime, realtime_batch_ms=200)),
    ("point", dict(query_type=QueryType.CountBased, count_window_size=500)),
    ("linestring", dict(query_type=QueryType.WindowBased, window_size=1.0,
                        slide_step=1.0)),
    ("polygons_20", dict(query_type=QueryType.RealTime,
                         realtime_batch_ms=500)),
    ("polygons_70", dict(query_type=QueryType.CountBased,
                         count_window_size=700)),
    ("polygons_70_pruned", dict(query_type=QueryType.WindowBased,
                                window_size=1.0, slide_step=1.0)),
    ("polygons_70", dict(query_type=QueryType.WindowBased, window_size=1.0,
                         slide_step=1.0, approximate_query=True)),
]


@pytest.mark.parametrize("kind,conf_kw", RUN_CASES,
                         ids=[f"{k}-{i}" for i, (k, _) in
                              enumerate(RUN_CASES)])
def test_run_matches_jax(kind, conf_kw):
    rng = np.random.default_rng(22)
    op, jop, qs, jqs = _ops(kind, conf_kw)
    near = qs if kind.startswith("polygons") else _polys(30)
    xy64 = _points_near(rng, 1400, near)
    if kind == "point":
        xy64[::5] = np.array([116.40, 40.19]) + rng.normal(0, 0.01, (280, 2))
    r = 0.02 if kind in ("point", "linestring") else R
    got = list(op.run(iter(_objects(xy64, 700, Point)), qs, r))
    want = list(jop.run(iter(_objects(xy64, 700, JPoint)), jqs, r,
                        dtype=np.float32))
    assert _same_results(got, want, LINE_ATOL * (kind == "linestring")) > 0


def test_query_incremental_matches_run():
    """As tests/test_operators.py:269 holds for the JAX operator: per
    window the same result multiset as full recomputation (in-order
    stream); and the same results as the JAX ``query_incremental``."""
    rng = np.random.default_rng(23)
    conf = dict(query_type=QueryType.WindowBased, window_size=1.0,
                slide_step=0.5)
    op, jop, _, _ = _ops("point", conf)
    xy64 = np.array([116.40, 40.19]) + rng.normal(0, 0.02, (1500, 2))
    q, jq = Point(x=116.40, y=40.19), JPoint(x=116.40, y=40.19)
    pts = _objects(xy64, 600, Point)
    full = {(r.start, r.end): sorted((o.obj_id, o.timestamp)
                                     for o in r.objects)
            for r in op.run(iter(pts), [q], 0.02)}
    inc = list(PointPointRangeQuery(
        QueryConfiguration(**conf), UniformGrid(**BEIJING),
        device="cpu").query_incremental(iter(pts), q, 0.02))
    assert full == {(r.start, r.end): sorted((o.obj_id, o.timestamp)
                                             for o in r.objects)
                    for r in inc}
    want = list(jop.query_incremental(iter(_objects(xy64, 600, JPoint)), jq,
                                      0.02, dtype=np.float32))
    assert _same_results(inc, want) > 0
    late = PointPointRangeQuery(
        QueryConfiguration(window_size=1.0, slide_step=0.5,
                           allowed_lateness=1.0),
        UniformGrid(**BEIJING), device="cpu")
    with pytest.raises(ValueError, match="allowed_lateness"):
        list(late.query_incremental(iter([]), q, 0.02))


def test_range_state_from_jax_resumes_grown_budgets():
    """A port operator built from a JAX query set and a JAX operator's
    grown ``_ncand``/``_cand_budget`` computes what the JAX one does."""
    rng = np.random.default_rng(24)
    conf = dict(window_size=1.0, slide_step=1.0)
    _, jop, _, jqs = _ops("polygons_70", conf)
    ext = jqs[4].rings[0]
    c = ext[:4].mean(axis=0)
    jqs = list(jqs) + [JMultiPolygon.from_polygons(
        [[p.rings[0]] for p in jqs[:3]], obj_id="mp"),
        JPolygon(obj_id="holed", rings=[ext, c + 0.3 * (ext - c)])]
    jop._ncand, jop._cand_budget = 16, 512
    qs, kw = range_state_from_jax(jqs, jop)
    assert kw == {"ncand": 16, "cand_budget": 512}
    assert type(qs[-2]).__name__ == "MultiPolygon" and qs[-2].parts == [1] * 3
    op = PointPolygonRangeQuery(QueryConfiguration(**conf),
                                UniformGrid(**BEIJING), device="cpu", **kw)
    xy64 = _points_near(rng, 2 * 2000, qs[:70])
    got = list(op.run_soa(_chunks(xy64, 2, 2000), qs, R))
    want = list(jop.run_soa(_chunks(xy64, 2, 2000), jqs, R,
                            dtype=np.float32))
    for g, w in zip(got, want):
        assert g[:2] == w[:2] and np.array_equal(g[2]["oid"], w[2]["oid"])
        assert _within_ulp(g[3], w[3])
    assert (op._ncand, op._cand_budget) == (jop._ncand, jop._cand_budget)
    lines = [JLineString(obj_id="l", coords=np.array([[0, 0], [1, 1.0]])),
             JMultiLine(obj_id="ml", parts=[np.array([[0, 0], [1, 0.0]]),
                                            np.array([[2, 2], [3, 3.0]])]),
             JPoint(obj_id="p", timestamp=5, x=1.0, y=2.0)]
    ql, kw = range_state_from_jax(lines)
    assert kw == {}
    for a, b in zip(ql, lines):
        assert type(a).__name__ == type(b).__name__
        assert a.bbox() == b.bbox() and a.obj_id == b.obj_id
    for a, b in zip(ql[:2], lines[:2]):
        assert all(np.array_equal(x, y) for x, y in zip(a.packed(),
                                                        b.packed()))


def test_device_and_unported_options():
    conf = QueryConfiguration()
    g = UniformGrid(**BEIJING)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            PointPolygonRangeQuery(conf, g)
    # ``mesh=`` is ported (tests/test_torch_parallel_operators.py): a
    # value that is not a mesh raises. The partitioned run is ported
    # (A12.2): on the CPU it equals the JAX operator's on its eight-device
    # mesh over the same events, distances within 1 ulp (the JAX program
    # may contract x² + y² into an FMA).
    with pytest.raises(TypeError, match="must be a spatialflink_tpu_torch.parallel.mesh.Mesh"):
        PointPointRangeQuery(conf, g, device="cpu", mesh=object())
    op = PointPointRangeQuery(conf, g, device="cpu")
    with pytest.raises(TypeError, match="must be a spatialflink_tpu_torch.parallel.mesh.Mesh"):
        list(op.run(iter([]), [Point()], 0.1, mesh=object()))
    with pytest.raises(TypeError, match="must be a spatialflink_tpu_torch.parallel.mesh.Mesh"):
        list(op.run_partitioned(iter([]), [Point()], 0.1, None))
    from spatialflink_tpu.parallel.mesh import data_mesh as j_data_mesh
    from spatialflink_tpu_torch.parallel.mesh import data_mesh

    rng = np.random.default_rng(5)
    xy = np.stack([rng.uniform(115.5, 117.6, 3000),
                   rng.uniform(39.6, 41.1, 3000)], axis=1)
    events = [(f"o{i % 31}", 10 * i, float(x), float(y))
              for i, (x, y) in enumerate(xy)]
    grid = dict(BEIJING, num_partitions=256)
    queries = [(116.4, 40.2), (116.0, 39.9), (117.1, 40.7)]
    rconf = QueryConfiguration(QueryType.WindowBased, window_size=10,
                               slide_step=5)
    got = list(PointPointRangeQuery(rconf, UniformGrid(**grid),
                                    device="cpu").run_partitioned(
        iter([Point(obj_id=o, timestamp=t, x=x, y=y)
              for o, t, x, y in events]),
        [Point(x=x, y=y) for x, y in queries], 0.08,
        data_mesh(8, devices=["cpu"] * 8)))
    want = list(JPointQ(JConf(JQT.WindowBased, window_size=10, slide_step=5),
                        JGrid(**grid)).run_partitioned(
        iter([JPoint(obj_id=o, timestamp=t, x=x, y=y)
              for o, t, x, y in events]),
        [JPoint(x=x, y=y) for x, y in queries], 0.08, j_data_mesh(8)))
    assert [(r.start, r.end, r.window_count,
             [(p.obj_id, p.timestamp) for p in r.objects]) for r in got] == \
        [(r.start, r.end, r.window_count,
          [(p.obj_id, p.timestamp) for p in r.objects]) for r in want]
    assert sum(len(r.objects) for r in got) > 50
    for a, b in zip(got, want):
        a, b = np.asarray(a.dists), np.asarray(b.dists)
        assert a.dtype == b.dtype == np.float64
        assert np.all(np.abs(a - b) <= np.spacing(np.maximum(a, b)))


def test_sqrt_rn_is_correctly_rounded_on_any_split():
    """torch's CPU root (float32 and float64) misses the correctly
    rounded result on some inputs, and which ones depends on how the
    work is split among threads; ``sqrt_rn`` must equal numpy's exact
    root however the work is split, so the CPU and the card agree."""
    from spatialflink_tpu_torch.ops.distances import sqrt_rn

    rng = np.random.default_rng(25)
    s = rng.uniform(0, 4, 1_000_003).astype(np.float32)
    want = np.sqrt(s)
    threads = torch.get_num_threads()
    try:
        for n in (1, max(2, threads)):
            torch.set_num_threads(n)
            got = sqrt_rn(_t(s)).numpy()
            assert np.array_equal(got.view(np.uint32), want.view(np.uint32))
            got = sqrt_rn(_t(s.astype(np.float64)), torch.float32).numpy()
            assert np.array_equal(
                got, np.sqrt(s.astype(np.float64)).astype(np.float32))
    finally:
        torch.set_num_threads(threads)


@pytest.mark.parametrize("kind", ["point", "polygon"])
def test_driver_with_an_overload_controller_changes_nothing(kind):
    from test_torch_overload import (
        assert_budget_free_controller_changes_nothing,
    )

    rng = np.random.default_rng(10)
    xy = rng.uniform([116.0, 39.9], [116.4, 40.3], (500, 2))
    stream = [Point(obj_id=f"o{i % 60}", timestamp=int(4 * i), x=float(x),
                    y=float(y)) for i, (x, y) in enumerate(xy)]
    if kind == "point":
        cls, queries, r = PointPointRangeQuery, [Point(x=116.2, y=40.1)], 0.05
    else:
        ring = [(116.1, 40.0), (116.3, 40.0), (116.3, 40.2), (116.1, 40.2),
                (116.1, 40.0)]
        cls, queries, r = PointPolygonRangeQuery, [Polygon(rings=[ring])], R

    def run(driver):
        op = cls(QueryConfiguration(window_size=1.0, slide_step=1.0),
                 UniformGrid(**COARSE), device="cpu")
        return [(res.start, res.end, [p.obj_id for p in res.objects],
                 np.asarray(res.dists).tolist())
                for res in op.run(iter(stream), queries, r, driver=driver)]

    assert_budget_free_controller_changes_nothing(run)
