"""Parity of the PyTorch port's geometry joins with the JAX package.

The same inputs, made with numpy from a seed, go through the JAX function
and its port counterpart; the port runs on the CPU, where B4's wrapper
takes its plain PyTorch version. The JAX operators are called with
``dtype=np.float32`` (the test configuration turns x64 on), so they
centre in float64 and cast, as the port always does; the JAX kernels get
the same float32 lanes.

Contracts held:
- ``first_k_prefix_indices``: array-equal to the JAX function, with rows
  of more than ``k`` set bits, rows with none and ``k`` above the row
  length;
- ``_block_candidates``: ``cvalid`` and ``overflow`` array-equal, the
  candidate ids equal on every valid slot; pad slots hold in-range ids in
  both (which ones is the selection strategy's: JAX's ``top_k`` gives the
  lowest unset ids on the CPU, its one-hot branch 0 on a TPU, the port
  C - 1), and no output reads them;
- ``_compact_pairs``: all five outputs array-equal, in order, with
  ``max_pairs`` above and below the count;
- the dense and pruned point ⋈ geometry and geometry ⋈ geometry kernels,
  exact and approximate, polygonal and not: pair arrays equal in order,
  ``count``, ``cand_overflow`` and ``pair_overflow`` exact; distances 0
  exactly where the JAX kernel gives 0 and otherwise within ``LINE_ATOL``
  (the JAX jitted point→segment and bbox distances contract multiply-adds
  into FMAs, ROADMAP Queue C, "Linestring distances"); the data keep
  every valid (item, geometry) distance more than ``LINE_ATOL`` from the
  radius, which each case asserts, so no pair can flip on that rounding.
  The pruned pair set equals the port's dense one, distance bits too;
- the tiled ``geometry_pair_distance`` bit-equal to the dense one, C2's
  crossing cases kept (1.0 and 1.5);
- all eight classes' ``run`` and ``run_soa`` against the JAX operators
  window by window (pairs in order, the same ids and timestamps,
  distances as above), with forced ``cand``, ``pair_cap`` and budget
  retries that leave the port operator's ``_cand``, ``_pair_cap`` and
  ``_geom_max_pairs`` at the JAX operator's values, a point inside a
  polygon at distance 0, one-sided windows (empty arrays of the JAX
  dtypes), and ``PolygonPointJoinQuery.run_soa``'s point-first argument
  order.
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
from spatialflink_tpu.ops import join as jjoin
from spatialflink_tpu.ops import select as jselect

from spatialflink_tpu_torch import operators as tops
from spatialflink_tpu_torch.grid import UniformGrid
from spatialflink_tpu_torch.models.batch import GeometryBatch
from spatialflink_tpu_torch.models.objects import LineString, Point, Polygon
from spatialflink_tpu_torch.operators import QueryConfiguration
from spatialflink_tpu_torch.operators.base import center_coords
from spatialflink_tpu_torch.operators.join_query import _centered_bbox
from spatialflink_tpu_torch.ops import join as tjoin
from spatialflink_tpu_torch.ops import range as tr
from spatialflink_tpu_torch.ops import select as tselect

# The Beijing extent on a 16 x 16 grid (cells of 0.13 deg).
GRID16 = dict(num_partitions=16, min_x=115.5, max_x=117.6, min_y=39.6,
              max_y=41.1)
CENTRE = np.array([116.55, 40.35])
R = 0.004
#: As tests/test_torch_range.py:122: two coordinate ulps of the centred
#: float32 values (below 1.05 on this extent), the FMA freedom of the
#: JAX jitted distances.
LINE_ATOL = 2 * float(np.spacing(np.float32(1.05)))
CONF = dict(window_size=1.0, slide_step=0.5)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _same_dists(got, want):
    """0 exactly where the reference is 0, the rest within LINE_ATOL."""
    g = np.asarray(got, np.float32)
    w = np.asarray(want, np.float32)
    assert g.shape == w.shape
    assert np.array_equal(g == 0, w == 0)
    assert np.array_equal(np.isinf(g), np.isinf(w))
    fin = np.isfinite(w)
    assert np.all(np.abs(g[fin].astype(np.float64) - w[fin]) <= LINE_ATOL)


def _assert_margin(d, valid_mask):
    """No valid (item, geometry) distance within LINE_ATOL of R."""
    d = np.asarray(d, np.float64)[np.asarray(valid_mask)]
    assert np.all(np.abs(d - np.float32(R)) > LINE_ATOL)


# ---------------------------------------------------------------------------
# Data


def _ring(rng, centre, r_max, m):
    """A closed star-shaped ring of ``m`` distinct vertices."""
    ang = np.sort(rng.uniform(0, 2 * np.pi, m))
    rad = rng.uniform(0.3, 1.0, m) * r_max
    ring = centre + np.stack([rad * np.cos(ang), rad * np.sin(ang)], axis=1)
    return np.concatenate([ring, ring[:1]])


def _point_objs(rng, n, spread=0.04, t0=0, t_span=2000, prefix="p"):
    """(port, JAX) ``Point`` streams about the centre, in time order."""
    xy = CENTRE + rng.uniform(-spread, spread, (n, 2))
    ts = np.sort(rng.integers(t0, t0 + t_span, n))
    port = [Point(obj_id=f"{prefix}{i}", timestamp=int(t), x=x, y=y)
            for i, (t, (x, y)) in enumerate(zip(ts, xy.tolist()))]
    jx = [JPoint(obj_id=p.obj_id, timestamp=p.timestamp, x=p.x, y=p.y)
          for p in port]
    return port, jx


def _geom_objs(rng, m, kind, spread=0.04, t0=0, t_span=2000, holes=False,
               prefix="g", r_max=0.008):
    """(port, JAX) polygon or linestring streams about the centre, rings
    of 4-11 distinct vertices; ``holes``: every third polygon gets one."""
    ts = np.sort(rng.integers(t0, t0 + t_span, m))
    port, jx = [], []
    for i, t in enumerate(ts):
        ring = _ring(rng, CENTRE + rng.uniform(-spread, spread, 2), r_max,
                     int(rng.integers(4, 12)))
        meta = dict(obj_id=f"{prefix}{i}", timestamp=int(t))
        if kind == "polygon":
            rs = [ring]
            if holes and i % 3 == 0:
                c = ring[:-1].mean(axis=0)
                rs.append(c + 0.3 * (ring - c))
            port.append(Polygon(rings=rs, **meta))
            jx.append(JPolygon(rings=rs, **meta))
        else:
            port.append(LineString(coords=ring[:-1], **meta))
            jx.append(JLineString(coords=ring[:-1], **meta))
    return port, jx


def _point_chunks(objs, n_chunks=3):
    ts = np.array([o.timestamp for o in objs], np.int64)
    x = np.array([o.x for o in objs])
    y = np.array([o.y for o in objs])
    oid = np.arange(len(objs), dtype=np.int32)
    cuts = np.linspace(0, len(objs), n_chunks + 1).astype(int)
    return [{"ts": ts[a:b], "x": x[a:b], "y": y[a:b], "oid": oid[a:b]}
            for a, b in zip(cuts[:-1], cuts[1:])]


def _ragged_chunks(objs, n_chunks=3, edges=False):
    """Objects → ragged SoA chunks of their packed chains; ``edges`` adds
    the flat edge masks (multi-ring seams)."""
    rows = [(o.timestamp, i, *o.packed()) for i, o in enumerate(objs)]
    cuts = np.linspace(0, len(rows), n_chunks + 1).astype(int)
    out = []
    for a, b in zip(cuts[:-1], cuts[1:]):
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


def _lanes(grid, geoms):
    """A geometry batch's float32 kernel lanes: (verts, edge_valid, valid,
    padded bbox, unpadded bbox)."""
    gb = GeometryBatch.from_objects(geoms)
    return (center_coords(grid, gb.verts), gb.edge_valid, gb.valid,
            _centered_bbox(grid, gb.bbox), _centered_bbox(grid, gb.bbox,
                                                          pad=False))


# ---------------------------------------------------------------------------
# Selection, candidates, compaction


@pytest.mark.parametrize("shape,k,p", [
    ((6, 5, 40), 8, 0.3),  # rows of more than k set bits
    ((7, 64), 64, 0.5),  # k == row length
    ((9, 16), 20, 0.4),  # k above the row length
    ((4, 3, 1), 1, 0.5),
    ((5, 33), 4, 0.05),  # mostly empty rows
])
def test_first_k_prefix_indices_matches_jax(shape, k, p):
    rng = np.random.default_rng(sum(shape) + k)
    m = rng.random(shape) < p
    m.reshape(-1, shape[-1])[0] = False  # a row with none
    m.reshape(-1, shape[-1])[-1] = True  # a full row
    want = jselect.first_k_prefix_indices(jnp.asarray(m), k)
    got = tselect.first_k_prefix_indices(_t(m), k)
    for g, w in zip(got, want):
        assert g.dtype == torch.int32
        assert np.array_equal(g.numpy(), np.asarray(w))


def _boxes(rng, n, lo=-1.0, hi=1.0, size=0.2):
    a = rng.uniform(lo, hi, (n, 2))
    return np.concatenate([a, a + rng.uniform(0, size, (n, 2))],
                          axis=1).astype(np.float32)


@pytest.mark.parametrize("cand", [1, 4, 16, 60])
def test_block_candidates_matches_jax(cand):
    rng = np.random.default_rng(cand)
    blocks = _boxes(rng, 12, size=0.5)
    big = np.finfo(np.float32).max
    blocks[3] = [big, big, -big, -big]  # an empty tile
    gbbox = _boxes(rng, 60)
    gvalid = rng.random(60) > 0.15
    want = jax.jit(jjoin._block_candidates, static_argnames="cand")(
        jnp.asarray(blocks), jnp.asarray(gbbox), jnp.asarray(gvalid), 0.05,
        cand=cand)
    got = tjoin._block_candidates(_t(blocks), _t(gbbox), _t(gvalid), 0.05,
                                  cand)
    gids, cvalid, over = (g.numpy() for g in got)
    wg, wc, wo = (np.asarray(w) for w in want)
    assert np.array_equal(cvalid, wc) and int(over) == int(wo)
    assert np.array_equal(gids[cvalid], wg[wc])
    assert gids.dtype == np.int32 and np.all((gids >= 0) & (gids < 60))
    assert cvalid[:, 0].sum() > 6 and not cvalid[3].any()
    if cand < 16:
        assert int(over) > 0


@pytest.mark.parametrize("pair_cap,max_pairs", [(3, 4096), (8, 4096),
                                                (3, 40), (1, 4096)])
def test_compact_pairs_matches_jax(pair_cap, max_pairs):
    rng = np.random.default_rng(pair_cap * 7 + max_pairs)
    nb, cand, b = 5, 9, 16
    mask = rng.random((nb, cand, b)) < 0.35
    mask[1] = False  # a tile with no match
    mask[2, :, 0] = True  # an item matching every candidate
    dmat = rng.uniform(0, 1, (nb, cand, b)).astype(np.float32)
    borig = np.arange(nb * b, dtype=np.int32).reshape(nb, b)
    borig[-1, 11:] = -1  # the last tile's padding
    mask[-1, :, 11:] = False
    gids = rng.integers(0, 50, (nb, cand)).astype(np.int32)
    want = jax.jit(jjoin._compact_pairs,
                   static_argnames=("pair_cap", "max_pairs"))(
        jnp.asarray(mask), jnp.asarray(dmat), jnp.asarray(borig),
        jnp.asarray(gids), pair_cap=pair_cap, max_pairs=max_pairs)
    got = tjoin._compact_pairs(_t(mask), _t(dmat), _t(borig), _t(gids),
                               pair_cap, max_pairs)
    for g, w in zip(got, want):
        g, w = g.numpy(), np.asarray(w)
        assert g.shape == w.shape
        if g.dtype == np.float32:
            assert np.array_equal(g.view(np.uint32), w.view(np.uint32))
        else:
            assert np.array_equal(g, w)
    assert int(got[3]) == int(mask.sum())
    if max_pairs == 40:
        assert int(got[3]) > 40 and np.all(got[0].numpy() >= 0)


# ---------------------------------------------------------------------------
# Kernels


def _point_kernel_inputs(seed, kind, n=700, m=40, holes=False):
    rng = np.random.default_rng(seed)
    grid = UniformGrid(**GRID16)
    pts, _ = _point_objs(rng, n)
    geoms, _ = _geom_objs(rng, m, kind, holes=holes)
    xy = np.array([[p.x, p.y] for p in pts])
    # Sorted along x for locality, as the operators sort by cell.
    pxy = center_coords(grid, xy[np.argsort(xy[:, 0])])
    pvalid = np.ones(n, bool)
    pvalid[::13] = False
    verts, ev, gvalid, gbbox, gbbox_np = _lanes(grid, geoms)
    return pxy, pvalid, verts, ev, gvalid, gbbox, gbbox_np


def _jax_point_pruned(args, polygonal, cand, pair_cap, max_pairs, approx,
                      block=256):
    return jax.jit(jjoin.point_geometry_join_pruned_kernel,
                   static_argnames=("polygonal", "block", "cand",
                                    "max_pairs", "pair_cap", "approx"))(
        *map(jnp.asarray, args), R, polygonal=polygonal, block=block,
        cand=cand, max_pairs=max_pairs, pair_cap=pair_cap, approx=approx)


def _same_pruned(got, want):
    for a, b in zip(got[:2], want[:2]):
        assert np.array_equal(a.numpy(), np.asarray(b))
    _same_dists(got.dist.numpy(), np.asarray(want.dist))
    for a, b in zip(got[3:], want[3:]):
        assert int(a) == int(b)


def _pair_dict(res):
    n = min(int(res.count), len(res.left_index))
    li, ri, dd = (x[:n].numpy() for x in res[:3])
    return {(int(a), int(b)): d.view(np.uint32).item()
            for a, b, d in zip(li, ri, dd) if a >= 0}


@pytest.mark.parametrize("kind", ["polygon", "linestring"])
def test_point_geometry_dense_kernel_matches_jax(kind):
    pxy, pvalid, verts, ev, gvalid, _, _ = _point_kernel_inputs(3, kind)
    poly = kind == "polygon"
    want = jax.jit(jjoin.point_geometry_join_kernel,
                   static_argnames="polygonal")(
        *map(jnp.asarray, (pxy, pvalid, verts, ev, gvalid)), R,
        polygonal=poly)
    got = tjoin.point_geometry_join_kernel(
        *map(_t, (pxy, pvalid, verts, ev, gvalid)), R, polygonal=poly)
    live = pvalid[None, :] & gvalid[:, None]
    _assert_margin(got[1].numpy(), live)
    assert np.array_equal(got[0].numpy(), np.asarray(want[0]))
    _same_dists(got[1].numpy()[live], np.asarray(want[1])[live])
    assert got[0].sum() > 20
    if poly:
        assert (got[1].numpy()[got[0].numpy()] == 0).sum() > 5


POINT_PRUNED_CASES = {
    # name: (kind, cand, pair_cap, max_pairs, approx, holes)
    "polygon": ("polygon", 32, 8, 4096, False, False),
    "polygon_holes": ("polygon", 32, 8, 4096, False, True),
    "linestring": ("linestring", 32, 8, 4096, False, False),
    "cand_overflow": ("polygon", 2, 8, 4096, False, False),
    "pair_overflow": ("polygon", 32, 1, 4096, False, False),
    "cand_above_m": ("linestring", 500, 500, 4096, False, False),
    "over_budget": ("polygon", 32, 8, 16, False, False),
    "approx": ("polygon", 32, 8, 4096, True, False),
}


@pytest.mark.parametrize("case", list(POINT_PRUNED_CASES))
def test_point_geometry_pruned_kernel_matches_jax(case):
    kind, cand, pair_cap, max_pairs, approx, holes = POINT_PRUNED_CASES[case]
    pxy, pvalid, verts, ev, gvalid, gbbox, gbbox_np = _point_kernel_inputs(
        5, kind, holes=holes)
    poly = kind == "polygon"
    box = gbbox_np if approx else gbbox
    args = (pxy, pvalid, verts, ev, gvalid, box)
    want = _jax_point_pruned(args, poly, cand, pair_cap, max_pairs, approx)
    got = tjoin.point_geometry_join_pruned_kernel(
        *map(_t, args), R, polygonal=poly, block=256, cand=cand,
        max_pairs=max_pairs, pair_cap=pair_cap, approx=approx)
    dense_d = tjoin.point_geometry_join_kernel(
        *map(_t, (pxy, pvalid, verts, ev, gvalid)), R, polygonal=poly)[1]
    if approx:
        from spatialflink_tpu_torch.ops.distances import (
            bbox_point_min_distance,
        )
        dense_d = bbox_point_min_distance(_t(pxy)[None], _t(box)[:, None])
    live = pvalid[None, :] & gvalid[:, None]
    _assert_margin(dense_d.numpy(), live)
    _same_pruned(got, want)
    assert int(got.count) > 20
    if case == "cand_overflow":
        assert int(got.cand_overflow) > 0
    elif case == "pair_overflow":
        assert int(got.pair_overflow) > 0
    elif case == "over_budget":
        assert int(got.count) > max_pairs
    else:
        assert int(got.cand_overflow) == int(got.pair_overflow) == 0
        # the pruned pair set is the dense one, distance bits too
        if not approx:
            mask, d = tjoin.point_geometry_join_kernel(
                *map(_t, (pxy, pvalid, verts, ev, gvalid)), R,
                polygonal=poly)
        else:
            mask = (dense_d <= np.float32(R)) & _t(live)
            d = dense_d
        gi, pi = np.nonzero(mask.numpy())
        dense = {(int(p), int(g)): d.numpy()[g, p].view(np.uint32).item()
                 for g, p in zip(gi, pi)}
        assert _pair_dict(got) == dense


def _geom_kernel_inputs(seed, akind, bkind, la=150, lb=40):
    rng = np.random.default_rng(seed)
    grid = UniformGrid(**GRID16)
    a, _ = _geom_objs(rng, la, akind, r_max=0.004, prefix="a")
    # Sorted along x for locality, as the operators sort by bbox centre.
    a.sort(key=lambda o: o.bbox()[0])
    b, _ = _geom_objs(rng, lb, bkind, holes=bkind == "polygon", prefix="b")
    av, ae, avalid, abox, abox_np = _lanes(grid, a)
    bv, be, bvalid, bbox, bbox_np = _lanes(grid, b)
    avalid = avalid.copy()
    avalid[5] = False
    return (av, ae, avalid, abox, abox_np), (bv, be, bvalid, bbox, bbox_np)


KINDS = {"PolygonPolygon": ("polygon", "polygon"),
         "PolygonLineString": ("polygon", "linestring"),
         "LineStringPolygon": ("linestring", "polygon"),
         "LineStringLineString": ("linestring", "linestring")}


@pytest.mark.parametrize("pair", list(KINDS))
def test_geometry_dense_kernel_matches_jax(pair):
    akind, bkind = KINDS[pair]
    (av, ae, avalid, _, _), (bv, be, bvalid, _, _) = _geom_kernel_inputs(
        7, akind, bkind, la=60)
    ap, bp = akind == "polygon", bkind == "polygon"
    want = jax.jit(jjoin.geometry_geometry_join_kernel,
                   static_argnames=("a_polygonal", "b_polygonal"))(
        *map(jnp.asarray, (av, ae, avalid, bv, be, bvalid)), R,
        a_polygonal=ap, b_polygonal=bp)
    got = tjoin.geometry_geometry_join_kernel(
        *map(_t, (av, ae, avalid, bv, be, bvalid)), R, a_polygonal=ap,
        b_polygonal=bp)
    live = avalid[:, None] & bvalid[None, :]
    _assert_margin(got[1].numpy(), live)
    assert np.array_equal(got[0].numpy(), np.asarray(want[0]))
    _same_dists(got[1].numpy()[live], np.asarray(want[1])[live])
    assert got[0].sum() > 5


GEOM_PRUNED_CASES = {
    # name: (pair, cand, pair_cap, max_pairs, approx)
    "PolygonPolygon": ("PolygonPolygon", 32, 8, 4096, False),
    "PolygonLineString": ("PolygonLineString", 32, 8, 4096, False),
    "LineStringPolygon": ("LineStringPolygon", 32, 8, 4096, False),
    "LineStringLineString": ("LineStringLineString", 32, 8, 4096, False),
    "cand_overflow": ("PolygonPolygon", 3, 8, 4096, False),
    "pair_overflow": ("PolygonPolygon", 32, 1, 4096, False),
    "cand_above_m": ("PolygonLineString", 200, 200, 4096, False),
    "approx": ("PolygonPolygon", 32, 8, 4096, True),
}


@pytest.mark.parametrize("case", list(GEOM_PRUNED_CASES))
def test_geometry_pruned_kernel_matches_jax(case):
    pair, cand, pair_cap, max_pairs, approx = GEOM_PRUNED_CASES[case]
    akind, bkind = KINDS[pair]
    a, b = _geom_kernel_inputs(9, akind, bkind)
    ap, bp = akind == "polygon", bkind == "polygon"
    pick = 4 if approx else 3
    args = (a[0], a[1], a[2], a[pick], b[0], b[1], b[2], b[pick])
    want = jax.jit(jjoin.geometry_geometry_join_pruned_kernel,
                   static_argnames=("a_polygonal", "b_polygonal", "block",
                                    "cand", "max_pairs", "pair_cap",
                                    "approx"))(
        *map(jnp.asarray, args), R, a_polygonal=ap, b_polygonal=bp,
        block=32, cand=cand, max_pairs=max_pairs, pair_cap=pair_cap,
        approx=approx)
    got = tjoin.geometry_geometry_join_pruned_kernel(
        *map(_t, args), R, a_polygonal=ap, b_polygonal=bp, block=32,
        cand=cand, max_pairs=max_pairs, pair_cap=pair_cap, approx=approx)
    if approx:
        from spatialflink_tpu_torch.ops.distances import (
            bbox_bbox_min_distance,
        )
        d = bbox_bbox_min_distance(_t(a[4])[:, None], _t(b[4])[None])
    else:
        d = tr.geometry_pair_distance(_t(a[0]), _t(a[1]), _t(b[0]),
                                      _t(b[1]), ap, bp)
    live = a[2][:, None] & b[2][None, :]
    _assert_margin(d.numpy(), live)
    _same_pruned(got, want)
    assert int(got.count) > 5
    if case == "cand_overflow":
        assert int(got.cand_overflow) > 0
    elif case == "pair_overflow":
        assert int(got.pair_overflow) > 0
    else:
        assert int(got.cand_overflow) == int(got.pair_overflow) == 0
        mask = (d <= np.float32(R)) & _t(live)
        li, ri = np.nonzero(mask.numpy())
        dense = {(int(i), int(j)): d.numpy()[i, j].view(np.uint32).item()
                 for i, j in zip(li, ri)}
        assert _pair_dict(got) == dense


@pytest.mark.parametrize("pair", list(KINDS))
def test_tiled_geometry_pair_distance_is_the_dense_one(pair):
    """The tiled form (B4 gathered both ways) equals the dense form (B4
    dense both ways) bit for bit at every tile's candidates, padding
    rows (no valid edge) at finfo.max."""
    akind, bkind = KINDS[pair]
    (av, ae, *_), (bv, be, *_) = _geom_kernel_inputs(13, akind, bkind,
                                                     la=90)
    ap, bp = akind == "polygon", bkind == "polygon"
    rng = np.random.default_rng(14)
    block, c = 32, 7
    nb = -(-len(av) // block)
    pad = nb * block - len(av)
    sav = np.concatenate([av, np.zeros((pad,) + av.shape[1:], np.float32)])
    sae = np.concatenate([ae, np.zeros((pad, ae.shape[1]), bool)])
    gids = rng.integers(0, len(bv), (nb, c)).astype(np.int32)
    got = tr.geometry_pair_distance_tiles(_t(sav), _t(sae), _t(bv), _t(be),
                                          _t(gids), ap, bp).numpy()
    dense = tr.geometry_pair_distance(_t(sav), _t(sae), _t(bv), _t(be), ap,
                                      bp).numpy()
    want = dense.reshape(nb, block, -1)[
        np.arange(nb)[:, None, None], np.arange(block)[None, :, None],
        gids[:, None, :]]
    assert np.array_equal(got.view(np.uint32), want.view(np.uint32))
    assert np.all(got.reshape(-1, c)[90:] == np.finfo(np.float32).max)


def test_tiled_geometry_pair_distance_keeps_c2():
    """Crossing edges with no vertex inside keep the reference's vertex
    distance (ROADMAP C2): the X of two open linestrings at 1.0, the plus
    of a 4 x 1 and a 1 x 4 rectangle at 1.5."""
    def lanes(chains, close):
        v = np.zeros((len(chains), 8, 2), np.float32)
        e = np.zeros((len(chains), 7), bool)
        for i, c in enumerate(chains):
            c = np.asarray(c, np.float32)
            if close:
                c = np.concatenate([c, c[:1]])
            v[i, :len(c)] = c
            v[i, len(c):] = c[-1]
            e[i, :len(c) - 1] = True
        return _t(v), _t(e)

    xa, xe = lanes([[(-1, 0), (1, 0)]], False)
    ya, ye = lanes([[(0, -1), (0, 1)]], False)
    d = tr.geometry_pair_distance_tiles(xa, xe, ya, ye,
                                        _t(np.zeros((1, 1), np.int32)))
    assert float(d[0, 0, 0]) == 1.0
    ha, he = lanes([[(-2, -0.5), (2, -0.5), (2, 0.5), (-2, 0.5)]], True)
    va, ve = lanes([[(-0.5, -2), (0.5, -2), (0.5, 2), (-0.5, 2)]], True)
    d = tr.geometry_pair_distance_tiles(ha, he, va, ve,
                                        _t(np.zeros((1, 1), np.int32)),
                                        True, True)
    assert float(d[0, 0, 0]) == 1.5


# ---------------------------------------------------------------------------
# Operators

POINT_CLASSES = ["PointPolygon", "PointLineString", "PolygonPoint",
                 "LineStringPoint"]
GEOM_CLASSES = list(KINDS)


def _ops(name, approx=False, **conf_kw):
    conf = dict(CONF, approximate_query=approx, **conf_kw)
    cls = f"{name}JoinQuery"
    return (getattr(tops, cls)(QueryConfiguration(**conf),
                               UniformGrid(**GRID16), device="cpu"),
            getattr(jops, cls)(JConf(**conf), JGrid(**GRID16)))


def _streams(name, seed, n=500, m=40, holes=False, g_t0=600):
    """(port left, port right, JAX left, JAX right) in each class's
    ``run`` order; the geometry stream starts ``g_t0`` ms after the
    points, so the first window is one-sided."""
    rng = np.random.default_rng(seed)
    if name in POINT_CLASSES:
        gkind = "polygon" if "Polygon" in name else "linestring"
        pts, jpts = _point_objs(rng, n)
        g, jg = _geom_objs(rng, m, gkind, t0=g_t0, holes=holes)
        if name.startswith("Point"):
            return pts, g, jpts, jg
        return g, pts, jg, jpts
    akind, bkind = KINDS[name]
    a, ja = _geom_objs(rng, 3 * m, akind, r_max=0.004, prefix="a")
    b, jb = _geom_objs(rng, m, bkind, t0=g_t0, holes=holes, prefix="b")
    return a, b, ja, jb


def _key(o):
    return (o.obj_id, o.timestamp)


def _same_run(got, want):
    assert len(got) == len(want) >= 3
    for g, w in zip(got, want):
        assert (g.start, g.end, g.overflow, g.window_count) == \
            (w.start, w.end, w.overflow, w.window_count)
        assert [(_key(a), _key(b)) for a, b, _ in g.pairs] == \
            [(_key(a), _key(b)) for a, b, _ in w.pairs]
        _same_dists([d for *_, d in g.pairs], [d for *_, d in w.pairs])
    return sum(len(g.pairs) for g in got)


def _same_soa(got, want):
    assert len(got) == len(want) >= 3
    for g, w in zip(got, want):
        assert g[:2] == w[:2] and g[5] == w[5]
        assert np.array_equal(g[2], w[2]) and np.array_equal(g[3], w[3])
        assert g[2].dtype == np.asarray(w[2]).dtype == np.int32
        _same_dists(g[4], np.asarray(w[4]))
        if g[5] == 0:  # one-sided: the JAX empties, float64 distances
            assert g[4].dtype == np.asarray(w[4]).dtype
    return sum(g[5] for g in got)


def _all_dists(name, left, right, op):
    """Every (left, right) window-independent exact distance, for the
    margin assertion."""
    grid = op.grid
    if name in POINT_CLASSES:
        pts, geoms = (left, right) if name.startswith("Point") else \
            (right, left)
        verts, ev, gvalid, _, _ = _lanes(grid, geoms)
        pxy = center_coords(grid, np.array([[p.x, p.y] for p in pts]))
        return tjoin.point_geometry_join_kernel(
            _t(pxy), _t(np.ones(len(pts), bool)), _t(verts), _t(ev),
            _t(gvalid), R, polygonal="Polygon" in name)[1].numpy()
    av, ae, avalid, _, _ = _lanes(grid, left)
    bv, be, bvalid, _, _ = _lanes(grid, right)
    d = tr.geometry_pair_distance(_t(av), _t(ae), _t(bv), _t(be),
                                  op.left_polygonal, op.right_polygonal)
    return d.numpy()[:len(left), :len(right)]


@pytest.mark.parametrize("name", POINT_CLASSES + GEOM_CLASSES)
def test_run_matches_jax(name):
    left, right, jleft, jright = _streams(name, 21, holes=True)
    op, jop = _ops(name)
    _assert_margin(_all_dists(name, left, right, op), True)
    got = list(op.run(iter(left), iter(right), R))
    want = list(jop.run(iter(jleft), iter(jright), R, dtype=np.float32))
    assert _same_run(got, want) > 20
    assert got[0].pairs == []  # one-sided
    if name == "PolygonPoint":
        assert isinstance(got[1].pairs[0][0], Polygon)
        assert isinstance(got[1].pairs[0][1], Point)


@pytest.mark.parametrize("name", POINT_CLASSES + GEOM_CLASSES)
def test_run_soa_matches_jax(name):
    left, right, _, _ = _streams(name, 23, holes=True)
    op, jop = _ops(name)
    _assert_margin(_all_dists(name, left, right, op), True)

    def chunks(objs):
        if isinstance(objs[0], Point):
            return _point_chunks(objs)
        return _ragged_chunks(objs, edges=True)

    # run_soa takes the point chunks first in every point class
    # (PolygonPoint's and LineStringPoint's included, unswapped).
    if name in POINT_CLASSES and not name.startswith("Point"):
        left, right = right, left
    got = list(op.run_soa(chunks(left), chunks(right), R))
    want = list(jop.run_soa(chunks(left), chunks(right), R,
                            dtype=np.float32))
    assert _same_soa(got, want) > 20
    assert got[0][5] == 0 and len(got[0][2]) == 0


@pytest.mark.parametrize("name", ["PointPolygon", "PolygonPoint",
                                  "PointLineString", "LineStringPoint",
                                  "PolygonPolygon", "LineStringLineString"])
def test_approximate_modes_match_jax(name):
    """Emit-all for the point-ordinary classes (every grid candidate, at
    distance 0), the point → bbox distance for PolygonPoint and
    LineStringPoint, bbox ↔ bbox for the geometry classes."""
    left, right, jleft, jright = _streams(name, 25, n=300, m=25)
    op, jop = _ops(name, approx=True)
    got = list(op.run(iter(left), iter(right), R))
    want = list(jop.run(iter(jleft), iter(jright), R, dtype=np.float32))
    n = _same_run(got, want)
    assert n > 20
    dists = [d for w in got for *_, d in w.pairs]
    if name.startswith("Point"):
        assert set(dists) == {0.0}
    else:
        assert 0 < max(dists) <= np.float32(R)


def test_point_inside_polygon_is_at_zero():
    """A point inside a polygon joins at distance 0; one outside, beyond
    the radius, does not."""
    sq = np.array([[116.5, 40.3], [116.6, 40.3], [116.6, 40.4],
                   [116.5, 40.4], [116.5, 40.3]])
    pts = [(116.55, 40.35, "in"), (116.7, 40.5, "out")]
    port = (
        [Point(obj_id=o, timestamp=i, x=x, y=y)
         for i, (x, y, o) in enumerate(pts)],
        [Polygon(obj_id="g", timestamp=0, rings=[sq])])
    jx = ([JPoint(obj_id=o, timestamp=i, x=x, y=y)
           for i, (x, y, o) in enumerate(pts)],
          [JPolygon(obj_id="g", timestamp=0, rings=[sq])])
    op, jop = _ops("PointPolygon")
    got = list(op.run(iter(port[0]), iter(port[1]), R))
    want = list(jop.run(iter(jx[0]), iter(jx[1]), R, dtype=np.float32))
    assert [[(a.obj_id, b.obj_id, d) for a, b, d in w.pairs] for w in got] \
        == [[(a.obj_id, b.obj_id, d) for a, b, d in w.pairs]
            for w in want] == [[("in", "g", 0.0)], [("in", "g", 0.0)]]


@pytest.mark.parametrize("name,attr,start", [
    ("PointPolygon", "_cand", 1), ("PointPolygon", "_pair_cap", 1),
    ("PolygonPolygon", "_cand", 1), ("PolygonPolygon", "_pair_cap", 1),
    ("LineStringPoint", "_geom_max_pairs", 4),
])
def test_retries_grow_as_jax(name, attr, start):
    """A forced retry (the candidate width, the per-item cap or the pair
    budget started at ``start``) reaches the JAX results, and the port
    operator ends with the JAX operator's ``_cand``, ``_pair_cap`` and
    ``_geom_max_pairs``."""
    left, right, jleft, jright = _streams(name, 27, n=600, m=40)
    op, jop = _ops(name)
    # Stacked polygons: points inside many of them (the pair cap).
    if attr == "_pair_cap" and name == "PointPolygon":
        rings = [np.array([[-1, -1], [1, -1], [1, 1], [-1, 1], [-1, -1]])
                 * (0.01 + 0.002 * i) + CENTRE for i in range(8)]
        right = right + [Polygon(obj_id=f"s{i}", timestamp=400 + i,
                                 rings=[r]) for i, r in enumerate(rings)]
        jright = jright + [JPolygon(obj_id=f"s{i}", timestamp=400 + i,
                                    rings=[r]) for i, r in enumerate(rings)]
        right.sort(key=lambda o: o.timestamp)
        jright.sort(key=lambda o: o.timestamp)
    _assert_margin(_all_dists(name, left, right, op), True)
    setattr(op, attr, start)
    setattr(jop, attr, start)
    got = list(op.run(iter(left), iter(right), R))
    want = list(jop.run(iter(jleft), iter(jright), R, dtype=np.float32))
    assert _same_run(got, want) > 20
    state = [(o._cand, o._pair_cap, o._geom_max_pairs) for o in (op, jop)]
    assert state[0] == state[1]
    assert getattr(op, attr) > start


def test_one_sided_windows_yield_the_jax_empties():
    """Windows with one side only: ``run`` yields no pairs; ``run_soa``
    the JAX empty arrays (int32, int32, float64) and count 0, on either
    side."""
    rng = np.random.default_rng(31)
    pts, _ = _point_objs(rng, 50, t_span=900)
    geoms, _ = _geom_objs(rng, 5, "polygon", t0=3000, t_span=900)
    op, _ = _ops("PointPolygon", window_size=1.0, slide_step=1.0)
    res = list(op.run(iter(pts), iter(geoms), R))
    assert [(w.start, w.pairs, w.window_count) for w in res] == \
        [(0, [], 50), (3000, [], 5)]
    soa = list(op.run_soa(_point_chunks(pts), _ragged_chunks(geoms), R))
    assert [w[0] for w in soa] == [0, 3000]
    for w in soa:
        assert w[5] == 0 and w[2].dtype == w[3].dtype == np.int32
        assert w[4].dtype == np.float64 and len(w[4]) == 0
    early, _ = _geom_objs(rng, 5, "polygon", t_span=900)
    gop, _ = _ops("PolygonPolygon", window_size=1.0, slide_step=1.0)
    soa = list(gop.run_soa(_ragged_chunks(early), _ragged_chunks(geoms), R))
    assert [w[0] for w in soa] == [0, 3000]
    for w in soa:
        assert w[5] == 0 and w[2].dtype == w[3].dtype == np.int32
        assert w[4].dtype == np.float64 and len(w[4]) == 0


@pytest.mark.parametrize("name", ["PointPolygon", "PolygonPolygon"])
def test_mesh_raises(name):
    cls = getattr(tops, f"{name}JoinQuery")
    conf = QueryConfiguration(**CONF)
    with pytest.raises(NotImplementedError, match="A12"):
        cls(conf, UniformGrid(**GRID16), device="cpu", mesh=object())
    op = cls(conf, UniformGrid(**GRID16), device="cpu")
    with pytest.raises(NotImplementedError, match="A12"):
        list(op.run([], [], R, mesh=object()))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            cls(conf, UniformGrid(**GRID16))
