"""The port's standing-query bucket program
(``spatialflink_tpu_torch/ops/query_registry.py``) and the kNN core's
absent sentinel (``ops/knn.py``), against the JAX package on the CPU.

Inputs come from numpy seeds and go through both packages with the same
dtypes. Contracts:

- the absent sentinel is the distance dtype's max: a float64
  ``knn_points_fused`` and ``knn_multi_query_kernel`` equal the JAX
  package's in every one of the ``k`` slots, empty slots included, and
  the float32 results stay bit-equal;
- ``registry_bucket_kernel`` against the JAX program, lane by lane:
  segment, index, ``num_valid`` and ``within`` exact, distances within
  1 ulp (the JAX jitted distance may contract x² + y² into an FMA) or
  bit-equal on a lattice; padded lanes empty at every rung of
  ``capacity_ladder(1024, 8)``, and a live lane's result the same at
  every rung;
- within the port, the bucket program's lane equals
  ``registry_bucket_query`` for that query alone and
  ``knn_points_fused`` with its own flag table, bit for bit;
- a float64 radius is compared in float64 against float32 distances, as
  the JAX program compares it under x64: a point at float32 distance
  f32(r) > r is out of the bucket program and in the single-query
  program given r as a Python float, in both packages.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spatialflink_tpu import overload as jov
from spatialflink_tpu import qserve as jqs
from spatialflink_tpu import slo as jslo
from spatialflink_tpu.ops import knn as jknn
from spatialflink_tpu.ops import query_registry as jqr
from spatialflink_tpu.telemetry import telemetry as jtel

from spatialflink_tpu_torch import overload as tov
from spatialflink_tpu_torch import qserve as tqs
from spatialflink_tpu_torch import slo as tslo
from spatialflink_tpu_torch.grid import UniformGrid
from spatialflink_tpu_torch.ops import knn as tknn
from spatialflink_tpu_torch.ops import query_registry as tqr
from spatialflink_tpu_torch.ops.compaction import capacity_ladder
from spatialflink_tpu_torch.telemetry import telemetry

GRID = UniformGrid(10, 0.0, 10.0, 0.0, 10.0)
NSEG = 64


@pytest.fixture(autouse=True)
def _clean():
    yield
    for tel, mods in ((jtel, (jqs, jov, jslo)),
                      (telemetry, (tqs, tov, tslo))):
        for mod in mods:
            mod.uninstall()
        tel.enable()
        tel.disable()


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _inputs(seed, dtype=np.float32, n=256, n_obj=40, lattice=False):
    rng = np.random.default_rng(seed)
    if lattice:
        # Coordinates on a 1/64 lattice: x² + y² is exact, so an FMA
        # cannot round it differently.
        xy = rng.integers(0, 640, (n, 2)) / 64.0
    else:
        xy = rng.uniform(0, 10, (n, 2))
    oid = rng.integers(0, n_obj, n).astype(np.int32)
    cell = GRID.assign_cells_np(xy).astype(np.int32)
    valid = np.ones(n, bool)
    valid[rng.random(n) < 0.05] = False
    return xy.astype(dtype), valid, cell, oid


def _queries(seed, q, dtype=np.float32, lattice=False):
    rng = np.random.default_rng(seed)
    if lattice:
        qxy = rng.integers(64, 576, (q, 2)) / 64.0
    else:
        qxy = rng.uniform(1, 9, (q, 2))
    radius = rng.uniform(0.5, 2.5, q)
    tables = np.stack([
        GRID.neighbor_flags(float(radius[i]),
                            [GRID.flat_cell(float(qxy[i, 0]),
                                            float(qxy[i, 1]))])
        for i in range(q)]).astype(np.uint8)
    return qxy.astype(dtype), radius, tables


def _jax_bucket(xy, valid, cell, tables, oid, qxy, radius, qvalid, k,
                block):
    return jax.jit(jqr.registry_bucket_kernel,
                   static_argnames=("k", "num_segments", "query_block"))(
        jnp.asarray(xy), jnp.asarray(valid), jnp.asarray(cell),
        jnp.asarray(tables), jnp.asarray(oid), jnp.asarray(qxy),
        jnp.asarray(radius), jnp.asarray(qvalid), k=k, num_segments=NSEG,
        query_block=block)


def _port_bucket(xy, valid, cell, tables, oid, qxy, radius, qvalid, k,
                 block):
    return tqr.registry_bucket_kernel(
        _t(xy), _t(valid), _t(cell), _t(tables), _t(oid), _t(qxy),
        _t(radius), _t(qvalid), k=k, num_segments=NSEG, query_block=block)


def _within_ulp(a, b):
    a, b = np.asarray(a), np.asarray(b)
    with np.errstate(over="ignore"):  # the spacing of the max is inf
        ulp = np.spacing(np.maximum(np.abs(a), np.abs(b)))
    return bool(np.all((a == b) | (np.abs(a - b) <= ulp)))


def _assert_rows_agree(j, t, lanes, exact_dist=False):
    for f in ("segment", "index", "num_valid", "within"):
        np.testing.assert_array_equal(np.asarray(getattr(j, f))[lanes],
                                      getattr(t, f).numpy()[lanes],
                                      err_msg=f)
    jd, td = np.asarray(j.dist)[lanes], t.dist.numpy()[lanes]
    assert jd.dtype == td.dtype
    if exact_dist:
        np.testing.assert_array_equal(jd.view(np.uint8), td.view(np.uint8))
    else:
        assert _within_ulp(jd, td)


# -- C7: the absent sentinel follows the distance dtype -------------------


def _sparse_case(dtype):
    """Few objects in radius, so most of the k slots stay empty."""
    xy, valid, cell, oid = _inputs(5, dtype, lattice=True)
    qxy, _, _ = _queries(6, 3, dtype, lattice=True)
    radius = 0.75
    tables = np.stack([GRID.neighbor_flags(radius, [GRID.flat_cell(
        float(x), float(y))]) for x, y in qxy]).astype(np.uint8)
    return xy, valid, cell, oid, qxy, radius, tables


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_knn_points_fused_equals_jax_in_every_slot(dtype):
    xy, valid, cell, oid, qxy, radius, tables = _sparse_case(dtype)
    k = 16
    for i in range(len(qxy)):
        j = jknn.knn_points_fused(
            jnp.asarray(xy), jnp.asarray(valid), jnp.asarray(cell),
            jnp.asarray(tables[i]), jnp.asarray(oid), jnp.asarray(qxy[i]),
            radius, k=k, num_segments=NSEG)
        t = tknn.knn_points_fused(_t(xy), _t(valid), _t(cell), _t(tables[i]),
                                  _t(oid), _t(qxy[i]), radius, k, NSEG)
        jd, td = np.asarray(j.dist), t.dist.numpy()
        assert jd.dtype == td.dtype == dtype
        nv = int(t.num_valid)
        assert 0 < nv < k  # live and empty slots both present
        np.testing.assert_array_equal(td[nv:], np.finfo(dtype).max)
        np.testing.assert_array_equal(jd.view(np.uint8), td.view(np.uint8))
        np.testing.assert_array_equal(np.asarray(j.segment), t.segment)
        np.testing.assert_array_equal(np.asarray(j.index), t.index)
        assert int(j.num_valid) == nv


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_knn_multi_query_kernel_equals_jax_in_every_slot(dtype):
    xy, valid, cell, oid, _, radius, _ = _sparse_case(dtype)
    qxy, _, _ = _queries(8, 8, dtype, lattice=True)
    tables = np.stack([GRID.neighbor_flags(radius, [GRID.flat_cell(
        float(x), float(y))]) for x, y in qxy]).astype(np.uint8)
    k = 16
    j = jknn.knn_multi_query_kernel(
        jnp.asarray(xy), jnp.asarray(valid), jnp.asarray(cell),
        jnp.asarray(tables), jnp.asarray(oid), jnp.asarray(qxy), radius,
        k=k, num_segments=NSEG, query_block=4)
    t = tknn.knn_multi_query_kernel(_t(xy), _t(valid), _t(cell), _t(tables),
                                    _t(oid), _t(qxy), radius, k, NSEG,
                                    query_block=4)
    jd, td = np.asarray(j.dist), t.dist.numpy()
    assert jd.dtype == td.dtype == dtype
    assert (td == np.finfo(dtype).max).any() and (t.num_valid > 0).all()
    np.testing.assert_array_equal(jd.view(np.uint8), td.view(np.uint8))
    np.testing.assert_array_equal(np.asarray(j.segment), t.segment)
    np.testing.assert_array_equal(np.asarray(j.index), t.index)
    np.testing.assert_array_equal(np.asarray(j.num_valid), t.num_valid)


def test_float64_digest_pads_absent_objects_with_the_float64_max():
    xy, valid, cell, oid, qxy, radius, tables = _sparse_case(np.float64)
    d = tknn.knn_pane_digest(_t(xy), _t(valid), _t(cell), _t(tables[0]),
                             _t(oid), _t(qxy[0]), radius, 0, NSEG)
    jd = jknn.knn_pane_digest(
        jnp.asarray(xy), jnp.asarray(valid), jnp.asarray(cell),
        jnp.asarray(tables[0]), jnp.asarray(oid), jnp.asarray(qxy[0]),
        radius, 0, num_segments=NSEG)
    np.testing.assert_array_equal(np.asarray(jd.seg_min), d.seg_min)
    np.testing.assert_array_equal(np.asarray(jd.rep), d.rep)
    assert tknn.absent_dist(torch.float64) == np.finfo(np.float64).max
    assert tknn.absent_dist(torch.float32) == tknn.F32_BIG


# -- the bucket program against the JAX program ---------------------------


@pytest.mark.parametrize("dtype,lattice", [
    (np.float32, False), (np.float64, False), (np.float32, True),
])
def test_bucket_kernel_matches_jax_lane_by_lane(dtype, lattice):
    xy, valid, cell, oid = _inputs(11, dtype, lattice=lattice)
    qxy, radius, tables = _queries(12, 16, dtype, lattice=lattice)
    qvalid = np.arange(16) < 11
    j = _jax_bucket(xy, valid, cell, tables, oid, qxy, radius, qvalid, 8, 8)
    t = _port_bucket(xy, valid, cell, tables, oid, qxy, radius, qvalid, 8, 8)
    assert (t.within[:11] > 8).any()  # some lanes are truncated
    _assert_rows_agree(j, t, slice(None), exact_dist=lattice)
    for f in ("segment", "index", "num_valid", "within"):
        assert getattr(t, f).dtype == torch.int32, f


def test_bucket_kernel_bit_matches_sequential_evaluation(rng):
    """A lane of the bucket program equals ``registry_bucket_query`` for
    that query alone, bit for bit, in both packages' terms; padded lanes
    are empty."""
    xy, valid, cell, oid = _inputs(21)
    qxy, radius, tables = _queries(22, 8)
    qvalid = np.arange(8) < 6
    res = _port_bucket(xy, valid, cell, tables, oid, qxy, radius, qvalid, 8,
                       8)
    jsingle = jax.jit(jqr.registry_bucket_query,
                      static_argnames=("k", "num_segments"))
    for i in range(8):
        d, seg, idx, nv, within = tqr.registry_bucket_query(
            _t(xy), _t(valid), _t(cell), _t(tables[i]), _t(oid), _t(qxy[i]),
            _t(radius[i]), bool(qvalid[i]), k=8, num_segments=NSEG)
        np.testing.assert_array_equal(res.dist[i].numpy().view(np.uint32),
                                      d.numpy().view(np.uint32))
        np.testing.assert_array_equal(res.segment[i], seg)
        np.testing.assert_array_equal(res.index[i], idx)
        assert int(res.num_valid[i]) == int(nv)
        assert int(res.within[i]) == int(within)
        jd, jseg, jidx, jnv, jwithin = jsingle(
            jnp.asarray(xy), jnp.asarray(valid), jnp.asarray(cell),
            jnp.asarray(tables[i]), jnp.asarray(oid), jnp.asarray(qxy[i]),
            jnp.asarray(radius[i]), jnp.asarray(qvalid[i]), k=8,
            num_segments=NSEG)
        np.testing.assert_array_equal(np.asarray(jseg), seg)
        np.testing.assert_array_equal(np.asarray(jidx), idx)
        assert int(jnv) == int(nv) and int(jwithin) == int(within)
        assert _within_ulp(np.asarray(jd), d.numpy())
    for i in range(6, 8):
        assert int(res.num_valid[i]) == 0 and int(res.within[i]) == 0
        assert bool((res.segment[i] == -1).all())
        assert bool((res.index[i] == -1).all())
        assert bool((res.dist[i] == tknn.F32_BIG).all())


def test_bucket_kernel_vs_operator_kernel_fusion_contract():
    """Against ``knn_points_fused`` with the query's own flag table:
    winners, indices, counts and distances equal, bit for bit (the port
    runs the same elementwise distance in both)."""
    from spatialflink_tpu_torch.models.objects import Point
    from spatialflink_tpu_torch.operators.base import flags_for_queries

    xy, valid, cell, oid = _inputs(31)
    qxy, radius, _ = _queries(32, 5)
    qs = [tqs.StandingQuery(qid=f"q{i}", tenant="t", kind="knn",
                            x=float(x), y=float(y), radius=float(r), k=8)
          for i, ((x, y), r) in enumerate(zip(qxy, radius))]
    qxy, radius, qvalid, tables = tqs.bucket_host_arrays(GRID, qs, 8)
    res = _port_bucket(xy, valid, cell, tables, oid, qxy.astype(np.float32),
                       radius, qvalid, 8, 8)
    for i, q in enumerate(qs):
        ft = flags_for_queries(GRID, q.radius, [Point(x=q.x, y=q.y)])
        np.testing.assert_array_equal(ft, tables[i])
        ref = tknn.knn_points_fused(
            _t(xy), _t(valid), _t(cell), _t(ft), _t(oid),
            _t(np.float32([q.x, q.y])), _t(np.float64([q.radius])), 8, NSEG)
        np.testing.assert_array_equal(res.segment[i], ref.segment)
        np.testing.assert_array_equal(res.index[i], ref.index)
        np.testing.assert_array_equal(res.dist[i].numpy().view(np.uint32),
                                      ref.dist.numpy().view(np.uint32))
        assert int(res.num_valid[i]) == int(ref.num_valid)


def test_float64_radius_compares_in_float64_as_in_jax():
    """The point at float32 distance f32(r) > r: out under the float64
    radius (bucket program, both packages), in under the Python-float
    radius of the single-query program (float32 compare, both
    packages)."""
    r = 0.05
    assert np.float64(np.float32(r)) > r
    xy = np.zeros((8, 2), np.float32)
    xy[:, 0] = 3.0
    xy[0] = (np.float32(r), 0.0)  # distance exactly f32(r)
    xy[1] = (np.float32(0.01), 0.0)
    valid = np.ones(8, bool)
    cell = GRID.assign_cells_np(xy.astype(np.float64)).astype(np.int32)
    oid = np.arange(8, dtype=np.int32)
    qxy = np.zeros((8, 2), np.float32)
    radius = np.full(8, r)
    qvalid = np.ones(8, bool)
    tables = np.ones((8, GRID.num_cells + 1), np.uint8)
    tables[:, -1] = 0
    j = _jax_bucket(xy, valid, cell, tables, oid, qxy, radius, qvalid, 8, 8)
    t = _port_bucket(xy, valid, cell, tables, oid, qxy, radius, qvalid, 8, 8)
    assert int(t.within[0]) == int(j.within[0]) == 1
    assert int(t.segment[0, 0]) == 1
    _assert_rows_agree(j, t, slice(None), exact_dist=True)
    fused = tknn.knn_points_fused(_t(xy), _t(valid), _t(cell), _t(tables[0]),
                                  _t(oid), _t(qxy[0]), r, 8, NSEG)
    jfused = jknn.knn_points_fused(
        jnp.asarray(xy), jnp.asarray(valid), jnp.asarray(cell),
        jnp.asarray(tables[0]), jnp.asarray(oid), jnp.asarray(qxy[0]), r,
        k=8, num_segments=NSEG)
    assert int(fused.num_valid) == int(jfused.num_valid) == 2
    single = tqr.registry_bucket_query(
        _t(xy), _t(valid), _t(cell), _t(tables[0]), _t(oid), _t(qxy[0]),
        _t(radius)[0], True, k=8, num_segments=NSEG)
    assert int(single[4]) == 1  # a 0-d float64 radius still compares wide


@pytest.mark.parametrize("rung", capacity_ladder(1024, 8))
def test_padded_lanes_are_empty_and_change_no_live_lane(rung):
    """The rung moves with occupancy, so a live lane's result must be the
    same at every rung of ``capacity_ladder(1024, 8)`` and every padded
    lane empty, in both packages."""
    xy, valid, cell, oid = _inputs(41, n=128)
    live = 5
    qxy, radius, tables = _queries(42, live)
    pad = rung - live
    qxy_r = np.concatenate([qxy, np.full((pad, 2), 5.0, np.float32)])
    radius_r = np.concatenate([radius, np.full(pad, 9.0)])
    tables_r = np.concatenate([tables, np.ones((pad, tables.shape[1]),
                                               np.uint8)])
    qvalid = np.arange(rung) < live
    block = min(rung, 32)
    t = _port_bucket(xy, valid, cell, tables_r, oid, qxy_r, radius_r, qvalid,
                     8, block)
    ref = _port_bucket(xy, valid, cell, tables_r[:8], oid, qxy_r[:8],
                       radius_r[:8], qvalid[:8], 8, 8)
    for f in ("dist", "segment", "index", "num_valid", "within"):
        np.testing.assert_array_equal(getattr(t, f)[:live],
                                      getattr(ref, f)[:live], err_msg=f)
    assert bool((t.num_valid[live:] == 0).all())
    assert bool((t.within[live:] == 0).all())
    assert bool((t.segment[live:] == -1).all())
    assert bool((t.index[live:] == -1).all())
    assert bool((t.dist[live:] == tknn.F32_BIG).all())
    j = _jax_bucket(xy, valid, cell, tables_r, oid, qxy_r, radius_r, qvalid,
                    8, block)
    _assert_rows_agree(j, t, slice(None))


def test_bucket_kernel_contract_errors():
    xy, valid, cell, oid = _inputs(51)
    qxy, radius, tables = _queries(52, 8)
    qvalid = np.ones(8, bool)
    with pytest.raises(ValueError, match="query_block"):
        _port_bucket(xy, valid, cell, tables, oid, qxy, radius, qvalid, 8, 3)
    with pytest.raises(ValueError, match="k argument to top_k"):
        tqr.registry_bucket_kernel(
            _t(xy), _t(valid), _t(cell), _t(tables), _t(oid), _t(qxy),
            _t(radius), _t(qvalid), k=128, num_segments=NSEG, query_block=8)


def test_ids_beyond_the_segments_are_dropped():
    xy, valid, cell, oid = _inputs(61)
    oid[::7] = NSEG + 3
    qxy, radius, tables = _queries(62, 8)
    qvalid = np.ones(8, bool)
    t = _port_bucket(xy, valid, cell, tables, oid, qxy, radius, qvalid, 8, 8)
    keep = oid < NSEG
    t2 = _port_bucket(xy, valid & keep, cell, tables, oid % NSEG, qxy,
                      radius, qvalid, 8, 8)
    for f in ("dist", "segment", "index", "num_valid", "within"):
        np.testing.assert_array_equal(getattr(t, f), getattr(t2, f),
                                      err_msg=f)


def test_range_bucket_overflow_counter():
    within = torch.tensor([3, 8, 12, 0], dtype=torch.int32)
    assert int(tqr.range_bucket_overflow(within, 8)) == 4
    assert int(jqr.range_bucket_overflow(jnp.asarray([3, 8, 12, 0]), 8)) == 4
