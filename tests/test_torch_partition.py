"""Parity of the port's grid-partitioned layer (``parallel/partition.py``,
``ops/halo.py``, ``parallel/halo.py``) with the JAX package's, on the CPU.

``tests/test_partition.py`` is the oracle, case by case. The port's mesh
lists the CPU eight times (``devices=["cpu"] * 8``); the JAX side runs on
the test configuration's eight virtual CPU devices (``tests/conftest.py``).
The same numpy inputs, made from a seed, go through both, their dtype
pinned (float64 unless a case says float32).

Contracts held:
- the planner and the layouts are the JAX package's, array for array and
  error text for error text, and a plan serialises to the same dict;
- within the port, every halo wrapper on the eight-shard mesh is
  bit-equal to its single-device ``ops/halo.py`` kernel;
- against the JAX wrappers: keep masks and pair sets equal, distances
  within 1 ulp of their dtype (a compiled JAX program may contract
  dx² + dy² into a fused multiply-add); the registry cases run on a 1/64
  lattice, where x² + y² is exact, and are equal outright;
- the collective and halo-state gauges and the shard watermarks equal
  the JAX package's after the same calls; the halo moves at most a
  quarter of the replicated paths' broadcast and all-gather bytes.
"""

import functools
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spatialflink_tpu.grid import UniformGrid as JGrid
from spatialflink_tpu.ops import halo as jhalo_ops
from spatialflink_tpu.parallel import halo as jhalo
from spatialflink_tpu.parallel import mesh as jmesh_mod
from spatialflink_tpu.parallel import partition as jpart
from spatialflink_tpu.telemetry import telemetry as jtel

from spatialflink_tpu_torch.grid import UniformGrid
from spatialflink_tpu_torch.ops import halo as thalo_ops
from spatialflink_tpu_torch.parallel import halo as thalo
from spatialflink_tpu_torch.parallel import mesh as tmesh
from spatialflink_tpu_torch.parallel import partition as tpart
from spatialflink_tpu_torch.telemetry import telemetry

GRID = UniformGrid(64, 0.0, 1.0, 0.0, 1.0)
JGRID = JGrid(64, 0.0, 1.0, 0.0, 1.0)
RADIUS = 0.012  # one candidate layer on GRID: halo width 65
BEIJING = dict(num_partitions=1024, min_x=115.5, max_x=117.6, min_y=39.6,
               max_y=41.1)


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Two intra-op threads while this module runs (its shards are many
    small ops, and the suite's workers share the host's cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def mesh():
    return tmesh.data_mesh(8, devices=["cpu"] * 8)


@pytest.fixture(scope="module")
def jmesh():
    assert len(jax.devices()) >= 8, "conftest must provide 8 devices"
    return jmesh_mod.data_mesh(8)


@pytest.fixture
def both_telemetry():
    """Both packages' telemetry on and reset around the test."""
    for tel in (telemetry, jtel):
        tel.enable()
        tel.disable()
        tel.enable()
    try:
        yield
    finally:
        for tel in (telemetry, jtel):
            tel.enable()
            tel.disable()


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _cloud(rng, n, dtype=np.float64, lattice=False):
    if lattice:
        xy = rng.integers(0, 64, (n, 2)) / 64.0
    else:
        xy = rng.uniform(0.0, 1.0, (n, 2))
    xy = xy.astype(dtype)
    return xy, GRID.assign_cells_np(xy), np.ones(n, bool)


def _within_ulp(a, b):
    """Equal within 1 ulp of their own dtype."""
    a, b = np.asarray(a), np.asarray(b)
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    same = a == b
    ulp = np.spacing(np.maximum(np.abs(a[~same]), np.abs(b[~same])))
    return bool(np.all(np.abs(a[~same] - b[~same]) <= ulp))


def _near_radius(d, radius):
    """Distances within 1 ulp of the radius: where an FMA may move a
    point across it (reported, never reseeded)."""
    d = np.asarray(d)
    return int(np.sum(np.abs(d - radius) <= np.spacing(np.abs(d))))


# -- the planner --------------------------------------------------------------


def test_plan_contiguous_cover_and_balance():
    plan = tpart.plan_partition(GRID, 8, RADIUS)
    assert plan.bounds[0] == 0 and plan.bounds[-1] == GRID.num_cells
    widths = plan.shard_widths()
    assert (widths > 0).all()
    assert (widths == GRID.num_cells // 8).all()  # uniform occupancy
    assert plan.halo == tpart.halo_width(GRID.n, plan.layers) == 65
    assert plan.to_dict() == jpart.plan_partition(JGRID, 8, RADIUS).to_dict()


def test_plan_occupancy_balancing_with_min_width_clamp():
    occ = np.zeros(GRID.num_cells)
    occ[:100] = 1.0  # all live mass in the first 100 cells
    plan = tpart.plan_partition(GRID, 8, RADIUS, occupancy=occ)
    assert (plan.shard_widths() >= plan.halo).all()
    assert plan.bounds[1] <= 100 + plan.halo
    np.testing.assert_array_equal(
        plan.bounds,
        jpart.plan_partition(JGRID, 8, RADIUS, occupancy=occ).bounds)
    # The sentinel bucket of the compaction planner's counts carries no
    # weight; the plan is the JAX package's either way.
    occ1 = np.concatenate([occ, [1e6]])
    assert tpart.plan_partition(GRID, 8, RADIUS, occ1).to_dict() == \
        jpart.plan_partition(JGRID, 8, RADIUS, occ1).to_dict()


def test_plan_infeasible_raises():
    with pytest.raises(ValueError, match="finer grid or fewer shards") as t:
        tpart.plan_partition(UniformGrid(8, 0.0, 1.0, 0.0, 1.0), 8, 0.5)
    with pytest.raises(ValueError) as j:
        jpart.plan_partition(JGrid(8, 0.0, 1.0, 0.0, 1.0), 8, 0.5)
    assert str(t.value) == str(j.value)
    with pytest.raises(ValueError, match="n_shards must be >= 1"):
        tpart.plan_partition(GRID, 0, RADIUS)


def test_plan_shard_of_sentinel_goes_last():
    plan = tpart.plan_partition(GRID, 8, RADIUS)
    cells = np.array([0, plan.bounds[1] - 1, plan.bounds[1],
                      GRID.num_cells - 1, GRID.num_cells])
    np.testing.assert_array_equal(plan.shard_of(cells), [0, 0, 1, 7, 7])
    assert plan.shard_of(cells).dtype == np.int32


def _bad_dicts(d):
    bad = list(d["bounds"])
    bad[1], bad[2] = bad[2], bad[1]
    return [
        ("unknown keys", {**d, "surprise": 1}),
        ("missing keys", {k: v for k, v in d.items() if k != "bounds"}),
        ("version", {**d, "version": tpart.PLAN_VERSION + 1}),
        ("does not match", {**d, "n_shards": 4}),
        ("monotone", {**d, "bounds": bad}),
        ("must be a dict", [1, 2]),
    ]


def test_plan_dict_roundtrip_and_validation():
    plan = tpart.plan_partition(GRID, 8, RADIUS)
    d = plan.to_dict()
    back = tpart.PartitionPlan.from_dict(d)
    assert back.n_shards == plan.n_shards and back.halo == plan.halo
    np.testing.assert_array_equal(back.bounds, plan.bounds)
    # Plans cross packages both ways.
    assert jpart.PartitionPlan.from_dict(d).to_dict() == d
    assert tpart.PartitionPlan.from_dict(
        jpart.plan_partition(JGRID, 8, RADIUS).to_dict()).to_dict() == d
    assert tpart.PLAN_VERSION == jpart.PLAN_VERSION
    for match, bad in _bad_dicts(d):
        with pytest.raises(ValueError, match=match) as t:
            tpart.PartitionPlan.from_dict(bad)
        with pytest.raises(ValueError) as j:
            jpart.PartitionPlan.from_dict(bad)
        assert str(t.value) == str(j.value)


def test_shard_layout_rows_and_scatter_roundtrip(rng):
    plan = tpart.plan_partition(GRID, 8, RADIUS)
    xy, cell, valid = _cloud(rng, 1024)
    valid[::5] = False
    lay = tpart.shard_layout(plan, cell, valid)
    shard = plan.shard_of(cell)
    for s in range(8):
        rows = lay.own[s][lay.own[s] >= 0]
        expect = np.nonzero(valid & (shard == s))[0]
        np.testing.assert_array_equal(rows, expect)  # stable order
        lo, hi = plan.bounds[s], plan.bounds[s + 1]
        lrows = lay.left[s][lay.left[s] >= 0]
        assert (cell[lrows] < lo + plan.halo).all()
        rrows = lay.right[s][lay.right[s] >= 0]
        assert (cell[rrows] >= hi - plan.halo).all()
    assert lay.live_boundary_rows == int(
        (lay.left >= 0).sum() + (lay.right >= 0).sum())
    jlay = jpart.shard_layout(jpart.plan_partition(JGRID, 8, RADIUS), cell,
                              valid)
    assert (lay.cap, lay.halo_cap) == (jlay.cap, jlay.halo_cap)
    for name in ("own", "left", "right", "counts"):
        np.testing.assert_array_equal(getattr(lay, name),
                                      getattr(jlay, name))
    vals = tpart.gather_rows(lay.own, xy[:, 0], np.nan)
    back = tpart.scatter_rows(lay.own, vals, 1024, np.nan)
    np.testing.assert_array_equal(back[valid], xy[valid, 0])
    assert np.isnan(back[~valid]).all()
    np.testing.assert_array_equal(
        vals, jpart.gather_rows(jlay.own, xy[:, 0], np.nan))


def test_cell_layer_and_pair_layers_agree():
    rng = np.random.default_rng(3)
    a = rng.integers(0, GRID.num_cells, 200)
    b = rng.integers(0, GRID.num_cells, 200)
    got = thalo_ops.pair_layers(_t(a.astype(np.int32)),
                                _t(b.astype(np.int32)), GRID.n).numpy()
    want = [GRID.cell_layer(x, y) for x, y in zip(a, b)]
    assert got.tolist() == want == [JGRID.cell_layer(x, y)
                                    for x, y in zip(a, b)]


# -- mesh parity --------------------------------------------------------------


def _range_single(plan, xy, valid, cell, qxy, qcell, qok, radius,
                  approximate=False):
    keep, dist = thalo_ops.range_partitioned_kernel(
        _t(xy), _t(valid), _t(cell), _t(qxy), _t(qcell), _t(qok), radius,
        grid_n=plan.grid_n, layers=plan.layers, guaranteed=plan.guaranteed,
        approximate=approximate)
    return keep.numpy(), dist.numpy()


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_sharded_range_halo_bit_parity(mesh, jmesh, dtype):
    rng = np.random.default_rng(7)
    xy, cell, valid = _cloud(rng, 4096, dtype)
    valid[::7] = False
    qxy, qcell, qok = _cloud(rng, 512, dtype)
    plan = tpart.plan_partition(GRID, 8, RADIUS)
    keep, dist = thalo.sharded_range_halo(
        mesh, plan, xy, valid, cell, qxy, qcell, qok, RADIUS)
    keep1, dist1 = _range_single(plan, xy, valid, cell, qxy, qcell, qok,
                                 RADIUS)
    assert dist.dtype == dtype
    np.testing.assert_array_equal(keep, keep1)
    np.testing.assert_array_equal(dist, dist1)  # bitwise
    jkeep, jdist = jhalo.sharded_range_halo(
        jmesh, jpart.plan_partition(JGRID, 8, RADIUS), xy, valid, cell,
        qxy, qcell, qok, RADIUS)
    near = _near_radius(dist[keep], RADIUS)
    assert near == 0, f"{near} kept distances within 1 ulp of the radius"
    np.testing.assert_array_equal(keep, np.asarray(jkeep))
    assert _within_ulp(dist, np.asarray(jdist))
    assert 100 < keep.sum() < 4096


def test_sharded_range_halo_approximate_parity(mesh, jmesh):
    rng = np.random.default_rng(17)
    xy, cell, valid = _cloud(rng, 2048)
    qxy, qcell, qok = _cloud(rng, 256)
    plan = tpart.plan_partition(GRID, 8, RADIUS)
    keep, _ = thalo.sharded_range_halo(
        mesh, plan, xy, valid, cell, qxy, qcell, qok, RADIUS,
        approximate=True)
    keep1, _ = _range_single(plan, xy, valid, cell, qxy, qcell, qok, RADIUS,
                             approximate=True)
    np.testing.assert_array_equal(keep, keep1)
    jkeep, _ = jhalo.sharded_range_halo(
        jmesh, jpart.plan_partition(JGRID, 8, RADIUS), xy, valid, cell, qxy,
        qcell, qok, RADIUS, approximate=True)
    np.testing.assert_array_equal(keep, np.asarray(jkeep))


def test_range_partitioned_kernel_matches_jax_single():
    """The single-device kernel against the JAX kernel, jitted: with a
    guaranteed layer (a wider radius), padding query lanes and
    out-of-grid points."""
    rng = np.random.default_rng(29)
    xy = rng.uniform(-0.05, 1.05, (1024, 2))
    cell = GRID.assign_cells_np(xy)
    valid = rng.random(1024) > 0.1
    qxy, qcell, qok = _cloud(rng, 64)
    qok[::5] = False
    radius = 0.05
    plan = tpart.plan_partition(GRID, 4, radius)
    assert plan.guaranteed >= 0
    keep, dist = _range_single(plan, xy, valid, cell, qxy, qcell, qok,
                               radius)
    jkeep, jdist = jax.jit(functools.partial(
        jhalo_ops.range_partitioned_kernel, grid_n=GRID.n,
        layers=plan.layers, guaranteed=plan.guaranteed))(
        xy, valid, cell, qxy, qcell, qok, radius)
    np.testing.assert_array_equal(keep, np.asarray(jkeep))
    assert _within_ulp(dist, np.asarray(jdist))
    assert (dist == np.finfo(np.float64).max).any()


def _join_single(plan, lxy, lok, lcell, rxy, rok, rcell, radius, budget):
    out = thalo_ops.join_partitioned_kernel(
        _t(lxy), _t(lok), _t(lcell), _t(rxy), _t(rok), _t(rcell), radius,
        grid_n=plan.grid_n, layers=plan.layers, budget=budget)
    li, ri, dv, count, over = (o.numpy() for o in out)
    found = li >= 0
    li, ri, dv = li[found], ri[found], dv[found]
    order = np.lexsort((ri, li))
    return li[order], ri[order], dv[order], int(count), int(over)


def _same_pairs(got, want):
    li, ri, dv, count, over = got
    wli, wri, wdv, wcount, wover = want
    np.testing.assert_array_equal(li, np.asarray(wli))
    np.testing.assert_array_equal(ri, np.asarray(wri))
    assert (count, over) == (wcount, wover)
    return dv, np.asarray(wdv)


def test_sharded_join_halo_bit_parity(mesh, jmesh):
    rng = np.random.default_rng(11)
    lxy, lcell, lok = _cloud(rng, 2048)
    rxy, rcell, rok = _cloud(rng, 2048)
    lok[::9] = False
    plan = tpart.plan_partition(GRID, 8, RADIUS)
    got = thalo.sharded_join_halo(mesh, plan, lxy, lok, lcell, rxy, rok,
                                  rcell, RADIUS, 4096)
    one = _join_single(plan, lxy, lok, lcell, rxy, rok, rcell, RADIUS, 4096)
    dv, dv1 = _same_pairs(got, one)
    np.testing.assert_array_equal(dv, dv1)  # bitwise
    assert got[3] > 500 and got[4] == 0
    jgot = jhalo.sharded_join_halo(
        jmesh, jpart.plan_partition(JGRID, 8, RADIUS), lxy, lok, lcell, rxy,
        rok, rcell, RADIUS, 4096)
    dv, jdv = _same_pairs(got, jgot)
    assert _within_ulp(dv, jdv)


def test_sharded_join_halo_overflow_keeps_the_jax_lanes(mesh, jmesh):
    """A shard budget below the shards' pair counts: each shard keeps its
    first pairs in lane order (own lanes, then the left neighbour's, then
    the right's), so the kept pairs, the count and the overflow are the
    JAX wrapper's; the single-device kernel at the same budget keeps its
    own first pairs."""
    rng = np.random.default_rng(19)
    lxy, lcell, lok = _cloud(rng, 2048)
    rxy, rcell, rok = _cloud(rng, 2048)
    plan = tpart.plan_partition(GRID, 8, RADIUS)
    got = thalo.sharded_join_halo(mesh, plan, lxy, lok, lcell, rxy, rok,
                                  rcell, RADIUS, 64)
    jgot = jhalo.sharded_join_halo(
        jmesh, jpart.plan_partition(JGRID, 8, RADIUS), lxy, lok, lcell, rxy,
        rok, rcell, RADIUS, 64)
    dv, jdv = _same_pairs(got, jgot)
    assert _within_ulp(dv, jdv)
    assert got[4] > 0 and len(got[0]) == 8 * 64
    full = _join_single(plan, lxy, lok, lcell, rxy, rok, rcell, RADIUS, 8192)
    assert got[3] == full[3]  # the true count survives the budget
    cut = _join_single(plan, lxy, lok, lcell, rxy, rok, rcell, RADIUS, 64)
    assert (cut[3], cut[4], len(cut[0])) == (full[3], full[3] - 64, 64)


def _panes(rng, n_slides, slide_pts):
    out = []
    for _ in range(n_slides):
        xy, cell, ok = _cloud(rng, slide_pts)
        out.append((xy, ok, cell))
    return out


def test_sharded_tjoin_panes_halo_bit_parity(mesh, jmesh):
    rng = np.random.default_rng(13)
    n_slides, slide_pts, ppw = 4, 512, 2
    plan = tpart.plan_partition(GRID, 8, RADIUS)
    lp, rp = _panes(rng, n_slides, slide_pts), _panes(rng, n_slides,
                                                      slide_pts)
    ts = np.arange(n_slides, dtype=np.int64) * 100
    results = thalo.sharded_tjoin_panes_halo(mesh, plan, ts, lp, rp, RADIUS,
                                             ppw, 8192)
    jresults = jhalo.sharded_tjoin_panes_halo(
        jmesh, jpart.plan_partition(JGRID, 8, RADIUS), ts, lp, rp, RADIUS,
        ppw, 8192)
    assert len(results) == len(jresults) == n_slides
    for i, (got, jgot) in enumerate(zip(results, jresults)):
        lo = max(0, i - ppw + 1)
        lxy, lok, lcell = (np.concatenate([p[j] for p in lp[lo: i + 1]])
                           for j in range(3))
        rxy, rok, rcell = (np.concatenate([p[j] for p in rp[lo: i + 1]])
                           for j in range(3))
        one = _join_single(plan, lxy, lok, lcell, rxy, rok, rcell, RADIUS,
                           8192)
        dv, dv1 = _same_pairs(got, one)
        np.testing.assert_array_equal(dv, dv1)
        assert got[4] == 0 and got[3] > 0
        dv, jdv = _same_pairs(got, jgot)
        assert _within_ulp(dv, jdv)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_sharded_registry_bucket_halo_bit_parity(mesh, jmesh, dtype):
    rng = np.random.default_rng(11)
    xy, cell, valid = _cloud(rng, 2048, dtype, lattice=True)
    valid[::11] = False
    oid = rng.integers(0, 300, 2048).astype(np.int32)
    qxy, qcell, qok = _cloud(rng, 128, dtype, lattice=True)
    radius = 2.5 / 64  # the lattice's squared distances are exact
    rad = np.full(128, radius, dtype)
    plan = tpart.plan_partition(GRID, 8, radius)
    out = thalo.sharded_registry_bucket_halo(
        mesh, plan, xy, valid, cell, oid, qxy, qcell, rad, qok, k=8,
        num_segments=300)
    one = thalo_ops.registry_bucket_partitioned_kernel(
        _t(xy), _t(valid), _t(cell), _t(oid), _t(qxy), _t(qcell), _t(rad),
        _t(qok), grid_n=GRID.n, layers=plan.layers, k=8, num_segments=300)
    jout = jhalo.sharded_registry_bucket_halo(
        jmesh, jpart.plan_partition(JGRID, 8, radius), xy, valid, cell, oid,
        qxy, qcell, rad, qok, k=8, num_segments=300)
    for got, single, want in zip(out, one, jout):
        np.testing.assert_array_equal(got, single.numpy())  # bitwise
        np.testing.assert_array_equal(got, np.asarray(want))
    assert out[0].dtype == dtype
    assert out[3].sum() > 100 and (out[1] == -1).any()


def test_registry_kernel_ties_keep_the_lowest_segment():
    """Equal distances order lowest segment first (JAX's ``top_k``), and
    an absent slot is −1 at the dtype's max."""
    xy = np.array([[0.5, 0.5 + d] for d in (0.01, 0.01, 0.01, 0.02)])
    cell = GRID.assign_cells_np(xy)
    oid = np.array([9, 3, 7, 1], np.int32)
    q = np.array([[0.5, 0.5]])
    qcell = GRID.assign_cells_np(q)
    args = (xy, np.ones(4, bool), cell, oid, q, qcell, np.array([0.015]),
            np.ones(1, bool))
    dist, seg, nv, win = thalo_ops.registry_bucket_partitioned_kernel(
        *map(_t, args), grid_n=GRID.n, layers=1, k=5, num_segments=16)
    jd, js, jn, jw = jhalo_ops.registry_bucket_partitioned_kernel(
        *map(jnp.asarray, args), grid_n=GRID.n, layers=1, k=5,
        num_segments=16)
    assert seg.tolist() == np.asarray(js).tolist() == [[3, 7, 9, -1, -1]]
    np.testing.assert_array_equal(dist.numpy(), np.asarray(jd))
    assert dist[0, 3] == np.finfo(np.float64).max
    assert (int(nv[0]), int(win[0])) == (int(jn[0]), int(jw[0])) == (3, 3)


# -- collective traffic: the halo beats replication ---------------------------


def _gauges():
    return telemetry.snapshot()["collectives"], jtel.snapshot()["collectives"]


def _reset():
    for tel in (telemetry, jtel):
        tel.disable()
        tel.enable()


def test_range_halo_bytes_beat_broadcast_4x(mesh, jmesh, both_telemetry):
    from spatialflink_tpu.parallel.sharded import sharded_range_query as jrq
    from spatialflink_tpu_torch.parallel.sharded import sharded_range_query

    grid = UniformGrid(**BEIJING)
    jgrid = JGrid(**BEIJING)
    radius = 0.002  # one layer: the boundary region is ~1.6% of the grid
    rng = np.random.default_rng(47)
    n, nq = 8192, 4096
    xy = np.stack([rng.uniform(115.5, 117.6, n),
                   rng.uniform(39.6, 41.1, n)], axis=1)
    qxy = np.stack([rng.uniform(115.6, 117.5, nq),
                    rng.uniform(39.7, 41.0, nq)], axis=1)
    cell = grid.assign_cells_np(xy)
    qcell = grid.assign_cells_np(qxy)
    ok, qok = np.ones(n, bool), np.ones(nq, bool)
    plan = tpart.plan_partition(grid, 8, radius)
    keep_h, _ = thalo.sharded_range_halo(mesh, plan, xy, ok, cell, qxy,
                                         qcell, qok, radius)
    jhalo.sharded_range_halo(jmesh, jpart.plan_partition(jgrid, 8, radius),
                             xy, ok, cell, qxy, qcell, qok, radius)
    coll, jcoll = _gauges()
    assert coll == jcoll
    halo_bytes = coll["by_kind"]["ppermute"]["bytes"]
    assert coll["halo_state_bytes"] > 0
    _reset()
    table = grid.neighbor_flags(radius, [int(c) for c in qcell])
    keep_l, _ = sharded_range_query(mesh, _t(xy), _t(ok),
                                    _t(table[cell]), _t(qxy), radius)
    jrq(jmesh, xy, ok, table[cell], qxy, radius)
    legacy, jlegacy = _gauges()
    assert legacy == jlegacy
    assert legacy["bytes"] == nq * 2 * xy.dtype.itemsize  # the broadcast
    assert halo_bytes * 4 <= legacy["bytes"], (halo_bytes, legacy["bytes"])
    # The same answer set on this geometry: a traffic win that changed
    # results would be a miscount.
    assert int(keep_h.sum()) == int(keep_l.numpy().sum())


def test_tjoin_halo_bytes_beat_all_gather_4x(mesh, jmesh, both_telemetry):
    from spatialflink_tpu_torch.operators.base import center_coords
    from spatialflink_tpu_torch.ops import tjoin_panes as ttp
    from spatialflink_tpu_torch.parallel.sharded import (
        sharded_tjoin_pane_scan,
    )

    beijing = dict(BEIJING, num_partitions=256)
    grid = UniformGrid(**beijing)
    radius = 0.005
    n_slides, slide_pts, ppw, n_obj = 3, 512, 2, 64
    total = n_slides * slide_pts
    rng = np.random.default_rng(53)

    def side():
        sxy = np.stack([rng.uniform(115.5, 117.6, total),
                        rng.uniform(39.6, 41.1, total)], axis=1)
        return sxy, grid.assign_cells_np(sxy), \
            rng.integers(0, n_obj, total).astype(np.int32)

    (lxy, lcell, loid), (rxy, rcell, roid) = side(), side()
    ok = np.ones(slide_pts, bool)
    plan = tpart.plan_partition(grid, 8, radius)

    def panes_of(sxy, scell):
        return [(sxy[i * slide_pts:(i + 1) * slide_pts], ok,
                 scell[i * slide_pts:(i + 1) * slide_pts])
                for i in range(n_slides)]

    ts = np.arange(n_slides, dtype=np.int64) * 1000
    thalo.sharded_tjoin_panes_halo(mesh, plan, ts, panes_of(lxy, lcell),
                                   panes_of(rxy, rcell), radius, ppw, 16384)
    jhalo.sharded_tjoin_panes_halo(
        jmesh, jpart.plan_partition(JGrid(**beijing), 8, radius), ts,
        panes_of(lxy, lcell), panes_of(rxy, rcell), radius, ppw, 16384)
    coll, jcoll = _gauges()
    assert coll == jcoll
    halo_bytes = coll["by_kind"]["ppermute"]["bytes"]
    _reset()

    def side_fields(sxy, scell, soid):
        cxy = center_coords(grid, sxy, np.float32)
        ci = grid.cell_xy_indices_np(sxy)
        ing = scell < grid.num_cells
        rank = ttp.pane_cell_ranks(np.repeat(np.arange(n_slides), slide_pts),
                                   scell, valid=ing)
        host = (cxy[:, 0].astype(np.float32), cxy[:, 1].astype(np.float32),
                ci[:, 0], ci[:, 1], np.where(ing, scell, 0).astype(np.int32),
                rank.astype(np.int32), soid, ing)
        return tuple(_t(a.reshape(n_slides, slide_pts)) for a in host)

    carry = ttp.tjoin_pane_init(grid.num_cells, 8, ppw, n_obj, device="cpu")
    sharded_tjoin_pane_scan(
        mesh, carry, torch.arange(n_slides), side_fields(lxy, lcell, loid),
        side_fields(rxy, rcell, roid), np.float32(radius), grid_n=grid.n,
        cap_w=8, layers=grid.candidate_layers(radius), ppw=ppw,
        num_ids=n_obj, pair_sel=16)
    legacy = telemetry.snapshot()["collectives"]
    legacy_bytes = legacy["by_kind"]["all_gather"]["bytes"]
    assert halo_bytes * 4 <= legacy_bytes, (halo_bytes, legacy_bytes)


def test_shard_watermark_gauges(mesh, jmesh, both_telemetry):
    rng = np.random.default_rng(7)
    xy, cell, valid = _cloud(rng, 4096)
    qxy, qcell, qok = _cloud(rng, 512)
    ts = rng.integers(0, 10_000, 4096).astype(np.int64)
    plan = tpart.plan_partition(GRID, 8, RADIUS)
    thalo.sharded_range_halo(mesh, plan, xy, valid, cell, qxy, qcell, qok,
                             RADIUS, ts=ts)
    jhalo.sharded_range_halo(jmesh, jpart.plan_partition(JGRID, 8, RADIUS),
                             xy, valid, cell, qxy, qcell, qok, RADIUS, ts=ts)
    wm = telemetry.snapshot()["shard_watermarks"]
    assert wm == jtel.snapshot()["shard_watermarks"]
    assert wm["shards"] == 8
    shard = plan.shard_of(cell)
    for s in range(8):
        assert wm["per_shard"][str(s)] == int(ts[shard == s].max())
    assert wm["merged_min"] == min(wm["per_shard"].values())


def test_join_and_registry_gauges_equal_jax(mesh, jmesh, both_telemetry):
    rng = np.random.default_rng(31)
    lxy, lcell, lok = _cloud(rng, 1024)
    rxy, rcell, rok = _cloud(rng, 1024)
    oid = rng.integers(0, 50, 1024).astype(np.int32)
    plan = tpart.plan_partition(GRID, 8, RADIUS)
    jplan = jpart.plan_partition(JGRID, 8, RADIUS)
    thalo.sharded_join_halo(mesh, plan, lxy, lok, lcell, rxy, rok, rcell,
                            RADIUS, 512, ts=np.arange(1024))
    jhalo.sharded_join_halo(jmesh, jplan, lxy, lok, lcell, rxy, rok, rcell,
                            RADIUS, 512, ts=np.arange(1024))
    rad = np.full(64, RADIUS)
    thalo.sharded_registry_bucket_halo(mesh, plan, lxy, lok, lcell, oid,
                                       rxy[:64], rcell[:64], rad, rok[:64],
                                       k=4, num_segments=50)
    jhalo.sharded_registry_bucket_halo(jmesh, jplan, lxy, lok, lcell, oid,
                                       rxy[:64], rcell[:64], rad, rok[:64],
                                       k=4, num_segments=50)
    assert telemetry.snapshot()["collectives"] == \
        jtel.snapshot()["collectives"]
    assert telemetry.snapshot()["shard_watermarks"] == \
        jtel.snapshot()["shard_watermarks"]


# -- the contract around the wrappers -----------------------------------------


def test_wrappers_check_the_plan_and_pass_the_fault_point(mesh):
    from spatialflink_tpu_torch.faults import InjectedFault, faults

    rng = np.random.default_rng(5)
    xy, cell, valid = _cloud(rng, 256)
    plan4 = tpart.plan_partition(GRID, 4, RADIUS)
    with pytest.raises(ValueError, match="plan is for 4 shard"):
        thalo.sharded_range_halo(mesh, plan4, xy, valid, cell, xy[:8],
                                 cell[:8], valid[:8], RADIUS)
    plan = tpart.plan_partition(GRID, 8, RADIUS)
    faults.arm([{"point": "shard.exchange", "at": 2}])
    try:
        thalo.sharded_range_halo(mesh, plan, xy, valid, cell, xy[:8],
                                 cell[:8], valid[:8], RADIUS)
        with pytest.raises(InjectedFault):
            thalo.sharded_join_halo(mesh, plan, xy, valid, cell, xy, valid,
                                    cell, RADIUS, 64)
    finally:
        faults.disarm()
    # One shard: no exchange, no gauge; equal to the kernel.
    one = tmesh.data_mesh(1, devices=["cpu"])
    plan1 = tpart.plan_partition(GRID, 1, RADIUS)
    keep, dist = thalo.sharded_range_halo(one, plan1, xy, valid, cell,
                                          xy[:8], cell[:8], valid[:8],
                                          RADIUS)
    k1, d1 = _range_single(plan1, xy, valid, cell, xy[:8], cell[:8],
                           valid[:8], RADIUS)
    np.testing.assert_array_equal(keep, k1)
    np.testing.assert_array_equal(dist, d1)


def test_modules_keep_the_jax_names_in_the_jax_order():
    for jmod, tmod in ((jpart, tpart), (jhalo_ops, thalo_ops),
                       (jhalo, thalo)):
        public = getattr(jmod, "__all__", None) or [
            n for n, o in vars(jmod).items() if not n.startswith("_")
            and getattr(o, "__module__", None) == jmod.__name__]
        for name in public:
            jobj, tobj = getattr(jmod, name), getattr(tmod, name)
            assert tobj.__module__ == tmod.__name__, name
            if inspect.isfunction(jobj):
                assert list(inspect.signature(jobj).parameters) == \
                    list(inspect.signature(tobj).parameters), name


def test_process_spanning_mesh_identity_and_refusals():
    devs = ["cpu"] * 4
    a = tmesh.Mesh(np.array([torch.device(d) for d in devs], dtype=object),
                   ("data",), ranks=[0, 0, 1, 1])
    b = tmesh.Mesh(np.array([torch.device(d) for d in devs], dtype=object),
                   ("data",), ranks=[0, 1, 0, 1])
    c = tmesh.data_mesh(4, devices=devs)
    assert a != b and a != c and hash(a) != hash(c)
    assert a == tmesh.Mesh(a.devices, ("data",), ranks=[0, 0, 1, 1])
    assert tmesh.spans_processes(a) and not tmesh.spans_processes(c)
    assert "ranks=[0, 0, 1, 1]" in repr(a)
    # A mesh in one process maps every shard and gathers nothing.
    assert tmesh.map_shards(c, lambda s: s * s) == [0, 1, 4, 9]
    assert tmesh.home_device(c) == torch.device("cpu")
    assert tmesh.local_tiles(c) == [(0, 0), (1, 0), (2, 0), (3, 0)]


def test_ownership_by_tile_on_a_straddling_2d_mesh(monkeypatch):
    """A (1, 4) mesh whose one ``data`` row straddles two ranks: each
    rank runs the tiles it owns, the rank that owns no tile of column 0
    runs no 1-D shard, and its home is the first device it owns
    (before ownership by tile it raised ``IndexError``)."""
    import torch.distributed as dist

    devs = np.array([torch.device("cpu", i) for i in range(4)],
                    dtype=object).reshape(1, 4)
    m = tmesh.Mesh(devs, ("data", "query"), ranks=[0, 0, 1, 1])
    assert m.ranks.shape == (1, 4)
    want = {0: ([(0, 0), (0, 1)], [0], torch.device("cpu", 0)),
            1: ([(0, 2), (0, 3)], [], torch.device("cpu", 2))}
    for rank, (tiles, shards, home) in want.items():
        monkeypatch.setattr(dist, "get_rank", lambda r=rank: r)
        assert tmesh.local_tiles(m) == tiles
        assert tmesh.local_shards(m) == shards
        assert tmesh.home_device(m) == home
    # (2, 2) with a row a rank; a rank that owns nothing has no home.
    m2 = tmesh.Mesh(devs.reshape(2, 2), ("data", "query"),
                    ranks=[0, 0, 1, 1])
    monkeypatch.setattr(dist, "get_rank", lambda: 1)
    assert tmesh.local_tiles(m2) == [(1, 0), (1, 1)]
    assert tmesh.local_shards(m2) == [1]
    assert tmesh.home_device(m2) == torch.device("cpu", 2)
    monkeypatch.setattr(dist, "get_rank", lambda: 2)
    assert tmesh.local_tiles(m2) == []
    with pytest.raises(ValueError, match="rank 2 owns no device"):
        tmesh.home_device(m2)
    # One process: every tile, row by row; home the first device.
    one = tmesh.make_mesh((2, 2), ("data", "query"),
                          devices=[torch.device("cpu", i) for i in range(4)])
    assert tmesh.local_tiles(one) == [(0, 0), (0, 1), (1, 0), (1, 1)]
    assert tmesh.local_shards(one) == [0, 1]
    assert tmesh.home_device(one) == torch.device("cpu", 0)
    assert tmesh.gather_parts(one, {(0, 1): "b", (0, 0): "a"},
                              [(0, 0), (0, 1)]) == ["a", "b"]


def test_shard_exchange_point_is_threaded():
    """``shard.exchange`` is hit in ``parallel/halo.py``, listed among the
    threaded points of ``faults.py`` with the JAX registry's site, and no
    point waits any more."""
    from pathlib import Path

    import spatialflink_tpu_torch.faults as tfaults
    from spatialflink_tpu.faults import INJECTION_POINTS as JPOINTS

    text = Path(thalo.__file__).read_text()
    assert text.count('faults.hit("shard.exchange")') == 3
    threaded, waiting = tfaults.__doc__.split("The other points wait")
    assert "``shard.exchange``" in threaded
    assert "``" not in waiting.split("This module")[0]
    assert "ROADMAP" not in tfaults.INJECTION_POINTS["shard.exchange"]
    assert tfaults.INJECTION_POINTS["shard.exchange"].split(" — ")[0] == \
        JPOINTS["shard.exchange"].split(" — ")[0] == "parallel/halo.py"
