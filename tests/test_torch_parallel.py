"""Parity of the PyTorch port's mesh layer (``parallel/mesh.py``,
``parallel/sharded.py``) with the JAX package's, on the CPU.

The port's mesh lists the CPU eight times (``devices=["cpu"] * 8``, a 2-D
``(4, 2)`` mesh for the query axis); the JAX side runs on the test
configuration's eight virtual CPU devices (``tests/conftest.py``), with
``tests/test_parallel.py`` as the oracle. The same numpy inputs, made
from a seed, go through both; float32 is pinned on both sides (the JAX
functions get float32 arrays).

Contracts held:
- every sharded program equals the port's own unsharded kernel: bit-equal
  for range (keep and distances), kNN, multi-query kNN on the 1-D and
  2-D meshes, the registry bucket and the pane scan; joins as pair sets
  with equal counts and overflow; tStats counts and temporal sums exact,
  spatial sums within ``spatial_sum_bound``;
- against the JAX sharded program: keep masks, kNN segments, indices
  and counts, and join pair sets equal; distances within 1 float32 ulp
  (the port's contract with the JAX kernels since the first slice: a
  compiled JAX program may contract dx² + dy² into a fused
  multiply-add, which moves the root by at most 1 ulp,
  ``tests/test_torch_tjoin_panes.py``); one join case where a single
  shard overflows its local budget reports the JAX count;
- ``telemetry.collective_gauges()`` equal to the JAX package's (kinds,
  calls and bytes) after the same calls, zero for the pane engine;
- ``make_mesh`` and ``mesh_from_config`` raise as JAX's do.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spatialflink_tpu import parallel as jpar
from spatialflink_tpu.parallel import sharded as jsh
from spatialflink_tpu.grid import UniformGrid as JGrid
from spatialflink_tpu.ops import join as jjoin
from spatialflink_tpu.ops import tjoin_panes as jtp
from spatialflink_tpu.telemetry import telemetry as jtel

from spatialflink_tpu_torch.grid import UniformGrid
from spatialflink_tpu_torch.models.batch import GeometryBatch, PointBatch
from spatialflink_tpu_torch.models.objects import Polygon
from spatialflink_tpu_torch.ops import join as tjoin
from spatialflink_tpu_torch.ops import knn as tknn
from spatialflink_tpu_torch.ops import query_registry as tqr
from spatialflink_tpu_torch.ops import range as trange
from spatialflink_tpu_torch.ops import tjoin_panes as ttp
from spatialflink_tpu_torch.ops import trajectory as ttraj
from spatialflink_tpu_torch.ops.cells import gather_cell_flags
from spatialflink_tpu_torch.ops.join_kernel import join_window
from spatialflink_tpu_torch.parallel import (
    data_mesh,
    make_mesh,
    sharded_join,
    sharded_knn,
    sharded_knn_multi,
    sharded_range_query,
    sharded_range_query_2d,
    sharded_traj_stats,
)
from spatialflink_tpu_torch.parallel import mesh as tmesh
from spatialflink_tpu_torch.parallel import sharded as tsh
from spatialflink_tpu_torch.telemetry import telemetry

GRID = UniformGrid(20, 0.0, 10.0, 0.0, 10.0)
JGRID = JGrid(20, 0.0, 10.0, 0.0, 10.0)
CPU8 = ["cpu"] * 8


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Two intra-op threads while this module runs: its shards are many
    small ops, and the whole suite's workers share the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def mesh():
    return data_mesh(8, devices=CPU8)


@pytest.fixture(scope="module")
def jmesh():
    assert len(jax.devices()) >= 8, "conftest must provide 8 devices"
    return jpar.data_mesh(8)


@pytest.fixture
def gauges():
    """Both packages' telemetry on, reset, around the test; hands back a
    probe of the two ``collective_gauges()`` (None before the first
    collective)."""
    telemetry.enable()
    jtel.enable()

    def probe():
        return telemetry.collective_gauges(), jtel.collective_gauges()

    try:
        yield probe
    finally:
        for tel in (telemetry, jtel):
            tel.enable()
            tel.disable()


def _assert_same_gauges(probe, zero=False):
    port, jx = probe()
    if zero:
        assert port is None and jx is None
        return
    assert port is not None and port["bytes"] > 0
    assert port["by_kind"] == jx["by_kind"]
    assert (port["calls"], port["bytes"]) == (jx["calls"], jx["bytes"])
    assert port["by_axis"] == jx["by_axis"]


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _batch(rng, n=1000, bucket=2048):
    xy = rng.uniform(0, 10, size=(n, 2))
    oid = rng.integers(0, 100, n).astype(np.int32)
    b = PointBatch.from_arrays(xy, None, oid, bucket=bucket).with_cells(GRID)
    b.xy = b.xy.astype(np.float32)
    return b


def _eq(a, b):
    return all(torch.equal(x, y) for x, y in zip(a, b))


def _within_ulp(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return got.shape == want.shape and bool(np.all(
        np.abs(got - want) <= np.spacing(np.abs(want).astype(np.float32))))


def _same_dists(got, want):
    """Equal where absent (the dtype's max or inf), within 1 float32 ulp
    elsewhere."""
    got = np.asarray(got)
    want = np.asarray(want)
    big = (want >= np.finfo(np.float32).max)
    return (np.array_equal(got >= np.finfo(np.float32).max, big)
            and _within_ulp(got[~big], want[~big]))


def _same_knn(res, jres):
    """A port ``KnnResult`` against JAX's: ids, indices and counts equal,
    distances per ``_same_dists``."""
    return (_same_dists(res.dist.numpy(), jres.dist)
            and all(np.array_equal(g.numpy(), np.asarray(w))
                    for g, w in zip(res[1:], jres[1:])))


# -- meshes ---------------------------------------------------------------------


def test_make_mesh_shape_hash_and_errors():
    m = make_mesh((4, 2), ("data", "query"), devices=CPU8)
    jm = jpar.make_mesh((4, 2), ("data", "query"))
    assert m.shape == dict(jm.shape) == {"data": 4, "query": 2}
    assert m.size == 8 and m.devices.shape == (4, 2)
    assert hash(m) == hash(make_mesh((4, 2), ("data", "query"),
                                     devices=CPU8))
    assert m != data_mesh(8, devices=CPU8)
    with pytest.raises(ValueError) as te:
        make_mesh((16,), ("data",), devices=CPU8)
    with pytest.raises(ValueError) as je:
        jpar.make_mesh((16,), ("data",))
    assert str(te.value) == str(je.value) == "need 16 devices, have 8"
    if not torch.cuda.is_available():
        # The default device list is the visible cards; none here.
        with pytest.raises(ValueError, match="need 4 devices, have 0"):
            make_mesh((4,), ("data",))
        # No fallback: a card named on a machine without one raises.
        with pytest.raises(RuntimeError, match="is_available"):
            make_mesh((2,), ("data",), devices=["cuda:0"] * 2)


def test_mesh_from_config_matches_jax():
    assert tsh.mesh_from_config([1], device="cpu") is None
    assert jsh.mesh_from_config([1]) is None
    assert tsh.mesh_from_config([], device="cpu") is None
    with pytest.raises(ValueError) as te:
        tsh.mesh_from_config([3], device="cpu")
    with pytest.raises(ValueError) as je:
        jsh.mesh_from_config([3])
    assert str(te.value) == str(je.value)
    m = tsh.mesh_from_config([8], device="cpu")
    assert m.shape == dict(jsh.mesh_from_config([8]).shape)
    assert {d.type for d in m.devices.flat} == {"cpu"}
    m2 = tsh.mesh_from_config([4, 2], device="cpu")
    assert m2.axis_names == ("data", "query")
    assert m2.shape == dict(jsh.mesh_from_config([4, 2]).shape)
    if not torch.cuda.is_available():
        with pytest.raises(ValueError, match="need 4 devices, have 0"):
            tsh.mesh_from_config([4], device="cuda")


def test_payload_nbytes_reads_torch_and_numpy():
    a = torch.zeros((3, 2), dtype=torch.float32)
    b = np.zeros(5, np.int64)
    assert tmesh.payload_nbytes(a, b, None, 3.0) == 24 + 40
    assert tmesh.payload_nbytes(a, b) == jpar.mesh.payload_nbytes(
        jnp.zeros((3, 2), jnp.float32), b)


def test_data_axis_must_divide(mesh):
    xy = torch.zeros((100, 2))
    with pytest.raises(ValueError, match="must divide"):
        sharded_range_query(mesh, xy, torch.ones(100, dtype=torch.bool),
                            torch.ones(100, dtype=torch.uint8),
                            torch.zeros((1, 2)), 1.0)


# -- range ----------------------------------------------------------------------


def _range_inputs(rng):
    b = _batch(rng)
    q = np.array([[5.0, 5.0], [1.0, 9.0]], np.float32)
    r = 1.5
    flags = GRID.neighbor_flags(r, [GRID.flat_cell(*p) for p in q])
    pflags = gather_cell_flags(t(b.cell), t(flags)).numpy()
    return b, q, r, pflags


def test_sharded_range_matches_single_and_jax(rng, mesh, jmesh, gauges):
    b, q, r, pflags = _range_inputs(rng)
    args = (t(b.xy), t(b.valid), t(pflags), t(q))
    keep_s, dist_s = sharded_range_query(mesh, *args, r)
    keep_1, dist_1 = trange.range_query_kernel(*args, r)
    assert torch.equal(keep_s, keep_1) and torch.equal(dist_s, dist_1)
    jk, jd = jsh.sharded_range_query(
        jmesh, jnp.asarray(b.xy), jnp.asarray(b.valid),
        jnp.asarray(pflags), jnp.asarray(q), r)
    assert np.array_equal(keep_s.numpy(), np.asarray(jk))
    assert _same_dists(dist_s.numpy(), jd)
    assert keep_s.any()
    _assert_same_gauges(gauges)


def test_sharded_range_query_2d_matches_single_and_jax(rng, gauges):
    mesh2d = make_mesh((4, 2), ("data", "query"), devices=CPU8)
    b, q, r, pflags = _range_inputs(rng)
    args = (t(b.xy), t(b.valid), t(pflags), t(q))
    keep_s, dist_s = sharded_range_query_2d(mesh2d, *args, r)
    keep_1, dist_1 = trange.range_query_kernel(*args, r)
    assert torch.equal(keep_s, keep_1) and torch.equal(dist_s, dist_1)
    jk, jd = jsh.sharded_range_query_2d(
        jpar.make_mesh((4, 2), ("data", "query")), jnp.asarray(b.xy),
        jnp.asarray(b.valid), jnp.asarray(pflags), jnp.asarray(q), r)
    assert np.array_equal(keep_s.numpy(), np.asarray(jk))
    assert _same_dists(dist_s.numpy(), jd)
    _assert_same_gauges(gauges)


def test_sharded_window_kernel_matches_single_and_jax(rng, mesh, jmesh,
                                                      gauges):
    """The generic mesh dispatcher on the same fused kernel the unsharded
    path runs, against ``jitted``'s unsharded call and JAX's program."""
    from spatialflink_tpu.ops.range import range_points_fused as jfused

    from spatialflink_tpu_torch.operators.base import window_program

    b, q, r, _ = _range_inputs(rng)
    flags = GRID.neighbor_flags(r, [GRID.flat_cell(*p) for p in q])
    args = (t(b.xy), t(b.valid), t(b.cell), t(flags), t(q), r)
    keep_s, dist_s = window_program(
        mesh, trange.range_points_fused, (0, 1, 2), 6,
        approximate=False)(*args)
    keep_1, dist_1 = window_program(
        None, trange.range_points_fused, (0, 1, 2), 6,
        approximate=False)(*args)
    assert torch.equal(keep_s, keep_1) and torch.equal(dist_s, dist_1)
    jprog = jsh.sharded_window_kernel(jmesh, jfused, (0, 1, 2), 6,
                                      approximate=False)
    jk, jd = jprog(jnp.asarray(b.xy), jnp.asarray(b.valid),
                   jnp.asarray(b.cell), jnp.asarray(flags), jnp.asarray(q),
                   r)
    assert np.array_equal(keep_s.numpy(), np.asarray(jk))
    assert _same_dists(dist_s.numpy(), jd)
    _assert_same_gauges(gauges)


# -- kNN ------------------------------------------------------------------------


@pytest.mark.parametrize("k", [5, 50])
def test_sharded_knn_matches_single_and_jax(rng, mesh, jmesh, k, gauges):
    b = _batch(rng)
    q = np.array([5.0, 5.0], np.float32)
    r = 3.0
    flags = GRID.neighbor_flags(r, [GRID.flat_cell(*q)])
    pflags = gather_cell_flags(t(b.cell), t(flags)).numpy()
    args = (t(b.xy), t(b.valid), t(pflags), t(b.oid), t(q))
    res_s = sharded_knn(mesh, *args, r, k, num_segments=128)
    res_1 = tknn.knn_kernel(*args, r, k, 128)
    assert _eq(res_s, res_1)
    jr = jsh.sharded_knn(
        jmesh, jnp.asarray(b.xy), jnp.asarray(b.valid), jnp.asarray(pflags),
        jnp.asarray(b.oid), jnp.asarray(q), r, k, num_segments=128)
    assert _same_knn(res_s, jr)
    assert int(res_s.num_valid) == min(k, int((res_s.segment >= 0).sum()))
    _assert_same_gauges(gauges)


@pytest.mark.parametrize("fused", ["points", "polygon", "polyline"])
def test_topk_window_kernels_merge_digests_exactly(rng, mesh, fused):
    """Every kNN window kernel's local phase (``index_base``) merged over
    the mesh equals its unsharded top-k."""
    from spatialflink_tpu_torch.operators.base import window_program

    b = _batch(rng, n=1500)
    r = 2.0
    flags = GRID.neighbor_flags(r, [GRID.flat_cell(5.0, 5.0)])
    lanes = (t(b.xy), t(b.valid), t(b.cell), t(flags), t(b.oid))
    if fused == "points":
        kern, query = tknn.knn_points_fused, (t(np.float32([5.0, 5.0])),)
    else:
        ring = np.float32([[4.5, 4.5], [5.5, 4.5], [5.5, 5.5], [4.5, 5.5],
                           [4.5, 4.5]])
        kern = (tknn.knn_polygon_fused if fused == "polygon"
                else tknn.knn_polyline_fused)
        query = (t(ring), t(np.ones(4, bool)))
    want = kern(*lanes, *query, r, 20, 128)
    got = window_program(mesh, kern, (0, 1, 2, 4), 6 + len(query),
                         topk=True, k=20, num_segments=128)(
        *lanes, *query, r)
    assert _eq(got, want) and int(want.num_valid) == 20


def _multi_inputs(rng, nq=8, r=2.5):
    b = _batch(rng, n=2000)
    qxy = rng.uniform(0, 10, (nq, 2)).astype(np.float32)
    tables = np.stack([GRID.neighbor_flags(r, [GRID.flat_cell(*p)])
                       for p in qxy])
    return b, qxy, tables


@pytest.mark.parametrize("shape", [(8,), (4, 2)], ids=["1d", "2d"])
def test_sharded_knn_multi_matches_single_and_jax(rng, shape, gauges):
    names = ("data", "query")[:len(shape)]
    mesh = make_mesh(shape, names, devices=CPU8)
    b, qxy, tables = _multi_inputs(rng)
    r, k = 2.5, 5
    args = (t(b.xy), t(b.valid), t(b.cell), t(tables), t(b.oid), t(qxy))
    res_s = sharded_knn_multi(mesh, *args, r, k=k, num_segments=128)
    res_1 = tknn.knn_multi_query_kernel(*args, r, k, 128, query_block=4)
    assert _eq(res_s, res_1)
    jr = jsh.sharded_knn_multi(
        jpar.make_mesh(shape, names), jnp.asarray(b.xy),
        jnp.asarray(b.valid), jnp.asarray(b.cell), jnp.asarray(tables),
        jnp.asarray(b.oid), jnp.asarray(qxy), r, k=k, num_segments=128)
    assert _same_knn(res_s, jr)
    assert int(res_s.num_valid.sum()) > 0
    _assert_same_gauges(gauges)


def test_sharded_knn_multi_query_axis_must_divide(rng):
    mesh = make_mesh((2, 4), ("data", "query"), devices=CPU8)
    b, qxy, tables = _multi_inputs(rng, nq=6)
    with pytest.raises(ValueError, match="query axis"):
        sharded_knn_multi(mesh, t(b.xy), t(b.valid), t(b.cell), t(tables),
                          t(b.oid), t(qxy), 2.5, k=5, num_segments=128)


def test_sharded_registry_bucket_matches_single_and_jax(rng, mesh, jmesh,
                                                        gauges):
    from spatialflink_tpu.ops.query_registry import (
        registry_bucket_kernel as j_bucket,
    )

    b, qxy, tables = _multi_inputs(rng, nq=16)
    radius = rng.uniform(0.5, 3.0, 16)  # float64 per-query radii
    qvalid = np.ones(16, bool)
    qvalid[[3, 11, 12]] = False
    args = (t(b.xy), t(b.valid), t(b.cell), t(tables), t(b.oid), t(qxy),
            t(radius), t(qvalid))
    res_s = tsh.sharded_registry_bucket(mesh, *args, k=8, num_segments=128)
    res_1 = tqr.registry_bucket_kernel(*args, k=8, num_segments=128,
                                       query_block=8)
    assert _eq(res_s, res_1)
    jargs = (jnp.asarray(b.xy), jnp.asarray(b.valid), jnp.asarray(b.cell),
             jnp.asarray(tables), jnp.asarray(b.oid), jnp.asarray(qxy),
             jnp.asarray(radius), jnp.asarray(qvalid))
    jr = jsh.sharded_registry_bucket(jmesh, *jargs, k=8, num_segments=128)
    assert _same_knn(res_s, jr)
    assert np.array_equal(res_s.within.numpy(), np.asarray(jr.within))
    j1 = j_bucket(*jargs, k=8, num_segments=128, query_block=8)
    assert np.array_equal(res_s.within.numpy(), np.asarray(j1.within))
    assert int(res_s.within.sum()) > 0
    _assert_same_gauges(gauges)


# -- trajectories ---------------------------------------------------------------


def test_sharded_traj_stats_matches_single_and_jax(rng, mesh, jmesh,
                                                   gauges):
    n, n_traj = 2048, 7
    oid = np.sort(rng.integers(0, n_traj, n)).astype(np.int32)
    ts = np.zeros(n, np.int64)
    for o in range(n_traj):
        idx = np.nonzero(oid == o)[0]
        ts[idx] = np.arange(len(idx)) * 1000
    xy = rng.uniform(0, 10, size=(n, 2)).astype(np.float32)
    valid = np.ones(n, bool)
    valid[rng.integers(0, n, 50)] = False
    sp, tp, cnt, speed = sharded_traj_stats(mesh, t(xy), t(ts), t(oid),
                                            t(valid), num_segments=8)
    one = ttraj.traj_stats_kernel(t(xy), t(ts), t(oid), t(valid), 8)
    assert torch.equal(tp, one.temporal_length)
    assert torch.equal(cnt, one.count)
    seg = np.hypot(*(xy[1:] - xy[:-1]).T)
    bound = ttraj.spatial_sum_bound(n, seg.sum())
    assert np.all(np.abs(sp.numpy() - one.spatial_length.numpy()) <= bound)
    js, jt, jc, _ = jsh.sharded_traj_stats(
        jmesh, jnp.asarray(xy), jnp.asarray(ts), jnp.asarray(oid),
        jnp.asarray(valid), num_segments=8)
    assert np.array_equal(tp.numpy(), np.asarray(jt))
    assert np.array_equal(cnt.numpy(), np.asarray(jc))
    assert np.all(np.abs(sp.numpy() - np.asarray(js)) <= bound)
    pos = tp.numpy() > 0
    assert np.allclose(speed.numpy()[pos], sp.numpy()[pos] / tp.numpy()[pos])
    assert not speed.numpy()[~pos].any()
    _assert_same_gauges(gauges)


def test_sharded_traj_stats_pane_matches_single_and_jax(rng, mesh, jmesh,
                                                        gauges):
    num_oids, slide_ms, ppw, n = 16, 1000, 3, 4096
    oid = np.sort(rng.integers(0, num_oids, n)).astype(np.int32)
    ts = np.zeros(n, np.int32)
    for o in range(num_oids):
        idx = np.nonzero(oid == o)[0]
        ts[idx] = np.arange(len(idx), dtype=np.int32) * 400
    x = rng.uniform(0, 10, n).astype(np.float32)
    y = rng.uniform(0, 10, n).astype(np.float32)
    valid = np.ones(n, bool)
    n_panes = int(ts.max() // slide_ms) + 1
    kw = dict(num_oids=num_oids, slide_ms=slide_ms, ppw=ppw,
              n_panes=n_panes)
    got = tsh.sharded_traj_stats_pane(mesh, ts, x, y, oid, valid, **kw)
    one = ttraj.traj_stats_pane_kernel(t(ts), t(x), t(y), t(oid), t(valid),
                                       **kw)
    jr = jsh.sharded_traj_stats_pane(jmesh, ts, x, y, oid, valid, **kw)
    assert torch.equal(got.temporal, one.temporal)
    assert torch.equal(got.count, one.count)
    assert np.array_equal(got.temporal.numpy(), np.asarray(jr.temporal))
    assert np.array_equal(got.count.numpy(), np.asarray(jr.count))
    # A row's terms: its segments, the cumulative sums and corrections.
    mag = np.abs(np.diff(np.stack([x, y]), axis=1)).sum() * 2
    bound = ttraj.spatial_sum_bound(3 * n, mag)
    for want in (one.spatial.numpy(), np.asarray(jr.spatial)):
        assert np.all(np.abs(got.spatial.numpy() - want) <= bound)
    assert got.count.numpy().any()
    with pytest.raises(ValueError, match="divide"):
        tsh.sharded_traj_stats_pane(mesh, ts, x, y, oid, valid,
                                    **{**kw, "num_oids": 12})
    # The zero-collective program: no gauge on either side.
    _assert_same_gauges(gauges, zero=True)


def _pane_fields(rng, s, pc, gn, n_obj, extent=10.0):
    xy = rng.uniform(-0.3, extent + 0.3, (s * pc, 2))
    cl = extent / gn
    xi = np.floor(xy[:, 0] / cl).astype(np.int64)
    yi = np.floor(xy[:, 1] / cl).astype(np.int64)
    ing = (xi >= 0) & (xi < gn) & (yi >= 0) & (yi < gn)
    valid = ing & (rng.random(s * pc) > 0.05)
    cell = np.where(ing, xi * gn + yi, 0).astype(np.int32)
    rank = jtp.pane_cell_ranks(np.repeat(np.arange(s), pc), cell,
                               valid=valid)
    c = (xy - extent / 2).astype(np.float32)
    arrs = (c[:, 0], c[:, 1], xi.astype(np.int32), yi.astype(np.int32),
            cell, rank.astype(np.int32),
            rng.integers(0, n_obj, s * pc).astype(np.int32), valid)
    return tuple(a.reshape(s, pc) for a in arrs)


@pytest.mark.parametrize("cap_c", [0, 8])
def test_sharded_tjoin_pane_scan_matches_single_and_jax(rng, mesh, jmesh,
                                                        cap_c, gauges):
    s, pc, gn, k, ppw, cap_w = 24, 64, 10, 8, 6, 32
    lf = _pane_fields(rng, s, pc, gn, k)
    rf = _pane_fields(rng, s, pc, gn, k)
    kw = dict(grid_n=gn, cap_w=cap_w, layers=1, ppw=ppw, num_ids=k,
              pair_sel=16, cap_c=cap_c)

    def tensors(f):
        return tuple(t(a) for a in f)

    def fresh():
        return ttp.tjoin_pane_init(gn * gn, cap_w, ppw, k, device="cpu")

    one_c, one_w = ttp.tjoin_pane_scan(fresh(), range(s), tensors(lf),
                                       tensors(rf), 0.8, **kw)
    got_c, got_w = tsh.sharded_tjoin_pane_scan(
        mesh, fresh(), torch.arange(s), tensors(lf), tensors(rf), 0.8, **kw)
    assert torch.equal(got_w, one_w)
    for a, b in zip(got_c, one_c):
        assert torch.equal(a, b)
    with jax.enable_x64(False):
        j0 = jtp.tjoin_pane_init(gn * gn, cap_w, ppw, k, jnp.float32)
        jc, jw = jsh.sharded_tjoin_pane_scan(
            jmesh, j0, jnp.arange(s, dtype=jnp.int32),
            tuple(map(jnp.asarray, lf)), tuple(map(jnp.asarray, rf)),
            np.float32(0.8), **kw)
        jw = np.asarray(jw)
    tw = got_w.numpy()
    assert np.array_equal(np.isfinite(tw), np.isfinite(jw))
    assert _within_ulp(tw[np.isfinite(jw)], jw[np.isfinite(jw)])
    assert np.isfinite(jw).sum() > 100
    assert [int(got_c.cap_overflow), int(got_c.sel_overflow),
            int(got_c.cmp_overflow)] == [int(jc.cap_overflow),
                                         int(jc.sel_overflow),
                                         int(jc.cmp_overflow)]
    _assert_same_gauges(gauges)
    with pytest.raises(ValueError, match="pane capacity"):
        ttp.tjoin_pane_scan(fresh(), range(s), tensors(lf), tensors(rf),
                            0.8, **kw, mesh=data_mesh(3, devices=["cpu"] * 3))


# -- joins ----------------------------------------------------------------------


def _pair_set(left, right, dist=None):
    left = np.asarray(left)
    right = np.asarray(right)
    keep = left >= 0
    if dist is None:
        return set(zip(left[keep].tolist(), right[keep].tolist()))
    d = np.asarray(dist)
    return set(zip(left[keep].tolist(), right[keep].tolist(),
                   d[keep].tolist()))


def _join_inputs(rng):
    a = _batch(rng, n=700, bucket=1024)
    b = _batch(rng, n=300, bucket=512)
    return a, b, 0.6


def test_sharded_join_matches_single_and_jax(rng, mesh, jmesh, gauges):
    a, b, r = _join_inputs(rng)
    lci = GRID.cell_xy_indices_np(a.xy)
    left_in = a.valid & (a.cell < GRID.num_cells)
    order = np.argsort(b.cell, kind="stable").astype(np.int32)
    offsets = GRID.neighbor_offsets(r)
    res_s = sharded_join(mesh, t(a.xy), t(left_in), t(lci),
                         t(b.xy[order]), t(b.valid[order]),
                         t(b.cell[order]), t(order), t(offsets),
                         grid_n=GRID.n, radius=r, cap=32)
    li, rj = torch.nonzero(res_s.pair_mask, as_tuple=True)
    got = _pair_set(li, res_s.right_index[li, rj])
    one = join_window(t(a.xy), t(left_in), t(a.cell), t(b.xy), t(b.valid),
                      t(b.cell), GRID.n, GRID.candidate_layers(r), r, 32, 32,
                      65536)
    assert got == _pair_set(one.left_index, one.right_index) and got
    assert torch.equal(res_s.dist[li, rj], res_s.dist[res_s.pair_mask])
    jcells, jorder = jjoin.sort_by_cell(jnp.asarray(b.cell),
                                        JGRID.num_cells)
    jr = jsh.sharded_join(
        jmesh, jnp.asarray(a.xy), jnp.asarray(left_in), jnp.asarray(lci),
        jnp.asarray(b.xy)[jorder], jnp.asarray(b.valid)[jorder], jcells,
        jorder, jnp.asarray(offsets), grid_n=GRID.n, radius=r, cap=32)
    jm = np.asarray(jr.pair_mask)
    jl, js = np.nonzero(jm)
    assert got == _pair_set(jl, np.asarray(jr.right_index)[jl, js])
    assert int(res_s.overflow) == int(jr.overflow) == 0
    _assert_same_gauges(gauges)


def _compact_args(a, b, r):
    lci = GRID.cell_xy_indices_np(a.xy)
    left_in = a.valid & (a.cell < GRID.num_cells)
    return (a.xy, left_in, lci, b.xy, b.valid, b.cell,
            GRID.neighbor_offsets(r))


def test_sharded_join_window_compact_matches_single_and_jax(rng, mesh,
                                                            jmesh, gauges):
    a, b, r = _join_inputs(rng)
    args = _compact_args(a, b, r)
    res_s = tsh.sharded_join_window_compact(
        mesh, *map(t, args), grid_n=GRID.n, radius=r, cap=32,
        max_pairs=4096)
    one = join_window(t(a.xy), t(args[1]), t(a.cell), t(b.xy), t(b.valid),
                      t(b.cell), GRID.n, GRID.candidate_layers(r), r, 32, 32,
                      4096)
    got = _pair_set(res_s.left_index, res_s.right_index, res_s.dist)
    assert got == _pair_set(one.left_index, one.right_index, one.dist)
    assert got and int(res_s.count) >= int(one.count)
    jr = jsh.sharded_join_window_compact(
        jmesh, *map(jnp.asarray, args), grid_n=GRID.n, radius=r, cap=32,
        max_pairs=4096)
    assert _pair_set(res_s.left_index, res_s.right_index) == _pair_set(
        jr.left_index, jr.right_index)
    assert int(res_s.count) == int(jr.count)
    assert int(res_s.overflow) == int(jr.overflow) == 0
    _assert_same_gauges(gauges)


def test_sharded_join_compact_one_shard_over_its_budget(rng, mesh, jmesh):
    """The left side's first eighth sits on the right points: one shard
    holds nearly every pair, past its ``max_pairs / 8`` share while the
    total fits, so ``count`` reports ``max_local · 8`` (above
    ``max_pairs``) and the caller's doubling retry fires, as in JAX."""
    bxy = rng.uniform(4.0, 6.0, (200, 2))
    b = PointBatch.from_arrays(bxy, None, np.zeros(200, np.int32),
                               bucket=256).with_cells(GRID)
    axy = rng.uniform(0, 10, (1024, 2))
    axy[:128] = rng.uniform(4.0, 6.0, (128, 2))
    a = PointBatch.from_arrays(axy, None, np.zeros(1024, np.int32),
                               bucket=1024).with_cells(GRID)
    a.xy = a.xy.astype(np.float32)
    b.xy = b.xy.astype(np.float32)
    r, max_pairs = 0.3, 4096
    args = _compact_args(a, b, r)
    res_s = tsh.sharded_join_window_compact(
        mesh, *map(t, args), grid_n=GRID.n, radius=r, cap=64,
        max_pairs=max_pairs)
    jr = jsh.sharded_join_window_compact(
        jmesh, *map(jnp.asarray, args), grid_n=GRID.n, radius=r, cap=64,
        max_pairs=max_pairs)
    one = join_window(t(a.xy), t(args[1]), t(a.cell), t(b.xy), t(b.valid),
                      t(b.cell), GRID.n, GRID.candidate_layers(r), r, 64, 64,
                      max_pairs)
    total = int(one.count)
    assert total <= max_pairs < int(res_s.count) == int(jr.count)
    # Each shard kept its share: the truncated pairs are a subset.
    assert _pair_set(res_s.left_index, res_s.right_index) <= _pair_set(
        one.left_index, one.right_index)
    # The retry at the reported count is exact again.
    res_2 = tsh.sharded_join_window_compact(
        mesh, *map(t, args), grid_n=GRID.n, radius=r, cap=64,
        max_pairs=int(res_s.count))
    assert _pair_set(res_2.left_index, res_2.right_index) == _pair_set(
        one.left_index, one.right_index)


def _square_polygons(rng, m, size=0.25, tag="g"):
    out = []
    for i in range(m):
        cx, cy = rng.uniform(0.5, 9.5, 2)
        ring = np.array([
            [cx - size, cy - size], [cx + size, cy - size],
            [cx + size, cy + size], [cx - size, cy + size],
            [cx - size, cy - size],
        ])
        out.append(Polygon(obj_id=f"{tag}{i}", timestamp=i, rings=[ring]))
    return out


def _f32_batch(gb):
    return (gb.verts.astype(np.float32), gb.edge_valid, gb.valid,
            gb.bbox.astype(np.float32))


def test_sharded_point_geometry_join_pruned_matches_single_and_jax(
        rng, mesh, jmesh, gauges):
    b = _batch(rng, n=1500, bucket=2048)
    gb = GeometryBatch.from_objects(_square_polygons(rng, 60),
                                    dtype=np.float64)
    r = 0.15
    args = (b.xy, b.valid, *_f32_batch(gb))
    kw = dict(polygonal=True, block=256, cand=gb.capacity, max_pairs=4096,
              pair_cap=8)
    res_s = tsh.sharded_point_geometry_join_pruned(mesh, *map(t, args), r,
                                                   **kw)
    one = tjoin.point_geometry_join_pruned_kernel(*map(t, args), r, **kw)
    got = _pair_set(res_s.left_index, res_s.right_index, res_s.dist)
    assert got == _pair_set(one.left_index, one.right_index, one.dist)
    assert got and res_s.count.shape == (8,)
    assert int(res_s.count.sum()) == int(one.count)
    jr = jsh.sharded_point_geometry_join_pruned(
        jmesh, *map(jnp.asarray, args), r, **kw)
    assert _pair_set(res_s.left_index, res_s.right_index) == _pair_set(
        jr.left_index, jr.right_index)
    assert np.array_equal(res_s.count.numpy(), np.asarray(jr.count))
    for name in ("cand_overflow", "pair_overflow"):
        assert int(getattr(res_s, name)) == int(getattr(jr, name)) == 0
    _assert_same_gauges(gauges)


@pytest.mark.parametrize("approx", [False, True])
def test_sharded_geometry_geometry_join_pruned_matches_single_and_jax(
        rng, mesh, jmesh, approx, gauges):
    la = GeometryBatch.from_objects(_square_polygons(rng, 120, size=0.3),
                                    dtype=np.float64, bucket=128)
    rb = GeometryBatch.from_objects(
        _square_polygons(np.random.default_rng(13), 80, size=0.3, tag="h"),
        dtype=np.float64)
    r = 0.2
    args = (*_f32_batch(la), *_f32_batch(rb))
    kw = dict(a_polygonal=True, b_polygonal=True, block=16,
              cand=rb.capacity, max_pairs=4096, pair_cap=16, approx=approx)
    targs = [t(a) for a in args]
    res_s = tsh.sharded_geometry_geometry_join_pruned(mesh, *targs, r, **kw)
    one = tjoin.geometry_geometry_join_pruned_kernel(*targs, r, **kw)
    got = _pair_set(res_s.left_index, res_s.right_index, res_s.dist)
    assert got == _pair_set(one.left_index, one.right_index, one.dist)
    assert got
    jr = jsh.sharded_geometry_geometry_join_pruned(
        jmesh, *map(jnp.asarray, args), r, **kw)
    assert _pair_set(res_s.left_index, res_s.right_index) == _pair_set(
        jr.left_index, jr.right_index)
    assert np.array_equal(res_s.count.numpy(), np.asarray(jr.count))
    for name in ("cand_overflow", "pair_overflow"):
        assert int(getattr(res_s, name)) == int(getattr(jr, name)) == 0
    _assert_same_gauges(gauges)
