"""The float64 mode of the port's trajectory operators and of the
standing-query server against the JAX package's x64 mode.

The session runs JAX with x64 on (``tests/conftest.py``) and the JAX
operators here run at their default ``dtype`` (float64): they ship raw
float64 coordinates and compute in float64. The port runs inside
``precision.x64(True)`` at its default ``dtype`` (float64), on the CPU,
where B3's wrapper takes its plain PyTorch version in float64; the JAX
tJoin takes its CPU path (the XLA bucketed join).

Contracts held:
- tRange, tKnn, tJoin (``run``, ``run_single``, ``run_soa``,
  ``run_soa_panes`` on the device and the native engine), tAggregate,
  tStats (``run`` WindowBased, RealTime and CountBased, ``run_soa``) and
  ``QServeOperator`` (``run``, ``serve_window``) equal their JAX
  counterparts on random data: windows, ids, pairs, counts and spans
  exact; distances float64 and within 1 float64 ulp (``x64._within``:
  the jitted JAX programs may contract the last multiply-add of
  dx² + dy²); tStats spatial sums within the float64
  ``spatial_sum_bound`` (the operators) and ``pane_spatial_bound`` (the
  device pane engine), counts and temporal sums exact;
- the pane-carry engine: a float64 scan against the JAX float64 scan,
  and a JAX float64 carry imported through ``state.py`` stays float64
  and continues the JAX scan; the float64 ``radius_sq_bound`` against
  ``sqrt(d²) <= r`` around r²;
- the radius's edge: trajectories 0.001 ± a few float64 ulps apart keep
  exactly JAX's pairs in ``run_soa`` and in ``run_soa_panes`` with both
  engines;
- empty results are float64: a one-sided tJoin window, a window with no
  pair (``run_soa`` and both pane engines), the registry's sentinel for
  a query with nothing in its radius;
- resume: a float64 ``run_soa_panes`` and ``QServeOperator.run``, killed
  and resumed through the driver, write the uninterrupted run's egress
  bytes;
- the tStats device pane engine takes float64 lanes whenever x64 is on
  and float32 ones whenever it is off, as the JAX engine does; a
  float64 mesh run, and the mesh scan of a float64 tJoin carry, equal
  their unsharded runs (the mesh in full: ``tests/test_torch_x64_mesh.py``).
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_qserve as TQ
import test_torch_tjoin_panes as TTP
import test_torch_trajectory as TT
import test_torch_x64 as TX
from spatialflink_tpu.grid import UniformGrid as JGrid
from spatialflink_tpu.models.objects import Point as JPoint
from spatialflink_tpu.models.objects import Polygon as JPolygon
from spatialflink_tpu.operators import QueryConfiguration as JConf
from spatialflink_tpu.operators import QueryType as JQT
from spatialflink_tpu.operators import trajectory as jtraj
from spatialflink_tpu.operators.base import jitted as j_jitted
from spatialflink_tpu.ops import query_registry as jqr
from spatialflink_tpu.ops import tjoin_panes as jtp
from spatialflink_tpu.streams import panes as jpanes

from spatialflink_tpu_torch import precision, qserve
from spatialflink_tpu_torch.grid import UniformGrid
from spatialflink_tpu_torch.models.objects import Point, Polygon
from spatialflink_tpu_torch.operators import (
    PointPointTJoinQuery,
    PointPointTKNNQuery,
    PointPolygonTRangeQuery,
    PointTAggregateQuery,
    PointTStatsQuery,
    QueryType,
)
from spatialflink_tpu_torch.operators.base import jitted
from spatialflink_tpu_torch.ops import query_registry as tqr
from spatialflink_tpu_torch.ops import tjoin_panes as ttp
from spatialflink_tpu_torch.ops import trajectory as tops
from spatialflink_tpu_torch.streams import panes as tpanes
from spatialflink_tpu_torch.state import tjoin_pane_carry_from_jax

x64 = TX.x64  # the fixture: the port's float64 mode on
_within = TX._within
_bits = TX._bits
F64_MAX = np.finfo(np.float64).max


def _sums_close64(got, want, n_terms):
    """float64 sums of nonnegative terms within the float64
    ``spatial_sum_bound(n_terms, sum)``."""
    got = np.asarray(got)
    want = np.asarray(want)
    assert got.dtype == np.float64, got.dtype
    bound = tops.spatial_sum_bound(n_terms, np.maximum(got, want),
                                   np.float64)
    return got.shape == want.shape and bool(
        np.all(np.abs(got - want.astype(np.float64)) <= bound))


def _stats_close64(got, want, n_terms):
    if got.keys() != want.keys():
        return False
    keys = sorted(got)
    if [got[k][1] for k in keys] != [want[k][1] for k in keys]:
        return False
    t = np.array([max(got[k][1], 1) for k in keys], np.float64)
    return (_sums_close64([got[k][0] for k in keys],
                          [want[k][0] for k in keys], n_terms)
            and _sums_close64(np.array([got[k][2] for k in keys]) * t,
                              np.array([want[k][2] for k in keys]) * t,
                              n_terms + 2))


def _not_f32(values):
    """Some non-zero value that no float32 holds: a float64 result."""
    nonzero = [float(v) for v in values if v != 0]
    return bool(nonzero) and any(float(np.float32(v)) != v for v in nonzero)


# ---------------------------------------------------------------------------
# tRange, tKnn, tAggregate


def test_trange_run_and_run_soa_match_jax(x64):
    rng = np.random.default_rng(201)
    pts, jpts = TT._walks(rng, n_traj=8)
    polys = [Polygon(rings=[TT.SQUARE]), Polygon(rings=[TT.TRI])]
    jpolys = [JPolygon(rings=[TT.SQUARE]), JPolygon(rings=[TT.TRI])]
    op, jop = TT._ops(PointPolygonTRangeQuery, jtraj.PointPolygonTRangeQuery)
    got = list(op.run(iter(pts), polys))
    want = list(jop.run(iter(jpts), jpolys))
    assert len(got) == len(want) > 1
    for g, w in zip(got, want):
        assert (g.start, g.end, g.window_count) == \
            (w.start, w.end, w.window_count)
        assert TT._lines(g.trajectories) == TT._lines(w.trajectories)
    assert any(g.trajectories for g in got)
    ts, xs, ys, oids = TT._stream(rng, 3000, n_obj=200)
    op, jop = TT._ops(PointPolygonTRangeQuery, jtraj.PointPolygonTRangeQuery)
    got = list(op.run_soa(TT._chunks(ts, xs, ys, oids), polys, 256))
    want = list(jop.run_soa(TT._chunks(ts, xs, ys, oids), jpolys, 256))
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert g[0:2] == w[0:2] and g[3] == w[3]
        assert np.array_equal(g[2], w[2]) and len(g[2]) > 10


@pytest.mark.parametrize("qt", [QueryType.WindowBased, QueryType.CountBased])
def test_tknn_run_and_run_soa_match_jax(qt, x64):
    rng = np.random.default_rng(202)
    pts, jpts = TT._walks(rng, n_traj=12)
    conf = TT._conf(query_type=qt, count_window_size=150)
    op, jop = TT._ops(PointPointTKNNQuery, jtraj.PointPointTKNNQuery, conf)
    q, jq = Point(x=5.0, y=5.0), JPoint(x=5.0, y=5.0)
    got = list(op.run(iter(pts), q, 3.0, 5))
    want = list(jop.run(iter(jpts), jq, 3.0, 5))
    assert len(got) == len(want) > 1
    for g, w in zip(got, want):
        assert (g.start, g.end, g.window_count) == \
            (w.start, w.end, w.window_count)
        assert [n[0] for n in g.neighbors] == [n[0] for n in w.neighbors]
        assert _within([n[1] for n in g.neighbors],
                       [n[1] for n in w.neighbors])
        assert TT._lines([n[2] for n in g.neighbors]) == \
            TT._lines([n[2] for n in w.neighbors])
    assert _not_f32([n[1] for g in got for n in g.neighbors])
    if qt == QueryType.CountBased:
        return
    ts, xs, ys, oids = TT._stream(rng, 3000, n_obj=100)
    got = list(op.run_soa(TT._chunks(ts, xs, ys, oids), q, 1.0, 10, 128))
    want = list(jop.run_soa(TT._chunks(ts, xs, ys, oids), jq, 1.0, 10, 128))
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert g[0:2] == w[0:2] and g[4] == w[4] == 10
        assert np.array_equal(g[2], w[2]) and _within(g[3], w[3])


@pytest.mark.parametrize("mode", ["ALL", "SUM", "MAX"])
def test_taggregate_run_and_run_soa_match_jax(mode, x64):
    rng = np.random.default_rng(203)
    pts, jpts = TT._walks(rng, n_traj=6, pts_per=30)
    op, jop = TT._ops(PointTAggregateQuery, jtraj.PointTAggregateQuery,
                      aggregate=mode)
    got = list(op.run(iter(pts)))
    want = list(jop.run(iter(jpts)))
    assert [(g.start, g.end, g.window_count, g.cells) for g in got] == \
        [(w.start, w.end, w.window_count, w.cells) for w in want]
    assert len(got[-1].cells) > 5
    ts, xs, ys, oids = TT._stream(rng, 2000, n_obj=12)
    op, jop = TT._ops(PointTAggregateQuery, jtraj.PointTAggregateQuery,
                      aggregate=mode)
    got = list(op.run_soa(TT._chunks(ts, xs, ys, oids)))
    want = list(jop.run_soa(TT._chunks(ts, xs, ys, oids)))
    assert [(g.start, g.end, g.window_count, g.cells) for g in got] == \
        [(w.start, w.end, w.window_count, w.cells) for w in want]
    for a in ("_skeys", "_smin", "_smax"):
        assert np.array_equal(getattr(op, a), getattr(jop, a))


# ---------------------------------------------------------------------------
# tStats


@pytest.mark.parametrize("qt", [QueryType.WindowBased, QueryType.RealTime,
                                QueryType.CountBased])
def test_tstats_run_matches_jax(qt, x64):
    rng = np.random.default_rng(204)
    pts, jpts = TT._walks(rng, n_traj=5, pts_per=40)
    pts[30].timestamp = jpts[30].timestamp = pts[20].timestamp - 1
    conf = TT._conf(10.0, 5.0, query_type=qt, count_window_size=64,
                    realtime_batch_ms=700)
    op, jop = TT._ops(PointTStatsQuery, jtraj.PointTStatsQuery, conf)
    got = list(op.run(iter(pts)))
    want = list(jop.run(iter(jpts)))
    assert len(got) == len(want) > 3
    for g, w in zip(got, want):
        assert (g.start, g.end, g.window_count) == \
            (w.start, w.end, w.window_count)
        if qt == QueryType.RealTime:
            assert g.stats == w.stats
        else:
            assert _stats_close64(g.stats, w.stats, g.window_count)
    assert _not_f32([s[0] for g in got for s in g.stats.values()])


def test_tstats_numpy_twin_computes_in_float64(x64):
    """The driver's failover twin: the same float64 lanes as the device
    path, its spatial sums within the float64 bound of the device's."""
    rng = np.random.default_rng(205)
    pts, _ = TT._walks(rng, n_traj=5, pts_per=40)
    conf = TT._conf(10.0, 5.0)
    op = PointTStatsQuery(conf[0], UniformGrid(**TT.GRID), device="cpu")
    dev = list(op.run(iter(pts)))
    twin = op._numpy_window_process(np.float64)
    for w in dev:
        win = next(x for x in op.windows(iter(pts)) if x.start == w.start)
        t = twin(win)
        assert _stats_close64(t.stats, w.stats, w.window_count)
    assert _not_f32([s[0] for w in dev for s in w.stats.values()])


def test_tstats_run_soa_matches_jax(x64):
    rng = np.random.default_rng(206)
    ts, xs, ys, oids = TT._stream(rng, 3000, n_obj=40)
    conf = TT._conf(10.0, 5.0)
    op, jop = TT._ops(PointTStatsQuery, jtraj.PointTStatsQuery, conf)
    got = list(op.run_soa(TT._chunks(ts, xs, ys, oids), 64))
    want = list(jop.run_soa(TT._chunks(ts, xs, ys, oids), 64))
    assert len(got) == len(want) == 7
    for g, w in zip(got, want):
        assert g[0:2] == w[0:2]
        assert _sums_close64(g[2], w[2], g[4])
        assert np.array_equal(g[3], np.asarray(w[3]))
        assert np.array_equal(g[4], np.asarray(w[4]))


def _pane_stream(rng, n=6000, k=64, span=4000):
    ts = np.sort(rng.integers(0, span, n)).astype(np.int64)
    oid = rng.integers(0, k, n).astype(np.int64)
    xy = 116.0 + rng.uniform(0, 1, (n, 2))  # raw degrees: float64 matters
    return ts, xy, oid


def test_tstats_device_pane_engine_follows_x64():
    """``traj_stats_sliding(backend="device")`` with x64 on: float64
    lanes and spatial sums, equal to the JAX device engine under x64
    (starts, counts and temporal sums exact, spatial within
    ``pane_spatial_bound``, which is then float64's) and to the port's
    numpy engine; x64 off: the float32 engine, as the JAX engine takes
    float32 lanes with its x64 off."""
    rng = np.random.default_rng(207)
    ts, xy, oid = _pane_stream(rng)
    args = (ts, xy, oid, 64, 1000, 100)
    with precision.x64(True):
        lanes, _, _ = tpanes.pane_operands(ts, xy, oid, 64, 100)
        assert lanes[1].dtype == lanes[2].dtype == np.float64
        got = tpanes.traj_stats_sliding(*args, backend="device",
                                        device="cpu")
        bound = tpanes.pane_spatial_bound(*args)
    want = jpanes.traj_stats_sliding(*args, backend="device")
    host = tpanes.traj_stats_sliding(*args, backend="numpy")
    assert got.spatial.dtype == np.float64
    assert np.asarray(want.spatial).dtype == np.float64
    for ref in (want, host):
        assert np.array_equal(got.starts, ref.starts)
        assert np.array_equal(got.count, ref.count)
        assert np.array_equal(got.temporal, np.asarray(ref.temporal))
        assert np.all(np.abs(got.spatial - np.asarray(ref.spatial))
                      <= bound[None, :])
    # float64's bound is float32's over 2^29.
    with precision.x64(False):
        bound32 = tpanes.pane_spatial_bound(*args)
        lanes32, _, _ = tpanes.pane_operands(ts, xy, oid, 64, 100)
        off = tpanes.traj_stats_sliding(*args, backend="device",
                                        device="cpu")
    assert lanes32[1].dtype == np.float32 and off.spatial.dtype == np.float32
    assert np.allclose(bound32 / bound, 2.0 ** 29, rtol=1e-3)
    assert np.max(np.abs(off.spatial - host.spatial)) > \
        np.max(np.abs(got.spatial - host.spatial))


def test_tstats_device_engine_ignores_the_operator_dtype():
    """The engine takes no dtype: with x64 on it is float64 even where a
    float32 operator run sits beside it, as in the JAX package."""
    rng = np.random.default_rng(208)
    ts, xy, oid = _pane_stream(rng, n=500)
    with precision.x64(True):
        res = tpanes.traj_stats_sliding(ts, xy, oid, 64, 1000, 100,
                                        backend="device", device="cpu")
        op = PointTStatsQuery(TT._conf(10.0, 5.0)[0], UniformGrid(**TT.GRID),
                              device="cpu")
        chunks = TT._chunks(ts, xy[:, 0] - 116 + 2, xy[:, 1] - 116 + 2,
                            oid.astype(np.int32), 2)
        soa32 = list(op.run_soa(chunks, 64, dtype=np.float32))
    assert res.spatial.dtype == np.float64
    assert soa32 and all(w[2].dtype == np.float32 for w in soa32)


# ---------------------------------------------------------------------------
# tJoin: run, run_single, run_soa


def test_tjoin_run_matches_jax(x64):
    """The budgets grow as in the JAX run; the first windows are
    one-sided."""
    rng = np.random.default_rng(209)
    left, jleft = TT._walks(rng, n_traj=40, pts_per=30, prefix="l",
                            step=1000)
    right, jright = TT._walks(rng, n_traj=30, pts_per=20, prefix="r",
                              step=500, t0=20_000)
    op, jop = TT._ops(PointPointTJoinQuery, jtraj.PointPointTJoinQuery,
                      cap=48)
    got = list(op.run(iter(left), iter(right), 2.5))
    want = list(jop.run(iter(jleft), iter(jright), 2.5))
    assert TT._join_pairs(got) == TT._join_pairs(want)
    for g, w in zip(got, want):
        assert _within([d for *_, d in g.pairs], [d for *_, d in w.pairs])
    assert not got[0].pairs and got[2].pairs
    assert _not_f32([d for g in got for *_, d in g.pairs])
    assert op._max_pairs == jop._max_pairs > 1024
    assert op._max_tpairs == jop._max_tpairs > 256


def test_tjoin_run_single_matches_jax(x64):
    rng = np.random.default_rng(210)
    pts, jpts = TT._walks(rng, n_traj=5)
    op, jop = TT._ops(PointPointTJoinQuery, jtraj.PointPointTJoinQuery,
                      cap=24)
    got = list(op.run_single(iter(pts), 1.0))
    want = list(jop.run_single(iter(jpts), 1.0))
    assert TT._join_pairs(got) == TT._join_pairs(want)
    for g, w in zip(got, want):
        assert _within([d for *_, d in g.pairs], [d for *_, d in w.pairs])
    assert all(a.obj_id != b.obj_id for g in got for a, b, _ in g.pairs)
    assert _not_f32([d for g in got for *_, d in g.pairs])


def test_tjoin_run_soa_matches_jax_and_one_sided_windows_are_float64(x64):
    rng = np.random.default_rng(211)
    conf = TT._conf(10.0, 5.0)
    lt, lx, ly, lo = TT._stream(rng, 1500, n_obj=24)
    rt, rx, ry, ro = TT._stream(rng, 1200, n_obj=22, t0=10_000)
    op, jop = TT._ops(PointPointTJoinQuery, jtraj.PointPointTJoinQuery, conf,
                      cap=48)
    got = list(op.run_soa(TT._chunks(lt, lx, ly, lo),
                          TT._chunks(rt, rx, ry, ro), 1.0, 32, max_pairs=128))
    want = list(jop.run_soa(TT._chunks(lt, lx, ly, lo),
                            TT._chunks(rt, rx, ry, ro), 1.0, 32,
                            max_pairs=128))
    assert len(got) == len(want) > 4
    for g, w in zip(got, want):
        assert g[0:2] == w[0:2] and g[5:] == w[5:]
        assert np.array_equal(g[2], w[2]) and np.array_equal(g[3], w[3])
        assert _within(g[4], w[4])
    # The right stream starts 10 s late: the first window is one-sided,
    # empty and float64, as JAX's.
    assert got[0][5] == 0 and got[0][4].dtype == want[0][4].dtype == \
        np.float64
    assert _not_f32(np.concatenate([g[4] for g in got]))
    assert op._max_tpairs == jop._max_tpairs > 256


# ---------------------------------------------------------------------------
# tJoin's pane carry


def _tp_fields64(rng, s, pc, gn, n_obj, extent=10.0):
    """``test_torch_tjoin_panes._pane_fields`` with raw float64
    coordinates, as the float64 mode ships them."""
    xy = rng.uniform(-0.3, extent + 0.3, (s * pc, 2))
    cl = extent / gn
    xi = np.floor(xy[:, 0] / cl).astype(np.int64)
    yi = np.floor(xy[:, 1] / cl).astype(np.int64)
    ing = (xi >= 0) & (xi < gn) & (yi >= 0) & (yi < gn)
    valid = ing & (rng.random(s * pc) > 0.05)
    cell = np.where(ing, xi * gn + yi, 0).astype(np.int32)
    rank = jtp.pane_cell_ranks(np.repeat(np.arange(s), pc), cell,
                               valid=valid)
    arrs = (xy[:, 0].copy(), xy[:, 1].copy(), xi.astype(np.int32),
            yi.astype(np.int32), cell, rank.astype(np.int32),
            rng.integers(0, n_obj, s * pc).astype(np.int32), valid)
    return tuple(a.reshape(s, pc) for a in arrs)


def _assert_carry64(port, jax_carry):
    for name, j, t in zip(ttp.TJoinPaneCarry._fields, jax_carry, port):
        t = t.numpy()
        j = np.asarray(j)
        if t.ndim:
            t, j = t[:-1], j.reshape(-1)
        if j.dtype.kind == "f":
            assert t.dtype == j.dtype == np.float64, name
            fin = np.isfinite(j)
            assert np.array_equal(fin, np.isfinite(t)), name
            assert _within(t[fin], j[fin]), name
        else:
            assert np.array_equal(t, j), name


@pytest.mark.parametrize("cap_c", [0, 16])
def test_float64_scan_matches_jax(cap_c, x64):
    rng = np.random.default_rng(212 + cap_c)
    s, pc, gn, k, ppw, cap_w = 30, 64, 10, 8, 10, 32
    lf = _tp_fields64(rng, s, pc, gn, k)
    rf = _tp_fields64(rng, s, pc, gn, k)
    kw = dict(grid_n=gn, cap_w=cap_w, layers=1, ppw=ppw, num_ids=k,
              pair_sel=64, cap_c=cap_c)
    j0 = jtp.tjoin_pane_init(gn * gn, cap_w, ppw, k, jnp.float64)
    jc, jw = jtp.tjoin_pane_scan(
        j0, jnp.arange(s, dtype=jnp.int32), tuple(map(jnp.asarray, lf)),
        tuple(map(jnp.asarray, rf)), 0.8, **kw)
    carry = ttp.tjoin_pane_init(gn * gn, cap_w, ppw, k, np.float64,
                                device="cpu")
    assert carry.lwx.dtype == carry.digests.dtype == torch.float64
    tc, tw = ttp.tjoin_pane_scan(carry, range(s), TTP._tensors(lf),
                                 TTP._tensors(rf), 0.8, **kw)
    _assert_carry64(tc, jc)
    tw, jw = tw.numpy(), np.asarray(jw)
    assert tw.dtype == jw.dtype == np.float64
    assert np.array_equal(np.isfinite(tw), np.isfinite(jw))
    assert _within(tw[np.isfinite(jw)], jw[np.isfinite(jw)])
    assert np.isfinite(jw).sum() > 300
    assert int(tc.cap_overflow) == int(tc.cmp_overflow) == 0


def test_a_jax_float64_tjoin_carry_stays_float64(x64):
    """A JAX float64 carry warmed over ppw panes, moved to the port
    through ``state.tjoin_pane_carry_from_jax``: float64, bit for bit,
    and its continued scan equals the JAX steady scan's minima."""
    rng = np.random.default_rng(214)
    ppw, steady, pc, gn, k, cap_w = 12, 16, 64, 10, 8, 64
    s = ppw + steady
    lf = _tp_fields64(rng, s, pc, gn, k)
    rf = _tp_fields64(rng, s, pc, gn, k)
    kw = dict(grid_n=gn, cap_w=cap_w, layers=1, ppw=ppw, num_ids=k,
              pair_sel=32, cap_c=32)

    def part(f, lo, hi):
        return tuple(a[lo:hi] for a in f)

    j0 = jtp.tjoin_pane_init(gn * gn, cap_w, ppw, k, jnp.float64)
    warm, _ = jtp.tjoin_pane_scan(
        j0, jnp.arange(ppw, dtype=jnp.int32),
        tuple(map(jnp.asarray, part(lf, 0, ppw))),
        tuple(map(jnp.asarray, part(rf, 0, ppw))), 0.8, **kw)
    lx = (jnp.asarray(lf[4][:steady]), jnp.asarray(lf[7][:steady]))
    rx = (jnp.asarray(rf[4][:steady]), jnp.asarray(rf[7][:steady]))
    jc, jw = jtp.tjoin_pane_scan(
        warm, jnp.arange(ppw, s, dtype=jnp.int32),
        tuple(map(jnp.asarray, part(lf, ppw, s))),
        tuple(map(jnp.asarray, part(rf, ppw, s))), 0.8,
        lps_expire=lx, rps_expire=rx, **kw)
    carry = tjoin_pane_carry_from_jax(warm, device="cpu")
    assert carry.lwx.dtype == carry.digests.dtype == \
        carry.block_digests.dtype == torch.float64
    for name in ("lwx", "rwy", "digests"):
        a = getattr(carry, name).numpy()[:-1]
        b = np.asarray(getattr(warm, name)).reshape(-1)
        assert np.array_equal(_bits(a), _bits(b)), name
    tc, tw = ttp.tjoin_pane_scan(
        carry, range(ppw, s), TTP._tensors(part(lf, ppw, s)),
        TTP._tensors(part(rf, ppw, s)), 0.8,
        lps_expire=TTP._tensors((lf[4][:steady], lf[7][:steady])),
        rps_expire=TTP._tensors((rf[4][:steady], rf[7][:steady])), **kw)
    _assert_carry64(tc, jc)
    tw, jw = tw.numpy(), np.asarray(jw)
    assert tw.dtype == np.float64
    assert np.array_equal(np.isfinite(tw), np.isfinite(jw))
    assert _within(tw[np.isfinite(jw)], jw[np.isfinite(jw)])
    assert np.isfinite(jw).sum() > 100


def test_float64_radius_sq_bound():
    """The largest float64 d² whose correctly rounded root is at most r:
    ``sqrt(d²) <= r`` exactly when ``d² <= bound``, checked over the
    float64 values around r²; float32's bound is unchanged."""
    for r in (0.001, 0.8, 1e-7, 3.0, 0.0017):
        b = ttp.radius_sq_bound(r, np.float64)
        x = np.float64(r) * np.float64(r)
        for k in range(-40, 41):
            y = x
            step = np.inf if k > 0 else 0.0
            for _ in range(abs(k)):
                y = np.nextafter(y, step)
            assert (np.sqrt(y) <= np.float64(r)) == (y <= b), (r, k)
        assert np.sqrt(np.float64(b)) <= r < np.sqrt(
            np.nextafter(np.float64(b), np.inf))
        assert ttp.radius_sq_bound(r) == ttp.radius_sq_bound(r, np.float32)
    assert ttp.radius_sq_bound(-1.0, np.float64) == -1.0
    assert ttp.radius_sq_bound(np.inf, np.float64) == np.inf


def _jax_tjoin(window, slide):
    return jtraj.TJoinQuery(JConf(JQT.WindowBased, window_size=window,
                                  slide_step=slide), JGrid(**TTP.GRID))


@pytest.mark.parametrize("backend", ["device", "native"])
def test_tjoin_run_soa_panes_matches_jax(backend, x64):
    rng = np.random.default_rng(215)
    left = TTP._chunks(rng, 1500, 4_000, 24)
    right = TTP._chunks(rng, 1500, 4_000, 24, shift=0.3)
    op = TTP._port(1.0, 0.1)
    got = list(op.run_soa_panes(TTP._copies(left), TTP._copies(right), 0.4,
                                24, backend=backend))
    want = list(_jax_tjoin(1.0, 0.1).run_soa_panes(
        TTP._copies(left), TTP._copies(right), 0.4, 24, backend=backend))
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert g[0:2] == w[0:2] and g[5:] == w[5:]
        assert np.array_equal(g[2], w[2]) and np.array_equal(g[3], w[3])
        assert g[4].dtype == w[4].dtype == np.float64
        if backend == "native":  # the same C++ engine on the same lanes
            assert np.array_equal(_bits(g[4]), _bits(w[4]))
        else:
            assert _within(g[4], w[4])
    assert sum(g[5] for g in got) > 1000
    assert _not_f32(np.concatenate([g[4] for g in got]))
    if backend == "device":
        assert op.pane_scans and op.pane_scans[-1][3:] == (0, 0, 0)


def test_tjoin_run_soa_panes_equals_run_soa_in_float64(x64):
    rng = np.random.default_rng(216)
    left = TTP._chunks(rng, 800, 3_000, 16)
    right = TTP._chunks(rng, 800, 3_000, 16, shift=0.2)
    panes = list(TTP._port(1.0, 0.5).run_soa_panes(
        TTP._copies(left), TTP._copies(right), 0.4, 16, backend="device"))
    soa = list(TTP._port(1.0, 0.5, cap=16).run_soa(
        TTP._copies(left), TTP._copies(right), 0.4, 16))
    assert all(w[6] == 0 for w in soa)  # no cell past the cap
    soa = [w for w in soa if w[5]]
    panes = [w for w in panes if w[5]]
    assert len(panes) == len(soa) > 2
    for a, b in zip(panes, soa):
        order = np.lexsort((b[3], b[2]))
        assert a[:2] == b[:2] and a[5] == b[5]
        assert np.array_equal(a[2], b[2][order])
        assert np.array_equal(a[3], b[3][order])
        assert a[4].dtype == b[4].dtype == np.float64
        assert np.array_equal(_bits(a[4]), _bits(b[4][order]))


# ---------------------------------------------------------------------------
# tJoin at the radius

#: Offsets, in float64 ulps of 5.0, of seven right trajectories from the
#: point 0.001 right of the left trajectory's.
EDGE_STEPS = np.arange(-3, 4)


def _edge_chunks():
    """A left trajectory (oid 0) at (5, 5) and seven right ones (oids
    0..6) a few float64 ulps either side of 0.001 to its right, all at
    t = 100 ms."""
    x0 = 5.0
    xs = []
    for k in EDGE_STEPS:
        x = np.float64(x0 + 0.001)
        for _ in range(abs(int(k))):
            x = np.nextafter(x, np.inf if k > 0 else 0.0)
        xs.append(x)
    n = len(xs)
    left = [{"ts": np.array([100], np.int64), "x": np.array([x0]),
             "y": np.array([5.0]), "oid": np.zeros(1, np.int32)}]
    right = [{"ts": np.full(n, 100, np.int64), "x": np.array(xs),
              "y": np.full(n, 5.0), "oid": np.arange(n, dtype=np.int32)}]
    return left, right


@pytest.mark.parametrize("path", ["run_soa", "device", "native"])
def test_tjoin_at_the_radius_keeps_exactly_the_jax_pairs(path, x64):
    """Exactly JAX's pairs and distances at the radius; the same call on
    the centred float32 lanes (``dtype=np.float32``) decides the seven
    alike, all kept or none, where float64 keeps some."""
    def run(op, **kw):
        left, right = _edge_chunks()
        if path == "run_soa":
            res = op.run_soa(left, right, 0.001, 8, **kw)
        else:
            res = op.run_soa_panes(left, right, 0.001, 8, backend=path,
                                   **kw)
        return [(w[3].tolist(), w[4]) for w in res if w[5]]

    got = run(TTP._port(1.0, 1.0))
    want = run(_jax_tjoin(1.0, 1.0))
    assert len(got) == len(want) == 1
    (gi, gd), (wi, wd) = got[0], want[0]
    assert gi == wi and 0 < len(wi) < len(EDGE_STEPS)
    assert gd.dtype == np.float64
    assert np.array_equal(_bits(gd), _bits(wd))
    f32 = run(TTP._port(1.0, 1.0), dtype=np.float32)
    assert [ids for ids, _ in f32] in ([], [list(range(len(EDGE_STEPS)))])


def test_an_empty_tjoin_window_is_float64(x64):
    """A window with points on both sides and no pair within the radius:
    ``run_soa`` and both ``run_soa_panes`` engines yield empty float64
    distances, as the JAX operators do."""
    left, right = _edge_chunks()
    got = list(TTP._port(1.0, 1.0).run_soa(left, right, 1e-6, 8))
    want = list(_jax_tjoin(1.0, 1.0).run_soa(left, right, 1e-6, 8))
    assert [(w[0], w[5]) for w in got] == [(w[0], w[5]) for w in want] == \
        [(0, 0)]
    assert got[0][4].dtype == want[0][4].dtype == np.float64
    for backend in ("device", "native"):
        got = list(TTP._port(1.0, 1.0).run_soa_panes(left, right, 1e-6, 8,
                                                     backend=backend))
        assert got and all(w[5] == 0 and w[4].dtype == np.float64
                           for w in got)


# ---------------------------------------------------------------------------
# The mesh runs: A14.2c


def test_float64_mesh_runs_and_the_mesh_scan_raise_a14_2c(x64):
    """The four calls this file held refused until A14.2c ported them, on
    a two-shard CPU mesh in the float64 mode: tStats ``run``, tJoin's
    ``run_soa_panes``, ``QServeOperator.run`` and the mesh scan of a
    float64 tJoin carry each run and equal the unsharded run (tStats'
    spatial sums within the float64 ``spatial_sum_bound``, the rest bit
    for bit), their distances float64; float32 on the same mesh runs as
    before."""
    from spatialflink_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh((2,), ("data",), devices=["cpu", "cpu"])
    conf = TT._conf(10.0)[0]
    grid = UniformGrid(**TT.GRID)
    pts, _ = TT._walks(np.random.default_rng(230), n_traj=4, pts_per=20)

    def tstats(m):
        return [(w.start, w.end, w.stats) for w in PointTStatsQuery(
            conf, grid, device="cpu").run(iter(pts), mesh=m)]

    got, want = tstats(mesh), tstats(None)
    assert [w[:2] for w in got] == [w[:2] for w in want] and got
    assert all(_stats_close64(g[2], w[2], len(pts))
               for g, w in zip(got, want))
    assert _not_f32([s[0] for w in got for s in w[2].values()])

    def tjoin(m):
        return [(w[3].tolist(), w[4]) for w in PointPointTJoinQuery(
            TT._conf(1.0)[0], grid, device="cpu").run_soa_panes(
                *_edge_chunks(), 0.001, 8, backend="device", mesh=m)
            if w[5]]

    got, want = tjoin(mesh), tjoin(None)
    assert [g[0] for g in got] == [w[0] for w in want] and got
    assert all(np.array_equal(_bits(g[1]), _bits(w[1]))
               for g, w in zip(got, want))
    assert all(g[1].dtype == np.float64 for g in got)

    def served(m):
        sq = qserve.StandingQuery(qid="q", tenant="t", kind="knn", x=5.0,
                                  y=5.0, radius=3.0, k=3)
        stream = [qserve.QServeCommand(timestamp=0, action="register",
                                       uid="u", query=sq)] + pts
        try:
            return [row for res in qserve.QServeOperator(
                conf, grid, device="cpu").run(iter(stream), mesh=m)
                for row in res.rows]
        finally:
            qserve.uninstall()

    got, want = served(mesh), served(None)
    assert got == want and _not_f32([row[4] for row in got])

    rng = np.random.default_rng(231)
    lf = _tp_fields64(rng, 6, 16, 4, 4)
    rf = _tp_fields64(rng, 6, 16, 4, 4)

    def scan(m):
        carry = ttp.tjoin_pane_init(16, 8, 2, 4, np.float64, device="cpu")
        return ttp.tjoin_pane_scan(carry, range(6), TTP._tensors(lf),
                                   TTP._tensors(rf), 0.8, 4, 8, 1, 2, 4, 16,
                                   mesh=m)

    (gc, gw), (wc, ww) = scan(mesh), scan(None)
    assert gw.dtype == torch.float64 and torch.isfinite(gw).any()
    assert np.array_equal(_bits(gw.numpy()), _bits(ww.numpy()))
    assert all(torch.equal(a, b) for a, b in zip(gc, wc))
    # float32 on the same mesh is ported.
    assert list(PointTStatsQuery(conf, grid, device="cpu").run(
        iter([]), mesh=mesh, dtype=np.float32)) == []


# ---------------------------------------------------------------------------
# The standing-query server


@pytest.fixture
def clean_qserve():
    yield
    for pkg in (TQ.JAX, TQ.PORT):
        pkg.faults.disarm()
        pkg.qs.uninstall()
        pkg.ov.uninstall()
        pkg.slo.uninstall()
        pkg.tel.enable()
        pkg.tel.disable()


def test_qserve_run_matches_jax_in_float64(x64, clean_qserve):
    """The churn stream of ``tests/test_torch_qserve.py`` (1/64 lattice:
    x² + y² exact, so the float64 roots are the same bits in both
    packages), served in float64 by both: the same egress lines, their
    distances float64."""
    def scenario(pkg):
        ctrl = pkg.ov.install(pkg.ov.OverloadController(
            TQ._budget_policy(pkg)))
        op = TQ._op(pkg)
        res = list(op.run(iter(TQ._churn_stream(pkg))))
        return TQ._lines(res), op.registry.state(), ctrl.snapshot(), res

    (jl, jstate, jsnap, _), (tl, state, snap, res) = TQ.twin(scenario)
    assert len(tl) > 100 and tl == jl
    assert state == jstate and snap == jsnap
    assert _not_f32([row[4] for r in res for row in r.rows])


def test_qserve_serve_window_matches_jax_off_the_lattice(x64, clean_qserve):
    """``serve_window`` on points off the lattice: the same objects in
    the same order, float64 distances within 1 ulp of the JAX
    program's."""
    rng = np.random.default_rng(217)
    qs = [dict(qid=f"q{i}", tenant=f"t{i % 3}",
               kind=("knn", "range")[i % 2], x=float(rng.uniform(2, 8)),
               y=float(rng.uniform(2, 8)), radius=float(rng.uniform(1, 3)),
               k=5) for i in range(6)]
    xy = rng.uniform(0, 10, (150, 2))

    def scenario(pkg):
        op = TQ._op(pkg)
        cmds = [pkg.qs.QServeCommand(timestamp=0, action="register",
                                     uid=f"u{i}",
                                     query=pkg.qs.StandingQuery(**q))
                for i, q in enumerate(qs)]
        pts = [pkg.Point(obj_id=f"o{i % 40}", timestamp=10 * i,
                         x=float(x), y=float(y)) for i, (x, y) in
               enumerate(xy)]
        kernel = (j_jitted(jqr.registry_bucket_kernel, "k", "num_segments",
                           "query_block") if pkg is TQ.JAX
                  else jitted(tqr.registry_bucket_kernel))
        return [op.serve_window(win, kernel).rows
                for win in op.windows(iter(cmds + pts))]

    want, got = TQ.twin(scenario)
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert [r[:4] for r in g] == [r[:4] for r in w]
        assert _within([r[4] for r in g], [r[4] for r in w])
    assert _not_f32([r[4] for g in got for r in g])


def test_an_empty_qserve_result_is_float64(x64):
    """A query with no point within its radius: the registry program's
    rows are the float64 sentinel, as JAX's are, and the operator's
    window has no row, its query lanes float64."""
    rng = np.random.default_rng(218)
    xy = rng.uniform(0, 1, (64, 2))
    n_cells = 17
    args = (xy, np.ones(64, bool), np.zeros(64, np.int32),
            np.ones((8, n_cells + 1), bool),
            (np.arange(64) % 5).astype(np.int32),
            np.full((8, 2), 9.0), np.full(8, 0.5), np.arange(8) < 3)
    t = tqr.registry_bucket_kernel(
        *(torch.from_numpy(np.asarray(a)) for a in args), k=4,
        num_segments=8, query_block=8)
    j = jqr.registry_bucket_kernel(*(jnp.asarray(a) for a in args), k=4,
                                   num_segments=8, query_block=8)
    assert t.dist.dtype == torch.float64 and np.asarray(j.dist).dtype == \
        np.float64
    assert np.array_equal(t.dist.numpy(), np.asarray(j.dist))
    assert np.all(t.dist.numpy() == F64_MAX)
    assert t.within.tolist() == np.asarray(j.within).tolist() == [0] * 8
    # The operator on such a window: no rows.
    op = qserve.QServeOperator(TT._conf(1.0)[0], UniformGrid(**TT.GRID),
                               device="cpu")
    far = qserve.StandingQuery(qid="q", tenant="t", kind="range", x=9.5,
                               y=9.5, radius=0.01, k=3)
    stream = [qserve.QServeCommand(timestamp=0, action="register", uid="u",
                                   query=far)]
    stream += [Point(obj_id=f"o{i}", timestamp=10 * i, x=1.0 + i / 7,
                     y=1.0) for i in range(5)]
    try:
        res = list(op.run(iter(stream)))
    finally:
        qserve.uninstall()
    assert res and all(r.rows == [] for r in res)
    arrays = op._bucket_dev[next(iter(op._bucket_dev))]
    assert arrays["qxy"].dtype == torch.float64
    assert arrays["ck"][3] == np.dtype(np.float64).str


# ---------------------------------------------------------------------------
# Resume through the driver


def test_tjoin_run_soa_panes_resumes_in_float64(x64, tmp_path):
    """``tests/test_torch_driver.py``'s kill → resume leg in the float64
    mode: the resumed egress is the clean run's, byte for byte, and its
    distances are float64."""
    import test_torch_driver as TD

    d = tmp_path / "x64"
    d.mkdir()
    TD.chaos_tjoin_panes(d, "driver.window")
    lines = (d / "clean" / "egress.csv").read_text().split()
    assert _not_f32([float(line.split(",")[4]) for line in lines])


def _qserve_leg64(pkg, workdir, fault_plan=None):
    """``test_torch_qserve._qserve_leg`` at the default dtype."""
    ctrl = pkg.ov.install(pkg.ov.OverloadController(TQ._budget_policy(pkg)))
    op = TQ._op(pkg)
    sink = pkg.Sink(os.path.join(workdir, "egress.csv"))
    drv = pkg.drv.WindowedDataflowDriver(
        checkpoint_path=os.path.join(workdir, "ckpt.bin"),
        checkpoint_every=2, sink=sink,
        retry=pkg.drv.RetryPolicy(max_retries=0, backoff_s=0.0),
        failover=False, overload=ctrl)
    if fault_plan:
        pkg.faults.arm(fault_plan)
    try:
        for res in op.run(iter(TQ._churn_stream(pkg)), driver=drv):
            for line in res.lines():
                sink.stage(line)
    finally:
        pkg.faults.disarm()
        pkg.qs.uninstall()
        pkg.ov.uninstall()
    return drv


def test_qserve_run_resumes_in_float64(x64, tmp_path, clean_qserve):
    clean, chaos, jclean = (tmp_path / d for d in ("clean", "chaos",
                                                    "jclean"))
    for d in (clean, chaos, jclean):
        d.mkdir()
    _qserve_leg64(TQ.PORT, str(clean))
    want = (clean / "egress.csv").read_bytes()
    assert want.count(b"\n") > 100
    _qserve_leg64(TQ.JAX, str(jclean))
    assert (jclean / "egress.csv").read_bytes() == want
    with pytest.raises(TQ.InjectedFault):
        _qserve_leg64(TQ.PORT, str(chaos), fault_plan=TQ.KILL)
    assert 0 < len((chaos / "egress.csv").read_bytes()) < len(want)
    drv = _qserve_leg64(TQ.PORT, str(chaos))
    assert drv.stats["resumed"] is True
    assert (chaos / "egress.csv").read_bytes() == want
    dists = [float(line.split(",")[-1]) for line in
             want.decode().split()]
    assert _not_f32(dists)
