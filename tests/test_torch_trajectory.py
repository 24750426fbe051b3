"""Parity of the PyTorch port's trajectory layer with the JAX package:
``ops/trajectory.py`` op by op, and the six t* operator families
(``run``, ``run_soa``, tJoin's ``run_single``).

The same inputs, made with numpy from a seed, go through the JAX function
or operator and its port counterpart. The port runs on the CPU, where
B3's wrapper takes its plain PyTorch version; the JAX tJoin takes its CPU
path (the XLA bucketed join, since Pallas joins are TPU-only), on a
16 × 16 grid to stay small. The test configuration turns x64 on, so the
JAX operators are called with ``dtype=np.float32`` and the ops are fed
float32 coordinates: both sides then compute in float32.

Contracts held:
- integer results (counts, temporal sums, timestamps, spans, pair keys,
  hit sets) exact;
- float32 sums: the ops bit-equal on the CPU (the port's ``index_add_``
  and the JAX ``segment_sum`` both add in lane order there, and the JAX
  ops run eagerly); the JAX operators' jitted programs may contract
  dx² + dy² into a fused multiply-add, which moves each term by at most
  1 ulp, so operator spatial sums are held to
  ``ops/trajectory.py:spatial_sum_bound`` over the window's terms and
  their sum (which covers that and any order of the additions; the card
  adds in another order, ``tests/test_torch_kernels_cuda.py``);
- tJoin: the same trajectory pairs in the same order, and the same
  minimum distances within 1 float32 ulp. Both sides take the root of
  the same float32 d² = dx² + dy², the port correctly rounded
  (``sqrt_rn``); the JAX CPU join may contract the square sum into a
  fused multiply-add, which can move d² by one rounding (and so the root
  by at most 1 ulp). The pair set is fixed by the key-ordered dedup;
- tKnn: the same objIDs in the same order, distances within 1 ulp (the
  same reason);
- operators' results (sub-trajectories, cells, stats) equal, float
  stats within the rule above; one-sided tJoin windows empty on both
  sides (the port's distance array is float32, the JAX one float64:
  ROADMAP's standing deviation);
- a port operator started from a JAX operator's state
  (``state.trajectory_state_from_jax``) gives the JAX operator's next
  windows.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spatialflink_tpu.grid import UniformGrid as JGrid
from spatialflink_tpu.models.objects import Point as JPoint
from spatialflink_tpu.models.objects import Polygon as JPolygon
from spatialflink_tpu.operators import QueryConfiguration as JConf
from spatialflink_tpu.operators import QueryType as JQT
from spatialflink_tpu.operators import trajectory as jtraj
from spatialflink_tpu.ops import trajectory as jops

from spatialflink_tpu_torch.grid import UniformGrid
from spatialflink_tpu_torch.models.objects import Point, Polygon
from spatialflink_tpu_torch.operators import (
    PointPointTJoinQuery,
    PointPointTKNNQuery,
    PointPolygonTRangeQuery,
    PointTAggregateQuery,
    PointTFilterQuery,
    PointTStatsQuery,
    QueryConfiguration,
    QueryType,
)
from spatialflink_tpu_torch.operators import trajectory as ttraj
from spatialflink_tpu_torch.ops import trajectory as tops
from spatialflink_tpu_torch.state import (
    interner_from_jax,
    trajectory_state_from_jax,
)

GRID = dict(num_partitions=16, min_x=0.0, max_x=10.0, min_y=0.0, max_y=10.0)
SQUARE = np.array([[4, 4], [6, 4], [6, 6], [4, 6], [4, 4]], float)
TRI = np.array([[1, 7], [3.5, 9.2], [0.5, 9.5], [1, 7]], float)


def _conf(window=10.0, slide=None, **kw):
    slide = window if slide is None else slide
    qt = kw.pop("query_type", QueryType.WindowBased)
    return (QueryConfiguration(qt, window_size=window, slide_step=slide,
                               **kw),
            JConf(JQT[qt.name], window_size=window, slide_step=slide, **kw))


def _ops(port_cls, jax_cls, conf=None, port_kw=None, **kw):
    conf = conf or _conf()
    return (port_cls(conf[0], UniformGrid(**GRID), device="cpu",
                     **(port_kw or {}), **kw),
            jax_cls(conf[1], JGrid(**GRID), **kw))


def _walks(rng, n_traj=6, pts_per=40, prefix="tr", step=750, t0=0):
    """Random walks, one per objID, as (port Points, JAX Points) built from
    the same numbers, sorted by time."""
    rows = []
    for t in range(n_traj):
        x, y = rng.uniform(2, 8), rng.uniform(2, 8)
        for i in range(pts_per):
            x = float(np.clip(x + rng.normal(0, 0.4), 0, 10))
            y = float(np.clip(y + rng.normal(0, 0.4), 0, 10))
            rows.append((f"{prefix}{t}", t0 + i * step + t, x, y))
    rows.sort(key=lambda r: r[1])
    return ([Point(obj_id=o, timestamp=ts, x=x, y=y) for o, ts, x, y in rows],
            [JPoint(obj_id=o, timestamp=ts, x=x, y=y)
             for o, ts, x, y in rows])


def _stream(rng, n, n_obj=8, t_max=30_000, t0=0):
    ts = np.sort(rng.integers(t0, t_max, n)).astype(np.int64)
    return (ts, rng.uniform(0, 10, n), rng.uniform(0, 10, n),
            rng.integers(0, n_obj, n).astype(np.int32))


def _chunks(ts, xs, ys, oids, n_chunks=4):
    bounds = np.linspace(0, len(ts), n_chunks + 1).astype(int)
    return [{"ts": ts[a:b], "x": xs[a:b], "y": ys[a:b], "oid": oids[a:b]}
            for a, b in zip(bounds[:-1], bounds[1:])]


def _within_ulp(a, b):
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    return a.shape == b.shape and bool(np.all(
        np.abs(a.astype(np.float64) - b) <= np.spacing(np.maximum(
            np.abs(a), np.abs(b)))))


def _sums_close(got, want, n_terms):
    """float32 spatial sums of nonnegative terms within
    ``spatial_sum_bound(n_terms, sum)``."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    bound = tops.spatial_sum_bound(n_terms, np.maximum(got, want))
    return got.shape == want.shape and bool(np.all(np.abs(got - want)
                                                   <= bound))


def _stats_close(got, want, n_terms):
    """tStats dicts: the same objIDs, temporal lengths exact, spatial
    lengths and ratios within the sum bound."""
    if got.keys() != want.keys():
        return False
    keys = sorted(got)
    if [got[k][1] for k in keys] != [want[k][1] for k in keys]:
        return False
    t = np.array([max(got[k][1], 1) for k in keys], np.float64)
    return (_sums_close([got[k][0] for k in keys], [want[k][0] for k in keys],
                        n_terms)
            and _sums_close(np.array([got[k][2] for k in keys]) * t,
                            np.array([want[k][2] for k in keys]) * t,
                            n_terms + 2))


def _lines(trajs):
    return [(t.obj_id, t.timestamp, t.coords.tolist()) for t in trajs]


# ---------------------------------------------------------------------------
# ops/trajectory.py


def _sorted_lanes(rng, n=3000, nseg=64, n_obj=50, pad=100):
    ts = np.sort(rng.integers(0, 10_000, n)).astype(np.int64)
    oid = rng.integers(0, n_obj, n).astype(np.int32)
    xy = rng.uniform(-5, 5, (n, 2)).astype(np.float32)
    valid = np.ones(n, bool)
    valid[n - pad:] = False
    oid[n - pad:] = nseg - 1
    order = np.lexsort((ts, oid))
    return xy[order], ts[order], oid[order], valid[order]


def _both(fn_j, fn_t, lanes, **kw):
    return (fn_j(*map(jnp.asarray, lanes), **kw),
            fn_t(*map(torch.from_numpy, lanes), *kw.values()))


@pytest.mark.parametrize("fused", [False, True])
def test_traj_stats_kernels(fused):
    """traj_stats_kernel on (oid, ts)-sorted lanes, and the fused form on
    shuffled lanes with timestamp ties (the two stable sorts must give
    lexsort's permutation): every output bit-equal on the CPU."""
    rng = np.random.default_rng(1)
    lanes = _sorted_lanes(rng)
    fn_j, fn_t = jops.traj_stats_kernel, tops.traj_stats_kernel
    if fused:
        perm = rng.permutation(len(lanes[0]))
        xy, _, oid, valid = (a[perm] for a in lanes)
        lanes = (xy, rng.integers(0, 40, len(xy)).astype(np.int64), oid,
                 valid)
        fn_j, fn_t = jops.traj_stats_sorted_fused, tops.traj_stats_sorted_fused
    j, t = _both(fn_j, fn_t, lanes, num_segments=64)
    assert np.array_equal(np.asarray(j.spatial_length),
                          t.spatial_length.numpy())
    assert t.temporal_length.dtype == torch.int64
    assert np.array_equal(np.asarray(j.temporal_length),
                          t.temporal_length.numpy())
    assert np.array_equal(np.asarray(j.count), t.count.numpy())
    assert np.array_equal(np.asarray(j.avg_speed), t.avg_speed.numpy())


def test_sort_by_oid_ts_is_lexsort():
    rng = np.random.default_rng(2)
    ts = rng.integers(0, 5, 500).astype(np.int64)
    oid = rng.integers(0, 7, 500).astype(np.int32)
    valid = rng.random(500) > 0.2
    got = tops.sort_by_oid_ts(torch.from_numpy(ts), torch.from_numpy(oid),
                              torch.from_numpy(valid), 8).numpy()
    assert np.array_equal(got, np.lexsort((ts, np.where(valid, oid, 8))))


@pytest.mark.parametrize("max_tpairs", [512, 64])
def test_traj_pair_dedup_kernel(max_tpairs):
    """Keys ascending, min distances, padding and the true count equal,
    within and over the budget."""
    rng = np.random.default_rng(3)
    m = 5000
    li = rng.integers(0, 800, m).astype(np.int32)
    ri = rng.integers(0, 700, m).astype(np.int32)
    li[4000:] = -1
    ri[4000:] = -1
    d = rng.uniform(0, 1, m).astype(np.float32)
    ll = rng.integers(0, 20, 800).astype(np.int32)
    rl = rng.integers(0, 20, 700).astype(np.int32)
    j = jops.traj_pair_dedup_kernel(*map(jnp.asarray, (li, ri, d, ll, rl)),
                                    num_left=32, num_right=32,
                                    max_tpairs=max_tpairs)
    t = tops.traj_pair_dedup_kernel(*map(torch.from_numpy,
                                         (li, ri, d, ll, rl)),
                                    32, 32, max_tpairs)
    assert t.pair_key.dtype == torch.int64
    assert np.array_equal(np.asarray(j.pair_key), t.pair_key.numpy())
    assert np.array_equal(np.asarray(j.dist), t.dist.numpy())
    assert int(j.count) == int(t.count) == 400


def test_traj_cell_spans_and_hits_kernels():
    rng = np.random.default_rng(4)
    n = 2000
    ts = rng.integers(0, 1 << 40, n).astype(np.int64)
    pid = rng.integers(0, 100, n).astype(np.int32)
    valid = rng.random(n) > 0.1
    j = jops.traj_cell_spans_kernel(jnp.asarray(ts), jnp.asarray(pid),
                                    jnp.asarray(valid), num_pairs=128)
    t = tops.traj_cell_spans_kernel(torch.from_numpy(ts),
                                    torch.from_numpy(pid),
                                    torch.from_numpy(valid), 128)
    assert np.array_equal(np.asarray(j.min_ts), t.min_ts.numpy())
    assert np.array_equal(np.asarray(j.max_ts), t.max_ts.numpy())
    inside = rng.random(n) > 0.97
    oid = rng.integers(0, 200, n).astype(np.int32)
    jh = jops.traj_hits_kernel(jnp.asarray(inside), jnp.asarray(oid),
                               jnp.asarray(valid), num_segments=256)
    th = tops.traj_hits_kernel(torch.from_numpy(inside),
                               torch.from_numpy(oid),
                               torch.from_numpy(valid), 256)
    assert np.array_equal(np.asarray(jh), th.numpy()) and th.any()


def test_traj_range_hits_fused():
    from spatialflink_tpu.ops.polygon import pack_rings as j_pack

    rng = np.random.default_rng(5)
    n = 3000
    xy = rng.uniform(0, 10, (n, 2)).astype(np.float32)
    oid = rng.integers(0, 300, n).astype(np.int32)
    valid = np.ones(n, bool)
    packed = [j_pack([r], pad_to=8) for r in (SQUARE, TRI)]
    verts = np.stack([p[0] for p in packed]).astype(np.float32)
    ev = np.stack([p[1] for p in packed])
    lanes = (xy, valid, oid, verts, ev)
    j = jops.traj_range_hits_fused(*map(jnp.asarray, lanes),
                                   num_segments=512)
    t = tops.traj_range_hits_fused(*map(torch.from_numpy, lanes), 512)
    assert np.array_equal(np.asarray(j), t.numpy()) and t.sum() > 10


def test_stay_time_cells_kernel():
    rng = np.random.default_rng(6)
    _, ts, oid, valid = _sorted_lanes(rng)
    cell = rng.integers(0, 257, len(ts)).astype(np.int32)
    lanes = (ts, cell, oid, valid)
    jd, jc = jops.stay_time_cells_kernel(*map(jnp.asarray, lanes),
                                         num_cells=256)
    td, tc = tops.stay_time_cells_kernel(*map(torch.from_numpy, lanes), 256)
    assert np.array_equal(np.asarray(jd), td.numpy())
    assert np.array_equal(np.asarray(jc), tc.numpy())


@pytest.mark.parametrize("ppw,slide", [(1, 1000), (10, 300), (1000, 10)])
def test_traj_stats_pane_kernel(ppw, slide):
    """The pane kernel on the same sorted float32 lanes: counts and
    temporal sums exact; spatial sums within ``pane_spatial_bound`` (the
    JAX kernel's cumulative sums associate differently on the CPU)."""
    import jax

    from spatialflink_tpu_torch.streams.panes import (
        pane_operands,
        pane_spatial_bound,
    )

    rng = np.random.default_rng(7)
    n = 4000
    ts = np.sort(rng.integers(0, 20_000, n)).astype(np.int64)
    xy = rng.uniform(0, 10, (n, 2))
    oid = rng.integers(0, 40, n)
    lanes, _, n_panes = pane_operands(ts, xy, oid, 64, slide)
    statics = dict(num_oids=64, slide_ms=slide, ppw=ppw, n_panes=n_panes)
    with jax.enable_x64(False):
        j = jops.traj_stats_pane_kernel(*map(jnp.asarray, lanes), **statics)
        j = [np.asarray(a) for a in j]
    t = tops.traj_stats_pane_kernel(*map(torch.from_numpy, lanes), **statics)
    assert np.array_equal(j[2], t.count.numpy())
    assert np.array_equal(j[1], t.temporal.numpy())
    bound = pane_spatial_bound(ts, xy, oid, 64, ppw * slide, slide)
    assert np.all(np.abs(j[0] - t.spatial.numpy()) <= bound[:, None])


# ---------------------------------------------------------------------------
# Operators


def test_sub_trajectory_and_group_by_oid_match():
    rng = np.random.default_rng(8)
    pts, jpts = _walks(rng, n_traj=3, pts_per=10)
    # Equal timestamps: the stable sort keeps arrival order.
    pts[4].timestamp = jpts[4].timestamp = pts[5].timestamp
    g, jg = ttraj.group_by_oid(pts), jtraj.group_by_oid(jpts)
    assert list(g) == list(jg)
    for k in g:
        a = ttraj.sub_trajectory(g[k], k, 0)
        b = jtraj.sub_trajectory(jg[k], k, 0)
        assert np.array_equal(a.coords, b.coords) and a.obj_id == b.obj_id


def test_trange_run_and_run_soa():
    rng = np.random.default_rng(9)
    pts, jpts = _walks(rng, n_traj=8)
    polys = [Polygon(rings=[SQUARE]), Polygon(rings=[TRI])]
    jpolys = [JPolygon(rings=[SQUARE]), JPolygon(rings=[TRI])]
    op, jop = _ops(PointPolygonTRangeQuery, jtraj.PointPolygonTRangeQuery)
    got = list(op.run(iter(pts), polys))
    want = list(jop.run(iter(jpts), jpolys, dtype=np.float32))
    assert len(got) == len(want) > 1
    for g, w in zip(got, want):
        assert (g.start, g.end, g.window_count) == \
            (w.start, w.end, w.window_count)
        assert _lines(g.trajectories) == _lines(w.trajectories)
    assert any(g.trajectories for g in got)

    ts, xs, ys, oids = _stream(rng, 3000, n_obj=200)
    op, jop = _ops(PointPolygonTRangeQuery, jtraj.PointPolygonTRangeQuery)
    got = list(op.run_soa(_chunks(ts, xs, ys, oids), polys, 256))
    want = list(jop.run_soa(_chunks(ts, xs, ys, oids), jpolys, 256,
                            dtype=np.float32))
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert g[0:2] == w[0:2] and g[3] == w[3]
        assert np.array_equal(g[2], w[2]) and len(g[2]) > 10
    with pytest.raises(ValueError, match="num_segments"):
        list(op.run_soa(_chunks(ts, xs, ys, oids), polys, 128))


@pytest.mark.parametrize("qt", [QueryType.WindowBased, QueryType.CountBased])
def test_tknn_run_and_run_soa(qt):
    rng = np.random.default_rng(10)
    pts, jpts = _walks(rng, n_traj=12)
    conf = _conf(query_type=qt, count_window_size=150)
    op, jop = _ops(PointPointTKNNQuery, jtraj.PointPointTKNNQuery, conf)
    q, jq = Point(x=5.0, y=5.0), JPoint(x=5.0, y=5.0)
    got = list(op.run(iter(pts), q, 3.0, 5))
    want = list(jop.run(iter(jpts), jq, 3.0, 5, dtype=np.float32))
    assert len(got) == len(want) > 1
    for g, w in zip(got, want):
        assert (g.start, g.end, g.window_count) == \
            (w.start, w.end, w.window_count)
        assert [n[0] for n in g.neighbors] == [n[0] for n in w.neighbors]
        assert _within_ulp([n[1] for n in g.neighbors],
                           [n[1] for n in w.neighbors])
        assert _lines([n[2] for n in g.neighbors]) == \
            _lines([n[2] for n in w.neighbors])
    assert any(len(g.neighbors) == 5 for g in got)
    if qt == QueryType.CountBased:
        return
    ts, xs, ys, oids = _stream(rng, 3000, n_obj=100)
    got = list(op.run_soa(_chunks(ts, xs, ys, oids), q, 1.0, 10, 128))
    want = list(jop.run_soa(_chunks(ts, xs, ys, oids), jq, 1.0, 10, 128,
                            dtype=np.float32))
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert g[0:2] == w[0:2] and g[4] == w[4] == 10
        assert np.array_equal(g[2], w[2]) and _within_ulp(g[3], w[3])


def test_tknn_k_above_segments_raises_like_jax():
    """C1: k above the bucketed segment count (64 here) raises in both."""
    rng = np.random.default_rng(11)
    pts, jpts = _walks(rng, n_traj=4, pts_per=10)
    op, jop = _ops(PointPointTKNNQuery, jtraj.PointPointTKNNQuery)
    with pytest.raises(ValueError, match="k"):
        next(op.run(iter(pts), Point(x=5.0, y=5.0), 3.0, 100))
    with pytest.raises(ValueError):
        next(jop.run(iter(jpts), JPoint(x=5.0, y=5.0), 3.0, 100,
                     dtype=np.float32))


def _join_pairs(results):
    return [(r.start, r.end, r.window_count,
             [(a.obj_id, b.obj_id, a.coords.tolist(), b.coords.tolist())
              for a, b, _ in r.pairs]) for r in results]


def _assert_tjoin_equal(got, want):
    assert _join_pairs(got) == _join_pairs(want)
    for g, w in zip(got, want):
        assert _within_ulp([d for *_, d in g.pairs], [d for *_, d in w.pairs])


def test_tjoin_run_budget_growth_and_one_sided_windows():
    """Pairs (sorted by ids), sub-trajectories and min distances equal;
    the point-pair budget grows past its 1,024 floor and the
    trajectory-pair budget past 256, to the JAX operator's values; the
    right stream starts 20 s late, so the first windows are one-sided."""
    rng = np.random.default_rng(12)
    left, jleft = _walks(rng, n_traj=40, pts_per=30, prefix="l", step=1000)
    right, jright = _walks(rng, n_traj=30, pts_per=20, prefix="r",
                           step=500, t0=20_000)
    op, jop = _ops(PointPointTJoinQuery, jtraj.PointPointTJoinQuery, cap=48)
    got = list(op.run(iter(left), iter(right), 2.5))
    want = list(jop.run(iter(jleft), iter(jright), 2.5, dtype=np.float32))
    _assert_tjoin_equal(got, want)
    assert not got[0].pairs and not got[1].pairs and got[2].pairs
    assert op._max_pairs == jop._max_pairs > 1024
    assert op._max_tpairs == jop._max_tpairs > 256


def test_tjoin_run_single_excludes_identity():
    rng = np.random.default_rng(13)
    pts, jpts = _walks(rng, n_traj=5)
    op, jop = _ops(PointPointTJoinQuery, jtraj.PointPointTJoinQuery)
    got = list(op.run_single(iter(pts), 1.5))
    want = list(jop.run_single(iter(jpts), 1.5, dtype=np.float32))
    _assert_tjoin_equal(got, want)
    assert all(a.obj_id != b.obj_id for g in got for a, b, _ in g.pairs)
    assert any(g.pairs for g in got)


def test_tjoin_run_soa_sliding_budgets_and_one_sided():
    """Sliding 10 s / 5 s windows: per window the same (left, right)
    trajectory ids in key order, count and overflow, distances within 1
    ulp; a point-pair budget of 128 and the trajectory-pair budget grow
    as in the JAX run; the right stream's first 10 s are empty, so the
    first windows are one-sided (empty arrays, zeros)."""
    rng = np.random.default_rng(14)
    conf = _conf(10.0, 5.0)
    lt, lx, ly, lo = _stream(rng, 1500, n_obj=24)
    rt, rx, ry, ro = _stream(rng, 1200, n_obj=22, t0=10_000)
    op, jop = _ops(PointPointTJoinQuery, jtraj.PointPointTJoinQuery, conf,
                   cap=48)
    got = list(op.run_soa(_chunks(lt, lx, ly, lo), _chunks(rt, rx, ry, ro),
                          1.0, 32, max_pairs=128))
    want = list(jop.run_soa(_chunks(lt, lx, ly, lo),
                            _chunks(rt, rx, ry, ro), 1.0, 32, max_pairs=128,
                            dtype=np.float32))
    assert len(got) == len(want) > 4
    for g, w in zip(got, want):
        assert g[0:2] == w[0:2] and g[5:] == w[5:]
        assert np.array_equal(g[2], w[2]) and np.array_equal(g[3], w[3])
        assert _within_ulp(g[4], w[4])
        assert g[2].dtype == g[3].dtype == np.int32
    assert got[0][5] == 0 and got[0][4].dtype == np.float32
    assert max(g[5] for g in got) > 256 and all(g[6] == 0 for g in got)
    assert op._max_tpairs == jop._max_tpairs > 256
    with pytest.raises(ValueError, match="num_segments"):
        list(op.run_soa(_chunks(lt, lx, ly, lo), _chunks(rt, rx, ry, ro),
                        1.0, 16))


@pytest.mark.parametrize("mode", ["ALL", "SUM", "AVG", "MIN", "MAX"])
def test_taggregate_run_and_run_soa(mode):
    rng = np.random.default_rng(15)
    pts, jpts = _walks(rng, n_traj=6, pts_per=30)
    op, jop = _ops(PointTAggregateQuery, jtraj.PointTAggregateQuery,
                   aggregate=mode)
    got = list(op.run(iter(pts)))
    want = list(jop.run(iter(jpts)))
    assert [(g.start, g.end, g.window_count, g.cells) for g in got] == \
        [(w.start, w.end, w.window_count, w.cells) for w in want]
    assert len(got[-1].cells) > 5

    ts, xs, ys, oids = _stream(rng, 2000, n_obj=12)
    op, jop = _ops(PointTAggregateQuery, jtraj.PointTAggregateQuery,
                   aggregate=mode)
    got = list(op.run_soa(_chunks(ts, xs, ys, oids)))
    want = list(jop.run_soa(_chunks(ts, xs, ys, oids), dtype=np.float32))
    assert [(g.start, g.end, g.window_count, g.cells) for g in got] == \
        [(w.start, w.end, w.window_count, w.cells) for w in want]


def test_taggregate_inactive_deletion():
    """An object that stops at 5 s leaves the state once the newest span
    passes it by the threshold; the state arrays equal the JAX ones."""
    conf = _conf(10.0)
    rows = [("dead", t, 1.0, 1.0) for t in range(0, 5000, 1000)]
    rows += [("alive", t, 9.0, 9.0) for t in range(0, 40_000, 1000)]
    rows.sort(key=lambda r: r[1])
    pts = [Point(obj_id=o, timestamp=t, x=x, y=y) for o, t, x, y in rows]
    jpts = [JPoint(obj_id=o, timestamp=t, x=x, y=y) for o, t, x, y in rows]
    op, jop = _ops(PointTAggregateQuery, jtraj.PointTAggregateQuery, conf,
                   aggregate="ALL", inactive_threshold_ms=8000)
    got = list(op.run(iter(pts)))
    want = list(jop.run(iter(jpts)))
    assert [g.cells for g in got] == [w.cells for w in want]
    oids = {o for _, lens in got[-1].cells.values() for o in lens}
    assert oids == {"alive"} and "dead" in str(got[0].cells)
    for a in ("_skeys", "_smin", "_smax"):
        assert np.array_equal(getattr(op, a), getattr(jop, a))


@pytest.mark.parametrize("qt", [QueryType.WindowBased, QueryType.RealTime,
                                QueryType.CountBased])
def test_tstats_run(qt):
    """Per window the same objIDs and exact temporal lengths; float32
    spatial lengths and ratios within the sum bound (WindowBased,
    CountBased). RealTime carries float64 running totals on the host and
    drops out-of-order points: equal to the JAX operator's."""
    rng = np.random.default_rng(16)
    pts, jpts = _walks(rng, n_traj=5, pts_per=40)
    # An out-of-order point: dropped by RealTime, sorted in by the others.
    pts[30].timestamp = jpts[30].timestamp = pts[20].timestamp - 1
    conf = _conf(10.0, 5.0, query_type=qt, count_window_size=64,
                 realtime_batch_ms=700)
    op, jop = _ops(PointTStatsQuery, jtraj.PointTStatsQuery, conf)
    got = list(op.run(iter(pts)))
    want = list(jop.run(iter(jpts), dtype=np.float32))
    assert len(got) == len(want) > 3
    for g, w in zip(got, want):
        assert (g.start, g.end, g.window_count) == \
            (w.start, w.end, w.window_count)
        if qt == QueryType.RealTime:
            assert g.stats == w.stats
        else:
            assert _stats_close(g.stats, w.stats, g.window_count)
    assert any(s[1] > 0 for g in got for s in g.stats.values())


def test_tstats_run_soa():
    rng = np.random.default_rng(17)
    ts, xs, ys, oids = _stream(rng, 3000, n_obj=40)
    conf = _conf(10.0, 5.0)
    op, jop = _ops(PointTStatsQuery, jtraj.PointTStatsQuery, conf)
    got = list(op.run_soa(_chunks(ts, xs, ys, oids), 64))
    want = list(jop.run_soa(_chunks(ts, xs, ys, oids), 64, dtype=np.float32))
    assert len(got) == len(want) == 7
    for g, w in zip(got, want):
        assert g[0:2] == w[0:2]
        assert _sums_close(g[2], w[2], g[4])
        assert g[3].dtype == np.int64
        assert np.array_equal(g[3], np.asarray(w[3]))
        assert np.array_equal(g[4], np.asarray(w[4]))


def test_tfilter_run_and_run_soa():
    rng = np.random.default_rng(18)
    pts, jpts = _walks(rng, n_traj=6)
    op, jop = _ops(PointTFilterQuery, jtraj.PointTFilterQuery)
    got = list(op.run(iter(pts), ["tr1", "tr4"]))
    want = list(jop.run(iter(jpts), ["tr1", "tr4"]))
    assert [(g.start, g.window_count, _lines(g.trajectories)) for g in got] \
        == [(w.start, w.window_count, _lines(w.trajectories)) for w in want]
    ts, xs, ys, oids = _stream(rng, 2000, n_obj=64)
    got = list(op.run_soa(_chunks(ts, xs, ys, oids), [3, 17, 40]))
    want = list(jop.run_soa(_chunks(ts, xs, ys, oids), [3, 17, 40]))
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert g[0:2] == w[0:2] and g[5] == w[5]
        assert all(np.array_equal(a, b) for a, b in zip(g[2:5], w[2:5]))


# ---------------------------------------------------------------------------
# Resume from a JAX operator


def _split(pts, jpts, at):
    return (pts[:at], pts[at:]), (jpts[:at], jpts[at:])


def test_resume_taggregate_from_jax():
    """A JAX tAggregate ingests the first half; a port operator built from
    its state and interner gives the JAX operator's next windows."""
    rng = np.random.default_rng(19)
    pts, jpts = _walks(rng, n_traj=6, pts_per=40)
    (_, p2), (j1, j2) = _split(pts, jpts, len(pts) // 2)
    _, jop = _ops(PointTAggregateQuery, jtraj.PointTAggregateQuery,
                  aggregate="ALL", inactive_threshold_ms=15_000)
    list(jop.run(iter(j1)))
    op = PointTAggregateQuery(_conf()[0], UniformGrid(**GRID),
                              aggregate="ALL", inactive_threshold_ms=15_000,
                              device="cpu", **trajectory_state_from_jax(jop))
    op.interner = interner_from_jax(jop)
    got = list(op.run(iter(p2)))
    want = list(jop.run(iter(j2)))
    assert [g.cells for g in got] == [w.cells for w in want] and got


def test_resume_tstats_realtime_from_jax():
    rng = np.random.default_rng(20)
    pts, jpts = _walks(rng, n_traj=4, pts_per=30)
    (_, p2), (j1, j2) = _split(pts, jpts, 50)
    conf = _conf(query_type=QueryType.RealTime, realtime_batch_ms=1000)
    _, jop = _ops(PointTStatsQuery, jtraj.PointTStatsQuery, conf)
    list(jop.run(iter(j1)))
    op = PointTStatsQuery(conf[0], UniformGrid(**GRID), device="cpu",
                          **trajectory_state_from_jax(jop))
    got = list(op.run(iter(p2)))
    want = list(jop.run(iter(j2)))
    assert [g.stats for g in got] == [w.stats for w in want] and got


def test_resume_tjoin_budgets_from_jax():
    """The grown budgets carry over: the port operator starts at them and
    gives the JAX operator's next windows."""
    rng = np.random.default_rng(21)
    left, jleft = _walks(rng, n_traj=40, pts_per=30, prefix="l", step=1000)
    right, jright = _walks(rng, n_traj=30, pts_per=60, prefix="r", step=500)
    (l1, l2), (jl1, jl2) = _split(left, jleft, 600)
    (r1, r2), (jr1, jr2) = _split(right, jright, 900)
    _, jop = _ops(PointPointTJoinQuery, jtraj.PointPointTJoinQuery, cap=48)
    list(jop.run(iter(jl1), iter(jr1), 2.5, dtype=np.float32))
    kw = trajectory_state_from_jax(jop)
    assert kw == {"pair_budget": jop._max_pairs,
                  "tpair_budget": jop._max_tpairs}
    assert kw["tpair_budget"] > 256
    op = PointPointTJoinQuery(_conf()[0], UniformGrid(**GRID), cap=48,
                              device="cpu", **kw)
    got = list(op.run(iter(l2), iter(r2), 2.5))
    want = list(jop.run(iter(jl2), iter(jr2), 2.5, dtype=np.float32))
    _assert_tjoin_equal(got, want)
    assert (op._max_pairs, op._max_tpairs) == (jop._max_pairs,
                                               jop._max_tpairs)


# ---------------------------------------------------------------------------
# What is not ported raises


def test_unported_options_raise_naming_their_items():
    conf = _conf()[0]
    grid = UniformGrid(**GRID)
    op = PointPointTJoinQuery(conf, grid, device="cpu")
    one = [{"ts": np.asarray([100], np.int64), "x": np.asarray([1.0]),
            "y": np.asarray([1.0]), "oid": np.asarray([0], np.int32)}]
    # The native engine (ROADMAP A11.4a) is ported: it runs, and a lone
    # point a side pairs with itself at distance 0.
    [win] = [w for w in op.run_soa_panes(one, one, 1.0, 16,
                                         backend="native") if w[5]]
    assert (win[2].tolist(), win[3].tolist(), win[4].tolist()) == \
        ([0], [0], [0.0])
    # ``mesh=`` is ported (tests/test_torch_parallel_operators.py): a
    # value that is not a mesh raises.
    with pytest.raises(TypeError, match="must be a spatialflink_tpu_torch"):
        PointTStatsQuery(conf, grid, device="cpu", mesh=object())
    with pytest.raises(TypeError, match="must be a spatialflink_tpu_torch"):
        next(op.run(iter([]), iter([]), 1.0, mesh=object()))
    with pytest.raises(TypeError):
        trajectory_state_from_jax(object())


def test_driver_with_an_overload_controller_changes_nothing():
    from test_torch_overload import (
        assert_budget_free_controller_changes_nothing,
        plain,
    )

    rng = np.random.default_rng(13)
    xy = rng.uniform(0.0, 10.0, (400, 2))
    stream = [Point(obj_id=f"t{i % 7}", timestamp=int(25 * i), x=float(x),
                    y=float(y)) for i, (x, y) in enumerate(xy)]

    def run(driver):
        op = PointTStatsQuery(_conf(2.0, 1.0)[0], UniformGrid(**GRID),
                              device="cpu")
        return [plain(r) for r in op.run(iter(stream), driver=driver)]

    assert_budget_free_controller_changes_nothing(run)
