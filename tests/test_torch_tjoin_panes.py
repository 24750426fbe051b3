"""Parity of the PyTorch port's pane-carry tJoin (``ops/tjoin_panes.py``,
``ops/compaction.py``'s ladder, ``TJoinQuery.run_soa_panes``) with the
JAX package's.

The same inputs, made with numpy from a seed, go through the JAX function
or operator and its port counterpart, the port on the CPU. The test
configuration turns x64 on, and the JAX pane engine takes its float type
from that flag: the JAX side runs inside ``jax.enable_x64(False)``, its
operator with ``dtype=np.float32`` and ``backend="device"`` (the scan,
not the C++ engine), so both sides compute in float32.

Contracts held:
- host helpers (ranks, block size, ladder, occupancy) equal;
- the engine: planes, tags, cursors, live counts and the three counters
  equal; digests and window minima with the same finite entries, values
  within 1 float32 ulp. Both sides take the root of the same float32
  dx² + dy², the port correctly rounded (``sqrt_rn``); the JAX scan is
  compiled and may contract the square sum into a fused multiply-add,
  which moves d² by one rounding and the root by at most 1 ulp;
- the operator, window by window: the same starts and ends, the same
  (left, right) id arrays in the same order, counts and overflow, and
  float64 distances within 1 float32 ulp, through both probe forms and
  every retry branch;
- the JAX package's own contract inside the port: the pane engine's
  windows equal ``run_soa``'s when its counters end at 0 (distances
  bit-equal: both roots are ``sqrt_rn`` of the same float32 d²);
- the segmented scan under a pipeline policy equals the one scan; a
  JAX carry handed over through ``state.tjoin_pane_carry_from_jax``
  continues to the JAX scan's window minima;
- the guards and what is not ported raise as stated.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spatialflink_tpu.grid import UniformGrid as JGrid
from spatialflink_tpu.operators import QueryConfiguration as JConf
from spatialflink_tpu.operators import QueryType as JQT
from spatialflink_tpu.operators.trajectory import TJoinQuery as JTJoin
from spatialflink_tpu.ops import compaction as jcomp
from spatialflink_tpu.ops import tjoin_panes as jtp

from spatialflink_tpu_torch import pipeline
from spatialflink_tpu_torch.grid import UniformGrid
from spatialflink_tpu_torch.operators import (
    PointPointTJoinQuery,
    QueryConfiguration,
)
from spatialflink_tpu_torch.operators import trajectory as ttraj
from spatialflink_tpu_torch.ops import compaction as tcomp
from spatialflink_tpu_torch.ops import tjoin_panes as ttp
from spatialflink_tpu_torch.state import tjoin_pane_carry_from_jax

GRID = dict(num_partitions=20, min_x=0.0, max_x=10.0, min_y=0.0, max_y=10.0)


def _within_ulp(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return got.shape == want.shape and bool(np.all(
        np.abs(got - want) <= np.spacing(np.abs(want).astype(np.float32))))


# ---------------------------------------------------------------------------
# Host helpers


def test_pane_cell_ranks_with_out_of_grid_events():
    rng = np.random.default_rng(1)
    n = 5000
    pane = rng.integers(0, 40, n)
    cell = rng.integers(0, 30, n).astype(np.int32)
    valid = rng.random(n) > 0.2
    for v in (None, valid):
        got = ttp.pane_cell_ranks(pane, cell, valid=v)
        assert np.array_equal(got, jtp.pane_cell_ranks(pane, cell, valid=v))
    # An invalid event ahead of a valid one of its placeholder cell does
    # not take the valid one's rank.
    r = ttp.pane_cell_ranks(np.zeros(3, int), np.zeros(3, np.int32),
                            valid=np.array([False, True, True]))
    assert r.tolist() == [0, 0, 1]


@pytest.mark.parametrize("ppw", [1, 2, 7, 10, 97, 100, 360, 1000])
def test_block_size(ppw):
    assert ttp.block_size(ppw) == jtp.block_size(ppw)
    assert ppw % ttp.block_size(ppw) == 0


def test_capacity_ladder_and_pick():
    for cap in (4, 8, 9, 64, 100, 256):
        assert tcomp.capacity_ladder(cap) == jcomp.capacity_ladder(cap)
        for live in range(0, cap + 40):
            assert tcomp.pick_capacity(live, cap) == jcomp.pick_capacity(
                live, cap)
    assert tcomp.capacity_ladder(256) == (8, 16, 32, 64, 128, 256)


@pytest.mark.parametrize("ppw", [1, 5, 100])
def test_max_window_cell_count(ppw):
    rng = np.random.default_rng(ppw)
    pane = np.sort(rng.integers(0, 300, 4000))
    cell = rng.integers(0, 25, 4000)
    got = tcomp.max_window_cell_count(pane, cell, ppw)
    assert got == jcomp.max_window_cell_count(pane, cell, ppw)
    # Brute force: every (cell, window end).
    want = max(int(((cell == c) & (pane > t - ppw) & (pane <= t)).sum())
               for c in range(25) for t in np.unique(pane))
    assert got == want
    assert tcomp.max_window_cell_count(pane[:0], cell[:0], ppw) == 0


# ---------------------------------------------------------------------------
# The engine


def _pane_fields(rng, s, pc, gn, n_obj, extent=10.0):
    """(s, pc) fields of random panes on a gn × gn grid over [0, extent)²,
    with out-of-grid and dropped (invalid) points."""
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


def _jax_scan(carry, ts, lf, rf, radius, **kw):
    with jax.enable_x64(False):
        c, w = jtp.tjoin_pane_scan(
            carry, jnp.asarray(ts, jnp.int32),
            tuple(map(jnp.asarray, lf)), tuple(map(jnp.asarray, rf)),
            np.float32(radius), **kw)
        return [np.asarray(a) for a in c], np.asarray(w)


def _tensors(fields):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in fields)


def _assert_carry_equal(port, jax_carry, floats=True):
    for name, j, t in zip(ttp.TJoinPaneCarry._fields, jax_carry, port):
        t = t.numpy()
        if t.ndim:
            t = t[:-1]  # the port's spare slot
            j = j.reshape(-1)
        if j.dtype.kind == "f":
            if floats:
                fin = np.isfinite(j)
                assert np.array_equal(fin, np.isfinite(t)), name
                assert _within_ulp(t[fin], j[fin]), name
        else:
            assert np.array_equal(t, j), name


@pytest.mark.parametrize("cap_c,pair_sel", [(0, 4), (16, 4), (0, 64),
                                            (32, 64)])
def test_scan_matches_jax(cap_c, pair_sel):
    """Both probe forms, with ``pair_sel`` 4 overflowing (so the selected
    sets themselves are compared) and 64; nothing else overflows."""
    rng = np.random.default_rng(cap_c + pair_sel)
    s, pc, gn, k, ppw, cap_w = 40, 64, 10, 8, 10, 32
    lf = _pane_fields(rng, s, pc, gn, k)
    rf = _pane_fields(rng, s, pc, gn, k)
    kw = dict(grid_n=gn, cap_w=cap_w, layers=1, ppw=ppw, num_ids=k,
              pair_sel=pair_sel, cap_c=cap_c)
    with jax.enable_x64(False):
        j0 = jtp.tjoin_pane_init(gn * gn, cap_w, ppw, k, jnp.float32)
    jc, jw = _jax_scan(j0, np.arange(s), lf, rf, 0.8, **kw)
    tc, tw = ttp.tjoin_pane_scan(
        ttp.tjoin_pane_init(gn * gn, cap_w, ppw, k, device="cpu"),
        range(s), _tensors(lf), _tensors(rf), 0.8, **kw)
    _assert_carry_equal(tc, jc)
    tw = tw.numpy()
    assert np.array_equal(np.isfinite(tw), np.isfinite(jw))
    assert _within_ulp(tw[np.isfinite(jw)], jw[np.isfinite(jw)])
    assert np.isfinite(jw).sum() > 500
    assert int(jc[14]) == int(jc[16]) == 0  # cap, cmp
    assert (int(jc[15]) > 0) == (pair_sel == 4)


def test_scan_counters_match_jax_when_budgets_overflow():
    """``cap_w`` 4 and ``cap_c`` 2: the ring drops live slots and probed
    cells hold more than the probe reads. The counters (the retry's
    signals) are equal; the lost points' planes are not compared (a
    collision's survivor is the scatter's choice)."""
    rng = np.random.default_rng(3)
    s, pc, gn, k, ppw = 30, 64, 6, 8, 8
    lf = _pane_fields(rng, s, pc, gn, k)
    rf = _pane_fields(rng, s, pc, gn, k)
    kw = dict(grid_n=gn, cap_w=4, layers=1, ppw=ppw, num_ids=k,
              pair_sel=16, cap_c=2)
    with jax.enable_x64(False):
        j0 = jtp.tjoin_pane_init(gn * gn, 4, ppw, k, jnp.float32)
    jc, _ = _jax_scan(j0, np.arange(s), lf, rf, 0.8, **kw)
    tc, _ = ttp.tjoin_pane_scan(
        ttp.tjoin_pane_init(gn * gn, 4, ppw, k, device="cpu"), range(s),
        _tensors(lf), _tensors(rf), 0.8, **kw)
    got = [int(tc.cap_overflow), int(tc.sel_overflow),
           int(tc.cmp_overflow)]
    assert got == [int(a) for a in jc[14:]]
    assert got[0] > 0 and got[2] > 0
    assert np.array_equal(tc.lwcur.numpy()[:-1], jc[4])
    assert np.array_equal(tc.rwlive.numpy()[:-1], jc[11])


def test_carry_handover_from_jax_continues_the_scan():
    """A JAX warm scan of ppw slides, handed over, continues in the port
    to the JAX steady scan's window minima (the JAX bench's warm-then-
    steady split, the expiring panes sliced from the warm batch)."""
    rng = np.random.default_rng(4)
    ppw, steady, pc, gn, k, cap_w = 12, 20, 64, 10, 8, 64
    s = ppw + steady
    lf = _pane_fields(rng, s, pc, gn, k)
    rf = _pane_fields(rng, s, pc, gn, k)
    kw = dict(grid_n=gn, cap_w=cap_w, layers=1, ppw=ppw, num_ids=k,
              pair_sel=32, cap_c=32)

    def part(f, lo, hi):
        return tuple(a[lo:hi] for a in f)

    with jax.enable_x64(False):
        j0 = jtp.tjoin_pane_init(gn * gn, cap_w, ppw, k, jnp.float32)
        warm, _ = jtp.tjoin_pane_scan(
            j0, jnp.arange(ppw, dtype=jnp.int32),
            tuple(map(jnp.asarray, part(lf, 0, ppw))),
            tuple(map(jnp.asarray, part(rf, 0, ppw))), np.float32(0.8),
            **kw)
        lx = (jnp.asarray(lf[4][:steady]), jnp.asarray(lf[7][:steady]))
        rx = (jnp.asarray(rf[4][:steady]), jnp.asarray(rf[7][:steady]))
        jc, jw = jtp.tjoin_pane_scan(
            warm, jnp.arange(ppw, s, dtype=jnp.int32),
            tuple(map(jnp.asarray, part(lf, ppw, s))),
            tuple(map(jnp.asarray, part(rf, ppw, s))), np.float32(0.8),
            lps_expire=lx, rps_expire=rx, **kw)
        jc = [np.asarray(a) for a in jc]
        jw = np.asarray(jw)
    carry = tjoin_pane_carry_from_jax(warm, device="cpu")
    _assert_carry_equal(carry, [np.asarray(a) for a in warm])
    tc, tw = ttp.tjoin_pane_scan(
        carry, range(ppw, s), _tensors(part(lf, ppw, s)),
        _tensors(part(rf, ppw, s)), 0.8,
        lps_expire=_tensors((lf[4][:steady], lf[7][:steady])),
        rps_expire=_tensors((rf[4][:steady], rf[7][:steady])), **kw)
    _assert_carry_equal(tc, jc)
    tw = tw.numpy()
    assert np.array_equal(np.isfinite(tw), np.isfinite(jw))
    assert _within_ulp(tw[np.isfinite(jw)], jw[np.isfinite(jw)])
    assert np.isfinite(jw).sum() > 200 and int(tc.cap_overflow) == 0


def test_expired_pane_fields_and_unported_mesh():
    cells = torch.arange(12, dtype=torch.int32).reshape(6, 2)
    valid = torch.ones(6, 2, dtype=torch.bool)
    with jax.enable_x64(False):
        for ppw in (2, 6, 9):
            got = ttp.expired_pane_fields(cells, valid, ppw)
            want = jtp.expired_pane_fields(jnp.asarray(cells.numpy()),
                                           jnp.asarray(valid.numpy()), ppw)
            for g, w in zip(got, want):
                assert np.array_equal(g.numpy(), np.asarray(w))
    carry = ttp.tjoin_pane_init(4, 2, 2, 2, device="cpu")
    with pytest.raises(NotImplementedError, match="A12"):
        ttp.tjoin_pane_scan(carry, [], (), (), 1.0, 2, 2, 1, 2, 2, 1,
                            mesh=object())


# ---------------------------------------------------------------------------
# The operator


def _chunks(rng, n, t_span, n_obj, shift=0.0, base=0):
    ts = base + np.sort(rng.integers(0, t_span, n)).astype(np.int64)
    return [{
        "ts": ts,
        "x": rng.uniform(2 + shift, 8 + shift, n),
        "y": rng.uniform(2, 8, n),
        "oid": rng.integers(0, n_obj, n).astype(np.int32),
    }]


def _copies(chunks):
    return iter([dict(c) for c in chunks])


def _port(window, slide, **op_kw):
    return PointPointTJoinQuery(
        QueryConfiguration(window_size=window, slide_step=slide),
        UniformGrid(**GRID), device="cpu", **op_kw)


def _run_both(left, right, window, slide, radius, n_obj, **kw):
    """The port's windows, the JAX operator's, and the port operator's
    scans (``pane_scans``: one a scan, the retries included)."""
    op = _port(window, slide)
    got = list(op.run_soa_panes(
        _copies(left), _copies(right), radius, n_obj, **kw))
    jop = JTJoin(JConf(JQT.WindowBased, window_size=window,
                       slide_step=slide), JGrid(**GRID))
    with jax.enable_x64(False):
        want = list(jop.run_soa_panes(
            _copies(left), _copies(right), radius, n_obj, dtype=np.float32,
            backend="device", **kw))
    return got, want, op.pane_scans


def _assert_windows_equal(got, want):
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert g[0:2] == w[0:2] and g[5:] == w[5:]
        assert np.array_equal(g[2], w[2]) and np.array_equal(g[3], w[3])
        assert g[2].dtype == g[3].dtype == np.int32
        assert g[4].dtype == w[4].dtype == np.float64
        assert _within_ulp(g[4], w[4])


@pytest.mark.parametrize("cap_c", [None, 0])
def test_run_soa_panes_sliding_matches_jax(cap_c):
    rng = np.random.default_rng(11)
    left = _chunks(rng, 1500, 4_000, 24)
    right = _chunks(rng, 1500, 4_000, 24, shift=0.3)
    got, want, scans = _run_both(left, right, 1.0, 0.1, 0.4, 24, cap_c=cap_c)
    _assert_windows_equal(got, want)
    assert sum(g[5] for g in got) > 1000
    assert scans == [(64, 16, 16 if cap_c is None else 0, 0, 0, 0)]


def test_run_soa_panes_extreme_overlap_matches_jax():
    """ppw = 100: the 10 s / 10 ms window shape at test scale."""
    rng = np.random.default_rng(12)
    left = _chunks(rng, 800, 2_500, 16)
    right = _chunks(rng, 800, 2_500, 16, shift=0.3)
    got, want, _ = _run_both(left, right, 1.0, 0.01, 0.3, 16)
    _assert_windows_equal(got, want)
    assert len(got) > 300 and max(g[5] for g in got) > 50


def test_run_soa_panes_tiny_budgets_retry_like_jax():
    """``cap_w`` 2 and ``pair_sel`` 1 overflow both: the retry doubles them
    until the scan is exact, to the JAX operator's windows."""
    rng = np.random.default_rng(13)
    left = _chunks(rng, 600, 3_000, 8)
    right = _chunks(rng, 600, 3_000, 8, shift=0.2)
    got, want, scans = _run_both(left, right, 1.0, 0.25, 0.5, 8, cap_w=2,
                          pair_sel=1)
    _assert_windows_equal(got, want)
    assert scans[0][:2] == (2, 1) and scans[0][3] > 0 and scans[0][4] > 0
    assert scans[-1][0] > 2 and scans[-1][1] > 1
    assert scans[-1][3:] == (0, 0, 0)


def test_run_soa_panes_forced_small_cap_c_climbs_the_ladder():
    rng = np.random.default_rng(14)
    left = _chunks(rng, 1200, 2_000, 12)
    right = _chunks(rng, 1200, 2_000, 12, shift=0.2)
    got, want, scans = _run_both(left, right, 1.0, 0.25, 0.5, 12, cap_c=2)
    _assert_windows_equal(got, want)
    caps = [a[2] for a in scans]
    assert caps[0] == 2 and len(caps) > 2 and caps == sorted(caps)
    assert all(a[5] > 0 for a in scans[:-1]) and scans[-1][3:] == (0, 0, 0)


def test_run_soa_panes_one_sided_windows_fire_empty():
    rng = np.random.default_rng(15)
    left = _chunks(rng, 100, 1_000, 8)
    right = [{"ts": np.asarray([5_000, 5_100], np.int64),
              "x": np.asarray([5.0, 5.1]), "y": np.asarray([5.0, 5.1]),
              "oid": np.asarray([0, 1], np.int32)}]
    got, want, _ = _run_both(left, right, 1.0, 0.5, 0.5, 8)
    _assert_windows_equal(got, want)
    starts = [g[0] for g in got]
    assert any(s < 2_000 for s in starts) and any(s >= 4_000 for s in starts)
    empty = [g for g in got if g[0] < 2_000 or g[0] >= 4_000]
    assert empty and all(g[5] == 0 and g[4].dtype == np.float64
                         for g in empty)


def test_run_soa_panes_epoch_ms_timestamps():
    rng = np.random.default_rng(16)
    base = 1_753_900_000_000
    left = _chunks(rng, 400, 2_000, 8, base=base)
    right = _chunks(rng, 400, 2_000, 8, shift=0.2, base=base)
    got, want, _ = _run_both(left, right, 1.0, 0.25, 0.5, 8)
    _assert_windows_equal(got, want)
    assert got[0][0] > base - 2_000 and sum(g[5] for g in got) > 0


def test_run_soa_panes_single_pane_cell_flood():
    """120 points of one cell in one pane, ``cap_w`` 16: the ranks wrap
    and the scan retries until the ring holds the pane."""
    rng = np.random.default_rng(17)
    n = 120
    left = [{"ts": np.zeros(n, np.int64) + 100,
             "x": rng.uniform(5.0, 5.4, n), "y": rng.uniform(5.0, 5.4, n),
             "oid": rng.integers(0, 8, n).astype(np.int32)}]
    right = [dict(left[0], x=rng.uniform(5.0, 5.4, n))]
    got, want, scans = _run_both(left, right, 1.0, 1.0, 0.5, 8, cap_w=16)
    _assert_windows_equal(got, want)
    assert [a[0] for a in scans][:4] == [16, 32, 64, 128]
    assert scans[0][3] > 0 and scans[-1][3:] == (0, 0, 0)


@pytest.mark.parametrize("cap_c", [None, 0])
def test_run_soa_panes_equals_run_soa(cap_c):
    """The JAX package's contract, inside the port: with the counters at
    0 the pane engine's windows are ``run_soa``'s (same starts, ids in
    order, distances bit-equal as float32), one-sided windows aside."""
    rng = np.random.default_rng(18)
    left = _chunks(rng, 1500, 4_000, 24)
    right = _chunks(rng, 1500, 4_000, 24, shift=0.3)
    panes = list(_port(1.0, 0.1).run_soa_panes(
        _copies(left), _copies(right), 0.4, 24, cap_c=cap_c))
    soa = list(_port(1.0, 0.1, cap=64).run_soa(
        _copies(left), _copies(right), 0.4, 24))
    by_start = {w[0]: w for w in panes}
    assert sum(w[5] for w in soa) > 1000
    for w in soa:
        assert w[6] == 0
        p = by_start[w[0]]
        assert p[1] == w[1] and p[5] == w[5]
        assert np.array_equal(p[2], w[2]) and np.array_equal(p[3], w[3])
        assert np.array_equal(p[4].astype(np.float32), w[4])


class TestSegmentedScan:
    def _chunks(self, side, n_chunks=10, per=8):
        rng = np.random.default_rng(21 + side)
        out = []
        for c in range(n_chunks):
            base = c * per
            out.append({
                "ts": np.arange(base, base + per, dtype=np.int64) * 250,
                "x": rng.uniform(0.0, 8.0, per),
                "y": rng.uniform(0.0, 8.0, per),
                "oid": (np.arange(base, base + per) % 5).astype(np.int32),
            })
        return out

    def _collect(self):
        op = PointPointTJoinQuery(
            QueryConfiguration(window_size=2.0, slide_step=0.5),
            UniformGrid(8, 0.0, 8.0, 0.0, 8.0), device="cpu")
        return [(s, e, lo.tolist(), ro.tolist(), dd.tolist(), c, o)
                for s, e, lo, ro, dd, c, o in op.run_soa_panes(
                    self._chunks(0), self._chunks(1), 1.5, 5)]

    @pytest.mark.parametrize("polkw", [
        {}, {"depth": 4, "fetch_lag": 3}, {"depth": 1, "fetch_lag": 0},
    ])
    def test_segmented_scan_equals_the_one_scan(self, polkw):
        """Chained segments, each given its expiring panes from the whole
        stream, reproduce the one scan exactly (a segment that expired
        its own panes would leak stale pairs into later windows)."""
        pipeline.uninstall()
        base = self._collect()
        assert base and sum(w[5] for w in base) > 0
        try:
            pipeline.install(pipeline.PipelinePolicy(**polkw))
            got = self._collect()
        finally:
            pipeline.uninstall()
        assert got == base


# ---------------------------------------------------------------------------
# Guards and what is not ported


def _one_point(ts=100):
    return [{"ts": np.asarray([ts], np.int64), "x": np.asarray([1.0]),
             "y": np.asarray([1.0]), "oid": np.asarray([0], np.int32)}]


@pytest.mark.parametrize("case", ["digest", "output", "size_slide",
                                  "lateness", "backend"])
def test_guards_raise_value_error(case):
    op = _port(1.0, 0.5)
    args, kw, match = (_one_point(), _one_point(), 0.5, 4), {}, "backend"
    if case == "digest":
        op = _port(10.0, 0.01)
        args, match = (iter([]), _one_point(), 0.5, 2048), "digest memory"
    elif case == "output":
        op = _port(0.1, 0.1)
        args = (_one_point(0), _one_point(600_000), 0.5, 1024)
        match = "output"
    elif case == "size_slide":
        op, match = _port(1.0, 0.3), "size % slide"
    elif case == "lateness":
        op = PointPointTJoinQuery(
            QueryConfiguration(window_size=1.0, slide_step=0.5,
                               allowed_lateness=1.0),
            UniformGrid(**GRID), device="cpu")
        match = "allowed_lateness"
    else:
        kw = {"backend": "cuda"}
    with pytest.raises(ValueError, match=match):
        list(op.run_soa_panes(*args, **kw))


@pytest.mark.parametrize("kw,item", [({"backend": "native"}, "A11"),
                                     ({"mesh": object()}, "A12"),
                                     ({"driver": object()}, "A11")])
def test_unported_options_raise(kw, item):
    with pytest.raises(NotImplementedError, match=item):
        list(_port(1.0, 0.5).run_soa_panes(_one_point(), _one_point(), 0.5,
                                           4, **kw))
