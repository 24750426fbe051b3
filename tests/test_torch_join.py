"""Parity of the PyTorch port's point–point join with the JAX package.

The same inputs, made with numpy from a seed, go through the JAX function
and its port counterpart. The JAX side runs its Pallas join in interpret
mode where it reaches it (``join_window_pallas``), and its operators take
their CPU path (the XLA bucketed join); the port runs on the CPU, where the
join kernel's wrapper takes its plain PyTorch version. Float32 is pinned on
both sides (the test configuration turns x64 on), so the JAX operators are called
with ``dtype=np.float32``: they then centre in float64 and cast, as the
port always does.

Contracts held:
- grid arithmetic, ``bucketize_planes``, ``point_point_distance``,
  ``PointBatch`` and the naive cross join: exact;
- ``join_window`` against ``join_window_pallas(interpret=True)``: index
  arrays identical in order (padding included), ``count`` and
  ``overflow`` exact, distances within 1 ulp;
- window assemblers (object and SoA): the same windows, arrays and
  ``dropped_late``;
- ``run_soa`` and ``run`` (WindowBased, RealTime, CountBased,
  RealTimeNaive, approximate) against the JAX operator per window: starts
  and ends, ``count``/``overflow``/``window_count`` exact, the same pair
  sets (multisets keyed by ids and timestamps for ``run``), distances
  within 1 ulp; the same after a resume from the JAX assembler state.
"""

from collections import Counter, defaultdict

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spatialflink_tpu.checkpoint import soa_assembler_state
from spatialflink_tpu.grid import UniformGrid as JGrid
from spatialflink_tpu.models.batch import PointBatch as JPointBatch
from spatialflink_tpu.models.objects import Point as JPoint
from spatialflink_tpu.operators import PointPointJoinQuery as JJoin
from spatialflink_tpu.operators import QueryConfiguration as JConf
from spatialflink_tpu.operators import QueryType as JQT
from spatialflink_tpu.ops.distances import point_point_distance as j_ppd
from spatialflink_tpu.ops.join import bucketize_planes as j_bucketize
from spatialflink_tpu.ops.join import cross_join_kernel as j_cross
from spatialflink_tpu.ops.pallas_join import join_window_pallas
from spatialflink_tpu.streams.soa import SoaWindowAssembler as JSoa
from spatialflink_tpu.streams.windows import SlidingEventTimeWindows as JSW
from spatialflink_tpu.streams.windows import WindowAssembler as JWA
from spatialflink_tpu.utils.interning import Interner as JInterner

from spatialflink_tpu_torch.grid import UniformGrid
from spatialflink_tpu_torch.models.batch import PointBatch
from spatialflink_tpu_torch.models.objects import Point
from spatialflink_tpu_torch.operators import (
    PointPointJoinQuery,
    PolygonPolygonJoinQuery,
    QueryConfiguration,
    QueryType,
)
from spatialflink_tpu_torch.operators.base import center_coords
from spatialflink_tpu_torch.operators.join_query import check_join_backend
from spatialflink_tpu_torch.ops.distances import point_point_distance
from spatialflink_tpu_torch.ops.join import bucketize_planes, cross_join_kernel
from spatialflink_tpu_torch.ops.join_kernel import join_extract, join_window
from spatialflink_tpu_torch.state import soa_assembler_from_jax
from spatialflink_tpu_torch.streams.soa import SoaWindowAssembler
from spatialflink_tpu_torch.streams.windows import (
    SlidingEventTimeWindows,
    WindowAssembler,
)
from spatialflink_tpu_torch.utils.interning import Interner

BEIJING = dict(num_partitions=100, min_x=115.5, max_x=117.6, min_y=39.6,
               max_y=41.1)
# A coarse grid over the same extent keeps the JAX bucketed join (it tests
# cells × cap² × span² lanes on the CPU) small: cells of 0.13125°.
COARSE = dict(BEIJING, num_partitions=16)
R = 0.05  # one candidate layer on the coarse grid
CAP = 32


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _within_ulp(a, b):
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    if a.shape != b.shape:
        return False
    same = a == b  # the +inf padding included
    ulp = np.spacing(np.maximum(np.abs(a[~same]), np.abs(b[~same])))
    return bool(np.all(np.abs(a[~same] - b[~same]) <= ulp))


# ---------------------------------------------------------------------------
# Grid, batches, distances


def test_grid_arithmetic_matches_jax():
    rng = np.random.default_rng(1)
    g, jg = UniformGrid(**BEIJING), JGrid(**BEIJING)
    xy = np.stack([rng.uniform(115.0, 118.0, 5000),
                   rng.uniform(39.0, 42.0, 5000)], axis=1)
    xy[:4] = [[115.5, 39.6], [117.6, 41.1], [115.4999, 40.0], [116.0, 41.7]]
    assert g.num_cells == jg.num_cells
    assert np.array_equal(g.assign_cells_np(xy), jg.assign_cells_np(xy))
    assert (g.assign_cells_np(xy) == g.num_cells).sum() > 100  # out-of-grid
    assert np.array_equal(g.cell_xy_indices_np(xy), jg.cell_xy_indices_np(xy))
    for r in (0.002, 0.021, 0.03, 0.5, 0.0):
        assert g.candidate_layers(r) == jg.candidate_layers(r)
        assert np.array_equal(g.neighbor_offsets(r), jg.neighbor_offsets(r))


def test_point_batch_and_interner_match_jax():
    rng = np.random.default_rng(2)
    pts = [Point(obj_id=f"o{i % 37}", timestamp=int(t), x=x, y=y)
           for i, (t, x, y) in enumerate(zip(
               rng.integers(0, 1000, 300), rng.uniform(115.0, 118.0, 300),
               rng.uniform(39.0, 42.0, 300)))]
    jpts = [JPoint(obj_id=p.obj_id, timestamp=p.timestamp, x=p.x, y=p.y)
            for p in pts]
    it, jit_ = Interner(), JInterner()
    b = PointBatch.from_points(pts, interner=it).with_cells(
        UniformGrid(**BEIJING))
    jb = JPointBatch.from_points(jpts, interner=jit_).with_cells(
        JGrid(**BEIJING))
    for name in ("xy", "ts", "oid", "valid", "cell"):
        assert np.array_equal(getattr(b, name), getattr(jb, name)), name
    assert b.capacity == jb.capacity == 512 and b.count == jb.count == 300
    assert it.decode(range(len(it))) == jit_.decode(range(len(jit_)))
    assert it.num_segments == 37


def test_point_point_distance_matches_jax():
    rng = np.random.default_rng(3)
    a = rng.uniform(-1, 1, (4000, 2)).astype(np.float32)
    b = rng.uniform(-1, 1, (4000, 2)).astype(np.float32)
    got = point_point_distance(_t(a), _t(b)).numpy()
    want = np.asarray(j_ppd(jnp.asarray(a), jnp.asarray(b)))
    assert got.dtype == want.dtype == np.float32
    assert np.array_equal(got.view(np.uint32), want.view(np.uint32))


def test_center_coords_is_float64_then_float32():
    g = UniformGrid(**BEIJING)
    xy = np.asarray([[116.40, 40.19], [115.5, 41.1]])
    got = center_coords(g, xy, np.float64)
    center = np.array([(115.5 + 117.6) / 2, (39.6 + 41.1) / 2])
    want = (xy - center).astype(np.float32)
    assert got.dtype == np.float32 and np.array_equal(got, want)


@pytest.mark.parametrize("cap", [16, 2])
def test_bucketize_planes_matches_jax(cap):
    rng = np.random.default_rng(4)
    n, gn = 700, 8
    xy = rng.uniform(-1, 1, (n, 2)).astype(np.float32)
    valid = rng.random(n) > 0.2
    cells = rng.integers(0, gn * gn + 1, n).astype(np.int32)  # some off-grid
    got = bucketize_planes(_t(xy), _t(valid), _t(cells), gn, cap)
    want = j_bucketize(jnp.asarray(xy), jnp.asarray(valid),
                       jnp.asarray(cells), gn, cap)
    for a, b in zip(got, want):
        assert np.array_equal(a.numpy(), np.asarray(b))
    assert (int(got[3]) > 0) == (cap == 2)


def test_cross_join_kernel_matches_jax():
    rng = np.random.default_rng(5)
    a = rng.uniform(-0.1, 0.1, (300, 2)).astype(np.float32)
    b = rng.uniform(-0.1, 0.1, (200, 2)).astype(np.float32)
    av, bv = rng.random(300) > 0.1, rng.random(200) > 0.1
    got = cross_join_kernel(_t(a), _t(av), _t(b), _t(bv), 0.03)
    want = j_cross(jnp.asarray(a), jnp.asarray(av), jnp.asarray(b),
                   jnp.asarray(bv), 0.03)
    assert np.array_equal(got.pair_mask.numpy(), np.asarray(want.pair_mask))
    assert got.pair_mask.sum() > 500
    assert np.array_equal(got.right_index.numpy(),
                          np.asarray(want.right_index))
    assert np.array_equal(got.dist.numpy().view(np.uint32),
                          np.asarray(want.dist).view(np.uint32))


# ---------------------------------------------------------------------------
# join_window (kernel B3's plain version) vs the JAX Pallas join


GRID_N = 8


def _cells(xy):
    """tests/test_pallas_join.py's cell assignment on an 8×8 unit grid."""
    ci = np.clip(np.floor(xy).astype(np.int32), 0, GRID_N - 1)
    out = (ci[:, 0] * GRID_N + ci[:, 1]).astype(np.int32)
    oob = (xy < 0).any(axis=1) | (xy >= GRID_N).any(axis=1)
    out[oob] = GRID_N * GRID_N
    return out


def _pallas_data():
    """tests/test_pallas_join.py's data: 260 × 240 points, 15% invalid,
    some outside the grid."""
    rng = np.random.default_rng(7)
    n, m = 260, 240
    axy = rng.uniform(-0.5, GRID_N + 0.5, (n, 2)).astype(np.float32)
    bxy = rng.uniform(-0.5, GRID_N + 0.5, (m, 2)).astype(np.float32)
    av = rng.random(n) > 0.15
    bv = rng.random(m) > 0.15
    return axy, av, bxy, bv


def _on_radius_data():
    """Right points at exactly +0.5 in x from lattice left points, so that
    ``d² == r²`` in float32 with r = 0.5; the rest as ``_pallas_data``."""
    axy, av, bxy, bv = _pallas_data()
    axy = np.round(axy * 64) / 64  # exact lattice: differences are exact
    bxy[:120] = axy[:120] + np.float32([0.5, 0.0])
    return axy, av, bxy, bv


def _spread(rng, i, j, n):
    """``n`` points inside unit cell (i, j), away from its edges."""
    return (np.float32([i, j]) + rng.uniform(0.1, 0.9, (n, 2))).astype(
        np.float32)


def _saturated_data():
    """A saturated cell: 16 left points (the bucket cap) in cell (3, 3) and
    16 right points in each of its 9 neighbour cells, so that at r = inf
    all 16 × 144 slot pairs of the cell are hits."""
    rng = np.random.default_rng(8)
    axy = _spread(rng, 3, 3, 16)
    bxy = np.concatenate([_spread(rng, 3 + dx, 3 + dy, 16)
                          for dx in (-1, 0, 1) for dy in (-1, 0, 1)])
    return axy, np.ones(len(axy), bool), bxy, np.ones(len(bxy), bool)


def _cell_end_data():
    """Cell (0, 0) holds left points 0–7 and its in-grid neighbourhood 16
    right points, so at r = inf its 8 × 16 = 128 pairs come first and a
    128-pair budget ends exactly at the cell's end; cell (5, 5)'s 10 × 12
    pairs follow."""
    rng = np.random.default_rng(9)
    axy = np.concatenate([_spread(rng, 0, 0, 8), _spread(rng, 5, 5, 10)])
    bxy = np.concatenate([_spread(rng, i, j, 4)
                          for i, j in ((0, 0), (0, 1), (1, 0), (1, 1))]
                         + [_spread(rng, 5, 5, 6), _spread(rng, 6, 6, 6)])
    return axy, np.ones(len(axy), bool), bxy, np.ones(len(bxy), bool)


JOIN_CASES = {
    "one_layer": dict(r=0.7),
    "on_radius": dict(r=0.5, data=_on_radius_data),
    "two_layers": dict(r=1.6, layers=2, max_pairs=65536),
    "over_budget": dict(r=0.9, max_pairs=128),
    "overflow": dict(r=0.7, cap=2),
    "empty_side": dict(r=1.0, empty=True),
    "infinite_radius": dict(r=np.inf),
    "saturated_cell": dict(r=np.inf, data=_saturated_data),
    "budget_at_cell_end": dict(r=np.inf, data=_cell_end_data, max_pairs=128),
}


@pytest.mark.parametrize("case", list(JOIN_CASES))
def test_join_window_matches_pallas_in_order(case):
    kw = dict(cap=16, layers=1, max_pairs=4096, empty=False,
              data=_pallas_data)
    kw.update(JOIN_CASES[case])
    axy, av, bxy, bv = kw["data"]()
    if kw["empty"]:
        av = np.zeros_like(av)
    args = (axy, av, _cells(axy), bxy, bv, _cells(bxy))
    stat = dict(grid_n=GRID_N, layers=kw["layers"], cap_left=kw["cap"],
                cap_right=kw["cap"], max_pairs=kw["max_pairs"])
    launches = join_extract.launches
    got = join_window(*map(_t, args), radius=np.float32(kw["r"]), **stat)
    assert join_extract.launches == launches  # CPU: the plain version
    want = join_window_pallas(*map(jnp.asarray, args),
                              radius=np.float32(kw["r"]), interpret=True,
                              **stat)
    li, ri = got.left_index.numpy(), got.right_index.numpy()
    assert np.array_equal(li, np.asarray(want.left_index))
    assert np.array_equal(ri, np.asarray(want.right_index))
    assert int(got.count) == int(want.count)
    assert int(got.overflow) == int(want.overflow)
    assert _within_ulp(got.dist.numpy(), np.asarray(want.dist))
    count, budget = int(got.count), len(li)
    assert budget % 128 == 0 and budget >= kw["max_pairs"]
    assert np.all(li[count:] == -1) and np.all(np.isinf(
        got.dist.numpy()[count:]))
    if case == "over_budget":
        assert count > budget and np.all(li >= 0)
    elif case == "saturated_cell":
        assert count == 16 * 9 * 16 and int(got.overflow) == 0
    elif case == "budget_at_cell_end":
        assert count == 8 * 16 + 10 * 12 and budget == 128
        assert np.all((li >= 0) & (li < 8))  # exactly cell (0, 0)'s pairs
    elif case == "overflow":
        assert int(got.overflow) > 0
    elif case == "empty_side":
        assert count == 0
    elif case == "on_radius":
        on = (li == ri) & (li >= 0) & (li < 120)
        live = av[:120] & bv[:120] & (_cells(axy[:120]) < GRID_N ** 2) & \
            (_cells(axy[:120] + np.float32([0.5, 0])) < GRID_N ** 2)
        assert on.sum() == live.sum() > 50
        assert np.all(got.dist.numpy()[on] == np.float32(0.5))
    else:
        assert count > 100


def test_join_distances_correctly_rounded():
    """The plain version's distances are the correctly rounded float32
    roots of float32 ``d²`` (what the card's ``__fsqrt_rn`` gives), and
    every in-grid pair within the radius is found."""
    axy, av, bxy, bv = _pallas_data()
    r = np.float32(0.9)
    res = join_window(_t(axy), _t(av), _t(_cells(axy)), _t(bxy), _t(bv),
                      _t(_cells(bxy)), grid_n=GRID_N, layers=1, radius=r,
                      cap_left=16, cap_right=16, max_pairs=4096)
    n = int(res.count)
    li, ri = res.left_index.numpy()[:n], res.right_index.numpy()[:n]
    d = axy[li] - bxy[ri]
    want = np.sqrt(d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1])
    assert np.array_equal(res.dist.numpy()[:n].view(np.uint32),
                          want.view(np.uint32))
    dd = axy[:, None, :] - bxy[None, :, :]
    d2 = dd[..., 0] * dd[..., 0] + dd[..., 1] * dd[..., 1]
    ain = _cells(axy) < GRID_N * GRID_N
    bin_ = _cells(bxy) < GRID_N * GRID_N
    brute = (d2 <= r * r) & (av & ain)[:, None] & (bv & bin_)[None, :]
    assert set(zip(li.tolist(), ri.tolist())) == set(
        zip(*[x.tolist() for x in np.nonzero(brute)]))


@pytest.mark.parametrize("backend,dev,ok", [
    (None, "cuda", True), ("cuda", "cuda", True), (None, "cpu", True),
    ("torch", "cpu", True), ("torch", "cuda", False), ("cuda", "cpu", False),
    ("xla", "cpu", False), ("pallas", "cuda", False),
    ("pallas_interpret", "cpu", False),
])
def test_join_backend_rules(backend, dev, ok):
    if ok:
        check_join_backend(backend, dev)
    else:
        with pytest.raises(ValueError):
            check_join_backend(backend, dev)


def test_unported_options_raise():
    conf = QueryConfiguration(window_size=1.0, slide_step=1.0)
    op = PointPointJoinQuery(conf, UniformGrid(**COARSE), device="cpu")
    for kw in ({"driver": object()}, {"mesh": object()}):
        with pytest.raises(NotImplementedError):
            list(op.run([], [], R, **kw))
    geo = PolygonPolygonJoinQuery(conf, UniformGrid(**COARSE), device="cpu")
    with pytest.raises(NotImplementedError, match="A12"):
        list(geo.run([], [], R, mesh=object()))
    with pytest.raises(ValueError):
        PointPointJoinQuery(conf, UniformGrid(**COARSE), device="cpu",
                            join_backend="xla")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            PointPointJoinQuery(conf, UniformGrid(**COARSE))


# ---------------------------------------------------------------------------
# Window assemblers


def _soa_chunks(seed, n, t_span, n_chunks, shuffle=0, t0=0):
    """SoA chunks of one stream over the Beijing extent; ``shuffle`` ms of
    event-time disorder between neighbouring events."""
    rng = np.random.default_rng(seed)
    ts = np.sort(rng.integers(t0, t0 + t_span, n)).astype(np.int64)
    if shuffle:
        ts = ts + rng.integers(-shuffle, shuffle + 1, n)
    ch = {"ts": ts, "x": rng.uniform(115.5, 117.6, n),
          "y": rng.uniform(39.6, 41.1, n),
          "oid": rng.integers(0, 1000, n).astype(np.int32)}
    cuts = np.linspace(0, n, n_chunks + 1).astype(int)
    return [{k: v[a:b] for k, v in ch.items()}
            for a, b in zip(cuts[:-1], cuts[1:])]


def _soa_windows_agree(got, want):
    assert [(w.start, w.end) for w in got] == [(w.start, w.end) for w in want]
    for a, b in zip(got, want):
        assert a.arrays.keys() == b.arrays.keys()
        for k in a.arrays:
            assert np.array_equal(a.arrays[k], b.arrays[k])


def test_soa_assembler_matches_jax():
    """Out-of-order chunks, a lateness bound, and events later than it."""
    chunks = _soa_chunks(6, 6000, 9000, 12, shuffle=400)
    chunks[7]["ts"][:50] -= 3000  # late beyond every live window
    got_asm = SoaWindowAssembler(1000, 500, ooo_ms=300)
    want_asm = JSoa(1000, 500, ooo_ms=300)
    got, want = list(got_asm.stream(chunks)), list(want_asm.stream(chunks))
    assert len(got) >= 15
    _soa_windows_agree(got, want)
    assert got_asm.dropped_late == want_asm.dropped_late > 0


def test_object_window_assembler_matches_jax():
    """Sliding windows with out-of-orderness and allowed-lateness
    refires."""
    rng = np.random.default_rng(8)
    ts = np.sort(rng.integers(0, 5000, 800)) + rng.integers(-600, 600, 800)
    evs = [JPoint(obj_id=str(i), timestamp=int(t)) for i, t in enumerate(ts)]
    got_asm = WindowAssembler(SlidingEventTimeWindows(1000, 500),
                              lambda e: e.timestamp, 200, 200)
    want_asm = JWA(JSW(1000, 500), lambda e: e.timestamp, 200, 200)
    got, want = list(got_asm.stream(evs)), list(want_asm.stream(evs))
    assert len(got) == len(want) > 10
    for a, b in zip(got, want):
        assert (a.start, a.end) == (b.start, b.end)
        assert [id(e) for e in a.events] == [id(e) for e in b.events]
    assert got_asm.dropped_late == want_asm.dropped_late > 0


# ---------------------------------------------------------------------------
# run_soa


SOA_CONF = dict(window_size=1.0, slide_step=0.5)


def _join_streams():
    """Two 2-second SoA streams; the right one starts 600 ms later, so the
    first window is one-sided."""
    left = _soa_chunks(11, 4000, 2000, 4)
    right = _soa_chunks(12, 2800, 1400, 4, t0=600)
    return left, right


def _soa_pairs(li, ri, dd, count):
    li, ri, dd = (np.asarray(a) for a in (li, ri, dd))
    keep = li >= 0
    assert keep.sum() == min(count, len(li))
    return {(int(a), int(b)): np.float32(d)
            for a, b, d in zip(li[keep], ri[keep], dd[keep])}


def _soa_windows_match(got, want):
    assert [w[:2] for w in got] == [w[:2] for w in want]
    for g, w in zip(got, want):
        assert (g[5], g[6]) == (w[5], w[6])
        pg, pw = _soa_pairs(*g[2:6]), _soa_pairs(*w[2:6])
        assert pg.keys() == pw.keys()
        keys = sorted(pg)
        assert _within_ulp([pg[k] for k in keys], [pw[k] for k in keys])


@pytest.mark.parametrize("max_pairs", [262_144, 1024])
def test_run_soa_matches_jax(max_pairs):
    left, right = _join_streams()
    op = PointPointJoinQuery(QueryConfiguration(**SOA_CONF),
                             UniformGrid(**COARSE), cap=CAP, device="cpu")
    got = list(op.run_soa(left, right, R, max_pairs=max_pairs))
    jop = JJoin(JConf(**SOA_CONF), JGrid(**COARSE), cap=CAP)
    want = list(jop.run_soa(left, right, R, max_pairs=max_pairs,
                            dtype=np.float32))
    _soa_windows_match(got, want)
    counts = [w[5] for w in got]
    assert counts[0] == 0 and len(got[0][2]) == 0  # one-sided window
    assert min(counts[1:]) > 1024  # the small budget must retry
    assert all(w[6] == 0 for w in got)
    if max_pairs == 1024:
        assert len(got[-1][2]) > 1024


def test_run_soa_resumes_from_jax_assembler_state():
    """A port operator resumed from JAX assembler snapshots taken after
    half the chunks yields, on the other half, the windows the JAX
    operator yields after the cut."""
    left, right = _join_streams()
    cut = 2
    states = []
    for chunks in (left, right):
        asm = JSoa(1000, 500)
        for c in chunks[:cut]:
            asm.feed(c)
        states.append(soa_assembler_state(asm))
    op = PointPointJoinQuery(QueryConfiguration(**SOA_CONF),
                             UniformGrid(**COARSE), cap=CAP, device="cpu",
                             soa_state=tuple(states))
    tail = list(op.run_soa(left[cut:], right[cut:], R))
    jop = JJoin(JConf(**SOA_CONF), JGrid(**COARSE), cap=CAP)
    want = list(jop.run_soa(left, right, R, dtype=np.float32))
    assert 2 <= len(tail) < len(want)
    _soa_windows_match(tail, want[len(want) - len(tail):])
    # the assembler alone: the same windows as a JAX one fed everything
    asm = soa_assembler_from_jax(states[0], 1000, 500)
    full = JSoa(1000, 500)
    fired = [w for c in left for w in full.feed(c)] + full.flush()
    resumed = [w for c in left[cut:] for w in asm.feed(c)] + asm.flush()
    _soa_windows_agree(resumed, fired[len(fired) - len(resumed):])


# ---------------------------------------------------------------------------
# run on Point objects


def _point_streams(n, seed, t_span=2000):
    rng = np.random.default_rng(seed)
    out = []
    for side in ("l", "r"):
        ts = np.sort(rng.integers(0, t_span, n))
        xs = rng.uniform(115.5, 117.6, n)
        ys = rng.uniform(39.6, 41.1, n)
        out.append([(f"{side}{i % 400}", int(t), float(x), float(y))
                    for i, (t, x, y) in enumerate(zip(ts, xs, ys))])
    return out


def _pair_multiset(res):
    keyed = defaultdict(list)
    for a, b, d in res.pairs:
        keyed[(a.obj_id, a.timestamp, b.obj_id, b.timestamp)].append(
            np.float32(d))
    return keyed


RUN_CASES = {
    "window_based": (dict(query_type="WindowBased", **SOA_CONF), 1500),
    "real_time": (dict(query_type="RealTime", realtime_batch_ms=250), 1500),
    "count_based": (dict(query_type="CountBased", count_window_size=700),
                    1500),
    "real_time_naive": (dict(query_type="RealTimeNaive",
                             realtime_batch_ms=500), 1500),
    "approximate": (dict(query_type="WindowBased", approximate_query=True,
                         **SOA_CONF), 300),
}


@pytest.mark.parametrize("case", list(RUN_CASES))
def test_run_matches_jax(case):
    conf_kw, n = RUN_CASES[case]
    qt = conf_kw.pop("query_type")
    conf_kw = dict(conf_kw)
    streams = _point_streams(n, 21)
    mk = [[Point(obj_id=o, timestamp=t, x=x, y=y) for o, t, x, y in s]
          for s in streams]
    jmk = [[JPoint(obj_id=o, timestamp=t, x=x, y=y) for o, t, x, y in s]
           for s in streams]
    op = PointPointJoinQuery(
        QueryConfiguration(query_type=QueryType[qt], **conf_kw),
        UniformGrid(**COARSE), cap=CAP, device="cpu")
    jop = JJoin(JConf(query_type=JQT[qt], **conf_kw), JGrid(**COARSE),
                cap=CAP)
    got = list(op.run(mk[0], mk[1], R))
    want = list(jop.run(jmk[0], jmk[1], R, dtype=np.float32))
    assert len(got) == len(want) >= 2
    n_pairs = 0
    for g, w in zip(got, want):
        assert (g.start, g.end, g.overflow, g.window_count) == \
            (w.start, w.end, w.overflow, w.window_count)
        pg, pw = _pair_multiset(g), _pair_multiset(w)
        assert Counter({k: len(v) for k, v in pg.items()}) == \
            Counter({k: len(v) for k, v in pw.items()})
        for k in pg:
            assert _within_ulp(sorted(pg[k]), sorted(pw[k]))
        n_pairs += len(g.pairs)
    assert n_pairs > 200
    if case == "approximate":
        # every grid candidate, beyond the radius too
        assert max(d for r in got for *_, d in r.pairs) > R
