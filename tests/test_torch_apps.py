"""Parity of the PyTorch port's apps (``apps/checkin.py``,
``apps/staytime.py``, ``ops/checkin.py``) and pane aggregates
(``streams/panes.py:sliding_aggregate``) with the JAX package's.

The same events, made with numpy from a seed, go through both packages;
the port's device paths run on the CPU here (``device="cpu"``) and the
JAX package's jitted kernels on its CPU backend, as its own tests run
them. Everything is held EXACTLY equal: the check-in kernel's slot
arrays, the emitted (room, capacity, occupancy) sequences, the stay-time
dwell per (window, cell) (int64 on the port's device path), the sensor
counts, the normalised stay times, and every array of
``sliding_aggregate`` (the same numpy code). The JAX package's own cases
(``tests/test_apps.py``, ``tests/test_panes.py:12-45``) run against the
port as well.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spatialflink_tpu.apps import checkin as jci
from spatialflink_tpu.apps import staytime as jst
from spatialflink_tpu.grid import UniformGrid as JGrid
from spatialflink_tpu.models.objects import Point as JPoint
from spatialflink_tpu.models.objects import Polygon as JPolygon
from spatialflink_tpu.ops.checkin import check_in_kernel as j_check_in
from spatialflink_tpu.streams.panes import sliding_aggregate as j_slide

from spatialflink_tpu_torch.apps import checkin as tci
from spatialflink_tpu_torch.apps import staytime as tst
from spatialflink_tpu_torch.grid import UniformGrid
from spatialflink_tpu_torch.models.objects import Point, Polygon
from spatialflink_tpu_torch.ops.checkin import check_in_kernel
from spatialflink_tpu_torch.streams.panes import sliding_aggregate

GRID = UniformGrid(10, 0.0, 10.0, 0.0, 10.0)
JGRID = JGrid(10, 0.0, 10.0, 0.0, 10.0)


def checkin_events(mod, seed, n, n_rooms, n_users, repeat=0.3):
    """``n`` check-in events of ``mod`` (either package's app module):
    random doors, and with probability ``repeat`` a user's previous door
    again (a missed event, so both synthesis branches fire)."""
    rng = np.random.default_rng(seed)
    last = {}
    out = []
    for i in range(n):
        u = f"u{int(rng.integers(0, n_users))}"
        if u in last and rng.uniform() < repeat:
            dev = last[u]
        else:
            dev = (f"room{int(rng.integers(0, n_rooms))}-"
                   f"{'in' if rng.integers(0, 2) else 'out'}")
        last[u] = dev
        out.append(mod.CheckInEvent(f"e{i}", dev, u,
                                    int(1000 + 7 * i + rng.integers(0, 5))))
    return out


@pytest.mark.parametrize("seed,n,rooms,users", [
    (0, 8, 2, 2), (1, 300, 6, 9), (2, 1000, 40, 120), (3, 257, 1, 1)])
def test_check_in_kernel_matches(seed, n, rooms, users):
    rng = np.random.default_rng(seed)
    nb = 1 << max(3, (n - 1).bit_length())
    user = rng.integers(0, users, nb).astype(np.int32)
    room = rng.integers(0, rooms, nb).astype(np.int32)
    dirn = np.where(rng.integers(0, 2, nb) == 1, 1, -1).astype(np.int32)
    # Repeat the previous event of a user now and then.
    for i in range(1, nb):
        if rng.uniform() < 0.3:
            prev = np.nonzero(user[:i] == user[i])[0]
            if len(prev):
                room[i], dirn[i] = room[prev[-1]], dirn[prev[-1]]
    ts = np.sort(rng.integers(0, 10 ** 12, nb)).astype(np.int64)
    valid = np.arange(nb) < n
    got = check_in_kernel(*(torch.from_numpy(a) for a in
                            (user, room, dirn, ts, valid)), num_rooms=rooms)
    want = j_check_in(*(jnp.asarray(a) for a in (user, room, dirn, ts, valid)),
                      num_rooms=rooms)
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert np.array_equal(g.numpy(), w)
    assert got[4].dtype == torch.int32 and got[2].dtype == torch.int64
    assert bool(got[3][0::2].any()) or n < 2 or rooms * users > n


@pytest.mark.parametrize("seed,n,rooms,users", [
    (0, 400, 6, 9), (5, 3000, 25, 200), (6, 1, 1, 1)])
def test_check_in_query_soa_equals_host_walk(seed, n, rooms, users):
    caps = {"room0": 5, "room3": 2}
    t_evs = checkin_events(tci, seed, n, rooms, users)
    j_evs = checkin_events(jci, seed, n, rooms, users)
    strip = lambda out: [(r, c, o) for r, c, o, _w in out]  # noqa: E731
    host = strip(tci.check_in_query(iter(t_evs), caps))
    soa = strip(tci.check_in_query_soa(iter(t_evs), caps, device="cpu"))
    assert soa == host
    assert host == strip(jci.check_in_query(iter(j_evs), caps))
    assert soa == strip(jci.check_in_query_soa(iter(j_evs), caps))
    if n > 1:
        assert len(host) > n  # synthesized events occurred


def test_check_in_reference_cases():
    """tests/test_apps.py's check-in cases through the port."""
    E = tci.CheckInEvent
    occ = lambda evs, caps: [  # noqa: E731
        (r, c, o) for r, c, o, _ in tci.check_in_query_soa(
            iter(evs), caps, device="cpu")]
    out = occ([E("e1", "room1-in", "u1", 1000), E("e2", "room1-in", "u2",
                                                  2000),
               E("e3", "room1-out", "u1", 3000)], {"room1": 10})
    assert out == [("room1", 10, 1), ("room1", 10, 2), ("room1", 10, 1)]
    assert [o for _, _, o in occ([E("e1", "room1-in", "u1", 1000),
                                  E("e2", "room1-in", "u1", 3000)],
                                 {})] == [1, 0, 1]
    assert [o for _, _, o in occ([E("e1", "room2-out", "u1", 1000),
                                  E("e2", "room2-out", "u1", 5000)],
                                 {})] == [-1, 0, -1]
    assert list(tci.check_in_query_soa(iter([]), {}, device="cpu")) == []
    ev = E("e", "lab-7-in", "u", 0)
    assert (ev.room, ev.direction) == ("lab", "7-in")


def _stay_stream(seed, n=4000, n_obj=12):
    rng = np.random.default_rng(seed)
    ts = np.sort(rng.integers(0, 40_000, n)).astype(np.int64)
    x = rng.uniform(-0.5, 10.5, n)
    y = rng.uniform(-0.5, 10.5, n)
    oid = rng.integers(0, n_obj, n)
    ts[100] = ts[101]
    return ts, x, y, oid


def _points(mod, ts, x, y, oid):
    return [mod(obj_id=f"obj{o}", timestamp=int(t), x=float(a), y=float(b))
            for t, a, b, o in zip(ts, x, y, oid)]


@pytest.mark.parametrize("seed,window,slide", [(21, 10, 5), (22, 4, 4),
                                               (23, 7, 1)])
def test_cell_stay_time_matches(seed, window, slide):
    ts, x, y, oid = _stay_stream(seed)
    host = list(tst.cell_stay_time(iter(_points(Point, ts, x, y, oid)),
                                   set(), 0, window, slide, GRID))
    want = list(jst.cell_stay_time(iter(_points(JPoint, ts, x, y, oid)),
                                   set(), 0, window, slide, JGRID))
    assert host == want and host
    chunks = [{"ts": ts, "x": x, "y": y, "oid": oid.astype(np.int32)}]
    soa = list(tst.cell_stay_time_soa(iter(chunks), window, slide, GRID,
                                      device="cpu"))
    jsoa = list(jst.cell_stay_time_soa(iter(chunks), window, slide, JGRID))
    assert len(soa) == len(jsoa) == len(host)
    for (s, e, c, d), (js, je, jc, jd), (hs, he, cells) in zip(soa, jsoa,
                                                               host):
        assert (s, e) == (js, je) == (hs, he)
        assert np.array_equal(c, jc) and np.array_equal(d, jd)
        assert d.dtype == np.int64
        named = {(GRID.cell_name(int(k)) if k < GRID.num_cells else "out"):
                 float(v) for k, v in zip(c, d)}
        assert named == cells


def test_cell_stay_time_soa_filter_and_suppression():
    """tests/test_apps.py's trajId-filter cases through the port."""
    ts = np.asarray([0, 1000, 2000, 3000, 4000, 5000], np.int64)
    chunks = [{"ts": ts, "x": np.full(6, 1.5), "y": np.full(6, 1.5),
               "oid": np.asarray([0, 1, 0, 1, 0, 1], np.int32)}]
    allow = np.asarray([True, False])
    (s, e, cid, dwell), = tst.cell_stay_time_soa(iter(chunks), 10, 10, GRID,
                                                 oid_allow=allow,
                                                 device="cpu")
    assert cid.tolist() == [GRID.flat_cell(1.5, 1.5)] and dwell[0] == 4000
    chunks = [{"ts": np.asarray([100, 200, 10_100], np.int64),
               "x": np.asarray([1.5, 1.6, 1.5]),
               "y": np.asarray([1.5, 1.6, 1.5]),
               "oid": np.asarray([1, 1, 0], np.int32)}]
    out = list(tst.cell_stay_time_soa(iter(chunks), 10, 10, GRID,
                                      oid_allow=allow, device="cpu"))
    assert [(s, e, len(c)) for s, e, c, _ in out] == [(10_000, 20_000, 0)]
    pts = [Point(obj_id="keep" if i % 2 == 0 else "drop", timestamp=t,
                 x=1.5, y=1.5) for i, t in enumerate(ts.tolist())]
    (_, _, cells), = tst.cell_stay_time(iter(pts), {"keep"}, 0, 10, 10, GRID)
    assert cells == {GRID.cell_name(GRID.flat_cell(1.5, 1.5)): 4000.0}


def test_stay_time_window_soa_keeps_the_jax_signature():
    """The JAX positional call ``(ts, oid, xy, grid, kernel)`` binds as
    there: ``kernel`` in the fifth position, ``device`` keyword-only; the
    window's (cell_ids, dwell_ms) equal the JAX ones exactly."""
    import inspect

    from spatialflink_tpu.ops.trajectory import stay_time_cells_kernel as jk
    from spatialflink_tpu_torch.ops.trajectory import stay_time_cells_kernel

    params = inspect.signature(tst.stay_time_window_soa).parameters
    assert list(params)[:5] == list(
        inspect.signature(jst.stay_time_window_soa).parameters)
    assert params["device"].kind is inspect.Parameter.KEYWORD_ONLY
    ts, x, y, oid = _stay_stream(24)
    xy = np.stack([x, y], axis=1)
    want = jst.stay_time_window_soa(ts, oid, xy, JGRID, jk)
    for got in (tst.stay_time_window_soa(ts, oid, xy, GRID,
                                         stay_time_cells_kernel,
                                         device="cpu"),
                tst.stay_time_window_soa(ts, oid, xy, GRID, device="cpu")):
        assert all(np.array_equal(g, w) for g, w in zip(got, want))
        assert len(got[0]) > 50


def _sensors(mod, seed, n=12):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        cx, cy = rng.uniform(0, 10, 2)
        w, h = rng.uniform(0.05, 3.0, 2)
        ring = np.array([[cx - w, cy - h], [cx + w, cy - h], [cx + w, cy + h],
                         [cx - w, cy + h], [cx - w, cy - h]])
        out.append(mod(obj_id=f"s{i}", timestamp=int(i * 1500), rings=[ring]))
    strip = np.array([[-1.0, 4.45], [11.0, 4.45], [11.0, 4.55], [-1.0, 4.55],
                      [-1.0, 4.45]])
    out.append(mod(obj_id="strip", timestamp=1000, rings=[strip]))
    out.sort(key=lambda p: p.timestamp)
    out.append(mod(obj_id="late", timestamp=40_000,
                   rings=[np.array([[8, 8], [9, 8], [9, 9], [8, 9], [8, 8]],
                                   float)]))
    return out


@pytest.mark.parametrize("seed", [31, 32])
def test_sensor_intersection_and_normalisation_match(seed):
    got = list(tst.cell_sensor_range_intersection(
        iter(_sensors(Polygon, seed)), set(), 0, 10, 5, GRID, device="cpu"))
    want = list(jst.cell_sensor_range_intersection(
        iter(_sensors(JPolygon, seed)), set(), 0, 10, 5, JGRID))
    assert got == want and got
    assert got[0][2].get(GRID.cell_name(5 * 10 + 4)) >= 1  # the strip
    ts, x, y, oid = _stay_stream(seed, n=1500)
    norm = list(tst.normalized_cell_stay_time(
        iter(_points(Point, ts, x, y, oid)), set(),
        iter(_sensors(Polygon, seed)), set(), 0, 10, 5, GRID, device="cpu"))
    jnorm = list(jst.normalized_cell_stay_time(
        iter(_points(JPoint, ts, x, y, oid)), set(),
        iter(_sensors(JPolygon, seed)), set(), 0, 10, 5, JGRID))
    assert norm == jnorm and norm


def _agg_stream(seed, n=2000, keys=5, t_max=30_000):
    rng = np.random.default_rng(seed)
    ts = np.sort(rng.integers(0, t_max, n)).astype(np.int64)
    return ts, rng.integers(0, keys, n), rng.normal(size=n), \
        rng.integers(-50, 50, n).astype(float)


@pytest.mark.parametrize("size,slide,sumsq", [(10_000, 1_000, True),
                                              (10_000, 10, False),
                                              (3_000, 3_000, True)])
def test_sliding_aggregate_matches(size, slide, sumsq):
    ts, key, val, ival = _agg_stream(size + slide)
    kw = dict(sum_fields={"v": val, "i": ival}, minmax_fields={"v": val},
              min_fields={"i": ival}, max_fields={"w": -val}, sumsq=sumsq)
    got = sliding_aggregate(ts, key, 5, size, slide, **kw)
    want = j_slide(ts, key, 5, size, slide, **kw)
    assert np.array_equal(got.starts, want.starts)
    assert np.array_equal(got.ends, want.ends)
    assert np.array_equal(got.count, want.count)
    for name in ("sums", "sumsqs", "mins", "maxs"):
        a, b = getattr(got, name), getattr(want, name)
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k])


def test_sliding_aggregate_against_brute_force():
    """tests/test_panes.py:12-45 through the port: counts, minima and
    maxima exact; sums within rel 1e-12 (the pane sums are differences of
    cumulative sums, so they associate differently)."""
    ts, key, val, _ = _agg_stream(0)
    size, slide = 10_000, 1_000
    win = sliding_aggregate(ts, key, 5, size, slide, sum_fields={"v": val},
                            minmax_fields={"v": val}, sumsq=True)
    assert len(win.starts) > 0
    for w, start in enumerate(win.starts):
        in_win = (ts >= start) & (ts < start + size)
        assert in_win.any()
        for k in range(5):
            m = in_win & (key == k)
            assert win.count[w, k] == m.sum()
            if m.any():
                assert win.sums["v"][w, k] == pytest.approx(val[m].sum(),
                                                            rel=1e-12)
                assert win.sumsqs["v"][w, k] == pytest.approx(
                    (val[m] ** 2).sum(), rel=1e-12)
                assert win.mins["v"][w, k] == val[m].min()
                assert win.maxs["v"][w, k] == val[m].max()
    with pytest.raises(ValueError, match="multiple"):
        sliding_aggregate(np.array([0]), np.array([0]), 1, 1000, 300)
    empty = sliding_aggregate(np.array([], np.int64), np.array([], np.int64),
                              3, 1000, 100, sum_fields={"v": []}, sumsq=True)
    want = j_slide(np.array([], np.int64), np.array([], np.int64), 3, 1000,
                   100, sum_fields={"v": []}, sumsq=True)
    assert len(empty.starts) == 0 and empty.sums.keys() == want.sums.keys()
