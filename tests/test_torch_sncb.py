"""Parity of the port's SNCB domain layer (``spatialflink_tpu_torch.sncb``)
with the JAX package's.

The same seeded inputs go through the JAX function and its port, the port
with ``device="cpu"``; the records must be equal, in order, floats bit for
bit (both sides run the same numpy and Python arithmetic on the host).
The zone test is the one part computed by each package's array library:
the port's float64 distances equal the JAX ``point_polygon_distance`` run
op by op bit for bit, and the keep masks equal the JAX package's jitted
``contains_any_zone`` (under the session's x64), its numpy twin and the
port's, on points placed within a few ulps of each zone set's buffered
boundary, inside, outside and on a vertex. One case for each case of
``tests/test_sncb.py``; then the window cores, the Q2 batch replay, the
resource copies, the socket CLI and the device rule.
"""

import dataclasses
import os
import socket
import threading
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spatialflink_tpu.ops.polygon import point_polygon_distance as j_ppd
from spatialflink_tpu.sncb import common as jcommon
from spatialflink_tpu.sncb import mobility as jmobility
from spatialflink_tpu.sncb import ops as jsops
from spatialflink_tpu.sncb import queries as jqueries
from spatialflink_tpu.sncb import runners as jrunners

from spatialflink_tpu_torch.ops.polygon import point_polygon_distance
from spatialflink_tpu_torch.sncb import common as tcommon
from spatialflink_tpu_torch.sncb import mobility as tmobility
from spatialflink_tpu_torch.sncb import ops as tsops
from spatialflink_tpu_torch.sncb import queries as tqueries
from spatialflink_tpu_torch.sncb import runners as trunners

REPO = Path(__file__).resolve().parents[1]
JAX = SimpleNamespace(c=jcommon, m=jmobility, o=jsops, q=jqueries,
                      r=jrunners, dev={})
PORT = SimpleNamespace(c=tcommon, m=tmobility, o=tsops, q=tqueries,
                       r=trunners, dev={"device": "cpu"})


def rec(x):
    """A comparable form of a result: dataclasses by class name and
    fields, floats by their bits (NaN included), arrays by dtype and
    values, containers element by element."""
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return (type(x).__name__,) + tuple(
            rec(getattr(x, f.name)) for f in dataclasses.fields(x))
    if isinstance(x, float):
        return ("f", x.hex())
    if isinstance(x, np.ndarray):
        return (str(x.dtype), rec(x.tolist()))
    if isinstance(x, np.generic):
        return rec(x.item())
    if isinstance(x, dict):
        return tuple((k, rec(v)) for k, v in x.items())
    if isinstance(x, (list, tuple)):
        return tuple(rec(v) for v in x)
    return x


def same(got, want):
    assert rec(got) == rec(want)


def _zones(p):
    L = p.c.PolygonLoader
    return (L.load_geojson_buffered("high_risk_zones.geojson", 20.0),
            L.load_geojson_buffered("maintenance_areas.geojson", 0.0),
            L.load_wkt_buffered("q5_fence.wkt", 20.0))


def _fixture(p):
    return iter(p.r.sample_gps_events())


def _mk(p, n=50, lon=4.3658, lat=50.6456, dev="d0", t0=0, dt=100):
    return [p.c.GpsEvent(dev, lon, lat, t0 + i * dt, 10.0, 4.0, 5.0)
            for i in range(n)]


def _brussels_events(p, n, seed, every_ms=50):
    """Seeded events over the bundled zones: thirds near the high-risk
    zone, the maintenance area and the fence (as the JAX suite's SNCB DAG
    draws them), FA ~ U(0, 1), FF ~ U(0, 0.4), some fields None."""
    rng = np.random.default_rng(seed)
    xs = rng.uniform(4.25, 4.50, n)
    ys = rng.uniform(50.75, 50.95, n)
    for k, (cx, cy) in enumerate([(4.355, 50.855), (4.385, 50.855),
                                  (4.405, 50.855)]):
        xs[k::4] = cx + rng.normal(0.0, 0.004, len(xs[k::4]))
        ys[k::4] = cy + rng.normal(0.0, 0.004, len(ys[k::4]))
    fa = rng.uniform(0.0, 1.0, n)
    ff = rng.uniform(0.0, 0.4, n)
    sp = rng.uniform(20.0, 110.0, n)
    none = rng.random(n) < 0.05
    return [p.c.GpsEvent(f"dev{i % 7}", float(xs[i]), float(ys[i]),
                         1_700_000_000_000 + i * every_ms, float(sp[i]),
                         None if none[i] else float(fa[i]),
                         None if none[i] else float(ff[i]))
            for i in range(n)]


# -- one case for each case of tests/test_sncb.py ----------------------------


def _csv_schema(p):
    line = "1700000000000,trainX,z,4.5,5.2,a,b,c,d,e,f,33.5,50.8466,4.3517"
    return [p.c.csv_to_gps_event(line),
            p.c.csv_to_gps_event("xx,dev,z,bad,bad,a,b,c,d,e,f,bad,bad,bad"),
            p.c.csv_to_gps_event("17,only"), p.c.MnGpsEvent is p.c.GpsEvent]


def _zone_loading(p):
    zones = p.c.PolygonLoader.load_geojson_buffered(
        "high_risk_zones.geojson", 20.0)
    pts = p.c.CRSUtils.enrich_batch(
        [p.c.GpsEvent("a", 4.355, 50.855, 0), p.c.GpsEvent("b", 4.5, 50.5, 0),
         p.c.GpsEvent("c", 4.350, 50.855, 0)])
    edge = np.concatenate([pts, pts[2:] - [15.0, 0.0], pts[2:] - [45.0, 0.0]])
    return [zones, edge, p.c.contains_any_zone(zones, edge, **p.dev)]


def _wkt_fence(p):
    fence = p.c.PolygonLoader.load_wkt_buffered("q5_fence.wkt", 20.0)
    pts = p.c.CRSUtils.enrich_batch([p.c.GpsEvent("a", 4.405, 50.855, 0),
                                     p.c.GpsEvent("b", 4.45, 50.855, 0)])
    return [fence, p.c.contains_any_zone(fence, pts, **p.dev)]


def _ops_aggregations(p):
    evs = [p.c.GpsEvent("d", 0, 0, 1000, 10.0, 4.0, 5.0),
           p.c.GpsEvent("d", 0, 0, 2000, 20.0, 4.8, 5.4),
           p.c.GpsEvent("d", 0, 0, 3000, 30.0, None, None)]
    return [p.o.variation(evs), p.o.variance(evs), p.o.traj_speed(evs),
            p.o.trajectory_wkt([]), p.o.trajectory_wkt(evs[:1]),
            p.o.variation([]), p.o.variance(evs[:1]),
            p.o.traj_speed(evs[2:] + [p.c.GpsEvent("e", 1, 2, 5)])]


def _q1_fixture(p):
    risk = _zones(p)[0]
    return list(p.q.q1_high_risk(_fixture(p), risk, **p.dev))


def _q2_fixture(p):
    maint = _zones(p)[1]
    return list(p.q.q2_brake_monitor(_fixture(p), maint, slide_ms=500,
                                     **p.dev))


def _q3_fixture(p):
    return list(p.q.q3_trajectory(_fixture(p), slide_ms=1000))


def _q4_restriction(p):
    return list(p.q.q4_trajectory_restricted(
        _fixture(p), 4.3, 4.4, 50.8, 50.9, 1_700_000_000_000,
        1_700_000_002_000, slide_ms=1000))


def _q5_fixture(p):
    fence = _zones(p)[2]
    return list(p.q.q5_traj_speed_fence(_fixture(p), fence, **p.dev))


def _local_runner(p):
    return p.r.local_test_runner(**p.dev)


def _mn_q1(p):
    evs = _mk(p) + [p.c.GpsEvent("far", 10.0, 60.0, i * 100, 1.0, 0, 0)
                    for i in range(10)]
    evs.sort(key=lambda e: e.ts)
    return list(p.m.mn_q1(iter(evs), 4.3658, 50.6456, 2.0))


def _mn_q2(p):
    inside = [p.c.GpsEvent("a", 4.3, 50.4, i * 100, 1, 2.0, 2.0)
              for i in range(10)]
    outside = [p.c.GpsEvent("b", 5.5, 51.5, i * 100, 1, 4.0 + (i % 2), 5.0)
               for i in range(10)]
    evs = sorted(inside + outside, key=lambda e: e.ts)
    return list(p.m.mn_q2(iter(evs), slide_ms=1000))


def _mn_q3_q4(p):
    return [list(p.m.mn_q3(iter(_mk(p, 20, dt=500)))),
            list(p.m.mn_q4(iter(_mk(p, 20, dt=500)), 4.0, 50.0, 5.0, 51.0, 0,
                           10**15))]


def _mn_q5(p):
    slow = [p.c.GpsEvent("slow", 4.41, 50.85, i * 500, 30.0, 0, 0)
            for i in range(10)]
    fast = [p.c.GpsEvent("fast", 4.41, 50.85, i * 500, 150.0, 0, 0)
            for i in range(10)]
    evs = sorted(slow + fast, key=lambda e: e.ts)
    return list(p.m.mn_q5(iter(evs), p.m.Q5_FENCE, 0.001, **p.dev))


def _mobility_roundtrip(p, tmp_path):
    lines = [f"{i*200},dev{i%3},z,4.{i%7},5.0,a,b,c,d,e,f,{20+i%30}.5,"
             f"{50.846 + (i % 9) * 0.001},{4.406 + (i % 5) * 0.001}"
             for i in range(100)]
    out = []
    for q in ("q1", "q2", "q3", "q4", "q5"):
        kw = p.dev if q == "q5" else {}
        path = tmp_path / f"{q}.csv"
        rows = p.m.mobility_runner(q, iter(lines), out_path=str(path), **kw)
        out.append((rows, path.read_text()))
    return out


def _benchmark_small(p):
    out = []
    for q in ("q1", "q2", "q3", "q5"):
        rep = p.r.benchmark_runner(q, target_eps=2000, duration_ms=2000,
                                   **p.dev)
        out.append((rep.query, rep.events, rep.results))
    return out


SNCB_CASES = {
    "csv_schema_14_columns": _csv_schema,
    "zone_loading_and_containment": _zone_loading,
    "wkt_fence_loading": _wkt_fence,
    "ops_aggregations": _ops_aggregations,
    "q1_high_risk_fixture": _q1_fixture,
    "q2_brake_monitor_fixture": _q2_fixture,
    "q3_trajectory_fixture": _q3_fixture,
    "q4_restriction": _q4_restriction,
    "q5_fence_fixture": _q5_fixture,
    "local_test_runner_end_to_end": _local_runner,
    "mn_q1_counts": _mn_q1,
    "mn_q2_excludes_box_and_counts_all_key": _mn_q2,
    "mn_q3_q4_trajectories": _mn_q3_q4,
    "mn_q5_fence_and_speed_filter": _mn_q5,
    "mobility_runner_csv_roundtrip": _mobility_roundtrip,
    "benchmark_runner_small": _benchmark_small,
}


@pytest.mark.parametrize("case", list(SNCB_CASES))
def test_sncb_case_equals_jax(case, tmp_path):
    fn = SNCB_CASES[case]
    args = ((tmp_path / "port",), (tmp_path / "jax",)) \
        if case == "mobility_runner_csv_roundtrip" else ((), ())
    for a in args:
        for d in a:
            d.mkdir()
    got = fn(PORT, *args[0])
    want = fn(JAX, *args[1])
    same(got, want)
    assert rec(got) and got != []


def test_fixture_expectations_hold_on_the_port():
    # The golden expectations of LocalTestRunner.java:91-113, on the port.
    out = trunners.local_test_runner(device="cpu")
    assert {r.raw.device_id for r in out["q1"]} == {"A"}
    assert len(out["q1"]) == 3 and 5_600_000 < out["q1"][0].y_metric
    assert {o.device_id for o in out["q2"]} == {"A", "B"}
    assert {o.device_id for o in out["q5"]} == {"E"}


# -- the window cores, the batch replay, the aliases --------------------------


def _window_cores(p):
    risk, maint, fence = _zones(p)
    zones = p.q.buffer_q1_zones(risk, 20.0)
    evs = _brussels_events(p, 3000, 21)
    out = []
    for dev, start, end, win in p.q.keyed_windows(
            iter(evs), 10_000, 5_000, key_fn=lambda e: e.device_id):
        out.append((dev, start, end, len(win)))
    for backend in ("device", "numpy"):
        kw = p.dev if backend == "device" else {}
        out += [p.q.q1_window(evs, zones, backend=backend, **kw),
                p.q.q2_window(evs, maint, 0, 10_000, backend=backend, **kw),
                p.q.q5_window(evs, fence, 0, 10_000, avg_threshold=60.0,
                              backend=backend, **kw)]
    out += [p.q.q3_window(evs[:200], 0, 10_000),
            p.q.q4_window(evs, 0, 10_000, 4.3, 4.4, 50.8, 50.9,
                          1_700_000_000_000, 1_700_000_060_000)]
    return out


def _streaming_queries(p):
    risk, maint, fence = _zones(p)
    evs = _brussels_events(p, 4000, 22, every_ms=20)
    return [list(p.q.q1_high_risk(iter(evs), risk, 20.0, 10, **p.dev)),
            list(p.q.q2_brake_monitor(iter(evs), maint, 10.0, 1000, 0.6, 0.5,
                                      **p.dev)),
            list(p.q.q5_traj_speed_fence(iter(evs), fence, 60.0, 20.0, 45.0,
                                         5.0, **p.dev)),
            list(p.q.q3_trajectory(iter(evs[:600]), 10.0, 1000))]


def _q2_batch(p):
    maint = _zones(p)[1]
    evs = _brussels_events(p, 5000, 23, every_ms=10)
    return [p.q.q2_brake_monitor_batch(evs, maint, **p.dev),
            p.q.q2_brake_monitor_batch(evs, maint, 1.0, 100, 0.9, 0.35,
                                       **p.dev)]


def _mn_aliases(p):
    evs = _brussels_events(p, 2000, 24, every_ms=30)
    return [list(p.m.MN_Q1.build(iter(evs), 4.36, 50.85, 0.01)),
            list(p.m.MN_Q2.build(iter(evs), 10.0, 1000)),
            list(p.m.MN_Q3.build(iter(evs[:300]))),
            list(p.m.MN_Q4.build(iter(evs[:300]), 4.3, 50.8, 4.45, 50.9, 0,
                                 2**62)),
            list(p.m.MN_Q5.build(iter(evs), p.m.Q5_FENCE, 0.001, **p.dev)),
            list(p.q.Q3_Trajectory.build(iter(evs[:300]), 10.0, 1000)),
            p.m.MN_Q1.CountOut(1, 2, 3)]


def _mobility_query_runner(p, tmp_path):
    evs = _brussels_events(p, 1500, 25, every_ms=40)
    path = tmp_path / "mn.csv"
    path.write_text("".join(
        f"{e.ts},{e.device_id},z,{e.fa},{e.ff},a,b,c,d,e,f,{e.gps_speed},"
        f"{e.lat},{e.lon}\n" for e in evs))
    reps = p.r.mobility_query_runner(str(path), limit=1200, **p.dev)
    return [(q, r.events, r.results) for q, r in reps.items()]


MORE_CASES = {
    "window_cores": _window_cores,
    "streaming_queries_positional": _streaming_queries,
    "q2_brake_monitor_batch": _q2_batch,
    "mn_aliases": _mn_aliases,
    "mobility_query_runner": _mobility_query_runner,
}


@pytest.mark.parametrize("case", list(MORE_CASES))
def test_domain_case_equals_jax(case, tmp_path):
    fn = MORE_CASES[case]
    extra = case == "mobility_query_runner"
    if extra:
        for side in ("port", "jax"):
            (tmp_path / side).mkdir()
    got = fn(PORT, *((tmp_path / "port",) if extra else ()))
    want = fn(JAX, *((tmp_path / "jax",) if extra else ()))
    same(got, want)
    if extra:
        assert all(results > 0 for _, _, results in got)
    else:
        assert any(len(x) for x in got if isinstance(x, list))


def test_q2_batch_equals_streaming_q2():
    # The pane replay's contract: the same alerts as the windowed query.
    maint = _zones(PORT)[1]
    evs = _brussels_events(PORT, 1500, 26, every_ms=10)
    batch = tqueries.q2_brake_monitor_batch(evs, maint, 1.0, 100, 0.9, 0.35,
                                            device="cpu")
    stream = list(tqueries.q2_brake_monitor(iter(evs), maint, 1.0, 100, 0.9,
                                            0.35, device="cpu"))
    assert batch and [(o.device_id, o.win_start, o.count) for o in batch] \
        == sorted([(o.device_id, o.win_start, o.count) for o in stream],
                  key=lambda t: (t[1], t[0]))


# -- the zone test at the boundary --------------------------------------------


def _zone_sets(p):
    risk, maint, fence = _zones(p)
    degree = [p.c.BufferedZone(
        rings_metric=[np.asarray(p.m.Q5_FENCE, float)], buffer_m=0.001)]
    return {"q1": p.q.buffer_q1_zones(risk, 20.0), "maintenance": maint,
            "q5_fence": fence, "mn_q5_fence": degree}


def _boundary_points(zones, seed):
    """Points within a few ulps of each zone's buffered boundary (along
    each edge's outward normal from its midpoint, then stepped one ulp at
    a time across the boundary as the port computes it), inside, far
    outside, on every vertex, and at the buffer distance from a vertex."""
    rng = np.random.default_rng(seed)
    pts = []
    for z in zones:
        verts, ev = z.packed()
        vd, ed = torch.from_numpy(verts), torch.from_numpy(ev)

        def dist(q):
            return point_polygon_distance(
                torch.from_numpy(np.asarray(q, np.float64)), vd, ed).numpy()

        center = verts[:-1][ev].mean(0)
        for i in np.nonzero(ev)[0]:
            a, b = verts[i], verts[i + 1]
            mid = (a + b) / 2
            nrm = np.array([b[1] - a[1], a[0] - b[0]])
            nrm /= np.hypot(*nrm)
            if np.dot(mid - center, nrm) < 0:
                nrm = -nrm
            base = mid + nrm * z.buffer_m
            # Walk x one ulp at a time until the distance crosses the
            # buffer, then keep the points a few ulps either side.
            x = base[0]
            sgn = 1.0 if abs(nrm[0]) >= 1e-12 and nrm[0] > 0 else -1.0
            for _ in range(64):
                inside = dist([[x, base[1]]])[0] <= z.buffer_m
                nxt = np.nextafter(x, sgn * np.inf if inside else
                                   -sgn * np.inf)
                if (dist([[nxt, base[1]]])[0] <= z.buffer_m) != inside:
                    break
                x = nxt
            for k in range(-4, 5):
                pts.append([x + k * np.spacing(x), base[1]])
            pts.append(list(a))
        r = np.sqrt(rng.uniform(0, 1, 40)) * (z.buffer_m + 1e-9)
        th = rng.uniform(0, 2 * np.pi, 40)
        v0 = verts[0]
        pts += list(np.stack([v0[0] + r * np.cos(th),
                              v0[1] + r * np.sin(th)], 1))
        pts += list(center + rng.normal(0, 1, (20, 2))
                    * np.ptp(verts, axis=0))
    return np.asarray(pts, np.float64)


@pytest.mark.parametrize("name", ["q1", "maintenance", "q5_fence",
                                  "mn_q5_fence"])
def test_zone_masks_and_distances_at_the_boundary(name):
    zones = _zone_sets(PORT)[name]
    jzones = _zone_sets(JAX)[name]
    pts = _boundary_points(zones, seed=len(name))
    got = tcommon.contains_any_zone(zones, pts, device="cpu")
    assert np.array_equal(got, jcommon.contains_any_zone(jzones, pts))
    assert np.array_equal(got, jcommon.contains_any_zone_np(jzones, pts))
    assert np.array_equal(got, tcommon.contains_any_zone_np(zones, pts))
    assert 0 < got.sum() < len(got)
    for z, jz in zip(zones, jzones):
        verts, ev = z.packed()
        jverts, jev = jz.packed()
        assert np.array_equal(verts, jverts) and np.array_equal(ev, jev)
        d = point_polygon_distance(torch.from_numpy(pts),
                                   torch.from_numpy(verts),
                                   torch.from_numpy(ev)).numpy()
        with jax.disable_jit():
            jd = np.asarray(j_ppd(jnp.asarray(pts), jnp.asarray(verts),
                                  jnp.asarray(ev)))
        assert d.dtype == np.float64
        assert np.array_equal(d.view(np.int64), jd.view(np.int64))


def test_contains_any_zone_empty_inputs():
    zones = _zone_sets(PORT)["q1"]
    assert tcommon.contains_any_zone([], np.zeros((3, 2)),
                                     device="cpu").tolist() == [False] * 3
    assert tcommon.contains_any_zone(zones, np.zeros((0, 2)),
                                     device="cpu").shape == (0,)


def test_zone_blocks_do_not_change_the_mask(monkeypatch):
    zones = _zone_sets(PORT)["q5_fence"]
    pts = _boundary_points(zones, seed=3)
    want = tcommon.contains_any_zone(zones, pts, device="cpu")
    monkeypatch.setattr(tcommon, "BLOCK_LANES_CPU", 7)
    assert np.array_equal(
        tcommon.contains_any_zone(zones, pts, device="cpu"), want)


# -- resources, the socket CLI, the device rule -------------------------------


@pytest.mark.parametrize("name", ["high_risk_zones.geojson",
                                  "maintenance_areas.geojson",
                                  "q5_fence.wkt"])
def test_resource_copies_are_byte_equal(name):
    port = REPO / "spatialflink_tpu_torch" / "sncb" / "resources" / name
    assert port.read_bytes() == \
        (REPO / "spatialflink_tpu" / "sncb" / "resources" / name).read_bytes()
    assert Path(tcommon.PolygonLoader._resolve(name)) == port


def _serve(lines):
    srv = socket.socket()
    srv.bind(("127.0.0.1", 0))
    srv.listen(1)

    def run():
        conn, _ = srv.accept()
        with conn:
            conn.sendall("".join(ln + "\n" for ln in lines).encode())
        srv.close()

    t = threading.Thread(target=run, daemon=True)
    t.start()
    return srv.getsockname()[1], t


@pytest.mark.parametrize("query", ["q1", "q5"])
def test_socket_cli_equals_jax(query, tmp_path):
    evs = _brussels_events(PORT, 1200, 27, every_ms=40)
    lines = [f"{e.ts},{e.device_id},z,{e.fa},{e.ff},a,b,c,d,e,f,"
             f"{e.gps_speed},{e.lat},{e.lon}" for e in evs]
    outs = []
    for side, main, kw in (("port", tmobility.main, {"device": "cpu"}),
                           ("jax", jmobility.main, {})):
        port, t = _serve(lines)
        out_dir = tmp_path / side
        assert main([query, "127.0.0.1", str(port), str(out_dir)], **kw) == 0
        t.join(timeout=30)
        assert not t.is_alive()
        outs.append((out_dir / f"output_query{query[1:]}.csv").read_text())
    assert outs[0] == outs[1] and outs[0]


def test_cuda_entry_points_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: device='cuda' runs there")
    zones = _zone_sets(PORT)["q1"]
    evs = _brussels_events(PORT, 20, 28)
    calls = [
        lambda: tcommon.contains_any_zone(zones, np.zeros((0, 2))),
        lambda: zones[0].contains_batch(np.zeros((4, 2))),
        lambda: tqueries._zone_filter([], zones, True),
        lambda: list(tqueries.q1_high_risk(iter(evs), zones)),
        lambda: list(tqueries.q2_brake_monitor(iter(evs), zones)),
        lambda: list(tqueries.q5_traj_speed_fence(iter(evs), zones)),
        lambda: tqueries.q2_brake_monitor_batch(evs, zones),
        lambda: tqueries.q1_window(evs, zones),
        lambda: tqueries.q2_window(evs, zones, 0, 1),
        lambda: tqueries.q5_window(evs, zones, 0, 1),
        lambda: list(tmobility.mn_q5(iter(evs), tmobility.Q5_FENCE, 0.001)),
        lambda: trunners.benchmark_runner("q3", 100, 1000),
        lambda: trunners.local_test_runner(),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="cuda"):
            call()
    # The numpy twin is the caller's explicit choice, never a fallback.
    assert tqueries.q1_window(evs, zones, backend="numpy") == \
        tqueries.q1_window(evs, zones, backend="device", device="cpu")


def test_device_keyword_follows_the_jax_parameters():
    import inspect

    for name in ("q1_high_risk", "q2_brake_monitor", "q5_traj_speed_fence",
                 "q2_brake_monitor_batch", "q1_window", "q2_window",
                 "q5_window", "_zone_filter"):
        t = list(inspect.signature(getattr(tqueries, name)).parameters)
        j = list(inspect.signature(getattr(jqueries, name)).parameters)
        assert t == j + ["device"], name
    for mod, jmod, name in ((tmobility, jmobility, "mn_q5"),
                            (tmobility, jmobility, "mobility_runner"),
                            (tmobility, jmobility, "main"),
                            (trunners, jrunners, "benchmark_runner"),
                            (trunners, jrunners, "local_test_runner"),
                            (trunners, jrunners, "mobility_query_runner"),
                            (tcommon, jcommon, "contains_any_zone")):
        t = list(inspect.signature(getattr(mod, name)).parameters)
        j = list(inspect.signature(getattr(jmod, name)).parameters)
        assert t == j + ["device"], name
    for name in ("q3_trajectory", "q4_trajectory_restricted"):
        assert "device" not in inspect.signature(
            getattr(tqueries, name)).parameters
    assert os.path.isdir(tcommon.RESOURCE_DIR)
