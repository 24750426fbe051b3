"""Parity of the port's kernel-level op counters (``ops/counters.py``)
with the JAX package's.

The same seeded streams go through a JAX operator with the JAX counters
enabled and through its port with the port's counters enabled, on the
CPU; the two snapshots must be equal, ``throughput_eps`` (a wall-clock
rate) left out. One case for each case of ``tests/test_counters.py``,
and one for each operator family that reports to the counters: the range,
kNN and join ``run`` and ``run_soa`` paths, the trajectory families'
``run_soa`` and ``soa_point_batches``' window meter. The port's tallies
are computed from host arrays (flags, cells, validity), as the JAX
package's; a disabled registry records nothing.
"""

import json
import re

import numpy as np
import pytest

from spatialflink_tpu import operators as jops
from spatialflink_tpu.grid import UniformGrid as JGrid
from spatialflink_tpu.mn.metrics import MetricRegistry as JRegistry
from spatialflink_tpu.mn.reporter import NESFileReporter as JReporter
from spatialflink_tpu.models.objects import Point as JPoint
from spatialflink_tpu.models.objects import Polygon as JPolygon
from spatialflink_tpu.ops import counters as joc
from spatialflink_tpu.sncb.metrics import MetricsSink as JSink

from spatialflink_tpu_torch import operators as tops
from spatialflink_tpu_torch.grid import UniformGrid
from spatialflink_tpu_torch.mn.metrics import MetricRegistry
from spatialflink_tpu_torch.mn.reporter import NESFileReporter
from spatialflink_tpu_torch.models.objects import Point, Polygon
from spatialflink_tpu_torch.ops import counters as toc
from spatialflink_tpu_torch.sncb.metrics import MetricsSink

JAX = dict(ops=jops, Grid=JGrid, Point=JPoint, Polygon=JPolygon, oc=joc,
           kw={}, dtype={"dtype": np.float32}, Registry=JRegistry,
           Reporter=JReporter, Sink=JSink)
PORT = dict(ops=tops, Grid=UniformGrid, Point=Point, Polygon=Polygon,
            oc=toc, kw={"device": "cpu"}, dtype={}, Registry=MetricRegistry,
            Reporter=NESFileReporter, Sink=MetricsSink)


@pytest.fixture(autouse=True)
def _counters_off():
    yield
    joc.disable()
    toc.disable()


def _grid(pkg):
    return pkg["Grid"](20, 0.0, 10.0, 0.0, 10.0)


def _conf(pkg, qt="WindowBased"):
    return pkg["ops"].QueryConfiguration(
        getattr(pkg["ops"].QueryType, qt), window_size=10, slide_step=10)


def _pts(pkg, seed, n, prefix="d"):
    rng = np.random.default_rng(seed)
    xy = rng.uniform(0, 10, (n, 2))
    return [pkg["Point"](obj_id=f"{prefix}{i % 5}",
                         timestamp=int(i * 20_000 / n),
                         x=float(xy[i, 0]), y=float(xy[i, 1]))
            for i in range(n)]


def _chunks(seed, n, n_ids=16):
    rng = np.random.default_rng(seed)
    arrays = {"ts": np.sort(rng.integers(0, 30_000, n)).astype(np.int64),
              "x": rng.uniform(0, 10, n), "y": rng.uniform(0, 10, n),
              "oid": rng.integers(0, n_ids, n).astype(np.int32)}
    step = max(1, n // 4)
    return [{k: v[i:i + step] for k, v in arrays.items()}
            for i in range(0, n, step)]


def _square(pkg, x, y, h):
    return pkg["Polygon"](rings=[np.array(
        [[x - h, y - h], [x + h, y - h], [x + h, y + h], [x - h, y + h],
         [x - h, y - h]])])


def _op(pkg, cls, qt="WindowBased"):
    return getattr(pkg["ops"], cls)(_conf(pkg, qt), _grid(pkg), **pkg["kw"])


def _snap(pkg):
    snap = pkg["oc"].counters.snapshot()
    assert snap.pop("throughput_eps") >= 0
    return snap


# -- the operator families ---------------------------------------------------


def _range_run(pkg):
    q = [pkg["Point"](x=5.0, y=5.0), pkg["Point"](x=2.0, y=2.0)]
    list(_op(pkg, "PointPointRangeQuery").run(iter(_pts(pkg, 1, 400)), q,
                                              0.5, **pkg["dtype"]))


def _range_run_polygon(pkg):
    q = [_square(pkg, 3.0, 3.0, 0.4), _square(pkg, 7.0, 6.0, 0.8)]
    list(_op(pkg, "PointPolygonRangeQuery").run(iter(_pts(pkg, 2, 400)), q,
                                                0.3, **pkg["dtype"]))


def _range_run_soa(pkg):
    q = [_square(pkg, 3.0, 3.0, 0.4), _square(pkg, 7.0, 6.0, 0.8)]
    list(_op(pkg, "PointPolygonRangeQuery").run_soa(_chunks(3, 600), q, 0.3,
                                                    **pkg["dtype"]))


def _knn_run(pkg):
    list(_op(pkg, "PointPointKNNQuery").run(
        iter(_pts(pkg, 4, 300)), pkg["Point"](x=5, y=5), 2.0, 5,
        **pkg["dtype"]))


def _knn_run_polygon(pkg):
    list(_op(pkg, "PointPolygonKNNQuery").run(
        iter(_pts(pkg, 5, 300)), _square(pkg, 5.0, 5.0, 1.0), 1.5, 5,
        **pkg["dtype"]))


def _knn_run_soa(pkg):
    list(_op(pkg, "PointPointKNNQuery").run_soa(
        _chunks(6, 600), pkg["Point"](x=5, y=5), 2.0, 5, 16,
        **pkg["dtype"]))


def _join_run(qt):
    def run(pkg):
        list(_op(pkg, "PointPointJoinQuery", qt).run(
            iter(_pts(pkg, 7, 300)), iter(_pts(pkg, 8, 200, prefix="q")),
            0.4, **pkg["dtype"]))
    return run


def _join_run_soa(pkg):
    list(_op(pkg, "PointPointJoinQuery").run_soa(
        _chunks(9, 800), _chunks(10, 600), 0.4, **pkg["dtype"]))


def _point_polygon_join_run_soa(pkg):
    rng = np.random.default_rng(11)
    n = 12
    cx, cy = rng.uniform(1, 9, n), rng.uniform(1, 9, n)
    geoms = {"ts": np.sort(rng.integers(0, 30_000, n)).astype(np.int64),
             "oid": np.arange(n, dtype=np.int32),
             "lengths": np.full(n, 5, np.int64),
             "verts": np.concatenate([
                 np.array([[x - .3, y - .3], [x + .3, y - .3],
                           [x + .3, y + .3], [x - .3, y + .3],
                           [x - .3, y - .3]]) for x, y in zip(cx, cy)])}
    list(_op(pkg, "PointPolygonJoinQuery").run_soa(
        _chunks(12, 500), [geoms], 0.2, **pkg["dtype"]))


def _tstats_run_soa(pkg):
    list(_op(pkg, "PointTStatsQuery").run_soa(_chunks(13, 700), 16,
                                              **pkg["dtype"]))


def _tfilter_run_soa(pkg):
    list(_op(pkg, "PointTFilterQuery").run_soa(_chunks(14, 700), [1, 3, 7]))


def _trange_run_soa(pkg):
    list(_op(pkg, "PointPolygonTRangeQuery").run_soa(
        _chunks(15, 600), [_square(pkg, 4.0, 4.0, 1.0)], 16, **pkg["dtype"]))


def _tknn_run_soa(pkg):
    list(_op(pkg, "PointPointTKNNQuery").run_soa(
        _chunks(16, 600), pkg["Point"](x=5, y=5), 2.0, 4, 16,
        **pkg["dtype"]))


def _tjoin_run_soa(pkg):
    list(_op(pkg, "PointPointTJoinQuery").run_soa(
        _chunks(17, 500), _chunks(18, 400), 0.3, 16, **pkg["dtype"]))


FAMILIES = {
    "range_run": _range_run,
    "range_run_polygon": _range_run_polygon,
    "range_run_soa": _range_run_soa,
    "knn_run": _knn_run,
    "knn_run_polygon": _knn_run_polygon,
    "knn_run_soa": _knn_run_soa,
    "join_run": _join_run("WindowBased"),
    "join_run_naive": _join_run("RealTimeNaive"),
    "join_run_soa": _join_run_soa,
    "point_polygon_join_run_soa": _point_polygon_join_run_soa,
    "tstats_run_soa": _tstats_run_soa,
    "tfilter_run_soa": _tfilter_run_soa,
    "trange_run_soa": _trange_run_soa,
    "tknn_run_soa": _tknn_run_soa,
    "tjoin_run_soa": _tjoin_run_soa,
}


@pytest.mark.parametrize("family", list(FAMILIES))
def test_family_tallies_equal_jax(family):
    snaps = []
    for pkg in (JAX, PORT):
        pkg["oc"].enable()
        FAMILIES[family](pkg)
        snaps.append(_snap(pkg))
        pkg["oc"].disable()
    assert snaps[0] == snaps[1]
    assert snaps[1]["windows"] > 0 and snaps[1]["points_in"] > 0


@pytest.mark.parametrize("family", ["range_run", "knn_run_soa",
                                    "join_run_soa", "tstats_run_soa"])
def test_disabled_family_records_nothing(family):
    toc.counters.reset()
    FAMILIES[family](PORT)
    assert _snap(PORT) == {"windows": 0, "points_in": 0,
                           "candidate_lanes": 0, "dist_computations": 0}


# -- the cases of tests/test_counters.py --------------------------------------


def _case_disabled(pkg, tmp_path):
    pkg["oc"].counters.reset()
    list(_op(pkg, "PointPointRangeQuery").run(
        iter(_pts(pkg, 42, 200)), [pkg["Point"](x=5, y=5)], 0.5,
        **pkg["dtype"]))
    return _snap(pkg)


def _case_range(pkg, tmp_path):
    pkg["oc"].enable()
    _range_run(pkg)
    return _snap(pkg)


def _case_knn_and_join(pkg, tmp_path):
    pkg["oc"].enable()
    _knn_run(pkg)
    knn = _snap(pkg)
    pkg["oc"].enable()
    _join_run("WindowBased")(pkg)
    return knn, _snap(pkg)


def _case_reporter(pkg, tmp_path):
    pkg["oc"].enable()
    _range_run(pkg)
    rep = pkg["Reporter"](pkg["Registry"](), query_id="t",
                          out_dir=str(tmp_path))
    line = rep.report(now=1_700_000_000.0)
    pkg["oc"].disable()
    line2 = rep.report(now=1_700_000_005.0)
    return line, line2


def _case_sink(pkg, tmp_path):
    pkg["oc"].enable()
    sink = pkg["Sink"]("t", path=str(tmp_path / "m.csv"), interval_s=0.0,
                       include_opcounters=True)
    pkg["oc"].counters.record_candidates(10, 42)
    sink.record(event_ts_ms=0)
    sink.close()
    rows = (tmp_path / "m.csv").read_text().strip().splitlines()
    # Column set and the distComp column; the timing columns vary.
    return sink.HEADER, [(len(r.split(",")), r.split(",")[-1])
                         for r in rows[1:]]


COUNTER_CASES = {
    "disabled_counts_nothing": _case_disabled,
    "range_counts_candidates": _case_range,
    "knn_and_join_count": _case_knn_and_join,
    "nes_reporter_appends_counters": _case_reporter,
    "metrics_sink_opcounter_column": _case_sink,
}


def _mask_rates(line):
    # The first report's interval runs from the reporter's construction:
    # its rates are wall-clock, the counter fields are not.
    return re.sub(r"(eps_in_avg|eps_out_avg|throughput_mb_s)=\S+",
                  r"\1=*", line)


@pytest.mark.parametrize("case", list(COUNTER_CASES))
def test_counters_case_equals_jax(case, tmp_path):
    got = COUNTER_CASES[case](PORT, tmp_path / "port")
    want = COUNTER_CASES[case](JAX, tmp_path / "jax")
    if case == "nes_reporter_appends_counters":
        got, want = ([_mask_rates(x) for x in v] for v in (got, want))
        assert "dist_comp_total=" in got[0] and \
            "candidate_lanes_total=" in got[0]
        assert "dist_comp_total" not in got[1]
    json.dumps(got)
    assert got == want


def test_snapshot_is_json_safe_for_numpy_tallies():
    kc = toc.KernelCounters(enabled=True)
    kc.record_window(np.int64(100), np.int32(40), np.int64(40))
    snap = kc.snapshot()
    json.dumps(snap)
    assert type(snap["candidate_lanes"]) is int


def test_count_helpers_equal_jax():
    rng = np.random.default_rng(19)
    flags = (rng.random(401) > 0.7).astype(np.int32)
    cells = rng.integers(0, 401, 500)
    assert toc.count_candidates(flags, cells, 450) == \
        joc.count_candidates(flags, cells, 450)
    lc = rng.integers(0, 401, 300)
    rc = rng.integers(0, 401, 250)
    for layers in (0, 1, 3):
        assert toc.count_join_candidates(
            _grid(PORT), lc, 280, rc, 240, layers) == \
            joc.count_join_candidates(_grid(JAX), lc, 280, rc, 240, layers)
