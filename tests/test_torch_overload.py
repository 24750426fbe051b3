"""Overload control in the port (``spatialflink_tpu_torch/overload.py``)
against the JAX package's (``spatialflink_tpu/overload.py``), on the CPU,
with ``tests/test_overload.py`` as the oracle.

Every scenario runs twice, once through each package (controller,
telemetry, SLO engine, driver and operators of the same package), on the
same event streams and policies made with numpy from a seed, and the two
runs are held equal: the ``snapshot()["overload"]`` block, ``state()``,
the sequence of transition instants (name and arguments, in order) and
whatever the scenario returns. The instants' timestamps are left out:
they are wall-clock readings.

One class for each of ``tests/test_overload.py``'s: policy parsing,
admission, lag shedding (with the deterministic schedule), the ladder
(``pick_capacity`` under the clamp and the ``pane_backend`` rung's
routing of both pane engines included), the circuit breaker, the driver
(kill mid-shed, the state in the checkpoint, a JAX checkpoint taken
mid-shed resumed by the port), the SLO budgets read by ``tools/sfprof``
from the port's ledger, ``batch_slides`` on the wire path at the JAX
test's shape, and the smoke. The JAX range operator's device path may
contract x² + y² into an FMA; the driver cases whose egress bytes are
compared with the JAX driver's run on a 1/64 lattice, where it cannot
round differently.
"""

import json
import os
import pickle
import subprocess
import sys
from types import SimpleNamespace

import numpy as np
import pytest

from spatialflink_tpu import driver as jdriver
from spatialflink_tpu import overload as jov
from spatialflink_tpu import slo as jslo
from spatialflink_tpu.faults import InjectedFault as JInjected
from spatialflink_tpu.faults import faults as jfaults
from spatialflink_tpu.grid import UniformGrid as JGrid
from spatialflink_tpu.models.objects import Point as JPoint
from spatialflink_tpu.operators import QueryConfiguration as JConf
from spatialflink_tpu.operators import QueryType as JQT
from spatialflink_tpu.operators.knn_query import PointPointKNNQuery as JKnn
from spatialflink_tpu.operators.range_query import (
    PointPointRangeQuery as JRangeQ,
)
from spatialflink_tpu.operators.trajectory import TStatsQuery as JTStats
from spatialflink_tpu.ops import compaction as jcomp
from spatialflink_tpu.streams import panes as jpanes
from spatialflink_tpu.streams.sinks import TransactionalFileSink as JSink
from spatialflink_tpu.streams.wire import WireFormat as JWireFormat
from spatialflink_tpu.telemetry import telemetry as jtel

from spatialflink_tpu_torch import driver as tdriver
from spatialflink_tpu_torch import overload as tov
from spatialflink_tpu_torch import slo as tslo
from spatialflink_tpu_torch.checkpoint import (
    load_checkpoint,
    operator_state,
    restore_operator,
    save_checkpoint,
)
from spatialflink_tpu_torch.faults import InjectedFault, faults
from spatialflink_tpu_torch.grid import UniformGrid
from spatialflink_tpu_torch.models.objects import Point
from spatialflink_tpu_torch.operators import (
    PointPointKNNQuery,
    PointPointRangeQuery,
    PointPointTJoinQuery,
    QueryConfiguration,
    QueryType,
    TStatsQuery,
)
from spatialflink_tpu_torch.ops import compaction as tcomp
from spatialflink_tpu_torch.state import load_jax_checkpoint
from spatialflink_tpu_torch.streams import panes as tpanes
from spatialflink_tpu_torch.streams.sinks import TransactionalFileSink
from spatialflink_tpu_torch.streams.wire import WireFormat
from spatialflink_tpu_torch.telemetry import telemetry

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

JAX = SimpleNamespace(
    name="jax", ov=jov, slo=jslo, tel=jtel, faults=jfaults, drv=jdriver,
    Injected=JInjected, Point=JPoint, Grid=JGrid, Conf=JConf, QT=JQT,
    Range=JRangeQ, TStats=JTStats, Sink=JSink, comp=jcomp, panes=jpanes,
    kw={"dtype": np.float32})
PORT = SimpleNamespace(
    name="port", ov=tov, slo=tslo, tel=telemetry, faults=faults,
    drv=tdriver, Injected=InjectedFault, Point=Point, Grid=UniformGrid,
    Conf=QueryConfiguration, QT=QueryType, Range=PointPointRangeQuery,
    TStats=TStatsQuery, Sink=TransactionalFileSink, comp=tcomp,
    panes=tpanes, kw={})


@pytest.fixture(autouse=True)
def _clean():
    """Every test leaves both packages' module slots empty, their fault
    injectors disarmed and their telemetry disabled and reset."""
    yield
    for pkg in (JAX, PORT):
        pkg.slo.uninstall()
        pkg.ov.uninstall()
        pkg.faults.disarm()
        pkg.tel.enable()
        pkg.tel.disable()


class _Ev:
    def __init__(self, ts):
        self.timestamp = int(ts)


TRANSITIONS = ("overload_", "slo_", "circuit_", "pipeline_")


def _instants(tel):
    """The transition instants in emission order, timestamps left out
    (compile and fault instants are the packages' own)."""
    return [(e["name"], e.get("args", {})) for e in tel.events
            if e.get("ph") == "i" and e["name"].startswith(TRANSITIONS)]


def _record(pkg, ctrl, **extra):
    return {"snapshot": ctrl.snapshot(), "state": ctrl.state(),
            "instants": _instants(pkg.tel), **extra}


def twin(scenario):
    """``scenario(pkg)`` through both packages; asserts the two records
    equal and returns the port's."""
    want = scenario(JAX)
    got = scenario(PORT)
    assert got == want
    return got


# ---------------------------------------------------------------------------
# Policy parsing


BAD_POLICIES = {
    "unknown_key": lambda m: m.OverloadPolicy.from_dict(
        {"max_bufferd_events": 8}),
    "unknown_action": lambda m: m.OverloadPolicy(ladder=[{"action": "turbo"}]),
    "unknown_rung_key": lambda m: m.OverloadPolicy(
        ladder=[{"action": "batch_slides", "N": 4}]),
    "rung_not_object": lambda m: m.OverloadPolicy(ladder=["batch_slides"]),
    "bad_target": lambda m: m.OverloadPolicy(
        ladder=[{"action": "pane_backend", "to": "devise"}]),
    "cap_str": lambda m: m.OverloadPolicy(
        ladder=[{"action": "clamp_compaction", "cap": "top"}]),
    "cap_negative": lambda m: m.OverloadPolicy(
        ladder=[{"action": "clamp_compaction", "cap": -1}]),
    "n_str": lambda m: m.OverloadPolicy(
        ladder=[{"action": "batch_slides", "n": "four"}]),
    "n_zero": lambda m: m.OverloadPolicy(
        ladder=[{"action": "batch_slides", "n": 0}]),
    "version": lambda m: m.OverloadPolicy.from_dict({"overload_version": 99}),
    "tenant_key": lambda m: m.OverloadPolicy(
        tenant_budgets={"a": {"max_query": 1}}),
    "tenant_bool": lambda m: m.OverloadPolicy(
        tenant_budgets={"a": {"max_queries": True}}),
    "tenant_not_map": lambda m: m.OverloadPolicy(tenant_budgets=[1]),
}


class TestPolicy:
    @pytest.mark.parametrize("case", sorted(BAD_POLICIES))
    def test_strict_parse_raises_as_the_jax(self, case):
        with pytest.raises(ValueError) as je:
            BAD_POLICIES[case](jov)
        with pytest.raises(ValueError) as te:
            BAD_POLICIES[case](tov)
        assert str(te.value) == str(je.value)

    def test_dict_roundtrip_and_env_forms(self, tmp_path):
        kw = dict(max_buffered_events=8, lag_shed_ceiling_ms=500,
                  ladder=[{"action": "clamp_compaction"}],
                  tenant_budgets={"bulk": {"max_queries": 2}})
        p = tov.OverloadPolicy(**kw)
        assert p.to_dict() == jov.OverloadPolicy(**kw).to_dict()
        assert tov.OverloadPolicy.from_dict(p.to_dict()) == p
        assert tov.OverloadPolicy.from_env(json.dumps(p.to_dict())) == p
        f = tmp_path / "policy.json"
        f.write_text(json.dumps(jov.OverloadPolicy(**kw).to_dict()))
        assert tov.OverloadPolicy.from_env(str(f)) == p

    def test_module_constants_equal_the_jax(self):
        assert tov.OVERLOAD_VERSION == jov.OVERLOAD_VERSION
        assert tov.RUNG_ACTIONS == jov.RUNG_ACTIONS
        assert tov._RUNG_KEYS == jov._RUNG_KEYS
        assert tov.TENANT_BUDGET_KEYS == jov.TENANT_BUDGET_KEYS


# ---------------------------------------------------------------------------
# Bounded admission


def _admission(kind):
    def scenario(pkg):
        pkg.tel.enable()
        if kind == "non_pausable":
            c = pkg.ov.OverloadController(pkg.ov.OverloadPolicy(
                max_buffered_events=3, admission_window_ms=10_000))
            verdicts = [c.admit_item(_Ev(t), pausable=False)
                        for t in range(0, 80, 10)]
        elif kind == "pausable":
            c = pkg.ov.OverloadController(pkg.ov.OverloadPolicy(
                max_buffered_events=3))
            verdicts = [c.admit_item(_Ev(t), pausable=True)
                        for t in range(0, 80, 10)]
            c.on_window_fired(3, lag_ms=0.0, end=1000)
        elif kind == "horizon":
            c = pkg.ov.OverloadController(pkg.ov.OverloadPolicy(
                max_buffered_events=2, admission_window_ms=1000))
            verdicts = [c.admit_item(_Ev(t), pausable=False)
                        for t in (0, 10, 20, 2000)]
        else:  # SoA chunks, measured by arrays and bytes
            c = pkg.ov.OverloadController(pkg.ov.OverloadPolicy(
                max_buffered_bytes=100, admission_window_ms=10_000))
            chunk = {"ts": np.arange(4, dtype=np.int64),
                     "x": np.zeros(4), "y": np.zeros(4)}
            verdicts = [c.admit_item(chunk, pausable=False)
                        for _ in range(2)]
        return _record(pkg, c, verdicts=verdicts)
    return scenario


class TestAdmission:
    def test_non_pausable_sheds_beyond_budget(self):
        rec = twin(_admission("non_pausable"))
        assert rec["verdicts"] == [True] * 3 + [False] * 5
        assert rec["snapshot"]["shed"]["admission"]["events"] == 5
        names = [n for n, _ in rec["instants"]]
        assert names.count("overload_shedding:admission") == 1

    def test_pausable_backpressures_instead_of_shedding(self):
        rec = twin(_admission("pausable"))
        assert all(rec["verdicts"])
        assert rec["snapshot"]["shed_total"] == 0
        assert rec["snapshot"]["backpressure_engaged"] == 1
        names = [n for n, _ in rec["instants"]]
        assert names == ["overload_backpressure:engaged",
                         "overload_backpressure:released"]

    def test_event_time_horizon_resets_the_burst(self):
        rec = twin(_admission("horizon"))
        assert rec["verdicts"] == [True, True, False, True]
        assert rec["snapshot"]["shed_total"] == 1

    def test_chunks_measured_by_arrays_and_bytes(self):
        rec = twin(_admission("chunks"))
        assert rec["verdicts"] == [True, False]
        shed = rec["snapshot"]["shed"]["admission"]
        assert shed["events"] == 4 and shed["bytes"] == 96

    def test_control_plane_items_are_never_load(self):
        def scenario(pkg):
            c = pkg.ov.OverloadController(pkg.ov.OverloadPolicy(
                max_buffered_events=0))
            cmd = SimpleNamespace(control_plane=True, timestamp=5)
            return _record(pkg, c, v=[c.admit_item(cmd, pausable=False),
                                      c.admit_item(object(), pausable=False)])
        assert twin(scenario)["v"] == [True, False]


# ---------------------------------------------------------------------------
# Watermark-aware shedding


def _lag_controller(pkg, **kw):
    kw.setdefault("lag_shed_ceiling_ms", 1000)
    kw.setdefault("lag_recover_ms", 100)
    kw.setdefault("shed_oldest_after_windows", 2)
    return pkg.ov.OverloadController(pkg.ov.OverloadPolicy(**kw))


class TestLagShedding:
    def test_lag_ceiling_enters_shed_mode_late_first(self):
        def scenario(pkg):
            pkg.tel.enable()
            c = _lag_controller(pkg)
            c.admit_item(_Ev(5000), pausable=False)
            c.on_window_fired(5, lag_ms=4000.0, end=1000)
            v = [c.admit_item(_Ev(1200), pausable=False),
                 c.admit_item(_Ev(6000), pausable=False)]
            return _record(pkg, c, v=v)

        rec = twin(scenario)
        assert rec["v"] == [False, True]
        assert rec["snapshot"]["shed"]["late"]["events"] == 1
        assert rec["instants"][0][0] == "overload_shedding:lag"

    def test_escalates_to_oldest_then_recovers(self):
        def scenario(pkg):
            pkg.tel.enable()
            c = _lag_controller(pkg)
            c.admit_item(_Ev(5000), pausable=False)
            for end in (1000, 2000, 3000):
                c.on_window_fired(5, lag_ms=4000.0, end=end)
            v = [c.admit_item(_Ev(2500), pausable=False)]
            c.on_window_fired(5, lag_ms=50.0, end=4000)
            v.append(c.admit_item(_Ev(3500), pausable=False))
            return _record(pkg, c, v=v)

        rec = twin(scenario)
        assert rec["v"] == [False, True]
        assert rec["snapshot"]["shed"]["oldest"]["events"] == 1
        assert rec["snapshot"]["shedding"] is False
        assert [n for n, _ in rec["instants"]] == [
            "overload_shedding:lag", "overload_shedding:oldest",
            "overload_recovered:lag"]

    @pytest.mark.parametrize("seed", [3, 4, 5])
    def test_shed_schedule_is_deterministic(self, seed):
        """Same stream, same sheds, run to run and package to package:
        the premise of a byte-identical resume."""
        def scenario(pkg):
            pkg.tel.enable()
            c = _lag_controller(pkg, max_buffered_events=4,
                                admission_window_ms=500)
            rng = np.random.default_rng(seed)
            verdicts = []
            for i in range(300):
                ts = int(rng.integers(0, 20_000))
                verdicts.append(c.admit_item(_Ev(ts), pausable=False))
                if i % 7 == 0:
                    c.on_window_fired(3, lag_ms=float(ts % 3000),
                                      end=ts - (ts % 1000))
            return _record(pkg, c, verdicts=verdicts)

        first = twin(scenario)
        assert scenario(PORT) == first
        assert first["snapshot"]["shed_total"] > 0


# ---------------------------------------------------------------------------
# Degradation ladder


LADDER = (
    {"action": "clamp_compaction", "cap": 32},
    {"action": "batch_slides", "n": 3},
    {"action": "pane_backend", "to": "native"},
)


def _effects(pkg):
    return (pkg.ov.compaction_clamp(), pkg.ov.batch_slides(),
            pkg.ov.pane_backend())


class TestLadder:
    def test_steps_down_apply_cumulative_effects(self):
        def scenario(pkg):
            pkg.tel.enable()
            c = pkg.ov.install(pkg.ov.OverloadController(pkg.ov.OverloadPolicy(
                ladder=LADDER, degrade_cooldown=1, recover_after=2)))
            eff = [_effects(pkg)]
            for _ in range(3):
                c.on_slo_evaluation(False)
                eff.append(_effects(pkg))
            return _record(pkg, c, eff=eff)

        rec = twin(scenario)
        assert rec["eff"] == [(None, 1, None), (32, 1, None), (32, 3, None),
                              (32, 3, "native")]
        assert [n for n, _ in rec["instants"]] == [
            "overload_rung_down:clamp_compaction",
            "overload_rung_down:batch_slides",
            "overload_rung_down:pane_backend"]

    def test_sustained_recovery_steps_back_up(self):
        def scenario(pkg):
            pkg.tel.enable()
            c = pkg.ov.install(pkg.ov.OverloadController(pkg.ov.OverloadPolicy(
                ladder=LADDER, degrade_cooldown=1, recover_after=2)))
            c.on_slo_evaluation(False)
            c.on_slo_evaluation(False)
            for _ in range(4):
                c.on_window_fired(5, lag_ms=0.0, end=1000)
            return _record(pkg, c, eff=_effects(pkg))

        rec = twin(scenario)
        assert rec["snapshot"]["rung"] == 0
        assert rec["eff"] == (None, 1, None)
        assert [n for n, _ in rec["instants"]][-2:] == [
            "overload_rung_up:batch_slides",
            "overload_rung_up:clamp_compaction"]

    def test_midband_lag_is_neutral_for_the_ladder(self):
        def scenario(pkg):
            c = pkg.ov.install(pkg.ov.OverloadController(pkg.ov.OverloadPolicy(
                lag_shed_ceiling_ms=5_000, lag_recover_ms=2_500,
                ladder=({"action": "batch_slides", "n": 2},),
                degrade_cooldown=1, recover_after=2)))
            rungs = []
            for lag, n in ((3_000.0, 6), (None, 0), (3_000.0, 4),
                           (1_000.0, 2)):
                if lag is None:
                    c.on_slo_evaluation(False)
                for _ in range(n):
                    c.on_window_fired(1, lag_ms=lag)
                rungs.append(c.rung)
            return _record(pkg, c, rungs=rungs)

        assert twin(scenario)["rungs"] == [0, 1, 1, 0]

    @pytest.mark.parametrize("pausable", [False, True],
                             ids=["shedding", "backpressure"])
    def test_sustained_distress_holds_the_rung_down(self, pausable):
        def scenario(pkg):
            c = pkg.ov.install(pkg.ov.OverloadController(pkg.ov.OverloadPolicy(
                max_buffered_events=2, admission_window_ms=10_000,
                ladder=({"action": "clamp_compaction", "cap": 0},),
                degrade_cooldown=1, recover_after=3)))
            c.on_slo_evaluation(False)
            rungs = []
            for cycle in range(6):
                for i in range(5):
                    c.admit_item(_Ev(cycle * 100 + i), pausable=pausable)
                c.on_window_fired(5, lag_ms=0.0, end=cycle * 100)
                rungs.append(c.rung)
            for cycle in range(6, 9):
                c.on_window_fired(1, lag_ms=0.0, end=cycle * 100)
            return _record(pkg, c, rungs=rungs, final=c.rung)

        rec = twin(scenario)
        assert rec["rungs"] == [1] * 6 and rec["final"] == 0
        assert (rec["snapshot"]["shed_total"] > 0) is not pausable

    def test_live_slo_violation_drives_the_ladder(self):
        def scenario(pkg):
            pkg.tel.enable()
            c = pkg.ov.install(pkg.ov.OverloadController(pkg.ov.OverloadPolicy(
                ladder=LADDER, degrade_cooldown=1)))
            eng = pkg.slo.install(pkg.slo.SloEngine(pkg.slo.SloSpec(
                late_drop_budget=0, eval_interval_s=0.0)))
            pkg.tel.record_late_drop(3)
            eng.evaluate()
            return _record(pkg, c)

        rec = twin(scenario)
        assert rec["snapshot"]["rung"] == 1
        assert [n for n, _ in rec["instants"]] == [
            "slo_violation:late_drop_budget",
            "overload_rung_down:clamp_compaction"]

    @pytest.mark.parametrize("clamp", [None, 0, 8, 32, 100])
    def test_pick_capacity_honors_the_clamp(self, clamp):
        got = {}
        for pkg in (JAX, PORT):
            if clamp is not None:
                pkg.ov.install(pkg.ov.OverloadController(pkg.ov.OverloadPolicy(
                    ladder=({"action": "clamp_compaction", "cap": clamp},),
                    degrade_cooldown=1))).on_slo_evaluation(False)
            got[pkg.name] = [pkg.comp.pick_capacity(live, cap)
                             for cap in (4, 48, 64, 256)
                             for live in (0, 3, 9, 31, 33, 60, 64, 300)]
        assert got["port"] == got["jax"]
        if clamp == 32:
            assert tcomp.pick_capacity(3, 64) == 32
            assert tcomp.pick_capacity(60, 64) == 64
        if clamp == 0:
            assert tcomp.pick_capacity(3, 64) == 64

    @pytest.mark.parametrize("to", ["native", "numpy"])
    def test_traj_stats_auto_backend_biased_host(self, to, monkeypatch):
        """Under the rung (either target) "auto" takes the host engines
        in the JAX order: the native engine (a spy counts its calls),
        never the device engine, and a forced backend is never
        overridden. Windows equal the JAX numpy engine's."""
        from spatialflink_tpu_torch import native as tnative

        tov.install(tov.OverloadController(tov.OverloadPolicy(
            ladder=({"action": "pane_backend", "to": to},),
            degrade_cooldown=1))).on_slo_evaluation(False)
        rng = np.random.default_rng(9)
        ts = np.sort(rng.integers(0, 4000, 60)).astype(np.int64)
        xy = rng.uniform(0, 1, (60, 2))
        oid = rng.integers(0, 3, 60).astype(np.int64)
        args = (ts, xy, oid, 3, 1000, 500)
        taken = []
        real = tpanes._traj_stats_sliding_device
        real_native = tnative.traj_stats_native

        def spy(*a, **k):
            taken.append("device")
            return real(*a, **k)

        def native_spy(*a, **k):
            taken.append("native")
            return real_native(*a, **k)

        monkeypatch.setattr(tpanes, "_traj_stats_sliding_device", spy)
        monkeypatch.setattr(tnative, "traj_stats_native", native_spy)
        a = tpanes.traj_stats_sliding(*args, backend="auto", device="cpu")
        assert taken == ["native"]
        tpanes.traj_stats_sliding(*args, backend="device", device="cpu")
        assert taken == ["native", "device"]
        b = jpanes.traj_stats_sliding(*args, backend="numpy")
        np.testing.assert_array_equal(a.starts, b.starts)
        np.testing.assert_array_equal(a.count, b.count)
        np.testing.assert_array_equal(a.spatial, b.spatial)
        np.testing.assert_array_equal(a.temporal, b.temporal)

    def test_tjoin_panes_auto_keeps_the_device_engine_under_the_rung(
            self, monkeypatch):
        """Under a "native" rung "auto" runs the native engine (a spy
        counts its calls; the device engine does not scan), and its
        windows equal the device engine's: the same pairs in the same
        order, the float64 minima within the device engine's float32
        error (``test_torch_native.F32_DISTANCE_RTOL``). With the native library unavailable the
        rung keeps the device engine (the JAX operator without its
        library): a rung never becomes a crash."""
        from test_torch_native import F32_DISTANCE_RTOL

        from spatialflink_tpu_torch import native as tnative

        def run(backend="auto"):
            op = PointPointTJoinQuery(
                QueryConfiguration(window_size=1.0, slide_step=0.5),
                UniformGrid(8, 0.0, 8.0, 0.0, 8.0), device="cpu")
            rng = np.random.default_rng(4)
            side = [{"ts": np.sort(rng.integers(0, 3000, 40)).astype(
                np.int64), "x": rng.uniform(0, 8, 40),
                "y": rng.uniform(0, 8, 40),
                "oid": rng.integers(0, 4, 40).astype(np.int32)}]
            out = list(op.run_soa_panes(side, side, 1.0, 4,
                                        backend=backend))
            return out, op.pane_scans

        base, base_scans = run("device")
        assert base_scans
        tov.install(tov.OverloadController(tov.OverloadPolicy(
            ladder=({"action": "pane_backend", "to": "native"},),
            degrade_cooldown=1))).on_slo_evaluation(False)
        assert tov.pane_backend() == "native"
        calls = []
        real = tnative.tjoin_panes_native

        def spy(*a, **k):
            calls.append(1)
            return real(*a, **k)

        monkeypatch.setattr(tnative, "tjoin_panes_native", spy)
        got, scans = run()
        assert calls == [1] and scans == []
        assert len(got) == len(base) > 0 and sum(w[5] for w in got) > 0
        for a, b in zip(base, got):
            assert a[:2] == b[:2] and a[5:] == b[5:]
            np.testing.assert_array_equal(a[2], b[2])
            np.testing.assert_array_equal(a[3], b[3])
            assert np.all(np.abs(b[4] - a[4]) <= F32_DISTANCE_RTOL * b[4])
        monkeypatch.setattr(tnative, "available", lambda: False)
        kept, kept_scans = run()
        assert kept_scans and len(calls) == 1
        for a, b in zip(base, kept):
            for x, y in zip(a, b):
                np.testing.assert_array_equal(x, y)


# ---------------------------------------------------------------------------
# Circuit breaker


def _run_range(pkg, driver=None, n_events=120):
    grid, conf, source, query = pkg.drv._toy_pipeline(n_events=n_events)
    kw = dict(pkg.kw)
    if pkg is PORT:
        op = pkg.Range(conf, grid, device="cpu")
    else:
        op = pkg.Range(conf, grid)
    return list(op.run(source(), [query], 1.5, driver=driver, **kw))


def _same_range_windows(a, b, exact=True):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert (x.start, x.end) == (y.start, y.end)
        assert [p.obj_id for p in x.objects] == [p.obj_id for p in y.objects]
        if exact:
            np.testing.assert_array_equal(np.asarray(x.dists),
                                          np.asarray(y.dists))
        else:
            np.testing.assert_allclose(np.asarray(x.dists),
                                       np.asarray(y.dists), rtol=3e-7)


def _circuit(pkg, instants_prefix="circuit_"):
    return [(n, a) for n, a in _instants(pkg.tel)
            if n.startswith(instants_prefix)]


class TestCircuitBreaker:
    def test_open_fallback_probe_close_round_trip(self):
        def scenario(pkg):
            pkg.tel.enable()
            base = _run_range(pkg)
            ctrl = pkg.ov.OverloadController(pkg.ov.OverloadPolicy(
                breaker_failures=2, breaker_probe_every=3))
            drv = pkg.drv.WindowedDataflowDriver(
                retry=pkg.drv.RetryPolicy(max_retries=0, backoff_s=0.0),
                overload=ctrl)
            pkg.faults.arm([{"point": "driver.window", "at": 1, "times": 2}])
            driven = _run_range(pkg, driver=drv)
            pkg.faults.disarm()
            _same_range_windows(base, driven, exact=pkg is PORT)
            return {"snapshot": ctrl.snapshot(), "state": ctrl.state(),
                    "circuit": [n for n, _ in _circuit(pkg)],
                    "backend": drv.backend, "stats": drv.stats,
                    "windows": len(driven)}

        rec = twin(scenario)
        assert rec["snapshot"]["breaker"] == {
            "state": "closed", "opens": 1, "probes": 1,
            "consecutive_failures": 0}
        assert rec["backend"] == "device" and rec["stats"]["failovers"] == 0
        assert rec["snapshot"]["degraded_windows"] == 4
        assert rec["circuit"] == ["circuit_open", "circuit_half_open",
                                  "circuit_closed"]
        assert rec["windows"] > 5

    def test_probe_failure_reopens(self):
        def scenario(pkg):
            pkg.tel.enable()
            ctrl = pkg.ov.OverloadController(pkg.ov.OverloadPolicy(
                breaker_failures=1, breaker_probe_every=2))
            drv = pkg.drv.WindowedDataflowDriver(
                retry=pkg.drv.RetryPolicy(max_retries=0, backoff_s=0.0),
                overload=ctrl)
            pkg.faults.arm([{"point": "driver.window", "at": 1,
                             "times": 10_000}])
            driven = _run_range(pkg, driver=drv)
            pkg.faults.disarm()
            return {"snapshot": ctrl.snapshot(), "windows": len(driven),
                    "circuit": _circuit(pkg)}

        rec = twin(scenario)
        assert rec["snapshot"]["breaker"]["state"] == "open"
        assert rec["snapshot"]["breaker"]["probes"] >= 2
        assert rec["windows"] > 5
        assert [n for n, _ in rec["circuit"][:3]] == [
            "circuit_open", "circuit_half_open", "circuit_open"]
        assert rec["circuit"][2][1]["reason"] == "probe failed"

    def test_link_degraded_ratio_opens_preemptively(self):
        def scenario(pkg):
            pkg.tel.enable()
            ctrl = pkg.ov.OverloadController(pkg.ov.OverloadPolicy(
                breaker_failures=9, breaker_link_ratio=0.5))
            for mbps in (100.0, 100.0, 100.0, 10.0):
                pkg.tel.record_link_sample(1.0, mbps, 1 << 18)
            return {"route": ctrl.breaker.route(),
                    "snapshot": ctrl.snapshot(), "circuit": _circuit(pkg)}

        rec = twin(scenario)
        assert rec["route"] == "fallback"
        assert rec["snapshot"]["breaker"]["state"] == "open"
        assert rec["circuit"][0][1]["reason"] == \
            "link degraded (ratio 0.100 < 0.5)"

    def test_probe_close_not_reopened_by_stale_link_gauges(self):
        def scenario(pkg):
            pkg.tel.enable()
            ctrl = pkg.ov.OverloadController(pkg.ov.OverloadPolicy(
                breaker_link_ratio=0.5, breaker_probe_every=1))
            for mbps in (100.0, 100.0, 100.0, 10.0):
                pkg.tel.record_link_sample(1.0, mbps, 1 << 18)
            br = ctrl.breaker
            routes = [br.route(), br.route()]
            br.record_success()
            routes.append(br.route())
            pkg.tel.record_link_sample(1.0, 5.0, 1 << 18)
            routes.append(br.route())
            return {"routes": routes, "snapshot": ctrl.snapshot(),
                    "circuit": _circuit(pkg)}

        rec = twin(scenario)
        assert rec["routes"] == ["fallback", "probe", "device", "fallback"]
        assert rec["snapshot"]["breaker"]["opens"] == 2

    def test_link_only_policy_ignores_failure_counts(self):
        def scenario(pkg):
            ctrl = pkg.ov.OverloadController(pkg.ov.OverloadPolicy(
                breaker_link_ratio=0.5))
            for _ in range(5):
                ctrl.breaker.record_failure(window_start=0, error="boom")
            return ctrl.snapshot()

        snap = twin(scenario)
        assert snap["breaker"]["state"] == "closed"
        assert snap["breaker"]["opens"] == 0

    def test_without_breaker_permanent_failover_is_preserved(self):
        def scenario(pkg):
            ctrl = pkg.ov.OverloadController(pkg.ov.OverloadPolicy())
            assert ctrl.breaker is None
            drv = pkg.drv.WindowedDataflowDriver(
                retry=pkg.drv.RetryPolicy(max_retries=0, backoff_s=0.0),
                overload=ctrl)
            pkg.faults.arm([{"point": "driver.window", "at": 1,
                             "times": 10_000}])
            driven = _run_range(pkg, driver=drv)
            pkg.faults.disarm()
            return {"snapshot": ctrl.snapshot(), "backend": drv.backend,
                    "failovers": drv.stats["failovers"],
                    "windows": len(driven)}

        rec = twin(scenario)
        assert rec["backend"] == "fallback" and rec["failovers"] == 1
        assert rec["snapshot"]["degraded_windows"] == rec["windows"]

    def test_open_circuit_collapses_the_pipelined_driver(self):
        """While the circuit is open ``breaker_collapsed()`` is true and
        the pipelined driver runs at the synchronous cadence; after the
        probe closes it the overlap resumes. Windows equal the clean
        synchronous run. The pipelined dispatch is not the
        ``driver.window`` point: ``pipeline.ship`` fails the first two
        dispatches, whose synchronous reruns ``driver.window`` fails."""
        from spatialflink_tpu_torch import pipeline as tpipeline

        base = _run_range(PORT)
        telemetry.enable()
        ctrl = tov.OverloadController(tov.OverloadPolicy(
            breaker_failures=2, breaker_probe_every=3))
        seen = []
        drv = tdriver.WindowedDataflowDriver(
            retry=tdriver.RetryPolicy(max_retries=0, backoff_s=0.0),
            overload=ctrl,
            pipeline=tpipeline.PipelinePolicy(depth=2, fetch_lag=1))
        faults.arm([{"point": "pipeline.ship", "at": 1, "times": 2},
                    {"point": "driver.window", "at": 1, "times": 2}])
        grid, conf, source, query = tdriver._toy_pipeline()
        op = PointPointRangeQuery(conf, grid, device="cpu")
        driven = []
        for res in op.run(source(), [query], 1.5, driver=drv):
            seen.append(tpipeline.breaker_collapsed())
            driven.append(res)
        faults.disarm()
        _same_range_windows(base, driven)
        names = [n for n, _ in _instants(telemetry)]
        assert "pipeline_collapsed" in names and "pipeline_resumed" in names
        assert names.index("circuit_open") < names.index(
            "pipeline_collapsed") < names.index("circuit_closed") < \
            names.index("pipeline_resumed")
        assert True in seen and seen[-1] is False
        pipe = telemetry.snapshot()["pipeline"]
        assert pipe["collapses"] == 1 and pipe["resumes"] == 1
        assert pipe["overlapped"] > 0 and pipe["sync"] > 0
        assert ctrl.snapshot()["degraded_windows"] == 4


# ---------------------------------------------------------------------------
# Driver integration: admission and checkpointed shed determinism


def _lattice(pkg, n=120):
    """The toy stream's shape on a 1/64 lattice (x² + y² exact in
    float32: the JAX device path's FMA cannot round differently)."""
    rng = np.random.default_rng(7)
    xs = rng.integers(0, 512, n) / 64.0
    ys = rng.integers(0, 512, n) / 64.0
    return [pkg.Point(obj_id=f"o{i % 13}", timestamp=100 * i, x=float(xs[i]),
                      y=float(ys[i])) for i in range(n)]


def _shedding_pipeline(pkg, workdir, fault_plan=None):
    """Range pipeline under a tiny admission budget over a non-pausable
    source: the sheds are part of the committed stream position."""
    grid, conf, _, query = pkg.drv._toy_pipeline()
    sink = pkg.Sink(os.path.join(workdir, "egress.csv"))
    ctrl = pkg.ov.OverloadController(pkg.ov.OverloadPolicy(
        max_buffered_events=3, admission_window_ms=500))
    driver = pkg.drv.WindowedDataflowDriver(
        checkpoint_path=os.path.join(workdir, "ckpt.bin"),
        checkpoint_every=1, sink=sink,
        retry=pkg.drv.RetryPolicy(max_retries=1, backoff_s=0.0),
        failover=False, overload=ctrl, source_pausable=False,
    )
    op = pkg.Range(conf, grid, device="cpu") if pkg is PORT \
        else pkg.Range(conf, grid)
    if fault_plan:
        pkg.faults.arm(fault_plan)
    try:
        for res in op.run(iter(_lattice(pkg)), [query], 1.5, driver=driver,
                          **pkg.kw):
            for line in pkg.drv.render_range_result(res):
                sink.stage(line)
    finally:
        pkg.faults.disarm()
    return driver, ctrl


@pytest.fixture(scope="module")
def jax_shed_run(tmp_path_factory):
    d = tmp_path_factory.mktemp("jax_shed")
    drv, ctrl = _shedding_pipeline(JAX, str(d))
    ck = load_jax_checkpoint(str(d / "ckpt.bin"))
    return ((d / "egress.csv").read_bytes(), ctrl.snapshot(), ctrl.state(),
            drv.stats, ck)


KILL_MID_SHED = [{"point": "overload.admit", "at": 40, "times": 10_000}]


class TestDriverIntegration:
    def test_no_budget_controller_changes_nothing(self):
        base = _run_range(PORT)

        def scenario(pkg):
            ctrl = pkg.ov.OverloadController(pkg.ov.OverloadPolicy())
            driven = _run_range(pkg, driver=pkg.drv.WindowedDataflowDriver(
                overload=ctrl))
            if pkg is PORT:
                _same_range_windows(base, driven)
            return ctrl.snapshot()

        assert twin(scenario)["shed_total"] == 0

    def test_sheds_equal_the_jax_and_survive_kill_mid_shed(
            self, tmp_path, jax_shed_run):
        want, jsnap, jstate, jstats, _ = jax_shed_run
        clean, chaos = tmp_path / "clean", tmp_path / "chaos"
        clean.mkdir()
        chaos.mkdir()
        drv, ctrl = _shedding_pipeline(PORT, str(clean))
        assert (clean / "egress.csv").read_bytes() == want
        assert ctrl.snapshot() == jsnap and ctrl.state() == jstate
        assert ctrl.shed_total > 0, "vacuous: nothing shed"
        assert drv.stats == jstats
        with pytest.raises(InjectedFault):
            _shedding_pipeline(PORT, str(chaos), fault_plan=KILL_MID_SHED)
        drv2, ctrl2 = _shedding_pipeline(PORT, str(chaos))
        assert drv2.stats["resumed"] is True
        assert (chaos / "egress.csv").read_bytes() == want
        assert ctrl2.snapshot()["shed"] == jsnap["shed"]

    def test_overload_state_rides_the_checkpoint_byte_for_byte(
            self, tmp_path, jax_shed_run):
        _, _, _, _, jck_ = jax_shed_run
        _, ctrl = _shedding_pipeline(PORT, str(tmp_path))
        ck = load_checkpoint(str(tmp_path / "ckpt.bin"))
        assert ck["overload"]["shed"] == ctrl.snapshot()["shed"]
        assert pickle.dumps(ck["overload"], pickle.HIGHEST_PROTOCOL) == \
            pickle.dumps(jck_["overload"], pickle.HIGHEST_PROTOCOL)
        assert set(ck) == set(jck_)

    def test_jax_checkpoint_taken_mid_shed_resumes_in_the_port(
            self, tmp_path, jax_shed_run):
        want, jsnap, _, _, _ = jax_shed_run
        with pytest.raises(JInjected):
            _shedding_pipeline(JAX, str(tmp_path), fault_plan=KILL_MID_SHED)
        torn = (tmp_path / "egress.csv").read_bytes()
        assert 0 < len(torn) < len(want)
        path = str(tmp_path / "ckpt.bin")
        comps = load_jax_checkpoint(path)
        assert comps["overload"]["shed"]["admission"]["events"] > 0
        save_checkpoint(path, **comps)  # now the port's
        drv, ctrl = _shedding_pipeline(PORT, str(tmp_path))
        assert drv.stats["resumed"] is True
        assert (tmp_path / "egress.csv").read_bytes() == want
        assert ctrl.snapshot() == jsnap

    def test_driver_restores_a_preinstalled_controller(self):
        def scenario(pkg):
            g = pkg.ov.install(pkg.ov.OverloadController(
                pkg.ov.OverloadPolicy()))
            _run_range(pkg, driver=pkg.drv.WindowedDataflowDriver(
                overload=pkg.ov.OverloadController(pkg.ov.OverloadPolicy())))
            return pkg.ov.controller() is g

        assert twin(scenario) is True

    def test_run_windows_installs_the_controller_too(self):
        def scenario(pkg):
            c = pkg.ov.OverloadController(pkg.ov.OverloadPolicy())
            drv = pkg.drv.WindowedDataflowDriver(overload=c)
            drv.op = object()
            drv.process = lambda w: w
            seen = [pkg.ov.controller() is c
                    for _ in drv.run_windows(iter([1, 2]))]
            return seen + [pkg.ov.controller() is c]

        assert twin(scenario) == [True, True, True]

    def test_precomputed_windows_are_never_admitted(self):
        """``run_precomputed`` items are fired windows: a zero budget
        sheds none of them."""
        ctrl = tov.OverloadController(tov.OverloadPolicy(
            max_buffered_events=0))
        drv = tdriver.WindowedDataflowDriver(overload=ctrl,
                                             source_pausable=False)
        drv.op = object()
        drv.process = lambda w: w
        wins = [_Ev(t) for t in (1, 2, 3)]
        assert list(drv.run_precomputed(iter(wins))) == wins
        assert ctrl.shed_total == 0

    def test_source_pausable_follows_skip_on_resume(self):
        for kw, want in (({}, True), ({"skip_on_resume": False}, False),
                         ({"source_pausable": False}, False)):
            assert tdriver.WindowedDataflowDriver(**kw).source_pausable \
                is want
            assert jdriver.WindowedDataflowDriver(**kw).source_pausable \
                is want


# ---------------------------------------------------------------------------
# SLO budgets: the live engine, and the JAX package's post-hoc tools on
# the port's ledger


class TestSloBudgets:
    def test_live_shed_budget_reads_the_controller(self):
        def scenario(pkg):
            pkg.tel.enable()
            ctrl = pkg.ov.install(pkg.ov.OverloadController(
                pkg.ov.OverloadPolicy(max_buffered_events=1,
                                      admission_window_ms=10_000)))
            for t in range(5):
                ctrl.admit_item(_Ev(t), pausable=False)
            eng = pkg.slo.SloEngine(pkg.slo.SloSpec(
                shed_budget=2, degraded_window_budget=0))
            return eng.evaluate()

        rows = {r["check"]: r for r in twin(scenario)}
        assert rows["shed_budget"]["ok"] is False
        assert rows["shed_budget"]["value"] == 4
        assert rows["degraded_window_budget"]["ok"] is True

    def test_live_budget_fails_on_silence(self):
        def scenario(pkg):
            return pkg.slo.SloEngine(pkg.slo.SloSpec(
                shed_budget=1000)).evaluate()

        assert twin(scenario) == [{"check": "shed_budget", "value": None,
                                   "bound": "<= 1000", "ok": False}]

    def _port_ledger(self, tmp_path, pausable=False):
        telemetry.enable()
        ctrl = tov.install(tov.OverloadController(tov.OverloadPolicy(
            max_buffered_events=1, admission_window_ms=10_000,
            breaker_failures=2)))
        for t in range(4):
            ctrl.admit_item(_Ev(t), pausable=pausable)
        if not pausable:
            ctrl.count_degraded_window()
        ledger = tmp_path / "ledger.json"
        telemetry.write_ledger(str(ledger), capture_costs=False)
        return ledger, ctrl

    def test_posthoc_twin_reads_the_port_ledger(self, tmp_path):
        from tools.sfprof import slo as sfslo

        ledger, _ = self._port_ledger(tmp_path)
        doc = json.loads(ledger.read_text())
        assert doc["snapshot"]["overload"]["shed_total"] == 3
        rows = sfslo.evaluate(
            {"shed_budget": 2, "degraded_window_budget": 0}, doc)
        assert rows == [
            ("slo:shed_budget", 3.0, "<= 2", False),
            ("slo:degraded_window_budget", 1.0, "<= 0", False),
        ]
        rows = sfslo.evaluate(
            {"shed_budget": 10, "degraded_window_budget": 5}, doc)
        assert all(r[3] for r in rows)

    def test_health_reader_prints_the_port_overload_notes(self, tmp_path,
                                                          capsys):
        from tools.sfprof.cli import main as sfprof_main

        ledger, _ = self._port_ledger(tmp_path)
        assert sfprof_main(["health", str(ledger)]) == 0
        out = capsys.readouterr().out
        assert "note overload sheds: total=3 (admission=3)" in out
        assert "note overload degradation: rung=0" in out
        assert "note overload circuit: state=closed" in out

    def test_health_prints_backpressure_only_runs(self, tmp_path, capsys):
        from tools.sfprof.cli import main as sfprof_main

        ledger, ctrl = self._port_ledger(tmp_path, pausable=True)
        assert ctrl.shed_total == 0 and ctrl.backpressure_engaged > 0
        assert sfprof_main(["health", str(ledger)]) == 0
        out = capsys.readouterr().out
        assert (f"backpressure engaged "
                f"{int(ctrl.backpressure_engaged)}x") in out

    def test_spec_twin_field_sets_stay_in_sync(self):
        import dataclasses

        from tools.sfprof import slo as sfslo

        live = {f.name for f in dataclasses.fields(tslo.SloSpec)}
        assert live == set(sfslo.SPEC_KEYS)
        assert live == {f.name for f in dataclasses.fields(jslo.SloSpec)}


# ---------------------------------------------------------------------------
# run_wire_panes' batch_slides rung: batched fetches, identical results


def _wire_setup(pkg):
    grid = pkg.Grid(20, 0.0, 10.0, 0.0, 10.0)
    wf = (WireFormat if pkg is PORT else JWireFormat).for_grid(grid)
    rng = np.random.default_rng(5)
    panes = []
    for _ in range(9):
        n = int(rng.integers(5, 40))
        xy = np.stack([rng.uniform(0, 10, n),
                       rng.uniform(0, 10, n)], axis=1)
        q = wf.quantize(xy)
        oid = rng.integers(0, 9, n).astype(np.int16)
        panes.append(np.ascontiguousarray(np.concatenate(
            [q, oid.view(np.uint16)[:, None]], axis=1).T))
    conf = pkg.Conf(pkg.QT.WindowBased, window_size=3.0, slide_step=1.0)
    qp = pkg.Point(obj_id="q", x=5.0, y=5.0)

    def make_op():
        if pkg is PORT:
            return PointPointKNNQuery(conf, grid, device="cpu")
        return JKnn(conf, grid)

    return make_op, panes, qp, wf


def _collect(gen):
    return [(s, e, list(map(int, segs)), [float(d) for d in dists], nv)
            for s, e, segs, dists, nv in gen]


def _batching(pkg, n=3):
    ctrl = pkg.ov.install(pkg.ov.OverloadController(pkg.ov.OverloadPolicy(
        ladder=({"action": "batch_slides", "n": n},), degrade_cooldown=1)))
    ctrl.on_slo_evaluation(False)
    assert pkg.ov.batch_slides() == n
    return ctrl


class TestBatchSlides:
    @pytest.mark.parametrize("width", [1, 2, 3, 4, 20])
    def test_wire_pane_results_identical_under_batching(self, width):
        make_op, panes, qp, wf = _wire_setup(PORT)
        base = _collect(make_op().run_wire_panes(panes, qp, 2.0, 5, 16, wf))
        jmake, jpanes_, jqp, jwf = _wire_setup(JAX)
        jbase = _collect(jmake().run_wire_panes(jpanes_, jqp, 2.0, 5, 16,
                                                jwf))
        # The JAX digest may contract into an FMA: ids, counts and windows
        # exact, distances within the JAX tests' rtol 3e-7.
        assert [(s, e, o, n) for s, e, o, _, n in base] == \
            [(s, e, o, n) for s, e, o, _, n in jbase]
        np.testing.assert_allclose(sum((d for *_, d, _ in base), []),
                                   sum((d for *_, d, _ in jbase), []),
                                   rtol=3e-7)
        _batching(PORT, width)
        telemetry.enable()
        got = _collect(make_op().run_wire_panes(panes, qp, 2.0, 5, 16, wf))
        fetches = sum(1 for e in telemetry.events if e["name"] == "fetch")
        assert got == base and len(base) == 11
        # Fetches a window: 2 unbatched (the count, then the rows); one
        # packed copy a batch otherwise.
        want = 2 * len(base) if width == 1 else -(-len(base) // width)
        assert fetches == want

    def test_mid_batch_checkpoint_never_loses_pending_windows(
            self, tmp_path):
        make_op, panes, qp, wf = _wire_setup(PORT)
        base = _collect(make_op().run_wire_panes(panes, qp, 2.0, 5, 16, wf))
        _batching(PORT)
        op1 = make_op()
        gen = op1.run_wire_panes(panes, qp, 2.0, 5, 16, wf)
        head = []
        for tup in gen:
            head.append(tup)
            if len(head) == 2:  # suspended mid-flush: the batch is open
                break
        gen.close()
        state = operator_state(op1)
        cut = int(state["knn_wire_pane_carry"]["next_pane"])
        # Three panes consumed (the width-3 batch filled at pane 2), the
        # windows of panes 0-1 yielded: the carry lags at 2.
        assert cut == 2
        path = str(tmp_path / "wire.ckpt")
        save_checkpoint(path, op=state)
        op2 = make_op()
        restore_operator(op2, load_checkpoint(path)["op"])
        rest = _collect(op2.run_wire_panes(panes[cut:], qp, 2.0, 5, 16, wf))
        assert _collect(iter(head)) + rest == base

    def test_pipelined_branch_ignores_the_rung(self):
        from spatialflink_tpu_torch import pipeline as tpipeline

        make_op, panes, qp, wf = _wire_setup(PORT)
        base = _collect(make_op().run_wire_panes(panes, qp, 2.0, 5, 16, wf))
        _batching(PORT)
        tpipeline.install(tpipeline.PipelinePolicy(depth=2, fetch_lag=1))
        try:
            telemetry.enable()
            got = _collect(make_op().run_wire_panes(panes, qp, 2.0, 5, 16,
                                                    wf))
        finally:
            tpipeline.uninstall()
        assert got == base
        assert telemetry.snapshot()["pipeline"]["overlapped"] == len(base)


def test_open_circuit_collapses_the_pipelined_executor():
    """``PipelinedExecutor`` (here under ``run_wire_panes``) runs at the
    synchronous cadence while the installed breaker is open, emits
    ``pipeline_collapsed`` / ``pipeline_resumed`` on the transitions,
    and overlaps again once it closes; windows equal the synchronous
    run."""
    from spatialflink_tpu_torch import pipeline as tpipeline

    make_op, panes, qp, wf = _wire_setup(PORT)
    base = _collect(make_op().run_wire_panes(panes, qp, 2.0, 5, 16, wf))
    ctrl = tov.install(tov.OverloadController(tov.OverloadPolicy(
        breaker_failures=1)))
    telemetry.enable()
    ctrl.breaker.record_failure(0, "down")
    assert tpipeline.breaker_collapsed()
    tpipeline.install(tpipeline.PipelinePolicy(depth=2, fetch_lag=1))
    try:
        got = []
        for w in make_op().run_wire_panes(panes, qp, 2.0, 5, 16, wf):
            got.append(w)
            if len(got) == 4:
                ctrl.breaker.state = "closed"
        got = _collect(iter(got))
    finally:
        tpipeline.uninstall()
    assert got == base
    pipe = telemetry.snapshot()["pipeline"]
    assert pipe["collapses"] == 1 and pipe["resumes"] == 1
    assert pipe["sync"] >= 4 and pipe["overlapped"] > 0
    assert pipe["sync"] + pipe["overlapped"] == len(base)
    assert [n for n, _ in _instants(telemetry)
            if n.startswith("pipeline_")] == ["pipeline_collapsed",
                                              "pipeline_resumed"]


# ---------------------------------------------------------------------------
# The assemblers' fire sites feed the controller


def test_fire_sites_feed_the_controller_as_the_jax():
    from spatialflink_tpu.streams.soa import SoaWindowAssembler as JSoa
    from spatialflink_tpu.streams.windows import (
        SlidingEventTimeWindows as JSliding,
        WindowAssembler as JAsm,
    )
    from spatialflink_tpu_torch.streams.soa import SoaWindowAssembler
    from spatialflink_tpu_torch.streams.windows import (
        SlidingEventTimeWindows,
        WindowAssembler,
    )

    rng = np.random.default_rng(12)
    ts = np.sort(rng.integers(0, 20_000, 200)).astype(np.int64)
    ts[::17] -= 3000  # stragglers

    def scenario(pkg):
        pkg.tel.enable()
        ctrl = pkg.ov.install(pkg.ov.OverloadController(pkg.ov.OverloadPolicy(
            lag_shed_ceiling_ms=400, lag_recover_ms=100,
            ladder=({"action": "batch_slides", "n": 2},),
            degrade_cooldown=1, recover_after=2)))
        jx = pkg is JAX
        asm = (JAsm if jx else WindowAssembler)(
            (JSliding if jx else SlidingEventTimeWindows)(2000, 1000),
            timestamp_fn=lambda e: e.timestamp, max_out_of_orderness_ms=500)
        n_obj = 0
        for t in ts:
            n_obj += len(asm.feed(pkg.Point(obj_id="a", timestamp=int(t))))
        soa = (JSoa if jx else SoaWindowAssembler)(2000, 1000)
        n_soa = 0
        for c in range(0, len(ts), 20):
            n_soa += len(soa.feed({"ts": ts[c:c + 20],
                                   "x": np.zeros(len(ts[c:c + 20])),
                                   "y": np.zeros(len(ts[c:c + 20]))}))
        return _record(pkg, ctrl, n=(n_obj, n_soa))

    rec = twin(scenario)
    assert rec["n"][0] > 5 and rec["n"][1] > 5
    assert rec["snapshot"]["rung_transitions"] > 0


# ---------------------------------------------------------------------------
# The smoke


def _smoke_pipeline(pkg, stream_path=None):
    """The smoke's burst through TStatsQuery.run under the smoke's policy
    and SLO spec: the whole transition story of one run (streamed to
    ``stream_path`` when given)."""
    src = list(tov.smoke_source())
    if stream_path is None:
        pkg.tel.enable()
    else:
        pkg.tel.enable(stream_path=stream_path, stream_flush_interval_s=0.0)
    ctrl = pkg.ov.install(pkg.ov.OverloadController(
        pkg.ov.OverloadPolicy(**{
            k: v for k, v in tov.smoke_policy().to_dict().items()
            if k != "overload_version"})))
    eng = pkg.slo.install(pkg.slo.SloEngine(pkg.slo.SloSpec(
        name="overload-smoke", shed_budget=10_000,
        degraded_window_budget=0, eval_interval_s=0.0)))
    grid = pkg.Grid(8, 0.0, 8.0, 0.0, 8.0)
    conf = pkg.Conf(pkg.QT.WindowBased, window_size=2.0, slide_step=1.0)
    op = pkg.TStats(conf, grid, device="cpu") if pkg is PORT \
        else pkg.TStats(conf, grid)
    drv = pkg.drv.WindowedDataflowDriver(
        retry=pkg.drv.RetryPolicy(max_retries=0), failover=False,
        overload=ctrl, source_pausable=False)
    stream = [pkg.Point(obj_id=p.obj_id, timestamp=p.timestamp, x=p.x,
                        y=p.y) for p in src]
    rungs = [ctrl.rung for _ in op.run(iter(stream), driver=drv)]
    verdict = eng.verdict()
    for v in verdict["violations"]:
        v.pop("unix")
    return _record(pkg, ctrl, rungs=rungs, verdict=verdict,
                   stats=drv.stats)


def test_smoke_pipeline_transitions_equal_the_jax():
    rec = twin(_smoke_pipeline)
    assert max(rec["rungs"]) >= 1 and rec["snapshot"]["rung"] == 0
    assert {"late", "admission"} <= set(rec["snapshot"]["shed"])
    names = [n for n, _ in rec["instants"]]
    for head in ("overload_shedding:lag", "overload_shedding:admission",
                 "overload_recovered:lag", "overload_rung_down:",
                 "overload_rung_up:"):
        assert any(n.startswith(head) for n in names), head
    # Every transition the port emits is in the sfprof consumer registry.
    from tools.sfprof import events as events_mod

    for n in names:
        assert n in events_mod.INSTANT_EVENTS or n.startswith(
            events_mod.INSTANT_EVENT_PREFIXES), n


def test_sfprof_recovers_and_gates_the_port_sealed_stream(tmp_path,
                                                          capsys):
    """The JAX package's ``tools/sfprof`` reads the port's sealed ledger
    stream as it reads the JAX one: ``recover`` rebuilds a valid ledger
    holding the overload block and the transitions, and ``health
    --slo`` gives the same verdict, row for row, on both packages'
    recovered ledgers."""
    from tools.sfprof.cli import main as sfprof_main

    spec = tmp_path / "spec.json"
    spec.write_text(json.dumps({"name": "gate", "shed_budget": 10_000,
                                "degraded_window_budget": 0}))
    got = {}
    for pkg in (JAX, PORT):
        stream = str(tmp_path / f"{pkg.name}.stream.jsonl")
        rec = _smoke_pipeline(pkg, stream)
        pkg.tel.disable()  # seals: the verdict rides the epilogue
        capsys.readouterr()
        assert sfprof_main(["recover", stream]) == 0
        out = capsys.readouterr().out
        assert "sealed: yes" in out and "recovered ledger valid" in out
        with open(stream + ".recovered.json") as f:
            doc = json.load(f)
        assert doc["snapshot"]["overload"]["shed"] == \
            rec["snapshot"]["shed"]
        names = {e["name"] for e in doc["events"]}
        assert {"overload_shedding:lag", "overload_recovered:lag"} <= names
        rc = sfprof_main(["health", stream + ".recovered.json", "--slo",
                          str(spec)])
        rows = [ln.split()[:3] for ln in capsys.readouterr().out.splitlines()
                if ln.split()[1:2] and ln.split()[1].startswith("slo:")]
        got[pkg.name] = (rc, rows, doc["snapshot"]["overload"])
        pkg.slo.uninstall()
        pkg.ov.uninstall()
    assert got["port"] == got["jax"]
    assert ["ok", "slo:shed_budget", "44"] in got["port"][1]


def test_overload_smoke_round_trip_on_the_cpu():
    assert tov.smoke(device="cpu") == 0


def test_overload_smoke_cli_on_the_cpu():
    env = {k: v for k, v in os.environ.items()
           if k not in ("SFT_FAULT_PLAN", "SFT_LEDGER_STREAM",
                        "SFT_PIPELINE")}
    p = subprocess.run(
        [sys.executable, "-m", "spatialflink_tpu_torch.overload", "--smoke",
         "--device", "cpu"], env=env, capture_output=True, text=True,
        timeout=300, cwd=REPO)
    assert p.returncode == 0, p.stdout[-2000:] + p.stderr[-2000:]
    assert "OK" in p.stdout


# ---------------------------------------------------------------------------
# Shared by the operator families' files: a budget-free controller


def plain(x):
    """A result tree as comparable builtins: dataclass fields, arrays and
    tensors as lists, other objects by their attributes."""
    import dataclasses

    import torch

    if isinstance(x, (list, tuple)):
        return [plain(v) for v in x]
    if isinstance(x, dict):
        return {k: plain(v) for k, v in x.items()}
    if isinstance(x, (np.ndarray, torch.Tensor)):
        return np.asarray(x).tolist()
    if isinstance(x, np.generic):
        return x.item()
    if dataclasses.is_dataclass(x):
        return {f.name: plain(getattr(x, f.name))
                for f in dataclasses.fields(x)}
    if hasattr(x, "__dict__"):
        return plain(vars(x))
    return x


def assert_budget_free_controller_changes_nothing(run):
    """``run(driver)`` → the operator's windows. Through a driver with a
    controller that has no budget, the windows equal the run without a
    driver, nothing sheds and no window is degraded
    (``tests/test_overload.py``'s ``test_no_budget_controller_changes_
    nothing``, for any operator)."""
    try:
        base = plain(run(None))
        ctrl = tov.OverloadController(tov.OverloadPolicy())
        got = plain(run(tdriver.WindowedDataflowDriver(overload=ctrl)))
        assert base and got == base
        assert ctrl.shed_total == 0 and ctrl.degraded_windows == 0
        assert tov.controller() is ctrl
    finally:
        tov.uninstall()
