"""Deterministic fault injection in the PyTorch port
(``spatialflink_tpu_torch/faults.py``): plan parsing, trigger
determinism, the kinds, the disarmed-free contract, telemetry visibility,
and parity with the JAX package's injector at the threaded points.

One case for each case of ``tests/test_faults.py``, all of which apply
(the disarmed-hot-path case drives the port's range operator on the CPU
where the JAX one drives its driver's toy pipeline). Then parity: the
same plan, armed in both packages, fires at the same hit of
``window.feed`` and ``soa.feed`` on the same seeded stream, and at the
same window for ``device.ship`` (the port ships the flag table and the
query through ``ship`` too, two hits the JAX package makes through a
bare ``jnp.asarray``, so its hit numbers run two ahead).

Every test leaves both packages' ``telemetry``, ``faults`` and
``ablation`` singletons disarmed, disabled and reset.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest

from spatialflink_tpu import ablation as j_ablation_mod
from spatialflink_tpu import faults as j_faults_mod
from spatialflink_tpu import telemetry as j_tel_mod
from spatialflink_tpu.grid import UniformGrid as JGrid
from spatialflink_tpu.models.objects import Point as JPoint
from spatialflink_tpu.operators import PointPointRangeQuery as JRangeQ
from spatialflink_tpu.operators import QueryConfiguration as JConf
from spatialflink_tpu.operators import QueryType as JQT

from spatialflink_tpu_torch.ablation import ablation
from spatialflink_tpu_torch.faults import (
    ABORT_EXIT_CODE,
    INJECTION_POINTS,
    FaultInjector,
    FaultRule,
    InjectedFault,
    faults,
    parse_plan,
)
from spatialflink_tpu_torch.grid import UniformGrid
from spatialflink_tpu_torch.models.objects import Point
from spatialflink_tpu_torch.operators import (
    PointPointRangeQuery,
    QueryConfiguration,
    QueryType,
)
from spatialflink_tpu_torch.telemetry import instrument_jit, telemetry

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def reset_runtime_singletons():
    """Disarm, disable and reset both packages' runtime singletons (the
    ``tests/test_ledger_stream.py`` idiom: enable() resets every counter,
    disable() seals)."""
    for fl, ab, tel in (
            (faults, ablation, telemetry),
            (j_faults_mod.faults, j_ablation_mod.ablation,
             j_tel_mod.telemetry)):
        fl.disarm()
        ab.disarm()
        tel.enable()
        tel.disable()
        ab.reset_counters()


@pytest.fixture(autouse=True)
def _runtime_off():
    caps = (telemetry.max_events, j_tel_mod.telemetry.max_events)
    yield
    telemetry.max_events, j_tel_mod.telemetry.max_events = caps
    reset_runtime_singletons()


class TestPlanParsing:
    def test_unknown_point_raises(self):
        with pytest.raises(ValueError, match="unknown injection point"):
            parse_plan([{"point": "device.shipp"}])

    def test_unknown_kind_raises(self):
        with pytest.raises(ValueError, match="unknown fault kind"):
            parse_plan([{"point": "device.ship", "kind": "explode"}])

    def test_unknown_key_raises(self):
        with pytest.raises(ValueError, match="unknown keys"):
            parse_plan([{"point": "device.ship", "when": 3}])

    def test_partial_write_only_on_sink(self):
        with pytest.raises(ValueError, match="partial_write"):
            parse_plan([{"point": "device.ship", "kind": "partial_write"}])
        assert parse_plan(
            [{"point": "sink.write", "kind": "partial_write"}]
        )[0].kind == "partial_write"

    def test_single_object_is_one_rule_plan(self):
        assert len(parse_plan({"point": "window.feed"})) == 1

    def test_arm_accepts_inline_json_and_file(self, tmp_path):
        inj = FaultInjector()
        inj.arm('[{"point": "window.feed", "at": 2}]')
        assert inj.armed and inj.rules[0].at == 2
        p = tmp_path / "plan.json"
        p.write_text(json.dumps([{"point": "soa.feed", "times": 3}]))
        inj.arm(str(p))
        assert inj.rules[0].point == "soa.feed"
        assert inj.rules[0].times == 3

    def test_registry_names_every_threaded_point(self):
        # The JAX registry, kept whole: the port threads a subset and its
        # module docstring names the item each other point waits for.
        assert INJECTION_POINTS.keys() == j_faults_mod.INJECTION_POINTS.keys()
        assert set(INJECTION_POINTS) == {
            "device.ship", "device.dispatch", "device.fetch",
            "window.feed", "soa.feed", "kafka.fetch", "kafka.leader",
            "sink.write", "driver.window",
            "overload.admit", "source.stall",
            "pipeline.ship", "pipeline.fetch", "qserve.register",
            "dag.node", "dag.commit", "shard.exchange",
        }
        import spatialflink_tpu_torch.faults as mod

        for point in INJECTION_POINTS:
            assert f"``{point}``" in mod.__doc__, point


class TestTriggers:
    def test_fires_at_exact_hit_count(self):
        inj = FaultInjector()
        inj.arm([{"point": "window.feed", "at": 3, "times": 2}])
        assert inj.hit("window.feed") is None
        assert inj.hit("window.feed") is None
        for expect_hit in (3, 4):
            with pytest.raises(InjectedFault) as ei:
                inj.hit("window.feed")
            assert ei.value.hit == expect_hit
        assert inj.hit("window.feed") is None  # budget spent
        assert len(inj.fired) == 2

    def test_points_count_independently(self):
        inj = FaultInjector()
        inj.arm([{"point": "device.ship", "at": 2}])
        assert inj.hit("device.fetch") is None
        assert inj.hit("device.ship") is None
        with pytest.raises(InjectedFault):
            inj.hit("device.ship")

    def test_seeded_prob_replays_identically(self):
        def firing_pattern(cls):
            inj = cls()
            inj.arm([{"point": "window.feed", "at": 1, "times": 50,
                      "prob": 0.5, "seed": 42}])
            out = []
            for _ in range(50):
                try:
                    inj.hit("window.feed")
                    out.append(False)
                except (InjectedFault, j_faults_mod.InjectedFault):
                    out.append(True)
            return out

        a, b = firing_pattern(FaultInjector), firing_pattern(FaultInjector)
        assert a == b
        assert any(a) and not all(a)  # the draw actually varies
        # Bit-identical to the JAX injector's schedule for the same plan.
        assert a == firing_pattern(j_faults_mod.FaultInjector)

    def test_hang_kind_sleeps_then_raises(self):
        inj = FaultInjector()
        inj.arm([{"point": "device.fetch", "kind": "hang",
                  "hang_s": 0.05}])
        t0 = time.monotonic()
        with pytest.raises(InjectedFault) as ei:
            inj.hit("device.fetch")
        assert time.monotonic() - t0 >= 0.05
        assert ei.value.kind == "hang"

    def test_disarm_clears_state(self):
        inj = FaultInjector()
        inj.arm([{"point": "window.feed"}])
        inj.disarm()
        assert not inj.armed and not inj.rules
        assert inj.hit("window.feed") is None  # inert once disarmed


GRID = UniformGrid(20, 0.0, 10.0, 0.0, 10.0)
JGRID = JGrid(20, 0.0, 10.0, 0.0, 10.0)


def _points(cls, n=60, seed=3):
    rng = np.random.default_rng(seed)
    xy = rng.uniform(0, 10, (n, 2))
    return [cls(obj_id=f"d{i % 7}", timestamp=int(i * 75),
                x=float(xy[i, 0]), y=float(xy[i, 1])) for i in range(n)]


class TestDisarmedFree:
    def test_module_singleton_starts_disarmed(self):
        # SFT_FAULT_PLAN is unset in the test environment: the
        # import-time arm leaves the injector inert.
        assert faults.armed is False

    def test_disarmed_hot_paths_do_not_touch_the_injector(self):
        """With no plan the threaded paths never call hit() (the guard is
        ``if faults.armed``), so counts stay empty after real windows,
        ships and dispatches ran."""
        conf = QueryConfiguration(QueryType.WindowBased, window_size=10,
                                  slide_step=5)
        op = PointPointRangeQuery(conf, GRID, device="cpu")
        assert list(op.run(iter(_points(Point)), [Point(x=5.0, y=5.0)],
                           1.5))
        assert faults.counts == {}
        assert faults.fired == []


class TestTelemetryVisibility:
    def test_fired_fault_lands_in_snapshot_and_events(self):
        telemetry.enable()
        faults.arm([{"point": "window.feed", "at": 1}])
        with pytest.raises(InjectedFault):
            faults.hit("window.feed")
        snap = telemetry.snapshot()
        assert snap["faults"] == {"window.feed": 1}
        names = [e["name"] for e in telemetry.events]
        assert "fault_armed" in names
        assert "fault_fired:window.feed" in names

    def test_plan_armed_before_enable_still_records_fault_armed(self):
        faults.arm([{"point": "soa.feed", "at": 3}])
        telemetry.enable()
        armed = [e for e in telemetry.events if e["name"] == "fault_armed"]
        assert len(armed) == 1
        assert armed[0]["args"]["plan"][0]["point"] == "soa.feed"

    def test_no_faults_block_when_nothing_fired(self):
        telemetry.enable()
        assert "faults" not in telemetry.snapshot()
        assert telemetry.snapshot()["driver"] == {
            "retries": 0, "failovers": 0,
        }


class TestDispatchPointCoverage:
    def test_device_dispatch_lives_in_instrument_jit(self):
        calls = []
        f = instrument_jit(lambda x: calls.append(x) or x, name="probe")
        faults.arm([{"point": "device.dispatch", "at": 2}])
        assert f(1) == 1
        with pytest.raises(InjectedFault):
            f(2)
        assert calls == [1]  # the faulted dispatch never ran the kernel


class TestEnvArming:
    def test_subprocess_arms_from_env_and_abort_kind_kills(self):
        """SFT_FAULT_PLAN arms at import; the abort kind dies with the
        SIGKILL-analog exit code, skipping every handler."""
        code = (
            "from spatialflink_tpu_torch.faults import faults\n"
            "assert faults.armed\n"
            "import atexit; atexit.register("
            "lambda: print('HANDLER RAN'))\n"
            "faults.hit('window.feed')\n"
            "print('UNREACHABLE')\n"
        )
        p = subprocess.run(
            [sys.executable, "-c", code], cwd=REPO,
            env={**os.environ,
                 "SFT_FAULT_PLAN":
                     '[{"point": "window.feed", "kind": "abort"}]'},
            capture_output=True, text=True, timeout=120,
        )
        assert p.returncode == ABORT_EXIT_CODE, p.stderr
        assert "UNREACHABLE" not in p.stdout
        assert "HANDLER RAN" not in p.stdout

    def test_rule_validation_happens_at_arm_time(self):
        with pytest.raises(ValueError):
            FaultRule(point="nope")


# -- parity with the JAX injector at the threaded points ---------------------


def _fire_hit(run, injected):
    """The hit number at which ``run()`` raised the armed fault."""
    with pytest.raises(injected) as ei:
        run()
    return ei.value.hit


def _soa_chunks(seed=5, n_chunks=6, per=40):
    rng = np.random.default_rng(seed)
    out = []
    for c in range(n_chunks):
        ts = np.sort(rng.integers(c * 400, (c + 1) * 400, per))
        out.append({"ts": ts.astype(np.int64),
                    "x": rng.uniform(0, 10, per),
                    "y": rng.uniform(0, 10, per),
                    "oid": rng.integers(0, 8, per).astype(np.int32)})
    return out


def _range_ops():
    conf = QueryConfiguration(QueryType.WindowBased, window_size=1,
                              slide_step=1)
    jconf = JConf(JQT.WindowBased, window_size=1, slide_step=1)
    return (PointPointRangeQuery(conf, GRID, device="cpu"),
            JRangeQ(jconf, JGRID))


@pytest.mark.parametrize("at", [1, 9, 33])
def test_window_feed_fires_at_the_same_hit(at):
    plan = [{"point": "window.feed", "at": at}]
    op, jop = _range_ops()
    faults.arm(plan)
    got = _fire_hit(lambda: list(op.run(iter(_points(Point)),
                                        [Point(x=5.0, y=5.0)], 1.5)),
                    InjectedFault)
    counts = dict(faults.counts)
    j_faults_mod.faults.arm(plan)
    want = _fire_hit(lambda: list(jop.run(iter(_points(JPoint)),
                                          [JPoint(x=5.0, y=5.0)], 1.5,
                                          dtype=np.float32)),
                     j_faults_mod.InjectedFault)
    assert got == want == at
    assert counts["window.feed"] == j_faults_mod.faults.counts["window.feed"]


@pytest.mark.parametrize("at", [1, 4])
def test_soa_feed_fires_at_the_same_hit(at):
    plan = [{"point": "soa.feed", "at": at}]
    op, jop = _range_ops()
    faults.arm(plan)
    got = _fire_hit(lambda: list(op.run_soa(iter(_soa_chunks()),
                                            [Point(x=5.0, y=5.0)], 1.5)),
                    InjectedFault)
    j_faults_mod.faults.arm(plan)
    want = _fire_hit(lambda: list(jop.run_soa(iter(_soa_chunks()),
                                              [JPoint(x=5.0, y=5.0)], 1.5,
                                              dtype=np.float32)),
                     j_faults_mod.InjectedFault)
    assert got == want == at


@pytest.mark.parametrize("window", [1, 3])
def test_device_ship_fires_in_the_same_window(window):
    """``run_soa`` ships one batch a window in both packages; the port's
    set-up ships (flag table, query) are two more hits before the first
    window, so the port's ``at`` is the JAX one plus 2, and the windows
    yielded before the fault are the same."""
    op, jop = _range_ops()
    got, want = [], []
    faults.arm([{"point": "device.ship", "at": window + 2}])
    with pytest.raises(InjectedFault) as ei:
        for w in op.run_soa(iter(_soa_chunks()), [Point(x=5.0, y=5.0)],
                            1.5):
            got.append(w[:2])
    assert ei.value.hit == window + 2
    j_faults_mod.faults.arm([{"point": "device.ship", "at": window}])
    with pytest.raises(j_faults_mod.InjectedFault):
        for w in jop.run_soa(iter(_soa_chunks()), [JPoint(x=5.0, y=5.0)],
                             1.5, dtype=np.float32):
            want.append(w[:2])
    assert got == want and len(got) == window - 1
