"""The online SLO engine in the port (``spatialflink_tpu_torch/slo.py``)
against the JAX package's (``spatialflink_tpu/slo.py``), on the CPU, with
``tests/test_slo.py`` as the oracle.

Each case runs through both packages (engine, telemetry and assemblers of
the same package) on the same inputs, and the check rows, the verdict
blocks and the ``slo_*`` instants are held equal. Left out of the
comparison, because they are wall-clock readings: the ``unix`` stamp of
each violation record, the instants' timestamps, and the value of the
``eps_floor`` row (events over elapsed seconds; its ``ok`` is compared).
Then the window-fire hooks of both assemblers, the ledger embedding and
``tools/sfprof``'s post-hoc twin and ``health --slo`` reading the port's
ledger, the driver budgets, the e2e ceilings and the node budgets: with no
DAG installed a named node violates, as in the JAX engine; with each
package's composed DAG installed (``dag.py``) the budgets read its nodes'
counters and a clean node passes.
"""

import dataclasses
import json
import time
from types import SimpleNamespace

import numpy as np
import pytest

from spatialflink_tpu import overload as jov
from spatialflink_tpu import slo as jslo
from spatialflink_tpu.models.objects import Point as JPoint
from spatialflink_tpu.streams.soa import SoaWindowAssembler as JSoa
from spatialflink_tpu.streams.windows import (
    TumblingEventTimeWindows as JTumbling,
    WindowAssembler as JAsm,
)
from spatialflink_tpu.telemetry import telemetry as jtel
from tools.sfprof import slo as sfprof_slo

from spatialflink_tpu_torch import overload as tov
from spatialflink_tpu_torch import slo
from spatialflink_tpu_torch.models.objects import Point
from spatialflink_tpu_torch.streams.soa import SoaWindowAssembler
from spatialflink_tpu_torch.streams.windows import (
    TumblingEventTimeWindows,
    WindowAssembler,
)
from spatialflink_tpu_torch.telemetry import telemetry

JAX = SimpleNamespace(slo=jslo, ov=jov, tel=jtel, Asm=JAsm,
                      Tumbling=JTumbling, Soa=JSoa, Point=JPoint)
PORT = SimpleNamespace(slo=slo, ov=tov, tel=telemetry, Asm=WindowAssembler,
                       Tumbling=TumblingEventTimeWindows,
                       Soa=SoaWindowAssembler, Point=Point)


@pytest.fixture(autouse=True)
def _clean():
    yield
    for pkg in (JAX, PORT):
        pkg.slo.uninstall()
        pkg.ov.uninstall()
        pkg.tel.enable()
        pkg.tel.disable()


def _spec(pkg, **kw):
    kw.setdefault("eval_interval_s", 0.0)  # evaluate on every window
    kw.setdefault("warmup_windows", 0)
    return pkg.slo.SloSpec(**kw)


def _untimed(rows):
    return [{**r, "value": None} if r["check"] == "eps_floor" else r
            for r in rows]


def _verdict(v):
    v = dict(v)
    v["checks"] = _untimed(v["checks"])
    v["violations"] = [{k: x for k, x in rec.items() if k != "unix"}
                       for rec in v["violations"]]
    return v


def _slo_instants(tel):
    return [(e["name"], e.get("args", {})) for e in tel.events
            if e.get("ph") == "i" and e["name"].startswith("slo_")]


def twin(scenario):
    want = scenario(JAX)
    got = scenario(PORT)
    assert got == want
    return got


# -- spec parsing -------------------------------------------------------------


BAD_SPECS = {
    "typo": {"eps_flor": 1.0},
    "version": {"slo_version": 99},
    "tenant_key": {"tenant_budgets": {"a": {"shed_budgt": 1}}},
    "tenant_negative": {"tenant_budgets": {"a": {"shed_budget": -1}}},
    "node_key": {"node_budgets": {"q1": {"e2e_p99_mss": 5}}},
    "node_float": {"node_budgets": {"q1": {"e2e_p99_ms": 5.5}}},
}


@pytest.mark.parametrize("case", sorted(BAD_SPECS))
def test_spec_strict_parse_raises_as_the_jax(case):
    with pytest.raises(ValueError) as je:
        jslo.SloSpec.from_dict(BAD_SPECS[case])
    with pytest.raises(ValueError) as te:
        slo.SloSpec.from_dict(BAD_SPECS[case])
    assert str(te.value) == str(je.value)


def test_spec_from_dict_strict():
    sp = slo.SloSpec.from_dict(
        {"name": "q", "eps_floor": 100.0, "late_drop_budget": 0})
    assert sp.eps_floor == 100.0
    assert sp.watermark_lag_p99_ms is None


def test_spec_file_roundtrip(tmp_path):
    p = tmp_path / "spec.json"
    p.write_text(json.dumps({"slo_version": slo.SLO_VERSION,
                             "name": "smoke", "recompile_ceiling": 24,
                             "e2e_p99_ms": 200.0,
                             "node_budgets": {"q1": {"e2e_p99_ms": 5}}}))
    sp = slo.SloSpec.from_file(str(p))
    assert sp.recompile_ceiling == 24
    assert sp.to_dict() == jslo.SloSpec.from_file(str(p)).to_dict()


def test_spec_twin_constants_and_fields_in_sync():
    assert slo.SLO_VERSION == jslo.SLO_VERSION == sfprof_slo.SLO_VERSION
    fields = [f.name for f in dataclasses.fields(slo.SloSpec)]
    assert fields == [f.name for f in dataclasses.fields(jslo.SloSpec)]
    assert set(fields) == set(sfprof_slo.SPEC_KEYS)
    assert slo.SloSpec.TENANT_BUDGET_KEYS == jslo.SloSpec.TENANT_BUDGET_KEYS
    assert slo.SloSpec.NODE_BUDGET_KEYS == jslo.SloSpec.NODE_BUDGET_KEYS


# -- incremental evaluation ---------------------------------------------------


def test_lag_p99_violation_is_a_transition_not_a_spam():
    def scenario(pkg):
        pkg.tel.enable()
        eng = pkg.slo.install(pkg.slo.SloEngine(_spec(
            pkg, watermark_lag_p99_ms=8.0)))
        for _ in range(20):
            eng.observe_window(10, lag_ms=1.0)
        before = list(eng.violations)
        for _ in range(200):
            eng.observe_window(10, lag_ms=5000.0)
        rows = eng.evaluate()
        return {"before": before, "rows": rows,
                "verdict": _verdict(eng.verdict()),
                "instants": _slo_instants(pkg.tel)}

    rec = twin(scenario)
    assert rec["before"] == []
    assert not rec["rows"][0]["ok"]
    assert [v["check"] for v in rec["verdict"]["violations"]] == [
        "watermark_lag_p99_ms"]
    assert [n for n, _ in rec["instants"]] == [
        "slo_violation:watermark_lag_p99_ms"]
    assert rec["verdict"]["ok"] is False


def test_eps_clock_starts_at_first_window_not_install():
    telemetry.enable()
    eng = slo.SloEngine(_spec(PORT, eps_floor=100_000.0))
    assert eng._t0 is None
    time.sleep(0.06)
    eng.observe_window(500)
    eng.observe_window(500)
    rows = {r["check"]: r for r in eng.evaluate()}
    assert rows["eps_floor"]["ok"], rows["eps_floor"]
    assert eng.violations == []


def test_eps_floor_respects_warmup_then_violates():
    def scenario(pkg):
        pkg.tel.enable()
        eng = pkg.slo.SloEngine(_spec(pkg, eps_floor=1e15, warmup_windows=5))
        for _ in range(5):
            eng.observe_window(10)
        early = _untimed(eng.evaluate())
        eng.observe_window(10)
        late = _untimed(eng.evaluate())
        return early, late, [v["check"] for v in eng.violations]

    early, late, viol = twin(scenario)
    assert early == [] and late[0]["ok"] is False and viol == ["eps_floor"]


def test_budget_checks_read_telemetry_gauges():
    def scenario(pkg):
        pkg.tel.enable()
        eng = pkg.slo.SloEngine(_spec(pkg, late_drop_budget=1,
                                      recompile_ceiling=0))
        pkg.tel.record_late_drop(2)
        pkg.tel.record_jit_call("k", ((4,),))
        return eng.evaluate(), _verdict(eng.verdict())

    rows, v = twin(scenario)
    rows = {r["check"]: r for r in rows}
    assert not rows["late_drop_budget"]["ok"]
    assert rows["late_drop_budget"]["value"] == 2
    assert not rows["recompile_ceiling"]["ok"]
    assert {x["check"] for x in v["violations"]} == {
        "late_drop_budget", "recompile_ceiling"}
    json.dumps(v)


def test_overflow_budget_reads_the_snapshot():
    def scenario(pkg):
        pkg.tel.enable()
        pkg.tel.record_compaction("eng", 8, 3)
        eng = pkg.slo.SloEngine(_spec(pkg, overflow_budget=0))
        return eng.evaluate()

    assert twin(scenario)[0]["ok"] is True


def test_recovery_transition_emits_event_but_keeps_violation():
    def scenario(pkg):
        pkg.tel.enable()
        eng = pkg.slo.install(pkg.slo.SloEngine(_spec(
            pkg, late_drop_budget=0)))
        pkg.tel.record_late_drop(1)
        eng.evaluate()
        eng.spec = _spec(pkg, late_drop_budget=5)
        eng.evaluate()
        return _verdict(eng.verdict()), _slo_instants(pkg.tel)

    v, instants = twin(scenario)
    assert [n for n, _ in instants] == ["slo_violation:late_drop_budget",
                                        "slo_recovered:late_drop_budget"]
    assert v["ok"] is False


def test_compliant_run_verdict_ok():
    def scenario(pkg):
        pkg.tel.enable()
        eng = pkg.slo.install(pkg.slo.SloEngine(_spec(
            pkg, watermark_lag_p99_ms=10_000, eps_floor=0.001,
            late_drop_budget=0, overflow_budget=0, recompile_ceiling=64)))
        for _ in range(10):
            eng.observe_window(1000, lag_ms=1.0)
        return _verdict(eng.verdict())

    v = twin(scenario)
    assert v["ok"] is True and v["violations"] == []
    assert v["windows"] == 10 and v["points"] == 10_000


def test_slo_violation_steps_the_installed_controller():
    def scenario(pkg):
        pkg.tel.enable()
        ctrl = pkg.ov.install(pkg.ov.OverloadController(pkg.ov.OverloadPolicy(
            ladder=({"action": "batch_slides", "n": 2},),
            degrade_cooldown=1)))
        eng = pkg.slo.SloEngine(_spec(pkg, late_drop_budget=0))
        pkg.tel.record_late_drop(1)
        eng.evaluate()
        return ctrl.snapshot()

    assert twin(scenario)["rung"] == 1


# -- window-fire hook ---------------------------------------------------------


def test_hook_free_when_no_engine_installed():
    assert slo.engine() is None
    slo.on_window_fired(100, lag_ms=5.0)


def test_object_assembler_feeds_engine():
    def scenario(pkg):
        pkg.tel.enable()
        eng = pkg.slo.install(pkg.slo.SloEngine(_spec(pkg)))
        asm = pkg.Asm(pkg.Tumbling(10), timestamp_fn=lambda e: e.timestamp)
        asm.feed(pkg.Point(obj_id="a", timestamp=1, x=0.0, y=0.0))
        asm.feed(pkg.Point(obj_id="a", timestamp=25, x=0.0, y=0.0))
        return eng.windows, eng.points, eng.lag.count

    assert twin(scenario) == (1, 1, 1)


def test_soa_assembler_feeds_engine():
    def scenario(pkg):
        pkg.tel.enable()
        eng = pkg.slo.install(pkg.slo.SloEngine(_spec(pkg)))
        asm = pkg.Soa(10, 5)
        asm.feed({"ts": np.asarray([1, 3, 9], np.int64), "x": np.zeros(3),
                  "y": np.zeros(3), "oid": np.zeros(3, np.int32)})
        asm.feed({"ts": np.asarray([27], np.int64), "x": np.zeros(1),
                  "y": np.zeros(1), "oid": np.zeros(1, np.int32)})
        before = eng.lag.count
        asm.flush()
        return eng.windows, eng.points, before, eng.lag.count

    windows, points, before, after = twin(scenario)
    assert windows >= 1 and points >= 3 and after == before


# -- ledger integration -------------------------------------------------------


def test_installed_engine_verdict_rides_the_port_ledger_and_health_slo(
        tmp_path):
    from tools.sfprof.cli import main as sfprof_main

    telemetry.enable()
    slo.install(slo.SloEngine(_spec(PORT, eps_floor=1e15)))
    eng = slo.engine()
    for _ in range(3):
        eng.observe_window(1)
    path = str(tmp_path / "ledger.json")
    telemetry.write_ledger(path, bench={"value": 1.0,
                                        "points_per_sec": 1.0})
    with open(path) as f:
        doc = json.load(f)
    assert doc["slo"]["ok"] is False
    assert doc["slo"]["spec"]["eps_floor"] == 1e15
    spec_path = tmp_path / "spec.json"
    spec_path.write_text(json.dumps({"name": "gate", "eps_floor": 1e15}))
    assert sfprof_main(["health", path, "--slo", str(spec_path)]) == 1
    assert sfprof_main(["health", path]) == 0
    ok_spec = tmp_path / "ok.json"
    ok_spec.write_text(json.dumps({"name": "gate", "late_drop_budget": 9}))
    assert sfprof_main(["health", path, "--slo", str(ok_spec)]) == 1


def test_verdict_seals_into_the_port_stream(tmp_path):
    stream = str(tmp_path / "s.jsonl")
    telemetry.enable(stream_path=stream, stream_flush_interval_s=0.0)
    slo.install(slo.SloEngine(_spec(PORT, late_drop_budget=0)))
    telemetry.record_late_drop(1)
    slo.engine().observe_window(1)
    telemetry.disable()
    with open(stream) as f:
        recs = [json.loads(line) for line in f]
    assert recs[-1]["t"] == "epilogue"
    assert recs[-1]["slo"]["ok"] is False


def test_driver_budgets_live_and_posthoc_twin():
    def scenario(pkg):
        pkg.tel.enable()
        pkg.tel.record_driver_retry(0, 1, "err")
        pkg.tel.record_driver_failover(0, "err")
        eng = pkg.slo.SloEngine(pkg.slo.SloSpec(
            retry_budget=1, failover_budget=0, eval_interval_s=0.0))
        return eng.evaluate()

    rows = {r["check"]: r for r in twin(scenario)}
    assert rows["retry_budget"]["ok"] is True
    assert rows["failover_budget"]["ok"] is False
    doc = {"snapshot": telemetry.snapshot(), "bench": {}}
    prows = {name: ok for name, _v, _b, ok in sfprof_slo.evaluate(
        {"retry_budget": 1, "failover_budget": 0}, doc)}
    assert prows == {"slo:retry_budget": True,
                     "slo:failover_budget": False}


def test_driver_counts_feed_the_budgets_through_a_run():
    """The retry and failover budgets read what the port's driver counts
    (a failover on the toy range pipeline)."""
    from spatialflink_tpu_torch.driver import (
        RetryPolicy,
        WindowedDataflowDriver,
        _toy_pipeline,
    )
    from spatialflink_tpu_torch.faults import faults
    from spatialflink_tpu_torch.operators import PointPointRangeQuery

    telemetry.enable()
    eng = slo.install(slo.SloEngine(slo.SloSpec(
        retry_budget=0, failover_budget=0, eval_interval_s=0.0)))
    grid, conf, source, query = _toy_pipeline()
    drv = WindowedDataflowDriver(retry=RetryPolicy(max_retries=1,
                                                   backoff_s=0.0))
    faults.arm([{"point": "driver.window", "at": 1, "times": 10**9}])
    try:
        list(PointPointRangeQuery(conf, grid, device="cpu").run(
            source(), [query], 1.5, driver=drv))
    finally:
        faults.disarm()
    rows = {r["check"]: r for r in eng.verdict()["checks"]}
    assert rows["retry_budget"]["value"] == drv.stats["retries"] == 1
    assert rows["failover_budget"]["value"] == drv.stats["failovers"] == 1
    assert not rows["retry_budget"]["ok"]
    assert not rows["failover_budget"]["ok"]


# -- per-tenant and per-node budgets -------------------------------------------


def test_tenant_budgets_read_the_class_counters():
    def scenario(pkg):
        pkg.tel.enable()
        spec = _spec(pkg, tenant_budgets={"bulk": {"shed_budget": 3,
                                                   "degraded_window_budget": 0},
                                          "gold": {"shed_budget": 0}})
        silent = pkg.slo.SloEngine(spec).evaluate()
        ctrl = pkg.ov.install(pkg.ov.OverloadController(pkg.ov.OverloadPolicy(
            tenant_budgets={"bulk": {"max_queries": 1,
                                     "max_results_per_window": 5}})))
        ctrl.admit_tenant_query("bulk")
        ctrl.admit_tenant_query("bulk")
        ctrl.tenant_result_allowance("bulk", 9, window_start=1000)
        return silent, pkg.slo.SloEngine(spec).evaluate()

    silent, rows = twin(scenario)
    assert all(r["ok"] is False and r["value"] is None for r in silent)
    rows = {r["check"]: r for r in rows}
    assert rows["tenant_shed_budget:bulk"]["value"] == 5
    assert rows["tenant_shed_budget:gold"]["ok"] is True


def test_node_budgets_violate_with_no_dag():
    def scenario(pkg):
        pkg.tel.enable()
        eng = pkg.slo.SloEngine(_spec(pkg, warmup_windows=1, node_budgets={
            "q1": {"retry_budget": 3, "e2e_p99_ms": 5},
            "q2": {"watermark_lag_p99_ms": 100}}))
        eng.observe_window(10)
        early = eng.evaluate()
        eng.observe_window(10)
        return early, eng.evaluate()

    early, late = twin(scenario)
    assert [r["check"] for r in early] == [
        "node_retry_budget:q1", "node_watermark_lag_p99_ms:q2"]
    assert [r["check"] for r in late] == [
        "node_retry_budget:q1", "node_e2e_p99_ms:q1",
        "node_watermark_lag_p99_ms:q2"]
    assert all(r["ok"] is False and r["value"] is None for r in late)


def test_node_budgets_pass_with_a_dag(tmp_path):
    """The same two-node DAG through each package (a node failing over to
    its twin beside a clean one), installed: the node budgets read the
    DAG's counters, equal in both packages; the clean node passes every
    budget and the failed-over node violates its failover budget."""
    from spatialflink_tpu import dag as jdag
    from spatialflink_tpu.driver import RetryPolicy as JRetry
    from spatialflink_tpu.grid import UniformGrid as JGrid
    from spatialflink_tpu.operators.query_config import (
        QueryConfiguration as JConf,
        QueryType as JQT,
    )
    from spatialflink_tpu_torch import dag as tdag
    from spatialflink_tpu_torch.driver import RetryPolicy
    from spatialflink_tpu_torch.grid import UniformGrid
    from spatialflink_tpu_torch.operators.query_config import (
        QueryConfiguration,
        QueryType,
    )

    mods = {id(JAX): (jdag, JRetry, JGrid, JConf, JQT),
            id(PORT): (tdag, RetryPolicy, UniformGrid, QueryConfiguration,
                       QueryType)}

    def scenario(pkg):
        dag_mod, Retry, Grid, Conf, QT = mods[id(pkg)]

        def node(name, sick):
            def fn(win, results):
                if sick:
                    raise RuntimeError("dead device path")
                return len(win.events)

            return dag_mod.FunctionNode(
                name, fn, fallback=lambda win, results: len(win.events))

        dag = dag_mod.DataflowDAG(
            Conf(QT.WindowBased, window_size=2.0, slide_step=1.0),
            Grid(8, 0.0, 8.0, 0.0, 8.0),
            [node("sick", True), node("ok", False)],
            out_dir=str(tmp_path / pkg.slo.__name__),
            retry=Retry(max_retries=1, backoff_s=0.0, sleep=lambda s: None))
        pts = [pkg.Point(obj_id=f"o{i % 5}", timestamp=100 * i,
                         x=float(i % 8), y=float(i % 7)) for i in range(60)]
        try:
            list(dag.run(iter(pts)))
            budgets = {"retry_budget": 1, "failover_budget": 0,
                       "degraded_window_budget": 0,
                       "watermark_lag_p99_ms": 5_000}
            rows = pkg.slo.SloEngine(_spec(pkg, node_budgets={
                "ok": budgets, "sick": budgets})).evaluate()
        finally:
            dag_mod.uninstall()
        return rows

    rows = {r["check"]: r for r in twin(scenario)}
    assert len(rows) == 8
    for key in ("retry_budget", "failover_budget", "degraded_window_budget",
                "watermark_lag_p99_ms"):
        assert rows[f"node_{key}:ok"]["ok"] is True, key
        assert rows[f"node_{key}:ok"]["value"] is not None
    assert rows["node_failover_budget:sick"]["ok"] is False
    assert rows["node_failover_budget:sick"]["value"] == 1


# -- latency lineage (e2e ceilings) -------------------------------------------


def test_e2e_ceiling_live_warmup_grace_then_silence_fails():
    def scenario(pkg):
        pkg.tel.enable()
        eng = pkg.slo.SloEngine(_spec(pkg, e2e_p99_ms=1e9, warmup_windows=2))
        eng.observe_window(10)
        early = eng.evaluate()
        for _ in range(3):
            eng.observe_window(10)
        return early, eng.evaluate()

    early, rows = twin(scenario)
    assert early == []
    assert rows == [{"check": "e2e_p99_ms", "value": None, "bound": "<= 1e+09",
                     "ok": False}]


def test_e2e_ceiling_live_pass_and_deterministic_violation():
    def scenario(pkg):
        pkg.tel.enable()
        eng = pkg.slo.SloEngine(_spec(pkg, e2e_p99_ms=1e9))
        eng.observe_window(10)
        pkg.tel.record_e2e(10_000, "commit")
        ok_rows = eng.evaluate()
        pkg.tel.record_e2e(0, "commit")
        eng2 = pkg.slo.SloEngine(_spec(pkg, e2e_p99_ms=1_000))
        eng2.observe_window(10)
        bad = eng2.evaluate()[0]
        return ok_rows[0]["ok"], bad["ok"], bad["value"] >= 9_000.0

    assert twin(scenario) == (True, False, True)
