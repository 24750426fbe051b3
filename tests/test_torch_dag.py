"""The composed dataflow DAG in the port (``spatialflink_tpu_torch/dag.py``)
against the JAX package's (``spatialflink_tpu/dag.py``), on the CPU.

One case for each of ``tests/test_dag.py``'s: topology and its loud
errors, per-node retry, failover and breaker independence, the atomic
unit checkpoint (multi-sink exactly-once, kill anywhere), the one intern
home, node parity (device path against the numpy twin), the stateful
CheckIn node, per-node SLO budgets live and through ``tools/sfprof``, and
``streaming_job`` option 10. The port's device nodes run with
``device="cpu"``.

Then the parity cases:
- the toy stream through both packages' ``build_sncb_dag``: q1–q5 and
  staytime byte-identical; the qserve sink equal in every field but the
  distance, which is within one float32 ulp (the JAX node is given
  ``dtype=np.float32``, as the port always computes in float32; the JAX
  registry program rounds some distances one ulp apart on these
  non-lattice coordinates, the tolerance of ``tests/test_torch_qserve.py``
  off its lattice);
- ``dag_state()`` and ``snapshot()["dag"]`` equal, the wall-clock e2e
  fields aside;
- the chaos matrix's qserve-register kill (``tests/test_chaos_matrix.py``
  ``test_dag_qserve_register_kill_under_armed_policies``) under armed
  overload and pipeline policies, in child processes, every sink equal to
  the clean child's, and the clean child's shed-dependent sinks equal to
  the JAX DAG's under the same policy;
- a JAX DAG run stopped at a checkpoint and resumed in the port through
  ``state.load_jax_checkpoint``, every sink equal to the JAX
  uninterrupted run (qserve within the ulp above).

Every test leaves both packages' DAG, qserve, overload, fault and
telemetry slots clean.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from spatialflink_tpu import dag as jdag
from spatialflink_tpu import driver as jdriver
from spatialflink_tpu import overload as jov
from spatialflink_tpu import qserve as jqs
from spatialflink_tpu.faults import InjectedFault as JInjected
from spatialflink_tpu.faults import faults as jfaults
from spatialflink_tpu.telemetry import telemetry as jtel

from spatialflink_tpu_torch import dag as dag_mod
from spatialflink_tpu_torch import overload, qserve
from spatialflink_tpu_torch.checkpoint import (
    CheckpointCorruptError,
    load_checkpoint,
    save_checkpoint,
)
from spatialflink_tpu_torch.dag import (
    DataflowDAG,
    FunctionNode,
    StayTimeNode,
    _toy_sncb_stream,
    build_sncb_dag,
)
from spatialflink_tpu_torch.driver import (
    RetryPolicy,
    WindowedDataflowDriver,
)
from spatialflink_tpu_torch.faults import (
    ABORT_EXIT_CODE,
    InjectedFault,
    faults,
)
from spatialflink_tpu_torch.grid import UniformGrid
from spatialflink_tpu_torch.models.objects import Point
from spatialflink_tpu_torch.operators.query_config import (
    QueryConfiguration,
    QueryType,
)
from spatialflink_tpu_torch.state import load_jax_checkpoint
from spatialflink_tpu_torch.streams.sinks import (
    MultiSink,
    TransactionalFileSink,
)
from spatialflink_tpu_torch.telemetry import telemetry

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

#: Each child process's own bound (the smoke's three children run ~5 s
#: each on a CPU).
CHILD_TIMEOUT_S = 120


@pytest.fixture(autouse=True)
def _clean():
    yield
    for f in (faults, jfaults):
        f.disarm()
    for tel in (telemetry, jtel):
        tel.enable()  # resets every counter, so none outlives the test
        tel.disable()
    for mod in (dag_mod, jdag):
        mod.uninstall()
    for mod in (qserve, jqs):
        mod.uninstall()
    for mod in (overload, jov):
        mod.uninstall()


# ---------------------------------------------------------------------------
# Toy two-node function DAG (the fast unit harness of tests/test_dag.py)


def _toy_conf():
    return QueryConfiguration(QueryType.WindowBased, window_size=2.0,
                              slide_step=1.0)


def _toy_points(n=60):
    rng = np.random.default_rng(5)
    xs = rng.uniform(0.0, 8.0, n)
    ys = rng.uniform(0.0, 8.0, n)
    return [
        Point(obj_id=f"o{i % 5}", timestamp=100 * i,
              x=float(xs[i]), y=float(ys[i]))
        for i in range(n)
    ]


def _count_node(name, fail_windows=(), fallback=True, upstream=None):
    """A node counting window events; optionally raising on the given
    window starts (device path only)."""

    def fn(win, results):
        if win.start in fail_windows:
            raise RuntimeError(f"boom@{win.start}")
        return ("device", len(win.events))

    def fb(win, results):
        return ("fallback", len(win.events))

    def render(result, start, end):
        yield f"{start},{end},{result[1]}"

    return FunctionNode(name, fn, fallback=fb if fallback else None,
                        render_fn=render, upstream=upstream)


def _toy_dag(tmp_path, nodes):
    grid = UniformGrid(8, 0.0, 8.0, 0.0, 8.0)
    return DataflowDAG(_toy_conf(), grid, nodes,
                       out_dir=str(tmp_path / "egress"),
                       retry=RetryPolicy(max_retries=1, backoff_s=0.0,
                                         sleep=lambda s: None))


class TestTopology:
    def test_upstream_orders_nodes_and_passes_results(self, tmp_path):
        seen = {}

        def down_fn(win, results):
            seen[win.start] = results["up"]
            return results["up"] * 2

        up = FunctionNode("up", lambda win, results: len(win.events))
        down = FunctionNode("down", down_fn, upstream="up")
        # Constructed downstream-first: the sort still runs `up` first.
        dag = _toy_dag(tmp_path, [down, up])
        assert dag.dag_nodes == ("up", "down")
        out = list(dag.run(iter(_toy_points())))
        assert out and seen
        for res in out:
            assert res.counts["up"] >= 1
            assert seen[res.start] >= 1

    def test_cycle_and_unknown_upstream_are_loud(self, tmp_path):
        a = FunctionNode("a", lambda w, r: 1, upstream="b")
        b = FunctionNode("b", lambda w, r: 1, upstream="a")
        with pytest.raises(ValueError, match="cycle"):
            _toy_dag(tmp_path, [a, b])
        c = FunctionNode("c", lambda w, r: 1, upstream="ghost")
        with pytest.raises(ValueError, match="unknown upstream"):
            _toy_dag(tmp_path, [c])

    def test_duplicate_names_rejected(self, tmp_path):
        with pytest.raises(ValueError, match="duplicate"):
            _toy_dag(tmp_path, [FunctionNode("x", lambda w, r: 1),
                                FunctionNode("x", lambda w, r: 2)])


class TestPerNodeSelfHealing:
    def test_failover_is_node_local(self, tmp_path):
        telemetry.enable()
        sick = _count_node("sick", fail_windows=range(-10**9, 10**9))
        healthy = _count_node("healthy")
        dag = _toy_dag(tmp_path, [sick, healthy])
        out = list(dag.run(iter(_toy_points())))
        assert len(out) > 3
        snap = dag.snapshot()
        assert snap["nodes"]["sick"]["backend"] == "fallback"
        assert snap["nodes"]["sick"]["failovers"] == 1
        assert snap["nodes"]["sick"]["degraded_windows"] == len(out)
        assert snap["nodes"]["healthy"]["backend"] == "device"
        assert snap["nodes"]["healthy"]["degraded_windows"] == 0
        assert snap["nodes"]["sick"]["retries"] == 1
        names = [e["name"] for e in telemetry.events]
        assert "dag_node_failover:sick" in names
        sick_lines = (tmp_path / "egress" / "sick.csv").read_bytes()
        ok_lines = (tmp_path / "egress" / "healthy.csv").read_bytes()
        assert sick_lines.count(b"\n") == ok_lines.count(b"\n") > 0

    def test_transient_fault_is_retried_node_locally(self, tmp_path):
        sick = _count_node("sick")
        calls = {"n": 0}
        real = sick._fn

        def flaky(win, results):
            calls["n"] += 1
            if calls["n"] == 3:
                raise RuntimeError("transient")
            return real(win, results)

        sick._fn = flaky
        dag = _toy_dag(tmp_path, [sick])
        out = list(dag.run(iter(_toy_points())))
        assert len(out) > 3
        snap = dag.snapshot()
        assert snap["nodes"]["sick"]["retries"] == 1
        assert snap["nodes"]["sick"]["failovers"] == 0
        assert snap["nodes"]["sick"]["backend"] == "device"

    def test_no_fallback_node_crashes_the_run(self, tmp_path):
        sick = _count_node("sick", fail_windows=range(-10**9, 10**9),
                           fallback=False)
        dag = _toy_dag(tmp_path, [sick])
        with pytest.raises(RuntimeError, match="boom"):
            list(dag.run(iter(_toy_points())))

    def test_stateful_node_is_never_retried(self, tmp_path):
        hits = {"n": 0}

        def stateful(win, results):
            hits["n"] += 1
            raise RuntimeError("half-applied")

        dag = _toy_dag(tmp_path, [FunctionNode("state", stateful,
                                               idempotent=False)])
        with pytest.raises(RuntimeError, match="half-applied"):
            list(dag.run(iter(_toy_points())))
        assert hits["n"] == 1

    def test_driver_never_reruns_the_node_walk(self, tmp_path):
        sick = _count_node("sick", fail_windows=range(-10**9, 10**9),
                           fallback=False)
        dag = _toy_dag(tmp_path, [sick])
        drv = WindowedDataflowDriver(
            retry=RetryPolicy(max_retries=5, backoff_s=0.0))
        with pytest.raises(RuntimeError, match="boom"):
            list(dag.run(iter(_toy_points()), driver=drv))
        assert drv.stats["retries"] == 0

    def test_breaker_is_per_node(self, tmp_path):
        sick = _count_node("sick", fail_windows=range(-10**9, 10**9))
        healthy = _count_node("healthy")
        dag = _toy_dag(tmp_path, [sick, healthy])
        ctrl = overload.OverloadController(overload.OverloadPolicy(
            breaker_failures=2, breaker_probe_every=1000,
        ))
        drv = WindowedDataflowDriver(
            retry=RetryPolicy(max_retries=0, backoff_s=0.0), overload=ctrl)
        out = list(dag.run(iter(_toy_points()), driver=drv))
        assert len(out) > 4
        snap = dag.snapshot()
        assert snap["nodes"]["sick"]["breaker"]["state"] == "open"
        assert snap["nodes"]["sick"]["backend"] == "device"
        assert snap["nodes"]["healthy"]["breaker"]["state"] == "closed"
        assert snap["nodes"]["sick"]["degraded_windows"] == len(out)


# ---------------------------------------------------------------------------
# The atomic unit checkpoint (multi-sink exactly-once)


SNCB_SINKS = ("q1", "q2", "q3", "q4", "q5", "staytime", "qserve")


def _run_sncb_leg(workdir, fault_plan=None, n_events=150):
    dag = build_sncb_dag(
        os.path.join(workdir, "egress"), qserve_queries=None,
        retry=RetryPolicy(max_retries=1, backoff_s=0.0), device="cpu",
    )
    driver = WindowedDataflowDriver(
        checkpoint_path=os.path.join(workdir, "ckpt.bin"),
        checkpoint_every=2, sink=None,
        retry=RetryPolicy(max_retries=1, backoff_s=0.0), failover=False,
    )
    if fault_plan:
        faults.arm(fault_plan)
    try:
        for _ in dag.run(_toy_sncb_stream(n_events)(), driver=driver):
            pass
    finally:
        faults.disarm()
        qserve.uninstall()
        dag_mod.uninstall()
    return driver, dag


def _sink_bytes(workdir, names=SNCB_SINKS):
    out = {}
    for name in names:
        with open(os.path.join(workdir, "egress", f"{name}.csv"),
                  "rb") as f:
            out[name] = f.read()
    return out


@pytest.fixture(scope="module")
def sncb_clean(tmp_path_factory):
    """One clean 7-node port run shared by the kill and resume legs."""
    d = tmp_path_factory.mktemp("dag_clean")
    _run_sncb_leg(str(d))
    want = _sink_bytes(str(d))
    assert all(len(v) > 0 for v in want.values()), {
        k: len(v) for k, v in want.items()}
    return want


class TestUnitCheckpoint:
    @pytest.mark.parametrize("plan", [
        # Between-sink-commits cut: the second unit commit's 2nd
        # sub-append (7 sinks a commit, so hit 9).
        [{"point": "dag.commit", "at": 9, "times": 10_000}],
        # Mid-node-walk kill (some nodes already staged this window).
        [{"point": "dag.node", "at": 25, "times": 10_000}],
        # Kill mid-registration-churn inside the DAG.
        [{"point": "qserve.register", "at": 11, "times": 10_000}],
    ])
    def test_kill_anywhere_resumes_every_sink_exactly(
            self, tmp_path, sncb_clean, plan):
        with pytest.raises(InjectedFault):
            _run_sncb_leg(str(tmp_path), fault_plan=plan)
        drv, _dag = _run_sncb_leg(str(tmp_path))
        assert drv.stats["resumed"] is True
        assert _sink_bytes(str(tmp_path)) == sncb_clean

    def test_unit_checkpoint_carries_all_components(self, tmp_path):
        _run_sncb_leg(str(tmp_path))
        ck = load_checkpoint(os.path.join(str(tmp_path), "ckpt.bin"))
        assert set(ck["egress"]["sinks"]) == set(SNCB_SINKS)
        nodes = ck["op"]["dag"]["nodes"]
        assert set(nodes) == set(SNCB_SINKS)
        assert "substate" in nodes["qserve"]
        assert nodes["qserve"]["substate"]["queries"]
        for name, marker in ck["egress"]["sinks"].items():
            path = os.path.join(str(tmp_path), "egress", f"{name}.csv")
            assert marker["bytes"] == os.path.getsize(path)
        assert "interner" in ck["op"] and "assembler" in ck["op"]

    def test_one_intern_home(self, tmp_path):
        _, dag = _run_sncb_leg(str(tmp_path))
        interned = set(dag.interner._to_key)
        assert "dev0" in interned
        assert {"r0", "ta"} <= interned
        node = dag.node("qserve")
        assert node.op.interner is dag.interner
        assert node.registry.interner is dag.interner

    def test_resume_fallback_backend_without_twin_is_loud(self, tmp_path):
        sick = _count_node("sick", fail_windows=range(-10**9, 10**9))
        dag = _toy_dag(tmp_path, [sick])
        ck = str(tmp_path / "ck.bin")
        drv = WindowedDataflowDriver(checkpoint_path=ck, sink=None,
                                     checkpoint_every=1)
        list(dag.run(iter(_toy_points()), driver=drv))
        assert dag.snapshot()["nodes"]["sick"]["backend"] == "fallback"
        dag_mod.uninstall()
        twin_less = DataflowDAG(
            _toy_conf(), UniformGrid(8, 0.0, 8.0, 0.0, 8.0),
            [_count_node("sick", fallback=False)],
            out_dir=str(tmp_path / "egress2"))
        drv2 = WindowedDataflowDriver(checkpoint_path=ck, sink=None)
        with pytest.raises(ValueError, match="fallback"):
            list(twin_less.run(iter(_toy_points()), driver=drv2))

    def test_resume_with_missing_node_is_loud(self, tmp_path):
        _run_sncb_leg(str(tmp_path))
        small = DataflowDAG(_toy_conf(), UniformGrid(8, 0.0, 8.0, 0.0, 8.0),
                            [FunctionNode("q1", lambda w, r: 1)],
                            out_dir=str(tmp_path / "other"))
        drv = WindowedDataflowDriver(
            checkpoint_path=os.path.join(str(tmp_path), "ckpt.bin"),
            sink=None)
        with pytest.raises(ValueError, match="unknown DAG node"):
            list(small.run(iter([]), driver=drv))

    def test_driver_with_its_own_sink_is_refused(self, tmp_path):
        dag = _toy_dag(tmp_path, [_count_node("a")])
        drv = WindowedDataflowDriver(
            sink=TransactionalFileSink(str(tmp_path / "x.csv")))
        with pytest.raises(ValueError, match="MultiSink"):
            list(dag.run(iter(_toy_points()), driver=drv))


class TestMultiSink:
    def _pair(self, tmp_path):
        return MultiSink({
            "a": TransactionalFileSink(str(tmp_path / "a.csv")),
            "b": TransactionalFileSink(str(tmp_path / "b.csv")),
        })

    def test_torn_tail_on_a_newer_marker_on_b(self, tmp_path):
        ms = self._pair(tmp_path)
        ms.reset()
        ms.stage("a", "a1")
        ms.stage("b", "b1")
        marker = ms.commit()
        ms.stage("a", "a2")
        ms.stage("b", "b2")
        faults.arm([{"point": "dag.commit", "at": 2, "times": 10_000}])
        with pytest.raises(InjectedFault):
            ms.commit()
        faults.disarm()
        assert (tmp_path / "a.csv").read_bytes() == b"a1\na2\n"
        assert (tmp_path / "b.csv").read_bytes() == b"b1\n"
        ms2 = self._pair(tmp_path)
        ms2.restore(marker)
        assert (tmp_path / "a.csv").read_bytes() == b"a1\n"
        assert (tmp_path / "b.csv").read_bytes() == b"b1\n"
        ms2.stage("a", "a2")
        ms2.stage("b", "b2")
        ms2.commit()
        assert (tmp_path / "a.csv").read_bytes() == b"a1\na2\n"
        assert (tmp_path / "b.csv").read_bytes() == b"b1\nb2\n"

    def test_marker_ahead_of_file_is_loud(self, tmp_path):
        ms = self._pair(tmp_path)
        ms.reset()
        ms.stage("a", "a1" * 50)
        ms.stage("b", "b1")
        marker = ms.commit()
        (tmp_path / "a.csv").write_bytes(b"short")
        with pytest.raises(CheckpointCorruptError, match="out-of-band"):
            self._pair(tmp_path).restore(marker)

    def test_unknown_sink_in_restore_resets_fresh(self, tmp_path):
        ms = self._pair(tmp_path)
        ms.reset()
        ms.stage("a", "a1")
        marker = ms.commit()
        ms3 = MultiSink({
            "a": TransactionalFileSink(str(tmp_path / "a.csv")),
            "b": TransactionalFileSink(str(tmp_path / "b.csv")),
            "c": TransactionalFileSink(str(tmp_path / "c.csv")),
        })
        ms3.restore(marker)
        assert (tmp_path / "c.csv").read_bytes() == b""


# ---------------------------------------------------------------------------
# Node parity (device path vs numpy twin)


def _toy_window(n=90):
    from spatialflink_tpu_torch.streams.windows import WindowBatch

    evs = [e for e in _toy_sncb_stream(n)()
           if getattr(e, "device_id", None) is not None]
    return WindowBatch(0, 40_000, evs)


class TestNodeParity:
    def test_staytime_device_matches_host_walk(self, tmp_path):
        node = StayTimeNode("st", device="cpu")
        dag = build_sncb_dag(str(tmp_path / "egress"), device="cpu")
        node.bind(dag)
        win = _toy_window()
        dev = node.process(win, {})
        host = node.fallback_process(win, {})
        assert sorted(dev) == sorted(host)
        assert dev

    def test_zone_nodes_device_matches_numpy(self, tmp_path):
        dag = build_sncb_dag(str(tmp_path / "egress"), device="cpu")
        win = _toy_window()
        for name in ("q1", "q2", "q5"):
            node = dag.node(name)
            dev = node.process(win, {})
            twin = node.fallback_process(win, {})
            assert len(dev) > 0, name
            assert [repr(d) for d in dev] == [repr(t) for t in twin], name

    def test_nodes_match_the_jax_nodes(self, tmp_path):
        """Each node of the port's SNCB DAG renders the JAX node's lines
        over one window (StayTime through its segment-sum program, the
        zone nodes in float64)."""
        from spatialflink_tpu.streams.windows import WindowBatch as JWin

        tdag = build_sncb_dag(str(tmp_path / "t"), device="cpu")
        jd = jdag.build_sncb_dag(str(tmp_path / "j"))
        win = _toy_window()
        jevs = [e for e in jdag._toy_sncb_stream(90)()
                if getattr(e, "device_id", None) is not None]
        jwin = JWin(0, 40_000, jevs)
        for name in ("q1", "q2", "q3", "q4", "q5", "staytime"):
            got = list(tdag.node(name).render(
                tdag.node(name).process(win, {}), 0, 40_000))
            want = list(jd.node(name).render(
                jd.node(name).process(jwin, {}), 0, 40_000))
            assert got == want and got, name


# ---------------------------------------------------------------------------
# CheckIn node (stateful: occupancy + per-user last-event carry)


def _checkin_events(n=40):
    from spatialflink_tpu_torch.apps.checkin import CheckInEvent

    rooms = ("r1", "r2")
    evs = []
    for i in range(n):
        room = rooms[i % 2]
        direction = "in" if (i // 2) % 2 == 0 or i % 7 == 0 else "out"
        evs.append(CheckInEvent(
            event_id=f"e{i}", device_id=f"{room}-{direction}",
            user_id=f"u{i % 3}", timestamp=100 * i,
        ))
    return evs


class TestCheckInNode:
    def _dag(self, tmp_path, sub):
        from spatialflink_tpu_torch.dag import CheckInNode

        node = CheckInNode("checkin", {"r1": 10, "r2": 5})
        return DataflowDAG(_toy_conf(), UniformGrid(8, 0.0, 8.0, 0.0, 8.0),
                           [node], out_dir=str(tmp_path / sub)), node

    def test_matches_unwindowed_host_walk(self, tmp_path):
        from spatialflink_tpu_torch.apps.checkin import check_in_query

        evs = _checkin_events()
        want = [(room, cap, occ) for room, cap, occ, _t in check_in_query(
            iter(evs), {"r1": 10, "r2": 5})]
        dag, _node = self._dag(tmp_path, "egress")
        for _ in dag.run(iter(evs)):
            pass
        got = [ln.split(",")[2:] for ln in
               (tmp_path / "egress" / "checkin.csv").read_text().splitlines()]
        assert [(r, int(c), int(o)) for r, c, o in got] == want

    def test_kill_resumes_occupancy_exactly(self, tmp_path):
        evs = _checkin_events()

        def leg(sub, plan=None):
            dag, _node = self._dag(tmp_path, sub)
            drv = WindowedDataflowDriver(
                checkpoint_path=str(tmp_path / f"{sub}.ckpt"),
                checkpoint_every=2, sink=None, failover=False,
                retry=RetryPolicy(max_retries=1, backoff_s=0.0))
            if plan:
                faults.arm(plan)
            try:
                for _ in dag.run(iter(evs), driver=drv):
                    pass
            finally:
                faults.disarm()
            return drv

        leg("clean")
        want = (tmp_path / "clean" / "checkin.csv").read_bytes()
        assert want
        with pytest.raises(InjectedFault):
            leg("chaos", plan=[{"point": "dag.node", "at": 4,
                                "times": 10_000}])
        drv = leg("chaos")
        assert drv.stats["resumed"] is True
        assert (tmp_path / "chaos" / "checkin.csv").read_bytes() == want


# ---------------------------------------------------------------------------
# Per-node SLO budgets (live + sfprof twin) and telemetry surfaces


class TestNodeSlo:
    def test_live_node_budgets(self, tmp_path):
        from spatialflink_tpu_torch import slo

        telemetry.enable()
        sick = _count_node("sick", fail_windows=range(-10**9, 10**9))
        ok = _count_node("ok")
        dag = _toy_dag(tmp_path, [sick, ok])
        engine = slo.install(slo.SloEngine(slo.SloSpec(
            eval_interval_s=0.0,
            node_budgets={
                "sick": {"failover_budget": 0},
                "ok": {"failover_budget": 0, "degraded_window_budget": 0},
                "ghost": {"retry_budget": 1},
            },
        )))
        try:
            list(dag.run(iter(_toy_points())))
            rows = {r["check"]: r["ok"] for r in engine.evaluate()}
            assert rows["node_failover_budget:sick"] is False
            assert rows["node_failover_budget:ok"] is True
            assert rows["node_degraded_window_budget:ok"] is True
            assert rows["node_retry_budget:ghost"] is False
        finally:
            slo.uninstall()

    def test_live_node_budgets_without_dag_fail_on_silence(self):
        from spatialflink_tpu_torch import slo

        engine = slo.SloEngine(slo.SloSpec(
            eval_interval_s=0.0,
            node_budgets={"q1": {"watermark_lag_p99_ms": 10_000}}))
        rows = {r["check"]: r["ok"] for r in engine.evaluate()}
        assert rows["node_watermark_lag_p99_ms:q1"] is False

    def test_node_budget_validation_is_strict(self):
        from spatialflink_tpu_torch import slo

        with pytest.raises(ValueError, match="node_budgets"):
            slo.SloSpec(node_budgets={"q1": {"typo_budget": 1}})

    def test_ledger_and_sfprof_twin(self, tmp_path):
        telemetry.enable()
        sick = _count_node("sick", fail_windows=range(-10**9, 10**9))
        dag = _toy_dag(tmp_path, [sick])
        list(dag.run(iter(_toy_points())))
        ledger = tmp_path / "ledger.json"
        telemetry.write_ledger(str(ledger), capture_costs=False)
        doc = json.loads(ledger.read_text())
        nodes = doc["snapshot"]["dag"]["nodes"]
        assert nodes["sick"]["backend"] == "fallback"
        assert nodes["sick"]["failovers"] == 1

        from tools.sfprof import slo as sfslo

        rows = {name: ok for name, _v, _b, ok in sfslo.evaluate(
            {"node_budgets": {
                "sick": {"failover_budget": 0,
                         "watermark_lag_p99_ms": 10_000_000},
                "ghost": {"failover_budget": 0},
            }}, doc)}
        assert rows["slo:node_failover_budget:sick"] is False
        assert rows["slo:node_watermark_lag_p99_ms:sick"] is True
        assert rows["slo:node_failover_budget:ghost"] is False
        rows = sfslo.evaluate(
            {"node_budgets": {"sick": {"failover_budget": 0}}},
            {"snapshot": {}})
        assert rows == [("slo:node_failover_budget:sick", None,
                         "<= 0", False)]

    def test_sncb_node_budgets_pass_on_a_clean_run(self, tmp_path):
        """With the DAG installed, budgets on every SNCB node pass on a
        clean run: the budgets no longer violate by construction."""
        from spatialflink_tpu_torch import slo

        telemetry.enable()
        budgets = {name: {"retry_budget": 0, "failover_budget": 0,
                          "degraded_window_budget": 0,
                          "watermark_lag_p99_ms": 60_000}
                   for name in SNCB_SINKS}
        engine = slo.SloEngine(slo.SloSpec(eval_interval_s=0.0,
                                           node_budgets=budgets))
        _drv, dag = _run_sncb_leg(str(tmp_path))
        dag_mod.install(dag)
        rows = engine.evaluate()
        assert len(rows) == 4 * len(SNCB_SINKS)
        assert all(r["ok"] for r in rows), [r for r in rows if not r["ok"]]
        snap = telemetry.snapshot()["dag"]
        assert set(snap["nodes"]) == set(SNCB_SINKS)
        json.dumps(snap)  # json-safe


# ---------------------------------------------------------------------------
# streaming_job option 10 (tests/test_dag.py's, and against the JAX CLI)


def _write_conf(tmp_path, option=10):
    conf = tmp_path / "conf.yml"
    conf.write_text(f"""
backend: cpu
inputStream1:
  topicName: t
  format: CSV
  csvTsvSchemaAttr: [0, 1, 2, 3]
  gridBBox: [4.25, 50.75, 4.50, 50.95]
  numGridCells: 20
  delimiter: ","
query:
  option: {option}
  radius: 0.05
  k: 3
  queryPoints:
    - [4.37, 50.85]
window:
  type: "TIME"
  interval: 10
  step: 5
""")
    return conf


def _write_csv(tmp_path, n=120):
    rows = []
    for i in range(n):
        x = 4.354 if i % 3 == 0 else (4.404 if i % 3 == 1 else 4.30)
        y = 50.854 if i % 3 != 2 else 50.80
        rows.append(f"dev{i % 4},{i * 400},{x},{y}")
    csv = tmp_path / "in.csv"
    csv.write_text("\n".join(rows))
    return csv


class TestStreamingJobOption10:
    def test_option10_checkpointed_run(self, tmp_path):
        from spatialflink_tpu_torch.streaming_job import main

        conf = _write_conf(tmp_path)
        csv = _write_csv(tmp_path)
        out = tmp_path / "out"
        rc = main(["--config", str(conf), "--source", f"csv:{csv}",
                   "--output", str(out),
                   "--checkpoint", str(tmp_path / "ck.bin")])
        assert rc == 0
        for name in SNCB_SINKS:
            assert (out / f"{name}.csv").exists()
        assert (out / "q1.csv").read_bytes()
        assert (out / "qserve.csv").read_bytes()
        ck = load_checkpoint(str(tmp_path / "ck.bin"))
        assert set(ck["egress"]["sinks"]) == set(SNCB_SINKS)

    def test_option10_needs_output_dir(self, tmp_path):
        from spatialflink_tpu_torch.streaming_job import main

        conf = _write_conf(tmp_path)
        csv = _write_csv(tmp_path)
        with pytest.raises(SystemExit, match="directory"):
            main(["--config", str(conf), "--source", f"csv:{csv}"])

    def test_option10_equals_the_jax_cli(self, tmp_path):
        """The same YAML and CSV through both packages' CLI: every node
        file equal (qserve within one float32 ulp, the JAX node's dtype
        pinned to float32 through ``dag.QServeNode``'s default)."""
        from spatialflink_tpu.streaming_job import main as jmain
        from spatialflink_tpu_torch.streaming_job import main

        conf = _write_conf(tmp_path)
        csv = _write_csv(tmp_path)
        assert main(["--config", str(conf), "--source", f"csv:{csv}",
                     "--output", str(tmp_path / "t")]) == 0
        real = jdag.QServeNode.__init__.__defaults__
        jdag.QServeNode.__init__.__defaults__ = (*real[:2], np.float32)
        try:
            assert jmain(["--config", str(conf), "--source", f"csv:{csv}",
                          "--output", str(tmp_path / "j")]) == 0
        finally:
            jdag.QServeNode.__init__.__defaults__ = real
        for name in SNCB_SINKS:
            got = (tmp_path / "t" / f"{name}.csv").read_bytes()
            want = (tmp_path / "j" / f"{name}.csv").read_bytes()
            assert want or name not in ("q1", "q3", "qserve"), name
            if name == "qserve":
                assert_qserve_lines_close(got, want)
            else:
                assert got == want, name


# ---------------------------------------------------------------------------
# Parity with the JAX package's DAG


def assert_qserve_lines_close(got: bytes, want: bytes):
    """qserve egress lines equal in every field but the distance, which
    is within one float32 ulp."""
    g, w = got.decode().splitlines(), want.decode().splitlines()
    assert len(g) == len(w) and g
    for a, b in zip(g, w):
        ka, da = a.rsplit(",", 1)
        kb, db = b.rsplit(",", 1)
        assert ka == kb, (a, b)
        da, db = float(da), float(db)
        assert abs(da - db) <= np.spacing(np.float32(max(abs(da), abs(db)))
                                          ), (a, b)


def _jax_leg(workdir, fault_plan=None, n_events=150, policy=None):
    """The JAX package's 7-node DAG on the toy stream, qserve in float32."""
    dag = jdag.build_sncb_dag(
        os.path.join(workdir, "egress"), qserve_queries=None,
        retry=jdriver.RetryPolicy(max_retries=1, backoff_s=0.0))
    dag.node("qserve").dtype = np.float32
    ctrl = None if policy is None else jov.OverloadController(
        jov.OverloadPolicy.from_env(json.dumps(policy)))
    driver = jdriver.WindowedDataflowDriver(
        checkpoint_path=os.path.join(workdir, "ckpt.bin"),
        checkpoint_every=2, sink=None,
        retry=jdriver.RetryPolicy(max_retries=1, backoff_s=0.0),
        failover=False, overload=ctrl,
        source_pausable=False if policy else None)
    if fault_plan:
        jfaults.arm(fault_plan)
    try:
        for _ in dag.run(jdag._toy_sncb_stream(n_events)(), driver=driver):
            pass
    finally:
        jfaults.disarm()
        jqs.uninstall()
        jdag.uninstall()
        jov.uninstall()
    return driver, dag


def _assert_sinks_match_jax(got, want):
    for name in SNCB_SINKS:
        assert want[name], name
        if name == "qserve":
            assert_qserve_lines_close(got[name], want[name])
        else:
            assert got[name] == want[name], name


class TestJaxParity:
    def test_toy_stream_sinks_equal_the_jax_dag(self, tmp_path,
                                                sncb_clean):
        _jax_leg(str(tmp_path))
        _assert_sinks_match_jax(sncb_clean, _sink_bytes(str(tmp_path)))

    def test_dag_state_and_snapshot_equal_the_jax_dag(self, tmp_path):
        telemetry.enable()
        jtel.enable()
        _, tdag = _run_sncb_leg(str(tmp_path / "t"))
        _, jd = _jax_leg(str(tmp_path / "j"))

        def strip(snap):
            for rec in snap["nodes"].values():
                rec.pop("e2e_p50_ms", None)  # wall-clock staleness
                rec.pop("e2e_p99_ms", None)
            return snap

        assert strip(tdag.snapshot()) == strip(jd.snapshot())
        ts, js = tdag.dag_state(), jd.dag_state()
        tq = ts["nodes"]["qserve"].pop("substate")
        jq = js["nodes"]["qserve"].pop("substate")
        assert ts == js
        assert set(tq) == set(jq)
        assert tq["queries"] == jq["queries"] and tq["queries"]
        assert list(tdag.dag_nodes) == list(jd.dag_nodes) == list(SNCB_SINKS)

    def test_qserve_register_kill_under_armed_policies(self, tmp_path):
        """tests/test_chaos_matrix.py's fourth DAG cut in the port: an
        ``abort`` at ``qserve.register`` inside the DAG under armed
        overload and pipeline policies, child processes, every sink
        byte-identical after the resume; the clean child's sinks equal
        the JAX DAG's under the same overload policy (the shed schedule
        replays across packages)."""
        env = {**os.environ}
        env.pop("SFT_FAULT_PLAN", None)
        env.pop("SFT_LEDGER_STREAM", None)
        env["SFT_OVERLOAD_POLICY"] = json.dumps(dag_mod.SMOKE_OVERLOAD_POLICY)
        env["SFT_PIPELINE"] = json.dumps({"depth": 2, "fetch_lag": 2})

        def child(workdir, plan=None):
            e = dict(env)
            if plan:
                e["SFT_FAULT_PLAN"] = json.dumps(plan)
            return subprocess.run(
                [sys.executable, "-m", "spatialflink_tpu_torch.dag",
                 "--chaos-child", str(workdir), "--device", "cpu"],
                env=e, capture_output=True, text=True,
                timeout=CHILD_TIMEOUT_S, cwd=REPO)

        clean, chaos = tmp_path / "clean", tmp_path / "chaos"
        clean.mkdir()
        chaos.mkdir()
        p = child(clean)
        assert p.returncode == 0, p.stderr[-2000:]
        want = _sink_bytes(str(clean))
        assert all(want.values()), {k: len(v) for k, v in want.items()}
        p = child(chaos, plan=[{"point": "qserve.register", "kind": "abort",
                                "at": 11}])
        assert p.returncode == ABORT_EXIT_CODE, (p.returncode,
                                                 p.stderr[-2000:])
        p = child(chaos)
        assert p.returncode == 0, p.stderr[-2000:]
        assert _sink_bytes(str(chaos)) == want
        _jax_leg(str(tmp_path / "jax"), n_events=360,
                 policy=dag_mod.SMOKE_OVERLOAD_POLICY)
        _assert_sinks_match_jax(want, _sink_bytes(str(tmp_path / "jax")))

    def test_jax_checkpoint_resumes_in_the_port(self, tmp_path):
        """A JAX DAG run stopped by a fault after its first unit
        checkpoints, its checkpoint read through
        ``state.load_jax_checkpoint`` and resumed by the port's DAG on the
        same egress files: every sink equals the JAX uninterrupted run."""
        _jax_leg(str(tmp_path / "clean"))
        want = _sink_bytes(str(tmp_path / "clean"))
        work = str(tmp_path / "resume")
        with pytest.raises(JInjected):
            _jax_leg(work, fault_plan=[{"point": "dag.commit", "at": 16,
                                        "times": 10_000}])
        path = os.path.join(work, "ckpt.bin")
        comps = load_jax_checkpoint(path)
        assert "dag" in comps["op"]
        save_checkpoint(path, **comps)
        drv, _dag = _run_sncb_leg(work)
        assert drv.stats["resumed"] is True
        _assert_sinks_match_jax(_sink_bytes(work), want)


def test_smoke_runs_on_the_cpu():
    """``python -m spatialflink_tpu_torch.dag --smoke --device cpu``: the
    kill-between-sink-commits round trip with its ledger-stream gates."""
    p = subprocess.run(
        [sys.executable, "-m", "spatialflink_tpu_torch.dag", "--smoke",
         "--device", "cpu"],
        capture_output=True, text=True, timeout=CHILD_TIMEOUT_S, cwd=REPO)
    assert p.returncode == 0, p.stdout[-2000:] + p.stderr[-2000:]
    assert "byte-identical on all 7 sinks" in p.stdout
    assert "mesh collectives accounted" in p.stdout


def test_mesh_leg_raises_naming_a12():
    """The mesh leg is ported (its CPU run is in
    ``tests/test_torch_parallel_operators.py``): on the card by default,
    which raises on a machine without one rather than run on the CPU."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device exists")
    with pytest.raises(RuntimeError, match="is_available"):
        dag_mod.run_mesh_child()


def test_card_default_raises_without_a_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device exists")
    with pytest.raises(RuntimeError, match="cuda"):
        build_sncb_dag("unused")
