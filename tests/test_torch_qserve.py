"""Standing-query serving in the port (``spatialflink_tpu_torch/qserve.py``)
against the JAX package's (``spatialflink_tpu/qserve.py``), on the CPU,
with ``tests/test_qserve.py`` as the oracle, test for test (its mesh case
is in ``tests/test_torch_parallel_operators.py``; its ``streaming_job`` case is in
``tests/test_torch_streaming_job.py`` and the kernel cases are in
``tests/test_torch_query_registry.py``).

Most cases run through both packages (``twin``): the same queries,
commands and ``Point`` streams, made from numpy seeds on a 1/64 lattice
(centred coordinates with at most 9 significant bits, so x² + y² is exact
in float32 and the JAX program's FMA cannot round a distance
differently), into each package's operator with ``dtype=np.float32``
(the port always computes in float32; the tests run under x64). The
egress lines, the registry's ``state()``, the ``snapshot()["qserve"]``
blocks and the overload controller's tenant blocks are held equal.

Then the port's own: the ``qserve`` checkpoint component, a kill mid-churn
resumed to byte-identical egress, a JAX checkpoint resumed by the port,
the ``qserve.register`` fault point, ``tools/sfprof`` reading the port's
ledger, the host-memory rule for the flag tables, ``mesh=`` refusing a
value that is not a mesh, and the 1,024-query acceptance shape at full
size.
"""

import json
import os
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spatialflink_tpu import driver as jdriver
from spatialflink_tpu import overload as jov
from spatialflink_tpu import qserve as jqs
from spatialflink_tpu import slo as jslo
from spatialflink_tpu.faults import InjectedFault as JInjected
from spatialflink_tpu.faults import faults as jfaults
from spatialflink_tpu.grid import UniformGrid as JGrid
from spatialflink_tpu.models.objects import Point as JPoint
from spatialflink_tpu.operators.query_config import (
    QueryConfiguration as JConf,
    QueryType as JQT,
)
from spatialflink_tpu.ops import query_registry as jqr
from spatialflink_tpu.streams.sinks import TransactionalFileSink as JSink
from spatialflink_tpu.telemetry import telemetry as jtel
from spatialflink_tpu.utils.interning import Interner as JInterner

from spatialflink_tpu_torch import driver as tdriver
from spatialflink_tpu_torch import overload, qserve, slo
from spatialflink_tpu_torch.checkpoint import (
    load_checkpoint,
    operator_state,
    restore_operator,
    save_checkpoint,
)
from spatialflink_tpu_torch.faults import InjectedFault, faults
from spatialflink_tpu_torch.grid import UniformGrid
from spatialflink_tpu_torch.models.objects import Point
from spatialflink_tpu_torch.operators.query_config import (
    QueryConfiguration,
    QueryType,
)
from spatialflink_tpu_torch.ops import query_registry as tqr
from spatialflink_tpu_torch.ops.compaction import (
    capacity_ladder,
    pick_capacity,
)
from spatialflink_tpu_torch.state import load_jax_checkpoint
from spatialflink_tpu_torch.streams.sinks import TransactionalFileSink
from spatialflink_tpu_torch.telemetry import telemetry
from spatialflink_tpu_torch.utils.interning import Interner

JAX = SimpleNamespace(
    name="jax", qs=jqs, ov=jov, slo=jslo, tel=jtel, faults=jfaults,
    Injected=JInjected, Point=JPoint, Interner=JInterner, drv=jdriver,
    Sink=JSink, grid=lambda: JGrid(10, 0.0, 10.0, 0.0, 10.0),
    conf=lambda **kw: JConf(JQT.WindowBased, window_size=2.0,
                            slide_step=1.0, **kw),
    op_kw={})
PORT = SimpleNamespace(
    name="port", qs=qserve, ov=overload, slo=slo, tel=telemetry,
    faults=faults, Injected=InjectedFault, Point=Point, Interner=Interner,
    drv=tdriver, Sink=TransactionalFileSink,
    grid=lambda: UniformGrid(10, 0.0, 10.0, 0.0, 10.0),
    conf=lambda **kw: QueryConfiguration(QueryType.WindowBased,
                                         window_size=2.0, slide_step=1.0,
                                         **kw),
    op_kw={"device": "cpu"})


@pytest.fixture(autouse=True)
def _clean():
    yield
    for pkg in (JAX, PORT):
        pkg.faults.disarm()
        pkg.qs.uninstall()
        pkg.ov.uninstall()
        pkg.slo.uninstall()
        pkg.tel.enable()
        pkg.tel.disable()


def twin(scenario):
    """``scenario(pkg)`` through both packages, JAX first, each with
    clean module slots."""
    out = []
    for pkg in (JAX, PORT):
        pkg.qs.uninstall()
        pkg.ov.uninstall()
        out.append(scenario(pkg))
        pkg.qs.uninstall()
        pkg.ov.uninstall()
    return out


def _op(pkg, **kw):
    conf_kw = kw.pop("conf", {})
    return pkg.qs.QServeOperator(pkg.conf(**conf_kw), pkg.grid(),
                                 **kw, **pkg.op_kw)


def _lat(rng, lo, hi):
    return float(rng.integers(lo * 64, hi * 64) / 64)


def _mk_query(pkg, i, rng, kind=None, k=5, radius=None,
              tenant_class="default"):
    return pkg.qs.StandingQuery(
        qid=f"q{i}", tenant=f"t{i % 3}",
        kind=kind or ("knn" if i % 2 else "range"),
        x=_lat(rng, 1, 9), y=_lat(rng, 1, 9),
        radius=float(radius if radius is not None
                     else rng.integers(32, 160) / 64),
        k=k, tenant_class=tenant_class)


def _point_stream(pkg, rng, n=120, tmax_ms=12_000):
    for i in range(n):
        yield pkg.Point(obj_id=f"o{i % 13}", timestamp=(tmax_ms * i) // n,
                        x=_lat(rng, 0, 10), y=_lat(rng, 0, 10))


def _register_cmds(pkg, queries, ts=0, prefix="c"):
    return [pkg.qs.QServeCommand(timestamp=ts, action="register",
                                 uid=f"{prefix}{i}", query=q)
            for i, q in enumerate(queries)]


def _serve(pkg, op, stream, driver=None):
    return list(op.run(iter(stream), dtype=np.float32, driver=driver))


def _lines(results):
    return [line for res in results for line in res.lines()]


# ---------------------------------------------------------------------------
# registry semantics


def test_bucket_key_and_rungs():
    rng = np.random.default_rng(1)
    for i, (k, r) in enumerate([(5, 0.004), (17, 0.004), (32, 0.0021),
                                (1, 0.001), (33, 0.5), (1024, 7.0)]):
        args = dict(qid=f"q{i}", tenant="t", kind="knn", x=1.0, y=2.0,
                    radius=r, k=k)
        tq, jq = qserve.StandingQuery(**args), jqs.StandingQuery(**args)
        assert qserve.query_rung(tq) == jqs.query_rung(jq)
        assert qserve.bucket_key(tq) == jqs.bucket_key(jq)
        assert qserve.bucket_key_str(qserve.bucket_key(tq)) == \
            jqs.bucket_key_str(jqs.bucket_key(jq))
    q = _mk_query(PORT, 0, rng, kind="knn", k=5, radius=0.004)
    assert qserve.query_rung(q) == 8
    q2 = _mk_query(PORT, 1, rng, kind="knn", k=17, radius=0.004)
    assert qserve.query_rung(q2) == 32
    assert qserve.bucket_key(q)[0] == "knn"
    assert qserve.radius_class(0.0005) == 0
    assert qserve.radius_class(0.001) == 0
    assert qserve.radius_class(0.0021) > qserve.radius_class(0.001)
    for r in (0.0005, 0.001, 0.0021, 0.02, 0.05, 3.3):
        assert qserve.radius_class(r) == jqs.radius_class(r)


@pytest.mark.parametrize("bad,match", [
    (dict(kind="box"), "unknown query kind"),
    (dict(qid=""), "qid must be non-empty"),
    (dict(radius=0.0), "radius must be positive"),
    (dict(k=0), "k must be >= 1"),
])
def test_standing_query_validation_as_in_jax(bad, match):
    args = dict(qid="q", tenant="t", kind="knn", x=1.0, y=1.0, radius=1.0,
                k=3)
    args.update(bad)
    for pkg in (JAX, PORT):
        with pytest.raises(ValueError, match=match):
            pkg.qs.StandingQuery(**args)


@pytest.mark.parametrize("bad,match", [
    (dict(action="move"), "unknown qserve action"),
    (dict(action="register"), "register command needs a query"),
    (dict(action="unregister"), "unregister command needs a qid"),
    (dict(action="unregister", qid="q", uid=""), "uid must be non-empty"),
])
def test_command_validation_as_in_jax(bad, match):
    args = dict(timestamp=0, uid="u")
    args.update(bad)
    for pkg in (JAX, PORT):
        with pytest.raises(ValueError, match=match):
            pkg.qs.QServeCommand(**args)
    assert qserve.QServeCommand.control_plane is True


def test_command_application_is_exactly_once():
    rng = np.random.default_rng(2)
    reg = qserve.QueryRegistry(PORT.grid(), Interner())
    q = _mk_query(PORT, 0, rng)
    cmd = qserve.QServeCommand(timestamp=0, action="register", uid="u0",
                               query=q)
    assert reg.apply(cmd) is True
    assert reg.apply(cmd) is False  # replay: no-op
    assert len(reg) == 1 and reg.registered_total == 1
    un = qserve.QServeCommand(timestamp=1, action="unregister", uid="u1",
                              qid=q.qid)
    assert reg.apply(un) is True
    assert reg.apply(un) is False
    assert len(reg) == 0 and reg.unregistered_total == 1


def test_registry_state_round_trip():
    def scenario(pkg):
        rng = np.random.default_rng(3)
        reg = pkg.qs.QueryRegistry(pkg.grid(), pkg.Interner())
        for cmd in _register_cmds(pkg, [_mk_query(pkg, i, rng)
                                        for i in range(5)]):
            reg.apply(cmd)
        reg.apply(pkg.qs.QServeCommand(timestamp=9, action="unregister",
                                       uid="u", qid="q2"))
        reg.record_range_overflow(1000, 4)
        return reg

    jreg, treg = twin(scenario)
    state = treg.state()
    assert json.loads(json.dumps(state)) == json.loads(
        json.dumps(jreg.state()))
    for src in (state, jreg.state()):  # the port's and the JAX state
        reg2 = qserve.QueryRegistry(PORT.grid(), Interner())
        reg2.restore(json.loads(json.dumps(src)))
        assert sorted(reg2._queries) == sorted(treg._queries)
        assert reg2._applied == treg._applied
        assert reg2.unregistered_total == 1
        assert reg2.range_result_overflow == 4 and reg2.epoch == 1
        for qid in reg2._queries:
            np.testing.assert_array_equal(reg2.flags(qid), treg.flags(qid))
            np.testing.assert_array_equal(reg2.flags(qid), jreg.flags(qid))
    with pytest.raises(ValueError, match="qserve state version"):
        reg2.restore({**state, "version": 2})


def test_one_intern_home():
    import inspect

    rng = np.random.default_rng(4)
    op = _op(PORT)
    assert op.qserve_registry.interner is op.interner
    assert op.registry is op.qserve_registry
    before = len(op.interner)
    op.qserve_registry.apply(qserve.QServeCommand(
        timestamp=0, action="register", uid="u0",
        query=_mk_query(PORT, 0, rng)))
    assert len(op.interner) == before + 2  # tenant + qid interned there
    assert op.interner._to_int["q0"] is not None
    assert "Interner(" not in inspect.getsource(qserve)


# ---------------------------------------------------------------------------
# churn against the signature surface


def test_registration_storm_keeps_signatures_on_the_ladder():
    """Register/unregister storms sweep one bucket across every occupancy
    rung; the bucket program runs at most ladder-many signatures, a
    revisited occupancy adds none, and the counts, rung picks and
    snapshots equal the JAX package's."""
    cap_max = 32  # ladder (8, 16, 32)

    def scenario(pkg):
        rng = np.random.default_rng(5)
        op = _op(pkg, cap_max=cap_max)
        reg = op.qserve_registry
        pool = [pkg.qs.StandingQuery(
            qid=f"q{i}", tenant=f"t{i % 5}", kind="knn",
            x=_lat(rng, 1, 9), y=_lat(rng, 1, 9), radius=1.5, k=5)
            for i in range(cap_max)]
        for q in pool:
            reg.interner.intern(q.tenant)
            reg.interner.intern(q.qid)
        for i in range(130):
            reg.interner.intern(f"o{i % 13}")

        def stream(phase, live_target):
            cmds = []
            live = set(reg._queries)
            want = {q.qid for q in pool[:live_target]}
            seq = 0
            for qid in sorted(live - want):
                cmds.append(pkg.qs.QServeCommand(
                    timestamp=0, action="unregister",
                    uid=f"p{phase}u{seq}", qid=qid))
                seq += 1
            for q in pool:
                if q.qid in want - live:
                    cmds.append(pkg.qs.QServeCommand(
                        timestamp=0, action="register",
                        uid=f"p{phase}r{seq}", query=q))
                    seq += 1
            yield from cmds
            yield from _point_stream(pkg, rng, n=30, tmax_ms=4000)

        pkg.tel.enable()
        lines = []
        for phase, target in enumerate((4, 12, 30, 4)):
            lines += _lines(_serve(pkg, op, stream(phase, target)))
        sigs = pkg.tel.distinct_shapes("registry_bucket_kernel")
        buckets = pkg.tel.compaction_buckets("qserve_bucket")
        snap = pkg.tel.snapshot()
        pkg.tel.disable()
        return lines, sigs, buckets, snap["qserve"]

    (jl, jsigs, jb, jsnap), (tl, tsigs, tb, tsnap) = twin(scenario)
    assert 1 <= tsigs <= len(capacity_ladder(cap_max)), tsigs
    assert set(tb) <= set(capacity_ladder(cap_max))
    assert tsnap["recompiles"] == tsigs
    assert (tsigs, tb, tsnap) == (jsigs, jb, jsnap)
    assert tl == jl and tl


# ---------------------------------------------------------------------------
# per-tenant QoS


def _two_class_pipeline(pkg, policy):
    rng = np.random.default_rng(6)
    ctrl = pkg.ov.install(pkg.ov.OverloadController(policy))
    op = _op(pkg)
    queries = (
        [_mk_query(pkg, i, rng, kind="range", k=8, radius=3.0,
                   tenant_class="firehose") for i in range(4)]
        + [_mk_query(pkg, 9, rng, kind="knn", k=3, radius=1.0,
                     tenant_class="modest")])
    stream = _register_cmds(pkg, queries) + list(
        _point_stream(pkg, rng, n=150))
    results = _serve(pkg, op, stream)
    rows = [row for res in results for row in res.rows]
    return ctrl.snapshot(), rows, _lines(results), ctrl, op


def test_firehose_tenant_degrades_itself_not_the_fleet():
    def policy(pkg):
        return pkg.ov.OverloadPolicy(
            tenant_budgets={"firehose": {"max_queries": 3,
                                         "max_results_per_window": 5}},
            ladder=({"action": "clamp_compaction", "cap": 0},),
            degrade_cooldown=1)

    (jsnap, jrows, jlines, _, jop), (snap, rows, lines, ctrl, op) = twin(
        lambda pkg: _two_class_pipeline(pkg, policy(pkg)))
    t = snap["tenants"]
    assert t["firehose"]["queries_live"] == 3
    assert t["firehose"]["queries_shed"] >= 1
    assert t["firehose"]["results_shed"] > 0
    assert t["firehose"]["degraded_windows"] > 0
    assert t["modest"]["results_shed"] == 0
    assert t["modest"]["queries_shed"] == 0
    assert any(cls == "modest" for cls, *_ in rows)
    assert snap["rung"] == 0 and snap["rung_transitions"] == 0
    assert ctrl.tenant_shed_total("firehose") > 0
    assert ctrl.tenant_shed_total("modest") == 0
    assert op.registry.evicted_total == 1
    assert snap == jsnap and rows == jrows and lines == jlines
    assert op.registry.state() == jop.registry.state()


def test_tenant_result_budget_bounds_every_window():
    def scenario(pkg):
        rng = np.random.default_rng(7)
        ctrl = pkg.ov.install(pkg.ov.OverloadController(pkg.ov.OverloadPolicy(
            tenant_budgets={"firehose": {"max_results_per_window": 5}})))
        op = _op(pkg)
        queries = [_mk_query(pkg, i, rng, kind="range", k=8, radius=3.0,
                             tenant_class="firehose") for i in range(4)]
        results = _serve(pkg, op, _register_cmds(pkg, queries)
                         + list(_point_stream(pkg, rng, n=150)))
        return results, ctrl.tenant_shed_total("firehose")

    (jres, jshed), (res, shed) = twin(scenario)
    for r in res:
        assert sum(1 for cls, *_ in r.rows if cls == "firehose") <= 5
    assert shed > 0 and shed == jshed
    assert _lines(res) == _lines(jres)


def test_tenant_budgets_strict_parse():
    with pytest.raises(ValueError, match="unknown keys"):
        overload.OverloadPolicy(tenant_budgets={"a": {"max_queriez": 1}})
    with pytest.raises(ValueError, match="non-negative int"):
        overload.OverloadPolicy(tenant_budgets={"a": {"max_queries": -1}})
    p = overload.OverloadPolicy(tenant_budgets={"a": {"max_queries": 2}})
    p2 = overload.OverloadPolicy.from_dict(p.to_dict())
    assert p2.tenant_budgets == {"a": {"max_queries": 2}}


def test_tenant_state_checkpoint_round_trip():
    policy = overload.OverloadPolicy(
        tenant_budgets={"firehose": {"max_queries": 1}})
    ctrl = overload.OverloadController(policy)
    assert ctrl.admit_tenant_query("firehose") is True
    assert ctrl.admit_tenant_query("firehose") is False  # shed
    ctrl2 = overload.OverloadController(policy)
    ctrl2.restore(ctrl.state())
    assert ctrl2.tenant_shed_total("firehose") == 1
    assert ctrl2.snapshot()["tenants"]["firehose"]["queries_live"] == 1


def test_tenant_slo_budgets_live_engine():
    def scenario(pkg):
        ctrl = pkg.ov.install(pkg.ov.OverloadController(pkg.ov.OverloadPolicy(
            tenant_budgets={"firehose": {"max_results_per_window": 2}})))
        spec = pkg.slo.SloSpec(
            name="t", eval_interval_s=0.0,
            tenant_budgets={
                "firehose": {"shed_budget": 0, "degraded_window_budget": 0},
                "modest": {"shed_budget": 10}})
        engine = pkg.slo.install(pkg.slo.SloEngine(spec))
        ctrl.tenant_result_allowance("firehose", 7)  # sheds 5
        rows = engine.evaluate()
        violations = [v["check"] for v in engine.violations]
        pkg.slo.uninstall()
        pkg.ov.uninstall()
        silent = pkg.slo.SloEngine(spec).evaluate()
        return rows, violations, silent

    def tenant_rows(rows):
        return {r["check"]: r for r in rows
                if r["check"].startswith("tenant_")}

    (jrows, jviol, jsilent), (rows, viol, silent) = twin(scenario)
    by = tenant_rows(rows)
    assert by["tenant_shed_budget:firehose"]["ok"] is False
    assert by["tenant_degraded_window_budget:firehose"]["ok"] is False
    assert by["tenant_shed_budget:modest"]["ok"] is True
    assert "tenant_shed_budget:firehose" in viol
    sby = tenant_rows(silent)
    assert sby["tenant_shed_budget:firehose"]["ok"] is False
    assert sby["tenant_shed_budget:modest"]["ok"] is False
    assert by == tenant_rows(jrows) and sby == tenant_rows(jsilent)


def test_range_result_overflow_counts_at_query_cap():
    def scenario(pkg):
        rng = np.random.default_rng(8)
        op = _op(pkg)
        q = pkg.qs.StandingQuery(qid="r", tenant="t", kind="range", x=5.0,
                                 y=5.0, radius=4.0, k=2)
        results = _serve(pkg, op, [pkg.qs.QServeCommand(
            timestamp=0, action="register", uid="u", query=q)]
            + list(_point_stream(pkg, rng, n=80, tmax_ms=4000)))
        return results, op.qserve_registry.range_result_overflow

    (jres, jover), (res, over) = twin(scenario)
    assert max(len(r.rows) for r in res) == 2
    assert over > 0 and over == jover
    assert _lines(res) == _lines(jres)


def test_record_range_overflow_is_retry_idempotent():
    reg = qserve.QueryRegistry(PORT.grid(), Interner())
    reg.record_range_overflow(100, 5)
    reg.record_range_overflow(100, 5)  # retry of window 100
    assert reg.range_result_overflow == 5
    reg.record_range_overflow(200, 3)
    assert reg.range_result_overflow == 8
    reg2 = qserve.QueryRegistry(PORT.grid(), Interner())
    reg2.restore(json.loads(json.dumps(reg.state())))
    reg2.record_range_overflow(200, 3)
    assert reg2.range_result_overflow == 8


def test_commands_are_never_shed_by_admission():
    rng = np.random.default_rng(9)
    policy = overload.OverloadPolicy(max_buffered_events=1,
                                     lag_shed_ceiling_ms=1,
                                     lag_recover_ms=0)
    ctrl = overload.OverloadController(policy)
    cmd = qserve.QServeCommand(timestamp=0, action="register", uid="u",
                               query=_mk_query(PORT, 0, rng))
    ctrl.on_window_fired(n_events=1, lag_ms=10_000, end=1000)
    assert ctrl._shedding is True
    ctrl._max_ts = 5000
    assert ctrl.admit_item(cmd, pausable=False) is True
    assert ctrl.shed_total == 0


def test_allowed_lateness_is_rejected():
    op = _op(PORT, conf={"allowed_lateness": 1.0})
    with pytest.raises(ValueError, match="allowed_lateness"):
        next(iter(op.run(iter([]))))


def test_tenant_result_charge_is_retry_idempotent():
    policy = overload.OverloadPolicy(
        tenant_budgets={"a": {"max_results_per_window": 2}})
    ctrl = overload.OverloadController(policy)
    assert ctrl.tenant_result_allowance("a", 7, window_start=100) == 2
    assert ctrl.tenant_result_allowance("a", 7, window_start=100) == 2
    rec = ctrl.snapshot()["tenants"]["a"]
    assert rec["results_shed"] == 5 and rec["degraded_windows"] == 1
    assert ctrl.tenant_result_allowance("a", 4, window_start=200) == 2
    rec = ctrl.snapshot()["tenants"]["a"]
    assert rec["results_shed"] == 7 and rec["degraded_windows"] == 2
    ctrl2 = overload.OverloadController(policy)
    ctrl2.restore(ctrl.state())
    assert ctrl2.tenant_result_allowance("a", 4, window_start=200) == 2
    assert ctrl2.snapshot()["tenants"]["a"]["results_shed"] == 7


def test_applied_uid_set_prunes_behind_the_watermark():
    rng = np.random.default_rng(10)
    reg = qserve.QueryRegistry(PORT.grid(), Interner())
    for i in range(6):
        reg.apply(qserve.QServeCommand(
            timestamp=i * 1000, action="register", uid=f"u{i}",
            query=_mk_query(PORT, i, rng)))
    assert len(reg._applied) == 6
    reg.prune_applied(watermark_ts=10_000, horizon_ms=3_000)
    assert set(reg._applied) == set()
    reg.apply(qserve.QServeCommand(
        timestamp=12_000, action="register", uid="u9",
        query=_mk_query(PORT, 9, rng)))
    reg.prune_applied(watermark_ts=12_500, horizon_ms=3_000)
    assert set(reg._applied) == {"u9"}
    assert reg.apply(qserve.QServeCommand(
        timestamp=12_000, action="register", uid="u9",
        query=_mk_query(PORT, 9, rng))) is False


def test_dead_bucket_device_arrays_are_evicted():
    rng = np.random.default_rng(11)
    op = _op(PORT)
    q = _mk_query(PORT, 0, rng, kind="knn", k=5, radius=1.5)
    stream = ([qserve.QServeCommand(timestamp=0, action="register",
                                    uid="r0", query=q)]
              + list(_point_stream(PORT, rng, n=40, tmax_ms=4000))
              + [qserve.QServeCommand(timestamp=5000, action="unregister",
                                      uid="u0", qid=q.qid)]
              + [Point(obj_id=f"o{i}", timestamp=5000 + i * 100, x=5.0,
                       y=5.0) for i in range(40)])
    seen = []
    for _ in op.run(iter(stream)):
        seen.append(len(op._bucket_dev))
    assert max(seen) == 1
    assert op._bucket_dev == {}


def test_tenant_slo_spec_strict_parse():
    with pytest.raises(ValueError, match="unknown keys"):
        slo.SloSpec(tenant_budgets={"a": {"shed_budgett": 1}})
    with pytest.raises(ValueError, match="non-negative int"):
        slo.SloSpec(tenant_budgets={"a": {"shed_budget": "lots"}})
    with pytest.raises(ValueError, match="non-negative int"):
        slo.SloSpec(tenant_budgets={"a": {"shed_budget": -1}})
    from tools.sfprof import slo as slo_tool

    assert "tenant_budgets" in slo_tool.SPEC_KEYS


def _port_ledger(tmp_path):
    """A two-class port run under telemetry, its ledger written."""
    telemetry.enable()
    policy = overload.OverloadPolicy(
        tenant_budgets={"firehose": {"max_queries": 3,
                                     "max_results_per_window": 5}})
    snap, *_ = _two_class_pipeline(PORT, policy)
    path = tmp_path / "ledger.json"
    telemetry.write_ledger(str(path), bench={"points_per_sec": 1.0},
                           capture_costs=False)
    telemetry.disable()
    return path, snap


def test_tenant_slo_posthoc_twin(tmp_path):
    """``tools/sfprof/slo.py`` reads the port ledger's overload tenants
    block as it reads the JAX one's, silence-fails rule included."""
    from tools.sfprof import slo as slo_tool

    path, snap = _port_ledger(tmp_path)
    doc = json.loads(path.read_text())
    assert doc["snapshot"]["overload"]["tenants"] == snap["tenants"]
    spec = {"tenant_budgets": {
        "firehose": {"shed_budget": 3, "degraded_window_budget": 0},
        "modest": {"shed_budget": 0},
        "unseen": {"shed_budget": 0}}}
    rows = {r[0]: r for r in slo_tool.evaluate(spec, doc)}
    fire = snap["tenants"]["firehose"]
    name = "slo:tenant_shed_budget:firehose"
    assert rows[name][1] == fire["queries_shed"] + fire["results_shed"]
    assert rows[name][3] is False
    assert rows["slo:tenant_degraded_window_budget:firehose"][3] is False
    assert rows["slo:tenant_shed_budget:modest"][3] is True
    assert rows["slo:tenant_shed_budget:unseen"][3] is True
    rows2 = {r[0]: r for r in slo_tool.evaluate(spec, {"snapshot": {}})}
    assert rows2[name][3] is False
    p = tmp_path / "spec.json"
    p.write_text(json.dumps(spec))
    assert slo_tool.load_spec(str(p))["tenant_budgets"] == \
        spec["tenant_budgets"]


# ---------------------------------------------------------------------------
# observability surfaces


def test_snapshot_qserve_block_and_events():
    def scenario(pkg):
        rng = np.random.default_rng(12)
        pkg.tel.enable()
        op = _op(pkg)
        stream = _register_cmds(pkg, [_mk_query(pkg, i, rng)
                                      for i in range(4)]) + list(
            _point_stream(pkg, rng, n=60, tmax_ms=6000))
        lines = _lines(_serve(pkg, op, stream))
        snap = pkg.tel.snapshot()
        names = sorted(e["name"] for e in pkg.tel.events
                       if e.get("ph") == "i")
        pkg.tel.disable()
        return (snap["qserve"], snap["bytes_h2d"], snap["compaction"], names,
                lines)

    (jqsb, jh2d, jcomp, jnames, jlines), (qs, h2d, comp, names, lines) = \
        twin(scenario)
    assert qs["registered"] == 4 and qs["registered_total"] == 4
    assert qs["buckets"] and all(b["capacity"] >= b["live"]
                                 for b in qs["buckets"].values())
    assert qs["recompiles"] >= 1
    assert "qserve_registered" in names
    assert any(n.startswith("qserve_rung:") for n in names)
    assert qs == jqsb and comp == jcomp and lines == jlines
    # The same lanes shipped: points each window, each bucket once.
    assert h2d == jh2d
    qn = [n for n in names if n.startswith("qserve_") or
          n.startswith("compile:registry")]
    assert qn == [n for n in jnames if n.startswith("qserve_") or
                  n.startswith("compile:registry")]


def test_sfprof_health_and_report_print_tenant_qos(tmp_path, capsys):
    """health/report read the port's ledger: per-tenant-class QoS lines
    and the qserve note, with ``--json`` coverage."""
    from tools.sfprof import cli as sfprof_cli

    path, snap = _port_ledger(tmp_path)
    qs_block = json.loads(path.read_text())["snapshot"]["qserve"]
    assert qs_block["registered"] == 4 and qs_block["evicted_total"] == 1
    rc = sfprof_cli.main(["health", str(path)])
    out = capsys.readouterr().out
    assert rc == 0
    assert "tenant QoS [firehose]" in out
    assert (f"results_shed={snap['tenants']['firehose']['results_shed']}"
            in out)
    assert "note qserve: registered=4" in out
    sfprof_cli.main(["health", str(path), "--json"])
    notes = json.loads(capsys.readouterr().out)["notes"]
    assert notes["tenants"] == snap["tenants"]
    assert notes["qserve"] == qs_block
    sfprof_cli.main(["report", str(path)])
    out = capsys.readouterr().out
    assert "per-tenant-class QoS" in out
    assert "qserve registry: 4 standing queries" in out


def test_config_from_env_strict(monkeypatch, tmp_path):
    monkeypatch.delenv("SFT_QSERVE", raising=False)
    assert qserve.config_from_env() is None
    monkeypatch.setenv("SFT_QSERVE", json.dumps({
        "queries": [{"qid": "a", "tenant": "t", "kind": "knn", "x": 1.0,
                     "y": 2.0, "radius": 0.5, "k": 3}],
        "tenant_budgets": {"default": {"max_queries": 10}}}))
    cfg = qserve.config_from_env()
    assert cfg == jqs.config_from_env()
    qs = qserve.queries_from_config(cfg)
    assert qs[0].qid == "a" and qs[0].k == 3
    assert [q.to_dict() for q in qs] == \
        [q.to_dict() for q in jqs.queries_from_config(cfg)]
    monkeypatch.setenv("SFT_QSERVE", json.dumps({"nope": 1}))
    with pytest.raises(ValueError, match="unknown SFT_QSERVE keys"):
        qserve.config_from_env()
    arr = tmp_path / "arr.json"
    arr.write_text("[1]")
    monkeypatch.setenv("SFT_QSERVE", str(arr))
    for mod in (qserve, jqs):
        with pytest.raises(ValueError, match="must be a JSON object"):
            mod.config_from_env()
    p = tmp_path / "q.json"
    p.write_text(json.dumps({"cap_max": 64}))
    monkeypatch.setenv("SFT_QSERVE", str(p))
    assert qserve.config_from_env() == {"cap_max": 64}


def test_boot_commands_and_by_tenant():
    rng = np.random.default_rng(13)
    tq = [_mk_query(PORT, i, rng) for i in range(3)]
    cmds = qserve.boot_commands(tq, timestamp=5)
    jcmds = jqs.boot_commands([jqs.StandingQuery(**q.to_dict())
                               for q in tq], timestamp=5)
    assert [(c.timestamp, c.action, c.uid, c.query.to_dict())
            for c in cmds] == [(c.timestamp, c.action, c.uid,
                                c.query.to_dict()) for c in jcmds]
    res = qserve.QServeWindowResult(0, 10, [
        ("c", "t0", "q0", "o1", 0.5), ("c", "t1", "q1", "o2", 0.25),
        ("c", "t0", "q2", "o3", 1.0)], 3)
    jres = jqs.QServeWindowResult(0, 10, list(res.rows), 3)
    assert res.by_tenant() == jres.by_tenant()
    assert list(res.lines()) == list(jres.lines())


# ---------------------------------------------------------------------------
# the operator against the JAX operator: register, churn, unregister,
# evictions and truncations


def _churn_stream(pkg, seed=14, n=200, tmax_ms=14_000):
    rng = np.random.default_rng(seed)
    boot = [_mk_query(pkg, i, rng, k=(5, 3, 8)[i % 3],
                      tenant_class=("firehose" if i % 4 == 0 else "default"))
            for i in range(10)]
    churn = [
        pkg.qs.QServeCommand(timestamp=4005, action="unregister", uid="x1",
                             qid="q1"),
        pkg.qs.QServeCommand(timestamp=5005, action="register", uid="x2",
                             query=_mk_query(pkg, 20, rng, kind="range",
                                             k=30, radius=2.5)),
        pkg.qs.QServeCommand(timestamp=6005, action="register", uid="x3",
                             query=_mk_query(pkg, 21, rng, kind="knn",
                                             tenant_class="firehose")),
        pkg.qs.QServeCommand(timestamp=7005, action="unregister", uid="x4",
                             qid="q0"),
        pkg.qs.QServeCommand(timestamp=8005, action="register", uid="x5",
                             query=_mk_query(pkg, 22, rng, kind="knn",
                                             tenant_class="firehose")),
        pkg.qs.QServeCommand(timestamp=9005, action="unregister", uid="x6",
                             qid="q404"),
    ]
    pts = list(_point_stream(pkg, rng, n=n, tmax_ms=tmax_ms))
    out = list(pkg.qs.boot_commands(boot))
    pending = list(churn)
    for p in pts:
        while pending and pending[0].timestamp <= p.timestamp:
            out.append(pending.pop(0))
        out.append(p)
    return out + pending


def _budget_policy(pkg):
    return pkg.ov.OverloadPolicy(tenant_budgets={
        "firehose": {"max_queries": 2, "max_results_per_window": 6}})


def test_operator_egress_matches_jax_on_a_lattice():
    def scenario(pkg):
        ctrl = pkg.ov.install(pkg.ov.OverloadController(_budget_policy(pkg)))
        op = _op(pkg)
        results = _serve(pkg, op, _churn_stream(pkg))
        return (_lines(results), op.registry.state(), ctrl.snapshot(),
                [r.window_count for r in results])

    (jl, jstate, jsnap, jcounts), (tl, state, snap, counts) = twin(scenario)
    assert len(tl) > 100
    assert state["counters"]["evicted_total"] >= 1
    assert state["counters"]["unregistered_total"] == 2
    assert snap["tenants"]["firehose"]["results_shed"] > 0
    assert tl == jl
    assert state == jstate and snap == jsnap and counts == jcounts


def _qserve_leg(pkg, workdir, fault_plan=None, stream=None):
    """The chaos matrix's qserve leg: boot registrations, data and
    mid-stream churn through the driver, checkpointed every 2 windows
    into a transactional sink, under a tenant budget whose controller
    rides the checkpoint (``overload=``)."""
    ctrl = pkg.ov.install(pkg.ov.OverloadController(_budget_policy(pkg)))
    op = _op(pkg)
    sink = pkg.Sink(os.path.join(workdir, "egress.csv"))
    drv = pkg.drv.WindowedDataflowDriver(
        checkpoint_path=os.path.join(workdir, "ckpt.bin"),
        checkpoint_every=2, sink=sink,
        retry=pkg.drv.RetryPolicy(max_retries=0, backoff_s=0.0),
        failover=False, overload=ctrl)
    if fault_plan:
        pkg.faults.arm(fault_plan)
    try:
        for res in op.run(iter(stream or _churn_stream(pkg)),
                          dtype=np.float32, driver=drv):
            for line in res.lines():
                sink.stage(line)
    finally:
        pkg.faults.disarm()
        pkg.qs.uninstall()
        pkg.ov.uninstall()
    return drv, op


# Hit 23 of qserve.register: the 10 boot commands hit twice (two sliding
# windows hold ts=0), so this is a churn command, after checkpoints.
KILL = [{"point": "qserve.register", "at": 23, "times": 10**6}]


def test_kill_mid_churn_resumes_byte_identical(tmp_path):
    clean, chaos, jclean = (tmp_path / d for d in ("clean", "chaos",
                                                    "jclean"))
    for d in (clean, chaos, jclean):
        d.mkdir()
    _qserve_leg(PORT, str(clean))
    want = (clean / "egress.csv").read_bytes()
    assert want.count(b"\n") > 100
    _qserve_leg(JAX, str(jclean))
    assert (jclean / "egress.csv").read_bytes() == want
    with pytest.raises(InjectedFault):
        _qserve_leg(PORT, str(chaos), fault_plan=KILL)
    assert 0 < len((chaos / "egress.csv").read_bytes()) < len(want)
    drv, op = _qserve_leg(PORT, str(chaos))
    assert drv.stats["resumed"] is True
    assert (chaos / "egress.csv").read_bytes() == want
    whole = load_checkpoint(str(clean / "ckpt.bin"))["op"]["qserve"]
    assert op.registry.state()["counters"] == whole["counters"]


def test_jax_checkpoint_resumes_in_the_port(tmp_path):
    """A JAX qserve run killed mid-churn: its checkpoint (buffered Points
    and QServeCommands, the registry state) read by
    ``state.load_jax_checkpoint``, rewritten as the port's, and resumed
    by the port's driver, which writes the JAX run's uninterrupted
    egress."""
    clean, chaos = tmp_path / "clean", tmp_path / "chaos"
    clean.mkdir()
    chaos.mkdir()
    _qserve_leg(JAX, str(clean))
    want = (clean / "egress.csv").read_bytes()
    with pytest.raises(JInjected):
        _qserve_leg(JAX, str(chaos), fault_plan=KILL)
    path = str(chaos / "ckpt.bin")
    comps = load_jax_checkpoint(path)
    assert comps["op"]["qserve"]["counters"]["registered_total"] >= 7
    buffered = [e for _, evs in comps["op"]["assembler"]["buffers"]
                for e in evs]
    assert {type(e) for e in buffered} <= {Point, qserve.QServeCommand}
    assert Point in {type(e) for e in buffered}
    save_checkpoint(path, **comps)
    drv, _ = _qserve_leg(PORT, str(chaos))
    assert drv.stats["resumed"] is True
    assert (chaos / "egress.csv").read_bytes() == want


def test_qserve_checkpoint_component_round_trips():
    rng = np.random.default_rng(15)
    op = _op(PORT)
    stream = _register_cmds(PORT, [_mk_query(PORT, i, rng)
                                   for i in range(5)]) + list(
        _point_stream(PORT, rng, n=40, tmax_ms=4000))
    _serve(PORT, op, stream)
    state = operator_state(op)
    assert state["qserve"] == op.registry.state()
    op2 = _op(PORT)
    restore_operator(op2, state)
    assert op2.registry.state() == op.registry.state()
    assert op2.registry.epoch == 1
    assert op2.interner._to_key == op.interner._to_key
    for qid in op.registry._queries:
        np.testing.assert_array_equal(op2.registry.flags(qid),
                                      op.registry.flags(qid))


def test_qserve_register_fault_point_is_threaded():
    rng = np.random.default_rng(16)
    reg = qserve.QueryRegistry(PORT.grid(), Interner())
    faults.arm([{"point": "qserve.register", "at": 2}])
    cmds = _register_cmds(PORT, [_mk_query(PORT, i, rng) for i in range(3)])
    assert reg.apply(cmds[0]) is True
    with pytest.raises(InjectedFault):
        reg.apply(cmds[1])
    faults.disarm()
    assert len(reg) == 1 and reg.apply(cmds[1]) is True


def test_flag_tables_are_never_shipped_by_reference():
    rng = np.random.default_rng(17)
    op = _op(PORT)
    q = _mk_query(PORT, 0, rng, kind="knn", radius=1.5)
    _serve(PORT, op, [qserve.QServeCommand(timestamp=0, action="register",
                                           uid="r", query=q)]
           + list(_point_stream(PORT, rng, n=20, tmax_ms=2000)))
    (cached,) = op._bucket_dev.values()
    before = cached["tables"].clone()
    op.registry.flags(q.qid)[:] = 7
    assert torch.equal(cached["tables"], before)
    assert not np.shares_memory(cached["tables"].numpy(),
                                op.registry.flags(q.qid))


def test_mesh_and_device_entry_points():
    # ``mesh=`` is ported (tests/test_torch_parallel_operators.py): a
    # value that is not a mesh raises at each entry point.
    with pytest.raises(TypeError, match="must be a spatialflink_tpu_torch.parallel.mesh.Mesh"):
        qserve.QServeOperator(PORT.conf(), PORT.grid(), mesh=object(),
                              device="cpu")
    op = _op(PORT)
    with pytest.raises(TypeError, match="must be a spatialflink_tpu_torch.parallel.mesh.Mesh"):
        next(iter(op.run(iter([]), mesh=object())))
    with pytest.raises(TypeError, match="must be a spatialflink_tpu_torch.parallel.mesh.Mesh"):
        op.serve_window(None, None, mesh=object())
    assert op.device.type == "cpu"
    if torch.cuda.is_available():
        assert qserve.QServeOperator(PORT.conf(), PORT.grid()).device.type \
            == "cuda"
    else:
        with pytest.raises(RuntimeError, match="cuda"):
            qserve.QServeOperator(PORT.conf(), PORT.grid())


# ---------------------------------------------------------------------------
# acceptance: 1,024 standing queries


def test_1024_standing_queries_ladder_bounded_and_exact():
    """The JAX package's slow acceptance shape, run here in full: 1,024
    mixed standing queries over 4,096 points through at most
    ladder-many signatures per k-rung; every lane of every bucket equal to
    the JAX program's (segment, index, counts exact, distances within
    1 ulp), and sampled lanes bit-equal to the query evaluated alone."""
    nq, n, nseg = 1024, 4096, 512
    rng = np.random.default_rng(42)
    xy = rng.uniform(0, 10, (n, 2)).astype(np.float32)
    oid = rng.integers(0, nseg, n).astype(np.int32)
    grid = PORT.grid()
    cell = grid.assign_cells_np(xy.astype(np.float64)).astype(np.int32)
    valid = np.ones(n, bool)
    queries = [qserve.StandingQuery(
        qid=f"q{i}", tenant=f"t{i % 31}", kind="range" if i % 2 else "knn",
        x=float(rng.uniform(1, 9)), y=float(rng.uniform(1, 9)),
        radius=float((0.8, 1.6, 2.4)[i % 3]), k=(32, 5, 10, 30)[i % 4])
        for i in range(nq)]
    buckets = {}
    for q in queries:
        buckets.setdefault(qserve.bucket_key(q), []).append(q)
    kernel = tqr.registry_bucket_kernel
    from spatialflink_tpu_torch.operators.base import jitted

    ikern = jitted(kernel)
    jkern = jax.jit(jqr.registry_bucket_kernel,
                    static_argnames=("k", "num_segments", "query_block"))
    args = (torch.from_numpy(xy), torch.from_numpy(valid),
            torch.from_numpy(cell))
    jargs = (jnp.asarray(xy), jnp.asarray(valid), jnp.asarray(cell))
    telemetry.enable()
    results = {}
    for key in sorted(buckets):
        qs = buckets[key]
        cap = pick_capacity(len(qs), 1024, minimum=8)
        qxy, radius, qvalid, tables = qserve.bucket_host_arrays(grid, qs,
                                                                cap)
        qxy = qxy.astype(np.float32)
        res = ikern(*args, torch.from_numpy(tables), torch.from_numpy(oid),
                    torch.from_numpy(qxy), torch.from_numpy(radius),
                    torch.from_numpy(qvalid), k=int(key[1]),
                    num_segments=nseg, query_block=min(cap, 32))
        results[key] = (qs, qxy, radius, qvalid, tables, res)
        jres = jkern(*jargs, jnp.asarray(tables), jnp.asarray(oid),
                     jnp.asarray(qxy), jnp.asarray(radius),
                     jnp.asarray(qvalid), k=int(key[1]), num_segments=nseg,
                     query_block=min(cap, 32))
        for f in ("segment", "index", "num_valid", "within"):
            np.testing.assert_array_equal(np.asarray(getattr(jres, f)),
                                          getattr(res, f).numpy(),
                                          err_msg=f"{key} {f}")
        jd, td = np.asarray(jres.dist), res.dist.numpy()
        live = td < np.finfo(np.float32).max
        np.testing.assert_array_equal(jd < np.finfo(np.float32).max, live)
        assert np.all(np.abs(jd[live] - td[live])
                      <= np.spacing(np.maximum(jd[live], td[live])))
        assert bool((res.num_valid[len(qs):] == 0).all())
    sigs = telemetry.distinct_shapes("registry_bucket_kernel")
    telemetry.disable()
    k_rungs = {key[1] for key in buckets}
    assert len(buckets) == 12
    assert sigs <= len(capacity_ladder(1024)) * len(k_rungs), sigs
    for key in sorted(buckets)[:3]:
        qs, qxy, radius, qvalid, tables, res = results[key]
        for lane in (0, len(qs) // 2, len(qs) - 1):
            d, seg, idx, nv, within = tqr.registry_bucket_query(
                *args, torch.from_numpy(tables[lane]), torch.from_numpy(oid),
                torch.from_numpy(qxy[lane]),
                torch.from_numpy(radius[lane:lane + 1])[0],
                bool(qvalid[lane]), k=int(key[1]), num_segments=nseg)
            np.testing.assert_array_equal(
                res.dist[lane].numpy().view(np.uint32),
                d.numpy().view(np.uint32))
            np.testing.assert_array_equal(res.segment[lane], seg)
            np.testing.assert_array_equal(res.index[lane], idx)
            assert int(res.within[lane]) == int(within)
