"""dagmon in the port: per-node telemetry attribution
(``telemetry.scope``) over the port's composed DAG, the conservation
contract (node buckets sum exactly to the untagged globals), the v1
shape of an un-scoped capture, node tags surviving ``sfprof recover``,
and the ``sfprof live`` follower's exit codes, one case for each of
``tests/test_dagmon.py``'s, with the port's sealed and truncated streams
read by ``tools/sfprof`` as it stands. The SNCB DAG runs with
``device="cpu"``."""

import json
import os
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from spatialflink_tpu_torch import dag as dag_mod  # noqa: E402
from spatialflink_tpu_torch import overload, qserve  # noqa: E402
from spatialflink_tpu_torch.dag import (  # noqa: E402
    _toy_sncb_stream,
    build_sncb_dag,
)
from spatialflink_tpu_torch.driver import (  # noqa: E402
    RetryPolicy,
    WindowedDataflowDriver,
)
from spatialflink_tpu_torch.faults import faults  # noqa: E402
from spatialflink_tpu_torch.telemetry import telemetry  # noqa: E402
from tools.sfprof import live as live_mod  # noqa: E402
from tools.sfprof import stream as stream_mod  # noqa: E402


SNCB_NODES = ("q1", "q2", "q3", "q4", "q5", "staytime", "qserve")

# Node-bucket counters with an untagged global twin: the sum over every
# bucket ("(unscoped)" included) must equal the global EXACTLY — tagging
# re-labels accounting, it never creates or loses any.
CONSERVED = ("h2d_bytes", "h2d_transfers", "d2h_bytes", "d2h_transfers",
             "compiles", "collective_bytes", "shed_events", "fault_fires")


@pytest.fixture(autouse=True)
def _clean():
    yield
    faults.disarm()
    telemetry.disable()
    dag_mod.uninstall()
    qserve.uninstall()
    overload.uninstall()


def _bucket_sums(rollup):
    return {k: sum(row.get(k, 0) for row in rollup.values())
            for k in CONSERVED + ("dispatch_ns", "kernel_calls")}


class TestConservation:
    def test_sncb_dag_attributes_all_seven_nodes(self, tmp_path):
        """One in-process 7-node SNCB run: every node gets a bucket with
        real window/event/span accounting, and every conserved counter
        sums back to its untagged global."""
        telemetry.enable()
        dag = build_sncb_dag(
            str(tmp_path / "egress"), qserve_queries=None,
            retry=RetryPolicy(max_retries=1, backoff_s=0.0), device="cpu",
        )
        driver = WindowedDataflowDriver(
            checkpoint_path=str(tmp_path / "ckpt.bin"),
            checkpoint_every=2, sink=None,
            retry=RetryPolicy(max_retries=1, backoff_s=0.0),
            failover=False,
        )
        try:
            for _ in dag.run(_toy_sncb_stream(150)(), driver=driver):
                pass
            rollup = telemetry.node_rollup()
            assert set(SNCB_NODES) <= set(rollup), sorted(rollup)
            for name in SNCB_NODES:
                row = rollup[name]
                assert row["windows"] > 0, name
                assert row["events"] > 0, name
                assert row["span_us"] > 0, name
                assert row["window_latency_p50_ms"] is not None, name

            sums = _bucket_sums(rollup)
            assert sums["h2d_bytes"] == telemetry.h2d_bytes
            assert sums["h2d_transfers"] == telemetry.h2d_transfers
            assert sums["d2h_bytes"] == telemetry.d2h_bytes
            assert sums["d2h_transfers"] == telemetry.d2h_transfers
            assert sums["compiles"] == len(telemetry.compile_events)
            assert sums["fault_fires"] == sum(
                telemetry.fault_fires.values())
            assert sums["shed_events"] == telemetry.shed_events
            table = telemetry.kernel_table()
            assert sums["dispatch_ns"] == sum(
                r["dispatch_ns"] for r in table)
            assert sums["kernel_calls"] == sum(r["calls"] for r in table)
            # The DAG moved real data somewhere — conservation over all
            # zeros would be vacuous.
            assert sums["h2d_bytes"] + sums["d2h_bytes"] > 0
            # The snapshot's nodes block is the same rollup.
            assert telemetry.snapshot()["nodes"] == rollup
        finally:
            telemetry.disable()

    def test_scoped_collective_bytes_land_in_the_node_bucket(self):
        telemetry.enable()
        try:
            with telemetry.scope("meshnode"):
                telemetry.account_collective("psum", 4096, axis="data",
                                             calls=3)
            telemetry.account_collective("broadcast", 100, axis="data")
            rollup = telemetry.node_rollup()
            assert rollup["meshnode"]["collective_bytes"] == 4096
            assert rollup["meshnode"]["collective_calls"] == 3
            assert rollup["(unscoped)"]["collective_bytes"] == 100
            g = telemetry.collective_gauges()
            assert g["bytes"] == 4196 and g["calls"] == 4
            assert _bucket_sums(rollup)["collective_bytes"] == g["bytes"]
        finally:
            telemetry.disable()

    def test_nested_scope_reentrancy_conserves_exactly(self):
        """scope() is a re-entrant stack: the innermost node wins while
        it is active, the outer tag is restored on exit (not cleared),
        and every conserved counter still sums EXACTLY to its untagged
        global — re-labeling across nesting never double-counts."""
        telemetry.enable()
        try:
            with telemetry.scope("outer"):
                telemetry.account_h2d(100)
                with telemetry.scope("inner"):
                    assert telemetry.current_node() == "inner"
                    telemetry.account_h2d(30)
                    telemetry.account_collective("psum", 2048,
                                                 axis="data")
                    telemetry.record_e2e(1_000, "compute")
                # the outer tag must come back — a scope exit that
                # cleared instead of popped would orphan this byte
                assert telemetry.current_node() == "outer"
                telemetry.account_d2h(7)
            assert telemetry.current_node() is None
            telemetry.account_h2d(5)  # unscoped remainder

            rollup = telemetry.node_rollup()
            assert rollup["outer"]["h2d_bytes"] == 100
            assert rollup["outer"]["d2h_bytes"] == 7
            assert rollup["inner"]["h2d_bytes"] == 30
            assert rollup["inner"]["collective_bytes"] == 2048
            assert rollup["(unscoped)"]["h2d_bytes"] == 5

            sums = _bucket_sums(rollup)
            assert sums["h2d_bytes"] == telemetry.h2d_bytes == 135
            assert sums["d2h_bytes"] == telemetry.d2h_bytes == 7
            assert sums["collective_bytes"] == \
                telemetry.collective_gauges()["bytes"]

            # e2e lineage honors the same innermost-wins rule: the
            # stamp inside the inner scope lands in inner's bucket only.
            e2e = telemetry.e2e_gauges()
            assert set(e2e["nodes"]) == {"inner"}
            assert e2e["nodes"]["inner"]["compute"]["count"] == 1
            assert e2e["stages"]["compute"]["count"] == 1
        finally:
            telemetry.disable()


class TestByteCompat:
    def test_unscoped_capture_snapshots_the_v1_shape(self, tmp_path):
        """No scope ever entered → no ``nodes``/``collectives`` blocks
        anywhere: rollup empty, snapshot v1-shaped, ledger v1-shaped
        (modulo the version literal) — old readers keep working."""
        telemetry.enable()
        try:
            telemetry.account_h2d(1024)
            with telemetry.span("window.eval"):
                pass
            assert telemetry.node_rollup() == {}
            snap = telemetry.snapshot()
            assert "nodes" not in snap
            assert "collectives" not in snap
            path = str(tmp_path / "ledger.json")
            telemetry.write_ledger(path, capture_costs=False)
            with open(path) as f:
                doc = json.load(f)
            assert doc["ledger_version"] == 3
            assert "nodes" not in doc["snapshot"]
            assert "collectives" not in doc["snapshot"]
            # Latency lineage is opt-in the same way: no e2e stamp ever
            # → no e2e block (the v2 byte-compat rule).
            assert "e2e" not in doc["snapshot"]
            for row in doc["kernels"]:
                assert "node" not in row
        finally:
            telemetry.disable()


def _scoped_stream(path, flushes=2):
    """A stream capture with one scoped node block, flushed
    ``flushes`` times (so a tail truncation still leaves a complete
    node-carrying checkpoint), NOT sealed."""
    telemetry.enable(stream_path=path)
    with telemetry.scope("q1"), telemetry.span("node.q1", events=5):
        telemetry.account_h2d(512)
        telemetry.account_collective("psum", 2048, axis="data")
    for _ in range(flushes):
        telemetry.maybe_flush_stream(force=True)
    with open(path, "rb") as f:
        return f.read()


class TestRecoverKeepsNodes:
    def test_truncated_stream_recovers_node_blocks(self, tmp_path):
        """Kill-mid-capture: cut the stream inside its LAST checkpoint
        line — recover must rebuild a ledger whose snapshot still
        carries the per-node attribution from the previous flush."""
        stream = str(tmp_path / "s.jsonl")
        data = _scoped_stream(stream)
        telemetry.disable()
        crash = str(tmp_path / "crash.jsonl")
        with open(crash, "wb") as f:
            f.write(data[:-7])  # mid-line cut, the kill -9 shape
        doc, info = stream_mod.recover(crash)
        assert info["partial_tail"] is True
        assert "q1" in info["nodes_recovered"]
        assert info["collective_bytes_recovered"] == 2048
        nodes = doc["snapshot"]["nodes"]
        assert nodes["q1"]["h2d_bytes"] == 512
        assert nodes["q1"]["events"] == 5
        assert nodes["q1"]["collective_bytes"] == 2048


class TestLive:
    def test_sealed_stream_exits_zero(self, tmp_path, capsys):
        stream = str(tmp_path / "s.jsonl")
        _scoped_stream(stream)
        telemetry.disable()  # seals (reason: disabled)
        assert live_mod.follow(stream, 0.05, None, json_mode=True) == 0
        doc = json.loads(capsys.readouterr().out)
        assert doc["sealed"] is True and doc["reason"] == "disabled"
        assert "q1" in doc["nodes"]
        assert doc["collectives"]["bytes"] == 2048
        # Follow mode reaches the epilogue and exits 0 too.
        assert live_mod.follow(stream, 0.05, 5.0, json_mode=False) == 0
        assert "sealed: reason=disabled" in capsys.readouterr().out

    def test_unsealed_stream_exits_one(self, tmp_path, capsys):
        stream = str(tmp_path / "s.jsonl")
        _scoped_stream(stream)
        try:
            assert live_mod.follow(stream, 0.05, None,
                                   json_mode=True) == 1
            doc = json.loads(capsys.readouterr().out)
            assert doc["sealed"] is False
            assert doc["checkpoints"] >= 1
            # Follow mode gives up at --timeout on an unsealed stream.
            assert live_mod.follow(stream, 0.02, 0.1,
                                   json_mode=False) == 1
        finally:
            telemetry.disable()

    def test_truncated_tail_self_heals(self, tmp_path, capsys):
        """A half-written tail (the crash shape) must not break the
        follower: it reports the decodable prefix and exits by the
        seal state, exactly as recover does."""
        stream = str(tmp_path / "s.jsonl")
        data = _scoped_stream(stream)
        telemetry.disable()
        crash = str(tmp_path / "crash.jsonl")
        with open(crash, "wb") as f:
            f.write(data[:-7])
        assert live_mod.follow(crash, 0.05, None, json_mode=True) == 1
        doc = json.loads(capsys.readouterr().out)
        assert doc["sealed"] is False and doc["checkpoints"] >= 1
        assert "q1" in doc["nodes"]

    def test_not_a_stream_exits_two(self, tmp_path, capsys):
        bogus = str(tmp_path / "bogus.jsonl")
        with open(bogus, "w") as f:
            f.write(json.dumps({"t": "checkpoint", "seq": 1}) + "\n")
        assert live_mod.follow(bogus, 0.05, None, json_mode=True) == 2
        capsys.readouterr()
