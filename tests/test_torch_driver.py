"""The port's windowed-dataflow driver (``spatialflink_tpu_torch/driver.py``)
against the JAX package's (``spatialflink_tpu/driver.py``), on the CPU.

One case for each of ``tests/test_driver.py``'s classes: the default
(strict) driver is the plain loop; the migrated operators (range, kNN,
join, tStats, tJoin's pane engine) keep strict semantics without a
driver and fail over to their numpy twins with one; retries follow the
pinned backoff schedule; failover is visible in telemetry; a checkpoint
taken after a failover resumes on the twin; checkpoints resume
byte-identically; the dial watchdog fires once; a rejected configuration
leaves committed egress alone. The SLO-engine and overload cases are in
``tests/test_torch_slo.py`` and ``tests/test_torch_overload.py``.

Then the chaos matrix (``tests/test_chaos_matrix.py``) for the ten points
the port threads: a fault armed past the retry budget crashes the run,
and the resumed run's concatenated egress is byte-identical to the
uninterrupted run's and to the JAX driver's egress over the same stream.
The JAX device path contracts x² + y² into an FMA (the 1-ulp freedom its
own tests allow); its driver's numpy route computes op by op, as the port
does on every device, so the JAX oracle is the JAX driver on that route.
``pipeline.ship`` and ``pipeline.fetch`` are contained in process by the
driver's synchronous fallback, so their legs kill a child process with
the ``abort`` kind (two subprocess legs, a few seconds each).

Every test leaves both packages' fault injectors disarmed and telemetry
disabled, and the port's pipeline policy uninstalled.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from spatialflink_tpu import driver as jdriver
from spatialflink_tpu.faults import faults as jfaults
from spatialflink_tpu.operators.range_query import (
    PointPointRangeQuery as JRangeQ,
)
from spatialflink_tpu.streams.sinks import (
    TransactionalFileSink as JSink,
)
from spatialflink_tpu.telemetry import telemetry as jtelemetry

from spatialflink_tpu_torch import driver as driver_mod
from spatialflink_tpu_torch import pipeline as tpipeline
from spatialflink_tpu_torch.checkpoint import (
    CheckpointCorruptError,
    load_checkpoint,
)
from spatialflink_tpu_torch.driver import (
    RetryPolicy,
    WindowedDataflowDriver,
    _toy_pipeline,
    render_range_result,
    strict_driver,
)
from spatialflink_tpu_torch.faults import (
    ABORT_EXIT_CODE,
    InjectedFault,
    faults,
)
from spatialflink_tpu_torch.operators import (
    PointPointJoinQuery,
    PointPointKNNQuery,
    PointPointRangeQuery,
    PointPolygonRangeQuery,
    QueryConfiguration,
    QueryType,
    TJoinQuery,
    TStatsQuery,
)
from spatialflink_tpu_torch.streams.sinks import TransactionalFileSink
from spatialflink_tpu_torch.streams.soa import SoaWindowAssembler
from spatialflink_tpu_torch.telemetry import telemetry

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _clean():
    yield
    faults.disarm()
    jfaults.disarm()
    telemetry.disable()
    jtelemetry.disable()
    tpipeline.uninstall()


def _run_range(driver=None, radius=1.5, n_events=120):
    grid, conf, source, query = _toy_pipeline(n_events=n_events)
    op = PointPointRangeQuery(conf, grid, device="cpu")
    return list(op.run(source(), [query], radius, driver=driver)), op


def _range_pipeline(workdir, *, fault_plan=None, checkpoint_every=2,
                    retry=None, failover=False, pipeline=None,
                    with_overload=False):
    """One (possibly fault-armed) checkpointed range pipeline leg on the
    CPU; returns the driver (crashes propagate to the caller). With
    ``with_overload`` an admission controller with no budget is attached:
    nothing sheds, but every event passes the ``overload.admit`` point."""
    from spatialflink_tpu_torch import overload

    grid, conf, source, query = _toy_pipeline()
    sink = TransactionalFileSink(os.path.join(workdir, "egress.csv"))
    driver = WindowedDataflowDriver(
        checkpoint_path=os.path.join(workdir, "ckpt.bin"),
        checkpoint_every=checkpoint_every, sink=sink,
        retry=retry or RetryPolicy(max_retries=1, backoff_s=0.0),
        failover=failover, pipeline=pipeline,
        overload=(overload.OverloadController(overload.OverloadPolicy())
                  if with_overload else None),
    )
    op = PointPointRangeQuery(conf, grid, device="cpu")
    if fault_plan:
        faults.arm(fault_plan)
    try:
        for res in op.run(source(), [query], 1.5, driver=driver):
            for line in render_range_result(res):
                sink.stage(line)
    finally:
        faults.disarm()
    return driver


def _jax_range_egress(workdir, device_path=False) -> bytes:
    """The JAX driver's egress over the toy stream (float32, as the
    port), checkpointed every 2 windows into a transactional sink. Off
    ``device_path`` the JAX driver runs its numpy route from window 1."""
    grid, conf, source, query = jdriver._toy_pipeline()
    sink = JSink(os.path.join(workdir, "egress.csv"))
    drv = jdriver.WindowedDataflowDriver(
        checkpoint_path=os.path.join(workdir, "ckpt.bin"),
        checkpoint_every=2, sink=sink,
        retry=jdriver.RetryPolicy(max_retries=0, backoff_s=0.0),
        failover=not device_path)
    if not device_path:
        jfaults.arm([{"point": "driver.window", "at": 1, "times": 10**9}])
    try:
        for res in JRangeQ(conf, grid).run(source(), [query], 1.5,
                                           dtype=np.float32, driver=drv):
            for line in jdriver.render_range_result(res):
                sink.stage(line)
    finally:
        jfaults.disarm()
    assert drv.backend == ("device" if device_path else "fallback")
    with open(os.path.join(workdir, "egress.csv"), "rb") as f:
        return f.read()


@pytest.fixture(scope="module")
def jax_range_egress(tmp_path_factory):
    return _jax_range_egress(str(tmp_path_factory.mktemp("jax_range")))


def test_jax_device_path_agrees_within_its_fma_contract(tmp_path,
                                                        jax_range_egress):
    """The JAX device path's egress: the same lines but for the distance,
    which its jitted x² + y² may contract into an FMA; within the JAX
    tests' rtol 3e-7 of the numpy route, and so of the port."""
    dev = _jax_range_egress(str(tmp_path), device_path=True)
    a = [ln.rsplit(",", 1) for ln in dev.decode().splitlines()]
    b = [ln.rsplit(",", 1) for ln in jax_range_egress.decode().splitlines()]
    assert [x[0] for x in a] == [x[0] for x in b] and len(a) > 20
    np.testing.assert_allclose([float(x[1]) for x in a],
                               [float(x[1]) for x in b], rtol=3e-7)


class TestPlainLoopEquivalence:
    def test_default_driver_matches_direct_iteration(self):
        """Routing run() through a default driver is the plain loop: the
        same windows, objects and distances, bit for bit."""
        base, _ = _run_range()
        driven, _ = _run_range(driver=WindowedDataflowDriver())
        assert len(base) == len(driven) > 0
        for a, b in zip(base, driven):
            assert (a.start, a.end, a.window_count) == \
                (b.start, b.end, b.window_count)
            assert [p.obj_id for p in a.objects] == \
                [p.obj_id for p in b.objects]
            np.testing.assert_array_equal(a.dists, b.dists)

    def test_strict_driver_equals_the_jax_strict_driver(self,
                                                        jax_range_egress):
        got, _ = _run_range()
        lines = "".join(ln + "\n" for r in got
                        for ln in render_range_result(r)).encode()
        assert lines == jax_range_egress
        d = strict_driver()
        assert (d.retry.max_retries, d.failover, d.checkpoint_path) == \
            (0, False, None)

    def test_tstats_through_default_driver(self):
        grid, conf, source, _ = _toy_pipeline()
        base = list(TStatsQuery(conf, grid, device="cpu").run(source()))
        driven = list(TStatsQuery(conf, grid, device="cpu").run(
            source(), driver=WindowedDataflowDriver()))
        assert len(base) == len(driven) > 0
        for a, b in zip(base, driven):
            assert a.stats == b.stats

    def test_no_driver_keeps_old_error_semantics(self):
        """Without an explicit driver a device-path failure propagates at
        once: no silent retry, no silent completion on the twin."""
        faults.arm([{"point": "driver.window", "at": 1, "times": 1}])
        with pytest.raises(InjectedFault):
            _run_range()  # one transient fault; a retry would recover
        assert faults.counts.get("driver.window") == 1

    def test_realtime_tstats_is_never_retried(self):
        grid, _, source, _ = _toy_pipeline()
        conf = QueryConfiguration(QueryType.RealTime)
        faults.arm([{"point": "driver.window", "at": 2, "times": 1}])
        drv = WindowedDataflowDriver(
            retry=RetryPolicy(max_retries=5, backoff_s=0.0))
        with pytest.raises(InjectedFault):
            list(TStatsQuery(conf, grid, device="cpu").run(source(),
                                                           driver=drv))
        assert drv.stats["retries"] == 0
        assert drv.stats["failovers"] == 0

    def test_pipelined_driver_is_bit_identical(self, tmp_path):
        """The split protocol under a pipeline policy: the same egress as
        the synchronous loop, with windows overlapped and drained before
        every checkpoint."""
        sync = tmp_path / "sync"
        pipe = tmp_path / "pipe"
        sync.mkdir()
        pipe.mkdir()
        _range_pipeline(str(sync))
        telemetry.enable()
        _range_pipeline(str(pipe), pipeline=tpipeline.PipelinePolicy(
            depth=2, fetch_lag=2))
        counts = telemetry.pipeline_counters()
        assert counts["overlapped"] > 0 and counts["drains"] > 0
        assert (pipe / "egress.csv").read_bytes() == \
            (sync / "egress.csv").read_bytes()


class TestMigratedOperators:
    """kNN, join and tJoin's pane engine route through the driver: strict
    without one, failover parity with one (the twins), and the bucketed
    join without a twin staying strict."""

    def _knn(self, driver=None):
        grid, conf, source, query = _toy_pipeline()
        op = PointPointKNNQuery(conf, grid, device="cpu")
        return list(op.run(source(), query, 2.5, 3, driver=driver))

    def _join(self, driver=None, naive=False):
        grid, conf, source, _ = _toy_pipeline()
        if naive:
            # Micro-batches wide enough that each holds both sides of the
            # interleaved stream (events are 100 ms apart).
            conf = QueryConfiguration(QueryType.RealTimeNaive,
                                      realtime_batch_ms=2000)
        op = PointPointJoinQuery(conf, grid, device="cpu")
        left = [e for i, e in enumerate(source()) if i % 2 == 0]
        right = [e for i, e in enumerate(source()) if i % 2 == 1]
        return list(op.run(iter(left), iter(right), 1.5, driver=driver))

    def test_knn_no_driver_is_single_attempt(self):
        faults.arm([{"point": "driver.window", "at": 1, "times": 1}])
        with pytest.raises(InjectedFault):
            self._knn()
        assert faults.counts.get("driver.window") == 1

    def test_join_no_driver_is_single_attempt(self):
        faults.arm([{"point": "driver.window", "at": 1, "times": 1}])
        with pytest.raises(InjectedFault):
            self._join()
        assert faults.counts.get("driver.window") == 1

    def test_knn_failover_parity(self):
        base = self._knn()
        faults.arm([{"point": "driver.window", "at": 2, "times": 10_000}])
        drv = WindowedDataflowDriver(
            retry=RetryPolicy(max_retries=0, backoff_s=0.0))
        driven = self._knn(driver=drv)
        faults.disarm()
        assert drv.backend == "fallback"
        assert len(driven) == len(base) > 4
        assert any(r.neighbors for r in base), "degenerate: no neighbors"
        for a, b in zip(base, driven):
            assert (a.start, a.end) == (b.start, b.end)
            # The same ordered winners and representatives, and (the port
            # computes op by op on both routes) the same distance bits.
            assert [(oid, d, ev.obj_id, ev.timestamp)
                    for oid, d, ev in a.neighbors] == \
                [(oid, d, ev.obj_id, ev.timestamp)
                 for oid, d, ev in b.neighbors]

    def test_knn_failover_equals_the_jax_driver(self):
        """The port's failover run against the JAX driver's on the same
        stream (float32): the JAX test's contract, the same ordered
        winners and distances within rtol 3e-7."""
        faults.arm([{"point": "driver.window", "at": 2, "times": 10_000}])
        driven = self._knn(driver=WindowedDataflowDriver(
            retry=RetryPolicy(max_retries=0, backoff_s=0.0)))
        faults.disarm()
        from spatialflink_tpu.operators.knn_query import (
            PointPointKNNQuery as JKnn,
        )

        grid, conf, source, query = jdriver._toy_pipeline()
        want = list(JKnn(conf, grid).run(source(), query, 2.5, 3,
                                         dtype=np.float32))
        assert len(want) == len(driven) > 4
        for a, b in zip(want, driven):
            assert (a.start, a.end) == (b.start, b.end)
            assert [(oid, ev.obj_id) for oid, _, ev in a.neighbors] == \
                [(oid, ev.obj_id) for oid, _, ev in b.neighbors]
            np.testing.assert_allclose([d for _, d, _ in a.neighbors],
                                       [d for _, d, _ in b.neighbors],
                                       rtol=3e-7)

    def test_join_naive_failover_parity(self):
        base = self._join(naive=True)
        faults.arm([{"point": "driver.window", "at": 1, "times": 10_000}])
        drv = WindowedDataflowDriver(
            retry=RetryPolicy(max_retries=0, backoff_s=0.0))
        driven = self._join(driver=drv, naive=True)
        faults.disarm()
        assert drv.backend == "fallback"
        assert len(driven) == len(base) > 0
        assert any(r.pairs for r in base), "degenerate: no pairs"
        for a, b in zip(base, driven):
            assert [(x.obj_id, y.obj_id, d) for x, y, d in a.pairs] == \
                [(x.obj_id, y.obj_id, d) for x, y, d in b.pairs]

    def test_join_bucketed_has_no_twin_and_stays_strict(self):
        """The grid join's pair order is the kernel's output order: no
        twin exists, so even a failover-enabled driver crashes when the
        device path dies."""
        faults.arm([{"point": "driver.window", "at": 1, "times": 10_000}])
        drv = WindowedDataflowDriver(
            retry=RetryPolicy(max_retries=0, backoff_s=0.0))
        with pytest.raises(InjectedFault):
            self._join(driver=drv)
        assert drv.stats["failovers"] == 0

    def test_join_retry_equals_unarmed_run(self):
        base = self._join()
        faults.arm([{"point": "driver.window", "at": 2, "times": 2}])
        drv = WindowedDataflowDriver(
            retry=RetryPolicy(max_retries=2, backoff_s=0.0))
        driven = self._join(driver=drv)
        assert drv.stats["retries"] == 2 and drv.backend == "device"
        assert [(r.start, [(x.obj_id, y.obj_id, d) for x, y, d in r.pairs])
                for r in driven] == \
            [(r.start, [(x.obj_id, y.obj_id, d) for x, y, d in r.pairs])
             for r in base]

    def test_polygon_range_has_no_twin_and_stays_strict(self):
        from spatialflink_tpu_torch.models.objects import Polygon

        grid, conf, source, _ = _toy_pipeline()
        square = Polygon(rings=[[[3, 3], [5, 3], [5, 5], [3, 5], [3, 3]]])
        faults.arm([{"point": "driver.window", "at": 1, "times": 10_000}])
        drv = WindowedDataflowDriver(
            retry=RetryPolicy(max_retries=0, backoff_s=0.0))
        with pytest.raises(InjectedFault):
            list(PointPolygonRangeQuery(conf, grid, device="cpu").run(
                source(), [square], 0.5, driver=drv))
        assert drv.stats["failovers"] == 0

    def test_tjoin_panes_checkpoint_resume_byte_identical(self, tmp_path):
        """run_soa_panes through run_precomputed: the position counts
        fired windows; a resume reruns the deterministic scan and skips
        the committed prefix (the driver.window and source.stall
        points)."""
        for point in ("driver.window", "source.stall"):
            d = tmp_path / point
            d.mkdir()
            chaos_tjoin_panes(d, point)


def _tjoin_chunks(side, n_chunks=10, per=8):
    rng = np.random.default_rng(21 + side)
    out = []
    for c in range(n_chunks):
        base = c * per
        out.append({
            "ts": np.arange(base, base + per, dtype=np.int64) * 250,
            "x": rng.uniform(0.0, 8.0, per),
            "y": rng.uniform(0.0, 8.0, per),
            "oid": (np.arange(base, base + per) % 5).astype(np.int32),
        })
    return out


def run_tjoin_panes_leg(workdir, fault_plan=None):
    grid, conf, _, _ = _toy_pipeline()
    op = TJoinQuery(conf, grid, device="cpu")
    sink = TransactionalFileSink(os.path.join(workdir, "egress.csv"))
    driver = WindowedDataflowDriver(
        checkpoint_path=os.path.join(workdir, "ckpt.bin"),
        checkpoint_every=1, sink=sink,
        retry=RetryPolicy(max_retries=1, backoff_s=0.0), failover=False,
    )
    if fault_plan:
        faults.arm(fault_plan)
    try:
        for s, e, lo, ro, dd, cnt, over in op.run_soa_panes(
                _tjoin_chunks(0), _tjoin_chunks(1), 1.5, 5, driver=driver):
            for a, b, d in zip(lo, ro, dd):
                sink.stage(f"{s},{e},{int(a)},{int(b)},{float(d)!r}")
    finally:
        faults.disarm()
    return driver


def chaos_tjoin_panes(tmp_path, point, kind="raise", at=4):
    clean = tmp_path / "clean"
    chaos = tmp_path / "chaos"
    clean.mkdir()
    chaos.mkdir()
    run_tjoin_panes_leg(str(clean))
    want = (clean / "egress.csv").read_bytes()
    assert want, "vacuous leg: clean egress is empty"
    with pytest.raises(InjectedFault):
        run_tjoin_panes_leg(str(chaos), fault_plan=[
            {"point": point, "kind": kind, "at": at, "times": 10_000}])
    assert (chaos / "egress.csv").read_bytes() != want
    drv = run_tjoin_panes_leg(str(chaos))  # resume: rescan, skip prefix
    assert drv.stats["resumed"] is True
    assert (chaos / "egress.csv").read_bytes() == want


class TestRetry:
    def test_transient_fault_is_retried_and_recovers(self):
        telemetry.enable()
        base, _ = _run_range()
        faults.arm([{"point": "driver.window", "at": 3, "times": 1}])
        drv = WindowedDataflowDriver(
            retry=RetryPolicy(max_retries=2, backoff_s=0.0))
        driven, _ = _run_range(driver=drv)
        assert drv.stats["retries"] == 1
        assert drv.stats["failovers"] == 0
        assert drv.backend == "device"
        assert len(driven) == len(base)
        for a, b in zip(base, driven):
            np.testing.assert_array_equal(a.dists, b.dists)
        assert telemetry.snapshot()["driver"]["retries"] == 1
        assert "driver_retry" in [e["name"] for e in telemetry.events]

    def test_exhausted_retries_raise_in_strict_mode(self):
        faults.arm([{"point": "driver.window", "at": 1, "times": 99}])
        drv = WindowedDataflowDriver(
            retry=RetryPolicy(max_retries=1, backoff_s=0.0),
            failover=False)
        with pytest.raises(InjectedFault):
            _run_range(driver=drv)
        assert drv.stats["retries"] == 1

    def test_backoff_schedule_pinned_via_sleep_hook(self):
        """The same schedule as the JAX driver's for the same plan."""
        sleeps, jsleeps = [], []
        faults.arm([{"point": "driver.window", "at": 1, "times": 3}])
        drv = WindowedDataflowDriver(
            retry=RetryPolicy(max_retries=3, backoff_s=0.1,
                              multiplier=3.0, sleep=sleeps.append))
        _run_range(driver=drv)
        assert sleeps == [0.1, pytest.approx(0.3), pytest.approx(0.9)]
        assert drv.stats["retries"] == 3
        jfaults.arm([{"point": "driver.window", "at": 1, "times": 3}])
        grid, conf, source, query = jdriver._toy_pipeline()
        jdrv = jdriver.WindowedDataflowDriver(
            retry=jdriver.RetryPolicy(max_retries=3, backoff_s=0.1,
                                      multiplier=3.0, sleep=jsleeps.append))
        list(JRangeQ(conf, grid).run(source(), [query], 1.5,
                                     dtype=np.float32, driver=jdrv))
        assert jsleeps == sleeps and jdrv.stats == drv.stats

    def test_sleep_hook_default_is_time_sleep(self, monkeypatch):
        called = []
        monkeypatch.setattr(driver_mod.time, "sleep", called.append)
        RetryPolicy().do_sleep(0.07)
        assert called == [0.07]


class TestFailoverParity:
    def test_range_failover_set_parity_and_visibility(self, tmp_path):
        telemetry.enable()
        base, _ = _run_range()
        # The device path dies for good at window 3: the numpy twin.
        faults.arm([{"point": "driver.window", "at": 3, "times": 10_000}])
        drv = WindowedDataflowDriver(
            retry=RetryPolicy(max_retries=1, backoff_s=0.0))
        driven, _ = _run_range(driver=drv)
        faults.disarm()
        assert drv.backend == "fallback"
        assert drv.stats["failovers"] == 1
        assert len(driven) == len(base) > 4
        for a, b in zip(base, driven):
            assert (a.start, a.end) == (b.start, b.end)
            assert [p.obj_id for p in a.objects] == \
                [p.obj_id for p in b.objects]
            # Op by op on both routes: the same bits.
            np.testing.assert_array_equal(a.dists, b.dists)
        snap = telemetry.snapshot()
        assert snap["driver"]["failovers"] == 1
        assert "failover" in [e["name"] for e in telemetry.events]
        ledger = tmp_path / "ledger.json"
        telemetry.write_ledger(str(ledger))
        doc = json.loads(ledger.read_text())
        assert doc["snapshot"]["driver"]["failovers"] == 1

    def test_tstats_failover_parity(self):
        grid, conf, source, _ = _toy_pipeline()
        base = list(TStatsQuery(conf, grid, device="cpu").run(source()))
        faults.arm([{"point": "driver.window", "at": 1, "times": 10_000}])
        drv = WindowedDataflowDriver(
            retry=RetryPolicy(max_retries=0, backoff_s=0.0))
        driven = list(TStatsQuery(conf, grid, device="cpu").run(
            source(), driver=drv))
        faults.disarm()
        assert drv.backend == "fallback"
        assert len(driven) == len(base) > 4
        for a, b in zip(base, driven):
            assert set(a.stats) == set(b.stats)
            for oid in a.stats:
                np.testing.assert_allclose(
                    a.stats[oid][0], b.stats[oid][0], rtol=1e-6)
                assert a.stats[oid][1] == b.stats[oid][1]  # exact ms


class TestFailoverResume:
    """A checkpoint taken after a failover records backend "fallback":
    its resume neither stages on the dead device path nor crashes into a
    missing twin."""

    def _failover_checkpoint(self, tmp_path):
        grid, conf, source, query = _toy_pipeline()
        ck = str(tmp_path / "ck.bin")
        drv = WindowedDataflowDriver(
            checkpoint_path=ck, checkpoint_every=1,
            retry=RetryPolicy(max_retries=0, backoff_s=0.0))
        faults.arm([{"point": "driver.window", "at": 1, "times": 10_000}])
        op = PointPointRangeQuery(conf, grid, device="cpu")
        base = list(op.run(source(), [query], 1.5, driver=drv))
        faults.disarm()
        assert drv.backend == "fallback" and base
        return grid, conf, source, query, ck

    def test_resume_after_failover_skips_device_setup(self, tmp_path,
                                                      monkeypatch):
        grid, conf, source, query, ck = self._failover_checkpoint(tmp_path)

        def boom(*a, **k):
            raise AssertionError("resume staged on the dead device path")

        monkeypatch.setattr(PointPointRangeQuery, "_window_evaluator",
                            boom)
        drv2 = WindowedDataflowDriver(
            checkpoint_path=ck,
            retry=RetryPolicy(max_retries=0, backoff_s=0.0))
        op2 = PointPointRangeQuery(conf, grid, device="cpu")
        list(op2.run(source(), [query], 1.5, driver=drv2))
        assert drv2.stats["resumed"] is True
        assert drv2.backend == "fallback"

    def test_resume_fallback_checkpoint_without_fallback_is_loud(
            self, tmp_path):
        grid, conf, source, query, ck = self._failover_checkpoint(tmp_path)
        drv2 = WindowedDataflowDriver(checkpoint_path=ck, failover=False)
        op2 = PointPointRangeQuery(conf, grid, device="cpu")
        with pytest.raises(ValueError, match="failover"):
            list(op2.run(source(), [query], 1.5, driver=drv2))


class TestCheckpointResume:
    def test_crash_resume_egress_byte_identical(self, tmp_path,
                                                jax_range_egress):
        clean = tmp_path / "clean"
        chaos = tmp_path / "chaos"
        clean.mkdir()
        chaos.mkdir()
        _range_pipeline(str(clean))
        want = (clean / "egress.csv").read_bytes()
        assert want == jax_range_egress
        with pytest.raises(InjectedFault):
            _range_pipeline(str(chaos), fault_plan=[
                {"point": "driver.window", "at": 7, "times": 10_000}])
        partial = (chaos / "egress.csv").read_bytes()
        assert partial != want  # the crash really interrupted egress
        drv = _range_pipeline(str(chaos))
        assert drv.stats["resumed"] is True
        assert (chaos / "egress.csv").read_bytes() == want

    def test_resume_skips_consumed_prefix_exactly(self, tmp_path):
        d = tmp_path / "p"
        d.mkdir()
        with pytest.raises(InjectedFault):
            _range_pipeline(str(d), fault_plan=[
                {"point": "window.feed", "at": 70, "times": 10_000}])
        ck = load_checkpoint(str(d / "ckpt.bin"))
        consumed = ck["driver"]["events_consumed"]
        assert 0 < consumed < 120
        drv = _range_pipeline(str(d))
        assert drv.stats["events"] == 120 - consumed

    def test_checkpoint_carries_egress_marker_and_backend(self, tmp_path):
        d = tmp_path / "p"
        d.mkdir()
        drv = _range_pipeline(str(d))
        ck = load_checkpoint(str(d / "ckpt.bin"))
        assert ck["egress"]["bytes"] == \
            os.path.getsize(str(d / "egress.csv"))
        assert ck["driver"]["backend"] == "device"
        assert ck["driver"]["events_consumed"] == 120
        assert ck["driver"]["windows"] == drv.stats["windows"]

    def test_checkpoint_layout_equals_the_jax_drivers(self, tmp_path,
                                                      jax_range_egress):
        """The last checkpoint of the toy run: the same components, the
        same driver record (but the backend, which the JAX oracle's
        numpy route sets to fallback), the same egress marker, the same
        interner and buffered windows as the JAX driver's."""
        from spatialflink_tpu.checkpoint import (
            load_checkpoint as jload,
        )

        d = tmp_path / "p"
        d.mkdir()
        _range_pipeline(str(d))
        jd = tmp_path / "j"
        jd.mkdir()
        _jax_range_egress(str(jd))
        got = load_checkpoint(str(d / "ckpt.bin"))
        want = jload(str(jd / "ckpt.bin"))
        assert got.keys() == want.keys() == {"op", "driver", "egress"}
        assert got["egress"] == want["egress"]
        assert {**got["driver"], "backend": "fallback"} == want["driver"]
        assert got["op"]["interner"] == want["op"]["interner"]
        ga, wa = got["op"]["assembler"], want["op"]["assembler"]
        assert (ga["fired"], ga["max_ts"], ga["dropped_late"]) == \
            (wa["fired"], wa["max_ts"], wa["dropped_late"])
        assert [(k, [(p.obj_id, p.timestamp, p.x, p.y) for p in evs])
                for k, evs in ga["buffers"]] == \
            [(k, [(p.obj_id, p.timestamp, p.x, p.y) for p in evs])
             for k, evs in wa["buffers"]]

    def test_corrupt_checkpoint_fails_loudly_on_resume(self, tmp_path):
        d = tmp_path / "p"
        d.mkdir()
        _range_pipeline(str(d))
        path = str(d / "ckpt.bin")
        data = open(path, "rb").read()
        with open(path, "wb") as f:
            f.write(data[:-5])
        with pytest.raises(CheckpointCorruptError, match="truncated"):
            _range_pipeline(str(d))

    def test_extra_state_and_skip_on_resume(self, tmp_path):
        """``extra_state`` components publish in the same checkpoint, and
        ``skip_on_resume=False`` leaves positioning to the caller's source
        (the offsets a checkpointing consumer would restore)."""
        d = tmp_path / "p"
        d.mkdir()
        grid, conf, source, query = _toy_pipeline()
        events = list(source())
        calls = []

        def extra():
            calls.append(1)
            return {"source": {"offset": 60 + len(calls)}}

        drv = WindowedDataflowDriver(
            checkpoint_path=str(d / "ck.bin"), extra_state=extra,
            flush_at_end=False)
        op = PointPointRangeQuery(conf, grid, device="cpu")
        head = list(op.run(iter(events[:60]), [query], 1.5, driver=drv))
        ck = load_checkpoint(str(d / "ck.bin"))
        assert ck["source"] == {"offset": 60 + len(calls)} and calls
        assert ck["driver"]["events_consumed"] == 60
        drv2 = WindowedDataflowDriver(checkpoint_path=str(d / "ck.bin"),
                                      skip_on_resume=False)
        op2 = PointPointRangeQuery(conf, grid, device="cpu")
        tail = list(op2.run(iter(events[60:]), [query], 1.5, driver=drv2))
        whole, _ = _run_range()
        assert [(r.start, [p.obj_id for p in r.objects])
                for r in head + tail] == \
            [(r.start, [p.obj_id for p in r.objects]) for r in whole]
        assert drv2.stats["events"] == 60

    def test_run_windows_rejects_checkpointing(self):
        drv = WindowedDataflowDriver(checkpoint_path="x.bin")
        drv.op = object()
        drv.process = lambda w: w
        with pytest.raises(ValueError, match="run_windows"):
            list(drv.run_windows(iter([])))

    def test_overload_runs_and_its_state_restores(self, tmp_path):
        """``overload=`` runs, and a checkpoint holding overload state
        restores into the resuming driver's controller."""
        from spatialflink_tpu_torch.overload import (
            OverloadController,
            OverloadPolicy,
            uninstall,
        )

        try:
            ck = str(tmp_path / "ck.bin")
            ctrl = OverloadController(OverloadPolicy(
                max_buffered_events=3, admission_window_ms=500))
            drv = WindowedDataflowDriver(checkpoint_path=ck, overload=ctrl,
                                         source_pausable=False)
            got, _ = _run_range(driver=drv)
            assert got and ctrl.shed_total == drv.stats["shed"] > 0
            state = ctrl.state()
            assert load_checkpoint(ck)["overload"] == state
            ctrl2 = OverloadController(OverloadPolicy())
            grid, conf, source, query = _toy_pipeline()
            drv2 = WindowedDataflowDriver(checkpoint_path=ck, overload=ctrl2)
            drv2.attach(PointPointRangeQuery(conf, grid, device="cpu"))
            assert drv2.stats["resumed"] is True
            assert ctrl2.state() == state
            assert ctrl2.snapshot()["shed"] == ctrl.snapshot()["shed"]
        finally:
            uninstall()


class TestDialDeadline:
    def test_resolution_order(self, monkeypatch):
        monkeypatch.delenv("SFT_DIAL_DEADLINE_S", raising=False)
        assert driver_mod.resolve_dial_deadline_s() == 0.0
        monkeypatch.setenv("SFT_DIAL_DEADLINE_S", "7.5")
        assert driver_mod.resolve_dial_deadline_s() == 7.5
        assert driver_mod.resolve_dial_deadline_s(2.0) == 2.0

    def test_first_window_hang_fires_watchdog_and_seals(
            self, tmp_path, monkeypatch):
        import time as _time

        fired = []
        monkeypatch.setattr(driver_mod, "_dial_timeout_exit", fired.append)
        stream = tmp_path / "run.stream.jsonl"
        telemetry.enable(stream_path=str(stream),
                         stream_flush_interval_s=0.0)
        grid, conf, source, query = _toy_pipeline()
        op = PointPointRangeQuery(conf, grid, device="cpu")
        drv = WindowedDataflowDriver(dial_deadline_s=0.05)

        def slow_first(win):
            _time.sleep(0.4)  # the wedge: past the deadline, window 1 only
            return win

        drv.bind(op, slow_first)
        out = list(drv.run(source()))
        assert out
        assert fired == [driver_mod.DIAL_TIMEOUT_EXIT_CODE]
        telemetry.disable()
        recs = [json.loads(ln) for ln in stream.read_text().splitlines()]
        sealed = [r for r in recs if r.get("t") == "epilogue"]
        assert [r["reason"] for r in sealed] == ["dial_timeout"]

    def test_fast_first_window_never_fires(self, monkeypatch):
        fired = []
        monkeypatch.setattr(driver_mod, "_dial_timeout_exit", fired.append)
        grid, conf, source, query = _toy_pipeline()
        op = PointPointRangeQuery(conf, grid, device="cpu")
        drv = WindowedDataflowDriver(dial_deadline_s=5.0)
        drv.bind(op, lambda win: win)
        out = list(drv.run(source()))
        assert out and fired == []
        assert drv._dialed is True


class TestRejectedConfigPreservesEgress:
    def test_rejected_run_windows_does_not_wipe_prior_egress(self, tmp_path):
        path = str(tmp_path / "out.csv")
        prior = TransactionalFileSink(path)
        prior.reset()
        prior.stage("precious")
        prior.commit()
        grid, conf, source, query = _toy_pipeline()
        sink = TransactionalFileSink(path)
        drv = WindowedDataflowDriver(
            checkpoint_path=str(tmp_path / "ck.bin"), sink=sink)
        drv.bind(PointPointRangeQuery(conf, grid, device="cpu"),
                 lambda w: w)
        with pytest.raises(ValueError, match="run_windows"):
            list(drv.run_windows(iter([])))
        assert open(path, "rb").read() == b"precious\n"


def test_toy_pipeline_is_the_jax_stream():
    grid, conf, source, query = _toy_pipeline()
    jgrid, jconf, jsource, jquery = jdriver._toy_pipeline()
    assert [(p.obj_id, p.timestamp, p.x, p.y) for p in source()] == \
        [(p.obj_id, p.timestamp, p.x, p.y) for p in jsource()]
    assert (conf.window_size_ms, conf.slide_step_ms) == \
        (jconf.window_size_ms, jconf.slide_step_ms)
    assert (grid.n, query.x, query.y) == (jgrid.n, jquery.x, jquery.y)


def test_chaos_child_entry_runs_in_process(tmp_path):
    """``--chaos-child`` on the CPU: a full run, then a second call that
    resumes from the final checkpoint and stages nothing new."""
    assert driver_mod.main(["--chaos-child", str(tmp_path),
                            "--device", "cpu"]) == 0
    first = (tmp_path / "egress.csv").read_bytes()
    assert driver_mod.run_chaos_child(str(tmp_path), device="cpu") == 0
    assert (tmp_path / "egress.csv").read_bytes() == first and first
    # The grid-partitioned child (A12.2 is ported), in process on an
    # eight-shard CPU mesh: its egress equals the JAX child's on the
    # JAX tests' eight CPU devices line for line, every field byte for
    # byte but the distance, which is within 1 ulp: the JAX child has
    # no numpy route, and its jitted program contracts x² + y² into an
    # FMA.
    sharded = tmp_path / "sharded"
    sharded.mkdir()
    assert driver_mod.main(["--chaos-sharded-child", str(sharded),
                            "--device", "cpu"]) == 0
    jdir = tmp_path / "jax_sharded"
    jdir.mkdir()
    assert jdriver.run_chaos_sharded_child(str(jdir)) > 0
    got = (sharded / "egress.csv").read_text().splitlines()
    want = (jdir / "egress.csv").read_text().splitlines()
    assert got and len(got) == len(want)
    for g, w in zip(got, want):
        g, w = g.rsplit(",", 1), w.rsplit(",", 1)
        assert g[0] == w[0]
        a, b = float(g[1]), float(w[1])
        assert abs(a - b) <= np.spacing(max(a, b)), (g, w)


def test_chaos_shard_exchange_leg(tmp_path):
    """``tests/test_chaos_matrix.py``'s ``shard.exchange`` leg in process:
    the partitioned pipeline killed at the halo exchange's fifth hit
    (``raise``), then resumed onto the checkpointed plan, byte-identical
    to the clean run."""
    clean = tmp_path / "clean"
    chaos = tmp_path / "chaos"
    clean.mkdir()
    chaos.mkdir()
    assert driver_mod.run_chaos_sharded_child(str(clean), device="cpu") > 0
    want = (clean / "egress.csv").read_bytes()
    assert want
    faults.arm([{"point": "shard.exchange", "at": 5, "times": 10_000}])
    try:
        with pytest.raises(InjectedFault):
            driver_mod.run_chaos_sharded_child(str(chaos), device="cpu")
    finally:
        faults.disarm()
    assert (chaos / "egress.csv").read_bytes() != want
    assert os.path.exists(chaos / "ckpt.bin")
    driver_mod.run_chaos_sharded_child(str(chaos), device="cpu")
    assert (chaos / "egress.csv").read_bytes() == want


# -- the chaos matrix: the ten points the port threads ------------------------


RANGE_LEGS = [
    ("device.ship", "raise", 5),
    ("device.dispatch", "raise", 5),
    ("device.fetch", "raise", 5),
    ("window.feed", "raise", 70),
    ("driver.window", "raise", 5),
    ("driver.window", "hang", 5),
    ("sink.write", "raise", 3),
    ("sink.write", "partial_write", 3),
    ("source.stall", "raise", 70),
]


@pytest.mark.parametrize("point,kind,at", RANGE_LEGS,
                         ids=[f"{p}-{k}" for p, k, _ in RANGE_LEGS])
def test_chaos_range_leg(tmp_path, jax_range_egress, point, kind, at):
    clean = tmp_path / "clean"
    chaos = tmp_path / "chaos"
    clean.mkdir()
    chaos.mkdir()
    _range_pipeline(str(clean))
    want = (clean / "egress.csv").read_bytes()
    assert want == jax_range_egress and want
    rule = {"point": point, "kind": kind, "at": at, "times": 10_000}
    if kind == "hang":
        rule["hang_s"] = 0.001
    with pytest.raises(InjectedFault):
        _range_pipeline(str(chaos), fault_plan=[rule])
    assert (chaos / "egress.csv").read_bytes() != want
    drv = _range_pipeline(str(chaos))  # resume
    assert drv.stats["resumed"] is True
    assert (chaos / "egress.csv").read_bytes() == want


def test_chaos_overload_admit_leg(tmp_path, jax_range_egress):
    """``tests/test_chaos_matrix.py``'s ``overload.admit`` leg: the
    admission path killed at its 60th hit, resumed byte-identically."""
    from spatialflink_tpu_torch import overload

    clean = tmp_path / "clean"
    chaos = tmp_path / "chaos"
    clean.mkdir()
    chaos.mkdir()
    try:
        _range_pipeline(str(clean), with_overload=True)
        want = (clean / "egress.csv").read_bytes()
        assert want == jax_range_egress and want
        with pytest.raises(InjectedFault):
            _range_pipeline(str(chaos), with_overload=True, fault_plan=[
                {"point": "overload.admit", "at": 60, "times": 10_000}])
        assert (chaos / "egress.csv").read_bytes() != want
        drv = _range_pipeline(str(chaos), with_overload=True)
        assert drv.stats["resumed"] is True
        assert (chaos / "egress.csv").read_bytes() == want
    finally:
        overload.uninstall()


def _soa_chunks(n_chunks=12, per=10):
    rng = np.random.default_rng(11)
    for c in range(n_chunks):
        base = c * per
        yield {
            "ts": np.arange(base, base + per, dtype=np.int64) * 100,
            "x": rng.uniform(0.0, 8.0, per),
            "y": rng.uniform(0.0, 8.0, per),
            "oid": (np.arange(base, base + per) % 7).astype(np.int32),
        }


def run_soa_leg(workdir, fault_plan=None):
    grid, conf, _, _ = _toy_pipeline()
    op = TStatsQuery(conf, grid, device="cpu")
    sink = TransactionalFileSink(os.path.join(workdir, "egress.csv"))
    driver = WindowedDataflowDriver(
        checkpoint_path=os.path.join(workdir, "ckpt.bin"),
        checkpoint_every=1, sink=sink,
        retry=RetryPolicy(max_retries=1, backoff_s=0.0), failover=False)

    def process(win):
        # A host reduction: the leg exercises soa.feed's crash and resume.
        return (win.start, win.end, win.count,
                float(np.sum(win.arrays["x"])))

    driver.bind(op, process)
    if fault_plan:
        faults.arm(fault_plan)
    try:
        asm = SoaWindowAssembler(conf.window_size_ms, conf.slide_step_ms)
        for start, end, count, sx in driver.run_soa(_soa_chunks(), asm):
            sink.stage(f"{start},{end},{count},{float(sx)!r}")
    finally:
        faults.disarm()
    return driver


def test_chaos_soa_leg(tmp_path):
    from test_chaos_matrix import run_soa_leg as jax_soa_leg

    jd = tmp_path / "jax"
    jd.mkdir()
    jax_soa_leg(str(jd))
    clean = tmp_path / "clean"
    chaos = tmp_path / "chaos"
    clean.mkdir()
    chaos.mkdir()
    run_soa_leg(str(clean))
    want = (clean / "egress.csv").read_bytes()
    assert want == (jd / "egress.csv").read_bytes() and want
    with pytest.raises(InjectedFault):
        run_soa_leg(str(chaos), fault_plan=[
            {"point": "soa.feed", "at": 6, "times": 10_000}])
    drv = run_soa_leg(str(chaos))
    assert drv.stats["resumed"] is True
    assert (chaos / "egress.csv").read_bytes() == want


def _child(workdir, plan=None):
    env = {k: v for k, v in os.environ.items()
           if k not in ("SFT_FAULT_PLAN", "SFT_LEDGER_STREAM")}
    env["SFT_PIPELINE"] = json.dumps({"depth": 2, "fetch_lag": 2})
    if plan:
        env["SFT_FAULT_PLAN"] = json.dumps(plan)
    return subprocess.run(
        [sys.executable, "-m", "spatialflink_tpu_torch.driver",
         "--chaos-child", str(workdir), "--device", "cpu"],
        env=env, capture_output=True, text=True, timeout=120, cwd=REPO)


@pytest.mark.parametrize("point", ["pipeline.ship", "pipeline.fetch"])
def test_chaos_pipeline_leg(tmp_path, jax_range_egress, point):
    """The pipelined driver killed mid-overlap (``abort``, exit 137): the
    resumed pipelined child converges to the clean child's bytes, which
    equal the synchronous run's and the JAX driver's."""
    clean = tmp_path / "clean"
    chaos = tmp_path / "chaos"
    clean.mkdir()
    chaos.mkdir()
    p = _child(clean)
    assert p.returncode == 0, p.stderr[-2000:]
    want = (clean / "egress.csv").read_bytes()
    assert want == jax_range_egress and want
    at = 5 if point == "pipeline.ship" else 3
    p = _child(chaos, plan=[{"point": point, "kind": "abort", "at": at}])
    assert p.returncode == ABORT_EXIT_CODE, (p.returncode, p.stderr[-2000:])
    assert (chaos / "egress.csv").read_bytes() != want
    p = _child(chaos)  # resume, still pipelined
    assert p.returncode == 0, p.stderr[-2000:]
    assert (chaos / "egress.csv").read_bytes() == want
