"""Kernel ablation in the PyTorch port (``spatialflink_tpu_torch/
ablation.py``): the substituted dispatch (a learning call, then fresh
zeros of the right structure), the taint across snapshot, ledger and
stream, and ``SFT_ABLATE`` arming.

One case for each case of ``tests/test_ablation.py`` that applies. These
do not: ``test_diff_gate_rejects_tainted_ledger``,
``test_last_good_store_refuses_tainted_records``,
``test_cpu_baseline_refuses_armed_ablation``,
``test_run_ablation_measures_marginal_cost`` and
``test_run_ablation_records_load_bearing_kernels_as_evidence`` test the
bench tooling (``sfprof diff --gate``, ``bench.py``'s last-good store,
``bench_suite.py``'s ``CPU_BASELINE`` writer and ``--ablate`` sweep),
which is not a module of the JAX package and is not ported. The donated
buffer of ``test_pytree_outputs_and_fresh_buffers`` becomes an in-place
write, the port's way of consuming a tensor.

Then the port's own: the zero mirror of the wire digest step's
``KnnPaneDigest`` on its device, and ``run_wire_panes`` with the digest
step ablated (zeros after the learning pane, tainted) and disarmed again
(equal to the unablated run).
"""

import json

import numpy as np
import pytest
import torch

from spatialflink_tpu import ablation as j_ablation_mod
from spatialflink_tpu import faults as j_faults_mod
from spatialflink_tpu import telemetry as j_tel_mod

from spatialflink_tpu_torch.ablation import _parse_spec, ablation
from spatialflink_tpu_torch.faults import faults
from spatialflink_tpu_torch.grid import UniformGrid
from spatialflink_tpu_torch.models.objects import Point
from spatialflink_tpu_torch.operators import (
    PointPointKNNQuery,
    QueryConfiguration,
)
from spatialflink_tpu_torch.ops.knn import KnnPaneDigest
from spatialflink_tpu_torch.ops.wire_knn import (
    WIRE_DIGEST_LABELS,
    select_wire_digest_step,
)
from spatialflink_tpu_torch.streams.wire import WireFormat, wire_panes
from spatialflink_tpu_torch.telemetry import instrument_jit, telemetry
from tools.sfprof import ledger as ledger_mod
from tools.sfprof import stream as stream_mod
from tools.sfprof import trend as trend_mod
from tools.sfprof.cli import main as sfprof_main


def reset_runtime_singletons():
    """Disarm, disable and reset both packages' runtime singletons."""
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


# -- the substituted dispatch -------------------------------------------------


def test_learning_call_then_cached_zeros():
    telemetry.enable()
    f = instrument_jit(lambda x: x * 2 + 1, name="twice")
    x = torch.ones(8, dtype=torch.float32)
    assert float(f(x)[0]) == 3.0
    ablation.arm(["twice"])
    # The first armed call per signature is the REAL kernel (learning).
    assert float(f(x)[0]) == 3.0
    # Then zeros of the same shape, dtype and device.
    out = f(x)
    assert out.shape == (8,) and out.dtype == torch.float32
    assert out.device == x.device
    assert float(out.sum()) == 0.0
    t = ablation.taint_block()
    assert t["kind"] == "ablation"
    assert t["kernels"] == ["twice"]
    assert t["learning_calls"] == {"twice": 1}
    assert t["substituted_calls"] == {"twice": 1}


def test_new_signature_relearns():
    telemetry.enable()
    f = instrument_jit(lambda x: x + 1, name="bump")
    ablation.arm(["bump"])
    assert float(f(torch.ones(4))[0]) == 2.0  # learn (4,)
    assert float(f(torch.ones(4))[0]) == 0.0  # zeros
    # A new abstract shape learns again before substituting.
    assert float(f(torch.ones(6))[0]) == 2.0
    assert float(f(torch.ones(6))[0]) == 0.0


def test_pytree_outputs_and_fresh_buffers():
    """NamedTuple outputs mirror structurally, and each substituted call
    returns FRESH tensors: a caller writing into one in place must never
    reach the cache."""
    from typing import NamedTuple

    class Out(NamedTuple):
        a: object
        b: object

    telemetry.enable()
    f = instrument_jit(lambda x: Out(x * 2, (x.sum(), 7)), name="nt")
    x = torch.ones(16, dtype=torch.float32)
    ablation.arm(["nt"])
    f(x)  # learning
    o1 = f(x)
    assert isinstance(o1, Out)
    assert float(o1.b[0]) == 0.0 and o1.b[1] == 0
    o1.a.add_(1)  # the port's way of consuming a tensor: in place
    o2 = f(x)
    assert float(o2.a.sum()) == 0.0
    assert o2.a.data_ptr() != o1.a.data_ptr()


def test_unablated_kernels_unaffected_and_disarm_restores():
    telemetry.enable()
    f = instrument_jit(lambda x: x * 2, name="keep")
    g = instrument_jit(lambda x: x * 3, name="cut")
    x = torch.ones(4, dtype=torch.float32)
    ablation.arm(["cut"])
    g(x)  # learning
    assert float(g(x)[0]) == 0.0
    assert float(f(x)[0]) == 2.0  # untouched
    ablation.disarm()
    assert float(g(x)[0]) == 3.0  # real again
    # The dispatch table kept recording "keep".
    assert any(r["kernel"] == "keep" for r in telemetry.kernel_table())


def test_works_with_telemetry_disabled():
    f = instrument_jit(lambda x: x + 5, name="solo")
    x = torch.ones(4, dtype=torch.float32)
    ablation.arm(["solo"])
    f(x)
    assert float(f(x)[0]) == 0.0


# -- the taint contract -------------------------------------------------------


def test_taint_rides_snapshot_ledger_and_record(tmp_path):
    telemetry.enable()
    f = instrument_jit(lambda x: x * 2, name="tk")
    x = torch.ones(4, dtype=torch.float32)
    ablation.arm(["tk"])
    f(x)
    f(x)
    assert telemetry.snapshot()["tainted"]["kind"] == "ablation"
    path = telemetry.write_ledger(
        str(tmp_path / "t.json"),
        bench={"config": "c", "points_per_sec": 1.0, "value": 1.0})
    doc = ledger_mod.load(path)
    assert doc["tainted"]["kernels"] == ["tk"]
    assert doc["snapshot"]["tainted"]["kind"] == "ablation"
    assert ledger_mod.validate(doc) == []  # taint is schema-legal


def test_taint_scope_resets_with_a_fresh_capture(tmp_path):
    telemetry.enable()
    f = instrument_jit(lambda x: x * 2, name="tk2")
    ablation.arm(["tk2"])
    f(torch.ones(4))
    f(torch.ones(4))
    ablation.disarm()
    # Disarmed, but substitutions happened THIS capture: still tainted.
    assert telemetry.snapshot()["tainted"] is not None
    # A fresh capture with ablation disarmed starts clean.
    telemetry.enable()
    assert "tainted" not in telemetry.snapshot()
    path = telemetry.write_ledger(str(tmp_path / "clean.json"))
    assert "tainted" not in ledger_mod.load(path)


def test_taint_survives_stream_recovery(tmp_path):
    stream = str(tmp_path / "s.jsonl")
    telemetry.enable(stream_path=stream)
    f = instrument_jit(lambda x: x * 2, name="sk")
    ablation.arm(["sk"])
    f(torch.ones(4))
    f(torch.ones(4))
    telemetry.maybe_flush_stream(force=True)
    telemetry.disable()  # seals
    doc, _info = stream_mod.recover(stream)
    assert trend_mod.taint_of(doc)["kind"] == "ablation"
    # The recovered document is still rejected by the trend gate.
    p = tmp_path / "recovered.json"
    p.write_text(json.dumps(doc))
    hist = tmp_path / "hist"
    hist.mkdir()
    for i, v in enumerate((1.0, 2.0, 3.0)):
        (hist / f"r{i}.json").write_text(json.dumps(
            {"metric": "c", "value": v, "device": "cpu",
             "smoke": False}))
    assert sfprof_main(["trend", str(hist), "--gate", str(p)]) == 1


def test_ablation_armed_event_registered_and_counted():
    from tools.sfprof import events as events_mod

    telemetry.enable()
    ablation.arm(["whatever"])
    telemetry.disable()
    evs = [e for e in telemetry.events if e.get("ph") == "i"]
    names = [e["name"] for e in evs]
    assert "ablation_armed" in names
    counts = events_mod.notable_event_counts(evs)
    assert counts.get("ablation") == 1
    # arm-before-enable (the SFT_ABLATE import-time order): enable
    # re-emits the marker.
    telemetry.enable()
    telemetry.disable()
    assert any(e["name"] == "ablation_armed" for e in telemetry.events)


# -- SFT_ABLATE parsing -------------------------------------------------------


def test_parse_spec_shapes(tmp_path):
    assert _parse_spec("a,b , c") == ["a", "b", "c"]
    assert _parse_spec('["x", "y"]') == ["x", "y"]
    assert _parse_spec('{"kernels": ["z"]}') == ["z"]
    p = tmp_path / "spec.json"
    p.write_text('{"kernels": ["from_file"]}')
    assert _parse_spec(str(p)) == ["from_file"]
    assert _parse_spec("") == []
    with pytest.raises(ValueError):
        _parse_spec('{"kernels": "notalist"}')


def test_maybe_arm_from_env(monkeypatch):
    from spatialflink_tpu_torch.ablation import maybe_arm_from_env

    monkeypatch.setenv("SFT_ABLATE", "k1,k2")
    maybe_arm_from_env()
    assert ablation.armed and ablation.kernels == {"k1", "k2"}
    ablation.disarm()
    monkeypatch.setenv("SFT_ABLATE", "   ")
    with pytest.raises(ValueError):
        maybe_arm_from_env()


# -- the port's kernels -------------------------------------------------------

BEIJING = dict(num_partitions=100, min_x=115.5, max_x=117.6, min_y=39.6,
               max_y=41.1)
WF = WireFormat.for_grid(UniformGrid(**BEIJING))
NSEG, K, RADIUS = 256, 5, 0.05
QUERY = (116.4, 40.19)


def _wire_panes(n_panes=5, n=2000, seed=7):
    """``n_panes`` one-second wire panes of ``n`` points about the query
    (one pane bucket, so one learning call)."""
    rng = np.random.default_rng(seed)
    m = n * n_panes
    ts = np.concatenate([rng.integers(p * 1000, (p + 1) * 1000, n)
                         for p in range(n_panes)])
    ch = {"ts": np.sort(ts).astype(np.int64),
          "x": rng.normal(QUERY[0], 0.03, m),
          "y": rng.normal(QUERY[1], 0.03, m),
          "oid": rng.integers(0, NSEG, m)}
    return list(wire_panes([ch], WF, 1000, 0))


def test_wire_digest_zero_mirror_keeps_the_named_tuple():
    pane = torch.from_numpy(_wire_panes(1)[0])
    kind, step = select_wire_digest_step(
        pane, pane.shape[1], np.float32(QUERY), WF.scale, WF.origin,
        np.float32(RADIUS), num_segments=NSEG)
    f = instrument_jit(step, name=WIRE_DIGEST_LABELS[kind])
    ablation.arm([WIRE_DIGEST_LABELS[kind]])
    real = f(pane, pane.shape[1])
    zero = f(pane, pane.shape[1])
    assert type(zero) is KnnPaneDigest is type(real)
    for a, b in zip(zero, real):
        assert a.shape == b.shape and a.dtype == b.dtype
        assert a.device == b.device and not bool(a.any())


def _headline(panes):
    conf = QueryConfiguration(window_size=2.0, slide_step=1.0)
    op = PointPointKNNQuery(conf, UniformGrid(**BEIJING), device="cpu")
    return list(op.run_wire_panes(panes, Point(x=QUERY[0], y=QUERY[1]),
                                  RADIUS, K, NSEG, WF))


def test_ablated_digest_step_gives_zeros_then_disarm_restores():
    panes = _wire_panes()
    base = _headline(panes)
    telemetry.enable()
    ablation.arm([WIRE_DIGEST_LABELS["torch"]])
    ablated = _headline(panes)
    taint = telemetry.snapshot()["tainted"]
    assert taint["learning_calls"] == {"wire_digest_xla": 1}
    assert taint["substituted_calls"] == {"wire_digest_xla": len(panes) - 1}
    # Windows of only substituted panes see all-zero digests: every
    # object at distance 0 with representative 0.
    for w in ablated[2:]:
        assert w[4] == K and not np.any(w[3])
    assert [w[:2] for w in ablated] == [w[:2] for w in base]
    ablation.disarm()
    again = _headline(panes)
    assert len(again) == len(base)
    for g, w in zip(again, base):
        assert g[:2] == w[:2] and g[4] == w[4]
        assert np.array_equal(g[2], w[2])
        assert np.array_equal(g[3].view(np.uint32), w[3].view(np.uint32))
