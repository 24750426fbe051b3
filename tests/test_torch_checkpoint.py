"""Checkpoints in the port (``spatialflink_tpu_torch/checkpoint.py``) and
a JAX checkpoint carried across (``state.load_jax_checkpoint``), on the
CPU, with the JAX package's ``checkpoint.py`` and its tests as the
oracle.

- The framed format: the port's file for a component dict is the JAX
  package's byte for byte (magic, ``>IIQ`` version / CRC32 / length, the
  pickle), each package loads the other's, and a CRC flip, a truncation,
  a bad magic or a newer version raise ``CheckpointCorruptError``; a
  headerless round-1 file still loads.
- The component round trips of ``tests/test_io_and_state.py`` (window
  assembler, tAggregate's MapState, its round-1 format) and tStats'
  running state, the SoA assemblers and the interner.
- ``tests/test_checkpoint_panes.py``'s six kill-and-resume cases: the
  kNN ``query_panes``, ``run_soa_panes`` and ``run_wire_panes`` carries
  and the join's ``query_panes`` carry, cut mid-stream, saved, restored
  into a fresh operator and continued, equal to the uninterrupted run.
- A checkpoint holds numpy only (a walk of the component tree finds no
  ``torch.Tensor``), a restored carry is a copy, and the components that
  wait for later items raise naming them.
- ``load_jax_checkpoint``: a JAX driver run killed mid-stream and resumed
  by the port's driver writes the JAX run's uninterrupted egress (on the
  JAX device path over a lattice stream, where its FMA cannot round
  differently, and over the toy stream on the JAX numpy route); a JAX
  ``query_panes`` checkpoint resumed by a port operator continues the JAX
  windows; a class off the allow-list raises.
"""

import os
import pickle
import struct
import zlib

import numpy as np
import pytest
import torch

from spatialflink_tpu import checkpoint as jck
from spatialflink_tpu import driver as jdriver
from spatialflink_tpu.faults import InjectedFault as JInjected
from spatialflink_tpu.faults import faults as jfaults
from spatialflink_tpu.grid import UniformGrid as JGrid
from spatialflink_tpu.models.objects import Point as JPoint
from spatialflink_tpu.operators import PointPointKNNQuery as JKnn
from spatialflink_tpu.operators import PointPointRangeQuery as JRangeQ
from spatialflink_tpu.operators import QueryConfiguration as JConf
from spatialflink_tpu.operators import QueryType as JQT
from spatialflink_tpu.streams.sinks import TransactionalFileSink as JSink

from spatialflink_tpu_torch import checkpoint as ck
from spatialflink_tpu_torch.checkpoint import (
    CheckpointCorruptError,
    assembler_state,
    interner_state,
    load_checkpoint,
    operator_state,
    restore_assembler,
    restore_interner,
    restore_operator,
    restore_soa_assembler,
    save_checkpoint,
    soa_assembler_state,
)
from spatialflink_tpu_torch.driver import (
    RetryPolicy,
    WindowedDataflowDriver,
    render_range_result,
)
from spatialflink_tpu_torch.faults import faults
from spatialflink_tpu_torch.grid import UniformGrid
from spatialflink_tpu_torch.models.objects import Point
from spatialflink_tpu_torch.operators import (
    PointPointJoinQuery,
    PointPointKNNQuery,
    PointPointRangeQuery,
    QueryConfiguration,
    QueryType,
    TAggregateQuery,
    TStatsQuery,
)
from spatialflink_tpu_torch.state import load_jax_checkpoint
from spatialflink_tpu_torch.streams.sinks import TransactionalFileSink
from spatialflink_tpu_torch.streams.soa import (
    RaggedSoaWindowAssembler,
    SoaWindowAssembler,
)
from spatialflink_tpu_torch.streams.windows import (
    TumblingEventTimeWindows,
    WindowAssembler,
)
from spatialflink_tpu_torch.utils.interning import Interner

GRID = UniformGrid(20, 0.0, 10.0, 0.0, 10.0)
CONF = QueryConfiguration(QueryType.WindowBased, window_size=10,
                          slide_step=5)


@pytest.fixture(autouse=True)
def _disarm():
    yield
    faults.disarm()
    jfaults.disarm()


@pytest.fixture
def rng():
    return np.random.default_rng(21)


# -- the framed format ---------------------------------------------------------


COMPONENTS = {
    "op": {"interner": {"table": ["a", "b"]}, "running": {"a": (1.5, 2)}},
    "driver": {"events_consumed": 7, "windows": 3, "backend": "device"},
    "egress": {"bytes": 12, "records": 2},
    "arr": np.arange(6, dtype=np.int64).reshape(2, 3),
}


def _same(a, b):
    if isinstance(a, np.ndarray):
        return np.array_equal(a, b) and a.dtype == b.dtype
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    return a == b


def test_frame_is_the_jax_frame_byte_for_byte(tmp_path):
    port, jax_ = str(tmp_path / "p.bin"), str(tmp_path / "j.bin")
    save_checkpoint(port, **COMPONENTS)
    jck.save_checkpoint(jax_, **COMPONENTS)
    data = open(port, "rb").read()
    assert data == open(jax_, "rb").read()
    payload = pickle.dumps(COMPONENTS, protocol=pickle.HIGHEST_PROTOCOL)
    assert data[:8] == ck.CHECKPOINT_MAGIC == jck.CHECKPOINT_MAGIC
    assert data[8:24] == struct.pack(">IIQ", ck.CHECKPOINT_VERSION,
                                     zlib.crc32(payload), len(payload))
    assert data[24:] == payload  # the file minus the pickle is the header
    assert _same(load_checkpoint(jax_), COMPONENTS)
    assert _same(jck.load_checkpoint(port), COMPONENTS)
    assert not os.path.exists(port + ".tmp")  # published by rename


@pytest.mark.parametrize("damage,match", [
    (lambda d: d[:30] + bytes([d[30] ^ 0x40]) + d[31:], "CRC32"),
    (lambda d: d[:-5], "truncated"),
    (lambda d: d[:20], "truncated"),
    (lambda d: b"NOTACKPT" + d[8:], "magic"),
    (lambda d: d[:8] + struct.pack(">I", 99) + d[12:], "newer build"),
])
def test_corruption_raises_as_in_jax(tmp_path, damage, match):
    path = str(tmp_path / "c.bin")
    save_checkpoint(path, **COMPONENTS)
    with open(path, "rb") as f:
        bad = damage(f.read())
    with open(path, "wb") as f:
        f.write(bad)
    for load in (load_checkpoint, load_jax_checkpoint):
        with pytest.raises(CheckpointCorruptError, match=match) as e:
            load(path)
        assert e.value.path == path
    with pytest.raises(jck.CheckpointCorruptError, match=match):
        jck.load_checkpoint(path)


def test_legacy_headerless_checkpoint(tmp_path):
    path = str(tmp_path / "legacy.pkl")
    with open(path, "wb") as f:
        pickle.dump(COMPONENTS, f, protocol=pickle.HIGHEST_PROTOCOL)
    assert _same(load_checkpoint(path), COMPONENTS)
    assert _same(load_jax_checkpoint(path), COMPONENTS)
    with open(path, "wb") as f:
        f.write(pickle.dumps(COMPONENTS)[:-9])
    with pytest.raises(CheckpointCorruptError, match="legacy"):
        load_checkpoint(path)
    with open(path, "wb") as f:
        pickle.dump([1, 2], f, protocol=pickle.HIGHEST_PROTOCOL)
    with pytest.raises(CheckpointCorruptError, match="component dict"):
        load_checkpoint(path)


# -- component round trips -----------------------------------------------------


def test_checkpoint_roundtrip_assembler(tmp_path):
    def asm_():
        return WindowAssembler(TumblingEventTimeWindows(10_000),
                               timestamp_fn=lambda e: e.timestamp)

    asm = asm_()
    for i in range(5):
        asm.feed(Point(obj_id=f"p{i}", timestamp=i * 1000, x=i, y=i))
    path = str(tmp_path / "ckpt.pkl")
    save_checkpoint(path, assembler=assembler_state(asm))
    asm2 = asm_()
    restore_assembler(asm2, load_checkpoint(path)["assembler"])
    fired_orig = asm.feed(Point(obj_id="x", timestamp=15_000, x=0, y=0))
    fired_rest = asm2.feed(Point(obj_id="x", timestamp=15_000, x=0, y=0))
    assert [(w.start, w.end, [p.obj_id for p in w.events])
            for w in fired_orig] == \
        [(w.start, w.end, [p.obj_id for p in w.events]) for w in fired_rest]
    assert fired_orig


def _agg_points():
    return [Point(obj_id=f"tr{i % 2}", timestamp=i * 1000, x=1.0 + i * 0.1,
                  y=1.0) for i in range(20)]


def test_checkpoint_roundtrip_taggregate(tmp_path):
    conf = QueryConfiguration(QueryType.WindowBased, window_size=10,
                              slide_step=10)
    op = TAggregateQuery(conf, GRID, aggregate="ALL", device="cpu")
    list(op.run(iter(_agg_points())))
    path = str(tmp_path / "agg.pkl")
    save_checkpoint(path, op=operator_state(op))
    op2 = TAggregateQuery(conf, GRID, aggregate="ALL", device="cpu")
    restore_operator(op2, load_checkpoint(path)["op"])
    for a in ("_skeys", "_smin", "_smax"):
        np.testing.assert_array_equal(getattr(op2, a), getattr(op, a))
    assert op2.interner._to_key == op.interner._to_key
    more = [Point(obj_id="tr0", timestamp=30_000, x=5.0, y=5.0)]
    assert list(op2.run(iter(more)))[-1].cells == \
        list(op.run(iter(more)))[-1].cells


def test_checkpoint_restores_round1_agg_format(tmp_path):
    conf = QueryConfiguration(QueryType.WindowBased, window_size=10,
                              slide_step=10)
    op = TAggregateQuery(conf, GRID, aggregate="ALL", device="cpu")
    list(op.run(iter(_agg_points())))
    legacy = dict(operator_state(op))
    legacy["agg_state"] = {
        (int(k) >> 32, op.interner.lookup(int(k) & 0xFFFFFFFF)):
            (int(mn), int(mx))
        for k, mn, mx in zip(op._skeys, op._smin, op._smax)
    }
    path = str(tmp_path / "agg_legacy.pkl")
    save_checkpoint(path, op=legacy)
    op2 = TAggregateQuery(conf, GRID, aggregate="ALL", device="cpu")
    restore_operator(op2, load_checkpoint(path)["op"])
    for a in ("_skeys", "_smin", "_smax"):
        np.testing.assert_array_equal(getattr(op2, a), getattr(op, a))


def test_tstats_running_state_and_interner_roundtrip(tmp_path):
    conf = QueryConfiguration(QueryType.RealTime, realtime_batch_ms=1000)
    pts = [Point(obj_id=f"t{i % 3}", timestamp=i * 300, x=i * 0.1,
                 y=i * 0.05) for i in range(30)]
    whole = list(TStatsQuery(conf, GRID, device="cpu").run(iter(pts)))
    op = TStatsQuery(conf, GRID, device="cpu")
    drv = WindowedDataflowDriver(flush_at_end=False)
    part1 = list(op.run(iter(pts[:16]), driver=drv))
    path = str(tmp_path / "ts.bin")
    save_checkpoint(path, op=operator_state(op))
    op2 = TStatsQuery(conf, GRID, device="cpu")
    restore_operator(op2, load_checkpoint(path)["op"])
    assert op2._running == op._running and op2._running
    part2 = list(op2.run(iter(pts[16:])))
    assert [(r.start, r.stats) for r in part1 + part2] == \
        [(r.start, r.stats) for r in whole]
    it = Interner()
    it.intern_many(["z", "a", "m"])
    it2 = Interner()
    restore_interner(it2, interner_state(it))
    assert it2.intern("a") == 1 and it2.intern("new") == 3


def test_soa_assemblers_roundtrip_equal_jax_snapshots():
    from spatialflink_tpu.streams.soa import SoaWindowAssembler as JSoa

    rng = np.random.default_rng(5)
    chunks = [{"ts": np.arange(c * 40, c * 40 + 40, dtype=np.int64) * 50,
               "x": rng.uniform(0, 10, 40), "y": rng.uniform(0, 10, 40),
               "oid": rng.integers(0, 9, 40).astype(np.int32)}
              for c in range(6)]
    a, ja = SoaWindowAssembler(2000, 1000), JSoa(2000, 1000)
    for c in chunks[:3]:
        a.feed(c)
        ja.feed(c)
    snap, jsnap = soa_assembler_state(a), jck.soa_assembler_state(ja)
    assert _same({k: v for k, v in snap.items() if k != "chunks"},
                 {k: v for k, v in jsnap.items() if k != "chunks"})
    assert all(_same(x, y) for x, y in zip(snap["chunks"], jsnap["chunks"]))
    b = SoaWindowAssembler(2000, 1000)
    restore_soa_assembler(b, jsnap)  # a JAX snapshot restores in the port
    for c in chunks[3:]:
        got, want = b.feed(c), a.feed(c)
        assert [(w.start, w.end, w.count) for w in got] == \
            [(w.start, w.end, w.count) for w in want]
    ring = np.array([[0, 0], [1, 0], [1, 1], [0, 0]], np.float64)
    r = RaggedSoaWindowAssembler(2000, 1000)
    r.feed({"ts": np.asarray([10, 20], np.int64),
            "oid": np.asarray([1, 2], np.int32),
            "lengths": np.asarray([4, 4], np.int64),
            "verts": np.concatenate([ring, ring + 2])})
    rs = soa_assembler_state(r)
    r2 = RaggedSoaWindowAssembler(2000, 1000)
    restore_soa_assembler(r2, rs)
    assert [(w.start, w.count) for w in r2.flush()] == \
        [(w.start, w.count) for w in r.flush()]


# -- the six kill-and-resume cases of tests/test_checkpoint_panes.py -----------


def _pts(rng, n, prefix="d", n_obj=24, t_span=40_000, cls=Point):
    xy = rng.uniform(0, 10, (n, 2))
    return [cls(obj_id=f"{prefix}{i % n_obj}", timestamp=int(i * t_span / n),
                x=float(xy[i, 0]), y=float(xy[i, 1])) for i in range(n)]


def _knn_key(results):
    return [(r.start, r.end,
             [(o, d, ev.obj_id, ev.timestamp) for o, d, ev in r.neighbors])
            for r in results]


def _fresh_knn():
    return PointPointKNNQuery(CONF, GRID, device="cpu")


def _roundtrip(op, path):
    save_checkpoint(path, op=operator_state(op))
    return load_checkpoint(path)["op"]


def test_knn_pane_carry_kill_and_resume(rng, tmp_path):
    pts = _pts(rng, 900)
    q = Point(x=5.0, y=5.0)
    r, k, cut = 3.0, 6, 500
    baseline = _knn_key(_fresh_knn().query_panes(iter(pts), q, r, k))
    op1 = _fresh_knn()
    part1 = _knn_key(op1.query_panes(iter(pts[:cut]), q, r, k,
                                     flush_at_end=False))
    state = _roundtrip(op1, str(tmp_path / "knn.ckpt"))
    op2 = _fresh_knn()
    restore_operator(op2, state)
    part2 = _knn_key(op2.query_panes(iter(pts[cut:]), q, r, k))
    assert part1 + part2 == baseline
    assert part1 and part2
    # The uninterrupted port run is the JAX package's (float32 pin).
    jrng = np.random.default_rng(21)
    want = list(JKnn(JConf(JQT.WindowBased, window_size=10, slide_step=5),
                     JGrid(20, 0.0, 10.0, 0.0, 10.0)).query_panes(
        iter(_pts(jrng, 900, cls=JPoint)), JPoint(x=5.0, y=5.0), r, k,
        dtype=np.float32))
    assert [(w[0], w[1], [n[0] for n in w[2]]) for w in baseline] == \
        [(w.start, w.end, [n[0] for n in w.neighbors]) for w in want]


def test_knn_pane_carry_resume_digests_survive(rng):
    pts = _pts(rng, 600, t_span=30_000)
    op1 = _fresh_knn()
    list(op1.query_panes(iter(pts[:360]), Point(x=5.0, y=5.0), 3.0, 5,
                         flush_at_end=False))
    state = operator_state(op1)
    assert any(v is not None for v in state["knn_pane_carry"].values())
    assert state["assembler"]["buffers"]  # open windows buffered


def test_join_pane_carry_kill_and_resume(rng, tmp_path):
    left = _pts(rng, 300, prefix="a")
    right = _pts(np.random.default_rng(9), 240, prefix="b", n_obj=16)
    r = 0.7

    def op_():
        return PointPointJoinQuery(CONF, GRID, device="cpu")

    def collect(gen):
        return [(res.start, res.end, res.overflow,
                 sorted((a.obj_id, a.timestamp, b.obj_id, b.timestamp, d)
                        for a, b, d in res.pairs)) for res in gen]

    baseline = collect(op_().query_panes(iter(left), iter(right), r))
    op1 = op_()
    part1 = collect(op1.query_panes(iter(left[:170]), iter(right[:130]), r,
                                    flush_at_end=False))
    state = _roundtrip(op1, str(tmp_path / "join.ckpt"))
    op2 = op_()
    restore_operator(op2, state)
    part2 = collect(op2.query_panes(iter(left[170:]), iter(right[130:]), r))
    assert part1 + part2 == baseline
    assert part1 and part2


def test_knn_soa_pane_carry_kill_and_resume(rng, tmp_path):
    n = 4_000
    ts = np.sort(rng.integers(0, 40_000, n)).astype(np.int64)
    xs, ys = rng.uniform(0, 10, n), rng.uniform(0, 10, n)
    oids = rng.integers(0, 32, n).astype(np.int32)
    q = Point(x=5.0, y=5.0)

    def chunks(lo, hi, step=700):
        for a in range(lo, hi, step):
            b = min(a + step, hi)
            yield {"ts": ts[a:b], "x": xs[a:b], "y": ys[a:b],
                   "oid": oids[a:b]}

    def collect(gen):
        return [(s, e, o.tolist(), d.view(np.uint32).tolist(), nv)
                for s, e, o, d, nv in gen]

    baseline = collect(_fresh_knn().run_soa_panes(chunks(0, n), q, 3.0, 6,
                                                  num_segments=32))
    op1 = _fresh_knn()
    part1 = collect(op1.run_soa_panes(chunks(0, 2_300), q, 3.0, 6,
                                      num_segments=32, flush_at_end=False))
    state = _roundtrip(op1, str(tmp_path / "soa.ckpt"))
    op2 = _fresh_knn()
    restore_operator(op2, state)
    part2 = collect(op2.run_soa_panes(chunks(2_300, n), q, 3.0, 6,
                                      num_segments=32))
    assert part1 + part2 == baseline
    assert part1 and part2


def _wire_panes(rng, n, t_span, n_ids):
    from spatialflink_tpu_torch.streams.wire import WireFormat, wire_panes

    wf = WireFormat.for_grid(GRID)
    ts = np.sort(rng.integers(0, t_span, n)).astype(np.int64)
    xy = np.stack([rng.uniform(0, 10, n), rng.uniform(0, 10, n)], axis=1)
    xyf = wf.dequantize_np(wf.quantize(xy))
    oids = rng.integers(0, n_ids, n).astype(np.int32)
    panes = list(wire_panes(
        [{"ts": ts, "x": xyf[:, 0].astype(np.float64),
          "y": xyf[:, 1].astype(np.float64), "oid": oids}],
        wf, CONF.slide_step_ms, start_ms=0))
    return wf, panes


def _wire_collect(gen):
    return [(s, e, o.tolist(), d.view(np.uint32).tolist(), nv)
            for s, e, o, d, nv in gen]


def test_knn_wire_pane_carry_kill_and_resume(rng, tmp_path):
    wf, panes = _wire_panes(rng, 5_000, 40_000, 32)
    q = Point(x=5.0, y=5.0)

    def run(op, pane_list, flush=True):
        return _wire_collect(op.run_wire_panes(
            pane_list, q, 3.0, 6, 32, wf, start_ms=0, flush_at_end=flush))

    baseline = run(_fresh_knn(), panes)
    cut = len(panes) // 3
    op1 = _fresh_knn()
    part1 = run(op1, panes[:cut], flush=False)
    state = _roundtrip(op1, str(tmp_path / "wire.ckpt"))
    assert state["knn_wire_pane_carry"]["next_pane"] == cut
    op2 = _fresh_knn()
    restore_operator(op2, state)
    part2 = run(op2, panes[cut:])
    assert part1 + part2 == baseline
    assert part1 and part2


def test_knn_wire_pane_carry_not_reentrant_leak(rng, tmp_path):
    """The index-based wire carry is consumed only right after a restore:
    an ordinary second call is a fresh run, and a checkpoint taken before
    any pane restores to a run that flushes nothing."""
    wf, panes = _wire_panes(rng, 1_500, 20_000, 16)
    q = Point(x=5.0, y=5.0)
    op = _fresh_knn()
    first = _wire_collect(op.run_wire_panes(panes, q, 3.0, 5, 16, wf))
    second = _wire_collect(op.run_wire_panes(panes, q, 3.0, 5, 16, wf))
    assert first == second and first
    op1 = _fresh_knn()
    assert _wire_collect(op1.run_wire_panes([], q, 3.0, 5, 16, wf,
                                            flush_at_end=False)) == []
    state = _roundtrip(op1, str(tmp_path / "wire0.ckpt"))
    op2 = _fresh_knn()
    restore_operator(op2, state)
    assert _wire_collect(op2.run_wire_panes([], q, 3.0, 5, 16, wf)) == []


# -- numpy only, copies, and what waits -----------------------------------------


def _walk(x):
    """Every leaf of a component tree (dicts, lists, tuples, objects'
    ``__dict__``)."""
    if isinstance(x, dict):
        for v in x.values():
            yield from _walk(v)
    elif isinstance(x, (list, tuple)):
        for v in x:
            yield from _walk(v)
    elif hasattr(x, "__dict__") and not isinstance(x, type):
        yield x
        yield from _walk(vars(x))
    else:
        yield x


def _carrying_ops(rng):
    """Operators holding every kind of device carry the port has."""
    q = Point(x=5.0, y=5.0)
    knn = _fresh_knn()
    list(knn.query_panes(iter(_pts(rng, 300)), q, 3.0, 4,
                         flush_at_end=False))
    n = 600
    ts = np.sort(rng.integers(0, 20_000, n)).astype(np.int64)
    list(knn.run_soa_panes(
        [{"ts": ts, "x": rng.uniform(0, 10, n), "y": rng.uniform(0, 10, n),
          "oid": rng.integers(0, 16, n).astype(np.int32)}],
        q, 3.0, 4, num_segments=16, flush_at_end=False))
    wf, panes = _wire_panes(rng, 800, 20_000, 16)
    list(knn.run_wire_panes(panes[:2], q, 3.0, 4, 16, wf,
                            flush_at_end=False))
    join = PointPointJoinQuery(CONF, GRID, device="cpu")
    list(join.query_panes(iter(_pts(rng, 200, "a")),
                          iter(_pts(rng, 200, "b")), 0.7,
                          flush_at_end=False))
    return knn, join


def test_checkpoint_holds_numpy_only(rng, tmp_path):
    knn, join = _carrying_ops(rng)
    for op in (knn, join):
        state = operator_state(op)
        leaves = list(_walk(state))
        assert not [x for x in leaves if isinstance(x, torch.Tensor)]
        assert any(isinstance(x, np.ndarray) for x in leaves) or op is join
    state = operator_state(knn)
    assert {"knn_pane_carry", "knn_pane_carry_soa", "knn_wire_pane_carry",
            "assembler", "soa_assembler", "interner"} <= state.keys()
    assert "join_pane_carry" in operator_state(join)


def test_snapshot_and_restore_are_copies(rng):
    knn, _ = _carrying_ops(rng)
    ps, entry = next((ps, e) for ps, e in knn._pane_carry.items()
                     if e is not None)
    state = operator_state(knn)
    snap = state["knn_pane_carry"][ps][1]
    before = snap.copy()
    entry[1].fill_(-1.0)  # the live carry changes after the snapshot...
    np.testing.assert_array_equal(snap, before)  # ...the snapshot does not
    op2 = _fresh_knn()
    restore_operator(op2, state)
    restored = op2._pane_carry[ps][1]
    assert restored.device == op2.device
    snap[:] = 7.0  # mutating the loaded arrays leaves the restored carry
    np.testing.assert_array_equal(restored.numpy(), before)
    wire = state["knn_wire_pane_carry"]["digests"][0][0]
    wire[:] = 3.0
    assert op2._wire_pane_restored
    assert not torch.equal(op2._wire_pane_carry["digests"][0][0],
                           torch.from_numpy(wire))


@pytest.mark.parametrize("attr,component,item", [
    # The partition plan (A12.2) is ported: its component round-trips
    # now, and the case keeps its id.
    ("partition_plan", "partition", "A12"),
    # The DAG (A11.4b) is ported: its component round-trips now, and the
    # case keeps its id.
    pytest.param("dag_nodes", "dag", None, id="dag_nodes-dag-A11.4"),
])
def test_waiting_components_raise_naming_their_items(attr, component, item,
                                                     tmp_path):
    if item is None:
        _dag_component_round_trips(tmp_path)
        return
    _partition_component_round_trips(tmp_path)


def _partition_component_round_trips(tmp_path):
    """The ``partition`` component (``tests/test_partition.py``'s
    checkpoint case through the port): ``operator_state`` writes the
    JAX frame's plan dict, ``restore_operator`` adopts it, a resuming
    operator planned for another shard count raises the JAX
    ``ValueError``, and a JAX checkpoint carrying a plan restores
    through ``state.load_jax_checkpoint``."""
    from spatialflink_tpu.parallel.partition import (
        plan_partition as jplan_partition,
    )
    from spatialflink_tpu_torch.parallel.partition import plan_partition

    assert "partition" not in ck.WAITING_COMPONENTS
    grid = UniformGrid(64, 0.0, 1.0, 0.0, 1.0)
    conf = QueryConfiguration(QueryType.WindowBased, window_size=10,
                              slide_step=10)
    op = PointPointRangeQuery(conf, grid, device="cpu")
    op.partition_plan = plan_partition(grid, 8, 0.012)
    state = operator_state(op)
    assert state["partition"] == jplan_partition(
        JGrid(64, 0.0, 1.0, 0.0, 1.0), 8, 0.012).to_dict()
    path = str(tmp_path / "plan.ckpt")
    save_checkpoint(path, op=state)
    op2 = PointPointRangeQuery(conf, grid, device="cpu")
    restore_operator(op2, load_checkpoint(path)["op"])
    np.testing.assert_array_equal(op2.partition_plan.bounds,
                                  op.partition_plan.bounds)
    assert op2.partition_plan.to_dict() == op.partition_plan.to_dict()
    op3 = PointPointRangeQuery(conf, grid, device="cpu")
    op3.partition_plan = plan_partition(grid, 4, 0.012)
    with pytest.raises(ValueError, match="shard-count"):
        restore_operator(op3, state)
    # A JAX operator's checkpoint with its plan, resumed in the port.
    jop = JRangeQ(JConf(JQT.WindowBased, window_size=10, slide_step=10),
                  JGrid(64, 0.0, 1.0, 0.0, 1.0))
    jop.partition_plan = jplan_partition(JGrid(64, 0.0, 1.0, 0.0, 1.0), 8,
                                         0.012)
    jpath = str(tmp_path / "jax_plan.ckpt")
    jck.save_checkpoint(jpath, op=jck.operator_state(jop))
    op4 = PointPointRangeQuery(conf, grid, device="cpu")
    restore_operator(op4, load_jax_checkpoint(jpath)["op"])
    assert op4.partition_plan.to_dict() == jop.partition_plan.to_dict()


def _dag_component_round_trips(tmp_path):
    """The ``dag`` component: every node's backend, counters and substate
    snapshot through ``operator_state`` and restore into a fresh DAG
    through ``restore_operator``, before its assembler state is
    consumed."""
    from spatialflink_tpu_torch import dag as dag_mod
    from spatialflink_tpu_torch import qserve as tqserve

    assert "dag" not in ck.WAITING_COMPONENTS
    try:
        dag = dag_mod.build_sncb_dag(str(tmp_path / "a"), device="cpu")
        for _ in dag.run(dag_mod._toy_sncb_stream(90)()):
            pass
        state = operator_state(dag)
        assert set(state["dag"]["nodes"]) == set(dag.dag_nodes)
        path = str(tmp_path / "dag.ckpt")
        save_checkpoint(path, op=state)
        fresh = dag_mod.build_sncb_dag(str(tmp_path / "b"), device="cpu")
        restore_operator(fresh, load_checkpoint(path)["op"])
        assert fresh.dag_state() == dag.dag_state()
        assert fresh._restored_assembler is not None
    finally:
        dag_mod.uninstall()
        tqserve.uninstall()


def test_kafka_offsets_wait_for_a11_4(tmp_path):
    """The Kafka offsets (ROADMAP A11.4a, ported) round-trip through the
    framed checkpoint: the port's snapshot equals the JAX package's for
    the same source, each package restores the other's file, and a
    checkpoint of another topic is refused."""
    from types import SimpleNamespace

    src = SimpleNamespace(topic="gps", offsets={0: 13, 1: np.int64(7)})
    state = ck.kafka_source_state(src)
    assert state == jck.kafka_source_state(src) == \
        {"topic": "gps", "offsets": {0: 13, 1: 7}}
    path = str(tmp_path / "offsets.ckpt")
    ck.save_checkpoint(path, source=state)
    for load, restore in (
            (ck.load_checkpoint, ck.restore_kafka_source_offsets),
            (jck.load_checkpoint, jck.restore_kafka_source_offsets)):
        snap = load(path)["source"]
        assert restore(snap, "gps") == {0: 13, 1: 7}
    jck.save_checkpoint(path, source=jck.kafka_source_state(src))
    assert ck.restore_kafka_source_offsets(
        ck.load_checkpoint(path)["source"], "gps") == {0: 13, 1: 7}
    with pytest.raises(ValueError, match="topic"):
        ck.restore_kafka_source_offsets(state, "other")


# -- a JAX checkpoint resumed by the port ---------------------------------------


def _lattice(n=120, cls=Point):
    """The toy stream's shape on a 1/64 lattice: every centred coordinate
    has at most 9 significant bits, so x² + y² is exact in float32 and an
    FMA cannot round it differently."""
    rng = np.random.default_rng(7)
    xs = rng.integers(0, 512, n) / 64.0
    ys = rng.integers(0, 512, n) / 64.0
    return [cls(obj_id=f"o{i % 13}", timestamp=100 * i, x=float(xs[i]),
                y=float(ys[i])) for i in range(n)]


def _jax_leg(workdir, stream, numpy_route, kill_at=None):
    grid, conf, _, query = jdriver._toy_pipeline()
    sink = JSink(os.path.join(workdir, "egress.csv"))
    drv = jdriver.WindowedDataflowDriver(
        checkpoint_path=os.path.join(workdir, "ckpt.bin"),
        checkpoint_every=2, sink=sink,
        retry=jdriver.RetryPolicy(max_retries=0, backoff_s=0.0),
        failover=numpy_route)
    plan = []
    if numpy_route:
        plan.append({"point": "driver.window", "at": 1, "times": 10**9})
    if kill_at is not None:
        plan.append({"point": "sink.write", "at": kill_at, "times": 10**9})
    if plan:
        jfaults.arm(plan)
    try:
        for res in JRangeQ(conf, grid).run(iter(stream), [query], 1.5,
                                           dtype=np.float32, driver=drv):
            for line in jdriver.render_range_result(res):
                sink.stage(line)
    finally:
        jfaults.disarm()
    return drv


def _port_resume(workdir, stream, failover):
    path = os.path.join(workdir, "ckpt.bin")
    save_checkpoint(path, **load_jax_checkpoint(path))  # now the port's
    grid = UniformGrid(8, 0.0, 8.0, 0.0, 8.0)
    conf = QueryConfiguration(QueryType.WindowBased, window_size=2.0,
                              slide_step=1.0)
    sink = TransactionalFileSink(os.path.join(workdir, "egress.csv"))
    drv = WindowedDataflowDriver(
        checkpoint_path=path, checkpoint_every=2, sink=sink,
        retry=RetryPolicy(max_retries=0, backoff_s=0.0), failover=failover)
    op = PointPointRangeQuery(conf, grid, device="cpu")
    for res in op.run(iter(stream), [Point(obj_id="q", x=4.0, y=4.0)], 1.5,
                      driver=drv):
        for line in render_range_result(res):
            sink.stage(line)
    return drv


@pytest.mark.parametrize("numpy_route", [False, True],
                         ids=["jax_device_lattice", "jax_numpy_toy"])
def test_jax_run_killed_and_resumed_by_the_port(tmp_path, numpy_route):
    if numpy_route:
        jstream = list(jdriver._toy_pipeline()[2]())
    else:
        jstream = _lattice(cls=JPoint)
    stream = [Point(obj_id=p.obj_id, timestamp=p.timestamp, x=p.x, y=p.y)
              for p in jstream]
    clean, chaos = tmp_path / "clean", tmp_path / "chaos"
    clean.mkdir()
    chaos.mkdir()
    _jax_leg(str(clean), jstream, numpy_route)
    want = (clean / "egress.csv").read_bytes()
    assert want.count(b"\n") > 20
    with pytest.raises(JInjected):
        _jax_leg(str(chaos), jstream, numpy_route, kill_at=4)
    assert 0 < len((chaos / "egress.csv").read_bytes()) < len(want)
    comps = load_jax_checkpoint(str(chaos / "ckpt.bin"))
    buffered = [p for _, evs in comps["op"]["assembler"]["buffers"]
                for p in evs]
    assert buffered and all(type(p) is Point for p in buffered)
    drv = _port_resume(str(chaos), stream, failover=numpy_route)
    assert drv.stats["resumed"] is True
    assert drv.backend == ("fallback" if numpy_route else "device")
    assert (chaos / "egress.csv").read_bytes() == want


def test_jax_query_panes_checkpoint_continues_in_the_port(tmp_path):
    jconf = JConf(JQT.WindowBased, window_size=10, slide_step=5)
    jgrid = JGrid(20, 0.0, 10.0, 0.0, 10.0)
    jpts = _pts(np.random.default_rng(21), 900, cls=JPoint)
    q = JPoint(x=5.0, y=5.0)
    whole = list(JKnn(jconf, jgrid).query_panes(iter(jpts), q, 3.0, 6,
                                                dtype=np.float32))
    jop = JKnn(jconf, jgrid)
    part1 = list(jop.query_panes(iter(jpts[:500]), q, 3.0, 6,
                                 dtype=np.float32, flush_at_end=False))
    path = str(tmp_path / "jknn.ckpt")
    jck.save_checkpoint(path, op=jck.operator_state(jop))
    op = _fresh_knn()
    restore_operator(op, load_jax_checkpoint(path)["op"])
    rest = [Point(obj_id=p.obj_id, timestamp=p.timestamp, x=p.x, y=p.y)
            for p in jpts[500:]]
    part2 = list(op.query_panes(iter(rest), Point(x=5.0, y=5.0), 3.0, 6))
    assert part1 and part2 and len(part1) + len(part2) == len(whole)
    for a, b in zip(whole[len(part1):], part2):
        assert (a.start, a.end) == (b.start, b.end)
        assert [(o, ev.obj_id, ev.timestamp) for o, _, ev in a.neighbors] \
            == [(o, ev.obj_id, ev.timestamp) for o, _, ev in b.neighbors]
        np.testing.assert_allclose([d for _, d, _ in a.neighbors],
                                   [d for _, d, _ in b.neighbors],
                                   rtol=3e-7)


@pytest.mark.parametrize("payload", [
    "grid", "sink", "os_system", "ordered_dict"])
def test_load_jax_checkpoint_refuses_foreign_classes(tmp_path, payload):
    import collections

    path = str(tmp_path / "f.bin")
    if payload == "grid":
        jck.save_checkpoint(path, op={"grid": JGrid(4, 0, 1, 0, 1)})
    elif payload == "sink":
        jck.save_checkpoint(path, op={"sink": JSink(str(tmp_path / "e"))})
    elif payload == "os_system":
        class Evil:
            def __reduce__(self):
                return (os.system, ("true",))

        save_checkpoint(path, op=Evil())
    else:
        save_checkpoint(path, op=collections.OrderedDict(a=1))
    with pytest.raises(CheckpointCorruptError, match="expected"):
        load_jax_checkpoint(path)


def test_load_jax_checkpoint_maps_the_allow_list(tmp_path):
    from spatialflink_tpu.models import objects as jobj
    from spatialflink_tpu.streams.windows import WindowSpec as JSpec

    from spatialflink_tpu_torch.models import objects as tobj
    from spatialflink_tpu_torch.streams.windows import WindowSpec

    ring = np.array([[0, 0], [1, 0], [1, 1], [0, 0]], np.float64)
    things = [jobj.Point(obj_id="p", timestamp=5, x=1.5, y=2.5),
              jobj.Polygon(obj_id="g", rings=[ring]),
              jobj.LineString(obj_id="l", coords=ring[:3]),
              JSpec(0, 10)]
    path = str(tmp_path / "m.bin")
    jck.save_checkpoint(path, things=things)
    got = load_jax_checkpoint(path)["things"]
    assert [type(x) for x in got] == [tobj.Point, tobj.Polygon,
                                      tobj.LineString, WindowSpec]
    assert (got[0].obj_id, got[0].timestamp, got[0].x, got[0].y) == \
        ("p", 5, 1.5, 2.5)
    np.testing.assert_array_equal(got[1].rings[0], ring)
    assert got[3] == WindowSpec(0, 10)


def test_wire_pane_assembler_snapshot_resumes_equal_jax(rng):
    """``wire_pane_assembler_state`` / ``restore_wire_pane_assembler``:
    the open pane's events and position, cut mid-stream and restored,
    give the uninterrupted assembler's panes, which equal the JAX
    assembler's."""
    from spatialflink_tpu.streams.wire import (
        WireFormat as JWireFormat,
        WirePaneAssembler as JAsm,
    )

    from spatialflink_tpu_torch.streams.wire import (
        WireFormat,
        WirePaneAssembler,
    )

    n = 3_000
    ts = np.sort(rng.integers(0, 9_000, n)).astype(np.int64)
    chunks = [{"ts": ts[a:a + 500], "x": rng.uniform(0, 10, 500),
               "y": rng.uniform(0, 10, 500),
               "oid": rng.integers(0, 64, 500)} for a in range(0, n, 500)]
    wf = WireFormat.for_grid(GRID)
    jwf = JWireFormat.for_grid(JGrid(20, 0.0, 10.0, 0.0, 10.0))

    def panes(asm, part):
        return [p.tobytes() for ch in part for p in asm.feed(ch)]

    whole = WirePaneAssembler(wf, 1000, 0)
    want = panes(whole, chunks) + [p.tobytes() for p in whole.flush()]
    jwhole = JAsm(jwf, 1000, 0)
    assert want == panes(jwhole, chunks) + [p.tobytes()
                                            for p in jwhole.flush()]
    first = WirePaneAssembler(wf, 1000, 0)
    head = panes(first, chunks[:3])
    snap = ck.wire_pane_assembler_state(first)
    second = WirePaneAssembler(wf, 1000, 0)
    ck.restore_wire_pane_assembler(second, snap)
    tail = panes(second, chunks[3:]) + [p.tobytes() for p in second.flush()]
    assert head + tail == want and head and tail
