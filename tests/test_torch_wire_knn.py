"""Parity of the PyTorch port's wire-kNN path with the JAX package.

The same inputs, made with numpy from a seed, go through the JAX
function and its port counterpart. The JAX side runs its Pallas digest
in interpret mode, as its own tests do on the CPU; the port runs on the
CPU, where each kernel wrapper takes its plain PyTorch version. Float32
is pinned on both sides (the session turns x64 on).

Contracts held:
- pane digest: the reference's ``digests_agree`` (same in-radius object
  set, distances within 1 ulp, equal representatives where the
  distances are equal); exact on equal-distance ties and on points that
  lie exactly on the radius;
- window results of ``run_wire_panes`` (sync, pipelined, pipelined with
  the delta codec): starts, ends, ``nv`` and object ids exact,
  distances within 1 ulp; the same after a resume from the JAX carry.
"""

import ast
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spatialflink_tpu import pipeline as jpipeline
from spatialflink_tpu.grid import UniformGrid as JGrid
from spatialflink_tpu.models.objects import Point as JPoint
from spatialflink_tpu.operators import QueryConfiguration as JConf
from spatialflink_tpu.operators.knn_query import PointPointKNNQuery as JKnn
from spatialflink_tpu.ops import knn as jknn
from spatialflink_tpu.ops import wire_codec as jwc
from spatialflink_tpu.ops.wire_knn import digests_agree as j_digests_agree
from spatialflink_tpu.ops.wire_knn import wire_digest_pallas_step
from spatialflink_tpu.ops.pallas_digest import wire_digest_pallas
from spatialflink_tpu.streams.wire import WireFormat as JWireFormat
from spatialflink_tpu.streams.wire import wire_panes as j_wire_panes

from spatialflink_tpu_torch import pipeline as tpipeline
from spatialflink_tpu_torch.grid import UniformGrid
from spatialflink_tpu_torch.models.objects import Point
from spatialflink_tpu_torch.operators import QueryConfiguration
from spatialflink_tpu_torch.operators.base import ship
from spatialflink_tpu_torch.operators.knn_query import PointPointKNNQuery
from spatialflink_tpu_torch.ops import knn as tknn
from spatialflink_tpu_torch.ops.wire_digest_kernel import wire_digest
from spatialflink_tpu_torch.ops.wire_knn import (
    digests_agree,
    select_wire_digest_step,
    wire_plane_coords,
)
from spatialflink_tpu_torch.state import carry_from_jax
from spatialflink_tpu_torch.streams.wire import WireFormat, wire_panes

REPO = Path(__file__).resolve().parents[1]
BEIJING = dict(num_partitions=100, min_x=115.5, max_x=117.6, min_y=39.6,
               max_y=41.1)
Q = np.asarray([116.40, 40.19], np.float32)
NSEG, K, RADIUS = 512, 50, 0.5  # the headline's smoke sizes
WF = WireFormat.for_grid(UniformGrid(**BEIJING))
JWF = JWireFormat.for_grid(JGrid(**BEIJING))


def _pane(rng, n, nseg=NSEG):
    xy = np.stack([rng.uniform(115.5, 117.6, n), rng.uniform(39.6, 41.1, n)],
                  axis=1)
    oid = rng.integers(0, nseg, n).astype(np.int16)
    return np.ascontiguousarray(np.concatenate(
        [WF.quantize(xy), oid.view(np.uint16)[:, None]], axis=1).T)


def _padded(wire, bucket):
    return np.concatenate(
        [wire, np.zeros((3, bucket - wire.shape[1]), np.uint16)], axis=1)


def _port_digest(wire, n_valid, q=Q, radius=RADIUS, nseg=NSEG):
    return wire_digest(torch.from_numpy(wire.copy()), n_valid, q, WF.scale,
                       WF.origin, np.float32(radius), nseg)


def _jax_digest(wire, n_valid, q=Q, radius=RADIUS, nseg=NSEG):
    return jax.jit(
        lambda *a: wire_digest_pallas_step(*a, num_segments=nseg,
                                           interpret=True)
    )(jnp.asarray(wire), jnp.int32(n_valid), jnp.asarray(q),
      jnp.asarray(JWF.scale), jnp.asarray(JWF.origin),
      jnp.float32(radius))


def _jax_count(wire, n_valid, q=Q, radius=RADIUS, nseg=NSEG):
    _, cnt = wire_digest_pallas(
        jnp.asarray(wire), jnp.asarray(q), JWF.scale, JWF.origin,
        np.float32(radius), num_segments=nseg, interpret=True,
        n_valid=jnp.int32(n_valid),
    )
    return int(cnt)


# ---------------------------------------------------------------------------
# Wire format


def test_wire_format_matches_jax_bit_exact():
    rng = np.random.default_rng(3)
    assert np.array_equal(WF.scale, JWF.scale)
    assert np.array_equal(WF.origin, JWF.origin)
    xy = np.stack([rng.uniform(115.0, 118.0, 5000),
                   rng.uniform(39.0, 42.0, 5000)], axis=1)
    q = WF.quantize(xy)
    assert np.array_equal(q, JWF.quantize(xy))
    got = WF.dequantize(torch.from_numpy(q.copy())).numpy()
    want = np.asarray(JWF.dequantize(jnp.asarray(q)))
    assert got.dtype == want.dtype == np.float32
    assert np.array_equal(got.view(np.uint32), want.view(np.uint32))
    assert np.array_equal(got.view(np.uint32),
                          JWF.dequantize_np(q).view(np.uint32))


def test_wire_plane_coords_matches_dequant():
    wire = _pane(np.random.default_rng(4), 1000)
    xf, yf, oid = wire_plane_coords(torch.from_numpy(wire), WF.scale,
                                    WF.origin)
    ref = JWF.dequantize_np(wire[:2].T)
    assert np.array_equal(xf.numpy().view(np.uint32),
                          ref[:, 0].view(np.uint32))
    assert np.array_equal(yf.numpy().view(np.uint32),
                          ref[:, 1].view(np.uint32))
    assert np.array_equal(oid.numpy(), wire[2].astype(np.int32))


def test_wire_panes_match_jax():
    rng = np.random.default_rng(5)
    n = 3000
    ts = np.sort(rng.integers(0, 20_000, n)).astype(np.int64)
    ts[ts > 8_000] += 5_000  # an event-time gap: empty panes
    ch = {"ts": ts, "x": rng.uniform(115.5, 117.6, n),
          "y": rng.uniform(39.6, 41.1, n),
          "oid": rng.integers(0, NSEG, n)}
    got = list(wire_panes([ch], WF, 1000, 0))
    want = list(j_wire_panes([ch], JWF, 1000, 0))
    assert len(got) == len(want) and any(p.shape[1] == 0 for p in got)
    for a, b in zip(got, want):
        assert np.array_equal(a, b)


# ---------------------------------------------------------------------------
# Pane digest (kernel B1's plain version) vs the JAX Pallas step


@pytest.mark.parametrize("case", [
    "full", "n_valid_lt_bucket", "zero_hits", "all_hits",
    "width_not_multiple_of_8",
])
def test_digest_matches_jax_pallas_step(case):
    """``width_not_multiple_of_8``: a 2051-lane pane (the kernel's 2-byte
    path on the card; the JAX step pads to its block internally)."""
    rng = np.random.default_rng(11)
    n, bucket, q, radius = 2048, 2048, Q, RADIUS
    if case == "n_valid_lt_bucket":
        n = 1500
    if case == "width_not_multiple_of_8":
        n, bucket = 2049, 2051
    if case == "zero_hits":
        q = np.asarray([0.0, 0.0], np.float32)
    if case == "all_hits":
        radius = 10.0
    wire = _padded(_pane(rng, n), bucket)
    d_t, cnt = _port_digest(wire, n, q, radius)
    d_j = _jax_digest(wire, n, q, radius)
    assert j_digests_agree(d_t.seg_min.numpy(), d_t.rep.numpy(),
                           np.asarray(d_j.seg_min), np.asarray(d_j.rep))
    assert int(cnt) == _jax_count(wire, n, q, radius)
    live = int((d_t.seg_min < tknn.F32_BIG).sum())
    if case == "zero_hits":
        assert live == 0 and int(cnt) == 0
    else:
        assert live > 50, "degenerate: too few objects in radius"


def test_digest_plain_is_correctly_rounded():
    """The plain version must round each operation once, as the CUDA
    kernel does, so the CPU run and the card run agree bit for bit:
    against a numpy float32 reference, exact (numpy's float32 sqrt is
    correctly rounded; torch's CPU float32 sqrt is not everywhere)."""
    rng = np.random.default_rng(16)
    wire = rng.integers(0, 65536, (3, 200_000)).astype(np.uint16)
    wire[2] %= NSEG
    d, cnt = _port_digest(wire, wire.shape[1], radius=0.3)
    xf = wire[0].astype(np.float32) * WF.scale[0] + WF.origin[0]
    yf = wire[1].astype(np.float32) * WF.scale[1] + WF.origin[1]
    dx, dy = xf - Q[0], yf - Q[1]
    dist = np.sqrt(dx * dx + dy * dy)
    hit = dist <= np.float32(0.3)
    ref = np.full(NSEG, np.finfo(np.float32).max, np.float32)
    np.minimum.at(ref, wire[2][hit].astype(np.int64), dist[hit])
    assert int(cnt) == int(hit.sum()) > 1000
    assert np.array_equal(d.seg_min.numpy().view(np.uint32),
                          ref.view(np.uint32))


def test_digest_padding_never_matches():
    """Bucket padding (u16 zeros → the grid origin) lies in radius of a
    query at the origin; ``n_valid`` must mask it."""
    wire = _pane(np.random.default_rng(12), 300)
    padded = _padded(wire, 512)
    q0 = np.asarray([115.6, 39.7], np.float32)
    a, _ = _port_digest(padded, 300, q0, 0.5)
    b, _ = _port_digest(wire, 300, q0, 0.5)
    assert torch.equal(a.seg_min, b.seg_min) and torch.equal(a.rep, b.rep)
    leak, _ = _port_digest(padded, 512, q0, 0.5)
    assert not torch.equal(leak.seg_min, b.seg_min)


def test_digest_equal_distance_ties_exact():
    """Many points and objects at one distance: every tie is broken by
    the lowest index, exactly as in the reference."""
    rng = np.random.default_rng(13)
    n = 2048
    # 16 lattice positions, each repeated many times across 64 objects.
    qpts = WF.quantize(np.asarray([[116.40 + 0.01 * i, 40.19]
                                   for i in range(16)]))
    pick = rng.integers(0, 16, n)
    oid = rng.integers(0, 64, n).astype(np.int16)
    wire = np.ascontiguousarray(np.concatenate(
        [qpts[pick], oid.view(np.uint16)[:, None]], axis=1).T)
    d_t, _ = _port_digest(wire, n)
    d_j = _jax_digest(wire, n)
    assert np.array_equal(d_t.seg_min.numpy(), np.asarray(d_j.seg_min))
    assert np.array_equal(d_t.rep.numpy(), np.asarray(d_j.rep))
    # and the window top-k keeps the lowest object id among equal minima
    r_t = tknn._finish_topk(d_t.seg_min, d_t.rep, K)
    r_j = jknn._finish_topk(d_j.seg_min, d_j.rep, K)
    for a, b in zip(r_t, r_j):
        assert np.array_equal(a.numpy(), np.asarray(b))


def test_digest_points_exactly_on_radius():
    """A radius equal to some points' f32 distance keeps them in: sqrt
    first, then ``<=``, the same in-radius set as the reference."""
    wire = _pane(np.random.default_rng(14), 2048)
    xf, yf, _ = wire_plane_coords(torch.from_numpy(wire), WF.scale,
                                  WF.origin)
    dx, dy = xf - float(Q[0]), yf - float(Q[1])
    dist = torch.sqrt(dx * dx + dy * dy)
    radius = np.float32(torch.sort(dist).values[700].item())
    d_t, cnt = _port_digest(wire, 2048, radius=radius)
    d_j = _jax_digest(wire, 2048, radius=radius)
    assert int(cnt) == int((dist <= torch.tensor(radius)).sum()) > 700
    assert np.array_equal(d_t.seg_min.numpy() < tknn.F32_BIG,
                          np.asarray(d_j.seg_min) < tknn.F32_BIG)
    assert j_digests_agree(d_t.seg_min.numpy(), d_t.rep.numpy(),
                           np.asarray(d_j.seg_min), np.asarray(d_j.rep))


def test_select_step_on_cpu_is_plain_and_rejects_cuda_strategy():
    wire = torch.from_numpy(_pane(np.random.default_rng(15), 256))
    kind, step = select_wire_digest_step(
        wire, 256, Q, WF.scale, WF.origin, np.float32(RADIUS),
        num_segments=NSEG)
    assert kind == "torch"
    d = step(wire, 256)
    d2, _ = _port_digest(wire.numpy(), 256)
    assert digests_agree(d.seg_min, d.rep, d2.seg_min, d2.rep)
    with pytest.raises(ValueError):
        select_wire_digest_step(wire, 256, Q, WF.scale, WF.origin,
                                np.float32(RADIUS), num_segments=NSEG,
                                strategy="cuda")


# ---------------------------------------------------------------------------
# Merge and top-k


def test_finish_topk_tie_order_lowest_segment_first():
    rng = np.random.default_rng(21)
    seg_min = np.full(NSEG, np.finfo(np.float32).max, np.float32)
    live = rng.choice(NSEG, 200, replace=False)
    seg_min[live] = rng.choice(np.float32([0.1, 0.2, 0.3]), 200)
    rep = rng.integers(0, 10_000, NSEG).astype(np.int32)
    got = tknn._finish_topk(torch.from_numpy(seg_min),
                            torch.from_numpy(rep), K)
    want = jknn._finish_topk(jnp.asarray(seg_min), jnp.asarray(rep), K)
    for a, b in zip(got, want):
        assert np.array_equal(a.numpy(), np.asarray(b))


def test_merge_digests_matches_jax():
    rng = np.random.default_rng(22)
    big = np.finfo(np.float32).max
    sm = rng.choice(np.float32([0.1, 0.2, 0.25, big]), (3, NSEG))
    rp = np.where(sm < big, rng.integers(0, 9999, (3, NSEG)),
                  np.iinfo(np.int32).max).astype(np.int32)
    got = tknn.knn_merge_digest_list(list(torch.from_numpy(sm)),
                                     list(torch.from_numpy(rp)), None, K)
    want = jknn.knn_merge_digests(jnp.asarray(sm), jnp.asarray(rp), K)
    for a, b in zip(got, want):
        assert np.array_equal(a.numpy(), np.asarray(b))


# ---------------------------------------------------------------------------
# run_wire_panes end to end


CONF = dict(window_size=2.0, slide_step=1.0)  # two panes per window


def _stream_panes(seed=42, n=9000):
    """Variable-size panes with an event-time gap (empty panes, gap
    windows, bucket padding), made like the headline stream."""
    rng = np.random.default_rng(seed)
    ts = np.sort(rng.integers(0, 6_000, n)).astype(np.int64)
    ts[ts > 3_500] += 3_000
    ts = np.sort(ts)
    ch = {"ts": ts, "x": rng.uniform(115.5, 117.6, n),
          "y": rng.uniform(39.6, 41.1, n), "oid": rng.integers(0, NSEG, n)}
    return list(wire_panes([ch], WF, 1000, 0))


def _jax_run(panes, policy=None, op=None, flush=True):
    jpipeline.uninstall()
    if policy is not None:
        jpipeline.install(jpipeline.PipelinePolicy(
            **policy, codec_strategy="pallas") if policy.get("codec")
            else jpipeline.PipelinePolicy(**policy))
    op = op or JKnn(JConf(**CONF), JGrid(**BEIJING))
    try:
        return [(s, e, np.asarray(o), np.asarray(d), nv)
                for s, e, o, d, nv in op.run_wire_panes(
                    panes, JPoint(x=float(Q[0]), y=float(Q[1])), RADIUS, K,
                    NSEG, JWF, strategy="pallas", interpret=True,
                    flush_at_end=flush)]
    finally:
        jpipeline.uninstall()


def _port_run(panes, policy=None, op=None, flush=True):
    tpipeline.uninstall()
    if policy is not None:
        tpipeline.install(tpipeline.PipelinePolicy(**policy))
    op = op or PointPointKNNQuery(QueryConfiguration(**CONF),
                                  UniformGrid(**BEIJING), device="cpu")
    try:
        return list(op.run_wire_panes(
            panes, Point(x=float(Q[0]), y=float(Q[1])), RADIUS, K, NSEG, WF,
            flush_at_end=flush))
    finally:
        tpipeline.uninstall()


def _assert_windows_agree(got, want):
    assert [(s, e, nv) for s, e, _, _, nv in got] == \
        [(s, e, nv) for s, e, _, _, nv in want]
    for (_, _, o_t, d_t, _), (_, _, o_j, d_j, _) in zip(got, want):
        assert np.array_equal(o_t, o_j)
        assert d_t.dtype == d_j.dtype == np.float32
        ulp = np.spacing(np.maximum(np.abs(d_t), np.abs(d_j)))
        assert np.all(np.abs(d_t - d_j) <= ulp)


MODES = {"sync": None, "pipelined": {"depth": 3, "fetch_lag": 2},
         "pipelined_delta": {"depth": 2, "fetch_lag": 3, "codec": "delta"}}


@pytest.fixture(scope="module")
def jax_baseline():
    panes = _stream_panes()
    return panes, _jax_run(panes)


@pytest.mark.parametrize("mode", list(MODES))
def test_run_wire_panes_matches_jax(jax_baseline, mode):
    panes, want = jax_baseline
    op = PointPointKNNQuery(QueryConfiguration(**CONF),
                            UniformGrid(**BEIJING), device="cpu")
    got = _port_run(panes, MODES[mode], op=op)
    assert len(want) >= 6 and any(nv == K for *_, nv in want)
    _assert_windows_agree(got, want)
    # the JAX pipelined runs are bit-identical to its sync run
    if mode != "sync":
        _assert_windows_agree(_jax_run(panes, MODES[mode]), want)
    assert op.last_wire_digest_kind == "torch"
    assert op.last_wire_codec_kind == (
        "torch" if mode == "pipelined_delta" else None)


@pytest.mark.parametrize("mode", ["sync", "pipelined_delta"])
def test_resume_from_jax_carry(jax_baseline, mode):
    """A port operator restored from the JAX operator's carry continues
    mid-window and yields what the JAX run yields after the cut."""
    panes, want = jax_baseline
    cut = 4
    jop = JKnn(JConf(**CONF), JGrid(**BEIJING))
    head = _jax_run(panes[:cut], op=jop, flush=False)
    codec_state = None
    if mode == "pipelined_delta":
        enc = jwc.WirePaneEncoder(NSEG)
        for p in panes[:cut]:
            enc.encode(p)
        codec_state = enc.state()
    carry = carry_from_jax(jop._wire_pane_carry, "cpu", codec_state)
    op = PointPointKNNQuery(QueryConfiguration(**CONF),
                            UniformGrid(**BEIJING), device="cpu")
    op.restore_wire_pane_carry(carry)
    tail = _port_run(panes[cut:], MODES[mode], op=op)
    assert head and tail
    _assert_windows_agree(tail, want[len(head):])
    assert len(head) + len(tail) == len(want)


def test_shipped_tables_do_not_alias_host_memory():
    """``torch.from_numpy`` shares memory; the ship copies first, so the
    encoder's in-place table updates never reach a shipped table
    (num_segments >= 512, above any small-buffer copy threshold)."""
    table = np.arange(NSEG, dtype=np.uint16)
    (t,) = ship(table, device=torch.device("cpu")).arrive()
    table[:] = 7
    assert np.array_equal(t.numpy(), np.arange(NSEG, dtype=np.uint16))
    carry = {"next_pane": 1, "digests": [(np.zeros(NSEG, np.float32),
                                          np.zeros(NSEG, np.int32))],
             "counts": [1]}
    state = {"num_segments": NSEG, "pred_x": table, "pred_y": table}
    got = carry_from_jax(carry, "cpu", state)
    carry["digests"][0][0][:] = 1.0
    table[:] = 9
    assert float(got["digests"][0][0].sum()) == 0.0
    assert int(got["codec"]["pred_x"].max()) == 7


def test_device_cuda_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the missing-card error cannot occur")
    with pytest.raises(RuntimeError):
        PointPointKNNQuery(QueryConfiguration(**CONF),
                           UniformGrid(**BEIJING))


# ---------------------------------------------------------------------------
# The port stands alone


PORT_FILES = sorted((REPO / "spatialflink_tpu_torch").rglob("*.py")) + [
    REPO / "chip_smoke.py"]


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(REPO)))
def test_port_source_imports_no_jax(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for name in names:
            root = name.split(".")[0]
            assert root not in ("jax", "jaxlib", "spatialflink_tpu"), \
                f"{path.name} imports {name}"


def test_port_imports_with_jax_blocked():
    mods = [
        ".".join(p.relative_to(REPO).with_suffix("").parts)
        for p in PORT_FILES if p.name != "chip_smoke.py"
    ]
    code = (
        "import sys, importlib, importlib.util\n"
        "for m in ('jax', 'jaxlib', 'spatialflink_tpu'):\n"
        "    sys.modules[m] = None\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m.replace('.__init__', ''))\n"
        "spec = importlib.util.spec_from_file_location('chip_smoke_mod',\n"
        "                                              'chip_smoke.py')\n"
        "spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in\n"
        "       ('jax', 'jaxlib', 'spatialflink_tpu')\n"
        "       and sys.modules[m] is not None]\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
