"""Parity of the PyTorch port's delta-bitpacked wire codec with the JAX
package: the host encoder and the device decode (kernel B2's plain
version on the CPU) against the JAX encoder and its decode through the
Pallas extraction in interpret mode, all BIT-exact. The pipeline policy
parse is held to the JAX one. The kernels themselves are checked on the
card by ``tests/test_torch_kernels_cuda.py``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spatialflink_tpu import pipeline as jpipeline
from spatialflink_tpu.ops import wire_codec as jwc

from spatialflink_tpu_torch import pipeline as tpipeline
from spatialflink_tpu_torch.ops import wire_codec as twc

NSEG = 512


def _walk_panes(rng, nseg=NSEG, n_panes=6, max_n=3000, step=5,
                teleport_at=2):
    """Slow-moving objects (the codec's regime) with one teleport and
    panes of varying size, some empty."""
    pos = rng.integers(0, 65536, (nseg, 2)).astype(np.int64)
    panes = []
    for i in range(n_panes):
        n = 0 if i == 3 else int(rng.integers(1, max_n))
        oids = rng.integers(0, nseg, n)
        pos[oids] = (pos[oids] + rng.integers(-step, step + 1,
                                              (n, 2))) % 65536
        if i == teleport_at and n:
            pos[oids[0]] = rng.integers(0, 65536, 2)
        panes.append(np.stack([pos[oids, 0], pos[oids, 1],
                               oids]).astype(np.uint16))
    return panes


def _jax_decode(words, n_valid, bx, by, bo, px, py, nb, nseg):
    step = jax.jit(jwc.functools_partial_decode(
        jwc.make_pallas_extract(interpret=True), n=nb, num_segments=nseg))
    out = step(jnp.asarray(words), jnp.int32(n_valid), jnp.int32(bx),
               jnp.int32(by), jnp.int32(bo), jnp.asarray(px),
               jnp.asarray(py))
    return [np.asarray(a) for a in out]


def _port_decode(words, n_valid, bx, by, bo, px, py, nb, nseg):
    out = twc.decode_wire_pane(
        torch.from_numpy(np.asarray(words, np.uint32).view(np.int32).copy()),
        n_valid, bx, by, bo, torch.from_numpy(px.copy()),
        torch.from_numpy(py.copy()), n=nb, num_segments=nseg)
    return [a.numpy() for a in out]


def test_encoder_matches_jax_bit_exact():
    rng = np.random.default_rng(1)
    t_enc, j_enc = twc.WirePaneEncoder(NSEG), jwc.WirePaneEncoder(NSEG)
    for pane in _walk_panes(rng):
        a, b = t_enc.encode(pane), j_enc.encode(pane)
        assert (a.n, a.bx, a.by, a.bo, a.raw_bytes, a.coded_bytes) == \
            (b.n, b.bx, b.by, b.bo, b.raw_bytes, b.coded_bytes)
        assert np.array_equal(a.words, b.words)
        assert np.array_equal(t_enc.pred_x, j_enc.pred_x)
        assert np.array_equal(t_enc.pred_y, j_enc.pred_y)
    st = t_enc.state()
    t_enc.pred_x[:] = 0
    assert st["pred_x"].any(), "state() must be a copy"


def test_decode_stream_matches_jax_bit_exact():
    """A chain of panes through the device tables: every decoded pane and
    both tables equal the JAX decode's, and the raw pane."""
    rng = np.random.default_rng(2)
    enc = twc.WirePaneEncoder(NSEG)
    px_t = px_j = np.zeros(NSEG, np.uint16)
    py_t = py_j = np.zeros(NSEG, np.uint16)
    for pane in _walk_panes(rng):
        e = enc.encode(pane)
        nb = max(128, 1 << max(0, (e.n - 1).bit_length()))
        words = twc.pad_words(e.words, twc.wire_word_bucket(len(e.words),
                                                            nb))
        args = (words, e.n, e.bx, e.by, e.bo)
        pane_t, px_t, py_t = _port_decode(*args, px_t, py_t, nb, NSEG)
        pane_j, px_j, py_j = _jax_decode(*args, px_j, py_j, nb, NSEG)
        assert np.array_equal(pane_t, pane_j)
        assert np.array_equal(px_t, px_j) and np.array_equal(py_t, py_j)
        assert np.array_equal(pane_t[:, :e.n], pane)
        assert not pane_t[:, e.n:].any()
    assert np.array_equal(px_t, enc.pred_x)
    assert np.array_equal(py_t, enc.pred_y)


@pytest.mark.parametrize("b", range(17))
def test_decode_every_width_random_payload(b):
    """Arbitrary payload bits (not an encoder's) at every width 0..16,
    n_valid below the bucket: field extraction across word boundaries,
    the clamp at the payload's end and the u16 wrap, bit for bit."""
    rng = np.random.default_rng(100 + b)
    nb, n_valid, nseg = 1024, 1000, 64
    bo = min(b, 6)  # oids below num_segments; the 7-bit case clamps
    words = rng.integers(0, 1 << 32, 3 * ((n_valid * 16 + 31) // 32),
                         dtype=np.uint64).astype(np.uint32)
    px = rng.integers(0, 65536, nseg).astype(np.uint16)
    py = rng.integers(0, 65536, nseg).astype(np.uint16)
    for widths in ((b, b, bo), (b, (b + 5) % 17, 7)):
        got = _port_decode(words, n_valid, *widths, px, py, nb, nseg)
        want = _jax_decode(words, n_valid, *widths, px, py, nb, nseg)
        for g, w in zip(got, want):
            assert np.array_equal(g, w), widths


@pytest.mark.parametrize("widths", [(16, 16, 14), (5, 9, 3)],
                         ids=lambda w: "/".join(map(str, w)))
@pytest.mark.parametrize("n_words", [1, 7])
def test_decode_payload_shorter_than_streams(n_words, widths):
    """A payload of 1 or 7 words under streams that need hundreds: every
    word index past the payload clamps to its last word, in the port as
    in the Pallas extraction (a loader that read zeros there would
    differ)."""
    rng = np.random.default_rng(200 + n_words)
    nb, n_valid = 1024, 1000
    words = rng.integers(1, 1 << 32, n_words,
                         dtype=np.uint64).astype(np.uint32)
    px = rng.integers(0, 65536, NSEG).astype(np.uint16)
    py = rng.integers(0, 65536, NSEG).astype(np.uint16)
    got = _port_decode(words, n_valid, *widths, px, py, nb, NSEG)
    want = _jax_decode(words, n_valid, *widths, px, py, nb, NSEG)
    for g, w in zip(got, want):
        assert np.array_equal(g, w)
    # lanes far past the payload still read its last word
    assert got[0][2, n_valid - 100:n_valid].any()


def test_decode_np_reference_agrees():
    rng = np.random.default_rng(3)
    enc = twc.WirePaneEncoder(NSEG)
    px = np.zeros(NSEG, np.uint16)
    py = np.zeros(NSEG, np.uint16)
    for pane in _walk_panes(rng, n_panes=4):
        e = enc.encode(pane)
        want, px2, py2 = jwc.decode_wire_pane_np(
            jwc.EncodedPane(*e), px, py)
        got, tx2, ty2 = twc.decode_wire_pane_np(e, px, py)
        assert np.array_equal(got, want)
        assert np.array_equal(tx2, px2) and np.array_equal(ty2, py2)
        px, py = px2, py2


@pytest.mark.parametrize("w,nb", [(0, 128), (5, 128), (100, 4096),
                                  (3000, 524_288), (49_152, 524_288)])
def test_word_bucket_matches_jax(w, nb):
    assert twc.wire_word_bucket(w, nb) == jwc.wire_word_bucket(w, nb)
    words = np.arange(w, dtype=np.uint32)
    b = twc.wire_word_bucket(w, nb)
    assert np.array_equal(twc.pad_words(words, b), jwc.pad_words(words, b))


def test_select_decoder_on_cpu():
    e = twc.WirePaneEncoder(NSEG).encode(
        _walk_panes(np.random.default_rng(4), n_panes=1)[0])
    words = torch.from_numpy(twc.pad_words(e.words, 2048).view(np.int32))
    z = torch.zeros(NSEG, dtype=torch.uint16)
    args = (words, e.n, e.bx, e.by, e.bo, z, z)
    kind, decode = twc.select_wire_decoder("auto", sample_args=args,
                                           n=4096, num_segments=NSEG)
    assert kind == "torch" and decode is twc.decode_wire_pane
    with pytest.raises(ValueError):
        twc.select_wire_decoder("cuda", sample_args=args, n=4096,
                                num_segments=NSEG)


def test_decode_rejects_malformed_arguments():
    z = torch.zeros(NSEG, dtype=torch.uint16)
    w = torch.zeros(16, dtype=torch.int32)
    with pytest.raises(ValueError):
        twc.decode_wire_pane(w, 10, 17, 0, 0, z, z, n=128,
                             num_segments=NSEG)
    with pytest.raises(ValueError):
        twc.decode_wire_pane(w, 200, 1, 1, 1, z, z, n=128,
                             num_segments=NSEG)
    with pytest.raises(ValueError):
        twc.decode_wire_pane(w.to(torch.int64), 10, 1, 1, 1, z, z, n=128,
                             num_segments=NSEG)


@pytest.mark.parametrize("spec", [
    "on", '{"depth": 4, "codec": "delta"}',
    '{"fetch_lag": 0, "codec": "off"}',
])
def test_pipeline_policy_parse_matches_jax(spec):
    assert tpipeline.PipelinePolicy.from_env(spec).to_dict() == \
        jpipeline.PipelinePolicy.from_env(spec).to_dict()


@pytest.mark.parametrize("bad", [
    {"depth": 0}, {"fetch_lag": -1}, {"codec": "lz4"},
    {"codec_strategy": "pallas"}, {"unknown": 1},
])
def test_pipeline_policy_rejects_bad_values(bad):
    with pytest.raises(ValueError):
        tpipeline.PipelinePolicy.from_dict(bad)


def test_executor_order_depth_and_lag():
    """Ship-ahead never exceeds depth, in-flight windows never exceed
    fetch_lag, results come out in item order, gap items yield nothing."""
    log = []

    def ship(i):
        log.append(("ship", i))
        return i

    def compute(i, staged):
        log.append(("compute", i))
        shipped = sum(1 for e in log if e[0] == "ship")
        assert shipped - i <= 3  # depth
        return None if i % 4 == 3 else i

    def fetch(works):
        log.append(("fetch", tuple(works)))
        return [w * 10 for w in works]

    ex = tpipeline.PipelinedExecutor(
        tpipeline.PipelinePolicy(depth=3, fetch_lag=2), ship=ship,
        compute=compute, fetch=fetch)
    out = list(ex.run(range(10)))
    assert out == [i * 10 for i in range(10) if i % 4 != 3]
    assert log[-1][0] == "fetch" and len(log[-1][1]) <= 2


def test_arm_from_env(monkeypatch):
    monkeypatch.setenv("SFT_PIPELINE", '{"codec": "delta"}')
    try:
        assert tpipeline.arm_from_env()
        assert tpipeline.policy().codec == "delta"
    finally:
        tpipeline.uninstall()
    monkeypatch.delenv("SFT_PIPELINE")
    assert not tpipeline.arm_from_env()
