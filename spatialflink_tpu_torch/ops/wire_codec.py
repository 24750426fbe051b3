"""Delta-bitpacked wire-pane codec: fewer bytes per pane on the host link.

The format is the JAX package's ``ops/wire_codec.py``, bit for bit:

- **delta-against-previous-pane**: each record's quantized (x, y) is
  predicted by the SAME object's last position in any earlier pane (a
  per-oid predictor table, init 0); the wire carries the zigzag-encoded
  mod-2^16 delta, so the round trip is exact for every input.
- **bitpacked lanes**: per pane, each of the three streams (zigzag-dx,
  zigzag-dy, oid bits) is packed at the smallest bit width that holds
  its max value (0..16), LSB-first into little-endian uint32 words, the
  three word-aligned streams concatenated into ONE payload.

Encode is host code (numpy, where the bytes originate). Decode runs on
the device: ``decode_wire_pane`` launches the CUDA kernel
(``kernels/csrc/wire_codec.cu``) for a CUDA tensor and runs the plain
PyTorch version (``decode_wire_pane_plain``) for a CPU tensor. The
decoded (3, n) uint16 pane is bit-identical to the raw pane the
uncompressed path would have shipped (padding lanes zeroed), and the
device predictor tables update to each oid's LAST position in the pane,
the rule the host encoder mirrors.

The CUDA kernel replaces the TPU kernel ``spatialflink_tpu/ops/
wire_codec.py:_extract_kernel`` (driven by ``make_pallas_extract``),
which only extracted the three bit streams. Here the kernel also does
the unzigzag, the predictor add and the u16 wrap, and writes the pane;
an ``atomicMax`` of the lane index per oid and a gather update the
tables. Bound: bytes, at most 3 MB of payload in and 3 MB of pane out
per 500,000-point pane, about 2 µs at 3.35 TB/s, so at this size
launches cost more than the bytes. The kernel is one cooperative launch
a pane: a thread decodes 8 lanes from the at most 5 words they span,
each loaded once at the reference's clamped index, and writes them as
one 16-byte store a plane (2-byte stores when ``n % 8 != 0``); after a
grid-wide barrier the same blocks update the tables and reset the
per-oid scratch, which is made and filled once per (device, stream,
``num_segments``) and reused.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Tuple

import numpy as np
import torch

from spatialflink_tpu_torch import kernels
from spatialflink_tpu_torch.ops.wire_knn import check_interpret
from spatialflink_tpu_torch.utils.padding import pad_to_bucket

#: Fixed per-pane header cost: n (4 B) + three bit widths (1 B each) +
#: 1 B pad. The payload words are the real wire traffic.
HEADER_BYTES = 8

#: Floor for the payload word bucket (64 B).
WORD_BUCKET_MIN = 16

#: Rungs per pane bucket in the word ladder: padding overhead is
#: bounded by worst_case/WORD_LADDER_RUNGS (~6%).
WORD_LADDER_RUNGS = 16

#: Strategy values per device. "auto" takes the device's own decoder.
STRATEGIES = {"cuda": ("auto", "cuda"), "cpu": ("auto", "torch")}


# ---------------------------------------------------------------------------
# Host bit packing (encoder side)


def pack_bits(vals: np.ndarray, b: int) -> np.ndarray:
    """Pack ``(n,)`` unsigned values at ``b`` bits each, LSB-first, into
    little-endian uint32 words (``ceil(n*b/32)`` of them)."""
    n = int(len(vals))
    if b == 0 or n == 0:
        return np.zeros(0, np.uint32)
    v = np.asarray(vals, np.uint32)
    bits = ((v[:, None] >> np.arange(b, dtype=np.uint32)[None, :]) & 1)
    flat = bits.astype(np.uint8).ravel()
    words = -((-n * b) // 32)
    pad = words * 32 - flat.size
    if pad:
        flat = np.concatenate([flat, np.zeros(pad, np.uint8)])
    return np.packbits(flat, bitorder="little").view(np.dtype("<u4"))


def unpack_bits_np(words: np.ndarray, n: int, b: int) -> np.ndarray:
    """Host twin of the device extraction (tests + reference decode)."""
    if b == 0 or n == 0:
        return np.zeros(n, np.uint32)
    flat = np.unpackbits(
        np.asarray(words, np.dtype("<u4")).view(np.uint8), bitorder="little",
    )
    take = flat[: n * b].reshape(n, b).astype(np.uint32)
    return (take << np.arange(b, dtype=np.uint32)[None, :]).sum(
        axis=1, dtype=np.uint32
    )


def _zigzag16(d: np.ndarray) -> np.ndarray:
    """int16 deltas → uint16 zigzag codes (small |d| → small code)."""
    d32 = d.astype(np.int32)
    return (((d32 << 1) ^ (d32 >> 15)) & 0xFFFF).astype(np.uint16)


def _bit_width(vals: np.ndarray) -> int:
    if len(vals) == 0:
        return 0
    return int(int(np.max(vals)).bit_length())


class EncodedPane(NamedTuple):
    """One compressed wire pane: payload words + the header scalars the
    decode kernel needs."""

    words: np.ndarray  # (W,) uint32 payload (x-, y-, oid-stream concat)
    n: int             # record count
    bx: int            # zigzag-dx bit width (0..16)
    by: int            # zigzag-dy bit width (0..16)
    bo: int            # oid bit width (0..16)
    raw_bytes: int     # 6 * n: what the uncompressed wire would ship
    coded_bytes: int   # 4 * len(words) + HEADER_BYTES


class WirePaneEncoder:
    """Host-side stateful encoder.

    Mirrors the device predictor table exactly: both sides update each
    oid's entry to its LAST position in the pane, so encoder deltas and
    device reconstruction agree bit for bit. ``state()``/``restore()``
    snapshot the mirror; a restored encoder must be paired with device
    tables shipped from the same state.
    """

    def __init__(self, num_segments: int):
        self.num_segments = int(num_segments)
        self.pred_x = np.zeros(self.num_segments, np.uint16)
        self.pred_y = np.zeros(self.num_segments, np.uint16)

    def encode(self, wire_p: np.ndarray) -> EncodedPane:
        """(3, n) uint16 plane-major pane → :class:`EncodedPane`."""
        wire_p = np.asarray(wire_p)
        if wire_p.ndim != 2 or wire_p.shape[0] != 3 \
                or wire_p.dtype != np.uint16:
            raise ValueError(
                "encode expects a (3, n) uint16 plane-major pane, got "
                f"{wire_p.dtype} {wire_p.shape}"
            )
        n = int(wire_p.shape[1])
        if n == 0:
            return EncodedPane(np.zeros(0, np.uint32), 0, 0, 0, 0, 0,
                               HEADER_BYTES)
        x, y, o = wire_p[0], wire_p[1], wire_p[2]
        if int(np.max(o)) >= self.num_segments:
            raise ValueError(
                f"oid {int(np.max(o))} >= num_segments "
                f"{self.num_segments}: the predictor table cannot index "
                "it (intern ids densely, like the wire digest)"
            )
        oi = o.astype(np.int64)
        dx = (x.astype(np.int32) - self.pred_x[oi].astype(np.int32)) \
            .astype(np.int16)
        dy = (y.astype(np.int32) - self.pred_y[oi].astype(np.int32)) \
            .astype(np.int16)
        zx, zy = _zigzag16(dx), _zigzag16(dy)
        bx, by, bo = _bit_width(zx), _bit_width(zy), _bit_width(o)
        words = np.concatenate(
            [pack_bits(zx, bx), pack_bits(zy, by), pack_bits(o, bo)]
        )
        # Duplicate oids: numpy fancy assignment keeps the LAST write,
        # matching the device update's last-occurrence rule.
        self.pred_x[oi] = x
        self.pred_y[oi] = y
        return EncodedPane(
            words, n, bx, by, bo,
            raw_bytes=6 * n,
            coded_bytes=4 * int(len(words)) + HEADER_BYTES,
        )

    def state(self) -> dict:
        # Copies: the live tables mutate in place on the next encode.
        return {
            "num_segments": int(self.num_segments),
            "pred_x": self.pred_x.copy(),
            "pred_y": self.pred_y.copy(),
        }

    def restore(self, state: dict) -> None:
        if int(state["num_segments"]) != self.num_segments:
            raise ValueError(
                f"codec checkpoint num_segments {state['num_segments']} "
                f"!= this encoder's {self.num_segments}: predictor "
                "tables would silently misalign"
            )
        self.pred_x = np.asarray(state["pred_x"], np.uint16).copy()
        self.pred_y = np.asarray(state["pred_y"], np.uint16).copy()


def wire_word_bucket(w: int, pane_bucket: int,
                     minimum: int = WORD_BUCKET_MIN) -> int:
    """Payload word-count bucket. The rung size is the pane bucket's
    worst-case payload (three 16-bit streams) over ``WORD_LADDER_RUNGS``,
    so the shipped words stay within ~1/16 of the payload."""
    worst = 3 * ((int(pane_bucket) * 16 + 31) >> 5)
    grain = max(int(minimum), -(-worst // WORD_LADDER_RUNGS))
    return max(int(minimum), -(-int(w) // grain) * grain)


def pad_words(words: np.ndarray, bucket: int) -> np.ndarray:
    """Pad the payload to its bucket (zero words are inert: every read
    past a stream's end is masked by the extraction's width mask)."""
    return pad_to_bucket(np.asarray(words, np.uint32), bucket)


def decode_wire_pane_np(enc: EncodedPane, pred_x: np.ndarray,
                        pred_y: np.ndarray
                        ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Host reference decode without padding: (3, n) pane + updated
    predictor copies."""
    n = enc.n
    wx = -((-n * enc.bx) // 32)
    wy = -((-n * enc.by) // 32)
    zx = unpack_bits_np(enc.words[:wx], n, enc.bx)
    zy = unpack_bits_np(enc.words[wx:wx + wy], n, enc.by)
    o = unpack_bits_np(enc.words[wx + wy:], n, enc.bo).astype(np.uint16)
    zi_x = zx.astype(np.int32)
    zi_y = zy.astype(np.int32)
    dx = (zi_x >> 1) ^ -(zi_x & 1)
    dy = (zi_y >> 1) ^ -(zi_y & 1)
    oi = o.astype(np.int64)
    x = ((pred_x[oi].astype(np.int32) + dx) & 0xFFFF).astype(np.uint16)
    y = ((pred_y[oi].astype(np.int32) + dy) & 0xFFFF).astype(np.uint16)
    px2, py2 = pred_x.copy(), pred_y.copy()
    px2[oi] = x
    py2[oi] = y
    return np.stack([x, y, o]), px2, py2


# ---------------------------------------------------------------------------
# Device decode


def _check_args(words, n_valid, bits, pred_x, pred_y, n, num_segments):
    if words.dtype != torch.int32 or words.dim() != 1 or words.numel() < 1:
        raise ValueError(
            "words must be a non-empty (W,) int32 tensor holding the uint32 "
            f"payload bits, got {words.dtype} {tuple(words.shape)}"
        )
    if not 0 <= n_valid <= n:
        raise ValueError(f"n_valid {n_valid} outside [0, {n}]")
    if any(not 0 <= b <= 16 for b in bits):
        raise ValueError(f"bit widths must lie in 0..16, got {bits}")
    for t in (pred_x, pred_y):
        if t.dtype != torch.uint16 or tuple(t.shape) != (num_segments,):
            raise ValueError(
                f"predictor tables must be ({num_segments},) uint16, got "
                f"{t.dtype} {tuple(t.shape)}"
            )


def _extract_lanes(words64, word_off: int, idx, b: int):
    """``b``-bit fields ``idx`` of the LSB-first stream starting at
    ``words64[word_off]`` (int64 lanes holding uint32 words). Cross-word
    reads mask away foreign bits: a field that fits in one word puts the
    next word's bits at ≥ b, where the width mask kills them."""
    n_words = words64.shape[0]
    bitpos = idx * b
    w0 = torch.clamp(word_off + (bitpos >> 5), 0, n_words - 1)
    w1 = torch.clamp(word_off + (bitpos >> 5) + 1, 0, n_words - 1)
    s = bitpos & 31
    lo = words64[w0] >> s
    hi = torch.where(s == 0, 0, words64[w1] << ((32 - s) & 31))
    mask = 0 if b == 0 else (1 << b) - 1
    return (lo | hi) & mask


def _unzigzag(z):
    return (z >> 1) ^ -(z & 1)


def decode_wire_pane_plain(words, n_valid: int, bx: int, by: int, bo: int,
                           pred_x, pred_y, *, n: int, num_segments: int):
    """Plain PyTorch version of the kernel, on ``words``' device: the
    reference's ``decode_wire_pane`` in int64 lanes."""
    _check_args(words, n_valid, (bx, by, bo), pred_x, pred_y, n,
                num_segments)
    dev = words.device
    w64 = words.to(torch.int64) & 0xFFFFFFFF
    idx = torch.arange(n, dtype=torch.int64, device=dev)
    valid = idx < n_valid
    wx = (n_valid * bx + 31) >> 5
    wy = (n_valid * by + 31) >> 5
    zx = _extract_lanes(w64, 0, idx, bx)
    zy = _extract_lanes(w64, wx, idx, by)
    o = _extract_lanes(w64, wx + wy, idx, bo)
    o_safe = torch.clamp(o, 0, num_segments - 1)
    px = pred_x.to(torch.int64)
    py = pred_y.to(torch.int64)
    x = torch.where(valid, (px[o_safe] + _unzigzag(zx)) & 0xFFFF, 0)
    y = torch.where(valid, (py[o_safe] + _unzigzag(zy)) & 0xFFFF, 0)
    ou = torch.where(valid, o, 0)
    pane = torch.stack([x, y, ou]).to(torch.uint16)
    # Last-occurrence predictor update: per-oid max lane index, then that
    # lane's decoded coordinates (unchanged where the oid is absent).
    last = torch.full((num_segments,), -1, dtype=torch.int64, device=dev)
    last.scatter_reduce_(0, o_safe[valid], idx[valid], reduce="amax",
                         include_self=True)
    has = last >= 0
    gpos = torch.clamp(last, 0, n - 1)
    px2 = torch.where(has, x[gpos], px).to(torch.uint16)
    py2 = torch.where(has, y[gpos], py).to(torch.uint16)
    return pane, px2, py2


def _lib():
    fn = kernels.load("wire_codec").sft_wire_codec_decode
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, i, i, i, i, i, i, p, p, i, p, p, p, p, p]
        fn.restype = ctypes.c_int
    return fn


#: Ints per oid in the kernel's ``last`` scratch: one 32-byte sector each.
LAST_STRIDE = 8


def _last_scratch(dev: torch.device, stream: int, num_segments: int):
    """The kernel's per-oid last-lane scratch on ``stream``, all -1; the
    kernel leaves it so."""
    return kernels.scratch(
        ("wire_codec", dev.index, stream, num_segments),
        lambda: torch.full((num_segments * LAST_STRIDE,), -1,
                           dtype=torch.int32, device=dev))


def decode_wire_pane_cuda(words, n_valid: int, bx: int, by: int, bo: int,
                          pred_x, pred_y, *, n: int, num_segments: int):
    """Launch the kernel on the current stream (no synchronisation).

    The pane and both tables are new tensors at every call: ``pred_x``
    and ``pred_y`` are read only."""
    _check_args(words, n_valid, (bx, by, bo), pred_x, pred_y, n,
                num_segments)
    for t in (words, pred_x, pred_y):
        if not t.is_cuda or not t.is_contiguous():
            raise ValueError("decode_wire_pane_cuda needs contiguous CUDA "
                             "tensors")
    dev = words.device
    pane = torch.empty((3, n), dtype=torch.uint16, device=dev)
    px2 = torch.empty(num_segments, dtype=torch.uint16, device=dev)
    py2 = torch.empty(num_segments, dtype=torch.uint16, device=dev)
    fn = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        last = _last_scratch(dev, stream, num_segments)
        rc = fn(words.data_ptr(), words.shape[0], int(n), int(n_valid),
                int(bx), int(by), int(bo), pred_x.data_ptr(),
                pred_y.data_ptr(), int(num_segments), pane.data_ptr(),
                last.data_ptr(), px2.data_ptr(), py2.data_ptr(), stream)
    kernels.check(rc, "wire_codec_decode")
    decode_wire_pane.launches += 1
    return pane, px2, py2


def decode_wire_pane(words, n_valid: int, bx: int, by: int, bo: int,
                     pred_x, pred_y, *, n: int, num_segments: int):
    """Device decode + predictor update for one coded pane.

    ``words``: (W,) int32 tensor of the bucket-padded uint32 payload
    bits; ``n_valid``/widths: host ints; ``pred_x``/``pred_y``:
    (num_segments,) uint16 device tables. Returns ``(pane, pred_x2,
    pred_y2)``, ``pane`` the (3, n) uint16 plane-major pane with lanes
    past ``n_valid`` zeroed. CUDA tensors → the kernel; CPU → the plain
    version."""
    if words.is_cuda:
        return decode_wire_pane_cuda(words, n_valid, bx, by, bo, pred_x,
                                     pred_y, n=n, num_segments=num_segments)
    return decode_wire_pane_plain(words, n_valid, bx, by, bo, pred_x, pred_y,
                                  n=n, num_segments=num_segments)


#: Kernel launches since the count was last set to 0.
decode_wire_pane.launches = 0


def codec_decodes_agree(a, b) -> bool:
    """Two decoded (pane, px, py) triples are BIT-identical: the codec is
    integer arithmetic only."""
    return all(torch.equal(x.cpu(), y.cpu()) for x, y in zip(a, b))


def select_wire_decoder(strategy: str = "auto", *,
                        interpret: bool = False, sample_args: tuple,
                        n: int, num_segments: int):
    """Pick the decoder for the sample's device.

    ``sample_args``: (words, n_valid, bx, by, bo, pred_x, pred_y) of the
    first coded pane, ``n`` its bucket. Returns ``(kind, decode)``, where
    ``decode`` is :func:`decode_wire_pane`. On a card, kind is
    ``"cuda"``: the kernel decodes the sample beside the plain version,
    and a decode that is not bit-identical raises ``RuntimeError``. On
    the CPU, kind is ``"torch"``. A strategy that names the other
    device's decoder raises ``ValueError``. ``interpret`` keeps the JAX
    signature's flag and is accepted on the CPU only
    (``ops/wire_knn.py:check_interpret``)."""
    dev = sample_args[0].device.type
    check_interpret(interpret, dev)
    if strategy not in STRATEGIES[dev]:
        raise ValueError(
            f"codec strategy {strategy!r} is not available on {dev} "
            f"(choose from {STRATEGIES[dev]})"
        )
    decode = decode_wire_pane
    if dev == "cpu":
        return "torch", decode
    got = decode_wire_pane_cuda(*sample_args, n=n, num_segments=num_segments)
    want = decode_wire_pane_plain(*sample_args, n=n,
                                  num_segments=num_segments)
    if not codec_decodes_agree(got, want):
        raise RuntimeError(
            "wire-codec self-check failed: the CUDA decode of the first "
            "coded pane differs from its plain PyTorch version"
        )
    return "cuda", decode
