"""Wire pane → per-object kNN digest: the CUDA kernel and its plain twin.

Replaces the TPU kernel ``spatialflink_tpu/ops/pallas_digest.py:
_extract_kernel`` (driven by ``wire_candidates_pallas`` and finished by
``digest_from_candidates``): there, 2048-lane blocks walk the pane in
order and an argmin-peel compacts in-radius (dist, oid, idx) triples into
a 16,384-slot candidate buffer, with an in-program fallback to the full
scatter digest when the hit count overflows it.

On Hopper the digest is built directly (``kernels/csrc/wire_digest.cu``):
the per-object minimum is order-free, so each point's three u16 planes
are dequantized, its distance measured and, on a hit, one 64-bit
``atomicMin`` done on its object's key ``(f32 bits(dist) << 32) | idx``.
There is no candidate buffer, so no overflow and no fallback: the result
is exact at any hit count. Bound: bytes. A 500,000-point pane is 3 MB of
u16 planes in and 128 KB of digest out, about 1 µs at 3.35 TB/s, so at
this size launches cost more than the bytes. The kernel is one
cooperative launch a pane: a thread scans 8 lanes with one 16-byte load
a plane (2-byte loads where the planes are not 16-byte aligned), and
after a grid-wide barrier the same blocks unpack the keys and reset them.
The key scratch is therefore made and filled once per (device, stream,
``num_segments``) and reused; a call allocates only its outputs.

``wire_digest`` launches the kernel for a CUDA tensor and runs the plain
PyTorch version (``wire_digest_plain``) for a CPU tensor. Nothing falls
back from one to the other.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import numpy as np
import torch

from spatialflink_tpu_torch import kernels
from spatialflink_tpu_torch.ops.distances import sqrt_rn
from spatialflink_tpu_torch.ops.knn import KnnPaneDigest, _digest_from_point_dists


def _consts(query_xy, scale, origin, radius):
    """Host constants as exact float32 values."""
    q = np.asarray(query_xy, np.float32)
    s = np.asarray(scale, np.float32)
    o = np.asarray(origin, np.float32)
    return q, s, o, np.float32(radius)


def _check_pane(wire: torch.Tensor, n_valid: int) -> None:
    if wire.dtype != torch.uint16 or wire.dim() != 2 or wire.shape[0] != 3:
        raise ValueError(
            f"wire pane must be (3, n) uint16, got {wire.dtype} "
            f"{tuple(wire.shape)}"
        )
    if not 0 <= n_valid <= wire.shape[1]:
        raise ValueError(f"n_valid {n_valid} outside [0, {wire.shape[1]}]")


def wire_plane_coords(wire_s: torch.Tensor, scale, origin):
    """(3, N) u16 plane-major wire → (xf, yf, oid) planes on its device.

    The f32 upcast is bit-exact by the wire format's m×2^e scale
    contract (``streams/wire.py``); int16 oid bits travel as uint16, and
    values below 32768 upcast bit-exact."""
    dev = wire_s.device
    s = torch.from_numpy(np.asarray(scale, np.float32).copy()).to(dev)
    o = torch.from_numpy(np.asarray(origin, np.float32).copy()).to(dev)
    w = wire_s.to(torch.int32)
    xf = w[0].to(torch.float32) * s[0] + o[0]
    yf = w[1].to(torch.float32) * s[1] + o[1]
    return xf, yf, w[2]


def wire_digest_plain(wire: torch.Tensor, n_valid: int, query_xy, scale,
                      origin, radius, num_segments: int
                      ) -> Tuple[KnnPaneDigest, torch.Tensor]:
    """Plain PyTorch version of the kernel, on ``wire``'s device.

    The same arithmetic in the same order, one rounding per operation:
    ``q·scale + origin``, ``dx·dx + dy·dy``, sqrt, then ``dist <= radius``
    (sqrt first, then compare, as the reference does). Returns the digest
    and the number of in-radius points among the first ``n_valid``."""
    _check_pane(wire, n_valid)
    q, _, _, r = _consts(query_xy, scale, origin, radius)
    dev = wire.device
    xf, yf, oid = wire_plane_coords(wire, scale, origin)
    q_t = torch.from_numpy(q.copy()).to(dev)
    dx = xf - q_t[0]
    dy = yf - q_t[1]
    # The correctly rounded root on every device, as the kernel's
    # __fsqrt_rn (torch's CPU root is not, see ops/distances.py:sqrt_rn).
    dist = sqrt_rn(dx * dx + dy * dy)
    valid = torch.arange(wire.shape[1], device=dev) < n_valid
    radius_t = torch.tensor(r, device=dev)
    count = (valid & (dist <= radius_t)).sum().to(torch.int32)
    return (_digest_from_point_dists(dist, valid, None, oid, radius_t,
                                     num_segments), count)


def _lib():
    lib = kernels.load("wire_digest")
    fn = lib.sft_wire_digest
    if fn.argtypes is None:
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = [p, i, i, f, f, f, f, f, f, f, i, p, p, p, p, p]
        fn.restype = ctypes.c_int
    return fn


def _key_scratch(dev: torch.device, stream: int, num_segments: int):
    """The kernel's scratch on ``stream``: every key ~0 (empty) and one
    more word, 0, for the hit-count accumulator. The kernel leaves it
    so."""
    def make():
        keys = torch.full((num_segments + 1,), -1, dtype=torch.int64,
                          device=dev)
        keys[num_segments] = 0
        return keys
    return kernels.scratch(("wire_digest", dev.index, stream, num_segments),
                           make)


def wire_digest_cuda(wire: torch.Tensor, n_valid: int, query_xy, scale,
                     origin, radius, num_segments: int
                     ) -> Tuple[KnnPaneDigest, torch.Tensor]:
    """Launch the kernel on the current stream (no synchronisation).

    ``seg_min``, ``rep`` and the count are new tensors at every call:
    callers keep earlier panes' digests."""
    _check_pane(wire, n_valid)
    if not wire.is_cuda or not wire.is_contiguous():
        raise ValueError("wire_digest_cuda needs a contiguous CUDA tensor")
    if num_segments < 1:
        raise ValueError(f"num_segments must be >= 1, got {num_segments}")
    q, s, o, r = _consts(query_xy, scale, origin, radius)
    dev = wire.device
    seg_min = torch.empty(num_segments, dtype=torch.float32, device=dev)
    rep = torch.empty(num_segments, dtype=torch.int32, device=dev)
    count = torch.empty((), dtype=torch.int32, device=dev)
    fn = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        keys = _key_scratch(dev, stream, num_segments)
        rc = fn(wire.data_ptr(), wire.shape[1], int(n_valid),
                float(q[0]), float(q[1]), float(s[0]), float(s[1]),
                float(o[0]), float(o[1]), float(r), int(num_segments),
                keys.data_ptr(), seg_min.data_ptr(), rep.data_ptr(),
                count.data_ptr(), stream)
    kernels.check(rc, "wire_digest")
    wire_digest.launches += 1
    return KnnPaneDigest(seg_min, rep), count


def wire_digest(wire: torch.Tensor, n_valid: int, query_xy, scale, origin,
                radius, num_segments: int
                ) -> Tuple[KnnPaneDigest, torch.Tensor]:
    """(3, N) u16 plane-major pane → (digest, in-radius count).

    ``wire``: x_q, y_q and oid bits; lanes at or past ``n_valid`` are
    bucket padding and never match. ``query_xy``/``scale``/``origin``:
    (2,) host float32 values; ``radius``: host float. CUDA tensor → the
    kernel; CPU tensor → the plain version."""
    if wire.is_cuda:
        return wire_digest_cuda(wire, n_valid, query_xy, scale, origin,
                                radius, num_segments)
    return wire_digest_plain(wire, n_valid, query_xy, scale, origin, radius,
                             num_segments)


#: Kernel launches since the count was last set to 0.
wire_digest.launches = 0
