"""Grid-hash join extraction: the CUDA kernel, its plain twin, and the
window wrapper ``join_window``.

Replaces the TPU kernel ``spatialflink_tpu/ops/pallas_join.py:
_extract_kernel`` (driven by ``join_window_pallas``). There, one grid
step walks one row of left cells; per cell it concatenates the (2L+1)²
neighbour buckets of the right side into one (cap_left, k_cand)
candidate block, evaluates ``d² <= r²`` on the vector unit and peels the
hits off one at a time with an argmin over the hit codes, into
VMEM-resident (max_pairs,) outputs.

The output order is the TPU kernel's: cells in row-major (i, j) order,
and within a cell the hits ascending by the code ``l_lane · k_cand +
((dx+L)·span + (dy+L)) · cap_right + r_lane`` with ``k_cand =
span²·cap_right``. Keeping that order makes the result deterministic and
equal, array for array, to ``join_window_pallas``.

On Hopper (``kernels/csrc/join_extract.cu``) the peel becomes one
ordered pass, one warp per cell (four cells a block, no block barrier):
- the warp takes its cell from an atomic ticket, so cells start in
  row-major order and a warp waits only on cells already running;
- it stages the cell's live left slots and live right candidates in its
  shared memory (every slot's index and coordinates in one batch of
  loads, the live ones compacted in order with a ballot and a popcount),
  so that compacted order is code order whatever slots are live;
- it tests live × live pairs only (~1,550 a cell at the full join shape,
  not 20,736), a chunk of 32 candidates against each live left slot,
  and keeps each ballot as a hit mask;
- a single-pass scan with decoupled look-back (Merrill & Garland) gives
  each cell its output offset: the warp publishes its count in a 64-bit
  status word, sums its predecessors' 32 at a time until it meets an
  inclusive prefix, and publishes its own; the last cell's is the true
  total;
- it walks the nonzero hit masks in code order and writes each hit at
  offset + rank while that is below the budget.
The status words are zeroed by one memset and a second launch fills the
tail past ``count`` on the device: two kernel launches a call and no host
synchronisation. There is no budget other than memory: the outputs live
in device memory, so the TPU's 524,288-pair VMEM cap and its fallbacks
are gone. Bound at the full join shape (grid 100, cap 48, L = 1, 131,072
points a side): bytes, ~15 MB of planes and pairs, ~4.4 µs; the kernel
stays above it on latency (a warp stages, counts, then waits for its
predecessors' counts, and 8.4 KB of shared memory a warp keeps 24 warps
resident per multiprocessor).

``join_extract`` launches the kernel for CUDA tensors and runs the plain
PyTorch version (``join_extract_plain``) for CPU tensors; nothing falls
back from one to the other.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from spatialflink_tpu_torch import kernels
from spatialflink_tpu_torch.ops.distances import sqrt_rn
from spatialflink_tpu_torch.ops.join import CompactJoinResult, bucketize_planes

#: Lanes (cells × cap_left × k_cand) the plain version tests per block of
#: grid rows; bounds its temporaries to a few hundred MB.
PLAIN_BLOCK_LANES = 1 << 24

#: One warp's cell (``warp_shared_bytes``) fits in at most this much
#: dynamic shared memory (the H100's 232,448 B per block, less 1 KB);
#: the kernel puts as many cells in a block as fit, up to four.
MAX_SHARED_BYTES = 232_448 - 1024


def _round_pairs(max_pairs: int) -> int:
    """Budgets round up to whole 128-slot rows, as the TPU kernel's."""
    max_pairs = int(max_pairs)
    if max_pairs < 0:
        raise ValueError(f"max_pairs must be >= 0, got {max_pairs}")
    return max_pairs + (-max_pairs) % 128


def _check_planes(lx, ly, lidx, rxp, ryp, ridxp, grid_n, layers):
    gp = grid_n + 2 * layers
    cap_l, cap_r = lx.shape[-1], rxp.shape[-1]
    want = [(lx, (grid_n, grid_n, cap_l), torch.float32),
            (ly, (grid_n, grid_n, cap_l), torch.float32),
            (lidx, (grid_n, grid_n, cap_l), torch.int32),
            (rxp, (gp, gp, cap_r), torch.float32),
            (ryp, (gp, gp, cap_r), torch.float32),
            (ridxp, (gp, gp, cap_r), torch.int32)]
    for t, shape, dtype in want:
        if tuple(t.shape) != shape or t.dtype != dtype:
            raise ValueError(
                f"join planes must be {shape} {dtype}, got "
                f"{tuple(t.shape)} {t.dtype}")
        if t.device != lx.device:
            raise ValueError("join planes must lie on one device")
    if layers < 0 or cap_l < 1 or cap_r < 1:
        raise ValueError(f"bad join shape: layers={layers} cap_left={cap_l} "
                         f"cap_right={cap_r}")


def join_planes(left_xy, left_valid, left_cells, right_xy, right_valid,
                right_cells, grid_n: int, layers: int, cap_left: int,
                cap_right: int):
    """Both sides' bucket planes as the extraction takes them: the left
    planes (grid_n, grid_n, cap_left), the right ones padded by ``layers``
    rows and columns on each side with idx −1 (never matches), so every
    neighbour access is in bounds; plus ``overflow = l_over + r_over``."""
    lx, ly, lidx, l_over = bucketize_planes(
        left_xy.to(torch.float32), left_valid, left_cells, grid_n, cap_left)
    rx, ry, ridx, r_over = bucketize_planes(
        right_xy.to(torch.float32), right_valid, right_cells, grid_n,
        cap_right)
    pad = (0, 0, layers, layers, layers, layers)
    rxp = torch.nn.functional.pad(rx, pad)
    ryp = torch.nn.functional.pad(ry, pad)
    ridxp = torch.nn.functional.pad(ridx, pad, value=-1)
    return (lx, ly, lidx, rxp, ryp, ridxp), l_over + r_over


def join_extract_plain(lx, ly, lidx, rxp, ryp, ridxp, grid_n: int,
                       layers: int, radius, max_pairs: int):
    """Plain PyTorch version of the kernel, on the planes' device.

    For a block of grid rows at a time the shifted right planes are
    gathered into (rows, grid_n, k_cand) candidates and the pair mask
    (rows, grid_n, cap_left, k_cand) is evaluated; its ``nonzero`` order
    (row-major) is the code order. The first ``max_pairs`` hits are kept.
    Returns (left_index, right_index, dist, count)."""
    _check_planes(lx, ly, lidx, rxp, ryp, ridxp, grid_n, layers)
    max_pairs = _round_pairs(max_pairs)
    dev = lx.device
    span = 2 * layers + 1
    cap_l, cap_r = lx.shape[-1], rxp.shape[-1]
    k_cand = span * span * cap_r
    r = torch.tensor(np.float32(radius), device=dev)
    r2 = r * r
    outl = torch.full((max_pairs,), -1, dtype=torch.int32, device=dev)
    outr = torch.full((max_pairs,), -1, dtype=torch.int32, device=dev)
    outd = torch.full((max_pairs,), float("inf"), dtype=torch.float32,
                      device=dev)
    rows = max(1, PLAIN_BLOCK_LANES // (grid_n * cap_l * k_cand))
    total = 0
    for r0 in range(0, grid_n, rows):
        r1 = min(grid_n, r0 + rows)
        nr = r1 - r0

        def cand(plane):
            # (nr, grid_n, span², cap_r) → (nr, grid_n, k_cand), dx-major.
            return torch.stack(
                [plane[r0 + di:r1 + di, dj:dj + grid_n]
                 for di in range(span) for dj in range(span)],
                dim=2).reshape(nr, grid_n, k_cand)

        sx, sy, sidx = cand(rxp), cand(ryp), cand(ridxp)
        ddx = lx[r0:r1, :, :, None] - sx[:, :, None, :]
        ddy = ly[r0:r1, :, :, None] - sy[:, :, None, :]
        d2 = ddx * ddx + ddy * ddy
        mask = ((lidx[r0:r1, :, :, None] >= 0) & (sidx[:, :, None, :] >= 0)
                & (d2 <= r2))
        hits = torch.nonzero(mask)
        room = max(0, min(hits.shape[0], max_pairs - total))
        if room:
            h = hits[:room]
            a, b, lane, c = h[:, 0], h[:, 1], h[:, 2], h[:, 3]
            outl[total:total + room] = lidx[r0 + a, b, lane]
            outr[total:total + room] = sidx[a, b, c]
            # The correctly rounded root, as the kernel's __fsqrt_rn.
            outd[total:total + room] = sqrt_rn(d2[a, b, lane, c])
        total += hits.shape[0]
    count = torch.tensor(total, dtype=torch.int32, device=dev)
    return outl, outr, outd, count


def _lib():
    lib = kernels.load("join_extract")
    fn = lib.sft_join_extract
    if fn.argtypes is None:
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = [p, p, p, p, p, p, i, i, i, i, f, i, p, p, p, p, p, p]
        fn.restype = ctypes.c_int
    return fn


def warp_shared_bytes(cap_left: int, cap_right: int, layers: int) -> int:
    """Shared memory the kernel's warp takes for one cell: the compacted
    left slots and right candidates, 12 B each (x, y, idx), and a 32-bit
    hit mask per (left slot, chunk of 32 candidates), rounded up to
    16 B."""
    span = 2 * layers + 1
    k_cand = span * span * cap_right
    b = 12 * (cap_left + k_cand) + 4 * cap_left * -(-k_cand // 32)
    return b + (-b) % 16


def join_extract_cuda(lx, ly, lidx, rxp, ryp, ridxp, grid_n: int,
                      layers: int, radius, max_pairs: int):
    """Launch the kernel on the current stream (no synchronisation).
    Returns (left_index, right_index, dist, count) on the card."""
    _check_planes(lx, ly, lidx, rxp, ryp, ridxp, grid_n, layers)
    planes = (lx, ly, lidx, rxp, ryp, ridxp)
    if not all(t.is_cuda and t.is_contiguous() for t in planes):
        raise ValueError("join_extract_cuda needs contiguous CUDA planes")
    if grid_n < 1 or max(lx.numel(), rxp.numel()) >= 2**31:
        raise ValueError(f"join_extract_cuda takes grid_n >= 1 and planes "
                         f"of fewer than 2**31 slots (32-bit offsets), got "
                         f"grid_n={grid_n}")
    max_pairs = _round_pairs(max_pairs)
    cap_l, cap_r = lx.shape[-1], rxp.shape[-1]
    smem = warp_shared_bytes(cap_l, cap_r, layers)
    if smem > MAX_SHARED_BYTES:
        raise ValueError(
            f"cap_left={cap_l}, cap_right={cap_r}, layers={layers} need "
            f"{smem} B of shared memory per cell; the card has "
            f"{MAX_SHARED_BYTES}")
    dev = lx.device
    ncell = grid_n * grid_n
    outl = torch.empty(max_pairs, dtype=torch.int32, device=dev)
    outr = torch.empty(max_pairs, dtype=torch.int32, device=dev)
    outd = torch.empty(max_pairs, dtype=torch.float32, device=dev)
    count = torch.empty((), dtype=torch.int32, device=dev)
    # The scan's status words, one a cell, and the cell ticket; the
    # kernel's entry zeroes them on the stream.
    scratch = torch.empty(ncell + 1, dtype=torch.int64, device=dev)
    fn = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(lx.data_ptr(), ly.data_ptr(), lidx.data_ptr(),
                rxp.data_ptr(), ryp.data_ptr(), ridxp.data_ptr(),
                int(grid_n), int(layers), int(cap_l), int(cap_r),
                float(np.float32(radius)), int(max_pairs),
                scratch.data_ptr(), count.data_ptr(), outl.data_ptr(),
                outr.data_ptr(), outd.data_ptr(), stream)
    kernels.check(rc, "join_extract")
    join_extract.launches += 1
    return outl, outr, outd, count


def join_extract(lx, ly, lidx, rxp, ryp, ridxp, grid_n: int, layers: int,
                 radius, max_pairs: int):
    """Pairs within ``radius`` between each left bucket and its
    (2·layers+1)² neighbour right buckets: (left_index, right_index, dist,
    count), the first ``max_pairs`` (rounded up to 128) in code order.
    CUDA planes → the kernel; CPU planes → the plain version."""
    if lx.is_cuda:
        return join_extract_cuda(lx, ly, lidx, rxp, ryp, ridxp, grid_n,
                                 layers, radius, max_pairs)
    return join_extract_plain(lx, ly, lidx, rxp, ryp, ridxp, grid_n, layers,
                              radius, max_pairs)


#: Kernel launches since the count was last set to 0.
join_extract.launches = 0


def join_window(left_xy, left_valid, left_cells, right_xy, right_valid,
                right_cells, grid_n: int, layers: int, radius,
                cap_left: int, cap_right: int,
                max_pairs: int) -> CompactJoinResult:
    """Dense-bucket grid join of two cell-assigned point batches: the
    port of ``join_window_pallas``, with the same arguments and result.

    ``left_cells``/``right_cells``: flat cell ids (``grid_n²`` =
    out-of-grid). ``radius`` is the distance predicate (``inf`` in
    approximate mode); ``layers`` the candidate neighbourhood. ``count``
    is the true pair count even past ``max_pairs`` (rounded up to a
    multiple of 128); ``overflow`` counts in-grid points dropped past a
    bucket (the result is exact iff it is 0)."""
    planes, overflow = join_planes(left_xy, left_valid, left_cells,
                                   right_xy, right_valid, right_cells,
                                   grid_n, layers, cap_left, cap_right)
    li, ri, dd, count = join_extract(*planes, grid_n, layers, radius,
                                     max_pairs)
    return CompactJoinResult(li, ri, dd, count, overflow)
