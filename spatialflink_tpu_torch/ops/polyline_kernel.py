"""Point→polyline min distance over many boundaries (B4): the CUDA
kernel, its plain twin, and the wrapper ``polyline_min_dist``.

Replaces the TPU kernel ``spatialflink_tpu/ops/pallas_kernels.py:
_min_dist_kernel`` (driven by ``point_polyline_min_dist_pallas``): there,
one ``pallas_call`` gives the (N,) min distance from a block of points to
one boundary's edges, the edges read as SMEM scalars in a ``fori_loop``
with a running minimum of d². Here one launch gives an (N, C) table, so a
range query's whole distance step is one call:

- dense (``sel`` None): entry [i, g] for every boundary g of the set;
- gathered: entry [i, j] for boundary ``sel[i, j]`` (the pruned paths'
  top-``cand`` candidates).

The result is ``point_polyline_distance`` (``ops/distances.py``) batched:
invalid edges are skipped, degenerate edges clamp to their first
endpoint, and a boundary with no valid edge gives ``finfo(float32).max``
(the TPU kernel wrote +inf there). The kernel
(``kernels/csrc/polyline_min_dist.cu``) rounds each operation as the
plain version does, so the two agree bit for bit.

In the float64 mode (``precision.py``) the inputs are float64, and the
same kernel instantiated for double (``sft_polyline_min_dist_f64``)
computes in float64, with ``finfo(float64).max`` for a boundary with no
valid edge, as the JAX package's float64 ``point_polyline_distance``.
The plain version is generic over the two dtypes.

On Hopper both modes first build a per-edge table in shared memory (x1,
y1, abx, aby, len_sq of each valid edge, field by field, and each
boundary's count of valid edges, compacted with a warp ballot), so the
inner loop runs over valid edges with no flag and no recomputed edge
constant. Gathered: one thread per point for all C slots, ``sel`` read
and ``out`` written as 16-byte vectors when C % 4 == 0, four slots'
edge loops interleaved, a grid of the resident blocks (a set too large
to stage is read through the read-only cache instead). Dense: 32
boundaries on the lanes of a warp × 64 points a block, so a warp's store
writes a point's row segment contiguously. The bound is bytes (18.9 MB
gathered at the range path's config 3, ~5.6 µs; 33.5 MB of output dense
at 32 polygons, ~10.6 µs); what keeps the kernel above it is instruction
issue, some 30 instructions per (point, edge) with the correctly rounded
division, which it skips where the clamp to [0, 1] decides the result.

``polyline_min_dist`` launches the kernel for CUDA tensors and runs the
plain PyTorch version (``polyline_min_dist_plain``) for CPU tensors;
nothing falls back from one to the other.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from spatialflink_tpu_torch import kernels
from spatialflink_tpu_torch.ops.distances import (
    point_segment_sq_distance,
    sqrt_rn,
)
from spatialflink_tpu_torch.ops.polygon import used_edges

#: Lanes (points × slots × edges) the plain version evaluates per block of
#: points: on the card this bounds its temporaries to a few hundred MB; on
#: the CPU a smaller block keeps them in cache (about 3× faster at the
#: joins' shapes). The result does not depend on the block.
PLAIN_BLOCK_LANES = 1 << 24
PLAIN_BLOCK_LANES_CPU = 1 << 19

#: Dynamic shared memory a block may take on the H100 (232,448 B opt-in).
MAX_SHARED_BYTES = 232_448

#: The coordinate dtypes the kernel takes: its float and double
#: instantiations.
DTYPES = (torch.float32, torch.float64)


def _check(xy, verts, edge_valid, sel):
    if xy.dim() != 2 or xy.shape[1] != 2 or xy.dtype not in DTYPES:
        raise ValueError(f"xy must be (N, 2) float32 or float64, got "
                         f"{tuple(xy.shape)} {xy.dtype}")
    if verts.dim() != 3 or verts.shape[2] != 2 or verts.shape[1] < 2 \
            or verts.dtype != xy.dtype:
        raise ValueError(f"verts must be (G, V >= 2, 2) {xy.dtype}, got "
                         f"{tuple(verts.shape)} {verts.dtype}")
    g, v = verts.shape[:2]
    if tuple(edge_valid.shape) != (g, v - 1) or edge_valid.dtype not in (
            torch.bool, torch.uint8):
        raise ValueError(f"edge_valid must be ({g}, {v - 1}) bool or uint8, "
                         f"got {tuple(edge_valid.shape)} {edge_valid.dtype}")
    tensors = [xy, verts, edge_valid]
    if sel is not None:
        if sel.dim() != 2 or sel.shape[0] != xy.shape[0] \
                or sel.dtype != torch.int32:
            raise ValueError(f"sel must be ({xy.shape[0]}, C) int32, got "
                             f"{tuple(sel.shape)} {sel.dtype}")
        tensors.append(sel)
    if any(t.device != xy.device for t in tensors):
        raise ValueError("polyline_min_dist inputs must lie on one device")
    return tensors


def polyline_min_dist_plain(xy: torch.Tensor, verts: torch.Tensor,
                            edge_valid: torch.Tensor,
                            sel: Optional[torch.Tensor] = None
                            ) -> torch.Tensor:
    """Plain PyTorch version of the kernel, on the inputs' device and in
    their dtype: per block of points, d² of every (point, slot, edge) in
    the kernel's operation order, +inf on invalid edges, the min over
    edges, the correctly rounded root and the cap at the dtype's
    ``finfo.max``. On the CPU the edge columns valid in no boundary are
    cut first (``used_edges``)."""
    _check(xy, verts, edge_valid, sel)
    ev = edge_valid.bool()
    if not xy.is_cuda:
        verts, ev = used_edges(verts, ev)
    n, (g, v) = xy.shape[0], verts.shape[:2]
    c = g if sel is None else sel.shape[1]
    big = torch.finfo(xy.dtype).max
    out = torch.empty((n, c), dtype=xy.dtype, device=xy.device)
    lanes = PLAIN_BLOCK_LANES if xy.is_cuda else PLAIN_BLOCK_LANES_CPU
    step = max(1, lanes // max(1, c * (v - 1)))
    for i0 in range(0, n, step):
        i1 = min(n, i0 + step)
        p = xy[i0:i1, None, None, :]
        if sel is None:
            bv, ok = verts[None], ev[None]
        else:
            s = sel[i0:i1].long()
            bv, ok = verts[s], ev[s]
        d2 = point_segment_sq_distance(p, bv[..., :-1, :], bv[..., 1:, :])
        d2 = torch.where(ok, d2, float("inf")).min(dim=-1).values
        out[i0:i1] = sqrt_rn(d2).clamp(max=big)
    return out


def _lib(dtype: torch.dtype):
    """The C entry of the kernel's ``dtype`` instantiation."""
    lib = kernels.load("polyline_min_dist")
    fn = (lib.sft_polyline_min_dist_f64 if dtype == torch.float64
          else lib.sft_polyline_min_dist)
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, i, i, i, i, i, i, p, p]
        fn.restype = ctypes.c_int
    return fn


def polyline_min_dist_cuda(xy: torch.Tensor, verts: torch.Tensor,
                           edge_valid: torch.Tensor,
                           sel: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """Launch the kernel of the inputs' dtype on the current stream (no
    synchronisation). ``sel`` entries must lie in [0, G): the kernel does
    not check them."""
    tensors = _check(xy, verts, edge_valid, sel)
    if not all(t.is_cuda and t.is_contiguous() for t in tensors):
        raise ValueError("polyline_min_dist_cuda needs contiguous CUDA "
                         "tensors")
    align = 2 * xy.element_size()
    if xy.data_ptr() % align or verts.data_ptr() % align:
        raise ValueError(f"xy and verts must be {align}-byte aligned (pair "
                         f"loads)")
    n, (g, v) = xy.shape[0], verts.shape[:2]
    c = g if sel is None else sel.shape[1]
    if sel is None and g > 65_535 * 32:
        raise ValueError(f"dense mode takes at most 65,535 × 32 boundaries "
                         f"(one grid row per 32), got {g}")
    ev = edge_valid.view(torch.uint8) if edge_valid.dtype == torch.bool \
        else edge_valid
    dev = xy.device
    out = torch.empty((n, c), dtype=xy.dtype, device=dev)
    fn = _lib(xy.dtype)
    with torch.cuda.device(dev):
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(xy.data_ptr(), verts.data_ptr(), ev.data_ptr(),
                None if sel is None else sel.data_ptr(), int(n), int(c),
                int(g), int(v), MAX_SHARED_BYTES, sms,
                out.data_ptr(), stream)
    kernels.check(rc, "polyline_min_dist")
    polyline_min_dist.launches += 1
    if xy.dtype == torch.float64:
        polyline_min_dist.launches_f64 += 1
    return out


def polyline_min_dist(xy: torch.Tensor, verts: torch.Tensor,
                      edge_valid: torch.Tensor,
                      sel: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(N, C) min edge distance from point i to boundary ``sel[i, j]`` (or
    boundary j when ``sel`` is None, C = G), in the inputs' dtype. ``xy``
    (N, 2) and ``verts`` (G, V, 2) both float32 or both float64,
    ``edge_valid`` (G, V-1) bool or uint8, ``sel`` (N, C) int32. CUDA
    tensors → the kernel; CPU tensors → the plain version."""
    if xy.is_cuda:
        return polyline_min_dist_cuda(xy, verts, edge_valid, sel)
    return polyline_min_dist_plain(xy, verts, edge_valid, sel)


#: Kernel launches since the count was last set to 0, and those of them
#: that ran the float64 instantiation.
polyline_min_dist.launches = 0
polyline_min_dist.launches_f64 = 0
