"""Planar distances (the reference's DistanceFunctions, batched).

Plain PyTorch, one rounding per operation in the input dtype and in the
JAX package's operation order (``spatialflink_tpu/ops/distances.py``).
Roots are correctly rounded on every device (``sqrt_rn``). The
point→polyline minimum runs through the hand kernel B4 on the card:
``ops/polyline_kernel.py``.
"""

from __future__ import annotations

import numpy as np
import torch


def sqrt_rn(s: torch.Tensor, dtype=None) -> torch.Tensor:
    """The correctly rounded root of ``s`` (float32 or float64), rounded
    once more to ``dtype`` when given: the same bits on the card and on
    the CPU, as the kernels' ``__fsqrt_rn`` and, in the float64 mode,
    ``__dsqrt_rn``. On the card torch's root is IEEE-exact. On the CPU it
    is not, in float32 nor in float64 (1 ulp off on some inputs), and
    which lanes it misses depends on how the work is split among threads,
    so two calls on the same input can differ; numpy's root is exact."""
    if s.is_cuda:
        r = torch.sqrt(s)
        return r if dtype is None else r.to(dtype)
    r = np.sqrt(s.numpy())
    if dtype is not None:
        r = r.astype(torch.empty(0, dtype=dtype).numpy().dtype)
    return torch.from_numpy(np.asarray(r))  # a 0-d root is a numpy scalar


def point_point_distance(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Euclidean distance between points, broadcasting over leading dims.

    ``a``, ``b``: (..., 2) tensors."""
    d = a - b
    return sqrt_rn(d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1])


def pairwise_distance(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """All-pairs distance matrix: ``a`` (N, 2), ``b`` (M, 2) → (N, M), by
    explicit differences (DistanceFunctions.java:60-63)."""
    return point_point_distance(a[:, None, :], b[None, :, :])


def point_segment_sq_distance(p: torch.Tensor, s1: torch.Tensor,
                              s2: torch.Tensor) -> torch.Tensor:
    """Squared distance from point(s) to segment(s), broadcasting (..., 2).

    DistanceFunctions.java:96-131 in the JAX package's order: ``ap = p -
    s1``, ``ab = s2 - s1``, ``len_sq``, ``dot``, ``param = dot / len_sq``
    (−1 on a zero-length segment, so it clamps to ``s1``), the clamp to
    [0, 1], ``closest = s1 + t·ab``, ``d = p - closest``, ``d·d``. B4
    (``kernels/csrc/polyline_min_dist.cu``) repeats these operations one
    by one."""
    ap = p - s1
    ab = s2 - s1
    len_sq = ab[..., 0] * ab[..., 0] + ab[..., 1] * ab[..., 1]
    dot = ap[..., 0] * ab[..., 0] + ap[..., 1] * ab[..., 1]
    pos = len_sq > 0
    param = torch.where(pos, dot / torch.where(pos, len_sq, 1.0), -1.0)
    t = torch.clamp(param, 0.0, 1.0)
    dx = p[..., 0] - (s1[..., 0] + t * ab[..., 0])
    dy = p[..., 1] - (s1[..., 1] + t * ab[..., 1])
    return dx * dx + dy * dy


def point_segment_distance(p: torch.Tensor, s1: torch.Tensor,
                           s2: torch.Tensor) -> torch.Tensor:
    """Distance from point(s) to segment(s), broadcasting (..., 2)."""
    return sqrt_rn(point_segment_sq_distance(p, s1, s2))


def point_polyline_distance(p: torch.Tensor, verts: torch.Tensor,
                            edge_valid: torch.Tensor) -> torch.Tensor:
    """(N,) min distance from points ``p`` (N, 2) to the edges of one
    packed boundary: ``verts`` (V, 2), ``edge_valid`` (V-1,) bool. Invalid
    edges count as ``finfo.max``, so a boundary with no valid edge gives
    ``finfo.max`` (DistanceFunctions.java:71-85)."""
    d = point_segment_distance(p[:, None, :], verts[None, :-1],
                               verts[None, 1:])
    big = torch.finfo(d.dtype).max
    d = torch.where(edge_valid[None, :].bool(), d, big)
    return d.min(dim=-1).values


def bbox_point_min_distance(p: torch.Tensor, bbox: torch.Tensor
                            ) -> torch.Tensor:
    """Min distance from point(s) (..., 2) to axis-aligned box(es) (..., 4)
    as (minx, miny, maxx, maxy); 0 inside (DistanceFunctions.java:150-200).
    """
    dx = torch.maximum(torch.clamp(bbox[..., 0] - p[..., 0], min=0),
                       p[..., 0] - bbox[..., 2])
    dy = torch.maximum(torch.clamp(bbox[..., 1] - p[..., 1], min=0),
                       p[..., 1] - bbox[..., 3])
    return sqrt_rn(dx * dx + dy * dy)


def bbox_bbox_min_distance(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Min distance between axis-aligned boxes (..., 4) as (minx, miny,
    maxx, maxy); 0 where they overlap. The closed form of
    DistanceFunctions.getBBoxBBoxMinEuclideanDistance
    (DistanceFunctions.java:298-421), used by approximate geometry kNN."""
    dx = torch.maximum(torch.clamp(b[..., 0] - a[..., 2], min=0),
                       a[..., 0] - b[..., 2])
    dy = torch.maximum(torch.clamp(b[..., 1] - a[..., 3], min=0),
                       a[..., 1] - b[..., 3])
    return sqrt_rn(dx * dx + dy * dy)


#: Mean Earth radius in metres (the reference's mEarthRadius intent).
_EARTH_RADIUS_M = 6371008.7714


def haversine_distance(lonlat_a: torch.Tensor, lonlat_b: torch.Tensor,
                       radius: float = _EARTH_RADIUS_M) -> torch.Tensor:
    """Great-circle distance in metres between lon/lat degrees (..., 2),
    broadcasting over leading dims, on the inputs' device.

    The haversine form of the JAX package (``ops/distances.py:88``): the
    half-angle sines, the term clipped to [0, 1], ``arcsin`` of its root.
    The reference's ``computeHaverSine`` (HelperClass.java:379-385) takes
    the law of cosines, equal in float64 and worse conditioned for near
    points."""
    lon1 = torch.deg2rad(lonlat_a[..., 0])
    lat1 = torch.deg2rad(lonlat_a[..., 1])
    lon2 = torch.deg2rad(lonlat_b[..., 0])
    lat2 = torch.deg2rad(lonlat_b[..., 1])
    dlat = lat2 - lat1
    dlon = lon2 - lon1
    h = (torch.sin(dlat / 2) ** 2
         + torch.cos(lat1) * torch.cos(lat2) * torch.sin(dlon / 2) ** 2)
    return 2 * radius * torch.arcsin(sqrt_rn(torch.clamp(h, 0.0, 1.0)))
