"""Planar distances (the reference's DistanceFunctions, batched)."""

from __future__ import annotations

import torch


def point_point_distance(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Euclidean distance between points, broadcasting over leading dims.

    ``a``, ``b``: (..., 2) tensors. One rounding per operation in the
    input dtype; the root of a float32 sum is taken in float64 and rounded
    once, which is the correctly rounded float32 root (torch's float32
    ``sqrt`` on the CPU is not correctly rounded everywhere)."""
    d = a - b
    s = d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]
    if s.dtype == torch.float32:
        return torch.sqrt(s.to(torch.float64)).to(torch.float32)
    return torch.sqrt(s)
