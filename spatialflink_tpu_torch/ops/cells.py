"""Grid-cell assignment and cell-flag gathering on tensors."""

from __future__ import annotations

import torch


def assign_cells(xy: torch.Tensor, min_x: float, min_y: float,
                 cell_length: float, n: int) -> torch.Tensor:
    """Flat int32 cell id ``xi * n + yi`` per point (..., 2); ``n * n``
    marks a point outside the grid (HelperClass.java:104-116). The floor
    is taken in ``xy``'s dtype, as the JAX package's ``assign_cells``."""
    xi = torch.floor((xy[..., 0] - min_x) / cell_length).to(torch.int32)
    yi = torch.floor((xy[..., 1] - min_y) / cell_length).to(torch.int32)
    inside = (xi >= 0) & (xi < n) & (yi >= 0) & (yi < n)
    return torch.where(inside, xi * n + yi,
                       torch.full_like(xi, n * n))


def gather_cell_flags(cell_ids: torch.Tensor,
                      flags: torch.Tensor) -> torch.Tensor:
    """Per-point flags from a (n*n+1,) uint8 table: 0 prune, 1 candidate,
    2 guaranteed; the out-of-grid entry n*n is 0."""
    return flags[cell_ids.long()]
