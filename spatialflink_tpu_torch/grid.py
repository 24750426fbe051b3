"""UniformGrid: the grid extent and the cell arithmetic the operators read.

The wire format quantizes against the extent; the join assigns points to
cells (``assign_cells_np``) and reads the candidate neighbourhood from the
layer math (``candidate_layers``, ``neighbor_offsets``), kept numerically
identical to the JAX package's ``grid.py`` (and so to the reference's
UniformGrid.java). The range operators' flag tables come with their slice.
"""

from __future__ import annotations

import math

import numpy as np


class UniformGrid:
    """Square uniform grid over a bounding box: ``num_partitions`` cells
    per side (the reference's UniformGrid(n, bbox) constructor)."""

    def __init__(self, num_partitions: int, min_x: float, max_x: float,
                 min_y: float, max_y: float):
        if num_partitions < 1:
            raise ValueError("num_partitions must be >= 1")
        self.min_x = float(min_x)
        self.max_x = float(max_x)
        self.min_y = float(min_y)
        self.max_y = float(max_y)
        self.n = int(num_partitions)
        self.cell_length = (self.max_x - self.min_x) / self.n

    @property
    def num_cells(self) -> int:
        return self.n * self.n

    def cell_xy_indices_np(self, xy: np.ndarray) -> np.ndarray:
        """(N, 2) int32 unclamped (xi, yi) floor indices."""
        xi = np.floor((xy[..., 0] - self.min_x) / self.cell_length).astype(np.int32)
        yi = np.floor((xy[..., 1] - self.min_y) / self.cell_length).astype(np.int32)
        return np.stack([xi, yi], axis=-1)

    def assign_cells_np(self, xy: np.ndarray) -> np.ndarray:
        """Flat cell id ``xi * n + yi`` per point; ``num_cells`` marks a
        point outside the grid (such points never join)."""
        xi = np.floor((xy[..., 0] - self.min_x) / self.cell_length).astype(np.int64)
        yi = np.floor((xy[..., 1] - self.min_y) / self.cell_length).astype(np.int64)
        inside = (xi >= 0) & (xi < self.n) & (yi >= 0) & (yi < self.n)
        return np.where(inside, xi * self.n + yi, self.num_cells).astype(np.int32)

    def candidate_layers(self, radius: float) -> int:
        """ceil(r / cell); UniformGrid.java:441-445."""
        return math.ceil(radius / self.cell_length)

    def neighbor_offsets(self, radius: float) -> np.ndarray:
        """(K, 2) int32 (dx, dy) offsets covering the candidate square,
        dx-major."""
        lc = self.candidate_layers(radius)
        r = np.arange(-lc, lc + 1, dtype=np.int32)
        dx, dy = np.meshgrid(r, r, indexing="ij")
        return np.stack([dx.reshape(-1), dy.reshape(-1)], axis=1)
