"""UniformGrid: the grid extent and the cell arithmetic the operators read.

The wire format quantizes against the extent; the join assigns points to
cells (``assign_cells_np``) and reads the candidate neighbourhood from the
layer math (``candidate_layers``, ``neighbor_offsets``); the range
operators read a dense uint8 flag table per (query set, radius)
(``neighbor_flags``), gathered per point on the device (``ops/cells.py``).
All of it is kept numerically identical to the JAX package's ``grid.py``
(and so to the reference's UniformGrid.java):
  - guaranteed layers L_g = floor(r / (cell * sqrt(2)) - 1)
    (UniformGrid.java:428-439); -1 means no guaranteed cells;
  - candidate layers L_c = ceil(r / cell) (UniformGrid.java:441-445);
    the candidate set is the L_c-square minus the guaranteed set.
"""

from __future__ import annotations

import math
from typing import Iterable, Tuple

import numpy as np

#: Flag table values: prune, candidate (needs the exact distance),
#: guaranteed (emit with no distance test).
FLAG_NONE = np.uint8(0)
FLAG_CANDIDATE = np.uint8(1)
FLAG_GUARANTEED = np.uint8(2)

#: Digits of each cell index in a cell name (UniformGrid.java
#: CELLINDEXSTRLENGTH).
_CELL_INDEX_STR_LENGTH = 5


class UniformGrid:
    """Square uniform grid over a bounding box: ``num_partitions`` cells
    per side (the reference's UniformGrid(n, bbox) constructor), or cells
    of a given length (``from_cell_length``)."""

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

    @classmethod
    def from_cell_length(cls, cell_length: float, min_x: float, max_x: float,
                         min_y: float, max_y: float) -> "UniformGrid":
        """The grid of cells ``cell_length`` wide over the bbox, its shorter
        axis first stretched symmetrically to the longer one's span
        (UniformGrid.java:47-73 and :115-135)."""
        x_diff = max_x - min_x
        y_diff = max_y - min_y
        if x_diff > y_diff:
            pad = (x_diff - y_diff) / 2
            min_y, max_y = min_y - pad, max_y + pad
        elif y_diff > x_diff:
            pad = (y_diff - x_diff) / 2
            min_x, max_x = min_x - pad, max_x + pad
        n = max(1, math.ceil((max_x - min_x) / cell_length))
        return cls(n, min_x, max_x, min_y, max_y)

    @property
    def num_cells(self) -> int:
        return self.n * self.n

    def cell_indices(self, x: float, y: float) -> Tuple[int, int]:
        """Floor indices, unclamped (HelperClass.java:104-116)."""
        xi = math.floor((x - self.min_x) / self.cell_length)
        yi = math.floor((y - self.min_y) / self.cell_length)
        return xi, yi

    def flat_cell(self, x: float, y: float) -> int:
        """Flat id ``xi * n + yi``; ``num_cells`` means out-of-grid."""
        xi, yi = self.cell_indices(x, y)
        if 0 <= xi < self.n and 0 <= yi < self.n:
            return xi * self.n + yi
        return self.num_cells

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

    def cell_name(self, flat: int) -> str:
        """The reference's string key of a flat cell: x then y index, 5
        digits each ("xxxxxyyyyy")."""
        xi, yi = divmod(int(flat), self.n)
        w = _CELL_INDEX_STR_LENGTH
        return f"{xi:0{w}d}{yi:0{w}d}"

    def cell_from_name(self, name: str) -> int:
        """The flat cell of a ``cell_name`` key."""
        w = _CELL_INDEX_STR_LENGTH
        return int(name[:w]) * self.n + int(name[w:])

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

    def bbox_cells(self, min_x: float, min_y: float, max_x: float,
                   max_y: float) -> np.ndarray:
        """All flat cells a bbox overlaps, clipped to the grid
        (HelperClass.java:122-143)."""
        x1, y1 = self.cell_indices(min_x, min_y)
        x2, y2 = self.cell_indices(max_x, max_y)
        x1, x2 = max(0, x1), min(self.n - 1, x2)
        y1, y2 = max(0, y1), min(self.n - 1, y2)
        if x1 > x2 or y1 > y2:
            return np.empty((0,), np.int32)
        xs = np.arange(x1, x2 + 1, dtype=np.int32)
        ys = np.arange(y1, y2 + 1, dtype=np.int32)
        return (xs[:, None] * self.n + ys[None, :]).reshape(-1)

    def guaranteed_layers(self, radius: float) -> int:
        """floor(r / (cell*sqrt(2)) - 1); UniformGrid.java:428-439."""
        return math.floor(radius / (self.cell_length * math.sqrt(2.0)) - 1)

    def _square(self, xi: int, yi: int, layers: int, out: np.ndarray,
                flag: np.uint8) -> None:
        """Mark the (2*layers+1)^2 square around (xi, yi), grid-clipped."""
        if layers < 0:
            return
        x1, x2 = max(0, xi - layers), min(self.n - 1, xi + layers)
        y1, y2 = max(0, yi - layers), min(self.n - 1, yi + layers)
        if x1 > x2 or y1 > y2:
            return
        view = out[: self.num_cells].reshape(self.n, self.n)
        view[x1: x2 + 1, y1: y2 + 1] = flag

    def neighbor_flags(self, radius: float,
                       query_cells: Iterable[int]) -> np.ndarray:
        """The (num_cells+1,) uint8 flag table of a query: the candidate
        squares around every query cell, then the guaranteed squares over
        them (guaranteed wins, UniformGrid.java:161-164). The last entry
        (out-of-grid) is always FLAG_NONE."""
        flags = np.zeros(self.num_cells + 1, np.uint8)
        lg = self.guaranteed_layers(radius)
        lc = self.candidate_layers(radius)
        cells = [c for c in query_cells if 0 <= c < self.num_cells]
        for c in cells:
            xi, yi = divmod(int(c), self.n)
            self._square(xi, yi, lc, flags, FLAG_CANDIDATE)
        for c in cells:
            xi, yi = divmod(int(c), self.n)
            self._square(xi, yi, lg, flags, FLAG_GUARANTEED)
        flags[self.num_cells] = FLAG_NONE
        return flags

    def neighbor_cells(self, radius: float, query_cells: Iterable[int],
                       guaranteed_only: bool = False) -> np.ndarray:
        """Flat ids of the guaranteed (or guaranteed and candidate)
        neighbour cells."""
        flags = self.neighbor_flags(radius, query_cells)
        if guaranteed_only:
            return np.nonzero(flags == FLAG_GUARANTEED)[0].astype(np.int32)
        return np.nonzero(flags != FLAG_NONE)[0].astype(np.int32)

    def __repr__(self) -> str:
        return (
            f"UniformGrid(n={self.n}, cell={self.cell_length:.6g}, "
            f"bbox=({self.min_x}, {self.min_y})..({self.max_x}, {self.max_y}))"
        )
