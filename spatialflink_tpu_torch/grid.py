"""UniformGrid: the grid extent the wire format and operators read.

This slice needs only the constructor and the bounding box: the wire
format quantizes against the extent, and the wire-kNN path has no cell
pruning (the radius test alone decides membership). The neighbour-cell
flag machinery of the JAX package's ``grid.py`` comes with the range
operators.
"""

from __future__ import annotations


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
