"""Point batches: the host-side structure-of-arrays a window ships.

A window's points become one padded batch (``utils/padding.py`` buckets)
of float64 coordinates, timestamps, interned ids, a validity mask and,
after ``with_cells``, flat grid cells. Padding lanes are invalid and sit
in the out-of-grid cell, so they never join.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Optional, Sequence

import numpy as np

from spatialflink_tpu_torch.grid import UniformGrid
from spatialflink_tpu_torch.models.objects import Point
from spatialflink_tpu_torch.utils.interning import Interner
from spatialflink_tpu_torch.utils.padding import next_bucket, pad_to_bucket


@dataclass
class PointBatch:
    """Padded point batch: xy (N,2), ts (N,), oid (N,), valid (N,), cell (N,)."""

    xy: np.ndarray
    ts: np.ndarray
    oid: np.ndarray
    valid: np.ndarray
    cell: Optional[np.ndarray] = None

    @property
    def capacity(self) -> int:
        return self.xy.shape[0]

    @property
    def count(self) -> int:
        return int(self.valid.sum())

    @classmethod
    def from_arrays(
        cls,
        xy: np.ndarray,
        ts: Optional[np.ndarray] = None,
        oid: Optional[np.ndarray] = None,
        bucket: Optional[int] = None,
        dtype=np.float64,
    ) -> "PointBatch":
        xy = np.asarray(xy, dtype).reshape(-1, 2)
        n = len(xy)
        ts = np.zeros(n, np.int64) if ts is None else np.asarray(ts, np.int64)
        oid = np.zeros(n, np.int32) if oid is None else np.asarray(oid, np.int32)
        b = bucket if bucket is not None else next_bucket(n)
        return cls(
            xy=pad_to_bucket(xy, b),
            ts=pad_to_bucket(ts, b),
            oid=pad_to_bucket(oid, b, fill=0),
            valid=pad_to_bucket(np.ones(n, bool), b, fill=False),
        )

    @classmethod
    def from_points(
        cls,
        points: Sequence[Point],
        interner: Optional[Interner] = None,
        bucket: Optional[int] = None,
        dtype=np.float64,
    ) -> "PointBatch":
        n = len(points)
        xy = np.array([[p.x, p.y] for p in points], dtype).reshape(n, 2)
        ts = np.array([p.timestamp for p in points], np.int64)
        if interner is not None:
            oid = interner.intern_many(p.obj_id for p in points)
        else:
            oid = np.zeros(n, np.int32)
        return cls.from_arrays(xy, ts, oid, bucket=bucket, dtype=dtype)

    def with_cells(self, grid: UniformGrid) -> "PointBatch":
        cell = grid.assign_cells_np(self.xy)
        # Padding lanes → out-of-grid, so they never join.
        cell = np.where(self.valid, cell, grid.num_cells).astype(np.int32)
        return replace(self, cell=cell)
