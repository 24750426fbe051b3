"""Point and geometry batches: the host-side structure-of-arrays a window
ships.

A window's points become one padded batch (``utils/padding.py`` buckets)
of float64 coordinates, timestamps, interned ids, a validity mask and,
after ``with_cells``, flat grid cells. Padding lanes are invalid and sit
in the out-of-grid cell, so they never join. A window of polygons or
linestrings becomes a ``GeometryBatch``: per-object packed boundaries
(``ops/polygon.py``'s layout) and bboxes, built from objects or, with no
per-object Python, from ragged SoA arrays. Host numpy throughout, as the
JAX package's ``models/batch.py``.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Optional, Sequence

import numpy as np

from spatialflink_tpu_torch.grid import UniformGrid
from spatialflink_tpu_torch.models.objects import LineString, Point, Polygon
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


def flag_prefix_planes(grid: UniformGrid, flags: np.ndarray):
    """2-D prefix sums of the candidate/guaranteed indicator planes
    (zero-bordered: P[i, j] = count in [0:i, 0:j)). Build once per query;
    feed to GeometryBatch.any_cell_flagged per window."""
    n = grid.n
    plane = flags[: grid.num_cells].reshape(n, n)
    cand = np.zeros((n + 1, n + 1), np.int64)
    guar = np.zeros((n + 1, n + 1), np.int64)
    cand[1:, 1:] = np.cumsum(np.cumsum(plane == 1, axis=0), axis=1)
    guar[1:, 1:] = np.cumsum(np.cumsum(plane == 2, axis=0), axis=1)
    return cand, guar


@dataclass
class GeometryBatch:
    """Padded geometry batch: per-object packed boundary arrays.

    ``verts``: (N, V, 2); ``edge_valid``: (N, V-1); plus ts/oid/valid and a
    representative bbox per object (for cell assignment & bbox pruning).
    """

    verts: np.ndarray
    edge_valid: np.ndarray
    bbox: np.ndarray  # (N, 4) minx,miny,maxx,maxy
    ts: np.ndarray
    oid: np.ndarray
    valid: np.ndarray

    @property
    def capacity(self) -> int:
        return self.verts.shape[0]

    @classmethod
    def from_ragged(
        cls,
        ts: np.ndarray,
        oid: np.ndarray,
        lengths: np.ndarray,
        verts_flat: np.ndarray,
        edge_valid_flat: Optional[np.ndarray] = None,
        bucket: Optional[int] = None,
        vert_bucket: Optional[int] = None,
        dtype=np.float64,
    ) -> "GeometryBatch":
        """Vectorized batch build from ragged SoA arrays — the geometry
        analog of the point SoA fast path: no per-object Python.

        ``lengths[i]`` vertices of object ``i`` occupy the corresponding
        run of ``verts_flat`` as one PACKED boundary chain (closed rings
        for polygons — ``pack_rings``' contract — open for polylines).
        ``edge_valid_flat``: optional flat per-object (length−1)-run edge
        mask — REQUIRED for multi-ring chains (ring seam edges invalid,
        pack_rings' layout; the native WKT parser emits it); omitted, all
        within-chain edges are valid (single-chain objects).
        ``oid`` must already be dense int32.
        """
        n = len(ts)
        lengths = np.asarray(lengths, np.int64)
        if n and int(lengths.min()) < 2:
            raise ValueError(
                "from_ragged requires every chain length >= 2 (a zero-"
                "length run would corrupt the reduceat bboxes silently)"
            )
        verts_flat = np.asarray(verts_flat, np.float64)
        offsets = np.concatenate([[0], np.cumsum(lengths)])
        total = int(offsets[-1])
        vmax = int(lengths.max()) if n else 2
        if vert_bucket is not None and vert_bucket < vmax:
            raise ValueError(
                f"vert_bucket {vert_bucket} < longest chain {vmax}: chains "
                "would be silently truncated"
            )
        v = vert_bucket if vert_bucket is not None else next_bucket(
            max(vmax, 2), minimum=8)

        lane = np.arange(v)
        gather = np.minimum(offsets[:-1, None] + lane[None, :],
                            max(total - 1, 0))
        mask = lane[None, :] < lengths[:, None]  # (n, v)
        verts = np.where(
            mask[:, :, None], verts_flat[gather], 0.0
        ).astype(dtype)
        if edge_valid_flat is None:
            ev = lane[None, : v - 1] < (lengths - 1)[:, None]
        else:
            edge_valid_flat = np.asarray(edge_valid_flat, bool)
            e_lens = lengths - 1
            if int(e_lens.sum()) != len(edge_valid_flat):
                raise ValueError(
                    f"edge mask has {len(edge_valid_flat)} entries; "
                    f"lengths-1 sums to {int(e_lens.sum())}"
                )
            e_off = np.concatenate([[0], np.cumsum(e_lens)])
            e_total = int(e_off[-1])
            e_gather = np.minimum(e_off[:-1, None] + lane[None, : v - 1],
                                  max(e_total - 1, 0))
            in_run = lane[None, : v - 1] < e_lens[:, None]
            src = (edge_valid_flat[e_gather] if e_total
                   else np.zeros((n, v - 1), bool))
            ev = in_run & src

        # Per-object bbox via ragged reduceat (empty-safe: n>0 runs only).
        if n:
            red_idx = offsets[:-1]
            mins = np.minimum.reduceat(verts_flat, red_idx, axis=0)
            maxs = np.maximum.reduceat(verts_flat, red_idx, axis=0)
            boxes = np.concatenate([mins, maxs], axis=1).astype(dtype)
        else:
            boxes = np.zeros((0, 4), dtype)

        b = bucket if bucket is not None else next_bucket(n, minimum=8)
        return cls(
            verts=pad_to_bucket(verts, b),
            edge_valid=pad_to_bucket(ev, b, fill=False),
            bbox=pad_to_bucket(boxes, b),
            ts=pad_to_bucket(np.asarray(ts, np.int64), b),
            oid=pad_to_bucket(np.asarray(oid, np.int32), b),
            valid=pad_to_bucket(np.ones(n, bool), b, fill=False),
        )

    @classmethod
    def from_objects(
        cls,
        objs: Sequence[Polygon | LineString],
        interner: Optional[Interner] = None,
        bucket: Optional[int] = None,
        vert_bucket: Optional[int] = None,
        dtype=np.float64,
    ) -> "GeometryBatch":
        n = len(objs)
        vmax = max((o.num_vertices_packed() for o in objs), default=2)
        v = vert_bucket if vert_bucket is not None else next_bucket(vmax, minimum=8)
        verts = np.zeros((n, v, 2), dtype)
        ev = np.zeros((n, v - 1), bool)
        boxes = np.zeros((n, 4), dtype)
        for i, o in enumerate(objs):
            pv, pe = o.packed(pad_to=v)
            verts[i] = pv
            ev[i] = pe
            boxes[i] = o.bbox()
        ts = np.array([o.timestamp for o in objs], np.int64)
        if interner is not None:
            oid = interner.intern_many(o.obj_id for o in objs)
        else:
            oid = np.zeros(n, np.int32)
        b = bucket if bucket is not None else next_bucket(n, minimum=8)
        return cls(
            verts=pad_to_bucket(verts, b),
            edge_valid=pad_to_bucket(ev, b, fill=False),
            bbox=pad_to_bucket(boxes, b),
            ts=pad_to_bucket(ts, b),
            oid=pad_to_bucket(oid, b),
            valid=pad_to_bucket(np.ones(n, bool), b, fill=False),
        )

    def centroid_cells(self, grid: UniformGrid) -> np.ndarray:
        """Flat cell of each object's bbox center (its keyBy cell).

        The reference keys replicated polygons by each overlapped cell; for
        batched pruning we flag *all* cells of each object via
        ``grid.bbox_cells`` host-side instead (operator layer).
        """
        cx = (self.bbox[:, 0] + self.bbox[:, 2]) / 2
        cy = (self.bbox[:, 1] + self.bbox[:, 3]) / 2
        cell = grid.assign_cells_np(np.stack([cx, cy], axis=1))
        return np.where(self.valid, cell, grid.num_cells).astype(np.int32)

    def any_cell_flagged(
        self, grid: UniformGrid, flags: np.ndarray, prefix=None
    ) -> np.ndarray:
        """Per-object max flag over all cells its bbox overlaps (host-side,
        vectorized).

        Mirrors the reference's per-object gridIDsSet ∩ neighbor-set test
        for polygon/linestring streams (e.g. PolygonPointRangeQuery filter).
        The rectangle max over the flag grid is answered with 2-D prefix
        sums of the candidate/guaranteed indicator planes: a flag level is
        present in a bbox iff its indicator count over the rectangle is
        positive — O(cells + objects) instead of per-object cell loops.
        Pass ``prefix=flag_prefix_planes(grid, flags)`` to amortize the
        O(cells) plane build across windows of the same query.
        """
        n = grid.n
        cand, guar = prefix if prefix is not None else flag_prefix_planes(grid, flags)

        ci = grid.cell_xy_indices_np(self.bbox[:, 0:2])  # (N, 2) min corner
        cj = grid.cell_xy_indices_np(self.bbox[:, 2:4])  # (N, 2) max corner
        x1 = np.clip(ci[:, 0], 0, n - 1)
        y1 = np.clip(ci[:, 1], 0, n - 1)
        x2 = np.clip(cj[:, 0], 0, n - 1)
        y2 = np.clip(cj[:, 1], 0, n - 1)
        # Bboxes entirely outside the grid contribute nothing.
        inside = (cj[:, 0] >= 0) & (cj[:, 1] >= 0) & (ci[:, 0] < n) & (ci[:, 1] < n)

        def rect_count(p):
            return (
                p[x2 + 1, y2 + 1] - p[x1, y2 + 1] - p[x2 + 1, y1] + p[x1, y1]
            )

        has_guar = rect_count(guar) > 0
        has_cand = rect_count(cand) > 0
        out = np.where(has_guar, 2, np.where(has_cand, 1, 0)).astype(np.uint8)
        return np.where(self.valid & inside, out, 0).astype(np.uint8)
