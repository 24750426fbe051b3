"""Spatial object model: points, polygons, linestrings, their multi forms
and geometry collections.

Thin host-side records, as in the JAX package's ``models/objects.py``;
computation happens on tensors. A geometry's grid cells are those its
bbox overlaps (the reference's gridIDsSet, Polygon.java:16-22), computed
against a ``UniformGrid`` on demand; ``packed`` gives its boundary in the
layout of ``ops/polygon.py``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple

import numpy as np

from spatialflink_tpu_torch.ops.polygon import pack_polyline, pack_rings


@dataclass
class SpatialObject:
    """Base: objID + event timestamp (ms)."""

    obj_id: Optional[str] = None
    timestamp: int = 0  # epoch millis
    ingestion_time: Optional[float] = None  # host wall time at ingest (s)


@dataclass
class Point(SpatialObject):
    """A 2-D point."""

    x: float = 0.0
    y: float = 0.0

    @property
    def coords(self) -> np.ndarray:
        return np.array([self.x, self.y], np.float64)

    def grid_cell(self, grid) -> int:
        return grid.flat_cell(self.x, self.y)

    def grid_cells(self, grid) -> List[int]:
        return [self.grid_cell(grid)]

    def bbox(self) -> Tuple[float, float, float, float]:
        return (self.x, self.y, self.x, self.y)


def _bbox_of(arrays: Sequence[np.ndarray]
             ) -> Tuple[float, float, float, float]:
    allv = np.concatenate([np.asarray(a, np.float64) for a in arrays], axis=0)
    return (float(allv[:, 0].min()), float(allv[:, 1].min()),
            float(allv[:, 0].max()), float(allv[:, 1].max()))


@dataclass
class Polygon(SpatialObject):
    """Polygon with optional holes: ``rings[0]`` is the exterior
    (Polygon.java:26-100). Its bbox, and so its grid cells, come from the
    exterior ring (HelperClass.java:122-143)."""

    rings: List[np.ndarray] = field(default_factory=list)

    def __post_init__(self):
        self.rings = [np.asarray(r, np.float64) for r in self.rings]

    def bbox(self) -> Tuple[float, float, float, float]:
        return _bbox_of(self.rings[:1])

    def grid_cells(self, grid) -> List[int]:
        return grid.bbox_cells(*self.bbox()).tolist()

    def packed(self, pad_to: Optional[int] = None):
        return pack_rings(self.rings, pad_to=pad_to)

    @property
    def exterior(self) -> np.ndarray:
        return self.rings[0]

    def num_vertices_packed(self) -> int:
        return sum(len(r) + (0 if np.array_equal(r[0], r[-1]) else 1)
                   for r in self.rings)


@dataclass
class LineString(SpatialObject):
    """Open polyline (LineString.java:24-113)."""

    coords: np.ndarray = field(default_factory=lambda: np.zeros((0, 2)))

    def __post_init__(self):
        self.coords = np.asarray(self.coords, np.float64)

    def bbox(self) -> Tuple[float, float, float, float]:
        return _bbox_of([self.coords])

    def grid_cells(self, grid) -> List[int]:
        return grid.bbox_cells(*self.bbox()).tolist()

    def packed(self, pad_to: Optional[int] = None):
        return pack_polyline([self.coords], pad_to=pad_to)

    def num_vertices_packed(self) -> int:
        return len(self.coords)


@dataclass
class MultiPoint(SpatialObject):
    """Standalone point set (MultiPoint.java:14)."""

    coords: np.ndarray = field(default_factory=lambda: np.zeros((0, 2)))

    def __post_init__(self):
        self.coords = np.asarray(self.coords, np.float64)

    def bbox(self) -> Tuple[float, float, float, float]:
        return _bbox_of([self.coords])

    def grid_cells(self, grid) -> List[int]:
        return grid.bbox_cells(*self.bbox()).tolist()


@dataclass
class MultiPolygon(Polygon):
    """Polygons as one ring list (MultiPolygon.java:13 extends Polygon):
    ``rings`` holds every member's rings, ``parts`` the ring count of each
    member. Its bbox spans the members' exterior rings."""

    parts: List[int] = field(default_factory=list)

    @classmethod
    def from_polygons(cls, polys: Sequence[Sequence[np.ndarray]], **kw):
        rings: List[np.ndarray] = []
        parts = []
        for p in polys:
            parts.append(len(p))
            rings.extend(np.asarray(r, np.float64) for r in p)
        return cls(rings=rings, parts=parts, **kw)

    def bbox(self) -> Tuple[float, float, float, float]:
        ext, i = [], 0
        for n in self.parts or [len(self.rings)]:
            ext.append(self.rings[i])
            i += n
        return _bbox_of(ext)

    def polygons(self) -> List[Polygon]:
        """The members as ``Polygon``s, each with this object's id and
        timestamp."""
        out, i = [], 0
        for n in self.parts or [len(self.rings)]:
            out.append(Polygon(obj_id=self.obj_id, timestamp=self.timestamp,
                               rings=self.rings[i:i + n]))
            i += n
        return out


@dataclass
class MultiLineString(LineString):
    """Several polylines (MultiLineString.java:14 extends LineString)."""

    parts: List[np.ndarray] = field(default_factory=list)

    def __post_init__(self):
        self.parts = [np.asarray(p, np.float64) for p in self.parts]
        if len(self.parts) and self.coords.size == 0:
            self.coords = np.concatenate(self.parts, axis=0)
        super().__post_init__()

    def bbox(self) -> Tuple[float, float, float, float]:
        return _bbox_of(self.parts or [self.coords])

    def packed(self, pad_to: Optional[int] = None):
        return pack_polyline(self.parts or [self.coords], pad_to=pad_to)


@dataclass
class GeometryCollection(SpatialObject):
    """Heterogeneous geometry list (GeometryCollection.java:13)."""

    geometries: List[SpatialObject] = field(default_factory=list)

    def bbox(self) -> Tuple[float, float, float, float]:
        boxes = [g.bbox() for g in self.geometries]
        return (min(b[0] for b in boxes), min(b[1] for b in boxes),
                max(b[2] for b in boxes), max(b[3] for b in boxes))

    def grid_cells(self, grid) -> List[int]:
        cells: set = set()
        for g in self.geometries:
            cells.update(g.grid_cells(grid))
        return sorted(cells)
