"""Spatial object model: the ``Point`` a kNN query is asked about.

Thin host-side records, as in the JAX package's ``models/objects.py``;
computation happens on tensors. The other geometries come with the
operators that take them.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional


@dataclass
class SpatialObject:
    """Base: objID + event timestamp (ms)."""

    obj_id: Optional[str] = None
    timestamp: int = 0  # epoch millis


@dataclass
class Point(SpatialObject):
    """A 2-D point."""

    x: float = 0.0
    y: float = 0.0
