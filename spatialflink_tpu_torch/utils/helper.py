"""Query-set generation (the reference's HelperClass.generateQueryPolygons)."""

from __future__ import annotations

from typing import List

import numpy as np

from spatialflink_tpu_torch.models.objects import Polygon


def generate_query_polygons(num: int, min_x: float, min_y: float,
                            max_x: float, max_y: float, grid_size: int = 100,
                            seed: int = 0) -> List[Polygon]:
    """``num`` random axis-aligned rectangles inside a bbox, each a
    ``grid_size``-th of its spans, placed uniformly (HelperClass.java:
    387-439). The same numpy calls in the same order as the JAX package's
    ``utils/helper.py``, so a seed gives the same polygons."""
    rng = np.random.default_rng(seed)
    len_x = (max_x - min_x) / grid_size
    len_y = (max_y - min_y) / grid_size
    out = []
    for i in range(num):
        x0 = rng.uniform(min_x, max_x - len_x)
        y0 = rng.uniform(min_y, max_y - len_y)
        ring = np.array([[x0, y0], [x0 + len_x, y0], [x0 + len_x, y0 + len_y],
                         [x0, y0 + len_y], [x0, y0]])
        out.append(Polygon(obj_id=f"qpoly{i}", rings=[ring]))
    return out
