"""Kernel-level op counters and a throughput meter.

The analog of the reference's per-operator Flink metrics: the
distance-computation counter (spatialObjects/Point.java:220-235) and the
Dropwizard throughput meters (Point.java:237-253), for the batched
execution model: the operators report per-window tallies computed from
HOST arrays (flag tables, cell ids, validity) instead of counting inside
a kernel, so a tally never copies from the card or waits for it.

Disabled by default, and every hook sits behind ``if counters.enabled``,
so the hot path pays nothing; ``enable()`` turns it on. The NES reporter
(``mn/reporter.py``) appends ``dist_comp_total`` to its METRICS lines
while enabled, and ``sncb/metrics.py:MetricsSink`` can emit a distComp
column.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict

import numpy as np


@dataclass
class KernelCounters:
    enabled: bool = False
    windows: int = 0
    points_in: int = 0
    candidate_lanes: int = 0  # lanes surviving the grid prune
    dist_computations: int = 0  # distance evaluations issued to the kernel
    started_at: float = field(default_factory=time.time)

    def record_window(self, points: int, candidates: int, dist_comps: int):
        if not self.enabled:
            return
        self.windows += 1
        self.points_in += int(points)
        self.candidate_lanes += int(candidates)
        self.dist_computations += int(dist_comps)

    def record_candidates(self, candidates: int, dist_comps: int):
        """Candidate/dist tallies reported separately from window/point
        counts (the SoA assembler owns the latter — see
        operators.base.soa_point_batches)."""
        if not self.enabled:
            return
        self.candidate_lanes += int(candidates)
        self.dist_computations += int(dist_comps)

    def throughput_eps(self, now: float | None = None) -> float:
        elapsed = max((now if now is not None else time.time()) - self.started_at, 1e-9)
        return self.points_in / elapsed

    def snapshot(self) -> Dict[str, float]:
        from spatialflink_tpu_torch.mn.metrics import json_safe

        # json_safe at the boundary: tallies may arrive as numpy ints and
        # json.dumps of a snapshot must never raise.
        return json_safe({
            "windows": self.windows,
            "points_in": self.points_in,
            "candidate_lanes": self.candidate_lanes,
            "dist_computations": self.dist_computations,
            "throughput_eps": round(self.throughput_eps(), 2),
        })

    def reset(self):
        self.windows = 0
        self.points_in = 0
        self.candidate_lanes = 0
        self.dist_computations = 0
        self.started_at = time.time()


counters = KernelCounters()


def enable():
    counters.reset()
    counters.enabled = True


def disable():
    counters.enabled = False


def count_candidates(flags: np.ndarray, cells: np.ndarray, n: int) -> int:
    """Points whose cell flag is nonzero — the lanes the fused kernels
    evaluate distances for (everything else is masked by the prune)."""
    return int(np.count_nonzero(flags[np.minimum(cells[:n], len(flags) - 1)] > 0))


def count_join_candidates(
    grid, left_cells: np.ndarray, n_left: int, right_cells: np.ndarray,
    n_right: int, layers: int,
) -> int:
    """Exact candidate PAIR count of a grid-hash join window: for each
    in-grid left point, the number of in-grid right points in its
    (2·layers+1)² neighbor square — via a 2-D box-sum (integral image) over
    the right-side cell histogram, O(cells + n). This is what the
    reference's replicate+equi-join would enumerate (JoinQuery.java:73-137)
    and what the dense-bucket kernels evaluate (before per-cell caps)."""
    g = grid.n
    lc = left_cells[:n_left]
    rc = right_cells[:n_right]
    lc = lc[lc < grid.num_cells]
    rc = rc[rc < grid.num_cells]
    if not len(lc) or not len(rc):
        return 0
    hist = np.bincount(rc, minlength=grid.num_cells).reshape(g, g)
    integral = np.zeros((g + 1, g + 1), np.int64)
    integral[1:, 1:] = hist.cumsum(0).cumsum(1)

    xi, yi = np.divmod(lc, g)
    x1 = np.clip(xi - layers, 0, g)
    x2 = np.clip(xi + layers + 1, 0, g)
    y1 = np.clip(yi - layers, 0, g)
    y2 = np.clip(yi + layers + 1, 0, g)
    box = (
        integral[x2, y2] - integral[x1, y2] - integral[x2, y1]
        + integral[x1, y1]
    )
    return int(box.sum())
