"""Grid-partitioned placement: the host-side partition planner, the
port's own copy of the JAX package's ``parallel/partition.py``.

The reference scales out by hashing grid-cell keys across Flink
key-groups (``keyBy(gridID)``, StreamingJob.java:177): neighbouring cells
land on arbitrary workers, so every neighbour-cell probe is a network
shuffle. Here placement follows the grid instead: each shard owns a
contiguous range of flat cell ids (cells sorted by grid index, balanced
by live occupancy), so a query's candidate square (every cell within
Chebyshev distance L_c of its own cell) maps to a bounded range of flat
positions::

    flat = xi * n + yi      =>      |dflat| <= L * (n + 1)   when  cheb <= L

That bound is the halo width ``H = L_c * (n + 1)``: a shard owning flat
cells ``[lo, hi)`` answers every one of its probes from its own rows
plus its neighbours' boundary rows in ``[lo - H, lo)`` and
``[hi, hi + H)``. Neighbour-cell probes become a fixed-shape exchange of
boundary-cell pane lanes between adjacent shards (``parallel/halo.py``)
instead of a replication of the whole window state.

Single-hop contract: the halo reaches only adjacent shards, so every
shard's cell range spans at least ``H`` flat positions;
``plan_partition`` enforces it (clamping occupancy-skewed cuts, raising
when the grid is too small for the shard count at this radius).

Everything here is host-side numpy, so ``checkpoint.py`` restores a
serialised plan without touching a device. A plan serialises to the
same dict as the JAX package's (``PLAN_VERSION``, the keys, the error
texts), so a JAX checkpoint's plan restores here.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional

import numpy as np

PLAN_VERSION = 1

_PLAN_KEYS = frozenset({
    "version", "n_shards", "grid_n", "num_cells", "layers",
    "guaranteed", "halo", "bounds",
})


def halo_width(grid_n: int, layers: int) -> int:
    """Flat-position halo width for a Chebyshev layer count:
    ``cheb(a, b) ≤ L  ⇒  |flat(a) − flat(b)| ≤ L·(n+1)``."""
    return max(int(layers), 0) * (int(grid_n) + 1)


@dataclass(frozen=True, eq=False)
class PartitionPlan:
    """Contiguous flat-cell ranges per shard.

    ``bounds`` is ``(n_shards + 1,)`` int64 with ``bounds[0] == 0`` and
    ``bounds[-1] == num_cells``: shard ``s`` owns flat cells
    ``[bounds[s], bounds[s+1])``. The out-of-grid sentinel cell
    (``num_cells``) is assigned to the LAST shard — its rows never probe
    (pair activity requires both cells in-grid), they just need a home.

    ``layers``/``guaranteed`` are the candidate / guaranteed Chebyshev
    layer counts the plan was built for (grid.py layer math); ``halo``
    is the derived flat-position width.
    """

    n_shards: int
    grid_n: int
    num_cells: int
    layers: int
    guaranteed: int
    halo: int
    bounds: np.ndarray

    def shard_of(self, cells: np.ndarray) -> np.ndarray:
        """Owning shard per flat cell id (out-of-grid → last shard)."""
        cells = np.asarray(cells)
        return np.searchsorted(
            self.bounds[1:-1], cells, side="right"
        ).astype(np.int32)

    def shard_widths(self) -> np.ndarray:
        return np.diff(self.bounds)

    def to_dict(self) -> Dict[str, Any]:
        return {
            "version": PLAN_VERSION,
            "n_shards": int(self.n_shards),
            "grid_n": int(self.grid_n),
            "num_cells": int(self.num_cells),
            "layers": int(self.layers),
            "guaranteed": int(self.guaranteed),
            "halo": int(self.halo),
            "bounds": [int(b) for b in self.bounds],
        }

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "PartitionPlan":
        if not isinstance(d, dict):
            raise ValueError(
                f"partition plan must be a dict, got {type(d).__name__}"
            )
        unknown = sorted(set(d) - _PLAN_KEYS)
        if unknown:
            raise ValueError(f"partition plan has unknown keys {unknown}")
        missing = sorted(_PLAN_KEYS - set(d))
        if missing:
            raise ValueError(f"partition plan is missing keys {missing}")
        if int(d["version"]) != PLAN_VERSION:
            raise ValueError(
                f"partition plan version {d['version']} != {PLAN_VERSION}"
            )
        bounds = np.asarray(d["bounds"], np.int64)
        n_shards = int(d["n_shards"])
        num_cells = int(d["num_cells"])
        if bounds.shape != (n_shards + 1,):
            raise ValueError(
                f"partition plan bounds shape {bounds.shape} does not "
                f"match n_shards={n_shards}"
            )
        if bounds[0] != 0 or bounds[-1] != num_cells \
                or np.any(np.diff(bounds) < 0):
            raise ValueError("partition plan bounds are not a monotone "
                             "cover of [0, num_cells]")
        return cls(
            n_shards=n_shards,
            grid_n=int(d["grid_n"]),
            num_cells=num_cells,
            layers=int(d["layers"]),
            guaranteed=int(d["guaranteed"]),
            halo=int(d["halo"]),
            bounds=bounds,
        )


def plan_partition(
    grid,
    n_shards: int,
    radius: float,
    occupancy: Optional[np.ndarray] = None,
) -> PartitionPlan:
    """Assign contiguous flat-cell ranges to shards.

    Cells are already sorted by grid index (flat id); cuts balance
    *cumulative live occupancy* (per-cell live counts from the
    compaction planner's view of the window; uniform when ``None``).
    Cuts are then clamped so every shard spans at least the halo width —
    the single-hop halo-exchange contract.
    """
    n_shards = int(n_shards)
    if n_shards < 1:
        raise ValueError("n_shards must be >= 1")
    lc = grid.candidate_layers(radius)
    lg = grid.guaranteed_layers(radius)
    halo = halo_width(grid.n, lc)
    num_cells = grid.num_cells
    min_width = max(halo, 1)
    if n_shards * min_width > num_cells:
        raise ValueError(
            f"grid of {num_cells} cells cannot give {n_shards} shard(s) "
            f"a minimum width of {min_width} (halo for radius {radius!r})"
            f" — use a finer grid or fewer shards"
        )
    if occupancy is None:
        weights = np.ones(num_cells, np.float64)
    else:
        # Accepts (num_cells,) or (num_cells + 1,) — the compaction
        # planner's live counts include the out-of-grid sentinel bucket,
        # which carries no placement weight.
        weights = np.zeros(num_cells, np.float64)
        occ = np.asarray(occupancy, np.float64).reshape(-1)
        k = min(occ.shape[0], num_cells)
        weights[:k] = occ[:k]
    csum = np.cumsum(weights)
    total = float(csum[-1]) if csum.size else 0.0
    if total <= 0:
        cuts = np.linspace(0, num_cells, n_shards + 1)[1:-1]
        cuts = np.round(cuts).astype(np.int64)
    else:
        targets = total * np.arange(1, n_shards, dtype=np.float64) / n_shards
        cuts = (np.searchsorted(csum, targets, side="left") + 1).astype(
            np.int64
        )
    bounds = np.empty(n_shards + 1, np.int64)
    bounds[0] = 0
    bounds[1:-1] = cuts
    bounds[-1] = num_cells
    # Forward then backward clamp: every shard keeps >= min_width cells,
    # so occupancy skew can narrow a shard only down to the halo width.
    for s in range(1, n_shards):
        bounds[s] = max(bounds[s], bounds[s - 1] + min_width)
    for s in range(n_shards - 1, 0, -1):
        bounds[s] = min(bounds[s], bounds[s + 1] - min_width)
    return PartitionPlan(
        n_shards=n_shards,
        grid_n=int(grid.n),
        num_cells=int(num_cells),
        layers=int(lc),
        guaranteed=int(lg),
        halo=int(halo),
        bounds=bounds,
    )


@dataclass(frozen=True, eq=False)
class ShardLayout:
    """Host index maps for one partitioned window.

    ``own``: (n_shards, cap) int64 original-row indices per shard (−1
    padding); ``left``/``right``: (n_shards, halo_cap) boundary-pane
    rows — ``left[s]`` are shard ``s``'s rows within the halo of its
    LEFT edge (shipped to ``s−1``), ``right[s]`` within its RIGHT edge
    (shipped to ``s+1``). Capacities ride ``pick_capacity`` rungs so
    shard-count and occupancy churn stay on the ladder.
    """

    plan: PartitionPlan
    cap: int
    halo_cap: int
    own: np.ndarray
    left: np.ndarray
    right: np.ndarray
    counts: np.ndarray

    @property
    def live_boundary_rows(self) -> int:
        """Unpadded boundary-pane rows — the true boundary-state lanes
        the halo exchange exists to ship (replication-ratio
        denominator)."""
        return int((self.left >= 0).sum() + (self.right >= 0).sum())


def _index_map(rows_per_shard, n_shards: int, cap: int) -> np.ndarray:
    out = np.full((n_shards, cap), -1, np.int64)
    for s, rows in enumerate(rows_per_shard):
        out[s, : rows.shape[0]] = rows
    return out


def shard_layout(
    plan: PartitionPlan, cells: np.ndarray, valid: np.ndarray
) -> ShardLayout:
    """Partition one window's live rows by owning shard and extract the
    boundary panes. Original row order is preserved within each shard
    (stable), so the layout — and everything scattered back through it —
    is replay-deterministic."""
    from spatialflink_tpu_torch.ops.compaction import pick_capacity

    cells = np.asarray(cells)
    live = np.asarray(valid, bool)
    n = cells.shape[0]
    idx = np.nonzero(live)[0]
    shard = plan.shard_of(cells[idx])
    order = np.argsort(shard, kind="stable")
    sidx = idx[order]
    scell = cells[idx][order]
    counts = np.bincount(shard, minlength=plan.n_shards)
    starts = np.concatenate([[0], np.cumsum(counts)])
    own_rows, left_rows, right_rows = [], [], []
    for s in range(plan.n_shards):
        rows = sidx[starts[s]: starts[s + 1]]
        rcell = scell[starts[s]: starts[s + 1]]
        own_rows.append(rows)
        left_rows.append(rows[rcell < plan.bounds[s] + plan.halo])
        right_rows.append(rows[rcell >= plan.bounds[s + 1] - plan.halo])
    cap_top = max(n, 1)
    cap = pick_capacity(max(int(counts.max()) if counts.size else 1, 1),
                        cap_top)
    hmax = max(
        [max(int(lr.shape[0]), int(rr.shape[0]))
         for lr, rr in zip(left_rows, right_rows)] + [1]
    )
    halo_cap = pick_capacity(hmax, cap_top)
    return ShardLayout(
        plan=plan,
        cap=int(cap),
        halo_cap=int(halo_cap),
        own=_index_map(own_rows, plan.n_shards, int(cap)),
        left=_index_map(left_rows, plan.n_shards, int(halo_cap)),
        right=_index_map(right_rows, plan.n_shards, int(halo_cap)),
        counts=counts,
    )


def gather_rows(index_map: np.ndarray, arr: np.ndarray, fill) -> np.ndarray:
    """(n_shards, cap) index map + (N, …) array → (n_shards, cap, …)
    per-shard stack; −1 padding lanes take ``fill``."""
    arr = np.asarray(arr)
    safe = np.maximum(index_map, 0)
    out = arr[safe].copy()
    out[index_map < 0] = fill
    return out


def scatter_rows(
    index_map: np.ndarray, values: np.ndarray, n_rows: int, fill
) -> np.ndarray:
    """Inverse of :func:`gather_rows`: per-shard (n_shards, cap, …)
    outputs → (n_rows, …) in original row order (unassigned rows take
    ``fill``)."""
    values = np.asarray(values)
    out = np.full((n_rows,) + values.shape[2:], fill, values.dtype)
    m = index_map >= 0
    out[index_map[m]] = values[m]
    return out
