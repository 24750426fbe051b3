"""Capacity buckets chosen on the host for fixed-shape device programs.

- ``wire_pane_bucket``: a pane of n points is padded to
  ``wire_pane_bucket(n)`` lanes, and the kernels mask lanes past n
  (``n_valid``). Variable pane sizes therefore share a few buffer shapes.
- ``capacity_ladder``, ``pick_capacity``, ``max_window_cell_count``: the
  live-slot probe capacity ``cap_c`` of the pane-carry tJoin
  (``ops/tjoin_panes.py``). The ring planes hold ``cap_w`` slots a cell,
  live and expired; the compacted probe reads only ``cap_c`` lanes from
  each neighbour cell's head, so the host reads the stream's exact
  per-cell window occupancy and picks the smallest rung of a short
  power-of-two ladder that holds it. The device's ``cmp_overflow``
  counter catches a rung that was too small.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from spatialflink_tpu_torch.utils.padding import next_bucket

#: Wire-kNN panes bucket at this floor (the JAX package's value, so both
#: packages pad a pane to the same capacity).
PANE_BUCKET_MIN = 128

#: Smallest probe capacity the ladder offers (the JAX package's value).
CAP_LADDER_MIN = 8


def wire_pane_bucket(n: int, minimum: int = PANE_BUCKET_MIN) -> int:
    """Bucketed wire-pane capacity (power-of-two ladder above
    ``minimum``), the pick recorded per bucket in telemetry (occupancy
    drift between panes shows up there as bucket churn)."""
    from spatialflink_tpu_torch.telemetry import telemetry

    b = int(next_bucket(max(int(n), 1), minimum=minimum))
    telemetry.record_compaction("wire_pane_digest", b, int(n))
    return b


def capacity_ladder(cap: int, minimum: int = CAP_LADDER_MIN
                    ) -> Tuple[int, ...]:
    """Powers of two from ``minimum`` below ``cap``, then ``cap`` itself
    (a power of two or not), so the full ring row is always the top rung:
    cap_w = 64 → (8, 16, 32, 64); a ``cap`` below ``minimum`` → (cap,)."""
    if cap < minimum:
        return (cap,)
    out = []
    b = minimum
    while b < cap:
        out.append(b)
        b <<= 1
    out.append(cap)
    return tuple(out)


def pick_capacity(live: int, cap: int, minimum: int = CAP_LADDER_MIN) -> int:
    """The smallest ladder rung at or above ``live``; ``cap`` when
    ``live`` is beyond the ladder (the ring holds at most ``cap`` live
    points a cell anyway: the ``cap_overflow`` retry's contract).

    Under an active overload ``clamp_compaction`` rung (``overload.py``)
    the pick is floored at the clamp, so occupancy churn below it stops
    changing rungs; a clamp of 0 pins the top rung. Results cannot
    change: the rung only grows, and the padding stays masked."""
    from spatialflink_tpu_torch import overload

    clamp = overload.compaction_clamp()
    if clamp is not None:
        live = cap if clamp <= 0 else max(live, clamp)
    for b in capacity_ladder(cap, minimum):
        if b >= live:
            return b
    return cap


def max_window_cell_count(pane: np.ndarray, cell: np.ndarray,
                          ppw: int) -> int:
    """The most events of one cell inside one window ``(t - ppw, t]``, over
    every cell and slide: the live occupancy the capacity pick needs.

    Events sorted by (cell, pane); for event i, the window ending at its
    own pane holds ``i - lo + 1`` events of its cell, where ``lo`` is the
    first event of the cell with pane > pane_i - ppw (a binary search on
    the composite key). Occupancy grows only when an event enters, so the
    largest of these is the largest over all slides."""
    n = len(pane)
    if n == 0:
        return 0
    pane = np.asarray(pane, np.int64)
    cell = np.asarray(cell, np.int64)
    span = int(pane.max()) + 1
    key = cell * span + pane
    order = np.argsort(key, kind="stable")
    ks = key[order]
    lo = np.searchsorted(
        ks, cell[order] * span + np.maximum(pane[order] - ppw + 1, 0))
    return int((np.arange(n) - lo + 1).max())
