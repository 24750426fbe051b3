"""Wire-pane capacity buckets.

A pane of n points is padded to ``wire_pane_bucket(n)`` lanes, and the
kernels mask lanes past n (``n_valid``). Variable pane sizes therefore
share a few buffer shapes.
"""

from __future__ import annotations

from spatialflink_tpu_torch.utils.padding import next_bucket

#: Wire-kNN panes bucket at this floor (the JAX package's value, so both
#: packages pad a pane to the same capacity).
PANE_BUCKET_MIN = 128


def wire_pane_bucket(n: int, minimum: int = PANE_BUCKET_MIN) -> int:
    """Bucketed wire-pane capacity (power-of-two ladder above
    ``minimum``)."""
    return int(next_bucket(max(int(n), 1), minimum=minimum))
