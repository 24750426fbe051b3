"""Bucketed padding.

Pane point-counts vary between slides. Padding each pane to the next
bucket (powers of two above a floor) keeps the set of kernel shapes, and
the device allocations behind them, to a handful for the whole stream.
"""

from __future__ import annotations

import numpy as np

_MIN_BUCKET = 256


def next_bucket(n: int, minimum: int = _MIN_BUCKET) -> int:
    """Smallest power-of-two bucket >= max(n, 1), floored at ``minimum``."""
    b = minimum
    while b < n:
        b <<= 1
    return b


def pad_to_bucket(arr: np.ndarray, bucket: int, fill=0) -> np.ndarray:
    """Pad axis 0 of ``arr`` to ``bucket`` with ``fill``."""
    n = arr.shape[0]
    if n == bucket:
        return arr
    if n > bucket:
        raise ValueError(f"array length {n} exceeds bucket {bucket}")
    pad_shape = (bucket - n,) + arr.shape[1:]
    return np.concatenate(
        [arr, np.full(pad_shape, fill, dtype=arr.dtype)], axis=0
    )
