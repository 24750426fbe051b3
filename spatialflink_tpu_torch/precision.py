"""The port's counterpart of JAX's ``jax_enable_x64``: the float64 mode.

The JAX package computes in float64 where its caller asks for
``dtype=np.float64`` (every operator entry point's default) and JAX's
x64 mode is on, as its test suite turns it on; its accelerator, with x64
off, gets centred float32 lanes instead (``operators/base.py:
center_coords``). The port follows the same rule: **float64 only when
``dtype`` is float64 and x64 is on**. Then coordinates go to the device
raw, uncentred, in float64, as the JAX package ships them, and the
kernels (B3, B4 on the card) compute, compare the radius and return
distances in float64; sentinels are ``finfo(float64).max``, and the kNN
pane carries and the pane-carry tJoin's carry are float64. That holds for
every entry point that takes a ``dtype``: the range, kNN and join
operators of point and geometry streams (``run``, ``run_soa``,
``query_incremental``), the pane-carry kNN (``query_panes``,
``run_soa_panes``), ``run_multi``, the pane-carry point join
(``query_panes``), the trajectory operators (tRange, tKnn, tJoin with
its pane carry, tAggregate, tStats), the standing-query server
(``qserve.py``), every ``mesh=`` run of them, in one process or across
processes (``parallel/sharded.py``: each shard takes the unsharded run's
lanes and kernels). The grid-partitioned ``run_partitioned``
(``parallel/halo.py``) takes the raw coordinates cast to ``dtype``, as
the JAX package's does, in either mode. One path follows the mode
alone, as its JAX counterpart does: the tStats device pane engine
(``streams/panes.py:traj_stats_sliding``) takes float64 lanes whenever
x64 is on, and takes no ``dtype``. In every other case the lanes are the
centred float32 ones. The headline wire path (``run_wire_panes``) is
float32 in either mode, by its wire format.

The switch is off by default and is read at call time; nothing is read
from the environment. Like ``jax.config``, it is one setting for the
whole process, for every thread::

    from spatialflink_tpu_torch import precision

    precision.enable_x64(True)   # jax.config.update("jax_enable_x64", True)
    with precision.x64(True):    # jax.enable_x64(True)
        ...
"""

from __future__ import annotations

import contextlib
from typing import Iterator

import numpy as np


class _Precision:
    """The process-wide x64 setting (off until ``enable_x64(True)``)."""

    x64 = False


_config = _Precision()


def enable_x64(flag: bool) -> None:
    """Turn the float64 mode on or off for the whole process."""
    _config.x64 = bool(flag)


def x64_enabled() -> bool:
    """Whether the float64 mode is on."""
    return _config.x64


@contextlib.contextmanager
def x64(flag: bool = True) -> Iterator[None]:
    """The float64 mode set to ``flag`` inside the block, and restored to
    its earlier value on the way out."""
    prev = _config.x64
    _config.x64 = bool(flag)
    try:
        yield
    finally:
        _config.x64 = prev


def effective_f64(dtype) -> bool:
    """True when a request for ``dtype`` computes in float64: ``dtype``
    is float64 and the float64 mode is on (the JAX package's rule in
    ``center_coords``)."""
    return np.dtype(dtype) == np.float64 and _config.x64

