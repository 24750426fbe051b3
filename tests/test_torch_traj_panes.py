"""Parity of the PyTorch port's sliding tStats pane engine
(``streams/panes.py:traj_stats_sliding``) with the JAX package's.

The same streams, made with numpy from a seed, go through the port's
device engine (on the CPU here) and the JAX package's ``backend="device"``
and ``backend="numpy"`` engines. The test configuration turns x64 on; the
JAX device engine picks its float type from that flag, so it runs inside
``jax.enable_x64(False)`` and computes in float32, as the port does.

Contracts held:
- window starts, point counts and temporal sums exact against both JAX
  engines;
- spatial sums within ``pane_spatial_bound`` (per oid:
  ``spatial_sum_bound`` over the row's longest addition path and its
  total float32 length): against the JAX float32 device engine, whose
  cumulative sums associate differently on the CPU, and against the
  float64 numpy engine fed the same float32-rounded coordinates;
- the port's numpy engine bit-equal to the JAX one (the same code);
- an empty stream, the int32-span guard and the backends that are not
  ported (``"native"``, ``mesh=``) behave as stated.
"""

import jax
import numpy as np
import pytest

from spatialflink_tpu.streams import panes as jpanes

from spatialflink_tpu_torch.streams import panes as tpanes

K = 64


def _stream(rng, n, t_max=20_000, n_obj=40, base=0, shuffle=False):
    ts = base + np.sort(rng.integers(0, t_max, n)).astype(np.int64)
    xy = rng.uniform(0, 10, (n, 2))
    oid = rng.integers(0, n_obj, n).astype(np.int64)
    if shuffle:
        perm = rng.permutation(n)
        ts, xy, oid = ts[perm], xy[perm], oid[perm]
    return ts, xy, oid


def _device(ts, xy, oid, size, slide):
    return tpanes.traj_stats_sliding(ts, xy, oid, K, size, slide,
                                     backend="device", device="cpu")


def _assert_matches(got, want, bound):
    assert np.array_equal(got.starts, want.starts)
    assert np.array_equal(got.count, want.count)
    assert np.array_equal(got.temporal, want.temporal)
    assert got.temporal.dtype == got.count.dtype == np.int64
    assert got.spatial.shape == want.spatial.shape
    assert np.all(np.abs(got.spatial - want.spatial) <= bound[None, :])


@pytest.mark.parametrize("shuffle", [False, True])
@pytest.mark.parametrize("ppw,slide,n", [(1, 1000, 3000), (10, 300, 3000),
                                         (1000, 10, 20_000)])
def test_device_engine_matches_jax_engines(ppw, slide, n, shuffle):
    rng = np.random.default_rng(ppw + shuffle)
    ts, xy, oid = _stream(rng, n, shuffle=shuffle)
    size = ppw * slide
    got = _device(ts, xy, oid, size, slide)
    bound = tpanes.pane_spatial_bound(ts, xy, oid, K, size, slide)
    with jax.enable_x64(False):
        jdev = jpanes.traj_stats_sliding(ts, xy, oid, K, size, slide,
                                         backend="device")
    assert jdev.spatial.dtype == got.spatial.dtype == np.float32
    _assert_matches(got, jdev, bound)
    xy32 = xy.astype(np.float32).astype(np.float64)
    jnp_ = jpanes.traj_stats_sliding(ts, xy32, oid, K, size, slide,
                                     backend="numpy")
    _assert_matches(got, jnp_, bound)
    assert len(got.starts) >= 20 and got.spatial.max() > 0


@pytest.mark.parametrize("ppw,slide", [(1, 1000), (1000, 10)])
def test_numpy_engine_is_the_jax_one(ppw, slide):
    rng = np.random.default_rng(3)
    ts, xy, oid = _stream(rng, 5000, shuffle=True)
    got = tpanes.traj_stats_sliding(ts, xy, oid, K, ppw * slide, slide,
                                    backend="numpy")
    want = jpanes.traj_stats_sliding(ts, xy, oid, K, ppw * slide, slide,
                                     backend="numpy")
    for a in ("starts", "spatial", "temporal", "count"):
        assert np.array_equal(getattr(got, a), getattr(want, a))
    assert np.array_equal(got.ends, want.ends)


def test_epoch_ms_timestamps_survive_the_int32_rebase():
    rng = np.random.default_rng(4)
    ts, xy, oid = _stream(rng, 5000, t_max=6000, base=1_753_900_000_000)
    got = _device(ts, xy, oid, 3000, 100)
    with jax.enable_x64(False):
        want = jpanes.traj_stats_sliding(ts, xy, oid, K, 3000, 100,
                                         backend="device")
    _assert_matches(got, want,
                    tpanes.pane_spatial_bound(ts, xy, oid, K, 3000, 100))
    assert got.starts[0] > 1_753_899_990_000


def test_single_segment_and_empty_stream():
    """A tumbling window over one trajectory walks 5 + 4 units, as in the
    JAX engines; an empty stream gives no windows, as the JAX function's
    empty result."""
    ts = np.asarray([100, 200, 300], np.int64)
    xy = np.asarray([[0.0, 0.0], [3.0, 4.0], [3.0, 8.0]])
    oid = np.asarray([2, 2, 2], np.int64)
    got = tpanes.traj_stats_sliding(ts, xy, oid, 8, 1000, 1000,
                                    backend="auto", device="cpu")
    assert got.starts.tolist() == [0] and got.spatial[0, 2] == 9.0
    assert got.temporal[0, 2] == 200 and got.count[0, 2] == 3
    empty = np.zeros(0, np.int64)
    got = tpanes.traj_stats_sliding(empty, np.zeros((0, 2)), empty, 8,
                                    1000, 10, device="cpu")
    want = jpanes.traj_stats_sliding(empty, np.zeros((0, 2)), empty, 8,
                                     1000, 10)
    for a in ("starts", "spatial", "temporal", "count"):
        assert getattr(got, a).shape == getattr(want, a).shape
        assert getattr(got, a).dtype == getattr(want, a).dtype


def test_int32_span_guard_and_argument_checks():
    ts = np.asarray([0, np.iinfo(np.int32).max + 10_000], np.int64)
    with pytest.raises(ValueError, match="int32 ms range"):
        _device(ts, np.zeros((2, 2)), np.zeros(2, np.int64), 1000, 1000)
    with pytest.raises(ValueError, match="int32 ms range"):
        jpanes.traj_stats_sliding(ts, np.zeros((2, 2)),
                                  np.zeros(2, np.int64), 8, 1000, 1000,
                                  backend="device")
    args = (np.asarray([0, 10], np.int64), np.zeros((2, 2)),
            np.zeros(2, np.int64), 8)
    with pytest.raises(ValueError, match="multiple of slide"):
        tpanes.traj_stats_sliding(*args, 1000, 300, device="cpu")
    with pytest.raises(ValueError, match="unknown"):
        tpanes.traj_stats_sliding(*args, 1000, 1000, backend="tpu",
                                  device="cpu")


def test_unported_backends_raise():
    """``backend="native"`` raises and never runs the numpy engine in its
    place; ``mesh=`` raises."""
    args = (np.asarray([0, 10], np.int64), np.zeros((2, 2)),
            np.zeros(2, np.int64), 8, 1000, 1000)
    with pytest.raises(NotImplementedError, match="A11"):
        tpanes.traj_stats_sliding(*args, backend="native", device="cpu")
    with pytest.raises(NotImplementedError, match="A12"):
        tpanes.traj_stats_sliding(*args, device="cpu", mesh=object())
