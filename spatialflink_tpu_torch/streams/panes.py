"""Pane-decomposed sliding windows: per-key aggregates and trajectory
statistics through extreme-overlap windows (the reference's 10 s / 10 ms
configs).

``sliding_aggregate`` (host numpy, as in the JAX package) bins events
once into panes, one a slide step, and combines ``size/slide``
consecutive panes per window: cumulative-sum differences for counts,
sums and sums of squares, ``sliding_window_view`` minima and maxima. It
requires ``size % slide == 0``.

``traj_stats_sliding`` computes every window's per-trajectory spatial
length, temporal length and point count in O(events + panes × oids)
instead of O(windows × window size). Three engines, as in the JAX
package's ``streams/panes.py``:

- ``"device"``: ``ops/trajectory.py:traj_stats_pane_kernel`` on the
  given device, the card by default; float32 coordinates, or float64
  ones whenever the float64 mode is on (``precision.py``; the JAX
  engine's rule, which reads ``jax_enable_x64`` and takes no dtype), and
  int64 counts and temporal sums. Its spatial sums may differ from the
  numpy engine's in the last bits (``pane_spatial_bound``); counts and
  temporal sums are exact.
- ``"native"``: ``native.py:traj_stats_native``, the C++ single-pass
  engine (``native/sfnative.cpp:sf_traj_stats``) in float64 on the host,
  bit-identical to the numpy engine.
- ``"numpy"``: the host engine in float64, copied from the JAX package.

``"auto"`` follows the JAX rule with the card in the TPU's place: the
device engine when ``device`` is a CUDA device, else the native engine
(the numpy one where the native library is unavailable).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np
import torch
from numpy.lib.stride_tricks import sliding_window_view

from spatialflink_tpu_torch.device import resolve_device
from spatialflink_tpu_torch.ops.trajectory import (
    spatial_sum_bound,
    traj_stats_pane_kernel,
)
from spatialflink_tpu_torch.precision import x64_enabled
from spatialflink_tpu_torch.utils.padding import next_bucket


@dataclass
class PaneWindows:
    """Aggregates for every fired window.

    ``starts``: (W,) window start timestamps (ms). All per-key matrices are
    (W, K). A window fires iff it contains ≥1 event of any key (Flink
    semantics: windows materialize per element).
    """

    starts: np.ndarray
    count: np.ndarray  # events per (window, key)
    sums: Dict[str, np.ndarray]
    sumsqs: Dict[str, np.ndarray]
    mins: Dict[str, np.ndarray]
    maxs: Dict[str, np.ndarray]

    @property
    def ends(self) -> np.ndarray:
        return self.starts + self._size_ms

    _size_ms: int = 0


def sliding_aggregate(
    ts: np.ndarray,
    key: np.ndarray,
    num_keys: int,
    size_ms: int,
    slide_ms: int,
    sum_fields: Optional[Dict[str, np.ndarray]] = None,
    minmax_fields: Optional[Dict[str, np.ndarray]] = None,
    sumsq: bool = False,
    min_fields: Optional[Dict[str, np.ndarray]] = None,
    max_fields: Optional[Dict[str, np.ndarray]] = None,
) -> PaneWindows:
    """Aggregate a whole (bounded) stream over all sliding windows at once.

    ``ts``: (N,) event times ms; ``key``: (N,) dense int key per event
    (device id etc.); ``sum_fields``: named (N,) float arrays to sum per
    (window, key); ``minmax_fields``: tracked on both sides;
    ``min_fields``/``max_fields``: tracked on one side only (half the
    scatter + rolling work when the other side is unused).
    """
    if size_ms % slide_ms != 0:
        raise ValueError("size must be a multiple of slide for pane slicing")
    ppw = size_ms // slide_ms
    sum_fields = sum_fields or {}
    minmax_fields = minmax_fields or {}
    min_only = dict(min_fields or {})
    max_only = dict(max_fields or {})

    ts = np.asarray(ts, np.int64)
    key = np.asarray(key, np.int64)
    if len(ts) == 0:
        empty = np.zeros((0, num_keys))
        return PaneWindows(
            np.zeros(0, np.int64), empty.astype(np.int64),
            {k: empty.copy() for k in sum_fields},
            {k: empty.copy() for k in sum_fields} if sumsq else {},
            {k: empty.copy() for k in minmax_fields},
            {k: empty.copy() for k in minmax_fields},
            _size_ms=size_ms,
        )

    pane = np.floor_divide(ts, slide_ms)
    p_lo = int(pane.min())
    p_hi = int(pane.max())
    # Windows whose pane range [s, s+ppw) intersects [p_lo, p_hi]:
    # start panes from p_lo - ppw + 1 to p_hi.
    n_panes = p_hi - p_lo + 1
    n_starts = n_panes + ppw - 1
    flat = (pane - p_lo) * num_keys + key

    def scatter_sum(vals, dtype=np.float64):
        out = np.zeros(n_panes * num_keys, dtype)
        np.add.at(out, flat, vals)
        return out.reshape(n_panes, num_keys)

    pane_count = scatter_sum(np.ones(len(ts), np.int64), np.int64)
    pane_sums = {k: scatter_sum(np.asarray(v, float)) for k, v in sum_fields.items()}
    pane_sumsqs = (
        {k: scatter_sum(np.asarray(v, float) ** 2) for k, v in sum_fields.items()}
        if sumsq
        else {}
    )
    pane_mins = {}
    pane_maxs = {}
    for k, v in {**minmax_fields, **min_only}.items():
        v = np.asarray(v, float)
        mn = np.full(n_panes * num_keys, np.inf)
        np.minimum.at(mn, flat, v)
        pane_mins[k] = mn.reshape(n_panes, num_keys)
    for k, v in {**minmax_fields, **max_only}.items():
        v = np.asarray(v, float)
        mx = np.full(n_panes * num_keys, -np.inf)
        np.maximum.at(mx, flat, v)
        pane_maxs[k] = mx.reshape(n_panes, num_keys)

    # Pad ppw-1 panes on each side so every intersecting window start has a
    # full ppw-pane view.
    def pad(a, fill):
        padding = np.full((ppw - 1, num_keys), fill, a.dtype)
        return np.concatenate([padding, a, padding], axis=0)

    def rolling_sum(a):
        # Cumulative-sum difference: O(panes × keys) regardless of ppw.
        p = pad(a, 0)
        c = np.concatenate([np.zeros((1, num_keys), p.dtype), np.cumsum(p, axis=0)])
        return c[ppw:] - c[:-ppw]

    def rolling_min(a):
        return sliding_window_view(pad(a, np.inf), ppw, axis=0).min(axis=-1)

    def rolling_max(a):
        return sliding_window_view(pad(a, -np.inf), ppw, axis=0).max(axis=-1)

    w_count = rolling_sum(pane_count)
    # Keep only windows with ≥1 event (any key).
    alive = w_count.sum(axis=1) > 0
    starts = ((np.arange(n_starts) + p_lo - (ppw - 1)) * slide_ms)[alive]

    return PaneWindows(
        starts=starts.astype(np.int64),
        count=w_count[alive],
        sums={k: rolling_sum(v)[alive] for k, v in pane_sums.items()},
        sumsqs={k: rolling_sum(v)[alive] for k, v in pane_sumsqs.items()},
        mins={k: rolling_min(v)[alive] for k, v in pane_mins.items()},
        maxs={k: rolling_max(v)[alive] for k, v in pane_maxs.items()},
        _size_ms=size_ms,
    )


@dataclass
class TrajPaneWindows:
    """Per-(window, oid) trajectory stats for every fired sliding window.

    ``spatial``/``temporal``: (W, K) sums of consecutive-point distance /
    time within the window; ``count``: (W, K) points per trajectory.
    """

    starts: np.ndarray
    spatial: np.ndarray
    temporal: np.ndarray
    count: np.ndarray
    _size_ms: int = 0

    @property
    def ends(self) -> np.ndarray:
        return self.starts + self._size_ms


def pane_operands(ts, xy, oid, num_oids: int, slide_ms: int):
    """The device engine's host side: the (oid, ts) sort, the rebase to
    the first pane and the padding. Returns ``(operands, p_lo,
    n_panes)``, ``operands`` the numpy lanes (int32 rebased ts, x and y,
    int32 oid, bool valid) that ``traj_stats_pane_kernel`` takes. The x
    and y lanes are float64 whenever the float64 mode is on
    (``precision.py``), float32 otherwise, as the JAX engine takes
    float64 lanes whenever its x64 mode is on."""
    ts = np.asarray(ts, np.int64)
    oid = np.asarray(oid, np.int64)
    xy = np.asarray(xy, np.float64)
    ts_sorted = len(ts) <= 1 or bool(np.all(ts[1:] >= ts[:-1]))
    order = (np.argsort(oid, kind="stable") if ts_sorted
             else np.lexsort((ts, oid)))
    t, o, p = ts[order], oid[order], xy[order]
    pane = np.floor_divide(t, slide_ms)
    p_lo = int(pane.min())
    n_panes = next_bucket(int(pane.max()) - p_lo + 1, minimum=8)
    # Rebased time keeps epoch-ms streams inside int32 (pane arithmetic
    # is shift-invariant); beyond ~24 days of span fail, don't wrap.
    t_rel = t - p_lo * slide_ms
    if len(t_rel) and int(t_rel.max()) >= np.iinfo(np.int32).max - slide_ms:
        raise ValueError(
            "stream span exceeds the device pane engine's int32 ms range "
            "(~24 days); chunk the stream or use backend='numpy'"
        )
    n = len(t)
    pad = next_bucket(n, minimum=8) - n
    f_dtype = np.float64 if x64_enabled() else np.float32
    operands = (
        np.concatenate([t_rel, np.full(pad, t_rel[-1], np.int64)]
                       ).astype(np.int32),
        np.concatenate([p[:, 0], np.zeros(pad)]).astype(f_dtype),
        np.concatenate([p[:, 1], np.zeros(pad)]).astype(f_dtype),
        np.concatenate([o, np.full(pad, num_oids - 1, np.int64)]
                       ).astype(np.int32),
        np.concatenate([np.ones(n, bool), np.zeros(pad, bool)]),
    )
    return operands, p_lo, n_panes


def _traj_stats_sliding_device(ts, xy, oid, num_oids, size_ms, slide_ms,
                               device, mesh=None) -> TrajPaneWindows:
    """Device engine: host sort and pad, one kernel call on ``device``
    (or, with ``mesh``, one a shard of contiguous oid blocks,
    ``parallel/sharded.py:sharded_traj_stats_pane``), host
    alive-filter."""
    ppw = size_ms // slide_ms
    operands, p_lo, n_panes = pane_operands(ts, xy, oid, num_oids, slide_ms)
    if mesh is not None:
        from spatialflink_tpu_torch.parallel.sharded import (
            sharded_traj_stats_pane,
        )

        res = sharded_traj_stats_pane(
            mesh, *operands, num_oids=num_oids, slide_ms=slide_ms, ppw=ppw,
            n_panes=n_panes)
    else:
        dev = resolve_device(device)
        lanes = [torch.from_numpy(a).to(dev) for a in operands]
        res = traj_stats_pane_kernel(*lanes, num_oids=num_oids,
                                     slide_ms=slide_ms, ppw=ppw,
                                     n_panes=n_panes)
    w_d = res.spatial.T.cpu().numpy()
    w_dt = res.temporal.T.cpu().numpy()
    w_cnt = res.count.T.cpu().numpy()
    n_starts = n_panes + ppw - 1
    alive = w_cnt.sum(axis=1) > 0
    starts = ((np.arange(n_starts) + p_lo - (ppw - 1)) * slide_ms)[alive]
    return TrajPaneWindows(
        starts=starts.astype(np.int64),
        spatial=w_d[alive],
        temporal=w_dt[alive],
        count=w_cnt[alive],
        _size_ms=size_ms,
    )


def traj_stats_sliding(
    ts: np.ndarray,
    xy: np.ndarray,
    oid: np.ndarray,
    num_oids: int,
    size_ms: int,
    slide_ms: int,
    backend: str = "auto",
    device="cuda",
    mesh=None,
) -> TrajPaneWindows:
    """Pane-decomposed sliding trajectory statistics.

    Each consecutive same-trajectory segment is binned once into the pane
    of its later point; window sums are cumulative-sum differences over
    ``size/slide`` panes. A segment whose earlier point precedes a
    window's start does not count for that window (the reference's
    per-window walk truncates trajectories at the start boundary,
    tStats/TStatsQuery.java:148-189), so an interval correction
    subtracts every segment from exactly the windows whose start it
    crosses. Equals ``TStatsQuery.run``'s per-window recompute.

    ``backend``: ``"device"`` runs the device engine on ``device``;
    ``"native"`` the C++ engine on the ts-sorted stream, raising
    ``RuntimeError`` when the native library is unavailable (it never
    measures the numpy engine in its place); ``"numpy"`` the float64 host
    engine. ``"auto"`` takes the device engine when ``device`` is a CUDA
    device and the host engines otherwise, native first; under an active
    overload ``pane_backend`` rung (either target) it takes the host
    engines in that order on any device. A forced backend is never
    overridden. ``mesh``: the device engine over its ``data`` axis,
    contiguous oid blocks a shard with no collective, equal to the
    unsharded engine (``num_oids`` must divide by the axis); it refuses
    the host backends.
    """
    if size_ms % slide_ms != 0:
        raise ValueError("size must be a multiple of slide for pane slicing")
    ppw = size_ms // slide_ms
    ts = np.asarray(ts, np.int64)
    oid = np.asarray(oid, np.int64)
    xy = np.asarray(xy, float)
    if len(ts) == 0:
        empty = np.zeros((0, num_oids))
        return TrajPaneWindows(
            np.zeros(0, np.int64), empty, empty.astype(np.int64),
            empty.astype(np.int64), _size_ms=size_ms,
        )
    if backend not in ("auto", "device", "numpy", "native"):
        raise ValueError(f"unknown traj_stats backend {backend!r}")
    if mesh is not None and backend in ("numpy", "native"):
        raise ValueError(
            f"mesh execution requires the device backend, not {backend!r}"
        )
    # An active overload pane_backend rung biases "auto" to the host
    # engines, which answer as the device engine does, freeing the
    # device. Forced backends are never overridden.
    from spatialflink_tpu_torch import overload

    prefer_host = (backend == "auto" and mesh is None
                   and overload.pane_backend() in ("native", "numpy"))
    if mesh is not None or backend == "device" or (
            backend == "auto" and not prefer_host
            and torch.device(device).type == "cuda"):
        return _traj_stats_sliding_device(ts, xy, oid, num_oids, size_ms,
                                          slide_ms, device, mesh=mesh)

    ts_sorted = len(ts) <= 1 or bool(np.all(ts[1:] >= ts[:-1]))

    # The native single-pass engine (native/sfnative.cpp:sf_traj_stats):
    # bit-identical to the numpy engine below (the same float association
    # order).
    try:
        from spatialflink_tpu_torch import native as _native

        native_ok = backend != "numpy" and _native.available()
    except Exception:  # pragma: no cover - import or build failure
        native_ok = False
    if backend == "native" and not native_ok:
        raise RuntimeError(
            "backend='native' was forced but the native library is "
            "unavailable (build native/ with make); refusing to measure "
            "the numpy engine in its place")
    if native_ok:
        if ts_sorted:
            ts_s, xy_s, oid_s = ts, xy, oid
        else:
            order = np.argsort(ts, kind="stable")
            ts_s, xy_s, oid_s = ts[order], xy[order], oid[order]
        out = _native.traj_stats_native(
            ts_s, xy_s[:, 0], xy_s[:, 1], oid_s, num_oids, size_ms,
            slide_ms)
        if out is not None:
            n_starts, w_d, w_dt, w_cnt = out
            p_lo = int(np.floor_divide(int(ts_s[0]), slide_ms))
            alive = w_cnt.sum(axis=1) > 0
            starts = ((np.arange(n_starts) + p_lo - (ppw - 1))
                      * slide_ms)[alive]
            return TrajPaneWindows(
                starts=starts.astype(np.int64),
                spatial=w_d[alive],
                temporal=w_dt[alive],
                count=w_cnt[alive],
                _size_ms=size_ms,
            )
    if ts_sorted:
        # A stable sort on oid alone keeps the ts order within each
        # trajectory: cheaper than the two-key lexsort.
        order = np.argsort(oid, kind="stable")
    else:
        order = np.lexsort((ts, oid))
    t = ts[order]
    o = oid[order]
    p = xy[order]

    pane = np.floor_divide(t, slide_ms)
    p_lo = int(pane.min())
    p_hi = int(pane.max())
    n_panes = p_hi - p_lo + 1
    n_starts = n_panes + ppw - 1

    cnt = np.bincount(
        (pane - p_lo) * num_oids + o, minlength=n_panes * num_oids
    ).astype(np.int64).reshape(n_panes, num_oids)

    same = o[1:] == o[:-1]
    seg_d = np.hypot(p[1:, 0] - p[:-1, 0], p[1:, 1] - p[:-1, 1])[same]
    seg_dt = (t[1:] - t[:-1])[same]
    seg_oid = o[1:][same]
    seg_tprev = t[:-1][same]
    seg_pane = pane[1:][same]  # pane of the later point

    seg_flat = (seg_pane - p_lo) * num_oids + seg_oid

    def scatter(vals, dtype=float):
        if dtype is float:
            out = np.bincount(
                seg_flat, weights=vals, minlength=n_panes * num_oids
            )
        else:
            # Integer sums stay on add.at: bincount's float64 weights
            # would round above 2^53.
            out = np.zeros(n_panes * num_oids, dtype)
            np.add.at(out, seg_flat, vals)
        return out.reshape(n_panes, num_oids)

    pane_d = scatter(seg_d)
    pane_dt = scatter(seg_dt, np.int64)

    b = np.arange(n_starts) - (ppw - 1)  # window start pane indices
    row_hi = np.clip(b + ppw, 0, n_panes)
    row_lo = np.clip(b, 0, n_panes)

    def rolling_sum(a):
        c = np.concatenate(
            [np.zeros((1, num_oids), a.dtype), np.cumsum(a, axis=0)]
        )
        return c[row_hi] - c[row_lo]

    w_d = rolling_sum(pane_d)
    w_dt = rolling_sum(pane_dt)
    w_cnt = rolling_sum(cnt)

    # A segment is over-counted by every window whose start lies in
    # (t_prev, t_later] and that still holds the later point.
    first_b = np.maximum(seg_tprev // slide_ms + 1, seg_pane - ppw + 1)
    last_b = seg_pane
    has = first_b <= last_b
    if has.any():
        base = p_lo - (ppw - 1)  # window-start pane of start index 0
        si0 = (first_b[has] - base).astype(np.int64)
        si1 = (last_b[has] - base).astype(np.int64) + 1

        idx = np.concatenate(
            [si0 * num_oids + seg_oid[has], si1 * num_oids + seg_oid[has]]
        )

        def interval_sub(w_mat, vals, dtype=float):
            if dtype is float:
                diff = np.bincount(
                    idx, weights=np.concatenate([vals, -vals]),
                    minlength=(n_starts + 1) * num_oids,
                )
            else:
                diff = np.zeros(((n_starts + 1) * num_oids,), dtype)
                np.add.at(diff, idx, np.concatenate([vals, -vals]))
            corr = np.cumsum(diff.reshape(n_starts + 1, num_oids), axis=0)
            return w_mat - corr[:n_starts]

        w_d = interval_sub(w_d, seg_d[has])
        w_dt = interval_sub(w_dt, seg_dt[has], np.int64)

    alive = w_cnt.sum(axis=1) > 0
    starts = ((np.arange(n_starts) + p_lo - (ppw - 1)) * slide_ms)[alive]
    return TrajPaneWindows(
        starts=starts.astype(np.int64),
        spatial=w_d[alive],
        temporal=w_dt[alive],
        count=w_cnt[alive],
        _size_ms=size_ms,
    )


def pane_spatial_bound(ts, xy, oid, num_oids: int, size_ms: int,
                       slide_ms: int) -> np.ndarray:
    """(K,) the bound, per oid, within which two runs of the device
    engine's spatial sums agree, and within which the device engine
    agrees with the numpy engine fed the same coordinates, in the dtype
    of the engine's lanes (``pane_operands``: float32, or float64 in the
    float64 mode): ``spatial_sum_bound`` of that dtype over the row's
    longest addition path (its segments three times: the pane sums and
    both interval sums; the panes and window starts of both cumulative
    sums; 4 more for the differences and the roundings of each term) and
    its magnitude, the row's total segment length in the lanes' values
    (which bounds every partial sum)."""
    operands, _, n_panes = pane_operands(ts, xy, oid, num_oids, slide_ms)
    _, x, y, o, valid = operands
    same = (o[1:] == o[:-1]) & valid[1:] & valid[:-1]
    seg = np.hypot(x[1:].astype(np.float64) - x[:-1],
                   y[1:].astype(np.float64) - y[:-1])
    magnitude = np.bincount(o[1:][same], weights=seg[same],
                            minlength=num_oids)
    segments = np.bincount(o[1:][same], minlength=num_oids)
    n_starts = n_panes + size_ms // slide_ms - 1
    return spatial_sum_bound(3 * segments + n_panes + n_starts + 4,
                             magnitude, x.dtype)
