"""Per-interval CSV metrics sink (``sncb/metrics/MetricsSink.java:13-101``).

Rows: ``seconds,count,bytesMB,eps,throughputMBps,avgLatencyMs`` per
reporting interval, where latency = now − event/window timestamp.
``include_opcounters=True`` appends a ``distComp`` column fed by the
kernel-level counter registry (ops/counters.py — the Point.java:220-235
distance-computation analog); ``include_telemetry=True`` appends
``wmLagMs,lateDrops`` fed by the runtime telemetry layer (telemetry.py:
the max watermark lag gauge and the per-interval late-drop delta). Both
off by default to preserve the reference's exact column set.
"""

from __future__ import annotations

import os
import time
from typing import Optional


class MetricsSink:
    """Count records per wall-clock interval and append CSV rows."""

    HEADER = "seconds,count,bytesMB,eps,throughputMBps,avgLatencyMs"

    def __init__(
        self,
        name: str,
        path: Optional[str] = None,
        interval_s: float = 1.0,
        bytes_per_record: int = 128,
        include_opcounters: bool = False,
        include_telemetry: bool = False,
    ):
        self.name = name
        self.interval_s = interval_s
        self.bytes_per_record = bytes_per_record
        self.include_opcounters = include_opcounters
        self.include_telemetry = include_telemetry
        self._last_dist_comp = 0
        self._last_late_drops = 0
        if include_opcounters:
            self.HEADER = self.HEADER + ",distComp"
            # Baseline at construction: earlier runs' tallies must not leak
            # into this sink's first interval.
            from spatialflink_tpu_torch.ops.counters import counters as opcounters

            self._last_dist_comp = opcounters.dist_computations
        if include_telemetry:
            self.HEADER = self.HEADER + ",wmLagMs,lateDrops"
            from spatialflink_tpu_torch.telemetry import telemetry

            self._last_late_drops = telemetry.late_drops
        self._t0 = time.time()
        self._interval_start = self._t0
        self._count = 0
        self._latency_sum_ms = 0.0
        self.rows = []
        self._f = None
        if path:
            os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
            self._f = open(path, "w")
            self._f.write(self.HEADER + "\n")

    def record(self, event_ts_ms: Optional[int] = None, n: int = 1):
        now = time.time()
        self._count += n
        if event_ts_ms is not None:
            self._latency_sum_ms += max(0.0, now * 1000 - event_ts_ms) * n
        if now - self._interval_start >= self.interval_s:
            self._flush_interval(now)

    def _flush_interval(self, now: float):
        dt = now - self._interval_start
        if dt <= 0:
            return
        eps = self._count / dt
        mb = self._count * self.bytes_per_record / 1e6
        avg_lat = self._latency_sum_ms / self._count if self._count else 0.0
        # float() wraps: numpy ≥2 scalars would print np.float64(…) into
        # the CSV row (sfcheck fstring-numpy).
        row = (
            f"{float(now - self._t0):.1f},{self._count},{float(mb):.3f},"
            f"{float(eps):.1f},{float(mb / dt):.3f},{float(avg_lat):.2f}"
        )
        if self.include_opcounters:
            from spatialflink_tpu_torch.ops.counters import counters as opcounters

            total = opcounters.dist_computations
            row += f",{total - self._last_dist_comp}"
            self._last_dist_comp = total
        if self.include_telemetry:
            from spatialflink_tpu_torch.telemetry import telemetry

            late = telemetry.late_drops
            if late < self._last_late_drops:
                # telemetry.enable() reset the gauge mid-run: re-baseline
                # instead of printing a negative delta.
                self._last_late_drops = 0
            row += (f",{telemetry.max_watermark_lag_ms},"
                    f"{late - self._last_late_drops}")
            self._last_late_drops = late
        self.rows.append(row)
        if self._f:
            self._f.write(row + "\n")
            self._f.flush()
        self._interval_start = now
        self._count = 0
        self._latency_sum_ms = 0.0

    def close(self):
        self._flush_interval(time.time())
        if self._f:
            self._f.close()
