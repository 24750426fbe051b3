"""NES-compatible metrics primitives (``com/mn/metrics/``).

``FixedBucketLatency`` keeps the exact NES bucket boundaries and percentile
semantics of FixedBucketLatency.java:13-67; ``MetricNames`` the canonical
names of MetricNames.java:6-35; ``MetricRegistry`` replaces Flink's
MetricGroup with a flat counter/gauge registry the reporter reads.
"""

from __future__ import annotations

import bisect
import math
import numbers
import threading
from typing import Callable, Dict

import numpy as np


def json_safe(value):
    """Builtin-type mirror of a metrics/telemetry value: numpy scalars →
    ``int``/``float``, arrays → lists, containers recursed. Every snapshot
    crosses this at its boundary so ``json.dumps(snapshot)`` can never
    raise (the ``np.float32`` f-string/serialization bug has shipped twice)
    and f-strings format cleanly under numpy ≥2."""
    if isinstance(value, dict):
        return {k: json_safe(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return [json_safe(v) for v in value]
    if isinstance(value, (bool, int, float, str)) or value is None:
        return value
    if isinstance(value, np.ndarray):
        return value.tolist()
    if isinstance(value, np.bool_):  # not registered with numbers on np≥2
        return bool(value)
    if isinstance(value, numbers.Integral):  # np.int32/64, …
        return int(value)
    if isinstance(value, numbers.Real):  # np.float32/64, …
        return float(value)
    if isinstance(value, np.generic):  # any other numpy scalar
        return value.item()
    return value

# NES buckets in ms — upper bounds ("le" semantics), FixedBucketLatency.java:15-16.
BUCKETS_MS = [0, 1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1000, 2000, 5000,
              10000, 20000, 60000]


class MetricNames:
    """MetricNames.java:6-35."""

    THEORETICAL_EPS = "theoretical_eps"
    THEORETICAL_THROUGHPUT = "theoretical_throughput_mb_s"
    SOURCE_IN = "source_in_total"
    SINK_OUT = "sink_out_total"
    OUT_BYTES = "out_bytes_total"
    LATENCY_COUNT = "latency_count"
    LATENCY_SUM = "latency_sum_ms"
    LATENCY_P50 = "latency_p50_ms"
    LATENCY_P95 = "latency_p95_ms"
    LATENCY_P99 = "latency_p99_ms"

    @staticmethod
    def pipe_in(pipe_id: str) -> str:
        return f"pipe_{pipe_id}_in_total"

    @staticmethod
    def pipe_out(pipe_id: str) -> str:
        return f"pipe_{pipe_id}_out_total"


class MetricRegistry:
    """Counters + gauges, the host-side MetricGroup analog.

    Thread-safe: operator threads ``inc`` while the NESFileReporter timer
    thread snapshots — increments and copies share one lock (a bare
    ``dict(registry.counters)`` mid-resize raised RuntimeError and could
    tear read-modify-write increments)."""

    def __init__(self):
        self.counters: Dict[str, int] = {}
        self.gauges: Dict[str, Callable[[], float]] = {}
        self._lock = threading.Lock()

    def inc(self, name: str, n: int = 1):
        with self._lock:
            self.counters[name] = self.counters.get(name, 0) + n

    def counter(self, name: str) -> int:
        with self._lock:
            return self.counters.get(name, 0)

    def gauge(self, name: str, fn: Callable[[], float]):
        with self._lock:
            self.gauges[name] = fn

    def snapshot_counters(self) -> Dict[str, int]:
        """Consistent counter copy for reporter threads."""
        with self._lock:
            return dict(self.counters)

    def snapshot(self) -> Dict[str, float]:
        out: Dict[str, float] = self.snapshot_counters()
        with self._lock:
            gauges = list(self.gauges.items())
        for name, fn in gauges:
            out[name] = fn()
        return json_safe(out)


class FixedBucketLatency:
    """17-bucket latency histogram with p50/p95/p99 (FixedBucketLatency.java).

    ``observe`` places a sample in the first bucket whose bound is >= the
    value (binary search, overflow clamps to the last bucket); percentiles
    return the bucket bound at the ceil(p·n)-th cumulative sample.
    """

    def __init__(self, registry: MetricRegistry | None = None, prefix: str = ""):
        self.buckets = [0] * len(BUCKETS_MS)
        self.count = 0
        self.sum_ms = 0
        self.registry = registry
        self.prefix = prefix
        if registry is not None:
            registry.gauge(prefix + MetricNames.LATENCY_P50, lambda: self.percentile(0.50))
            registry.gauge(prefix + MetricNames.LATENCY_P95, lambda: self.percentile(0.95))
            registry.gauge(prefix + MetricNames.LATENCY_P99, lambda: self.percentile(0.99))

    def observe(self, latency_ms: float):
        idx = bisect.bisect_left(BUCKETS_MS, latency_ms)
        if idx >= len(BUCKETS_MS):
            idx = len(BUCKETS_MS) - 1
        self.buckets[idx] += 1
        self.count += 1
        self.sum_ms += int(latency_ms)
        if self.registry is not None:
            self.registry.inc(f"{self.prefix}latency_bucket_le_{BUCKETS_MS[idx]}")
            self.registry.inc(self.prefix + MetricNames.LATENCY_COUNT)
            self.registry.inc(self.prefix + MetricNames.LATENCY_SUM, int(latency_ms))

    def percentile(self, p: float) -> float:
        if self.count <= 0:
            return math.nan
        rank = math.ceil(p * self.count)
        cum = 0
        for i, c in enumerate(self.buckets):
            cum += c
            if cum >= rank:
                return float(BUCKETS_MS[i])
        return float(BUCKETS_MS[-1])
