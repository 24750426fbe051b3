"""Counting latency sinks (``com/mn/sinks/``). Each sink's registry also
carries the runtime telemetry gauges (``telemetry.register_metrics``)."""

from __future__ import annotations

import os
import time
from typing import Any, Callable, Optional

from spatialflink_tpu_torch.mn.metrics import FixedBucketLatency, MetricNames, MetricRegistry


class _CountingLatencySinkBase:
    """Measure sink_out, out_bytes, and per-record latency
    (now − ingestNs) into the histogram (CountingLatencyFileSink.java:23-70)."""

    def __init__(self, registry: MetricRegistry,
                 histogram: Optional[FixedBucketLatency] = None):
        self.registry = registry
        self.histogram = histogram or FixedBucketLatency(registry)
        # The telemetry gauges (watermark lag, late drops, distinct
        # shapes, device-boundary bytes) read live singleton state, so
        # telemetry enabled after the pipeline is built still reports
        # (zeros while disabled).
        from spatialflink_tpu_torch.telemetry import telemetry

        telemetry.register_metrics(registry)

    def _account(self, rendered: str, ingest_ns: Optional[int]):
        self.registry.inc(MetricNames.SINK_OUT)
        self.registry.inc(MetricNames.OUT_BYTES, len(rendered) + 1)
        if ingest_ns is not None:
            # Whole-ms truncation like the reference (deltaNs / 1_000_000
            # as integer division) so bucket placement matches exactly.
            self.histogram.observe((time.monotonic_ns() - ingest_ns) // 1_000_000)


class CountingLatencyFileSink(_CountingLatencySinkBase):
    """Write + flush each record (CountingLatencyFileSink.java:23-70)."""

    def __init__(self, path: str, registry: MetricRegistry,
                 formatter: Callable[[Any], str] = str,
                 histogram: Optional[FixedBucketLatency] = None):
        super().__init__(registry, histogram)
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        self._f = open(path, "w")
        self.formatter = formatter

    def __call__(self, record: Any, ingest_ns: Optional[int] = None):
        line = self.formatter(record)
        self._f.write(line + "\n")
        self._f.flush()
        self._account(line, ingest_ns)

    def close(self):
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class CountingLatencyPrintSink(_CountingLatencySinkBase):
    """Print variant (CountingLatencyPrintSink.java:17-48)."""

    def __init__(self, registry: MetricRegistry,
                 formatter: Callable[[Any], str] = str,
                 histogram: Optional[FixedBucketLatency] = None,
                 quiet: bool = False):
        super().__init__(registry, histogram)
        self.formatter = formatter
        self.quiet = quiet

    def __call__(self, record: Any, ingest_ns: Optional[int] = None):
        line = self.formatter(record)
        if not self.quiet:
            print(line)
        self._account(line, ingest_ns)
