"""Instrumentation operators (``com/mn/operators/``)."""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable, Generic, Iterable, Iterator, TypeVar

from spatialflink_tpu_torch.mn.metrics import MetricNames, MetricRegistry

T = TypeVar("T")


@dataclass
class Stamped(Generic[T]):
    """Record + monotonic ingest timestamp (Stamped.java:8-20)."""

    value: T
    ingest_ns: int


class CsvParseAndStamp(Generic[T]):
    """Parse CSV → T, count source_in_total, stamp ingest time
    (CsvParseAndStamp.java:14-53). Registers the theoretical EPS/MB-s
    gauges from the configured rate."""

    def __init__(
        self,
        parser: Callable[[str], T],
        registry: MetricRegistry,
        theoretical_rows_per_sec: int = 20_000,
        bytes_per_record: int = 128,
    ):
        self.parser = parser
        self.registry = registry
        registry.gauge(
            MetricNames.THEORETICAL_EPS, lambda: float(theoretical_rows_per_sec)
        )
        registry.gauge(
            MetricNames.THEORETICAL_THROUGHPUT,
            lambda: theoretical_rows_per_sec * bytes_per_record / 1_000_000.0,
        )

    def __call__(self, lines: Iterable[str]) -> Iterator[Stamped[T]]:
        for line in lines:
            try:
                v = self.parser(line)
            except (ValueError, IndexError):
                continue
            self.registry.inc(MetricNames.SOURCE_IN)
            yield Stamped(v, time.monotonic_ns())


class CountingStage(Generic[T]):
    """in/out counters around a pipeline stage for selectivity analysis
    (CountingMap.java:14-33 / CountingFlatMap.java:14-69). Wraps either a
    passthrough (count only) or a generator transform."""

    def __init__(self, pipe_id: str, registry: MetricRegistry):
        self.in_name = MetricNames.pipe_in(pipe_id)
        self.out_name = MetricNames.pipe_out(pipe_id)
        self.registry = registry

    def count_in(self, items: Iterable[T]) -> Iterator[T]:
        for it in items:
            self.registry.inc(self.in_name)
            yield it

    def count_out(self, items: Iterable[T]) -> Iterator[T]:
        for it in items:
            self.registry.inc(self.out_name)
            yield it

    def around(
        self, items: Iterable, transform: Callable[[Iterable], Iterable]
    ) -> Iterator:
        yield from self.count_out(transform(self.count_in(items)))
