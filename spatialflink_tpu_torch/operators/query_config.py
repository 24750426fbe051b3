"""Query configuration: the reference's QueryConfiguration and QueryType."""

from __future__ import annotations

import enum
from dataclasses import dataclass


class QueryType(enum.Enum):
    RealTime = "realtime"
    WindowBased = "windowbased"
    CountBased = "countbased"
    RealTimeNaive = "realtimenaive"


@dataclass
class QueryConfiguration:
    """windowSize / slideStep / allowedLateness in seconds, like the
    reference. ``realtime_batch_ms`` is the micro-batch slice used to
    emulate RealTime (per-record) mode on batched hardware: RealTime
    queries run as tumbling micro-batches of this span.
    """

    query_type: QueryType = QueryType.WindowBased
    window_size: float = 10.0
    slide_step: float = 5.0
    allowed_lateness: float = 0.0
    approximate_query: bool = False
    count_window_size: int = 100
    realtime_batch_ms: int = 100

    @property
    def window_size_ms(self) -> int:
        return int(self.window_size * 1000)

    @property
    def slide_step_ms(self) -> int:
        return int(self.slide_step * 1000)

    @property
    def allowed_lateness_ms(self) -> int:
        return int(self.allowed_lateness * 1000)
