"""Event-time windowing of object streams — the host control plane.

Sliding and tumbling event-time windows with a bounded-out-of-orderness
watermark and allowed lateness (Flink's semantics, which the reference
uses). The assembler buffers events per window and fires a batch when the
watermark passes the window's end; the batch then goes to the operator's
kernels in one call. Count windows slice arrival order. Semantics are the
JAX package's ``streams/windows.py``.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Dict, Generic, Iterable, Iterator, List, Optional, TypeVar

from spatialflink_tpu_torch import overload, slo
from spatialflink_tpu_torch.faults import faults
from spatialflink_tpu_torch.telemetry import telemetry

T = TypeVar("T")


@dataclass(frozen=True)
class WindowSpec:
    start: int  # ms, inclusive
    end: int  # ms, exclusive


@dataclass
class WindowBatch(Generic[T]):
    """A fired window: its span and the buffered events."""

    start: int
    end: int
    events: List[T]
    # Wall-clock time when the window fired (for latency accounting).
    fire_time: float = field(default_factory=time.time)


class SlidingEventTimeWindows:
    """Flink-compatible sliding window assignment: window starts are the
    multiples of ``slide`` with start > ts - size and start <= ts."""

    def __init__(self, size_ms: int, slide_ms: int):
        if size_ms <= 0 or slide_ms <= 0:
            raise ValueError("size and slide must be positive")
        self.size = int(size_ms)
        self.slide = int(slide_ms)

    def assign(self, ts: int) -> List[WindowSpec]:
        last_start = ts - ((ts % self.slide) + self.slide) % self.slide
        out = []
        start = last_start
        while start > ts - self.size:
            out.append(WindowSpec(start, start + self.size))
            start -= self.slide
        return out


class TumblingEventTimeWindows(SlidingEventTimeWindows):
    """size == slide."""

    def __init__(self, size_ms: int):
        super().__init__(size_ms, size_ms)


class CountWindows:
    """Count windows (size, slide) over arrival order."""

    def __init__(self, size: int, slide: Optional[int] = None):
        self.size = int(size)
        self.slide = int(slide) if slide is not None else self.size

    def feed(self, buf: List[T], event: T) -> List[List[T]]:
        """Append to a buffer; return fired windows (lists)."""
        buf.append(event)
        fired = []
        while len(buf) >= self.size:
            fired.append(buf[: self.size])
            del buf[: self.slide]
            if self.slide == 0:
                break
        return fired


class WindowAssembler(Generic[T]):
    """Buffers timestamped events into sliding windows; fires on watermark.

    Watermark = max event time − max_out_of_orderness. A window fires when
    the watermark passes its end; an event that arrives after the fire but
    within ``allowed_lateness`` re-fires the window with the late event
    included. Later events are dropped and counted (``dropped_late``).
    """

    def __init__(
        self,
        windows: SlidingEventTimeWindows,
        timestamp_fn: Callable[[T], int],
        max_out_of_orderness_ms: int = 0,
        allowed_lateness_ms: int = 0,
    ):
        self.windows = windows
        self.timestamp_fn = timestamp_fn
        self.ooo = int(max_out_of_orderness_ms)
        self.lateness = int(allowed_lateness_ms)
        self._buffers: Dict[WindowSpec, List[T]] = {}
        self._fired: Dict[WindowSpec, bool] = {}
        self._max_ts: Optional[int] = None
        self.dropped_late = 0

    @property
    def watermark(self) -> int:
        if self._max_ts is None:
            return -(2**62)
        return self._max_ts - self.ooo

    def feed(self, event: T) -> List[WindowBatch[T]]:
        """Add one event; return any windows that fire as a result."""
        if faults.armed:  # fault injection point (faults.py)
            faults.hit("window.feed")
        ts = int(self.timestamp_fn(event))
        if self._max_ts is None or ts > self._max_ts:
            self._max_ts = ts
        wm = self.watermark

        fired: List[WindowBatch[T]] = []
        landed = False
        for spec in self.windows.assign(ts):
            if spec.end + self.lateness <= wm:
                continue
            landed = True
            buf = self._buffers.setdefault(spec, [])
            buf.append(event)
            if self._fired.get(spec):
                # Late-but-allowed: refire immediately with the late event.
                fired.append(WindowBatch(spec.start, spec.end, list(buf)))
        if not landed:
            # Dropped only when every window of the event is past the
            # lateness horizon.
            self.dropped_late += 1
            telemetry.record_late_drop()

        fired.extend(self._advance(wm))
        return fired

    def _advance(self, wm: int) -> List[WindowBatch[T]]:
        fired = []
        for spec in sorted(self._buffers, key=lambda s: s.end):
            if spec.end <= wm and not self._fired.get(spec):
                fired.append(WindowBatch(spec.start, spec.end,
                                         list(self._buffers[spec])))
                self._fired[spec] = True
                # Watermark lag: event-time ms between window end and the
                # watermark that fired it. The SLO engine and the overload
                # controller ride the same fire site (one global read each
                # when nothing is installed).
                telemetry.record_watermark_lag(wm - spec.end)
                slo.on_window_fired(len(self._buffers[spec]),
                                    lag_ms=wm - spec.end)
                overload.on_window_fired(len(self._buffers[spec]),
                                         lag_ms=wm - spec.end,
                                         end=spec.end)
        # Forget windows past the lateness horizon (feed() already blocks
        # their re-entry).
        for spec in [s for s in self._buffers if s.end + self.lateness <= wm]:
            if not self._fired.get(spec):
                fired.append(WindowBatch(spec.start, spec.end,
                                         list(self._buffers[spec])))
            del self._buffers[spec]
            self._fired.pop(spec, None)
        return fired

    def flush(self) -> List[WindowBatch[T]]:
        """End of stream: fire every remaining un-fired window."""
        out = []
        for spec in sorted(self._buffers, key=lambda s: s.end):
            if not self._fired.get(spec):
                out.append(WindowBatch(spec.start, spec.end,
                                       list(self._buffers[spec])))
                self._fired[spec] = True
        self._buffers.clear()
        return out

    def stream(self, source: Iterable[T]) -> Iterator[WindowBatch[T]]:
        """Drive a whole source through the assembler."""
        for ev in source:
            yield from self.feed(ev)
        yield from self.flush()
