"""Stream sources: the host-side ingress, as in the JAX package's
``streams/sources.py``.

In-memory fixtures, CSV replay (``MobilityQueryRunner``-style, bad lines
skipped), line-based socket text streams (``MobilityRunner.java:14-73``)
and the seeded synthetic GPS rate source (``sncb/tests/
SyntheticGpsSource.java:8-57``). Every source is a plain Python iterator
of spatial objects or events; the window assemblers consume them.
"""

from __future__ import annotations

import socket
import time
from typing import Callable, Iterable, Iterator, Optional, TypeVar

import numpy as np

from spatialflink_tpu_torch.models.objects import Point

T = TypeVar("T")


def collection_source(items: Iterable[T]) -> Iterator[T]:
    """In-memory fixture source (env.fromCollection in LocalTestRunner)."""
    yield from items


def csv_source(
    path: str,
    parser: Callable[[str], T],
    skip_header: bool = False,
    limit: Optional[int] = None,
) -> Iterator[T]:
    """Replay a CSV/TSV file through a line parser, skipping bad lines
    (the reference's runners skip unparseable rows)."""
    n = 0
    with open(path, "r") as f:
        for i, line in enumerate(f):
            if skip_header and i == 0:
                continue
            line = line.strip()
            if not line:
                continue
            try:
                yield parser(line)
            except (ValueError, IndexError):
                continue
            n += 1
            if limit is not None and n >= limit:
                return


def socket_source(
    host: str, port: int, parser: Callable[[str], T], encoding: str = "utf-8"
) -> Iterator[T]:
    """Line-based TCP client source (socketTextStream analog,
    MobilityRunner.java:20). Yields parsed records until the peer closes."""
    with socket.create_connection((host, port)) as sock:
        buf = b""
        while True:
            chunk = sock.recv(65536)
            if not chunk:
                break
            buf += chunk
            while b"\n" in buf:
                line, buf = buf.split(b"\n", 1)
                text = line.decode(encoding).strip()
                if not text:
                    continue
                try:
                    yield parser(text)
                except (ValueError, IndexError):
                    continue


class SyntheticGpsSource:
    """Deterministic synthetic GPS event source.

    Mirrors the contract of ``sncb/tests/SyntheticGpsSource.java``:
    seeded RNG (42), bbox-uniform positions, ``num_devices`` round-robin
    device ids, a target events-per-second rate and a fixed duration.
    ``realtime=False`` (default) emits as fast as possible with synthetic
    event times advancing at the target rate — the deterministic benchmark
    mode; ``realtime=True`` rate-limits against the wall clock in ≤1000
    event batches like the reference (SyntheticGpsSource.java:22-53).
    """

    def __init__(
        self,
        min_x: float,
        max_x: float,
        min_y: float,
        max_y: float,
        target_eps: int = 20_000,
        duration_ms: int = 30_000,
        num_devices: int = 10,
        seed: int = 42,
        start_ts: int = 0,
        realtime: bool = False,
        make_event: Optional[Callable[..., T]] = None,
    ):
        self.bbox = (min_x, max_x, min_y, max_y)
        self.target_eps = int(target_eps)
        self.duration_ms = int(duration_ms)
        self.num_devices = int(num_devices)
        self.seed = seed
        self.start_ts = int(start_ts)
        self.realtime = realtime
        self.make_event = make_event

    @property
    def total_events(self) -> int:
        return self.target_eps * self.duration_ms // 1000

    def __iter__(self):
        rng = np.random.default_rng(self.seed)
        n = self.total_events
        min_x, max_x, min_y, max_y = self.bbox
        xs = rng.uniform(min_x, max_x, n)
        ys = rng.uniform(min_y, max_y, n)
        speeds = rng.uniform(0.0, 120.0, n)
        # Event times advance uniformly at the target rate.
        ts = self.start_ts + (np.arange(n, dtype=np.int64) * 1000) // self.target_eps
        t_wall = time.time()
        for i in range(n):
            if self.realtime and i % 1000 == 0:
                expect = i / self.target_eps
                ahead = expect - (time.time() - t_wall)
                if ahead > 0:
                    time.sleep(ahead)
            dev = f"dev{i % self.num_devices}"
            if self.make_event is not None:
                yield self.make_event(
                    device_id=dev, x=float(xs[i]), y=float(ys[i]),
                    timestamp=int(ts[i]), speed=float(speeds[i]),
                )
            else:
                yield Point(
                    obj_id=dev, timestamp=int(ts[i]), x=float(xs[i]), y=float(ys[i]),
                    ingestion_time=time.time(),
                )
