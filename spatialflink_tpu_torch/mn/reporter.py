"""NES-format periodic stats reporter (``com/mn/metrics/reporter/
NESFileReporter.java:19-105``).

Appends lines of the exact NES shape every interval:

  METRICS ts=<iso-instant> eps_in_avg=<…> eps_out_avg=<…> \
  selectivity_e2e=<…> throughput_mb_s=<…>

to ``EngineStats_<queryId>_proc.stats``. Deltas are computed against the
previous snapshot like the reference's counter-delta logic
(NESFileReporter.java:54-99). ``report()`` can be driven manually (tests,
bounded replays) or by the built-in timer thread. The kernel counters'
``dist_comp_total`` and ``candidate_lanes_total`` append while
``ops/counters.py`` is enabled, and the runtime telemetry columns
(``watermark_lag_ms_max``, ``late_dropped_total``, ``compiles_total``,
``h2d_bytes_total``, ``d2h_bytes_total``) while ``telemetry.py`` is.
"""

from __future__ import annotations

import math
import os
import threading
import time
from datetime import datetime, timezone
from typing import Dict, Optional

from spatialflink_tpu_torch.mn.metrics import MetricNames, MetricRegistry


class NESFileReporter:
    def __init__(
        self,
        registry: MetricRegistry,
        query_id: str,
        out_dir: str = ".",
        interval_s: float = 5.0,
    ):
        self.registry = registry
        self.query_id = query_id
        self.out_dir = out_dir
        self.interval_s = interval_s
        self._last: Dict[str, int] = {}
        # First interval measures from construction (real elapsed time, not
        # a fabricated interval_s).
        self._last_time: float = time.time()
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        os.makedirs(out_dir, exist_ok=True)

    @property
    def stats_path(self) -> str:
        return os.path.join(self.out_dir, f"EngineStats_{self.query_id}_proc.stats")

    def report(self, now: Optional[float] = None) -> str:
        now = time.time() if now is None else now
        interval = max(now - self._last_time, 1e-9)
        self._last_time = now

        # Locked copy: the timer thread must not iterate the dict while
        # operator threads mutate it (mn/metrics.py:MetricRegistry).
        counters = self.registry.snapshot_counters()
        # First report counts everything since start (reference initializes
        # last to the current value on first sight, yielding 0 — we prefer
        # the informative first delta; both converge immediately after).
        def delta(name: str) -> int:
            return counters.get(name, 0) - self._last.get(name, 0)

        d_source = delta(MetricNames.SOURCE_IN)
        d_sink = delta(MetricNames.SINK_OUT)
        d_bytes = delta(MetricNames.OUT_BYTES)
        self._last = counters
        eps_in = d_source / interval
        eps_out = d_sink / interval
        sel = (d_sink / d_source) if d_source > 0 else math.nan
        mbps = d_bytes / interval / 1_000_000.0

        ts = datetime.fromtimestamp(now, tz=timezone.utc).isoformat()
        # float() wraps: numpy ≥2 scalars would print np.float64(…) into
        # the METRICS line (sfcheck fstring-numpy).
        line = (
            f"METRICS ts={ts} eps_in_avg={float(eps_in):.2f} "
            f"eps_out_avg={float(eps_out):.2f} "
            f"selectivity_e2e={float(sel):.4f} "
            f"throughput_mb_s={float(mbps):.4f}"
        )
        # Kernel-level counters (Point.java:220-235 distance-computation
        # analog) append when the global registry is enabled.
        from spatialflink_tpu_torch.ops.counters import counters as opcounters

        if opcounters.enabled:
            line += (
                f" dist_comp_total={opcounters.dist_computations}"
                f" candidate_lanes_total={opcounters.candidate_lanes}"
            )
        # Telemetry columns append while the runtime telemetry layer is
        # enabled: watermark lag and late drops from the window
        # assemblers, distinct shapes from the dispatch table, and the
        # device-boundary bytes from the ship and fetch sites.
        from spatialflink_tpu_torch.telemetry import telemetry

        if telemetry.enabled:
            line += (
                f" watermark_lag_ms_max={telemetry.max_watermark_lag_ms}"
                f" late_dropped_total={telemetry.late_drops}"
                f" compiles_total={telemetry.compile_count}"
                f" h2d_bytes_total={telemetry.h2d_bytes}"
                f" d2h_bytes_total={telemetry.d2h_bytes}"
            )
        with open(self.stats_path, "a") as f:
            f.write(line + "\n")
        return line

    # -- optional timer-thread mode ------------------------------------------

    def start(self):
        if self._thread is not None:
            return
        self._stop.clear()

        def loop():
            while not self._stop.wait(self.interval_s):
                self.report()

        self._thread = threading.Thread(target=loop, daemon=True)
        self._thread.start()

    def stop(self):
        if self._thread is not None:
            self._stop.set()
            self._thread.join(timeout=self.interval_s + 1)
            self._thread = None
