"""Overload control: graceful degradation under sustained bursts.

The driver's pull loop has no channel credits to exhaust (the reference
inherits Flink's credit-based backpressure), so load it cannot drain
shows up as unbounded watermark lag. This layer turns that into
explicit, bounded behaviour, in four parts, all opt-in: with no
controller installed every hook is one global read and a ``None`` check,
and the run is the one without overload control. The semantics are the
JAX package's ``spatialflink_tpu/overload.py``, transition for
transition and counter for counter.

- **Bounded admission** (:meth:`OverloadController.admit_item`): an
  event and byte budget on the ingest burst between window firings.
  Replayable sources get BACKPRESSURE (the data is safe at the source;
  ``overload_backpressure:engaged``/``released``); non-replayable ones
  SPILL to a counted shed path (``snapshot()["overload"]``).
- **Watermark-aware load shedding**: past ``lag_shed_ceiling_ms`` of
  fired-window lag the controller sheds LATE events first, escalating to
  OLDEST-first when the lag keeps growing; ``lag_recover_ms`` ends it.
  Every trigger is event-time or count based, so a fixed stream sheds
  deterministically and a killed shedding run resumes byte-identically.
- **Degradation ladder**: rungs stepped DOWN by live SLO violations
  (``slo.py`` calls :func:`on_slo_evaluation`) or the controller's own
  shed and backpressure transitions, and back UP after ``recover_after``
  healthy fired windows. Every rung preserves results:

  - ``{"action": "clamp_compaction", "cap": N}``: floor the live-slot
    capacity pick (``ops/compaction.py:pick_capacity``) at ``cap``, 0 =
    the top rung;
  - ``{"action": "batch_slides", "n": N}``: ``run_wire_panes`` fetches N
    windows' results in one device→host copy;
  - ``{"action": "pane_backend", "to": ...}``: bias the ``backend="auto"``
    pane engines toward the host, as in the JAX package:
    ``traj_stats_sliding`` takes the native engine (the numpy one where
    the native library is unavailable), and ``TJoinQuery.run_soa_panes``
    takes the native engine under a ``"native"`` rung (the device engine
    where the library is unavailable: a rung never becomes a crash).

- **Device-path circuit breaker** (:class:`CircuitBreaker`): after
  ``breaker_failures`` consecutive window failures, or a degraded
  ``LinkProbe`` bandwidth ratio, whole windows route to the numpy twin
  with no device attempt; every ``breaker_probe_every``-th such window
  half-opens the circuit for one probe, whose success closes it, so the
  device path comes back mid-run. Routed windows are counted
  (``degraded_windows``, ``circuit_*`` events) and happen only under a
  configured policy.

:func:`install` puts one controller in the module slot; the window fire
sites (``streams/windows.py``, ``streams/soa.py``) feed
:func:`on_window_fired`; the driver threads admission, the breaker and
the checkpoint state; ``telemetry.snapshot()["overload"]`` carries the
counters. The ``overload.admit`` fault point lives in the admit path.

``python -m spatialflink_tpu_torch.overload --smoke [--device cpu]`` is
the self-test: a toy burst past a tiny admission budget must shed
deterministically, step the ladder down and back up, carry the budgets
through the SLO verdict and seal every transition in the ledger stream.
It runs on the card unless ``--device cpu`` is given.
"""

from __future__ import annotations

import json
import os
import threading
from dataclasses import dataclass, fields
from typing import Any, Dict, Optional, Tuple

from spatialflink_tpu_torch.faults import faults
from spatialflink_tpu_torch.telemetry import telemetry

#: Snapshot-block schema version (``snapshot()["overload"]["version"]``).
OVERLOAD_VERSION = 1

#: Ladder rung actions. Parsing an unknown action raises: a typo'd rung
#: that silently never engages is the worst failure a ladder can have.
RUNG_ACTIONS = ("clamp_compaction", "batch_slides", "pane_backend")

_RUNG_KEYS = {
    "clamp_compaction": {"action", "cap"},
    "batch_slides": {"action", "n"},
    "pane_backend": {"action", "to"},
}

#: Per-tenant-class budget keys (``OverloadPolicy.tenant_budgets``):
#: ``max_queries`` bounds the standing queries a class keeps registered,
#: ``max_results_per_window`` the result rows it emits per fired window.
#: Tenant sheds never feed the global ladder: a class over its budget
#: degrades itself only.
TENANT_BUDGET_KEYS = ("max_queries", "max_results_per_window")


def validate_budget_map(tb, keys, what: str = "tenant_budgets"):
    """Strict parse of a ``{class: {budget-key: int}}`` map, the one home
    of the validation ``OverloadPolicy.tenant_budgets`` and
    ``slo.SloSpec``'s budget maps share. Unknown keys and
    non-int, negative or bool values raise at parse time."""
    if tb is None:
        return None
    if not isinstance(tb, dict):
        raise ValueError(f"{what} must be an object, got {tb!r}")
    out = {}
    for cls, b in tb.items():
        if not isinstance(b, dict):
            raise ValueError(f"{what}[{cls!r}] is not an object: {b!r}")
        unknown = sorted(set(b) - set(keys))
        if unknown:
            raise ValueError(
                f"{what}[{cls!r}] has unknown keys {unknown} "
                f"(keys: {tuple(keys)})"
            )
        for key, v in b.items():
            if not isinstance(v, int) or isinstance(v, bool) or v < 0:
                raise ValueError(
                    f"{what}[{cls!r}].{key} must be a "
                    f"non-negative int, got {v!r}"
                )
        out[str(cls)] = dict(b)
    return out


def _parse_tenant_budgets(tb):
    return validate_budget_map(tb, TENANT_BUDGET_KEYS)


def _parse_ladder(ladder) -> Tuple[Dict[str, Any], ...]:
    if ladder is None:
        return ()
    out = []
    for i, rung in enumerate(ladder):
        if not isinstance(rung, dict):
            raise ValueError(f"ladder rung #{i} is not an object: {rung!r}")
        action = rung.get("action")
        if action not in RUNG_ACTIONS:
            raise ValueError(
                f"ladder rung #{i} has unknown action {action!r} "
                f"(actions: {RUNG_ACTIONS})"
            )
        unknown = sorted(set(rung) - _RUNG_KEYS[action])
        if unknown:
            raise ValueError(
                f"ladder rung #{i} ({action}) has unknown keys {unknown}"
            )
        # Values are checked at parse time too: a typo would otherwise be
        # a silent no-op rung or a crash at the first step-down.
        if action == "pane_backend":
            to = rung.get("to", "native")
            if to not in ("native", "numpy"):
                raise ValueError(
                    f"ladder rung #{i} (pane_backend) has unknown "
                    f"target {to!r} (targets: native, numpy)"
                )
        elif action == "clamp_compaction":
            cap = rung.get("cap", 0)
            if not isinstance(cap, int) or isinstance(cap, bool) or cap < 0:
                raise ValueError(
                    f"ladder rung #{i} (clamp_compaction) cap must be a "
                    f"non-negative int, got {cap!r}"
                )
        elif action == "batch_slides":
            n = rung.get("n", 4)
            if not isinstance(n, int) or isinstance(n, bool) or n < 1:
                raise ValueError(
                    f"ladder rung #{i} (batch_slides) n must be a "
                    f"positive int, got {n!r}"
                )
        out.append(dict(rung))
    return tuple(out)


@dataclass(frozen=True)
class OverloadPolicy:
    """Declarative overload policy; ``None`` disables a control.

    - ``max_buffered_events`` / ``max_buffered_bytes``: admission budget
      on the ingest burst, the events (bytes, for SoA chunks) arriving
      within one ``admission_window_ms`` event-time horizon or between
      two window firings, whichever drains first. The event-time horizon
      makes shedding self-recovering: shed events never advance the
      watermark, so a fires-only reset would starve forever;
    - ``lag_shed_ceiling_ms``: fired-window lag that enters shed mode;
      ``lag_recover_ms`` leaves it (default ``ceiling // 2``);
    - ``shed_oldest_after_windows``: fired windows still over the
      ceiling before late-first shedding escalates to oldest-first;
    - ``ladder``: degradation rungs, mildest first (module doc);
    - ``degrade_cooldown`` / ``recover_after``: unhealthy observations
      between step-downs / consecutive healthy fired windows before a
      step-up;
    - ``breaker_failures``: consecutive window failures that open the
      device-path circuit (0 disables it: the driver keeps its permanent
      failover);
    - ``breaker_probe_every``: fallback windows between half-open probes;
    - ``breaker_link_ratio``: ``LinkProbe`` bandwidth ratio (last / p50)
      below which the circuit opens preemptively;
    - ``tenant_budgets``: ``{class: {"max_queries": N,
      "max_results_per_window": M}}``, counted per class
      (``snapshot()["tenants"]``).
    """

    max_buffered_events: Optional[int] = None
    max_buffered_bytes: Optional[int] = None
    admission_window_ms: int = 1000
    lag_shed_ceiling_ms: Optional[int] = None
    lag_recover_ms: Optional[int] = None
    shed_oldest_after_windows: int = 2
    ladder: Tuple[Dict[str, Any], ...] = ()
    degrade_cooldown: int = 2
    recover_after: int = 5
    breaker_failures: int = 0
    breaker_probe_every: int = 8
    breaker_link_ratio: Optional[float] = None
    tenant_budgets: Optional[Dict[str, Dict[str, int]]] = None

    def __post_init__(self):
        object.__setattr__(self, "ladder", _parse_ladder(self.ladder))
        object.__setattr__(
            self, "tenant_budgets",
            _parse_tenant_budgets(self.tenant_budgets),
        )

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "OverloadPolicy":
        """Strict parse: unknown keys raise."""
        d = dict(d)
        ver = d.pop("overload_version", OVERLOAD_VERSION)
        if ver != OVERLOAD_VERSION:
            raise ValueError(
                f"overload_version {ver} != supported {OVERLOAD_VERSION}"
            )
        known = {f.name for f in fields(cls)}
        unknown = sorted(set(d) - known)
        if unknown:
            raise ValueError(f"unknown overload policy keys: {unknown}")
        return cls(**d)

    @classmethod
    def from_env(cls, spec: str) -> "OverloadPolicy":
        """``SFT_OVERLOAD_POLICY``: inline JSON or a path to a JSON file
        (the ``SFT_FAULT_PLAN`` convention)."""
        text = spec.strip()
        if not text.startswith("{"):
            with open(text) as f:
                text = f.read()
        return cls.from_dict(json.loads(text))

    def to_dict(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {"overload_version": OVERLOAD_VERSION}
        for f in fields(self):
            v = getattr(self, f.name)
            out[f.name] = list(v) if f.name == "ladder" else v
        return out


class CircuitBreaker:
    """Device-path circuit: closed → (consecutive failures | degraded
    link) → open → (half-open probe success) → closed.

    The driver calls :meth:`route` once a window: "device" runs the
    normal path, "fallback" skips it (no retry, no timeout), "probe"
    grants one device attempt. The state is not checkpointed: device
    health belongs to the process, not to the stream position.
    """

    def __init__(self, policy: OverloadPolicy, tel=telemetry):
        self.policy = policy
        self.tel = tel
        self.state = "closed"
        self.consecutive_failures = 0
        self.opens = 0
        self.probes = 0
        self._fallback_windows = 0  # since the circuit last opened
        # LinkProbe sample count at the last probe-success close: the
        # ratio check re-arms only on a fresher sample, or a stale
        # degraded sample would re-open the circuit the probe just closed.
        self._link_samples_seen = 0

    def route(self) -> str:
        if self.state == "closed":
            ratio = self.policy.breaker_link_ratio
            if ratio is not None:
                link = self.tel.link_gauges()
                if (link and link.get("roundtrip_mbps_p50")
                        and int(link.get("samples", 0))
                        > self._link_samples_seen):
                    r = (link["roundtrip_mbps_last"]
                         / link["roundtrip_mbps_p50"])
                    if r < ratio:
                        self._open(f"link degraded (ratio {float(r):.3f} "
                                   f"< {float(ratio):g})")
                        return "fallback"
            return "device"
        # Open: every breaker_probe_every-th fallback window half-opens
        # for one probe (count based: bounded and replayable).
        self._fallback_windows += 1
        if self._fallback_windows % max(1, self.policy.breaker_probe_every) \
                == 0:
            self.probes += 1
            self.state = "half_open"
            self.tel.emit_instant("circuit_half_open",
                                  probe=int(self.probes))
            return "probe"
        return "fallback"

    def record_success(self):
        if self.state == "half_open":
            self.state = "closed"
            link = self.tel.link_gauges()
            self._link_samples_seen = int(link["samples"]) if link else 0
            self.tel.emit_instant("circuit_closed", probe=int(self.probes))
            self.tel.maybe_flush_stream(force=True)
        self.consecutive_failures = 0

    def record_failure(self, window_start: int = 0, error: str = ""):
        if self.state == "half_open":
            # The probe failed: back to open; the next probe is scheduled.
            self.state = "open"
            self.tel.emit_instant(
                "circuit_open", reason="probe failed",
                window_start=int(window_start), error=str(error)[:200],
            )
            self.tel.maybe_flush_stream(force=True)
            return
        self.consecutive_failures += 1
        # breaker_failures == 0 disables count-based opening (a
        # link-ratio-only policy still has a breaker).
        if self.state == "closed" and self.policy.breaker_failures > 0 \
                and self.consecutive_failures >= self.policy.breaker_failures:
            self._open(f"{int(self.consecutive_failures)} consecutive "
                       f"window failures", window_start, error)

    def _open(self, reason: str, window_start: int = 0, error: str = ""):
        self.state = "open"
        self.opens += 1
        self._fallback_windows = 0
        self.tel.emit_instant(
            "circuit_open", reason=reason, window_start=int(window_start),
            error=str(error)[:200],
        )
        self.tel.maybe_flush_stream(force=True)

    def snapshot(self) -> Dict[str, Any]:
        return {
            "state": self.state,
            "opens": int(self.opens),
            "probes": int(self.probes),
            "consecutive_failures": int(self.consecutive_failures),
        }


def _measure_item(item) -> Tuple[Optional[int], int, int]:
    """(max event ts | None, n_events, nbytes) of one ingest item: an
    object event (``.timestamp``) or a SoA chunk (dict of arrays).
    Control-plane items (``control_plane`` true, such as standing-query
    registrations) measure as zero events: they are commands, not load."""
    if getattr(item, "control_plane", False):
        return None, 0, 0
    ts = getattr(item, "timestamp", None)
    if ts is not None:
        return int(ts), 1, 0
    if isinstance(item, dict) and "ts" in item:
        import numpy as np

        t = np.asarray(item["ts"])
        if len(t) == 0:
            return None, 0, 0
        nbytes = sum(
            np.asarray(v).nbytes for v in item.values()
            if hasattr(v, "__len__")
        )
        return int(t.max()), int(len(t)), int(nbytes)
    return None, 1, 0


class OverloadController:
    """One policy's live state: the admission backlog, the shed counters,
    the degradation rung and, optionally, the circuit breaker.

    Counter updates take the lock; the module-level hooks cost one global
    read when no controller is installed.
    """

    def __init__(self, policy: OverloadPolicy, tel=telemetry):
        self.policy = policy
        self.tel = tel
        # Telemetry's stream checkpoint calls back into snapshot() under
        # telemetry's lock, so transition events and shed charges are
        # queued under this lock and sent after it is released: neither
        # lock is ever taken while the other is held.
        self._lock = threading.RLock()
        self._pending_emits: list = []
        self._pending_sheds: list = []
        self.breaker = (CircuitBreaker(policy, tel)
                        if policy.breaker_failures > 0
                        or policy.breaker_link_ratio is not None else None)
        # The admission backlog: the current burst, bounded in event time
        # by admission_window_ms and drained early by window fires.
        self._backlog_events = 0
        self._backlog_bytes = 0
        self._backlog_start_ts: Optional[int] = None
        self._backpressured = False
        self.backpressure_engaged = 0
        # Shed counters by reason → {"events", "bytes"}.
        self.shed: Dict[str, Dict[str, int]] = {}
        self._admission_shedding = False
        self._sheds_since_fire = 0
        # Watermark-aware shed mode.
        self._max_ts: Optional[int] = None
        self._last_window_end: Optional[int] = None
        self._slide_ms = 0  # learned from consecutive fired ends
        self._shedding = False
        self._shed_oldest = False
        self._shed_windows = 0  # fired windows while in shed mode
        # Per-tenant-class QoS: class → counters, kept apart from the
        # global health machinery.
        self.tenant: Dict[str, Dict[str, int]] = {}
        self._tenant_shedding: set = set()
        self._tenant_shed_this_window: set = set()
        # class → (window_start, last results charge): the retry
        # idempotence marker of tenant_result_allowance.
        self._tenant_window_charge: Dict[str, Tuple[int, int]] = {}
        # The degradation ladder.
        self.rung = 0
        self.rung_transitions = 0
        self._unhealthy_streak = 0
        self._healthy_streak = 0
        self._apply_effects()
        # Windows answered by a non-device path (breaker routing or after
        # a failover): the SLO degraded_window_budget.
        self.degraded_windows = 0

    # -- admission + shedding --------------------------------------------------

    def admit_item(self, item, pausable: bool = True) -> bool:
        """One ingest item at the source→assembler boundary (the driver
        calls this). False means the item is SHED: the caller skips it,
        still counting it consumed, for resume determinism."""
        if faults.armed:  # fault injection point (faults.py)
            faults.hit("overload.admit")
        ts, n_events, nbytes = _measure_item(item)
        if n_events == 0:
            return True
        try:
            return self._admit_locked(ts, n_events, nbytes, pausable)
        finally:
            self._drain_emits()

    def _admit_locked(self, ts, n_events, nbytes, pausable) -> bool:
        with self._lock:
            if ts is not None and (self._max_ts is None
                                   or ts > self._max_ts):
                self._max_ts = ts
            # Shed mode. Oldest-first, the wider horizon, is classified
            # first: events for the already-behind oldest open windows
            # (up to one learned slide past the last fired end). Late-
            # first is the base tier: stragglers behind the stream head.
            if self._shedding and ts is not None:
                if self._shed_oldest and self._last_window_end is not None \
                        and ts <= self._last_window_end + self._slide_ms:
                    return not self._shed_locked("oldest", n_events, nbytes)
                if self._max_ts is not None and ts < self._max_ts:
                    return not self._shed_locked("late", n_events, nbytes)
            # Bounded admission on the current burst, whose horizon is
            # event time: once the head passes the burst's start by
            # admission_window_ms, a new burst begins.
            if ts is not None and (
                    self._backlog_start_ts is None
                    or ts > self._backlog_start_ts
                    + self.policy.admission_window_ms):
                self._backlog_start_ts = ts
                self._backlog_events = 0
                self._backlog_bytes = 0
            self._backlog_events += n_events
            self._backlog_bytes += nbytes
            pol = self.policy
            over = (
                (pol.max_buffered_events is not None
                 and self._backlog_events > pol.max_buffered_events)
                or (pol.max_buffered_bytes is not None
                    and self._backlog_bytes > pol.max_buffered_bytes)
            )
            if not over:
                return True
            if pausable:
                # Replayable source: signal backpressure (a transition,
                # not one event per item) and admit.
                if not self._backpressured:
                    self._backpressured = True
                    self.backpressure_engaged += 1
                    self._emit_locked("overload_backpressure:engaged",
                                      events=int(self._backlog_events),
                                      bytes=int(self._backlog_bytes))
                    self._observe_health_locked(False)
                return True
            # Non-replayable source: spill to the counted shed path.
            self._backlog_events -= n_events
            self._backlog_bytes -= nbytes
            return not self._shed_locked("admission", n_events, nbytes)

    def _shed_locked(self, reason: str, n_events: int, nbytes: int) -> bool:
        rec = self.shed.setdefault(reason, {"events": 0, "bytes": 0})
        rec["events"] += int(n_events)
        rec["bytes"] += int(nbytes)
        self._pending_sheds.append((int(n_events), int(nbytes)))
        self._sheds_since_fire += 1
        if reason == "admission" and not self._admission_shedding:
            self._admission_shedding = True
            self._emit_locked("overload_shedding:admission",
                              events=int(n_events))
            self._observe_health_locked(False)
        return True

    @property
    def shed_total(self) -> int:
        with self._lock:
            return sum(r["events"] for r in self.shed.values())

    # -- per-tenant-class QoS --------------------------------------------------

    def _tenant_rec_locked(self, cls: str) -> Dict[str, int]:
        return self.tenant.setdefault(str(cls), {
            "queries_live": 0, "queries_shed": 0,
            "results_shed": 0, "degraded_windows": 0,
        })

    def _tenant_budget(self, cls: str) -> Optional[Dict[str, int]]:
        return (self.policy.tenant_budgets or {}).get(str(cls))

    def admit_tenant_query(self, cls: str) -> bool:
        """One standing-query registration for class ``cls``. False: the
        class is at its ``max_queries`` budget; the registration is
        rejected and counted against the class (``queries_shed``)."""
        try:
            with self._lock:
                rec = self._tenant_rec_locked(cls)
                b = self._tenant_budget(cls)
                limit = None if b is None else b.get("max_queries")
                if limit is not None and rec["queries_live"] >= limit:
                    rec["queries_shed"] += 1
                    self._pending_sheds.append((1, 0))
                    self._tenant_shed_this_window.add(str(cls))
                    if cls not in self._tenant_shedding:
                        self._tenant_shedding.add(str(cls))
                        self._emit_locked(f"overload_tenant_shed:{cls}",
                                          control="queries",
                                          limit=int(limit))
                    return False
                rec["queries_live"] += 1
                return True
        finally:
            self._drain_emits()

    def release_tenant_query(self, cls: str):
        """One standing-query unregistration for class ``cls``."""
        with self._lock:
            rec = self._tenant_rec_locked(cls)
            rec["queries_live"] = max(0, rec["queries_live"] - 1)

    def tenant_result_allowance(self, cls: str, n: int,
                                window_start: Optional[int] = None) -> int:
        """Result rows class ``cls`` may emit this window: ``n`` under its
        ``max_results_per_window`` budget, else the budget, the excess
        counted as ``results_shed`` and the window as a class-degraded
        window. ``window_start`` makes the charge retry-idempotent: a
        second charge of the same (class, window) replaces the first."""
        try:
            with self._lock:
                rec = self._tenant_rec_locked(cls)
                b = self._tenant_budget(cls)
                limit = (None if b is None
                         else b.get("max_results_per_window"))
                if limit is None or n <= limit:
                    return int(n)
                shed = int(n) - int(limit)
                shed_delta = shed  # the telemetry twin's charge
                if window_start is not None:
                    prev = self._tenant_window_charge.get(str(cls))
                    if prev is not None and prev[0] == int(window_start):
                        rec["results_shed"] -= prev[1]
                        rec["degraded_windows"] -= 1
                        # The twin replaces too: queue the net delta.
                        shed_delta = shed - prev[1]
                    self._tenant_window_charge[str(cls)] = (
                        int(window_start), shed,
                    )
                rec["results_shed"] += shed
                if shed_delta:
                    self._pending_sheds.append((shed_delta, 0))
                rec["degraded_windows"] += 1
                self._tenant_shed_this_window.add(str(cls))
                if cls not in self._tenant_shedding:
                    self._tenant_shedding.add(str(cls))
                    self._emit_locked(f"overload_tenant_shed:{cls}",
                                      control="results",
                                      limit=int(limit))
                return int(limit)
        finally:
            self._drain_emits()

    def tenant_shed_total(self, cls: str) -> int:
        """Queries rejected plus result rows shed for class ``cls`` (0 for
        an unseen class)."""
        with self._lock:
            rec = self.tenant.get(str(cls))
            return 0 if rec is None \
                else rec["queries_shed"] + rec["results_shed"]

    def tenant_degraded_windows(self, cls: str) -> int:
        with self._lock:
            rec = self.tenant.get(str(cls))
            return 0 if rec is None else rec["degraded_windows"]

    # -- window-fire hook ------------------------------------------------------

    def on_window_fired(self, n_events: int = 0,
                        lag_ms: Optional[float] = None,
                        end: Optional[int] = None):
        """Every fired window: drain the admission burst, run the lag
        shed-mode state machine and feed the ladder a health sample."""
        try:
            self._on_window_fired_locked(n_events, lag_ms, end)
        finally:
            self._drain_emits()

    def _on_window_fired_locked(self, n_events, lag_ms, end):
        pol = self.policy
        with self._lock:
            self._backlog_events = 0
            self._backlog_bytes = 0
            self._backlog_start_ts = None
            if end is not None:
                if self._last_window_end is not None \
                        and end > self._last_window_end:
                    self._slide_ms = int(end) - self._last_window_end
                self._last_window_end = int(end)
            # The cycle's distress is read before the per-fire resets: the
            # health sample must see what happened since the last fire.
            was_backpressured = self._backpressured
            shed_this_cycle = self._sheds_since_fire > 0
            if self._backpressured:
                self._backpressured = False
                self._emit_locked("overload_backpressure:released")
            if self._admission_shedding and self._sheds_since_fire == 0:
                self._admission_shedding = False
                self._emit_locked("overload_recovered:admission")
            self._sheds_since_fire = 0
            # A class that shed nothing since the last fire leaves shed
            # mode; the global health sample never sees tenant sheds.
            for cls in sorted(self._tenant_shedding
                              - self._tenant_shed_this_window):
                self._tenant_shedding.discard(cls)
                self._emit_locked(f"overload_tenant_recovered:{cls}")
            self._tenant_shed_this_window = set()
            lag_ok = True
            if pol.lag_shed_ceiling_ms is not None and lag_ms is not None:
                ceiling = pol.lag_shed_ceiling_ms
                recover = (pol.lag_recover_ms if pol.lag_recover_ms
                           is not None else ceiling // 2)
                if not self._shedding and lag_ms > ceiling:
                    self._shedding = True
                    self._shed_windows = 0
                    self._emit_locked("overload_shedding:lag",
                                      lag_ms=float(lag_ms),
                                      ceiling_ms=float(ceiling))
                elif self._shedding:
                    self._shed_windows += 1
                    if lag_ms <= recover:
                        self._shedding = False
                        self._shed_oldest = False
                        self._emit_locked("overload_recovered:lag",
                                          lag_ms=float(lag_ms))
                    elif (not self._shed_oldest and lag_ms > ceiling
                          and self._shed_windows
                          >= pol.shed_oldest_after_windows):
                        # Late-first did not catch the lag up: escalate.
                        self._shed_oldest = True
                        self._emit_locked("overload_shedding:oldest",
                                          lag_ms=float(lag_ms))
                lag_ok = lag_ms <= recover
            if self._shedding or shed_this_cycle or was_backpressured:
                self._observe_health_locked(False)
            elif lag_ok:
                self._observe_health_locked(True)
            else:
                # Mid-band lag (recover < lag <= ceiling, no shed mode): no
                # step-down trigger, but no recovery either.
                self._healthy_streak = 0

    # -- degradation ladder ----------------------------------------------------

    def on_slo_evaluation(self, ok: bool):
        """Live SLO verdict hook (``slo.SloEngine.evaluate``): a violating
        evaluation is an unhealthy observation. Healthy evaluations do not
        step up: recovery is counted in fired windows."""
        if not ok:
            with self._lock:
                self._observe_health_locked(False)
            self._drain_emits()

    def _observe_health_locked(self, healthy: bool):
        pol = self.policy
        if healthy:
            self._unhealthy_streak = 0
            self._healthy_streak += 1
            if self.rung > 0 and self._healthy_streak >= pol.recover_after:
                self._healthy_streak = 0
                self.rung -= 1
                self.rung_transitions += 1
                restored = pol.ladder[self.rung]["action"]
                self._apply_effects()
                self._emit_locked(f"overload_rung_up:{restored}",
                                  rung=int(self.rung))
            return
        self._healthy_streak = 0
        self._unhealthy_streak += 1
        if self.rung < len(pol.ladder) \
                and self._unhealthy_streak >= pol.degrade_cooldown:
            self._unhealthy_streak = 0
            action = pol.ladder[self.rung]["action"]
            self.rung += 1
            self.rung_transitions += 1
            self._apply_effects()
            self._emit_locked(f"overload_rung_down:{action}",
                              rung=int(self.rung))

    def _apply_effects(self):
        """The active rung effects (rungs 1..current are cumulative), read
        by the hot paths through the module-level getters."""
        clamp = None
        backend = None
        slides = 1
        for rung in self.policy.ladder[: self.rung]:
            action = rung["action"]
            if action == "clamp_compaction":
                clamp = int(rung.get("cap", 0))
            elif action == "batch_slides":
                slides = max(1, int(rung.get("n", 4)))
            elif action == "pane_backend":
                backend = str(rung.get("to", "native"))
        self.effect_compaction_clamp = clamp
        self.effect_pane_backend = backend
        self.effect_batch_slides = slides

    # -- driver integration ----------------------------------------------------

    def count_degraded_window(self):
        with self._lock:
            self.degraded_windows += 1

    # -- telemetry / persistence ----------------------------------------------

    def _emit_locked(self, name: str, **args):
        """Queue one transition event (the caller holds the lock); the
        public entry points drain the queue after releasing it, and the
        drain force-flushes the ledger stream."""
        self._pending_emits.append((name, args))

    def _drain_emits(self):
        while True:
            with self._lock:
                sheds, self._pending_sheds = self._pending_sheds, []
            for n_events, nbytes in sheds:
                # Outside our lock: record_shed takes telemetry's.
                self.tel.record_shed(n_events, nbytes)
            with self._lock:
                if not self._pending_emits:
                    if self._pending_sheds:
                        continue  # a shed raced in; drain again
                    return
                name, args = self._pending_emits.pop(0)
            if self.tel.enabled:
                self.tel.emit_instant(name, **args)
                self.tel.maybe_flush_stream(force=True)

    def snapshot(self) -> Dict[str, Any]:
        """The ``snapshot()["overload"]`` block (installed as telemetry's
        ``overload_provider``)."""
        with self._lock:
            out: Dict[str, Any] = {
                "version": OVERLOAD_VERSION,
                "shed": {k: dict(v) for k, v in sorted(self.shed.items())},
                "shed_total": sum(r["events"] for r in self.shed.values()),
                "degraded_windows": int(self.degraded_windows),
                "backpressure_engaged": int(self.backpressure_engaged),
                "shedding": bool(self._shedding),
                "rung": int(self.rung),
                "ladder_depth": len(self.policy.ladder),
                "rung_transitions": int(self.rung_transitions),
                # Always present, possibly empty.
                "tenants": {cls: dict(rec)
                            for cls, rec in sorted(self.tenant.items())},
            }
        if self.breaker is not None:
            out["breaker"] = self.breaker.snapshot()
        return out

    def state(self) -> Dict[str, Any]:
        """Checkpointable state: everything a resume needs to replay the
        exact shed schedule of an uninterrupted run. Breaker state is
        left out: device health belongs to the process."""
        with self._lock:
            return {
                "shed": {k: dict(v) for k, v in self.shed.items()},
                "max_ts": self._max_ts,
                "last_window_end": self._last_window_end,
                "slide_ms": self._slide_ms,
                "shedding": self._shedding,
                "shed_oldest": self._shed_oldest,
                "shed_windows": self._shed_windows,
                "admission_shedding": self._admission_shedding,
                "backlog_events": self._backlog_events,
                "backlog_bytes": self._backlog_bytes,
                "backlog_start_ts": self._backlog_start_ts,
                "degraded_windows": self.degraded_windows,
                "backpressure_engaged": self.backpressure_engaged,
                "rung": self.rung,
                "rung_transitions": self.rung_transitions,
                "tenant": {cls: dict(rec)
                           for cls, rec in self.tenant.items()},
                "tenant_shedding": sorted(self._tenant_shedding),
                "tenant_window_charge": {
                    cls: [int(w), int(c)]
                    for cls, (w, c) in self._tenant_window_charge.items()
                },
            }

    def restore(self, state: Dict[str, Any]):
        with self._lock:
            self.shed = {k: dict(v) for k, v in state["shed"].items()}
            self._max_ts = state["max_ts"]
            self._last_window_end = state["last_window_end"]
            self._slide_ms = int(state.get("slide_ms", 0))
            self._shedding = bool(state["shedding"])
            self._shed_oldest = bool(state["shed_oldest"])
            self._shed_windows = int(state["shed_windows"])
            self._admission_shedding = bool(state["admission_shedding"])
            self._backlog_events = int(state["backlog_events"])
            self._backlog_bytes = int(state["backlog_bytes"])
            self._backlog_start_ts = state.get("backlog_start_ts")
            self.degraded_windows = int(state["degraded_windows"])
            self.backpressure_engaged = int(state["backpressure_engaged"])
            self.rung = int(state["rung"])
            self.rung_transitions = int(state["rung_transitions"])
            # Checkpoints without a tenant block restore fresh tenants.
            self.tenant = {cls: dict(rec)
                           for cls, rec in state.get("tenant", {}).items()}
            self._tenant_shedding = set(state.get("tenant_shedding", ()))
            self._tenant_shed_this_window = set()
            self._tenant_window_charge = {
                cls: (int(w), int(c))
                for cls, (w, c) in state.get(
                    "tenant_window_charge", {}).items()
            }
            self._apply_effects()


# -- module-level wiring (the telemetry singleton idiom) -----------------------

_controller: Optional[OverloadController] = None


def install(ctrl: OverloadController) -> OverloadController:
    """Make ``ctrl`` the process-global controller: the window-fire sites
    feed it, the hot-path getters read its rung effects, and
    ``telemetry.snapshot()["overload"]`` carries it."""
    global _controller
    _controller = ctrl
    ctrl.tel.overload_provider = ctrl.snapshot
    return ctrl


def uninstall():
    global _controller
    if _controller is not None:
        _controller.tel.overload_provider = None
    _controller = None


def controller() -> Optional[OverloadController]:
    return _controller


def on_window_fired(n_events: int = 0, lag_ms: Optional[float] = None,
                    end: Optional[int] = None):
    """The window-fire hook (``streams/windows.py``, ``streams/soa.py``):
    one global read and a ``None`` check when nothing is installed."""
    ctrl = _controller
    if ctrl is not None:
        ctrl.on_window_fired(n_events, lag_ms, end)


def on_slo_evaluation(ok: bool):
    """``slo.SloEngine.evaluate``'s hook; free when nothing is installed."""
    ctrl = _controller
    if ctrl is not None:
        ctrl.on_slo_evaluation(ok)


def admit_tenant_query(cls: str) -> bool:
    """The standing-query registry's admission hook
    (``qserve.QueryRegistry``): True when no controller is installed."""
    ctrl = _controller
    return True if ctrl is None else ctrl.admit_tenant_query(cls)


def release_tenant_query(cls: str):
    """The standing-query registry's unregistration hook."""
    ctrl = _controller
    if ctrl is not None:
        ctrl.release_tenant_query(cls)


def tenant_result_allowance(cls: str, n: int,
                            window_start: Optional[int] = None) -> int:
    """Result rows class ``cls`` may emit this window (``n`` with no
    controller or no budget)."""
    ctrl = _controller
    return int(n) if ctrl is None else ctrl.tenant_result_allowance(
        cls, n, window_start=window_start)


def compaction_clamp() -> Optional[int]:
    """The active ``clamp_compaction`` floor (None: rung inactive; 0: pin
    the top rung). ``ops/compaction.py:pick_capacity`` reads it."""
    ctrl = _controller
    return None if ctrl is None else ctrl.effect_compaction_clamp


def pane_backend() -> Optional[str]:
    """The active ``pane_backend`` bias of the ``backend="auto"`` pane
    engines (None: rung inactive)."""
    ctrl = _controller
    return None if ctrl is None else ctrl.effect_pane_backend


def batch_slides() -> int:
    """The active ``batch_slides`` fetch width (1: rung inactive)."""
    ctrl = _controller
    return 1 if ctrl is None else ctrl.effect_batch_slides


# ---------------------------------------------------------------------------
# The overload smoke: burst → shed → degrade → recover.


def _smoke_tenant_leg(fail) -> Optional[int]:
    """The per-tenant-class walk (the smoke's second leg, same stream):
    registration rejected at ``max_queries``, retry-idempotent truncation
    at ``max_results_per_window``, class-local accounting (the global
    ladder must not move), recovery on a clean fire and the per-class SLO
    budgets answering. Returns None on success, ``fail(...)`` else."""
    from spatialflink_tpu_torch import slo

    tctrl = install(OverloadController(OverloadPolicy(tenant_budgets={
        "bulk": {"max_queries": 1, "max_results_per_window": 5},
    })))
    slo.install(slo.SloEngine(slo.SloSpec(
        name="overload-smoke-tenants", eval_interval_s=0.0,
        tenant_budgets={"bulk": {"shed_budget": 3,
                                 "degraded_window_budget": 0}},
    )))
    tengine = slo.engine()
    if not tctrl.admit_tenant_query("bulk"):
        return fail("tenant leg: first registration rejected")
    if tctrl.admit_tenant_query("bulk"):
        return fail("tenant leg: budget-exceeding registration admitted")
    kept = tctrl.tenant_result_allowance("bulk", 9, window_start=1000)
    # Re-charging the same window replaces the previous charge.
    kept2 = tctrl.tenant_result_allowance("bulk", 9, window_start=1000)
    if (kept, kept2) != (5, 5):
        return fail(f"tenant leg: allowance ({kept}, {kept2}) != (5, 5)")
    if tctrl.tenant_shed_total("bulk") != 1 + 4:
        return fail(f"tenant leg: shed_total "
                    f"{tctrl.tenant_shed_total('bulk')} != 5 (1 "
                    "rejected query + 4 shed rows, charged once)")
    if tctrl.rung != 0 or tctrl.rung_transitions != 0:
        return fail("tenant leg: class-local sheds moved the GLOBAL "
                    "ladder")
    # The first fire clears the shed-this-window marker; the second,
    # clean, recovers the class.
    tctrl.on_window_fired(n_events=1, lag_ms=0.0, end=2000)
    tctrl.on_window_fired(n_events=1, lag_ms=0.0, end=3000)
    trows = {r["check"]: r for r in tengine.evaluate()}
    srow = trows.get("tenant_shed_budget:bulk")
    drow = trows.get("tenant_degraded_window_budget:bulk")
    if srow is None or srow["ok"] is not False:
        return fail(f"tenant leg: shed-budget row wrong: {srow}")
    if drow is None or drow["ok"] is not False:
        return fail(f"tenant leg: degraded-window row wrong: {drow}")
    return None


def smoke_source():
    """The smoke's stream (the JAX smoke's, event for event): a smooth
    cadence, a 20 s event-time jump (the backlog fires with a huge lag:
    shed mode), out-of-order stragglers (late sheds), a dense burst at
    one timestamp (the admission budget blows), then smooth recovery."""
    import numpy as np

    from spatialflink_tpu_torch.models.objects import Point

    rng = np.random.default_rng(17)
    i = 0

    def pt(ts):
        nonlocal i
        i += 1
        return Point(obj_id=f"o{i % 5}", timestamp=int(ts),
                     x=float(rng.uniform(0, 8)),
                     y=float(rng.uniform(0, 8)))

    for t in range(0, 6000, 200):          # smooth
        yield pt(t)
    yield pt(26_000)                       # the jump
    for t in range(6200, 9000, 100):       # stragglers: late sheds
        yield pt(t)
    for j in range(24):                    # dense burst at one ts
        yield pt(27_000 + j)
    for t in range(28_000, 48_000, 200):   # recovery
        yield pt(t)


def smoke_policy() -> OverloadPolicy:
    return OverloadPolicy(
        max_buffered_events=8,
        lag_shed_ceiling_ms=5_000,
        lag_recover_ms=1_000,
        shed_oldest_after_windows=2,
        ladder=(
            {"action": "clamp_compaction", "cap": 0},
            {"action": "pane_backend", "to": "native"},
        ),
        degrade_cooldown=1,
        recover_after=6,
    )


def smoke(device="cuda") -> int:
    """A deterministic toy burst against a tiny admission budget and a
    low lag ceiling, through ``TStatsQuery.run`` on ``device``: sheds
    must be counted, the ladder must step down and back up, the SLO
    verdict must carry the shed and degradation budgets, and every
    transition must be in the sealed ledger stream. The second leg walks
    the per-tenant-class machinery. Exit 0 on success."""
    import tempfile

    from spatialflink_tpu_torch import slo
    from spatialflink_tpu_torch.driver import (
        RetryPolicy,
        WindowedDataflowDriver,
    )
    from spatialflink_tpu_torch.grid import UniformGrid
    from spatialflink_tpu_torch.operators.query_config import (
        QueryConfiguration,
        QueryType,
    )
    from spatialflink_tpu_torch.operators.trajectory import TStatsQuery

    def fail(msg: str) -> int:
        print(f"overload-smoke: {msg}")
        return 1

    grid = UniformGrid(8, 0.0, 8.0, 0.0, 8.0)
    conf = QueryConfiguration(QueryType.WindowBased, window_size=2.0,
                              slide_step=1.0)
    spec = slo.SloSpec(name="overload-smoke", shed_budget=10_000,
                       degraded_window_budget=0, eval_interval_s=0.0)

    with tempfile.TemporaryDirectory(prefix="sft_overload_") as tmp:
        stream_path = os.path.join(tmp, "smoke.stream.jsonl")
        telemetry.enable(stream_path=stream_path,
                         stream_flush_interval_s=0.0)
        ctrl = install(OverloadController(smoke_policy()))
        engine = slo.install(slo.SloEngine(spec))
        max_rung = 0
        try:
            op = TStatsQuery(conf, grid, device=device)
            driver = WindowedDataflowDriver(
                retry=RetryPolicy(max_retries=0), failover=False,
                overload=ctrl, source_pausable=False,
            )
            for _ in op.run(smoke_source(), driver=driver):
                max_rung = max(max_rung, ctrl.rung)
            verdict = engine.verdict()
            snap = telemetry.snapshot()
            tenant_fail = _smoke_tenant_leg(fail)
            if tenant_fail is not None:
                return tenant_fail
        finally:
            slo.uninstall()
            uninstall()
            telemetry.disable()  # seals the stream

        ov = snap.get("overload")
        if not ov:
            return fail("snapshot() carries no overload block")
        if ov["shed_total"] <= 0 or "late" not in ov["shed"] \
                or "admission" not in ov["shed"]:
            return fail(f"expected late+admission sheds, got {ov['shed']}")
        if max_rung < 1:
            return fail("degradation ladder never stepped down")
        if ctrl.rung != 0:
            return fail(f"ladder did not recover (rung {ctrl.rung})")
        checks = {row["check"] for row in verdict["checks"]}
        if not {"shed_budget", "degraded_window_budget"} <= checks:
            return fail(f"SLO verdict misses overload budgets: {checks}")

        names = []
        sealed = False
        with open(stream_path) as f:
            for line in f:
                rec = json.loads(line)
                if rec.get("t") == "spans":
                    names.extend(e.get("name", "") for e in rec["events"])
                sealed = rec.get("t") == "epilogue"
        want = ("overload_shedding:lag", "overload_shedding:admission",
                "overload_recovered:lag", "overload_rung_down:",
                "overload_rung_up:", "overload_tenant_shed:bulk",
                "overload_tenant_recovered:bulk")
        missing = [w for w in want
                   if not any(n.startswith(w) for n in names)]
        if missing:
            return fail(f"stream misses transition events: {missing}")
        if not sealed:
            return fail("ledger stream was not sealed")

    shed = ", ".join(f"{k}={v['events']}" for k, v in sorted(ov["shed"].items()))
    print(f"overload-smoke: sheds ({shed}), rung peaked at {int(max_rung)} "
          f"and recovered, transitions sealed in the stream on {device} — OK")
    return 0


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        prog="python -m spatialflink_tpu_torch.overload",
        description="overload-control burst/shed/degrade/recover smoke",
    )
    ap.add_argument("--smoke", action="store_true",
                    help="run the deterministic overload round trip")
    ap.add_argument("--device", default="cuda",
                    help="where the pipeline runs: cuda (the default) or "
                         "cpu")
    args = ap.parse_args(argv)
    if args.smoke:
        return smoke(device=args.device)
    ap.error("pass --smoke")
    return 2


if __name__ == "__main__":
    import sys

    # ``python -m`` runs this file as __main__ while the hooks import the
    # package module: delegate so both share one controller slot.
    from spatialflink_tpu_torch.overload import main as _canonical_main

    sys.exit(_canonical_main())
