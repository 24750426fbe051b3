"""Online SLO engine: declarative per-run objectives evaluated while the
stream runs.

A declarative :class:`SloSpec` (watermark-lag p99 ceiling, EPS floor,
late-drop and overflow budgets, recompile ceiling, the driver's retry and
failover budgets, the overload controller's shed and degraded-window
budgets, event-time end-to-end ceilings) is evaluated incrementally from
the telemetry gauges as windows fire. Violations become
``slo_violation:*`` instant events (flushed to the ledger stream at once)
and a verdict block in the ledger; the JAX package's ``tools/sfprof``
applies the same spec post-hoc to the port's ledger. The semantics are
the JAX package's ``spatialflink_tpu/slo.py``.

:func:`install` opts in; the window fire sites (``streams/windows.py``,
``streams/soa.py``) call :func:`on_window_fired`, one global read and a
``None`` check while no engine is installed.
"""

from __future__ import annotations

import json
import threading
import time
from dataclasses import dataclass, fields
from typing import Any, Dict, List, Optional

from spatialflink_tpu_torch import overload
from spatialflink_tpu_torch.mn.metrics import FixedBucketLatency, json_safe
from spatialflink_tpu_torch.telemetry import telemetry

#: Spec schema version (the post-hoc twin's ``SLO_VERSION``).
SLO_VERSION = 1


@dataclass(frozen=True)
class SloSpec:
    """Declarative SLO thresholds; ``None`` means unchecked.

    - ``watermark_lag_p99_ms``: p99 of the event-time lag between a
      window's end and the watermark that fired it;
    - ``eps_floor``: events/s over the run so far, checked after
      ``warmup_windows`` fired windows;
    - ``late_drop_budget`` / ``overflow_budget``: counter ceilings;
    - ``recompile_ceiling``: distinct-signature compiles;
    - ``retry_budget`` / ``failover_budget``: ceilings on the dataflow
      driver's retries and failovers;
    - ``shed_budget`` / ``degraded_window_budget``: ceilings on the
      overload controller's shed events and non-device windows. Named
      with no controller installed, they violate: silence fails;
    - ``tenant_budgets``: ``{class: {"shed_budget": N,
      "degraded_window_budget": M}}`` against the controller's per-class
      counters; silence fails;
    - ``node_budgets``: per-DAG-node budgets against the installed
      composed DAG (``dag.active()``, its ``node_stats``): ``{node:
      {key: bound}}``. With no DAG installed, or a node it lacks, the
      budget is unanswerable and violates: silence fails;
    - ``e2e_p50_ms`` / ``e2e_p99_ms``: ceilings on the "commit" lineage
      stage (window end → sink or checkpoint commit), checked after
      ``warmup_windows``; past it, a run that never committed violates;
    - ``eval_interval_s``: pacing of the incremental evaluation.
    """

    name: str = "default"
    watermark_lag_p99_ms: Optional[float] = None
    eps_floor: Optional[float] = None
    late_drop_budget: Optional[int] = None
    overflow_budget: Optional[int] = None
    recompile_ceiling: Optional[int] = None
    retry_budget: Optional[int] = None
    failover_budget: Optional[int] = None
    shed_budget: Optional[int] = None
    degraded_window_budget: Optional[int] = None
    e2e_p50_ms: Optional[float] = None
    e2e_p99_ms: Optional[float] = None
    tenant_budgets: Optional[Dict[str, Dict[str, int]]] = None
    node_budgets: Optional[Dict[str, Dict[str, int]]] = None
    eval_interval_s: float = 1.0
    warmup_windows: int = 8

    #: Per-class budget keys ``tenant_budgets`` accepts.
    TENANT_BUDGET_KEYS = ("shed_budget", "degraded_window_budget")

    #: Per-node budget keys ``node_budgets`` accepts.
    NODE_BUDGET_KEYS = ("watermark_lag_p99_ms", "retry_budget",
                        "failover_budget", "degraded_window_budget",
                        "e2e_p50_ms", "e2e_p99_ms")

    def __post_init__(self):
        overload.validate_budget_map(
            self.tenant_budgets, self.TENANT_BUDGET_KEYS
        )
        overload.validate_budget_map(
            self.node_budgets, self.NODE_BUDGET_KEYS,
            what="node_budgets",
        )

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "SloSpec":
        """Strict parse: an unknown key raises; ``slo_version``, when
        present, must match."""
        d = dict(d)
        ver = d.pop("slo_version", SLO_VERSION)
        if ver != SLO_VERSION:
            raise ValueError(
                f"slo_version {ver} != supported {SLO_VERSION}"
            )
        known = {f.name for f in fields(cls)}
        unknown = sorted(set(d) - known)
        if unknown:
            raise ValueError(f"unknown SLO spec keys: {unknown}")
        return cls(**d)

    @classmethod
    def from_file(cls, path: str) -> "SloSpec":
        with open(path) as f:
            return cls.from_dict(json.load(f))

    def to_dict(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {"slo_version": SLO_VERSION}
        for f in fields(self):
            out[f.name] = getattr(self, f.name)
        return out


def _find_overflows(value, out: List[int]):
    """Every numeric counter whose key mentions ``overflow`` (the
    post-hoc health check's substring contract)."""
    if isinstance(value, dict):
        for k, v in value.items():
            if ("overflow" in str(k)
                    and isinstance(v, (int, float))
                    and not isinstance(v, bool)):
                out.append(int(v))
            else:
                _find_overflows(v, out)


#: (budget key, check-name head) of ``node_budgets``, in the JAX order.
_NODE_CHECKS = (
    ("watermark_lag_p99_ms", "node_watermark_lag_p99_ms",
     "watermark_lag_p99_ms"),
    ("retry_budget", "node_retry_budget", "retries"),
    ("failover_budget", "node_failover_budget", "failovers"),
    ("degraded_window_budget", "node_degraded_window_budget",
     "degraded_windows"),
    ("e2e_p50_ms", "node_e2e_p50_ms", "e2e_p50_ms"),
    ("e2e_p99_ms", "node_e2e_p99_ms", "e2e_p99_ms"),
)


class SloEngine:
    """Incremental evaluator of one :class:`SloSpec` against the live
    telemetry gauges.

    ``observe_window`` is the per-window hook: counter updates under a
    lock and, at most every ``eval_interval_s``, a full check pass. A
    check's transition into violation records it and emits
    ``slo_violation:<check>``; recovery emits ``slo_recovered:<check>``
    and keeps the record: the verdict is about the run."""

    def __init__(self, spec: SloSpec, tel=telemetry):
        self.spec = spec
        self.tel = tel
        self._lock = threading.Lock()
        self.windows = 0
        self.points = 0
        self.evaluations = 0
        self.violations: List[dict] = []
        self.lag = FixedBucketLatency()
        self._violated: Dict[str, bool] = {}
        self._last_checks: List[dict] = []
        # The EPS clock starts at the first fired window, not at
        # construction: set-up before the first window is not elapsed.
        self._t0: Optional[float] = None
        self._last_eval = time.monotonic()

    # -- per-window hook -------------------------------------------------------

    def observe_window(self, n_events: int = 0,
                       lag_ms: Optional[float] = None):
        now = time.monotonic()
        with self._lock:
            if self._t0 is None:
                self._t0 = now
            self.windows += 1
            self.points += int(n_events)
            if lag_ms is not None:
                self.lag.observe(float(lag_ms))
            due = now - self._last_eval >= self.spec.eval_interval_s
            if due:
                self._last_eval = now
        if due:
            self.evaluate()

    # -- evaluation ------------------------------------------------------------

    def _checks(self) -> List[dict]:
        sp = self.spec
        out: List[dict] = []

        def check(name, value, bound, ok):
            out.append({"check": name, "value": json_safe(value),
                        "bound": bound, "ok": bool(ok)})

        with self._lock:
            windows, points = self.windows, self.points
            t0 = self._t0
            lag_count = self.lag.count
            lag_p99 = self.lag.percentile(0.99) if lag_count else None
        if sp.watermark_lag_p99_ms is not None and lag_p99 is not None:
            check("watermark_lag_p99_ms", lag_p99,
                  f"<= {float(sp.watermark_lag_p99_ms):g}",
                  lag_p99 <= sp.watermark_lag_p99_ms)
        if sp.eps_floor is not None and t0 is not None \
                and windows > sp.warmup_windows:
            elapsed = max(time.monotonic() - t0, 1e-9)
            eps = points / elapsed
            check("eps_floor", eps, f">= {float(sp.eps_floor):g}",
                  eps >= sp.eps_floor)
        if sp.late_drop_budget is not None:
            late = self.tel.late_drops
            check("late_drop_budget", late,
                  f"<= {int(sp.late_drop_budget)}",
                  late <= sp.late_drop_budget)
        if sp.recompile_ceiling is not None:
            compiles = self.tel.compile_count
            check("recompile_ceiling", compiles,
                  f"<= {int(sp.recompile_ceiling)}",
                  compiles <= sp.recompile_ceiling)
        if sp.retry_budget is not None:
            retries = self.tel.driver_retries
            check("retry_budget", retries, f"<= {int(sp.retry_budget)}",
                  retries <= sp.retry_budget)
        if sp.failover_budget is not None:
            fo = self.tel.driver_failovers
            check("failover_budget", fo, f"<= {int(sp.failover_budget)}",
                  fo <= sp.failover_budget)
        if sp.shed_budget is not None:
            ctrl = overload.controller()
            shed = None if ctrl is None else ctrl.shed_total
            # No controller: the budget is unanswerable, and silence fails.
            check("shed_budget", shed, f"<= {int(sp.shed_budget)}",
                  shed is not None and shed <= sp.shed_budget)
        if sp.degraded_window_budget is not None:
            ctrl = overload.controller()
            dw = None if ctrl is None else ctrl.degraded_windows
            check("degraded_window_budget", dw,
                  f"<= {int(sp.degraded_window_budget)}",
                  dw is not None and dw <= sp.degraded_window_budget)
        if (sp.e2e_p50_ms is not None or sp.e2e_p99_ms is not None) \
                and windows > sp.warmup_windows:
            e2e_p50, e2e_p99 = self.tel.e2e_stage_percentiles("commit")
            if sp.e2e_p50_ms is not None:
                check("e2e_p50_ms", e2e_p50,
                      f"<= {float(sp.e2e_p50_ms):g}",
                      e2e_p50 is not None and e2e_p50 <= sp.e2e_p50_ms)
            if sp.e2e_p99_ms is not None:
                check("e2e_p99_ms", e2e_p99,
                      f"<= {float(sp.e2e_p99_ms):g}",
                      e2e_p99 is not None and e2e_p99 <= sp.e2e_p99_ms)
        if sp.tenant_budgets:
            ctrl = overload.controller()
            for cls, b in sorted(sp.tenant_budgets.items()):
                sb = b.get("shed_budget")
                if sb is not None:
                    shed = (None if ctrl is None
                            else ctrl.tenant_shed_total(cls))
                    check(f"tenant_shed_budget:{cls}", shed,
                          f"<= {int(sb)}",
                          shed is not None and shed <= sb)
                dwb = b.get("degraded_window_budget")
                if dwb is not None:
                    dw = (None if ctrl is None
                          else ctrl.tenant_degraded_windows(cls))
                    check(f"tenant_degraded_window_budget:{cls}", dw,
                          f"<= {int(dwb)}",
                          dw is not None and dw <= dwb)
        if sp.node_budgets:
            from spatialflink_tpu_torch import dag as dag_mod

            d = dag_mod.active()
            for node, b in sorted(sp.node_budgets.items()):
                stats = None if d is None else d.node_stats(node)
                for key, head, metric in _NODE_CHECKS:
                    bound = b.get(key)
                    if bound is None:
                        continue
                    if key.startswith("e2e_") \
                            and windows <= sp.warmup_windows:
                        continue  # the warm-up grace of eps_floor
                    val = None if stats is None else stats[metric]
                    # No DAG installed, or an unknown node: the budget is
                    # unanswerable, and silence fails (the eps_floor rule).
                    check(f"{head}:{node}", val, f"<= {int(bound)}",
                          val is not None and val <= bound)
        if sp.overflow_budget is not None:
            counts: List[int] = []
            _find_overflows(self.tel.snapshot(), counts)
            total = sum(counts)
            check("overflow_budget", total,
                  f"<= {int(sp.overflow_budget)}",
                  total <= sp.overflow_budget)
        return out

    def evaluate(self) -> List[dict]:
        """One full check pass; returns the check rows. Violation events
        are emitted on transitions only."""
        rows = self._checks()
        transitions = []
        with self._lock:
            self.evaluations += 1
            self._last_checks = rows
            for row in rows:
                was = self._violated.get(row["check"], False)
                now_bad = not row["ok"]
                self._violated[row["check"]] = now_bad
                if now_bad and not was:
                    rec = {
                        "check": row["check"], "value": row["value"],
                        "bound": row["bound"], "unix": time.time(),
                        "window_seq": self.windows,
                    }
                    self.violations.append(rec)
                    transitions.append(("slo_violation", rec))
                elif was and not now_bad:
                    transitions.append(("slo_recovered", {
                        "check": row["check"], "value": row["value"],
                        "bound": row["bound"], "unix": time.time(),
                        "window_seq": self.windows,
                    }))
        for kind, rec in transitions:
            # Two literal event-name heads, as the JAX engine emits them.
            if kind == "slo_violation":
                self.tel.emit_instant(f"slo_violation:{rec['check']}",
                                      value=rec["value"],
                                      bound=rec["bound"],
                                      window_seq=rec["window_seq"])
            else:
                self.tel.emit_instant(f"slo_recovered:{rec['check']}",
                                      value=rec["value"],
                                      bound=rec["bound"],
                                      window_seq=rec["window_seq"])
        if any(kind == "slo_violation" for kind, _ in transitions):
            # A violation must survive the run dying right after it.
            self.tel.maybe_flush_stream(force=True)
        if rows:
            # Live verdict → the overload ladder (free when uninstalled).
            overload.on_slo_evaluation(all(r["ok"] for r in rows))
        return rows

    def verdict(self) -> Dict[str, Any]:
        """The ledger block: the spec, the final check states (one last
        evaluation), every violation of the run and the gate (``ok`` is
        zero violations ever)."""
        rows = self.evaluate()
        with self._lock:
            return json_safe({
                "slo_version": SLO_VERSION,
                "spec": self.spec.to_dict(),
                "ok": not self.violations,
                "windows": self.windows,
                "points": self.points,
                "evaluations": self.evaluations,
                "checks": rows,
                "violations": list(self.violations),
            })


# -- module-level wiring (the telemetry singleton idiom) -----------------------

_engine: Optional[SloEngine] = None


def install(engine: SloEngine) -> SloEngine:
    """Make ``engine`` the process-global SLO engine: the window-fire
    sites feed it, and ``telemetry.write_ledger`` / ``seal_stream`` embed
    its verdict."""
    global _engine
    _engine = engine
    engine.tel.slo_provider = engine.verdict
    return engine


def uninstall():
    global _engine
    if _engine is not None:
        _engine.tel.slo_provider = None
    _engine = None


def engine() -> Optional[SloEngine]:
    return _engine


def on_window_fired(n_events: int = 0, lag_ms: Optional[float] = None):
    """The window-fire hook: one global read and a ``None`` check when no
    engine is installed."""
    eng = _engine
    if eng is not None:
        eng.observe_window(n_events, lag_ms)
