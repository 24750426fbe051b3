"""Deterministic fault injection: named injection points on the host/card
boundary, armed by a JSON fault plan, so a failure mode can be rehearsed
on demand instead of waited for.

Contract: **disarmed-free**. Every injection point costs ONE attribute
check while no plan is armed::

    if faults.armed:
        faults.hit("device.ship")

Plans arm via ``SFT_FAULT_PLAN`` (inline JSON or a path to a JSON file,
read once at import so a child process arms with no code) or
``faults.arm(...)`` in-process. A plan is a list of rules::

    [{"point": "device.dispatch", "at": 3, "times": 2, "kind": "raise"}]

- ``point``: a registered injection point (arming an unknown point is an
  error: a typo'd plan that silently never fires is worse than none);
- ``at``: fire on the Nth hit of that point (1-based, default 1);
- ``times``: how many consecutive hits fire (default 1);
- ``kind``: ``raise`` (InjectedFault), ``hang`` (sleep ``hang_s``, then
  raise: a bounded stall), ``abort`` (``os._exit(137)``, the SIGKILL
  analog: no handlers, no flush), or ``partial_write`` (sink commits
  only: write a byte prefix, then raise).

Determinism: triggers count hits, so a fixed input stream replays the
same fault schedule; an optional ``prob``/``seed`` pair draws per hit
from a dedicated ``random.Random(seed)``, so probabilistic plans replay
bit-identically too. Every firing is recorded (``faults.fired``) and,
while telemetry is enabled, emitted as a ``fault_fired:<point>`` instant
and force-flushed to the ledger stream.

The registry is the JAX package's, kept whole, and the port threads
every point of it:

=====================  ==================================================
point                  site in this package
=====================  ==================================================
``device.ship``        ``operators/base.py:ship`` (host→device copy)
``device.dispatch``    ``telemetry.instrument_jit`` (every instrumented
                       window or pane program, the four hand kernels'
                       wrappers among them)
``device.fetch``       ``telemetry.fetch`` (device→host copy)
``window.feed``        ``streams/windows.py:WindowAssembler.feed``
``soa.feed``           ``streams/soa.py`` sliding assemblers' ``feed``
``pipeline.ship``      ``pipeline.py:PipelinedExecutor`` ship stage and
                       ``driver.py``'s pipelined dispatch
``pipeline.fetch``     ``pipeline.py:PipelinedExecutor`` fetch stage and
                       ``driver.py``'s lagged fetch
``sink.write``         ``streams/sinks.py:TransactionalFileSink.commit``
                       (egress append; ``partial_write`` supported)
``driver.window``      ``driver.py`` device-path window processing
``source.stall``       ``driver.py`` per-item source pull
``overload.admit``     ``overload.py:OverloadController.admit_item``
                       (the admission decision)
``dag.node``           ``dag.py:DataflowDAG._run_node`` (each node's
                       device-path attempt of a window)
``dag.commit``         ``streams/sinks.py:MultiSink.commit`` (each sub-sink
                       append of the unit commit)
``qserve.register``    ``qserve.py:QueryRegistry.apply`` (each standing-
                       query register or unregister command)
``kafka.fetch``        ``streams/kafka.py:WireKafkaSource`` (each
                       partition's fetch in a round)
``kafka.leader``       ``streams/kafka_wire.py:_with_leader_retry`` (each
                       leader-routed request attempt; not retried)
``shard.exchange``     ``parallel/halo.py`` (each halo wrapper's call,
                       once, before its shards dispatch)
=====================  ==================================================

The other points wait for no module: none is left unthreaded.

This module imports nothing beyond the stdlib at module scope, so every
layer (telemetry included) can import it without cycles.
"""

from __future__ import annotations

import json
import os
import random
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional


#: Registered injection points (the JAX package's registry, whole).
INJECTION_POINTS: Dict[str, str] = {
    "device.ship": "operators/base.py:ship — host→device batch transfer",
    "device.dispatch": "telemetry.instrument_jit — instrumented window, "
                       "pane and hand-kernel dispatch",
    "device.fetch": "telemetry.fetch — device→host fetch",
    "window.feed": "streams/windows.py:WindowAssembler.feed — per-event "
                   "window assembly",
    "soa.feed": "streams/soa.py sliding assemblers — per-chunk SoA "
                "window assembly",
    "kafka.fetch": "streams/kafka.py:WireKafkaSource — per-partition "
                   "fetch round",
    "kafka.leader": "streams/kafka_wire.py:_with_leader_retry — "
                    "leader-routed request attempt",
    "sink.write": "streams/sinks.py:TransactionalFileSink.commit — "
                  "egress append (supports partial_write)",
    "driver.window": "driver.py — device-path window processing",
    "overload.admit": "overload.py:OverloadController.admit_item — "
                      "admission decision",
    "source.stall": "driver.py:_drive — per-item source pull",
    "pipeline.ship": "pipeline.py:PipelinedExecutor — overlapped "
                     "host→device pane ship (encode + stage ahead)",
    "pipeline.fetch": "pipeline.py:PipelinedExecutor — lagged "
                      "device→host result fetch (ordered drain)",
    "qserve.register": "qserve.py:QueryRegistry.apply — standing-query "
                       "register/unregister",
    "dag.node": "dag.py:DataflowDAG — per-node window processing",
    "dag.commit": "streams/sinks.py:MultiSink.commit — per-sink append "
                  "inside the atomic unit commit",
    "shard.exchange": "parallel/halo.py — grid-partitioned halo "
                      "exchange dispatch (boundary-cell pane copies "
                      "between shards; the kill-mid-exchange point the "
                      "sharded kill/resume leg cuts at)",
}

#: Points whose callers implement the cooperative ``partial_write`` kind.
PARTIAL_WRITE_POINTS = frozenset({"sink.write"})

FAULT_KINDS = ("raise", "hang", "partial_write", "abort")

#: The exit code the ``abort`` kind dies with: 128+SIGKILL, the code a
#: real ``kill -9`` produces.
ABORT_EXIT_CODE = 137


class InjectedFault(RuntimeError):
    """A deliberately injected failure (never raised by real code paths)."""

    def __init__(self, point: str, kind: str = "raise", hit: int = 0):
        super().__init__(
            f"injected fault at {point!r} (kind={kind}, hit #{hit})"
        )
        self.point = point
        self.kind = kind
        self.hit = hit


@dataclass
class FaultRule:
    """One armed fault: fires on hits ``at .. at+times-1`` of ``point``."""

    point: str
    kind: str = "raise"
    at: int = 1
    times: int = 1
    hang_s: float = 0.05
    prob: float = 1.0
    seed: int = 0
    _rng: random.Random = field(init=False, repr=False, default=None)

    def __post_init__(self):
        if self.point not in INJECTION_POINTS:
            raise ValueError(
                f"unknown injection point {self.point!r} "
                f"(registered: {sorted(INJECTION_POINTS)})"
            )
        if self.kind not in FAULT_KINDS:
            raise ValueError(
                f"unknown fault kind {self.kind!r} (kinds: {FAULT_KINDS})"
            )
        if self.kind == "partial_write" \
                and self.point not in PARTIAL_WRITE_POINTS:
            raise ValueError(
                f"kind 'partial_write' is only supported at "
                f"{sorted(PARTIAL_WRITE_POINTS)}, not {self.point!r}"
            )
        if self.at < 1 or self.times < 1:
            raise ValueError("`at` and `times` must be >= 1")
        # A dedicated, seeded stream per rule: probabilistic plans replay
        # bit-identically whatever else draws from the global RNG.
        self._rng = random.Random(self.seed)

    def should_fire(self, hit: int) -> bool:
        if not (self.at <= hit < self.at + self.times):
            return False
        if self.prob >= 1.0:
            return True
        return self._rng.random() < self.prob

    def to_dict(self) -> Dict[str, Any]:
        return {
            "point": self.point, "kind": self.kind, "at": self.at,
            "times": self.times, "hang_s": self.hang_s, "prob": self.prob,
            "seed": self.seed,
        }


_RULE_KEYS = {"point", "kind", "at", "times", "hang_s", "prob", "seed"}


def parse_plan(plan) -> List[FaultRule]:
    """A plan is a JSON list of rule objects (a single object is a 1-rule
    plan). Unknown keys raise: a typo'd trigger that silently never fires
    is the worst failure a chaos tool can have."""
    if isinstance(plan, dict):
        plan = [plan]
    if not isinstance(plan, list):
        raise ValueError(f"fault plan must be a list of rules, got "
                         f"{type(plan).__name__}")
    rules = []
    for i, r in enumerate(plan):
        if not isinstance(r, dict):
            raise ValueError(f"fault rule #{i} is not an object: {r!r}")
        unknown = sorted(set(r) - _RULE_KEYS)
        if unknown:
            raise ValueError(f"fault rule #{i} has unknown keys {unknown}")
        rules.append(FaultRule(**r))
    return rules


class FaultInjector:
    """Process-global injector (the ``ops/counters.py`` singleton idiom).
    ``armed`` is the ONLY state the disarmed hot path reads."""

    def __init__(self):
        self.armed = False
        self.rules: List[FaultRule] = []
        self.counts: Dict[str, int] = {}
        self.fired: List[Dict[str, Any]] = []
        self._lock = threading.Lock()

    # -- arming ----------------------------------------------------------------

    def arm(self, plan) -> "FaultInjector":
        """Arm a plan (list/dict, JSON string, or a path to a JSON file).
        Resets hit counts: arming IS the start of a fault schedule."""
        if isinstance(plan, str):
            text = plan.strip()
            if not text.startswith(("[", "{")):
                with open(text) as f:
                    text = f.read()
            plan = json.loads(text)
        with self._lock:
            self.rules = parse_plan(plan)
            self.counts = {}
            self.fired = []
            self.armed = bool(self.rules)
        if self.armed:
            self._telemetry_instant(
                "fault_armed", plan=[r.to_dict() for r in self.rules]
            )
        return self

    def arm_from_env(self) -> bool:
        """Arm from ``SFT_FAULT_PLAN`` (inline JSON or file path); no-op
        when unset. Called once at import."""
        spec = os.environ.get("SFT_FAULT_PLAN")
        if not spec:
            return False
        self.arm(spec)
        return True

    def disarm(self):
        with self._lock:
            self.armed = False
            self.rules = []
            self.counts = {}
            self.fired = []

    # -- the hot-path hook -----------------------------------------------------

    def hit(self, point: str) -> Optional[str]:
        """One pass through an injection point. Callers gate on
        ``faults.armed`` so the disarmed cost is one attribute check.

        Raises :class:`InjectedFault` (``raise``/``hang`` kinds), kills
        the process (``abort``), or returns ``"partial_write"`` for the
        caller to cooperate with. Returns ``None`` when nothing fires.
        """
        with self._lock:
            count = self.counts.get(point, 0) + 1
            self.counts[point] = count
            rule = None
            for r in self.rules:
                if r.point == point and r.should_fire(count):
                    rule = r
                    break
        if rule is None:
            return None
        return self._fire(rule, count)

    def _fire(self, rule: FaultRule, count: int) -> Optional[str]:
        # Whether a fault fires is the hit-count rule; the wall timestamp
        # only annotates the record.
        rec = {"point": rule.point, "kind": rule.kind, "hit": count,
               "unix": time.time()}
        with self._lock:
            self.fired.append(rec)
        self._telemetry_fired(rule.point, rule.kind, count)
        if rule.kind == "abort":
            # The SIGKILL analog: no atexit, no finally, no flush.
            os._exit(ABORT_EXIT_CODE)
        if rule.kind == "hang":
            # A bounded stall, then the failure surfaces.
            time.sleep(rule.hang_s)
            raise InjectedFault(rule.point, "hang", count)
        if rule.kind == "partial_write":
            return "partial_write"
        raise InjectedFault(rule.point, "raise", count)

    # -- telemetry (lazy import: telemetry itself imports this module) ---------

    @staticmethod
    def _telemetry_instant(name: str, **args):
        try:
            from spatialflink_tpu_torch.telemetry import telemetry
        except ImportError:  # partial interpreter teardown
            return
        if telemetry.enabled:
            telemetry.emit_instant(name, **args)

    @staticmethod
    def _telemetry_fired(point: str, kind: str, count: int):
        try:
            from spatialflink_tpu_torch.telemetry import telemetry
        except ImportError:
            return
        if telemetry.enabled:
            telemetry.record_fault(point, kind=kind, hit=count)


faults = FaultInjector()

# A child process only needs SFT_FAULT_PLAN in its environment.
faults.arm_from_env()
