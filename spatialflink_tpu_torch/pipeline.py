"""Pipelined ingest: the bounded ship/compute/fetch executor.

A bounded-depth pipeline over an item stream that overlaps

- **ship(N+1)**: encode (``ops/wire_codec.py``, when armed) and start the
  next pane's host→device copy, from pinned memory on a side CUDA stream
  (``operators/base.py:ship``); the copy runs while the host moves on;
- **compute(N)**: launch the current window's kernels on the compute
  stream, which waits on the pane's copy event and nothing else;
- **fetch(N−1)**: the lagged, ORDERED device→host copy of the results,
  the one point where the host waits for the card.

Ordering and results are bit-identical to the synchronous loop: the same
kernels run in the same order, only the host's waits move.

**Opt-in** via ``SFT_PIPELINE`` (inline JSON or a path to a JSON file;
``"1"``/``"on"`` = defaults; read at import) or :func:`install`. With no
policy, operators take their synchronous paths.
"""

from __future__ import annotations

import contextlib
import json
import os
from collections import deque
from dataclasses import dataclass
from typing import Any, Callable, Iterable, Iterator, List, Optional

from spatialflink_tpu_torch.faults import faults
from spatialflink_tpu_torch.telemetry import telemetry

_POLICY_KEYS = {"depth", "fetch_lag", "codec", "codec_strategy"}

CODECS = ("off", "delta")


@dataclass(frozen=True)
class PipelinePolicy:
    """Declarative pipeline configuration (strict parse: unknown keys
    raise).

    - ``depth``: panes shipped but not yet computed, INCLUDING the one
      about to compute (≥1; 1 = no ship-ahead);
    - ``fetch_lag``: computed windows left in flight before the oldest
      is fetched (0 = fetch every window immediately);
    - ``codec``: ``"delta"`` arms the delta-bitpacked wire-pane codec on
      paths that ship wire panes; ``"off"`` ships raw planes;
    - ``codec_strategy``: decoder (``auto``, or the device's own:
      ``cuda`` on a card, ``torch`` on the CPU; the other raises).
    """

    depth: int = 2
    fetch_lag: int = 2
    codec: str = "off"
    codec_strategy: str = "auto"

    def __post_init__(self):
        if int(self.depth) < 1:
            raise ValueError(f"depth must be >= 1, got {self.depth}")
        if int(self.fetch_lag) < 0:
            raise ValueError(
                f"fetch_lag must be >= 0, got {self.fetch_lag}"
            )
        if self.codec not in CODECS:
            raise ValueError(
                f"unknown codec {self.codec!r} (codecs: {CODECS})"
            )
        if self.codec_strategy not in ("auto", "cuda", "torch"):
            raise ValueError(
                f"codec_strategy must be auto|cuda|torch, got "
                f"{self.codec_strategy!r}"
            )

    @classmethod
    def from_dict(cls, d: dict) -> "PipelinePolicy":
        if not isinstance(d, dict):
            raise ValueError(
                f"pipeline policy must be an object, got "
                f"{type(d).__name__}"
            )
        unknown = sorted(set(d) - _POLICY_KEYS)
        if unknown:
            raise ValueError(f"pipeline policy has unknown keys {unknown}")
        return cls(**d)

    @classmethod
    def from_env(cls, spec: str) -> "PipelinePolicy":
        """``SFT_PIPELINE`` forms: ``1``/``on``/``true`` (defaults),
        inline JSON object, or a path to a JSON file."""
        text = spec.strip()
        if text.lower() in ("1", "on", "true", "yes"):
            return cls()
        if not text.startswith("{"):
            with open(text) as f:
                text = f.read()
        return cls.from_dict(json.loads(text))

    def to_dict(self) -> dict:
        return {
            "depth": int(self.depth), "fetch_lag": int(self.fetch_lag),
            "codec": self.codec, "codec_strategy": self.codec_strategy,
        }


_policy: Optional[PipelinePolicy] = None


def install(policy: PipelinePolicy) -> PipelinePolicy:
    """Make ``policy`` the process-wide pipeline policy: pane engines
    consult :func:`policy` when no explicit one is passed."""
    global _policy
    _policy = policy
    return policy


def uninstall():
    global _policy
    _policy = None


def policy() -> Optional[PipelinePolicy]:
    return _policy


def arm_from_env() -> bool:
    """Arm from ``SFT_PIPELINE``; no-op when unset."""
    spec = os.environ.get("SFT_PIPELINE")
    if not spec:
        return False
    install(PipelinePolicy.from_env(spec))
    return True


def breaker_collapsed() -> bool:
    """True while the installed overload controller's circuit breaker
    holds the device path open (``overload.py``): a pipeline must not
    stack windows onto it, so the executor and the driver's pipelined
    split collapse to the synchronous cadence until it closes."""
    from spatialflink_tpu_torch import overload

    ctrl = overload.controller()
    if ctrl is None or ctrl.breaker is None:
        return False
    return ctrl.breaker.state == "open"


class PipelinedExecutor:
    """Generic bounded overlap over an item stream.

    Stage contracts (all host callables):

    - ``ship(item) -> staged``: encode and start the host→device copy;
      may return ``None`` for items with nothing to ship (trailing flush
      panes). ``staged`` goes to exactly ONE compute call.
    - ``compute(item, staged) -> work | None``: launch the window's
      kernels; ``None`` = no window fired (gap pane). Must not wait.
    - ``fetch(works: list) -> iterable``: the one waiting point:
      copy the listed windows' results to the host IN ORDER and return
      the values to yield. Mid-stream the list has one element; the
      final drain passes everything still in flight.

    The ship and fetch stages are the ``pipeline.ship`` and
    ``pipeline.fetch`` fault points. ``spans=True`` wraps each item in a
    ``window.<label>`` span with ``ship``/``compute``/``fetch`` children;
    ``node`` tags the per-item work with a telemetry scope;
    ``e2e_end(item)`` (an item's event-time window end in ms, or None)
    stamps ``record_e2e`` at the ship, compute and fetch stages. While
    the overload circuit breaker is open (``breaker_collapsed``) the
    executor runs at the synchronous cadence (depth 1, no fetch lag) and
    emits ``pipeline_collapsed`` / ``pipeline_resumed`` on the
    transitions.
    """

    def __init__(self, pol: PipelinePolicy, *,
                 ship: Callable[[Any], Any],
                 compute: Callable[[Any, Any], Any],
                 fetch: Callable[[List[Any]], Iterable],
                 label: str = "pipeline",
                 spans: bool = False,
                 node: Optional[str] = None,
                 e2e_end: Optional[Callable[[Any], Any]] = None):
        self.pol = pol
        self._ship_fn = ship
        self._compute_fn = compute
        self._fetch_fn = fetch
        self.label = label
        self.spans = spans
        self.node = node
        self._e2e_end = e2e_end
        self.collapsed = False

    # -- stages (the fault points live here) -----------------------------------

    def _ship(self, item):
        if faults.armed:  # fault injection point (faults.py)
            faults.hit("pipeline.ship")
        return self._ship_fn(item)

    def _fetch(self, works: List[Any]) -> Iterable:
        if faults.armed:  # fault injection point (faults.py)
            faults.hit("pipeline.fetch")
        return self._fetch_fn(works)

    def _stamp_e2e(self, item, stage):
        """``record_e2e`` stamp when an ``e2e_end`` extractor is set;
        returns the item's event-time end for the later fetch stamp."""
        if self._e2e_end is None or not telemetry.enabled:
            return None
        end = self._e2e_end(item)
        if end is not None:
            telemetry.record_e2e(end, stage)
        return end

    def _sync_collapse_state(self):
        want = breaker_collapsed()
        if want == self.collapsed:
            return
        self.collapsed = want
        if telemetry.enabled:
            # One literal event name a branch, as the JAX executor emits.
            if want:
                telemetry.record_pipeline(collapses=1)
                telemetry.emit_instant("pipeline_collapsed",
                                       label=self.label)
            else:
                telemetry.record_pipeline(resumes=1)
                telemetry.emit_instant("pipeline_resumed",
                                       label=self.label)
            telemetry.maybe_flush_stream(force=True)

    # -- the loop --------------------------------------------------------------

    def run(self, items: Iterable) -> Iterator:
        """Drive ``items`` through the three stages; yield fetch results
        in item order. The in-flight window count never exceeds
        ``fetch_lag`` and the ship-ahead never exceeds ``depth``; while
        the circuit is open both clamp to the synchronous cadence."""
        shipped: deque = deque()
        inflight: deque = deque()
        ends: deque = deque()  # event-time ends aligned with inflight
        it = iter(items)
        exhausted = False

        def refill(n: int):
            nonlocal exhausted
            while not exhausted and len(shipped) < n:
                try:
                    item = next(it)
                except StopIteration:
                    exhausted = True
                    break
                shipped.append((item, self._ship(item)))
                self._stamp_e2e(item, "ship")

        def maybe_span(name: str):
            return (telemetry.span(name) if self.spans
                    else contextlib.nullcontext())

        # Prime the ship-ahead once, outside any window span; afterwards
        # each item tops it up INSIDE its window span.
        self._sync_collapse_state()
        refill(1 if self.collapsed else max(1, int(self.pol.depth)))
        while True:
            if not shipped:
                refill(1)  # depth-1 cadence: probe for the next item
                if not shipped:
                    break
            depth = 1 if self.collapsed else max(1, int(self.pol.depth))
            lag = 0 if self.collapsed else max(0, int(self.pol.fetch_lag))
            out: list = []
            # The scope covers the item's work only, never a yield.
            with telemetry.scope(self.node), \
                    maybe_span(f"window.{self.label}"):
                with maybe_span("ship"):
                    refill(depth)
                item, staged = shipped.popleft()
                with maybe_span("compute"):
                    work = self._compute_fn(item, staged)
                del staged  # the one compute owns it
                if work is not None:
                    inflight.append(work)
                    ends.append(self._stamp_e2e(item, "compute"))
                    if telemetry.enabled:
                        telemetry.record_pipeline(
                            windows=1,
                            **({"sync": 1} if self.collapsed
                               else {"overlapped": 1}),
                        )
                while len(inflight) > lag:
                    with maybe_span("fetch"):
                        out.extend(self._fetch([inflight.popleft()]))
                    end = ends.popleft()
                    if end is not None and telemetry.enabled:
                        telemetry.record_e2e(end, "fetch")
            yield from out
            self._sync_collapse_state()
        if inflight:  # final drain: one wait for the whole tail
            with telemetry.scope(self.node):
                tail = list(self._fetch(list(inflight)))
                if telemetry.enabled:
                    for end in ends:
                        if end is not None:
                            telemetry.record_e2e(end, "fetch")
            inflight.clear()
            ends.clear()
            yield from tail


arm_from_env()
