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

import json
import os
from collections import deque
from dataclasses import dataclass
from typing import Any, Callable, Iterable, Iterator, List, Optional

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
    """

    def __init__(self, pol: PipelinePolicy, *,
                 ship: Callable[[Any], Any],
                 compute: Callable[[Any, Any], Any],
                 fetch: Callable[[List[Any]], Iterable]):
        self.pol = pol
        self._ship = ship
        self._compute = compute
        self._fetch = fetch

    def run(self, items: Iterable) -> Iterator:
        """Drive ``items`` through the three stages; yield fetch results
        in item order. The in-flight window count never exceeds
        ``fetch_lag`` and the ship-ahead never exceeds ``depth``."""
        shipped: deque = deque()
        inflight: deque = deque()
        it = iter(items)
        exhausted = False
        depth = max(1, int(self.pol.depth))
        lag = max(0, int(self.pol.fetch_lag))

        def refill():
            nonlocal exhausted
            while not exhausted and len(shipped) < depth:
                try:
                    item = next(it)
                except StopIteration:
                    exhausted = True
                    break
                shipped.append((item, self._ship(item)))

        while True:
            refill()
            if not shipped:
                break
            item, staged = shipped.popleft()
            work = self._compute(item, staged)
            del staged  # the one compute owns it
            if work is not None:
                inflight.append(work)
            out: list = []
            while len(inflight) > lag:
                out.extend(self._fetch([inflight.popleft()]))
            yield from out
        if inflight:  # final drain: one wait for the whole tail
            tail = list(self._fetch(list(inflight)))
            inflight.clear()
            yield from tail


arm_from_env()
