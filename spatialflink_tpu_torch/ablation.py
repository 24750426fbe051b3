"""Measured kernel ablation: what does a kernel cost end to end?

If a kernel were free, how much faster would a run be? Arm a kernel's
label and ``telemetry.instrument_jit`` substitutes its dispatch with a
zero result of the right structure, so the run's rate with the kernel
"free" against its baseline rate is the kernel's *marginal* cost.

Mechanics per (label, abstract signature):

- the FIRST call runs the real kernel once (the *learning* call): it
  produces an output of the right structure, and that output's
  zero-filled mirror (same nesting, NamedTuple types included, shapes,
  dtypes and devices; ``torch.zeros_like`` per tensor) is cached;
- every later call returns a FRESH copy of the cached zeros (one
  ``clone`` per tensor), never the cached tensors themselves: the port's
  operators write into tensors in place (the digest rings,
  ``index_put_``), and a shared cache would carry one window's writes
  into the next. The copy is the substituted kernel's residual cost,
  which a marginal measurement should keep.

**Ablated runs are deliberately WRONG** (windows see zeros). They exist
only to be timed, so every capture they touch is tainted: while armed,
or after any substituted call since the capture began, the taint block
rides ``telemetry.snapshot()["tainted"]``, the ledger's top level and
the ledger-stream checkpoints.

Arming: ``SFT_ABLATE`` at import (a comma-separated label list, inline
JSON ``["k1", "k2"]`` or ``{"kernels": [...]}``, or a path to such JSON)
or ``ablation.arm`` in-process. Disarmed cost is one attribute check per
dispatch (``if ablation.armed``). ``telemetry`` imports this module at
module scope, so this module reaches telemetry only through lazy
per-call imports.
"""

from __future__ import annotations

import json
import os
import threading
from typing import Any, Dict, List, Optional, Sequence, Tuple


def _zeros_mirror(out):
    """Zero-filled mirror of a kernel output: tensors become
    ``torch.zeros_like`` (same shape, dtype and device), tuples, lists,
    NamedTuples and dicts recurse, Python numbers become their type's
    zero and anything else (None, strings) passes through."""
    if hasattr(out, "zero_") and hasattr(out, "dtype"):
        import torch

        return torch.zeros_like(out)
    if isinstance(out, tuple):
        parts = [_zeros_mirror(x) for x in out]
        return type(out)(*parts) if hasattr(out, "_fields") \
            else tuple(parts)
    if isinstance(out, list):
        return [_zeros_mirror(x) for x in out]
    if isinstance(out, dict):
        return {k: _zeros_mirror(v) for k, v in out.items()}
    if isinstance(out, bool):
        return False
    if isinstance(out, (int, float)):
        return type(out)(0)
    return out


def _fresh_copy(tree):
    """A copy of a cached zero mirror whose tensors are new storage."""
    if hasattr(tree, "clone") and hasattr(tree, "dtype"):
        return tree.clone()
    if isinstance(tree, tuple):
        parts = [_fresh_copy(x) for x in tree]
        return type(tree)(*parts) if hasattr(tree, "_fields") \
            else tuple(parts)
    if isinstance(tree, list):
        return [_fresh_copy(x) for x in tree]
    if isinstance(tree, dict):
        return {k: _fresh_copy(v) for k, v in tree.items()}
    return tree


class KernelAblation:
    """Process-global ablation controller (the faults/telemetry singleton
    idiom). ``armed`` is the ONLY state the disarmed hot path reads; the
    lock guards the cache and counters, never a dispatch."""

    def __init__(self):
        self.armed = False
        self.kernels: frozenset = frozenset()
        self._lock = threading.Lock()
        # (kernel label, abstract signature) → cached zero mirror.
        self._cache: Dict[Tuple[str, Tuple], Any] = {}
        self._hits: Dict[str, int] = {}     # substituted calls
        self._learned: Dict[str, int] = {}  # real learning calls

    # -- arming ----------------------------------------------------------------

    def arm(self, kernels: Sequence[str]):
        """Arm ablation for the named kernel labels (the names
        ``instrument_jit`` was given). Re-arming replaces the set and
        resets the cache: each leg of a sweep learns afresh."""
        ks = frozenset(str(k) for k in kernels if str(k))
        with self._lock:
            self.kernels = ks
            self._cache.clear()
            self.armed = bool(ks)
        if self.armed:
            self._emit_armed()

    def disarm(self):
        with self._lock:
            self.armed = False
            self.kernels = frozenset()
            self._cache.clear()

    def reset_counters(self):
        """Start-of-capture reset (``telemetry.enable`` calls this): a
        fresh capture's taint reflects THIS capture's substitutions."""
        with self._lock:
            self._hits.clear()
            self._learned.clear()
            self._cache.clear()

    def _emit_armed(self):
        # Lazy and guarded: at import-time arming telemetry may be
        # mid-import; telemetry.enable() re-issues the event then.
        try:
            from spatialflink_tpu_torch.telemetry import telemetry
        except ImportError:
            return
        if telemetry.enabled:
            telemetry.emit_instant(
                "ablation_armed", kernels=sorted(self.kernels))

    # -- the substituted dispatch ----------------------------------------------

    def matches(self, label: str) -> bool:
        return label in self.kernels

    def dispatch(self, label: str, fn, args: tuple, kwargs: dict):
        """Substitute one instrumented-kernel call (see the module doc):
        a learning call per (kernel, signature), fresh zeros after."""
        from spatialflink_tpu_torch.telemetry import abstract_signature

        key = (label, abstract_signature(args, kwargs))
        with self._lock:
            cached = self._cache.get(key)
        if cached is None:
            out = fn(*args, **kwargs)  # learning call: the real kernel
            zeros = _zeros_mirror(out)
            with self._lock:
                self._cache.setdefault(key, zeros)
                self._learned[label] = self._learned.get(label, 0) + 1
            return out
        with self._lock:
            self._hits[label] = self._hits.get(label, 0) + 1
        return _fresh_copy(cached)

    # -- taint -----------------------------------------------------------------

    def taint_block(self) -> Optional[Dict[str, Any]]:
        """The taint record (None while clean): armed now, or any
        substituted or learning call since the capture began."""
        with self._lock:
            if not self.armed and not self._hits and not self._learned:
                return None
            return {
                "kind": "ablation",
                "kernels": sorted(self.kernels),
                "substituted_calls": dict(self._hits),
                "learning_calls": dict(self._learned),
            }


ablation = KernelAblation()


def _parse_spec(text: str) -> List[str]:
    """``SFT_ABLATE`` value → kernel list: inline JSON (a list or
    ``{"kernels": [...]}``), a path to such JSON, or a comma list."""
    text = text.strip()
    if not text:
        return []
    if not text.startswith(("[", "{")) and os.path.isfile(text):
        with open(text) as f:
            text = f.read().strip()
    if text.startswith(("[", "{")):
        spec = json.loads(text)
        if isinstance(spec, dict):
            spec = spec.get("kernels") or []
        if not isinstance(spec, list):
            raise ValueError(
                f"SFT_ABLATE JSON must be a list or {{'kernels': [...]}}, "
                f"got {type(spec).__name__}")
        return [str(k) for k in spec]
    return [k.strip() for k in text.split(",") if k.strip()]


def maybe_arm_from_env():
    """Arm from ``SFT_ABLATE`` when set (called at import). A malformed
    spec raises: a sweep that silently times the UN-ablated program is
    worse than a crash."""
    spec = os.environ.get("SFT_ABLATE")
    if spec:
        kernels = _parse_spec(spec)
        if not kernels:
            raise ValueError(f"SFT_ABLATE set but names no kernels: "
                             f"{spec!r}")
        ablation.arm(kernels)


maybe_arm_from_env()
