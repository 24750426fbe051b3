"""Compact binary ingest wire format: grid-relative uint16 coordinates.

A point travels as quantized grid-relative ``uint16`` x and y plus an
interned ``int16`` object id: **6 bytes/point**, upcast to float32 on the
device inside the digest kernel.

Exactness contract (the same as the JAX package's ``streams/wire.py``):

- ``scale`` is chosen as ``m × 2^e`` with integer ``m ≤ 255`` (8
  significand bits), the smallest such value ≥ span/65535. A quantized
  coordinate ``q ≤ 65535`` (16 bits) times ``m`` (8 bits) needs ≤ 24
  significand bits, so ``q * scale`` is EXACT in f32 and
  ``origin + q * scale`` rounds exactly once. Fused (FMA) and unfused
  evaluation, numpy on the host, PyTorch on the CPU and the CUDA kernel
  all produce bit-identical f32 coordinates: the device upcast adds no
  error on top of quantization.
- Quantization itself is the ingest precision: one lattice step is
  span/65535-ish (Beijing extent: ~3.2e-5° ≈ 3.6 m east-west).
"""

from __future__ import annotations

import math

import numpy as np
import torch

U16_MAX = 65535


def wire_scale(span: float) -> float:
    """Smallest ``m × 2^e`` ≥ span/65535 with integer ``m`` ≤ 8 bits.

    The 8-bit significand keeps ``uint16 × scale`` exactly representable
    in f32 (16 + 8 ≤ 24 significand bits); see the module docstring.
    """
    if not span > 0:
        raise ValueError(f"span must be positive, got {span}")
    target = span / U16_MAX
    e = math.floor(math.log2(target)) - 7
    m = math.ceil(target / 2.0 ** e)
    if m > 255:  # target/2^e landed exactly on 256
        m, e = 128, e + 1
    if not 128 <= m <= 255:
        raise ArithmeticError(f"wire_scale significand {m} out of range")
    return m * 2.0 ** e


class WireFormat:
    """Quantizer/dequantizer for one grid extent.

    ``quantize`` runs on the host at the producer; ``dequantize`` is the
    tensor upcast (any device); ``dequantize_np`` is the host reference.
    All three agree bit for bit by the exactness contract above.
    """

    def __init__(self, min_x: float, max_x: float, min_y: float,
                 max_y: float):
        self.origin = np.asarray([min_x, min_y], np.float32)
        # The f32 cast is exact for the scale (m×2^e) by construction; the
        # origin rounds to f32 once, identically for every consumer.
        self.scale = np.asarray(
            [wire_scale(max_x - min_x), wire_scale(max_y - min_y)],
            np.float32,
        )

    @classmethod
    def for_grid(cls, grid) -> "WireFormat":
        return cls(grid.min_x, grid.max_x, grid.min_y, grid.max_y)

    def quantize(self, xy) -> np.ndarray:
        """(..., 2) float coords → (..., 2) uint16 (clipped to the bbox)."""
        xy64 = np.asarray(xy, np.float64)
        q = np.floor((xy64 - self.origin.astype(np.float64))
                     / self.scale.astype(np.float64))
        return np.clip(q, 0, U16_MAX).astype(np.uint16)

    def dequantize(self, q: torch.Tensor) -> torch.Tensor:
        """(..., 2) uint16 tensor → f32 coords on ``q``'s device."""
        scale = torch.from_numpy(self.scale.copy()).to(q.device)
        origin = torch.from_numpy(self.origin.copy()).to(q.device)
        return q.to(torch.float32) * scale + origin

    def dequantize_np(self, q) -> np.ndarray:
        """Host reference dequant (bit-identical to ``dequantize``)."""
        return np.asarray(q, np.float32) * self.scale + self.origin

    @property
    def bytes_per_point(self) -> int:
        """uint16 x + uint16 y + int16 interned oid."""
        return 6


class WirePaneAssembler:
    """Stateful SoA → (3, n) uint16 PLANE-MAJOR pane binner.

    Feeds ``PointPointKNNQuery.run_wire_panes`` from any SoA chunk stream
    ``{"ts", "x", "y", "oid"}``. Pane i covers
    [start_ms + i·slide_ms, start_ms + (i+1)·slide_ms); EVERY pane in
    order is emitted, including empty (3, 0) panes in event-time gaps, so
    downstream window indexing stays aligned.

    In-order streams only: a pane is emitted once an event at or after
    its end arrives, and an event earlier than the open pane raises.
    ``oid`` must already be interned into int16 range. ``flush()`` emits
    the final, possibly partial, pane at end of stream. ``state()`` and
    ``restore()`` snapshot the open pane's buffered events and position;
    snapshot only after every pane ``feed()`` returned has been consumed.
    """

    def __init__(self, wire_format: WireFormat, slide_ms: int,
                 start_ms: int):
        self._wf = wire_format
        self._slide = int(slide_ms)
        self._cur = int(start_ms)
        self._pend_ts = np.zeros(0, np.int64)
        self._pend_xy = np.zeros((0, 2), np.float64)
        self._pend_oid = np.zeros(0, np.int64)

    def _pack(self, xy, oid):
        q = self._wf.quantize(xy)
        o = np.asarray(oid, np.int16).view(np.uint16)
        return np.ascontiguousarray(
            np.concatenate([q, o[:, None]], axis=1).T
        )

    def feed(self, ch) -> list:
        """One SoA chunk in → the panes it completed (possibly [])."""
        ts = np.asarray(ch["ts"], np.int64)
        if len(ts) == 0:
            return []
        xy = np.stack(
            [np.asarray(ch["x"], np.float64),
             np.asarray(ch["y"], np.float64)], axis=1
        )
        oid = np.asarray(ch["oid"])
        prev_last = (int(self._pend_ts[-1]) if len(self._pend_ts)
                     else self._cur)
        if int(ts[0]) < max(self._cur, prev_last) or (
                len(ts) > 1 and bool(np.any(np.diff(ts) < 0))):
            raise ValueError(
                "out-of-order event stream: wire panes require "
                "non-decreasing timestamps; "
                f"open pane starts at {self._cur} ms"
            )
        self._pend_ts = np.concatenate([self._pend_ts, ts])
        self._pend_xy = np.concatenate([self._pend_xy, xy])
        self._pend_oid = np.concatenate([self._pend_oid, oid])
        # Emit every pane strictly BEFORE the newest event's pane (the
        # in-order watermark: a later event closes all earlier panes).
        out = []
        newest = int(self._pend_ts[-1])
        while self._cur + self._slide <= newest:
            hi = int(np.searchsorted(
                self._pend_ts, self._cur + self._slide, "left"
            ))
            out.append(self._pack(self._pend_xy[:hi], self._pend_oid[:hi]))
            self._pend_ts = self._pend_ts[hi:]
            self._pend_xy = self._pend_xy[hi:]
            self._pend_oid = self._pend_oid[hi:]
            self._cur += self._slide
        return out

    def flush(self) -> list:
        """End of stream: the open pane's events as one final pane."""
        if not len(self._pend_ts):
            return []
        out = [self._pack(self._pend_xy, self._pend_oid)]
        self._pend_ts = np.zeros(0, np.int64)
        self._pend_xy = np.zeros((0, 2), np.float64)
        self._pend_oid = np.zeros(0, np.int64)
        self._cur += self._slide
        return out

    def state(self) -> dict:
        return {
            "cur": int(self._cur),
            "slide_ms": int(self._slide),
            # wire-format identity: a checkpoint quantized against one
            # grid extent must not restore into another
            "wire_origin": [float(v) for v in self._wf.origin],
            "wire_scale": [float(v) for v in self._wf.scale],
            "pend_ts": np.asarray(self._pend_ts),
            "pend_xy": np.asarray(self._pend_xy),
            "pend_oid": np.asarray(self._pend_oid),
        }

    def restore(self, state: dict) -> None:
        if int(state.get("slide_ms", self._slide)) != self._slide:
            raise ValueError(
                f"checkpoint slide_ms {state['slide_ms']} != this "
                f"assembler's {self._slide}: pane boundaries would "
                "silently shift"
            )
        want = ([float(v) for v in self._wf.origin],
                [float(v) for v in self._wf.scale])
        got = (state.get("wire_origin", want[0]),
               state.get("wire_scale", want[1]))
        if got != want:
            raise ValueError(
                "checkpoint wire format (origin/scale) does not match "
                "this assembler's grid extent"
            )
        self._cur = int(state["cur"])
        self._pend_ts = np.asarray(state["pend_ts"], np.int64)
        self._pend_xy = np.asarray(state["pend_xy"], np.float64)
        self._pend_oid = np.asarray(state["pend_oid"])


def wire_panes(chunks, wire_format: WireFormat, slide_ms: int,
               start_ms: int):
    """Generator form of ``WirePaneAssembler``: chunks in, every completed
    pane out, final partial pane flushed at end of stream."""
    asm = WirePaneAssembler(wire_format, slide_ms, start_ms)
    for ch in chunks:
        yield from asm.feed(ch)
    yield from asm.flush()
