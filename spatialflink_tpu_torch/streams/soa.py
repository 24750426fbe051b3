"""Structure-of-arrays streaming: chunked ingest → vectorized windows.

The high-rate path. Sources deliver chunks of SoA arrays (``{"ts", "x",
"y", ...}``); the assembler buffers them as arrays, and each fired window
is a slice of a ts-sorted consolidation, with no per-event Python object.

Semantics are the JAX package's ``streams/soa.py``: watermark = max_ts −
ooo; a window fires once when the watermark passes its end; every window
holding at least one event fires exactly once; events older than every
live window at consolidation time are dropped and counted
(``dropped_late``). ``SoaWindowAssembler`` takes point chunks,
``RaggedSoaWindowAssembler`` geometry chunks (each object's packed
boundary chain, ragged), both on the one watermark state machine.
``csv_chunk_source`` reads a file into chunks through a parser.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np

from spatialflink_tpu_torch import overload, slo
from spatialflink_tpu_torch.faults import faults
from spatialflink_tpu_torch.telemetry import telemetry


def earliest_window_of(ts_val: int, size: int, slide: int) -> int:
    """Start of the earliest sliding window containing ``ts_val``."""
    last = ts_val - ((ts_val % slide) + slide) % slide
    return last - size + slide


@dataclass
class SoaWindow:
    """One fired window: [start, end) and its event arrays."""

    start: int
    end: int
    arrays: Dict[str, np.ndarray]  # each (n,), same order, incl. "ts"

    @property
    def count(self) -> int:
        return len(self.arrays["ts"])


class _SlidingAssemblerBase:
    """The sliding-window watermark state machine. Subclasses supply the
    payload: ``_ingest`` (store a chunk, return its ts array),
    ``_consolidate`` (merge and ts-sort, return the sorted ts),
    ``_window`` (rows [lo:hi) as a fired window) and ``_evict`` (drop rows
    below ``keep_from``)."""

    def __init__(self, size_ms: int, slide_ms: int, ooo_ms: int = 0):
        if size_ms <= 0 or slide_ms <= 0:
            raise ValueError("size and slide must be positive")
        self.size = int(size_ms)
        self.slide = int(slide_ms)
        self.ooo = int(ooo_ms)
        self._max_ts: Optional[int] = None
        self._next_start: Optional[int] = None  # earliest unfired window start
        self.dropped_late = 0

    def feed(self, chunk):
        """Add one chunk; return the windows that fire."""
        if faults.armed:  # fault injection point (faults.py)
            faults.hit("soa.feed")
        ts = self._ingest(chunk)
        if ts is None or len(ts) == 0:
            return []
        mx = int(ts.max())
        if self._max_ts is None or mx > self._max_ts:
            self._max_ts = mx
        if self._next_start is None:
            # Earliest window that could ever hold a non-late event: bounded
            # by both the first observed timestamp and the initial watermark.
            horizon = min(int(ts.min()), self._max_ts - self.ooo)
            self._next_start = earliest_window_of(horizon, self.size, self.slide)
        return self._fire(self._max_ts - self.ooo)

    def flush(self):
        """End of stream: fire everything up to the last event."""
        if self._max_ts is None:
            return []
        # record_lag=False: the flush watermark is artificial (max_ts +
        # size + 1), not a late watermark, and must not feed the gauge.
        return self._fire(self._max_ts + self.size + 1, record_lag=False)

    def stream(self, chunks):
        for c in chunks:
            yield from self.feed(c)
        yield from self.flush()

    def _fire(self, wm: int, record_lag: bool = True):
        out = []
        if self._next_start is None or self._next_start + self.size > wm:
            return out
        ts = self._consolidate()
        # Events older than the earliest live window start are late beyond
        # every remaining window: count (eviction below trims them).
        late = int(np.searchsorted(ts, self._next_start, side="left"))
        if late:
            self.dropped_late += late
            telemetry.record_late_drop(late)
        while self._next_start + self.size <= wm:
            s, e = self._next_start, self._next_start + self.size
            lo = int(np.searchsorted(ts, s, side="left"))
            hi = int(np.searchsorted(ts, e, side="left"))
            if hi > lo:
                out.append(self._window(s, e, lo, hi))
                if record_lag:
                    # Event-time ms between window end and the watermark
                    # that fired it; the SLO and overload hooks ride the
                    # same fire site.
                    telemetry.record_watermark_lag(wm - e)
                    slo.on_window_fired(hi - lo, lag_ms=wm - e)
                    overload.on_window_fired(hi - lo, lag_ms=wm - e, end=e)
                self._next_start += self.slide
            elif lo < len(ts):
                # Empty window: jump to the earliest window holding the
                # next buffered event.
                self._next_start = max(
                    self._next_start + self.slide,
                    earliest_window_of(int(ts[lo]), self.size, self.slide),
                )
            else:
                # No buffered events at/after s: wait for more data.
                self._next_start += self.slide
                break
        # Evict rows no live window can need.
        keep_from = int(np.searchsorted(ts, self._next_start, side="left"))
        if keep_from:
            self._evict(keep_from)
        return out


class SoaWindowAssembler(_SlidingAssemblerBase):
    """Sliding event-time windows over SoA chunks."""

    def __init__(self, size_ms: int, slide_ms: int, ooo_ms: int = 0):
        super().__init__(size_ms, slide_ms, ooo_ms)
        self._chunks: List[Dict[str, np.ndarray]] = []

    def _ingest(self, chunk: Dict[str, np.ndarray]):
        ts = np.asarray(chunk["ts"], np.int64)
        if len(ts) == 0:
            return None
        self._chunks.append({k: np.asarray(v) for k, v in chunk.items()})
        return ts

    def _consolidate(self) -> np.ndarray:
        if len(self._chunks) == 1:
            merged = self._chunks[0]
        else:
            merged = {
                k: np.concatenate([c[k] for c in self._chunks])
                for k in self._chunks[0]
            }
        ts = merged["ts"]
        if np.any(ts[:-1] > ts[1:]):  # in-order streams skip the sort
            order = np.argsort(ts, kind="stable")
            merged = {k: v[order] for k, v in merged.items()}
        self._chunks = [merged]
        return merged["ts"]

    def _window(self, s, e, lo, hi) -> SoaWindow:
        merged = self._chunks[0]
        return SoaWindow(s, e, {k: v[lo:hi] for k, v in merged.items()})

    def _evict(self, keep_from: int) -> None:
        self._chunks = [{k: v[keep_from:] for k, v in self._chunks[0].items()}]


def csv_chunk_source(path: str, parser, chunk_bytes: int = 1 << 22):
    """File → SoA chunks through a buffer-at-a-time parser: reads about
    ``chunk_bytes`` at a time, cut at line boundaries, and yields
    ``parser.parse(block)`` for each block (a final line without its
    newline included). ``parser`` is any object whose ``parse(bytes)``
    returns a chunk the assemblers take."""
    with open(path, "rb") as f:
        rest = b""
        while True:
            block = f.read(chunk_bytes)
            if not block:
                if rest.strip():
                    yield parser.parse(rest)
                return
            block = rest + block
            cut = block.rfind(b"\n")
            if cut < 0:
                rest = block
                continue
            rest = block[cut + 1:]
            yield parser.parse(block[: cut + 1])


def _ragged_reorder(flat: np.ndarray, lengths: np.ndarray, order: np.ndarray):
    """Reorder a ragged array (``flat`` rows grouped into ``lengths``-sized
    runs) by a per-group ``order`` — fully vectorized."""
    starts = np.concatenate([[0], np.cumsum(lengths)])[:-1]
    new_lens = lengths[order]
    total = int(new_lens.sum())
    pos_base = np.repeat(np.cumsum(new_lens) - new_lens, new_lens)
    src = (
        np.repeat(starts[order], new_lens)
        + np.arange(total, dtype=np.int64)
        - pos_base
    )
    return flat[src], new_lens


@dataclass
class RaggedSoaWindow:
    """One fired geometry window: object rows + their flat boundary chains.

    ``lengths[i]`` vertices of object ``i`` occupy
    ``verts[offsets[i]:offsets[i+1]]`` where ``offsets = cumsum``;
    ``edge_valid`` (optional) is the matching flat (length−1)-run edge
    mask (multi-ring seams invalid).
    """

    start: int
    end: int
    ts: np.ndarray  # (n,)
    oid: np.ndarray  # (n,) dense int32
    lengths: np.ndarray  # (n,)
    verts: np.ndarray  # (sum lengths, 2)
    edge_valid: Optional[np.ndarray] = None  # (sum lengths - n,) bool

    @property
    def count(self) -> int:
        return len(self.ts)


class RaggedSoaWindowAssembler(_SlidingAssemblerBase):
    """Sliding event-time windows over ragged GEOMETRY chunks.

    Chunks are ``{"ts": (n,), "oid": (n,), "lengths": (n,),
    "verts": (sum lengths, 2)}``: each object's packed boundary chain
    (closed rings for polygons, open for polylines). A chunk may carry
    ``"edge_valid"`` (sum lengths − n,), the flat per-object edge mask
    whose False entries are the seams of multi-ring objects; every chunk
    of a stream carries it or none does. Watermark/firing semantics come
    from the shared state machine (_SlidingAssemblerBase).
    """

    def __init__(self, size_ms: int, slide_ms: int, ooo_ms: int = 0):
        super().__init__(size_ms, slide_ms, ooo_ms)
        self._rows: List[Dict[str, np.ndarray]] = []
        self._verts: List[np.ndarray] = []
        self._edges: Optional[List[np.ndarray]] = None
        self._edge_mode: Optional[bool] = None  # fixed by the first chunk

    def _ingest(self, chunk: Dict[str, np.ndarray]):
        ts = np.asarray(chunk["ts"], np.int64)
        if len(ts) == 0:
            return None
        lengths = np.asarray(chunk["lengths"], np.int64)
        oid = np.asarray(chunk["oid"], np.int32)
        verts = np.asarray(chunk["verts"], np.float64)
        if not (len(ts) == len(oid) == len(lengths)):
            raise ValueError(
                f"ragged chunk row mismatch: ts={len(ts)} oid={len(oid)} "
                f"lengths={len(lengths)} must be equal"
            )
        if int(lengths.sum()) != len(verts):
            raise ValueError(
                f"ragged chunk mismatch: lengths sum to {int(lengths.sum())}"
                f" but verts has {len(verts)} rows — offsets for every later"
                " object would silently misalign"
            )
        edges = chunk.get("edge_valid")
        if self._edge_mode is None:
            self._edge_mode = edges is not None
        elif self._edge_mode != (edges is not None):
            # Both directions must fail loudly: a mode flip either way
            # would misalign masks against the edge offsets.
            raise ValueError(
                "all chunks of one stream must agree on carrying edge_valid"
            )
        if edges is not None:
            edges = np.asarray(edges, bool)
            if int((lengths - 1).sum()) != len(edges):
                raise ValueError(
                    f"ragged chunk edge-mask mismatch: lengths-1 sums to "
                    f"{int((lengths - 1).sum())} but edge_valid has "
                    f"{len(edges)} entries"
                )
            if self._edges is None:
                self._edges = []
            self._edges.append(edges)
        self._rows.append({"ts": ts, "oid": oid, "lengths": lengths})
        self._verts.append(verts)
        return ts

    def _consolidate(self) -> np.ndarray:
        if len(self._rows) > 1:
            rows = {
                k: np.concatenate([c[k] for c in self._rows])
                for k in ("ts", "oid", "lengths")
            }
            verts = np.concatenate(self._verts)
        else:
            rows = self._rows[0]
            verts = self._verts[0]
        edges = None
        if self._edges is not None:
            edges = (np.concatenate(self._edges) if len(self._edges) > 1
                     else self._edges[0])
        ts = rows["ts"]
        if np.any(ts[:-1] > ts[1:]):  # in-order streams skip the sort
            order = np.argsort(ts, kind="stable")
            verts, _ = _ragged_reorder(verts, rows["lengths"], order)
            if edges is not None:
                edges, _ = _ragged_reorder(edges, rows["lengths"] - 1, order)
            rows = {k: v[order] for k, v in rows.items()}
        self._rows = [rows]
        self._verts = [verts]
        if edges is not None:
            self._edges = [edges]
        self._offsets = np.concatenate([[0], np.cumsum(rows["lengths"])])
        self._e_offsets = np.concatenate(
            [[0], np.cumsum(rows["lengths"] - 1)])
        return rows["ts"]

    def _window(self, s, e, lo, hi) -> RaggedSoaWindow:
        rows = self._rows[0]
        offs = self._offsets
        ev = None
        if self._edges is not None:
            eo = self._e_offsets
            ev = self._edges[0][eo[lo]:eo[hi]]
        return RaggedSoaWindow(
            s, e, rows["ts"][lo:hi], rows["oid"][lo:hi],
            rows["lengths"][lo:hi],
            self._verts[0][offs[lo]:offs[hi]],
            edge_valid=ev,
        )

    def _evict(self, keep_from: int) -> None:
        rows = self._rows[0]
        offs = self._offsets
        if self._edges is not None:
            self._edges = [self._edges[0][self._e_offsets[keep_from]:]]
        self._rows = [{k: v[keep_from:] for k, v in rows.items()}]
        self._verts = [self._verts[0][offs[keep_from]:]]
