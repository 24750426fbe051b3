"""Polygon packing, point-in-polygon and point→polygon distance.

Packed layout (``pack_rings``), as in the JAX package's ``ops/polygon.py``:
``verts`` (V, 2) holds the rings back to back, each closed (first vertex
repeated last); ``edge_valid`` (V-1,) is True for real ring edges and
False for the seam between two rings and for padding. Holes need no
special case: even-odd crossing counting over all rings is the ray-cast
containment with holes. Packing is host numpy; containment is plain
PyTorch on the points' device, in the coordinates' dtype (float32, or
float64 in the float64 mode).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from spatialflink_tpu_torch.ops.distances import point_polyline_distance

#: Lanes (points × boundaries × edges) one block of the batched
#: containment evaluates; bounds its temporaries to a few hundred MB.
BLOCK_LANES = 1 << 24
#: The block on the CPU, small enough for its temporaries to stay in cache
#: (the result does not depend on the block).
BLOCK_LANES_CPU = 1 << 19


def _pad(verts, edge_valid, pad_to):
    if pad_to is not None:
        if pad_to < len(verts):
            raise ValueError(f"pad_to={pad_to} < {len(verts)} vertices")
        pad = pad_to - len(verts)
        if pad:
            verts = np.concatenate([verts, np.repeat(verts[-1:], pad, axis=0)])
            edge_valid = np.concatenate([edge_valid, np.zeros(pad, bool)])
    return verts, edge_valid


def _seams(parts) -> Tuple[np.ndarray, np.ndarray]:
    """Concatenated parts, with the edge from one part to the next
    invalid."""
    verts = np.concatenate(parts, axis=0)
    edge_valid = np.ones(len(verts) - 1, bool)
    pos = 0
    for r in parts[:-1]:
        pos += len(r)
        edge_valid[pos - 1] = False
    return verts, edge_valid


def pack_rings(rings: Sequence[np.ndarray], pad_to: Optional[int] = None,
               dtype=np.float64) -> Tuple[np.ndarray, np.ndarray]:
    """Pack polygon rings into (verts, edge_valid), ``verts`` in
    ``dtype``, closing each ring that is open. Padding vertices repeat the
    last real vertex with invalid edges, so padded shapes never change
    results."""
    closed = []
    for r in rings:
        r = np.asarray(r, dtype=dtype)
        if r.ndim != 2 or r.shape[1] != 2:
            raise ValueError("each ring must be (R, 2)")
        if not np.array_equal(r[0], r[-1]):
            r = np.concatenate([r, r[:1]], axis=0)
        closed.append(r)
    return _pad(*_seams(closed), pad_to)


def pack_polyline(parts: Sequence[np.ndarray], pad_to: Optional[int] = None,
                  dtype=np.float64) -> Tuple[np.ndarray, np.ndarray]:
    """Pack open polyline part(s) into (verts, edge_valid), ``verts`` in
    ``dtype``, no closing."""
    return _pad(*_seams([np.asarray(p, dtype=dtype) for p in parts]),
                pad_to)


def used_edges(verts: torch.Tensor, ev: torch.Tensor):
    """``verts`` (G, V, 2) and ``ev`` (G, V-1) bool cut to the edge columns
    up to the last one valid in any boundary (at least one): the columns
    after it are the padding of every boundary, valid nowhere, so they
    reach no minimum and cross no ray. A CPU saving of the plain
    versions; on the card finding the cut would wait for the device."""
    used = torch.nonzero(ev.any(dim=0))
    e = int(used[-1]) + 1 if used.numel() else 1
    return verts[:, :e + 1], ev[:, :e]


def points_in_polygon(p: torch.Tensor, verts: torch.Tensor,
                      edge_valid: torch.Tensor) -> torch.Tensor:
    """Even-odd ray-cast containment of points ``p`` (N, 2) in one packed
    polygon → (N,) bool. A point exactly on an edge may land either way,
    as with JTS's non-boundary-inclusive ``contains``."""
    return points_in_polygons(p, verts[None], edge_valid[None])[:, 0]


def points_in_polygons(p: torch.Tensor, verts: torch.Tensor,
                       edge_valid: torch.Tensor,
                       sel: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Batched ``points_in_polygon``: (N, C) bool, entry [i, j] for point
    i in polygon ``sel[i, j]`` of ``verts`` (G, V, 2) / ``edge_valid``
    (G, V-1), or in polygon j when ``sel`` is None (C = G). Counts the
    crossings of a +x ray with every valid edge (the half-open span test
    counts a shared vertex once), in blocks of points of at most
    ``BLOCK_LANES`` lanes (``BLOCK_LANES_CPU`` on the CPU, where the edge
    columns valid in no polygon are cut first)."""
    ev = edge_valid.bool()
    if not p.is_cuda:
        verts, ev = used_edges(verts, ev)
    n, g = p.shape[0], verts.shape[0]
    c = g if sel is None else sel.shape[1]
    e = verts.shape[1] - 1
    out = torch.empty((n, c), dtype=torch.bool, device=p.device)
    lanes = BLOCK_LANES if p.is_cuda else BLOCK_LANES_CPU
    step = max(1, lanes // max(1, c * e))
    for i0 in range(0, n, step):
        i1 = min(n, i0 + step)
        x = p[i0:i1, 0, None, None]
        y = p[i0:i1, 1, None, None]
        if sel is None:
            v, ok = verts[None], ev[None]
        else:
            s = sel[i0:i1].long()
            v, ok = verts[s], ev[s]
        x1, y1 = v[..., :-1, 0], v[..., :-1, 1]
        x2, y2 = v[..., 1:, 0], v[..., 1:, 1]
        spans = (y1 > y) != (y2 > y)
        dy = y2 - y1
        nz = dy != 0
        t = torch.where(nz, (y - y1) / torch.where(nz, dy, 1.0), 0.0)
        x_int = x1 + t * (x2 - x1)
        crossings = spans & (x < x_int) & ok
        out[i0:i1] = crossings.sum(dim=-1) % 2 == 1
    return out


def point_polygon_distance(p: torch.Tensor, verts: torch.Tensor,
                           edge_valid: torch.Tensor) -> torch.Tensor:
    """Point→polygon distance with JTS semantics: 0 inside, else the min
    edge distance (DistanceFunctions.java:33-36)."""
    inside = points_in_polygon(p, verts, edge_valid)
    d = point_polyline_distance(p, verts, edge_valid)
    return torch.where(inside, torch.zeros((), dtype=d.dtype,
                                           device=d.device), d)


def signed_area(ring: np.ndarray) -> float:
    """Shoelace signed area of a host-side ring (counter-clockwise
    positive)."""
    r = np.asarray(ring, np.float64)
    x, y = r[:, 0], r[:, 1]
    return 0.5 * float(np.sum(x * np.roll(y, -1) - np.roll(x, -1) * y))
