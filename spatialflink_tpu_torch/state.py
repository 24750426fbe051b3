"""State carried across from a JAX deployment to the port.

A wire-kNN deployment holds the operator's checkpoint carry: the digest
ring of the window's last panes, their event counts and the next pane
index (and, with the delta codec, the encoder's predictor tables).
``carry_from_jax`` turns the JAX operator's carry into the port's, so a
port operator resumes mid-window where the JAX one stopped.

A join deployment holds its two SoA window assemblers (and its pair
budget, a constructor argument of ``PointPointJoinQuery``);
``soa_assembler_from_jax`` turns a JAX assembler snapshot into the port's.

A range deployment holds its query set and, on the pruned polygon paths,
the grown candidate count and candidate-lane budget;
``range_state_from_jax`` turns both into the port's.

Every operator holds its objID interner; ``interner_from_jax`` copies a
JAX operator's, so a port kNN operator maps every objID to the segment
the JAX one does (the top-k's tie order is by segment id).

A pane-carry kNN deployment (``query_panes``, ``run_soa_panes``) holds
the digests of its live panes; ``pane_carry_from_jax`` turns the JAX
operator's into the port's, so a port operator given them and the
interner continues the JAX operator's windows.

A trajectory deployment holds tAggregate's MapState analog, tStats'
realtime running totals or tJoin's grown budgets;
``trajectory_state_from_jax`` turns them into the port constructor's
keyword arguments.

A pane-carry tJoin scan holds its ring planes, digest rings and
counters; ``tjoin_pane_carry_from_jax`` turns a JAX ``TJoinPaneCarry``
into the port's, so a port scan continues where a JAX scan stopped.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from spatialflink_tpu_torch.device import resolve_device
from spatialflink_tpu_torch.models import objects
from spatialflink_tpu_torch.streams.soa import SoaWindowAssembler
from spatialflink_tpu_torch.utils.interning import Interner


def _tensor(a, dtype, device) -> torch.Tensor:
    # Copy before the tensor exists: torch.from_numpy shares memory with
    # its source, and the source may be mutated after the carry is taken.
    return torch.from_numpy(np.array(a, dtype=dtype, copy=True)).to(device)


def carry_from_jax(carry: dict, device="cuda",
                   codec_state: Optional[dict] = None) -> dict:
    """JAX ``_wire_pane_carry`` (``next_pane``; ``digests`` as (seg_min,
    rep) arrays; ``counts``) → the port's carry on ``device``.

    ``codec_state``: optionally a JAX ``WirePaneEncoder.state()``; a
    pipelined delta-codec resume then starts its encoder and device
    predictor tables from it. Restore the result with
    ``PointPointKNNQuery.restore_wire_pane_carry``."""
    dev = resolve_device(device)
    digests = [
        (_tensor(s, np.float32, dev), _tensor(r, np.int32, dev))
        for s, r in carry["digests"]
    ]
    out = {
        "next_pane": int(carry["next_pane"]),
        "digests": digests,
        "counts": [int(c) for c in carry.get("counts",
                                             [1] * len(digests))],
    }
    if codec_state is not None:
        out["codec"] = {
            "num_segments": int(codec_state["num_segments"]),
            "pred_x": np.array(codec_state["pred_x"], np.uint16, copy=True),
            "pred_y": np.array(codec_state["pred_y"], np.uint16, copy=True),
        }
    return out


def soa_assembler_from_jax(state: dict, size_ms: int, slide_ms: int,
                           ooo_ms: int = 0):
    """A JAX ``checkpoint.soa_assembler_state`` dict (``max_ts``,
    ``next_start``, ``dropped_late``, ``chunks``) → a port
    ``SoaWindowAssembler`` with the same window spec that fires, on the
    rest of the stream, what the JAX assembler would have fired. The
    chunks are copied: the JAX side may go on mutating its own."""
    asm = SoaWindowAssembler(size_ms, slide_ms, ooo_ms=ooo_ms)
    asm._max_ts = None if state["max_ts"] is None else int(state["max_ts"])
    asm._next_start = (None if state["next_start"] is None
                       else int(state["next_start"]))
    asm.dropped_late = int(state["dropped_late"])
    asm._chunks = [{k: np.array(v, copy=True) for k, v in c.items()}
                   for c in state["chunks"]]
    return asm


def _query_from_jax(q):
    kind = type(q).__name__
    meta = dict(obj_id=q.obj_id, timestamp=int(q.timestamp))
    if kind == "Point":
        return objects.Point(x=float(q.x), y=float(q.y), **meta)
    if kind == "MultiPolygon":
        return objects.MultiPolygon(
            rings=[np.array(r, np.float64) for r in q.rings],
            parts=[int(n) for n in q.parts], **meta)
    if kind == "Polygon":
        return objects.Polygon(
            rings=[np.array(r, np.float64) for r in q.rings], **meta)
    if kind == "MultiLineString":
        return objects.MultiLineString(
            coords=np.array(q.coords, np.float64),
            parts=[np.array(p, np.float64) for p in q.parts], **meta)
    if kind == "LineString":
        return objects.LineString(coords=np.array(q.coords, np.float64),
                                  **meta)
    raise TypeError(f"no port counterpart for query object {kind}")


def range_state_from_jax(query_set, jax_op=None) -> Tuple[List, dict]:
    """A JAX range query set (``Point``, ``Polygon``, ``LineString`` and
    their Multi forms, read through their numpy arrays) → the port's
    objects, and the keyword arguments that start a port range operator
    where ``jax_op`` (a JAX ``PointPolygonRangeQuery`` or sibling) stands:
    its persisted ``_ncand`` and ``_cand_budget``, where it has them::

        queries, kw = range_state_from_jax(jax_queries, jax_op)
        op = PointPolygonRangeQuery(conf, grid, **kw)
    """
    if not isinstance(query_set, (list, tuple)):
        query_set = [query_set]
    kw = {}
    for attr, key in (("_ncand", "ncand"), ("_cand_budget", "cand_budget")):
        if jax_op is not None and hasattr(jax_op, attr):
            kw[key] = int(getattr(jax_op, attr))
    return [_query_from_jax(q) for q in query_set], kw


def interner_from_jax(jax_op) -> Interner:
    """A JAX operator's objID ``Interner`` (or the interner itself), read
    through its plain Python state (its keys in segment order) → the
    port's, with every key at the same segment::

        op = PointPolygonKNNQuery(conf, grid)
        op.interner = interner_from_jax(jax_op)
    """
    src = getattr(jax_op, "interner", jax_op)
    out = Interner()
    for key in src._to_key:
        out.intern(key)
    return out


def pane_carry_from_jax(jax_op, device="cuda") -> Tuple[Optional[dict],
                                                        Optional[dict]]:
    """A JAX kNN operator's pane carries → the port's, on ``device``:
    ``_pane_carry`` (``query_panes``: pane start → (nseg, seg_min, rep,
    events), or None for an empty pane) with each event copied into a
    port object, and ``_pane_carry_soa`` (``run_soa_panes``: pane start →
    (seg_min, rep), or None). Either is None where the JAX operator has
    none::

        op.interner = interner_from_jax(jax_op)
        op._pane_carry, op._pane_carry_soa = pane_carry_from_jax(jax_op)
    """
    dev = resolve_device(device)

    def digest(sm, rp):
        return (_tensor(sm, np.float32, dev), _tensor(rp, np.int32, dev))

    panes = getattr(jax_op, "_pane_carry", None)
    soa = getattr(jax_op, "_pane_carry_soa", None)
    if panes is not None:
        panes = {
            int(ps): None if e is None else (
                int(e[0]), *digest(e[1], e[2]),
                [_query_from_jax(ev) for ev in e[3]])
            for ps, e in panes.items()
        }
    if soa is not None:
        soa = {int(ps): None if e is None else digest(*e)
               for ps, e in soa.items()}
    return panes, soa


def join_pane_carry_from_jax(jax_op, op) -> Optional[dict]:
    """A JAX ``PointPointJoinQuery``'s ``_join_pane_carry`` (``panes``:
    pane start → (left events, right events, left batch, right batch);
    ``blocks``: (p, q) → (pairs, overflow)) → the port operator ``op``'s,
    or None where the JAX operator has none. Each JAX event becomes one
    port object, shared by the pane lists and the blocks' pairs; the pane
    batches are rebuilt through ``op.point_batch``, as the JAX package's
    checkpoint restore rebuilds them, so set the interner first::

        op.interner = interner_from_jax(jax_op)
        op._join_pane_carry = join_pane_carry_from_jax(jax_op, op)
    """
    carry = getattr(jax_op, "_join_pane_carry", None)
    if carry is None:
        return None
    port: dict = {}

    def obj(ev):
        key = id(ev)
        if key not in port:
            port[key] = _query_from_jax(ev)
        return port[key]

    panes = {}
    for ps, (lev, rev, _, _) in carry["panes"].items():
        lp, rp = [obj(e) for e in lev], [obj(e) for e in rev]
        panes[int(ps)] = (lp, rp, op.point_batch(lp) if lp else None,
                          op.point_batch(rp) if rp else None)
    blocks = {
        (int(p), int(q)): ([(obj(a), obj(b), float(d)) for a, b, d in pairs],
                           int(over))
        for (p, q), (pairs, over) in carry["blocks"].items()
    }
    return {"panes": panes, "blocks": blocks}


def trajectory_state_from_jax(jax_op) -> dict:
    """A JAX trajectory operator's carried state → the keyword arguments
    that start the port operator of the same family where it stands:
    ``TAggregateQuery``'s ``aggregate_state`` (its sorted ``_skeys``,
    ``_smin``, ``_smax``), ``TStatsQuery``'s ``running`` (the realtime
    totals per objID) or ``TJoinQuery``'s ``pair_budget`` and
    ``tpair_budget`` (its grown ``_max_pairs`` and ``_max_tpairs``).
    The arrays are copied. Copy the interner too, where the state keys
    on interned objIDs::

        op = TAggregateQuery(conf, grid, aggregate="SUM",
                             **trajectory_state_from_jax(jax_op))
        op.interner = interner_from_jax(jax_op)
    """
    if hasattr(jax_op, "_skeys"):
        return {"aggregate_state": tuple(
            np.array(getattr(jax_op, a), np.int64, copy=True)
            for a in ("_skeys", "_smin", "_smax"))}
    if hasattr(jax_op, "_running"):
        return {"running": {
            str(k): (float(s), int(t), int(ts), float(x), float(y))
            for k, (s, t, ts, x, y) in jax_op._running.items()}}
    if hasattr(jax_op, "_max_tpairs"):
        return {"pair_budget": int(jax_op._max_pairs),
                "tpair_budget": int(jax_op._max_tpairs)}
    raise TypeError(
        f"no trajectory state to carry on {type(jax_op).__name__}")


def tjoin_pane_carry_from_jax(carry, device="cuda"):
    """A JAX ``ops/tjoin_panes.py:TJoinPaneCarry`` (its arrays, as numpy or
    JAX arrays) → the port's ``TJoinPaneCarry`` on ``device``: each array
    copied, flattened and given the port's spare trailing slot (an empty
    plane slot, a zero count, an infinite digest). Continue it with
    ``ops/tjoin_panes.py:tjoin_pane_scan``, passing the panes that expire
    during the continued slides (the JAX bench's warm-then-steady split)::

        carry = tjoin_pane_carry_from_jax(jax_warm_carry)
        carry, wmins = tjoin_pane_scan(carry, ts, lps, rps, radius, ...,
                                       lps_expire=..., rps_expire=...)
    """
    from spatialflink_tpu_torch.ops.tjoin_panes import (
        EMPTY_TAG,
        TJoinPaneCarry,
    )

    dev = resolve_device(device)
    spare = {"lwtag": EMPTY_TAG, "rwtag": EMPTY_TAG,
             "digests": np.inf, "block_digests": np.inf}
    out = []
    for name, a in zip(TJoinPaneCarry._fields, carry):
        a = np.asarray(a)
        dt = np.float32 if a.dtype.kind == "f" else np.int32
        if a.ndim:
            a = np.concatenate([a.reshape(-1), [spare.get(name, 0)]])
        out.append(_tensor(a, dt, dev))
    return TJoinPaneCarry(*out)
