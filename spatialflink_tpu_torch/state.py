"""State carried across from a JAX deployment to the port.

A wire-kNN deployment holds the operator's checkpoint carry: the digest
ring of the window's last panes, their event counts and the next pane
index (and, with the delta codec, the encoder's predictor tables).
``carry_from_jax`` turns the JAX operator's carry into the port's, so a
port operator resumes mid-window where the JAX one stopped.

A join deployment holds its two SoA window assemblers (and its pair
budget, a constructor argument of ``PointPointJoinQuery``);
``soa_assembler_from_jax`` turns a JAX assembler snapshot into the port's.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from spatialflink_tpu_torch.device import resolve_device
from spatialflink_tpu_torch.streams.soa import SoaWindowAssembler


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
