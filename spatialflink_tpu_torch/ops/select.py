"""First-``k`` selection along the last axis, with no sort.

The JAX package's ``ops/select.py`` keeps three strategies for the same
selection (``lax.top_k`` over a 0/1 mask, a prefix-sum one-hot, and a
prefix sum searched by bisection) and picks one per backend. They select
the same set: the first ``k`` set bits of each row, ascending. The port
keeps one, ``first_k_prefix_indices``: a prefix sum and one batched
``searchsorted`` over it, on any device. ``torch.topk`` over the mask
would promise no order among its ties (ROADMAP Queue C, "Top-k tie
order").
"""

from __future__ import annotations

import torch


def first_k_prefix_indices(mask: torch.Tensor, k: int):
    """The first ``k`` set bits of ``mask`` (..., C) along its last axis.

    Returns ``(ci, count, overflow)``: ``ci`` (..., k) int32, slot ``s``
    the lane index of the (s+1)-th set bit of its row, ascending; past a
    row's count the slot holds C - 1, an in-range index to be masked by
    ``count`` downstream (as the JAX function's clipped search gives);
    ``count`` (...,) int32 the set bits of each row; ``overflow`` ()
    int32 the set bits beyond ``k`` over all rows (the callers' retry
    contract: the selection is complete iff it is 0).

    The prefix sum is nondecreasing, so the (s+1)-th set bit is the first
    lane whose prefix reaches s + 1: a left-sided ``searchsorted``."""
    c = mask.shape[-1]
    prefix = torch.cumsum(mask, dim=-1, dtype=torch.int32)
    count = prefix[..., -1]
    overflow = torch.clamp(count - k, min=0).sum(dtype=torch.int32)
    target = torch.arange(1, k + 1, dtype=torch.int32, device=mask.device)
    target = target.expand(count.shape + (k,)).contiguous()
    ci = torch.searchsorted(prefix.contiguous(), target, side="left",
                            out_int32=True)
    return torch.clamp(ci, max=c - 1), count, overflow
