"""Wire-plane kNN pane digest: the step ``run_wire_panes`` runs per pane.

One pane of 6 B/pt wire records (``streams/wire.py``) → the per-object
digest (``ops/knn.py``). On a card the step is the hand kernel
(``ops/wire_digest_kernel.py``); on the CPU it is the kernel's plain
PyTorch version. ``select_wire_digest_step`` checks the kernel against
its plain version on the first pane and raises if they differ: the card
path never quietly runs the plain version.
"""

from __future__ import annotations

import numpy as np
import torch

from spatialflink_tpu_torch.ops.wire_digest_kernel import (  # noqa: F401
    wire_digest,
    wire_digest_cuda,
    wire_digest_plain,
    wire_plane_coords,
)

#: Strategy values per device. "auto" takes the device's own step.
STRATEGIES = {"cuda": ("auto", "cuda"), "cpu": ("auto", "torch")}

#: Telemetry label of the step per kind: the JAX package's function that
#: runs the same digest (B1's Pallas step on the accelerator, the XLA step
#: on the CPU), so an ablation spec or a ledger names it in both packages.
WIRE_DIGEST_LABELS = {"cuda": "wire_digest_pallas_step",
                      "torch": "wire_digest_xla"}


def digests_agree(seg_a, rep_a, seg_b, rep_b) -> bool:
    """The reference's self-check predicate: identical in-radius object
    SETS, distances within 1 ulp, and identical representatives wherever
    the distances agree exactly. Host-side (copies both digests)."""
    sa, sb = seg_a.cpu().numpy(), seg_b.cpu().numpy()
    ra, rb = rep_a.cpu().numpy(), rep_b.cpu().numpy()
    big = np.asarray(np.finfo(sa.dtype).max, sa.dtype)
    live_a, live_b = sa != big, sb != big
    if not np.array_equal(live_a, live_b):
        return False
    if live_a.any():
        la, lb = sa[live_a], sb[live_a]
        ulp = np.spacing(np.maximum(np.abs(la), np.abs(lb)))
        if not np.all(np.abs(la - lb) <= ulp):
            return False
        exact = live_a & (sa == sb)
        if not np.array_equal(ra[exact], rb[exact]):
            return False
    return True


def check_cand(cand) -> None:
    """``cand``, the JAX package's candidate budget of the Pallas digest,
    must be a positive int. The hand kernel has no candidate buffer, so
    the value changes nothing here."""
    if isinstance(cand, bool) or not isinstance(cand, (int, np.integer)) \
            or cand <= 0:
        raise ValueError(f"cand must be a positive int, got {cand!r}")


def check_interpret(interpret, device_type: str) -> None:
    """``interpret``, the JAX flag that runs a Pallas kernel in its
    interpreter, is accepted only on the CPU, where every step already is
    its kernel's plain version and the flag changes nothing. On a card the
    wire path always runs its hand kernels, so ``interpret=True`` there
    raises ``ValueError``."""
    if interpret and device_type != "cpu":
        raise ValueError(
            f"interpret=True is not available on {device_type}: the card "
            "runs the hand kernels (pass interpret=False, or run on the CPU)"
        )


def select_wire_digest_step(sample_wire: torch.Tensor, sample_n: int,
                            query_xy, scale, origin, radius, *,
                            num_segments: int, cand: int = 8192,
                            interpret: bool = False,
                            strategy: str = "auto"):
    """Pick the digest step for ``sample_wire``'s device.

    Returns ``(kind, step)`` with ``step(wire, n_valid) -> KnnPaneDigest``.
    On a card, kind is ``"cuda"``: the kernel runs on the sample pane
    beside its plain version, and a digest that is not bit-identical
    raises ``RuntimeError``. On the CPU, kind is ``"torch"``. A strategy
    that names the other device's step raises ``ValueError``.

    ``cand`` and ``interpret`` keep the JAX signature: ``cand`` is
    validated (``check_cand``) and otherwise unused; ``interpret=True`` is
    accepted on the CPU only (``check_interpret``).
    """
    check_cand(cand)
    dev = sample_wire.device.type
    check_interpret(interpret, dev)
    if strategy not in STRATEGIES[dev]:
        raise ValueError(
            f"strategy {strategy!r} is not available on {dev} "
            f"(choose from {STRATEGIES[dev]})"
        )
    consts = (query_xy, scale, origin, radius)

    def step(wire, n_valid):
        return wire_digest(wire, n_valid, *consts, num_segments)[0]

    if dev == "cpu":
        return "torch", step
    d_k, c_k = wire_digest_cuda(sample_wire, sample_n, *consts, num_segments)
    d_p, c_p = wire_digest_plain(sample_wire, sample_n, *consts,
                                 num_segments)
    if not (torch.equal(d_k.seg_min, d_p.seg_min)
            and torch.equal(d_k.rep, d_p.rep) and torch.equal(c_k, c_p)):
        raise RuntimeError(
            "wire-digest self-check failed: the CUDA kernel's digest of the "
            "first pane differs from its plain PyTorch version"
        )
    return "cuda", step

