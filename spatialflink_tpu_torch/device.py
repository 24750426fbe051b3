"""Device resolution for the port's entry points.

Every entry point takes an explicit ``device`` and defaults to the card:
the hand kernels are the product, the CPU runs only the kernels' plain
PyTorch versions (the tests ask for it with ``device="cpu"``). Asking for
``cuda`` on a machine without a card raises; nothing falls back to the
CPU, so a run on the wrong machine can never pass for a card run.
"""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """``"cuda"``/``"cuda:N"``/``"cpu"``/``torch.device`` → a device that
    exists here, or ``RuntimeError`` when a card is asked for and absent."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {dev} requested but torch.cuda.is_available() is "
                "False; pass device='cpu' to run the plain PyTorch path"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    return dev
