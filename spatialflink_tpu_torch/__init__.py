"""spatialflink_tpu_torch — the PyTorch/CUDA port of spatialflink_tpu.

The JAX package ``spatialflink_tpu`` is the reference; this package runs
the same operators in PyTorch, with the TPU kernels rewritten by hand in
CUDA for Hopper (``kernels/csrc``). Entry points run on the card unless
the caller passes ``device="cpu"``, where each kernel's plain PyTorch
version runs instead. The package imports nothing of JAX.
"""
