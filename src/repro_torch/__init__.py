"""PyTorch/CUDA port of the Flower FL engine, beside the JAX package ``repro``.

Same layout and public names as ``repro``; parameters are nested dicts of
tensors with the JAX key names.  Entry points (``models.build_model``,
``core.TorchClient``, ``core.Server``) run on the CUDA card unless the
caller passes ``device="cpu"``.  The server's reduce and the Int8 uplink
codec run hand-written CUDA kernels (``kernels/csrc``) on CUDA tensors and
their plain PyTorch versions (``kernels/ref.py``) on CPU tensors.

This package imports neither ``jax`` nor ``repro``.
"""
import torch

# fp32 matmuls run in full fp32 on the card.  TF32 keeps ~3 decimal digits,
# which would break parity with the JAX package; both flags are set here so
# no PyTorch build's default decides it.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
