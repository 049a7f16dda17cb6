"""int8 block quantization codec on the card (``csrc/quantize.cu``).

The twin of ``repro.kernels.quantize``: symmetric per-256-block scaling,
scale = absmax/127 (0 -> 1), q = clip(round_half_even(x/scale), +-127).
These wrappers take CUDA tensors only; ``ops`` routes CPU tensors to
``ref``.  ``quantize_int8`` takes any N at any 4-byte start and quantizes
x padded with zeros to Np = a multiple of 256 inside its one launch (the
codec's pad);
``dequantize_int8`` takes Np % 256 == 0 (the JAX dispatch's extra
``N % 1024`` gate, ``repro/kernels/ops.py:185``, is a TPU tiling quirk).
"""
from __future__ import annotations

import torch

from ._cuda import check_tensor, launch

BLOCK = 256


def quantize_int8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """x: (N,) fp32 CUDA, any N, any 4-byte start (a segment's slice of
    a flat update) -> (q int8 (Np,), scales fp32 (Np/256,)), Np = N
    rounded up to a multiple of 256: the codes and scales of x padded with
    zeros (the pad's codes are 0)."""
    check_tensor(x, "x", device=x.device, dtypes=(torch.float32,), ndim=1, align=4)
    if x.device.type != "cuda":
        raise ValueError(f"quantize_int8 takes a CUDA tensor, got one on {x.device}")
    n = x.shape[0]
    n_blocks = -(-n // BLOCK)
    q = torch.empty(n_blocks * BLOCK, dtype=torch.int8, device=x.device)
    scales = torch.empty(n_blocks, dtype=torch.float32, device=x.device)
    launch("quantize", "repro_quantize_int8", "quantize_int8", x.device,
           x.data_ptr(), q.data_ptr(), scales.data_ptr(), n, n_blocks)
    return q, scales


def dequantize_int8(q: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """q: (N,) int8 CUDA, scales: (N/256,) fp32 -> (N,) fp32."""
    dev = q.device
    check_tensor(q, "q", device=dev, dtypes=(torch.int8,), ndim=1, align=16)
    check_tensor(scales, "scales", device=dev, dtypes=(torch.float32,), ndim=1)
    n = q.shape[0]
    if dev.type != "cuda" or n % BLOCK or scales.shape[0] != n // BLOCK:
        raise ValueError(
            f"dequantize_int8 takes CUDA (N,) codes with N % {BLOCK} == 0 and "
            f"N/{BLOCK} scales, got {n} and {scales.shape[0]}"
        )
    x = torch.empty(n, dtype=torch.float32, device=dev)
    launch("quantize", "repro_dequantize_int8", "dequantize_int8", dev,
           q.data_ptr(), scales.data_ptr(), x.data_ptr(), n // BLOCK)
    return x
