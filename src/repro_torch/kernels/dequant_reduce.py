"""Fused dequantize + FedAvg weighted reduce on the card
(``csrc/dequant_reduce.cu``).

The twin of ``repro.kernels.dequant_reduce``: the clients' int8 wires
(C, Np) and block scales (C, Np/256) reduce to the (Np,) fp32 weighted mean
in one pass, never building the fp32 (C, Np) matrix.  CUDA tensors only;
``ops`` routes CPU tensors to ``ref``.

One ``ops`` call is one device kernel: the weight sum (``safe_weight_sum``,
in client order), the normalized weights and, with ``normalize=False``,
the product of the mean with the weight sum are formed inside the launch.
For integer weights summing below 2**24 the kernel's weight sum has the
bits of ``safe_weight_sum(w)``, so the result is bitwise the composition
it replaced: the weights normalized around the kernel, and the mean
multiplied back by ``safe_weight_sum(w)`` (``ops._denormalize``).
"""
from __future__ import annotations

import torch

from ._cuda import check_tensor, launch

BLOCK = 256


def dequant_reduce(q: torch.Tensor, scales: torch.Tensor, weights: torch.Tensor, *,
                   normalize: bool = True) -> torch.Tensor:
    """(C,Np) int8 x (C,Np/256) fp32 x (C,) -> (Np,) fp32 weighted mean, or
    with ``normalize=False`` the mean times ``safe_weight_sum(weights)``."""
    if not isinstance(normalize, bool):
        raise TypeError(f"normalize must be a bool, got {normalize!r}")
    dev = q.device
    check_tensor(q, "q", device=dev, dtypes=(torch.int8,), ndim=2, align=16)
    check_tensor(scales, "scales", device=dev, dtypes=(torch.float32,), ndim=2)
    check_tensor(weights, "weights", device=dev,
                 dtypes=(torch.float32, torch.float64, torch.bfloat16), ndim=1)
    c, n = q.shape
    if dev.type != "cuda" or n % BLOCK or scales.shape != (c, n // BLOCK) or weights.shape != (c,):
        raise ValueError(
            f"dequant_reduce takes CUDA q (C, Np) with Np % {BLOCK} == 0, scales "
            f"(C, Np/{BLOCK}) and weights (C,); got {tuple(q.shape)}, "
            f"{tuple(scales.shape)}, {tuple(weights.shape)}"
        )
    if c == 0 or n == 0:  # nothing to reduce: no launch
        return torch.zeros(n, dtype=torch.float32, device=dev)
    out = torch.empty(n, dtype=torch.float32, device=dev)
    wf = weights.to(torch.float32).contiguous()
    launch("dequant_reduce", "repro_dequant_reduce", "dequant_reduce", dev,
           q.data_ptr(), scales.data_ptr(), wf.data_ptr(), out.data_ptr(), c, n,
           int(normalize))
    return out
