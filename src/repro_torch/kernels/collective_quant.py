"""int8 pack/unpack of the compressed mesh collective on the card
(``csrc/collective_quant.cu``).

The twin of ``repro.kernels.collective_quant``: ``collective_pack`` is
clip(round_half_even(x / scale), +-127) per 256-block against a scale
that is an INPUT (agreed across the reducing ranks), in an int32
container, the all-reduce's accumulator type; ``collective_unpack`` is
code * scale per block, for one rank's codes or their sum over ranks.
These wrappers take CUDA tensors only; ``ops`` routes CPU tensors to
``ref``.  Any N % 256 == 0 is taken (the JAX dispatch's extra
``N % 1024`` gate, ``repro/kernels/ops.py:207,218``, is a TPU tiling
quirk).
"""
from __future__ import annotations

import torch

from ._cuda import check_tensor, launch

BLOCK = 256


def _check(vals: torch.Tensor, name: str, dtype, scales: torch.Tensor) -> int:
    dev = vals.device
    check_tensor(vals, name, device=dev, dtypes=(dtype,), ndim=1, align=16)
    check_tensor(scales, "scales", device=dev, dtypes=(torch.float32,), ndim=1)
    n = vals.shape[0]
    if dev.type != "cuda" or n % BLOCK or scales.shape[0] != n // BLOCK:
        raise ValueError(
            f"the collective kernels take a CUDA (N,) {name} with N % {BLOCK} == 0 "
            f"and N/{BLOCK} scales, got {n} and {scales.shape[0]}"
        )
    return n


def collective_pack(x: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """x: (N,) fp32 CUDA, scales: (N/256,) fp32 -> codes int32 (N,), every
    value in [-127, 127]."""
    n = _check(x, "x", torch.float32, scales)
    q = torch.empty(n, dtype=torch.int32, device=x.device)
    launch("collective_quant", "repro_collective_pack", "collective_pack", x.device,
           x.data_ptr(), scales.data_ptr(), q.data_ptr(), n // BLOCK)
    return q


def collective_unpack(q: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """q: (N,) int32 CUDA (one rank's codes or their sum), scales:
    (N/256,) fp32 -> (N,) fp32."""
    n = _check(q, "q", torch.int32, scales)
    x = torch.empty(n, dtype=torch.float32, device=q.device)
    launch("collective_quant", "repro_collective_unpack", "collective_unpack", q.device,
           q.data_ptr(), scales.data_ptr(), x.data_ptr(), n // BLOCK)
    return x
