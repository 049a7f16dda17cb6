"""FedAvg weighted reduce on the card (``csrc/fedavg_reduce.cu``).

The twin of ``repro.kernels.fedavg_reduce``: (C, N) fp32 or bf16 updates and
(C,) weights -> the (N,) weighted mean in the input dtype, fp32
accumulation, any N.  CUDA tensors only; ``ops`` routes CPU tensors to
``ref``.
"""
from __future__ import annotations

import torch

from repro_torch.utils.pytree import safe_weight_sum

from ._cuda import check_tensor, launch

_ENTRY = {
    torch.float32: "repro_fedavg_reduce_f32",
    torch.bfloat16: "repro_fedavg_reduce_bf16",
}


def fedavg_reduce(updates: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """(C,N) x (C,) -> (N,) weighted mean (weights normalized here)."""
    dev = updates.device
    check_tensor(updates, "updates", device=dev, dtypes=tuple(_ENTRY), ndim=2)
    check_tensor(weights, "weights", device=dev,
                 dtypes=(torch.float32, torch.float64, torch.bfloat16), ndim=1)
    c, n = updates.shape
    if dev.type != "cuda" or weights.shape != (c,):
        raise ValueError(
            f"fedavg_reduce takes CUDA updates (C, N) and weights (C,); got "
            f"{tuple(updates.shape)} on {dev} and {tuple(weights.shape)}"
        )
    wf = weights.to(torch.float32)
    wn = (wf / safe_weight_sum(wf)).contiguous()
    out = torch.empty(n, dtype=updates.dtype, device=dev)
    launch("fedavg_reduce", _ENTRY[updates.dtype], "fedavg_reduce", dev,
           updates.data_ptr(), wn.data_ptr(), out.data_ptr(), c, n)
    return out
