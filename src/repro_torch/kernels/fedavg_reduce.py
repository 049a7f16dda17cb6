"""FedAvg weighted reduce on the card (``csrc/fedavg_reduce.cu``).

The twin of ``repro.kernels.fedavg_reduce``: (C, N) fp32 or bf16 updates and
(C,) weights -> the (N,) weighted mean in the input dtype, fp32
accumulation, any N.  CUDA tensors only; ``ops`` routes CPU tensors to
``ref``.

One ``ops`` call is one device kernel: the weight sum (``safe_weight_sum``,
in client order), the normalized weights and, with ``normalize=False``,
the product of the mean with the weight sum are formed inside the launch.
For integer weights summing below 2**24 the kernel's weight sum has the
bits of ``safe_weight_sum(w)``, so the result is bitwise the composition
it replaced: the weights normalized around the kernel, and the mean
multiplied back by ``safe_weight_sum(w)`` in the output dtype
(``ops._denormalize``).
"""
from __future__ import annotations

import torch

from ._cuda import check_tensor, launch

_ENTRY = {
    torch.float32: "repro_fedavg_reduce_f32",
    torch.bfloat16: "repro_fedavg_reduce_bf16",
}


def fedavg_reduce(updates: torch.Tensor, weights: torch.Tensor, *,
                  normalize: bool = True) -> torch.Tensor:
    """(C,N) x (C,) -> (N,) weighted mean, or with ``normalize=False`` the
    mean times ``safe_weight_sum(weights)``, each rounded to the updates'
    dtype."""
    if not isinstance(normalize, bool):
        raise TypeError(f"normalize must be a bool, got {normalize!r}")
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
    if c == 0 or n == 0:  # nothing to reduce: no launch
        return torch.zeros(n, dtype=updates.dtype, device=dev)
    out = torch.empty(n, dtype=updates.dtype, device=dev)
    wf = weights.to(torch.float32).contiguous()
    launch("fedavg_reduce", _ENTRY[updates.dtype], "fedavg_reduce", dev,
           updates.data_ptr(), wf.data_ptr(), out.data_ptr(), c, n, int(normalize))
    return out
