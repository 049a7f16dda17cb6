"""TopK scatter-accumulate weighted reduce on the card
(``csrc/topk_scatter_reduce.cu``).

The twin of ``repro.kernels.scatter_reduce``: the clients' TopK wires, idx
(C, k) int32 and val (C, k) fp32, and (C,) weights -> the (N,) fp32
weighted mean of the scattered entries, O(C*k) reads and one (N,) write,
never a dense (C, N).  Duplicates accumulate; negative and >= N indices
are dropped.  On TopKCodec's wire (distinct indices, ascending per row)
the result is the same bits on every launch.  CUDA tensors only; ``ops``
routes CPU tensors to ``ref``.

The TPU kernel keeps the whole (N,) accumulator in VMEM and so needs the
``MAX_N_PARAMS`` gate; here each CTA holds one 8192-float tile of it in
shared memory at a time, so any N < 2**31 is taken (int32 indices), and up
to 65,535 clients.

One ``ops`` call is one device kernel: the weight sum (``safe_weight_sum``,
in a fixed order) and, with ``normalize=False``, the product of the mean
with it are formed inside the launch.  For integer weights summing below
2**24 every order of their sum is exact, so the kernel's weight sum has
the bits of ``safe_weight_sum(w)`` and the result those of the same
scatter divided by it (and multiplied back) around the kernel.  For other
positive weights the two sums' orders differ, and the mean is within 2C -
1 ulps of that composition (C - 1 roundings in each sum of C weights, and
the division's own).
"""
from __future__ import annotations

import torch

from ._cuda import check_tensor, launch

TILE = 8192           # output floats per CTA: kTile in the .cu source
UNIT = 1024           # entries of a row the first phase checks at a time: kUnit
MAX_CLIENTS = 65_535


def topk_scatter_reduce(idx: torch.Tensor, val: torch.Tensor, weights: torch.Tensor,
                        n_params: int, *, normalize: bool = True) -> torch.Tensor:
    """(C,k) int32 x (C,k) fp32 x (C,) -> (N,) fp32 weighted mean, or with
    ``normalize=False`` the mean times ``safe_weight_sum(weights)``."""
    if not isinstance(normalize, bool):
        raise TypeError(f"normalize must be a bool, got {normalize!r}")
    dev = idx.device
    check_tensor(idx, "idx", device=dev, dtypes=(torch.int32,), ndim=2)
    check_tensor(val, "val", device=dev, dtypes=(torch.float32,), ndim=2)
    check_tensor(weights, "weights", device=dev,
                 dtypes=(torch.float32, torch.float64, torch.bfloat16), ndim=1)
    c, k = idx.shape
    if (dev.type != "cuda" or val.shape != (c, k) or weights.shape != (c,)
            or not 0 <= n_params < 2**31 or c > MAX_CLIENTS):
        raise ValueError(
            f"topk_scatter_reduce takes CUDA idx and val (C, k) with C <= "
            f"{MAX_CLIENTS}, weights (C,) and 0 <= N < 2**31; got "
            f"{tuple(idx.shape)}, {tuple(val.shape)}, {tuple(weights.shape)}, N={n_params}"
        )
    if c == 0 or k == 0 or n_params == 0:  # nothing to scatter: no launch
        return torch.zeros(n_params, dtype=torch.float32, device=dev)
    wf = weights.to(torch.float32).contiguous()
    workspace = torch.empty(workspace_ints(c, k, n_params), dtype=torch.int32, device=dev)
    out = torch.empty(n_params, dtype=torch.float32, device=dev)
    launch("topk_scatter_reduce", "repro_topk_scatter_reduce", "topk_scatter_reduce", dev,
           idx.data_ptr(), val.data_ptr(), wf.data_ptr(), out.data_ptr(), workspace.data_ptr(),
           c, k, n_params, workspace.numel(), int(normalize))
    return out


def workspace_ints(c: int, k: int, n_params: int) -> int:
    """The launch's int32 scratch: a flag per UNIT entries of each row, and
    each row's first entry in every TILE of the output (and its end)."""
    return c * (-(-k // UNIT) + -(-n_params // TILE) + 1)
