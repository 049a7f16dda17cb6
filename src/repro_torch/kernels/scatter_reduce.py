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
shared memory, so any N < 2**31 is taken (int32 indices), and up to 65,535
clients (the first pass's grid rows).
"""
from __future__ import annotations

import torch

from repro_torch.utils.pytree import safe_weight_sum

from ._cuda import check_tensor, launch

TILE = 8192           # output floats per CTA: kTile in the .cu source
MAX_CLIENTS = 65_535  # grid.y of the row-index pass


def topk_scatter_reduce(idx: torch.Tensor, val: torch.Tensor, weights: torch.Tensor,
                        n_params: int) -> torch.Tensor:
    """(C,k) int32 x (C,k) fp32 x (C,) -> (N,) fp32 weighted mean."""
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
    wsum = safe_weight_sum(wf)
    tiles = -(-n_params // TILE)
    workspace = torch.empty(c * (tiles + 2), dtype=torch.int32, device=dev)
    out = torch.empty(n_params, dtype=torch.float32, device=dev)
    launch("topk_scatter_reduce", "repro_topk_scatter_reduce", "topk_scatter_reduce", dev,
           idx.data_ptr(), val.data_ptr(), wf.data_ptr(), wsum.data_ptr(), out.data_ptr(),
           workspace.data_ptr(), c, k, n_params, workspace.numel())
    return out
