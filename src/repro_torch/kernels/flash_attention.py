"""Flash attention on the card (``csrc/flash_attention.cu``).

The twin of ``repro.kernels.flash_attention``: q (B,Sq,H,D), k and v
(B,Skv,KV,D) in fp32 or bf16 -> (B,Sq,H,D) in q's dtype, causal and/or a
sliding window, GQA (query head h reads KV head h // (H/KV)), ``q_offset``
the absolute position of q[:, 0].  Unlike the TPU dispatch, any Sq and Skv
run (ragged tails masked) and any D % 8 == 0 up to 256.

The dtype picks the kernel.  bf16 runs both products on Hopper's tensor
cores (wgmma, bf16 operands, fp32 sums, P rounded to bf16 before P . V),
128 query rows a work item, one persistent CTA an SM walking the items
heaviest first, K and V tiles arriving by TMA into a 2-stage ring;
fp32 runs the CUDA-core kernel, in fp32 throughout (TF32 would miss
fp32's 2e-5 tolerance).  CUDA tensors only; ``ops`` routes CPU tensors
to ``ref``.
"""
from __future__ import annotations

import torch

from ._cuda import check_tensor, launch

_ENTRY = {
    torch.float32: "repro_flash_attention_f32",
    torch.bfloat16: "repro_flash_attention_bf16",
}
NO_WINDOW = -1          # ``window=None`` as the kernel reads it
MAX_HEAD_DIM = 256
# fp32: the grid's y extent (65,535) times the 64-row query tile; bf16: TMA's
# int32 row coordinate (one persistent CTA an SM walks the 128-row tiles)
MAX_SQ = {torch.float32: 65_535 * 64, torch.bfloat16: 2**31 - 1}


def check_heads(h: int, kv: int, d: int) -> None:
    if kv < 1 or h % kv:
        raise ValueError(f"{h} query heads do not group over {kv} KV heads")
    if d % 8 or not 8 <= d <= MAX_HEAD_DIM:
        raise ValueError(f"head dim {d}: the attention kernels take D % 8 == 0 up to "
                         f"{MAX_HEAD_DIM}")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int | None = None,
                    q_offset: int = 0) -> torch.Tensor:
    dev = q.device
    if q.dtype not in _ENTRY:
        raise TypeError(f"q has dtype {q.dtype}, expected one of {tuple(_ENTRY)}")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape or k.shape[0] != q.shape[0] \
            or k.shape[3] != q.shape[3]:
        raise ValueError(f"flash_attention takes q (B,Sq,H,D) and k, v (B,Skv,KV,D); got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, sq, h, d = q.shape
    skv, kv = k.shape[1], k.shape[2]
    check_heads(h, kv, d)
    if skv < 1 or sq > MAX_SQ[q.dtype]:
        raise ValueError(f"flash_attention takes 1 <= Skv and Sq <= {MAX_SQ[q.dtype]}; got "
                         f"Skv={skv}, Sq={sq}")
    if (window is not None and window < 0) or q_offset < 0:
        raise ValueError(f"window {window} and q_offset {q_offset} must be >= 0")
    for t, name in ((q, "q"), (k, "k"), (v, "v")):
        check_tensor(t, name, device=dev, dtypes=(q.dtype,), ndim=4, align=16)
    if dev.type != "cuda":
        raise ValueError(f"flash_attention's kernel takes CUDA tensors, got {dev}")
    out = torch.empty_like(q)
    if b and sq:
        launch("flash_attention", _ENTRY[q.dtype], "flash_attention", dev,
               q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
               b, sq, skv, h, kv, d, int(causal),
               NO_WINDOW if window is None else int(window), int(q_offset),
               float(d ** -0.5))
    return out
