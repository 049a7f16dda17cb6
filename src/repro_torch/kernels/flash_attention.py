"""Flash attention on the card (``csrc/flash_attention.cu``): the forward
and, for training, its backward.

The twin of ``repro.kernels.flash_attention``: q (B,Sq,H,D), k and v
(B,Skv,KV,D) in fp32 or bf16 -> (B,Sq,H,D) in q's dtype, causal and/or a
sliding window, GQA (query head h reads KV head h // (H/KV)), ``q_offset``
the absolute position of q[:, 0].  Unlike the TPU dispatch, any Sq and Skv
run (ragged tails masked) and any D % 8 == 0 up to 256.

The dtype picks the forward's kernel.  bf16 runs both products on
Hopper's tensor cores (wgmma, bf16 operands, fp32 sums, P rounded to bf16
before P . V), 128 query rows a work item, one persistent CTA an SM
walking the items heaviest first, K and V tiles arriving by TMA into a
2-stage ring; fp32 runs the CUDA-core kernel, in fp32 throughout (TF32
would miss fp32's 2e-5 tolerance).  ``flash_attention_fwd`` also writes
each row's log-sum-exp (B, H, Sq) fp32; ``flash_attention`` (serving)
passes a null pointer and writes none.

The backward (``flash_attention_bwd``, one counted launch: a dQ kernel
that also writes delta = rowsum(dO * O), then a dK / dV kernel) recomputes
S and P from lse; each CTA owns its rows of dQ, or of dK and dV over a KV
head's G query heads, so there are no atomics and two calls give the same
bits.  The dtype picks its kernels too.  bf16 runs every product on the
tensor cores (wgmma, bf16 operands, fp32 sums, P^T, dS^T and dS rounded to
bf16 before their products), one persistent CTA an SM walking its items
heaviest first, tiles arriving by TMA: dQ a 128-row query tile an item
with K and V streaming, dK / dV a 128-key tile an item with Q and dO of
the group's heads streaming, transposed (S^T = K . Q^T).  fp32 runs the
CUDA-core kernels in fp32 throughout.  The JAX package has no backward
kernel: JAX differentiates its attention oracle.  CUDA tensors only;
``ops`` routes CPU tensors to ``ref``.
"""
from __future__ import annotations

import torch

from ._cuda import check_tensor, launch

_ENTRY = {
    torch.float32: "repro_flash_attention_f32",
    torch.bfloat16: "repro_flash_attention_bf16",
}
_BWD_ENTRY = {
    torch.float32: "repro_flash_attention_bwd_f32",
    torch.bfloat16: "repro_flash_attention_bwd_bf16",
}
NO_WINDOW = -1          # ``window=None`` as the kernel reads it
MAX_HEAD_DIM = 256
# fp32: the grid's y extent (65,535) times the 64-row query tile; bf16: TMA's
# int32 row coordinate (one persistent CTA an SM walks the tiles), forward
# and backward; fp32's backward grids hold 64 query rows a tile on y
MAX_SQ = {torch.float32: 65_535 * 64, torch.bfloat16: 2**31 - 1}
MAX_SQ_BWD = {torch.float32: 65_535 * 64, torch.bfloat16: 2**31 - 1}


def check_heads(h: int, kv: int, d: int) -> None:
    if kv < 1 or h % kv:
        raise ValueError(f"{h} query heads do not group over {kv} KV heads")
    if d % 8 or not 8 <= d <= MAX_HEAD_DIM:
        raise ValueError(f"head dim {d}: the attention kernels take D % 8 == 0 up to "
                         f"{MAX_HEAD_DIM}")


def _check(q, k, v, window, q_offset, *, backward: bool) -> tuple[int, ...]:
    """Raise on what the kernels do not take; -> (b, sq, skv, h, kv, d)."""
    if q.dtype not in _ENTRY:
        raise TypeError(f"q has dtype {q.dtype}, expected one of {tuple(_ENTRY)}")
    max_sq = (MAX_SQ_BWD if backward else MAX_SQ)[q.dtype]
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape or k.shape[0] != q.shape[0] \
            or k.shape[3] != q.shape[3]:
        raise ValueError(f"flash_attention takes q (B,Sq,H,D) and k, v (B,Skv,KV,D); got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, sq, h, d = q.shape
    skv, kv = k.shape[1], k.shape[2]
    check_heads(h, kv, d)
    if skv < 1 or sq > max_sq:
        raise ValueError(f"flash_attention takes 1 <= Skv and Sq <= {max_sq}; got "
                         f"Skv={skv}, Sq={sq}")
    if (window is not None and window < 0) or q_offset < 0:
        raise ValueError(f"window {window} and q_offset {q_offset} must be >= 0")
    for t, name in ((q, "q"), (k, "k"), (v, "v")):
        check_tensor(t, name, device=q.device, dtypes=(q.dtype,), ndim=4, align=16)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention's kernel takes CUDA tensors, got {q.device}")
    return b, sq, skv, h, kv, d


def _mask_args(causal: bool, window: int | None, q_offset: int, d: int) -> tuple:
    return (int(causal), NO_WINDOW if window is None else int(window), int(q_offset),
            float(d ** -0.5))


def _forward(q, k, v, causal, window, q_offset, with_lse: bool):
    b, sq, skv, h, kv, d = _check(q, k, v, window, q_offset, backward=False)
    out = torch.empty_like(q)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device) if with_lse else None
    if b and sq:
        launch("flash_attention", _ENTRY[q.dtype], "flash_attention", q.device,
               q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
               None if lse is None else lse.data_ptr(), b, sq, skv, h, kv, d,
               *_mask_args(causal, window, q_offset, d))
    return out, lse


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int | None = None,
                    q_offset: int = 0) -> torch.Tensor:
    """The serving forward: the output alone (no lse is written)."""
    return _forward(q, k, v, causal, window, q_offset, with_lse=False)[0]


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, window: int | None = None,
                        q_offset: int = 0) -> tuple[torch.Tensor, torch.Tensor]:
    """The training forward: (out (B,Sq,H,D), lse (B,H,Sq) fp32), lse the
    log-sum-exp of each row's scaled, masked scores (-1e30 for a row with
    no valid key, as the plain version's)."""
    return _forward(q, k, v, causal, window, q_offset, with_lse=True)


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, out: torch.Tensor,
                        lse: torch.Tensor, dout: torch.Tensor, *, causal: bool = True,
                        window: int | None = None, q_offset: int = 0):
    """(q, k, v, the forward's out and lse, the output's gradient dout) ->
    (dq, dk, dv) in q's dtype, one counted launch (two kernels)."""
    b, sq, skv, h, kv, d = _check(q, k, v, window, q_offset, backward=True)
    for t, name in ((out, "out"), (dout, "dout")):
        check_tensor(t, name, device=q.device, dtypes=(q.dtype,), ndim=4, align=16)
        if t.shape != q.shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(q.shape)}")
    check_tensor(lse, "lse", device=q.device, dtypes=(torch.float32,), ndim=3)
    if lse.shape != (b, h, sq):
        raise ValueError(f"lse has shape {tuple(lse.shape)}, expected {(b, h, sq)}")
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    if b and sq:
        delta = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
        launch("flash_attention", _BWD_ENTRY[q.dtype], "flash_attention_bwd", q.device,
               q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(),
               dout.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), delta.data_ptr(),
               b, sq, skv, h, kv, d, *_mask_args(causal, window, q_offset, d))
    else:  # no query row: nothing reaches K or V
        dk.zero_()
        dv.zero_()
    return dq, dk, dv
