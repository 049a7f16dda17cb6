"""Single-token decode attention on the card (``csrc/decode_attention.cu``).

The twin of ``repro.kernels.decode_attention``: q (B,H,D) against k and v
caches (B,S,KV,D) under a (B,S) bool validity mask (linear and ring caches
alike) -> (B,H,D) in q's dtype, GQA grouped.  Unlike the TPU dispatch, any
S runs and any D % 8 == 0 up to 256 (with (H/KV) * D_pad <= 4096).  CUDA
tensors only; ``ops`` routes CPU tensors to ``ref``.
"""
from __future__ import annotations

import torch

from ._cuda import check_tensor, launch
from .flash_attention import check_heads

_ENTRY = {
    torch.float32: "repro_decode_attention_f32",
    torch.bfloat16: "repro_decode_attention_bf16",
}
MAX_GROUP_WIDTH = 4096  # (H/KV) * D_pad: the kernel's accumulator, 16 floats a thread


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor, *,
                     kv_valid: torch.Tensor) -> torch.Tensor:
    dev = q.device
    if q.dtype not in _ENTRY:
        raise TypeError(f"q has dtype {q.dtype}, expected one of {tuple(_ENTRY)}")
    if q.dim() != 3 or k_cache.dim() != 4 or k_cache.shape != v_cache.shape \
            or k_cache.shape[0] != q.shape[0] or k_cache.shape[3] != q.shape[2] \
            or tuple(kv_valid.shape) != tuple(k_cache.shape[:2]):
        raise ValueError(f"decode_attention takes q (B,H,D), caches (B,S,KV,D) and "
                         f"kv_valid (B,S); got {tuple(q.shape)}, {tuple(k_cache.shape)}, "
                         f"{tuple(v_cache.shape)}, {tuple(kv_valid.shape)}")
    b, h, d = q.shape
    s, kv = k_cache.shape[1], k_cache.shape[2]
    check_heads(h, kv, d)
    d_pad = 64 if d <= 64 else 128 if d <= 128 else 256
    if s < 1 or (h // kv) * d_pad > MAX_GROUP_WIDTH:
        raise ValueError(f"decode_attention takes S >= 1 and (H/KV) * D_pad <= "
                         f"{MAX_GROUP_WIDTH}; got S={s}, H/KV={h // kv}, D_pad={d_pad}")
    for t, name in ((q, "q"), (k_cache, "k_cache"), (v_cache, "v_cache")):
        check_tensor(t, name, device=dev, dtypes=(q.dtype,), ndim=t.dim(), align=16)
    check_tensor(kv_valid, "kv_valid", device=dev, dtypes=(torch.bool,), ndim=2)
    if dev.type != "cuda":
        raise ValueError(f"decode_attention's kernel takes CUDA tensors, got {dev}")
    out = torch.empty_like(q)
    if b:
        launch("decode_attention", _ENTRY[q.dtype], "decode_attention", dev,
               q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), kv_valid.data_ptr(),
               out.data_ptr(), b, s, h, kv, d, float(d ** -0.5))
    return out
