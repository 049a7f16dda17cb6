"""Single-token decode attention on the card (``csrc/decode_attention.cu``).

The twin of ``repro.kernels.decode_attention``: q (B,H,D) against k and v
caches (B,S,KV,D) under a (B,S) bool validity mask (linear and ring caches
alike) -> (B,H,D) in q's dtype, GQA grouped.  Unlike the TPU dispatch, any
S runs and any D % 8 == 0 up to 256 (with (H/KV) * D_pad <= 4096).  CUDA
tensors only; ``ops`` routes CPU tensors to ``ref``.

The cache is split across CTAs: a (B*KV, splits) grid, each split taking
its share of the row's cache tiles that hold a valid slot, then a second
kernel of the same entry point combines the splits' fp32 partials in
split order (one counted launch).  ``splits`` defaults to one wave of the
card: two CTAs an SM, as many as the kernel's registers let stay resident.
"""
from __future__ import annotations

import functools

import torch

from ._cuda import check_tensor, launch
from .flash_attention import check_heads

_ENTRY = {
    torch.float32: "repro_decode_attention_f32",
    torch.bfloat16: "repro_decode_attention_bf16",
}
MAX_GROUP_WIDTH = 4096  # (H/KV) * D_pad: a CTA's query heads, fp32 in shared memory
MAX_SPLITS = 65_535     # grid.y
CTAS_PER_SM = 2         # resident at once: the kernel's registers allow two


def tile_slots(d_pad: int, itemsize: int) -> int:
    """Cache slots a tile: 64, fewer where a K tile would pass 16 KB
    (``kBK`` in the .cu source)."""
    return min(64, 16384 // (d_pad * itemsize))


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def default_splits(b: int, kv: int, tiles: int, sms: int) -> int:
    """Splits of each (batch row, KV head)'s cache: as many as keep the
    grid to one wave of CTAS_PER_SM CTAs an SM, at least one, at most one a
    tile."""
    return max(1, min(tiles, CTAS_PER_SM * sms // max(b * kv, 1), MAX_SPLITS))


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor, *,
                     kv_valid: torch.Tensor, splits: int | None = None) -> torch.Tensor:
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
    if splits is not None and (isinstance(splits, bool) or not isinstance(splits, int)
                               or not 1 <= splits <= MAX_SPLITS):
        raise ValueError(f"splits must be an int in [1, {MAX_SPLITS}], got {splits!r}")
    for t, name in ((q, "q"), (k_cache, "k_cache"), (v_cache, "v_cache")):
        check_tensor(t, name, device=dev, dtypes=(q.dtype,), ndim=t.dim(), align=16)
    check_tensor(kv_valid, "kv_valid", device=dev, dtypes=(torch.bool,), ndim=2)
    if dev.type != "cuda":
        raise ValueError(f"decode_attention's kernel takes CUDA tensors, got {dev}")
    out = torch.empty_like(q)
    if b:
        if splits is None:
            tiles = -(-s // tile_slots(d_pad, q.element_size()))
            splits = default_splits(b, kv, tiles, _sm_count(dev.index))
        # per split: (m, l) and acc of each query head, fp32
        ws = torch.empty(b * h * splits * (d + 2), dtype=torch.float32, device=dev)
        launch("decode_attention", _ENTRY[q.dtype], "decode_attention", dev,
               q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), kv_valid.data_ptr(),
               out.data_ptr(), ws.data_ptr(), b, s, h, kv, d, splits, ws.numel(),
               float(d ** -0.5))
    return out
