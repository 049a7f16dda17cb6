"""GQA/MHA attention block: projections + RoPE + flash attention + caches,
the twin of ``repro.models.layers.attention``.

Weights keep the JAX layout: ``wq`` (d, h, hd), ``wk``/``wv`` (d, kv, hd),
``wo`` (h, hd, d); a projection is one matrix product over a view of the
weight flattened to two dims.  The attention itself goes through
``kernels.ops`` (the hand-written kernels on the card).  A decode step
writes the new token's K and V into the cache in place: the cache of the
whole stack is 1.88 GB at qwen3-0.6b's serving shape, and JAX's
functional update would copy it every token.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ops

from .embeddings import apply_rope, normal, rope_angles


def init_attention(gen: torch.Generator, cfg, dtype, *, lead=(), device=None) -> dict:
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    params = {
        "wq": normal(gen, (*lead, d, h, hd), d, dtype, device),
        "wk": normal(gen, (*lead, d, kv, hd), d, dtype, device),
        "wv": normal(gen, (*lead, d, kv, hd), d, dtype, device),
        "wo": normal(gen, (*lead, h, hd, d), h * hd, dtype, device),
    }
    if cfg.qk_norm:
        params["q_scale"] = torch.zeros((*lead, hd), dtype=torch.float32, device=device)
        params["k_scale"] = torch.zeros((*lead, hd), dtype=torch.float32, device=device)
    return params


def _qk_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.to(torch.float32)
    y = xf * torch.rsqrt(torch.mean(torch.square(xf), dim=-1, keepdim=True) + eps)
    return (y * (1.0 + scale)).to(x.dtype)


def _proj(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """einsum('bsd,dhk->bshk'): x (B,S,d) times w (d, h, k) -> (B,S,h,k)."""
    return torch.matmul(x, w.reshape(w.shape[0], -1)).reshape(*x.shape[:-1], *w.shape[1:])


def _project_qkv(cfg, params: dict, x: torch.Tensor, positions: torch.Tensor):
    q = _proj(x, params["wq"])
    k = _proj(x, params["wk"])
    v = _proj(x, params["wv"])
    if cfg.qk_norm:
        q = _qk_norm(q, params["q_scale"])
        k = _qk_norm(k, params["k_scale"])
    cos, sin = rope_angles(positions, cfg.resolved_head_dim, cfg.rope_theta)
    return apply_rope(q, cos, sin), apply_rope(k, cos, sin), v


def _out_proj(out: torch.Tensor, wo: torch.Tensor) -> torch.Tensor:
    """einsum('...hk,hkd->...d')."""
    return torch.matmul(out.reshape(*out.shape[:-2], -1), wo.reshape(-1, wo.shape[-1]))


def attention_forward(cfg, params: dict, x: torch.Tensor, *, window=None):
    """Full-sequence causal attention (prefill). x: (B,S,D) -> (out, K, V),
    K and V rotated (B,S,KV,hd): JAX returns ``out`` alone, and its prefill
    projects K and V a second time for the cache; the port's writes these."""
    s = x.shape[1]
    positions = torch.arange(s, device=x.device)[None, :]
    q, k, v = _project_qkv(cfg, params, x, positions)
    win = window if window is not None else cfg.sliding_window
    out = _out_proj(ops.flash_attention(q, k, v, causal=True, window=win), params["wo"])
    return out, k, v


# ---------------- caches ----------------
def init_kv_cache(cfg, batch: int, cache_len: int, dtype, *, lead=(), device=None) -> dict:
    kv, hd = cfg.n_kv_heads, cfg.resolved_head_dim
    shape = (*lead, batch, cache_len, kv, hd)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def kv_valid(batch: int, cache_len: int, pos: int, *, ring: bool, device) -> torch.Tensor:
    """(B, cache_len) bool: the slots that hold a position <= ``pos`` (and,
    for a ring, one inside the last ``cache_len``) once the token at
    ``pos`` is written."""
    idx = torch.arange(cache_len, device=device)
    if ring:
        # slot i holds the most recent position written there
        slot = pos % cache_len
        age = (slot - idx) % cache_len          # 0 = newest
        valid = pos - age >= max(0, pos + 1 - cache_len)
    else:
        valid = idx <= pos
    return valid[None].expand(batch, cache_len).contiguous()


def attention_decode(cfg, params: dict, x: torch.Tensor, cache: dict, pos: int, *,
                     ring: bool, valid: torch.Tensor):
    """One-token decode. x: (B,1,D); ``pos`` the token's absolute position,
    a host int (no device sync).  ring=True -> sliding-window ring buffer of
    size cache_len; else a linear cache of the full context.  ``valid`` is
    ``kv_valid(B, cache_len, pos, ring=ring)``, the same for every layer,
    so the caller makes it once a step.  Writes K and V into ``cache`` in
    place.  Returns (out (B,1,D), cache)."""
    b = x.shape[0]
    cache_len = cache["k"].shape[1]
    positions = torch.full((b, 1), pos, dtype=torch.int32, device=x.device)
    q, k_new, v_new = _project_qkv(cfg, params, x, positions)

    slot = pos % cache_len if ring else min(pos, cache_len - 1)
    cache["k"][:, slot] = k_new[:, 0]
    cache["v"][:, slot] = v_new[:, 0]
    out = ops.decode_attention(q[:, 0], cache["k"], cache["v"], kv_valid=valid)
    return _out_proj(out, params["wo"])[:, None], cache
