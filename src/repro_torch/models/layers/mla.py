"""Multi-head Latent Attention (DeepSeek-V2 / MiniCPM3), the twin of
``repro.models.layers.mla``.

Q and KV come from low-rank latents; the decode cache stores only the
compressed KV latent ``c_kv`` and the shared rope key ``k_rope``, and decode
uses the absorbed form, so per-head K and V are never built over the cache:

    score_h(t) = (W_uk_h^T q_nope_h)^T c_t + q_rope_h^T k_rope_t
    out_h      = W_uv_h^T ( sum_t p_t c_t )

Weights keep the JAX layout and keys.  The prefill's attention goes through
``kernels.ops.flash_attention``, which takes K and V of one head width and
scales by that width's ``D**-0.5``: MLA's qk width is nope + rope and its V
is narrower, so V is padded with zero columns to the qk width and the
output's first ``v_head_dim`` columns are kept (exact: the zero columns add
nothing to the others, and the scale is the qk width's, as JAX's).  Decode
is JAX's absorbed form in fp32 products with no kernel; it writes the new
token's latents into the cache in place and reads nothing back to the host.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.kernels.ref import NEG_INF  # the masked score, -1e30 as JAX's decode writes

from .attention import _out_proj, _proj
from .attention import _qk_norm as _rms  # JAX's mla._rms: fp32, (1 + scale), eps 1e-6
from .embeddings import apply_rope, normal, rope_angles


def _qk_dim(m) -> int:
    return m.qk_nope_head_dim + m.qk_rope_head_dim


def init_mla(gen: torch.Generator, cfg, dtype, *, lead=(), device=None) -> dict:
    """JAX's keys, shapes and dtypes; ``lead`` = (L,) draws L layers' stacked
    leaves at once."""
    m = cfg.mla
    d, h, qk = cfg.d_model, cfg.n_heads, _qk_dim(m)
    return {
        "wq_a": normal(gen, (*lead, d, m.q_lora_rank), d, dtype, device),
        "wq_b": normal(gen, (*lead, m.q_lora_rank, h, qk), m.q_lora_rank, dtype, device),
        "wkv_a": normal(gen, (*lead, d, m.kv_lora_rank + m.qk_rope_head_dim), d, dtype, device),
        "wk_b": normal(gen, (*lead, m.kv_lora_rank, h, m.qk_nope_head_dim), m.kv_lora_rank,
                       dtype, device),
        "wv_b": normal(gen, (*lead, m.kv_lora_rank, h, m.v_head_dim), m.kv_lora_rank, dtype,
                       device),
        "wo": normal(gen, (*lead, h, m.v_head_dim, d), h * m.v_head_dim, dtype, device),
        "q_norm": torch.zeros((*lead, m.q_lora_rank), dtype=torch.float32, device=device),
        "kv_norm": torch.zeros((*lead, m.kv_lora_rank), dtype=torch.float32, device=device),
    }


def _latents(cfg, params: dict, x: torch.Tensor, positions: torch.Tensor):
    """x (B,S,d) -> (q_nope (B,S,H,nope), q_rope (B,S,H,rope) rotated, c_kv
    (B,S,kv_lora_rank) normed, k_rope (B,S,rope) rotated, shared by the
    heads)."""
    m = cfg.mla
    ql = _rms(torch.matmul(x, params["wq_a"]), params["q_norm"])
    q = _proj(ql, params["wq_b"])
    q_nope, q_rope = q[..., :m.qk_nope_head_dim], q[..., m.qk_nope_head_dim:]
    kv_a = torch.matmul(x, params["wkv_a"])
    c_kv = _rms(kv_a[..., :m.kv_lora_rank], params["kv_norm"])
    k_rope = kv_a[..., m.kv_lora_rank:]
    cos, sin = rope_angles(positions, m.qk_rope_head_dim, cfg.rope_theta)
    q_rope = apply_rope(q_rope, cos, sin)
    k_rope = apply_rope(k_rope[:, :, None, :], cos, sin)[:, :, 0]
    return q_nope, q_rope, c_kv, k_rope


def mla_forward(cfg, params: dict, x: torch.Tensor, *, window=None):
    """Full-sequence causal MLA (prefill). x: (B,S,d) -> (out (B,S,d), c_kv,
    k_rope): JAX returns ``out`` alone and projects the latents a second
    time for the cache; the port's prefill writes these."""
    m = cfg.mla
    b, s, _ = x.shape
    qk = _qk_dim(m)
    if m.v_head_dim > qk:
        raise ValueError(f"{cfg.name}: v_head_dim {m.v_head_dim} > the qk width {qk}: the "
                         "flash kernel scales by its one head width, padding Q and K would "
                         "change the scale")
    positions = torch.arange(s, device=x.device)[None, :]
    q_nope, q_rope, c_kv, k_rope = _latents(cfg, params, x, positions)
    # per-head K and V from the latent (fine for prefill: O(S) memory)
    k_nope = _proj(c_kv, params["wk_b"])
    v = _proj(c_kv, params["wv_b"])
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, k_rope[:, :, None].expand(b, s, cfg.n_heads, m.qk_rope_head_dim)],
                  dim=-1)
    v = F.pad(v, (0, qk - m.v_head_dim))
    out = ops.flash_attention(q, k, v, causal=True, window=window or cfg.sliding_window)
    return _out_proj(out[..., :m.v_head_dim], params["wo"]), c_kv, k_rope


def init_mla_cache(cfg, batch: int, cache_len: int, dtype, *, lead=(), device=None) -> dict:
    m = cfg.mla
    return {
        "c_kv": torch.zeros((*lead, batch, cache_len, m.kv_lora_rank), dtype=dtype,
                            device=device),
        "k_rope": torch.zeros((*lead, batch, cache_len, m.qk_rope_head_dim), dtype=dtype,
                              device=device),
    }


def mla_decode(cfg, params: dict, x: torch.Tensor, cache: dict, pos: int, *, ring: bool,
               valid: torch.Tensor):
    """Absorbed one-token MLA decode. x: (B,1,d); ``pos`` a host int;
    ``valid`` is ``attention.kv_valid(B, cache_len, pos, ring=ring)``.
    Writes the token's latents into ``cache`` in place.  Scores, softmax
    and the latent context in fp32, the context rounded to x's dtype
    before ``wo`` (as JAX's).  Returns (out (B,1,d), cache)."""
    m = cfg.mla
    b = x.shape[0]
    cache_len = cache["c_kv"].shape[1]
    positions = torch.full((b, 1), pos, dtype=torch.int32, device=x.device)
    q_nope, q_rope, c_new, kr_new = _latents(cfg, params, x, positions)

    slot = pos % cache_len if ring else min(pos, cache_len - 1)
    cache["c_kv"][:, slot] = c_new[:, 0]
    cache["k_rope"][:, slot] = kr_new[:, 0]

    f32 = torch.float32
    c_kv = cache["c_kv"].to(f32)
    q_abs = torch.einsum("bhk,rhk->bhr", q_nope[:, 0].to(f32), params["wk_b"].to(f32))
    scores = torch.einsum("bhr,bsr->bhs", q_abs, c_kv)
    scores = scores + torch.einsum("bhk,bsk->bhs", q_rope[:, 0].to(f32),
                                   cache["k_rope"].to(f32))
    scores = (scores * _qk_dim(m) ** -0.5).masked_fill(~valid[:, None, :], NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    ctx = torch.einsum("bhs,bsr->bhr", probs, c_kv)  # the latent context
    out = torch.einsum("bhr,rhk->bhk", ctx, params["wv_b"].to(f32)).to(x.dtype)
    return _out_proj(out, params["wo"])[:, None], cache
