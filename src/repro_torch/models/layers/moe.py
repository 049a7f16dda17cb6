"""Mixture-of-Experts feed-forward: top-k token-choice routing and sort-based
dispatch into a per-sequence capacity buffer, the twin of
``repro.models.layers.moe``.

Each sequence's (token, choice) pairs are sorted by expert id and written
into ``capacity`` slots an expert; pairs past an expert's capacity are
dropped (they contribute zero).  The expert FFNs are three batched matrix
products over the expert axis, computed over every slot of every expert
as JAX's buffer is, and the combine adds each token's k products to zero
one at a time in the output dtype, in the sorted pairs' order: the
sequential fold that XLA's scatter-add ``.at[].add`` makes.  JAX vmaps
the dispatch over sequences; here the batch is one more tensor axis.
Nothing in the layer reads a value back to the host: ``capacity`` comes
from shapes, and the per-expert counts are a ``scatter_add`` (on the
card ``torch.bincount`` reads its maximum back).

The layer trains under ``torch.func.vmap(grad)``, as the round engine
runs a cohort: every scatter is out of place on a fresh tensor, so vmap
batches it.  A gradient repeats bit for bit on the card: in the backward
no two values meet in an atomic add, except in the discarded drop row.
The dispatch copies each token's k rows out of ``x`` expanded along k, in
token-major order, so the gradient of ``x`` is a gather of the buffer's
gradient and a sum over k (the expand's backward), never a scatter-add of
k rows into one token.

The buffer is laid out expert-major, (E, B, capacity, d), so each expert's
rows of all sequences are one matrix for the batched products; JAX's
(B, E, capacity, d) buffer is its ``transpose(0, 1)``.  ``dst`` keeps
JAX's per-sequence meaning (``expert * capacity + pos``, the drop row
``E * capacity``).

The JAX module's sharding hooks (``spec_moe``, ``_pin_*``) belong to the
mesh and are not here: the port serves an MoE stack on one card.
"""
from __future__ import annotations

import math

import torch

from .embeddings import normal
from .mlp import gelu, init_mlp, mlp_forward, silu


def expert_ff_dim(cfg) -> int:
    return cfg.moe.d_expert or cfg.d_ff


def _expert_weights(gen: torch.Generator, shape, fan_in: int, dtype, device) -> torch.Tensor:
    """``normal`` for a (..., E, a, b) leaf, drawn one (a, b) matrix at a
    time into the output: the fp32 draw of a whole stacked leaf would be
    twice its bf16 size again (30 GB for Mixtral's (16, 8, 4096, 14336))."""
    out = torch.empty(shape, dtype=dtype, device=device)
    for mat in out.view(-1, *shape[-2:]):
        mat.copy_(normal(gen, shape[-2:], fan_in, dtype, device))
    return out


def init_moe(gen: torch.Generator, cfg, dtype, *, lead=(), device=None) -> dict:
    """JAX's leaves, shapes and dtypes: an fp32 ``router`` (d, E), the
    experts' ``w_gate`` / ``w_up`` (E, d, dff) and ``w_down`` (E, dff, d),
    and ``shared`` (a gated MLP of width dff * n_shared) where the config
    has shared experts; ``lead`` = (L,) draws the stacked leaves."""
    mc = cfg.moe
    d, dff, e = cfg.d_model, expert_ff_dim(cfg), mc.n_experts
    params = {
        "router": normal(gen, (*lead, d, e), d, torch.float32, device),
        "w_gate": _expert_weights(gen, (*lead, e, d, dff), d, dtype, device),
        "w_up": _expert_weights(gen, (*lead, e, d, dff), d, dtype, device),
        "w_down": _expert_weights(gen, (*lead, e, dff, d), dff, dtype, device),
    }
    if mc.n_shared_experts:
        params["shared"] = init_mlp(gen, d, dff * mc.n_shared_experts, dtype, lead=lead,
                                    device=device)
    return params


def top_k(probs: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``jax.lax.top_k`` over the last axis: the k largest, equal values in
    ascending index order (a stable sort; ``torch.topk`` is not stable)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def router_topk(cfg, params: dict, x_flat: torch.Tensor):
    """x_flat: (T, d) -> (probs (T, k) renormalized over the chosen experts,
    expert ids (T, k), {"moe_aux", "moe_z"}).  The logits are fp32."""
    mc = cfg.moe
    e = mc.n_experts
    logits = torch.matmul(x_flat.to(torch.float32), params["router"])
    probs_full = torch.softmax(logits, dim=-1)
    topv, topi = top_k(probs_full, mc.top_k)
    topv = topv / torch.sum(topv, dim=-1, keepdim=True)

    # load-balance aux (Switch): E * sum_e f_e * p_e
    flat = topi.reshape(-1)
    assign = torch.zeros(e, dtype=torch.float32, device=x_flat.device).scatter_add(
        0, flat, torch.ones(flat.shape, dtype=torch.float32, device=x_flat.device))
    f_e = assign / max(1.0, float(topi.numel()))
    p_e = torch.mean(probs_full, dim=0)
    aux = e * torch.sum(f_e * p_e)
    z = torch.mean(torch.square(torch.logsumexp(logits, dim=-1)))
    return topv, topi, {"moe_aux": aux, "moe_z": z}


def capacity_of(s: int, k: int, e: int, capacity_factor: float) -> int:
    return max(1, int(math.ceil(s * k * capacity_factor / e)))


def _buffer_rows(dst: torch.Tensor, capacity: int, e: int) -> torch.Tensor:
    """JAX's per-sequence ``dst`` (B, n) -> rows of the expert-major buffer
    flattened to (E * B * capacity + 1, d); the drop row ``E * capacity``
    -> its last row."""
    b = dst.shape[0]
    seq = torch.arange(b, device=dst.device)[:, None]
    rows = (torch.div(dst, capacity, rounding_mode="floor") * b + seq) * capacity + dst % capacity
    return torch.where(dst < e * capacity, rows, e * b * capacity)


def dispatch(x: torch.Tensor, topi: torch.Tensor, topv: torch.Tensor, *, e: int, k: int,
             capacity: int):
    """Every sequence's pairs sorted by expert id (stably) into ``capacity``
    slots an expert.  x: (B, S, d); topi / topv: (B, S, k).  Returns the
    expert-major buffer (E, B, capacity, d) and, each (B, S*k) in sorted
    order, JAX's ``dst``, ``scale``, ``src_tok`` and ``keep``."""
    b, s, d = x.shape
    n = s * k
    flat_e = topi.reshape(b, n)
    order = torch.argsort(flat_e, dim=-1, stable=True)
    sorted_e = torch.gather(flat_e, 1, order)
    counts = torch.zeros((b, e), dtype=torch.int64, device=x.device).scatter_add(
        1, sorted_e, torch.ones_like(sorted_e))
    seg_start = torch.cumsum(counts, dim=1) - counts
    pos = torch.arange(n, device=x.device) - torch.gather(seg_start, 1, sorted_e)
    keep = pos < capacity
    dst = torch.where(keep, sorted_e * capacity + pos, e * capacity)
    src_tok = torch.div(order, k, rounding_mode="floor")
    scale = torch.gather(topv.reshape(b, n), 1, order)
    # each pair's buffer row in token-major order (pair t * k + j), the
    # order of x expanded along k
    rows = _buffer_rows(dst, capacity, e)
    rows = torch.empty_like(rows).scatter(1, order, rows)
    buf = torch.zeros((e * b * capacity + 1, d), dtype=x.dtype, device=x.device).index_copy(
        0, rows.reshape(-1), x[:, :, None, :].expand(b, s, k, d).reshape(b * n, d))
    return buf[:-1].view(e, b, capacity, d), dst, scale, src_tok, keep


def expert_ffn(params: dict, buf: torch.Tensor, act: str) -> torch.Tensor:
    """(E, B, capacity, d) -> (E, B, capacity, d): each expert's gated FFN
    on its slots of every sequence, three batched products over E."""
    e, b, c, d = buf.shape
    xb = buf.reshape(e, b * c, d)
    a = torch.matmul(xb, params["w_gate"])
    h = (silu(a) if act == "silu" else gelu(a)) * torch.matmul(xb, params["w_up"])
    return torch.matmul(h, params["w_down"]).view(e, b, c, d)


def combine(out_buf: torch.Tensor, dst: torch.Tensor, scale: torch.Tensor,
            src_tok: torch.Tensor, *, s: int) -> torch.Tensor:
    """Each token's expert outputs, times their scale cast to the output
    dtype, added to zero one at a time in that dtype, in the order of the
    sorted pairs (ascending expert id): XLA's scatter-add.  out_buf: (E, B,
    capacity, d); dst / scale / src_tok: (B, S*k) in sorted order -> (B, S, d)."""
    e, b, capacity, d = out_buf.shape
    k = dst.shape[1] // s
    flat = torch.cat([out_buf.reshape(-1, d), out_buf.new_zeros((1, d))])
    # each token's pairs, by their place in the sorted order: the fold order
    fold = torch.argsort(src_tok, dim=-1, stable=True)
    rows = torch.gather(_buffer_rows(dst, capacity, e), 1, fold)
    g = flat[rows.reshape(-1)].view(b, s, k, d)
    g = g * torch.gather(scale, 1, fold).to(flat.dtype).view(b, s, k, 1)
    out = torch.zeros((b, s, d), dtype=flat.dtype, device=flat.device)
    for j in range(k):
        out = out + g[:, :, j]
    return out


def moe_forward(cfg, params: dict, x: torch.Tensor, *, capacity_factor: float = 1.25):
    """x: (B, S, d) -> (out, aux): aux holds ``moe_aux``, ``moe_z`` and
    ``moe_drop_frac`` (the share of pairs past their expert's capacity)."""
    mc = cfg.moe
    b, s, d = x.shape
    k, e = mc.top_k, mc.n_experts
    topv, topi, aux = router_topk(cfg, params, x.reshape(b * s, d))
    capacity = capacity_of(s, k, e, capacity_factor)
    buf, dst, scale, src_tok, keep = dispatch(x, topi.view(b, s, k), topv.view(b, s, k), e=e,
                                              k=k, capacity=capacity)
    out = combine(expert_ffn(params, buf, cfg.act), dst, scale, src_tok, s=s)
    if mc.n_shared_experts:
        out = out + mlp_forward(params["shared"], x, cfg.act)
    aux["moe_drop_frac"] = 1.0 - torch.mean(keep.to(torch.float32))
    return out, aux


def moe_loss(aux: dict, cfg) -> torch.Tensor:
    mc = cfg.moe
    return mc.router_aux_coef * aux["moe_aux"] + mc.router_z_coef * aux["moe_z"]
