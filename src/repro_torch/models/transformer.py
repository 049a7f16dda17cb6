"""Decoder-only stack, the twin of ``repro.models.transformer`` for every
transformer family (dense, MoE, ssm, hybrid, vlm, audio): pre-norm mixer
(attention, MLA where ``cfg.mla`` is set, mamba, mLSTM or sLSTM, by the
layer plan) + pre-norm feed-forward (the gated MLP, or the MoE layer where
the plan marks it; none where ``d_ff`` is 0, as in xLSTM) blocks.  A config
with ``frontend_tokens`` takes ``batch["frontend"]`` (B, F, frontend_dim),
cast to the model dtype, projected by ``frontend_proj`` and prepended to
the token embeddings; after prefill the cache's ``pos`` counts those F
positions, and decode takes tokens only.

Params and caches keep the JAX trees exactly, so one ``params_from_numpy``
carries either across: ``blocks`` (and a cache's ``layers``) is a tuple of
per-position dicts whose leaves are stacked ``(L / period, ...)`` when
``scan_layers``, and a tuple of per-layer dicts otherwise.  A cache holds
K and V at an attention position (the latent ``c_kv`` and ``k_rope`` under
MLA), the (conv, ssm) state at a mamba one, (C, n, m) at an mLSTM one and
(c, n, h, m) at an sLSTM one.  Where JAX scans over the stacked leaves,
the port loops over layers and indexes views of them: nothing is unstacked
or copied.  A cache's ``pos`` is a host-side int32 scalar, so a decode step
reads it once and no layer waits on the card.

The MoE layers' aux terms (``AUX_KEYS``) are summed over the stack as
JAX's ``_run_stack`` sums them: ``forward`` returns them beside the
logits; prefill and decode drop them, as JAX's do.  The capacity factor
is JAX's: 1.25 in ``block_forward`` and prefill, 2.0 in ``block_decode``.

Training (``loss_fn``: CE over the final residual stream, ``cross_entropy``,
plus ``moe_loss`` of the summed aux terms where ``cfg.moe`` is set) runs
the dense, MoE, MLA, frontend-token and hybrid Mamba families: attention
(MLA's with V zero-padded to the qk width) through ``ops.flash_attention``
and the mamba layers' scan through ``ops.selective_scan``, whose backwards
are hand-written kernels on the card; the F frontend positions take the
label -1 and predict nothing.  ``loss_fn`` refuses, with
``NotImplementedError`` naming ROADMAP.md queue 1 item 15, the family whose
training is not ported yet (``_training_gaps``): xLSTM layers.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.configs.base import ArchConfig, LayerSpec
from repro_torch.utils.pytree import tree_leaves, tree_map, tree_unflatten

from .layers import attention as attn_lib
from .layers import mamba as mamba_lib
from .layers import mla as mla_lib
from .layers import moe as moe_lib
from .layers import xlstm as xlstm_lib
from .layers.embeddings import embed, init_embedding, normal
from .layers.mlp import init_mlp, mlp_forward
from .layers.norms import apply_norm, init_norm

PyTree = Any
_ITEM = "ROADMAP.md queue 1 item 15"
AUX_KEYS = ("moe_aux", "moe_z", "moe_drop_frac")
# the recurrent mixers: forward -> (out, final state), decode writing its
# cache in place
_RECURRENT = {
    "mamba": (mamba_lib.mamba_forward, mamba_lib.mamba_decode),
    "mlstm": (xlstm_lib.mlstm_forward, xlstm_lib.mlstm_decode),
    "slstm": (xlstm_lib.slstm_forward, xlstm_lib.slstm_decode),
}


def _dtype(cfg: ArchConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def check_ported(cfg: ArchConfig) -> None:
    """Raise for a layer plan the transformer cannot build."""
    for spec in cfg.layer_plan():
        if spec.kind != "attn" and spec.kind not in _RECURRENT:
            raise ValueError(f"{cfg.name}: unknown layer kind {spec.kind!r}")
        if spec.kind == "mamba" and cfg.ssm is None:
            raise ValueError(f"{cfg.name}: a mamba layer needs cfg.ssm (d_state, d_conv, "
                             "expand)")


# ============================ block ============================
def init_block(gen: torch.Generator, cfg: ArchConfig, spec: LayerSpec, *, lead=(),
               device=None) -> dict:
    """One block's params; ``lead`` = (L,) draws the stacked leaves of L
    layers at once."""
    dt = _dtype(cfg)
    if spec.kind == "attn":
        init_mixer = attn_lib.init_attention if cfg.mla is None else mla_lib.init_mla
    elif spec.kind == "mamba":
        init_mixer = mamba_lib.init_mamba
    elif spec.kind == "mlstm":
        init_mixer = xlstm_lib.init_mlstm
    elif spec.kind == "slstm":
        init_mixer = xlstm_lib.init_slstm
    else:
        raise ValueError(spec.kind)
    p: dict = {
        "norm1": init_norm(cfg, cfg.d_model, lead=lead, device=device),
        "mixer": init_mixer(gen, cfg, dt, lead=lead, device=device),
    }
    if cfg.d_ff > 0:
        p["norm2"] = init_norm(cfg, cfg.d_model, lead=lead, device=device)
        p["ffn"] = (moe_lib.init_moe(gen, cfg, dt, lead=lead, device=device) if spec.moe
                    else init_mlp(gen, cfg.d_model, cfg.d_ff, dt, lead=lead, device=device))
    return p


def _ffn(cfg: ArchConfig, spec: LayerSpec, params: dict, x: torch.Tensor,
         capacity_factor: float) -> tuple[torch.Tensor, dict | None]:
    """x plus the block's feed-forward; the MoE layer's aux dict (None
    for the MLP or a block without one)."""
    if cfg.d_ff == 0:
        return x, None
    h = apply_norm(cfg, params["norm2"], x)
    if spec.moe:
        out, aux = moe_lib.moe_forward(cfg, params["ffn"], h, capacity_factor=capacity_factor)
        return x + out, aux
    return x + mlp_forward(params["ffn"], h, cfg.act), None


def block_forward(cfg: ArchConfig, spec: LayerSpec, params: dict, x: torch.Tensor, *,
                  window=None, cache: dict | None = None, ring: bool = False):
    """Full-sequence pass of one block -> (x, the MoE aux dict or None).
    Given this layer's ``cache`` (prefill), what its mixer leaves for
    decode is written into it: the K and V its attention projected (MLA's
    latents), or a recurrent mixer's final state."""
    h = apply_norm(cfg, params["norm1"], x)
    if spec.kind == "attn" and cfg.mla is not None:
        out, c_kv, k_rope = mla_lib.mla_forward(cfg, params["mixer"], h, window=window)
        if cache is not None:
            _ring_arrange(c_kv, cache["c_kv"], ring)
            _ring_arrange(k_rope, cache["k_rope"], ring)
    elif spec.kind == "attn":
        out, k, v = attn_lib.attention_forward(cfg, params["mixer"], h, window=window)
        if cache is not None:
            _ring_arrange(k, cache["k"], ring)
            _ring_arrange(v, cache["v"], ring)
    elif spec.kind in _RECURRENT:
        out, state = _RECURRENT[spec.kind][0](cfg, params["mixer"], h)
        if cache is not None:
            for key, t in state.items():
                cache[key].copy_(t)
    else:
        raise ValueError(spec.kind)
    return _ffn(cfg, spec, params, x + out, 1.25)


def block_decode(cfg: ArchConfig, spec: LayerSpec, params: dict, x: torch.Tensor,
                 cache: dict, pos: int, *, ring: bool, valid: torch.Tensor | None):
    """One-token decode. x: (B,1,d). Returns (x, cache), the cache written
    in place.  ``valid`` is the attention layers' slot mask (None in a
    stack without attention)."""
    h = apply_norm(cfg, params["norm1"], x)
    if spec.kind == "attn":
        decode = attn_lib.attention_decode if cfg.mla is None else mla_lib.mla_decode
        out, cache = decode(cfg, params["mixer"], h, cache, pos, ring=ring, valid=valid)
    elif spec.kind in _RECURRENT:
        out, cache = _RECURRENT[spec.kind][1](cfg, params["mixer"], h, cache)
    else:
        raise ValueError(spec.kind)
    return _ffn(cfg, spec, params, x + out, 2.0)[0], cache


# ============================ full model ============================
def init_params(cfg: ArchConfig, seed: int = 0, *, device=None) -> PyTree:
    """JAX's tree, shapes and dtypes, with the port's own draws from an
    explicit ``torch.Generator`` seeded with ``seed`` (on ``device``)."""
    check_ported(cfg)
    dev = torch.device("cpu" if device is None else device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    dt = _dtype(cfg)
    params: dict = {
        "embed": init_embedding(gen, cfg.vocab_size, cfg.d_model, dt, dev),
        "final_norm": init_norm(cfg, cfg.d_model, device=dev),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = {"w": normal(gen, (cfg.d_model, cfg.vocab_size), cfg.d_model,
                                         dt, dev)}
    if cfg.frontend_tokens:
        fd = cfg.frontend_dim or cfg.d_model
        params["frontend_proj"] = {"w": normal(gen, (fd, cfg.d_model), fd, dt, dev)}
    plan = cfg.layer_plan()
    if cfg.scan_layers:
        period = cfg.plan_period
        lead = (cfg.n_layers // period,)
        params["blocks"] = tuple(
            init_block(gen, cfg, plan[pos], lead=lead, device=dev) for pos in range(period)
        )
    else:
        params["blocks"] = tuple(
            init_block(gen, cfg, plan[i], device=dev) for i in range(cfg.n_layers)
        )
    return params


def _layers(cfg: ArchConfig, blocks: tuple):
    """(layer spec, that layer's params) in stack order: views into the
    stacked leaves when ``scan_layers``.  The views come from one
    ``unbind`` a leaf, whose gradient is one stack of the layers'
    gradients; indexing a layer out (``x[j]``) would give each layer's
    gradient the whole stacked leaf's size, zeros around its slice, and
    sum L of them."""
    plan = cfg.layer_plan()
    if not cfg.scan_layers:
        yield from zip(plan, blocks)
        return
    period = cfg.plan_period
    unbound = [[x.unbind(0) for x in tree_leaves(b)] for b in blocks]
    for i in range(cfg.n_layers):
        pos, j = i % period, i // period
        yield plan[i], tree_unflatten(blocks[pos], [u[j] for u in unbound[pos]])


def _layer_caches(cfg: ArchConfig, layers: tuple):
    """Each layer's cache dict, views into the stacked caches when
    ``scan_layers``: writing to one writes the stacked tensor."""
    if not cfg.scan_layers:
        yield from layers
        return
    period = cfg.plan_period
    for i in range(cfg.n_layers):
        yield tree_map(lambda x, j=i // period: x[j], layers[i % period])


def _embed_inputs(cfg: ArchConfig, params: dict, batch: dict) -> torch.Tensor:
    """tokens (B, S) (+ the frontend's (B, F, frontend_dim) embeddings,
    projected and prepended) -> (B, F + S, d) residual stream."""
    x = embed(params["embed"], batch["tokens"])
    if cfg.frontend_tokens:
        if "frontend" not in batch:
            raise ValueError(f"{cfg.name} takes batch['frontend'], (B, {cfg.frontend_tokens}, "
                             f"{cfg.frontend_dim or cfg.d_model}) embeddings")
        fe = torch.matmul(batch["frontend"].to(x.dtype), params["frontend_proj"]["w"])
        x = torch.cat([fe, x], dim=1)
    return x.to(_dtype(cfg))


def _run_stack(cfg: ArchConfig, params: dict, x: torch.Tensor, *, window=None):
    """All blocks -> (x, the aux terms summed over the MoE layers; fp32
    zeros where the stack has none)."""
    aux = {k: torch.zeros((), dtype=torch.float32, device=x.device) for k in AUX_KEYS}
    for spec, p in _layers(cfg, params["blocks"]):
        x, a = block_forward(cfg, spec, p, x, window=window)
        if a is not None:
            aux = {k: aux[k] + a[k] for k in AUX_KEYS}
    return x, aux


def _logits(cfg: ArchConfig, params: dict, x: torch.Tensor) -> torch.Tensor:
    if cfg.tie_embeddings:
        return torch.matmul(x, params["embed"]["table"].transpose(0, 1))
    return torch.matmul(x, params["lm_head"]["w"])


def forward(cfg: ArchConfig, params: dict, batch: dict, *, window=None):
    """Full-sequence (logits (B, S, V), aux): aux is ``AUX_KEYS``' MoE terms
    summed over the layers, as JAX's."""
    x, aux = _run_stack(cfg, params, _embed_inputs(cfg, params, batch), window=window)
    return _logits(cfg, params, apply_norm(cfg, params["final_norm"], x)), aux


# ---------------- losses ----------------
def _training_gaps(cfg: ArchConfig) -> list[str]:
    """What the port lacks to train ``cfg``, one line a family; empty for
    the dense, MoE, MLA, frontend-token and hybrid Mamba families."""
    kinds = {spec.kind for spec in cfg.layer_plan()}
    gaps = []
    if kinds & {"mlstm", "slstm"}:
        gaps.append("xLSTM: the mLSTM's and the sLSTM recurrence's backward")
    return gaps


def cross_entropy(cfg: ArchConfig, params: dict, x_final: torch.Tensor, labels: torch.Tensor,
                  *, chunk: int = 0) -> torch.Tensor:
    """Token CE over the final residual stream; labels == -1 are masked.
    Logits in fp32, the gold logit gathered at max(labels, 0), the sum over
    the unmasked tokens divided by max(their count, 1).

    ``chunk > 0`` (dividing S, S > chunk) sums the loss chunk by chunk along
    the sequence, as JAX's ``lax.map`` does; JAX also checkpoints each
    chunk so the (B, S, V) logits never exist at once.  The port computes
    the same sum plainly: ``torch.utils.checkpoint`` does not run under
    ``torch.func.grad`` (saved-tensor hooks, or an autograd.Function
    without ``setup_context``), so every chunk's logits stay saved."""
    b, s, _ = x_final.shape

    def ce_of(xc, yc):
        logits = _logits(cfg, params, xc).to(torch.float32)
        logz = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, torch.clamp(yc, min=0).to(torch.int64)[..., None])[..., 0]
        mask = (yc >= 0).to(torch.float32)
        return torch.sum((logz - gold) * mask), torch.sum(mask)

    if chunk and s % chunk == 0 and s > chunk:
        parts = [ce_of(x_final[:, i:i + chunk], labels[:, i:i + chunk])
                 for i in range(0, s, chunk)]
        total = torch.sum(torch.stack([t for t, _ in parts]))
        n = torch.sum(torch.stack([c for _, c in parts]))
    else:
        total, n = ce_of(x_final, labels)
    return total / torch.clamp(n, min=1.0)


def loss_fn(cfg: ArchConfig, params: dict, batch: dict, *, ce_chunk: int = 0):
    """FL-client local loss: CE over next-token ``batch["labels"]``, plus
    ``moe_loss`` of the aux terms summed over the MoE layers where the
    config has experts -> (loss, metrics {"ce", the MoE aux keys}).  Raises
    for a family whose training is not ported (``_training_gaps``)."""
    gaps = _training_gaps(cfg)
    if gaps:
        raise NotImplementedError(
            f"{cfg.name}: transformer training (loss_fn) is ported for the dense, MoE, MLA, "
            f"frontend-token and hybrid Mamba families; missing here: {'; '.join(gaps)} "
            f"({_ITEM})")
    x = _embed_inputs(cfg, params, batch)
    x, aux = _run_stack(cfg, params, x)
    x = apply_norm(cfg, params["final_norm"], x)

    labels = batch["labels"]
    if cfg.frontend_tokens:  # the frontend's positions predict nothing (the reference's pad)
        pad = torch.full((labels.shape[0], cfg.frontend_tokens), -1, dtype=labels.dtype,
                         device=labels.device)
        labels = torch.cat([pad, labels], dim=1)

    ce = cross_entropy(cfg, params, x, labels, chunk=ce_chunk)
    loss = ce if cfg.moe is None else ce + moe_lib.moe_loss(aux, cfg)
    return loss, {"ce": ce, **aux}


# ---------------- prefill / decode ----------------
def _ring(cfg: ArchConfig, shape_seq_len: int) -> tuple[bool, int]:
    """(use ring buffer?, cache_len) for a given context length."""
    win = cfg.sliding_window
    if win is None and shape_seq_len > 65_536:
        win = cfg.long_context_window  # sliding-window variant for long contexts
    if win is not None and win < shape_seq_len:
        return True, win
    return False, shape_seq_len


def init_cache(cfg: ArchConfig, batch: int, context_len: int, *, device=None) -> dict:
    """Each layer's cache by its kind: K and V (B, cache_len, KV, hd) for
    attention (under MLA the latents c_kv (B, cache_len, kv_lora_rank) and
    k_rope (B, cache_len, rope)), conv (B, d_conv - 1, di) and fp32 ssm
    (B, di, N) state for mamba, fp32 C (B, H, hd, hd), n (B, H, hd) and m
    (B, H) for mLSTM, fp32 c, n, h and m (B, H, hd) for sLSTM; stacked
    ``(L / period, ...)`` per position when ``scan_layers``."""
    check_ported(cfg)
    _, cache_len = _ring(cfg, context_len)
    dt = _dtype(cfg)
    plan = cfg.layer_plan()

    def one(spec, lead):
        if spec.kind == "attn":
            init = attn_lib.init_kv_cache if cfg.mla is None else mla_lib.init_mla_cache
            return init(cfg, batch, cache_len, dt, lead=lead, device=device)
        if spec.kind == "mamba":
            return mamba_lib.init_mamba_cache(cfg, batch, dt, lead=lead, device=device)
        if spec.kind == "mlstm":
            return xlstm_lib.init_mlstm_cache(cfg, batch, lead=lead, device=device)
        if spec.kind == "slstm":
            return xlstm_lib.init_slstm_cache(cfg, batch, lead=lead, device=device)
        raise ValueError(spec.kind)

    if not cfg.scan_layers:
        layers = tuple(one(plan[i], ()) for i in range(cfg.n_layers))
    else:
        lead = (cfg.n_layers // cfg.plan_period,)
        layers = tuple(one(plan[pos], lead) for pos in range(cfg.plan_period))
    return {"layers": layers, "pos": torch.zeros((), dtype=torch.int32)}


def decode_step(cfg: ArchConfig, params: dict, batch: dict, cache: dict, *,
                context_len: int):
    """One-token decode: batch {"tokens": (B,1)} -> (logits (B,1,V), cache).
    The cache's K and V (MLA's latents) and the recurrent states are
    written in place; the returned cache holds the same tensors and
    ``pos + 1``."""
    ring, cache_len = _ring(cfg, context_len)
    pos = int(cache["pos"])  # host-side: no sync (a card tensor syncs once a step)
    x = embed(params["embed"], batch["tokens"]).to(_dtype(cfg))
    # every attention layer masks the same slots: one mask a step, not one a layer
    valid = None
    if any(spec.kind == "attn" for spec in cfg.layer_plan()):
        valid = attn_lib.kv_valid(x.shape[0], cache_len, pos, ring=ring, device=x.device)
    for (spec, p), c in zip(_layers(cfg, params["blocks"]),
                            _layer_caches(cfg, cache["layers"]), strict=True):
        x, _ = block_decode(cfg, spec, p, x, c, pos, ring=ring, valid=valid)
    logits = _logits(cfg, params, apply_norm(cfg, params["final_norm"], x))
    return logits, {"layers": cache["layers"], "pos": torch.tensor(pos + 1, dtype=torch.int32)}


def prefill(cfg: ArchConfig, params: dict, batch: dict, *, context_len: int):
    """Prefill: full forward + cache construction. Returns (next-token logits
    (B,1,V), cache)."""
    ring, _ = _ring(cfg, context_len)
    x = _embed_inputs(cfg, params, batch)
    b, s, _ = x.shape
    cache = init_cache(cfg, b, context_len, device=x.device)
    for (spec, p), c in zip(_layers(cfg, params["blocks"]),
                            _layer_caches(cfg, cache["layers"]), strict=True):
        x, _ = block_forward(cfg, spec, p, x, cache=c, ring=ring)
    x = apply_norm(cfg, params["final_norm"], x)
    logits = _logits(cfg, params, x[:, -1:])  # next-token logits only
    return logits, {"layers": cache["layers"], "pos": torch.tensor(s, dtype=torch.int32)}


def _ring_arrange(full: torch.Tensor, out: torch.Tensor, ring: bool) -> torch.Tensor:
    """full: (B,S,...) per-position tensor -> its cache layout, written into
    ``out`` (B,cache_len,...), which holds zeros past S.  The prefill writes
    what its mixer projected (JAX projects K and V, or MLA's latents, a
    second time; the result is the same)."""
    s, cache_len = full.shape[1], out.shape[1]
    if not ring or s <= cache_len:
        out[:, :s] = full
        return out
    # absolute positions s-cache_len .. s-1 -> slot = pos % cache_len
    slots = torch.arange(s - cache_len, s, device=full.device) % cache_len
    out[:, slots] = full[:, s - cache_len:]
    return out
