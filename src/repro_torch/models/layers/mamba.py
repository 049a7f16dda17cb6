"""Mamba (selective SSM) block, Jamba's recurrent layer: the twin of
``repro.models.layers.mamba``.

Prefill runs the selective scan over the whole sequence (the hand-written
kernel on the card, through ``kernels.ops``); decode is the O(1) recurrent
step carrying (conv state, ssm state).  ``mamba_forward`` returns the
final state beside the output, so a prefill gets its cache from the one
pass (JAX runs a second copy of the forward for it,
``repro/models/transformer.py:560``).  A decode step writes the state in
place, as the attention layer writes its KV cache.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops

from .embeddings import normal
from .mlp import silu


def _dims(cfg):
    d_inner = cfg.ssm.expand * cfg.d_model
    dt_rank = cfg.ssm.dt_rank or math.ceil(cfg.d_model / 16)
    return d_inner, dt_rank, cfg.ssm.d_state, cfg.ssm.d_conv


def init_mamba(gen: torch.Generator, cfg, dtype, *, lead=(), device=None) -> dict:
    """JAX's leaves, shapes and dtypes (``conv_b``, ``dt_bias``, ``A_log``
    and ``D`` in fp32), with the port's own draws; ``lead`` = (L,) draws L
    layers' stacked leaves at once."""
    d = cfg.d_model
    di, dtr, n, dc = _dims(cfg)
    f32 = torch.float32
    u = torch.rand((*lead, di), generator=gen, dtype=f32, device=device)
    # dt bias so that softplus(dt) spans ~[1e-3, 1e-1] (the mamba reference)
    dt_init = torch.exp(u * (math.log(0.1) - math.log(1e-3)) + math.log(1e-3))
    a_log = torch.log(torch.arange(1, n + 1, dtype=f32, device=device))
    return {
        "in_proj": normal(gen, (*lead, d, 2 * di), d, dtype, device),
        "conv_w": normal(gen, (*lead, dc, di), dc, dtype, device),
        "conv_b": torch.zeros((*lead, di), dtype=f32, device=device),
        "x_proj": normal(gen, (*lead, di, dtr + 2 * n), di, dtype, device),
        "dt_proj": normal(gen, (*lead, dtr, di), dtr, dtype, device),
        "dt_bias": dt_init + torch.log(-torch.expm1(-dt_init)),  # inverse softplus
        "A_log": a_log.expand(*lead, di, n).contiguous(),
        "D": torch.ones((*lead, di), dtype=f32, device=device),
        "out_proj": normal(gen, (*lead, di, d), di, dtype, device),
    }


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``, which is ``jnp.logaddexp(x, 0)``:
    max(x, 0) + log1p(exp(-|x|)), NaN passed through."""
    return torch.where(torch.isnan(x), x, x.clamp_min(0) + torch.log1p(torch.exp(-x.abs())))


def _ssm_inputs(cfg, params: dict, xc: torch.Tensor):
    """xc: post-conv activations (B,S,di) in the model dtype -> (dt, B, C),
    all fp32."""
    _, dtr, n, _ = _dims(cfg)
    proj = torch.matmul(xc, params["x_proj"])
    dt = softplus(torch.matmul(proj[..., :dtr], params["dt_proj"]).to(torch.float32)
                  + params["dt_bias"])
    return dt, proj[..., dtr:dtr + n].to(torch.float32), proj[..., dtr + n:].to(torch.float32)


def mamba_forward(cfg, params: dict, u: torch.Tensor):
    """u: (B,S,d) -> (out (B,S,d), state {"conv", "ssm"}): the selective
    scan over the sequence, and the state a decode continues from."""
    _, _, _, dc = _dims(cfg)
    s = u.shape[1]
    x, z = torch.chunk(torch.matmul(u, params["in_proj"]), 2, dim=-1)

    # causal depthwise conv1d as JAX writes it: a sum of dc shifted
    # products, each rounded to the model dtype (F.conv1d would not round
    # where XLA rounds)
    x_pad = F.pad(x, (0, 0, dc - 1, 0))
    xc = sum(x_pad[:, i:i + s] * params["conv_w"][i] for i in range(dc))
    xc = silu(xc + params["conv_b"].to(x.dtype))

    dt, bm, cm = _ssm_inputs(cfg, params, xc)
    y, ssm = ops.selective_scan(xc, dt, -torch.exp(params["A_log"]), bm, cm, params["D"])
    out = torch.matmul(y * silu(z), params["out_proj"])
    # the last dc - 1 raw (pre-conv) rows, zeros included when S < dc - 1
    return out, {"conv": x_pad[:, s:], "ssm": ssm}


# ---------------- decode ----------------
def init_mamba_cache(cfg, batch: int, dtype, *, lead=(), device=None) -> dict:
    di, _, n, dc = _dims(cfg)
    return {"conv": torch.zeros((*lead, batch, dc - 1, di), dtype=dtype, device=device),
            "ssm": torch.zeros((*lead, batch, di, n), dtype=torch.float32, device=device)}


def mamba_decode(cfg, params: dict, u: torch.Tensor, cache: dict):
    """u: (B,1,d) -> (out (B,1,d), cache): the O(1) recurrent step, the
    cache's conv and ssm state written in place."""
    xz = torch.matmul(u[:, 0], params["in_proj"])
    x, z = torch.chunk(xz, 2, dim=-1)  # (B, di)

    conv_buf = torch.cat([cache["conv"], x[:, None]], dim=1)  # (B, dc, di)
    # JAX's einsum: exact products summed in fp32, rounded once
    xc = torch.einsum("bcd,cd->bd", conv_buf.to(torch.float32),
                      params["conv_w"].to(torch.float32)).to(x.dtype)
    xc = silu(xc + params["conv_b"].to(x.dtype))

    dt, bm, cm = _ssm_inputs(cfg, params, xc)
    y, new_ssm = ops.selective_scan_step(xc, dt, -torch.exp(params["A_log"]), bm, cm,
                                         params["D"], cache["ssm"])
    out = torch.matmul(y * silu(z), params["out_proj"])[:, None]
    cache["conv"].copy_(conv_buf[:, 1:])
    cache["ssm"].copy_(new_ssm)
    return out, cache
