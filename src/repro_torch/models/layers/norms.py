"""Normalization layers: fp32 compute, cast back; the transformer norms
store their scale as ``1 + s``, ``groupnorm`` (the ResNet's) as ``s``.

The twin of ``repro.models.layers.norms``."""
from __future__ import annotations

import torch


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    dtype = x.dtype
    x = x.to(torch.float32)
    var = torch.mean(torch.square(x), dim=-1, keepdim=True)
    y = x * torch.rsqrt(var + eps)
    return (y * (1.0 + scale.to(torch.float32))).to(dtype)


def layernorm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
              eps: float = 1e-5) -> torch.Tensor:
    dtype = x.dtype
    x = x.to(torch.float32)
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean(torch.square(x - mu), dim=-1, keepdim=True)
    y = (x - mu) * torch.rsqrt(var + eps)
    return (y * (1.0 + scale.to(torch.float32)) + bias.to(torch.float32)).to(dtype)


def groupnorm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, groups: int = 8,
              eps: float = 1e-5) -> torch.Tensor:
    """GroupNorm over channel-last conv activations (N, H, W, C), as the
    reference computes it: fp32, the channels split (groups, C / groups),
    mean and population variance over (H, W, C / groups), then the affine.
    Explicit tensor ops, not ``F.group_norm``: they round where the
    reference rounds, and ``torch.func.vmap`` (the round engine's parallel
    mode) maps them without a batching rule of its own."""
    n, h, w, c = x.shape
    dtype = x.dtype
    xg = x.to(torch.float32).reshape(n, h, w, groups, c // groups)
    mu = torch.mean(xg, dim=(1, 2, 4), keepdim=True)
    var = torch.mean(torch.square(xg - mu), dim=(1, 2, 4), keepdim=True)
    y = ((xg - mu) * torch.rsqrt(var + eps)).reshape(n, h, w, c)
    return (y * scale.to(torch.float32) + bias.to(torch.float32)).to(dtype)


def init_norm(cfg, d: int, *, lead=(), device=None) -> dict:
    """Zero scale (and bias): the identity map.  ``lead`` prepends the
    stacked-layers dimension."""
    z = lambda: torch.zeros((*lead, d), dtype=torch.float32, device=device)  # noqa: E731
    if cfg.norm == "rmsnorm":
        return {"scale": z()}
    return {"scale": z(), "bias": z()}


def apply_norm(cfg, params: dict, x: torch.Tensor) -> torch.Tensor:
    if cfg.norm == "rmsnorm":
        return rmsnorm(x, params["scale"])
    return layernorm(x, params["scale"], params["bias"])
