"""Token embeddings + rotary position encodings (half-split rotation), the
twin of ``repro.models.layers.embeddings``."""
from __future__ import annotations

import math

import torch


def normal(gen: torch.Generator, shape, fan_in: int, dtype, device) -> torch.Tensor:
    """N(0, 1/fan_in) drawn in fp32 from ``gen``, cast to ``dtype``: the
    JAX package's initializer, with the port's own draws."""
    x = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
    return (x / math.sqrt(fan_in)).to(dtype)


def init_embedding(gen: torch.Generator, vocab: int, d_model: int, dtype, device) -> dict:
    return {"table": normal(gen, (vocab, d_model), d_model, dtype, device)}


def embed(params: dict, tokens: torch.Tensor) -> torch.Tensor:
    return params["table"][tokens]


def rope_angles(positions: torch.Tensor, head_dim: int, theta: float):
    """positions: (...,) int -> cos/sin of shape (..., head_dim//2), fp32.
    ``freqs = exp(-ln(theta) * i / half)`` in fp32, as JAX computes it."""
    half = head_dim // 2
    # ln(theta) in fp32, on the host: a scalar tensor made on the card would
    # be a host-to-device copy, which waits for the card every layer
    log_theta = float(torch.log(torch.tensor(theta, dtype=torch.float32)))
    idx = torch.arange(half, dtype=torch.float32, device=positions.device)
    freqs = torch.exp(-log_theta * idx / half)
    ang = positions.to(torch.float32)[..., None] * freqs
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x: (..., S, H, D); cos/sin: (..., S, D/2) broadcast over heads."""
    dtype = x.dtype
    x = x.to(torch.float32)
    x1, x2 = torch.chunk(x, 2, dim=-1)
    c = cos[..., None, :]
    s = sin[..., None, :]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1).to(dtype)
