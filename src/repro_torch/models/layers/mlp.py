"""Gated MLP (SwiGLU / GeGLU), the twin of ``repro.models.layers.mlp``.
Plain matrix products: in JAX these are XLA dots outside any kernel."""
from __future__ import annotations

import math

import torch

from .embeddings import normal


def silu(a: torch.Tensor) -> torch.Tensor:
    """``a * (1 / (1 + exp(-a)))``, each step in a's dtype: how XLA expands
    ``jax.nn.silu``, so bf16 activations round where JAX's round."""
    return a * torch.reciprocal(1.0 + torch.exp(-a))


def gelu(a: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu``'s tanh approximation as XLA expands it: each step,
    and each constant, in a's dtype."""
    k = lambda v: torch.full((), v, dtype=a.dtype, device=a.device)  # noqa: E731
    inner = k(math.sqrt(2.0 / math.pi)) * (a + k(0.044715) * (a * a * a))
    return a * (k(0.5) * (k(1.0) + torch.tanh(inner)))


def init_mlp(gen: torch.Generator, d_model: int, d_ff: int, dtype, *, lead=(),
             device=None) -> dict:
    return {
        "w_gate": normal(gen, (*lead, d_model, d_ff), d_model, dtype, device),
        "w_up": normal(gen, (*lead, d_model, d_ff), d_model, dtype, device),
        "w_down": normal(gen, (*lead, d_ff, d_model), d_ff, dtype, device),
    }


def mlp_forward(params: dict, x: torch.Tensor, act: str = "silu") -> torch.Tensor:
    a = torch.matmul(x, params["w_gate"])
    g = silu(a) if act == "silu" else gelu(a)
    h = g * torch.matmul(x, params["w_up"])
    return torch.matmul(h, params["w_down"])
