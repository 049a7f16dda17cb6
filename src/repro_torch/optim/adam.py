"""Adam / AdamW / Yogi -- the server optimizers of FedAdam and FedYogi, and
available as a client optimizer for small models (twin of
``repro.optim.adam``).

Rounding follows the JAX package:
- Adam's bias corrections are fp32, ``1 - b ** (f32(step) + 1)``; they
  are computed as numpy float32 scalars on the host, since a Python float
  rounds them differently and a card scalar built from a Python value
  syncs the host.
- The divisions by them are by a tensor: on CUDA ``tensor /
  python_scalar`` multiplies by the reciprocal.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.utils.pytree import tree_map

from .base import Optimizer, constant_schedule


def _scalar_like(x: torch.Tensor, value) -> torch.Tensor:
    """An fp32 0-d tensor on ``x``'s device, filled without a host sync."""
    return torch.full((), float(value), dtype=torch.float32, device=x.device)


def adam(
    lr,
    b1: float = 0.9,
    b2: float = 0.999,
    eps: float = 1e-8,
    weight_decay: float = 0.0,
    state_dtype=torch.float32,
) -> Optimizer:
    schedule = lr if callable(lr) else constant_schedule(lr)

    def init(params):
        zeros = lambda p: torch.zeros(p.shape, dtype=state_dtype, device=p.device)
        return {"m": tree_map(zeros, params), "v": tree_map(zeros, params)}

    def update(grads, params, state, step):
        step = np.float32(int(step)) + np.float32(1.0)
        lr_t = schedule(step)
        bc1 = np.float32(1.0) - np.float32(b1) ** step
        bc2 = np.float32(1.0) - np.float32(b2) ** step

        m = tree_map(
            lambda m_, g: b1 * m_ + (1 - b1) * g.to(state_dtype), state["m"], grads
        )
        v = tree_map(
            lambda v_, g: b2 * v_ + (1 - b2) * torch.square(g.to(state_dtype)),
            state["v"], grads,
        )

        def step_fn(p, m_, v_):
            upd = (m_ / _scalar_like(m_, bc1)) / (
                torch.sqrt(v_ / _scalar_like(v_, bc2)) + eps
            )
            if weight_decay:
                upd = upd + weight_decay * p.to(state_dtype)
            return (p.to(state_dtype) - lr_t * upd).to(p.dtype)

        new_params = tree_map(step_fn, params, m, v)
        return new_params, {"m": m, "v": v}

    return Optimizer(init, update)


def adamw(lr, weight_decay: float = 0.01, **kw) -> Optimizer:
    return adam(lr, weight_decay=weight_decay, **kw)


def yogi(lr, b1: float = 0.9, b2: float = 0.99, eps: float = 1e-3) -> Optimizer:
    """Yogi second-moment update (additive, sign-controlled; ``sign(0) =
    0``), v starting at 1e-6 -- the FedYogi server optimizer.  Its step
    has no ``+ 1``."""
    schedule = lr if callable(lr) else constant_schedule(lr)

    def init(params):
        return {
            "m": tree_map(
                lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device), params
            ),
            "v": tree_map(
                lambda p: torch.full(p.shape, 1e-6, dtype=torch.float32, device=p.device),
                params,
            ),
        }

    def update(grads, params, state, step):
        lr_t = schedule(step)
        m = tree_map(
            lambda m_, g: b1 * m_ + (1 - b1) * g.to(torch.float32), state["m"], grads
        )

        def v_fn(v_, g):
            g2 = torch.square(g.to(torch.float32))
            return v_ - (1 - b2) * torch.sign(v_ - g2) * g2

        v = tree_map(v_fn, state["v"], grads)
        new_params = tree_map(
            lambda p, m_, v_: (
                p.to(torch.float32) - lr_t * m_ / (torch.sqrt(v_) + eps)
            ).to(p.dtype),
            params, m, v,
        )
        return new_params, {"m": m, "v": v}

    return Optimizer(init, update)
