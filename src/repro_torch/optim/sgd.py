"""SGD (+momentum, +weight decay) — the paper's on-device client optimizer.

Plain SGD keeps per-client optimizer state tiny (zero for momentum=0):
memory = params + grads only.
"""
from __future__ import annotations

import torch

from repro_torch.utils.pytree import tree_map

from .base import Optimizer, constant_schedule


def sgd(lr, momentum: float = 0.0, weight_decay: float = 0.0, nesterov: bool = False) -> Optimizer:
    schedule = lr if callable(lr) else constant_schedule(lr)

    def init(params):
        if momentum == 0.0:
            return ()
        return tree_map(torch.zeros_like, params)

    def update(grads, params, state, step):
        lr_t = schedule(step)

        if weight_decay:
            grads = tree_map(lambda g, p: g + weight_decay * p.to(g.dtype), grads, params)
        if momentum == 0.0:
            new_params = tree_map(
                lambda p, g: p - (lr_t * g.to(torch.float32)).to(p.dtype), params, grads
            )
            return new_params, state

        new_state = tree_map(lambda m, g: momentum * m + g.to(m.dtype), state, grads)
        step_dir = (
            tree_map(lambda m, g: momentum * m + g.to(m.dtype), new_state, grads)
            if nesterov
            else new_state
        )
        new_params = tree_map(
            lambda p, d: p - (lr_t * d.to(torch.float32)).to(p.dtype), params, step_dir
        )
        return new_params, new_state

    return Optimizer(init, update)
