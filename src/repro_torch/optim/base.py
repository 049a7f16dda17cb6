"""Minimal functional optimizer core, the twin of ``repro.optim.base``.

An ``Optimizer`` is an (init, update) pair over pytrees of tensors.
``update`` returns (new_params, new_state) directly; the caller runs it
under ``torch.no_grad()`` so the new params carry no autograd history.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable, NamedTuple

import torch

from repro_torch.utils.pytree import tree_leaves, tree_map

PyTree = Any


class Optimizer(NamedTuple):
    init: Callable[[PyTree], PyTree]
    update: Callable[[PyTree, PyTree, PyTree, Any], tuple[PyTree, PyTree]]
    # update(grads, params, state, step) -> (new_params, new_state)


def chain_clip_by_global_norm(opt: Optimizer, max_norm: float) -> Optimizer:
    """Wrap an optimizer with global-norm gradient clipping."""

    def update(grads, params, state, step):
        gnorm = torch.sqrt(
            sum(torch.sum(torch.square(g.to(torch.float32))) for g in tree_leaves(grads))
        )
        scale = torch.clamp(max_norm / (gnorm + 1e-9), max=1.0)
        grads = tree_map(lambda g: g * scale.to(g.dtype), grads)
        return opt.update(grads, params, state, step)

    return Optimizer(opt.init, update)


@dataclass(frozen=True)
class Schedule:
    """Piecewise schedule: linear warmup then cosine decay to `final_frac`."""

    base_lr: float
    warmup_steps: int = 0
    decay_steps: int = 0
    final_frac: float = 0.1

    def __call__(self, step) -> float:
        step = float(step)
        warm = min(1.0, step / max(1, self.warmup_steps))
        if self.decay_steps:
            prog = min(1.0, max(0.0, (step - self.warmup_steps) / max(1, self.decay_steps)))
            cos = self.final_frac + (1 - self.final_frac) * 0.5 * (1 + math.cos(math.pi * prog))
        else:
            cos = 1.0
        return self.base_lr * warm * cos


def constant_schedule(lr: float):
    return lambda step: lr
