"""Base/Head split model — the paper's §4.1 Android personalization design.

The frozen *Base Model* (MobileNetV2 feature extractor in the paper) is a
fixed random projection producing `feature_dim` features; FL trains only the
2-layer *Head Model*.  ``trainable_mask`` realizes the freeze: frozen leaves
pass through local SGD untouched.  Weights keep the JAX package's ``x @ w``
layout, ``w`` as (in, out), so parameters carry over leaf for leaf.
"""
from __future__ import annotations

import math

import torch

from repro_torch.utils.device import resolve_device


def init_params(cfg, *, seed: int = 0, device=None) -> dict:
    """Seeded random params on ``device`` (None: the card).  Torch's
    generator draws other numbers than ``jax.random``; parity tests start
    both packages from the JAX init via
    ``repro_torch.models.params_from_numpy`` instead."""
    device = resolve_device(device)
    g = torch.Generator().manual_seed(seed)

    def normal(*shape):
        return torch.randn(*shape, generator=g, dtype=torch.float32) / math.sqrt(shape[0])

    params = {
        "base": {  # frozen feature extractor (identity-ish random projection)
            "w": normal(cfg.feature_dim, cfg.feature_dim),
        },
        "head": {
            "w1": normal(cfg.feature_dim, cfg.hidden_dim),
            "b1": torch.zeros(cfg.hidden_dim),
            "w2": normal(cfg.hidden_dim, cfg.num_classes),
            "b2": torch.zeros(cfg.num_classes),
        },
    }
    return {k: {n: t.to(device) for n, t in sub.items()} for k, sub in params.items()}


def trainable_mask(params) -> dict:
    """True = FL-trainable (head), False = frozen (base)."""
    return {
        "base": {k: False for k in params["base"]},
        "head": {k: True for k in params["head"]},
    }


def forward(cfg, params, x):
    feats = torch.relu(x @ params["base"]["w"])  # frozen base
    h = torch.relu(feats @ params["head"]["w1"] + params["head"]["b1"])
    return h @ params["head"]["w2"] + params["head"]["b2"]


def loss_fn(cfg, params, batch):
    logits = forward(cfg, params, batch["x"])
    labels = batch["y"].long()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[:, None])[:, 0]
    loss = torch.mean(logz - gold)
    acc = torch.mean((torch.argmax(logits, -1) == labels).to(torch.float32))
    return loss, {"ce": loss, "acc": acc}
