"""Model API: a uniform functional interface, the twin of ``repro.models``.

``build_model(arch_name_or_cfg, device=None)`` returns a `Model` whose
methods are plain functions on nested dicts of tensors:

    init(seed) -> params (on the model's device)
    loss_fn(params, batch) -> (loss, metrics)
    trainable_mask(params) -> bool pytree (None = all trainable)
    prefill / decode_step / init_cache (transformers)

The port runs the ``head`` and ``cnn`` (ResNet-18) families, the
serving path (prefill + decode) of every transformer family (dense, MoE,
ssm, hybrid, vlm, audio): attention, MLA, mamba, mLSTM, sLSTM, the gated
MLP, the MoE feed-forward and the frontend tokens, and the training of the
dense family (``loss_fn``; ``ce_chunk`` as the reference's).  Training the
other families raises ``NotImplementedError`` naming its ROADMAP.md item;
an unknown family raises ``ValueError``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Optional

import torch

from repro_torch.configs.base import ArchConfig, get_config
from repro_torch.utils.device import resolve_device
from repro_torch.utils.pytree import tensor_from_numpy, tree_map

PyTree = Any

_TRANSFORMER_FAMILIES = ("dense", "moe", "ssm", "hybrid", "vlm", "audio")


@dataclass(frozen=True)
class Model:
    cfg: Any
    arch: ArchConfig
    device: torch.device
    init: Callable                          # (seed) -> params
    loss_fn: Callable                       # (params, batch) -> (loss, metrics)
    trainable_mask: Optional[Callable] = None
    prefill: Optional[Callable] = None      # (params, batch, context_len) -> (logits, cache)
    decode_step: Optional[Callable] = None  # (params, batch, cache, context_len)
    init_cache: Optional[Callable] = None   # (batch, context_len) -> cache

    @property
    def name(self) -> str:
        return self.arch.name


def build_model(arch, *, device=None, ce_chunk: int = 0) -> Model:
    arch_cfg = get_config(arch) if isinstance(arch, str) else arch
    dev = resolve_device(device)

    if arch_cfg.family == "head":
        from repro_torch.configs.mobilenet_head_office31 import HEAD_CONFIG
        from . import headmodel

        cfg = HEAD_CONFIG if not arch_cfg.name.endswith("reduced") else HEAD_CONFIG.reduced()
        return Model(
            cfg=cfg,
            arch=arch_cfg,
            device=dev,
            init=lambda seed=0: headmodel.init_params(cfg, seed=seed, device=dev),
            loss_fn=lambda p, b: headmodel.loss_fn(cfg, p, b),
            trainable_mask=headmodel.trainable_mask,
        )

    if arch_cfg.family == "cnn":
        from repro_torch.configs.resnet18_cifar10 import CNN_CONFIG
        from . import resnet

        cfg = CNN_CONFIG if not arch_cfg.name.endswith("reduced") else CNN_CONFIG.reduced()
        return Model(
            cfg=cfg,
            arch=arch_cfg,
            device=dev,
            init=lambda seed=0: resnet.init_params(cfg, seed, device=dev),
            loss_fn=lambda p, b: resnet.loss_fn(cfg, p, b),
        )

    if arch_cfg.family in _TRANSFORMER_FAMILIES:
        # what a transformer needs is read from its layers: check_ported
        # raises for a plan it cannot build
        from . import transformer as tfm

        cfg = arch_cfg
        tfm.check_ported(cfg)
        return Model(
            cfg=cfg,
            arch=arch_cfg,
            device=dev,
            init=lambda seed=0: tfm.init_params(cfg, seed, device=dev),
            loss_fn=lambda p, b: tfm.loss_fn(cfg, p, b, ce_chunk=ce_chunk),
            prefill=lambda p, b, ctx: tfm.prefill(cfg, p, b, context_len=ctx),
            decode_step=lambda p, b, cache, ctx: tfm.decode_step(
                cfg, p, b, cache, context_len=ctx),
            init_cache=lambda batch, ctx: tfm.init_cache(cfg, batch, ctx, device=dev),
        )

    raise ValueError(f"{arch_cfg.name}: unknown model family {arch_cfg.family!r}")


def params_from_numpy(tree: PyTree, device) -> PyTree:
    """The JAX package's params, given as a nested dict of numpy arrays
    (``jax.tree.map(np.asarray, params)``), as the port's tensors on
    ``device`` — so both packages start from the same draw."""
    return tree_map(lambda a: tensor_from_numpy(a, device), tree)
