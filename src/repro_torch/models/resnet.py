"""ResNet-18 in PyTorch — the paper's Jetson-TX2 FL workload (§5), the
twin of ``repro.models.resnet``.

GroupNorm replaces BatchNorm: FedAvg over divergent client BN statistics
is a known failure mode.  CIFAR stem (3x3, no max-pool).  Params keep the
reference's layout, conv weights HWIO and activations NHWC, so flat
vectors, codec deltas, TopK indices and ``Parameters`` bytes line up with
the JAX package's element for element; only the conv itself permutes to
PyTorch's NCHW / OIHW.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.utils.device import resolve_device
from repro_torch.utils.pytree import tree_map

from .layers.norms import groupnorm


def _conv_init(g: torch.Generator, shape) -> torch.Tensor:  # HWIO, He-normal
    fan_in = shape[0] * shape[1] * shape[2]
    return torch.randn(*shape, generator=g, dtype=torch.float32) * math.sqrt(2.0 / fan_in)


def _same_pads(n: int, k: int, s: int) -> tuple[int, int]:
    """XLA's "SAME" padding of one spatial dim: (low, high).  At stride 2
    on an even size the 3x3 conv pads (0, 1), not PyTorch's symmetric
    (1, 1)."""
    total = max((-(-n // s) - 1) * s + k - n, 0)
    return total // 2, total - total // 2


def conv2d(x: torch.Tensor, w: torch.Tensor, stride: int = 1) -> torch.Tensor:
    """``lax.conv_general_dilated(x, w, (s, s), "SAME")`` with NHWC x and
    HWIO w; the result NHWC."""
    (top, bottom), (left, right) = (_same_pads(x.shape[1], w.shape[0], stride),
                                    _same_pads(x.shape[2], w.shape[1], stride))
    xc = x.permute(0, 3, 1, 2)
    if (bottom, right) != (top, left):
        xc = F.pad(xc, (0, right - left, 0, bottom - top))
    y = F.conv2d(xc, w.permute(3, 2, 0, 1), stride=stride, padding=(top, left))
    return y.permute(0, 2, 3, 1)


def _init_norm(c: int) -> dict:
    return {"scale": torch.ones(c, dtype=torch.float32),
            "bias": torch.zeros(c, dtype=torch.float32)}


def _init_block(g: torch.Generator, cin: int, cout: int, stride: int) -> dict:
    p = {
        "conv1": _conv_init(g, (3, 3, cin, cout)),
        "n1": _init_norm(cout),
        "conv2": _conv_init(g, (3, 3, cout, cout)),
        "n2": _init_norm(cout),
    }
    if stride != 1 or cin != cout:
        p["proj"] = _conv_init(g, (1, 1, cin, cout))
        p["proj_n"] = _init_norm(cout)
    return p


def _block(p: dict, x: torch.Tensor, stride: int, groups: int = 8) -> torch.Tensor:
    h = conv2d(x, p["conv1"], stride)
    h = torch.relu(groupnorm(h, p["n1"]["scale"], p["n1"]["bias"], groups))
    h = conv2d(h, p["conv2"])
    h = groupnorm(h, p["n2"]["scale"], p["n2"]["bias"], groups)
    if "proj" in p:
        x = conv2d(x, p["proj"], stride)
        x = groupnorm(x, p["proj_n"]["scale"], p["proj_n"]["bias"], groups)
    return torch.relu(x + h)


def _stride(si: int, bi: int) -> int:
    return 2 if (si > 0 and bi == 0) else 1


def init_params(cfg, seed: int = 0, *, device=None) -> dict:
    """Seeded He-normal params on ``device`` (None: the card), in the
    reference's tree: ``stem``, ``stem_n``, ``stages`` (a list of lists of
    block dicts), ``fc_w``, ``fc_b``.  Torch's generator draws other
    numbers than ``jax.random``; parity tests start both packages from the
    JAX init via ``repro_torch.models.params_from_numpy``."""
    device = resolve_device(device)
    g = torch.Generator().manual_seed(seed)
    w0, wl = cfg.stage_widths[0], cfg.stage_widths[-1]
    params = {
        "stem": _conv_init(g, (3, 3, cfg.channels, w0)),
        "stem_n": _init_norm(w0),
        "stages": [],
        "fc_w": torch.randn(wl, cfg.num_classes, generator=g, dtype=torch.float32)
        / math.sqrt(wl),
        "fc_b": torch.zeros(cfg.num_classes, dtype=torch.float32),
    }
    cin = w0
    for si, (n, cout) in enumerate(zip(cfg.stage_sizes, cfg.stage_widths)):
        stage = []
        for bi in range(n):
            stage.append(_init_block(g, cin, cout, _stride(si, bi)))
            cin = cout
        params["stages"].append(stage)
    return tree_map(lambda t: t.to(device), params)


def forward(cfg, params: dict, x: torch.Tensor) -> torch.Tensor:
    """x: (N, H, W, C) -> logits (N, classes)."""
    h = conv2d(x, params["stem"])
    h = torch.relu(groupnorm(h, params["stem_n"]["scale"], params["stem_n"]["bias"]))
    for si, stage in enumerate(params["stages"]):
        for bi, bp in enumerate(stage):
            h = _block(bp, h, _stride(si, bi))
    h = torch.mean(h, dim=(1, 2))
    return h @ params["fc_w"] + params["fc_b"]


def loss_fn(cfg, params: dict, batch: dict):
    logits = forward(cfg, params, batch["x"])
    labels = batch["y"].long()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[:, None])[:, 0]
    loss = torch.mean(logz - gold)
    acc = torch.mean((torch.argmax(logits, -1) == labels).to(torch.float32))
    return loss, {"ce": loss, "acc": acc}
