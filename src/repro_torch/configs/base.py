"""Architecture + run configuration system.

Every architecture the port runs gets one ``src/repro_torch/configs/<id>.py``
exporting a ``CONFIG: ArchConfig``; the registry maps its name to it.
Configs are plain frozen dataclasses, derivable from the published model
cards cited in each file.  The port carries the fields of the families it
runs; the attention, MoE and SSM fields and the layer plan come with the
transformer family (ROADMAP.md queue 1 item 15).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Literal

Family = Literal["dense", "moe", "ssm", "hybrid", "vlm", "audio", "cnn", "head"]


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: Family
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    source: str = ""                   # citation bracket from the assignment

    def reduced(self, *, n_layers: int = 2, d_model: int = 128) -> "ArchConfig":
        """Tiny same-family variant for CPU smoke tests (spec: <=512 d_model,
        2 layers)."""
        n_heads = max(2, min(4, d_model // 32))
        return dataclasses.replace(
            self,
            name=self.name + "-reduced",
            n_layers=n_layers,
            d_model=d_model,
            n_heads=n_heads,
            n_kv_heads=1 if self.n_kv_heads < self.n_heads else n_heads,
            d_ff=d_model * 2,
            vocab_size=min(self.vocab_size, 512),
        )


# ---------------- registry ----------------
_REGISTRY: dict[str, ArchConfig] = {}


def register(cfg: ArchConfig) -> ArchConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ArchConfig:
    _ensure_loaded()
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name]


# the port carries the configs of the model families it runs (ROADMAP.md
# queue 1 items 14-15 add the CNN and transformer configs)
_ARCH_MODULES = (
    "mobilenet_head_office31",
)

_loaded = False


def _ensure_loaded() -> None:
    global _loaded
    if _loaded:
        return
    import importlib

    for mod in _ARCH_MODULES:
        importlib.import_module(f"repro_torch.configs.{mod}")
    _loaded = True
