"""Architecture + run configuration system.

Every architecture the port runs gets one ``src/repro_torch/configs/<id>.py``
exporting a ``CONFIG: ArchConfig``; the registry maps its name to it.
Configs are plain frozen dataclasses, derivable from the published model
cards cited in each file.  ``ArchConfig`` and its sub-configs are field for
field the JAX package's (``repro/configs/base.py``), so a config and its
``reduced()`` variant mean the same model in both packages.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Literal, Optional

Family = Literal["dense", "moe", "ssm", "hybrid", "vlm", "audio", "cnn", "head"]
LayerKind = Literal["attn", "mamba", "slstm", "mlstm"]


@dataclass(frozen=True)
class MLAConfig:
    """Multi-head Latent Attention (DeepSeek-V2 / MiniCPM3 style)."""

    q_lora_rank: int = 768
    kv_lora_rank: int = 256
    qk_nope_head_dim: int = 64
    qk_rope_head_dim: int = 32
    v_head_dim: int = 64


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int = 8
    top_k: int = 2
    n_shared_experts: int = 0          # DeepSeekMoE fine-grained shared experts
    d_expert: int = 0                  # per-expert FFN hidden dim (0 -> use d_ff)
    layer_period: int = 1              # MoE every `period` layers ...
    layer_offset: int = 0              # ... starting at this layer index
    router_aux_coef: float = 0.01      # load-balance loss weight
    router_z_coef: float = 1e-3


@dataclass(frozen=True)
class SSMConfig:
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    dt_rank: int = 0                   # 0 -> ceil(d_model/16)


@dataclass(frozen=True)
class LayerSpec:
    kind: LayerKind
    moe: bool = False


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
    head_dim: int = 0                  # 0 -> d_model // n_heads
    # attention flavour
    sliding_window: Optional[int] = None   # tokens; None = full attention
    qk_norm: bool = False
    rope_theta: float = 10_000.0
    mla: Optional[MLAConfig] = None
    # mixture-of-experts
    moe: Optional[MoEConfig] = None
    # state-space / recurrent
    ssm: Optional[SSMConfig] = None
    attn_layer_period: int = 1         # hybrid: attention every Nth layer...
    attn_layer_offset: int = 0         # ...at this offset; others are `alt_kind`
    alt_kind: LayerKind = "mamba"
    xlstm_slstm_every: int = 0         # xLSTM: sLSTM every Nth block (rest mLSTM)
    # embeddings / head
    tie_embeddings: bool = True
    norm: Literal["rmsnorm", "layernorm"] = "rmsnorm"
    act: Literal["silu", "gelu"] = "silu"
    # modality frontend stub: non-text archs consume precomputed embeddings
    modality: Literal["text", "vision_stub", "audio_stub"] = "text"
    frontend_tokens: int = 0           # prefix embedding tokens (vlm patches)
    frontend_dim: int = 0              # raw frontend embedding width (0 -> d_model)
    # FL / distribution behaviour
    execution_mode: Literal["parallel", "sequential", "fsdp"] = "parallel"
    microbatches: int = 1              # grad-accumulation slices per local step
    remat: bool = True
    scan_layers: bool = True
    dtype: str = "bfloat16"
    # long-context: archs whose reference model is full-attention run
    # contexts above 65,536 tokens on a ring cache of this window
    long_context_window: int = 4096
    source: str = ""                   # citation bracket from the assignment

    # ---------------- derived ----------------
    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    def layer_plan(self) -> tuple[LayerSpec, ...]:
        """Per-layer (kind, moe?) plan for the whole stack."""
        plan = []
        for i in range(self.n_layers):
            if self.family in ("ssm",) and self.xlstm_slstm_every:
                kind: LayerKind = (
                    "slstm" if i % self.xlstm_slstm_every == 0 else "mlstm"
                )
            elif self.attn_layer_period > 1:
                kind = (
                    "attn"
                    if i % self.attn_layer_period == self.attn_layer_offset
                    else self.alt_kind
                )
            elif self.family == "ssm":
                kind = self.alt_kind
            else:
                kind = "attn"
            is_moe = False
            if self.moe is not None:
                is_moe = i % self.moe.layer_period == self.moe.layer_offset
            plan.append(LayerSpec(kind=kind, moe=is_moe))
        return tuple(plan)

    @property
    def plan_period(self) -> int:
        """Smallest repeating period of the layer plan (for scan-over-period)."""
        plan = self.layer_plan()
        for p in range(1, self.n_layers + 1):
            if self.n_layers % p == 0 and all(
                plan[i] == plan[i % p] for i in range(self.n_layers)
            ):
                return p
        return self.n_layers

    def reduced(self, *, n_layers: int = 2, d_model: int = 128) -> "ArchConfig":
        """Tiny same-family variant for CPU smoke tests (spec: <=512 d_model,
        2 layers, <=4 experts)."""
        head_dim = 32
        n_heads = max(2, min(4, d_model // head_dim))
        n_kv = 1 if self.n_kv_heads < self.n_heads else n_heads
        kw: dict = dict(
            name=self.name + "-reduced",
            n_layers=n_layers,
            d_model=d_model,
            n_heads=n_heads,
            n_kv_heads=n_kv,
            head_dim=head_dim,
            d_ff=d_model * 2,
            vocab_size=min(self.vocab_size, 512),
            frontend_tokens=min(self.frontend_tokens, 16),
            execution_mode="parallel",
            scan_layers=False,
            remat=False,
            sliding_window=min(self.sliding_window, 64) if self.sliding_window else None,
            long_context_window=64,
        )
        if self.moe is not None:
            kw["moe"] = dataclasses.replace(
                self.moe,
                n_experts=min(self.moe.n_experts, 4),
                top_k=min(self.moe.top_k, 2),
                n_shared_experts=min(self.moe.n_shared_experts, 1),
                d_expert=d_model if self.moe.d_expert else 0,
            )
        if self.ssm is not None:
            kw["ssm"] = dataclasses.replace(self.ssm, d_state=8)
        if self.mla is not None:
            kw["mla"] = MLAConfig(
                q_lora_rank=64, kv_lora_rank=32, qk_nope_head_dim=16,
                qk_rope_head_dim=16, v_head_dim=32,
            )
        # keep hybrid structure visible even at 2 layers
        if self.attn_layer_period > 1:
            kw["attn_layer_period"] = 2
            kw["attn_layer_offset"] = min(self.attn_layer_offset, 1)
        return dataclasses.replace(self, **kw)


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


# the port carries the configs of every model the JAX package runs
_ARCH_MODULES = (
    "deepseek_moe_16b",
    "granite_8b",
    "jamba_1_5_large_398b",
    "minicpm3_4b",
    "mixtral_8x7b",
    "mobilenet_head_office31",
    "musicgen_medium",
    "paligemma_3b",
    "qwen3_0_6b",
    "resnet18_cifar10",
    "stablelm_3b",
    "xlstm_1_3b",
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
