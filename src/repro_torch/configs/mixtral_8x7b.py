"""Mixtral 8x7B [arXiv:2401.04088].

32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=32000, 8 experts top-2,
sliding-window attention (4096).  46.7B total / ~12.9B active params:
93.41 GB in bf16, more than one H100 80GB holds, so a single card serves a
depth cut (16 layers: 23,482,470,400 params, 46.97 GB).  Fields as the JAX
package's config.
"""
from repro_torch.configs.base import ArchConfig, MoEConfig, register

CONFIG = register(
    ArchConfig(
        name="mixtral-8x7b",
        family="moe",
        n_layers=32,
        d_model=4096,
        n_heads=32,
        n_kv_heads=8,
        head_dim=128,
        d_ff=14336,
        vocab_size=32000,
        sliding_window=4096,
        rope_theta=1e6,
        moe=MoEConfig(n_experts=8, top_k=2),
        tie_embeddings=False,
        execution_mode="fsdp",
        source="[arXiv:2401.04088]",
    )
)
