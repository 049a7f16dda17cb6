"""Jamba 1.5 Large (398B) [arXiv:2403.19887 / Jamba-1.5 report].

72L d_model=8192 64H (GQA kv=8) d_ff=24576 vocab=65536.  Hybrid Mamba +
attention with a 1:7 attention:mamba interleave (one attention layer per
8-layer period) and MoE (16 experts, top-2) on every other layer.

398B total params: client-sequential FL (one client occupies the whole mesh;
experts sharded over `data`, tensor-parallel over `model`).  Long-context
decode is native (Mamba recurrent state + few attention layers w/ window).
"""
from repro_torch.configs.base import ArchConfig, MoEConfig, SSMConfig, register

CONFIG = register(
    ArchConfig(
        name="jamba-1.5-large-398b",
        family="hybrid",
        n_layers=72,
        d_model=8192,
        n_heads=64,
        n_kv_heads=8,
        head_dim=128,
        d_ff=24576,
        vocab_size=65536,
        moe=MoEConfig(n_experts=16, top_k=2, layer_period=2, layer_offset=1),
        ssm=SSMConfig(d_state=16, d_conv=4, expand=2),
        attn_layer_period=8,   # 1 attention : 7 mamba
        attn_layer_offset=4,
        alt_kind="mamba",
        tie_embeddings=False,
        execution_mode="sequential",
        microbatches=16,   # 398B: activation memory / 8 via grad accumulation
        source="[arXiv:2403.19887]",
    )
)
