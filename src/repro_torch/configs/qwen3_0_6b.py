"""Qwen3 0.6B [hf:Qwen/Qwen3-8B family, 0.6B config].

28L d_model=1024 16H (GQA kv=8) d_ff=3072 vocab=151936.  Distinctive: QK-RMS
norm on per-head queries/keys, explicit head_dim=128 (> d_model/n_heads).
"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(
    ArchConfig(
        name="qwen3-0.6b",
        family="dense",
        n_layers=28,
        d_model=1024,
        n_heads=16,
        n_kv_heads=8,
        head_dim=128,
        d_ff=3072,
        vocab_size=151936,
        qk_norm=True,
        rope_theta=1e6,
        tie_embeddings=True,
        source="[hf:Qwen/Qwen3-8B]",
    )
)
