"""Granite 8B Code [arXiv:2405.04324].

36L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=49152.  Llama-style
architecture (RMSNorm, SwiGLU, RoPE).
"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(
    ArchConfig(
        name="granite-8b",
        family="dense",
        n_layers=36,
        d_model=4096,
        n_heads=32,
        n_kv_heads=8,
        d_ff=14336,
        vocab_size=49152,
        rope_theta=10_000_000.0,
        tie_embeddings=False,
        execution_mode="fsdp",
        source="[arXiv:2405.04324]",
    )
)
