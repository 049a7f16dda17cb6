"""StableLM 3B [hf:stabilityai/stablelm-2-1_6b family, 3B config].

32L d_model=2560 32H (MHA: kv=32) d_ff=6912 vocab=50304.  LayerNorm + rotary
(partial in the reference; full here), SiLU-gated MLP.
"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(
    ArchConfig(
        name="stablelm-3b",
        family="dense",
        n_layers=32,
        d_model=2560,
        n_heads=32,
        n_kv_heads=32,
        d_ff=6912,
        vocab_size=50304,
        norm="layernorm",
        tie_embeddings=False,
        execution_mode="fsdp",
        source="[hf:stabilityai/stablelm-2-1_6b]",
    )
)
