"""MiniCPM3 4B [hf:openbmb/MiniCPM3-4B].

62L d_model=2560 40H d_ff=6400 vocab=73448.  Multi-head Latent Attention
(MLA): queries/keys/values are produced from low-rank latents
(q_lora_rank=768, kv_lora_rank=256) with a nope/rope head-dim split — the KV
cache stores the compressed latent, not per-head KV.
"""
from repro_torch.configs.base import ArchConfig, MLAConfig, register

CONFIG = register(
    ArchConfig(
        name="minicpm3-4b",
        family="dense",
        n_layers=62,
        d_model=2560,
        n_heads=40,
        n_kv_heads=40,
        d_ff=6400,
        vocab_size=73448,
        mla=MLAConfig(
            q_lora_rank=768,
            kv_lora_rank=256,
            qk_nope_head_dim=64,
            qk_rope_head_dim=32,
            v_head_dim=64,
        ),
        tie_embeddings=True,
        execution_mode="fsdp",
        source="[hf:openbmb/MiniCPM3-4B]",
    )
)
