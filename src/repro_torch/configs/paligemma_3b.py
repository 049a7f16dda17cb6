"""PaliGemma 3B [arXiv:2407.07726] — Gemma-2B language backbone.

18L d_model=2048 8H (GQA kv=1: MQA) d_ff=16384 vocab=257216.  The SigLIP
vision tower + projector is the frozen *Base Model* in the paper's §4.1
head/base split: ``input_specs()`` supplies 256 precomputed patch embeddings
(224px / 14px patches = 16x16) prepended to the token stream; FL trains the
language decoder (the head).
"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(
    ArchConfig(
        name="paligemma-3b",
        family="vlm",
        n_layers=18,
        d_model=2048,
        n_heads=8,
        n_kv_heads=1,
        head_dim=256,
        d_ff=16384,
        vocab_size=257216,
        act="gelu",
        tie_embeddings=True,
        modality="vision_stub",
        frontend_tokens=256,
        frontend_dim=1152,
        execution_mode="fsdp",  # 257k-vocab CE + patch frontend: per-client replica too fat
        source="[arXiv:2407.07726]",
    )
)
