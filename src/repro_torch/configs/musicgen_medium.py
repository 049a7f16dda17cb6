"""MusicGen Medium [arXiv:2306.05284] — decoder backbone.

48L d_model=1536 24H (MHA kv=24) d_ff=6144 vocab=2048 (EnCodec codebook).
Decoder-only transformer over EnCodec audio tokens.  The EnCodec tokenizer /
conditioning encoder is the frozen modality frontend: ``input_specs()``
supplies a 64-token conditioning-embedding prefix (T5-style) + codec token
ids; FL trains the decoder.
"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(
    ArchConfig(
        name="musicgen-medium",
        family="audio",
        n_layers=48,
        d_model=1536,
        n_heads=24,
        n_kv_heads=24,
        d_ff=6144,
        vocab_size=2048,
        norm="layernorm",
        act="gelu",
        tie_embeddings=False,
        modality="audio_stub",
        frontend_tokens=64,
        frontend_dim=768,
        execution_mode="fsdp",
        source="[arXiv:2306.05284]",
    )
)
