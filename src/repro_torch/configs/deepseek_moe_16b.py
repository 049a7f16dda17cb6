"""DeepSeekMoE 16B [arXiv:2401.06066].

28L d_model=2048 16H (MHA kv=16) d_ff=1408 (per-expert) vocab=102400.
Fine-grained MoE: 2 shared + 64 routed experts, top-6 routing.  (The
reference model keeps layer 0 dense; here every layer is MoE, as in the
JAX package's config, whose fields this copy keeps one for one.)
16,879,568,896 parameters: 33.77 GB in bf16, one H100 80GB at full width.
"""
from repro_torch.configs.base import ArchConfig, MoEConfig, register

CONFIG = register(
    ArchConfig(
        name="deepseek-moe-16b",
        family="moe",
        n_layers=28,
        d_model=2048,
        n_heads=16,
        n_kv_heads=16,
        d_ff=1408,
        vocab_size=102400,
        moe=MoEConfig(
            n_experts=64,
            top_k=6,
            n_shared_experts=2,
            d_expert=1408,
        ),
        tie_embeddings=False,
        execution_mode="fsdp",
        source="[arXiv:2401.06066]",
    )
)
