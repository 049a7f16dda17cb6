"""xLSTM 1.3B [arXiv:2405.04517].

48L d_model=2048 4H d_ff=0 (xLSTM blocks carry their own up-projection; no
separate FFN) vocab=50304.  xLSTM[7:1]: one sLSTM block per 8 blocks, the
rest mLSTM (matrix-memory, fully parallelizable).  Recurrent state makes
long_500k decode native.
"""
from repro_torch.configs.base import ArchConfig, SSMConfig, register

CONFIG = register(
    ArchConfig(
        name="xlstm-1.3b",
        family="ssm",
        n_layers=48,
        d_model=2048,
        n_heads=4,
        n_kv_heads=4,
        head_dim=512,
        d_ff=0,
        vocab_size=50304,
        xlstm_slstm_every=8,   # blocks 0,8,16,... are sLSTM; rest mLSTM
        alt_kind="mlstm",
        ssm=SSMConfig(),       # unused by xLSTM blocks but keeps family tooling uniform
        tie_embeddings=False,
        execution_mode="fsdp",
        source="[arXiv:2405.04517]",
    )
)
