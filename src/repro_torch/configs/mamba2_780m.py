"""mamba2-780m [ssm]: attention-free, SSD (state-space duality).
[arXiv:2405.21060; unverified]"""

from .base import ArchConfig, SSMConfig, register

CONFIG = register(
    ArchConfig(
        name="mamba2-780m",
        family="ssm",
        n_layers=48,
        d_model=1536,
        n_heads=0,  # attention-free
        n_kv_heads=0,
        d_ff=0,  # no separate MLP: the mamba block is the whole layer
        vocab=50280,
        ssm=SSMConfig(d_state=128, d_conv=4, expand=2, head_dim=64, chunk=256),
        tie_embeddings=True,
        source="arXiv:2405.21060; unverified",
    )
)
