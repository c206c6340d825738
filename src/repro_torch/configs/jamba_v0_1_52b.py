"""jamba-v0.1-52b [hybrid]: Mamba+attention 1:7 interleave, MoE 16e top-2
every other layer. [arXiv:2403.19887; hf]"""

from .base import ArchConfig, MoEConfig, SSMConfig, register

CONFIG = register(
    ArchConfig(
        name="jamba-v0.1-52b",
        family="hybrid",
        n_layers=32,
        d_model=4096,
        n_heads=32,
        n_kv_heads=8,
        d_ff=14336,
        vocab=65536,
        moe=MoEConfig(n_experts=16, top_k=2, d_ff=14336, every=2),
        ssm=SSMConfig(d_state=16, d_conv=4, expand=2, head_dim=64, chunk=256),
        layer_pattern="jamba",
        attn_every=8,  # 1 attention : 7 mamba (4 attn layers in 32)
        source="arXiv:2403.19887; hf",
    )
)
