"""mixtral-8x22b [moe]: 8 experts top-2, sliding-window attention.
[arXiv:2401.04088; hf]"""

from .base import ArchConfig, AttnConfig, MoEConfig, register

CONFIG = register(
    ArchConfig(
        name="mixtral-8x22b",
        family="moe",
        n_layers=56,
        d_model=6144,
        n_heads=48,
        n_kv_heads=8,
        d_ff=16384,
        vocab=32768,
        moe=MoEConfig(n_experts=8, top_k=2, d_ff=16384),
        attn=AttnConfig(kind="swa", window=4096),
        rope_theta=1000000.0,
        source="arXiv:2401.04088; hf",
    )
)
