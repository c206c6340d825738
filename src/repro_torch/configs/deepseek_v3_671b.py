"""deepseek-v3-671b [moe]: MLA, 1 shared + 256 routed top-8, first 3 layers
dense, MTP. [arXiv:2412.19437; hf]"""

from .base import ArchConfig, AttnConfig, MoEConfig, register

CONFIG = register(
    ArchConfig(
        name="deepseek-v3-671b",
        family="moe",
        n_layers=61,
        d_model=7168,
        n_heads=128,
        n_kv_heads=128,  # MLA: per-head K/V reconstructed from the latent
        head_dim=128,  # nope head dim; +64 rope dims (attn config)
        d_ff=18432,  # dense-layer MLP hidden (first_dense layers)
        vocab=129280,
        moe=MoEConfig(
            n_experts=256,
            top_k=8,
            d_ff=2048,
            n_shared=1,
            first_dense=3,
        ),
        attn=AttnConfig(
            kind="mla",
            q_lora_rank=1536,
            kv_lora_rank=512,
            rope_head_dim=64,
            v_head_dim=128,
        ),
        mtp=True,
        source="arXiv:2412.19437; hf",
    )
)
