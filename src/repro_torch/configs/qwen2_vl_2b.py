"""qwen2-vl-2b [vlm]: M-RoPE, dynamic-resolution vision frontend STUB
(input_specs provides patch embeddings). [arXiv:2409.12191; hf]"""

from .base import ArchConfig, register

CONFIG = register(
    ArchConfig(
        name="qwen2-vl-2b",
        family="vlm",
        n_layers=28,
        d_model=1536,
        n_heads=12,
        n_kv_heads=2,
        d_ff=8960,
        vocab=151936,
        rope="mrope",
        mrope_sections=(16, 24, 24),  # temporal/height/width rope sections
        rope_theta=1000000.0,
        frontend="vision",
        n_frontend_tokens=256,  # stub patch-embedding count
        tie_embeddings=True,
        source="arXiv:2409.12191; hf",
    )
)
