"""whisper-medium [audio]: encoder-decoder, conv frontend STUB (input_specs
provides precomputed frame embeddings). [arXiv:2212.04356; unverified]"""

from .base import ArchConfig, register

CONFIG = register(
    ArchConfig(
        name="whisper-medium",
        family="audio",
        n_layers=24,  # decoder layers
        n_enc_layers=24,
        enc_dec=True,
        d_model=1024,
        n_heads=16,
        n_kv_heads=16,
        d_ff=4096,
        vocab=51865,
        rope="learned",  # whisper uses absolute positions
        frontend="audio",
        n_frontend_tokens=1500,  # 30 s of mel frames after conv subsampling
        source="arXiv:2212.04356; unverified",
    )
)
