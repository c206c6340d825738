"""Optimizer substrate: AdamW + schedules + gradient compression."""

from .adamw import AdamWConfig, adamw_init, adamw_update, global_norm, lr_at  # noqa: F401
from .compression import (  # noqa: F401
    CompressionState,
    compress_grads,
    compressed_psum,
    compression_init,
    dequantize_int8,
    quantize_int8,
)
