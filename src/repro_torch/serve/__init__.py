"""Serving substrate: KV caches (MLA latents, SWA rings, SSM states),
prefill/decode steps, batched greedy generation."""

from .kvcache import cache_bytes, init_caches  # noqa: F401
from .serve_step import generate, generate_timed, greedy, make_decode_step, make_prefill  # noqa: F401
