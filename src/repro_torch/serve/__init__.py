"""Serving-side state of the LM architectures: the decode caches."""

from .kvcache import cache_bytes, init_caches  # noqa: F401
