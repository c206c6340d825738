"""KV-cache construction, mirroring the stack's layers.

Cache kinds per block:
* attention: k/v rings (full length, or ``window`` slots for SWA);
* MLA: the compressed latent ``ckv`` + shared rope key ``krope`` -- the
  per-token cache is r_kv + d_rope values instead of 2*H*Dh;
* SSD: constant-size conv window + state (the "cache" does not grow with
  context);
* enc-dec decoders additionally get per-layer cross K/V (written once at
  prefill), and ``enc_out`` itself when ``include_enc``.

Every cache carries an int32 ``idx`` (tokens written so far). The JAX
package stacks each slot's cache over its segment's repeats, so its
scalar ``idx`` is broadcast to one int32 per repeat; here the caches are a
list with one entry per layer, each with its own 0-d ``idx``, which is the
same tensors and the same bytes (:func:`cache_bytes` equals the
reference's).
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch

from .._device import resolve_device
from ..configs.base import ArchConfig
from ..models.layers import torch_dtype
from ..models.ssm import ssm_state_shapes
from ..models.transformer import segments

__all__ = ["init_caches", "cache_bytes"]


def _zeros(shape, dtype, device):
    return torch.zeros(shape, dtype=dtype, device=device)


def _idx(device):
    return _zeros((), torch.int32, device)


def _attn_cache(cfg: ArchConfig, batch: int, max_len: int, dtype, device):
    a = cfg.attn
    if a.kind == "mla":
        return {
            "ckv": _zeros((batch, max_len, a.kv_lora_rank), dtype, device),
            "krope": _zeros((batch, max_len, a.rope_head_dim), dtype, device),
            "idx": _idx(device),
        }
    length = min(max_len, a.window) if a.kind == "swa" and a.window else max_len
    kh, dh = cfg.n_kv_heads, cfg.head_dim_
    return {
        "k": _zeros((batch, length, kh, dh), dtype, device),
        "v": _zeros((batch, length, kh, dh), dtype, device),
        "idx": _idx(device),
    }


def _cross_cache(cfg: ArchConfig, batch: int, dtype, device):
    kh, dh = cfg.n_kv_heads, cfg.head_dim_
    n = cfg.n_frontend_tokens
    return {
        "k": _zeros((batch, n, kh, dh), dtype, device),
        "v": _zeros((batch, n, kh, dh), dtype, device),
        "idx": _idx(device),
    }


def _ssm_cache(cfg: ArchConfig, batch: int, dtype, device):
    return {k: _zeros(v, dtype, device) for k, v in ssm_state_shapes(cfg, batch).items()}


def init_caches(
    cfg: ArchConfig,
    batch: int,
    max_len: int,
    dtype: Optional[torch.dtype] = None,
    include_enc: bool = False,
    device=None,
) -> Dict:
    """The decode caches, zero-initialized, on ``device`` (the card unless
    given; ``"meta"`` allocates nothing).

    ``{"stack": [layer caches], "enc_out": ...}``: entry ``i`` of the list
    is the cache of the stack's (decoder's) layer ``i``, a dict with
    ``"mixer"`` and, for enc-dec models, ``"cross"``. ``max_len`` bounds
    the rings in tokens (SWA blocks clamp it to their window).
    ``include_enc=False`` (prefill): the encoder output is not known yet.
    """
    device = resolve_device(device)
    dtype = dtype or torch_dtype(cfg.dtype)
    layers: List[Dict] = []
    for pattern, reps in segments(cfg):
        for _ in range(reps):
            for mixer, _ffn in pattern:
                c: Dict = {}
                if mixer == "attn":
                    c["mixer"] = _attn_cache(cfg, batch, max_len, dtype, device)
                else:
                    c["mixer"] = _ssm_cache(cfg, batch, dtype, device)
                if cfg.enc_dec:
                    c["cross"] = _cross_cache(cfg, batch, dtype, device)
                layers.append(c)
    caches: Dict = {"stack": layers}
    if include_enc:
        caches["enc_out"] = _zeros((batch, cfg.n_frontend_tokens, cfg.d_model), dtype, device)
    return caches


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def cache_bytes(cfg: ArchConfig, batch: int, max_len: int) -> int:
    """Cache footprint in bytes, without allocating anything: the caches
    :func:`init_caches` builds, on the meta device, summed leaf by leaf
    (MLA latents, SWA windows, SSD state, enc-dec cross K/V and
    ``enc_out``, and every layer's int32 ``idx``). The LM codesign decode
    cells bake this number into their constants."""
    caches = init_caches(cfg, batch, max_len, include_enc=cfg.enc_dec, device="meta")
    return sum(t.numel() * t.element_size() for t in _leaves(caches))
