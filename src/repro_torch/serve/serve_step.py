"""Serving steps: prefill, one decode step, greedy selection and a batched
generation loop -- the JAX package's ``serve/serve_step.py``.

The reference jits each step and donates the caches to decode. Here each
step is a plain eager function under ``torch.inference_mode()``: no jit,
no CUDA graph, no ``torch.compile``. Decode updates the caches in place
(the port's counterpart of donation) and returns them. There is no
``mesh`` argument: sharding is not ported yet.
"""

from __future__ import annotations

import time
from typing import Dict, List

import torch

from .._device import resolve_device
from ..configs.base import ArchConfig
from ..models.layers import torch_dtype
from ..models.model import Model, _head, forward, forward_hidden
from .kvcache import init_caches

__all__ = ["make_prefill", "make_decode_step", "greedy", "generate", "generate_timed"]


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def make_prefill(cfg: ArchConfig, max_len: int = 0, impl: str = "auto", device=None):
    """``(params, batch) -> (last-position logits (B, V), caches)``.
    ``max_len`` is the cache capacity (>= prompt + generation length); the
    caches are built on ``device`` (the card unless given), where the
    model and the batch must lie."""
    device = resolve_device(device)

    @torch.inference_mode()
    def prefill(params: Model, batch: Dict):
        b, s = batch["tokens"].shape
        caches = init_caches(cfg, b, max_len or s, dtype=torch_dtype(cfg.dtype), device=device)
        hidden, caches, _ = forward_hidden(params, cfg, batch, caches=caches, impl=impl)
        # head on the last position only: prefill never needs S x V logits
        logits = _head(cfg, params, hidden[:, -1:])
        return logits[:, 0], caches

    return prefill


def make_decode_step(cfg: ArchConfig, impl: str = "auto"):
    """``(params, tokens (B, 1), caches, cache_index) -> (logits (B, V),
    caches)``; the caches are updated in place and returned."""

    @torch.inference_mode()
    def decode(params: Model, tokens: torch.Tensor, caches: Dict, cache_index):
        batch = {"tokens": tokens, "cache_index": cache_index}
        logits, caches, _ = forward(params, cfg, batch, caches=caches, impl=impl)
        return logits[:, -1], caches

    return decode


def greedy(logits: torch.Tensor) -> torch.Tensor:
    """argmax over the vocabulary, int32; the first maximum on a tie."""
    return torch.argmax(logits, dim=-1).to(torch.int32)


def generate_timed(
    params: Model,
    cfg: ArchConfig,
    batch: Dict,
    steps: int,
    impl: str = "auto",
    device=None,
) -> Dict:
    """Prefill the prompt batch, then greedy-decode ``steps`` tokens,
    keeping what a caller measures: ``{"tokens" (B, steps) int32,
    "prefill_logits" (B, V), "logits" [(B, V) per decode step], "caches"
    (after the last step), "prefill_s", "decode_s" [per decode step]}``.
    Each clock is the host's, stopped once the device has finished the
    step. Vision models reserve ``n_frontend_tokens`` more cache slots for
    the prepended patches."""
    device = resolve_device(device)
    b, s = batch["tokens"].shape
    extra = cfg.n_frontend_tokens if cfg.frontend == "vision" else 0
    prefill = make_prefill(cfg, max_len=s + steps + extra, impl=impl, device=device)
    decode = make_decode_step(cfg, impl=impl)
    _sync(device)
    t0 = time.perf_counter()
    logits, caches = prefill(params, batch)
    tok = greedy(logits)
    _sync(device)
    out = {"prefill_s": time.perf_counter() - t0, "prefill_logits": logits,
           "decode_s": [], "logits": []}
    toks: List[torch.Tensor] = [tok]
    for pos in range(s, s + steps - 1):
        t0 = time.perf_counter()
        logits, caches = decode(params, tok[:, None], caches, pos)
        tok = greedy(logits)
        _sync(device)
        out["decode_s"].append(time.perf_counter() - t0)
        out["logits"].append(logits)
        toks.append(tok)
    out["tokens"], out["caches"] = torch.stack(toks, dim=1), caches
    return out


def generate(
    params: Model,
    cfg: ArchConfig,
    batch: Dict,
    steps: int,
    impl: str = "auto",
    device=None,
) -> torch.Tensor:
    """Prefill the prompt batch, then greedy-decode ``steps`` tokens.
    Returns (B, steps) generated ids: :func:`generate_timed`'s tokens."""
    return generate_timed(params, cfg, batch, steps, impl=impl, device=device)["tokens"]
