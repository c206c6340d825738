"""Serving steps: prefill, one decode step, greedy selection and a batched
generation loop -- the JAX package's ``serve/serve_step.py``.

The reference jits each step and donates the caches to decode. Here each
step is a plain eager function under ``torch.inference_mode()``
(``no_grad`` on a mesh, see :func:`_no_autograd`): no jit, no CUDA graph,
no ``torch.compile``. Decode updates the caches in place (the port's
counterpart of donation) and returns them.

With ``mesh=`` (a ``DeviceMesh``) the steps serve a model whose
parameters are DTensors placed by ``param_specs``
(:func:`repro_torch.sharding.dtensor.distribute_model`; ``generate_timed``
places a plain model itself): prefill places the batch by
``batch_specs`` and builds the caches placed by ``cache_specs`` -- the
batch over the data axes, kv heads over ``model``, and the cache length
over the data axes when the batch cannot shard (the long-context
fallback) --, decode writes them in place, shard by shard, with no read
back to the host. The plain tensors the model makes (positions, masks)
count as replicated, and the logits come back as full plain tensors on
every rank.
"""

from __future__ import annotations

import time
from typing import Dict, List

import torch
from torch.distributed.tensor import DTensor

from .._device import resolve_device
from ..configs.base import ArchConfig
from ..models.layers import torch_dtype
from ..models.model import Model, _head, forward, forward_hidden
from ..obs.trace import layer_span
from ..sharding.dtensor import (
    check_placed,
    distribute_batch,
    distribute_caches,
    distribute_model,
    full,
    mesh_device,
    replicating,
)
from .kvcache import init_caches

__all__ = ["make_prefill", "make_decode_step", "greedy", "generate", "generate_timed"]


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _no_autograd(mesh):
    """``inference_mode``; on a mesh ``no_grad``, because a DTensor view of
    an inference tensor cannot take the version counter DTensor gives it
    (the SSM's shifted cache slices)."""
    return torch.no_grad() if mesh is not None else torch.inference_mode()


def make_prefill(cfg: ArchConfig, max_len: int = 0, impl: str = "auto", device=None, mesh=None):
    """``(params, batch) -> (last-position logits (B, V), caches)``.
    ``max_len`` is the cache capacity (>= prompt + generation length); the
    caches are built on ``device`` (the card unless given), where the
    model and the batch must lie, or on ``mesh``, placed by
    ``cache_specs`` (the model placed by ``param_specs`` already)."""
    device = mesh_device(mesh) if mesh is not None else resolve_device(device)

    @_no_autograd(mesh)
    def prefill(params: Model, batch: Dict):
        b, s = batch["tokens"].shape
        _check(params, mesh)
        # on a mesh each rank allocates its own shards only
        caches = init_caches(cfg, b, max_len or s, dtype=torch_dtype(cfg.dtype),
                             device=device if mesh is None else "meta")
        caches = distribute_caches(cfg, caches, mesh, batch_size=b)
        with replicating(mesh):
            hidden, caches, _ = forward_hidden(params, cfg, distribute_batch(cfg, batch, mesh),
                                               caches=caches, impl=impl)
            # head on the last position only: prefill never needs S x V logits
            logits = _head(cfg, params, hidden[:, -1:])[:, 0]
        return full(logits), caches

    return prefill


def make_decode_step(cfg: ArchConfig, impl: str = "auto", mesh=None):
    """``(params, tokens (B, 1), caches, cache_index) -> (logits (B, V),
    caches)``; the caches are updated in place and returned. With
    ``mesh``: the model and the caches are prefill's on that mesh."""

    @_no_autograd(mesh)
    def decode(params: Model, tokens: torch.Tensor, caches: Dict, cache_index):
        _check(params, mesh)
        batch = distribute_batch(cfg, {"tokens": tokens}, mesh)
        batch["cache_index"] = cache_index
        with replicating(mesh):
            logits, caches, _ = forward(params, cfg, batch, caches=caches, impl=impl)
            logits = logits[:, -1]
        return full(logits), caches

    return decode


def _check(params: Model, mesh) -> None:
    if mesh is not None:
        check_placed([params.embed], mesh)


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
    mesh=None,
) -> Dict:
    """Prefill the prompt batch, then greedy-decode ``steps`` tokens,
    keeping what a caller measures: ``{"tokens" (B, steps) int32,
    "prefill_logits" (B, V), "logits" [(B, V) per decode step], "caches"
    (after the last step), "prefill_s", "decode_s" [per decode step]}``.
    Each clock is the host's, stopped once the device has finished the
    step. Under ``torch.profiler`` each decode step is the layer span
    ``serve.decode`` (:func:`repro_torch.obs.trace.layer_span`). Vision
    models reserve ``n_frontend_tokens`` more cache slots for the
    prepended patches. With ``mesh``, a plain model is first placed on it
    by ``param_specs`` (in place) and the steps serve on the mesh."""
    if mesh is not None:
        device = mesh_device(mesh)
        if not isinstance(params.embed, DTensor):
            distribute_model(params, cfg, mesh)
    else:
        device = resolve_device(device)
    b, s = batch["tokens"].shape
    extra = cfg.n_frontend_tokens if cfg.frontend == "vision" else 0
    prefill = make_prefill(cfg, max_len=s + steps + extra, impl=impl, device=device, mesh=mesh)
    decode = make_decode_step(cfg, impl=impl, mesh=mesh)
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
        # one span per decode step, its synchronise inside: every device
        # operation the step launched has ended when the span closes
        with layer_span("serve.decode"):
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
    mesh=None,
) -> torch.Tensor:
    """Prefill the prompt batch, then greedy-decode ``steps`` tokens.
    Returns (B, steps) generated ids: :func:`generate_timed`'s tokens."""
    return generate_timed(params, cfg, batch, steps, impl=impl, device=device, mesh=mesh)["tokens"]
