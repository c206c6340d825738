"""The train step (the JAX package's ``train/train_step.py``):
microbatched gradient accumulation, the remat policy, the MTP auxiliary
loss, optional gradient compression, AdamW.

The step works on a :class:`~repro_torch.models.model.Model`; gradients
come from ``torch.autograd.grad``, eagerly (no jit, no CUDA graph). It
updates the parameters and the optimizer state in place under
``torch.no_grad()``, the port's counterpart of the reference's
``donate_argnums=(0,)``, and returns the same state object. It keeps the
reference's arithmetic where it changes numbers:

* with one microbatch the gradients stay in the parameters' dtype (bf16 at
  full width), and AdamW casts them to f32;
* with M > 1 each microbatch's gradients come from their own
  ``torch.autograd.grad`` and are accumulated into f32 buffers as
  ``g_acc += g.float() / M`` (not ``.grad`` accumulation, which would add
  in the parameters' dtype and divide once), and the metrics are the last
  microbatch's, as the reference's scan carry leaves them;
* the MTP term is ``mtp_weight * chunked_ce(mtp_hidden, labels[:, 1:])``
  and the MoE ``aux`` loss is added;
* ``compress_grads`` runs before AdamW and updates ``state["comp"]``; the
  per-layer tensors of one reference leaf share its quantization scale.

A train state is ``{"params": Model, "opt": {"m": {name: tensor}, "step":
int32 0-d tensor, "v": {...}}, "comp"?: {name: f32 tensor}}``;
:mod:`repro_torch.models.convert` carries it to and from the reference's
tree.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Tuple

import numpy as np
import torch

from .._device import resolve_device
from ..configs.base import ArchConfig
from ..models.convert import reference_layout
from ..models.model import Model, chunked_ce, forward_hidden
from ..optim.adamw import AdamWConfig, adamw_init, adamw_update
from ..optim.compression import CompressionState, compress_grads, compression_init

__all__ = ["TrainConfig", "init_train_state", "make_train_step"]


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    microbatches: int = 1
    remat: str = "dots"
    attn_impl: str = "auto"
    mtp_weight: float = 0.3
    compress_grads: bool = False
    # weight sharding over the data axes (ZeRO-3 style); on one device this
    # is the reference's 1x1-mesh case and changes nothing
    fsdp: bool = False
    loss_chunks: int = 0  # 0 = auto: bound live logits to ~256 MB
    opt: AdamWConfig = AdamWConfig()


def init_train_state(
    cfg: ArchConfig, tcfg: TrainConfig, device=None, seed: int = 0
) -> Dict[str, Any]:
    """Parameters drawn from ``seed`` (a ``torch.Generator`` on ``device``,
    the card unless given) and zero optimizer state beside them."""
    device = resolve_device(device)
    model = Model(cfg, device=device, generator=torch.Generator(device=device).manual_seed(seed))
    state = {"params": model, "opt": adamw_init(model, tcfg.opt)}
    if tcfg.compress_grads:
        state["comp"] = compression_init(model).error
    return state


def _loss_fn(params: Model, cfg: ArchConfig, tcfg: TrainConfig, batch, n_chunks: int):
    hidden, _, ex = forward_hidden(
        params, cfg, batch, impl=tcfg.attn_impl, remat=tcfg.remat, want_mtp=cfg.mtp
    )
    loss = chunked_ce(cfg, params, hidden, batch["labels"], n_chunks)
    total = loss + ex["aux"]
    metrics = {"lm_loss": loss, "aux_loss": ex["aux"]}
    if "mtp_hidden" in ex:
        # position t predicts token t+2 == labels shifted one further
        mtp = chunked_ce(cfg, params, ex["mtp_hidden"], batch["labels"][:, 1:], n_chunks)
        total = total + tcfg.mtp_weight * mtp
        metrics["mtp_loss"] = mtp
    metrics["loss"] = total
    return total, metrics


def _auto_loss_chunks(cfg: ArchConfig, tcfg: TrainConfig, batch_shape, chips: int = 1) -> int:
    """Bound live f32 chunk logits to ~256 MB per chip (one chip here)."""
    if tcfg.loss_chunks:
        return tcfg.loss_chunks
    b, s = batch_shape
    budget = 256e6
    n = int(np.ceil(b // max(1, tcfg.microbatches) * s * cfg.vocab * 4 / (chips * budget)))
    return max(1, min(n, s))


def _grads(model: Model, names, params, cfg, tcfg, batch, n_chunks):
    """(grads by name in the parameters' dtypes, metrics) of one batch;
    a parameter the loss does not reach gets zeros, as ``jax.grad``
    gives."""
    loss, metrics = _loss_fn(model, cfg, tcfg, batch, n_chunks)
    grads = torch.autograd.grad(loss, params, allow_unused=True)
    grads = {n: torch.zeros_like(p) if g is None else g for n, p, g in zip(names, params, grads)}
    return grads, {k: v.detach() for k, v in metrics.items()}


def make_train_step(
    cfg: ArchConfig, tcfg: TrainConfig, device=None
) -> Callable[[Dict, Dict], Tuple[Dict, Dict[str, torch.Tensor]]]:
    """Returns ``step(state, batch) -> (state, metrics)`` for a state and a
    batch on ``device`` (the card unless given); the state is updated in
    place and returned. Metrics are 0-d f32 tensors on the device:
    ``lm_loss``, ``aux_loss``, ``loss``, ``grad_norm``, ``lr`` (and
    ``mtp_loss`` for MTP models)."""
    device = resolve_device(device)
    m = tcfg.microbatches

    def step_fn(state, batch):
        model = state["params"]
        if model.embed.device.type != device.type:
            raise ValueError(f"the state lies on {model.embed.device}, the step on {device}")
        names, params = zip(*model.named_parameters())
        n_chunks = _auto_loss_chunks(cfg, tcfg, batch["tokens"].shape)
        with torch.enable_grad():
            if m == 1:
                grads, metrics = _grads(model, names, params, cfg, tcfg, batch, n_chunks)
            else:
                b = batch["tokens"].shape[0]
                grads = {n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                         for n, p in zip(names, params)}
                for i in range(m):
                    mb = {k: v.reshape(m, b // m, *v.shape[1:])[i] for k, v in batch.items()}
                    g, metrics = _grads(model, names, params, cfg, tcfg, mb, n_chunks)
                    with torch.no_grad():
                        for n in names:
                            grads[n] += g[n].float() / m
                    del g
        if tcfg.compress_grads:
            groups = [names for _, names, _ in reference_layout(model)]
            grads, _ = compress_grads(grads, CompressionState(state["comp"]), groups)
        _, _, opt_metrics = adamw_update(model, grads, state["opt"], tcfg.opt)
        return state, dict(metrics, **opt_metrics)

    return step_fn
