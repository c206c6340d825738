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

On a mesh (pass a ``DeviceMesh`` where a device goes) the state is
DTensors: the parameters placed by ``param_specs(fsdp=tcfg.fsdp)``, the
moments and residuals by ``opt_state_specs`` (ZeRO-1). The step is the
same body: it places a batch by ``batch_specs``; with M > 1 it re-slices
each microbatch from the global batch and places it again, so every
microbatch stays sharded over the data axes (the reference re-pins the
sharding for the same reason). The microbatch gradients are accumulated
in place as DTensor partial sums and reduced once per step into the
moments' layout; compression and AdamW then work on local shards. The
helpers of :mod:`repro_torch.sharding.dtensor` that do this leave plain
tensors as they are, so a ``torch.device`` keeps the single-device path
above.

Under ``torch.profiler`` the step records the layer spans
(:func:`repro_torch.obs.trace.layer_span`, each with its device time)
``train.step`` (the whole step) and ``train.forward`` (each microbatch's
forward pass and loss); the stack adds ``model.attention`` and
``train.recompute`` (:mod:`repro_torch.models.transformer`).
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
from ..obs.trace import layer_span
from ..optim.adamw import AdamWConfig, adamw_init, adamw_update
from ..optim.compression import CompressionState, compress_grads, compression_init
from ..sharding.dtensor import (
    add_,
    check_placed,
    distribute_batch,
    distribute_model,
    full,
    is_mesh,
    mesh_device,
    microbatches,
    opt_placements,
    replicating,
    to_layout,
    zeros_like,
)

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


def _init_mesh_state(cfg: ArchConfig, tcfg: TrainConfig, mesh, seed: int) -> Dict[str, Any]:
    device = mesh_device(mesh)
    model = Model(cfg, device=device, generator=torch.Generator(device=device).manual_seed(seed))
    return mesh_state(cfg, tcfg, model, mesh)


def mesh_state(cfg: ArchConfig, tcfg: TrainConfig, model: Model, mesh) -> Dict[str, Any]:
    """A train state on ``mesh`` around ``model`` (the same full values on
    every rank): its parameters placed by ``param_specs`` in place, zero
    moments (and compression residuals) by ``opt_state_specs``."""
    from torch.distributed.tensor import zeros as dzeros

    device = mesh_device(mesh)
    opl = opt_placements(cfg, model, mesh, tcfg.fsdp)
    distribute_model(model, cfg, mesh, tcfg.fsdp)
    names = [n for n, _ in model.named_parameters()]
    shapes = {n: p.shape for n, p in model.named_parameters()}

    def zeros(dtype):
        return {n: dzeros(shapes[n], dtype=dtype, device_mesh=mesh, placements=opl[n])
                for n in names}

    mdt = getattr(torch, tcfg.opt.moment_dtype)
    state = {"params": model, "opt": {"m": zeros(mdt), "v": zeros(mdt),
                                      "step": torch.zeros((), dtype=torch.int32, device=device)}}
    if tcfg.compress_grads:
        state["comp"] = zeros(torch.float32)
    return state


def init_train_state(
    cfg: ArchConfig, tcfg: TrainConfig, device=None, seed: int = 0
) -> Dict[str, Any]:
    """Parameters drawn from ``seed`` (a ``torch.Generator`` on ``device``,
    the card unless given) and zero optimizer state beside them. ``device``
    may be a ``DeviceMesh``: every rank draws the same parameters on the
    mesh's device and keeps its shards (params by ``param_specs``, moments
    by ``opt_state_specs``)."""
    if is_mesh(device):
        return _init_mesh_state(cfg, tcfg, device, seed)
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
    """Bound live f32 chunk logits to ~256 MB per chip (``chips``: the
    mesh's size, one on a single device: on a mesh each rank holds its
    data rows of the chunk and its vocab shard,
    :func:`repro_torch.sharding.dtensor.vocab_nll`)."""
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
    with layer_span("train.forward", device=True):  # remat's recompute is train.recompute
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
    ``mtp_loss`` for MTP models). ``device`` may be a ``DeviceMesh``; the
    state is then :func:`init_train_state`'s on that mesh, a batch may be
    plain (the same global batch on every rank) or placed already, and the
    metrics are plain tensors with the global values."""
    mesh = device if is_mesh(device) else None
    where = device if mesh is not None else resolve_device(device)
    chips = mesh.size() if mesh is not None else 1
    m = tcfg.microbatches

    def step_fn(state, batch):
        with layer_span("train.step", device=True):
            return _step(state, batch)

    def _step(state, batch):
        model = state["params"]
        names, params = zip(*model.named_parameters())
        check_placed(params, where)
        batch = distribute_batch(cfg, batch, mesh)
        n_chunks = _auto_loss_chunks(cfg, tcfg, batch["tokens"].shape, chips=chips)
        with torch.enable_grad(), replicating(mesh):
            if m == 1:
                grads, metrics = _grads(model, names, params, cfg, tcfg, batch, n_chunks)
            else:
                grads = {}
                for mb in microbatches(cfg, batch, m):
                    g, metrics = _grads(model, names, params, cfg, tcfg, mb, n_chunks)
                    with torch.no_grad():
                        for n in names:
                            gn = g[n].float() / m
                            if n not in grads:
                                grads[n] = zeros_like(gn)
                            add_(grads[n], gn)
                    del g
        with torch.no_grad():  # on a mesh: one reduction per step, into the moments' layout
            grads = {n: to_layout(grads[n], state["opt"]["m"][n]) for n in names}
        if tcfg.compress_grads:
            groups = [names for _, names, _ in reference_layout(model)]
            grads, _ = compress_grads(grads, CompressionState(state["comp"]), groups)
        _, _, opt_metrics = adamw_update(model, grads, state["opt"], tcfg.opt)
        metrics = {k: full(v) for k, v in metrics.items()}
        return state, dict(metrics, **opt_metrics)

    return step_fn
