"""AdamW with decoupled weight decay, global-norm clipping and a
warmup+cosine schedule (the JAX package's ``optim/adamw.py``).

Moments are f32 regardless of parameter dtype; parameters stay in their
storage dtype and the update is computed in f32 then cast back (bf16-native
training, no separate f32 master copy), leaf by leaf, as in the reference.

A *tree* here is a :class:`torch.nn.Module` (its ``named_parameters()``) or
a flat dict of name -> tensor; the moments are dicts keyed by the same
names. The reference returns new trees; here the update writes the
parameters and the moments in place under ``torch.no_grad()`` (the port's
counterpart of the reference's buffer donation), and returns the same
objects. ``step`` is an int32 0-d tensor on the parameters' device, and the
schedule and the bias corrections are computed on the device from it, so
an update reads nothing back to the host.

On a mesh the parameters, gradients and moments are DTensors (ZeRO-1:
the moments, and the gradients handed in, carry the data axes the
parameters may lack). The update runs leaf by leaf on the local shards in
the moments' layout, and the new parameter values are redistributed to
the parameter's own layout (ZeRO-1's all-gather) before they are copied
in; the global norm sums each leaf's squares over the mesh.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Mapping, Tuple

import torch
from torch import nn
from torch.distributed.tensor import DTensor

__all__ = ["AdamWConfig", "adamw_init", "adamw_update", "global_norm", "lr_at", "named_leaves"]


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_ratio: float = 0.1
    moment_dtype: str = "float32"  # bf16 halves optimizer memory


def named_leaves(tree: Any) -> Dict[str, torch.Tensor]:
    """``{name: tensor}`` of a module's parameters or of a flat dict."""
    if isinstance(tree, nn.Module):
        return dict(tree.named_parameters())
    if isinstance(tree, Mapping):
        return dict(tree)
    raise TypeError(f"want an nn.Module or a dict of tensors, got {type(tree).__name__}")


def lr_at(cfg: AdamWConfig, step) -> torch.Tensor:
    """Linear warmup then cosine decay to min_lr_ratio * lr (an f32 tensor
    on ``step``'s device)."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = step / max(1.0, cfg.warmup_steps)
    t = (step - cfg.warmup_steps) / max(1.0, cfg.total_steps - cfg.warmup_steps)
    t = torch.clamp(t, 0.0, 1.0)
    cos = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * (1 + torch.cos(math.pi * t))
    return cfg.lr * torch.where(step < cfg.warmup_steps, warm, cos)


def adamw_init(params: Any, cfg: "AdamWConfig | None" = None) -> Dict[str, Any]:
    """Zero moments (``cfg.moment_dtype``, f32 without a config) beside
    every parameter, and ``step`` 0 on the parameters' device."""
    dtype = getattr(torch, cfg.moment_dtype) if cfg else torch.float32
    leaves = named_leaves(params)
    device = next(iter(leaves.values())).device if leaves else torch.device("cpu")
    zeros = lambda p: torch.zeros(p.shape, dtype=dtype, device=p.device)  # noqa: E731
    return {
        "m": {k: zeros(p) for k, p in leaves.items()},
        "v": {k: zeros(p) for k, p in leaves.items()},
        "step": torch.zeros((), dtype=torch.int32, device=device),
    }


def global_norm(tree: Any) -> torch.Tensor:
    """sqrt of the sum of the per-leaf f32 sums of squares (a DTensor
    leaf's sum is reduced over the mesh first)."""
    leaves = [_full(torch.sum(torch.square(x.float()))) for x in named_leaves(tree).values()]
    return torch.sqrt(torch.sum(torch.stack(leaves)))


def _full(t: torch.Tensor) -> torch.Tensor:
    return t.full_tensor() if isinstance(t, DTensor) else t


def _update_local(p, g, m, v, scale, lr, bc1, bc2, cfg: AdamWConfig) -> None:
    """One leaf's update on tensors of one layout, in place."""
    g = g.float() * scale
    m_new = cfg.b1 * m.float() + (1 - cfg.b1) * g
    v_new = cfg.b2 * v.float() + (1 - cfg.b2) * torch.square(g)
    del g
    p32 = p.float()
    delta = (m_new / bc1) / (torch.sqrt(v_new / bc2) + cfg.eps) + cfg.weight_decay * p32
    p.copy_(p32 - lr * delta)
    m.copy_(m_new)
    v.copy_(v_new)


def _update_dtensor(p: DTensor, g: DTensor, m: DTensor, v: DTensor, *args) -> None:
    """The update of a DTensor leaf on the local shards of the moments'
    layout (ZeRO-1), the result all-gathered into the parameter's."""
    if g.placements != m.placements:
        g = g.redistribute(placements=m.placements)
    same = p.placements == m.placements
    p_opt = p if same else p.redistribute(placements=m.placements)
    p_loc = p_opt.to_local() if same else p_opt.to_local().clone()
    _update_local(p_loc, g.to_local(), m.to_local(), v.to_local(), *args)
    if not same:
        new = DTensor.from_local(p_loc, m.device_mesh, m.placements, shape=p.shape,
                                 stride=p.stride()).redistribute(placements=p.placements)
        p.to_local().copy_(new.to_local())


@torch.no_grad()
def adamw_update(
    params: Any, grads: Any, state: Dict[str, Any], cfg: AdamWConfig
) -> Tuple[Any, Dict[str, Any], Dict[str, torch.Tensor]]:
    """One step, in place. Returns (params, state, metrics)."""
    flat_p, flat_g = named_leaves(params), named_leaves(grads)
    if flat_g.keys() != flat_p.keys():
        raise ValueError("grads and params name different leaves")
    state["step"].add_(1)
    step = state["step"]
    gnorm = global_norm(flat_g)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9), max=1.0)
    lr = lr_at(cfg, step)
    sf = step.to(torch.float32)
    bc1 = 1.0 - cfg.b1 ** sf
    bc2 = 1.0 - cfg.b2 ** sf
    for name, p in flat_p.items():
        update = _update_dtensor if isinstance(p, DTensor) else _update_local
        update(p, flat_g[name], state["m"][name], state["v"][name], scale, lr, bc1, bc2, cfg)
    return params, state, {"grad_norm": gnorm, "lr": lr}
