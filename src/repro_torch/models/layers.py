"""Shared layers, init half: parameter trees as ``nn.Module``s.

The JAX package's ``models/layers.py`` keeps parameters as nested dicts of
arrays. Here each initializer returns an ``nn.Parameter`` or an
``nn.Module`` whose attribute names are that dict's keys, so
``named_parameters()`` reads like the reference's pytree paths. Matmul
weights keep the reference's ``(d_in, d_out)`` layout (a forward computes
``x @ w``), so a reference tree carries in without a transpose
(:mod:`repro_torch.models.convert`).

Tensors are allocated on ``init.device``. On ``torch.device("meta")``
nothing is allocated and nothing is drawn: that is how
:func:`repro_torch.models.model.count_params` sizes a full model. On a real
device the values are drawn from ``init.generator``, a ``torch.Generator``
on that device, from the reference's distributions (truncated normal at
fan-in scale, ones or zeros for norms); the numbers differ, since JAX's
PRNG is not torch's.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional, Sequence

import torch
from torch import nn

__all__ = [
    "Init",
    "torch_dtype",
    "dense_init",
    "embed_init",
    "rmsnorm_init",
    "mlp_init",
    "MLP",
]


def torch_dtype(name: str) -> torch.dtype:
    """The torch dtype of a config's ``dtype`` name (``"bfloat16"``, ...)."""
    dtype = getattr(torch, name, None)
    if not isinstance(dtype, torch.dtype):
        raise ValueError(f"unknown dtype {name!r}")
    return dtype


@dataclasses.dataclass(frozen=True)
class Init:
    """Where parameters are allocated and what draws their values (unused
    on the meta device)."""

    device: torch.device
    generator: Optional[torch.Generator] = None

    def param(
        self, shape: Sequence[int], dtype: torch.dtype, fill: Callable[[torch.Tensor], None]
    ) -> nn.Parameter:
        """A parameter of ``shape``; ``fill`` writes its float32 values
        (skipped on the meta device), which are then cast to ``dtype``."""
        t = torch.empty(tuple(shape), dtype=dtype, device=self.device)
        if self.device.type != "meta":
            v = torch.empty(t.shape, dtype=torch.float32, device=self.device)
            fill(v)
            t.copy_(v)
        return nn.Parameter(t)


def _trunc_normal(init: Init, scale: float):
    def fill(v):
        nn.init.trunc_normal_(v, 0.0, 1.0, -2.0, 2.0, generator=init.generator)
        v.mul_(scale)

    return fill


def dense_init(init: Init, shape, dtype, scale: float | None = None) -> nn.Parameter:
    """Truncated-normal fan-in init (matmul weights). A matrix's last two
    axes are ``(d_in, d_out)``; a leading axis stacks experts, each drawn
    at its own ``d_in``."""
    fan_in = shape[-2] if len(shape) >= 2 else 1
    scale = scale if scale is not None else 1.0 / math.sqrt(fan_in)
    return init.param(shape, dtype, _trunc_normal(init, scale))


def embed_init(init: Init, vocab: int, d_model: int, dtype) -> nn.Parameter:
    return init.param((vocab, d_model), dtype, _trunc_normal(init, 0.02))


def rmsnorm_init(init: Init, d_model: int, dtype, offset: float = 0.0) -> nn.Parameter:
    # stored weight; effective scale is (offset + w) so gemma stores zeros
    value = 1.0 if offset == 0.0 else 0.0
    return init.param((d_model,), dtype, lambda v: v.fill_(value))


class MLP(nn.Module):
    """silu-gated (llama), geglu (gemma) or squared-relu (nemotron) MLP.
    ``n`` stacks ``n`` experts' matrices on a leading axis."""

    def __init__(self, init: Init, d_model: int, d_ff: int, act: str, dtype, n: Optional[int] = None):
        super().__init__()
        lead = () if n is None else (n,)
        self.down = dense_init(init, (*lead, d_ff, d_model), dtype)
        if act in ("silu", "geglu"):
            self.gate = dense_init(init, (*lead, d_model, d_ff), dtype)
        self.up = dense_init(init, (*lead, d_model, d_ff), dtype)


def mlp_init(init: Init, d_model: int, d_ff: int, act: str, dtype, n: Optional[int] = None) -> MLP:
    return MLP(init, d_model, d_ff, act, dtype, n)
