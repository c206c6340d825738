"""Shared layers: parameter trees as ``nn.Module``s, and the functions that
apply them (the JAX package's ``models/layers.py``).

The JAX package keeps parameters as nested dicts of arrays. Here each
initializer returns an ``nn.Parameter`` or an ``nn.Module`` whose
attribute names are that dict's keys, so ``named_parameters()`` reads like
the reference's pytree paths. Matmul weights keep the reference's
``(d_in, d_out)`` layout (a forward computes ``x @ w``), so a reference
tree carries in without a transpose (:mod:`repro_torch.models.convert`).
The apply functions keep the reference's names and take the module where
the reference takes its dict; activations and softmax accumulate in f32
and are stored in the input dtype, as there.

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
from typing import Callable, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..sharding.dtensor import reduce_partial, reduce_partial_grad

__all__ = [
    "Init",
    "torch_dtype",
    "dense_init",
    "embed_init",
    "rmsnorm_init",
    "mlp_init",
    "MLP",
    "rmsnorm",
    "mlp",
    "rope_freqs",
    "apply_rope",
    "mrope_rotate",
    "sinusoidal_positions",
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
    ``n`` stacks ``n`` experts' matrices on a leading axis; its forward then
    takes ``(n, tokens, d_model)``, one row of tokens per expert."""

    def __init__(self, init: Init, d_model: int, d_ff: int, act: str, dtype, n: Optional[int] = None):
        super().__init__()
        self.act = act
        lead = () if n is None else (n,)
        self.down = dense_init(init, (*lead, d_ff, d_model), dtype)
        if act in ("silu", "geglu"):
            self.gate = dense_init(init, (*lead, d_model, d_ff), dtype)
        self.up = dense_init(init, (*lead, d_model, d_ff), dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return mlp(self, x, self.act)


def mlp_init(init: Init, d_model: int, d_ff: int, act: str, dtype, n: Optional[int] = None) -> MLP:
    return MLP(init, d_model, d_ff, act, dtype, n)


# ---------------------------------------------------------------------------
# Apply
# ---------------------------------------------------------------------------
def rmsnorm(w: torch.Tensor, x: torch.Tensor, offset: float = 0.0, eps: float = 1e-6) -> torch.Tensor:
    # on a mesh: the residual stream's partial sums are reduced here, and
    # so are those of the gradient coming back into the output
    x = reduce_partial(x)
    xf = x.float()
    rms = torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + eps)
    return reduce_partial_grad(((offset + w.float()) * xf * rms).to(x.dtype))


def mlp(params: MLP, x: torch.Tensor, act: str) -> torch.Tensor:
    """``x @ up`` etc.; with stacked experts ``(E, T, d) @ (E, d, f)`` is
    one batched product per matrix (the reference's ``vmap`` over
    experts)."""
    up = x @ params.up
    if act == "silu":
        h = F.silu(x @ params.gate) * up
    elif act == "geglu":
        h = F.gelu(x @ params.gate, approximate="tanh") * up
    elif act == "relu2":
        h = torch.square(F.relu(up))
    else:
        raise ValueError(f"unknown act {act}")
    return h @ params.down


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    """Inverse frequencies for the pairwise rotation, shape (head_dim//2,)."""
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim))


def _rotate(x: torch.Tensor, angles: torch.Tensor) -> torch.Tensor:
    """Rotate pairs. x: (..., S, H, D); angles: (..., S, 1|H, D/2)."""
    x1, x2 = x.float().chunk(2, dim=-1)
    cos, sin = torch.cos(angles), torch.sin(angles)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Standard RoPE. x: (B, S, H, D); positions: (B, S) int."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)  # (D/2,)
    angles = positions[..., None, None].float() * freqs  # (B,S,1,D/2)
    return _rotate(x, angles)


def mrope_rotate(x: torch.Tensor, positions3: torch.Tensor, sections: Tuple[int, ...],
                 theta: float) -> torch.Tensor:
    """Qwen2-VL M-RoPE: positions3 (B, 3, S) = (t, h, w) ids; the D/2 rotary
    pairs are split into ``sections`` (sum = D/2), each driven by one id."""
    d_half = x.shape[-1] // 2
    if sum(sections) != d_half:
        raise ValueError(f"mrope sections {sections} do not sum to {d_half}")
    freqs = rope_freqs(x.shape[-1], theta, x.device)  # (D/2,)
    # select which of the 3 position streams drives each pair
    sel = torch.repeat_interleave(
        torch.arange(3, device=x.device), torch.tensor(sections, device=x.device),
        output_size=d_half,
    )  # (D/2,)
    pos = positions3.float()[:, sel, :]  # (B, D/2, S)
    angles = pos.movedim(1, -1)[..., None, :] * freqs  # (B,S,1,D/2)
    return _rotate(x, angles)


def pad_seq(x: torch.Tensor, n: int, value=0) -> torch.Tensor:
    """Pad axis 1 (the sequence) of ``x`` at its end with ``n`` entries of
    ``value`` (``jnp.pad`` of one axis)."""
    if not n:
        return x
    return torch.cat([x, x.new_full((x.shape[0], n, *x.shape[2:]), value)], dim=1)


def sinusoidal_positions(n: int, d_model: int, device=None) -> torch.Tensor:
    """Whisper-style sinusoidal embedding table (n, d_model), f32."""
    half = d_model // 2
    scale = torch.exp(
        -torch.arange(half, dtype=torch.float32, device=device) * math.log(10000.0) / (half - 1)
    )
    args = torch.arange(n, dtype=torch.float32, device=device)[:, None] * scale[None, :]
    return torch.cat([torch.sin(args), torch.cos(args)], dim=-1)
