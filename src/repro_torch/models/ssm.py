"""Mamba-2 (SSD) mixer parameters and decode-state shapes -- the init half
of the JAX package's ``models/ssm.py``. The decode "cache" of an SSM layer
is a constant-size conv window plus a ``(B, H, P, N)`` state, which is why
ssm/hybrid architectures run long contexts."""

from __future__ import annotations

import torch
from torch import nn

from ..configs.base import ArchConfig
from .layers import Init, dense_init

__all__ = ["SSM", "ssm_init", "ssm_state_shapes"]


def _dims(cfg: ArchConfig):
    s = cfg.ssm
    d_inner = s.expand * cfg.d_model
    n_heads = d_inner // s.head_dim
    conv_ch = d_inner + 2 * s.n_groups * s.d_state
    return d_inner, n_heads, conv_ch


class SSM(nn.Module):
    """Projections kept as separate matrices (wz/wx/wbc/wdt, split convs),
    as in the reference, so tensor parallelism can shard the d_inner-sized
    outputs while the small B/C/dt streams stay replicated. ``dt_bias``,
    ``a_log`` and ``d_skip`` are float32 whatever the config's dtype."""

    def __init__(self, init: Init, cfg: ArchConfig, dtype):
        super().__init__()
        s = cfg.ssm
        d = cfg.d_model
        d_inner, h, _ = _dims(cfg)
        bc_ch = 2 * s.n_groups * s.d_state
        f32 = torch.float32
        self.wz = dense_init(init, (d, d_inner), dtype)
        self.wx = dense_init(init, (d, d_inner), dtype)
        self.wbc = dense_init(init, (d, bc_ch), dtype)
        self.wdt = dense_init(init, (d, h), dtype)
        self.conv_x_w = dense_init(init, (s.d_conv, d_inner), dtype, scale=0.5)
        self.conv_x_b = init.param((d_inner,), dtype, lambda v: v.zero_())
        self.conv_bc_w = dense_init(init, (s.d_conv, bc_ch), dtype, scale=0.5)
        self.conv_bc_b = init.param((bc_ch,), dtype, lambda v: v.zero_())
        self.dt_bias = init.param((h,), f32, lambda v: v.zero_())
        # A in [-16, -1]
        self.a_log = init.param(
            (h,), f32, lambda v: v.copy_(torch.linspace(1.0, 16.0, h, dtype=f32).log())
        )
        self.d_skip = init.param((h,), f32, lambda v: v.fill_(1.0))
        self.norm_w = init.param((d_inner,), dtype, lambda v: v.fill_(1.0))
        self.out_proj = dense_init(init, (d_inner, d), dtype)


def ssm_init(init: Init, cfg: ArchConfig, dtype) -> SSM:
    return SSM(init, cfg, dtype)


def ssm_state_shapes(cfg: ArchConfig, batch: int):
    """Decode-cache shapes (the SSM analogue of a KV cache)."""
    s = cfg.ssm
    d_inner, h, _ = _dims(cfg)
    return {
        "conv_x": (batch, s.d_conv - 1, d_inner),
        "conv_bc": (batch, s.d_conv - 1, 2 * s.n_groups * s.d_state),
        "ssm": (batch, h, s.head_dim, s.d_state),
    }
