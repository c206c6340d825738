"""Mixture-of-experts parameters -- the init half of the JAX package's
``models/moe.py``: the router, the routed experts as one stack of
``n_experts`` MLPs (each matrix ``(E, d_in, d_out)``, the layout a grouped
matmul reads), and the always-on shared experts (DeepSeek)."""

from __future__ import annotations

from torch import nn

from ..configs.base import ArchConfig
from .layers import Init, dense_init, mlp_init

__all__ = ["MoE", "moe_init"]


class MoE(nn.Module):
    def __init__(self, init: Init, cfg: ArchConfig, dtype):
        super().__init__()
        m = cfg.moe
        d = cfg.d_model
        self.router = dense_init(init, (d, m.n_experts), dtype, scale=0.02)
        self.experts = mlp_init(init, d, m.d_ff, cfg.act, dtype, n=m.n_experts)
        if m.n_shared:
            self.shared = mlp_init(init, d, m.d_ff * m.n_shared, cfg.act, dtype)


def moe_init(init: Init, cfg: ArchConfig, dtype) -> MoE:
    return MoE(init, cfg, dtype)
