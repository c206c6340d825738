"""Attention parameters: GQA/MHA, sliding window (SWA), MLA (DeepSeek) and
cross-attention -- the init half of the JAX package's
``models/attention.py``. The KV-cache layout each variant serves from is
built by :mod:`repro_torch.serve.kvcache`."""

from __future__ import annotations

from torch import nn

from ..configs.base import ArchConfig
from .layers import Init, dense_init, rmsnorm_init

__all__ = ["Attention", "attn_init"]


class Attention(nn.Module):
    """One attention sublayer's projections, named as the reference's keys:
    ``wq``/``wk``/``wv``/``wo``, or for MLA the low-rank ``wq_a``/``wq_b``
    and ``wkv_a``/``wkv_b`` with their norms. Cross-attention of an MLA
    model takes the plain projections, as in the reference."""

    def __init__(self, init: Init, cfg: ArchConfig, dtype, cross: bool = False):
        super().__init__()
        d, h, kh, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
        a = cfg.attn
        if a.kind == "mla" and not cross:
            r_q, r_kv, dr, dv = a.q_lora_rank, a.kv_lora_rank, a.rope_head_dim, a.v_head_dim
            self.wq_a = dense_init(init, (d, r_q), dtype)
            self.q_norm = rmsnorm_init(init, r_q, dtype)
            self.wq_b = dense_init(init, (r_q, h * (dh + dr)), dtype)
            self.wkv_a = dense_init(init, (d, r_kv + dr), dtype)
            self.kv_norm = rmsnorm_init(init, r_kv, dtype)
            self.wkv_b = dense_init(init, (r_kv, h * (dh + dv)), dtype)
            self.wo = dense_init(init, (h * dv, d), dtype)
        else:
            self.wq = dense_init(init, (d, h * dh), dtype)
            self.wk = dense_init(init, (d, kh * dh), dtype)
            self.wv = dense_init(init, (d, kh * dh), dtype)
            self.wo = dense_init(init, (h * dh, d), dtype)


def attn_init(init: Init, cfg: ArchConfig, dtype, cross: bool = False) -> Attention:
    return Attention(init, cfg, dtype, cross)
