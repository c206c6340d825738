"""Model assembly, init half: embeddings, stack(s), head and the MTP block
as one ``nn.Module``, and the parameter accounting the LM codesign cells
read (the JAX package's ``models/model.py``).

:class:`Model` has no forward yet (it comes with serving and training);
calling one raises ``nn.Module``'s own missing-forward error.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from .._device import resolve_device
from ..configs.base import ArchConfig
from .layers import Init, dense_init, embed_init, rmsnorm_init, torch_dtype
from .transformer import block_init, stack_init

__all__ = ["Model", "count_params", "active_params", "LEARNED_POS_MAX"]

LEARNED_POS_MAX = 32768  # whisper decode_32k needs absolute slots up to 32k


class MTP(nn.Module):
    """DeepSeek-V3 multi-token prediction: fuse the hidden state with the
    next token's embedding, one extra block, the shared head."""

    def __init__(self, init: Init, cfg: ArchConfig, dtype):
        super().__init__()
        self.norm_h = rmsnorm_init(init, cfg.d_model, dtype, cfg.rms_offset)
        self.norm_e = rmsnorm_init(init, cfg.d_model, dtype, cfg.rms_offset)
        self.proj = dense_init(init, (2 * cfg.d_model, cfg.d_model), dtype)
        self.block = block_init(init, cfg, "attn", "mlp", dtype)
        self.final_norm = rmsnorm_init(init, cfg.d_model, dtype, cfg.rms_offset)


class Model(nn.Module):
    """The parameters of one architecture (the reference's ``init_model``),
    named as its tree: ``embed``, ``pos_embed`` (learned positions,
    ``LEARNED_POS_MAX`` rows), ``stack`` -- or ``encoder``/``enc_norm``/
    ``decoder`` for enc-dec models --, ``final_norm``, ``lm_head`` unless
    the embeddings are tied, and ``mtp``.

    ``device`` is the card unless given (``"cpu"``, or ``"meta"`` to
    allocate nothing); on a real device the values are drawn from
    ``generator`` (a fresh one seeded 0 on that device when ``None``).
    """

    def __init__(self, cfg: ArchConfig, device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        if generator is None and device.type != "meta":
            generator = torch.Generator(device=device).manual_seed(0)
        init = Init(device, generator)
        dtype = torch_dtype(cfg.dtype)
        self.embed = embed_init(init, cfg.vocab, cfg.d_model, dtype)
        if cfg.rope == "learned":
            self.pos_embed = init.param(
                (LEARNED_POS_MAX, cfg.d_model), dtype,
                lambda v: v.normal_(0.0, 1.0, generator=generator).mul_(0.01),
            )
        if cfg.enc_dec:
            enc_segs = [((("attn", "mlp"),), cfg.n_enc_layers)]
            self.encoder = stack_init(init, cfg, dtype, cross=False, segs=enc_segs)
            self.enc_norm = rmsnorm_init(init, cfg.d_model, dtype, cfg.rms_offset)
            self.decoder = stack_init(init, cfg, dtype, cross=True)
        else:
            self.stack = stack_init(init, cfg, dtype, cross=False)
        self.final_norm = rmsnorm_init(init, cfg.d_model, dtype, cfg.rms_offset)
        if not cfg.tie_embeddings:
            self.lm_head = dense_init(init, (cfg.d_model, cfg.vocab), dtype)
        if cfg.mtp:
            self.mtp = MTP(init, cfg, dtype)


# ---------------------------------------------------------------------------
# Parameter accounting (for MODEL_FLOPS / roofline)
# ---------------------------------------------------------------------------
def count_params(cfg: ArchConfig) -> int:
    """Exact parameter count: the real model built on the meta device
    (nothing allocated, nothing drawn)."""
    return sum(p.numel() for p in Model(cfg, device="meta").parameters())


def active_params(cfg: ArchConfig) -> int:
    """Active-per-token parameters (MoE: routed top-k + shared only)."""
    total = count_params(cfg)
    if cfg.moe is None:
        return total
    m = cfg.moe
    mats = 3 if cfg.act in ("silu", "geglu") else 2
    per_expert = mats * cfg.d_model * m.d_ff
    n_moe_layers = sum(1 for _, f in cfg.layer_kinds() if f == "moe")
    inactive = per_expert * (m.n_experts - m.top_k) * n_moe_layers
    return total - inactive
