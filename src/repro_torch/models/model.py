"""Model assembly: embeddings/frontends -> stack(s) -> head (+MTP), the
loss, and the parameter accounting the LM codesign cells read (the JAX
package's ``models/model.py``).

:class:`Model` holds the parameters; :func:`forward_hidden`/:func:`forward`
(also ``Model.forward``) run them, and are what the serve steps call.
Modality frontends are stubs, as in the reference: ``batch["frontend"]``
carries precomputed frame/patch embeddings, consumed as leading sequence
positions (vlm) or as the encoder input (audio). A forward computes on
the device its parameters lie on, and refuses tokens that lie elsewhere.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.distributed.tensor import DTensor
from torch.utils.checkpoint import checkpoint

from .._device import resolve_device
from ..configs.base import ArchConfig
from ..obs.trace import checkpointed
from ..sharding.dtensor import fsdp_gather, rows_like, vocab_embedding, vocab_nll
from .layers import Init, dense_init, embed_init, rmsnorm, rmsnorm_init, sinusoidal_positions, torch_dtype
from .transformer import block_apply, block_init, stack_apply, stack_init

__all__ = [
    "Model",
    "forward",
    "forward_hidden",
    "lm_loss",
    "chunked_ce",
    "count_params",
    "active_params",
    "mrope_positions",
    "LEARNED_POS_MAX",
]

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
        self.cfg = cfg
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

    def forward(self, batch: Dict, *, caches: Optional[Dict] = None, impl: str = "auto",
                remat: str = "none", want_mtp: bool = False):
        """:func:`forward` of this model: (logits, new_caches, extras)."""
        return forward(self, self.cfg, batch, caches=caches, impl=impl, remat=remat,
                       want_mtp=want_mtp)


# ---------------------------------------------------------------------------
# Positions
# ---------------------------------------------------------------------------
def mrope_positions(cfg: ArchConfig, batch: int, n_vision: int, n_text: int, offset=0,
                    device=None, like=None) -> torch.Tensor:
    """Qwen2-VL M-RoPE ids (B, 3, S): vision patches get (t=0, h, w) grid
    ids; text gets synchronized ids continuing after the grid extent.
    ``like`` (a (B, ...) tensor) donates its rows' layout
    (:func:`_text_positions`)."""
    g = max(1, int(math.ceil(math.sqrt(max(n_vision, 1)))))
    vis_i = torch.arange(n_vision, device=device)
    vis = torch.stack([torch.zeros_like(vis_i), vis_i // g, vis_i % g])  # (3, Nv)
    start = g  # text ids start after the spatial extent
    txt_i = start + torch.arange(n_text, device=device) + _offset(offset, device)
    txt = txt_i.expand(3, n_text)  # (3, Nt)
    pos = torch.cat([vis, txt], dim=1)  # (3, S)

    def rows(lo, n):
        return pos[None].expand(n, 3, pos.shape[1])

    return rows(0, batch) if like is None else rows_like(rows, like)


def _offset(offset, device):
    """A cache index as something to add to positions: a Python int stays
    one; a tensor (a 0-d index on the device, or one per batch row) is
    moved to ``device``, never read back to the host."""
    if isinstance(offset, torch.Tensor):
        return offset.to(device=device, dtype=torch.int64)
    return int(offset)


def _text_positions(like: torch.Tensor, seq: int, offset, device) -> torch.Tensor:
    """Position ids (B, S) for the B rows of ``like`` (the tokens), which
    donates its layout, as the reference's ``like=`` hands the tokens'
    sharding to the ids: on a mesh the ids are a DTensor sharded over the
    rows as ``like`` is, each rank making its own rows only, so what is
    built from them (the rope angles, the learned lookup, the masks) runs
    on the rank's rows. Made bare they would count as replicated, and all
    of that would run at the global batch on every rank."""
    off = _offset(offset, device)

    def rows(lo, n):
        pos = torch.arange(seq, device=device)[None, :]
        if isinstance(off, torch.Tensor):
            o = off.reshape(-1, 1)
            pos = pos + (o[lo:lo + n] if o.shape[0] > 1 else o)
        else:
            pos = pos + off
        return pos.expand(n, seq)

    return rows_like(rows, like)


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------
def _embed(cfg, params, tokens):
    # on a mesh: a masked lookup in each rank's rows of a vocab-sharded
    # table, summed over the vocab ranks (no DTensor rule back-propagates
    # the masked partial sum)
    x = vocab_embedding(params.embed, tokens)
    if cfg.emb_scale:
        x = (x.float() * math.sqrt(cfg.d_model)).to(x.dtype)
    return x


def _head(cfg, params, x):
    # on a mesh under FSDP the weight is gathered over the data axes that
    # shard the rows, so the logits keep their rows there and their vocab
    # over ``model`` (left to itself DTensor splits the contraction over
    # data: logits of every row, partial sums that the loss then gathers
    # to the full vocab)
    w = params.embed.T if cfg.tie_embeddings else params.lm_head
    return x @ fsdp_gather(w, x)


def _check_device(params: Model, tokens: torch.Tensor) -> None:
    dev = params.embed.device
    if tokens.device != dev:
        raise ValueError(f"tokens on {tokens.device}, the model on {dev}: move one of them")


def forward_hidden(
    params: Model,
    cfg: ArchConfig,
    batch: Dict,
    *,
    caches: Optional[Dict] = None,
    impl: str = "auto",
    remat: str = "none",
    want_mtp: bool = False,
) -> Tuple[torch.Tensor, Optional[Dict], Dict]:
    """Backbone only: returns (normed hidden (B,S,d), new_caches, extras
    {'aux', 'mtp_hidden'?}). The head is applied by the caller -- training
    uses :func:`chunked_ce` so full (tokens x vocab) logits never
    materialize; serving applies the head to the positions it needs.

    batch keys: 'tokens' (B,S); optional 'frontend' (B,F,d) patch/frame
    embeddings (vlm: prepended; audio: encoder input); optional
    'cache_index' (an int or a 0-d tensor) for decode; optional
    'positions' override. ``caches`` (``init_caches``' layout) are updated
    in place; ``new_caches`` is a new dict over the same tensors.
    """
    tokens = batch["tokens"]
    _check_device(params, tokens)
    dev = tokens.device
    b, s = tokens.shape
    offset = batch.get("cache_index", 0)
    x = _embed(cfg, params, tokens)

    enc_out = None  # only non-None when cross K/V must be (re)computed
    new_caches = dict(caches) if caches is not None else None
    if cfg.enc_dec:
        if caches is not None and "enc_out" in caches:
            # decode: cross K/V already live in the per-layer caches; the
            # stack must NOT see enc_out again (it would re-append K/V)
            new_caches["enc_out"] = caches["enc_out"]
        else:
            enc_in = batch["frontend"].to(x.dtype)
            ns = enc_in.shape[1]
            enc_in = enc_in + sinusoidal_positions(ns, cfg.d_model, dev)[None].to(x.dtype)
            enc_pos = _text_positions(enc_in, ns, 0, dev)
            enc_out, _, _ = stack_apply(
                params.encoder, cfg, enc_in, positions=enc_pos, mode="bidir",
                impl=impl, remat=remat,
            )
            enc_out = rmsnorm(params.enc_norm, enc_out, cfg.rms_offset)
            if new_caches is not None:
                new_caches["enc_out"] = enc_out

    if cfg.frontend == "vision" and batch.get("frontend") is not None:
        vis = batch["frontend"].to(x.dtype)
        x = torch.cat([vis, x], dim=1)
        positions = mrope_positions(cfg, b, vis.shape[1], s, offset=offset, device=dev,
                                    like=tokens)
    elif cfg.rope == "mrope":
        # text-only step (e.g. decode): all three ids follow the text id
        nv = cfg.n_frontend_tokens
        g = max(1, int(math.ceil(math.sqrt(max(nv, 1)))))
        txt = _text_positions(tokens, s, offset, dev) + g
        positions = txt[:, None, :].expand(b, 3, s)
    else:
        positions = batch.get("positions")
        if positions is None:
            positions = _text_positions(tokens, s, offset, dev)

    if cfg.rope == "learned":
        slots = torch.clamp(positions, 0, LEARNED_POS_MAX - 1)
        # on a mesh a lookup: indexing's backward (index_put) has no DTensor rule
        rows = F.embedding(slots, params.pos_embed) if isinstance(params.pos_embed, DTensor) \
            else params.pos_embed[slots]
        x = x + rows.to(x.dtype)

    stack = params.decoder if cfg.enc_dec else params.stack
    stack_caches = caches.get("stack") if caches is not None else None
    h, stack_caches_out, aux = stack_apply(
        stack, cfg, x, positions=positions, mode="causal",
        caches=stack_caches, enc_out=enc_out, impl=impl, remat=remat,
        cross=cfg.enc_dec,
    )
    if new_caches is not None:
        new_caches["stack"] = stack_caches_out

    hn = rmsnorm(params.final_norm, h, cfg.rms_offset)
    extras = {"aux": aux}

    if cfg.mtp and want_mtp and caches is None:
        # DeepSeek-V3 MTP: fuse h_t with emb(tok_{t+1}), one extra block,
        # shared head -> predicts tok_{t+2}. (Sequence shortened by 1.)
        mp = params.mtp
        h_in = rmsnorm(mp.norm_h, h[:, :-1], cfg.rms_offset)
        e_in = rmsnorm(mp.norm_e, _embed(cfg, params, tokens[:, 1:]), cfg.rms_offset)
        fused = torch.cat([h_in, e_in], dim=-1) @ mp.proj
        fused, _, _ = block_apply(
            mp.block, cfg, "attn", "mlp", fused,
            positions=positions[:, :-1] if positions.dim() == 2 else positions,
            mode="causal", cache=None, enc_out=None, impl=impl,
        )
        extras["mtp_hidden"] = rmsnorm(mp.final_norm, fused, cfg.rms_offset)

    return hn, new_caches, extras


def forward(
    params: Model,
    cfg: ArchConfig,
    batch: Dict,
    *,
    caches: Optional[Dict] = None,
    impl: str = "auto",
    remat: str = "none",
    want_mtp: bool = False,
) -> Tuple[torch.Tensor, Optional[Dict], Dict]:
    """Full-logits forward (tests/small models/serving). Training uses
    forward_hidden + chunked_ce instead."""
    hn, new_caches, extras = forward_hidden(
        params, cfg, batch, caches=caches, impl=impl, remat=remat, want_mtp=want_mtp
    )
    logits = _head(cfg, params, hn)
    if "mtp_hidden" in extras:
        extras["mtp_logits"] = _head(cfg, params, extras.pop("mtp_hidden"))
    return logits, new_caches, extras


def chunked_ce(
    cfg: ArchConfig,
    params: Model,
    hidden: torch.Tensor,
    labels: torch.Tensor,
    n_chunks: int = 1,
) -> torch.Tensor:
    """Masked CE without materializing (B, S, V) logits: the sequence is
    split into n_chunks, each chunk's logits are computed, reduced, and
    *rematerialized* in the backward pass (``torch.utils.checkpoint``, the
    reference's ``jax.checkpoint``), so live logits are (B, S/n, V). Under
    ``torch.profiler`` each chunk's recompute is the layer span
    ``train.recompute`` (:func:`repro_torch.obs.trace.checkpointed`).
    """
    b, s, d = hidden.shape
    while s % n_chunks:
        n_chunks -= 1  # largest divisor <= requested
    if n_chunks <= 1:
        return lm_loss(_head(cfg, params, hidden), labels)
    hc = hidden.reshape(b, n_chunks, s // n_chunks, d).transpose(0, 1)
    lc = labels.reshape(b, n_chunks, s // n_chunks).transpose(0, 1)

    def chunk_stats(h_chunk, l_chunk):
        # on a mesh the logits stay vocab-sharded (vocab_nll)
        nll = vocab_nll(_head(cfg, params, h_chunk).float(), l_chunk)
        mask = (l_chunk >= 0).float()
        return torch.sum(nll * mask), torch.sum(mask)

    tot = torch.zeros((), dtype=torch.float32, device=hidden.device)
    cnt = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for i in range(n_chunks):
        t, c = checkpoint(checkpointed, chunk_stats, hc[i], lc[i], use_reentrant=False)
        tot, cnt = tot + t, cnt + c
    return tot / torch.clamp(cnt, min=1.0)


# ---------------------------------------------------------------------------
# Loss
# ---------------------------------------------------------------------------
def lm_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Masked CE in f32; labels < 0 are ignored (vision slots, padding)."""
    nll = vocab_nll(logits.float(), labels)  # on a mesh the logits stay vocab-sharded
    mask = (labels >= 0).float()
    return torch.sum(nll * mask) / torch.clamp(mask.sum(), min=1.0)


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
