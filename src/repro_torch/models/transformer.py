"""Block and stack assembly -- the JAX package's ``models/transformer.py``.

A *block* is a pre-norm mixer (attention or SSD) plus a pre-norm FFN (MLP
or MoE), with an optional cross-attention sublayer (enc-dec decoders). A
*stack* is a list of **segments** ``(pattern, repeats)``: the segment runs
``pattern * repeats`` layers. The reference stacks each pattern slot's
parameters over the repeats and ``lax.scan``s them; here a stack is an
``nn.ModuleList`` with one :class:`Block` per layer, in execution order,
:func:`layer_index` maps (segment, repeat, slot) to it, and
:func:`stack_apply` walks the layers with the per-layer cache list that
:func:`repro_torch.serve.kvcache.init_caches` builds.

Rematerialization: :func:`stack_apply`'s ``remat`` takes the reference's
five policy names (:data:`REMAT_POLICIES`) and wraps each layer in
``torch.utils.checkpoint.checkpoint(use_reentrant=False)`` while autograd
records: ``"full"`` saves only the layer's input, ``"dots"`` and
``"dots_no_batch"`` are selective checkpoints that save the outputs of the
matrix products (``mm``/``addmm``/``bmm``/``baddbmm``; for
``"dots_no_batch"`` only the 2-D ``mm``/``addmm``, the products without
batch dimensions) and recompute the rest, and ``"save_block_io"``
checkpoints the mixer and the FFN sub-layers as two regions, so a block
keeps its sub-layer boundaries (the reference's ``mixer_out`` and
``ffn_out``) and recomputes what lies inside them. Remat changes memory,
never values. The reference maps an unknown name to full remat; here an
unknown name raises ``ValueError``.

Under ``torch.profiler`` the stack records two layer spans
(:func:`repro_torch.obs.trace.layer_span`):
``model.attention`` around a mixer's attention (its device time where grad
is enabled), and ``train.recompute`` around each recompute of a
checkpointed block or sub-layer, which the backward pass runs, with its
device time (:func:`repro_torch.obs.trace.checkpointed`).
"""

from __future__ import annotations

import functools
from typing import Dict, List, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint, create_selective_checkpoint_contexts

from ..configs.base import ArchConfig
from ..obs.trace import checkpointed, layer_span
from .attention import attention, attn_init
from .layers import Init, mlp, mlp_init, rmsnorm, rmsnorm_init
from .moe import moe_apply, moe_init
from .ssm import ssm_apply, ssm_init

__all__ = [
    "segments",
    "layer_index",
    "block_init",
    "block_apply",
    "stack_init",
    "stack_apply",
    "Block",
    "Stack",
    "REMAT_POLICIES",
]

_aten = torch.ops.aten
#: the reference's remat policy names -> the operations whose outputs a
#: layer's checkpoint saves (None: the layer is not checkpointed)
REMAT_POLICIES = {
    "none": None,
    "dots": (_aten.mm.default, _aten.addmm.default, _aten.bmm.default, _aten.baddbmm.default),
    "dots_no_batch": (_aten.mm.default, _aten.addmm.default),
    "full": (),  # the layer's input only
    "save_block_io": None,  # block_apply checkpoints each sub-layer instead
}

Segments = List[Tuple[Tuple[Tuple[str, str], ...], int]]


def segments(cfg: ArchConfig) -> Segments:
    """Decompose layer kinds into (pattern, repeats) segments."""
    kinds = list(cfg.layer_kinds())
    segs: Segments = []
    first_dense = cfg.moe.first_dense if cfg.moe else 0
    if first_dense:
        segs.append((tuple(kinds[:first_dense]), 1))
        kinds = kinds[first_dense:]
    n = len(kinds)
    for p in range(1, n + 1):
        if n % p:
            continue
        unit = kinds[:p]
        if kinds == unit * (n // p):
            segs.append((tuple(unit), n // p))
            break
    return segs


def layer_index(segs: Segments, seg: int, rep: int, slot: int) -> int:
    """The layer that runs repeat ``rep`` of slot ``slot`` of segment
    ``seg`` (the reference's ``seg{seg}[slot]`` leaves, row ``rep``)."""
    start = sum(len(p) * r for p, r in segs[:seg])
    return start + rep * len(segs[seg][0]) + slot


class Block(nn.Module):
    """``kind`` is the layer's ``(mixer, ffn)`` pair; ``cross`` says whether
    it has a cross-attention sublayer."""

    def __init__(self, init: Init, cfg: ArchConfig, mixer: str, ffn: str, dtype, cross: bool = False):
        super().__init__()
        self.cfg, self.kind, self.has_cross = cfg, (mixer, ffn), cross
        self.norm1 = rmsnorm_init(init, cfg.d_model, dtype, cfg.rms_offset)
        self.mixer = attn_init(init, cfg, dtype) if mixer == "attn" else ssm_init(init, cfg, dtype)
        if cross:
            self.norm_cross = rmsnorm_init(init, cfg.d_model, dtype, cfg.rms_offset)
            self.cross = attn_init(init, cfg, dtype, cross=True)
        if ffn != "none":
            self.norm2 = rmsnorm_init(init, cfg.d_model, dtype, cfg.rms_offset)
            self.ffn = (
                moe_init(init, cfg, dtype) if ffn == "moe"
                else mlp_init(init, cfg.d_model, cfg.d_ff, cfg.act, dtype)
            )

    def forward(self, x, *, positions, mode="causal", cache=None, enc_out=None, impl="auto"):
        return block_apply(self, self.cfg, *self.kind, x, positions=positions, mode=mode,
                           cache=cache, enc_out=enc_out, impl=impl, cross=self.has_cross)


def block_init(init: Init, cfg: ArchConfig, mixer: str, ffn: str, dtype, cross: bool = False) -> Block:
    return Block(init, cfg, mixer, ffn, dtype, cross)


class Stack(nn.Module):
    """``layers[i]`` is the i-th layer the stack runs; ``segs`` is the
    reference's segment list it was built from."""

    def __init__(self, init: Init, cfg: ArchConfig, dtype, cross: bool = False,
                 segs: Optional[Segments] = None):
        super().__init__()
        self.cfg, self.cross = cfg, cross
        self.segs = segs if segs is not None else segments(cfg)
        self.layers = nn.ModuleList(
            block_init(init, cfg, mixer, ffn, dtype, cross=cross)
            for pattern, reps in self.segs
            for _ in range(reps)
            for mixer, ffn in pattern
        )

    def forward(self, x, *, positions, mode="causal", caches=None, enc_out=None, impl="auto",
                remat="none"):
        return stack_apply(self, self.cfg, x, positions=positions, mode=mode, caches=caches,
                           enc_out=enc_out, impl=impl, remat=remat, cross=self.cross)


def stack_init(init: Init, cfg: ArchConfig, dtype, *, cross: bool = False,
               segs: Optional[Segments] = None) -> Stack:
    return Stack(init, cfg, dtype, cross=cross, segs=segs)


# ---------------------------------------------------------------------------
# Apply
# ---------------------------------------------------------------------------
def _mixer_sublayer(params: Block, cfg, mixer, x, positions, mode, cache, impl):
    h = rmsnorm(params.norm1, x, cfg.rms_offset)
    if mixer == "attn":
        # its device time only where grad is on: in a train step, not in decode
        with layer_span("model.attention", device=torch.is_grad_enabled()):
            return attention(params.mixer, cfg, h, positions=positions, mode=mode, cache=cache,
                             impl=impl)
    return ssm_apply(params.mixer, cfg, h, cache=cache)


def _cross_sublayer(params: Block, cfg, x, positions, cache, enc_out, impl):
    h = rmsnorm(params.norm_cross, x, cfg.rms_offset)
    return attention(params.cross, cfg, h, positions=positions, mode="cross", cache=cache,
                     kv_source=enc_out, impl=impl)


def _ffn_sublayer(params: Block, cfg, ffn, x):
    h = rmsnorm(params.norm2, x, cfg.rms_offset)
    if ffn == "moe":
        return moe_apply(params.ffn, cfg, h)
    return mlp(params.ffn, h, cfg.act), None


def block_apply(
    params: Block,
    cfg: ArchConfig,
    mixer: str,
    ffn: str,
    x: torch.Tensor,
    *,
    positions,
    mode: str,
    cache: Optional[Dict],
    enc_out: Optional[torch.Tensor],
    impl: str,
    cross: bool = False,
    remat_sublayers: bool = False,
):
    """Returns (x, new_cache, aux_loss). ``remat_sublayers`` checkpoints
    each sub-layer (remat ``"save_block_io"``)."""
    run = (lambda f, *a: checkpoint(checkpointed, f, *a, use_reentrant=False)) \
        if remat_sublayers else (lambda f, *a: f(*a))
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    new_cache: Dict = {}
    h, c = run(_mixer_sublayer, params, cfg, mixer, x, positions, mode,
               cache.get("mixer") if cache else None, impl)
    if c is not None:
        new_cache["mixer"] = c
    x = x + h
    if cross:
        h, c = run(_cross_sublayer, params, cfg, x, positions,
                   cache.get("cross") if cache else None, enc_out, impl)
        if c is not None:
            new_cache["cross"] = c
        x = x + h
    if ffn != "none":
        h, moe_aux = run(_ffn_sublayer, params, cfg, ffn, x)
        if moe_aux is not None:
            aux = moe_aux
        x = x + h
    return x, (new_cache or None), aux


def stack_apply(
    params: Stack,
    cfg: ArchConfig,
    x: torch.Tensor,
    *,
    positions,
    mode: str = "causal",
    caches: Optional[List[Dict]] = None,
    enc_out=None,
    impl: str = "auto",
    remat: str = "none",
    cross: bool = False,
):
    """Run the full stack. Returns (x, new_caches, aux_sum).

    ``caches`` is None (training) or one cache dict per layer, in the
    stack's execution order (``init_caches(...)["stack"]``); the layers
    update them in place and ``new_caches`` lists the same dicts.
    """
    if remat not in REMAT_POLICIES:
        raise ValueError(f"unknown remat policy {remat!r} (want one of {sorted(REMAT_POLICIES)})")
    # checkpoint only while autograd records: without a backward pass a
    # checkpoint would save nothing and only cost its bookkeeping
    saved = REMAT_POLICIES[remat]
    wrap = saved is not None and torch.is_grad_enabled()
    ckpt_kw = {"use_reentrant": False}
    if saved:
        ckpt_kw["context_fn"] = functools.partial(create_selective_checkpoint_contexts, list(saved))
    sublayers = remat == "save_block_io" and torch.is_grad_enabled()
    if caches is not None and len(caches) != len(params.layers):
        raise ValueError(f"{len(caches)} layer caches for {len(params.layers)} layers")
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    new_caches = [] if caches is not None else None
    for i, layer in enumerate(params.layers):
        kw = dict(positions=positions, mode=mode,
                  cache=caches[i] if caches is not None else None,
                  enc_out=enc_out, impl=impl, cross=cross, remat_sublayers=sublayers)
        if wrap:
            x, c_out, aux = checkpoint(checkpointed, block_apply, layer, cfg, *layer.kind, x,
                                       **ckpt_kw, **kw)
        else:
            x, c_out, aux = block_apply(layer, cfg, *layer.kind, x, **kw)
        aux_total = aux_total + aux
        if new_caches is not None:
            new_caches.append(c_out)
    return x, new_caches, aux_total
