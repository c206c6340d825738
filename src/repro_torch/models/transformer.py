"""Block and stack parameters -- the init half of the JAX package's
``models/transformer.py``.

A *block* is a pre-norm mixer (attention or SSD) plus a pre-norm FFN (MLP
or MoE), with an optional cross-attention sublayer (enc-dec decoders). A
*stack* is a list of **segments** ``(pattern, repeats)``: the segment runs
``pattern * repeats`` layers. The reference stacks each pattern slot's
parameters over the repeats (one ``lax.scan`` body per slot); here a stack
is an ``nn.ModuleList`` with one :class:`Block` per layer, in execution
order, and :meth:`Stack.layer_index` maps (segment, repeat, slot) to it.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

from torch import nn

from ..configs.base import ArchConfig
from .attention import attn_init
from .layers import Init, mlp_init, rmsnorm_init
from .moe import moe_init
from .ssm import ssm_init

__all__ = ["segments", "block_init", "stack_init", "Block", "Stack"]

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


class Block(nn.Module):
    def __init__(self, init: Init, cfg: ArchConfig, mixer: str, ffn: str, dtype, cross: bool = False):
        super().__init__()
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


def block_init(init: Init, cfg: ArchConfig, mixer: str, ffn: str, dtype, cross: bool = False) -> Block:
    return Block(init, cfg, mixer, ffn, dtype, cross)


class Stack(nn.Module):
    """``layers[i]`` is the i-th layer the stack runs; ``segs`` is the
    reference's segment list it was built from."""

    def __init__(self, init: Init, cfg: ArchConfig, dtype, cross: bool = False,
                 segs: Optional[Segments] = None):
        super().__init__()
        self.segs = segs if segs is not None else segments(cfg)
        self.layers = nn.ModuleList(
            block_init(init, cfg, mixer, ffn, dtype, cross=cross)
            for pattern, reps in self.segs
            for _ in range(reps)
            for mixer, ffn in pattern
        )

    def layer_index(self, seg: int, rep: int, slot: int) -> int:
        """The layer that runs repeat ``rep`` of slot ``slot`` of segment
        ``seg`` (the reference's ``seg{seg}[slot]`` leaves, row ``rep``)."""
        start = sum(len(p) * r for p, r in self.segs[:seg])
        return start + rep * len(self.segs[seg][0]) + slot


def stack_init(init: Init, cfg: ArchConfig, dtype, *, cross: bool = False,
               segs: Optional[Segments] = None) -> Stack:
    return Stack(init, cfg, dtype, cross=cross, segs=segs)
