"""Gradient compression: int8 quantization with error feedback (the JAX
package's ``optim/compression.py``).

int8 cuts the bytes of a gradient reduction 4x against f32. Error feedback
keeps the long-run bias at zero: the residual e_t = g_t -
deq(quant(g_t + e_{t-1})) is added to the next step's gradient, so
quantization noise is a zero-mean perturbation instead of a systematic
truncation (Seide et al.; Karimireddy et al.).

:func:`compress_grads` is the transform inside the train step.
:func:`compressed_psum` is the int8 all-reduce over one mesh dim's
process group (the reference's ``compressed_psum`` over a mesh axis name,
inside ``shard_map``). Trees are as in
:mod:`repro_torch.optim.adamw`: a module or a flat dict of tensors; the
residuals are a dict keyed by the same names.

The reference quantizes each leaf of its tree with one scale, and its
stacked leaves span every repeat of a segment: ``groups`` names the port
tensors that form one such leaf (one per layer), and they share one scale
(:func:`repro_torch.models.convert.reference_layout`).
"""

from __future__ import annotations

from typing import Any, Dict, List, NamedTuple, Optional, Sequence, Tuple

import torch
from torch.distributed.tensor import DTensor

from .adamw import named_leaves

__all__ = [
    "quantize_int8",
    "dequantize_int8",
    "CompressionState",
    "compression_init",
    "compress_grads",
    "compressed_psum",
]


def _scale(xs: List[torch.Tensor], over_ranks: bool = False) -> torch.Tensor:
    """The shared scale of ``xs``; ``over_ranks``: the ``xs`` are local
    shards, and the peak is agreed over every rank (MAX)."""
    peak = torch.max(torch.stack([torch.max(torch.abs(x)) for x in xs]))
    if over_ranks:
        import torch.distributed as dist

        dist.all_reduce(peak, op=dist.ReduceOp.MAX)
    return torch.clamp(peak, min=1e-12) / 127.0


def _local(t: torch.Tensor) -> torch.Tensor:
    return t.to_local() if isinstance(t, DTensor) else t


def _like(ref: torch.Tensor, local: torch.Tensor) -> torch.Tensor:
    """``local`` as a tensor laid out like ``ref`` (a DTensor's shard)."""
    if not isinstance(ref, DTensor):
        return local
    return DTensor.from_local(local, ref.device_mesh, ref.placements, shape=ref.shape,
                              stride=ref.stride())


def _quantize(xf: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    # torch.round rounds half to even, as jnp.round does
    return torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)


def quantize_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-tensor int8. Returns (q int8, scale f32 scalar)."""
    xf = x.float()
    scale = _scale([xf])
    return _quantize(xf, scale), scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


class CompressionState(NamedTuple):
    error: Dict[str, torch.Tensor]  # f32 residuals, keyed as the grads


def compression_init(grads_like: Any) -> CompressionState:
    """Zero f32 residuals beside every leaf (DTensors of the leaf's layout
    for DTensor leaves)."""
    return CompressionState(error={
        k: torch.zeros_like(g, dtype=torch.float32) if isinstance(g, DTensor)
        else torch.zeros(g.shape, dtype=torch.float32, device=g.device)
        for k, g in named_leaves(grads_like).items()
    })


@torch.no_grad()
def compress_grads(
    grads: Any, state: Optional[CompressionState],
    groups: Optional[Sequence[Sequence[str]]] = None,
) -> Tuple[Dict[str, torch.Tensor], CompressionState]:
    """Quantize-dequantize each gradient leaf with error feedback, the
    leaves of a group (default: each leaf alone) under one scale. Returns
    the dequantized grads (each in its grad's dtype) and the new state,
    whose residuals are written in place into ``state.error``."""
    flat_g = named_leaves(grads)
    if state is None:
        state = compression_init(flat_g)
    # on a mesh the grads and residuals are DTensors of one layout: each
    # rank quantizes its shards under the scale agreed over all ranks
    over_ranks = any(isinstance(g, DTensor) for g in flat_g.values())
    out = {}
    for names in groups if groups is not None else [[k] for k in flat_g]:
        corrected = [_local(flat_g[k]).float() + _local(state.error[k]) for k in names]
        scale = _scale(corrected, over_ranks)
        for k, c in zip(names, corrected):
            deq = dequantize_int8(_quantize(c, scale), scale)
            out[k] = _like(flat_g[k], deq.to(flat_g[k].dtype))
            _local(state.error[k]).copy_(c - deq)
    return out, state


@torch.no_grad()
def compressed_psum(x: torch.Tensor, group=None) -> torch.Tensor:
    """The int8 all-reduce of ``x`` over ``group`` (a process group, e.g.
    ``mesh.get_group("pod")``; ``None`` is the default group).

    A shared quantization scale is agreed with one scalar ``all_reduce``
    (MAX) of the local ``max |x|`` -- ``max(., 1e-12) / 127`` --, then the
    int8 payloads are summed exactly in int32: each participant ships ~1/4
    the bytes of an f32 all-reduce, and the result (f32) is exactly the sum
    of the per-rank quantized values, bit for bit the reference's (error
    feedback at the caller absorbs the quantization residual)."""
    import torch.distributed as dist

    xf = x.float()
    peak = torch.max(torch.abs(xf)) if xf.numel() else xf.new_zeros(())
    dist.all_reduce(peak, op=dist.ReduceOp.MAX, group=group)
    scale = torch.clamp(peak, min=1e-12) / 127.0
    total = _quantize(xf, scale).to(torch.int32)
    dist.all_reduce(total, op=dist.ReduceOp.SUM, group=group)
    return total.to(torch.float32) * scale
