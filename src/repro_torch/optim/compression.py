"""Gradient compression: int8 quantization with error feedback (the JAX
package's ``optim/compression.py``).

int8 cuts the bytes of a gradient reduction 4x against f32. Error feedback
keeps the long-run bias at zero: the residual e_t = g_t -
deq(quant(g_t + e_{t-1})) is added to the next step's gradient, so
quantization noise is a zero-mean perturbation instead of a systematic
truncation (Seide et al.; Karimireddy et al.).

:func:`compress_grads` is the transform inside the train step. The
reference's ``compressed_psum`` (the int8 all-reduce over a mesh axis) is a
collective and comes with the multi-device slice. Trees are as in
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

from .adamw import named_leaves

__all__ = [
    "quantize_int8",
    "dequantize_int8",
    "CompressionState",
    "compression_init",
    "compress_grads",
]


def _scale(xs: List[torch.Tensor]) -> torch.Tensor:
    peak = torch.max(torch.stack([torch.max(torch.abs(x)) for x in xs]))
    return torch.clamp(peak, min=1e-12) / 127.0


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
    return CompressionState(error={
        k: torch.zeros(g.shape, dtype=torch.float32, device=g.device)
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
    out = {}
    for names in groups if groups is not None else [[k] for k in flat_g]:
        corrected = [flat_g[k].float() + state.error[k] for k in names]
        scale = _scale(corrected)
        for k, c in zip(names, corrected):
            deq = dequantize_int8(_quantize(c, scale), scale)
            out[k] = deq.to(flat_g[k].dtype)
            state.error[k].copy_(c - deq)
    return out, state
