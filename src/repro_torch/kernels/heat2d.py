"""Heat-2D: explicit 5-point diffusion step. out = c + a*(n+s+e+w-4c)."""

from __future__ import annotations

import torch

from .stencil_common import stencil2d_call

NAME = "heat2d"
DIMS = 2
HALO = 1
ALPHA = 0.125
FLOPS_PER_POINT = 10.0


def update(ext: torch.Tensor, h: int) -> torch.Tensor:
    """Interior update of a halo-extended array (leading axes batch)."""
    c = ext[..., h:-h, h:-h]
    n = ext[..., : -2 * h, h:-h]
    s = ext[..., 2 * h :, h:-h]
    w = ext[..., h:-h, : -2 * h]
    e = ext[..., h:-h, 2 * h :]
    return c + ALPHA * (n + s + e + w - 4.0 * c)


def step(x, block_rows=None):
    return stencil2d_call(x, NAME, update, HALO, block_rows)
