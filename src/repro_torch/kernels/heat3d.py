"""Heat-3D: explicit 7-point diffusion step."""

from __future__ import annotations

import torch

from .stencil_common import stencil3d_call

NAME = "heat3d"
DIMS = 3
HALO = 1
ALPHA = 0.125
FLOPS_PER_POINT = 15.0


def update(ext: torch.Tensor, h: int) -> torch.Tensor:
    """Interior update of a halo-extended array (leading axes batch)."""
    c = ext[..., h:-h, h:-h, h:-h]
    u = ext[..., : -2 * h, h:-h, h:-h]
    d = ext[..., 2 * h :, h:-h, h:-h]
    n = ext[..., h:-h, : -2 * h, h:-h]
    s = ext[..., h:-h, 2 * h :, h:-h]
    w = ext[..., h:-h, h:-h, : -2 * h]
    e = ext[..., h:-h, h:-h, 2 * h :]
    return c + ALPHA * (u + d + n + s + e + w - 6.0 * c)


def step(x, block_rows=None):
    return stencil3d_call(x, NAME, update, HALO, block_rows)
