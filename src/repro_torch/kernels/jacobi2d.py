"""Jacobi-2D: 5-point average (paper workload). out = 0.2*(c+n+s+e+w)."""

from __future__ import annotations

import torch

from .stencil_common import stencil2d_call

NAME = "jacobi2d"
DIMS = 2
HALO = 1
FLOPS_PER_POINT = 5.0


def update(ext: torch.Tensor, h: int) -> torch.Tensor:
    """Interior update of a halo-extended array (leading axes batch)."""
    c = ext[..., h:-h, h:-h]
    n = ext[..., : -2 * h, h:-h]
    s = ext[..., 2 * h :, h:-h]
    w = ext[..., h:-h, : -2 * h]
    e = ext[..., h:-h, 2 * h :]
    return 0.2 * (c + n + s + e + w)


def step(x, block_rows=None):
    return stencil2d_call(x, NAME, update, HALO, block_rows)
