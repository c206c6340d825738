"""Gradient-2D: central-difference gradient magnitude.
out = sqrt(((e-w)/2)^2 + ((s-n)/2)^2)."""

from __future__ import annotations

import torch

from .stencil_common import stencil2d_call

NAME = "gradient2d"
DIMS = 2
HALO = 1
FLOPS_PER_POINT = 9.0


def update(ext: torch.Tensor, h: int) -> torch.Tensor:
    """Interior update of a halo-extended array (leading axes batch)."""
    n = ext[..., : -2 * h, h:-h]
    s = ext[..., 2 * h :, h:-h]
    w = ext[..., h:-h, : -2 * h]
    e = ext[..., h:-h, 2 * h :]
    gx = 0.5 * (e - w)
    gy = 0.5 * (s - n)
    return torch.sqrt(gx * gx + gy * gy)


def step(x, block_rows=None):
    return stencil2d_call(x, NAME, update, HALO, block_rows)
