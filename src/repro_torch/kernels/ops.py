"""Public API over the one-step stencil kernels (K3/K4).

``stencil_run(name, x, steps)`` executes T time steps of the named stencil,
one launch per step on the card; ``block_rows`` defaults to
:func:`repro_torch.kernels.stencil_common.plan_block_rows` and can be
overridden. It never changes a value.
"""

from __future__ import annotations

from types import ModuleType
from typing import Dict

import torch

from . import gradient2d, heat2d, heat3d, jacobi2d, laplacian2d, laplacian3d
from .stencil_common import plan_block_rows, time_loop

__all__ = ["KERNELS", "stencil_step", "stencil_run", "kernel_flops", "tuned_block_rows"]

KERNELS: Dict[str, ModuleType] = {
    m.NAME: m
    for m in (jacobi2d, heat2d, laplacian2d, gradient2d, heat3d, laplacian3d)
}


def kernel_flops(name: str, shape, steps: int = 1) -> float:
    """Useful flops of a run (interior points only -- borders are copies)."""
    mod = KERNELS[name]
    interior = 1.0
    for d in shape:
        interior *= max(d - 2 * mod.HALO, 0)
    return mod.FLOPS_PER_POINT * interior * steps


def tuned_block_rows(name: str, shape, dtype) -> int:
    """The default band height of the one-step kernels."""
    del name  # every stencil has halo 1 and the same launch plan
    return plan_block_rows(shape, dtype)


def stencil_step(name: str, x: torch.Tensor, block_rows=None) -> torch.Tensor:
    """One stencil application."""
    return KERNELS[name].step(x, block_rows=block_rows)


def stencil_run(
    name: str, x: torch.Tensor, steps: int = 1, block_rows: int | None = None
) -> torch.Tensor:
    """T time steps of the named stencil (Dirichlet borders)."""
    mod = KERNELS[name]
    return time_loop(lambda v: mod.step(v, block_rows=block_rows), x, steps)
