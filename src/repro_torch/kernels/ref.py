"""Eager-torch oracles for the stencil kernels.

Written independently of the kernel bodies (interior slicing on the full
array, Dirichlet borders by assigning only the interior of a copy), so the
allclose tests are a genuine cross-check, not a tautology. Like the
kernels, arithmetic is done in f32 (bf16 and float64 inputs are converted)
and the result is returned in the input dtype.
"""

from __future__ import annotations

from typing import Callable, Dict

import torch

__all__ = ["REF_STEPS", "run_ref"]


def _with_interior(x: torch.Tensor, new: torch.Tensor, dtype) -> torch.Tensor:
    out = x.clone()
    out[(slice(1, -1),) * x.dim()] = new
    return out.to(dtype)


def jacobi2d(x0: torch.Tensor) -> torch.Tensor:
    x = x0.to(torch.float32)
    i = x[1:-1, 1:-1]
    new = 0.2 * (i + x[:-2, 1:-1] + x[2:, 1:-1] + x[1:-1, :-2] + x[1:-1, 2:])
    return _with_interior(x, new, x0.dtype)


def heat2d(x0: torch.Tensor) -> torch.Tensor:
    x = x0.to(torch.float32)
    i = x[1:-1, 1:-1]
    lap = x[:-2, 1:-1] + x[2:, 1:-1] + x[1:-1, :-2] + x[1:-1, 2:] - 4.0 * i
    return _with_interior(x, i + 0.125 * lap, x0.dtype)


def laplacian2d(x0: torch.Tensor) -> torch.Tensor:
    x = x0.to(torch.float32)
    i = x[1:-1, 1:-1]
    new = x[:-2, 1:-1] + x[2:, 1:-1] + x[1:-1, :-2] + x[1:-1, 2:] - 4.0 * i
    return _with_interior(x, new, x0.dtype)


def gradient2d(x0: torch.Tensor) -> torch.Tensor:
    x = x0.to(torch.float32)
    gx = 0.5 * (x[1:-1, 2:] - x[1:-1, :-2])
    gy = 0.5 * (x[2:, 1:-1] - x[:-2, 1:-1])
    return _with_interior(x, torch.sqrt(gx * gx + gy * gy), x0.dtype)


def _lap3d(x: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    return (
        x[:-2, 1:-1, 1:-1]
        + x[2:, 1:-1, 1:-1]
        + x[1:-1, :-2, 1:-1]
        + x[1:-1, 2:, 1:-1]
        + x[1:-1, 1:-1, :-2]
        + x[1:-1, 1:-1, 2:]
        - 6.0 * i
    )


def heat3d(x0: torch.Tensor) -> torch.Tensor:
    x = x0.to(torch.float32)
    i = x[1:-1, 1:-1, 1:-1]
    return _with_interior(x, i + 0.125 * _lap3d(x, i), x0.dtype)


def laplacian3d(x0: torch.Tensor) -> torch.Tensor:
    x = x0.to(torch.float32)
    i = x[1:-1, 1:-1, 1:-1]
    return _with_interior(x, _lap3d(x, i), x0.dtype)


REF_STEPS: Dict[str, Callable] = {
    "jacobi2d": jacobi2d,
    "heat2d": heat2d,
    "laplacian2d": laplacian2d,
    "gradient2d": gradient2d,
    "heat3d": heat3d,
    "laplacian3d": laplacian3d,
}


def run_ref(name: str, x: torch.Tensor, steps: int = 1) -> torch.Tensor:
    f = REF_STEPS[name]
    for _ in range(steps):
        x = f(x)
    return x
