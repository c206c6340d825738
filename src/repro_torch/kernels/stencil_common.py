"""One-step stencil kernels K3 (2-D) and K4 (3-D), and their plain versions.

Replaces ``stencil2d_call`` / ``_stencil2d_kernel`` and ``stencil3d_call``
/ ``_stencil3d_kernel`` of the JAX package's ``kernels/stencil_common.py``:
one Dirichlet step over the whole array, arithmetic in f32, stored in the
input dtype, border cells copied through.

On the card (``csrc/step.cu``) a 2-D grid of blocks covers ``block_rows``
rows (3-D: planes) x 128 columns (3-D: 128 positions of the flattened
plane); each thread walks its column down the band and reads its
neighbours from device memory through L1/L2. The kernel stages nothing in
shared memory, so ``block_rows`` is not a memory-fit solve as on the TPU:
it sets how many cells each thread updates, and with it how often halo
rows are read again from L2 (``(block_rows + 2) / block_rows``) against
how many blocks there are to fill the SMs. :func:`plan_block_rows` keeps
at least :data:`MIN_BLOCKS` blocks and at most :data:`MAX_BLOCK_ROWS` rows.
``block_rows`` never changes a value.

A CUDA tensor launches the kernel (or raises); a CPU tensor takes the
plain version.
"""

from __future__ import annotations

from typing import Callable

import torch

from . import _build

__all__ = [
    "stencil2d_call",
    "stencil3d_call",
    "step_plain",
    "plan_block_rows",
    "time_loop",
    "edge_pad",
]

#: columns (3-D: flattened plane positions) per block -- csrc/step.cu COLS
BLOCK_COLS = 128
#: H100 SXM streaming multiprocessors; the plan keeps 4 blocks per SM
MIN_BLOCKS = 4 * 132
MAX_BLOCK_ROWS = 8
_MAX_GRID_Y = 65535


def plan_block_rows(shape, dtype=None) -> int:
    """Band height for the one-step kernels: the largest power of two up to
    :data:`MAX_BLOCK_ROWS` that still gives :data:`MIN_BLOCKS` blocks (or 1).
    ``dtype`` does not enter: nothing is staged in shared memory."""
    del dtype
    rows = int(shape[0])
    plane = 1
    for d in shape[1:]:
        plane *= int(d)
    col_blocks = -(-plane // BLOCK_COLS)
    br = MAX_BLOCK_ROWS
    while br > 1 and col_blocks * -(-rows // br) < MIN_BLOCKS:
        br //= 2
    return max(1, min(br, rows))


def edge_pad(v: torch.Tensor, h: int, ndim: int) -> torch.Tensor:
    """Pad the last ``ndim`` axes of ``v`` by ``h`` cells, replicating the
    edge (``jnp.pad(mode="edge")``)."""
    for ax in range(v.dim() - ndim, v.dim()):
        n = v.shape[ax]
        idx = torch.arange(-h, n + h, device=v.device).clamp_(0, n - 1)
        v = v.index_select(ax, idx)
    return v


def _boundary(shape, halo: int, device) -> torch.Tensor:
    mask = torch.zeros(shape, dtype=torch.bool, device=device)
    for ax, n in enumerate(shape):
        i = torch.arange(n, device=device)
        edge = (i < halo) | (i >= n - halo)
        mask |= edge.view([-1 if a == ax else 1 for a in range(len(shape))])
    return mask


def step_plain(x: torch.Tensor, update: Callable, halo: int) -> torch.Tensor:
    """Plain version of K3/K4: one step, f32 arithmetic, borders copied."""
    x32 = x.to(torch.float32)
    new = update(edge_pad(x32, halo, x.dim()), halo)
    return torch.where(_boundary(x.shape, halo, x.device), x32, new).to(x.dtype)


def _launch(x: torch.Tensor, name: str, halo: int, block_rows: int) -> torch.Tensor:
    kernel = "step3d" if x.dim() == 3 else "step2d"
    out, dtype_id = _build.cuda_args(x, kernel)
    plane = x[0].numel()
    bands = -(-x.shape[0] // block_rows)
    if bands > _MAX_GRID_Y:
        raise ValueError(
            f"{kernel}: {bands} bands of {block_rows} rows exceed the grid's "
            f"{_MAX_GRID_Y}; raise block_rows"
        )
    lib = _build.library("step")
    sid = _build.STENCIL_IDS[name]
    with torch.cuda.device(x.device):
        stream = _build.stream_of(x)
        if x.dim() == 2:
            rc = lib.repro_step2d(
                x.data_ptr(), out.data_ptr(), dtype_id, sid, x.shape[0], plane,
                halo, block_rows, stream,
            )
        else:
            rc = lib.repro_step3d(
                x.data_ptr(), out.data_ptr(), dtype_id, sid, *x.shape, halo,
                block_rows, stream,
            )
    _build.check(lib, rc, kernel)
    _build.LAUNCHES[kernel] += 1
    return out


def _call(x, dims, name, update, halo, block_rows):
    if x.dim() != dims:
        raise ValueError(f"{name}: expected a {dims}-D array, got shape {tuple(x.shape)}")
    if block_rows is None:
        block_rows = plan_block_rows(x.shape, x.dtype)
    if block_rows < 1:
        raise ValueError(f"block_rows must be >= 1, got {block_rows}")
    block_rows = min(int(block_rows), x.shape[0])
    if x.is_cuda:
        return _launch(x, name, halo, block_rows)
    if x.device.type != "cpu":
        raise ValueError(f"{name}: unsupported device {x.device}")
    return step_plain(x, update, halo)


def stencil2d_call(
    x: torch.Tensor, name: str, update: Callable, halo: int = 1, block_rows=None
) -> torch.Tensor:
    """One step of the named 2-D stencil: K3 on a CUDA tensor, the plain
    version (``update``) on a CPU tensor."""
    return _call(x, 2, name, update, halo, block_rows)


def stencil3d_call(
    x: torch.Tensor, name: str, update: Callable, halo: int = 1, block_rows=None
) -> torch.Tensor:
    """One step of the named 3-D stencil, banded on the leading axis: K4 on
    a CUDA tensor, the plain version on a CPU tensor."""
    return _call(x, 3, name, update, halo, block_rows)


def time_loop(step: Callable, x: torch.Tensor, steps: int) -> torch.Tensor:
    """Apply ``step`` ``steps`` times (the stencil time dimension T): one
    launch per step on the card."""
    for _ in range(steps):
        x = step(x)
    return x
