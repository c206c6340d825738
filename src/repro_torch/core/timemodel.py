"""Analytical execution-time model for tiled stencils (eqs. 9-15).

The same model as the JAX package's ``core/timemodel.py``:

problem parameters  p = (S1, S2[, S3], T)        -- iteration-space extents
hardware parameters h = (n_SM, n_V, M_SM)        -- + GPU family constants
software parameters s = (t_S1, t_S2[, t_S3], t_T, k)

* hexagonal tiles on the (T, S1) plane: average width ``W = t_S1 + s*t_T``,
  max width ``W_max = t_S1 + 2*s*t_T`` (sigma = stencil radius);
* a tile is one threadblock of ``t_S2`` threads; 3D tiles walk ``t_S3``
  points per thread;
* compute time per co-resident group of k blocks:
  ``C_iter * t_T * W * t_S3 * ceil(k*t_S2/n_V)``;
* shared-memory footprint per tile:
  ``n_arr * (W_max+2s) * (t_S2+2s) * (t_S3+2s | 1) * 4`` bytes, feasible
  when ``k * footprint <= M_SM`` (eq. 11);
* ``T_alg = 2*ceil(T/t_T) * (batches*T_batch + launch_overhead)`` with
  ``T_batch = max(T_compute, n_active*footprint/BW)``.

Every evaluation function takes an array namespace ``xp``: ``numpy`` (the
default, float64 -- the oracle) or ``torch`` (float32 by default, on the
device of its tensor arguments or ``device=``). The body only branches in
Python on stencil *structure* (``st.dims``), never on array values, so one
expression serves a scalar, a (P, chunk, L) broadcast on the card, and an
autograd graph over the machine parameters (:mod:`repro_torch.measure
.calibrate`).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict

import numpy as np
import torch

from .._device import resolve_device

__all__ = [
    "StencilSpec",
    "GPUSpec",
    "ProblemSize",
    "STENCILS",
    "MAXWELL_GPU",
    "TITANX_GPU",
    "GPUS_BY_NAME",
    "footprint_bytes",
    "stencil_time",
    "stencil_gflops",
    "feasible",
    "with_machine_params",
    "with_c_iter",
]


@dataclasses.dataclass(frozen=True)
class StencilSpec:
    """Workload characterization of one stencil benchmark."""

    name: str
    dims: int  # spatial dimensions (2 or 3)
    radius: int  # sigma: halo width per time step
    flops_per_point: float
    n_arrays: int  # arrays resident in the tile footprint (in + out)
    c_iter: float  # seconds per iteration per thread (measured, §IV.B)


@dataclasses.dataclass(frozen=True)
class GPUSpec:
    """Family constants that are *not* design variables (paper §IV.A)."""

    name: str
    bw_gmem: float  # global-memory bandwidth, bytes/s
    max_threads_per_block: int = 1024
    max_threads_per_sm: int = 2048
    max_threadblocks_per_sm: int = 32  # MTB_SM, eq. (10)
    launch_overhead: float = 5.0e-6  # per-phase sync/launch, seconds
    bytes_per_word: int = 4  # fp32 stencils


@dataclasses.dataclass(frozen=True)
class ProblemSize:
    """Problem parameters p. ``s3 = 1`` for 2D stencils. Fields may be
    arrays or tensors (one column per batched problem size)."""

    s1: int
    s2: int
    t: int
    s3: int = 1

    @property
    def points(self) -> float:
        return float(self.s1) * self.s2 * self.s3 * self.t


#: The paper's six-benchmark suite (§IV.A), the same constants as the JAX
#: package's table (C_iter calibrated to the GTX-980 magnitude range).
STENCILS: Dict[str, StencilSpec] = {
    "jacobi2d": StencilSpec("jacobi2d", 2, 1, 5.0, 2, 4.0e-9),
    "heat2d": StencilSpec("heat2d", 2, 1, 10.0, 2, 5.5e-9),
    "laplacian2d": StencilSpec("laplacian2d", 2, 1, 6.0, 2, 4.0e-9),
    "gradient2d": StencilSpec("gradient2d", 2, 1, 9.0, 2, 4.5e-9),
    "heat3d": StencilSpec("heat3d", 3, 1, 15.0, 2, 7.0e-9),
    "laplacian3d": StencilSpec("laplacian3d", 3, 1, 8.0, 2, 6.0e-9),
}

MAXWELL_GPU = GPUSpec(name="gtx980", bw_gmem=224.0e9)
TITANX_GPU = GPUSpec(name="titanx", bw_gmem=336.0e9)

#: name -> datasheet-spec registry (the calibration fit's frame lookup).
GPUS_BY_NAME: Dict[str, GPUSpec] = {g.name: g for g in (MAXWELL_GPU, TITANX_GPU)}


def with_machine_params(gpu: GPUSpec, bw_gmem=None, launch_overhead=None, name=None):
    """A copy of ``gpu`` with refitted measured machine parameters (values
    may be tensors that require grad: the fit differentiates through
    :func:`stencil_time` on such a spec)."""
    updates: Dict[str, object] = {}
    if bw_gmem is not None:
        updates["bw_gmem"] = bw_gmem
    if launch_overhead is not None:
        updates["launch_overhead"] = launch_overhead
    if name is not None:
        updates["name"] = name
    return dataclasses.replace(gpu, **updates)


def with_c_iter(st: StencilSpec, c_iter):
    """A copy of ``st`` with a refitted per-iteration compute cost."""
    return dataclasses.replace(st, c_iter=c_iter)


class _NumpyOps:
    """numpy namespace at one dtype (float64 unless asked)."""

    inf = np.inf

    def __init__(self, dtype):
        self.dtype = np.float64 if dtype is None else dtype

    def asarray(self, v):
        return np.asarray(v, self.dtype)

    ceil = staticmethod(np.ceil)
    maximum = staticmethod(np.maximum)
    minimum = staticmethod(np.minimum)
    mod = staticmethod(np.mod)
    ones_like = staticmethod(np.ones_like)
    where = staticmethod(np.where)


class _TorchOps:
    """torch namespace at one dtype and device. ``asarray`` keeps a tensor
    that already has them (and its autograd graph); scalars and numpy
    arrays are placed on the device, so no CPU array meets a CUDA one."""

    inf = math.inf

    def __init__(self, dtype, device):
        self.dtype = torch.float32 if dtype is None else dtype
        self.device = device

    def asarray(self, v):
        return torch.as_tensor(v, dtype=self.dtype, device=self.device)

    ceil = staticmethod(torch.ceil)
    ones_like = staticmethod(torch.ones_like)

    # a Python-number operand stays a scalar argument: no 0-d tensor is
    # copied to the device for it
    def maximum(self, a, b):
        if isinstance(b, (int, float)):
            return torch.clamp(self.asarray(a), min=b)
        return torch.maximum(self.asarray(a), self.asarray(b))

    def minimum(self, a, b):
        return torch.minimum(self.asarray(a), self.asarray(b))

    def mod(self, a, b):
        return torch.remainder(self.asarray(a), self.asarray(b))

    def where(self, ok, a, b):
        if isinstance(b, (int, float)):
            return torch.where(ok, self.asarray(a), b)
        return torch.where(ok, self.asarray(a), self.asarray(b))


def _ops(xp, dtype, device, *args):
    """The namespace for ``xp`` (numpy or torch). For torch, ``device``
    defaults to the device of the first tensor argument, else the card
    (:func:`repro_torch._device.resolve_device`: it raises without one,
    so nothing runs on the CPU unless a CPU tensor or ``device="cpu"``
    asked for it)."""
    if xp is np:
        return _NumpyOps(dtype)
    if xp is not torch:
        raise TypeError(f"xp must be numpy or torch, got {xp!r}")
    if device is None:
        device = next(
            (a.device for a in args if isinstance(a, torch.Tensor)), None
        )
    return _TorchOps(dtype, resolve_device(device))


def _ceil_div(ops, a, b):
    return ops.ceil(a / b)


def _footprint(ops, st: StencilSpec, gpu: GPUSpec, t_s1, t_s2, t_t, t_s3):
    s = st.radius
    t_s1, t_s2, t_t, t_s3 = (ops.asarray(v) for v in (t_s1, t_s2, t_t, t_s3))
    w_max = t_s1 + 2.0 * s * t_t
    # static branch on stencil structure -- never on array values
    depth = t_s3 + 2.0 * s if st.dims == 3 else ops.ones_like(t_s3)
    return (
        st.n_arrays
        * (w_max + 2.0 * s)
        * (t_s2 + 2.0 * s)
        * depth
        * gpu.bytes_per_word
    )


def footprint_bytes(
    st: StencilSpec, gpu: GPUSpec, t_s1, t_s2, t_t, t_s3=1, *, xp=np, dtype=None,
    device=None,
):
    """Shared-memory bytes needed by one tile (halo-expanded, all arrays)."""
    ops = _ops(xp, dtype, device, t_s1, t_s2, t_t, t_s3)
    return _footprint(ops, st, gpu, t_s1, t_s2, t_t, t_s3)


def _feasible(ops, st, gpu, m_sm, t_s1, t_s2, t_t, k, t_s3):
    t_s2 = ops.asarray(t_s2)
    t_t = ops.asarray(t_t)
    k = ops.asarray(k)
    fp = _footprint(ops, st, gpu, t_s1, t_s2, t_t, t_s3)
    ok = k * fp <= ops.asarray(m_sm) * 1024.0  # eq. (11) [& (9)]
    ok = ok & (k <= gpu.max_threadblocks_per_sm)  # eq. (10)
    ok = ok & (t_s2 <= gpu.max_threads_per_block)
    ok = ok & (k * t_s2 <= gpu.max_threads_per_sm)
    ok = ok & (t_t % 2 == 0)  # eq. (15): t_T even (HHC)
    ok = ok & (t_s2 % 32 == 0)  # eq. (13): full warps
    return ok


def feasible(
    st: StencilSpec,
    gpu: GPUSpec,
    n_sm,
    n_v,
    m_sm,
    t_s1,
    t_s2,
    t_t,
    k,
    t_s3=1,
    *,
    xp=np,
    dtype=None,
    device=None,
):
    """Feasibility mask, eqs. (9)-(15). Broadcasts over array inputs."""
    ops = _ops(xp, dtype, device, n_sm, n_v, m_sm, t_s1, t_s2, t_t, k, t_s3)
    return _feasible(ops, st, gpu, m_sm, t_s1, t_s2, t_t, k, t_s3)


def stencil_time(
    st: StencilSpec,
    gpu: GPUSpec,
    size: ProblemSize,
    n_sm,
    n_v,
    m_sm,
    t_s1,
    t_s2,
    t_t,
    k,
    t_s3=1,
    *,
    xp=np,
    dtype=None,
    device=None,
):
    """T_alg in seconds. Infeasible points get +inf. Fully vectorized."""
    ops = _ops(
        xp, dtype, device, n_sm, n_v, m_sm, t_s1, t_s2, t_t, k, t_s3,
        size.s1, size.s2, size.s3, size.t,
    )
    n_sm = ops.asarray(n_sm)
    n_v = ops.asarray(n_v)
    t_s1 = ops.asarray(t_s1)
    t_s2 = ops.asarray(t_s2)
    t_t = ops.asarray(t_t)
    k = ops.asarray(k)
    t_s3 = ops.asarray(t_s3)
    s1 = ops.asarray(size.s1)
    s2 = ops.asarray(size.s2)
    s3 = ops.asarray(size.s3)
    t_total = ops.asarray(size.t)
    s = st.radius

    w_avg = t_s1 + s * t_t
    fp = _footprint(ops, st, gpu, t_s1, t_s2, t_t, t_s3)

    # --- compute time of one co-resident group (k blocks -> k tiles done).
    serial = ops.ceil(k * t_s2 / n_v)
    t_compute = st.c_iter * t_t * w_avg * t_s3 * serial

    # --- phase structure.
    tiles_phase = (
        ops.ceil(_ceil_div(ops, s1, w_avg) / 2.0)
        * _ceil_div(ops, s2, t_s2)
        * (_ceil_div(ops, s3, t_s3) if st.dims == 3 else 1.0)
    )
    tiles_phase = ops.maximum(tiles_phase, 1.0)
    concurrent = ops.minimum(k * n_sm, tiles_phase)
    batches = _ceil_div(ops, tiles_phase, k * n_sm)

    # --- per-batch: all concurrent tiles' global traffic shares BW.
    t_mem = concurrent * fp / gpu.bw_gmem
    t_batch = ops.maximum(t_compute, t_mem)

    phases = 2.0 * _ceil_div(ops, t_total, t_t)
    t_alg = phases * (batches * t_batch + gpu.launch_overhead)

    ok = _feasible(ops, st, gpu, m_sm, t_s1, t_s2, t_t, k, t_s3)
    return ops.where(ok, t_alg, ops.inf)


def stencil_gflops(st: StencilSpec, size: ProblemSize, t_alg_seconds):
    """Achieved GFLOP/s given a T_alg (broadcasts; numpy)."""
    total = st.flops_per_point * size.points
    return total / np.asarray(t_alg_seconds) / 1.0e9
