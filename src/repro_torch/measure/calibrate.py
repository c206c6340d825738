"""Refit the time model's machine parameters from measurements.

The same fit as the JAX package's ``measure/calibrate.py``: nonlinear least
squares in log space over per-stencil ``C_iter``, global-memory bandwidth
and launch overhead::

    theta = log([C_iter(st_1) ... C_iter(st_n), bw_gmem, launch_overhead])
    loss(theta) = mean_r (log T_model(r; theta) - log T_measured(r))^2

The model is evaluated with ``xp=torch`` in float32 on specs carrying
``theta``-derived tensors, and autograd differentiates through it (the
floor/ceil terms do not depend on ``theta``; ``torch.ceil`` has zero
gradient, as in JAX). The descent is the reference's Adam update written
out by hand (not ``torch.optim.Adam``), so both packages take the same
steps. Stencils that share (dims, radius, n_arrays) are evaluated as one
batch with a per-record ``C_iter``. The ``iters`` eager iterations, each a
few dozen small kernels, are launch-bound on the card.

Records the model deems infeasible at their hardware point do not depend
on ``theta``; they are dropped up front and counted, so ``where`` never
selects an infinity inside the loss.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from .._device import resolve_device
from ..core.timemodel import (
    GPUS_BY_NAME,
    MAXWELL_GPU,
    STENCILS,
    GPUSpec,
    ProblemSize,
    StencilSpec,
    stencil_time,
    with_c_iter,
    with_machine_params,
)
from ..core.workload import Workload, WorkloadCell, paper_sizes
from ..kernels.tiled_stencils import TILE_NAMES
from .harness import MeasurementRecord, MeasurementRun, feasible_tiles

__all__ = [
    "RECOVERY_RTOL",
    "CalibrationResult",
    "predicted_times",
    "fit_machine_params",
    "synthetic_records",
]

#: synthetic recovery: fitting model-generated timings from perturbed
#: starting parameters must land every parameter within this relative
#: error of the generating machine (the JAX package's constant).
RECOVERY_RTOL = 0.05


def _group_arrays(
    records: Sequence[MeasurementRecord],
) -> Dict[str, Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]]:
    """stencil -> (hw (P,3), sizes (P,4) as (s1,s2,s3,t), tiles (P,5),
    measured times (P,)), in first-appearance order."""
    groups: Dict[str, List[MeasurementRecord]] = {}
    for r in records:
        groups.setdefault(r.stencil, []).append(r)
    out = {}
    for name, rs in groups.items():
        out[name] = (
            np.array([r.hw for r in rs], np.float64),
            np.array([r.size for r in rs], np.float64),
            np.array([r.tiles for r in rs], np.float64),
            np.array([r.time_s for r in rs], np.float64),
        )
    return out


def _model_times(st, gpu, hw, sizes, tiles, xp=np, dtype=None):
    """Vectorized T_alg for (P,) records of one stencil."""
    size = ProblemSize(s1=sizes[:, 0], s2=sizes[:, 1], t=sizes[:, 3], s3=sizes[:, 2])
    return stencil_time(
        st, gpu, size, hw[:, 0], hw[:, 1], hw[:, 2],
        tiles[:, 0], tiles[:, 1], tiles[:, 2], tiles[:, 3], tiles[:, 4],
        xp=xp, dtype=dtype,
    )


def predicted_times(
    records: Sequence[MeasurementRecord],
    gpu: GPUSpec,
    stencils: Optional[Mapping[str, StencilSpec]] = None,
) -> np.ndarray:
    """Model predictions (float64 numpy) for each record, in order;
    infeasible configurations get ``+inf``."""
    stencils = dict(STENCILS if stencils is None else stencils)
    out = np.empty(len(records), np.float64)
    index: Dict[str, List[int]] = {}
    for i, r in enumerate(records):
        index.setdefault(r.stencil, []).append(i)
    for name, (hw, sizes, tiles, _) in _group_arrays(records).items():
        out[index[name]] = _model_times(stencils[name], gpu, hw, sizes, tiles)
    return out


@dataclasses.dataclass
class CalibrationResult:
    """Fitted machine parameters plus the before/after error report."""

    gpu0: GPUSpec  # datasheet constants the fit started from
    gpu: GPUSpec  # refitted (bw_gmem, launch_overhead)
    stencils: Dict[str, StencilSpec]  # refitted c_iter per measured stencil
    errors_before: Dict[str, float]  # per-stencil mean |rel err|, datasheet
    errors_after: Dict[str, float]  # ... refitted
    loss_before: float  # mean squared log residual
    loss_after: float
    n_records: int
    n_dropped: int  # model-infeasible records excluded from the fit
    iters: int
    learning_rate: float

    def param_rel_error(self, target_gpu: GPUSpec,
                        target_stencils: Mapping[str, StencilSpec]) -> float:
        """Max relative error of the fitted parameters vs a known truth."""
        errs = [
            abs(self.gpu.bw_gmem - target_gpu.bw_gmem) / target_gpu.bw_gmem,
            abs(self.gpu.launch_overhead - target_gpu.launch_overhead)
            / target_gpu.launch_overhead,
        ]
        for name, st in self.stencils.items():
            truth = target_stencils[name].c_iter
            errs.append(abs(st.c_iter - truth) / truth)
        return float(max(errs))

    def calibrated_gpu(self, name: Optional[str] = None) -> GPUSpec:
        """The refitted GPUSpec under a distinguishable name."""
        return with_machine_params(
            self.gpu, name=name or f"{self.gpu0.name}-cal"
        )

    def calibrated_workload(
        self,
        stencil_names: Optional[Sequence[str]] = None,
        name: str = "paper-uniform-cal",
    ) -> Workload:
        """The paper's uniform workload rebuilt on the refitted specs."""
        names = list(stencil_names or self.stencils)
        missing = [n for n in names if n not in self.stencils]
        if missing:
            raise KeyError(f"stencil(s) {missing} were not calibrated")
        cells: List[WorkloadCell] = []
        for n in names:
            st = self.stencils[n]
            sizes = paper_sizes(st.dims)
            for sz in sizes:
                cells.append(WorkloadCell(st, sz, 1.0 / (len(names) * len(sizes))))
        return Workload(name=name, cells=tuple(cells))

    def to_payload(self) -> dict:
        """Plain-JSON payload, the same keys as the JAX package's."""
        return {
            "gpu0": dataclasses.asdict(self.gpu0),
            "gpu": dataclasses.asdict(self.gpu),
            "stencils": {
                n: dataclasses.asdict(st) for n, st in sorted(self.stencils.items())
            },
            "errors_before": {k: float(v) for k, v in sorted(self.errors_before.items())},
            "errors_after": {k: float(v) for k, v in sorted(self.errors_after.items())},
            "loss_before": float(self.loss_before),
            "loss_after": float(self.loss_after),
            "n_records": int(self.n_records),
            "n_dropped": int(self.n_dropped),
            "iters": int(self.iters),
            "learning_rate": float(self.learning_rate),
        }

    @classmethod
    def from_payload(cls, obj: Mapping) -> "CalibrationResult":
        return cls(
            gpu0=GPUSpec(**obj["gpu0"]),
            gpu=GPUSpec(**obj["gpu"]),
            stencils={n: StencilSpec(**d) for n, d in obj["stencils"].items()},
            errors_before=dict(obj["errors_before"]),
            errors_after=dict(obj["errors_after"]),
            loss_before=float(obj["loss_before"]),
            loss_after=float(obj["loss_after"]),
            n_records=int(obj["n_records"]),
            n_dropped=int(obj["n_dropped"]),
            iters=int(obj["iters"]),
            learning_rate=float(obj["learning_rate"]),
        )


def _rel_errors(records, gpu, stencils) -> Dict[str, float]:
    pred = predicted_times(records, gpu, stencils)
    per: Dict[str, List[float]] = {}
    for r, p in zip(records, pred):
        if np.isfinite(p):
            per.setdefault(r.stencil, []).append(abs(p - r.time_s) / r.time_s)
    return {k: float(np.mean(v)) for k, v in sorted(per.items())}


def fit_machine_params(
    run: MeasurementRun | Sequence[MeasurementRecord],
    gpu0: Optional[GPUSpec] = None,
    stencils0: Optional[Mapping[str, StencilSpec]] = None,
    iters: int = 1500,
    learning_rate: float = 0.05,
    device=None,
) -> CalibrationResult:
    """Fit (per-stencil C_iter, bw_gmem, launch_overhead) to measurements,
    on the card unless ``device`` says otherwise.

    Adam in log-parameter space with a fixed ``iters`` budget; gradients
    from autograd through the float32 torch time model.
    """
    device = resolve_device(device)
    if isinstance(run, MeasurementRun):
        records = list(run.records)
        if gpu0 is None:
            gpu0 = GPUS_BY_NAME.get(run.gpu_name)
            if gpu0 is None:
                raise ValueError(
                    f"measurement run is framed against unknown GPU "
                    f"{run.gpu_name!r}; pass gpu0= explicitly "
                    f"(known families: {sorted(GPUS_BY_NAME)})"
                )
    else:
        records = list(run)
    gpu0 = gpu0 or MAXWELL_GPU
    stencils0 = dict(STENCILS if stencils0 is None else stencils0)
    if not records:
        raise ValueError("no measurement records to fit")

    pred0 = predicted_times(records, gpu0, stencils0)
    keep = np.isfinite(pred0)
    n_dropped = int((~keep).sum())
    records = [r for r, k in zip(records, keep) if k]
    if not records:
        raise ValueError("every record is infeasible under the analytical model")

    groups = _group_arrays(records)
    names = list(groups)  # first-appearance order; theta layout
    f32 = dict(dtype=torch.float32, device=device)
    # stencils that share (dims, radius, n_arrays) evaluate as one batch with
    # a per-record C_iter: fewer, larger kernels per iteration
    batches: Dict[tuple, list] = {}
    for gi, n in enumerate(names):
        st = stencils0[n]
        batches.setdefault((st.dims, st.radius, st.n_arrays), []).append(gi)
    dev_batches = []
    for gis in batches.values():
        arrs = [np.concatenate([groups[names[gi]][a] for gi in gis]) for a in range(4)]
        which = np.concatenate(
            [np.full(groups[names[gi]][3].shape[0], gi) for gi in gis]
        )
        dev_batches.append((
            stencils0[names[gis[0]]],
            torch.as_tensor(which, dtype=torch.int64, device=device),
            *(torch.as_tensor(a, **f32) for a in arrs),
        ))
    n_records = len(records)
    theta = torch.log(
        torch.as_tensor(
            [stencils0[n].c_iter for n in names] + [gpu0.bw_gmem, gpu0.launch_overhead],
            **f32,
        )
    )

    def loss_fn(th):
        gpu = with_machine_params(
            gpu0, bw_gmem=torch.exp(th[-2]), launch_overhead=torch.exp(th[-1])
        )
        total = 0.0
        for st0, which, hw, sizes, tiles, t_meas in dev_batches:
            st = with_c_iter(st0, torch.exp(th[which]))
            pred = _model_times(st, gpu, hw, sizes, tiles, xp=torch, dtype=torch.float32)
            r = torch.log(pred) - torch.log(t_meas)
            total = total + torch.sum(r * r)
        return total / n_records

    b1, b2, eps = 0.9, 0.999, 1e-8
    m = torch.zeros_like(theta)
    v = torch.zeros_like(theta)
    b1_t, b2_t = torch.tensor(b1, **f32), torch.tensor(b2, **f32)
    for i in range(int(iters)):
        th = theta.detach().requires_grad_(True)
        (g,) = torch.autograd.grad(loss_fn(th), th)
        with torch.no_grad():
            m = b1 * m + (1.0 - b1) * g
            v = b2 * v + (1.0 - b2) * g * g
            t = torch.tensor(i + 1.0, **f32)
            mhat = m / (1.0 - b1_t**t)
            vhat = v / (1.0 - b2_t**t)
            theta = theta - learning_rate * mhat / (torch.sqrt(vhat) + eps)

    fitted = np.exp(theta.detach().cpu().numpy().astype(np.float64))
    stencils = {
        n: with_c_iter(stencils0[n], float(fitted[i])) for i, n in enumerate(names)
    }
    gpu = with_machine_params(
        gpu0, bw_gmem=float(fitted[-2]), launch_overhead=float(fitted[-1])
    )

    def _sq_log_loss(g, sts):
        pred = predicted_times(records, g, sts)
        r = np.log(pred) - np.log([rec.time_s for rec in records])
        return float(np.mean(r * r))

    return CalibrationResult(
        gpu0=gpu0,
        gpu=gpu,
        stencils=stencils,
        errors_before=_rel_errors(records, gpu0, stencils0),
        errors_after=_rel_errors(records, gpu, stencils),
        loss_before=_sq_log_loss(gpu0, stencils0),
        loss_after=_sq_log_loss(gpu, stencils),
        n_records=len(records),
        n_dropped=n_dropped,
        iters=int(iters),
        learning_rate=float(learning_rate),
    )


def synthetic_records(
    gpu: GPUSpec,
    stencils: Optional[Mapping[str, StencilSpec]] = None,
    noise: float = 0.0,
    seed: int = 0,
    hw_points: Optional[Sequence[Tuple[float, float, float]]] = None,
) -> List[MeasurementRecord]:
    """Model-generated "measurements" (the JAX package's grid): fitting them
    from perturbed starting parameters must recover the generating model.
    ``noise`` is multiplicative log-normal sigma from a numpy seed."""
    stencils = dict(STENCILS if stencils is None else stencils)
    if hw_points is None:
        # the (2, 32) point gives every stencil compute-bound records, so
        # C_iter is identifiable (memory-bound-only grids leave it flat)
        hw_points = [(16.0, 128.0, 96.0), (8.0, 64.0, 48.0), (2.0, 32.0, 96.0)]
    tile_cands = [
        {"t_s1": 8, "t_s2": 32, "t_t": 2, "k": 1},
        {"t_s1": 16, "t_s2": 64, "t_t": 4, "k": 2},
        {"t_s1": 32, "t_s2": 128, "t_t": 8, "k": 1},
    ]
    sizes_2d = [(512, 512, 1, 8), (2048, 2048, 1, 64), (128, 128, 1, 2)]
    sizes_3d = [(64, 64, 64, 8), (128, 128, 128, 16), (32, 32, 32, 2)]
    rng = np.random.default_rng(seed)
    candidates: List[MeasurementRecord] = []
    for name, st in stencils.items():
        sizes = sizes_3d if st.dims == 3 else sizes_2d
        for hw in hw_points:
            hw_map = dict(zip(("n_sm", "n_v", "m_sm"), hw))
            for tiles in feasible_tiles(name, tile_cands, gpu, hw_map):
                for size in sizes:
                    candidates.append(
                        MeasurementRecord(
                            stencil=name,
                            size=size,
                            tiles=tuple(int(tiles[k]) for k in TILE_NAMES),
                            time_s=1.0,  # placeholder, replaced below
                            hw=hw,
                        )
                    )
    times = predicted_times(candidates, gpu, stencils)
    if noise > 0:
        times = times * np.exp(rng.normal(0.0, noise, size=times.shape))
    out = [
        dataclasses.replace(rec, time_s=float(t))
        for rec, t in zip(candidates, times)
        if np.isfinite(t)
    ]
    if not out:
        raise RuntimeError("synthetic grid produced no feasible records")
    return out
