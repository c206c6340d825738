"""The codesign optimization driver (paper §IV, eqs. 7-18).

Eq. (18)'s separability: every hardware point of ``HP`` x an independent
tile-size minimization per (stencil, size) cell. The per-cell optima are
kept as a ``(cells x hardware)`` matrix, so re-weighting frequencies or
picking one stencil (§V.B "workload sensitivity for free") are matrix
re-reductions with no new solve.

The inner solves run on one of three engines:

* ``"torch"`` -- :func:`repro_torch.core.sweep.sweep_cells`, one
  broadcast sweep per stencil over all its problem sizes, on the card
  unless ``device="cpu"`` is passed;
* ``"sharded"`` -- :func:`repro_torch.core.sweep.sweep_cells_sharded`,
  the same sweep with the hardware axis split over ``devices=``
  (bit-identical to ``"torch"``);
* ``"numpy"`` -- the float64 oracle :func:`repro_torch.core.solver
  .solve_cell`.

``engine="auto"`` keeps the JAX package's rule: numpy below
:data:`_AUTO_MIN_HW` hardware points, else sharded when more than one card
is attached, else the torch engine; ``devices=`` promotes ``"auto"`` to
``"sharded"`` and the other engines refuse it. It never chooses numpy or
the CPU because no card was found: the torch engine then raises. LM op-graph workloads dispatch to :mod:`repro_torch.core.lmcells`
under the same engine rule.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..obs.metrics import get_registry as _obs_registry
from ..obs.trace import span
from .area import GTX980, MAXWELL, TITAN_X, HardwarePoint, LinearAreaModel
from .pareto import pareto_mask
from .solver import LATTICE_2D, LATTICE_3D, TileLattice, decode_index, solve_cell
from .timemodel import MAXWELL_GPU, GPUSpec, ProblemSize, StencilSpec, stencil_time
from .workload import Workload, WorkloadCell

# ---- observability (repro_torch.obs; no-ops under REPRO_OBS_DISABLED=1) --
_REG = _obs_registry()
_M_CODESIGN_SECONDS = _REG.histogram(
    "repro_codesign_seconds",
    "wall time of one full codesign() sweep (all cells x hardware "
    "points), by resolved engine and cell family",
    labels=("engine", "family"),
)
_M_CODESIGN_CELLS = _REG.counter(
    "repro_codesign_cells_total",
    "workload cells swept by codesign(), by resolved engine",
    labels=("engine",),
)

__all__ = [
    "HardwareSpace",
    "CodesignResult",
    "enumerate_hw_space",
    "codesign",
    "evaluate_fixed_hw",
    "STOCK",
]

#: Paper §IV.B parameter ranges: n_SM in [2, 32] even; n_V in [32, 2048]
#: multiple of 32; M_SM multiples of 48 kB up to 480 kB, plus {12, 24, 36}.
N_SM_RANGE = tuple(range(2, 33, 2))
N_V_RANGE = tuple(range(32, 2049, 32))
M_SM_RANGE = (12, 24, 36) + tuple(48 * j for j in range(1, 11))


@dataclasses.dataclass
class HardwareSpace:
    """Flattened feasible hardware points + their (cache-less) areas."""

    n_sm: np.ndarray
    n_v: np.ndarray
    m_sm: np.ndarray
    area: np.ndarray

    def __len__(self) -> int:
        return self.n_sm.shape[0]

    def point(self, i: int) -> HardwarePoint:
        return HardwarePoint(
            n_sm=int(self.n_sm[i]), n_v=int(self.n_v[i]), m_sm=float(self.m_sm[i])
        )

    def downsample(self, step: int) -> "HardwareSpace":
        """Every ``step``-th point -- quick demos and tests."""
        keep = np.arange(len(self)) % step == 0
        return HardwareSpace(
            self.n_sm[keep], self.n_v[keep], self.m_sm[keep], self.area[keep]
        )


def enumerate_hw_space(
    area_model: LinearAreaModel = MAXWELL,
    max_area: float = 650.0,
    min_area: float = 0.0,
    n_sm_range: Sequence[int] = N_SM_RANGE,
    n_v_range: Sequence[int] = N_V_RANGE,
    m_sm_range: Sequence[int] = M_SM_RANGE,
) -> HardwareSpace:
    """All hardware points within the area budget. Proposed designs are
    cache-less (§V.A), so L1 = L2 = 0 in the area term."""
    n_sm, n_v, m_sm = np.meshgrid(
        np.array(n_sm_range, np.float64),
        np.array(n_v_range, np.float64),
        np.array(m_sm_range, np.float64),
        indexing="ij",
    )
    n_sm, n_v, m_sm = n_sm.ravel(), n_v.ravel(), m_sm.ravel()
    area = area_model.area(n_sm, n_v, m_sm, r_vu=2.0, l1_smpair=0.0, l2_kb=0.0)
    keep = (area <= max_area) & (area >= min_area)
    return HardwareSpace(n_sm[keep], n_v[keep], m_sm[keep], area[keep])


def _stencil_groups(
    workload: Workload, indices: Optional[Sequence[int]] = None
) -> Dict[str, Tuple[object, List[int], np.ndarray]]:
    """Cells grouped per stencil for batched sweeps: name -> (stencil spec,
    cell indices, (P, 4) sizes as (s1, s2, s3, t) rows)."""
    groups: Dict[str, List[int]] = {}
    for ci in range(len(workload.cells)) if indices is None else indices:
        groups.setdefault(workload.cells[ci].stencil.name, []).append(ci)
    out: Dict[str, Tuple[object, List[int], np.ndarray]] = {}
    for name, cis in groups.items():
        sizes = np.array(
            [
                (c.size.s1, c.size.s2, c.size.s3, c.size.t)
                for c in (workload.cells[ci] for ci in cis)
            ],
            np.float64,
        )
        out[name] = (workload.cells[cis[0]].stencil, cis, sizes)
    return out


@dataclasses.dataclass
class CodesignResult:
    """Per-cell optimal times for every hardware point (eq. 18 inner solves)
    plus workload-level reductions."""

    workload: Workload
    gpu: GPUSpec
    hw: HardwareSpace
    cell_time: np.ndarray  # (C, H) optimal T_alg per cell per hw point
    cell_tile_idx: np.ndarray  # (C, H) winning lattice index (-1 infeasible)
    lattices: List[TileLattice]  # per cell

    def cell_freqs(self) -> np.ndarray:
        """(C,) default workload frequencies."""
        return np.array([c.freq for c in self.workload.cells], np.float64)

    def cell_flops(self) -> np.ndarray:
        """(C,) useful flops per cell -- the gflops numerator."""
        return np.array(
            [c.stencil.flops_per_point * c.size.points for c in self.workload.cells],
            np.float64,
        )

    def weighted_time(self, freqs: Optional[np.ndarray] = None) -> np.ndarray:
        """Eq. (17) objective per hardware point; default = workload freqs."""
        if freqs is None:
            freqs = self.cell_freqs()
        freqs = np.asarray(freqs, np.float64)
        return freqs @ self.cell_time

    def gflops(self, freqs: Optional[np.ndarray] = None) -> np.ndarray:
        """Workload performance: weighted useful flops / weighted time."""
        if freqs is None:
            freqs = self.cell_freqs()
        freqs = np.asarray(freqs, np.float64)
        return (freqs @ self.cell_flops()) / self.weighted_time(freqs) / 1.0e9

    def pareto(self, freqs: Optional[np.ndarray] = None) -> np.ndarray:
        """Pareto mask over (area, GFLOP/s)."""
        return pareto_mask(self.hw.area, self.gflops(freqs))

    def best(self, max_area: float = np.inf, freqs=None) -> Tuple[int, float]:
        """(index, GFLOP/s) of the best design within an area cap."""
        g = self.gflops(freqs)
        g = np.where(self.hw.area <= max_area, g, -np.inf)
        i = int(np.argmax(g))
        return i, float(g[i])

    def tiles_for(self, cell_index: int, hw_index: int) -> Dict[str, int]:
        idx = int(self.cell_tile_idx[cell_index, hw_index])
        if idx < 0:
            raise ValueError("infeasible cell/hw combination")
        return decode_index(self.lattices[cell_index], idx)

    def refine(
        self, hw_index: int, device=None
    ) -> Tuple[np.ndarray, List[Optional[Dict[str, int]]]]:
        """Polish every cell's lattice optimum at one hardware point with the
        batched descent of :func:`repro_torch.core.sweep.refine_points` (on
        the card unless ``device="cpu"``).

        Returns ``(times (C,), tile dicts)``; a cell infeasible at this
        point keeps its +inf time and gets ``None`` tiles.
        """
        from . import sweep

        times = self.cell_time[:, hw_index].copy()
        tiles: List[Optional[Dict[str, int]]] = [None] * len(times)
        point = self.hw.point(hw_index)
        hw_row = (float(point.n_sm), float(point.n_v), float(point.m_sm))
        feasible = [
            ci
            for ci in range(len(self.workload.cells))
            if self.cell_tile_idx[ci, hw_index] >= 0
        ]
        for st, cis, sizes in _stencil_groups(self.workload, feasible).values():
            start = {ci: self.tiles_for(ci, hw_index) for ci in cis}
            sw0 = np.array(
                [[start[ci][k] for k in sweep.SW_NAMES] for ci in cis],
                np.float64,
            )
            _, sw_ref = sweep.refine_points(
                st, self.gpu, sizes, np.tile(hw_row, (len(cis), 1)), sw0,
                device=device,
            )
            # accept in the float64 oracle model: never on float32 noise,
            # and reported times reproduce at the reported tiles
            size64 = ProblemSize(
                s1=sizes[:, 0], s2=sizes[:, 1], t=sizes[:, 3], s3=sizes[:, 2]
            )

            def t64(sw):
                return stencil_time(
                    st, self.gpu, size64, hw_row[0], hw_row[1], hw_row[2],
                    sw[:, 0], sw[:, 1], sw[:, 2], sw[:, 3], sw[:, 4],
                )

            t_ref, t_start = t64(sw_ref), t64(sw0)
            for j, ci in enumerate(cis):
                if t_ref[j] < t_start[j]:
                    times[ci] = t_ref[j]
                    tiles[ci] = sweep.decode_sw(sw_ref[j])
                else:
                    times[ci] = t_start[j]
                    tiles[ci] = start[ci]
        return times, tiles

    def routing_metadata(self) -> Dict[str, object]:
        """The attributes a multi-artifact front-end routes on, derivable
        without touching any array: GPU target, stencil set, workload name.
        Persisted verbatim as the manifest's ``"routing"`` block so a
        gateway can index hundreds of artifacts from their (small) JSON
        manifests alone -- no mmap, no npz decompression."""
        return {
            "gpu": self.gpu.name,
            "workload": self.workload.name,
            "stencils": sorted({c.stencil.name for c in self.workload.cells}),
        }

    # ---- artifact serialization (repro_torch.service.store hooks) ----------
    def artifact_payload(self) -> Tuple[dict, Dict[str, np.ndarray]]:
        """(manifest, arrays) split for on-disk persistence.

        The manifest is pure JSON (workload cells with full stencil specs,
        GPU constants, the per-cell lattice tables, and the ``"routing"``
        block of :meth:`routing_metadata`); the arrays dict holds the big
        matrices. :meth:`from_artifact_payload` inverts it exactly: JSON
        round-trips float64 losslessly, so a reloaded result's
        ``weighted_time``/``pareto`` are bit-identical.
        """
        unique: List[TileLattice] = []
        lat_idx: List[int] = []
        for lat in self.lattices:
            if lat not in unique:
                unique.append(lat)
            lat_idx.append(unique.index(lat))
        manifest = {
            "workload": {
                "name": self.workload.name,
                "cells": [
                    {
                        "stencil": dataclasses.asdict(c.stencil),
                        "size": {
                            "s1": int(c.size.s1), "s2": int(c.size.s2),
                            "t": int(c.size.t), "s3": int(c.size.s3),
                        },
                        "freq": float(c.freq),
                        "lattice": lat_idx[i],
                    }
                    for i, c in enumerate(self.workload.cells)
                ],
            },
            "gpu": dataclasses.asdict(self.gpu),
            "lattices": [
                {k: list(getattr(lat, k)) for k in ("t_s1", "t_s2", "t_t", "k", "t_s3")}
                for lat in unique
            ],
            "routing": self.routing_metadata(),
        }
        arrays = {
            "cell_time": np.asarray(self.cell_time, np.float64),
            "cell_tile_idx": np.asarray(self.cell_tile_idx, np.int64),
            "hw_n_sm": np.asarray(self.hw.n_sm, np.float64),
            "hw_n_v": np.asarray(self.hw.n_v, np.float64),
            "hw_m_sm": np.asarray(self.hw.m_sm, np.float64),
            "hw_area": np.asarray(self.hw.area, np.float64),
        }
        return manifest, arrays

    @staticmethod
    def parse_manifest(
        manifest: dict,
    ) -> Tuple[Workload, GPUSpec, List[TileLattice]]:
        """The JSON-only half of :meth:`from_artifact_payload`:
        ``(workload, gpu, per-cell lattices)`` from a stored manifest,
        touching no arrays. A service front-end uses this to reconstruct a
        server's configuration from a discovered artifact without paging
        in its ``(C, H)`` matrix."""
        lattices_tbl = [
            TileLattice(**{k: tuple(int(x) for x in v) for k, v in d.items()})
            for d in manifest["lattices"]
        ]
        cells = []
        lattices: List[TileLattice] = []
        for c in manifest["workload"]["cells"]:
            st = StencilSpec(**c["stencil"])
            sz = c["size"]
            size = ProblemSize(s1=sz["s1"], s2=sz["s2"], t=sz["t"], s3=sz["s3"])
            cells.append(WorkloadCell(st, size, c["freq"]))
            lattices.append(lattices_tbl[c["lattice"]])
        workload = Workload(manifest["workload"]["name"], tuple(cells))
        gpu = GPUSpec(**manifest["gpu"])
        return workload, gpu, lattices

    @classmethod
    def from_artifact_payload(
        cls, manifest: dict, arrays: Dict[str, np.ndarray]
    ) -> "CodesignResult":
        """Rebuild a result from :meth:`artifact_payload` output. Array
        values may be mmap-backed; they are used as-is (no copy)."""
        workload, gpu, lattices = cls.parse_manifest(manifest)
        hw = HardwareSpace(
            n_sm=np.asarray(arrays["hw_n_sm"], np.float64),
            n_v=np.asarray(arrays["hw_n_v"], np.float64),
            m_sm=np.asarray(arrays["hw_m_sm"], np.float64),
            area=np.asarray(arrays["hw_area"], np.float64),
        )
        return cls(
            workload=workload,
            gpu=gpu,
            hw=hw,
            cell_time=np.asarray(arrays["cell_time"]),
            cell_tile_idx=np.asarray(arrays["cell_tile_idx"]),
            lattices=lattices,
        )


#: below this many hardware points the numpy oracle is the cheaper engine;
#: ``engine="auto"`` picks it there (the JAX package's rule).
_AUTO_MIN_HW = 64


def _devices_engine(engine: str, devices) -> str:
    """An explicit device selection is a request for the sharded engine:
    promote auto (even below the numpy floor -- the caller knows their
    devices) and reject engines that would silently drop the knob."""
    if devices is None or engine == "sharded":
        return engine
    if engine == "auto":
        return "sharded"
    raise ValueError(
        f"devices= only applies to engine='sharded' (or 'auto'); "
        f"engine={engine!r} would silently ignore it"
    )


def _resolve_engine(engine: str, n_hw: int, devices=None) -> str:
    if engine not in ("auto", "torch", "sharded", "numpy"):
        raise ValueError(f"unknown engine {engine!r} (want auto|torch|sharded|numpy)")
    engine = _devices_engine(engine, devices)
    if engine == "auto":
        if n_hw < _AUTO_MIN_HW:
            return "numpy"
        from . import sweep

        return "sharded" if sweep.device_count() > 1 else "torch"
    return engine


def codesign(
    workload: Workload,
    gpu: GPUSpec = MAXWELL_GPU,
    area_model: LinearAreaModel = MAXWELL,
    max_area: float = 650.0,
    hw: Optional[HardwareSpace] = None,
    lattice_2d: TileLattice = LATTICE_2D,
    lattice_3d: TileLattice = LATTICE_3D,
    chunk: Optional[int] = None,
    engine: str = "auto",
    device=None,
    devices=None,
) -> CodesignResult:
    """Solve eq. (18): for every feasible hardware point, the optimal tile
    sizes (and time) of every workload cell.

    ``engine`` is ``"torch"`` (broadcast sweep on ``device``; the card
    unless ``device="cpu"``), ``"sharded"`` (the hardware axis split over
    ``devices``: ``None`` for every card, an int for the first n, or a
    sequence of devices, one shard each), ``"numpy"`` (float64 oracle) or
    ``"auto"`` (numpy below :data:`_AUTO_MIN_HW` points, else sharded when
    more than one card is attached, else torch; ``devices=`` promotes it
    to sharded, and the other engines refuse ``devices=``). ``chunk``
    bounds the hardware points per slab (per shard on the sharded engine);
    ``None`` uses each engine's default.

    Dispatches on the workload's cell family: LM op-graph workloads
    (``workload.family == "lm"``) route to :func:`repro_torch.core.lmcells
    .lm_codesign`, whose hardware axis is mesh factorizations of a chip
    budget (``hw`` must then be an :class:`~repro_torch.core.lmcells
    .LMHardwareSpace` or None); the stencil-specific knobs (gpu, area
    model, tile lattices, chunk) do not apply there.
    """
    if workload.family == "lm":
        from .lmcells import lm_codesign, resolve_lm_engine

        if devices is not None:
            raise ValueError("devices= applies to stencil workloads; the LM sweep runs on `device`")

        t0 = time.perf_counter()
        with span("codesign", family="lm"):
            result = lm_codesign(workload, hw=hw, engine=engine, device=device)
        eng = resolve_lm_engine(engine, len(result.hw))
        _M_CODESIGN_SECONDS.labels(engine=eng, family="lm").observe(
            time.perf_counter() - t0
        )
        _M_CODESIGN_CELLS.labels(engine=eng).inc(len(workload.cells))
        return result
    if workload.family != "stencil":
        raise ValueError(f"unsupported cell family {workload.family!r}")
    if hw is None:
        hw = enumerate_hw_space(area_model, max_area=max_area)
    eng = _resolve_engine(engine, len(hw), devices)
    C, H = len(workload.cells), len(hw)
    cell_time = np.empty((C, H))
    cell_idx = np.empty((C, H), dtype=np.int64)
    lattices: List[TileLattice] = [
        lattice_3d if c.stencil.dims == 3 else lattice_2d for c in workload.cells
    ]
    from . import sweep

    t0 = time.perf_counter()
    with span("codesign", family="stencil", engine=eng, cells=C, hw=H):
        if eng in ("torch", "sharded"):
            for st, cis, sizes in _stencil_groups(workload).values():
                if eng == "sharded":
                    t, i = sweep.sweep_cells_sharded(
                        st, gpu, sizes, hw.n_sm, hw.n_v, hw.m_sm, lattices[cis[0]], chunk,
                        devices=devices,
                    )
                else:
                    t, i = sweep.sweep_cells(
                        st, gpu, sizes, hw.n_sm, hw.n_v, hw.m_sm, lattices[cis[0]], chunk,
                        device=device,
                    )
                cell_time[cis] = t
                cell_idx[cis] = i
        else:
            np_chunk = 512 if chunk is None else chunk
            for ci, cell in enumerate(workload.cells):
                cell_time[ci], cell_idx[ci] = solve_cell(
                    cell.stencil, gpu, cell.size, hw.n_sm, hw.n_v, hw.m_sm,
                    lattices[ci], np_chunk,
                )
            # the oracle has no dispatch hook of its own: count its cell
            # evaluations here so engine throughput is comparable
            sweep._M_CELL_EVALS.labels(engine="numpy").inc(C * H)
    _M_CODESIGN_SECONDS.labels(engine=eng, family="stencil").observe(
        time.perf_counter() - t0
    )
    _M_CODESIGN_CELLS.labels(engine=eng).inc(C)
    return CodesignResult(workload, gpu, hw, cell_time, cell_idx, lattices)


def evaluate_fixed_hw(
    workload: Workload,
    point: HardwarePoint,
    gpu: GPUSpec = MAXWELL_GPU,
    lattice_2d: TileLattice = LATTICE_2D,
    lattice_3d: TileLattice = LATTICE_3D,
    engine: str = "auto",
    device=None,
) -> Tuple[float, float]:
    """(weighted time, GFLOP/s) of a *fixed* hardware point (e.g. the stock
    GTX-980 / Titan X baselines) with per-cell optimal tiles."""
    hw = HardwareSpace(
        n_sm=np.array([point.n_sm], np.float64),
        n_v=np.array([point.n_v], np.float64),
        m_sm=np.array([point.m_sm], np.float64),
        area=np.array([MAXWELL.area_point(point)]),
    )
    res = codesign(
        workload, gpu=gpu, hw=hw, lattice_2d=lattice_2d, lattice_3d=lattice_3d,
        engine=engine, device=device,
    )
    return float(res.weighted_time()[0]), float(res.gflops()[0])


#: Stock baseline points.
STOCK = {"gtx980": GTX980, "titanx": TITAN_X}
