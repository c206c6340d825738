"""Timing harness over the tile-parameterized stencil kernels (K1/K2).

One measurement = one (stencil, problem size, tile config) triple run for
``steps`` time steps by :func:`repro_torch.kernels.tiled_stencils.run_tiled`,
timed as the JAX package times it: warmup calls first (the kernel build and
caches), never timed; then ``repeats`` runs, each a host clock around the
whole ``steps``-step run ended by ``torch.cuda.synchronize()``; the median
is recorded. Launch overhead is therefore inside the number, where the
model's ``launch_overhead`` term fits it.

Records and runs serialize to the same JSON as the JAX package's
(:meth:`MeasurementRun.to_payload`), so either package can fit the other's
measurements. A run on the card has ``backend="cuda"``, ``interpret=False``
and the card's name in ``note``.
"""

from __future__ import annotations

import dataclasses
import statistics
import time
from typing import Dict, Iterable, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from .._device import resolve_device
from ..core.timemodel import MAXWELL_GPU, STENCILS, GPUSpec, ProblemSize, feasible
from ..kernels.tiled_stencils import TILE_NAMES, normalize_tiles, run_tiled
from ..obs.metrics import get_registry as _obs_registry

# ---- observability (repro_torch.obs; no-ops under REPRO_OBS_DISABLED=1) --
_REG = _obs_registry()
_M_POINTS = _REG.counter(
    "repro_measure_points_total",
    "measured (stencil, size, tiles) points, by stencil",
    labels=("stencil",),
)
_M_POINT_SECONDS = _REG.histogram(
    "repro_measure_point_seconds",
    "median wall seconds of one measured point (the recorded time_s)",
)

__all__ = [
    "MeasurementRecord",
    "MeasurementRun",
    "STOCK_HW",
    "STOCK_HW_BY_GPU",
    "stock_hw",
    "default_grid",
    "frame_tiles",
    "feasible_tiles",
    "measure_one",
    "measure_grid",
]

#: nominal description of the measured machine as a paper hardware point
#: (n_SM, n_V, M_SM kB); the fit holds it fixed and moves only the machine
#: parameters. The same stock points as the JAX package.
STOCK_HW: Dict[str, float] = {"n_sm": 16.0, "n_v": 128.0, "m_sm": 96.0}
STOCK_HW_BY_GPU: Dict[str, Dict[str, float]] = {
    "gtx980": STOCK_HW,
    "titanx": {"n_sm": 24.0, "n_v": 128.0, "m_sm": 96.0},
}


def stock_hw(gpu: GPUSpec) -> Dict[str, float]:
    """The nominal hardware point a measurement framed on ``gpu``'s family
    is described as."""
    return dict(STOCK_HW_BY_GPU.get(gpu.name, STOCK_HW))


@dataclasses.dataclass(frozen=True)
class MeasurementRecord:
    """One timed (stencil, size, tiles) point plus its context."""

    stencil: str
    size: Tuple[int, int, int, int]  # (s1, s2, s3, t) -- t = measured steps
    tiles: Tuple[int, ...]  # TILE_NAMES order
    time_s: float  # median wall seconds for the whole t-step run
    hw: Tuple[float, float, float]  # (n_sm, n_v, m_sm) nominal description
    repeats: int = 1
    warmup: int = 1
    #: every timed repeat in call order (time_s is their median); optional
    times_s: Optional[Tuple[float, ...]] = None

    def problem_size(self) -> ProblemSize:
        s1, s2, s3, t = self.size
        return ProblemSize(s1=s1, s2=s2, t=t, s3=s3)

    def tile_dict(self) -> Dict[str, int]:
        return dict(zip(TILE_NAMES, self.tiles))

    def to_json(self) -> dict:
        out = {
            "stencil": self.stencil,
            "size": list(self.size),
            "tiles": list(self.tiles),
            "time_s": float(self.time_s),
            "hw": list(self.hw),
            "repeats": int(self.repeats),
            "warmup": int(self.warmup),
        }
        if self.times_s is not None:
            out["times_s"] = [float(t) for t in self.times_s]
        return out

    @classmethod
    def from_json(cls, obj: Mapping) -> "MeasurementRecord":
        raw_times = obj.get("times_s")
        return cls(
            stencil=str(obj["stencil"]),
            size=tuple(int(v) for v in obj["size"]),
            tiles=tuple(int(v) for v in obj["tiles"]),
            time_s=float(obj["time_s"]),
            hw=tuple(float(v) for v in obj["hw"]),
            repeats=int(obj.get("repeats", 1)),
            warmup=int(obj.get("warmup", 1)),
            times_s=None if raw_times is None
            else tuple(float(t) for t in raw_times),
        )


@dataclasses.dataclass
class MeasurementRun:
    """A list of records plus run-level context (the persistable unit)."""

    records: List[MeasurementRecord]
    gpu_name: str  # GPU family whose constants frame the fit
    backend: str  # where the kernels ran: "cuda" (or "cpu" when asked)
    interpret: bool  # always False here: no interpret mode
    note: str = ""

    def to_payload(self) -> dict:
        """Plain-JSON payload, the same keys as the JAX package's."""
        return {
            "records": [r.to_json() for r in self.records],
            "gpu_name": self.gpu_name,
            "backend": self.backend,
            "interpret": bool(self.interpret),
            "note": self.note,
        }

    @classmethod
    def from_payload(cls, obj: Mapping) -> "MeasurementRun":
        return cls(
            records=[MeasurementRecord.from_json(r) for r in obj["records"]],
            gpu_name=str(obj["gpu_name"]),
            backend=str(obj["backend"]),
            interpret=bool(obj["interpret"]),
            note=str(obj.get("note", "")),
        )

    def stencil_names(self) -> List[str]:
        seen: Dict[str, None] = {}
        for r in self.records:
            seen.setdefault(r.stencil)
        return list(seen)


def frame_tiles(name: str, tiles) -> Tuple[int, ...]:
    """Normalized tile tuple in the frame the model evaluates it: 2D
    stencils get ``t_s3`` pinned to 1 (the 2D kernel never reads it, and
    the model's compute term multiplies by it)."""
    t = list(normalize_tiles(tiles))
    if STENCILS[name].dims == 2:
        t[TILE_NAMES.index("t_s3")] = 1
    return tuple(t)


def feasible_tiles(
    name: str,
    tile_candidates: Iterable[Mapping[str, int]],
    gpu: GPUSpec = MAXWELL_GPU,
    hw: Mapping[str, float] = None,
) -> List[Dict[str, int]]:
    """Candidates the analytical model deems feasible at the nominal
    hardware point (eqs. 9-15), framed by :func:`frame_tiles` and deduped."""
    hw = dict(STOCK_HW if hw is None else hw)
    st = STENCILS[name]
    out: List[Dict[str, int]] = []
    seen = set()
    for cand in tile_candidates:
        framed = frame_tiles(name, cand)
        if framed in seen:
            continue
        seen.add(framed)
        t = dict(zip(TILE_NAMES, framed))
        ok = feasible(
            st, gpu, hw["n_sm"], hw["n_v"], hw["m_sm"],
            t["t_s1"], t["t_s2"], t["t_t"], t["k"], t["t_s3"],
        )
        if bool(np.asarray(ok)):
            out.append(t)
    return out


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def measure_one(
    name: str,
    shape: Sequence[int],
    steps: int,
    tiles: Mapping[str, int],
    warmup: int = 1,
    repeats: int = 3,
    hw: Mapping[str, float] = None,
    seed: int = 0,
    device=None,
) -> MeasurementRecord:
    """Time one configuration (median of ``repeats`` synchronized runs) on
    the card, or on ``device`` when given. The input is standard normal
    f32 from a ``torch.Generator`` seeded with ``seed`` on that device."""
    device = resolve_device(device)
    hw = dict(STOCK_HW if hw is None else hw)
    tile_tuple = frame_tiles(name, tiles)  # 2D: t_s3 pinned to 1
    gen = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn(tuple(shape), generator=gen, device=device, dtype=torch.float32)
    _sync(device)

    def run() -> float:
        t0 = time.perf_counter()
        run_tiled(name, x, steps=steps, tiles=tiles)
        _sync(device)
        return time.perf_counter() - t0

    for _ in range(max(0, warmup)):
        run()
    times = [run() for _ in range(max(1, repeats))]
    dims = STENCILS[name].dims
    size = (
        int(shape[0]),
        int(shape[1]),
        int(shape[2]) if dims == 3 else 1,
        int(steps),
    )
    median = float(statistics.median(times))
    _M_POINTS.labels(stencil=name).inc()
    _M_POINT_SECONDS.observe(median)
    return MeasurementRecord(
        stencil=name,
        size=size,
        tiles=tile_tuple,
        time_s=median,
        hw=(hw["n_sm"], hw["n_v"], hw["m_sm"]),
        repeats=int(repeats),
        warmup=int(warmup),
        times_s=tuple(float(t) for t in times),
    )


def default_grid(
    smoke: bool = True, gpu: GPUSpec = MAXWELL_GPU
) -> Dict[str, List[dict]]:
    """stencil -> list of {"shape", "steps", "tiles"} configs: the JAX
    package's grids, feasibility-filtered against ``gpu``'s family at its
    :func:`stock_hw` point."""
    if smoke:
        shapes_2d = [(48, 64), (96, 128)]
        shapes_3d = [(16, 16, 32)]
        steps = 4
        tile_cands = [
            {"t_s1": 8, "t_s2": 32, "t_t": 2, "k": 1},
            {"t_s1": 16, "t_s2": 64, "t_t": 2, "k": 2},
            {"t_s1": 32, "t_s2": 64, "t_t": 4, "k": 1},
            {"t_s1": 8, "t_s2": 32, "t_t": 2, "k": 1, "t_s3": 4},
            {"t_s1": 4, "t_s2": 32, "t_t": 4, "k": 1, "t_s3": 4},
        ]
    else:
        shapes_2d = [(256, 256), (512, 512), (1024, 1024)]
        shapes_3d = [(48, 48, 64), (96, 96, 96)]
        steps = 8
        tile_cands = [
            {"t_s1": 8, "t_s2": 32, "t_t": 2, "k": 1},
            {"t_s1": 16, "t_s2": 64, "t_t": 2, "k": 2},
            {"t_s1": 32, "t_s2": 128, "t_t": 4, "k": 4},
            {"t_s1": 64, "t_s2": 256, "t_t": 8, "k": 2},
        ]
    grid: Dict[str, List[dict]] = {}
    for name, st in STENCILS.items():
        shapes = shapes_3d if st.dims == 3 else shapes_2d
        cands = feasible_tiles(name, tile_cands, gpu, stock_hw(gpu))
        grid[name] = [
            {"shape": shape, "steps": steps, "tiles": t}
            for shape in shapes
            for t in cands
        ]
    return grid


def measure_grid(
    grid: Optional[Dict[str, List[dict]]] = None,
    warmup: int = 1,
    repeats: int = 3,
    gpu: GPUSpec = MAXWELL_GPU,
    note: str = "",
    device=None,
) -> MeasurementRun:
    """Run every configuration of a :func:`default_grid`-shaped grid on the
    card (or ``device``). Records are stamped with ``gpu``'s family stock
    hardware point (a config may override with its own ``"hw"``)."""
    device = resolve_device(device)
    if grid is None:
        grid = default_grid(gpu=gpu)
    records: List[MeasurementRecord] = []
    for name, configs in grid.items():
        for cfg in configs:
            records.append(
                measure_one(
                    name,
                    cfg["shape"],
                    cfg["steps"],
                    cfg["tiles"],
                    warmup=warmup,
                    repeats=repeats,
                    hw=cfg.get("hw", stock_hw(gpu)),
                    device=device,
                )
            )
    card = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    return MeasurementRun(
        records=records,
        gpu_name=gpu.name,
        backend=device.type,
        interpret=False,
        note=f"{card}; {note}" if note else card,
    )
