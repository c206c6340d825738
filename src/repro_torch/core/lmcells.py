"""LM op-graph workload cells -- the second cell family (``family="lm"``),
routing the repo's model configs through the same eq.-18 machinery as the
stencils (the JAX package's ``core/lmcells.py``).

The mapping onto the paper's decomposition:

* **cell**: one ``(model, op, shape)`` triple -- ``prefill``, ``decode``
  (KV-cache streaming via :func:`repro_torch.serve.kvcache.cache_bytes`),
  ``train`` step, or ``moe_dispatch`` (the all-to-all routing op of MoE
  models) -- with an occurrence frequency;
* **hardware axis** (the paper's ``(n_SM, n_V, M_SM)`` analogue): the
  chip-budget factorizations ``(pod, data, model)`` of
  :class:`LMHardwareSpace`, with **area := chips** so every existing area
  budget / Pareto / what-if reduction applies unchanged;
* **software axis** (the tile-size analogue): the
  ``(microbatches, remat, fsdp, compress_grads)`` lattice of
  :class:`MeshPlan` knobs, minimized out independently per (cell, hw).

Two engines, one body (:func:`_grid_times`, through the numpy|torch ops
namespace of :mod:`repro_torch.core.timemodel`): ``"numpy"`` evaluates the
scalar oracle's float64 expressions vectorized over the whole ``(hw, sw)``
grid, and ``"torch"`` evaluates the same expressions in float64 on a torch
device (the card unless ``device="cpu"``), every operand a tensor on that
device so each division is a true division. :func:`lm_cell_roofline` is the
plain-scalar oracle both are tested against; for the three standard ops it
reproduces :func:`repro_torch.core.lmtime.lm_roofline` term for term. The
times are model predictions for the modelled fleet of
:data:`repro_torch.core.lmtime.HW`.

The port, against the JAX package's module: the float32 ``"jax"`` engine
becomes the float64 ``"torch"`` engine; ``engine`` is ``auto|torch|numpy``
(``"auto"``: numpy below 64 hardware points, else torch, the stencil
rule), and ``"jax"``/``"sharded"`` remain digest names of the store only.
Parameter counts come from the meta-device model of
:mod:`repro_torch.models`.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..configs.base import SHAPES, ArchConfig, ShapeSpec
from .lmtime import HW, MeshPlan
from .timemodel import _ops
from .pareto import pareto_mask
from .workload import Workload

__all__ = [
    "LMCell",
    "LMHardwareSpace",
    "LMSwLattice",
    "LMCodesignResult",
    "LM_GPU_NAME",
    "enumerate_lm_hw_space",
    "lm_sw_lattice",
    "lm_cells_for",
    "lm_workload",
    "lm_cell_roofline",
    "lm_codesign",
    "resolve_lm_engine",
]

#: default "gpu" routing attribute of LM artifacts: the chip the roofline
#: constants describe. Overridable per sweep (routing is not the model).
LM_GPU_NAME = "tpu_v5e"

#: the acceptance-criteria serving shape: decode at global batch 64 over an
#: 8k context (ISSUE: "what chip config serves Llama-3-8B at batch 64").
DECODE_B64 = ShapeSpec("decode_b64", 8192, 64, "decode")

LM_OPS = ("prefill", "decode", "train", "moe_dispatch")


@dataclasses.dataclass(frozen=True)
class LMCell:
    """One LM workload cell: an op of one model at one shape.

    All numeric fields are plain Python scalars precomputed at build time
    (parameter counts on the meta device, KV bytes via
    :func:`repro_torch.serve.kvcache.cache_bytes`), so a cell round-trips through
    a JSON manifest and the sweep never re-touches model code.
    """

    model: str  # arch name, e.g. "llama3-8b"
    op: str  # prefill | decode | train | moe_dispatch
    shape: ShapeSpec
    freq: float
    n_params: int  # total parameters (elements)
    n_active: int  # parameters touched per token (< n_params for MoE)
    kv_bytes: int  # full KV-cache bytes at this shape (0 unless decode)
    d_model: int
    n_layers: int
    flops: float  # useful FLOPs per step -- the GFLOP/s numerator
    moe_top_k: int = 0
    moe_capacity: float = 0.0
    moe_n_experts: int = 0

    def __post_init__(self):
        if self.op not in LM_OPS:
            raise ValueError(f"unknown LM op {self.op!r} (want one of {LM_OPS})")

    @property
    def family(self) -> str:
        return "lm"

    @property
    def label(self) -> str:
        return f"{self.model}:{self.op}"

    @property
    def tokens(self) -> int:
        """Tokens processed per step (decode emits one per sequence)."""
        return (
            self.shape.tokens
            if self.shape.kind != "decode"
            else self.shape.global_batch
        )

    def consts(self) -> Dict[str, float]:
        """The serializable numeric identity of this cell."""
        return {
            "n_params": int(self.n_params),
            "n_active": int(self.n_active),
            "kv_bytes": int(self.kv_bytes),
            "d_model": int(self.d_model),
            "n_layers": int(self.n_layers),
            "flops": float(self.flops),
            "moe_top_k": int(self.moe_top_k),
            "moe_capacity": float(self.moe_capacity),
            "moe_n_experts": int(self.moe_n_experts),
        }


# ---------------------------------------------------------------------------
# Design-space enumeration
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class LMHardwareSpace:
    """Flattened chip-budget factorizations; ``area`` IS the chip count, so
    the store/query/gateway area-budget machinery applies verbatim."""

    pod: np.ndarray
    data: np.ndarray
    model: np.ndarray
    area: np.ndarray  # = pod * data * model (chips)

    def __len__(self) -> int:
        return self.pod.shape[0]

    def point(self, i: int) -> Dict[str, float]:
        return {
            "pod": int(self.pod[i]),
            "data": int(self.data[i]),
            "model": int(self.model[i]),
            "chips": int(self.area[i]),
        }

    def downsample(self, step: int) -> "LMHardwareSpace":
        keep = np.arange(len(self)) % step == 0
        return LMHardwareSpace(
            self.pod[keep], self.data[keep], self.model[keep], self.area[keep]
        )


def enumerate_lm_hw_space(
    max_chips: int = 512, multi_pod: bool = True
) -> LMHardwareSpace:
    """All mesh factorizations ``pod * data * model <= max_chips`` with
    power-of-two data/model axes (the shapes XLA meshes actually take),
    sorted by (chips, pod, model) for a deterministic content address.

    The 512 default is the smallest power of two at which EVERY default
    cell fits HBM somewhere -- Mixtral-8x22B's train step needs 512 v5e
    chips -- so the default pair artifact has a non-empty answer for its
    own uniform mix (a mix is infeasible at a mesh where *any* workload
    cell is infeasible, zero-weighted or not; see docs/lm_codesign.md)."""
    rows: List[Tuple[int, int, int]] = []
    pows = [1 << j for j in range(max_chips.bit_length()) if (1 << j) <= max_chips]
    for pod in (1, 2) if multi_pod else (1,):
        for data in pows:
            for model in pows:
                if pod * data * model <= max_chips:
                    rows.append((pod, data, model))
    rows.sort(key=lambda r: (r[0] * r[1] * r[2], r[0], r[2], r[1]))
    arr = np.array(rows, np.float64)
    return LMHardwareSpace(
        pod=arr[:, 0],
        data=arr[:, 1],
        model=arr[:, 2],
        area=arr[:, 0] * arr[:, 1] * arr[:, 2],
    )


@dataclasses.dataclass(frozen=True)
class LMSwLattice:
    """Software-knob candidate rows (aligned columns, not a cross product
    object -- row ``j`` is one :class:`MeshPlan` knob setting)."""

    microbatches: Tuple[int, ...]
    remat_full: Tuple[int, ...]  # 0 | 1
    fsdp: Tuple[int, ...]  # 0 | 1
    compress: Tuple[int, ...]  # 0 | 1

    def __len__(self) -> int:
        return len(self.microbatches)

    def plan(self, pod: int, data: int, model: int, j: int) -> MeshPlan:
        """Materialize row ``j`` at one hardware point."""
        return MeshPlan(
            pod=pod,
            data=data,
            model=model,
            microbatches=int(self.microbatches[j]),
            remat="full" if self.remat_full[j] else "none",
            fsdp=bool(self.fsdp[j]),
            compress_grads=bool(self.compress[j]),
        )

    def as_dict(self) -> Dict[str, List[int]]:
        return {
            k: [int(x) for x in getattr(self, k)]
            for k in ("microbatches", "remat_full", "fsdp", "compress")
        }


MICROBATCHES = (1, 2, 4, 8, 16, 32)


def lm_sw_lattice(op: str) -> LMSwLattice:
    """The software lattice an op minimizes over (the tile-size analogue).

    Train steps search the full ``microbatches x remat x fsdp x compress``
    product (48 rows, matching :func:`repro_torch.core.meshopt.enumerate_plans`'s
    knob ranges); inference ops and MoE dispatch have no backward pass, so
    only the weight-sharding knob remains (2 rows).
    """
    if op == "train":
        rows = list(
            itertools.product(MICROBATCHES, (0, 1), (0, 1), (0, 1))
        )
    else:
        rows = [(1, 0, 0, 0), (1, 0, 1, 0)]
    cols = list(zip(*rows))
    return LMSwLattice(
        microbatches=tuple(cols[0]),
        remat_full=tuple(cols[1]),
        fsdp=tuple(cols[2]),
        compress=tuple(cols[3]),
    )


# ---------------------------------------------------------------------------
# Cell builders
# ---------------------------------------------------------------------------
def lm_cells_for(
    cfg: ArchConfig,
    shapes: Optional[Dict[str, ShapeSpec]] = None,
    freq: float = 1.0,
) -> List[LMCell]:
    """Unnormalized cells for one architecture: prefill + decode@batch-64 +
    train step, plus the MoE dispatch op when the config routes experts.

    ``shapes`` overrides the per-op shape table (keys: op names); parameter
    counts come from the real model built on the meta device, so they are
    exact without allocating anything.
    """
    from ..models.model import active_params, count_params
    from ..serve.kvcache import cache_bytes

    shapes = {
        "prefill": SHAPES["prefill_32k"],
        "decode": DECODE_B64,
        "train": SHAPES["train_4k"],
        **(shapes or {}),
    }
    n_params = int(count_params(cfg))
    n_active = int(active_params(cfg))
    cells: List[LMCell] = []
    for op in ("prefill", "decode", "train"):
        shape = shapes[op]
        if shape.kind != op:
            raise ValueError(f"shape {shape.name!r} is kind {shape.kind!r}, not {op!r}")
        tokens = shape.tokens if op != "decode" else shape.global_batch
        mult = 6.0 if op == "train" else 2.0
        kv = (
            int(cache_bytes(cfg, shape.global_batch, shape.seq_len))
            if op == "decode"
            else 0
        )
        cells.append(
            LMCell(
                model=cfg.name,
                op=op,
                shape=shape,
                freq=freq,
                n_params=n_params,
                n_active=n_active,
                kv_bytes=kv,
                d_model=cfg.d_model,
                n_layers=cfg.n_layers,
                flops=mult * n_active * tokens,
            )
        )
    if cfg.moe is not None:
        shape = shapes.get("moe_dispatch", shapes["decode"])
        tokens = shape.tokens if shape.kind != "decode" else shape.global_batch
        cells.append(
            LMCell(
                model=cfg.name,
                op="moe_dispatch",
                shape=shape,
                freq=freq,
                n_params=n_params,
                n_active=n_active,
                kv_bytes=0,
                d_model=cfg.d_model,
                n_layers=cfg.n_layers,
                flops=2.0 * cfg.d_model * cfg.moe.n_experts * tokens,
                moe_top_k=cfg.moe.top_k,
                moe_capacity=cfg.moe.capacity_factor,
                moe_n_experts=cfg.moe.n_experts,
            )
        )
    return cells


def lm_workload(
    archs: Sequence = ("llama3-8b", "mixtral-8x22b"),
    name: str = "lm",
    shapes: Optional[Dict[str, ShapeSpec]] = None,
) -> Workload:
    """Uniform-frequency LM workload over the given architectures (names
    resolved through the config registry, or :class:`ArchConfig` objects
    passed directly -- tests use ``cfg.reduced()``). The default pair is
    the docs walkthrough's: a dense 8B and a large MoE."""
    from ..configs import get_arch

    cfgs = [a if isinstance(a, ArchConfig) else get_arch(a) for a in archs]
    raw: List[LMCell] = []
    for cfg in cfgs:
        raw.extend(lm_cells_for(cfg, shapes=shapes))
    cells = tuple(dataclasses.replace(c, freq=1.0 / len(raw)) for c in raw)
    return Workload(name=name, cells=cells)


# ---------------------------------------------------------------------------
# Scalar oracle
# ---------------------------------------------------------------------------
def _div_ok(op: str, gb: int, data_shards: int, microbatches: int) -> bool:
    """The :func:`repro_torch.core.meshopt.optimize` shardability constraints."""
    if gb % data_shards and gb >= data_shards:
        return False
    if op == "train" and gb % (data_shards * microbatches):
        return False
    return True


def lm_cell_roofline(cell: LMCell, plan: MeshPlan) -> Dict:
    """Plain-scalar reference model for one (cell, plan) point.

    For prefill/decode/train this mirrors
    :func:`repro_torch.core.lmtime.lm_roofline` expression for expression (a
    test asserts term-level equality against it); ``moe_dispatch`` is
    defined here: the dispatch+combine all-to-all of ``capacity * top_k``
    routed tokens over the model axis as expert parallelism, plus the
    router matmul, with weight-fit feasibility. Adds the mesh
    shardability constraint (``div_ok``) on top of the HBM fit;
    ``feasible`` is their conjunction and is what the sweep masks on.
    """
    chips = plan.chips
    ds = plan.data_shards
    tokens = cell.tokens
    peak, hbm_bw = HW["peak_flops_bf16"], HW["hbm_bw"]
    ici_bw = HW["ici_links"] * HW["ici_link_bw"]
    if cell.op == "moe_dispatch":
        tokens_local = tokens / ds
        toks_chip = cell.moe_capacity * cell.moe_top_k * tokens / chips
        t_compute = 2.0 * cell.d_model * cell.moe_n_experts * tokens / chips / peak
        t_memory = 2.0 * toks_chip * cell.d_model * 2.0 / hbm_bw
        ep_factor = (plan.model - 1) / plan.model
        t_coll = 2.0 * toks_chip * cell.d_model * 2.0 * ep_factor / ici_bw
        w_shards = plan.model * (ds if plan.fsdp else 1)
        hbm = 2.0 * cell.n_params / w_shards
    else:
        train = cell.op == "train"
        n_layers_eff = max(cell.n_layers, 1)
        recompute = 1.0 + (0.5 if (train and plan.remat == "full") else 0.0)
        t_compute = cell.flops * recompute / (chips * peak)
        passes = (2.0 if train else 1.0) * plan.microbatches
        w_shards = plan.model * (ds if plan.fsdp else 1)
        weight_traffic = 2.0 * cell.n_params / w_shards * passes
        tokens_local = tokens / ds
        act_traffic = 12.0 * tokens_local * cell.d_model * 2.0 * n_layers_eff
        opt_traffic = (12.0 * cell.n_params / chips) if train else 0.0
        kv_traffic = cell.kv_bytes / chips if cell.op == "decode" else 0.0
        t_memory = (weight_traffic + act_traffic + opt_traffic + kv_traffic) / hbm_bw
        tp_factor = 0.0 if plan.model == 1 else 2.0 * (plan.model - 1) / plan.model
        ar_per_layer = (4.0 if train and plan.remat == "full" else 2.0) * (
            2.0 if train else 1.0
        ) / 2.0
        tp_bytes = (
            ar_per_layer * n_layers_eff * tokens_local * cell.d_model * 2.0 * tp_factor
        ) * plan.microbatches
        dp_factor = 0.0 if ds == 1 or not train else 2.0 * (ds - 1) / ds
        grad_bytes_unit = 1.0 if plan.compress_grads else 4.0
        dp_bytes = grad_bytes_unit * cell.n_params / plan.model * dp_factor
        fsdp_bytes = 2.0 * cell.n_params / plan.model * passes if plan.fsdp else 0.0
        pod_fraction = 0.0 if plan.pod == 1 else (plan.pod - 1) / plan.pod
        dci_bytes = dp_bytes * pod_fraction
        ici_bytes = tp_bytes + fsdp_bytes + dp_bytes * (1 - pod_fraction)
        t_coll = ici_bytes / ici_bw + dci_bytes / HW["dci_link_bw"]
        hbm = 2.0 * cell.n_params / w_shards
        if train:
            hbm += 12.0 * cell.n_params / chips
            hbm += 3.0 * (tokens_local / plan.microbatches) * cell.d_model * 2.0 * (
                n_layers_eff
            ) * (1.0 if plan.remat == "full" else 4.0)
        if cell.op == "decode":
            hbm += cell.kv_bytes / chips
    terms = {"compute_s": t_compute, "memory_s": t_memory, "collective_s": t_coll}
    dominant = max(terms, key=terms.get)
    fits = hbm <= HW["hbm_bytes"] * 0.9
    div_ok = _div_ok(cell.op, cell.shape.global_batch, ds, plan.microbatches)
    return {
        **terms,
        "dominant": dominant.replace("_s", ""),
        "bound_s": terms[dominant],
        "hbm_bytes": hbm,
        "fits": fits,
        "div_ok": div_ok,
        "feasible": fits and div_ok,
    }


# ---------------------------------------------------------------------------
# Vectorized twin
# ---------------------------------------------------------------------------
def _grid_times(op, consts, pod, data, model, mb, remat, fsdp, compress, xp):
    """(H, L) bound-seconds grid; +inf where infeasible.

    ``op`` is the only static branch (cell *structure*); ``xp`` is the
    numpy or torch ops namespace of :mod:`repro_torch.core.timemodel`, and
    every numeric input arrives as one of its float64 arrays (the cell
    constants and the fleet constants too: torch divides by a Python
    number through its reciprocal on some devices), so the body evaluates
    the scalar oracle's expressions in their order. Hardware columns
    arrive shaped (H, 1), software columns (L,); all terms broadcast to
    (H, L).
    """
    (tokens, gb, n_params, kv_bytes, d_model, n_layers_eff, flops,
     top_k, capacity, n_experts) = consts
    chips = pod * data * model
    ds = pod * data
    peak, hbm_bw = xp.asarray(HW["peak_flops_bf16"]), xp.asarray(HW["hbm_bw"])
    ici_bw = xp.asarray(HW["ici_links"] * HW["ici_link_bw"])
    dci_bw = xp.asarray(HW["dci_link_bw"])
    one = xp.ones_like(mb)  # broadcast helper: (L,)
    if op == "moe_dispatch":
        toks_chip = capacity * top_k * tokens / chips
        t_compute = (2.0 * d_model * n_experts * tokens / chips / peak) * one
        t_memory = (2.0 * toks_chip * d_model * 2.0 / hbm_bw) * one
        ep_factor = (model - 1) / model
        t_coll = (2.0 * toks_chip * d_model * 2.0 * ep_factor / ici_bw) * one
        w_shards = model * (1.0 + fsdp * (ds - 1.0))
        hbm = 2.0 * n_params / w_shards
    else:
        train = op == "train"
        recompute = 1.0 + 0.5 * remat if train else one
        t_compute = flops * recompute / (chips * peak)
        passes = (2.0 if train else 1.0) * mb
        w_shards = model * (1.0 + fsdp * (ds - 1.0))
        weight_traffic = 2.0 * n_params / w_shards * passes
        tokens_local = tokens / ds
        act_traffic = 12.0 * tokens_local * d_model * 2.0 * n_layers_eff
        opt_traffic = 12.0 * n_params / chips if train else 0.0
        kv_traffic = kv_bytes / chips if op == "decode" else 0.0
        t_memory = (weight_traffic + act_traffic + opt_traffic + kv_traffic) / hbm_bw
        tp_factor = 2.0 * (model - 1.0) / model
        ar_per_layer = (2.0 + 2.0 * remat) * 2.0 / 2.0 if train else one
        tp_bytes = (
            ar_per_layer * n_layers_eff * tokens_local * d_model * 2.0 * tp_factor
        ) * mb
        dp_factor = 2.0 * (ds - 1.0) / ds if train else 0.0
        grad_bytes_unit = 4.0 - 3.0 * compress
        dp_bytes = grad_bytes_unit * n_params / model * dp_factor
        fsdp_bytes = fsdp * (2.0 * n_params / model * passes)
        pod_fraction = (pod - 1.0) / pod
        dci_bytes = dp_bytes * pod_fraction
        ici_bytes = tp_bytes + fsdp_bytes + dp_bytes * (1 - pod_fraction)
        t_coll = ici_bytes / ici_bw + dci_bytes / dci_bw
        hbm = 2.0 * n_params / w_shards
        if train:
            hbm = hbm + 12.0 * n_params / chips + 3.0 * (
                tokens_local / mb
            ) * d_model * 2.0 * n_layers_eff * (4.0 - 3.0 * remat)
        if op == "decode":
            hbm = hbm + kv_bytes / chips
    bound = xp.maximum(t_compute, xp.maximum(t_memory, t_coll))
    fits = hbm <= HW["hbm_bytes"] * 0.9
    div = (xp.mod(gb, ds) == 0) | (gb < ds)
    if op == "train":
        div = div & (xp.mod(gb, ds * mb) == 0)
    feasible = fits & div
    return xp.where(feasible, bound, xp.inf)


def _cell_consts(cell: LMCell) -> Tuple[float, ...]:
    """The numeric tuple :func:`_grid_times` consumes (order matters)."""
    return (
        float(cell.tokens),
        float(cell.shape.global_batch),
        float(cell.n_params),
        float(cell.kv_bytes),
        float(cell.d_model),
        float(max(cell.n_layers, 1)),
        float(cell.flops),
        float(cell.moe_top_k),
        float(cell.moe_capacity),
        float(cell.moe_n_experts),
    )


def resolve_lm_engine(engine: str, n_hw: int) -> str:
    """Concrete engine for an LM sweep over ``n_hw`` hardware points: the
    single-device half of the stencil rule (``"auto"`` is numpy below 64
    points, else torch; ``"jax"`` and ``"sharded"`` are no LM engines of
    the port and raise)."""
    from .codesign import _AUTO_MIN_HW

    if engine not in ("auto", "torch", "numpy"):
        raise ValueError(f"unknown engine {engine!r} (want auto|torch|numpy)")
    if engine == "auto":
        return "numpy" if n_hw < _AUTO_MIN_HW else "torch"
    return engine


# ---------------------------------------------------------------------------
# Result + driver
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class LMCodesignResult:
    """Per-cell optimal step times for every mesh factorization -- the LM
    twin of :class:`repro_torch.core.codesign.CodesignResult`, exposing the same
    reduction surface so the artifact store, query engine, and gateway
    treat both families uniformly. ``gflops`` here reads "model GFLOP/s":
    useful model FLOPs per step over the optimized step time."""

    workload: Workload
    hw: LMHardwareSpace
    cell_time: np.ndarray  # (C, H) optimal bound_s; +inf infeasible
    cell_plan_idx: np.ndarray  # (C, H) winning sw-lattice row (-1 infeasible)
    sw_lattices: List[LMSwLattice]  # per cell
    gpu_name: str = LM_GPU_NAME

    family = "lm"

    # ---- reductions (same contracts as CodesignResult) --------------------
    def cell_freqs(self) -> np.ndarray:
        return np.array([c.freq for c in self.workload.cells], np.float64)

    def cell_flops(self) -> np.ndarray:
        return np.array([c.flops for c in self.workload.cells], np.float64)

    def weighted_time(self, freqs: Optional[np.ndarray] = None) -> np.ndarray:
        if freqs is None:
            freqs = self.cell_freqs()
        freqs = np.asarray(freqs, np.float64)
        return freqs @ self.cell_time

    def gflops(self, freqs: Optional[np.ndarray] = None) -> np.ndarray:
        if freqs is None:
            freqs = self.cell_freqs()
        freqs = np.asarray(freqs, np.float64)
        return (freqs @ self.cell_flops()) / self.weighted_time(freqs) / 1.0e9

    def pareto(self, freqs: Optional[np.ndarray] = None) -> np.ndarray:
        return pareto_mask(self.hw.area, self.gflops(freqs))

    def best(self, max_area: float = np.inf, freqs=None) -> Tuple[int, float]:
        g = self.gflops(freqs)
        g = np.where(self.hw.area <= max_area, g, -np.inf)
        i = int(np.argmax(g))
        return i, float(g[i])

    def plan_for(self, cell_index: int, hw_index: int) -> MeshPlan:
        """The winning :class:`MeshPlan` of one (cell, hw) solve."""
        j = int(self.cell_plan_idx[cell_index, hw_index])
        if j < 0:
            raise ValueError("infeasible cell/hw combination")
        p = self.hw.point(hw_index)
        return self.sw_lattices[cell_index].plan(p["pod"], p["data"], p["model"], j)

    def routing_metadata(self) -> Dict[str, object]:
        """Manifest routing block: same keys a stencil sweep publishes
        (gpu, workload) plus the LM discriminators (family, models, ops) --
        ``workload: "lm"`` is what ``query --workload lm`` selects on."""
        return {
            "gpu": self.gpu_name,
            "workload": self.workload.name,
            "family": "lm",
            "models": sorted({c.model for c in self.workload.cells}),
            "ops": sorted({c.op for c in self.workload.cells}),
        }

    # ---- artifact serialization ------------------------------------------
    def artifact_payload(self) -> Tuple[dict, Dict[str, np.ndarray]]:
        """(manifest, arrays) split; exact inverse of
        :meth:`from_artifact_payload` (JSON round-trips float64 losslessly)."""
        unique: List[LMSwLattice] = []
        lat_idx: List[int] = []
        for lat in self.sw_lattices:
            if lat not in unique:
                unique.append(lat)
            lat_idx.append(unique.index(lat))
        manifest = {
            "workload": {
                "name": self.workload.name,
                "family": "lm",
                "cells": [
                    {
                        "model": c.model,
                        "op": c.op,
                        "shape": {
                            "name": c.shape.name,
                            "seq_len": int(c.shape.seq_len),
                            "global_batch": int(c.shape.global_batch),
                            "kind": c.shape.kind,
                        },
                        "freq": float(c.freq),
                        "consts": c.consts(),
                        "lattice": lat_idx[i],
                    }
                    for i, c in enumerate(self.workload.cells)
                ],
            },
            "gpu": {"name": self.gpu_name, "hw": dict(HW)},
            "sw_lattices": [lat.as_dict() for lat in unique],
            "routing": self.routing_metadata(),
        }
        arrays = {
            "cell_time": np.asarray(self.cell_time, np.float64),
            "cell_plan_idx": np.asarray(self.cell_plan_idx, np.int64),
            "hw_pod": np.asarray(self.hw.pod, np.float64),
            "hw_data": np.asarray(self.hw.data, np.float64),
            "hw_model": np.asarray(self.hw.model, np.float64),
            "hw_area": np.asarray(self.hw.area, np.float64),
        }
        return manifest, arrays

    @staticmethod
    def parse_manifest(
        manifest: dict,
    ) -> Tuple[Workload, str, List[LMSwLattice]]:
        """JSON-only half of :meth:`from_artifact_payload`: ``(workload,
        gpu_name, per-cell sw lattices)``, touching no arrays."""
        lattices_tbl = [
            LMSwLattice(**{k: tuple(int(x) for x in v) for k, v in d.items()})
            for d in manifest["sw_lattices"]
        ]
        cells: List[LMCell] = []
        lattices: List[LMSwLattice] = []
        for c in manifest["workload"]["cells"]:
            s = c["shape"]
            shape = ShapeSpec(s["name"], s["seq_len"], s["global_batch"], s["kind"])
            cells.append(
                LMCell(
                    model=c["model"], op=c["op"], shape=shape, freq=c["freq"],
                    **c["consts"],
                )
            )
            lattices.append(lattices_tbl[c["lattice"]])
        workload = Workload(manifest["workload"]["name"], tuple(cells))
        return workload, manifest["gpu"]["name"], lattices

    @classmethod
    def from_artifact_payload(
        cls, manifest: dict, arrays: Dict[str, np.ndarray]
    ) -> "LMCodesignResult":
        workload, gpu_name, lattices = cls.parse_manifest(manifest)
        hw = LMHardwareSpace(
            pod=np.asarray(arrays["hw_pod"], np.float64),
            data=np.asarray(arrays["hw_data"], np.float64),
            model=np.asarray(arrays["hw_model"], np.float64),
            area=np.asarray(arrays["hw_area"], np.float64),
        )
        return cls(
            workload=workload,
            hw=hw,
            cell_time=np.asarray(arrays["cell_time"]),
            cell_plan_idx=np.asarray(arrays["cell_plan_idx"]),
            sw_lattices=lattices,
            gpu_name=gpu_name,
        )


def lm_codesign(
    workload: Workload,
    hw: Optional[LMHardwareSpace] = None,
    max_chips: int = 512,
    engine: str = "auto",
    gpu_name: str = LM_GPU_NAME,
    device=None,
) -> LMCodesignResult:
    """Eq. (18) for the LM family: for every mesh factorization, the
    optimal software knobs (and step time) of every cell.

    ``engine="numpy"`` evaluates the oracle's float64 expressions
    vectorized (bit-exact vs :func:`lm_cell_roofline`); ``"torch"``
    evaluates the same body in float64 on ``device`` (the card unless
    ``device="cpu"``; without a card it raises); ``"auto"`` is numpy below
    64 hardware points, else torch. Infeasible (cell, hw) combinations --
    HBM overflow or unshardable batch at every software setting -- carry
    ``+inf`` time and plan index ``-1``, exactly the stencil sweep's
    convention; the plan is the first minimum of its row in both engines.
    """
    if getattr(workload, "family", "stencil") != "lm":
        raise ValueError(f"lm_codesign wants an LM workload, got {workload.family!r}")
    if hw is None:
        hw = enumerate_lm_hw_space(max_chips=max_chips)
    eng = resolve_lm_engine(engine, len(hw))
    C, H = len(workload.cells), len(hw)
    cell_time = np.empty((C, H))
    cell_idx = np.empty((C, H), dtype=np.int64)
    lattices = [lm_sw_lattice(c.op) for c in workload.cells]
    ops = _ops(torch, torch.float64, device) if eng == "torch" else _ops(np, None, None)
    pod, data, model = (ops.asarray(a)[:, None] for a in (hw.pod, hw.data, hw.model))
    for ci, cell in enumerate(workload.cells):
        lat = lattices[ci]
        grid = _grid_times(
            cell.op, tuple(ops.asarray(c) for c in _cell_consts(cell)),
            pod, data, model,
            ops.asarray(lat.microbatches), ops.asarray(lat.remat_full),
            ops.asarray(lat.fsdp), ops.asarray(lat.compress),
            ops,
        )
        if eng == "torch":
            idx = torch.argmin(grid, dim=1)  # the first minimum, as np.argmin
            t = grid.gather(1, idx[:, None])[:, 0]
            idx, t = idx.cpu().numpy(), t.cpu().numpy()
        else:
            idx = np.argmin(grid, axis=1)
            t = grid[np.arange(H), idx]
        cell_time[ci] = t
        cell_idx[ci] = np.where(np.isfinite(t), idx, -1)
    return LMCodesignResult(workload, hw, cell_time, cell_idx, lattices, gpu_name)
