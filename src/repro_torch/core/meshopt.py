"""Mesh/sharding codesign -- the paper's eq. (18) over the modelled fleet
(the JAX package's ``core/meshopt.py``).

Exhaustive search over the hardware factorization (pod, data, model) of the
chip budget x an independent small integer search over the software knobs
(microbatches, remat, fsdp, compression) per (arch, shape) cell -- exactly
the separability decomposition the paper uses for (n_SM, n_V, M_SM) x tile
sizes. The analytic `lm_roofline` plays T_alg; HBM capacity plays the chip
area budget.

Output is a ranked list of feasible plans per cell.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

from ..configs.base import ArchConfig, ShapeSpec
from .lmtime import MeshPlan, lm_roofline

__all__ = ["enumerate_plans", "optimize", "pareto_plans"]


def _factorizations(chips: int, multi_pod: bool) -> List[Tuple[int, int, int]]:
    pods = [2] if multi_pod else [1]
    out = []
    for pod in pods:
        rest = chips // pod
        model = 1
        while model <= rest:
            if rest % model == 0:
                out.append((pod, rest // model, model))
            model *= 2
    return out


def enumerate_plans(
    chips: int = 256,
    multi_pod: bool = False,
    microbatches=(1, 2, 4, 8, 16, 32),
    remats=("none", "full"),
    fsdps=(False, True),
    compress=(False, True),
    train: bool = True,
) -> List[MeshPlan]:
    plans = []
    for pod, data, model in _factorizations(chips, multi_pod):
        for mb in microbatches if train else (1,):
            for remat in remats if train else ("none",):
                for fsdp in fsdps:
                    for comp in compress if (train and pod > 1) else (False,):
                        plans.append(
                            MeshPlan(pod, data, model, mb, remat, fsdp, comp)
                        )
    return plans


def optimize(
    cfg: ArchConfig,
    shape: ShapeSpec,
    n_params: int,
    n_active: int,
    chips: int = 256,
    multi_pod: bool = False,
    top_k: int = 5,
    constraints: Optional[Dict] = None,
) -> List[Dict]:
    """Ranked feasible plans (lowest bound_s first) for one cell."""
    train = shape.kind == "train"
    results = []
    for plan in enumerate_plans(chips, multi_pod, train=train):
        if shape.global_batch % plan.data_shards and shape.global_batch >= plan.data_shards:
            continue
        if train and shape.global_batch % (plan.data_shards * plan.microbatches):
            continue
        r = lm_roofline(cfg, shape, plan, n_params, n_active)
        if constraints:
            if not all(r.get(k) == v for k, v in constraints.items()):
                continue
        if not r["fits"]:
            continue
        results.append({"plan": dataclasses.asdict(plan), **r})
    results.sort(key=lambda r: r["bound_s"])
    return results[:top_k]


def pareto_plans(results: List[Dict]) -> List[Dict]:
    """Pareto set over (chips used, bound_s) -- the Fig. 3 analogue."""
    out = []
    best = float("inf")
    for r in sorted(results, key=lambda r: r["plan"]["pod"] * r["plan"]["data"] * r["plan"]["model"]):
        if r["bound_s"] < best:
            best = r["bound_s"]
            out.append(r)
    return out
