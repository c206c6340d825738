"""Analytic execution-time model for the LM cells -- the `T(p, h, s)` of
the paper's codesign problem over a modelled accelerator fleet (the JAX
package's ``core/lmtime.py``).

Problem parameters  p: ArchConfig + ShapeSpec
Hardware parameters h: mesh factorization (pod, data, model) of the chip
                       budget -- the paper's (n_SM, n_V, M_SM) analogue
Software parameters s: microbatches, remat policy, fsdp on/off,
                       gradient compression -- the paper's tile sizes

The model returns the three roofline terms (seconds/step, per chip) plus
an HBM-fit feasibility flag (the eq. 9/11 analogue: the working set must
fit the per-chip memory budget). Its answers are model predictions for the
modelled fleet, not measurements of the card this package runs on.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

from ..configs.base import ArchConfig, ShapeSpec

__all__ = ["MeshPlan", "lm_roofline", "HW"]

#: Per-chip constants of the modelled fleet: the JAX package's ``HW``,
#: copied unchanged so both packages give the same answers. They are a
#: model input, not a property of the card this package runs on. Units:
#: ``peak_flops_bf16`` FLOP/s, ``hbm_bw``/``ici_link_bw``/``dci_link_bw``
#: bytes/s, ``ici_links`` count (the modelled torus gives each chip 4
#: usable links), ``hbm_bytes`` bytes.
HW = {
    "peak_flops_bf16": 197e12,
    "hbm_bw": 819e9,
    "ici_link_bw": 50e9,
    "ici_links": 4,
    "dci_link_bw": 12.5e9,  # cross-pod (data-center network) per chip
    "hbm_bytes": 16e9,
}


@dataclasses.dataclass(frozen=True)
class MeshPlan:
    """One point in the hardware x software design space.

    Hardware axes (chip-count factorization, ``chips = pod*data*model``):
    ``pod`` pods bridged by DCN, ``data``-way data parallelism within a
    pod, ``model``-way tensor parallelism. Software knobs (the paper's
    tile-size analogue): ``microbatches`` splits the global batch into
    sequential pipeline passes; ``remat`` trades +50% forward FLOPs for a
    4x smaller activation working set when "full"; ``fsdp`` additionally
    shards weights over the data axis (all-gathering them per pass);
    ``compress_grads`` sends int8 (1-byte) instead of f32 gradients in the
    data-parallel all-reduce.
    """

    pod: int
    data: int
    model: int
    microbatches: int = 1
    remat: str = "full"  # none | full
    fsdp: bool = False
    compress_grads: bool = False

    @property
    def chips(self) -> int:
        return self.pod * self.data * self.model

    @property
    def data_shards(self) -> int:
        return self.pod * self.data


def _param_bytes(n_params: int) -> float:
    return 2.0 * n_params  # bf16 storage


def lm_roofline(
    cfg: ArchConfig,
    shape: ShapeSpec,
    plan: MeshPlan,
    n_params: int,
    n_active: int,
) -> Dict:
    """Three analytic roofline terms + feasibility for one design point.

    Args:
        cfg: architecture (only ``d_model``/``n_layers`` enter directly;
            expert sparsity is already folded into ``n_active``).
        shape: workload shape; ``kind`` picks the cost model. For decode,
            "one step" means one token generated per sequence, so the
            compute term scales with ``global_batch`` tokens while the
            memory term streams the full ``seq_len``-deep KV cache.
        plan: mesh factorization + software knobs (see :class:`MeshPlan`).
        n_params: total parameter count (elements, bf16-stored).
        n_active: parameters touched per token (``< n_params`` for MoE).

    Returns a dict of per-step wall-clock seconds — ``compute_s``,
    ``memory_s``, ``collective_s``, their max ``bound_s`` with the
    ``dominant`` term's name — plus the per-chip working set ``hbm_bytes``
    and ``fits`` (True iff it is under 90% of HBM, the eq. 9/11 analogue).
    All terms are smooth in the plan parameters, so a vectorized twin
    (:mod:`repro_torch.core.lmcells`) evaluates the whole lattice at once.
    """
    chips = plan.chips
    tokens = shape.tokens if shape.kind != "decode" else shape.global_batch
    train = shape.kind == "train"

    # ---- compute ----------------------------------------------------------
    mult = 6.0 if train else 2.0
    flops_total = mult * n_active * tokens
    recompute = 1.0 + (0.5 if (train and plan.remat == "full") else 0.0)
    t_compute = flops_total * recompute / (chips * HW["peak_flops_bf16"])

    # ---- memory -----------------------------------------------------------
    # weights stream per microbatch pass (fwd [+bwd]), sharded over
    # model (x data when fsdp); optimizer state traffic once per step
    passes = (2.0 if train else 1.0) * plan.microbatches
    w_shards = plan.model * (plan.data_shards if plan.fsdp else 1)
    weight_traffic = _param_bytes(n_params) / w_shards * passes
    tokens_local = tokens / plan.data_shards
    act_traffic = 12.0 * tokens_local * cfg.d_model * 2.0 * max(cfg.n_layers, 1)
    opt_traffic = (12.0 * n_params / chips) if train else 0.0
    kv_traffic = 0.0
    if shape.kind == "decode":
        # decode reads the whole cache once per token
        from ..serve.kvcache import cache_bytes

        kv_traffic = cache_bytes(cfg, shape.global_batch, shape.seq_len) / chips
    t_memory = (weight_traffic + act_traffic / 1.0 + opt_traffic + kv_traffic) / HW[
        "hbm_bw"
    ]

    # ---- collectives ------------------------------------------------------
    # TP: 2 all-reduces of the token activations per layer per pass (4 with
    # full-remat backward recompute); ICI bandwidth
    tp_factor = 0.0 if plan.model == 1 else 2.0 * (plan.model - 1) / plan.model
    ar_per_layer = (4.0 if train and plan.remat == "full" else 2.0) * (
        2.0 if train else 1.0
    ) / 2.0
    tp_bytes = (
        ar_per_layer * max(cfg.n_layers, 1) * tokens_local * cfg.d_model * 2.0 * tp_factor
    ) * plan.microbatches
    # DP gradient reduction: once per step over (pod x data); f32 grads
    dp_size = plan.data_shards
    dp_factor = 0.0 if dp_size == 1 or not train else 2.0 * (dp_size - 1) / dp_size
    grad_bytes_unit = 1.0 if plan.compress_grads else 4.0
    dp_bytes = grad_bytes_unit * n_params / plan.model * dp_factor
    # FSDP weight all-gather per microbatch pass
    fsdp_bytes = (
        _param_bytes(n_params) / plan.model * passes if plan.fsdp else 0.0
    )
    ici_bw = HW["ici_links"] * HW["ici_link_bw"]
    # the pod axis rides the slower cross-pod fabric
    pod_fraction = 0.0 if plan.pod == 1 else (plan.pod - 1) / plan.pod
    dci_bytes = dp_bytes * pod_fraction
    ici_bytes = tp_bytes + fsdp_bytes + dp_bytes * (1 - pod_fraction)
    t_coll = ici_bytes / ici_bw + dci_bytes / HW["dci_link_bw"]

    # ---- feasibility (the eq. 9/11 analogue) ------------------------------
    hbm = _param_bytes(n_params) / w_shards
    if train:
        hbm += 12.0 * n_params / chips  # f32 grads+moments, ZeRO over chips
        hbm += 3.0 * (tokens_local / plan.microbatches) * cfg.d_model * 2.0 * max(
            cfg.n_layers, 1
        ) * (1.0 if plan.remat == "full" else 4.0)
    if shape.kind == "decode":
        from ..serve.kvcache import cache_bytes

        hbm += cache_bytes(cfg, shape.global_batch, shape.seq_len) / chips

    terms = {
        "compute_s": t_compute,
        "memory_s": t_memory,
        "collective_s": t_coll,
    }
    dominant = max(terms, key=terms.get)
    return {
        **terms,
        "dominant": dominant.replace("_s", ""),
        "bound_s": terms[dominant],
        "hbm_bytes": hbm,
        "fits": hbm <= HW["hbm_bytes"] * 0.9,
    }
