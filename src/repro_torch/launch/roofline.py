"""Roofline analysis over the dry-run records (the JAX package's
``launch/roofline.py``, with the H100's constants).

The three roofline terms are derived per (arch x shape x mesh) from a
record of :mod:`repro_torch.launch.dryrun` (or of the reference's dry
run: the keys are the same):

    compute term    = dot FLOPs / peak FLOP/s                [per chip]
    memory term     = materialized bytes / HBM bandwidth     [per chip]
    collective term = collective bytes / (links * link bw)   [per chip]

where the dot FLOPs count every matmul that runs (layer loops, microbatch
accumulation and remat recomputes included), the materialized bytes are
2 x the bytes of every tensor an op allocates, and the collective bytes
the operand bytes of every collective. The records are per chip, so each
term is a per-chip, per-step time bound. All of them are predictions of
a model of the card, not measurements of it.

Also reported per cell: the dominant term, MODEL_FLOPS = 6*N(_active)*D
(2*N*D for inference shapes), the useful-compute ratio MODEL_FLOPS/dot
FLOPs, and a one-line lever for the dominant term.

The links are one class: NVLink 4 between the 8 cards of one host.
Traffic between hosts (beyond 8 cards, over the network) is not modelled,
so the collective term of a 256- or 512-card mesh is a lower bound.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Dict, List, Optional

__all__ = ["HW", "model_flops_for", "roofline_terms", "load_cells", "analyze_cell",
           "render_table", "main"]

#: NVIDIA H100 SXM5 80 GB per-card constants (NVIDIA's data sheet, dense
#: rates without sparsity, at the card's full 700 W power limit).
HW = {
    "peak_flops_bf16": 989e12,  # FLOP/s, bf16 tensor cores
    "hbm_bw": 3.35e12,  # B/s, HBM3
    "ici_link_bw": 25e9,  # B/s per NVLink 4 link, per direction
    "ici_links": 18,  # NVLink 4 links per card
    "hbm_bytes": 80e9,
}


def model_flops_for(rec: Dict, seq_len: int, global_batch: int) -> float:
    """6*N_active*D for training, 2*N_active*D forward-only (prefill),
    2*N_active*B for one decoded token."""
    n = rec.get("active_params") or rec.get("params") or 0
    kind = rec.get("kind", "train")
    if kind == "train":
        return 6.0 * n * seq_len * global_batch
    if kind == "prefill":
        return 2.0 * n * seq_len * global_batch
    return 2.0 * n * global_batch  # decode: one token per sequence


def roofline_terms(rec: Dict, chips: Optional[int] = None) -> Dict:
    """Three terms in seconds (per chip = per step wall-clock bound)."""
    chips = chips or rec.get("chips", 256)
    raw_flops = rec.get("flops", 0.0) or 0.0
    exp_flops = rec.get("dot_flops_expanded", 0.0) or 0.0
    ratio = exp_flops / raw_flops if raw_flops > 0 and exp_flops > 0 else 1.0
    ratio = max(ratio, 1.0)
    bytes_accessed = rec.get("materialized_bytes", 0.0) or (
        (rec.get("bytes_accessed", 0.0) or 0.0) * ratio
    )
    coll = rec.get("collective_bytes", 0.0) or 0.0

    t_compute = exp_flops / HW["peak_flops_bf16"]
    t_memory = bytes_accessed / HW["hbm_bw"]
    t_coll = coll / (HW["ici_links"] * HW["ici_link_bw"])
    terms = {"compute_s": t_compute, "memory_s": t_memory, "collective_s": t_coll}
    dominant = max(terms, key=terms.get)
    bound = terms[dominant]
    out = dict(terms)
    out["dominant"] = dominant.replace("_s", "")
    out["bound_s"] = bound
    out["bytes_expansion_ratio"] = ratio
    return out


_LEVERS = {
    "compute": (
        "cut recompute (remat policy) or raise tensor-core utilization "
        "(bf16 products, fused attention, dims padded to multiples of 64)"
    ),
    "memory": (
        "raise arithmetic intensity: larger microbatch per card, bf16 "
        "elementwise passes where safe, fuse normalization and softmax chains"
    ),
    "collective": (
        "re-shard to cut all-reduce bytes: sequence-parallel reduce-scatter, "
        "microbatch-amortized grad reduction, int8 compression across hosts, "
        "or a mesh that keeps tensor parallelism inside one NVLink domain (meshopt)"
    ),
}


def load_cells(outdir: str, mesh_kind: str = "single") -> List[Dict]:
    d = os.path.join(outdir, mesh_kind)
    cells = []
    if not os.path.isdir(d):
        return cells
    for name in sorted(os.listdir(d)):
        if name.endswith(".json"):
            with open(os.path.join(d, name)) as f:
                cells.append(json.load(f))
    return cells


def analyze_cell(rec: Dict, shapes: Dict) -> Optional[Dict]:
    if rec.get("skipped") or "error" in rec:
        return None
    shape = shapes[rec["shape"]]
    terms = roofline_terms(rec)
    mf_total = model_flops_for(rec, shape.seq_len, shape.global_batch)
    mf_chip = mf_total / rec.get("chips", 256)
    hlo = rec.get("dot_flops_expanded", 0.0) or 1.0
    useful = mf_chip / hlo if hlo else 0.0
    step_s = terms["bound_s"]
    mfu = (mf_chip / HW["peak_flops_bf16"]) / step_s if step_s > 0 else 0.0
    return {
        "arch": rec["arch"],
        "shape": rec["shape"],
        "mesh": rec["mesh"],
        "plan": rec.get("plan", {}),
        **{k: terms[k] for k in ("compute_s", "memory_s", "collective_s")},
        "dominant": terms["dominant"],
        "model_flops_per_chip": mf_chip,
        "useful_ratio": useful,
        "roofline_fraction": mfu,
        "lever": _LEVERS[terms["dominant"]],
        "hbm_gb": (rec.get("memory", {}).get("temp_size_in_bytes", 0)
                   + rec.get("memory", {}).get("argument_size_in_bytes", 0)) / 1e9,
    }


def render_table(rows: List[Dict]) -> str:
    hdr = (
        "| arch | shape | compute s | memory s | collective s | dominant | "
        "useful | roofline frac | HBM GB |\n"
        "|---|---|---|---|---|---|---|---|---|\n"
    )
    lines = []
    for r in rows:
        lines.append(
            f"| {r['arch']} | {r['shape']} | {r['compute_s']:.3e} | "
            f"{r['memory_s']:.3e} | {r['collective_s']:.3e} | "
            f"**{r['dominant']}** | {r['useful_ratio']:.2f} | "
            f"{r['roofline_fraction']:.3f} | {r['hbm_gb']:.1f} |"
        )
    return hdr + "\n".join(lines)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="roofline terms of the dry-run records")
    ap.add_argument("--out", default="build/dryrun")
    ap.add_argument("--mesh", default="single")
    ap.add_argument("--json", default="")
    args = ap.parse_args(argv)
    from ..configs.base import SHAPES

    rows = []
    for rec in load_cells(args.out, args.mesh):
        row = analyze_cell(rec, SHAPES)
        if row:
            rows.append(row)
    rows.sort(key=lambda r: (r["arch"], r["shape"]))
    print(render_table(rows))
    if args.json:
        with open(args.json, "w") as f:
            json.dump(rows, f, indent=1)


if __name__ == "__main__":
    main()
