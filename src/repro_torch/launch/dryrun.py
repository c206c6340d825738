"""Multi-pod dry run (the JAX package's ``launch/dryrun.py``).

For every (architecture x input shape) cell and both production meshes
(single pod 16x16 = 256 chips, multi-pod 2x16x16 = 512 chips) it traces
one step as rank 0 of a fake process group of 256 or 512 ranks, every
tensor a fake tensor (``FakeTensorMode``: shapes, dtypes and devices, no
storage), and counts what that rank would run (:mod:`.opanalysis`):
FLOPs, collective operand bytes, the bytes it holds and the peak of what
it allocates. Nothing is compiled and no chip is needed beyond the host:
the reference lowers and compiles the step for 512 forced host devices,
the port dispatches it once per op on local shapes. Every number in a
record is a prediction of one chip's work, not a measurement.

``train_4k`` traces the *train step* (fwd + bwd + AdamW); ``prefill_32k``
the prefill (caches, backbone, head on the last position);
``decode_32k`` / ``long_500k`` one token against a ``seq_len``-deep
cache. ``long_500k`` runs only for sub-quadratic archs (ssm / hybrid /
SWA); skips are recorded, not dropped.

Results land as one JSON per cell under ``--out`` with the reference's
keys (``compile_s`` becomes ``trace_s``), so each package's roofline
reads the other's records; the run resumes (existing JSONs are skipped
unless ``--force``) and exits 1 if a cell failed. Tensors are fake
``cuda`` tensors on a ``cuda`` mesh unless ``--device cpu`` is given;
without a card and without ``--device cpu`` it exits 2 with one line.
The process group is process-global: run one dry run per process.

    python -m repro_torch.launch.dryrun --tiny --device cpu \\
        --arch internlm2-1.8b --shape train_4k --mesh both
    python -m repro_torch.launch.dryrun --arch llama3-8b,gemma-7b \\
        --shape prefill_32k,decode_32k --mesh single --jobs 4
    python -m repro_torch.launch.roofline --out build/dryrun --mesh single

``--arch`` and ``--shape`` take ``all``, one id or a comma-separated
list; the cells are their product. Each cell's line gives its per-chip
dot FLOPs, collective bytes, argument + temp bytes and the largest of
its ``peak_holders`` and of its ``collective_ops``; ``launch.roofline``
reads the dominant term.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import sys
import time
import traceback
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import torch

from .._device import resolve_device
from ..configs import ARCHS, SHAPES
from ..configs.base import ArchConfig, ShapeSpec, get_arch
from ..models.model import Model, _head, active_params, count_params, forward, forward_hidden
from ..models.layers import torch_dtype
from ..optim.adamw import AdamWConfig
from ..serve.kvcache import init_caches
from ..sharding.dtensor import distribute_batch, distribute_caches, distribute_model, replicating
from ..sharding.partition import mesh_sizes
from ..train.train_step import TrainConfig, make_train_step, mesh_state
from .mesh import make_mesh, production_shape
from .opanalysis import analyze_ops, argument_bytes

__all__ = [
    "SUBQUADRATIC",
    "applicable",
    "plan_cell",
    "input_specs",
    "fake_mesh",
    "Lowered",
    "lower_cell",
    "analyze",
    "run_cell",
    "main",
]

#: archs whose attention cost is sub-quadratic in context (may run long_500k)
SUBQUADRATIC = {"mamba2-780m", "jamba-v0.1-52b", "mixtral-8x22b"}


def applicable(arch: str, shape_name: str) -> Tuple[bool, str]:
    if shape_name == "long_500k" and arch not in SUBQUADRATIC:
        return False, (
            "full-attention arch: 500k decode is quadratic-cost; skipped per "
            "assignment note (DESIGN.md §Arch-applicability)"
        )
    return True, ""


# ---------------------------------------------------------------------------
# Per-cell plan: the reference's pre-hillclimb defaults
# ---------------------------------------------------------------------------
def plan_cell(cfg: ArchConfig, shape: ShapeSpec, mesh) -> Dict:
    """The reference's planning rule, unchanged (its 4e9-byte thresholds
    are that rule's, not a fit to any chip).

    * fsdp: on when TP-only parameter shards exceed ~4 GB/chip;
    * remat 'full': 'dots' saves attention probability matrices; full
      recompute keeps only the per-layer residual carry;
    * microbatches sized so the saved residual stash (~3x tokens_local *
      d_model * 2 B per layer) stays under ~4 GB/chip, each microbatch
      still sharded over the data axes.

    ``mesh``: a ``DeviceMesh`` or a :class:`~.mesh.MeshShape`.
    """
    axis = mesh_sizes(mesh)
    data_shards = axis.get("data", 1) * axis.get("pod", 1)
    model_size = axis.get("model", 1)
    p_bytes = 2 * count_params(cfg)
    fsdp = p_bytes / model_size > 4e9
    microbatches = 1
    if shape.kind == "train":
        tokens_local = shape.tokens / data_shards
        saved = cfg.n_layers * tokens_local * cfg.d_model * 2 * 3
        mb_cap = max(1, shape.global_batch // data_shards)
        while saved / microbatches > 4e9 and microbatches < mb_cap:
            microbatches *= 2
    return {
        "fsdp": bool(fsdp),
        "microbatches": int(microbatches),
        "remat": "full",
        "attn_impl": "auto",
    }


# ---------------------------------------------------------------------------
# Stand-ins and the traced closures
# ---------------------------------------------------------------------------
def input_specs(cfg: ArchConfig, shape: ShapeSpec, device) -> Dict[str, torch.Tensor]:
    """Stand-ins for the *batch* inputs of the traced step: empty tensors
    of the reference's shapes and dtypes on ``device`` (fake tensors when
    made under a ``FakeTensorMode``)."""
    b, s = shape.global_batch, shape.seq_len

    def empty(shp, dtype):
        return torch.empty(tuple(int(x) for x in shp), dtype=dtype, device=device)

    if shape.kind == "decode":
        return {"tokens": empty((b, 1), torch.int32)}
    specs = {"tokens": empty((b, s), torch.int32)}
    if shape.kind == "train":
        s_lab = s + (cfg.n_frontend_tokens if cfg.frontend == "vision" else 0)
        specs["labels"] = empty((b, s_lab), torch.int32)
    if cfg.frontend or cfg.enc_dec:
        specs["frontend"] = empty((b, cfg.n_frontend_tokens, cfg.d_model), torch.float32)
    return specs


def fake_mesh(shape: Sequence[int], axes: Sequence[str], device_type: str):
    """A ``DeviceMesh`` of ``shape`` in which this process is rank 0 of a
    fake process group of ``prod(shape)`` ranks (collectives return at
    once and move nothing); an earlier process group is destroyed first."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=math.prod(shape))
    return make_mesh(shape, axes, device_type)


@dataclasses.dataclass
class Lowered:
    """A cell ready to trace: ``fn(*args)`` under ``fake_mode``."""

    fn: Callable
    args: Tuple[Any, ...]
    fake_mode: Any


def lower_cell(cfg: ArchConfig, shape: ShapeSpec, mesh, plan: Dict) -> Lowered:
    """The cell's step as a closure over fake tensors placed on ``mesh``
    (a ``DeviceMesh`` over a fake process group): the train step on a
    state, the prefill, or one decode token against a ``seq_len``-deep
    cache. The reference lowers the same three programs."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    fake_mode = FakeTensorMode(allow_non_fake_inputs=True)
    device = torch.device(mesh.device_type)
    meta_model = Model(cfg, device="meta")  # full width, nothing drawn
    with fake_mode:
        model = meta_model.to_empty(device=device)  # fake storage
        batch = distribute_batch(cfg, input_specs(cfg, shape, device), mesh)
        if shape.kind == "train":
            tcfg = TrainConfig(
                microbatches=plan["microbatches"],
                remat=plan["remat"],
                attn_impl=plan["attn_impl"],
                fsdp=plan["fsdp"],
                opt=AdamWConfig(moment_dtype=plan.get("moments", "float32")),
            )
            state = mesh_state(cfg, tcfg, model, mesh)
            return Lowered(make_train_step(cfg, tcfg, mesh), (state, batch), fake_mode)

        params = distribute_model(model, cfg, mesh, plan["fsdp"])
        dtype = torch_dtype(cfg.dtype)
        impl = plan["attn_impl"]
        if shape.kind == "prefill":
            # vlm: vision embeddings prepend n_frontend_tokens to the sequence
            cache_len = shape.seq_len + (
                cfg.n_frontend_tokens if cfg.frontend == "vision" else 0)

            def prefill(params, batch):
                b = batch["tokens"].shape[0]
                caches = distribute_caches(
                    cfg, init_caches(cfg, b, cache_len, dtype=dtype, device="meta"), mesh, b)
                with torch.no_grad(), replicating(mesh):
                    hidden, caches, _ = forward_hidden(params, cfg, batch, caches=caches,
                                                       impl=impl)
                    return _head(cfg, params, hidden[:, -1:])[:, 0], caches

            return Lowered(prefill, (params, batch), fake_mode)

        b = shape.global_batch
        caches = distribute_caches(
            cfg, init_caches(cfg, b, shape.seq_len, dtype=dtype, include_enc=cfg.enc_dec,
                             device="meta"), mesh, b)
        cache_index = torch.zeros((), dtype=torch.int32, device=device)

        def decode(params, tokens, caches, cache_index):
            step = {"tokens": tokens, "cache_index": cache_index}
            with torch.no_grad(), replicating(mesh):
                logits, caches, _ = forward(params, cfg, step, caches=caches, impl=impl)
            return logits[:, -1], caches

        return Lowered(decode, (params, batch["tokens"], caches, cache_index), fake_mode)


# ---------------------------------------------------------------------------
# Analysis of the traced step
# ---------------------------------------------------------------------------
def analyze(lowered: Lowered) -> Dict:
    """Trace ``lowered`` once and return the record's analysis keys: the
    reference's names for what one chip runs and holds (per-chip FLOPs,
    collective operand bytes by kind, the bytes of its arguments, of what
    it returns and the peak of what it allocates), and the port's own
    ``peak_holders`` (what the peak holds, by the op that made it),
    ``collective_ops`` and ``dot_ops`` (the collectives by operand, the
    products by output)."""
    t0 = time.time()
    args_bytes = argument_bytes(lowered.args)
    totals, _ = analyze_ops(lowered.fn, *lowered.args, fake_mode=lowered.fake_mode)
    return {
        "trace_s": round(time.time() - t0, 2),
        "flops": totals.flops,
        "bytes_accessed": totals.bytes_accessed,
        "memory": {
            "argument_size_in_bytes": args_bytes,
            "output_size_in_bytes": totals.output_bytes,
            "temp_size_in_bytes": totals.peak_bytes,
            "alias_size_in_bytes": totals.alias_bytes,
        },
        "dot_flops_expanded": totals.dot_flops,
        "dot_ops": totals.dot_ops,
        "collectives": totals.per_collective,
        "collective_ops": totals.collective_ops,
        "collective_bytes": totals.collective_bytes,
        "materialized_bytes": totals.materialized_bytes,
        "peak_holders": totals.peak_holders,
    }


# ---------------------------------------------------------------------------
# Command line
# ---------------------------------------------------------------------------
def _cell_mesh(mesh_kind: str, tiny: bool, device_type: str):
    multi = mesh_kind == "multi"
    if tiny:
        shape = (2, 2, 2) if multi else (2, 2)
        axes = ("pod", "data", "model") if multi else ("data", "model")
    else:
        ms = production_shape(multi_pod=multi)
        shape, axes = ms.sizes, ms.axis_names
    return fake_mesh(shape, axes, device_type)


def run_cell(
    arch: str, shape_name: str, mesh_kind: str, outdir: str, tiny: bool = False,
    plan_overrides: Optional[Dict] = None, device_type: str = "cuda",
) -> Dict:
    cfg = get_arch(arch)
    shape = SHAPES[shape_name]
    if tiny:
        cfg = cfg.reduced()
        shape = dataclasses.replace(
            shape, seq_len=min(shape.seq_len, 128), global_batch=min(shape.global_batch, 8)
        )
    mesh = _cell_mesh(mesh_kind, tiny, device_type)
    rec: Dict = {
        "arch": arch,
        "shape": shape_name,
        "mesh": mesh_kind,
        "chips": int(mesh.size()),
        "kind": shape.kind,
        "tiny": tiny,
    }
    ok, reason = applicable(arch, shape_name)
    if not ok:
        rec.update(skipped=True, reason=reason)
        return rec

    rec["params"] = count_params(cfg)
    rec["active_params"] = active_params(cfg)
    plan = plan_cell(cfg, shape, mesh)
    if plan_overrides:
        plan.update(plan_overrides)
    rec["plan"] = plan
    t0 = time.time()
    lowered = lower_cell(cfg, shape, mesh, plan)
    rec["lower_s"] = round(time.time() - t0, 2)
    rec.update(analyze(lowered))
    rec["skipped"] = False
    return rec


def _out_path(outdir, mesh_kind, arch, shape_name):
    d = os.path.join(outdir, mesh_kind)
    os.makedirs(d, exist_ok=True)
    return os.path.join(d, f"{arch}__{shape_name}.json")


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="all", help="arch ids (comma-separated) or 'all'")
    ap.add_argument("--shape", default="all", help="shape ids (comma-separated) or 'all'")
    ap.add_argument("--mesh", default="both", choices=["single", "multi", "both"])
    ap.add_argument("--out", default="build/dryrun")
    ap.add_argument("--tiny", action="store_true", help="reduced configs (CI)")
    ap.add_argument("--force", action="store_true", help="recompute existing")
    ap.add_argument("--fsdp", default=None, choices=[None, "on", "off"])
    ap.add_argument("--microbatches", type=int, default=0)
    ap.add_argument("--remat", default=None)
    ap.add_argument("--moments", default=None, help="optimizer moment dtype")
    ap.add_argument("--jobs", type=int, default=1,
                    help="cells traced at once, each in a child process (default 1: in process)")
    ap.add_argument("--device", default=None,
                    help="device type of the fake tensors and the mesh "
                         "(default: the card; 'cpu' only when asked for)")
    args = ap.parse_args(argv)
    try:
        device = resolve_device(args.device)
    except RuntimeError:
        print("error: no CUDA device is available; pass --device cpu to run on the CPU",
              file=sys.stderr)
        raise SystemExit(2) from None

    from ..configs import _register_all  # noqa: F401

    archs = sorted(ARCHS) if args.arch == "all" else args.arch.split(",")
    shapes = list(SHAPES) if args.shape == "all" else args.shape.split(",")
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    overrides = {}
    if args.fsdp:
        overrides["fsdp"] = args.fsdp == "on"
    if args.microbatches:
        overrides["microbatches"] = args.microbatches
    if args.remat:
        overrides["remat"] = args.remat
    if args.moments:
        overrides["moments"] = args.moments

    cells = []
    for mesh_kind in meshes:
        for arch in archs:
            for shape_name in shapes:
                path = _out_path(args.out, mesh_kind, arch, shape_name)
                if os.path.exists(path) and not args.force:
                    print(f"[cached] {mesh_kind}/{arch}/{shape_name}")
                    continue
                cells.append((arch, shape_name, mesh_kind, path))
    if args.jobs > 1:
        results = _run_children(cells, args)
    else:
        results = (_run_here(cell, args, overrides, device.type) for cell in cells)
    n_ok = n_skip = n_fail = 0
    for status, line in results:
        n_ok += status == "ok"
        n_skip += status == "SKIP"
        n_fail += status == "FAIL"
        print(line, flush=True)
    print(f"done: {n_ok} ok, {n_skip} skipped, {n_fail} failed")
    if n_fail:
        raise SystemExit(1)


def _status(rec: Dict) -> str:
    return "FAIL" if "error" in rec else "SKIP" if rec.get("skipped") else "ok"


def _run_here(cell, args, overrides, device_type) -> Tuple[str, str]:
    """One cell in this process; its record written; (status, line)."""
    arch, shape_name, mesh_kind, path = cell
    t0 = time.time()
    try:
        rec = run_cell(
            arch, shape_name, mesh_kind, args.out, tiny=args.tiny,
            plan_overrides=overrides or None, device_type=device_type,
        )
    except Exception as e:  # noqa: BLE001
        rec = {
            "arch": arch, "shape": shape_name, "mesh": mesh_kind,
            "error": repr(e), "traceback": traceback.format_exc(),
            "skipped": False,
        }
    with open(path, "w") as f:
        json.dump(rec, f, indent=1)
    extra = ""
    if "flops" in rec:
        mem = rec["memory"]
        top = "{}: {}B".format(*rec["peak_holders"][0]) if rec["peak_holders"] else "-"
        coll = "{} x{}: {:.4g}B".format(*rec["collective_ops"][0]) if rec["collective_ops"] \
            else "-"
        extra = (f" flops={rec['flops']:.3e} dot={rec['dot_flops_expanded']:.3e}"
                 f" coll={rec['collective_bytes']:.3e}B"
                 f" arg+temp={mem['argument_size_in_bytes'] + mem['temp_size_in_bytes']:.4g}B"
                 f" peak_top={top} coll_top={coll}")
    status = _status(rec)
    return status, f"[{status}] {mesh_kind}/{arch}/{shape_name} ({time.time() - t0:.0f}s){extra}"


def _run_children(cells, args):
    """Each cell in a child process of its own (the process group is
    process-global), ``args.jobs`` at a time; yields (status, line) as
    the cells finish. A child that dies writes no record: a failure."""
    import subprocess
    from concurrent.futures import ThreadPoolExecutor, as_completed

    passed = ["--out", args.out, "--force"] + (["--tiny"] if args.tiny else [])
    for flag in ("device", "fsdp", "microbatches", "remat", "moments"):
        if getattr(args, flag):
            passed += [f"--{flag}", str(getattr(args, flag))]

    def child(cell):
        arch, shape_name, mesh_kind, path = cell
        t0 = time.time()
        proc = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch, "--shape",
             shape_name, "--mesh", mesh_kind, *passed], capture_output=True, text=True)
        wall = f"child wall {time.time() - t0:.0f}s"
        lines = [x for x in proc.stdout.splitlines() if x.startswith("[")]
        if not os.path.exists(path) or not lines:
            rec = {"arch": arch, "shape": shape_name, "mesh": mesh_kind, "skipped": False,
                   "error": f"child exited {proc.returncode}", "traceback": proc.stderr[-4000:]}
            with open(path, "w") as f:
                json.dump(rec, f, indent=1)
            return "FAIL", f"[FAIL] {mesh_kind}/{arch}/{shape_name} ({wall}, exit {proc.returncode})"
        with open(path) as f:
            return _status(json.load(f)), f"{lines[-1]} ({wall})"

    with ThreadPoolExecutor(args.jobs) as pool:
        for fut in as_completed([pool.submit(child, c) for c in cells]):
            yield fut.result()


if __name__ == "__main__":
    main()
