"""Training launcher: the fault-tolerant Trainer on one device or on a
``DeviceMesh``.

    python -m repro_torch.launch.train --arch internlm2-1.8b --batch 8 --microbatches 4 --remat full
    python -m repro_torch.launch.train --arch internlm2-1.8b --reduced --device cpu
    torchrun --nproc-per-node 4 -m repro_torch.launch.train --arch internlm2-1.8b \
        --reduced --mesh 2x2 --device cpu
    torchrun --nproc-per-node 1 -m repro_torch.launch.train --arch internlm2-1.8b --mesh 1x1

The flags are the JAX package's ``launch/train.py``'s, plus ``--device``:
it runs on the card unless ``--device`` names another device, and without
a card it exits 2 with one line. ``--mesh`` is ``A``, ``AxB`` or
``AxBxC`` over the reference's axis names (``model``; ``data, model``;
``pod, data, model``). Under ``torchrun`` the mesh spans the job's ranks
(one process per device: NCCL on cards, gloo for ``--device cpu``), and a
mesh of another size than ``WORLD_SIZE`` exits 2 with one line; without
``torchrun`` only ``1``/``1x1`` runs, on one device, and a larger mesh
exits 2. Rank 0 prints one line with the device, the mesh, the median
step ms, tokens/s and ``max_memory_allocated``, then the reference's
``finished step=...`` line.
"""

from __future__ import annotations

import argparse
import math
import os
import statistics
import sys
import tempfile
from typing import List, Optional, Tuple

import torch

from repro_torch._device import resolve_device
from repro_torch.configs import SHAPES, get_arch
from repro_torch.data.pipeline import DataConfig
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.sharding.dtensor import is_mesh, mesh_device
from repro_torch.train import TrainConfig, Trainer, TrainerConfig


_AXES = {1: ("model",), 2: ("data", "model"), 3: ("pod", "data", "model")}


def _die(message: str) -> "SystemExit":
    print(f"error: {message}", file=sys.stderr)
    return SystemExit(2)


def parse_mesh(spec: str) -> Tuple[Tuple[int, ...], Tuple[str, ...]]:
    """``A``, ``AxB`` or ``AxBxC`` -> (shape, the reference's axis names);
    anything else exits 2."""
    try:
        dims = tuple(int(x) for x in spec.split("x"))
    except ValueError:
        dims = ()
    if not dims or len(dims) > 3 or any(d < 1 for d in dims):
        raise _die(f"--mesh {spec}: want A, AxB or AxBxC")
    return dims, _AXES[len(dims)]


def _mesh_or_device(args):
    """The Trainer's third argument: a ``DeviceMesh`` over the torchrun
    job's ranks, or (no torchrun, a one-device mesh) the device."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_mesh

    dims, axes = parse_mesh(args.mesh)
    need = math.prod(dims)
    world = int(os.environ.get("WORLD_SIZE", "0"))
    try:
        device = resolve_device(args.device)
    except RuntimeError:
        raise _die("no CUDA device is available; pass --device cpu to run on the CPU") from None
    if not world:
        if need != 1:
            raise _die(f"--mesh {args.mesh} needs {need} ranks: run under "
                       f"torchrun --nproc-per-node {need}")
        return device
    if need != world:
        raise _die(f"--mesh {args.mesh} needs {need} ranks, WORLD_SIZE is {world}")
    if device.type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
    dist.init_process_group("nccl" if device.type == "cuda" else "gloo")
    return make_mesh(dims, axes, device_type=device.type)


def main(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser(description="train one architecture with the fault-tolerant Trainer")
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", default="train_4k", choices=list(SHAPES))
    ap.add_argument("--mesh", default="1x1",
                    help="A, AxB or AxBxC (model; data x model; pod x data x model); "
                         "more than one device runs under torchrun")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=0, help="override global batch")
    ap.add_argument("--seq", type=int, default=0, help="override seq len")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--remat", default="none")
    ap.add_argument("--fsdp", action="store_true")
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(), "repro_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device to run on (default: the card; 'cpu' only when asked for)")
    args = ap.parse_args(argv)

    where = _mesh_or_device(args)
    mesh = where if is_mesh(where) else None
    device = mesh_device(mesh) if mesh is not None else where
    try:
        _train(args, where, device, mesh)
    finally:
        if mesh is not None:
            import torch.distributed as dist

            dist.destroy_process_group()


def _train(args, where, device, mesh) -> None:
    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    shape = SHAPES[args.shape]
    tcfg = TrainConfig(
        microbatches=args.microbatches,
        remat=args.remat,
        fsdp=args.fsdp,
        compress_grads=args.compress_grads,
        opt=AdamWConfig(lr=args.lr, warmup_steps=max(2, args.steps // 20),
                        total_steps=args.steps),
    )
    run = TrainerConfig(
        steps=args.steps, ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
        batch_override=args.batch or None, seq_override=args.seq or None,
    )
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    trainer = Trainer(cfg, shape, where, tcfg, run, DataConfig(seed=args.seed))
    out = trainer.train()
    if mesh is not None and mesh.get_rank() != 0:
        return
    last = out["metrics"][-1] if out["metrics"] else {}
    tokens = (args.batch or shape.global_batch) * (args.seq or shape.seq_len)
    step_ms = statistics.median(trainer.step_times) * 1e3 if trainer.step_times else float("nan")
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    peak = f"{torch.cuda.max_memory_allocated(device)} B" if device.type == "cuda" \
        else "not measured (cpu)"
    on = f"mesh {args.mesh} ({mesh.size()} ranks); " if mesh is not None else ""
    print(f"device {name}; {on}{cfg.name}: {len(trainer.step_times)} steps of {tokens} tokens, "
          f"step {step_ms:.3f} ms (median), {tokens / step_ms * 1e3:.1f} tokens/s, "
          f"max_memory_allocated {peak}")
    print(
        f"finished step={out['step']} failures={out['failures']} "
        f"stragglers={len(out['stragglers'])} "
        f"loss={last.get('lm_loss', float('nan')):.4f}"
    )


if __name__ == "__main__":
    main()
