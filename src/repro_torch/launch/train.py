"""Training launcher: the fault-tolerant Trainer on one device.

    python -m repro_torch.launch.train --arch internlm2-1.8b --batch 8 --microbatches 4 --remat full
    python -m repro_torch.launch.train --arch internlm2-1.8b --reduced --device cpu

The flags are the JAX package's ``launch/train.py``'s, plus ``--device``:
it runs on the card unless ``--device`` names another device, and without
a card it exits 2 with one line. ``--mesh`` accepts only one device
(``1`` or ``1x1``); multi-device meshes come with the multi-device slice.
Prints one line with the device, the median step ms, tokens/s and
``max_memory_allocated``, then the reference's ``finished step=...``
line.
"""

from __future__ import annotations

import argparse
import os
import statistics
import sys
import tempfile
from typing import List, Optional

import torch

from repro_torch._device import resolve_device
from repro_torch.configs import SHAPES, get_arch
from repro_torch.data.pipeline import DataConfig
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.train import TrainConfig, Trainer, TrainerConfig


def parse_mesh(spec: str) -> None:
    """Only a single device: ``1`` or ``1x1`` (any other shape exits 2)."""
    try:
        dims = [int(x) for x in spec.split("x")]
    except ValueError:
        dims = []
    if not dims or any(d != 1 for d in dims) or len(dims) > 3:
        print(f"error: --mesh {spec}: this launcher trains on one device (1 or 1x1); "
              "multi-device meshes are ROADMAP Queue 1 item 3", file=sys.stderr)
        raise SystemExit(2)


def main(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser(description="train one architecture with the fault-tolerant Trainer")
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", default="train_4k", choices=list(SHAPES))
    ap.add_argument("--mesh", default="1x1", help="one device only: 1 or 1x1")
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

    parse_mesh(args.mesh)
    try:
        device = resolve_device(args.device)
    except RuntimeError:
        print("error: no CUDA device is available; pass --device cpu to run on the CPU",
              file=sys.stderr)
        raise SystemExit(2) from None
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
    trainer = Trainer(cfg, shape, device, tcfg, run, DataConfig(seed=args.seed))
    out = trainer.train()
    last = out["metrics"][-1] if out["metrics"] else {}
    tokens = (args.batch or shape.global_batch) * (args.seq or shape.seq_len)
    step_ms = statistics.median(trainer.step_times) * 1e3 if trainer.step_times else float("nan")
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    peak = f"{torch.cuda.max_memory_allocated(device)} B" if device.type == "cuda" \
        else "not measured (cpu)"
    print(f"device {name}; {cfg.name}: {len(trainer.step_times)} steps of {tokens} tokens, "
          f"step {step_ms:.3f} ms (median), {tokens / step_ms * 1e3:.1f} tokens/s, "
          f"max_memory_allocated {peak}")
    print(
        f"finished step={out['step']} failures={out['failures']} "
        f"stragglers={len(out['stragglers'])} "
        f"loss={last.get('lm_loss', float('nan')):.4f}"
    )


if __name__ == "__main__":
    main()
