#!/usr/bin/env python3
"""Check the PyTorch port's multi-device paths on several cards, one rank
per card, against the same work on one card.

    torchrun --standalone --nproc-per-node 4 scripts/torch_mesh_check.py
    torchrun --standalone --nproc-per-node 4 scripts/torch_mesh_check.py --device cpu

Four ranks (NCCL on cards, gloo with ``--device cpu``) run, on ``(data,
model)`` meshes of the job's ranks:

1. ``compressed_psum`` over the world, against the plain int8 sum of the
   ranks' inputs (bit for bit);
2. one train step of reduced InternLM2 (fsdp off; fsdp on with int8
   compression), Mixtral (fsdp on) and Jamba on ``(2, 2)``, against the
   single-device step on rank 0's device: metrics within 1e-5 relative,
   parameters after the step within rtol 2e-4 / atol 2e-5 but for at most
   0.1% of them (a gradient at the f32 noise floor moves AdamW's first
   step by about +-lr); then InternLM2 and Jamba on ``(1, 4)``, whose 2
   reduced kv heads are fewer than the ``model`` ranks (each rank runs
   its own q head against the kv head it reads), held alike;
3. greedy serving of reduced Llama-3-8B and Mixtral on ``(1, 4)`` and
   ``(2, 2)``: tokens equal to the single-device serve's;
4. an elastic restart: a Trainer on ``(2, 2)`` checkpoints at step 3, a
   Trainer on ``(1, 4)`` resumes from it (the restored state equal to the
   checkpoint's leaves bit for bit) and trains to step 5;
5. the GPipe schedule over a ``(4,)`` stage mesh (S = 4, M = 8 and 4,
   stage params as DTensors sharded over ``stage``): the output and the
   gradients of ``sum(out ** 2)`` for ``w``, ``b`` and ``x`` against the
   sequential loop on one device (1e-5);
6. with cards: InternLM2-1.8B at full width in bf16 on ``(2, 2)`` (8 x
   4096 tokens in 4 microbatches, remat full), two steps, their
   ``lm_loss`` and ms per step and the peak memory per card.

Rank 0 prints the cards' names and power limits (``nvidia-smi``), one
line per check and ``mesh check OK`` last; a failed check raises, and the
job exits non-zero.
"""

from __future__ import annotations

import argparse
import datetime
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.configs import SHAPES, get_arch  # noqa: E402
from repro_torch.configs.base import ShapeSpec  # noqa: E402
from repro_torch.data import DataConfig, make_batch  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.models.convert import train_state_leaves  # noqa: E402
from repro_torch.optim import AdamWConfig, compressed_psum  # noqa: E402
from repro_torch.serve import generate_timed  # noqa: E402
from repro_torch.sharding.dtensor import full  # noqa: E402
from repro_torch.train import (  # noqa: E402
    TrainConfig,
    Trainer,
    TrainerConfig,
    init_train_state,
    make_train_step,
)

TINY = ShapeSpec("tiny", 32, 4, "train")


def say(*parts) -> None:
    if dist.get_rank() == 0:
        print(*parts, flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(f"mesh check failed: {what}")


def _leaves(state):
    """The reference's leaves of a train state as full numpy arrays, rows
    of a stacked leaf stacked (a collective for DTensors)."""
    out = []
    for _, ts, stacked in train_state_leaves(state):
        rows = [np.array(full(t).detach().float().cpu().numpy()) for t in ts]
        out.append(np.stack(rows) if stacked else rows[0])
    return out


def check_compressed_psum(device):
    rank, world = dist.get_rank(), dist.get_world_size()
    g = torch.Generator().manual_seed(rank)
    x = (torch.randn(4096, generator=g) * (rank + 1)).to(device)
    got = compressed_psum(x)
    xs = [torch.empty_like(x) for _ in range(world)]
    dist.all_gather(xs, x)
    scale = torch.clamp(max(float(v.abs().max()) for v in xs) * torch.ones((), device=device),
                        min=1e-12) / 127.0
    want = sum(torch.clamp(torch.round(v / scale), -127, 127).to(torch.int8).to(torch.int32)
               for v in xs).to(torch.float32) * scale
    check(torch.equal(got, want), "compressed_psum = the plain int8 sum")
    say(f"compressed_psum over {world} ranks: bit for bit the plain int8 sum")


def check_train(device, shape, runs):
    mesh = make_mesh(shape, ("data", "model"), device.type)
    for arch, fsdp, compress in runs:
        cfg = get_arch(arch).reduced()
        tcfg = TrainConfig(microbatches=2, fsdp=fsdp, compress_grads=compress,
                           opt=AdamWConfig(warmup_steps=2, total_steps=10))
        state = init_train_state(cfg, tcfg, mesh)
        batch = make_batch(cfg, TINY, DataConfig(), 0, mesh=mesh)
        t0 = time.perf_counter()
        state, got = make_train_step(cfg, tcfg, mesh)(state, batch)
        step_s = time.perf_counter() - t0
        got_leaves = _leaves(state)
        if dist.get_rank() == 0:
            single = init_train_state(cfg, tcfg, device)
            b = make_batch(cfg, TINY, DataConfig(), 0, device)
            single, want = make_train_step(cfg, tcfg, device)(single, b)
            m_err = max(abs(float(got[k]) - float(want[k])) / max(abs(float(want[k])), 1e-6)
                        for k in want)
            off = total = 0
            for g_, w_ in zip(got_leaves, _leaves(single)):
                off += int((~np.isclose(g_, w_, rtol=2e-4, atol=2e-5)).sum())
                total += w_.size
            check(m_err <= 1e-5, f"{arch}: metrics max relative err {m_err}")
            check(off <= 1e-3 * total, f"{arch}: {off} of {total} state elements off")
            say(f"train step {arch} on {shape} (fsdp {fsdp}, compression {compress}): "
                f"metrics max relative err {m_err:.3g}; {off} of {total} state elements beyond "
                f"rtol 2e-4 / atol 2e-5; first mesh step {step_s * 1e3:.1f} ms")
        dist.barrier()


def check_serve(device):
    for shape in ((1, 4), (2, 2)):
        mesh = make_mesh(shape, ("data", "model"), device.type)
        for arch in ("llama3-8b", "mixtral-8x22b"):
            cfg = get_arch(arch).reduced()
            g = torch.Generator().manual_seed(1)
            batch = {"tokens": torch.randint(0, cfg.vocab, (2, 12), generator=g,
                                             dtype=torch.int32).to(device)}
            model = Model(cfg, device=device, generator=torch.Generator(device=device).manual_seed(0))
            want = generate_timed(model, cfg, batch, 5, device=device)["tokens"]
            got = generate_timed(model, cfg, batch, 5, mesh=mesh)["tokens"]
            check(torch.equal(got, want), f"{arch} on {shape}: tokens")
            say(f"serve {arch} on {shape}: tokens {got[0].tolist()} = single-device's")


def check_elastic(device, ckpt):
    cfg = get_arch("internlm2-1.8b").reduced()
    tcfg = TrainConfig(opt=AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=20))
    shape = ShapeSpec("tiny", 32, 8, "train")

    def trainer(mesh_shape, steps):
        mesh = make_mesh(mesh_shape, ("data", "model"), device.type)
        return Trainer(cfg, shape, mesh, tcfg, TrainerConfig(steps=steps, ckpt_dir=ckpt,
                                                             ckpt_every=3), DataConfig(seed=7))

    one = trainer((2, 2), 3).train()
    check(one["step"] == 3, "phase 1 reached step 3")
    two = trainer((1, 4), 5)
    restored, start = two._init_or_restore()
    got = _leaves(restored)
    if dist.get_rank() == 0:
        path = Path(ckpt) / "step_00000003"
        n = json.loads((path / "manifest.json").read_text())["n_leaves"]
        disk = [np.load(path / f"leaf_{i:05d}.npy") for i in range(n)]
        check(start == 3 and all(np.array_equal(a.astype(b.dtype), b) for a, b in zip(got, disk)),
              "the (1, 4) restore is the step-3 checkpoint")
    del restored
    out = two.train()
    losses = [m["lm_loss"] for m in out["metrics"]]
    check(out["step"] == 5 and all(np.isfinite(losses)), f"resumed to {out['step']}: {losses}")
    say(f"elastic: (2, 2) to step 3, (1, 4) restored bit for bit and trained to step 5; "
        f"lm_loss {[round(v, 4) for v in losses]}")


def check_pipeline(device):
    from torch.distributed.tensor import Shard, distribute_tensor

    from repro_torch.train.pipeline import pipeline_apply

    s, b, d = 4, 16, 32
    g = torch.Generator().manual_seed(0)
    w = (torch.randn(s, d, d, generator=g) * 0.2).to(device)
    bias = (torch.randn(s, d, generator=g) * 0.1).to(device)
    x = torch.randn(b, d, generator=g).to(device)

    def stage_fn(p, h):
        return torch.tanh(h @ p["w"] + p["b"])

    wl, bl, xl = (t.clone().requires_grad_() for t in (w, bias, x))
    h = xl
    for i in range(s):
        h = stage_fn({"w": wl[i], "b": bl[i]}, h)
    want = [h.detach(), *torch.autograd.grad((h ** 2).sum(), [wl, bl, xl])]
    mesh = make_mesh((s,), ("stage",), device.type)
    for m in (8, 4):
        params = {k: distribute_tensor(v, mesh, [Shard(0)]).requires_grad_()
                  for k, v in (("w", w), ("b", bias))}
        xs = x.clone().requires_grad_()
        out = pipeline_apply(stage_fn, params, xs, mesh, m)
        grads = torch.autograd.grad((out ** 2).sum(), [params["w"], params["b"], xs])
        got = [out.detach(), *(full(t) for t in grads)]
        err = max(float((a - c).abs().max()) for a, c in zip(got, want))
        check(all(torch.allclose(a, c, rtol=1e-5, atol=1e-5) for a, c in zip(got, want)),
              f"pipeline M={m}: output and gradients differ from the sequential loop by {err}")
        say(f"GPipe S={s}, M={m}: output and gradients for w, b, x = the sequential loop's "
            f"(max |err| {err:.3g})")


def check_full_width(device):
    cfg = get_arch("internlm2-1.8b")
    shape = SHAPES["train_4k"]
    mesh = make_mesh((2, 2), ("data", "model"), device.type)
    tcfg = TrainConfig(microbatches=4, remat="full",
                       opt=AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=6))
    torch.cuda.reset_peak_memory_stats()
    state = init_train_state(cfg, tcfg, mesh)
    step_fn = make_train_step(cfg, tcfg, mesh)
    losses, times = [], []
    for step in range(2):
        batch = make_batch(cfg, shape, DataConfig(), step, batch_override=8, mesh=mesh)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step_fn(state, batch)
        losses.append(float(m["lm_loss"]))
        times.append(time.perf_counter() - t0)
    peak = torch.tensor([torch.cuda.max_memory_allocated()], device=device)
    dist.all_reduce(peak, op=dist.ReduceOp.MAX)
    check(all(np.isfinite(losses)), f"full width: losses {losses}")
    say(f"InternLM2-1.8B bf16 full width on (2, 2), 8 x 4096 tokens, M = 4, remat full: "
        f"lm_loss {losses}; step {times[0] * 1e3:.3f} ms (first), {times[1] * 1e3:.3f} ms "
        f"(second); max_memory_allocated {int(peak)} B on the fullest card "
        f"[{torch.cuda.get_device_name(device)}]")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args()
    if args.device == "cuda":
        if not torch.cuda.is_available():
            print("error: no CUDA device is available; pass --device cpu", file=sys.stderr)
            return 2
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
        torch.backends.cuda.matmul.allow_tf32 = False
        device = torch.device("cuda", torch.cuda.current_device())
    else:
        device = torch.device("cpu")
    dist.init_process_group("nccl" if args.device == "cuda" else "gloo",
                            timeout=datetime.timedelta(minutes=10))
    try:
        if dist.get_world_size() != 4:
            raise SystemExit(f"error: run 4 ranks, not {dist.get_world_size()}")
        say(f"{dist.get_world_size()} ranks on {args.device}"
            + (f": {torch.cuda.get_device_name(device)}" if args.device == "cuda" else ""))
        if args.device == "cuda" and dist.get_rank() == 0:
            smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                                  "--format=csv,noheader"], capture_output=True, text=True,
                                 check=True).stdout.strip().splitlines()
            say("nvidia-smi: " + "; ".join(smi))
        check_compressed_psum(device)
        check_train(device, (2, 2), [("internlm2-1.8b", False, False),
                                     ("internlm2-1.8b", True, True),
                                     ("mixtral-8x22b", True, False),
                                     ("jamba-v0.1-52b", False, False)])
        check_train(device, (1, 4), [("internlm2-1.8b", False, False),
                                     ("jamba-v0.1-52b", False, False)])
        check_serve(device)
        ckpt = tempfile.mkdtemp(prefix="mesh_check_") if dist.get_rank() == 0 else None
        holder = [ckpt]
        dist.broadcast_object_list(holder)
        check_elastic(device, holder[0])
        check_pipeline(device)
        if args.device == "cuda":
            check_full_width(device)
        say("mesh check OK")
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
