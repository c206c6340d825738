"""Serving launcher: batched prefill + greedy decode, timed.

    python -m repro_torch.launch.serve --arch llama3-8b               # full width, the card
    python -m repro_torch.launch.serve --arch mixtral-8x22b --reduced --device cpu

The model is drawn from ``--seed`` (a ``torch.Generator`` on the device),
the prompt tokens and the frontend embeddings from ``--seed + 1`` and
``--seed + 2`` (``torch.Generator``s on the CPU, so a prompt is the same
on every device). Prints the device, prefill ms, decode ms per step (the
median of the steps), and tokens/s; runs on the card unless ``--device``
names another device, and without a card exits 2 with one line.
"""

from __future__ import annotations

import argparse
import statistics
import sys
from typing import Dict, List, Optional

import torch

from repro_torch._device import resolve_device
from repro_torch.configs import get_arch
from repro_torch.configs.base import ArchConfig
from repro_torch.models import Model
from repro_torch.models.layers import torch_dtype
from repro_torch.serve import generate_timed


def prompt_batch(cfg: ArchConfig, requests: int, prompt_len: int, seed: int,
                 device: torch.device) -> Dict[str, torch.Tensor]:
    """Seeded prompt tokens (and frontend embeddings, for audio and vision
    models) on ``device``."""
    g = torch.Generator().manual_seed(seed + 1)
    batch = {"tokens": torch.randint(0, cfg.vocab, (requests, prompt_len), generator=g,
                                     dtype=torch.int32).to(device)}
    if cfg.frontend or cfg.enc_dec:
        g = torch.Generator().manual_seed(seed + 2)
        front = torch.randn((requests, cfg.n_frontend_tokens, cfg.d_model), generator=g) * 0.05
        batch["frontend"] = front.to(device=device, dtype=torch_dtype(cfg.dtype))
    return batch


def main(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser(description="batched prefill + greedy decode of one architecture")
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--requests", type=int, default=4, help="batch of prompts")
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen-len", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device to run on (default: the card; 'cpu' only when asked for)")
    args = ap.parse_args(argv)

    try:
        device = resolve_device(args.device)
    except RuntimeError:
        print("error: no CUDA device is available; pass --device cpu to run on the CPU",
              file=sys.stderr)
        raise SystemExit(2) from None
    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    model = Model(cfg, device=device,
                  generator=torch.Generator(device=device).manual_seed(args.seed))
    batch = prompt_batch(cfg, args.requests, args.prompt_len, args.seed, device)
    r = generate_timed(model, cfg, batch, args.gen_len, device=device)
    total = args.requests * args.gen_len
    wall = r["prefill_s"] + sum(r["decode_s"])
    decode_ms = statistics.median(r["decode_s"]) * 1e3 if r["decode_s"] else float("nan")
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    print(f"device {name}; {cfg.name}: {args.requests} x {args.prompt_len} prompt tokens, "
          f"{args.gen_len} generated each")
    print(f"prefill {r['prefill_s'] * 1e3:.3f} ms; decode {decode_ms:.3f} ms/step (median of "
          f"{len(r['decode_s'])}); generated {total} tokens in {wall:.3f} s ({total / wall:.1f} tok/s)")
    print(r["tokens"][:2].cpu().tolist())


if __name__ == "__main__":
    main()
