#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path once on an NVIDIA GPU.

    python3 chip_smoke.py        # from the root of a checkout; needs one card

The main path is the paper's loop, at its full width: the eq.-18 sweep over
all 5,121 hardware points x 96 cells on the card, the codesign best point,
the stencils run at the codesigned tiles by the hand-written kernels, the
measurement grid timed on the card, the machine parameters refitted, and
the sweep again on the calibrated machine. Phases:

0. device facts (exits non-zero without a card);
1. build the stencil kernels from ``src/repro_torch/kernels/csrc`` with nvcc
   (the attention library is built apart, at its first use in phase 6);
2. every kernel x stencil against its plain torch version on the card
   (f32 and bf16, ragged shapes, several tiles and bands, 8192^2 and 256^3,
   and the K1/K2 edge cases of ``EDGE_CASES``, also from an input off the
   16-byte grid);
3. analytic codesign at full width, checked tie-aware against the float64
   numpy oracle;
4. the codesigned tiles run through K1 (2-D) and the one-step kernels
   K3/K4 at their planned band, each checked against plain;
5. measure -> refit -> calibrated codesign;
6. kernel times (CUDA events) beside their bound, plain and library times;
   K1/K2 at every tile of the measurement grid and K1 at the 2-D jacobi
   optimum, each with its bound share, shared memory and blocks per SM;
   then the fused attention (``kernels/attention.py``): its library's
   compile seconds, and its forward and backward at one microbatch of the
   benchmark's training cell (``ATTN_SHAPE``) beside their bound (the
   causal pairs' useful products at 989 TFLOP/s), the plain core
   (``_sdpa``) and ``F.scaled_dot_product_attention`` as the library
   yardstick (here only: the port never calls it);
7. the served path, in a temporary artifact store: ``repro_torch.measure
   .cli`` ``run --full`` (K1/K2 on the card), ``fit``, ``build --engine
   torch`` at full width; the calibrated sweep served by
   ``server_from_artifact`` to 64 seeded mixes from threads (microbatched)
   and one at a time; a ``CodesignServer`` at the stock GTX-980 spec whose
   miss path sweeps on the card, and a second server over the same store
   that answers warm with phase 3's best point;
8. the fleet gateway over HTTP, driven through ``python -m
   repro_torch.service.cli`` child processes: ``build --engine torch`` for
   gtx980 and titanx at full width (sweeps on the card), ``portfolio --k 2
   --budget 900 --objective throughput`` over each (its default engine
   scores on the card) held against the numpy oracle on the stored
   matrix, then ``serve --port 0``: 64 seeded mixes over ``/v1/query`` one
   at a time and from 64 threads, one ``/v1/query_many`` of 64 and
   ``/v1/route`` for every cell group, each byte-identical to the
   in-process servers (batched answers but for their ``batch_size``);
   metrics, SLO and health scrapes; ``unknown_artifact`` and
   ``bad_request``; a second child with ``--rate-limit 1`` (429 +
   ``Retry-After``) and a third with ``REPRO_FAULTS`` arming one
   portfolio member (degraded routing, then recovery). It launches no
   stencil kernel, by construction: the sweeps and the portfolio scoring
   are torch ops that call no kernel wrapper;
9. LM-workload codesign (model predictions for the modelled fleet of
   ``repro_torch.core.lmtime.HW``): ``lm_codesign(engine="torch")`` over
   the default question (Llama-3-8B + Mixtral-8x22B, 7 cells, 512 chips)
   in float64 on the card, held to the numpy oracle (times within 1e-12
   relative, another plan only on a tie); the docs' question (Llama-3-8B
   decode at batch 64 under 64 chips) through an ``LMServer`` whose miss
   path sweeps on the card, answering ``pod=1 data=4 model=16`` as its
   ``best_index`` (``pod=2 data=2 model=16`` ties with it); ``build
   --workload lm --engine torch`` and ``portfolio --k 2 --budget 512
   --objective throughput`` as children, held against the in-process sweep
   and the numpy portfolio oracle; a ``serve`` child answering LM queries
   routed by ``{"workload": "lm"}``, a stencil query and ``/v1/route``
   beside them, byte-identically to the in-process servers; Llama-3-8B's
   whole parameter tree drawn on the card in bf16 from a seeded
   ``torch.Generator`` (its bytes = 2 x ``count_params``). No kernel lies
   on this path; the counters are read around it all the same;
10. the LM forward passes and serve steps (``repro_torch.serve``
   ``make_prefill``/``make_decode_step``/``greedy`` through
   ``generate_timed``, the loop that ``generate`` returns the tokens of):
   reduced llama3-8b, mixtral-8x22b (capacity factor 64), mamba2-780m,
   deepseek-v3-671b (MLA), whisper-medium and qwen2-vl-2b, each from one
   seeded tree on the card and on the CPU in f32 (no TF32), with identical
   tokens and the prefill logits and final caches within 1e-4; ``forward``
   with ``impl="chunked"`` against ``"plain"`` at S = 2100; then
   Llama-3-8B at full width on phase 9's bf16 tree (the same seed): (a) 4
   x 512-token prompts + 32 greedy decode steps, (b) 1 x 8192 tokens (at
   ``CHUNKED_THRESHOLD``; the fused core takes it, as it takes (a)'s
   prefill) + 4 steps, each run twice (cold, warm), the
   prefill logits and decode steps 1 and last held against a cacheless
   ``forward`` within ``LOGIT_RTOL`` of the logits' scale, the greedy-token
   agreement reported; prefill ms, decode ms per step, tokens/s and
   ``max_memory_allocated`` beside their bounds (``_serve_bounds``); (b)'s
   prompt through ``forward`` with ``impl="chunked"`` (the chunked core in
   bf16 at full width) held against the fused core's within
   ``LOGIT_RTOL``; and
   ``python -m repro_torch.launch.serve --arch llama3-8b`` as a child at
   case (a)'s shape. No stencil kernel lies on this path; the bf16
   prefills run the fused attention;
11. training (``repro_torch.train``, ``optim``, ``data``, ``checkpoint``):
   (a) one train step (remat ``"dots"``, two microbatches; int8 gradient
   compression for ``TRAIN_COMPRESS_ARCH``) on the six reduced archs of
   phase 10, from one seeded state on the CPU and on the card, f32
   without TF32: metrics within 1e-5 relative, gradients (``m`` after the
   first step) within 1e-4 of each leaf's largest entry (one int8 bin
   where compression met a tie); (b) InternLM2-1.8B at full width in bf16
   through ``Trainer``: train_4k's 4,096 tokens per sequence, 8 sequences
   per step in 4 microbatches, ``remat="full"``, AdamW with f32 moments,
   6 steps, an async checkpoint every 3 (``keep=1``, in a temporary
   directory under ``build/`` that must hold two), a fault injected at
   step 4, so the run restores the step-3 checkpoint into its own tensors
   and replays step 3, whose ``lm_loss`` must equal the first pass's (or,
   if the bits differ, lie within 1e-3 relative, with the first
   nondeterministic operation printed); the first ``lm_loss`` within 0.5
   of ln(92,544) and the last below it; step ms, tokens/s, peak memory and
   checkpoint seconds beside their bounds (``_train_bound``), and a
   ``torch.profiler`` count of one step's device operations and busy
   share; (c) ``python -m repro_torch.launch.train --arch internlm2-1.8b
   --reduced --steps 20`` as a child (train_4k's sequence, the batch cut
   to 8, remat full). No stencil kernel lies on this path; (b)'s forward,
   recompute and backward run the fused attention;
12. multi-device (one card, so one rank): (a) the sharded sweep at full
   width, ``sweep_cells_sharded`` with ``devices=1`` and with
   ``devices=["cuda:0"] * 4`` (four shards on the one card) over every
   stencil group, then ``codesign(engine="sharded", devices=1)``, each bit
   for bit phase 3's matrix with its best point; (b) one NCCL rank in
   process (``tcp://localhost`` on a free port) and a 1 x 1
   ``DeviceMesh("cuda", ("data", "model"))``: ``compressed_psum`` equal to
   quantize -> dequantize, and one train step of each of phase 11 (a)'s
   six reduced archs on the mesh against the single-device card step (f32,
   no TF32: metrics and every state leaf within 1e-6); (c) InternLM2-1.8B
   at full width on that mesh from phase 11's seeded state (bf16, 8 x
   4096 tokens, M = 4, remat full; the fused attention runs on each rank's
   tensors, as in phase 11), 2 steps whose ``lm_loss`` must equal
   phase 11's first two (the largest difference printed), ms per step
   beside phase 11's and its bound, peak memory; (d) Llama-3-8B served on
   the mesh at phase 10 (a)'s shape, its tokens equal to phase 10's and
   decode ms per step beside phase 10's; (e) the sharded code paths on the
   one rank: the partition rules place every tensor with ``Shard`` kept on
   the size-1 axes (``to_placements`` patched here, and only here), so the
   DTensor rules, ``local_map`` wraps, vocab-parallel lookup and loss and
   redistributions a wider mesh runs all run; one fsdp train step of each
   of the six reduced archs against the single-device card step (metrics
   within 1e-5 relative, the state within rtol 2e-4 / atol 2e-5 but for
   at most 0.1% of its elements, each within a first step's AdamW move of
   2 lr), and Llama-3-8B, Mixtral, Whisper and Qwen2-VL (reduced) served
   against the single-device serve (tokens identical, logits within 1e-4),
   the position ids of every stack call in those steps and serves placed
   as the tokens' rows (``Shard(0)`` over data, replicated over model,
   never a plain tensor); then, with
   every spec chosen as if the axes were 4 wide (``mesh_sizes`` patched
   here, and only here), a GQA arch whose 2 kv heads do not divide that:
   InternLM2's fsdp step and Llama-3-8B served, its caches' head dims
   sharded over ``model`` (the decode's scores summed over it), each held
   alike; and the attention core's split over ``model`` alone
   (``_attend`` on placed q, k, v: q by heads with k, v whole, whose
   gradients are partial sums, and k, v by head dims) against the plain
   core, output and gradients within 1e-6. The process group is destroyed
   at the end of the phase. No kernel lies on this path either;
13. the launch analysis (predictions of a model of the card, not
   measurements): (a) ``python -m repro_torch.launch.dryrun`` children at
   full width as rank 0 of a fake 256-rank process group on fake
   ``cuda`` tensors (``DRYRUN_CELLS``: InternLM2-1.8B's train step,
   Mamba2's 500k decode, Llama-3-8B's 500k cell, which must skip as
   quadratic), each record free of errors and, where it ran, its argument
   + temp bytes under the card's 80 GB, InternLM2's per-chip dot FLOPs
   printed beside 6ND x 4/3 / 256 and at most 9e13 (each model rank
   computes its share of the attention heads), then ``python -m
   repro_torch.launch.roofline`` over the records; (b) ``lower_cell`` /
   ``analyze`` in a child on a 1-rank fake mesh at phase 11 (b)'s train
   shape and phase 10 (a)'s decode shape, each count printed against the
   card's measurement with its ratio: the dot FLOPs against
   ``_train_bound``'s operations, the train state's argument bytes
   against phase 11's resident bytes (equal to the byte, checked), the
   traced peak against phase 11's ``max_memory_allocated``, the roofline
   bound against phase 11's median step, and the decode roofline bound
   against ``_serve_bounds`` and phase 10 (a)'s decode ms. No kernel lies
   on this path either.

The launch counters are set to 0 just before phase 3 and read just after
phase 5, and again just before and after phase 7: every stencil kernel
must have been launched on the main path, and K1/K2 on the served path;
they are set to 0 before phase 9 and the stencil counters must read 0
after it, and again around phases 10, 11, 12 and 13; the fused attention
must run on the paths of phases 10 (its forward), 11 and 12, and its rows
count their launches there. A failed check raises; nothing is caught. The
last three lines are a JSON object of per-kernel numbers (launches: the
main path plus the served path for the stencil kernels, the LM paths of
phases 10-12 for the attention), the card's name and power limit as
``nvidia-smi`` gives them, and the device record.
"""

from __future__ import annotations

import json
import math
import shutil
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

#: H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s, f32 FLOP/s outside the
#: tensor cores, dense bf16 FLOP/s on the tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12

#: phase 10's card-against-CPU parity archs (reduced, f32)
PARITY_ARCHS = ("llama3-8b", "mixtral-8x22b", "mamba2-780m", "deepseek-v3-671b",
                "whisper-medium", "qwen2-vl-2b")
#: full-width Llama-3-8B cases of phase 10: (label, batch, prompt, generated
#: tokens = 1 from the prefill + the decode steps)
SERVE_CASES = (("a", 4, 512, 33), ("b", 1, 8192, 5))
#: phase 11 (b): InternLM2-1.8B trained at full width on train_4k's
#: sequence, the global batch cut from 256 to 8 sequences in 4 microbatches
#: of 2; checkpoints every 3 steps, a fault at step 4 (replays step 3)
TRAIN_ARCH, TRAIN_BATCH, TRAIN_MICRO, TRAIN_LR = "internlm2-1.8b", 8, 4, 1e-3
TRAIN_STEPS, TRAIN_CKPT_EVERY, TRAIN_FAULT_AT = 6, 3, 4
#: phase 11 (a): the parity arch that also runs int8 gradient compression
TRAIN_COMPRESS_ARCH = "llama3-8b"
#: phase 6's attention shape: one microbatch of the benchmark's training
#: cell (InternLM2-1.8B): batch, sequence, query heads, kv heads, head width
ATTN_SHAPE = (2, 4096, 16, 8, 128)
#: bf16 logits of the serve steps against a cacheless forward: max |diff|
#: within this fraction of the largest |logit|. bf16 keeps 8 significant
#: bits (a step of 2^-8 = 0.4% of a value); the two paths differ only in
#: the shapes of their products, whose rounding differs per layer over 32
#: layers, so differences of a few steps are expected, and a fault (a wrong
#: slot, position or mask) moves logits by their whole scale
LOGIT_RTOL = 0.05

NAMES_2D = ("jacobi2d", "heat2d", "laplacian2d", "gradient2d")
NAMES_3D = ("heat3d", "laplacian3d")

#: (stencil, shape, steps, tiles, dtype) edge cases of K1/K2: t_s1 = 1
#: strips and t_s1 >= s1, last passes shorter than t_t, windows clipped at
#: both ends of an axis, 1024 threads for windows wider than 1024, widths
#: that are not multiples of 4 (unaligned row heads and tails), bf16 in 3-D
EDGE_CASES = (
    ("jacobi2d", (45, 131), 5, {"t_s1": 1, "t_s2": 32, "t_t": 2}, "f32"),
    ("heat2d", (37, 53), 7, {"t_s1": 64, "t_s2": 64, "t_t": 3}, "f32"),
    ("gradient2d", (40, 2100), 3, {"t_s1": 4, "t_s2": 1024, "t_t": 2}, "f32"),
    ("laplacian2d", (33, 1030), 4, {"t_s1": 8, "t_s2": 1024, "t_t": 3}, "f32"),
    ("heat2d", (29, 1027), 3, {"t_s1": 16, "t_s2": 1024, "t_t": 2}, "bf16"),
    ("heat3d", (9, 21, 23), 5, {"t_s1": 1, "t_s2": 32, "t_t": 2, "t_s3": 4}, "f32"),
    ("laplacian3d", (11, 13, 17), 5, {"t_s1": 16, "t_s2": 32, "t_t": 3, "t_s3": 32}, "f32"),
    ("heat3d", (20, 70, 37), 6, {"t_s1": 8, "t_s2": 64, "t_t": 4, "t_s3": 8}, "f32"),
    ("heat3d", (6, 1030, 7), 2, {"t_s1": 2, "t_s2": 1024, "t_t": 2, "t_s3": 2}, "f32"),
    ("laplacian3d", (17, 9, 33), 3, {"t_s1": 4, "t_s2": 32, "t_t": 2, "t_s3": 8}, "bf16"),
    ("heat3d", (12, 40, 30), 5, {"t_s1": 3, "t_s2": 16, "t_t": 3, "t_s3": 5}, "bf16"),
)


def say(*parts) -> None:
    print(*parts, flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(f"chip_smoke check failed: {what}")


def _assert_close(got, want, rtol, atol, what):
    import torch

    err = float((got.float() - want.float()).abs().max()) if got.numel() else 0.0
    check(bool(torch.isfinite(want.float()).all()), f"{what}: plain result not finite")
    ok = bool(torch.allclose(got.float(), want.float(), rtol=rtol, atol=atol))
    check(ok, f"{what}: max |err| {err} beyond rtol {rtol} atol {atol}")
    return err


def _event_ms(fn, iters=20, warmup=3):
    """Mean milliseconds of ``fn`` over ``iters`` back-to-back calls,
    between CUDA events, after ``warmup`` calls."""
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def phase0_device():
    import torch

    say("== phase 0: device")
    name = torch.cuda.get_device_name(0)
    props = torch.cuda.get_device_properties(0)
    say(f"device: {name}; count {torch.cuda.device_count()}; torch {torch.__version__}; "
        f"torch.version.cuda {torch.version.cuda}; python {sys.version.split()[0]}")
    say(f"SMs {props.multi_processor_count}; memory {props.total_memory / 2**30:.1f} GiB; "
        f"shared memory per block (opt-in) "
        f"{getattr(props, 'shared_memory_per_block_optin', 'n/a')} B")
    from repro_torch.kernels import _build

    nvcc = _build.find_nvcc()
    ver = subprocess.run([nvcc, "--version"], capture_output=True, text=True, check=True)
    say(f"nvcc: {nvcc}: {ver.stdout.strip().splitlines()[-1]}")
    smi = shutil.which("nvidia-smi")
    check(smi is not None, "nvidia-smi on PATH")
    out = subprocess.run(
        [smi, "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    say(f"nvidia-smi: {out}")
    return name, out


def phase1_build():
    from repro_torch.kernels import _build

    say("== phase 1: build")
    t0 = time.perf_counter()
    report = _build.build()
    say(f"build: {time.perf_counter() - t0:.2f} s (sources built in parallel)")
    for stem, info in report.items():
        say(f"  {stem}: {info['seconds']:.2f} s -> {info['path']}")
        for line in info["log"].splitlines():
            if any(k in line for k in ("Compiling entry", "registers", "spill", "error")):
                say("    " + line.strip())


def phase2_compare(errs):
    """Every kernel x stencil vs its plain version on the card."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.kernels import tiled_stencils as ts
    from repro_torch.kernels.stencil_common import step_plain

    say("== phase 2: kernels vs plain versions on the card")
    gen = torch.Generator(device="cuda").manual_seed(0)

    def rand(shape, dtype=torch.float32):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    def tol(dtype):
        return (2e-2, 2e-2) if dtype == torch.bfloat16 else (1e-5, 1e-5)

    # K3/K4: one step, f32 and bf16, ragged and realistic shapes, bands
    for name, mod in ops.KERNELS.items():
        kernel = f"step{mod.DIMS}d"
        shapes = [(33, 257), (5, 7), (8192, 8192)] if mod.DIMS == 2 else [(17, 9, 33), (256, 256, 256)]
        for shape in shapes:
            for dtype in (torch.float32, torch.bfloat16):
                x = rand(shape, dtype)
                want = step_plain(x, mod.update, mod.HALO)
                for br in (None, 1, 3, 64):
                    got = ops.stencil_step(name, x, block_rows=br)
                    torch.cuda.synchronize()
                    e = _assert_close(got, want, *tol(dtype), f"{kernel} {name} {shape} {dtype} br={br}")
                    errs[kernel] = max(errs[kernel], e)
                say(f"  {kernel} {name:12s} {str(shape):16s} {str(dtype):15s} ok (max |err| {e:.3g})")
        # multi-step run through time_loop
        x = rand((24, 40) if mod.DIMS == 2 else (10, 12, 14))
        want = x
        for _ in range(8):
            want = step_plain(want, mod.update, mod.HALO)
        got = ops.stencil_run(name, x, steps=8)
        torch.cuda.synchronize()
        scale = max(1.0, float(want.abs().max()))
        errs[kernel] = max(errs[kernel], _assert_close(got, want, 1e-4, 1e-4 * scale, f"{kernel} {name} 8 steps"))

    # K1/K2: tile grids, ragged shapes, bf16 on heat, realistic shapes
    grid_2d = [{"t_s1": 1, "t_s2": 32, "t_t": 2}, {"t_s1": 4, "t_s2": 32, "t_t": 4},
               {"t_s1": 16, "t_s2": 128, "t_t": 8}, {"t_s1": 64, "t_s2": 1024, "t_t": 2}]
    grid_3d = [{"t_s1": 1, "t_s2": 32, "t_t": 2, "t_s3": 1}, {"t_s1": 4, "t_s2": 32, "t_t": 2, "t_s3": 2},
               {"t_s1": 8, "t_s2": 64, "t_t": 4, "t_s3": 8}]

    def compare_tiled(name, x, steps, tiles, dtype_tol=None):
        kernel = f"tiled{ops.KERNELS[name].DIMS}d"
        got = ts.run_tiled(name, x, steps=steps, tiles=tiles)
        want = ts.run_tiled_plain(name, x, steps, ts.normalize_tiles(tiles))
        torch.cuda.synchronize()
        if dtype_tol is None:
            scale = max(1.0, float(want.abs().max()))
            rtol, atol = 1e-4, 1e-4 * scale
        else:
            rtol, atol = dtype_tol
        e = _assert_close(got, want, rtol, atol, f"{kernel} {name} {tuple(x.shape)} {tiles}")
        errs[kernel] = max(errs[kernel], e)
        return e

    for name in NAMES_2D:
        for shape in ((37, 53), (33, 257)):
            x = rand(shape)
            for tiles in grid_2d:
                compare_tiled(name, x, 5, tiles)
        e = compare_tiled(name, rand((8192, 8192)), 4, {"t_s1": 16, "t_s2": 64, "t_t": 2})
        say(f"  tiled2d {name:12s} tile grid + 8192^2 ok (max |err| {e:.3g})")
    for name in NAMES_3D:
        for shape in ((11, 13, 17), (17, 9, 33)):
            x = rand(shape)
            for tiles in grid_3d:
                compare_tiled(name, x, 4, tiles)
        e = compare_tiled(name, rand((256, 256, 256)), 4, {"t_s1": 8, "t_s2": 32, "t_t": 2, "t_s3": 8})
        say(f"  tiled3d {name:12s} tile grid + 256^3 ok (max |err| {e:.3g})")
    for name, shape in (("heat2d", (24, 40)), ("heat3d", (10, 12, 14))):
        compare_tiled(name, rand(shape, torch.bfloat16), 3, {"t_s1": 8, "t_s2": 32, "t_t": 2}, (2e-2, 2e-2))
        say(f"  tiled {name} bf16 ok")
    for name, shape, steps, tiles, dt in EDGE_CASES:
        dtype = torch.bfloat16 if dt == "bf16" else torch.float32
        x = rand(shape, dtype)
        e = compare_tiled(name, x, steps, tiles, tol(dtype) if dt == "bf16" else None)
        # the same values from an address off the 16-byte grid: x starts 1
        # element past an allocation's start
        off = torch.empty(x.numel() + 1, device="cuda", dtype=dtype)[1:].view(shape)
        off.copy_(x)
        e_off = compare_tiled(name, off, steps, tiles, tol(dtype) if dt == "bf16" else None)
        say(f"  edge {name:12s} {str(shape):15s} {steps} steps {dt} tiles {tiles}: ok "
            f"(max |err| {e:.3g}; off the 16-byte grid {e_off:.3g})")
    # a tile that cannot fit raises before launch
    from repro_torch.kernels import _build

    before = dict(_build.LAUNCHES)
    try:
        ts.run_tiled("heat3d", rand((64, 128, 128)), 16, {"t_s1": 8, "t_s2": 64, "t_t": 16, "t_s3": 2})
    except ValueError as exc:
        say(f"  oversized window refused before launch: {exc}")
    else:
        check(False, "an oversized window was launched")
    check(_build.LAUNCHES == before, "no launch for a refused window")


def _tie_check(st, gpu, size, lattice, hw, t_np, i_np, t_got, i_got, rtol=1e-5):
    """Feasibility equal, optima within rtol, differing argmins are ties in
    the float64 oracle model."""
    import numpy as np

    from repro_torch.core.timemodel import stencil_time

    check(np.array_equal(i_np < 0, i_got < 0), f"{st.name}: feasibility sets differ")
    feas = i_np >= 0
    check(bool(np.allclose(t_got[feas], t_np[feas], rtol=rtol)), f"{st.name}: optima differ")
    g = lattice.grid()
    diff = np.nonzero(feas & (i_np != i_got))[0]
    for h in diff:
        j = i_got[h]
        t_alt = float(stencil_time(
            st, gpu, size, hw.n_sm[h], hw.n_v[h], hw.m_sm[h],
            g["t_s1"][j], g["t_s2"][j], g["t_t"][j], g["k"][j], g["t_s3"][j],
        ))
        check(abs(t_alt - t_np[h]) <= rtol * abs(t_np[h]), f"{st.name} hw {h}: not a tie")
    return int(feas.sum()), len(diff)


def phase3_codesign():
    import numpy as np
    import torch

    from repro_torch.core.area import GTX980
    from repro_torch.core.codesign import codesign, enumerate_hw_space, evaluate_fixed_hw
    from repro_torch.core.solver import solve_cell
    from repro_torch.core.timemodel import MAXWELL_GPU
    from repro_torch.core.workload import paper_workload

    say("== phase 3: analytic codesign at full width on the card")
    wl = paper_workload()
    hw = enumerate_hw_space()
    check(len(hw) == 5121 and len(wl.cells) == 96, "full width: 5,121 points x 96 cells")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = codesign(wl, hw=hw, engine="torch")
    sweep_s = time.perf_counter() - t0
    say(f"sweep: {len(hw)} hardware points x {len(wl.cells)} cells on the card in {sweep_s:.3f} s "
        f"(first call, torch engine, chunk = 2048 // 16 sizes)")
    checked = set()
    for ci, cell in enumerate(wl.cells):
        # the first and the last size of every stencil
        key = cell.stencil.name
        last = ci + 1 == len(wl.cells) or wl.cells[ci + 1].stencil.name != key
        if key in checked and not last:
            continue
        checked.add(key)
        t_np, i_np = solve_cell(cell.stencil, MAXWELL_GPU, cell.size, hw.n_sm, hw.n_v, hw.m_sm,
                                res.lattices[ci])
        n_feas, n_ties = _tie_check(cell.stencil, MAXWELL_GPU, cell.size, res.lattices[ci], hw, t_np,
                                    i_np, res.cell_time[ci], res.cell_tile_idx[ci])
        say(f"  oracle check {key:12s} size ({cell.size.s1}, {cell.size.t}): "
            f"{n_feas} feasible points agree, {n_ties} argmin ties")
    i, g = res.best()
    p = hw.point(i)
    _, g_stock = evaluate_fixed_hw(wl, GTX980)
    say(f"best design (model prediction in the GTX-980 frame): n_sm={p.n_sm} n_v={p.n_v} "
        f"m_sm={p.m_sm} kB, area {hw.area[i]:.1f} mm^2, {g:.1f} GFLOP/s predicted; "
        f"stock GTX-980 {g_stock:.1f} GFLOP/s predicted; gain {g / g_stock:.3f}x")
    check(np.isfinite(g) and g > g_stock, "codesigned design beats the stock point in the model")
    return res, sweep_s


def phase4_codesigned_tiles():
    """The stock-point optimum tiles through K1; the one-step kernels at
    their planned band (analytic tiles -> kernel, as the e2e example)."""
    import numpy as np
    import torch

    from repro_torch.core.solver import LATTICE_2D, LATTICE_3D, decode_index, solve_cell
    from repro_torch.core.timemodel import MAXWELL_GPU, STENCILS, ProblemSize
    from repro_torch.kernels import ops
    from repro_torch.kernels import tiled_stencils as ts
    from repro_torch.kernels.stencil_common import step_plain

    say("== phase 4: codesigned tiles on the card")
    gen = torch.Generator(device="cuda").manual_seed(1)
    stock = (np.array([16.0]), np.array([128.0]), np.array([96.0]))
    for name, st in STENCILS.items():
        lattice = LATTICE_3D if st.dims == 3 else LATTICE_2D
        size = ProblemSize(4096, 4096, 1024, s3=4096 if st.dims == 3 else 1)
        _, idx = solve_cell(st, MAXWELL_GPU, size, *stock, lattice)
        tiles = decode_index(lattice, int(idx[0]))
        tt = ts.normalize_tiles(tiles)
        shape = (4096, 4096) if st.dims == 2 else (4096, 4096, 4096)
        nbytes = ts.smem_layout(shape, ts.tile_shape(st.dims, tt), tt[2]).nbytes
        if nbytes > ts.SMEM_LIMIT_BYTES:
            say(f"  {name}: analytic optimum {tiles} needs {nbytes} B of shared memory for a "
                f"{tt[2]}-step pass, over the {ts.SMEM_LIMIT_BYTES} B a block may have: not run")
            check(st.dims == 3, f"{name}: a 2-D optimum must fit")
            continue
        x = torch.randn(shape, generator=gen, device="cuda")
        steps = tt[2]  # one full pass of the optimum's time tile
        got = ts.run_tiled(name, x, steps=steps, tiles=tiles)
        want = ts.run_tiled_plain(name, x, steps, tt)
        torch.cuda.synchronize()
        scale = max(1.0, float(want.abs().max()))
        e = _assert_close(got, want, 1e-4, 1e-4 * scale, f"{name} optimum tiles")
        say(f"  {name}: analytic optimum {tiles}, {steps} steps on 4096^2 through K1 "
            f"({nbytes} B of shared memory per block): matches plain (max |err| {e:.3g}, "
            f"field scale {scale:.3g})")
    for name, mod in ops.KERNELS.items():
        shape = (8192, 8192) if mod.DIMS == 2 else (256, 256, 256)
        x = torch.randn(shape, generator=gen, device="cuda")
        br = ops.tuned_block_rows(name, shape, x.dtype)
        got = ops.stencil_run(name, x, steps=4, block_rows=br)
        want = x
        for _ in range(4):
            want = step_plain(want, mod.update, mod.HALO)
        torch.cuda.synchronize()
        scale = max(1.0, float(want.abs().max()))
        e = _assert_close(got, want, 1e-4, 1e-4 * scale, f"{name} stencil_run")
        say(f"  {name}: ops.stencil_run 4 steps on {shape} at block_rows={br}: matches plain "
            f"(max |err| {e:.3g})")


def phase5_measure_fit():
    import numpy as np
    import torch

    from repro_torch.core.codesign import codesign
    from repro_torch.core.timemodel import MAXWELL_GPU
    from repro_torch.measure import default_grid, fit_machine_params, measure_grid

    say("== phase 5: measure -> refit -> calibrated codesign on the card")
    grid = default_grid(smoke=False)
    for name, cfgs in grid.items():
        big = (8192, 8192) if len(cfgs[0]["shape"]) == 2 else (256, 256, 256)
        tiles = []
        for c in cfgs:
            if c["tiles"] not in tiles:
                tiles.append(c["tiles"])
        cfgs.extend({"shape": big, "steps": c["steps"], "tiles": t} for t in tiles)
    n = sum(len(v) for v in grid.values())
    t0 = time.perf_counter()
    run = measure_grid(grid, warmup=1, repeats=3, gpu=MAXWELL_GPU)
    measure_s = time.perf_counter() - t0
    say(f"measure: {n} configurations in {measure_s:.2f} s; backend {run.backend}, note {run.note!r}")
    for r in run.records:
        say(f"  {r.stencil:12s} size {r.size} tiles {r.tiles}: {r.time_s * 1e3:.4f} ms "
            f"(repeats {', '.join(f'{t * 1e3:.4f}' for t in r.times_s)})")
    check(run.backend == "cuda" and not run.interpret, "records stamped as card runs")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cal = fit_machine_params(run)
    fit_s = time.perf_counter() - t0
    say(f"fit: {cal.iters} Adam iterations on the card in {fit_s:.2f} s; loss {cal.loss_before:.4g} -> "
        f"{cal.loss_after:.4g}; {cal.n_records} records, {cal.n_dropped} dropped")
    say(f"  bw_gmem {MAXWELL_GPU.bw_gmem:.4g} -> {cal.gpu.bw_gmem:.4g} B/s; launch_overhead "
        f"{MAXWELL_GPU.launch_overhead:.4g} -> {cal.gpu.launch_overhead:.4g} s")
    for name in cal.stencils:
        say(f"  {name:12s} c_iter {cal.stencils[name].c_iter:.4g} s; rel_err "
            f"{cal.errors_before[name]:.4f} -> {cal.errors_after[name]:.4f}")
    check(cal.loss_after < cal.loss_before, "the fit lowers the loss")
    t0 = time.perf_counter()
    res = codesign(cal.calibrated_workload(), gpu=cal.calibrated_gpu(), engine="torch")
    cal_s = time.perf_counter() - t0
    i, g = res.best()
    p = res.hw.point(i)
    check(np.isfinite(g), "calibrated best point is finite")
    say(f"calibrated codesign: {cal_s:.3f} s; best n_sm={p.n_sm} n_v={p.n_v} m_sm={p.m_sm} kB, "
        f"{g:.1f} GFLOP/s (model prediction, machine parameters fitted on this card)")
    return measure_s, fit_s, cal_s


def _bound_ms(name, shape, n, itemsize=4):
    """The least time for an n-step pass: each input element read once and
    each output element written once at the card's memory rate, or the
    useful flops at its f32 rate, whichever is larger."""
    from repro_torch.kernels import ops

    numel = 1
    for d in shape:
        numel *= d
    t_bytes = 2 * numel * itemsize / PEAK_BYTES_PER_S
    t_ops = ops.kernel_flops(name, shape, n) / PEAK_F32_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def tile_lines(gen):
    """K1 and K2 (heat, f32) at every tile of the measurement grid at
    8192^2 / 256^3, and K1 at the 2-D jacobi optimum on 4096^2: time, bound
    share, shared memory and blocks per SM."""
    import torch

    from repro_torch.kernels import tiled_stencils as ts
    from repro_torch.measure import default_grid

    runs = []
    for name, cfgs in default_grid(smoke=False).items():
        if name not in ("heat2d", "heat3d"):
            continue
        shape = (8192, 8192) if name == "heat2d" else (256, 256, 256)
        for tiles in {tuple(sorted(c["tiles"].items())) for c in cfgs}:
            runs.append((name, shape, dict(tiles)))
    runs.sort(key=lambda r: (r[0], ts.normalize_tiles(r[2])))
    runs.append(("jacobi2d", (4096, 4096), {"t_s1": 16, "t_s2": 128, "t_t": 32}))
    say("  K1/K2 per tile (one pass of t_t steps per launch, f32):")
    for name, shape, tiles in runs:
        tt = ts.normalize_tiles(tiles)
        x = torch.randn(shape, generator=gen, device="cuda")
        ms = _event_ms(lambda: ts.stencil_run_tiled(name, x, tt[2], tt))  # noqa: B023
        layout = ts.smem_layout(shape, ts.tile_shape(len(shape), tt), tt[2])
        blocks = ts.blocks_per_sm(len(shape), tt, layout)
        bound_ms, bound_by = _bound_ms(name, shape, tt[2])
        say(f"    {name:9s} {str(shape):16s} tiles {tt[:3] + (tt[4],) if len(shape) == 3 else tt[:3]}: "
            f"{ms:.4f} ms; bound {bound_ms:.4f} ms by {bound_by} ({bound_ms / ms:.1%} of it); "
            f"{layout.nbytes} B shared memory and {min(tt[1], 1024)} threads per block, "
            f"{blocks} blocks per SM")


def phase6_times(launches, errs):
    """Per kernel at the main path's shapes: kernel, plain and library
    times by CUDA events, and the bound; one row per kernel, keyed by its
    launch counter."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import ops
    from repro_torch.kernels import tiled_stencils as ts
    from repro_torch.kernels.stencil_common import step_plain

    say("== phase 6: times (CUDA events, warm, mean of 20 launches)")
    torch.backends.cudnn.allow_tf32 = False
    say("library yardstick: F.conv2d / F.conv3d with torch.backends.cudnn.allow_tf32 = False "
        "(interior only, no border copy; n chained calls for an n-step pass)")
    gen = torch.Generator(device="cuda").manual_seed(2)

    def weights(name, dims):
        mod = ops.KERNELS[name]
        w = torch.zeros((3,) * dims, device="cuda")
        centre = (1,) * dims
        if name == "jacobi2d":
            w[1, 1] = w[0, 1] = w[2, 1] = w[1, 0] = w[1, 2] = 0.2
            return w
        lap = 1.0 if name.startswith("laplacian") else mod.ALPHA
        for ax in range(dims):
            for off in (0, 2):
                idx = list(centre)
                idx[ax] = off
                w[tuple(idx)] = lap
        w[centre] = -2.0 * dims * lap + (0.0 if name.startswith("laplacian") else 1.0)
        return w

    def library_fn(name, x, n):
        if name == "gradient2d":
            return None
        dims = x.dim()
        w = weights(name, dims).view(1, 1, *(3,) * dims)
        conv = F.conv2d if dims == 2 else F.conv3d
        xin = x.view(1, 1, *x.shape)

        def run():
            y = xin
            for _ in range(n):
                y = conv(y, w)
            return y

        return run

    rows = {}
    configs = [
        ("tiled2d", NAMES_2D, (8192, 8192), {"t_s1": 16, "t_s2": 64, "t_t": 2}),
        ("tiled3d", NAMES_3D, (256, 256, 256), {"t_s1": 8, "t_s2": 32, "t_t": 2, "t_s3": 8}),
        ("step2d", NAMES_2D, (8192, 8192), None),
        ("step3d", NAMES_3D, (256, 256, 256), None),
    ]
    for kernel, names, shape, tiles in configs:
        for name in names:
            mod = ops.KERNELS[name]
            x = torch.randn(shape, generator=gen, device="cuda")
            if tiles is not None:
                tt = ts.normalize_tiles(tiles)
                n = tt[2]
                kfn = lambda: ts.stencil_run_tiled(name, x, n, tt)  # noqa: E731
                pfn = lambda: ts.run_tiled_plain(name, x, n, tt)  # noqa: E731
            else:
                n = 1
                br = ops.tuned_block_rows(name, shape, x.dtype)
                kfn = lambda: ops.stencil_step(name, x, block_rows=br)  # noqa: E731
                pfn = lambda: step_plain(x, mod.update, mod.HALO)  # noqa: E731
            ms = _event_ms(kfn)
            plain_ms = _event_ms(pfn, iters=5, warmup=1)
            lib = library_fn(name, x, n)
            library_ms = None
            if lib is not None:
                # the yardstick computes the stencil: its one-step interior
                # equals the plain step's
                one = library_fn(name, x, 1)().view(*(s - 2 for s in shape))
                inner = step_plain(x, mod.update, mod.HALO)[(slice(1, -1),) * len(shape)]
                _assert_close(one, inner, 1e-5, 1e-5, f"library yardstick {name}")
                library_ms = _event_ms(lib)
            bound_ms, bound_by = _bound_ms(name, shape, n, x.element_size())
            say(f"  {kernel} {name:12s} {shape} {'tiles ' + str(tiles) if tiles else 'block_rows ' + str(br)}: "
                f"{ms:.4f} ms ({n} step(s)/launch; bound {bound_ms:.4f} ms by {bound_by}, "
                f"{bound_ms / ms:.1%} of it); plain {plain_ms:.4f} ms; "
                f"library {'n/a' if library_ms is None else f'{library_ms:.4f} ms'}")
            if name in ("heat2d", "heat3d"):
                rows[kernel] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                                    library_ms=library_ms)
    tile_lines(gen)
    meta = {
        "tiled2d": ("K1 tiled2d [heat2d 8192^2, tiles (16,64,t_t=2)]", "src/repro_torch/kernels/csrc/tiled.cu",
                    "src/repro/kernels/pallas_stencils.py:168"),
        "tiled3d": ("K2 tiled3d [heat3d 256^3, tiles (8,32,t_t=2,t_s3=8)]", "src/repro_torch/kernels/csrc/tiled.cu",
                    "src/repro/kernels/pallas_stencils.py:189"),
        "step2d": ("K3 step2d [heat2d 8192^2]", "src/repro_torch/kernels/csrc/step.cu",
                   "src/repro/kernels/stencil_common.py:107"),
        "step3d": ("K4 step3d [heat3d 256^3]", "src/repro_torch/kernels/csrc/step.cu",
                   "src/repro/kernels/stencil_common.py:176"),
    }
    return {
        kernel: {"name": label, "route": "cuda", "source": source, "replaces": replaces,
                 "launches": launches[kernel], "max_abs_err": errs[kernel], **rows[kernel]}
        for kernel, (label, source, replaces) in meta.items()
    }


def phase6_attention():
    """The fused attention at ``ATTN_SHAPE`` (causal, bf16): its library's
    build, then forward and backward by CUDA events beside their bound,
    the plain core's times and ``F.scaled_dot_product_attention``'s (the
    library yardstick; the port never calls it); out, dq, dk and dv held
    against ``_sdpa``'s. One row per direction, keyed by its launch
    counter, whose launches ``main`` fills in from the LM paths that run
    the kernels."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import _build
    from repro_torch.kernels import attention as fa
    from repro_torch.models.attention import _mask_bias, _sdpa

    say("== phase 6 (attention): the fused kernels (CUDA events, warm, mean of 20 calls)")
    t0 = time.perf_counter()
    report = _build.build("attention")["attention"]
    compile_s = time.perf_counter() - t0
    say(f"attention library: built in {compile_s:.2f} s (nvcc {report['seconds']:.2f} s) -> "
        f"{report['path']}")
    for line in report["log"].splitlines():
        if any(k in line for k in ("Compiling entry", "registers", "spill", "error")):
            say("    " + line.strip())
    b, s, h, kh, d = ATTN_SHAPE
    gen = torch.Generator(device="cuda").manual_seed(6)
    q, k, v, dout = (torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)
                     for shape in ((b, s, h, d), (b, s, kh, d), (b, s, kh, d), (b, s, h, d)))
    pos = torch.arange(s, device="cuda")[None].expand(b, s)
    scale = 1.0 / math.sqrt(d)
    bias = _mask_bias(pos, pos, "causal", 0)
    cores = {
        "fused": lambda q, k, v: fa.fused_attention(q, k, v, pos, pos, True, 0, scale),
        "plain": lambda q, k, v: _sdpa(q, k, v, bias, scale),
        "library": lambda q, k, v: F.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), is_causal=True,
            enable_gqa=True).transpose(1, 2),
    }
    fwd, bwd = {}, {}
    for name, core in cores.items():
        with torch.no_grad():
            fwd[name] = _event_ms(lambda: core(q, k, v))
        leaves = [t.detach().requires_grad_() for t in (q, k, v)]
        out = core(*leaves)
        bwd[name] = _event_ms(lambda: torch.autograd.grad(out, leaves, dout, retain_graph=True))
        del out, leaves

    def grads(core, dtype):
        """out, dq, dk, dv of ``core`` in ``dtype`` on the bf16 inputs, as f32."""
        leaves = [t.detach().to(dtype).requires_grad_() for t in (q, k, v)]
        out = core(*leaves)
        return [out.detach().float()] + [g.float() for g in torch.autograd.grad(
            out, leaves, dout.to(dtype))]

    # the card tests' rule (tests/test_torch_attention_kernel.py): against
    # _sdpa in f32, the fused core's worst error within 1.25x bf16 _sdpa's
    # plus half a bf16 ulp, its mean error within 1.1x, each relative to its
    # own tensor's largest entry
    ref = grads(cores["plain"], torch.float32)
    errs = {}
    for name in ("plain", "fused", "library"):
        got = grads(cores[name], torch.bfloat16)
        errs[name] = [(float((x - r).abs().max()), float((x - r).abs().mean()))
                      for x, r in zip(got, ref)]
        del got
    tops = [float(r.abs().max()) for r in ref]
    del ref
    for i, what in enumerate(("out", "dq", "dk", "dv")):
        (w_plain, m_plain), (w_fused, m_fused) = errs["plain"][i], errs["fused"][i]
        w_lib = errs["library"][i][0]
        say(f"  {what} against f32 _sdpa (max |{what}| {tops[i]:.4g}): worst |err| fused "
            f"{w_fused:.4g}, bf16 _sdpa {w_plain:.4g}, library {w_lib:.4g}; mean |err| fused "
            f"{m_fused:.4g}, bf16 _sdpa {m_plain:.4g}")
        check(math.isfinite(w_fused) and w_fused / tops[i] <= 1.25 * w_plain / tops[i] + 2.0 ** -8,
              f"fused attention {what}: worst |err| {w_fused} against bf16 _sdpa's {w_plain}")
        check(m_fused <= 1.1 * m_plain,
              f"fused attention {what}: mean |err| {m_fused} against bf16 _sdpa's {m_plain}")
    check(errs["library"][0][0] <= 2.0 ** -6 * tops[0],
          "the library yardstick computes the plain core's function")
    err = {"attn_fwd": errs["fused"][0][0], "attn_bwd": max(e for e, _ in errs["fused"][1:])}
    # useful products: QK^T and PV over the causal pairs s (s + 1) / 2 in the
    # forward; dP, dV, dQ and dK (twice the forward's) in the backward
    useful = 2 * 2 * b * h * d * s * (s + 1) / 2
    rows = {}
    for kernel, ms, plain_ms, library_ms, flops in (
            ("attn_fwd", fwd["fused"], fwd["plain"], fwd["library"], useful),
            ("attn_bwd", bwd["fused"], bwd["plain"], bwd["library"], 2 * useful)):
        bound_ms = flops / PEAK_BF16_FLOPS * 1e3
        say(f"  {kernel} {ATTN_SHAPE} causal bf16: {ms:.4f} ms ({flops / ms / 1e9:.1f} TFLOP/s "
            f"useful; bound {bound_ms:.4f} ms by bf16 products, {bound_ms / ms:.1%} of it); plain "
            f"{plain_ms:.4f} ms; library {library_ms:.4f} ms")
        rows[kernel] = {"name": f"{kernel} [{b}x{s}, {h}/{kh} heads of {d}, causal]",
                        "route": "cuda", "source": "src/repro_torch/kernels/csrc/attention.cu",
                        "replaces": "none (the plain core _sdpa; the reference's attention is jnp)",
                        "launches": 0, "launches_by_path": {}, "max_abs_err": err[kernel],
                        "ms": ms, "plain_ms": plain_ms,
                        "bound_ms": bound_ms, "bound_by": "bf16 products", "library_ms": library_ms,
                        "compile_s": compile_s}
    return rows


def _pct(values, q):
    """The q-th percentile (nearest rank) of ``values``."""
    ordered = sorted(values)
    return ordered[min(len(ordered) - 1, max(0, -(-len(ordered) * q // 100) - 1))]


def phase7_served(analytic, smi):
    """measure.cli run -> fit -> build on the card, then the calibrated
    sweep served from the store; a cold and a warm server at the stock
    spec. Returns the build seconds."""
    import tempfile
    import threading

    import numpy as np
    import torch

    from repro_torch.kernels import _build
    from repro_torch.measure import CalibrationResult, MeasurementRun, cli
    from repro_torch.service import ArtifactStore, CodesignServer, QueryRequest, server_from_artifact

    say("== phase 7: served path (measure.cli run -> fit -> build, then the server)")
    with tempfile.TemporaryDirectory(prefix="chip-smoke-store-") as root:
        store = ArtifactStore(root)
        before = dict(_build.LAUNCHES)
        t0 = time.perf_counter()
        cli.main(["run", "--store", root, "--full"])
        run_s = time.perf_counter() - t0
        launched = {k: _build.LAUNCHES[k] - before[k] for k in before}
        say(f"  run: {run_s:.2f} s; kernel launches {launched}")
        check(launched["tiled2d"] > 0 and launched["tiled3d"] > 0, "measure.cli run launched K1 and K2")
        meas = cli._latest(store, "measurement")
        run = MeasurementRun.from_payload(meas.payload)
        check(run.backend == "cuda" and run.interpret is False, "stored measurement is a card run")
        check(meas.routing()["backend"] == "cuda" and meas.routing()["interpret"] is False,
              "measurement routing stamped from the run")

        cli.main(["fit", "--store", root])
        cal = CalibrationResult.from_payload(cli._latest(store, "calibration").payload)
        check(cal.loss_after < cal.loss_before, "the CLI fit lowers the loss")

        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cli.main(["build", "--store", root, "--engine", "torch"])
        build_s = time.perf_counter() - t0
        art = cli._latest(store, "sweep")
        check((art.n_cells, art.n_hw) == (96, 5121), "calibrated build at full width")
        check(art.manifest["spec"]["engine"] == "torch", "built by the torch engine")
        say(f"served: build --engine torch (5,121 points x 96 cells, sweep + store write) "
            f"{build_s:.3f} s [{smi}]")

        srv = server_from_artifact(store, art, batch_window=0.002)
        solo = server_from_artifact(store, art, batch_window=0.0)
        names = art.stencil_names
        rng = np.random.default_rng(0)
        reqs = [QueryRequest(freqs=dict(zip(names, rng.uniform(0.1, 1.0, size=len(names)))),
                             max_area=float(rng.uniform(350.0, 650.0)), top_k=3, pareto=True,
                             use_cache=False) for _ in range(64)]

        def reduce_seconds():
            from repro_torch.obs import get_registry

            samples = get_registry().snapshot()["repro_query_reduce_seconds"]["samples"]
            return (samples[0]["sum"], samples[0]["count"]) if samples else (0.0, 0)

        seq_lat = []
        red0 = reduce_seconds()
        t0 = time.perf_counter()
        for r in reqs:
            t = time.perf_counter()
            solo.query(r)
            seq_lat.append(time.perf_counter() - t)
        seq_qps = len(reqs) / (time.perf_counter() - t0)
        red1 = reduce_seconds()

        out, lat = [None] * len(reqs), [0.0] * len(reqs)
        barrier = threading.Barrier(len(reqs))

        def worker(i):
            barrier.wait()
            t = time.perf_counter()
            out[i] = srv.query(reqs[i])
            lat[i] = time.perf_counter() - t

        threads = [threading.Thread(target=worker, args=(i,)) for i in range(len(reqs))]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        batch_qps = len(reqs) / (time.perf_counter() - t0)
        red2 = reduce_seconds()
        for i, r in enumerate(reqs):
            want = srv.query(r)  # the same server, one at a time
            got = out[i]
            check(got is not None and got.best_index == want.best_index, f"request {i}: best index")
            check([t["index"] for t in got.top_k] == [t["index"] for t in want.top_k], f"request {i}: top-k")
            check(abs(got.best_gflops - want.best_gflops) <= 1e-12 * abs(want.best_gflops),
                  f"request {i}: best GFLOP/s within rel 1e-12")
            check(np.array_equal(got.pareto_indices, want.pareto_indices), f"request {i}: Pareto indices")
        check(srv.stats["max_batch"] > 1, "the rendezvous batched")
        say(f"  64 microbatched answers equal the same server's one-at-a-time answers; "
            f"batches {srv.stats['batches'] - len(reqs)}, largest {srv.stats['max_batch']}")
        say(f"served: queries one at a time {seq_qps:.1f} q/s, p50 {_pct(seq_lat, 50) * 1e3:.3f} ms, "
            f"p99 {_pct(seq_lat, 99) * 1e3:.3f} ms [{smi}]")
        say(f"served: queries microbatched (64 threads, window 2 ms) {batch_qps:.1f} q/s, "
            f"p50 {_pct(lat, 50) * 1e3:.3f} ms, p99 {_pct(lat, 99) * 1e3:.3f} ms [{smi}]")
        say(f"served: reduction (repro_query_reduce_seconds) one at a time "
            f"{(red1[0] - red0[0]) / (red1[1] - red0[1]) * 1e3:.4f} ms per request of "
            f"{sum(seq_lat) / len(seq_lat) * 1e3:.4f} ms mean latency; microbatched "
            f"{(red2[0] - red1[0]) * 1e3:.4f} ms in {red2[1] - red1[1]} pass(es) [{smi}]")

        cold = CodesignServer(store, engine="torch", batch_window=0.0)
        check(not cold.warm, "the stock-spec sweep is not stored yet")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cold_resp = cold.query(QueryRequest())
        cold_s = time.perf_counter() - t0
        check(cold.stats["artifact_builds"] == 1, "the cold server built once, on the card")
        warm = CodesignServer(store, engine="torch", batch_window=0.0)
        check(warm.warm, "a second server over the same store is warm")
        warm_resp = warm.query(QueryRequest())
        check(warm.stats["artifact_builds"] == 0 and warm.stats["artifact_loads"] == 1,
              "the warm server loaded, never built")
        i3, g3 = analytic.best()
        check(warm_resp.best_index == cold_resp.best_index == i3, "warm best point = phase 3's")
        check(abs(warm_resp.best_gflops - g3) <= 1e-12 * abs(g3), "warm best GFLOP/s = phase 3's")
        p = warm_resp.best_point
        say(f"  cold server miss path (sweep on the card + store write + first answer) {cold_s:.3f} s; "
            f"warm server best n_sm={p['n_sm']} n_v={p['n_v']} m_sm={p['m_sm']} kB, "
            f"{warm_resp.best_gflops:.1f} GFLOP/s (model prediction) = phase 3's")
    return build_s

class _Serve:
    """One ``repro_torch.service.cli serve --port 0`` child; its URL is read
    off its stdout. Stopped (terminate, then kill) on exit."""

    def __init__(self, root, *flags, env=None):
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "repro_torch.service.cli", "serve", "--store", root,
             "--port", "0", *flags],
            stdout=subprocess.PIPE, text=True, env=env)
        self.url = None
        try:
            for line in self.proc.stdout:  # the bound address is printed last
                if line.startswith("serving on "):
                    self.url = line.split()[-1]
                    break
            check(self.url is not None, "serve printed its bound address")
        except BaseException:
            self.__exit__()
            raise

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.proc.terminate()
        try:
            self.proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            self.proc.wait()
        self.proc.stdout.close()


def _post(url, body, path="/v1/query"):
    """(status, headers, body) of one POST without the client's retries."""
    import urllib.error
    import urllib.request

    req = urllib.request.Request(url + path, data=body, method="POST",
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, dict(r.headers), r.read()
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), e.read()


def phase8_gateway(smi):
    """The fleet gateway over HTTP, from child processes of the port's
    service CLI: full-width torch builds for gtx980 and titanx, a K=2
    portfolio over each scored on the card (the CLI's default engine) and
    held against the numpy oracle, then ``serve`` answering /v1/query, /v1/query_many and
    /v1/route byte-identically to the in-process servers, its metrics,
    SLO, errors, rate limit and a member fault. Returns the build seconds
    per GPU."""
    import dataclasses
    import math
    import os
    import tempfile
    import threading

    import numpy as np

    from repro_torch.core.portfolio import optimize_portfolio_arrays
    from repro_torch.service import (
        ArtifactStore,
        CodesignServer,
        GatewayClient,
        PortfolioServer,
        QueryRequest,
        RetryPolicy,
        RouteRequest,
        wire,
    )

    say("== phase 8: the fleet gateway over HTTP (service CLI children on the card)")
    env = dict(os.environ, PYTHONUNBUFFERED="1")
    env["PYTHONPATH"] = str(ROOT / "src") + os.pathsep + env.get("PYTHONPATH", "")
    gpus = ("gtx980", "titanx")
    budget = 900.0

    def run_cli(*args):
        t0 = time.perf_counter()
        r = subprocess.run([sys.executable, "-m", "repro_torch.service.cli", *args],
                           capture_output=True, text=True, env=env, timeout=600)
        check(r.returncode == 0, f"cli {args[0]} exited {r.returncode}: {r.stderr.strip()}")
        return r.stdout.strip(), time.perf_counter() - t0

    build_s = {}
    with tempfile.TemporaryDirectory(prefix="chip-smoke-gateway-") as root:
        store = ArtifactStore(root)
        sweeps, portfolios = {}, {}
        for gpu in gpus:
            base = ("--store", root, "--gpu", gpu, "--engine", "torch")
            out, wall = run_cli("build", *base)
            build_s[gpu] = wall
            say(f"gateway: build --gpu {gpu} --engine torch (child process, sweep on the card): "
                f"{out} ; child wall {wall:.3f} s [{smi}]")
            out, wall = run_cli("portfolio", *base, "--k", "2", "--budget", str(budget),
                                "--objective", "throughput")
            say(f"  portfolio (default engine, torch on the card): {out} ; child wall {wall:.3f} s")
        for row in store.entries():
            art = store.get(row["key"])
            if row["kind"] == "sweep":
                check((art.n_cells, art.n_hw) == (96, 5121), f"{row['gpu']} sweep at full width")
                check(art.manifest["spec"]["engine"] == "torch", "sweep built by the torch engine")
                sweeps[row["gpu"]] = art
            else:
                portfolios[row["gpu"]] = art
        check(sorted(sweeps) == sorted(portfolios) == sorted(gpus), "a sweep and a portfolio per GPU")

        # each stored torch portfolio against the numpy oracle on the same stored matrix
        for gpu in gpus:
            sw, pf = sweeps[gpu], portfolios[gpu].payload
            check(pf["sweep_key"] == sw.key and pf["engine"] == "torch", f"{gpu}: portfolio of the sweep")
            args = (sw.hw_area, sw.cell_time, sw.cell_flops(), sw.cell_freqs(), 2, budget)
            t0 = time.perf_counter()
            oracle = optimize_portfolio_arrays(*args, objective="throughput", engine="numpy")
            numpy_s = time.perf_counter() - t0
            torch_s = []
            for _ in range(2):  # cold (first call in this process), then warm
                t0 = time.perf_counter()
                mine = optimize_portfolio_arrays(*args, objective="throughput", engine="torch")
                torch_s.append(time.perf_counter() - t0)
            check(mine.members == tuple(pf["members"]), f"{gpu}: in-process torch = stored portfolio")
            check(tuple(pf["candidates"]) == oracle.candidates,
                  f"{gpu}: the card's dominance mask = numpy's")
            if oracle.members == tuple(pf["members"]):
                check(pf["fleet_gflops"] == oracle.fleet_gflops, f"{gpu}: same members, same fleet")
                tie = "same members"
            else:  # float64 sums in another order: a tie to the last bits only
                check(math.isclose(pf["fleet_gflops"], oracle.fleet_gflops, rel_tol=1e-12),
                      f"{gpu}: other members only on a tie within 1e-12")
                tie = f"oracle names {oracle.members}, a tie within 1e-12"
            n_cand = len(oracle.candidates)
            subsets = sw.n_hw + math.comb(n_cand, 2)
            f = sw.cell_freqs()
            g = (f @ sw.cell_flops()) / (f @ np.asarray(sw.cell_time, np.float64)) / 1.0e9
            single = float(np.max(np.where(sw.hw_area <= budget, g, -np.inf)))
            check(pf["fleet_gflops"] >= single * (1 - 1e-12), f"{gpu}: fleet >= best single design")
            say(f"gateway: portfolio {gpu} K=2 budget {budget:g} throughput: candidates {n_cand} "
                f"of {sw.n_hw}, subsets scored {subsets}, members {tuple(pf['members'])} ({tie}), "
                f"fleet {pf['fleet_gflops']:.1f} GFLOP/s, best single {single:.1f} GFLOP/s "
                f"(model predictions); in process: numpy oracle {numpy_s:.3f} s, torch on the "
                f"card {torch_s[0]:.3f} s cold / {torch_s[1]:.3f} s warm [{smi}]")

        oracles = {gpu: CodesignServer.from_artifact(store, sweeps[gpu], batch_window=0.0)
                   for gpu in gpus}
        routers = {gpu: PortfolioServer(portfolios[gpu], sweeps[gpu]) for gpu in gpus}
        names = sweeps[gpus[0]].stencil_names
        rng = np.random.default_rng(8)
        reqs = [QueryRequest(freqs=dict(zip(names, rng.uniform(0.1, 1.0, size=len(names)).tolist())),
                             max_area=float(rng.uniform(350.0, 650.0)), top_k=3, pareto=True,
                             use_cache=False) for _ in range(64)]
        routes = [{"gpu": gpus[i % 2]} for i in range(len(reqs))]
        lone = [oracles[r["gpu"]].query(q) for q, r in zip(reqs, routes)]
        want = [wire.encode_response(resp) for resp in lone]

        def same_as_lone(i, resp):
            """Bytes equal to the lone in-process answer, but for the
            ``batch_size`` a microbatched answer reports."""
            return wire.encode_response(resp) == wire.encode_response(
                dataclasses.replace(lone[i], batch_size=resp.batch_size))

        with _Serve(root, env=env) as srv:
            client = GatewayClient(srv.url)
            check(client.health()["artifacts"] == 4, "healthz sees both sweeps and both portfolios")
            seq_lat = []
            t0 = time.perf_counter()
            for i, q in enumerate(reqs):
                t = time.perf_counter()
                raw = client.query_bytes(q, route=routes[i])
                seq_lat.append(time.perf_counter() - t)
                check(raw == want[i], f"HTTP query {i} byte-identical to the in-process answer")
            seq_qps = len(reqs) / (time.perf_counter() - t0)

            got, lat = [None] * len(reqs), [0.0] * len(reqs)
            barrier = threading.Barrier(len(reqs))

            def worker(i):
                c = GatewayClient(srv.url, retry=None)
                barrier.wait()
                t = time.perf_counter()
                got[i] = c.query(reqs[i], route=routes[i])
                lat[i] = time.perf_counter() - t
                c.close()

            threads = [threading.Thread(target=worker, args=(i,)) for i in range(len(reqs))]
            t0 = time.perf_counter()
            for t in threads:
                t.start()
            for t in threads:
                t.join()
            par_qps = len(reqs) / (time.perf_counter() - t0)
            for i, resp in enumerate(got):
                check(resp is not None and same_as_lone(i, resp),
                      f"threaded HTTP query {i} equals the lone in-process answer")
            max_batch = max(r.batch_size for r in got)

            t0 = time.perf_counter()
            many = client.query_many([(q, None, r) for q, r in zip(reqs, routes)])
            many_s = time.perf_counter() - t0
            for i, resp in enumerate(many):
                check(same_as_lone(i, resp), f"query_many element {i} equals the lone answer")
            say(f"  64 queries one at a time, from 64 threads (largest batch {max_batch}) and in one "
                f"/v1/query_many (batch {max(r.batch_size for r in many)}): each equals the lone "
                f"in-process answer byte for byte (batched answers but for their batch_size)")

            n_routes = 0
            for gpu in gpus:
                for cell in routers[gpu].cell_labels():
                    rq = RouteRequest(cell=cell)
                    raw = client.route_bytes(rq, route={"gpu": gpu})
                    check(raw == wire.encode_route_response(routers[gpu].route(rq)),
                          f"/v1/route {gpu}/{cell} byte-identical to the in-process router")
                    n_routes += 1
            say(f"  /v1/route for all {n_routes} cell groups of both portfolios: byte-identical")

            snap = client.metrics()
            n_query = sum(s["value"] for s in snap["repro_gateway_requests_total"]["samples"]
                          if s["labels"].get("route") == "/v1/query")
            check(n_query == 2 * len(reqs), f"/v1/query counter {n_query} = {2 * len(reqs)} sent")
            slo = client.slo()["routes"]["/v1/query"]
            check(slo["windows"]["1h"]["count"] == 2 * len(reqs), "/v1/slo counted the queries")
            check(all(math.isfinite(w["availability_burn"]) and math.isfinite(w["latency_burn"])
                      for w in slo["windows"].values()), "finite burn rates")
            health = client.health()
            check(health["ok"] and health["slo"] in ("ok", "burning", "violated"), "healthz")
            w1h = slo["windows"]["1h"]
            say(f"  metrics: /v1/query counter {n_query:g}; /v1/slo status {slo['status']}, 1h: "
                f"p99 estimate {w1h['p_estimate_s'] * 1e3:.3f} ms, availability burn "
                f"{w1h['availability_burn']:g}, latency burn {w1h['latency_burn']:g}; "
                f"healthz slo {health['slo']}")

            try:
                client.query(reqs[0], artifact="0" * 20)
                check(False, "an unknown artifact must answer an error")
            except wire.RemoteError as e:
                check(e.code == "unknown_artifact" and e.http_status == 404, "404 unknown_artifact")
            status, _, body = _post(srv.url, b"{not json")
            check(status == 400 and json.loads(body)["error"]["code"] == "bad_request",
                  "400 bad_request")
            check(client.query_bytes(reqs[0], route=routes[0]) == want[0] and client.health()["ok"],
                  "the server answers as before after the errors")
            client.close()

        body = wire.encode_request(reqs[0], route=routes[0])
        with _Serve(root, "--rate-limit", "1", env=env) as srv:
            first, _, raw = _post(srv.url, body)
            status, headers, err = _post(srv.url, body)
            check(first == 200 and raw == want[0], "first request rides the burst token")
            check(status == 429 and json.loads(err)["error"]["code"] == "rate_limited",
                  "a drained bucket answers 429 rate_limited")
            check(int(headers.get("Retry-After", 0)) >= 1, "429 carries Retry-After")
            retrying = GatewayClient(srv.url, retry=RetryPolicy(max_retries=3))
            check(retrying.query_bytes(reqs[0], route=routes[0]) == want[0],
                  "a client honouring Retry-After succeeds byte-identically")
        say(f"  --rate-limit 1: 429 rate_limited with Retry-After {headers.get('Retry-After')}; "
            f"the retrying client then got the byte-identical answer")

        gpu = gpus[0]
        router = routers[gpu]
        cell = router.cell_labels()[0]
        healthy = router.route(RouteRequest(cell=cell))
        check(len(router.members) == 2, f"{gpu}: a two-member portfolio to degrade")
        hw = healthy.hw_index
        faults = {f"route.member.{hw}": {"error": "RuntimeError:member down", "count": 3}}
        with _Serve(root, env=dict(env, REPRO_FAULTS=json.dumps(faults))) as srv:
            client = GatewayClient(srv.url)
            for _ in range(3):
                resp = client.route(cell, route={"gpu": gpu})
                check(resp.degraded and resp.fallback_from == (hw,) and resp.hw_index != hw
                      and resp.hw_index in router.members,
                      f"route.member.{hw} armed: {cell} degrades onto the other member")
            raw = client.route_bytes(RouteRequest(cell=cell), route={"gpu": gpu})
            check(raw == wire.encode_route_response(healthy),
                  "the fault cleared: routing recovers byte-identically")
            client.close()
        say(f"  route.member.{hw} armed 3 times: {cell} served degraded by hw {resp.hw_index}, "
            f"then recovered onto hw {hw}")

        say(f"gateway: HTTP /v1/query one at a time {seq_qps:.1f} q/s, p50 "
            f"{_pct(seq_lat, 50) * 1e3:.3f} ms, p99 {_pct(seq_lat, 99) * 1e3:.3f} ms [{smi}]")
        say(f"gateway: HTTP /v1/query from 64 threads (batch window 2 ms) {par_qps:.1f} q/s, p50 "
            f"{_pct(lat, 50) * 1e3:.3f} ms, p99 {_pct(lat, 99) * 1e3:.3f} ms [{smi}]")
        say(f"gateway: HTTP /v1/query_many of 64 {many_s * 1e3:.3f} ms [{smi}]")
    return build_s


def _lm_tie_check(wl, hw, want, got, rtol=1e-12):
    """The torch LM sweep against the numpy oracle: the same feasibility,
    times within ``rtol`` relative, and a plan index that differs only
    where the scalar oracle times the torch engine's plan the same."""
    import numpy as np

    from repro_torch.core.lmcells import lm_cell_roofline, lm_sw_lattice

    feas = np.isfinite(want.cell_time)
    check(np.array_equal(np.isfinite(got.cell_time), feas), "LM torch: the oracle's feasibility")
    err = float(np.max(np.abs(got.cell_time[feas] - want.cell_time[feas]) / want.cell_time[feas]))
    check(err <= rtol, f"LM torch times within rel {rtol} of numpy (max {err:.3g})")
    ties = 0
    for ci, hi in zip(*np.nonzero(got.cell_plan_idx != want.cell_plan_idx)):
        cell, pt = wl.cells[ci], hw.point(int(hi))
        plan = lm_sw_lattice(cell.op).plan(pt["pod"], pt["data"], pt["model"],
                                           int(got.cell_plan_idx[ci, hi]))
        t = lm_cell_roofline(cell, plan)["bound_s"]
        check(abs(t - want.cell_time[ci, hi]) <= rtol * want.cell_time[ci, hi],
              f"LM torch plan {ci},{hi}: another plan only on a tie")
        ties += 1
    return err, ties


def phase9_lm(smi):
    """LM-workload codesign on the card: the default question (Llama-3-8B +
    Mixtral-8x22B, 7 cells, 512 chips) with the float64 torch engine held
    to the numpy oracle; the docs' question (Llama-3-8B decode at batch 64
    under 64 chips) through an ``LMServer`` whose miss path sweeps on the
    card; ``python -m repro_torch.service.cli build --workload lm --engine
    torch`` and a K=2 ``portfolio`` over it as children; a ``serve`` child
    answering LM queries (``{"workload": "lm"}``) beside a stencil sweep
    in the same store, byte-identically to the in-process servers; and
    Llama-3-8B's full parameter tree materialised on the card in bf16."""
    import math
    import os
    import tempfile

    import numpy as np
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.core.lmcells import enumerate_lm_hw_space, lm_codesign, lm_workload
    from repro_torch.core.portfolio import optimize_portfolio_arrays
    from repro_torch.models import Model, count_params
    from repro_torch.service import (
        ArtifactStore,
        CodesignServer,
        GatewayClient,
        LMServer,
        PortfolioServer,
        QueryRequest,
        RouteRequest,
        server_from_artifact,
        wire,
    )

    say("== phase 9: LM-workload codesign on the card (model predictions for the modelled fleet)")
    wl, hw = lm_workload(), enumerate_lm_hw_space(512)
    check((len(wl.cells), len(hw)) == (7, 100), "the default LM question: 7 cells x 100 meshes")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want = lm_codesign(wl, hw=hw, engine="numpy")
    numpy_s = time.perf_counter() - t0
    torch_s = []
    for _ in range(2):  # cold (the first torch LM sweep of the process), then warm
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = lm_codesign(wl, hw=hw, engine="torch")
        torch.cuda.synchronize()
        torch_s.append(time.perf_counter() - t0)
    err, ties = _lm_tie_check(wl, hw, want, got)
    i, g = got.best()
    wi, wg = want.best()
    check(i == wi and abs(g - wg) <= 1e-12 * abs(wg), "LM torch best point = numpy's")
    p = hw.point(i)
    say(f"lm: lm_codesign 512 chips (7 cells x 100 meshes): torch on the card {torch_s[0]:.4f} s "
        f"cold / {torch_s[1]:.4f} s warm, numpy {numpy_s:.4f} s; max rel time diff {err:.3g}, "
        f"plans that differ on a tie {ties}; best pod={p['pod']} data={p['data']} "
        f"model={p['model']} {g:.1f} GFLOP/s (model prediction) [{smi}]")

    env = dict(os.environ, PYTHONUNBUFFERED="1")
    env["PYTHONPATH"] = str(ROOT / "src") + os.pathsep + env.get("PYTHONPATH", "")

    def run_cli(*args):
        t0 = time.perf_counter()
        r = subprocess.run([sys.executable, "-m", "repro_torch.service.cli", *args],
                           capture_output=True, text=True, env=env, timeout=600)
        check(r.returncode == 0, f"cli {args[0]} exited {r.returncode}: {r.stderr.strip()}")
        return r.stdout.strip(), time.perf_counter() - t0

    with tempfile.TemporaryDirectory(prefix="chip-smoke-lm-docs-") as docs_root:
        docs_store = ArtifactStore(docs_root)
        # the docs' question: 49 meshes, so auto would pick numpy; force torch
        docs = LMServer(docs_store, workload=lm_workload(archs=("llama3-8b",)), max_chips=64,
                        engine="torch", batch_window=0.0)
        check(len(docs.hw) == 49 and not docs.warm, "the docs' question: 49 meshes, not stored")
        req = QueryRequest(freqs={"llama3-8b:decode": 1.0}, max_area=64.0, top_k=3)
        t0 = time.perf_counter()
        resp = docs.query(req)
        docs_s = time.perf_counter() - t0
        check(docs.stats["artifact_builds"] == 1, "the docs' LMServer built once, on the card")
        check(docs_store.get(docs.key).manifest["spec"]["engine"] == "torch", "docs' sweep keyed torch")
        bp = resp.best_point
        check((bp["pod"], bp["data"], bp["model"]) == (1, 4, 16), f"docs' best point {bp}")
        tie = [t for t in resp.top_k if (t["pod"], t["data"], t["model"]) == (2, 2, 16)]
        check(len(tie) == 1 and tie[0]["gflops"] == resp.best_gflops,
              "pod=2 data=2 model=16 ties with the best point")
        say(f"lm: docs' question (llama3-8b decode, batch 64, <= 64 chips; LMServer miss path, "
            f"torch sweep on the card) {docs_s:.3f} s: best_index {resp.best_index} = pod=1 data=4 "
            f"model=16, {resp.best_gflops:.1f} GFLOP/s (model prediction), tied by pod=2 data=2 "
            f"model=16 [{smi}]")

    with tempfile.TemporaryDirectory(prefix="chip-smoke-lm-") as root:
        store = ArtifactStore(root)
        base = ("--store", root, "--workload", "lm", "--engine", "torch")
        out, build_wall = run_cli("build", *base)
        say(f"lm: build --workload lm --engine torch (child, sweep on the card): {out} ; "
            f"child wall {build_wall:.3f} s [{smi}]")
        out, pf_wall = run_cli("portfolio", *base, "--k", "2", "--budget", "512",
                               "--objective", "throughput")
        say(f"  portfolio --k 2 --budget 512 --objective throughput (default engine, torch on "
            f"the card): {out} ; child wall {pf_wall:.3f} s")
        lm_key = store.key_for_lm(wl, hw, "torch")
        lm_art = store.get(lm_key)
        check(lm_art is not None and lm_art.family == "lm", "the child stored the torch LM sweep")
        stored = lm_art.to_result()
        check(np.array_equal(stored.cell_time, got.cell_time)
              and np.array_equal(stored.cell_plan_idx, got.cell_plan_idx),
              "the child's torch LM sweep = the in-process torch sweep")
        (pf,) = [store.get(r["key"]) for r in store.entries() if r["kind"] == "portfolio"]
        check(pf.payload["sweep_key"] == lm_key and pf.payload["engine"] == "torch",
              "the LM portfolio of the stored sweep, scored by torch")
        oracle = optimize_portfolio_arrays(lm_art.hw_area, lm_art.cell_time, lm_art.cell_flops(),
                                           lm_art.cell_freqs(), 2, 512.0, objective="throughput",
                                           engine="numpy")
        if oracle.members == tuple(pf.payload["members"]):
            check(pf.payload["fleet_gflops"] == oracle.fleet_gflops, "LM portfolio = the oracle's")
        else:
            check(math.isclose(pf.payload["fleet_gflops"], oracle.fleet_gflops, rel_tol=1e-12),
                  "LM portfolio: other members only on a tie within 1e-12")
        members = [hw.point(m) for m in pf.payload["members"]]
        say(f"  LM portfolio members {tuple(pf.payload['members'])} "
            f"({', '.join('pod=%d data=%d model=%d' % (m['pod'], m['data'], m['model']) for m in members)}), "
            f"fleet {pf.payload['fleet_gflops']:.1f} GFLOP/s (model prediction); numpy oracle "
            f"names {oracle.members}")

        stencil = CodesignServer(store, engine="torch", batch_window=0.0)
        stencil.ensure_artifact()  # the full-width stencil sweep, on the card
        lm_srv = server_from_artifact(store, lm_art, batch_window=0.0)
        router = PortfolioServer(pf, lm_art)
        labels = [c.label for c in wl.cells]
        rng = np.random.default_rng(9)
        lm_reqs = [QueryRequest(freqs=dict(zip(labels, rng.uniform(0.1, 1.0, len(labels)).tolist())),
                                max_area=float(rng.choice([128.0, 256.0, 512.0])), top_k=3,
                                pareto=True, use_cache=False) for _ in range(16)]
        lm_reqs += [QueryRequest(freqs={"llama3-8b:decode": 1.0}, max_area=64.0, top_k=3),
                    QueryRequest(freqs={"mixtral-8x22b": 1.0}, fix={"model": 8.0}),
                    QueryRequest(freqs={"train": 1.0}, max_area=0.5)]
        st_req = QueryRequest(max_area=450.0, top_k=3, pareto=True, use_cache=False)
        with _Serve(root, env=env) as srv:
            client = GatewayClient(srv.url)
            lat = []
            for q in lm_reqs:
                t = time.perf_counter()
                raw = client.query_bytes(q, route={"workload": "lm"})
                lat.append(time.perf_counter() - t)
                check(raw == wire.encode_response(lm_srv.query(q)),
                      "HTTP LM query byte-identical to the in-process LMServer")
            check(client.query_bytes(st_req, route={"family": "stencil"})
                  == wire.encode_response(stencil.query(st_req)),
                  "the stencil sweep beside it answers byte-identically")
            for cell in router.cell_labels():
                rq = RouteRequest(cell=cell)
                check(client.route_bytes(rq, route={"workload": "lm"})
                      == wire.encode_route_response(router.route(rq)),
                      f"/v1/route {cell} byte-identical to the in-process router")
            rows = {r["key"]: r for r in client.artifacts()}
            check(rows[lm_key]["family"] == "lm" and rows[stencil.key].get("family", "stencil")
                  == "stencil", "/v1/artifacts lists both families")
            client.close()
        say(f"lm: serve child: {len(lm_reqs)} LM /v1/query ({{\"workload\": \"lm\"}}) byte-identical "
            f"to the in-process LMServer, p50 {_pct(lat, 50) * 1e3:.3f} ms, p99 "
            f"{_pct(lat, 99) * 1e3:.3f} ms; the stencil sweep beside it and /v1/route for "
            f"{len(router.cell_labels())} LM cell groups byte-identical [{smi}]")

    cfg = get_arch("llama3-8b")
    n = count_params(cfg)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base_mem = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    model = Model(cfg, generator=torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    params = list(model.parameters())
    nbytes = sum(q.numel() * q.element_size() for q in params)
    check(all(q.is_cuda and q.dtype == torch.bfloat16 for q in params), "llama3-8b in bf16 on the card")
    check(nbytes == 2 * n, f"llama3-8b tree bytes {nbytes} = 2 x count_params {n}")
    check(all(bool(torch.isfinite(q).all()) for q in params), "llama3-8b parameters finite")
    peak = torch.cuda.max_memory_allocated() - base_mem
    say(f"lm: llama3-8b parameter tree on the card: {len(params)} tensors, {n} parameters, "
        f"{nbytes} B = 2 x count_params (bf16); init {init_s:.3f} s (seeded torch.Generator); "
        f"torch.cuda.max_memory_allocated {peak} B above the {base_mem} B held before [{smi}]")
    del model, params
    torch.cuda.empty_cache()
    return {"lm_torch_cold_s": torch_s[0], "lm_torch_warm_s": torch_s[1], "lm_numpy_s": numpy_s,
            "docs_s": docs_s, "build_wall_s": build_wall, "portfolio_wall_s": pf_wall,
            "init_s": init_s}



def _moe_ample(cfg):
    import dataclasses

    return dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=64.0)) \
        if cfg.moe else cfg


def _serve_bounds(model, cfg, batch, prompt, steps):
    """Least times for the serve steps of a dense GQA model on this card:
    (prefill s, [decode s per step], resident bytes). Operations: 2 per
    multiply-add of every matrix the step applies (the head on the last
    position only at prefill), plus QK^T and PV over the causal pairs this
    run's data has in every layer, at the bf16 tensor-core peak. Bytes: every parameter
    read once, the embedding rows gathered, the K/V written (prefill) or
    the valid K/V read and one row written (decode), logits written, at
    the HBM peak. Each bound is the larger of the two."""
    layers = [p for p in model.stack.parameters() if p.dim() >= 2]
    n_mat = sum(p.numel() for p in layers)
    head = cfg.d_model * cfg.vocab
    isz = model.embed.element_size()
    h, kh, dh, nl = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_, cfg.n_layers
    w_bytes = sum(p.numel() for p in model.parameters() if p is not model.embed) * isz
    kv_row = 2 * nl * kh * dh * isz  # one token's K and V in every layer
    fl = 2 * n_mat * batch * prompt + 2 * head * batch + 4 * nl * batch * h * dh * prompt * (prompt + 1) / 2
    by = w_bytes + batch * prompt * cfg.d_model * isz + batch * prompt * kv_row + batch * cfg.vocab * isz
    prefill = max(fl / PEAK_BF16_FLOPS, by / PEAK_BYTES_PER_S)
    decode = []
    for j in range(1, steps):
        length = prompt + j  # valid cache entries after this step's write
        fl = 2 * (n_mat + head) * batch + 4 * nl * batch * h * dh * length
        by = w_bytes + batch * cfg.d_model * isz + batch * length * kv_row + batch * cfg.vocab * isz
        decode.append(max(fl / PEAK_BF16_FLOPS, by / PEAK_BYTES_PER_S))
    resident = sum(p.numel() for p in model.parameters()) * isz \
        + batch * (prompt + steps) * kv_row
    return prefill, decode, resident


def _decode_profile(model, cfg, batch, steps, device):
    """``torch.profiler`` over ``steps`` decode steps after a prefill:
    (device operations per step, device-busy microseconds per step -- the
    union of the device events' intervals), or None when the profiler
    records no device activity."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.serve import greedy, make_decode_step, make_prefill

    b, s = batch["tokens"].shape
    logits, caches = make_prefill(cfg, max_len=s + steps + 1, device=device)(model, batch)
    decode = make_decode_step(cfg)
    tok = greedy(logits)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for pos in range(s, s + steps):
            logits, caches = decode(model, tok[:, None], caches, pos)
            tok = greedy(logits)
        torch.cuda.synchronize()
    busy = _device_busy(prof)
    return None if busy is None else (busy[0] / steps, busy[1] / steps)


def _device_busy(prof):
    """(device operations, device-busy microseconds: the union of the
    device events' intervals) of a ``torch.profiler`` trace, or None when
    it recorded no device activity."""
    from torch.autograd import DeviceType

    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type == DeviceType.CUDA)
    if not spans:
        return None
    busy, end = 0.0, float("-inf")
    for a, z in spans:
        if z > end:
            busy += z - max(a, end)
            end = z
    return len(spans), busy


def phase10_serve(smi):
    """The LM forward passes and serve steps on the card: reduced models
    held card against CPU, the chunked attention against the plain one,
    and Llama-3-8B served at full width (see the module docstring)."""
    import copy
    import os
    import statistics

    import torch

    from repro_torch.configs import get_arch
    from repro_torch.launch.serve import prompt_batch
    from repro_torch.models import Model, forward
    from repro_torch.models.convert import tree_leaves
    from repro_torch.serve import generate_timed
    from repro_torch.kernels import _build
    from repro_torch.models.attention import CHUNKED_THRESHOLD, _core_path

    say("== phase 10: LM forward passes and serve steps on the card")
    card, cpu = torch.device("cuda"), torch.device("cpu")
    for name in PARITY_ARCHS:
        cfg = _moe_ample(get_arch(name).reduced())
        cpu_model = Model(cfg, device=cpu, generator=torch.Generator().manual_seed(0))
        card_model = copy.deepcopy(cpu_model).to(card)
        batch = prompt_batch(cfg, 2, 12, 0, cpu)
        on_cpu = generate_timed(cpu_model, cfg, batch, 5, device=cpu)
        on_card = generate_timed(card_model, cfg, {k: v.to(card) for k, v in batch.items()}, 5,
                              device=card)
        check(torch.equal(on_card["tokens"].cpu(), on_cpu["tokens"]), f"{name}: card tokens = CPU tokens")
        err = _assert_close(on_card["prefill_logits"].cpu(), on_cpu["prefill_logits"], 1e-4, 1e-4,
                            f"{name}: prefill logits card vs CPU")
        cache_err, n_leaves = 0.0, 0
        want = dict(tree_leaves(on_cpu["caches"]))
        for path, t in tree_leaves(on_card["caches"]):
            check(t.device.type == card.type and t.dtype == want[path].dtype,
                  f"{name}: cache {path} on the card")
            cache_err = max(cache_err, _assert_close(t.cpu(), want[path], 1e-4, 1e-4,
                                                     f"{name}: cache {path} card vs CPU"))
            n_leaves += 1
        check(n_leaves == len(want), f"{name}: the card's caches have the CPU's leaves")
        say(f"  parity {name} (reduced, f32): tokens {on_card['tokens'][0].tolist()} = CPU's; "
            f"prefill logits max |err| {err:.3g}; {n_leaves} cache leaves after prefill + 4 decode "
            f"steps, max |err| {cache_err:.3g}")

    cfg = get_arch("llama3-8b").reduced()
    model = Model(cfg, device=card, generator=torch.Generator(device=card).manual_seed(0))
    toks = torch.randint(0, cfg.vocab, (2, 2100), generator=torch.Generator().manual_seed(3),
                         dtype=torch.int32).to(card)
    with torch.inference_mode():
        plain, _, _ = forward(model, cfg, {"tokens": toks}, impl="plain")
        chunked, _, _ = forward(model, cfg, {"tokens": toks}, impl="chunked")
    err = _assert_close(chunked, plain, 1e-4, 1e-4, "chunked attention vs plain, S = 2100")
    say(f"  forward impl='chunked' vs 'plain', reduced llama3-8b, 2 x 2100 tokens (3 Q and 3 KV "
        f"blocks of 1024, padded): max |err| {err:.3g}")
    del model, plain, chunked

    cfg = get_arch("llama3-8b")
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base_mem = torch.cuda.memory_allocated()
    model = Model(cfg, device=card, generator=torch.Generator(device=card).manual_seed(0))  # phase 9's tree
    results = {}
    for label, b, s, steps in SERVE_CASES:
        check((s >= CHUNKED_THRESHOLD) == (label == "b"),
              f"case ({label}): only (b) reaches CHUNKED_THRESHOLD")
        q = torch.empty(b, s, cfg.n_heads, cfg.head_dim_, dtype=torch.bfloat16, device=card)
        kv = torch.empty(b, s, cfg.n_kv_heads, cfg.head_dim_, dtype=torch.bfloat16, device=card)
        check(_core_path(q, kv, kv, "auto") == "fused",
              f"case ({label}): the fused core takes the prefill")
        del q, kv
        batch = prompt_batch(cfg, b, s, 0, card)
        cold = generate_timed(model, cfg, batch, steps, device=card)
        cold = (cold["prefill_s"], statistics.median(cold["decode_s"]))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        r = generate_timed(model, cfg, batch, steps, device=card)
        peak = torch.cuda.max_memory_allocated() - base_mem
        seq = torch.cat([batch["tokens"], r["tokens"][:, :-1].to(batch["tokens"].dtype)], dim=1)
        with torch.inference_mode():
            ref, _, _ = forward(model, cfg, {"tokens": seq})
        ref = ref[:, s - 1:].float()  # predictions of generated tokens 1 .. steps
        scale = float(ref.abs().max())
        errs = {
            "prefill": float((r["prefill_logits"].float() - ref[:, 0]).abs().max()),
            "decode step 1": float((r["logits"][0].float() - ref[:, 1]).abs().max()),
            f"decode step {steps - 1}": float((r["logits"][-1].float() - ref[:, -1]).abs().max()),
        }
        agree = float((ref.argmax(dim=-1) == r["tokens"].long()).float().mean())
        check(all(torch.isfinite(t).all() for t in [r["prefill_logits"], *r["logits"]]),
              f"case ({label}): finite logits")
        b_pre, b_dec, resident = _serve_bounds(model, cfg, b, s, steps)
        dec = statistics.median(r["decode_s"])
        b_dec_med = statistics.median(b_dec)
        wall = r["prefill_s"] + sum(r["decode_s"])
        tps, tps_bound = b * steps / wall, b * steps / (b_pre + sum(b_dec))
        say(f"serve ({label}): llama3-8b {cfg.dtype}, {b} x {s} prompt + {steps - 1} greedy decode steps "
            f"(warm run; the cold one before it: prefill {cold[0] * 1e3:.3f} ms, decode "
            f"{cold[1] * 1e3:.3f} ms/step): prefill {r['prefill_s'] * 1e3:.3f} ms "
            f"(bound {b_pre * 1e3:.3f} ms, {100 * b_pre / r['prefill_s']:.1f}%); decode "
            f"{dec * 1e3:.3f} ms/step median of {len(r['decode_s'])} (min "
            f"{min(r['decode_s']) * 1e3:.3f}, max {max(r['decode_s']) * 1e3:.3f}; bound "
            f"{b_dec_med * 1e3:.3f} ms, {100 * b_dec_med / dec:.1f}%); {tps:.1f} tok/s (bound "
            f"{tps_bound:.1f}, {100 * tps / tps_bound:.1f}%); max_memory_allocated {peak} B above "
            f"the {base_mem} B held before (resident bound {resident} B, {100 * resident / peak:.1f}%) "
            f"[{smi}]")
        say(f"  logits vs a cacheless forward over prompt + generated tokens (scale max |logit| "
            f"{scale:.4f}): " + ", ".join(f"{k} max |err| {v:.4f} ({100 * v / scale:.2f}%)"
                                          for k, v in errs.items())
            + f"; greedy-token agreement {agree * 100:.1f}% of {b * steps} tokens "
              f"(reported, not required: bf16 near-ties may flip a token)")
        for k, v in errs.items():
            check(v <= LOGIT_RTOL * scale, f"case ({label}) {k}: max |err| {v} beyond "
                  f"{LOGIT_RTOL} x {scale}")
        prof = _decode_profile(model, cfg, batch, 4, card)
        if prof is None:
            say("  decode profile: not measured (torch.profiler recorded no device activity)")
        else:
            ops, busy_us = prof
            say(f"  decode profile (torch.profiler, 4 steps after a prefill): {ops:.1f} device "
                f"operations per step, device busy {busy_us / 1e3:.3f} ms per step = "
                f"{100 * busy_us / 1e3 / (dec * 1e3):.1f}% of the unprofiled median step "
                f"(device idle {100 - 100 * busy_us / 1e3 / (dec * 1e3):.1f}%)")
        results[label] = {"prefill_ms": r["prefill_s"] * 1e3, "decode_ms": dec * 1e3,
                          "tok_s": tps, "peak_B": peak, "agree": agree,
                          "tokens": r["tokens"].cpu()}
        del r, ref, seq

    # the chunked core at full width in bf16, which "auto" keeps for what the
    # fused core does not take at CHUNKED_THRESHOLD tokens or more (MLA, f32
    # models): case (b)'s prompt through impl="chunked", held against the
    # fused core's forward
    with torch.inference_mode():
        fused_logits, _, _ = forward(model, cfg, {"tokens": batch["tokens"]})
        torch.cuda.synchronize()
        before = _build.LAUNCHES["attn_fwd"]
        chunked_logits, _, _ = forward(model, cfg, {"tokens": batch["tokens"]}, impl="chunked")
        torch.cuda.synchronize()
    check(_build.LAUNCHES["attn_fwd"] == before, "impl='chunked' launched the fused attention")
    scale = float(fused_logits.float().abs().max())
    err = float((chunked_logits.float() - fused_logits.float()).abs().max())
    agree = float((chunked_logits.argmax(dim=-1) == fused_logits.argmax(dim=-1)).float().mean())
    say(f"  forward impl='chunked' vs the fused core, llama3-8b {cfg.dtype} at full width, "
        f"{tuple(batch['tokens'].shape)} tokens (8 Q and 8 KV blocks of 1024): logits max |err| "
        f"{err:.4f} ({100 * err / scale:.2f}% of max |logit| {scale:.4f}); argmax agreement "
        f"{100 * agree:.2f}%")
    check(bool(torch.isfinite(chunked_logits).all()), "chunked forward at 8192: finite logits")
    check(err <= LOGIT_RTOL * scale, f"chunked forward at 8192: max |err| {err} beyond "
          f"{LOGIT_RTOL} x {scale}")
    del model, fused_logits, chunked_logits, batch
    torch.cuda.empty_cache()

    label, b, s, steps = SERVE_CASES[0]
    env = dict(os.environ, PYTHONUNBUFFERED="1")
    env["PYTHONPATH"] = str(ROOT / "src") + os.pathsep + env.get("PYTHONPATH", "")
    args = ["--arch", "llama3-8b", "--requests", str(b), "--prompt-len", str(s), "--gen-len", str(steps)]
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, "-m", "repro_torch.launch.serve", *args],
                         capture_output=True, text=True, env=env, timeout=600)
    wall = time.perf_counter() - t0
    check(out.returncode == 0, f"launch.serve exited {out.returncode}: {out.stderr.strip()[-2000:]}")
    lines = out.stdout.strip().splitlines()
    check(len(lines) == 3 and lines[1].startswith("prefill "), f"launch.serve printed {lines}")
    say(f"serve child: python -m repro_torch.launch.serve {' '.join(args)} (cold, one run): "
        f"{lines[1]}; child wall {wall:.3f} s [{smi}]")
    return results


def _train_state_to(state, device):
    """A copy of a train state on ``device``."""
    import copy

    def move(tensors):
        return {k: v.to(device, copy=True) for k, v in tensors.items()}

    out = {"params": copy.deepcopy(state["params"]).to(device),
           "opt": {"m": move(state["opt"]["m"]), "v": move(state["opt"]["v"]),
                   "step": state["opt"]["step"].to(device, copy=True)}}
    if "comp" in state:
        out["comp"] = move(state["comp"])
    return out


def _train_bound(cfg, batch, seq):
    """Least time of one train step of a dense GQA model on this card:
    (seconds, what bounds it, operations, bytes). Operations: 6 per
    parameter of the products (every matrix but the embedding, whose rows
    are gathered) per token, plus QK^T and PV over the full S x S as the
    reference computes them, forward and backward (3 x 4 S^2 H d_h per
    layer and sequence), at the bf16 tensor-core peak; the recompute of
    remat is not counted. Bytes: the parameters and the f32 moments each
    read and written once, and the batch read, at the HBM peak."""
    import torch

    from repro_torch.models import count_params
    from repro_torch.models.layers import torch_dtype

    n = count_params(cfg)
    tokens = batch * seq
    ops = 6 * (n - cfg.vocab * cfg.d_model) * tokens \
        + 3 * cfg.n_layers * 4 * seq ** 2 * cfg.n_heads * cfg.head_dim_ * batch
    isz = torch.finfo(torch_dtype(cfg.dtype)).bits // 8
    by = 2 * (isz * n) + 2 * (2 * 4 * n) + 2 * 4 * tokens
    t_ops, t_by = ops / PEAK_BF16_FLOPS, by / PEAK_BYTES_PER_S
    return max(t_ops, t_by), ("operations" if t_ops >= t_by else "bytes"), ops, by


def _first_nondeterministic_op(fn):
    """Run ``fn`` twice under a dispatch mode that checksums every
    operation's output; the first operation whose outputs differ between
    the runs, or None."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode

    class Record(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.sums = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if isinstance(out, torch.Tensor) and out.is_floating_point():
                self.sums.append((str(func), out.double().sum().item()))
            return out

    runs = []
    for _ in range(2):
        with torch.no_grad(), Record() as r:
            fn()
        runs.append(r.sums)
    for (name, a), (_, b) in zip(*runs):
        if a != b:
            return name
    return None


def phase11_train(smi):
    """Training on the card: reduced archs held card against CPU, then
    InternLM2-1.8B trained at full width through a fault, a restore and a
    replay, and the ``launch.train`` CLI as a child (see the module
    docstring)."""
    import math
    import os
    import statistics
    import tempfile

    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import SHAPES, get_arch
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.data import DataConfig, make_batch
    from repro_torch.models import count_params
    from repro_torch.models.convert import reference_layout
    from repro_torch.models.layers import torch_dtype
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import Trainer, TrainerConfig, TrainConfig, init_train_state
    from repro_torch.train import make_train_step
    from repro_torch.train.train_step import _loss_fn

    say("== phase 11: training on the card")
    card, cpu = torch.device("cuda"), torch.device("cpu")
    tiny = ShapeSpec("tiny", 32, 4, "train")
    worst = {"metric": 0.0, "grad": 0.0}
    for name in PARITY_ARCHS:
        cfg = _moe_ample(get_arch(name).reduced())
        compress = name == TRAIN_COMPRESS_ARCH
        tcfg = TrainConfig(microbatches=2, remat="dots", compress_grads=compress)
        cpu_state = init_train_state(cfg, tcfg, device=cpu)
        card_state = _train_state_to(cpu_state, card)
        batch = make_batch(cfg, tiny, DataConfig(), 0, cpu)
        _, want = make_train_step(cfg, tcfg, device=cpu)(cpu_state, batch)
        _, got = make_train_step(cfg, tcfg)(card_state, {k: v.to(card) for k, v in batch.items()})
        check(set(got) == set(want), f"{name}: the card's metrics are the CPU's")
        m_err = max(abs(float(got[k]) - float(want[k])) / max(abs(float(want[k])), 1e-6)
                    for k in want)
        # m after the first step is (1 - b1) x the clipped gradient; compared
        # per reference leaf (a segment's layers share one int8 scale)
        g_err = 0.0
        for _, names, _ in reference_layout(cpu_state["params"]):
            err = max(float((card_state["opt"]["m"][k].cpu() - cpu_state["opt"]["m"][k])
                            .abs().max()) for k in names)
            top = max(float(cpu_state["opt"]["m"][k].abs().max()) for k in names)
            g_err = max(g_err, err / max(top, 1e-30))
        slack = 1 / 127 + 1e-4 if compress else 1e-4  # an int8 tie moves one bin
        check(m_err <= 1e-5, f"{name}: train-step metrics card vs CPU, max relative err {m_err}")
        check(g_err <= slack, f"{name}: gradients card vs CPU, max |err| / max |g| {g_err}")
        worst = {"metric": max(worst["metric"], m_err), "grad": max(worst["grad"], g_err)}
        say(f"  train parity {name} (reduced, f32, remat dots, 2 microbatches"
            f"{', int8 compression' if compress else ''}): loss {float(got['loss']):.6f} = CPU "
            f"{float(want['loss']):.6f}; metrics max relative err {m_err:.3g}; gradients max "
            f"|err| / max |g| per reference leaf {g_err:.3g} [{smi}]")
    say(f"  train parity, all six: metrics max relative err {worst['metric']:.3g}, gradients "
        f"{worst['grad']:.3g} [{smi}]")

    cfg = get_arch(TRAIN_ARCH)
    shape = SHAPES["train_4k"]
    bound_s, bound_by, ops, by = _train_bound(cfg, TRAIN_BATCH, shape.seq_len)
    tokens = TRAIN_BATCH * shape.seq_len
    n = count_params(cfg)
    resident = (torch.finfo(torch_dtype(cfg.dtype)).bits // 8) * n + 2 * 4 * n
    accum = 4 * n
    root = ROOT / "build"
    root.mkdir(exist_ok=True)
    ckpt_dir = tempfile.mkdtemp(prefix="train_ckpt_", dir=root)
    free = shutil.disk_usage(ckpt_dir).free
    say(f"train (b): checkpoints in {ckpt_dir}: {free} B free; a checkpoint is {resident} B "
        f"({cfg.dtype} params + f32 m and v), up to two on disk at once [{smi}]")
    check(free >= 2 * resident, f"{ckpt_dir} has {free} B free, less than two checkpoints "
          f"({2 * resident} B); phase 11 (b) does not run smaller")
    fired = []

    def fault(step):
        if step == TRAIN_FAULT_AT and not fired:
            fired.append(step)
            raise RuntimeError(f"injected fault at step {step}")

    tcfg = TrainConfig(microbatches=TRAIN_MICRO, remat="full",
                       opt=AdamWConfig(lr=TRAIN_LR, warmup_steps=2, total_steps=TRAIN_STEPS))
    run = TrainerConfig(steps=TRAIN_STEPS, ckpt_dir=ckpt_dir, ckpt_every=TRAIN_CKPT_EVERY, keep=1,
                        batch_override=TRAIN_BATCH)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base_mem = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    trainer = Trainer(cfg, shape, card, tcfg, run, DataConfig(), fault_hook=fault)
    t0 = time.perf_counter()
    out = trainer.train()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() - base_mem
    hist = out["metrics"]
    check(out["step"] == TRAIN_STEPS and out["failures"] == 1 and fired == [TRAIN_FAULT_AT],
          f"the run ended at step {out['step']} with {out['failures']} failures")
    order = [m["step"] for m in hist]
    replay_from = TRAIN_FAULT_AT - TRAIN_FAULT_AT % TRAIN_CKPT_EVERY
    want_order = list(range(TRAIN_FAULT_AT)) + list(range(replay_from, TRAIN_STEPS))
    check(order == want_order, f"steps run {order}, want {want_order}")
    first_pass = hist[replay_from]["lm_loss"]
    replayed = hist[TRAIN_FAULT_AT]["lm_loss"]
    if replayed == first_pass:
        replay_note = "bit for bit"
    else:
        state = out["state"]
        b = make_batch(cfg, shape, DataConfig(), replay_from, card, batch_override=TRAIN_BATCH)
        op = _first_nondeterministic_op(
            lambda: _loss_fn(state["params"], cfg, tcfg, {k: v[:2] for k, v in b.items()}, 8))
        replay_note = (f"differs by {abs(replayed - first_pass) / first_pass:.3g} relative; "
                       f"first nondeterministic operation: {op}")
        check(abs(replayed - first_pass) <= 1e-3 * abs(first_pass),
              f"replayed step {replay_from}: lm_loss {replayed} vs {first_pass}")
    ln_v = math.log(cfg.vocab)
    first, last = hist[0]["lm_loss"], hist[-1]["lm_loss"]
    check(abs(first - ln_v) <= 0.5, f"first lm_loss {first} is not within 0.5 of ln(V) {ln_v}")
    check(last < first, f"the loss did not fall: {first} -> {last}")
    for m in hist:
        check(all(math.isfinite(v) for v in m.values()), f"step {m['step']}: metrics not finite")
    times = trainer.step_times
    med = statistics.median(times)
    saves = trainer.checkpointer.saves
    check(all(s["bytes"] == resident + 4 for s in saves),
          f"checkpoint bytes {[s['bytes'] for s in saves]}, want {resident} + the 4-byte step")
    say(f"train (b): {cfg.name} {cfg.dtype} at full width ({n} parameters), train_4k sequence "
        f"{shape.seq_len}, global batch cut from {shape.global_batch} to {TRAIN_BATCH} in "
        f"{TRAIN_MICRO} microbatches, remat full, AdamW f32 moments (lr {TRAIN_LR}), "
        f"{TRAIN_STEPS} steps with a fault at step {TRAIN_FAULT_AT}: steps run {order}; "
        f"wall {wall:.3f} s [{smi}]")
    say(f"  lm_loss per step: " + ", ".join(f"{m['step']}: {m['lm_loss']:.4f}" for m in hist)
        + f"; first {first:.4f} vs ln(V) = {ln_v:.4f}; last {last:.4f}; replayed step "
          f"{replay_from}: {replayed:.6f} vs first pass {first_pass:.6f} ({replay_note}); "
          f"grad_norm first {hist[0]['grad_norm']:.4f}, last {hist[-1]['grad_norm']:.4f} [{smi}]")
    say(f"  step {med * 1e3:.3f} ms median of {len(times)} (min {min(times) * 1e3:.3f}, max "
        f"{max(times) * 1e3:.3f}); bound {bound_s * 1e3:.3f} ms ({bound_by}: {ops:.4g} "
        f"operations, {by:.4g} B), {100 * bound_s / med:.1f}% of it; with remat's recomputed "
        f"forward counted ({4 / 3 * bound_s * 1e3:.3f} ms) {100 * 4 / 3 * bound_s / med:.1f}%; "
        f"{tokens / med:.1f} tokens/s (bound {tokens / bound_s:.1f}) [{smi}]")
    say(f"  max_memory_allocated {peak} B above the {base_mem} B held before; resident state "
        f"{resident} B ({100 * resident / peak:.1f}% of the peak), {resident + accum} B with the "
        f"f32 accumulators of M > 1 ({100 * (resident + accum) / peak:.1f}%) [{smi}]")
    say(f"  checkpoints: " + "; ".join(
        f"step {s['step']}: {s['bytes']} B, snapshot {s['snapshot_s']:.3f} s (the loop's "
        f"stall), write {s.get('write_s', float('nan')):.3f} s" for s in saves)
        + f"; restore " + ", ".join(f"{r:.3f} s" for r in trainer.restore_seconds)
        + f" [{smi}]")

    state = out["state"]
    b0 = make_batch(cfg, shape, DataConfig(), 0, card, batch_override=TRAIN_BATCH)
    mb = TRAIN_BATCH // TRAIN_MICRO
    with torch.no_grad():
        again = float(_loss_fn(state["params"], cfg, tcfg,
                               {k: v[-mb:] for k, v in b0.items()}, 8)[1]["lm_loss"])
    say(f"  step 0's last microbatch after the run: lm_loss {again:.4f}, against {first:.4f} "
        f"when step 0 ran it (the step's metrics are its last microbatch's) [{smi}]")
    step_fn = make_train_step(cfg, tcfg)
    batch = make_batch(cfg, shape, DataConfig(), TRAIN_STEPS, card, batch_override=TRAIN_BATCH)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _, metrics = step_fn(state, batch)
        torch.cuda.synchronize()
    prof_s = time.perf_counter() - t0
    busy = _device_busy(prof)
    if busy is None:
        say(f"  train-step profile: not measured (torch.profiler recorded no device activity) "
            f"[{smi}]")
    else:
        n_ops, busy_us = busy
        say(f"  train-step profile (torch.profiler, one more step): {n_ops} device operations, "
            f"device busy {busy_us / 1e3:.3f} ms = {100 * busy_us / 1e6 / med:.1f}% of the "
            f"unprofiled median step (device idle {100 - 100 * busy_us / 1e6 / med:.1f}%); "
            f"profiled step {prof_s * 1e3:.3f} ms [{smi}]")
        def self_us(e):
            return getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0))

        top = sorted((e for e in prof.key_averages() if e.key.startswith("aten::")),
                     key=lambda e: -self_us(e))[:10]
        say("  device time by aten operation (self time of the kernels each launched): " + "; ".join(
            f"{e.key} {self_us(e) / 1e3:.3f} ms x {e.count}" for e in top) + f" [{smi}]")
    del state, out, trainer, batch, prof
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    torch.cuda.empty_cache()

    cli_dir = tempfile.mkdtemp(prefix="train_cli_", dir=root)
    env = dict(os.environ, PYTHONUNBUFFERED="1")
    env["PYTHONPATH"] = str(ROOT / "src") + os.pathsep + env.get("PYTHONPATH", "")
    args = ["--arch", TRAIN_ARCH, "--reduced", "--steps", "20", "--batch", "8", "--remat", "full",
            "--ckpt-dir", cli_dir]
    t0 = time.perf_counter()
    child = subprocess.run([sys.executable, "-m", "repro_torch.launch.train", *args],
                           capture_output=True, text=True, env=env, timeout=600)
    cli_wall = time.perf_counter() - t0
    shutil.rmtree(cli_dir, ignore_errors=True)
    check(child.returncode == 0, f"launch.train exited {child.returncode}: "
          f"{child.stderr.strip()[-2000:]}")
    lines = child.stdout.strip().splitlines()
    check(len(lines) == 2 and lines[1].startswith("finished step=20 failures=0"),
          f"launch.train printed {lines}")
    say(f"train child: python -m repro_torch.launch.train {' '.join(args[:-2])}: {lines[0]}; "
        f"{lines[1]}; child wall {cli_wall:.3f} s [{smi}]")
    return {"step_ms": med * 1e3, "tok_s": tokens / med, "peak_B": peak, "wall_s": wall,
            "cli_wall_s": cli_wall, "first_losses": [m["lm_loss"] for m in hist[:2]]}


def _free_port() -> int:
    import socket

    with socket.socket() as sk:
        sk.bind(("localhost", 0))
        return sk.getsockname()[1]


def _state_beyond(on_mesh, single, lr, rtol=2e-4, atol=2e-5):
    """(elements of ``on_mesh``'s state beyond rtol/atol of ``single``'s,
    elements in all, the largest excess of a parameter's move over a first
    AdamW step's 2 lr (1 + 0.1 |p|), the largest relative error of any
    other leaf beyond the tolerance)."""
    from repro_torch.models.convert import train_state_leaves
    from repro_torch.sharding.dtensor import full

    beyond = total = 0
    move = other = 0.0
    for (path, a, _), (_, b, _) in zip(train_state_leaves(on_mesh), train_state_leaves(single)):
        for ta, tb in zip(a, b):
            ta, tb = full(ta).detach().float(), tb.detach().float()
            err = (ta - tb).abs()
            out = err > atol + rtol * tb.abs()
            beyond, total = beyond + int(out.sum()), total + tb.numel()
            if not bool(out.any()):
                continue
            if path[0] == "params":
                move = max(move, float((err - 2 * lr * (1 + 0.1 * tb.abs()))[out].max()))
            else:
                other = max(other, float((err / tb.abs().clamp(min=1e-30))[out].max()))
    return beyond, total, move, other


def _heads_core_check(mesh, smi):
    """Phase 12 (e): the attention core's split over ``model`` on the card
    (``sharding.dtensor.local_heads``, through ``models.attention
    ._attend``) against the plain core on the same inputs, outputs and the
    gradients of q, k and v: q sharded along its heads with k and v whole
    (each rank slices the kv heads its q heads read; their gradients come
    back as partial sums over ``model``), and k and v sharded along their
    head dims, a cache's layout where the kv heads do not divide
    ``model`` (the scores summed over ``model``, no gather of k or v)."""
    import torch
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from repro_torch.models.attention import _attend
    from repro_torch.sharding.dtensor import full, mesh_device

    dev = mesh_device(mesh)
    g = torch.Generator(device=dev).manual_seed(0)
    b, s, h, kh, d = 2, 64, 8, 2, 32
    q, k, v = (torch.randn(b, s, n, d, generator=g, device=dev) for n in (h, kh, kh))
    pos = torch.arange(s, device=dev)[None].expand(b, s)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    want = _attend(*leaves, pos, pos, "causal", 0, "auto")
    want_g = torch.autograd.grad(want.square().sum(), leaves)
    for label, kv_pl in (("k, v whole", Replicate()), ("k, v head dims sharded", Shard(3))):
        placed = [distribute_tensor(t, mesh, [Replicate(), pl]).requires_grad_()
                  for t, pl in ((q, Shard(2)), (k, kv_pl), (v, kv_pl))]
        out = full(_attend(*placed, pos, pos, "causal", 0, "auto"))
        grads = [full(t) for t in torch.autograd.grad(out.square().sum(), placed)]
        err = max(float((a - c).abs().max()) for a, c in zip([out, *grads], [want, *want_g]))
        say(f"  attention core on the mesh, q heads sharded, {label} (B {b}, S {s}, {h} q / "
            f"{kh} kv heads, f32): output and q/k/v gradients max |err| {err:.3g} against "
            f"the plain core [{smi}]")
        check(err <= 1e-6, f"attention core on the mesh ({label}): max |err| {err}")


def _phase12_sharded_paths(mesh, smi):
    """Phase 12 (e): train steps and serving on the one-rank mesh with
    ``Shard`` kept on its size-1 axes, against one device of the mesh's
    type; then the same for a GQA arch as if the axes were 4 wide (its 2
    kv heads do not divide that, so its caches shard their head dims over
    ``model``), and the attention core's split alone."""
    import torch
    from torch.distributed.tensor import DTensor, Replicate, Shard

    from repro_torch.configs import get_arch
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.data import DataConfig, make_batch
    from repro_torch.launch.mesh import MeshShape
    from repro_torch.launch.serve import prompt_batch
    from repro_torch.models import Model
    from repro_torch.models import model as model_mod
    from repro_torch.serve import generate_timed
    from repro_torch.sharding import dtensor, partition
    from repro_torch.train import TrainConfig, init_train_state, make_train_step

    tiny = ShapeSpec("tiny", 32, 4, "train")
    dev = torch.device(mesh.device_type)

    def keep_shards(width):  # as if every axis were ``width`` wide: size-1 axes shard too
        return lambda spec, m: partition.to_placements(
            spec, MeshShape(m.mesh_dim_names, (width,) * m.ndim))

    def step(name, width):
        cfg = _moe_ample(get_arch(name).reduced())
        tcfg = TrainConfig(microbatches=2, remat="dots", fsdp=True)
        single = init_train_state(cfg, tcfg, device=dev)
        on_mesh = init_train_state(cfg, tcfg, mesh)
        params = list(on_mesh["params"].parameters())
        n_shard = sum(any(isinstance(p, Shard) for p in t.placements) for t in params
                      if isinstance(t, DTensor))
        check(n_shard > 0, f"{name}: no parameter is sharded on the size-1 axes")
        batch = make_batch(cfg, tiny, DataConfig(), 0, dev)
        _, want = make_train_step(cfg, tcfg, dev)(single, batch)
        _, got = make_train_step(cfg, tcfg, mesh)(on_mesh, batch)
        m_err = max(abs(float(got[k]) - float(want[k])) / max(abs(float(want[k])), 1e-6)
                    for k in want)
        beyond, total, move, other = _state_beyond(on_mesh, single, float(want["lr"]))
        say(f"  sharded step {name} (reduced, f32, fsdp, 2 microbatches, axes as if {width} "
            f"wide, {n_shard} of {len(params)} parameters sharded): loss "
            f"{float(got['loss']):.6f} vs single-device {float(want['loss']):.6f}; metrics max "
            f"relative err {m_err:.3g}; {beyond} of {total} state elements beyond rtol 2e-4 / "
            f"atol 2e-5 (params: largest excess over 2 lr {move:.3g}; other leaves: largest "
            f"relative err {other:.3g}) [{smi}]")
        check(m_err <= 1e-5, f"{name}: sharded step metrics, max relative err {m_err}")
        check(beyond <= 1e-3 * total and move <= 2e-5 and other == 0.0,
              f"{name}: sharded step state: {beyond} of {total} beyond, excess {move}, "
              f"other {other}")

    def serve(name, width):
        cfg = _moe_ample(get_arch(name).reduced())
        batch = prompt_batch(cfg, 2, 12, 0, dev)
        want = generate_timed(Model(cfg, device=dev), cfg, batch, 4, device=dev)
        got = generate_timed(Model(cfg, device=dev), cfg, batch, 4, mesh=mesh)
        k_pl = [tuple(layer["mixer"]["k"].placements) for layer in got["caches"]["stack"]
                if layer is not None and "k" in layer.get("mixer", {})]
        same = torch.equal(got["tokens"], want["tokens"])
        l_err = max(float((g - w).abs().max()) for g, w in
                    zip([got["prefill_logits"], *got["logits"]],
                        [want["prefill_logits"], *want["logits"]]))
        say(f"  sharded serve {name} (reduced, f32, 2 x 12 prompt + 3 decode steps, axes as "
            f"if {width} wide, k cache {k_pl[0] if k_pl else 'none'}): tokens "
            f"{'identical to' if same else 'differ from'} the single-device serve's; logits "
            f"max |err| {l_err:.3g} [{smi}]")
        check(same and l_err <= 1e-4, f"{name}: sharded serve differs from one device")
        return k_pl

    # the position ids of every stack call on the mesh: made in the
    # tokens' layout (rows over data, replicated over model), never plain
    ids, stack_apply = [], model_mod.stack_apply

    def recording(stack, cfg, x, *, positions, **kw):
        if isinstance(x, DTensor):
            ids.append(str(tuple(positions.placements)) if isinstance(positions, DTensor)
                       else "plain")
        return stack_apply(stack, cfg, x, positions=positions, **kw)

    sizes = partition.mesh_sizes
    try:
        dtensor.to_placements = keep_shards(2)
        model_mod.stack_apply = recording
        for name in PARITY_ARCHS:
            step(name, 2)
        for name in ("llama3-8b", "mixtral-8x22b", "whisper-medium", "qwen2-vl-2b"):
            serve(name, 2)
        model_mod.stack_apply = stack_apply
        rows = str((Shard(0), Replicate()))
        say(f"  position ids of {len(ids)} stack calls (the six steps, four serves): "
            f"{sorted(set(ids))}, the tokens' rows layout {rows} [{smi}]")
        check(bool(ids) and set(ids) == {rows}, f"position ids placed {sorted(set(ids))}, "
              f"not as the tokens' rows {rows}")
        dtensor.to_placements = partition.to_placements
        # GQA: the rules choose every spec as if the axes were 4 wide, so
        # the 2 kv heads do not divide ``model``: the decode steps read a
        # cache whose head dims are sharded over it
        partition.mesh_sizes = lambda m: {a: 4 for a in sizes(m)}
        step("internlm2-1.8b", 4)
        k_pl = serve("llama3-8b", 4)
        check(bool(k_pl) and all(pl[1] == Shard(3) for pl in k_pl),
              f"llama3-8b as if 4 wide: the k caches are {k_pl}, not head dims over model")
    finally:
        dtensor.to_placements = partition.to_placements
        partition.mesh_sizes = sizes
        model_mod.stack_apply = stack_apply
    _heads_core_check(mesh, smi)


def phase12_multi_device(smi, analytic, sweep_s, serve, train):
    """The multi-device half of the port on the one card: the sharded
    sweep, then one NCCL rank on a 1 x 1 mesh (see the module docstring)."""
    import statistics

    import numpy as np
    import torch
    import torch.distributed as dist

    from repro_torch.configs import SHAPES, get_arch
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.core.codesign import _stencil_groups, codesign
    from repro_torch.core.sweep import clear_caches, sweep_cells_sharded
    from repro_torch.data import DataConfig, make_batch
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.serve import prompt_batch
    from repro_torch.models import Model
    from repro_torch.models.convert import train_state_leaves
    from repro_torch.optim import AdamWConfig, compressed_psum, dequantize_int8, quantize_int8
    from repro_torch.serve import generate_timed
    from repro_torch.sharding.dtensor import full
    from repro_torch.train import TrainConfig, init_train_state, make_train_step

    say("== phase 12: multi-device on one card (one rank)")
    wl, hw = analytic.workload, analytic.hw
    groups = _stencil_groups(wl).values()
    for devices in (1, ["cuda:0"] * 4):
        clear_caches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for st, cis, sizes in groups:
            t, i = sweep_cells_sharded(st, analytic.gpu, sizes, hw.n_sm, hw.n_v, hw.m_sm,
                                       analytic.lattices[cis[0]], devices=devices)
            check(np.array_equal(t, analytic.cell_time[cis])
                  and np.array_equal(i, analytic.cell_tile_idx[cis]),
                  f"sharded sweep devices={devices}: {st.name} differs from phase 3")
        dt = time.perf_counter() - t0
        say(f"sharded sweep devices={devices}: {len(hw)} hardware points x {len(wl.cells)} cells "
            f"in {dt:.3f} s (first call after clear_caches), bit for bit phase 3's matrix "
            f"(phase 3's torch engine: {sweep_s:.3f} s, first call) [{smi}]")
    t0 = time.perf_counter()
    res = codesign(wl, hw=hw, engine="sharded", devices=1)
    dt = time.perf_counter() - t0
    check(np.array_equal(res.cell_time, analytic.cell_time)
          and np.array_equal(res.cell_tile_idx, analytic.cell_tile_idx),
          "codesign(engine='sharded', devices=1) differs from phase 3")
    check(res.best() == analytic.best(), "the sharded best point is phase 3's")
    i, g = res.best()
    say(f"codesign(engine='sharded', devices=1): {dt:.3f} s; best point {i} ({g:.1f} GFLOP/s "
        f"predicted) = phase 3's [{smi}]")

    torch.cuda.set_device(0)
    port = _free_port()
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}", rank=0, world_size=1)
    try:
        mesh = make_mesh((1, 1), ("data", "model"), device_type="cuda")
        say(f"NCCL process group (1 rank, tcp://localhost:{port}); mesh {mesh}")
        x = torch.randn(4096, 1024, generator=torch.Generator(device="cuda").manual_seed(5),
                        device="cuda") * 3.0
        got = compressed_psum(x, mesh.get_group("data"))
        want = dequantize_int8(*quantize_int8(x))
        check(torch.equal(got, want), "compressed_psum on one rank = quantize -> dequantize")
        say(f"compressed_psum over the data dim's NCCL group: 4096 x 1024 f32 equal bit for bit "
            f"to quantize -> dequantize (max |x| {float(x.abs().max()):.4f}) [{smi}]")

        tiny = ShapeSpec("tiny", 32, 4, "train")
        worst = {"metric": 0.0, "state": 0.0}
        for name in PARITY_ARCHS:
            cfg = _moe_ample(get_arch(name).reduced())
            compress = name == TRAIN_COMPRESS_ARCH
            tcfg = TrainConfig(microbatches=2, remat="dots", compress_grads=compress)
            single = init_train_state(cfg, tcfg, device="cuda")
            on_mesh = init_train_state(cfg, tcfg, mesh)
            batch = make_batch(cfg, tiny, DataConfig(), 0, "cuda")
            _, want = make_train_step(cfg, tcfg, "cuda")(single, batch)
            t0 = time.perf_counter()
            _, got = make_train_step(cfg, tcfg, mesh)(on_mesh, batch)
            torch.cuda.synchronize()
            step_s = time.perf_counter() - t0
            check(set(got) == set(want), f"{name}: the mesh step's metrics are the device's")
            m_err = max(abs(float(got[k]) - float(want[k])) / max(abs(float(want[k])), 1e-6)
                        for k in want)
            s_err = 0.0
            for (path, a, _), (_, b, _) in zip(train_state_leaves(on_mesh),
                                               train_state_leaves(single)):
                for ta, tb in zip(a, b):
                    ta, tb = full(ta).detach().float(), tb.detach().float()
                    scale = max(float(tb.abs().max()), 1e-30)
                    s_err = max(s_err, float((ta - tb).abs().max()) / scale)
            check(m_err <= 1e-6, f"{name}: mesh step metrics, max relative err {m_err}")
            check(s_err <= 1e-6, f"{name}: mesh step state, max |err| / max |leaf| {s_err}")
            worst = {"metric": max(worst["metric"], m_err), "state": max(worst["state"], s_err)}
            say(f"  mesh step {name} (reduced, f32, remat dots, 2 microbatches"
                f"{', int8 compression' if compress else ''}): loss {float(got['loss']):.6f} = "
                f"single-device {float(want['loss']):.6f}; metrics max relative err {m_err:.3g}; "
                f"state max |err| / max |leaf| {s_err:.3g}; mesh step {step_s * 1e3:.1f} ms "
                f"(first call) [{smi}]")
            del single, on_mesh
        say(f"  mesh steps, all six: metrics max relative err {worst['metric']:.3g}, state "
            f"{worst['state']:.3g} [{smi}]")

        cfg = get_arch(TRAIN_ARCH)
        shape = SHAPES["train_4k"]
        tcfg = TrainConfig(microbatches=TRAIN_MICRO, remat="full",
                           opt=AdamWConfig(lr=TRAIN_LR, warmup_steps=2, total_steps=TRAIN_STEPS))
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        base_mem = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        state = init_train_state(cfg, tcfg, mesh)
        step_fn = make_train_step(cfg, tcfg, mesh)
        losses, times = [], []
        for step in range(2):
            batch = make_batch(cfg, shape, DataConfig(), step, batch_override=TRAIN_BATCH, mesh=mesh)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, metrics = step_fn(state, batch)
            losses.append(float(metrics["lm_loss"]))
            times.append(time.perf_counter() - t0)
        peak = torch.cuda.max_memory_allocated() - base_mem
        del state, batch
        torch.cuda.empty_cache()
        diff = max(abs(a - b) for a, b in zip(losses, train["first_losses"]))
        bound_s = _train_bound(cfg, TRAIN_BATCH, shape.seq_len)[0]
        say(f"mesh train: {cfg.name} {cfg.dtype} at full width on the 1 x 1 mesh, "
            f"{TRAIN_BATCH} x {shape.seq_len} tokens in {TRAIN_MICRO} microbatches, remat full: "
            f"lm_loss {losses} vs phase 11's first two {train['first_losses']} (max |diff| "
            f"{diff:.3g}{', bit for bit' if diff == 0 else ''}); step ms {times[0] * 1e3:.3f} "
            f"(first), {times[1] * 1e3:.3f} (second) against phase 11's median "
            f"{train['step_ms']:.3f}; second step {100 * bound_s / times[1]:.1f}% of the "
            f"{bound_s * 1e3:.3f} ms bound; max_memory_allocated {peak} B above the {base_mem} B "
            f"held before [{smi}]")
        check(all(np.isfinite(losses)), "mesh train: finite losses")
        check(diff <= 1e-6, f"mesh train lm_loss {losses} vs phase 11's {train['first_losses']}")

        cfg = get_arch("llama3-8b")
        label, b, s, steps = SERVE_CASES[0]
        model = Model(cfg, device="cuda", generator=torch.Generator(device="cuda").manual_seed(0))
        batch = prompt_batch(cfg, b, s, 0, torch.device("cuda"))
        generate_timed(model, cfg, batch, steps, mesh=mesh)  # cold: places the model
        r = generate_timed(model, cfg, batch, steps, mesh=mesh)
        dec = statistics.median(r["decode_s"])
        want = serve[label]["tokens"]
        same = torch.equal(r["tokens"].cpu(), want)
        say(f"mesh serve: llama3-8b bf16 on the 1 x 1 mesh, {b} x {s} prompt + {steps - 1} "
            f"decode steps (warm run): prefill {r['prefill_s'] * 1e3:.3f} ms, decode "
            f"{dec * 1e3:.3f} ms/step against phase 10 (a)'s {serve[label]['decode_ms']:.3f}; "
            f"tokens {'identical to' if same else 'differ from'} phase 10's [{smi}]")
        check(same, "mesh serve tokens = phase 10 (a)'s")
        del model, r
        torch.cuda.empty_cache()
        _phase12_sharded_paths(mesh, smi)
    finally:
        dist.destroy_process_group()
    return {"sweep_sharded_s": dt, "train_ms": times[1] * 1e3, "decode_ms": dec * 1e3}


#: phase 13 (a): dry-run cells at the production meshes' full width, each
#: ``python -m repro_torch.launch.dryrun`` child's arguments (the train
#: cell on the 256-rank mesh only: with the 512-rank one too the phase took
#: 192 s, past its ~150 s share; the whole grid runs apart, ``PERF.md``)
DRYRUN_CELLS = (
    ("--arch", "internlm2-1.8b", "--shape", "train_4k", "--mesh", "single"),
    ("--arch", "mamba2-780m", "--shape", "long_500k", "--mesh", "single"),
    ("--arch", "llama3-8b", "--shape", "long_500k", "--mesh", "single"),
)

#: phase 13 (b): ``lower_cell``/``analyze`` on a 1-rank fake mesh at the
#: shapes phases 10 (a) and 11 (b) measure; prints one JSON line
_DRYRUN_CHILD = r"""
import json, sys
from repro_torch.configs import get_arch
from repro_torch.configs.base import ShapeSpec
from repro_torch.launch.dryrun import analyze, fake_mesh, lower_cell
from repro_torch.launch.opanalysis import argument_bytes
from repro_torch.launch.roofline import roofline_terms

mesh = fake_mesh((1, 1), ("data", "model"), "cuda")
out = {}
for key, arch, shape, plan in (
    ("train", "internlm2-1.8b", ShapeSpec("phase11b", 4096, 8, "train"),
     {"fsdp": False, "microbatches": 4, "remat": "full", "attn_impl": "auto"}),
    ("decode", "llama3-8b", ShapeSpec("phase10a", 545, 4, "decode"),
     {"fsdp": False, "microbatches": 1, "remat": "full", "attn_impl": "auto"}),
):
    low = lower_cell(get_arch(arch), shape, mesh, plan)
    rec = analyze(low)
    rec["state_bytes"] = argument_bytes(low.args[0]) if key == "decode" else \
        argument_bytes([low.args[0]["params"], low.args[0]["opt"]["m"], low.args[0]["opt"]["v"]])
    rec["roofline"] = roofline_terms(rec)
    out[key] = rec
print(json.dumps(out))
"""


def _dryrun_line(rec, smi):
    """One phase-13 line of a dry-run record (predictions, not measurements)."""
    from repro_torch.launch.roofline import roofline_terms

    if rec.get("skipped"):
        return f"{rec['mesh']}/{rec['arch']}/{rec['shape']}: skipped ({rec['reason']})"
    mem = rec["memory"]
    colls = ", ".join(f"{k} {v['bytes']:.4g} B ({v['count']:.0f})"
                      for k, v in sorted(rec["collectives"].items())) or "none"
    terms = roofline_terms(rec)
    return (f"{rec['mesh']}/{rec['arch']}/{rec['shape']} on {rec['chips']} fake ranks: plan "
            f"{rec['plan']}; trace {rec['trace_s']} s (build {rec['lower_s']} s); per chip "
            f"dot_flops_expanded {rec['dot_flops_expanded']:.4g}, collectives {colls}; argument "
            f"{mem['argument_size_in_bytes']} B + temp {mem['temp_size_in_bytes']} B; roofline "
            f"compute {terms['compute_s']:.4g} s, memory {terms['memory_s']:.4g} s, collective "
            f"{terms['collective_s']:.4g} s: {terms['dominant']} dominates (H100 constants "
            f"beside a card reading [{smi}])")


def phase13_dryrun(smi, serve, train):
    """The launch analysis on the card host: (a) the dry run over fake
    256/512-rank meshes at full width and the roofline over its records,
    as children; (b) ``lower_cell``/``analyze`` on a 1-rank fake mesh at
    phases 10 (a) and 11 (b)'s shapes, held against their measurements.
    Every dry-run number is a prediction."""
    import os

    import torch

    from repro_torch.configs import SHAPES, get_arch
    from repro_torch.models import Model, count_params
    from repro_torch.models.layers import torch_dtype

    say("== phase 13: launch analysis (dry run, op trace, roofline; predictions)")

    out = ROOT / "build" / "dryrun_smoke"
    shutil.rmtree(out, ignore_errors=True)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), PYTHONUNBUFFERED="1")
    t_phase = time.perf_counter()
    for args in DRYRUN_CELLS:
        t0 = time.perf_counter()
        child = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun", *args,
                                "--out", str(out), "--force"], cwd=ROOT, env=env,
                               capture_output=True, text=True, timeout=600)
        check(child.returncode == 0, f"dryrun {' '.join(args)} exited {child.returncode}: "
              f"{child.stdout[-2000:]}{child.stderr[-3000:]}")
        say(f"dryrun {' '.join(args)}: child wall {time.perf_counter() - t0:.1f} s; "
            + "; ".join(line for line in child.stdout.splitlines() if line.startswith("[")))
    recs = [json.loads(p.read_text()) for p in sorted(out.glob("*/*.json"))]
    check(len(recs) == len(DRYRUN_CELLS), f"{len(recs)} dry-run records, want {len(DRYRUN_CELLS)}")
    for rec in recs:
        check("error" not in rec, f"dry-run cell {rec['mesh']}/{rec['arch']}/{rec['shape']}: "
              f"{rec.get('error')}")
        say("  " + _dryrun_line(rec, smi))
        if (rec["arch"], rec["shape"]) == ("internlm2-1.8b", "train_4k"):
            # full remat runs the forward twice: 4/3 of 6ND, split over the chips;
            # the causal S^2 attention comes on top, split over ``model`` too
            dot = rec["dot_flops_expanded"]
            ideal = 6 * rec["params"] * SHAPES["train_4k"].tokens * 4 / 3 / rec["chips"]
            say(f"  {rec['mesh']}/internlm2-1.8b/train_4k per chip: dot_flops_expanded "
                f"{dot:.4g} beside 6ND x 4/3 / {rec['chips']} = {ideal:.4g} (ratio "
                f"{dot / ideal:.4f}; at most 9e13 with each model rank's share of the heads)")
            check(dot <= 9e13, f"internlm2-1.8b train_4k: {dot:.4g} dot FLOPs per chip, over "
                  "9e13: the attention is not split over model")
        if rec["arch"] == "llama3-8b":
            check(rec["skipped"] and "quadratic" in rec["reason"], "llama3-8b long_500k skips")
            continue
        mem = rec["memory"]
        held = mem["argument_size_in_bytes"] + mem["temp_size_in_bytes"]
        check(held < 80e9, f"{rec['mesh']}/{rec['arch']}/{rec['shape']}: argument + temp "
              f"{held} B, not under the card's 80e9 B")
    child = subprocess.run([sys.executable, "-m", "repro_torch.launch.roofline", "--out",
                            str(out), "--mesh", "single"], cwd=ROOT, env=env,
                           capture_output=True, text=True, timeout=300)
    check(child.returncode == 0, f"roofline exited {child.returncode}: {child.stderr[-3000:]}")
    say("roofline --mesh single (predictions, H100 SXM constants):\n" + child.stdout.strip())
    say(f"dryrun (a): {time.perf_counter() - t_phase:.1f} s")

    t0 = time.perf_counter()
    child = subprocess.run([sys.executable, "-c", _DRYRUN_CHILD], cwd=ROOT, env=env,
                           capture_output=True, text=True, timeout=600)
    check(child.returncode == 0, f"phase 13 (b) child exited {child.returncode}: "
          f"{child.stderr[-3000:]}")
    got = json.loads(child.stdout.strip().splitlines()[-1])
    say(f"dryrun (b): child wall {time.perf_counter() - t0:.1f} s")

    def pair(what, predicted, measured, unit):
        say(f"  {what}: predicted {predicted:.6g} {unit} against {measured:.6g} {unit}, ratio "
            f"{predicted / measured:.4f} [{smi}]")

    tr = got["train"]
    cfg = get_arch(TRAIN_ARCH)
    n = count_params(cfg)
    resident = (torch.finfo(torch_dtype(cfg.dtype)).bits // 8) * n + 2 * 4 * n
    _, _, ops, _ = _train_bound(cfg, TRAIN_BATCH, 4096)
    say(f"dryrun (b) train: {TRAIN_ARCH} bf16, {TRAIN_BATCH} x 4096, M = {TRAIN_MICRO}, remat "
        f"full, 1-rank fake mesh; trace {tr['trace_s']} s")
    pair("dot_flops_expanded vs _train_bound's operations (no remat)", tr["dot_flops_expanded"],
         ops, "FLOP")
    arg = tr["memory"]["argument_size_in_bytes"]
    say(f"  state argument bytes {tr['state_bytes']} against phase 11's resident {resident}; "
        f"the rest of the arguments {arg - tr['state_bytes']} B (batch 2 x {TRAIN_BATCH} x 4096 "
        f"int32 = {2 * TRAIN_BATCH * 4096 * 4} B + the 4-byte step)")
    check(tr["state_bytes"] == resident, "the train state's argument bytes = phase 11's resident")
    pair("argument + temp (the trace's peak) vs phase 11's max_memory_allocated",
         arg + tr["memory"]["temp_size_in_bytes"], train["peak_B"], "B")
    rt = tr["roofline"]
    say(f"  roofline: compute {rt['compute_s'] * 1e3:.3f} ms, memory {rt['memory_s'] * 1e3:.3f} "
        f"ms, collective {rt['collective_s'] * 1e3:.3f} ms ({rt['dominant']})")
    pair("roofline bound vs phase 11's median step", rt["bound_s"] * 1e3, train["step_ms"], "ms")
    dc = got["decode"]
    label, b, s, steps = SERVE_CASES[0]
    lcfg = get_arch("llama3-8b")
    _, b_dec, _ = _serve_bounds(Model(lcfg, device="meta"), lcfg, b, s, steps)
    rd = dc["roofline"]
    say(f"dryrun (b) decode: llama3-8b bf16, {b} x {s} + one token against a {s + steps}-slot "
        f"cache, 1-rank fake mesh; trace {dc['trace_s']} s; roofline compute "
        f"{rd['compute_s'] * 1e3:.4f} ms, memory {rd['memory_s'] * 1e3:.4f} ms ({rd['dominant']})")
    pair("roofline bound vs _serve_bounds' decode bound (median)", rd["bound_s"] * 1e3,
         sorted(b_dec)[len(b_dec) // 2] * 1e3, "ms")
    pair("roofline bound vs phase 10 (a)'s decode ms/step", rd["bound_s"] * 1e3,
         serve[label]["decode_ms"], "ms")
    wall = time.perf_counter() - t_phase
    say(f"phase 13: {wall:.1f} s")
    return {"wall_s": wall, "records": len(recs)}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"chip_smoke: no src/repro_torch beside {Path(__file__).name}", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    t_start = time.perf_counter()
    card, smi = phase0_device()
    phase1_build()
    from repro_torch.kernels import _build

    errs = {k: 0.0 for k in _build.STENCIL_LAUNCHES}
    phase2_compare(errs)
    torch.cuda.synchronize()

    _build.reset_launches()  # the main path starts here
    analytic, sweep_s = phase3_codesign()
    torch.cuda.synchronize()
    phase4_codesigned_tiles()
    torch.cuda.synchronize()
    measure_s, fit_s, cal_s = phase5_measure_fit()
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)  # the main path ends here
    say(f"main path launches: {launches}")
    for kernel in _build.STENCIL_LAUNCHES:
        check(launches[kernel] > 0, f"{kernel} was not launched on the main path")

    kernels = phase6_times(launches, errs)
    torch.cuda.synchronize()
    _build.reset_launches()
    kernels.update(phase6_attention())
    torch.cuda.synchronize()

    def stencil_free(path, attention=()):
        got = dict(_build.LAUNCHES)
        say(f"{path} path launches: {got} (no stencil kernel lies on this path)")
        check(not any(got[k] for k in _build.STENCIL_LAUNCHES),
              f"a stencil kernel was launched on the {path} path")
        for k in attention:
            check(got[k] > 0, f"{k} was not launched on the {path} path")
            kernels[k]["launches"] += got[k]
            kernels[k]["launches_by_path"][path] = got[k]

    _build.reset_launches()  # the served path starts here
    build_s = phase7_served(analytic, smi)
    torch.cuda.synchronize()
    served_launches = dict(_build.LAUNCHES)  # the served path ends here
    say(f"served path launches: {served_launches}")
    for kernel in ("tiled2d", "tiled3d"):
        check(served_launches[kernel] > 0, f"{kernel} was not launched on the served path")
    for kernel, row in kernels.items():
        row["launches"] += served_launches[kernel]

    gateway_build_s = phase8_gateway(smi)  # launches no stencil kernel (see phase 8)

    _build.reset_launches()  # the LM path starts here
    lm_s = phase9_lm(smi)
    torch.cuda.synchronize()
    stencil_free("LM")

    _build.reset_launches()  # the serve path starts here
    serve = phase10_serve(smi)
    torch.cuda.synchronize()
    stencil_free("serve", attention=("attn_fwd",))

    _build.reset_launches()  # the train path starts here
    train = phase11_train(smi)
    torch.cuda.synchronize()
    stencil_free("train", attention=("attn_fwd", "attn_bwd"))

    _build.reset_launches()  # the multi-device path starts here
    multi = phase12_multi_device(smi, analytic, sweep_s, serve, train)
    torch.cuda.synchronize()
    stencil_free("multi-device", attention=("attn_fwd", "attn_bwd"))
    _build.reset_launches()  # the launch-analysis path starts here
    dry = phase13_dryrun(smi, serve, train)
    torch.cuda.synchronize()
    stencil_free("launch-analysis")
    say(f"seconds: sweep {sweep_s:.3f}, measure {measure_s:.2f}, fit {fit_s:.2f}, "
        f"calibrated codesign {cal_s:.3f}, served build {build_s:.3f}, gateway builds "
        + ", ".join(f"{g} {t:.3f}" for g, t in gateway_build_s.items())
        + ", LM " + ", ".join(f"{k} {v:.3f}" for k, v in lm_s.items())
        + ", serve " + ", ".join(f"({c}) prefill {v['prefill_ms'] / 1e3:.3f} decode/step "
                                 f"{v['decode_ms'] / 1e3:.4f}" for c, v in serve.items())
        + f", train step {train['step_ms'] / 1e3:.3f} (run {train['wall_s']:.3f}, child "
          f"{train['cli_wall_s']:.3f})"
        + f", mesh: sharded codesign {multi['sweep_sharded_s']:.3f}, train step "
          f"{multi['train_ms'] / 1e3:.3f}, decode/step {multi['decode_ms'] / 1e3:.4f}"
        + f", dry run {dry['wall_s']:.1f}"
        + f", total {time.perf_counter() - t_start:.1f}")
    print(json.dumps({"kernels": list(kernels.values())}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": card,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
