#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path once on an NVIDIA GPU.

    python3 chip_smoke.py        # from the root of a checkout; needs one card

The main path is the paper's loop, at its full width: the eq.-18 sweep over
all 5,121 hardware points x 96 cells on the card, the codesign best point,
the stencils run at the codesigned tiles by the hand-written kernels, the
measurement grid timed on the card, the machine parameters refitted, and
the sweep again on the calibrated machine. Phases:

0. device facts (exits non-zero without a card);
1. build the CUDA kernels from ``src/repro_torch/kernels/csrc`` with nvcc;
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
7. the served path, in a temporary artifact store: ``repro_torch.measure
   .cli`` ``run --full`` (K1/K2 on the card), ``fit``, ``build --engine
   torch`` at full width; the calibrated sweep served by
   ``server_from_artifact`` to 64 seeded mixes from threads (microbatched)
   and one at a time; a ``CodesignServer`` at the stock GTX-980 spec whose
   miss path sweeps on the card, and a second server over the same store
   that answers warm with phase 3's best point.

The launch counters are set to 0 just before phase 3 and read just after
phase 5, and again just before and after phase 7: every kernel must have
been launched on the main path, and K1/K2 on the served path. A failed
check raises; nothing is caught. The last three lines are a JSON object of
per-kernel numbers (launches: main path plus served path), the card's name
and power limit as ``nvidia-smi`` gives them, and the device record.
"""

from __future__ import annotations

import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

#: H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s, f32 FLOP/s outside the
#: tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12

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

    errs = {k: 0.0 for k in _build.LAUNCHES}
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
    for kernel, n in launches.items():
        check(n > 0, f"{kernel} was not launched on the main path")

    kernels = phase6_times(launches, errs)
    torch.cuda.synchronize()

    _build.reset_launches()  # the served path starts here
    build_s = phase7_served(analytic, smi)
    torch.cuda.synchronize()
    served_launches = dict(_build.LAUNCHES)  # the served path ends here
    say(f"served path launches: {served_launches}")
    for kernel in ("tiled2d", "tiled3d"):
        check(served_launches[kernel] > 0, f"{kernel} was not launched on the served path")
    for kernel, row in kernels.items():
        row["launches"] += served_launches[kernel]
    say(f"seconds: sweep {sweep_s:.3f}, measure {measure_s:.2f}, fit {fit_s:.2f}, "
        f"calibrated codesign {cal_s:.3f}, served build {build_s:.3f}, "
        f"total {time.perf_counter() - t_start:.1f}")
    print(json.dumps({"kernels": list(kernels.values())}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": card,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
