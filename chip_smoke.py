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
   (f32 and bf16, ragged shapes, several tiles and bands, 8192^2 and 256^3);
3. analytic codesign at full width, checked tie-aware against the float64
   numpy oracle;
4. the codesigned tiles run through K1 (2-D) and the one-step kernels
   K3/K4 at their planned band, each checked against plain;
5. measure -> refit -> calibrated codesign;
6. kernel times (CUDA events) beside their bound, plain and library times.

The launch counters are set to 0 just before phase 3 and read just after
phase 5: every kernel must have been launched on the main path. A failed
check raises; nothing is caught. The line before the last is a JSON
object of per-kernel numbers, the last line the device record.
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
        nbytes = ts.window_bytes(shape, ts.tile_shape(st.dims, tt), tt[2])
        if nbytes > ts.SMEM_LIMIT_BYTES:
            say(f"  {name}: analytic optimum {tiles} needs a {tt[2]}-step window of {nbytes} B "
                f"(two f32 buffers), over the {ts.SMEM_LIMIT_BYTES} B a block may have: not run")
            check(st.dims == 3, f"{name}: a 2-D optimum must fit")
            continue
        x = torch.randn(shape, generator=gen, device="cuda")
        steps = tt[2]  # one full pass of the optimum's time tile
        got = ts.run_tiled(name, x, steps=steps, tiles=tiles)
        want = ts.run_tiled_plain(name, x, steps, tt)
        torch.cuda.synchronize()
        scale = max(1.0, float(want.abs().max()))
        e = _assert_close(got, want, 1e-4, 1e-4 * scale, f"{name} optimum tiles")
        say(f"  {name}: analytic optimum {tiles}, {steps} steps on 4096^2 through K1: "
            f"matches plain (max |err| {e:.3g}, field scale {scale:.3g})")
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


def phase6_times(launches, errs):
    """Per kernel at the main path's shapes: kernel, plain and library
    times by CUDA events, and the bound."""
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
            nbytes = 2 * x.numel() * x.element_size()
            flops = ops.kernel_flops(name, shape, n)
            t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, flops / PEAK_F32_FLOPS
            bound_ms = max(t_bytes, t_ops) * 1e3
            bound_by = "bytes" if t_bytes >= t_ops else "operations"
            say(f"  {kernel} {name:12s} {shape} {'tiles ' + str(tiles) if tiles else 'block_rows ' + str(br)}: "
                f"{ms:.4f} ms ({n} step(s)/launch; bound {bound_ms:.4f} ms by {bound_by}, "
                f"{bound_ms / ms:.1%} of it); plain {plain_ms:.4f} ms; "
                f"library {'n/a' if library_ms is None else f'{library_ms:.4f} ms'}")
            if name in ("heat2d", "heat3d"):
                rows[kernel] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                                    library_ms=library_ms)
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
    out = []
    for kernel, (label, source, replaces) in meta.items():
        out.append({"name": label, "route": "cuda", "source": source, "replaces": replaces,
                    "launches": launches[kernel], "max_abs_err": errs[kernel], **rows[kernel]})
    return out


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
    _, sweep_s = phase3_codesign()
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
    say(f"seconds: sweep {sweep_s:.3f}, measure {measure_s:.2f}, fit {fit_s:.2f}, "
        f"calibrated codesign {cal_s:.3f}, total {time.perf_counter() - t_start:.1f}")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": card,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
