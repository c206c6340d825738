"""The hand-written CUDA kernels against their plain versions, on the card.

Every test here needs an NVIDIA GPU and carries the ``cuda`` marker; the
``card`` fixture skips it, with a reason, where there is none (it decides
inside the fixture, never while the module is imported). Run them on the
card with ``python -m pytest -m cuda tests/test_torch_cuda.py``.

The kernels are built with ``--fmad=false`` and keep the plain versions'
operation order, so f32 results are expected to match bit for bit; the
asserted tolerances are still the reference's (1e-5, rtol 1e-4 with the
field-magnitude slack for multi-step runs, 2e-2 for bf16)."""

import pytest
import torch

from repro_torch.kernels import _build, ops, tiled_stencils as ts
from repro_torch.kernels.stencil_common import step_plain

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _rand(shape, dtype, card, seed=0):
    g = torch.Generator(device=card).manual_seed(seed)
    return torch.randn(shape, generator=g, device=card).to(dtype)


def _tol(dtype):
    return dict(rtol=2e-2, atol=2e-2) if dtype == torch.bfloat16 else dict(rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", list(ops.KERNELS))
def test_step_kernel_matches_plain(card, name, dtype):
    m = ops.KERNELS[name]
    for shape in ([(5, 7), (33, 257), (128, 384)] if m.DIMS == 2 else [(12, 12, 12), (17, 9, 33)]):
        x = _rand(shape, dtype, card)
        for br in (1, 3, 64):
            before = _build.LAUNCHES["step%dd" % m.DIMS]
            got = ops.stencil_step(name, x, block_rows=br)
            assert _build.LAUNCHES["step%dd" % m.DIMS] == before + 1
            want = step_plain(x, m.update, m.HALO)
            torch.cuda.synchronize()
            assert got.dtype == dtype
            torch.testing.assert_close(got.float(), want.float(), **_tol(dtype))


@pytest.mark.parametrize("name", list(ops.KERNELS))
def test_tiled_kernel_matches_plain(card, name):
    m = ops.KERNELS[name]
    shape = (37, 53) if m.DIMS == 2 else (11, 13, 17)
    grid = (
        [{"t_s1": 1, "t_s2": 32, "t_t": 2}, {"t_s1": 16, "t_s2": 128, "t_t": 8},
         {"t_s1": 64, "t_s2": 1024, "t_t": 2}]
        if m.DIMS == 2 else
        [{"t_s1": 1, "t_s2": 32, "t_t": 2, "t_s3": 1}, {"t_s1": 8, "t_s2": 64, "t_t": 4, "t_s3": 8},
         {"t_s1": 32, "t_s2": 256, "t_t": 6, "t_s3": 4}]
    )
    x = _rand(shape, torch.float32, card, seed=1)
    for tiles in grid:
        t = ts.normalize_tiles(tiles)
        got = ts.run_tiled(name, x, steps=5, tiles=tiles)
        want = ts.run_tiled_plain(name, x, 5, t)
        torch.cuda.synchronize()
        scale = max(1.0, float(want.abs().max()))
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4 * scale)


def test_tiled_bf16_and_launch_count(card):
    x = _rand((24, 40), torch.bfloat16, card, seed=3)
    before = _build.LAUNCHES["tiled2d"]
    got = ts.run_tiled("heat2d", x, steps=3, tiles={"t_s1": 8, "t_s2": 32, "t_t": 2})
    assert _build.LAUNCHES["tiled2d"] == before + 2  # passes of 2 and 1 steps
    want = ts.run_tiled_plain("heat2d", x, 3, ts.normalize_tiles({"t_s1": 8, "t_s2": 32, "t_t": 2}))
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16
    torch.testing.assert_close(got.float(), want.float(), rtol=2e-2, atol=2e-2)


#: K1/K2 edge cases: t_s1 = 1 strips and t_s1 >= s1, last passes shorter
#: than t_t, windows clipped at both ends of an axis, 1024 threads for
#: windows wider than 1024, widths that are not multiples of 4 (unaligned
#: row heads and tails), bf16 in 3-D
EDGE_CASES = [
    ("jacobi2d", (45, 131), 5, {"t_s1": 1, "t_s2": 32, "t_t": 2}, torch.float32),
    ("heat2d", (37, 53), 7, {"t_s1": 64, "t_s2": 64, "t_t": 3}, torch.float32),
    ("gradient2d", (40, 2100), 3, {"t_s1": 4, "t_s2": 1024, "t_t": 2}, torch.float32),
    ("laplacian2d", (33, 1030), 4, {"t_s1": 8, "t_s2": 1024, "t_t": 3}, torch.float32),
    ("heat2d", (29, 1027), 3, {"t_s1": 16, "t_s2": 1024, "t_t": 2}, torch.bfloat16),
    ("heat3d", (9, 21, 23), 5, {"t_s1": 1, "t_s2": 32, "t_t": 2, "t_s3": 4}, torch.float32),
    ("laplacian3d", (11, 13, 17), 5, {"t_s1": 16, "t_s2": 32, "t_t": 3, "t_s3": 32}, torch.float32),
    ("heat3d", (20, 70, 37), 6, {"t_s1": 8, "t_s2": 64, "t_t": 4, "t_s3": 8}, torch.float32),
    ("heat3d", (6, 1030, 7), 2, {"t_s1": 2, "t_s2": 1024, "t_t": 2, "t_s3": 2}, torch.float32),
    ("laplacian3d", (17, 9, 33), 3, {"t_s1": 4, "t_s2": 32, "t_t": 2, "t_s3": 8}, torch.bfloat16),
    ("heat3d", (12, 40, 30), 5, {"t_s1": 3, "t_s2": 16, "t_t": 3, "t_s3": 5}, torch.bfloat16),
]


@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("name, shape, steps, tiles, dtype", EDGE_CASES)
def test_tiled_edge_cases_match_plain(card, name, shape, steps, tiles, dtype, offset):
    """``offset`` 1 starts the input one element past an allocation's
    start, off the 16-byte grid of the vector staging."""
    x = _rand(shape, dtype, card, seed=4)
    if offset:
        y = torch.empty(x.numel() + offset, device=card, dtype=dtype)[offset:].view(shape)
        x = y.copy_(x)
    got = ts.run_tiled(name, x, steps=steps, tiles=tiles)
    want = ts.run_tiled_plain(name, x, steps, ts.normalize_tiles(tiles))
    torch.cuda.synchronize()
    assert got.dtype == dtype
    if dtype == torch.bfloat16:
        torch.testing.assert_close(got.float(), want.float(), rtol=2e-2, atol=2e-2)
    else:
        scale = max(1.0, float(want.abs().max()))
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4 * scale)


@pytest.mark.parametrize("name", ["jacobi2d", "heat2d", "laplacian2d", "gradient2d"])
def test_tiled_2d_analytic_optimum_at_4096(card, name):
    """One full pass of the stock-point analytic optimum's time tile on
    4096^2, as the codesign path runs it."""
    import numpy as np

    from repro_torch.core.solver import LATTICE_2D, decode_index, solve_cell
    from repro_torch.core.timemodel import MAXWELL_GPU, STENCILS, ProblemSize

    stock = (np.array([16.0]), np.array([128.0]), np.array([96.0]))
    _, idx = solve_cell(STENCILS[name], MAXWELL_GPU, ProblemSize(4096, 4096, 1024), *stock, LATTICE_2D)
    tiles = decode_index(LATTICE_2D, int(idx[0]))
    t = ts.normalize_tiles(tiles)
    x = _rand((4096, 4096), torch.float32, card, seed=5)
    got = ts.run_tiled(name, x, steps=t[2], tiles=tiles)
    want = ts.run_tiled_plain(name, x, t[2], t)
    torch.cuda.synchronize()
    scale = max(1.0, float(want.abs().max()))
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4 * scale)


def test_oversized_window_raises_before_launch(card):
    x = _rand((64, 128, 128), torch.float32, card)
    before = dict(_build.LAUNCHES)
    with pytest.raises(ValueError, match="shared memory"):
        ts.run_tiled("heat3d", x, steps=16, tiles={"t_s1": 8, "t_s2": 64, "t_t": 16, "t_s3": 2})
    assert _build.LAUNCHES == before


def test_wrappers_refuse_unsupported_input(card):
    with pytest.raises(TypeError, match="dtype"):
        ops.stencil_step("heat2d", torch.zeros(8, 8, device=card, dtype=torch.float64))
    with pytest.raises(ValueError, match="contiguous"):
        ops.stencil_step("heat2d", torch.zeros(8, 16, device=card)[:, ::2])


def _chip_smoke():
    import importlib.util
    import pathlib

    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_server_builds_torch_sweep_on_the_card(card, tmp_path):
    """A ``CodesignServer`` with ``engine="torch"`` builds its artifact on
    the card (the miss path); per cell, best point and Pareto front it
    agrees with an ``engine="numpy"`` server under the tie-aware RTOL 1e-5
    check of ``chip_smoke._tie_check``."""
    import numpy as np

    from repro_torch.core import enumerate_hw_space
    from repro_torch.core.timemodel import MAXWELL_GPU
    from repro_torch.service import ArtifactStore, CodesignServer, QueryRequest

    rtol = 1e-5
    hw = enumerate_hw_space().downsample(32)
    store = ArtifactStore(str(tmp_path))
    srv = CodesignServer(store, hw=hw, engine="torch", batch_window=0.0)
    ref = CodesignServer(store, hw=hw, engine="numpy", batch_window=0.0)
    got_resp, want_resp = srv.query(QueryRequest(pareto=True)), ref.query(QueryRequest(pareto=True))
    assert srv.stats["artifact_builds"] == 1 and srv.key != ref.key
    got, want = store.get(srv.key).to_result(), store.get(ref.key).to_result()
    tie_check = _chip_smoke()._tie_check
    for ci, cell in enumerate(want.workload.cells):
        tie_check(cell.stencil, MAXWELL_GPU, cell.size, want.lattices[ci], hw,
                  want.cell_time[ci], want.cell_tile_idx[ci], got.cell_time[ci],
                  got.cell_tile_idx[ci], rtol)
    g = want.gflops()  # the oracle's numbers judge both answers
    assert got_resp.best_gflops == pytest.approx(want_resp.best_gflops, rel=rtol)
    assert g[got_resp.best_index] >= g[want_resp.best_index] * (1 - rtol)
    # a point on one front and not the other is a tie within rtol
    front_got, front_want = set(got_resp.pareto_indices), set(want_resp.pareto_indices)
    for extra, other in ((front_got - front_want, front_want), (front_want - front_got, front_got)):
        for i in extra:
            assert any(hw.area[j] <= hw.area[i] and g[j] >= g[i] * (1 - rtol) for j in other), i
