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
