"""Port's tile-parameterized stencils (K1/K2 and their plain versions) vs
the JAX package's Pallas tile kernels in interpret mode.

The tolerance is the reference's (``tests/test_pallas_stencils.py``):
rtol 1e-4 elementwise with an absolute slack of rtol x field magnitude
(laplacian and gradient iterations amplify the field, so rounding-order
differences compound relative to the field's scale); bf16 at 2e-2."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import pallas_stencils as jps
from repro.kernels.ref import run_ref as j_run_ref
from repro_torch.kernels import tiled_stencils as ts
from repro_torch.kernels.ref import run_ref

NAMES_2D = ["jacobi2d", "heat2d", "laplacian2d", "gradient2d"]
NAMES_3D = ["heat3d", "laplacian3d"]

#: the reference test's slice of the sweep lattice: tiles larger than the
#: arrays, t_s1=1 strips, and time tiles deeper than the run
TILE_GRID_2D = [
    {"t_s1": 1, "t_s2": 32, "t_t": 2, "k": 1},
    {"t_s1": 4, "t_s2": 32, "t_t": 4, "k": 8},
    {"t_s1": 8, "t_s2": 64, "t_t": 2, "k": 2},
    {"t_s1": 16, "t_s2": 128, "t_t": 8, "k": 32},
    {"t_s1": 64, "t_s2": 1024, "t_t": 2, "k": 1},
]
TILE_GRID_3D = [
    {"t_s1": 1, "t_s2": 32, "t_t": 2, "k": 1, "t_s3": 1},
    {"t_s1": 4, "t_s2": 32, "t_t": 2, "k": 4, "t_s3": 2},
    {"t_s1": 8, "t_s2": 64, "t_t": 4, "k": 1, "t_s3": 8},
    {"t_s1": 32, "t_s2": 256, "t_t": 6, "k": 16, "t_s3": 4},
]


def _pair(shape, dtype="f32", seed=0):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    if dtype == "bf16":
        return jnp.asarray(x).astype(jnp.bfloat16), torch.from_numpy(x).to(torch.bfloat16)
    return jnp.asarray(x), torch.from_numpy(x)


def assert_close(got, want, rtol=1e-4):
    got = got.to(torch.float32).numpy() if isinstance(got, torch.Tensor) else np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    scale = float(np.max(np.abs(want))) if want.size else 1.0
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * max(1.0, scale))


@pytest.mark.parametrize("tiles", TILE_GRID_2D)
@pytest.mark.parametrize("name", NAMES_2D)
def test_2d_tile_grid_matches_reference_kernel(name, tiles):
    xj, xt = _pair((37, 53), seed=1)
    want = jps.run_tiled(name, xj, steps=5, tiles=tiles, interpret=True)
    assert_close(ts.run_tiled(name, xt, steps=5, tiles=tiles), want)


@pytest.mark.parametrize("tiles", TILE_GRID_3D)
@pytest.mark.parametrize("name", NAMES_3D)
def test_3d_tile_grid_matches_reference_kernel(name, tiles):
    xj, xt = _pair((11, 13, 17), seed=2)
    want = jps.run_tiled(name, xj, steps=4, tiles=tiles, interpret=True)
    assert_close(ts.run_tiled(name, xt, steps=4, tiles=tiles), want)


@pytest.mark.parametrize("name", ["heat2d", "heat3d"])
def test_bf16_matches_reference_kernel(name):
    shape = (24, 40) if name == "heat2d" else (10, 12, 14)
    xj, xt = _pair(shape, "bf16", seed=3)
    tiles = {"t_s1": 8, "t_s2": 32, "t_t": 2}
    want = jps.run_tiled(name, xj, steps=2, tiles=tiles, interpret=True)
    got = ts.run_tiled(name, xt, steps=2, tiles=tiles)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), rtol=2e-2, atol=2e-2)


def test_k_is_occupancy_only():
    _, x = _pair((29, 31), seed=4)
    outs = [
        ts.run_tiled("jacobi2d", x, steps=3, tiles={"t_s1": 8, "t_s2": 32, "t_t": 2, "k": k})
        for k in (1, 8, 32)
    ]
    for o in outs[1:]:
        np.testing.assert_array_equal(outs[0].numpy(), o.numpy())


@pytest.mark.parametrize("t_t", [1, 2, 3, 7, 16])
def test_time_tile_depth_is_semantics_preserving(t_t):
    xj, xt = _pair((25, 45), seed=5)
    want = j_run_ref("heat2d", xj, steps=7)
    assert_close(ts.run_tiled("heat2d", xt, steps=7, tiles={"t_s1": 8, "t_s2": 32, "t_t": t_t}), want)
    assert_close(run_ref("heat2d", xt, steps=7), want)


def test_borders_are_dirichlet():
    _, x = _pair((18, 22), seed=6)
    y = ts.run_tiled("laplacian2d", x, steps=3, tiles={"t_s1": 4, "t_s2": 32, "t_t": 2})
    for sl in (np.s_[0], np.s_[-1], np.s_[:, 0], np.s_[:, -1]):
        np.testing.assert_array_equal(y[sl].numpy(), x[sl].numpy())


def test_normalize_tiles_contract_matches_reference():
    assert ts.TILE_NAMES == jps.TILE_NAMES
    assert ts.DEFAULT_TILES == jps.DEFAULT_TILES
    for tiles in (None, {"t_s1": 2}, {"t_s3": 3, "k": 4}):
        assert ts.normalize_tiles(tiles) == jps.normalize_tiles(tiles)
    with pytest.raises(ValueError, match="unknown tile parameter"):
        ts.normalize_tiles({"t_sX": 2})
    with pytest.raises(ValueError, match=">= 1"):
        ts.normalize_tiles({"t_t": 0})
    with pytest.raises(KeyError, match="unknown stencil"):
        ts.run_tiled("nosuch", torch.zeros(4, 4), steps=1)
    with pytest.raises(ValueError, match="steps"):
        ts.run_tiled("heat2d", torch.zeros(4, 4), steps=-1)


def test_zero_steps_is_identity():
    _, x = _pair((9, 9), seed=7)
    assert ts.run_tiled("heat2d", x, steps=0) is x


def test_footprint_matches_reference():
    for dims, tiles in ((2, {"t_s1": 8, "t_s2": 32, "t_t": 8}), (3, {"t_s1": 4, "t_s2": 64, "t_t": 2})):
        assert ts.tile_footprint_cells(dims, tiles) == jps.tile_footprint_cells(dims, tiles)


def test_window_check_refuses_the_3d_analytic_optimum():
    """The 3-D optimum (8, 64, t_t=16, t_s3=2) widens every axis by 16 per
    side: 40 x 96 x 34 cells, 522,240 B per f32 buffer -- over the 232,448 B
    a block may have. The check raises before any launch, naming tile,
    bytes and limit; it is pure Python."""
    tiles = ts.normalize_tiles({"t_s1": 8, "t_s2": 64, "t_t": 16, "k": 1, "t_s3": 2})
    assert ts.window_cells((4096, 4096, 4096), (8, 64, 2), 16) * 4 == 522_240
    with pytest.raises(ValueError, match=r"1044480 B.*232448 B") as err:
        ts.check_window("heat3d", (4096, 4096, 4096), tiles, 16)
    assert "t_s1" in str(err.value) and "232448" in str(err.value)
    # the 2-D jacobi optimum (16, 128, t_t=32) fits: 80 x 192 cells, two buffers
    t2 = ts.normalize_tiles({"t_s1": 16, "t_s2": 128, "t_t": 32})
    assert ts.check_window("jacobi2d", (4096, 4096), t2, 32) == 2 * 61_440
    # windows are clipped to the array, so a small array fits any tile
    assert ts.check_window("heat3d", (11, 13, 17), tiles, 16) == 2 * 4 * 11 * 13 * 17


def test_plain_pass_is_tile_invariant_and_exact():
    """The plain pass computes every core value from its own window: the
    result does not depend on the tile shape (same f32 ops per cell)."""
    _, x = _pair((20, 70), seed=8)
    a = ts.tiled_pass_plain(x, ts._MODULES["heat2d"].update, 1, (3, 32), 4)
    b = ts.tiled_pass_plain(x, ts._MODULES["heat2d"].update, 1, (20, 70), 4)
    np.testing.assert_array_equal(a.numpy(), b.numpy())
