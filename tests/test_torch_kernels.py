"""Port's one-step stencils (K3/K4 and their plain versions) vs the JAX
package's Pallas kernels in interpret mode, plus the eager oracles.

The same numpy-seeded input goes through ``repro.kernels.ops.stencil_step``
(``interpret=True``) and ``repro_torch.kernels.ops.stencil_step`` on a CPU
tensor, which takes the plain version. Tolerances are the reference's
(``tests/test_kernels.py``): f32 rtol/atol 1e-5, bf16 2e-2, multi-step
rtol 1e-4 / atol 1e-5."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels.ref import run_ref as j_run_ref
from repro_torch.kernels import ops
from repro_torch.kernels.ref import run_ref
from repro_torch.kernels.stencil_common import BLOCK_COLS, MIN_BLOCKS, edge_pad, plan_block_rows

NAMES_2D = ["jacobi2d", "heat2d", "laplacian2d", "gradient2d"]
NAMES_3D = ["heat3d", "laplacian3d"]
SHAPES_2D = [(8, 130), (16, 128), (33, 257), (64, 64), (128, 384), (5, 7)]
SHAPES_3D = [(8, 16, 130), (12, 12, 12), (17, 9, 33), (32, 16, 128)]


def _pair(shape, dtype, seed=0):
    """(jax array, torch tensor) holding the same numpy-seeded values."""
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    if dtype == "bf16":
        return jnp.asarray(x).astype(jnp.bfloat16), torch.from_numpy(x).to(torch.bfloat16)
    return jnp.asarray(x), torch.from_numpy(x)


def _np(t):
    return t.to(torch.float32).numpy()


def _tol(dtype):
    return dict(rtol=2e-2, atol=2e-2) if dtype == "bf16" else dict(rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("shape", SHAPES_2D)
@pytest.mark.parametrize("name", NAMES_2D)
def test_2d_step_matches_reference_kernel(name, shape, dtype):
    xj, xt = _pair(shape, dtype)
    want = np.asarray(jops.stencil_step(name, xj, interpret=True), np.float32)
    got = ops.stencil_step(name, xt)
    assert got.dtype == xt.dtype and got.shape == xt.shape
    np.testing.assert_allclose(_np(got), want, **_tol(dtype))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("shape", SHAPES_3D)
@pytest.mark.parametrize("name", NAMES_3D)
def test_3d_step_matches_reference_kernel(name, shape, dtype):
    xj, xt = _pair(shape, dtype)
    want = np.asarray(jops.stencil_step(name, xj, interpret=True), np.float32)
    got = ops.stencil_step(name, xt)
    assert got.dtype == xt.dtype
    np.testing.assert_allclose(_np(got), want, **_tol(dtype))


@pytest.mark.parametrize("name", list(ops.KERNELS))
def test_multi_step_run_matches_reference(name):
    shape = (24, 40) if ops.KERNELS[name].DIMS == 2 else (10, 12, 14)
    xj, xt = _pair(shape, "f32", seed=1)
    want = np.asarray(jops.stencil_run(name, xj, steps=4, interpret=True))
    got = ops.stencil_run(name, xt, steps=4)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5)
    assert not np.isnan(got.numpy()).any()


@pytest.mark.parametrize("name", ["jacobi2d", "heat3d"])
@pytest.mark.parametrize("block_rows", [1, 2, 3, 5, 8, 64])
def test_block_rows_never_changes_values(name, block_rows):
    shape = (19, 33) if ops.KERNELS[name].DIMS == 2 else (11, 9, 17)
    _, xt = _pair(shape, "f32", seed=3)
    got = ops.stencil_step(name, xt, block_rows=block_rows)
    np.testing.assert_array_equal(got.numpy(), ops.stencil_step(name, xt).numpy())
    np.testing.assert_allclose(got.numpy(), run_ref(name, xt).numpy(), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("name", list(ops.KERNELS))
def test_torch_oracle_matches_jax_oracle(name):
    shape = (21, 34) if ops.KERNELS[name].DIMS == 2 else (9, 10, 11)
    xj, xt = _pair(shape, "f32", seed=4)
    np.testing.assert_allclose(
        run_ref(name, xt, steps=3).numpy(), np.asarray(j_run_ref(name, xj, steps=3)),
        rtol=1e-5, atol=1e-5,
    )


def test_oracle_keeps_dtype_and_f32_accuracy():
    """Compute in f32, return the input dtype (float64 and bf16 alike)."""
    x = torch.from_numpy(np.random.default_rng(5).standard_normal((12, 13)))
    y = run_ref("heat2d", x)
    assert y.dtype == torch.float64
    np.testing.assert_allclose(y.numpy(), run_ref("heat2d", x.float()).double().numpy(), rtol=0)
    assert run_ref("heat2d", x.to(torch.bfloat16)).dtype == torch.bfloat16


def test_borders_are_dirichlet():
    _, x = _pair((16, 24), "f32", seed=2)
    y = ops.stencil_step("jacobi2d", x)
    for sl in (np.s_[0], np.s_[-1], np.s_[:, 0], np.s_[:, -1]):
        np.testing.assert_array_equal(y[sl].numpy(), x[sl].numpy())


def test_plan_block_rows_keeps_the_card_busy():
    assert 1 <= plan_block_rows((8192, 8192)) <= 8
    assert plan_block_rows((8192, 8192)) == 8  # 64 x 1024 blocks
    br = plan_block_rows((4096, 256))
    assert -(-256 // BLOCK_COLS) * -(-4096 // br) >= MIN_BLOCKS
    assert plan_block_rows((5, 7)) == 1
    assert plan_block_rows((256, 256, 256)) == 8
    assert ops.tuned_block_rows("heat2d", (8192, 8192), torch.float32) == 8


def test_kernel_flops_counts_interior():
    assert ops.kernel_flops("jacobi2d", (10, 10), steps=2) == jops.kernel_flops("jacobi2d", (10, 10), 2)
    assert ops.kernel_flops("heat3d", (4, 4, 4)) == 15.0 * 2 * 2 * 2


def test_edge_pad_is_jnp_edge_pad():
    x = np.random.default_rng(6).standard_normal((3, 4, 5)).astype(np.float32)
    got = edge_pad(torch.from_numpy(x), 2, 2).numpy()
    np.testing.assert_array_equal(got, np.pad(x, ((0, 0), (2, 2), (2, 2)), mode="edge"))


def test_wrappers_reject_bad_input():
    with pytest.raises(ValueError, match="2-D"):
        ops.stencil_step("heat2d", torch.zeros(4, 4, 4))
    with pytest.raises(ValueError, match="block_rows"):
        ops.stencil_step("heat2d", torch.zeros(4, 4), block_rows=0)
    with pytest.raises(ValueError, match="unsupported device"):
        ops.stencil_step("heat2d", torch.zeros(4, 4, device="meta"))
