"""Port vs JAX package: the time, area, workload and Pareto models.

The same random lattice x hardware points go through
``repro.core.timemodel`` (numpy float64) and ``repro_torch.core.timemodel``
(torch). In float64 the port is bit-exact: every op (``+ * /``, ``ceil``,
``maximum``/``minimum``, ``%``, ``where``) is one IEEE-rounded operation in
the same order on both sides. In float32 it is held to RTOL = 1e-5, the
sweep's float32 evaluation-noise bound."""

import numpy as np
import pytest
import torch

from repro.core import area as j_area
from repro.core import pareto as j_pareto
from repro.core import timemodel as jtm
from repro.core import workload as j_workload
from repro_torch.core import area, pareto, timemodel as tm, workload
from repro_torch.core.solver import LATTICE_2D, LATTICE_3D

RTOL = 1e-5


def _points(n, lattice, seed):
    """n random (hardware, lattice, size) points drawn with numpy."""
    rng = np.random.default_rng(seed)
    g = lattice.grid()
    li = rng.integers(0, lattice.size, n)
    cols = {k: g[k][li] for k in ("t_s1", "t_s2", "t_t", "k", "t_s3")}
    hw = {
        "n_sm": rng.integers(1, 17, n) * 2.0,
        "n_v": rng.integers(1, 65, n) * 32.0,
        "m_sm": rng.choice([12.0, 24.0, 36.0, 48.0, 96.0, 480.0], n),
    }
    s = rng.choice([512.0, 4096.0, 8192.0], n)
    size = (s, s, rng.choice([64.0, 1024.0], n), s)
    return hw, cols, size


def _args(hw, cols, size, mod, conv):
    s1, s2, t, s3 = (conv(v) for v in size)
    return (
        mod.ProblemSize(s1=s1, s2=s2, t=t, s3=s3),
        conv(hw["n_sm"]), conv(hw["n_v"]), conv(hw["m_sm"]),
        *(conv(cols[k]) for k in ("t_s1", "t_s2", "t_t", "k", "t_s3")),
    )


@pytest.mark.parametrize("name", list(jtm.STENCILS))
def test_stencil_time_float64_bit_exact(name):
    lattice = LATTICE_3D if tm.STENCILS[name].dims == 3 else LATTICE_2D
    hw, cols, size = _points(4000, lattice, seed=len(name))
    want = jtm.stencil_time(jtm.STENCILS[name], jtm.MAXWELL_GPU, *_args(hw, cols, size, jtm, np.asarray))
    got = tm.stencil_time(
        tm.STENCILS[name], tm.MAXWELL_GPU, *_args(hw, cols, size, tm, torch.from_numpy),
        xp=torch, dtype=torch.float64,
    )
    assert np.isfinite(want).any() and (~np.isfinite(want)).any()
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("name", ["jacobi2d", "heat3d"])
def test_stencil_time_float32_within_rtol(name):
    lattice = LATTICE_3D if tm.STENCILS[name].dims == 3 else LATTICE_2D
    hw, cols, size = _points(4000, lattice, seed=7)
    want = jtm.stencil_time(jtm.STENCILS[name], jtm.MAXWELL_GPU, *_args(hw, cols, size, jtm, np.asarray))
    got = tm.stencil_time(
        tm.STENCILS[name], tm.MAXWELL_GPU, *_args(hw, cols, size, tm, torch.from_numpy),
        xp=torch,
    ).numpy()
    assert got.dtype == np.float32
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=RTOL)


@pytest.mark.parametrize("name", ["laplacian2d", "laplacian3d"])
def test_feasible_and_footprint_bit_exact(name):
    lattice = LATTICE_3D if tm.STENCILS[name].dims == 3 else LATTICE_2D
    hw, cols, _ = _points(3000, lattice, seed=3)
    lat = [cols[k] for k in ("t_s1", "t_s2", "t_t", "k", "t_s3")]
    want_ok = jtm.feasible(jtm.STENCILS[name], jtm.MAXWELL_GPU, hw["n_sm"], hw["n_v"], hw["m_sm"], *lat)
    got_ok = tm.feasible(
        tm.STENCILS[name], tm.MAXWELL_GPU,
        *(torch.from_numpy(v) for v in (hw["n_sm"], hw["n_v"], hw["m_sm"], *lat)),
        xp=torch, dtype=torch.float64,
    )
    np.testing.assert_array_equal(got_ok.numpy(), want_ok)
    fp_args = (cols["t_s1"], cols["t_s2"], cols["t_t"], cols["t_s3"])
    want_fp = jtm.footprint_bytes(jtm.STENCILS[name], jtm.MAXWELL_GPU, *fp_args)
    got_fp = tm.footprint_bytes(
        tm.STENCILS[name], tm.MAXWELL_GPU, *(torch.from_numpy(v) for v in fp_args),
        xp=torch, dtype=torch.float64,
    )
    np.testing.assert_array_equal(got_fp.numpy(), want_fp)


def test_numpy_path_is_the_reference_model():
    """The port's numpy path (its oracle) is the reference's, and scalars
    evaluate on the device of the tensor arguments."""
    st, gpu = tm.STENCILS["heat2d"], tm.MAXWELL_GPU
    size = tm.ProblemSize(4096, 4096, 1024)
    args = (16.0, 128.0, 96.0, 16.0, 128.0, 32.0, 1.0)
    want = jtm.stencil_time(jtm.STENCILS["heat2d"], jtm.MAXWELL_GPU, jtm.ProblemSize(4096, 4096, 1024), *args)
    assert float(tm.stencil_time(st, gpu, size, *args)) == float(want)
    t = tm.stencil_time(st, gpu, size, *args[:-1], torch.ones(3), xp=torch)
    assert t.shape == (3,) and t.dtype == torch.float32
    with pytest.raises(TypeError, match="numpy or torch"):
        tm.stencil_time(st, gpu, size, *args, xp=object())


def test_specs_and_registries_match_reference():
    import dataclasses

    assert {n: dataclasses.asdict(s) for n, s in tm.STENCILS.items()} == {
        n: dataclasses.asdict(s) for n, s in jtm.STENCILS.items()
    }
    assert {n: dataclasses.asdict(g) for n, g in tm.GPUS_BY_NAME.items()} == {
        n: dataclasses.asdict(g) for n, g in jtm.GPUS_BY_NAME.items()
    }
    assert dataclasses.asdict(area.MAXWELL) == dataclasses.asdict(j_area.MAXWELL)
    for a, b in ((area.GTX980, j_area.GTX980), (area.TITAN_X, j_area.TITAN_X)):
        assert area.MAXWELL.area_point(a) == j_area.MAXWELL.area_point(b)
    assert area.cacheless(area.GTX980).l2_kb == 0.0


def test_workload_matches_reference():
    import dataclasses

    ours = workload.paper_workload()
    ref = j_workload.paper_workload()
    assert len(ours.cells) == len(ref.cells) == 96
    for a, b in zip(ours.cells, ref.cells):
        assert dataclasses.asdict(a.stencil) == dataclasses.asdict(b.stencil)
        assert (a.size.s1, a.size.s2, a.size.s3, a.size.t, a.freq) == (
            b.size.s1, b.size.s2, b.size.s3, b.size.t, b.freq,
        )
    with pytest.raises(ValueError, match="sum to"):
        workload.Workload("bad", ours.cells[:3])


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pareto_matches_reference(seed):
    rng = np.random.default_rng(seed)
    cost = rng.integers(0, 40, 300).astype(float)
    perf = rng.integers(0, 40, (4, 300)).astype(float)
    perf[0, ::7] = np.inf
    np.testing.assert_array_equal(pareto.pareto_mask(cost, perf[1]), j_pareto.pareto_mask(cost, perf[1]))
    np.testing.assert_array_equal(
        pareto.pareto_mask_batched(cost, perf), j_pareto.pareto_mask_batched(cost, perf)
    )
    for a, b in zip(pareto.pareto_front(cost, perf[2]), j_pareto.pareto_front(cost, perf[2])):
        np.testing.assert_array_equal(a, b)


def test_no_tensor_and_no_device_means_the_card():
    """With ``xp=torch``, no tensor argument and no ``device``, the model
    evaluates on the card: without one it raises, and ``device="cpu"``
    runs it on the CPU."""
    st, gpu = tm.STENCILS["heat3d"], tm.MAXWELL_GPU
    size = tm.ProblemSize(256, 256, 64, s3=256)
    hw, tiles = (16.0, 128.0, 96.0), (8.0, 32.0, 2.0, 1.0, 8.0)
    calls = (
        lambda **kw: tm.stencil_time(st, gpu, size, *hw, *tiles, xp=torch, **kw),
        lambda **kw: tm.feasible(st, gpu, *hw, *tiles, xp=torch, **kw),
        lambda **kw: tm.footprint_bytes(st, gpu, 8.0, 32.0, 2.0, 8.0, xp=torch, **kw),
    )
    for call in calls:
        if torch.cuda.is_available():
            assert call().device.type == "cuda"
        else:
            with pytest.raises(RuntimeError, match="no CUDA device"):
                call()
        assert call(device="cpu").device.type == "cpu"
    want = jtm.stencil_time(jtm.STENCILS["heat3d"], jtm.MAXWELL_GPU,
                            jtm.ProblemSize(256, 256, 64, s3=256), *hw, *tiles)
    got = tm.stencil_time(st, gpu, size, *hw, *tiles, xp=torch, dtype=torch.float64, device="cpu")
    assert float(got) == float(want)
