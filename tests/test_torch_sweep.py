"""Port's torch sweep engine vs the JAX package's compiled sweep.

Held to the reference's own contract (``tests/test_sweep.py``): identical
feasibility, optima within RTOL = 1e-5 (float32 evaluation noise), and
where the argmins differ only exact ties -- the port's candidate,
re-evaluated in the float64 oracle model, must reach the reference's
optimum. The port runs on the CPU here (``device="cpu"``)."""

import numpy as np
import pytest

from repro.core import sweep as jsweep
from repro.core.codesign import enumerate_hw_space as j_enumerate
from repro.core.timemodel import MAXWELL_GPU as J_GPU
from repro.core.timemodel import ProblemSize as JSize
from repro.core.timemodel import STENCILS as J_STENCILS
from repro.core.timemodel import stencil_time as j_stencil_time
from repro.core.workload import paper_sizes
from repro_torch.core import sweep
from repro_torch.core.codesign import enumerate_hw_space
from repro_torch.core.solver import LATTICE_2D, LATTICE_3D, solve_cell
from repro_torch.core.timemodel import MAXWELL_GPU, STENCILS, ProblemSize

RTOL = 1e-5


def small_hw(step=16):
    return enumerate_hw_space().downsample(step)


def _sizes(dims):
    return np.array([(s.s1, s.s2, s.s3, s.t) for s in paper_sizes(dims)], np.float64)


def assert_tie_equivalent(name, sizes, hw, t_ref, i_ref, t_got, i_got):
    """Feasibility equal; optima within RTOL; differing argmins are ties."""
    st = J_STENCILS[name]
    lattice = LATTICE_3D if st.dims == 3 else LATTICE_2D
    g = lattice.grid()
    assert np.array_equal(i_ref < 0, i_got < 0), "feasibility sets differ"
    feas = i_ref >= 0
    assert feas.any()
    np.testing.assert_allclose(t_got[feas], t_ref[feas], rtol=RTOL)
    for p, h in zip(*np.nonzero(feas & (i_ref != i_got))):
        j = i_got[p, h]
        s1, s2, s3, t = sizes[p]
        t_alt = float(j_stencil_time(
            st, J_GPU, JSize(s1=s1, s2=s2, t=t, s3=s3), hw.n_sm[h], hw.n_v[h], hw.m_sm[h],
            g["t_s1"][j], g["t_s2"][j], g["t_t"][j], g["k"][j], g["t_s3"][j],
        ))
        assert t_alt == pytest.approx(t_ref[p, h], rel=RTOL), (p, h)


@pytest.mark.parametrize("name", list(STENCILS))
def test_sweep_cells_matches_reference(name):
    hw = small_hw()
    sizes = _sizes(STENCILS[name].dims)
    t_ref, i_ref = jsweep.sweep_cells(J_STENCILS[name], J_GPU, sizes, hw.n_sm, hw.n_v, hw.m_sm)
    t_got, i_got = sweep.sweep_cells(
        STENCILS[name], MAXWELL_GPU, sizes, hw.n_sm, hw.n_v, hw.m_sm, device="cpu"
    )
    assert t_got.dtype == np.float64 and i_got.dtype == np.int64
    assert t_got.shape == (len(sizes), len(hw))
    assert_tie_equivalent(name, sizes, hw, t_ref, i_ref, t_got, i_got)


def test_sweep_cell_matches_numpy_oracle():
    """The P=1 form against the port's own float64 oracle."""
    st = STENCILS["heat3d"]
    size = ProblemSize(512, 512, 256, s3=512)
    hw = small_hw()
    t_np, i_np = solve_cell(st, MAXWELL_GPU, size, hw.n_sm, hw.n_v, hw.m_sm)
    t_got, i_got = sweep.sweep_cell(st, MAXWELL_GPU, size, hw.n_sm, hw.n_v, hw.m_sm, device="cpu")
    sizes = np.array([[size.s1, size.s2, size.s3, size.t]], np.float64)
    assert_tie_equivalent("heat3d", sizes, hw, t_np[None], i_np[None], t_got[None], i_got[None])


def test_all_sizes_in_one_call_equal_separate_calls():
    """A (P, 4) size batch reproduces P separate sweep_cell calls exactly,
    for every chunking regime (scaled default, a non-divisor, none)."""
    st = STENCILS["heat2d"]
    hw = small_hw(step=13)
    sizes = _sizes(2)[:5]
    refs = [
        sweep.sweep_cell(
            st, MAXWELL_GPU, ProblemSize(s1=r[0], s2=r[1], t=r[3], s3=r[2]),
            hw.n_sm, hw.n_v, hw.m_sm, device="cpu",
        )
        for r in sizes
    ]
    for chunk in (None, 7, 0):
        t, i = sweep.sweep_cells(
            st, MAXWELL_GPU, sizes, hw.n_sm, hw.n_v, hw.m_sm, chunk=chunk, device="cpu"
        )
        for p, (t_ref, i_ref) in enumerate(refs):
            np.testing.assert_array_equal(t[p], t_ref)
            np.testing.assert_array_equal(i[p], i_ref)


def test_chunking_is_invisible():
    st = STENCILS["jacobi2d"]
    size = ProblemSize(4096, 4096, 1024)
    hw = small_hw(step=11)
    ref_t, ref_i = sweep.sweep_cell(st, MAXWELL_GPU, size, hw.n_sm, hw.n_v, hw.m_sm, chunk=0, device="cpu")
    for chunk in (1, 7, 64, 10**9):
        t, i = sweep.sweep_cell(
            st, MAXWELL_GPU, size, hw.n_sm, hw.n_v, hw.m_sm, chunk=chunk, device="cpu"
        )
        np.testing.assert_array_equal(i, ref_i)
        np.testing.assert_array_equal(t, ref_t)


def test_infeasible_hardware_gives_minus_one_and_inf():
    st = STENCILS["heat3d"]
    size = ProblemSize(512, 512, 256, s3=512)
    n_sm, n_v, m_sm = np.array([16.0, 16.0]), np.array([128.0, 128.0]), np.array([0.001, 96.0])
    t, i = sweep.sweep_cell(st, MAXWELL_GPU, size, n_sm, n_v, m_sm, device="cpu")
    t_np, i_np = solve_cell(st, MAXWELL_GPU, size, n_sm, n_v, m_sm)
    assert i[0] == -1 and not np.isfinite(t[0])
    assert i_np[0] == -1 and i[1] >= 0 and np.isfinite(t[1])
    # empty hardware space: shape-correct and all-infeasible
    t0, i0 = sweep.sweep_cells(st, MAXWELL_GPU, np.zeros((2, 4)) + 64, [], [], [], device="cpu")
    assert t0.shape == i0.shape == (2, 0)


def test_sizes_must_be_p_by_4():
    with pytest.raises(ValueError, match=r"\(P, 4\)"):
        sweep.sweep_cells(STENCILS["heat2d"], MAXWELL_GPU, np.ones((2, 3)), [2.0], [32.0], [96.0], device="cpu")


@pytest.mark.parametrize("name", ["heat2d", "laplacian3d"])
def test_refine_points_matches_reference(name):
    st = STENCILS[name]
    lattice = LATTICE_3D if st.dims == 3 else LATTICE_2D
    size = ProblemSize(8192, 8192, 2048, s3=8192 if st.dims == 3 else 1)
    hw = small_hw(step=64)
    t0, i0 = sweep.sweep_cell(st, MAXWELL_GPU, size, hw.n_sm, hw.n_v, hw.m_sm, device="cpu")
    feas = np.nonzero(i0 >= 0)[0][:8]
    g = lattice.grid()
    sw0 = np.stack([[g[k][i0[h]] for k in sweep.SW_NAMES] for h in feas])
    hw_rows = np.stack([[hw.n_sm[h], hw.n_v[h], hw.m_sm[h]] for h in feas])
    sizes = np.tile((size.s1, size.s2, size.s3, size.t), (len(feas), 1))
    t_got, sw_got = sweep.refine_points(st, MAXWELL_GPU, sizes, hw_rows, sw0, device="cpu")
    t_ref, sw_ref = jsweep.refine_points(J_STENCILS[name], J_GPU, sizes, hw_rows, sw0)
    np.testing.assert_array_equal(sw_got, sw_ref)
    np.testing.assert_allclose(t_got, t_ref, rtol=RTOL)
    assert np.all(t_got <= t0[feas] * (1 + RTOL))
    # zero rounds: the start points untouched, with float64 times
    t_z, sw_z = sweep.refine_points(st, MAXWELL_GPU, sizes, hw_rows, sw0, max_rounds=0, device="cpu")
    np.testing.assert_array_equal(sw_z, sw0)
    np.testing.assert_array_equal(t_z, jsweep.refine_points(
        J_STENCILS[name], J_GPU, sizes, hw_rows, sw0, max_rounds=0)[0])


def test_sw_names_and_steps_match_reference():
    assert sweep.SW_NAMES == jsweep.SW_NAMES
    assert sweep.SW_STEPS == jsweep.SW_STEPS
    assert sweep.SW_MINS == jsweep.SW_MINS
    assert sweep.DEFAULT_CHUNK == jsweep.DEFAULT_CHUNK
    assert sweep.decode_sw(np.array([8.0, 32.0, 2.0, 1.0, 1.0])) == jsweep.decode_sw(
        np.array([8.0, 32.0, 2.0, 1.0, 1.0])
    )
    hw = j_enumerate()
    assert len(hw) == len(enumerate_hw_space()) == 5121
