"""The JAX package's ``tests/test_solver_edges.py``, run on the port's
modules (``repro_torch.core``; the reference's description follows).

Edge-case coverage for the NumPy reference solver + Pareto extraction
(single point, all-dominated, ties) -- pure-NumPy, runs everywhere."""

import numpy as np
import pytest

from repro_torch.core import MAXWELL_GPU, STENCILS, ProblemSize
from repro_torch.core.pareto import pareto_front, pareto_mask
from repro_torch.core.solver import LATTICE_2D, TileLattice, decode_index, refine_point, solve_cell


# ---------------------------------------------------------------------------
# pareto_front / pareto_mask
# ---------------------------------------------------------------------------
def test_pareto_single_point():
    c, p, idx = pareto_front(np.array([10.0]), np.array([5.0]))
    assert idx.tolist() == [0]
    assert c.tolist() == [10.0] and p.tolist() == [5.0]


def test_pareto_all_dominated_by_one():
    """One point dominates everything: the front is exactly that point."""
    cost = np.array([5.0, 10.0, 20.0, 30.0])
    perf = np.array([100.0, 90.0, 50.0, 10.0])  # [0] dominates all
    mask = pareto_mask(cost, perf)
    assert mask.tolist() == [True, False, False, False]


def test_pareto_cost_ties_keep_best_performer_only():
    cost = np.array([10.0, 10.0, 10.0, 20.0])
    perf = np.array([50.0, 70.0, 60.0, 80.0])
    mask = pareto_mask(cost, perf)
    assert mask.tolist() == [False, True, False, True]


def test_pareto_perf_ties_at_same_cost():
    """Exact duplicates: exactly one representative survives."""
    cost = np.array([10.0, 10.0])
    perf = np.array([50.0, 50.0])
    assert pareto_mask(cost, perf).sum() == 1


def test_pareto_nonfinite_points_never_on_front():
    cost = np.array([1.0, 2.0, np.inf, 3.0])
    perf = np.array([1.0, np.nan, 5.0, 2.0])
    mask = pareto_mask(cost, perf)
    assert not mask[1] and not mask[2]
    assert mask[0] and mask[3]


def test_pareto_front_sorted_and_strictly_improving():
    rng = np.random.default_rng(7)
    cost = rng.uniform(1, 100, 200)
    perf = rng.uniform(1, 100, 200)
    fc, fp, idx = pareto_front(cost, perf)
    assert np.all(np.diff(fc) > 0)  # unique, ascending cost
    assert np.all(np.diff(fp) > 0)  # strictly better perf as cost grows
    np.testing.assert_array_equal(cost[idx], fc)


def test_pareto_shape_mismatch_raises():
    with pytest.raises(ValueError, match="shape mismatch"):
        pareto_mask(np.ones(3), np.ones(4))


# ---------------------------------------------------------------------------
# refine_point
# ---------------------------------------------------------------------------
HW = (16.0, 128.0, 96.0)


def _lattice_opt(st, size):
    t, i = solve_cell(
        st, MAXWELL_GPU, size,
        np.array([HW[0]]), np.array([HW[1]]), np.array([HW[2]]), LATTICE_2D,
    )
    return float(t[0]), decode_index(LATTICE_2D, int(i[0]))


def test_refine_from_lattice_optimum_is_locally_exact():
    st = STENCILS["jacobi2d"]
    size = ProblemSize(4096, 4096, 1024)
    t0, sw0 = _lattice_opt(st, size)
    t1, sw1 = refine_point(st, MAXWELL_GPU, size, HW, sw0)
    assert t1 <= t0 * (1 + 1e-12)
    # alignment survives the descent
    assert sw1["t_s2"] % 32 == 0 and sw1["t_t"] % 2 == 0
    assert sw1["t_s1"] >= 1 and sw1["k"] >= 1


def test_refine_single_round_when_already_optimal():
    """Refining a refined point is a fixed point (terminates round one)."""
    st = STENCILS["heat2d"]
    size = ProblemSize(8192, 8192, 2048)
    _, sw0 = _lattice_opt(st, size)
    t1, sw1 = refine_point(st, MAXWELL_GPU, size, HW, sw0)
    t2, sw2 = refine_point(st, MAXWELL_GPU, size, HW, sw1)
    assert sw2 == sw1
    assert t2 == t1


def test_refine_respects_max_rounds():
    """max_rounds=0 must return the starting point untouched."""
    st = STENCILS["jacobi2d"]
    size = ProblemSize(4096, 4096, 1024)
    _, sw0 = _lattice_opt(st, size)
    t, sw = refine_point(st, MAXWELL_GPU, size, HW, sw0, max_rounds=0)
    assert sw == sw0


def test_refine_from_infeasible_start_cannot_reach_finite_lie():
    """Starting from an infeasible tile, the descent either escapes to a
    feasible neighbor (finite time) or reports +inf -- never a finite time
    for an infeasible configuration."""
    st = STENCILS["jacobi2d"]
    size = ProblemSize(4096, 4096, 1024)
    sw0 = {"t_s1": 1, "t_s2": 2048, "t_t": 2, "k": 32, "t_s3": 1}  # violates eq. 12/14
    t, sw = refine_point(st, MAXWELL_GPU, size, HW, sw0)
    from repro_torch.core.timemodel import feasible

    if np.isfinite(t):
        assert bool(
            feasible(
                st, MAXWELL_GPU, HW[0], HW[1], HW[2],
                sw["t_s1"], sw["t_s2"], sw["t_t"], sw["k"], sw["t_s3"],
            )
        )


def test_solve_cell_empty_hardware():
    """H=0 is a degenerate but legal sweep."""
    st = STENCILS["jacobi2d"]
    size = ProblemSize(4096, 4096, 1024)
    t, i = solve_cell(
        st, MAXWELL_GPU, size, np.array([]), np.array([]), np.array([]), LATTICE_2D
    )
    assert t.shape == (0,) and i.shape == (0,)


def test_solve_cell_chunk_zero_means_unchunked():
    """chunk<=0 is 'no chunking' -- same contract as the jax engine."""
    st = STENCILS["jacobi2d"]
    size = ProblemSize(4096, 4096, 1024)
    hw = (np.array([16.0, 8.0]), np.array([128.0, 64.0]), np.array([96.0, 48.0]))
    t_ref, i_ref = solve_cell(st, MAXWELL_GPU, size, *hw, LATTICE_2D)
    t0, i0 = solve_cell(st, MAXWELL_GPU, size, *hw, LATTICE_2D, chunk=0)
    np.testing.assert_array_equal(t0, t_ref)
    np.testing.assert_array_equal(i0, i_ref)


def test_single_candidate_lattice():
    """A one-point lattice degenerates to a plain feasibility check."""
    st = STENCILS["jacobi2d"]
    size = ProblemSize(4096, 4096, 1024)
    lat = TileLattice(t_s1=(8,), t_s2=(64,), t_t=(16,), k=(2,))
    t, i = solve_cell(
        st, MAXWELL_GPU, size,
        np.array([16.0]), np.array([128.0]), np.array([96.0]), lat,
    )
    assert i[0] == 0 and np.isfinite(t[0])
