"""The JAX package's ``tests/test_properties.py``, run on the port's
modules (``repro_torch.core``): property-based invariants for the
optimization core (+ seeded twins). The portfolio properties run on both
of the port's engines: the numpy oracle and the torch engine (float64,
here on the CPU), which is the default of every port entry point.

The reference's description follows.

Three subsystems get algebraic contracts here rather than example tests:

* :func:`repro_torch.core.pareto.pareto_mask` / ``pareto_mask_batched`` -- no
  dominated point survives, every eliminated point has a witness, and the
  surviving *value set* is invariant under permutation and duplication
  (the tie contract pareto.py documents);
* the eq.-18 reduction (:meth:`CodesignResult.best`) -- the best
  achievable GFLOP/s is monotone in the area budget, and uniformly
  scaling every cell time scales the objective by exactly the inverse
  (the argmax is invariant);
* :func:`repro_torch.core.portfolio.optimize_portfolio_arrays` -- K=1 under the
  throughput objective degenerates bit-for-bit to ``best()``, assignment
  rows are one-hot, and a fleet never does worse than the best single
  design it could have been.

Every ``@given`` property has a seeded deterministic twin exercising the
same checker, so a machine without hypothesis (the shim skips the
properties) still runs the invariants over a fixed corpus.
"""

import dataclasses

import numpy as np
import pytest
from _hypothesis_compat import given, settings, st  # soft dep: skips, not errors

from repro_torch.core.codesign import HardwareSpace, codesign
from repro_torch.core.pareto import pareto_front, pareto_mask, pareto_mask_batched
from repro_torch.core.portfolio import optimize_portfolio_arrays, portfolio_candidates
from repro_torch.core.solver import TileLattice
from repro_torch.core.workload import Workload, WorkloadCell, paper_workload
from repro_torch.core.area import MAXWELL

ENGINES = ("numpy", "torch")


def optimize(*args, engine, **kw):
    """``optimize_portfolio_arrays`` on ``engine``; the torch engine on the
    CPU (it wants the card unless given a device)."""
    device = "cpu" if engine == "torch" else None
    return optimize_portfolio_arrays(*args, engine=engine, device=device, **kw)

# ---------------------------------------------------------------------------
# checkers (shared by the hypothesis properties and the seeded twins)
# ---------------------------------------------------------------------------


def check_pareto_contract(cost, perf):
    """The full pareto_mask contract on one (cost, perf) instance."""
    cost = np.asarray(cost, np.float64)
    perf = np.asarray(perf, np.float64)
    mask = pareto_mask(cost, perf)
    finite = np.isfinite(cost) & np.isfinite(perf)
    assert not mask[~finite].any(), "non-finite point survived"
    for i in np.nonzero(mask)[0]:
        dominated = (cost <= cost[i]) & (perf > perf[i]) & finite
        assert not dominated.any(), f"survivor {i} is dominated"
        dup = (cost == cost[i]) & (perf == perf[i]) & finite
        assert i == int(np.nonzero(dup)[0][0]), (
            f"duplicate survivor {i} is not the lowest index"
        )
    for i in np.nonzero(finite & ~mask)[0]:
        # every eliminated finite point has a witness: a strictly better
        # point, or an equal-value duplicate at a lower index
        better = finite & (
            ((cost < cost[i]) & (perf >= perf[i]))
            | ((cost <= cost[i]) & (perf > perf[i]))
        )
        dup_lower = (
            finite & (cost == cost[i]) & (perf == perf[i])
            & (np.arange(cost.size) < i) & mask
        )
        assert better.any() or dup_lower.any(), f"point {i} eliminated without witness"
    return mask


def check_pareto_invariance(cost, perf, rng):
    """Surviving (cost, perf) value set is permutation/duplication-invariant."""
    cost = np.asarray(cost, np.float64)
    perf = np.asarray(perf, np.float64)
    mask = pareto_mask(cost, perf)
    values = sorted(zip(cost[mask].tolist(), perf[mask].tolist()))

    p = rng.permutation(cost.size)
    mask_p = pareto_mask(cost[p], perf[p])
    assert sorted(zip(cost[p][mask_p].tolist(), perf[p][mask_p].tolist())) == values

    cost2, perf2 = np.concatenate([cost, cost]), np.concatenate([perf, perf])
    mask2 = pareto_mask(cost2, perf2)
    assert sorted(zip(cost2[mask2].tolist(), perf2[mask2].tolist())) == values
    assert not mask2[cost.size:].any(), "a duplicated copy survived over the original"


def best_arrays(area, cell_time, cell_flops, freqs, budget):
    """The eq.-18 reduction on raw arrays (CodesignResult.best's algebra)."""
    wt = freqs @ cell_time
    g = (freqs @ cell_flops) / wt / 1.0e9
    g = np.where(np.asarray(area) <= budget, g, -np.inf)
    i = int(np.argmax(g))
    return i, float(g[i])


def check_portfolio_contract(area, cell_time, cell_flops, freqs, k, budget, engine):
    """K=1 degeneracy + one-hot rows + fleet >= best single design."""
    best_i, best_g = best_arrays(area, cell_time, cell_flops, freqs, budget)
    r1 = optimize(
        area, cell_time, cell_flops, freqs, 1, budget, objective="throughput", engine=engine
    )
    assert r1.members == (best_i,), "K=1 named a different design than best()"
    assert r1.fleet_gflops == best_g, "K=1 objective is not bit-equal to best()"

    rk = optimize(
        area, cell_time, cell_flops, freqs, k, budget, objective="throughput", engine=engine
    )
    a = rk.assignment
    assert a.shape == (len(cell_time), len(rk.members))
    np.testing.assert_array_equal(a.sum(axis=1), np.ones(len(cell_time)))
    assert ((a == 0.0) | (a == 1.0)).all(), "assignment is not one-hot"
    assert rk.fleet_gflops >= best_g * (1 - 1e-12), (
        f"fleet {rk.fleet_gflops} worse than single design {best_g}"
    )
    assert rk.total_area <= budget + 1e-9 * abs(budget)
    return rk


def random_portfolio_instance(rng, n_cells=None, n_hw=None):
    C = n_cells or int(rng.integers(1, 5))
    H = n_hw or int(rng.integers(2, 9))
    area = rng.uniform(1.0, 100.0, H)
    cell_time = rng.uniform(0.1, 10.0, (C, H))
    cell_flops = rng.uniform(1e6, 1e9, C)
    freqs = rng.uniform(0.1, 3.0, C)
    return area, cell_time, cell_flops, freqs


# ---------------------------------------------------------------------------
# a real (tiny) codesign result for the eq.-18 / portfolio-degeneracy tests
# ---------------------------------------------------------------------------

TINY_LATTICE = TileLattice(t_s1=(2, 8), t_s2=(32, 128), t_t=(4, 16), k=(1, 4))

_CACHE = {}


def tiny_result():
    """A 12-point hardware space x 3-cell workload, numpy engine (cheap
    enough to build once per test session, real enough that the reduction
    under test is the production one)."""
    if "res" not in _CACHE:
        n_sm = np.repeat([2.0, 8.0, 16.0, 32.0], 3)
        n_v = np.tile([64.0, 256.0, 1024.0], 4)
        m_sm = np.tile([48.0, 96.0, 192.0, 384.0], 3)
        area = MAXWELL.area(n_sm, n_v, m_sm)
        hw = HardwareSpace(n_sm, n_v, m_sm, area)
        wl = paper_workload(["jacobi2d", "heat2d"])
        wl = Workload("tiny", tuple(
            WorkloadCell(c.stencil, c.size, 1.0 / 3) for c in wl.cells[:3]
        ))
        _CACHE["res"] = codesign(wl, hw=hw, lattice_2d=TINY_LATTICE, engine="numpy")
    return _CACHE["res"]


# ---------------------------------------------------------------------------
# pareto: hypothesis properties + seeded twins + duplicate regression
# ---------------------------------------------------------------------------

finite_f = st.floats(
    min_value=-1e6, max_value=1e6, allow_nan=False, allow_infinity=False
)


@settings(max_examples=200)
@given(
    st.lists(st.tuples(finite_f, finite_f), min_size=1, max_size=40),
    st.integers(min_value=0, max_value=2**32 - 1),
)
def test_pareto_mask_properties(points, seed):
    cost = np.array([p[0] for p in points])
    perf = np.array([p[1] for p in points])
    check_pareto_contract(cost, perf)
    check_pareto_invariance(cost, perf, np.random.default_rng(seed))


@settings(max_examples=100)
@given(
    st.integers(min_value=1, max_value=12),
    st.integers(min_value=1, max_value=4),
    st.integers(min_value=0, max_value=2**32 - 1),
)
def test_pareto_mask_batched_matches_rows(n, b, seed):
    rng = np.random.default_rng(seed)
    # coarse quantization manufactures plenty of cost/perf ties
    cost = np.round(rng.uniform(0, 5, n))
    perf = np.round(rng.uniform(0, 5, (b, n)))
    batched = pareto_mask_batched(cost, perf)
    for row in range(b):
        np.testing.assert_array_equal(batched[row], pareto_mask(cost, perf[row]))
        check_pareto_contract(cost, perf[row])


def test_pareto_properties_seeded_twin():
    """The same contract over a fixed corpus -- runs without hypothesis."""
    rng = np.random.default_rng(7)
    for _ in range(40):
        n = int(rng.integers(1, 30))
        # quantized draws force duplicate (cost, perf) pairs regularly
        cost = np.round(rng.uniform(0, 8, n) * 2) / 2
        perf = np.round(rng.uniform(0, 8, n) * 2) / 2
        check_pareto_contract(cost, perf)
        check_pareto_invariance(cost, perf, rng)
        batched = pareto_mask_batched(cost, np.stack([perf, perf[::-1]]))
        np.testing.assert_array_equal(batched[0], pareto_mask(cost, perf))
        np.testing.assert_array_equal(batched[1], pareto_mask(cost, perf[::-1]))


def test_pareto_duplicate_lowest_index_regression():
    """Exact duplicates keep ONLY the lowest original index -- the tie
    contract pareto.py documents and portfolio enumeration relies on."""
    cost = np.array([2.0, 1.0, 2.0, 1.0, 1.0])
    perf = np.array([5.0, 3.0, 5.0, 3.0, 3.0])
    mask = pareto_mask(cost, perf)
    #          dup of 0 at 2; dups of 1 at 3, 4; 0 dominates nothing (cost
    #          higher but perf higher too -> both fronts survive once)
    np.testing.assert_array_equal(mask, [True, True, False, False, False])

    # permuting moves the survivors with their (new) lowest index
    p = np.array([4, 2, 0, 3, 1])
    mask_p = pareto_mask(cost[p], perf[p])
    np.testing.assert_array_equal(mask_p, [True, True, False, False, False])


def test_pareto_front_deterministic_with_duplicates():
    cost = np.array([3.0, 1.0, 3.0, 1.0, 2.0])
    perf = np.array([9.0, 4.0, 9.0, 4.0, 6.0])
    c, p, idx = pareto_front(cost, perf)
    np.testing.assert_array_equal(idx, [1, 4, 0])  # lowest index per value
    assert (np.diff(c) > 0).all() and (np.diff(p) > 0).all()


# ---------------------------------------------------------------------------
# eq.-18 reduction: budget monotonicity + time scaling
# ---------------------------------------------------------------------------

budget_f = st.floats(min_value=0.0, max_value=700.0, allow_nan=False)


@settings(max_examples=50)
@given(budget_f, budget_f)
def test_best_budget_monotone(b1, b2):
    res = tiny_result()
    lo, hi = sorted((b1, b2))
    _, g_lo = res.best(max_area=lo)
    _, g_hi = res.best(max_area=hi)
    assert g_lo <= g_hi, "a bigger area budget made the best design worse"


@settings(max_examples=50)
@given(st.floats(min_value=1e-3, max_value=1e3, allow_nan=False))
def test_best_time_scaling(scale):
    res = tiny_result()
    scaled = dataclasses.replace(res, cell_time=res.cell_time * scale)
    i0, g0 = res.best(max_area=500.0)
    i1, g1 = scaled.best(max_area=500.0)
    assert i1 == i0, "uniform time scaling moved the argmax"
    assert g1 == pytest.approx(g0 / scale, rel=1e-9)


def test_eq18_properties_seeded_twin():
    res = tiny_result()
    budgets = [0.0, 50.0, 120.0, 250.0, 400.0, 650.0, np.inf]
    values = [res.best(max_area=b)[1] for b in budgets]
    assert values == sorted(values)
    for scale in (0.125, 0.5, 3.0, 64.0):
        scaled = dataclasses.replace(res, cell_time=res.cell_time * scale)
        i0, g0 = res.best(max_area=500.0)
        i1, g1 = scaled.best(max_area=500.0)
        assert i1 == i0 and g1 == pytest.approx(g0 / scale, rel=1e-9)


# ---------------------------------------------------------------------------
# portfolio: K=1 degeneracy, one-hot assignment, fleet >= single design
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("engine", ENGINES)
@settings(max_examples=50)
@given(
    st.integers(min_value=0, max_value=2**32 - 1),
    st.integers(min_value=1, max_value=3),
    st.floats(min_value=0.0, max_value=1.0, allow_nan=False),
)
def test_portfolio_properties(engine, seed, k, budget_frac):
    rng = np.random.default_rng(seed)
    area, cell_time, cell_flops, freqs = random_portfolio_instance(rng)
    # budget spans [cheapest single design, whole catalog] -> always feasible
    budget = float(area.min() + budget_frac * (area.sum() - area.min()))
    check_portfolio_contract(area, cell_time, cell_flops, freqs, k, budget, engine)


@pytest.mark.parametrize("engine", ENGINES)
def test_portfolio_properties_seeded_twin(engine):
    rng = np.random.default_rng(11)
    for _ in range(25):
        area, cell_time, cell_flops, freqs = random_portfolio_instance(rng)
        budget = float(rng.uniform(area.min(), area.sum()))
        k = int(rng.integers(1, 4))
        check_portfolio_contract(area, cell_time, cell_flops, freqs, k, budget, engine)


@pytest.mark.parametrize("engine", ENGINES)
def test_portfolio_k1_degenerates_on_real_sweep(engine):
    """K=1 + throughput objective == codesign().best(), bit for bit, on a
    real (tiny) sweep -- the acceptance identity, not just synthetics."""
    res = tiny_result()
    area = res.hw.area
    for budget in (float(area.min()), 120.0, 300.0, float(area.max())):
        best_i, best_g = res.best(max_area=budget)
        r = optimize(
            area, res.cell_time, res.cell_flops(), res.cell_freqs(),
            1, budget, objective="throughput", engine=engine,
        )
        assert r.members == (best_i,)
        assert r.fleet_gflops == best_g


@pytest.mark.parametrize("engine", ENGINES)
def test_portfolio_candidates_never_lose_optimal_value(engine):
    """Restricting k>=2 subsets to full-vector-dominance candidates is
    value-lossless: brute force over ALL subsets finds the same optimum."""
    import itertools

    rng = np.random.default_rng(3)
    for _ in range(10):
        area, cell_time, cell_flops, freqs = random_portfolio_instance(
            rng, n_hw=6
        )
        budget = float(rng.uniform(area.min(), area.sum()))
        for k in (2, 3):
            r = optimize(
                area, cell_time, cell_flops, freqs, k, budget,
                objective="throughput", engine=engine,
            )
            best = -np.inf
            for size in range(1, k + 1):
                for sub in itertools.combinations(range(len(area)), size):
                    if area[list(sub)].sum() > budget:
                        continue
                    t = cell_time[:, list(sub)].min(axis=1)
                    wt = freqs @ t
                    best = max(best, float((freqs @ cell_flops) / wt / 1e9))
            assert r.fleet_gflops == pytest.approx(best, rel=1e-12)


@pytest.mark.parametrize("device", [None, "cpu"])
def test_portfolio_candidates_duplicate_lowest_index(device):
    area = np.array([1.0, 1.0, 2.0])
    cell_time = np.array([[3.0, 3.0, 3.0], [2.0, 2.0, 2.0]])
    mask = portfolio_candidates(area, cell_time, device=device)
    # 1 duplicates 0 (same area, same column) -> only 0 survives; 2 is
    # dominated outright (more area, no faster anywhere)
    assert np.nonzero(mask)[0].tolist() == [0]
