"""Port's codesign driver vs the JAX package's, on a downsampled space."""

import numpy as np
import pytest
import torch

from repro.core import codesign as jcodesign
from repro.core import enumerate_hw_space as j_enumerate
from repro.core.workload import paper_workload as j_paper_workload
from repro_torch.core.codesign import (
    _AUTO_MIN_HW,
    _resolve_engine,
    codesign,
    enumerate_hw_space,
    evaluate_fixed_hw,
)
from repro_torch.core.area import GTX980
from repro_torch.core.timemodel import MAXWELL_GPU
from repro_torch.core.workload import paper_workload

RTOL = 1e-5


@pytest.fixture(scope="module")
def pair():
    hw_j = j_enumerate().downsample(24)
    hw = enumerate_hw_space().downsample(24)
    ref = jcodesign(j_paper_workload(), hw=hw_j, engine="jax")
    got = codesign(paper_workload(), hw=hw, engine="torch", device="cpu")
    return ref, got


def test_cell_matrices_match(pair):
    ref, got = pair
    assert got.cell_time.shape == ref.cell_time.shape == (96, len(got.hw))
    np.testing.assert_array_equal(np.isfinite(got.cell_time), np.isfinite(ref.cell_time))
    feas = np.isfinite(ref.cell_time)
    np.testing.assert_allclose(got.cell_time[feas], ref.cell_time[feas], rtol=RTOL)


def test_reductions_match(pair):
    ref, got = pair
    np.testing.assert_allclose(got.weighted_time(), ref.weighted_time(), rtol=RTOL)
    np.testing.assert_allclose(got.gflops(), ref.gflops(), rtol=RTOL)
    freqs = np.linspace(1.0, 2.0, 96)
    freqs /= freqs.sum()
    np.testing.assert_allclose(got.gflops(freqs), ref.gflops(freqs), rtol=RTOL)


@pytest.mark.parametrize("max_area", [np.inf, 450.0, 300.0])
def test_best_matches(pair, max_area):
    ref, got = pair
    i_ref, g_ref = ref.best(max_area=max_area)
    i_got, g_got = got.best(max_area=max_area)
    assert g_got == pytest.approx(g_ref, rel=RTOL)
    assert i_got == i_ref


def test_pareto_mask_matches(pair):
    ref, got = pair
    np.testing.assert_array_equal(got.pareto(), ref.pareto())
    assert got.pareto().sum() > 1


def test_tiles_and_refine_match(pair):
    ref, got = pair
    i, _ = got.best()
    for ci in (0, 50, 95):
        assert got.tiles_for(ci, i) == ref.tiles_for(ci, i)
    t_got, tiles_got = got.refine(i, device="cpu")
    t_ref, tiles_ref = ref.refine(i)
    np.testing.assert_allclose(t_got, t_ref, rtol=RTOL)
    assert tiles_got == tiles_ref


def test_numpy_engine_equals_torch_engine_up_to_ties():
    wl = paper_workload(["jacobi2d", "heat3d"], name="parity")
    hw = enumerate_hw_space().downsample(48)
    a = codesign(wl, hw=hw, engine="numpy")
    b = codesign(wl, hw=hw, engine="torch", device="cpu")
    np.testing.assert_allclose(b.weighted_time(), a.weighted_time(), rtol=RTOL)
    assert b.best()[0] == a.best()[0]


def test_engine_resolution():
    """auto keeps the reference's rule (numpy below _AUTO_MIN_HW points) and
    never falls back because no card is present."""
    assert _resolve_engine("auto", _AUTO_MIN_HW - 1) == "numpy"
    assert _resolve_engine("auto", _AUTO_MIN_HW) == "torch"
    with pytest.raises(ValueError, match="unknown engine"):
        codesign(paper_workload(["jacobi2d"]), hw=enumerate_hw_space().downsample(64),
                    engine="jax")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            codesign(paper_workload(["jacobi2d"]), engine="auto")


def test_evaluate_fixed_hw_matches_reference():
    from repro.core import evaluate_fixed_hw as j_eval
    from repro.core.area import GTX980 as J_GTX980

    got = evaluate_fixed_hw(paper_workload(), GTX980, MAXWELL_GPU)
    ref = j_eval(j_paper_workload(), J_GTX980)
    assert got == pytest.approx(ref, rel=1e-12)
