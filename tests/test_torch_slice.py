"""The slice as a whole, through both packages on a downsampled space:
analytic codesign -> fit on the same synthetic "measurements" ->
calibrated codesign. Both must land on the same calibrated best point,
and a calibration from either package frames a sweep in the other."""

import numpy as np
import pytest

from repro.core import codesign as j_codesign
from repro.core import enumerate_hw_space as j_enumerate
from repro.core.timemodel import MAXWELL_GPU as J_GPU
from repro.core.timemodel import STENCILS as J_STENCILS
from repro.core.timemodel import with_c_iter as j_with_c_iter
from repro.core.timemodel import with_machine_params as j_with_machine_params
from repro.core.workload import paper_workload as j_paper_workload
from repro.measure import CalibrationResult as JCalibrationResult
from repro.measure import fit_machine_params as j_fit
from repro.measure import synthetic_records as j_synthetic_records
from repro_torch.core.codesign import codesign, enumerate_hw_space
from repro_torch.core.timemodel import MAXWELL_GPU
from repro_torch.core.workload import paper_workload
from repro_torch.measure import CalibrationResult, MeasurementRecord, fit_machine_params

RTOL = 1e-5
STEP = 32  # every 32nd hardware point: 161 of 5,121


@pytest.fixture(scope="module")
def slice_pair():
    hw_j, hw = j_enumerate().downsample(STEP), enumerate_hw_space().downsample(STEP)
    # 1. analytic codesign
    a_ref = j_codesign(j_paper_workload(), hw=hw_j, engine="jax")
    a_got = codesign(paper_workload(), hw=hw, engine="torch", device="cpu")
    # 2. the same "measurements": a machine off the datasheet, 3% noise
    g_t = j_with_machine_params(J_GPU, bw_gmem=120.0e9, launch_overhead=12.0e-6)
    s_t = {n: j_with_c_iter(s, s.c_iter * (0.6 + 0.2 * i)) for i, (n, s) in enumerate(J_STENCILS.items())}
    recs = j_synthetic_records(g_t, s_t, noise=0.03, seed=11)
    cal_ref = j_fit(recs, gpu0=J_GPU)
    cal_got = fit_machine_params(
        [MeasurementRecord.from_json(r.to_json()) for r in recs], gpu0=MAXWELL_GPU, device="cpu"
    )
    # 3. calibrated codesign
    c_ref = j_codesign(cal_ref.calibrated_workload(), gpu=cal_ref.calibrated_gpu(), hw=hw_j, engine="jax")
    c_got = codesign(cal_got.calibrated_workload(), gpu=cal_got.calibrated_gpu(), hw=hw,
                     engine="torch", device="cpu")
    return a_ref, a_got, cal_ref, cal_got, c_ref, c_got


def test_analytic_best_point_matches(slice_pair):
    a_ref, a_got = slice_pair[:2]
    assert a_got.best()[0] == a_ref.best()[0]
    assert a_got.best()[1] == pytest.approx(a_ref.best()[1], rel=RTOL)


def test_calibrated_best_point_matches(slice_pair):
    _, _, _, _, c_ref, c_got = slice_pair
    i_ref, g_ref = c_ref.best()
    i_got, g_got = c_got.best()
    assert i_got == i_ref
    assert g_got == pytest.approx(g_ref, rel=1e-3)
    assert c_got.gpu.name == c_ref.gpu.name == "gtx980-cal"


def test_calibration_moved_the_design(slice_pair):
    """The fit is not a no-op: calibrated predictions differ from the
    datasheet ones (the best point's GFLOP/s changes)."""
    a_ref, a_got, _, _, c_ref, c_got = slice_pair
    assert c_got.best()[1] != pytest.approx(a_got.best()[1], rel=1e-3)


def test_calibrations_frame_sweeps_across_packages(slice_pair):
    """A calibration written by one package, read by the other, frames the
    same sweep (bit-identical specs go across as dataclass fields)."""
    _, _, cal_ref, cal_got, c_ref, _ = slice_pair
    crossed = CalibrationResult.from_payload(cal_ref.to_payload())
    hw = enumerate_hw_space().downsample(STEP)
    res = codesign(crossed.calibrated_workload(), gpu=crossed.calibrated_gpu(), hw=hw,
                   engine="torch", device="cpu")
    np.testing.assert_allclose(res.weighted_time(), c_ref.weighted_time(), rtol=RTOL)
    back = JCalibrationResult.from_payload(cal_got.to_payload())
    assert back.gpu.bw_gmem == cal_got.gpu.bw_gmem
