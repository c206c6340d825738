"""Port's measurement harness and calibration fit vs the JAX package's.

* The fit: on identical synthetic records both packages start from the
  same datasheet parameters and take the same hand-written Adam steps in
  float32. Measured agreement is ~4e-6 relative on every fitted parameter
  (float32 rounding in another order); the test holds 1e-4.
* Synthetic recovery stays under RECOVERY_RTOL.
* Payloads round-trip in both directions as the same JSON.
"""

import json

import numpy as np
import pytest
import torch

from repro.core.timemodel import MAXWELL_GPU as J_GPU
from repro.core.timemodel import STENCILS as J_STENCILS
from repro.core.timemodel import with_c_iter as j_with_c_iter
from repro.core.timemodel import with_machine_params as j_with_machine_params
from repro.measure import CalibrationResult as JCalibrationResult
from repro.measure import MeasurementRun as JMeasurementRun
from repro.measure import fit_machine_params as j_fit
from repro.measure import synthetic_records as j_synthetic_records
from repro.measure.harness import default_grid as j_default_grid
from repro_torch.core.timemodel import MAXWELL_GPU, STENCILS, TITANX_GPU, with_c_iter, with_machine_params
from repro_torch.measure import (
    RECOVERY_RTOL,
    CalibrationResult,
    MeasurementRecord,
    MeasurementRun,
    default_grid,
    fit_machine_params,
    measure_grid,
    measure_one,
    predicted_times,
    synthetic_records,
)
from repro_torch.measure.harness import STOCK_HW, feasible_tiles, stock_hw

FIT_RTOL = 1e-4


def _truth(with_c, with_m, gpu, stencils):
    g = with_m(gpu, bw_gmem=150.0e9, launch_overhead=8.0e-6)
    sts = {n: with_c(st, st.c_iter * (1.0 + 0.25 * (i + 1))) for i, (n, st) in enumerate(stencils.items())}
    return g, sts


@pytest.fixture(scope="module")
def noisy_fits():
    gpu_t, st_t = _truth(j_with_c_iter, j_with_machine_params, J_GPU, J_STENCILS)
    recs = j_synthetic_records(gpu_t, st_t, noise=0.05, seed=7)
    ref = j_fit(recs, gpu0=J_GPU, stencils0=J_STENCILS)
    ours = [MeasurementRecord.from_json(r.to_json()) for r in recs]
    got = fit_machine_params(ours, gpu0=MAXWELL_GPU, stencils0=STENCILS, device="cpu")
    return ref, got


def test_fit_agrees_with_reference(noisy_fits):
    ref, got = noisy_fits
    assert got.gpu.bw_gmem == pytest.approx(ref.gpu.bw_gmem, rel=FIT_RTOL)
    assert got.gpu.launch_overhead == pytest.approx(ref.gpu.launch_overhead, rel=FIT_RTOL)
    for name, st in ref.stencils.items():
        assert got.stencils[name].c_iter == pytest.approx(st.c_iter, rel=FIT_RTOL), name
    assert (got.n_records, got.n_dropped, got.iters) == (ref.n_records, ref.n_dropped, ref.iters)
    assert got.loss_before == ref.loss_before
    assert got.loss_after == pytest.approx(ref.loss_after, rel=1e-3)
    assert got.errors_before == ref.errors_before


def test_synthetic_fit_recovers_generating_parameters():
    gpu_t, st_t = _truth(with_c_iter, with_machine_params, MAXWELL_GPU, STENCILS)
    recs = synthetic_records(gpu_t, st_t)
    cal = fit_machine_params(recs, gpu0=MAXWELL_GPU, stencils0=STENCILS, device="cpu")
    assert cal.n_dropped == 0
    assert cal.loss_after < 1e-6 < cal.loss_before
    assert cal.param_rel_error(gpu_t, st_t) < RECOVERY_RTOL
    for name in cal.stencils:
        assert cal.errors_after[name] < cal.errors_before[name]


def test_synthetic_records_match_reference():
    gpu_t, st_t = _truth(with_c_iter, with_machine_params, MAXWELL_GPU, STENCILS)
    jg, js = _truth(j_with_c_iter, j_with_machine_params, J_GPU, J_STENCILS)
    ours = [r.to_json() for r in synthetic_records(gpu_t, st_t, noise=0.05, seed=3)]
    ref = [r.to_json() for r in j_synthetic_records(jg, js, noise=0.05, seed=3)]
    assert ours == ref


def test_fit_drops_infeasible_records_and_requires_some():
    recs = synthetic_records(MAXWELL_GPU)[:12]
    bad = MeasurementRecord(
        stencil="heat2d", size=(64, 64, 1, 4), tiles=(8, 33, 2, 1, 1),
        time_s=1.0, hw=(16.0, 128.0, 96.0),
    )
    assert not np.isfinite(predicted_times([bad], MAXWELL_GPU)[0])
    cal = fit_machine_params(recs + [bad], gpu0=MAXWELL_GPU, iters=5, device="cpu")
    assert cal.n_dropped == 1 and cal.n_records == len(recs)
    with pytest.raises(ValueError, match="no measurement records"):
        fit_machine_params([], device="cpu")
    with pytest.raises(ValueError, match="infeasible"):
        fit_machine_params([bad], device="cpu")
    with pytest.raises(ValueError, match="unknown GPU"):
        fit_machine_params(MeasurementRun(recs, "h100", "cuda", False), device="cpu")


def test_measurement_run_payload_round_trips_both_ways():
    rec = MeasurementRecord(
        stencil="jacobi2d", size=(64, 64, 1, 4), tiles=(8, 32, 2, 1, 1),
        time_s=1.25e-3, hw=(16.0, 128.0, 96.0), repeats=3, times_s=(1e-3, 1.25e-3, 2e-3),
    )
    run = MeasurementRun(records=[rec], gpu_name="gtx980", backend="cuda", interpret=False, note="x")
    text = json.dumps(run.to_payload(), sort_keys=True)
    ref = JMeasurementRun.from_payload(json.loads(text))
    assert json.dumps(ref.to_payload(), sort_keys=True) == text
    back = MeasurementRun.from_payload(json.loads(json.dumps(ref.to_payload())))
    assert back.records == run.records and back.note == "x" and back.backend == "cuda"


def test_calibration_payload_round_trips_both_ways(noisy_fits):
    ref, got = noisy_fits
    for cal, other in ((got, JCalibrationResult), (ref, CalibrationResult)):
        text = json.dumps(cal.to_payload(), sort_keys=True)
        assert json.dumps(other.from_payload(json.loads(text)).to_payload(), sort_keys=True) == text
    back = CalibrationResult.from_payload(ref.to_payload())
    assert back.calibrated_gpu().name == "gtx980-cal"
    wl = back.calibrated_workload(["heat2d"])
    assert len(wl.cells) == 16 and wl.cells[0].stencil.c_iter == ref.stencils["heat2d"].c_iter
    with pytest.raises(KeyError, match="not calibrated"):
        back.calibrated_workload(["nosuch"])


def test_measure_one_record_contract_on_cpu():
    rec = measure_one(
        "heat2d", (24, 40), steps=4, tiles={"t_s1": 8, "t_s2": 32, "t_t": 2},
        warmup=1, repeats=2, device="cpu",
    )
    assert rec.stencil == "heat2d" and rec.size == (24, 40, 1, 4)
    assert rec.tiles == (8, 32, 2, 1, 1)
    assert rec.time_s > 0 and len(rec.times_s) == 2
    assert rec.hw == (STOCK_HW["n_sm"], STOCK_HW["n_v"], STOCK_HW["m_sm"])
    assert MeasurementRecord.from_json(rec.to_json()) == rec


def test_measure_grid_stamps_family_and_device():
    run = measure_grid(
        {"heat3d": [{"shape": (8, 9, 10), "steps": 2,
                     "tiles": {"t_s1": 4, "t_s2": 32, "t_t": 2, "t_s3": 4}}]},
        warmup=0, repeats=1, gpu=TITANX_GPU, device="cpu",
    )
    assert run.records[0].hw == (24.0, 128.0, 96.0)
    assert (run.gpu_name, run.backend, run.interpret, run.note) == ("titanx", "cpu", False, "cpu")
    assert stock_hw(MAXWELL_GPU)["n_sm"] == 16.0


def test_entry_points_need_a_device_or_a_card():
    from repro_torch._device import resolve_device

    if torch.cuda.is_available():  # with a card, no device= means the card
        assert resolve_device(None).type == "cuda"
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        measure_one("heat2d", (8, 8), 1, {})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fit_machine_params(synthetic_records(MAXWELL_GPU)[:3], iters=1)


def test_grids_and_feasibility_match_reference():
    for smoke in (True, False):
        ours = default_grid(smoke=smoke)
        ref = j_default_grid(smoke=smoke)
        assert {n: [(tuple(c["shape"]), c["steps"], c["tiles"]) for c in v] for n, v in ours.items()} == {
            n: [(tuple(c["shape"]), c["steps"], c["tiles"]) for c in v] for n, v in ref.items()
        }
    kept = feasible_tiles("heat2d", [
        {"t_s1": 8, "t_s2": 32, "t_t": 2, "k": 1},
        {"t_s1": 8, "t_s2": 33, "t_t": 2, "k": 1},
        {"t_s1": 512, "t_s2": 1024, "t_t": 64, "k": 32},
    ])
    assert kept == [{"t_s1": 8, "t_s2": 32, "t_t": 2, "k": 1, "t_s3": 1}]
