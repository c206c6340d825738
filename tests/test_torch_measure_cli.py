"""The port's ``measure.cli`` (run | fit | build) against the JAX package,
on the CPU (``--device cpu``), and the metrics the port's codesign, sweep
and harness record.

* ``run --device cpu`` times the smoke grid (the reference's grid) and
  stores a measurement stamped ``backend="cpu"``, ``interpret=False``.
* ``fit --synthetic`` recovers the generating machine within
  ``RECOVERY_RTOL`` (the check of ``scripts/measure_smoke.py``).
* ``fit`` reads a measurement that the reference wrote into its store and
  lands within 1e-4 relative of the reference's own fit (the tolerance of
  ``tests/test_torch_measure.py``).
* ``build --engine numpy --downsample 32`` stores a sweep whose served best
  point equals in-process ``codesign`` on the calibrated GPU, exactly.
* An unknown key, a wrong kind, or no card without ``--device`` exits 2.
"""

import re

import numpy as np
import pytest
import torch

import repro.service as RS
from repro.core.timemodel import MAXWELL_GPU as J_GPU
from repro.core.timemodel import STENCILS as J_STENCILS
from repro.core.timemodel import with_c_iter as j_with_c_iter
from repro.core.timemodel import with_machine_params as j_with_machine_params
from repro.measure import MeasurementRun as JMeasurementRun
from repro.measure import fit_machine_params as j_fit
from repro.measure import synthetic_records as j_synthetic_records
from repro.measure.harness import default_grid as j_default_grid
from repro_torch.core import codesign, enumerate_hw_space, paper_workload
from repro_torch.core.timemodel import GPUSpec, StencilSpec
from repro_torch.measure import RECOVERY_RTOL, CalibrationResult, MeasurementRun, measure_one
from repro_torch.measure import cli
from repro_torch.obs import get_registry
from repro_torch.service import ArtifactStore, QueryRequest, server_from_artifact

FIT_RTOL = 1e-4
STRIDE = 32


def _cli(capsys, *argv):
    cli.main(list(argv))
    return capsys.readouterr().out


def _key(out, what):
    m = re.search(rf"{what} ([0-9a-f]{{20}})", out)
    assert m, out
    return m.group(1)


@pytest.fixture(scope="module")
def ref_measurement(tmp_path_factory):
    """A measurement run the reference wrote: its synthetic records (5%
    log-normal noise, numpy seed 7) stored by its own ``put_json``."""
    truth = j_with_machine_params(J_GPU, bw_gmem=150.0e9, launch_overhead=8.0e-6)
    sts = {n: j_with_c_iter(st, st.c_iter * (1.0 + 0.25 * (i + 1)))
           for i, (n, st) in enumerate(J_STENCILS.items())}
    run = JMeasurementRun(j_synthetic_records(truth, sts, noise=0.05, seed=7),
                          gpu_name="gtx980", backend="cpu", interpret=True)
    root = str(tmp_path_factory.mktemp("cli-store"))
    art = RS.ArtifactStore(root).put_json("measurement", run.to_payload(),
                                          routing={"gpu": "gtx980"})
    return root, art.key, run


def test_run_on_cpu_stores_the_smoke_grid(tmp_path, capsys):
    out = _cli(capsys, "run", "--store", str(tmp_path), "--repeats", "1", "--device", "cpu")
    art = ArtifactStore(str(tmp_path)).get(_key(out, "measurement"))
    assert art.kind == "measurement"
    routing = art.routing()
    assert (routing["backend"], routing["interpret"], routing["gpu"]) == ("cpu", False, "gtx980")
    run = MeasurementRun.from_payload(art.payload)
    want = [(n, tuple(c["shape"]), c["steps"]) for n, cfgs in j_default_grid(smoke=True).items()
            for c in cfgs]
    got = [(r.stencil, r.size[:2] if r.size[2] == 1 else r.size[:3], r.size[3]) for r in run.records]
    assert got == want and routing["records"] == len(want)
    assert all(r.time_s > 0 and len(r.times_s) == 1 for r in run.records)
    # the reference reads the port's measurement
    assert JMeasurementRun.from_payload(art.payload).backend == "cpu"


def test_fit_synthetic_recovers_the_generating_machine(tmp_path, capsys):
    out = _cli(capsys, "fit", "--store", str(tmp_path), "--synthetic", "--perturb", "0.5",
               "--device", "cpu")
    art = ArtifactStore(str(tmp_path)).get(_key(out, "calibration"))
    cal = CalibrationResult.from_payload(art.payload)
    truth = art.manifest["extra"]["synthetic_truth"]
    truth_gpu = GPUSpec(**truth["gpu"])
    truth_st = {n: StencilSpec(**d) for n, d in truth["stencils"].items()}
    assert cal.param_rel_error(truth_gpu, truth_st) < RECOVERY_RTOL
    assert cal.loss_after < 1e-6


@pytest.fixture(scope="module")
def fitted(ref_measurement):
    """The port's ``fit`` on the reference-written measurement."""
    root, key, _ = ref_measurement
    cli.main(["fit", "--store", root, "--measurement", key, "--device", "cpu"])
    store = ArtifactStore(root)
    art = cli._latest(store, "calibration")
    return store, art


def test_fit_reads_a_reference_measurement(ref_measurement, fitted):
    _, key, run = ref_measurement
    _, art = fitted
    assert art.routing()["measurement"] == key
    got = CalibrationResult.from_payload(art.payload)
    ref = j_fit(run, gpu0=J_GPU)
    assert got.gpu.bw_gmem == pytest.approx(ref.gpu.bw_gmem, rel=FIT_RTOL)
    assert got.gpu.launch_overhead == pytest.approx(ref.gpu.launch_overhead, rel=FIT_RTOL)
    for name, st in ref.stencils.items():
        assert got.stencils[name].c_iter == pytest.approx(st.c_iter, rel=FIT_RTOL), name
    assert got.loss_after < got.loss_before


def test_build_numpy_serves_the_in_process_best_point(fitted, capsys):
    store, cal_art = fitted
    out = _cli(capsys, "build", "--store", store.root, "--calibration", cal_art.key,
               "--engine", "numpy", "--downsample", str(STRIDE), "--device", "cpu")
    art = store.get(_key(out, "calibrated sweep"))
    assert art.routing()["calibration"] == cal_art.key
    assert art.routing()["gpu"] == "gtx980-cal" and art.routing()["engine"] == "numpy"
    cal = CalibrationResult.from_payload(cal_art.payload)
    hw = enumerate_hw_space().downsample(STRIDE)
    res = codesign(cal.calibrated_workload(), gpu=cal.calibrated_gpu(), hw=hw, engine="numpy")
    srv = server_from_artifact(store, art, batch_window=0.0)
    for max_area in (np.inf, 450.0):
        resp = srv.query(QueryRequest(max_area=max_area))
        assert (resp.best_index, resp.best_gflops) == res.best(max_area=max_area)


def test_unknown_key_and_wrong_kind_exit_2(fitted, capsys):
    store, cal_art = fitted
    for argv in (["fit", "--measurement", "nosuch"], ["build", "--calibration", "nosuch"],
                 ["fit", "--measurement", cal_art.key]):
        with pytest.raises(SystemExit) as exc:
            cli.main(argv + ["--store", store.root, "--device", "cpu"])
        assert exc.value.code == 2
        err = capsys.readouterr().err
        assert err.startswith("error: ") and len(err.strip().splitlines()) == 1


def test_no_card_without_device_exits_2(tmp_path, capsys, monkeypatch):
    """Without a card and without --device, run and fit refuse to run on
    the CPU, and store nothing."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for argv in (["run"], ["fit", "--synthetic"]):
        with pytest.raises(SystemExit) as exc:
            cli.main(argv + ["--store", str(tmp_path)])
        assert exc.value.code == 2
        assert "--device cpu" in capsys.readouterr().err
    assert ArtifactStore(str(tmp_path)).keys() == []


def _total(name, **labels):
    fam = get_registry().snapshot().get(name, {"samples": []})
    return sum(s.get("value", s.get("count", 0)) for s in fam["samples"]
               if all(s["labels"].get(k) == v for k, v in labels.items()))


def test_codesign_sweep_and_measurement_move_their_metrics():
    wl, hw = paper_workload(["heat2d"]), enumerate_hw_space().downsample(512)
    before = {
        "cs": _total("repro_codesign_seconds", engine="numpy", family="stencil"),
        "cells": _total("repro_codesign_cells_total", engine="numpy"),
        "evals": _total("repro_sweep_cell_evals_total", engine="numpy"),
        "t_evals": _total("repro_sweep_cell_evals_total", engine="torch"),
        "disp": _total("repro_sweep_dispatch_seconds", engine="torch"),
        "pts": _total("repro_measure_points_total", stencil="heat2d"),
        "pt_s": _total("repro_measure_point_seconds"),
    }
    codesign(wl, hw=hw, engine="numpy")
    codesign(wl, hw=hw, engine="torch", device="cpu")
    measure_one("heat2d", (24, 40), 2, {"t_s1": 8, "t_s2": 32, "t_t": 2}, warmup=0, repeats=1,
                device="cpu")
    c, h = len(wl.cells), len(hw)
    assert _total("repro_codesign_seconds", engine="numpy", family="stencil") == before["cs"] + 1
    assert _total("repro_codesign_cells_total", engine="numpy") == before["cells"] + c
    assert _total("repro_sweep_cell_evals_total", engine="numpy") == before["evals"] + c * h
    assert _total("repro_sweep_cell_evals_total", engine="torch") == before["t_evals"] + c * h
    assert _total("repro_sweep_dispatch_seconds", engine="torch") == before["disp"] + 1
    assert _total("repro_measure_points_total", stencil="heat2d") == before["pts"] + 1
    assert _total("repro_measure_point_seconds") == before["pt_s"] + 1
