"""LM op-graph cells on the port (``repro_torch.core.lmcells``), against the
JAX package's.

* The reference's own tests (``tests/test_lmcells.py``), run on the port:
  the numpy engine bit-exact against the scalar oracle, the oracle term for
  term against ``lm_roofline``, family dispatch through ``codesign()``,
  mixed families rejected, ``plan_for``, the artifact round trip and key
  stability, divisibility infeasibility. Its jax-engine test becomes the
  torch engine's: on the CPU it equals the numpy engine bit for bit (times
  and plan indices).
* Against the reference, on the same inputs: the cells' constants, the
  numpy matrices (times and plans) and every scalar-oracle term are equal
  exactly, on reduced models and on the full-size default workload at 512
  chips and the docs' 64-chip question.
* Engines: ``auto|torch|numpy``, auto by the stencil rule (numpy below 64
  hardware points); ``"jax"``/``"sharded"`` raise; without a card and
  without ``device="cpu"`` the torch engine raises.
"""

import dataclasses

import numpy as np
import pytest
import torch

import repro.configs as RC
import repro.core.lmcells as R
from repro.core.lmtime import MeshPlan as RMeshPlan
from repro_torch.configs import ShapeSpec, get_arch
from repro_torch.core.codesign import codesign
from repro_torch.core.lmcells import (
    LM_GPU_NAME,
    enumerate_lm_hw_space,
    lm_cell_roofline,
    lm_codesign,
    lm_sw_lattice,
    lm_workload,
    resolve_lm_engine,
)
from repro_torch.core.lmtime import MeshPlan, lm_roofline
from repro_torch.core.workload import Workload, paper_workload
from repro_torch.service.store import ArtifactStore

PAIR = ("llama3-8b", "mixtral-8x22b")


@pytest.fixture(scope="module")
def cfgs():
    """Reduced same-family variants; mixtral brings the MoE dispatch op."""
    return [get_arch(a).reduced() for a in PAIR]


@pytest.fixture(scope="module")
def wl(cfgs):
    return lm_workload(archs=cfgs, name="lm-test")


@pytest.fixture(scope="module")
def hw():
    return enumerate_lm_hw_space(max_chips=32)


@pytest.fixture(scope="module")
def oracle(wl, hw):
    return lm_codesign(wl, hw=hw, engine="numpy")


def _brute_force(cell, lat, point):
    times = []
    for j in range(len(lat)):
        plan = lat.plan(point["pod"], point["data"], point["model"], j)
        r = lm_cell_roofline(cell, plan)
        times.append(r["bound_s"] if r["feasible"] else np.inf)
    return times


def test_workload_shape(wl):
    assert wl.family == "lm"
    assert {c.op for c in wl.cells} == {"prefill", "decode", "train", "moe_dispatch"}
    assert len(wl.cells) == 7
    np.testing.assert_allclose(sum(c.freq for c in wl.cells), 1.0)
    for c in wl.cells:
        assert (c.kv_bytes > 0) == (c.op == "decode")


def test_numpy_engine_is_bit_exact_vs_scalar_oracle(wl, hw, oracle):
    for ci, cell in enumerate(wl.cells):
        lat = lm_sw_lattice(cell.op)
        for hi in range(len(hw)):
            times = _brute_force(cell, lat, hw.point(hi))
            t = min(times)
            if np.isfinite(t):
                assert oracle.cell_time[ci, hi] == t, (cell.label, hi)
                j = int(oracle.cell_plan_idx[ci, hi])
                assert times[j] == t
            else:
                assert oracle.cell_time[ci, hi] == np.inf
                assert oracle.cell_plan_idx[ci, hi] == -1


def test_scalar_oracle_mirrors_lm_roofline(cfgs, wl):
    by_model = {c.name: c for c in cfgs}
    plans = [
        MeshPlan(1, 2, 2),
        MeshPlan(1, 1, 8, microbatches=2, remat="none"),
        MeshPlan(2, 4, 2, microbatches=4, remat="full", fsdp=True, compress_grads=True),
    ]
    checked = 0
    for cell in wl.cells:
        if cell.op == "moe_dispatch":
            continue
        cfg = by_model[cell.model]
        for plan in plans:
            a = lm_cell_roofline(cell, plan)
            b = lm_roofline(cfg, cell.shape, plan, cell.n_params, cell.n_active)
            for key in ("compute_s", "memory_s", "collective_s", "bound_s", "hbm_bytes"):
                assert a[key] == b[key], (cell.label, plan, key)
            assert a["dominant"] == b["dominant"]
            assert a["fits"] == b["fits"]
            checked += 1
    assert checked == 6 * len(plans)


def test_torch_engine_on_the_cpu_is_bit_identical_to_numpy(wl, hw, oracle):
    res = lm_codesign(wl, hw=hw, engine="torch", device="cpu")
    np.testing.assert_array_equal(res.cell_time, oracle.cell_time)
    np.testing.assert_array_equal(res.cell_plan_idx, oracle.cell_plan_idx)


@pytest.mark.parametrize("archs,chips", [(PAIR, 512), (("llama3-8b",), 64)])
def test_full_size_engines_equal_the_reference(archs, chips):
    """The default question (7 cells, 512 chips, 100 mesh points) and the
    docs' (Llama-3-8B, 64 chips, 49 points): the port's numpy and torch
    engines give the reference's numpy matrices exactly."""
    wl, rwl = lm_workload(archs=archs), R.lm_workload(archs=archs)
    for c, rc in zip(wl.cells, rwl.cells):
        assert c.label == rc.label and c.consts() == rc.consts() and c.freq == rc.freq
    hw, rhw = enumerate_lm_hw_space(chips), R.enumerate_lm_hw_space(chips)
    np.testing.assert_array_equal(hw.area, rhw.area)
    ref = R.lm_codesign(rwl, hw=rhw, engine="numpy")
    for engine, kw in (("numpy", {}), ("torch", {"device": "cpu"})):
        res = lm_codesign(wl, hw=hw, engine=engine, **kw)
        np.testing.assert_array_equal(res.cell_time, ref.cell_time)
        np.testing.assert_array_equal(res.cell_plan_idx, ref.cell_plan_idx)
    if archs == ("llama3-8b",):
        f = np.array([1.0 if c.op == "decode" else 0.0 for c in wl.cells])
        with np.errstate(invalid="ignore"):  # 0 x inf of a zero-weighted cell is NaN
            g = res.gflops(f)
        i = int(np.argmax(np.where(np.isfinite(g), g, -np.inf)))
        assert hw.point(i) == {"pod": 1, "data": 4, "model": 16, "chips": 64}


def test_scalar_oracle_terms_equal_the_reference(wl):
    rcells = R.lm_workload(archs=[RC.get_arch(a).reduced() for a in PAIR], name="lm-test").cells
    plans = [(1, 2, 2, 1, "full", False, False), (2, 4, 2, 4, "none", True, True),
             (1, 8, 4, 2, "full", True, False)]
    for cell, rcell in zip(wl.cells, rcells):
        for p in plans:
            assert lm_cell_roofline(cell, MeshPlan(*p)) == R.lm_cell_roofline(rcell, RMeshPlan(*p))


def test_engine_resolution():
    assert resolve_lm_engine("numpy", 100) == "numpy"
    assert resolve_lm_engine("torch", 10) == "torch"
    assert resolve_lm_engine("auto", 63) == "numpy"
    assert resolve_lm_engine("auto", 64) == "torch"
    for name in ("cuda", "jax", "sharded"):
        with pytest.raises(ValueError, match="unknown engine"):
            resolve_lm_engine(name, 100)


def test_torch_engine_needs_a_card_or_cpu(wl, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    big = enumerate_lm_hw_space(max_chips=512)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        lm_codesign(wl, hw=big, engine="torch")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        lm_codesign(wl, hw=big)  # auto at 100 points: torch, on the card
    with pytest.raises(RuntimeError, match="no CUDA device"):
        codesign(wl, hw=big)
    assert lm_codesign(wl, hw=enumerate_lm_hw_space(max_chips=32)).cell_time.shape[1] == 36


def test_codesign_dispatches_on_family(wl, hw, oracle):
    res = codesign(wl, hw=hw, engine="numpy")
    assert type(res).__name__ == "LMCodesignResult"
    assert np.array_equal(res.cell_time, oracle.cell_time)
    assert np.array_equal(res.cell_plan_idx, oracle.cell_plan_idx)
    res = codesign(wl, hw=hw, engine="torch", device="cpu")
    assert np.array_equal(res.cell_time, oracle.cell_time)


def test_mixed_family_workload_rejected(wl):
    halved = [dataclasses.replace(c, freq=c.freq / 2) for c in (*paper_workload().cells, *wl.cells)]
    with pytest.raises(ValueError, match="famil"):
        Workload(name="mixed", cells=tuple(halved))


def test_plan_for_round_trips(wl, hw, oracle):
    ci = next(i for i, c in enumerate(wl.cells) if c.op == "train")
    hi = int(np.nonzero(np.isfinite(oracle.cell_time[ci]))[0][-1])
    plan = oracle.plan_for(ci, hi)
    r = lm_cell_roofline(wl.cells[ci], plan)
    assert r["feasible"]
    assert r["bound_s"] == oracle.cell_time[ci, hi]


def test_artifact_round_trip_bit_identity(tmp_path, wl, hw, oracle):
    store = ArtifactStore(str(tmp_path))
    art = store.put(oracle, engine="numpy")
    assert art.key == store.key_for_lm(wl, hw, engine="numpy")
    assert art.family == "lm"
    assert store.put(oracle, engine="numpy").key == art.key

    back = art.to_result()
    assert type(back).__name__ == "LMCodesignResult"
    assert np.array_equal(back.cell_time, oracle.cell_time)
    assert np.array_equal(back.cell_plan_idx, oracle.cell_plan_idx)
    assert back.gpu_name == oracle.gpu_name == LM_GPU_NAME
    assert [c.label for c in back.workload.cells] == [c.label for c in wl.cells]
    np.testing.assert_array_equal(back.cell_freqs(), oracle.cell_freqs())
    np.testing.assert_array_equal(back.cell_flops(), oracle.cell_flops())
    for ci in range(len(wl.cells)):
        hi = int(np.nonzero(np.isfinite(oracle.cell_time[ci]))[0][0])
        assert back.plan_for(ci, hi) == oracle.plan_for(ci, hi)

    md = art.routing()
    assert md["workload"] == "lm-test" and md["family"] == "lm"
    assert md["models"] == sorted({c.model for c in wl.cells})
    assert md["ops"] == ["decode", "moe_dispatch", "prefill", "train"]
    np.testing.assert_array_equal(art.hw_area, art.hw_column("chips"))


def test_key_tracks_the_question(tmp_path, wl, cfgs, hw):
    store = ArtifactStore(str(tmp_path))
    base = store.key_for_lm(wl, hw, engine="numpy")
    assert store.key_for_lm(wl, hw, engine="numpy") == base
    assert store.key_for_lm(wl, enumerate_lm_hw_space(max_chips=16), engine="numpy") != base
    assert store.key_for_lm(lm_workload(archs=cfgs[:1], name="lm-test"), hw, engine="numpy") != base
    assert store.key_for_lm(wl, hw, engine="numpy", gpu_name="other") != base
    # the torch matrix keys apart from numpy's and the reference's jax's
    assert len({store.key_for_lm(wl, hw, engine=e) for e in ("numpy", "torch", "jax")}) == 3
    assert store.key_for_lm(wl, hw, engine="sharded") == store.key_for_lm(wl, hw, engine="jax")
    assert store.key_for_lm(wl, hw, engine="auto") == base  # 36 points: numpy


def test_divisibility_infeasibility(cfgs, hw):
    shape = ShapeSpec("decode_b3", 1024, 3, "decode")  # 3 never splits
    wl3 = lm_workload(archs=cfgs[:1], name="gb3", shapes={"decode": shape})
    for engine, kw in (("numpy", {}), ("torch", {"device": "cpu"})):
        res = lm_codesign(wl3, hw=hw, engine=engine, **kw)
        ci = next(i for i, c in enumerate(wl3.cells) if c.op == "decode")
        ds = (hw.pod * hw.data).astype(int)
        bad = (3 % ds != 0) & (3 >= ds)
        assert np.all(~np.isfinite(res.cell_time[ci][bad]))
        assert np.all(res.cell_plan_idx[ci][bad] == -1)
