"""The analytic LM roofline and the eq.-18 mesh optimizer on the port
(``repro_torch.core.{lmtime,meshopt}``), against the JAX package's.

* The reference's own tests (``tests/test_meshopt.py``), run on the port
  with the port's meta-device parameter counts.
* Against the reference, with the same inputs: every ``lm_roofline`` term
  over seeded plans for every registered architecture and shape, and the
  ranked plans of ``optimize``/``pareto_plans``, are equal exactly; ``HW``
  is the reference's dict.
"""

import dataclasses

import numpy as np
import pytest

import repro.configs as RC
import repro.core.lmtime as RL
import repro.core.meshopt as RM
from repro.models.model import active_params as r_active_params
from repro.models.model import count_params as r_count_params
from repro_torch.configs import SHAPES, get_arch, list_archs
from repro_torch.core.lmtime import HW, MeshPlan, lm_roofline
from repro_torch.core.meshopt import enumerate_plans, optimize, pareto_plans
from repro_torch.models import active_params, count_params


def _cell(arch, shape):
    cfg = get_arch(arch)
    return cfg, SHAPES[shape], count_params(cfg), active_params(cfg)


def test_roofline_terms_positive_and_bounded():
    cfg, shape, n, na = _cell("llama3-8b", "train_4k")
    r = lm_roofline(cfg, shape, MeshPlan(1, 16, 16, 8, "full", False), n, na)
    assert r["compute_s"] > 0 and r["memory_s"] > 0 and r["collective_s"] > 0
    ideal = 6 * na * shape.tokens / (256 * HW["peak_flops_bf16"])
    assert r["compute_s"] >= ideal * 0.99


def test_fsdp_required_for_huge_models():
    cfg, shape, n, na = _cell("deepseek-v3-671b", "train_4k")
    no = lm_roofline(cfg, shape, MeshPlan(1, 16, 16, 32, "full", False), n, na)
    yes = lm_roofline(cfg, shape, MeshPlan(1, 16, 16, 32, "full", True), n, na)
    assert not no["fits"]
    assert yes["hbm_bytes"] < no["hbm_bytes"]


def test_compression_reduces_collective_term():
    cfg, shape, n, na = _cell("llama3-8b", "train_4k")
    plain = lm_roofline(cfg, shape, MeshPlan(2, 8, 16, 8, "full", False, False), n, na)
    comp = lm_roofline(cfg, shape, MeshPlan(2, 8, 16, 8, "full", False, True), n, na)
    assert comp["collective_s"] < plain["collective_s"]


def test_optimize_returns_feasible_sorted():
    cfg, shape, n, na = _cell("llama3-8b", "train_4k")
    plans = optimize(cfg, shape, n, na, chips=256, top_k=8)
    assert plans
    bounds = [p["bound_s"] for p in plans]
    assert bounds == sorted(bounds)
    for p in plans:
        assert p["fits"]
        mp = p["plan"]
        assert mp["pod"] * mp["data"] * mp["model"] == 256


def test_enumerate_respects_multipod():
    plans = enumerate_plans(512, multi_pod=True, train=False)
    assert all(p.pod == 2 for p in plans)
    assert all(p.chips == 512 for p in plans)


def test_pareto_plans_monotone():
    cfg, shape, n, na = _cell("internlm2-1.8b", "train_4k")
    all_results = []
    for chips in (64, 128, 256):
        all_results += optimize(cfg, shape, n, na, chips=chips, top_k=3)
    front = pareto_plans(all_results)
    bounds = [r["bound_s"] for r in front]
    assert bounds == sorted(bounds, reverse=True)


def test_hw_is_the_references():
    assert HW == RL.HW


def _seeded_plans(seed, n=12):
    rng = np.random.default_rng(seed)
    pows = [1, 2, 4, 8, 16, 32]
    return [
        (int(rng.choice([1, 2])), int(rng.choice(pows)), int(rng.choice(pows)),
         int(rng.choice(pows)), str(rng.choice(["none", "full"])), bool(rng.integers(2)),
         bool(rng.integers(2)))
        for _ in range(n)
    ]


@pytest.mark.parametrize("name", list_archs())
def test_roofline_terms_equal_the_references(name):
    cfg, ref = get_arch(name), RC.get_arch(name)
    n, na = count_params(cfg), active_params(cfg)
    assert (n, na) == (r_count_params(ref), r_active_params(ref))
    for shape in SHAPES:
        for p in _seeded_plans(sum(map(ord, name + shape))):
            got = lm_roofline(cfg, SHAPES[shape], MeshPlan(*p), n, na)
            want = RL.lm_roofline(ref, RC.SHAPES[shape], RL.MeshPlan(*p), n, na)
            assert got == want, (name, shape, p)


@pytest.mark.parametrize("arch,shape,chips,multi_pod", [
    ("llama3-8b", "train_4k", 256, False),
    ("mixtral-8x22b", "decode_32k", 512, True),
    ("mamba2-780m", "long_500k", 64, False),
])
def test_optimize_equals_the_references(arch, shape, chips, multi_pod):
    cfg, ref = get_arch(arch), RC.get_arch(arch)
    n, na = count_params(cfg), active_params(cfg)
    got = optimize(cfg, SHAPES[shape], n, na, chips=chips, multi_pod=multi_pod, top_k=10)
    want = RM.optimize(ref, RC.SHAPES[shape], n, na, chips=chips, multi_pod=multi_pod, top_k=10)
    assert got == want
    assert pareto_plans(got) == RM.pareto_plans(want)
    assert [dataclasses.asdict(p) for p in enumerate_plans(chips, multi_pod)] == [
        dataclasses.asdict(p) for p in RM.enumerate_plans(chips, multi_pod)
    ]
