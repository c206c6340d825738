"""The hand-written CUDA kernels against their plain versions, on the card.

Every test here needs an NVIDIA GPU and carries the ``cuda`` marker; the
``card`` fixture skips it, with a reason, where there is none (it decides
inside the fixture, never while the module is imported). Run them on the
card with ``python -m pytest -m cuda tests/test_torch_cuda.py``.

The kernels are built with ``--fmad=false`` and keep the plain versions'
operation order, so f32 results are expected to match bit for bit; the
asserted tolerances are still the reference's (1e-5, rtol 1e-4 with the
field-magnitude slack for multi-step runs, 2e-2 for bf16)."""

import pytest
import torch

from repro_torch.kernels import _build, ops, tiled_stencils as ts
from repro_torch.kernels.stencil_common import step_plain

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _rand(shape, dtype, card, seed=0):
    g = torch.Generator(device=card).manual_seed(seed)
    return torch.randn(shape, generator=g, device=card).to(dtype)


def _tol(dtype):
    return dict(rtol=2e-2, atol=2e-2) if dtype == torch.bfloat16 else dict(rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", list(ops.KERNELS))
def test_step_kernel_matches_plain(card, name, dtype):
    m = ops.KERNELS[name]
    for shape in ([(5, 7), (33, 257), (128, 384)] if m.DIMS == 2 else [(12, 12, 12), (17, 9, 33)]):
        x = _rand(shape, dtype, card)
        for br in (1, 3, 64):
            before = _build.LAUNCHES["step%dd" % m.DIMS]
            got = ops.stencil_step(name, x, block_rows=br)
            assert _build.LAUNCHES["step%dd" % m.DIMS] == before + 1
            want = step_plain(x, m.update, m.HALO)
            torch.cuda.synchronize()
            assert got.dtype == dtype
            torch.testing.assert_close(got.float(), want.float(), **_tol(dtype))


@pytest.mark.parametrize("name", list(ops.KERNELS))
def test_tiled_kernel_matches_plain(card, name):
    m = ops.KERNELS[name]
    shape = (37, 53) if m.DIMS == 2 else (11, 13, 17)
    grid = (
        [{"t_s1": 1, "t_s2": 32, "t_t": 2}, {"t_s1": 16, "t_s2": 128, "t_t": 8},
         {"t_s1": 64, "t_s2": 1024, "t_t": 2}]
        if m.DIMS == 2 else
        [{"t_s1": 1, "t_s2": 32, "t_t": 2, "t_s3": 1}, {"t_s1": 8, "t_s2": 64, "t_t": 4, "t_s3": 8},
         {"t_s1": 32, "t_s2": 256, "t_t": 6, "t_s3": 4}]
    )
    x = _rand(shape, torch.float32, card, seed=1)
    for tiles in grid:
        t = ts.normalize_tiles(tiles)
        got = ts.run_tiled(name, x, steps=5, tiles=tiles)
        want = ts.run_tiled_plain(name, x, 5, t)
        torch.cuda.synchronize()
        scale = max(1.0, float(want.abs().max()))
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4 * scale)


def test_tiled_bf16_and_launch_count(card):
    x = _rand((24, 40), torch.bfloat16, card, seed=3)
    before = _build.LAUNCHES["tiled2d"]
    got = ts.run_tiled("heat2d", x, steps=3, tiles={"t_s1": 8, "t_s2": 32, "t_t": 2})
    assert _build.LAUNCHES["tiled2d"] == before + 2  # passes of 2 and 1 steps
    want = ts.run_tiled_plain("heat2d", x, 3, ts.normalize_tiles({"t_s1": 8, "t_s2": 32, "t_t": 2}))
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16
    torch.testing.assert_close(got.float(), want.float(), rtol=2e-2, atol=2e-2)


#: K1/K2 edge cases: t_s1 = 1 strips and t_s1 >= s1, last passes shorter
#: than t_t, windows clipped at both ends of an axis, 1024 threads for
#: windows wider than 1024, widths that are not multiples of 4 (unaligned
#: row heads and tails), bf16 in 3-D
EDGE_CASES = [
    ("jacobi2d", (45, 131), 5, {"t_s1": 1, "t_s2": 32, "t_t": 2}, torch.float32),
    ("heat2d", (37, 53), 7, {"t_s1": 64, "t_s2": 64, "t_t": 3}, torch.float32),
    ("gradient2d", (40, 2100), 3, {"t_s1": 4, "t_s2": 1024, "t_t": 2}, torch.float32),
    ("laplacian2d", (33, 1030), 4, {"t_s1": 8, "t_s2": 1024, "t_t": 3}, torch.float32),
    ("heat2d", (29, 1027), 3, {"t_s1": 16, "t_s2": 1024, "t_t": 2}, torch.bfloat16),
    ("heat3d", (9, 21, 23), 5, {"t_s1": 1, "t_s2": 32, "t_t": 2, "t_s3": 4}, torch.float32),
    ("laplacian3d", (11, 13, 17), 5, {"t_s1": 16, "t_s2": 32, "t_t": 3, "t_s3": 32}, torch.float32),
    ("heat3d", (20, 70, 37), 6, {"t_s1": 8, "t_s2": 64, "t_t": 4, "t_s3": 8}, torch.float32),
    ("heat3d", (6, 1030, 7), 2, {"t_s1": 2, "t_s2": 1024, "t_t": 2, "t_s3": 2}, torch.float32),
    ("laplacian3d", (17, 9, 33), 3, {"t_s1": 4, "t_s2": 32, "t_t": 2, "t_s3": 8}, torch.bfloat16),
    ("heat3d", (12, 40, 30), 5, {"t_s1": 3, "t_s2": 16, "t_t": 3, "t_s3": 5}, torch.bfloat16),
]


@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("name, shape, steps, tiles, dtype", EDGE_CASES)
def test_tiled_edge_cases_match_plain(card, name, shape, steps, tiles, dtype, offset):
    """``offset`` 1 starts the input one element past an allocation's
    start, off the 16-byte grid of the vector staging."""
    x = _rand(shape, dtype, card, seed=4)
    if offset:
        y = torch.empty(x.numel() + offset, device=card, dtype=dtype)[offset:].view(shape)
        x = y.copy_(x)
    got = ts.run_tiled(name, x, steps=steps, tiles=tiles)
    want = ts.run_tiled_plain(name, x, steps, ts.normalize_tiles(tiles))
    torch.cuda.synchronize()
    assert got.dtype == dtype
    if dtype == torch.bfloat16:
        torch.testing.assert_close(got.float(), want.float(), rtol=2e-2, atol=2e-2)
    else:
        scale = max(1.0, float(want.abs().max()))
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4 * scale)


@pytest.mark.parametrize("name", ["jacobi2d", "heat2d", "laplacian2d", "gradient2d"])
def test_tiled_2d_analytic_optimum_at_4096(card, name):
    """One full pass of the stock-point analytic optimum's time tile on
    4096^2, as the codesign path runs it."""
    import numpy as np

    from repro_torch.core.solver import LATTICE_2D, decode_index, solve_cell
    from repro_torch.core.timemodel import MAXWELL_GPU, STENCILS, ProblemSize

    stock = (np.array([16.0]), np.array([128.0]), np.array([96.0]))
    _, idx = solve_cell(STENCILS[name], MAXWELL_GPU, ProblemSize(4096, 4096, 1024), *stock, LATTICE_2D)
    tiles = decode_index(LATTICE_2D, int(idx[0]))
    t = ts.normalize_tiles(tiles)
    x = _rand((4096, 4096), torch.float32, card, seed=5)
    got = ts.run_tiled(name, x, steps=t[2], tiles=tiles)
    want = ts.run_tiled_plain(name, x, t[2], t)
    torch.cuda.synchronize()
    scale = max(1.0, float(want.abs().max()))
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4 * scale)


def test_oversized_window_raises_before_launch(card):
    x = _rand((64, 128, 128), torch.float32, card)
    before = dict(_build.LAUNCHES)
    with pytest.raises(ValueError, match="shared memory"):
        ts.run_tiled("heat3d", x, steps=16, tiles={"t_s1": 8, "t_s2": 64, "t_t": 16, "t_s3": 2})
    assert _build.LAUNCHES == before


def test_wrappers_refuse_unsupported_input(card):
    with pytest.raises(TypeError, match="dtype"):
        ops.stencil_step("heat2d", torch.zeros(8, 8, device=card, dtype=torch.float64))
    with pytest.raises(ValueError, match="contiguous"):
        ops.stencil_step("heat2d", torch.zeros(8, 16, device=card)[:, ::2])


def _chip_smoke():
    import importlib.util
    import pathlib

    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_server_builds_torch_sweep_on_the_card(card, tmp_path):
    """A ``CodesignServer`` with ``engine="torch"`` builds its artifact on
    the card (the miss path); per cell, best point and Pareto front it
    agrees with an ``engine="numpy"`` server under the tie-aware RTOL 1e-5
    check of ``chip_smoke._tie_check``."""
    import numpy as np

    from repro_torch.core import enumerate_hw_space
    from repro_torch.core.timemodel import MAXWELL_GPU
    from repro_torch.service import ArtifactStore, CodesignServer, QueryRequest

    rtol = 1e-5
    hw = enumerate_hw_space().downsample(32)
    store = ArtifactStore(str(tmp_path))
    srv = CodesignServer(store, hw=hw, engine="torch", batch_window=0.0)
    ref = CodesignServer(store, hw=hw, engine="numpy", batch_window=0.0)
    got_resp, want_resp = srv.query(QueryRequest(pareto=True)), ref.query(QueryRequest(pareto=True))
    assert srv.stats["artifact_builds"] == 1 and srv.key != ref.key
    got, want = store.get(srv.key).to_result(), store.get(ref.key).to_result()
    tie_check = _chip_smoke()._tie_check
    for ci, cell in enumerate(want.workload.cells):
        tie_check(cell.stencil, MAXWELL_GPU, cell.size, want.lattices[ci], hw,
                  want.cell_time[ci], want.cell_tile_idx[ci], got.cell_time[ci],
                  got.cell_tile_idx[ci], rtol)
    g = want.gflops()  # the oracle's numbers judge both answers
    assert got_resp.best_gflops == pytest.approx(want_resp.best_gflops, rel=rtol)
    assert g[got_resp.best_index] >= g[want_resp.best_index] * (1 - rtol)
    # a point on one front and not the other is a tie within rtol
    front_got, front_want = set(got_resp.pareto_indices), set(want_resp.pareto_indices)
    for extra, other in ((front_got - front_want, front_want), (front_want - front_got, front_got)):
        for i in extra:
            assert any(hw.area[j] <= hw.area[i] and g[j] >= g[i] * (1 - rtol) for j in other), i


@pytest.mark.parametrize("k", [1, 2, 3])
def test_portfolio_torch_engine_on_the_card(card, k):
    """The torch portfolio engine on the card against the numpy oracle on
    the same matrix (a torch sweep of 641 points, stride 8): the float64
    dominance mask is the oracle's exactly, and each fleet is the oracle's
    or, on a tie to the last bits of float64, equal in objective within
    1e-12. The torch engine is the default; the oracle is asked for."""
    import numpy as np

    from repro_torch.core import codesign, enumerate_hw_space, paper_workload
    from repro_torch.core.portfolio import (
        OBJECTIVES,
        optimize_portfolio,
        portfolio_candidates,
    )

    res = codesign(paper_workload(), hw=enumerate_hw_space().downsample(8), engine="torch")
    mask = portfolio_candidates(res.hw.area, res.cell_time)
    np.testing.assert_array_equal(portfolio_candidates(res.hw.area, res.cell_time, device=card), mask)
    for objective in OBJECTIVES:
        for budget in (450.0, 900.0):
            want = optimize_portfolio(res, k, budget, objective=objective, engine="numpy")
            got = optimize_portfolio(res, k, budget, objective=objective)
            assert got.candidates == want.candidates == tuple(np.nonzero(mask)[0])
            if got.members == want.members:
                assert got.payload() == {**want.payload(), "engine": "torch"}
            else:
                attr = "fleet_density" if objective == "density" else "fleet_gflops"
                assert getattr(got, attr) == pytest.approx(getattr(want, attr), rel=1e-12)


@pytest.mark.parametrize("chips", [64, 512])
def test_lm_codesign_torch_engine_on_the_card(card, chips):
    """The LM sweep's torch engine in float64 on the card against the numpy
    oracle (the default workload): times within 1e-12 relative, plan
    indices equal but where the oracle's row ties them."""
    import numpy as np

    from repro_torch.core.lmcells import (
        enumerate_lm_hw_space,
        lm_cell_roofline,
        lm_codesign,
        lm_sw_lattice,
        lm_workload,
    )

    wl, hw = lm_workload(), enumerate_lm_hw_space(chips)
    want = lm_codesign(wl, hw=hw, engine="numpy")
    got = lm_codesign(wl, hw=hw, engine="torch")
    feas = np.isfinite(want.cell_time)
    np.testing.assert_array_equal(np.isfinite(got.cell_time), feas)
    np.testing.assert_allclose(got.cell_time[feas], want.cell_time[feas], rtol=1e-12, atol=0)
    for ci, hi in zip(*np.nonzero(got.cell_plan_idx != want.cell_plan_idx)):
        cell, p = wl.cells[ci], hw.point(int(hi))
        plan = lm_sw_lattice(cell.op).plan(p["pod"], p["data"], p["model"], int(got.cell_plan_idx[ci, hi]))
        assert lm_cell_roofline(cell, plan)["bound_s"] == pytest.approx(want.cell_time[ci, hi], rel=1e-12)


def test_lm_model_materialises_on_the_card(card):
    """A reduced model's parameter tree on the card, drawn from a seeded
    CUDA generator: every parameter finite and on the card, the same
    values from the same seed, and the bytes its count predicts."""
    from repro_torch.configs import get_arch
    from repro_torch.models import Model, count_params

    for name in ("llama3-8b", "deepseek-v3-671b", "jamba-v0.1-52b", "whisper-medium"):
        cfg = get_arch(name).reduced()
        a = Model(cfg, generator=torch.Generator(device=card).manual_seed(3))
        b = Model(cfg, generator=torch.Generator(device=card).manual_seed(3))
        pb = dict(b.named_parameters())
        n = 0
        for key, p in a.named_parameters():
            assert p.is_cuda and bool(torch.isfinite(p).all()), (name, key)
            assert torch.equal(p, pb[key]), (name, key)
            n += p.numel()
        assert n == count_params(cfg)


def _ample(cfg):
    import dataclasses

    return dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=64.0)) \
        if cfg.moe else cfg


def _serve_batch(cfg, device, b=2, s=12):
    g = torch.Generator().manual_seed(5)
    batch = {"tokens": torch.randint(0, cfg.vocab, (b, s), generator=g, dtype=torch.int32)}
    if cfg.frontend or cfg.enc_dec:
        batch["frontend"] = torch.randn((b, cfg.n_frontend_tokens, cfg.d_model), generator=g) * 0.05
    return {k: v.to(device) for k, v in batch.items()}


@pytest.mark.parametrize("name", ["llama3-8b", "mixtral-8x22b", "mamba2-780m", "deepseek-v3-671b",
                                  "whisper-medium", "qwen2-vl-2b"])
def test_reduced_generate_on_the_card_equals_the_cpu(card, name):
    """One seeded tree on the CPU and on the card, f32 without TF32: the
    same greedy tokens, and prefill logits within 1e-4."""
    import copy

    from repro_torch.configs import get_arch
    from repro_torch.models import Model
    from repro_torch.serve import generate, make_prefill

    cfg = _ample(get_arch(name).reduced())
    cpu_model = Model(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    card_model = copy.deepcopy(cpu_model).to(card)
    batch = _serve_batch(cfg, "cpu")
    on_card = {k: v.to(card) for k, v in batch.items()}
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        want = generate(cpu_model, cfg, batch, 5, device="cpu")
        got = generate(card_model, cfg, on_card, 5)
        lw, _ = make_prefill(cfg, max_len=20, device="cpu")(cpu_model, batch)
        lg, caches = make_prefill(cfg, max_len=20)(card_model, on_card)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    assert got.is_cuda and torch.equal(got.cpu(), want)
    torch.testing.assert_close(lg.cpu(), lw, rtol=1e-4, atol=1e-4)
    assert all(t.is_cuda for c in caches["stack"] for part in c.values() for t in part.values())


def test_forward_builds_no_tensor_off_the_card(card):
    """Every tensor the serve steps and a forward make lies on the card,
    and no value is read back to the host (no ``.item()``) on the way."""
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_flatten

    from repro_torch.configs import get_arch
    from repro_torch.models import Model, forward
    from repro_torch.serve import generate

    class Seen(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.devices, self.syncs = set(), []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if "_local_scalar_dense" in str(func):
                self.syncs.append(str(func))
            out = func(*args, **(kwargs or {}))
            self.devices |= {t.device.type for t in tree_flatten(out)[0] if isinstance(t, torch.Tensor)}
            return out

    for name in ("llama3-8b", "mixtral-8x22b", "deepseek-v3-671b", "jamba-v0.1-52b",
                 "whisper-medium", "qwen2-vl-2b"):
        cfg = _ample(get_arch(name).reduced())
        model = Model(cfg, generator=torch.Generator(device=card).manual_seed(1))
        batch = _serve_batch(cfg, card)
        with Seen() as seen, torch.no_grad():
            forward(model, cfg, batch)
            generate(model, cfg, batch, 3)
        assert seen.devices == {"cuda"}, (name, seen.devices)
        assert not seen.syncs, (name, seen.syncs)


def _state_to(state, device):
    """A copy of a train state on ``device``."""
    import copy

    out = {"params": copy.deepcopy(state["params"]).to(device),
           "opt": {"m": {k: v.to(device, copy=True) for k, v in state["opt"]["m"].items()},
                   "v": {k: v.to(device, copy=True) for k, v in state["opt"]["v"].items()},
                   "step": state["opt"]["step"].to(device, copy=True)}}
    if "comp" in state:
        out["comp"] = {k: v.to(device, copy=True) for k, v in state["comp"].items()}
    return out


@pytest.mark.parametrize("name,compress", [("internlm2-1.8b", False), ("mixtral-8x22b", False),
                                           ("deepseek-v3-671b", True)])
def test_reduced_train_step_on_the_card_equals_the_cpu(card, name, compress):
    """One train step (remat "dots", two microbatches) from one seeded
    state on the CPU and on the card, f32 without TF32: the metrics within
    1e-5 relative, the gradients (``m`` after the first step is
    (1 - b1) x the clipped gradient) within 1e-4 of the largest entry of
    each reference leaf (a segment's layers, which share one int8 scale),
    or one int8 bin (1/127 of it) where compression met a near tie."""
    from repro_torch.configs import get_arch
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.data import DataConfig, make_batch
    from repro_torch.models.convert import reference_layout
    from repro_torch.train import TrainConfig, init_train_state, make_train_step

    cfg = _ample(get_arch(name).reduced())
    tcfg = TrainConfig(microbatches=2, remat="dots", compress_grads=compress)
    cpu_state = init_train_state(cfg, tcfg, device="cpu")
    card_state = _state_to(cpu_state, card)
    batch = make_batch(cfg, ShapeSpec("tiny", 32, 4, "train"), DataConfig(), 0, "cpu")
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        _, want = make_train_step(cfg, tcfg, device="cpu")(cpu_state, batch)
        _, got = make_train_step(cfg, tcfg)(card_state, {k: v.to(card) for k, v in batch.items()})
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    assert set(got) == set(want) and all(v.is_cuda for v in got.values())
    for k in want:
        torch.testing.assert_close(got[k].cpu(), want[k], rtol=1e-5, atol=1e-7)
    slack = 1 / 127 + 1e-4 if compress else 1e-4
    m_cpu, m_card = cpu_state["opt"]["m"], card_state["opt"]["m"]
    for path, names, _ in reference_layout(cpu_state["params"]):
        err = max(float((m_card[k].cpu() - m_cpu[k]).abs().max()) for k in names)
        assert err <= slack * max(float(m_cpu[k].abs().max()) for k in names) + 1e-12, path


def test_bf16_checkpoint_roundtrip_on_the_card(card, tmp_path):
    """A bf16 train state on the card after one step: the async snapshot,
    then in-place updates, then a restore into the same tensors gives the
    snapshot's bits back."""
    import dataclasses

    from repro_torch.checkpoint import AsyncCheckpointer, restore_checkpoint
    from repro_torch.configs import get_arch
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.data import DataConfig, make_batch
    from repro_torch.train import TrainConfig, init_train_state, make_train_step

    cfg = dataclasses.replace(get_arch("llama3-8b").reduced(), dtype="bfloat16")
    tcfg = TrainConfig(remat="full")
    state = init_train_state(cfg, tcfg)
    step = make_train_step(cfg, tcfg)
    state, _ = step(state, make_batch(cfg, ShapeSpec("tiny", 32, 4, "train"), DataConfig(), 0))
    assert state["params"].embed.dtype == torch.bfloat16 and state["params"].embed.is_cuda
    want = [t.detach().clone() for t in state["params"].parameters()]
    want_m = {k: v.clone() for k, v in state["opt"]["m"].items()}
    ck = AsyncCheckpointer(str(tmp_path), keep=1)
    ck.save(1, state, {"next_step": 1})
    state, _ = step(state, make_batch(cfg, ShapeSpec("tiny", 32, 4, "train"), DataConfig(), 1))
    ck.wait()
    restored, at, extra = restore_checkpoint(str(tmp_path), state)
    assert restored is state and at == 1 and extra == {"next_step": 1}
    assert int(state["opt"]["step"]) == 1
    for p, w in zip(state["params"].parameters(), want):
        assert p.is_cuda and torch.equal(p.view(torch.int16), w.view(torch.int16))
    assert all(torch.equal(state["opt"]["m"][k], v) for k, v in want_m.items())
