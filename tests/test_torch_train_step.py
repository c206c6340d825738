"""The port's train step (``repro_torch.train.train_step``) against the JAX
package's, on the reference's weights and batch.

One ``make_train_step`` step from the reference's ``init_model`` tree and
zero optimizer state, carried into the port bit for bit
(``models/convert.py:train_state_from_reference``), for all ten
registered architectures reduced with one microbatch, and for
InternLM2 with two microbatches and with int8 gradient compression. The
metrics (``loss``, ``lm_loss``, ``aux_loss``, ``mtp_loss``, ``grad_norm``,
``lr``) agree within 1e-5 relative; the params, ``m``, ``v`` and ``comp``
after the step, carried back (``train_state_to_reference``), within the
reference's own tolerance for its microbatch test (rtol 2e-4, atol 2e-5,
``tests/test_models_smoke.py``). Also the train-step half of the
reference's ``tests/test_models_smoke.py`` on the port
(``test_one_train_step`` over all ten archs,
``test_microbatch_accumulation_matches_single``), M = 2 reporting the last
microbatch's metrics, and every remat policy giving the loss and grads of
``"none"``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import repro.configs as RC
from repro.models.model import init_model as r_init_model
from repro.optim import AdamWConfig as RAdamWConfig
from repro.train import TrainConfig as RTrainConfig
from repro.train import make_train_step as r_make_train_step
from repro_torch.configs import get_arch, list_archs
from repro_torch.configs.base import ShapeSpec
from repro_torch.data import DataConfig
from repro_torch.data.pipeline import host_batch, make_batch
from repro_torch.models import Model
from repro_torch.models.convert import (
    train_state_from_reference,
    train_state_to_reference,
    tree_leaves,
)
from repro_torch.models.transformer import REMAT_POLICIES
from repro_torch.optim import AdamWConfig
from repro_torch.train import TrainConfig, init_train_state, make_train_step
from repro_torch.train.train_step import _loss_fn

SHAPE = ShapeSpec("tiny", 32, 4, "train")
ARCHS = list_archs()
METRIC_RTOL = 1e-5
STATE_TOL = dict(rtol=2e-4, atol=2e-5)


def _mesh():
    return Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "model"))


def _reference_state(ref, compress, seed=0):
    params = jax.device_get(r_init_model(ref, jax.random.PRNGKey(seed)))
    zeros = lambda t: jax.tree.map(lambda x: np.zeros(x.shape, np.float32), t)  # noqa: E731
    state = {"params": params,
             "opt": {"m": zeros(params), "v": zeros(params), "step": np.zeros((), np.int32)}}
    if compress:
        state["comp"] = zeros(params)
    return state


def _both_steps(name, microbatches=1, compress=False, remat="dots"):
    """(reference state after, reference metrics, port state after, port
    metrics) of one step from the same state and batch."""
    cfg, ref = get_arch(name).reduced(), RC.get_arch(name).reduced()
    opt = dict(warmup_steps=2, total_steps=10)
    rt = RTrainConfig(microbatches=microbatches, remat=remat, compress_grads=compress,
                      opt=RAdamWConfig(**opt))
    tt = TrainConfig(microbatches=microbatches, remat=remat, compress_grads=compress,
                     opt=AdamWConfig(**opt))
    start = _reference_state(ref, compress)
    port = train_state_from_reference(cfg, start, device="cpu")
    batch = host_batch(cfg, SHAPE, DataConfig(), 0)
    r_state, r_metrics = r_make_train_step(ref, rt, _mesh())(
        jax.tree.map(jnp.asarray, start), {k: jnp.asarray(v) for k, v in batch.items()})
    p_state, p_metrics = make_train_step(cfg, tt, device="cpu")(
        port, {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in batch.items()})
    return jax.device_get(r_state), r_metrics, p_state, p_metrics


def _assert_step_matches(r_state, r_metrics, p_state, p_metrics, lr=1.5e-4):
    """Metrics within METRIC_RTOL; every state element within STATE_TOL
    but at the step's two discontinuities, which rounding noise may cross:

    * a gradient that cancels to f32 noise (its sign differs between the
      packages, or it is below 100 eps = 1e-6, where eps moves the update
      by more than 1%): AdamW's first step scales a gradient g to
      lr g / (|g| + eps), about +-lr, so there each package's parameter
      may have moved by up to lr (1 + weight_decay |p|), in either
      direction;
    * an int8 rounding tie (``compress_grads``): an element at half a bin
      rounds up in one package and down in the other, so its residual
      differs by exactly one bin and is half a bin in size.

    Such elements are counted and printed, and must stay below 0.1% of
    the state."""
    assert set(p_metrics) == set(r_metrics)
    for k in r_metrics:
        np.testing.assert_allclose(float(p_metrics[k]), float(r_metrics[k]), rtol=METRIC_RTOL,
                                   atol=1e-7 if k == "aux_loss" else 0, err_msg=k)
    got = dict(tree_leaves(train_state_to_reference(p_state)))
    want = {p: np.asarray(w) for p, w in tree_leaves(r_state)}
    assert got.keys() == want.keys()
    n_total, n_edge = 0, 0
    for path, w in want.items():
        g = got[path]
        assert g.shape == w.shape and g.dtype == w.dtype, path
        ok = np.isclose(g, w, **STATE_TOL)
        edge = np.zeros_like(ok)
        if path[0] in ("params", "comp"):
            m_got, m_want = got[("opt", "m") + path[1:]], want[("opt", "m") + path[1:]]
        if path[0] == "params":
            # m = (1 - b1) g after the first step
            noise = (np.sign(m_got) != np.sign(m_want)) | (np.abs(m_want) < 0.1 * 1e-6)
            edge = noise & (np.abs(g - w) <= 2 * lr * (1 + 0.1 * np.abs(w)) + STATE_TOL["atol"])
        elif path[0] == "comp":
            # the leaf's quantization step: m = (1 - b1) clip g, max |g| = 127 bins
            clip = min(1.0, 1.0 / float(r_metrics["grad_norm"]))
            bin_ = np.abs(m_want).max() / (0.1 * clip * 127)
            edge = np.isclose(np.abs(g - w), bin_, rtol=1e-3) & np.isclose(np.abs(w), bin_ / 2,
                                                                           rtol=1e-2)
        edge &= ~ok
        n_total, n_edge = n_total + w.size, n_edge + int(edge.sum())
        np.testing.assert_allclose(np.where(edge, w, g), w, **STATE_TOL, err_msg=str(path))
    print(f"{n_edge} of {n_total} state elements at a gradient noise floor or a rounding tie")
    assert n_edge <= 1e-3 * n_total


@pytest.mark.parametrize("name", ARCHS)
def test_one_step_matches_reference(name):
    _assert_step_matches(*_both_steps(name))


@pytest.mark.parametrize("microbatches,compress", [(2, False), (1, True), (2, True)])
def test_microbatched_and_compressed_step_matches_reference(microbatches, compress):
    r_state, r_metrics, p_state, p_metrics = _both_steps("internlm2-1.8b", microbatches, compress)
    assert ("comp" in p_state) == compress
    _assert_step_matches(r_state, r_metrics, p_state, p_metrics)


# ---------------------------------------------------------------------------
# the reference's tests/test_models_smoke.py, train-step half, on the port
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", ARCHS)
def test_one_train_step(name):
    cfg = get_arch(name).reduced()
    tcfg = TrainConfig(
        microbatches=1, remat="dots", opt=AdamWConfig(warmup_steps=2, total_steps=10)
    )
    state = init_train_state(cfg, tcfg, device="cpu")
    before = state["params"].embed.detach().clone()
    step = make_train_step(cfg, tcfg, device="cpu")
    batch = make_batch(cfg, SHAPE, DataConfig(), 0, "cpu")
    state, metrics = step(state, batch)
    assert np.isfinite(float(metrics["loss"]))
    assert np.isfinite(float(metrics["grad_norm"])) and float(metrics["grad_norm"]) > 0
    assert int(state["opt"]["step"]) == 1
    # params actually moved
    l0 = state["params"].embed
    assert bool(torch.isfinite(l0).all()) and not torch.equal(l0, before)


def test_microbatch_accumulation_matches_single():
    """Grad accumulation is exact: M=2 microbatches == one big batch."""
    cfg = get_arch("internlm2-1.8b").reduced()
    opt = AdamWConfig(warmup_steps=0, lr=1e-2)
    batch = make_batch(cfg, SHAPE, DataConfig(), 0, "cpu")

    s1 = init_train_state(cfg, TrainConfig(microbatches=1, opt=opt), device="cpu")
    f1 = make_train_step(cfg, TrainConfig(microbatches=1, opt=opt), device="cpu")
    s1, m1 = f1(s1, batch)

    s2 = init_train_state(cfg, TrainConfig(microbatches=2, opt=opt), device="cpu")
    f2 = make_train_step(cfg, TrainConfig(microbatches=2, opt=opt), device="cpu")
    s2, m2 = f2(s2, batch)

    for a, b in zip(s1["params"].parameters(), s2["params"].parameters()):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(), rtol=2e-4, atol=2e-5)


def test_microbatched_metrics_are_the_last_microbatchs():
    """With M > 1 the step reports the last microbatch's losses (the
    reference's scan carry is overwritten), not their mean."""
    cfg = get_arch("internlm2-1.8b").reduced()
    tcfg = TrainConfig(microbatches=2, remat="none")
    state = init_train_state(cfg, tcfg, device="cpu")
    batch = make_batch(cfg, SHAPE, DataConfig(), 0, "cpu")
    with torch.no_grad():
        last, _ = _loss_fn(state["params"], cfg, tcfg, {k: v[2:] for k, v in batch.items()}, 1)
        first, _ = _loss_fn(state["params"], cfg, tcfg, {k: v[:2] for k, v in batch.items()}, 1)
    _, metrics = make_train_step(cfg, tcfg, device="cpu")(state, batch)
    assert float(metrics["loss"]) == pytest.approx(float(last), rel=1e-6)
    assert abs(float(last) - float(first)) > 1e-4


# ---------------------------------------------------------------------------
# remat: memory, never values
# ---------------------------------------------------------------------------
def _loss_and_grads(name, remat):
    cfg = get_arch(name).reduced()
    model = init_train_state(cfg, TrainConfig(), device="cpu")["params"]
    batch = make_batch(cfg, SHAPE, DataConfig(), 0, "cpu")
    loss, _ = _loss_fn(model, cfg, TrainConfig(remat=remat), batch, 2)
    names, params = zip(*model.named_parameters())
    grads = torch.autograd.grad(loss, params, allow_unused=True)
    return float(loss.detach()), {n: g for n, g in zip(names, grads) if g is not None}


@pytest.mark.parametrize("name", ["llama3-8b", "mixtral-8x22b", "mamba2-780m", "whisper-medium"])
@pytest.mark.parametrize("remat", sorted(set(REMAT_POLICIES) - {"none"}))
def test_remat_changes_no_value(name, remat):
    loss0, g0 = _loss_and_grads(name, "none")
    loss1, g1 = _loss_and_grads(name, remat)
    assert g1.keys() == g0.keys()
    err = max(float((g1[k] - g0[k]).abs().max()) for k in g0)
    print(f"{name} remat={remat}: |loss diff| {abs(loss1 - loss0)}, max |grad diff| {err}")
    assert loss1 == loss0
    assert err == 0.0


def _products_run(remat):
    """(mm, bmm) operations run by one forward + backward of reduced llama."""
    from torch.utils._python_dispatch import TorchDispatchMode

    aten = torch.ops.aten

    class Count(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.n = {"mm": 0, "bmm": 0}

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func in (aten.mm.default, aten.addmm.default):
                self.n["mm"] += 1
            elif func in (aten.bmm.default, aten.baddbmm.default):
                self.n["bmm"] += 1
            return func(*args, **(kwargs or {}))

    cfg = get_arch("llama3-8b").reduced()
    model = init_train_state(cfg, TrainConfig(), device="cpu")["params"]
    batch = make_batch(cfg, SHAPE, DataConfig(), 0, "cpu")
    with Count() as c:
        loss, _ = _loss_fn(model, cfg, TrainConfig(remat=remat), batch, 1)
        torch.autograd.grad(loss, list(model.parameters()))
    return c.n["mm"], c.n["bmm"]


def test_remat_recomputes_what_its_policy_does_not_save():
    """``"dots"`` saves every product, ``"dots_no_batch"`` only the 2-D
    ones (the attention's batched products run again), ``"full"`` and
    ``"save_block_io"`` rerun the layers' forward products."""
    mm0, bmm0 = _products_run("none")
    assert _products_run("dots") == (mm0, bmm0)
    mm, bmm = _products_run("dots_no_batch")
    assert mm == mm0 and bmm > bmm0
    for remat in ("full", "save_block_io"):
        mm, bmm = _products_run(remat)
        assert mm > mm0 and bmm > bmm0, remat


def test_unknown_remat_name_raises():
    with pytest.raises(ValueError, match="unknown remat policy 'everything'"):
        _loss_and_grads("llama3-8b", "everything")


def test_step_refuses_a_state_on_another_device():
    cfg = get_arch("llama3-8b").reduced()
    state = init_train_state(cfg, TrainConfig(), device="cpu")
    state["params"] = Model(cfg, device="meta")
    with pytest.raises(ValueError, match="lies on meta"):
        make_train_step(cfg, TrainConfig(), device="cpu")(state, {})


def test_training_entry_points_want_the_card(monkeypatch):
    """Without a card and without ``device="cpu"`` nothing runs on the CPU
    unasked: ``init_train_state``, ``make_train_step``,
    ``train_state_from_reference`` and ``make_batch`` raise."""
    cfg = get_arch("llama3-8b").reduced()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: init_train_state(cfg, TrainConfig()),
                 lambda: make_train_step(cfg, TrainConfig()),
                 lambda: train_state_from_reference(cfg, {}),
                 lambda: make_batch(cfg, SHAPE, DataConfig(), 0)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
