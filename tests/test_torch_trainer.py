"""The port's fault-tolerant trainer (``repro_torch.train.Trainer``): the
reference's ``tests/test_trainer.py`` on the port (convergence, crash ->
restore -> replay, the failure budget, preemption, straggler accounting,
restart determinism), the device rule, and a run that crosses the two
packages: the port's Trainer resumes the reference Trainer's checkpoint
and its losses follow the reference's own resumed run (f32, 1e-4
relative)."""

import shutil
import time

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import repro.configs as RC
from repro.data import DataConfig as RDataConfig
from repro.optim import AdamWConfig as RAdamWConfig
from repro.train import TrainConfig as RTrainConfig
from repro.train import Trainer as RTrainer
from repro.train import TrainerConfig as RTrainerConfig
from repro_torch.checkpoint import latest_step
from repro_torch.configs import get_arch
from repro_torch.configs.base import ShapeSpec
from repro_torch.data import DataConfig
from repro_torch.optim import AdamWConfig
from repro_torch.train import TrainConfig, Trainer, TrainerConfig

SHAPE = ShapeSpec("tiny", 32, 4, "train")
OPT = dict(lr=6e-3, warmup_steps=5, total_steps=80, weight_decay=0.0)


def _tcfg():
    return TrainConfig(microbatches=1, remat="none", opt=AdamWConfig(**OPT))


def _trainer(tmp_path, steps=30, fault_hook=None, clock=time.perf_counter, **kw):
    cfg = get_arch("internlm2-1.8b").reduced()
    run = TrainerConfig(
        steps=steps, ckpt_dir=str(tmp_path / "ckpt"), ckpt_every=5, log_every=100, **kw
    )
    return Trainer(cfg, SHAPE, "cpu", _tcfg(), run, DataConfig(seed=1), fault_hook=fault_hook,
                   clock=clock)


def test_loss_decreases(tmp_path):
    out = _trainer(tmp_path, steps=40).train()
    losses = [m["lm_loss"] for m in out["metrics"]]
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.1
    assert out["step"] == 40 and out["failures"] == 0


def test_fault_recovery_resumes_and_is_deterministic(tmp_path):
    # clean run
    clean = _trainer(tmp_path / "clean", steps=20).train()

    # faulty run: crash once at step 13 (after the step-10 checkpoint)
    state = {"fired": False}

    def hook(step):
        if step == 13 and not state["fired"]:
            state["fired"] = True
            raise RuntimeError("injected node failure")

    faulty = _trainer(tmp_path / "faulty", steps=20, fault_hook=hook).train()
    assert faulty["failures"] == 1
    assert faulty["step"] == 20
    # steps 10-12 ran twice; the replay computed the first pass's losses
    replayed = [m for m in faulty["metrics"] if m["step"] in (10, 11, 12)]
    assert len(replayed) == 6
    for first, again in zip(replayed[:3], replayed[3:]):
        assert first["step"] == again["step"] and first["lm_loss"] == again["lm_loss"]

    # deterministic pipeline + checkpoint/replay => identical final params
    for a, b in zip(clean["state"]["params"].parameters(), faulty["state"]["params"].parameters()):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(), rtol=1e-5, atol=1e-6)


def test_failure_budget_exhaustion(tmp_path):
    def hook(step):
        raise RuntimeError("permafail")

    t = _trainer(tmp_path, steps=10, fault_hook=hook, max_failures=2)
    with pytest.raises(RuntimeError, match="failure budget"):
        t.train()


def test_preemption_checkpoint_and_exit(tmp_path):
    flag = tmp_path / "preempt"

    def hook(step):
        if step == 7:
            flag.write_text("now")

    out = _trainer(
        tmp_path, steps=50, fault_hook=hook, preempt_file=str(flag)
    ).train()
    assert out["preempted"] is True
    assert out["step"] <= 9
    # a final checkpoint exists at the preemption step
    assert latest_step(str(tmp_path / "ckpt")) == out["step"]


def test_straggler_detection(tmp_path):
    """Step 20 is 1 s slower than the others on the Trainer's clock. The
    clock is the test's own (every step reads 0.1 s on it), so the delay
    does not drown in the machine's load: an eager CPU step under a busy
    test run can take 2 s, and a real 1 s sleep then stays under 2 x the
    median."""
    clock = {"t": 0.0}

    def tick():
        clock["t"] += 0.05  # twice a step: 0.1 s a step
        return clock["t"]

    def hook(step):
        if step == 20:
            clock["t"] += 1.0  # synthetic slow step

    out = _trainer(tmp_path, steps=25, fault_hook=hook, clock=tick).train()
    assert 20 in out["stragglers"]
    assert out["stragglers"] == [20]


def test_a_restarted_trainer_resumes_from_its_checkpoint(tmp_path):
    """A new Trainer over the same directory starts at the saved step and
    ends where one uninterrupted run ends."""
    whole = _trainer(tmp_path / "whole", steps=12).train()
    first = _trainer(tmp_path / "split", steps=7).train()
    assert first["step"] == 7 and latest_step(str(tmp_path / "split" / "ckpt")) == 7
    second = _trainer(tmp_path / "split", steps=12).train()
    assert [m["step"] for m in second["metrics"]] == list(range(7, 12))
    for a, b in zip(whole["state"]["params"].parameters(), second["state"]["params"].parameters()):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(), rtol=1e-5, atol=1e-6)


def test_trainer_wants_the_card_unless_given_a_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(get_arch("internlm2-1.8b").reduced(), SHAPE)


def test_port_trainer_resumes_the_references_checkpoint(tmp_path):
    """Ten reference steps (checkpoints at 5 and 10), then steps 10-14
    twice from the step-10 checkpoint: by the reference Trainer and by
    the port's. Their losses agree."""
    ref = RC.get_arch("internlm2-1.8b").reduced()
    mesh = Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "model"))
    rt = RTrainConfig(microbatches=1, remat="none", opt=RAdamWConfig(**OPT))

    def r_run(steps, ckpt):
        run = RTrainerConfig(steps=steps, ckpt_dir=str(ckpt), ckpt_every=5, log_every=100)
        return RTrainer(ref, SHAPE, mesh, rt, run, RDataConfig(seed=1)).train()

    r_run(10, tmp_path / "ref")
    shutil.copytree(tmp_path / "ref", tmp_path / "port")
    want = r_run(15, tmp_path / "ref")["metrics"]
    run = TrainerConfig(steps=15, ckpt_dir=str(tmp_path / "port"), ckpt_every=5, log_every=100)
    got = Trainer(get_arch("internlm2-1.8b").reduced(), SHAPE, "cpu", _tcfg(), run,
                  DataConfig(seed=1)).train()["metrics"]
    assert [m["step"] for m in got] == [m["step"] for m in want] == list(range(10, 15))
    for g, w in zip(got, want):
        for k in ("lm_loss", "loss", "grad_norm", "lr"):
            np.testing.assert_allclose(g[k], w[k], rtol=1e-4, err_msg=f"step {g['step']} {k}")
