"""The port's serve steps (``repro_torch.serve``: ``make_prefill``,
``make_decode_step``, ``greedy``, ``generate``) and the serving CLI
(``python -m repro_torch.launch.serve``) against the JAX package's.

The reference's ``tests/test_serve.py`` on the port, with the reference's
parameters carried bit for bit and numpy-seeded prompts: ``generate``
gives the reference's tokens (and the port's own cacheless greedy
rollout's) for reduced llama3-8b, mamba2-780m and mixtral-8x22b; whisper
prefill -> decode with cross-attention served from the cache; the VLM's
generation; the caches after a prefill and after a decode step equal the
reference's leaf by leaf through the cache carry
(``repro_torch.models.convert.caches_to_reference`` /
``caches_from_reference``); the MLA and SWA cache sizes. Also: the steps
run on the meta device, where no value can be read back to the host and
every tensor made lies on the model's device; without a card and without
a device they raise, and the CLI exits 2. Tolerance: f32, rtol = atol =
1e-4; tokens exact.
"""

import dataclasses
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

import repro.configs as RC
from repro.models.model import forward as r_forward
from repro.models.model import init_model as r_init_model
from repro.serve import generate as r_generate
from repro.serve import make_decode_step as r_make_decode_step
from repro.serve import make_prefill as r_make_prefill
from repro_torch.configs import get_arch
from repro_torch.models import (
    Model,
    caches_from_reference,
    caches_to_reference,
    forward,
    from_reference_params,
)
from repro_torch.serve import (
    cache_bytes,
    generate,
    generate_timed,
    greedy,
    make_decode_step,
    make_prefill,
)

TOL = dict(rtol=1e-4, atol=1e-4)


def _ample(cfg):
    return dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=64.0)) \
        if cfg.moe else cfg


def _carried(name, seed=0):
    cfg, ref = _ample(get_arch(name).reduced()), _ample(RC.get_arch(name).reduced())
    tree = jax.device_get(r_init_model(ref, jax.random.PRNGKey(seed)))
    return cfg, ref, tree, from_reference_params(cfg, tree, device="cpu")


def _batch(cfg, b=2, s=12, seed=1):
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)}
    if cfg.frontend or cfg.enc_dec:
        batch["frontend"] = (rng.standard_normal((b, cfg.n_frontend_tokens, cfg.d_model))
                             * 0.05).astype(np.float32)
    return ({k: jnp.asarray(v) for k, v in batch.items()},
            {k: torch.from_numpy(v) for k, v in batch.items()})


def _assert_trees_close(got, want, path=""):
    if isinstance(want, dict):
        assert set(got) == set(want), (path, set(got), set(want))
        for k in want:
            _assert_trees_close(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, (tuple, list)):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_trees_close(g, w, f"{path}/{i}")
    else:
        w = np.asarray(want)
        assert got.shape == w.shape and got.dtype == w.dtype, (path, got.shape, w.shape)
        np.testing.assert_allclose(got, w, **TOL, err_msg=path)


def _greedy_reference(model, cfg, tokens, steps):
    """Teacher-forced rollout with full recompute each step (no cache)."""
    toks, out = tokens, []
    with torch.no_grad():
        for _ in range(steps):
            logits, _, _ = forward(model, cfg, {"tokens": toks})
            nxt = greedy(logits[:, -1])
            out.append(nxt)
            toks = torch.cat([toks, nxt[:, None]], dim=1)
    return torch.stack(out, dim=1)


@pytest.mark.parametrize("arch", ["llama3-8b", "mamba2-780m", "mixtral-8x22b"])
def test_generate_matches_reference(arch):
    cfg, ref, tree, model = _carried(arch)
    jb, tb = _batch(cfg)
    want = np.asarray(r_generate(tree, ref, jb, 5))
    got = generate(model, cfg, tb, 5, device="cpu")
    assert got.dtype == torch.int32 and got.shape == (2, 5)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(_greedy_reference(model, cfg, tb["tokens"], 5).numpy(), want)


@pytest.mark.parametrize("arch", ["llama3-8b", "mamba2-780m"])
def test_generate_timed_records_the_reference_steps(arch):
    """``generate_timed`` -- the loop ``generate`` returns the tokens of --
    keeps each step's logits, the final caches and one clock per step,
    held against the reference's steps driven by hand."""
    cfg, ref, tree, model = _carried(arch)
    jb, tb = _batch(cfg)
    r = generate_timed(model, cfg, tb, 4, device="cpu")
    assert r["tokens"].shape == (2, 4) and len(r["logits"]) == len(r["decode_s"]) == 3
    assert r["prefill_s"] > 0 and min(r["decode_s"]) > 0
    rl, rc = r_make_prefill(ref, max_len=16)(tree, jb)
    np.testing.assert_allclose(r["prefill_logits"].numpy(), np.asarray(rl), **TOL)
    step = r_make_decode_step(ref)
    for j, got in enumerate(r["logits"]):
        tok = jnp.asarray(r["tokens"][:, j:j + 1].numpy())
        rl, rc = step(tree, tok, rc, jnp.int32(12 + j))
        np.testing.assert_allclose(got.numpy(), np.asarray(rl), **TOL)
    np.testing.assert_array_equal(r["tokens"].numpy(),
                                  np.stack([np.argmax(np.asarray(x), -1) for x in
                                            [r["prefill_logits"], *r["logits"]]], 1))
    _assert_trees_close(caches_to_reference(cfg, r["caches"]), jax.device_get(rc))


@pytest.mark.parametrize("arch", ["llama3-8b", "mixtral-8x22b", "deepseek-v3-671b",
                                  "mamba2-780m", "jamba-v0.1-52b", "whisper-medium",
                                  "qwen2-vl-2b"])
def test_caches_after_prefill_and_decode_match_reference(arch):
    """GQA, SWA rings, MLA latents, SSD states, hybrid, enc-dec cross K/V
    and ``enc_out``, M-RoPE: the caches leaf by leaf, and the logits."""
    cfg, ref, tree, model = _carried(arch)
    jb, tb = _batch(cfg)
    extra = cfg.n_frontend_tokens if cfg.frontend == "vision" else 0
    max_len = 20 + extra
    rl, rc = r_make_prefill(ref, max_len=max_len)(tree, jb)
    pl, pc = make_prefill(cfg, max_len=max_len, device="cpu")(model, tb)
    np.testing.assert_allclose(pl.numpy(), np.asarray(rl), **TOL)
    _assert_trees_close(caches_to_reference(cfg, pc), jax.device_get(rc))

    nxt = np.argmax(np.asarray(rl), -1).astype(np.int32)[:, None]
    rl2, rc2 = r_make_decode_step(ref)(tree, jnp.asarray(nxt), rc, jnp.int32(12))
    pl2, pc2 = make_decode_step(cfg)(model, torch.from_numpy(nxt), pc, 12)
    for before, after in zip(pc["stack"], pc2["stack"]):  # the same tensors, updated in place
        assert all(after[part] is before[part] for part in before)
    np.testing.assert_allclose(pl2.numpy(), np.asarray(rl2), **TOL)
    _assert_trees_close(caches_to_reference(cfg, pc2), jax.device_get(rc2))


def test_decode_from_the_references_carried_caches():
    """The reference's prefill caches, carried in, decode as the
    reference's own; carrying out and in again is the identity."""
    cfg, ref, tree, model = _carried("mixtral-8x22b")
    jb, _ = _batch(cfg)
    rl, rc = r_make_prefill(ref, max_len=16)(tree, jb)
    rc = jax.device_get(rc)
    pc = caches_from_reference(cfg, rc, device="cpu")
    _assert_trees_close(caches_to_reference(cfg, pc), rc)
    assert all(c["mixer"]["idx"].dim() == 0 for c in pc["stack"])
    nxt = np.argmax(np.asarray(rl), -1).astype(np.int32)[:, None]
    rl2, _ = r_make_decode_step(ref)(tree, jnp.asarray(nxt), rc, jnp.int32(12))
    pl2, _ = make_decode_step(cfg)(model, torch.from_numpy(nxt), pc, 12)
    np.testing.assert_allclose(pl2.numpy(), np.asarray(rl2), **TOL)


def test_whisper_prefill_decode():
    cfg, ref, tree, model = _carried("whisper-medium")
    jb, tb = _batch(cfg, s=6, seed=3)
    with torch.no_grad():
        full, _, _ = forward(model, cfg, tb)
    last, caches = make_prefill(cfg, max_len=16, device="cpu")(model, tb)
    np.testing.assert_allclose(last.numpy(), full[:, -1].numpy(), **TOL)
    assert "enc_out" in caches
    # decode continues with cross-attention served from the cache
    nxt = greedy(last)[:, None]
    logits, caches = make_decode_step(cfg)(model, nxt, caches, 6)
    assert logits.shape == (2, cfg.vocab) and torch.isfinite(logits).all()
    rl, rc = r_make_prefill(ref, max_len=16)(tree, jb)
    rl2, _ = r_make_decode_step(ref)(tree, jnp.asarray(nxt.numpy()), rc, jnp.int32(6))
    np.testing.assert_allclose(logits.numpy(), np.asarray(rl2), **TOL)
    with torch.no_grad():
        ext, _, _ = forward(model, cfg, {"tokens": torch.cat([tb["tokens"], nxt], 1),
                                         "frontend": tb["frontend"]})
    np.testing.assert_allclose(logits.numpy(), ext[:, -1].numpy(), **TOL)


def test_vlm_generate_matches_reference():
    cfg, ref, tree, model = _carried("qwen2-vl-2b")
    jb, tb = _batch(cfg, s=8)
    want = np.asarray(r_generate(tree, ref, jb, 3))
    got = generate(model, cfg, tb, 3, device="cpu")
    assert got.shape == (2, 3)
    np.testing.assert_array_equal(got.numpy(), want)


def test_mla_cache_is_compressed():
    """DeepSeek's latent cache must be far smaller than a dense KV cache."""
    cfg = get_arch("deepseek-v3-671b")
    mla_bytes = cache_bytes(cfg, batch=1, max_len=1024)
    dense_kv = cfg.n_layers * 2 * 1024 * cfg.n_kv_heads * cfg.head_dim_ * 2  # bf16
    assert mla_bytes < dense_kv / 20  # ~28x structural shrink


def test_swa_cache_is_bounded():
    cfg = get_arch("mixtral-8x22b")
    assert cache_bytes(cfg, batch=1, max_len=524288) == cache_bytes(cfg, batch=1, max_len=4096)


class _Devices(TorchDispatchMode):
    """Records the device of every tensor an op returns."""

    def __init__(self):
        super().__init__()
        self.seen = set()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        self.seen |= {t.device.type for t in tree_flatten(out)[0] if isinstance(t, torch.Tensor)}
        return out


@pytest.mark.parametrize("arch", ["llama3-8b", "mixtral-8x22b", "deepseek-v3-671b",
                                  "jamba-v0.1-52b", "whisper-medium", "qwen2-vl-2b"])
def test_serve_steps_read_nothing_back_and_stay_on_the_device(arch):
    """On the meta device a tensor has no values, so a step that read one
    back to the host (``.item()``, a Python branch on a tensor) would
    raise: prefill and decode never sync per layer. Every tensor made
    lies on the model's device."""
    cfg = _ample(get_arch(arch).reduced())
    model = Model(cfg, device="meta")
    batch = {"tokens": torch.zeros(2, 12, dtype=torch.int32, device="meta")}
    if cfg.frontend or cfg.enc_dec:
        batch["frontend"] = torch.zeros(2, cfg.n_frontend_tokens, cfg.d_model, device="meta")
    with _Devices() as mode:
        out = generate(model, cfg, batch, 3, device="meta")
    assert out.shape == (2, 3) and out.is_meta
    assert mode.seen == {"meta"}


def test_no_card_means_no_serve_steps(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_arch("llama3-8b").reduced()
    model = Model(cfg, device="cpu")
    batch = {"tokens": torch.zeros(1, 4, dtype=torch.int32)}
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_prefill(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        generate(model, cfg, batch, 2)
    assert generate(model, cfg, batch, 2, device="cpu").shape == (1, 2)


def test_launch_serve_cli(subprocess_env):
    env = dict(subprocess_env, CUDA_VISIBLE_DEVICES="")
    base = [sys.executable, "-m", "repro_torch.launch.serve", "--arch", "mixtral-8x22b",
            "--reduced", "--requests", "2", "--prompt-len", "8", "--gen-len", "3"]
    out = subprocess.run(base + ["--device", "cpu"], env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.strip().splitlines()
    assert lines[0].startswith("device cpu; mixtral-8x22b-reduced: 2 x 8 prompt tokens")
    assert lines[1].startswith("prefill ") and "ms/step (median of 2)" in lines[1]
    assert "tok/s" in lines[1] and len(eval(lines[2])) == 2  # noqa: S307 -- our own list
    nocard = subprocess.run(base, env=env, capture_output=True, text=True, timeout=300)
    assert nocard.returncode == 2 and nocard.stdout == ""
    assert nocard.stderr.strip().splitlines() == [
        "error: no CUDA device is available; pass --device cpu to run on the CPU"]
