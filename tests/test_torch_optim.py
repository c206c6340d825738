"""The port's optimizer (``repro_torch.optim``: AdamW, its schedule, int8
gradient compression) against the JAX package's.

The reference's ``tests/test_optim.py`` on the port (the hand-rolled
AdamW, clipping, the warmup + cosine schedule, the quantization error
bound as a Hypothesis property with a seeded twin, error feedback, the
global norm), then the two packages side by side on numpy-seeded trees:
``lr_at`` at every step of a schedule, ``adamw_update`` over several steps
(f32 and bf16 parameters, f32 moments), ``quantize_int8`` (half-to-even
ties included) and ``compress_grads``: the schedule within 1e-6, the
update and the moments within 1e-5 relative (the clip factor comes from a
norm summed in another order), the int8 codes exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _hypothesis_compat import given, settings, st  # soft dep: skips, not errors

from repro.optim import AdamWConfig as RAdamWConfig
from repro.optim import adamw_init as r_adamw_init
from repro.optim import adamw_update as r_adamw_update
from repro.optim import compress_grads as r_compress_grads
from repro.optim import lr_at as r_lr_at
from repro.optim import quantize_int8 as r_quantize_int8
from repro.optim.compression import compression_init as r_compression_init
from repro_torch.optim import (
    AdamWConfig,
    adamw_init,
    adamw_update,
    compress_grads,
    compression_init,
    dequantize_int8,
    global_norm,
    lr_at,
    quantize_int8,
)


def test_adamw_matches_reference_math():
    """Single-tensor AdamW vs a hand-rolled numpy reference."""
    cfg = AdamWConfig(lr=1e-2, b1=0.9, b2=0.99, eps=1e-8, weight_decay=0.01,
                      clip_norm=1e9, warmup_steps=0, total_steps=10**9)
    p = {"w": torch.tensor([1.0, -2.0, 3.0])}
    g = {"w": torch.tensor([0.1, 0.2, -0.3])}
    state = adamw_init(p)
    new_p, state, _ = adamw_update(p, g, state, cfg)

    m = 0.1 * np.array([0.1, 0.2, -0.3])
    v = 0.01 * np.array([0.1, 0.2, -0.3]) ** 2
    mhat, vhat = m / 0.1, v / 0.01
    lr = float(lr_at(cfg, 1))
    want = np.array([1.0, -2.0, 3.0]) - lr * (
        mhat / (np.sqrt(vhat) + 1e-8) + 0.01 * np.array([1.0, -2.0, 3.0])
    )
    np.testing.assert_allclose(new_p["w"].numpy(), want, rtol=1e-5)


def test_clipping_bounds_update():
    cfg = AdamWConfig(clip_norm=1.0, weight_decay=0.0, warmup_steps=0)
    p = {"w": torch.zeros(4)}
    g = {"w": torch.full((4,), 100.0)}
    state = adamw_init(p)
    _, state, metrics = adamw_update(p, g, state, cfg)
    assert float(metrics["grad_norm"]) == pytest.approx(200.0, rel=1e-5)
    # post-clip first moment magnitude <= (1-b1) * clip_norm
    assert float(state["m"]["w"].abs().max()) <= 0.1 * 1.0 + 1e-6


def test_schedule_warmup_and_decay():
    cfg = AdamWConfig(lr=1.0, warmup_steps=10, total_steps=110, min_lr_ratio=0.1)
    assert float(lr_at(cfg, 0)) == 0.0
    assert float(lr_at(cfg, 5)) == pytest.approx(0.5)
    assert float(lr_at(cfg, 10)) == pytest.approx(1.0)
    assert float(lr_at(cfg, 110)) == pytest.approx(0.1, abs=1e-6)
    assert float(lr_at(cfg, 60)) == pytest.approx(0.55, abs=1e-6)


def check_quantize_roundtrip(vals):
    x = torch.tensor(vals, dtype=torch.float32)
    q, s = quantize_int8(x)
    err = (dequantize_int8(q, s) - x).abs().max()
    assert float(err) <= float(s) * 0.5 + 1e-9  # rounding: half a bin


@settings(max_examples=50, deadline=None)
@given(st.lists(st.floats(-1e3, 1e3, allow_nan=False), min_size=1, max_size=64))
def test_quantize_roundtrip_error_bound(vals):
    check_quantize_roundtrip(vals)


def test_quantize_roundtrip_seeded_twin():
    rng = np.random.default_rng(5)
    for _ in range(50):
        n = int(rng.integers(1, 65))
        check_quantize_roundtrip(rng.uniform(-1e3, 1e3, n).tolist())
    check_quantize_roundtrip([0.0])
    check_quantize_roundtrip([1e3, -1e3, 0.5])


def test_error_feedback_accumulates_residual():
    """With constant grads, error feedback makes the *average* dequantized
    gradient converge to the true gradient (unbiasedness over time)."""
    g = {"w": torch.tensor([1e-3, 2.5e-3, -7e-4, 0.9])}
    state = compression_init(g)
    total = torch.zeros_like(g["w"])
    n = 64
    for _ in range(n):
        dq, state = compress_grads(g, state)
        total = total + dq["w"]
    # |avg - g| <= residual range / n = one int8 bin (~0.9/127) / 64 steps
    np.testing.assert_allclose((total / n).numpy(), g["w"].numpy(), rtol=0.0, atol=1.5e-4)


def test_global_norm():
    t = {"a": torch.ones(4), "b": torch.full((9,), 2.0)}
    assert float(global_norm(t)) == pytest.approx(np.sqrt(4 + 36), rel=1e-6)


# ---------------------------------------------------------------------------
# side by side with the reference
# ---------------------------------------------------------------------------
def _tree(seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return {"a": rng.standard_normal((3, 5)).astype(dtype),
            "b": (rng.standard_normal(7) * 1e-3).astype(dtype),
            "c": rng.standard_normal((2, 2, 4)).astype(dtype)}


@pytest.mark.parametrize("warmup,total", [(0, 10), (3, 12), (100, 10000)])
def test_lr_at_equals_reference(warmup, total):
    kw = dict(lr=3e-3, warmup_steps=warmup, total_steps=total, min_lr_ratio=0.1)
    for step in range(0, total + 3):
        got = lr_at(AdamWConfig(**kw), torch.tensor(step, dtype=torch.int32))
        assert got.dtype == torch.float32
        np.testing.assert_allclose(float(got), float(r_lr_at(RAdamWConfig(**kw), step)),
                                   rtol=1e-6, err_msg=str(step))


@pytest.mark.parametrize("clip", [1e9, 1.0])
def test_adamw_update_equals_reference_over_steps(clip):
    kw = dict(lr=1e-2, warmup_steps=2, total_steps=8, clip_norm=clip, weight_decay=0.1)
    p_np = _tree(0)
    rp, rs = {k: jnp.asarray(v) for k, v in p_np.items()}, None
    rs = r_adamw_init(rp)
    tp = {k: torch.from_numpy(v.copy()) for k, v in p_np.items()}
    ts = adamw_init(tp)
    for step in range(5):
        g = _tree(100 + step)
        rp, rs, rm = r_adamw_update(rp, {k: jnp.asarray(v) for k, v in g.items()}, rs,
                                    RAdamWConfig(**kw))
        tp, ts, tm = adamw_update(tp, {k: torch.from_numpy(v) for k, v in g.items()}, ts,
                                  AdamWConfig(**kw))
        for k in p_np:
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(rp[k]), rtol=1e-5, atol=1e-7)
            np.testing.assert_allclose(ts["m"][k].numpy(), np.asarray(rs["m"][k]), rtol=1e-5)
            np.testing.assert_allclose(ts["v"][k].numpy(), np.asarray(rs["v"][k]), rtol=1e-5)
        assert int(ts["step"]) == int(rs["step"]) == step + 1
        for k in ("grad_norm", "lr"):
            np.testing.assert_allclose(float(tm[k]), float(rm[k]), rtol=1e-5)


def test_adamw_update_of_bf16_params_equals_reference():
    """bf16 parameters, f32 moments: the update in f32, cast back."""
    p_np = _tree(1)
    rp = {k: jnp.asarray(v, jnp.bfloat16) for k, v in p_np.items()}
    rs = r_adamw_init(rp, RAdamWConfig())
    tp = {k: torch.from_numpy(v).to(torch.bfloat16) for k, v in p_np.items()}
    ts = adamw_init(tp, AdamWConfig())
    assert all(m.dtype == torch.float32 for m in ts["m"].values())
    kw = dict(lr=1e-2, warmup_steps=0)
    for step in range(3):
        g = _tree(200 + step)
        rp, rs, _ = r_adamw_update(rp, {k: jnp.asarray(v, jnp.bfloat16) for k, v in g.items()},
                                   rs, RAdamWConfig(**kw))
        tp, ts, _ = adamw_update(tp, {k: torch.from_numpy(v).to(torch.bfloat16)
                                      for k, v in g.items()}, ts, AdamWConfig(**kw))
    for k in p_np:
        assert tp[k].dtype == torch.bfloat16
        want = np.asarray(rp[k]).astype(np.float32)
        np.testing.assert_allclose(tp[k].float().numpy(), want, rtol=8e-3, atol=1e-6)
        np.testing.assert_allclose(ts["m"][k].numpy(), np.asarray(rs["m"][k]), rtol=1e-5)


def test_quantize_int8_equals_reference():
    rng = np.random.default_rng(3)
    x = (rng.standard_normal(4096) * 3).astype(np.float32)
    # exact half-bin values: both packages round half to even
    x[:8] = np.array([0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 126.5, -127.0], np.float32) * (
        float(np.abs(x).max()) / 127.0)
    q, s = quantize_int8(torch.from_numpy(x))
    rq, rs = r_quantize_int8(jnp.asarray(x))
    assert float(s) == float(rs)
    np.testing.assert_array_equal(q.numpy(), np.asarray(rq))
    z, zs = quantize_int8(torch.zeros(5))
    assert float(zs) == pytest.approx(1e-12 / 127.0) and not z.any()


def test_compress_grads_equals_reference_over_steps():
    g_np = [_tree(300 + i) for i in range(4)]
    rstate = r_compression_init({k: jnp.asarray(v) for k, v in g_np[0].items()})
    tstate = compression_init({k: torch.from_numpy(v) for k, v in g_np[0].items()})
    for g in g_np:
        rd, rstate = r_compress_grads({k: jnp.asarray(v) for k, v in g.items()}, rstate)
        td, tstate = compress_grads({k: torch.from_numpy(v) for k, v in g.items()}, tstate)
        for k in g:
            np.testing.assert_allclose(td[k].numpy(), np.asarray(rd[k]), rtol=1e-6, atol=1e-9)
            np.testing.assert_allclose(tstate.error[k].numpy(), np.asarray(rstate.error[k]),
                                       rtol=1e-5, atol=1e-9)


def test_grouped_leaves_share_one_scale():
    """Tensors of one group quantize as one leaf: the reference's stacked
    leaf of a segment is the port's per-layer tensors of that group."""
    rng = np.random.default_rng(9)
    rows = [rng.standard_normal((4, 3)).astype(np.float32) * s for s in (1.0, 10.0)]
    rd, _ = r_compress_grads({"w": jnp.asarray(np.stack(rows))}, None)
    td, _ = compress_grads({"w.0": torch.from_numpy(rows[0]), "w.1": torch.from_numpy(rows[1])},
                           None, groups=[["w.0", "w.1"]])
    got = np.stack([td["w.0"].numpy(), td["w.1"].numpy()])
    np.testing.assert_allclose(got, np.asarray(rd["w"]), rtol=1e-6)
