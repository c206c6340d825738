"""The port's MoE layer (``repro_torch.models.moe``) against the JAX
package's, on numpy-seeded inputs with the reference's parameters carried
bit for bit.

The reference's ``tests/test_moe.py`` on the port -- ample capacity (held
to the reference and to a naive per-expert loop), the shared expert,
capacity drops, the decode group, the aux loss of a uniform router -- plus
the orders the port makes explicit: top-k prefers the lower index on a
tie (``jax.lax.top_k``), and the capacity is Python's banker's ``round``.
Tolerance: f32, rtol = atol = 1e-4.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as RC
from repro.models import moe as rm
from repro_torch.configs import get_arch
from repro_torch.models import moe as pm
from repro_torch.models.convert import load_reference_tree
from repro_torch.models.layers import Init, mlp

TOL = dict(rtol=1e-4, atol=1e-4)


def _cfgs(arch="mixtral-8x22b", capacity_factor=None, top_k=None):
    out = []
    for cfg in (get_arch(arch).reduced(), RC.get_arch(arch).reduced()):
        moe = cfg.moe
        if capacity_factor is not None:
            moe = dataclasses.replace(moe, capacity_factor=capacity_factor)
        if top_k is not None:
            moe = dataclasses.replace(moe, top_k=top_k)
        out.append(dataclasses.replace(cfg, moe=moe))
    return out


def _carry(cfg, ref, seed=0):
    tree = jax.device_get(rm.moe_init(jax.random.PRNGKey(seed), ref, jnp.float32))
    mod = pm.MoE(Init(torch.device("meta")), cfg, torch.float32).to_empty(device="cpu")
    return tree, load_reference_tree(mod, tree)


def _x(shape, seed=1):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _both(tree, ref, mod, cfg, x):
    yj, auxj = rm.moe_apply(tree, ref, jnp.asarray(x))
    with torch.no_grad():
        yt, auxt = pm.moe_apply(mod, cfg, torch.from_numpy(x))
    assert auxt.dtype == torch.float32 and auxt.dim() == 0
    np.testing.assert_allclose(float(auxt), float(auxj), **TOL)
    return np.asarray(yj), yt.numpy()


def _naive_moe(mod, cfg, x):
    """Loop over experts, dense masks, no capacity limit (in torch)."""
    m = cfg.moe
    b, s, d = x.shape
    xf = x.reshape(-1, d)
    probs = torch.softmax((xf @ mod.router).float(), -1)
    gates, idx = pm.top_k(probs, m.top_k)
    gates = gates / gates.sum(-1, keepdim=True)
    y = torch.zeros_like(xf)
    ex = mod.experts
    for e in range(m.n_experts):
        pe = type("Expert", (), {k: getattr(ex, k)[e] for k in ("up", "down", "gate") if hasattr(ex, k)})
        fe = mlp(pe, xf, cfg.act)
        y = y + fe * torch.where(idx == e, gates, 0.0).sum(-1)[:, None]
    if m.n_shared:
        y = y + mlp(mod.shared, xf, cfg.act)
    return y.reshape(b, s, d)


def test_moe_matches_reference_with_ample_capacity():
    cfg, ref = _cfgs(capacity_factor=64.0)  # capacity >= group size: dropless
    tree, mod = _carry(cfg, ref)
    x = _x((3, 16, cfg.d_model))
    want, got = _both(tree, ref, mod, cfg, x)
    np.testing.assert_allclose(got, want, **TOL)
    with torch.no_grad():
        np.testing.assert_allclose(got, _naive_moe(mod, cfg, torch.from_numpy(x)).numpy(), **TOL)
        y, aux = mod(torch.from_numpy(x))  # MoE.forward
    np.testing.assert_array_equal(y.numpy(), got)
    assert float(aux) > 0.0


def test_moe_shared_expert_path():
    cfg, ref = _cfgs("deepseek-v3-671b", capacity_factor=64.0)
    tree, mod = _carry(cfg, ref)
    x = _x((2, 8, cfg.d_model))
    want, got = _both(tree, ref, mod, cfg, x)
    np.testing.assert_allclose(got, want, **TOL)
    with torch.no_grad():
        np.testing.assert_allclose(got, _naive_moe(mod, cfg, torch.from_numpy(x)).numpy(), **TOL)


def test_capacity_drops_tokens_like_the_reference():
    cfg, ref = _cfgs(capacity_factor=0.25)  # aggressive: forces drops
    tree, mod = _carry(cfg, ref)
    x = _x((2, 32, cfg.d_model))
    want, got = _both(tree, ref, mod, cfg, x)
    assert np.all(np.isfinite(got))
    np.testing.assert_allclose(got, want, **TOL)
    # dropped tokens contribute zero; output norm below dropless output norm
    cfg2, _ = _cfgs(capacity_factor=64.0)
    with torch.no_grad():
        y2, _ = pm.moe_apply(mod, cfg2, torch.from_numpy(x))
    assert np.linalg.norm(got) <= float(torch.linalg.norm(y2)) + 1e-3


def test_decode_single_token_group():
    cfg, ref = _cfgs(capacity_factor=8.0)
    tree, mod = _carry(cfg, ref)
    x = _x((8, 1, cfg.d_model), seed=3)  # S == 1: batch routed as one group
    want, got = _both(tree, ref, mod, cfg, x)
    np.testing.assert_allclose(got, want, **TOL)
    with torch.no_grad():
        np.testing.assert_allclose(got, _naive_moe(mod, cfg, torch.from_numpy(x)).numpy(), **TOL)


def test_aux_loss_uniform_router_is_minimal():
    """A perfectly uniform router gives aux ~= weight (its minimum), and
    every expert ties: top-k must then take the lowest indices."""
    cfg, ref = _cfgs()
    tree, mod = _carry(cfg, ref)
    tree = dict(tree, router=np.zeros_like(tree["router"]))
    with torch.no_grad():
        mod.router.zero_()
    x = _x((2, 64, cfg.d_model))
    want, got = _both(tree, ref, mod, cfg, x)
    np.testing.assert_allclose(got, want, **TOL)
    with torch.no_grad():
        _, aux = pm.moe_apply(mod, cfg, torch.from_numpy(x))
    assert abs(float(aux) - cfg.moe.router_aux_weight) < 2e-3


def test_top_k_prefers_the_lower_index_on_ties():
    rng = np.random.default_rng(0)
    probs = rng.integers(0, 4, (64, 12)).astype(np.float32) / 4  # many exact ties
    for k in (1, 2, 5, 12):
        vj, ij = jax.lax.top_k(jnp.asarray(probs), k)
        vt, it = pm.top_k(torch.from_numpy(probs), k)
        np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
        np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))


@pytest.mark.parametrize("batch,cf", [(5, 1.0), (3, 1.0), (1, 1.25), (7, 0.5)])
def test_capacity_rounds_like_the_reference(batch, cf):
    """cap = round(Tg * k / E * cf) with Python's round (halves to even):
    5 * 2 / 4 = 2.5 -> 2, 3 * 2 / 4 = 1.5 -> 2; held by the output."""
    cfg, ref = _cfgs(capacity_factor=cf)
    tree, mod = _carry(cfg, ref, seed=4)
    want, got = _both(tree, ref, mod, cfg, _x((batch, 1, cfg.d_model), seed=batch))
    np.testing.assert_allclose(got, want, **TOL)
