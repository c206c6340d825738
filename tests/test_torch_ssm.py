"""The port's Mamba-2 SSD block (``repro_torch.models.ssm``) against the
JAX package's, on numpy-seeded inputs with the reference's parameters
carried bit for bit.

The reference's ``tests/test_ssm.py`` on the port: the chunked scan at
chunk 4, 8, 16, 48 and 64 equals the reference's chunked scan and the
naive recurrence (the reference's and the port's own), with an initial
state too; streaming the block (prefill, then one token at a time) equals
one full pass and the reference's stream, states included; a length that
is not a chunk multiple. Plus ``_segsum``'s exact zeros above the diagonal
and the shifted multiply-add conv. Tolerance: f32, rtol = atol = 1e-4
(5e-4 for the stream against the full pass, the reference's own).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as RC
from repro.models import ssm as rs
from repro_torch.configs import get_arch
from repro_torch.models import ssm as ps
from repro_torch.models.convert import load_reference_tree
from repro_torch.models.layers import Init

TOL = dict(rtol=1e-4, atol=1e-4)


def _rand_ssd(b=2, l=48, h=4, p=8, n=16, seed=0):
    rng = np.random.default_rng(seed)
    xdt = rng.standard_normal((b, l, h, p)) * 0.5
    dta = -np.log1p(np.exp(rng.standard_normal((b, l, h))))  # -softplus
    bm = rng.standard_normal((b, l, h, n)) * 0.3
    cm = rng.standard_normal((b, l, h, n)) * 0.3
    return [a.astype(np.float32) for a in (xdt, dta, bm, cm)]


def _j(arrs):
    return [jnp.asarray(a) for a in arrs]


def _t(arrs):
    return [torch.from_numpy(a) for a in arrs]


@pytest.mark.parametrize("chunk", [4, 8, 16, 48, 64])
def test_chunked_matches_reference(chunk):
    arrs = _rand_ssd()
    y_ref, s_ref = rs._ssd_chunked(*_j(arrs), chunk, None)
    y, s = ps._ssd_chunked(*_t(arrs), chunk, None)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_ref), **TOL)
    np.testing.assert_allclose(s.numpy(), np.asarray(s_ref), **TOL)
    y_naive, s_naive = ps.ssd_reference(*_t(arrs))
    ry_naive, rs_naive = rs.ssd_reference(*_j(arrs))
    np.testing.assert_allclose(y.numpy(), y_naive.numpy(), **TOL)
    np.testing.assert_allclose(s.numpy(), s_naive.numpy(), **TOL)
    np.testing.assert_allclose(y_naive.numpy(), np.asarray(ry_naive), **TOL)
    np.testing.assert_allclose(s_naive.numpy(), np.asarray(rs_naive), **TOL)


def test_chunked_with_initial_state():
    arrs = _rand_ssd(seed=1)
    s0 = (np.random.default_rng(9).standard_normal((2, 4, 8, 16)) * 0.2).astype(np.float32)
    y_ref, s_ref = rs._ssd_chunked(*_j(arrs), 16, jnp.asarray(s0))
    y, s = ps._ssd_chunked(*_t(arrs), 16, torch.from_numpy(s0))
    np.testing.assert_allclose(y.numpy(), np.asarray(y_ref), **TOL)
    np.testing.assert_allclose(s.numpy(), np.asarray(s_ref), **TOL)
    y_naive, s_naive = ps.ssd_reference(*_t(arrs), torch.from_numpy(s0))
    np.testing.assert_allclose(y.numpy(), y_naive.numpy(), **TOL)
    np.testing.assert_allclose(s.numpy(), s_naive.numpy(), **TOL)


def _carry(seed=0):
    cfg, ref = get_arch("mamba2-780m").reduced(), RC.get_arch("mamba2-780m").reduced()
    tree = jax.device_get(rs.ssm_init(jax.random.PRNGKey(seed), ref, jnp.float32))
    mod = ps.SSM(Init(torch.device("meta")), cfg, torch.float32).to_empty(device="cpu")
    return cfg, ref, tree, load_reference_tree(mod, tree)


def test_block_prefill_then_decode_matches_full():
    """Streaming the block one token at a time == one full-sequence pass,
    and every step (output and cache) == the reference's."""
    cfg, ref, tree, mod = _carry()
    b, s, split = 2, 24, 11
    x = (np.random.default_rng(1).standard_normal((b, s, cfg.d_model)) * 0.3).astype(np.float32)
    y_full_j, _ = rs.ssm_apply(tree, ref, jnp.asarray(x), cache=None)
    with torch.no_grad():
        y_full, none = ps.ssm_apply(mod, cfg, torch.from_numpy(x), cache=None)
    assert none is None
    np.testing.assert_allclose(y_full.numpy(), np.asarray(y_full_j), **TOL)

    shapes = ps.ssm_state_shapes(cfg, b)
    assert shapes == rs.ssm_state_shapes(ref, b)
    jc = {k: jnp.zeros(v, jnp.float32) for k, v in shapes.items()}
    tc = {k: torch.zeros(v) for k, v in shapes.items()}
    ys = []
    with torch.no_grad():
        for a, e in [(0, split)] + [(t, t + 1) for t in range(split, s)]:
            yj, jc = rs.ssm_apply(tree, ref, jnp.asarray(x[:, a:e]), cache=jc)
            yt, out = mod(torch.from_numpy(x[:, a:e]), cache=tc)  # SSM.forward
            assert out is tc  # updated in place
            np.testing.assert_allclose(yt.numpy(), np.asarray(yj), **TOL)
            for k in tc:
                np.testing.assert_allclose(tc[k].numpy(), np.asarray(jc[k]), **TOL)
            ys.append(yt.numpy())
    np.testing.assert_allclose(np.concatenate(ys, 1), y_full.numpy(), rtol=5e-4, atol=5e-4)


def test_seq_not_multiple_of_chunk():
    cfg, ref, tree, mod = _carry()
    x = np.random.default_rng(2).standard_normal((1, 19, cfg.d_model)).astype(np.float32)
    y_j, _ = rs.ssm_apply(tree, ref, jnp.asarray(x))
    with torch.no_grad():
        y, _ = ps.ssm_apply(mod, cfg, torch.from_numpy(x))
    assert y.shape == x.shape and torch.isfinite(y).all()
    np.testing.assert_allclose(y.numpy(), np.asarray(y_j), **TOL)


def test_segsum_is_exactly_zero_above_the_diagonal():
    x = torch.from_numpy(np.random.default_rng(3).standard_normal((2, 7)).astype(np.float32))
    seg = ps._segsum(x)
    np.testing.assert_allclose(seg.numpy(), np.asarray(rs._segsum(jnp.asarray(x.numpy()))), **TOL)
    lmat = torch.exp(seg)
    upper = torch.triu(torch.ones(7, 7, dtype=torch.bool), diagonal=1)
    assert torch.isneginf(seg[:, upper]).all() and (lmat[:, upper] == 0).all()
    assert (torch.diagonal(lmat, dim1=-2, dim2=-1) == 1).all()


@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv_matches_reference(with_state):
    rng = np.random.default_rng(4)
    u, w, b = (rng.standard_normal(s).astype(np.float32) for s in ((2, 5, 6), (4, 6), (6,)))
    st = rng.standard_normal((2, 3, 6)).astype(np.float32) if with_state else None
    yj, sj = rs._causal_conv(*_j([u, w, b]), None if st is None else jnp.asarray(st))
    yt, stt = ps._causal_conv(*_t([u, w, b]), None if st is None else torch.from_numpy(st))
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), **TOL)
    np.testing.assert_array_equal(stt.numpy(), np.asarray(sj))
