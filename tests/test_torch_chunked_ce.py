"""The port's losses (``repro_torch.models.model.chunked_ce`` and
``lm_loss``) against the JAX package's: ``chunked_ce`` is a memory
optimization, not an approximation, so its value equals the reference's
and plain CE for every chunk count, and its autograd gradients (through
``forward_hidden`` and ``torch.utils.checkpoint``) equal ``jax.grad`` of
the reference, leaf by leaf through the parameter carry. The reference's
``tests/test_chunked_ce.py`` on the port. Tolerance: f32, rtol = atol =
1e-4 on values; on gradients rtol = 1e-4 with atol = 1e-4 of the leaf's
largest |entry|, since the leaves' scales span 1e-2 (a norm) to 3 (the
embedding rows of the tokens used) and a fixed atol would be loose for
one and tight for the other.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as RC
from repro.models.model import _head as r_head
from repro.models.model import chunked_ce as r_chunked_ce
from repro.models.model import forward_hidden as r_forward_hidden
from repro.models.model import init_model as r_init_model
from repro.models.model import lm_loss as r_lm_loss
from repro_torch.configs import get_arch
from repro_torch.models import chunked_ce, forward_hidden, from_reference_params, lm_loss
from repro_torch.models.convert import reference_leaves
from repro_torch.models.model import _head

ARCH = "internlm2-1.8b"


def _setup(b, s, seed=0):
    cfg, ref = get_arch(ARCH).reduced(), RC.get_arch(ARCH).reduced()
    tree = jax.device_get(r_init_model(ref, jax.random.PRNGKey(seed)))
    model = from_reference_params(cfg, tree, device="cpu")
    rng = np.random.default_rng(seed + 1)
    tokens = rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)
    labels = rng.integers(-1, cfg.vocab, (b, s)).astype(np.int32)
    return cfg, ref, tree, model, tokens, labels


@pytest.mark.parametrize("n_chunks", [1, 2, 4, 7, 8])
def test_chunked_matches_plain_and_reference(n_chunks):
    cfg, ref, tree, model, tokens, labels = _setup(2, 32)
    hj, _, _ = r_forward_hidden(tree, ref, {"tokens": jnp.asarray(tokens)})
    want = float(r_chunked_ce(ref, tree, hj, jnp.asarray(labels), n_chunks))
    with torch.no_grad():
        h, _, _ = forward_hidden(model, cfg, {"tokens": torch.from_numpy(tokens)})
        plain = lm_loss(_head(cfg, model, h), torch.from_numpy(labels))
        got = chunked_ce(cfg, model, h, torch.from_numpy(labels), n_chunks)
    np.testing.assert_allclose(float(got), float(plain), rtol=1e-6)
    np.testing.assert_allclose(float(got), want, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(
        float(plain), float(r_lm_loss(r_head(ref, tree, hj), jnp.asarray(labels))), rtol=1e-4)


def test_chunked_grads_match_jax_grad():
    cfg, ref, tree, model, tokens, _ = _setup(2, 16)
    labels = np.roll(tokens, -1, axis=1)

    def r_loss(p, n):
        h, _, _ = r_forward_hidden(p, ref, {"tokens": jnp.asarray(tokens)})
        return r_chunked_ce(ref, p, h, jnp.asarray(labels), n)

    want = jax.device_get(jax.grad(lambda p: r_loss(p, 4))(tree))
    grads = {}
    for n in (1, 4):
        model.zero_grad(set_to_none=True)
        h, _, _ = forward_hidden(model, cfg, {"tokens": torch.from_numpy(tokens)})
        chunked_ce(cfg, model, h, torch.from_numpy(labels), n).backward()
        grads[n] = {k: p.grad.clone() for k, p in model.named_parameters()}
    leaves = list(reference_leaves(model, want))
    assert {k for k, _ in leaves} == set(grads[4])
    for name, g in leaves:
        tol = dict(rtol=1e-4, atol=1e-4 * float(np.abs(g).max()), err_msg=name)
        np.testing.assert_allclose(grads[4][name].numpy(), g, **tol)
        np.testing.assert_allclose(grads[4][name].numpy(), grads[1][name].numpy(), **tol)


def test_all_labels_masked_is_zero():
    cfg, _, _, model, _, _ = _setup(1, 8)
    with torch.no_grad():
        h, _, _ = forward_hidden(model, cfg, {"tokens": torch.zeros(1, 8, dtype=torch.int32)})
        loss = chunked_ce(cfg, model, h, torch.full((1, 8), -1, dtype=torch.int32), 2)
    assert float(loss) == 0.0
