"""The port's model forward (``repro_torch.models.model``: ``forward``,
``forward_hidden``, ``Model.forward``, blocks and stacks) against the JAX
package's, for all ten registered architectures reduced (the reference's
``tests/test_models_smoke.py`` forward on the port), with the reference's
``init_model`` tree carried bit for bit and numpy-seeded tokens and
frontend embeddings.

Logits (and DeepSeek's MTP logits and the MoE aux loss) within f32
rtol = atol = 1e-4. Also: every ``remat`` name gives the same logits and
an unknown one is refused, a forward refuses tokens that do not lie on the model's device, and the
stack refuses a cache list of the wrong length.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as RC
from repro.models.model import forward as r_forward
from repro.models.model import init_model as r_init_model
from repro_torch.configs import get_arch, list_archs
from repro_torch.models import Model, forward, forward_hidden, from_reference_params
from repro_torch.models.transformer import stack_apply
from repro_torch.serve import init_caches

TOL = dict(rtol=1e-4, atol=1e-4)
ARCHS = list_archs()


def _batch(cfg, b=2, s=12, seed=0):
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)}
    if cfg.frontend or cfg.enc_dec:
        batch["frontend"] = (rng.standard_normal((b, cfg.n_frontend_tokens, cfg.d_model))
                             * 0.05).astype(np.float32)
    return batch


def _carried(name, seed=0):
    cfg, ref = get_arch(name).reduced(), RC.get_arch(name).reduced()
    tree = jax.device_get(r_init_model(ref, jax.random.PRNGKey(seed)))
    return cfg, ref, tree, from_reference_params(cfg, tree, device="cpu")


@pytest.mark.parametrize("name", ARCHS)
def test_forward_matches_reference(name):
    cfg, ref, tree, model = _carried(name)
    batch = _batch(cfg)
    want, _, wex = r_forward(tree, ref, {k: jnp.asarray(v) for k, v in batch.items()},
                             want_mtp=cfg.mtp)
    with torch.no_grad():
        got, caches, ex = model({k: torch.from_numpy(v) for k, v in batch.items()},
                                want_mtp=cfg.mtp)
    s_out = 12 + (cfg.n_frontend_tokens if cfg.frontend == "vision" else 0)
    assert caches is None and got.shape == (2, s_out, cfg.vocab) and got.dtype == torch.float32
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(float(ex["aux"]), float(wex["aux"]), **TOL)
    if cfg.mtp:
        assert ex["mtp_logits"].shape[1] == s_out - 1
        np.testing.assert_allclose(ex["mtp_logits"].numpy(), np.asarray(wex["mtp_logits"]), **TOL)
    else:
        assert "mtp_logits" not in ex


def test_forward_hidden_is_forward_before_the_head():
    cfg, _, _, model = _carried("gemma-7b")  # tied embeddings, emb_scale, rms offset
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg).items()}
    with torch.no_grad():
        hn, _, _ = forward_hidden(model, cfg, batch)
        logits, _, _ = forward(model, cfg, batch)
    torch.testing.assert_close(hn @ model.embed.T, logits, rtol=0, atol=0)


def test_module_forwards_are_the_apply_functions():
    """``Stack.forward``/``Block.forward`` of an enc-dec decoder (cross
    attention) run what ``stack_apply``/``block_apply`` run."""
    from repro_torch.models.transformer import block_apply

    cfg, _, _, model = _carried("whisper-medium")
    g = torch.Generator().manual_seed(0)
    x = torch.randn(2, 5, cfg.d_model, generator=g)
    enc = torch.randn(2, cfg.n_frontend_tokens, cfg.d_model, generator=g)
    pos = torch.arange(5)[None].expand(2, 5)
    with torch.no_grad():
        want, _, _ = stack_apply(model.decoder, cfg, x, positions=pos, enc_out=enc, cross=True)
        got, _, _ = model.decoder(x, positions=pos, enc_out=enc)
        torch.testing.assert_close(got, want, rtol=0, atol=0)
        layer = model.decoder.layers[0]
        want, _, _ = block_apply(layer, cfg, "attn", "mlp", x, positions=pos, mode="causal",
                                 cache=None, enc_out=enc, impl="auto", cross=True)
        got, _, _ = layer(x, positions=pos, enc_out=enc)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_remat_other_than_none_is_refused():
    """The reference's five remat names run (they change memory, never
    values: ``tests/test_torch_train_step.py``); any other name is refused
    (the reference would take it for full remat)."""
    cfg, _, _, model = _carried("llama3-8b")
    batch = {"tokens": torch.zeros(1, 4, dtype=torch.int32)}
    want, _, _ = forward(model, cfg, batch)
    for remat in ("dots", "dots_no_batch", "full", "save_block_io"):
        got, _, _ = forward(model, cfg, batch, remat=remat)
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    for remat in ("everything", "dot", ""):
        with pytest.raises(ValueError, match="unknown remat policy"):
            forward(model, cfg, batch, remat=remat)


def test_forward_refuses_tokens_off_the_models_device():
    cfg = get_arch("llama3-8b").reduced()
    model = Model(cfg, device="meta")
    with pytest.raises(ValueError, match="tokens on cpu"):
        model({"tokens": torch.zeros(1, 4, dtype=torch.int32)})


def test_stack_refuses_a_cache_list_of_another_length():
    cfg, _, _, model = _carried("llama3-8b")
    caches = init_caches(cfg, 1, 8, device="cpu")["stack"][:-1]
    x = torch.zeros(1, 2, cfg.d_model)
    with pytest.raises(ValueError, match="3 layer caches for 4 layers"):
        stack_apply(model.stack, cfg, x, positions=torch.zeros(1, 2, dtype=torch.long),
                    caches=caches)
