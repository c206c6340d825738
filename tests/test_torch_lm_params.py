"""The LM parameter trees of the port (``repro_torch.models``) and its KV
caches (``repro_torch.serve.kvcache``), against the JAX package's.

* Full size, all ten registered architectures: ``count_params``,
  ``active_params`` and ``cache_bytes(cfg, 64, 8192)`` (the decode cell's
  shape) equal the reference's exactly. The port builds on the meta device
  and the reference under ``jax.eval_shape``, so neither allocates.
* ``cfg.reduced()`` for every architecture: the reference's ``init_model``
  tree (numpy leaves) carries into a port :class:`Model` as a bijection --
  every leaf into exactly one parameter, every parameter filled -- with
  bit-equal values; the carried model has the shapes and dtypes of a model
  the port initialises itself, from an explicit ``torch.Generator``.
* The caches: per-layer caches hold the reference's stacked leaves (shape
  and dtype, ``idx`` once per layer), on the CPU and on the meta device.
* Without a card and without a device, ``Model`` raises; a model on the
  CPU, asked for, runs its forward there.
"""

import math

import jax
import numpy as np
import pytest
import torch

import repro.configs as RC
from repro.models.model import active_params as r_active_params
from repro.models.model import count_params as r_count_params
from repro.models.model import init_model as r_init_model
from repro.serve.kvcache import cache_bytes as r_cache_bytes
from repro.serve.kvcache import init_caches as r_init_caches
from repro_torch.configs import get_arch, list_archs
from repro_torch.models import Model, active_params, count_params, from_reference_params, segments
from repro_torch.models.convert import reference_leaves
from repro_torch.serve import cache_bytes, init_caches

ARCHS = list_archs()


@pytest.mark.parametrize("name", ARCHS)
def test_full_size_counts_equal_the_references(name):
    cfg, ref = get_arch(name), RC.get_arch(name)
    assert count_params(cfg) == r_count_params(ref)
    assert active_params(cfg) == r_active_params(ref)
    assert cache_bytes(cfg, 64, 8192) == r_cache_bytes(ref, 64, 8192)


@pytest.mark.parametrize("name", ["llama3-8b", "deepseek-v3-671b", "whisper-medium"])
def test_full_size_model_on_meta_allocates_nothing(name):
    cfg = get_arch(name)
    model = Model(cfg, device="meta")
    assert all(p.is_meta for p in model.parameters())
    assert sum(p.numel() for p in model.parameters()) == count_params(cfg)
    if cfg.rope == "learned":
        assert tuple(model.pos_embed.shape) == (32768, cfg.d_model)


def _reference_tree(ref, seed=0):
    return jax.device_get(r_init_model(ref, jax.random.PRNGKey(seed)))


@pytest.mark.parametrize("name", ARCHS)
def test_reduced_carry_is_a_bit_equal_bijection(name):
    cfg, ref = get_arch(name).reduced(), RC.get_arch(name).reduced()
    tree = _reference_tree(ref)
    model = from_reference_params(cfg, tree, device="cpu")
    params = dict(model.named_parameters())
    leaves = list(reference_leaves(model, tree))
    names = [n for n, _ in leaves]
    assert len(names) == len(set(names)) == len(params)
    assert set(names) == set(params)
    for n, value in leaves:
        got = params[n].detach().numpy()
        assert got.dtype == value.dtype and got.shape == value.shape, n
        np.testing.assert_array_equal(got, value, err_msg=n)
    n_ref = sum(int(np.prod(np.shape(leaf))) for leaf in jax.tree.leaves(tree))
    assert sum(p.numel() for p in model.parameters()) == n_ref == count_params(cfg)


@pytest.mark.parametrize("name", ARCHS)
def test_reduced_port_init_has_the_carried_layout(name):
    cfg = get_arch(name).reduced()
    carried = dict(from_reference_params(cfg, _reference_tree(RC.get_arch(name).reduced()),
                                         device="cpu").named_parameters())
    g = torch.Generator(device="cpu").manual_seed(7)
    mine = dict(Model(cfg, device="cpu", generator=g).named_parameters())
    assert {n: (p.shape, p.dtype) for n, p in mine.items()} == {
        n: (p.shape, p.dtype) for n, p in carried.items()
    }
    again = dict(Model(cfg, device="cpu",
                       generator=torch.Generator(device="cpu").manual_seed(7)).named_parameters())
    for n, p in mine.items():
        assert torch.isfinite(p).all(), n
        assert torch.equal(p, again[n]), n  # the generator alone decides the values


def test_init_distributions_follow_the_reference():
    """Matmul weights: truncated normal at 1/sqrt(fan_in), |w| <= 2 scale;
    norms ones (zeros for gemma's offset); the routed experts' fan-in is
    each expert's d_model, not the stack's leading axis."""
    cfg = get_arch("mixtral-8x22b").reduced()
    model = Model(cfg, device="cpu", generator=torch.Generator().manual_seed(1)).requires_grad_(False)
    wq = model.stack.layers[0].mixer.wq
    scale = 1.0 / math.sqrt(cfg.d_model)
    assert float(wq.abs().max()) <= 2.0 * scale * (1 + 1e-6)
    assert 0.5 * scale < float(wq.std()) < 1.0 * scale
    experts = model.stack.layers[0].ffn.experts
    assert float(experts.gate.abs().max()) <= 2.0 * scale * (1 + 1e-6)
    assert torch.equal(model.final_norm, torch.ones_like(model.final_norm))
    gemma = Model(get_arch("gemma-7b").reduced(), device="cpu",
                  generator=torch.Generator().manual_seed(1))
    assert torch.equal(gemma.final_norm, torch.zeros_like(gemma.final_norm))


@pytest.mark.parametrize("name", ARCHS)
@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_caches_hold_the_references_leaves(name, device):
    cfg, ref = get_arch(name).reduced(), RC.get_arch(name).reduced()
    batch, max_len = 3, 40
    enc = cfg.enc_dec
    rc = jax.eval_shape(lambda: r_init_caches(ref, batch, max_len, include_enc=enc))
    mine = init_caches(cfg, batch, max_len, include_enc=enc, device=device)
    layers = mine["stack"]
    assert len(layers) == cfg.n_layers
    i = 0
    for si, (pattern, reps) in enumerate(segments(cfg)):
        for r in range(reps):
            for j in range(len(pattern)):
                want = rc["stack"][f"seg{si}"][j]
                got = layers[i]
                assert set(got) == set(want)
                for part, leaves in want.items():
                    assert set(got[part]) == set(leaves)
                    for k, sd in leaves.items():
                        t = got[part][k]
                        assert tuple(t.shape) == tuple(sd.shape[1:]), (name, i, part, k)
                        assert str(t.dtype).removeprefix("torch.") == str(sd.dtype), (name, k)
                        assert t.device.type == device
                        if device == "cpu":
                            assert not t.any()
                i += 1
    if enc:
        assert tuple(mine["enc_out"].shape) == tuple(rc["enc_out"].shape)
    assert cache_bytes(cfg, batch, max_len) == r_cache_bytes(ref, batch, max_len)


def test_no_card_means_no_model(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_arch("llama3-8b").reduced()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Model(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_caches(cfg, 1, 8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        from_reference_params(cfg, _reference_tree(RC.get_arch("llama3-8b").reduced()))
    model = Model(cfg, device="cpu")
    with torch.no_grad():
        logits, _, _ = model({"tokens": torch.zeros(1, 4, dtype=torch.long)})
    assert logits.shape == (1, 4, cfg.vocab) and logits.device.type == "cpu"


def test_carry_refuses_a_tree_that_does_not_fit():
    cfg = get_arch("llama3-8b").reduced()
    tree = _reference_tree(RC.get_arch("llama3-8b").reduced())
    extra = dict(tree, bogus=np.zeros(3, np.float32))
    with pytest.raises(KeyError, match="bogus"):
        from_reference_params(cfg, extra, device="cpu")
    short = {k: v for k, v in tree.items() if k != "lm_head"}
    with pytest.raises(KeyError, match="lm_head"):
        from_reference_params(cfg, short, device="cpu")
    wrong = dict(tree, final_norm=np.zeros(7, np.float32))
    with pytest.raises(ValueError, match="final_norm"):
        from_reference_params(cfg, wrong, device="cpu")
