"""The port's shared layers and attention variants
(``repro_torch.models.layers``, ``repro_torch.models.attention``) against
the JAX package's, on numpy-seeded inputs with the reference's parameters
carried bit for bit (``repro_torch.models.convert.load_reference_tree``).

The reference's ``tests/test_attention.py`` on the port: GQA with 1, 2 and
4 KV heads, SWA, chunked = plain (also at a length that is not a chunk
multiple), prefill + token-by-token decode = the full pass, the SWA ring
cache across a rollover, MLA's absorbed decode = its expanded prefill, and
M-RoPE; plus the cache writes (the clamp of
``lax.dynamic_update_slice_in_dim``, ring slots) and slot positions.
Tolerance: f32, rtol = atol = 1e-4 unless a test says otherwise.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as RC
from repro.configs.base import ArchConfig as RArchConfig
from repro.configs.base import AttnConfig as RAttnConfig
from repro.models import attention as ra
from repro.models import layers as rl
from repro_torch.configs import get_arch
from repro_torch.configs.base import ArchConfig, AttnConfig
from repro_torch.models import attention as pa
from repro_torch.models import layers as pl
from repro_torch.models.convert import load_reference_tree

TOL = dict(rtol=1e-4, atol=1e-4)


def _cfgs(**kw):
    d = dict(name="t", family="dense", n_layers=1, d_model=32, n_heads=4,
             n_kv_heads=2, d_ff=64, vocab=64, head_dim=8, rope="standard", dtype="float32")
    d.update(kw)
    attn = d.pop("attn", None)
    port = ArchConfig(**d, **({"attn": AttnConfig(**attn)} if attn else {}))
    ref = RArchConfig(**d, **({"attn": RAttnConfig(**attn)} if attn else {}))
    return port, ref


def _carry_attn(cfg, ref, seed=0, cross=False):
    tree = jax.device_get(ra.attn_init(jax.random.PRNGKey(seed), ref, jnp.float32, cross=cross))
    mod = pa.Attention(pl.Init(torch.device("meta")), cfg, torch.float32, cross=cross)
    mod.to_empty(device="cpu")
    return tree, load_reference_tree(mod, tree)


def _x(shape, seed=1, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _pos(b, s):
    return np.broadcast_to(np.arange(s)[None], (b, s)).astype(np.int32)


def _run_both(tree, ref, mod, cfg, x, pos, **kw):
    want, _ = ra.attention(tree, ref, jnp.asarray(x), positions=jnp.asarray(pos), **kw)
    with torch.no_grad():
        got, _ = pa.attention(mod, cfg, torch.from_numpy(x), positions=torch.from_numpy(pos), **kw)
    return np.asarray(want), got.numpy()


# ---------------------------------------------------------------------------
# Layers
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("offset", [0.0, 1.0])
def test_rmsnorm_matches_reference(offset):
    x, w = _x((3, 5, 16)), _x((16,), seed=2)
    want = rl.rmsnorm(jnp.asarray(w), jnp.asarray(x), offset)
    got = pl.rmsnorm(torch.from_numpy(w), torch.from_numpy(x), offset)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("act", ["silu", "geglu", "relu2"])
def test_mlp_matches_reference(act):
    tree = jax.device_get(rl.mlp_init(jax.random.PRNGKey(0), 16, 48, act, jnp.float32))
    mod = pl.MLP(pl.Init(torch.device("meta")), 16, 48, act, torch.float32).to_empty(device="cpu")
    load_reference_tree(mod, tree)
    x = _x((2, 7, 16))
    want = rl.mlp(tree, jnp.asarray(x), act)
    with torch.no_grad():
        got = mod(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_rope_and_positions_match_reference():
    x = _x((2, 9, 3, 16))
    pos = np.random.default_rng(4).integers(0, 5000, (2, 9)).astype(np.int32)
    np.testing.assert_allclose(pl.rope_freqs(16, 500000.0).numpy(),
                               np.asarray(rl.rope_freqs(16, 500000.0)), rtol=1e-6)
    want = rl.apply_rope(jnp.asarray(x), jnp.asarray(pos), 10000.0)
    got = pl.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 10000.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(pl.sinusoidal_positions(40, 24).numpy(),
                               np.asarray(rl.sinusoidal_positions(40, 24)), **TOL)


def test_mrope_rotate_matches_reference():
    x = _x((2, 6, 3, 16))
    p3 = np.random.default_rng(5).integers(0, 50, (2, 3, 6)).astype(np.int32)
    want = rl.mrope_rotate(jnp.asarray(x), jnp.asarray(p3), (4, 2, 2), 10000.0)
    got = pl.mrope_rotate(torch.from_numpy(x), torch.from_numpy(p3), (4, 2, 2), 10000.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    with pytest.raises(ValueError, match="sections"):
        pl.mrope_rotate(torch.from_numpy(x), torch.from_numpy(p3), (4, 2, 1), 10000.0)


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kv_heads", [1, 2, 4])
def test_gqa_matches_reference(kv_heads):
    cfg, ref = _cfgs(n_kv_heads=kv_heads)
    tree, mod = _carry_attn(cfg, ref)
    want, got = _run_both(tree, ref, mod, cfg, _x((2, 24, 32)), _pos(2, 24))
    np.testing.assert_allclose(got, want, **TOL)


def test_swa_matches_reference():
    cfg, ref = _cfgs(attn=dict(kind="swa", window=5))
    tree, mod = _carry_attn(cfg, ref)
    want, got = _run_both(tree, ref, mod, cfg, _x((1, 20, 32)), _pos(1, 20))
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("seq", [64, 1030])
def test_chunked_matches_plain(seq):
    """The online softmax equals the plain one, also with padded Q and KV
    blocks (1030 = one block of 1024 + 6), and the reference's."""
    cfg, ref = _cfgs()
    tree, mod = _carry_attn(cfg, ref)
    x, pos = _x((2, seq, 32)), _pos(2, seq)
    want, got = _run_both(tree, ref, mod, cfg, x, pos, impl="chunked")
    _, plain = _run_both(tree, ref, mod, cfg, x, pos, impl="plain")
    np.testing.assert_allclose(got, plain, **TOL)
    np.testing.assert_allclose(got, want, **TOL)


def _zero_cache(b, length, kh, dh):
    return ({"k": np.zeros((b, length, kh, dh), np.float32),
             "v": np.zeros((b, length, kh, dh), np.float32), "idx": np.int32(0)})


def _stream(tree, ref, mod, cfg, x, pos, split, cache):
    """Prefill ``split`` tokens, then decode one at a time, in both packages."""
    jc = {k: jnp.asarray(v) for k, v in cache.items()}
    tc = {k: torch.tensor(v) for k, v in cache.items()}
    jx, tx, jp, tp = jnp.asarray(x), torch.from_numpy(x), jnp.asarray(pos), torch.from_numpy(pos)
    outs_j, outs_t = [], []
    cuts = [(0, split)] + [(t, t + 1) for t in range(split, x.shape[1])]
    with torch.no_grad():
        for a, b in cuts:
            yj, jc = ra.attention(tree, ref, jx[:, a:b], positions=jp[:, a:b], cache=jc)
            yt, tc2 = pa.attention(mod, cfg, tx[:, a:b], positions=tp[:, a:b], cache=tc)
            assert tc2 is tc  # updated in place
            outs_j.append(np.asarray(yj))
            outs_t.append(yt.numpy())
            for k in tc:
                np.testing.assert_allclose(tc[k].numpy(), np.asarray(jc[k]), **TOL)
    return np.concatenate(outs_j, 1), np.concatenate(outs_t, 1)


def test_decode_stream_matches_full():
    """prefill + token-by-token decode == full causal forward, and every
    cache state equals the reference's."""
    cfg, ref = _cfgs()
    tree, mod = _carry_attn(cfg, ref)
    b, s = 2, 16
    x, pos = _x((b, s, 32)), _pos(b, s)
    full, _ = _run_both(tree, ref, mod, cfg, x, pos)
    want, got = _stream(tree, ref, mod, cfg, x, pos, 9, _zero_cache(b, s, 2, 8))
    np.testing.assert_allclose(got, full, **TOL)
    np.testing.assert_allclose(got, want, **TOL)


def test_swa_ring_cache_decode():
    """Ring-buffered SWA cache: a prefill longer than the window rolls the
    ring over; decode equals the full SWA forward."""
    w = 6
    cfg, ref = _cfgs(attn=dict(kind="swa", window=w))
    tree, mod = _carry_attn(cfg, ref)
    b, s = 1, 25
    x, pos = _x((b, s, 32)), _pos(b, s)
    full, _ = _run_both(tree, ref, mod, cfg, x, pos)
    want, got = _stream(tree, ref, mod, cfg, x, pos, 13, _zero_cache(b, w, 2, 8))
    np.testing.assert_allclose(got, full, **TOL)
    np.testing.assert_allclose(got, want, **TOL)


def test_mla_decode_matches_prefill_logits():
    """Absorbed-matmul MLA decode == expanded MLA forward (last position),
    and == the reference's decode, caches included."""
    cfg, ref = get_arch("deepseek-v3-671b").reduced(), RC.get_arch("deepseek-v3-671b").reduced()
    tree, mod = _carry_attn(cfg, ref)
    b, s = 2, 12
    x, pos = _x((b, s, cfg.d_model)), _pos(b, s)
    full_j, full_t = _run_both(tree, ref, mod, cfg, x, pos)
    np.testing.assert_allclose(full_t, full_j, **TOL)
    cache = {"ckv": np.zeros((b, s, cfg.attn.kv_lora_rank), np.float32),
             "krope": np.zeros((b, s, cfg.attn.rope_head_dim), np.float32), "idx": np.int32(0)}
    want, got = _stream(tree, ref, mod, cfg, x, pos, s - 1, cache)
    np.testing.assert_allclose(got[:, -1], full_t[:, -1], rtol=5e-4, atol=5e-4)  # the reference's
    np.testing.assert_allclose(got, want, **TOL)


def test_mrope_runs_and_differs_from_standard():
    cfg, ref = _cfgs(rope="mrope", mrope_sections=(2, 1, 1))
    tree, mod = _carry_attn(cfg, ref)
    b, s = 1, 10
    x = _x((b, s, 32))
    p3 = np.broadcast_to(np.arange(s)[None, None], (b, 3, s)).astype(np.int32).copy()
    want, got = _run_both(tree, ref, mod, cfg, x, p3)
    np.testing.assert_allclose(got, want, **TOL)
    p3b = p3.copy()
    p3b[:, 1] = 0  # diverging h/w ids must change the result
    want_b, got_b = _run_both(tree, ref, mod, cfg, x, p3b)
    np.testing.assert_allclose(got_b, want_b, **TOL)
    assert not np.allclose(got, got_b)


def test_cross_attention_writes_then_serves_its_cache():
    cfg, ref = _cfgs()
    tree, mod = _carry_attn(cfg, ref, cross=True)
    x, enc = _x((2, 3, 32)), _x((2, 5, 32), seed=7)
    pos = _pos(2, 3)
    cache = _zero_cache(2, 5, 2, 8)
    jc = {k: jnp.asarray(v) for k, v in cache.items()}
    tc = {k: torch.tensor(v) for k, v in cache.items()}
    yj, jc = ra.attention(tree, ref, jnp.asarray(x), positions=jnp.asarray(pos), mode="cross",
                          cache=jc, kv_source=jnp.asarray(enc))
    with torch.no_grad():
        yt, tc = pa.attention(mod, cfg, torch.from_numpy(x), positions=torch.from_numpy(pos),
                              mode="cross", cache=tc, kv_source=torch.from_numpy(enc))
        np.testing.assert_allclose(yt.numpy(), np.asarray(yj), **TOL)
        y2, _ = pa.attention(mod, cfg, torch.from_numpy(x), positions=torch.from_numpy(pos),
                             mode="cross", cache=tc)  # from the cache alone
    np.testing.assert_allclose(y2.numpy(), np.asarray(yj), **TOL)
    for k in tc:
        np.testing.assert_allclose(tc[k].numpy(), np.asarray(jc[k]), **TOL)


# ---------------------------------------------------------------------------
# Cache bookkeeping
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("idx,s,ring", [(0, 3, 0), (5, 3, 0), (7, 3, 0), (9, 3, 0), (40, 10, 0),
                                        (0, 3, 8), (6, 4, 8), (3, 8, 8), (5, 13, 8), (21, 1, 8)])
def test_write_cache_matches_reference(idx, s, ring):
    """Linear caches clamp the start to [0, L - S] as
    ``lax.dynamic_update_slice_in_dim`` does (idx 9 and 40 write at L - S,
    never out of range); rings place the update (or its last L entries)
    modulo L. ``idx`` advances by S either way; the slot positions follow."""
    length = 10 if not ring else ring
    rng = np.random.default_rng(idx * 31 + s)
    buf = rng.standard_normal((2, length, 3)).astype(np.float32)
    val = rng.standard_normal((2, s, 3)).astype(np.float32)
    pos = _pos(2, s) + idx
    jc = ra._write_cache({"k": jnp.asarray(buf), "idx": jnp.int32(idx)}, {"k": jnp.asarray(val)},
                         jnp.asarray(pos), ring=ring)
    tc = {"k": torch.from_numpy(buf.copy()), "idx": torch.tensor(idx, dtype=torch.int32)}
    out = pa._write_cache(tc, {"k": torch.from_numpy(val)}, torch.from_numpy(pos), ring=ring)
    assert out is tc and tc["idx"].dtype == torch.int32
    np.testing.assert_array_equal(tc["k"].numpy(), np.asarray(jc["k"]))
    assert int(tc["idx"]) == int(jc["idx"]) == idx + s
    np.testing.assert_array_equal(pa._cache_positions(tc, ring=ring).numpy(),
                                  np.asarray(ra._cache_positions(jc, ring=ring)))


def test_write_cache_refuses_more_entries_than_slots():
    tc = {"k": torch.zeros(1, 4, 2), "idx": torch.tensor(0, dtype=torch.int32)}
    with pytest.raises(ValueError, match="4 slots"):
        pa._write_cache(tc, {"k": torch.ones(1, 5, 2)}, torch.zeros(1, 5, dtype=torch.long))


def test_mask_bias_matches_reference():
    q = np.array([[0, 3, 7, 9]], np.int32)
    k = np.array([[-1, 0, 2, 3, 6, 7, 8, 9]], np.int32)
    for mode, window in (("causal", 0), ("causal", 3), ("bidir", 0)):
        want = np.asarray(ra._mask_bias(jnp.asarray(q), jnp.asarray(k), mode, window))
        got = pa._mask_bias(torch.from_numpy(q), torch.from_numpy(k), mode, window)
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), want)
    assert pa.NEG_INF == ra.NEG_INF and pa.CHUNKED_THRESHOLD == ra.CHUNKED_THRESHOLD
