"""The fused attention kernels (``kernels/csrc/attention.cu``) against the
plain core, on the card.

Every test here needs an NVIDIA GPU and carries the ``cuda`` marker; the
``card`` fixture skips it, with a reason, where there is none. Run them on
the card with ``python -m pytest -m cuda tests/test_torch_attention_kernel.py``.

The forward's output and dQ/dK/dV are held against ``_sdpa`` in float32
on the same bf16 inputs. The kernels compute ``_sdpa``'s function at bf16
with its rounding points, differing in the order of their sums, so their
worst error (relative to the largest reference entry) may be at most
:data:`SLACK` times ``_sdpa``'s own in bf16, plus :data:`FLOOR`, half a
bf16 ulp at that entry: two sums in different orders may land on the two
sides of a rounding boundary and round the same entry that far apart. The
mean error, which no single rounding moves, may be at most
:data:`MEAN_SLACK` times ``_sdpa``'s: above it, the kernels round more
often or in other places than the plain core does.
"""

import dataclasses
import math

import pytest
import torch

from repro_torch.kernels import _build
from repro_torch.kernels import attention as fa
from repro_torch.models.attention import _mask_bias, _sdpa

pytestmark = pytest.mark.cuda

SLACK = 1.25
FLOOR = 2.0 ** -8
MEAN_SLACK = 1.1


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _inputs(card, b, sq, lk, h, kh, d, seed):
    g = torch.Generator(device=card).manual_seed(seed)
    return [torch.randn(shape, generator=g, device=card).to(torch.bfloat16)
            for shape in ((b, sq, h, d), (b, lk, kh, d), (b, lk, kh, d), (b, sq, h, d))]


def _run(fn, q, k, v, dout, dtype):
    qq, kk, vv = (t.detach().to(dtype).requires_grad_() for t in (q, k, v))
    out = fn(qq, kk, vv)
    out.backward(dout.to(dtype))
    return [t.detach().float() for t in (out, qq.grad, kk.grad, vv.grad)]


def _positions(card, kind, b, sq):
    ar = torch.arange(sq, device=card)[None].expand(b, sq)
    if kind == "arange":
        return ar, ar
    g = torch.Generator(device=card).manual_seed(7)
    if kind == "shuffled":  # shuffled positions, every seventh key an unwritten slot (-1)
        perm = torch.stack([torch.randperm(sq, generator=g, device=card) for _ in range(b)])
        kpos = perm.clone()
        kpos[:, ::7] = -1
        return perm, kpos
    # rows with no valid key: causally, a query before every key
    qpos = ar.clone()
    qpos[:, 5] = -1
    qpos[:, sq - 3] = -4
    return qpos, ar


CASES = {
    # name: (b, s, h, kh, d, causal, window, positions)
    "train-4096": (1, 4096, 16, 8, 128, True, 0, "arange"),
    "mixtral-prefill-w4096": (2, 512, 48, 8, 128, True, 4096, "arange"),
    "mixtral-prefill-w256": (2, 512, 48, 8, 128, True, 256, "arange"),
    "ragged-1030": (1, 1030, 4, 2, 128, True, 0, "arange"),
    "ragged-1030-d64": (1, 1030, 4, 2, 64, True, 0, "arange"),
    "bidir": (2, 300, 4, 2, 128, False, 0, "arange"),
    "shuffled-and-empty-slots": (2, 700, 4, 2, 128, True, 0, "shuffled"),
    "rows-without-a-key": (1, 200, 2, 1, 128, True, 0, "dead"),
}


@pytest.mark.parametrize("name", list(CASES))
def test_fused_matches_the_plain_core(card, name):
    b, s, h, kh, d, causal, window, kind = CASES[name]
    q, k, v, dout = _inputs(card, b, s, s, h, kh, d, seed=len(name))
    qpos, kpos = _positions(card, kind, b, s)
    scale = 1.0 / math.sqrt(d)
    bias = _mask_bias(qpos, kpos, "causal" if causal else "bidir", window)

    def plain(q, k, v):
        return _sdpa(q, k, v, bias, scale)

    def fused(q, k, v):
        return fa.fused_attention(q, k, v, qpos, kpos, causal, window, scale)

    ref = _run(plain, q, k, v, dout, torch.float32)
    low = _run(plain, q, k, v, dout, torch.bfloat16)
    got = _run(fused, q, k, v, dout, torch.bfloat16)
    torch.cuda.synchronize()
    for what, r, lo, x in zip(("out", "dq", "dk", "dv"), ref, low, got):
        top = float(r.abs().max())
        e_plain = float((lo - r).abs().max()) / top
        e_fused = float((x - r).abs().max()) / top
        assert math.isfinite(e_fused) and e_fused <= SLACK * e_plain + FLOOR, (
            f"{name} {what}: worst error fused {e_fused:.3e} against bf16 plain {e_plain:.3e}")
        m_plain, m_fused = float((lo - r).abs().mean()), float((x - r).abs().mean())
        assert m_fused <= MEAN_SLACK * m_plain, (
            f"{name} {what}: mean error fused {m_fused:.3e} against bf16 plain {m_plain:.3e}")


def test_rows_without_a_key_read_the_mean_of_v(card):
    b, s, h, kh, d = 1, 200, 2, 1, 128
    q, k, v, _ = _inputs(card, b, s, s, h, kh, d, seed=3)
    qpos, kpos = _positions(card, "dead", b, s)
    out = fa.fused_attention(q, k, v, qpos, kpos, True, 0, d ** -0.5).float()
    mean = v.float().mean(dim=1)  # (B, KH, D)
    for row in (5, s - 3):
        torch.testing.assert_close(out[0, row], mean[0].expand(h, d), rtol=0, atol=2e-2)


def test_gradients_are_bit_identical_from_run_to_run(card):
    b, s, h, kh, d = 2, 1030, 8, 2, 128
    q, k, v, dout = _inputs(card, b, s, s, h, kh, d, seed=11)
    pos = torch.arange(s, device=card)[None].expand(b, s)

    def fused(q, k, v):
        return fa.fused_attention(q, k, v, pos, pos, True, 0, d ** -0.5)

    first = _run(fused, q, k, v, dout, torch.bfloat16)
    second = _run(fused, q, k, v, dout, torch.bfloat16)
    assert all(torch.equal(x, y) for x, y in zip(first, second))


def test_launch_counts_per_call(card):
    q, k, v, dout = _inputs(card, 1, 256, 256, 4, 2, 64, seed=1)
    pos = torch.arange(256, device=card)[None]
    before = dict(_build.LAUNCHES)
    with torch.no_grad():
        fa.fused_attention(q, k, v, pos, pos, True, 0, 0.125)
    assert _build.LAUNCHES["attn_fwd"] == before["attn_fwd"] + 2
    assert _build.LAUNCHES["attn_bwd"] == before["attn_bwd"]
    qq = q.detach().requires_grad_()
    fa.fused_attention(qq, k, v, pos, pos, True, 0, 0.125).backward(dout)
    assert _build.LAUNCHES["attn_fwd"] == before["attn_fwd"] + 4
    assert _build.LAUNCHES["attn_bwd"] == before["attn_bwd"] + 3
    assert all(_build.LAUNCHES[n] == before[n] for n in _build.STENCIL_LAUNCHES)


def test_refuses_what_it_does_not_take(card):
    q, k, v, _ = _inputs(card, 1, 64, 64, 4, 2, 128, seed=2)
    pos = torch.arange(64, device=card)[None]
    for bad in (q.float(), q[:, :1], q.cpu()):
        with pytest.raises(ValueError, match="fused attention takes"):
            fa.fused_attention(bad, k, v, pos, pos, True, 0, 0.1)


@pytest.mark.parametrize("remat", ["full", "dots"])
def test_train_step_runs_the_fused_core(card, remat):
    """One bf16 train step of a reduced InternLM2 with 64-wide heads: the
    fused core's launches, and its loss and first moments against the same
    step with the plain core (``attn_impl="plain"``) within bf16's noise."""
    from repro_torch.configs import get_arch
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.data import DataConfig, make_batch
    from repro_torch.train import TrainConfig, init_train_state, make_train_step

    cfg = dataclasses.replace(get_arch("internlm2-1.8b").reduced(), head_dim=64, dtype="bfloat16")
    batch = make_batch(cfg, ShapeSpec("tiny", 256, 4, "train"), DataConfig(), 0, "cuda")
    got = {}
    for impl in ("auto", "plain"):
        tcfg = TrainConfig(microbatches=2, remat=remat, attn_impl=impl)
        torch.manual_seed(0)
        state = init_train_state(cfg, tcfg, device="cuda")
        before = dict(_build.LAUNCHES)
        _, metrics = make_train_step(cfg, tcfg)(state, batch)
        torch.cuda.synchronize()
        launched = {n: _build.LAUNCHES[n] - before[n] for n in ("attn_fwd", "attn_bwd")}
        got[impl] = (float(metrics["lm_loss"]), state["opt"]["m"], launched)
    (loss, m, launched), (loss_p, m_p, launched_p) = got["auto"], got["plain"]
    # 4 layers x 2 microbatches: a forward and, under remat, its recompute; one backward
    assert launched == {"attn_fwd": 2 * 2 * 8, "attn_bwd": 3 * 8}
    assert launched_p == {"attn_fwd": 0, "attn_bwd": 0}
    assert math.isfinite(loss) and abs(loss - loss_p) <= 1e-2 * abs(loss_p)
    for n in m_p:
        top = float(m_p[n].float().abs().max())
        assert float((m[n].float() - m_p[n].float()).abs().max()) <= 0.05 * top + 1e-8, n
