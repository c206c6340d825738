"""Plain reference of a dense GQA decoder's training (InternLM2's block:
pre-norm RMSNorm, rotary attention with grouped KV heads, a SiLU-gated
MLP, an untied head, mean token cross-entropy), and AdamW.

Plain PyTorch in float32 with TF32 off; it imports nothing of the system
under test. It is handed the same seeded inputs as the program: the
weights from :func:`draw` and the tokens from :func:`tokens` (a frozen
copy of the synthetic data pipeline's numpy generator), and works out
everything else again. Each layer is checkpointed (recomputed in the
backward), so a microbatch of 2 x 4,096 tokens fits beside the f32 state.

``Precision("fp8")`` is the control: every matrix product's operands are
rounded to float8 e4m3 (per-tensor scale) and the gradients flowing into
them to e5m2, the next precision below the configuration's bfloat16.
"""

from __future__ import annotations

import math
import statistics
from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint


def layout(c: dict) -> List[Tuple[str, Tuple[int, ...], str]]:
    """(name, shape, init) of every parameter, named as the program names
    them; ``init`` is ``embed`` (N(0, 0.02)), ``router`` (N(0, 0.02)),
    ``ones`` or ``fan_in`` (N(0, 1/d_in)). A configuration with
    ``n_experts`` has a router and that many SiLU-gated experts of width
    ``d_ff`` (stacked on a leading axis) in every layer's FFN."""
    d, h, kh, dh, f, v = (c["d_model"], c["n_heads"], c["n_kv_heads"], c["head_dim"],
                          c["d_ff"], c["vocab"])
    e = c.get("n_experts")
    lead, ffn = ((e,), "ffn.experts.") if e else ((), "ffn.")
    out = [("embed", (v, d), "embed"), ("final_norm", (d,), "ones"),
           ("lm_head", (d, v), "fan_in")]
    for i in range(c["n_layers"]):
        p = f"stack.layers.{i}."
        out += [(p + "norm1", (d,), "ones"), (p + "norm2", (d,), "ones"),
                (p + "mixer.wq", (d, h * dh), "fan_in"), (p + "mixer.wk", (d, kh * dh), "fan_in"),
                (p + "mixer.wv", (d, kh * dh), "fan_in"), (p + "mixer.wo", (h * dh, d), "fan_in")]
        if e:
            out.append((p + "ffn.router", (d, e), "router"))
        out += [(p + ffn + "down", (*lead, f, d), "fan_in"),
                (p + ffn + "gate", (*lead, d, f), "fan_in"),
                (p + ffn + "up", (*lead, d, f), "fan_in")]
    return out


def n_params(c: dict) -> int:
    return sum(math.prod(s) for _, s, _ in layout(c))


def draw(c: dict, seed: int, device, dtype) -> Dict[str, torch.Tensor]:
    """The weights from ``seed``: one flat buffer of ``dtype`` on
    ``device``, filled by a ``torch.Generator`` there in chunks of 2^27
    normals, each leaf a view of it scaled in place."""
    lay = layout(c)
    total = sum(math.prod(s) for _, s, _ in lay)
    flat = torch.empty(total, dtype=dtype, device=device)
    g = torch.Generator(device=device).manual_seed(seed)
    chunk = 1 << 27
    for a in range(0, total, chunk):
        n = min(chunk, total - a)
        flat[a:a + n].copy_(torch.randn(n, generator=g, device=device, dtype=torch.float32))
    out, a = {}, 0
    for name, shape, init in lay:
        n = math.prod(shape)
        w = flat[a:a + n].view(shape)
        if init == "ones":
            w.fill_(1.0)
        else:
            w.mul_(1.0 / math.sqrt(shape[-2]) if init == "fan_in" else 0.02)
        out[name] = w
        a += n
    return out


def tokens(vocab: int, seed: int, step: int, batch: int, seq: int, copy_period: int,
           noise: float) -> np.ndarray:
    """(batch, seq + 1) int32 tokens of ``step``: a random period of
    ``copy_period`` tokens repeated, a ``noise`` share replaced."""
    rng = np.random.default_rng(np.uint64(seed * 1_000_003 + step))
    base = rng.integers(0, vocab, size=(batch, copy_period), dtype=np.int64)
    reps = -(-(seq + 1) // copy_period)
    toks = np.tile(base, (1, reps))[:, : seq + 1]
    mask = rng.random((batch, seq + 1)) < noise
    toks = np.where(mask, rng.integers(0, vocab, size=(batch, seq + 1), dtype=np.int64), toks)
    return toks.astype(np.int32)


class _Round(torch.autograd.Function):
    """Round to float8 (e4m3 forward, e5m2 for the gradient), per-tensor
    scaled to the format's largest value; computed on in float32."""

    @staticmethod
    def forward(ctx, x):
        return _fp8(x, torch.float8_e4m3fn)

    @staticmethod
    def backward(ctx, g):
        return _fp8(g, torch.float8_e5m2)


def _fp8(x, fmt):
    top = torch.finfo(fmt).max
    scale = torch.clamp(x.detach().abs().amax(), min=1e-30) / top
    return (x / scale).to(fmt).to(x.dtype) * scale


class Precision:
    """What a matrix product's operands are rounded to: ``f32`` (nothing)
    or ``fp8`` (the control)."""

    def __init__(self, name: str = "f32"):
        if name not in ("f32", "fp8"):
            raise ValueError(f"unknown precision {name!r}")
        self.name = name

    def __call__(self, x):
        return _Round.apply(x) if self.name == "fp8" else x


def _rms(x, w, eps):
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * w


def _rope(x, pos, theta):
    d = x.shape[-1]
    inv = 1.0 / theta ** (torch.arange(0, d, 2, dtype=torch.float32, device=x.device) / d)
    ang = pos[:, :, None, None].float() * inv
    x1, x2 = x[..., : d // 2], x[..., d // 2:]
    return torch.cat([x1 * torch.cos(ang) - x2 * torch.sin(ang),
                      x2 * torch.cos(ang) + x1 * torch.sin(ang)], dim=-1)


def _layer(c, q8, x, pos, norm1, wq, wk, wv, wo, norm2, down, gate, up):
    b, s, _ = x.shape
    h, kh, dh = c["n_heads"], c["n_kv_heads"], c["head_dim"]
    y = _rms(x, norm1, c["norm_eps"])
    q = _rope((q8(y) @ q8(wq)).view(b, s, h, dh), pos, c["rope_theta"])
    k = _rope((q8(y) @ q8(wk)).view(b, s, kh, dh), pos, c["rope_theta"])
    v = (q8(y) @ q8(wv)).view(b, s, kh, dh)
    k, v = k.repeat_interleave(h // kh, dim=2), v.repeat_interleave(h // kh, dim=2)
    scores = torch.einsum("bqhd,bkhd->bhqk", q8(q), q8(k)) / math.sqrt(dh)
    causal = torch.ones(s, s, dtype=torch.bool, device=x.device).tril()
    p = torch.softmax(scores.masked_fill(~causal, float("-inf")), dim=-1)
    o = torch.einsum("bhqk,bkhd->bqhd", q8(p), q8(v)).reshape(b, s, h * dh)
    x = x + q8(o) @ q8(wo)
    y = q8(_rms(x, norm2, c["norm_eps"]))
    return x + q8(F.silu(y @ q8(gate)) * (y @ q8(up))) @ q8(down)


def loss(c: dict, w: Dict[str, torch.Tensor], tok: torch.Tensor, lab: torch.Tensor,
         q8: Precision) -> torch.Tensor:
    """Mean cross-entropy of ``lab`` given ``tok`` (both (B, S))."""
    b, s = tok.shape
    pos = torch.arange(s, device=tok.device)[None].expand(b, s)
    x = w["embed"][tok.long()]
    for i in range(c["n_layers"]):
        p = f"stack.layers.{i}."
        args = [w[p + n] for n in ("norm1", "mixer.wq", "mixer.wk", "mixer.wv", "mixer.wo",
                                   "norm2", "ffn.down", "ffn.gate", "ffn.up")]
        x = checkpoint(_layer, c, q8, x, pos, *args, use_reentrant=False)
    logits = q8(_rms(x, w["final_norm"], c["norm_eps"])) @ q8(w["lm_head"])
    return F.cross_entropy(logits.reshape(b * s, -1), lab.reshape(-1).long(), ignore_index=-1)


def lr_at(o: dict, step: int) -> float:
    """Linear warm-up, then cosine decay to ``min_lr_ratio`` of ``lr``."""
    if step < o["warmup_steps"]:
        return o["lr"] * step / max(1, o["warmup_steps"])
    t = (step - o["warmup_steps"]) / max(1, o["total_steps"] - o["warmup_steps"])
    t = min(max(t, 0.0), 1.0)
    r = o["min_lr_ratio"]
    return o["lr"] * (r + (1 - r) * 0.5 * (1 + math.cos(math.pi * t)))


def train(c: dict, t: dict, seed: int, device, precision: str = "f32",
          rows: float = 1.0) -> Dict:
    """``t["checked_steps"]`` AdamW steps from the seed's weights on the
    seed's batches: ``{"loss": [last microbatch's loss per step], "grad":
    {leaf: norm of the first step's clipped gradient}, "change": {leaf:
    norm of the parameters' change}}``. ``rows`` < 1 keeps that share of
    each batch's microbatches (the mean over the rest): the half-batch
    fault."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    q8, o = Precision(precision), t["optimizer"]
    w0 = draw(c, seed, device, getattr(torch, c["dtype"]))
    w = {n: v.to(torch.float32, copy=True).requires_grad_() for n, v in w0.items()}
    m = {n: torch.zeros_like(v) for n, v in w.items()}
    v2 = {n: torch.zeros_like(v) for n, v in w.items()}
    mb, out = t["microbatches"], {"loss": []}
    kept = max(1, int(mb * rows))
    for step in range(t["checked_steps"]):
        tok = torch.from_numpy(tokens(c["vocab"], seed, step, t["batch"], t["seq"],
                                      t["copy_period"], t["noise"])).to(device)
        for i in range(kept):
            rows_i = slice(i * t["batch"] // mb, (i + 1) * t["batch"] // mb)
            lo = loss(c, w, tok[rows_i, :-1], tok[rows_i, 1:], q8)
            (lo / kept).backward()
        out["loss"].append(float(lo.detach()))
        with torch.no_grad():
            gnorm = math.sqrt(sum(float(p.grad.square().sum()) for p in w.values()))
            scale = min(1.0, o["clip_norm"] / max(gnorm, 1e-9))
            k = step + 1
            lr, bc1, bc2 = lr_at(o, k), 1 - o["b1"] ** k, 1 - o["b2"] ** k
            for n, p in w.items():
                g = p.grad * scale
                m[n].mul_(o["b1"]).add_(g, alpha=1 - o["b1"])
                v2[n].mul_(o["b2"]).add_(g * g, alpha=1 - o["b2"])
                upd = (m[n] / bc1) / (torch.sqrt(v2[n] / bc2) + o["eps"]) + o["weight_decay"] * p
                p.sub_(lr * upd)
                p.grad = None
            if step == 0:
                out["grad"] = {n: float(m[n].norm()) / (1 - o["b1"]) for n in w}
    with torch.no_grad():
        out["change"] = {n: float((w[n] - w0[n].float()).norm()) for n in w}
    return out


def gaps(got: Dict, ref: Dict) -> Dict[str, float]:
    """The compared numbers of ``got`` against ``ref``: the largest
    relative gap of a step's loss, and by the worst leaf the gap between
    the two norms of the first gradient and of the change, each against
    the larger of the reference leaf's norm and the median leaf's. Leaves
    whose reference gradient is under a thousandth of the median leaf's
    are left out of the change (round-off alone moves them)."""
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(got["loss"], ref["loss"]))
    g_med = statistics.median(ref["grad"].values())
    grad_gap = max(abs(got["grad"][n] - r) / max(r, g_med) for n, r in ref["grad"].items())
    moved = [n for n, r in ref["grad"].items() if r >= 1e-3 * g_med]
    c_med = statistics.median(ref["change"][n] for n in moved)
    change_gap = max(abs(got["change"][n] - ref["change"][n]) / max(ref["change"][n], c_med)
                     for n in moved)
    return {"loss_gap": loss_gap, "grad_gap": grad_gap, "change_gap": change_gap}
