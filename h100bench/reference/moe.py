"""Plain reference of a served sparse-MoE decoder (Mixtral's block: pre-norm
RMSNorm, rotary attention with grouped KV heads in a sliding window, a
router choosing ``top_k`` of ``n_experts`` SiLU-gated experts per token,
an untied head), run once over whole sequences: the prompts and the
tokens the program served, in float32 with TF32 off.

The configuration's experts take at most ``capacity_factor`` times a
balanced share of a routing group's tokens; a token over its expert's
capacity is dropped for that expert. The groups are the serving steps'
as the configuration states them: a prompt's tokens route as one group
per sequence (the prefill), and each generated position routes as one
group across the batch's sequences, in sequence order (one decode step).
So the reference is run over every sequence of a batch, and the logits
are read at the sampled ones. Ranks within an expert follow the tokens'
order, each token's choices in rank order; the top-k order is the
stable descending one (the lower expert on a tie).

It imports nothing of the system under test; the weights come from
:func:`h100bench.reference.lm.draw` and are taken to float32 one layer (one
expert) at a time. ``q8`` (:class:`h100bench.reference.lm.Precision`)
rounds every product's operands: the float8 control.
"""

from __future__ import annotations

import math
from typing import Dict, List

import torch
import torch.nn.functional as F

from h100bench.reference.lm import Precision, _rms, _rope

#: sequences per block of the attention (scores of 4 x 48 heads x 1,279^2 f32: 1.3 GB)
ROWS = 4


def _attention(c, q8, x, w, p, pos):
    b, s, _ = x.shape
    h, kh, dh = c["n_heads"], c["n_kv_heads"], c["head_dim"]
    f32 = {n: w[p + "mixer." + n].float() for n in ("wq", "wk", "wv", "wo")}
    qi = torch.arange(s, device=x.device)
    ok = (qi[None, :] <= qi[:, None]) & ((qi[:, None] - qi[None, :]) < c["window"])
    out = torch.empty_like(x)
    for r in range(0, b, ROWS):
        y = _rms(x[r:r + ROWS], w[p + "norm1"].float(), c["norm_eps"])
        n = y.shape[0]
        q = _rope((q8(y) @ q8(f32["wq"])).view(n, s, h, dh), pos[:n], c["rope_theta"])
        k = _rope((q8(y) @ q8(f32["wk"])).view(n, s, kh, dh), pos[:n], c["rope_theta"])
        v = (q8(y) @ q8(f32["wv"])).view(n, s, kh, dh)
        k, v = k.repeat_interleave(h // kh, dim=2), v.repeat_interleave(h // kh, dim=2)
        scores = torch.einsum("bqhd,bkhd->bhqk", q8(q), q8(k)) / math.sqrt(dh)
        prob = torch.softmax(scores.masked_fill(~ok, float("-inf")), dim=-1)
        del scores
        o = torch.einsum("bhqk,bkhd->bqhd", q8(prob), q8(v)).reshape(n, s, h * dh)
        out[r:r + ROWS] = x[r:r + ROWS] + q8(o) @ q8(f32["wo"])
    return out


def _kept(idx: torch.Tensor, n_experts: int, cap: int) -> torch.Tensor:
    """idx (G, T, k) of G groups -> keep mask (G, T, k): a choice is kept
    when fewer than ``cap`` earlier choices of its group (token order,
    then rank order) went to the same expert."""
    g, t, k = idx.shape
    flat = idx.reshape(g, t * k)
    onehot = F.one_hot(flat, n_experts)
    before = torch.cumsum(onehot, dim=1) - onehot
    rank = torch.gather(before, 2, flat[..., None])[..., 0]
    return (rank < cap).reshape(g, t, k)


def _capacity(tokens: int, c: dict) -> int:
    return int(max(1, round(tokens * c["top_k"] / c["n_experts"] * c["capacity_factor"])))


def _moe(c, q8, x, w, p, prompt: int, margin=None):
    b, s, d = x.shape
    e, k = c["n_experts"], c["top_k"]
    y = _rms(x, w[p + "norm2"].float(), c["norm_eps"])
    probs = torch.softmax(q8(y) @ q8(w[p + "ffn.router"].float()), dim=-1)
    gates, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    if margin is not None:  # how near each token's last chosen expert is to the first left out
        torch.minimum(margin, gates[..., k - 1] - gates[..., k], out=margin)
    gates, idx = gates[..., :k], idx[..., :k]
    gates = gates / gates.sum(dim=-1, keepdim=True)
    keep = torch.zeros_like(idx, dtype=torch.bool)
    keep[:, :prompt] = _kept(idx[:, :prompt], e, _capacity(prompt, c))
    if s > prompt:  # one group per generated position, across the sequences
        step = _kept(idx[:, prompt:].transpose(0, 1), e, _capacity(b, c))
        keep[:, prompt:] = step.transpose(0, 1)
    out = x.clone()
    flat_y, flat_out = y.reshape(b * s, d), out.view(b * s, d)
    for j in range(e):
        chosen = (idx == j) & keep  # (B, S, k)
        tok, slot = chosen.reshape(b * s, k).nonzero(as_tuple=True)
        if tok.numel() == 0:
            continue
        ex = {n: w[p + "ffn.experts." + n][j].float() for n in ("gate", "up", "down")}
        xi = q8(flat_y[tok])
        hid = F.silu(xi @ q8(ex["gate"])) * (xi @ q8(ex["up"]))
        gate = gates.reshape(b * s, k)[tok, slot, None]
        flat_out.index_add_(0, tok, (q8(hid) @ q8(ex["down"])) * gate)
    return out


@torch.no_grad()
def logits(c: dict, w: Dict[str, torch.Tensor], seqs: torch.Tensor, prompt: int,
           rows: List[int], q8: Precision, margins: bool = False):
    """Logits (len(rows), S - prompt + 1, V) at the positions that predict
    the served tokens (the prompt's last position onward) of the sequences
    ``rows`` of ``seqs`` (B, S): the prompts, then the served tokens but
    the last. With ``margins``, also the smallest router margin over the
    layers (the last chosen expert's probability less the first left
    out's) at those positions."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    b, s = seqs.shape
    pos = torch.arange(s, device=seqs.device)[None].expand(ROWS, s)
    x = w["embed"][seqs.long()].float()
    margin = torch.ones(b, s, device=seqs.device) if margins else None
    for i in range(c["n_layers"]):
        p = f"stack.layers.{i}."
        x = _attention(c, q8, x, w, p, pos)
        x = _moe(c, q8, x, w, p, prompt, margin)
    h = _rms(x[rows, prompt - 1:], w["final_norm"].float(), c["norm_eps"])
    out = q8(h) @ q8(w["lm_head"].float())
    return (out, margin[rows, prompt - 1:]) if margins else out


def gaps(ref: torch.Tensor, served: torch.Tensor) -> torch.Tensor:
    """How far each served token's logit lies below the reference's best at
    its position: ref (R, G, V), served (R, G) -> (R, G)."""
    return ref.max(dim=-1).values - torch.gather(ref, -1, served.long()[..., None])[..., 0]
