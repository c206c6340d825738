"""serve_mfu_pct: the model operations of the traced window's prefills and
decode steps per second, as a share of the card's 989 TFLOP/s bf16 peak,
in %.

Operations, 2 per multiply-add: every product a token passes through (the
attention projections, the router, ``top_k`` experts, the head at a
prefill's last position and at every decode step; not the embedding, a
lookup), plus QK^T and PV over the causal pairs (inside the window) at a prefill
and over the valid cache at a decode step, in every layer (the count of
``chip_smoke.py:_serve_bounds``, with a token's active experts).
"""

from h100bench.harness import PEAKS


def active_products(c: dict) -> int:
    """Parameters of the products one token passes through, head excluded."""
    d, h, kh, dh, f = c["d_model"], c["n_heads"], c["n_kv_heads"], c["head_dim"], c["d_ff"]
    attn = d * h * dh * 2 + d * kh * dh * 2
    ffn = c["top_k"] * 3 * d * f + d * c["n_experts"] if c.get("n_experts") else 3 * d * f
    return c["n_layers"] * (attn + ffn)


def causal_pairs(c: dict, prompt: int) -> int:
    """(query, key) pairs of a prompt that attention computes: each position
    with itself and the earlier ones inside the window."""
    w = c.get("window") or prompt
    return sum(min(i + 1, w) for i in range(prompt))


def prefill_flops(c: dict, batch: int, prompt: int) -> float:
    attn = 4 * c["n_layers"] * batch * c["n_heads"] * c["head_dim"] * causal_pairs(c, prompt)
    return 2 * active_products(c) * batch * prompt + attn + 2 * c["d_model"] * c["vocab"] * batch


def decode_flops(c: dict, batch: int, length: int) -> float:
    """One decode step at ``length`` tokens of context, its own included (the
    valid cache entries it reads: no more than the window)."""
    length = min(length, c.get("window") or length)
    attn = 4 * c["n_layers"] * batch * c["n_heads"] * c["head_dim"] * length
    return 2 * (active_products(c) + c["d_model"] * c["vocab"]) * batch + attn


def read(rec):
    if not rec.get("batches"):
        return None
    c, t = rec["config"], rec["traffic"]
    b, p, g = t["batch"], t["prompt"], t["generated"]
    per_batch = prefill_flops(c, b, p) + sum(decode_flops(c, b, p + j) for j in range(1, g))
    return 100.0 * rec["batches"] * per_batch / (rec["window_s"] * PEAKS["bf16_flops_per_s"])
