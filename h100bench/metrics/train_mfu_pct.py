"""train_mfu_pct: the whole train step's share of the card's bf16 peak, in %.

Operations per step, as ``chip_smoke.py:_train_bound`` counts them: 6 per
parameter of the products (every matrix but the embedding, whose rows are
gathered) per token, plus QK^T and PV over the full S x S, forward and
backward (3 x 4 S^2 H d_h per layer and sequence); remat's recompute is
not counted. Divided by the traced window's steps' time at 989 TFLOP/s.
"""

from h100bench.harness import PEAKS
from h100bench.reference.lm import n_params


def step_flops(c: dict, batch: int, seq: int) -> float:
    products = n_params(c) - c["vocab"] * c["d_model"]
    attention = 3 * c["n_layers"] * 4 * seq ** 2 * c["n_heads"] * c["head_dim"] * batch
    return 6 * products * batch * seq + attention


def read(rec):
    if not rec["steps"]:
        return None
    t = rec["traffic"]
    flops = rec["steps"] * step_flops(rec["config"], t["batch"], t["seq"])
    return 100.0 * flops / (rec["window_s"] * PEAKS["bf16_flops_per_s"])
