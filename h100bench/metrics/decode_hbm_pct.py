"""decode_hbm_pct: the least bytes of the traced window's decode steps over
their measured time at 3.35 TB/s, in %.

The least bytes of one step, each read or written once: every weight but
the embedding (at a batch of 64 with 2 of 8 experts per token every
expert is chosen, but with probability (6/8)^64 ~ 1e-8 under even
routing, so all are counted), the batch's embedding rows, the valid K/V
rows of every layer read and one written per sequence, and the logits
written. The measured time is ``generate_timed``'s host clock of each
step, stopped once the card has finished it.
"""

from h100bench.harness import PEAKS
from h100bench.reference.lm import n_params


def step_bytes(c: dict, batch: int, length: int, itemsize: int = 2) -> float:
    """One decode step at ``length`` tokens of context, its own included
    (the valid cache entries it reads: no more than the window)."""
    length = min(length, c.get("window") or length)
    weights = (n_params(c) - c["vocab"] * c["d_model"]) * itemsize
    kv_row = 2 * c["n_layers"] * c["n_kv_heads"] * c["head_dim"] * itemsize
    rows = batch * (c["d_model"] + c["vocab"]) * itemsize  # embedding rows read, logits written
    return weights + rows + batch * (length + 1) * kv_row  # K/V read, one row written


def read(rec):
    if not rec.get("decode_s"):
        return None
    c, t = rec["config"], rec["traffic"]
    b, p, g = t["batch"], t["prompt"], t["generated"]
    per_batch = sum(step_bytes(c, b, p + j) for j in range(1, g))
    least = rec["batches"] * per_batch / PEAKS["hbm_bytes_per_s"]
    return 100.0 * least / sum(rec["decode_s"])
