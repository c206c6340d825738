"""The operation counts of the MFU and roofline metrics, held at a tiny size
on the CPU against the program's own op counter (``launch/opanalysis.py``),
within its known differences."""

import torch

from h100bench.harness import load_module, BENCH
from h100bench.tests import tiny


def test_train_step_flops_equal_the_op_counters_products():
    """Without remat and with one loss chunk nothing is recomputed, so the
    counted products of one train step are 6 per parameter but the
    embedding (a lookup) per token plus 3 x 4 S^2 H d_h per layer and row.
    The one known difference: ``chip_smoke.py:_train_bound``'s count, which
    the metric copies, takes the RMSNorm weights for products too."""
    from repro_torch.launch.opanalysis import analyze_ops
    from repro_torch.models import Model
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.train import TrainConfig, make_train_step
    from repro_torch.data import DataConfig, make_batch
    from repro_torch.configs.base import ShapeSpec

    from h100bench.runners._lm import port_config

    cell = tiny.train_cell()
    c, t = cell["config"], cell["traffic"]
    cfg = port_config(c)
    tcfg = TrainConfig(microbatches=t["microbatches"], remat="none", loss_chunks=1,
                       opt=AdamWConfig())
    model = Model(cfg, device="cpu")
    state = {"params": model, "opt": adamw_init(model, tcfg.opt)}
    batch = make_batch(cfg, ShapeSpec("t", t["seq"], t["batch"], "train"), DataConfig(), 0,
                       "cpu", batch_override=t["batch"])
    totals, _ = analyze_ops(make_train_step(cfg, tcfg, device="cpu"), state, batch)
    mfu = load_module(BENCH / "metrics" / "train_mfu_pct.py")
    norms = (2 * c["n_layers"] + 1) * c["d_model"]
    tokens = t["batch"] * t["seq"]
    assert totals.dot_flops == mfu.step_flops(c, t["batch"], t["seq"]) - 6 * norms * tokens


def test_k1_least_bytes_are_at_most_what_a_plain_step_moves():
    """The roofline's bytes term counts the grid read once and written once
    (8 bytes a cell); the program's plain step, counted op by op, moves
    more (it materializes every intermediate), never less."""
    from repro_torch.kernels import heat2d
    from repro_torch.kernels.stencil_common import step_plain
    from repro_torch.launch.opanalysis import analyze_ops

    roof = load_module(BENCH / "metrics" / "k1_roofline_pct.py")
    x = torch.rand(64, 96)
    totals, _ = analyze_ops(step_plain, x, heat2d.update, heat2d.HALO)
    least_bytes = roof.least_seconds(0.0, x.numel(), 1) * roof.PEAKS["hbm_bytes_per_s"]
    assert abs(least_bytes - 8 * x.numel()) < 1e-3
    assert totals.bytes_accessed >= least_bytes


def test_decode_flops_and_the_op_counters_products():
    """A decode step's count (``serve_mfu_pct``) against the products the
    program runs, with its two known differences: the experts compute
    every slot of their capacity (E x cap rows, not top_k per token), and
    attention reads every slot of the cache, not only the valid ones."""
    from repro_torch.launch.opanalysis import analyze_ops
    from repro_torch.models import Model
    from repro_torch.serve import greedy, make_decode_step, make_prefill

    from h100bench.runners._lm import port_config

    cell = tiny.serve_cell()
    c, t = cell["config"], cell["traffic"]
    cfg = port_config(c)
    b, p, cache = t["batch"], t["prompt"], t["prompt"] + t["generated"]
    model = Model(cfg, device="cpu")
    toks = torch.randint(0, c["vocab"], (b, p), dtype=torch.int32)
    # the steps without their inference_mode, under which the counter sees
    # aten.matmul whole and counts no product
    with torch.no_grad():
        logits, caches = make_prefill(cfg, max_len=cache, device="cpu").__wrapped__(
            model, {"tokens": toks})
        totals, _ = analyze_ops(make_decode_step(cfg).__wrapped__, model,
                                greedy(logits)[:, None], caches, p)
    mfu = load_module(BENCH / "metrics" / "serve_mfu_pct.py")
    cap = int(max(1, round(b * c["top_k"] / c["n_experts"] * c["capacity_factor"])))
    slots = (c["n_experts"] * cap - c["top_k"] * b) * 3 * 2 * c["d_model"] * c["d_ff"]
    slots_read = min(cache, c["window"])
    unwritten = 4 * b * c["n_heads"] * c["head_dim"] * (slots_read - min(p + 1, c["window"]))
    assert totals.dot_flops == mfu.decode_flops(c, b, p + 1) + c["n_layers"] * (slots + unwritten)
