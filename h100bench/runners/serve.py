"""Batch-serving cells: a closed loop of whole batches through the program's
serve steps.

Set-up makes the seed's weights (:func:`h100bench.reference.lm.draw`) the
program's model's parameters and serves one batch of two tokens, which
runs every shape the window runs (the prefill at the batch's prompt
length, a decode step over the full cache). The window serves whole
batches, each ``batch`` prompts of ``prompt`` tokens drawn from the seed
and the batch's index, through ``serve.generate_timed`` (the prefill,
then ``generated - 1`` greedy decode steps, the host clock read once the
card has finished each), the next when one ends, while the next is
expected to end inside ``--seconds``. After the window the program is
freed, and the plain reference (:mod:`h100bench.reference.moe`) runs
once over a batch drawn from the seed, its prompts and served tokens, and
reads the logits of ``check_rows`` sequences drawn from the seed: how far
each served token's logit lies below the reference's best.
"""

from __future__ import annotations

import gc
import time

import numpy as np
import torch

from h100bench.runners._lm import load_weights, port_config
from h100bench.reference import lm, moe


def gap_stats(g: torch.Tensor) -> dict:
    """The compared numbers of the gaps of a batch's sampled served tokens."""
    g = g.float().flatten()
    return {"max_gap": float(g.max()), "p99_gap": float(torch.quantile(g, 0.99)),
            "mean_gap": float(g.mean())}


class Cell:
    def __init__(self, cell: dict, seed: int, device: torch.device):
        self.cell, self.seed, self.device = cell, seed, device
        self.c, self.t = cell["config"], cell["traffic"]

    def _prompts(self, b: int) -> torch.Tensor:
        g = torch.Generator(device=self.device).manual_seed((self.seed * 1_000_003 + b) % 2**63)
        return torch.randint(0, self.c["vocab"], (self.t["batch"], self.t["prompt"]),
                             generator=g, device=self.device, dtype=torch.int32)

    def _weights(self):
        return lm.draw(self.c, self.seed, self.device, getattr(torch, self.c["dtype"]))

    def setup(self) -> None:
        from repro_torch.models import Model
        from repro_torch.serve import generate_timed

        self.cfg = port_config(self.c)
        self.model = Model(self.cfg, device="meta")
        load_weights(self.model, self._weights(), requires_grad=False)
        self.generate = generate_timed
        warm = self.generate(self.model, self.cfg, {"tokens": self._prompts(-1)}, 2,
                             device=self.device)
        self.est = warm["prefill_s"] + (self.t["generated"] - 1) * warm["decode_s"][0]
        del warm

    def window(self, seconds: float, spans) -> dict:
        """Whole batches while the next one is expected to end inside
        ``seconds``; generated tokens per second over all of them, and the
        gap before every generated token but a batch's first."""
        t0, est = time.perf_counter(), self.est
        prefill, decode, self.served = [], [], []
        while True:
            elapsed = time.perf_counter() - t0
            if self.served and elapsed + est > seconds:
                break
            with spans("prompts"):
                batch = {"tokens": self._prompts(len(self.served))}
            with spans("generate"):
                r = self.generate(self.model, self.cfg, batch, self.t["generated"],
                                  device=self.device)
            prefill.append(r["prefill_s"])
            decode += r["decode_s"]
            self.served.append(r["tokens"])
            del r
            est = (time.perf_counter() - t0) / len(self.served)
        n = len(self.served) * self.t["batch"] * self.t["generated"]
        itl = np.asarray(decode)  # every step's gap, once for each sequence of its batch
        return {"elapsed": elapsed, "attempted": len(self.served) * self.t["batch"], "failed": 0,
                "metrics": {"serve_tokens_per_s": n / elapsed,
                            "itl_p95_ms": 1e3 * float(np.percentile(itl, 95))},
                "record": {"batches": len(self.served), "prefill_s": prefill, "decode_s": decode}}

    def release(self) -> None:
        del self.model
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def _reference(self, precision: str, margins: bool = False):
        """(the batch checked, its rows, the reference's logits there[, and
        the router margins there])."""
        rng = np.random.default_rng(self.seed)
        b = int(rng.integers(len(self.served)))
        rows = sorted(int(r) for r in rng.choice(self.t["batch"], self.t["check_rows"], False))
        seqs = torch.cat([self._prompts(b), self.served[b][:, :-1].to(torch.int32)], dim=1)
        w = self._weights()
        out = moe.logits(self.c, w, seqs, self.t["prompt"], rows, lm.Precision(precision), margins)
        del w
        return b, rows, out

    def check(self):
        b, rows, ref = self._reference("f32")
        got = gap_stats(moe.gaps(ref, self.served[b][rows]))
        lim = self.cell["limits"]
        return [(k, got[k], lim[k]["limit"]) for k in sorted(lim)]

    def readings(self, kind: str) -> dict:
        """The gap statistics on this seed of ``program`` (a window of one
        batch) or of ``fp8``: at the same positions of the same prompts and
        served tokens, the token the reference in float8 puts first."""
        self.setup()
        self.window(0.0, lambda name: torch.profiler.record_function(name))
        self.release()
        b, rows, (ref, margin) = self._reference("f32", margins=True)
        if kind == "program":
            g = moe.gaps(ref, self.served[b][rows]).flatten()
            top = torch.topk(g, 10).indices
            # the look: are the widest gaps where a router's choice was near a tie?
            return dict(gap_stats(g), mismatch_share=float((g > 0).float().mean()),
                        margin_median=float(margin.median()),
                        margin_median_top10=float(margin.flatten()[top].median()))
        _, _, low = self._reference("fp8")
        g = moe.gaps(ref, low.argmax(dim=-1))
        return dict(gap_stats(g), mismatch_share=float((g > 0).float().mean()))
