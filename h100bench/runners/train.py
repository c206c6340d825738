"""Training cells: back-to-back train steps of a dense decoder.

Set-up builds one train state from the seed's weights
(:func:`h100bench.reference.lm.draw`, made the program's parameters), and
drives it through ``checked_steps`` steps with the window's own step
function and feed (the program's synthetic data pipeline, one batch of
fresh rows per step). It keeps each step's loss, every leaf's first
clipped gradient (from the moments after step 1) and every leaf's change
after the checked steps; the window then continues the same state. After
the window the program's state is freed and the plain reference follows
the checked steps from the same weights and tokens
(:func:`h100bench.reference.lm.train`).
"""

from __future__ import annotations

import gc
import math
import time

import torch

from h100bench.runners._lm import load_weights, port_config
from h100bench.reference import lm


class Cell:
    def __init__(self, cell: dict, seed: int, device: torch.device):
        self.cell, self.seed, self.device = cell, seed, device
        self.c, self.t = cell["config"], cell["traffic"]

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _batch(self, step: int):
        return self.make_batch(self.cfg, self.shape, self.dcfg, step, self.device,
                               batch_override=self.t["batch"])

    def setup(self) -> None:
        from repro_torch.configs.base import ShapeSpec
        from repro_torch.data import DataConfig, make_batch
        from repro_torch.models import Model
        from repro_torch.optim import AdamWConfig, adamw_init
        from repro_torch.train import TrainConfig, make_train_step

        t, dev = self.t, self.device
        self.cfg = port_config(self.c)
        opt = AdamWConfig(**t["optimizer"])
        tcfg = TrainConfig(microbatches=t["microbatches"], remat=t["remat"], opt=opt)
        model = Model(self.cfg, device="meta")
        load_weights(model, lm.draw(self.c, self.seed, dev, getattr(torch, self.c["dtype"])),
                     requires_grad=True)
        self.state = {"params": model, "opt": adamw_init(model, opt)}
        self.step = make_train_step(self.cfg, tcfg, device=dev)
        self.make_batch = make_batch
        self.dcfg = DataConfig(seed=self.seed, copy_period=t["copy_period"], noise=t["noise"])
        self.shape = ShapeSpec(self.cell["name"], t["seq"], t["batch"], "train")
        got = {"loss": []}
        for i in range(t["checked_steps"]):
            t0 = time.perf_counter()
            _, metrics = self.step(self.state, self._batch(i))
            got["loss"].append(float(metrics["lm_loss"]))
            self.step_s = time.perf_counter() - t0
            if i == 0:
                got["grad"] = {n: float(m.norm()) / (1 - opt.b1)
                               for n, m in self.state["opt"]["m"].items()}
        w0 = lm.draw(self.c, self.seed, dev, getattr(torch, self.c["dtype"]))
        with torch.no_grad():
            got["change"] = {n: float((p.float() - w0[n].float()).norm())
                             for n, p in model.named_parameters()}
        del w0
        self.got = got

    def window(self, seconds: float, spans) -> dict:
        """Whole steps while the next one is expected to end inside
        ``seconds``; tokens per second over all of them."""
        t0, n, losses = time.perf_counter(), 0, []
        est = self.step_s
        while True:
            with spans("sync"):
                self._sync()
            elapsed = time.perf_counter() - t0
            if n and elapsed + est > seconds:
                break
            if n:
                est = elapsed / n
            with spans("data"):
                batch = self._batch(self.t["checked_steps"] + n)
            with spans("step"):
                _, metrics = self.step(self.state, batch)
            losses.append(metrics["lm_loss"])
            n += 1
        failed = sum(not math.isfinite(float(v)) for v in losses)
        tokens = n * self.t["batch"] * self.t["seq"]
        return {"elapsed": elapsed, "attempted": n, "failed": failed,
                "metrics": {"train_tokens_per_s": tokens / elapsed},
                "record": {"steps": n, "tokens": tokens}}

    def release(self) -> None:
        del self.state, self.step
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def check(self):
        got = lm.gaps(self.got, lm.train(self.c, self.t, self.seed, self.device))
        return [(k, got[k], self.cell["limits"][k]["limit"]) for k in sorted(got)]

    def readings(self, kind: str) -> dict:
        """The compared numbers of one kind of run against the f32
        reference on this seed: ``program`` (set-up's checked steps),
        ``fp8`` (the reference in float8 put in the program's place) or
        ``half_batch`` (the reference on half of each batch)."""
        if kind == "program":
            self.setup()
            self.release()
            got = self.got
        else:
            fp8, rows = (("fp8", 1.0) if kind == "fp8" else ("f32", 0.5))
            got = lm.train(self.c, self.t, self.seed, self.device, fp8, rows)
        ref = lm.train(self.c, self.t, self.seed, self.device)
        return lm.gaps(got, ref)
