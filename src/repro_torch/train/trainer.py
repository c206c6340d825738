"""Fault-tolerant training loop (the JAX package's ``train/trainer.py``),
on one device or on a ``DeviceMesh``.

* **checkpoint/restart**: async atomic checkpoints every N steps; any
  exception inside the step triggers restore-from-latest + replay (the data
  pipeline is stateless-deterministic, so the replayed batches are
  identical); a bounded failure budget prevents crash loops;
* **preemption**: a preemption file (what a real cluster delivers as
  SIGTERM) causes a final synchronous checkpoint + clean exit;
* **straggler mitigation**: a step-time watchdog tracks the median of the
  last 50 steps; steps slower than ``straggler_factor`` x median are
  recorded and surfaced. Steps are timed on ``clock`` (``time.perf_counter``
  unless given), so a test can give them durations of its own.

The third argument is a device (the card unless given) or a mesh. A
restore writes the checkpoint into the state's own tensors
(:func:`repro_torch.checkpoint.restore_checkpoint`), so a replay allocates
no second copy of the state. On a mesh those tensors are DTensors: each
rank reads the full logical leaves and keeps its own shards, so a job
saved on one mesh shape resumes on another (the elastic restore,
``tests/test_torch_elastic.py``); only rank 0 writes checkpoints.
"""

from __future__ import annotations

import dataclasses
import os
import tempfile
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np

from .._device import resolve_device
from ..checkpoint.checkpoint import AsyncCheckpointer, latest_step, restore_checkpoint
from ..sharding.dtensor import is_mesh
from ..configs.base import ArchConfig, ShapeSpec
from ..data.pipeline import DataConfig, SyntheticPipeline
from .train_step import TrainConfig, init_train_state, make_train_step

__all__ = ["Trainer", "TrainerConfig"]


@dataclasses.dataclass
class TrainerConfig:
    steps: int = 100
    ckpt_dir: str = os.path.join(tempfile.gettempdir(), "repro_ckpt")
    ckpt_every: int = 25
    keep: int = 3
    max_failures: int = 3
    straggler_factor: float = 2.0
    preempt_file: Optional[str] = None
    log_every: int = 10
    batch_override: Optional[int] = None
    seq_override: Optional[int] = None


class Trainer:
    def __init__(
        self,
        cfg: ArchConfig,
        shape: ShapeSpec,
        device=None,
        tcfg: TrainConfig = TrainConfig(),
        run_cfg: TrainerConfig = TrainerConfig(),
        dcfg: DataConfig = DataConfig(),
        fault_hook: Optional[Callable[[int], None]] = None,
        clock: Callable[[], float] = time.perf_counter,
    ):
        self.cfg, self.shape = cfg, shape
        self.clock = clock
        self.mesh = device if is_mesh(device) else None
        self.device = device if self.mesh is not None else resolve_device(device)
        self.tcfg, self.run_cfg, self.dcfg = tcfg, run_cfg, dcfg
        self.fault_hook = fault_hook
        self.step_fn = make_train_step(cfg, tcfg, self.device)
        self.checkpointer = AsyncCheckpointer(run_cfg.ckpt_dir, keep=run_cfg.keep)
        self.step_times: List[float] = []
        self.stragglers: List[int] = []
        self.metrics_history: List[Dict[str, float]] = []
        self.restore_seconds: List[float] = []
        self.failures = 0

    # ------------------------------------------------------------------
    def _init_or_restore(self):
        state = init_train_state(self.cfg, self.tcfg, self.device)
        start = 0
        if latest_step(self.run_cfg.ckpt_dir) is not None:
            state, start, extra = restore_checkpoint(self.run_cfg.ckpt_dir, state)
            start = int(extra.get("next_step", start))
        return state, start

    def _is_straggler(self, dt: float) -> bool:
        if len(self.step_times) < 5:
            return False
        med = float(np.median(self.step_times[-50:]))
        return dt > self.run_cfg.straggler_factor * med

    def _preempted(self) -> bool:
        f = self.run_cfg.preempt_file
        return bool(f and os.path.exists(f))

    # ------------------------------------------------------------------
    def train(self) -> Dict[str, Any]:
        state, start = self._init_or_restore()
        step = start
        while step < self.run_cfg.steps:
            try:
                pipeline = SyntheticPipeline(
                    self.cfg, self.shape, self.dcfg,
                    None if self.mesh else self.device, start_step=step,
                    batch_override=self.run_cfg.batch_override,
                    seq_override=self.run_cfg.seq_override, mesh=self.mesh,
                )
                for batch in pipeline:
                    if step >= self.run_cfg.steps:
                        break
                    if self._preempted():
                        self.checkpointer.wait()
                        self.checkpointer.save(step, state, {"next_step": step})
                        self.checkpointer.wait()
                        return self._summary(state, step, preempted=True)
                    t0 = self.clock()
                    if self.fault_hook is not None:
                        self.fault_hook(step)
                    state, metrics = self.step_fn(state, batch)
                    metrics = {k: float(v) for k, v in metrics.items()}
                    dt = self.clock() - t0
                    self.step_times.append(dt)
                    if self._is_straggler(dt):
                        self.stragglers.append(step)
                    self.metrics_history.append(dict(metrics, step=step, time=dt))
                    step += 1
                    if step % self.run_cfg.ckpt_every == 0:
                        self.checkpointer.save(step, state, {"next_step": step})
            except (KeyboardInterrupt,):
                raise
            except Exception as e:  # noqa: BLE001 -- restart-on-failure
                self.failures += 1
                if self.failures > self.run_cfg.max_failures:
                    raise RuntimeError(
                        f"exceeded failure budget ({self.failures})"
                    ) from e
                self.checkpointer.wait()
                if latest_step(self.run_cfg.ckpt_dir) is not None:
                    state, step = self._restore_after_failure(state)
                else:
                    state = init_train_state(self.cfg, self.tcfg, self.device)
                    step = 0
        self.checkpointer.wait()
        self.checkpointer.save(step, state, {"next_step": step})
        self.checkpointer.wait()
        return self._summary(state, step)

    def _restore_after_failure(self, state):
        t0 = time.perf_counter()
        state, ck_step, extra = restore_checkpoint(self.run_cfg.ckpt_dir, state)
        self.restore_seconds.append(time.perf_counter() - t0)
        return state, int(extra.get("next_step", ck_step))

    def _summary(self, state, step, preempted: bool = False):
        return {
            "state": state,
            "step": step,
            "preempted": preempted,
            "failures": self.failures,
            "stragglers": self.stragglers,
            "metrics": self.metrics_history,
        }
