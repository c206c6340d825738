"""Tiny versions of the benchmark's cells, run on the CPU by the tests:
the same runners, references and comparisons at sizes a test can hold.

At these sizes the models are float32 and the program reads float32
round-off against the reference (1e-7 or exactly 0), so each number is
held to a limit of that order (:data:`LIMITS`) rather than the card's,
which were set from bfloat16 runs at the cells' own sizes."""

from __future__ import annotations

import copy

import torch

from h100bench import harness

CPU = torch.device("cpu")
SEED = 2**31 + 11  # a run's seed may be larger than 32 signed bits hold

LIMITS = {
    "internlm2-train-4k": {"loss_gap": 1e-5, "grad_gap": 1e-5, "change_gap": 1e-5},
    "mixtral-serve-decode": {"mean_gap": 1e-6},
    "paper-stencils-2d": {"tile_excess": 1e-6, "grid_err": 1e-6},
}

_DENSE = {"n_layers": 2, "d_model": 64, "n_heads": 4, "n_kv_heads": 2, "head_dim": 16,
          "d_ff": 128, "vocab": 256, "dtype": "float32"}


def _cell(name: str) -> dict:
    cell = copy.deepcopy(harness.load_cell(name))
    cell["limits"] = {k: {"limit": v} for k, v in LIMITS[name].items()}
    return cell


def train_cell() -> dict:
    cell = _cell("internlm2-train-4k")
    cell["config"].update(_DENSE, reduced=sorted(_DENSE))
    cell["traffic"].update(batch=4, seq=32, microbatches=2)
    return cell


def stencil_cell() -> dict:
    cell = _cell("paper-stencils-2d")
    cell["config"].update(sz_s=[64, 96], sz_t=[32, 64], t_divisor_2d=8,
                          hw_space={"n_sm": [16], "n_v": [128], "m_sm": [96]})
    return cell


def run(cell: dict, trace: bool = False, seconds: float = 0.3) -> dict:
    import time

    return harness.run(cell, SEED, seconds, trace, CPU, time.perf_counter())


_MOE = dict(_DENSE, n_experts=4, top_k=2, d_ff=64, window=16, capacity_factor=1.25)


def serve_cell() -> dict:
    cell = _cell("mixtral-serve-decode")
    cell["config"].update(_MOE, reduced=sorted(set(_MOE) - {"top_k"}))
    cell["traffic"].update(batch=6, prompt=24, generated=8, check_rows=2)
    return cell
