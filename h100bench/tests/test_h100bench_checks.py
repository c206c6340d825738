"""The comparisons that decide ``correct``, at tiny sizes on the CPU: each
reference agrees with the program, the lower-precision control fails the
cell's limits, and a run with the timed path broken underneath comes out
not correct."""

import contextlib

import pytest
import torch

from h100bench.runners import serve, stencil, train
from h100bench.tests import tiny


def _fails(readings, cell):
    """The compared numbers of ``readings`` over the cell's limits."""
    return [k for k, lim in cell["limits"].items() if readings[k] > lim["limit"]]


def test_train_reference_agrees_and_fp8_fails():
    cell = tiny.train_cell()
    got = train.Cell(cell, tiny.SEED, tiny.CPU).readings("program")
    assert max(got.values()) < 1e-5, got  # float32 at this size: round-off only
    ctl = train.Cell(cell, tiny.SEED, tiny.CPU).readings("fp8")
    assert _fails(ctl, cell), ctl


def test_serve_reference_agrees_and_fp8_fails():
    """The reference reproduces the program's routing, token drops included:
    every served token is its best at this size in float32."""
    cell = tiny.serve_cell()
    got = serve.Cell(cell, tiny.SEED, tiny.CPU).readings("program")
    assert got["max_gap"] == 0.0, got
    ctl = serve.Cell(cell, tiny.SEED, tiny.CPU).readings("fp8")
    assert _fails(ctl, cell), ctl


def test_stencil_reference_agrees_and_bf16_fails():
    cell = tiny.stencil_cell()
    got = stencil.Cell(cell, tiny.SEED, tiny.CPU).readings("program")
    assert got == {"tile_excess": 0.0, "grid_err": 0.0}
    ctl = stencil.Cell(cell, tiny.SEED, tiny.CPU).readings("control")
    assert _fails(ctl, cell), ctl


def _broken_train(monkeypatch, fault):
    import repro_torch.train as rt

    make = rt.make_train_step

    def broken_make(cfg, tcfg, device=None):
        step = make(cfg, tcfg, device)

        def broken(state, batch):
            if fault == "half_batch":  # half the rows left out, the mean over the rest
                return step(state, {k: v[: v.shape[0] // 2] for k, v in batch.items()})
            saved = {n: p.detach().clone() for n, p in state["params"].named_parameters()}
            opt = {k: {n: t.clone() for n, t in state["opt"][k].items()} for k in ("m", "v")}
            step_no = state["opt"]["step"].clone()
            _, metrics = step(state, batch)
            with torch.no_grad():  # the state handed back unchanged
                for n, p in state["params"].named_parameters():
                    p.copy_(saved[n])
                for k in ("m", "v"):
                    for n, t in state["opt"][k].items():
                        t.copy_(opt[k][n])
                state["opt"]["step"].copy_(step_no)
            return state, metrics

        return broken

    monkeypatch.setattr(rt, "make_train_step", broken_make)


@pytest.mark.parametrize("fault", ["unchanged_state", "half_batch"])
def test_train_faults_come_out_not_correct(monkeypatch, fault):
    _broken_train(monkeypatch, fault)
    out = tiny.run(tiny.train_cell())
    assert out["correct"] is False, out["compared"]


def test_stencil_altered_answer_comes_out_not_correct(monkeypatch):
    import repro_torch.kernels.tiled_stencils as ts

    run_tiled = ts.run_tiled

    def altered(name, x, steps=1, tiles=None):
        out = run_tiled(name, x, steps, tiles).clone()
        out[out.shape[0] // 2, out.shape[1] // 2] += 0.5  # one cell of the answer
        return out

    monkeypatch.setattr(ts, "run_tiled", altered)
    out = tiny.run(tiny.stencil_cell())
    assert out["correct"] is False and out["compared"]["grid_err"]["value"] > 0


def test_serve_altered_token_comes_out_not_correct(monkeypatch):
    import repro_torch.serve.serve_step as ss

    greedy, calls = ss.greedy, []

    def altered(logits):
        tok = greedy(logits)
        calls.append(1)
        if len(calls) % 3 == 0:  # every third step's tokens, where they are produced
            tok = (tok + 1) % logits.shape[-1]
        return tok

    monkeypatch.setattr(ss, "greedy", altered)
    out = tiny.run(tiny.serve_cell())
    assert out["correct"] is False, out["compared"]


def test_a_diverging_stencil_is_held_to_a_finite_run(monkeypatch):
    """laplacian2d grows 8x a step and overflows float32 within ~45 steps;
    where the checked run's reference is no longer finite, a run at a
    lower step count is compared too, so a kernel that writes NaN over
    the interior comes out not correct on every seed."""
    import time

    import repro_torch.kernels.tiled_stencils as ts

    from h100bench import harness

    cell = tiny.stencil_cell()
    cell["traffic"]["stencils"] = ["laplacian2d"]
    cell["config"].update(sz_t=[16, 64], t_divisor_2d=1)
    run_tiled = ts.run_tiled

    def nan_interior(name, x, steps=1, tiles=None):
        out = run_tiled(name, x, steps, tiles).clone()
        out[1:-1, 1:-1] = float("nan")
        return out

    monkeypatch.setattr(ts, "run_tiled", nan_interior)
    fell_back = 0
    for seed in range(tiny.SEED, tiny.SEED + 4):
        case = stencil.Cell(cell, seed, tiny.CPU)
        out = harness.run(cell, seed, 0.0, False, tiny.CPU, time.perf_counter())
        assert out["correct"] is False, out["compared"]
        case.setup()
        case.window(0.0, lambda name: contextlib.nullcontext())
        case.grid_err()
        assert case.compared[-1][3], case.compared  # the last compared run is finite
        fell_back += len(case.compared) > 1
    assert fell_back, "no seed's checked run diverged: the fallback went untried"
