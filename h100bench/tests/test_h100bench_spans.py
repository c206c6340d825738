"""The readers of the program's layer spans (``repro_torch.obs.trace``):
each on a hand-made record with known spans and device operations, and
None where nothing was recorded or the program has no spans. On the card
(``cuda`` marker): a traced run of the tiny cells gives every reader a
number, and the spans' profiler ranges reach neither the reduction's
device operations nor its breakdown."""

import sys

import pytest
import torch

from h100bench import harness
from h100bench import trace as tr
from h100bench.tests import tiny

import repro_torch.obs.trace  # noqa: F401

LAYERS = sys.modules["repro_torch.obs.trace"]  # the package's ``trace`` name is a function


def _span(name, parent=None, start=0, end=0, device_ms=None):
    return {"name": name, "parent": parent, "tid": 1, "start_ns": start, "end_ns": end,
            "attrs": {}, "device_ms": device_ms}


#: two decode steps, 10-20 ms and 30-40 ms (ns), one still open, and a span of another name
DECODE = [_span("serve.decode", None, 10_000_000, 20_000_000),
          _span("model.attention", 0, 11_000_000, 12_000_000),
          _span("serve.decode", None, 30_000_000, 40_000_000),
          _span("serve.decode", None, 50_000_000, None)]
#: (name, start_us, end_us): two overlapping inside the first step, one
#: straddling its end, one before it, one between the steps, one inside the second
KERNELS = [("a", 10_001.0, 10_500.0), ("b", 10_400.0, 11_000.0), ("c", 19_990.0, 20_010.0),
           ("d", 9_000.0, 10_002.0), ("e", 25_000.0, 26_000.0), ("f", 30_500.0, 31_000.0)]
#: a step of two microbatches (device ms): forward 40 + 40, recompute 20, step 100
TRAIN = [_span("train.step", None, device_ms=100.0),
         _span("train.forward", 0, device_ms=40.0),
         _span("model.attention", 1, device_ms=25.0),
         _span("model.attention", 1, device_ms=5.0),
         _span("train.recompute", 0, device_ms=20.0),
         _span("model.attention", 4, device_ms=10.0),
         _span("train.forward", 0, device_ms=40.0),
         _span("model.attention", 6, device_ms=20.0)]
WANT = {"decode_launches.serve": 1.5,  # a, b, f over 2 closed steps
        "decode_busy_ms.serve": (1_000.0 - 1.0 + 500.0) * 1e-3 / 2,  # union 10,001-11,000 and f
        "recompute_pct.train": 20.0,
        "attn_fwd_pct.train": 100.0 * (25 + 5 + 20) / 80}


def _rec(kernels=KERNELS):
    return {"trace": {"kernels": kernels, "busy_s": 0.0, "window_s": 1.0}}


@pytest.mark.parametrize("metric", sorted(WANT))
def test_reader_on_known_spans(monkeypatch, metric):
    spans = DECODE if metric.endswith(".serve") else TRAIN
    monkeypatch.setattr(LAYERS, "recorded", lambda: spans)
    assert harness.reader(metric)(_rec()) == pytest.approx(WANT[metric])


@pytest.mark.parametrize("metric", sorted(WANT))
@pytest.mark.parametrize("case", ["no_spans", "no_device", "no_recorder"])
def test_reader_is_none_where_nothing_was_recorded(monkeypatch, metric, case):
    if case == "no_spans":
        monkeypatch.setattr(LAYERS, "recorded", lambda: [])
        rec = _rec()
    elif case == "no_device":  # spans on the CPU: no device operations, no event pairs
        spans = DECODE if metric.endswith(".serve") else [dict(s, device_ms=None) for s in TRAIN]
        monkeypatch.setattr(LAYERS, "recorded", lambda: spans)
        rec = _rec(kernels=[])
    else:  # a program that records no layer spans
        monkeypatch.delattr(LAYERS, "recorded")
        rec = _rec()
    assert harness.reader(metric)(rec) is None


@pytest.mark.cuda
@pytest.mark.parametrize("make", [tiny.train_cell, tiny.serve_cell], ids=["train", "serve"])
def test_traced_tiny_cell_on_the_card(make):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cell, card = make(), torch.device("cuda")
    case = harness.runner(cell).Cell(cell, tiny.SEED, card)
    case.setup()
    LAYERS.clear()
    spans = harness.Spans()
    with tr.profiler(True) as prof:
        win = case.window(0.5, spans)
        torch.cuda.synchronize()
    red = tr.reduce(prof, win["elapsed"])
    names = [k for k, _, _ in red["kernels"]] + [
        k for k, _ in red["breakdown"]["device_ops"] + red["breakdown"]["idle_gaps"]]
    assert names and not any("repro/" in k for k in names)
    rec = dict(win["record"], config=cell["config"], traffic=cell["traffic"],
               spans=spans.seconds, trace=red, window_s=win["elapsed"])
    mine = [m for m in WANT if (m.endswith(".serve") == ("serve" in cell["name"]))]
    for m in mine:
        got = harness.reader(m)(rec)
        print(m, got)
        assert got is not None and got > 0
        if m.endswith("_pct.train"):
            assert got < 100
    case.release()
