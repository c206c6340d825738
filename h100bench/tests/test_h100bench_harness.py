"""The harness: the result line, discovery by file name, the refusals."""

import importlib.util
import json
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from h100bench import harness
from h100bench.tests import tiny

KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.mark.parametrize("make", [tiny.train_cell, tiny.serve_cell, tiny.stencil_cell],
                         ids=["train", "serve", "stencil"])
@pytest.mark.parametrize("trace", [False, True], ids=["plain", "traced"])
def test_result_line_keys(make, trace):
    out = tiny.run(make(), trace=trace)
    assert list(out) == KEYS + (["breakdown"] if trace else []) + ["compared"]
    assert out["correct"] is True and out["failed"] == 0 and out["attempted"] > 0
    cell = make()
    want = {m["name"] for m in (cell["per_layer"] if trace else cell["end_to_end"])}
    # device metrics are left out without a device trace; everything else is read
    assert set(out["metrics"]) <= want
    if not trace:
        assert set(out["metrics"]) == want
    assert all(set(m) == {"value", "unit"} for m in out["metrics"].values())
    assert set(out["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    assert all(set(c) == {"value", "limit"} for c in out["compared"].values())
    json.loads(json.dumps(out))


def _copy_bench(root: Path) -> Path:
    shutil.copytree(harness.BENCH, root / "h100bench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(harness.ROOT / "BENCHMARK.json", root / "BENCHMARK.json")
    return root


def test_a_new_cell_is_files_and_entries_only(tmp_path):
    """A configuration, a traffic mix, limits and a per-layer metric added as
    new files, and a workload and a metric entry added to BENCHMARK.json: no
    existing file of the harness is edited, and the run finds all of it."""
    root = _copy_bench(tmp_path)
    bench = root / "h100bench"
    cell = tiny.train_cell()
    config = dict(cell["config"], name="tiny-dense")
    (bench / "configs" / "tiny-dense.json").write_text(json.dumps(config))
    (bench / "traffic" / "train-tiny.json").write_text(json.dumps(cell["traffic"]))
    (bench / "limits" / "tiny-train.json").write_text(json.dumps(cell["limits"]))
    (bench / "metrics" / "steps.train.py").write_text("def read(rec):\n    return rec['steps']\n")
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "tiny-dense", "source": "https://arxiv.org/abs/2403.17297",
                            "file": "h100bench/configs/tiny-dense.json", "reduced": [],
                            "why": "test"})
    spec["workloads"].append({"name": "tiny-train", "config": "tiny-dense",
                              "traffic": "train-tiny", "chips": 1, "why": "test"})
    for m in spec["end_to_end"]:
        if "train_tokens_per_s" == m["name"]:
            m["workloads"].append("tiny-train")
    spec["per_layer"].append({"name": "steps.train", "unit": "steps", "better": "higher",
                              "source": "host_clock", "layer": "train step",
                              "moves": "train_tokens_per_s", "workloads": ["tiny-train"]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    spec_ = importlib.util.spec_from_file_location("h100bench_copy_harness", bench / "harness.py")
    mod = importlib.util.module_from_spec(spec_)
    spec_.loader.exec_module(mod)
    new = mod.load_cell("tiny-train", root)
    assert new["config"]["name"] == "tiny-dense" and new["traffic"]["batch"] == 4
    import time

    import torch

    plain = mod.run(new, tiny.SEED, 0.3, False, torch.device("cpu"), time.perf_counter())
    assert set(plain["metrics"]) == {"train_tokens_per_s", "setup_s"} and plain["correct"]
    traced = mod.run(new, tiny.SEED, 0.3, True, torch.device("cpu"), time.perf_counter())
    assert traced["metrics"]["steps.train"]["value"] == traced["attempted"] > 0


def _run_py(root: Path, *args):
    return subprocess.run([sys.executable, str(root / "h100bench" / "run.py"), *args],
                          capture_output=True, text=True, cwd=root, timeout=300)


def test_without_the_program_or_a_card_no_result(tmp_path):
    """In a directory holding only BENCHMARK.json and the benchmark (no
    program), and on a machine without a card, a run exits non-zero and
    prints nothing on standard output."""
    root = _copy_bench(tmp_path)
    out = _run_py(root, "--workload", "paper-stencils-2d", "--seed", str(tiny.SEED),
                  "--seconds", "1", "--trace", "0")
    assert out.returncode != 0 and out.stdout == ""
    out = _run_py(harness.ROOT, "--workload", "internlm2-train-4k", "--seed", "1",
                  "--seconds", "1", "--trace", "0")
    assert out.returncode != 0 and out.stdout == "" and "CUDA" in out.stderr
    out = _run_py(harness.ROOT, "--workload", "no-such-cell", "--seed", "1", "--seconds", "1")
    assert out.returncode == 2 and out.stdout == ""


def test_nothing_loads_jax_or_the_reference_package():
    """A run of each cell, every runner, reference and metric reader loaded,
    leaves no module whose top-level name is jax, jaxlib, flax or repro
    (compared whole: repro_torch is not repro)."""
    code = (
        "import sys, time, torch\n"
        "from h100bench import harness\n"
        "from h100bench.tests import tiny\n"
        "for make in (tiny.train_cell, tiny.serve_cell, tiny.stencil_cell):\n"
        "    tiny.run(make(), trace=True)\n"
        "for p in sorted((harness.BENCH / 'metrics').glob('*.py')):\n"
        "    harness.load_module(p)\n"
        "for p in sorted((harness.BENCH / 'runners').glob('[!_]*.py')):\n"
        "    harness.load_module(p)\n"
        "assert 'repro_torch' in sys.modules\n"
        "print(sorted({m.split('.')[0] for m in sys.modules} & harness.FORBIDDEN))\n"
    )
    env = {"PYTHONPATH": f"{harness.ROOT}:{harness.ROOT / 'src'}", "PATH": "/usr/bin:/bin"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=harness.ROOT, env=env, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"
