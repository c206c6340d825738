"""One run of one benchmark cell: set-up, a measured window, the check.

``python h100bench/run.py --workload <name> --seed <n> --seconds <s>
--trace <0|1>`` runs the cell ``<name>`` of ``BENCHMARK.json`` once on the
card and prints one JSON line as the last line of its standard output.
Everything a cell needs is found by name, each in a file of its own:

* ``BENCHMARK.json``'s workload entry names a configuration, whose ``file``
  (``configs/<config>.json``) holds its sizes, and a traffic mix,
  ``traffic/<mix>.json``, the parameters of one general generator;
* the mix's ``"runner"`` names ``runners/<runner>.py``, which builds the
  system under test, drives its window and checks what the window made
  against ``reference/``;
* ``limits/<workload>.json`` holds the limit of every number the check
  compares, and the readings each limit was set from;
* each per-layer metric ``<metric>`` is read by ``metrics/<metric>.py``
  from the traced run's record.

A runner module defines ``Cell(cell, seed, device)`` with ``setup()``,
``window(seconds, spans) -> dict``, ``release()`` and ``check() -> [(name,
value, limit)]``. With ``--trace 0`` the line's metrics are the cell's
end-to-end metrics, with ``--trace 1`` its per-layer ones.
"""

from __future__ import annotations

import argparse
import contextlib
import importlib.util
import json
import math
import os
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
#: top-level module names that may not be loaded in a run's process (the
#: JAX package and JAX itself), compared whole: ``repro_torch`` is not ``repro``
FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "repro"})
PEAKS = json.loads((BENCH / "peaks.json").read_text())


def load_cell(name: str, root: Path = ROOT) -> dict:
    """The workload ``name`` of ``root/BENCHMARK.json`` with its
    configuration, traffic, limits and metric entries loaded."""
    spec = json.loads((root / "BENCHMARK.json").read_text())
    work = {w["name"]: w for w in spec["workloads"]}[name]
    conf = {c["name"]: c for c in spec["configs"]}[work["config"]]

    def mine(metric):
        return name in metric.get("workloads", [name])

    return {
        "name": name,
        "chips": work["chips"],
        "config": json.loads((root / conf["file"]).read_text()),
        "traffic": json.loads((BENCH / "traffic" / f"{work['traffic']}.json").read_text()),
        "limits": json.loads((BENCH / "limits" / f"{name}.json").read_text()),
        "end_to_end": [m for m in spec["end_to_end"] if mine(m)],
        "per_layer": [m for m in spec["per_layer"] if mine(m)],
    }


def load_module(path: Path):
    """Import the file ``path`` as a module of its own."""
    mod_name = "h100bench_" + "_".join(path.relative_to(BENCH).with_suffix("").parts)
    spec = importlib.util.spec_from_file_location(mod_name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def runner(cell: dict):
    return load_module(BENCH / "runners" / f"{cell['traffic']['runner']}.py")


def reader(metric: str):
    return load_module(BENCH / "metrics" / f"{metric}.py").read


class Spans:
    """Host-clock spans of the benchmark's own calls into the program,
    by name, and a ``record_function`` label each, which the traced run's
    idle gaps are attributed to."""

    def __init__(self):
        self.seconds: Dict[str, List[float]] = {}

    @contextlib.contextmanager
    def __call__(self, name: str):
        from torch.profiler import record_function

        t0 = time.perf_counter()
        with record_function(f"bench/{name}"):
            yield
        self.seconds.setdefault(name, []).append(time.perf_counter() - t0)


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & FORBIDDEN)


def _number(v: float):
    """A compared number as JSON holds it: non-finite ones as strings."""
    return v if math.isfinite(v) else str(v)


def run(cell: dict, seed: int, seconds: float, trace: bool, device, t_start: float) -> dict:
    """One run of ``cell`` on ``device``; returns the result line's keys,
    ``compared`` last. ``t_start`` is when the process began its set-up."""
    import torch

    from h100bench import trace as tr

    is_cuda = device.type == "cuda"

    def sync():
        if is_cuda:
            torch.cuda.synchronize(device)

    case = runner(cell).Cell(cell, seed, device)
    case.setup()
    sync()
    setup_s = time.perf_counter() - t_start
    spans = Spans()
    prof = tr.profiler(is_cuda) if trace else contextlib.nullcontext()
    with prof:
        win = case.window(seconds, spans)
        sync()
    peak = torch.cuda.max_memory_allocated(device) if is_cuda else 0
    loaded = forbidden_modules()
    if loaded:
        raise RuntimeError(f"forbidden modules loaded in the run's process: {loaded}")
    reduced = tr.reduce(prof, win["elapsed"]) if trace else None
    case.release()
    t_check = time.perf_counter()
    compared = case.check()
    print(f"h100bench: set-up {setup_s:.3f} s, window {win['elapsed']:.3f} s, check "
          f"{time.perf_counter() - t_check:.3f} s", file=sys.stderr)
    correct = all(math.isfinite(v) and v <= lim for _, v, lim in compared)

    units = {m["name"]: m["unit"] for m in cell["end_to_end"] + cell["per_layer"]}
    if trace:
        rec = dict(win["record"], config=cell["config"], traffic=cell["traffic"],
                   spans=spans.seconds, trace=reduced, window_s=win["elapsed"])
        values = {m["name"]: reader(m["name"])(rec) for m in cell["per_layer"]}
    else:
        values = dict(win["metrics"], setup_s=setup_s)
        values = {m["name"]: values.get(m["name"]) for m in cell["end_to_end"]}
    metrics = {k: {"value": v, "unit": units[k]} for k, v in values.items() if v is not None}
    dev = {"platform": "gpu" if is_cuda else device.type,
           "kind": torch.cuda.get_device_name(device) if is_cuda else device.type,
           "count": cell["chips"], "memory_peak_bytes": int(peak)}
    out = {"correct": correct, "attempted": win["attempted"], "failed": win["failed"],
           "metrics": metrics, "device": dev}
    if trace:
        dev.update(busy_s=reduced["busy_s"], window_s=reduced["window_s"])
        out["breakdown"] = reduced["breakdown"]
    out["compared"] = {name: {"value": _number(v), "limit": lim} for name, v, lim in compared}
    return out


def main(argv: Optional[List[str]] = None, t_start: Optional[float] = None) -> int:
    t_start = time.perf_counter() if t_start is None else t_start
    ap = argparse.ArgumentParser(description="run one benchmark cell once")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    try:
        cell = load_cell(args.workload)
    except (OSError, KeyError, ValueError) as e:
        print(f"h100bench: cannot load workload {args.workload!r}: {e!r}", file=sys.stderr)
        return 2
    # every build and kernel cache of the run lives at a fixed path in the checkout
    cache = ROOT / "build" / "h100bench_cache"
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    sys.path.insert(0, str(ROOT / "src"))
    try:
        import torch

        import repro_torch  # noqa: F401
    except ImportError as e:
        print(f"h100bench: the system under test does not import: {e!r}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"h100bench: {cell['name']} needs {cell['chips']} CUDA device(s), found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 3
    result = run(cell, args.seed, args.seconds, bool(args.trace), torch.device("cuda", 0), t_start)
    for name, c in result["compared"].items():
        print(f"compared {name}: {c['value']} (limit {c['limit']})", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0
