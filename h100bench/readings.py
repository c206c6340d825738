"""The readings a cell's limits are set from, on the card at the cell's own
size (not a benchmark run; no measured window where none is needed):

    python3 h100bench/readings.py --workload <name> --kind <kind> --seeds <n>[,<n>...]

``kind`` is ``program`` (sound runs of the program), or the runner's
control or fault (``fp8``, ``half_batch``, ``control``; see each runner's
``readings``). Prints one JSON line per seed: the compared numbers of that
run against the reference.
"""

import argparse
import json
import sys
import time
from pathlib import Path


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--kind", required=True)
    ap.add_argument("--seeds", required=True)
    args = ap.parse_args(argv)
    root = Path(__file__).resolve().parents[1]
    sys.path[:0] = [str(root), str(root / "src")]
    import torch

    from h100bench import harness

    if not torch.cuda.is_available():
        print("readings: no CUDA device", file=sys.stderr)
        return 3
    cell = harness.load_cell(args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        got = harness.runner(cell).Cell(cell, seed, torch.device("cuda", 0)).readings(args.kind)
        torch.cuda.empty_cache()
        print(json.dumps({"workload": args.workload, "kind": args.kind, "seed": seed,
                          "seconds": time.perf_counter() - t0, **got}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
