"""Run one benchmark cell once and print its result as the last line:

    python3 h100bench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout on a machine with the cell's cards. See
:mod:`h100bench.harness`.
"""

import sys
import time

T_START = time.perf_counter()

if __name__ == "__main__":
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    from h100bench.harness import main

    sys.exit(main(sys.argv[1:], T_START))
