"""decode_busy_ms.serve: the card's busy milliseconds per decode step: the
union of the intervals of the device operations inside the program's
``serve.decode`` layer spans (see ``decode_launches.serve``), over the
number of spans. The profiler's cost per operation falls on the host
between operations, not inside them. None where the program records no
such span."""

from h100bench.harness import BENCH, load_module
from h100bench.trace import union

decode_ops = load_module(BENCH / "metrics" / "decode_launches.serve.py").decode_ops


def read(rec):
    got = decode_ops(rec)
    if got is None:
        return None
    inside, n = got
    return 1e-3 * sum(z - a for a, z in union(inside)) / n
