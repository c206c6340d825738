"""k1_roofline_pct: K1's share of its roofline over the traced window, in %.

For every whole T-step run of a 2-D stencil in the window, the least time
the card could take: the larger of the grid read once and written once
(8 bytes a cell at 3.35 TB/s) and the run's useful operations (the
paper's flops per point x cells x steps at the 67 TFLOP/s float32 peak),
whatever implements it. Summed, and divided by the device time of the
``tiled2d_kernel`` launches the trace holds.
"""

from h100bench.harness import PEAKS
from h100bench.trace import device_seconds

KERNEL = "tiled2d_kernel"


def least_seconds(flops_per_point: float, cells: int, steps: int) -> float:
    return max(8.0 * cells / PEAKS["hbm_bytes_per_s"],
               flops_per_point * cells * steps / PEAKS["f32_flops_per_s"])


def read(rec):
    if not rec.get("trace") or not rec["trace"]["kernels"]:
        return None
    spent = device_seconds(rec, KERNEL)
    st = rec["config"]["stencils"]
    least = sum(least_seconds(st[name]["flops_per_point"], s ** dims, steps)
                for name, s, dims, steps in rec["runs"] if dims == 2)
    return 100.0 * least / spent if spent > 0 and least > 0 else None
