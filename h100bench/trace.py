"""The traced run's reduction: ``torch.profiler`` over the window, reduced
to what the per-layer readers and the result line take.

* ``kernels``: ``(name, start_us, end_us)`` of every device operation;
* ``busy_s``: the union of the device operations' intervals (the copy of
  ``chip_smoke.py:_device_busy``), ``window_s`` the window's host clock;
* ``breakdown``: the ten device operations that took most time, and the
  ten largest sums of idle gaps by what the host was doing when each gap
  began (the benchmark's innermost ``bench/`` span, then the innermost
  host operation).
"""

from __future__ import annotations

import bisect
from typing import Dict, List, Tuple

#: how far back (in host events) a gap's attribution looks for one covering it
_LOOKBACK = 256


def profiler(cuda: bool):
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    return profile(activities=acts)


def union(spans: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """Sorted, merged intervals of ``spans``."""
    out: List[Tuple[float, float]] = []
    for a, z in sorted(spans):
        if out and a <= out[-1][1]:
            if z > out[-1][1]:
                out[-1] = (out[-1][0], z)
        else:
            out.append((a, z))
    return out


def _cover(events, starts, t):
    """Name of the latest-starting event of ``events`` (sorted by start)
    that covers time ``t``, or None."""
    i = bisect.bisect_right(starts, t)
    for j in range(i - 1, max(-1, i - 1 - _LOOKBACK), -1):
        if events[j][2] >= t:
            return events[j][0]
    return None


def reduce(prof, window_s: float) -> Dict:
    """Read from the profiler's raw events (microseconds): the event tree
    that ``prof.events()`` builds takes minutes for a window of a few
    hundred thousand operations."""
    from torch.autograd import DeviceType

    kernels, labels, ops = [], [], []
    for e in prof.profiler.kineto_results.events():
        name, a = e.name(), e.start_ns() * 1e-3
        z = a + e.duration_ns() * 1e-3
        if e.device_type() == DeviceType.CUDA:
            # the device-side copies of the host's record_function ranges are no operations
            if not (e.is_user_annotation() or name.startswith("bench/")):
                kernels.append((name, a, z))
        elif name.startswith("bench/"):
            labels.append((name[len("bench/"):], a, z))
        elif name.startswith("aten::") or name.startswith("cuda"):
            ops.append((name, a, z))
    busy = union([(a, z) for _, a, z in kernels])
    by_name: Dict[str, float] = {}
    for name, a, z in kernels:
        by_name[name] = by_name.get(name, 0.0) + (z - a) * 1e-6
    top_ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]

    gaps = [(busy[i][1], busy[i + 1][0]) for i in range(len(busy) - 1)]
    labels.sort(key=lambda e: e[1])
    ops.sort(key=lambda e: e[1])
    l_starts, o_starts = [e[1] for e in labels], [e[1] for e in ops]
    idle: Dict[str, float] = {}
    for a, z in gaps:
        key = f"{_cover(labels, l_starts, a) or 'no_span'}/{_cover(ops, o_starts, a) or 'python'}"
        idle[key] = idle.get(key, 0.0) + (z - a) * 1e-6
    top_gaps = sorted(idle.items(), key=lambda kv: -kv[1])[:10]
    busy_s = sum(z - a for a, z in busy) * 1e-6
    return {
        "kernels": kernels,
        "busy_s": busy_s,
        "window_s": window_s,
        "breakdown": {"device_ops": [[k[:96], v] for k, v in top_ops],
                      "idle_gaps": [[k[:96], v] for k, v in top_gaps]},
    }


def device_seconds(rec: Dict, fragment: str) -> float:
    """Device seconds of the traced kernels whose names hold ``fragment``."""
    return sum(z - a for name, a, z in rec["trace"]["kernels"] if fragment in name) * 1e-6


def idle_pct(rec: Dict):
    """The device's idle share of the traced window, in %; None without a
    device trace."""
    t = rec.get("trace")
    if not t or not t["kernels"] or t["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
