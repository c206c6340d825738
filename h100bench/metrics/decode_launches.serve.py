"""decode_launches.serve: device operations per decode step. The program
marks each decode step with its ``serve.decode`` layer span
(``repro_torch.obs.trace``, on the clock of the profiler's events), which
holds the step's synchronise; the device operations of the traced window
that start and end inside a span are its step's, counted exactly. None
where the program records no such span."""

import bisect


def decode_ops(rec):
    """(the ``(start_us, end_us)`` of every device operation inside a
    ``serve.decode`` span, the number of spans), or None."""
    try:
        from repro_torch.obs.trace import recorded
    except ImportError:
        return None
    spans = sorted((s["start_ns"] * 1e-3, s["end_ns"] * 1e-3) for s in recorded()
                   if s["name"] == "serve.decode" and s["end_ns"] is not None)
    t = rec.get("trace")
    if not spans or not t or not t["kernels"]:
        return None
    starts = [a for a, _ in spans]
    inside = []
    for _, a, z in t["kernels"]:
        i = bisect.bisect_right(starts, a) - 1
        if i >= 0 and z <= spans[i][1]:
            inside.append((a, z))
    return inside, len(spans)


def read(rec):
    got = decode_ops(rec)
    return None if got is None else len(got[0]) / got[1]
