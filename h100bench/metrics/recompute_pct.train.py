"""recompute_pct.train: the backward pass's recompute as a share of the
train step's device time, in %: the device milliseconds (CUDA event pairs)
of the program's ``train.recompute`` layer spans (remat's checkpointed
blocks and the chunked loss's checkpointed chunks) over those of its
``train.step`` spans (``repro_torch.obs.trace``). None where the program
records no step span."""


def read(rec):
    try:
        from repro_torch.obs.trace import recorded
    except ImportError:
        return None
    ms = {}
    for s in recorded():
        if s["device_ms"] is not None:
            ms[s["name"]] = ms.get(s["name"], 0.0) + s["device_ms"]
    step = ms.get("train.step")
    return 100.0 * ms.get("train.recompute", 0.0) / step if step else None
