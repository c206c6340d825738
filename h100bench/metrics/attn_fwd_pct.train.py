"""attn_fwd_pct.train: attention's share of the train step's forward
passes, in %: the device milliseconds (CUDA event pairs) of the program's
``model.attention`` layer spans nested under a ``train.forward`` span
over those of the ``train.forward`` spans (``repro_torch.obs.trace``);
remat's recompute of attention is not counted. None where the program
records no forward span."""


def read(rec):
    try:
        from repro_torch.obs.trace import recorded
    except ImportError:
        return None
    spans = recorded()

    def under_forward(s):
        while s["parent"] is not None:
            s = spans[s["parent"]]
            if s["name"] == "train.forward":
                return True
        return False

    forward = sum(s["device_ms"] for s in spans
                  if s["name"] == "train.forward" and s["device_ms"] is not None)
    attn = sum(s["device_ms"] for s in spans if s["name"] == "model.attention"
               and s["device_ms"] is not None and under_forward(s))
    return 100.0 * attn / forward if forward else None
