"""attn_fused_pct.train: the share of the attention cores in the traced
window that ran the fused kernels, in %: of the program's
``model.attention.core`` layer spans (``repro_torch.obs.trace``), those
whose ``path`` attribute is ``fused``. None where the program records no
such span."""


def read(rec):
    try:
        from repro_torch.obs.trace import recorded
    except ImportError:
        return None
    paths = [s["attrs"].get("path") for s in recorded() if s["name"] == "model.attention.core"]
    return 100.0 * paths.count("fused") / len(paths) if paths else None
