"""What the language-model runners share: the program's architecture of a
configuration file, and the seed's weights handed to the program's model."""

from __future__ import annotations

import dataclasses
from typing import Dict

import torch

#: the configuration keys that name the program's ``ArchConfig`` fields
SIZE_KEYS = ("n_layers", "d_model", "n_heads", "n_kv_heads", "d_ff", "vocab", "head_dim",
             "rope_theta", "act", "tie_embeddings", "dtype")
#: configuration keys of a sparse-MoE FFN -> the program's ``MoEConfig`` fields
MOE_KEYS = {"n_experts": "n_experts", "top_k": "top_k", "d_ff": "d_ff",
            "capacity_factor": "capacity_factor"}
#: keys of the program's settings, which no published configuration has:
#: always taken from the file, which says under ``assumed`` why
SETTINGS = ("capacity_factor",)


def port_config(c: dict):
    """The program's architecture of configuration ``c``: its registry
    entry ``c["arch"]`` with the keys that ``c["reduced"]`` names, and the
    :data:`SETTINGS` that ``c`` has, taken from ``c``; any other key that
    differs is refused."""
    from repro_torch.configs import get_arch

    cfg = get_arch(c["arch"])
    cut = {k: c[k] for k in c["reduced"] if k in SIZE_KEYS}
    if cfg.moe is not None:
        moe = {f: c[k] for k, f in MOE_KEYS.items()
               if k in c["reduced"] or (k in SETTINGS and k in c)}
        cut["moe"] = dataclasses.replace(cfg.moe, **moe)
        if "window" in c["reduced"]:
            cut["attn"] = dataclasses.replace(cfg.attn, window=c["window"])
    cfg = dataclasses.replace(cfg, **cut)
    have = {k: cfg.head_dim_ if k == "head_dim" else getattr(cfg, k) for k in SIZE_KEYS}
    if cfg.moe is not None:
        have.update({k: getattr(cfg.moe, f) for k, f in MOE_KEYS.items()})
        have["window"] = cfg.attn.window
    for k, v in have.items():
        if v != c[k]:
            raise ValueError(f"{c['name']}: {k} is {c[k]} in the configuration file and "
                             f"{v} in the program's {c['arch']!r}")
    return cfg


def load_weights(model: torch.nn.Module, weights: Dict[str, torch.Tensor],
                 requires_grad: bool) -> None:
    """Make the tensors of ``weights`` the parameters of ``model`` (built on
    the meta device), by name, without a copy."""
    names = [n for n, _ in model.named_parameters()]
    if set(names) != set(weights):
        raise ValueError(f"the program's parameters {sorted(set(names) ^ set(weights))} "
                         "differ from the configuration's layout")
    for n in names:
        path, _, leaf = n.rpartition(".")
        owner = model.get_submodule(path) if path else model
        owner._parameters[leaf] = torch.nn.Parameter(weights[n], requires_grad=requires_grad)
