"""Carry a JAX package parameter tree into a :class:`~repro_torch.models
.model.Model`.

``from_reference_params(cfg, tree, device)`` takes the reference's
``init_model`` tree with numpy arrays as leaves (``jax.device_get`` of it,
or ``np.asarray`` per leaf) and returns a model on ``device`` whose
parameters hold the same values bit for bit. Names are the tree's paths
joined by dots, except inside a stack: the reference's ``seg{i}`` entry is
a tuple over pattern slots, each leaf stacked over the segment's repeats,
and the port keeps one block per layer, so leaf row ``r`` of slot ``j``
lands in layer :func:`~repro_torch.models.transformer.layer_index`
``(segs, i, r, j)``. Matmul weights keep the reference's ``(d_in, d_out)``
layout, so no leaf is transposed. The carry is a bijection: it raises
unless every leaf lands in exactly one parameter of the same shape and
dtype and every parameter is filled. :func:`load_reference_tree` does the
same for one submodule (an ``Attention``, ``MoE``, ``SSM``) from the tree
of the reference's matching ``*_init``.

The decode caches carry both ways. The reference's cache tree is
``{"stack": {"seg{i}": (slot caches, leaves stacked over the repeats)},
"enc_out"?}``; the port's is ``{"stack": [one dict per layer],
"enc_out"?}`` (:func:`repro_torch.serve.kvcache.init_caches`).
:func:`caches_from_reference` splits the repeat axis into layers (each
layer's ``idx`` its own 0-d tensor), :func:`caches_to_reference` stacks it
back, so caches after a prefill or a decode step compare leaf by leaf.
"""

from __future__ import annotations

from typing import Dict, Iterable, Iterator, List, Tuple

import numpy as np
import torch
from torch import nn

from .._device import resolve_device
from ..configs.base import ArchConfig
from .model import Model
from .transformer import layer_index, segments

__all__ = [
    "from_reference_params",
    "load_reference_tree",
    "reference_leaves",
    "caches_from_reference",
    "caches_to_reference",
]

_STACKS = ("stack", "encoder", "decoder")


def tree_leaves(tree, prefix: Tuple = ()) -> Iterator[Tuple[Tuple, object]]:
    """``(path, leaf)`` for every leaf of nested dicts (keys sorted), lists
    and tuples."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from tree_leaves(tree[k], prefix + (k,))
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            yield from tree_leaves(v, prefix + (i,))
    else:
        yield prefix, tree


def reference_leaves(model: Model, tree: Dict) -> Iterator[Tuple[str, np.ndarray]]:
    """``(port parameter name, value)`` for every leaf of the reference
    tree, stacked leaves split into their per-layer rows."""
    for path, leaf in tree_leaves(tree):
        arr = np.asarray(leaf)
        if path[0] not in _STACKS:
            yield ".".join(map(str, path)), arr
            continue
        stack = getattr(model, path[0])
        seg, slot, rest = int(path[1].removeprefix("seg")), path[2], path[3:]
        reps = stack.segs[seg][1]
        if arr.shape[:1] != (reps,):
            raise ValueError(f"{'.'.join(map(str, path))}: leading axis {arr.shape[:1]}, want ({reps},)")
        for r in range(reps):
            layer = layer_index(stack.segs, seg, r, slot)
            name = ".".join([path[0], "layers", str(layer), *map(str, rest)])
            yield name, arr[r]


def _to_tensor(arr: np.ndarray) -> torch.Tensor:
    if arr.dtype.name == "bfloat16":  # ml_dtypes' bfloat16: carry the bits
        return torch.from_numpy(np.ascontiguousarray(arr).view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(np.array(arr))  # a writable copy


def from_reference_params(cfg: ArchConfig, tree: Dict, device=None) -> Model:
    """A :class:`Model` of ``cfg`` on ``device`` (the card unless given)
    holding the reference tree's values bit for bit."""
    model = Model(cfg, device="meta")
    model.to_empty(device=resolve_device(device))
    return _fill(model, reference_leaves(model, tree))


def load_reference_tree(module: nn.Module, tree: Dict) -> nn.Module:
    """Fill ``module``'s parameters, in place, from a reference tree whose
    paths are its parameter names (no stacked segments), bit for bit."""
    return _fill(module, ((".".join(map(str, p)), np.asarray(v)) for p, v in tree_leaves(tree)))


def _fill(model: nn.Module, leaves: Iterable[Tuple[str, np.ndarray]]) -> nn.Module:
    params = dict(model.named_parameters())
    filled = set()
    with torch.no_grad():
        for name, arr in leaves:
            if name not in params:
                raise KeyError(f"reference leaf {name!r} has no port parameter")
            if name in filled:
                raise KeyError(f"two reference leaves land in {name!r}")
            p, value = params[name], _to_tensor(arr)
            if tuple(p.shape) != tuple(value.shape) or p.dtype != value.dtype:
                raise ValueError(
                    f"{name}: reference {tuple(value.shape)} {value.dtype}, "
                    f"port {tuple(p.shape)} {p.dtype}"
                )
            p.copy_(value)
            filled.add(name)
    missing = sorted(set(params) - filled)
    if missing:
        raise KeyError(f"port parameters no reference leaf fills: {missing[:5]}")
    return model


def caches_from_reference(cfg: ArchConfig, tree: Dict, device=None) -> Dict:
    """The reference's cache tree (numpy leaves) as the port's caches on
    ``device`` (the card unless given), bit for bit."""
    device = resolve_device(device)
    segs = segments(cfg)
    layers: List[Dict] = [None] * sum(len(p) * r for p, r in segs)
    for si, (pattern, reps) in enumerate(segs):
        for j, slot in enumerate(tree["stack"][f"seg{si}"]):
            for r in range(reps):
                layers[layer_index(segs, si, r, j)] = {
                    part: {k: _to_tensor(np.asarray(v)[r]).to(device) for k, v in leaves.items()}
                    for part, leaves in slot.items()
                }
    out: Dict = {"stack": layers}
    if "enc_out" in tree:
        out["enc_out"] = _to_tensor(np.asarray(tree["enc_out"])).to(device)
    return out


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        import ml_dtypes  # numpy's bfloat16, as the reference's leaves carry it

        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def caches_to_reference(cfg: ArchConfig, caches: Dict) -> Dict:
    """The port's caches as the reference's cache tree, numpy leaves
    stacked over each segment's repeats."""
    segs = segments(cfg)
    stack: Dict = {}
    for si, (pattern, reps) in enumerate(segs):
        slots = []
        for j in range(len(pattern)):
            rows = [caches["stack"][layer_index(segs, si, r, j)] for r in range(reps)]
            slots.append({
                part: {k: np.stack([_to_numpy(row[part][k]) for row in rows]) for k in leaves}
                for part, leaves in rows[0].items()
            })
        stack[f"seg{si}"] = tuple(slots)
    out: Dict = {"stack": stack}
    if "enc_out" in caches:
        out["enc_out"] = _to_numpy(caches["enc_out"])
    return out
