"""Carry a JAX package parameter tree into a :class:`~repro_torch.models
.model.Model`.

``from_reference_params(cfg, tree, device)`` takes the reference's
``init_model`` tree with numpy arrays as leaves (``jax.device_get`` of it,
or ``np.asarray`` per leaf) and returns a model on ``device`` whose
parameters hold the same values bit for bit. Names are the tree's paths
joined by dots, except inside a stack: the reference's ``seg{i}`` entry is
a tuple over pattern slots, each leaf stacked over the segment's repeats,
and the port keeps one block per layer, so leaf row ``r`` of slot ``j``
lands in layer :meth:`~repro_torch.models.transformer.Stack.layer_index`
``(i, r, j)``. Matmul weights keep the reference's ``(d_in, d_out)``
layout, so no leaf is transposed. The carry is a bijection: it raises
unless every leaf lands in exactly one parameter of the same shape and
dtype and every parameter is filled.
"""

from __future__ import annotations

from typing import Dict, Iterator, Tuple

import numpy as np
import torch

from .._device import resolve_device
from ..configs.base import ArchConfig
from .model import Model

__all__ = ["from_reference_params", "reference_leaves"]

_STACKS = ("stack", "encoder", "decoder")


def _walk(tree, prefix: Tuple) -> Iterator[Tuple[Tuple, np.ndarray]]:
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _walk(tree[k], prefix + (k,))
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            yield from _walk(v, prefix + (i,))
    else:
        yield prefix, tree


def reference_leaves(model: Model, tree: Dict) -> Iterator[Tuple[str, np.ndarray]]:
    """``(port parameter name, value)`` for every leaf of the reference
    tree, stacked leaves split into their per-layer rows."""
    for path, leaf in _walk(tree, ()):
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
            name = ".".join([path[0], "layers", str(stack.layer_index(seg, r, slot)), *map(str, rest)])
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
    params = dict(model.named_parameters())
    filled = set()
    with torch.no_grad():
        for name, arr in reference_leaves(model, tree):
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
