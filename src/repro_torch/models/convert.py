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

A whole train state carries both ways too. The reference's train state is
``{"comp"?, "opt": {"m", "step", "v"}, "params"}`` with ``m``, ``v`` and
``comp`` trees shaped as ``params``; the port's is ``{"params": Model,
"opt": {"m": {name: tensor}, "step": 0-d int32, "v": {...}}, "comp"?:
{...}}`` (:mod:`repro_torch.train.train_step`). :func:`reference_layout`
lists the reference tree's leaves in the order ``jax.tree_util`` flattens
it (dict keys sorted, segment slots in order), each with the port names of
its rows; :func:`train_state_leaves` lists a port train state's leaves in
the reference's train-state order, which is the order of a checkpoint's
``leaf_{i:05d}.npy`` files (:mod:`repro_torch.checkpoint`);
:func:`train_state_to_reference` and :func:`train_state_from_reference`
carry the values.
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
    "reference_layout",
    "train_state_leaves",
    "train_state_to_reference",
    "train_state_from_reference",
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


# ---------------------------------------------------------------------------
# Train states
# ---------------------------------------------------------------------------
def reference_layout(model: Model) -> List[Tuple[Tuple, List[str], bool]]:
    """``(path, names, stacked)`` for every leaf of the reference's
    parameter tree, in ``jax.tree_util``'s flatten order. ``names[r]`` is
    the port parameter holding row ``r`` of a leaf stacked over a
    segment's repeats (``stacked``); an unstacked leaf has one name."""
    slots = {}
    for stack in _STACKS:
        if hasattr(model, stack):
            segs = getattr(model, stack).segs
            slots[stack] = {
                layer_index(segs, si, r, j): (si, r, j)
                for si, (pattern, reps) in enumerate(segs)
                for r in range(reps) for j in range(len(pattern))
            }
    rows: Dict[Tuple, Dict[int, str]] = {}
    for name, _ in model.named_parameters():
        parts = name.split(".")
        if parts[0] in slots:
            si, r, j = slots[parts[0]][int(parts[2])]
            rows.setdefault((parts[0], f"seg{si}", j, *parts[3:]), {})[r] = name
        else:
            rows[tuple(parts)] = {-1: name}
    return [(path, [rows[path][r] for r in sorted(rows[path])], path[0] in slots)
            for path in sorted(rows)]


def train_state_leaves(state: Dict) -> List[Tuple[Tuple, List[torch.Tensor], bool]]:
    """``(path, tensors, stacked)`` for every leaf of the reference's train
    state, in its flatten order: the port tensors of the leaf's rows
    (stacked) or its one tensor."""
    model = state["params"]
    layout = reference_layout(model)

    def tree(prefix, src):
        return [(prefix + path, [src[n] for n in names], stacked) for path, names, stacked in layout]

    out = []
    if "comp" in state:
        out += tree(("comp",), state["comp"])
    out += tree(("opt", "m"), state["opt"]["m"])
    out.append((("opt", "step"), [state["opt"]["step"]], False))
    out += tree(("opt", "v"), state["opt"]["v"])
    return out + tree(("params",), dict(model.named_parameters()))


def _set_path(tree: Dict, path: Tuple, value) -> None:
    for key in path[:-1]:
        tree = tree.setdefault(key, {})
    tree[path[-1]] = value


def _tuples(tree):
    """Nested dicts whose keys are segment-slot integers as tuples."""
    if not isinstance(tree, dict):
        return tree
    out = {k: _tuples(v) for k, v in tree.items()}
    if out and all(isinstance(k, int) for k in out):
        return tuple(out[k] for k in sorted(out))
    return out


def train_state_to_reference(state: Dict) -> Dict:
    """A port train state as the reference's train-state tree, numpy
    leaves stacked over each segment's repeats."""
    tree: Dict = {}
    for path, tensors, stacked in train_state_leaves(state):
        arrs = [_to_numpy(t) for t in tensors]
        _set_path(tree, path, np.stack(arrs) if stacked else arrs[0])
    return _tuples(tree)


def _get_path(tree, path: Tuple):
    for key in path:
        tree = tree[key]
    return tree


def train_state_from_reference(cfg: ArchConfig, tree: Dict, device=None) -> Dict:
    """The reference's train-state tree (numpy leaves) as a port train
    state on ``device`` (the card unless given), bit for bit."""
    device = resolve_device(device)
    model = from_reference_params(cfg, tree["params"], device)
    layout = reference_layout(model)

    def carry(sub) -> Dict[str, torch.Tensor]:
        out = {}
        for path, names, stacked in layout:
            arr = np.asarray(_get_path(sub, path))
            for r, name in enumerate(names):
                out[name] = _to_tensor(arr[r] if stacked else arr).to(device)
        return out

    state: Dict = {"params": model, "opt": {
        "m": carry(tree["opt"]["m"]),
        "step": _to_tensor(np.asarray(tree["opt"]["step"])).to(device),
        "v": carry(tree["opt"]["v"]),
    }}
    if "comp" in tree:
        state["comp"] = carry(tree["comp"])
    return state
