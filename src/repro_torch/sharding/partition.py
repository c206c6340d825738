"""Partition rules for every parameter / optimizer / batch / cache tensor
(the JAX package's ``sharding/partition.py``), as DTensor placements.

Strategy (Megatron-style TP x DP, EP for experts, ZeRO-1 for optimizer
state), the reference's rules unchanged:

* batch-like dims -> the data axes (``('pod', 'data')`` on the multi-pod
  mesh, ``('data',)`` single-pod);
* attention head / ffn hidden / vocab dims -> the ``model`` axis;
* MoE experts -> the ``model`` axis (EP) when E divides the axis size,
  otherwise TP *within* experts (mixtral's 8 experts on a 16-wide axis);
* SSM d_inner-sized dims -> ``model``; the small B/C/dt streams replicate;
* optimizer moments -> the parameter spec plus the data axes on the largest
  still-unsharded dim (ZeRO-1);
* KV caches -> batch over data, kv-heads over model; MLA latents and SSM
  states shard their structurally analogous dims.

A spec is the reference's ``PartitionSpec`` as a tuple with one entry per
tensor dim: ``None``, an axis name, or a tuple of axis names.
:func:`to_placements` turns it into one DTensor placement per mesh dim.

The reference stacks each segment's layers on a leading ``reps`` dim; the
port holds one tensor per layer. The rules are therefore evaluated on the
reference's leaf (its path from :func:`repro_torch.models.convert
.reference_layout` and its stacked shape), because the FSDP/ZeRO choice of
"the largest free dim" and its size floor see the stacked shape, and the
per-layer spec is the reference's spec without its leading entry.
``by_path=True`` returns the reference's stacked specs themselves, keyed
by the reference's leaf paths. The leading entry is ``None`` but in one
case: where ZeRO-1 (or FSDP) finds the repeats dim the largest free one,
as for mamba2's ``conv_x_w`` moments ``(48, 4, 3072)``, the reference
spreads the layers over the data axes; one layer's tensor cannot hold
that placement, so it replicates over data there (these leaves are the
small ones: under 1 MB a layer at full width).

``mesh`` is a live ``DeviceMesh`` or a :class:`repro_torch.launch.mesh
.MeshShape`.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Sequence, Tuple

from ..configs.base import ArchConfig

__all__ = [
    "data_axes",
    "mesh_sizes",
    "param_specs",
    "opt_state_specs",
    "batch_specs",
    "cache_specs",
    "to_placements",
    "to_spec",
]

Spec = Tuple[Any, ...]


def mesh_sizes(mesh) -> Dict[str, int]:
    """``{axis name: size}`` of a ``DeviceMesh`` or a ``MeshShape``."""
    if hasattr(mesh, "mesh_dim_names"):
        return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))
    return dict(zip(mesh.axis_names, mesh.sizes))


def _axis_names(mesh) -> Tuple[str, ...]:
    return tuple(mesh_sizes(mesh))


def data_axes(mesh) -> Tuple[str, ...]:
    return tuple(a for a in _axis_names(mesh) if a in ("pod", "data"))


def _axis_size(mesh, name: str) -> int:
    return mesh_sizes(mesh).get(name, 1)


# leaf-name buckets ---------------------------------------------------------
_SHARD_LAST = {"wq", "wk", "wv", "wq_b", "wkv_b", "up", "gate", "wz", "wx", "proj", "lm_head"}
_SHARD_PENULT_LAST = {"wo", "down", "out_proj"}  # (in=model-sharded, out)
_REPLICATE = {
    "router", "wq_a", "wkv_a", "wbc", "wdt", "conv_x_b", "conv_bc_w",
    "conv_bc_b", "dt_bias", "a_log", "d_skip", "norm_w", "q_norm", "kv_norm",
    "norm1", "norm2", "norm_cross", "final_norm", "enc_norm", "norm_h",
    "norm_e", "pos_embed", "conv_b",
}
_SHARD_LAST_1D = {"conv_x_w", "conv_x_b"}  # depthwise conv over d_inner


def _name_of(path: Tuple) -> str:
    names = [p for p in path if isinstance(p, str)]
    return names[-1] if names else ""


def _in_experts(path: Tuple) -> bool:
    return "experts" in path


def _axes_of(entry) -> Tuple[str, ...]:
    return entry if isinstance(entry, tuple) else (entry,)


def _add_dp(spec: Spec, shape, dp: Tuple[str, ...], mesh, min_elems: int = 1 << 16) -> Spec:
    """Additionally shard the largest evenly-divisible free dim over the
    (not already used) data axes (FSDP / ZeRO-style)."""
    if not dp or len(shape) == 0 or math.prod(shape) < min_elems:
        return spec
    entries = list(spec) + [None] * (len(shape) - len(spec))
    used = {a for e in entries if e is not None for a in _axes_of(e)}
    dp = tuple(a for a in dp if a not in used)
    if not dp:
        return spec
    dp_size = math.prod(_axis_size(mesh, a) for a in dp)
    free = [i for i, s in enumerate(entries) if s is None and shape[i] % max(dp_size, 1) == 0]
    if not free:
        return spec
    i_best = max(free, key=lambda i: shape[i])
    entries[i_best] = dp if len(dp) > 1 else dp[0]
    return tuple(entries)


def _divisible(shape, entries, mesh) -> bool:
    """Every sharded dim must divide evenly."""
    for size, e in zip(shape, entries):
        if e is None:
            continue
        total = math.prod(_axis_size(mesh, a) for a in _axes_of(e))
        if total and size % total:
            return False
    return True


def _pad(shape, mesh, candidates, dp=()) -> Spec:
    """First candidate whose sharded dims divide evenly; candidates are
    right-aligned tails, left-padded with None for stacked leading dims.
    FSDP then adds the data axes on the largest remaining free dim."""
    rank = len(shape)
    for tail in list(candidates) + [[None] * rank]:
        entries = [None] * (rank - len(tail)) + list(tail)
        if _divisible(shape, entries, mesh):
            spec = tuple(entries)
            return _add_dp(spec, shape, dp, mesh) if dp else spec
    return (None,) * rank


def _spec_for(path: Tuple, shape: Tuple[int, ...], cfg: ArchConfig, mesh, fsdp: bool) -> Spec:
    """The reference's ``_spec_for`` on a leaf of the reference's tree."""
    name = _name_of(path)
    rank = len(shape)
    model_size = _axis_size(mesh, "model")
    dp = data_axes(mesh) if fsdp else ()
    pad = lambda *c: _pad(shape, mesh, c, dp)  # noqa: E731

    if _in_experts(path):
        if cfg.moe.n_experts % model_size == 0:
            return pad(["model", None, None])  # EP: the expert dim of (E, d, f)
        if name in ("up", "gate"):  # TP within experts
            return pad([None, None, "model"], [None, "model", None])
        return pad([None, "model", None], [None, None, "model"])
    if name == "embed":
        # vocab-sharded; odd vocabs (whisper 51865) fall back to d_model
        return pad(["model", None], [None, "model"])
    if name in _REPLICATE:
        return (None,) * rank
    if name in _SHARD_LAST_1D:
        return pad(["model"])
    if name in _SHARD_LAST:
        return pad([None, "model"], ["model", None])
    if name in _SHARD_PENULT_LAST:
        return pad(["model", None], [None, "model"])
    return (None,) * rank  # biases, scalars, anything unrecognized


def _unstack(spec: Spec, where: str) -> Spec:
    if spec[0] is not None:
        raise ValueError(f"{where}: the reference shards the repeats dim ({spec}); "
                         "per-layer caches cannot hold that placement")
    return spec[1:]


def _leaf_specs(cfg, params, mesh, fsdp: bool, zero1: bool, by_path: bool) -> Dict:
    from ..models.convert import reference_layout

    named = dict(params.named_parameters())
    dp = data_axes(mesh)
    dp_size = math.prod(_axis_size(mesh, a) for a in dp)
    out: Dict[str, Spec] = {}
    for path, names, stacked in reference_layout(params):
        shape = tuple(named[names[0]].shape)
        full = (len(names),) + shape if stacked else shape
        spec = _spec_for(path, full, cfg, mesh, fsdp)
        if zero1 and dp_size != 1:
            spec = _add_dp(spec, full, dp, mesh)
        if by_path:
            out[path] = spec
            continue
        for n in names:
            out[n] = spec[1:] if stacked else spec  # the repeats dim's entry dropped
    return out


def param_specs(cfg: ArchConfig, params, mesh, fsdp: bool = False, by_path: bool = False) -> Dict:
    """``{parameter name: spec}`` of a :class:`repro_torch.models.model
    .Model` (the meta device will do: only shapes are read).

    ``fsdp=True`` additionally shards every large parameter over the data
    axes (ZeRO-3 / weight-gather) -- required for the >50B archs, where
    TP-16 alone leaves tens of GB of parameters per chip."""
    return _leaf_specs(cfg, params, mesh, fsdp, zero1=False, by_path=by_path)


def opt_state_specs(cfg: ArchConfig, params, mesh, fsdp: bool = False,
                    by_path: bool = False) -> Dict:
    """ZeRO-1: moments = param spec + data axes on the largest free dim.
    (With fsdp=True the param spec already includes the data axes.)"""
    return _leaf_specs(cfg, params, mesh, fsdp, zero1=True, by_path=by_path)


def _batch_entry(mesh, batch_size: int):
    """The batch dim's entry and, when the batch cannot shard, the data
    axes the cache length takes instead."""
    dp = data_axes(mesh)
    dp_size = math.prod(_axis_size(mesh, a) for a in dp)
    b = dp if len(dp) > 1 else (dp[0] if dp else None)
    if batch_size and batch_size % max(dp_size, 1):
        return None, b
    return b, None


def batch_specs(cfg: ArchConfig, mesh, batch_size: int = 0) -> Dict[str, Spec]:
    """Input shardings: batch over the data axes (replicated when the batch
    is smaller than the data extent, e.g. long_500k's global_batch=1)."""
    b, _ = _batch_entry(mesh, batch_size)
    specs = {"tokens": (b, None), "labels": (b, None), "positions": (b, None)}
    if cfg.frontend or cfg.enc_dec:
        specs["frontend"] = (b, None, None)
    if cfg.rope == "mrope":
        specs["positions"] = (b, None, None)
    return specs


def _cache_leaf_spec(name: str, shape, mesh, b, sa) -> Spec:
    """The reference's cache rules with divisibility-guarded fallbacks:

    * batch over the data axes when it divides; otherwise (long_500k B=1)
      the cache *length* dim is sharded over data instead -- context
      parallelism over the KV/ring cache;
    * kv-heads over model when divisible (llama KH=8 on model=16 falls back
      to head_dim); SSM states shard heads, falling back to head_dim.
    """
    pad = lambda *c: _pad(shape, mesh, c)  # noqa: E731
    if name in ("k", "v"):  # (reps?, B, L, KH, Dh)
        return pad([b, sa, "model", None], [b, sa, None, "model"], [b, sa, None, None])
    if name in ("ckv", "krope"):  # (reps?, B, L, r)
        return pad([b, sa, None])
    if name == "conv_x":  # (reps?, B, K-1, d_inner)
        return pad([b, None, "model"])
    if name == "conv_bc":
        return pad([b, None, None])
    if name == "ssm":  # (reps?, B, H, P, N)
        return pad([b, "model", None, None], [b, None, "model", None], [b, None, None, "model"])
    if name == "enc_out":  # (B, S_enc, d)
        return pad([b, None, None])
    return (None,) * len(shape)  # idx and anything unrecognized


def cache_specs(cfg: ArchConfig, caches: Dict, mesh, batch_size: int = 0) -> Dict:
    """Specs shaped as the port's caches (``{"stack": [one dict per layer],
    "enc_out"?}``, :func:`repro_torch.serve.kvcache.init_caches`)."""
    from ..models.transformer import layer_index, segments

    b, sa = _batch_entry(mesh, batch_size)
    segs = segments(cfg)
    reps_of = {layer_index(segs, si, r, j): reps
               for si, (pattern, reps) in enumerate(segs)
               for r in range(reps) for j in range(len(pattern))}
    layers: List[Optional[Dict]] = []
    for i, layer in enumerate(caches["stack"]):
        if layer is None:
            layers.append(None)
            continue
        spec_layer = {}
        for part, leaves in layer.items():
            spec_layer[part] = {
                k: _unstack(_cache_leaf_spec(k, (reps_of[i],) + tuple(t.shape), mesh, b, sa),
                            f"stack.{i}.{part}.{k}")
                for k, t in leaves.items()
            }
        layers.append(spec_layer)
    out: Dict = {"stack": layers}
    if "enc_out" in caches:
        out["enc_out"] = _cache_leaf_spec("enc_out", tuple(caches["enc_out"].shape), mesh, b, sa)
    return out


# ---------------------------------------------------------------------------
# Specs <-> DTensor placements
# ---------------------------------------------------------------------------
def to_placements(spec: Sequence, mesh) -> list:
    """One placement per mesh dim: ``Shard(d)`` where that axis shards
    tensor dim ``d``, else ``Replicate()``. An axis tuple on one dim (e.g.
    ``('pod', 'data')``) gives ``Shard(d)`` on each of those mesh dims,
    major to minor in the mesh's order, as the reference splits it. An
    axis of size 1 shards nothing, so its mesh dim is ``Replicate()``
    (as a size-1 axis of a JAX ``NamedSharding`` replicates): a 1 x 1
    mesh computes exactly what one device does."""
    from torch.distributed.tensor import Replicate, Shard

    names = _axis_names(mesh)
    sizes = mesh_sizes(mesh)
    where: Dict[str, int] = {}
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        axes = _axes_of(entry)
        unknown = set(axes) - set(names)
        if unknown:
            raise ValueError(f"spec {spec} names axes {sorted(unknown)} the mesh {names} lacks")
        if list(axes) != sorted(axes, key=names.index):
            raise ValueError(f"spec {spec}: axes {axes} are not in the mesh's order {names}")
        for a in axes:
            if a in where:
                raise ValueError(f"spec {spec} uses axis {a!r} twice")
            where[a] = d
    return [Shard(where[a]) if a in where and sizes[a] > 1 else Replicate() for a in names]


def to_spec(placements: Sequence, mesh, ndim: int) -> Spec:
    """The inverse of :func:`to_placements` for ``ndim``-dim tensors (on
    a mesh whose axes are all larger than 1)."""
    from torch.distributed.tensor import Replicate, Shard

    entries: List[List[str]] = [[] for _ in range(ndim)]
    for a, pl in zip(_axis_names(mesh), placements):
        if isinstance(pl, Shard):
            entries[pl.dim % ndim].append(a)
        elif not isinstance(pl, Replicate):
            raise ValueError(f"placement {pl} has no spec entry")
    return tuple(None if not e else (e[0] if len(e) == 1 else tuple(e)) for e in entries)
