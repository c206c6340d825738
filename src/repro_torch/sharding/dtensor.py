"""The port's tensors on a ``DeviceMesh``: parameters, train states,
batches and caches as DTensors placed by the partition rules, and the few
model ops that DTensor's sharding propagation cannot take as they stand.

Placing never communicates: every rank holds the same full values (drawn
from one seed, or read from one checkpoint file) and keeps its own shard
(``distribute_tensor(..., src_data_rank=None)``). From there DTensor's
propagation plays the part GSPMD plays in the reference: column- and
row-parallel products, partial sums reduced where a replicated value is
needed. Where an op has no correct rule, the model calls one of the
helpers below; each is the identity on a plain tensor, so the
single-device path does not change by a bit:

* :func:`vocab_embedding` -- the embedding lookup in a vocab-sharded
  table gives a masked partial sum, which DTensor can neither
  reduce-scatter into the next op's layout nor back-propagate a partial
  gradient into; it runs under ``local_map`` as a masked lookup in each
  rank's rows of the table, the activations summed over the vocab ranks
  (nothing of the table moves);
* :func:`gather_slots` -- the MoE's combine reads each token's expert
  outputs by slot (``torch.gather``); with the experts over ``model``
  (expert parallelism) each rank reads the slots it holds and the sums
  are added up over ``model``, as the lookup above, instead of gathering
  every expert's outputs;
* :func:`fsdp_gather` -- the MoE's expert products under FSDP: left to
  its cost model at full width, DTensor gathers the tokens over the data
  axes rather than the experts' weights, and every data rank then runs
  every group; where the tokens are sharded over data the weights are
  gathered first, as FSDP does;
* :func:`vocab_nll` -- the loss gathers each target's logit along the
  vocab dim (``torch.gather``), which has no rule for a sharded gather
  dim; it runs under ``local_map`` on each rank's vocab shard: the
  log-sum-exp from the local max and sum, and the target's logit from the
  rank that holds it, each reduced over the vocab ranks as one value per
  position (the logits never gather);
* :func:`assign` and :func:`write_slots` -- the caches' in-place writes
  (``copy_``, ``index_copy_`` of new slots) want the value in the cache's
  own layout and act on the local shards; when the cache length is
  sharded (the long-context fallback) each rank writes the slots that fall
  in its own range, without reading anything back to the host;
* :func:`reduce_partial` -- the row-parallel products (attention's and
  the MLP's output projections) leave the residual stream a partial sum
  over ``model``, which DTensor carries on through the residual adds and
  even through the norm (linear once its scale is computed); the next
  column-parallel product then gathers its *weight* rather than reduce
  the activations. The norm reduces its input first, once per
  projection, as GSPMD and tensor parallelism do; and
  :func:`reduce_partial_grad` does the same for the gradient that the
  column-parallel products hand back to the norm's output, which would
  otherwise reach the row-parallel products' backward as a partial sum
  and gather their weights there;
* :func:`unshard_dim` -- gathers one dim (:func:`split_dim`'s fallback);
* :func:`grad_in_layout` -- a value whose gradient the backward hands back
  in a layout its producer's backward cannot take is given that gradient
  in its own layout: the SSM's dt projection (torch 2.11's elementwise
  rules shard its gradient along the sequence, which the product's
  backward cannot flatten);
* :func:`shard_like` -- a replicated operand sliced, on each rank, to
  the part another tensor's sharding needs: the SSM's dt projection to
  the heads the rank holds, and the merged heads to ``wo``'s rows where
  ``model`` does not divide the heads (so the output projection's
  backward is row-parallel too, and the merge's gradient comes back
  whole, where it splits into heads);
* :func:`split_dim` -- splitting a sharded dim into heads (``view``) has
  no rule when the leading factor does not divide the shard count (GQA's
  kv heads on a wider model axis: llama's 8 on 16, the reduced archs' 2 on
  4); the dim is gathered first, which GSPMD does on its own;
* :func:`local_rows` -- the MoE dispatch and combine (``scatter_add_`` and
  ``gather`` over token slots, ``cumsum`` over routing ranks) have no
  rules, nor the SSM scan's backward (``aten.flip``, from ``cumsum``'s);
  they run under ``local_map`` on each rank's routing groups or batch
  rows, with that dim kept sharded over the data axes, the SSM's heads
  kept sharded over ``model`` (:func:`shard_like` splits the projection
  that feeds them), and every other mesh dim replicated;
* :func:`local_heads` -- the attention core's einsums flatten the batch
  and head dims together, which DTensor cannot do when both are sharded
  (torch 2.11), and GQA's kv heads may be fewer than ``model``'s ranks;
  it runs under ``local_map`` on each rank's batch rows and its own q
  heads, against the kv heads those read (sliced on the rank, their
  gradients partial sums over ``model``), or, against a cache sharded
  along its head dims, on each rank's slice of those dims.

The train and serve steps run one body on both: :func:`distribute_batch`,
:func:`distribute_caches`, :func:`microbatches`, :func:`replicating`,
:func:`rows_like`, :func:`check_placed`, :func:`zeros_like`,
:func:`add_`, :func:`to_layout` and :func:`full` place, make, slice,
accumulate and gather DTensors and leave plain tensors (``mesh=None``)
as the single-device path has them.
"""

from __future__ import annotations

import contextlib
import math
from typing import Callable, Dict, Iterator, Optional, Sequence

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard, distribute_tensor

from .partition import batch_specs, cache_specs, opt_state_specs, param_specs, to_placements

__all__ = [
    "is_mesh",
    "mesh_device",
    "opt_placements",
    "place",
    "full",
    "distribute_model",
    "distribute_batch",
    "distribute_caches",
    "microbatches",
    "replicating",
    "rows_like",
    "check_placed",
    "zeros_like",
    "add_",
    "to_layout",
    "vocab_embedding",
    "vocab_nll",
    "gather_slots",
    "fsdp_gather",
    "reduce_partial",
    "reduce_partial_grad",
    "grad_in_layout",
    "unshard_dim",
    "split_dim",
    "shard_count",
    "assign",
    "write_slots",
    "local_rows",
    "local_heads",
    "shard_like",
    "sum_partial",
    "sum_grad",
]


def is_mesh(x) -> bool:
    return isinstance(x, DeviceMesh)


def mesh_device(mesh: DeviceMesh) -> torch.device:
    """This rank's device of ``mesh`` (the current card for a CUDA mesh)."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def place(t: torch.Tensor, mesh: DeviceMesh, spec) -> DTensor:
    """``t`` (the same full value on every rank) as a DTensor with the
    placements of ``spec``; each rank keeps its shard, no communication."""
    return distribute_tensor(t, mesh, to_placements(spec, mesh), src_data_rank=None)


def full(t):
    """A DTensor's full value (a collective: every rank must call it); a
    plain tensor as it is."""
    return t.full_tensor() if isinstance(t, DTensor) else t


def _set_param(model: nn.Module, name: str, value: torch.Tensor) -> None:
    *owner, leaf = name.split(".")
    module = model.get_submodule(".".join(owner))
    module.register_parameter(leaf, nn.Parameter(value, requires_grad=True))


def distribute_model(model: nn.Module, cfg, mesh: DeviceMesh, fsdp: bool = False) -> nn.Module:
    """Replace every parameter of ``model`` by a DTensor placed by
    :func:`~repro_torch.sharding.partition.param_specs`, in place."""
    specs = param_specs(cfg, model, mesh, fsdp)
    with torch.no_grad():
        for name, p in list(model.named_parameters()):
            _set_param(model, name, place(p.detach(), mesh, specs[name]))
    return model


def opt_placements(cfg, model: nn.Module, mesh: DeviceMesh, fsdp: bool = False) -> Dict[str, list]:
    """ZeRO-1 placements of the optimizer moments, by parameter name."""
    return {n: to_placements(s, mesh) for n, s in opt_state_specs(cfg, model, mesh, fsdp).items()}


def distribute_batch(cfg, batch: Dict[str, torch.Tensor], mesh) -> Dict[str, DTensor]:
    """A global batch (the same on every rank) placed by ``batch_specs``;
    leaves that are DTensors already are kept. ``mesh=None``: the batch
    as it is."""
    if mesh is None:
        return batch
    b = next(iter(batch.values())).shape[0]
    specs = batch_specs(cfg, mesh, batch_size=b)
    return {k: v if isinstance(v, DTensor) else place(v, mesh, specs.get(k, specs["tokens"]))
            for k, v in batch.items()}


def _place_cache(t: torch.Tensor, mesh: DeviceMesh, spec) -> DTensor:
    """A cache leaf placed by ``spec``; one on the meta device is allocated
    on the mesh, zeros as ``init_caches`` makes them, each rank its own
    shard only."""
    if not t.is_meta:
        return place(t, mesh, spec)
    from torch.distributed.tensor import zeros

    return zeros(tuple(t.shape), dtype=t.dtype, device_mesh=mesh,
                 placements=to_placements(spec, mesh))


def distribute_caches(cfg, caches: Dict, mesh, batch_size: int) -> Dict:
    """Caches (``init_caches``' layout, the same on every rank) placed by
    ``cache_specs``, including the long-context fallback that shards the
    cache length over the data axes when the batch cannot shard. Caches
    built on the meta device are allocated shard by shard, so no rank
    holds a whole cache (at full width a prefill_32k cache is 100-480 GB).
    ``mesh=None``: the caches as they are."""
    if mesh is None:
        return caches
    specs = cache_specs(cfg, caches, mesh, batch_size=batch_size)
    layers = [
        None if layer is None else {
            part: {k: _place_cache(t, mesh, specs["stack"][i][part][k])
                   for k, t in leaves.items()}
            for part, leaves in layer.items()
        }
        for i, layer in enumerate(caches["stack"])
    ]
    out = {"stack": layers}
    if "enc_out" in caches:
        out["enc_out"] = _place_cache(caches["enc_out"], mesh, specs["enc_out"])
    return out


def microbatches(cfg, batch: Dict[str, torch.Tensor], m: int) -> Iterator[Dict]:
    """The ``m`` microbatches of ``batch``, row blocks in order. A placed
    batch is gathered once and each block placed again by ``batch_specs``,
    so every microbatch stays sharded over the data axes (a slice of a
    sharded dim would leave a microbatch on one data rank; the reference
    re-pins the sharding for the same reason)."""
    leaf = next(iter(batch.values()))
    mesh = leaf.device_mesh if isinstance(leaf, DTensor) else None
    whole = {k: full(v) for k, v in batch.items()}
    b = leaf.shape[0]
    for i in range(m):
        mb = {k: v.reshape(m, b // m, *v.shape[1:])[i] for k, v in whole.items()}
        yield distribute_batch(cfg, mb, mesh)


def replicating(mesh):
    """On a mesh, DTensor's ``implicit_replication``: the plain tensors
    the model makes (constants, frequency tables, cache slot ids) hold the
    same global values on every rank and count as replicated; position
    ids are made in the tokens' layout instead (:func:`rows_like`). Else
    nothing."""
    if mesh is None:
        return contextlib.nullcontext()
    from torch.distributed.tensor.experimental import implicit_replication

    return implicit_replication()


def check_placed(params: Sequence[torch.Tensor], where) -> None:
    """Raise unless ``params`` lie where a step runs: DTensors on the mesh
    ``where``, or plain tensors on a device of ``where``'s type."""
    if is_mesh(where):
        if not all(isinstance(p, DTensor) and p.device_mesh == where for p in params):
            raise ValueError("the parameters are not DTensors on the step's mesh: place them "
                             "with repro_torch.sharding.dtensor.distribute_model first")
    elif params[0].device.type != where.type:
        raise ValueError(f"the state lies on {params[0].device}, the step on {where}")


def zeros_like(x: torch.Tensor) -> torch.Tensor:
    """Zeros of ``x``'s shape, dtype and layout; a DTensor's placements
    are kept as they are, partial sums too (``torch.zeros_like`` makes a
    partial DTensor replicated)."""
    if not isinstance(x, DTensor):
        return torch.zeros_like(x)
    return DTensor.from_local(torch.zeros_like(x.to_local()), x.device_mesh, x.placements,
                              shape=x.shape, stride=x.stride())


def add_(acc: torch.Tensor, x: torch.Tensor) -> None:
    """``acc += x`` in place; a DTensor ``acc`` adds ``x`` brought into its
    own layout, shard by shard (partial sums add as partial sums)."""
    if not isinstance(acc, DTensor):
        acc += x
        return
    acc.to_local().add_(to_layout(x, acc).to_local())


def to_layout(x: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """``x`` redistributed to ``like``'s placements; a plain ``x`` as it is."""
    if not isinstance(x, DTensor) or list(x.placements) == list(like.placements):
        return x
    return x.redistribute(placements=like.placements)


class _SumOver(torch.autograd.Function):
    """``all_reduce(SUM)`` over process groups in the forward, the identity
    in the backward: the sum is the same on every rank of those groups, so
    each rank's part takes the (replicated) gradient of the sum as it is."""

    @staticmethod
    def forward(ctx, x, groups):
        x = x.clone()
        for g in groups:
            dist.all_reduce(x, group=g)
        return x

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _SumGrad(torch.autograd.Function):
    """The identity in the forward, ``all_reduce(SUM)`` of the gradient over
    process groups in the backward: every rank of those groups holds the
    value whole but reads it against its own slice of another operand, so
    each rank's gradient is a part of the value's."""

    @staticmethod
    def forward(ctx, x, groups):
        ctx.groups = groups
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone(memory_format=torch.contiguous_format)
        for g in ctx.groups:
            dist.all_reduce(grad, group=g)
        return grad, None


def sum_partial(x: torch.Tensor, groups: Sequence = ()) -> torch.Tensor:
    """``x``, a partial sum on each rank, summed over ``groups``; its
    gradient passes as it is (every rank uses the sum whole). No groups:
    ``x`` as it is."""
    return _SumOver.apply(x, groups) if groups else x


def sum_grad(x: torch.Tensor, groups: Sequence = ()) -> torch.Tensor:
    """``x`` as it is, whose gradient is summed over ``groups`` (see
    :class:`_SumGrad`). No groups: ``x`` as it is."""
    return _SumGrad.apply(x, groups) if groups else x


def _local_extent(x: DTensor):
    """(local shape, global offset) of this rank's shard of ``x``."""
    return _extent(x.shape, x.placements, x.device_mesh)


def _extent(shape, placements, mesh: DeviceMesh):
    """(local shape, global offset) of this rank's shard of a tensor of
    ``shape`` with ``placements``, as ``torch.chunk`` splits each sharded
    dim, mesh dim by mesh dim, in plain ints (DTensor's own helper builds
    index tensors, which a fake tensor mode would turn into host reads)."""
    shape, offset = list(shape), [0] * len(shape)
    coord = mesh.get_coordinate()
    for i, p in enumerate(placements):
        if isinstance(p, Shard):
            chunk = -(-shape[p.dim] // mesh.size(i))
            start = min(coord[i] * chunk, shape[p.dim])
            offset[p.dim] += start
            shape[p.dim] = min(chunk, shape[p.dim] - start)
    return shape, offset


def rows_like(make: Callable, like: torch.Tensor) -> torch.Tensor:
    """A tensor whose rows (dim 0) are ``like``'s, made by ``make(lo, n)``,
    which returns its rows ``[lo, lo + n)``. A DTensor ``like`` gives a
    DTensor sharded along dim 0 as ``like`` is and replicated on every
    other mesh dim, each rank making its own rows only: nothing moves,
    and what is computed from it runs on the rank's rows (the reference's
    ids take the tokens' sharding so, through ``like=``). A plain
    ``like``: ``make(0, len(like))``."""
    if not isinstance(like, DTensor):
        return make(0, like.shape[0])
    mesh = like.device_mesh
    pls = [Shard(0) if p == Shard(0) else Replicate() for p in like.placements]
    (n, *_), (lo, *_) = _extent(like.shape[:1], pls, mesh)
    local = make(lo, n).contiguous()  # sharded along dim 0 only: its strides are the whole's
    return DTensor.from_local(local, mesh, pls, run_check=False,
                              shape=(like.shape[0], *local.shape[1:]), stride=local.stride())


def _vocab_shards(x: DTensor, dim: int):
    """(mesh dims that shard ``x`` along ``dim``, this rank's offset along
    ``dim``, its local extent there)."""
    dims = [i for i, p in enumerate(x.placements) if isinstance(p, Shard) and p.dim == dim]
    shape, offset = _local_extent(x)
    return dims, offset[dim], shape[dim]


def _as_dtensor(x, mesh: DeviceMesh):
    if isinstance(x, DTensor):
        return x
    return distribute_tensor(x, mesh, [Replicate()] * mesh.ndim, src_data_rank=None)


def vocab_embedding(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``F.embedding(ids, table)``. A DTensor ``table`` sharded over its
    vocab dim (dim 0) is read in place: each rank looks up the ids that
    fall in its rows (the others give zeros) and the activations are
    summed over the vocab ranks, so the result has ``ids``' layout,
    replicated over those ranks; the table's other dim is gathered if
    sharded (FSDP). Any other table: the lookup as it is."""
    if not isinstance(table, DTensor) or not any(
        isinstance(p, Shard) and p.dim == 0 for p in table.placements
    ):
        return F.embedding(ids, table)
    from torch.distributed.tensor.experimental import local_map

    mesh = table.device_mesh
    vdims = [i for i, p in enumerate(table.placements) if p == Shard(0)]
    t_pl = [Shard(0) if i in vdims else Replicate() for i in range(mesh.ndim)]
    ids = _as_dtensor(ids, mesh)
    i_pl = [Replicate() if i in vdims or isinstance(p, Partial) else p
            for i, p in enumerate(ids.placements)]
    table = table.redistribute(placements=t_pl)
    _, lo, n = _vocab_shards(table, 0)
    groups = [mesh.get_group(i) for i in vdims]

    def lookup(tbl, idx):
        loc = idx - lo
        hit = (loc >= 0) & (loc < n)
        x = F.embedding(torch.where(hit, loc, 0), tbl)
        return _SumOver.apply(torch.where(hit[..., None], x, 0), groups)

    # each rank's table gradient comes from its own ids: a partial sum
    # over the mesh dims that shard the ids
    g_pl = [p if i in vdims else Partial() if isinstance(i_pl[i], Shard) else Replicate()
            for i, p in enumerate(t_pl)]
    return local_map(_local(lookup), out_placements=i_pl, in_placements=(t_pl, i_pl),
                     in_grad_placements=(g_pl, i_pl), device_mesh=mesh,
                     redistribute_inputs=True)(table, ids)


def gather_slots(fn: Callable, table, slot, keep, *rest):
    """``fn(table, slot, keep, *rest)``: a weighted sum of the rows of
    ``table`` (G, N, d) that ``slot`` (G, T) names along dim 1, ``keep``
    false for slots to skip (the MoE's combine), on each rank's groups.

    Where ``table`` is sharded along dim 1 (the MoE's expert slots over
    ``model``: expert parallelism), each rank reads the slots it holds, the
    others masked out of ``keep``, and the sums are added up over those
    ranks, as :func:`vocab_embedding` does: no rank gathers the table. The
    groups keep ``slot``'s layout (the routing's), and so does the result.
    Otherwise :func:`local_rows` as it is."""
    if not isinstance(table, DTensor) or Shard(1) not in table.placements:
        return local_rows(fn, (table, slot, keep, *rest), (True,))
    from torch.distributed.tensor.experimental import local_map

    mesh = table.device_mesh
    sdims = [i for i, p in enumerate(table.placements) if p == Shard(1)]
    slot = _as_dtensor(slot, mesh)  # the groups' layout is the routing's
    rows = [Shard(0) if p == Shard(0) and i not in sdims else Replicate()
            for i, p in enumerate(slot.placements)]
    t_pl = [Shard(1) if i in sdims else p for i, p in enumerate(rows)]
    table = table.redistribute(placements=t_pl)
    _, lo, n = _vocab_shards(table, 1)
    groups = [mesh.get_group(i) for i in sdims]

    def combine(tbl, sl, kp, *r):
        loc = sl - lo
        hit = kp & (loc >= 0) & (loc < n)
        return _SumOver.apply(fn(tbl, torch.where(hit, loc, 0), hit, *r), groups)

    # each rank's gradient of ``rest`` (the gates) covers its own slots
    part = [Partial() if i in sdims else p for i, p in enumerate(rows)]
    n_rest = len(rest)
    return local_map(_local(combine), out_placements=rows,
                     in_placements=(t_pl, rows, rows) + (rows,) * n_rest,
                     in_grad_placements=(t_pl, rows, rows) + (part,) * n_rest,
                     device_mesh=mesh, redistribute_inputs=True)(table, slot, keep, *rest)


def vocab_nll(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Per position ``logsumexp(logits) - logits[label]`` over the last
    (vocab) dim (labels < 0 read entry 0; the caller masks them). A
    DTensor ``logits`` sharded over its vocab dim stays so: the max, the
    sum of exponentials and the target's logit are reduced over the vocab
    ranks as one value per position, under ``local_map``; the result has
    the logits' row layout. Plain or vocab-replicated logits: the
    single-device ops as they are."""
    vd = logits.ndim - 1
    if isinstance(logits, DTensor) and any(isinstance(p, Partial) for p in logits.placements):
        # partial sums are reduce-scattered over the vocab
        logits = logits.redistribute(placements=[Shard(vd) if isinstance(p, Partial) else p
                                                 for p in logits.placements])
    if not isinstance(logits, DTensor) or not any(
        isinstance(p, Shard) and p.dim == vd for p in logits.placements
    ):
        lse = torch.logsumexp(logits, dim=-1)
        tgt = torch.gather(logits, -1, torch.clamp(labels, min=0)[..., None].long())[..., 0]
        return lse - tgt
    from torch.distributed.tensor.experimental import local_map

    mesh = logits.device_mesh
    l_pl = list(logits.placements)
    r_pl = [Replicate() if p == Shard(vd) else p for p in l_pl]  # the rows' layout
    labels = _as_dtensor(labels, mesh)
    vdims, lo, n = _vocab_shards(logits, vd)
    groups = [mesh.get_group(i) for i in vdims]

    def nll(lg, lb):
        mx = lg.detach().amax(dim=-1)
        for g in groups:
            dist.all_reduce(mx, op=dist.ReduceOp.MAX, group=g)
        se = _SumOver.apply(torch.exp(lg - mx[..., None]).sum(dim=-1), groups)
        loc = lb.long() - lo
        hit = (loc >= 0) & (loc < n)
        tgt = torch.gather(lg, -1, torch.where(hit, loc, 0)[..., None])[..., 0]
        tgt = _SumOver.apply(torch.where(hit, tgt, 0.0), groups)
        return torch.log(se) + mx - tgt

    return local_map(_local(nll), out_placements=r_pl, in_placements=(l_pl, r_pl),
                     device_mesh=mesh, redistribute_inputs=True)(logits, labels)


def fsdp_gather(w, x):
    """A DTensor weight gathered over the mesh dims, ``model`` aside, that
    shard the tokens ``x`` it multiplies: FSDP's gather before a product,
    so the tokens stay sharded there (the weight's gradient is
    reduce-scattered back into its layout). Where the tokens are
    replicated (a decode step's one routing group) the weight stays
    sharded and the product splits its contraction instead. A plain
    tensor as it is."""
    if not isinstance(w, DTensor) or not isinstance(x, DTensor):
        return w
    md = _model_dim(w.device_mesh)
    pls = [Replicate() if i != md and isinstance(xp, Shard) else p
           for i, (p, xp) in enumerate(zip(w.placements, x.placements))]
    return w if pls == list(w.placements) else w.redistribute(placements=pls)


def reduce_partial(x):
    """A DTensor's partial sums reduced (those mesh dims replicated); a
    plain tensor as it is."""
    if not isinstance(x, DTensor) or not any(isinstance(p, Partial) for p in x.placements):
        return x
    return x.redistribute(placements=[Replicate() if isinstance(p, Partial) else p
                                      for p in x.placements])


class _OnGrad(torch.autograd.Function):
    """The identity, whose gradient passes through ``fn`` first."""

    @staticmethod
    def forward(ctx, x, fn):
        ctx.fn = fn
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return ctx.fn(grad), None


def reduce_partial_grad(x):
    """``x``, whose gradient on a mesh has its partial sums reduced; a
    plain tensor (or one that needs no gradient) as it is."""
    if not isinstance(x, DTensor) or not x.requires_grad:
        return x
    return _OnGrad.apply(x, reduce_partial)


def grad_in_layout(x):
    """``x``, whose gradient on a mesh comes back in ``x``'s own placements,
    a partial sum's replicated (redistributed if the backward handed it
    another layout); a plain tensor (or one that needs no gradient) as it
    is."""
    if not isinstance(x, DTensor) or not x.requires_grad:
        return x
    pls = [Replicate() if isinstance(p, Partial) else p for p in x.placements]
    return _OnGrad.apply(x, lambda g: g if list(g.placements) == pls
                         else g.redistribute(placements=pls))


def unshard_dim(x, dim: int):
    """Gather a DTensor over tensor dim ``dim`` (its shards there become
    replicated); partial sums are reduced too."""
    if not isinstance(x, DTensor):
        return x
    dim %= x.ndim
    pls = [Replicate() if isinstance(p, Partial) or (isinstance(p, Shard) and p.dim == dim)
           else p for p in x.placements]
    return x if list(pls) == list(x.placements) else x.redistribute(placements=pls)


def shard_count(x, dim: int) -> int:
    """How many shards a DTensor's ``dim`` is split into (1 for a plain
    tensor)."""
    if not isinstance(x, DTensor):
        return 1
    dim %= x.ndim
    return math.prod(x.device_mesh.size(i) for i, p in enumerate(x.placements)
                     if isinstance(p, Shard) and p.dim == dim)


def split_dim(x, dim: int, sizes: Sequence[int]):
    """``x`` with dim ``dim`` split into ``sizes`` (a reshape); a DTensor
    whose ``dim`` is sharded over more ranks than ``sizes[0]`` divides
    into is gathered over that dim first."""
    dim %= x.ndim
    if sizes[0] % shard_count(x, dim):
        x = unshard_dim(x, dim)
    return x.reshape(*x.shape[:dim], *sizes, *x.shape[dim + 1:])


def _like_layout(src, dst: DTensor, free_dim: int = -1):
    """``src`` redistributed to ``dst``'s placements (``free_dim`` of
    ``dst`` replicated instead of sharded)."""
    pls = [Replicate() if isinstance(p, Shard) and p.dim == free_dim else p
           for p in dst.placements]
    if not isinstance(src, DTensor):
        return distribute_tensor(src, dst.device_mesh, pls, src_data_rank=None)
    return src.redistribute(placements=pls)


def assign(dst, src) -> None:
    """``dst.copy_(src)``, in place; a DTensor ``dst`` takes ``src`` in its
    own layout, shard by shard."""
    if not isinstance(dst, DTensor):
        dst.copy_(src)
        return
    dst.to_local().copy_(_like_layout(src, dst).to_local())


def write_slots(buf, slots, val) -> None:
    """``buf.index_copy_(1, slots, val)``, in place, for distinct
    ``slots``. A DTensor ``buf`` sharded along dim 1 is written by each
    rank over its own range of slots: every local slot takes the update
    aimed at it, if any, else keeps its value."""
    if not isinstance(buf, DTensor):
        buf.index_copy_(1, slots, val.to(buf.dtype))
        return
    slots = slots.to_local() if isinstance(slots, DTensor) else slots
    local = buf.to_local()
    val = _like_layout(val, buf, free_dim=1).to_local().to(buf.dtype)
    if not any(isinstance(p, Shard) and p.dim == 1 for p in buf.placements):
        local.index_copy_(1, slots, val)
        return
    shape, offset = _local_extent(buf)
    inv = torch.full((buf.shape[1],), -1, dtype=torch.int64, device=local.device)
    inv.index_copy_(0, slots, torch.arange(slots.numel(), device=local.device))
    inv = inv[offset[1]:offset[1] + shape[1]]  # update row per local slot, -1: none
    new = val.index_select(1, torch.clamp(inv, min=0))
    hit = (inv >= 0).view(1, -1, *([1] * (local.ndim - 2)))
    local.copy_(torch.where(hit, new, local))


class _ContiguousGrad(torch.autograd.Function):
    """Identity whose backward hands on a contiguous gradient: a local
    gradient leaves ``local_map`` as a DTensor shard, and DTensor's views
    of it (the backward of a reshape) assume a contiguous shard."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return grad.contiguous()


def _local(fn: Callable) -> Callable:
    """``fn`` whose tensor arguments that require grad pass
    :class:`_ContiguousGrad` first."""
    def run(*args):
        return fn(*(_ContiguousGrad.apply(a) if isinstance(a, torch.Tensor) and a.requires_grad
                    else a for a in args))
    return run


def _model_dim(mesh: DeviceMesh) -> Optional[int]:
    """The index of the mesh dim named ``model``, if any."""
    names = mesh.mesh_dim_names or ()
    return names.index("model") if "model" in names else None


def shard_like(w, dim: int, like, like_dim: int):
    """``w`` sharded along ``dim`` on each mesh dim where ``like`` is
    sharded along ``like_dim`` and ``w`` is replicated: a slice on each
    rank, no communication (its gradient is gathered back). So a
    replicated projection feeds only the heads its rank holds, as GSPMD
    splits it. Otherwise, and for plain tensors, ``w`` as it is."""
    if not isinstance(w, DTensor) or not isinstance(like, DTensor):
        return w
    like_dim %= like.ndim
    pls = [Shard(dim) if isinstance(p, Replicate) and lp == Shard(like_dim) else p
           for p, lp in zip(w.placements, like.placements)]
    return w if pls == list(w.placements) else w.redistribute(placements=pls)


def local_rows(fn: Callable, args: Sequence, rows_out: Sequence[bool],
               heads: Optional[Sequence] = None, heads_out: Optional[Sequence] = None):
    """``fn(*args)`` on each rank's local rows, for an op without a
    sharding rule.

    The tensor arguments lead with one shared row dim (the MoE's routing
    groups). Every mesh dim on which the first DTensor argument is sharded
    along its rows keeps that sharding, every other mesh dim is
    replicated; the arguments are redistributed to that layout and ``fn``
    runs under ``local_map`` on the local tensors, so autograd flows
    through. Outputs flagged in ``rows_out`` come back in the row layout,
    the others replicated (each rank computed the same value). Without a
    DTensor argument, ``fn(*args)`` runs as it is.

    ``heads`` names each argument's head dim (``None``: it has none), for
    an ``fn`` whose heads are independent (the SSM scan): where the mesh
    dim ``model`` shards the first DTensor argument along its head dim,
    every argument with a head dim is sharded along it there (the others
    come in whole) and each output along its dim in ``heads_out``, so each
    rank runs its own heads.
    """
    first = next((i for i, a in enumerate(args) if isinstance(a, DTensor)), None)
    if first is None:
        return fn(*args)
    from torch.distributed.tensor.experimental import local_map

    mesh = args[first].device_mesh
    rows = [Shard(0) if p == Shard(0) else Replicate() for p in args[first].placements]
    md = _model_dim(mesh)
    split = (heads is not None and md is not None and heads[first] is not None
             and args[first].placements[md] == Shard(heads[first]))

    def layout(base, hd):
        out = list(base)
        if split:
            out[md] = Replicate() if hd is None else Shard(hd)
        return out

    repl = [Replicate()] * mesh.ndim
    in_pl = tuple(layout(rows, heads[i] if heads else None) if isinstance(a, DTensor) else None
                  for i, a in enumerate(args))
    out_pl = tuple(layout(rows if r else repl, heads_out[i] if heads_out else None)
                   for i, r in enumerate(rows_out))
    if len(out_pl) == 1:  # fn returns one tensor, not a tuple
        out_pl = out_pl[0]
    return local_map(_local(fn), out_placements=out_pl, in_placements=in_pl, device_mesh=mesh,
                     redistribute_inputs=True)(*args)


def local_heads(fn: Callable, q, k, v, rows: Sequence, dims_ok: bool = True):
    """``fn(q, k, v, *rows, groups)``, an attention core, on each rank's
    batch rows and its share of the attention, as GSPMD splits it.

    ``q`` is ``(B, Sq, H, Dk)``, ``k`` ``(B, L, KH, Dk)`` and ``v`` ``(B,
    L, KH, Dv)``; q head ``h`` reads kv head ``h // (H / KH)``. ``rows``
    lead with the batch rows (the positions). On every mesh dim but
    ``model`` the rows stay sharded where q is sharded along them, and the
    rest is replicated. On ``model`` (M ranks, this one r) the rank runs

    * its own q heads ``[r n, min((r + 1) n, H))``, ``n = ceil(H / M)``:
      ``torch.chunk``'s split, GSPMD's padding where M does not divide H.
      q comes in sharded along its heads where it is, else whole (as
      :func:`split_dim` leaves heads M does not divide) and is sliced on
      the rank; k and v come in sharded alike where their heads are, else
      whole (gathered, or a cache's layout), and each rank slices the kv
      heads its q heads read. An operand that comes in whole and is
      sliced takes back a partial gradient over ``model`` (each rank's
      covers its slice only), which DTensor reduces, or reduce-scatters
      into the projection's layout. The output is laid out as q's heads;
      heads that M does not divide are gathered after;
    * or, where k and v are sharded along their last dim (a cache whose kv
      heads M does not divide) and ``dims_ok``, its slice of the head
      dims: q comes in whole and is sliced alike, ``fn`` sums its partial
      scores over ``groups`` (the ``model`` group; see :func:`sum_partial`
      and :func:`sum_grad`) and reads its slice of Dv out, gathered after.
      No rank gathers the cache.

    ``groups`` is ``()`` but in the second case; a mesh whose ``model``
    axis is absent, or of size 1 and replicated, runs ``fn`` on whole
    heads. Without a DTensor among q, k and v, ``fn(q, k, v, *rows, ())``
    runs as it is.
    """
    dts = [a for a in (q, k, v) if isinstance(a, DTensor)]
    if not dts:
        return fn(q, k, v, *rows, ())
    from torch.distributed.tensor.experimental import local_map

    mesh = dts[0].device_mesh
    q, k, v = (_as_dtensor(a, mesh) for a in (q, k, v))
    rows = [_as_dtensor(a, mesh) for a in rows]
    base = [Shard(0) if p == Shard(0) else Replicate() for p in q.placements]
    md = _model_dim(mesh)
    if md is not None and mesh.size(md) == 1 and all(
            isinstance(a.placements[md], Replicate) for a in (q, k, v)):
        md = None
    if md is None:
        pls = [base] * 3 + [base] * len(rows)
        return local_map(_local(lambda *a: fn(*a, ())), out_placements=base,
                         in_placements=tuple(pls), device_mesh=mesh,
                         redistribute_inputs=True)(q, k, v, *rows)

    m, r = mesh.size(md), mesh.get_coordinate()[md]
    h, kh = q.shape[2], k.shape[2]
    g = h // kh

    def on_model(p):
        out = list(base)
        out[md] = p
        return out

    kv_pl = [k.placements[md], v.placements[md]]
    split_d = dims_ok and kv_pl == [Shard(3), Shard(3)]
    if split_d:
        q_in, kv_in, out_pl = Replicate(), Shard(3), Shard(3)
        groups = (mesh.get_group(md),)
    else:
        q_in = Shard(2) if q.placements[md] == Shard(2) and h % m == 0 else Replicate()
        kv_in = Shard(2) if kv_pl == [Shard(2), Shard(2)] and kh % m == 0 else Replicate()
        out_pl, groups = Shard(2), ()
    n = -(-h // m)
    lo, hi = min(r * n, h), min((r + 1) * n, h)
    k_off = r * kh // m if kv_in == Shard(2) else 0  # the local kv shard's first head

    def run(q, k, v, *rows):
        if split_d:
            dk = k.shape[-1]
            return fn(q[..., r * dk:(r + 1) * dk], k, v, *rows, groups)
        if q_in == Replicate():
            q = q[:, :, lo:hi]
        a = min(lo // g, kh - 1)  # the kv heads [a, b) that q heads [lo, hi) read
        b = (hi - 1) // g + 1 if hi > lo else a + 1
        if b - a == 1 or (lo % g == 0 and hi - lo == (b - a) * g):
            k, v = k[:, :, a - k_off:b - k_off], v[:, :, a - k_off:b - k_off]
        else:  # the q heads cover parts of groups: one kv head per q head
            idx = torch.arange(lo, hi, device=k.device) // g - k_off
            k, v = k.index_select(2, idx), v.index_select(2, idx)
        out = fn(q, k, v, *rows, ())
        return F.pad(out, (0, 0, 0, n - out.shape[2])) if out.shape[2] < n else out

    in_pl = ((on_model(q_in), on_model(kv_in), on_model(kv_in))
             + (on_model(Replicate()),) * len(rows))
    part = on_model(Partial())
    grad_pl = ((part if q_in == Replicate() else in_pl[0]),
               *((part if kv_in == Replicate() else in_pl[1]),) * 2) + in_pl[3:]
    out = local_map(_local(run), out_placements=on_model(out_pl), in_placements=in_pl,
                    in_grad_placements=grad_pl, device_mesh=mesh,
                    redistribute_inputs=True)(q, k, v, *rows)
    if split_d:
        return unshard_dim(out, 3)
    return out if out.shape[2] == h else unshard_dim(out, 2)[:, :, :h]
