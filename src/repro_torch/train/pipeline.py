"""GPipe-style pipeline parallelism over a ``stage`` mesh dim (the JAX
package's ``train/pipeline.py``).

When a model's layers do not fit even with TP+FSDP, stages of layers are
placed on a ``stage`` mesh dim and microbatches stream through with the
classic fill-drain GPipe schedule (M + S - 1 ticks, bubble fraction
(S-1)/(M+S-1)); not 1F1B.

Each rank of the ``stage`` dim holds its own stage's parameters and runs
the schedule: at tick t, stage s works on microbatch t - s when there is
one, receiving its input from stage s - 1 and sending its output to stage
s + 1 with ``batch_isend_irecv`` (the reference's ``ppermute`` over the
stage axis). The last stage banks the finished microbatches, and a masked
sum over the stage group (zeros elsewhere, exact) hands them to every
rank, as the reference's masked ``psum`` does.

The port's schedule runs forward only: point-to-point sends carry no
autograd, so :func:`pipeline_apply` refuses parameters or inputs that
require grad rather than return values without a backward.
"""

from __future__ import annotations

from typing import Any, Callable, Dict

import torch

__all__ = ["pipeline_apply", "bubble_fraction"]


def bubble_fraction(n_stages: int, n_microbatches: int) -> float:
    """Idle fraction of the fill-drain schedule."""
    return (n_stages - 1) / (n_microbatches + n_stages - 1)


def _stage_leaf(a: torch.Tensor, sidx: int, n_stages: int) -> torch.Tensor:
    """This stage's row of a leaf with leading dim S: a DTensor sharded
    over the stage dim gives its local (1, ...) shard, a plain tensor its
    row ``sidx``."""
    from torch.distributed.tensor import DTensor

    if isinstance(a, DTensor):
        local = a.to_local()
        if local.shape[0] != 1:
            raise ValueError(f"a stage leaf's local shard has {local.shape[0]} rows, want 1")
        return local[0]
    if a.shape[0] != n_stages:
        raise ValueError(f"a stage leaf has leading dim {a.shape[0]}, want S={n_stages}")
    return a[sidx]


@torch.no_grad()
def _run(stage_fn, params_here, xs, group, sidx, n_stages, peers):
    import torch.distributed as dist

    m = xs.shape[0]
    outs = torch.zeros_like(xs)
    pending = []
    for t in range(m + n_stages - 1):
        mb = t - sidx
        if not 0 <= mb < m:
            continue
        if sidx == 0:
            h = xs[mb]
        else:
            h = torch.empty_like(xs[0])
            for w in dist.batch_isend_irecv([dist.P2POp(dist.irecv, h, peers[sidx - 1], group)]):
                w.wait()
        h = stage_fn(params_here, h)
        if sidx < n_stages - 1:
            h = h.contiguous()
            pending += dist.batch_isend_irecv([dist.P2POp(dist.isend, h, peers[sidx + 1], group)])
        else:
            outs[mb] = h
    for w in pending:
        w.wait()
    # only the last stage holds real outputs; hand them to every rank
    # with a masked sum (x + 0 is exact)
    dist.all_reduce(outs, op=dist.ReduceOp.SUM, group=group)
    return outs


def pipeline_apply(
    stage_fn: Callable[[Any, torch.Tensor], torch.Tensor],
    stage_params: Dict[str, torch.Tensor],
    x: torch.Tensor,
    mesh,
    n_microbatches: int,
    axis: str = "stage",
) -> torch.Tensor:
    """Run ``stage_fn`` as an S-stage pipeline over microbatches.

    ``stage_fn(params_one_stage, h) -> h`` is applied by every stage in
    order and keeps ``h``'s shape; ``stage_params`` is a dict of tensors
    with leading dim S (plain, every rank taking its own row, or DTensors
    sharded over ``axis`` so that each rank holds only its stage's);
    ``x`` is the (B, ...) input, the same on every rank, and B must
    divide by ``n_microbatches``. ``mesh`` is a ``DeviceMesh`` with an
    ``axis`` dim of S ranks.

    Returns ``stage_{S-1}(... stage_0(x))`` on every rank, with the
    semantics of the sequential loop (``tests/test_torch_pipeline.py``).
    """
    import torch.distributed as dist

    if torch.is_grad_enabled() and (
        x.requires_grad or any(v.requires_grad for v in stage_params.values())
    ):
        raise NotImplementedError(
            "pipeline_apply runs forward only (its sends carry no autograd); "
            "call it under torch.no_grad() with tensors that do not require grad"
        )
    n_stages = mesh.size(mesh.mesh_dim_names.index(axis))
    group = mesh.get_group(axis)
    sidx = mesh.get_local_rank(axis)
    peers = dist.get_process_group_ranks(group)
    b = x.shape[0]
    if b % n_microbatches:
        raise ValueError(f"batch {b} does not divide into {n_microbatches} microbatches")
    xs = x.reshape(n_microbatches, b // n_microbatches, *x.shape[1:])
    params_here = {k: _stage_leaf(v, sidx, n_stages) for k, v in stage_params.items()}
    outs = _run(stage_fn, params_here, xs, group, sidx, n_stages, peers)
    return outs.reshape(b, *x.shape[1:])
