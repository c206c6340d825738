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

The schedule differentiates. Each stage-to-stage transfer is an
autograd function whose gradient travels the other way: a stage's send
receives its output's gradient from stage s + 1 in the backward, and its
receive sends its input's gradient to stage s - 1. The autograd engine
runs each rank's nodes from the last microbatch to the first, so every
rank receives the gradients in the order its neighbour sends them; the
backward sends are non-blocking and each rank waits for them once its
first microbatch's gradient has gone out. The masked sum that hands the
outputs to every rank is the identity in the backward (every rank holds
the same outputs, and a loss on them is the same on every rank). A leaf
that every rank holds whole (a plain stacked tensor, or ``x``) has its
gradient summed over the stage group, so each rank gets the whole
gradient, as from the sequential loop; a DTensor leaf sharded over the
stage dim gets its gradient in its own shards.
"""

from __future__ import annotations

from typing import Any, Callable, Dict

import torch

__all__ = ["pipeline_apply", "bubble_fraction"]


def bubble_fraction(n_stages: int, n_microbatches: int) -> float:
    """Idle fraction of the fill-drain schedule."""
    return (n_stages - 1) / (n_microbatches + n_stages - 1)


def _stage_leaf(a: torch.Tensor, sidx: int, n_stages: int, group) -> torch.Tensor:
    """This stage's row of a leaf with leading dim S: a DTensor sharded
    over the stage dim gives its local (1, ...) shard, a plain tensor its
    row ``sidx`` (whose gradient is summed over ``group``: every rank
    holds the whole leaf)."""
    from torch.distributed.tensor import DTensor

    if isinstance(a, DTensor):
        local = a.to_local()
        if local.shape[0] != 1:
            raise ValueError(f"a stage leaf's local shard has {local.shape[0]} rows, want 1")
        return local[0]
    if a.shape[0] != n_stages:
        raise ValueError(f"a stage leaf has leading dim {a.shape[0]}, want S={n_stages}")
    return _Whole.apply(a, group)[sidx]


class _Whole(torch.autograd.Function):
    """The identity on a tensor that every rank of ``group`` holds whole;
    its gradient is summed over the group, since each rank's part of the
    schedule reaches only its own slice of it."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        import torch.distributed as dist

        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class _Link:
    """One rank's point-to-point traffic of a schedule: its stage group,
    its neighbours and the sends still in flight."""

    def __init__(self, group, peers, sidx):
        self.group, self.peers, self.sidx = group, peers, sidx
        self.pending = []  # (work, buffer): a buffer lives until its send completes

    def send(self, t: torch.Tensor, to: int) -> None:
        import torch.distributed as dist

        t = t.contiguous()
        works = dist.batch_isend_irecv([dist.P2POp(dist.isend, t, self.peers[to], self.group)])
        self.pending += [(w, t) for w in works]

    def recv(self, like: torch.Tensor, frm: int) -> torch.Tensor:
        """A tensor of ``like``'s shape, dtype and device from stage ``frm``."""
        import torch.distributed as dist

        t = torch.empty(like.shape, dtype=like.dtype, device=like.device)
        for w in dist.batch_isend_irecv([dist.P2POp(dist.irecv, t, self.peers[frm], self.group)]):
            w.wait()
        return t

    def drain(self) -> None:
        for w, _ in self.pending:
            w.wait()
        self.pending = []


class _Send(torch.autograd.Function):
    """Sends ``h`` to stage s + 1 and returns a 0-d zero that ties the send
    into the outputs; the backward receives ``h``'s gradient from s + 1."""

    @staticmethod
    def forward(ctx, h, link):
        ctx.link, ctx.like = link, h.new_empty(()).expand(h.shape)  # the shape, one element
        link.send(h, link.sidx + 1)
        return h.new_zeros(())

    @staticmethod
    def backward(ctx, _):
        return ctx.link.recv(ctx.like, ctx.link.sidx + 1), None


class _Recv(torch.autograd.Function):
    """Receives a stage input like ``like`` from stage s - 1; the backward
    sends its gradient back to s - 1, without blocking, and after
    microbatch 0 (the last one the backward reaches) waits for every send
    of the schedule. ``leaves`` (the tensors this rank's gradients are
    asked for) only put the node on the graph's paths to them, so that
    ``torch.autograd.grad`` runs it; they get no gradient from it."""

    @staticmethod
    def forward(ctx, like, link, mb, *leaves):
        ctx.link, ctx.mb, ctx.n = link, mb, len(leaves)
        return link.recv(like, link.sidx - 1)

    @staticmethod
    def backward(ctx, grad):
        ctx.link.send(grad, ctx.link.sidx - 1)
        if ctx.mb == 0:
            ctx.link.drain()
        return (None,) * (3 + ctx.n)


def _run(stage_fn, params_here, x, xs, link, n_stages, needs_grad):
    from ..sharding.dtensor import _SumOver

    sidx, m = link.sidx, xs.shape[0]
    leaves = [t for t in (x, *params_here.values()) if needs_grad and t.requires_grad]
    outs, ties = [], xs.new_zeros(())
    for t in range(m + n_stages - 1):
        mb = t - sidx
        if not 0 <= mb < m:
            continue
        h = xs[mb] if sidx == 0 else _Recv.apply(xs[0].detach(), link, mb, *leaves)
        h = stage_fn(params_here, h)
        if sidx < n_stages - 1:
            ties = ties + _Send.apply(h, link)
        else:
            outs.append(h)
    link.drain()
    out = torch.stack(outs) if outs else torch.zeros_like(xs)
    # only the last stage holds real outputs; hand them to every rank
    # with a masked sum (x + 0 is exact)
    return _SumOver.apply(out + ties, [link.group])


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
    semantics of the sequential loop, its gradients included
    (``tests/test_torch_pipeline.py``).
    """
    import torch.distributed as dist

    n_stages = mesh.size(mesh.mesh_dim_names.index(axis))
    group = mesh.get_group(axis)
    link = _Link(group, dist.get_process_group_ranks(group), mesh.get_local_rank(axis))
    b = x.shape[0]
    if b % n_microbatches:
        raise ValueError(f"batch {b} does not divide into {n_microbatches} microbatches")
    needs_grad = torch.is_grad_enabled() and (
        x.requires_grad or any(v.requires_grad for v in stage_params.values()))
    # the gradient nodes of the whole leaves, made in one order on every
    # rank, so that the backward reduces them in one order
    xw = _Whole.apply(x, group) if needs_grad and x.requires_grad else x
    xs = xw.reshape(n_microbatches, b // n_microbatches, *x.shape[1:])
    params_here = {k: _stage_leaf(v, link.sidx, n_stages, group)
                   for k, v in stage_params.items()}
    outs = _run(stage_fn, params_here, xw, xs, link, n_stages, needs_grad)
    return outs.reshape(b, *x.shape[1:])
