"""Mixture-of-experts layer: top-k routing, capacity-bounded dispatch,
optional shared experts (DeepSeek), load-balancing aux loss -- the JAX
package's ``models/moe.py``.

Parameters: the router, the routed experts as one stack of ``n_experts``
MLPs (each matrix ``(E, d_in, d_out)``, the layout a grouped matmul reads),
and the always-on shared experts.

Dispatch is gather/scatter-based: tokens are expanded k-fold, ranked
within their expert by a cumulative count, and scattered into a dense
``(E, C, d)`` buffer (rank >= capacity is dropped). Routing is grouped by
batch row (G = B groups of S tokens); decode steps (S == 1) route the
whole batch as one group so per-expert capacity never rounds down to
nothing. The groups run as one batched computation here (the reference
``vmap``s them).

Two orders are made explicit where torch promises none. Top-k takes the
lower expert index on a tie, as ``jax.lax.top_k`` does (a stable
descending sort). The combine adds each token's ``k`` expert outputs in
slot order, as a loop over ``k`` -- not a float ``index_add_``, whose
order on the card is that of its atomics -- so it is deterministic. The
dispatch scatter-add is deterministic as it stands: kept tokens land on
unique slots and dropped ones add zeros.
"""

from __future__ import annotations

from types import SimpleNamespace
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..configs.base import ArchConfig
from ..sharding.dtensor import fsdp_gather, gather_slots, local_rows
from .layers import Init, dense_init, mlp, mlp_init

__all__ = ["MoE", "moe_init", "moe_apply"]


class MoE(nn.Module):
    def __init__(self, init: Init, cfg: ArchConfig, dtype):
        super().__init__()
        self.cfg = cfg
        m = cfg.moe
        d = cfg.d_model
        self.router = dense_init(init, (d, m.n_experts), dtype, scale=0.02)
        self.experts = mlp_init(init, d, m.d_ff, cfg.act, dtype, n=m.n_experts)
        if m.n_shared:
            self.shared = mlp_init(init, d, m.d_ff * m.n_shared, cfg.act, dtype)

    def forward(self, x):
        return moe_apply(self, self.cfg, x)


def moe_init(init: Init, cfg: ArchConfig, dtype) -> MoE:
    return MoE(init, cfg, dtype)


def top_k(probs: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The ``k`` largest values along the last axis, descending, and their
    indices; on a tie the lower index comes first (``jax.lax.top_k``'s
    order)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _dispatch_group(cfg: ArchConfig, xg, gates, idx, cap: int):
    """All routing groups at once. xg: (G, Tg, d); gates/idx: (G, Tg, k).

    Returns (buf (G, E, cap, d), slot, keep, flat_t, flat_g), the last four
    (G, Tg*k) but ``flat_t`` (Tg*k,).
    """
    m = cfg.moe
    g, tg, d = xg.shape
    e, k = m.n_experts, m.top_k
    flat_e = idx.reshape(g, tg * k)
    flat_g = gates.reshape(g, tg * k)
    flat_t = torch.arange(tg, device=xg.device).repeat_interleave(k)
    # rank of each expanded token within its expert (order = token order)
    onehot = F.one_hot(flat_e, e).to(torch.int32)  # (G, Tg*k, E)
    prior = torch.cumsum(onehot, dim=1) - onehot  # same-expert tokens before
    rank = torch.gather(prior, 2, flat_e[..., None])[..., 0]
    keep = rank < cap
    slot = flat_e * cap + torch.where(keep, rank, 0)
    src = torch.where(keep[..., None], xg[:, flat_t], 0)
    buf = torch.zeros((g, e * cap, d), dtype=xg.dtype, device=xg.device)
    buf.scatter_add_(1, slot[..., None].expand(g, tg * k, d), src)
    return buf.reshape(g, e, cap, d), slot, keep, flat_t, flat_g


def _combine_group(expert_out_flat, slot, keep, flat_g, tg, k):
    """expert_out_flat (G, E*cap, d) -> (G, Tg, d): each token's ``k``
    gated outputs summed in slot order."""
    g, _, d = expert_out_flat.shape
    w = torch.where(keep, flat_g, 0.0).to(expert_out_flat.dtype)
    gathered = torch.gather(expert_out_flat, 1, slot[..., None].expand(g, tg * k, d))
    gathered = (gathered * w[..., None]).reshape(g, tg, k, d)
    y = gathered[:, :, 0]
    for j in range(1, k):
        y = y + gathered[:, :, j]
    return y


def moe_apply(params: MoE, cfg: ArchConfig, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d) -> (y (B, S, d), aux_loss scalar f32)."""
    m = cfg.moe
    b, s, d = x.shape
    e, k = m.n_experts, m.top_k
    # group by batch row; decode: one group
    g, tg = (b, s) if s > 1 else (1, b)
    xg = x.reshape(g, tg, d)

    logits = (xg @ params.router).float()
    probs = torch.softmax(logits, dim=-1)
    gates, idx = top_k(probs, k)
    gates = gates / torch.clamp(gates.sum(dim=-1, keepdim=True), min=1e-9)

    # load-balancing aux loss (Switch-style): E * <f_e> . <p_e>
    me = probs.mean(dim=(0, 1))
    # one-hot by comparison: F.one_hot's value check has no DTensor rule
    fe = (idx[..., 0, None] == torch.arange(e, device=idx.device)).float().mean(dim=(0, 1))
    aux = e * torch.sum(fe * me) * m.router_aux_weight

    cap = int(max(1, round(tg * k / e * m.capacity_factor)))  # Python's (banker's) round

    # scatter_add_/gather/cumsum over token slots have no DTensor rules:
    # on a mesh the dispatch and the combine run on each rank's groups
    buf, slot, keep, _flat_t, flat_g = local_rows(
        lambda *a: _dispatch_group(cfg, *a, cap), (xg, gates, idx),
        (True, True, True, False, True))
    # buf: (G, E, cap, d) -> experts see all groups' slices: (E, G*cap, d)
    ein = buf.transpose(0, 1).reshape(e, g * cap, d)
    # on a mesh the experts' FSDP shards are gathered where the tokens are
    # sharded over the data axes, so they stay sharded there
    experts = SimpleNamespace(**{n: fsdp_gather(getattr(params.experts, n), ein)
                                 for n in ("up", "gate", "down") if hasattr(params.experts, n)})
    eout = mlp(experts, ein, cfg.act)
    eout = eout.reshape(e, g, cap, d).transpose(0, 1).reshape(g, e * cap, d)

    # with the experts over ``model`` each rank combines from its own slots
    y = gather_slots(lambda *a: _combine_group(*a, tg, k), eout, slot, keep, flat_g)

    if m.n_shared:
        y = y + mlp(params.shared, xg, cfg.act)
    return y.reshape(b, s, d), aux
