"""Mamba-2 block (SSD -- state-space duality, arXiv:2405.21060): the JAX
package's ``models/ssm.py``.

The selective scan is computed as chunked matmuls plus one short
inter-chunk recurrence:

* intra-chunk: ``Y_diag[t] = sum_{s<=t} (C_t . B_s) * exp(cum_t - cum_s)
  * dt_s * x_s`` -- an (Q x Q) masked matmul per chunk;
* chunk states: ``S_c = sum_s exp(cum_last - cum_s) * dt_s * B_s (x) x_s``;
* inter-chunk: ``S_c = exp(sum_c) * S_{c-1} + S_c_local``, a loop over
  chunks (the reference's ``lax.scan``);
* off-diagonal: ``Y_off[t] = (C_t . S_{c-1}) * exp(cum_t)``.

Decode is the O(1) recurrent update on the carried state: the decode
"cache" of an SSM layer is a constant-size conv window plus a
``(B, H, P, N)`` state, which is why ssm/hybrid architectures run long
contexts. With a cache, :func:`ssm_apply` writes the new windows and state
into the cache's tensors in place and returns the same dict.

``ssd_reference`` is the naive per-token recurrence used as the test
oracle.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..configs.base import ArchConfig
from ..sharding.dtensor import assign, grad_in_layout, local_rows, shard_like, split_dim
from .layers import Init, dense_init, pad_seq, rmsnorm

__all__ = ["SSM", "ssm_init", "ssm_apply", "ssd_reference", "ssm_state_shapes"]


def _dims(cfg: ArchConfig):
    s = cfg.ssm
    d_inner = s.expand * cfg.d_model
    n_heads = d_inner // s.head_dim
    conv_ch = d_inner + 2 * s.n_groups * s.d_state
    return d_inner, n_heads, conv_ch


class SSM(nn.Module):
    """Projections kept as separate matrices (wz/wx/wbc/wdt, split convs),
    as in the reference, so tensor parallelism can shard the d_inner-sized
    outputs while the small B/C/dt streams stay replicated. ``dt_bias``,
    ``a_log`` and ``d_skip`` are float32 whatever the config's dtype."""

    def __init__(self, init: Init, cfg: ArchConfig, dtype):
        super().__init__()
        self.cfg = cfg
        s = cfg.ssm
        d = cfg.d_model
        d_inner, h, _ = _dims(cfg)
        bc_ch = 2 * s.n_groups * s.d_state
        f32 = torch.float32
        self.wz = dense_init(init, (d, d_inner), dtype)
        self.wx = dense_init(init, (d, d_inner), dtype)
        self.wbc = dense_init(init, (d, bc_ch), dtype)
        self.wdt = dense_init(init, (d, h), dtype)
        self.conv_x_w = dense_init(init, (s.d_conv, d_inner), dtype, scale=0.5)
        self.conv_x_b = init.param((d_inner,), dtype, lambda v: v.zero_())
        self.conv_bc_w = dense_init(init, (s.d_conv, bc_ch), dtype, scale=0.5)
        self.conv_bc_b = init.param((bc_ch,), dtype, lambda v: v.zero_())
        self.dt_bias = init.param((h,), f32, lambda v: v.zero_())
        # A in [-16, -1]
        self.a_log = init.param(
            (h,), f32, lambda v: v.copy_(torch.linspace(1.0, 16.0, h, dtype=f32).log())
        )
        self.d_skip = init.param((h,), f32, lambda v: v.fill_(1.0))
        self.norm_w = init.param((d_inner,), dtype, lambda v: v.fill_(1.0))
        self.out_proj = dense_init(init, (d_inner, d), dtype)

    def forward(self, x, cache=None):
        return ssm_apply(self, self.cfg, x, cache=cache)


def ssm_init(init: Init, cfg: ArchConfig, dtype) -> SSM:
    return SSM(init, cfg, dtype)


def ssm_state_shapes(cfg: ArchConfig, batch: int):
    """Decode-cache shapes (the SSM analogue of a KV cache)."""
    s = cfg.ssm
    d_inner, h, _ = _dims(cfg)
    return {
        "conv_x": (batch, s.d_conv - 1, d_inner),
        "conv_bc": (batch, s.d_conv - 1, 2 * s.n_groups * s.d_state),
        "ssm": (batch, h, s.head_dim, s.d_state),
    }


def _segsum(x: torch.Tensor) -> torch.Tensor:
    """exp-arg matrix: out[..., t, s] = sum_{s < r <= t} x[..., r] (t >= s),
    -inf above the diagonal so that ``exp`` gives exactly 0 there."""
    t = x.shape[-1]
    cs = torch.cumsum(x, dim=-1)
    out = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((t, t), dtype=torch.bool, device=x.device))
    return out.masked_fill(~mask, float("-inf"))


def _ssd_chunked(xdt, dta, b_mat, c_mat, chunk: int, state0):
    """Chunked SSD scan.

    xdt: (B,L,H,P) -- dt-weighted inputs; dta: (B,L,H) -- dt*A decays;
    b_mat/c_mat: (B,L,H,N) (groups already broadcast to heads);
    state0: (B,H,P,N) or None. Returns (y (B,L,H,P), state (B,H,P,N)).
    """
    bsz, l, h, p = xdt.shape
    n = b_mat.shape[-1]
    pad = (-l) % chunk
    xdt, dta, b_mat, c_mat = (pad_seq(t, pad) for t in (xdt, dta, b_mat, c_mat))
    lc = xdt.shape[1]
    nc = lc // chunk
    xdt_c = xdt.reshape(bsz, nc, chunk, h, p)
    dta_c = dta.reshape(bsz, nc, chunk, h)
    b_c = b_mat.reshape(bsz, nc, chunk, h, n)
    c_c = c_mat.reshape(bsz, nc, chunk, h, n)

    cum = torch.cumsum(dta_c, dim=2)  # (B,nc,Q,H)

    # intra-chunk (diagonal blocks)
    lmat = torch.exp(_segsum(dta_c.movedim(3, 2)))  # (B,nc,H,Q,Q)
    scores = torch.einsum("bcthn,bcshn->bchts", c_c, b_c) * lmat.to(c_c.dtype)
    y_diag = torch.einsum("bchts,bcshp->bcthp", scores, xdt_c)

    # per-chunk final states
    decay_to_end = torch.exp(cum[:, :, -1:, :] - cum)  # (B,nc,Q,H)
    states = torch.einsum(
        "bcshn,bcsh,bcshp->bchpn", b_c, decay_to_end.to(b_c.dtype), xdt_c
    )  # (B,nc,H,P,N)

    # inter-chunk recurrence
    chunk_decay = torch.exp(cum[:, :, -1, :])  # (B,nc,H)
    if state0 is None:
        state0 = xdt.new_zeros((bsz, h, p, n))
    s_prev, prevs = state0, []
    for c in range(nc):
        prevs.append(s_prev)
        s_prev = s_prev * chunk_decay[:, c, :, None, None].to(s_prev.dtype) + states[:, c]
    final = s_prev
    prev_states = torch.stack(prevs, dim=1)  # (B,nc,H,P,N) state before chunk

    # off-diagonal contribution from carried state
    in_decay = torch.exp(cum)  # (B,nc,Q,H)
    y_off = torch.einsum(
        "bcthn,bchpn->bcthp", c_c * in_decay[..., None].to(c_c.dtype), prev_states
    )

    y = (y_diag + y_off).reshape(bsz, lc, h, p)[:, :l]
    return y, final


def ssd_reference(xdt, dta, b_mat, c_mat, state0=None):
    """Naive per-token recurrence (oracle): S_t = exp(dta_t) S + B_t (x) xdt_t;
    y_t = C_t . S_t. Shapes as in :func:`_ssd_chunked`."""
    bsz, l, h, p = xdt.shape
    n = b_mat.shape[-1]
    s = xdt.new_zeros((bsz, h, p, n)) if state0 is None else state0
    ys = []
    for t in range(l):
        s = s * torch.exp(dta[:, t])[..., None, None].to(s.dtype) + torch.einsum(
            "bhp,bhn->bhpn", xdt[:, t], b_mat[:, t]
        )
        ys.append(torch.einsum("bhpn,bhn->bhp", s, c_mat[:, t]))
    return torch.stack(ys, dim=1), s


def _causal_conv(u, w, b, conv_state):
    """Depthwise causal conv as shifted multiply-adds. u: (B,S,C); w: (K,C);
    returns (y, new_state)."""
    k = w.shape[0]
    bsz, s, c = u.shape
    if conv_state is None:
        ext = torch.cat([u.new_zeros((bsz, k - 1, c)), u], dim=1)
    else:
        ext = torch.cat([conv_state.to(u.dtype), u], dim=1)
    y = sum(ext[:, i : i + s, :] * w[i][None, None, :] for i in range(k)) + b[None, None, :]
    new_state = ext[:, -(k - 1) :, :] if k > 1 else None
    return y, new_state


def ssm_apply(
    params: SSM,
    cfg: ArchConfig,
    x: torch.Tensor,
    cache: Optional[Dict] = None,
) -> Tuple[torch.Tensor, Optional[Dict]]:
    """Mamba2 block. x: (B, S, d_model) -> (y, updated cache or None).

    cache = {"conv_x": (B, K-1, d_inner), "conv_bc": (B, K-1, 2GN),
    "ssm": (B, H, P, N)} for decode/prefill, updated in place.
    """
    s_cfg = cfg.ssm
    d_inner, h, _ = _dims(cfg)
    g, n, p = s_cfg.n_groups, s_cfg.d_state, s_cfg.head_dim
    bsz, seq, _ = x.shape

    z = x @ params.wz
    xc = x @ params.wx
    bc_raw = x @ params.wbc

    conv_x_state = cache["conv_x"] if cache is not None else None
    conv_bc_state = cache["conv_bc"] if cache is not None else None
    xs, new_conv_x = _causal_conv(xc, params.conv_x_w, params.conv_x_b, conv_x_state)
    bc, new_conv_bc = _causal_conv(bc_raw, params.conv_bc_w, params.conv_bc_b, conv_bc_state)
    xs = F.silu(xs)
    bc = F.silu(bc)
    bm, cm = bc[..., : g * n], bc[..., g * n :]
    xh = split_dim(xs, -1, (h, p))

    # on a mesh each model rank projects dt for the heads it holds
    dt_raw = grad_in_layout(x @ shard_like(params.wdt, 1, xh, 2))
    dt = F.softplus(dt_raw.float() + params.dt_bias)  # (B,S,H)
    a = -torch.exp(params.a_log)  # (H,)
    dta = dt * a  # (B,S,H)

    xdt = xh * dt[..., None].to(xh.dtype)
    # broadcast groups to heads
    rep = h // g
    bmh = bm.reshape(bsz, seq, g, n).repeat_interleave(rep, dim=2)
    cmh = cm.reshape(bsz, seq, g, n).repeat_interleave(rep, dim=2)

    state0 = cache["ssm"] if cache is not None else None

    def scan(xdt, dta, bmh, cmh, state0):
        if seq == 1 and state0 is not None:
            # O(1) decode update
            st = state0 * torch.exp(dta[:, 0])[..., None, None].to(state0.dtype)
            st = st + torch.einsum("bhp,bhn->bhpn", xdt[:, 0], bmh[:, 0])
            return torch.einsum("bhpn,bhn->bhp", st, cmh[:, 0])[:, None], st
        # keep decays in f32 inside the scan; cast at the consumption points
        return _ssd_chunked(xdt, dta, bmh, cmh, s_cfg.chunk, state0)

    # on a mesh the scan runs on each rank's batch rows and its own heads:
    # cumsum's backward flips, and aten.flip has no DTensor rule in every
    # torch; nor does an einsum whose batch and head dims are both sharded
    # (torch 2.11)
    y, final = local_rows(scan, (xdt, dta, bmh, cmh, state0), (True, True),
                          heads=(2, 2, 2, 2, 1), heads_out=(2, 1))

    y = y + xh * params.d_skip[None, None, :, None].to(xh.dtype)
    y = y.reshape(bsz, seq, d_inner)
    y = rmsnorm(params.norm_w, y * F.silu(z))
    out = y @ params.out_proj

    if cache is not None:
        assign(cache["conv_x"], new_conv_x)
        assign(cache["conv_bc"], new_conv_bc)
        assign(cache["ssm"], final)
    return out, cache
