"""The fused grouped-query attention of ``csrc/attention.cu``: forward and
backward kernels behind a ``torch.autograd.Function``.

:func:`takes` is the routing predicate that ``models/attention.py``'s
``_attend`` asks under ``impl="auto"``: plain CUDA tensors (not DTensors,
not fake tensors), bf16, more than one query, head widths ``Dk == Dv`` of
64 or 128, the last dim contiguous, and query heads a multiple of the kv
heads. On a mesh ``_attend`` asks it of each rank's local tensors, unless
they are a split of the head dims. Everything else keeps the plain core
(``_sdpa``, the plain version of this function: the card tests hold the
kernels to it) or the chunked one. :func:`fused_attention` raises on an
input :func:`takes` refuses.

The function is ``_sdpa``'s with ``_mask_bias``'s mask (see the source's
note): ``causal`` (with ``window``, 0 for none) or bidirectional, keys at
a position < 0 invalid, a row with no valid key the mean of V.

Launches (:data:`_build.LAUNCHES`): ``attn_fwd`` counts 2 a forward call
(the tiles' summary of positions, the forward), ``attn_bwd`` 3 a backward
call (delta, dK/dV, dQ).
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

__all__ = ["HEAD_DIMS", "TILE", "fits", "takes", "fused_attention"]

#: the head widths the library is built for
HEAD_DIMS = (64, 128)
#: rows of a query or key tile (csrc/attention.cu TILE)
TILE = 64

_PTRS = ("q", "k", "v", "o32", "dout", "out", "dq", "dk", "dv", "lse", "delta",
         "q_pos", "k_pos", "qmeta", "kmeta", "dead")
_STRIDES = ("q_b", "q_s", "q_h", "k_b", "k_s", "k_h", "v_b", "v_s", "v_h",
            "do_b", "do_s", "do_h")
_INTS = ("B", "Sq", "Lk", "H", "KH", "causal", "window")


class _Params(ctypes.Structure):
    """csrc/attention.cu's ``AttnParams``, field for field."""

    _fields_ = ([(n, ctypes.c_void_p) for n in _PTRS]
                + [(n, ctypes.c_longlong) for n in _STRIDES]
                + [(n, ctypes.c_int) for n in _INTS]
                + [("scale", ctypes.c_float)])


def fits(q_shape, k_shape, v_shape) -> bool:
    """Whether the kernels take q, k and v of these shapes: ``(B, Sq, H,
    D)``, ``(B, L, KH, D)`` and ``(B, L, KH, D)``, with Sq > 1, D in
    :data:`HEAD_DIMS` and H a multiple of KH."""
    if not len(q_shape) == len(k_shape) == len(v_shape) == 4:
        return False
    b, sq, h, d = q_shape
    return (sq > 1 and d in HEAD_DIMS and k_shape[-1] == d and tuple(v_shape) == tuple(k_shape)
            and k_shape[0] == b and h % k_shape[2] == 0)


def takes(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> bool:
    """Whether the fused kernels take this (q, k, v): plain bf16 tensors on
    one CUDA device, their last dim contiguous, of shapes that
    :func:`fits` takes. Decided from types, devices, dtypes and shapes
    alone."""
    return (q.dim() == 4 and q.shape[1] > 1  # decode's single query first: the common refusal
            and all(type(t) is torch.Tensor and t.is_cuda and t.dtype == torch.bfloat16
                    and t.dim() == 4 and t.stride(-1) == 1 for t in (q, k, v))
            and q.device == k.device == v.device and fits(q.shape, k.shape, v.shape))


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t``, or a contiguous copy where its address or strides would break
    the kernels' 16-byte copies."""
    if t.stride(-1) == 1 and t.data_ptr() % 16 == 0 and all(s % 8 == 0 for s in t.stride()[:-1]):
        return t
    return t.clone(memory_format=torch.contiguous_format)


def _launch(fn: str, p: _Params, q: torch.Tensor) -> None:
    lib = _build.library("attention")
    with torch.cuda.device(q.device):
        rc = getattr(lib, fn)(ctypes.addressof(p), q.shape[-1], _build.stream_of(q))
    _build.check(lib, rc, fn)


def _params(q, k, v, qp, kp, meta, causal, window, scale, **buffers) -> _Params:
    """The launch's arguments: q, k, v with their strides, the positions and
    their tiles' summary, and ``buffers`` (name -> tensor, or None for a
    null pointer)."""
    b, sq, h, _ = q.shape
    lk, kh = k.shape[1], k.shape[2]
    n_qt, n_kt = -(-sq // TILE), -(-lk // TILE)
    p = _Params(q=q.data_ptr(), k=k.data_ptr(), v=v.data_ptr(), q_pos=qp.data_ptr(),
                k_pos=kp.data_ptr(), qmeta=meta.data_ptr(), kmeta=meta[4 * b * n_qt:].data_ptr(),
                dead=meta[4 * b * (n_qt + n_kt):].data_ptr(), B=b, Sq=sq, Lk=lk, H=h, KH=kh,
                causal=int(causal), window=int(window), scale=scale,
                **{n: t.data_ptr() for n, t in buffers.items() if t is not None})
    p.q_b, p.q_s, p.q_h = q.stride()[:3]
    p.k_b, p.k_s, p.k_h = k.stride()[:3]
    p.v_b, p.v_s, p.v_h = v.stride()[:3]
    return p


def _forward(q, k, v, q_pos, k_pos, causal: bool, window: int, scale: float, keep: bool):
    """The forward launches; ``keep``: also the f32 output, which the
    backward reads (else None in its place)."""
    b, sq, h, d = q.shape
    lk = k.shape[1]
    dev = q.device
    qp = q_pos.to(device=dev, dtype=torch.int32).expand(b, sq).contiguous()
    kp = k_pos.to(device=dev, dtype=torch.int32).expand(b, lk).contiguous()
    n_tiles = -(-sq // TILE) + -(-lk // TILE)
    # the tiles' summary of positions: (B, query tiles, 4), (B, key tiles, 4), (B, Sq)
    meta = torch.empty(4 * b * n_tiles + b * sq, dtype=torch.int32, device=dev)
    out = torch.empty((b, sq, h, d), dtype=q.dtype, device=dev)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=dev)
    o32 = torch.empty((b, sq, h, d), dtype=torch.float32, device=dev) if keep else None
    p = _params(q, k, v, qp, kp, meta, causal, window, scale, out=out, o32=o32, lse=lse)
    _launch("repro_attn_fwd", p, q)
    _build.LAUNCHES["attn_fwd"] += 2
    return out, o32, lse, meta, qp, kp


def _backward(dout, q, k, v, o32, lse, meta, qp, kp, causal, window, scale):
    dout = _aligned(dout)
    dq, dk, dv = (torch.empty(t.shape, dtype=t.dtype, device=t.device) for t in (q, k, v))
    delta = torch.empty_like(lse)
    p = _params(q, k, v, qp, kp, meta, causal, window, scale, o32=o32, dout=dout, dq=dq, dk=dk,
                dv=dv, lse=lse, delta=delta)
    p.do_b, p.do_s, p.do_h = dout.stride()[:3]
    _launch("repro_attn_bwd", p, q)
    _build.LAUNCHES["attn_bwd"] += 3
    return dq, dk, dv


class _Fused(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, q_pos, k_pos, causal, window, scale):
        out, o32, lse, meta, qp, kp = _forward(q, k, v, q_pos, k_pos, causal, window, scale, True)
        ctx.save_for_backward(q, k, v, o32, lse, meta, qp, kp)
        ctx.args = (causal, window, scale)
        return out

    @staticmethod
    def backward(ctx, dout):
        dq, dk, dv = _backward(dout, *ctx.saved_tensors, *ctx.args)
        return dq, dk, dv, None, None, None, None, None


def fused_attention(q, k, v, q_pos, k_pos, causal: bool, window: int, scale: float):
    """Attention of q ``(B, Sq, H, D)`` over k, v ``(B, Lk, KH, D)``, query
    head h reading kv head ``h // (H / KH)``, masked by the positions
    ``q_pos`` ``(B, Sq)`` and ``k_pos`` ``(B, Lk)``; returns ``(B, Sq, H,
    D)`` in q's dtype. Raises ``ValueError`` where :func:`takes` refuses
    the input."""
    if not takes(q, k, v):
        raise ValueError(
            "fused attention takes bf16 CUDA tensors q (B, Sq > 1, H, D), k and v (B, L, KH, D), "
            f"D in {HEAD_DIMS}, H a multiple of KH, the last dim contiguous; got "
            + ", ".join(f"{type(t).__name__} {tuple(t.shape)} {t.dtype} on {t.device}"
                        for t in (q, k, v)))
    q, k, v = (_aligned(t) for t in (q, k, v))
    args = (q_pos, k_pos, bool(causal), int(window), float(scale))
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return _Fused.apply(q, k, v, *args)
    return _forward(q, k, v, *args, False)[0]
