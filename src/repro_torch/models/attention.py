"""Attention variants: GQA/MHA, sliding window (SWA), MLA (DeepSeek) and
cross-attention, with the KV-cache contract that serving uses -- the JAX
package's ``models/attention.py``.

Cache contract (built by :mod:`repro_torch.serve.kvcache`):

* GQA/SWA/cross: ``{"k": (B, L, KH, Dk), "v": (B, L, KH, Dv), "idx": ()}``
  -- ``idx`` is the number of tokens already written, a 0-d int32 tensor on
  the cache's device; keys are stored *post-RoPE*. SWA caches are ring
  buffers of ``window`` slots.
* MLA: ``{"ckv": (B, L, r_kv), "krope": (B, L, Dr), "idx": ()}`` -- the
  compressed latent is cached and decode runs the absorbed-matmul path, so
  per-token memory is O(r_kv + Dr), not O(H*Dh).

The reference returns a new cache and donates the old one; here a cache is
updated in place (slots by ``index_copy_``, ``idx`` by ``add_``) and the
same dict is returned. Slots are computed on the device from ``idx``, so a
decode step reads no cache index back to the host.

Three cores compute the attention itself (``_attend``, under the layer
span ``model.attention.core`` with the path taken):

* **fused** -- the hand-written CUDA kernels of
  :mod:`repro_torch.kernels.attention` (forward and backward), which
  write no score out. Under ``impl="auto"`` it runs wherever its
  predicate takes the input: bf16 CUDA tensors, more than one query
  (training, prefill, encoders), head widths 64 or 128. It is chosen on
  each rank's own tensors, so training and prefill on the card take it,
  on a mesh too.
* **plain** -- ``_sdpa``, which writes its softmax out, as the reference
  does: CPU tensors (so every CPU parity test holds it to the reference),
  a mesh's split of a cache's head dims, fake tensors (the launch
  analysis's traces), decode (one query), MLA's 192/128 heads, f32
  models, and ``impl="plain"``.
* **chunked** -- an online softmax over KV blocks inside a loop over Q
  blocks (the reference's ``lax.scan`` inside ``lax.map``), O(S * block)
  activation memory: ``impl="chunked"``, and under ``"auto"`` what the
  fused core does not take at ``CHUNKED_THRESHOLD`` tokens or more.

None of them is ``F.scaled_dot_product_attention``.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
from torch import nn
from torch.distributed.tensor import DTensor

from ..configs.base import ArchConfig
from ..kernels import attention as fused
from ..obs.trace import layer_span
from ..sharding.dtensor import (
    local_heads,
    shard_like,
    split_dim,
    sum_grad,
    sum_partial,
    write_slots,
)
from .layers import Init, apply_rope, dense_init, mrope_rotate, pad_seq, rmsnorm, rmsnorm_init

__all__ = ["Attention", "attn_init", "attention", "NEG_INF"]

#: an additive bias, not -inf: a fully masked row stays finite, as in the
#: reference
NEG_INF = -0.7 * float(torch.finfo(torch.float32).max)

# Sequences at or above this length take the chunked path under impl="auto".
CHUNKED_THRESHOLD = 8192
Q_CHUNK = 1024
K_CHUNK = 1024


class Attention(nn.Module):
    """One attention sublayer's projections, named as the reference's keys:
    ``wq``/``wk``/``wv``/``wo``, or for MLA the low-rank ``wq_a``/``wq_b``
    and ``wkv_a``/``wkv_b`` with their norms. Cross-attention of an MLA
    model takes the plain projections, as in the reference."""

    def __init__(self, init: Init, cfg: ArchConfig, dtype, cross: bool = False):
        super().__init__()
        self.cfg = cfg
        d, h, kh, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
        a = cfg.attn
        if a.kind == "mla" and not cross:
            r_q, r_kv, dr, dv = a.q_lora_rank, a.kv_lora_rank, a.rope_head_dim, a.v_head_dim
            self.wq_a = dense_init(init, (d, r_q), dtype)
            self.q_norm = rmsnorm_init(init, r_q, dtype)
            self.wq_b = dense_init(init, (r_q, h * (dh + dr)), dtype)
            self.wkv_a = dense_init(init, (d, r_kv + dr), dtype)
            self.kv_norm = rmsnorm_init(init, r_kv, dtype)
            self.wkv_b = dense_init(init, (r_kv, h * (dh + dv)), dtype)
            self.wo = dense_init(init, (h * dv, d), dtype)
        else:
            self.wq = dense_init(init, (d, h * dh), dtype)
            self.wk = dense_init(init, (d, kh * dh), dtype)
            self.wv = dense_init(init, (d, kh * dh), dtype)
            self.wo = dense_init(init, (h * dh, d), dtype)

    def forward(self, x, *, positions, mode="causal", cache=None, kv_source=None, impl="auto"):
        return attention(self, self.cfg, x, positions=positions, mode=mode, cache=cache,
                         kv_source=kv_source, impl=impl)


def attn_init(init: Init, cfg: ArchConfig, dtype, cross: bool = False) -> Attention:
    return Attention(init, cfg, dtype, cross)


# ---------------------------------------------------------------------------
# Masked softmax-attention over explicit K/V (grouped heads)
# ---------------------------------------------------------------------------
def _mask_bias(q_pos, k_pos, mode: str, window: int) -> torch.Tensor:
    """(B, Sq, Lk) additive f32 bias. k_pos < 0 marks invalid cache slots."""
    q = q_pos[:, :, None].to(torch.int32)
    k = k_pos[:, None, :].to(torch.int32)
    ok = k >= 0
    if mode == "causal":
        ok = ok & (k <= q)
        if window:
            ok = ok & ((q - k) < window)
    zero = torch.zeros((), dtype=torch.float32, device=ok.device)
    return torch.where(ok, zero, NEG_INF)


def _sdpa(q, k, v, bias, scale, groups=()):
    """q: (B,Sq,H,Dk) k: (B,Lk,KH,Dk) v: (B,Lk,KH,Dv) bias: (B,Sq,Lk).

    ``groups``: process groups over which q and k hold slices of the head
    dims (a rank's share of a mesh's attention): the partial scores are
    summed over them, and so is the probabilities' gradient."""
    b, sq, h, dk = q.shape
    kh = k.shape[2]
    g = h // kh
    qg = split_dim(q, 2, (kh, g))
    scores = sum_partial(torch.einsum("bqkgd,blkd->bkgql", qg, k).float(), groups) * scale
    scores = scores + bias[:, None, None, :, :]
    w = sum_grad(torch.softmax(scores, dim=-1).to(v.dtype), groups)
    out = torch.einsum("bkgql,blke->bqkge", w, v)
    return out.reshape(b, sq, h, v.shape[-1])


def _sdpa_chunked(q, k, v, q_pos, k_pos, mode, window, scale):
    """Online-softmax attention; O(S*block) activation memory."""
    b, sq, h, dk = q.shape
    lk = k.shape[1]
    kh = k.shape[2]
    g = h // kh
    dv = v.shape[-1]
    q_chunks = -(-sq // Q_CHUNK)
    k_chunks = -(-lk // K_CHUNK)
    # pad to chunk multiples; pad keys are invalid slots (position -1)
    sq_p, lk_p = q_chunks * Q_CHUNK, k_chunks * K_CHUNK
    qp = pad_seq(q, sq_p - sq).reshape(b, q_chunks, Q_CHUNK, kh, g, dk)
    qpos = pad_seq(q_pos, sq_p - sq, 0).reshape(b, q_chunks, Q_CHUNK)
    kp = pad_seq(k, lk_p - lk).reshape(b, k_chunks, K_CHUNK, kh, dk)
    vp = pad_seq(v, lk_p - lk).reshape(b, k_chunks, K_CHUNK, kh, dv)
    kpos = pad_seq(k_pos, lk_p - lk, -1).reshape(b, k_chunks, K_CHUNK)

    outs = []
    for qi in range(q_chunks):
        qc, qpc = qp[:, qi], qpos[:, qi]  # (B, Qc, KH, G, Dk), (B, Qc)
        m = torch.full((b, kh, g, Q_CHUNK), NEG_INF, dtype=torch.float32, device=q.device)
        l = torch.zeros((b, kh, g, Q_CHUNK), dtype=torch.float32, device=q.device)
        acc = torch.zeros((b, kh, g, Q_CHUNK, dv), dtype=torch.float32, device=q.device)
        for ki in range(k_chunks):
            kc, vc, kpc = kp[:, ki], vp[:, ki], kpos[:, ki]
            s = torch.einsum("bqkgd,blkd->bkgql", qc, kc).float() * scale
            s = s + _mask_bias(qpc, kpc, mode, window)[:, None, None, :, :]
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bkgql,blke->bkgqe", p.to(vc.dtype), vc
            ).float()
            m = m_new
        out = acc / torch.clamp(l[..., None], min=1e-30)
        outs.append(out.movedim(3, 1))  # (B, Qc, KH, G, Dv)
    out = torch.stack(outs, dim=1).reshape(b, sq_p, h, dv)[:, :sq]
    return out.to(v.dtype)


def _core_path(q, k, v, impl: str, groups=()) -> str:
    """Which core ``_attend`` runs: ``"fused"``, ``"chunked"`` or
    ``"plain"``, from ``impl``, the inputs' types, devices and shapes, and
    whether they are a split of the head dims (``groups``)."""
    if impl == "auto" and not groups and fused.takes(q, k, v):
        return "fused"
    long_seq = max(q.shape[1], k.shape[1]) >= CHUNKED_THRESHOLD
    if impl == "chunked" or (impl == "auto" and long_seq and q.shape[1] > 1):
        return "chunked"
    return "plain"


#: the ``model.attention.core`` span's attributes, one dict per path
_CORE_ATTRS = {path: {"path": path} for path in ("fused", "chunked", "plain")}


def _attend(q, k, v, q_pos, k_pos, mode, window, impl):
    scale = 1.0 / math.sqrt(q.shape[-1])

    def core(q, k, v, q_pos, k_pos, groups):
        path = _core_path(q, k, v, impl, groups)
        with layer_span("model.attention.core", attrs=_CORE_ATTRS[path]):
            if path == "fused":
                return fused.fused_attention(q, k, v, q_pos, k_pos, mode == "causal", window,
                                             scale)
            if path == "chunked":
                return _sdpa_chunked(q, k, v, q_pos, k_pos, mode, window, scale)
            return _sdpa(q, k, v, _mask_bias(q_pos, k_pos, mode, window), scale, groups)

    # on a mesh the core runs on each rank's batch rows and its own q heads
    # (or its slice of a cache's head dims): its einsums flatten batch and
    # head dims together, which DTensor (torch 2.11) cannot do when both
    # are sharded, and GQA's kv heads may be fewer than the model ranks. The
    # core is chosen there, on the rank's own tensors, so a mesh takes the
    # fused kernels wherever it does not split the head dims
    chunked = _core_path(q, k, v, impl) == "chunked"
    return local_heads(core, q, k, v, (q_pos, k_pos), dims_ok=not chunked)


# ---------------------------------------------------------------------------
# Cache write helpers
# ---------------------------------------------------------------------------
def _write_cache(cache: Dict, updates: Dict, positions, ring: int = 0) -> Dict:
    """Write S new entries into the cache at ``idx`` (ring-buffered if SWA),
    in place, and advance ``idx`` by S.

    ``positions`` are the absolute token positions (B, S) of the updates;
    slot bookkeeping uses idx (same for all batch rows). A linear cache
    writes at ``clamp(idx, 0, L - S)``: the reference's
    ``lax.dynamic_update_slice_in_dim`` clamps its start so the update
    fits, and so does this.
    """
    idx = cache["idx"]
    s = positions.shape[1]
    for name, val in updates.items():
        buf = cache[name]
        cap = buf.shape[1]
        if ring and s >= cap:
            # keep only the last `cap` entries, ring-placed
            val = val[:, -cap:]
            slots = (idx + torch.arange(s - cap, s, device=buf.device)) % cap
        elif ring:
            slots = (idx + torch.arange(s, device=buf.device)) % cap
        else:
            if s > cap:
                raise ValueError(f"cannot write {s} entries into a cache of {cap} slots")
            slots = torch.clamp(idx, 0, cap - s) + torch.arange(s, device=buf.device)
        write_slots(buf, slots.long(), val)
    (idx.to_local() if isinstance(idx, DTensor) else idx).add_(s)
    return cache


def _cache_positions(cache: Dict, ring: int = 0) -> torch.Tensor:
    """Absolute position per cache slot, -1 for unwritten slots. (B, L)."""
    idx = cache["idx"]
    first = next(k for k in cache if k != "idx")
    b, cap = cache[first].shape[:2]
    slots = torch.arange(cap, device=idx.device)
    minus1 = torch.full((), -1, dtype=slots.dtype, device=idx.device)
    if ring:
        # slot s holds position p where p % cap == s, for the last `cap` p's
        newest = idx - 1
        pos = newest - ((newest - slots) % cap)
        pos = torch.where((pos >= 0) & (pos < idx), pos, minus1)
    else:
        pos = torch.where(slots < idx, slots, minus1)
    return pos[None, :].expand(b, cap)


# ---------------------------------------------------------------------------
# Public entry
# ---------------------------------------------------------------------------
def attention(
    params: Attention,
    cfg: ArchConfig,
    x: torch.Tensor,
    *,
    positions: torch.Tensor,
    mode: str = "causal",  # causal | bidir | cross
    cache: Optional[Dict] = None,
    kv_source: Optional[torch.Tensor] = None,  # encoder states for cross-attn
    impl: str = "auto",
) -> Tuple[torch.Tensor, Optional[Dict]]:
    """Returns (output (B,S,d), updated cache or None).

    * training/encoder: ``cache=None`` -- K/V computed inline.
    * prefill: pass a fresh cache; S tokens are written, attention runs
      against the inline K/V (cheaper than reading back).
    * decode: pass the live cache; S == 1 (or a small chunk) is appended and
      attention runs against the cache contents.
    """
    a = cfg.attn
    if a.kind == "mla" and mode != "cross":
        return _mla_attention(params, cfg, x, positions, cache, impl)

    h, kh, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    b, s, _ = x.shape
    ring = a.window if a.kind == "swa" else 0
    is_mrope = cfg.rope == "mrope"
    pos_ids = positions[:, 0] if is_mrope else positions  # (B,S) temporal ids

    q = split_dim(x @ params.wq, -1, (h, dh))

    if mode == "cross":
        if cache is not None and kv_source is None:
            k, v = cache["k"], cache["v"]  # precomputed at prefill
            k_pos = _cache_positions(cache)
            out = _attend(q, k, v, pos_ids, k_pos, "bidir", 0, impl)
            return _po(params, out), cache
        if kv_source is None:
            raise ValueError("cross-attention needs kv_source or a filled cache")
        lk = kv_source.shape[1]
        k = split_dim(kv_source @ params.wk, -1, (kh, dh))
        v = split_dim(kv_source @ params.wv, -1, (kh, dh))
        k_pos = torch.arange(lk, device=x.device)[None].expand(b, lk)
        out = _attend(q, k, v, pos_ids, k_pos, "bidir", 0, impl)
        if cache is not None:
            cache = _write_cache(cache, {"k": k, "v": v}, k_pos)
        return _po(params, out), cache

    k = split_dim(x @ params.wk, -1, (kh, dh))
    v = split_dim(x @ params.wv, -1, (kh, dh))
    if cfg.rope == "standard":
        q = apply_rope(q, pos_ids, cfg.rope_theta)
        k = apply_rope(k, pos_ids, cfg.rope_theta)
    elif is_mrope:
        q = mrope_rotate(q, positions, cfg.mrope_sections, cfg.rope_theta)
        k = mrope_rotate(k, positions, cfg.mrope_sections, cfg.rope_theta)
    # learned/sinusoidal positions are added at the embedding level

    window = a.window if a.kind == "swa" else 0
    if cache is None:
        out = _attend(q, k, v, pos_ids, pos_ids, mode, window, impl)
        return _po(params, out), None

    prefill = s > 1
    cache = _write_cache(cache, {"k": k, "v": v}, pos_ids, ring=ring)
    if prefill:
        # inline K/V already cover every valid key (ring keeps last window)
        out = _attend(q, k, v, pos_ids, pos_ids, mode, window, impl)
    else:
        k_pos = _cache_positions(cache, ring=ring)
        out = _attend(q, cache["k"], cache["v"], pos_ids, k_pos, mode, window, impl)
    return _po(params, out), cache


def _po(params, out):
    """Output projection over flattened heads. On a mesh whose ``model``
    axis the heads do not divide, the merged heads come back whole: they
    are sliced to the rows of ``wo`` each rank holds first, so the
    product is row-parallel in the backward too (taken whole, each rank
    would compute the weight's whole gradient), and their gradient is
    gathered back whole, where it splits into heads."""
    merged = out.reshape(*out.shape[:2], -1)
    return shard_like(merged, -1, params.wo, 0) @ params.wo


# ---------------------------------------------------------------------------
# MLA (DeepSeek-V3): low-rank latent KV + decoupled RoPE
# ---------------------------------------------------------------------------
def _mla_project_q(params, cfg, x, pos_ids):
    a = cfg.attn
    b, s, _ = x.shape
    h, dh, dr = cfg.n_heads, cfg.head_dim_, a.rope_head_dim
    q_lat = rmsnorm(params.q_norm, x @ params.wq_a)
    q = split_dim(q_lat @ params.wq_b, -1, (h, dh + dr))
    q_nope, q_rope = q[..., :dh], q[..., dh:]
    q_rope = apply_rope(q_rope, pos_ids, cfg.rope_theta)
    return q_nope, q_rope


def _mla_latents(params, cfg, x, pos_ids):
    a = cfg.attn
    kv = x @ params.wkv_a
    ckv, k_rope = kv[..., : a.kv_lora_rank], kv[..., a.kv_lora_rank :]
    ckv = rmsnorm(params.kv_norm, ckv)
    k_rope = apply_rope(k_rope[:, :, None, :], pos_ids, cfg.rope_theta)[:, :, 0]
    return ckv, k_rope  # (B,S,r_kv), (B,S,Dr)


def _mla_attention(params, cfg, x, positions, cache, impl):
    a = cfg.attn
    b, s, _ = x.shape
    h, dh, dr, dv = cfg.n_heads, cfg.head_dim_, a.rope_head_dim, a.v_head_dim
    r_kv = a.kv_lora_rank
    pos_ids = positions
    q_nope, q_rope = _mla_project_q(params, cfg, x, pos_ids)
    ckv, k_rope = _mla_latents(params, cfg, x, pos_ids)
    scale = 1.0 / math.sqrt(dh + dr)

    wkv_b = split_dim(params.wkv_b, -1, (h, dh + dv))
    wk_b, wv_b = wkv_b[..., :dh], wkv_b[..., dh:]

    decode = cache is not None and s == 1
    if cache is not None:
        cache = _write_cache(cache, {"ckv": ckv, "krope": k_rope}, pos_ids)

    if not decode:
        # train/prefill: expand per-position K/V (activation-sized, fine)
        k_nope = torch.einsum("blr,rhe->blhe", ckv, wk_b)
        v = torch.einsum("blr,rhe->blhe", ckv, wv_b)
        k = torch.cat([k_nope, k_rope[:, :, None, :].expand(b, s, h, dr)], dim=-1)
        q = torch.cat([q_nope, q_rope], dim=-1)
        out = _attend(q, k, v, pos_ids, pos_ids, "causal", 0, impl)
    else:
        # absorbed decode: score/context in latent space, O(L * r_kv)
        k_pos = _cache_positions(cache)
        q_lat = torch.einsum("bshe,rhe->bshr", q_nope, wk_b)  # absorb W^UK
        s_lat = torch.einsum("bshr,blr->bhsl", q_lat, cache["ckv"]).float()
        s_rope = torch.einsum("bshe,ble->bhsl", q_rope, cache["krope"]).float()
        scores = (s_lat + s_rope) * scale
        scores = scores + _mask_bias(pos_ids, k_pos, "causal", 0)[:, None, :, :]
        w = torch.softmax(scores, dim=-1).to(x.dtype)  # x's dtype, as the reference
        ctx_lat = torch.einsum("bhsl,blr->bshr", w, cache["ckv"])
        out = torch.einsum("bshr,rhe->bshe", ctx_lat, wv_b)  # expand W^UV
    return _po(params, out), cache
