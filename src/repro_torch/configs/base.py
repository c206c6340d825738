"""Architecture configuration system.

The JAX package's ``configs/base.py``, kept as this package's own copy
(pure Python): the port's registry is its own dict, so both registries
live side by side in one process.

Every assigned architecture is a frozen :class:`ArchConfig`; the registry
maps ``--arch <id>`` names to configs. ``cfg.reduced()`` produces the
small-but-same-family variant used by CPU smoke tests (the FULL configs are
sized on the meta device, without allocating).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

__all__ = [
    "AttnConfig",
    "MoEConfig",
    "SSMConfig",
    "ArchConfig",
    "ARCHS",
    "register",
    "get_arch",
    "get",
    "list_archs",
    "SHAPES",
    "ShapeSpec",
]


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    """Mixture-of-experts sublayer parameters.

    ``n_experts`` routed experts, of which ``top_k`` are active per token;
    each expert is an MLP with hidden width ``d_ff`` (units: model
    dimensions, not bytes). ``capacity_factor`` scales per-expert token
    buffers relative to a perfectly balanced router (dimensionless ratio);
    ``router_aux_weight`` is the load-balancing auxiliary-loss coefficient.
    """

    n_experts: int
    top_k: int
    d_ff: int  # per-expert hidden size
    n_shared: int = 0  # always-on shared experts (DeepSeek)
    every: int = 1  # MoE replaces the MLP every N layers (Jamba: 2)
    first_dense: int = 0  # leading dense layers (DeepSeek-V3: 3)
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    """State-space (Mamba-2 / SSD) mixer parameters.

    ``d_state`` is the per-head recurrent state width, ``d_conv`` the depth
    of the causal conv preceding the SSM, ``expand`` the inner-width
    multiplier over ``d_model``, and ``chunk`` the SSD scan chunk length in
    tokens.
    """

    d_state: int = 128
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    n_groups: int = 1
    chunk: int = 128  # SSD chunk length


@dataclasses.dataclass(frozen=True)
class AttnConfig:
    """Attention variant. ``kind`` selects full softmax attention, sliding
    window (``swa``, window size in tokens), or DeepSeek's multi-head latent
    attention (``mla``) whose low-rank dims are per-head widths."""

    kind: str = "full"  # full | swa | mla
    window: int = 0  # SWA window
    # MLA (DeepSeek): low-rank Q/KV compression + decoupled RoPE dims
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    rope_head_dim: int = 0
    v_head_dim: int = 0


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    """One published model architecture, frozen.

    Field units: ``n_layers``/``n_enc_layers`` count transformer (or SSM)
    blocks; ``d_model``/``d_ff``/``head_dim`` are activation widths in model
    dimensions (elements, not bytes — multiply by the ``dtype`` width for
    bytes); ``n_heads``/``n_kv_heads`` count query/KV heads (GQA when
    ``n_kv_heads < n_heads``); ``vocab`` is the embedding-table row count;
    ``rope_theta`` is the rotary base frequency (dimensionless). ``dtype``
    names the parameter/activation storage dtype and is what converts
    element counts into HBM bytes in the roofline model.
    """

    name: str
    family: str  # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0  # 0 -> d_model // n_heads
    act: str = "silu"  # silu | geglu | relu2
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    attn: AttnConfig = AttnConfig()
    rope: str = "standard"  # standard | mrope | learned | sinusoidal
    rope_theta: float = 10000.0
    mrope_sections: Tuple[int, ...] = ()
    enc_dec: bool = False
    n_enc_layers: int = 0
    frontend: Optional[str] = None  # audio | vision (STUB: embeddings given)
    n_frontend_tokens: int = 0  # stub frame/patch count fed by input_specs
    layer_pattern: str = "uniform"  # uniform | jamba
    attn_every: int = 0  # jamba: attention layer each N (offset period//2)
    tie_embeddings: bool = False
    mtp: bool = False  # DeepSeek multi-token-prediction head
    rms_offset: float = 0.0  # gemma: rmsnorm scale = (1 + w)
    emb_scale: bool = False  # gemma: embeddings * sqrt(d_model)
    dtype: str = "bfloat16"
    source: str = ""  # provenance note [arXiv id; verification tier]

    # ------------------------------------------------------------------
    @property
    def head_dim_(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    def layer_kinds(self) -> Tuple[Tuple[str, str], ...]:
        """(mixer, ffn) kind per layer index.

        mixer: 'attn' | 'ssm' | (encoder handled separately)
        ffn:   'mlp' | 'moe'
        """
        kinds = []
        for i in range(self.n_layers):
            if self.layer_pattern == "jamba":
                mixer = "attn" if (i % self.attn_every) == self.attn_every // 2 else "ssm"
            elif self.family == "ssm":
                mixer = "ssm"
            else:
                mixer = "attn"
            if self.moe is None:
                ffn = "mlp" if self.d_ff else "none"  # pure-SSM blocks
            elif i < self.moe.first_dense:
                ffn = "mlp"
            elif (i % self.moe.every) == (self.moe.every - 1):
                ffn = "moe"
            else:
                ffn = "mlp"
            kinds.append((mixer, ffn))
        return tuple(kinds)

    def reduced(self) -> "ArchConfig":
        """Same-family tiny variant for CPU smoke tests."""
        moe = (
            dataclasses.replace(
                self.moe,
                n_experts=min(self.moe.n_experts, 4),
                top_k=min(self.moe.top_k, 2),
                d_ff=64,
                first_dense=min(self.moe.first_dense, 1),
                capacity_factor=4.0,
            )
            if self.moe
            else None
        )
        ssm = (
            dataclasses.replace(self.ssm, d_state=16, head_dim=8, chunk=16)
            if self.ssm
            else None
        )
        attn = self.attn
        if attn.kind == "mla":
            attn = dataclasses.replace(
                attn, q_lora_rank=32, kv_lora_rank=16, rope_head_dim=8, v_head_dim=16
            )
        if attn.kind == "swa":
            attn = dataclasses.replace(attn, window=16)
        n_layers = {
            "uniform": 4 if self.moe is None else 5,
            "jamba": 2 * self.attn_every if self.attn_every else 4,
        }[self.layer_pattern]
        return dataclasses.replace(
            self,
            name=self.name + "-reduced",
            n_layers=n_layers,
            n_enc_layers=min(self.n_enc_layers, 2),
            d_model=64,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 2) if self.n_kv_heads < self.n_heads else 4,
            head_dim=16,
            d_ff=128 if self.d_ff else 0,
            vocab=256,
            moe=moe,
            ssm=ssm,
            attn=attn,
            n_frontend_tokens=8 if self.frontend else 0,
            mrope_sections=(4, 2, 2) if self.rope == "mrope" else (),
            dtype="float32",
        )


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------
ARCHS: Dict[str, ArchConfig] = {}


def register(cfg: ArchConfig) -> ArchConfig:
    """Add ``cfg`` to the registry; raises ``ValueError`` on a duplicate name."""
    if cfg.name in ARCHS:
        raise ValueError(f"duplicate arch {cfg.name}")
    ARCHS[cfg.name] = cfg
    return cfg


def get_arch(name: str) -> ArchConfig:
    """Look up a registered architecture by ``--arch`` name.

    Triggers discovery of every config module on first use, so callers never
    see a partially populated registry.
    """
    from . import _register_all  # noqa: F401  (side-effect registration)

    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCHS)}")
    return ARCHS[name]


def list_archs() -> Tuple[str, ...]:
    """All registered architecture names, sorted (deterministic across runs)."""
    from . import _register_all  # noqa: F401  (side-effect registration)

    return tuple(sorted(ARCHS))


#: Short alias — ``repro_torch.configs.get(name)``.
get = get_arch


# ---------------------------------------------------------------------------
# Assigned input shapes (harness table). decode_*/long_* lower serve_step.
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    """One workload shape: ``seq_len`` tokens of context per sequence and
    ``global_batch`` concurrent sequences across the whole mesh. ``kind``
    selects the cost model — ``train`` (fwd+bwd over all tokens),
    ``prefill`` (fwd over all tokens), or ``decode`` (one new token per
    sequence per step against a ``seq_len``-deep KV cache)."""

    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode

    @property
    def tokens(self) -> int:
        """Tokens processed per step (for decode this is tokens *resident*,
        not tokens generated — decode emits ``global_batch`` per step)."""
        return self.seq_len * self.global_batch


SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}
