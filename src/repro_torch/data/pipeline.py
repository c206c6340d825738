"""Deterministic synthetic LM data pipeline (the JAX package's
``data/pipeline.py``).

Batches are produced deterministically from (seed, step), so a restart or a
replay after a failure re-produces identical batches with no data-loader
state to checkpoint. Tokens follow a mixed-unigram + copy-structure
distribution so the LM loss has learnable signal; modality frontends are
stubbed with deterministic pseudo-embeddings. The numpy part is the
reference's, unchanged, so a port batch equals the reference's byte for
byte. A batch lands on ``device`` (the card unless given) or, with
``mesh=``, on the mesh's device with every leaf a DTensor placed by
:func:`repro_torch.sharding.partition.batch_specs` (the batch over the
data axes), as the reference's ``mesh=`` places it.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional

import numpy as np
import torch

from .._device import resolve_device
from ..configs.base import ArchConfig, ShapeSpec

__all__ = ["DataConfig", "make_batch", "SyntheticPipeline"]


@dataclasses.dataclass(frozen=True)
class DataConfig:
    seed: int = 0
    copy_period: int = 16  # tokens repeat with this period (learnable)
    noise: float = 0.15  # fraction of positions replaced by noise


def _host_tokens(cfg: ArchConfig, shape: ShapeSpec, dcfg: DataConfig, step: int, batch: int, seq: int) -> np.ndarray:
    """(batch, seq+1) int32, deterministic in (seed, step)."""
    rng = np.random.default_rng(np.uint64(dcfg.seed * 1_000_003 + step))
    base = rng.integers(0, cfg.vocab, size=(batch, dcfg.copy_period), dtype=np.int64)
    reps = -(-(seq + 1) // dcfg.copy_period)
    toks = np.tile(base, (1, reps))[:, : seq + 1]
    noise_mask = rng.random((batch, seq + 1)) < dcfg.noise
    noise = rng.integers(0, cfg.vocab, size=(batch, seq + 1), dtype=np.int64)
    toks = np.where(noise_mask, noise, toks)
    return toks.astype(np.int32)


def host_batch(
    cfg: ArchConfig,
    shape: ShapeSpec,
    dcfg: DataConfig,
    step: int,
    batch_override: Optional[int] = None,
    seq_override: Optional[int] = None,
) -> Dict[str, np.ndarray]:
    """One global training batch as numpy arrays: tokens, labels (+frontend
    embeddings) -- the reference's ``make_batch`` before its device put."""
    b = batch_override or shape.global_batch
    s = seq_override or shape.seq_len
    toks = _host_tokens(cfg, shape, dcfg, step, b, s)
    batch: Dict[str, np.ndarray] = {
        "tokens": toks[:, :-1],
        "labels": toks[:, 1:].copy(),
    }
    if cfg.frontend == "vision":
        rng = np.random.default_rng(np.uint64(dcfg.seed * 7 + step))
        nf = cfg.n_frontend_tokens
        batch["frontend"] = (
            rng.standard_normal((b, nf, cfg.d_model)).astype(np.float32) * 0.02
        )
        # the model prepends Nf vision slots; logits at slot i predict
        # sequence position i+1-Nf, so pad labels on the left with ignore
        batch["labels"] = np.concatenate(
            [np.full((b, nf), -1, np.int32), batch["labels"]], axis=1
        )
    elif cfg.enc_dec:
        rng = np.random.default_rng(np.uint64(dcfg.seed * 13 + step))
        batch["frontend"] = (
            rng.standard_normal((b, cfg.n_frontend_tokens, cfg.d_model)).astype(
                np.float32
            )
            * 0.02
        )
    return batch


def make_batch(
    cfg: ArchConfig,
    shape: ShapeSpec,
    dcfg: DataConfig,
    step: int,
    device=None,
    batch_override: Optional[int] = None,
    seq_override: Optional[int] = None,
    mesh=None,
) -> Dict[str, torch.Tensor]:
    """One global training batch on ``device`` (the card unless given):
    int32 tokens and labels, f32 frontend embeddings. With ``mesh`` (a
    ``DeviceMesh``) each leaf is a DTensor on it, placed by
    ``batch_specs``; every rank builds the same global batch and keeps its
    shard."""
    batch = host_batch(cfg, shape, dcfg, step, batch_override, seq_override)
    if mesh is not None:
        from ..sharding.dtensor import distribute_batch, mesh_device

        device = mesh_device(mesh)
    else:
        device = resolve_device(device)
    out = {k: torch.from_numpy(np.ascontiguousarray(v)).to(device) for k, v in batch.items()}
    return distribute_batch(cfg, out, mesh) if mesh is not None else out


class SyntheticPipeline:
    """Iterator facade used by the trainer; stateless w.r.t. restarts."""

    def __init__(
        self,
        cfg: ArchConfig,
        shape: ShapeSpec,
        dcfg: DataConfig = DataConfig(),
        device=None,
        start_step: int = 0,
        batch_override: Optional[int] = None,
        seq_override: Optional[int] = None,
        mesh=None,
    ):
        self.cfg, self.shape, self.dcfg, self.mesh = cfg, shape, dcfg, mesh
        self.device = None if mesh is not None else resolve_device(device)
        self.step = start_step
        self.batch_override = batch_override
        self.seq_override = seq_override

    def __iter__(self) -> Iterator[Dict[str, torch.Tensor]]:
        return self

    def __next__(self) -> Dict[str, torch.Tensor]:
        b = make_batch(
            self.cfg, self.shape, self.dcfg, self.step, self.device,
            self.batch_override, self.seq_override, mesh=self.mesh,
        )
        self.step += 1
        return b
