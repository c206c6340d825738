"""Portfolio codesign: K design points + a traffic assignment (fleet eq. 18).

Eq. 18 picks ONE hardware point for a workload mix; a fleet runs a *mix*
of designs and routes each workload cell to the design that serves it
best (portfolio codesign with heterogeneity-aware routing; the
charm-style heterogeneous codesign direction). Given the swept
``(C, H)`` cell-time matrix, a traffic distribution over cells, and a
fleet budget (total silicon area, or total chips for LM cells), choose
**up to K design points** plus an assignment of every cell's traffic to
a chosen design, maximizing either

* ``objective="throughput"`` -- fleet GFLOP/s subject to total area <=
  budget (``k=1`` is then *exactly* ``CodesignResult.best(max_area=budget)``,
  same arithmetic, same argmax tie-break); or
* ``objective="density"``    -- fleet GFLOP/s per unit total area under
  the same budget (the default).

Structure of the optimum, used by both engines:

* Given a chosen set S, the fleet weighted time is linear in the
  assignment matrix, so the inner assignment problem is solved at a
  vertex: each cell one-hot routes ALL of its traffic to its fastest
  design in S (cells are separable given S -- the "greedy-optimal"
  inner step). The outer problem is therefore a subset search.
* Singletons are enumerated over the FULL hardware space in ascending
  index order (bit-reproducing ``best()``'s first-max argmax); subsets of
  size >= 2 only over the dominance-surviving candidate set
  (:func:`portfolio_candidates`), which is lossless for the optimal
  value: replacing a dominated member with its dominator never worsens
  time on any cell and never grows the area sum.
* "Up to K": sizes 1..K are all enumerated with a strict ``>`` running
  max, so the reported fleet objective is monotone in K and always >=
  the best single design, and ties resolve to the
  first-in-enumeration-order (smallest, then lexicographically lowest)
  subset -- deterministic because :mod:`repro_torch.core.pareto`'s masks and
  the dominance filter here break every tie toward the lowest index.

The candidate filter must be FULL-VECTOR dominance (area plus the whole
per-cell time column), not a union of per-cell 2-D Pareto fronts: a
"generalist" design dominated on every individual cell by some
specialist can still be the unique optimum when the budget fits only
one chip (e.g. cells {1,2}, A=(area 1, t=(1,100)), B=(area 1,
t=(100,1)), M=(area 1.5, t=(2,2)), budget 1.5, even mix: {M} wins).

Two equivalence-tested engines: an exact float64 NumPy oracle
(explicit loop over subsets -- the trust anchor) and a ``"torch"`` engine
scoring every subset in one fused gather/min/matvec reduction on a torch
device (float64, tie-aware equivalent: its sums may round in another
order than numpy's, so the engines can differ only in which of two
subsets tied to the last bits they name; the winning subset's reported
numbers are always recomputed through the float64 path).

The port, against the JAX package's module:

* the jitted JAX scorer becomes the ``"torch"`` engine, and it is the
  default: the entry points score on the card unless ``device="cpu"``
  (they raise without a card, never falling back to the CPU), and the
  numpy oracle runs only when ``engine="numpy"`` is asked for. ``"jax"``
  is not an engine name here and is rejected like any other unknown name;
* the torch engine scores in float64, where the JAX scorer used float32:
  31k subsets x 96 cells is small work for the card, and float32 named
  the singleton (5023,) where the oracle names (0, 5023) on the titanx
  sweep at full width;
* the torch engine also runs the dominance filter on its device, through
  the same chunked passes as numpy (:func:`_dominance_passes`, written
  once for both array types): every comparison is exact, so its mask
  equals the numpy mask bit for bit (``tests/test_torch_portfolio.py``).
  No hand-written kernel is involved: the JAX package computes this
  outside any Pallas kernel, so torch ops do it here.
"""

from __future__ import annotations

import itertools
import math
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np

__all__ = [
    "ENGINES",
    "OBJECTIVES",
    "PortfolioResult",
    "optimize_portfolio",
    "optimize_portfolio_arrays",
    "portfolio_candidates",
]

OBJECTIVES = ("density", "throughput")
ENGINES = ("numpy", "torch")

# subsets are scored in one vectorized pass; past this many the fused
# (C, M, K) gather stops fitting comfortably in memory -- downsample the
# hardware space (the CLI's --downsample) instead of brute-forcing it
_MAX_SUBSETS_DEFAULT = 200_000


def portfolio_candidates(
    area: np.ndarray, cell_time: np.ndarray, chunk: int = 512, device=None
) -> np.ndarray:
    """Boolean mask of designs that can appear in some optimal portfolio.

    A design ``h`` is dominated iff some ``h'`` has ``area[h'] <= area[h]``
    and ``cell_time[:, h'] <= cell_time[:, h]`` componentwise, strictly on
    at least one axis; exact duplicates keep the lowest index (the same
    tie contract as :mod:`repro_torch.core.pareto`). O(H^2 * C) in chunked
    vectorized passes -- meant for the downsampled spaces portfolios are
    built from, not the full million-point lattice.

    ``device=None`` runs the passes in numpy; a torch device runs the same
    passes there in float64 and returns the identical mask.
    """
    area = np.asarray(area, np.float64).ravel()
    t = np.asarray(cell_time, np.float64)
    if t.ndim != 2 or t.shape[1] != area.shape[0]:
        raise ValueError("cell_time must be (C, H) matching area (H,)")
    t = np.where(np.isnan(t), np.inf, t)  # infeasible cells compare as inf
    n_hw = area.shape[0]
    if device is None:
        return _dominance_passes(area, t, np.arange(n_hw), np.zeros(n_hw, bool), chunk)
    import torch

    dev = torch.device(device)
    keep = _dominance_passes(
        torch.as_tensor(area, device=dev),
        torch.as_tensor(t, device=dev),
        torch.arange(n_hw, device=dev),
        torch.zeros(n_hw, dtype=torch.bool, device=dev),
        chunk,
    )
    return keep.cpu().numpy()


def _dominance_passes(area, t, idx, dominated, chunk: int):
    """The chunked dominance passes of :func:`portfolio_candidates`, for
    numpy arrays or torch tensors alike (``dominated`` is updated in place;
    returns the survivors' mask)."""
    n_cells, n_hw = t.shape
    for s in range(0, n_hw, chunk):
        e = min(s + chunk, n_hw)
        a_d = area[s:e, None]
        all_le = a_d <= area[None, :]
        any_lt = a_d < area[None, :]
        for c in range(n_cells):
            t_d = t[c, s:e, None]
            all_le &= t_d <= t[c][None, :]
            any_lt |= t_d < t[c][None, :]
        strict = all_le & any_lt
        duplicate = all_le & ~any_lt  # equal on every axis (includes self)
        dom = strict | (duplicate & (idx[s:e, None] < idx[None, :]))
        dominated |= dom.any(0)
    return ~dominated


@dataclass(frozen=True)
class PortfolioResult:
    """A chosen fleet: up to K designs plus the per-cell traffic routing."""

    k: int  # requested K (len(members) may be smaller: "up to K")
    objective: str
    budget: float
    members: Tuple[int, ...]  # chosen hw indices, ascending
    assignment: np.ndarray  # (C, len(members)) one-hot rows, rows sum to 1
    preference: np.ndarray  # (C, len(members)) member slots, fastest first
    freqs: np.ndarray  # (C,) traffic distribution actually used
    weighted_time: float  # fleet eq.-17 objective at the optimum
    fleet_gflops: float
    total_area: float
    fleet_density: float  # fleet_gflops / total_area
    candidates: Tuple[int, ...]  # dominance survivors (audit trail)
    engine: str  # "numpy" | "torch"

    def assigned_member(self, cell_index: int) -> int:
        """The hw index serving all of ``cell_index``'s traffic."""
        return self.members[int(np.argmax(self.assignment[cell_index]))]

    def payload(self) -> Dict[str, object]:
        """Canonical-JSON-able body for a ``kind: "portfolio"`` manifest.

        Pure python scalars/lists (json round-trips float64 losslessly),
        key order irrelevant -- the store canonicalizes with sorted keys,
        so identical optimizations produce identical bytes and content
        keys regardless of engine or writer.
        """
        return {
            "k": int(self.k),
            "objective": self.objective,
            "budget": float(self.budget),
            "members": [int(m) for m in self.members],
            "assignment": [[float(x) for x in row] for row in self.assignment],
            "preference": [[int(x) for x in row] for row in self.preference],
            "freqs": [float(x) for x in self.freqs],
            "weighted_time": float(self.weighted_time),
            "fleet_gflops": float(self.fleet_gflops),
            "total_area": float(self.total_area),
            "fleet_density": float(self.fleet_density),
            "candidates": [int(c) for c in self.candidates],
            "engine": self.engine,
        }


def _finalize_subset(
    members: Tuple[int, ...],
    area: np.ndarray,
    times: np.ndarray,
    freqs: np.ndarray,
    numer: float,
    *,
    k: int,
    objective: str,
    budget: float,
    candidates: Tuple[int, ...],
    engine: str,
) -> PortfolioResult:
    """Exact float64 report for a chosen subset (shared by both engines)."""
    sub = times[:, members]  # (C, K')
    slot = np.argmin(sub, axis=1)  # fastest member per cell; ties -> low slot
    assignment = np.zeros(sub.shape, np.float64)
    assignment[np.arange(sub.shape[0]), slot] = 1.0
    preference = np.argsort(sub, axis=1, kind="stable").astype(np.int64)
    if len(members) == 1:
        # same full-matrix matvec CodesignResult.weighted_time() runs, so
        # the K=1 degeneracy is bit-exact (a per-column dot can round the
        # last ulp differently than BLAS's matvec)
        wt = float((freqs @ times)[members[0]])
    else:
        wt = float(freqs @ sub.min(axis=1))
    total_area = float(np.sum(area[list(members)]))
    gflops = numer / wt / 1.0e9
    return PortfolioResult(
        k=k,
        objective=objective,
        budget=float(budget),
        members=tuple(int(m) for m in members),
        assignment=assignment,
        preference=preference,
        freqs=np.asarray(freqs, np.float64).copy(),
        weighted_time=wt,
        fleet_gflops=float(gflops),
        total_area=total_area,
        fleet_density=float(gflops / total_area),
        candidates=candidates,
        engine=engine,
    )


def _subset_universe(
    n_hw: int, cand: np.ndarray, k: int, max_subsets: int
) -> list:
    """Enumeration order shared by both engines: all singletons (ascending
    hw index), then size-2..K combinations of the candidate set."""
    total = n_hw
    for size in range(2, k + 1):
        total += math.comb(cand.shape[0], size)
    if total > max_subsets:
        raise ValueError(
            f"portfolio enumeration would score {total} subsets "
            f"(> max_subsets={max_subsets}); downsample the hardware "
            f"space or lower k"
        )
    subsets = [(int(h),) for h in range(n_hw)]
    for size in range(2, k + 1):
        subsets.extend(
            tuple(int(cand[j]) for j in combo)
            for combo in itertools.combinations(range(cand.shape[0]), size)
        )
    return subsets


def _score_numpy(
    subsets: list,
    area: np.ndarray,
    times: np.ndarray,
    freqs: np.ndarray,
    numer: float,
    budget: float,
    objective: str,
) -> int:
    """Exact oracle: explicit float64 loop, strict ``>`` keeps the first
    (smallest, lexicographically lowest) of tied subsets. Singletons use
    the same full-matrix ``freqs @ times`` matvec as ``gflops()`` so a
    k=1 throughput answer is bit-identical to ``best()``."""
    wt_single = freqs @ times  # (H,) -- best()'s own reduction
    best_obj = -np.inf
    best_i = -1
    for i, sub in enumerate(subsets):
        if len(sub) == 1:
            wt = wt_single[sub[0]]
            total_area = area[sub[0]]
        else:
            wt = float(freqs @ np.min(times[:, sub], axis=1))
            total_area = float(np.sum(area[list(sub)]))
        gflops = numer / wt / 1.0e9
        obj = gflops / total_area if objective == "density" else gflops
        if total_area <= budget and np.isfinite(obj) and obj > best_obj:
            best_obj = obj
            best_i = i
    return best_i


#: subsets scored per pass of the torch engine: bounds the (C, M, K)
#: gather at C x 32,768 x K float64 values
_TORCH_SUBSET_CHUNK = 1 << 15


def _score_torch(
    subsets: list,
    area: np.ndarray,
    times: np.ndarray,
    freqs: np.ndarray,
    numer: float,
    budget: float,
    objective: str,
    k: int,
    device,
) -> int:
    """Fused torch scorer: pad subsets to width K (mask-aware), gather the
    (C, M, K) time block, min over members, one matvec for every fleet's
    weighted time. float64 on ``device``, with the oracle's arithmetic:
    singletons read the full-matrix ``freqs @ times`` matvec, member areas
    sum left to right. ``torch.argmax`` names the first maximum, as the
    oracle's strict ``>`` does. The caller re-reports the winner in
    float64 numpy."""
    import torch

    dev = torch.device(device)
    m = len(subsets)
    idx = np.zeros((m, k), np.int64)
    valid = np.zeros((m, k), bool)
    for i, sub in enumerate(subsets):
        idx[i, : len(sub)] = sub
        valid[i, : len(sub)] = True
    single = valid.sum(axis=1) == 1

    # np.array copies: a stored matrix is a read-only mmap
    t = torch.from_numpy(np.array(times, np.float64)).to(dev)
    f = torch.from_numpy(np.array(freqs, np.float64)).to(dev)
    a = torch.from_numpy(np.array(area, np.float64)).to(dev)
    wt_single = f @ t  # (H,) -- best()'s own reduction
    inf = torch.tensor(float("inf"), dtype=torch.float64, device=dev)
    objs = []
    for s in range(0, m, _TORCH_SUBSET_CHUNK):
        idx_d = torch.as_tensor(idx[s : s + _TORCH_SUBSET_CHUNK], device=dev)
        valid_d = torch.as_tensor(valid[s : s + _TORCH_SUBSET_CHUNK], device=dev)
        single_d = torch.as_tensor(single[s : s + _TORCH_SUBSET_CHUNK], device=dev)
        g = torch.where(valid_d[None, :, :], t[:, idx_d], inf)  # (C, M, K)
        wt = torch.where(single_d, wt_single[idx_d[:, 0]], f @ g.amin(dim=2))  # (M,)
        member_area = torch.where(valid_d, a[idx_d], 0.0)
        total_area = member_area[:, 0]
        for j in range(1, k):  # left to right, as np.sum over <= K members
            total_area = total_area + member_area[:, j]
        gflops = numer / wt / 1.0e9
        obj = gflops / total_area if objective == "density" else gflops
        ok = (total_area <= budget) & torch.isfinite(obj)
        objs.append(torch.where(ok, obj, -inf))
    obj = torch.cat(objs)
    best = int(torch.argmax(obj))
    return best if bool(torch.isfinite(obj[best])) else -1


def optimize_portfolio_arrays(
    area: np.ndarray,
    cell_time: np.ndarray,
    cell_flops: np.ndarray,
    freqs: np.ndarray,
    k: int,
    budget: float,
    *,
    objective: str = "density",
    engine: str = "torch",
    max_subsets: int = _MAX_SUBSETS_DEFAULT,
    device=None,
) -> PortfolioResult:
    """Array-level portfolio optimization (the service/artifact path).
    ``device`` is where the torch engine runs (the card unless
    ``device="cpu"``; without a card it raises); ``engine="numpy"`` is the
    float64 oracle and ignores it."""
    if objective not in OBJECTIVES:
        raise ValueError(f"objective must be one of {OBJECTIVES}, got {objective!r}")
    if engine not in ENGINES:
        raise ValueError(f"engine must be 'numpy' or 'torch', got {engine!r}")
    k = int(k)
    if k < 1:
        raise ValueError(f"k must be >= 1, got {k}")
    area = np.asarray(area, np.float64).ravel()
    times = np.asarray(cell_time, np.float64)
    freqs = np.asarray(freqs, np.float64).ravel()
    flops = np.asarray(cell_flops, np.float64).ravel()
    if times.shape != (freqs.shape[0], area.shape[0]):
        raise ValueError("cell_time must be (C, H) matching freqs/area")
    if (freqs < 0).any() or not np.isfinite(freqs).all():
        raise ValueError("freqs must be finite and non-negative")
    numer = float(freqs @ flops)

    if engine == "torch":
        from .._device import resolve_device

        device = resolve_device(device)  # the card unless the CPU was asked for
    else:
        device = None  # the oracle's passes run in numpy
    cand = np.nonzero(portfolio_candidates(area, times, device=device))[0]
    subsets = _subset_universe(area.shape[0], cand, k, max_subsets)
    if engine == "torch":
        best_i = _score_torch(
            subsets, area, times, freqs, numer, budget, objective, k, device
        )
    else:
        best_i = _score_numpy(subsets, area, times, freqs, numer, budget, objective)
    if best_i < 0:
        raise ValueError(
            f"no feasible portfolio: no subset of <= {k} designs fits "
            f"budget {budget} with a finite fleet objective"
        )
    return _finalize_subset(
        subsets[best_i],
        area,
        times,
        freqs,
        numer,
        k=k,
        objective=objective,
        budget=budget,
        candidates=tuple(int(c) for c in cand),
        engine=engine,
    )


def optimize_portfolio(
    result,
    k: int,
    budget: float,
    freqs: Optional[np.ndarray] = None,
    *,
    objective: str = "density",
    engine: str = "torch",
    max_subsets: int = _MAX_SUBSETS_DEFAULT,
    device=None,
) -> PortfolioResult:
    """Portfolio over a :class:`~repro_torch.core.codesign.CodesignResult` (or
    any object with ``hw.area`` / ``cell_time`` / ``cell_freqs()`` /
    ``cell_flops()`` -- LM results and stored artifacts qualify via
    :func:`optimize_portfolio_arrays`). ``freqs`` defaults to the
    workload's own mix, unnormalized, exactly as ``best()`` consumes it.
    """
    return optimize_portfolio_arrays(
        result.hw.area,
        result.cell_time,
        result.cell_flops(),
        result.cell_freqs() if freqs is None else freqs,
        k,
        budget,
        objective=objective,
        engine=engine,
        max_subsets=max_subsets,
        device=device,
    )
