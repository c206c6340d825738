"""Integer non-linear solver for the per-cell tile-size problems.

The paper solves each per-(stencil, size) sub-problem (10 integer variables,
non-convex rational objective with floor/ceil) with bonmin, averaging 19 s
per instance (§IV.B) -- 7 to 24 hours per sweep. We replace bonmin with an
*exact* vectorized lattice sweep + local integer refinement:

* the feasible tile lattice is small once the paper's alignment constraints
  (t_S2 mult. 32, t_T even, k <= 32, footprint <= M_SM/k) are applied;
* `numpy` evaluates the full (hardware x lattice) cross product in chunked
  broadcasts -- thousands of hardware points x ~2k tile candidates per cell
  in milliseconds, so the whole Fig.-3 sweep takes minutes, not hours;
* a coordinate-descent refinement then polishes the best lattice point over
  unit integer steps, so reported optima are locally exact, not just
  lattice-exact.

This is the same eq.-(18) decomposition the paper uses; only the inner
solver is stronger (global-on-lattice instead of a local NLP solve).

This module is the **NumPy reference oracle** of this package: the torch
engine in :mod:`repro_torch.core.sweep` must match its argmins cell-by-cell
(tie-aware), on the CPU in the tests and on the card in ``chip_smoke.py``.
It stays float64 numpy. Keep it simple and exact rather than fast.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Dict, Tuple

import numpy as np

from .timemodel import GPUSpec, ProblemSize, StencilSpec, stencil_time

__all__ = [
    "TileLattice",
    "LATTICE_2D",
    "LATTICE_3D",
    "solve_cell",
    "refine_point",
]


@dataclasses.dataclass(frozen=True)
class TileLattice:
    """Candidate tile-size values per software parameter."""

    t_s1: Tuple[int, ...]
    t_s2: Tuple[int, ...]
    t_t: Tuple[int, ...]
    k: Tuple[int, ...]
    t_s3: Tuple[int, ...] = (1,)

    def grid(self) -> Dict[str, np.ndarray]:
        """Flattened meshgrid, one (L,) array per parameter."""
        combos = np.array(
            list(
                itertools.product(self.t_s1, self.t_s2, self.t_t, self.k, self.t_s3)
            ),
            dtype=np.float64,
        )
        return {
            "t_s1": combos[:, 0],
            "t_s2": combos[:, 1],
            "t_t": combos[:, 2],
            "k": combos[:, 3],
            "t_s3": combos[:, 4],
        }

    @property
    def size(self) -> int:
        return (
            len(self.t_s1) * len(self.t_s2) * len(self.t_t) * len(self.k) * len(self.t_s3)
        )


LATTICE_2D = TileLattice(
    t_s1=(1, 2, 4, 8, 16, 32, 64),
    t_s2=(32, 64, 128, 256, 512, 1024),
    t_t=(2, 4, 8, 16, 32, 64, 128),
    k=(1, 2, 4, 8, 16, 32),
)

LATTICE_3D = TileLattice(
    t_s1=(1, 2, 4, 8, 16, 32),
    t_s2=(32, 64, 128, 256),
    t_t=(2, 4, 8, 16, 32, 64),
    k=(1, 2, 4, 8, 16),
    t_s3=(1, 2, 4, 8),
)


def solve_cell(
    st: StencilSpec,
    gpu: GPUSpec,
    size: ProblemSize,
    n_sm: np.ndarray,
    n_v: np.ndarray,
    m_sm: np.ndarray,
    lattice: TileLattice | None = None,
    chunk: int = 512,
) -> Tuple[np.ndarray, np.ndarray]:
    """min over tile sizes of T_alg, for every hardware point.

    Returns ``(best_time (H,), best_lattice_index (H,))``; infeasible
    hardware points (no feasible tile) get +inf / -1.
    """
    if lattice is None:
        lattice = LATTICE_3D if st.dims == 3 else LATTICE_2D
    g = lattice.grid()
    n_sm = np.asarray(n_sm, np.float64).ravel()
    n_v = np.asarray(n_v, np.float64).ravel()
    m_sm = np.asarray(m_sm, np.float64).ravel()
    H = n_sm.shape[0]
    if chunk <= 0:  # same contract as the torch engine: no chunking
        chunk = max(1, H)
    best_t = np.full(H, np.inf)
    best_i = np.full(H, -1, dtype=np.int64)
    for lo in range(0, H, chunk):
        hi = min(lo + chunk, H)
        t = stencil_time(
            st,
            gpu,
            size,
            n_sm[lo:hi, None],
            n_v[lo:hi, None],
            m_sm[lo:hi, None],
            g["t_s1"][None, :],
            g["t_s2"][None, :],
            g["t_t"][None, :],
            g["k"][None, :],
            g["t_s3"][None, :],
        )
        idx = np.argmin(t, axis=1)
        tt = t[np.arange(hi - lo), idx]
        best_t[lo:hi] = tt
        best_i[lo:hi] = np.where(np.isfinite(tt), idx, -1)
    return best_t, best_i


def decode_index(lattice: TileLattice, index: int) -> Dict[str, int]:
    """Lattice index -> tile-size dict."""
    g = lattice.grid()
    return {kk: int(g[kk][index]) for kk in ("t_s1", "t_s2", "t_t", "k", "t_s3")}


_STEPS = {
    "t_s1": 1,
    "t_s2": 32,  # eq. (13): warps
    "t_t": 2,  # eq. (15): even (hybrid-hexagonal requirement)
    "k": 1,
    "t_s3": 1,
}


def refine_point(
    st: StencilSpec,
    gpu: GPUSpec,
    size: ProblemSize,
    hw: Tuple[float, float, float],
    sw0: Dict[str, int],
    max_rounds: int = 64,
) -> Tuple[float, Dict[str, int]]:
    """Coordinate descent over unit integer steps from a lattice optimum.

    Guarantees a locally-exact integer optimum (no neighbor within one
    aligned step improves). Used for the *reported* design points.
    """
    n_sm, n_v, m_sm = hw
    sw = dict(sw0)
    names = ["t_s1", "t_s2", "t_t", "k"] + (["t_s3"] if st.dims == 3 else [])

    def ev(s):
        return float(
            stencil_time(
                st, gpu, size, n_sm, n_v, m_sm,
                s["t_s1"], s["t_s2"], s["t_t"], s["k"], s["t_s3"],
            )
        )

    cur = ev(sw)
    for _ in range(max_rounds):
        improved = False
        for name in names:
            step = _STEPS[name]
            for delta in (step, -step):
                cand = dict(sw)
                cand[name] = max(step if name != "t_s1" else 1, cand[name] + delta)
                if cand[name] == sw[name]:
                    continue
                t = ev(cand)
                if t < cur:
                    cur, sw, improved = t, cand, True
        if not improved:
            break
    return cur, sw
