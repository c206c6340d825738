"""Workload characterization (paper §II, §IV.A).

A workload is a set of (stencil, problem-size) cells with occurrence
frequencies. The paper's experiments use the six-stencil suite over

    SZ_S = {4096, 8192, 12288, 16384},  SZ_T = {1024, ..., 16384},
    SZ   = {(S, T) | S in SZ_S, T in SZ_T, T <= S}      (|SZ| = 16)

with uniform frequencies ("we assumed all six stencils equally likely, and
that each size combination also equally likely", §IV.B).

Eq. (17)/(18) never look inside a cell: the objective only needs each
cell's occurrence frequency and a per-design-point time/feasibility
function that the sweep engine can evaluate in bulk. That contract is the
:class:`Cell` protocol below. ``(stencil, size)`` cells
(:class:`WorkloadCell`, family ``"stencil"``) are the only family this
package sweeps so far.

numpy only: the same definitions as the JAX package's ``core/workload.py``,
kept as this package's own copy.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Protocol, Sequence, Tuple, runtime_checkable

from .timemodel import STENCILS, ProblemSize, StencilSpec

__all__ = [
    "Cell",
    "WorkloadCell",
    "Workload",
    "paper_sizes",
    "paper_workload",
]

SZ_S = (4096, 8192, 12288, 16384)
SZ_T = (1024, 2048, 4096, 8192, 16384)


@runtime_checkable
class Cell(Protocol):
    """What eq. (18)'s inner minimization needs from a workload cell.

    A cell is one independently-optimized unit of work: it exposes its
    occurrence frequency (``freq``), a ``family`` tag the sweep engine
    dispatches on, and a stable ``label`` used for grouping in query-time
    frequency overrides and artifact manifests. The per-design-point time
    model itself lives with the family's sweep implementation (it is
    vectorized over the whole lattice, not evaluated cell-by-cell) and
    branches in Python on cell *structure* only, never on array values.
    """

    freq: float

    @property
    def family(self) -> str: ...

    @property
    def label(self) -> str: ...


@dataclasses.dataclass(frozen=True)
class WorkloadCell:
    """The paper's original cell: one stencil at one problem size."""

    stencil: StencilSpec
    size: ProblemSize
    freq: float  # fr(c) * fr(c, Sz), already combined

    @property
    def family(self) -> str:
        return "stencil"

    @property
    def label(self) -> str:
        return self.stencil.name


@dataclasses.dataclass(frozen=True)
class Workload:
    """A frequency-weighted set of cells; eq. (17)'s objective is
    ``sum_cell freq * min_tiles T_alg(cell)`` (separability, eq. (18)).

    All cells must share one ``family`` — the sweep engines vectorize over
    homogeneous lattices, so a mixed workload has no single design space.
    """

    name: str
    cells: Tuple[WorkloadCell, ...]

    def __post_init__(self):
        total = sum(c.freq for c in self.cells)
        if not 0.999 <= total <= 1.001:
            raise ValueError(f"cell frequencies sum to {total}, expected 1")
        families = {getattr(c, "family", "stencil") for c in self.cells}
        if len(families) > 1:
            raise ValueError(f"mixed cell families in one workload: {sorted(families)}")

    @property
    def family(self) -> str:
        """Cell family ("stencil" for the paper's suite)."""
        if not self.cells:
            return "stencil"
        return getattr(self.cells[0], "family", "stencil")

    @property
    def stencils(self) -> List[StencilSpec]:
        seen: Dict[str, StencilSpec] = {}
        for c in self.cells:
            seen.setdefault(c.stencil.name, c.stencil)
        return list(seen.values())


def paper_sizes(dims: int) -> List[ProblemSize]:
    """The 16-element SZ grid; for 3D stencils the three spatial extents are
    all S (the paper reuses the same SZ set for both classes)."""
    sizes = []
    for s in SZ_S:
        for t in SZ_T:
            if t <= s:
                sizes.append(
                    ProblemSize(s1=s, s2=s, t=t, s3=s if dims == 3 else 1)
                )
    assert len(sizes) == 16
    return sizes


def paper_workload(
    stencil_names: Sequence[str] | None = None, name: str = "paper-uniform"
) -> Workload:
    """Uniform-frequency workload over the chosen stencils (default: all six,
    as in Fig. 3 / §IV.B). Single-stencil workloads (Table II) are built by
    passing one name -- the §V.B 'workload sensitivity for free' trick."""
    names = list(stencil_names or STENCILS.keys())
    cells: List[WorkloadCell] = []
    for n in names:
        st = STENCILS[n]
        sizes = paper_sizes(st.dims)
        for sz in sizes:
            cells.append(WorkloadCell(st, sz, 1.0 / (len(names) * len(sizes))))
    return Workload(name=name, cells=tuple(cells))
