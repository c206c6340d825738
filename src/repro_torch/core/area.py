"""Analytical silicon-area model (paper §III).

The paper models total die area of a GPU-like programmable accelerator as a
linear composite of micro-architectural parameters (eqs. 3-6), calibrated
with Cacti 6.5 fits + die-photomicrograph measurements on the Maxwell
GTX-980 and validated on the Titan X.

Two layers are provided:

* :class:`LinearAreaModel` -- the generic linear-composite form of eq. (5):
  a sum of per-SM, per-vector-unit, per-kB and per-chip terms. Any
  accelerator family can be expressed by choosing coefficients.
* :data:`MAXWELL` -- the paper's calibrated Maxwell instantiation, using the
  folded coefficients of eq. (6) *exactly* (the operative model the paper
  validates against the Titan X). The raw §III.B Cacti-fit coefficients are
  kept in :data:`MAXWELL_RAW_FITS` for reference; the paper's folded
  constants do not precisely re-derive from them (see DESIGN.md,
  "Known internal inconsistencies").

All evaluation functions are vectorized over numpy arrays so the codesign
driver can sweep thousands of hardware points at once. numpy only: the same
model as the JAX package's ``core/area.py``, kept as this package's own copy.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping

import numpy as np

__all__ = [
    "HardwarePoint",
    "LinearAreaModel",
    "MAXWELL",
    "MAXWELL_RAW_FITS",
    "GTX980",
    "TITAN_X",
    "cacheless",
]


@dataclasses.dataclass(frozen=True)
class HardwarePoint:
    """One point in the hardware design space (paper Table I, group 2).

    Attributes
    ----------
    n_sm:        number of streaming multiprocessors (coarse parallelism).
    n_v:         vector units (cores) per SM (fine parallelism).
    m_sm:        kB of shared (scratchpad) memory per SM.
    r_vu:        kB of register file per vector unit (fixed at calibration
                 value by the paper -- "the register file size is a fixed
                 constant in the area model").
    l1_smpair:   kB of L1 cache per SM pair (0 for the paper's cache-less
                 proposed designs).
    l2_kb:       kB of L2 cache on the chip (0 for cache-less designs).
    """

    n_sm: int
    n_v: int
    m_sm: float
    r_vu: float = 2.0
    l1_smpair: float = 0.0
    l2_kb: float = 0.0

    def as_dict(self) -> Mapping[str, float]:
        return dataclasses.asdict(self)


@dataclasses.dataclass(frozen=True)
class LinearAreaModel:
    """Eq. (5)/(6): ``A_tot = c_vu*n_sm*n_v + c_r*R_vu*n_sm*n_v
    + c_m*M_sm*n_sm + c_l1*L1_smpair*n_sm + c_l2*L2_kb + c_sm*n_sm + c_0``.

    Coefficients are mm^2 (per kB where applicable). ``c_0`` is a per-chip
    constant (zero in the paper's folded eq. (6) -- the chip-level overheads
    are amortized per-SM via ``c_sm``, a documented design choice, §III.A
    footnote 2).
    """

    c_vu: float  # per vector unit (core logic + per-VU register overhead)
    c_r: float  # per kB of register file per vector unit
    c_m: float  # per kB of shared memory per SM
    c_l1: float  # per kB of L1 per SM-pair, already folded with the 1/2
    c_l2: float  # per kB of L2 (chip-wide)
    c_sm: float  # per-SM overhead (FDU, I-cache, LSU, chip overhead share)
    c_0: float = 0.0
    name: str = "linear-area"

    def area(
        self,
        n_sm,
        n_v,
        m_sm,
        r_vu=2.0,
        l1_smpair=0.0,
        l2_kb=0.0,
    ):
        """Total die area in mm^2; broadcasts over numpy array inputs."""
        n_sm = np.asarray(n_sm, dtype=np.float64)
        n_v = np.asarray(n_v, dtype=np.float64)
        m_sm = np.asarray(m_sm, dtype=np.float64)
        return (
            self.c_vu * n_sm * n_v
            + self.c_r * np.asarray(r_vu, np.float64) * n_sm * n_v
            + self.c_m * m_sm * n_sm
            + self.c_l1 * np.asarray(l1_smpair, np.float64) * n_sm
            + self.c_l2 * np.asarray(l2_kb, np.float64)
            + self.c_sm * n_sm
            + self.c_0
        )

    def area_point(self, hw: HardwarePoint) -> float:
        return float(
            self.area(
                hw.n_sm, hw.n_v, hw.m_sm, hw.r_vu, hw.l1_smpair, hw.l2_kb
            )
        )

    def breakdown(self, hw: HardwarePoint) -> Mapping[str, float]:
        """Per-component areas (mm^2) -- used by the Fig.-4 resource plot."""
        return {
            "vector_units": self.c_vu * hw.n_sm * hw.n_v,
            "register_files": self.c_r * hw.r_vu * hw.n_sm * hw.n_v,
            "shared_memory": self.c_m * hw.m_sm * hw.n_sm,
            "l1": self.c_l1 * hw.l1_smpair * hw.n_sm,
            "l2": self.c_l2 * hw.l2_kb,
            "overhead": self.c_sm * hw.n_sm + self.c_0,
        }


#: The paper's folded, calibrated Maxwell model -- eq. (6) verbatim.
MAXWELL = LinearAreaModel(
    c_vu=0.0447,
    c_r=0.0043,
    c_m=0.015,
    c_l1=0.08,
    c_l2=0.041,
    c_sm=7.317,
    name="maxwell-eq6",
)

#: Raw §III.B Cacti linear-fit coefficients (reference only; eq. (6) is the
#: operative model). beta = slope per kB, alpha = per-bank overhead, mm^2.
MAXWELL_RAW_FITS = {
    "beta_R": 0.004305,
    "alpha_R": 0.001947,
    "beta_M": 0.01565,
    "alpha_M": 0.09281,
    "beta_L1": 0.1604,
    "alpha_L1": 0.08204,
    "beta_L2": 0.04197,
    "alpha_L2": 0.7685,
    "beta_VU": 0.04282,  # measured from die photo, excludes register file
    "alpha_oh": 6.4156,  # per-SM share of I/O pads, controllers, etc.
}

#: Stock configurations (paper §III.B-C). R_VU = 512 regs x 32 b = 2 kB.
#: L1_SMpair = 48 kB is required for eq. (6) to reproduce the published die
#: areas (see DESIGN.md); L2 = 2 MB (GTX980) / 3 MB (Titan X).
GTX980 = HardwarePoint(n_sm=16, n_v=128, m_sm=96.0, r_vu=2.0, l1_smpair=48.0, l2_kb=2048.0)
TITAN_X = HardwarePoint(n_sm=24, n_v=128, m_sm=96.0, r_vu=2.0, l1_smpair=48.0, l2_kb=3072.0)

#: Published die areas (mm^2) used for calibration/validation.
GTX980_DIE_MM2 = 398.0
TITAN_X_DIE_MM2 = 601.0


def cacheless(hw: HardwarePoint) -> HardwarePoint:
    """The paper's §V.A *delete the caches* transform (HHC codes bypass
    caches, so proposed designs spend that area on cores instead)."""
    return dataclasses.replace(hw, l1_smpair=0.0, l2_kb=0.0)
