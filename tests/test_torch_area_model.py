"""The JAX package's ``tests/test_area_model.py``, run on the port's
``repro_torch.core.area``. Area-model tests: paper §III calibration/validation numbers + properties."""

import numpy as np
import pytest
from _hypothesis_compat import given, settings, st  # soft dep: skips, not errors

from repro_torch.core.area import (
    GTX980,
    GTX980_DIE_MM2,
    MAXWELL,
    TITAN_X,
    TITAN_X_DIE_MM2,
    HardwarePoint,
    cacheless,
)


def test_gtx980_calibration():
    """Eq. (6) at the GTX-980 stock point reproduces the published die area
    (398 mm^2) to < 2.5% (we land at 394.68, -0.83%)."""
    a = MAXWELL.area_point(GTX980)
    assert a == pytest.approx(394.6784, abs=1e-3)
    assert abs(a - GTX980_DIE_MM2) / GTX980_DIE_MM2 < 0.025


def test_titanx_validation():
    """Paper §III.C: the model predicts the Titan X within ~2% of the
    published 601 mm^2 (paper: 589.2, -1.96%; our eq.-6-exact: 592.0)."""
    a = MAXWELL.area_point(TITAN_X)
    assert a == pytest.approx(592.0176, abs=1e-3)
    assert abs(a - TITAN_X_DIE_MM2) / TITAN_X_DIE_MM2 < 0.025


def test_cacheless_transform():
    """§V.A: deleting caches removes exactly the L1/L2 terms."""
    a_with = MAXWELL.area_point(GTX980)
    a_without = MAXWELL.area_point(cacheless(GTX980))
    l1 = 0.08 * 48.0 * 16
    l2 = 0.041 * 2048.0
    assert a_with - a_without == pytest.approx(l1 + l2, rel=1e-9)


def test_breakdown_sums_to_total():
    b = MAXWELL.breakdown(TITAN_X)
    assert sum(b.values()) == pytest.approx(MAXWELL.area_point(TITAN_X), rel=1e-12)


def test_vectorized_matches_scalar():
    n_sm = np.array([2, 16, 32])
    n_v = np.array([32, 128, 2048])
    m_sm = np.array([12.0, 96.0, 480.0])
    vec = MAXWELL.area(n_sm, n_v, m_sm)
    for i in range(3):
        pt = HardwarePoint(int(n_sm[i]), int(n_v[i]), float(m_sm[i]))
        assert vec[i] == pytest.approx(MAXWELL.area_point(pt), rel=1e-12)


@settings(max_examples=200, deadline=None)
@given(
    n_sm=st.integers(2, 64),
    n_v=st.integers(32, 4096),
    m_sm=st.integers(12, 960),
    dn=st.integers(0, 8),
    dv=st.integers(0, 256),
    dm=st.integers(0, 96),
)
def test_area_monotone(n_sm, n_v, m_sm, dn, dv, dm):
    """Property: area is monotone non-decreasing in every resource."""
    a0 = float(MAXWELL.area(n_sm, n_v, m_sm))
    a1 = float(MAXWELL.area(n_sm + dn, n_v + dv, m_sm + dm))
    assert a1 >= a0 - 1e-9


@settings(max_examples=100, deadline=None)
@given(n_sm=st.integers(2, 64), n_v=st.integers(32, 4096), m_sm=st.integers(12, 960))
def test_area_positive_and_linear_in_l2(n_sm, n_v, m_sm):
    a = float(MAXWELL.area(n_sm, n_v, m_sm))
    assert a > 0
    a2 = float(MAXWELL.area(n_sm, n_v, m_sm, l2_kb=1024.0))
    assert a2 - a == pytest.approx(0.041 * 1024.0, rel=1e-9)
