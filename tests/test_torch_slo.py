"""The JAX package's ``tests/test_slo.py``, run on the port's modules.

SLO engine: bucket quantile estimator vs the NumPy percentile oracle
on adversarial distributions, rolling-window frame arithmetic under a
fake clock, burn-rate math, status transitions (ok -> burning ->
violated), and the dual renderings of ``SLOTracker.report``."""

import json

import numpy as np
import pytest

from repro_torch.obs.metrics import LATENCY_BUCKETS
from repro_torch.obs.slo import (
    DEFAULT_OBJECTIVES,
    SLOObjective,
    SLOTracker,
    bucket_quantile,
)


def _bucketize(bounds, samples):
    """Counts in the same layout bucket_quantile wants: one count per
    bound (cumulative-style bins: sample <= bound) plus overflow."""
    counts = [0] * (len(bounds) + 1)
    for s in samples:
        for i, b in enumerate(bounds):
            if s <= b:
                counts[i] += 1
                break
        else:
            counts[-1] += 1
    return counts


# ---------------------------------------------------------------------------
# bucket_quantile vs numpy oracle
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("q", [0.5, 0.9, 0.99, 0.999])
@pytest.mark.parametrize(
    "name,samples",
    [
        ("uniform", np.linspace(1e-4, 5.0, 4001)),
        ("lognormal", np.exp(np.random.RandomState(0).normal(-6, 2, 5000))),
        # adversarial: bimodal mass hugging two bucket boundaries
        ("bimodal_edges", np.concatenate([
            np.full(900, 0.00101), np.full(100, 0.9999),
        ])),
        # everything in ONE bucket: interpolation must stay inside it
        ("single_bucket", np.full(1000, 0.003)),
        # heavy overflow tail beyond the last bound
        ("overflow_tail", np.concatenate([
            np.full(500, 0.001), np.full(500, 50.0),
        ])),
    ],
)
def test_bucket_quantile_vs_numpy(name, samples, q):
    bounds = LATENCY_BUCKETS
    counts = _bucketize(bounds, samples)
    est = bucket_quantile(bounds, counts, q)
    assert est is not None
    # the estimator is correct up to bucket resolution: it must land
    # within the bucket span covered by the order-statistic oracles
    # (nearest sample at or below / above the rank -- at an exact rank
    # boundary the linear-interpolation oracle jumps buckets, the
    # histogram cannot). Overflow clamps to the last finite bound.
    o_lo = float(np.percentile(samples, q * 100, method="lower"))
    o_hi = float(np.percentile(samples, q * 100, method="higher"))

    def bucket_edges(x):
        if x > bounds[-1]:
            return bounds[-1], bounds[-1]
        i = next(i for i, b in enumerate(bounds) if x <= b)
        return (0.0 if i == 0 else bounds[i - 1]), bounds[i]

    lo_edge = bucket_edges(o_lo)[0]
    hi_edge = bucket_edges(o_hi)[1]
    assert lo_edge - 1e-12 <= est <= hi_edge + 1e-12, (
        f"{name}: q={q} est={est} outside oracle band [{lo_edge}, {hi_edge}]"
    )


def test_bucket_quantile_edge_cases():
    bounds = (1.0, 2.0, 4.0)
    assert bucket_quantile(bounds, [0, 0, 0, 0], 0.5) is None  # no mass
    # all mass in overflow -> clamp to last bound
    assert bucket_quantile(bounds, [0, 0, 0, 7], 0.99) == 4.0
    # exact midpoint of a uniform bucket
    assert bucket_quantile(bounds, [0, 10, 0, 0], 0.5) == pytest.approx(1.5)
    with pytest.raises(ValueError):
        bucket_quantile(bounds, [1, 2], 0.5)  # wrong count arity
    with pytest.raises(ValueError):
        bucket_quantile(bounds, [0, 0, 0, 1], 1.5)  # q out of range


# ---------------------------------------------------------------------------
# objectives
# ---------------------------------------------------------------------------


def test_objective_validation():
    with pytest.raises(ValueError):
        SLOObjective(route="/v1/query", availability=1.5)
    with pytest.raises(ValueError):
        SLOObjective(route="/v1/query", latency_p=0.0)
    with pytest.raises(ValueError):
        SLOObjective(route="", latency_threshold_s=0.01)
    with pytest.raises(ValueError):
        SLOObjective(route="/v1/query", latency_threshold_s=-1.0)
    d = SLOObjective(route="/v1/query").to_dict()
    assert d["availability"] == 0.999 and d["latency_p"] == 0.99


def test_default_objectives_cover_query_routes():
    routes = {o.route for o in DEFAULT_OBJECTIVES}
    assert routes == {"/v1/query", "/v1/query_many", "/v1/route"}


# ---------------------------------------------------------------------------
# tracker: windows, burn rates, status transitions
# ---------------------------------------------------------------------------


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def test_tracker_ignores_unknown_routes():
    clk = FakeClock()
    tr = SLOTracker(clock=clk)
    tr.record("/v1/metrics", 0.001, ok=True)
    rep = tr.report()
    assert all(
        w["count"] == 0
        for r in rep["routes"].values()
        for w in r["windows"].values()
    )


def test_tracker_healthy_traffic_is_ok():
    clk = FakeClock()
    tr = SLOTracker(clock=clk)
    for i in range(1000):
        clk.t = i * 0.1
        tr.record("/v1/query", 0.005, ok=True)
    rep = tr.report()
    q = rep["routes"]["/v1/query"]
    assert q["status"] == "ok"
    assert rep["status"] == "ok"
    w5 = q["windows"]["5m"]
    assert w5["errors"] == 0 and w5["availability_burn"] == 0.0
    assert w5["p_estimate_s"] is not None and w5["p_estimate_s"] < 0.025


def test_tracker_burn_math_exact():
    """1% 5xx against a 99.9% objective = burn rate 10x, both windows."""
    clk = FakeClock()
    tr = SLOTracker(clock=clk)
    for i in range(1000):
        clk.t = float(i) * 0.05
        tr.record("/v1/query", 0.001, ok=(i % 100 != 0))
    rep = tr.report()
    q = rep["routes"]["/v1/query"]
    for w in ("5m", "1h"):
        assert q["windows"][w]["availability_burn"] == pytest.approx(10.0)
    # burning in BOTH windows -> violated, and the top status folds worst-of
    assert q["status"] == "violated"
    assert rep["status"] == "violated"


def test_tracker_recovery_transitions_to_burning_then_ok():
    """A recent error blip burns the short window while staying inside
    the hour's budget -> ``burning``; once it ages out of both windows
    the route is ok again."""
    clk = FakeClock()
    tr = SLOTracker(clock=clk)
    # an hour of clean traffic at 1 qps
    for i in range(3600):
        clk.t = float(i)
        tr.record("/v1/query", 0.001, ok=True)
    # then a 2-error blip: over the 5m budget (2/~300 >> 0.001), under
    # the 1h budget (2/~3600 < 0.001 is false -- 2/3602 = 0.00056 < 0.001)
    for i in (3600, 3601):
        clk.t = float(i)
        tr.record("/v1/query", 0.001, ok=False)
    rep = tr.report()
    q = rep["routes"]["/v1/query"]
    assert q["windows"]["5m"]["errors"] == 2
    assert q["windows"]["5m"]["availability_burn"] >= 1.0
    assert q["windows"]["1h"]["availability_burn"] < 1.0
    assert q["status"] == "burning"
    assert rep["status"] == "burning"
    # two hours later every error aged out of both windows
    clk.t = 10800.0
    tr.record("/v1/query", 0.001, ok=True)
    rep = tr.report()
    assert rep["routes"]["/v1/query"]["status"] == "ok"
    assert tr.status() == "ok"


def test_tracker_latency_burn_without_errors():
    """Slow-but-successful answers burn the latency budget only."""
    clk = FakeClock()
    tr = SLOTracker(clock=clk)
    for i in range(1000):
        clk.t = float(i) * 0.01
        # 5% of answers over the 25ms threshold, all HTTP 200
        tr.record("/v1/query", 0.5 if i % 20 == 0 else 0.001, ok=True)
    q = tr.report()["routes"]["/v1/query"]
    w5 = q["windows"]["5m"]
    assert w5["availability_burn"] == 0.0
    assert w5["latency_burn"] == pytest.approx(0.05 / 0.01)  # 5x
    assert q["status"] == "violated"


def test_report_shape_and_canonical_encoding():
    clk = FakeClock()
    tr = SLOTracker(clock=clk)
    tr.record("/v1/query", 0.004, ok=True)
    rep = tr.report()
    assert [w["name"] for w in rep["windows"]] == ["5m", "1h"]
    assert [w["seconds"] for w in rep["windows"]] == [300.0, 3600.0]
    assert list(rep["routes"]) == sorted(rep["routes"])
    # JSON-serializable all the way down (wire.encode_slo_response relies
    # on this)
    json.dumps(rep)


def test_render_prometheus_exposition():
    clk = FakeClock()
    tr = SLOTracker(clock=clk)
    for _ in range(10):
        tr.record("/v1/query", 0.004, ok=True)
    text = tr.render_prometheus().decode("utf-8")
    assert "repro_slo_burn_rate{" in text
    assert 'route="/v1/query"' in text
    assert "repro_slo_status{" in text
    assert "repro_slo_latency_estimate_seconds{" in text
    # status gauge encodes ok=0
    line = next(l for l in text.splitlines()
                if l.startswith('repro_slo_status{route="/v1/query"}'))
    assert float(line.split()[-1]) == 0.0


def test_frame_ring_is_bounded():
    """Days of traffic cannot grow the ring past its computed cap."""
    clk = FakeClock()
    tr = SLOTracker(clock=clk, frame_interval_s=5.0)
    for i in range(100_000):
        clk.t = float(i)
        tr.record("/v1/query", 0.001, ok=True)
    assert len(tr._frames) <= tr._max_frames
