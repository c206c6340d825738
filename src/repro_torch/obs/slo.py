"""Service-level objectives: declared targets, measured burn rates.

The gateway's metrics (:mod:`repro_torch.obs.metrics`) say *what happened*;
this module says *whether that is acceptable*. An :class:`SLOObjective`
declares, per route, an availability target (fraction of non-5xx
responses) and a latency target (a percentile that must stay under a
threshold). An :class:`SLOTracker` folds every response into rolling
multi-window frames (5 minutes and 1 hour by default) and reports, per
window:

* the observed request/error/slow counts,
* a streaming latency-percentile estimate -- linear interpolation over
  the same fixed ``LATENCY_BUCKETS`` the request histograms use, so the
  estimate is dependency-free and costs one bisect per record,
* **error-budget burn rates**: observed bad fraction divided by the
  budgeted bad fraction. Burn 1.0 means "spending the budget exactly as
  fast as allowed"; burn 10 on the short window is a page.

Status folds to one word the health endpoint can carry:
``violated`` when the long (1h) window is burning >= 1x on any
objective, ``burning`` when only the short (5m) window is, ``ok``
otherwise (including "no traffic yet" -- silence is not an outage).

Frames are advanced lazily on both :meth:`SLOTracker.record` and
:meth:`SLOTracker.report`, so an idle gateway's windows still roll
forward when scraped. The clock is injectable (monotonic seconds) which
keeps the golden wire fixture and the window tests deterministic.
"""

from __future__ import annotations

import bisect
import threading
import time
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

from .metrics import LATENCY_BUCKETS, Registry

__all__ = [
    "DEFAULT_OBJECTIVES",
    "WINDOWS",
    "SLOObjective",
    "SLOTracker",
    "bucket_quantile",
]

#: rolling windows reported per objective: (label, seconds). The last
#: (longest) window drives the ``violated`` status; the short one drives
#: ``burning``.
WINDOWS: Tuple[Tuple[str, float], ...] = (("5m", 300.0), ("1h", 3600.0))


@dataclass(frozen=True)
class SLOObjective:
    """One route's declared service level.

    ``availability`` is the target fraction of non-5xx responses (0.999
    budgets one bad request per thousand). ``latency_p`` is the
    percentile (0.99 = p99) that must stay under
    ``latency_threshold_s`` seconds; requests over the threshold spend
    the latency budget ``1 - latency_p``.
    """

    route: str
    availability: float = 0.999
    latency_p: float = 0.99
    latency_threshold_s: float = 0.025

    def __post_init__(self) -> None:
        if not self.route:
            raise ValueError("route must be a non-empty path")
        if not 0.0 < self.availability < 1.0:
            raise ValueError(f"availability must be in (0, 1), got {self.availability}")
        if not 0.0 < self.latency_p < 1.0:
            raise ValueError(f"latency_p must be in (0, 1), got {self.latency_p}")
        if self.latency_threshold_s <= 0.0:
            raise ValueError(
                f"latency_threshold_s must be > 0, got {self.latency_threshold_s}"
            )

    def to_dict(self) -> Dict[str, Any]:
        return {
            "route": self.route,
            "availability": self.availability,
            "latency_p": self.latency_p,
            "latency_threshold_s": self.latency_threshold_s,
        }


#: the serving stack's declared objectives: answer routes are p99-bound
#: at interactive thresholds; the batch route gets 10x headroom.
DEFAULT_OBJECTIVES: Tuple[SLOObjective, ...] = (
    SLOObjective("/v1/query", availability=0.999, latency_p=0.99,
                 latency_threshold_s=0.025),
    SLOObjective("/v1/query_many", availability=0.999, latency_p=0.99,
                 latency_threshold_s=0.250),
    SLOObjective("/v1/route", availability=0.999, latency_p=0.99,
                 latency_threshold_s=0.025),
)


def bucket_quantile(
    bounds: Sequence[float], counts: Sequence[int], q: float
) -> Optional[float]:
    """Quantile ``q`` estimated from per-bucket counts by linear
    interpolation inside the containing bucket.

    ``bounds`` are the histogram's upper bounds (strictly increasing);
    ``counts`` are NON-cumulative per-bucket counts with one extra
    trailing entry for the ``+Inf`` overflow bucket (``len(bounds)+1``
    entries). Returns ``None`` when there are no observations. Overflow
    quantiles clamp to the last finite bound -- the estimator never
    invents a value above what the histogram can resolve.
    """
    if not 0.0 <= q <= 1.0:
        raise ValueError(f"q must be in [0, 1], got {q}")
    if len(counts) != len(bounds) + 1:
        raise ValueError(
            f"need {len(bounds) + 1} counts (incl. overflow), got {len(counts)}"
        )
    total = sum(counts)
    if total == 0:
        return None
    # rank of the target observation (1-based, ceil)
    rank = q * total
    cum = 0
    for i, c in enumerate(counts):
        cum += c
        if cum >= rank and c > 0:
            if i == len(bounds):  # overflow bucket: clamp to last bound
                return float(bounds[-1])
            lo = 0.0 if i == 0 else float(bounds[i - 1])
            hi = float(bounds[i])
            # fraction of the way through this bucket's mass
            frac = (rank - (cum - c)) / c
            return lo + (hi - lo) * min(max(frac, 0.0), 1.0)
    return float(bounds[-1])


class _Totals:
    """Cumulative per-route counters (monotone; windows are deltas)."""

    __slots__ = ("count", "errors", "slow", "sum_s", "buckets")

    def __init__(self, n_buckets: int):
        self.count = 0
        self.errors = 0
        self.slow = 0
        self.sum_s = 0.0
        self.buckets = [0] * (n_buckets + 1)  # + overflow

    def snapshot(self) -> "_Totals":
        s = _Totals(len(self.buckets) - 1)
        s.count, s.errors, s.slow = self.count, self.errors, self.slow
        s.sum_s = self.sum_s
        s.buckets = list(self.buckets)
        return s


class SLOTracker:
    """Rolling-window SLO accounting over an injectable monotonic clock.

    ``record(route, duration_s, ok)`` is the single write path (one lock,
    one bisect); ``report()`` is the read path serving ``GET /v1/slo``.
    Windows are computed as deltas between the live cumulative counters
    and periodic frame snapshots kept in a bounded ring -- memory is
    O(routes x frames), independent of traffic.
    """

    def __init__(
        self,
        objectives: Sequence[SLOObjective] = DEFAULT_OBJECTIVES,
        *,
        buckets: Sequence[float] = LATENCY_BUCKETS,
        clock=time.monotonic,
        frame_interval_s: float = 5.0,
        windows: Sequence[Tuple[str, float]] = WINDOWS,
    ):
        if frame_interval_s <= 0:
            raise ValueError("frame_interval_s must be > 0")
        self._objectives = {o.route: o for o in objectives}
        self._bounds = tuple(float(b) for b in buckets)
        self._clock = clock
        self._frame_interval = float(frame_interval_s)
        self._windows = tuple((str(n), float(w)) for n, w in windows)
        max_w = max(w for _, w in self._windows)
        # frames to cover the longest window, +2 so the delta baseline
        # (newest frame at or before now - w) is always retained
        self._max_frames = int(max_w / self._frame_interval) + 2
        self._mu = threading.Lock()
        self._t0 = float(clock())
        self._last_event = self._t0
        self._totals: Dict[str, _Totals] = {
            r: _Totals(len(self._bounds)) for r in self._objectives
        }
        # frame ring: list of (t, {route: _Totals snapshot}) oldest-first
        self._frames: List[Tuple[float, Dict[str, _Totals]]] = [
            (self._t0, {r: t.snapshot() for r, t in self._totals.items()})
        ]

    @property
    def objectives(self) -> Tuple[SLOObjective, ...]:
        return tuple(self._objectives[r] for r in sorted(self._objectives))

    def _advance_frames(self, now: float) -> None:
        # caller holds self._mu; totals must NOT yet include an event
        # being recorded at `now` (record() advances before folding)
        last_t = self._frames[-1][0]
        if now - last_t < self._frame_interval:
            return
        if self._last_event > last_t and now - self._last_event >= self._frame_interval:
            # idle gap: totals haven't changed since the last event, so
            # sealing them at that event's own time is exact -- without
            # this frame, a quiet stretch would keep old events inside
            # windows that have already rolled past them
            self._frames.append(
                (self._last_event,
                 {r: t.snapshot() for r, t in self._totals.items()})
            )
        self._frames.append(
            (now, {r: t.snapshot() for r, t in self._totals.items()})
        )
        if len(self._frames) > self._max_frames:
            del self._frames[: len(self._frames) - self._max_frames]

    # ---- write path --------------------------------------------------------
    def record(self, route: str, duration_s: float, ok: bool) -> None:
        """Fold one response in. Routes without a declared objective are
        ignored -- scrapes and debug endpoints don't spend budget."""
        tot = self._totals.get(route)
        if tot is None:
            return
        d = float(duration_s)
        obj = self._objectives[route]
        i = bisect.bisect_left(self._bounds, d)
        with self._mu:
            now = float(self._clock())
            # seal pre-event state first, so this event can never leak
            # into a window baseline older than itself
            self._advance_frames(now)
            tot.count += 1
            tot.sum_s += d
            tot.buckets[min(i, len(self._bounds))] += 1
            if not ok:
                tot.errors += 1
            if d > obj.latency_threshold_s:
                tot.slow += 1
            self._last_event = now

    # ---- read path ---------------------------------------------------------
    def _baseline(self, now: float, window_s: float) -> Dict[str, _Totals]:
        # newest frame at or before (now - window_s); the very first
        # frame (all zeros at t0) backstops trackers younger than the
        # window. Caller holds self._mu.
        cutoff = now - window_s
        base = self._frames[0][1]
        for t, snap in self._frames:
            if t <= cutoff:
                base = snap
            else:
                break
        return base

    def _window_report(
        self, obj: SLOObjective, cur: _Totals, base: _Totals
    ) -> Dict[str, Any]:
        count = cur.count - base.count
        errors = cur.errors - base.errors
        slow = cur.slow - base.slow
        dcounts = [c - b for c, b in zip(cur.buckets, base.buckets)]
        p_est = bucket_quantile(self._bounds, dcounts, obj.latency_p)
        if count > 0:
            avail_burn = (errors / count) / (1.0 - obj.availability)
            latency_burn = (slow / count) / (1.0 - obj.latency_p)
        else:
            avail_burn = 0.0
            latency_burn = 0.0
        return {
            "count": count,
            "errors": errors,
            "slow": slow,
            "availability_burn": avail_burn,
            "latency_burn": latency_burn,
            "p_estimate_s": p_est,
        }

    @staticmethod
    def _route_status(windows: Dict[str, Dict[str, Any]],
                      short: str, long: str) -> str:
        def burning(w: Dict[str, Any]) -> bool:
            return w["availability_burn"] >= 1.0 or w["latency_burn"] >= 1.0

        if burning(windows[long]):
            return "violated"
        if burning(windows[short]):
            return "burning"
        return "ok"

    def report(self, now: Optional[float] = None) -> Dict[str, Any]:
        """The full SLO report as a deterministic plain dict (the JSON
        rendering of ``GET /v1/slo`` wraps exactly this)."""
        with self._mu:
            t = float(self._clock()) if now is None else float(now)
            self._advance_frames(t)
            cur = {r: tot.snapshot() for r, tot in self._totals.items()}
            bases = {
                name: self._baseline(t, w) for name, w in self._windows
            }
        short_name = self._windows[0][0]
        long_name = self._windows[-1][0]
        routes: Dict[str, Any] = {}
        worst = "ok"
        rank = {"ok": 0, "burning": 1, "violated": 2}
        for route in sorted(self._objectives):
            obj = self._objectives[route]
            windows = {
                name: self._window_report(obj, cur[route], bases[name][route])
                for name, _ in self._windows
            }
            status = self._route_status(windows, short_name, long_name)
            if rank[status] > rank[worst]:
                worst = status
            routes[route] = {
                "objective": obj.to_dict(),
                "status": status,
                "windows": windows,
            }
        return {
            "status": worst,
            "windows": [
                {"name": n, "seconds": w} for n, w in self._windows
            ],
            "routes": routes,
        }

    def status(self) -> str:
        """Just the folded one-word status (what ``/v1/healthz`` carries)."""
        return self.report()["status"]

    def render_prometheus(self, report: Optional[Dict[str, Any]] = None) -> bytes:
        """The report as Prometheus text exposition, via a throwaway
        private registry so families/labels render in the exact same
        format as ``/v1/metrics``."""
        rep = self.report() if report is None else report
        reg = Registry(disabled=False)
        burn = reg.gauge(
            "repro_slo_burn_rate",
            "error-budget burn rate (1.0 = spending exactly the budget)",
            labels=("route", "window", "objective"),
        )
        pest = reg.gauge(
            "repro_slo_latency_estimate_seconds",
            "windowed latency percentile estimate",
            labels=("route", "window"),
        )
        stat = reg.gauge(
            "repro_slo_status",
            "folded route status (0 ok, 1 burning, 2 violated)",
            labels=("route",),
        )
        rank = {"ok": 0, "burning": 1, "violated": 2}
        for route, r in rep["routes"].items():
            stat.labels(route=route).set(rank[r["status"]])
            for wname, w in r["windows"].items():
                burn.labels(route=route, window=wname,
                            objective="availability").set(w["availability_burn"])
                burn.labels(route=route, window=wname,
                            objective="latency").set(w["latency_burn"])
                if w["p_estimate_s"] is not None:
                    pest.labels(route=route, window=wname).set(w["p_estimate_s"])
        return reg.render_prometheus()
