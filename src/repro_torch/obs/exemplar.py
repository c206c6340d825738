"""Tail exemplars: span trees for the requests worth staring at.

Aggregates (histograms, burn rates) tell you the p99 regressed; they
cannot tell you *why*. This module keeps, per route, the full span trees
of exactly the requests an operator would ask for:

* the **slowest N** requests seen so far (a min-heap on duration: a new
  request evicts the fastest retained exemplar iff it is slower, so the
  retained set is deterministically the top-N regardless of thread
  interleaving), and
* the **most recent M error responses** (a ring: newest wins).

The gateway forces an internal trace for every request while capture is
enabled -- the client's response bytes are untouched (the trace tree is
only attached to the envelope when the client explicitly asked for it),
so untraced answers stay byte-identical. Exemplars are served at
``GET /v1/debug/exemplars`` and cross-referenced by the ``X-Repro-Trace``
response header: an operator who saw a slow request's trace id can pull
its tree minutes later.

Everything is bounded: memory is O(routes x (N + M) x tree size), and
``offer()`` is one lock acquisition plus at most one heap push-pop.
"""

from __future__ import annotations

import heapq
import itertools
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional, Tuple

__all__ = ["ExemplarStore"]


class _RouteRing:
    __slots__ = ("slow", "errors")

    def __init__(self, max_errors: int):
        # min-heap of (duration_s, seq, entry): root = fastest retained
        self.slow: List[Tuple[float, int, Dict[str, Any]]] = []
        self.errors: deque = deque(maxlen=max_errors)


class ExemplarStore:
    """Bounded per-route retention of slow/error request exemplars."""

    def __init__(self, slow_n: int = 8, max_errors: int = 32, *,
                 clock=time.time):
        if slow_n < 1:
            raise ValueError(f"slow_n must be >= 1, got {slow_n}")
        if max_errors < 1:
            raise ValueError(f"max_errors must be >= 1, got {max_errors}")
        self._slow_n = slow_n
        self._max_errors = max_errors
        self._clock = clock
        self._mu = threading.Lock()
        self._routes: Dict[str, _RouteRing] = {}
        self._seq = itertools.count()

    def offer(
        self,
        route: str,
        trace_id: str,
        duration_s: float,
        status: int,
        code: Optional[str] = None,
        trace: Optional[Dict[str, Any]] = None,
    ) -> None:
        """Consider one finished request for retention. Cheap to decline:
        a fast, successful request on a full ring costs one comparison."""
        entry = {
            "route": route,
            "trace_id": trace_id,
            "dur_us": int(round(float(duration_s) * 1e6)),
            "status": int(status),
            "at": float(self._clock()),
        }
        if code is not None:
            entry["code"] = code
        if trace is not None:
            entry["trace"] = trace
        with self._mu:
            ring = self._routes.get(route)
            if ring is None:
                ring = self._routes.setdefault(route, _RouteRing(self._max_errors))
            if status >= 400:
                ring.errors.append(entry)
                return
            item = (float(duration_s), next(self._seq), entry)
            if len(ring.slow) < self._slow_n:
                heapq.heappush(ring.slow, item)
            elif item[0] > ring.slow[0][0]:
                heapq.heapreplace(ring.slow, item)

    def routes(self) -> List[str]:
        with self._mu:
            return sorted(self._routes)

    def snapshot(self, route: Optional[str] = None) -> Dict[str, Any]:
        """Deterministic snapshot: slow exemplars sorted slowest-first,
        errors in arrival order (oldest retained first). ``route=None``
        returns every route; an unknown route returns empty lists (the
        gateway validates route names before calling, so "no exemplars
        yet" and "unknown route" stay distinguishable)."""
        with self._mu:
            if route is not None:
                names = [route] if route in self._routes else []
            else:
                names = sorted(self._routes)
            picked = {
                n: (list(self._routes[n].slow), list(self._routes[n].errors))
                for n in names
            }
        out: Dict[str, Any] = {}
        for n, (slow, errors) in picked.items():
            out[n] = {
                "slow": [e for _, _, e in
                         sorted(slow, key=lambda it: (-it[0], it[1]))],
                "errors": list(errors),
            }
        if route is not None and route not in out:
            out[route] = {"slow": [], "errors": []}
        return {"slow_n": self._slow_n, "max_errors": self._max_errors,
                "routes": out}
