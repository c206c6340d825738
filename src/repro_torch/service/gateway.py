"""Fleet gateway: one front door over many stored sweep artifacts.

:class:`repro_torch.service.server.CodesignServer` serves exactly one sweep; a
fleet store holds one artifact per (GPU target, hardware space, lattice,
stencil set) and a cache only pays off if all of them are reachable
through a single long-lived endpoint. The gateway closes that gap:

* **discovery / index** -- every artifact under one or more
  :class:`~repro_torch.service.store.ArtifactStore` roots is indexed at startup
  (and re-indexed on demand) by its manifest-only routing attributes
  (:meth:`repro_torch.service.store.Artifact.routing`): content key, GPU name,
  workload name, stencil set, hardware-space digest, engine family.
  Indexing reads only the small JSON manifests -- no matrix is paged in;
* **routing** -- a request names its artifact either exactly (the content
  key) or by a *routing selector* (``{"gpu": "titanx"}``,
  ``{"stencils": ["heat2d"]}``); :meth:`Gateway.resolve` maps selector ->
  key, answering ``unknown_artifact`` / ``ambiguous_route`` as structured
  errors rather than guessing. A key that misses triggers one re-scan
  before failing, so artifacts dropped into the store after startup are
  served without a restart;
* **LRU server pool** -- each routed key gets a lazily-instantiated
  per-artifact server for its cell family
  (:func:`~repro_torch.service.server.server_from_artifact`: a
  :class:`CodesignServer` for stencil sweeps, an
  :class:`~repro_torch.service.server.LMServer` for LM sweeps), kept in an
  LRU bounded by ``pool_size``: hundreds of stored artifacts never mean
  hundreds of resident mmaps/LRUs. Evicted servers finish their in-flight
  queries (the query path holds a reference) and are garbage-collected;
* **HTTP transport** -- :class:`GatewayHTTPServer` (stdlib
  ``ThreadingHTTPServer``; one thread per connection) exposes
  ``POST /v1/query``, ``GET /v1/artifacts``, ``GET /v1/healthz``,
  ``GET /v1/metrics`` and ``POST /v1/refresh`` over the
  :mod:`repro_torch.service.wire` codec. Concurrent HTTP requests for the same
  artifact rendezvous in that artifact's ``CodesignServer.query``, so the
  leader/follower microbatching survives the process boundary unchanged;
* **observability** -- every request lands in the :mod:`repro_torch.obs`
  metrics registry (per-route and per-artifact counters + latency
  histograms, served back at ``/v1/metrics``), query routes carry an
  ``X-Repro-Trace`` id, a ``"trace": true`` envelope opts into span
  recording, and ``telemetry_interval`` periodically persists per-artifact
  hit/latency stats as ``kind: "telemetry"`` manifest-only artifacts.

Wire format, error codes and a curl-able quickstart are documented in
``docs/serving.md``; the observability surface in
``docs/observability.md``; the request flow diagram lives in
``docs/architecture.md`` (written for the JAX package; the port answers
with the same bytes).

The port, against the JAX package's gateway:

* the gateway creates no tensor: it serves stored artifacts on the host,
  and each query reduces on the host in the port's
  :class:`~repro_torch.service.query.QueryEngine`, which reduces a
  microbatch row by row -- so an HTTP answer, from ``/v1/query`` under
  concurrency or from ``/v1/query_many``, is byte-identical to the lone
  in-process answer to the same request.
"""

from __future__ import annotations

import contextlib
import contextvars
import json
import math
import os
import re
import threading
import time
from collections import OrderedDict
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple, Union
from urllib.parse import parse_qs, urlsplit

from repro_torch.obs import get_logger
from repro_torch.obs.exemplar import ExemplarStore
from repro_torch.obs.metrics import get_registry as _obs_registry
from repro_torch.obs.process import M_CONNECTIONS, M_POOL_SERVERS, sample_process
from repro_torch.obs.slo import DEFAULT_OBJECTIVES, SLOObjective, SLOTracker
from repro_torch.obs.trace import TRACE_HEADER, new_trace_id, span, trace

from . import faults, wire
from .errors import GatewayError
from .usage import UsageLedger
from .portfolio import PortfolioServer, RouteRequest, RouteResponse
from .query import QueryRequest, QueryResponse
from .resilience import (
    CLIENT_HEADER,
    DEADLINE_HEADER,
    Deadline,
    GatewayResilience,
    check_deadline,
    deadline_scope,
)
from .server import CodesignServer, _M_BATCH_POISON, server_from_artifact
from .store import ArtifactStore

__all__ = [
    "Gateway",
    "GatewayError",
    "UnknownArtifactError",
    "UnknownRouteError",
    "AmbiguousRouteError",
    "AmbiguousWorkloadError",
    "WrongArtifactKindError",
    "GatewayHTTPServer",
    "serve_http",
]

#: selector names :meth:`Gateway.resolve` understands. ``stencils``,
#: ``models`` and ``ops`` are subset matches (the artifact must serve at
#: least those stencils / LM models / LM ops); the rest are exact equality
#: against the routing row. ``workload`` matches the workload name (LM
#: sweeps are built as workload ``"lm"`` by default, so ``{"workload":
#: "lm"}`` is the LM disambiguator); ``family`` matches the cell family
#: ("stencil" | "lm"). ``kind`` widens the search beyond sweep artifacts
#: (measurement/calibration manifests); ``calibration`` selects the sweep
#: built from a given calibration key.
ROUTE_SELECTORS = (
    "key", "gpu", "workload", "family", "stencils", "models", "ops",
    "engine", "hw_digest", "kind", "calibration",
)

#: selectors matched as subsets rather than exact equality.
_SUBSET_SELECTORS = ("stencils", "models", "ops")

# ---- observability (repro_torch.obs; no-ops under REPRO_OBS_DISABLED=1) --
_LOG = get_logger("repro_torch.gateway")
_REG = _obs_registry()
_M_REQUESTS = _REG.counter(
    "repro_gateway_requests_total", "HTTP requests handled, by route",
    labels=("route",),
)
_M_REQUEST_SECONDS = _REG.histogram(
    "repro_gateway_request_seconds",
    "end-to-end HTTP request wall time (decode -> encode), by route",
    labels=("route",),
)
_M_ERRORS = _REG.counter(
    "repro_gateway_errors_total", "error responses, by route and wire code",
    labels=("route", "code"),
)
_M_ENCODE_SECONDS = _REG.histogram(
    "repro_gateway_encode_seconds", "wire-encoding wall time of /v1/query answers",
)
_M_ART_REQUESTS = _REG.counter(
    "repro_gateway_artifact_requests_total",
    "queries routed to each artifact (the per-artifact hit stats behind "
    "/v1/artifacts and the persisted telemetry snapshots)",
    labels=("artifact",),
)
_M_ART_LAST = _REG.gauge(
    "repro_gateway_artifact_last_access_seconds",
    "unix time of each artifact's most recent routed query",
    labels=("artifact",),
)
_M_ART_SECONDS = _REG.histogram(
    "repro_gateway_artifact_query_seconds",
    "server dispatch wall time per routed artifact",
    labels=("artifact",),
)

#: the bounded set of HTTP route labels (unknown paths all fold into
#: "other" so a path-scanning client can't explode label cardinality).
_ROUTES = (
    "/v1/query", "/v1/query_many", "/v1/route", "/v1/artifacts",
    "/v1/healthz", "/v1/metrics", "/v1/slo", "/v1/debug/exemplars",
    "/v1/refresh",
)

#: the routes whose finished requests are offered as tail exemplars
#: (slowest-N span trees + error ring; docs/observability.md).
_EXEMPLAR_ROUTES = ("/v1/query", "/v1/query_many", "/v1/route")

#: per-request client bucket (X-Repro-Client header or peer address),
#: set by the HTTP handler so the usage ledger can attribute hits
#: without threading a parameter through every query signature.
_CLIENT_BUCKET: contextvars.ContextVar[Optional[str]] = contextvars.ContextVar(
    "repro_gateway_client_bucket", default=None
)


# GatewayError itself now lives in the dependency-leaf
# :mod:`repro_torch.service.errors` (so the store and resilience layers can
# raise structured failures without importing this module); it is
# re-exported here -- ``repro_torch.service.gateway.GatewayError`` stays the
# public spelling. Every subclass pins the wire error ``code``, and the
# HTTP status comes from the shared :data:`wire.ERROR_HTTP_STATUS`
# registry (one table serves the server side here and the batched
# client-side decoder, so the two can never disagree about how a code
# classifies).


class UnknownArtifactError(GatewayError):
    """No stored artifact matches the requested key/selector (HTTP 404)."""

    code = "unknown_artifact"
    http_status = wire.ERROR_HTTP_STATUS["unknown_artifact"]


class UnknownRouteError(GatewayError):
    """A ``/v1/debug/exemplars?route=`` filter named a route this gateway
    does not serve -- a caller typo, not a retryable condition (HTTP 404)."""

    code = "unknown_route"
    http_status = wire.ERROR_HTTP_STATUS["unknown_route"]


class AmbiguousRouteError(GatewayError):
    """A routing selector matched more than one artifact; the message
    carries the candidate keys so the caller can pin one (HTTP 409)."""

    code = "ambiguous_route"
    http_status = wire.ERROR_HTTP_STATUS["ambiguous_route"]


class AmbiguousWorkloadError(GatewayError):
    """A routing selector matched artifacts of more than one *cell family*
    (e.g. a stencil sweep and an LM sweep stored for the same GPU name).
    Unlike a same-family :class:`AmbiguousRouteError` (HTTP 409, "pin a
    key"), the request is underspecified about what kind of question it is
    asking -- add a ``workload`` or ``family`` selector -- so it classifies
    as the caller's error (HTTP 400), mirroring ``wrong_artifact_kind``."""

    code = "ambiguous_workload"
    http_status = wire.ERROR_HTTP_STATUS["ambiguous_workload"]


class WrongArtifactKindError(GatewayError):
    """The resolved artifact exists but is not a queryable sweep (e.g. a
    measurement run or calibration manifest was pinned for /v1/query).
    The request named the wrong thing, hence HTTP 400."""

    code = "wrong_artifact_kind"
    http_status = wire.ERROR_HTTP_STATUS["wrong_artifact_kind"]


class Gateway:
    """Route :class:`QueryRequest` s across every artifact in one or more
    store roots (see the module docstring for the moving parts).

    Parameters
    ----------
    roots:
        One path or a sequence of paths to artifact store directories.
        Roots must exist (:class:`UnknownArtifactError` is *not* the right
        failure for a typo'd path): a missing root raises
        ``FileNotFoundError`` immediately.
    pool_size:
        Max resident per-artifact servers (LRU-evicted beyond this).
    batch_window / lru_size:
        Forwarded to each pooled :class:`CodesignServer` /
        :class:`~repro_torch.service.query.QueryEngine`.
    telemetry_interval:
        Seconds between persisted per-artifact telemetry snapshots
        (:meth:`persist_telemetry`); ``0`` (the default) disables
        persistence entirely -- stored artifact counts then never drift
        under test/smoke query load.
    resilience:
        The :class:`~repro_torch.service.resilience.GatewayResilience` bundle
        (admission control + per-artifact circuit breakers). The default
        sentinel ``"default"`` builds one with permissive settings (no
        rate limits, inflight cap 128, breaker threshold 5); pass
        ``None`` to disable resilience entirely (deadlines still
        propagate -- they are a per-request contract, not a knob).
    slo_objectives:
        Per-route :class:`~repro_torch.obs.slo.SLOObjective` declarations
        tracked by the gateway's :class:`~repro_torch.obs.slo.SLOTracker`
        (served at ``GET /v1/slo``; folds into ``/v1/healthz``). Pass
        ``()`` to declare none (the tracker then reports no routes).
    exemplar_slow_n / exemplar_errors:
        Per-route tail-exemplar retention: span trees of the slowest
        ``exemplar_slow_n`` requests plus the last ``exemplar_errors``
        error responses (``GET /v1/debug/exemplars``).
        ``exemplar_slow_n=0`` disables capture entirely.
    usage_flush_interval:
        Seconds between persistent usage-ledger flushes (the
        ``.usage-ledger.json`` beside each store root;
        :mod:`repro_torch.service.usage`). The ledger replaces the old
        process-local hit counters behind ``/v1/artifacts``.
    telemetry_cap:
        Max ``kind: "telemetry"`` snapshots retained per store root;
        :meth:`persist_telemetry` prunes the oldest beyond it (the cap
        also folds into the ``gc`` CLI's retention plan).
    """

    def __init__(
        self,
        roots: Union[str, Sequence[str]],
        pool_size: int = 8,
        batch_window: float = 0.002,
        lru_size: int = 256,
        telemetry_interval: float = 0.0,
        resilience: Union[GatewayResilience, None, str] = "default",
        slo_objectives: Sequence[SLOObjective] = DEFAULT_OBJECTIVES,
        exemplar_slow_n: int = 8,
        exemplar_errors: int = 32,
        usage_flush_interval: float = 60.0,
        telemetry_cap: int = 32,
    ):
        if isinstance(roots, (str, os.PathLike)):
            roots = [roots]
        if not roots:
            raise ValueError("gateway needs at least one store root")
        self.stores = [ArtifactStore(r, create=False) for r in roots]
        self.pool_size = int(pool_size)
        if self.pool_size < 1:
            raise ValueError("pool_size must be >= 1")
        self.batch_window = float(batch_window)
        self.lru_size = int(lru_size)
        self.telemetry_interval = float(telemetry_interval)
        if resilience == "default":
            resilience = GatewayResilience()
        self.resilience: Optional[GatewayResilience] = resilience
        if telemetry_cap < 0:
            raise ValueError("telemetry_cap must be >= 0")
        self.telemetry_cap = int(telemetry_cap)
        self.slo = SLOTracker(slo_objectives)
        self.exemplars: Optional[ExemplarStore] = (
            ExemplarStore(exemplar_slow_n, exemplar_errors)
            if exemplar_slow_n > 0 else None
        )
        #: per-store-root persistent usage ledgers (the durable hit/byte
        #: accounting behind /v1/artifacts and the gc retention plan)
        self.usage: Dict[str, UsageLedger] = {
            s.root: UsageLedger(s.root, flush_interval_s=usage_flush_interval)
            for s in self.stores
        }
        self._t0_mono = time.monotonic()  # uptime basis (NTP-step immune)
        self._telemetry_mu = threading.Lock()
        self._telemetry_last = time.monotonic()
        self._mu = threading.Lock()  # guards _index and both pools
        self._index: "OrderedDict[str, Dict[str, Any]]" = OrderedDict()
        self._pool: "OrderedDict[str, CodesignServer]" = OrderedDict()
        self._portfolio_pool: "OrderedDict[str, PortfolioServer]" = OrderedDict()
        self.stats: Dict[str, int] = {
            "requests": 0,
            "routed_by_key": 0,
            "routed_by_selector": 0,
            "unknown": 0,
            "pool_hits": 0,
            "pool_instantiations": 0,
            "pool_evictions": 0,
            "rescans": 0,
            "batched_requests": 0,
        }
        self.refresh()

    # ---- discovery --------------------------------------------------------
    def refresh(self) -> int:
        """Re-scan every root and rebuild the routing index from manifests
        (cheap: JSON only). Returns the number of indexed artifacts.
        Already-pooled servers for keys that disappeared are dropped."""
        index: "OrderedDict[str, Dict[str, Any]]" = OrderedDict()
        for store in self.stores:
            for row in store.entries():
                # first root wins on (content-addressed) key collisions --
                # identical keys name identical bytes, so either copy serves
                index.setdefault(row["key"], {**row, "store": store})
        with self._mu:
            self._index = index
            self.stats["rescans"] += 1
            for key in [k for k in self._pool if k not in index]:
                del self._pool[key]
            for key in [k for k in self._portfolio_pool if k not in index]:
                del self._portfolio_pool[key]
            M_POOL_SERVERS.set(len(self._pool) + len(self._portfolio_pool))
        return len(index)

    def keys(self) -> List[str]:
        with self._mu:
            return list(self._index)

    def entries(self) -> List[Dict[str, Any]]:
        """Routing rows (sans store handles) -- the ``/v1/artifacts``
        payload. Each row carries ``hits`` / ``bytes`` / ``last_access``
        sourced from the persistent usage ledger beside its store root
        (:mod:`repro_torch.service.usage`): buffered deltas merged over what
        the last flush persisted, so the counts survive restarts. The
        fields stay advisory in the wire sense -- deliberately excluded
        from the canonical byte-identity surface (only ``/v1/query``
        answers carry that guarantee)."""
        with self._mu:
            rows = [
                {k: v for k, v in row.items() if k != "store"}
                for row in self._index.values()
            ]
            roots = {k: row["store"].root for k, row in self._index.items()}
        snaps = {root: ledger.snapshot() for root, ledger in self.usage.items()}
        for row in rows:
            rec = snaps.get(roots.get(row["key"], ""), {}).get(row["key"])
            row["hits"] = int(rec["hits"]) if rec else 0
            row["bytes"] = int(rec["bytes"]) if rec else 0
            row["last_access"] = rec["last_access"] if rec else None
        return rows

    def __len__(self) -> int:
        with self._mu:
            return len(self._index)

    # ---- routing ----------------------------------------------------------
    def _match(
        self, route: Mapping[str, Any], kinds: Optional[Sequence[str]]
    ) -> List[str]:
        unknown = set(route) - set(ROUTE_SELECTORS)
        if unknown:
            raise ValueError(
                f"unknown route selector(s) {sorted(unknown)} "
                f"(want one of {list(ROUTE_SELECTORS)})"
            )
        if "kind" in route:
            kinds = None  # an explicit kind selector overrides the default
        with self._mu:
            rows = list(self._index.values())
        out = []
        for row in rows:
            ok = kinds is None or row.get("kind", "sweep") in kinds
            if ok:
                for name, want in route.items():
                    if name in _SUBSET_SELECTORS:
                        want_set = {want} if isinstance(want, str) else set(want)
                        ok = want_set <= set(row.get(name) or ())
                    elif name == "family":
                        ok = row.get("family", "stencil") == want
                    else:
                        ok = row.get(name) == want
                    if not ok:
                        break
            if ok:
                out.append(row["key"])
        return out

    def resolve(
        self,
        artifact: Optional[str] = None,
        route: Optional[Mapping[str, Any]] = None,
        kinds: Optional[Sequence[str]] = ("sweep",),
        rescan: bool = True,
    ) -> str:
        """Map (key | selector | nothing) -> one content key.

        An exact ``artifact`` key wins over ``route``. A miss triggers one
        on-demand :meth:`refresh` (new artifacts appear without a restart)
        before raising :class:`UnknownArtifactError`; a selector matching
        several artifacts raises :class:`AmbiguousRouteError` listing the
        candidates. With neither argument, a single-artifact gateway
        serves its only artifact and a multi-artifact one refuses to
        guess.

        ``kinds`` restricts which manifest kinds compete: the query paths
        keep the default ``("sweep",)`` so measurement/calibration
        manifests in the same store can never make a ``{"gpu": ...}``
        selector ambiguous (an explicit ``{"kind": ...}`` selector in
        ``route`` overrides it). A pinned ``artifact`` key of the wrong
        kind raises :class:`WrongArtifactKindError` rather than a
        misleading 404.

        ``rescan=False`` skips the on-demand refresh on a miss --
        :meth:`query_many` uses it to bound a whole batch to ONE store
        re-scan instead of one per unresolvable query."""
        for attempt in range(2 if rescan else 1):
            if artifact is not None:
                with self._mu:
                    row = self._index.get(artifact)
                    if row is not None:
                        kind = row.get("kind", "sweep")
                        if kinds is not None and kind not in kinds:
                            pass  # raise outside the lock
                        else:
                            self.stats["routed_by_key"] += 1
                            return artifact
                if row is not None:
                    want = (
                        "a queryable sweep" if kinds == ("sweep",)
                        else f"a routable {'/'.join(kinds)} manifest"
                    )
                    raise WrongArtifactKindError(
                        f"artifact {artifact!r} is a {row.get('kind')!r} manifest, "
                        f"not {want}"
                    )
            elif route:
                matches = self._match(route, kinds)
                if len(matches) == 1:
                    with self._mu:
                        self.stats["routed_by_selector"] += 1
                    return matches[0]
                if len(matches) > 1:
                    with self._mu:
                        families = {
                            self._index[k].get("family", "stencil")
                            for k in matches
                            if k in self._index
                        }
                    if len(families) > 1:
                        raise AmbiguousWorkloadError(
                            f"route {dict(route)} matches artifacts of "
                            f"{len(families)} cell families "
                            f"({', '.join(sorted(families))}); add a "
                            f"'workload' or 'family' selector to say which "
                            f"kind of question this is"
                        )
                    raise AmbiguousRouteError(
                        f"route {dict(route)} matches {len(matches)} artifacts "
                        f"({', '.join(sorted(matches))}); pin one with 'artifact'"
                    )
            else:
                with self._mu:
                    candidates = [
                        k for k, row in self._index.items()
                        if kinds is None or row.get("kind", "sweep") in kinds
                    ]
                if len(candidates) == 1:
                    with self._mu:
                        self.stats["routed_by_key"] += 1
                    return candidates[0]
                if len(candidates) > 1:
                    raise AmbiguousRouteError(
                        f"gateway serves {len(candidates)} artifacts; name one "
                        "via 'artifact' or a 'route' selector"
                    )
            if rescan and attempt == 0:
                self.refresh()  # on-demand discovery before giving up
        with self._mu:
            self.stats["unknown"] += 1
        if artifact is not None:
            what = f"artifact {artifact!r}"
        elif route:
            what = f"route {dict(route)}"
        elif kinds is not None:
            # the store may be non-empty but hold only non-sweep kinds
            # (e.g. after `measure.cli run` + `fit`, before `build`) --
            # "empty store" would contradict the indexed count printed next
            what = f"an unselected query (no {'/'.join(kinds)}-kind artifact stored)"
        else:
            what = "empty store"
        raise UnknownArtifactError(
            f"no stored artifact matches {what} "
            f"({len(self)} artifacts indexed; GET /v1/artifacts lists them)"
        )

    # ---- server pool ------------------------------------------------------
    def server_for(self, key: str) -> CodesignServer:
        """The pooled per-artifact server for an (already resolved) key,
        instantiating (and LRU-evicting) as needed."""
        with self._mu:
            srv = self._pool.get(key)
            if srv is not None:
                self._pool.move_to_end(key)
                self.stats["pool_hits"] += 1
                return srv
            row = self._index.get(key)
        if row is None:
            raise UnknownArtifactError(f"artifact {key!r} is not indexed")
        if row.get("kind", "sweep") != "sweep":
            raise WrongArtifactKindError(
                f"artifact {key!r} is a {row.get('kind')!r} manifest; only "
                "sweep artifacts serve queries"
            )
        store: ArtifactStore = row["store"]
        # the expensive, failure-prone part of a pool miss (store I/O +
        # server build: mmap, JSON, integrity check) runs under this
        # artifact's circuit breaker: after `threshold` consecutive raw
        # failures (corrupt file, flaky filesystem) the breaker opens and
        # callers fail fast with `circuit_open` instead of re-paying the
        # broken build until a half-open probe succeeds. GatewayError
        # outcomes (unknown/kind/deadline) pass through untouched and do
        # NOT count as breaker failures -- a client's tiny deadline must
        # never open the circuit for everyone else.
        res = self.resilience
        breaker = res.breaker(key) if res is not None else None
        ctx = breaker.call() if breaker is not None else contextlib.nullcontext()
        with ctx:
            art = store.get(key)
            if art is None:  # deleted between index and query
                self.refresh()
                raise UnknownArtifactError(
                    f"artifact {key!r} vanished from {store.root}"
                )
            srv = server_from_artifact(
                store, art, batch_window=self.batch_window, lru_size=self.lru_size
            )
        with self._mu:
            # a racing thread may have built it meanwhile; keep the first
            winner = self._pool.setdefault(key, srv)
            if winner is srv:
                self.stats["pool_instantiations"] += 1
            srv = winner
            self._pool.move_to_end(key)
            while len(self._pool) > self.pool_size:
                self._pool.popitem(last=False)  # in-flight queries hold refs
                self.stats["pool_evictions"] += 1
            M_POOL_SERVERS.set(len(self._pool) + len(self._portfolio_pool))
        return srv

    def portfolio_server_for(self, key: str) -> PortfolioServer:
        """The pooled :class:`~repro_torch.service.portfolio.PortfolioServer`
        for an (already resolved) portfolio key. Shares the gateway's
        resilience bundle, so route-time member reads run under the
        per-member circuit breakers; the build itself (two manifest
        loads) runs under the portfolio's own breaker like any pool
        miss."""
        with self._mu:
            srv = self._portfolio_pool.get(key)
            if srv is not None:
                self._portfolio_pool.move_to_end(key)
                self.stats["pool_hits"] += 1
                return srv
            row = self._index.get(key)
        if row is None:
            raise UnknownArtifactError(f"artifact {key!r} is not indexed")
        if row.get("kind", "sweep") != "portfolio":
            raise WrongArtifactKindError(
                f"artifact {key!r} is a {row.get('kind')!r} manifest; only "
                "portfolio artifacts serve /v1/route"
            )
        store: ArtifactStore = row["store"]
        res = self.resilience
        breaker = res.breaker(key) if res is not None else None
        ctx = breaker.call() if breaker is not None else contextlib.nullcontext()
        with ctx:
            art = store.get(key)
            if art is None:
                self.refresh()
                raise UnknownArtifactError(
                    f"artifact {key!r} vanished from {store.root}"
                )
            sweep_key = art.payload.get("sweep_key")
            sweep = None
            for s in [store] + [s for s in self.stores if s is not store]:
                sweep = s.get(sweep_key)
                if sweep is not None:
                    break
            if sweep is None:
                raise UnknownArtifactError(
                    f"portfolio {key!r} references sweep {sweep_key!r}, which "
                    "no store root holds (was the member sweep deleted?)"
                )
            srv = PortfolioServer(art, sweep, resilience=res)
        with self._mu:
            winner = self._portfolio_pool.setdefault(key, srv)
            if winner is srv:
                self.stats["pool_instantiations"] += 1
            srv = winner
            self._portfolio_pool.move_to_end(key)
            while len(self._portfolio_pool) > self.pool_size:
                self._portfolio_pool.popitem(last=False)
                self.stats["pool_evictions"] += 1
            M_POOL_SERVERS.set(len(self._pool) + len(self._portfolio_pool))
        return srv

    # ---- queries ----------------------------------------------------------
    def _note_artifact(self, key: str, dispatch_s: float, n: int = 1) -> None:
        """Per-artifact hit accounting: the live metrics registry (the
        telemetry snapshots) plus the persistent usage ledger (the
        ``/v1/artifacts`` rows and the ``gc`` retention plan). The single
        choke point for routed-query hits, so the two can never double
        count. No-ops under the ``REPRO_OBS_DISABLED`` kill switch."""
        _M_ART_REQUESTS.labels(artifact=key).inc(n)
        _M_ART_LAST.labels(artifact=key).set(time.time())
        _M_ART_SECONDS.labels(artifact=key).observe(dispatch_s)
        if _REG.disabled:
            return
        with self._mu:
            row = self._index.get(key)
            root = row["store"].root if row is not None else None
        ledger = self.usage.get(root) if root is not None else None
        if ledger is not None:
            ledger.record(key, n=n, client=_CLIENT_BUCKET.get())
            ledger.maybe_flush()

    def _note_bytes(self, key: str, nbytes: int) -> None:
        """Response-byte accounting for the single-answer routes (the
        batched route's shared envelope is not attributed per artifact)."""
        if _REG.disabled:
            return
        with self._mu:
            row = self._index.get(key)
            root = row["store"].root if row is not None else None
        ledger = self.usage.get(root) if root is not None else None
        if ledger is not None:
            ledger.record(key, n=0, nbytes=nbytes)

    def flush_usage(self) -> None:
        """Flush every store root's usage ledger now (shutdown path; the
        request path flushes on its own interval). Never raises."""
        for ledger in self.usage.values():
            try:
                ledger.flush()
            except Exception as e:  # noqa: BLE001 - accounting, never fatal
                _LOG.warning("usage_flush_failed",
                             error=f"{type(e).__name__}: {e}")

    def query(
        self,
        request: QueryRequest,
        artifact: Optional[str] = None,
        route: Optional[Mapping[str, Any]] = None,
    ) -> QueryResponse:
        """Route one request to its artifact's server (microbatching with
        any concurrent caller of the same artifact) and answer it."""
        with self._mu:
            self.stats["requests"] += 1
        check_deadline("gateway.resolve")
        with span("resolve"):
            key = self.resolve(artifact, route)
        check_deadline("gateway.pool")
        with span("pool", artifact=key[:12]):
            srv = self.server_for(key)
        t0 = time.perf_counter()
        with span("dispatch", artifact=key[:12]):
            response = srv.query(request)
        self._note_artifact(key, time.perf_counter() - t0)
        self._maybe_persist_telemetry()
        return response

    def route(
        self,
        request: RouteRequest,
        artifact: Optional[str] = None,
        route: Optional[Mapping[str, Any]] = None,
    ) -> RouteResponse:
        """Resolve a portfolio (key or selector, among ``kind:
        "portfolio"`` manifests only) and route one workload cell to its
        assigned member design (``POST /v1/route``)."""
        with self._mu:
            self.stats["requests"] += 1
        check_deadline("gateway.resolve")
        with span("resolve"):
            key = self.resolve(artifact, route, kinds=("portfolio",))
        check_deadline("gateway.pool")
        with span("pool", artifact=key[:12]):
            srv = self.portfolio_server_for(key)
        t0 = time.perf_counter()
        with span("dispatch", artifact=key[:12]):
            response = srv.route(request)
        self._note_artifact(key, time.perf_counter() - t0)
        self._maybe_persist_telemetry()
        return response

    def query_many(
        self,
        queries: Sequence[
            Tuple[QueryRequest, Optional[str], Optional[Mapping[str, Any]]]
        ],
    ) -> List[Any]:
        """Answer N routed queries in one call (the ``/v1/query_many``
        body). Queries are resolved individually, grouped by artifact, and
        each group rides that artifact's ``CodesignServer.query_many``
        stacked matmul -- per-artifact microbatching without waiting on a
        rendezvous window. Returns, per query *in order*, either a
        :class:`QueryResponse` or a ``(code, message)`` error pair: one
        unroutable or poisonous query never fails its batchmates."""
        results: List[Any] = [None] * len(queries)
        groups: Dict[str, List[int]] = {}
        with self._mu:
            self.stats["requests"] += len(queries)
            self.stats["batched_requests"] += len(queries)
        # at most ONE on-demand store re-scan per batch: the first
        # unresolvable query pays it, the rest fail fast (a batch of
        # unknown keys must not trigger MAX_BATCH full-store scans)
        rescanned = False
        for i, (request, artifact, route) in enumerate(queries):
            try:
                # the deadline classifies per element (the batch contract:
                # errors are pairs, never a blanket failure) -- a spent
                # budget fails each remaining element fast, right here
                check_deadline("gateway.resolve")
                key = self.resolve(artifact, route, rescan=not rescanned)
            except UnknownArtifactError as e:
                rescanned = True
                results[i] = (e.code, str(e))
                continue
            except GatewayError as e:
                results[i] = (e.code, str(e))
                continue
            except (KeyError, ValueError) as e:
                results[i] = ("bad_request", str(e.args[0] if e.args else e))
                continue
            groups.setdefault(key, []).append(i)
        def answer_group(key: str, idxs: List[int]) -> None:
            try:
                _answer_group(key, idxs)
            except Exception as e:  # noqa: BLE001 - NOTHING may escape: an
                # unfilled slot would crash the whole batch's encoding
                # (and the pool path would swallow the exception silently)
                for i in idxs:
                    if results[i] is None:
                        results[i] = ("internal", f"{type(e).__name__}: {e}")

        def _answer_group(key: str, idxs: List[int]) -> None:
            try:
                # server_for can also raise outside the GatewayError
                # family (e.g. a corrupt artifact failing its content-key
                # check with ValueError) -- the outer boundary catches it
                srv = self.server_for(key)
            except GatewayError as e:
                for i in idxs:
                    results[i] = (e.code, str(e))
                return
            t0 = time.perf_counter()
            try:
                for i, resp in zip(idxs, srv.query_many([queries[i][0] for i in idxs])):
                    results[i] = resp
                self._note_artifact(key, time.perf_counter() - t0, n=len(idxs))
            except GatewayError as e:
                # a classified outcome for the whole stacked call (e.g.
                # deadline_exceeded): every element gets the code -- solo
                # retries would just re-pay a budget that is already spent
                for i in idxs:
                    results[i] = (e.code, str(e))
            except Exception as flush_err:  # noqa: BLE001 - isolate the poison pill
                _M_BATCH_POISON.inc()
                _LOG.warning("batch_poisoned", artifact=key[:12], size=len(idxs),
                             error=f"{type(flush_err).__name__}: {flush_err}")
                for i in idxs:
                    try:
                        results[i] = srv.query(queries[i][0])
                    except GatewayError as e:
                        results[i] = (e.code, str(e))
                    except (KeyError, ValueError) as e:
                        results[i] = (
                            "bad_request", str(e.args[0] if e.args else e)
                        )
                    except Exception as e:  # noqa: BLE001 - boundary
                        results[i] = ("internal", f"{type(e).__name__}: {e}")
                self._note_artifact(key, time.perf_counter() - t0, n=len(idxs))

        if len(groups) <= 1:
            for key, idxs in groups.items():
                answer_group(key, idxs)
        else:
            # overlap the per-artifact stacked matmuls: groups answer
            # concurrently (each writes disjoint result indices), matching
            # what concurrent single-endpoint requests would get from the
            # threaded HTTP server -- but on a pool BOUNDED by the server
            # pool size: a batch pinning 1024 distinct artifacts must not
            # spawn 1024 threads thrashing an 8-server LRU.
            from concurrent.futures import ThreadPoolExecutor

            workers = min(len(groups), self.pool_size)
            with ThreadPoolExecutor(max_workers=workers) as pool:
                for key, idxs in groups.items():
                    # contextvars (the request deadline) do not cross into
                    # executor threads by themselves; each submission gets
                    # its own Context copy (one Context cannot run
                    # concurrently in two threads)
                    pool.submit(
                        contextvars.copy_context().run, answer_group, key, idxs
                    )
        self._maybe_persist_telemetry()
        return results

    def health(self) -> Dict[str, Any]:
        slo_status = self.slo.status()  # own lock; computed outside _mu
        with self._mu:
            return {
                "ok": True,
                "slo": slo_status,
                "uptime_s": round(time.monotonic() - self._t0_mono, 3),
                "artifacts": len(self._index),
                "pooled_servers": len(self._pool),
                "pool_size": self.pool_size,
                "telemetry_interval": self.telemetry_interval,
                "roots": [s.root for s in self.stores],
                "stats": dict(self.stats),
            }

    # ---- telemetry persistence --------------------------------------------
    def artifact_stats(self) -> Dict[str, Dict[str, Any]]:
        """Per-artifact hit/latency stats for every *indexed* artifact,
        read from the live metrics registry (never minting zero samples
        for untouched keys). The payload of :meth:`persist_telemetry`."""
        out: Dict[str, Dict[str, Any]] = {}
        for key in self.keys():
            hits = _M_ART_REQUESTS.get(artifact=key)
            last = _M_ART_LAST.get(artifact=key)
            lat = _M_ART_SECONDS.get(artifact=key)
            out[key] = {
                "hits": int(hits.value) if hits is not None else 0,
                "last_access": last.value if last is not None else None,
                "query_seconds_count": lat.count if lat is not None else 0,
                "query_seconds_sum": lat.sum if lat is not None else 0.0,
            }
        return out

    def persist_telemetry(self, store: Optional[ArtifactStore] = None) -> str:
        """Write the current per-artifact hit/latency stats as a
        ``kind: "telemetry"`` manifest-only artifact (first store root by
        default) and return its content key.

        Each snapshot carries its collection time, so successive snapshots
        get distinct keys -- a retention policy reads the *series*. The
        ``("sweep",)`` default kind filter in :meth:`resolve` keeps these
        manifests out of query routing automatically."""
        store = store if store is not None else self.stores[0]
        with self._mu:
            stats = dict(self.stats)
        payload = {
            "collected_at": time.time(),
            "uptime_s": round(time.monotonic() - self._t0_mono, 3),
            "gateway": stats,
            "artifacts": self.artifact_stats(),
        }
        art = store.put_json(
            "telemetry", payload, routing={"workload": "gateway-telemetry"}
        )
        _LOG.info("telemetry_persisted", key=art.key,
                  artifacts=len(payload["artifacts"]))
        self._prune_telemetry(store)
        return art.key

    def _prune_telemetry(self, store: ArtifactStore) -> None:
        """Enforce ``telemetry_cap``: drop the oldest ``kind:
        "telemetry"`` snapshots (by their own ``collected_at``) beyond
        the cap, so a long-lived gateway's snapshot *series* stays a
        series instead of an unbounded accretion."""
        snaps: List[Tuple[float, str]] = []
        for key in store.keys():
            art = store.get(key)
            if art is not None and art.kind == "telemetry":
                snaps.append((float(art.payload.get("collected_at") or 0.0), key))
        excess = len(snaps) - self.telemetry_cap
        if excess <= 0:
            return
        snaps.sort()
        for _, key in snaps[:excess]:
            store.delete(key)
        _LOG.info("telemetry_pruned", dropped=excess, cap=self.telemetry_cap)
        self.refresh()

    def _maybe_persist_telemetry(self) -> None:
        """Interval-gated :meth:`persist_telemetry` on the request path
        (no background thread: a gateway that stops serving stops
        snapshotting, and tests stay deterministic). Never lets a
        telemetry failure fail the query that triggered it."""
        iv = self.telemetry_interval
        if iv <= 0:
            return
        now = time.monotonic()
        with self._telemetry_mu:
            if now - self._telemetry_last < iv:
                return
            self._telemetry_last = now
        try:
            self.persist_telemetry()
        except Exception as e:  # noqa: BLE001 - advisory path, never fatal
            _LOG.warning("telemetry_persist_failed",
                         error=f"{type(e).__name__}: {e}")


# ---------------------------------------------------------------------------
# HTTP transport
# ---------------------------------------------------------------------------
_TRACE_ID_RE = re.compile(r"[^A-Za-z0-9_-]")


def _clean_trace_id(raw: Optional[str]) -> str:
    """A usable trace id from a client-supplied header value: echo it
    (sanitized to a bounded identifier charset) or mint a fresh one."""
    if raw:
        tid = _TRACE_ID_RE.sub("", raw)[:64]
        if tid:
            return tid
    return new_trace_id()


class _Handler(BaseHTTPRequestHandler):
    """Maps the wire codec onto HTTP. All bodies are JSON; failures are
    :func:`repro_torch.service.wire.encode_error` payloads (never tracebacks).

    Every request increments per-route counters and a latency histogram
    in the :mod:`repro_torch.obs` registry (served right back at
    ``GET /v1/metrics``); query routes echo/mint an ``X-Repro-Trace``
    header, and a ``"trace": true`` request envelope opts into span
    recording (the tree rides back in the response envelope)."""

    server_version = "repro-gateway/1"
    protocol_version = "HTTP/1.1"  # keep-alive: clients reuse connections

    def setup(self) -> None:
        super().setup()
        M_CONNECTIONS.inc()

    def finish(self) -> None:
        try:
            super().finish()
        finally:
            M_CONNECTIONS.dec()

    def log_message(self, fmt, *args):  # noqa: ARG002
        # the stdlib's per-request stderr line, rerouted through the
        # structured logger at DEBUG: silent by default (NullHandler /
        # level), JSON lines under `serve --log-level debug`
        _LOG.debug("http_access", client=self.client_address[0],
                   line=fmt % args)

    @property
    def gateway(self) -> Gateway:
        return self.server.gateway  # type: ignore[attr-defined]

    def _route(self) -> str:
        """Metrics label for this request's path: the known endpoint, or
        "other" (bounded label cardinality under path scans)."""
        path = self.path.split("?", 1)[0]
        return path if path in _ROUTES else "other"

    def _send(
        self,
        status: int,
        body: bytes,
        content_type="application/json",
        headers: Optional[Mapping[str, str]] = None,
    ) -> None:
        self._last_status = status  # the SLO recorder reads it in finally
        self.send_response(status)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(body)))
        for name, value in (headers or {}).items():
            self.send_header(name, value)
        if self.close_connection:
            self.send_header("Connection", "close")
        self.end_headers()
        self.wfile.write(body)

    def _send_error(
        self,
        status: int,
        code: str,
        message: str,
        headers: Optional[Mapping[str, str]] = None,
    ) -> None:
        # one request per connection on failures: simpler client recovery
        # than reasoning about keep-alive state after an error
        self.close_connection = True
        self._ex_code = code  # the error-exemplar offer reads it in finally
        _M_ERRORS.labels(route=self._route(), code=code).inc()
        _LOG.debug("request_error", route=self._route(), code=code,
                   status=status, message=message)
        self._send(status, wire.encode_error(code, message), headers=headers)

    def _send_gateway_error(self, e: GatewayError) -> None:
        """A structured GatewayError onto the wire, carrying Retry-After
        when the failure advertises a backoff hint (429/503 family)."""
        headers = None
        retry_after = getattr(e, "retry_after_s", None)
        if retry_after is not None:
            headers = {"Retry-After": str(max(1, math.ceil(retry_after)))}
        self._send_error(e.http_status, e.code, str(e), headers=headers)

    def _request_deadline(self, env_ms: Optional[float]) -> Optional[Deadline]:
        """The effective request deadline: the ``X-Repro-Deadline-Ms``
        header, the envelope ``deadline_ms``, or (when both are present)
        the tighter of the two. None when the request carries neither."""
        raw = self.headers.get(DEADLINE_HEADER)
        ms: Optional[float] = None
        if raw is not None:
            try:
                ms = float(raw)
            except ValueError:
                raise wire.WireError(
                    f"invalid {DEADLINE_HEADER} header {raw!r} "
                    "(want a positive number of milliseconds)"
                ) from None
            ms = wire._check_deadline_ms(ms)
        if env_ms is not None:
            ms = env_ms if ms is None else min(ms, env_ms)
        return None if ms is None else Deadline(ms)

    def _metrics_body(self, query: str) -> Tuple[bytes, str]:
        """The ``/v1/metrics`` payload: Prometheus text by default,
        canonical JSON via ``?format=json`` or ``Accept:
        application/json`` (explicit ``?format=`` wins)."""
        fmt = self._scrape_format(query)
        sample_process()  # lazy process gauges: refreshed per scrape
        reg = _REG
        if fmt == "json":
            return reg.render_json(), "application/json"
        if fmt in ("prometheus", "text"):
            return (reg.render_prometheus(),
                    "text/plain; version=0.0.4; charset=utf-8")
        raise wire.WireError(
            f"unknown metrics format {fmt!r} (want 'prometheus' or 'json')"
        )

    def _scrape_format(self, query: str) -> str:
        """Shared format negotiation of the scrape endpoints
        (``/v1/metrics``, ``/v1/slo``): explicit ``?format=`` wins over
        the Accept header; Prometheus text is the default."""
        fmt = (parse_qs(query).get("format") or [""])[0]
        if not fmt:
            accept = self.headers.get("Accept", "")
            fmt = "json" if "application/json" in accept else "prometheus"
        return fmt

    def _slo_body(self, query: str) -> Tuple[bytes, str]:
        """The ``/v1/slo`` payload: the burn-rate gauges as Prometheus
        text by default, the full wire-enveloped report via
        ``?format=json`` (the canonical rendering the golden corpus
        pins)."""
        fmt = self._scrape_format(query)
        slo = self.gateway.slo
        if fmt == "json":
            return wire.encode_slo_response(slo.report()), "application/json"
        if fmt in ("prometheus", "text"):
            return (slo.render_prometheus(),
                    "text/plain; version=0.0.4; charset=utf-8")
        raise wire.WireError(
            f"unknown slo format {fmt!r} (want 'prometheus' or 'json')"
        )

    def do_GET(self) -> None:  # noqa: N802 - BaseHTTPRequestHandler API
        split = urlsplit(self.path)
        t0 = time.perf_counter()
        self._last_status: Optional[int] = None
        try:
            if split.path == "/v1/healthz":
                body = json.dumps(self.gateway.health(), sort_keys=True).encode()
                self._send(200, body)
            elif split.path == "/v1/artifacts":
                body = json.dumps(
                    {"v": wire.WIRE_VERSION, "artifacts": self.gateway.entries()},
                    sort_keys=True,
                ).encode()
                self._send(200, body)
            elif split.path == "/v1/metrics":
                body, content_type = self._metrics_body(split.query)
                self._send(200, body, content_type=content_type)
            elif split.path == "/v1/slo":
                body, content_type = self._slo_body(split.query)
                self._send(200, body, content_type=content_type)
            elif split.path == "/v1/debug/exemplars":
                self._send_exemplars(split.query)
            else:
                self._send_error(wire.ERROR_HTTP_STATUS["not_found"], "not_found",
                                 f"no such endpoint {split.path!r}")
        except wire.WireError as e:
            self._send_error(wire.ERROR_HTTP_STATUS.get(e.code, 400), e.code, str(e))
        except GatewayError as e:
            self._send_gateway_error(e)
        except BrokenPipeError:
            pass
        except Exception as e:  # noqa: BLE001 - boundary: never leak a traceback
            self._send_error(500, "internal", f"{type(e).__name__}: {e}")
        finally:
            route = self._route()
            dt = time.perf_counter() - t0
            _M_REQUESTS.labels(route=route).inc()
            _M_REQUEST_SECONDS.labels(route=route).observe(dt)
            status = getattr(self, "_last_status", None)
            if status is not None and not _REG.disabled:
                self.gateway.slo.record(route, dt, ok=status < 500)

    def _send_exemplars(self, query: str) -> None:
        """GET /v1/debug/exemplars[?route=/v1/query]: retained span trees
        of the slowest/error requests, cross-referenced by trace id."""
        route = (parse_qs(query).get("route") or [None])[0]
        if route is not None and route not in _ROUTES:
            raise UnknownRouteError(
                f"unknown route {route!r} (this gateway serves "
                f"{', '.join(_ROUTES)})"
            )
        ex = self.gateway.exemplars
        snap = (ex.snapshot(route) if ex is not None
                else {"slow_n": 0, "max_errors": 0, "routes": {}})
        self._send(200, wire.encode_exemplars_response(snap))

    def _capture(self) -> bool:
        """Whether this request should record an internal span tree for
        the tail-exemplar ring even though the client didn't ask for one
        (never perturbs response bytes; disabled with the kill switch so
        the obs-overhead A/B measures the whole capture path)."""
        return self.gateway.exemplars is not None and not _REG.disabled

    def _answer_query(self, data: bytes) -> None:
        """POST /v1/query: the one route with opt-in tracing. Untraced
        requests encode with ``trace=None`` -- the exact pre-tracing
        bytes (byte-identity) -- even when exemplar capture forces an
        *internal* span tree; traced requests return the tree in the
        (additive) ``trace`` envelope field, under the echoed/minted
        trace id."""
        request, artifact, route_sel, traced, env_ms = \
            wire.decode_request_full(data)
        deadline = self._request_deadline(env_ms)
        tid = _clean_trace_id(self.headers.get(TRACE_HEADER))
        self._ex_tid = tid
        tree = None
        with deadline_scope(deadline):
            if traced or self._capture():
                with trace("gateway.request", trace_id=tid,
                           route="/v1/query") as root:
                    response = self.gateway.query(
                        request, artifact=artifact, route=route_sel
                    )
                tree = root.root_tree()  # complete only after the root closes
            else:
                response = self.gateway.query(
                    request, artifact=artifact, route=route_sel
                )
        self._ex_tree = tree
        with _M_ENCODE_SECONDS.time():
            body = wire.encode_response(response, trace=tree if traced else None)
        self._send(200, body, headers={TRACE_HEADER: tid})
        self.gateway._note_bytes(response.artifact_key, len(body))

    def _answer_route(self, data: bytes) -> None:
        """POST /v1/route: canonical-byte answers like /v1/query (the
        portfolio byte-identity surface); degraded fallback answers are
        still HTTP 200 -- ``degraded: true`` rides in the payload."""
        request, artifact, route_sel, env_ms = wire.decode_route_request_full(data)
        deadline = self._request_deadline(env_ms)
        tid = _clean_trace_id(self.headers.get(TRACE_HEADER))
        self._ex_tid = tid
        with deadline_scope(deadline):
            if self._capture():
                with trace("gateway.request", trace_id=tid,
                           route="/v1/route") as root:
                    response = self.gateway.route(
                        request, artifact=artifact, route=route_sel
                    )
                self._ex_tree = root.root_tree()
            else:
                response = self.gateway.route(
                    request, artifact=artifact, route=route_sel
                )
        with _M_ENCODE_SECONDS.time():
            body = wire.encode_route_response(response)
        self._send(200, body, headers={TRACE_HEADER: tid})
        self.gateway._note_bytes(response.portfolio_key, len(body))

    def _answer_query_many(self, data: bytes) -> None:
        """POST /v1/query_many: an envelope-level deadline bounds the
        whole batch (elements past the budget classify as
        ``deadline_exceeded`` pairs; the batch itself still answers 200)."""
        queries, env_ms = wire.decode_request_many_full(data)
        deadline = self._request_deadline(env_ms)
        tid = _clean_trace_id(self.headers.get(TRACE_HEADER))
        self._ex_tid = tid
        with deadline_scope(deadline):
            if self._capture():
                with trace("gateway.request", trace_id=tid,
                           route="/v1/query_many") as root:
                    results = self.gateway.query_many(queries)
                self._ex_tree = root.root_tree()
            else:
                results = self.gateway.query_many(queries)
        self._send(200, wire.encode_response_many(results),
                   headers={TRACE_HEADER: tid})

    def do_POST(self) -> None:  # noqa: N802
        t0 = time.perf_counter()
        self._last_status: Optional[int] = None
        self._ex_tid: Optional[str] = None
        self._ex_tree: Optional[Dict[str, Any]] = None
        self._ex_code: Optional[str] = None
        client_token = _CLIENT_BUCKET.set(
            self.headers.get(CLIENT_HEADER) or self.client_address[0]
        )
        try:
            # always drain the body first: with keep-alive, unread body
            # bytes would be misparsed as the connection's next request line
            length = int(self.headers.get("Content-Length", 0))
            data = self.rfile.read(length)
            if faults.should_drop("gateway.drop_socket"):
                # chaos hook: abandon the connection without a response --
                # the client sees a reset/EOF (the retryable failure its
                # RetryPolicy is built for). Armed only via fault injection.
                self.close_connection = True
                return
            if self.path == "/v1/refresh":
                n = self.gateway.refresh()
                self._send(200, json.dumps({"ok": True, "artifacts": n}).encode())
                return
            if self.path not in ("/v1/query", "/v1/query_many", "/v1/route"):
                self._send_error(wire.ERROR_HTTP_STATUS["not_found"], "not_found",
                             f"no such endpoint {self.path!r}")
                return
            # admission control guards only the query routes (health,
            # metrics and refresh must stay reachable under overload --
            # they are how an operator sees the overload)
            res = self.gateway.resilience
            if res is not None:
                client = self.headers.get(CLIENT_HEADER) or self.client_address[0]
                admit = res.admission.admit(client)
            else:
                admit = contextlib.nullcontext()
            with admit:
                if self.path == "/v1/query_many":
                    self._answer_query_many(data)
                elif self.path == "/v1/route":
                    self._answer_route(data)
                else:
                    self._answer_query(data)
        except wire.WireError as e:
            self._send_error(
                wire.ERROR_HTTP_STATUS.get(e.code, 400), e.code, str(e)
            )
        except GatewayError as e:
            self._send_gateway_error(e)
        except (KeyError, ValueError) as e:
            # engine-level rejections (unknown stencil, bad shapes, bad
            # selector names): the request is at fault, not the server
            msg = e.args[0] if e.args else str(e)
            self._send_error(400, "bad_request", str(msg))
        except BrokenPipeError:  # client went away mid-answer
            pass
        except Exception as e:  # noqa: BLE001 - boundary: never leak a traceback
            self._send_error(500, "internal", f"{type(e).__name__}: {e}")
        finally:
            _CLIENT_BUCKET.reset(client_token)
            route = self._route()
            dt = time.perf_counter() - t0
            _M_REQUESTS.labels(route=route).inc()
            _M_REQUEST_SECONDS.labels(route=route).observe(dt)
            status = getattr(self, "_last_status", None)
            if status is not None and not _REG.disabled:
                gw = self.gateway
                gw.slo.record(route, dt, ok=status < 500)
                if gw.exemplars is not None and (
                    route in _EXEMPLAR_ROUTES or status >= 400
                ):
                    tid = self._ex_tid or _clean_trace_id(
                        self.headers.get(TRACE_HEADER)
                    )
                    gw.exemplars.offer(
                        route, tid, dt, status,
                        code=self._ex_code, trace=self._ex_tree,
                    )


class GatewayHTTPServer(ThreadingHTTPServer):
    """Threaded HTTP front end over one :class:`Gateway` (stdlib only).

    One thread per connection; threads answering the same artifact
    rendezvous inside that artifact's ``CodesignServer`` microbatch.
    ``daemon_threads`` keeps shutdown prompt. The listen backlog matches
    the default in-flight watermark (128): the stdlib's 5 resets a burst
    of concurrent connects before admission control can see them (the
    JAX package keeps 5)."""

    daemon_threads = True
    request_queue_size = 128

    def __init__(self, address, gateway: Gateway):
        super().__init__(address, _Handler)
        self.gateway = gateway


def serve_http(
    gateway: Gateway, host: str = "127.0.0.1", port: int = 0
) -> GatewayHTTPServer:
    """Bind (``port=0`` picks a free one -- see ``server_address``) and
    return the server; the caller drives ``serve_forever()``, typically on
    a daemon thread (tests, benchmarks) or the main thread (the CLI)."""
    return GatewayHTTPServer((host, port), gateway)
