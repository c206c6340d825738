"""Thin HTTP client for a codesign gateway (stdlib only).

The client is a pure transport shim: it encodes with
:mod:`repro_torch.service.wire`, POSTs, and decodes -- so a
:class:`~repro_torch.service.query.QueryResponse` obtained here is the same
object (field for field, and on the wire byte for byte) the in-process
:class:`~repro_torch.service.server.CodesignServer` would have returned.

    from repro_torch.service import GatewayClient, QueryRequest

    c = GatewayClient("http://127.0.0.1:8932")
    c.artifacts()                                   # routing index rows
    c.query(QueryRequest(freqs={"heat2d": 1.0}),    # routed by selector
            route={"gpu": "titanx"})
    c.query_many([(QueryRequest(freqs={"heat2d": 1.0}), None, {"gpu": "titanx"}),
                  (QueryRequest(freqs={"jacobi2d": 1.0}), None, {"gpu": "gtx980"})])

Transport: one persistent ``http.client.HTTPConnection`` per client,
reused across requests (the gateway speaks HTTP/1.1 keep-alive). The
previous ``urllib`` implementation opened a fresh TCP connection per
request -- connection setup was most of the JAX package's measured
~7-10x wire tax. A request that fails on a *reused*
connection (the server closed its keep-alive side) is retried once on a
fresh connection; a fresh-connection failure propagates. ``keepalive=
False`` restores the connection-per-request behavior for A/B measurement.

Structured gateway failures raise :class:`repro_torch.service.wire.RemoteError`
with the server's error ``code`` (``unknown_artifact``, ``bad_request``,
``ambiguous_route``, ``internal``); transport-level failures surface as
``urllib.error.URLError`` (the exception type callers already handle).
The client is thread-compatible (an internal lock serializes requests);
use one client per thread for parallelism.

**Retries** (``docs/resilience.md``): by default the client retries
*idempotent* failures -- HTTP 429/503 (the gateway's ``rate_limited`` /
``shed`` / ``circuit_open`` / ``build_lock_timeout`` answers, honoring
``Retry-After``) and connection resets (the request provably never
produced a response) -- under a bounded exponential-backoff-with-jitter
:class:`~repro_torch.service.resilience.RetryPolicy`. Timeouts are **never**
retried: a timed-out request may still be executing server-side, and
re-sending would double both the wait and the server's work. Pass
``retry=None`` to disable, or your own policy to tune; ``sleep`` and
``rng`` are injectable so tests assert the backoff schedule without
sleeping.
"""

from __future__ import annotations

import http.client
import json
import random
import threading
import time
import urllib.error
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple, Union
from urllib.parse import urlsplit

from . import wire
from .portfolio import RouteRequest, RouteResponse
from .query import QueryRequest, QueryResponse
from .resilience import RetryPolicy
from repro_torch.obs.trace import TRACE_HEADER

__all__ = ["GatewayClient"]

#: HTTP statuses the retry policy may re-send: the gateway only answers
#: these for requests it REFUSED to start (rate_limited / shed /
#: circuit_open / build_lock_timeout), so a retry can never double work.
_RETRYABLE_STATUSES = frozenset({429, 503})


def _retryable_exception(exc: BaseException) -> bool:
    """True for transport failures where the request provably never got a
    response: connection reset / aborted / broken pipe (including
    ``http.client.RemoteDisconnected``, a ``ConnectionResetError``
    subclass). Timeouts are excluded by construction -- ``TimeoutError``
    is not in this family -- as is ``ConnectionRefusedError`` (the server
    is down; backoff won't bring it up and callers should fail fast)."""
    return isinstance(
        exc, (ConnectionResetError, ConnectionAbortedError, BrokenPipeError)
    ) and not isinstance(exc, TimeoutError)


class GatewayClient:
    """Client for one gateway base URL (e.g. ``http://host:port``).

    Parameters
    ----------
    retry:
        The :class:`~repro_torch.service.resilience.RetryPolicy` for idempotent
        failures (the default sentinel builds the stock policy: 3 retries,
        50ms base, 2s cap, full jitter); ``None`` disables retries.
    sleep / rng:
        Injection points for the backoff sleep and jitter randomness
        (tests pass a recording fake and a seeded ``random.Random``).
    """

    def __init__(
        self,
        base_url: str,
        timeout: float = 30.0,
        keepalive: bool = True,
        retry: Union[RetryPolicy, None, str] = "default",
        sleep=time.sleep,
        rng: Optional[random.Random] = None,
    ):
        parts = urlsplit(base_url if "//" in base_url else f"http://{base_url}")
        if parts.scheme not in ("http", "https"):
            raise ValueError(f"unsupported URL scheme {parts.scheme!r} in {base_url!r}")
        if not parts.hostname:
            raise ValueError(f"no host in gateway URL {base_url!r}")
        self.base_url = base_url.rstrip("/")
        self.timeout = float(timeout)
        self.keepalive = bool(keepalive)
        self._host = parts.hostname
        self._port = parts.port  # None -> scheme default
        self._path_prefix = parts.path.rstrip("/")
        self._conn_cls = (
            http.client.HTTPSConnection if parts.scheme == "https"
            else http.client.HTTPConnection
        )
        self._conn: Optional[http.client.HTTPConnection] = None
        self._mu = threading.Lock()
        self._last_status = 0  # HTTP status of the most recent call
        self._last_trace_id = ""  # X-Repro-Trace echoed by the most recent call
        if retry == "default":
            retry = RetryPolicy()
        self.retry: Optional[RetryPolicy] = retry
        self._sleep = sleep
        self._rng = rng if rng is not None else random.Random()
        self.stats: Dict[str, int] = {"retries": 0}

    # ---- transport --------------------------------------------------------
    def _drop(self) -> None:
        if self._conn is not None:
            try:
                self._conn.close()
            except OSError:
                pass
            self._conn = None

    def close(self) -> None:
        """Drop the persistent connection (idempotent)."""
        with self._mu:
            self._drop()

    def __enter__(self) -> "GatewayClient":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def _request(
        self,
        path: str,
        body: Optional[bytes] = None,
        headers: Optional[Mapping[str, str]] = None,
    ) -> Tuple[bytes, int]:
        """One request; returns ``(raw body, HTTP status)``. HTTP error
        statuses still carry wire payloads -- the body is returned (not
        raised) so the decoder can surface the server's structured code.
        The status is *returned* rather than read back from shared state:
        two threads sharing a client must never pair one request's body
        with the other's status.

        This is also where the retry policy lives: idempotent failures
        (connection reset before any response; 429/503 refusals, honoring
        the ``Retry-After`` hint) re-send under bounded backoff. Every
        request is re-sent from its original ``body`` bytes, so a retried
        answer is byte-identical to a first-try answer."""
        method = "POST" if body is not None else "GET"
        hdrs = {"Content-Type": "application/json", **(headers or {})}
        policy = self.retry
        with self._mu:
            tries = 0  # policy retries consumed (stale-socket retry is free)
            while True:
                try:
                    data, status, retry_after = self._exchange(
                        method, path, body, hdrs
                    )
                except urllib.error.URLError as e:
                    reason = e.reason if isinstance(
                        getattr(e, "reason", None), BaseException
                    ) else e
                    if (
                        policy is not None
                        and tries < policy.max_retries
                        and _retryable_exception(reason)
                    ):
                        tries += 1
                        self.stats["retries"] += 1
                        self._sleep(policy.delay(tries, self._rng))
                        continue
                    raise
                if (
                    policy is not None
                    and status in _RETRYABLE_STATUSES
                    and tries < policy.max_retries
                ):
                    tries += 1
                    self.stats["retries"] += 1
                    self._sleep(
                        policy.delay(tries, self._rng, retry_after_s=retry_after)
                    )
                    continue
                return data, status

    def _exchange(
        self,
        method: str,
        path: str,
        body: Optional[bytes],
        hdrs: Dict[str, str],
    ) -> Tuple[bytes, int, Optional[float]]:
        """One HTTP exchange (with the free stale-keep-alive retry);
        returns ``(body, status, Retry-After seconds or None)``. Caller
        holds ``_mu``."""
        for attempt in (0, 1):
            reused = self._conn is not None
            conn = self._conn or self._conn_cls(
                self._host, self._port, timeout=self.timeout
            )
            self._conn = None
            try:
                conn.request(method, self._path_prefix + path, body, hdrs)
                resp = conn.getresponse()
                data = resp.read()
                self._last_status = resp.status
                self._last_trace_id = resp.getheader(TRACE_HEADER, "")
            except (http.client.HTTPException, OSError) as e:
                try:
                    conn.close()
                except OSError:
                    pass
                # this retry covers ONLY a stale keep-alive socket (server
                # closed its side: reset/EOF before a response). A
                # timeout is not staleness -- re-sending would double
                # both the effective timeout and the server's work.
                if reused and attempt == 0 and not isinstance(e, TimeoutError):
                    continue
                raise urllib.error.URLError(e) from e
            if self.keepalive and not resp.will_close:
                self._conn = conn
            else:
                conn.close()
            ra_raw = resp.getheader("Retry-After")
            try:
                retry_after = float(ra_raw) if ra_raw else None
            except ValueError:
                retry_after = None  # HTTP-date form: fall back to backoff
            return data, resp.status, retry_after
        raise AssertionError("unreachable")  # pragma: no cover

    def _http(self, path: str, body: Optional[bytes] = None) -> bytes:
        """Body-only transport entry point (kept for callers that pair it
        with :attr:`_last_status` single-threadedly, e.g. smoke scripts)."""
        return self._request(path, body)[0]

    def query_bytes(
        self,
        request: QueryRequest,
        artifact: Optional[str] = None,
        route: Optional[Mapping[str, Any]] = None,
    ) -> bytes:
        """The raw response body for one query -- the byte-identity tests'
        entry point (no decode/re-encode in between)."""
        return self._http(
            "/v1/query", wire.encode_request(request, artifact=artifact, route=route)
        )

    def query_many_bytes(
        self,
        queries: Sequence[
            Tuple[QueryRequest, Optional[str], Optional[Mapping[str, Any]]]
        ],
    ) -> bytes:
        """Raw ``/v1/query_many`` body (byte-identity entry point)."""
        return self._http("/v1/query_many", wire.encode_request_many(queries))

    def route_bytes(
        self,
        request: RouteRequest,
        artifact: Optional[str] = None,
        route: Optional[Mapping[str, Any]] = None,
    ) -> bytes:
        """Raw ``/v1/route`` body (the portfolio byte-identity tests'
        entry point)."""
        return self._http(
            "/v1/route",
            wire.encode_route_request(request, artifact=artifact, route=route),
        )

    # ---- API --------------------------------------------------------------
    def query(
        self,
        request: QueryRequest,
        artifact: Optional[str] = None,
        route: Optional[Mapping[str, Any]] = None,
        deadline_ms: Optional[float] = None,
    ) -> QueryResponse:
        """Answer one request over HTTP; raises
        :class:`~repro_torch.service.wire.RemoteError` on structured failures.
        ``deadline_ms`` rides the request envelope: the gateway abandons
        the request (HTTP 504, code ``deadline_exceeded``) once the budget
        is spent. The budget is per attempt, not across retries."""
        body, status = self._request(
            "/v1/query",
            wire.encode_request(
                request, artifact=artifact, route=route, deadline_ms=deadline_ms
            ),
        )
        return wire.decode_response(body, http_status=status)

    def route(
        self,
        request: Union[RouteRequest, str],
        artifact: Optional[str] = None,
        route: Optional[Mapping[str, Any]] = None,
        deadline_ms: Optional[float] = None,
    ) -> RouteResponse:
        """Route one workload cell through a portfolio artifact
        (``POST /v1/route``). ``request`` may be a bare cell label for
        convenience; ``artifact``/``route`` resolve the portfolio the
        same way :meth:`query` resolves a sweep (but among ``kind:
        "portfolio"`` manifests)."""
        if isinstance(request, str):
            request = RouteRequest(cell=request)
        body, status = self._request(
            "/v1/route",
            wire.encode_route_request(
                request, artifact=artifact, route=route, deadline_ms=deadline_ms
            ),
        )
        return wire.decode_route_response(body, http_status=status)

    def query_traced(
        self,
        request: QueryRequest,
        artifact: Optional[str] = None,
        route: Optional[Mapping[str, Any]] = None,
        trace_id: Optional[str] = None,
    ) -> Tuple[QueryResponse, Optional[Dict[str, Any]]]:
        """Like :meth:`query` but with ``"trace": true`` in the envelope:
        returns ``(response, span_tree)`` where the span tree is the
        gateway's ``gateway.request`` root (``trace_id``, ``dur_us``,
        nested ``children``) for THIS request. Pass ``trace_id`` to
        correlate with client-side logs; otherwise the gateway mints one
        (echoed in the ``X-Repro-Trace`` response header, readable via
        :attr:`last_trace_id`). Tracing adds a ``"trace"`` field to the
        response envelope, so the bytes intentionally differ from an
        untraced answer; the decoded :class:`QueryResponse` is identical."""
        hdrs = {TRACE_HEADER: trace_id} if trace_id else None
        body, status = self._request(
            "/v1/query",
            wire.encode_request(request, artifact=artifact, route=route, trace=True),
            headers=hdrs,
        )
        return wire.decode_response_traced(body, http_status=status)

    @property
    def last_trace_id(self) -> str:
        """``X-Repro-Trace`` from the most recent response (empty before
        the first call). Single-threaded pairing only, like
        ``_last_status``."""
        return self._last_trace_id

    def metrics(self, fmt: str = "json") -> Union[Dict[str, Any], str]:
        """Scrape ``GET /v1/metrics``: ``fmt="json"`` returns the decoded
        snapshot dict, ``fmt="prometheus"`` the text exposition as str."""
        if fmt == "json":
            return self._json("/v1/metrics?format=json")
        raw, status = self._request(f"/v1/metrics?format={fmt}")
        if not 200 <= status < 300:
            raise wire.RemoteError(
                "bad_request", raw[:200].decode("utf-8", "replace"), status
            )
        return raw.decode("utf-8")

    def slo(self, fmt: str = "json") -> Union[Dict[str, Any], str]:
        """Scrape ``GET /v1/slo``: ``fmt="json"`` returns the decoded
        burn-rate report (see :class:`repro_torch.obs.slo.SLOTracker.report`),
        ``fmt="prometheus"`` the gauge-only text exposition as str."""
        if fmt == "json":
            raw, status = self._request("/v1/slo?format=json")
            return wire.decode_slo_response(raw, http_status=status)
        raw, status = self._request(f"/v1/slo?format={fmt}")
        if not 200 <= status < 300:
            raise wire.RemoteError(
                "bad_request", raw[:200].decode("utf-8", "replace"), status
            )
        return raw.decode("utf-8")

    def exemplars(self, route: Optional[str] = None) -> Dict[str, Any]:
        """Fetch the tail-exemplar rings (``GET /v1/debug/exemplars``):
        slowest-N span trees plus the recent-error ring, per route. Pass
        ``route`` to filter to one route's rings (an unknown route raises
        :class:`~repro_torch.service.wire.RemoteError` code ``unknown_route``)."""
        path = "/v1/debug/exemplars"
        if route is not None:
            from urllib.parse import quote

            path += f"?route={quote(route, safe='')}"
        raw, status = self._request(path)
        return wire.decode_exemplars_response(raw, http_status=status)

    def query_many(
        self,
        queries: Sequence[
            Union[
                QueryRequest,
                Tuple[QueryRequest, Optional[str], Optional[Mapping[str, Any]]],
            ]
        ],
        artifact: Optional[str] = None,
        route: Optional[Mapping[str, Any]] = None,
        deadline_ms: Optional[float] = None,
    ) -> List[Union[QueryResponse, wire.RemoteError]]:
        """Answer N queries in one HTTP round trip (``POST
        /v1/query_many``). Each element is a bare :class:`QueryRequest`
        (routed by the shared ``artifact``/``route`` arguments) or an
        explicit ``(request, artifact, route)`` triple. Per-query failures
        come back as :class:`~repro_torch.service.wire.RemoteError` *values* in
        the result list -- only envelope-level failures raise. Batches
        larger than the wire cap (:data:`wire.MAX_BATCH`) are split
        transparently into consecutive round trips, results concatenated
        in input order; an envelope-level failure of a *later* chunk is
        reported as that chunk's per-query errors rather than raised, so
        earlier chunks' completed answers are never discarded (only a
        first-chunk envelope failure raises, matching the single-request
        contract)."""
        triples = [
            q if isinstance(q, tuple) else (q, artifact, route) for q in queries
        ]
        out: List[Union[QueryResponse, wire.RemoteError]] = []
        for lo in range(0, len(triples), wire.MAX_BATCH):
            chunk = triples[lo : lo + wire.MAX_BATCH]
            try:
                body, status = self._request(
                    "/v1/query_many",
                    wire.encode_request_many(chunk, deadline_ms=deadline_ms),
                )
                out.extend(wire.decode_response_many(body, http_status=status))
            except wire.RemoteError as e:
                if lo == 0:
                    raise
                out.extend([e] * len(chunk))
            except (wire.WireError, urllib.error.URLError) as e:
                # transport died / undecodable envelope mid-way: the same
                # rule -- answered chunks are never discarded
                if lo == 0:
                    raise
                err = wire.RemoteError("transport_error", str(e), 0)
                out.extend([err] * len(chunk))
        return out

    def _json(self, path: str, body: Optional[bytes] = None) -> Dict[str, Any]:
        """GET/POST a JSON endpoint; a non-2xx answer raises the server's
        structured error as :class:`RemoteError` instead of a KeyError on
        the missing success fields."""
        raw, status = self._request(path, body)
        if not 200 <= status < 300:
            try:
                err = json.loads(raw).get("error") or {}
            except ValueError:
                err = {}
            raise wire.RemoteError(
                str(err.get("code", "unknown")),
                str(err.get("message", raw[:200].decode("utf-8", "replace"))),
                status,
            )
        return json.loads(raw)

    def artifacts(self) -> List[Dict[str, Any]]:
        """Routing rows for every artifact the gateway serves."""
        return self._json("/v1/artifacts")["artifacts"]

    def health(self) -> Dict[str, Any]:
        return self._json("/v1/healthz")

    def refresh(self) -> int:
        """Ask the gateway to re-scan its store roots; returns the indexed
        artifact count."""
        return self._json("/v1/refresh", b"")["artifacts"]
