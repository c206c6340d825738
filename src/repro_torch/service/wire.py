"""Versioned HTTP/JSON wire codec for the codesign query service.

This module is the single source of truth for how a
:class:`repro_torch.service.query.QueryRequest` and its
:class:`~repro_torch.service.query.QueryResponse` cross a process boundary.
Everything else (the gateway's HTTP handler, the thin client, the CLI's
``--url`` mode, the CI smoke lane) encodes and decodes through these four
functions, so the in-process objects and the wire can never drift apart:

* :func:`encode_request` / :func:`decode_request` -- request envelope
  (``{"v", "artifact", "route", "request"}`` plus two optional fields:
  a ``"trace": true`` observability opt-in and a ``"deadline_ms"`` time
  budget, surfaced by :func:`decode_request_traced` /
  :func:`decode_request_full`);
* :func:`encode_response` / :func:`decode_response` -- response envelope
  (``{"v", "ok", "response"}`` on success, ``{"v", "ok", "error"}`` on
  failure; a traced request's answer additionally carries ``"trace"``,
  read back by :func:`decode_response_traced`);
* :func:`encode_error` -- structured error payloads (``code`` +
  ``message``), never tracebacks.

Design rules (documented for clients in ``docs/serving.md``):

* **Canonical bytes.** Encoders emit ``sort_keys=True`` +
  ``separators=(",", ":")`` JSON, and Python's ``repr``-based float
  serialization round-trips every float64 exactly. Encoding is therefore
  deterministic: the same ``QueryResponse`` always produces the same
  bytes, which is what lets tests (and the CI smoke lane) assert that an
  HTTP answer is *byte-identical* to the in-process answer.
* **Non-finite floats.** Strict JSON has no ``inf``/``nan``, but the
  service's contract does (``best_gflops = -inf`` means "no feasible
  design"). Non-finite floats are encoded as a tagged object
  ``{"$f": "inf" | "-inf" | "nan"}`` and decoded back to the exact float.
* **Versioning.** Every envelope carries ``"v": WIRE_VERSION``. A server
  rejects requests whose major version it does not speak
  (``unsupported_version``); a *client* decoding a response tolerates
  unknown **response** fields (servers may add fields within a version),
  while a *server* rejects unknown **request** fields (a typo'd field
  silently ignored would answer the wrong question).
"""

from __future__ import annotations

import dataclasses
import json
import math
from typing import Any, Dict, Mapping, Optional, Sequence, Tuple, Union

import numpy as np

from .errors import ERROR_HTTP_STATUS  # noqa: F401  (re-export: THE registry)
from .portfolio import RouteRequest, RouteResponse
from .query import QueryRequest, QueryResponse

__all__ = [
    "WIRE_VERSION",
    "MAX_BATCH",
    "ERROR_HTTP_STATUS",
    "WireError",
    "RemoteError",
    "encode_request",
    "decode_request",
    "decode_request_traced",
    "decode_request_full",
    "encode_request_many",
    "decode_request_many",
    "decode_request_many_full",
    "encode_response",
    "decode_response",
    "decode_response_traced",
    "encode_response_many",
    "decode_response_many",
    "encode_route_request",
    "decode_route_request",
    "decode_route_request_full",
    "encode_route_response",
    "decode_route_response",
    "encode_slo_response",
    "decode_slo_response",
    "encode_exemplars_response",
    "decode_exemplars_response",
    "encode_error",
]

#: Wire (envelope) version. Bump only for incompatible envelope changes;
#: additive response fields do NOT bump it (clients ignore unknowns).
#: Adding the /v1/query_many envelope was additive (new endpoint, same
#: per-query objects), so it did not bump the version.
WIRE_VERSION = 1

#: upper bound on queries per /v1/query_many envelope: a fat-finger guard
#: (a million-query body would be decoded before any answer could say no),
#: not a throughput ceiling -- clients chunk above it.
MAX_BATCH = 1024

# ERROR_HTTP_STATUS -- THE code -> HTTP status registry -- is defined in
# the dependency-leaf :mod:`repro_torch.service.errors` (the store needs it too
# and cannot import this module) and re-exported here unchanged: clients
# keep reading ``wire.ERROR_HTTP_STATUS``. One table, both directions:
# adding an error code means adding it THERE.

#: request fields a v1 server accepts, mirroring QueryRequest exactly.
_REQUEST_FIELDS = frozenset(f.name for f in dataclasses.fields(QueryRequest))

#: route-request fields, mirroring RouteRequest exactly (same strictness).
_ROUTE_REQUEST_FIELDS = frozenset(f.name for f in dataclasses.fields(RouteRequest))


class WireError(ValueError):
    """A request that cannot be decoded (malformed JSON, wrong types,
    unknown fields, unsupported version). Maps to HTTP 400."""

    def __init__(self, message: str, code: str = "bad_request"):
        super().__init__(message)
        self.code = code


class RemoteError(RuntimeError):
    """A structured error answer from a gateway (the client-side mirror of
    :func:`encode_error`); carries the server's ``code`` and HTTP status."""

    def __init__(self, code: str, message: str, http_status: int = 0):
        super().__init__(f"[{code}] {message}")
        self.code = code
        self.message = message
        self.http_status = http_status


# ---------------------------------------------------------------------------
# float / array tagging
# ---------------------------------------------------------------------------
_NONFINITE = {"inf": math.inf, "-inf": -math.inf}


def _jsonify(obj: Any) -> Any:
    """Recursively convert to strict-JSON-safe values: numpy scalars/arrays
    to native, non-finite floats to ``{"$f": ...}`` tags."""
    if isinstance(obj, (np.floating, np.integer)):
        obj = obj.item()
    if isinstance(obj, float):
        if math.isfinite(obj):
            return obj
        if math.isnan(obj):
            return {"$f": "nan"}
        return {"$f": "inf" if obj > 0 else "-inf"}
    if isinstance(obj, np.ndarray):
        return [_jsonify(x) for x in obj.tolist()]
    if isinstance(obj, dict):
        return {str(k): _jsonify(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_jsonify(x) for x in obj]
    return obj


def _unjsonify(obj: Any) -> Any:
    """Invert :func:`_jsonify` (tags back to floats)."""
    if isinstance(obj, dict):
        if set(obj) == {"$f"}:
            tag = obj["$f"]
            if tag == "nan":
                return math.nan
            if tag in _NONFINITE:
                return _NONFINITE[tag]
            raise WireError(f"unknown non-finite float tag {tag!r}")
        return {k: _unjsonify(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_unjsonify(x) for x in obj]
    return obj


def _dumps(obj: Any) -> bytes:
    return json.dumps(
        _jsonify(obj), sort_keys=True, separators=(",", ":"), allow_nan=False
    ).encode()


def _loads(data: bytes) -> Any:
    try:
        return json.loads(data.decode("utf-8"))
    except (UnicodeDecodeError, json.JSONDecodeError) as e:
        raise WireError(f"malformed JSON: {e}") from e


def _check_version(obj: Any, what: str) -> None:
    if not isinstance(obj, dict):
        raise WireError(f"{what} must be a JSON object, got {type(obj).__name__}")
    v = obj.get("v")
    if v != WIRE_VERSION:
        raise WireError(
            f"unsupported wire version {v!r} (this endpoint speaks v{WIRE_VERSION})",
            code="unsupported_version",
        )


# ---------------------------------------------------------------------------
# requests
# ---------------------------------------------------------------------------
def encode_request(
    request: QueryRequest,
    artifact: Optional[str] = None,
    route: Optional[Mapping[str, Any]] = None,
    trace: bool = False,
    deadline_ms: Optional[float] = None,
) -> bytes:
    """Serialize one query. ``artifact`` pins a content-address key;
    ``route`` is a routing selector the gateway resolves (e.g.
    ``{"gpu": "titanx"}``); both ``None`` is valid on a one-artifact
    gateway. ``trace=True`` asks the gateway to record spans for this
    request and return the span tree in the response envelope (see
    ``docs/observability.md``); ``deadline_ms`` is the caller's total
    time budget -- the gateway fails stages past it with a structured
    ``deadline_exceeded`` instead of piling on (``docs/resilience.md``).
    Both fields are omitted entirely when unset so capable clients emit
    byte-identical plain requests (and old servers, which reject unknown
    envelope fields, only ever see the fields the caller actually
    used)."""
    body: Dict[str, Any] = {
        "v": WIRE_VERSION,
        "request": dataclasses.asdict(request),
    }
    if artifact is not None:
        body["artifact"] = str(artifact)
    if route:
        body["route"] = dict(route)
    if trace:
        body["trace"] = True
    if deadline_ms is not None:
        body["deadline_ms"] = _check_deadline_ms(deadline_ms)
    return _dumps(body)


def _check_deadline_ms(value: Any) -> float:
    """Validate a ``deadline_ms`` budget (either side of the wire):
    a positive finite number, or WireError."""
    if isinstance(value, bool) or not isinstance(value, (int, float)):
        raise WireError(
            f"'deadline_ms' must be a positive number of milliseconds, "
            f"got {type(value).__name__}"
        )
    value = float(value)
    if not math.isfinite(value) or value <= 0:
        raise WireError(
            f"'deadline_ms' must be a positive finite number, got {value!r}"
        )
    return value


def decode_request(data: bytes) -> Tuple[QueryRequest, Optional[str], Optional[dict]]:
    """Bytes -> ``(QueryRequest, artifact_key, route)``.

    Raises :class:`WireError` on malformed JSON, a version this codec does
    not speak, non-object envelopes, or unknown request fields (strict on
    purpose: a silently dropped field would answer a different question
    than the client asked).
    """
    request, artifact, route, _ = decode_request_traced(data)
    return request, artifact, route


def decode_request_traced(
    data: bytes,
) -> Tuple[QueryRequest, Optional[str], Optional[dict], bool]:
    """Like :func:`decode_request` but also surfaces the envelope's
    optional ``trace`` flag as a fourth element (False when absent).
    In-process callers that don't care keep the 3-tuple
    :func:`decode_request`."""
    return decode_request_full(data)[:4]


def decode_request_full(
    data: bytes,
) -> Tuple[QueryRequest, Optional[str], Optional[dict], bool, Optional[float]]:
    """The whole v1 request envelope: ``(request, artifact, route,
    traced, deadline_ms)``. The HTTP handler decodes through this;
    ``deadline_ms`` is None when the caller set no budget."""
    obj = _loads(data)
    _check_version(obj, "request envelope")
    unknown = set(obj) - {"v", "artifact", "route", "request", "trace",
                          "deadline_ms"}
    if unknown:
        raise WireError(f"unknown envelope fields {sorted(unknown)}")
    traced = obj.get("trace", False)
    if not isinstance(traced, bool):
        raise WireError("'trace' must be a boolean")
    deadline_ms = obj.get("deadline_ms")
    if deadline_ms is not None:
        deadline_ms = _check_deadline_ms(deadline_ms)
    return (*_decode_query(obj), traced, deadline_ms)


def _decode_query(obj: dict) -> Tuple[QueryRequest, Optional[str], Optional[dict]]:
    """Shared body of the single and batched request decoders: one
    ``{artifact?, route?, request}`` object -> the routed-query triple."""
    artifact = obj.get("artifact")
    if artifact is not None and not isinstance(artifact, str):
        raise WireError("'artifact' must be a string key")
    route = obj.get("route")
    if route is not None and not isinstance(route, dict):
        raise WireError("'route' must be an object of selector: value pairs")
    req = obj.get("request")
    if not isinstance(req, dict):
        raise WireError("'request' must be an object (the QueryRequest fields)")
    req = _unjsonify(req)
    unknown = set(req) - _REQUEST_FIELDS
    if unknown:
        raise WireError(
            f"unknown request fields {sorted(unknown)} "
            f"(v{WIRE_VERSION} accepts {sorted(_REQUEST_FIELDS)})"
        )
    try:
        # coerce scalars so garbage fails HERE (bad_request) rather than
        # deep inside the engine -- and so a JSON "450" behaves like 450
        # instead of poisoning later comparisons with a str
        for name, conv in (("max_area", float), ("min_area", float),
                           ("top_k", int)):
            if name in req:
                req[name] = conv(req[name])
        for name in ("pareto", "use_cache"):
            if name in req and not isinstance(req[name], bool):
                raise WireError(f"{name!r} must be a boolean")
        request = QueryRequest(**req)
        if request.freqs is not None and not isinstance(request.freqs, dict):
            raise WireError("'freqs' must be an object of stencil: weight")
        if request.fix is not None and not isinstance(request.fix, dict):
            raise WireError("'fix' must be an object of param: value")
    except WireError:
        raise
    except (TypeError, ValueError) as e:
        raise WireError(f"bad request field: {e}") from e
    return request, artifact, route


def encode_request_many(
    queries: Sequence[
        Tuple[QueryRequest, Optional[str], Optional[Mapping[str, Any]]]
    ],
    deadline_ms: Optional[float] = None,
) -> bytes:
    """Serialize a ``POST /v1/query_many`` envelope: each element is a
    ``(request, artifact, route)`` triple exactly as :func:`encode_request`
    takes them, carried in one body so N queries cost one round trip.
    ``deadline_ms`` (optional, omitted when unset) budgets the whole
    batch, not each element."""
    items = []
    for request, artifact, route in queries:
        body: Dict[str, Any] = {"request": dataclasses.asdict(request)}
        if artifact is not None:
            body["artifact"] = str(artifact)
        if route:
            body["route"] = dict(route)
        items.append(body)
    envelope: Dict[str, Any] = {"v": WIRE_VERSION, "queries": items}
    if deadline_ms is not None:
        envelope["deadline_ms"] = _check_deadline_ms(deadline_ms)
    return _dumps(envelope)


def decode_request_many(
    data: bytes,
) -> list:
    """Bytes -> list of ``(QueryRequest, artifact_key, route)`` triples.

    Strict like :func:`decode_request`: one malformed query fails the
    whole envelope with the offending index in the message (a server must
    not answer a batch it only partially understood -- per-query *routing
    and engine* failures, by contrast, are reported per query)."""
    return decode_request_many_full(data)[0]


def decode_request_many_full(
    data: bytes,
) -> Tuple[list, Optional[float]]:
    """Like :func:`decode_request_many` but also surfaces the envelope's
    optional ``deadline_ms`` (the whole batch's budget; None when
    unset)."""
    obj = _loads(data)
    _check_version(obj, "request envelope")
    unknown = set(obj) - {"v", "queries", "deadline_ms"}
    if unknown:
        raise WireError(f"unknown envelope fields {sorted(unknown)}")
    deadline_ms = obj.get("deadline_ms")
    if deadline_ms is not None:
        deadline_ms = _check_deadline_ms(deadline_ms)
    queries = obj.get("queries")
    if not isinstance(queries, list) or not queries:
        raise WireError("'queries' must be a non-empty array of query objects")
    if len(queries) > MAX_BATCH:
        raise WireError(
            f"batch of {len(queries)} exceeds the {MAX_BATCH}-query cap; "
            "chunk the request"
        )
    out = []
    for i, q in enumerate(queries):
        if not isinstance(q, dict):
            raise WireError(f"queries[{i}] must be an object")
        unknown = set(q) - {"artifact", "route", "request"}
        if unknown:
            raise WireError(f"queries[{i}]: unknown fields {sorted(unknown)}")
        try:
            out.append(_decode_query(q))
        except WireError as e:
            raise WireError(f"queries[{i}]: {e}", code=e.code) from e
    return out, deadline_ms


# ---------------------------------------------------------------------------
# routing (POST /v1/route -- portfolio heterogeneity-aware routing)
# ---------------------------------------------------------------------------
def encode_route_request(
    request: RouteRequest,
    artifact: Optional[str] = None,
    route: Optional[Mapping[str, Any]] = None,
    deadline_ms: Optional[float] = None,
) -> bytes:
    """Serialize one ``POST /v1/route`` request. Same envelope shape as
    :func:`encode_request` (``artifact`` pins a portfolio's content key,
    ``route`` is a selector resolved among ``kind: "portfolio"``
    manifests, ``deadline_ms`` budgets the request); the ``request`` body
    carries the :class:`~repro_torch.service.portfolio.RouteRequest` fields."""
    body: Dict[str, Any] = {
        "v": WIRE_VERSION,
        "request": dataclasses.asdict(request),
    }
    if artifact is not None:
        body["artifact"] = str(artifact)
    if route:
        body["route"] = dict(route)
    if deadline_ms is not None:
        body["deadline_ms"] = _check_deadline_ms(deadline_ms)
    return _dumps(body)


def decode_route_request(
    data: bytes,
) -> Tuple[RouteRequest, Optional[str], Optional[dict]]:
    """Bytes -> ``(RouteRequest, artifact_key, route)`` (strict, like
    :func:`decode_request`)."""
    return decode_route_request_full(data)[:3]


def decode_route_request_full(
    data: bytes,
) -> Tuple[RouteRequest, Optional[str], Optional[dict], Optional[float]]:
    """The whole v1 route envelope: ``(request, artifact, route,
    deadline_ms)``; the HTTP handler decodes through this."""
    obj = _loads(data)
    _check_version(obj, "request envelope")
    unknown = set(obj) - {"v", "artifact", "route", "request", "deadline_ms"}
    if unknown:
        raise WireError(f"unknown envelope fields {sorted(unknown)}")
    deadline_ms = obj.get("deadline_ms")
    if deadline_ms is not None:
        deadline_ms = _check_deadline_ms(deadline_ms)
    artifact = obj.get("artifact")
    if artifact is not None and not isinstance(artifact, str):
        raise WireError("'artifact' must be a string key")
    route = obj.get("route")
    if route is not None and not isinstance(route, dict):
        raise WireError("'route' must be an object of selector: value pairs")
    req = obj.get("request")
    if not isinstance(req, dict):
        raise WireError("'request' must be an object (the RouteRequest fields)")
    unknown = set(req) - _ROUTE_REQUEST_FIELDS
    if unknown:
        raise WireError(
            f"unknown request fields {sorted(unknown)} "
            f"(v{WIRE_VERSION} route accepts {sorted(_ROUTE_REQUEST_FIELDS)})"
        )
    cell = req.get("cell")
    if not isinstance(cell, str) or not cell:
        raise WireError("'cell' must be a non-empty string cell label")
    return RouteRequest(cell=cell), artifact, route, deadline_ms


def _route_response_payload(response: RouteResponse) -> Dict[str, Any]:
    """Canonical JSON-able body of one routing decision. ``degraded`` and
    ``fallback_from`` are always present (not elided when falsy): a
    client must be able to distinguish "healthy answer" from "old server
    that predates degradation marking" without guessing."""
    return {
        "portfolio_key": response.portfolio_key,
        "sweep_key": response.sweep_key,
        "cell": response.cell,
        "cell_indices": [int(i) for i in response.cell_indices],
        "hw_index": int(response.hw_index),
        "member_slot": int(response.member_slot),
        "point": dict(response.point),
        "time_s": float(response.time_s),
        "gflops": float(response.gflops),
        "degraded": bool(response.degraded),
        "fallback_from": [int(i) for i in response.fallback_from],
    }


def encode_route_response(response: RouteResponse) -> bytes:
    """Serialize a routing answer (canonical bytes, same determinism
    contract as :func:`encode_response` -- the gateway's ``/v1/route``
    byte-identity test encodes the in-process answer through this)."""
    return _dumps(
        {"v": WIRE_VERSION, "ok": True, "response": _route_response_payload(response)}
    )


def decode_route_response(data: bytes, http_status: int = 0) -> RouteResponse:
    """Bytes -> :class:`~repro_torch.service.portfolio.RouteResponse`; a
    structured error envelope raises :class:`RemoteError`."""
    obj = _loads(data)
    _check_version(obj, "response envelope")
    if not obj.get("ok"):
        err = obj.get("error") or {}
        raise RemoteError(
            str(err.get("code", "unknown")),
            str(err.get("message", "(no message)")),
            http_status,
        )
    r = obj.get("response")
    if not isinstance(r, dict):
        raise WireError("'response' must be an object")
    r = _unjsonify(r)
    try:
        return RouteResponse(
            portfolio_key=str(r["portfolio_key"]),
            sweep_key=str(r["sweep_key"]),
            cell=str(r["cell"]),
            cell_indices=tuple(int(i) for i in r["cell_indices"]),
            hw_index=int(r["hw_index"]),
            member_slot=int(r["member_slot"]),
            point=dict(r["point"]),
            time_s=float(r["time_s"]),
            gflops=float(r["gflops"]),
            degraded=bool(r["degraded"]),
            fallback_from=tuple(int(i) for i in r["fallback_from"]),
        )
    except (KeyError, TypeError, ValueError) as e:
        raise WireError(f"bad route response field: {e}") from e


# ---------------------------------------------------------------------------
# responses / errors
# ---------------------------------------------------------------------------
def _response_payload(response: QueryResponse) -> Dict[str, Any]:
    """The canonical JSON-able body of one answer -- shared by the single
    and batched encoders so a query_many element is field-for-field the
    single-query payload (byte-identity composes)."""
    r: Dict[str, Any] = {
        "artifact_key": response.artifact_key,
        "best_index": int(response.best_index),
        "best_gflops": float(response.best_gflops),
        "best_weighted_time": float(response.best_weighted_time),
        "best_point": dict(response.best_point),
        "top_k": [dict(t) for t in response.top_k],
        "cached": bool(response.cached),
        "batch_size": int(response.batch_size),
    }
    if response.pareto_indices is not None:
        r["pareto_indices"] = [int(i) for i in np.asarray(response.pareto_indices)]
    if response.baseline_best_index is not None:
        r["baseline_best_index"] = int(response.baseline_best_index)
        r["baseline_best_gflops"] = float(response.baseline_best_gflops)
    return r


def encode_response(
    response: QueryResponse, trace: Optional[Mapping[str, Any]] = None
) -> bytes:
    """Serialize a success answer. Deterministic (canonical JSON), so two
    equal responses always encode to identical bytes -- the property the
    gateway's byte-identity acceptance test leans on. ``trace`` (a span
    tree from :meth:`repro_torch.obs.trace.Span.root_tree`) is attached as an
    additive envelope field only when the request opted in; with
    ``trace=None`` the bytes are exactly the pre-tracing encoding, which
    is what preserves byte-identity for untraced requests."""
    body: Dict[str, Any] = {
        "v": WIRE_VERSION, "ok": True, "response": _response_payload(response)
    }
    if trace is not None:
        body["trace"] = dict(trace)
    return _dumps(body)


def decode_response(data: bytes, http_status: int = 0) -> QueryResponse:
    """Bytes -> :class:`QueryResponse`. A structured error envelope raises
    :class:`RemoteError`; unknown *response* fields are ignored (additive
    server evolution within a wire version)."""
    return decode_response_traced(data, http_status)[0]


def decode_response_traced(
    data: bytes, http_status: int = 0
) -> Tuple[QueryResponse, Optional[dict]]:
    """Like :func:`decode_response` but also returns the envelope's
    ``trace`` span tree (None when the request didn't opt in -- or the
    server predates tracing; the field is additive either way)."""
    obj = _loads(data)
    _check_version(obj, "response envelope")
    if not obj.get("ok"):
        err = obj.get("error") or {}
        raise RemoteError(
            str(err.get("code", "unknown")),
            str(err.get("message", "(no message)")),
            http_status,
        )
    trace = obj.get("trace")
    if trace is not None and not isinstance(trace, dict):
        trace = None
    return _parse_response_payload(obj.get("response")), trace


def _parse_response_payload(r: Any) -> QueryResponse:
    """One decoded-JSON response object -> :class:`QueryResponse` (the
    inverse of :func:`_response_payload`); shared by the single and
    batched decoders."""
    if not isinstance(r, dict):
        raise WireError("'response' must be an object")
    r = _unjsonify(r)
    pareto = r.get("pareto_indices")
    return QueryResponse(
        artifact_key=r["artifact_key"],
        best_index=int(r["best_index"]),
        best_gflops=float(r["best_gflops"]),
        best_weighted_time=float(r["best_weighted_time"]),
        best_point=r["best_point"],
        top_k=list(r["top_k"]),
        pareto_indices=None if pareto is None else np.asarray(pareto, np.int64),
        baseline_best_index=r.get("baseline_best_index"),
        baseline_best_gflops=r.get("baseline_best_gflops"),
        cached=bool(r.get("cached", False)),
        batch_size=int(r.get("batch_size", 1)),
    )


def encode_response_many(
    results: Sequence[Union[QueryResponse, Tuple[str, str]]],
) -> bytes:
    """Serialize a ``/v1/query_many`` answer. Each element is either a
    :class:`QueryResponse` (``{"ok": true, "response": ...}`` with the
    exact single-query payload) or a ``(code, message)`` pair for a query
    that failed routing/decoding/reduction (``{"ok": false, "error":
    ...}``) -- one bad query never fails its batchmates. The envelope
    itself is HTTP 200: per-query status lives per element."""
    items = []
    for r in results:
        if isinstance(r, QueryResponse):
            items.append({"ok": True, "response": _response_payload(r)})
        else:
            code, message = r
            items.append(
                {"ok": False, "error": {"code": str(code), "message": str(message)}}
            )
    return _dumps({"v": WIRE_VERSION, "ok": True, "results": items})


def decode_response_many(
    data: bytes, http_status: int = 0
) -> list:
    """Bytes -> list of :class:`QueryResponse` | :class:`RemoteError`
    (per-query failures are *returned*, not raised -- the caller decides
    what a partial batch means). A whole-envelope error (malformed batch,
    unsupported version) still raises. Per-element errors carry the HTTP
    status their *code* maps to on the single-query endpoint (the
    envelope itself is 200), so ``RemoteError.http_status`` means the
    same thing whichever endpoint produced it."""
    obj = _loads(data)
    _check_version(obj, "response envelope")
    if not obj.get("ok"):
        err = obj.get("error") or {}
        raise RemoteError(
            str(err.get("code", "unknown")),
            str(err.get("message", "(no message)")),
            http_status,
        )
    results = obj.get("results")
    if not isinstance(results, list):
        raise WireError("'results' must be an array")
    out = []
    for item in results:
        if not isinstance(item, dict):
            raise WireError("each query_many result must be an object")
        if item.get("ok"):
            out.append(_parse_response_payload(item.get("response")))
        else:
            err = item.get("error") or {}
            code = str(err.get("code", "unknown"))
            out.append(
                RemoteError(
                    code,
                    str(err.get("message", "(no message)")),
                    ERROR_HTTP_STATUS.get(code, 0),
                )
            )
    return out


# ---------------------------------------------------------------------------
# observability envelopes (GET /v1/slo, GET /v1/debug/exemplars)
# ---------------------------------------------------------------------------
def encode_slo_response(report: Mapping[str, Any]) -> bytes:
    """Serialize an SLO report (:meth:`repro_torch.obs.slo.SLOTracker.report`)
    as the ``GET /v1/slo?format=json`` body. Canonical bytes, same
    determinism contract as every other envelope -- the golden corpus
    pins this encoding."""
    return _dumps({"v": WIRE_VERSION, "ok": True, "slo": dict(report)})


def decode_slo_response(data: bytes, http_status: int = 0) -> Dict[str, Any]:
    """Bytes -> the SLO report dict; a structured error envelope raises
    :class:`RemoteError`."""
    obj = _loads(data)
    _check_version(obj, "response envelope")
    if not obj.get("ok"):
        err = obj.get("error") or {}
        raise RemoteError(
            str(err.get("code", "unknown")),
            str(err.get("message", "(no message)")),
            http_status,
        )
    slo = obj.get("slo")
    if not isinstance(slo, dict):
        raise WireError("'slo' must be an object (the SLO report)")
    return _unjsonify(slo)


def encode_exemplars_response(payload: Mapping[str, Any]) -> bytes:
    """Serialize a tail-exemplar snapshot
    (:meth:`repro_torch.obs.exemplar.ExemplarStore.snapshot`) as the
    ``GET /v1/debug/exemplars`` body."""
    return _dumps({"v": WIRE_VERSION, "ok": True, "exemplars": dict(payload)})


def decode_exemplars_response(data: bytes, http_status: int = 0) -> Dict[str, Any]:
    """Bytes -> the exemplar snapshot dict; a structured error envelope
    raises :class:`RemoteError`."""
    obj = _loads(data)
    _check_version(obj, "response envelope")
    if not obj.get("ok"):
        err = obj.get("error") or {}
        raise RemoteError(
            str(err.get("code", "unknown")),
            str(err.get("message", "(no message)")),
            http_status,
        )
    ex = obj.get("exemplars")
    if not isinstance(ex, dict):
        raise WireError("'exemplars' must be an object (the exemplar snapshot)")
    return _unjsonify(ex)


def encode_error(code: str, message: str) -> bytes:
    """Structured failure payload (the only thing a gateway ever sends on
    error -- clients never parse tracebacks)."""
    return _dumps(
        {"v": WIRE_VERSION, "ok": False,
         "error": {"code": str(code), "message": str(message)}}
    )
