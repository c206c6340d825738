"""Shared structured-error vocabulary of the serving stack.

A dependency **leaf**: it imports nothing from the rest of
:mod:`repro_torch.service`, so every layer -- the store, the servers and
the deadline machinery today, the wire codec and the gateway when they
are ported -- can name the same error base class and the same code ->
HTTP status registry without import cycles.

Two things live here, the same as in the JAX package, so both packages
answer with one vocabulary:

* :data:`ERROR_HTTP_STATUS` -- THE code -> HTTP status registry. Adding an
  error code means adding it here.
* :class:`GatewayError` -- the base of every structured server-side
  failure. Each subclass pins its wire ``code`` and reads its
  ``http_status`` from the registry, so the two can never disagree.

The full error-code table (what each code means, when it is returned,
whether a client should retry) is documented in ``docs/serving.md`` and
``docs/resilience.md``.
"""

from __future__ import annotations

__all__ = ["ERROR_HTTP_STATUS", "GatewayError"]

ERROR_HTTP_STATUS = {
    "bad_request": 400,
    "unsupported_version": 400,
    "wrong_artifact_kind": 400,
    "ambiguous_workload": 400,
    "unknown_artifact": 404,
    "not_found": 404,
    # portfolio routing (docs/portfolio.md): unknown_cell is the route
    # twin of unknown_artifact; portfolio_exhausted means every member
    # design's breaker/read failed -- retryable with backoff.
    "unknown_cell": 404,
    # observability endpoints (docs/observability.md): unknown_route is
    # a /v1/debug/exemplars?route= filter naming a route the gateway
    # does not serve -- a caller typo, not a retryable condition.
    "unknown_route": 404,
    "ambiguous_route": 409,
    "portfolio_exhausted": 503,
    # resilience layer (docs/resilience.md): 429/503 are retryable with
    # backoff (the response carries Retry-After); 504 means the caller's
    # own deadline_ms budget ran out -- retrying with the same budget
    # would just burn it again.
    "rate_limited": 429,
    "shed": 503,
    "circuit_open": 503,
    "build_lock_timeout": 503,
    "deadline_exceeded": 504,
    "internal": 500,
}


class GatewayError(Exception):
    """Base of the serving stack's structured failures; every subclass
    pins the wire error ``code``, and the HTTP status comes from the
    shared :data:`ERROR_HTTP_STATUS` registry (one table serves the
    server side and the batched client-side decoder, so the two can
    never disagree about how a code classifies).

    Subclasses that are *retryable after a delay* additionally carry a
    ``retry_after_s`` attribute; the HTTP handler surfaces it as a
    ``Retry-After`` header and a retrying client honors it."""

    code = "internal"
    http_status = ERROR_HTTP_STATUS["internal"]
