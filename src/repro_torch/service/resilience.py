"""Resilience primitives for the serving stack: deadlines, admission
control, circuit breaking, and the client retry policy.

What separates a gateway that could take public traffic from a demo is
how the *worst minute* goes. Without
this module, one slow artifact load holds a handler thread for as long
as the disk feels like, a thundering herd exhausts the
``ThreadingHTTPServer``'s accept loop before anything says no, and a
wedged store flock parks a request forever. The primitives here are the
reflexes; :mod:`repro_torch.obs` is the instruments; the wiring through
the request path lives in :mod:`.gateway`, :mod:`.server`, :mod:`.store`
and :mod:`.client`.

Four independent mechanisms (each usable and testable on its own --
every class takes an injectable ``clock``/``rng``/``sleep`` seam, so the
tests never sleep):

* **deadline propagation** -- a request's ``deadline_ms`` envelope field
  (or ``X-Repro-Deadline-Ms`` header) becomes a :class:`Deadline` bound
  to a contextvar for the request's duration (:func:`deadline_scope`).
  Every stage downstream -- routing, pool build, store open, the
  microbatch rendezvous, the build lock -- calls the free function
  :func:`check_deadline` (a no-op when no deadline is in flight) and
  fails fast with a structured ``deadline_exceeded`` (HTTP 504) instead
  of piling work behind a caller that has already given up;
* **token-bucket admission control with load shedding**
  (:class:`TokenBucket`, :class:`AdmissionController`) -- a global
  bucket and bounded per-client buckets (keyed by ``X-Repro-Client`` or
  the remote address) gate ``/v1/query`` + ``/v1/query_many``; over
  budget answers ``rate_limited`` (429 + ``Retry-After``), and an
  in-flight watermark sheds with ``shed`` (503) *before* the thread
  pool exhausts;
* **circuit breakers** (:class:`CircuitBreaker`) -- around per-artifact
  server builds and store I/O. After ``threshold`` consecutive
  infrastructure failures a key's circuit opens and requests fail fast
  with ``circuit_open`` (503 + ``Retry-After``); after ``cooldown_s``
  one half-open probe is let through and its outcome closes or re-opens
  the circuit. Structured :class:`~.errors.GatewayError` outcomes
  (client errors, deadline hits) do NOT count as failures -- only raw
  exceptions (the infrastructure actually breaking) trip the breaker;
* **client retry policy** (:class:`RetryPolicy`) -- bounded exponential
  backoff with full jitter, honoring ``Retry-After``. The policy object
  only *computes delays*; :class:`repro_torch.service.client.GatewayClient`
  applies it, retrying idempotent failures only (429 / 503 /
  connection reset) and never timeouts.

Every resilience event lands in the :mod:`repro_torch.obs` metrics registry
(sheds, rejections, deadline hits by stage, breaker transitions), so a
``GET /v1/metrics`` scrape tells the whole story. Knobs, the error-code
table, and tuning guidance are documented in ``docs/resilience.md``
(written for the JAX package; the port keeps its names, codes and knobs).
"""

from __future__ import annotations

import contextlib
import contextvars
import math
import threading
import time
from collections import OrderedDict
from typing import Dict, Iterator, Optional

from repro_torch.obs import get_logger
from repro_torch.obs.metrics import get_registry as _obs_registry

from .errors import ERROR_HTTP_STATUS, GatewayError

__all__ = [
    "DEADLINE_HEADER",
    "CLIENT_HEADER",
    "Deadline",
    "DeadlineExceededError",
    "RateLimitedError",
    "ShedError",
    "CircuitOpenError",
    "TokenBucket",
    "AdmissionController",
    "CircuitBreaker",
    "RetryPolicy",
    "GatewayResilience",
    "deadline_scope",
    "current_deadline",
    "check_deadline",
    "remaining_s",
]

#: request header carrying the caller's total time budget (milliseconds,
#: positive float). The envelope field ``deadline_ms`` means the same
#: thing; when both are present the smaller budget wins.
DEADLINE_HEADER = "X-Repro-Deadline-Ms"

#: request header naming the client for per-client admission buckets;
#: the remote address is the fallback key.
CLIENT_HEADER = "X-Repro-Client"

# ---- observability (repro_torch.obs; no-ops under REPRO_OBS_DISABLED=1) --
_LOG = get_logger("repro_torch.resilience")
_REG = _obs_registry()
_M_DEADLINE = _REG.counter(
    "repro_resilience_deadline_exceeded_total",
    "requests failed because their deadline budget ran out, by the "
    "pipeline stage that noticed",
    labels=("stage",),
)
_M_REJECTED = _REG.counter(
    "repro_resilience_rejections_total",
    "admission-control rejections, by reason "
    "(rate_limited_global | rate_limited_client | shed)",
    labels=("reason",),
)
_M_INFLIGHT = _REG.gauge(
    "repro_gateway_inflight_requests",
    "query requests currently admitted and executing (the load-shed "
    "watermark watches this)",
)
_M_BREAKER_STATE = _REG.gauge(
    "repro_resilience_breaker_state",
    "circuit state per breaker key (0=closed, 1=open, 2=half-open)",
    labels=("key",),
)
_M_BREAKER_TRANSITIONS = _REG.counter(
    "repro_resilience_breaker_transitions_total",
    "circuit state transitions, by breaker key and destination state",
    labels=("key", "to"),
)


# ---------------------------------------------------------------------------
# structured errors (the wire codes live in .errors.ERROR_HTTP_STATUS)
# ---------------------------------------------------------------------------
class DeadlineExceededError(GatewayError):
    """The request's ``deadline_ms`` budget ran out before the answer was
    ready; the message names the stage that noticed (HTTP 504). Not
    retryable as-is: the same budget would burn the same way."""

    code = "deadline_exceeded"
    http_status = ERROR_HTTP_STATUS["deadline_exceeded"]


class RateLimitedError(GatewayError):
    """Admission control's token bucket (global or per-client) is out of
    budget (HTTP 429). ``retry_after_s`` says when the bucket will have
    a token again; the HTTP handler surfaces it as ``Retry-After``."""

    code = "rate_limited"
    http_status = ERROR_HTTP_STATUS["rate_limited"]

    def __init__(self, message: str, retry_after_s: float = 1.0):
        super().__init__(message)
        self.retry_after_s = float(retry_after_s)


class ShedError(GatewayError):
    """The gateway is over its in-flight watermark and shed this request
    rather than queue it behind work it cannot finish (HTTP 503).
    Retryable after a short backoff."""

    code = "shed"
    http_status = ERROR_HTTP_STATUS["shed"]

    def __init__(self, message: str, retry_after_s: float = 1.0):
        super().__init__(message)
        self.retry_after_s = float(retry_after_s)


class CircuitOpenError(GatewayError):
    """The key's circuit breaker is open: recent attempts kept failing,
    so the gateway fails fast instead of hammering a broken dependency
    (HTTP 503). ``retry_after_s`` is the remaining cooldown before a
    half-open probe is allowed."""

    code = "circuit_open"
    http_status = ERROR_HTTP_STATUS["circuit_open"]

    def __init__(self, message: str, retry_after_s: float = 1.0):
        super().__init__(message)
        self.retry_after_s = float(retry_after_s)


# ---------------------------------------------------------------------------
# deadlines
# ---------------------------------------------------------------------------
class Deadline:
    """A monotonic-clock time budget, created once at request ingress.

    Stages *check* it (:meth:`check` raises :class:`DeadlineExceededError`
    past expiry) or *cap* their own waits by :meth:`remaining_s`; nobody
    extends it. The injectable ``clock`` keeps tests sleep-free."""

    __slots__ = ("budget_ms", "_expires", "_clock")

    def __init__(self, budget_ms: float, clock=time.monotonic):
        budget_ms = float(budget_ms)
        if not math.isfinite(budget_ms) or budget_ms <= 0:
            raise ValueError(f"deadline budget must be a positive finite "
                             f"number of ms, got {budget_ms!r}")
        self.budget_ms = budget_ms
        self._clock = clock
        self._expires = clock() + budget_ms / 1000.0

    def remaining_s(self) -> float:
        """Seconds of budget left (never negative)."""
        return max(0.0, self._expires - self._clock())

    @property
    def expired(self) -> bool:
        return self._clock() >= self._expires

    def check(self, stage: str) -> None:
        """Raise ``deadline_exceeded`` (and count it, labeled by stage)
        when the budget is gone; free when it is not."""
        if self.expired:
            _M_DEADLINE.labels(stage=stage).inc()
            raise DeadlineExceededError(
                f"deadline of {self.budget_ms:g}ms exceeded at stage "
                f"{stage!r}"
            )

    def __repr__(self) -> str:
        return (f"Deadline(budget_ms={self.budget_ms:g}, "
                f"remaining_s={self.remaining_s():.3f})")


#: the in-flight request's deadline. A contextvar (not an argument
#: threaded through every signature) so the store and server layers can
#: stay deadline-aware without their APIs knowing about HTTP ingress;
#: contextvars propagate into `with` blocks and down the call stack but
#: NOT into unrelated threads, so concurrent requests never share one.
_CURRENT_DEADLINE: contextvars.ContextVar[Optional[Deadline]] = (
    contextvars.ContextVar("repro_deadline", default=None)
)


@contextlib.contextmanager
def deadline_scope(deadline: Optional[Deadline]) -> Iterator[None]:
    """Bind ``deadline`` as the current request's budget for the dynamic
    extent of the block (``None`` explicitly clears an inherited one)."""
    token = _CURRENT_DEADLINE.set(deadline)
    try:
        yield
    finally:
        _CURRENT_DEADLINE.reset(token)


def current_deadline() -> Optional[Deadline]:
    """The in-flight request's :class:`Deadline`, or None."""
    return _CURRENT_DEADLINE.get()


def check_deadline(stage: str) -> None:
    """Stage checkpoint: raise ``deadline_exceeded`` iff a deadline is in
    flight and spent. The no-deadline fast path is one contextvar read,
    cheap enough for every hop of the request pipeline."""
    d = _CURRENT_DEADLINE.get()
    if d is not None:
        d.check(stage)


def remaining_s(default: Optional[float] = None) -> Optional[float]:
    """Seconds left on the in-flight deadline, or ``default`` when no
    deadline is set -- the cap for bounded waits (rendezvous windows,
    lock timeouts)."""
    d = _CURRENT_DEADLINE.get()
    return default if d is None else d.remaining_s()


# ---------------------------------------------------------------------------
# admission control
# ---------------------------------------------------------------------------
class TokenBucket:
    """Classic token bucket: ``burst`` capacity, refilled at ``rate``
    tokens/second. ``rate=0`` (or ``inf``) disables the bucket entirely
    (always admits) -- the unconfigured default costs one comparison.

    Thread-safe; time comes from the injectable ``clock``."""

    def __init__(self, rate: float, burst: Optional[float] = None,
                 clock=time.monotonic):
        self.rate = float(rate)
        if self.rate < 0:
            raise ValueError("rate must be >= 0 (0 disables the bucket)")
        self.burst = float(burst) if burst is not None else max(1.0, self.rate)
        if self.burst <= 0 and self._limiting:
            raise ValueError("burst must be > 0")
        self._clock = clock
        self._tokens = self.burst
        self._last = clock()
        self._mu = threading.Lock()

    @property
    def _limiting(self) -> bool:
        return self.rate > 0 and math.isfinite(self.rate)

    def try_acquire(self, n: float = 1.0) -> float:
        """Take ``n`` tokens if available. Returns ``0.0`` on admit, else
        the seconds until ``n`` tokens will exist (the Retry-After
        hint). Never blocks."""
        if not self._limiting:
            return 0.0
        with self._mu:
            now = self._clock()
            self._tokens = min(
                self.burst, self._tokens + (now - self._last) * self.rate
            )
            self._last = now
            if self._tokens >= n:
                self._tokens -= n
                return 0.0
            return (n - self._tokens) / self.rate


class AdmissionController:
    """Front-door admission for the query routes: shed on queue depth
    first (the cheapest overload signal), then the global bucket, then
    the caller's bucket.

    Parameters
    ----------
    global_rate / global_burst:
        Token budget shared by every caller (requests/second); ``0``
        disables the global bucket (the default).
    client_rate / client_burst:
        Per-client-key budget; ``0`` disables (the default). Client
        buckets live in an LRU bounded by ``max_clients`` so a key-
        scanning client cannot grow memory without bound.
    max_inflight:
        The load-shed watermark: when this many admitted requests are
        still executing, new ones answer ``shed`` (503) instead of
        queueing. ``0`` disables shedding.
    """

    def __init__(
        self,
        global_rate: float = 0.0,
        global_burst: Optional[float] = None,
        client_rate: float = 0.0,
        client_burst: Optional[float] = None,
        max_inflight: int = 0,
        max_clients: int = 1024,
        clock=time.monotonic,
    ):
        self._clock = clock
        self.global_bucket = TokenBucket(global_rate, global_burst, clock)
        self.client_rate = float(client_rate)
        self.client_burst = client_burst
        self.max_inflight = int(max_inflight)
        self.max_clients = int(max_clients)
        self._clients: "OrderedDict[str, TokenBucket]" = OrderedDict()
        self._inflight = 0
        self._mu = threading.Lock()

    @property
    def inflight(self) -> int:
        with self._mu:
            return self._inflight

    def _client_bucket(self, client: str) -> Optional[TokenBucket]:
        if self.client_rate <= 0 or not math.isfinite(self.client_rate):
            return None
        with self._mu:
            bucket = self._clients.get(client)
            if bucket is None:
                bucket = TokenBucket(
                    self.client_rate, self.client_burst, self._clock
                )
                self._clients[client] = bucket
            self._clients.move_to_end(client)
            while len(self._clients) > self.max_clients:
                self._clients.popitem(last=False)
        return bucket

    @contextlib.contextmanager
    def admit(self, client: str) -> Iterator[None]:
        """Admit one request for ``client`` (held for its duration) or
        raise :class:`ShedError` / :class:`RateLimitedError`."""
        with self._mu:
            if 0 < self.max_inflight <= self._inflight:
                _M_REJECTED.labels(reason="shed").inc()
                raise ShedError(
                    f"gateway over its in-flight watermark "
                    f"({self._inflight} >= {self.max_inflight}); shedding",
                    retry_after_s=1.0,
                )
            self._inflight += 1
            _M_INFLIGHT.set(self._inflight)
        try:
            wait = self.global_bucket.try_acquire()
            if wait > 0:
                _M_REJECTED.labels(reason="rate_limited_global").inc()
                raise RateLimitedError(
                    f"global rate limit "
                    f"({self.global_bucket.rate:g} req/s) exceeded",
                    retry_after_s=wait,
                )
            bucket = self._client_bucket(client)
            if bucket is not None:
                wait = bucket.try_acquire()
                if wait > 0:
                    _M_REJECTED.labels(reason="rate_limited_client").inc()
                    raise RateLimitedError(
                        f"client {client!r} over its rate limit "
                        f"({bucket.rate:g} req/s)",
                        retry_after_s=wait,
                    )
            yield
        finally:
            with self._mu:
                self._inflight -= 1
                _M_INFLIGHT.set(self._inflight)


# ---------------------------------------------------------------------------
# circuit breaker
# ---------------------------------------------------------------------------
class CircuitBreaker:
    """Per-key fail-fast switch around an unreliable dependency.

    closed --(``threshold`` consecutive failures)--> open
    open --(``cooldown_s`` elapsed)--> half-open (ONE probe admitted)
    half-open --(probe ok)--> closed | --(probe fails)--> open

    What counts as a failure is deliberate: only *raw* exceptions -- the
    dependency actually breaking (I/O errors, corrupt artifacts). A
    structured :class:`~.errors.GatewayError` is a classified outcome
    (the caller's key was wrong, their deadline ran out) and neither
    trips nor resets the breaker. :class:`CircuitOpenError` raised by
    the breaker itself is likewise transparent."""

    CLOSED, OPEN, HALF_OPEN = "closed", "open", "half_open"
    _STATE_GAUGE = {CLOSED: 0, OPEN: 1, HALF_OPEN: 2}

    def __init__(self, key: str, threshold: int = 5, cooldown_s: float = 30.0,
                 clock=time.monotonic):
        if threshold < 1:
            raise ValueError("threshold must be >= 1")
        self.key = str(key)
        self.threshold = int(threshold)
        self.cooldown_s = float(cooldown_s)
        self._clock = clock
        self._mu = threading.Lock()
        self._state = self.CLOSED
        self._failures = 0  # consecutive, while closed
        self._opened_at = 0.0
        self._probing = False  # a half-open probe is in flight

    @property
    def state(self) -> str:
        with self._mu:
            return self._state

    def _transition(self, to: str) -> None:
        # callers hold self._mu
        if self._state != to:
            _LOG.info("breaker_transition", key=self.key[:12],
                      frm=self._state, to=to)
            _M_BREAKER_TRANSITIONS.labels(key=self.key, to=to).inc()
        self._state = to
        _M_BREAKER_STATE.labels(key=self.key).set(self._STATE_GAUGE[to])

    @contextlib.contextmanager
    def call(self) -> Iterator[None]:
        """Guard one attempt against the dependency: raises
        :class:`CircuitOpenError` while open, records the wrapped
        block's outcome otherwise."""
        probe = False
        with self._mu:
            if self._state == self.OPEN:
                elapsed = self._clock() - self._opened_at
                if elapsed < self.cooldown_s:
                    raise CircuitOpenError(
                        f"circuit for {self.key[:12]!r} is open "
                        f"({self._failures} consecutive failures); "
                        f"half-open probe in "
                        f"{self.cooldown_s - elapsed:.1f}s",
                        retry_after_s=self.cooldown_s - elapsed,
                    )
                self._transition(self.HALF_OPEN)
            if self._state == self.HALF_OPEN:
                if self._probing:  # one probe at a time; the rest wait out
                    raise CircuitOpenError(
                        f"circuit for {self.key[:12]!r} is half-open with "
                        f"a probe in flight",
                        retry_after_s=self.cooldown_s,
                    )
                self._probing = True
                probe = True
        try:
            yield
        except GatewayError:
            # a classified outcome, not the dependency breaking: leave the
            # breaker state alone (a probe slot is released, not judged)
            with self._mu:
                if probe:
                    self._probing = False
            raise
        except BaseException:
            with self._mu:
                if probe:
                    self._probing = False
                self._failures += 1
                if self._state == self.HALF_OPEN or (
                    self._state == self.CLOSED
                    and self._failures >= self.threshold
                ):
                    self._opened_at = self._clock()
                    self._transition(self.OPEN)
            raise
        else:
            with self._mu:
                if probe:
                    self._probing = False
                self._failures = 0
                self._transition(self.CLOSED)


# ---------------------------------------------------------------------------
# client retry policy
# ---------------------------------------------------------------------------
class RetryPolicy:
    """Bounded exponential backoff with full jitter (delay computation
    only -- the transport applies it).

    ``delay(attempt, rng, retry_after_s)``: attempt 1 is the first
    *retry*. The exponential ramp is ``base_s * 2**(attempt-1)`` capped
    at ``max_s``, jittered down to ``[ (1-jitter)*d, d ]`` with the
    caller's ``rng`` (injectable, so tests are deterministic). A server
    ``Retry-After`` hint overrides the computed delay (still capped at
    ``max_s`` -- a confused server must not park the client for an
    hour)."""

    def __init__(self, max_retries: int = 3, base_s: float = 0.05,
                 max_s: float = 2.0, jitter: float = 0.5):
        if max_retries < 0:
            raise ValueError("max_retries must be >= 0")
        if not 0.0 <= jitter <= 1.0:
            raise ValueError("jitter must be in [0, 1]")
        self.max_retries = int(max_retries)
        self.base_s = float(base_s)
        self.max_s = float(max_s)
        self.jitter = float(jitter)

    def delay(self, attempt: int, rng,
              retry_after_s: Optional[float] = None) -> float:
        if retry_after_s is not None:
            return max(0.0, min(float(retry_after_s), self.max_s))
        d = min(self.max_s, self.base_s * (2.0 ** (attempt - 1)))
        return d * (1.0 - self.jitter * rng.random())

    def __repr__(self) -> str:
        return (f"RetryPolicy(max_retries={self.max_retries}, "
                f"base_s={self.base_s:g}, max_s={self.max_s:g}, "
                f"jitter={self.jitter:g})")


# ---------------------------------------------------------------------------
# the gateway-side bundle
# ---------------------------------------------------------------------------
class GatewayResilience:
    """Everything a :class:`~.gateway.Gateway` needs to defend itself,
    in one object: the admission controller for the HTTP front door and
    a registry of per-key circuit breakers for artifact builds / store
    I/O. The defaults are deliberately permissive (no rate limits, a
    high shed watermark) so an unconfigured gateway behaves exactly like
    the pre-resilience one on the happy path -- the knobs exist for
    operators (``serve --rate-limit ...``; see ``docs/resilience.md``)."""

    def __init__(
        self,
        global_rate: float = 0.0,
        global_burst: Optional[float] = None,
        client_rate: float = 0.0,
        client_burst: Optional[float] = None,
        max_inflight: int = 128,
        max_clients: int = 1024,
        breaker_threshold: int = 5,
        breaker_cooldown_s: float = 30.0,
        clock=time.monotonic,
    ):
        self.admission = AdmissionController(
            global_rate=global_rate,
            global_burst=global_burst,
            client_rate=client_rate,
            client_burst=client_burst,
            max_inflight=max_inflight,
            max_clients=max_clients,
            clock=clock,
        )
        self.breaker_threshold = int(breaker_threshold)
        self.breaker_cooldown_s = float(breaker_cooldown_s)
        self._clock = clock
        self._breakers: Dict[str, CircuitBreaker] = {}
        self._mu = threading.Lock()

    def breaker(self, key: str) -> CircuitBreaker:
        """The (lazily created) circuit breaker guarding one key."""
        with self._mu:
            b = self._breakers.get(key)
            if b is None:
                b = CircuitBreaker(
                    key,
                    threshold=self.breaker_threshold,
                    cooldown_s=self.breaker_cooldown_s,
                    clock=self._clock,
                )
                self._breakers[key] = b
            return b
