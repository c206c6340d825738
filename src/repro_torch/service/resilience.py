"""Deadlines for the serving stack: the request-budget half of the JAX
package's ``service/resilience.py``.

A request's time budget becomes a :class:`Deadline` bound to a
contextvar for the request's duration (:func:`deadline_scope`). Every
stage downstream -- store open, the microbatch rendezvous, the build
lock, a miss-path build -- calls the free function :func:`check_deadline`
(a no-op when no deadline is in flight) and fails fast with a structured
``deadline_exceeded`` (HTTP 504) instead of piling work behind a caller
that has already given up; bounded waits cap themselves by
:func:`remaining_s`.

Admission control, circuit breakers and the client retry policy belong to
the gateway and are ported with it. Deadline hits land in the
:mod:`repro_torch.obs` metrics registry under the JAX package's metric
name, labelled by the stage that noticed.
"""

from __future__ import annotations

import contextlib
import contextvars
import math
import time
from typing import Iterator, Optional

from repro_torch.obs.metrics import get_registry as _obs_registry

from .errors import ERROR_HTTP_STATUS, GatewayError

__all__ = [
    "Deadline",
    "DeadlineExceededError",
    "deadline_scope",
    "current_deadline",
    "check_deadline",
    "remaining_s",
]

# ---- observability (repro_torch.obs; no-ops under REPRO_OBS_DISABLED=1) --
_REG = _obs_registry()
_M_DEADLINE = _REG.counter(
    "repro_resilience_deadline_exceeded_total",
    "requests failed because their deadline budget ran out, by the "
    "pipeline stage that noticed",
    labels=("stage",),
)


class DeadlineExceededError(GatewayError):
    """The request's ``deadline_ms`` budget ran out before the answer was
    ready; the message names the stage that noticed (HTTP 504). Not
    retryable as-is: the same budget would burn the same way."""

    code = "deadline_exceeded"
    http_status = ERROR_HTTP_STATUS["deadline_exceeded"]



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
