"""Deterministic fault injection for the serving stack.

You cannot claim a gateway degrades gracefully without being able to
*make* it degrade on demand. This module is a process-wide registry of
named injection points that production code consults via cheap hooks:

* the hooks (:func:`fire`, :func:`should_drop`) cost **one module-global
  read** when nothing is armed -- the registry exists precisely so the
  production request path can carry its failure modes at zero cost;
* faults are **deterministic**: no randomness. A fault fires on every
  hit, optionally skipping the first ``after`` hits and auto-clearing
  after ``count`` firings -- which is what lets the chaos harness
  (``scripts/chaos_smoke.py``) assert not just the failure but the
  *recovery* after the fault clears;
* gating is explicit: programmatic (:func:`enable` / :func:`configure`,
  used by tests) or the ``REPRO_FAULTS`` environment variable (a JSON
  object, parsed once at import -- how the chaos harness arms a
  ``serve`` child process). An unset env and an empty registry mean
  every hook is a no-op.

Injection points wired into the port so far (each documented where it
is called; the JAX package's gateway and portfolio points come with those
modules):

========================  ==================================================
``store.open``            :meth:`repro_torch.service.store.ArtifactStore.get`
                          -- artifact-open latency and load exceptions
``store.lock``            :meth:`~repro_torch.service.store.ArtifactStore
                          .build_lock` -- extra hold time on the build flock
``server.batch``          the microbatch leader's flush in
                          :mod:`repro_torch.service.server` -- slow/failing
                          batch answers (slow-follower symptom)
========================  ==================================================

Fault spec fields: ``latency_s`` (sleep before proceeding), ``error``
(raise; programmatically an exception instance, from the env a string
``"ExcName:message"`` resolved against a small builtin whitelist),
``count`` (fire at most N times, then auto-clear), ``after`` (skip the
first N hits). Example::

    REPRO_FAULTS='{"store.open": {"latency_s": 0.5, "count": 2}}'
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Any, Dict, Mapping, Optional

from repro_torch.obs import get_logger
from repro_torch.obs.metrics import get_registry as _obs_registry

__all__ = [
    "enable",
    "disable",
    "reset",
    "configure",
    "active",
    "is_active",
    "fire",
    "should_drop",
]

_LOG = get_logger("repro_torch.faults")
_REG = _obs_registry()
_M_FIRED = _REG.counter(
    "repro_faults_fired_total",
    "injected faults actually fired, by injection point (nonzero only "
    "when fault injection is armed -- never in production)",
    labels=("point",),
)

#: exception names the env-var string form may raise. A whitelist, not
#: arbitrary lookup: REPRO_FAULTS is a test harness knob, not an eval.
_ERROR_TYPES = {
    "OSError": OSError,
    "IOError": OSError,
    "RuntimeError": RuntimeError,
    "ValueError": ValueError,
    "TimeoutError": TimeoutError,
    "ConnectionResetError": ConnectionResetError,
}

_MU = threading.Lock()
_ACTIVE: Dict[str, Dict[str, Any]] = {}
#: the no-op fast path: hooks return immediately unless this is True.
#: Only ever written under _MU; read without it (a stale False merely
#: delays arming by one hit, a stale True costs one lock acquisition).
_ARMED = False


def _parse_error(err: Any) -> Optional[BaseException]:
    """An exception instance from a spec's ``error`` field: pass
    instances through; parse ``"ExcName:message"`` strings (whitelisted
    types only; unknown names become RuntimeError)."""
    if err is None:
        return None
    if isinstance(err, BaseException):
        return err
    name, _, message = str(err).partition(":")
    exc_type = _ERROR_TYPES.get(name.strip())
    if exc_type is None:
        return RuntimeError(str(err))
    return exc_type(message.strip() or name.strip())


def enable(point: str, *, latency_s: float = 0.0,
           error: Any = None, count: Optional[int] = None,
           after: int = 0) -> None:
    """Arm one injection point (replacing any existing spec for it)."""
    global _ARMED
    spec = {
        "latency_s": float(latency_s),
        "error": error,
        "count": None if count is None else int(count),
        "after": int(after),
        "hits": 0,
        "fired": 0,
    }
    with _MU:
        _ACTIVE[point] = spec
        _ARMED = True
    _LOG.info("fault_enabled", point=point, latency_s=latency_s,
              error=str(error) if error is not None else None,
              count=count, after=after)


def disable(point: str) -> None:
    """Disarm one injection point (idempotent)."""
    global _ARMED
    with _MU:
        _ACTIVE.pop(point, None)
        _ARMED = bool(_ACTIVE)


def reset() -> None:
    """Disarm everything (tests call this in teardown)."""
    global _ARMED
    with _MU:
        _ACTIVE.clear()
        _ARMED = False


def configure(spec: Mapping[str, Mapping[str, Any]]) -> None:
    """Replace the whole registry from a ``{point: spec}`` mapping (the
    parsed form of ``REPRO_FAULTS``)."""
    reset()
    for point, cfg in spec.items():
        if not isinstance(cfg, Mapping):
            raise ValueError(
                f"fault spec for {point!r} must be an object, got "
                f"{type(cfg).__name__}"
            )
        unknown = set(cfg) - {"latency_s", "error", "count", "after"}
        if unknown:
            raise ValueError(
                f"fault spec for {point!r} has unknown fields "
                f"{sorted(unknown)}"
            )
        enable(point, **cfg)


def active() -> Dict[str, Dict[str, Any]]:
    """Snapshot of the armed points (counters included) -- diagnostics
    and test assertions."""
    with _MU:
        return {k: dict(v) for k, v in _ACTIVE.items()}


def is_active(point: str) -> bool:
    if not _ARMED:
        return False
    with _MU:
        return point in _ACTIVE


def _take(point: str) -> Optional[Dict[str, Any]]:
    """Consume one hit of ``point``; returns the spec iff the fault fires
    this hit (honoring ``after``/``count``, auto-clearing at count)."""
    global _ARMED
    with _MU:
        spec = _ACTIVE.get(point)
        if spec is None:
            return None
        spec["hits"] += 1
        if spec["hits"] <= spec["after"]:
            return None
        if spec["count"] is not None and spec["fired"] >= spec["count"]:
            del _ACTIVE[point]
            _ARMED = bool(_ACTIVE)
            return None
        spec["fired"] += 1
        if spec["count"] is not None and spec["fired"] >= spec["count"]:
            # last firing: clear now so the very next hit is clean
            del _ACTIVE[point]
            _ARMED = bool(_ACTIVE)
        return spec


def fire(point: str, sleep=time.sleep) -> None:
    """Production hook: no-op unless ``point`` is armed; then apply its
    latency and/or raise its exception. The sleep happens outside the
    registry lock."""
    if not _ARMED:
        return
    spec = _take(point)
    if spec is None:
        return
    _M_FIRED.labels(point=point).inc()
    _LOG.warning("fault_fired", point=point, fired=spec["fired"])
    if spec["latency_s"] > 0:
        sleep(spec["latency_s"])
    exc = _parse_error(spec["error"])
    if exc is not None:
        raise exc


def should_drop(point: str) -> bool:
    """Production hook for faults that cannot be expressed as an
    exception (e.g. the HTTP handler abandoning a connection): True iff
    the armed fault fires this hit. Latency (if any) is applied here
    too; an ``error`` field is ignored for drop-style points."""
    if not _ARMED:
        return False
    spec = _take(point)
    if spec is None:
        return False
    _M_FIRED.labels(point=point).inc()
    _LOG.warning("fault_fired", point=point, fired=spec["fired"])
    if spec["latency_s"] > 0:
        time.sleep(spec["latency_s"])
    return True


# --- env gating: how a child process (the chaos harness's `serve`) is
# armed. Parsed once at import; malformed JSON is a hard error -- a chaos
# run silently testing nothing would be worse than crashing.
_env_spec = os.environ.get("REPRO_FAULTS")
if _env_spec:
    configure(json.loads(_env_spec))
