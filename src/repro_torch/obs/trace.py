"""Context-manager spans over the monotonic clock.

A *trace* is one request's tree of timed spans. The API is built around
two costs-nothing-when-off invariants:

* With no active trace, :func:`span` yields ``None`` without allocating a
  node -- instrumented code pays one contextvar read.
* Span trees are plain dicts the moment the root closes, so encoding them
  is just JSON; nothing observability-shaped touches the answer path.

Usage (a serving front end does this per traced request)::

    with trace("request", trace_id=tid) as root:
        with span("server.answer", key=key[:12]):
            ...
    tree = root.tree()   # {"trace_id", "name", "t_offset_us", "dur_us", ...}

Nesting rides :mod:`contextvars`, so concurrent requests on a
``ThreadingHTTPServer`` (one thread each) never see each other's spans.
One documented blind spot: the microbatching ``CodesignServer`` executes
*followers'* reductions on the leader's thread, so engine-level spans
attach to the leader's trace only -- follower trees show the rendezvous
wait, not the matmul. Trace ids ride the HTTP wire as the
:data:`TRACE_HEADER` header (client-supplied or gateway-minted).
"""

from __future__ import annotations

import contextlib
import contextvars
import time
import uuid
from typing import Any, Dict, Iterator, List, Optional

__all__ = [
    "TRACE_HEADER",
    "Span",
    "current_span",
    "current_trace_id",
    "new_trace_id",
    "span",
    "trace",
]

#: HTTP header carrying the request's trace id in both directions: echoed
#: back when the client supplied one, minted by the gateway otherwise.
TRACE_HEADER = "X-Repro-Trace"

_ACTIVE: contextvars.ContextVar[Optional["Span"]] = contextvars.ContextVar(
    "repro_obs_active_span", default=None
)


def new_trace_id() -> str:
    """A fresh 16-hex-char trace id (no ordering or meaning implied)."""
    return uuid.uuid4().hex[:16]


class Span:
    """One timed node. Offsets/durations are whole microseconds relative
    to the trace root's start on the monotonic clock -- wall-clock never
    enters a span tree, so trees are insensitive to NTP steps."""

    __slots__ = ("name", "trace_id", "attrs", "children",
                 "_t0", "_root_t0", "_dur", "_token")

    def __init__(
        self,
        name: str,
        trace_id: str,
        root_t0: Optional[float] = None,
        attrs: Optional[Dict[str, Any]] = None,
    ):
        self.name = name
        self.trace_id = trace_id
        self.attrs = attrs or {}
        self.children: List[Span] = []
        self._t0 = time.perf_counter()
        self._root_t0 = self._t0 if root_t0 is None else root_t0
        self._dur: Optional[float] = None
        self._token: Optional[contextvars.Token] = None

    # -- lifecycle ---------------------------------------------------------
    def _enter(self) -> "Span":
        self._token = _ACTIVE.set(self)
        return self

    def _exit(self) -> None:
        self._dur = time.perf_counter() - self._t0
        if self._token is not None:
            _ACTIVE.reset(self._token)
            self._token = None

    @property
    def duration_s(self) -> float:
        """Closed span's duration in seconds (0.0 while still open)."""
        return self._dur if self._dur is not None else 0.0

    def tree(self) -> Dict[str, Any]:
        """The span subtree as a plain JSON-ready dict (children in
        start order). Safe to call once the span has closed."""
        node: Dict[str, Any] = {
            "name": self.name,
            "t_offset_us": int(round((self._t0 - self._root_t0) * 1e6)),
            "dur_us": int(round(self.duration_s * 1e6)),
        }
        if self.attrs:
            node["attrs"] = {k: self.attrs[k] for k in sorted(self.attrs)}
        if self.children:
            node["children"] = [c.tree() for c in self.children]
        return node

    def root_tree(self) -> Dict[str, Any]:
        """Like :meth:`tree` but stamped with the trace id -- the shape
        that goes into the response envelope's ``trace`` field."""
        return {"trace_id": self.trace_id, **self.tree()}


def current_span() -> Optional[Span]:
    """The innermost open span on this thread/context, or None."""
    return _ACTIVE.get()


def current_trace_id() -> Optional[str]:
    """Trace id of the active trace, or None when not tracing."""
    s = _ACTIVE.get()
    return s.trace_id if s is not None else None


@contextlib.contextmanager
def trace(
    name: str, trace_id: Optional[str] = None, **attrs: Any
) -> Iterator[Span]:
    """Open a ROOT span, starting a new trace on this context. Always
    yields a real :class:`Span` (unlike :func:`span`, which no-ops when
    nothing is tracing)."""
    root = Span(name, trace_id or new_trace_id(), attrs=attrs or None)
    root._enter()
    try:
        yield root
    finally:
        root._exit()


@contextlib.contextmanager
def span(name: str, **attrs: Any) -> Iterator[Optional[Span]]:
    """Open a child span under the active trace. With NO active trace
    this yields ``None`` without allocating -- instrumentation stays
    near-free on untraced requests."""
    parent = _ACTIVE.get()
    if parent is None:
        yield None
        return
    child = Span(name, parent.trace_id, root_t0=parent._root_t0,
                 attrs=attrs or None)
    parent.children.append(child)
    child._enter()
    try:
        yield child
    finally:
        child._exit()
