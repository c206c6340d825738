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

*Layer spans* (:func:`layer_span`) are the second kind: records of where
a train or serve step spends its time. The program opens six:

========================== ============================================= ===========
span                       where                                         device time
========================== ============================================= ===========
``serve.decode``           each decode step of ``serve.generate_timed``, no
                           its synchronise inside
``train.step``             the whole train step                          yes
``train.forward``          each microbatch's forward pass and loss       yes
``train.recompute``        each recompute of a checkpointed block,       yes
                           sub-layer or loss chunk, in the backward pass
                           (:func:`checkpointed`)
``model.attention``        a mixer's attention                           with grad
``model.attention.core``   the attention core inside it (``_attend``),   no
                           ``attrs`` ``{"path": "fused" | "plain" |
                           "chunked"}``
========================== ============================================= ===========

* **When they record.** Only while a ``torch.profiler`` session records
  (the flag ``torch.autograd.profiler`` keeps). Otherwise a span site is
  one flag read: no allocation, no clock read, no profiler range.
* **Which clock.** Start and end are ``time.time_ns()``, Unix-epoch
  nanoseconds, the clock of the profiler's events
  (``_KinetoEvent.start_ns()``), so the device operations of a trace can be
  placed inside a span: a decode step's lie inside its ``serve.decode``
  span. Each span also opens the profiler range ``repro/<name>``, which
  shows in an exported timeline and dispatches no operation (a selective
  checkpoint's recompute sees the same operations either way).
* **Device time.** A span marked for it records a timed CUDA event pair on
  the current stream at both ends (``model.attention`` only where grad is
  enabled: in training, not in serving); the pair is read only when
  :func:`recorded` is called, after one synchronise. It times the stream,
  so it also counts the stream's idle time inside the span.
* **Reading them.** :func:`recorded` returns the kept spans, oldest first,
  as dicts: ``name``, ``parent`` (an index into the same list, or None),
  ``tid``, ``start_ns``, ``end_ns``, ``attrs``, ``device_ms`` (None without
  a pair). The parent is the innermost open span of the same thread; a
  span opened in a backward pass, which runs on autograd's device thread
  while the step's thread waits, takes the innermost open span of any
  thread instead (a recompute's parent is ``train.step``). The spans live
  in a ring of :data:`RING`; past it the oldest is dropped. :func:`clear`
  empties it.
* **Cost.** Off: under a microsecond a site on one CPU core, nothing
  measurable in a step. On, under the profiler: a few microseconds a span,
  small against the profiler's own cost per operation.
"""

from __future__ import annotations

import collections
import contextlib
import contextvars
import threading
import time
import uuid
from typing import Any, Dict, Iterator, List, Optional

import torch
import torch.autograd.profiler as _profiler
from torch._C._profiler import _RecordFunctionFast

__all__ = [
    "TRACE_HEADER",
    "Span",
    "current_span",
    "current_trace_id",
    "new_trace_id",
    "span",
    "trace",
    "RING",
    "checkpointed",
    "clear",
    "layer_span",
    "recorded",
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


# ---------------------------------------------------------------------------
# Layer spans
# ---------------------------------------------------------------------------
#: the most layer spans kept; past it the oldest is dropped
RING = 1 << 20

_RECORDS: "collections.deque[_Record]" = collections.deque(maxlen=RING)
#: the layer spans open now, on every thread, oldest first
_OPEN: List["_Record"] = []
_OPEN_LOCK = threading.Lock()


#: the span site's context while nothing records
_OFF = contextlib.nullcontext()


class _Record:
    """One layer span: name, parent, thread, the profiler's clock at both
    ends, attributes, and the CUDA event pair of a ``device=True`` span."""

    __slots__ = ("name", "parent", "tid", "start_ns", "end_ns", "attrs", "events", "_rf")

    def __init__(self, name: str, device: bool, attrs: Optional[Dict[str, Any]]):
        self.name, self.attrs = name, attrs
        self.tid = threading.get_ident()
        self.end_ns: Optional[int] = None
        self.events = None
        if device and torch.cuda.is_initialized():
            self.events = (torch.cuda.Event(enable_timing=True),
                           torch.cuda.Event(enable_timing=True))
        # a profiler range that goes through no dispatcher op, so that a
        # selective checkpoint's recompute sees the same operations as its
        # forward pass whether or not a span opens around it
        self._rf = _RecordFunctionFast("repro/" + name)

    def __enter__(self) -> "_Record":
        # the parent: the innermost open span of this thread; inside a
        # backward pass, which runs on autograd's device thread while the
        # step's thread waits for it, else the innermost open span of any
        # thread
        in_backward = torch._C._current_graph_task_id() != -1
        with _OPEN_LOCK:
            mine = [r for r in _OPEN if r.tid == self.tid]
            self.parent = mine[-1] if mine else (_OPEN[-1] if _OPEN and in_backward else None)
            _OPEN.append(self)
            _RECORDS.append(self)
        self.start_ns = time.time_ns()
        self._rf.__enter__()
        if self.events is not None:
            self.events[0].record()
        return self

    def __exit__(self, *exc) -> bool:
        if self.events is not None:
            self.events[1].record()
        self._rf.__exit__(*exc)
        self.end_ns = time.time_ns()
        with _OPEN_LOCK:
            _OPEN.remove(self)
        return False


def layer_span(name: str, device: bool = False, attrs: Optional[Dict[str, Any]] = None):
    """A context that records the layer span ``name`` while a
    ``torch.profiler`` session records, and does nothing otherwise (one
    flag read: no allocation, no clock read).

    A recorded span keeps its parent, thread id, start and end in
    Unix-epoch nanoseconds (``time.time_ns``, the clock of the profiler's
    events), and ``attrs``; it also opens the profiler range
    ``repro/<name>``, so it shows in an exported profiler timeline. With
    ``device=True`` and CUDA in use it records a timed CUDA event pair on
    the current stream at both ends, read only by :func:`recorded`."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    return _Record(name, device, attrs)


def checkpointed(fn, *args, **kw):
    """``fn(*args, **kw)``, for ``torch.utils.checkpoint.checkpoint`` to run
    in place of ``fn``: once in the forward pass, and again as the backward
    pass's recompute (inside a graph task), which is the layer span
    ``train.recompute`` with its device time."""
    if _profiler._is_profiler_enabled and torch._C._current_graph_task_id() != -1:
        with _Record("train.recompute", True, None):
            return fn(*args, **kw)
    return fn(*args, **kw)


def recorded() -> List[Dict[str, Any]]:
    """The layer spans kept (at most :data:`RING`, oldest first), as dicts:
    ``name``, ``parent`` (the parent's index in this list, or None),
    ``tid``, ``start_ns``, ``end_ns`` (None while open), ``attrs`` and
    ``device_ms``: the device time between a ``device=True`` span's events,
    read now (after a synchronise), else None."""
    spans = list(_RECORDS)
    if any(r.events is not None for r in spans):
        torch.cuda.synchronize()
    index = {id(r): i for i, r in enumerate(spans)}
    out = []
    for r in spans:
        closed = r.end_ns is not None
        out.append({
            "name": r.name,
            "parent": None if r.parent is None else index.get(id(r.parent)),
            "tid": r.tid,
            "start_ns": r.start_ns,
            "end_ns": r.end_ns,
            "attrs": dict(r.attrs or {}),
            "device_ms": r.events[0].elapsed_time(r.events[1])
            if closed and r.events is not None else None,
        })
    return out


def clear() -> None:
    """Drop every kept layer span."""
    _RECORDS.clear()
