"""Dependency-free observability for the port's codesign stack.

Three small, stdlib-only modules, copies of the JAX package's with the same
metric names and the same ``REPRO_OBS_DISABLED=1`` switch (see
``docs/observability.md`` for the metric reference):

* :mod:`repro_torch.obs.metrics` -- a process-wide registry of thread-safe
  counters, gauges, and fixed-bucket histograms with snapshot/reset
  semantics and two exporters (Prometheus text + canonical JSON).
* :mod:`repro_torch.obs.trace`   -- context-manager spans over the
  monotonic clock with parent/child nesting and a per-request trace id.
* :mod:`repro_torch.obs.logging` -- structured JSON line logging under the
  ``repro_torch`` logger namespace.

Design rule: observability is **additive, never on the answer path**, and
``REPRO_OBS_DISABLED=1`` turns every metric into a no-op. Exemplars, SLOs
and process gauges come with the gateway.
"""

from .logging import configure_logging, get_logger  # noqa: F401
from .metrics import (  # noqa: F401
    Counter,
    Gauge,
    Histogram,
    Registry,
    get_registry,
    set_disabled,
)
from .trace import (  # noqa: F401
    TRACE_HEADER,
    Span,
    current_span,
    current_trace_id,
    new_trace_id,
    span,
    trace,
)
