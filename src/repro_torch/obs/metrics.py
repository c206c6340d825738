"""Thread-safe metrics registry: counters, gauges, fixed-bucket histograms.

A deliberately tiny subset of the Prometheus client model, stdlib-only,
built for hot paths measured in microseconds:

* **families + labels** -- ``registry.counter(name, help, labels=("route",))``
  returns a :class:`Family`; ``family.labels(route="/v1/query")`` returns
  (and caches) one :class:`Counter` child per label-value tuple. A family
  with no label names acts as its own single child (``family.inc()``).
* **thread safety** -- every child guards its state with one uncontended
  lock (a bare ``+=`` on a Python float is a read-modify-write and CAN
  interleave across threads); child creation locks the family.
* **snapshot / reset** -- :meth:`Registry.snapshot` returns a plain,
  deterministic dict (sorted names, sorted label tuples) decoupled from
  live state; :meth:`Registry.reset` zeroes every child in place (tests,
  benchmarks) without dropping registrations.
* **exporters** -- :meth:`Registry.render_prometheus` (text exposition
  format, version 0.0.4) and :meth:`Registry.render_json` (canonical JSON:
  sorted keys, compact separators -- equal states always render to equal
  bytes). Both render from the same snapshot so they can never disagree.
* **kill switch** -- ``REPRO_OBS_DISABLED=1`` (or :func:`set_disabled`)
  turns ``inc``/``set``/``observe`` into early returns on every child of
  the default registry. Instrumented code never needs to branch.

Histograms use **fixed buckets** chosen at registration (defaults:
:data:`LATENCY_BUCKETS` seconds / :data:`SIZE_BUCKETS` counts); bucket
counts are cumulative, Prometheus-style, with ``+Inf`` implicit in
``count``.
"""

from __future__ import annotations

import bisect
import json
import math
import os
import threading
import time
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

__all__ = [
    "LATENCY_BUCKETS",
    "SIZE_BUCKETS",
    "Counter",
    "Gauge",
    "Histogram",
    "Family",
    "Registry",
    "get_registry",
    "set_disabled",
]

#: env var disabling the DEFAULT registry's instrumentation at import
#: (benchmarks A/B the overhead against exactly this knob).
DISABLED_ENV = "REPRO_OBS_DISABLED"

#: default histogram buckets for wall-time observations, in seconds:
#: 50 us (an LRU-hit query) up through 10 s (a cold sweep build).
LATENCY_BUCKETS: Tuple[float, ...] = (
    5e-5, 1e-4, 2.5e-4, 5e-4, 1e-3, 2.5e-3, 5e-3, 1e-2, 2.5e-2, 5e-2,
    0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
)

#: default buckets for size-ish observations (batch sizes, row counts).
SIZE_BUCKETS: Tuple[float, ...] = (1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024)


class Counter:
    """Monotonically increasing float (negative increments rejected)."""

    __slots__ = ("_mu", "_value", "_family")

    def __init__(self, family: "Family"):
        self._mu = threading.Lock()
        self._value = 0.0
        self._family = family

    def inc(self, n: float = 1.0) -> None:
        if self._family._registry.disabled:
            return
        if n < 0:
            raise ValueError(f"counter increment must be >= 0, got {n}")
        with self._mu:
            self._value += n

    @property
    def value(self) -> float:
        with self._mu:
            return self._value

    def _sample(self) -> Dict[str, Any]:
        return {"value": self.value}

    def _reset(self) -> None:
        with self._mu:
            self._value = 0.0


class Gauge:
    """A value that goes up and down (pool occupancy, last-access stamp)."""

    __slots__ = ("_mu", "_value", "_family")

    def __init__(self, family: "Family"):
        self._mu = threading.Lock()
        self._value = 0.0
        self._family = family

    def set(self, v: float) -> None:
        if self._family._registry.disabled:
            return
        with self._mu:
            self._value = float(v)

    def inc(self, n: float = 1.0) -> None:
        if self._family._registry.disabled:
            return
        with self._mu:
            self._value += n

    def dec(self, n: float = 1.0) -> None:
        self.inc(-n)

    @property
    def value(self) -> float:
        with self._mu:
            return self._value

    def _sample(self) -> Dict[str, Any]:
        return {"value": self.value}

    def _reset(self) -> None:
        with self._mu:
            self._value = 0.0


class Histogram:
    """Fixed-bucket histogram (cumulative counts + sum + count).

    Buckets are upper bounds, strictly increasing, fixed at registration;
    an observation lands in the first bucket whose bound is >= the value
    (``bisect_left``), and ``+Inf`` is implicit: ``count`` minus the last
    bucket's cumulative count is the overflow.
    """

    __slots__ = ("_mu", "_buckets", "_counts", "_sum", "_count", "_family")

    def __init__(self, family: "Family", buckets: Sequence[float]):
        b = tuple(float(x) for x in buckets)
        if not b or any(b[i] >= b[i + 1] for i in range(len(b) - 1)):
            raise ValueError(f"buckets must be strictly increasing, got {b}")
        self._mu = threading.Lock()
        self._buckets = b
        self._counts = [0] * len(b)
        self._sum = 0.0
        self._count = 0
        self._family = family

    def observe(self, v: float) -> None:
        if self._family._registry.disabled:
            return
        v = float(v)
        i = bisect.bisect_left(self._buckets, v)
        with self._mu:
            if i < len(self._counts):
                self._counts[i] += 1
            self._sum += v
            self._count += 1

    def time(self) -> "_Timer":
        """``with hist.time(): ...`` observes the block's wall seconds."""
        return _Timer(self)

    @property
    def count(self) -> int:
        with self._mu:
            return self._count

    @property
    def sum(self) -> float:
        with self._mu:
            return self._sum

    def _sample(self) -> Dict[str, Any]:
        with self._mu:
            counts, total, n = list(self._counts), self._sum, self._count
        cum, cumulative = 0, []
        for bound, c in zip(self._buckets, counts):
            cum += c
            cumulative.append({"le": bound, "count": cum})
        return {"count": n, "sum": total, "buckets": cumulative}

    def _reset(self) -> None:
        with self._mu:
            self._counts = [0] * len(self._buckets)
            self._sum = 0.0
            self._count = 0


class _Timer:
    __slots__ = ("_hist", "_t0")

    def __init__(self, hist: Histogram):
        self._hist = hist

    def __enter__(self) -> "_Timer":
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        self._hist.observe(time.perf_counter() - self._t0)


_KINDS = {"counter": Counter, "gauge": Gauge, "histogram": Histogram}


class Family:
    """One named metric family: fixed label names, one child per
    label-value tuple. With no label names the family proxies its single
    child, so unlabeled metrics read naturally (``family.inc()``)."""

    __slots__ = ("name", "help", "kind", "labelnames", "_buckets",
                 "_children", "_mu", "_registry")

    def __init__(
        self,
        registry: "Registry",
        name: str,
        help: str,
        kind: str,
        labelnames: Sequence[str],
        buckets: Optional[Sequence[float]] = None,
    ):
        self.name = name
        self.help = help
        self.kind = kind
        self.labelnames = tuple(labelnames)
        if buckets is not None:
            # validate at registration, not first observation -- a bad
            # bucket spec should fail the module import that wrote it
            b = tuple(float(x) for x in buckets)
            if not b or any(b[i] >= b[i + 1] for i in range(len(b) - 1)):
                raise ValueError(f"buckets must be strictly increasing, got {b}")
            self._buckets = b
        else:
            self._buckets = None
        self._children: Dict[Tuple[str, ...], Any] = {}
        self._mu = threading.Lock()
        self._registry = registry

    def _make_child(self):
        if self.kind == "histogram":
            return Histogram(self, self._buckets or LATENCY_BUCKETS)
        return _KINDS[self.kind](self)

    def labels(self, **kv: Any):
        """The child for one label-value assignment (cached). Values are
        stringified -- label values are identifiers, not data."""
        if set(kv) != set(self.labelnames):
            raise ValueError(
                f"{self.name} wants labels {self.labelnames}, got {sorted(kv)}"
            )
        key = tuple(str(kv[ln]) for ln in self.labelnames)
        child = self._children.get(key)
        if child is None:
            with self._mu:
                child = self._children.setdefault(key, self._make_child())
        return child

    def get(self, **kv: Any):
        """The child for one label assignment IF it exists, else None.
        Read-side queries (artifact listings, telemetry snapshots) go
        through this so looking at a metric never mints a zero sample."""
        if set(kv) != set(self.labelnames):
            raise ValueError(
                f"{self.name} wants labels {self.labelnames}, got {sorted(kv)}"
            )
        return self._children.get(tuple(str(kv[ln]) for ln in self.labelnames))

    # -- unlabeled convenience: the family IS its single child ------------
    def _solo(self):
        if self.labelnames:
            raise ValueError(
                f"{self.name} has labels {self.labelnames}; use .labels(...)"
            )
        return self.labels()

    def inc(self, n: float = 1.0) -> None:
        self._solo().inc(n)

    def dec(self, n: float = 1.0) -> None:
        self._solo().dec(n)

    def set(self, v: float) -> None:
        self._solo().set(v)

    def observe(self, v: float) -> None:
        self._solo().observe(v)

    def time(self) -> _Timer:
        return self._solo().time()

    @property
    def value(self) -> float:
        return self._solo().value

    @property
    def count(self) -> int:
        return self._solo().count

    @property
    def sum(self) -> float:
        return self._solo().sum

    def _snapshot(self) -> Dict[str, Any]:
        with self._mu:
            items = sorted(self._children.items())
        return {
            "type": self.kind,
            "help": self.help,
            "labelnames": list(self.labelnames),
            "samples": [
                {"labels": dict(zip(self.labelnames, key)), **child._sample()}
                for key, child in items
            ],
        }


class Registry:
    """Process-wide named metric families with snapshot/reset semantics.

    Registration is idempotent: asking for an already-registered name with
    the same (kind, labelnames) returns the existing family, so module
    init order never matters; a *conflicting* re-registration raises.
    """

    def __init__(self, disabled: Optional[bool] = None):
        self._mu = threading.Lock()
        self._families: Dict[str, Family] = {}
        if disabled is None:
            disabled = os.environ.get(DISABLED_ENV, "") == "1"
        self.disabled = bool(disabled)

    # ---- registration -----------------------------------------------------
    def _register(
        self,
        kind: str,
        name: str,
        help: str,
        labels: Sequence[str],
        buckets: Optional[Sequence[float]] = None,
    ) -> Family:
        with self._mu:
            fam = self._families.get(name)
            if fam is not None:
                if fam.kind != kind or fam.labelnames != tuple(labels):
                    raise ValueError(
                        f"metric {name!r} already registered as {fam.kind}"
                        f"{fam.labelnames}; cannot re-register as {kind}"
                        f"{tuple(labels)}"
                    )
                return fam
            fam = Family(self, name, help, kind, labels, buckets)
            self._families[name] = fam
            return fam

    def counter(self, name: str, help: str = "", labels: Sequence[str] = ()) -> Family:
        return self._register("counter", name, help, labels)

    def gauge(self, name: str, help: str = "", labels: Sequence[str] = ()) -> Family:
        return self._register("gauge", name, help, labels)

    def histogram(
        self,
        name: str,
        help: str = "",
        labels: Sequence[str] = (),
        buckets: Optional[Sequence[float]] = None,
    ) -> Family:
        return self._register("histogram", name, help, labels, buckets)

    # ---- snapshot / reset -------------------------------------------------
    def snapshot(self) -> Dict[str, Any]:
        """Deterministic plain-dict snapshot (sorted family names, sorted
        label tuples), fully decoupled from live children."""
        with self._mu:
            fams = sorted(self._families.items())
        return {name: fam._snapshot() for name, fam in fams}

    def reset(self) -> None:
        """Zero every child in place; registrations (and child identity --
        instrumented code holds direct references) survive."""
        with self._mu:
            fams = list(self._families.values())
        for fam in fams:
            with fam._mu:
                children = list(fam._children.values())
            for child in children:
                child._reset()

    # ---- exporters ---------------------------------------------------------
    def render_json(self, snapshot: Optional[Mapping[str, Any]] = None) -> bytes:
        """Canonical JSON (sorted keys, compact separators): equal
        snapshots always render to identical bytes."""
        snap = self.snapshot() if snapshot is None else snapshot
        return json.dumps(
            snap, sort_keys=True, separators=(",", ":"), allow_nan=False
        ).encode()

    def render_prometheus(
        self, snapshot: Optional[Mapping[str, Any]] = None
    ) -> bytes:
        """Prometheus text exposition format (version 0.0.4)."""
        snap = self.snapshot() if snapshot is None else snapshot
        lines: List[str] = []
        for name, fam in snap.items():
            if fam["help"]:
                lines.append(f"# HELP {name} {fam['help']}")
            lines.append(f"# TYPE {name} {fam['type']}")
            for s in fam["samples"]:
                labels = s["labels"]
                if fam["type"] == "histogram":
                    for b in s["buckets"]:
                        lines.append(
                            name + "_bucket"
                            + _labelstr({**labels, "le": _fmt(b["le"])})
                            + f" {b['count']}"
                        )
                    lines.append(
                        name + "_bucket" + _labelstr({**labels, "le": "+Inf"})
                        + f" {s['count']}"
                    )
                    lines.append(name + "_sum" + _labelstr(labels) + f" {_fmt(s['sum'])}")
                    lines.append(name + "_count" + _labelstr(labels) + f" {s['count']}")
                else:
                    lines.append(name + _labelstr(labels) + f" {_fmt(s['value'])}")
        return ("\n".join(lines) + "\n").encode()


def _fmt(v: float) -> str:
    """Prometheus number formatting: integers without the trailing .0."""
    if isinstance(v, float) and math.isfinite(v) and v == int(v) and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v))


def _escape(v: str) -> str:
    return v.replace("\\", r"\\").replace('"', r"\"").replace("\n", r"\n")


def _labelstr(labels: Mapping[str, Any]) -> str:
    if not labels:
        return ""
    inner = ",".join(f'{k}="{_escape(str(v))}"' for k, v in sorted(labels.items()))
    return "{" + inner + "}"


#: THE default registry every instrumented subsystem registers into (and
#: the one ``GET /v1/metrics`` serves). Honors ``REPRO_OBS_DISABLED=1``.
_DEFAULT = Registry()


def get_registry() -> Registry:
    return _DEFAULT


def set_disabled(disabled: Optional[bool] = None) -> bool:
    """Flip the default registry's kill switch; ``None`` re-reads
    :data:`DISABLED_ENV` (how benchmarks A/B the instrumentation overhead
    in-process). Returns the new state."""
    if disabled is None:
        disabled = os.environ.get(DISABLED_ENV, "") == "1"
    _DEFAULT.disabled = bool(disabled)
    return _DEFAULT.disabled
