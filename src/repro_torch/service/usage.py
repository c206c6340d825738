"""Persistent per-artifact usage accounting + kind-aware retention.

The gateway's in-memory hit counters die with the process, which makes
them useless for the question retention actually asks: *which artifacts
earn their disk over weeks?* This module persists the accounting:

* :class:`UsageLedger` -- per-store-root hit/byte/last-access/client
  accounting, buffered in memory and periodically flushed to one atomic
  JSON file **beside** the root (``.usage-ledger.json``; dot-prefixed so
  :meth:`ArtifactStore.keys` never mistakes it for an artifact). Flushes
  MERGE with the on-disk state under a bounded ``flock`` (the same
  discipline as build locks), so N gateway replicas over one shared root
  each fold their deltas in without losing each other's -- and a restart
  resumes exactly where the last flush left off.
* :func:`retention_plan` -- a deterministic, kind-aware GC plan over a
  store's entries + its ledger: telemetry snapshots age out first (cap,
  oldest-first), sweeps referenced by a live portfolio member are never
  evicted, and an optional total-artifact cap evicts the coldest
  unprotected artifacts (fewest hits, oldest access, key order). The
  plan is pure data -- ``cli gc --dry-run`` prints it, ``--apply``
  executes it via :meth:`ArtifactStore.delete`.

Nothing here is ever on the answer path: :meth:`UsageLedger.record` is a
dict update under one lock, and a flush that cannot win the file lock
within its bound simply keeps its deltas buffered for the next try.
"""

from __future__ import annotations

import json
import os
import tempfile
import time
from threading import Lock
from typing import Any, Dict, List, Optional, Sequence

try:
    import fcntl
except ImportError:  # pragma: no cover - non-POSIX: lock-free merge
    fcntl = None

__all__ = [
    "LEDGER_FILENAME",
    "LEDGER_VERSION",
    "UsageLedger",
    "retention_plan",
]

LEDGER_FILENAME = ".usage-ledger.json"
LEDGER_VERSION = 1

#: distinct client buckets tracked per artifact before folding the long
#: tail into ``"other"`` -- the ledger must stay small no matter how
#: many X-Repro-Client values the internet invents.
MAX_CLIENT_BUCKETS = 16


def _merge_record(into: Dict[str, Any], delta: Dict[str, Any]) -> None:
    into["hits"] = int(into.get("hits", 0)) + int(delta.get("hits", 0))
    into["bytes"] = int(into.get("bytes", 0)) + int(delta.get("bytes", 0))
    la = delta.get("last_access")
    if la is not None and (into.get("last_access") is None
                           or la > into["last_access"]):
        into["last_access"] = la
    clients = into.setdefault("clients", {})
    for bucket, n in delta.get("clients", {}).items():
        clients[bucket] = int(clients.get(bucket, 0)) + int(n)
    if len(clients) > MAX_CLIENT_BUCKETS:
        # deterministic fold: keep the highest-traffic buckets, sum the
        # tail into "other" (ties break by name so replicas agree)
        keep = sorted(clients.items(), key=lambda kv: (-kv[1], kv[0]))
        head = dict(keep[: MAX_CLIENT_BUCKETS - 1])
        tail = sum(n for _, n in keep[MAX_CLIENT_BUCKETS - 1:])
        head["other"] = head.pop("other", 0) + tail
        clients.clear()
        clients.update(head)


class UsageLedger:
    """Crash-safe usage accounting for one artifact-store root."""

    def __init__(self, root: str, *, flush_interval_s: float = 60.0,
                 clock=time.time, lock_timeout_s: float = 2.0):
        self.root = os.path.abspath(root)
        self.path = os.path.join(self.root, LEDGER_FILENAME)
        self._lock_path = os.path.join(self.root, LEDGER_FILENAME + ".lock")
        self._flush_interval = float(flush_interval_s)
        self._lock_timeout = float(lock_timeout_s)
        self._clock = clock
        self._mu = Lock()
        self._pending: Dict[str, Dict[str, Any]] = {}
        self._last_flush = float(clock())
        self._persisted = self._read_file()

    # ---- disk ---------------------------------------------------------------
    def _read_file(self) -> Dict[str, Dict[str, Any]]:
        try:
            with open(self.path) as f:
                doc = json.load(f)
        except (OSError, ValueError):
            return {}
        if not isinstance(doc, dict) or doc.get("v") != LEDGER_VERSION:
            return {}
        arts = doc.get("artifacts")
        return dict(arts) if isinstance(arts, dict) else {}

    def _locked(self):
        """Bounded-wait exclusive flock over the ledger file, or None when
        the lock cannot be won in time (callers then skip the flush and
        keep deltas buffered -- serving never blocks on accounting)."""
        if fcntl is None:
            return -1  # lock-free platforms: merge unatomically but honestly
        fd = os.open(self._lock_path, os.O_CREAT | os.O_RDWR, 0o644)
        t0 = time.perf_counter()
        while True:
            try:
                fcntl.flock(fd, fcntl.LOCK_EX | fcntl.LOCK_NB)
                return fd
            except (BlockingIOError, InterruptedError):
                if time.perf_counter() - t0 >= self._lock_timeout:
                    os.close(fd)
                    return None
                time.sleep(0.005)

    def _unlock(self, fd: int) -> None:
        if fd >= 0 and fcntl is not None:
            fcntl.flock(fd, fcntl.LOCK_UN)
            os.close(fd)

    # ---- write path ---------------------------------------------------------
    def record(self, key: str, n: int = 1, nbytes: int = 0,
               client: Optional[str] = None) -> None:
        """Buffer one access. O(1), one lock, no I/O."""
        now = float(self._clock())
        with self._mu:
            rec = self._pending.setdefault(
                key, {"hits": 0, "bytes": 0, "last_access": None, "clients": {}}
            )
            rec["hits"] += int(n)
            rec["bytes"] += int(nbytes)
            rec["last_access"] = now
            if client:
                b = str(client)[:64]
                rec["clients"][b] = rec["clients"].get(b, 0) + int(n)

    def maybe_flush(self) -> bool:
        """Flush iff the interval elapsed and there is anything to write.
        Cheap enough for a request path (one clock read when idle)."""
        with self._mu:
            due = (self._pending
                   and float(self._clock()) - self._last_flush
                   >= self._flush_interval)
        return self.flush() if due else False

    def flush(self) -> bool:
        """Merge buffered deltas into the on-disk ledger atomically.
        Returns True when the file was updated; False when there was
        nothing to write or the file lock could not be won (deltas stay
        buffered -- nothing is lost either way)."""
        with self._mu:
            if not self._pending:
                self._last_flush = float(self._clock())
                return False
            pending, self._pending = self._pending, {}
        fd = self._locked()
        if fd is None:
            with self._mu:  # lock contention: re-buffer for the next try
                for key, delta in pending.items():
                    rec = self._pending.setdefault(
                        key, {"hits": 0, "bytes": 0, "last_access": None,
                              "clients": {}}
                    )
                    _merge_record(rec, delta)
            return False
        try:
            disk = self._read_file()
            for key, delta in pending.items():
                _merge_record(disk.setdefault(key, {}), delta)
            doc = {
                "v": LEDGER_VERSION,
                "updated_at": float(self._clock()),
                "artifacts": disk,
            }
            tmpfd, tmp = tempfile.mkstemp(prefix=".usage-", dir=self.root)
            try:
                with os.fdopen(tmpfd, "w") as f:
                    json.dump(doc, f, sort_keys=True, separators=(",", ":"))
                os.replace(tmp, self.path)
            except BaseException:
                if os.path.exists(tmp):
                    os.unlink(tmp)
                raise
            with self._mu:
                self._persisted = disk
                self._last_flush = float(self._clock())
            return True
        finally:
            self._unlock(fd)

    # ---- read path ----------------------------------------------------------
    def snapshot(self) -> Dict[str, Dict[str, Any]]:
        """Merged persisted + buffered view, per artifact key. The shape
        each record takes: ``{hits, bytes, last_access, clients}``."""
        with self._mu:
            merged: Dict[str, Dict[str, Any]] = {
                k: {"hits": int(v.get("hits", 0)),
                    "bytes": int(v.get("bytes", 0)),
                    "last_access": v.get("last_access"),
                    "clients": dict(v.get("clients", {}))}
                for k, v in self._persisted.items()
            }
            for key, delta in self._pending.items():
                _merge_record(merged.setdefault(key, {}), delta)
        for rec in merged.values():
            rec.setdefault("hits", 0)
            rec.setdefault("bytes", 0)
            rec.setdefault("last_access", None)
            rec.setdefault("clients", {})
        return merged

    def get(self, key: str) -> Optional[Dict[str, Any]]:
        """One artifact's merged record, or None when never accessed."""
        return self.snapshot().get(key)


def retention_plan(
    entries: Sequence[Dict[str, Any]],
    usage: Dict[str, Dict[str, Any]],
    *,
    telemetry_cap: int = 32,
    max_artifacts: Optional[int] = None,
) -> Dict[str, Any]:
    """A deterministic, kind-aware eviction plan for one store root.

    ``entries`` are :meth:`ArtifactStore.entries` rows (must carry
    ``key`` and ``kind``; portfolio rows carry the member ``sweep_key``
    either in the row or in the artifact payload -- pass it through as
    ``sweep_key``). ``usage`` is a :meth:`UsageLedger.snapshot`.

    Rules, in order:

    1. **Protected, never evicted**: portfolio manifests themselves, and
       any sweep referenced by a portfolio's ``sweep_key`` (evicting the
       matrix behind a live routing policy would turn ``/v1/route`` into
       503s).
    2. **Telemetry ages out first**: keep the newest ``telemetry_cap``
       snapshots (by ``collected_at``, ties by key), evict the rest.
    3. **Cold-artifact cap** (optional): when ``max_artifacts`` is set
       and the post-telemetry population still exceeds it, evict
       unprotected artifacts coldest-first -- fewest ledger hits, then
       oldest ``last_access`` (never-accessed sorts coldest), then key
       -- with measurements/calibrations/telemetry preferred over
       sweeps at equal coldness.

    The plan is plain data (canonical-JSON-stable): ``evict`` rows carry
    key/kind/reason, plus ``kept``/``protected`` key lists, so two
    replicas planning over the same root emit identical bytes.
    """
    if telemetry_cap < 0:
        raise ValueError(f"telemetry_cap must be >= 0, got {telemetry_cap}")
    rows = {str(e["key"]): e for e in entries}
    protected: Dict[str, str] = {}
    for key, e in rows.items():
        if e.get("kind") == "portfolio":
            protected[key] = "portfolio manifest"
            sk = e.get("sweep_key")
            if sk and sk in rows:
                protected[str(sk)] = f"sweep behind portfolio {key[:12]}"

    evict: List[Dict[str, Any]] = []
    evicted: set = set()

    # rule 2: telemetry cap, oldest collected_at first
    telemetry = [
        (e.get("collected_at") or 0.0, key)
        for key, e in rows.items()
        if e.get("kind") == "telemetry" and key not in protected
    ]
    telemetry.sort()
    if len(telemetry) > telemetry_cap:
        for at, key in telemetry[: len(telemetry) - telemetry_cap]:
            evict.append({
                "key": key,
                "kind": "telemetry",
                "reason": f"telemetry beyond cap {telemetry_cap} (oldest first)",
            })
            evicted.add(key)

    # rule 3: optional total cap, coldest unprotected first
    if max_artifacts is not None and max_artifacts >= 0:
        remaining = [k for k in rows if k not in evicted]
        if len(remaining) > max_artifacts:
            # sweeps evict last among equals: kind_rank orders the
            # expendable kinds ahead of the expensive-to-rebuild matrix
            kind_rank = {"telemetry": 0, "measurement": 1,
                         "calibration": 2, "sweep": 3, "portfolio": 4}
            def coldness(key: str):
                u = usage.get(key, {})
                return (
                    int(u.get("hits", 0)),
                    float(u.get("last_access") or 0.0),
                    kind_rank.get(rows[key].get("kind", "sweep"), 3),
                    key,
                )
            candidates = sorted(
                (k for k in remaining if k not in protected), key=coldness
            )
            need = len(remaining) - max_artifacts
            for key in candidates[:need]:
                u = usage.get(key, {})
                evict.append({
                    "key": key,
                    "kind": rows[key].get("kind", "sweep"),
                    "reason": (
                        f"over max_artifacts={max_artifacts}: "
                        f"{int(u.get('hits', 0))} hits"
                    ),
                })
                evicted.add(key)

    evict.sort(key=lambda e: e["key"])
    return {
        "evict": evict,
        "kept": sorted(k for k in rows if k not in evicted),
        "protected": {k: protected[k] for k in sorted(protected)},
        "telemetry_cap": telemetry_cap,
        "max_artifacts": max_artifacts,
    }
