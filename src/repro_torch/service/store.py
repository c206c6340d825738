"""Versioned on-disk artifact store for eq.-18 sweep results.

The JAX package's store, with the same on-disk format (``FORMAT_VERSION``,
file layout, manifest keys, content keys), so either package can serve
the other's artifacts. Two differences: the stencil family only (LM
artifacts' JSON reads, but keying, writing or materializing one raises
until LM codesign is ported), and the digest engine (:func:`_digest_engine`)
knows the port's ``"torch"`` engine.

The separability decomposition makes the ``(cells x hardware)`` optima
matrix the unit of reuse: every §V.B analysis (re-weighted mixes, top-k
under an area budget, Pareto fronts, what-if subspaces) is a cheap
re-reduction over it. This module persists :class:`repro_torch.core.codesign
.CodesignResult` so that reuse survives the process:

* one directory per artifact: ``manifest.json`` (workload cells with full
  stencil specs, GPU constants, lattices, shapes, spec) + ``cell_time.npy``
  (the big (C, H) float64 matrix, written raw so it can be **memory-mapped**
  on load) + ``arrays.npz`` (compressed: tile argmins and the hardware-space
  columns);
* **content-addressed keys**: sha256 over a canonical-JSON spec of
  (stencil set incl. numeric model constants, size grid, hardware-space
  digest, GPU constants, lattices, engine, format version). Same question
  -> same key; any change to the inputs that could change the matrix ->
  a different key (see ``tests/test_torch_service.py``);
* lazy loading: :class:`Artifact` reads the manifest eagerly (small JSON)
  and materializes arrays on first attribute access -- ``cell_time`` as an
  ``mmap_mode="r"`` view, the npz members on demand;
* atomic writes: artifacts are staged in a temp directory and renamed into
  place, so readers never observe a half-written artifact; an exclusive
  per-key ``flock`` (:meth:`ArtifactStore.build_lock`) serializes
  concurrent builders across processes -- the loser reuses the winner's
  artifact instead of re-solving/re-staging.
"""

from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import json
import os
import shutil
import tempfile
import threading
import time
from typing import Dict, List, Optional

import numpy as np

from repro_torch.obs.metrics import get_registry as _obs_registry

try:  # POSIX file locks for the cross-process build path
    import fcntl
except ImportError:  # pragma: no cover - non-POSIX: fall back to lock-free
    fcntl = None

#: process-wide registry of held build locks: lock-file path -> [fd, depth].
#: flock is per open-file-description, so re-opening the same lock file in
#: one process (server wraps the whole build, put wraps the staged write)
#: would self-deadlock; the registry makes :meth:`ArtifactStore.build_lock`
#: reentrant *within* a process while staying exclusive *across* processes.
_HELD_LOCKS: Dict[str, list] = {}
_HELD_LOCKS_MU = threading.Lock()

from repro_torch.core.codesign import _AUTO_MIN_HW, CodesignResult, HardwareSpace
from repro_torch.core.solver import LATTICE_2D, LATTICE_3D, TileLattice
from repro_torch.core.timemodel import GPUSpec
from repro_torch.core.workload import Workload

from . import faults
from .errors import ERROR_HTTP_STATUS, GatewayError
from .resilience import check_deadline, remaining_s

__all__ = [
    "FORMAT_VERSION",
    "KINDS",
    "Artifact",
    "ArtifactStore",
    "BuildLockTimeoutError",
    "artifact_spec",
    "lm_artifact_spec",
    "spec_key",
]

#: default bound on how long :meth:`ArtifactStore.build_lock` waits for
#: another process's flock before failing structured (seconds). Generous
#: on purpose -- a full-space sweep legitimately takes minutes -- and
#: overridable per store (``lock_timeout_s=``), per acquisition
#: (``timeout_s=``), or process-wide via ``REPRO_LOCK_TIMEOUT_S``.
DEFAULT_LOCK_TIMEOUT_S = 600.0

#: bump when the on-disk layout or the solver semantics change; old
#: artifacts then read as misses (the store rebuilds, never mis-serves).
FORMAT_VERSION = 1

#: manifest kinds one store can hold (the JAX package's list, so one store
#: serves both packages). "sweep" is the (C, H) optima matrix (manifest +
#: cell_time.npy + arrays.npz); "measurement" and "calibration" are
#: manifest-only JSON artifacts written by :mod:`repro_torch.measure.cli`
#: (timing runs / refitted machine parameters); "telemetry" and
#: "portfolio" are manifest-only kinds the JAX package's gateway and
#: portfolio layer write. Manifests written before kinds existed read as
#: "sweep".
KINDS = ("sweep", "measurement", "calibration", "telemetry", "portfolio")

#: engines whose optima matrices are bit-identical share one content
#: address: the JAX package's "sharded" is its "jax" program over a device
#: mesh, so both digest as "jax" -- the port never sweeps with either, but
#: must recompute such an artifact's key to serve it. "numpy" is the same
#: float64 oracle in both packages and keeps the JAX package's key.
#: "torch" is the port's float32 broadcast engine: its matrix agrees with
#: "jax" and "numpy" only up to ties at RTOL 1e-5, so it keeps a key of
#: its own and never shares one with either. "auto" is resolved to the
#: concrete engine it would pick *before* digesting.
_DIGEST_ENGINE = {"sharded": "jax"}

#: engine names a key may digest: the port's own and the JAX package's.
_DIGEST_NAMES = ("auto", "torch", "numpy", "jax", "sharded")

# ---- observability (repro_torch.obs; no-ops under REPRO_OBS_DISABLED=1) --
_REG = _obs_registry()
_M_BUILDS = _REG.counter(
    "repro_store_builds_total",
    "artifacts committed by a staged write, by manifest kind",
    labels=("kind",),
)
_M_OPENS = _REG.counter(
    "repro_store_opens_total",
    "successful artifact opens via ArtifactStore.get",
)
_M_LOCK_WAIT = _REG.histogram(
    "repro_store_lock_wait_seconds",
    "wall time blocked acquiring a per-key build flock (cross-process "
    "build contention)",
)
_M_LOCK_TIMEOUTS = _REG.counter(
    "repro_store_build_lock_timeouts_total",
    "build-lock acquisitions abandoned at their wait bound "
    "(structured build_lock_timeout errors instead of hung threads)",
)


class BuildLockTimeoutError(GatewayError):
    """Another process held a key's build flock past the caller's wait
    bound (HTTP 503, wire code ``build_lock_timeout``). Retryable: the
    holder is usually a legitimate builder that will finish."""

    code = "build_lock_timeout"
    http_status = ERROR_HTTP_STATUS["build_lock_timeout"]

    def __init__(self, message: str, retry_after_s: float = 5.0):
        super().__init__(message)
        self.retry_after_s = float(retry_after_s)


def _digest_engine(engine: str, n_hw: int) -> str:
    """The matrix family a key names. ``"auto"`` resolves by the port's
    own rule (:func:`repro_torch.core.codesign._resolve_engine`): numpy
    below ``_AUTO_MIN_HW`` hardware points, else torch. An unknown name
    raises rather than being keyed under some other engine's matrix."""
    if engine not in _DIGEST_NAMES:
        raise ValueError(
            f"unknown engine {engine!r} (want one of {list(_DIGEST_NAMES)})"
        )
    if engine == "auto":
        engine = "numpy" if n_hw < _AUTO_MIN_HW else "torch"
    return _DIGEST_ENGINE.get(engine, engine)


#: what an LM-family entry point says: the family is not ported yet.
_LM_TODO = (
    "LM-workload artifacts are not ported to repro_torch yet "
    "(ROADMAP Queue 1 item 7, LM-workload codesign)"
)


def _canonical_json(obj) -> str:
    return json.dumps(obj, sort_keys=True, separators=(",", ":"))


def _array_digest(*arrays: np.ndarray) -> str:
    h = hashlib.sha256()
    for a in arrays:
        a = np.ascontiguousarray(np.asarray(a, np.float64))
        h.update(str(a.shape).encode())
        h.update(a.tobytes())
    return h.hexdigest()


def artifact_spec(
    workload: Workload,
    gpu: GPUSpec,
    hw: HardwareSpace,
    engine: str,
    lattice_2d: TileLattice = LATTICE_2D,
    lattice_3d: TileLattice = LATTICE_3D,
) -> dict:
    """The content-address identity of a sweep, computable WITHOUT running
    it. Frequencies are deliberately excluded: the stored matrix serves
    every mix, so re-weighting must not change the key."""
    lat_d = lambda lat: {k: list(getattr(lat, k)) for k in ("t_s1", "t_s2", "t_t", "k", "t_s3")}
    return {
        "format_version": FORMAT_VERSION,
        "stencils": sorted(
            {c.stencil.name: dataclasses.asdict(c.stencil) for c in workload.cells}.values(),
            key=lambda d: d["name"],
        ),
        "cells": [
            [c.stencil.name, int(c.size.s1), int(c.size.s2), int(c.size.s3), int(c.size.t)]
            for c in workload.cells
        ],
        "gpu": dataclasses.asdict(gpu),
        "hw_digest": _array_digest(hw.n_sm, hw.n_v, hw.m_sm, hw.area),
        "n_hw": len(hw),
        "lattices": {"2d": lat_d(lattice_2d), "3d": lat_d(lattice_3d)},
        "engine": _digest_engine(engine, len(hw)),
    }


def lm_artifact_spec(workload: Workload, hw, engine: str, gpu_name: str) -> dict:
    """Content-address identity of an LM-family sweep: not ported yet."""
    raise NotImplementedError(_LM_TODO)


def spec_key(spec: dict) -> str:
    return hashlib.sha256(_canonical_json(spec).encode()).hexdigest()[:20]


class Artifact:
    """Lazy read handle over one stored sweep.

    The manifest is loaded eagerly; ``cell_time`` is an mmap-backed view
    materialized on first access (queries that never touch a row never page
    it in), and the smaller arrays decompress from the npz on demand.
    """

    def __init__(self, path: str):
        self.path = path
        with open(os.path.join(path, "manifest.json")) as f:
            self.manifest = json.load(f)
        self.key: str = self.manifest["key"]
        self._cell_time: Optional[np.ndarray] = None
        self._npz = None
        self._cache: Dict[str, np.ndarray] = {}

    # ---- shapes / metadata ------------------------------------------------
    @property
    def kind(self) -> str:
        """Manifest kind; pre-kind manifests are sweep artifacts."""
        return self.manifest.get("kind", "sweep")

    @property
    def payload(self) -> dict:
        """The JSON body of a manifest-only artifact (measurement run /
        calibration); empty for sweep artifacts."""
        return self.manifest.get("payload", {})

    @property
    def n_cells(self) -> int:
        return int(self.manifest["shapes"]["cells"])

    @property
    def n_hw(self) -> int:
        return int(self.manifest["shapes"]["hw"])

    @property
    def family(self) -> str:
        """Cell family of a sweep artifact ("stencil" | "lm"); manifests
        written before families existed are stencil sweeps."""
        return self.manifest.get("workload", {}).get("family", "stencil")

    @property
    def stencil_names(self) -> List[str]:
        seen: Dict[str, None] = {}
        for c in self.manifest["workload"]["cells"]:
            seen.setdefault(c["stencil"]["name"])
        return list(seen)

    @property
    def cell_labels(self) -> List[str]:
        """Distinct cell group labels: stencil names, or ``model:op`` for
        the LM family."""
        if self.family == "lm":
            seen: Dict[str, None] = {}
            for c in self.manifest["workload"]["cells"]:
                seen.setdefault(f"{c['model']}:{c['op']}")
            return list(seen)
        return self.stencil_names

    def routing(self) -> Dict[str, object]:
        """The manifest-only attribute row a gateway indexes this artifact
        under: content key, GPU target, workload name, stencil set,
        hardware-space digest, resolved engine family, and shapes.

        Derivable from the (small) JSON manifest alone -- listing a fleet
        store never mmaps a matrix. Falls back to recomputing the fields
        for artifacts written before the manifest grew a ``"routing"``
        block (same format version, older writer). Non-sweep kinds
        (measurement / calibration manifests) carry whatever their writer
        put in the routing block, plus key/kind/format_version."""
        m = self.manifest
        spec = m.get("spec", {})
        r = dict(m.get("routing") or {})
        if self.kind != "sweep":
            r.update(
                key=self.key,
                kind=self.kind,
                format_version=m.get("format_version"),
            )
            return r
        r.setdefault("gpu", m["gpu"]["name"])
        r.setdefault("workload", m["workload"]["name"])
        r.setdefault("family", self.family)
        if self.family == "lm":
            cells = m["workload"]["cells"]
            r.setdefault("models", sorted({c["model"] for c in cells}))
            r.setdefault("ops", sorted({c["op"] for c in cells}))
        else:
            r.setdefault("stencils", sorted(self.stencil_names))
        r.update(
            key=self.key,
            kind=self.kind,
            hw_digest=spec.get("hw_digest"),
            engine=spec.get("engine", m.get("engine")),
            cells=self.n_cells,
            hw=self.n_hw,
            format_version=m.get("format_version"),
        )
        return r

    def cell_freqs(self) -> np.ndarray:
        """(C,) stored workload frequencies (the artifact's own mix)."""
        return np.array(
            [c["freq"] for c in self.manifest["workload"]["cells"]], np.float64
        )

    def cell_flops(self) -> np.ndarray:
        """(C,) useful flops per cell -- the GFLOP/s numerator. Stencil
        cells derive it from the model (flops/point x points); LM cells
        store it precomputed in their constants."""
        cells = self.manifest["workload"]["cells"]
        if self.family == "lm":
            return np.array([c["consts"]["flops"] for c in cells], np.float64)
        out = np.empty(self.n_cells, np.float64)
        for i, c in enumerate(cells):
            sz = c["size"]
            points = float(sz["s1"]) * sz["s2"] * sz["s3"] * sz["t"]
            out[i] = c["stencil"]["flops_per_point"] * points
        return out

    # ---- arrays -----------------------------------------------------------
    @property
    def cell_time(self) -> np.ndarray:
        if self._cell_time is None:
            self._cell_time = np.load(
                os.path.join(self.path, "cell_time.npy"), mmap_mode="r"
            )
        return self._cell_time

    def _arr(self, name: str) -> np.ndarray:
        if name not in self._cache:
            if self._npz is None:
                self._npz = np.load(os.path.join(self.path, "arrays.npz"))
            self._cache[name] = self._npz[name]
        return self._cache[name]

    @property
    def cell_tile_idx(self) -> np.ndarray:
        return self._arr("cell_tile_idx")

    @property
    def hw_n_sm(self) -> np.ndarray:
        return self._arr("hw_n_sm")

    @property
    def hw_n_v(self) -> np.ndarray:
        return self._arr("hw_n_v")

    @property
    def hw_m_sm(self) -> np.ndarray:
        return self._arr("hw_m_sm")

    @property
    def hw_area(self) -> np.ndarray:
        return self._arr("hw_area")

    def hw_column(self, name: str) -> np.ndarray:
        """Hardware-space column by design-parameter name (what-if filters).
        Column names are family-specific: ``n_sm/n_v/m_sm/area`` for
        stencil sweeps, ``pod/data/model/chips/area`` for LM sweeps (where
        area IS the chip count)."""
        if self.family == "lm":
            cols = {"pod": "hw_pod", "data": "hw_data", "model": "hw_model",
                    "chips": "hw_area", "area": "hw_area"}
        else:
            cols = {"n_sm": "hw_n_sm", "n_v": "hw_n_v", "m_sm": "hw_m_sm",
                    "area": "hw_area"}
        if name not in cols:
            raise KeyError(f"unknown hardware parameter {name!r} (want one of {sorted(cols)})")
        return self._arr(cols[name])

    def point(self, i: int) -> Dict[str, float]:
        """Design parameters of hardware point ``i`` as a plain dict."""
        if self.family == "lm":
            return {
                "pod": int(self._arr("hw_pod")[i]),
                "data": int(self._arr("hw_data")[i]),
                "model": int(self._arr("hw_model")[i]),
                "chips": int(self.hw_area[i]),
            }
        return {
            "n_sm": int(self.hw_n_sm[i]),
            "n_v": int(self.hw_n_v[i]),
            "m_sm": float(self.hw_m_sm[i]),
            "area": float(self.hw_area[i]),
        }

    def to_result(self):
        """Materialize the full in-process result object (round-trip
        inverse of :meth:`ArtifactStore.put`); stencil family only."""
        if self.family == "lm":
            raise NotImplementedError(_LM_TODO)
        arrays = {
            "cell_time": self.cell_time,
            "cell_tile_idx": self.cell_tile_idx,
            "hw_n_sm": self.hw_n_sm,
            "hw_n_v": self.hw_n_v,
            "hw_m_sm": self.hw_m_sm,
            "hw_area": self.hw_area,
        }
        return CodesignResult.from_artifact_payload(self.manifest, arrays)


class ArtifactStore:
    """Directory of content-addressed sweep artifacts.

    ``create=False`` opens an existing root without creating it (a serving
    front-end must not silently conjure empty stores out of typo'd paths);
    the default keeps the build-path ergonomics of ``put`` into a fresh
    directory."""

    def __init__(self, root: str, create: bool = True,
                 lock_timeout_s: Optional[float] = None):
        self.root = os.path.abspath(root)
        if create:
            os.makedirs(self.root, exist_ok=True)
        elif not os.path.isdir(self.root):
            raise FileNotFoundError(f"artifact store root {self.root!r} does not exist")
        if lock_timeout_s is None:
            lock_timeout_s = float(
                os.environ.get("REPRO_LOCK_TIMEOUT_S", DEFAULT_LOCK_TIMEOUT_S)
            )
        if lock_timeout_s <= 0:
            raise ValueError("lock_timeout_s must be > 0")
        self.lock_timeout_s = lock_timeout_s

    # ---- keys -------------------------------------------------------------
    def key_for(
        self,
        workload: Workload,
        gpu: GPUSpec,
        hw: HardwareSpace,
        engine: str = "auto",
        lattice_2d: TileLattice = LATTICE_2D,
        lattice_3d: TileLattice = LATTICE_3D,
    ) -> str:
        return spec_key(
            artifact_spec(workload, gpu, hw, engine, lattice_2d, lattice_3d)
        )

    def key_for_lm(
        self, workload: Workload, hw, engine: str = "auto", gpu_name: str = "tpu_v5e"
    ) -> str:
        """Content key of an LM-family sweep: not ported yet."""
        raise NotImplementedError(_LM_TODO)

    def _path(self, key: str) -> str:
        return os.path.join(self.root, key)

    @contextlib.contextmanager
    def build_lock(self, key: str, timeout_s: Optional[float] = None):
        """Exclusive **cross-process** lock for one key's build/staged-write.

        Two processes building the same artifact key serialize here: the
        loser re-checks the store after acquiring and finds the winner's
        artifact instead of re-staging (and, for callers that wrap the
        whole sweep -- :meth:`CodesignServer.ensure_artifact` -- instead of
        re-solving). Reentrant within a process via a refcount registry;
        it is NOT a cross-thread mutex (in-process threads serialize with
        their own locks, as the server does). Lock files are dot-prefixed
        so :meth:`keys` never lists them, and are left in place --
        unlinking a locked path would hand a third process a fresh inode
        and break the mutual exclusion. No-op where ``fcntl`` is
        unavailable (non-POSIX), which degrades to the previous
        benign-rename behavior.

        The wait is **bounded** (a wedged or merely slow holder must not
        park a request thread forever): ``timeout_s`` (default the
        store's ``lock_timeout_s``; generous, because a legitimate
        builder takes minutes) -- capped further by the in-flight
        request's remaining deadline budget when one is active
        (``docs/resilience.md``). Exhausting the bound raises a
        structured :class:`BuildLockTimeoutError` (wire code
        ``build_lock_timeout``) instead of hanging."""
        if fcntl is None:
            yield
            return
        path = os.path.join(self.root, f".lock-{key}")
        with _HELD_LOCKS_MU:
            held = _HELD_LOCKS.get(path)
            if held is not None:
                held[1] += 1
        if held is None:
            budget = self.lock_timeout_s if timeout_s is None else float(timeout_s)
            cap = remaining_s()  # in-flight request deadline, if any
            deadline_capped = cap is not None and cap < budget
            if deadline_capped:
                budget = cap
            fd = os.open(path, os.O_CREAT | os.O_RDWR, 0o644)
            t0 = time.perf_counter()
            try:
                faults.fire("store.lock")
                while True:
                    try:
                        # non-blocking + poll, never LOCK_EX: an
                        # uninterruptible blocking flock is exactly the
                        # unbounded wait this method exists to prevent
                        fcntl.flock(fd, fcntl.LOCK_EX | fcntl.LOCK_NB)
                        break
                    except (BlockingIOError, InterruptedError):
                        waited = time.perf_counter() - t0
                        if waited >= budget:
                            _M_LOCK_TIMEOUTS.inc()
                            why = ("request deadline budget"
                                   if deadline_capped else "wait bound")
                            raise BuildLockTimeoutError(
                                f"build lock for key {key[:12]}... still "
                                f"held by another process after "
                                f"{waited:.1f}s ({why} {budget:.1f}s); "
                                f"the holder is likely building this "
                                f"artifact -- retry later"
                            )
                        time.sleep(min(0.01, max(budget - waited, 0.001)))
            except BaseException:
                os.close(fd)
                raise
            _M_LOCK_WAIT.observe(time.perf_counter() - t0)
            with _HELD_LOCKS_MU:
                _HELD_LOCKS[path] = [fd, 1]
        try:
            yield
        finally:
            with _HELD_LOCKS_MU:
                ent = _HELD_LOCKS[path]
                ent[1] -= 1
                if ent[1] == 0:
                    del _HELD_LOCKS[path]
                    fcntl.flock(ent[0], fcntl.LOCK_UN)
                    os.close(ent[0])

    def _staged_write(self, key: str, write_files) -> Artifact:
        """The shared commit discipline of :meth:`put` / :meth:`put_json`:
        under the cross-process build lock, re-check for a racing winner,
        stage via ``write_files(tmp_dir)`` in a temp dir, and
        ``os.replace`` into place -- tolerating the rename failing only
        when a concurrent same-key builder's artifact is already there
        (content addressing guarantees the bytes match). Lives in ONE
        place because the lost-race tolerance is subtle enough that two
        copies would drift."""
        with self.build_lock(key):
            existing = self.get(key)
            if existing is not None:  # a racing builder finished first
                return existing
            tmp = tempfile.mkdtemp(prefix=f".stage-{key}-", dir=self.root)
            try:
                write_files(tmp)
                try:
                    os.replace(tmp, self._path(key))
                except OSError:
                    if not os.path.exists(
                        os.path.join(self._path(key), "manifest.json")
                    ):
                        raise  # real failure, not a lost same-key race
            finally:
                if os.path.exists(tmp):
                    shutil.rmtree(tmp, ignore_errors=True)
        art = self.get(key)
        assert art is not None
        _M_BUILDS.labels(kind=art.kind).inc()  # this process staged it
        return art

    def has(self, key: str) -> bool:
        """True iff ``key`` is stored AND readable at this format version."""
        return self.get(key) is not None

    def get(self, key: str) -> Optional[Artifact]:
        """None on miss OR format-version mismatch (stale artifacts are
        invisible, never mis-served)."""
        # resilience hooks: the chaos harness injects open latency /
        # load exceptions here, and a request whose deadline budget is
        # already spent fails fast instead of paying the open
        faults.fire("store.open")
        check_deadline("store.open")
        path = self._path(key)
        if not os.path.exists(os.path.join(path, "manifest.json")):
            return None
        art = Artifact(path)
        if art.manifest.get("format_version") != FORMAT_VERSION:
            return None
        _M_OPENS.inc()
        return art

    def put(
        self,
        result: CodesignResult,
        engine: str = "auto",
        extra: Optional[dict] = None,
        lattice_2d: Optional[TileLattice] = None,
        lattice_3d: Optional[TileLattice] = None,
        routing_extra: Optional[dict] = None,
    ) -> Artifact:
        """Persist a sweep result; returns the (re)loaded lazy handle.

        The staged write runs under :meth:`build_lock`, so two processes
        persisting the same key serialize and the loser returns the
        winner's artifact without re-staging (content addressing guarantees
        the bytes match). Writes are still staged in a temp dir and renamed
        into place, so a reader that ignores the lock sees either nothing
        or the whole artifact. ``lattice_2d``/``lattice_3d`` pin the key's
        lattice tables when the workload exercises only one dimensionality
        (otherwise inferred from the result's per-cell lattices, falling
        back to the defaults). ``routing_extra`` merges additional
        attributes into the manifest's routing block (e.g. the
        ``calibration`` key of the fit a calibrated sweep derives from) --
        routing is not part of the content address, so this never moves
        the key. LM results are not ported yet and raise."""
        if getattr(result, "family", "stencil") == "lm":
            raise NotImplementedError(_LM_TODO)
        lat2 = lattice_2d or next(
            (lat for lat in result.lattices if len(lat.t_s3) == 1), LATTICE_2D
        )
        lat3 = lattice_3d or next(
            (lat for lat in result.lattices if len(lat.t_s3) > 1), LATTICE_3D
        )
        spec = artifact_spec(
            result.workload, result.gpu, result.hw, engine, lat2, lat3
        )
        key = spec_key(spec)
        manifest, arrays = result.artifact_payload()
        manifest.update(
            format_version=FORMAT_VERSION,
            kind="sweep",
            key=key,
            spec=spec,
            engine=engine,
            shapes={"cells": int(arrays["cell_time"].shape[0]),
                    "hw": int(arrays["cell_time"].shape[1])},
            extra=extra or {},
        )
        if routing_extra:
            manifest["routing"] = {**manifest.get("routing", {}), **routing_extra}
        def write_files(tmp: str) -> None:
            np.save(os.path.join(tmp, "cell_time.npy"), arrays["cell_time"])
            np.savez_compressed(
                os.path.join(tmp, "arrays.npz"),
                **{k: v for k, v in arrays.items() if k != "cell_time"},
            )
            with open(os.path.join(tmp, "manifest.json"), "w") as f:
                json.dump(manifest, f, indent=1)

        return self._staged_write(key, write_files)

    def put_json(
        self,
        kind: str,
        payload: dict,
        routing: Optional[dict] = None,
        extra: Optional[dict] = None,
    ) -> Artifact:
        """Persist a manifest-only JSON artifact (measurement run,
        calibration) content-addressed over its canonical payload.

        Same staging/locking discipline as :meth:`put`; the key is a
        sha256 over ``(format_version, kind, payload)``, so identical runs
        dedupe and any payload change gets a fresh key. ``routing`` is the
        attribute row a gateway indexes the artifact under (not hashed);
        ``extra`` is free-form annotation (not hashed either).
        """
        if kind not in KINDS or kind == "sweep":
            raise ValueError(
                f"put_json stores manifest-only kinds {[k for k in KINDS if k != 'sweep']}, got {kind!r}"
            )
        spec = {
            "format_version": FORMAT_VERSION,
            "kind": kind,
            "payload_digest": hashlib.sha256(
                _canonical_json(payload).encode()
            ).hexdigest(),
        }
        key = spec_key(spec)
        manifest = {
            "format_version": FORMAT_VERSION,
            "kind": kind,
            "key": key,
            "spec": spec,
            "routing": dict(routing or {}),
            "payload": payload,
            "extra": extra or {},
        }
        def write_files(tmp: str) -> None:
            with open(os.path.join(tmp, "manifest.json"), "w") as f:
                json.dump(manifest, f, indent=1)

        return self._staged_write(key, write_files)

    def upgrade_manifests(self) -> List[str]:
        """Backfill manifests written by older writers in place.

        Legacy sweep manifests (pre-gateway) lack the ``"routing"`` block
        and the ``"kind"`` tag; a gateway can still index them through
        :meth:`Artifact.routing`'s derivation fallback, but every scan
        re-derives and the rows stay partial (no hw_digest-independent
        attrs a future writer might add). This rewrites each such manifest
        with its derived routing block and ``kind: "sweep"``. The content
        key hashes the *spec*, never the manifest bytes, so upgraded
        artifacts keep their key (asserted) -- readers racing the rewrite
        see either the old or the new manifest, both valid for the same
        matrix. Returns the upgraded keys."""
        upgraded: List[str] = []
        for key in self.keys():
            path = os.path.join(self._path(key), "manifest.json")
            with open(path) as f:
                manifest = json.load(f)
            if "routing" in manifest and "kind" in manifest:
                continue
            with self.build_lock(key):
                art = Artifact(self._path(key))
                row = art.routing()  # derivation fallback fills the gaps
                manifest = art.manifest
                manifest["kind"] = art.kind
                manifest["routing"] = {
                    k: row[k]
                    for k in ("gpu", "workload", "stencils")
                    if k in row
                }
                assert manifest.get("key", key) == key, "manifest key drifted"
                fd, tmp = tempfile.mkstemp(
                    prefix=".manifest-", dir=self._path(key)
                )
                try:
                    with os.fdopen(fd, "w") as f:
                        json.dump(manifest, f, indent=1)
                    os.replace(tmp, path)
                except BaseException:
                    if os.path.exists(tmp):
                        os.unlink(tmp)
                    raise
            upgraded.append(key)
        return upgraded

    def delete(self, key: str) -> bool:
        """Remove one stored artifact (the GC apply path). Runs under the
        key's build lock so a concurrent builder either finishes before
        the removal or re-stages afterward -- never loses half its files.
        Returns True when an artifact directory was removed. Open mmap
        handles on the old files stay valid on POSIX (the inode lives
        until the last reader closes)."""
        with self.build_lock(key):
            path = self._path(key)
            if not os.path.exists(os.path.join(path, "manifest.json")):
                return False
            shutil.rmtree(path)
        return True

    def keys(self) -> List[str]:
        """Sorted content keys of every (complete) stored artifact."""
        return sorted(
            d for d in os.listdir(self.root)
            if os.path.exists(os.path.join(self.root, d, "manifest.json"))
            and not d.startswith(".")
        )

    def entries(self) -> List[Dict]:
        """One routing-attribute row per stored artifact (the CLI's ``ls``
        and the raw material of the gateway's index); manifest-only, so
        listing a large store never touches a matrix."""
        return [Artifact(self._path(k)).routing() for k in self.keys()]
