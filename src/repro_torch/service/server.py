"""Thread-safe in-process codesign query servers.

Decouples the expensive eq.-18 sweep (producer) from cheap workload
queries (consumers):

* **warm path**: the configured sweep's artifact is on disk -- queries are
  answered by :class:`repro_torch.service.query.QueryEngine`
  re-reductions and NEVER invoke a sweep engine;
* **miss path**: first touch runs the family's sweep once (under a build
  lock, so a thundering herd compiles/solves exactly once) and writes the
  artifact through the store for every later process;
* **microbatching**: concurrent ``query()`` callers rendezvous for a short
  window; the leader answers every pending request in one reduction pass
  (row by row, so each answer is the one the request gets alone; see
  :mod:`repro_torch.service.query`) and distributes the answers.

One server serves one configured sweep. :class:`CodesignServer` serves
the stencil family on the serving machinery of :class:`_BaseServer`; its
miss path sweeps on the card unless ``device="cpu"`` is passed.
:func:`server_from_artifact` wraps a discovered artifact as a warm server
(the miss path is unreachable); it serves artifacts either package built.
LM-family serving (:class:`LMServer`) is not ported yet and raises.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional, Sequence

import numpy as np

from repro_torch.core.area import MAXWELL, LinearAreaModel
from repro_torch.core.codesign import (
    CodesignResult,
    HardwareSpace,
    codesign,
    enumerate_hw_space,
)
from repro_torch.core.solver import LATTICE_2D, LATTICE_3D, TileLattice
from repro_torch.core.timemodel import MAXWELL_GPU, GPUSpec
from repro_torch.core.workload import Workload, paper_workload
from repro_torch.obs import get_logger
from repro_torch.obs.metrics import SIZE_BUCKETS
from repro_torch.obs.metrics import get_registry as _obs_registry
from repro_torch.obs.trace import span

from . import faults
from .query import QueryEngine, QueryRequest, QueryResponse
from .resilience import check_deadline, remaining_s
from .store import _LM_TODO, Artifact, ArtifactStore

__all__ = ["CodesignServer", "LMServer", "server_from_artifact"]

# ---- observability (repro_torch.obs; no-ops under REPRO_OBS_DISABLED=1) --
_LOG = get_logger("repro_torch.server")
_REG = _obs_registry()
_M_BATCH_SIZE = _REG.histogram(
    "repro_server_batch_size",
    "microbatch flush sizes (requests per leader-stacked matmul)",
    buckets=SIZE_BUCKETS,
)
_M_FOLLOWER_WAIT = _REG.histogram(
    "repro_server_follower_wait_seconds",
    "wall time a follower spends parked on its rendezvous slot "
    "(leader's own window/answer time excluded)",
)
_M_ART_BUILDS = _REG.counter(
    "repro_server_artifact_builds_total",
    "miss-path sweeps run by a server (cold artifact built + persisted)",
)
_M_ART_LOADS = _REG.counter(
    "repro_server_artifact_loads_total",
    "warm artifact loads (stored sweep opened, no engine invoked)",
)
_M_BATCH_POISON = _REG.counter(
    "repro_server_batch_poison_total",
    "microbatch flushes that failed whole and fell back to per-request "
    "solo retries (one poison-pill request degrading its batchmates "
    "from one stacked matmul to N solo answers)",
)


class _Slot:
    __slots__ = ("request", "event", "response", "error")

    def __init__(self, request: QueryRequest):
        self.request = request
        self.event = threading.Event()
        self.response: Optional[QueryResponse] = None
        self.error: Optional[BaseException] = None


class _BaseServer:
    """Family-agnostic serving machinery: artifact lifecycle (get-or-build
    under the cross-process lock) and leader/follower query microbatching.

    Subclasses set ``self.key`` (the content address, known BEFORE any
    sweep -- that is what makes the warm path engine-free) in their
    ``__init__`` after calling :meth:`_init_serving`, and implement
    :meth:`_solve` (run the family's sweep, persist it, return the
    artifact)."""

    def _init_serving(
        self, store: ArtifactStore, batch_window: float, lru_size: int
    ) -> None:
        self.store = store
        self.batch_window = float(batch_window)
        self.lru_size = lru_size
        self._engine: Optional[QueryEngine] = None
        self._build_mu = threading.Lock()
        self._batch_mu = threading.Lock()
        self._pending: List[_Slot] = []
        self._leader_active = False
        self.stats: Dict[str, int] = {
            "queries": 0,
            "batches": 0,
            "max_batch": 0,
            "artifact_builds": 0,
            "artifact_loads": 0,
        }

    def _solve(self) -> Artifact:
        raise NotImplementedError

    # ---- artifact lifecycle ----------------------------------------------
    def ensure_artifact(self) -> QueryEngine:
        """Get-or-build the configured sweep's artifact (thread-safe)."""
        eng = self._engine
        if eng is not None:
            return eng
        with self._build_mu:
            if self._engine is None:
                art = self.store.get(self.key)
                if art is None:
                    # cross-process dedup: a second process racing to the
                    # same key blocks here (bounded by the lock timeout
                    # and any in-flight request deadline), then finds the
                    # winner's artifact on the re-check instead of
                    # re-sweeping (build_lock is reentrant, so store.put
                    # inside _solve can re-acquire it around the staged
                    # write).
                    with self.store.build_lock(self.key):
                        art = self.store.get(self.key)
                        if art is None:
                            # a request whose budget is already spent must
                            # not kick off a minutes-long sweep
                            check_deadline("server.build")
                            with span("artifact.build", key=self.key[:12]):
                                art = self._solve()
                            assert art.key == self.key, (
                                "store key drifted from server key"
                            )
                            self.stats["artifact_builds"] += 1
                            _M_ART_BUILDS.inc()
                        else:
                            self.stats["artifact_loads"] += 1
                            _M_ART_LOADS.inc()
                else:
                    self.stats["artifact_loads"] += 1
                    _M_ART_LOADS.inc()
                self._engine = QueryEngine(art, lru_size=self.lru_size)
            return self._engine

    @property
    def warm(self) -> bool:
        """True when queries can be served without any sweep engine."""
        return self._engine is not None or self.store.has(self.key)

    # ---- queries ----------------------------------------------------------
    def query(self, request: QueryRequest) -> QueryResponse:
        """Answer one request; concurrent callers microbatch automatically."""
        check_deadline("server.query")
        engine = self.ensure_artifact()
        if self.batch_window <= 0:
            with self._batch_mu:
                self.stats["queries"] += 1
                self.stats["batches"] += 1
                self.stats["max_batch"] = max(self.stats["max_batch"], 1)
            _M_BATCH_SIZE.observe(1)
            with span("server.answer", key=self.key[:12], batched=0):
                return engine.query(request)
        slot = _Slot(request)
        with self._batch_mu:
            self._pending.append(slot)
            am_leader = not self._leader_active
            if am_leader:
                self._leader_active = True
        if am_leader:
            try:
                # rendezvous: followers pile in. A leader carrying a
                # deadline never sleeps past its own remaining budget.
                time.sleep(
                    min(self.batch_window,
                        remaining_s(default=self.batch_window))
                )
            finally:
                # even if the sleep is interrupted (KeyboardInterrupt), the
                # leadership MUST be handed back and every collected
                # follower answered or failed -- never left waiting forever
                with self._batch_mu:
                    batch, self._pending = self._pending, []
                    self._leader_active = False
                    self.stats["queries"] += len(batch)
                    self.stats["batches"] += 1
                    self.stats["max_batch"] = max(self.stats["max_batch"], len(batch))
                _M_BATCH_SIZE.observe(len(batch))
                try:
                    # NB: follower requests are answered HERE, on the
                    # leader's thread -- span trees of traced followers
                    # show their rendezvous wait, not this reduction
                    faults.fire("server.batch")
                    with span("batch.answer", size=len(batch), key=self.key[:12]):
                        responses = engine.answer_many([s.request for s in batch])
                    for s, r in zip(batch, responses):
                        s.response = r
                except BaseException as flush_err:  # noqa: BLE001 -- isolate
                    # the poison pill: retry each request solo so one bad
                    # request can't take down its batchmates. Counted and
                    # logged (this path used to be silent -- a fleet
                    # quietly degrading from one batched pass to N solo
                    # answers looked identical to a healthy one).
                    _M_BATCH_POISON.inc()
                    _LOG.warning(
                        "batch_poisoned", size=len(batch),
                        error=f"{type(flush_err).__name__}: {flush_err}",
                    )
                    for idx, s in enumerate(batch):
                        try:
                            s.response = engine.query(s.request)
                        except BaseException as e:  # noqa: BLE001
                            s.error = e
                            _LOG.warning(
                                "batch_poison_request", request_id=idx,
                                request=repr(s.request)[:200],
                                error=f"{type(e).__name__}: {e}",
                            )
                finally:
                    for s in batch:
                        s.event.set()
        if am_leader:
            slot.event.wait()  # already set by the flush above
        else:
            t0 = time.perf_counter()
            with span("batch.wait"):
                slot.event.wait()
            _M_FOLLOWER_WAIT.observe(time.perf_counter() - t0)
        if slot.error is not None:
            raise slot.error
        assert slot.response is not None
        return slot.response

    def query_many(self, requests: Sequence[QueryRequest]) -> List[QueryResponse]:
        """Batch entry point for a caller that already has its requests in
        hand (no rendezvous window needed)."""
        check_deadline("server.query")
        engine = self.ensure_artifact()
        faults.fire("server.batch")
        with self._batch_mu:
            self.stats["queries"] += len(requests)
            self.stats["batches"] += 1
            self.stats["max_batch"] = max(self.stats["max_batch"], len(requests))
        _M_BATCH_SIZE.observe(len(requests))
        with span("server.answer_many", size=len(requests), key=self.key[:12]):
            return engine.answer_many(list(requests))


class CodesignServer(_BaseServer):
    """Serve codesign queries for one configured stencil sweep.

    ``batch_window`` is the rendezvous time (seconds) the microbatch leader
    waits for followers; 0 disables batching (every query answers solo,
    still thread-safe). The default workload is the paper's Fig.-3
    six-stencil uniform mix; ``downsample`` thins the hardware space for
    demos/CI. ``engine`` picks the miss path's sweep engine (``"torch"``,
    ``"numpy"`` or ``"auto"``, as :func:`repro_torch.core.codesign
    .codesign`) and is part of the content key; ``device`` is where the
    torch engine sweeps: the card unless ``device="cpu"``. ``"jax"`` and
    ``"sharded"`` name the JAX package's matrices: a server so configured
    serves such an artifact warm, and its miss path raises.
    """

    def __init__(
        self,
        store: ArtifactStore,
        workload: Optional[Workload] = None,
        gpu: GPUSpec = MAXWELL_GPU,
        area_model: LinearAreaModel = MAXWELL,
        max_area: float = 650.0,
        hw: Optional[HardwareSpace] = None,
        downsample: int = 1,
        engine: str = "auto",
        chunk: Optional[int] = None,
        device=None,
        lattice_2d: TileLattice = LATTICE_2D,
        lattice_3d: TileLattice = LATTICE_3D,
        batch_window: float = 0.002,
        lru_size: int = 256,
    ):
        self._init_serving(store, batch_window, lru_size)
        self.workload = workload or paper_workload()
        self.gpu = gpu
        self.chunk = chunk
        self.device = device
        self.lattice_2d = lattice_2d
        self.lattice_3d = lattice_3d
        if hw is None:
            hw = enumerate_hw_space(area_model, max_area=max_area)
            if downsample > 1:
                hw = hw.downsample(downsample)
        self.hw = hw
        self.engine = engine
        self.key = store.key_for(
            self.workload, gpu, self.hw, engine, lattice_2d, lattice_3d
        )

    def _solve(self) -> Artifact:
        result = codesign(
            self.workload,
            gpu=self.gpu,
            hw=self.hw,
            lattice_2d=self.lattice_2d,
            lattice_3d=self.lattice_3d,
            chunk=self.chunk,
            engine=self.engine,
            device=self.device,
        )
        return self.store.put(
            result,
            engine=self.engine,
            lattice_2d=self.lattice_2d,
            lattice_3d=self.lattice_3d,
        )

    @classmethod
    def from_artifact(
        cls,
        store: ArtifactStore,
        artifact: Artifact,
        batch_window: float = 0.002,
        lru_size: int = 256,
    ) -> "CodesignServer":
        """Wrap an already-stored artifact as a warm server (never sweeps).

        A discovered artifact's manifest is parsed back into the
        server's configuration (workload, GPU,
        hardware space, lattices, resolved engine family), the content
        address is recomputed and checked against the artifact's own key --
        a mismatch means the manifest does not describe the matrix and the
        artifact must not be served -- and the query engine is pre-seeded,
        so the miss path is unreachable. Only the small npz hardware
        columns are materialized here; the ``(C, H)`` matrix stays an
        untouched mmap until the first query needs a row.
        """
        m = artifact.manifest
        workload, gpu, lattices = CodesignResult.parse_manifest(m)
        # the spec records the exact (2d, 3d) lattice pair the key was
        # digested over -- including a lattice for a dimensionality the
        # workload never used, which the per-cell tables cannot recover
        spec_lat = m.get("spec", {}).get("lattices")
        if spec_lat:
            lat2, lat3 = (
                TileLattice(**{k: tuple(int(x) for x in v) for k, v in spec_lat[d].items()})
                for d in ("2d", "3d")
            )
        else:  # pre-spec manifests: per-cell tables + defaults
            lat2 = next((lat for lat in lattices if len(lat.t_s3) == 1), LATTICE_2D)
            lat3 = next((lat for lat in lattices if len(lat.t_s3) > 1), LATTICE_3D)
        hw = HardwareSpace(
            n_sm=np.asarray(artifact.hw_n_sm, np.float64),
            n_v=np.asarray(artifact.hw_n_v, np.float64),
            m_sm=np.asarray(artifact.hw_m_sm, np.float64),
            area=np.asarray(artifact.hw_area, np.float64),
        )
        # the spec's engine is already the resolved matrix *family*
        # ("torch"/"numpy"/"jax"), so the recomputed key cannot drift with
        # the loading host.
        engine = m.get("spec", {}).get("engine") or m.get("engine", "auto")
        srv = cls(
            store,
            workload=workload,
            gpu=gpu,
            hw=hw,
            engine=engine,
            lattice_2d=lat2,
            lattice_3d=lat3,
            batch_window=batch_window,
            lru_size=lru_size,
        )
        if srv.key != artifact.key:
            raise ValueError(
                f"artifact {artifact.key} does not reproduce its own content "
                f"address (got {srv.key}); refusing to serve it"
            )
        srv._engine = QueryEngine(artifact, lru_size=lru_size)
        srv.stats["artifact_loads"] += 1
        _M_ART_LOADS.inc()
        return srv


class LMServer(_BaseServer):
    """LM-family serving: not ported yet (it needs LM-workload codesign)."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(_LM_TODO)

    @classmethod
    def from_artifact(cls, *args, **kwargs) -> "LMServer":
        raise NotImplementedError(_LM_TODO)


def server_from_artifact(
    store: ArtifactStore,
    artifact: Artifact,
    batch_window: float = 0.002,
    lru_size: int = 256,
):
    """Warm server for a discovered sweep artifact, dispatched on its
    manifest's cell family (LM artifacts raise until that family is
    ported)."""
    if artifact.family == "lm":
        return LMServer.from_artifact(store, artifact, batch_window, lru_size)
    return CodesignServer.from_artifact(store, artifact, batch_window, lru_size)
