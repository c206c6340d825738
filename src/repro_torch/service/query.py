"""Codesign query engine: cheap re-reductions over a stored sweep artifact.

Everything here is "sensitivity for free" (paper §V.B): the expensive
eq.-18 matrix is already on disk, so a query -- an arbitrary stencil
frequency mix, a top-k under an area budget, a Pareto front, a what-if
subspace ("fix n_SM=16") -- is one vectorized pass over ``(C, H)`` data:

    weighted_time = f @ cell_time          # (C,) @ (C, H), per request
    gflops        = (f @ cell_flops) / weighted_time / 1e9

A small LRU memoizes recent reduction rows, so repeated mixes (dashboards,
retry storms) skip even the product. :meth:`QueryEngine.answer_many` is the
microbatch entry point the in-process server feeds: one pass answers every
request of a batch.

The JAX package's engine, with one change: a batch reduces each row with
the vector-matrix expression a lone request uses, where the JAX package
stacks the rows into one ``(B, C) @ (C, H)`` product. On some BLAS builds
the stacked product rounds differently in the last ulp, and the sweep
matrix has many identical columns (designs whose extra shared memory no
tile uses), so the stacked product could reorder exact ties and a batched
answer could name other designs than the same request answered alone.
The reduction stays numpy float64 on the host: a ``(96,) @ (96, 5121)``
product is about 1 MFLOP, and the card would add a host-device round trip
per query and break the contract that a warm answer is bit-identical to
``CodesignResult.weighted_time``.
"""

from __future__ import annotations

import dataclasses
import math
import threading
import time
from collections import OrderedDict
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.pareto import pareto_mask_batched
from repro_torch.obs.metrics import get_registry as _obs_registry
from repro_torch.obs.trace import span

from .store import Artifact

__all__ = ["QueryRequest", "QueryResponse", "QueryEngine"]

# ---- observability (repro_torch.obs; no-ops under REPRO_OBS_DISABLED=1) --
_REG = _obs_registry()
_M_LRU_HITS = _REG.counter(
    "repro_query_lru_hits_total",
    "reduction rows served from the QueryEngine LRU (matmul skipped)",
)
_M_LRU_MISSES = _REG.counter(
    "repro_query_lru_misses_total",
    "reduction rows that had to ride the (B', C) @ (C, H) matmul",
)
_M_REDUCE_SECONDS = _REG.histogram(
    "repro_query_reduce_seconds",
    "wall time of one stacked reduction matmul over the optima matrix",
)


@dataclasses.dataclass(frozen=True)
class QueryRequest:
    """One codesign question against a stored artifact.

    ``freqs`` weights whole cell groups (unnormalized; redistributed over
    each group's stored cells proportionally to the artifact's cell
    frequencies). Group names are stencil names for stencil artifacts; LM
    artifacts accept a model name, an op name, or an exact ``model:op``
    label. ``cell_freqs`` overrides with an explicit per-cell vector.
    Leaving both None asks about the artifact's own workload mix.
    ``fix`` is the what-if subspace: only hardware points whose named
    design parameters equal the given values compete (e.g.
    ``{"n_sm": 16}``); the response also carries the unrestricted
    baseline's best so the delta is one subtraction away.

    Every field here is a wire field of the JAX package's gateway
    (``docs/serving.md`` documents each one).
    """

    freqs: Optional[Mapping[str, float]] = None
    cell_freqs: Optional[Sequence[float]] = None
    max_area: float = math.inf
    min_area: float = 0.0
    top_k: int = 1
    pareto: bool = False
    fix: Optional[Mapping[str, float]] = None
    use_cache: bool = True


@dataclasses.dataclass
class QueryResponse:
    """``best_index == -1`` (empty ``best_point``/``top_k``,
    ``best_gflops == -inf``) means NO design satisfies the request's
    budget/fix constraints -- never an arbitrary fallback design.

    Field reference: ``docs/serving.md``."""

    artifact_key: str
    best_index: int
    best_gflops: float
    best_weighted_time: float
    best_point: Dict[str, float]
    top_k: List[Dict[str, float]]
    pareto_indices: Optional[np.ndarray] = None
    baseline_best_index: Optional[int] = None  # set iff the query had a what-if
    baseline_best_gflops: Optional[float] = None
    cached: bool = False  # reduction row came from the LRU
    batch_size: int = 1  # how many requests shared this reduction matmul


class _LRU:
    """Tiny thread-safe LRU of reduction rows, with stats."""

    def __init__(self, maxsize: int):
        self.maxsize = maxsize
        self._d: OrderedDict[bytes, Tuple[np.ndarray, np.ndarray]] = OrderedDict()
        self._mu = threading.Lock()
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def get(self, key: bytes):
        with self._mu:
            row = self._d.get(key)
            if row is None:
                self.misses += 1
                return None
            self._d.move_to_end(key)
            self.hits += 1
            return row

    def put(self, key: bytes, value) -> None:
        if self.maxsize <= 0:
            return
        with self._mu:
            self._d[key] = value
            self._d.move_to_end(key)
            while len(self._d) > self.maxsize:
                self._d.popitem(last=False)
                self.evictions += 1

    def __len__(self) -> int:
        with self._mu:
            return len(self._d)


def _fix_signature(fix: Optional[Mapping[str, float]]) -> Tuple:
    if not fix:
        return ()
    return tuple(sorted((str(k), float(v)) for k, v in fix.items()))


class QueryEngine:
    """Vectorized re-reductions over one artifact, with an LRU of recent
    reduction rows."""

    def __init__(self, artifact: Artifact, lru_size: int = 256):
        self.artifact = artifact
        self._flops = artifact.cell_flops()
        self._default_freqs = artifact.cell_freqs()
        # per-group cell index lists, in artifact cell order. Stencil
        # artifacts group by stencil name; LM artifacts register three
        # overlapping aliases per cell -- model ("llama3-8b"), op
        # ("decode"), and the exact "model:op" label -- so mixes can be
        # stated at whichever granularity the caller thinks in.
        self._group_cells: Dict[str, List[int]] = {}
        for i, c in enumerate(artifact.manifest["workload"]["cells"]):
            if artifact.family == "lm":
                for alias in (c["model"], c["op"], f"{c['model']}:{c['op']}"):
                    self._group_cells.setdefault(alias, []).append(i)
            else:
                self._group_cells.setdefault(c["stencil"]["name"], []).append(i)
        self.lru = _LRU(lru_size)

    # ---- frequency resolution --------------------------------------------
    def freq_vector(self, req: QueryRequest) -> np.ndarray:
        """(C,) normalized cell frequencies for a request."""
        c = self.artifact.n_cells
        if req.cell_freqs is not None:
            f = np.asarray(req.cell_freqs, np.float64)
            if f.shape != (c,):
                raise ValueError(f"cell_freqs must have shape ({c},); got {f.shape}")
        elif req.freqs is not None:
            f = np.zeros(c, np.float64)
            for name, w in req.freqs.items():
                cells = self._group_cells.get(name)
                if cells is None:
                    raise KeyError(
                        f"cell group {name!r} not in artifact "
                        f"(has {sorted(self._group_cells)})"
                    )
                base = self._default_freqs[cells]
                f[cells] = float(w) * base / base.sum()
        else:
            f = self._default_freqs.copy()
        total = f.sum()
        if not (np.isfinite(total) and total > 0):
            raise ValueError("frequency mix must have a positive finite sum")
        return f / total

    # ---- reductions -------------------------------------------------------
    def _feasible_mask(self, fix_sig: Tuple) -> Optional[np.ndarray]:
        if not fix_sig:
            return None
        mask = np.ones(self.artifact.n_hw, dtype=bool)
        for name, value in fix_sig:
            mask &= self.artifact.hw_column(name) == value
        return mask

    def _reduce_rows(
        self, fmat: np.ndarray, use_cache: Sequence[bool]
    ) -> Tuple[np.ndarray, np.ndarray, List[bool]]:
        """(B, C) frequency rows -> (wt (B, H), gflops (B, H), lru_hit flags).

        Rows found in the LRU skip the product; each of the rest uses the
        exact vector-matrix expression of ``CodesignResult.weighted_time``,
        so a warm answer is bit-identical to a fresh in-process reduction
        and a batched answer to the same request answered alone.
        """
        b, _ = fmat.shape
        h = self.artifact.n_hw
        wt = np.empty((b, h))
        gf = np.empty((b, h))
        hit = [False] * b
        todo: List[int] = []
        keys: List[Optional[bytes]] = [None] * b
        for i in range(b):
            if use_cache[i]:
                keys[i] = fmat[i].tobytes()
                row = self.lru.get(keys[i])
                if row is not None:
                    wt[i], gf[i] = row
                    hit[i] = True
                    continue
            todo.append(i)
        _M_LRU_HITS.inc(b - len(todo))
        _M_LRU_MISSES.inc(len(todo))
        if todo:
            t0 = time.perf_counter()
            with span("reduce.matmul", rows=len(todo)):
                sub = fmat[todo]
                ct = self.artifact.cell_time
                # row by row, never one stacked (B', C) @ (C, H) product:
                # every row rounds exactly as a lone request's row does
                wt_new = np.stack([sub[j] @ ct for j in range(len(todo))])
                num = np.concatenate([sub[j:j + 1] @ self._flops for j in range(len(todo))])
                gf_new = num[:, None] / wt_new / 1.0e9
            _M_REDUCE_SECONDS.observe(time.perf_counter() - t0)
            for j, i in enumerate(todo):
                wt[i], gf[i] = wt_new[j], gf_new[j]
                if keys[i] is not None:
                    # copy: a row VIEW would pin the whole (B', H) batch
                    # product alive for as long as the entry stays cached
                    self.lru.put(keys[i], (wt_new[j].copy(), gf_new[j].copy()))
        return wt, gf, hit

    # ---- request finalization --------------------------------------------
    def _finalize(
        self,
        req: QueryRequest,
        wt_row: np.ndarray,
        gf_row: np.ndarray,
        cached: bool,
        batch_size: int,
    ) -> QueryResponse:
        art = self.artifact
        area = art.hw_area
        in_budget = (area <= req.max_area) & (area >= req.min_area)
        mask = self._feasible_mask(_fix_signature(req.fix))
        sel = in_budget if mask is None else (in_budget & mask)
        # a one-hot mix times an infeasible unused cell yields 0*inf = nan in
        # the (seed-exact) matmul; such designs are infeasible for the asked
        # mix, never winners
        g = np.where(sel & np.isfinite(gf_row), gf_row, -np.inf)
        best = int(np.argmax(g))
        feasible = bool(np.isfinite(g[best]))
        if not feasible:
            best = -1
        k = max(1, int(req.top_k))
        if k >= g.shape[0]:
            order = np.argsort(-g, kind="stable")
        else:
            part = np.argpartition(-g, k)[:k]
            order = part[np.argsort(-g[part], kind="stable")]
        top = [
            {**art.point(int(i)), "index": int(i), "gflops": float(g[i]),
             "weighted_time": float(wt_row[i])}
            for i in order[:k]
            if np.isfinite(g[i])
        ]
        resp = QueryResponse(
            artifact_key=art.key,
            best_index=best,
            best_gflops=float(g[best]) if feasible else -np.inf,
            best_weighted_time=float(wt_row[best]) if feasible else np.inf,
            best_point=art.point(best) if feasible else {},
            top_k=top,
            cached=cached,
            batch_size=batch_size,
        )
        if req.pareto:
            perf = np.where(sel, gf_row, -np.inf)  # -inf -> excluded (non-finite)
            resp.pareto_indices = np.nonzero(pareto_mask_batched(area, perf)[0])[0]
        if mask is not None:
            # what-if delta: unrestricted baseline under the same mix/budget
            # (left None when even the unrestricted budget is infeasible)
            g0 = np.where(in_budget & np.isfinite(gf_row), gf_row, -np.inf)
            b0 = int(np.argmax(g0))
            if np.isfinite(g0[b0]):
                resp.baseline_best_index = b0
                resp.baseline_best_gflops = float(g0[b0])
        return resp

    def query(self, req: QueryRequest) -> QueryResponse:
        return self.answer_many([req])[0]

    def answer_many(self, reqs: Sequence[QueryRequest]) -> List[QueryResponse]:
        """Answer a microbatch: one reduction pass over all LRU-missing
        frequency rows, then per-request finalization."""
        fmat = np.stack([self.freq_vector(r) for r in reqs])
        wt, gf, hit = self._reduce_rows(fmat, [r.use_cache for r in reqs])
        return [
            self._finalize(r, wt[i], gf[i], hit[i], len(reqs))
            for i, r in enumerate(reqs)
        ]
