"""Portfolio artifacts + heterogeneity-aware routing (the serving half of
:mod:`repro_torch.core.portfolio`).

* :func:`build_portfolio` optimizes a fleet over a stored sweep artifact
  and persists the decision as a ``kind: "portfolio"`` manifest-only
  artifact: members (hw indices into the sweep), the one-hot traffic
  assignment matrix, per-cell-group routing tables, and the content key
  of the underlying sweep -- all canonical JSON, so the same
  optimization always produces the same bytes and content key.
* :class:`PortfolioServer` answers :class:`RouteRequest` s: "which
  design serves cell X?" resolves through the persisted assignment to a
  member design, and the answer's numbers (per-unit-traffic time,
  GFLOP/s) are recomputed from the *sweep artifact's matrix at serve
  time* -- live store reads, so member health is a real runtime
  property, not a build-time constant.
* Degraded routing: each member read runs under that member's circuit
  breaker (key ``{portfolio_key}:{hw_index}``) and a deterministic
  fault-injection point ``route.member.{hw_index}``. A failing/broken
  member falls back to the cell's next-preferred member with a
  structured ``degraded: true`` marker (the skipped members ride along
  in ``fallback_from``); only when EVERY member of a cell's preference
  list is down does the route fail -- structured 503
  ``portfolio_exhausted``, never a 500.

The manifests are the JAX package's: a numpy-engine portfolio built by
either package over the same sweep has the same manifest bytes and content
key, and each package routes the other's. The default engine is
``"torch"``: it scores the subsets on ``device`` (the card unless
``device="cpu"``; without a card it raises) and stamps ``"torch"`` in the
payload, so it keys apart from the numpy oracle's (``engine="numpy"``).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Mapping, Optional, Tuple, Union

import numpy as np

from repro_torch.core.portfolio import PortfolioResult, optimize_portfolio_arrays

from . import faults
from .errors import ERROR_HTTP_STATUS, GatewayError
from .resilience import CircuitOpenError, GatewayResilience, check_deadline
from .store import Artifact, ArtifactStore

__all__ = [
    "PortfolioServer",
    "RouteRequest",
    "RouteResponse",
    "UnknownCellError",
    "PortfolioExhaustedError",
    "build_portfolio",
]


class UnknownCellError(GatewayError):
    """The route request named a workload cell the portfolio's sweep does
    not carry (HTTP 404; the message lists the known labels)."""

    code = "unknown_cell"
    http_status = ERROR_HTTP_STATUS["unknown_cell"]


class PortfolioExhaustedError(GatewayError):
    """Every member design in the cell's preference order is failing (all
    breakers open / all reads raising). The fleet is degraded beyond
    this portfolio's redundancy -- retry later (HTTP 503)."""

    code = "portfolio_exhausted"
    http_status = ERROR_HTTP_STATUS["portfolio_exhausted"]

    retry_after_s: float = 1.0


@dataclass(frozen=True)
class RouteRequest:
    """``POST /v1/route`` body: which design serves this workload cell?

    ``cell`` is a cell-group label exactly as sweep artifacts expose
    them: a stencil name (``"heat2d"``) or ``"model:op"`` for LM sweeps
    (``"llama3_8b:decode"``).
    """

    cell: str


@dataclass(frozen=True)
class RouteResponse:
    """The routing decision for one cell, plus serve-time numbers read
    from the member's reduction row of the underlying sweep."""

    portfolio_key: str
    sweep_key: str
    cell: str
    cell_indices: Tuple[int, ...]  # sweep cell rows in this group
    hw_index: int  # the member design actually serving the cell
    member_slot: int  # its slot in the portfolio's member list
    point: Dict[str, float]  # design parameters of hw_index
    time_s: float  # per-unit-traffic weighted time on that design
    gflops: float
    degraded: bool  # True iff preferred member(s) were skipped
    fallback_from: Tuple[int, ...] = field(default_factory=tuple)


def _group_cells(sweep: Artifact) -> "Dict[str, List[int]]":
    """Cell-group label -> sweep cell rows, in stored cell order (the
    same labels :attr:`Artifact.cell_labels` reports)."""
    cells = sweep.manifest["workload"]["cells"]
    groups: Dict[str, List[int]] = {}
    for i, c in enumerate(cells):
        if sweep.family == "lm":
            label = f"{c['model']}:{c['op']}"
        else:
            label = c["stencil"]["name"]
        groups.setdefault(label, []).append(i)
    return groups


def build_portfolio(
    store: ArtifactStore,
    sweep: Union[Artifact, str],
    k: int,
    budget: float,
    freqs: Optional[np.ndarray] = None,
    *,
    objective: str = "density",
    engine: str = "torch",
    device=None,
) -> Tuple[Artifact, PortfolioResult]:
    """Optimize a K-design fleet over a stored sweep and persist it.

    Returns ``(portfolio_artifact, PortfolioResult)``. The payload is
    pure canonical JSON over the optimization *decision* (members,
    assignment, per-group routing) plus the sweep's content key; the
    matrix itself stays in the sweep artifact, which routing re-reads at
    serve time. Identical inputs dedupe to the same content key.
    ``device`` is where the default ``engine="torch"`` scores (the card
    unless ``device="cpu"``); ``engine="numpy"`` is the oracle.
    """
    if isinstance(sweep, str):
        art = store.get(sweep)
        if art is None:
            raise KeyError(f"no stored sweep artifact {sweep!r} in {store.root}")
        sweep = art
    if sweep.kind != "sweep":
        raise ValueError(
            f"portfolios are built over sweep artifacts, got kind {sweep.kind!r}"
        )
    f = sweep.cell_freqs() if freqs is None else np.asarray(freqs, np.float64)
    result = optimize_portfolio_arrays(
        sweep.hw_area,
        sweep.cell_time,
        sweep.cell_flops(),
        f,
        k,
        budget,
        objective=objective,
        engine=engine,
        device=device,
    )
    times = np.asarray(sweep.cell_time, np.float64)
    groups = []
    for label, cells in _group_cells(sweep).items():
        # the group's routed member: the member slot serving the largest
        # share of the group's traffic (freq-weighted vote over the
        # per-cell one-hot assignment; np.argmax ties -> lowest slot)
        shares = result.assignment[cells].T @ result.freqs[cells]
        slot = int(np.argmax(shares))
        # fallback order: member slots by the group's weighted time,
        # fastest first (stable sort -> lowest slot on exact ties)
        member_time = times[np.ix_(cells, list(result.members))].T @ result.freqs[cells]
        preference = [int(s) for s in np.argsort(member_time, kind="stable")]
        groups.append(
            {
                "label": label,
                "cells": [int(c) for c in cells],
                "slot": slot,
                "preference": preference,
            }
        )
    payload = {
        **result.payload(),
        "sweep_key": sweep.key,
        "groups": groups,
    }
    sweep_routing = sweep.routing()
    routing = {
        k_: sweep_routing[k_]
        for k_ in ("gpu", "workload", "family", "stencils", "models", "ops")
        if k_ in sweep_routing
    }
    routing.update(sweep_key=sweep.key, members=[int(m) for m in result.members])
    artifact = store.put_json("portfolio", payload, routing=routing)
    return artifact, result


class PortfolioServer:
    """In-process route oracle over one portfolio artifact.

    The gateway pools these exactly like :class:`CodesignServer` s; tests
    use them directly as the byte-identity reference. ``resilience``
    supplies the per-member circuit breakers (None disables breakers --
    faults then surface as immediate fallback, still never a 500).
    """

    def __init__(
        self,
        artifact: Artifact,
        sweep: Artifact,
        resilience: Optional[GatewayResilience] = None,
    ):
        if artifact.kind != "portfolio":
            raise ValueError(
                f"PortfolioServer wants a portfolio manifest, got {artifact.kind!r}"
            )
        p = artifact.payload
        if sweep.key != p["sweep_key"]:
            raise ValueError(
                f"sweep artifact {sweep.key!r} is not this portfolio's member "
                f"sweep {p['sweep_key']!r}"
            )
        self.artifact = artifact
        self.sweep = sweep
        self.key: str = artifact.key
        self.resilience = resilience
        self.members: List[int] = [int(m) for m in p["members"]]
        self.freqs = np.asarray(p["freqs"], np.float64)
        self._groups: Dict[str, Dict[str, Any]] = {
            g["label"]: g for g in p["groups"]
        }

    def cell_labels(self) -> List[str]:
        return list(self._groups)

    def _member_read(self, cells: List[int], hw: int) -> np.ndarray:
        """The member's reduction rows for a cell group, read from the
        sweep artifact's (mmap-backed) matrix -- the serve-time store
        access that breakers and fault injection guard."""
        faults.fire(f"route.member.{hw}")
        check_deadline("route.member")
        return np.asarray(self.sweep.cell_time[cells, hw], np.float64)

    def route(self, request: RouteRequest) -> RouteResponse:
        group = self._groups.get(request.cell)
        if group is None:
            known = ", ".join(sorted(self._groups))
            raise UnknownCellError(
                f"portfolio {self.key!r} serves no cell {request.cell!r} "
                f"(known cells: {known})"
            )
        cells: List[int] = list(group["cells"])
        f = self.freqs[cells]
        fsum = float(f.sum())
        weights = f / fsum if fsum > 0 else np.full(len(cells), 1.0 / len(cells))
        numer = float(weights @ np.asarray(self.sweep.cell_flops())[cells])
        # the assigned member first, then the group's fallback preference
        order = [int(group["slot"])] + [
            int(s) for s in group["preference"] if int(s) != int(group["slot"])
        ]
        fallback_from: List[int] = []
        res = self.resilience
        for slot in order:
            hw = self.members[slot]
            breaker = res.breaker(f"{self.key}:{hw}") if res is not None else None
            try:
                if breaker is not None:
                    with breaker.call():
                        rows = self._member_read(cells, hw)
                else:
                    rows = self._member_read(cells, hw)
            except CircuitOpenError:
                fallback_from.append(hw)
                continue
            except GatewayError:
                raise  # deadlines etc. classify for the whole request
            except Exception:  # noqa: BLE001 - a failing member is routed
                # around, not surfaced: degraded beats unavailable
                fallback_from.append(hw)
                continue
            time_s = float(weights @ rows)
            return RouteResponse(
                portfolio_key=self.key,
                sweep_key=self.sweep.key,
                cell=request.cell,
                cell_indices=tuple(cells),
                hw_index=int(hw),
                member_slot=int(slot),
                point=self.sweep.point(hw),
                time_s=time_s,
                gflops=float(numer / time_s / 1.0e9),
                degraded=bool(fallback_from),
                fallback_from=tuple(fallback_from),
            )
        raise PortfolioExhaustedError(
            f"every member design of portfolio {self.key!r} failed for cell "
            f"{request.cell!r} (tried hw indices {fallback_from})"
        )
