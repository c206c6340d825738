"""Pareto-front extraction over (cost, performance) design points (Fig. 3).

A design is Pareto-optimal iff no other design has both lower-or-equal cost
(area) and strictly higher performance. The paper observes only ~1% of the
thousands of feasible designs are Pareto-optimal -- "a nearly 100-fold
savings in design cost".

Tie contract: when several points tie on *every* axis (exact duplicates),
the survivor is the one with the LOWEST original index, and the mask is
invariant under permutation/duplication of the input (the surviving point
set is the same set of (cost, perf) values). Downstream consumers --
portfolio subset enumeration in particular -- rely on this: an unstable
tie-break would make candidate sets, and therefore chosen fleets, depend
on iteration order. Every sort below is explicitly stable to keep the
contract independent of numpy's default (introsort) tie behavior.
"""

from __future__ import annotations

import numpy as np

__all__ = ["pareto_mask", "pareto_mask_batched", "pareto_front"]


def pareto_mask(cost: np.ndarray, perf: np.ndarray) -> np.ndarray:
    """Boolean mask of Pareto-optimal points (minimize cost, maximize perf).

    O(n log n): sweep by ascending cost, keep the running best performance.
    Ties on cost keep only the best-performing point; full duplicates keep
    the lowest-index copy (``np.lexsort`` is stable, so equal keys preserve
    original order and the scan admits only the first).
    """
    cost = np.asarray(cost, np.float64).ravel()
    perf = np.asarray(perf, np.float64).ravel()
    if cost.shape != perf.shape:
        raise ValueError("cost/perf shape mismatch")
    n = cost.shape[0]
    mask = np.zeros(n, dtype=bool)
    finite = np.isfinite(cost) & np.isfinite(perf)
    idx = np.nonzero(finite)[0]
    if idx.size == 0:
        return mask
    # sort by (cost asc, perf desc) so equal-cost groups see their best first
    order = idx[np.lexsort((-perf[idx], cost[idx]))]
    best = -np.inf
    for i in order:
        if perf[i] > best:
            mask[i] = True
            best = perf[i]
    return mask


def pareto_mask_batched(cost: np.ndarray, perf: np.ndarray) -> np.ndarray:
    """Row-wise :func:`pareto_mask` for B perf vectors sharing one cost axis.

    ``cost`` is ``(H,)``, ``perf`` is ``(B, H)``; returns a ``(B, H)`` bool
    mask identical row-by-row to ``pareto_mask(cost, perf[b])``. The shared
    cost axis is the codesign-service case (one hardware space, many
    frequency mixes), and it is what makes the batch vectorizable: cost is
    sorted once and the per-row scan collapses to a running-max over
    equal-cost segments (``maximum.reduceat`` + ``maximum.accumulate``),
    with no Python loop over B or H.
    """
    cost = np.asarray(cost, np.float64).ravel()
    perf = np.atleast_2d(np.asarray(perf, np.float64))
    if perf.shape[1] != cost.shape[0]:
        raise ValueError("cost/perf shape mismatch")
    b, n = perf.shape
    mask = np.zeros((b, n), dtype=bool)
    usable_cost = np.isfinite(cost)
    idx = np.nonzero(usable_cost)[0]
    if idx.size == 0:
        return mask
    order = idx[np.argsort(cost[idx], kind="stable")]  # cost asc, stable
    cs = cost[order]
    ps = perf[:, order]  # (B, K)
    ps = np.where(np.isfinite(ps), ps, -np.inf)  # per-row non-finite perf
    # equal-cost segments: within a segment only the best perf can win
    seg_start = np.nonzero(np.r_[True, cs[1:] != cs[:-1]])[0]
    seg_id = np.cumsum(np.r_[False, cs[1:] != cs[:-1]])
    seg_max = np.maximum.reduceat(ps, seg_start, axis=1)  # (B, S)
    # running best over *previous* segments (exclusive cumulative max)
    run = np.maximum.accumulate(seg_max, axis=1)
    prev = np.concatenate(
        [np.full((b, 1), -np.inf), run[:, :-1]], axis=1
    )  # (B, S)
    seg_wins = seg_max > prev[:, : seg_max.shape[1]]
    # the winner inside a segment is the FIRST position achieving seg_max
    # (stable cost sort keeps original index order, matching pareto_mask's
    # lexsort tie-breaking); np.maximum.reduceat has no arg variant, so
    # find it with a segment-local == scan.
    is_max = ps == seg_max[:, seg_id]
    first_hit = np.zeros_like(is_max)
    # positions where is_max first becomes True within each segment:
    csum = np.cumsum(is_max, axis=1)
    seg_base = np.concatenate(
        [np.zeros((b, 1), csum.dtype), csum[:, seg_start[1:] - 1]], axis=1
    )  # cumulative hits before each segment
    first_hit = is_max & (csum - seg_base[:, seg_id] == 1)
    winners = first_hit & seg_wins[:, seg_id] & np.isfinite(ps)
    rows, cols = np.nonzero(winners)
    mask[rows, order[cols]] = True
    return mask


def pareto_front(cost: np.ndarray, perf: np.ndarray):
    """(sorted_cost, sorted_perf, indices) of the Pareto-optimal points.

    Survivor costs are strictly increasing (equal-cost groups keep one
    point), but the sort is stable anyway so the lowest-index tie contract
    cannot silently regress if that invariant ever loosens.
    """
    mask = pareto_mask(cost, perf)
    idx = np.nonzero(mask)[0]
    order = np.argsort(np.asarray(cost)[idx], kind="stable")
    idx = idx[order]
    return np.asarray(cost)[idx], np.asarray(perf)[idx], idx
