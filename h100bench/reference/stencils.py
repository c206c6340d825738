"""Plain reference of the paper's stencils and of its eq.-18 time model.

* :func:`run`: T Dirichlet steps of a stencil in float32 over the whole
  array (border cells keep their values), each step as whole-array torch
  operations in the order of the stencil's formula, into a second buffer.
* :func:`stencil_time` and :func:`best_time`: eqs. 9-15 of the paper
  (arXiv:1712.04892) in float64, at one hardware point over the
  whole tile lattice, from the constants of the configuration file (torch
  on the CPU).

It imports nothing of the system under test. :func:`best_time` with
``dtype=torch.bfloat16`` is the tile choice's control; the benchmark's
runs do not call it.
"""

from __future__ import annotations

import itertools
from typing import Dict, Tuple

import torch


def _step2d(name: str, x: torch.Tensor, y: torch.Tensor) -> None:
    """One step of ``x`` into the interior of ``y`` (whose border is ``x``'s)."""
    c, n, s = x[1:-1, 1:-1], x[:-2, 1:-1], x[2:, 1:-1]
    w, e = x[1:-1, :-2], x[1:-1, 2:]
    out = y[1:-1, 1:-1]
    if name == "jacobi2d":
        t = c + n
        t += s
        t += e
        t += w
        torch.mul(t, 0.2, out=out)
    elif name in ("heat2d", "laplacian2d"):
        t = n + s
        t += e
        t += w
        t -= 4.0 * c
        if name == "heat2d":
            t *= 0.125
            torch.add(c, t, out=out)
        else:
            out.copy_(t)
    elif name == "gradient2d":
        gx = e - w
        gx *= 0.5
        gy = s - n
        gy *= 0.5
        gx *= gx
        gy *= gy
        gx += gy
        torch.sqrt(gx, out=out)
    else:
        raise KeyError(name)


def _step3d(name: str, x: torch.Tensor, y: torch.Tensor) -> None:
    c = x[1:-1, 1:-1, 1:-1]
    t = x[:-2, 1:-1, 1:-1] + x[2:, 1:-1, 1:-1]
    t += x[1:-1, :-2, 1:-1]
    t += x[1:-1, 2:, 1:-1]
    t += x[1:-1, 1:-1, 2:]
    t += x[1:-1, 1:-1, :-2]
    t -= 6.0 * c
    out = y[1:-1, 1:-1, 1:-1]
    if name == "heat3d":
        t *= 0.125
        torch.add(c, t, out=out)
    elif name == "laplacian3d":
        out.copy_(t)
    else:
        raise KeyError(name)


def run(name: str, x: torch.Tensor, steps: int) -> torch.Tensor:
    """``steps`` steps of stencil ``name`` from ``x``, in float32."""
    a = x.to(torch.float32, copy=True)
    b = a.clone()
    step = _step3d if a.dim() == 3 else _step2d
    for _ in range(steps):
        step(name, a, b)
        a, b = b, a
    return a


def grid_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """The largest |got - want| over the cells where ``want`` is finite,
    relative to the largest finite |want|; infinite where the two differ
    in which cells are infinite or NaN (a diverging stencil overflows)."""
    got, want = got.float(), want.float()
    fin = torch.isfinite(want)
    if not torch.equal(fin, torch.isfinite(got)):
        return float("inf")
    odd = ~fin & ~((got == want) | (torch.isnan(got) & torch.isnan(want)))
    if bool(odd.any()):
        return float("inf")
    if not bool(fin.any()):
        return 0.0
    scale = float(want[fin].abs().max())
    return float((got[fin] - want[fin]).abs().max()) / max(scale, 1e-30)


def lattice(spec: Dict) -> Dict[str, torch.Tensor]:
    """The tile lattice of a configuration's ``lattice_2d``/``lattice_3d``
    entry, flattened in the order t_s1, t_s2, t_t, k, t_s3 (float64)."""
    names = ("t_s1", "t_s2", "t_t", "k", "t_s3")
    combos = torch.tensor(list(itertools.product(*(spec.get(n, [1]) for n in names))),
                          dtype=torch.float64)
    return {n: combos[:, i] for i, n in enumerate(names)}


def stencil_time(st: Dict, gpu: Dict, size: Tuple[int, int, int, int], hw: Dict,
                 tiles: Dict[str, torch.Tensor], dtype=torch.float64) -> torch.Tensor:
    """T_alg (s) of eqs. 9-15 for ``size`` = (s1, s2, s3, t) at hardware
    point ``hw`` for every tile in ``tiles``, computed in ``dtype`` on the
    CPU; +inf where infeasible."""
    def f(v):
        return torch.as_tensor(v, dtype=torch.float64).to(dtype)

    t_s1, t_s2, t_t, k, t_s3 = (f(tiles[n]) for n in ("t_s1", "t_s2", "t_t", "k", "t_s3"))
    s1, s2, s3, t_total = (f(v) for v in size)
    n_sm, n_v, m_sm = f(hw["n_sm"]), f(hw["n_v"]), f(hw["m_sm"])
    r, three = st["radius"], st["dims"] == 3
    w_avg = t_s1 + f(r) * t_t
    depth = t_s3 + f(2 * r) if three else f(1)
    fp = f(st["n_arrays"]) * (t_s1 + f(2 * r) * t_t + f(2 * r)) * (t_s2 + f(2 * r)) * depth \
        * f(gpu["bytes_per_word"])
    t_compute = f(st["c_iter"]) * t_t * w_avg * t_s3 * torch.ceil(k * t_s2 / n_v)
    tiles_phase = torch.ceil(torch.ceil(s1 / w_avg) / f(2)) * torch.ceil(s2 / t_s2) \
        * (torch.ceil(s3 / t_s3) if three else f(1))
    tiles_phase = torch.maximum(tiles_phase, f(1))
    concurrent = torch.minimum(k * n_sm, tiles_phase)
    batches = torch.ceil(tiles_phase / (k * n_sm))
    t_batch = torch.maximum(t_compute, concurrent * fp / f(gpu["bw_gmem"]))
    t_alg = f(2) * torch.ceil(t_total / t_t) * (batches * t_batch + f(gpu["launch_overhead"]))
    ok = (k * fp <= m_sm * f(1024)) & (k <= gpu["max_threadblocks_per_sm"]) \
        & (t_s2 <= gpu["max_threads_per_block"]) & (k * t_s2 <= gpu["max_threads_per_sm"]) \
        & (t_t % 2 == 0) & (t_s2 % 32 == 0)
    inf = torch.full_like(t_alg, float("inf"), dtype=torch.float64)
    return torch.where(ok, t_alg.double(), inf)


def best_time(st: Dict, gpu: Dict, size, hw: Dict, lat: Dict, dtype=torch.float64):
    """(least T_alg over the lattice, in float64; the tile that the model
    computed in ``dtype`` ranks first, the lowest lattice index on a tie)."""
    t = stencil_time(st, gpu, size, hw, lat, dtype)
    i = int(torch.argmin(t))
    return float(stencil_time(st, gpu, size, hw, lat).min()), \
        {n: int(v[i]) for n, v in lat.items()}
