"""The eq.-18 sweep engine in PyTorch: hardware points x tile lattice.

The JAX package compiles the sweep as a jitted ``vmap`` over hardware
points and problem sizes. Here each ``vmap`` is an explicit broadcast: one
call of :func:`repro_torch.core.timemodel.stencil_time` with ``xp=torch``
evaluates a ``(P sizes, chunk hardware points, L lattice candidates)``
float32 tensor on the device, then ``argmin`` over the lattice axis picks
each (size, hardware) optimum.

* The lattice is pruned up front of candidates that break the
  hardware-independent constraints (:func:`_lattice_arrays`); original
  lattice indices are returned (``keep_idx`` remap), ``-1`` / ``+inf``
  where no candidate is feasible.
* The hardware axis is chunked: ``chunk=None`` takes the reference's
  ``DEFAULT_CHUNK // P`` rule, so the times tensor of one chunk holds
  ``DEFAULT_CHUNK x L`` floats whatever P is. ``chunk <= 0`` disables it.
* ``torch.argmin`` returns the first minimum, as ``jnp.argmin`` does; ties
  are still judged by the tie-aware check against the numpy oracle.
* :func:`refine_points` runs the batched coordinate descent: every point
  moves to its best single-step neighbour each round, until no point moves.
* :func:`sweep_cells_sharded` splits the hardware axis over several
  devices from one process (the reference's ``shard_map`` over a 1-D
  ``("hw",)`` mesh): each shard's chunks are launched on its own device,
  asynchronously, so shards overlap across cards, and the results are
  gathered to the host. Bit-identical to :func:`sweep_cells`.

Entry points run on the card unless the caller passes ``device="cpu"``.
"""

from __future__ import annotations

import functools
import threading
import time
from typing import Dict, Tuple

import numpy as np
import torch

from .._device import resolve_device
from ..obs.metrics import get_registry as _obs_registry
from .solver import LATTICE_2D, LATTICE_3D, TileLattice
from .solver import _STEPS as _SOLVER_STEPS
from .timemodel import GPUSpec, ProblemSize, StencilSpec, stencil_time

__all__ = [
    "DEFAULT_CHUNK",
    "SW_NAMES",
    "SW_STEPS",
    "SW_MINS",
    "sweep_cell",
    "sweep_cells",
    "sweep_cells_sharded",
    "refine_points",
    "decode_sw",
    "device_count",
    "clear_caches",
]

#: hardware points per chunk for a single problem size (scaled down by P).
DEFAULT_CHUNK = 2048

#: software-parameter column order used by the packed (P, 5) refine arrays.
SW_NAMES = ("t_s1", "t_s2", "t_t", "k", "t_s3")

#: aligned unit steps per parameter and the descent's lower bounds, from
#: the numpy oracle's table so the two refine paths cannot drift apart.
SW_STEPS = tuple(float(_SOLVER_STEPS[k]) for k in SW_NAMES)
SW_MINS = tuple(1.0 if k == "t_s1" else float(_SOLVER_STEPS[k]) for k in SW_NAMES)

# ---- observability (repro_torch.obs; no-ops under REPRO_OBS_DISABLED=1) --
_REG = _obs_registry()
_M_DISPATCH_SECONDS = _REG.histogram(
    "repro_sweep_dispatch_seconds",
    "wall time of one sweep dispatch (solve call through host "
    "materialization), split by engine and phase: 'first' is the initial "
    "dispatch of a (device, shape) pair -- allocator and context warm-up "
    "included -- 'steady' is every later dispatch of the same pair",
    labels=("engine", "phase"),
)
_M_CELL_EVALS = _REG.counter(
    "repro_sweep_cell_evals_total",
    "optima-matrix entries produced (P sizes x H hardware points per "
    "dispatch) -- divide by dispatch seconds for cells/sec",
    labels=("engine",),
)

#: (device, shapes) pairs whose first dispatch has been seen.
_DISPATCH_SEEN: set = set()
_DISPATCH_MU = threading.Lock()


def _note_dispatch(engine: str, cache_key: tuple, p: int, h: int, dt: float) -> None:
    """Record one dispatch, classified first/steady by whether this
    (device, shape) pair has dispatched before."""
    with _DISPATCH_MU:
        first = cache_key not in _DISPATCH_SEEN
        if first:
            _DISPATCH_SEEN.add(cache_key)
    _M_DISPATCH_SECONDS.labels(
        engine=engine, phase="first" if first else "steady"
    ).observe(dt)
    _M_CELL_EVALS.labels(engine=engine).inc(p * h)


def device_count() -> int:
    """Attached CUDA devices (0 without a card). The ``engine="auto"`` rule
    reads it through here, so tests can monkeypatch it."""
    return torch.cuda.device_count()


def _resolve_devices(devices) -> Tuple[torch.device, ...]:
    """The ``devices=`` knob as a tuple of shard devices.

    ``None`` -> every attached card; an int n -> the first n cards
    (``ValueError`` outside 1..attached, so a CPU host refuses any int);
    a sequence -> its entries as given, one shard each. A sequence may
    repeat a device: ``["cpu"] * 8`` is the port's counterpart of the
    reference's ``XLA_FLAGS=--xla_force_host_platform_device_count=8``,
    eight shards in one process.
    """
    if devices is None:
        n = device_count()
        if n == 0:
            raise RuntimeError(
                "no CUDA device is available; pass devices=['cpu', ...] to shard on the CPU"
            )
        return tuple(torch.device("cuda", i) for i in range(n))
    if isinstance(devices, int) and not isinstance(devices, bool):
        avail = device_count()
        if not 1 <= devices <= avail:
            raise ValueError(f"devices={devices} out of range (1..{avail} attached)")
        return tuple(torch.device("cuda", i) for i in range(devices))
    devs = tuple(torch.device(d) for d in devices)
    if not devs:
        raise ValueError("devices= names no device")
    return devs


@functools.lru_cache(maxsize=64)
def _lattice_arrays(lattice: TileLattice, gpu: GPUSpec, device):
    """Pruned (candidates, original-index) lattice columns on ``device``,
    cached per (lattice, GPU, device) until :func:`clear_caches`.

    Candidates that violate the hardware-independent constraints (eqs.
    10/12-15 with GPU-family constants) are +inf at every hardware point,
    so dropping them cannot change an argmin.
    """
    g = lattice.grid()
    keep = (
        (g["k"] * g["t_s2"] <= gpu.max_threads_per_sm)
        & (g["t_s2"] <= gpu.max_threads_per_block)
        & (g["k"] <= gpu.max_threadblocks_per_sm)
        & (g["t_t"] % 2 == 0)
        & (g["t_s2"] % 32 == 0)
    )
    keep_idx = np.nonzero(keep)[0]
    cols = tuple(
        torch.as_tensor(g[k][keep_idx], dtype=torch.float32, device=device)
        for k in SW_NAMES
    )
    return cols, torch.as_tensor(keep_idx, dtype=torch.int64, device=device)


def _best_of_factory(gpu: GPUSpec, lat, keep_idx):
    """The fused eq.-18 inner body: ``best_of(hw_chunk (n, 3), sizes (P, 4),
    st) -> (best_t (P, n), best_i (P, n))``."""
    cols = tuple(c.view(1, 1, -1) for c in lat)

    def best_of(hw_chunk, sizes, st):
        n_sm, n_v, m_sm = (hw_chunk[:, j].view(1, -1, 1) for j in range(3))
        s1, s2, s3, t = (sizes[:, j].view(-1, 1, 1) for j in range(4))
        times = stencil_time(
            st, gpu, ProblemSize(s1=s1, s2=s2, t=t, s3=s3), n_sm, n_v, m_sm,
            *cols, xp=torch, dtype=torch.float32,
        )  # (P, n, L)
        best_i = torch.argmin(times, dim=2)
        best_t = torch.gather(times, 2, best_i.unsqueeze(2)).squeeze(2)
        # map back to the full lattice's indices; -1 where nothing fits
        best_i = torch.where(
            torch.isfinite(best_t), keep_idx[best_i], torch.full_like(best_i, -1)
        )
        return best_t, best_i

    return best_of


def _prep_cells(st: StencilSpec, sizes, lattice, chunk):
    """Shared argument normalization: default lattice by dimensionality,
    (P, 4) size validation, P-scaled chunk."""
    if lattice is None:
        lattice = LATTICE_3D if st.dims == 3 else LATTICE_2D
    sizes = np.atleast_2d(np.asarray(sizes, np.float64))
    if sizes.shape[1] != 4:
        raise ValueError(f"sizes must be (P, 4) (s1, s2, s3, t); got {sizes.shape}")
    if chunk is None:
        chunk = max(1, DEFAULT_CHUNK // sizes.shape[0])
    return lattice, sizes, int(chunk)


def _solve_on(st, gpu, lat, keep_idx, sizes, hw, step: int):
    """Launch the chunked sweep of ``hw`` (n, 3) on its device; returns the
    device tensors ``(best_t (P, n), best_i (P, n))`` without waiting."""
    device = hw.device
    best_of = _best_of_factory(gpu, lat, keep_idx)
    sz = torch.as_tensor(sizes, dtype=torch.float32, device=device)
    p, h = sizes.shape[0], hw.shape[0]
    best_t = torch.empty((p, h), dtype=torch.float32, device=device)
    best_i = torch.empty((p, h), dtype=torch.int64, device=device)
    for lo in range(0, h, step):
        t, i = best_of(hw[lo:lo + step], sz, st)
        best_t[:, lo:lo + step] = t
        best_i[:, lo:lo + step] = i
    return best_t, best_i


def sweep_cells(
    st: StencilSpec,
    gpu: GPUSpec,
    sizes: np.ndarray,
    n_sm: np.ndarray,
    n_v: np.ndarray,
    m_sm: np.ndarray,
    lattice: TileLattice | None = None,
    chunk: int | None = None,
    device=None,
) -> Tuple[np.ndarray, np.ndarray]:
    """All P problem sizes of one stencil against every hardware point.

    ``sizes`` is a ``(P, 4)`` array of ``(s1, s2, s3, t)`` rows. Returns
    ``(best_time (P, H), best_lattice_index (P, H))`` as float64/int64
    numpy; infeasible points get ``+inf`` / ``-1``.
    """
    device = resolve_device(device)
    lattice, sizes, chunk = _prep_cells(st, sizes, lattice, chunk)
    p = sizes.shape[0]
    hw = torch.as_tensor(
        np.stack([np.asarray(a, np.float64).ravel() for a in (n_sm, n_v, m_sm)], 1),
        dtype=torch.float32, device=device,
    )  # (H, 3)
    h = hw.shape[0]
    lat, keep_idx = _lattice_arrays(lattice, gpu, device)
    if keep_idx.numel() == 0 or h == 0:
        return np.full((p, h), np.inf), np.full((p, h), -1, np.int64)
    t0 = time.perf_counter()
    step = h if chunk <= 0 else int(chunk)
    best_t, best_i = _solve_on(st, gpu, lat, keep_idx, sizes, hw, step)
    out = (
        best_t.cpu().numpy().astype(np.float64),  # waits for the device
        best_i.cpu().numpy().astype(np.int64),
    )
    _note_dispatch(
        "torch", (str(device), p, h, step, keep_idx.numel()), p, h,
        time.perf_counter() - t0,
    )
    return out


def sweep_cells_sharded(
    st: StencilSpec,
    gpu: GPUSpec,
    sizes: np.ndarray,
    n_sm: np.ndarray,
    n_v: np.ndarray,
    m_sm: np.ndarray,
    lattice: TileLattice | None = None,
    chunk: int | None = None,
    devices=None,
) -> Tuple[np.ndarray, np.ndarray]:
    """:func:`sweep_cells` with the hardware axis sharded over devices,
    from one process (no process group).

    The (H,) hardware columns are padded to a multiple of ``len(devices) x
    chunk`` (repeating the first point, whose results are discarded) and
    split into one equal shard per entry of ``devices``; each shard's
    chunks are launched on its device (launches are asynchronous, so the
    shards overlap across cards) and the shards are gathered to the host.
    The chunk is capped at the shard size (``min(chunk, ceil(H / n_dev))``)
    so a small H does not pad every shard to a full default chunk. Every
    hardware point is evaluated by the same float32 broadcast as in
    :func:`sweep_cells`, so times and indices are **bit-identical** to it
    (``tests/test_torch_sweep_sharded.py``).

    ``devices`` is ``None`` (every card), an int (the first n cards) or a
    sequence of devices, one shard per entry; a sequence may repeat a
    device, so ``devices=["cpu"] * 8`` runs eight shards on the CPU, as
    the reference's ``XLA_FLAGS=--xla_force_host_platform_device_count=8``
    runs its mesh on one host.
    """
    lattice, sizes, chunk = _prep_cells(st, sizes, lattice, chunk)
    devs = _resolve_devices(devices)
    n_dev, p = len(devs), sizes.shape[0]
    cols = [np.asarray(np.asarray(a, np.float64).ravel(), np.float32) for a in (n_sm, n_v, m_sm)]
    h = cols[0].shape[0]
    if h == 0:
        return np.full((p, 0), np.inf), np.full((p, 0), -1, np.int64)
    if chunk > 0:
        chunk = min(chunk, -(-h // n_dev))
    quantum = n_dev * max(chunk, 1)
    h_pad = -(-h // quantum) * quantum
    if h_pad != h:
        cols = [np.concatenate([a, np.full(h_pad - h, a[0], a.dtype)]) for a in cols]
    hw = np.stack(cols, 1)  # (H_pad, 3) float32, as sweep_cells converts it
    per = h_pad // n_dev
    step = per if chunk <= 0 else chunk
    t0 = time.perf_counter()
    shards = []
    for k, dev in enumerate(devs):
        lat, keep_idx = _lattice_arrays(lattice, gpu, dev)
        if keep_idx.numel() == 0:
            return np.full((p, h), np.inf), np.full((p, h), -1, np.int64)
        hw_k = torch.as_tensor(hw[k * per:(k + 1) * per], device=dev)
        shards.append(_solve_on(st, gpu, lat, keep_idx, sizes, hw_k, step))
    out = (  # .cpu() waits for each shard's device in turn
        np.concatenate([t.cpu().numpy() for t, _ in shards], 1)[:, :h].astype(np.float64),
        np.concatenate([i.cpu().numpy() for _, i in shards], 1)[:, :h].astype(np.int64),
    )
    _note_dispatch(
        "sharded", (tuple(map(str, devs)), p, h_pad, step), p, h, time.perf_counter() - t0,
    )
    return out


def sweep_cell(
    st: StencilSpec,
    gpu: GPUSpec,
    size: ProblemSize,
    n_sm: np.ndarray,
    n_v: np.ndarray,
    m_sm: np.ndarray,
    lattice: TileLattice | None = None,
    chunk: int = DEFAULT_CHUNK,
    device=None,
) -> Tuple[np.ndarray, np.ndarray]:
    """The P=1 case of :func:`sweep_cells`, shaped like the numpy oracle's
    :func:`repro_torch.core.solver.solve_cell` result."""
    sizes = np.array([[size.s1, size.s2, size.s3, size.t]], np.float64)
    best_t, best_i = sweep_cells(
        st, gpu, sizes, n_sm, n_v, m_sm, lattice, int(chunk), device=device
    )
    return best_t[0], best_i[0]


def refine_points(
    st: StencilSpec,
    gpu: GPUSpec,
    sizes: np.ndarray,
    hw: np.ndarray,
    sw0: np.ndarray,
    max_rounds: int = 64,
    device=None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Coordinate descent over aligned integer steps, batched over P points.

    ``sizes`` (P, 4) as (s1, s2, s3, t), ``hw`` (P, 3) as (n_sm, n_v, m_sm),
    ``sw0`` (P, 5) start tiles in :data:`SW_NAMES` order. Each round every
    point moves to its best candidate among itself and its +/- one-step
    neighbours (clamped to :data:`SW_MINS`; ``argmin`` ties keep the current
    point, listed first); the descent stops after a round in which no point
    moved, or after ``max_rounds``. Returns ``(times (P,), sw (P, 5))``.
    """
    device = resolve_device(device)
    hw64 = np.asarray(hw, np.float64)
    sizes64 = np.asarray(sizes, np.float64)
    sw = np.asarray(sw0, np.float64)
    if max_rounds <= 0:  # the start points untouched, with float64 times
        size = ProblemSize(
            s1=sizes64[:, 0], s2=sizes64[:, 1], t=sizes64[:, 3], s3=sizes64[:, 2]
        )
        cur = stencil_time(
            st, gpu, size, hw64[:, 0], hw64[:, 1], hw64[:, 2],
            sw[:, 0], sw[:, 1], sw[:, 2], sw[:, 3], sw[:, 4],
        )
        return np.asarray(cur, np.float64), sw

    f32 = dict(dtype=torch.float32, device=device)
    steps = torch.as_tensor(SW_STEPS, **f32)
    mins = torch.as_tensor(SW_MINS, **f32)
    n_par = len(SW_NAMES)
    deltas = torch.cat(
        [torch.zeros((1, n_par), **f32), torch.diag(steps), -torch.diag(steps)]
    )  # (2n+1, 5): current point first
    hw_t = torch.as_tensor(hw64, **f32)
    sz_t = torch.as_tensor(sizes64, **f32)
    size = ProblemSize(
        s1=sz_t[:, 0:1], s2=sz_t[:, 1:2], t=sz_t[:, 3:4], s3=sz_t[:, 2:3]
    )
    cur = torch.as_tensor(sw, **f32)
    best_t = torch.full((cur.shape[0],), float("inf"), **f32)
    for _ in range(int(max_rounds)):
        cands = torch.maximum(cur[:, None, :] + deltas[None], mins)  # (P, 2n+1, 5)
        times = stencil_time(
            st, gpu, size, hw_t[:, 0:1], hw_t[:, 1:2], hw_t[:, 2:3],
            *(cands[:, :, j] for j in range(n_par)), xp=torch, dtype=torch.float32,
        )  # (P, 2n+1)
        best = torch.argmin(times, dim=1)
        best_t = torch.gather(times, 1, best[:, None])[:, 0]
        nxt = torch.gather(cands, 1, best[:, None, None].expand(-1, 1, n_par))[:, 0]
        moved = bool(torch.any(nxt != cur))
        cur = nxt
        if not moved:
            break
    return (
        best_t.cpu().numpy().astype(np.float64),
        cur.cpu().numpy().astype(np.float64),
    )


def decode_sw(sw_row: np.ndarray) -> Dict[str, int]:
    """(5,) packed software-parameter row -> tile-size dict."""
    return {name: int(v) for name, v in zip(SW_NAMES, sw_row)}


def clear_caches() -> None:
    """Drop the cached lattice columns and the first/steady dispatch
    record (for tests and benchmarks that time cold starts)."""
    _lattice_arrays.cache_clear()
    with _DISPATCH_MU:
        _DISPATCH_SEEN.clear()
