"""Tile-parameterized stencils K1 (2-D) and K2 (3-D), and their plain versions.

Replaces ``_pass_2d`` / ``_kernel_2d`` and ``_pass_3d`` / ``_kernel_3d`` of
the JAX package's ``kernels/pallas_stencils.py``: the stencils run at the
software parameters ``(t_s1, t_s2, t_t, k, t_s3)`` the eq.-18 sweep
enumerates, so the measurement harness can time the tile shapes the
optimizer picks.

* A tile is a ``(t_s1, t_s2[, t_s3])`` block of the array; one pass (one
  launch) advances ``n <= t_t`` steps of it from a window widened by the
  halo ``hh = radius * n`` on every axis (overlapped, trapezoidal time
  tiling). After ``n`` steps the outer ``hh`` ring of the window is stale
  and the core tile is exact.
* Dirichlet borders and out-of-array cells are handled by a mask on
  *global* coordinates: a cell outside ``[radius, s - radius)`` on any
  axis keeps its value. Reads outside the array take the nearest edge
  value (``jnp.pad(mode="edge")``).
* ``k`` (tiles co-resident per SM) changes no value and is ignored, as the
  TPU kernel ignores it.

On the card (``csrc/tiled.cu``) one block of ``min(t_s2, 1024)`` threads
runs one tile: it stages the window in shared memory as f32, steps it
there between two buffers, and writes back the core. The window is clipped
to the array (cells outside it are pinned edge copies that no core value
depends on), so it holds :func:`window_cells` cells and two buffers take
:func:`window_bytes`. A pass whose window exceeds :data:`SMEM_LIMIT_BYTES`
raises ``ValueError`` before launch: it is never run some other way, so a
measurement stamped with a tile is always a run of that tile.

A CUDA tensor launches the kernel (or raises); a CPU tensor takes the
plain version, which evaluates every tile's window at once.
"""

from __future__ import annotations

from types import ModuleType
from typing import Dict, Mapping, Optional, Sequence, Tuple

import torch

from . import _build, gradient2d, heat2d, heat3d, jacobi2d, laplacian2d, laplacian3d
from .stencil_common import edge_pad

__all__ = [
    "TILE_NAMES",
    "DEFAULT_TILES",
    "SMEM_LIMIT_BYTES",
    "normalize_tiles",
    "tile_footprint_cells",
    "window_cells",
    "window_bytes",
    "check_window",
    "tile_shape",
    "tiled_pass_plain",
    "run_tiled_plain",
    "stencil_run_tiled",
    "run_tiled",
]

#: software-parameter order, the same as ``repro_torch.core.sweep.SW_NAMES``
TILE_NAMES = ("t_s1", "t_s2", "t_t", "k", "t_s3")

#: a modest, always-feasible default (every stencil, every shape).
DEFAULT_TILES = {"t_s1": 8, "t_s2": 32, "t_t": 2, "k": 1, "t_s3": 8}

#: shared memory one block may opt in to on an H100 (sm_90): 227 KB
SMEM_LIMIT_BYTES = 232_448

_MODULES: Dict[str, ModuleType] = {
    m.NAME: m
    for m in (jacobi2d, heat2d, laplacian2d, gradient2d, heat3d, laplacian3d)
}


def normalize_tiles(tiles: Optional[Mapping[str, int]]) -> Tuple[int, ...]:
    """Tile mapping -> ``TILE_NAMES``-ordered int tuple. Unknown names and
    non-positive sizes are rejected, so a typo'd sweep row fails loudly."""
    merged = dict(DEFAULT_TILES)
    if tiles:
        unknown = set(tiles) - set(TILE_NAMES)
        if unknown:
            raise ValueError(
                f"unknown tile parameter(s) {sorted(unknown)} "
                f"(want {list(TILE_NAMES)})"
            )
        merged.update({k: int(v) for k, v in tiles.items()})
    out = tuple(int(merged[k]) for k in TILE_NAMES)
    if any(v < 1 for v in out):
        raise ValueError(f"tile sizes must be >= 1, got {dict(zip(TILE_NAMES, out))}")
    return out


def tile_footprint_cells(dims: int, tiles: Mapping[str, int], radius: int = 1) -> int:
    """Cells of one unclipped halo-extended time tile (``t_t`` deep) -- the
    empirical analogue of :func:`repro_torch.core.timemodel.footprint_bytes`."""
    t = dict(zip(TILE_NAMES, normalize_tiles(tiles)))
    hh = radius * t["t_t"]
    cells = (t["t_s1"] + 2 * hh) * (t["t_s2"] + 2 * hh)
    if dims == 3:
        cells *= t["t_s3"] + 2 * hh
    return int(cells)


def tile_shape(dims: int, tiles: Sequence[int]) -> Tuple[int, ...]:
    """The spatial tile extents of a normalized tile tuple."""
    t_s1, t_s2, _t_t, _k, t_s3 = tiles
    return (t_s1, t_s2, t_s3)[:dims]


def _pass_depths(steps: int, t_t: int):
    """Steps per pass: ``t_t`` each, the last one what remains."""
    return [min(t_t, steps - done) for done in range(0, steps, t_t)]


def window_cells(shape: Sequence[int], tile_ext: Sequence[int], n: int, radius: int = 1) -> int:
    """Cells of the largest window the kernel stages for an ``n``-step pass:
    per axis the tile plus ``radius * n`` each side, clipped to the array."""
    cells = 1
    for s, t in zip(shape, tile_ext):
        cells *= min(t + 2 * radius * n, s)
    return cells


def window_bytes(shape: Sequence[int], tile_ext: Sequence[int], n: int, radius: int = 1) -> int:
    """Shared-memory bytes of one block: two f32 buffers of the window."""
    return 2 * 4 * window_cells(shape, tile_ext, n, radius)


def check_window(name: str, shape, tiles: Sequence[int], n: int, radius: int = 1) -> int:
    """The window bytes of an ``n``-step pass; raises ``ValueError`` naming
    the tile, the bytes and the limit when they exceed
    :data:`SMEM_LIMIT_BYTES`."""
    nbytes = window_bytes(shape, tile_shape(len(shape), tiles), n, radius)
    if nbytes > SMEM_LIMIT_BYTES:
        raise ValueError(
            f"{name}: tile {dict(zip(TILE_NAMES, tiles))} on shape {tuple(shape)} "
            f"needs a {n}-step window of {nbytes} B of shared memory, over the "
            f"{SMEM_LIMIT_BYTES} B a block may have"
        )
    return nbytes


def tiled_pass_plain(
    x: torch.Tensor, update, radius: int, tile_ext: Sequence[int], n: int
) -> torch.Tensor:
    """Plain version of one K1/K2 pass: every tile's unclipped window is
    gathered (edge-clamped global reads), stepped ``n`` times under the
    global-coordinate mask with window-local edge replication, and its core
    written back."""
    dims = x.dim()
    hh = radius * n
    dev = x.device
    idx, act, grid = [], [], []
    for s, t in zip(x.shape, tile_ext):
        g = -(-s // t)
        coord = (
            torch.arange(g, device=dev)[:, None] * t - hh
            + torch.arange(t + 2 * hh, device=dev)[None, :]
        )  # (g, window extent) global coordinates
        idx.append(coord.clamp(0, s - 1))
        act.append((coord >= radius) & (coord < s - radius))
        grid.append(g)

    def spread(v, a):
        # axis a's (g, e) table -> broadcastable over (g1..gD, e1..eD)
        shape = [1] * (2 * dims)
        shape[a], shape[dims + a] = v.shape
        return v.view(shape)

    v = x.to(torch.float32)[tuple(spread(i, a) for a, i in enumerate(idx))]
    active = spread(act[0], 0)
    for a in range(1, dims):
        active = active & spread(act[a], a)
    for _ in range(n):
        v = torch.where(active, update(edge_pad(v, radius, dims), radius), v)
    core = v[(Ellipsis,) + tuple(slice(hh, hh + t) for t in tile_ext)]
    # (g1..gD, t1..tD) -> (g1 t1, ..., gD tD)
    perm = [p for a in range(dims) for p in (a, dims + a)]
    out = core.permute(perm).reshape([g * t for g, t in zip(grid, tile_ext)])
    return out[tuple(slice(0, s) for s in x.shape)].to(x.dtype)


def _launch(x: torch.Tensor, name: str, radius: int, tiles, n: int) -> torch.Tensor:
    kernel = "tiled3d" if x.dim() == 3 else "tiled2d"
    smem = check_window(name, x.shape, tiles, n, radius)
    out, dtype_id = _build.cuda_args(x, kernel)
    lib = _build.library("tiled")
    sid = _build.STENCIL_IDS[name]
    with torch.cuda.device(x.device):
        stream = _build.stream_of(x)
        fn = lib.repro_tiled3d if x.dim() == 3 else lib.repro_tiled2d
        rc = fn(
            x.data_ptr(), out.data_ptr(), dtype_id, sid, *x.shape, *tile_shape(x.dim(), tiles),
            n, radius, smem, stream,
        )
    _build.check(lib, rc, kernel)
    _build.LAUNCHES[kernel] += 1
    return out


def run_tiled_plain(
    name: str, x: torch.Tensor, steps: int, tiles: Tuple[int, ...]
) -> torch.Tensor:
    """Plain version of :func:`stencil_run_tiled`, on any device."""
    mod = _MODULES[name]
    for n in _pass_depths(steps, tiles[TILE_NAMES.index("t_t")]):
        x = tiled_pass_plain(x, mod.update, mod.HALO, tile_shape(mod.DIMS, tiles), n)
    return x


def stencil_run_tiled(
    name: str, x: torch.Tensor, steps: int, tiles: Tuple[int, ...]
) -> torch.Tensor:
    """T-step run at one normalized tile tuple (from :func:`normalize_tiles`):
    ``ceil(steps / t_t)`` passes, one launch each on the card; a CPU tensor
    takes :func:`run_tiled_plain`."""
    mod = _MODULES[name]
    if x.dim() != mod.DIMS:
        raise ValueError(f"{name}: expected a {mod.DIMS}-D array, got shape {tuple(x.shape)}")
    if not x.is_cuda:
        if x.device.type != "cpu":
            raise ValueError(f"{name}: unsupported device {x.device}")
        return run_tiled_plain(name, x, steps, tiles)
    for n in _pass_depths(steps, tiles[TILE_NAMES.index("t_t")]):
        x = _launch(x, name, mod.HALO, tiles, n)
    return x


def run_tiled(
    name: str,
    x: torch.Tensor,
    steps: int = 1,
    tiles: Optional[Mapping[str, int]] = None,
) -> torch.Tensor:
    """T time steps of the named stencil at an eq.-18 tile configuration.

    ``tiles`` maps any subset of :data:`TILE_NAMES` to ints; missing
    parameters take :data:`DEFAULT_TILES`. Zero steps return ``x`` itself.
    """
    if name not in _MODULES:
        raise KeyError(f"unknown stencil {name!r} (want one of {sorted(_MODULES)})")
    if steps < 0:
        raise ValueError(f"steps must be >= 0, got {steps}")
    if steps == 0:
        return x
    return stencil_run_tiled(name, x, int(steps), normalize_tiles(tiles))
