"""Build and bind the hand-written CUDA kernels under ``csrc/``.

Each ``csrc/*.cu`` source compiles with ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface, loaded with ``ctypes``. The
sources compile in parallel (one ``nvcc`` each, all started together) at
first use, into ``build/repro_torch_kernels/<hash>/`` of the checkout; the
hash covers the sources and the flags, so an edited source rebuilds and an
unchanged one is reused. ``nvcc`` is found through ``CUDA_HOME``, then
``PATH``, then ``/usr/local/cuda``; without it the build raises.

Every C entry point takes a stencil id and a dtype id and returns
``cudaGetLastError()`` after its launch: :func:`check` raises when that is
not 0. :data:`LAUNCHES` counts the launches each wrapper made.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict

import torch

__all__ = [
    "STENCIL_IDS",
    "DTYPE_IDS",
    "LAUNCHES",
    "reset_launches",
    "find_nvcc",
    "build",
    "library",
    "check",
    "stream_of",
    "cuda_args",
]

CSRC = Path(__file__).with_name("csrc")
SOURCES = ("tiled.cu", "step.cu")
HEADERS = ("stencil_bodies.cuh",)
#: ``--fmad=false``: no multiply-add contraction, so each kernel rounds
#: every operation where the plain torch version rounds it (see the note
#: in csrc/stencil_bodies.cuh).
NVCC_FLAGS = (
    "-gencode=arch=compute_90a,code=sm_90a",
    "-std=c++17",
    "-O3",
    "--fmad=false",
    "-Xptxas",
    "-v",
    "-shared",
    "-Xcompiler",
    "-fPIC",
)
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"

#: the StencilId enum of csrc/stencil_bodies.cuh
STENCIL_IDS: Dict[str, int] = {
    "jacobi2d": 0,
    "heat2d": 1,
    "laplacian2d": 2,
    "gradient2d": 3,
    "heat3d": 4,
    "laplacian3d": 5,
}
#: the DtypeId enum of csrc/stencil_bodies.cuh
DTYPE_IDS = {torch.float32: 0, torch.bfloat16: 1}

#: launches per kernel wrapper, counted where the wrapper launches
LAUNCHES: Dict[str, int] = {"tiled2d": 0, "tiled3d": 0, "step2d": 0, "step3d": 0}

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_ENTRY_POINTS = {
    "tiled": {
        # x, out, dtype, stencil, s1, s2, t1, t2, n, h, smem bytes, stream
        "repro_tiled2d": [_P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _LL, _P],
        # x, out, dtype, stencil, s1, s2, s3, t1, t2, t3, n, h, smem bytes, stream
        "repro_tiled3d": [_P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _LL, _P],
    },
    "step": {
        # x, out, dtype, stencil, rows, width, h, block_rows, stream
        "repro_step2d": [_P, _P, _I, _I, _I, _I, _I, _I, _P],
        # x, out, dtype, stencil, d, h, w, halo, block_rows, stream
        "repro_step3d": [_P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
    },
}

#: loaded libraries by source stem (process-wide, like any loaded library)
_LIBS: Dict[str, ctypes.CDLL] = {}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def find_nvcc() -> str:
    """Path of ``nvcc``: ``$CUDA_HOME/bin``, then ``PATH``, then
    ``/usr/local/cuda/bin``. Raises when none has it."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    on_path = shutil.which("nvcc")
    if on_path:
        cands.append(Path(on_path))
    cands.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in cands:
        if c.is_file():
            return str(c)
    raise FileNotFoundError(
        "nvcc not found (looked in $CUDA_HOME/bin, PATH, /usr/local/cuda/bin); "
        "the CUDA kernels cannot be built"
    )


def _build_dir() -> Path:
    h = hashlib.sha256()
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_ROOT / h.hexdigest()[:16]


def build() -> Dict[str, dict]:
    """Compile every source whose library is missing, all in parallel.

    Returns ``{stem: {"path", "seconds", "log"}}`` per source; ``log`` is
    nvcc's output (the ``-Xptxas -v`` registers, shared memory and spills
    per kernel) for a source built now, else ``""``. Raises on any failure.
    """
    out_dir = _build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    report: Dict[str, dict] = {}
    procs = {}
    for src in SOURCES:
        stem = Path(src).stem
        lib = out_dir / f"lib{stem}.so"
        report[stem] = {"path": str(lib), "seconds": 0.0, "log": ""}
        if lib.exists():
            continue
        tmp = out_dir / f".lib{stem}.{os.getpid()}.so"
        cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / src)]
        procs[stem] = (
            subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
            ),
            tmp,
            lib,
            time.perf_counter(),
        )
    failed = []
    for stem, (proc, tmp, lib, t0) in procs.items():
        log, _ = proc.communicate()
        report[stem]["seconds"] = time.perf_counter() - t0
        report[stem]["log"] = log
        if proc.returncode != 0:
            failed.append(f"{stem}: nvcc exited {proc.returncode}\n{log}")
        else:
            os.replace(tmp, lib)
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return report


def library(stem: str) -> ctypes.CDLL:
    """The loaded library built from ``csrc/<stem>.cu`` (built if needed),
    with ``argtypes``/``restype`` set on every entry point."""
    lib = _LIBS.get(stem)
    if lib is None:
        path = build()[stem]["path"]
        lib = ctypes.CDLL(path)
        for fn, argtypes in _ENTRY_POINTS[stem].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        lib.repro_error_string.argtypes = [ctypes.c_int]
        lib.repro_error_string.restype = ctypes.c_char_p
        _LIBS[stem] = lib
    return lib


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise if a launch returned a CUDA error."""
    if rc != 0:
        msg = lib.repro_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")


def stream_of(x: torch.Tensor) -> int:
    """The raw handle of PyTorch's current stream on ``x``'s device."""
    return torch.cuda.current_stream(x.device).cuda_stream


def cuda_args(x: torch.Tensor, kernel: str):
    """Validate a CUDA input, allocate its output and return
    ``(out, dtype id)``: the wrappers' shared pre-launch checks."""
    if x.dtype not in DTYPE_IDS:
        raise TypeError(f"{kernel}: dtype {x.dtype} not supported (float32, bfloat16)")
    if not x.is_contiguous():
        raise ValueError(f"{kernel}: input must be contiguous")
    if x.numel() >= 2**31:
        raise ValueError(f"{kernel}: {x.numel()} elements exceed the int32 index range")
    return torch.empty_like(x), DTYPE_IDS[x.dtype]
