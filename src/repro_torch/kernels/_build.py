"""Build and bind the hand-written CUDA kernels under ``csrc/``.

Each ``csrc/*.cu`` source compiles with ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface, loaded with ``ctypes``. The
libraries form two groups (:data:`GROUPS`), each with its own sources and
flags, built at the first use of one of its libraries: the stencils'
(``tiled``, ``step``; :data:`NVCC_FLAGS`) and attention's (``attention``;
:data:`ATTENTION_FLAGS`), so a process that runs no attention never
compiles or loads it. A group's sources compile in parallel (one ``nvcc``
each, all started together) into ``build/repro_torch_kernels/<hash>/`` of
the checkout; the hash covers the group's sources and flags, so an edited
source rebuilds and an unchanged one is reused. ``nvcc`` is found through
``CUDA_HOME``, then ``PATH``, then ``/usr/local/cuda``; without it the
build raises.

Every C entry point returns ``cudaGetLastError()`` after its launches:
:func:`check` raises when that is not 0. :data:`LAUNCHES` counts the
launches each wrapper made.
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
#: the attention library's flags: the stencils' but ``--fmad=false``, whose
#: bit-identity rule is theirs; the kernels round where the plain core
#: rounds, and contract the rest
ATTENTION_FLAGS = tuple(f for f in NVCC_FLAGS if f != "--fmad=false")
#: csrc/attention.cu's compilation units, compiled in parallel and linked
#: into one library: its C entry points, then each head width's forward
#: and backward kernels
ATTENTION_UNITS = ((),) + tuple(
    (f"-DATTN_HEAD_DIM={d}", f"-DATTN_BACKWARD={bwd}") for d in (64, 128) for bwd in (0, 1))
#: group name -> ({library: its units}, headers, flags); a unit is a source
#: and its extra flags. A library of one unit compiles straight into it; the
#: units of a library of several compile into objects, linked after
GROUPS = {
    "stencils": ({Path(src).stem: ((src, ()),) for src in SOURCES}, HEADERS, NVCC_FLAGS),
    "attention": ({"attention": tuple(("attention.cu", u) for u in ATTENTION_UNITS)}, (),
                  ATTENTION_FLAGS),
}
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
LAUNCHES: Dict[str, int] = {"tiled2d": 0, "tiled3d": 0, "step2d": 0, "step3d": 0,
                            "attn_fwd": 0, "attn_bwd": 0}
#: the stencil kernels' counters, which the LM paths leave at 0
STENCIL_LAUNCHES = ("tiled2d", "tiled3d", "step2d", "step3d")

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_ENTRY_POINTS = {
    "tiled": {
        # x, out, dtype, stencil, s1, s2, t1, t2, n, h, pitch, slot, smem bytes, stream
        "repro_tiled2d": [_P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _LL, _P],
        # x, out, dtype, stencil, s1, s2, s3, t1, t2, t3, n, h, pitch, slot, smem bytes, stream
        "repro_tiled3d": [_P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _LL, _P],
        # dims, threads, smem bytes, out: blocks per SM
        "repro_tiled_blocks_per_sm": [_I, _I, _LL, ctypes.POINTER(ctypes.c_int)],
    },
    "step": {
        # x, out, dtype, stencil, rows, width, h, block_rows, stream
        "repro_step2d": [_P, _P, _I, _I, _I, _I, _I, _I, _P],
        # x, out, dtype, stencil, d, h, w, halo, block_rows, stream
        "repro_step3d": [_P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
    },
    "attention": {
        # the address of an AttnParams, head width, stream
        "repro_attn_fwd": [_P, _I, _P],
        "repro_attn_bwd": [_P, _I, _P],
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


def _build_dir(group: str) -> Path:
    libs, headers, flags = GROUPS[group]
    h = hashlib.sha256()
    for name in sorted({src for units in libs.values() for src, _ in units}) + list(headers):
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    h.update(" ".join(flags).encode())
    h.update(repr(sorted(libs.items())).encode())
    return BUILD_ROOT / h.hexdigest()[:16]


def _group_of(stem: str) -> str:
    return next(g for g, (libs, _, _) in GROUPS.items() if stem in libs)


def _run(cmds):
    """Run ``cmds`` in parallel; returns (return code, output) of each."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    outs = [p.communicate()[0] for p in procs]
    return [(p.returncode, out) for p, out in zip(procs, outs)]


def build(group: str = "stencils") -> Dict[str, dict]:
    """Compile every library of ``group`` (:data:`GROUPS`) that is missing:
    all their units in parallel, then link the libraries of several units.

    Returns ``{stem: {"path", "seconds", "log"}}`` per library; ``log`` is
    nvcc's output (the ``-Xptxas -v`` registers, shared memory and spills
    per kernel) for a library built now, else ``""``. Raises on any failure.
    """
    libs, _, flags = GROUPS[group]
    out_dir = _build_dir(group)
    out_dir.mkdir(parents=True, exist_ok=True)
    report: Dict[str, dict] = {}
    nvcc, pid, t0 = None, os.getpid(), time.perf_counter()
    compiles, links, done = [], [], []  # (stem, command); (stem, command); (tmp, lib, stem)
    for stem, units in libs.items():
        lib = out_dir / f"lib{stem}.so"
        report[stem] = {"path": str(lib), "seconds": 0.0, "log": ""}
        if lib.exists():
            continue
        nvcc = nvcc or find_nvcc()
        tmp = out_dir / f".lib{stem}.{pid}.so"
        if len(units) == 1:
            src, extra = units[0]
            compiles.append((stem, [nvcc, *flags, *extra, "-o", str(tmp), str(CSRC / src)]))
            done.append((tmp, lib, stem))
            continue
        objs = [out_dir / f".{stem}.{i}.{pid}.o" for i in range(len(units))]
        unit_flags = [f for f in flags if f != "-shared"]
        compiles += [(stem, [nvcc, *unit_flags, *extra, "-c", "-o", str(o), str(CSRC / src)])
                     for (src, extra), o in zip(units, objs)]
        links.append((stem, [nvcc, "-shared", "-o", str(tmp), *map(str, objs)]))
        done.append((tmp, lib, stem))
    failed = []
    for step in (compiles, links):
        for (stem, cmd), (rc, log) in zip(step, _run([c for _, c in step])):
            report[stem]["log"] += log
            if rc != 0:
                failed.append(f"{stem}: exited {rc}: {' '.join(cmd)}\n{log}")
        if failed:
            raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    for tmp, lib, stem in done:
        os.replace(tmp, lib)
        report[stem]["seconds"] = time.perf_counter() - t0
    for obj in out_dir.glob(f".*.{pid}.o"):
        obj.unlink()
    return report


def library(stem: str) -> ctypes.CDLL:
    """The loaded library built from ``csrc/<stem>.cu`` (built if needed),
    with ``argtypes``/``restype`` set on every entry point."""
    lib = _LIBS.get(stem)
    if lib is None:
        path = build(_group_of(stem))[stem]["path"]
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
