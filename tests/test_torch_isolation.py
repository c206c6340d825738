"""The port stands alone: no module of ``repro_torch``, and not
``chip_smoke.py``, imports ``jax`` or the JAX package ``repro``; every
module imports with jax blocked; and without a card the entry points
refuse to run unless the CPU is asked for."""

import ast
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"


def _modules():
    return sorted(
        ".".join(p.relative_to(ROOT / "src").with_suffix("").parts).removesuffix(".__init__")
        for p in PKG.rglob("*.py")
    )


def _imported_roots(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    roots = set(_imported_roots(path))
    assert not roots & {"jax", "jaxlib", "repro"}, roots


def test_every_module_imports_with_jax_blocked(subprocess_env):
    mods = _modules()
    assert "repro_torch.kernels.tiled_stencils" in mods and len(mods) > 20
    code = (
        "import sys, importlib\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['repro'] = None\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "assert 'jax' not in [k for k, v in sys.modules.items() if v is not None]\n"
        "print('ok', len(" + repr(mods) + "))\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], env=subprocess_env, capture_output=True, text=True,
        timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


def test_no_device_means_the_card():
    """Without a card, an entry point given no device raises; with one, it
    runs there. Nothing falls back to the CPU unasked."""
    from repro_torch.core.sweep import sweep_cells
    from repro_torch.core.timemodel import MAXWELL_GPU, STENCILS

    args = (STENCILS["heat2d"], MAXWELL_GPU, np.array([[64.0, 64.0, 1.0, 4.0]]),
            [16.0], [128.0], [96.0])
    if torch.cuda.is_available():
        t, i = sweep_cells(*args)
        assert i[0, 0] >= 0
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sweep_cells(*args)


def test_build_locates_sources_in_the_checkout():
    from repro_torch.kernels import _build

    for name in _build.SOURCES + _build.HEADERS:
        assert (_build.CSRC / name).is_file()
    assert _build.BUILD_ROOT == ROOT / "build" / "repro_torch_kernels"
    assert any("sm_90a" in f for f in _build.NVCC_FLAGS) and "--fmad=false" in _build.NVCC_FLAGS
