"""Which attention core ``_attend`` runs, decided from the inputs alone,
and the ``model.attention.core`` span that records it; on the CPU.

The fused kernels (``kernels/attention.py``) run only on the card; their
card tests are ``tests/test_torch_attention_kernel.py``. Here: every CPU
input keeps the path it had before them (plain, or chunked at
``CHUNKED_THRESHOLD`` tokens), the shapes the kernels take, and the span's
``path`` attribute with the benchmark's reader of it."""

import importlib.util
import math
from pathlib import Path

import pytest
import torch

from repro_torch.kernels import attention as fa
from repro_torch.models import attention as attn
from repro_torch.obs.trace import clear, recorded

ROOT = Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("impl,sq,lk,want", [
    ("auto", 16, 16, "plain"),
    ("auto", 1, 16, "plain"),
    ("auto", attn.CHUNKED_THRESHOLD, attn.CHUNKED_THRESHOLD, "chunked"),
    ("auto", 1, attn.CHUNKED_THRESHOLD, "plain"),
    ("chunked", 16, 16, "chunked"),
    ("plain", attn.CHUNKED_THRESHOLD, attn.CHUNKED_THRESHOLD, "plain"),
])
@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_inputs_off_the_card_keep_their_path(device, impl, sq, lk, want, dtype):
    q = torch.empty(2, sq, 4, 128, dtype=dtype, device=device)
    k = torch.empty(2, lk, 2, 128, dtype=dtype, device=device)
    assert not fa.takes(q, k, k)
    assert attn._core_path(q, k, k, impl) == want


@pytest.mark.parametrize("impl,groups,want", [
    ("auto", (), "fused"),
    ("auto", ("model",), "plain"),  # a split of the head dims sums partial scores
    ("plain", (), "plain"),
    ("chunked", (), "chunked"),
])
def test_a_split_of_the_head_dims_keeps_the_plain_core(monkeypatch, impl, groups, want):
    """Where the kernels would take the rank's tensors, ``groups`` (a mesh's
    split of the head dims) and ``impl`` alone decide."""
    monkeypatch.setattr(fa, "takes", lambda q, k, v: True)
    q = torch.empty(2, 16, 4, 128, dtype=torch.bfloat16)
    k = torch.empty(2, 16, 2, 128, dtype=torch.bfloat16)
    assert attn._core_path(q, k, k, impl, groups) == want


@pytest.mark.parametrize("q,k,v,ok", [
    ((2, 4096, 16, 128), (2, 4096, 8, 128), (2, 4096, 8, 128), True),  # training
    ((64, 512, 48, 128), (64, 512, 8, 128), (64, 512, 8, 128), True),  # Mixtral prefill
    ((1, 1030, 4, 64), (1, 1030, 2, 64), (1, 1030, 2, 64), True),
    ((2, 7, 4, 128), (2, 300, 4, 128), (2, 300, 4, 128), True),  # a chunk against a cache
    ((2, 1, 16, 128), (2, 4096, 8, 128), (2, 4096, 8, 128), False),  # decode
    ((2, 64, 16, 192), (2, 64, 16, 192), (2, 64, 16, 128), False),  # MLA's heads
    ((2, 64, 4, 96), (2, 64, 2, 96), (2, 64, 2, 96), False),
    ((2, 64, 4, 32), (2, 64, 2, 32), (2, 64, 2, 32), False),
    ((2, 64, 6, 128), (2, 64, 4, 128), (2, 64, 4, 128), False),  # H not a multiple of KH
    ((2, 64, 4, 128), (1, 64, 2, 128), (1, 64, 2, 128), False),
    ((2, 64, 4, 128), (2, 64, 2, 128), (2, 63, 2, 128), False),
    ((64, 4, 128), (64, 2, 128), (64, 2, 128), False),
])
def test_shapes_the_kernels_take(q, k, v, ok):
    assert fa.fits(q, k, v) is ok


def test_the_kernels_refuse_cpu_tensors():
    q = torch.zeros(1, 64, 4, 128, dtype=torch.bfloat16)
    k = torch.zeros(1, 64, 2, 128, dtype=torch.bfloat16)
    pos = torch.arange(64)[None]
    with pytest.raises(ValueError, match="fused attention takes"):
        fa.fused_attention(q, k, k, pos, pos, True, 0, 1 / math.sqrt(128))


def _metric():
    path = ROOT / "h100bench" / "metrics" / "attn_fused_pct.train.py"
    spec = importlib.util.spec_from_file_location("attn_fused_pct_train", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


@pytest.mark.parametrize("impl,want", [("auto", "plain"), ("chunked", "chunked"), ("plain", "plain")])
def test_the_core_span_names_its_path(impl, want):
    g = torch.Generator().manual_seed(0)
    q = torch.randn(1, 24, 4, 16, generator=g)
    k = torch.randn(1, 24, 2, 16, generator=g)
    pos = torch.arange(24)[None]
    clear()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        out = attn._attend(q, k, k, pos, pos, "causal", 0, impl)
    spans = [s for s in recorded() if s["name"] == "model.attention.core"]
    clear()
    assert out.shape == (1, 24, 4, 16)
    assert len(spans) == 1 and spans[0]["attrs"] == {"path": want}
    assert spans[0]["device_ms"] is None


def test_the_fused_share_reads_the_spans():
    read = _metric()
    clear()
    assert read({}) is None
    pos = torch.arange(8)[None]
    q = torch.zeros(1, 8, 2, 16)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        attn._attend(q, q, q, pos, pos, "causal", 0, "auto")
    assert read({}) == 0.0
    rec = recorded()
    clear()
    assert [s["attrs"]["path"] for s in rec if s["name"] == "model.attention.core"] == ["plain"]


def test_the_attention_library_builds_apart_from_the_stencils():
    """The stencil cell's build never compiles attention: two groups, each
    with its own flags; attention's without the stencils' ``--fmad=false``."""
    from repro_torch.kernels import _build

    stencils, _, stencil_flags = _build.GROUPS["stencils"]
    libs, _, flags = _build.GROUPS["attention"]
    assert set(stencils) == {"tiled", "step"} and set(libs) == {"attention"}
    assert _build._group_of("attention") == "attention" and _build._group_of("tiled") == "stencils"
    assert "--fmad=false" in stencil_flags and "--fmad=false" not in flags
    assert any("sm_90a" in f for f in flags)
    assert _build._build_dir("attention") != _build._build_dir("stencils")
    units = libs["attention"]
    assert {src for src, _ in units} == {"attention.cu"} and len(units) == 5
    assert (_build.CSRC / "attention.cu").is_file()
