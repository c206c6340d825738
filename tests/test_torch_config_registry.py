"""The port's config registry (``repro_torch.configs``), against the JAX
package's.

* The reference's own registry tests (``tests/test_config_registry.py``),
  run on the port: deterministic auto-discovery of every config module,
  ``get``/``list_archs``, duplicate-name rejection, re-import idempotence.
* Every registered architecture, and its ``reduced()`` variant, has the
  reference's field values; so do the shape table and ``layer_kinds``.
* The two registries are separate dicts that coexist in one process.
"""

import dataclasses
import importlib
import pkgutil

import pytest

import repro.configs as R
import repro_torch.configs as configs_pkg
from repro_torch.configs import ARCHS, SHAPES, ArchConfig, get, get_arch, list_archs, register

#: every named architecture the repo carries
EXPECTED = (
    "deepseek-v3-671b",
    "gemma-7b",
    "internlm2-1.8b",
    "jamba-v0.1-52b",
    "llama3-8b",
    "mamba2-780m",
    "minitron-4b",
    "mixtral-8x22b",
    "qwen2-vl-2b",
    "whisper-medium",
)


def test_listing_is_sorted_deterministic_and_complete():
    names = list_archs()
    assert names == tuple(sorted(names))
    assert names == EXPECTED
    assert list_archs() == names


def test_get_resolves_every_listed_arch():
    for name in list_archs():
        cfg = get(name)
        assert isinstance(cfg, ArchConfig)
        assert cfg.name == name
        assert get_arch(name) is cfg


def test_get_unknown_name_is_a_keyerror_listing_known():
    with pytest.raises(KeyError, match="unknown arch"):
        get("llama3-8b-typo")


def test_every_config_module_registers_exactly_its_archs():
    modules = [
        m.name
        for m in pkgutil.iter_modules(configs_pkg.__path__)
        if not m.name.startswith("_") and m.name != "base"
    ]
    for name in modules:
        importlib.import_module(f"repro_torch.configs.{name}")
    assert set(ARCHS) == set(EXPECTED)


def test_duplicate_registration_rejected():
    cfg = get("llama3-8b")
    with pytest.raises(ValueError, match="duplicate"):
        register(cfg)
    assert get("llama3-8b") is cfg


def test_reimport_is_idempotent():
    importlib.reload(importlib.import_module("repro_torch.configs._register_all"))
    assert set(ARCHS) == set(EXPECTED)


@pytest.mark.parametrize("name", EXPECTED)
def test_configs_are_the_references(name):
    cfg, ref = get_arch(name), R.get_arch(name)
    assert cfg is not ref and type(cfg) is not type(ref)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(ref)
    assert dataclasses.asdict(cfg.reduced()) == dataclasses.asdict(ref.reduced())
    assert cfg.layer_kinds() == ref.layer_kinds()
    if cfg.n_heads:
        assert cfg.head_dim_ == ref.head_dim_


def test_registries_coexist_and_shapes_match():
    assert ARCHS is not R.ARCHS
    assert set(R.list_archs()) == set(list_archs())
    assert {k: dataclasses.asdict(v) for k, v in SHAPES.items()} == {
        k: dataclasses.asdict(v) for k, v in R.SHAPES.items()
    }
    assert SHAPES["train_4k"].tokens == R.SHAPES["train_4k"].tokens
