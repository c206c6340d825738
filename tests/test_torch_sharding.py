"""The port's partition rules (``repro_torch.sharding.partition``) against
the JAX package's, leaf for leaf.

For all ten full-size architectures on the production mesh shapes
``(16, 16)`` and ``(2, 16, 16)`` (``MeshShape``: no ranks needed), fsdp on
and off, the port's ``param_specs``, ``opt_state_specs``, ``cache_specs``
and ``batch_specs`` equal the reference's on ``jax.eval_shape`` trees: a
port spec with a ``None`` prepended for a leaf stacked over a segment's
repeats is the reference's ``PartitionSpec``. The port's model and caches
are built on the meta device. Also the reference's own cases in
``tests/test_sharding.py`` (divisibility, whisper's odd vocab, llama's
vocab, EP against TP within experts, the long-context cache fallback, the
tiny-batch replicate), and ``to_placements`` / ``to_spec`` round trips.
"""

import math

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import repro.configs as RC
from repro.models.model import init_model as r_init_model
from repro.serve.kvcache import init_caches as r_init_caches
from repro.sharding import partition as RP
from repro_torch.configs import get_arch, list_archs
from repro_torch.launch.mesh import MULTI_POD, SINGLE_POD, MeshShape, production_shape
from repro_torch.models import Model
from repro_torch.models.convert import reference_layout
from repro_torch.serve.kvcache import init_caches
from repro_torch.sharding import (
    batch_specs,
    cache_specs,
    opt_state_specs,
    param_specs,
    to_placements,
    to_spec,
)

ARCHS = list_archs()
MESHES = {"single": production_shape(), "multi": production_shape(multi_pod=True)}


def _fake_mesh(shape: MeshShape):
    """The reference test's abstract mesh: names and a device array."""
    devs = np.array([jax.devices()[0]] * shape.size).reshape(shape.sizes)

    class _M:
        axis_names = shape.axis_names
        devices = devs

    return _M()


_MODELS, _REF_SHAPES = {}, {}


def _model(name):
    if name not in _MODELS:
        _MODELS[name] = Model(get_arch(name), device="meta")
    return _MODELS[name]


def _ref_shapes(name):
    if name not in _REF_SHAPES:
        ref = RC.get_arch(name)
        _REF_SHAPES[name] = jax.eval_shape(lambda: r_init_model(ref, jax.random.PRNGKey(0)))
    return _REF_SHAPES[name]


def _spec_leaves(tree):
    """(path, PartitionSpec) leaves of a reference spec tree."""
    return [(tuple(getattr(k, "key", getattr(k, "idx", None)) for k in path), s)
            for path, s in jax.tree_util.tree_flatten_with_path(
                tree, is_leaf=lambda x: isinstance(x, P))[0]]


def _check_against_reference(specs, ref_tree, model):
    """``specs(by_path)`` against the reference's tree: the stacked specs
    are the reference's, and each layer's spec is its row's."""
    want = {p: tuple(s) for p, s in _spec_leaves(ref_tree)}
    got, per_layer = specs(True), specs(False)
    assert got == want
    for path, names, stacked in reference_layout(model):
        for name in names:
            assert per_layer[name] == (want[path][1:] if stacked else want[path]), name


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("fsdp", [False, True])
@pytest.mark.parametrize("name", ARCHS)
def test_param_and_opt_specs_equal_the_references(name, fsdp, mesh):
    shape = MESHES[mesh]
    cfg, ref = get_arch(name), RC.get_arch(name)
    model, shapes, fake = _model(name), _ref_shapes(name), _fake_mesh(shape)
    _check_against_reference(lambda by_path: param_specs(cfg, model, shape, fsdp, by_path),
                             RP.param_specs(ref, shapes, fake, fsdp=fsdp), model)
    _check_against_reference(lambda by_path: opt_state_specs(cfg, model, shape, fsdp, by_path),
                             RP.opt_state_specs(ref, shapes, fake, fsdp=fsdp), model)


def _port_cache_leaves(caches):
    """(reference path, port spec or tensor) of the port's cache layout,
    keyed as the reference's tree (per layer, not stacked)."""
    for i, layer in enumerate(caches["stack"]):
        for part, leaves in (layer or {}).items():
            for k, v in leaves.items():
                yield (i, part, k), v
    if "enc_out" in caches:
        yield ("enc_out",), caches["enc_out"]


@pytest.mark.parametrize("batch", [256, 1])
@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("name", ARCHS)
def test_cache_and_batch_specs_equal_the_references(name, mesh, batch):
    from repro_torch.models.transformer import layer_index, segments

    shape = MESHES[mesh]
    cfg, ref = get_arch(name), RC.get_arch(name)
    fake = _fake_mesh(shape)
    enc = cfg.enc_dec
    r_caches = jax.eval_shape(
        lambda: r_init_caches(ref, batch, 2048, dtype="bfloat16", include_enc=enc))
    want = {p: tuple(s) for p, s in _spec_leaves(RP.cache_specs(ref, r_caches, fake, batch))}
    caches = init_caches(cfg, batch, 2048, dtype=torch.bfloat16, include_enc=enc, device="meta")
    got = dict(_port_cache_leaves(cache_specs(cfg, caches, shape, batch_size=batch)))
    segs = segments(cfg)
    where = {layer_index(segs, si, r, j): (si, j)
             for si, (pattern, reps) in enumerate(segs)
             for r in range(reps) for j in range(len(pattern))}
    for key, spec in got.items():
        if key == ("enc_out",):
            assert spec == want[("enc_out",)]
            continue
        si, j = where[key[0]]
        assert (None,) + spec == want[("stack", f"seg{si}", j) + key[1:]], key
    assert len(got) > 0
    r_batch = RP.batch_specs(ref, fake, batch_size=batch)
    assert batch_specs(cfg, shape, batch_size=batch) == {k: tuple(v) for k, v in r_batch.items()}


# ---- the reference's tests/test_sharding.py cases on the port -------------
def _check_divisible(specs: dict, shapes: dict, mesh: MeshShape):
    sizes = dict(zip(mesh.axis_names, mesh.sizes))
    for name, spec in specs.items():
        shape = shapes[name]
        assert len(spec) == len(shape), name
        used = []
        for dim, entry in zip(shape, spec):
            if entry is None:
                continue
            axes = entry if isinstance(entry, tuple) else (entry,)
            used += axes
            assert dim % math.prod(sizes[a] for a in axes) == 0, (name, spec, shape)
        assert len(used) == len(set(used)), spec


@pytest.mark.parametrize("fsdp", [False, True])
@pytest.mark.parametrize("name", ARCHS)
def test_full_config_param_specs_are_valid(name, fsdp):
    cfg, model = get_arch(name), _model(name)
    shapes = {n: tuple(p.shape) for n, p in model.named_parameters()}
    mesh = MeshShape(("data", "model"), SINGLE_POD)
    _check_divisible(param_specs(cfg, model, mesh, fsdp=fsdp), shapes, mesh)
    _check_divisible(opt_state_specs(cfg, model, mesh, fsdp=fsdp), shapes, mesh)
    multi = MeshShape(("pod", "data", "model"), MULTI_POD)
    _check_divisible(param_specs(cfg, model, multi, fsdp=True), shapes, multi)


def test_whisper_odd_vocab_falls_back():
    """51865 doesn't divide 16: the embedding shards d_model instead."""
    cfg = get_arch("whisper-medium")
    assert param_specs(cfg, _model("whisper-medium"), production_shape())["embed"] == (None, "model")


def test_llama_vocab_shards():
    cfg = get_arch("llama3-8b")
    assert param_specs(cfg, _model("llama3-8b"), production_shape())["embed"] == ("model", None)


def test_expert_parallel_vs_tp_within():
    mesh = production_shape()
    # deepseek: 256 experts % 16 == 0 -> EP on the expert dim
    ds = param_specs(get_arch("deepseek-v3-671b"), _model("deepseek-v3-671b"), mesh)
    ups = [s for n, s in ds.items() if n.endswith("ffn.experts.up")]
    assert ups and all(s[-3] == "model" for s in ups)
    # mixtral: 8 experts % 16 != 0 -> TP within experts (hidden dim)
    mx = param_specs(get_arch("mixtral-8x22b"), _model("mixtral-8x22b"), mesh)
    ups = [s for n, s in mx.items() if n.endswith("ffn.experts.up")]
    assert ups and all(s[-1] == "model" and s[-3] is None for s in ups)


def test_cache_specs_long_context_fallback():
    """B=1 cannot shard over data: the cache length dim takes it instead."""
    cfg = get_arch("jamba-v0.1-52b")
    mesh = production_shape()
    caches = init_caches(cfg, 1, 2048, dtype=torch.bfloat16, device="meta")
    specs = cache_specs(cfg, caches, mesh, batch_size=1)
    k_specs = [layer["mixer"]["k"] for layer in specs["stack"] if "k" in layer.get("mixer", {})]
    assert k_specs and all("data" in s for s in k_specs)
    shapes, flat = {}, {}
    for key, t in _port_cache_leaves(caches):
        shapes[key], flat[key] = tuple(t.shape), dict(_port_cache_leaves(specs))[key]
    _check_divisible(flat, shapes, mesh)


def test_batch_specs_replicate_tiny_batch():
    cfg = get_arch("llama3-8b")
    mesh = production_shape()
    assert batch_specs(cfg, mesh, batch_size=256)["tokens"] == ("data", None)
    assert batch_specs(cfg, mesh, batch_size=1)["tokens"] == (None, None)


# ---- specs <-> placements ----------------------------------------------------
@pytest.mark.parametrize("spec,ndim", [
    (("model", None), 2), ((None, "model"), 2), ((None, None), 2),
    ((("pod", "data"), None, "model"), 3), (("data", "model"), 2),
    ((None, ("pod", "data")), 2), (("pod", None, ("data", "model")), 3), ((), 0),
])
def test_to_placements_round_trips(spec, ndim):
    from torch.distributed.tensor import Replicate, Shard

    mesh = production_shape(multi_pod=True)
    pl = to_placements(spec, mesh)
    assert len(pl) == 3
    for axis, p in zip(mesh.axis_names, pl):
        dims = [d for d, e in enumerate(spec) if e is not None
                and axis in (e if isinstance(e, tuple) else (e,))]
        assert p == (Shard(dims[0]) if dims else Replicate())
    assert to_spec(pl, mesh, ndim) == spec


def test_to_placements_refuses_what_dtensor_cannot_hold():
    mesh = production_shape(multi_pod=True)
    with pytest.raises(ValueError, match="order"):
        to_placements((("data", "pod"), None), mesh)
    with pytest.raises(ValueError, match="twice"):
        to_placements(("data", "data"), mesh)
    with pytest.raises(ValueError, match="lacks"):
        to_placements(("stage", None), production_shape())


def test_axes_of_size_one_replicate():
    """A size-1 axis shards nothing: its mesh dim is Replicate, so a
    1 x 1 mesh places every tensor whole."""
    from torch.distributed.tensor import Replicate, Shard

    one = MeshShape(("data", "model"), (1, 1))
    assert to_placements(("data", "model"), one) == [Replicate(), Replicate()]
    half = MeshShape(("data", "model"), (1, 4))
    assert to_placements(("data", "model"), half) == [Replicate(), Shard(1)]
