"""The port's checkpoints (``repro_torch.checkpoint``) against the JAX
package's: the reference's ``tests/test_checkpoint.py`` on the port
(atomic write, roundtrip, pruning, async, crash-consistency, restore onto
a device), then the two packages on one on-disk format: each restores the
other's f32 train state leaf for leaf (and their leaf files are the same
bytes), a bf16 train state round-trips bit for bit in the port, a bf16
checkpoint the reference writes restores in the port bit for bit (the
reference's own restore hands its bf16 leaves back as ``|V2`` arrays),
and the async snapshot is complete before ``save`` returns."""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import repro.configs as RC
from repro.checkpoint import restore_checkpoint as r_restore_checkpoint
from repro.checkpoint import save_checkpoint as r_save_checkpoint
from repro.models.model import init_model as r_init_model
from repro_torch.checkpoint import (
    AsyncCheckpointer,
    latest_step,
    restore_checkpoint,
    save_checkpoint,
)
from repro_torch.configs import get_arch
from repro_torch.models.convert import (
    train_state_from_reference,
    train_state_to_reference,
    tree_leaves,
)
from repro_torch.train import TrainConfig, init_train_state


def _tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {
        "a": torch.randn((4, 8), generator=g),
        "nested": {"b": torch.arange(10, dtype=torch.int32), "c": torch.tensor(3.5)},
    }


def _leaves(tree):
    return [np.asarray(v) for _, v in tree_leaves(tree)]


def test_roundtrip(tmp_path):
    t = _tree()
    save_checkpoint(str(tmp_path), 7, t, extra={"next_step": 7})
    restored, step, extra = restore_checkpoint(str(tmp_path), t)
    assert step == 7 and extra["next_step"] == 7
    for a, b in zip(_leaves(t), _leaves(restored)):
        np.testing.assert_array_equal(a, b)


def test_latest_and_multiple(tmp_path):
    for s in (5, 10, 15):
        save_checkpoint(str(tmp_path), s, _tree(s))
    assert latest_step(str(tmp_path)) == 15
    _, step, _ = restore_checkpoint(str(tmp_path), _tree(), step=10)
    assert step == 10


def test_tmp_dirs_are_invisible(tmp_path):
    save_checkpoint(str(tmp_path), 1, _tree())
    os.makedirs(tmp_path / "step_00000099.tmp")  # simulated dead write
    assert latest_step(str(tmp_path)) == 1


def test_structure_mismatch_raises(tmp_path):
    save_checkpoint(str(tmp_path), 1, _tree())
    with pytest.raises(ValueError):
        restore_checkpoint(str(tmp_path), {"only": torch.zeros(3)})


def test_async_checkpointer_and_prune(tmp_path):
    ck = AsyncCheckpointer(str(tmp_path), keep=2)
    for s in (1, 2, 3, 4):
        ck.save(s, _tree(s))
    ck.wait()
    steps = sorted(
        int(n.split("_")[1]) for n in os.listdir(tmp_path) if n.startswith("step_")
    )
    assert steps == [3, 4]
    restored, step, _ = restore_checkpoint(str(tmp_path), _tree())
    assert step == 4
    for a, b in zip(_leaves(_tree(4)), _leaves(restored)):
        np.testing.assert_array_equal(a, b)


def test_restore_onto_a_device(tmp_path):
    """The reference's ``shardings=`` restore: here ``device=``."""
    t = _tree()
    save_checkpoint(str(tmp_path), 3, t)
    restored, _, _ = restore_checkpoint(str(tmp_path), t, device="cpu")
    assert all(isinstance(v, torch.Tensor) and v.device.type == "cpu"
               for _, v in tree_leaves(restored))
    restored, _, _ = restore_checkpoint(str(tmp_path), t, device="meta")
    assert all(v.device.type == "meta" for _, v in tree_leaves(restored))


def test_async_snapshot_is_complete_before_save_returns(tmp_path):
    """The train step updates the state in place right after ``save``:
    the checkpoint must hold the values at ``save`` time."""
    t = _tree()
    want = [a.copy() for a in _leaves(t)]
    ck = AsyncCheckpointer(str(tmp_path), keep=1)
    ck.save(1, t)
    with torch.no_grad():
        t["a"].add_(1.0)
        t["nested"]["b"].mul_(0)
    ck.wait()
    restored, _, _ = restore_checkpoint(str(tmp_path), t)
    for a, b in zip(want, _leaves(restored)):
        np.testing.assert_array_equal(a, b)


def test_async_error_surfaces_on_wait(tmp_path):
    blocker = tmp_path / "file"
    blocker.write_text("not a directory")
    ck = AsyncCheckpointer(str(blocker), keep=1)
    ck.save(1, _tree())
    with pytest.raises(OSError):
        ck.wait()


# ---------------------------------------------------------------------------
# train states across the two packages
# ---------------------------------------------------------------------------
def _reference_state(name, seed=0, compress=False):
    ref = RC.get_arch(name).reduced()
    params = jax.device_get(r_init_model(ref, jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed + 1)
    draw = lambda t: jax.tree.map(  # noqa: E731
        lambda x: rng.standard_normal(x.shape).astype(np.float32), t)
    state = {"params": params,
             "opt": {"m": draw(params), "v": draw(params), "step": np.array(3, np.int32)}}
    if compress:
        state["comp"] = draw(params)
    return state


def _assert_same_tree(got, want):
    got, want = dict(tree_leaves(got)), dict(tree_leaves(want))
    assert got.keys() == want.keys()
    for path in want:
        g, w = np.asarray(got[path]), np.asarray(want[path])
        assert g.dtype == w.dtype and g.shape == w.shape, path
        assert g.tobytes() == w.tobytes(), path


@pytest.mark.parametrize("name,compress", [("internlm2-1.8b", False), ("jamba-v0.1-52b", True),
                                           ("whisper-medium", False)])
def test_port_restores_the_references_train_state(tmp_path, name, compress):
    ref_state = _reference_state(name, compress=compress)
    r_save_checkpoint(str(tmp_path), 3, ref_state, extra={"next_step": 3})
    cfg = get_arch(name).reduced()
    target = init_train_state(cfg, TrainConfig(compress_grads=compress), device="cpu")
    restored, step, extra = restore_checkpoint(str(tmp_path), target)
    assert restored is target and step == 3 and extra == {"next_step": 3}
    _assert_same_tree(train_state_to_reference(restored), ref_state)


@pytest.mark.parametrize("name,compress", [("internlm2-1.8b", True), ("deepseek-v3-671b", False),
                                           ("qwen2-vl-2b", False)])
def test_reference_restores_the_ports_train_state(tmp_path, name, compress):
    ref_state = _reference_state(name, seed=2, compress=compress)
    port = train_state_from_reference(get_arch(name).reduced(), ref_state, device="cpu")
    save_checkpoint(str(tmp_path / "port"), 5, port, extra={"next_step": 5})
    target = _reference_state(name, seed=9, compress=compress)  # other values, same tree
    restored, step, extra = r_restore_checkpoint(str(tmp_path / "port"), target)
    assert step == 5 and extra == {"next_step": 5}
    _assert_same_tree(jax.device_get(restored), ref_state)
    # the same leaf files as the reference writes for the same state
    r_save_checkpoint(str(tmp_path / "ref"), 5, ref_state, extra={"next_step": 5})
    port_dir, ref_dir = tmp_path / "port" / "step_00000005", tmp_path / "ref" / "step_00000005"
    leaves = sorted(p.name for p in ref_dir.iterdir() if p.name.startswith("leaf_"))
    assert leaves == sorted(p.name for p in port_dir.iterdir() if p.name.startswith("leaf_"))
    for leaf in leaves:
        assert (port_dir / leaf).read_bytes() == (ref_dir / leaf).read_bytes(), leaf
    mp, mr = (json.loads((d / "manifest.json").read_text()) for d in (port_dir, ref_dir))
    for key in ("step", "n_leaves", "extra", "dtypes", "shapes"):
        assert mp[key] == mr[key], key


def _bf16_state(seed=0):
    cfg = get_arch("llama3-8b").reduced()
    state = init_train_state(cfg, TrainConfig(), device="cpu", seed=seed)
    state["params"].to(torch.bfloat16)
    with torch.no_grad():
        for t in state["opt"]["m"].values():
            t.normal_(generator=torch.Generator().manual_seed(seed))
        state["opt"]["step"].fill_(11)
    return cfg, state


def test_bf16_train_state_roundtrips_bit_for_bit(tmp_path):
    cfg, state = _bf16_state(0)
    assert state["params"].embed.dtype == torch.bfloat16
    want = {k: v.detach().clone() for k, v in state["params"].named_parameters()}
    ck = AsyncCheckpointer(str(tmp_path), keep=1)
    ck.save(11, state, {"next_step": 11})
    ck.wait()
    manifest = json.loads((tmp_path / "step_00000011" / "manifest.json").read_text())
    assert "bfloat16" in manifest["dtypes"] and "float32" in manifest["dtypes"]
    _, other = _bf16_state(1)
    restored, step, _ = restore_checkpoint(str(tmp_path), other)
    assert step == 11 and int(restored["opt"]["step"]) == 11
    for k, p in restored["params"].named_parameters():
        assert p.dtype == torch.bfloat16
        assert torch.equal(p.view(torch.int16), want[k].view(torch.int16)), k
    for k, t in restored["opt"]["m"].items():
        assert torch.equal(t, state["opt"]["m"][k]), k


def test_bf16_leaf_file_is_the_references(tmp_path):
    """A bf16 leaf is the bytes ``np.save`` writes for the reference's
    ml_dtypes array (header ``<V2``), and the port reads the reference's
    file back bit for bit, where the reference's restore gives ``|V2``."""
    x = np.random.default_rng(0).standard_normal((3, 5)).astype(ml_dtypes.bfloat16)
    r_save_checkpoint(str(tmp_path / "ref"), 1, {"w": jnp.asarray(x)})
    save_checkpoint(str(tmp_path / "port"), 1,
                    {"w": torch.from_numpy(x.view(np.uint16)).view(torch.bfloat16)})
    leaf = "step_00000001/leaf_00000.npy"
    assert (tmp_path / "port" / leaf).read_bytes() == (tmp_path / "ref" / leaf).read_bytes()
    got, _, _ = restore_checkpoint(str(tmp_path / "ref"), {"w": torch.zeros(3, 5)})
    assert got["w"].dtype == torch.bfloat16
    assert np.array_equal(got["w"].view(torch.int16).numpy().view(np.uint16), x.view(np.uint16))
    want, _, _ = r_restore_checkpoint(str(tmp_path / "ref"), {"w": jnp.zeros((3, 5))})
    assert want["w"].dtype.str == "|V2"  # the reference fault the port does not share


def test_train_state_leaf_shapes_must_fit(tmp_path):
    cfg = get_arch("llama3-8b").reduced()
    save_checkpoint(str(tmp_path), 1, init_train_state(cfg, TrainConfig(), device="cpu"))
    wider = dataclasses.replace(cfg, d_ff=cfg.d_ff * 2)
    with pytest.raises(ValueError, match="does not fit"):
        restore_checkpoint(str(tmp_path), init_train_state(wider, TrainConfig(), device="cpu"))
