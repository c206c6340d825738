"""Elastic restarts on the port: a job checkpointed on one mesh shape
resumes on another (the reference's ``tests/test_elastic.py``).

Eight gloo ranks train reduced InternLM2 for 6 steps on a ``(data, model)
= (4, 2)`` mesh with checkpoints every 3 steps, then a new launch resumes
the same job on ``(2, 4)`` and trains to step 10. Every loss is finite;
the state restored onto the new mesh equals the step-6 checkpoint's
leaves bit for bit, and the resumed job writes a checkpoint at step 10.
The checkpoints carry full logical leaves, so they cross between the
packages: the reference restores the mesh-written step-10 checkpoint
(its ``restore_checkpoint`` onto host arrays) to the values the port's
ranks held, and a checkpoint the reference wrote restores onto the
``(2, 4)`` mesh bit for bit.
"""

import json
import os

import jax
import numpy as np

import repro.configs as RC
from _torch_spmd import launch
from repro.checkpoint import restore_checkpoint as r_restore
from repro.checkpoint import save_checkpoint as r_save
from repro.models.model import init_model as r_init_model
from repro_torch.models.convert import tree_leaves


def _reference_state(seed):
    ref = RC.get_arch("internlm2-1.8b").reduced()
    params = jax.device_get(r_init_model(ref, jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed)
    moments = lambda: jax.tree.map(  # noqa: E731
        lambda x: rng.standard_normal(x.shape).astype(np.float32), params)
    return {"opt": {"m": moments(), "step": np.asarray(4, np.int32), "v": moments()},
            "params": params}


def _checkpoint_leaves(directory, step):
    path = os.path.join(directory, f"step_{step:08d}")
    n = json.load(open(os.path.join(path, "manifest.json")))["n_leaves"]
    return [np.load(os.path.join(path, f"leaf_{i:05d}.npy")) for i in range(n)]


def test_elastic_restart_across_mesh_shapes(tmp_path):
    ckpt, ref_ckpt = str(tmp_path / "ckpt"), str(tmp_path / "ref")
    one = launch("elastic", 8, tmp_path, timeout=420, ckpt=ckpt, shape=[4, 2], steps=6)[0]
    assert one["start"] == 0 and one["step"] == 6 and len(one["losses"]) == 6
    assert np.all(np.isfinite(one["losses"]))
    assert sorted(os.listdir(ckpt)) == ["step_00000003", "step_00000006"]

    ref_state = _reference_state(seed=3)
    r_save(ref_ckpt, 4, ref_state)
    two = launch("elastic", 8, tmp_path, timeout=420, ckpt=ckpt, shape=[2, 4], steps=10,
                 restore_from=ref_ckpt)[0]
    assert two["start"] == 6 and two["step"] == 10
    assert len(two["losses"]) == 4 and np.all(np.isfinite(two["losses"]))
    # the restore onto (2, 4) is the step-6 checkpoint, bit for bit
    restored = list(two["restored"].values())
    on_disk = _checkpoint_leaves(ckpt, 6)
    assert len(restored) == len(on_disk)
    for got, want in zip(restored, on_disk):
        np.testing.assert_array_equal(got, want)
    # ... which is the state phase 1 ended with
    for path, want in one["final"].items():
        np.testing.assert_array_equal(two["restored"][path], want)
    # the reference restores the mesh-written step-10 checkpoint
    target = jax.tree.map(np.zeros_like, ref_state)
    tree, step, extra = r_restore(ckpt, target)
    assert step == 10 and extra == {"next_step": 10}
    got = {p: np.asarray(v) for p, v in tree_leaves(tree)}
    assert got.keys() == two["final"].keys()
    for path, want in two["final"].items():
        np.testing.assert_array_equal(got[path], want)
    # ... and the port restores the reference's onto the (2, 4) mesh
    want = {p: np.asarray(v) for p, v in tree_leaves(ref_state)}
    assert two["other"].keys() == want.keys()
    for path, w in want.items():
        np.testing.assert_array_equal(two["other"][path], w)
