"""The port's train step on a ``(data, model) = (2, 2)`` mesh of gloo
ranks against the JAX package's step on a ``(2, 2)`` mesh of forced host
devices, and against its own single-device step.

One launch of four CPU ranks runs one step of each case from the seed-0
state (``init_train_state(cfg, tcfg, mesh)``: parameters placed by
``param_specs``, moments by ``opt_state_specs``) on a batch placed by
``batch_specs``: InternLM2 (the reference's elastic arch) with fsdp off
and on, the second with int8 compression; Mixtral with fsdp off and on
(its 4 reduced experts shard over ``model`` = 2: expert parallelism);
Jamba, the hybrid of attention, Mamba-2 and MoE layers; all with two
microbatches. The reference runs the same steps from the same weights
and batch on its mesh, in a subprocess beside the ranks, and the same
steps run on one CPU device here. Against both, the metrics agree within
1e-5 relative and every element of the state after the
step (params, moments, residuals, gathered to full leaves) within PR
17's tolerances (rtol 2e-4, atol 2e-5), but at the step's two
discontinuities (``tests/test_torch_train_step.py``): a gradient at the
f32 noise floor, and an int8 rounding tie; those are counted and stay
below 0.1% of the state. A launch of four ranks on ``(1, 4)`` runs
InternLM2 and Jamba, whose 2 reduced kv heads are fewer than the
``model`` ranks (each rank slices the kv head its q head reads), against
the reference's step on ``(1, 4)`` and the single-device step; a launch
of eight ranks runs InternLM2 on ``(1, 8)``, whose ``model`` axis its 4
q heads do not divide either, against the single-device step. And the
attention core alone on ``(1, 4)``, through every branch of its split
over ``model`` (kv heads sliced, matched, split by head dims; q heads
uneven), against the plain core with gradients.
"""

import textwrap

import numpy as np
import pytest
import torch

from _torch_spmd import launch, start_reference
from repro_torch.configs import get_arch
from repro_torch.configs.base import ShapeSpec
from repro_torch.data import DataConfig
from repro_torch.data.pipeline import make_batch
from repro_torch.models.convert import train_state_to_reference, tree_leaves
from repro_torch.optim import AdamWConfig
from repro_torch.sharding import param_specs
from repro_torch.launch.mesh import MeshShape
from repro_torch.train import TrainConfig, init_train_state, make_train_step

SEQ, BATCH = 32, 4
METRIC_RTOL = 1e-5
STATE_TOL = dict(rtol=2e-4, atol=2e-5)
LR = 1.5e-4  # the first step's learning rate (warmup 2)

#: (arch, fsdp, microbatches, compress, remat)
RUNS_2X2 = [
    ("internlm2-1.8b", False, 2, False, "dots"),
    ("internlm2-1.8b", True, 2, True, "dots"),
    ("mixtral-8x22b", False, 2, False, "dots"),
    ("mixtral-8x22b", True, 2, False, "dots"),
    ("jamba-v0.1-52b", False, 2, False, "dots"),
]

#: the runs on (1, 4): 4 q heads, 2 kv heads on 4 model ranks
RUNS_1X4 = [
    ("internlm2-1.8b", False, 2, False, "dots"),
    ("jamba-v0.1-52b", False, 2, False, "dots"),
]


#: the JAX package's step on a mesh of four forced host devices (the
#: payload's shape), from each run's seed-0 state and batch as the port
#: draws them
REF = textwrap.dedent(
    """
    import pickle, sys
    import jax, numpy as np
    from jax.sharding import Mesh
    import repro.configs as RC
    from repro.optim import AdamWConfig
    from repro.train import TrainConfig, make_train_step

    payload = pickle.load(open(sys.argv[1], "rb"))
    mesh = Mesh(np.array(jax.devices()[:4]).reshape(payload["shape"]), ("data", "model"))
    out = []
    for run in payload["runs"]:
        arch, fsdp, micro, compress, remat = run["run"]
        tcfg = TrainConfig(microbatches=micro, compress_grads=compress, fsdp=fsdp, remat=remat,
                           opt=AdamWConfig(warmup_steps=2, total_steps=10))
        state, metrics = make_train_step(RC.get_arch(arch).reduced(), tcfg, mesh)(
            run["state"], run["batch"])
        out.append({"state": jax.device_get(state),
                    "metrics": {k: float(v) for k, v in metrics.items()}})
    pickle.dump(out, open(sys.argv[2], "wb"))
    """
)


def _tcfg(fsdp, micro, compress, remat):
    return TrainConfig(microbatches=micro, compress_grads=compress, fsdp=fsdp, remat=remat,
                       opt=AdamWConfig(warmup_steps=2, total_steps=10))


def _start(arch, fsdp, micro, compress, remat):
    """(the seed-0 state as the reference's tree, the batch as numpy)."""
    cfg = get_arch(arch).reduced()
    state = init_train_state(cfg, _tcfg(fsdp, micro, compress, remat), "cpu", seed=0)
    batch = make_batch(cfg, ShapeSpec("tiny", SEQ, BATCH, "train"), DataConfig(), 0, device="cpu")
    return train_state_to_reference(state), {k: v.numpy() for k, v in batch.items()}


def _single(arch, fsdp, micro, compress, remat):
    cfg = get_arch(arch).reduced()
    tcfg = _tcfg(fsdp, micro, compress, remat)
    state = init_train_state(cfg, tcfg, "cpu", seed=0)
    batch = make_batch(cfg, ShapeSpec("tiny", SEQ, BATCH, "train"), DataConfig(), 0, device="cpu")
    state, metrics = make_train_step(cfg, tcfg, "cpu")(state, batch)
    return dict(tree_leaves(train_state_to_reference(state))), {k: float(v) for k, v in metrics.items()}


def _assert_matches(got, got_metrics, want, want_metrics):
    assert got_metrics.keys() == want_metrics.keys()
    for k, w in want_metrics.items():
        np.testing.assert_allclose(got_metrics[k], w, rtol=METRIC_RTOL,
                                   atol=1e-7 if k == "aux_loss" else 0, err_msg=k)
    assert got.keys() == want.keys()
    n_total = n_edge = 0
    for path, w in want.items():
        g = got[path]
        assert g.shape == w.shape and g.dtype == w.dtype, path
        ok = np.isclose(g, w, **STATE_TOL)
        edge = np.zeros_like(ok)
        m_got, m_want = got.get(("opt", "m") + path[1:]), want.get(("opt", "m") + path[1:])
        if path[0] == "params":
            noise = (np.sign(m_got) != np.sign(m_want)) | (np.abs(m_want) < 0.1 * 1e-6)
            edge = noise & (np.abs(g - w) <= 2 * LR * (1 + 0.1 * np.abs(w)) + STATE_TOL["atol"])
        elif path[0] == "comp":
            clip = min(1.0, 1.0 / want_metrics["grad_norm"])
            bin_ = np.abs(m_want).max() / (0.1 * clip * 127)
            edge = np.isclose(np.abs(g - w), bin_, rtol=1e-3) & np.isclose(np.abs(w), bin_ / 2,
                                                                           rtol=1e-2)
        edge &= ~ok
        n_total, n_edge = n_total + w.size, n_edge + int(edge.sum())
        np.testing.assert_allclose(np.where(edge, w, g), w, **STATE_TOL, err_msg=str(path))
    print(f"{n_edge} of {n_total} state elements at a gradient noise floor or a rounding tie")
    assert n_edge <= 1e-3 * n_total


def _against_reference_and_single(runs, shape, tmp_path, subprocess_env):
    """One launch of ``runs`` on a four-rank ``shape`` mesh, held to the
    reference's steps on the same mesh shape and to the single-device
    steps; returns the launch's results."""
    payload = {"shape": list(shape), "runs": []}
    for run in runs:
        state, batch = _start(*run)
        payload["runs"].append({"run": run, "state": state, "batch": batch})
    reference = start_reference(REF, payload, tmp_path, subprocess_env, timeout=480)
    out = launch("train_step", 4, tmp_path, timeout=480, runs=[list(r) for r in runs],
                 shape=list(shape), axes=["data", "model"], seq=SEQ, batch=BATCH)
    for run, mesh_out, ref in zip(runs, out[0], reference()):
        ref_state = {p: np.asarray(w) for p, w in tree_leaves(ref["state"])}
        _assert_matches(mesh_out["state"], mesh_out["metrics"], ref_state, ref["metrics"])
        want, want_metrics = _single(*run)
        _assert_matches(mesh_out["state"], mesh_out["metrics"], want, want_metrics)
    for rank_out in out[1:]:  # every rank reports the same global metrics
        assert [r["metrics"] for r in rank_out] == [r["metrics"] for r in out[0]]
    return out


def test_mesh_train_step_matches_single_device(tmp_path, subprocess_env):
    out = _against_reference_and_single(RUNS_2X2, (2, 2), tmp_path, subprocess_env)
    # tensor parallelism moves activations, never weights: InternLM2's
    # forward and backward passes gather nothing (the vocab-parallel lookup
    # and loss reduce activations; the norms reduce the partial sums a
    # column-parallel product would otherwise meet by gathering its weight)
    for run, mesh_out in zip(RUNS_2X2, out[0]):
        if run[0] == "internlm2-1.8b":
            assert "all_gather_into_tensor" not in mesh_out["comms"], mesh_out["comms"]
            assert mesh_out["comms"].get("all_reduce", 0) > 0


def test_mesh_train_step_kv_heads_not_dividing_model(tmp_path, subprocess_env):
    """On (1, 4) the q heads split over ``model`` one a rank; k and v are
    gathered, each rank slices the kv head its q head reads, and their
    gradients come back as partial sums over ``model``, reduce-scattered
    into ``wk``/``wv``'s columns (a replicated gradient there would count
    each rank's part as the whole, and the step would differ). Jamba's
    SSM layers also run their 16 heads 4 a rank."""
    out = _against_reference_and_single(RUNS_1X4, (1, 4), tmp_path, subprocess_env)
    for mesh_out in out[0]:
        assert mesh_out["comms"].get("reduce_scatter_tensor", 0) > 0, mesh_out["comms"]


def test_mesh_train_step_heads_not_dividing_model(tmp_path):
    """On a (1, 8) mesh the reduced InternLM2's 4 heads (2 kv) do not divide
    over ``model``: ``split_dim`` gathers them, and rank r runs the head
    [r, r + 1) of ``torch.chunk``'s split (ranks 4-7 none) against the kv
    head it reads; the heads are gathered after, and the merge is sliced
    to ``wo``'s rows before the output projection, so its gradient comes
    back whole, where it splits into heads. The step equals the
    single-device step."""
    run = ("internlm2-1.8b", False, 1, False, "dots")
    out = launch("train_step", 8, tmp_path, timeout=480, runs=[list(run)], shape=[1, 8],
                 axes=["data", "model"], seq=SEQ, batch=BATCH)
    want, want_metrics = _single(*run)
    _assert_matches(out[0][0]["state"], out[0][0]["metrics"], want, want_metrics)


#: (label, q heads, kv heads, q's and k/v's placement on a 4-rank model
#: axis): every branch of ``sharding.dtensor.local_heads``
SPLITS = [
    ("kv whole", 8, 2, "S2", "R"),  # 2 q heads a rank, one kv head sliced
    ("kv by heads", 8, 4, "S2", "S2"),  # the kv heads divide too
    ("kv head dims", 8, 2, "S2", "S3"),  # a cache's layout: scores summed
    ("q heads uneven", 6, 2, "R", "R"),  # 2, 2, 2, 0 heads; rank 1 spans 2 groups
]


@pytest.fixture(scope="module")
def attention_split(tmp_path_factory):
    return launch("attention_split", 4, tmp_path_factory.mktemp("split"), timeout=240,
                  cases=[list(c) for c in SPLITS])[0]


@pytest.mark.parametrize("case", SPLITS, ids=[c[0] for c in SPLITS])
def test_attention_core_split_over_model(attention_split, case):
    """The attention core on a (1, 4) mesh, each rank on its share of the
    heads (or of the head dims), equals the plain core on one device:
    output and the gradients of q, k and v (f32, 1e-5)."""
    from repro_torch.models.attention import _attend

    got = attention_split[case[0]]
    leaves = [torch.from_numpy(a).requires_grad_() for a in got["inputs"]]
    pos = torch.arange(leaves[0].shape[1])[None].expand(leaves[0].shape[0], -1)
    want = _attend(*leaves, pos, pos, "causal", 0, "auto")
    grads = torch.autograd.grad(want.square().sum(), leaves)
    np.testing.assert_allclose(got["out"], want.detach().numpy(), rtol=1e-5, atol=1e-5)
    for g, w, name in zip(got["grads"], grads, "qkv"):
        np.testing.assert_allclose(g, w.numpy(), rtol=1e-5, atol=1e-5, err_msg=name)
    if case[3] == "S2" and case[4] != "S3":
        assert got["local_heads"] == case[1] // 4  # the output stays split by heads


def test_moe_combine_reads_its_own_slots(tmp_path):
    """The MoE's combine with the expert slots sharded over a 4-rank
    ``model`` axis (expert parallelism): each rank reads the slots it
    holds and the sums are added up over ``model``, so no rank gathers the
    expert outputs; output and gradients (the expert outputs', the
    gates') equal the plain combine's (f32, 1e-6)."""
    from repro_torch.models.moe import _combine_group

    got = launch("moe_combine", 4, tmp_path, timeout=240)[0]
    table, slot, keep, gates = got["inputs"]
    tg, k = slot.shape[1] // 2, 2
    leaves = [torch.from_numpy(table).requires_grad_(), torch.from_numpy(gates).requires_grad_()]
    want = _combine_group(leaves[0], torch.from_numpy(slot), torch.from_numpy(keep), leaves[1],
                          tg, k)
    grads = torch.autograd.grad(want.square().sum(), leaves)
    np.testing.assert_allclose(got["out"], want.detach().numpy(), rtol=1e-6, atol=1e-6)
    for g, w in zip(got["grads"], grads):
        np.testing.assert_allclose(g, w.numpy(), rtol=1e-6, atol=1e-6)
    assert "all_gather_into_tensor" not in got["comms"], got["comms"]
    assert got["comms"].get("all_reduce", 0) + got["comms"].get("allreduce_", 0) > 0


def test_mesh_placements_follow_the_partition_rules():
    """What the launch above places: the (2, 2) mesh shards InternLM2's
    projections over model; Mixtral's 4 experts divide model = 2, so EP,
    and its expert stacks (the only reduced leaves of 2^16 elements or
    more) take the data axis too: in the moments (ZeRO-1) always, in the
    parameters with fsdp."""
    from repro_torch.models import Model
    from repro_torch.sharding import opt_state_specs

    cfg = get_arch("internlm2-1.8b").reduced()
    model = Model(cfg, device="meta")
    mesh = MeshShape(("data", "model"), (2, 2))
    specs = param_specs(cfg, model, mesh)
    assert specs["stack.layers.0.mixer.wq"] == (None, "model")
    assert specs["stack.layers.0.mixer.wo"] == ("model", None)
    mx = get_arch("mixtral-8x22b").reduced()
    mx_model = Model(mx, device="meta")
    plain = param_specs(mx, mx_model, mesh)
    zero1 = opt_state_specs(mx, mx_model, mesh)
    fsdp = param_specs(mx, mx_model, mesh, fsdp=True)
    for name in (n for n in plain if n.endswith("experts.up")):
        assert plain[name] == ("model", None, None)
        assert zero1[name] == fsdp[name] == ("model", "data", None)


def test_step_refuses_a_state_off_its_mesh():
    from torch.distributed.device_mesh import DeviceMesh

    cfg = get_arch("internlm2-1.8b").reduced()
    tcfg = TrainConfig()
    state = init_train_state(cfg, tcfg, "cpu")
    batch = make_batch(cfg, ShapeSpec("tiny", SEQ, BATCH, "train"), DataConfig(), 0, device="cpu")
    # a one-rank mesh that needs no process group: the check comes first
    mesh = DeviceMesh("cpu", [0], mesh_dim_names=("data",), _init_backend=False, _rank=0)
    with pytest.raises(ValueError, match="not DTensors"):
        make_train_step(cfg, tcfg, mesh)(state, batch)
    assert torch.is_tensor(state["opt"]["step"])
