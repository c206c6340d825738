"""Multi-rank test harness for the port: gloo ranks on the CPU.

:func:`launch` starts ``world`` Python processes, one per rank, each
joining a gloo process group through a file store under the test's
``tmp_path`` (no TCP port, so xdist workers never collide), runs
``CASES[case](**args)`` on every rank and returns the ranks' results
(whatever each returned, via ``torch.save``). A launch that outlives its
``timeout`` is killed and fails the test with the ranks' stderr.

The cases import torch and ``repro_torch`` only (no jax), so a rank
starts in a couple of seconds; the tests hold the results against the
reference in their own process, or against the reference on a mesh of
forced host devices in a subprocess started beside the ranks
(:func:`start_reference`).
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(os.path.dirname(HERE), "src")

_BOOT = (
    "import sys; sys.path[:0] = [{here!r}, {src!r}]; "
    "import _torch_spmd; _torch_spmd._worker()"
)


def launch(case: str, world: int, tmp_path, timeout: float = 240.0, **args):
    """Run ``case`` on ``world`` gloo ranks; returns [result of rank 0, ...]."""
    run = os.path.join(str(tmp_path), f"spmd-{case}-{time.monotonic_ns()}")
    os.makedirs(run)
    env = dict(os.environ)
    env["PYTHONPATH"] = SRC + (os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
    env.update(SPMD_CASE=case, SPMD_ARGS=json.dumps(args), SPMD_WORLD=str(world),
               SPMD_DIR=run, OMP_NUM_THREADS="1")
    procs = []
    for rank in range(world):
        err = open(os.path.join(run, f"err{rank}.txt"), "w")
        procs.append((subprocess.Popen(
            [sys.executable, "-c", _BOOT.format(here=HERE, src=SRC)],
            env=dict(env, SPMD_RANK=str(rank)), stdout=err, stderr=subprocess.STDOUT,
        ), err))
    deadline = time.monotonic() + timeout
    failed = None
    for rank, (p, err) in enumerate(procs):
        try:
            rc = p.wait(timeout=max(1.0, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            rc = "timeout"
        err.close()
        if rc != 0 and failed is None:
            failed = (rank, rc)
            for q, _ in procs:
                if q.poll() is None:
                    q.kill()
    for p, _ in procs:
        p.wait()
    if failed is not None:
        logs = "\n".join(
            f"--- rank {r} ---\n" + open(os.path.join(run, f"err{r}.txt")).read()[-3000:]
            for r in range(world)
        )
        raise AssertionError(f"case {case}: rank {failed[0]} exited {failed[1]}\n{logs}")
    import torch

    return [torch.load(os.path.join(run, f"out{r}.pt"), weights_only=False) for r in range(world)]


def start_reference(script: str, payload, tmp_path, env, devices: int = 4,
                    timeout: float = 300.0):
    """Start the JAX package's side of a comparison: ``script`` runs in a
    subprocess on ``devices`` forced host devices (``XLA_FLAGS``), reads
    ``payload`` from the pickle named by its ``sys.argv[1]`` and pickles
    its result to ``sys.argv[2]``. It runs beside the gloo ranks; the
    returned function waits for it (failing the test with its stderr
    after ``timeout`` seconds or a non-zero exit) and returns the result."""
    import pickle

    run = os.path.join(str(tmp_path), f"ref-{time.monotonic_ns()}")
    os.makedirs(run)
    src, dst = os.path.join(run, "in.pkl"), os.path.join(run, "out.pkl")
    with open(src, "wb") as f:
        pickle.dump(payload, f)
    env = dict(env, XLA_FLAGS=f"--xla_force_host_platform_device_count={devices}",
               JAX_PLATFORMS="cpu")
    err = open(os.path.join(run, "err.txt"), "w")
    proc = subprocess.Popen([sys.executable, "-c", script, src, dst], env=env, stdout=err,
                            stderr=subprocess.STDOUT, cwd=os.path.dirname(HERE),
                            preexec_fn=lambda: os.nice(19))  # as the ranks: the workers first
    started = time.monotonic()

    def wait():
        try:
            rc = proc.wait(timeout=max(1.0, started + timeout - time.monotonic()))
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
            rc = "timeout"
        err.close()
        if rc != 0:
            log = open(os.path.join(run, "err.txt")).read()[-3000:]
            raise AssertionError(f"reference run exited {rc}\n{log}")
        with open(dst, "rb") as f:
            return pickle.load(f)

    return wait


def _worker() -> None:
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    os.nice(19)  # yield the CPU to the test workers beside the ranks
    rank, world = int(os.environ["SPMD_RANK"]), int(os.environ["SPMD_WORLD"])
    run = os.environ["SPMD_DIR"]
    dist.init_process_group("gloo", init_method=f"file://{run}/pg", rank=rank,
                            world_size=world)
    try:
        out = CASES[os.environ["SPMD_CASE"]](**json.loads(os.environ["SPMD_ARGS"]))
        torch.save(out, os.path.join(run, f"out{rank}.pt"))
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# Cases (run on every rank)
# ---------------------------------------------------------------------------
def _mesh(shape, axes):
    from repro_torch.launch.mesh import make_mesh

    return make_mesh(tuple(shape), tuple(axes), device_type="cpu")


def case_compressed_psum(xs, sub):
    """compressed_psum of this rank's row of ``xs`` over the world, and
    over the ``sub`` mesh dim of a (2, world/2) mesh."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from repro_torch.optim.compression import compressed_psum

    rank, world = dist.get_rank(), dist.get_world_size()
    x = torch.from_numpy(np.asarray(xs, np.float32)[rank])
    mesh = _mesh((2, world // 2), ("pod", "data"))
    return {"world": compressed_psum(x).numpy(),
            "sub": compressed_psum(x, mesh.get_group(sub)).numpy()}


def case_pipeline(w, b, x, microbatches, dtensor):
    """pipeline_apply over a 1-D ("stage",) mesh of the world's ranks, for
    each microbatch count; stage params plain or DTensor-sharded."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from torch.distributed.tensor import Shard, distribute_tensor

    from repro_torch.train.pipeline import pipeline_apply

    mesh = _mesh((dist.get_world_size(),), ("stage",))
    params = {"w": torch.tensor(np.asarray(w, np.float32)),
              "b": torch.tensor(np.asarray(b, np.float32))}
    if dtensor:
        params = {k: distribute_tensor(v, mesh, [Shard(0)]) for k, v in params.items()}
    xt = torch.tensor(np.asarray(x, np.float32))

    def stage_fn(p, h):
        return torch.tanh(h @ p["w"] + p["b"])

    return {m: pipeline_apply(stage_fn, params, xt, mesh, m).numpy() for m in microbatches}


def case_pipeline_grads(w, b, x, microbatches, dtensor):
    """Gradients of ``sum(pipeline_apply(...) ** 2)`` with respect to the
    stage params and the input, for each microbatch count, over a 1-D
    ("stage",) mesh of the world's ranks; stage params plain or
    DTensor-sharded (their gradients gathered)."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from torch.distributed.tensor import Shard, distribute_tensor

    from repro_torch.sharding.dtensor import full
    from repro_torch.train.pipeline import pipeline_apply

    mesh = _mesh((dist.get_world_size(),), ("stage",))

    def stage_fn(p, h):
        return torch.tanh(h @ p["w"] + p["b"])

    out = {}
    for m in microbatches:
        params = {"w": torch.tensor(np.asarray(w, np.float32)),
                  "b": torch.tensor(np.asarray(b, np.float32))}
        if dtensor:
            params = {k: distribute_tensor(v, mesh, [Shard(0)]) for k, v in params.items()}
        for v in params.values():
            v.requires_grad_(True)
        xt = torch.tensor(np.asarray(x, np.float32), requires_grad=True)
        y = pipeline_apply(stage_fn, params, xt, mesh, m)
        gw, gb, gx = torch.autograd.grad((y ** 2).sum(), [params["w"], params["b"], xt])
        out[m] = {"w": full(gw).numpy(), "b": full(gb).numpy(), "x": gx.numpy(),
                  "out": y.detach().numpy()}
    return out


def _gathered_state(state):
    """(reference path, full numpy leaf) of a train state, in the
    reference's order; every rank joins the gathers, rank 0 keeps them."""
    import numpy as np
    import torch.distributed as dist

    from repro_torch.models.convert import _to_numpy, train_state_leaves
    from repro_torch.sharding.dtensor import full

    out = {}
    for path, tensors, stacked in train_state_leaves(state):
        arrs = [np.array(_to_numpy(full(t))) for t in tensors]  # copies: no view of a shard
        out[path] = np.stack(arrs) if stacked else arrs[0]
    return out if dist.get_rank() == 0 else None


def case_train_step(runs, shape, axes, seq, batch):
    """One mesh train step per run (arch, fsdp, microbatches, compress,
    remat) from the seed-0 state on the ``shape`` mesh; the metrics, the
    full state after the step, and the collectives of its forward and
    backward passes (by op, as ``CommDebugMode`` counts them)."""
    from collections import Counter

    from torch.distributed.tensor.debug import CommDebugMode

    from repro_torch.configs import get_arch
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.data import DataConfig
    from repro_torch.data.pipeline import make_batch
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import TrainConfig, init_train_state, make_train_step
    from repro_torch.train import train_step as ts

    grads, comms = ts._grads, Counter()

    def counted(*args):
        with CommDebugMode() as comm:
            result = grads(*args)
        comms.update({str(op).split(".")[-1]: n for op, n in comm.get_comm_counts().items()})
        return result

    ts._grads = counted
    mesh = _mesh(shape, axes)
    out = []
    for arch, fsdp, micro, compress, remat in runs:
        comms.clear()
        cfg = get_arch(arch).reduced()
        tcfg = TrainConfig(microbatches=micro, compress_grads=compress, fsdp=fsdp, remat=remat,
                           opt=AdamWConfig(warmup_steps=2, total_steps=10))
        state = init_train_state(cfg, tcfg, mesh, seed=0)
        b = make_batch(cfg, ShapeSpec("tiny", seq, batch, "train"), DataConfig(), 0, mesh=mesh)
        state, metrics = make_train_step(cfg, tcfg, mesh)(state, b)
        out.append({"metrics": {k: float(v) for k, v in metrics.items()},
                    "state": _gathered_state(state), "comms": dict(comms)})
    return out


def _elastic_trainer(ckpt, shape, steps):
    from repro_torch.configs import get_arch
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import TrainConfig, Trainer, TrainerConfig

    cfg = get_arch("internlm2-1.8b").reduced()
    tcfg = TrainConfig(opt=AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=20))
    return Trainer(cfg, ShapeSpec("tiny", 32, 8, "train"), _mesh(shape, ("data", "model")), tcfg,
                   TrainerConfig(steps=steps, ckpt_dir=ckpt, ckpt_every=3), DataConfig(seed=7))


def case_elastic(ckpt, shape, steps, restore_from=None):
    """The reference's elastic test body on ``shape``: a Trainer over
    ``ckpt`` trained (or resumed) to ``steps``. Rank 0 returns the
    restored state (gathered) before training, ``restore_from``'s
    checkpoint restored onto the same mesh, and the metrics."""
    from repro_torch.checkpoint import restore_checkpoint

    trainer = _elastic_trainer(ckpt, shape, steps)
    restored, start = trainer._init_or_restore()
    first = _gathered_state(restored)
    other = None
    if restore_from is not None:
        state, _, _ = restore_checkpoint(restore_from, restored)
        other = _gathered_state(state)
    del restored
    out = trainer.train()
    return {"start": start, "restored": first, "other": other, "step": out["step"],
            "losses": [m["lm_loss"] for m in out["metrics"]], "final": _gathered_state(out["state"])}


def serve_batch(cfg, b, s, seed=1):
    """The numpy-seeded prompt batch of a serve case (torch tensors)."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)}
    if cfg.frontend or cfg.enc_dec:
        batch["frontend"] = (rng.standard_normal((b, cfg.n_frontend_tokens, cfg.d_model))
                             * 0.05).astype(np.float32)
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def gathered_caches(caches):
    """A cache tree with every leaf as a full numpy array."""
    import numpy as np

    from repro_torch.sharding.dtensor import full

    def leaf(t):
        return np.array(full(t).cpu().numpy())

    out = {"stack": [None if layer is None else
                     {part: {k: leaf(t) for k, t in leaves.items()} for part, leaves in layer.items()}
                     for layer in caches["stack"]]}
    if "enc_out" in caches:
        out["enc_out"] = leaf(caches["enc_out"])
    return out


def case_serve(runs, shape, axes):
    """``generate_timed`` on the mesh for each run (arch, batch, prompt,
    steps) from the seed-0 model: tokens, logits and the caches after the
    last step."""
    from repro_torch.configs import get_arch
    from repro_torch.models import Model
    from repro_torch.serve import generate_timed

    mesh = _mesh(shape, axes)
    out = []
    for arch, b, s, steps in runs:
        cfg = get_arch(arch).reduced()
        model = Model(cfg, device="cpu")
        r = generate_timed(model, cfg, serve_batch(cfg, b, s), steps, mesh=mesh)
        out.append({"tokens": r["tokens"].numpy(), "prefill_logits": r["prefill_logits"].numpy(),
                    "logits": [x.numpy() for x in r["logits"]],
                    "caches": gathered_caches(r["caches"])})
    return out


def case_positions(serve_runs, train_runs, shape, axes, seq, batch):
    """What the position ids look like on the ``shape`` mesh: every call of
    ``models.model.stack_apply`` records its mode and its ids' placements
    (``"plain"`` for a plain tensor). ``generate_timed`` for
    each serve run (arch, batch, prompt, steps) from the seed-0 model, and
    one train step for each train run (arch, microbatches) from the seed-0
    state: the ids of each, tokens and logits, metrics and the state."""
    from torch.distributed.tensor import DTensor

    from repro_torch.configs import get_arch
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.data import DataConfig
    from repro_torch.data.pipeline import make_batch
    from repro_torch.models import Model
    from repro_torch.models import model as model_mod
    from repro_torch.optim import AdamWConfig
    from repro_torch.serve import generate_timed
    from repro_torch.train import TrainConfig, init_train_state, make_train_step

    ids, stack_apply = [], model_mod.stack_apply

    def recording(stack, cfg, x, *, positions, mode, **kw):
        pls = str(tuple(positions.placements)) if isinstance(positions, DTensor) else "plain"
        ids.append({"mode": mode, "placements": pls})
        return stack_apply(stack, cfg, x, positions=positions, mode=mode, **kw)

    model_mod.stack_apply = recording
    mesh = _mesh(shape, axes)
    serve, train = [], []
    for arch, b, s, steps in serve_runs:
        ids.clear()
        cfg = get_arch(arch).reduced()
        r = generate_timed(Model(cfg, device="cpu"), cfg, serve_batch(cfg, b, s), steps, mesh=mesh)
        serve.append({"ids": list(ids), "tokens": r["tokens"].numpy(),
                      "prefill_logits": r["prefill_logits"].numpy(),
                      "logits": [x.numpy() for x in r["logits"]]})
    for arch, micro in train_runs:
        ids.clear()
        cfg = get_arch(arch).reduced()
        tcfg = TrainConfig(microbatches=micro, remat="dots",
                           opt=AdamWConfig(warmup_steps=2, total_steps=10))
        state = init_train_state(cfg, tcfg, mesh, seed=0)
        bt = make_batch(cfg, ShapeSpec("tiny", seq, batch, "train"), DataConfig(), 0, mesh=mesh)
        state, metrics = make_train_step(cfg, tcfg, mesh)(state, bt)
        train.append({"ids": list(ids), "metrics": {k: float(v) for k, v in metrics.items()},
                      "state": _gathered_state(state)})
    return {"serve": serve, "train": train}


def case_attention_split(cases):
    """``models.attention._attend`` on a ``(1, world)`` mesh for each case
    (label, H, KH, q placement, k/v placement on ``model``; "S2", "S3" or
    "R"), from numpy-seeded q, k, v: the output and the gradients of
    ``sum(out ** 2)`` for q, k and v, gathered."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from repro_torch.models.attention import _attend
    from repro_torch.sharding.dtensor import full

    mesh = _mesh((1, dist.get_world_size()), ("data", "model"))
    pl = {"S2": Shard(2), "S3": Shard(3), "R": Replicate()}
    out = {}
    for label, h, kh, q_pl, kv_pl in cases:
        rng = np.random.default_rng(0)
        b, s, d = 2, 12, 8
        arrs = [rng.standard_normal((b, s, n, d)).astype(np.float32) for n in (h, kh, kh)]
        placed = [distribute_tensor(torch.from_numpy(a), mesh, [Replicate(), pl[p]],
                                    src_data_rank=None).requires_grad_()
                  for a, p in zip(arrs, (q_pl, kv_pl, kv_pl))]
        pos = torch.arange(s)[None].expand(b, s)
        o = _attend(*placed, pos, pos, "causal", 0, "auto")
        grads = torch.autograd.grad(full(o).square().sum(), placed)
        out[label] = {"inputs": arrs, "out": full(o).detach().numpy(),
                      "grads": [full(g).numpy() for g in grads],
                      "local_heads": o.to_local().shape[2] if o.placements[1] == Shard(2) else None}
    return out


def case_moe_combine():
    """The MoE's combine (``models.moe._combine_group``) through
    ``sharding.dtensor.gather_slots`` on a ``(1, world)`` mesh, the expert
    slots sharded over ``model``: the output, the gradients of the expert
    outputs and the gates, and the collectives it ran (by op)."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from torch.distributed.tensor.debug import CommDebugMode

    from repro_torch.models.moe import _combine_group
    from repro_torch.sharding.dtensor import full, gather_slots

    mesh = _mesh((1, dist.get_world_size()), ("data", "model"))
    rng = np.random.default_rng(0)
    g, e, cap, d, tg, k = 2, 8, 3, 5, 6, 2
    table = rng.standard_normal((g, e * cap, d)).astype(np.float32)
    slot = rng.integers(0, e * cap, (g, tg * k))
    keep = rng.random((g, tg * k)) < 0.8
    gates = rng.random((g, tg * k)).astype(np.float32)
    repl = [Replicate(), Replicate()]
    tbl = distribute_tensor(torch.from_numpy(table), mesh, [Replicate(), Shard(1)],
                            src_data_rank=None).requires_grad_()
    gt = distribute_tensor(torch.from_numpy(gates), mesh, repl,
                           src_data_rank=None).requires_grad_()
    sl, kp = (distribute_tensor(torch.from_numpy(a), mesh, repl, src_data_rank=None)
              for a in (slot, keep))
    with CommDebugMode() as comm:
        y = gather_slots(lambda *a: _combine_group(*a, tg, k), tbl, sl, kp, gt)
        grads = torch.autograd.grad(y.square().sum(), [tbl, gt])
    return {"inputs": (table, slot, keep, gates), "out": full(y).detach().numpy(),
            "grads": [full(t).numpy() for t in grads],
            "comms": {str(op).split(".")[-1]: n for op, n in comm.get_comm_counts().items()}}


CASES = {
    "moe_combine": case_moe_combine,
    "attention_split": case_attention_split,
    "serve": case_serve,
    "positions": case_positions,
    "elastic": case_elastic,
    "train_step": case_train_step,
    "compressed_psum": case_compressed_psum,
    "pipeline": case_pipeline,
    "pipeline_grads": case_pipeline_grads,
}
