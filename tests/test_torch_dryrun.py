"""The port's dry run (``python -m repro_torch.launch.dryrun``) end to end
on fake process groups with reduced configs, against the reference's.

The reference's ``tests/test_dryrun_small.py`` on the port: the train
cell on the tiny single (2 x 2) and multi (2 x 2 x 2) meshes, Mixtral's
decode, Mamba2's 500k decode and Llama-3's 500k skip, plus a prefill
through the vision frontend (Qwen2-VL). Each cell runs as a child
process (the process group is process-global), as rank 0 of a fake
group of 4 or 8 ranks, on fake CPU tensors (``--device cpu``). The
records are then held to the reference's own (``python -m
repro.launch.dryrun --tiny`` with ``REPRO_DRYRUN_DEVICES=8``):
``params``, ``active_params`` and ``plan`` equal, the argument bytes
equal but for the leaves named in ``ARGUMENT_RULES``, and
``dot_flops_expanded`` within 2% but for the gaps named in
``DOT_GAPS``. The collectives are recorded beside the reference's, not
held equal: DTensor and GSPMD choose different collectives.

On meshes whose ``model`` axis is wider than a GQA model's kv heads
(``(1, 4)``: 2 kv heads on 4 ranks; ``(1, 8)``: 4 heads on 8) each model
rank must compute only its share of the attention heads:
``test_heads_split_over_model`` holds the port's per-chip dot FLOPs to
the reference's ``lower_cell`` + ``analyze`` on the same mesh shape over
forced host devices. ``test_fsdp_loss_keeps_logits_vocab_sharded`` holds
DeepSeek-V3's train step under FSDP on ``(2, 2)``: no all-gather of the
loss's logits, and the reference's dot FLOPs.
"""

import json
import os
import re
import subprocess
import sys
import textwrap
from concurrent.futures import ThreadPoolExecutor

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: (arch, shape, mesh) of every cell held to the reference
CELLS = (
    ("internlm2-1.8b", "train_4k", "single"),
    ("internlm2-1.8b", "train_4k", "multi"),
    ("mixtral-8x22b", "decode_32k", "single"),
    ("mamba2-780m", "long_500k", "single"),
    ("qwen2-vl-2b", "prefill_32k", "single"),
)

#: argument bytes of the port's record less the reference's, by cell, and why
ARGUMENT_RULES = {
    # the decode step's cache_index (an int32 scalar) reaches no op of an
    # SSM-only model; jax.jit drops unused arguments (keep_unused=False),
    # the port's step holds it all the same
    ("mamba2-780m", "long_500k", "single"): 4,
}

#: dot_flops_expanded of the port's record over the reference's, beyond
#: 2%: none (each model rank computes its own attention and SSM heads)
DOT_GAPS = {}

TRAIN = ("internlm2-1.8b", "train_4k")


def _env(**extra):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), JAX_PLATFORMS="cpu",
               OMP_NUM_THREADS="1")
    env.update(extra)
    return env


def _nice():
    """Run a child at the lowest priority: the test workers beside it keep
    the CPU (some time their steps)."""
    os.nice(19)


def _port(arch, shape, mesh, outdir, *extra):
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--tiny", "--device", "cpu",
         "--arch", arch, "--shape", shape, "--mesh", mesh, "--out", outdir, "--force", *extra],
        capture_output=True, text=True, env=_env(), cwd=ROOT, timeout=600, preexec_fn=_nice)


def _reference(arch, shape, mesh, outdir):
    return subprocess.run(
        [sys.executable, "-m", "repro.launch.dryrun", "--tiny", "--arch", arch, "--shape", shape,
         "--mesh", mesh, "--out", outdir, "--force"],
        capture_output=True, text=True, env=_env(REPRO_DRYRUN_DEVICES="8"), cwd=ROOT,
        timeout=600, preexec_fn=_nice)


def _load(outdir, arch, shape, mesh):
    with open(os.path.join(outdir, mesh, f"{arch}__{shape}.json")) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    """Every cell's record from each package (and Llama-3's skip), the
    children run three at a time; the port's train cell on both meshes
    as one run of two child processes (``--jobs 2``)."""
    port = str(tmp_path_factory.mktemp("port"))
    ref = str(tmp_path_factory.mktemp("reference"))
    jobs = [(_port, *TRAIN, "both", port, "--jobs", "2"), (_reference, *TRAIN, "both", ref),
            (_port, "llama3-8b", "long_500k", "single", port)]
    jobs += [(run, arch, shape, mesh, out) for arch, shape, mesh in CELLS[2:]
             for run, out in ((_port, port), (_reference, ref))]
    with ThreadPoolExecutor(3) as pool:
        procs = list(pool.map(lambda j: (j, j[0](*j[1:])), jobs))
    for job, proc in procs:
        assert proc.returncode == 0, f"{job[0].__name__} {job[1:4]}: {proc.stderr[-3000:]}"
    lines = procs[0][1].stdout.splitlines()  # --jobs 2: a line per child, then the count
    assert sorted(x.split()[1] for x in lines[:-1]) == [f"{m}/{TRAIN[0]}/{TRAIN[1]}"
                                                        for m in ("multi", "single")]
    assert all("child wall" in x for x in lines[:-1])
    assert lines[-1] == "done: 2 ok, 0 skipped, 0 failed"
    return port, ref


@pytest.mark.parametrize("mesh", ["single", "multi"])
def test_train_cell_traces_and_accounts(records, mesh):
    rec = _load(records[0], *TRAIN, mesh)
    assert not rec.get("skipped") and "error" not in rec
    assert rec["flops"] > 0
    assert rec["dot_flops_expanded"] > rec["flops"] * 0.5
    assert rec["collective_bytes"] > 0  # DP/TP collectives must exist
    assert "all-reduce" in rec["collectives"]
    assert rec["memory"]["temp_size_in_bytes"] > 0
    assert rec["chips"] == (4 if mesh == "single" else 8) and rec["trace_s"] >= 0


def test_decode_cell_traces(records):
    rec = _load(records[0], "mixtral-8x22b", "decode_32k", "single")
    assert not rec.get("skipped") and "error" not in rec
    assert rec["flops"] > 0


def test_ssm_long_context_runs(records):
    rec = _load(records[0], "mamba2-780m", "long_500k", "single")
    assert not rec.get("skipped") and "error" not in rec


def test_full_attention_long_context_skips(records):
    rec = _load(records[0], "llama3-8b", "long_500k", "single")
    assert rec["skipped"] and "quadratic" in rec["reason"]


def test_prefill_cell_with_vision_frontend(records):
    rec = _load(records[0], "qwen2-vl-2b", "prefill_32k", "single")
    assert not rec.get("skipped") and "error" not in rec
    assert rec["kind"] == "prefill" and rec["dot_flops_expanded"] > 0
    # the prefill returns its caches: they are output, not aliased arguments
    assert rec["memory"]["output_size_in_bytes"] > 0
    assert rec["memory"]["alias_size_in_bytes"] == 0


@pytest.mark.parametrize("cell", CELLS, ids=["/".join(c) for c in CELLS])
def test_records_match_reference(records, cell):
    got, want = _load(records[0], *cell), _load(records[1], *cell)
    for key in ("arch", "shape", "mesh", "chips", "kind", "tiny", "params", "active_params",
                "plan", "skipped"):
        assert got[key] == want[key], key
    arg = got["memory"]["argument_size_in_bytes"] - want["memory"]["argument_size_in_bytes"]
    assert arg == ARGUMENT_RULES.get(cell, 0)
    ratio = got["dot_flops_expanded"] / want["dot_flops_expanded"]
    assert ratio == pytest.approx(DOT_GAPS.get(cell, 1.0), rel=0.02)
    # the same record keys (compile_s is trace_s; no while_trips, no HLO text)
    missing = set(want) - set(got) - {"compile_s", "while_trips", "transcendentals",
                                      "collective_bytes_raw"}
    assert not missing
    assert set(want["memory"]) - set(got["memory"]) == {"generated_code_size_in_bytes"}
    print(f"{'/'.join(cell)} collectives: port {got['collectives']}, reference "
          f"{want['collectives']}")
    if "all-reduce" in want["collectives"]:
        assert "all-reduce" in got["collectives"]


#: (arch, shape, (data, model)) of the meshes wider than the kv heads
HEAD_CELLS = (
    ("internlm2-1.8b", "train_4k", (1, 4)),
    ("llama3-8b", "prefill_32k", (1, 4)),
    ("llama3-8b", "decode_32k", (1, 4)),
    ("internlm2-1.8b", "train_4k", (1, 8)),
)

#: the port's dot FLOPs over the reference's where the q heads do not
#: divide ``model`` either (4 on 8): rank r runs the heads [r, r + 1) of
#: ``torch.chunk``'s split (ranks 4-7 none), so rank 0 computes a quarter
#: of the attention, where GSPMD splits the head dims as well and
#: computes an eighth plus 14,680,064 FLOPs of its own: (N/8 + A/4) /
#: (N/8 + A/8 + 14,680,064) with N = 1,241,513,984 FLOPs outside the
#: attention and A = 536,870,912 in it (4 layers x 4 passes x 2 x 2 x 8
#: x 128^2 x 4 x 16)
UNEVEN_GAP = 289_406_976 / 236_978_176

#: DeepSeek-V3's train step under FSDP, reduced, where its loss gathered
#: the logits: the reduced config with a vocab of 2048, so that the head's
#: weight (64 x 2048) passes FSDP's 2^16-element floor as at full width,
#: FSDP on and two microbatches on (2, 2). Left to DTensor, the head's
#: product split its contraction over ``data`` (logits of every row, partial
#: sums over ``data``), and the loss's reduce-scatter of those sums first
#: gathered the logits over ``model`` to the full vocab: at full width on
#: 256 ranks, 3 x 33.9 GB per chip
LOGITS_CELL = ("deepseek-v3-671b", "train_4k", (2, 2), {"vocab": 2048},
               {"fsdp": True, "microbatches": 2})

#: the cells above on the port: rank 0 of a fake process group, fake CPU
#: tensors, reduced as ``--tiny`` reduces them (and by the cell's config
#: and plan overrides)
PORT_CELL = textwrap.dedent(
    """
    import dataclasses, json, sys
    from repro_torch.configs import SHAPES, get_arch
    from repro_torch.launch.dryrun import analyze, fake_mesh, lower_cell, plan_cell
    arch, name, shape = sys.argv[1], sys.argv[2], tuple(json.loads(sys.argv[3]))
    cfg_over, plan_over = json.loads(sys.argv[4]), json.loads(sys.argv[5])
    cfg, s = dataclasses.replace(get_arch(arch).reduced(), **cfg_over), SHAPES[name]
    s = dataclasses.replace(s, seq_len=min(s.seq_len, 128), global_batch=min(s.global_batch, 8))
    mesh = fake_mesh(shape, ("data", "model"), "cpu")
    rec = analyze(lower_cell(cfg, s, mesh, dict(plan_cell(cfg, s, mesh), **plan_over)))
    print(json.dumps({"dot": rec["dot_flops_expanded"], "memory": rec["memory"],
                      "collective_ops": rec["collective_ops"]}))
    """
)

#: the same cells on the reference, over eight forced host devices: its
#: ``lower_cell`` + ``analyze`` on its own ``make_mesh``, outside a mesh
#: context (``"free"``: ``_constrain_batch_heads`` pins nothing and GSPMD
#: splits the heads by propagation alone) and inside one, as its dry run's
#: ``run_cell`` lowers (``"pinned"``: the pin of 2 kv heads on 4 or 8
#: model ranks pads them, and rank 0 computes 2 of the 4 q heads)
REF_CELLS = textwrap.dedent(
    """
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import dataclasses, json
    from repro.configs import SHAPES, get_arch
    from repro.launch.dryrun import analyze, lower_cell, plan_cell
    from repro.launch.mesh import make_mesh
    out = []
    for arch, name, shape, cfg_over, plan_over in json.loads(sys.argv[1]):
        cfg, s = dataclasses.replace(get_arch(arch).reduced(), **cfg_over), SHAPES[name]
        s = dataclasses.replace(s, seq_len=min(s.seq_len, 128),
                                global_batch=min(s.global_batch, 8))
        mesh = make_mesh(tuple(shape), ("data", "model"))
        plan = dict(plan_cell(cfg, s, mesh), **plan_over)
        rec = {"free": analyze(lower_cell(cfg, s, mesh, plan))["dot_flops_expanded"]}
        with mesh:
            rec["pinned"] = analyze(lower_cell(cfg, s, mesh, plan))["dot_flops_expanded"]
        out.append(rec)
    print(json.dumps(out))
    """
)


@pytest.fixture(scope="module")
def head_records():
    """{cell: (the port's record, the reference's dot FLOPs free and
    pinned)} of ``HEAD_CELLS`` and ``LOGITS_CELL``: the reference in two
    children (the head cells, then the logits cell), the port's cells
    beside them, a child each."""
    head = [(*c, {}, {}) for c in HEAD_CELLS]
    cells = head + [LOGITS_CELL]

    def run(*args, timeout=600):
        return subprocess.run([sys.executable, "-c", *args], capture_output=True, text=True,
                              env=_env(), cwd=ROOT, timeout=timeout, preexec_fn=_nice)

    def port(cell):
        arch, shape, mesh, cfg_over, plan_over = cell
        return run(PORT_CELL, arch, shape, *map(json.dumps, (mesh, cfg_over, plan_over)))

    with ThreadPoolExecutor(4) as pool:
        refs = [pool.submit(run, REF_CELLS, json.dumps(group), timeout=900)
                for group in (head, [LOGITS_CELL])]
        ports = list(pool.map(port, cells))
        refs = [r.result() for r in refs]
    for ref in refs:
        assert ref.returncode == 0, ref.stderr[-3000:]
    for cell, proc in zip(cells, ports):
        assert proc.returncode == 0, f"{cell}: {proc.stderr[-3000:]}"
    refs = sum((json.loads(r.stdout.splitlines()[-1]) for r in refs), [])
    return {cell[:3]: (json.loads(p.stdout.splitlines()[-1]), r)
            for cell, p, r in zip(cells, ports, refs)}


@pytest.mark.parametrize("cell", HEAD_CELLS,
                         ids=[f"{a}/{s}/{m[0]}x{m[1]}" for a, s, m in HEAD_CELLS])
def test_heads_split_over_model(head_records, cell):
    """Each model rank computes only its share of the attention: the
    port's per-chip dot FLOPs equal the reference's within 2% where the q
    heads divide ``model`` (the kv heads do not), ``UNEVEN_GAP`` over it
    where neither does, and never exceed what the reference's own dry run
    lowers (its pinned program)."""
    got, want = head_records[cell]
    print(f"{cell}: port {got['dot']:,.0f}, reference free {want['free']:,.0f}, "
          f"pinned {want['pinned']:,.0f}")
    gap = UNEVEN_GAP if cell[2] == (1, 8) else 1.0
    assert got["dot"] / want["free"] == pytest.approx(gap, rel=0.02)
    assert got["dot"] <= want["pinned"]


def test_decode_reads_the_cache_in_place(head_records):
    """A decode step on ``(1, 4)`` reads the cache in its own layout (kv
    heads that do not divide ``model``, so head dims sharded over it): its
    temp bytes stay below the single device's whole step, where a gather
    of k and v per layer tripled them (536,136 against 181,320)."""
    got, _ = head_records[("llama3-8b", "decode_32k", (1, 4))]
    assert got["memory"]["temp_size_in_bytes"] < 181_320


def test_fsdp_loss_keeps_logits_vocab_sharded(head_records):
    """DeepSeek-V3's train step under FSDP (``LOGITS_CELL``): the head's
    weight is gathered over ``data`` (FSDP's gather) and the logits keep
    their rows on their data ranks and their vocab over ``model`` through
    the loss and the MTP term, so no rank gathers logits: no all-gather's
    operand is shaped as logits, (rows, positions, the vocab shard 2048 / 2)
    (the MTP term's positions one fewer). Per-chip dot FLOPs equal the
    reference's own dry run (pinned) within 2%."""
    got, want = head_records[LOGITS_CELL[:3]]
    vocab_shard = LOGITS_CELL[3]["vocab"] // LOGITS_CELL[2][1]
    logits = re.compile(rf"all-gather \(\d+, 12[78], {vocab_shard}\) ")
    gathers = [op for op in got["collective_ops"] if logits.match(op[0])]
    print(f"{LOGITS_CELL[:3]}: port {got['dot']:,.0f}, reference pinned {want['pinned']:,.0f}; "
          f"largest collectives {got['collective_ops'][:4]}")
    assert gathers == []
    assert got["dot"] / want["pinned"] == pytest.approx(1.0, rel=0.02)


def test_without_a_card_exits_2(tmp_path):
    """No card (none visible) and no ``--device cpu``: one line, exit 2."""
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--tiny", "--arch",
         "internlm2-1.8b", "--shape", "train_4k", "--mesh", "single", "--out", str(tmp_path)],
        capture_output=True, text=True, env=_env(CUDA_VISIBLE_DEVICES=""), cwd=ROOT, timeout=300)
    assert proc.returncode == 2
    assert proc.stderr.strip().splitlines() == [
        "error: no CUDA device is available; pass --device cpu to run on the CPU"]
    assert not os.listdir(tmp_path)
