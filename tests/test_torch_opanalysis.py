"""The port's op-trace counter (``repro_torch.launch.opanalysis``) against
the reference's HLO analyzer (``repro.launch.hloanalysis``).

The reference's ``tests/test_hloanalysis.py`` on the port: the same four
programs written in torch (a plain matmul, a loop of 7 matmuls, nested
loops of 3 x 5, the loop-free ``relu(x@y)@y.T``), each counted by
:func:`analyze_ops` on real CPU tensors and on fake tensors, and each
count held to ``analyze_hlo`` of the same program compiled by JAX (its
loops as ``lax.scan``). Beyond them: the recompute of a
``torch.utils.checkpoint`` region is counted in the backward; a DTensor
matmul counts one chip's FLOPs (65,536 for ``(8, 256) @ (256, 256)`` with
the weight ``Shard(1)`` on 16 fake ranks, not the 1,048,576 of the global
product) on the first call of an op signature, when DTensor's sharding
propagation runs it at the global shape, and on later calls; collective
operand bytes by kind on a fake 4-rank group, with the reference's
all-gather / reduce-scatter operand semantics
(``hloanalysis.py:266-272``); the peak of live storages; and meta
tensors, which count no bytes.
"""

import json
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro.launch.hloanalysis import analyze_hlo
from repro_torch.launch.opanalysis import analyze_ops, argument_bytes

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _hlo_dot_flops(fn, *shapes):
    args = [jax.ShapeDtypeStruct(s, jnp.float32) for s in shapes]
    return analyze_hlo(jax.jit(fn).lower(*args).compile().as_text()).dot_flops


def _count(fn, *shapes, fake: bool):
    """analyze_ops of ``fn`` on numpy-seeded f32 tensors of ``shapes``
    (real), or on fake tensors of those shapes."""
    if fake:
        mode = FakeTensorMode()
        with mode:
            args = [torch.empty(s) for s in shapes]
        return analyze_ops(fn, *args, fake_mode=mode)[0]
    rng = np.random.default_rng(0)
    args = [torch.from_numpy(rng.standard_normal(s).astype(np.float32)) for s in shapes]
    return analyze_ops(fn, *args)[0]


MODES = pytest.mark.parametrize("fake", [False, True], ids=["real", "fake"])


@MODES
def test_plain_matmul_flops(fake):
    t = _count(lambda x, y: x @ y, (64, 128), (128, 32), fake=fake)
    want = _hlo_dot_flops(lambda x, y: x @ y, (64, 128), (128, 32))
    assert want == pytest.approx(2 * 64 * 128 * 32, rel=0.01)
    assert t.dot_flops == want == t.flops


@MODES
def test_loop_counts_every_trip(fake):
    """A loop of N matmuls counts N x the single-matmul FLOPs (the
    reference needs the scan's trip count; an eager loop runs N ops)."""
    n = 7

    def loop(ws, x0):
        c = x0
        for i in range(n):
            c = torch.tanh(c @ ws[i])
        return c

    def scan(ws, x0):
        def body(c, w):
            return jnp.tanh(c @ w), None

        return jax.lax.scan(body, x0, ws)[0]

    t = _count(loop, (n, 32, 32), (8, 32), fake=fake)
    want = _hlo_dot_flops(scan, (n, 32, 32), (8, 32))
    assert want == pytest.approx(n * 2 * 8 * 32 * 32, rel=0.05)
    assert t.dot_flops == pytest.approx(want, rel=1e-12)


@MODES
def test_nested_loops_multiply(fake):
    """loop(M) of loop(N) of matmul -> M*N x flops."""
    m_out, n_in = 3, 5

    def loops(ws, x0):
        c = x0
        for i in range(m_out):
            for j in range(n_in):
                c = c @ ws[i, j]
        return c

    def scans(ws, x0):
        def outer(c, w_outer):
            def inner(ci, wi):
                return ci @ wi, None

            return jax.lax.scan(inner, c, w_outer)[0], None

        return jax.lax.scan(outer, x0, ws)[0]

    t = _count(loops, (m_out, n_in, 16, 16), (4, 16), fake=fake)
    want = _hlo_dot_flops(scans, (m_out, n_in, 16, 16), (4, 16))
    assert want == pytest.approx(m_out * n_in * 2 * 4 * 16 * 16, rel=0.05)
    assert t.dot_flops == pytest.approx(want, rel=1e-12)


@MODES
def test_matches_reference_without_loops(fake):
    """On a loop-free program the dot count is the reference's, and the
    registry's ``flops`` (its stand-in for cost_analysis) bound it."""
    t = _count(lambda x, y: torch.relu(x @ y) @ y.T, (128, 256), (256, 512), fake=fake)
    want = _hlo_dot_flops(lambda x, y: jax.nn.relu(x @ y) @ y.T, (128, 256), (256, 512))
    assert want >= 0.9 * 2 * (128 * 256 * 512 + 128 * 512 * 256)
    assert t.dot_flops == pytest.approx(want, rel=1e-12)
    assert t.flops >= t.dot_flops


def test_checkpoint_recompute_is_counted():
    """A checkpointed region runs its forward again in the backward: one
    product forward, one recomputed, two in the backward (x and w)."""
    from torch.utils.checkpoint import checkpoint

    rng = np.random.default_rng(1)
    w = torch.from_numpy(rng.standard_normal((64, 64)).astype(np.float32)).requires_grad_()
    x = torch.from_numpy(rng.standard_normal((32, 64)).astype(np.float32)).requires_grad_()
    one = 2 * 32 * 64 * 64

    def step(region):
        def fn(w, x):
            y = region(lambda a: torch.tanh(a @ w), x)
            return torch.autograd.grad(y.sum(), [w, x])

        return analyze_ops(fn, w, x)[0].dot_flops

    assert step(lambda f, a: f(a)) == 3 * one
    assert step(lambda f, a: checkpoint(f, a, use_reentrant=False)) == 4 * one


def test_peak_and_materialized_bytes():
    """Storages are tracked from the op that makes them to their release:
    the peak is the most alive at once, views allocate nothing, and the
    result's storages are the output (an in-place argument an alias)."""
    x = torch.zeros(1024)  # 4096 B

    def fn(x):
        keep = [x + i for i in range(4)]  # four live at once
        v = keep[0].view(32, 32)  # a view: no allocation
        del keep
        y = x * 2  # one more, after the four died
        x.add_(1)  # in place: no allocation
        return y, v, x

    t, _ = analyze_ops(fn, x)
    assert t.peak_bytes == 4 * 4096
    assert t.materialized_bytes == 2 * 5 * 4096
    assert t.output_bytes == 3 * 4096 and t.alias_bytes == 4096
    assert argument_bytes({"a": x, "b": [x, x.view(2, 512)]}) == 4096


def test_meta_tensors_are_neither_read_nor_held():
    """A meta tensor holds a shape and no bytes (a cache drawn on the meta
    device before it is placed shard by shard): its ops add nothing to
    ``bytes_accessed``, ``materialized_bytes`` or the peak."""
    x = torch.zeros(1024)  # 4096 B

    def fn(x):
        big = torch.zeros(1 << 30, device="meta") + 1  # 4 GiB, were it real
        return x * 2, big.shape

    t, _ = analyze_ops(fn, x)
    assert t.bytes_accessed == 2 * 4096
    assert t.materialized_bytes == 2 * 4096
    assert t.peak_bytes == 4096


#: a child on a fake 16-rank process group: per-chip FLOPs of a DTensor
#: matmul on its first call (cold propagation) and a later one, for each
#: way of writing it, on real or fake tensors (``sys.argv[1]``)
_DTENSOR_CHILD = textwrap.dedent(
    """
    import json, sys
    import torch, torch.distributed as dist
    import torch.nn.functional as F
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from torch.testing._internal.distributed.fake_pg import FakeStore
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.launch.opanalysis import analyze_ops

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=16)
    mesh = init_device_mesh("cpu", (16,))
    mode = FakeTensorMode() if sys.argv[1] == "fake" else None
    forms = {"mm": torch.mm, "matmul": lambda a, b: a @ b,
             "linear": lambda a, b: F.linear(a, b.t())}
    out = {}
    for i, (name, fn) in enumerate(forms.items()):
        rows = 8 * (i + 1)  # a new op signature per form: a cold propagation cache
        if mode is not None:
            with mode:
                x, w = torch.empty(rows, 256), torch.empty(256, 256)
        else:
            x, w = torch.randn(rows, 256), torch.randn(256, 256)
        x = distribute_tensor(x, mesh, [Replicate()], src_data_rank=None)
        w = distribute_tensor(w, mesh, [Shard(1)], src_data_rank=None)
        first = analyze_ops(fn, x, w, fake_mode=mode)[0].dot_flops
        later = analyze_ops(fn, x, w, fake_mode=mode)[0].dot_flops
        with FlopCounterMode(display=False) as fc:
            fn(x, w)
        out[name] = {"rows": rows, "first": first, "later": later,
                     "flop_counter": fc.get_total_flops()}
    print(json.dumps(out))
    """
)


@pytest.mark.parametrize("tensors", ["real", "fake"])
def test_dtensor_counts_one_chip(tensors):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    proc = subprocess.run([sys.executable, "-c", _DTENSOR_CHILD, tensors], capture_output=True,
                          text=True, env=env, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    for name, r in got.items():
        local, whole = 2 * r["rows"] * 256 * 16, 2 * r["rows"] * 256 * 256
        # per chip, not the global product (FlopCounterMode's count) ...
        assert r["first"] == r["later"] == local, (name, r)
        assert r["flop_counter"] == whole, (name, r)
        # ... and the first call's propagation at the global shape not counted
        assert r["first"] != local + whole


_COLLECTIVES_CHILD = textwrap.dedent(
    """
    import json
    import torch, torch.distributed as dist
    import torch.distributed._functional_collectives as funcol
    from torch.testing._internal.distributed.fake_pg import FakeStore
    from repro_torch.launch.opanalysis import analyze_ops

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=4)
    g = dist.group.WORLD
    x = torch.zeros(64, 8)  # 2048 B

    def fn(x):
        funcol.wait_tensor(funcol.all_reduce(x, "sum", g))
        funcol.wait_tensor(funcol.all_gather_tensor(x, 0, g))  # result 4 x x
        funcol.wait_tensor(funcol.reduce_scatter_tensor(x, "sum", 0, g))  # result x / 4
        funcol.wait_tensor(funcol.all_to_all_single(x, None, None, g))
        dist.all_reduce(x.clone())
        dist.all_gather_into_tensor(torch.empty(256, 8), x)
        dist.reduce_scatter_tensor(torch.empty(16, 8), x)
        dist.send(x, dst=1)

    t = analyze_ops(fn, x)[0]
    print(json.dumps({"per": t.per_collective, "total": t.collective_bytes}))
    """
)


def test_collective_operand_bytes_by_kind():
    """Operand bytes, as the reference reads them: an all-gather's operand
    is its input (the result / group size), a reduce-scatter's its input
    (the result x group size); functional and c10d ops alike; a send is a
    collective-permute of its buffer."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    proc = subprocess.run([sys.executable, "-c", _COLLECTIVES_CHILD], capture_output=True,
                          text=True, env=env, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    assert got["per"] == {
        "all-reduce": {"count": 2.0, "bytes": 4096.0},
        "all-gather": {"count": 2.0, "bytes": 4096.0},
        "reduce-scatter": {"count": 2.0, "bytes": 4096.0},
        "all-to-all": {"count": 1.0, "bytes": 2048.0},
        "collective-permute": {"count": 1.0, "bytes": 2048.0},
    }
    assert got["total"] == 16384.0
