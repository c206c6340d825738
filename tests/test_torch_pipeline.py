"""The port's GPipe schedule (``repro_torch.train.pipeline``) against the
sequential loop, in the port and in the JAX package.

The reference's ``tests/test_pipeline.py`` on the port: four gloo ranks
(one per stage), S = 4, M in {8, 4}, stage parameters as plain stacked
tensors and as DTensors sharded over the ``stage`` dim. Every rank's
result equals the port's sequential loop and the reference's sequential
loop on the same numpy inputs within 1e-5, and ``bubble_fraction(4, 8)
= 3/11``. The schedule differentiates: every rank's gradients of
``sum(out ** 2)`` for ``w``, ``b`` and ``x`` equal the sequential loop's
(torch autograd) and the reference's ``jax.grad`` through its own
``pipeline_apply`` on four forced host devices, within 1e-5.
"""

import os
import textwrap

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_spmd import launch, start_reference
from repro_torch.train.pipeline import bubble_fraction

S, M, B, D = 4, 8, 16, 32
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: the reference's pipeline and its gradients on four forced host devices
REFERENCE_GRADS = textwrap.dedent(
    """
    import pickle, sys
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import Mesh
    from repro.train.pipeline import pipeline_apply

    w, b, x, micro = pickle.load(open(sys.argv[1], "rb"))
    mesh = Mesh(np.array(jax.devices()).reshape(4), ("stage",))

    def stage_fn(p, h):
        return jnp.tanh(h @ p["w"] + p["b"])

    out = {}
    for m in micro:
        def loss(w, b, x):
            y = pipeline_apply(stage_fn, {"w": w, "b": b}, x, mesh, n_microbatches=m)
            return jnp.sum(y ** 2)
        gw, gb, gx = jax.grad(loss, argnums=(0, 1, 2))(jnp.asarray(w), jnp.asarray(b),
                                                        jnp.asarray(x))
        out[m] = {"w": np.asarray(gw), "b": np.asarray(gb), "x": np.asarray(gx)}
    pickle.dump(out, open(sys.argv[2], "wb"))
    """
)


def _inputs():
    rng = np.random.default_rng(0)
    w = (rng.standard_normal((S, D, D)) * 0.2).astype(np.float32)
    b = (rng.standard_normal((S, D)) * 0.1).astype(np.float32)
    x = rng.standard_normal((B, D)).astype(np.float32)
    return w, b, x


def _sequential_grads(w, b, x):
    """The port's sequential loop and its gradients of sum(out ** 2)."""
    wt, bt, xt = (torch.tensor(a, requires_grad=True) for a in (w, b, x))
    h = xt
    for s in range(S):
        h = torch.tanh(h @ wt[s] + bt[s])
    gw, gb, gx = torch.autograd.grad((h ** 2).sum(), [wt, bt, xt])
    return {"w": gw.numpy(), "b": gb.numpy(), "x": gx.numpy(), "out": h.detach().numpy()}


def test_gpipe_matches_sequential(tmp_path):
    w, b, x = _inputs()
    ref_t = torch.tensor(x)
    ref_j = jnp.asarray(x)
    for s in range(S):
        ref_t = torch.tanh(ref_t @ torch.tensor(w[s]) + torch.tensor(b[s]))
        ref_j = jnp.tanh(ref_j @ w[s] + b[s])
    np.testing.assert_allclose(ref_t.numpy(), np.asarray(ref_j), rtol=1e-5, atol=1e-5)
    for dtensor in (False, True):
        got = launch("pipeline", S, tmp_path, timeout=240, w=w.tolist(), b=b.tolist(),
                     x=x.tolist(), microbatches=[M, 4], dtensor=dtensor)
        for rank_out in got:
            for m in (M, 4):
                np.testing.assert_allclose(rank_out[m], ref_t.numpy(), rtol=1e-5, atol=1e-5)
                np.testing.assert_allclose(rank_out[m], np.asarray(ref_j), rtol=1e-5, atol=1e-5)
    assert abs(bubble_fraction(S, M) - 3 / 11) < 1e-9


@pytest.mark.parametrize("dtensor", [False, True], ids=["plain", "dtensor"])
def test_gpipe_gradients_match_sequential(tmp_path, dtensor):
    """Every rank's gradients for w, b and x equal the sequential loop's."""
    w, b, x = _inputs()
    want = _sequential_grads(w, b, x)
    got = launch("pipeline_grads", S, tmp_path, timeout=240, w=w.tolist(), b=b.tolist(),
                 x=x.tolist(), microbatches=[M, 4], dtensor=dtensor)
    for rank, rank_out in enumerate(got):
        for m in (M, 4):
            for k in ("out", "w", "b", "x"):
                np.testing.assert_allclose(rank_out[m][k], want[k], rtol=1e-5, atol=1e-5,
                                           err_msg=f"rank {rank}, M={m}, {k}")


def test_gpipe_gradients_match_reference(tmp_path):
    """The port's pipeline gradients equal the reference's ``jax.grad``
    through its own ``pipeline_apply`` on four forced host devices."""
    w, b, x = _inputs()
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    wait = start_reference(REFERENCE_GRADS, (w, b, x, [M, 4]), tmp_path, env, devices=S)
    got = launch("pipeline_grads", S, tmp_path, timeout=240, w=w.tolist(), b=b.tolist(),
                 x=x.tolist(), microbatches=[M, 4], dtensor=True)
    ref = wait()
    for m in (M, 4):
        for k in ("w", "b", "x"):
            np.testing.assert_allclose(got[0][m][k], ref[m][k], rtol=1e-5, atol=1e-5,
                                       err_msg=f"M={m}, {k}")
