"""The port's GPipe schedule (``repro_torch.train.pipeline``) against the
sequential loop, in the port and in the JAX package.

The reference's ``tests/test_pipeline.py`` on the port: four gloo ranks
(one per stage), S = 4, M in {8, 4}, stage parameters as plain stacked
tensors and as DTensors sharded over the ``stage`` dim. Every rank's
result equals the port's sequential loop and the reference's sequential
loop on the same numpy inputs within 1e-5, and ``bubble_fraction(4, 8)
= 3/11``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_spmd import launch
from repro_torch.train.pipeline import bubble_fraction, pipeline_apply

S, M, B, D = 4, 8, 16, 32


def _inputs():
    rng = np.random.default_rng(0)
    w = (rng.standard_normal((S, D, D)) * 0.2).astype(np.float32)
    b = (rng.standard_normal((S, D)) * 0.1).astype(np.float32)
    x = rng.standard_normal((B, D)).astype(np.float32)
    return w, b, x


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


def test_pipeline_refuses_autograd():
    class _Mesh:
        mesh_dim_names = ("stage",)

    w = torch.zeros((S, D, D), requires_grad=True)
    with pytest.raises(NotImplementedError, match="forward only"):
        pipeline_apply(lambda p, h: h, {"w": w}, torch.zeros(B, D), _Mesh(), M)
