"""The port's ``compressed_psum`` (``repro_torch.optim.compression``) over
gloo ranks against the JAX package's under ``shard_map``, bit for bit.

Four CPU ranks each hold their own numpy-seeded row; the port sums them
over the world's group and over the ``data`` dim of a ``(pod, data) =
(2, 2)`` mesh. The reference runs the same rows through its
``compressed_psum`` inside ``shard_map`` on four forced host devices, in a
subprocess (``tests/test_pipeline.py``'s way of getting a multi-device
JAX). Both results equal the plain quantize -> int32 sum -> dequantize,
computed here in numpy.
"""

import os
import subprocess
import sys
import textwrap

import numpy as np

from _torch_spmd import launch

REF = textwrap.dedent(
    """
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import Mesh, PartitionSpec as P
    from repro.core.sweep import shard_map
    from repro.optim.compression import compressed_psum

    xs = np.load(sys.argv[1])
    out = {}
    for name, shape, axes, axis in (("world", (4,), ("x",), "x"),
                                    ("sub", (2, 2), ("pod", "data"), "data")):
        mesh = Mesh(np.array(jax.devices()).reshape(shape), axes)
        f = shard_map(lambda x: compressed_psum(x[0], axis)[None], mesh=mesh,
                      in_specs=P(axes), out_specs=P(axes))
        out[name] = np.asarray(f(jnp.asarray(xs)))  # rows over every axis, in order
    np.savez(sys.argv[2], **out)
    """
)


def _plain(rows):
    """quantize -> int32 sum -> dequantize of a group's rows, in f32."""
    scale = np.float32(max(np.abs(rows).max(), np.float32(1e-12))) / np.float32(127.0)
    q = np.clip(np.round(rows / scale), -127, 127).astype(np.int8)
    return q.astype(np.int32).sum(0).astype(np.float32) * scale


def test_compressed_psum_equals_the_reference_bit_for_bit(tmp_path, subprocess_env):
    rng = np.random.default_rng(0)
    xs = (rng.standard_normal((4, 96)) * np.array([[1.0], [3.0], [0.01], [30.0]])).astype(np.float32)
    xs[2, :5] = 0.0
    np.save(tmp_path / "xs.npy", xs)
    proc = subprocess.run(
        [sys.executable, "-c", REF, str(tmp_path / "xs.npy"), str(tmp_path / "ref.npz")],
        capture_output=True, text=True, env=subprocess_env, timeout=300,
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    ref = np.load(tmp_path / "ref.npz")
    got = launch("compressed_psum", 4, tmp_path, timeout=240, xs=xs.tolist(), sub="data")
    for r in range(4):
        np.testing.assert_array_equal(got[r]["world"], ref["world"][r])
        np.testing.assert_array_equal(got[r]["sub"], ref["sub"][r])
        np.testing.assert_array_equal(got[r]["world"], _plain(xs))
        pair = xs[(r // 2) * 2:(r // 2) * 2 + 2]
        np.testing.assert_array_equal(got[r]["sub"], _plain(pair))
