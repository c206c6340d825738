"""The port's serve steps on a mesh of gloo ranks against the JAX
package's serve steps on a mesh of forced host devices, and against its
own single-device serve.

``generate_timed(..., mesh=)`` places the seed-0 model by
``param_specs`` and the caches by ``cache_specs`` and greedy-decodes on
``(data, model) = (1, 4)`` and ``(2, 2)`` meshes of four CPU ranks:
llama3-8b (its 2 reduced kv heads are fewer than the 4-wide model axis,
so the kv projection is gathered before it splits into heads) and
mixtral-8x22b (MoE, experts over ``model``) with a batch of 2, and on
``(2, 2)`` also a batch of 1, which cannot shard over data, so the caches
shard their length over data instead (the long-context fallback). The
reference's ``make_prefill``/``make_decode_step`` serve the same weights
and prompts on a mesh of the same shape over four forced host devices,
in a subprocess beside the ranks (the loop of its ``generate``, keeping
the logits). The tokens equal the reference's and the single-device
serve's exactly; the prefill and decode logits agree with both, and every
cache leaf after the last step with the single-device serve's, within
f32 1e-4 (PR 16's serving tolerance).
"""

import textwrap

import numpy as np
import pytest
import torch

from _torch_spmd import case_serve, gathered_caches, launch, serve_batch, start_reference  # noqa: F401
from repro_torch.configs import get_arch
from repro_torch.models import Model
from repro_torch.models.convert import train_state_to_reference
from repro_torch.serve import generate_timed

TOL = dict(rtol=1e-4, atol=1e-4)
RUNS = {
    (1, 4): [("llama3-8b", 2, 12, 4), ("mixtral-8x22b", 2, 12, 4)],
    (2, 2): [("llama3-8b", 2, 12, 4), ("mixtral-8x22b", 2, 12, 4), ("llama3-8b", 1, 12, 4)],
}


#: the JAX package's serve loop (its ``generate``, keeping the logits) on
#: a mesh of four forced host devices
REF = textwrap.dedent(
    """
    import pickle, sys
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import Mesh
    import repro.configs as RC
    from repro.serve.serve_step import greedy, make_decode_step, make_prefill

    payload = pickle.load(open(sys.argv[1], "rb"))
    mesh = Mesh(np.array(jax.devices()[:4]).reshape(payload["shape"]), ("data", "model"))
    out = []
    for run in payload["runs"]:
        cfg = RC.get_arch(run["arch"]).reduced()
        tokens, steps = run["tokens"], run["steps"]
        b, s = tokens.shape
        prefill = make_prefill(cfg, mesh, max_len=s + steps)
        decode = make_decode_step(cfg, mesh)
        logits, caches = prefill(run["params"], {"tokens": jnp.asarray(tokens)})
        r = {"prefill_logits": np.asarray(logits), "logits": []}
        tok, toks = greedy(logits), []
        toks.append(tok)
        for pos in range(s, s + steps - 1):
            logits, caches = decode(run["params"], tok[:, None], caches, jnp.int32(pos))
            tok = greedy(logits)
            toks.append(tok)
            r["logits"].append(np.asarray(logits))
        r["tokens"] = np.asarray(jnp.stack(toks, axis=1))
        out.append(r)
    pickle.dump(out, open(sys.argv[2], "wb"))
    """
)


def _reference_params(model):
    """The port model's weights as the reference's parameter tree."""
    named = dict(model.named_parameters())
    state = {"params": model, "opt": {"m": named, "v": named, "step": torch.zeros((), dtype=torch.int32)}}
    return train_state_to_reference(state)["params"]


def _single(arch, b, s, steps):
    cfg = get_arch(arch).reduced()
    r = generate_timed(Model(cfg, device="cpu"), cfg, serve_batch(cfg, b, s), steps, device="cpu")
    return r, gathered_caches(r["caches"])


def _close(got, want, path=""):
    if isinstance(want, dict):
        assert got.keys() == want.keys(), path
        for k in want:
            _close(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, list):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _close(g, w, f"{path}/{i}")
    elif want is None:
        assert got is None, path
    else:
        assert got.shape == want.shape and got.dtype == want.dtype, path
        np.testing.assert_allclose(got, want, **TOL, err_msg=path)


@pytest.mark.parametrize("shape", sorted(RUNS), ids=lambda s: "x".join(map(str, s)))
def test_mesh_serve_matches_single_device(shape, tmp_path, subprocess_env):
    runs = RUNS[shape]
    payload = {"shape": list(shape), "runs": []}
    for arch, b, s, steps in runs:
        cfg = get_arch(arch).reduced()
        payload["runs"].append({"arch": arch, "steps": steps,
                                "tokens": serve_batch(cfg, b, s)["tokens"].numpy(),
                                "params": _reference_params(Model(cfg, device="cpu"))})
    reference = start_reference(REF, payload, tmp_path, subprocess_env, timeout=300)
    out = launch("serve", 4, tmp_path, timeout=300, runs=[list(r) for r in runs],
                 shape=list(shape), axes=["data", "model"])
    for run, got, ref in zip(runs, out[0], reference()):
        np.testing.assert_array_equal(got["tokens"], ref["tokens"])
        np.testing.assert_allclose(got["prefill_logits"], ref["prefill_logits"], **TOL)
        _close(got["logits"], ref["logits"], "logits")
        want, want_caches = _single(*run)
        np.testing.assert_array_equal(got["tokens"], want["tokens"].numpy())
        np.testing.assert_allclose(got["prefill_logits"], want["prefill_logits"].numpy(), **TOL)
        _close(got["logits"], [x.numpy() for x in want["logits"]], "logits")
        _close(got["caches"], want_caches, "caches")
    for rank_out in out[1:]:  # every rank holds the same tokens
        for got, mine in zip(rank_out, out[0]):
            np.testing.assert_array_equal(got["tokens"], mine["tokens"])
