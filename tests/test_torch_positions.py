"""Position ids on a mesh follow the tokens' layout, as the reference's
``_text_positions(..., like=tokens)`` hands them the tokens' sharding.

On a ``(2, 2)`` mesh of four gloo ranks, every ``stack_apply`` call of
the reduced InternLM2 (rope), Whisper (the encoder's ids and the learned
position lookup) and Qwen2-VL (M-RoPE, with the vision prefix at prefill)
gets ids placed as its rows are over ``data`` -- ``Shard(0)`` where the
batch divides the data axis, replicated where it does not (a batch of 1)
-- and replicated over ``model``, never a plain tensor that every rank
would hold at the global batch: through ``generate_timed`` (prefill and
decode) and through a train step of two microbatches. The values stay
one device's: tokens identical and logits within f32 1e-4 (the serving
tolerance of ``tests/test_torch_serve_mesh.py``), metrics and state as
``tests/test_torch_mesh_train.py`` holds them.
"""

import numpy as np

import test_torch_mesh_train as mesh_train
import test_torch_serve_mesh as serve_mesh
from _torch_spmd import launch

SERVE_RUNS = [("internlm2-1.8b", 2, 12, 3), ("whisper-medium", 2, 12, 3),
              ("qwen2-vl-2b", 2, 12, 3), ("internlm2-1.8b", 1, 12, 2)]
TRAIN_RUNS = [("whisper-medium", 2), ("qwen2-vl-2b", 2)]
SHARDED, REPLICATED = "(Shard(dim=0), Replicate())", "(Replicate(), Replicate())"


def test_position_ids_follow_the_tokens(tmp_path):
    out = launch("positions", 4, tmp_path, timeout=420, serve_runs=[list(r) for r in SERVE_RUNS],
                 train_runs=[list(r) for r in TRAIN_RUNS], shape=[2, 2], axes=["data", "model"],
                 seq=mesh_train.SEQ, batch=mesh_train.BATCH)
    got = out[0]
    for (arch, b, s, steps), run in zip(SERVE_RUNS, got["serve"]):
        modes = [c["mode"] for c in run["ids"]]
        # prefill (the encoder first for whisper), then a call per decode step
        assert modes.count("causal") == steps, (arch, modes)
        assert modes.count("bidir") == (arch == "whisper-medium"), (arch, modes)
        want = SHARDED if b % 2 == 0 else REPLICATED
        assert {c["placements"] for c in run["ids"]} == {want}, (arch, b, run["ids"])
        single, _ = serve_mesh._single(arch, b, s, steps)
        np.testing.assert_array_equal(run["tokens"], single["tokens"].numpy())
        serve_mesh._close(run["prefill_logits"], single["prefill_logits"].numpy(), arch)
        serve_mesh._close(run["logits"], [x.numpy() for x in single["logits"]], arch)
    for (arch, micro), run in zip(TRAIN_RUNS, got["train"]):
        assert len(run["ids"]) == micro * (1 + (arch == "whisper-medium")), (arch, run["ids"])
        assert {c["placements"] for c in run["ids"]} == {SHARDED}, (arch, run["ids"])
        want, want_metrics = mesh_train._single(arch, False, micro, False, "dots")
        mesh_train._assert_matches(run["state"], run["metrics"], want, want_metrics)
    for rank_out in out[1:]:  # every rank builds its ids alike
        assert [r["ids"] for r in rank_out["serve"] + rank_out["train"]] == \
            [r["ids"] for r in got["serve"] + got["train"]]
