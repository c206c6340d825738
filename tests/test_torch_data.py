"""The port's data pipeline (``repro_torch.data``) against the JAX
package's: the reference's ``tests/test_data.py`` on the port, then the
batches of both packages byte for byte (the numpy part is the
reference's, unchanged) for a text (llama3-8b), a vision (qwen2-vl-2b)
and an enc-dec (whisper-medium) arch at steps 0, 1 and 7 and two seeds,
with overrides of batch and sequence, and the device rule: the card
unless the CPU is asked for."""

import numpy as np
import pytest
import torch

import repro.configs as RC
from repro.data import DataConfig as RDataConfig
from repro.data import make_batch as r_make_batch
from repro_torch.configs import get_arch
from repro_torch.configs.base import ShapeSpec
from repro_torch.data import DataConfig, SyntheticPipeline, make_batch

SHAPE = ShapeSpec("tiny", 32, 4, "train")


def test_deterministic_across_restarts():
    cfg = get_arch("llama3-8b").reduced()
    b1 = make_batch(cfg, SHAPE, DataConfig(seed=3), step=17, device="cpu")
    b2 = make_batch(cfg, SHAPE, DataConfig(seed=3), step=17, device="cpu")
    np.testing.assert_array_equal(b1["tokens"].numpy(), b2["tokens"].numpy())
    b3 = make_batch(cfg, SHAPE, DataConfig(seed=4), step=17, device="cpu")
    assert not np.array_equal(b1["tokens"].numpy(), b3["tokens"].numpy())


def test_labels_are_shifted_tokens():
    cfg = get_arch("llama3-8b").reduced()
    b = make_batch(cfg, SHAPE, DataConfig(), step=0, device="cpu")
    assert b["tokens"].shape == (4, 32) and b["labels"].shape == (4, 32)
    # deterministic copy-structure: tokens repeat with the configured period
    toks = b["tokens"].numpy()
    assert (toks >= 0).all() and (toks < cfg.vocab).all()
    np.testing.assert_array_equal(b["tokens"][:, 1:].numpy(), b["labels"][:, :-1].numpy())


def test_vlm_batch_pads_vision_labels():
    cfg = get_arch("qwen2-vl-2b").reduced()
    b = make_batch(cfg, SHAPE, DataConfig(), step=0, device="cpu")
    nf = cfg.n_frontend_tokens
    assert b["frontend"].shape == (4, nf, cfg.d_model)
    labels = b["labels"].numpy()
    assert labels.shape == (4, nf + 32)
    assert (labels[:, :nf] == -1).all()  # vision slots are ignored in loss


def test_encdec_batch_has_frames():
    cfg = get_arch("whisper-medium").reduced()
    b = make_batch(cfg, SHAPE, DataConfig(), step=0, device="cpu")
    assert b["frontend"].shape == (4, cfg.n_frontend_tokens, cfg.d_model)


def test_pipeline_resumes_mid_stream():
    cfg = get_arch("llama3-8b").reduced()
    full = [b for _, b in zip(range(5), SyntheticPipeline(cfg, SHAPE, device="cpu"))]
    resumed = [b for _, b in zip(range(2), SyntheticPipeline(cfg, SHAPE, device="cpu",
                                                             start_step=3))]
    np.testing.assert_array_equal(full[3]["tokens"].numpy(), resumed[0]["tokens"].numpy())
    np.testing.assert_array_equal(full[4]["tokens"].numpy(), resumed[1]["tokens"].numpy())


@pytest.mark.parametrize("name", ["llama3-8b", "qwen2-vl-2b", "whisper-medium"])
@pytest.mark.parametrize("step", [0, 1, 7])
@pytest.mark.parametrize("seed", [0, 5])
def test_batches_are_the_references_byte_for_byte(name, step, seed):
    cfg, ref = get_arch(name).reduced(), RC.get_arch(name).reduced()
    got = make_batch(cfg, SHAPE, DataConfig(seed=seed), step, "cpu")
    want = r_make_batch(ref, SHAPE, RDataConfig(seed=seed), step)
    assert sorted(got) == sorted(want)
    for k in want:
        w = np.asarray(want[k])
        g = got[k].numpy()
        assert g.dtype == w.dtype and g.shape == w.shape, k
        assert g.tobytes() == w.tobytes(), k


def test_overrides_are_the_references():
    cfg, ref = get_arch("qwen2-vl-2b").reduced(), RC.get_arch("qwen2-vl-2b").reduced()
    got = make_batch(cfg, SHAPE, DataConfig(copy_period=5, noise=0.4), 3, "cpu",
                     batch_override=6, seq_override=19)
    want = r_make_batch(ref, SHAPE, RDataConfig(copy_period=5, noise=0.4), 3,
                        batch_override=6, seq_override=19)
    for k in want:
        assert got[k].numpy().tobytes() == np.asarray(want[k]).tobytes(), k
    assert got["tokens"].shape == (6, 19)


def test_the_card_is_the_default(monkeypatch):
    cfg = get_arch("llama3-8b").reduced()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_batch(cfg, SHAPE, DataConfig(), 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SyntheticPipeline(cfg, SHAPE)
