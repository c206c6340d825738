"""The port's roofline (``repro_torch.launch.roofline``) against the
reference's (``repro.launch.roofline``).

Each package's dry run writes the tiny InternLM2 train cell on both tiny
meshes (children, fake process groups / forced host devices). With the
port's ``HW`` set to the reference's TPU constants, the two packages'
``analyze_cell`` and ``render_table`` give identical rows on each
other's records (but for the lever's text, which names the H100's
tensor cores and NVLink); each package's roofline CLI reads the other's records;
and the port's own ``HW`` holds the H100 SXM's data-sheet numbers.
"""

import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import pytest

from repro.configs.base import SHAPES as REF_SHAPES
from repro.launch import roofline as ref_roofline
from repro_torch.configs.base import SHAPES
from repro_torch.launch import roofline

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _env(**extra):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), JAX_PLATFORMS="cpu",
               OMP_NUM_THREADS="1")
    env.update(extra)
    return env


@pytest.fixture(scope="module")
def outdirs(tmp_path_factory):
    """{"port": dir, "reference": dir} of the tiny train cell on both meshes."""
    dirs = {k: str(tmp_path_factory.mktemp(k)) for k in ("port", "reference")}
    cell = ["--tiny", "--arch", "internlm2-1.8b", "--shape", "train_4k", "--mesh", "both"]
    cmds = {
        "port": ([sys.executable, "-m", "repro_torch.launch.dryrun", *cell, "--device", "cpu",
                  "--out", dirs["port"]], _env()),
        "reference": ([sys.executable, "-m", "repro.launch.dryrun", *cell, "--out",
                       dirs["reference"]], _env(REPRO_DRYRUN_DEVICES="8")),
    }
    with ThreadPoolExecutor(2) as pool:
        procs = dict(pool.map(lambda kv: (kv[0], subprocess.run(
            kv[1][0], capture_output=True, text=True, env=kv[1][1], cwd=ROOT, timeout=600)),
            cmds.items()))
    for k, p in procs.items():
        assert p.returncode == 0, f"{k}: {p.stderr[-3000:]}"
    return dirs


@pytest.mark.parametrize("owner", ["port", "reference"])
@pytest.mark.parametrize("mesh", ["single", "multi"])
def test_rows_identical_on_each_others_records(outdirs, monkeypatch, owner, mesh):
    monkeypatch.setattr(roofline, "HW", dict(ref_roofline.HW))
    recs = roofline.load_cells(outdirs[owner], mesh)
    assert recs == ref_roofline.load_cells(outdirs[owner], mesh) and len(recs) == 1
    got = [roofline.analyze_cell(r, SHAPES) for r in recs]
    want = [ref_roofline.analyze_cell(r, REF_SHAPES) for r in recs]
    for g, w in zip(got, want):  # the lever's words are the card's (tensor cores, NVLink)
        assert g["lever"] == roofline._LEVERS[w["dominant"]]
        assert {k: v for k, v in g.items() if k != "lever"} == \
            {k: v for k, v in w.items() if k != "lever"}
    assert roofline.render_table(got) == ref_roofline.render_table(want)
    assert roofline.roofline_terms(recs[0]) == ref_roofline.roofline_terms(recs[0])


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_model_flops_for_matches_reference(kind):
    rec = {"params": 1_000, "active_params": 400, "kind": kind}
    assert roofline.model_flops_for(rec, 4096, 8) == ref_roofline.model_flops_for(rec, 4096, 8)


@pytest.mark.parametrize("module", ["repro_torch.launch.roofline", "repro.launch.roofline"])
@pytest.mark.parametrize("owner", ["port", "reference"])
def test_cli_reads_records(outdirs, tmp_path, module, owner):
    """Each package's roofline CLI reads each package's records."""
    out = tmp_path / "rows.json"
    proc = subprocess.run([sys.executable, "-m", module, "--out", outdirs[owner], "--mesh",
                           "single", "--json", str(out)], capture_output=True, text=True,
                          env=_env(), cwd=ROOT, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    rows = json.loads(out.read_text())
    assert [r["arch"] for r in rows] == ["internlm2-1.8b"]
    assert proc.stdout.splitlines()[0].startswith("| arch | shape |")


def test_hw_is_the_h100():
    """NVIDIA's data sheet for the H100 SXM5 80 GB at 700 W: dense bf16,
    HBM3, 18 NVLink 4 links of 25 GB/s per direction each."""
    assert roofline.HW == {"peak_flops_bf16": 989e12, "hbm_bw": 3.35e12,
                           "ici_link_bw": 25e9, "ici_links": 18, "hbm_bytes": 80e9}
    assert set(roofline._LEVERS) == set(ref_roofline._LEVERS)
    assert not any(w in text for text in roofline._LEVERS.values() for w in ("MXU", "ICI"))
