"""Gateway routing across cell families on the port, against the JAX
package's ``tests/test_gateway_lm.py``.

* The reference's own tests, run on the port: the ``workload``/``family``/
  ``models``/``ops`` selectors, cross-family ambiguity as a structured 400,
  HTTP answers byte-identical to the in-process :class:`LMServer`, the
  listing's LM routing, and the CLI's ``--workload lm`` path (the docs'
  question: Llama-3-8B decode at batch 64 under 64 chips), cold then warm.
* The port's LM server answers exactly as the reference's over the same
  numpy-built store, and the docs' answer is ``pod=1 data=4 model=16``
  (``best_index``: ``pod=2 data=2 model=16`` ties with it).
* The CLI's device rule for LM builds: ``--engine torch --device cpu``
  builds; on a miss, without ``--device`` and without a card, it exits 2.
"""

import json
import subprocess
import sys
import tempfile
import threading

import pytest

import repro.service as RS
from repro.configs import get_arch as r_get_arch
from repro.core.lmcells import enumerate_lm_hw_space as r_enumerate_lm_hw_space
from repro.core.lmcells import lm_workload as r_lm_workload
from repro_torch.configs import get_arch
from repro_torch.core import MAXWELL, enumerate_hw_space
from repro_torch.core.lmcells import enumerate_lm_hw_space, lm_workload
from repro_torch.core.timemodel import MAXWELL_GPU
from repro_torch.core.workload import paper_workload
from repro_torch.service import (
    ArtifactStore,
    CodesignServer,
    Gateway,
    GatewayClient,
    QueryRequest,
    RemoteError,
    serve_http,
    wire,
)
from repro_torch.service.gateway import AmbiguousWorkloadError
from repro_torch.service.server import LMServer

GPU = MAXWELL_GPU.name
MODEL = "llama3-8b-reduced"


@pytest.fixture(scope="module")
def fleet():
    """One store holding a stencil sweep and an LM sweep for the SAME gpu
    name, their oracle servers, a gateway, and a live HTTP endpoint."""
    root = tempfile.mkdtemp(prefix="lmgw-")
    store = ArtifactStore(root)
    ssrv = CodesignServer(
        store, workload=paper_workload(["heat2d", "jacobi2d"]), gpu=MAXWELL_GPU,
        hw=enumerate_hw_space(MAXWELL, max_area=650.0).downsample(64),
        engine="numpy", batch_window=0.0,
    )
    ssrv.ensure_artifact()
    lsrv = LMServer(
        store, workload=lm_workload(archs=[get_arch("llama3-8b").reduced()], name="lm"),
        hw=enumerate_lm_hw_space(max_chips=32), engine="numpy", gpu_name=GPU,
        batch_window=0.0,
    )
    lsrv.ensure_artifact()
    gw = Gateway(root, batch_window=0.0)
    httpd = serve_http(gw)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    url = "http://%s:%d" % httpd.server_address[:2]
    yield ssrv, lsrv, gw, url
    httpd.shutdown()
    httpd.server_close()


def _req(**kw):
    kw.setdefault("freqs", {f"{MODEL}:decode": 1.0})
    kw.setdefault("use_cache", False)
    return QueryRequest(**kw)


LM_REQUESTS = (
    dict(max_area=16.0, top_k=3, pareto=True),
    dict(freqs={MODEL: 1.0}, top_k=5),               # model-level group
    dict(freqs={"train": 1.0}, fix={"model": 2.0}),  # op group + what-if
    dict(max_area=0.5),                              # infeasible budget
)


def test_cross_family_ambiguity_is_structured_400(fleet):
    _, _, gw, url = fleet
    with pytest.raises(AmbiguousWorkloadError) as ei:
        gw.resolve(route={"gpu": GPU})
    assert ei.value.code == "ambiguous_workload"
    assert ei.value.http_status == 400
    assert "workload" in str(ei.value)
    assert (wire.ERROR_HTTP_STATUS["ambiguous_workload"]
            == wire.ERROR_HTTP_STATUS["wrong_artifact_kind"] == 400)
    with pytest.raises(RemoteError) as ei:
        GatewayClient(url).query(_req(), route={"gpu": GPU})
    assert ei.value.code == "ambiguous_workload"
    assert ei.value.http_status == 400


def test_workload_and_family_selectors_resolve(fleet):
    ssrv, lsrv, gw, _ = fleet
    assert gw.resolve(route={"gpu": GPU, "workload": "lm"}) == lsrv.key
    assert gw.resolve(route={"gpu": GPU, "family": "lm"}) == lsrv.key
    assert gw.resolve(route={"gpu": GPU, "family": "stencil"}) == ssrv.key
    assert gw.resolve(route={"workload": "paper-uniform"}) == ssrv.key
    with pytest.raises(Exception, match="no stored artifact"):
        gw.resolve(route={"workload": "nope"})


def test_models_and_ops_subset_selectors(fleet):
    ssrv, lsrv, gw, _ = fleet
    assert gw.resolve(route={"models": [MODEL]}) == lsrv.key
    assert gw.resolve(route={"ops": ["decode", "train"]}) == lsrv.key
    with pytest.raises(Exception, match="no stored artifact"):
        gw.resolve(route={"ops": ["decode", "backprop"]})
    assert gw.resolve(route={"stencils": ["heat2d"]}) == ssrv.key


def test_http_lm_answers_are_byte_identical_to_in_process(fleet):
    _, lsrv, _, url = fleet
    client = GatewayClient(url)
    route = {"gpu": GPU, "workload": "lm"}
    for kw in LM_REQUESTS:
        req = _req(**kw)
        assert client.query_bytes(req, route=route) == wire.encode_response(lsrv.query(req))
    resp = client.query(_req(max_area=16.0, top_k=3), route=route)
    assert resp.best_index >= 0
    assert set(resp.best_point) == {"pod", "data", "model", "chips"}
    assert resp.best_point["chips"] <= 16


def test_unknown_group_is_bad_request(fleet):
    _, _, _, url = fleet
    with pytest.raises(RemoteError) as ei:
        GatewayClient(url).query(
            _req(freqs={"not-a-group": 1.0}), route={"gpu": GPU, "workload": "lm"}
        )
    assert ei.value.code == "bad_request"
    assert ei.value.http_status == 400


def test_artifact_listing_carries_lm_routing(fleet):
    _, lsrv, gw, _ = fleet
    rows = {r["key"]: r for r in gw.entries()}
    row = rows[lsrv.key]
    assert row["family"] == "lm"
    assert row["models"] == [MODEL]
    assert row["ops"] == ["decode", "prefill", "train"]
    stencil_rows = [r for r in rows.values() if r.get("family", "stencil") == "stencil"]
    assert stencil_rows and all("models" not in r for r in stencil_rows)


def test_port_lm_server_answers_as_the_references(fleet):
    """The reference's LMServer over the port's numpy-built LM artifact
    (same key as the reference would build) gives the same wire bytes."""
    _, lsrv, _, _ = fleet
    rstore = RS.ArtifactStore(lsrv.store.root)
    rsrv = RS.LMServer(
        rstore, workload=r_lm_workload(archs=[r_get_arch("llama3-8b").reduced()], name="lm"),
        hw=r_enumerate_lm_hw_space(max_chips=32), engine="numpy", gpu_name=GPU,
        batch_window=0.0,
    )
    assert rsrv.key == lsrv.key and rsrv.warm
    for kw in LM_REQUESTS:
        want = wire.encode_response(lsrv.query(_req(**kw)))
        got = RS.wire.encode_response(rsrv.query(RS.QueryRequest(**dict(
            {"freqs": {f"{MODEL}:decode": 1.0}, "use_cache": False}, **kw))))
        assert got == want


def _cli(env, *args):
    return subprocess.run([sys.executable, "-m", "repro_torch.service.cli", *args],
                          env=env, capture_output=True, text=True, timeout=300)


def test_cli_workload_lm_end_to_end(subprocess_env, tmp_path):
    """The docs' question: the chip config for Llama-3-8B decode at batch
    64 under a 64-chip budget (cold build, then warm, byte-identical)."""
    args = ["query", "--store", str(tmp_path), "--workload", "lm", "--arch", "llama3-8b",
            "--chips", "64", "--engine", "numpy", "--freq", "llama3-8b:decode=1",
            "--max-area", "64", "--top-k", "3", "--json"]
    out = _cli(subprocess_env, *args)
    assert out.returncode == 0, out.stderr
    data = json.loads(out.stdout)
    assert data["feasible"]
    best = {k: data["best"][k] for k in ("pod", "data", "model", "chips")}
    assert best == {"pod": 1, "data": 4, "model": 16, "chips": 64}
    assert len(data["top_k"]) <= 3
    again = _cli(subprocess_env, *args)
    assert again.returncode == 0, again.stderr
    d2 = json.loads(again.stdout)
    assert d2["origin"] == "warm" and d2["best"] == data["best"]


def test_cli_rejects_lm_flags_without_lm_workload(subprocess_env, tmp_path):
    out = _cli(subprocess_env, "query", "--store", str(tmp_path), "--arch", "llama3-8b")
    assert out.returncode == 2
    assert "--workload lm" in out.stderr and "Traceback" not in out.stderr


def test_cli_lm_torch_build_needs_a_card_or_cpu(subprocess_env, tmp_path):
    env = dict(subprocess_env, CUDA_VISIBLE_DEVICES="")
    base = ["build", "--store", str(tmp_path), "--workload", "lm", "--arch", "llama3-8b",
            "--engine", "torch"]
    out = _cli(env, *base)
    assert out.returncode == 2 and out.stdout == ""
    lines = out.stderr.strip().splitlines()
    assert len(lines) == 1 and "no CUDA device" in lines[0], out.stderr
    out = _cli(env, *base, "--device", "cpu")
    assert out.returncode == 0, out.stderr
    assert "built" in out.stdout and "gpu=tpu_v5e" in out.stdout
    (row,) = ArtifactStore(str(tmp_path)).entries()
    assert row["family"] == "lm" and row["engine"] == "torch"
