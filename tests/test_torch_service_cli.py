"""The port's service CLI, ``python -m repro_torch.service.cli``.

* The steps of the JAX package's ``scripts/gateway_smoke.py`` and
  ``scripts/portfolio_smoke.py``, pointed at the port's CLI as child
  processes: numpy builds for gtx980 and titanx, a K=2 throughput
  portfolio over each (a rebuild is a stored no-op on the same key), a
  ``serve --port 0`` child whose ``/v1/query`` and ``/v1/route`` bodies
  are byte-identical to the in-process servers, metrics and SLO scrapes
  that count the traffic issued, and the structured error paths.
* The port's device rule, in process: ``build``, ``query`` on a miss and
  ``portfolio`` (whose default engine is torch) without ``--device`` and
  without a card exit 2 with one line; ``--device cpu`` runs them on the
  CPU, and ``--portfolio-engine numpy`` (the oracle) needs no device;
  ``build --workload lm`` follows the same rule. ``serve`` needs no card:
  its child runs with the card hidden.
"""

import json
import math
import os
import re
import subprocess
import sys
import threading

import numpy as np
import pytest

from repro_torch.core.portfolio import optimize_portfolio_arrays
from repro_torch.service import (
    ArtifactStore,
    CodesignServer,
    GatewayClient,
    PortfolioServer,
    QueryRequest,
    RouteRequest,
    cli,
    wire,
)

CLI = [sys.executable, "-m", "repro_torch.service.cli"]
GPUS = ("gtx980", "titanx")
DOWNSAMPLE = "48"
BUDGET = 900.0
SRC = os.path.abspath(os.path.join(os.path.dirname(__file__), os.pardir, "src"))


def _env():
    """The children import the port from ``src`` and see no card."""
    env = dict(os.environ)
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    env["PYTHONUNBUFFERED"] = "1"
    env["CUDA_VISIBLE_DEVICES"] = ""
    return env


def _run(args):
    return subprocess.run(CLI + args, capture_output=True, text=True, env=_env(),
                          timeout=300)


@pytest.fixture(scope="module")
def cli_store(tmp_path_factory):
    """Per GPU, in parallel: ``build --engine numpy``, then ``portfolio
    --k 2 --budget 900 --objective throughput --device cpu`` twice."""
    root = str(tmp_path_factory.mktemp("cli-store"))
    out = {}

    def chain(gpu):
        base = ["--store", root, "--gpu", gpu, "--engine", "numpy",
                "--downsample", DOWNSAMPLE]
        pf = ["--k", "2", "--budget", str(BUDGET), "--objective", "throughput",
              "--device", "cpu"]
        out[gpu] = [_run(["build"] + base), _run(["portfolio"] + base + pf),
                    _run(["portfolio"] + base + pf)]

    threads = [threading.Thread(target=chain, args=(gpu,)) for gpu in GPUS]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for gpu in GPUS:
        for r in out[gpu]:
            assert r.returncode == 0, r.stderr
    return root, out


@pytest.fixture(scope="module")
def served(cli_store):
    """A ``serve --port 0`` child over the store (card hidden), its URL read
    off its stdout, and the in-process oracles over the same artifacts."""
    root, _ = cli_store
    store = ArtifactStore(root)
    sweeps, portfolios = {}, {}
    for row in store.entries():
        art = store.get(row["key"])
        if row["kind"] == "sweep":
            sweeps[row["gpu"]] = CodesignServer.from_artifact(store, art, batch_window=0.0)
        elif row["kind"] == "portfolio":
            portfolios[row["gpu"]] = PortfolioServer(art, store.get(art.payload["sweep_key"]))
    proc = subprocess.Popen(CLI + ["serve", "--store", root, "--port", "0"],
                            stdout=subprocess.PIPE, text=True, env=_env())
    url = None
    for line in proc.stdout:  # the bound port is printed last
        m = re.search(r"serving on (http://\S+)", line)
        if m:
            url = m.group(1)
            break
    try:
        assert url is not None, "serve printed no bound address"
        yield GatewayClient(url), sweeps, portfolios
    finally:
        proc.terminate()
        proc.wait(timeout=30)
        proc.stdout.close()


REQUESTS = (
    QueryRequest(freqs={"heat2d": 3.0, "jacobi2d": 1.0}, max_area=450.0, top_k=3,
                 use_cache=False),
    QueryRequest(freqs={"heat3d": 1.0}, pareto=True, fix={"n_sm": 16.0}, use_cache=False),
    QueryRequest(max_area=1.0, use_cache=False),  # infeasible: -inf
)


def _query_count(client):
    snap = client.metrics()
    return sum(s["value"] for s in snap["repro_gateway_requests_total"]["samples"]
               if s["labels"].get("route") == "/v1/query")


# ---------------------------------------------------------------------------
# the gateway smoke's steps
# ---------------------------------------------------------------------------
def test_cli_builds_one_sweep_and_one_portfolio_per_gpu(cli_store):
    root, out = cli_store
    rows = ArtifactStore(root).entries()
    assert sorted(r["gpu"] for r in rows if r["kind"] == "sweep") == sorted(GPUS)
    assert sorted(r["gpu"] for r in rows if r["kind"] == "portfolio") == sorted(GPUS)
    for gpu in GPUS:
        build, first, again = out[gpu]
        assert re.search(r"^artifact [0-9a-f]{20}: built", build.stdout, re.M)
        key = re.search(r"^portfolio ([0-9a-f]{20}): built", first.stdout, re.M).group(1)
        assert f"portfolio {key}: already stored" in again.stdout


def test_cli_ls_lists_both_kinds(cli_store, capsys):
    root, _ = cli_store
    cli.main(["ls", "--store", root])
    out = capsys.readouterr().out
    assert out.count("kind=portfolio") == 2 and "gpu=titanx" in out


@pytest.mark.parametrize("gpu", GPUS)
def test_http_query_is_byte_identical_to_in_process(served, gpu):
    client, sweeps, _ = served
    oracle = sweeps[gpu]
    for req in REQUESTS:
        raw = client.query_bytes(req, route={"gpu": gpu})
        assert raw == wire.encode_response(oracle.query(req))
        assert wire.decode_response(raw).artifact_key == oracle.key


def test_metrics_scrape_counts_the_traffic(served):
    client, sweeps, _ = served
    before = _query_count(client)
    per_art0 = {s["labels"]["artifact"]: s["value"] for s in
                client.metrics()["repro_gateway_artifact_requests_total"]["samples"]}
    for gpu, oracle in sweeps.items():
        for req in REQUESTS:
            client.query(req, route={"gpu": gpu})
    assert _query_count(client) - before == len(sweeps) * len(REQUESTS)
    per_art = {s["labels"]["artifact"]: s["value"] for s in
               client.metrics()["repro_gateway_artifact_requests_total"]["samples"]}
    for oracle in sweeps.values():
        assert per_art[oracle.key] - per_art0.get(oracle.key, 0) == len(REQUESTS)
    text = client.metrics("prometheus")
    sample_re = re.compile(r'^[a-zA-Z_:][a-zA-Z0-9_:]*(\{[^}]*\})? -?[0-9.e+-]+$')
    lines = [ln for ln in text.splitlines() if ln and not ln.startswith("#")]
    assert lines and all(sample_re.match(ln) for ln in lines)
    assert "# TYPE repro_gateway_requests_total counter" in text
    rows = {r["key"]: r for r in client.artifacts()}
    assert all(rows[o.key]["hits"] >= len(REQUESTS) and rows[o.key]["last_access"]
               for o in sweeps.values())


def test_slo_and_healthz_scrape(served):
    client, sweeps, _ = served
    client.query(REQUESTS[0], route={"gpu": GPUS[0]})
    slo = client.slo()
    q = slo["routes"]["/v1/query"]
    assert set(q["windows"]) == {"5m", "1h"}
    assert all(math.isfinite(w["availability_burn"]) and math.isfinite(w["latency_burn"])
               for w in q["windows"].values())
    assert q["windows"]["1h"]["count"] == _query_count(client)
    assert q["status"] in ("ok", "burning", "violated")
    health = client.health()
    assert health["ok"] and health["slo"] in ("ok", "burning", "violated")
    assert health["artifacts"] == 4
    assert "repro_slo_burn_rate" in client.slo("prometheus")


def test_structured_error_paths_leave_the_server_up(served):
    client, _, _ = served
    with pytest.raises(wire.RemoteError) as exc:
        client.query(REQUESTS[0], artifact="0" * 20)
    assert exc.value.code == "unknown_artifact" and exc.value.http_status == 404
    bad = client._http("/v1/query", b"{not json")
    with pytest.raises(wire.RemoteError) as exc:
        wire.decode_response(bad, client._last_status)
    assert exc.value.code == "bad_request" and client._last_status == 400
    assert client.health()["ok"]


def test_serve_on_a_missing_store_exits_2(tmp_path):
    r = _run(["serve", "--store", str(tmp_path / "nope"), "--port", "0"])
    assert r.returncode == 2 and "error:" in r.stderr and "Traceback" not in r.stderr


# ---------------------------------------------------------------------------
# the portfolio smoke's steps
# ---------------------------------------------------------------------------
def test_fleet_objective_is_at_least_the_best_single_design(cli_store):
    root, _ = cli_store
    store = ArtifactStore(root)
    for row in store.entries():
        if row["kind"] != "portfolio":
            continue
        art = store.get(row["key"])
        sweep = store.get(art.payload["sweep_key"])
        freqs = sweep.cell_freqs()
        g = (freqs @ sweep.cell_flops()) / (freqs @ np.asarray(sweep.cell_time)) / 1.0e9
        best_single = float(np.max(np.where(sweep.hw_area <= BUDGET, g, -np.inf)))
        assert art.payload["fleet_gflops"] >= best_single * (1 - 1e-12)


def test_http_route_is_byte_identical_to_in_process(served):
    client, _, portfolios = served
    n = 0
    for gpu, oracle in portfolios.items():
        for cell in oracle.cell_labels():
            req = RouteRequest(cell=cell)
            raw = client.route_bytes(req, route={"gpu": gpu})
            assert raw == wire.encode_route_response(oracle.route(req))
            resp = wire.decode_route_response(raw)
            assert not resp.degraded and resp.hw_index in oracle.members
            n += 1
    assert n >= 2 * len(GPUS)


def test_route_error_paths(served):
    client, _, portfolios = served
    with pytest.raises(wire.RemoteError) as exc:
        client.route("not-a-cell", route={"gpu": GPUS[0]})
    assert exc.value.code == "unknown_cell" and exc.value.http_status == 404
    with pytest.raises(wire.RemoteError) as exc:
        client.route("heat2d", artifact=portfolios[GPUS[0]].sweep.key)
    assert exc.value.code == "wrong_artifact_kind"
    assert client.health()["ok"]


def test_cli_route_in_process_and_over_http(cli_store, served, capsys):
    root, _ = cli_store
    client, _, portfolios = served
    cli.main(["route", "heat2d", "--store", root, "--gpu", "titanx", "--json"])
    local = json.loads(capsys.readouterr().out)
    cli.main(["route", "heat2d", "--url", client.base_url, "--gpu", "titanx", "--json"])
    remote = json.loads(capsys.readouterr().out)
    assert local == remote
    assert local["hw_index"] in portfolios["titanx"].members


# ---------------------------------------------------------------------------
# the port's device rule
# ---------------------------------------------------------------------------
def _exit_2_one_line(argv, capsys, match):
    with pytest.raises(SystemExit) as exc:
        cli.main(argv)
    assert exc.value.code == 2
    err = capsys.readouterr().err.strip().splitlines()
    assert len(err) == 1 and err[0].startswith("error:") and match in err[0], err


def test_no_card_without_device_exits_2(cli_store, tmp_path, capsys, monkeypatch):
    import torch

    root, _ = cli_store
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    empty = str(tmp_path / "empty")
    _exit_2_one_line(["build", "--store", empty], capsys, "no CUDA device")
    _exit_2_one_line(["query", "--store", empty, "--stencil", "heat2d"], capsys,
                     "no CUDA device")
    _exit_2_one_line(["portfolio", "--store", root, "--gpu", "gtx980", "--engine", "numpy",
                      "--downsample", DOWNSAMPLE, "--budget", "900",
                      "--portfolio-engine", "torch"], capsys, "no CUDA device")
    _exit_2_one_line(["portfolio", "--store", root, "--gpu", "gtx980", "--engine", "numpy",
                      "--downsample", DOWNSAMPLE, "--budget", "900"], capsys,
                     "no CUDA device")  # the default engine is torch, on the card
    cli.main(["portfolio", "--store", root, "--gpu", "gtx980", "--engine", "numpy",
              "--downsample", DOWNSAMPLE, "--budget", "900", "--portfolio-engine", "numpy"])
    assert re.search(r"^portfolio [0-9a-f]{20}: built", capsys.readouterr().out, re.M)
    assert not os.path.exists(os.path.join(empty, "manifest.json"))
    # a warm store needs no device: the query reduces on the host
    cli.main(["query", "--store", root, "--gpu", "gtx980", "--engine", "numpy",
              "--downsample", DOWNSAMPLE, "--stencil", "heat2d", "--json"])
    assert json.loads(capsys.readouterr().out)["origin"] == "warm"


def test_workload_lm_builds_on_cpu_and_exits_2_without_a_card(tmp_path, capsys, monkeypatch):
    """``build --workload lm`` (512 chips, 100 mesh points: auto resolves
    to torch) builds with ``--device cpu``; without ``--device`` and
    without a card it exits 2 with one line and writes nothing."""
    import torch

    from repro_torch.core.lmcells import lm_codesign, lm_workload

    store = str(tmp_path / "lm")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _exit_2_one_line(["build", "--store", store, "--workload", "lm"], capsys, "no CUDA device")
    assert not os.path.exists(store) or not os.listdir(store)
    cli.main(["build", "--store", store, "--workload", "lm", "--device", "cpu"])
    out = capsys.readouterr().out
    assert re.search(r"^artifact [0-9a-f]{20}: built .*100 hw points, 7 cells, gpu=tpu_v5e\)$",
                     out, re.M), out
    st = ArtifactStore(store)
    (row,) = st.entries()
    assert row["family"] == "lm" and row["engine"] == "torch"
    art = st.get(row["key"])
    want = lm_codesign(lm_workload(), engine="numpy")
    np.testing.assert_array_equal(art.cell_time, want.cell_time)
    # warm now: the same build needs no device
    cli.main(["build", "--store", store, "--workload", "lm"])
    assert "already stored" in capsys.readouterr().out


def test_device_cpu_builds_and_scores_with_torch(cli_store, tmp_path, capsys):
    root, _ = cli_store
    store = str(tmp_path / "torch-store")
    base = ["--store", store, "--engine", "torch", "--device", "cpu",
            "--downsample", DOWNSAMPLE]
    cli.main(["query"] + base + ["--stencil", "heat2d", "--json"])
    assert json.loads(capsys.readouterr().out)["origin"] == "cold build"
    cli.main(["portfolio"] + base + ["--k", "2", "--budget", "900", "--objective",
                                     "throughput"])  # the default engine: torch
    assert re.search(r"^portfolio [0-9a-f]{20}: built", capsys.readouterr().out, re.M)
    st = ArtifactStore(store)
    (pf,) = [st.get(r["key"]) for r in st.entries() if r["kind"] == "portfolio"]
    sweep = st.get(pf.payload["sweep_key"])
    assert pf.payload["engine"] == "torch" and sweep.manifest["spec"]["engine"] == "torch"
    want = optimize_portfolio_arrays(sweep.hw_area, sweep.cell_time, sweep.cell_flops(),
                                     sweep.cell_freqs(), 2, 900.0, objective="throughput",
                                     engine="numpy")
    if tuple(pf.payload["members"]) != want.members:
        assert pf.payload["fleet_gflops"] == pytest.approx(want.fleet_gflops, rel=1e-12)
    else:
        assert pf.payload["fleet_gflops"] == want.fleet_gflops
