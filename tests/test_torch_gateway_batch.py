"""The JAX package's ``tests/test_gateway_batch.py``, run on the port: the
/v1/query_many batched wire endpoint,
the persistent-connection client, manifest-kind routing (measurement /
calibration artifacts sharing a store with sweeps), the legacy-manifest
upgrade path, and the acceptance property that calibrated-hardware sweep
artifacts round-trip store -> gateway -> HTTP with byte-identical wire
answers."""

import json
import os
import subprocess
import sys
import tempfile
import threading

import numpy as np
import pytest

from repro_torch.core import MAXWELL, enumerate_hw_space
from repro_torch.core.codesign import codesign
from repro_torch.core.timemodel import (
    MAXWELL_GPU,
    STENCILS,
    with_c_iter,
    with_machine_params,
)
from repro_torch.measure import fit_machine_params, synthetic_records
from repro_torch.service import (
    ArtifactStore,
    CodesignServer,
    Gateway,
    GatewayClient,
    QueryRequest,
    RemoteError,
    WireError,
    WrongArtifactKindError,
    serve_http,
    wire,
)

STRIDE = 64
STENCIL_NAMES = ["heat2d", "jacobi2d"]


def small_hw():
    return enumerate_hw_space(MAXWELL, max_area=650.0).downsample(STRIDE)


@pytest.fixture(scope="module")
def fleet():
    """One store holding a datasheet sweep, a calibrated sweep (built from
    a stored calibration), a measurement manifest, a gateway, and a live
    HTTP server."""
    from repro_torch.core.workload import paper_workload
    from repro_torch.measure import MeasurementRecord, MeasurementRun

    root = tempfile.mkdtemp(prefix="gwbatch-")
    store = ArtifactStore(root)
    hw = small_hw()
    # datasheet sweep (the "before" target)
    srv = CodesignServer(
        store, workload=paper_workload(STENCIL_NAMES), gpu=MAXWELL_GPU,
        hw=hw, engine="numpy", batch_window=0.0,
    )
    srv.ensure_artifact()
    # a measurement manifest shares the store (must never route queries)
    meas = store.put_json(
        "measurement",
        MeasurementRun(
            records=[
                MeasurementRecord(
                    stencil="heat2d", size=(64, 64, 1, 4),
                    tiles=(8, 32, 2, 1, 1), time_s=1e-3,
                    hw=(16.0, 128.0, 96.0),
                )
            ],
            gpu_name="gtx980", backend="cpu", interpret=True,
        ).to_payload(),
        routing={"gpu": "gtx980"},
    )
    # calibration fitted from synthetic truth, persisted, then a sweep on
    # the calibrated hardware routed by its calibration key
    truth_gpu = with_machine_params(
        MAXWELL_GPU, bw_gmem=150.0e9, launch_overhead=8.0e-6
    )
    truth_st = {n: with_c_iter(STENCILS[n], STENCILS[n].c_iter * 1.5)
                for n in STENCIL_NAMES}
    cal = fit_machine_params(
        synthetic_records(truth_gpu, truth_st), gpu0=MAXWELL_GPU, iters=150, device="cpu"
    )
    cal_art = store.put_json(
        "calibration", cal.to_payload(),
        routing={"gpu": "gtx980", "calibrated_gpu": cal.calibrated_gpu().name},
    )
    result = codesign(
        cal.calibrated_workload(STENCIL_NAMES), gpu=cal.calibrated_gpu(),
        hw=hw, engine="numpy",
    )
    cal_sweep = store.put(
        result, engine="numpy", routing_extra={"calibration": cal_art.key}
    )
    cal_srv = CodesignServer.from_artifact(store, cal_sweep, batch_window=0.0)
    gw = Gateway(root, batch_window=0.0)
    httpd = serve_http(gw)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    url = "http://%s:%d" % httpd.server_address[:2]
    yield {
        "store": store, "srv": srv, "cal": cal, "cal_art": cal_art,
        "cal_srv": cal_srv, "meas": meas, "gw": gw, "url": url,
    }
    httpd.shutdown()
    httpd.server_close()


def _req(**kw):
    kw.setdefault("freqs", {"heat2d": 1.0})
    kw.setdefault("use_cache", False)
    return QueryRequest(**kw)


# ---------------------------------------------------------------------------
# wire: query_many codec
# ---------------------------------------------------------------------------
def test_wire_request_many_round_trip():
    triples = [
        (_req(top_k=3), "abc", None),
        (_req(freqs={"jacobi2d": 2.0}, max_area=450.0), None, {"gpu": "titanx"}),
    ]
    data = wire.encode_request_many(triples)
    back = wire.decode_request_many(data)
    assert back == triples
    assert wire.encode_request_many(triples) == data  # canonical


def test_wire_request_many_is_strict():
    with pytest.raises(WireError, match="non-empty array"):
        wire.decode_request_many(b'{"v": 1, "queries": []}')
    with pytest.raises(WireError, match="unknown envelope fields"):
        wire.decode_request_many(b'{"v": 1, "queries": [], "x": 1}')
    with pytest.raises(WireError, match=r"queries\[1\].*unknown fields"):
        wire.decode_request_many(
            b'{"v": 1, "queries": [{"request": {}}, {"request": {}, "bogus": 1}]}'
        )
    with pytest.raises(WireError, match=r"queries\[0\]"):
        wire.decode_request_many(
            b'{"v": 1, "queries": [{"request": {"max_aera": 1}}]}'
        )
    too_many = json.dumps(
        {"v": 1, "queries": [{"request": {}}] * (wire.MAX_BATCH + 1)}
    ).encode()
    with pytest.raises(WireError, match="cap"):
        wire.decode_request_many(too_many)


def test_wire_response_many_elements_are_single_payloads(fleet):
    """Each query_many element must carry byte-for-byte the single-query
    payload (the byte-identity property composes into batches)."""
    resp = fleet["srv"].query(_req(top_k=2))
    data = wire.encode_response_many([resp, ("unknown_artifact", "nope")])
    obj = json.loads(data)
    single = json.loads(wire.encode_response(resp))
    assert obj["results"][0] == {"ok": True, "response": single["response"]}
    assert obj["results"][1]["ok"] is False
    back = wire.decode_response_many(data, 200)
    assert isinstance(back[0], type(resp))
    assert wire.encode_response(back[0]) == wire.encode_response(resp)
    assert isinstance(back[1], RemoteError) and back[1].code == "unknown_artifact"


# ---------------------------------------------------------------------------
# gateway + HTTP: batched endpoint
# ---------------------------------------------------------------------------
def test_gateway_query_many_groups_and_orders(fleet):
    gw, srv, cal_srv = fleet["gw"], fleet["srv"], fleet["cal_srv"]
    reqs = [_req(max_area=float(a)) for a in (400, 500, 600, 450)]
    queries = [
        (reqs[0], srv.key, None),
        (reqs[1], cal_srv.key, None),
        (reqs[2], srv.key, None),
        (reqs[3], None, {"calibration": fleet["cal_art"].key}),
    ]
    results = gw.query_many(queries)
    # oracle: the same grouping by artifact (order preserved within and
    # across groups), answered by each artifact's own server batch
    want = {0: None, 1: None, 2: None, 3: None}
    want[0], want[2] = srv.query_many([reqs[0], reqs[2]])
    want[1], want[3] = cal_srv.query_many([reqs[1], reqs[3]])
    for i, got in enumerate(results):
        assert wire.encode_response(got) == wire.encode_response(want[i])
    assert gw.stats["batched_requests"] >= len(queries)


def test_gateway_query_many_rescans_at_most_once(fleet):
    """A batch of unresolvable queries must cost ONE on-demand store
    re-scan, not one per query (MAX_BATCH unknown keys must not mean
    MAX_BATCH full-store manifest scans)."""
    gw = fleet["gw"]
    before = gw.stats["rescans"]
    results = gw.query_many([(_req(), "a" * 20, None)] * 5)
    assert all(r == ("unknown_artifact", r[1]) for r in results)
    assert gw.stats["rescans"] == before + 1


def test_http_query_many_matches_singles_and_isolates_errors(fleet):
    client = GatewayClient(fleet["url"])
    srv = fleet["srv"]
    good = _req(top_k=3)
    bad_route = (_req(), "f" * 20, None)
    bad_request = (_req(freqs={"nosuch": 1.0}), srv.key, None)
    results = client.query_many(
        [(good, srv.key, None), bad_route, bad_request, (good, srv.key, None)]
    )
    want = wire.encode_response(srv.query(good))
    assert wire.encode_response(results[0]) == want
    assert wire.encode_response(results[3]) == want
    assert isinstance(results[1], RemoteError)
    # per-element errors classify exactly like their single-query twins,
    # even though the batch envelope itself is HTTP 200
    assert results[1].code == "unknown_artifact" and results[1].http_status == 404
    assert isinstance(results[2], RemoteError)
    assert results[2].code == "bad_request" and "nosuch" in results[2].message
    assert results[2].http_status == 400


def test_client_query_many_chunks_above_wire_cap(fleet, monkeypatch):
    """Batches above wire.MAX_BATCH split transparently into consecutive
    round trips, results concatenated in input order."""
    client = GatewayClient(fleet["url"])
    srv = fleet["srv"]
    monkeypatch.setattr(wire, "MAX_BATCH", 3)
    reqs = [_req(top_k=k + 1) for k in range(8)]  # 3 + 3 + 2 round trips
    results = client.query_many(reqs, artifact=srv.key)
    assert len(results) == len(reqs)
    for req, got in zip(reqs, results):
        assert len(got.top_k) == req.top_k
        assert got.artifact_key == srv.key
    assert max(r.batch_size for r in results) <= 3  # server saw the chunks


def test_http_query_many_batch_rides_one_matmul(fleet):
    """All same-artifact queries in one envelope share one reduction
    (batch_size > 1 on every response)."""
    client = GatewayClient(fleet["url"])
    srv = fleet["srv"]
    rng = np.random.default_rng(11)
    reqs = [
        _req(freqs=dict(zip(STENCIL_NAMES, rng.uniform(0.1, 1.0, size=2))))
        for _ in range(6)
    ]
    results = client.query_many(reqs, artifact=srv.key)
    assert all(r.batch_size == len(reqs) for r in results)


# ---------------------------------------------------------------------------
# client transport: persistent connection
# ---------------------------------------------------------------------------
def test_client_reuses_connection(fleet):
    client = GatewayClient(fleet["url"])
    assert client._conn is None
    client.health()
    conn1 = client._conn
    assert conn1 is not None  # kept alive
    client.artifacts()
    assert client._conn is conn1  # same socket reused
    client.query(_req(), artifact=fleet["srv"].key)
    assert client._conn is conn1
    client.close()
    assert client._conn is None
    # and still works after an explicit close (fresh connection)
    assert client.health()["ok"]


def test_client_keepalive_off_never_pools(fleet):
    client = GatewayClient(fleet["url"], keepalive=False)
    client.health()
    assert client._conn is None
    resp = client.query(_req(), artifact=fleet["srv"].key)
    assert wire.encode_response(resp) == wire.encode_response(
        fleet["srv"].query(_req())
    )


def test_client_survives_server_side_close(fleet):
    """Error responses close the connection server-side; the next request
    must transparently reconnect."""
    client = GatewayClient(fleet["url"])
    with pytest.raises(RemoteError):
        client.query(_req(), artifact="0" * 20)
    assert client.health()["ok"]
    with pytest.raises(ValueError, match="scheme"):
        GatewayClient("ftp://example.com")


# ---------------------------------------------------------------------------
# kind routing
# ---------------------------------------------------------------------------
def test_non_sweep_kinds_never_route_queries(fleet):
    gw = fleet["gw"]
    # the measurement + calibration manifests carry gpu=gtx980 too; the
    # sweep selector must not become ambiguous because of them
    key = gw.resolve(route={"gpu": "gtx980"})
    assert key == fleet["srv"].key
    with pytest.raises(WrongArtifactKindError, match="measurement"):
        gw.query(_req(), artifact=fleet["meas"].key)
    with pytest.raises(WrongArtifactKindError, match="calibration"):
        gw.query(_req(), artifact=fleet["cal_art"].key)
    # over HTTP: structured 400 wrong_artifact_kind
    client = GatewayClient(fleet["url"])
    with pytest.raises(RemoteError) as ei:
        client.query(_req(), artifact=fleet["meas"].key)
    assert ei.value.code == "wrong_artifact_kind" and ei.value.http_status == 400
    # explicit kind selector finds the manifest (e.g. for tooling), but
    # querying it is still a kind error
    assert gw.resolve(route={"kind": "measurement"}) == fleet["meas"].key
    with pytest.raises(WrongArtifactKindError):
        gw.query(_req(), route={"kind": "measurement"})


def test_artifacts_endpoint_lists_all_kinds(fleet):
    rows = {r["key"]: r for r in GatewayClient(fleet["url"]).artifacts()}
    assert rows[fleet["meas"].key]["kind"] == "measurement"
    assert rows[fleet["cal_art"].key]["kind"] == "calibration"
    assert rows[fleet["srv"].key]["kind"] == "sweep"


# ---------------------------------------------------------------------------
# acceptance: calibrated hardware round-trips byte-identically
# ---------------------------------------------------------------------------
def test_calibrated_sweep_serves_byte_identical_over_http(fleet):
    client = GatewayClient(fleet["url"])
    cal_srv = fleet["cal"]
    srv = fleet["cal_srv"]
    for req in (
        _req(top_k=3, pareto=True),
        _req(freqs={"jacobi2d": 1.0, "heat2d": 0.5}, max_area=500.0,
             fix={"n_sm": 16.0}),
    ):
        want = wire.encode_response(srv.query(req))
        by_cal = client.query_bytes(
            req, route={"calibration": fleet["cal_art"].key}
        )
        by_gpu = client.query_bytes(
            req, route={"gpu": cal_srv.calibrated_gpu().name}
        )
        assert by_cal == want
        assert by_gpu == want
    # and the calibrated sweep answers differently from the datasheet one
    a = fleet["srv"].query(_req())
    b = srv.query(_req())
    assert a.best_gflops != b.best_gflops


# ---------------------------------------------------------------------------
# legacy-manifest upgrade
# ---------------------------------------------------------------------------
def _strip_manifest(store: ArtifactStore, key: str) -> None:
    """Rewrite an artifact's manifest as a pre-gateway writer would have left
    it (no routing block, no kind tag)."""
    path = os.path.join(store.root, key, "manifest.json")
    with open(path) as f:
        m = json.load(f)
    m.pop("routing", None)
    m.pop("kind", None)
    with open(path, "w") as f:
        json.dump(m, f, indent=1)


def test_upgrade_backfills_legacy_manifests(tmp_path, subprocess_env):
    from repro_torch.core.timemodel import TITANX_GPU
    from repro_torch.core.workload import paper_workload

    store = ArtifactStore(str(tmp_path))
    hw = small_hw()
    legacy = CodesignServer(
        store, workload=paper_workload(["heat2d"]), gpu=MAXWELL_GPU,
        hw=hw, engine="numpy", batch_window=0.0,
    )
    legacy.ensure_artifact()
    modern = CodesignServer(
        store, workload=paper_workload(["heat2d"]), gpu=TITANX_GPU,
        hw=hw, engine="numpy", batch_window=0.0,
    )
    modern.ensure_artifact()
    _strip_manifest(store, legacy.key)
    # mixed store: the gateway still serves the legacy artifact through
    # the derivation fallback...
    gw = Gateway(store.root, batch_window=0.0)
    req = _req()
    want_legacy = wire.encode_response(legacy.query(req))
    assert gw.resolve(route={"gpu": "gtx980"}) == legacy.key
    assert wire.encode_response(
        gw.query(req, route={"gpu": "gtx980"})
    ) == want_legacy
    # ...and the upgrade rewrites it in place, key unchanged
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.service.cli", "upgrade",
         "--store", str(tmp_path)],
        capture_output=True, text=True, timeout=120, env=subprocess_env,
    )
    assert proc.returncode == 0, proc.stderr
    assert legacy.key in proc.stdout and "1 manifest(s) upgraded" in proc.stdout
    with open(os.path.join(store.root, legacy.key, "manifest.json")) as f:
        m = json.load(f)
    assert m["kind"] == "sweep"
    assert m["routing"] == {
        "gpu": "gtx980", "workload": "paper-uniform", "stencils": ["heat2d"],
    }
    assert m["key"] == legacy.key
    # second run is a no-op; answers unchanged after re-index
    assert ArtifactStore(str(tmp_path)).upgrade_manifests() == []
    gw.refresh()
    assert wire.encode_response(
        gw.query(req, route={"gpu": "gtx980"})
    ) == want_legacy


# ---------------------------------------------------------------------------
# CLI --batch-file
# ---------------------------------------------------------------------------
def test_cli_query_batch_file(fleet, tmp_path, subprocess_env):
    batch = [
        {"artifact": fleet["srv"].key,
         "request": {"freqs": {"heat2d": 1.0}, "top_k": 2}},
        {"route": {"calibration": fleet["cal_art"].key},
         "request": {"freqs": {"jacobi2d": 1.0}}},
        {"artifact": "f" * 20, "request": {}},
    ]
    path = tmp_path / "batch.json"
    path.write_text(json.dumps(batch))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.service.cli", "query",
         "--url", fleet["url"], "--batch-file", str(path)],
        capture_output=True, text=True, timeout=120, env=subprocess_env,
    )
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout)
    assert [r["ok"] for r in out["results"]] == [True, True, False]
    assert out["results"][0]["artifact_key"] == fleet["srv"].key
    assert out["results"][2]["error"]["code"] == "unknown_artifact"
    # --batch-file without --url is a clean one-line failure
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.service.cli", "query",
         "--batch-file", str(path)],
        capture_output=True, text=True, timeout=120, env=subprocess_env,
    )
    assert proc.returncode == 2
    assert "requires --url" in proc.stderr and "Traceback" not in proc.stderr
