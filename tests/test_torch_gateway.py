"""The port's gateway, against the JAX package's.

* The reference's own gateway tests (``tests/test_gateway.py``), run on
  the port: wire codec round trips, multi-artifact routing, HTTP transport
  byte-identity vs the in-process server, structured error paths, pool LRU
  bounds, concurrent clients across two artifacts, and the CLI's clean
  failure on missing/empty stores.
* Across packages, over one numpy-built store: the reference's
  ``GatewayClient`` against the port's gateway and the port's client
  against the reference's gateway give byte-identical ``/v1/query``,
  ``/v1/query_many`` and ``/v1/route`` bodies.
* An LM sweep (built by the reference) shares a store with a stencil
  sweep: LM selectors resolve, and each package's client against each
  package's gateway gets the reference's in-process LM answer byte for
  byte on ``/v1/query``, while stencil traffic is unaffected.
"""

import dataclasses
import json
import math
import subprocess
import sys
import tempfile
import threading
import urllib.request

import numpy as np
import pytest

from repro_torch.core import MAXWELL, enumerate_hw_space
from repro_torch.core.timemodel import MAXWELL_GPU, TITANX_GPU
from repro_torch.core.workload import paper_workload
from repro_torch.service import (
    AmbiguousRouteError,
    ArtifactStore,
    CodesignServer,
    Gateway,
    GatewayClient,
    QueryRequest,
    RemoteError,
    UnknownArtifactError,
    WireError,
    serve_http,
    wire,
)

#: tiny space (~81 points) + two-stencil workload keep the numpy sweeps in
#: test time; two GPUs give genuinely different matrices to route between.
STRIDE = 64
STENCILS = ["heat2d", "jacobi2d"]


def small_hw():
    return enumerate_hw_space(MAXWELL, max_area=650.0).downsample(STRIDE)


@pytest.fixture(scope="module")
def fleet():
    """One store holding two artifacts (gtx980 + titanx), their oracle
    servers, a gateway, and a live HTTP server -- built once."""
    root = tempfile.mkdtemp(prefix="gwstore-")
    store = ArtifactStore(root)
    wl = paper_workload(STENCILS)
    hw = small_hw()
    oracles = {}
    for gpu in (MAXWELL_GPU, TITANX_GPU):
        srv = CodesignServer(
            store, workload=wl, gpu=gpu, hw=hw, engine="numpy", batch_window=0.0
        )
        srv.ensure_artifact()
        oracles[gpu.name] = srv
    gw = Gateway(root, pool_size=2, batch_window=0.0)
    httpd = serve_http(gw)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    url = "http://%s:%d" % httpd.server_address[:2]
    yield store, oracles, gw, url
    httpd.shutdown()
    httpd.server_close()


def _req(**kw):
    kw.setdefault("freqs", {"heat2d": 1.0})
    kw.setdefault("use_cache", False)  # keep `cached` deterministic across
    return QueryRequest(**kw)         # oracle and gateway LRUs


# ---------------------------------------------------------------------------
# wire codec
# ---------------------------------------------------------------------------
def test_wire_request_round_trip_all_fields():
    req = QueryRequest(
        freqs={"heat2d": 2.0, "jacobi2d": 0.5},
        max_area=math.inf,
        min_area=120.0,
        top_k=7,
        pareto=True,
        fix={"n_sm": 16.0, "m_sm": 96.0},
        use_cache=False,
    )
    data = wire.encode_request(req, artifact="abc123", route={"gpu": "titanx"})
    got, artifact, route = wire.decode_request(data)
    assert got == req
    assert artifact == "abc123"
    assert route == {"gpu": "titanx"}
    # canonical encoding: same object -> same bytes, always
    assert wire.encode_request(req, artifact="abc123", route={"gpu": "titanx"}) == data
    # cell_freqs variant (sequences survive)
    req2 = QueryRequest(cell_freqs=[1.0] * 4, max_area=450.0)
    got2, _, _ = wire.decode_request(wire.encode_request(req2))
    assert list(got2.cell_freqs) == [1.0] * 4


def test_wire_nonfinite_floats_round_trip_exactly():
    req, _, _ = wire.decode_request(wire.encode_request(QueryRequest()))
    assert req.max_area == math.inf
    # a nan travels as a tag and comes back as a real nan
    obj = wire._unjsonify(wire._jsonify({"x": math.nan, "y": -math.inf}))
    assert math.isnan(obj["x"]) and obj["y"] == -math.inf


def test_wire_coerces_scalars_and_rejects_garbage():
    """JSON-ly typed scalars ('450', 3.0 for top_k) coerce at decode time;
    uncoercible garbage fails as bad_request, never a deep engine error."""
    got, _, _ = wire.decode_request(
        b'{"v": 1, "request": {"max_area": "450", "top_k": 3.0}}'
    )
    assert got.max_area == 450.0 and isinstance(got.max_area, float)
    assert got.top_k == 3 and isinstance(got.top_k, int)
    with pytest.raises(WireError, match="bad request field"):
        wire.decode_request(b'{"v": 1, "request": {"max_area": "plenty"}}')
    with pytest.raises(WireError, match="must be a boolean"):
        wire.decode_request(b'{"v": 1, "request": {"pareto": "yes"}}')


def test_wire_rejects_malformed_and_unknown():
    with pytest.raises(WireError, match="malformed JSON"):
        wire.decode_request(b"{not json")
    with pytest.raises(WireError, match="must be a JSON object"):
        wire.decode_request(b"[1,2]")
    with pytest.raises(WireError) as ei:
        wire.decode_request(b'{"v": 99, "request": {}}')
    assert ei.value.code == "unsupported_version"
    with pytest.raises(WireError, match="unknown request fields"):
        wire.decode_request(b'{"v": 1, "request": {"max_aera": 5}}')
    with pytest.raises(WireError, match="unknown envelope fields"):
        wire.decode_request(b'{"v": 1, "request": {}, "extra": 1}')
    with pytest.raises(WireError, match="'artifact' must be a string"):
        wire.decode_request(b'{"v": 1, "request": {}, "artifact": 7}')
    with pytest.raises(WireError, match="'freqs' must be an object"):
        wire.decode_request(b'{"v": 1, "request": {"freqs": [1, 2]}}')


def test_wire_response_round_trip_bit_identical(fleet):
    _, oracles, _, _ = fleet
    # exercise every optional field: pareto, what-if baseline, and the
    # infeasible -inf/empty shape
    for req in (
        _req(top_k=5, pareto=True, fix={"n_sm": 16.0}),
        _req(max_area=1.0),  # infeasible: best_index=-1, -inf gflops
    ):
        resp = oracles["gtx980"].query(req)
        data = wire.encode_response(resp)
        back = wire.decode_response(data)
        assert wire.encode_response(back) == data  # decode inverts encode
        assert back.best_index == resp.best_index
        assert back.best_gflops == resp.best_gflops  # incl. -inf exactly
        assert back.top_k == resp.top_k
        if resp.pareto_indices is not None:
            np.testing.assert_array_equal(back.pareto_indices, resp.pareto_indices)
    # a structured error decodes as RemoteError carrying the code
    with pytest.raises(RemoteError) as ei:
        wire.decode_response(wire.encode_error("unknown_artifact", "nope"), 404)
    assert ei.value.code == "unknown_artifact" and ei.value.http_status == 404


# ---------------------------------------------------------------------------
# gateway: discovery, routing, pool
# ---------------------------------------------------------------------------
def test_gateway_indexes_both_artifacts_with_routing_attrs(fleet):
    store, oracles, gw, _ = fleet
    keys = {srv.key for srv in oracles.values()}
    assert set(gw.keys()) >= keys
    by_key = {row["key"]: row for row in gw.entries()}
    for name, srv in oracles.items():
        row = by_key[srv.key]
        assert row["gpu"] == name
        assert row["stencils"] == sorted(STENCILS)
        assert row["engine"] == "numpy"
        assert row["hw"] == len(small_hw())


def test_gateway_routes_by_key_and_selector(fleet):
    _, oracles, gw, _ = fleet
    req = _req(max_area=500.0, top_k=3)
    for name, srv in oracles.items():
        want = srv.query(req)
        by_key = gw.query(req, artifact=srv.key)
        by_gpu = gw.query(req, route={"gpu": name})
        for got in (by_key, by_gpu):
            assert got.artifact_key == srv.key
            assert got.best_index == want.best_index
            assert got.best_gflops == want.best_gflops
    # the two GPUs genuinely answer differently (different bandwidth)
    a = gw.query(req, route={"gpu": "gtx980"})
    b = gw.query(req, route={"gpu": "titanx"})
    assert a.best_gflops != b.best_gflops


def test_gateway_routing_errors(fleet):
    _, _, gw, _ = fleet
    req = _req()
    with pytest.raises(UnknownArtifactError, match="no stored artifact"):
        gw.query(req, artifact="0" * 20)
    with pytest.raises(UnknownArtifactError):
        gw.query(req, route={"gpu": "voodoo2"})
    with pytest.raises(AmbiguousRouteError, match="pin one"):
        gw.query(req, route={"stencils": ["heat2d"]})  # both artifacts serve it
    with pytest.raises(AmbiguousRouteError, match="name one"):
        gw.query(req)  # two artifacts, no selector
    with pytest.raises(ValueError, match="unknown route selector"):
        gw.query(req, route={"gpus": "gtx980"})


def test_gateway_pool_is_lru_bounded(fleet):
    store, oracles, _, _ = fleet
    gw = Gateway(store.root, pool_size=1, batch_window=0.0)
    req = _req(max_area=500.0)
    keys = [srv.key for srv in oracles.values()]
    for key in keys + keys:  # A, B, A, B: every switch evicts
        resp = gw.query(req, artifact=key)
        assert resp.artifact_key == key
    assert gw.stats["pool_evictions"] >= 3
    assert gw.stats["pool_instantiations"] >= 4
    assert len(gw._pool) == 1
    # answers stay correct after re-instantiation
    for name, srv in oracles.items():
        assert gw.query(req, artifact=srv.key).best_index == srv.query(req).best_index


def test_gateway_discovers_new_artifact_on_demand():
    # own store root: adding an artifact to the shared fleet store would
    # make the other tests' {"gpu": "gtx980"} selector ambiguous
    store = ArtifactStore(tempfile.mkdtemp(prefix="gwlate-"))
    gw = Gateway(store.root, batch_window=0.0)
    n0 = len(gw)
    wl3 = paper_workload(["heat3d"], name="late-arrival")
    srv3 = CodesignServer(
        store, workload=wl3, hw=small_hw(), engine="numpy", batch_window=0.0
    )
    srv3.ensure_artifact()  # lands AFTER the gateway indexed the store
    want = srv3.query(_req(freqs={"heat3d": 1.0}))
    got = gw.query(_req(freqs={"heat3d": 1.0}), artifact=srv3.key)  # on-demand rescan
    assert got.best_index == want.best_index
    assert len(gw) == n0 + 1
    assert gw.stats["rescans"] >= 2
    # selector routing sees it too
    assert gw.resolve(route={"workload": "late-arrival"}) == srv3.key


def test_from_artifact_honors_spec_lattices_for_unused_dims():
    """The content key digests BOTH lattice tables; a custom lattice for a
    dimensionality the workload never exercises must still reproduce the
    key from the stored spec (the per-cell tables alone cannot)."""
    from repro_torch.core.solver import TileLattice

    store = ArtifactStore(tempfile.mkdtemp(prefix="gwlat-"))
    custom_3d = TileLattice(
        t_s1=(1, 2), t_s2=(32, 64), t_t=(2, 4), k=(1, 2), t_s3=(1, 2)
    )
    srv = CodesignServer(
        store, workload=paper_workload(["heat2d"]), hw=small_hw(),
        engine="numpy", lattice_3d=custom_3d, batch_window=0.0,
    )
    srv.ensure_artifact()
    art = store.get(srv.key)
    warm = CodesignServer.from_artifact(store, art, batch_window=0.0)
    assert warm.key == srv.key
    assert warm.query(_req()).best_index == srv.query(_req()).best_index


def test_from_artifact_reproduces_key_and_answers(fleet):
    store, oracles, _, _ = fleet
    for srv in oracles.values():
        art = store.get(srv.key)
        warm = CodesignServer.from_artifact(store, art, batch_window=0.0)
        assert warm.key == art.key
        assert warm.warm
        req = _req(top_k=4, pareto=True)
        a, b = warm.query(req), srv.query(req)
        assert wire.encode_response(a) == wire.encode_response(b)
    assert warm.stats["artifact_builds"] == 0


# ---------------------------------------------------------------------------
# HTTP transport: the acceptance property + error paths
# ---------------------------------------------------------------------------
def test_http_query_is_byte_identical_to_in_process(fleet):
    _, oracles, _, url = fleet
    client = GatewayClient(url)
    rng = np.random.default_rng(5)
    for name, srv in oracles.items():
        for _ in range(3):
            w = rng.uniform(0.1, 1.0, size=2)
            req = _req(
                freqs=dict(zip(STENCILS, w)),
                max_area=float(rng.uniform(350, 650)),
                top_k=3,
                pareto=True,
            )
            raw = client.query_bytes(req, route={"gpu": name})
            assert raw == wire.encode_response(srv.query(req))
    # and the infeasible case crosses the wire exactly (-inf survives)
    raw = client.query_bytes(_req(max_area=1.0), route={"gpu": "gtx980"})
    assert raw == wire.encode_response(oracles["gtx980"].query(_req(max_area=1.0)))
    resp = wire.decode_response(raw)
    assert resp.best_index == -1 and resp.best_gflops == -math.inf


def test_http_error_paths_are_structured(fleet):
    _, _, _, url = fleet
    client = GatewayClient(url)

    def status_and_code(body: bytes, status: int):
        with pytest.raises(RemoteError) as ei:
            wire.decode_response(body, status)
        return ei.value

    # malformed JSON -> 400 bad_request (never a traceback)
    req = urllib.request.Request(
        url + "/v1/query", data=b"{oops", method="POST",
        headers={"Content-Type": "application/json"},
    )
    with pytest.raises(urllib.error.HTTPError) as ei:
        urllib.request.urlopen(req)
    assert ei.value.code == 400
    err = status_and_code(ei.value.read(), 400)
    assert err.code == "bad_request" and "JSON" in err.message

    # unknown artifact -> 404 unknown_artifact
    with pytest.raises(RemoteError) as ei:
        client.query(_req(), artifact="f" * 20)
    assert ei.value.code == "unknown_artifact" and ei.value.http_status == 404

    # ambiguous route -> 409
    with pytest.raises(RemoteError) as ei:
        client.query(_req())
    assert ei.value.code == "ambiguous_route" and ei.value.http_status == 409

    # semantic rejection from the engine -> 400 bad_request
    with pytest.raises(RemoteError) as ei:
        client.query(_req(freqs={"nosuch": 1.0}), route={"gpu": "gtx980"})
    assert ei.value.code == "bad_request" and "nosuch" in ei.value.message

    # unknown endpoint -> 404 not_found
    with pytest.raises(RemoteError) as ei:
        wire.decode_response(client._http("/v2/query", b"{}"), client._last_status)
    assert ei.value.code == "not_found"

    # wrong wire version -> 400 unsupported_version
    with pytest.raises(RemoteError) as ei:
        wire.decode_response(
            client._http("/v1/query", b'{"v": 9, "request": {}}'),
            client._last_status,
        )
    assert ei.value.code == "unsupported_version"


def test_http_introspection_endpoints(fleet):
    _, oracles, _, url = fleet
    client = GatewayClient(url)
    health = client.health()
    assert health["ok"] and health["artifacts"] >= 2
    rows = {r["key"]: r for r in client.artifacts()}
    for name, srv in oracles.items():
        assert rows[srv.key]["gpu"] == name
    assert client.refresh() >= 2


def test_http_concurrent_clients_route_to_distinct_artifacts(fleet):
    """Eight threads interleave queries against both GPUs through ONE
    gateway; every answer must match that artifact's oracle (no
    cross-artifact bleed) even while requests microbatch."""
    _, oracles, _, url = fleet
    names = list(oracles)
    rng = np.random.default_rng(23)
    reqs = [
        _req(
            freqs=dict(zip(STENCILS, rng.uniform(0.1, 1.0, size=2))),
            max_area=float(rng.uniform(350, 650)),
            top_k=2,
        )
        for _ in range(8)
    ]
    want = [wire.encode_response(oracles[names[i % 2]].query(r))
            for i, r in enumerate(reqs)]
    got = [None] * len(reqs)
    barrier = threading.Barrier(len(reqs))

    def worker(i):
        client = GatewayClient(url)
        barrier.wait()
        got[i] = client.query_bytes(reqs[i], route={"gpu": names[i % 2]})

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(len(reqs))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for i, (g, w) in enumerate(zip(got, want)):
        assert g == w, f"request {i} diverged from its artifact's oracle"


# ---------------------------------------------------------------------------
# CLI: clean failures (no tracebacks) on missing/empty stores
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("case", ["missing", "empty"])
def test_cli_serve_exits_cleanly_without_artifacts(case, tmp_path, subprocess_env):
    root = tmp_path / "nosuch-store"
    if case == "empty":
        root.mkdir()
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.service.cli", "serve",
         "--store", str(root), "--port", "0"],
        capture_output=True, text=True, timeout=60, env=subprocess_env,
    )
    assert proc.returncode == 2
    assert proc.stderr.startswith("error:")
    assert "Traceback" not in proc.stderr
    assert str(root) in proc.stderr


def test_cli_serve_root_only_skips_default_store(fleet, subprocess_env):
    """`serve --root <store>` must not require the default cache dir to
    exist (it is only consulted when no root is named explicitly)."""
    store, _, _, _ = fleet
    env = dict(subprocess_env)
    env["HOME"] = tempfile.mkdtemp(prefix="gwhome-")  # no default store here
    env.pop("REPRO_STORE", None)
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.service.cli", "serve",
         "--root", store.root, "--port", "0"],
        stdout=subprocess.PIPE, text=True, env=env,
    )
    try:
        served = False
        for line in proc.stdout:
            if "serving on http://" in line:
                served = True
                break
        assert served, "serve --root <valid store> failed to start"
    finally:
        proc.terminate()
        proc.wait(timeout=30)


def test_cli_query_url_unreachable_exits_cleanly(subprocess_env):
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.service.cli", "query",
         "--url", "http://127.0.0.1:9", "--stencil", "heat2d"],
        capture_output=True, text=True, timeout=60, env=subprocess_env,
    )
    assert proc.returncode == 2
    assert "cannot reach gateway" in proc.stderr
    assert "Traceback" not in proc.stderr


def test_store_refuses_missing_root_when_not_creating(tmp_path):
    with pytest.raises(FileNotFoundError, match="does not exist"):
        ArtifactStore(str(tmp_path / "nope"), create=False)
    with pytest.raises(FileNotFoundError):
        Gateway(str(tmp_path / "nope"))


def test_artifact_routing_row_falls_back_without_block(fleet):
    """Artifacts written before the manifest grew a 'routing' block still
    produce a full routing row (derived from workload/gpu/spec)."""
    store, oracles, _, _ = fleet
    srv = oracles["titanx"]
    art = store.get(srv.key)
    m = json.loads(json.dumps(art.manifest))  # deep copy
    m.pop("routing", None)
    art.manifest = m
    row = art.routing()
    assert row["gpu"] == "titanx"
    assert row["stencils"] == sorted(STENCILS)
    assert row["key"] == srv.key


# ---------------------------------------------------------------------------
# across packages: each package's client against the other's gateway
# ---------------------------------------------------------------------------
def _serve(gw, serve):
    httpd = serve(gw)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return httpd, "http://%s:%d" % httpd.server_address[:2]


@pytest.fixture(scope="module")
def two_gateways():
    """One numpy-built store (two sweeps and a K=2 portfolio), served by the
    port's gateway and by the reference's gateway at once."""
    import repro.service as RS

    from repro_torch.service import build_portfolio

    root = tempfile.mkdtemp(prefix="gwcross-")
    store = ArtifactStore(root)
    wl = paper_workload(STENCILS)
    oracles = {}
    for gpu in (MAXWELL_GPU, TITANX_GPU):
        srv = CodesignServer(store, workload=wl, gpu=gpu, hw=small_hw(),
                             engine="numpy", batch_window=0.0)
        srv.ensure_artifact()
        oracles[gpu.name] = srv
    pf, _ = build_portfolio(store, oracles["gtx980"].key, 2, 900.0, objective="throughput",
                            engine="numpy")
    port_httpd, port_url = _serve(Gateway(root, batch_window=0.0), serve_http)
    ref_httpd, ref_url = _serve(RS.Gateway(root, batch_window=0.0), RS.serve_http)
    yield {"store": store, "oracles": oracles, "portfolio": pf,
           "port_url": port_url, "ref_url": ref_url}
    for httpd in (port_httpd, ref_httpd):
        httpd.shutdown()
        httpd.server_close()


def _cross_requests(names, n=6, seed=11):
    """Seeded mixes, budgets, top-k and Pareto (port and reference twins)."""
    import repro.service as RS

    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        kw = dict(freqs=dict(zip(names, rng.uniform(0.1, 1.0, size=len(names)).tolist())),
                  max_area=float(rng.uniform(300.0, 650.0)), top_k=1 + i % 3,
                  pareto=i % 2 == 0, use_cache=False)
        out.append((QueryRequest(**kw), RS.QueryRequest(**kw)))
    return out


def _clients(urls):
    """(name, port client, reference client) for every gateway."""
    import repro.service as RS

    return [(name, GatewayClient(url), RS.GatewayClient(url)) for name, url in urls]


def test_cross_package_http_query_bytes(two_gateways):
    g = two_gateways
    urls = (("port", g["port_url"]), ("ref", g["ref_url"]))
    for gpu, oracle in g["oracles"].items():
        for req, rreq in _cross_requests(STENCILS):
            want = wire.encode_response(oracle.query(req))
            for name, mine, theirs in _clients(urls):
                assert mine.query_bytes(req, route={"gpu": gpu}) == want, name
                assert theirs.query_bytes(rreq, route={"gpu": gpu}) == want, name
                assert theirs.query_bytes(rreq, artifact=oracle.key) == want, name


def test_cross_package_http_query_many_bytes(two_gateways):
    """Either client gets the same ``/v1/query_many`` body from a gateway.
    The port's elements are the lone in-process answers' bytes; the
    reference's are its own in-process batched answers' bytes. (The two
    gateways' bodies may differ from each other in the last ulp: the
    reference reduces a batch as one stacked product, the port row by
    row.)"""
    import repro.service as RS

    g = two_gateways
    pairs = _cross_requests(STENCILS, n=8, seed=12)
    gpus = list(g["oracles"])
    mine_triples = [(q, None, {"gpu": gpus[i % 2]}) for i, (q, _) in enumerate(pairs)]
    ref_triples = [(r, None, {"gpu": gpus[i % 2]}) for i, (_, r) in enumerate(pairs)]
    mine_triples.append((pairs[0][0], "0" * 20, None))  # one structured error
    ref_triples.append((pairs[0][1], "0" * 20, None))
    for url in (g["port_url"], g["ref_url"]):
        body = GatewayClient(url).query_many_bytes(mine_triples)
        assert RS.GatewayClient(url).query_many_bytes(ref_triples) == body

    got = RS.GatewayClient(g["port_url"]).query_many(ref_triples)
    for i, (q, _, route) in enumerate(mine_triples[:-1]):
        assert got[i].batch_size > 1  # the batch rode one reduction pass
        lone = g["oracles"][route["gpu"]].query(q)
        want = wire.encode_response(dataclasses.replace(lone, batch_size=got[i].batch_size))
        assert RS.wire.encode_response(got[i]) == want
    assert isinstance(got[-1], RS.RemoteError) and got[-1].code == "unknown_artifact"

    got = GatewayClient(g["ref_url"]).query_many(mine_triples)
    want = RS.Gateway(g["store"].root, batch_window=0.0).query_many(ref_triples)
    for mine, theirs in zip(got[:-1], want[:-1]):
        assert wire.encode_response(mine) == RS.wire.encode_response(theirs)
    assert isinstance(got[-1], RemoteError) and got[-1].code == "unknown_artifact"


def test_cross_package_http_route_bytes(two_gateways):
    import repro.service as RS

    from repro_torch.service import PortfolioServer, RouteRequest

    g = two_gateways
    store, pf = g["store"], g["portfolio"]
    oracle = PortfolioServer(store.get(pf.key), store.get(pf.payload["sweep_key"]))
    urls = (("port", g["port_url"]), ("ref", g["ref_url"]))
    for cell in oracle.cell_labels():
        want = wire.encode_route_response(oracle.route(RouteRequest(cell=cell)))
        for name, mine, theirs in _clients(urls):
            assert mine.route_bytes(RouteRequest(cell=cell), route={"gpu": "gtx980"}) == want
            assert theirs.route_bytes(RS.RouteRequest(cell=cell), artifact=pf.key) == want
    for name, mine, theirs in _clients(urls):
        with pytest.raises(RS.RemoteError) as exc:
            theirs.route("not-a-cell", artifact=pf.key)
        assert exc.value.code == "unknown_cell" and exc.value.http_status == 404


# ---------------------------------------------------------------------------
# an LM sweep beside the stencil sweeps: both gateways, both clients
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def lm_fleet():
    """A stencil sweep (port) and an LM sweep (reference) for the same GPU
    name in one store, behind the port's gateway and the reference's."""
    import repro.service as RS
    from repro.configs import get_arch
    from repro.core.lmcells import enumerate_lm_hw_space, lm_workload

    root = tempfile.mkdtemp(prefix="gwlm-")
    store = ArtifactStore(root)
    ssrv = CodesignServer(store, workload=paper_workload(STENCILS), gpu=MAXWELL_GPU,
                          hw=small_hw(), engine="numpy", batch_window=0.0)
    ssrv.ensure_artifact()
    lsrv = RS.LMServer(
        RS.ArtifactStore(root),
        workload=lm_workload(archs=[get_arch("llama3-8b").reduced()], name="lm"),
        hw=enumerate_lm_hw_space(max_chips=32), engine="numpy",
        gpu_name=MAXWELL_GPU.name, batch_window=0.0,
    )
    lsrv.ensure_artifact()
    gw = Gateway(root, batch_window=0.0)
    httpd, url = _serve(gw, serve_http)
    ref_httpd, ref_url = _serve(RS.Gateway(root, batch_window=0.0), RS.serve_http)
    yield ssrv, lsrv.key, gw, url, ref_url
    for h in (httpd, ref_httpd):
        h.shutdown()
        h.server_close()


def test_lm_selectors_resolve_and_cross_family_is_structured(lm_fleet):
    from repro_torch.service import AmbiguousWorkloadError

    ssrv, lm_key, gw, _, _ = lm_fleet
    assert gw.resolve(route={"workload": "lm"}) == lm_key
    assert gw.resolve(route={"family": "lm"}) == lm_key
    assert gw.resolve(route={"family": "stencil"}) == ssrv.key
    with pytest.raises(AmbiguousWorkloadError):
        gw.resolve(route={"gpu": MAXWELL_GPU.name})


def _lm_cross_requests(seed=13):
    """LM queries (port and reference twins): decode under a chip budget,
    model and op groups, a what-if, Pareto, seeded mixes."""
    import repro.service as RS

    model = "llama3-8b-reduced"
    rng = np.random.default_rng(seed)
    reqs = [_req(freqs={f"{model}:decode": 1.0}, max_area=16.0, top_k=3, pareto=True),
            _req(freqs={model: 1.0}, top_k=5),
            _req(freqs={"train": 1.0}, fix={"model": 2.0}),
            _req(freqs={f"{model}:decode": 1.0}, max_area=0.5)]
    labels = [f"{model}:{op}" for op in ("prefill", "decode", "train")]
    for i in range(3):
        reqs.append(_req(freqs=dict(zip(labels, rng.uniform(0.1, 1.0, 3).tolist())),
                         max_area=float(rng.choice([8, 16, 32])), top_k=1 + i))
    return [(q, RS.QueryRequest(**dataclasses.asdict(q))) for q in reqs]


def test_cross_package_http_lm_query_bytes_and_stencils_unaffected(lm_fleet):
    """Each package's client against each gateway: an LM ``/v1/query``
    body is the bytes of the reference's in-process LM server, and a
    stencil query on the same gateways is unaffected."""
    import repro.service as RS

    ssrv, lm_key, _, url, ref_url = lm_fleet
    rstore = RS.ArtifactStore(ssrv.store.root)
    oracle = RS.server_from_artifact(rstore, rstore.get(lm_key), batch_window=0.0)
    stencil = _req(top_k=2, pareto=True)
    want_stencil = wire.encode_response(ssrv.query(stencil))
    for name, mine, theirs in _clients((("port", url), ("ref", ref_url))):
        for req, rreq in _lm_cross_requests():
            want = RS.wire.encode_response(oracle.query(rreq))
            assert mine.query_bytes(req, route={"workload": "lm"}) == want, name
            assert mine.query_bytes(req, artifact=lm_key) == want, name
            assert theirs.query_bytes(rreq, route={"workload": "lm"}) == want, name
        assert mine.query_bytes(stencil, route={"family": "stencil"}) == want_stencil, name
        assert mine.query_bytes(stencil, artifact=ssrv.key) == want_stencil, name
        assert mine.health()["ok"]
    many = GatewayClient(url).query_many(
        [(stencil, ssrv.key, None), (_lm_cross_requests()[0][0], lm_key, None)])
    assert wire.encode_response(many[0]) == want_stencil
    assert many[1].best_index >= 0 and many[1].artifact_key == lm_key
