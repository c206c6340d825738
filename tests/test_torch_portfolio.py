"""Portfolio codesign on the port, against the JAX package's.

* The port's numpy oracle equals the reference's exactly (members,
  assignment, preference, payload bytes) for K in {1, 2, 3}, both
  objectives and several budgets, on sweeps both packages compute from the
  same inputs (``STRIDE = 32``: 161 hardware points, both paper GPUs; and
  an LM sweep, Llama-3-8B over 64 chips, whose budgets are chip counts).
* K=1 under the throughput objective is ``best(max_area=budget)`` bit for
  bit.
* The ``"torch"`` engine (float64 scoring, here on the CPU) is
  tie-aware-equal to the oracle: the same members, or the same fleet
  objective within RTOL 1e-12 when a tie to the last bits resolves
  differently; its dominance filter gives the numpy mask exactly. It is
  the default engine of every entry point, which raises without a card
  unless given ``device="cpu"``.
* A numpy-engine portfolio built by either package over the same sweep has
  the same content key and manifest bytes, and each package routes the
  other's.
* The reference's own portfolio tests (``tests/test_portfolio.py``), run
  on the port with its default engine on the CPU: persistence, the budget and argument guards, and the
  gateway's ``/v1/route`` answers, in process and over HTTP, byte-identical
  to the in-process :class:`PortfolioServer`.
"""

import functools
import json
import threading

import numpy as np
import pytest

import repro.core as R
import repro.service as RS
from repro.core.portfolio import optimize_portfolio as r_optimize_portfolio
from repro.core.timemodel import GPUS_BY_NAME as R_GPUS
from repro.core.portfolio import portfolio_candidates as r_portfolio_candidates
from repro.service.portfolio import build_portfolio as r_build_portfolio
from repro_torch.core.codesign import codesign, enumerate_hw_space
from repro_torch.core.portfolio import (
    OBJECTIVES,
    optimize_portfolio,
    optimize_portfolio_arrays,
    portfolio_candidates,
)
from repro_torch.core.timemodel import GPUS_BY_NAME
from repro_torch.core.workload import paper_workload
from repro_torch.service import wire
from repro_torch.service.client import GatewayClient
from repro_torch.service.gateway import Gateway, WrongArtifactKindError, serve_http
from repro_torch.service.portfolio import (
    PortfolioServer,
    RouteRequest,
    UnknownCellError,
    build_portfolio,
)
from repro_torch.service.server import CodesignServer
from repro_torch.service.store import ArtifactStore

#: stride 32 of the 5,121-point space: 161 points
STRIDE = 32
#: the torch engine scores in float64, summing in another order than
#: numpy: a tie to the last bits may name another subset
RTOL = 1e-12

#: both paper GPUs' stencil sweeps, and an LM sweep (Llama-3-8B, 64 chips)
#: as in the reference's ``tests/test_portfolio.py``
FAMILIES = ("gtx980", "titanx", "lm")

_RESULTS = {}


def sweep_result(name):
    """Module-cached numpy-engine sweeps: (port result, reference result)."""
    if name == "lm" and name not in _RESULTS:
        from repro.core.lmcells import lm_codesign as r_lm_codesign
        from repro.core.lmcells import lm_workload as r_lm_workload
        from repro_torch.core.lmcells import lm_codesign, lm_workload

        _RESULTS[name] = (
            lm_codesign(lm_workload(archs=("llama3-8b",)), max_chips=64, engine="numpy"),
            r_lm_codesign(r_lm_workload(archs=("llama3-8b",)), max_chips=64, engine="numpy"),
        )
    if name not in _RESULTS:
        _RESULTS[name] = (
            codesign(paper_workload(), gpu=GPUS_BY_NAME[name],
                     hw=enumerate_hw_space().downsample(STRIDE), engine="numpy"),
            R.codesign(R.paper_workload(), gpu=R_GPUS[name],
                       hw=R.enumerate_hw_space().downsample(STRIDE), engine="numpy"),
        )
    return _RESULTS[name]


@functools.lru_cache(maxsize=None)
def oracle(family, k, budget, objective):
    """The port's numpy oracle on a family's sweep (shared by the tests)."""
    return optimize_portfolio(sweep_result(family)[0], k, budget, objective=objective,
                              engine="numpy")


def budgets_for(res):
    """Fleet budgets spanning single-member to multi-member (900 mm^2 is
    the reference's portfolio smoke budget)."""
    area = np.asarray(res.hw.area, np.float64)
    return [float(np.quantile(area, 0.5)), 900.0, float(area.sum())]


def _objective(r, objective):
    return r.fleet_density if objective == "density" else r.fleet_gflops


def assert_tie_aware_equal(got, want, objective, what):
    """Same subset: every float64-finalized number bit-identical. Another
    subset: only on a tie to the last bits, so the fleet objectives agree
    to RTOL."""
    if got.members == want.members:
        assert got.fleet_gflops == want.fleet_gflops
        assert got.weighted_time == want.weighted_time
        assert got.total_area == want.total_area
        np.testing.assert_array_equal(got.assignment, want.assignment)
        np.testing.assert_array_equal(got.preference, want.preference)
    else:
        assert _objective(got, objective) == pytest.approx(
            _objective(want, objective), rel=RTOL
        ), f"{what}: engines disagree beyond the tie tolerance ({got.members} vs {want.members})"


# ---------------------------------------------------------------------------
# the numpy oracle against the reference's
# ---------------------------------------------------------------------------


def test_sweeps_under_test_are_the_references():
    for family in FAMILIES:
        res, rres = sweep_result(family)
        np.testing.assert_array_equal(res.cell_time, rres.cell_time)
        np.testing.assert_array_equal(res.hw.area, rres.hw.area)


@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("k", [1, 2, 3])
def test_numpy_oracle_is_the_references(family, k):
    res, rres = sweep_result(family)
    for objective in OBJECTIVES:
        for budget in budgets_for(res):
            got = oracle(family, k, budget, objective)
            want = r_optimize_portfolio(rres, k, budget, objective=objective)
            assert got.members == want.members
            np.testing.assert_array_equal(got.assignment, want.assignment)
            np.testing.assert_array_equal(got.preference, want.preference)
            assert json.dumps(got.payload(), sort_keys=True) == json.dumps(
                want.payload(), sort_keys=True
            )


@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("k", [1, 2, 3])
def test_torch_engine_tie_aware_equal_to_oracle(family, k):
    res, _ = sweep_result(family)
    for objective in OBJECTIVES:
        for budget in budgets_for(res):
            want = oracle(family, k, budget, objective)
            got = optimize_portfolio(
                res, k, budget, objective=objective, engine="torch", device="cpu"
            )
            assert got.engine == "torch" and got.candidates == want.candidates
            assert_tie_aware_equal(got, want, objective, f"{family} k={k} {objective} {budget}")


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_torch_engine_on_seeded_ties(seed):
    """Random matrices with duplicated columns (exact ties between designs)
    and infeasible (inf / NaN) cells, from a numpy seed."""
    rng = np.random.default_rng(seed)
    n_cells, n_hw = 7, 40
    times = rng.uniform(1e-4, 1e-2, size=(n_cells, n_hw))
    area = rng.uniform(50.0, 400.0, size=n_hw)
    times[:, 20:30] = times[:, 0:10]
    area[20:30] = area[0:10]
    times[rng.integers(0, n_cells, 5), rng.integers(0, n_hw, 5)] = np.inf
    times[0, 5] = np.nan
    flops = rng.uniform(1e9, 1e11, size=n_cells)
    freqs = rng.uniform(0.1, 1.0, size=n_cells)
    np.testing.assert_array_equal(
        portfolio_candidates(area, times, device="cpu"), portfolio_candidates(area, times)
    )
    for k in (1, 2, 3):
        for objective in OBJECTIVES:
            want = optimize_portfolio_arrays(area, times, flops, freqs, k, 600.0,
                                             objective=objective, engine="numpy")
            got = optimize_portfolio_arrays(area, times, flops, freqs, k, 600.0,
                                            objective=objective, engine="torch",
                                            device="cpu")
            assert_tie_aware_equal(got, want, objective, f"seed={seed} k={k} {objective}")


@pytest.mark.parametrize("family", FAMILIES)
def test_torch_dominance_mask_equals_numpy(family):
    res, rres = sweep_result(family)
    want = portfolio_candidates(res.hw.area, res.cell_time)
    for chunk in (7, 512):
        got = portfolio_candidates(res.hw.area, res.cell_time, chunk=chunk, device="cpu")
        assert got.dtype == want.dtype == bool
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(want, r_portfolio_candidates(rres.hw.area, rres.cell_time))


def test_torch_engine_needs_a_card_or_cpu(monkeypatch, tmp_path):
    import torch

    res, _ = sweep_result("gtx980")
    store, sweep_key = _stencil_store(tmp_path, downsample=STRIDE)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        optimize_portfolio(res, 2, 900.0, engine="torch")
    # the torch engine on the card is the default of every entry point
    with pytest.raises(RuntimeError, match="no CUDA device"):
        optimize_portfolio(res, 2, 900.0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_portfolio(store, sweep_key, 2, 900.0)
    assert optimize_portfolio(res, 2, 900.0, device="cpu").engine == "torch"


@pytest.mark.parametrize("family", FAMILIES)
def test_k1_throughput_is_exactly_best(family):
    """The K=1 degeneracy: same argmax index, bit-equal GFLOP/s."""
    res, _ = sweep_result(family)
    area = np.asarray(res.hw.area, np.float64)
    for budget in [float(area.min()), *budgets_for(res)]:
        best_i, best_g = res.best(max_area=budget)
        r = optimize_portfolio(res, 1, budget, objective="throughput", engine="numpy")
        assert r.members == (best_i,)
        assert r.fleet_gflops == best_g
        assert r.total_area == float(area[best_i])


def _ref_stencil_store(root, gpu="gtx980"):
    store = RS.ArtifactStore(str(root))
    srv = RS.CodesignServer(store, gpu=R_GPUS[gpu], downsample=STRIDE,
                            engine="numpy", batch_window=0.0)
    srv.ensure_artifact()
    return store, srv.key


def test_numpy_portfolio_key_and_bytes_match_the_reference(tmp_path):
    store, sweep_key = _stencil_store(tmp_path / "port", downsample=STRIDE)
    rstore, rsweep_key = _ref_stencil_store(tmp_path / "ref")
    assert sweep_key == rsweep_key
    for k, budget, objective in ((1, 450.0, "throughput"), (2, 900.0, "throughput"),
                                 (3, 900.0, "density")):
        art, _ = build_portfolio(store, sweep_key, k, budget, objective=objective,
                                 engine="numpy")
        rart, _ = r_build_portfolio(rstore, rsweep_key, k, budget, objective=objective)
        assert art.key == rart.key
        with open(f"{art.path}/manifest.json", "rb") as f, \
                open(f"{rart.path}/manifest.json", "rb") as g:
            assert f.read() == g.read()
    # each package routes the other's portfolio with the same bytes
    port = ArtifactStore(store.root)  # the port's store, reopened
    ref_in_port = ArtifactStore(rstore.root)  # the reference's, read by the port
    port_in_ref = RS.ArtifactStore(store.root)  # the port's, read by the reference
    for cell in ("heat2d", "laplacian3d"):
        req = RouteRequest(cell=cell)
        want = wire.encode_route_response(
            PortfolioServer(port.get(art.key), port.get(sweep_key)).route(req))
        got = PortfolioServer(ref_in_port.get(rart.key), ref_in_port.get(rsweep_key)).route(req)
        assert wire.encode_route_response(got) == want
        ref = RS.PortfolioServer(port_in_ref.get(art.key), port_in_ref.get(sweep_key))
        assert RS.wire.encode_route_response(ref.route(RS.RouteRequest(cell=cell))) == want


def test_torch_portfolio_keys_apart_from_numpy(tmp_path):
    store, sweep_key = _stencil_store(tmp_path, downsample=STRIDE)
    art_np, r_np = build_portfolio(store, sweep_key, 2, 900.0, engine="numpy")
    art_t, r_t = build_portfolio(store, sweep_key, 2, 900.0, device="cpu")  # the default engine
    assert art_t.payload["engine"] == "torch" and art_t.key != art_np.key
    assert_tie_aware_equal(r_t, r_np, "density", "build_portfolio")


def test_fleet_never_worse_than_single_design():
    res, _ = sweep_result("gtx980")
    for budget in budgets_for(res):
        _, best_g = res.best(max_area=budget)
        r = optimize_portfolio(res, 3, budget, objective="throughput", device="cpu")
        assert r.fleet_gflops >= best_g * (1 - 1e-12)


def test_infeasible_budget_raises():
    res, _ = sweep_result("gtx980")
    tiny = float(np.asarray(res.hw.area).min()) / 2
    with pytest.raises(ValueError, match="no feasible portfolio"):
        optimize_portfolio(res, 2, tiny, device="cpu")


def test_max_subsets_guard():
    res, _ = sweep_result("gtx980")
    with pytest.raises(ValueError, match="max_subsets"):
        optimize_portfolio(res, 3, 1e9, max_subsets=10, device="cpu")


def test_bad_args_rejected():
    res, _ = sweep_result("gtx980")
    with pytest.raises(ValueError, match="objective"):
        optimize_portfolio(res, 1, 100.0, objective="latency", device="cpu")
    with pytest.raises(ValueError, match="engine"):
        optimize_portfolio(res, 1, 100.0, engine="fortran")
    # the JAX package's scorer is no engine of the port's
    with pytest.raises(ValueError, match="engine must be 'numpy' or 'torch', got 'jax'"):
        optimize_portfolio(res, 1, 100.0, engine="jax")
    with pytest.raises(ValueError, match="k must be"):
        optimize_portfolio(res, 0, 100.0, device="cpu")
    with pytest.raises(ValueError, match="freqs"):
        optimize_portfolio_arrays(
            np.ones(2), np.ones((1, 2)), np.ones(1), -np.ones(1), 1, 10.0, device="cpu"
        )


# ---------------------------------------------------------------------------
# persistence: deterministic manifests, store round trip
# ---------------------------------------------------------------------------


def _stencil_store(tmp_path, gpu="gtx980", downsample=64):
    store = ArtifactStore(str(tmp_path))
    srv = CodesignServer(
        store, gpu=GPUS_BY_NAME[gpu], downsample=downsample, engine="numpy",
        batch_window=0.0,
    )
    srv.ensure_artifact()
    return store, srv.key


def test_build_portfolio_persists_deterministically(tmp_path):
    store, sweep_key = _stencil_store(tmp_path)
    art1, res1 = build_portfolio(store, sweep_key, 2, 900.0, device="cpu")
    art2, res2 = build_portfolio(store, sweep_key, 2, 900.0, device="cpu")
    assert art1.key == art2.key
    assert res1.members == res2.members

    # canonical manifest bytes are stable across processes/instances
    raw1 = json.dumps(art1.manifest, sort_keys=True, separators=(",", ":"))
    reopened = ArtifactStore(str(tmp_path))
    raw2 = json.dumps(
        reopened.get(art1.key).manifest, sort_keys=True, separators=(",", ":")
    )
    assert raw1 == raw2

    # payload carries the optimization decision + provenance
    p = art1.payload
    assert p["sweep_key"] == sweep_key
    assert p["members"] == list(res1.members)
    assert {g["label"] for g in p["groups"]} >= {"heat2d", "jacobi2d"}
    for g in p["groups"]:
        assert g["slot"] in range(len(res1.members))
        assert sorted(g["preference"]) == list(range(len(res1.members)))

    # a different budget is a different decision -> a different key
    art3, _ = build_portfolio(store, sweep_key, 2, 450.0, device="cpu")
    assert art3.key != art1.key

    # the store indexes it with routing inherited from the sweep
    row = [e for e in store.entries() if e["key"] == art1.key]
    assert row and row[0]["kind"] == "portfolio" and row[0]["gpu"] == "gtx980"


def test_build_portfolio_rejects_non_sweep(tmp_path):
    store, sweep_key = _stencil_store(tmp_path)
    art, _ = build_portfolio(store, sweep_key, 1, 900.0, device="cpu")
    with pytest.raises(ValueError, match="kind"):
        build_portfolio(store, art.key, 1, 900.0, device="cpu")
    with pytest.raises(KeyError, match="no stored sweep"):
        build_portfolio(store, "deadbeef", 1, 900.0, device="cpu")


# ---------------------------------------------------------------------------
# routing: gateway (in-process and HTTP) vs the PortfolioServer oracle
# ---------------------------------------------------------------------------


def test_route_byte_identity_and_errors(tmp_path):
    store, sweep_key = _stencil_store(tmp_path)
    art, _ = build_portfolio(store, sweep_key, 2, 900.0, device="cpu")
    oracle = PortfolioServer(store.get(art.key), store.get(sweep_key))
    gw = Gateway([str(tmp_path)], batch_window=0.0)

    for cell in oracle.cell_labels():
        req = RouteRequest(cell=cell)
        want = wire.encode_route_response(oracle.route(req))
        got = wire.encode_route_response(gw.route(req, route={"gpu": "gtx980"}))
        assert got == want, f"gateway route for {cell!r} diverged"
        # explicit artifact pinning takes the same path
        got_pinned = wire.encode_route_response(gw.route(req, artifact=art.key))
        assert got_pinned == want

    with pytest.raises(UnknownCellError):
        gw.route(RouteRequest(cell="not-a-cell"), artifact=art.key)
    with pytest.raises(WrongArtifactKindError):
        gw.route(RouteRequest(cell="heat2d"), artifact=sweep_key)

    httpd = serve_http(gw)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    try:
        host, port = httpd.server_address[:2]
        client = GatewayClient(f"http://{host}:{port}")
        for cell in oracle.cell_labels():
            req = RouteRequest(cell=cell)
            body = client.route_bytes(req, route={"gpu": "gtx980"})
            assert body == wire.encode_route_response(oracle.route(req))
        resp = client.route("heat2d", artifact=art.key)
        assert resp == oracle.route(RouteRequest(cell="heat2d"))
        assert not resp.degraded and resp.fallback_from == ()
        with pytest.raises(wire.RemoteError) as exc:
            client.route("not-a-cell", artifact=art.key)
        assert exc.value.code == "unknown_cell"
    finally:
        httpd.shutdown()
        httpd.server_close()


def test_route_wire_codec_round_trip():
    req = RouteRequest(cell="llama3-8b:decode")
    data = wire.encode_route_request(
        req, artifact="abc123", route={"gpu": "tpu_v5e"}, deadline_ms=250.0
    )
    got, artifact, route, deadline = wire.decode_route_request_full(data)
    assert got == req and artifact == "abc123"
    assert route == {"gpu": "tpu_v5e"} and deadline == 250.0

    with pytest.raises(wire.WireError):
        wire.decode_route_request_full(
            json.dumps({"v": 1, "request": {"cell": "x", "bogus": 1}}).encode()
        )
    with pytest.raises(wire.WireError):
        wire.decode_route_request_full(
            json.dumps({"v": 1, "request": {"cell": ""}}).encode()
        )


def test_lm_portfolio_key_bytes_and_routes_match_the_reference(tmp_path):
    """A K=2 fleet over the LM sweep (Llama-3-8B, 64 chips; budgets are
    chip counts): a numpy portfolio built by either package has the same
    key and manifest bytes, routes every model:op group with the same
    bytes, and the default torch engine (here on the CPU) agrees with it."""
    from repro.core.lmcells import lm_workload as r_lm_workload
    from repro_torch.core.lmcells import lm_workload
    from repro_torch.service.server import LMServer

    store = ArtifactStore(str(tmp_path / "port"))
    srv = LMServer(store, workload=lm_workload(archs=("llama3-8b",)), max_chips=64,
                   engine="numpy", batch_window=0.0)
    srv.ensure_artifact()
    rstore = RS.ArtifactStore(str(tmp_path / "ref"))
    rsrv = RS.LMServer(rstore, workload=r_lm_workload(archs=("llama3-8b",)), max_chips=64,
                       engine="numpy", batch_window=0.0)
    rsrv.ensure_artifact()
    assert srv.key == rsrv.key
    for k, budget, objective in ((2, 64.0, "throughput"), (2, 128.0, "density")):
        art, res = build_portfolio(store, srv.key, k, budget, objective=objective, engine="numpy")
        rart, _ = r_build_portfolio(rstore, rsrv.key, k, budget, objective=objective)
        assert art.key == rart.key
        with open(f"{art.path}/manifest.json", "rb") as f, open(f"{rart.path}/manifest.json", "rb") as g:
            assert f.read() == g.read()
        router = PortfolioServer(store.get(art.key), store.get(srv.key))
        rrouter = RS.PortfolioServer(rstore.get(rart.key), rstore.get(rsrv.key))
        assert sorted(router.cell_labels()) == ["llama3-8b:decode", "llama3-8b:prefill", "llama3-8b:train"]
        for cell in router.cell_labels():
            assert wire.encode_route_response(router.route(RouteRequest(cell=cell))) == \
                RS.wire.encode_route_response(rrouter.route(RS.RouteRequest(cell=cell)))
        _, got = build_portfolio(store, srv.key, k, budget, objective=objective, device="cpu")
        assert_tie_aware_equal(got, res, objective, f"lm k={k} {objective}")
