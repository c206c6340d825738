"""The port's artifact store, query engine and in-process server against the
JAX package's.

* Keys: ``engine="numpy"`` keys are the reference's; ``"jax"`` and
  ``"sharded"`` digest as one key in both packages; the port's ``"torch"``
  matrix never shares a key with ``"jax"`` or ``"numpy"``.
* Bytes: a numpy build writes the reference's ``manifest.json`` and
  ``cell_time.npy`` byte for byte, and the same ``arrays.npz`` members.
* Each package serves the other's artifact with exactly equal answers.
* The LM family, on the default question (Llama-3-8B + Mixtral-8x22B, 512
  chips): numpy, jax and sharded keys are the reference's, torch keys
  apart; a numpy build writes the reference's bytes; each package serves
  the other's numpy LM artifact with the same wire bytes; a port-built
  torch LM artifact serves from the port and the reference refuses it.
* The reference's own service tests (``tests/test_service.py``), run on the
  port: round trip, stale format, reuse without restaging, the build lock
  across processes, an engine-free warm path, top-k, what-if, infeasible
  requests, unknown stencils, microbatch vs sequential, poison pill, LRU.

Everything runs on the CPU (``device="cpu"``) at ``STRIDE = 32``, about 160
hardware points; inputs come from numpy seeds.
"""

import dataclasses
import importlib
import json
import os
import threading

import numpy as np
import pytest

import repro.core as R
import repro.service as RS
from repro.core.workload import paper_workload as r_paper_workload
from repro_torch.core import MAXWELL, MAXWELL_GPU, codesign, enumerate_hw_space
from repro_torch.core.pareto import pareto_mask, pareto_mask_batched
from repro_torch.core.workload import paper_workload
from repro_torch.service import (
    ArtifactStore,
    CodesignServer,
    LMServer,
    QueryEngine,
    QueryRequest,
    artifact_spec,
    server_from_artifact,
    spec_key,
)
from repro_torch.service import store as store_mod

#: stride 32 of the 5,121-point space: 161 points, above the engines'
#: auto threshold of 64
STRIDE = 32


def small_hw(step=STRIDE):
    return enumerate_hw_space(MAXWELL, max_area=650.0).downsample(step)


def r_small_hw(step=STRIDE):
    return R.enumerate_hw_space(R.MAXWELL, max_area=650.0).downsample(step)


def _mixes(names, n, seed):
    rng = np.random.default_rng(seed)
    return [dict(zip(names, rng.uniform(0.1, 1.0, size=len(names)))) for _ in range(n)]


def _requests(names, seed=5):
    """Mixes, budgets, top-k, Pareto and what-ifs, from a numpy seed."""
    rng = np.random.default_rng(seed)
    reqs = [QueryRequest(), QueryRequest(max_area=1.0), QueryRequest(fix={"n_sm": 17.0})]
    for i, freqs in enumerate(_mixes(names, 6, seed)):
        reqs.append(QueryRequest(
            freqs=freqs, max_area=float(rng.uniform(300, 650)), top_k=1 + i % 4,
            pareto=i % 2 == 0, fix={"n_sm": 16.0} if i % 3 == 0 else None,
        ))
    return reqs


def _as_ref(req):
    return RS.QueryRequest(**dataclasses.asdict(req))


def assert_same_response(got, want):
    """Field by field, exactly; Pareto indices as arrays."""
    g, w = dataclasses.asdict(got), dataclasses.asdict(want)
    gp, wp = g.pop("pareto_indices"), w.pop("pareto_indices")
    assert g == w
    assert (gp is None) == (wp is None)
    if wp is not None:
        np.testing.assert_array_equal(gp, wp)


@pytest.fixture(scope="module")
def built(tmp_path_factory):
    """The port's store with the default (auto -> torch) sweep built through
    the server's miss path, plus an independent in-process result."""
    store = ArtifactStore(str(tmp_path_factory.mktemp("torch-store")))
    hw = small_hw()
    srv = CodesignServer(store, hw=hw, engine="auto", device="cpu", batch_window=0.0)
    srv.ensure_artifact()
    fresh = codesign(paper_workload(), hw=hw, engine="auto", device="cpu")
    return store, srv, fresh


@pytest.fixture(scope="module")
def numpy_pair(tmp_path_factory):
    """The same numpy-engine sweep built by each package into its own store."""
    port = ArtifactStore(str(tmp_path_factory.mktemp("port-numpy")))
    ref = RS.ArtifactStore(str(tmp_path_factory.mktemp("ref-numpy")))
    p_art = port.put(codesign(paper_workload(), hw=small_hw(), engine="numpy"), engine="numpy")
    r_art = ref.put(R.codesign(r_paper_workload(), hw=r_small_hw(), engine="numpy"), engine="numpy")
    return port, p_art, ref, r_art


# ---------------------------------------------------------------------------
# keys
# ---------------------------------------------------------------------------
def test_numpy_key_is_the_reference_key():
    wl, rwl = paper_workload(), r_paper_workload()
    for hw, rhw in ((small_hw(), r_small_hw()), (small_hw(128), r_small_hw(128))):
        spec = artifact_spec(wl, MAXWELL_GPU, hw, "numpy")
        assert spec == RS.artifact_spec(rwl, R.MAXWELL_GPU, rhw, "numpy")
        assert spec_key(spec) == RS.spec_key(spec)
    heat = paper_workload(["heat2d"])
    assert spec_key(artifact_spec(heat, MAXWELL_GPU, small_hw(), "numpy")) == RS.spec_key(
        RS.artifact_spec(r_paper_workload(["heat2d"]), R.MAXWELL_GPU, r_small_hw(), "numpy")
    )


def test_jax_and_sharded_share_one_key_in_both_packages():
    wl, rwl, hw, rhw = paper_workload(), r_paper_workload(), small_hw(), r_small_hw()
    port = {e: spec_key(artifact_spec(wl, MAXWELL_GPU, hw, e)) for e in ("jax", "sharded")}
    ref = {e: RS.spec_key(RS.artifact_spec(rwl, R.MAXWELL_GPU, rhw, e)) for e in ("jax", "sharded")}
    assert port["jax"] == port["sharded"] == ref["jax"] == ref["sharded"]


def test_torch_never_shares_a_key_with_jax_or_numpy():
    wl, hw = paper_workload(), small_hw()
    assert len(hw) >= 64
    keys = {e: spec_key(artifact_spec(wl, MAXWELL_GPU, hw, e)) for e in ("auto", "torch", "numpy", "jax")}
    assert artifact_spec(wl, MAXWELL_GPU, hw, "auto")["engine"] == "torch"
    assert keys["auto"] == keys["torch"]
    assert len({keys["torch"], keys["numpy"], keys["jax"]}) == 3
    # the reference resolves auto to its own compiled engine: another key
    r_auto = RS.spec_key(RS.artifact_spec(r_paper_workload(), R.MAXWELL_GPU, r_small_hw(), "auto"))
    assert keys["auto"] != r_auto
    # below 64 points auto is the numpy oracle in both packages: one key
    tiny = small_hw(128)
    assert len(tiny) < 64
    assert spec_key(artifact_spec(wl, MAXWELL_GPU, tiny, "auto")) == RS.spec_key(
        RS.artifact_spec(r_paper_workload(), R.MAXWELL_GPU, r_small_hw(128), "auto")
    )
    with pytest.raises(ValueError, match="unknown engine"):
        artifact_spec(wl, MAXWELL_GPU, hw, "cuda")


# ---------------------------------------------------------------------------
# the LM family: keys, bytes, each package serving the other's
# ---------------------------------------------------------------------------
LM_ARCHS = ("llama3-8b", "mixtral-8x22b")


def _lm_requests(seed=7):
    """LM queries: the docs' decode mix under 64 chips, model and op
    groups, what-ifs, Pareto, an infeasible budget, seeded mixes."""
    rng = np.random.default_rng(seed)
    reqs = [
        QueryRequest(freqs={"llama3-8b:decode": 1.0}, max_area=64.0, top_k=3),
        QueryRequest(freqs={"mixtral-8x22b": 1.0}, top_k=5, pareto=True),
        QueryRequest(freqs={"train": 1.0}, fix={"model": 8.0}),
        QueryRequest(max_area=0.5),
        QueryRequest(),
    ]
    labels = [f"{a}:{op}" for a in LM_ARCHS for op in ("prefill", "decode", "train")]
    for i in range(4):
        reqs.append(QueryRequest(freqs=dict(zip(labels, rng.uniform(0.1, 1.0, len(labels)).tolist())),
                                 max_area=float(rng.choice([128, 256, 512])), top_k=1 + i,
                                 pareto=i % 2 == 0))
    return reqs


@pytest.fixture(scope="module")
def lm_pair(tmp_path_factory):
    """The default LM question (Llama-3-8B + Mixtral-8x22B, 512 chips),
    numpy-built by each package into its own store."""
    from repro.core.lmcells import lm_codesign as r_lm_codesign
    from repro.core.lmcells import lm_workload as r_lm_workload
    from repro_torch.core.lmcells import lm_codesign, lm_workload

    port = ArtifactStore(str(tmp_path_factory.mktemp("port-lm")))
    ref = RS.ArtifactStore(str(tmp_path_factory.mktemp("ref-lm")))
    p_art = port.put(lm_codesign(lm_workload(LM_ARCHS), engine="numpy"), engine="numpy")
    r_art = ref.put(r_lm_codesign(r_lm_workload(LM_ARCHS), engine="numpy"), engine="numpy")
    return port, p_art, ref, r_art


def test_lm_keys_are_the_references():
    from repro.core.lmcells import enumerate_lm_hw_space as r_hw_space
    from repro.core.lmcells import lm_workload as r_lm_workload
    from repro.service.store import lm_artifact_spec as r_lm_artifact_spec
    from repro_torch.core.lmcells import enumerate_lm_hw_space, lm_workload
    from repro_torch.service.store import lm_artifact_spec

    wl, rwl = lm_workload(LM_ARCHS), r_lm_workload(LM_ARCHS)
    for chips in (512, 64, 32):
        hw, rhw = enumerate_lm_hw_space(chips), r_hw_space(chips)
        for engine in ("numpy", "jax", "sharded"):
            spec = lm_artifact_spec(wl, hw, engine, "tpu_v5e")
            assert spec == r_lm_artifact_spec(rwl, rhw, engine, "tpu_v5e")
            assert spec_key(spec) == RS.spec_key(spec)
        store = ArtifactStore.__new__(ArtifactStore)  # key_for_lm reads no store state
        keys = {e: store.key_for_lm(wl, hw, e) for e in ("numpy", "torch", "jax", "auto")}
        assert len({keys["numpy"], keys["torch"], keys["jax"]}) == 3
        # auto: numpy below 64 mesh points, else the port's torch matrix
        assert keys["auto"] == (keys["numpy"] if len(hw) < 64 else keys["torch"])
    with pytest.raises(ValueError, match="unknown engine"):
        lm_artifact_spec(wl, enumerate_lm_hw_space(64), "cuda", "tpu_v5e")


def test_lm_numpy_build_writes_the_reference_bytes(lm_pair):
    _, p_art, _, r_art = lm_pair
    assert p_art.key == r_art.key and p_art.family == "lm"
    for name in ("manifest.json", "cell_time.npy"):
        with open(os.path.join(p_art.path, name), "rb") as a, open(os.path.join(r_art.path, name), "rb") as b:
            assert a.read() == b.read(), name
    with np.load(os.path.join(p_art.path, "arrays.npz")) as a, \
            np.load(os.path.join(r_art.path, "arrays.npz")) as b:
        assert sorted(a.files) == sorted(b.files) and "cell_plan_idx" in a.files
        for name in b.files:
            assert a[name].dtype == b[name].dtype, name
            np.testing.assert_array_equal(a[name], b[name])


@pytest.mark.parametrize("direction", ["reference_artifact_in_port", "port_artifact_in_reference"])
def test_each_package_serves_the_others_lm_artifact(lm_pair, direction):
    """Each package opens the other's numpy LM artifact (re-deriving its
    key) and answers with the bytes the builder's own server gives."""
    from repro_torch.service import wire

    port, p_art, ref, r_art = lm_pair
    port_srv = server_from_artifact(port, p_art, batch_window=0.0)
    ref_srv = RS.server_from_artifact(ref, r_art, batch_window=0.0)
    if direction == "reference_artifact_in_port":
        other = ArtifactStore(ref.root)
        port_srv = server_from_artifact(other, other.get(r_art.key), batch_window=0.0)
    else:
        other = RS.ArtifactStore(port.root)
        ref_srv = RS.server_from_artifact(other, other.get(p_art.key), batch_window=0.0)
    assert isinstance(port_srv, LMServer) and type(ref_srv).__name__ == "LMServer"
    assert port_srv.key == ref_srv.key == p_art.key
    for req in _lm_requests():
        got = wire.encode_response(port_srv.query(req))
        assert got == RS.wire.encode_response(ref_srv.query(_as_ref(req))), req


def test_port_torch_lm_artifact_and_the_reference(tmp_path):
    """A port-built ``"torch"`` LM artifact serves from the port, with the
    numpy artifact's answers (the CPU torch engine is bit-identical); the
    reference's LM digest rejects the engine name, so it refuses to open
    it (ROADMAP Queue 3), where it serves the port's stencil ``"torch"``
    artifacts (``test_port_torch_artifact_served_by_the_reference``)."""
    from repro_torch.core.lmcells import enumerate_lm_hw_space, lm_codesign, lm_workload
    from repro_torch.service import wire

    store = ArtifactStore(str(tmp_path))
    wl = lm_workload(LM_ARCHS)
    art = store.put(lm_codesign(wl, engine="torch", device="cpu"), engine="torch")
    assert art.manifest["spec"]["engine"] == "torch"
    assert art.key == store.key_for_lm(wl, enumerate_lm_hw_space(512), "torch")
    np_art = store.put(lm_codesign(wl, engine="numpy"), engine="numpy")
    assert np_art.key != art.key
    srv = server_from_artifact(store, art, batch_window=0.0)
    oracle = server_from_artifact(store, np_art, batch_window=0.0)
    for req in _lm_requests():
        want = dataclasses.replace(oracle.query(req), artifact_key=art.key)
        assert wire.encode_response(srv.query(req)) == wire.encode_response(want)
    rstore = RS.ArtifactStore(str(tmp_path))
    with pytest.raises(ValueError, match="unknown engine 'torch'"):
        RS.server_from_artifact(rstore, rstore.get(art.key))


def test_lm_manifest_json_reads(tmp_path):
    lm = ArtifactStore(str(tmp_path))
    d = tmp_path / "lmkey"
    d.mkdir()
    cells = [{"model": "llama3-8b", "op": "decode", "freq": 0.5, "consts": {"flops": 2.0}},
             {"model": "llama3-8b", "op": "train", "freq": 0.5, "consts": {"flops": 4.0}}]
    (d / "manifest.json").write_text(json.dumps({
        "format_version": store_mod.FORMAT_VERSION, "kind": "sweep", "key": "lmkey",
        "spec": {"engine": "numpy"}, "shapes": {"cells": 2, "hw": 3}, "gpu": {"name": "tpu_v5e"},
        "workload": {"name": "lm", "family": "lm", "cells": cells},
    }))
    art = lm.get("lmkey")
    assert art.family == "lm" and art.cell_labels == ["llama3-8b:decode", "llama3-8b:train"]
    np.testing.assert_array_equal(art.cell_flops(), [2.0, 4.0])
    assert art.routing()["models"] == ["llama3-8b"]


# ---------------------------------------------------------------------------
# bytes and cross-package serving
# ---------------------------------------------------------------------------
def test_numpy_build_writes_the_reference_bytes(numpy_pair):
    _, p_art, _, r_art = numpy_pair
    assert p_art.key == r_art.key
    for name in ("manifest.json", "cell_time.npy"):
        with open(os.path.join(p_art.path, name), "rb") as a, open(os.path.join(r_art.path, name), "rb") as b:
            assert a.read() == b.read(), name
    with np.load(os.path.join(p_art.path, "arrays.npz")) as a, \
            np.load(os.path.join(r_art.path, "arrays.npz")) as b:
        assert sorted(a.files) == sorted(b.files)
        for name in b.files:
            assert a[name].dtype == b[name].dtype, name
            np.testing.assert_array_equal(a[name], b[name])


@pytest.mark.parametrize("engine", ["numpy", "jax"])
def test_reference_artifact_served_by_the_port(numpy_pair, tmp_path, engine):
    if engine == "numpy":
        _, _, ref, r_art = numpy_pair
    else:
        ref = RS.ArtifactStore(str(tmp_path))
        r_art = ref.put(R.codesign(r_paper_workload(), hw=r_small_hw(), engine="jax"), engine="jax")
    r_srv = RS.CodesignServer.from_artifact(ref, r_art, batch_window=0.0)
    port = ArtifactStore(ref.root, create=False)
    srv = server_from_artifact(port, port.get(r_art.key), batch_window=0.0)
    assert srv.key == r_art.key and srv.engine == engine
    names = [st.name for st in paper_workload().stencils]
    for req in _requests(names):
        assert_same_response(srv.query(req), r_srv.query(_as_ref(req)))
    assert srv.stats["artifact_builds"] == 0


def test_port_torch_artifact_served_by_the_reference(built):
    store, srv, _ = built
    art = store.get(srv.key)
    assert art.manifest["spec"]["engine"] == "torch"
    ref = RS.ArtifactStore(store.root, create=False)
    r_srv = RS.CodesignServer.from_artifact(ref, ref.get(srv.key), batch_window=0.0)
    assert r_srv.key == srv.key  # the reference re-keys a "torch" artifact
    names = [st.name for st in paper_workload().stencils]
    for req in _requests(names, seed=9):
        assert_same_response(srv.query(req), r_srv.query(_as_ref(req)))


# ---------------------------------------------------------------------------
# the reference's service tests, on the port
# ---------------------------------------------------------------------------
def test_artifact_round_trip_bit_identical(built):
    store, srv, fresh = built
    art = store.get(srv.key)
    assert art is not None
    res = art.to_result()
    np.testing.assert_array_equal(res.weighted_time(), fresh.weighted_time())
    np.testing.assert_array_equal(res.gflops(), fresh.gflops())
    np.testing.assert_array_equal(res.pareto(), fresh.pareto())
    np.testing.assert_array_equal(np.asarray(res.cell_time), fresh.cell_time)
    np.testing.assert_array_equal(np.asarray(res.cell_tile_idx), fresh.cell_tile_idx)
    ci, hi = 0, int(np.nonzero(fresh.cell_tile_idx[0] >= 0)[0][0])
    assert res.tiles_for(ci, hi) == fresh.tiles_for(ci, hi)
    assert art.routing()["engine"] == "torch" and art.routing()["gpu"] == "gtx980"


def test_store_key_tracks_hardware_spec(built):
    store, srv, _ = built
    wl = paper_workload()
    base = store.key_for(wl, MAXWELL_GPU, small_hw(), "auto")
    assert base == srv.key
    assert store.key_for(wl, MAXWELL_GPU, small_hw(), "auto") == base
    assert store.key_for(wl, MAXWELL_GPU, small_hw(step=16), "auto") != base
    hw2 = enumerate_hw_space(MAXWELL, max_area=500.0).downsample(STRIDE)
    assert store.key_for(wl, MAXWELL_GPU, hw2, "auto") != base
    assert store.key_for(paper_workload(["heat2d"]), MAXWELL_GPU, small_hw(), "auto") != base
    assert store.key_for(wl, MAXWELL_GPU, small_hw(), "numpy") != base
    spec = artifact_spec(wl, MAXWELL_GPU, small_hw(), "auto")
    spec["format_version"] += 1
    assert spec_key(spec) != base
    # frequencies are not in the key: re-weighting is free
    assert store.key_for(paper_workload(name="paper-uniform"), MAXWELL_GPU, small_hw(), "auto") == base


def test_stale_format_version_reads_as_miss(built, monkeypatch):
    store, srv, _ = built
    assert store.get(srv.key) is not None
    monkeypatch.setattr(store_mod, "FORMAT_VERSION", store_mod.FORMAT_VERSION + 1)
    assert store.get(srv.key) is None


def test_put_same_key_reuses_winner_without_restaging(built):
    store, srv, fresh = built
    art = store.get(srv.key)
    manifest_path = os.path.join(art.path, "manifest.json")
    mtime = os.stat(manifest_path).st_mtime_ns
    again = store.put(fresh, engine="auto")
    assert again.key == srv.key
    assert os.stat(manifest_path).st_mtime_ns == mtime
    assert os.path.exists(os.path.join(store.root, f".lock-{srv.key}"))


@pytest.mark.skipif(store_mod.fcntl is None, reason="no fcntl: build_lock degrades to a no-op")
def test_build_lock_excludes_across_processes(built, subprocess_env):
    import subprocess
    import sys
    import time as _time

    store, _, _ = built
    child = """
import sys
from repro_torch.service.store import ArtifactStore
store = ArtifactStore(sys.argv[1])
print("WAITING", flush=True)
with store.build_lock(sys.argv[2]):
    print("ACQUIRED", flush=True)
"""
    key = "lock-contention-test"
    with store.build_lock(key):
        with store.build_lock(key):  # reentrant within the process
            pass
        proc = subprocess.Popen(
            [sys.executable, "-c", child, store.root, key],
            stdout=subprocess.PIPE, text=True, env=subprocess_env,
        )
        assert proc.stdout.readline().strip() == "WAITING"
        _time.sleep(0.3)
        assert proc.poll() is None, "child acquired a held exclusive lock"
    out, _ = proc.communicate(timeout=60)
    assert "ACQUIRED" in out


def test_warm_query_is_engine_free_and_exact(built, monkeypatch):
    store, _, fresh = built

    def boom(*a, **k):  # noqa: ARG001
        raise AssertionError("sweep engine invoked on the warm path")

    codesign_mod = importlib.import_module("repro_torch.core.codesign")
    solver_mod = importlib.import_module("repro_torch.core.solver")
    sweep_mod = importlib.import_module("repro_torch.core.sweep")
    server_mod = importlib.import_module("repro_torch.service.server")
    for mod, name in ((solver_mod, "solve_cell"), (codesign_mod, "solve_cell"),
                      (codesign_mod, "codesign"), (server_mod, "codesign"),
                      (sweep_mod, "sweep_cell"), (sweep_mod, "sweep_cells")):
        monkeypatch.setattr(mod, name, boom)

    srv = CodesignServer(store, hw=small_hw(), engine="auto", batch_window=0.0)
    assert srv.warm
    names = [st.name for st in fresh.workload.stencils]
    assert len(names) == 6
    for freqs in _mixes(names, 3, seed=7):
        resp = srv.query(QueryRequest(freqs=freqs, max_area=500.0))
        vec = np.zeros(len(fresh.workload.cells))
        for name, wt in freqs.items():
            cells = [i for i, c in enumerate(fresh.workload.cells) if c.stencil.name == name]
            base = np.array([fresh.workload.cells[i].freq for i in cells])
            vec[cells] = float(wt) * base / base.sum()
        vec /= vec.sum()
        i_ref, g_ref = fresh.best(max_area=500.0, freqs=vec)
        assert resp.best_index == i_ref
        assert resp.best_gflops == g_ref
        resp_p = srv.query(QueryRequest(freqs=freqs, pareto=True))
        np.testing.assert_array_equal(resp_p.pareto_indices, np.nonzero(fresh.pareto(vec))[0])
    assert srv.stats["artifact_builds"] == 0


def test_top_k_is_sorted_and_within_budget(built):
    _, srv, fresh = built
    resp = srv.query(QueryRequest(max_area=450.0, top_k=5))
    assert 1 <= len(resp.top_k) <= 5
    gs = [r["gflops"] for r in resp.top_k]
    assert gs == sorted(gs, reverse=True)
    assert all(r["area"] <= 450.0 for r in resp.top_k)
    assert resp.top_k[0]["index"] == resp.best_index
    assert resp.best_index == fresh.best(max_area=450.0)[0]


def test_what_if_fix_restricts_subspace(built):
    _, srv, _ = built
    resp = srv.query(QueryRequest(fix={"n_sm": 16.0}))
    assert resp.best_point["n_sm"] == 16
    assert resp.baseline_best_index is not None
    assert resp.best_gflops <= resp.baseline_best_gflops + 1e-12


@pytest.mark.parametrize("req", [QueryRequest(fix={"n_sm": 17.0}), QueryRequest(max_area=1.0)],
                         ids=["odd-n_sm", "tiny-budget"])
def test_infeasible_constraints_signal_not_fallback(built, req):
    _, srv, _ = built
    resp = srv.query(req)
    assert resp.best_index == -1
    assert resp.best_point == {}
    assert resp.top_k == []
    assert resp.best_gflops == -np.inf


def test_unknown_stencil_is_rejected_without_poisoning(built):
    _, srv, _ = built
    with pytest.raises(KeyError, match="not in artifact"):
        srv.query(QueryRequest(freqs={"nosuch": 1.0}))
    assert np.isfinite(srv.query(QueryRequest()).best_gflops)


def test_pareto_mask_batched_matches_sequential():
    rng = np.random.default_rng(3)
    cost = rng.uniform(100, 650, size=200)
    cost[::17] = cost[0]
    perf = rng.uniform(10, 1e4, size=(5, 200))
    perf[2, ::13] = np.inf
    perf[3, ::11] = np.nan
    got = pareto_mask_batched(cost, perf)
    for b in range(5):
        np.testing.assert_array_equal(got[b], pareto_mask(cost, perf[b]))


def test_concurrent_microbatched_queries_match_sequential(built):
    store, _, fresh = built
    srv_seq = CodesignServer(store, hw=small_hw(), engine="auto", batch_window=0.0)
    srv = CodesignServer(store, hw=small_hw(), engine="auto", batch_window=0.05)
    srv.ensure_artifact()
    names = [st.name for st in fresh.workload.stencils]
    rng = np.random.default_rng(11)
    reqs = [
        QueryRequest(freqs=dict(zip(names, rng.uniform(0.1, 1.0, size=6))),
                     max_area=float(rng.uniform(350, 650)), top_k=3, pareto=(i % 2 == 0))
        for i in range(8)
    ]
    sequential = [srv_seq.query(r) for r in reqs]
    out = [None] * len(reqs)
    barrier = threading.Barrier(len(reqs))

    def worker(i):
        barrier.wait()
        out[i] = srv.query(reqs[i])

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(len(reqs))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for got, want in zip(out, sequential):
        assert got.best_index == want.best_index
        assert got.best_gflops == pytest.approx(want.best_gflops, rel=1e-12)
        assert [r["index"] for r in got.top_k] == [r["index"] for r in want.top_k]
        if want.pareto_indices is not None:
            np.testing.assert_array_equal(got.pareto_indices, want.pareto_indices)
    assert srv.stats["max_batch"] > 1
    assert srv.stats["queries"] >= len(reqs)


def test_batched_rows_are_bit_identical_to_solo_rows(built):
    """A batch reduces each row with the lone request's expression, so every
    field of a batched answer equals the same request answered alone (the
    JAX package stacks one (B, C) @ (C, H) product, which some BLAS builds
    round differently, reordering exact ties between identical columns)."""
    store, srv, fresh = built
    eng = QueryEngine(store.get(srv.key), lru_size=0)
    ct = np.asarray(eng.artifact.cell_time)
    assert len(np.unique(ct.T, axis=0)) < ct.shape[1]  # identical columns exist
    names = [st.name for st in fresh.workload.stencils]
    reqs = _requests(names, seed=13) * 3
    for got, req in zip(eng.answer_many(reqs), reqs):
        want = eng.query(req)
        assert got.batch_size == len(reqs) and want.batch_size == 1
        got.batch_size = want.batch_size
        assert_same_response(got, want)


def test_one_bad_request_does_not_poison_the_batch(built):
    store, _, _ = built
    srv = CodesignServer(store, hw=small_hw(), engine="auto", batch_window=0.05)
    srv.ensure_artifact()
    results = {}
    barrier = threading.Barrier(2)

    def good():
        barrier.wait()
        results["good"] = srv.query(QueryRequest(max_area=500.0))

    def bad():
        barrier.wait()
        try:
            srv.query(QueryRequest(freqs={"nosuch": 1.0}))
        except KeyError as e:
            results["bad"] = e

    ts = [threading.Thread(target=good), threading.Thread(target=bad)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    assert isinstance(results["bad"], KeyError)
    assert np.isfinite(results["good"].best_gflops)


def test_lru_hit_and_eviction(built):
    store, srv, _ = built
    art = store.get(srv.key)
    eng = QueryEngine(art, lru_size=2)
    names = art.stencil_names
    reqs = [QueryRequest(freqs={names[i]: 1.0}) for i in range(4)]
    base = [eng.query(r) for r in reqs]
    assert eng.lru.hits == 0 and eng.lru.misses == 4
    assert len(eng.lru) == 2
    assert eng.lru.evictions == 2
    for r, want in zip(reqs[2:], base[2:]):
        got = eng.query(r)
        assert got.cached
        assert got.best_index == want.best_index
        assert got.best_gflops == want.best_gflops
    assert eng.lru.hits == 2
    again = eng.query(reqs[0])
    assert not again.cached
    assert again.best_index == base[0].best_index
    assert again.best_gflops == base[0].best_gflops


def test_use_cache_false_bypasses_lru(built):
    store, srv, _ = built
    eng = QueryEngine(store.get(srv.key), lru_size=8)
    r = QueryRequest(use_cache=False)
    a, b = eng.query(r), eng.query(r)
    assert not a.cached and not b.cached
    assert len(eng.lru) == 0
    assert a.best_index == b.best_index


def test_miss_path_without_a_card_raises(tmp_path):
    """The miss path sweeps on the card unless device="cpu" was asked for;
    the port's server never sweeps with the JAX package's engines."""
    import torch

    store = ArtifactStore(str(tmp_path))
    if not torch.cuda.is_available():
        srv = CodesignServer(store, hw=small_hw(), engine="torch", batch_window=0.0)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            srv.query(QueryRequest())
        assert not store.keys()
    jax_srv = CodesignServer(store, hw=small_hw(), engine="jax", device="cpu", batch_window=0.0)
    with pytest.raises(ValueError, match="unknown engine 'jax'"):
        jax_srv.query(QueryRequest())


def test_lm_miss_path_without_a_card_raises(tmp_path, monkeypatch):
    """An ``LMServer``'s miss path sweeps on the card unless device="cpu"
    was asked for (auto at 100 mesh points is torch); it never sweeps with
    the JAX package's engines."""
    import torch

    from repro_torch.core.lmcells import lm_workload

    store = ArtifactStore(str(tmp_path))
    wl = lm_workload(LM_ARCHS)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for engine in ("torch", "auto"):
        srv = LMServer(store, workload=wl, engine=engine, batch_window=0.0)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            srv.query(QueryRequest())
    assert not store.keys()
    jax_srv = LMServer(store, workload=wl, engine="jax", device="cpu", batch_window=0.0)
    with pytest.raises(ValueError, match="unknown engine 'jax'"):
        jax_srv.query(QueryRequest())
    cpu = LMServer(store, workload=wl, engine="torch", device="cpu", batch_window=0.0)
    assert cpu.query(QueryRequest()).best_index >= 0 and cpu.stats["artifact_builds"] == 1
