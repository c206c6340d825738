"""The JAX package's ``tests/test_obs.py``, run on the port's modules
(``repro_torch.obs`` and ``repro_torch.service``).

The metrics registry (thread safety, exporter goldens, disabled mode),
span trees, structured JSON logging, and the instrumented serving stack
end to end over real HTTP: trace-id propagation and sanitising,
per-artifact hit stats, ``/v1/metrics``, healthz, the telemetry artifact
round trip, the ``/v1/slo`` and ``/v1/debug/exemplars`` endpoints, and the
byte identity of untraced answers.

The SLO tracker's and the exemplar rings' own cases (the reference's
``tests/test_slo.py`` and ``tests/test_exemplar.py``) run on the port in
``tests/test_torch_slo.py`` and ``tests/test_torch_exemplar.py``; the
endpoint cases over HTTP, which those files do not hold, run here. Left
out: ``test_validate_trajectory_entry``, a check of the benchmark
harness's trajectory records (``benchmarks/common.py``), which reads
nothing of either package.

Where the port differs by design: its loggers live under the
``repro_torch`` namespace (the reference's under ``repro``), so the
re-rooted logger name and the root logger the test cleans up are
``repro_torch``'s.

The port's own cases close the file: its layer spans
(``repro_torch.obs.trace.layer_span``), which the reference does not have,
recorded only under ``torch.profiler`` in a tiny train step and in
``generate_timed``, on the clock of the profiler's events; and, on the
card (``cuda`` marker), a decode step's device operations inside its span.
"""

import collections
import dataclasses
import io
import json
import logging as pylogging
import sys
import tempfile
import threading
import timeit

import pytest
import torch

from repro_torch.configs import get_arch
from repro_torch.core import MAXWELL, enumerate_hw_space
from repro_torch.core.timemodel import MAXWELL_GPU, TITANX_GPU
from repro_torch.core.workload import paper_workload
from repro_torch.models import Model
from repro_torch.obs import configure_logging, get_logger
from repro_torch.obs.metrics import Registry, get_registry, set_disabled
from repro_torch.obs.trace import RING, clear, current_trace_id, layer_span, recorded, span, trace
from repro_torch.optim import adamw_init
from repro_torch.serve import generate_timed
from repro_torch.service import (
    ArtifactStore,
    CodesignServer,
    Gateway,
    GatewayClient,
    QueryRequest,
    serve_http,
    wire,
)
from repro_torch.train import TrainConfig, make_train_step

STRIDE = 64
STENCILS = ["heat2d", "jacobi2d"]


@pytest.fixture(scope="module")
def fleet():
    """Two artifacts (gtx980 + titanx) behind a live instrumented HTTP
    gateway -- the same shape as the test_gateway fixture, built once."""
    root = tempfile.mkdtemp(prefix="obsstore-")
    store = ArtifactStore(root)
    wl = paper_workload(STENCILS)
    hw = enumerate_hw_space(MAXWELL, max_area=650.0).downsample(STRIDE)
    keys = {}
    for gpu in (MAXWELL_GPU, TITANX_GPU):
        srv = CodesignServer(
            store, workload=wl, gpu=gpu, hw=hw, engine="numpy", batch_window=0.0
        )
        srv.ensure_artifact()
        keys[gpu.name] = srv.key
    gw = Gateway(root, pool_size=2, batch_window=0.0)
    httpd = serve_http(gw)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    url = "http://%s:%d" % httpd.server_address[:2]
    yield store, keys, gw, url
    httpd.shutdown()
    httpd.server_close()


def _req(**kw):
    kw.setdefault("freqs", {"heat2d": 1.0})
    kw.setdefault("use_cache", False)
    return QueryRequest(**kw)


def _counter_value(snapshot, name, **labels):
    """Counter value for one label assignment in a snapshot dict (0.0 when
    the child was never minted)."""
    for s in snapshot.get(name, {}).get("samples", []):
        if s["labels"] == {k: str(v) for k, v in labels.items()}:
            return s["value"]
    return 0.0


# ---------------------------------------------------------------------------
# metrics registry
# ---------------------------------------------------------------------------
def test_counter_and_gauge_basics():
    reg = Registry(disabled=False)
    c = reg.counter("c_total", "help", labels=("route",))
    c.labels(route="/a").inc()
    c.labels(route="/a").inc(2.5)
    c.labels(route="/b").inc()
    assert c.labels(route="/a").value == 3.5
    with pytest.raises(ValueError, match=">= 0"):
        c.labels(route="/a").inc(-1)
    with pytest.raises(ValueError, match="wants labels"):
        c.labels(path="/a")
    g = reg.gauge("g")
    g.set(7)
    g.dec(2)
    assert g.value == 5.0
    # re-registration: idempotent when identical, error on conflict
    assert reg.counter("c_total", "help", labels=("route",)) is c
    with pytest.raises(ValueError, match="already registered"):
        reg.gauge("c_total")


def test_family_get_never_mints_children():
    reg = Registry(disabled=False)
    c = reg.counter("c_total", labels=("k",))
    assert c.get(k="x") is None
    assert reg.snapshot()["c_total"]["samples"] == []
    c.labels(k="x").inc()
    assert c.get(k="x").value == 1.0


def test_histogram_bucket_placement():
    reg = Registry(disabled=False)
    h = reg.histogram("h", buckets=(1.0, 2.0, 4.0))
    for v in (0.5, 1.0, 1.5, 4.0, 99.0):  # 99 -> +Inf overflow
        h.observe(v)
    (s,) = reg.snapshot()["h"]["samples"]
    assert s["count"] == 5 and s["sum"] == pytest.approx(106.0)
    assert [b["count"] for b in s["buckets"]] == [2, 3, 4]  # cumulative
    with pytest.raises(ValueError, match="strictly increasing"):
        reg.histogram("bad", buckets=(1.0, 1.0))


def test_metrics_thread_safety_exact_counts():
    reg = Registry(disabled=False)
    c = reg.counter("c_total", labels=("t",))
    h = reg.histogram("h", buckets=(0.5,))
    n_threads, n_iter = 8, 10_000

    def work(i):
        child = c.labels(t=i % 2)
        for _ in range(n_iter):
            child.inc()
            h.observe(1.0)

    threads = [threading.Thread(target=work, args=(i,)) for i in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    total = c.labels(t=0).value + c.labels(t=1).value
    assert total == n_threads * n_iter  # a lost += would shave counts
    assert h.count == n_threads * n_iter


def test_reset_zeroes_but_preserves_child_identity():
    reg = Registry(disabled=False)
    c = reg.counter("c_total", labels=("k",))
    child = c.labels(k="x")
    child.inc(5)
    reg.reset()
    assert c.labels(k="x") is child  # held references keep working
    assert child.value == 0.0
    child.inc()
    assert child.value == 1.0


def test_exporter_goldens():
    reg = Registry(disabled=False)
    reg.counter("req_total", "requests", labels=("route",)).labels(
        route="/v1/query"
    ).inc(3)
    reg.gauge("pool", "occupancy").set(2)
    h = reg.histogram("lat_seconds", "latency", buckets=(0.1, 1.0))
    h.observe(0.05)
    h.observe(5.0)
    assert reg.render_prometheus() == (
        b"# HELP lat_seconds latency\n"
        b"# TYPE lat_seconds histogram\n"
        b'lat_seconds_bucket{le="0.1"} 1\n'
        b'lat_seconds_bucket{le="1"} 1\n'
        b'lat_seconds_bucket{le="+Inf"} 2\n'
        b"lat_seconds_sum 5.05\n"
        b"lat_seconds_count 2\n"
        b"# HELP pool occupancy\n"
        b"# TYPE pool gauge\n"
        b"pool 2\n"
        b"# HELP req_total requests\n"
        b"# TYPE req_total counter\n"
        b'req_total{route="/v1/query"} 3\n'
    )
    snap = json.loads(reg.render_json())
    assert snap["req_total"]["samples"] == [
        {"labels": {"route": "/v1/query"}, "value": 3.0}
    ]
    # canonical: equal state renders equal bytes
    assert reg.render_json() == reg.render_json()


def test_disabled_mode_drops_everything():
    reg = get_registry()
    c = reg.counter("test_obs_disabled_total")
    before = c.value
    set_disabled(True)
    try:
        c.inc()
        assert c.value == before
    finally:
        set_disabled(None)  # back to the REPRO_OBS_DISABLED env default
    c.inc()
    assert c.value == before + 1


# ---------------------------------------------------------------------------
# spans
# ---------------------------------------------------------------------------
def test_span_nesting_and_tree_shape():
    with trace("root", trace_id="tid1", route="/x") as root:
        assert current_trace_id() == "tid1"
        with span("a", artifact="k1"):
            with span("a1"):
                pass
        with span("b"):
            pass
    t = root.root_tree()
    assert t["trace_id"] == "tid1"
    assert t["name"] == "root" and t["attrs"] == {"route": "/x"}
    assert [c["name"] for c in t["children"]] == ["a", "b"]
    assert [c["name"] for c in t["children"][0]["children"]] == ["a1"]
    assert t["dur_us"] >= t["children"][0]["dur_us"] >= 0
    assert all(c["t_offset_us"] >= 0 for c in t["children"])
    assert json.dumps(t)  # plain JSON-ready dict


def test_span_without_trace_is_noop():
    assert current_trace_id() is None
    with span("orphan") as s:
        assert s is None
    assert current_trace_id() is None


# ---------------------------------------------------------------------------
# structured logging
# ---------------------------------------------------------------------------
def test_structured_logging_json_lines_and_trace_id():
    buf = io.StringIO()
    configure_logging("debug", stream=buf)
    try:
        log = get_logger("gateway")  # re-rooted to repro_torch.gateway (port: by design)
        log.info("request", route="/v1/query", status=200)
        with trace("t", trace_id="tid42"):
            log.debug("inner")
        lines = [json.loads(ln) for ln in buf.getvalue().splitlines()]
        assert lines[0]["event"] == "request"
        assert lines[0]["level"] == "info"
        assert lines[0]["logger"] == "repro_torch.gateway"
        assert lines[0]["route"] == "/v1/query" and lines[0]["status"] == 200
        assert "trace_id" not in lines[0]  # nothing was tracing
        assert lines[1]["trace_id"] == "tid42"
        # reconfiguring replaces the handler instead of stacking a second
        configure_logging("debug", stream=buf)
        root = pylogging.getLogger("repro_torch")
        assert sum(
            getattr(h, "_repro_obs_handler", False) for h in root.handlers
        ) == 1
    finally:
        root = pylogging.getLogger("repro_torch")
        for h in list(root.handlers):
            if getattr(h, "_repro_obs_handler", False):
                root.removeHandler(h)
        root.setLevel(pylogging.NOTSET)


# ---------------------------------------------------------------------------
# instrumented serving stack over real HTTP
# ---------------------------------------------------------------------------
def test_untraced_answers_carry_no_trace_field(fleet):
    _, keys, _, url = fleet
    client = GatewayClient(url)
    body = client.query_bytes(_req(), artifact=keys["gtx980"])
    env = json.loads(body)
    assert "trace" not in env  # byte-identity guarantee: tracing is opt-in
    assert client.query_bytes(_req(), artifact=keys["gtx980"]) == body
    # a minted trace id still rides the response header
    assert len(client.last_trace_id) == 16


def test_traced_query_span_tree_over_http(fleet):
    _, keys, _, url = fleet
    client = GatewayClient(url)
    plain = client.query(_req(), artifact=keys["titanx"])
    resp, tree = client.query_traced(
        _req(), artifact=keys["titanx"], trace_id="test-trace-1"
    )
    # same answer, field for field -- the envelope grew, the payload didn't
    assert dataclasses.replace(resp, cached=False) == dataclasses.replace(
        plain, cached=False
    )
    assert client.last_trace_id == "test-trace-1"
    assert tree["trace_id"] == "test-trace-1"
    assert tree["name"] == "gateway.request"
    names = [c["name"] for c in tree["children"]]
    assert names == ["resolve", "pool", "dispatch"]
    assert tree["dur_us"] >= sum(c["dur_us"] for c in tree["children"])


def test_trace_id_header_is_sanitized(fleet):
    _, keys, _, url = fleet
    client = GatewayClient(url)
    _, tree = client.query_traced(
        _req(), artifact=keys["gtx980"], trace_id="abc !@#$ def\tghi" + "x" * 100
    )
    tid = tree["trace_id"]
    assert tid.startswith("abcdefghi") and len(tid) == 64
    assert client.last_trace_id == tid


def test_trace_envelope_field_must_be_bool():
    with pytest.raises(wire.WireError, match="'trace' must be a boolean"):
        wire.decode_request_traced(b'{"v": 1, "request": {}, "trace": "yes"}')


def test_metrics_endpoint_counts_requests(fleet):
    _, keys, _, url = fleet
    client = GatewayClient(url)
    before = client.metrics()
    n0 = _counter_value(before, "repro_gateway_requests_total", route="/v1/query")
    h0 = _counter_value(
        before, "repro_gateway_artifact_requests_total", artifact=keys["gtx980"]
    )
    n_queries = 4
    for _ in range(n_queries):
        client.query(_req(), artifact=keys["gtx980"])
    after = client.metrics()
    n1 = _counter_value(after, "repro_gateway_requests_total", route="/v1/query")
    h1 = _counter_value(
        after, "repro_gateway_artifact_requests_total", artifact=keys["gtx980"]
    )
    assert n1 - n0 == n_queries
    assert h1 - h0 == n_queries
    # prometheus rendering of the same registry
    text = client.metrics("prometheus")
    assert "# TYPE repro_gateway_requests_total counter" in text
    assert 'route="/v1/query"' in text
    # unknown format is a structured 400, not a traceback
    with pytest.raises(wire.RemoteError):
        client.metrics("xml")


def test_query_lru_metrics_over_http(fleet):
    _, keys, _, url = fleet
    client = GatewayClient(url)
    req = QueryRequest(freqs={"jacobi2d": 1.0}, use_cache=True)
    client.query(req, artifact=keys["gtx980"])  # prime the LRU
    before = client.metrics()
    client.query(req, artifact=keys["gtx980"])
    after = client.metrics()
    hits = lambda snap: _counter_value(snap, "repro_query_lru_hits_total")  # noqa: E731
    assert hits(after) - hits(before) == 1


def test_artifact_rows_carry_hit_stats(fleet):
    _, keys, gw, url = fleet
    client = GatewayClient(url)
    rows = {r["key"]: r for r in client.artifacts()}
    before = rows[keys["titanx"]].get("hits", 0)
    # the registry counter is process-global (same content key in another
    # module's fleet shares the label); the ledger row is per store root.
    # Baseline each source independently and assert both increment.
    stats_before = gw.artifact_stats()[keys["titanx"]]["hits"]
    client.query(_req(), artifact=keys["titanx"])
    rows = {r["key"]: r for r in client.artifacts()}
    row = rows[keys["titanx"]]
    assert row["hits"] == before + 1
    assert isinstance(row["last_access"], float)
    stats = gw.artifact_stats()
    assert stats[keys["titanx"]]["hits"] == stats_before + 1
    assert stats[keys["titanx"]]["query_seconds_count"] >= 1


def test_healthz_reports_uptime_and_pool(fleet):
    _, _, _, url = fleet
    h = GatewayClient(url).health()
    assert h["ok"] is True
    assert h["uptime_s"] >= 0.0
    assert h["telemetry_interval"] == 0.0
    assert h["artifacts"] == 2


def test_telemetry_artifact_round_trip(fleet):
    store, keys, gw, url = fleet
    client = GatewayClient(url)
    client.query(_req(), artifact=keys["gtx980"])
    key = gw.persist_telemetry()
    art = store.get(key)
    assert art.manifest["kind"] == "telemetry"
    assert art.manifest["routing"]["workload"] == "gateway-telemetry"
    payload = art.payload
    assert payload["gateway"]["requests"] >= 1
    assert payload["artifacts"][keys["gtx980"]]["hits"] >= 1
    assert payload["uptime_s"] >= 0.0 and payload["collected_at"] > 0
    # telemetry artifacts are manifest-only metadata: a rescan indexes
    # them (they appear in /v1/artifacts) but the default ("sweep",) kind
    # filter keeps them out of query routing -- a selector query is still
    # unambiguous with the snapshot sitting in the same store
    n = client.refresh()
    assert n == 3
    resp = client.query(_req(), route={"gpu": "titanx"})
    assert resp.artifact_key == keys["titanx"]


# ---------------------------------------------------------------------------
# SLO + exemplar endpoints (repro_torch.obs.slo / .exemplar over HTTP)
# ---------------------------------------------------------------------------
def test_slo_endpoint_reports_query_traffic(fleet):
    _, keys, _, url = fleet
    client = GatewayClient(url)
    for _ in range(3):
        client.query(_req(), artifact=keys["gtx980"])
    rep = client.slo()
    assert rep["status"] in ("ok", "burning", "violated")
    assert [w["name"] for w in rep["windows"]] == ["5m", "1h"]
    q = rep["routes"]["/v1/query"]
    assert q["objective"]["latency_threshold_s"] == 0.025
    assert q["windows"]["5m"]["count"] >= 3
    for w in q["windows"].values():
        assert w["availability_burn"] >= 0.0
        assert w["latency_burn"] >= 0.0
    # prometheus rendering of the same report
    text = client.slo("prometheus")
    assert "repro_slo_burn_rate{" in text
    with pytest.raises(wire.RemoteError):
        client.slo("xml")
    # and healthz folds the one-word status in
    h = client.health()
    assert h["slo"] in ("ok", "burning", "violated")


def test_exemplars_capture_without_perturbing_bytes(fleet):
    _, keys, _, url = fleet
    client = GatewayClient(url)
    # untraced answers stay byte-identical even though capture forces an
    # internal trace for the exemplar ring
    body = client.query_bytes(_req(), artifact=keys["gtx980"])
    assert b'"trace"' not in body
    assert client.query_bytes(_req(), artifact=keys["gtx980"]) == body
    snap = client.exemplars(route="/v1/query")
    ring = snap["routes"]["/v1/query"]
    assert len(ring["slow"]) >= 1
    e = ring["slow"][0]
    assert e["status"] == 200 and e["dur_us"] > 0
    # the forced internal trace was retained with real span children
    assert e["trace"]["name"] == "gateway.request"
    assert e["trace"]["trace_id"] == e["trace_id"]
    assert any("server" in c["name"] or "batch" in c["name"] or "store" in c["name"]
               for c in e["trace"].get("children", [])) or e["trace"]["dur_us"] > 0


def test_exemplars_retain_errors_with_code(fleet):
    _, keys, _, url = fleet
    client = GatewayClient(url)
    with pytest.raises(wire.RemoteError):
        client.query(_req(), artifact="0" * 20)
    snap = client.exemplars(route="/v1/query")
    errors = snap["routes"]["/v1/query"]["errors"]
    assert any(e["code"] == "unknown_artifact" and e["status"] == 404
               for e in errors)


def test_exemplars_unknown_route_is_structured_404(fleet):
    _, _, _, url = fleet
    client = GatewayClient(url)
    with pytest.raises(wire.RemoteError) as exc:
        client.exemplars(route="/v1/nope")
    assert exc.value.code == "unknown_route"
    assert exc.value.http_status == 404


def test_exemplar_trace_id_cross_references_header(fleet):
    _, keys, _, url = fleet
    client = GatewayClient(url)
    client.query(_req(), artifact=keys["titanx"])
    tid = client.last_trace_id
    assert tid
    snap = client.exemplars()
    everything = (snap["routes"].get("/v1/query", {}).get("slow", [])
                  + list(snap["routes"].get("/v1/query", {}).get("errors", [])))
    assert any(e["trace_id"] == tid for e in everything) or len(everything) > 0


# ---------------------------------------------------------------------------
# The port's layer spans
# ---------------------------------------------------------------------------
#: the module itself (the package's ``trace`` name is the function)
_LAYERS = sys.modules["repro_torch.obs.trace"]
_TINY = get_arch("internlm2-1.8b").reduced()


def _profiled(fn, on):
    """``fn()`` under ``torch.profiler`` (``on``) or not: (its result, the
    layer spans it recorded, the profiler's CPU events)."""
    clear()
    if not on:
        return fn(), recorded(), []
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, recorded(), list(prof.profiler.kineto_results.events())


def _train_step(remat, loss_chunks=0):
    """One tiny train step of two microbatches: (loss, the parameters after)."""
    tcfg = TrainConfig(microbatches=2, remat=remat, loss_chunks=loss_chunks)
    model = Model(_TINY, device="cpu", generator=torch.Generator().manual_seed(0))
    state = {"params": model, "opt": adamw_init(model, tcfg.opt)}
    toks = torch.randint(0, _TINY.vocab, (4, 16), generator=torch.Generator().manual_seed(1))
    _, m = make_train_step(_TINY, tcfg, device="cpu")(state, {"tokens": toks,
                                                            "labels": toks.roll(-1, 1)})
    return float(m["loss"]), [p.detach().clone() for p in model.parameters()]


def _serve(steps=4):
    model = Model(_TINY, device="cpu", generator=torch.Generator().manual_seed(0))
    toks = torch.randint(0, _TINY.vocab, (2, 8), generator=torch.Generator().manual_seed(2))
    return generate_timed(model, _TINY, {"tokens": toks}, steps, device="cpu")["tokens"]


def _named(spans, i):
    p = spans[i]["parent"]
    return None if p is None else spans[p]["name"]


def test_layer_spans_record_nothing_without_the_profiler():
    _profiled(lambda: _train_step("full"), on=False)
    assert recorded() == []
    _profiled(_serve, on=False)
    assert recorded() == []


@pytest.mark.parametrize("remat", ["full", "dots", "save_block_io", "none"])
def test_train_step_layer_spans_nest_and_change_no_number(remat):
    plain, _, _ = _profiled(lambda: _train_step(remat), on=False)
    (loss, params), spans, _ = _profiled(lambda: _train_step(remat), on=True)
    assert loss == plain[0]
    assert all(torch.equal(a, b) for a, b in zip(params, plain[1]))
    names = collections.Counter((s["name"], _named(spans, i)) for i, s in enumerate(spans))
    n_blocks = 2 * _TINY.n_layers  # two microbatches
    recompute = {"full": n_blocks, "dots": n_blocks, "save_block_io": 2 * n_blocks, "none": 0}
    assert names == collections.Counter({
        ("train.step", None): 1,
        ("train.forward", "train.step"): 2,
        ("model.attention", "train.forward"): n_blocks,
        ("model.attention.core", "model.attention"): n_blocks * (1 if remat == "none" else 2),
        **({("train.recompute", "train.step"): recompute[remat],
            ("model.attention", "train.recompute"): n_blocks} if remat != "none" else {}),
    })
    # a recompute runs in the backward pass: after its microbatch's forward
    # pass has ended and before the next one starts
    fwd = [(s["start_ns"], s["end_ns"]) for s in spans if s["name"] == "train.forward"]
    for s in spans:
        if s["name"] == "train.recompute":
            assert not any(a <= s["start_ns"] <= z for a, z in fwd)
            assert any(z < s["start_ns"] for _, z in fwd)
    for s in spans:
        assert s["start_ns"] <= s["end_ns"] and s["device_ms"] is None  # no card here
        if s["parent"] is not None:
            p = spans[s["parent"]]
            assert p["start_ns"] <= s["start_ns"] and s["end_ns"] <= p["end_ns"]


@pytest.mark.parametrize("remat", ["full", "none"])
def test_the_loss_chunks_recompute_is_a_recompute_span(remat):
    """``chunked_ce`` checkpoints each loss chunk: its recompute in the
    backward pass is a ``train.recompute`` span too, with or without remat
    of the blocks, and holds no attention."""
    plain, _, _ = _profiled(lambda: _train_step(remat, loss_chunks=4), on=False)
    (loss, params), spans, _ = _profiled(lambda: _train_step(remat, loss_chunks=4), on=True)
    assert loss == plain[0]
    assert all(torch.equal(a, b) for a, b in zip(params, plain[1]))
    n_blocks = 2 * _TINY.n_layers  # two microbatches
    recompute = [i for i, s in enumerate(spans) if s["name"] == "train.recompute"]
    assert len(recompute) == 2 * 4 + (n_blocks if remat == "full" else 0)
    assert all(_named(spans, i) == "train.step" for i in recompute)
    held = collections.Counter(spans[s["parent"]]["name"] for s in spans
                               if s["name"] == "model.attention")
    assert held == collections.Counter({"train.forward": n_blocks,
                                        **({"train.recompute": n_blocks} if remat == "full" else {})})


def test_generate_timed_records_one_decode_span_per_step():
    plain, _, _ = _profiled(_serve, on=False)
    tokens, spans, _ = _profiled(_serve, on=True)
    assert torch.equal(tokens, plain)
    names = collections.Counter((s["name"], _named(spans, i)) for i, s in enumerate(spans))
    # the prefill's attention has no parent span; each of 3 decode steps holds its layers';
    # every attention holds its core
    assert names == collections.Counter({("serve.decode", None): 3,
                                         ("model.attention", None): _TINY.n_layers,
                                         ("model.attention", "serve.decode"): 3 * _TINY.n_layers,
                                         ("model.attention.core", "model.attention"):
                                             4 * _TINY.n_layers})


def test_an_op_inside_a_span_lies_inside_it_on_the_profilers_clock():
    x = torch.randn(128, 128)

    def work():
        with layer_span("test.outer", attrs={"k": 1}):
            with layer_span("test.inner"):
                return x @ x

    _, spans, events = _profiled(work, on=True)
    inner = next(s for s in spans if s["name"] == "test.inner")
    assert spans[inner["parent"]]["name"] == "test.outer"
    assert spans[inner["parent"]]["attrs"] == {"k": 1}
    mm = [e for e in events if e.name() == "aten::mm"]
    assert len(mm) == 1
    a, z = mm[0].start_ns(), mm[0].start_ns() + mm[0].duration_ns()
    assert inner["start_ns"] <= a <= z <= inner["end_ns"]
    # the span's own profiler range, on the same clock
    rng = [e for e in events if e.name() == "repro/test.inner"]
    assert len(rng) == 1 and inner["start_ns"] <= rng[0].start_ns() <= inner["end_ns"]


def test_the_span_ring_drops_the_oldest(monkeypatch):
    assert RING >= 10**6
    monkeypatch.setattr(_LAYERS, "_RECORDS", collections.deque(maxlen=3))

    def work():
        for i in range(5):
            with layer_span(f"test.{i}"):
                pass

    _, spans, _ = _profiled(work, on=True)
    assert [s["name"] for s in spans] == ["test.2", "test.3", "test.4"]


def test_spans_of_concurrent_threads_keep_their_own_parents():
    n_threads, n_spans = 16, 200

    def worker(k):
        for i in range(n_spans):
            with layer_span("test.outer", attrs={"k": k}):
                with layer_span("test.inner", attrs={"k": k}):
                    pass

    def work():
        old = sys.getswitchinterval()
        sys.setswitchinterval(1e-6)
        try:
            threads = [threading.Thread(target=worker, args=(k,)) for k in range(n_threads)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
            assert not any(t.is_alive() for t in threads)
        finally:
            sys.setswitchinterval(old)

    _, spans, _ = _profiled(work, on=True)
    assert len(spans) == 2 * n_threads * n_spans and not _LAYERS._OPEN
    for s in spans:
        if s["name"] == "test.inner":  # its own thread's outer span, never another's
            p = spans[s["parent"]]
            assert p["name"] == "test.outer" and p["tid"] == s["tid"] and p["attrs"] == s["attrs"]
        else:  # outside a backward pass, another thread's open span is no parent
            assert s["parent"] is None


def test_a_span_site_costs_under_a_microsecond_off():
    assert not torch.autograd.profiler._is_profiler_enabled
    clear()
    per = min(timeit.repeat("with layer_span('serve.decode'):\n    pass",
                            globals={"layer_span": layer_span}, number=10**5, repeat=5)) / 10**5
    print(f"a span site with nothing recording: {per * 1e9:.0f} ns")
    assert per < 1e-6
    assert recorded() == []


@pytest.mark.cuda
def test_decode_step_device_ops_lie_inside_their_spans():
    """On the card at a tiny size: every device operation of a decode step
    lies inside its ``serve.decode`` span (within 50 us), and a device
    span's event pair reads the extent of the traced kernels inside it
    within 5%."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from torch.autograd import DeviceType

    card = torch.device("cuda")
    model = Model(_TINY, device=card, generator=torch.Generator(device=card).manual_seed(0))
    toks = torch.randint(0, _TINY.vocab, (2, 8), device=card)
    generate_timed(model, _TINY, {"tokens": toks}, 3, device=card)  # warm
    # products long enough that the launch before the first one, which the
    # event pair also times, is well under 5% of the span
    a = torch.randn(8192, 8192, device=card, dtype=torch.bfloat16)
    a @ a  # warm
    torch.cuda.synchronize()

    def work():
        generate_timed(model, _TINY, {"tokens": toks}, 6, device=card)
        with layer_span("test.products", device=True):
            for _ in range(20):
                a @ a
            torch.cuda.synchronize()

    clear()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        work()
    spans = recorded()
    ops = [(e.start_ns(), e.start_ns() + e.duration_ns())
           for e in prof.profiler.kineto_results.events()
           if e.device_type() == DeviceType.CUDA and not e.is_user_annotation()]
    decode = [(s["start_ns"], s["end_ns"]) for s in spans if s["name"] == "serve.decode"]
    assert len(decode) == 5
    # serving runs without grad: its attention spans record no event pair
    assert all(s["device_ms"] is None for s in spans if s["name"] == "model.attention")
    slack = 50_000
    for a0, z0 in decode:
        assert any(a0 - slack <= a1 and z1 <= z0 + slack for a1, z1 in ops)
    # from the first step's start to the last one's end, the card runs only
    # the steps' operations: each lies inside one of the spans
    steps = [(a1, z1) for a1, z1 in ops if decode[0][0] - slack <= z1 and a1 <= decode[-1][1]]
    assert all(any(a0 - slack <= a1 and z1 <= z0 + slack for a0, z0 in decode)
               for a1, z1 in steps)
    # the pair times the stream from the span's start to its end: the first
    # of its kernels' starts to the last one's end
    prod = next(s for s in spans if s["name"] == "test.products")
    mine = [(a1, z1) for a1, z1 in ops if prod["start_ns"] <= a1 and z1 <= prod["end_ns"]]
    extent = max(z1 for _, z1 in mine) - min(a1 for a1, _ in mine)
    print(f"products: pair {prod['device_ms']:.4f} ms, kernels' extent {extent * 1e-6:.4f} ms, "
          f"their sum {sum(z1 - a1 for a1, z1 in mine) * 1e-6:.4f} ms")
    assert prod["device_ms"] == pytest.approx(extent * 1e-6, rel=0.05)
