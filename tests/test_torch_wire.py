"""The JAX package's ``tests/test_golden.py``, run on the port's modules.

Golden wire corpus: every endpoint's canonical bytes, locked on disk.

``tests/golden/`` holds the exact request/response bytes for each
endpoint envelope -- ``/v1/query``, ``/v1/query_many``, ``/v1/route``,
the structured error shape, and the ``/v1/metrics`` JSON rendering. The
builders below reconstruct each envelope from fixed values with the
port's codec; the test asserts it produces the committed bytes, which the
JAX package's codec wrote, so a diff here means the two packages no
longer speak one wire. The corpus is read only here: it is regenerated
by the JAX package's ``tests/test_golden.py`` alone. Decoders are
additionally checked as exact inverses over the corpus (decode . encode
== identity, every envelope), and each corpus value is encoded by both
packages to the same bytes.
"""

import pathlib

import numpy as np
import pytest

from repro_torch.obs.metrics import Registry
from repro_torch.service import wire
from repro_torch.service.portfolio import RouteRequest, RouteResponse
from repro_torch.service.query import QueryRequest, QueryResponse

GOLDEN_DIR = pathlib.Path(__file__).parent / "golden"


# ---------------------------------------------------------------------------
# fixed envelope builders (pure values -> bytes; no sweeps, no clocks)
# ---------------------------------------------------------------------------


def _query_request() -> bytes:
    return wire.encode_request(
        QueryRequest(
            freqs={"heat2d": 2.0, "jacobi2d": 1.0},
            max_area=450.0,
            min_area=60.0,
            top_k=3,
            pareto=True,
            fix={"n_sm": 16.0},
        ),
        artifact="0123456789abcdef0123",
        route={"gpu": "titanx", "workload": "paper-8-2048"},
        deadline_ms=250.0,
    )


def _query_many_request() -> bytes:
    return wire.encode_request_many(
        [
            (QueryRequest(freqs={"heat2d": 1.0}), None, {"gpu": "gtx980"}),
            (QueryRequest(max_area=650.0, top_k=2), "0123456789abcdef0123", None),
        ]
    )


def _route_request() -> bytes:
    return wire.encode_route_request(
        RouteRequest(cell="llama3-8b:decode"),
        artifact="fedcba98765432100123",
        route={"gpu": "tpu_v5e"},
        deadline_ms=100.0,
    )


def _query_response() -> bytes:
    # exercises the $f non-finite tagging (infeasible -> -inf gflops)
    # alongside a normal answer's full field surface
    return wire.encode_response(
        QueryResponse(
            artifact_key="0123456789abcdef0123",
            best_index=7,
            best_gflops=1063.25,
            best_weighted_time=7.0625,
            best_point={"area": 61.5, "m_sm": 432.0, "n_sm": 2.0, "n_v": 320.0},
            top_k=[
                {"area": 61.5, "gflops": 1063.25, "index": 7.0},
                {"area": 80.0, "gflops": 990.5, "index": 12.0},
            ],
            pareto_indices=np.array([2, 7, 12], np.int64),
            baseline_best_index=3,
            baseline_best_gflops=-np.inf,
            cached=True,
            batch_size=4,
        )
    )


def _query_many_response() -> bytes:
    ok = QueryResponse(
        artifact_key="0123456789abcdef0123",
        best_index=-1,
        best_gflops=-np.inf,
        best_weighted_time=np.inf,
        best_point={},
        top_k=[],
    )
    return wire.encode_response_many(
        [ok, ("unknown_artifact", "no artifact matches selector {'gpu': 'rtx'}")]
    )


def _route_response() -> bytes:
    return wire.encode_route_response(
        RouteResponse(
            portfolio_key="fedcba98765432100123",
            sweep_key="0123456789abcdef0123",
            cell="heat2d",
            cell_indices=(0, 6, 12),
            hw_index=42,
            member_slot=1,
            point={"area": 61.5, "m_sm": 432.0, "n_sm": 2.0, "n_v": 320.0},
            time_s=7.0625,
            gflops=1063.25,
            degraded=True,
            fallback_from=(17,),
        )
    )


def _error() -> bytes:
    return wire.encode_error(
        "portfolio_exhausted", "every member design failed for cell 'heat2d'"
    )


def _metrics_json() -> bytes:
    # a private registry with one of each family kind and fixed
    # observations: the canonical /v1/metrics?format=json rendering
    reg = Registry(disabled=False)
    c = reg.counter("repro_requests_total", "requests", labels=("endpoint",))
    c.labels(endpoint="/v1/route").inc(3)
    c.labels(endpoint="/v1/query").inc(5)
    g = reg.gauge("repro_pool_servers", "resident servers")
    g.set(2)
    h = reg.histogram("repro_route_seconds", "route latency",
                      buckets=(0.001, 0.01, 0.1))
    for v in (0.0005, 0.002, 0.05):
        h.observe(v)
    return reg.render_json()


def _slo_json() -> bytes:
    # a fixed-clock SLOTracker fed a fixed request mix: the canonical
    # /v1/slo?format=json rendering (burn rates, latency estimates,
    # per-route status), no wall clock anywhere
    from repro_torch.obs.slo import SLOTracker

    t = [0.0]
    tracker = SLOTracker(clock=lambda: t[0])
    for i in range(20):
        t[0] = float(i)
        tracker.record("/v1/query", 0.004 + 0.001 * (i % 3), ok=True)
        tracker.record("/v1/route", 0.002, ok=(i % 10 != 0))
    t[0] = 30.0
    tracker.record("/v1/query", 0.250, ok=False)  # one slow 5xx outlier
    return wire.encode_slo_response(tracker.report(now=30.0))


CORPUS = {
    "query_request.json": _query_request,
    "query_many_request.json": _query_many_request,
    "route_request.json": _route_request,
    "query_response.json": _query_response,
    "query_many_response.json": _query_many_response,
    "route_response.json": _route_response,
    "error.json": _error,
    "metrics.json": _metrics_json,
    "slo.json": _slo_json,
}


@pytest.mark.parametrize("name", sorted(CORPUS))
def test_golden_bytes_stable(name):
    got = CORPUS[name]()
    want = (GOLDEN_DIR / name).read_bytes()
    assert got == want, f"{name}: the port's wire bytes differ from the corpus"


def test_golden_decoders_invert_corpus():
    """decode(encode(x)) == x over the committed bytes (not just today's
    encoder output), so decoder drift is caught even when encoders hold."""
    req, artifact, route, deadline = wire.decode_route_request_full(
        (GOLDEN_DIR / "route_request.json").read_bytes()
    )
    assert req == RouteRequest(cell="llama3-8b:decode")
    assert artifact == "fedcba98765432100123"
    assert route == {"gpu": "tpu_v5e"} and deadline == 100.0

    resp = wire.decode_route_response(
        (GOLDEN_DIR / "route_response.json").read_bytes()
    )
    assert resp.degraded and resp.fallback_from == (17,)
    assert wire.encode_route_response(resp) == (
        GOLDEN_DIR / "route_response.json"
    ).read_bytes()

    q = wire.decode_response((GOLDEN_DIR / "query_response.json").read_bytes())
    assert q.baseline_best_gflops == -np.inf  # $f tag round-trips
    assert wire.encode_response(q) == (
        GOLDEN_DIR / "query_response.json"
    ).read_bytes()

    many = wire.decode_response_many(
        (GOLDEN_DIR / "query_many_response.json").read_bytes()
    )
    assert isinstance(many[0], QueryResponse)
    assert isinstance(many[1], wire.RemoteError)
    assert many[1].code == "unknown_artifact" and many[1].http_status == 404

    qreq, art, rt = wire.decode_request(
        (GOLDEN_DIR / "query_request.json").read_bytes()
    )
    assert art == "0123456789abcdef0123" and rt["gpu"] == "titanx"
    assert qreq.top_k == 3 and qreq.fix == {"n_sm": 16.0}

    with pytest.raises(wire.RemoteError) as exc:
        wire.decode_route_response((GOLDEN_DIR / "error.json").read_bytes(),
                                   http_status=503)
    assert exc.value.code == "portfolio_exhausted"


#: every request/response envelope of the corpus: decode, then encode again
ROUND_TRIPS = {
    "query_request.json": lambda b: wire.encode_request(
        *_unpack_request(wire.decode_request_full(b))),
    "query_many_request.json": lambda b: wire.encode_request_many(
        *wire.decode_request_many_full(b)),
    "route_request.json": lambda b: _encode_route_request(wire.decode_route_request_full(b)),
    "query_response.json": lambda b: wire.encode_response(wire.decode_response(b)),
    "query_many_response.json": lambda b: wire.encode_response_many(
        [r if isinstance(r, QueryResponse) else (r.code, r.message)
         for r in wire.decode_response_many(b)]),
    "route_response.json": lambda b: wire.encode_route_response(wire.decode_route_response(b)),
    "slo.json": lambda b: wire.encode_slo_response(wire.decode_slo_response(b)),
}


def _unpack_request(full):
    request, artifact, route, traced, deadline_ms = full
    return request, artifact, route, traced, deadline_ms


def _encode_route_request(full):
    request, artifact, route, deadline_ms = full
    return wire.encode_route_request(request, artifact=artifact, route=route,
                                     deadline_ms=deadline_ms)


@pytest.mark.parametrize("name", sorted(ROUND_TRIPS))
def test_decode_encode_is_the_identity_on_the_corpus(name):
    data = (GOLDEN_DIR / name).read_bytes()
    assert ROUND_TRIPS[name](data) == data
    # and once more from the port's own output
    assert ROUND_TRIPS[name](ROUND_TRIPS[name](data)) == data


def test_error_envelope_decodes_to_its_code_and_status():
    data = (GOLDEN_DIR / "error.json").read_bytes()
    with pytest.raises(wire.RemoteError) as exc:
        wire.decode_response(data, http_status=503)
    assert wire.encode_error(exc.value.code, exc.value.message) == data


@pytest.mark.parametrize("name", sorted(ROUND_TRIPS))
def test_both_packages_encode_the_decoded_corpus_alike(name):
    """The reference's codec re-encodes what the port's decoded (and the
    port what the reference's decoded) to the corpus bytes."""
    import dataclasses

    from repro.service import wire as rwire

    data = (GOLDEN_DIR / name).read_bytes()
    if name == "query_response.json":
        mine = wire.decode_response(data)
        theirs = rwire.decode_response(data)
        assert dataclasses.asdict(mine).keys() == dataclasses.asdict(theirs).keys()
        assert rwire.encode_response(mine) == wire.encode_response(theirs) == data
    elif name == "route_response.json":
        assert rwire.encode_route_response(wire.decode_route_response(data)) == data
        assert wire.encode_route_response(rwire.decode_route_response(data)) == data
    elif name == "query_request.json":
        theirs = rwire.decode_request_full(data)
        assert wire.encode_request(*theirs) == data
        assert rwire.encode_request(*wire.decode_request_full(data)) == data
    elif name == "query_many_request.json":
        assert wire.encode_request_many(*rwire.decode_request_many_full(data)) == data
        assert rwire.encode_request_many(*wire.decode_request_many_full(data)) == data
    elif name == "route_request.json":
        req, artifact, route, deadline = rwire.decode_route_request_full(data)
        assert wire.encode_route_request(req, artifact=artifact, route=route,
                                         deadline_ms=deadline) == data
    elif name == "query_many_response.json":
        rs = rwire.decode_response_many(data)
        assert wire.encode_response_many(
            [(r.code, r.message) if isinstance(r, rwire.RemoteError) else
             QueryResponse(**{f.name: getattr(r, f.name) for f in dataclasses.fields(r)})
             for r in rs]) == data
    else:
        assert wire.encode_slo_response(rwire.decode_slo_response(data)) == data
