"""The JAX package's ``tests/test_wire_errors.py``, run on the port's modules.

The error-code contract: every GatewayError subclass maps to exactly
one documented wire code + HTTP status (the ERROR_HTTP_STATUS registry),
and the gateway actually answers those statuses over live HTTP -- one
trigger per code, including the resilience family (429/503/504)."""

import json
import math
import tempfile
import threading
import urllib.error
import urllib.request

import pytest

from repro_torch.core import MAXWELL, enumerate_hw_space
from repro_torch.core.timemodel import MAXWELL_GPU, TITANX_GPU
from repro_torch.core.workload import paper_workload
from repro_torch.service import (
    ArtifactStore,
    CodesignServer,
    Gateway,
    GatewayError,
    QueryRequest,
    serve_http,
    wire,
)
from repro_torch.service.errors import ERROR_HTTP_STATUS
from repro_torch.service.resilience import GatewayResilience

STRIDE = 64
STENCILS = ["heat2d", "jacobi2d"]


def _all_gateway_error_classes():
    """Every concrete GatewayError subclass reachable from the package
    (importing repro.service pulls in gateway, store and resilience, so
    the recursive walk sees them all)."""
    out, stack = [], [GatewayError]
    while stack:
        cls = stack.pop()
        out.append(cls)
        stack.extend(cls.__subclasses__())
    return out


# ---------------------------------------------------------------------------
# the registry itself
# ---------------------------------------------------------------------------
def test_registry_statuses_are_sane():
    for code, status in ERROR_HTTP_STATUS.items():
        assert 400 <= status < 600, (code, status)
    # the codes the resilience layer added, pinned (docs/serving.md table)
    assert ERROR_HTTP_STATUS["rate_limited"] == 429
    assert ERROR_HTTP_STATUS["shed"] == 503
    assert ERROR_HTTP_STATUS["circuit_open"] == 503
    assert ERROR_HTTP_STATUS["build_lock_timeout"] == 503
    assert ERROR_HTTP_STATUS["deadline_exceeded"] == 504
    # wire re-exports THE registry (one table, never two)
    assert wire.ERROR_HTTP_STATUS is ERROR_HTTP_STATUS


@pytest.mark.parametrize(
    "cls", _all_gateway_error_classes(), ids=lambda c: c.__name__
)
def test_every_gateway_error_is_documented(cls):
    """Each subclass pins a code present in the registry and an
    http_status that agrees with it -- the property that keeps the server,
    the client decoder and docs/serving.md telling one story."""
    assert cls.code in ERROR_HTTP_STATUS, (
        f"{cls.__name__}.code = {cls.code!r} missing from ERROR_HTTP_STATUS"
    )
    assert cls.http_status == ERROR_HTTP_STATUS[cls.code]


@pytest.mark.parametrize("code", sorted(ERROR_HTTP_STATUS))
def test_every_code_round_trips_through_the_codec(code):
    status = ERROR_HTTP_STATUS[code]
    body = wire.encode_error(code, "why it failed")
    with pytest.raises(wire.RemoteError) as ei:
        wire.decode_response(body, http_status=status)
    assert ei.value.code == code
    assert ei.value.http_status == status
    assert "why it failed" in ei.value.message


# ---------------------------------------------------------------------------
# live-HTTP trigger table
# ---------------------------------------------------------------------------
def small_hw():
    return enumerate_hw_space(MAXWELL, max_area=650.0).downsample(STRIDE)


@pytest.fixture(scope="module")
def fleet():
    """Two sweep artifacts + one non-sweep manifest behind a live gateway
    whose resilience bundle the tests can reach (and swap)."""
    root = tempfile.mkdtemp(prefix="errfleet-")
    store = ArtifactStore(root)
    wl = paper_workload(STENCILS)
    hw = small_hw()
    keys = {}
    for gpu in (MAXWELL_GPU, TITANX_GPU):
        srv = CodesignServer(
            store, workload=wl, gpu=gpu, hw=hw, engine="numpy",
            batch_window=0.0,
        )
        srv.ensure_artifact()
        keys[gpu.name] = srv.key
    telemetry_key = store.put_json(
        "telemetry", {"collected_at": 0.0}, routing={"workload": "t"}
    ).key
    gw = Gateway(root, pool_size=2, batch_window=0.0,
                 resilience=GatewayResilience())
    httpd = serve_http(gw)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    url = "http://%s:%d" % httpd.server_address[:2]
    yield gw, url, keys, telemetry_key
    httpd.shutdown()
    httpd.server_close()


def _post(url, body, path="/v1/query", headers=None):
    req = urllib.request.Request(
        url + path, data=body, method="POST",
        headers={"Content-Type": "application/json", **(headers or {})},
    )
    try:
        with urllib.request.urlopen(req) as r:
            return r.status, dict(r.headers), r.read()
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), e.read()


def _assert_error(status, body, code):
    assert status == ERROR_HTTP_STATUS[code], (status, body)
    payload = json.loads(body)
    assert payload["ok"] is False
    assert payload["error"]["code"] == code
    assert payload["error"]["message"]


def _q(**kw):
    return wire.encode_request(QueryRequest(use_cache=False), **kw)


def test_http_bad_request(fleet):
    _, url, keys, _ = fleet
    status, _, body = _post(
        url, b'{"v": 1, "request": {"max_area": "plenty"}}'
    )
    _assert_error(status, body, "bad_request")


def test_http_unsupported_version(fleet):
    _, url, _, _ = fleet
    status, _, body = _post(url, b'{"v": 99, "request": {}}')
    _assert_error(status, body, "unsupported_version")


def test_http_unknown_artifact(fleet):
    _, url, _, _ = fleet
    status, _, body = _post(url, _q(artifact="0" * 64))
    _assert_error(status, body, "unknown_artifact")


def test_http_ambiguous_route(fleet):
    _, url, _, _ = fleet
    status, _, body = _post(url, _q())  # two artifacts, no selector
    _assert_error(status, body, "ambiguous_route")


def test_http_wrong_artifact_kind(fleet):
    _, url, _, telemetry_key = fleet
    status, _, body = _post(url, _q(artifact=telemetry_key))
    _assert_error(status, body, "wrong_artifact_kind")


def test_http_not_found(fleet):
    _, url, _, _ = fleet
    status, _, body = _post(url, b"{}", path="/v1/nope")
    _assert_error(status, body, "not_found")


def test_http_deadline_exceeded_envelope_and_header(fleet):
    _, url, keys, _ = fleet
    key = keys[MAXWELL_GPU.name]
    # a microscopic envelope budget is spent before the resolve stage
    status, _, body = _post(
        url, _q(artifact=key, deadline_ms=1e-6)
    )
    _assert_error(status, body, "deadline_exceeded")
    # header spelling, same contract
    status, _, body = _post(
        url, _q(artifact=key),
        headers={"X-Repro-Deadline-Ms": "0.000001"},
    )
    _assert_error(status, body, "deadline_exceeded")
    # a generous budget answers normally (and the envelope field is
    # accepted, not rejected as an unknown key)
    status, _, body = _post(url, _q(artifact=key, deadline_ms=60000))
    assert status == 200 and json.loads(body)["ok"] is True


def test_http_deadline_header_garbage_is_bad_request(fleet):
    _, url, keys, _ = fleet
    status, _, body = _post(
        url, _q(artifact=keys[MAXWELL_GPU.name]),
        headers={"X-Repro-Deadline-Ms": "soon"},
    )
    _assert_error(status, body, "bad_request")


def test_http_rate_limited_with_retry_after(fleet):
    gw, url, keys, _ = fleet
    saved = gw.resilience
    gw.resilience = GatewayResilience(global_rate=0.001, global_burst=1.0)
    try:
        body = _q(artifact=keys[MAXWELL_GPU.name])
        status, _, _ = _post(url, body)
        assert status == 200  # the one burst token
        status, headers, raw = _post(url, body)
        _assert_error(status, raw, "rate_limited")
        assert int(headers["Retry-After"]) >= 1
    finally:
        gw.resilience = saved


def test_http_shed_with_retry_after(fleet):
    gw, url, keys, _ = fleet
    saved = gw.resilience
    gw.resilience = GatewayResilience(max_inflight=1)
    try:
        # occupy the single in-flight slot from in-process, then knock
        holder = gw.resilience.admission.admit("holder")
        holder.__enter__()
        try:
            status, headers, raw = _post(
                url, _q(artifact=keys[MAXWELL_GPU.name])
            )
            _assert_error(status, raw, "shed")
            assert "Retry-After" in headers
        finally:
            holder.__exit__(None, None, None)
        status, _, _ = _post(url, _q(artifact=keys[MAXWELL_GPU.name]))
        assert status == 200
    finally:
        gw.resilience = saved


def test_http_circuit_open_with_retry_after(fleet):
    gw, url, keys, _ = fleet
    key = keys[TITANX_GPU.name]
    with gw._mu:
        gw._pool.pop(key, None)  # force the next query through the breaker
    breaker = gw.resilience.breaker(key)
    for _ in range(breaker.threshold):
        with pytest.raises(OSError):
            with breaker.call():
                raise OSError("simulated store failure")
    try:
        status, headers, raw = _post(url, _q(artifact=key))
        _assert_error(status, raw, "circuit_open")
        assert int(headers["Retry-After"]) >= 1
    finally:
        gw.resilience._breakers.pop(key, None)
    status, _, _ = _post(url, _q(artifact=key))
    assert status == 200


def test_http_query_many_deadline_classifies_elements(fleet):
    """An envelope deadline on /v1/query_many answers 200 with per-element
    deadline_exceeded pairs -- batch semantics, not a blanket 504."""
    _, url, keys, _ = fleet
    key = keys[MAXWELL_GPU.name]
    body = wire.encode_request_many(
        [(QueryRequest(use_cache=False), key, None)] * 3, deadline_ms=1e-6
    )
    status, _, raw = _post(url, body, path="/v1/query_many")
    assert status == 200
    payload = json.loads(raw)
    assert payload["ok"] is True
    for row in payload["results"]:
        assert row["ok"] is False
        assert row["error"]["code"] == "deadline_exceeded"


def test_in_process_matches_http_statuses(fleet):
    """The in-process exception carries the same status the wire answers:
    no drift between `except GatewayError` callers and HTTP clients."""
    gw, url, _, _ = fleet
    with pytest.raises(GatewayError) as ei:
        gw.query(QueryRequest(use_cache=False), artifact="0" * 64)
    status, _, _ = _post(url, _q(artifact="0" * 64))
    assert ei.value.http_status == status == 404
