"""The JAX package's ``tests/test_portfolio_chaos.py``, run on the port's modules.

Chaos: portfolio routing degrades member-by-member, never a 500.

Arms :mod:`repro_torch.service.faults` ``route.member.<hw>`` points while
routing through a live portfolio: a failing member design falls back to
the group's next-preferred member with a structured ``degraded: true``
answer, per-member circuit breakers open after repeated failures, and
only when *every* member is down does the route fail -- as a structured
503 ``portfolio_exhausted``, not an internal error.
"""

import threading

import numpy as np
import pytest

from repro_torch.core.timemodel import GPUS_BY_NAME
from repro_torch.service import faults, wire
from repro_torch.service.client import GatewayClient
from repro_torch.service.errors import ERROR_HTTP_STATUS
from repro_torch.service.gateway import Gateway, serve_http
from repro_torch.service.portfolio import (
    PortfolioExhaustedError,
    PortfolioServer,
    RouteRequest,
    build_portfolio,
)
from repro_torch.service.resilience import GatewayResilience
from repro_torch.service.server import CodesignServer
from repro_torch.service.store import ArtifactStore


@pytest.fixture(autouse=True)
def _clean_faults():
    faults.reset()
    yield
    faults.reset()


@pytest.fixture(scope="module")
def fleet(tmp_path_factory):
    """A store holding one sweep + one genuinely multi-member portfolio."""
    root = str(tmp_path_factory.mktemp("chaos-store"))
    store = ArtifactStore(root)
    srv = CodesignServer(
        store, gpu=GPUS_BY_NAME["gtx980"], downsample=64, engine="numpy",
        batch_window=0.0,
    )
    srv.ensure_artifact()
    area = np.asarray(store.get(srv.key).hw_area, np.float64)
    art, res = build_portfolio(
        store, srv.key, 2, float(area.sum()), objective="throughput", device="cpu"
    )
    assert len(res.members) >= 2, "chaos needs a multi-member portfolio"
    return root, store, srv.key, art.key


def _server(store, sweep_key, portfolio_key, **res_kw):
    return PortfolioServer(
        store.get(portfolio_key),
        store.get(sweep_key),
        resilience=GatewayResilience(**res_kw) if res_kw else None,
    )


def _cell_assigned_to_slot0(ps):
    """A cell label whose primary member is slot 0 (exists: slot 0 is the
    fastest member for at least one group in a multi-member optimum)."""
    for label, g in ps._groups.items():
        if g["slot"] == 0:
            return label
    raise AssertionError("no group routed to member slot 0")


def test_failed_member_degrades_to_next_preference(fleet):
    root, store, sweep_key, portfolio_key = fleet
    ps = _server(store, sweep_key, portfolio_key)
    cell = _cell_assigned_to_slot0(ps)
    primary = ps.members[0]

    healthy = ps.route(RouteRequest(cell=cell))
    assert healthy.hw_index == primary and not healthy.degraded

    faults.enable(f"route.member.{primary}", error=OSError("member on fire"))
    try:
        resp = ps.route(RouteRequest(cell=cell))
    finally:
        faults.reset()
    assert resp.degraded and resp.fallback_from == (primary,)
    assert resp.hw_index != primary
    assert resp.hw_index in ps.members
    assert resp.gflops > 0 and np.isfinite(resp.time_s)

    # fault cleared -> back to the primary, un-degraded
    again = ps.route(RouteRequest(cell=cell))
    assert again == healthy


def test_breaker_opens_and_recovers(fleet):
    root, store, sweep_key, portfolio_key = fleet
    ps = _server(store, sweep_key, portfolio_key,
                 breaker_threshold=2, breaker_cooldown_s=0.05)
    cell = _cell_assigned_to_slot0(ps)
    primary = ps.members[0]

    # two raw failures open the per-member breaker...
    faults.enable(f"route.member.{primary}", error=OSError("flaky"), count=2)
    for _ in range(2):
        assert ps.route(RouteRequest(cell=cell)).degraded
    # ...so the third route degrades WITHOUT touching the member (the
    # fault budget is exhausted; a read would have succeeded)
    resp = ps.route(RouteRequest(cell=cell))
    assert resp.degraded and resp.fallback_from == (primary,)

    # after the cooldown the half-open probe succeeds and routing heals
    import time

    time.sleep(0.06)
    assert not ps.route(RouteRequest(cell=cell)).degraded


def test_all_members_down_is_structured_exhaustion(fleet):
    root, store, sweep_key, portfolio_key = fleet
    ps = _server(store, sweep_key, portfolio_key)
    cell = next(iter(ps.cell_labels()))
    for hw in ps.members:
        faults.enable(f"route.member.{hw}", error=OSError("fleet outage"))
    with pytest.raises(PortfolioExhaustedError) as exc:
        ps.route(RouteRequest(cell=cell))
    assert exc.value.code == "portfolio_exhausted"
    assert ERROR_HTTP_STATUS[exc.value.code] == 503
    assert exc.value.retry_after_s == 1.0


def test_http_route_degrades_never_500(fleet):
    root, store, sweep_key, portfolio_key = fleet
    gw = Gateway([root], batch_window=0.0)
    httpd = serve_http(gw)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    try:
        host, port = httpd.server_address[:2]
        client = GatewayClient(f"http://{host}:{port}", retry=None)
        oracle = PortfolioServer(store.get(portfolio_key), store.get(sweep_key))
        cell = _cell_assigned_to_slot0(oracle)
        primary = oracle.members[0]

        faults.enable(f"route.member.{primary}", error=OSError("down"))
        resp = client.route(cell, artifact=portfolio_key)
        assert resp.degraded and primary in resp.fallback_from
        assert resp.hw_index != primary

        # every member down -> structured 503, never an internal 500
        for hw in oracle.members:
            faults.enable(f"route.member.{hw}", error=OSError("down"))
        body, status = client._request(
            "/v1/route",
            wire.encode_route_request(
                RouteRequest(cell=cell), artifact=portfolio_key
            ),
        )
        assert status == 503
        with pytest.raises(wire.RemoteError) as exc:
            wire.decode_route_response(body, http_status=status)
        assert exc.value.code == "portfolio_exhausted"

        faults.reset()
        healthy = client.route(cell, artifact=portfolio_key)
        assert not healthy.degraded and healthy.hw_index == primary
    finally:
        httpd.shutdown()
        httpd.server_close()
