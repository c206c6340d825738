"""The JAX package's ``tests/test_resilience.py``, run on the port's modules.

Resilience layer: token buckets, admission control, circuit breakers,
deadlines, the retry policy, fault injection, the bounded build lock and
the poison-batch solo-retry path -- all with injectable clocks/rngs/sleeps
so nothing here actually waits."""

import os
import random
import tempfile
import threading
import urllib.error
from contextlib import ExitStack

import numpy as np
import pytest

from repro_torch.core import MAXWELL, enumerate_hw_space
from repro_torch.core.timemodel import MAXWELL_GPU
from repro_torch.core.workload import paper_workload
from repro_torch.service import (
    ArtifactStore,
    BuildLockTimeoutError,
    CircuitOpenError,
    CodesignServer,
    Deadline,
    DeadlineExceededError,
    GatewayClient,
    GatewayError,
    QueryRequest,
    RateLimitedError,
    RetryPolicy,
    ShedError,
    faults,
)
from repro_torch.service.errors import ERROR_HTTP_STATUS
from repro_torch.service.resilience import (
    AdmissionController,
    CircuitBreaker,
    TokenBucket,
    check_deadline,
    current_deadline,
    deadline_scope,
    remaining_s,
)

try:
    import fcntl
except ImportError:  # pragma: no cover - non-POSIX
    fcntl = None


class FakeClock:
    def __init__(self, t: float = 1000.0):
        self.t = t

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> None:
        self.t += dt


@pytest.fixture(autouse=True)
def _no_leftover_faults():
    faults.reset()
    yield
    faults.reset()


# ---------------------------------------------------------------------------
# token bucket
# ---------------------------------------------------------------------------
def test_token_bucket_disabled_always_admits():
    clk = FakeClock()
    for rate in (0.0, float("inf")):
        b = TokenBucket(rate, clock=clk)
        assert all(b.try_acquire() == 0.0 for _ in range(1000))


def test_token_bucket_burst_drain_and_refill():
    clk = FakeClock()
    b = TokenBucket(rate=2.0, burst=3.0, clock=clk)
    assert [b.try_acquire() for _ in range(3)] == [0.0, 0.0, 0.0]
    wait = b.try_acquire()
    assert wait == pytest.approx(0.5)  # 1 token at 2/s
    clk.advance(0.5)
    assert b.try_acquire() == 0.0
    # refill caps at burst: a long idle never banks more than `burst`
    clk.advance(1e6)
    assert [b.try_acquire() for _ in range(3)] == [0.0, 0.0, 0.0]
    assert b.try_acquire() > 0


def test_token_bucket_rejects_bad_params():
    with pytest.raises(ValueError):
        TokenBucket(rate=-1.0)
    with pytest.raises(ValueError):
        TokenBucket(rate=5.0, burst=0.0)


# ---------------------------------------------------------------------------
# admission control
# ---------------------------------------------------------------------------
def test_admission_sheds_over_inflight_watermark():
    adm = AdmissionController(max_inflight=2, clock=FakeClock())
    with ExitStack() as stack:
        stack.enter_context(adm.admit("a"))
        stack.enter_context(adm.admit("b"))
        assert adm.inflight == 2
        with pytest.raises(ShedError) as ei:
            stack.enter_context(adm.admit("c"))
        assert ei.value.code == "shed"
        assert ei.value.http_status == 503
        assert ei.value.retry_after_s > 0
    # contexts released: admits again
    assert adm.inflight == 0
    with adm.admit("c"):
        pass


def test_admission_global_rate_limit():
    clk = FakeClock()
    adm = AdmissionController(global_rate=1.0, global_burst=1.0, clock=clk)
    with adm.admit("x"):
        pass
    with pytest.raises(RateLimitedError) as ei:
        with adm.admit("x"):
            pass
    assert ei.value.code == "rate_limited"
    assert ei.value.http_status == 429
    assert ei.value.retry_after_s == pytest.approx(1.0)
    clk.advance(1.0)
    with adm.admit("x"):
        pass
    # a rejected request must not leak in-flight accounting
    assert adm.inflight == 0


def test_admission_per_client_buckets_are_isolated():
    clk = FakeClock()
    adm = AdmissionController(client_rate=1.0, client_burst=1.0, clock=clk)
    with adm.admit("alice"):
        pass
    with pytest.raises(RateLimitedError, match="alice"):
        with adm.admit("alice"):
            pass
    # bob has his own bucket
    with adm.admit("bob"):
        pass


def test_admission_client_bucket_lru_is_bounded():
    clk = FakeClock()
    adm = AdmissionController(client_rate=100.0, max_clients=2, clock=clk)
    for name in ("a", "b", "c", "d"):
        with adm.admit(name):
            pass
    assert len(adm._clients) <= 2


# ---------------------------------------------------------------------------
# deadlines
# ---------------------------------------------------------------------------
def test_deadline_expiry_and_stage_label():
    clk = FakeClock()
    d = Deadline(100.0, clock=clk)
    assert not d.expired
    assert d.remaining_s() == pytest.approx(0.1)
    d.check("gateway.resolve")  # free while budget remains
    clk.advance(0.2)
    assert d.expired
    assert d.remaining_s() == 0.0
    with pytest.raises(DeadlineExceededError, match="store.open"):
        d.check("store.open")
    err = pytest.raises(DeadlineExceededError, d.check, "x").value
    assert err.code == "deadline_exceeded"
    assert err.http_status == 504


def test_deadline_rejects_bad_budget():
    for bad in (0.0, -5.0, float("inf"), float("nan")):
        with pytest.raises(ValueError):
            Deadline(bad)


def test_deadline_scope_binds_and_clears():
    assert current_deadline() is None
    check_deadline("anywhere")  # no deadline in flight: free no-op
    assert remaining_s() is None
    assert remaining_s(default=7.0) == 7.0
    clk = FakeClock()
    d = Deadline(50.0, clock=clk)
    with deadline_scope(d):
        assert current_deadline() is d
        assert remaining_s(default=99.0) == pytest.approx(0.05)
        clk.advance(1.0)
        with pytest.raises(DeadlineExceededError):
            check_deadline("server.query")
        # an inner scope can explicitly clear the inherited deadline
        with deadline_scope(None):
            check_deadline("inner")
    assert current_deadline() is None


def test_deadline_does_not_leak_across_threads():
    seen = {}

    def worker():
        seen["deadline"] = current_deadline()

    with deadline_scope(Deadline(1000.0)):
        t = threading.Thread(target=worker)
        t.start()
        t.join()
    assert seen["deadline"] is None


# ---------------------------------------------------------------------------
# circuit breaker
# ---------------------------------------------------------------------------
def _fail(breaker, exc=OSError("boom")):
    with pytest.raises(type(exc)):
        with breaker.call():
            raise exc


def test_breaker_opens_after_threshold_then_fails_fast():
    clk = FakeClock()
    b = CircuitBreaker("k1", threshold=3, cooldown_s=10.0, clock=clk)
    _fail(b)
    _fail(b)
    assert b.state == CircuitBreaker.CLOSED  # 2 < threshold
    _fail(b)
    assert b.state == CircuitBreaker.OPEN
    with pytest.raises(CircuitOpenError) as ei:
        with b.call():
            raise AssertionError("must not run while open")
    assert ei.value.code == "circuit_open"
    assert ei.value.http_status == 503
    assert 0 < ei.value.retry_after_s <= 10.0


def test_breaker_success_resets_failure_streak():
    b = CircuitBreaker("k2", threshold=2, clock=FakeClock())
    _fail(b)
    with b.call():
        pass  # success wipes the streak
    _fail(b)
    assert b.state == CircuitBreaker.CLOSED


def test_breaker_half_open_probe_recovers():
    clk = FakeClock()
    b = CircuitBreaker("k3", threshold=1, cooldown_s=5.0, clock=clk)
    _fail(b)
    assert b.state == CircuitBreaker.OPEN
    clk.advance(5.1)
    with b.call():  # the half-open probe, succeeding
        assert b.state == CircuitBreaker.HALF_OPEN
    assert b.state == CircuitBreaker.CLOSED
    with b.call():
        pass


def test_breaker_half_open_probe_failure_reopens():
    clk = FakeClock()
    b = CircuitBreaker("k4", threshold=1, cooldown_s=5.0, clock=clk)
    _fail(b)
    clk.advance(5.1)
    _fail(b, RuntimeError("still broken"))
    assert b.state == CircuitBreaker.OPEN
    with pytest.raises(CircuitOpenError):
        with b.call():
            pass


def test_breaker_admits_one_probe_at_a_time():
    clk = FakeClock()
    b = CircuitBreaker("k5", threshold=1, cooldown_s=1.0, clock=clk)
    _fail(b)
    clk.advance(1.5)
    probe = b.call()
    probe.__enter__()  # probe in flight
    try:
        with pytest.raises(CircuitOpenError, match="probe in flight"):
            with b.call():
                pass
    finally:
        probe.__exit__(None, None, None)
    assert b.state == CircuitBreaker.CLOSED


def test_breaker_ignores_gateway_errors():
    """Classified outcomes (a caller's bad key, a spent deadline) must
    neither trip nor reset the breaker -- else one impatient client opens
    the circuit for everyone."""
    clk = FakeClock()
    b = CircuitBreaker("k6", threshold=2, clock=clk)
    _fail(b)  # one real failure banked
    for _ in range(10):
        with pytest.raises(DeadlineExceededError):
            with b.call():
                raise DeadlineExceededError("budget spent")
    assert b.state == CircuitBreaker.CLOSED
    _fail(b)  # second REAL failure: streak was preserved, not reset
    assert b.state == CircuitBreaker.OPEN


# ---------------------------------------------------------------------------
# retry policy
# ---------------------------------------------------------------------------
class _FixedRng:
    def __init__(self, r: float):
        self.r = r

    def random(self) -> float:
        return self.r


def test_retry_policy_exponential_ramp_and_cap():
    p = RetryPolicy(max_retries=5, base_s=0.1, max_s=1.0, jitter=0.0)
    rng = _FixedRng(0.0)
    assert [p.delay(a, rng) for a in (1, 2, 3, 4, 5)] == [
        pytest.approx(0.1), pytest.approx(0.2), pytest.approx(0.4),
        pytest.approx(0.8), pytest.approx(1.0),  # capped
    ]


def test_retry_policy_full_jitter_range():
    p = RetryPolicy(base_s=0.4, max_s=10.0, jitter=0.5)
    assert p.delay(1, _FixedRng(0.0)) == pytest.approx(0.4)  # no jitter drawn
    assert p.delay(1, _FixedRng(1.0)) == pytest.approx(0.2)  # full jitter
    rng = random.Random(7)
    for _ in range(100):
        d = p.delay(2, rng)
        assert 0.4 <= d <= 0.8


def test_retry_policy_honors_retry_after_capped():
    p = RetryPolicy(base_s=0.05, max_s=2.0)
    rng = _FixedRng(0.5)
    assert p.delay(1, rng, retry_after_s=0.7) == pytest.approx(0.7)
    assert p.delay(1, rng, retry_after_s=3600.0) == pytest.approx(2.0)
    assert p.delay(1, rng, retry_after_s=-4.0) == 0.0


def test_retry_policy_rejects_bad_params():
    with pytest.raises(ValueError):
        RetryPolicy(max_retries=-1)
    with pytest.raises(ValueError):
        RetryPolicy(jitter=1.5)


# ---------------------------------------------------------------------------
# client retry integration (scripted transport; no sockets, no sleeps)
# ---------------------------------------------------------------------------
def _scripted_client(script, **kw):
    """A GatewayClient whose transport replays `script`: each item is a
    ``(body, status, retry_after)`` tuple or an exception to raise."""
    sleeps = []
    kw.setdefault("retry", RetryPolicy(max_retries=3, base_s=0.1,
                                       max_s=2.0, jitter=0.0))
    c = GatewayClient("http://127.0.0.1:1", sleep=sleeps.append,
                      rng=_FixedRng(0.0), **kw)
    it = iter(script)

    def fake_exchange(method, path, body, hdrs):
        item = next(it)
        if isinstance(item, BaseException):
            raise item
        return item

    c._exchange = fake_exchange
    return c, sleeps


def test_client_retries_connection_reset_then_succeeds():
    reset = urllib.error.URLError(ConnectionResetError("peer reset"))
    c, sleeps = _scripted_client([reset, (b"ok", 200, None)])
    data, status = c._request("/v1/query", b"{}")
    assert (data, status) == (b"ok", 200)
    assert c.stats["retries"] == 1
    assert sleeps == [pytest.approx(0.1)]


def test_client_retries_429_honoring_retry_after():
    c, sleeps = _scripted_client([(b"no", 429, 0.7), (b"ok", 200, None)])
    data, status = c._request("/v1/query", b"{}")
    assert (data, status) == (b"ok", 200)
    assert sleeps == [pytest.approx(0.7)]


def test_client_retries_503_with_backoff_schedule():
    c, sleeps = _scripted_client(
        [(b"a", 503, None), (b"b", 503, None), (b"ok", 200, None)]
    )
    data, status = c._request("/v1/query", b"{}")
    assert status == 200
    assert sleeps == [pytest.approx(0.1), pytest.approx(0.2)]


def test_client_retry_budget_exhausts_to_last_answer():
    c, _ = _scripted_client([(b"x", 503, None)] * 4)  # 1 try + 3 retries
    data, status = c._request("/v1/query", b"{}")
    assert status == 503
    assert c.stats["retries"] == 3


def test_client_never_retries_timeouts():
    import socket

    c, sleeps = _scripted_client(
        [urllib.error.URLError(socket.timeout("timed out"))]
    )
    with pytest.raises(urllib.error.URLError):
        c._request("/v1/query", b"{}")
    assert sleeps == [] and c.stats["retries"] == 0


def test_client_never_retries_connection_refused():
    c, sleeps = _scripted_client(
        [urllib.error.URLError(ConnectionRefusedError("down"))]
    )
    with pytest.raises(urllib.error.URLError):
        c._request("/v1/query", b"{}")
    assert sleeps == []


def test_client_retry_none_disables():
    c, sleeps = _scripted_client([(b"x", 503, None)], retry=None)
    _, status = c._request("/v1/query", b"{}")
    assert status == 503 and sleeps == []


def test_client_does_not_retry_non_idempotent_statuses():
    for status in (400, 404, 409, 500, 504):
        c, sleeps = _scripted_client([(b"x", status, None)])
        _, got = c._request("/v1/query", b"{}")
        assert got == status and sleeps == []


# ---------------------------------------------------------------------------
# fault injection registry
# ---------------------------------------------------------------------------
def test_fault_fire_is_noop_when_disarmed():
    faults.fire("store.open")  # must not raise
    assert not faults.should_drop("gateway.drop_socket")


def test_fault_error_and_latency():
    slept = []
    faults.enable("store.open", latency_s=0.25, error=OSError("disk gone"))
    with pytest.raises(OSError, match="disk gone"):
        faults.fire("store.open", sleep=slept.append)
    assert slept == [0.25]


def test_fault_count_auto_clears_and_after_skips():
    faults.enable("server.batch", error=RuntimeError("x"), count=2, after=1)
    faults.fire("server.batch")  # hit 1: skipped by after=1
    for _ in range(2):
        with pytest.raises(RuntimeError):
            faults.fire("server.batch")
    faults.fire("server.batch")  # count exhausted: auto-cleared
    assert not faults.is_active("server.batch")


def test_fault_env_string_errors_whitelisted():
    faults.configure({"store.open": {"error": "TimeoutError:slow disk"}})
    with pytest.raises(TimeoutError, match="slow disk"):
        faults.fire("store.open")
    faults.configure({"store.open": {"error": "SystemExit:nope"}})
    with pytest.raises(RuntimeError):  # unknown names never eval
        faults.fire("store.open")


def test_fault_configure_rejects_unknown_fields():
    with pytest.raises(ValueError, match="unknown fields"):
        faults.configure({"store.open": {"latency": 1.0}})
    with pytest.raises(ValueError, match="must be an object"):
        faults.configure({"store.open": 5})


def test_should_drop_consumes_hits():
    faults.enable("gateway.drop_socket", count=1)
    assert faults.should_drop("gateway.drop_socket")
    assert not faults.should_drop("gateway.drop_socket")


# ---------------------------------------------------------------------------
# bounded build lock (satellite: build_lock_timeout)
# ---------------------------------------------------------------------------
@pytest.mark.skipif(fcntl is None, reason="flock requires POSIX")
def test_build_lock_timeout_is_structured():
    root = tempfile.mkdtemp(prefix="lockstore-")
    store = ArtifactStore(root)
    key = "f" * 64
    # hold the flock on a SEPARATE file descriptor: flock exclusion is per
    # open-file-description, so this conflicts even within one process
    path = os.path.join(root, f".lock-{key}")
    fd = os.open(path, os.O_CREAT | os.O_RDWR, 0o644)
    fcntl.flock(fd, fcntl.LOCK_EX)
    try:
        with pytest.raises(BuildLockTimeoutError, match="still held") as ei:
            with store.build_lock(key, timeout_s=0.05):
                raise AssertionError("lock must not be acquired")
        assert ei.value.code == "build_lock_timeout"
        assert ei.value.http_status == ERROR_HTTP_STATUS["build_lock_timeout"]
        assert isinstance(ei.value, GatewayError)
        assert ei.value.retry_after_s > 0
    finally:
        fcntl.flock(fd, fcntl.LOCK_UN)
        os.close(fd)
    # holder released: the same acquisition now succeeds
    with store.build_lock(key, timeout_s=1.0):
        pass


def test_store_lock_timeout_env_and_validation(monkeypatch):
    monkeypatch.setenv("REPRO_LOCK_TIMEOUT_S", "12.5")
    root = tempfile.mkdtemp(prefix="lockenv-")
    assert ArtifactStore(root).lock_timeout_s == 12.5
    with pytest.raises(ValueError):
        ArtifactStore(root, lock_timeout_s=0.0)


# ---------------------------------------------------------------------------
# server integration: deadlines + the poison-batch metric (needs a real
# artifact; everything below shares one tiny single-stencil sweep)
# ---------------------------------------------------------------------------
STRIDE = 64


def small_hw():
    return enumerate_hw_space(MAXWELL, max_area=650.0).downsample(STRIDE)


@pytest.fixture(scope="module")
def built():
    root = tempfile.mkdtemp(prefix="resil-")
    store = ArtifactStore(root)
    srv = CodesignServer(
        store, workload=paper_workload(["heat2d"]), gpu=MAXWELL_GPU,
        hw=small_hw(), engine="numpy", batch_window=0.0,
    )
    srv.ensure_artifact()
    return store, srv


def test_expired_deadline_fails_server_query(built):
    _, srv = built
    clk = FakeClock()
    d = Deadline(10.0, clock=clk)
    clk.advance(1.0)
    with deadline_scope(d):
        with pytest.raises(DeadlineExceededError, match="server.query"):
            srv.query(QueryRequest())
    # scope exited: the same server answers normally
    assert np.isfinite(srv.query(QueryRequest()).best_gflops)


def test_expired_deadline_fails_store_open(built):
    store, srv = built
    clk = FakeClock()
    d = Deadline(10.0, clock=clk)
    clk.advance(1.0)
    with deadline_scope(d):
        with pytest.raises(DeadlineExceededError, match="store.open"):
            store.get(srv.key)


def test_store_open_fault_reaches_caller(built):
    store, srv = built
    faults.enable("store.open", error=OSError("injected disk failure"))
    with pytest.raises(OSError, match="injected disk failure"):
        store.get(srv.key)
    faults.reset()
    assert store.get(srv.key) is not None


def test_poisoned_batch_counts_metric_and_solo_retries(built):
    """Satellite: a failing batch flush increments
    repro_server_batch_poison_total and every request is still answered
    via the solo-retry path."""
    from repro_torch.service.server import _M_BATCH_POISON

    store, _ = built
    srv = CodesignServer(
        store, hw=small_hw(), engine="numpy", batch_window=0.01,
    )
    srv.ensure_artifact()
    before = _M_BATCH_POISON.value
    faults.enable("server.batch", error=RuntimeError("injected flush"), count=1)
    resp = srv.query(QueryRequest())  # leader flush fails -> solo retry
    assert np.isfinite(resp.best_gflops)
    assert _M_BATCH_POISON.value == before + 1
    # fault consumed: the next batched query takes the fast path again
    assert np.isfinite(srv.query(QueryRequest()).best_gflops)
    assert _M_BATCH_POISON.value == before + 1
