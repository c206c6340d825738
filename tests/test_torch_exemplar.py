"""The JAX package's ``tests/test_exemplar.py``, run on the port's modules.

Tail-exemplar rings: deterministic top-N retention under heavy
multi-threaded writes (no lost slots, no interleaving-dependent
outcomes), error-ring recency semantics, and the snapshot shape the
``/v1/debug/exemplars`` endpoint serves."""

import threading

import pytest

from repro_torch.obs.exemplar import ExemplarStore


def test_constructor_validation():
    with pytest.raises(ValueError):
        ExemplarStore(slow_n=0)
    with pytest.raises(ValueError):
        ExemplarStore(max_errors=0)


def test_slow_ring_retains_top_n():
    ex = ExemplarStore(slow_n=3, max_errors=4, clock=lambda: 0.0)
    for i, d in enumerate([0.010, 0.050, 0.001, 0.030, 0.020, 0.002]):
        ex.offer("/v1/query", f"t{i}", d, 200)
    snap = ex.snapshot()["routes"]["/v1/query"]
    # slowest first: 50ms, 30ms, 20ms
    assert [e["trace_id"] for e in snap["slow"]] == ["t1", "t3", "t4"]
    assert [e["dur_us"] for e in snap["slow"]] == [50000, 30000, 20000]
    assert snap["errors"] == []


def test_error_ring_keeps_newest():
    ex = ExemplarStore(slow_n=2, max_errors=3, clock=lambda: 0.0)
    for i in range(5):
        ex.offer("/v1/query", f"e{i}", 0.001, 503, code="shed")
    snap = ex.snapshot()["routes"]["/v1/query"]
    # arrival order, oldest retained first, capped at 3
    assert [e["trace_id"] for e in snap["errors"]] == ["e2", "e3", "e4"]
    assert all(e["code"] == "shed" and e["status"] == 503
               for e in snap["errors"])
    # errors never consume slow slots
    assert snap["slow"] == []


def test_trace_tree_rides_along():
    ex = ExemplarStore(slow_n=2, max_errors=2, clock=lambda: 42.0)
    tree = {"trace_id": "abc", "name": "gateway.request", "dur_us": 900,
            "children": [{"name": "server.answer", "dur_us": 800}]}
    ex.offer("/v1/query", "abc", 0.0009, 200, trace=tree)
    e = ex.snapshot()["routes"]["/v1/query"]["slow"][0]
    assert e["trace"] == tree
    assert e["at"] == 42.0


def test_snapshot_route_filter():
    ex = ExemplarStore(slow_n=2, max_errors=2)
    ex.offer("/v1/query", "a", 0.001, 200)
    ex.offer("/v1/route", "b", 0.001, 200)
    snap = ex.snapshot(route="/v1/query")
    assert list(snap["routes"]) == ["/v1/query"]
    # a known-but-quiet route yields the empty shape, not a KeyError
    empty = ex.snapshot(route="/v1/query_many")
    assert empty["routes"]["/v1/query_many"] == {"slow": [], "errors": []}


def test_concurrent_writers_no_lost_slots():
    """8 writer threads, globally distinct durations: the retained set
    must be exactly the top-N by duration -- any interleaving that
    dropped or duplicated a slot would miss that oracle."""
    N = 16
    ex = ExemplarStore(slow_n=N, max_errors=8, clock=lambda: 0.0)
    threads = 8
    per = 500
    # duration encodes (thread, i) uniquely
    def work(t):
        for i in range(per):
            d = (t * per + i + 1) * 1e-6
            ex.offer("/v1/query", f"{t}:{i}", d, 200)
            if i % 97 == 0:
                ex.offer("/v1/query", f"err{t}:{i}", d, 500)

    ts = [threading.Thread(target=work, args=(t,)) for t in range(threads)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    snap = ex.snapshot()["routes"]["/v1/query"]
    got = [e["dur_us"] for e in snap["slow"]]
    top = sorted(range(1, threads * per + 1), reverse=True)[:N]
    assert got == top, "retained set is not the deterministic top-N"
    # the error ring stayed capped
    assert len(snap["errors"]) == 8


def test_equal_durations_evict_deterministically():
    """Ties on duration break by arrival sequence: the earliest-offered
    tie is the one evicted (min-heap orders (duration, seq))."""
    ex = ExemplarStore(slow_n=2, max_errors=2, clock=lambda: 0.0)
    ex.offer("/v1/query", "first", 0.005, 200)
    ex.offer("/v1/query", "second", 0.005, 200)
    ex.offer("/v1/query", "third", 0.006, 200)  # evicts "first"
    snap = ex.snapshot()["routes"]["/v1/query"]
    assert [e["trace_id"] for e in snap["slow"]] == ["third", "second"]
    # an equal-duration offer on a full ring does NOT evict (strict >)
    ex.offer("/v1/query", "fourth", 0.005, 200)
    snap = ex.snapshot()["routes"]["/v1/query"]
    assert [e["trace_id"] for e in snap["slow"]] == ["third", "second"]
