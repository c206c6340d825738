"""The JAX package's ``tests/test_usage.py``, run on the port's modules.

Persistent usage ledger + kind-aware retention: record/flush/merge
round trips, restart survival across two gateway lifetimes, client-bucket
folding, corrupt-file tolerance, the retention plan's protection rules
(never evict the sweep behind a portfolio; telemetry ages out first),
telemetry-cap pruning on the gateway, deterministic ``gc --dry-run``
bytes, and the process-level gauges."""

import contextlib
import io
import json
import os
import tempfile
import threading

import pytest

from repro_torch.core import MAXWELL, enumerate_hw_space
from repro_torch.core.timemodel import MAXWELL_GPU
from repro_torch.core.workload import paper_workload
from repro_torch.service import ArtifactStore, CodesignServer, Gateway, QueryRequest
from repro_torch.service import cli
from repro_torch.service.usage import (
    LEDGER_FILENAME,
    MAX_CLIENT_BUCKETS,
    UsageLedger,
    retention_plan,
)


@pytest.fixture(scope="module")
def sweep_store():
    """One tiny numpy sweep artifact in a fresh store root."""
    root = tempfile.mkdtemp(prefix="usagestore-")
    store = ArtifactStore(root)
    srv = CodesignServer(
        store,
        workload=paper_workload(["heat2d"]),
        gpu=MAXWELL_GPU,
        hw=enumerate_hw_space(MAXWELL, max_area=650.0).downsample(64),
        engine="numpy",
        batch_window=0.0,
    )
    srv.ensure_artifact()
    return root, store, srv.key


# ---------------------------------------------------------------------------
# ledger unit behavior
# ---------------------------------------------------------------------------


def test_record_flush_reload_round_trip(tmp_path):
    root = str(tmp_path)
    led = UsageLedger(root, clock=lambda: 100.0)
    led.record("k1", n=2, nbytes=300, client="alice")
    led.record("k1", n=1, nbytes=100, client="bob")
    led.record("k2")
    assert led.flush() is True
    # a second ledger (new process) sees the persisted state
    led2 = UsageLedger(root, clock=lambda: 200.0)
    rec = led2.get("k1")
    assert rec == {"hits": 3, "bytes": 400, "last_access": 100.0,
                   "clients": {"alice": 2, "bob": 1}}
    # its own deltas MERGE (sum hits, max last_access) on flush
    led2.record("k1", n=1)
    led2.flush()
    led3 = UsageLedger(root)
    assert led3.get("k1")["hits"] == 4
    assert led3.get("k1")["last_access"] == 200.0
    assert led3.get("k2")["hits"] == 1


def test_flush_is_atomic_and_dotfile_invisible_to_store(tmp_path):
    root = str(tmp_path)
    store = ArtifactStore(root)
    led = UsageLedger(root)
    led.record("k1")
    led.flush()
    assert os.path.exists(os.path.join(root, LEDGER_FILENAME))
    # the ledger (and its lock) never show up as artifacts
    assert store.keys() == []


def test_corrupt_or_foreign_ledger_is_ignored(tmp_path):
    root = str(tmp_path)
    path = os.path.join(root, LEDGER_FILENAME)
    with open(path, "w") as f:
        f.write("not json{{{")
    led = UsageLedger(root)
    assert led.snapshot() == {}
    with open(path, "w") as f:
        json.dump({"v": 999, "artifacts": {"k": {"hits": 5}}}, f)
    assert UsageLedger(root).snapshot() == {}


def test_client_buckets_fold_deterministically(tmp_path):
    led = UsageLedger(str(tmp_path), clock=lambda: 1.0)
    # many distinct clients, traffic proportional to index
    for i in range(3 * MAX_CLIENT_BUCKETS):
        led.record("k", n=i + 1, client=f"c{i:03d}")
    led.flush()
    rec = UsageLedger(str(tmp_path)).get("k")
    clients = rec["clients"]
    assert len(clients) <= MAX_CLIENT_BUCKETS
    assert "other" in clients
    # total traffic is conserved through the fold
    total = 3 * MAX_CLIENT_BUCKETS * (3 * MAX_CLIENT_BUCKETS + 1) // 2
    assert sum(clients.values()) == total
    # the highest-traffic buckets survived by name
    assert f"c{3 * MAX_CLIENT_BUCKETS - 1:03d}" in clients


def test_maybe_flush_honors_interval(tmp_path):
    t = [0.0]
    led = UsageLedger(str(tmp_path), flush_interval_s=60.0, clock=lambda: t[0])
    led.record("k")
    assert led.maybe_flush() is False  # interval not elapsed
    t[0] = 61.0
    assert led.maybe_flush() is True
    assert led.maybe_flush() is False  # nothing pending


def test_concurrent_recorders_lose_nothing(tmp_path):
    led = UsageLedger(str(tmp_path))
    def work():
        for _ in range(1000):
            led.record("k", n=1, nbytes=2)
    ts = [threading.Thread(target=work) for _ in range(8)]
    for th in ts:
        th.start()
    for th in ts:
        th.join()
    led.flush()
    rec = UsageLedger(str(tmp_path)).get("k")
    assert rec["hits"] == 8000 and rec["bytes"] == 16000


# ---------------------------------------------------------------------------
# retention plan
# ---------------------------------------------------------------------------


def _entries():
    return [
        {"key": "sweep-a", "kind": "sweep"},
        {"key": "sweep-b", "kind": "sweep"},
        {"key": "portfolio-1", "kind": "portfolio", "sweep_key": "sweep-a"},
        {"key": "tele-1", "kind": "telemetry", "collected_at": 10.0},
        {"key": "tele-2", "kind": "telemetry", "collected_at": 20.0},
        {"key": "tele-3", "kind": "telemetry", "collected_at": 30.0},
    ]


def test_plan_protects_portfolio_and_its_sweep():
    plan = retention_plan(_entries(), {}, telemetry_cap=0, max_artifacts=0)
    evicted = {e["key"] for e in plan["evict"]}
    assert "portfolio-1" not in evicted
    assert "sweep-a" not in evicted  # the member sweep is load-bearing
    assert "sweep-b" in evicted      # unreferenced sweep is fair game
    assert plan["protected"]["sweep-a"].startswith("sweep behind portfolio")


def test_plan_telemetry_ages_out_oldest_first():
    plan = retention_plan(_entries(), {}, telemetry_cap=1)
    evicted = [e["key"] for e in plan["evict"]]
    assert sorted(evicted) == ["tele-1", "tele-2"]  # newest (tele-3) kept
    assert all(e["kind"] == "telemetry" for e in plan["evict"])
    assert "tele-3" in plan["kept"]


def test_plan_total_cap_evicts_coldest_by_ledger():
    usage = {
        "sweep-b": {"hits": 100, "last_access": 50.0},
        "tele-3": {"hits": 0, "last_access": None},
    }
    # cap of 3 over {sweep-a, sweep-b, portfolio-1, tele-3} after the
    # telemetry cap evicts tele-1/2; protected sweep-a and portfolio-1
    # stay, so the cold tele-3 goes before the hot sweep-b
    plan = retention_plan(_entries(), usage, telemetry_cap=1, max_artifacts=3)
    evicted = [e["key"] for e in plan["evict"]]
    assert "tele-3" in evicted
    assert "sweep-b" not in evicted


def test_plan_is_deterministic_and_json_stable():
    a = retention_plan(_entries(), {}, telemetry_cap=1, max_artifacts=2)
    b = retention_plan(list(reversed(_entries())), {}, telemetry_cap=1,
                       max_artifacts=2)
    assert json.dumps(a, sort_keys=True) == json.dumps(b, sort_keys=True)
    with pytest.raises(ValueError):
        retention_plan(_entries(), {}, telemetry_cap=-1)


# ---------------------------------------------------------------------------
# gateway integration: restart survival, telemetry cap, gc CLI
# ---------------------------------------------------------------------------


def test_ledger_survives_two_gateway_lifetimes(sweep_store):
    root, store, key = sweep_store
    req = QueryRequest(freqs={"heat2d": 1.0})
    # lifetime 1: three hits, flushed on shutdown (what cmd_serve does)
    gw1 = Gateway(root, batch_window=0.0, usage_flush_interval=1e9)
    for _ in range(3):
        gw1.query(req, artifact=key)
    gw1.flush_usage()
    # lifetime 2: resumes the persisted counts, adds two more
    gw2 = Gateway(root, batch_window=0.0, usage_flush_interval=1e9)
    row = next(r for r in gw2.entries() if r["key"] == key)
    assert row["hits"] == 3 and row["last_access"] is not None
    for _ in range(2):
        gw2.query(req, artifact=key)
    row = next(r for r in gw2.entries() if r["key"] == key)
    assert row["hits"] == 5  # merged view: persisted 3 + buffered 2
    gw2.flush_usage()
    assert UsageLedger(root).get(key)["hits"] == 5


def test_gateway_telemetry_cap_prunes_snapshot_series(sweep_store):
    root, store, key = sweep_store
    gw = Gateway(root, batch_window=0.0, telemetry_cap=2)
    for _ in range(5):
        gw.persist_telemetry()
    tele = [k for k in store.keys()
            if store.get(k).kind == "telemetry"]
    assert len(tele) == 2
    # newest survive: collected_at strictly increasing across persists
    ats = sorted(store.get(k).payload["collected_at"] for k in tele)
    all_ats = ats  # remaining two are the two largest by construction
    assert all_ats == sorted(all_ats)
    # clean up for other tests sharing the module store
    for k in tele:
        store.delete(k)
    gw.refresh()


def test_gc_dry_run_bytes_are_deterministic(sweep_store, capsys):
    root, store, key = sweep_store
    for i in range(3):
        store.put_json("telemetry", {"collected_at": float(i), "gateway": {}},
                       routing={"workload": "gateway-telemetry"})
    try:
        cli.main(["gc", "--store", root, "--dry-run", "--telemetry-cap", "1"])
        first = capsys.readouterr().out
        cli.main(["gc", "--store", root, "--dry-run", "--telemetry-cap", "1"])
        second = capsys.readouterr().out
        assert first == second
        doc = json.loads(first)
        plan = doc[0]["plan"]
        assert [e["kind"] for e in plan["evict"]] == ["telemetry", "telemetry"]
        assert doc[0]["applied"] is False and doc[0]["deleted"] == []
        assert key in plan["kept"]
        # --apply executes exactly the printed plan
        cli.main(["gc", "--store", root, "--apply", "--telemetry-cap", "1"])
        applied = json.loads(capsys.readouterr().out)
        assert sorted(applied[0]["deleted"]) == sorted(
            e["key"] for e in plan["evict"]
        )
    finally:
        for k in list(store.keys()):
            if store.get(k).kind == "telemetry":
                store.delete(k)


# ---------------------------------------------------------------------------
# process gauges
# ---------------------------------------------------------------------------


def test_process_gauges_sample_without_raising():
    from repro_torch.obs.process import M_RSS, rss_bytes, sample_process

    rss = rss_bytes()
    if rss is not None:  # Linux/macOS: a real positive byte count
        assert rss > 1 << 20
    sample_process()  # must never raise regardless of platform
    if rss is not None:
        assert M_RSS.value > 0
