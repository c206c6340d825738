"""Command-line front end for the codesign query service.

Quickstart (first call sweeps once and persists the artifact; every later
call -- any frequency mix, budget, what-if -- is a warm re-reduction):

    python -m repro_torch.service.cli query --stencil heat2d --max-area 450
    python -m repro_torch.service.cli query --freq heat2d=3 --freq jacobi2d=1 \\
        --top-k 5 --pareto --fix n_sm=16
    python -m repro_torch.service.cli build --downsample 4     # pre-warm a store
    python -m repro_torch.service.cli build --gpu titanx       # second GPU target
    python -m repro_torch.service.cli ls

LM workloads (op-graph cells over mesh plans; see docs/lm_codesign.md --
area IS the chip count, so --max-area is a chip budget):

    python -m repro_torch.service.cli build --workload lm --chips 256
    python -m repro_torch.service.cli query --workload lm \\
        --freq llama3-8b:decode=1 --max-area 64 --top-k 3

Fleet serving (gateway over every stored artifact; see docs/serving.md):

    python -m repro_torch.service.cli serve --port 8932
    python -m repro_torch.service.cli query --url http://127.0.0.1:8932 \\
        --gpu titanx --stencil heat2d --max-area 450
    python -m repro_torch.service.cli query --url http://127.0.0.1:8932 \\
        --gpu tpu_v5e --workload lm --freq llama3-8b:decode=1

Fleet portfolios (K designs + heterogeneity-aware routing; see
docs/portfolio.md):

    python -m repro_torch.service.cli portfolio --gpu titanx --k 2 --budget 900
    python -m repro_torch.service.cli route heat2d --gpu titanx
    python -m repro_torch.service.cli route heat2d --url http://127.0.0.1:8932 \\
        --gpu titanx

The store location is ``--store``, else ``$REPRO_STORE``, else
``~/.cache/repro/codesign-store``.

The port, against the JAX package's CLI (same subcommands, flags, output
lines and exit codes otherwise):

* ``--engine`` is ``auto|torch|sharded|numpy`` (``auto``: numpy below 64
  hardware points, else sharded when more than one card is attached, else
  torch). ``"jax"`` remains a digest name only: the port serves and
  re-keys such artifacts, it cannot sweep them.
* ``--device`` (default: the card) is where the torch engine sweeps:
  ``build``, ``query`` on a miss and ``portfolio`` sweep there when the
  resolved engine is torch, and ``portfolio`` scores there; without a card
  and without ``--device cpu`` they exit 2 with one line. A warm store and
  the numpy oracle need no device.
* ``--devices N`` shards the stencil sweep's hardware axis over the first
  N cards (the sharded engine; it promotes ``--engine auto``), as the
  JAX package's ``--devices``; a request for more cards than are attached
  exits 2 with one line.
* ``--portfolio-engine`` is ``torch|numpy`` (default torch, on the card,
  where the JAX package defaults to its numpy oracle: the port's entry
  points run on the card unless asked otherwise; ``numpy`` names the
  float64 oracle).
* ``serve`` creates no tensor: it serves stored artifacts on the host,
  and queries reduce on the host, as in the JAX package.
* ``--workload lm`` builds and queries LM sweeps in process under the same
  ``--engine``/``--device`` rule (``auto``: numpy below 64 mesh points,
  else torch); with ``--url`` the name stays a routing selector.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
import urllib.error

import numpy as np

from .query import QueryRequest
from .server import CodesignServer
from .store import ArtifactStore
from .wire import RemoteError

DEFAULT_STORE = os.environ.get(
    "REPRO_STORE", os.path.join(os.path.expanduser("~"), ".cache", "repro", "codesign-store")
)

def _gpu_names():
    """Buildable GPU targets (paper §IV.B GTX-980 + §V Titan X) -- read
    from THE registry (`timemodel.GPUS_BY_NAME`, a numpy-only import) so
    the CLI knobs can never drift from the families the model knows."""
    from repro_torch.core.timemodel import GPUS_BY_NAME

    return sorted(GPUS_BY_NAME)


def _gpu(name: str):
    from repro_torch.core.timemodel import GPUS_BY_NAME

    try:
        return GPUS_BY_NAME[name]
    except KeyError:
        # reached only on in-process paths: with --url the name is a
        # routing selector and never resolves to constants here
        raise _die(
            f"unknown GPU target {name!r} (in-process builds support "
            f"{_gpu_names()}; calibrated names like 'gtx980-cal' route "
            "only through a gateway, via --url)"
        ) from None


def _die(message: str) -> "SystemExit":
    """Clear one-line failure on stderr, exit status 2 -- never a
    traceback (the CI smoke lane asserts this)."""
    print(f"error: {message}", file=sys.stderr)
    return SystemExit(2)


def _device(name):
    """``--device`` resolved by the port's rule: the card unless a device
    was named; without a card, a one-line failure (exit 2)."""
    from repro_torch._device import resolve_device

    try:
        return resolve_device(name)
    except RuntimeError:
        raise _die("no CUDA device is available; pass --device cpu to run on the CPU") from None


def _add_server_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--store", default=DEFAULT_STORE, help="artifact store directory")
    p.add_argument("--gpu", default=None,
                   help=f"GPU target constants, one of {_gpu_names()} "
                        "(default gtx980); with --workload lm, the accelerator "
                        "name stamped on the artifact (default tpu_v5e); with "
                        "--url, the routing selector instead -- any served "
                        "name, incl. calibrated ones like 'gtx980-cal'")
    p.add_argument("--workload", default=None, metavar="FAMILY",
                   help="cell family to build/query: 'lm' sweeps LM op-graph "
                        "cells over mesh plans (docs/lm_codesign.md); default "
                        "is the paper's stencil workload. With --url, the "
                        "workload-name routing selector")
    p.add_argument("--arch", action="append", metavar="NAME",
                   help="with --workload lm: model config to include, e.g. "
                        "llama3-8b (repeatable; default llama3-8b + "
                        "mixtral-8x22b)")
    p.add_argument("--chips", type=int, default=512,
                   help="with --workload lm: chip budget bounding the mesh "
                        "factorization space (default 512, the smallest "
                        "budget where every default cell fits)")
    p.add_argument("--max-hw-area", type=float, default=650.0,
                   help="hardware-space enumeration budget (mm^2)")
    p.add_argument("--downsample", type=int, default=1,
                   help="keep every Nth hardware point (quick demos)")
    p.add_argument("--engine", choices=("auto", "torch", "sharded", "numpy"), default="auto",
                   help="sweep engine of a build (auto: numpy below 64 "
                        "hardware points, else sharded on more than one card, "
                        "else torch)")
    p.add_argument("--device", default=None,
                   help="torch device a build sweeps on (default: the card; "
                        "'cpu' runs on the CPU)")
    p.add_argument("--devices", type=int, default=None,
                   help="sharded engine: first N attached cards (default: all)")


def _server(args):
    """In-process server for the requested cell family (the --url path
    never gets here; there the flags become routing selectors)."""
    if args.workload is not None and args.workload != "lm":
        raise _die(
            f"in-process --workload supports 'lm' (got {args.workload!r}); "
            "other workload names are routing selectors for --url queries"
        )
    if args.workload != "lm" and (args.arch or args.chips != 512):
        raise _die("--arch/--chips only apply to --workload lm")
    if args.workload == "lm":
        from repro_torch.core.lmcells import LM_GPU_NAME, lm_workload

        if args.devices is not None or args.engine == "sharded":
            raise _die("--devices and --engine sharded apply to the stencil sweep; "
                       "an LM build runs on --device")

        from .server import LMServer

        kw = {}
        if args.arch:
            kw["workload"] = lm_workload(archs=tuple(args.arch))
        return LMServer(
            ArtifactStore(args.store),
            max_chips=args.chips,
            downsample=args.downsample,
            engine=args.engine,
            gpu_name=args.gpu or LM_GPU_NAME,
            batch_window=0.0,
            **kw,
        )
    try:
        return CodesignServer(
            ArtifactStore(args.store),
            gpu=_gpu(args.gpu or "gtx980"),
            max_area=args.max_hw_area,
            downsample=args.downsample,
            engine=args.engine,
            devices=args.devices,
            batch_window=0.0,  # CLI is single-threaded; no rendezvous needed
        )
    except ValueError as e:  # --devices with a non-sharded --engine
        raise _die(str(e)) from None


def _ready(args):
    """:func:`_server`, with ``--device`` resolved only when its miss path
    will sweep on torch (and ``--devices`` checked when it will shard): a
    warm store and the numpy oracle need no device."""
    from repro_torch.core.codesign import _resolve_engine
    from repro_torch.core.lmcells import resolve_lm_engine
    from repro_torch.core.sweep import _resolve_devices

    srv = _server(args)
    if srv.warm:
        return srv
    resolve = resolve_lm_engine if args.workload == "lm" else _resolve_engine
    engine = resolve(srv.engine, len(srv.hw))
    if engine == "torch":
        srv.device = _device(args.device)
    elif engine == "sharded":
        try:
            _resolve_devices(srv.devices)
        except (RuntimeError, ValueError) as e:
            raise _die(f"{e}: the sharded engine shards over cards") from None
    return srv


def _freqs(args):
    freqs = {}
    for name in args.stencil or []:
        freqs[name] = freqs.get(name, 0.0) + 1.0
    for spec in args.freq or []:
        name, _, w = spec.partition("=")
        if not w:
            raise SystemExit(f"--freq wants name=weight, got {spec!r}")
        freqs[name] = freqs.get(name, 0.0) + float(w)
    return freqs or None


def _fix(args):
    fix = {}
    for spec in args.fix or []:
        name, _, v = spec.partition("=")
        if not v:
            raise SystemExit(f"--fix wants param=value, got {spec!r}")
        fix[name] = float(v)
    return fix or None


def _print_response(resp, out, total_hw=None) -> None:
    """Shared human-readable rendering for the in-process and --url paths
    (same QueryResponse object either way)."""
    b = out["best"]
    if resp.best_index < 0:
        print("no design satisfies the requested constraints "
              "(budget/fix select an empty subspace)")
        return
    if "n_sm" in b:  # stencil sweeps keep the paper's design-point layout
        print(f"best:  n_SM={b['n_sm']:3d} n_V={b['n_v']:4d} M_SM={b['m_sm']:4.0f}kB "
              f"area={b['area']:6.1f}mm^2  {b['gflops']:8.1f} GFLOP/s")
        for r in resp.top_k[1:]:
            print(f"       n_SM={r['n_sm']:3d} n_V={r['n_v']:4d} M_SM={r['m_sm']:4.0f}kB "
                  f"area={r['area']:6.1f}mm^2  {r['gflops']:8.1f} GFLOP/s")
    else:  # generic design points (LM: pod/data/model/chips)
        def _row(point):
            pairs = " ".join(
                f"{k}={point[k]:g}" for k in point
                if k not in ("index", "gflops", "weighted_time")
            )
            return f"{pairs}  {point['gflops']:10.1f} GFLOP/s"

        print(f"best:  {_row({**resp.best_point, 'gflops': b['gflops']})}")
        for r in resp.top_k[1:]:
            print(f"       {_row(r)}")
    if "pareto" in out:
        of = f" of {total_hw}" if total_hw else ""
        print(f"pareto front: {out['pareto']['count']}{of} designs")
    if "what_if" in out:
        w = out["what_if"]
        print(f"what-if delta vs unrestricted best: {w['delta_gflops']:+.1f} GFLOP/s")


def _load_batch_file(path: str):
    """A --batch-file is a JSON array of ``{"artifact"?, "route"?,
    "request"}`` objects (the /v1/query_many elements, verbatim)."""
    try:
        with open(path) as f:
            items = json.load(f)
    except (OSError, json.JSONDecodeError) as e:
        raise _die(f"cannot read batch file {path!r}: {e}")
    if not isinstance(items, list) or not items:
        raise _die(f"batch file {path!r} must hold a non-empty JSON array")
    triples = []
    for i, obj in enumerate(items):
        if not isinstance(obj, dict) or "request" not in obj:
            raise _die(f"batch file entry {i} must be an object with a 'request'")
        try:
            triples.append(
                (QueryRequest(**obj["request"]), obj.get("artifact"), obj.get("route"))
            )
        except TypeError as e:
            raise _die(f"batch file entry {i}: {e}")
    return triples


def cmd_query_batch(args) -> None:
    """One /v1/query_many round trip; per-query results (answers or
    structured errors) print as a JSON array in input order."""
    from .client import GatewayClient

    if not args.url:
        raise _die("--batch-file requires --url (the batched endpoint is "
                   "a gateway feature)")
    # the batch file is the whole question: silently ignoring query-shaping
    # flags would run different constraints than the user typed
    superseded = {
        "--stencil": args.stencil, "--freq": args.freq, "--fix": args.fix,
        "--artifact": args.artifact, "--gpu": args.gpu,
        "--workload": args.workload, "--arch": args.arch,
        "--pareto": args.pareto or None,
        "--max-area": None if args.max_area == np.inf else args.max_area,
        "--min-area": args.min_area or None,
        "--top-k": None if args.top_k == 1 else args.top_k,
    }
    clashing = sorted(flag for flag, v in superseded.items() if v)
    if clashing:
        raise _die(
            f"{', '.join(clashing)} cannot be combined with --batch-file; "
            "put the constraints in each batch entry's 'request' instead"
        )
    triples = _load_batch_file(args.batch_file)
    client = GatewayClient(args.url)
    t0 = time.perf_counter()
    try:
        results = client.query_many(triples)
    except RemoteError as e:
        raise _die(f"gateway refused the batch: {e}")
    except urllib.error.URLError as e:
        raise _die(f"cannot reach gateway at {args.url}: {e.reason}")
    dt = time.perf_counter() - t0
    out = []
    for r in results:
        if isinstance(r, RemoteError):
            out.append({"ok": False,
                        "error": {"code": r.code, "message": r.message}})
        else:
            feasible = r.best_index >= 0
            out.append({
                "ok": True,
                "artifact_key": r.artifact_key,
                "feasible": feasible,
                "best": {**r.best_point, "index": r.best_index,
                         "gflops": r.best_gflops} if feasible else None,
                "top_k": r.top_k,
            })
    json.dump({"batch_s": round(dt, 4), "results": out}, sys.stdout,
              indent=1, default=float)
    sys.stdout.write("\n")


def cmd_query(args) -> None:
    if args.batch_file:
        cmd_query_batch(args)
        return
    req = QueryRequest(
        freqs=_freqs(args),
        max_area=args.max_area,
        min_area=args.min_area,
        top_k=args.top_k,
        pareto=args.pareto,
        fix=_fix(args),
    )
    total_hw = None
    if args.url:
        from .client import GatewayClient

        client = GatewayClient(args.url)
        route = None
        if args.artifact is None:
            route = {}
            if args.gpu is not None:
                route["gpu"] = args.gpu
            if args.workload is not None:
                route["workload"] = args.workload
            route = route or None
        t0 = time.perf_counter()
        try:
            resp = client.query(req, artifact=args.artifact, route=route)
        except RemoteError as e:
            raise _die(f"gateway refused the query: {e}")
        except urllib.error.URLError as e:
            raise _die(f"cannot reach gateway at {args.url}: {e.reason}")
        dt = time.perf_counter() - t0
        origin = f"via {args.url}"
    else:
        if args.artifact:
            raise _die("--artifact only applies to --url (gateway) queries")
        srv = _ready(args)
        origin = "warm" if srv.warm else "cold build"
        total_hw = len(srv.hw)
        t0 = time.perf_counter()
        resp = srv.query(req)
        dt = time.perf_counter() - t0
    feasible = resp.best_index >= 0
    out = {
        "artifact_key": resp.artifact_key,
        "origin": origin,
        "query_s": round(dt, 4),
        "feasible": feasible,
        "best": {**resp.best_point, "index": resp.best_index,
                 "gflops": resp.best_gflops,
                 "weighted_time_s": resp.best_weighted_time} if feasible else None,
        "top_k": resp.top_k,
    }
    if resp.pareto_indices is not None:
        out["pareto"] = {
            "count": int(resp.pareto_indices.size),
            "indices": [int(i) for i in resp.pareto_indices],
        }
    if resp.baseline_best_index is not None:
        out["what_if"] = {
            "baseline_best_index": resp.baseline_best_index,
            "baseline_best_gflops": resp.baseline_best_gflops,
            "delta_gflops": resp.best_gflops - resp.baseline_best_gflops,
        }
    if args.json:
        json.dump(out, f := sys.stdout, indent=1, default=float)
        f.write("\n")
        return
    print(f"artifact {resp.artifact_key} ({origin}), query {dt*1e3:.1f} ms")
    _print_response(resp, out, total_hw)


def cmd_build(args) -> None:
    from .errors import GatewayError

    srv = _ready(args)
    t0 = time.perf_counter()
    try:
        srv.ensure_artifact()
    except GatewayError as e:
        # structured serving-layer failures (e.g. build_lock_timeout when
        # another process holds the build flock past REPRO_LOCK_TIMEOUT_S):
        # one line + exit 2, never a traceback
        raise _die(f"{e.code}: {e}")
    gpu_name = srv.gpu_name if hasattr(srv, "gpu_name") else srv.gpu.name
    print(f"artifact {srv.key}: "
          f"{'already stored' if srv.stats['artifact_loads'] else 'built'} "
          f"({time.perf_counter()-t0:.1f}s, {len(srv.hw)} hw points, "
          f"{len(srv.workload.cells)} cells, gpu={gpu_name})")


def cmd_portfolio(args) -> None:
    """Optimize + persist a K-design fleet portfolio over a sweep
    artifact, building the sweep first on miss (docs/portfolio.md)."""
    from .errors import GatewayError
    from .portfolio import build_portfolio

    srv = _ready(args)
    device = _device(args.device) if args.portfolio_engine == "torch" else None
    try:
        srv.ensure_artifact()
    except GatewayError as e:
        raise _die(f"{e.code}: {e}")
    store = ArtifactStore(args.store)
    known = set(store.keys())
    t0 = time.perf_counter()
    try:
        art, result = build_portfolio(
            store, srv.key, args.k, args.budget,
            objective=args.objective, engine=args.portfolio_engine,
            device=device,
        )
    except ValueError as e:
        raise _die(str(e))
    members = ",".join(str(m) for m in result.members)
    print(f"portfolio {art.key}: "
          f"{'already stored' if art.key in known else 'built'} "
          f"({time.perf_counter()-t0:.1f}s, k={result.k} "
          f"objective={result.objective} budget={result.budget:g} "
          f"members=[{members}] fleet={result.fleet_gflops:.1f} GFLOP/s "
          f"area={result.total_area:.1f})")


def cmd_route(args) -> None:
    """Route one workload cell-group through a stored portfolio (over
    HTTP with --url, else in-process through a Gateway)."""
    from .portfolio import RouteRequest

    req = RouteRequest(cell=args.cell)
    selector = {}
    if args.gpu is not None:
        selector["gpu"] = args.gpu
    if args.workload is not None:
        selector["workload"] = args.workload
    route = (selector or None) if args.artifact is None else None
    if args.url:
        from .client import GatewayClient

        client = GatewayClient(args.url)
        try:
            resp = client.route(req, artifact=args.artifact, route=route)
        except RemoteError as e:
            raise _die(f"gateway refused the route: {e}")
        except urllib.error.URLError as e:
            raise _die(f"cannot reach gateway at {args.url}: {e.reason}")
        origin = f"via {args.url}"
    else:
        from .errors import GatewayError
        from .gateway import Gateway

        try:
            gw = Gateway([args.store], batch_window=0.0)
        except FileNotFoundError as e:
            raise _die(str(e))
        try:
            resp = gw.route(req, artifact=args.artifact, route=route)
        except GatewayError as e:
            raise _die(f"{e.code}: {e}")
        origin = "in-process"
    out = {
        "portfolio_key": resp.portfolio_key,
        "sweep_key": resp.sweep_key,
        "cell": resp.cell,
        "member_slot": resp.member_slot,
        "hw_index": resp.hw_index,
        "point": resp.point,
        "time_s": resp.time_s,
        "gflops": resp.gflops,
        "degraded": resp.degraded,
        "fallback_from": list(resp.fallback_from),
    }
    if args.json:
        json.dump(out, sys.stdout, indent=1, default=float)
        sys.stdout.write("\n")
        return
    point = " ".join(f"{k}={v:g}" for k, v in resp.point.items() if k != "index")
    flag = (f"  [degraded: fell back from hw {list(resp.fallback_from)}]"
            if resp.degraded else "")
    print(f"portfolio {resp.portfolio_key} ({origin})")
    print(f"{resp.cell} -> member {resp.member_slot} (hw {resp.hw_index}): "
          f"{point}  {resp.gflops:.1f} GFLOP/s{flag}")


def cmd_ls(args) -> None:
    store = ArtifactStore(args.store)
    rows = store.entries()
    if not rows:
        print(f"(no artifacts under {store.root})")
        return
    for r in rows:
        kind = r.get("kind", "sweep")
        if kind != "sweep":
            print(f"{r['key']}  v{r['format_version']}  kind={kind}  "
                  + " ".join(f"{k}={v}" for k, v in sorted(r.items())
                             if k not in ("key", "format_version", "kind")))
            continue
        if r.get("family", "stencil") == "lm":
            groups = ",".join(r.get("models") or []) or "?"
            ops = ",".join(r.get("ops") or [])
            print(f"{r['key']}  v{r['format_version']}  {r['workload']:16s} "
                  f"gpu={r['gpu']:8s} {r['cells']:4d} cells x {r['hw']:6d} hw  "
                  f"engine={r['engine']}  lm[{groups}: {ops}]")
            continue
        print(f"{r['key']}  v{r['format_version']}  {r['workload']:16s} "
              f"gpu={r['gpu']:8s} {r['cells']:4d} cells x {r['hw']:6d} hw  "
              f"engine={r['engine']}  [{','.join(r['stencils'])}]")


def cmd_upgrade(args) -> None:
    """Backfill routing blocks / kind tags on manifests written by older
    writers (pre-gateway). Content keys never move (the key hashes the
    question spec, not the manifest bytes)."""
    roots = [args.store] + (args.root or [])
    total = stored = 0
    for root in roots:
        try:
            store = ArtifactStore(root, create=False)
        except FileNotFoundError as e:
            raise _die(str(e))
        upgraded = store.upgrade_manifests()
        total += len(upgraded)
        stored += len(store.keys())
        for key in upgraded:
            print(f"upgraded {key}  ({root})")
    print(f"{total} manifest(s) upgraded, {stored} total")


def cmd_gc(args) -> None:
    """Kind-aware artifact retention over store root(s): the default
    (``--dry-run``) prints the deterministic eviction plan as canonical
    JSON; ``--apply`` executes it via :meth:`ArtifactStore.delete`.
    Telemetry snapshots age out first; a sweep referenced by a stored
    portfolio member is never evicted (docs/serving.md)."""
    from .usage import UsageLedger, retention_plan

    roots = [args.store] + (args.root or [])
    out = []
    for root in roots:
        try:
            store = ArtifactStore(root, create=False)
        except FileNotFoundError as e:
            raise _die(str(e))
        # routing rows don't carry payload fields; decorate the two kinds
        # whose plan inputs live there (telemetry age, portfolio member)
        entries = []
        for row in store.entries():
            kind = row.get("kind", "sweep")
            if kind in ("telemetry", "portfolio"):
                art = store.get(row["key"])
                if art is not None:
                    if kind == "telemetry":
                        row = {**row,
                               "collected_at": art.payload.get("collected_at")}
                    else:
                        row = {**row, "sweep_key": art.payload.get("sweep_key")}
            entries.append(row)
        try:
            plan = retention_plan(
                entries,
                UsageLedger(root).snapshot(),
                telemetry_cap=args.telemetry_cap,
                max_artifacts=args.max_artifacts,
            )
        except ValueError as e:
            raise _die(str(e))
        deleted = []
        if args.apply:
            for e in plan["evict"]:
                if store.delete(e["key"]):
                    deleted.append(e["key"])
        out.append({"root": store.root, "plan": plan,
                    "applied": bool(args.apply), "deleted": deleted})
    json.dump(out, sys.stdout, indent=1, sort_keys=True)
    sys.stdout.write("\n")


def cmd_serve(args) -> None:
    """Run the fleet gateway over every artifact under the store root(s).

    Exits 2 with a one-line message (no traceback) when a root is missing
    or holds no artifacts -- a gateway with nothing to serve is a
    misconfiguration, not a valid idle state."""
    from repro_torch.obs import configure_logging

    from .gateway import Gateway, serve_http

    # default quiet: WARNING keeps per-request access lines (DEBUG) and
    # lifecycle notes (INFO) off the console the smoke lane parses
    configure_logging(args.log_level)

    # the default store joins the root list only when no root was named
    # explicitly: `serve --root /data/fleet` must not die because the
    # default cache dir was never created on this host
    roots = ([args.store] if args.store else []) + (args.root or [])
    if not roots:
        roots = [DEFAULT_STORE]
    if args.no_resilience:
        resilience = None
    else:
        from .resilience import GatewayResilience

        resilience = GatewayResilience(
            global_rate=args.rate_limit,
            client_rate=args.client_rate_limit,
            max_inflight=args.max_inflight,
            breaker_threshold=args.breaker_threshold,
            breaker_cooldown_s=args.breaker_cooldown,
        )
    try:
        gw = Gateway(
            roots,
            pool_size=args.pool_size,
            batch_window=args.batch_window,
            telemetry_interval=args.telemetry_interval,
            resilience=resilience,
            usage_flush_interval=args.usage_flush_interval,
            telemetry_cap=args.telemetry_cap,
        )
    except FileNotFoundError as e:
        raise _die(str(e))
    if len(gw) == 0:
        raise _die(
            f"no artifacts under {', '.join(roots)}; build one first: "
            "python -m repro_torch.service.cli build --store <root>"
        )
    httpd = serve_http(gw, host=args.host, port=args.port)
    host, port = httpd.server_address[:2]
    print(f"gateway: {len(gw)} artifact(s) from {len(roots)} store root(s)")
    for row in gw.entries():
        if row.get("kind", "sweep") != "sweep":
            print(f"  {row['key']}  kind={row['kind']}  "
                  f"gpu={row.get('gpu', '?')}")
            continue
        cells = row.get("stencils") or row.get("models") or []
        print(f"  {row['key']}  gpu={row['gpu']}  {row['cells']}x{row['hw']}  "
              f"[{','.join(cells)}]")
    # machine-parseable last line: the smoke lane reads the bound port here
    print(f"serving on http://{host}:{port}", flush=True)
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        gw.flush_usage()  # buffered ledger deltas survive the shutdown
        httpd.server_close()


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(
        prog="repro_torch.service.cli", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    sub = ap.add_subparsers(dest="cmd", required=True)

    q = sub.add_parser("query", help="answer a codesign query (sweeps on first miss)")
    _add_server_args(q)
    q.add_argument("--url", default=None, metavar="URL",
                   help="query a running gateway over HTTP instead of "
                        "in-process (e.g. http://127.0.0.1:8932)")
    q.add_argument("--artifact", default=None, metavar="KEY",
                   help="with --url: pin the artifact content key to query")
    q.add_argument("--batch-file", default=None, metavar="FILE",
                   help="with --url: JSON array of {artifact?, route?, request} "
                        "objects sent as ONE /v1/query_many round trip")
    q.add_argument("--stencil", action="append",
                   help="cell group to weight 1.0 (repeatable): a stencil "
                        "name, or for LM artifacts a model, op, or model:op")
    q.add_argument("--freq", action="append", metavar="NAME=W",
                   help="explicit cell-group weight (repeatable)")
    q.add_argument("--max-area", type=float, default=np.inf,
                   help="area budget for the answer (mm^2; for LM sweeps "
                        "area IS the chip count, so this is a chip budget)")
    q.add_argument("--min-area", type=float, default=0.0)
    q.add_argument("--top-k", type=int, default=1)
    q.add_argument("--pareto", action="store_true", help="include the Pareto front")
    q.add_argument("--fix", action="append", metavar="PARAM=VALUE",
                   help="what-if subspace, e.g. n_sm=16 (repeatable)")
    q.add_argument("--json", action="store_true", help="machine-readable output")
    q.set_defaults(fn=cmd_query)

    b = sub.add_parser("build", help="pre-warm the default paper-workload artifact")
    _add_server_args(b)
    b.set_defaults(fn=cmd_build)

    pf = sub.add_parser(
        "portfolio",
        help="optimize + persist a K-design fleet portfolio over a sweep "
             "(docs/portfolio.md)",
    )
    _add_server_args(pf)
    pf.add_argument("--k", type=int, default=2,
                    help="max designs in the fleet (sizes 1..K are "
                         "searched; default %(default)s)")
    pf.add_argument("--budget", type=float, required=True,
                    help="total fleet area budget summed over the chosen "
                         "members (mm^2; chips for LM sweeps)")
    pf.add_argument("--objective", choices=("density", "throughput"),
                    default="density",
                    help="density = fleet GFLOP/s per mm^2 of member area "
                         "(default); throughput = fleet GFLOP/s (K=1 "
                         "reproduces the single-design optimum exactly)")
    pf.add_argument("--portfolio-engine", choices=("torch", "numpy"),
                    default="torch",
                    help="subset-scoring engine (default torch: the fused "
                         "float64 scorer on --device; numpy is the oracle)")
    pf.set_defaults(fn=cmd_portfolio)

    rt = sub.add_parser(
        "route",
        help="route a workload cell-group through a stored portfolio",
    )
    rt.add_argument("cell",
                    help="cell-group label: a stencil name, or model:op "
                         "for LM sweeps")
    rt.add_argument("--store", default=DEFAULT_STORE)
    rt.add_argument("--url", default=None, metavar="URL",
                    help="route through a running gateway over HTTP "
                         "instead of in-process")
    rt.add_argument("--artifact", default=None, metavar="KEY",
                    help="pin the portfolio content key to route through")
    rt.add_argument("--gpu", default=None,
                    help="routing selector matching the portfolio's "
                         "inherited gpu tag")
    rt.add_argument("--workload", default=None,
                    help="routing selector matching the portfolio's "
                         "inherited workload tag")
    rt.add_argument("--json", action="store_true",
                    help="machine-readable output")
    rt.set_defaults(fn=cmd_route)

    ls = sub.add_parser("ls", help="list stored artifacts")
    ls.add_argument("--store", default=DEFAULT_STORE)
    ls.set_defaults(fn=cmd_ls)

    up = sub.add_parser(
        "upgrade",
        help="backfill routing/kind on manifests from older writers "
             "(content keys unchanged)",
    )
    up.add_argument("--store", default=DEFAULT_STORE)
    up.add_argument("--root", action="append", metavar="DIR",
                    help="additional store root (repeatable)")
    up.set_defaults(fn=cmd_upgrade)

    s = sub.add_parser(
        "serve", help="HTTP gateway over every stored artifact (docs/serving.md)"
    )
    s.add_argument("--store", default=None,
                   help=f"artifact store directory (default {DEFAULT_STORE} "
                        "unless --root is given)")
    s.add_argument("--root", action="append", metavar="DIR",
                   help="additional store root (repeatable)")
    s.add_argument("--host", default="127.0.0.1")
    s.add_argument("--port", type=int, default=8932,
                   help="TCP port (0 picks a free one and prints it)")
    s.add_argument("--pool-size", type=int, default=8,
                   help="max resident per-artifact servers (LRU beyond)")
    s.add_argument("--batch-window", type=float, default=0.002,
                   help="per-artifact microbatch rendezvous window, seconds")
    s.add_argument("--log-level", default="warning",
                   choices=("debug", "info", "warning", "error"),
                   help="structured-log verbosity on stderr (JSON lines; "
                        "debug includes per-request access logs; default "
                        "warning = quiet)")
    s.add_argument("--rate-limit", type=float, default=0.0, metavar="QPS",
                   help="global admission rate for the query routes in "
                        "requests/s (0 = unlimited); over-budget requests "
                        "get HTTP 429 + Retry-After")
    s.add_argument("--client-rate-limit", type=float, default=0.0,
                   metavar="QPS",
                   help="per-client admission rate (clients keyed by the "
                        "X-Repro-Client header, else remote address; "
                        "0 = unlimited)")
    s.add_argument("--max-inflight", type=int, default=128, metavar="N",
                   help="shed watermark: concurrent query requests beyond "
                        "this get HTTP 503 code=shed (0 = unlimited; "
                        "default %(default)s)")
    s.add_argument("--breaker-threshold", type=int, default=5, metavar="N",
                   help="consecutive raw failures that open a per-artifact "
                        "circuit breaker (default %(default)s)")
    s.add_argument("--breaker-cooldown", type=float, default=30.0,
                   metavar="SECONDS",
                   help="open-circuit cooldown before a half-open probe "
                        "(default %(default)s)")
    s.add_argument("--no-resilience", action="store_true",
                   help="disable admission control and circuit breakers "
                        "entirely (deadlines still apply)")
    s.add_argument("--telemetry-interval", type=float, default=0.0,
                   help="seconds between persisted per-artifact telemetry "
                        "snapshots (kind: 'telemetry' store artifacts; "
                        "0 = off, the default)")
    s.add_argument("--telemetry-cap", type=int, default=32, metavar="N",
                   help="retained telemetry snapshots per store root; older "
                        "ones are pruned after each persist (default "
                        "%(default)s)")
    s.add_argument("--usage-flush-interval", type=float, default=60.0,
                   metavar="SECONDS",
                   help="seconds between usage-ledger flushes to the "
                        ".usage-ledger.json beside each store root "
                        "(default %(default)s)")
    s.set_defaults(fn=cmd_serve)

    g = sub.add_parser(
        "gc",
        help="plan / apply kind-aware artifact retention over a store "
             "(docs/serving.md)",
    )
    g.add_argument("--store", default=DEFAULT_STORE)
    g.add_argument("--root", action="append", metavar="DIR",
                   help="additional store root (repeatable)")
    mx = g.add_mutually_exclusive_group()
    mx.add_argument("--dry-run", action="store_true",
                    help="print the eviction plan without deleting "
                         "(the default)")
    mx.add_argument("--apply", action="store_true",
                    help="execute the plan (deletes artifacts)")
    g.add_argument("--telemetry-cap", type=int, default=32, metavar="N",
                   help="retained telemetry snapshots per root, newest "
                        "first (default %(default)s)")
    g.add_argument("--max-artifacts", type=int, default=None, metavar="N",
                   help="optional total cap per root: evict the coldest "
                        "unprotected artifacts beyond it (ledger hits, "
                        "then last access, then kind)")
    g.set_defaults(fn=cmd_gc)

    args = ap.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
