"""Command-line front end for the measure -> fit -> build loop, on the card.

    # 1. time the K1/K2 tile kernels over a measurement grid on the card
    #    and persist the timings as a `kind: "measurement"` artifact
    python -m repro_torch.measure.cli run --store /tmp/fleet --full

    # 2. refit the time model's machine parameters from a measurement run
    #    (or --synthetic: model-generated timings, the recovery check),
    #    persist as `kind: "calibration"`
    python -m repro_torch.measure.cli fit --store /tmp/fleet --measurement <KEY>

    # 3. sweep the CALIBRATED hardware description on the card and store it
    python -m repro_torch.measure.cli build --store /tmp/fleet --calibration <KEY>

Every subcommand runs on the card unless ``--device cpu`` is given; without
a card it fails rather than running on the CPU. The store is
:class:`repro_torch.service.store.ArtifactStore`, whose on-disk format is
the JAX package's: either package's ``measure.cli`` can fit the other's
measurement, and :func:`repro_torch.service.server_from_artifact` (or the
JAX package's gateway) serves the calibrated sweep. The walkthrough of the
loop is ``docs/calibration.md``.

The store location is ``--store``, else ``$REPRO_STORE``, else
``~/.cache/repro/codesign-store``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Optional

from repro_torch.service.store import Artifact, ArtifactStore

DEFAULT_STORE = os.environ.get(
    "REPRO_STORE", os.path.join(os.path.expanduser("~"), ".cache", "repro", "codesign-store")
)


def _gpu_names():
    """GPU families whose constants frame a fit or a build, read from the
    registry (`timemodel.GPUS_BY_NAME`) so the knobs cannot drift from the
    families the model knows."""
    from repro_torch.core.timemodel import GPUS_BY_NAME

    return sorted(GPUS_BY_NAME)


def _gpu(name: str):
    from repro_torch.core.timemodel import GPUS_BY_NAME

    try:
        return GPUS_BY_NAME[name]
    except KeyError:
        raise _die(
            f"unknown GPU target {name!r} (known: {_gpu_names()})"
        ) from None


def _die(message: str) -> "SystemExit":
    """Clear one-line failure on stderr, exit status 2 -- never a
    traceback."""
    print(f"error: {message}", file=sys.stderr)
    return SystemExit(2)


def _device(name: Optional[str]):
    """``--device`` resolved by the port's rule: the card unless a device
    was named; without a card, a one-line failure (exit 2)."""
    from repro_torch._device import resolve_device

    try:
        return resolve_device(name)
    except RuntimeError:
        raise _die("no CUDA device is available; pass --device cpu to run on the CPU") from None


def _latest(store: ArtifactStore, kind: str) -> Optional[Artifact]:
    """Most recently written artifact of a kind: stat mtimes first, then
    parse manifests newest-first and stop at the first match (a fleet
    store holds hundreds of sweeps whose manifests we must not parse just
    to pick the newest measurement)."""

    def mtime(key: str) -> float:
        try:
            return os.path.getmtime(os.path.join(store.root, key, "manifest.json"))
        except OSError:
            return -1.0

    for key in sorted(store.keys(), key=mtime, reverse=True):
        art = store.get(key)
        if art is not None and art.kind == kind:
            return art
    return None


def _resolve(store: ArtifactStore, key: Optional[str], kind: str) -> Artifact:
    if key:
        art = store.get(key)
        if art is None:
            raise _die(f"no artifact {key!r} under {store.root}")
        if art.kind != kind:
            raise _die(f"artifact {key} is kind={art.kind!r}, expected {kind!r}")
        return art
    art = _latest(store, kind)
    if art is None:
        raise _die(
            f"no {kind} artifact under {store.root}; run "
            f"`python -m repro_torch.measure.cli "
            f"{'run' if kind == 'measurement' else 'fit'}` first"
        )
    return art


def cmd_run(args) -> None:
    from .harness import default_grid, measure_grid

    device = _device(args.device)
    store = ArtifactStore(args.store)
    gpu = _gpu(args.gpu)
    grid = default_grid(smoke=not args.full, gpu=gpu)
    t0 = time.perf_counter()
    run = measure_grid(
        grid, warmup=args.warmup, repeats=args.repeats, gpu=gpu, note=args.note,
        device=device,
    )
    dt = time.perf_counter() - t0
    art = store.put_json(
        "measurement",
        run.to_payload(),
        routing={
            "gpu": gpu.name,
            "stencils": sorted(run.stencil_names()),
            "backend": run.backend,
            "interpret": run.interpret,
            "records": len(run.records),
        },
    )
    print(
        f"measurement {art.key}: {len(run.records)} records "
        f"({dt:.1f}s, backend={run.backend}, interpret={run.interpret}, "
        f"gpu frame={gpu.name})"
    )


def cmd_fit(args) -> None:
    import dataclasses

    from repro_torch.core.timemodel import STENCILS, with_c_iter, with_machine_params

    from .calibrate import CalibrationResult, fit_machine_params, synthetic_records
    from .harness import MeasurementRun

    device = _device(args.device)
    store = ArtifactStore(args.store)
    extra = {}
    if args.synthetic:
        gpu0 = _gpu(args.gpu or "gtx980")
        # generate from a machine --perturb away from the datasheet start:
        # the fit must travel back to it (recovery, not mere stability).
        # Bandwidth is perturbed DOWN: a slower-than-datasheet memory
        # system binds (t_mem wins the max) on part of the grid, keeping
        # bw identifiable -- a faster one can stop binding anywhere, and
        # an unidentifiable parameter has no recovery to assert.
        p = float(args.perturb)
        truth_gpu = with_machine_params(
            gpu0,
            bw_gmem=gpu0.bw_gmem / (1.0 + p),
            launch_overhead=gpu0.launch_overhead * (1.0 + 0.5 * p),
        )
        truth_st = {
            n: with_c_iter(st, st.c_iter * (1.0 + p * (i + 1) / len(STENCILS)))
            for i, (n, st) in enumerate(STENCILS.items())
        }
        run = synthetic_records(truth_gpu, truth_st, seed=args.seed)
        source = "synthetic"
        extra["synthetic_truth"] = {
            "gpu": dataclasses.asdict(truth_gpu),
            "stencils": {n: dataclasses.asdict(st) for n, st in truth_st.items()},
        }
    else:
        meas = _resolve(store, args.measurement, "measurement")
        run = MeasurementRun.from_payload(meas.payload)
        source = meas.key
        # default to the GPU family the measurement itself was framed
        # against -- fitting a titanx run from the gtx980 datasheet (and
        # routing the calibration as gtx980) must require an explicit ask
        gpu0 = _gpu(args.gpu or run.gpu_name)
    t0 = time.perf_counter()
    cal: CalibrationResult = fit_machine_params(
        run, gpu0=gpu0, iters=args.iters, learning_rate=args.lr, device=device
    )
    dt = time.perf_counter() - t0
    art = store.put_json(
        "calibration",
        cal.to_payload(),
        routing={
            "gpu": gpu0.name,
            "calibrated_gpu": cal.calibrated_gpu().name,
            "measurement": source,
            "stencils": sorted(cal.stencils),
        },
        extra={"fit_seconds": round(dt, 3), **extra},
    )
    print(f"calibration {art.key} (fit {dt:.1f}s on {cal.n_records} records, "
          f"{cal.n_dropped} dropped as model-infeasible; source={source})")
    print(f"  mean sq log residual: {cal.loss_before:.4g} -> {cal.loss_after:.4g}")
    print(f"  bw_gmem: {cal.gpu0.bw_gmem:.3e} -> {cal.gpu.bw_gmem:.3e} B/s")
    print(f"  launch:  {cal.gpu0.launch_overhead:.2e} -> "
          f"{cal.gpu.launch_overhead:.2e} s")
    for name in sorted(cal.stencils):
        print(
            f"  {name:12s} C_iter {cal.stencils[name].c_iter:.3e}  "
            f"|rel err| {cal.errors_before.get(name, float('nan')):7.2%}"
            f" -> {cal.errors_after.get(name, float('nan')):7.2%}"
        )
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump(cal.to_payload(), f, indent=1)
        print(f"  report written to {args.json_out}")


def cmd_build(args) -> None:
    from repro_torch.core.codesign import _resolve_engine, codesign, enumerate_hw_space

    from .calibrate import CalibrationResult

    store = ArtifactStore(args.store)
    cal_art = _resolve(store, args.calibration, "calibration")
    cal = CalibrationResult.from_payload(cal_art.payload)
    workload = cal.calibrated_workload()
    gpu = cal.calibrated_gpu()
    hw = enumerate_hw_space(max_area=args.max_hw_area)
    if args.downsample > 1:
        hw = hw.downsample(args.downsample)
    # the numpy oracle runs on the host; the torch engine needs a device
    device = _device(args.device) if _resolve_engine(args.engine, len(hw)) == "torch" else None
    t0 = time.perf_counter()
    result = codesign(workload, gpu=gpu, hw=hw, engine=args.engine, device=device)
    art = store.put(
        result,
        engine=args.engine,
        routing_extra={"calibration": cal_art.key},
        extra={"calibration": cal_art.key},
    )
    print(
        f"calibrated sweep {art.key}: {len(workload.cells)} cells x "
        f"{len(hw)} hw points on gpu={gpu.name} "
        f"({time.perf_counter()-t0:.1f}s); serve it with "
        f"repro_torch.service.server_from_artifact"
    )


def _add_device(p: argparse.ArgumentParser) -> None:
    p.add_argument("--device", default=None,
                   help="torch device to run on (default: the card; 'cpu' "
                        "only when asked for)")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(
        prog="repro_torch.measure.cli", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    sub = ap.add_subparsers(dest="cmd", required=True)

    r = sub.add_parser("run", help="time the K1/K2 tile kernels over a grid")
    r.add_argument("--store", default=DEFAULT_STORE)
    r.add_argument("--gpu", choices=_gpu_names(), default="gtx980",
                   help="GPU family whose constants frame the fit")
    r.add_argument("--full", action="store_true",
                   help="full grid (default: smoke grid sized for CI)")
    r.add_argument("--warmup", type=int, default=1)
    r.add_argument("--repeats", type=int, default=3)
    r.add_argument("--note", default="")
    _add_device(r)
    r.set_defaults(fn=cmd_run)

    f = sub.add_parser("fit", help="refit machine parameters from a run")
    f.add_argument("--store", default=DEFAULT_STORE)
    f.add_argument("--gpu", choices=_gpu_names(), default=None,
                   help="datasheet family to start the fit from (default: "
                        "the measurement run's own GPU frame)")
    f.add_argument("--measurement", default=None, metavar="KEY",
                   help="measurement artifact (default: most recent)")
    f.add_argument("--synthetic", action="store_true",
                   help="fit model-generated timings instead (recovery check)")
    f.add_argument("--perturb", type=float, default=0.5,
                   help="with --synthetic: relative distance of the "
                        "generating machine from the datasheet start")
    f.add_argument("--seed", type=int, default=0)
    f.add_argument("--iters", type=int, default=1500)
    f.add_argument("--lr", type=float, default=0.05)
    f.add_argument("--json-out", default=None, metavar="FILE",
                   help="also write the calibration payload to FILE")
    _add_device(f)
    f.set_defaults(fn=cmd_fit)

    b = sub.add_parser(
        "build", help="sweep on the calibrated hardware and store the artifact"
    )
    b.add_argument("--store", default=DEFAULT_STORE)
    b.add_argument("--calibration", default=None, metavar="KEY",
                   help="calibration artifact (default: most recent)")
    b.add_argument("--max-hw-area", type=float, default=650.0)
    b.add_argument("--downsample", type=int, default=1)
    b.add_argument("--engine", choices=("auto", "torch", "numpy"), default="auto")
    _add_device(b)
    b.set_defaults(fn=cmd_build)

    args = ap.parse_args(argv)
    args.fn(args)
    sys.stdout.flush()


if __name__ == "__main__":
    main()
