"""Stencil cells: the paper's stencils run by the hand-written tile kernels
at the tiles that the eq.-18 sweep chooses.

Set-up runs the program's codesign sweep of the paper's workload over the
configuration's hardware space (``core.codesign.codesign(..., engine=
"torch")``; the configuration's sizes are the paper's), takes
each cell's tiles at the stock hardware point (``tiles_for``), leaves out a
cell with no feasible tiles there or whose tiles the kernel's window
refuses, draws one float32 grid per extent from the seed, and launches
each stencil's tiles at each pass depth once on a small grid (K1 and K2
take the grid's extent at run time: nothing else is built per shape). The
window runs the cells in an order drawn from the seed, in whole passes
over all of them, while the next pass is expected to end inside
``--seconds``; each run is ``run_tiled`` of the cell's T / divisor steps.
After the window the plain reference recomputes one run of each stencil,
drawn from the seed, from the same grid, and holds every cell's tiles to
the time model at the stock point. Where that run's reference is not
finite everywhere (a stencil that diverges, as laplacian2d does, grows
past float32), the check also compares the stencil's run at the next
lower step count, on the smallest extent that has it, and so on down
until a run whose reference stays finite: each stencil is held to at
least one grid of finite values.
"""

from __future__ import annotations

import contextlib
import gc
import sys
import time
from typing import Dict, List

import numpy as np
import torch

from h100bench.reference import stencils as ref

#: edge of the grid that set-up launches every tile and pass depth on
WARM_EXTENT = 2048


def cells(c: dict, t: dict) -> List[dict]:
    """The configuration's cells of the traffic's stencils: (stencil, extent,
    paper T, steps run)."""
    out = []
    for name in t["stencils"]:
        dims = c["stencils"][name]["dims"]
        for s in c["sz_s"]:
            for tt in c["sz_t"]:
                if tt <= s:
                    out.append({"stencil": name, "s": s, "t": tt, "dims": dims,
                                "steps": tt // c[f"t_divisor_{dims}d"]})
    return out


class Cell:
    def __init__(self, cell: dict, seed: int, device: torch.device):
        self.cell, self.seed, self.device = cell, seed, device
        self.c, self.t = cell["config"], cell["traffic"]

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _grids(self, extents) -> Dict[int, torch.Tensor]:
        """The seed's grids of ``extents``: every extent's grid is drawn,
        in order, and those not asked for are dropped."""
        g = torch.Generator(device=self.device).manual_seed(self.seed)
        out = {}
        for s in sorted(set(self.c["sz_s"])):
            x = torch.rand((s, s), generator=g, device=self.device)
            if s in extents:
                out[s] = x
            del x
        return out

    def setup(self) -> None:
        from repro_torch.core.codesign import codesign, enumerate_hw_space
        from repro_torch.core.timemodel import STENCILS, ProblemSize
        from repro_torch.core.workload import Workload, WorkloadCell
        from repro_torch.kernels.tiled_stencils import (
            _pass_depths,
            check_window,
            normalize_tiles,
            run_tiled,
        )
        from repro_torch.obs.metrics import get_registry

        c = self.c
        hs = c["hw_space"]
        hw = enumerate_hw_space(max_area=c["max_area"], n_sm_range=hs["n_sm"],
                                n_v_range=hs["n_v"], m_sm_range=hs["m_sm"])
        # the paper's workload (all six stencils, uniform frequencies) at
        # the configuration's sizes: paper_workload() at the published ones
        sizes = [(s, tt) for s in c["sz_s"] for tt in c["sz_t"] if tt <= s]
        work = Workload("paper-uniform", tuple(
            WorkloadCell(STENCILS[n], ProblemSize(s1=s, s2=s, t=tt, s3=s if sp["dims"] == 3 else 1),
                         1.0 / (len(c["stencils"]) * len(sizes)))
            for n, sp in c["stencils"].items() for s, tt in sizes))
        before = self._codesign_seconds(get_registry())
        res = codesign(work, hw=hw, engine="torch", device=self.device)
        self.codesign_ms = 1e3 * (self._codesign_seconds(get_registry()) - before)
        stock = [i for i in range(len(hw)) if (hw.n_sm[i], hw.n_v[i], hw.m_sm[i])
                 == (c["stock"]["n_sm"], c["stock"]["n_v"], c["stock"]["m_sm"])]
        if len(stock) != 1:
            raise ValueError(f"the stock point {c['stock']} is not once in the hardware space")
        index = {(wc.stencil.name, wc.size.s1, wc.size.t): ci
                 for ci, wc in enumerate(res.workload.cells)}
        self.run_tiled = run_tiled
        self.mix, self.left_out = [], []
        for cl in cells(c, self.t):
            try:
                tiles = res.tiles_for(index[(cl["stencil"], cl["s"], cl["t"])], stock[0])
                tup = normalize_tiles(tiles)
                for n in set(_pass_depths(cl["steps"], tup[2])):
                    check_window(cl["stencil"], (cl["s"],) * cl["dims"], tup, n)
            except ValueError as e:
                self.left_out.append((cl, str(e)))
                continue
            self.mix.append(dict(cl, tiles=tiles))
        if not self.mix:
            raise ValueError(f"no cell of {self.cell['name']} is runnable: {self.left_out[:2]}")
        self.grids = self._grids({cl["s"] for cl in self.mix})
        small = self.grids[min(self.grids)][:WARM_EXTENT, :WARM_EXTENT].contiguous()
        warm = {(cl["stencil"], tuple(sorted(cl["tiles"].items())), n)
                for cl in self.mix for n in _pass_depths(cl["steps"], cl["tiles"]["t_t"])}
        for name, tiles, n in sorted(warm):  # each stencil's tiles at each pass depth, once
            run_tiled(name, small, n, dict(tiles))
        for x in self.grids.values():  # the allocator's blocks of a run's two live outputs
            outs = [torch.empty_like(x) for _ in range(2)]
            del outs
        del small
        self._sync()
        rng = np.random.default_rng(self.seed)
        self.order = [self.mix[i] for i in rng.permutation(len(self.mix))]
        self.checked = {}  # stencil -> its checked run, then the runs compared where it diverges
        for name in sorted({cl["stencil"] for cl in self.mix}):
            mine = [i for i, cl in enumerate(self.order) if cl["stencil"] == name]
            first = int(rng.choice(mine))
            lower = sorted({self.order[i]["steps"] for i in mine
                            if self.order[i]["steps"] < self.order[first]["steps"]}, reverse=True)
            self.checked[name] = [first] + [
                min((i for i in mine if self.order[i]["steps"] == n),
                    key=lambda i: self.order[i]["s"]) for n in lower]
        self.flops = sum(c["stencils"][cl["stencil"]]["flops_per_point"] * cl["s"] ** cl["dims"]
                         * cl["steps"] for cl in self.mix)

    @staticmethod
    def _codesign_seconds(reg) -> float:
        fam = reg.snapshot()["repro_codesign_seconds"]
        return sum(s["sum"] for s in fam["samples"] if s["labels"].get("family") == "stencil")

    def window(self, seconds: float, spans) -> dict:
        """Whole passes over the mix while the next is expected to end inside
        ``seconds``; useful GFLOP/s over all of them."""
        t0, passes, kept = time.perf_counter(), 0, {}
        checked = {i for runs in self.checked.values() for i in runs}
        self.pass_s = []
        while True:
            for i, cl in enumerate(self.order):
                with spans("run"):
                    out = self.run_tiled(cl["stencil"], self.grids[cl["s"]], cl["steps"],
                                         cl["tiles"])
                if i in checked:
                    kept[i] = out
                del out
            with spans("sync"):
                self._sync()
            passes += 1
            elapsed = time.perf_counter() - t0
            self.pass_s.append(elapsed - sum(self.pass_s))
            if elapsed * (passes + 1) / passes > seconds:
                break
        self.kept = kept
        runs = [(cl["stencil"], cl["s"], cl["dims"], cl["steps"]) for cl in self.order] * passes
        return {"elapsed": elapsed, "attempted": len(runs), "failed": 0,
                "metrics": {"stencil_gflops": passes * self.flops / elapsed / 1e9},
                "record": {"runs": runs, "codesign_ms": self.codesign_ms}}

    def release(self) -> None:
        del self.grids
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def tile_excess(self, dtype=torch.float64) -> float:
        """By the worst cell of the mix: how far the time of its tiles lies
        above the least time over the lattice at the stock point, as a
        share of the least (the tiles ranked first by the model computed in
        ``dtype`` with ``dtype`` other than float64: the control)."""
        c, worst = self.c, 0.0
        for cl in self.mix:
            st = c["stencils"][cl["stencil"]]
            lat = ref.lattice(c[f"lattice_{cl['dims']}d"])
            size = (cl["s"], cl["s"], cl["s"] if cl["dims"] == 3 else 1, cl["t"])
            best, first = ref.best_time(st, c["gpu"], size, c["stock"], lat, dtype)
            tiles = cl["tiles"] if dtype == torch.float64 else first
            one = {n: torch.tensor([float(tiles.get(n, 1))]) for n in lat}
            got = float(ref.stencil_time(st, c["gpu"], size, c["stock"], one)[0])
            worst = max(worst, got / best - 1.0)
        return worst

    def grid_err(self, control: bool = False) -> float:
        """By the worst compared run: its grid against the reference's
        (``control``: the program's bfloat16 path in the program's place).
        Each stencil's checked run is compared, and where its reference
        is not finite everywhere, its runs at lower step counts in turn,
        down to the first whose reference is."""
        runs = [i for r in self.checked.values() for i in r]
        grids, worst = self._grids({self.order[i]["s"] for i in runs}), 0.0
        self.compared = []
        for name in sorted(self.checked):
            for i in self.checked[name]:
                cl = self.order[i]
                x = grids[cl["s"]]
                if control:
                    got = self.run_tiled(name, x.to(torch.bfloat16), cl["steps"], cl["tiles"])
                else:
                    got = self.kept[i]
                want = ref.run(name, x, cl["steps"])
                worst = max(worst, ref.grid_err(got, want))
                finite = bool(torch.isfinite(want).all())
                self.compared.append((name, cl["s"], cl["steps"], finite))
                del got, want
                if finite:
                    break
        self.kept = {}
        print("h100bench: grid_err compared (stencil, extent, steps, reference finite) "
              f"{self.compared}", file=sys.stderr)
        return worst

    def check(self):
        print(f"h100bench: seconds of each pass {self.pass_s}", file=sys.stderr)
        got = {"tile_excess": self.tile_excess(), "grid_err": self.grid_err()}
        return [(k, got[k], self.cell["limits"][k]["limit"]) for k in sorted(got)]

    def readings(self, kind: str) -> dict:
        """The compared numbers of one kind of run on this seed:
        ``program`` (a window of one pass) or ``control`` (the program's
        bfloat16 kernels and the time model in bfloat16)."""
        self.setup()
        if kind == "program":
            self.window(0.0, lambda name: contextlib.nullcontext())
            self.release()
            return {"tile_excess": self.tile_excess(), "grid_err": self.grid_err()}
        self.release()
        return {"tile_excess": self.tile_excess(torch.bfloat16),
                "grid_err": self.grid_err(control=True)}
