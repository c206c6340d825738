"""The port's sharded sweep (``sweep_cells_sharded``) against its own
single-device ``sweep_cells``, and the engine rules of ``codesign``.

The reference's ``tests/test_sweep_sharded.py`` bodies on the port. The
sharded engine evaluates every hardware point with the same float32
broadcast as ``sweep_cells``, so the bar is **bit-identity** -- times and
argmin indices -- for every padding regime (H not divisible by shards x
chunk, H smaller than the shard count, empty H) and every ``devices=``
form. On this CPU host the shards are ``devices=["cpu"] * 8`` (the
counterpart of the reference's eight forced host devices) and explicit
lists; ``devices=1`` names the first card, so here it must refuse. The
sharded result is also held tie-aware (RTOL 1e-5) against the reference's
single-device ``sweep_cells``: the reference's own sharded engine fails
under JAX 0.9.0 whenever ``chunk`` is below the per-device H, so it is no
oracle.
"""

import numpy as np
import pytest

from repro.core import sweep as jsweep
from repro.core.timemodel import MAXWELL_GPU as J_GPU
from repro.core.timemodel import STENCILS as J_STENCILS
from repro_torch.core import MAXWELL, MAXWELL_GPU, STENCILS, codesign, enumerate_hw_space
from repro_torch.core import sweep
from repro_torch.core.codesign import _resolve_engine
from repro_torch.core.solver import LATTICE_2D
from repro_torch.core.workload import paper_workload
from repro_torch.service.server import CodesignServer
from repro_torch.service.store import ArtifactStore
from test_torch_sweep import assert_tie_equivalent

CPU8 = ["cpu"] * 8


def small_hw(step=16):
    return enumerate_hw_space(MAXWELL, max_area=650.0).downsample(step)


def hw_cols(hw):
    return hw.n_sm, hw.n_v, hw.m_sm


SIZES_2D = np.array([[4096, 4096, 1, 1024], [2048, 2048, 1, 512]], np.float64)


def test_sharded_bit_identical_paper_sweep():
    """The six-stencil paper workload: the sharded codesign path equals the
    single-device engine bit for bit (times and argmin indices), and the
    reference's single-device engine tie-aware."""
    wl = paper_workload()
    hw = small_hw(step=24)
    res_torch = codesign(wl, hw=hw, engine="torch", device="cpu")
    res_sh = codesign(wl, hw=hw, engine="sharded", devices=CPU8)
    np.testing.assert_array_equal(res_sh.cell_time, res_torch.cell_time)
    np.testing.assert_array_equal(res_sh.cell_tile_idx, res_torch.cell_tile_idx)
    assert res_sh.best() == res_torch.best()


@pytest.mark.parametrize("chunk", [None, 0, 7, 64])
def test_sharded_padding_is_invisible(chunk):
    """H deliberately not divisible by shards x chunk: the pad rows never
    leak into results, for chunked and unchunked shard programs."""
    st = STENCILS["jacobi2d"]
    hw = small_hw(step=13)  # 394 points: not a multiple of 8 x any chunk
    t_ref, i_ref = sweep.sweep_cells(
        st, MAXWELL_GPU, SIZES_2D, *hw_cols(hw), LATTICE_2D, chunk, device="cpu"
    )
    for devices in (CPU8, ["cpu"] * 3, ["cpu"]):
        t, i = sweep.sweep_cells_sharded(
            st, MAXWELL_GPU, SIZES_2D, *hw_cols(hw), LATTICE_2D, chunk, devices=devices
        )
        np.testing.assert_array_equal(t, t_ref)
        np.testing.assert_array_equal(i, i_ref)
    t_j, i_j = jsweep.sweep_cells(J_STENCILS["jacobi2d"], J_GPU, SIZES_2D, *hw_cols(hw))
    assert_tie_equivalent("jacobi2d", SIZES_2D, hw, t_j, i_j, t, i)


@pytest.mark.parametrize("n_hw", [1, 3, 7])
def test_sharded_tiny_hardware_spaces(n_hw):
    """H < shards and H < chunk: every shard still gets a full-shaped
    slice via padding; results drop it."""
    st = STENCILS["jacobi2d"]
    cols = tuple(c[:n_hw] for c in hw_cols(small_hw(step=16)))
    t_ref, i_ref = sweep.sweep_cells(st, MAXWELL_GPU, SIZES_2D, *cols, LATTICE_2D, 5, device="cpu")
    t, i = sweep.sweep_cells_sharded(st, MAXWELL_GPU, SIZES_2D, *cols, LATTICE_2D, 5, devices=CPU8)
    assert t.shape == (SIZES_2D.shape[0], n_hw)
    np.testing.assert_array_equal(t, t_ref)
    np.testing.assert_array_equal(i, i_ref)


def test_sharded_empty_hardware_space():
    st = STENCILS["jacobi2d"]
    empty = np.empty(0)
    t, i = sweep.sweep_cells_sharded(
        st, MAXWELL_GPU, SIZES_2D, empty, empty, empty, LATTICE_2D, devices=CPU8
    )
    assert t.shape == (2, 0) and i.shape == (2, 0)
    assert t.dtype == np.float64 and i.dtype == np.int64


def test_sharded_devices_knob(monkeypatch):
    """devices= as repeated and explicit device lists agree with the
    single-device engine; an int names cards, so a host without one
    refuses every int (out of range), and None asks for every card."""
    import torch

    st = STENCILS["jacobi2d"]
    hw = small_hw(step=16)
    t_ref, i_ref = sweep.sweep_cells(st, MAXWELL_GPU, SIZES_2D, *hw_cols(hw), LATTICE_2D,
                                     device="cpu")
    for devices in (["cpu"], CPU8, [torch.device("cpu"), "cpu"], ("cpu",) * 5):
        t, i = sweep.sweep_cells_sharded(
            st, MAXWELL_GPU, SIZES_2D, *hw_cols(hw), LATTICE_2D, devices=devices
        )
        np.testing.assert_array_equal(t, t_ref)
        np.testing.assert_array_equal(i, i_ref)
    monkeypatch.setattr(sweep, "device_count", lambda: 0)
    for n in (1, 2):
        with pytest.raises(ValueError, match="out of range"):
            sweep.sweep_cells_sharded(st, MAXWELL_GPU, SIZES_2D, *hw_cols(hw), devices=n)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sweep.sweep_cells_sharded(st, MAXWELL_GPU, SIZES_2D, *hw_cols(hw))
    with pytest.raises(ValueError, match="no device"):
        sweep.sweep_cells_sharded(st, MAXWELL_GPU, SIZES_2D, *hw_cols(hw), devices=[])
    monkeypatch.setattr(sweep, "device_count", lambda: 4)
    assert sweep._resolve_devices(2) == (torch.device("cuda", 0), torch.device("cuda", 1))
    assert len(sweep._resolve_devices(None)) == 4
    with pytest.raises(ValueError, match="out of range"):
        sweep._resolve_devices(5)


def test_engine_auto_promotes_on_multi_device(monkeypatch):
    """auto -> sharded iff >1 card; -> torch on one card or none; ->
    numpy below the oracle floor."""
    monkeypatch.setattr(sweep, "device_count", lambda: 8)
    assert _resolve_engine("auto", 1000) == "sharded"
    assert _resolve_engine("auto", 3) == "numpy"
    monkeypatch.setattr(sweep, "device_count", lambda: 1)
    assert _resolve_engine("auto", 1000) == "torch"
    monkeypatch.setattr(sweep, "device_count", lambda: 0)
    assert _resolve_engine("auto", 1000) == "torch"  # and the torch engine raises
    assert _resolve_engine("auto", 3) == "numpy"


def test_devices_knob_implies_mesh_engine():
    """devices= promotes auto to sharded (even below the numpy floor) and
    is rejected, not silently ignored, by non-mesh engines."""
    assert _resolve_engine("auto", 1000, devices=4) == "sharded"
    assert _resolve_engine("auto", 3, devices=1) == "sharded"
    assert _resolve_engine("sharded", 1000, devices=4) == "sharded"
    for eng in ("torch", "numpy"):
        with pytest.raises(ValueError, match="devices"):
            _resolve_engine(eng, 1000, devices=2)
    with pytest.raises(ValueError, match="unknown engine"):
        _resolve_engine("jax", 1000)
    wl = paper_workload(["jacobi2d"])
    with pytest.raises(ValueError, match="devices"):
        codesign(wl, hw=small_hw(step=64), engine="numpy", devices=1)
    res_auto = codesign(wl, hw=small_hw(step=64), engine="auto", devices=["cpu"] * 2)
    res_torch = codesign(wl, hw=small_hw(step=64), engine="torch", device="cpu")
    np.testing.assert_array_equal(res_auto.cell_time, res_torch.cell_time)
    np.testing.assert_array_equal(res_auto.cell_tile_idx, res_torch.cell_tile_idx)


def test_sharded_matches_numpy_oracle_reductions():
    """Workload-level reductions through the full codesign stack agree with
    the float64 oracle within the cross-engine noise bound."""
    wl = paper_workload(["heat2d", "heat3d"], name="sharded-parity")
    hw = small_hw(step=48)
    res_np = codesign(wl, hw=hw, engine="numpy")
    res_sh = codesign(wl, hw=hw, engine="sharded", devices=["cpu"] * 4)
    np.testing.assert_allclose(res_sh.weighted_time(), res_np.weighted_time(), rtol=1e-5)
    np.testing.assert_allclose(res_sh.gflops(), res_np.gflops(), rtol=1e-5)


def test_server_devices_promotes_once_and_keys_as_the_reference(tmp_path):
    """The server's devices= promotes auto to sharded before keying, and
    the key names the matrix the port builds: its sharded engine returns
    the torch engine's matrix bit for bit, so the artifact keys as the
    port's torch family, and never as the JAX package's sharded/jax
    family, whose matrix differs on ties (the same request to the two
    packages names two artifacts). Its miss path shards; a non-mesh
    engine refuses devices=."""
    from repro.core.workload import paper_workload as j_paper_workload
    from repro.service.server import CodesignServer as JServer
    from repro.service.store import ArtifactStore as JStore

    store = ArtifactStore(str(tmp_path / "s"))
    wl = paper_workload(["jacobi2d"])
    srv = CodesignServer(store, workload=wl, downsample=64, devices=["cpu"] * 3)
    assert srv.engine == "sharded"
    ref = JServer(JStore(str(tmp_path / "r")), workload=j_paper_workload(["jacobi2d"]),
                  downsample=64, engine="sharded")
    assert srv.key == store.key_for(wl, MAXWELL_GPU, srv.hw, "torch")
    assert srv.key != ref.key == store.key_for(wl, MAXWELL_GPU, srv.hw, "jax")
    srv.ensure_artifact()
    art = store.get(srv.key)
    assert art.manifest["spec"]["engine"] == "torch" and art.manifest["engine"] == "sharded"
    res_torch = codesign(wl, hw=srv.hw, engine="torch", device="cpu")
    np.testing.assert_array_equal(np.asarray(art.cell_time), res_torch.cell_time)
    assert not store.has(ref.key)
    # the artifact reloads warm under its own key, as a torch-family server
    warm = CodesignServer.from_artifact(store, art)
    assert warm.key == srv.key and warm.engine == "torch"
    with pytest.raises(ValueError, match="devices"):
        CodesignServer(store, workload=wl, downsample=64, engine="torch", devices=1)


def test_clear_caches_resets_first_dispatch():
    st = STENCILS["jacobi2d"]
    hw = small_hw(step=64)
    sweep.sweep_cells_sharded(st, MAXWELL_GPU, SIZES_2D, *hw_cols(hw), devices=["cpu"] * 2)
    assert sweep._DISPATCH_SEEN and sweep._lattice_arrays.cache_info().currsize
    sweep.clear_caches()
    assert not sweep._DISPATCH_SEEN and sweep._lattice_arrays.cache_info().currsize == 0


def test_cli_devices_flag(tmp_path, capsys, monkeypatch):
    """``--devices N`` is the sharded engine's: with ``--engine auto`` it
    promotes, with a non-mesh engine or more cards than attached it exits
    2 with one line, and an LM build refuses it."""
    from repro_torch.service import cli

    monkeypatch.setattr(sweep, "device_count", lambda: 0)
    base = ["build", "--store", str(tmp_path / "s"), "--downsample", "48"]
    for extra, msg in (
        (["--devices", "1"], "out of range"),
        (["--engine", "sharded"], "no CUDA device"),
        (["--engine", "numpy", "--devices", "1"], "devices= only applies"),
        (["--workload", "lm", "--devices", "1"], "stencil sweep"),
    ):
        with pytest.raises(SystemExit) as e:
            cli.main(base + extra)
        assert e.value.code == 2
        err = capsys.readouterr().err.strip().splitlines()
        assert len(err) == 1 and err[0].startswith("error:") and msg in err[0], err
    cli.main(base + ["--engine", "numpy"])
    assert "built" in capsys.readouterr().out
