"""The port's training launcher (``python -m repro_torch.launch.train``):
on the CPU it finishes a reduced run and prints the device line and the
``finished step=...`` line in the form the JAX package's ``python -m
repro.launch.train`` prints for the same flags (the weights differ: each
package draws them from its own generator); without ``--device`` and
without a card, and for a mesh of more than one device, it exits 2 with
one line; a rerun over the same checkpoint directory resumes where the
first run stopped. Under ``torchrun --nproc-per-node 4`` with ``--mesh
2x2 --device cpu`` the same run trains on a mesh of four gloo ranks, and
a mesh of another size than ``WORLD_SIZE`` exits 2 with one line."""

import os
import re
import subprocess
import sys

import pytest

from repro_torch.launch.train import main

FLAGS = ["--arch", "internlm2-1.8b", "--reduced", "--steps", "6", "--batch", "4", "--seq", "32",
         "--ckpt-every", "3"]
FINISHED = re.compile(r"finished step=(\d+) failures=0 stragglers=\d+ loss=(\d+\.\d{4})$")


def _run(module, args, env):
    return subprocess.run([sys.executable, "-m", module, *args], env=env, capture_output=True,
                          text=True, timeout=300)


def test_launch_train_cli_on_the_cpu(subprocess_env, tmp_path):
    env = dict(subprocess_env, CUDA_VISIBLE_DEVICES="", JAX_PLATFORMS="cpu")
    out = _run("repro_torch.launch.train",
               FLAGS + ["--device", "cpu", "--ckpt-dir", str(tmp_path / "port")], env)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.strip().splitlines()
    assert len(lines) == 2, lines
    assert lines[0].startswith("device cpu; internlm2-1.8b-reduced: 6 steps of 128 tokens, step ")
    assert "tokens/s, max_memory_allocated not measured (cpu)" in lines[0]
    got = FINISHED.match(lines[1])
    assert got and got.group(1) == "6", lines[1]
    ref = _run("repro.launch.train", FLAGS + ["--ckpt-dir", str(tmp_path / "ref")], env)
    assert ref.returncode == 0, ref.stderr
    want = FINISHED.match(ref.stdout.strip().splitlines()[-1])
    assert want and want.group(1) == "6"
    assert 0 < float(got.group(2)) < 6.6  # ln(256) = 5.55 for uniform guesses


def test_launch_train_without_a_card_exits_2(subprocess_env, tmp_path):
    env = dict(subprocess_env, CUDA_VISIBLE_DEVICES="")
    out = _run("repro_torch.launch.train", FLAGS + ["--ckpt-dir", str(tmp_path)], env)
    assert out.returncode == 2 and out.stdout == ""
    assert out.stderr.strip().splitlines() == [
        "error: no CUDA device is available; pass --device cpu to run on the CPU"]


@pytest.mark.parametrize("mesh", ["2x2", "16x16", "1x2", "4", "2x16x16", "one"])
def test_launch_train_refuses_a_multi_device_mesh(mesh, tmp_path, capsys):
    with pytest.raises(SystemExit) as e:
        main(FLAGS + ["--device", "cpu", "--mesh", mesh, "--ckpt-dir", str(tmp_path)])
    assert e.value.code == 2
    err = capsys.readouterr().err.strip().splitlines()
    # without torchrun only a one-device mesh runs
    want = "want A, AxB or AxBxC" if mesh == "one" else "run under torchrun"
    assert len(err) == 1 and want in err[0] and mesh in err[0], err


@pytest.mark.parametrize("mesh,world", [("2x2", 2), ("2x2", 8), ("1x1", 4)])
def test_launch_train_refuses_a_mesh_of_another_size_than_the_job(mesh, world, tmp_path, capsys,
                                                                  monkeypatch):
    monkeypatch.setenv("WORLD_SIZE", str(world))
    with pytest.raises(SystemExit) as e:
        main(FLAGS + ["--device", "cpu", "--mesh", mesh, "--ckpt-dir", str(tmp_path)])
    assert e.value.code == 2
    err = capsys.readouterr().err.strip().splitlines()
    assert err == [f"error: --mesh {mesh} needs {eval(mesh.replace('x', '*'))} ranks, "
                   f"WORLD_SIZE is {world}"]


def test_launch_train_under_torchrun_on_a_2x2_mesh(subprocess_env, tmp_path):
    env = dict(subprocess_env, CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node", "4",
         "-m", "repro_torch.launch.train", *FLAGS, "--mesh", "2x2", "--device", "cpu",
         "--ckpt-dir", str(tmp_path)],
        env=env, capture_output=True, text=True, timeout=300,
        preexec_fn=lambda: os.nice(19))  # yield the CPU to the test workers beside the ranks
    assert out.returncode == 0, out.stderr[-3000:]
    lines = out.stdout.strip().splitlines()
    assert len(lines) == 2, lines  # rank 0 alone prints
    assert lines[0].startswith("device cpu; mesh 2x2 (4 ranks); internlm2-1.8b-reduced: "
                               "6 steps of 128 tokens, step ")
    got = FINISHED.match(lines[1])
    assert got and got.group(1) == "6", lines[1]
    assert 0 < float(got.group(2)) < 6.6
    assert sorted(p.name for p in tmp_path.iterdir()) == ["step_00000003", "step_00000006"]


def test_launch_train_resumes_from_its_checkpoint_dir(tmp_path, capsys):
    args = ["--arch", "llama3-8b", "--reduced", "--batch", "2", "--seq", "16", "--ckpt-every", "2",
            "--device", "cpu", "--mesh", "1", "--ckpt-dir", str(tmp_path)]
    main(args + ["--steps", "3"])
    assert "finished step=3 " in capsys.readouterr().out
    main(args + ["--steps", "5"])
    first, last = capsys.readouterr().out.strip().splitlines()
    assert ": 2 steps of 32 tokens" in first and last.startswith("finished step=5 ")
