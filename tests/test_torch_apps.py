"""The port's applications on the CPU: the CLI renderer and the
inverse-render demo, called in process through ``main(argv)``, and the
CLI once as ``python -m`` in a subprocess.

As the JAX package's ``tests/test_cli.py`` holds its CLI: a resumed
render equals an uninterrupted one within rtol 1e-6, atol 1e-7 (here on
every value: the same samples summed in the same chunks); a missing scene
exits nonzero.  Renders are tiny (at most 32x24, depth 2).
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from spt_tpu_torch.apps import inverse_render, render_cli

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
SCENE = str(ROOT / "scenes" / "cornell.json")
PNG = b"\x89PNG\r\n\x1a\n"
SMALL = ["--device", "cpu", "--size", "32", "24", "--chunk", "4",
         "--max-bounces", "2", "-q"]


def test_cli_writes_png_and_resumes(tmp_path, capsys):
    out = str(tmp_path / "out.png")
    assert render_cli.main([SCENE, "-o", out, "--spp", "2", *SMALL]) == 0
    assert Path(out).read_bytes()[:8] == PNG

    direct = str(tmp_path / "direct.npy")
    assert render_cli.main([SCENE, "-o", direct, "--spp", "8", *SMALL]) == 0
    state = str(tmp_path / "state.npz")
    stats = {}
    assert render_cli.main([SCENE, "-o", str(tmp_path / "part.npy"),
                            "--spp", "4", "--checkpoint", state, *SMALL],
                           stats=stats) == 0
    assert len(stats["chunk_s"]) == 1 and stats["tracer"].frame_count == 4
    resumed = str(tmp_path / "resumed.npy")
    assert render_cli.main([SCENE, "-o", resumed, "--spp", "8", "--resume",
                            state, *SMALL]) == 0
    assert "resumed at 4 spp" in capsys.readouterr().out
    np.testing.assert_allclose(np.load(resumed), np.load(direct),
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_array_equal(np.load(resumed), np.load(direct))


def test_cli_missing_scene_fails(tmp_path, capsys):
    code = render_cli.main([str(tmp_path / "missing.json"), "-o",
                            str(tmp_path / "x.png"), "--device", "cpu"])
    assert code != 0
    assert "cannot load" in capsys.readouterr().err
    assert not (tmp_path / "x.png").exists()


def test_cli_runs_as_a_module(tmp_path):
    out = str(tmp_path / "m.png")
    env = dict(os.environ, OMP_NUM_THREADS="1")
    r = subprocess.run(
        [sys.executable, "-m", "spt_tpu_torch.apps.render_cli", SCENE, "-o",
         out, "--device", "cpu", "--size", "8", "8", "--spp", "1",
         "--max-bounces", "1"],
        capture_output=True, text=True, timeout=300, cwd=str(ROOT), env=env)
    assert r.returncode == 0, r.stderr
    assert "wrote" in r.stdout and "device=cpu" in r.stdout
    assert Path(out).read_bytes()[:8] == PNG


def test_inverse_render_prints_finite_losses(tmp_path, capsys):
    stats = {}
    out = str(tmp_path / "inv.png")
    assert inverse_render.main(
        ["--device", "cpu", "--spheres", "4", "--steps", "3", "--size", "16",
         "16", "--spp", "2", "--target-spp", "4", "--out", out],
        stats=stats) == 0
    text = capsys.readouterr().out
    losses = [float(line.split("loss=")[1].split()[0])
              for line in text.splitlines() if "loss=" in line]
    assert len(losses) == 3 and np.isfinite(losses).all()
    np.testing.assert_allclose(losses, stats["losses"], atol=1e-6)
    assert set(stats["err_end"]) == {"albedo", "roughness"}
    assert np.isfinite([stats["loss_before"], stats["loss_after"]]).all()
    assert "mean abs error" in text
    assert Path(out).read_bytes()[:8] == PNG
