"""The harness is driven by data: a configuration, a traffic mix, a cell
and a per-layer metric added as new files are found by name; and a run
loads nothing of JAX or of the JAX package."""

import json
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

from benchmark import harness  # noqa: E402

SMALL = {"config": {"render": {"width": 12, "height": 8}},
         "traffic": {"spp": 4, "warmup_spp": 2}, "check": {"pixels": 24}}


def test_new_files_are_found_by_name(tmp_path):
    """A copy of the benchmark with one configuration, traffic mix, cell
    and per-layer metric more, each a new file and a new entry of
    BENCHMARK.json: the new cell runs and reports the new metric."""
    shutil.copytree(REPO / "benchmark", tmp_path / "benchmark")
    root = tmp_path / "benchmark"
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    cfg = json.loads((root / "configs" / "cornell512.json").read_text())
    cfg["name"] = "cornell_dim"
    cfg["scene"]["materials"][3]["emission"] = [5.0, 5.0, 5.0]
    (root / "configs" / "cornell_dim.json").write_text(json.dumps(cfg))
    (root / "traffic" / "render_8spp.json").write_text(json.dumps(
        dict(entry="facade_render", loop="closed", spp=40, warmup_spp=4,
             keep_images=2)))
    (root / "cells" / "cornell_dim.render8.json").write_text(json.dumps(
        dict(pixels=24, limits=dict(image_rel_l1=1e-3))))
    (root / "metrics" / "chunks_per_image.py").write_text(
        "def read(ctx):\n"
        "    n = ctx['window']['images']\n"
        "    return len(ctx['spans']['render_call_s']) / n if n else None\n")
    bench["configs"].append(dict(bench["configs"][0], name="cornell_dim",
                                 file="benchmark/configs/cornell_dim.json"))
    bench["workloads"].append(dict(
        name="cornell_dim.render8", config="cornell_dim",
        traffic="render_8spp", chips=1, why="a dimmer lamp"))
    bench["per_layer"].append(dict(
        name="chunks_per_image", unit="chunks", better="lower",
        source="program_counter", layer="facade", moves="msamples_per_s",
        workloads=["cornell_dim.render8"]))
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    over = {"config": SMALL["config"], "traffic": {}, "check": {}}
    result, _ = harness.run("cornell_dim.render8", 3, 2.0, True,
                            device="cpu", overrides=over, root=root)
    assert result["correct"]
    m = result["metrics"]
    # The facade's chunks of 32 spp: 2 an image of 40.
    assert m["chunks_per_image"]["value"] == 2.0
    assert m["chunks_per_image"]["unit"] == "chunks"
    assert "facade_host_ms" not in m      # listed for another cell only
    with pytest.raises(harness.RunError):
        harness.run("no.such.cell", 3, 0.3, False, device="cpu", root=root)


def test_metrics_of_follow_workloads_and_moves():
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    for w in bench["workloads"]:
        e2e = {m["name"] for m in harness.metrics_of(bench, w["name"],
                                                     "end_to_end")}
        assert "setup_s" in e2e and len(e2e) >= 2
        per = harness.metrics_of(bench, w["name"], "per_layer")
        assert per and all(m["moves"] in e2e for m in per)


def test_forbidden_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "spt_tpu_torch_x", sys)
    assert "spt_tpu" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "spt_tpu.core", sys)
    assert "spt_tpu" in harness.forbidden_modules()


CHILD = """
import sys, json
sys.path.insert(0, {repo!r})
from benchmark import harness
for cell, over in {cells!r}:
    harness.run(cell, 5, 0.2, cell.endswith('render'), device='cpu',
                overrides=over)
print(json.dumps(sorted({{m.split('.')[0] for m in sys.modules}})))
"""


def test_a_run_loads_no_jax():
    """Every module a run loads, in a fresh process: the harness, the
    entries, the reference, the trace reader and the program."""
    cells = [("cornell512.render", SMALL),
             ("cornell512.inverse",
              {"config": SMALL["config"],
               "traffic": {"spp_per_step": 2, "target_spp": 2}})]
    out = subprocess.run(
        [sys.executable, "-c", CHILD.format(repo=str(REPO), cells=cells)],
        capture_output=True, text=True, timeout=600, cwd=REPO)
    assert out.returncode == 0, out.stderr[-3000:]
    names = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "spt_tpu_torch" in names and "benchmark" in names
    assert not names & {"jax", "jaxlib", "flax", "spt_tpu"}


def test_reference_imports_nothing_of_the_program():
    child = ("import sys; sys.path.insert(0, %r)\n"
             "import benchmark.reference.render, benchmark.reference.counts\n"
             "print(sorted(m for m in sys.modules if m.startswith('spt_')))"
             % str(REPO))
    out = subprocess.run([sys.executable, "-c", child], capture_output=True,
                         text=True, timeout=120, cwd=REPO)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
    for path in (REPO / "benchmark" / "reference").glob("*.py"):
        text = path.read_text()
        assert "spt_tpu" not in text.replace("spt_tpu_torch/", "")


def test_run_without_a_card_prints_no_result():
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload",
         "cornell512.render", "--seed", str(2**31 + 7), "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, timeout=300,
        cwd=REPO, env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin",
                       "HOME": str(REPO)})
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is here")
    assert out.returncode != 0
    assert not [ln for ln in out.stdout.splitlines() if ln.startswith("{")]
