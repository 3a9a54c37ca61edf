"""The frozen reference against ``spt_tpu_torch``'s plain versions at 16x16
pixels and depth 3 on the CPU: K1's (the Cornell box), the wavefront's
(2,100 spheres, above the facade's wavefront threshold) and K2's
gradient.  The test imports both; the reference imports nothing of the
program."""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from benchmark import harness, scenes  # noqa: E402
from benchmark.reference import render as ref  # noqa: E402

import spt_tpu_torch as T  # noqa: E402
from spt_tpu_torch.diff import cuda_diff  # noqa: E402
from spt_tpu_torch.engine.cuda_backend import render_route  # noqa: E402

W = H = 16
DEPTH = 3


def _setup(cell, seed, **over):
    _, _, config, _, _ = harness.load_cell(cell, overrides=dict(
        config=over))
    desc = scenes.describe(config, seed)
    pose = scenes.pose(config, seed, 0)
    r = config["render"]
    st = ref.Settings(W, H, DEPTH, r["rr_depth"], r["use_nee"],
                      r["use_mis"], r["seed"])
    sd = scenes.port_scene(T, desc).compile(device="cpu")
    cam = T.Camera.look_at(pose["position"], pose["target"],
                           fov_degrees=pose["fov_degrees"], device="cpu")
    return desc, pose, st, sd, cam


@pytest.mark.parametrize("cell,over,start,spp", [
    ("cornell512.render", {}, 5, 3),
    ("scene10k.render", {"scene": {"count": 2100}}, 0, 2)])
def test_render_matches_the_ports_plain_version(cell, over, start, spp):
    desc, pose, st, sd, cam = _setup(cell, 2**31 + 99, **over)
    got = render_route(sd)(sd, cam, W, H, start, spp, max_bounces=DEPTH,
                           rr_depth=st.rr_depth, use_nee=st.use_nee,
                           use_mis=st.use_mis, seed=st.seed, dof=False)
    pids = torch.arange(W * H)
    want = ref.render_pixels(ref.scene_tables(desc, "cpu"),
                             ref.camera_blob(pose, "cpu"), pids,
                             range(start, start + spp), st)
    got = got.reshape(-1, 3)
    assert torch.count_nonzero(want) > 0
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)


def test_gradient_matches_the_ports_plain_k2():
    desc, pose, st, sd, cam = _setup("cornell512.inverse", 17)
    rng = np.random.default_rng(3)
    target = torch.as_tensor(rng.uniform(0, 1, (H, W, 3)), dtype=torch.float32)
    params = {"albedo": sd.materials.albedo.clone(),
              "roughness": sd.materials.roughness.clone()}
    render = cuda_diff.make_cuda_render_fn(
        sd, cam, W, H, spp=4, max_bounces=DEPTH, rr_depth=st.rr_depth,
        use_nee=st.use_nee, use_mis=st.use_mis, seed=st.seed)
    leaves = {k: v.clone().requires_grad_(True) for k, v in params.items()}
    loss = torch.mean((render(leaves, 8) - target) ** 2)
    loss.backward()
    want_loss, want = ref.loss_and_grad(desc, params, pose, target,
                                        list(range(8, 12)), st)
    assert float(loss.detach()) == pytest.approx(float(want_loss), rel=1e-6)
    for k in params:
        assert torch.count_nonzero(want[k]) > 0
        torch.testing.assert_close(leaves[k].grad, want[k], rtol=1e-4,
                                   atol=1e-7)


def test_control_differs_from_the_reference():
    desc, pose, st, sd, cam = _setup("cornell512.render", 4)
    pids = torch.arange(W * H)
    blob = ref.camera_blob(pose, "cpu")
    hi = ref.render_pixels(ref.scene_tables(desc, "cpu"), blob, pids,
                           range(4), st)
    lo = ref.render_pixels(ref.scene_tables(desc, "cpu", lowp=True), blob,
                           pids, range(4), st, lowp=True)
    assert float((hi - lo).abs().sum() / hi.abs().sum()) > 1e-3
