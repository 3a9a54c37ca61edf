"""The port's progressive facade, its routes, and the package boundary.

The facade runs on the CPU here (``device="cpu"``), where K1's wrapper takes
the plain version.  Against ``create_path_tracer("jax")`` the tolerance is
the JAX suite's bar between two implementations (97% of pixels
``isclose(rtol=2e-3, atol=2e-4)``, means within 1%); the display
conversion from one accumulation buffer must be bit-equal.
"""

import ast
from pathlib import Path

import numpy as np
import pytest
import torch

import spt_tpu
import spt_tpu_torch
from spt_tpu_torch import RenderSettings, create_path_tracer
from spt_tpu_torch.kernels import megakernel as tmega
from test_torch_scene import cornell_camera, cornell_scene

# One intra-op thread: these tests trace small tensors, where torch's
# idle OpenMP workers would only spin against the other test processes.
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent


def _tracer(scene=None, w=8, h=8, spp=2, **settings):
    tr = create_path_tracer("cuda", device="cpu")
    tr.set_scene(scene if scene is not None else cornell_scene(spt_tpu_torch))
    tr.set_camera(cornell_camera(spt_tpu_torch))
    s = RenderSettings()
    s.set_resolution(w, h)
    s.samples_per_pixel = spp
    s.max_bounces = 2
    s.russian_roulette_depth = 1
    for k, v in settings.items():
        setattr(s, k, v)
    tr.set_settings(s)
    return tr


def test_unknown_backend_raises_value_error():
    with pytest.raises(ValueError, match="available.*cuda"):
        create_path_tracer("optix", device="cpu")


def test_render_without_scene_raises():
    tr = create_path_tracer("cuda", device="cpu")
    with pytest.raises(RuntimeError, match="Scene not set"):
        tr.render()


def test_default_device_needs_a_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        create_path_tracer("cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        spt_tpu_torch.Scene().compile()


def test_progressive_accumulation_and_result():
    tr = _tracer()
    assert tr.get_backend_name() == "cuda" and tr.device.type == "cpu"
    with pytest.raises(RuntimeError, match="No frames"):
        tr.get_render_result()
    before = dict(tmega.LAUNCHES)
    for i in range(3):
        tr.render()
        assert tr.frame_count == i + 1
    res = tr.get_render_result()
    assert (res.width, res.height) == (8, 8)
    assert res.image_f32.shape == (8, 8, 3)
    assert res.image_buffer.dtype == torch.uint32
    assert torch.isfinite(res.image_f32).all() and res.image_f32.max() > 0
    assert tmega.LAUNCHES["plain"] == before["plain"] + 3
    assert tmega.LAUNCHES["k1"] == before["k1"]


def test_scene_edit_resets_accumulation():
    scene = cornell_scene(spt_tpu_torch)
    tr = _tracer(scene)
    tr.render()
    tr.render()
    assert tr.frame_count == 2
    cap = tr.scene_data.capacity
    scene.find_node("ball").set_position(-0.6, 0.5, 3.4)
    tr.render()
    assert tr.frame_count == 1
    assert tr.scene_data.capacity == cap
    assert float(tr.scene_data.centers[6, 0]) == pytest.approx(-0.6)


def test_settings_and_camera_changes_reset():
    tr = _tracer()
    tr.render()
    tr.render()
    tr.get_settings().max_bounces = 3
    tr.render()
    assert tr.frame_count == 1
    tr.render()
    tr.set_camera(cornell_camera(spt_tpu_torch, fov_degrees=40))
    tr.render()
    assert tr.frame_count == 1


def test_resolution_change_reallocates():
    tr = _tracer()
    tr.render()
    tr.get_settings().set_resolution(6, 4)
    tr.render()
    assert tr.frame_count == 1
    assert tr.get_render_result().image_f32.shape == (4, 6, 3)


def test_render_to_completion_chunks():
    tr = _tracer(spp=5)
    tr.render_to_completion(chunk_spp=2)
    assert tr.frame_count == 5
    tr.get_settings().progressive = False
    tr.render_to_completion()
    assert tr.frame_count == 5


def test_checkpoint_roundtrip():
    tr = _tracer()
    tr.render()
    tr.render()
    state = tr.get_state()
    img = tr.get_render_result().image_f32.clone()
    tr2 = _tracer()
    tr2.set_state(state)
    assert tr2.frame_count == 2
    torch.testing.assert_close(tr2.get_render_result().image_f32, img)


def _many_spheres(n):
    scene = spt_tpu_torch.Scene()
    for i in range(n):
        scene.create_sphere(f"s{i}", (i * 0.1, 0.0, 5.0), 0.01)
    return scene


@pytest.mark.parametrize("route", ["capacity", "envmap", "reference", "bvh"])
def test_unported_routes_raise_not_implemented(route):
    """Env-map skies and the reference integrator raise, naming their
    ROADMAP.md item.  Scenes above K1's 128 spheres ("capacity") and above
    the BVH threshold ("bvh") do not: they render through the plain K3."""
    if route == "capacity":
        tr = _tracer(_many_spheres(130))          # capacity 256 > 128
    elif route == "bvh":
        tr = _tracer(_many_spheres(600))          # compile builds a BVH
    else:
        tr = _tracer()
    if route == "envmap":
        tr._scene.set_environment_map(np.ones((4, 8, 3), np.float32))
    if route == "reference":
        tr.get_settings().integrator = "reference"
    if route in ("envmap", "reference"):
        with pytest.raises(NotImplementedError, match="ROADMAP.md"):
            tr.render()
        return
    before = dict(tmega.LAUNCHES)
    tr.render()
    assert tmega.LAUNCHES == dict(before, plain=before["plain"] + 1)
    sd = tr.scene_data
    assert sd.capacity == (256 if route == "capacity" else 1024)
    assert (sd.bvh is not None) == (route == "bvh")
    img = tr.get_render_result().image_f32
    assert img.shape == (8, 8, 3) and bool(torch.isfinite(img).all())


def test_result_matches_jax_facade():
    kw = dict(w=16, h=16, spp=2)
    tj = spt_tpu.create_path_tracer("jax")
    tj.set_scene(cornell_scene(spt_tpu))
    tj.set_camera(cornell_camera(spt_tpu))
    s = spt_tpu.RenderSettings()
    s.set_resolution(16, 16)
    s.samples_per_pixel, s.max_bounces, s.russian_roulette_depth = 2, 3, 2
    s.progressive, s.seed = False, 3
    tj.set_settings(s)
    tj.render()
    tt = _tracer(max_bounces=3, russian_roulette_depth=2, progressive=False,
                 seed=3, **kw)
    tt.render()
    want = tj.get_render_result()
    got = tt.get_render_result()
    close = np.isclose(got.image_f32.numpy(), np.asarray(want.image_f32),
                       rtol=2e-3, atol=2e-4).all(axis=-1)
    assert close.mean() >= 0.97
    assert abs(float(got.image_f32.mean()) - float(want.image_f32.mean())) \
        <= 0.01 * float(want.image_f32.mean())
    # One accumulation buffer gives the same display image and words.
    tt.set_state({"accum": torch.from_numpy(np.array(tj.get_state()["accum"])),
                  "frame_count": 2})
    again = tt.get_render_result()
    np.testing.assert_array_equal(again.image_f32.numpy(),
                                  np.asarray(want.image_f32))
    np.testing.assert_array_equal(again.image_buffer.numpy(),
                                  np.asarray(want.image_buffer))


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", sorted(
    [p.relative_to(ROOT).as_posix()
     for p in (ROOT / "spt_tpu_torch").rglob("*.py")] + ["chip_smoke.py"]))
def test_port_imports_no_jax(path):
    """Neither the package nor chip_smoke.py imports jax or spt_tpu."""
    for name in _imports(ROOT / path):
        top = name.split(".")[0]
        assert top not in ("jax", "jaxlib", "spt_tpu"), f"{path}: {name}"
