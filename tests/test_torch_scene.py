"""The port's scene, camera, packing and color against the JAX package's.

Tolerances: compiled scene arrays, packed blob/meta and light-cell bounds
are bit-equal; ``Camera.look_at`` agrees within 1e-6 (the two frameworks'
norm and tan may round differently); the display image and its RGBA8888
words are bit-equal for one accumulation buffer.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import spt_tpu
import spt_tpu_torch
from spt_tpu.kernels import megakernel as jmega
from spt_tpu.kernels import physics as jphys
from spt_tpu_torch.core import color as tcolor
from spt_tpu_torch.core.convert import camera_from_arrays, scene_data_from_arrays
from spt_tpu_torch.kernels import megakernel as tmega
from spt_tpu_torch.kernels import physics as tphys

CPU = "cpu"


def cornell_scene(pkg):
    """bench.py's Cornell box, built through either package's Scene API."""
    scene = pkg.Scene()
    scene.set_sky(pkg.SKY_NONE)
    white = scene.add_material("lambert", albedo=(0.73, 0.73, 0.73))
    red = scene.add_material("lambert", albedo=(0.65, 0.05, 0.05))
    green = scene.add_material("lambert", albedo=(0.12, 0.45, 0.15))
    light = scene.add_material("lambert", albedo=(0.78,) * 3,
                               emission=(15.0,) * 3)
    metal = scene.add_material("metal", albedo=(0.8, 0.85, 0.9), roughness=0.2)
    glass = scene.add_material("glass", albedo=(0.97,) * 3, ior=1.5)
    R = 1000.0
    for nm, pos, r, m in [
            ("floor", (0, -R, 3), R, white), ("ceil", (0, R + 2, 3), R, white),
            ("left", (-R - 2, 1, 3), R, red), ("right", (R + 2, 1, 3), R, green),
            ("back", (0, 1, R + 5), R, white), ("lamp", (0, 2.55, 3), 0.6, light),
            ("ball", (-0.7, 0.5, 3.4), 0.5, metal),
            ("gball", (0.7, 0.45, 2.8), 0.45, glass)]:
        scene.create_sphere(nm, pos, r, m)
    return scene


def cornell_camera(pkg, **kw):
    if pkg is spt_tpu_torch:
        kw.setdefault("device", CPU)
    kw.setdefault("fov_degrees", 55)
    return pkg.Camera.look_at((0, 1.0, -1.5), (0, 1.0, 3.0), **kw)


SCENES = {
    "cornell": (cornell_scene, {}),
    "demo38": (lambda pkg: pkg.demo_scene_38_spheres(), {"capacity": 64}),
}


def compile_both(name):
    build, kw = SCENES[name]
    return (build(spt_tpu).compile(**kw),
            build(spt_tpu_torch).compile(device=CPU, **kw))


def jax_scene_arrays(sd):
    """The JAX SceneData's fields as numpy arrays (materials.* flattened)."""
    out = {f: np.asarray(getattr(sd, f)) for f in
           ("centers", "radii", "mat_id", "prim_valid", "light_idx",
            "light_valid", "sky_params")}
    out.update({f"materials.{f}": np.asarray(getattr(sd.materials, f))
                for f in ("albedo", "emission", "roughness", "ior", "mtype")})
    return out


def torch_scene_arrays(sd):
    out = {f: getattr(sd, f).numpy() for f in
           ("centers", "radii", "mat_id", "prim_valid", "light_idx",
            "light_valid", "sky_params")}
    out.update({f"materials.{f}": getattr(sd.materials, f).numpy()
                for f in ("albedo", "emission", "roughness", "ior", "mtype")})
    return out


def _assert_same(a: dict, b: dict):
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("name", sorted(SCENES))
def test_compile_bit_equal(name):
    sdj, sdt = compile_both(name)
    _assert_same(torch_scene_arrays(sdt), jax_scene_arrays(sdj))
    assert (sdt.num_prims, sdt.num_lights, sdt.sky_mode) == \
        (sdj.num_prims, sdj.num_lights, sdj.sky_mode)
    assert sdt.capacity == sdj.capacity and sdt.env_map is None


@pytest.mark.parametrize("name", sorted(SCENES))
def test_scene_data_from_jax_arrays(name):
    sdj, sdt = compile_both(name)
    conv = scene_data_from_arrays(jax_scene_arrays(sdj),
                                  num_prims=sdj.num_prims,
                                  num_lights=sdj.num_lights,
                                  sky_mode=sdj.sky_mode, device=CPU)
    _assert_same(torch_scene_arrays(conv), torch_scene_arrays(sdt))


@pytest.mark.parametrize("name", sorted(SCENES))
def test_pack_scene_bit_equal(name):
    sdj, sdt = compile_both(name)
    cam_j, cam_t = cornell_camera(spt_tpu), cornell_camera(spt_tpu_torch)
    blob_j, mt_j, lp_j = jmega.pack_scene(sdj, cam_j)
    blob_t, mt_t, lp_t = tmega.pack_scene(sdt, cam_j)   # the JAX camera's bits
    np.testing.assert_array_equal(blob_t, blob_j)
    assert (mt_t, lp_t) == (mt_j, lp_j)
    assert tmega.pack_scene_static(sdt) == jmega.pack_scene_static(sdj)
    # The port's own camera packs within look_at's tolerance.
    np.testing.assert_allclose(tmega.pack_scene(sdt, cam_t)[0], blob_j,
                               rtol=0, atol=1e-6)


@pytest.mark.parametrize("name", sorted(SCENES))
def test_pack_meta_matches_jax_layout(name):
    sdj, sdt = compile_both(name)
    _, mtypes, lights = jmega.pack_scene(sdj, cornell_camera(spt_tpu))
    # The JAX package builds meta inline in render_tiles (megakernel.py).
    want = np.zeros(3 + sdj.capacity + max(len(lights), 1), np.int32)
    want[:3] = [5, 3, len(lights)]
    want[3:3 + sdj.capacity] = mtypes
    want[3 + sdj.capacity:3 + sdj.capacity + len(lights)] = lights
    _, mt, lp = tmega.pack_scene(sdt, cornell_camera(spt_tpu_torch))
    np.testing.assert_array_equal(tmega.pack_meta(5, 3, mt, lp), want)


@pytest.mark.parametrize("name", sorted(SCENES))
def test_lsel_bounds_bit_equal(name):
    sdj, sdt = compile_both(name)
    want = np.asarray(jphys.lsel_bounds(sdj.centers, sdj.radii,
                                        sdj.prim_valid))
    got = tphys.lsel_bounds(sdt.centers, sdt.radii, sdt.prim_valid).numpy()
    np.testing.assert_array_equal(got, want)


def test_lsel_bounds_empty_scene():
    want = np.asarray(jphys.lsel_bounds(np.zeros((8, 3), np.float32),
                                        np.zeros(8, np.float32),
                                        np.zeros(8, bool)))
    got = tphys.lsel_bounds(torch.zeros(8, 3), torch.zeros(8),
                            torch.zeros(8, dtype=torch.bool)).numpy()
    np.testing.assert_array_equal(got, want)


CAMERAS = [
    dict(position=(0, 1.0, -1.5), target=(0, 1.0, 3.0), fov_degrees=55),
    dict(position=(0, 0, 0), target=(0, 0, 1), fov_degrees=90),
    dict(position=(1.5, 2.0, -3.0), target=(-0.2, 0.4, 2.5), fov_degrees=40,
         aperture=0.15, focus_dist=4.5),
    dict(position=(0, 5, 0), target=(0.3, 0, 0.2), fov_degrees=70),
]


@pytest.mark.parametrize("i", range(len(CAMERAS)))
def test_camera_look_at(i):
    kw = CAMERAS[i]
    cj = spt_tpu.Camera.look_at(**kw)
    ct = spt_tpu_torch.Camera.look_at(device=CPU, **kw)
    for f in ("position", "forward", "right", "up", "tan_half_fov",
              "aperture", "focus_dist"):
        np.testing.assert_allclose(getattr(ct, f).numpy(),
                                   np.asarray(getattr(cj, f)), rtol=0,
                                   atol=1e-6, err_msg=f)
    conv = camera_from_arrays({f: np.asarray(getattr(cj, f)) for f in
                               ("position", "forward", "right", "up",
                                "tan_half_fov", "aperture", "focus_dist")},
                              device=CPU)
    np.testing.assert_array_equal(conv.right.numpy(), np.asarray(cj.right))


def test_camera_generate_rays_matches_jax():
    cj = spt_tpu.Camera.look_at(**CAMERAS[2])
    ct = spt_tpu_torch.Camera.look_at(device=CPU, **CAMERAS[2])
    r = np.random.default_rng(0)
    px = r.integers(0, 64, 256).astype(np.int32)
    py = r.integers(0, 48, 256).astype(np.int32)
    jit = r.random((4, 256)).astype(np.float32)
    oj, dj = cj.generate_rays(jnp.asarray(px), jnp.asarray(py), 64, 48,
                              *(jnp.asarray(j) for j in jit))
    ot, dt = ct.generate_rays(torch.from_numpy(px), torch.from_numpy(py), 64,
                              48, *(torch.from_numpy(j) for j in jit))
    np.testing.assert_allclose(ot.numpy(), np.asarray(oj), atol=1e-5)
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), atol=1e-5)


def test_bvh_scene_raises_not_implemented():
    scene = spt_tpu_torch.Scene()
    for i in range(600):
        scene.create_sphere(f"s{i}", (i * 0.1, 0.0, 5.0), 0.01)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        scene.compile(device=CPU)


@pytest.mark.parametrize("tonemap,gamma,auto", [
    ("none", 1.0, False), ("reinhard", 2.2, False), ("aces", 1.0, True)])
def test_display_image_and_rgba8_bit_equal(tonemap, gamma, auto):
    from spt_tpu.core import color as jcolor
    acc = (np.random.default_rng(1).random((8, 12, 3)) * 6.0).astype(
        np.float32)
    kw = dict(exposure=1.3, tonemap=tonemap, gamma=gamma, auto_exposure=auto)
    img_j = jcolor.finalize_image(jnp.asarray(acc), 3, **kw)
    img_t = tcolor.finalize_image(torch.from_numpy(acc), 3, **kw)
    np.testing.assert_allclose(img_t.numpy(), np.asarray(img_j), rtol=1e-6,
                               atol=1e-7)
    packed_t = tcolor.pack_rgba8(torch.from_numpy(np.array(img_j)))
    assert packed_t.dtype == torch.uint32
    np.testing.assert_array_equal(packed_t.numpy(),
                                  np.asarray(jcolor.pack_rgba8(img_j)))


def test_settings_dirty_protocol():
    s = spt_tpu_torch.RenderSettings()
    assert s.is_dirty()
    s.clear_dirty()
    s.width = 512          # unchanged value: stays clean
    assert not s.is_dirty()
    s.set_resolution(64, 32)
    assert s.is_dirty() and (s.get_width(), s.get_height()) == (64, 32)
