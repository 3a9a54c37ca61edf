"""The port's I/O against the JAX package's: scene files, image writers,
the native display bridge and checkpoints.

Tolerances: compiled scene arrays, settings and saved files are equal
exactly; cameras within 1e-6 relative (``Camera.look_at``'s norm and tan
round otherwise in the two frameworks, ROADMAP.md §3); an environment map
through a saved scene within RGBE precision (1/128 of a pixel's largest
channel); the writers' bytes equal.  ``native_display.resolve_pack`` is
held to the port's ``finalize_image`` / ``pack_rgba8`` / ``to_u8_array``
as the JAX package's tests hold its own (bit-equal at a power-of-two
sample count, else 2e-6 and one u8 step).
"""

import dataclasses
import json
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import spt_tpu
import spt_tpu_torch
from spt_tpu.core import color as jcolor
from spt_tpu.io import checkpoint as jckpt
from spt_tpu.io import exr as jexr
from spt_tpu.io import hdr as jhdr
from spt_tpu.io import image as jimage
from spt_tpu.io import scene_json as jsj
from spt_tpu_torch.core import color as tcolor
from spt_tpu_torch.io import checkpoint as tckpt
from spt_tpu_torch.io import exr as texr
from spt_tpu_torch.io import hdr as thdr
from spt_tpu_torch.io import image as timage
from spt_tpu_torch.io import native_display as tnd
from spt_tpu_torch.io import scene_json as tsj
from test_torch_scene import (_assert_same, cornell_camera, cornell_scene,
                              jax_scene_arrays, torch_scene_arrays)

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
RGBE_REL = 1.0 / 128.0 + 1e-3


def _camera_close(cj, ct):
    for f in ("position", "forward", "right", "up", "tan_half_fov",
              "aperture", "focus_dist"):
        np.testing.assert_allclose(getattr(ct, f).numpy(),
                                   np.asarray(getattr(cj, f)), rtol=1e-6,
                                   atol=1e-7, err_msg=f)


def _settings(s) -> dict:
    return {f.name: getattr(s, f.name) for f in dataclasses.fields(s)}


@pytest.mark.parametrize("name", ["cornell.json", "demo38.json"])
def test_load_scene_matches_jax(name):
    path = str(ROOT / "scenes" / name)
    sj, cj, stj = jsj.load_scene(path)
    st, ct, stt = tsj.load_scene(path, device="cpu")
    _assert_same(jax_scene_arrays(sj.compile()),
                 torch_scene_arrays(st.compile(device="cpu")))
    assert ct.position.device.type == "cpu"
    _camera_close(cj, ct)
    assert _settings(stt) == _settings(stj)


def _dof_env_scene(pkg, env):
    scene = cornell_scene(pkg)
    scene.set_environment_map(env)
    cam = cornell_camera(pkg, aperture=0.25, focus_dist=4.5)
    s = pkg.RenderSettings()
    s.set_resolution(24, 16)
    s.samples_per_pixel, s.seed, s.tonemap, s.gamma = 12, 7, "aces", 2.2
    return scene, cam, s


@pytest.mark.parametrize("direction", ["port_to_jax", "jax_to_port"])
def test_save_scene_across_packages(tmp_path, direction):
    """A scene with a thin lens and an environment map, saved by one
    package and loaded by the other, compiles to the same arrays (the map
    within RGBE precision) and keeps its camera and settings; the JSON
    either package writes is the same."""
    env = np.random.default_rng(3).uniform(0, 4, (8, 16, 3)).astype(
        np.float32)
    saver, loader = (tsj, jsj) if direction == "port_to_jax" else (jsj, tsj)
    src = spt_tpu_torch if direction == "port_to_jax" else spt_tpu
    scene, cam, s = _dof_env_scene(src, env)
    out = str(tmp_path / "scene.json")
    saver.save_scene(out, scene, cam, s)
    other = str(tmp_path / "other.json")
    (jsj if saver is tsj else tsj).save_scene(
        other, *_dof_env_scene(spt_tpu if src is spt_tpu_torch
                               else spt_tpu_torch, env))
    doc, doc_other = json.load(open(out)), json.load(open(other))
    doc_other["scene"]["environment"]["path"] = \
        doc["scene"]["environment"]["path"]
    assert doc == doc_other
    assert Path(out + ".envmap.hdr").read_bytes() == \
        Path(other + ".envmap.hdr").read_bytes()

    kw = {"device": "cpu"} if loader is tsj else {}
    scene2, cam2, s2 = loader.load_scene(out, **kw)
    err = np.abs(scene2.env_map - env) / np.maximum(
        env.max(-1, keepdims=True), 1e-9)
    assert float(err.max()) < RGBE_REL
    sd2 = scene2.compile(**kw)
    want = cornell_scene(spt_tpu).compile()
    got = torch_scene_arrays(sd2) if loader is tsj else jax_scene_arrays(sd2)
    _assert_same(jax_scene_arrays(want), got)
    cj = cornell_camera(spt_tpu, aperture=0.25, focus_dist=4.5)
    if loader is tsj:
        _camera_close(cj, cam2)
        assert s2.samples_per_pixel == 12 and s2.seed == 7
    else:
        for f in ("position", "forward", "aperture", "focus_dist",
                  "tan_half_fov"):
            np.testing.assert_allclose(np.asarray(getattr(cam2, f)),
                                       np.asarray(getattr(cj, f)),
                                       rtol=1e-6, atol=1e-7, err_msg=f)
    assert (s2.width, s2.height, s2.tonemap, s2.gamma) == (24, 16, "aces",
                                                            2.2)


def test_scene_file_errors_and_named_env_map(tmp_path):
    with pytest.raises(ValueError, match="unsupported object type"):
        tsj.load_scene({"scene": {"objects": [{"type": "cube"}]}})
    with pytest.raises(ValueError, match="unknown material"):
        tsj.load_scene({"scene": {"objects": [
            {"type": "sphere", "material": "nope"}]}})
    with pytest.raises(ValueError, match="unknown environment"):
        tsj.load_scene({"scene": {"environment": {"type": "wat"}}})
    env_path = str(tmp_path / "named.npy")
    np.save(env_path, np.ones((4, 8, 3), np.float32))
    doc = {"scene": {"objects": [{"type": "sphere"}],
                     "environment": {"type": "hdri", "path": env_path,
                                     "intensity": 2.0}}}
    scene, cam, _ = tsj.load_scene(doc, device="cpu")
    assert cam is None and float(scene.env_map.max()) == 2.0
    out = str(tmp_path / "named_scene.json")
    tsj.save_scene(out, scene)
    assert json.load(open(out))["scene"]["environment"]["path"] == env_path


def _image(seed=0, shape=(9, 13, 3), scale=1.0):
    r = np.random.default_rng(seed)
    img = (r.uniform(0, 1, shape) ** 3 * scale).astype(np.float32)
    img[0, :3] = 0.0
    return img


@pytest.mark.parametrize("ext", ["hdr", "exr", "png", "ppm", "npy"])
def test_writers_bytes_equal_jax(tmp_path, ext):
    """From a tensor the port writes the bytes JAX's writers write from the
    same array (an HDR range for .hdr/.exr/.npy, [0, 1.2] for the 8-bit
    formats); each reads back."""
    img = _image(scale=50.0 if ext in ("hdr", "exr", "npy") else 1.2,
                 shape=(9, 40, 3) if ext == "hdr" else (9, 13, 3))
    pj, pt = str(tmp_path / f"j.{ext}"), str(tmp_path / f"t.{ext}")
    jimage.write_image(pj, jnp.asarray(img))
    timage.write_image(pt, torch.from_numpy(img))
    assert Path(pt).read_bytes() == Path(pj).read_bytes()
    if ext == "hdr":
        back = thdr.read_hdr(pt)
        np.testing.assert_array_equal(back, jhdr.read_hdr(pj))
        err = np.abs(back - img) / np.maximum(img.max(-1, keepdims=True),
                                              1e-9)
        assert float(err.max()) < RGBE_REL
    elif ext == "exr":
        np.testing.assert_array_equal(texr.read_exr(pt), img)
        np.testing.assert_array_equal(jexr.read_exr(pt), img)
    elif ext == "npy":
        np.testing.assert_array_equal(np.load(pt), img)
    elif ext == "png":
        assert Path(pt).read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
        pure = str(tmp_path / "pure.png")
        timage._write_png_pure(pure, timage.to_uint8(img))
        jimage._write_png_pure(pj, jimage.to_uint8(img))
        assert Path(pure).read_bytes() == Path(pj).read_bytes()
    with pytest.raises(ValueError, match="unsupported"):
        timage.write_image(str(tmp_path / "x.gif"), img)


def test_to_u8_array_matches_jax():
    rgb = _image(seed=1, scale=1.3)
    rgb[1, 1] = [-0.1, 0.5, 1.0]
    got = tcolor.to_u8_array(torch.from_numpy(rgb))
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jcolor.to_u8_array(jnp.asarray(rgb))))


@pytest.mark.parametrize("tonemap,gamma,n", [("none", 1.0, 4.0),
                                             ("aces", 2.2, 3.0)])
def test_native_resolve_pack_matches_port(tonemap, gamma, n):
    if not tnd.available():
        pytest.skip("native/libdisplay.so does not load here")
    accum = (np.random.default_rng(2).gamma(1.5, 2.0, (11, 17, 3))
             .astype(np.float32))
    accum[0, 0] = 0.0
    kw = dict(exposure=1.0 if n == 4.0 else 1.7, tonemap=tonemap,
              gamma=gamma)
    f32, u32, u8 = tnd.resolve_pack(torch.from_numpy(accum), n, **kw)
    pf32 = tcolor.finalize_image(torch.from_numpy(accum), n, **kw)
    pu32 = tcolor.pack_rgba8(pf32).numpy()
    pu8 = tcolor.to_u8_array(pf32).numpy()
    if n == 4.0:
        np.testing.assert_array_equal(f32, pf32.numpy())
        np.testing.assert_array_equal(u32, pu32)
        np.testing.assert_array_equal(u8, pu8)
    else:
        np.testing.assert_allclose(f32, pf32.numpy(), atol=2e-6)
        assert np.abs(u8.astype(int) - pu8.astype(int)).max() <= 1
        np.testing.assert_array_equal((u32 >> 24) & 0xFF, u8[..., 0])
    png = tnd.encode_png(u8)
    assert png is not None and png[:8] == b"\x89PNG\r\n\x1a\n"


def _jax_tracer():
    tr = spt_tpu.create_path_tracer("jax")
    tr.set_scene(cornell_scene(spt_tpu))
    s = spt_tpu.RenderSettings()
    s.set_resolution(6, 4)
    tr.set_settings(s)
    return tr


def _port_tracer():
    tr = spt_tpu_torch.create_path_tracer("cuda", device="cpu")
    tr.set_scene(cornell_scene(spt_tpu_torch))
    s = spt_tpu_torch.RenderSettings()
    s.set_resolution(6, 4)
    tr.set_settings(s)
    return tr


def test_checkpoints_load_across_packages(tmp_path):
    accum = _image(seed=4, shape=(4, 6, 3), scale=3.0)
    # A port session's state loads into JAX's, and back.
    tp = _port_tracer()
    tp.set_state({"accum": torch.from_numpy(accum), "frame_count": 5})
    p1 = str(tmp_path / "port.npz")
    tckpt.save_render_state(p1, tp)
    tj = _jax_tracer()
    jckpt.load_render_state(p1, tj)
    assert tj.frame_count == 5
    np.testing.assert_array_equal(np.asarray(tj.get_state()["accum"]), accum)
    p2 = str(tmp_path / "jax.npz")
    jckpt.save_render_state(p2, tj)
    tp2 = _port_tracer()
    tckpt.load_render_state(p2, tp2)
    assert tp2.frame_count == 5
    got = tp2.get_state()["accum"]
    assert got.device == tp2.device and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), accum)
    # Optimizer state: the port's tensors, JAX's reader, and back.
    params = {"albedo": torch.from_numpy(accum[0]), "radii": torch.ones(3)}
    opt = {"mu_albedo": torch.zeros(6, 3), "count": torch.tensor(4)}
    p3 = str(tmp_path / "opt.npz")
    tckpt.save_optimizer_state(p3, params, opt, 9)
    jp, jo, step = jckpt.load_optimizer_state(p3)
    assert step == 9 and set(jo) == set(opt)
    np.testing.assert_array_equal(jp["albedo"], accum[0])
    jckpt.save_optimizer_state(p3, jp, jo, 10)
    tp3, to3, step = tckpt.load_optimizer_state(p3)
    assert step == 10
    np.testing.assert_array_equal(to3["count"], 4)
    np.testing.assert_array_equal(tp3["radii"], np.ones(3, np.float32))
