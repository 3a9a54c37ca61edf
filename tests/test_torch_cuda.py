"""The port's CUDA kernels on the card; every test here skips without one.

Imports neither jax nor the JAX package, so it runs on a GPU machine that
has neither.  There, from the repo root (the suite's conftest imports jax):

    python -m pytest --noconftest tests/test_torch_cuda.py -q

Tolerance: the RNG bits are equal exactly; K1 against its plain version is
held to chip_smoke.py's bar (99.9% of pixels isclose(rtol=2e-3,
atol=2e-4), means within 0.1%).  K2's image equals K1's bit for bit; its
gradient and its per-lane bounce adjoint are held to chip_smoke.py's bars
(``GRAD_REL`` / ``GRAD_ABS`` per field, ``VJP_*`` per lane).  K3 is held
to K1's bar against its plain version, and equals K1 bit for bit on
Cornell packed for the BVH walk (one leaf, the spheres in index order).
"""

import numpy as np
import pytest
import torch

import spt_tpu_torch as T
from chip_smoke import (ATOL, MAX_MEAN_REL, MIN_CLOSE, RTOL, VJP_ATOL_REL,
                        VJP_MIN_CLOSE, VJP_RTOL, cornell, grad_errors,
                        grad_scene, k3_inputs, scene_200, vjp_lanes)
from spt_tpu_torch.core import rng
from spt_tpu_torch.diff import cuda_diff, gradients as G
from spt_tpu_torch.kernels import megakernel as mk
from spt_tpu_torch.kernels import megakernel_bvh as mb
from spt_tpu_torch.kernels import megakernel_grad as mg


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def test_counter_bits_kernel_exact(cuda):
    r = np.random.default_rng(0)
    args = [torch.from_numpy(r.integers(0, 2**32, 1 << 16, dtype=np.uint64)
                             .astype(np.int64)).to(cuda) for _ in range(4)]
    assert torch.equal(mk.counter_bits_cuda(*args), rng.counter_bits(*args))


def _case(case, dev):
    if case == "demo38":
        sd = T.demo_scene_38_spheres().compile(capacity=64, device=dev)
        cam = T.Camera.look_at((0, 0, 0), (0, 0, 1), fov_degrees=90,
                               device=dev)
    else:
        sd = cornell(T).compile(device=dev)
        lens = dict(aperture=0.15, focus_dist=4.5) if case == "thin_lens" \
            else {}
        cam = T.Camera.look_at((0, 1.0, -1.5), (0, 1.0, 3.0),
                               fov_degrees=55, device=dev, **lens)
    return sd, cam


@pytest.mark.parametrize("case", ["cornell", "demo38", "thin_lens"])
def test_k1_matches_plain(cuda, case):
    sd, cam = _case(case, cuda)
    blob, meta, lsb, static = mk.pack_uniforms(sd, cam, 7, 3)
    kw = dict(width=48, height=32, spp=4, max_bounces=8, rr_depth=3,
              use_nee=True, use_mis=True, sky_mode=sd.sky_mode,
              dof=case == "thin_lens", **static)
    got = mk.megakernel_fwd(blob, meta, lsb, **kw).cpu().numpy()
    want = mk.render_tiles_plain(blob, meta, lsb, **kw).cpu().numpy()
    assert np.isfinite(got).all() and want.mean() > 0.01
    close = np.isclose(got, want, rtol=RTOL, atol=ATOL).all(axis=-1)
    assert close.mean() >= MIN_CLOSE
    assert abs(got.mean() - want.mean()) <= MAX_MEAN_REL * want.mean()


def test_facade_launches_k1(cuda):
    tr = T.create_path_tracer("cuda")
    assert tr.device.type == "cuda"
    tr.set_scene(cornell(T))
    s = T.RenderSettings()
    s.set_resolution(32, 24)
    tr.set_settings(s)
    before = dict(mk.LAUNCHES)
    tr.render()
    tr.render()
    img = tr.get_render_result().image_f32
    assert img.device.type == "cuda" and bool(torch.isfinite(img).all())
    assert mk.LAUNCHES == dict(before, k1=before["k1"] + 2)


def test_k1_rejects_what_it_cannot_take(cuda):
    sd = cornell(T).compile(device=cuda)
    cam = T.Camera.look_at((0, 1, -1.5), (0, 1, 3), device=cuda)
    blob, meta, lsb, static = mk.pack_uniforms(sd, cam, 0, 3)
    kw = dict(width=8, height=8, spp=1, max_bounces=2, rr_depth=1,
              use_nee=True, use_mis=True, sky_mode=sd.sky_mode, dof=False)
    with pytest.raises(ValueError):
        mk.megakernel_fwd(blob.double(), meta, lsb, **kw, **static)
    with pytest.raises(ValueError):
        mk.megakernel_fwd(blob, meta, lsb.cpu(), **kw, **static)
    with pytest.raises(ValueError):
        mk.megakernel_fwd(blob, meta, lsb, **kw, n_prims=256,
                          n_light_slots=1)


@pytest.mark.parametrize("k", [0, 3])
def test_bounce_vjp_kernel_matches_plain(cuda, k):
    sd = grad_scene(T).compile(device=cuda)
    cam = T.Camera.look_at((0, 1.0, -1.2), (0, 0.8, 4.0), device=cuda)
    blob, meta, lsb, static = mk.pack_uniforms(sd, cam, 0, 3)
    lanes = vjp_lanes(torch, cuda, 1 << 14, k)
    kw = dict(k=k, rr_depth=3, use_nee=True, use_mis=True,
              sky_mode=sd.sky_mode, **static)
    g_k, ct_k = mg.bounce_vjp(blob, meta, lsb, *lanes, **kw)
    g_p, ct_p = mg.bounce_vjp_plain(blob, meta, lsb, *lanes, **kw)
    a, b = ct_k.cpu().numpy(), ct_p.cpu().numpy()
    close = np.isclose(a, b, rtol=VJP_RTOL, atol=VJP_ATOL_REL
                       * np.abs(b).max(axis=1, keepdims=True)).all(0)
    assert close.mean() >= VJP_MIN_CLOSE
    errs, _ = grad_errors(g_k, g_p, static["n_prims"])
    assert all(e["ok"] for e in errs), errs


@pytest.mark.parametrize("case", ["cornell", "demo38", "thin_lens"])
def test_k2_matches_plain(cuda, case):
    sd, cam = _case(case, cuda)
    blob, meta, lsb, static = mk.pack_uniforms(sd, cam, 7, 3)
    kw = dict(width=48, height=32, spp=4, max_bounces=8, rr_depth=3,
              use_nee=True, use_mis=True, sky_mode=sd.sky_mode,
              dof=case == "thin_lens", **static)
    ct = torch.from_numpy(np.random.default_rng(0).uniform(
        0.5, 1.5, (32, 48, 3)).astype(np.float32)).to(cuda)
    before = dict(mk.LAUNCHES)
    img, gvec = mg.megakernel_grad(blob, meta, lsb, ct, **kw)
    assert mk.LAUNCHES == dict(before, k2=before["k2"] + 1)
    assert torch.equal(img, mk.megakernel_fwd(blob, meta, lsb, **kw))
    _, want = mg.render_and_grad_plain(blob, meta, lsb, ct, **kw)
    errs, _ = grad_errors(gvec, want, static["n_prims"])
    assert all(e["ok"] for e in errs), errs
    assert float(want.abs().sum()) > 0


def test_kernel_render_launches_k1_then_k2(cuda):
    sd = cornell(T).compile(device=cuda)
    cam = T.Camera.look_at((0, 1.0, -1.5), (0, 1.0, 3.0), fov_degrees=55,
                           device=cuda)
    render = cuda_diff.make_cuda_render_fn(sd, cam, 16, 16, spp=2)
    p = {k: v.clone().requires_grad_(True)
         for k, v in G.get_params(sd, cuda_diff.PARAM_KEYS).items()}
    before = dict(mk.LAUNCHES)
    render(p, 0).sum().backward()
    assert mk.LAUNCHES == dict(before, k1=before["k1"] + 1,
                               k2=before["k2"] + 1)
    assert all(bool(torch.isfinite(v.grad).all()) for v in p.values())


def test_k2_rejects_depth_above_its_cap():
    sd = cornell(T).compile(device="cpu")
    cam = T.Camera.look_at((0, 1, -1.5), (0, 1, 3), device="cpu")
    blob, meta, lsb, static = mk.pack_uniforms(sd, cam, 0, 3)
    with pytest.raises(ValueError, match="at most 16 bounces"):
        mg.megakernel_grad(blob, meta, lsb, torch.ones(4, 4, 3), width=4,
                           height=4, spp=1, max_bounces=mg.MAX_DEPTH + 1,
                           rr_depth=3, use_nee=True, use_mis=True,
                           sky_mode=sd.sky_mode, dof=False, **static)


def _scene200_camera(dev, lens):
    kw = dict(aperture=0.3, focus_dist=14.0) if lens else {}
    return T.Camera.look_at((0, 2.0, -4.0), (0, 1.0, 14.0), fov_degrees=60,
                            device=dev, **kw)


@pytest.mark.parametrize("lens", [False, True])
def test_k3_matches_plain(cuda, lens):
    sd = scene_200(T).compile(device=cuda)
    args, k3kw, _ = k3_inputs(torch, mb, sd, _scene200_camera(cuda, lens), 3)
    kw = dict(width=48, height=40, spp=4, max_bounces=8, rr_depth=3,
              use_nee=True, use_mis=True, sky_mode=sd.sky_mode, dof=lens,
              **k3kw)
    before = dict(mk.LAUNCHES)
    got = mb.megakernel_bvh_fwd(*args, **kw)
    assert mk.LAUNCHES == dict(before, k3=before["k3"] + 1)
    got = got.cpu().numpy()
    want = mb.render_tiles_bvh_plain(*args, **kw).cpu().numpy()
    assert np.isfinite(got).all() and want.mean() > 0.01
    close = np.isclose(got, want, rtol=RTOL, atol=ATOL).all(axis=-1)
    assert close.mean() >= MIN_CLOSE
    assert abs(got.mean() - want.mean()) <= MAX_MEAN_REL * want.mean()


def test_k3_equals_k1_on_cornell(cuda):
    sd, cam = _case("cornell", cuda)
    blob, meta, lsb, static = mk.pack_uniforms(sd, cam, 0, 3)
    kw = dict(width=48, height=32, spp=4, max_bounces=8, rr_depth=3,
              use_nee=True, use_mis=True, sky_mode=sd.sky_mode, dof=False)
    args, k3kw, _ = k3_inputs(torch, mb, sd, cam, 3)
    assert torch.equal(mb.megakernel_bvh_fwd(*args, **kw, **k3kw),
                       mk.megakernel_fwd(blob, meta, lsb, **kw, **static))


def test_facade_launches_k3(cuda):
    tr = T.create_path_tracer("cuda")
    tr.set_scene(scene_200(T))
    tr.set_camera(_scene200_camera(cuda, False))
    s = T.RenderSettings()
    s.set_resolution(40, 24)
    tr.set_settings(s)
    before = dict(mk.LAUNCHES)
    tr.render()
    tr.render()
    img = tr.get_render_result().image_f32
    assert img.device.type == "cuda" and bool(torch.isfinite(img).all())
    assert mk.LAUNCHES == dict(before, k3=before["k3"] + 2)
    assert tr.scene_data.capacity == 256
