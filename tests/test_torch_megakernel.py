"""K1's plain version against the JAX package's megakernel and integrator.

On the CPU ``render_tiles`` runs the plain PyTorch version.  Tolerance: the
JAX suite's own bar between two implementations (tests/test_pallas.py): at
least 97% of pixels ``isclose(rtol=2e-3, atol=2e-4)`` and image means
within 1% — both consume the same counter-RNG streams, but an ulp of
difference in sin/cos can turn one path at a knife edge.  Sample chunking
composes to float-summation order (rtol 1e-6).  The kernel itself is held
against this plain version on the card by chip_smoke.py and by
tests/test_torch_cuda.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import spt_tpu
import spt_tpu_torch
from spt_tpu.engine.integrator_jax import render_megasample
from spt_tpu.kernels import megakernel as jmega
from spt_tpu_torch.kernels import megakernel as tmega
from test_torch_scene import cornell_camera, cornell_scene

W = H = 16
KW = dict(max_bounces=3, rr_depth=2, use_nee=True, use_mis=True, seed=3)


def _assert_images_agree(got, want):
    assert got.shape == want.shape and np.isfinite(got).all()
    close = np.isclose(got, want, rtol=2e-3, atol=2e-4).all(axis=-1)
    assert close.mean() >= 0.97, f"{(~close).sum()} px diverge"
    assert abs(got.mean() - want.mean()) <= 0.01 * abs(want.mean())


def test_render_tiles_matches_pallas_interpret():
    sdj = cornell_scene(spt_tpu).compile()
    sdt = cornell_scene(spt_tpu_torch).compile(device="cpu")
    cam = cornell_camera(spt_tpu_torch)
    want = np.asarray(jmega.render_tiles(sdj, cornell_camera(spt_tpu), W, H,
                                         0, 2, interpret=True, **KW))
    before = dict(tmega.LAUNCHES)
    got = tmega.render_tiles(sdt, cam, W, H, 0, 2, **KW)
    assert got.dtype == torch.float32 and got.device.type == "cpu"
    assert tmega.LAUNCHES["plain"] == before["plain"] + 1
    assert tmega.LAUNCHES["k1"] == before["k1"]
    _assert_images_agree(got.numpy(), want)
    assert want.mean() > 0.01


def test_thin_lens_matches_jax_integrator():
    kw = dict(aperture=0.15, focus_dist=4.5)
    sdj = cornell_scene(spt_tpu).compile()
    sdt = cornell_scene(spt_tpu_torch).compile(device="cpu")
    want = np.asarray(render_megasample(
        sdj, cornell_camera(spt_tpu, **kw), W, H, jnp.arange(2), dof=True,
        **KW))
    cam = cornell_camera(spt_tpu_torch, **kw)
    got = tmega.render_tiles(sdt, cam, W, H, 0, 2, **KW)   # dof auto
    _assert_images_agree(got.numpy(), want)
    pin = tmega.render_tiles(sdt, cam, W, H, 0, 2, dof=False, **KW)
    assert (pin - got).abs().max() > 1e-3


def test_sample_chunking_invariance():
    sd = cornell_scene(spt_tpu_torch).compile(device="cpu")
    cam = cornell_camera(spt_tpu_torch)
    kw = dict(KW, seed=5)
    full = tmega.render_tiles(sd, cam, W, H, 0, 4, **kw)
    parts = (tmega.render_tiles(sd, cam, W, H, 0, 2, **kw)
             + tmega.render_tiles(sd, cam, W, H, 2, 2, **kw))
    np.testing.assert_allclose(parts.numpy(), full.numpy(), rtol=1e-6,
                               atol=1e-7)


@pytest.mark.parametrize("use_nee,use_mis", [(True, True), (True, False),
                                             (False, False)])
def test_estimators_agree_in_expectation(use_nee, use_mis):
    """NEE/MIS change the noise, not the mean (Cornell, 24 spp, 8x8)."""
    sd = cornell_scene(spt_tpu_torch).compile(device="cpu")
    cam = cornell_camera(spt_tpu_torch)
    kw = dict(max_bounces=3, rr_depth=2, seed=1)
    ref = tmega.render_tiles(sd, cam, 8, 8, 0, 24, use_nee=True,
                             use_mis=True, **kw)
    img = tmega.render_tiles(sd, cam, 8, 8, 0, 24, use_nee=use_nee,
                             use_mis=use_mis, **kw)
    assert torch.isfinite(img).all()
    assert abs(float(img.mean()) / float(ref.mean()) - 1.0) < 0.35


def test_wrapper_routes_cpu_tensors_to_plain():
    sd = spt_tpu_torch.demo_scene_38_spheres().compile(capacity=64,
                                                       device="cpu")
    cam = spt_tpu_torch.Camera.look_at((0, 0, 0), (0, 0, 1), fov_degrees=90,
                                       device="cpu")
    blob, meta, lsb, static = tmega.pack_uniforms(sd, cam, 0, 3)
    assert blob.shape == (21 + 12 * 64,) and meta.dtype == torch.int32
    before = dict(tmega.LAUNCHES)
    img = tmega.megakernel_fwd(blob, meta, lsb, width=8, height=6, spp=1,
                               max_bounces=2, rr_depth=1, use_nee=True,
                               use_mis=True, sky_mode=sd.sky_mode, dof=False,
                               **static)
    assert img.shape == (6, 8, 3) and float(img.mean()) > 0.1  # sky-lit
    assert tmega.LAUNCHES == dict(before, plain=before["plain"] + 1)

