"""The port's fused bounce and matmul-form sweeps against the JAX package.

Whole renders and gradients of the port's plain versions against JAX's
Pallas kernels in interpret mode (leaf block 8, every sort run):

* ``render_wavefront(split=False)``, the plain K11 against JAX's fused
  bounce (``_bounce_kernel``), and ``render_wavefront(mxu=True)``, the
  plain K6m and K7m against JAX's (``_isect_kernel_mxu``,
  ``_shade_kernel_mxu``), on tests/test_wavefront.py's 300-sphere config-5
  scene at 32x32, 1 spp, depth 2.  The JAX suite's bar between two
  implementations: 97% of pixels ``isclose(rtol=2e-3, atol=2e-4)``, means
  within 1%.  The two round rsqrt, sin and cos otherwise, and the port's
  lanes stop their sweeps on their own where JAX's stop a tile at once.
* ``make_wavefront_render_fn(split=False)``, the plain K11g forward and K10
  backward, against JAX's fused ``_bounce_op`` under ``jax.grad`` on
  tests/test_wavefront_grad.py's 160-sphere scene (24x16, 1 spp, depth 1:
  a bounce's record of its winner and shadow verdict, replayed; the port
  holds the fused gradient equal to the split one at depth 3 in
  ``test_torch_wavefront_fused.py``), at test_torch_diff_envmap.py's bars: the forward agrees on 99%
  of pixels (``|a - b| < 1e-4 + 1e-3 |b|``), and through a loss masked to
  those the value within rtol 1e-3, materials allclose(rtol 3e-2, atol
  3e-3), centres and radii within atol 3e-2 of the field's largest value.
* Padding winners: on rays that JAX's raygen makes for both packages (the
  port fed JAX's stream), at depth 1, a ray whose winner is a leaf's
  padding slot takes the sky on JAX's split bounce and on the port's, and
  adds nothing on JAX's fused bounce and on the port's (JAX's fused rule:
  a hit with no material).  Which rays win padding slots depends on the
  order the sweeps stop in, so the two packages' sets may differ.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import spt_tpu
import spt_tpu_torch
from bench_suite import scene_10k as jax_scene_10k
from spt_tpu.diff import gradients as JG
from spt_tpu.kernels import megakernel_bvh as jmbvh
from spt_tpu.kernels import physics as jphys
from spt_tpu.kernels import wavefront as jwf
from spt_tpu.kernels import wavefront_grad as jwg
from spt_tpu_torch.diff import gradients as TG
from spt_tpu_torch.kernels import megakernel as tmega
from spt_tpu_torch.kernels import wavefront as twf
from spt_tpu_torch.kernels import wavefront_grad as twg
from chip_smoke import CAM_10K, PAD_CAM, padding_scene, scene_10k

# One intra-op thread: these tests trace small tensors, where torch's
# idle OpenMP workers would only spin against the other test processes.
torch.set_num_threads(1)

KW = dict(max_bounces=2, rr_depth=2, use_nee=True, use_mis=True, seed=5)
GRAD_KW = dict(max_bounces=1, rr_depth=5, use_nee=True, use_mis=True, seed=4)
KEYS = ("albedo", "emission", "roughness", "centers", "radii")


@pytest.mark.parametrize("mode", ["fused", "mxu"])
def test_render_matches_jax(mode):
    opts = dict(split=False) if mode == "fused" else dict(mxu=True)
    want = np.asarray(jwf.render_wavefront(
        jax_scene_10k(300).compile(use_bvh=True),
        spt_tpu.Camera.look_at(**CAM_10K), 32, 32, 0, 1, block=8,
        sort_min_rays=0, interpret=True, **opts, **KW))
    before = dict(tmega.LAUNCHES)
    got = twf.render_wavefront(
        scene_10k(spt_tpu_torch, n=300).compile(device="cpu"),
        spt_tpu_torch.Camera.look_at(device="cpu", **CAM_10K), 32, 32, 0, 1,
        block=8, sort_min_rays=0, **opts, **KW).numpy()
    assert tmega.LAUNCHES["plain"] > before["plain"]
    assert got.shape == want.shape and np.isfinite(got).all()
    close = np.isclose(got, want, rtol=2e-3, atol=2e-4).all(axis=-1)
    assert close.mean() >= 0.97, f"{(~close).sum()} px diverge"
    assert abs(got.mean() - want.mean()) <= 0.01 * abs(want.mean())
    assert want.mean() > 0.05


def test_fused_grad_matches_jax():
    sdj = jax_scene_10k(160).compile(use_bvh=True)
    sdt = scene_10k(spt_tpu_torch, n=160).compile(device="cpu")
    w, h = 24, 16
    render = twg.make_wavefront_render_fn(
        sdt, spt_tpu_torch.Camera.look_at(device="cpu", **CAM_10K), w, h,
        spp=1, split=False, sort_min_rays=0, **GRAD_KW)
    params = {k: v.clone().requires_grad_(True)
              for k, v in TG.get_params(sdt, KEYS).items()}
    img = render(params, 0)
    rj = jwg.make_wavefront_render_fn(
        sdj, spt_tpu.Camera.look_at(**CAM_10K), w, h, spp=1, split=False,
        block=8, sort_min_rays=0, interpret=True, **GRAD_KW)
    img_j, vjp = jax.vjp(lambda p: rj(p, 0), JG.get_params(sdj, KEYS))
    img_w, img_j = img.detach().numpy(), np.asarray(img_j)
    assert np.isfinite(img_w).all() and img_w.mean() > 0.01
    agree = (np.abs(img_w - img_j) < 1e-4 + 1e-3 * np.abs(img_j)).all(-1)
    assert agree.mean() >= 0.99, f"only {agree.mean():.3f} forward-agree"
    mask = agree[:, :, None].astype(np.float32)
    (img * torch.from_numpy(mask)).sum().backward()
    (g_j,) = vjp(jnp.broadcast_to(jnp.asarray(mask), img_j.shape))
    np.testing.assert_allclose(float((img_w * mask).sum()),
                               float((img_j * mask).sum()), rtol=1e-3)
    for key in ("albedo", "emission", "roughness"):
        np.testing.assert_allclose(params[key].grad.numpy(),
                                   np.asarray(g_j[key]), rtol=3e-2,
                                   atol=3e-3, err_msg=key)
    valid = np.asarray(sdj.prim_valid)
    for key in ("centers", "radii"):
        a = params[key].grad.numpy()[valid]
        b = np.asarray(g_j[key])[valid]
        scale = np.abs(b).max() + 1e-6
        np.testing.assert_allclose(a / scale, b / scale, atol=3e-2,
                                   err_msg=key)


def test_padding_winners_follow_jax():
    sdj = padding_scene(spt_tpu).compile(use_bvh=True)
    # Looking at the origin from off its axes, JAX's raygen makes rays that
    # win the padding slots there (PAD_CAM's make few).
    camj = spt_tpu.Camera.look_at(**dict(PAD_CAM, position=(0.5, 0.5, -5.0)))
    blob, meta3, nodef, nodei, prims, static = jmbvh._packed(sdj, camj, 8)
    t = {k: torch.from_numpy(np.array(v)) for k, v in
         (("blob", blob), ("nodef", nodef), ("nodei", nodei),
          ("prims", prims))}
    t["lsb"] = torch.from_numpy(np.array(jphys.lsel_bounds_from_prims(prims)))
    t["mtypes"] = torch.tensor(static["mtypes"], dtype=torch.int32)
    meta = [0, 5, int(meta3[2])]
    kw = dict(KW, max_bounces=1)
    del kw["seed"]

    def jax_raygen(_blob, _meta, *, width, height, chunk_spp, dof):
        st_j, ids_j, _ = jwf._raygen_launch(
            jnp.asarray(meta, jnp.int32), blob, width=width, height=height,
            chunk_spp=chunk_spp, dof=dof, interpret=True)
        st, ids = twf._new_stream(np.asarray(ids_j).size // 2, "cpu")
        st.copy_(torch.from_numpy(np.array(st_j).reshape(twf.N_CH, -1)))
        ids.copy_(torch.from_numpy(np.array(ids_j).reshape(2, -1)))
        return st, ids

    images = {}
    for split in (True, False):
        images["port", split] = twf._launch_wavefront(
            t, static, None, torch.tensor(meta, dtype=torch.int32), width=16,
            height=16, chunk_spp=1, sky_mode=sdj.sky_mode, dof=False,
            compact=True, sort_min_rays=0, split=split, precull=True,
            mxu=False, stages=(jax_raygen,) + twf.PLAIN[1:], times=None,
            **kw).numpy()
        images["jax", split] = np.asarray(jwf._launch_wavefront(
            blob, jnp.asarray(meta, jnp.int32),
            jphys.lsel_bounds_from_prims(prims), nodef, nodei, prims,
            jnp.zeros((1, 1, 3), jnp.float32), width=16, height=16,
            chunk_spp=1, block=8, n_mats=static["n_mats"],
            mtypes=static["mtypes"], n_light_slots=static["n_light_slots"],
            sky_mode=sdj.sky_mode, dof=False, split=split, dir_major=True,
            sort_min_rays=0, interpret=True, **kw))
    for pkg in ("port", "jax"):
        split, fused = images[pkg, True], images[pkg, False]
        padding = (split != fused).any(-1)
        assert padding.sum() > 0, pkg
        # Every other pixel is the same; a padding winner's pixel is the
        # sky on the split bounce and unlit on the fused one.
        assert (split[padding] > 0).all() and (fused[padding] == 0).all()
