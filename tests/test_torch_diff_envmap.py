"""Environment-map skies on both training backends, against the JAX package.

Regression tests of the fault that rendered an environment map as a black
sky on every gradient path but the wavefront's (ROADMAP.md §3): an env-map
scene of at most 2048 spheres (config 5's scene cut to 160 spheres,
capacity 256, compiled without a BVH) through
``make_cuda_render_fn(engine="auto")`` (the kernel backend; the plain
versions on the CPU) and through the plain ``make_render_fn``, each held
against ``jax.grad`` of the JAX package's SoA render, which samples the
map.  tests/test_wavefront_grad.py's configuration and the JAX suite's
bars, as ``test_torch_wavefront_grad.py`` holds the wavefront: the forward
agrees with the oracle on at least 99% of pixels (``|a - b| < 1e-4 + 1e-3
|b|``), and through a loss masked to the agreeing pixels the image sum
within rtol 1e-3, materials allclose(rtol 3e-2, atol 3e-3), centres and
radii over the field's largest magnitude within atol 3e-2.  Russian
roulette starts past the last bounce, so both backends draw the same paths.
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
from spt_tpu.engine.integrator_soa import render_megasample_soa
from spt_tpu_torch.diff import cuda_diff, gradients as TG
from spt_tpu_torch.kernels import megakernel as tmega
from chip_smoke import CAM_10K, env_gradient, scene_10k

# One intra-op thread: these tests trace small tensors, where torch's
# idle OpenMP workers would only spin against the other test processes.
torch.set_num_threads(1)

CPU = "cpu"
SOA_KW = dict(max_bounces=3, rr_depth=5, use_nee=True, use_mis=True, seed=4)
W, H, SPP = 24, 16, 2
KEYS = ("albedo", "emission", "roughness", "centers", "radii")
_JAX_GRADS = {}


@pytest.fixture(scope="module")
def envmap_scenes():
    """(JAX SceneData, port SceneData, JAX image) of the 160-sphere
    env-map scene; the port's compiled without a BVH."""
    sj, st = jax_scene_10k(160), scene_10k(spt_tpu_torch, n=160)
    for s in (sj, st):
        s.set_environment_map(env_gradient(16, 32))
    sdj, sdt = sj.compile(use_bvh=True), st.compile(device=CPU)
    assert sdt.bvh is None and sdt.capacity <= cuda_diff.FUSED_GRAD_PRIM_CAP
    img = np.asarray(render_megasample_soa(
        sdj, spt_tpu.Camera.look_at(**CAM_10K), W, H, jnp.arange(SPP),
        **SOA_KW)) / SPP
    return sdj, sdt, img


def _jax_grads(sdj, mask):
    """JAX's masked loss and its gradients, once per mask."""
    key = mask.tobytes()
    if key not in _JAX_GRADS:
        camj = spt_tpu.Camera.look_at(**CAM_10K)

        def loss(p):
            sc = JG.apply_params(sdj, p)
            return jnp.sum(render_megasample_soa(
                sc, camj, W, H, jnp.arange(SPP), **SOA_KW) * mask) / SPP

        _JAX_GRADS[key] = jax.value_and_grad(loss)(JG.get_params(sdj, KEYS))
    return _JAX_GRADS[key]


@pytest.mark.parametrize("backend", ["cuda", "plain"])
def test_envmap_gradients_match_soa(envmap_scenes, backend):
    sdj, sdt, img_s = envmap_scenes
    cam = spt_tpu_torch.Camera.look_at(device=CPU, **CAM_10K)
    if backend == "cuda":
        fn = cuda_diff.make_cuda_render_fn(sdt, cam, W, H, spp=SPP,
                                           engine="auto", **SOA_KW)

        def render(p):
            return fn(p, 0)
    else:
        fn = TG.make_render_fn(sdt, cam, W, H, **SOA_KW)

        def render(p):
            return fn(p, torch.arange(SPP))
    params = {k: v.clone().requires_grad_(True)
              for k, v in TG.get_params(sdt, KEYS).items()}
    before = dict(tmega.LAUNCHES)
    img = render(params)
    runs = {k: tmega.LAUNCHES[k] - before[k] for k in before}
    # The wavefront's plain stages ran (a raygen and two a bounce), nothing
    # else: K1-K4's plain versions are one call a render.
    assert runs["plain"] >= 1 + 2 * SOA_KW["max_bounces"]
    img_w = img.detach().numpy()
    assert np.isfinite(img_w).all() and img_w.mean() > 0.05
    agree = (np.abs(img_w - img_s) < 1e-4 + 1e-3 * np.abs(img_s)).all(-1)
    assert agree.mean() >= 0.99, f"only {agree.mean():.3f} forward-agree"
    assert abs(img_w.mean() - img_s.mean()) <= 0.01 * img_s.mean()
    mask = agree[:, :, None].astype(np.float32)
    (img * torch.from_numpy(mask)).sum().backward()
    val_s, g_s = _jax_grads(sdj, mask)
    np.testing.assert_allclose(float((img_w * mask).sum()), float(val_s),
                               rtol=1e-3)
    for key in ("albedo", "emission", "roughness"):
        np.testing.assert_allclose(params[key].grad.numpy(),
                                   np.asarray(g_s[key]), rtol=3e-2,
                                   atol=3e-3, err_msg=key)
    valid = np.asarray(sdj.prim_valid)
    for key in ("centers", "radii"):
        a = params[key].grad.numpy()[valid]
        b = np.asarray(g_s[key])[valid]
        scale = np.abs(b).max() + 1e-6
        np.testing.assert_allclose(a / scale, b / scale, atol=3e-2,
                                   err_msg=key)


def test_fused_engine_refuses_envmap(envmap_scenes):
    """K1-K4 have no map to shade a miss with: ``engine="fused"`` raises
    and names it, where it used to render the sky black."""
    _, sdt, _ = envmap_scenes
    cam = spt_tpu_torch.Camera.look_at(device=CPU, **CAM_10K)
    with pytest.raises(ValueError, match="environment-map"):
        cuda_diff.make_cuda_render_fn(sdt, cam, W, H, spp=1, engine="fused")
