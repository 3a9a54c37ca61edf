"""``parallel.sharding`` and ``render_and_grad_bvh`` against the JAX
package's.

The five sharded renders on two spawned gloo ranks (``tools/dist_worker``,
the plain versions of the kernels the facade's route takes: K1 for this
scene, and K5-K8 and K7b in the ring) against JAX's same functions on the
suite's virtual CPU devices (``make_render_mesh(data=2)`` or ``(data=1,
prim=2)``; JAX renders through its oracle ``render_megasample``):
tests/test_sharding.py's scene, camera and options, 16x16, sample ids 0
and 1.  Held to the JAX suite's bar between two implementations: 97% of
pixels ``isclose(rtol=2e-3, atol=2e-4)``, means within 1%
(tests/test_torch_megakernel.py); the two round rsqrt, sin and cos
otherwise, so a path at a knife edge may turn.

``render_and_grad_bvh`` (the plain K4 here) against JAX's in interpret
mode on tests/test_pallas_bvh_grad.py's 40-sphere scene (8x8, 1 spp, leaf
block 8, depth 2; about 30 s): the image's sum within 1e-3 and each of
the seven gradient fields within 1% relative L2.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spt_tpu.kernels import megakernel_bvh_grad as jmbg
from spt_tpu.parallel import sharding as JS
from spt_tpu.parallel.mesh import make_render_mesh
from spt_tpu_torch.core.convert import (camera_from_arrays,
                                        scene_data_from_arrays)
from spt_tpu_torch.core.scene import SKY_ENVMAP
from spt_tpu_torch.kernels import megakernel_bvh_grad as tmbg
from spt_tpu_torch.tools import dist_worker
from test_sharding import CAM, KW, _scene
from test_torch_scene import jax_scene_arrays

# One intra-op thread: these tests trace small tensors, where torch's
# idle OpenMP workers would only spin against the other test processes.
torch.set_num_threads(1)

CPU = "cpu"
W = H = 16
IDS = (0, 1)
MESHES = {"pixel": dict(data=2, prim=1), "sample": dict(data=2, prim=1),
          "prim_gather": dict(data=1, prim=2),
          "prim_ring": dict(data=1, prim=2),
          "prim_auto": dict(data=1, prim=2)}


def _port(sdj, camj):
    """The port's scene and camera from JAX's arrays (their look_at may
    round tan(fov/2) one ulp apart)."""
    sd = scene_data_from_arrays(
        {k: np.asarray(v) for k, v in jax_scene_arrays(sdj).items()},
        num_prims=sdj.num_prims, num_lights=sdj.num_lights,
        sky_mode=sdj.sky_mode, device=CPU)
    cam = camera_from_arrays({f: np.asarray(getattr(camj, f)) for f in (
        "position", "forward", "right", "up", "tan_half_fov", "aperture",
        "focus_dist")}, device=CPU)
    return sd, cam


@pytest.fixture(scope="module")
def port_images():
    """Each render on two gloo ranks: name -> rank 0's image."""
    sd, cam = _port(_scene().compile(), CAM)
    cases = [dict(case=name, scene="s", width=W, height=H, spp=len(IDS),
                  start=IDS[0], kw=KW, **mesh)
             for name, mesh in MESHES.items()]
    reports = dist_worker.launch(cases, 2, scenes={"s": (sd, cam)},
                                 backend="gloo", device=CPU, timeout=240.0)
    return {c["case"]: r["image"] for c, r in zip(cases, reports)}


def _jax(name):
    sd = _scene().compile()
    mesh = make_render_mesh(**MESHES[name])
    ids = jnp.asarray(IDS)
    if name == "sample":
        return JS.render_sample_sharded(sd, CAM, W, H, 1, mesh, **KW)
    fn = {"pixel": JS.render_pixel_sharded,
          "prim_gather": JS.render_prim_sharded_gather,
          "prim_ring": JS.render_prim_sharded_ring,
          "prim_auto": JS.render_prim_sharded}[name]
    return fn(sd, CAM, W, H, ids, mesh, **KW)


@pytest.mark.parametrize("name", list(MESHES))
def test_sharded_render_matches_jax(port_images, name):
    want = np.asarray(_jax(name))
    got = port_images[name]
    assert got.shape == want.shape == (H, W, 3) and np.isfinite(got).all()
    close = np.isclose(got, want, rtol=2e-3, atol=2e-4).all(axis=-1)
    assert close.mean() >= 0.97, f"{(~close).sum()} px diverge"
    assert abs(got.mean() - want.mean()) <= 0.01 * abs(want.mean())
    assert want.mean() > 0.05


def test_render_and_grad_bvh_matches_jax():
    from test_pallas_bvh_grad import CAM as BCAM, _scene as bvh_scene
    sdj = bvh_scene(40).compile()
    kw = dict(max_bounces=2, rr_depth=5, seed=4, block=8)
    ct = np.random.default_rng(5).uniform(0.5, 1.5, (8, 8, 3)) \
        .astype(np.float32)
    img_j, g_j = jmbg.render_and_grad_bvh(sdj, BCAM, 8, 8, 0, 1,
                                          ct_image=ct, interpret=True, **kw)
    sd, cam = _port(sdj, BCAM)
    img_t, g_t = tmbg.render_and_grad_bvh(sd, cam, 8, 8, 0, 1,
                                          ct_image=torch.from_numpy(ct), **kw)
    np.testing.assert_allclose(float(img_t.sum()), float(np.sum(img_j)),
                               rtol=1e-3)
    assert sorted(g_t) == sorted(g_j)
    for key, want in g_j.items():
        want = np.asarray(want, np.float64)
        got = g_t[key].double().numpy()
        assert got.shape == want.shape, key
        err = np.linalg.norm(got - want)
        assert err <= 1e-2 * np.linalg.norm(want) + 1e-6, \
            (key, err, np.linalg.norm(want))
    assert np.abs(np.asarray(g_j["centers"])).sum() > 0
    # K3 and K4 have no environment map: such a scene raises (JAX's K4
    # drops the map).
    with pytest.raises(ValueError, match="environment"):
        tmbg.render_and_grad_bvh(
            dataclasses.replace(sd, sky_mode=SKY_ENVMAP,
                                env_map=torch.ones(4, 8, 3)), cam, 8, 8, 0, 1)
