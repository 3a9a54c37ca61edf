"""The prim-sharded wavefront against the JAX package's.

``parallel.wavefront_prim.render_wavefront_prim_sharded`` on two spawned
gloo ranks (``tools/dist_worker``, the plain versions of K5, K6, K8 and K7)
against JAX's ``render_wavefront_prim_sharded`` on a (data=1, prim=2) mesh
of the suite's virtual CPU devices (its Pallas kernels in interpret mode):
tests/test_wavefront.py's 300-sphere config-5 scene, leaf block 8, 32x32,
1 spp, depth 3.  Held to the JAX suite's bar between two implementations:
97% of pixels ``isclose(rtol=2e-3, atol=2e-4)``, means within 1%.  The two
round rsqrt, sin and cos otherwise, so a path at a knife edge may turn.
One test only: JAX's prim-sharded render takes some 20 s on a CPU.
"""

import numpy as np
import torch

import spt_tpu
import spt_tpu_torch
from bench_suite import scene_10k as jax_scene_10k
from spt_tpu.parallel import wavefront_prim as jwp
from spt_tpu.parallel.mesh import make_render_mesh
from spt_tpu_torch.tools import dist_worker
from chip_smoke import CAM_10K, scene_10k

# One intra-op thread: these tests trace small tensors, where torch's
# idle OpenMP workers would only spin against the other test processes.
torch.set_num_threads(1)

KW = dict(max_bounces=3, rr_depth=2, use_nee=True, use_mis=True, seed=5)


def test_prim_sharded_matches_jax():
    want = np.asarray(jwp.render_wavefront_prim_sharded(
        jax_scene_10k(300).compile(use_bvh=True),
        spt_tpu.Camera.look_at(**CAM_10K), 32, 32, 0, 1,
        make_render_mesh(data=1, prim=2), block=8, interpret=True, **KW))
    sd = scene_10k(spt_tpu_torch, n=300).compile(device="cpu")
    cam = spt_tpu_torch.Camera.look_at(device="cpu", **CAM_10K)
    rep, = dist_worker.launch(
        [dict(case="prim_forward", data=1, prim=2, scene="s300", width=32,
              height=32, spp=1, kw=dict(KW, block=8, sort_min_rays=0))],
        2, scenes={"s300": (sd, cam)}, backend="gloo", device="cpu",
        timeout=240.0)
    got = rep["image"]
    assert rep["launches"]["plain"] == 2 * (1 + 3 * KW["max_bounces"])
    assert got.shape == want.shape and np.isfinite(got).all()
    close = np.isclose(got, want, rtol=2e-3, atol=2e-4).all(axis=-1)
    assert close.mean() >= 0.97, f"{(~close).sum()} px diverge"
    assert abs(got.mean() - want.mean()) <= 0.01 * abs(want.mean())
    assert want.mean() > 0.05
