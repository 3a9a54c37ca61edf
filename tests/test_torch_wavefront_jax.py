"""Whole renders of the port's plain wavefront against the JAX package's
``render_wavefront`` (its Pallas kernels in interpret mode, leaf block 8,
every sort run): tests/test_wavefront.py's 300-sphere config-5 scene at
32x32, 1 spp, depth 3, under its gradient sky and under an environment
map.  Held to the JAX suite's bar between two implementations: 97% of
pixels ``isclose(rtol=2e-3, atol=2e-4)``, means within 1%.  The two round
rsqrt, sin and cos otherwise, and each lane of the port stops its sweep at
its own nearest hit where JAX's stops a tile at once, so a path at a knife
edge may turn.  Two tests only: each JAX render takes some 20 s on a CPU.
"""

import numpy as np
import pytest
import torch

import spt_tpu
import spt_tpu_torch
from bench_suite import scene_10k as jax_scene_10k
from spt_tpu.kernels import wavefront as jwf
from spt_tpu_torch.kernels import megakernel as tmega
from spt_tpu_torch.kernels import wavefront as twf
from chip_smoke import CAM_10K, env_gradient, scene_10k

# One intra-op thread: these tests trace small tensors, where torch's
# idle OpenMP workers would only spin against the other test processes.
torch.set_num_threads(1)

KW = dict(max_bounces=3, rr_depth=2, use_nee=True, use_mis=True, seed=5)


@pytest.mark.parametrize("sky", ["gradient", "envmap"])
def test_wavefront_matches_jax(sky):
    sj, st = jax_scene_10k(300), scene_10k(spt_tpu_torch, n=300)
    if sky == "envmap":
        for s in (sj, st):
            s.set_environment_map(env_gradient(16, 32))
    want = np.asarray(jwf.render_wavefront(
        sj.compile(use_bvh=True), spt_tpu.Camera.look_at(**CAM_10K), 32, 32,
        0, 1, block=8, sort_min_rays=0, interpret=True, **KW))
    before = dict(tmega.LAUNCHES)
    got = twf.render_wavefront(
        st.compile(device="cpu"),
        spt_tpu_torch.Camera.look_at(device="cpu", **CAM_10K), 32, 32, 0, 1,
        block=8, sort_min_rays=0, **KW).numpy()
    assert tmega.LAUNCHES["plain"] > before["plain"]
    assert got.shape == want.shape and np.isfinite(got).all()
    close = np.isclose(got, want, rtol=2e-3, atol=2e-4).all(axis=-1)
    assert close.mean() >= 0.97, f"{(~close).sum()} px diverge"
    assert abs(got.mean() - want.mean()) <= 0.01 * abs(want.mean())
    assert want.mean() > 0.05
