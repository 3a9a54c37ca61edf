"""The port's reference integrator, BVH walk and occupancy against the
JAX package's (few tests: the JAX side compiles its walk and its SoA
integrator).

Tolerances: the reference RNG's seeds and draws equal bit for bit; images
at the JAX parity bar (``tests/test_reference_parity.py``): every value
within 2e-3 and 99.5% of pixels within 1e-4 on every channel; the BVH walk
finds JAX's hit ids (but at exact t-ties, none in these cases) and its t
within 2e-6 relative (a few ulp: one of 155 hits differs by 1.3e-6, the
two frameworks' CPU code rounding the quadratic otherwise); occupancy
within 0.01 a bounce.
"""

import jax.numpy as jnp
import numpy as np
import torch

import spt_tpu
import spt_tpu_torch
from chip_smoke import scene_200
from spt_tpu.core import rng as jrng
from spt_tpu.core.bvh import intersect_bvh as j_intersect_bvh
from spt_tpu.engine.integrator_jax import render_reference_sample as j_ref
from spt_tpu.utils.profiling import measure_occupancy as j_occupancy
from spt_tpu_torch.core import rng as trng
from spt_tpu_torch.core.bvh import intersect_bvh as t_intersect_bvh
from spt_tpu_torch.engine.integrator import render_reference_sample as t_ref
from spt_tpu_torch.utils.profiling import measure_occupancy as t_occupancy
from test_torch_scene import cornell_camera, cornell_scene

torch.set_num_threads(1)


def parity(got, want):
    """The JAX parity bar: allclose atol 2e-3, 99.5% of pixels within
    1e-4."""
    np.testing.assert_allclose(got, want, atol=2e-3, rtol=0)
    close = np.all(np.abs(got - want) < 1e-4, axis=-1).mean()
    assert close > 0.995, close


def single_sphere(pkg):
    scene = pkg.Scene()
    scene.create_sphere("s", (0.0, -1.0, 5.0), 1.0)
    scene.create_sphere("ground", (0.0, -102.0, 5.0), 100.0)
    return scene


def test_reference_sample_matches_jax():
    """Single sphere and demo38 at 16x16, frames 0 and 3; the seeds and
    the first draws of the reference RNG equal JAX's bit for bit."""
    w = h = 16
    px = np.tile(np.arange(w, dtype=np.uint32), h)
    py = np.repeat(np.arange(h, dtype=np.uint32), w)
    for frame in (0, 3):
        sj = jrng.ref_seed(jnp.asarray(px), jnp.asarray(py), jnp.uint32(w),
                           jnp.uint32(frame + 1))
        st = trng.ref_seed(torch.from_numpy(px.astype(np.int64)),
                           torch.from_numpy(py.astype(np.int64)), w,
                           frame + 1)
        for _ in range(3):
            np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
            sj, uj = jrng.ref_next(sj)
            st, ut = trng.ref_next(st)
            np.testing.assert_array_equal(ut.numpy(), np.asarray(uj))
    for build in (single_sphere, lambda pkg: pkg.demo_scene_38_spheres()):
        sdj = build(spt_tpu).compile()
        sdt = build(spt_tpu_torch).compile(device="cpu")
        for frame in (0, 3):
            got = t_ref(sdt, w, h, frame)
            assert got.shape == (h, w, 3) and got.dtype == torch.float32
            parity(got.numpy(), np.asarray(j_ref(sdj, w, h, frame)))


def test_reference_bvh_route_and_walk_match_jax():
    """A 200-sphere scene compiled with a tree: one reference frame at 8x8
    through the walk, and ``intersect_bvh`` on 256 random rays."""
    sdj = scene_200(spt_tpu).compile(use_bvh=True)
    sdt = scene_200(spt_tpu_torch).compile(use_bvh=True, device="cpu")
    assert sdt.bvh is not None and sdt.bvh.n_nodes == sdj.bvh.n_nodes
    parity(t_ref(sdt, 8, 8, 0).numpy(), np.asarray(j_ref(sdj, 8, 8, 0)))

    r = np.random.default_rng(0)
    o = r.uniform(-10, 10, (256, 3)).astype(np.float32)
    o[:, 2] -= 5.0
    d = r.normal(size=(256, 3)).astype(np.float32)
    d[:, 2] = np.abs(d[:, 2]) + 0.5
    tj, hj = j_intersect_bvh(jnp.asarray(o), jnp.asarray(d), sdj.centers,
                             sdj.radii, sdj.bvh)
    o_t = torch.from_numpy(o).requires_grad_(True)
    tt, ht = t_intersect_bvh(o_t, torch.from_numpy(d), sdt.centers,
                             sdt.radii, sdt.bvh)
    hj, tj = np.asarray(hj), np.asarray(tj)
    assert ht.dtype == torch.int32 and 0 < int((ht >= 0).sum()) < 256
    np.testing.assert_array_equal(ht.numpy(), hj)
    hit = hj >= 0
    np.testing.assert_allclose(tt.detach().numpy()[hit], tj[hit], rtol=2e-6)
    assert np.isinf(tt.detach().numpy()[~hit]).all()
    # t is recomputed from the winner's quadratic: autograd reaches the rays.
    torch.where(ht >= 0, tt, 0.0).sum().backward()
    assert bool(torch.isfinite(o_t.grad).all()) and bool(
        (o_t.grad[torch.from_numpy(hit)] != 0).any())


def test_measure_occupancy_matches_jax():
    """Cornell at 16x16 x 4 spp, depth 3: the wavefront's alive lanes a
    bounce against JAX's SoA integrator's active lanes."""
    kw = dict(spp=4, max_bounces=3, rr_depth=1, seed=3)
    want = j_occupancy(cornell_scene(spt_tpu).compile(),
                       cornell_camera(spt_tpu), 16, 16, **kw)
    got = t_occupancy(cornell_scene(spt_tpu_torch).compile(device="cpu"),
                      cornell_camera(spt_tpu_torch), 16, 16, **kw)
    assert len(got) == 3 and got[0] == 1.0
    assert all(a >= b for a, b in zip(got, got[1:])) and got[-1] < 1.0
    np.testing.assert_allclose(got, want, atol=0.01, rtol=0)
