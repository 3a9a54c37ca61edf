"""K3's plain version against brute force, the JAX package and K1's.

* The per-lane walk's nearest winner and distance equal a brute-force
  nearest over every valid sphere (same quadratic, strict ``<``), and its
  any-hit equals brute-force occlusion, exactly, on 4,096 random rays.
* The render against ``integrator_jax.render_megasample`` (the oracle that
  tests/test_pallas_bvh.py holds JAX's K3 against): that suite's bar, at
  least 97% of pixels ``isclose(rtol=2e-3, atol=2e-4)`` and means within
  1%; the two walk in another order and round sin/cos otherwise, so a path
  at a knife edge may turn.
* Sample chunking composes to float-summation order (rtol 1e-6).
* Cornell packed for the BVH path renders bit for bit as the plain K1: the
  same bounce code, and one leaf holds all eight spheres in index order.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import spt_tpu
import spt_tpu_torch
from spt_tpu.engine.integrator_jax import render_megasample
from spt_tpu_torch.kernels import megakernel as tmega
from spt_tpu_torch.kernels import megakernel_bvh as tmbvh
from spt_tpu_torch.kernels import physics as tphys
from test_torch_bvh import big_camera, big_scene
from test_torch_scene import cornell_camera, cornell_scene

# One intra-op thread: these tests trace small tensors, where torch's
# idle OpenMP workers would only spin against the other test processes.
torch.set_num_threads(1)

CPU = "cpu"
KW = dict(max_bounces=3, rr_depth=2, seed=3)


def _assert_images_agree(got, want):
    assert got.shape == want.shape and np.isfinite(got).all()
    close = np.isclose(got, want, rtol=2e-3, atol=2e-4).all(axis=-1)
    assert close.mean() >= 0.97, f"{(~close).sum()} px diverge"
    assert abs(got.mean() - want.mean()) <= 0.01 * abs(want.mean())


def _walk(sd, cam, block=tmbvh.BLOCK):
    t, static = tmbvh.packed(sd, cam, block)
    walk = tmbvh._Walk(t["nodef"], t["nodei"].long(), t["prims"], block)
    return walk, static


def _random_rays(n, seed):
    r = np.random.default_rng(seed)
    o = np.stack([r.uniform(-9, 9, n), r.uniform(-1, 6, n),
                  r.uniform(5, 23, n)]).astype(np.float32)
    d = r.normal(size=(3, n))
    d = (d / np.linalg.norm(d, axis=0)).astype(np.float32)
    return (tuple(torch.from_numpy(a) for a in o),
            tuple(torch.from_numpy(a) for a in d))


def test_walk_nearest_and_anyhit_match_brute_force():
    sd = big_scene(spt_tpu_torch).compile(device=CPU)
    walk, static = _walk(sd, big_camera(spt_tpu_torch))
    o, d = _random_rays(4096, 11)
    spheres = torch.cat([sd.centers, sd.radii[:, None]], 1)[sd.prim_valid]
    ids = torch.nonzero(sd.prim_valid)[:, 0]
    tj, ok = tphys._sphere_t(spheres, *o, *d)
    t_bf, j_bf = torch.where(ok, tj, tphys.BIG).min(dim=0)

    active = torch.ones(4096, dtype=torch.bool)
    t, win, nodes, spheres_tested = walk.nearest(o, d, active)
    found = t < tphys.BIG
    assert 0.2 < float(found.float().mean()) < 1.0
    torch.testing.assert_close(t, t_bf, rtol=0, atol=0)
    prim = torch.from_numpy(static["block_prim_ids"].reshape(-1))[
        torch.clamp_min(win, 0)]
    assert torch.equal(prim[found], ids[j_bf][found])
    assert 0 < nodes < 4096 * static["n_nodes"]
    # Sphere tests count a hit leaf's filled slots: each valid sphere fills
    # one slot, and no leaf's padding counts.
    assert int(walk.filled.sum()) == int(sd.prim_valid.sum())
    assert 0 < spheres_tested < nodes * static["block"]

    tmax = torch.from_numpy(np.random.default_rng(12).uniform(
        0.5, 20.0, 4096).astype(np.float32))
    need = torch.from_numpy(np.random.default_rng(13).random(4096) < 0.8)
    blocked, _, _ = walk.anyhit(o, d, tmax, need)
    want = (ok & (tj < tmax)).any(dim=0) & need
    assert torch.equal(blocked, want)
    assert 0.1 < float(want.float().mean()) < 0.9


@pytest.mark.parametrize("use_nee,use_mis", [(True, True), (False, False)])
def test_render_matches_jax_integrator(use_nee, use_mis):
    sdj = big_scene(spt_tpu).compile()
    sdt = big_scene(spt_tpu_torch).compile(device=CPU)
    assert sdt.capacity > tmega.MAX_PRIMS
    kw = dict(KW, use_nee=use_nee, use_mis=use_mis)
    want = np.asarray(render_megasample(sdj, big_camera(spt_tpu), 16, 16,
                                        jnp.arange(2), **kw))
    before = dict(tmega.LAUNCHES)
    got = tmbvh.render_tiles_bvh(sdt, big_camera(spt_tpu_torch), 16, 16, 0,
                                 2, **kw)
    assert tmega.LAUNCHES == dict(before, plain=before["plain"] + 1)
    _assert_images_agree(got.numpy(), want)
    assert want.mean() > 0.05


@pytest.mark.parametrize("case", ["ragged", "thin_lens"])
def test_render_matches_jax_integrator_ragged_and_lens(case):
    lens = dict(aperture=0.3, focus_dist=14.0) if case == "thin_lens" else {}
    w, h = (40, 24) if case == "ragged" else (16, 16)
    sdj = big_scene(spt_tpu, 150, seed=4).compile()
    sdt = big_scene(spt_tpu_torch, 150, seed=4).compile(device=CPU)
    want = np.asarray(render_megasample(
        sdj, big_camera(spt_tpu, **lens), w, h, jnp.arange(2),
        dof=bool(lens), **KW))
    got = tmbvh.render_tiles_bvh(sdt, big_camera(spt_tpu_torch, **lens), w,
                                 h, 0, 2, **KW)                # dof auto
    assert got.shape == (h, w, 3)
    _assert_images_agree(got.numpy(), want)


def test_sample_chunking_invariance():
    sd = big_scene(spt_tpu_torch, 140, seed=5).compile(device=CPU)
    cam = big_camera(spt_tpu_torch)
    kw = dict(KW, seed=5)
    full = tmbvh.render_tiles_bvh(sd, cam, 8, 8, 0, 4, **kw)
    parts = (tmbvh.render_tiles_bvh(sd, cam, 8, 8, 0, 2, **kw)
             + tmbvh.render_tiles_bvh(sd, cam, 8, 8, 2, 2, **kw))
    np.testing.assert_allclose(parts.numpy(), full.numpy(), rtol=1e-6,
                               atol=1e-7)


def test_cornell_through_the_bvh_equals_plain_k1():
    sd = cornell_scene(spt_tpu_torch).compile(device=CPU)
    cam = cornell_camera(spt_tpu_torch)
    kw = dict(max_bounces=4, rr_depth=2, seed=7)
    _, static = tmbvh.packed(sd, cam)
    assert static["n_blocks"] == 1
    assert list(static["block_prim_ids"][0, :8]) == list(range(8))
    k3 = tmbvh.render_tiles_bvh(sd, cam, 16, 12, 3, 2, **kw)
    k1 = tmega.render_tiles(sd, cam, 16, 12, 3, 2, **kw)
    assert float(k1.mean()) > 0.01
    assert torch.equal(k3, k1)


def test_facade_takes_plain_k3_on_the_cpu():
    tr = spt_tpu_torch.create_path_tracer("cuda", device=CPU)
    tr.set_scene(big_scene(spt_tpu_torch, 200))
    tr.set_camera(big_camera(spt_tpu_torch))
    s = spt_tpu_torch.RenderSettings()
    s.set_resolution(8, 8)
    s.samples_per_pixel, s.max_bounces, s.progressive = 2, 2, False
    tr.set_settings(s)
    before = dict(tmega.LAUNCHES)
    tr.render()
    img = tr.get_render_result().image_f32
    assert tmega.LAUNCHES == dict(before, plain=before["plain"] + 1)
    assert tr.scene_data.capacity == 256
    assert bool(torch.isfinite(img).all()) and float(img.max()) > 0.05
