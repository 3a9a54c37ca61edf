"""The hand-written adjoint and K2's plain version against the JAX package.

``physics_adjoint.trace_bounce_vjp`` is the plain version of K2's per-bounce
backward; its lanes are ``test_torch_adjoint.py``'s (where it is also held
against ``torch.autograd``).  The JAX side runs eagerly, and an eager JAX op
compiles once per shape, so every case here uses 256 lanes.  This file
holds few tests so that xdist, which schedules files with more tests first,
runs it after the long JAX files.  Tolerances:

* Against ``jax.vjp`` of ``spt_tpu.kernels.physics.trace_bounce``, with the
  cell-keyed light pick as K2 uses it: in float32, state cotangents
  allclose(rtol=1e-3, atol=1e-4 times the channel's largest magnitude) on
  at least 99.5% of lanes (an ulp of sin/cos between the frameworks can
  flip a knife-edge lane) and summed theta cotangents within 1e-2
  relative.
* ``render_and_grad`` against JAX's own ``render_and_grad`` (Cornell,
  16x16, 2 spp, depth 2, RR from bounce 1), whose kernel launch is replaced
  by an eager run of that kernel's body (JAX's ``_read_theta``,
  ``_raygen``, ``_uniforms`` and ``trace_bounce`` under ``jax.vjp``; the
  Pallas kernel in interpret mode takes about ten minutes): JAX's own bar
  between its kernel and its oracle (tests/test_pallas_grad.py), the image
  sum within rtol 1e-3 and every field allclose(rtol 3e-2, atol 3e-3).
* At an exact tie of the Russian-roulette clip (a glass albedo of exactly
  0.95 and a unit throughput): autograd, the adjoint and ``jax.vjp`` agree
  to float32 rounding.  ``jnp.clip`` gives a value at a bound half the
  cotangent; ``torch.clamp`` gave all of it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import spt_tpu
import spt_tpu_torch
from spt_tpu.kernels import megakernel_grad as jmg
from spt_tpu.kernels import physics as jp
from spt_tpu_torch.kernels import megakernel_grad as tmg
from spt_tpu_torch.kernels import physics as tp
from spt_tpu_torch.kernels.physics_adjoint import trace_bounce_vjp
from test_torch_adjoint import (N, RR_DEPTH, SEED, _autograd, _cfg, _lanes,
                                _scene_uniforms, _torch_args)
from test_torch_scene import cornell_camera, cornell_scene

# One intra-op thread: these tests trace small tensors, where torch's
# idle OpenMP workers would only spin against the other test processes.
torch.set_num_threads(1)


def _jax_vjp(x, cfg, dtype=jnp.float32):
    f = dtype
    theta = (tuple(tuple(f(v) for v in row) for row in x["sph"]),
             tuple(f(v) for v in x["sky"]),
             tuple(tuple(f(v) for v in row) for row in x["lights"]))
    u = {k: jnp.asarray(v, dtype) for k, v in x["uni"].items()}
    u.update(lsel_lo=tuple(f(v) for v in x["lsb"][:3]),
             lsel_ext=tuple(f(v) for v in x["lsb"][3:]),
             sample=jnp.asarray(x["sample"].astype(np.uint32)),
             seed=jnp.uint32(SEED))
    state = tuple(jnp.asarray(a, dtype) for a in x["state"])
    aux = tuple(jnp.asarray(a) for a in x["aux"])
    _, vjp_fn, _ = jax.vjp(
        lambda th, st: jp.trace_bounce(th, st, aux, u, jnp.int32(x["nl"]),
                                       cfg), theta, state, has_aux=True)
    th_ct, st_ct = vjp_fn(tuple(jnp.asarray(c, dtype) for c in x["ct"]))
    sph, sky, lights = (np.array(a, np.float64) for a in th_ct)
    return (sph, sky, lights), [np.asarray(a, np.float64) for a in st_ct]


@pytest.mark.parametrize("winner,k,use_nee,use_mis,sky_mode", [
    ("lambert", 0, True, True, spt_tpu.SKY_GRADIENT),
    ("metal", RR_DEPTH, True, False, spt_tpu.SKY_NONE),
    ("glass", RR_DEPTH, False, False, spt_tpu.SKY_GRADIENT)])
def test_vjp_matches_jax(winner, k, use_nee, use_mis, sky_mode):
    x = _lanes(winner, sky_mode, seed=21 + k)
    kw = (k, use_nee, use_mis, sky_mode)
    jax_out = _jax_vjp(x, _cfg(jp, x, *kw))
    theta, state, aux, u, ct = _torch_args(x)
    th_ct, st_ct = trace_bounce_vjp(theta, state, aux, u, x["nl"],
                                    _cfg(tp, x, *kw), ct)
    (sph, sky, lights), want = jax_out
    ok = np.ones(N, bool)
    for c, (a, b) in enumerate(zip(st_ct, want)):
        close = np.isclose(a.numpy(), b, rtol=1e-3,
                           atol=1e-4 * np.abs(b).max())
        assert close.mean() >= 0.995, f"state channel {c}"
        ok &= close
    assert ok.mean() >= 0.995
    for a, b in zip(th_ct, (sph, sky, lights)):
        assert np.abs(a.numpy() - b).sum() <= 1e-2 * max(np.abs(b).sum(),
                                                          1e-30)
    assert np.abs(sph).sum() > 0


def _tie_scene(pkg):
    """tests/test_pallas_grad.py's scene: its glass albedo is exactly 0.95."""
    scene = pkg.Scene()
    scene.set_sky(pkg.SKY_NONE)
    white = scene.add_material("lambert", albedo=(0.7, 0.65, 0.6))
    lamp = scene.add_material("lambert", albedo=(0.8,) * 3,
                              emission=(11.0,) * 3)
    metal = scene.add_material("metal", albedo=(0.85, 0.85, 0.9),
                               roughness=0.3)
    glass = scene.add_material("glass", albedo=(0.95,) * 3, ior=1.5)
    scene.create_sphere("floor", (0, -1000, 4), 1000.0, white)
    scene.create_sphere("lamp", (0, 2.8, 4), 0.7, lamp)
    scene.create_sphere("m", (-0.6, 0.6, 4.0), 0.6, metal)
    scene.create_sphere("g", (0.7, 0.5, 3.6), 0.5, glass)
    return scene


def test_russian_roulette_tie_matches_jax():
    """Refracted lanes of unit throughput through glass of albedo 0.95 at
    k >= rr_depth: p_cont = clip(max(0.95, 0.95, 0.95), 0.05, 0.95) sits
    exactly on the upper bound."""
    x = _scene_uniforms(_tie_scene(spt_tpu_torch))
    r = np.random.default_rng(7)
    n = N
    c = x["sph"][3, :3]
    o = np.stack([r.uniform(-0.2, 0.6, n), r.uniform(0.6, 1.0, n),
                  np.zeros(n)])
    d = c[:, None] + r.normal(size=(3, n)) * 0.1 - o
    d /= np.linalg.norm(d, axis=0)
    ones, zeros = np.ones(n), np.zeros(n)
    x.update(state=[a.astype(np.float32) for a in
                    (*o, *d, ones, ones, ones, zeros, zeros, zeros, ones)],
             aux=[np.ones(n, bool), np.zeros(n, bool)],
             uni=dict(rr=np.full(n, 0.01, np.float32),
                      lobe=np.full(n, 0.99, np.float32),
                      **{k: r.random(n).astype(np.float32)
                         for k in ("u1", "u2", "lu1", "lu2")}),
             sample=r.integers(0, 2**32, n, dtype=np.uint64).astype(np.int64),
             ct=r.normal(size=(13, n)).astype(np.float32))
    kw = (RR_DEPTH, True, True, spt_tpu.SKY_NONE)
    (sph_j, _, _), st_j = _jax_vjp(x, _cfg(jp, x, *kw))
    theta, state, aux, u, ct = _torch_args(x, grad=True)
    cfg = _cfg(tp, x, *kw)
    out, new_aux = tp.trace_bounce(theta, state, aux, u, x["nl"], cfg)
    assert bool(new_aux[0].all())            # every lane refracted on
    assert torch.equal(out[6], torch.full((n,), 0.95 / np.float32(0.95)))
    auto = _autograd(theta, state, aux, u, x["nl"], cfg, ct)
    hand_th, hand_st = trace_bounce_vjp(
        tuple(a.detach() for a in theta), tuple(a.detach() for a in state),
        aux, u, x["nl"], cfg, ct)
    for got in (auto[0], hand_th[0]):
        np.testing.assert_allclose(got[3, 4:7].numpy(), sph_j[3, 4:7],
                                   rtol=1e-4)
    for c_ in (6, 7, 8):                     # throughput channels
        for got in (auto[3 + c_], hand_st[c_]):
            np.testing.assert_allclose(got.numpy(), st_j[c_], rtol=1e-4,
                                       atol=1e-6)


def _eager_launch_grad(blob, meta, lsb, ct, *, width, height, spp, n_prims,
                       n_light_slots, mtypes, max_bounces, rr_depth, use_nee,
                       use_mis, sky_mode, dof=False, interpret=False):
    """JAX's K2 computed eagerly: its kernel body's own functions, one
    ``jax.vjp`` of the whole render with respect to the blob.  The blob is
    handed over as a tuple of scalars, indexed as the kernel indexes its
    SMEM copy (an eager index into an array would compile once per
    offset)."""
    meta = np.asarray(meta)
    n_pix = width * height
    pix = jnp.arange(n_pix, dtype=jnp.int32)
    px, py, pid = pix % width, pix // width, pix.astype(jnp.uint32)
    seed, nl = jnp.uint32(meta[1]), jnp.int32(meta[2])
    ct_pix = jnp.asarray(ct).reshape(3, -1)[:, :n_pix]
    lsb_t = tuple(jnp.float32(v) for v in np.asarray(lsb))

    def render(b):
        theta, _ = jmg._read_theta(meta, b, n_prims, n_light_slots)
        img, loss = jnp.zeros((3, n_pix), jnp.float32), jnp.float32(0.0)
        for s in range(spp):
            sample = jnp.full(pid.shape, meta[0] + s, jnp.uint32)
            o_d = jmg._raygen(b, pid, px, py, sample, seed, width, height,
                              dof=dof)
            one, zero = jnp.ones(n_pix), jnp.zeros(n_pix)
            state = (*o_d, one, one, one, zero, zero, zero, zero)
            aux = (jnp.ones(n_pix, bool), jnp.ones(n_pix, bool))
            for k in range(max_bounces):
                cfg = jp.BounceCfg(
                    mtypes=mtypes, k=k, rr_depth=rr_depth, use_nee=use_nee,
                    use_mis=use_mis, sky_mode=sky_mode,
                    n_light_slots=n_light_slots)
                state, aux = jp.trace_bounce(
                    theta, state, aux,
                    jmg._uniforms(pid, sample, seed, k, lsb_t), nl, cfg)
            rad = jnp.stack(state[9:12])
            img, loss = img + rad, loss + jnp.sum(ct_pix * rad)
        return loss, img

    scalars = tuple(jnp.float32(v) for v in np.asarray(blob))
    _, vjp_fn, img = jax.vjp(render, scalars, has_aux=True)
    (d_blob,) = vjp_fn(jnp.float32(1.0))
    d_blob = np.array([float(v) for v in d_blob], np.float32)
    gvec = np.concatenate([d_blob[21:], d_blob[15:21]])
    return img.T.reshape(height, width, 3), jnp.asarray(gvec)


def test_render_and_grad_matches_jax(monkeypatch):
    monkeypatch.setattr(jmg, "_launch_grad", _eager_launch_grad)
    kw = dict(max_bounces=2, rr_depth=1, use_nee=True, use_mis=True, seed=3)
    img_j, g_j = jmg.render_and_grad(cornell_scene(spt_tpu).compile(),
                                     cornell_camera(spt_tpu), 16, 16, 0, 2,
                                     **kw)
    sd = cornell_scene(spt_tpu_torch).compile(device="cpu")
    cam = cornell_camera(spt_tpu_torch)
    img_t, g_t = tmg.render_and_grad(sd, cam, 16, 16, 0, 2, **kw)
    np.testing.assert_allclose(float(img_t.sum()), float(jnp.sum(img_j)),
                               rtol=1e-3)
    assert set(g_t) == set(g_j)
    for key in g_j:
        np.testing.assert_allclose(g_t[key].numpy(), np.asarray(g_j[key]),
                                   rtol=3e-2, atol=3e-3, err_msg=key)
    assert float(g_t["albedo"].abs().sum()) > 0
