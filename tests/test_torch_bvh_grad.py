"""The BVH gradient's plain versions against the JAX package: the traceable
packers, the rebuilt-winner adjoint and the plain K4.

Tolerances:

* ``pack_blob_torch``, ``pack_prims_torch`` and ``refit_nodef_torch`` are
  bit-equal to JAX's ``pack_blob_jnp``, ``pack_prims_jnp`` and
  ``refit_nodef_jnp`` (the same gathers, min and max); the packers'
  gradients equal ``jax.vjp``'s to rtol 1e-6 (a gather's transpose adds a
  prim's cotangents in another order).  An ior exactly at the packer's
  floor 1.001 takes half its cotangent in both.
* The rebuilt-winner adjoint (``physics_adjoint.rebuilt_bounce_vjp``) on
  256 lanes against ``jax.vjp`` of JAX's bounce on ``_rebuilt_intersect``
  with a saved shadow verdict, at tests/test_torch_grad.py's bar: state
  and winner cotangents allclose(rtol 1e-3, atol 1e-4 times the channel's
  largest magnitude) on at least 99.5% of lanes, and the summed sky,
  material and light cotangents within 1e-2 relative.
* The plain K4 against JAX's K4 in interpret mode (its own minimal case:
  the 40-sphere scene of tests/test_pallas_bvh_grad.py, 8x8, 1 spp, leaf
  block 8, depth 2; about 30 s) and against ``jax.grad`` of the SoA oracle
  (``integrator_soa.render_megasample_soa``; 16x16, 1 spp, depth 3, the
  160-sphere config-5 scene of tests/test_wavefront_grad.py, so that the
  oracle takes its BVH path): the JAX suite's bars, image sum within rtol
  1e-3, materials allclose(rtol 3e-2, atol 3e-3), centres and radii over
  the field's largest magnitude within atol 3e-2.

The JAX side runs eagerly (and compiles once per shape), so this file holds
few tests; the card's kernels are held against these plain versions by
tests/test_torch_cuda.py and chip_smoke.py.
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
from spt_tpu.kernels import megakernel_bvh as jmb
from spt_tpu.kernels import megakernel_bvh_grad as jmbg
from spt_tpu.kernels import physics as jp
from spt_tpu_torch.core.convert import (camera_from_arrays,
                                        scene_data_from_arrays)
from spt_tpu_torch.diff import cuda_diff, gradients as TG
from spt_tpu_torch.kernels import megakernel as tmega
from spt_tpu_torch.kernels import megakernel_bvh as tmb
from spt_tpu_torch.kernels import megakernel_bvh_grad as tmbg
from spt_tpu_torch.kernels import physics as tp
from spt_tpu_torch.kernels.physics_adjoint import rebuilt_bounce_vjp
from chip_smoke import (CAM_10K, PAD_CAM, padding_scene, scene_10k,
                         scene_200 as big_scene)
from test_torch_bvh import big_camera

# One intra-op thread: these tests trace small tensors, where torch's
# idle OpenMP workers would only spin against the other test processes.
torch.set_num_threads(1)

CPU = "cpu"
N = 256
KEYS = ("albedo", "emission", "roughness", "centers", "radii")


def _both(block=tmb.BLOCK):
    """The 202-sphere scene and its packing in both packages."""
    sdj = big_scene(spt_tpu).compile()
    sdt = big_scene(spt_tpu_torch).compile(device=CPU)
    camj = big_camera(spt_tpu, aperture=0.2, focus_dist=9.0)
    camt = _camera(camj)
    static_j = jmb._packed(sdj, camj, block)[5]
    static_t = tmb.packed(sdt, camt, block)[1]
    return (sdj, camj, static_j), (sdt, camt, static_t)


def _camera(cam):
    """The port's camera from a JAX camera's arrays (their look_at may
    round tan(fov/2) one ulp apart)."""
    return camera_from_arrays({f: np.asarray(getattr(cam, f)) for f in (
        "position", "forward", "right", "up", "tan_half_fov", "aperture",
        "focus_dist")}, device=CPU)


def _perturbed(sd, pkg_arrays):
    """Parameter arrays (numpy) of the scene with moved centres and radii
    and one material's ior exactly at the packer's floor."""
    r = np.random.default_rng(8)
    p = {k: np.array(v, np.float32) for k, v in pkg_arrays.items()}
    p["centers"] = p["centers"] + r.normal(size=p["centers"].shape).astype(
        np.float32) * 0.3
    p["radii"] = p["radii"] * np.float32(1.1)
    p["ior"][0] = np.float32(1.001)
    return p


@pytest.mark.parametrize("packer", ["blob", "prims", "refit"])
def test_packers_bit_equal_and_gradients_match_jax(packer):
    (sdj, camj, sj), (sdt, camt, st) = _both()
    p0 = JG.get_params(sdj, KEYS + ("ior",))
    p = _perturbed(sdj, {k: np.asarray(v) for k, v in p0.items()})

    def jax_fn(params):
        sc = JG.apply_params(sdj, params)
        if packer == "blob":
            return jmb.pack_blob_jnp(sc, camj, sj)
        if packer == "prims":
            return jmb.pack_prims_jnp(sc, sj)
        return jmb.refit_nodef_jnp(sc, sj)

    pt = {k: torch.from_numpy(v.copy()).requires_grad_(True)
          for k, v in p.items()}
    sc = TG.apply_params(sdt, pt)
    got = {"blob": lambda: tmb.pack_blob_torch(sc, camt, st),
           "prims": lambda: tmb.pack_prims_torch(sc, st),
           "refit": lambda: tmb.refit_nodef_torch(sc, st)}[packer]()
    want, vjp_fn = jax.vjp(jax_fn, {k: jnp.asarray(v) for k, v in p.items()})
    np.testing.assert_array_equal(got.detach().numpy().view(np.uint32),
                                  np.asarray(want).view(np.uint32))
    if packer == "refit":
        assert not got.requires_grad       # culling data: detached
        assert not np.array_equal(np.asarray(want), np.asarray(
            jmb.refit_nodef_jnp(sdj, sj)))
        return
    ct = np.random.default_rng(3).normal(size=got.shape).astype(np.float32)
    (g_jax,) = vjp_fn(jnp.asarray(ct))
    got.backward(torch.from_numpy(ct))
    for k in p:
        a, b = pt[k].grad, np.asarray(g_jax[k])
        a = np.zeros_like(b) if a is None else a.numpy()
        np.testing.assert_allclose(a, b, rtol=1e-6,
                                   atol=1e-6 * max(np.abs(b).max(), 1e-30),
                                   err_msg=k)
    if packer == "blob":
        assert np.asarray(g_jax["ior"])[0] != 0.0


def _winner_lanes(seed):
    """256 lanes of bounce-entry states aimed at random prims of the
    202-sphere scene, each with its winner record (a tenth recorded as
    misses) and a random shadow verdict, plus the scene's packed sky,
    material table and light slots."""
    (sdj, camj, sj), (sdt, camt, st) = _both()
    t, _ = tmb.packed(sdt, camt)
    blob = t["blob"].numpy()
    n_mats, n_l = st["n_mats"], st["n_light_slots"]
    off = tmb._MAT_OFF
    mats = blob[off:off + 8 * n_mats].reshape(n_mats, 8)
    lights = blob[off + 8 * n_mats:off + 8 * n_mats + 7 * n_l].reshape(n_l, 7)
    r = np.random.default_rng(seed)
    valid = np.nonzero(sdt.prim_valid.numpy())[0]
    j = r.choice(valid, N)
    c = sdt.centers.numpy()[j].T.astype(np.float64)
    rad = sdt.radii.numpy()[j].astype(np.float64)
    away = r.normal(size=(3, N))
    away /= np.linalg.norm(away, axis=0)
    o = c + away * (rad + r.uniform(0.3, 3.0, N))
    tgt = c + r.normal(size=(3, N)) * 0.45 * rad
    d = tgt - o
    d /= np.linalg.norm(d, axis=0)
    hmid = sdt.mat_id.numpy()[j].astype(np.float32)
    miss = r.random(N) < 0.1
    hmid[miss] = -1.0
    res = np.zeros((8, N), np.float32)
    res[0:3] = np.where(miss, 0.0, c)
    res[3] = np.where(miss, 0.0, rad)
    res[4] = hmid
    res[7] = r.random(N) < 0.3
    th = r.uniform(0.2, 1.0, (3, N))
    rad_in = r.uniform(0.0, 1.0, (3, N))
    prev_pdf = np.where(r.random(N) < 0.2, 0.0, r.uniform(0.0, 2.0, N))
    lsb = tp.lsel_bounds(sdt.centers, sdt.radii, sdt.prim_valid).numpy()
    return dict(
        sky=blob[15:21], mats=mats, lights=lights, lsb=lsb,
        mtypes=tuple(st["mtypes"]), nl=n_l, res=res,
        state=[a.astype(np.float32) for a in (*o, *d, *th, *rad_in,
                                              prev_pdf)],
        aux=[r.random(N) < 0.9, r.random(N) < 0.3],
        uni={k: r.random(N).astype(np.float32)
             for k in ("rr", "u1", "u2", "lobe", "lu1", "lu2")},
        sample=r.integers(0, 2**32, N, dtype=np.uint64).astype(np.int64),
        ct=r.normal(size=(13, N)).astype(np.float32))


@pytest.mark.parametrize("k,use_mis", [(0, True), (3, False)])
def test_rebuilt_adjoint_matches_jax(k, use_mis):
    x = _winner_lanes(30 + k)
    seed = 3
    cfg_kw = dict(k=k, rr_depth=2, use_nee=True, use_mis=use_mis,
                  sky_mode=spt_tpu.SKY_GRADIENT, n_light_slots=x["nl"])
    f32 = jnp.float32
    res = x["res"]
    blocked = jnp.asarray(res[7] > 0.5)
    u = {kk: jnp.asarray(v) for kk, v in x["uni"].items()}
    u.update(lsel_lo=tuple(f32(v) for v in x["lsb"][:3]),
             lsel_ext=tuple(f32(v) for v in x["lsb"][3:]),
             sample=jnp.asarray(x["sample"].astype(np.uint32)),
             seed=jnp.uint32(seed))
    aux = tuple(jnp.asarray(a) for a in x["aux"])
    cfg = jp.BounceCfg(mtypes=(), **cfg_kw)

    def f(theta2, st):
        sky_t, mats_t, lights_t, cx, cy, cz, rr = theta2
        ifn = jmbg._rebuilt_intersect(mats_t, x["mtypes"], cx, cy, cz, rr,
                                      jnp.asarray(res[4]))
        return jp.trace_bounce(((), sky_t, lights_t), st, aux, u,
                               jnp.int32(x["nl"]), cfg, intersect_fn=ifn,
                               occluded_fn=lambda *a: blocked)

    theta2 = (tuple(f32(v) for v in x["sky"]),
              tuple(tuple(f32(v) for v in row) for row in x["mats"]),
              tuple(tuple(f32(v) for v in row) for row in x["lights"]),
              *(jnp.asarray(res[a]) for a in range(4)))
    state = tuple(jnp.asarray(a) for a in x["state"])
    _, vjp_fn, _ = jax.vjp(f, theta2, state, has_aux=True)
    th_ct, st_ct = vjp_fn(tuple(jnp.asarray(c) for c in x["ct"]))

    tu = {kk: torch.from_numpy(v) for kk, v in x["uni"].items()}
    lsb = torch.from_numpy(x["lsb"])
    tu.update(lsel_lo=tuple(lsb[:3]), lsel_ext=tuple(lsb[3:]),
              sample=torch.from_numpy(x["sample"]), seed=seed)
    sky_ct, mats_ct, lights_ct, dgeo, got_st = rebuilt_bounce_vjp(
        torch.from_numpy(x["sky"]), torch.from_numpy(x["mats"]),
        torch.tensor(x["mtypes"]), torch.from_numpy(x["lights"]),
        torch.from_numpy(res), tuple(torch.from_numpy(a) for a in x["state"]),
        tuple(torch.from_numpy(a) for a in x["aux"]), tu, x["nl"],
        tp.BounceCfg(mtypes=(), **cfg_kw),
        tuple(torch.from_numpy(c) for c in x["ct"]))
    ok = np.ones(N, bool)
    for a, b in zip([*got_st, *dgeo], [*st_ct, *th_ct[3:7]]):
        a, b = a.numpy(), np.asarray(b, np.float64)
        close = np.isclose(a, b, rtol=1e-3, atol=1e-4 * np.abs(b).max())
        assert close.mean() >= 0.995
        ok &= close
    assert ok.mean() >= 0.995
    for a, b in ((sky_ct, th_ct[0]), (mats_ct, th_ct[1]),
                 (lights_ct, th_ct[2])):
        b = np.asarray(b, np.float64).reshape(a.shape)
        assert np.abs(a.numpy() - b).sum() <= 1e-2 * max(np.abs(b).sum(),
                                                          1e-30)
    assert np.abs(dgeo.numpy()).sum() > 0 and np.abs(mats_ct.numpy()).sum() > 0


def _assert_grads_match(img_sum, grads, val_ref, g_ref, valid):
    """The JAX suite's bars between its K4 and its oracle."""
    np.testing.assert_allclose(img_sum, float(val_ref), rtol=1e-3)
    for key in ("albedo", "emission", "roughness"):
        np.testing.assert_allclose(grads[key].numpy(), np.asarray(g_ref[key]),
                                   rtol=3e-2, atol=3e-3, err_msg=key)
    for key in ("centers", "radii"):
        a = grads[key].numpy()[valid]
        b = np.asarray(g_ref[key])[valid]
        scale = np.abs(b).max() + 1e-6
        np.testing.assert_allclose(a / scale, b / scale, atol=3e-2,
                                   err_msg=key)


def test_plain_k4_matches_jax_k4_interpret():
    """The port's K4 wrapper (its plain version here) against JAX's K4 in
    interpret mode on the same packed inputs, output by output: the image,
    the scalar gradients (sky, material rows, light slots) and the leaf
    slots' geometry gradients, before any mapping to parameters."""
    from test_pallas_bvh_grad import CAM, _scene
    sdj = _scene(40).compile()
    w = h = 8
    kw = dict(width=w, height=h, spp=1, block=8, max_bounces=2, rr_depth=5,
              use_nee=True, use_mis=True, sky_mode=sdj.sky_mode, dof=False)
    ct_img = np.random.default_rng(5).uniform(0.5, 1.5, (h, w, 3)) \
        .astype(np.float32)
    blob, meta3, nodef, nodei, prims, sj = jmb._packed(sdj, CAM, 8)
    meta = np.asarray([0, 4, int(meta3[2])], np.int32)
    img_j, gs_j, gg_j = jmbg._launch_bvh_grad(
        blob, jnp.asarray(meta), jp.lsel_bounds_from_prims(prims), nodef,
        nodei, prims, jmbg.swizzle_ct(ct_img, w, h), n_mats=sj["n_mats"],
        mtypes=sj["mtypes"], n_light_slots=sj["n_light_slots"],
        interpret=True, **kw)
    sdt = scene_data_from_arrays(
        {k: np.asarray(v) for k, v in _scene_arrays(sdj).items()},
        num_prims=sdj.num_prims, num_lights=sdj.num_lights,
        sky_mode=sdj.sky_mode, device=CPU)
    t, st = tmb.packed(sdt, _camera(CAM), 8)
    for name, a in (("blob", blob), ("nodef", nodef), ("nodei", nodei),
                    ("prims", prims)):
        np.testing.assert_array_equal(t[name].numpy(), np.asarray(a),
                                      err_msg=name)
    img_t, gs_t, gg_t = tmbg.megakernel_bvh_grad(
        t["blob"], torch.from_numpy(meta), t["lsb"], t["nodef"], t["nodei"],
        t["prims"], t["mtypes"],
        tmbg.swizzle_ct(torch.from_numpy(ct_img), w, h),
        n_mats=st["n_mats"], n_light_slots=st["n_light_slots"], **kw)
    img_j, gs_j, gg_j = (np.asarray(a) for a in (img_j, gs_j, gg_j))
    np.testing.assert_allclose(float(img_t.sum()), float(img_j.sum()),
                               rtol=1e-3)
    np.testing.assert_allclose(gs_t.numpy(), gs_j, rtol=3e-2, atol=3e-3)
    a, b = gg_t[:, :4].numpy(), gg_j[:, :4]
    scale = np.abs(b).max() + 1e-6
    np.testing.assert_allclose(a / scale, b / scale, atol=3e-2)
    assert float(img_t.sum()) > 0 and np.abs(gs_j).sum() > 0 \
        and np.abs(b).sum() > 0


def _scene_arrays(sd):
    from test_torch_scene import jax_scene_arrays
    return jax_scene_arrays(sd)


def test_plain_k4_matches_soa_oracle():
    """The render InverseRenderer takes for 129-2048 spheres
    (``make_cuda_render_fn``: K3 forward, K4 backward, the raw gradients
    carried to the parameters by autograd through the packers) against
    ``jax.grad`` of the SoA oracle."""
    kw = dict(max_bounces=3, rr_depth=5, use_nee=True, use_mis=True, seed=4)
    w = h = 16
    sdj = jax_scene_10k(160).compile(use_bvh=True)
    camj = spt_tpu.Camera.look_at(**CAM_10K)
    params = JG.get_params(sdj, KEYS)

    def loss(p):
        sc = JG.apply_params(sdj, p)
        return jnp.sum(render_megasample_soa(sc, camj, w, h, jnp.arange(1),
                                             **kw))

    val_ref, g_ref = jax.value_and_grad(loss)(params)
    sdt = scene_10k(spt_tpu_torch, n=160).compile(device=CPU)
    camt = spt_tpu_torch.Camera.look_at(device=CPU, **CAM_10K)
    assert 128 < sdt.capacity <= 2048
    render = cuda_diff.make_cuda_render_fn(sdt, camt, w, h, spp=1,
                                           engine="fused", **kw)
    pt = {k: v.clone().requires_grad_(True)
          for k, v in TG.get_params(sdt, KEYS).items()}
    before = dict(tmega.LAUNCHES)
    img = render(pt, 0)
    img.sum().backward()
    assert tmega.LAUNCHES["plain"] == before["plain"] + 2   # plain K3, K4
    _assert_grads_match(float(img.detach().sum()), {k: p.grad for k, p in pt.items()},
                        val_ref, g_ref, np.asarray(sdj.prim_valid))


def test_plain_k4_padding_winners():
    """Rays that win a leaf's padding slot (centre 0, radius 0: the float
    quadratic finds a ray through the origin): the plain K4 gives them
    K1's invalid row, as the plain K3 does (the image bit for bit), and
    no geometry gradient to any padding slot."""
    sd = padding_scene(spt_tpu_torch).compile(device=CPU)
    cam = spt_tpu_torch.Camera.look_at(device=CPU, **PAD_CAM)
    t, st = tmb.packed(sd, cam)
    meta = torch.tensor([0, 4, st["n_light_slots"]], dtype=torch.int32)
    w = h = 16
    kw = dict(width=w, height=h, spp=1, block=st["block"],
              n_mats=st["n_mats"], n_light_slots=st["n_light_slots"],
              max_bounces=2, rr_depth=5, use_nee=True, use_mis=True,
              sky_mode=sd.sky_mode, dof=False)
    args = (t["blob"], meta, t["lsb"], t["nodef"], t["nodei"], t["prims"],
            t["mtypes"])
    ct = tmbg.swizzle_ct(torch.from_numpy(np.random.default_rng(6).uniform(
        0.5, 1.5, (h, w, 3)).astype(np.float32)), w, h)
    stats = {}
    img, gs, gg = tmbg.render_and_grad_bvh_plain(*args, ct, **kw,
                                                 stats=stats)
    assert stats["padding_winners"] > 0
    assert torch.equal(img, tmb.render_tiles_bvh_plain(*args, **kw))
    pad = t["prims"].reshape(-1, 5, st["block"])[:, 4, :] < 0
    assert float(gg[:, :4].abs().sum(1)[pad].sum()) == 0.0
    assert bool(torch.isfinite(gs).all() and torch.isfinite(gg).all())
    assert float(gg.abs().sum()) > 0 and float(gs.abs().sum()) > 0
