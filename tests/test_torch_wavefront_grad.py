"""The differentiable wavefront's plain versions against the JAX package.

* Against ``jax.grad`` of the SoA oracle (``integrator_soa.
  render_megasample_soa``) on tests/test_wavefront_grad.py's configuration:
  the 160-sphere config-5 scene, 24x16, 2 spp, depth 3, RR from bounce 5,
  seed 4, every sort run; under its gradient sky and under an environment
  map.  The JAX suite's bars: the forward agrees with the oracle on at
  least 99% of pixels (``|a - b| < 1e-4 + 1e-3 |b|``), and through a loss
  masked to the agreeing pixels the image sum within rtol 1e-3, materials
  allclose(rtol 3e-2, atol 3e-3), centres and radii over the field's
  largest magnitude within atol 3e-2.  (A knife-edge hit can take another
  valid path in the two estimators; its gradient differs with it.)
* The sort under autograd is a permutation: its backward gives every lane
  its own cotangent back, bit for bit.
* The forward equals the forward wavefront's (``render_wavefront``) bit for
  bit: K9 is K7 on a copy, recording the shadow verdict.
* Lanes whose winner is a padding slot: K9 (plain) shades them as K7 does,
  bit for bit, and K10 (plain) gives them no geometry cotangent.
* K9's shadow rays walking the tree (the split path's) give the verdicts
  and state of its sweep of the shadow lists, bit for bit, and with
  centres among the parameters the walks take the refit tree: a sphere
  moved out of every leaf box is seen, the value and gradients are the
  fused render's over lists culled from the moved spheres.
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
from spt_tpu_torch.diff import gradients as TG
from spt_tpu_torch.kernels import megakernel as tmega
from spt_tpu_torch.kernels import wavefront as twf
from spt_tpu_torch.kernels import wavefront_grad as twg
from chip_smoke import (CAM_10K, PAD_CAM, env_gradient, padding_scene,
                         scene_10k, wf_bounce, wf_inputs)

# One intra-op thread: these tests trace small tensors, where torch's
# idle OpenMP workers would only spin against the other test processes.
torch.set_num_threads(1)

CPU = "cpu"
SOA_KW = dict(max_bounces=3, rr_depth=5, use_nee=True, use_mis=True, seed=4)
W, H, SPP = 24, 16, 2
KEYS = ("albedo", "emission", "roughness", "centers", "radii")


def _scenes(sky):
    sj, st = jax_scene_10k(160), scene_10k(spt_tpu_torch, n=160)
    if sky == "envmap":
        for s in (sj, st):
            s.set_environment_map(env_gradient(16, 32))
    return sj.compile(use_bvh=True), st.compile(device=CPU)


def _camera():
    return spt_tpu_torch.Camera.look_at(device=CPU, **CAM_10K)


@pytest.mark.parametrize("sky", ["gradient", "envmap"])
def test_wavefront_grad_matches_soa(sky):
    sdj, sdt = _scenes(sky)
    camj = spt_tpu.Camera.look_at(**CAM_10K)
    render = twg.make_wavefront_render_fn(sdt, _camera(), W, H, spp=SPP,
                                          sort_min_rays=0, **SOA_KW)
    params = {k: v.clone().requires_grad_(True)
              for k, v in TG.get_params(sdt, KEYS).items()}
    before = dict(tmega.LAUNCHES)
    img = render(params, 0)
    assert tmega.LAUNCHES["plain"] > before["plain"]
    img_s = np.asarray(render_megasample_soa(
        sdj, camj, W, H, jnp.arange(SPP), **SOA_KW)) / SPP
    img_w = img.detach().numpy()
    assert np.isfinite(img_w).all() and img_w.mean() > 0.01
    agree = (np.abs(img_w - img_s) < 1e-4 + 1e-3 * np.abs(img_s)).all(-1)
    assert agree.mean() >= 0.99, f"only {agree.mean():.3f} forward-agree"
    mask = agree[:, :, None].astype(np.float32)
    (img * torch.from_numpy(mask)).sum().backward()

    def loss(p):
        sc = JG.apply_params(sdj, p)
        return jnp.sum(render_megasample_soa(sc, camj, W, H, jnp.arange(SPP),
                                             **SOA_KW) * mask) / SPP

    val_s, g_s = jax.value_and_grad(loss)(JG.get_params(sdj, KEYS))
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


@pytest.mark.parametrize("prefix", [False, True])
def test_sort_backward_is_exact(prefix):
    """``_sort_rays_diff`` of a live stream (the first tile dead, so the
    sort moves lanes), on the whole stream or on its first half: each
    lane's cotangent comes back to the lane it came from, unchanged."""
    sd = scene_10k(spt_tpu_torch, n=160).compile(device=CPU)
    t, static = twf.packed(sd, _camera())
    meta = torch.tensor([0, 4, static["n_light_slots"]], dtype=torch.int32)
    st, ids = twf.raygen_plain(t["blob"], meta, width=64, height=32,
                               chunk_spp=2, dof=False)
    st = st.clone()
    st[twf.C_ALIVE, :twf.TILE] = 0.0
    st.requires_grad_(True)
    lanes = st.shape[1] // 2 if prefix else st.shape[1]
    lo, ext = twf._scene_sort_bounds(t["nodef"])
    out, ids_s, nalive = twg._sort_rays_diff(st, ids, lanes, lo, ext)
    # 64x32 is two tiles an image: 2 spp and a pad tile make five, tile 0
    # dead; the first half holds tile 1 and half of tile 2 alive.
    assert nalive == (2 if prefix else 3)
    order = ids_s[1].long() * (1 << 20) + ids_s[0].long()
    assert not torch.equal(ids_s, ids)      # the sort moved lanes
    ct = torch.from_numpy(np.random.default_rng(6).normal(
        size=tuple(st.shape)).astype(np.float32))
    out.backward(ct)
    # Where each output lane came from: match the (sample, pixel) keys.
    src = {int(k): i for i, k in enumerate(
        (ids[1].long() * (1 << 20) + ids[0].long()).tolist())}
    perm = torch.tensor([src[int(k)] for k in order.tolist()])
    assert torch.equal(out.detach(), st.detach()[:, perm])
    want = torch.zeros_like(ct).index_copy_(1, perm, ct)
    assert torch.equal(st.grad.view(torch.int32), want.view(torch.int32))


def test_forward_equals_forward_wavefront():
    """The differentiable render's image is the forward wavefront's, bit
    for bit, under the environment map (whose step is taken out of place
    here and in place there)."""
    _, sdt = _scenes("envmap")
    cam = _camera()
    render = twg.make_wavefront_render_fn(sdt, cam, W, H, spp=SPP,
                                          sort_min_rays=0, **SOA_KW)
    with torch.no_grad():
        got = render({}, 0)
    want = twf.render_wavefront(sdt, cam, W, H, 0, SPP, sort_min_rays=0,
                                **SOA_KW) * (1.0 / SPP)
    assert torch.equal(got, want) and float(want.mean()) > 0.01


def test_padding_winners_take_no_gradient():
    """Lanes whose nearest hit is a leaf's padding slot (centre 0, radius
    0: the float quadratic finds rays through the origin) keep the
    wavefront's rule under the gradient: K6 stores ``hmid = -1`` with the
    slot's block, K9 (plain) shades them as the sky, as K7 does, and K10
    (plain) gives them no geometry cotangent."""
    sd = padding_scene(spt_tpu_torch).compile(device=CPU)
    cam = spt_tpu_torch.Camera.look_at(device=CPU, **PAD_CAM)
    t, stc, meta = wf_inputs(torch, twf, twf, sd, cam, 4)
    b0 = wf_bounce(torch, twf, t, stc, meta, 16, 16, 0, 4)
    n, res = b0["n"], b0["res"]
    padding = ((res[4] < 0) & (res[5] >= 0))[:n]
    assert int(padding.sum()) > 0
    st, ids = b0["buf"][:twf.N_CH], b0["buf"][twf.N_CH:].view(torch.int32)
    kw = dict(k=0, n_mats=stc["n_mats"], n_light_slots=stc["n_light_slots"],
              rr_depth=5, use_nee=True, use_mis=True, sky_mode=sd.sky_mode)
    args = (t["blob"], meta, t["lsb"], t["prims"], t["mtypes"], b0["scand"],
            b0["sctn"])
    out, blocked = twg.shade_fwd_plain(*args, st, ids, res, n,
                                       block=stc["block"], **kw)
    st7 = st.clone()
    twf.shade_plain(*args, st7, ids, res, n, block=stc["block"], **kw)
    assert torch.equal(out[:, :n].view(torch.int32),
                       st7[:, :n].view(torch.int32))
    res8 = res.clone()
    res8[7] = blocked
    ct = torch.from_numpy(np.random.default_rng(7).normal(
        size=tuple(st.shape)).astype(np.float32))
    din, dgeo, dscal = twg.bounce_bwd_plain(
        t["blob"], meta, t["lsb"], t["mtypes"], st, ids, res8, ct, n, **kw)
    assert float(dgeo[:, padding].abs().sum()) == 0.0
    assert float(dgeo[:, ~padding].abs().sum()) > 0.0
    assert bool(torch.isfinite(din).all() and torch.isfinite(dscal).all())


@pytest.mark.parametrize("case", ["scene", "padding"])
def test_shadow_walk_equals_shadow_lists(case):
    """K9's plain version (K7's bounce recording its verdict) with its
    shadow rays walking the tree against sweeping the shadow lists, on the
    same winners (K6's list-mode residual) of one sorted bounce of the
    160-sphere scene and of the padding scene: the same verdict on every
    lane and the same state bit for bit (no shadow ray grazes a leaf box
    here), with the walks' counts."""
    if case == "padding":
        sd = padding_scene(spt_tpu_torch).compile(device=CPU)
        cam = spt_tpu_torch.Camera.look_at(device=CPU, **PAD_CAM)
    else:
        sd, cam = scene_10k(spt_tpu_torch, n=160).compile(device=CPU), \
            _camera()
    t, stc, meta = wf_inputs(torch, twf, twf, sd, cam, 4)
    b = wf_bounce(torch, twf, t, stc, meta, 16, 16, 0, 4)
    n, res = b["n"], b["res"]
    st, ids = b["buf"][:twf.N_CH], b["buf"][twf.N_CH:].view(torch.int32)
    kw = dict(k=0, block=stc["block"], n_mats=stc["n_mats"],
              n_light_slots=stc["n_light_slots"], rr_depth=5, use_nee=True,
              use_mis=True, sky_mode=sd.sky_mode)
    args = (t["blob"], meta, t["lsb"], t["prims"], t["mtypes"])
    stats = {}
    out_w, blocked_w = twg.shade_fwd_plain(*args, None, None, st, ids, res,
                                           n, tree=b["tree"], stats=stats,
                                           **kw)
    out_l, blocked_l = twg.shade_fwd_plain(*args, b["scand"], b["sctn"], st,
                                           ids, res, n, **kw)
    assert torch.equal(blocked_w, blocked_l) and float(blocked_w.sum()) > 0
    assert torch.equal(out_w.view(torch.int32), out_l.view(torch.int32))
    assert stats["shadow"] > 0
    assert stats["shadow_nodes"] >= stats["shadow"]
    assert stats["shadow_spheres"] > 0 and "shadow_blocks" not in stats
    assert twf.k7_op_count(stats) > 0


def test_split_walks_the_refit_tree(monkeypatch):
    """A sphere moved by the ``centers`` parameter out of every leaf box
    (into the view, 10 units before the camera): the split render walks
    the tree refit to it (``refit_nodef_torch``) and gives the fused
    render's value and gradients over lists culled from the moved spheres'
    own boxes; with the packed tree's stale boxes its walks miss the
    sphere."""
    sd = scene_10k(spt_tpu_torch, n=160).compile(device=CPU)
    kw = dict(spp=1, max_bounces=2, rr_depth=2, seed=5, sort_min_rays=0)
    centers = TG.get_params(sd, ("centers",))["centers"].clone()
    centers[1] = torch.tensor([0.0, 0.0, 0.0])

    def run(**opts):
        render = twg.make_wavefront_render_fn(sd, _camera(), 16, 16, **kw,
                                              **opts)
        params = {"centers": centers.clone().requires_grad_(True),
                  "albedo": TG.get_params(sd, ("albedo",))["albedo"]
                  .clone().requires_grad_(True)}
        img = render(params, 0)
        img.sum().backward()
        return img.detach(), {k: p.grad for k, p in params.items()}

    img, grads = run()
    img_f, grads_f = run(split=False, precull=True)
    still = twg.make_wavefront_render_fn(sd, _camera(), 16, 16, **kw)(
        {}, 0)
    assert torch.equal(img, img_f)
    assert not torch.equal(img, still)      # the moved sphere is seen
    for k in grads:
        torch.testing.assert_close(grads[k], grads_f[k], rtol=1e-5,
                                   atol=1e-7)
    assert float(grads["centers"][1].abs().sum()) > 0
    stale = twg.packed(sd, _camera(), twg.BLOCK)[0]["nodef"]
    monkeypatch.setattr(twg, "refit_nodef_torch", lambda sc, st: stale)
    img_s, _ = run()
    assert not torch.equal(img_s, img)


@pytest.mark.parametrize("case", ["scene", "padding"])
def test_k10_wrapper_on_the_cpu_is_plain_and_scatter(case):
    """K10's wrapper on CPU tensors (``bounce_bwd``: the kernel's contract,
    d(prims) summed by winner) equals the plain K10 followed by
    ``_grads_from_bwd``'s scatter bit for bit, on one sorted bounce of the
    160-sphere scene at 16x16 and of the padding scene, whose padding
    winners' slots get nothing."""
    if case == "padding":
        sd = padding_scene(spt_tpu_torch).compile(device=CPU)
        cam = spt_tpu_torch.Camera.look_at(device=CPU, **PAD_CAM)
    else:
        sd = scene_10k(spt_tpu_torch, n=160).compile(device=CPU)
        cam = _camera()
    t, stc, meta = wf_inputs(torch, twf, twf, sd, cam, 4)
    b0 = wf_bounce(torch, twf, t, stc, meta, 16, 16, 0, 4)
    n, res = b0["n"], b0["res"]
    st, ids = b0["buf"][:twf.N_CH], b0["buf"][twf.N_CH:].view(torch.int32)
    kw = dict(k=0, n_mats=stc["n_mats"], n_light_slots=stc["n_light_slots"],
              rr_depth=5, use_nee=True, use_mis=True, sky_mode=sd.sky_mode)
    block = stc["block"]
    _, blocked = twg.shade_fwd_plain(
        t["blob"], meta, t["lsb"], t["prims"], t["mtypes"], b0["scand"],
        b0["sctn"], st, ids, res, n, block=block, **kw)
    res8 = res.clone()
    res8[7] = blocked
    ct = torch.from_numpy(np.random.default_rng(8).normal(
        size=tuple(st.shape)).astype(np.float32))
    args = (t["blob"], meta, t["lsb"], t["mtypes"], st, ids, res8, ct, n)
    n_blocks = t["prims"].numel() // (5 * block)
    din, d_prims, dscal = twg.bounce_bwd(*args, **kw, n_blocks=n_blocks,
                                         block=block)
    din_p, dgeo_p, dscal_p = twg.bounce_bwd_plain(*args, **kw)
    d_blob_p, d_prims_p = twg._grads_from_bwd(
        t["blob"], res8, dgeo_p, dscal_p, n_mats=kw["n_mats"],
        n_light_slots=kw["n_light_slots"], n_blocks=n_blocks, block=block)
    assert d_prims.shape == (n_blocks, 5, block)
    for got, want in ((din, din_p), (d_prims, d_prims_p), (dscal, dscal_p)):
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert torch.equal(twg._blob_grad(t["blob"], dscal, n_mats=kw["n_mats"],
                                      n_light_slots=kw["n_light_slots"]),
                       d_blob_p)
    assert float(d_prims[:, :4].abs().sum()) > 0.0
    pad = t["prims"].reshape(-1, 5, block)[:, 4, :] < 0
    assert float(d_prims[:, :4].abs().sum(1)[pad].sum()) == 0.0
