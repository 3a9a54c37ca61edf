"""The port's CUDA kernels on the card; every test here skips without one.

Imports neither jax nor the JAX package, so it runs on a GPU machine that
has neither.  There, from the repo root (the suite's conftest imports jax):

    python -m pytest --noconftest tests/test_torch_cuda.py -q

Tolerance: the RNG bits are equal exactly; K1 against its plain version is
held to chip_smoke.py's bar (99.9% of pixels isclose(rtol=2e-3,
atol=2e-4), means within 0.1%), and on ragged images, K3's too, to every
value equal; their counting launches count the plain paths' bounces.  K2's image equals K1's bit for bit; its
gradient and its per-lane bounce adjoint are held to chip_smoke.py's bars
(``GRAD_REL`` / ``GRAD_ABS`` per field, ``VJP_*`` per lane).  K3 is held
to K1's bar against its plain version, and equals K1 bit for bit on
Cornell packed for the BVH walk (one leaf, the spheres in index order).
The wavefront: K5 equals its plain version bit for bit, K6's residual
equals the plain K6's (its tree mode and its list mode), K7's state with
the shadow walks equals its plain walk's bit for bit, and over the lists
and in the whole render meets K1's bar against its plain version; the
walks and the lists part only at exact t-ties and padding winners, and
the split render builds no lists.  The gradients, whose fields have heavy
tails (grazing hits), are held on typical scales (chip_smoke.py's
``tail_field_errors``: ``GRAD_REL`` in each field's body and in its tail
above the 99th percentile; ``lanes_close``: the ``VJP_*`` bar with atol
taken from a channel's median nonzero magnitude, on 99.5% of lanes,
and body and tail lanes within ``GRAD_REL``).  K4's image equals
K3's (K1's bar) and its raw gradients meet that bar against the plain
K4's; K9's state equals K7's bit for bit and its blocked mask the plain
K9's (with the walks also its state); K10's per-lane cotangents, its
prim table and its scalar gradient meet the plain K10's and its
scatter's; K4's image equals K3's value for value on ragged images; the
differentiable wavefront's image meets K1's bar and its gradients the
field bar against its plain stages.  Rays that win padding slots (the
padding scene) take no geometry gradient in K4 and K10.  K8's verdicts
equal its plain version's bit for bit, on a whole leaf table and on each
half, and the halves' MAX equals the whole's and K9's; K7 reading K9's
verdict (``blocked_in_res``) equals K7 sweeping bit for bit, and reading
K9's walked verdicts K7 walking.  K6m, culling its per-row lists by the
leaf boxes, equals its plain version bit for bit and parts from the
unculled sweep only at exact ties and box edges.  An
environment-map scene's gradient takes the wavefront.  The applications
and the reference integrator on the card: the CLI's resumed render equals
an uninterrupted one (rtol 1e-6, atol 1e-7, the JAX CLI's bar),
reference-mode frames meet the JAX parity bar against the CPU (atol 2e-3,
99.5% of pixels within 1e-4), and the inverse-render app's loss falls.
"""

import numpy as np
import pytest
import torch

import spt_tpu_torch as T
from chip_smoke import (ATOL, ENCLOSURE_CAM, K2_CAPACITY_CAM, MAX_MEAN_REL,
                        MIN_CLOSE, PAD_CAM, RAGGED, RTOL, VJP_ATOL_REL,
                        VJP_MIN_CLOSE, VJP_RTOL, cornell, cull_differ,
                        enclosure_scene, env_gradient,
                        grad_errors, grad_scene, k2_capacity_scene, k3_inputs,
                        lanes_close, padding_scene, raw_fields, scene_200,
                        route_differ, shadow_sray, tail_field_errors,
                        vjp_lanes, wf_bounce, wf_inputs)
from spt_tpu_torch.core import rng
from spt_tpu_torch.diff import cuda_diff, gradients as G
from spt_tpu_torch.kernels import megakernel as mk
from spt_tpu_torch.kernels import megakernel_bvh as mb
from spt_tpu_torch.kernels import megakernel_grad as mg


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def test_counter_bits_kernel_exact(cuda):
    r = np.random.default_rng(0)
    args = [torch.from_numpy(r.integers(0, 2**32, 1 << 16, dtype=np.uint64)
                             .astype(np.int64)).to(cuda) for _ in range(4)]
    assert torch.equal(mk.counter_bits_cuda(*args), rng.counter_bits(*args))


def _case(case, dev):
    if case == "demo38":
        sd = T.demo_scene_38_spheres().compile(capacity=64, device=dev)
        cam = T.Camera.look_at((0, 0, 0), (0, 0, 1), fov_degrees=90,
                               device=dev)
    elif case in ("capacity_128", "enclosure"):
        scene, camkw = ((k2_capacity_scene(T), K2_CAPACITY_CAM)
                        if case == "capacity_128"
                        else (enclosure_scene(T), ENCLOSURE_CAM))
        sd = scene.compile(device=dev)
        cam = T.Camera.look_at(device=dev, **camkw)
    else:
        sd = cornell(T).compile(device=dev)
        lens = dict(aperture=0.15, focus_dist=4.5) if case == "thin_lens" \
            else {}
        cam = T.Camera.look_at((0, 1.0, -1.5), (0, 1.0, 3.0),
                               fov_degrees=55, device=dev, **lens)
    return sd, cam


@pytest.mark.parametrize("case", ["cornell", "demo38", "thin_lens"])
def test_k1_matches_plain(cuda, case):
    sd, cam = _case(case, cuda)
    blob, meta, lsb, static = mk.pack_uniforms(sd, cam, 7, 3)
    kw = dict(width=48, height=32, spp=4, max_bounces=8, rr_depth=3,
              use_nee=True, use_mis=True, sky_mode=sd.sky_mode,
              dof=case == "thin_lens", **static)
    got = mk.megakernel_fwd(blob, meta, lsb, **kw).cpu().numpy()
    want = mk.render_tiles_plain(blob, meta, lsb, **kw).cpu().numpy()
    assert np.isfinite(got).all() and want.mean() > 0.01
    close = np.isclose(got, want, rtol=RTOL, atol=ATOL).all(axis=-1)
    assert close.mean() >= MIN_CLOSE
    assert abs(got.mean() - want.mean()) <= MAX_MEAN_REL * want.mean()


# K1 equals its plain version value for value: on ragged images (a width
# not a multiple of 32, a height not of 8, a pixel count not of a warp's
# batch), at 1 and 3 spp, from a start sample above 0, with a thin lens.
@pytest.mark.parametrize("case,spp,start", [
    ("cornell", 3, 7), ("demo38", 1, 0), ("thin_lens", 1, 5)])
def test_k1_equals_plain_on_ragged_images(cuda, case, spp, start):
    sd, cam = _case(case, cuda)
    w, h = RAGGED
    blob, meta, lsb, static = mk.pack_uniforms(sd, cam, start, 3)
    kw = dict(width=w, height=h, spp=spp, max_bounces=8, rr_depth=3,
              use_nee=True, use_mis=True, sky_mode=sd.sky_mode,
              dof=case == "thin_lens", **static)
    got = mk.megakernel_fwd(blob, meta, lsb, **kw)
    want = mk.render_tiles_plain(blob, meta, lsb, **kw)
    assert float(want.mean()) > 0.01
    assert int((got != want).sum()) == 0


def test_k1_lane_counts_add_up_to_the_plain_paths(cuda):
    """The counting launch's busy lanes are the bounces the plain paths
    ran, and its image the kernel's."""
    sd, cam = _case("cornell", cuda)
    blob, meta, lsb, static = mk.pack_uniforms(sd, cam, 0, 3)
    kw = dict(width=48, height=32, spp=3, max_bounces=8, rr_depth=3,
              use_nee=True, use_mis=True, sky_mode=sd.sky_mode, dof=False,
              **static)
    stats = {}
    mk.render_tiles_plain(blob, meta, lsb, stats=stats, **kw)
    before = dict(mk.LAUNCHES)
    lanes = mk.lane_counts("k1", blob, meta, lsb, **kw)
    assert mk.LAUNCHES == dict(before, k1=before["k1"] + 1)
    assert lanes["busy"] == int(stats["lengths"].sum())
    assert 0 < lanes["share"] <= 1 and lanes["lane_slots"] % 32 == 0


def test_facade_launches_k1(cuda):
    tr = T.create_path_tracer("cuda")
    assert tr.device.type == "cuda"
    tr.set_scene(cornell(T))
    s = T.RenderSettings()
    s.set_resolution(32, 24)
    tr.set_settings(s)
    before = dict(mk.LAUNCHES)
    tr.render()
    tr.render()
    img = tr.get_render_result().image_f32
    assert img.device.type == "cuda" and bool(torch.isfinite(img).all())
    assert mk.LAUNCHES == dict(before, k1=before["k1"] + 2)


def test_k1_rejects_what_it_cannot_take(cuda):
    sd = cornell(T).compile(device=cuda)
    cam = T.Camera.look_at((0, 1, -1.5), (0, 1, 3), device=cuda)
    blob, meta, lsb, static = mk.pack_uniforms(sd, cam, 0, 3)
    kw = dict(width=8, height=8, spp=1, max_bounces=2, rr_depth=1,
              use_nee=True, use_mis=True, sky_mode=sd.sky_mode, dof=False)
    with pytest.raises(ValueError):
        mk.megakernel_fwd(blob.double(), meta, lsb, **kw, **static)
    with pytest.raises(ValueError):
        mk.megakernel_fwd(blob, meta, lsb.cpu(), **kw, **static)
    with pytest.raises(ValueError):
        mk.megakernel_fwd(blob, meta, lsb, **kw, n_prims=256,
                          n_light_slots=1)


@pytest.mark.parametrize("k", [0, 3])
def test_bounce_vjp_kernel_matches_plain(cuda, k):
    sd = grad_scene(T).compile(device=cuda)
    cam = T.Camera.look_at((0, 1.0, -1.2), (0, 0.8, 4.0), device=cuda)
    blob, meta, lsb, static = mk.pack_uniforms(sd, cam, 0, 3)
    lanes = vjp_lanes(torch, cuda, 1 << 14, k)
    kw = dict(k=k, rr_depth=3, use_nee=True, use_mis=True,
              sky_mode=sd.sky_mode, **static)
    g_k, ct_k = mg.bounce_vjp(blob, meta, lsb, *lanes, **kw)
    g_p, ct_p = mg.bounce_vjp_plain(blob, meta, lsb, *lanes, **kw)
    a, b = ct_k.cpu().numpy(), ct_p.cpu().numpy()
    close = np.isclose(a, b, rtol=VJP_RTOL, atol=VJP_ATOL_REL
                       * np.abs(b).max(axis=1, keepdims=True)).all(0)
    assert close.mean() >= VJP_MIN_CLOSE
    errs, _ = grad_errors(g_k, g_p, static["n_prims"])
    assert all(e["ok"] for e in errs), errs


# capacity_128: 128 spheres, 7 light slots and a gradient sky, many rows
# and light rows in one warp; enclosure: all lanes of a warp on one row.
@pytest.mark.parametrize("case", ["cornell", "demo38", "thin_lens",
                                  "capacity_128", "enclosure"])
def test_k2_matches_plain(cuda, case):
    sd, cam = _case(case, cuda)
    blob, meta, lsb, static = mk.pack_uniforms(sd, cam, 7, 3)
    kw = dict(width=48, height=32, spp=4, max_bounces=8, rr_depth=3,
              use_nee=True, use_mis=True, sky_mode=sd.sky_mode,
              dof=case == "thin_lens", **static)
    ct = torch.from_numpy(np.random.default_rng(0).uniform(
        0.5, 1.5, (32, 48, 3)).astype(np.float32)).to(cuda)
    before = dict(mk.LAUNCHES)
    img, gvec = mg.megakernel_grad(blob, meta, lsb, ct, **kw)
    assert mk.LAUNCHES == dict(before, k2=before["k2"] + 1)
    assert torch.equal(img, mk.megakernel_fwd(blob, meta, lsb, **kw))
    _, want = mg.render_and_grad_plain(blob, meta, lsb, ct, **kw)
    errs, _ = grad_errors(gvec, want, static["n_prims"])
    assert all(e["ok"] for e in errs), errs
    assert float(want.abs().sum()) > 0


def test_kernel_render_launches_k1_then_k2(cuda):
    sd = cornell(T).compile(device=cuda)
    cam = T.Camera.look_at((0, 1.0, -1.5), (0, 1.0, 3.0), fov_degrees=55,
                           device=cuda)
    render = cuda_diff.make_cuda_render_fn(sd, cam, 16, 16, spp=2)
    p = {k: v.clone().requires_grad_(True)
         for k, v in G.get_params(sd, cuda_diff.PARAM_KEYS).items()}
    before = dict(mk.LAUNCHES)
    render(p, 0).sum().backward()
    assert mk.LAUNCHES == dict(before, k1=before["k1"] + 1,
                               k2=before["k2"] + 1)
    assert all(bool(torch.isfinite(v.grad).all()) for v in p.values())


def test_k2_rejects_depth_above_its_cap():
    sd = cornell(T).compile(device="cpu")
    cam = T.Camera.look_at((0, 1, -1.5), (0, 1, 3), device="cpu")
    blob, meta, lsb, static = mk.pack_uniforms(sd, cam, 0, 3)
    with pytest.raises(ValueError, match="at most 16 bounces"):
        mg.megakernel_grad(blob, meta, lsb, torch.ones(4, 4, 3), width=4,
                           height=4, spp=1, max_bounces=mg.MAX_DEPTH + 1,
                           rr_depth=3, use_nee=True, use_mis=True,
                           sky_mode=sd.sky_mode, dof=False, **static)


def _scene200_camera(dev, lens):
    kw = dict(aperture=0.3, focus_dist=14.0) if lens else {}
    return T.Camera.look_at((0, 2.0, -4.0), (0, 1.0, 14.0), fov_degrees=60,
                            device=dev, **kw)


@pytest.mark.parametrize("lens", [False, True])
def test_k3_matches_plain(cuda, lens):
    sd = scene_200(T).compile(device=cuda)
    args, k3kw, _ = k3_inputs(torch, mb, sd, _scene200_camera(cuda, lens), 3)
    kw = dict(width=48, height=40, spp=4, max_bounces=8, rr_depth=3,
              use_nee=True, use_mis=True, sky_mode=sd.sky_mode, dof=lens,
              **k3kw)
    before = dict(mk.LAUNCHES)
    got = mb.megakernel_bvh_fwd(*args, **kw)
    assert mk.LAUNCHES == dict(before, k3=before["k3"] + 1)
    got = got.cpu().numpy()
    want = mb.render_tiles_bvh_plain(*args, **kw).cpu().numpy()
    assert np.isfinite(got).all() and want.mean() > 0.01
    close = np.isclose(got, want, rtol=RTOL, atol=ATOL).all(axis=-1)
    assert close.mean() >= MIN_CLOSE
    assert abs(got.mean() - want.mean()) <= MAX_MEAN_REL * want.mean()


# K3 equals its plain version value for value on ragged images, at 1 and
# 3 spp, from a start sample above 0, with a thin lens, and on the padding
# scene, whose rays win leaf padding slots.
@pytest.mark.parametrize("case,spp,start", [
    ("scene200", 3, 7), ("scene200_thin_lens", 1, 5), ("padding", 3, 3)])
def test_k3_equals_plain_on_ragged_images(cuda, case, spp, start):
    if case == "padding":
        sd = padding_scene(T).compile(device=cuda)
        cam = T.Camera.look_at(device=cuda, **PAD_CAM)
    else:
        sd = scene_200(T).compile(device=cuda)
        cam = _scene200_camera(cuda, case.endswith("lens"))
    args, k3kw, _ = k3_inputs(torch, mb, sd, cam, 3, start=start)
    w, h = RAGGED
    kw = dict(width=w, height=h, spp=spp, max_bounces=8, rr_depth=3,
              use_nee=True, use_mis=True, sky_mode=sd.sky_mode,
              dof=case.endswith("lens"), **k3kw)
    got = mb.megakernel_bvh_fwd(*args, **kw)
    want = mb.render_tiles_bvh_plain(*args, **kw)
    assert float(want.mean()) > 0.01
    assert int((got != want).sum()) == 0
    lanes = mk.lane_counts("k3", *args, **kw)
    stats = {}
    mb.render_tiles_bvh_plain(*args, stats=stats, **kw)
    assert lanes["busy"] == int(stats["lengths"].sum())


def test_k3_equals_k1_on_cornell(cuda):
    sd, cam = _case("cornell", cuda)
    blob, meta, lsb, static = mk.pack_uniforms(sd, cam, 0, 3)
    kw = dict(width=48, height=32, spp=4, max_bounces=8, rr_depth=3,
              use_nee=True, use_mis=True, sky_mode=sd.sky_mode, dof=False)
    args, k3kw, _ = k3_inputs(torch, mb, sd, cam, 3)
    assert torch.equal(mb.megakernel_bvh_fwd(*args, **kw, **k3kw),
                       mk.megakernel_fwd(blob, meta, lsb, **kw, **static))


def test_facade_launches_k3(cuda):
    tr = T.create_path_tracer("cuda")
    tr.set_scene(scene_200(T))
    tr.set_camera(_scene200_camera(cuda, False))
    s = T.RenderSettings()
    s.set_resolution(40, 24)
    tr.set_settings(s)
    before = dict(mk.LAUNCHES)
    tr.render()
    tr.render()
    img = tr.get_render_result().image_f32
    assert img.device.type == "cuda" and bool(torch.isfinite(img).all())
    assert mk.LAUNCHES == dict(before, k3=before["k3"] + 2)
    assert tr.scene_data.capacity == 256


def _wf_case(dev, lens=False):
    """The 200-sphere scene packed for the wavefront, and its meta."""
    from spt_tpu_torch.kernels import wavefront as wf
    sd = scene_200(T).compile(device=dev)
    t, st, meta = wf_inputs(torch, wf, mb, sd, _scene200_camera(dev, lens), 3)
    return wf, sd, t, st, meta


@pytest.mark.parametrize("lens", [False, True])
def test_k5_equals_plain(cuda, lens):
    wf, _, t, _, meta = _wf_case(cuda, lens)
    kw = dict(width=72, height=40, chunk_spp=3, dof=lens)
    before = dict(mk.LAUNCHES)
    got = wf._stream_buffer(*wf.raygen(t["blob"], meta, **kw))
    assert mk.LAUNCHES == dict(before, k5=before["k5"] + 1)
    want = wf._stream_buffer(*wf.raygen_plain(t["blob"], meta, **kw))
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def test_k6_k7_match_plain(cuda):
    """One bounce after raygen and a sort: K6's residual over the lists
    equals the plain K6's, and K7's state over the shadow lists meets K1's
    bar against the plain K7's."""
    wf, sd, t, stc, meta = _wf_case(cuda)
    b = wf_bounce(torch, wf, t, stc, meta, 96, 64, 1, 3)
    st, ids, n, res = b["st"], b["ids"], b["n"], b["res"]
    block, prims = stc["block"], t["prims"]
    before = dict(mk.LAUNCHES)
    again = wf.isect(prims, b["cand"], b["ctn"], st, n, block=block)
    assert mk.LAUNCHES == dict(before, k6l=before["k6l"] + 1)
    assert torch.equal(again, res)
    assert torch.equal(res, wf.isect_plain(prims, b["cand"], b["ctn"], st, n,
                                           block=block))
    assert int((res[4] >= 0).sum()) > 0
    other = b["buf"].clone()
    st2, ids2 = other[:wf.N_CH], other[wf.N_CH:].view(torch.int32)
    kw = dict(k=1, block=block, n_mats=stc["n_mats"],
              n_light_slots=stc["n_light_slots"], rr_depth=1, use_nee=True,
              use_mis=True, sky_mode=sd.sky_mode)
    args = (t["blob"], meta, t["lsb"], prims, t["mtypes"], b["scand"],
            b["sctn"])
    wf.shade(*args, st, ids, res, n, **kw)
    wf.shade_plain(*args, st2, ids2, res, n, **kw)
    got, want = st.cpu().numpy(), st2.cpu().numpy()
    assert np.isfinite(got).all()
    close = np.isclose(got, want, rtol=RTOL, atol=ATOL)
    assert close.mean() >= MIN_CLOSE
    assert not got[wf.C_MISS].any()


@pytest.mark.parametrize("case", ["scene200", "padding"])
def test_walks_match_plain_and_lists(cuda, case):
    """K6's tree mode and K7's and K9's shadow walks on one bounce: K6's
    residual equals its plain walk's, K7's and K9's state and K9's
    verdicts their plain walks' bit for bit, and K9's state K7's; against
    the list route every lane whose winner differs is an exact t-tie or a
    padding winner (the padding scene has some)."""
    from spt_tpu_torch.kernels import wavefront_grad as wg
    wf, t, meta, b, kw, args = _grad_bounce(cuda, case)
    st, ids, n, tree = b["st"], b["ids"], b["n"], b["tree"]
    prims = t["prims"]
    before = dict(mk.LAUNCHES)
    res = wf.isect(prims, None, None, st, n, block=kw["block"], tree=tree)
    assert mk.LAUNCHES == dict(before, k6=before["k6"] + 1)
    assert torch.equal(res, b["res_t"])
    assert torch.equal(res, wf.isect_plain(prims, None, None, st, n,
                                           block=kw["block"], tree=tree))
    route = route_differ(torch, wf, st[:, :n], res, b["res"])
    assert route["other"] == 0, route
    padding = int(((res[4] < 0) & (res[5] >= 0)).sum())
    assert (padding + route["padding"] > 0) == (case == "padding")
    base = b["buf"].clone()
    st7, ids7 = _fresh(wf, base)
    before = dict(mk.LAUNCHES)
    wf.shade(*args[:5], None, None, st7, ids7, res, n, tree=tree, **kw)
    out9, blocked = wg.shade_fwd(*args[:5], None, None, st, ids, res, n,
                                 tree=tree, **kw)
    assert mk.LAUNCHES == dict(before, k7=before["k7"] + 1,
                               k9=before["k9"] + 1)
    assert torch.equal(out9.view(torch.int32), st7.view(torch.int32))
    out_p, blocked_p = wg.shade_fwd_plain(*args[:5], None, None, st, ids,
                                          res, n, tree=tree, **kw)
    assert torch.equal(out9.view(torch.int32), out_p.view(torch.int32))
    assert torch.equal(blocked, blocked_p) and float(blocked.sum()) > 0


@pytest.mark.parametrize("case", ["gradient", "envmap"])
def test_wavefront_matches_plain(cuda, case):
    wf, sd, t, _, _ = _wf_case(cuda)
    if case == "envmap":
        scene = scene_200(T)
        scene.set_environment_map(env_gradient(16, 32))
        sd = scene.compile(device=cuda)
    cam = _scene200_camera(cuda, False)
    kw = dict(max_bounces=8, rr_depth=3, seed=3, sort_min_rays=0)
    before, glue = dict(mk.LAUNCHES), dict(wf.GLUE_CALLS)
    got = wf.render_wavefront(sd, cam, 48, 40, 0, 2, **kw)
    after = dict(mk.LAUNCHES)
    assert after["plain"] == before["plain"] and after["k5"] == before["k5"] + 1
    assert wf.GLUE_CALLS == glue        # the split path builds no lists
    want = wf._render(sd, cam, 48, 40, 0, 2, stages=wf.PLAIN, **kw)
    got, want = got.cpu().numpy(), want.cpu().numpy()
    assert np.isfinite(got).all() and want.mean() > 0.01
    close = np.isclose(got, want, rtol=RTOL, atol=ATOL).all(axis=-1)
    assert close.mean() >= MIN_CLOSE
    assert abs(got.mean() - want.mean()) <= MAX_MEAN_REL * want.mean()


def test_facade_launches_wavefront(cuda):
    scene = scene_200(T)
    scene.set_environment_map(env_gradient(16, 32))
    tr = T.create_path_tracer("cuda")
    tr.set_scene(scene)
    tr.set_camera(_scene200_camera(cuda, False))
    s = T.RenderSettings()
    s.set_resolution(40, 24)
    s.max_bounces = 3
    tr.set_settings(s)
    before = dict(mk.LAUNCHES)
    tr.render()
    img = tr.get_render_result().image_f32
    assert img.device.type == "cuda" and bool(torch.isfinite(img).all())
    assert mk.LAUNCHES == dict(before, k5=before["k5"] + 1,
                               k6=before["k6"] + 3, k7=before["k7"] + 3)


def _ct(dev, w, h, seed=4):
    return torch.from_numpy(np.random.default_rng(seed).uniform(
        0.5, 1.5, (h, w, 3)).astype(np.float32)).to(dev)


# K4's image equals K3's value for value on ragged images, at 1 and 3 spp,
# from a start sample above 0, with a thin lens, and on the padding scene.
@pytest.mark.parametrize("case,spp,start", [
    ("scene200", 3, 7), ("scene200_thin_lens", 1, 5), ("padding", 3, 3)])
def test_k4_equals_k3_on_ragged_images(cuda, case, spp, start):
    from spt_tpu_torch.kernels import megakernel_bvh_grad as mbg
    if case == "padding":
        sd = padding_scene(T).compile(device=cuda)
        cam = T.Camera.look_at(device=cuda, **PAD_CAM)
    else:
        sd = scene_200(T).compile(device=cuda)
        cam = _scene200_camera(cuda, case.endswith("lens"))
    args, k3kw, _ = k3_inputs(torch, mb, sd, cam, 3, start=start)
    w, h = RAGGED
    kw = dict(width=w, height=h, spp=spp, max_bounces=8, rr_depth=3,
              use_nee=True, use_mis=True, sky_mode=sd.sky_mode,
              dof=case.endswith("lens"), **k3kw)
    img, _, gg = mbg.megakernel_bvh_grad(
        *args, mbg.swizzle_ct(_ct(cuda, w, h), w, h), **kw)
    want = mb.megakernel_bvh_fwd(*args, **kw)
    assert float(want.mean()) > 0.01
    assert int((img != want).sum()) == 0
    assert bool(torch.isfinite(gg).all()) and float(gg.abs().sum()) > 0


@pytest.mark.parametrize("case", ["scene200", "padding"])
def test_k4_matches_plain(cuda, case):
    """K4's image equals K3's; its raw gradients are held to GRAD_REL in
    body and tail against the plain K4's.  In the padding case rays win
    padding slots, which take no geometry gradient."""
    from spt_tpu_torch.kernels import megakernel_bvh_grad as mbg
    if case == "padding":
        sd = padding_scene(T).compile(device=cuda)
        cam = T.Camera.look_at(device=cuda, **PAD_CAM)
    else:
        sd = scene_200(T).compile(device=cuda)
        cam = _scene200_camera(cuda, False)
    args, k3kw, _ = k3_inputs(torch, mb, sd, cam, 3)
    kw = dict(width=48, height=40, spp=2, max_bounces=8, rr_depth=3,
              use_nee=True, use_mis=True, sky_mode=sd.sky_mode, dof=False,
              **k3kw)
    ct = mbg.swizzle_ct(_ct(cuda, 48, 40), 48, 40)
    before = dict(mk.LAUNCHES)
    img, gs, gg = mbg.megakernel_bvh_grad(*args, ct, **kw)
    assert mk.LAUNCHES == dict(before, k4=before["k4"] + 1)
    got, want = img.cpu().numpy(), mb.megakernel_bvh_fwd(*args, **kw) \
        .cpu().numpy()
    close = np.isclose(got, want, rtol=RTOL, atol=ATOL).all(axis=-1)
    assert close.mean() >= MIN_CLOSE and want.mean() > 0.01
    stats = {}
    _, p_gs, p_gg = mbg.render_and_grad_bvh_plain(*args, ct, **kw,
                                                  stats=stats)
    n_mats = k3kw["n_mats"]
    errs, _ = tail_field_errors(raw_fields(gs, gg, n_mats),
                                raw_fields(p_gs, p_gg, n_mats))
    assert all(e["ok"] for e in errs.values()), errs
    assert float(p_gg.abs().sum()) > 0 and float(p_gs.abs().sum()) > 0
    pad = args[5].reshape(-1, 5, k3kw["block"])[:, 4, :] < 0
    assert float(gg[:, :4].abs().sum(1)[pad].sum()) == 0.0
    assert (stats["padding_winners"] > 0) == (case == "padding")


def _grad_bounce(cuda, case="scene200"):
    """A wavefront bounce (k=1) of the 200-sphere scene at 96x64 x 2 spp
    after raygen, a sort and the precull, or bounce 0 of the padding
    scene, and K9's keywords."""
    if case == "padding":
        from spt_tpu_torch.kernels import wavefront as wf
        sd = padding_scene(T).compile(device=cuda)
        t, stc, meta = wf_inputs(torch, wf, mb, sd, T.Camera.look_at(
            device=cuda, **PAD_CAM), 3)
        k = 0
    else:
        wf, sd, t, stc, meta = _wf_case(cuda)
        k = 1
    b = wf_bounce(torch, wf, t, stc, meta, 96, 64, k, 3)
    b["static"] = stc
    kw = dict(k=k, block=stc["block"], n_mats=stc["n_mats"],
              n_light_slots=stc["n_light_slots"], rr_depth=1, use_nee=True,
              use_mis=True, sky_mode=sd.sky_mode)
    args = (t["blob"], meta, t["lsb"], t["prims"], t["mtypes"], b["scand"],
            b["sctn"])
    return wf, t, meta, b, kw, args


def test_k9_matches_k7_and_plain(cuda):
    """K9 over the shadow lists: its state equals K7's bit for bit; against
    the plain K9 it meets K1's bar and its blocked mask is equal on every
    lane."""
    from spt_tpu_torch.kernels import wavefront_grad as wg
    wf, t, meta, b, kw, args = _grad_bounce(cuda)
    st, ids, n, res = b["st"], b["ids"], b["n"], b["res"]
    before = dict(mk.LAUNCHES)
    out, blocked = wg.shade_fwd(*args, st, ids, res, n, **kw)
    assert mk.LAUNCHES == dict(before, k9l=before["k9l"] + 1)
    st7 = st.clone()
    wf.shade(*args, st7, ids, res, n, **kw)
    assert torch.equal(out.view(torch.int32), st7.view(torch.int32))
    out_p, blocked_p = wg.shade_fwd_plain(*args, st, ids, res, n, **kw)
    assert torch.equal(blocked, blocked_p) and float(blocked.sum()) > 0
    got, want = out.cpu().numpy(), out_p.cpu().numpy()
    assert np.isclose(got, want, rtol=RTOL, atol=ATOL).mean() >= MIN_CLOSE


def _shard_ranges(nb):
    """The whole leaf table and the two prim=2 shards' ranges of it."""
    half = -(-nb // 2)
    return ((0, nb), (0, half), (half, nb))


@pytest.mark.parametrize("case", ["scene200", "padding"])
def test_k8_matches_plain(cuda, case):
    """K8 (the bounce on the winner, each shadow ray walking a shard's
    tree, the verdict kept) equals its plain version on every lane, on
    the whole tree and on each prim=2 shard's tree; the shards' MAX
    equals the whole's, and that K9's recorded verdict; the stream is
    left as it was; and K6's tree mode on each shard's tree equals its
    plain walk."""
    from spt_tpu_torch.kernels import wavefront_grad as wg
    from spt_tpu_torch.parallel.wavefront_prim import _shard_tree
    wf, t, meta, b, kw, args = _grad_bounce(cuda, case)
    st, ids, n, res = b["st"], b["ids"], b["n"], b["res_t"]
    block = kw["block"]
    prims = t["prims"].reshape(-1, 5, block)
    before_buf = b["buf"].clone()
    verdicts = []
    for lo, hi in _shard_ranges(prims.shape[0]):
        local = prims[lo:hi].contiguous()
        tree = _shard_tree(t, b["static"], lo, hi)
        before = dict(mk.LAUNCHES)
        res_s = wf.isect(local, None, None, st, n, block=block, tree=tree)
        got = wf.shadow_verdicts(*args[:3], local, args[4], st, ids, res, n,
                                 tree=tree, **kw)
        assert mk.LAUNCHES == dict(before, k6=before["k6"] + 1,
                                   k8=before["k8"] + 1)
        assert torch.equal(res_s, wf.isect_plain(local, None, None, st, n,
                                                 block=block, tree=tree))
        assert torch.equal(got, wf.shadow_verdicts_plain(
            *args[:3], local, args[4], st, ids, res, n, tree=tree, **kw))
        verdicts.append(got)
    assert torch.equal(b["buf"], before_buf)
    whole, a, c = verdicts
    assert torch.equal(torch.maximum(a, c), whole)
    _, blocked = wg.shade_fwd(*args[:5], None, None, st, ids, res, n,
                              tree=b["tree"], **kw)
    assert torch.equal(blocked, whole) and float(whole.sum()) > 0


@pytest.mark.parametrize("case", ["scene200", "padding"])
def test_k8l_matches_plain(cuda, case):
    """K8's list form (K8l) equals its plain version on every lane, on the
    whole leaf table and on each half of it (each with its own lists); the
    halves' MAX equals the whole's, and that K9's recorded verdict."""
    from spt_tpu_torch.kernels import wavefront_grad as wg
    from spt_tpu_torch.parallel.wavefront_prim import _local_blocks
    wf, t, meta, b, kw, args = _grad_bounce(cuda, case)
    stc = dict(n_light_slots=kw["n_light_slots"], n_mats=kw["n_mats"],
               mtypes=t["mtypes"].tolist())
    n, block = b["n"], kw["block"]
    sray = shadow_sray(torch, wf, t, stc, b, kw["k"], 3)
    prims = t["prims"].reshape(-1, 5, block)
    verdicts = []
    for part in (prims, _local_blocks(prims, 2, 0)[0],
                 _local_blocks(prims, 2, 1)[0]):
        part = part.contiguous()
        scand, sctn = wf.precull_tiles(
            tuple(sray[:3]), tuple(sray[3:6]), sray[7], sray[6],
            *wf._leaf_block_bounds(part))
        before = dict(mk.LAUNCHES)
        got = wf.anyhit(part, scand, sctn, sray, n, block=block)
        assert mk.LAUNCHES == dict(before, k8l=before["k8l"] + 1)
        assert torch.equal(got, wf.anyhit_plain(part, scand, sctn, sray, n,
                                                block=block))
        verdicts.append(got)
    whole, a, c = verdicts
    assert torch.equal(torch.maximum(a, c), whole)
    _, blocked = wg.shade_fwd(*args, b["st"], b["ids"], b["res"], n, **kw)
    assert torch.equal(blocked, whole) and float(whole.sum()) > 0


@pytest.mark.parametrize("case", ["scene200", "padding"])
def test_k7_reading_the_verdict_matches_k7(cuda, case):
    """K7 with ``blocked_in_res`` (K7b, its bounce inlined), fed K9's
    verdict in residual row 7, equals K7 sweeping the lists on every lane
    bit for bit, and fed K9's walked verdicts on K6's tree-mode winner K7
    walking the tree (the split path's); it meets K1's bar against its
    plain version."""
    from spt_tpu_torch.kernels import wavefront_grad as wg
    wf, t, meta, b, kw, args = _grad_bounce(cuda, case)
    st, ids, n, res = b["st"], b["ids"], b["n"], b["res"]
    _, blocked = wg.shade_fwd(*args, st, ids, res, n, **kw)
    res8 = res.clone()
    res8[7] = blocked
    sweep, read, plain = (b["buf"].clone() for _ in range(3))

    def stream(buf):
        return buf[:wf.N_CH], buf[wf.N_CH:].view(torch.int32)

    wf.shade(*args, *stream(sweep), res, n, **kw)
    none = torch.zeros((1, 1, 1), device=cuda)
    before = dict(mk.LAUNCHES)
    wf.shade(*args[:5], none.int(), none, *stream(read), res8, n,
             blocked_in_res=True, **kw)
    assert mk.LAUNCHES == dict(before, k7b=before["k7b"] + 1)
    assert torch.equal(read.view(torch.int32), sweep.view(torch.int32))
    wf.shade_plain(*args[:5], none.int(), none, *stream(plain), res8, n,
                   blocked_in_res=True, **kw)
    got, want = read.cpu().numpy(), plain.cpu().numpy()
    assert np.isfinite(got).all()
    assert np.isclose(got, want, rtol=RTOL, atol=ATOL).mean() >= MIN_CLOSE
    walk, read_t = b["buf"].clone(), b["buf"].clone()
    _, blocked_t = wg.shade_fwd(*args[:5], None, None, *stream(
        b["buf"].clone()), b["res_t"], n, tree=b["tree"], **kw)
    res8t = b["res_t"].clone()
    res8t[7] = blocked_t
    wf.shade(*args[:5], None, None, *stream(walk), b["res_t"], n,
             tree=b["tree"], **kw)
    wf.shade(*args[:5], none.int(), none, *stream(read_t), res8t, n,
             blocked_in_res=True, **kw)
    assert torch.equal(read_t.view(torch.int32), walk.view(torch.int32))


@pytest.mark.parametrize("case", ["scene200", "padding"])
def test_k10_matches_plain(cuda, case):
    """K10 against the plain K10 on one bounce: d(state) by
    ``lanes_close`` (the VJP_* bar on a typical lane's scale, on
    K10_MIN_CLOSE of the lanes; GRAD_REL in body and tail), the flags'
    and the suffix's cotangents exactly; its d(prims), summed in the
    kernel by winner, and dscal within GRAD_REL in body and tail of the
    plain K10's dgeo scattered by ``_grads_from_bwd``.  In the padding
    case lanes that won a padding slot (``hmid`` -1, a block) add
    nothing: their slots get no gradient."""
    from spt_tpu_torch.kernels import wavefront_grad as wg
    wf, t, meta, b, kw, args = _grad_bounce(cuda, case)
    st, ids, n, res = b["st"], b["ids"], b["n"], b["res"]
    _, blocked = wg.shade_fwd_plain(*args, st, ids, res, n, **kw)
    res8 = res.clone()
    res8[7] = blocked
    ct = torch.from_numpy(np.random.default_rng(5).normal(
        size=tuple(st.shape)).astype(np.float32)).to(cuda)
    kw10 = {k: v for k, v in kw.items() if k != "block"}
    bargs = (t["blob"], meta, t["lsb"], t["mtypes"], st, ids, res8, ct, n)
    block = kw["block"]
    n_blocks = t["prims"].numel() // (5 * block)
    before = dict(mk.LAUNCHES)
    din, d_prims, dscal = wg.bounce_bwd(*bargs, **kw10, n_blocks=n_blocks,
                                        block=block)
    assert mk.LAUNCHES == dict(before, k10=before["k10"] + 1)
    din_p, dgeo_p, dscal_p = wg.bounce_bwd_plain(*bargs, **kw10)
    _, d_prims_p = wg._grads_from_bwd(
        t["blob"], res8, dgeo_p, dscal_p, n_mats=kw["n_mats"],
        n_light_slots=kw["n_light_slots"], n_blocks=n_blocks, block=block)
    res_ = lanes_close(din[:13, :n], din_p[:13, :n])
    assert res_["ok"], res_
    assert torch.equal(din[13:], din_p[13:])
    assert torch.equal(din[:, n:], din_p[:, n:])
    errs, _ = tail_field_errors({"d_prims": d_prims, "dscal": dscal},
                                {"d_prims": d_prims_p, "dscal": dscal_p})
    assert all(e["ok"] for e in errs.values()), errs
    assert float(d_prims_p.abs().sum()) > 0
    padding = ((res[4] < 0) & (res[5] >= 0))[:n]
    assert (int(padding.sum()) > 0) == (case == "padding")
    pad = t["prims"].reshape(-1, 5, block)[:, 4, :] < 0
    assert float(d_prims[:, :4].abs().sum(1)[pad].sum()) == 0.0


def test_k10_sums_winners_as_the_scatter(cuda):
    """K10's d(prims) on a stream where many lanes share few winners (the
    padding scene's bounce 0, its camera's narrow field: whole warps on
    one sphere) against the plain K10 and ``_grads_from_bwd``'s
    ``index_add_``, at the same bar; every slot the scatter gives a
    gradient gets one from the kernel, and no other."""
    from spt_tpu_torch.kernels import wavefront_grad as wg
    wf, t, meta, b, kw, args = _grad_bounce(cuda, "padding")
    st, ids, n, res = b["st"], b["ids"], b["n"], b["res"]
    _, blocked = wg.shade_fwd_plain(*args, st, ids, res, n, **kw)
    res8 = res.clone()
    res8[7] = blocked
    ct = torch.ones_like(st)
    kw10 = {k: v for k, v in kw.items() if k != "block"}
    bargs = (t["blob"], meta, t["lsb"], t["mtypes"], st, ids, res8, ct, n)
    block = kw["block"]
    n_blocks = t["prims"].numel() // (5 * block)
    _, d_prims, _ = wg.bounce_bwd(*bargs, **kw10, n_blocks=n_blocks,
                                  block=block)
    din_p, dgeo_p, dscal_p = wg.bounce_bwd_plain(*bargs, **kw10)
    _, d_prims_p = wg._grads_from_bwd(
        t["blob"], res8, dgeo_p, dscal_p, n_mats=kw["n_mats"],
        n_light_slots=kw["n_light_slots"], n_blocks=n_blocks, block=block)
    errs, _ = tail_field_errors({"d_prims": d_prims}, {"d_prims": d_prims_p})
    assert errs["d_prims"]["ok"], errs
    assert torch.equal(d_prims != 0, d_prims_p != 0)
    own = res8[4, :n] >= 0
    assert int(own.sum()) > 64 * int(torch.unique(
        res8[5, :n][own] * block + res8[6, :n][own]).numel())


@pytest.mark.parametrize("case", ["gradient", "envmap"])
def test_wavefront_grad_matches_plain(cuda, case):
    """The differentiable wavefront through K5, K6, K9 and K10 against its
    plain versions on the card: image at K1's bar, gradients at GRAD_REL."""
    from spt_tpu_torch.kernels import wavefront_grad as wg
    scene = scene_200(T)
    if case == "envmap":
        scene.set_environment_map(env_gradient(16, 32))
    sd = scene.compile(device=cuda)
    cam = _scene200_camera(cuda, False)
    ct = _ct(cuda, 48, 40)
    out = []
    for stages in (wg.KERNELS, wg.PLAIN):
        render = wg._make_render_fn(
            sd, cam, 48, 40, stages=stages, spp=2, max_bounces=8, rr_depth=3,
            use_nee=True, use_mis=True, seed=3, sort_min_rays=0,
            chunk_rays=2 << 20)
        params = {k: v.clone().requires_grad_(True) for k, v in
                  G.get_params(sd, cuda_diff.PARAM_KEYS).items()}
        before = dict(mk.LAUNCHES)
        img = render(params, 0)
        (img * ct).sum().backward()
        runs = {k: mk.LAUNCHES[k] - before[k] for k in before}
        out.append((img.detach(), {k: v.grad for k, v in params.items()},
                    runs))
    (img, grads, runs), (img_p, grads_p, runs_p) = out
    assert runs["k9"] > 0 and runs["k10"] == runs["k9"] and runs["plain"] == 0
    assert runs_p["k9"] == 0 and runs_p["plain"] > 0
    got, want = img.cpu().numpy(), img_p.cpu().numpy()
    close = np.isclose(got, want, rtol=RTOL, atol=ATOL).all(axis=-1)
    assert close.mean() >= MIN_CLOSE and want.mean() > 0.01
    errs, _ = tail_field_errors(grads, grads_p)
    assert all(e["ok"] for e in errs.values()), errs


@pytest.mark.parametrize("engine,kernels", [
    ("auto", ("k3", "k4")), ("wavefront", ("k5", "k6", "k9", "k10"))])
def test_kernel_render_routes_large_scenes(cuda, engine, kernels):
    """make_cuda_render_fn on the 200-sphere scene: K3 forward and K4
    backward, or the differentiable wavefront when forced."""
    sd = scene_200(T).compile(device=cuda)
    render = cuda_diff.make_cuda_render_fn(
        sd, _scene200_camera(cuda, False), 32, 24, spp=1, max_bounces=3,
        engine=engine)
    params = {k: v.clone().requires_grad_(True) for k, v in
              G.get_params(sd, ("albedo", "centers")).items()}
    before = dict(mk.LAUNCHES)
    render(params, 0).sum().backward()
    runs = {k: mk.LAUNCHES[k] - before[k] for k in before}
    assert all(runs[k] > 0 for k in kernels) and runs["plain"] == 0
    assert sum(runs.values()) == sum(runs[k] for k in kernels)
    assert all(bool(torch.isfinite(p.grad).all()) for p in params.values())


def test_kernel_render_routes_envmap_to_wavefront(cuda):
    """An environment-map scene of 200 spheres goes to the differentiable
    wavefront (K5, K6, K9, K10), which renders the map; "fused" refuses
    it."""
    scene = scene_200(T)
    scene.set_environment_map(env_gradient(16, 32))
    sd = scene.compile(device=cuda)
    cam = _scene200_camera(cuda, False)
    render = cuda_diff.make_cuda_render_fn(sd, cam, 32, 24, spp=1,
                                           max_bounces=3)
    params = {k: v.clone().requires_grad_(True) for k, v in
              G.get_params(sd, ("albedo", "centers")).items()}
    before = dict(mk.LAUNCHES)
    render(params, 0).sum().backward()
    runs = {k: mk.LAUNCHES[k] - before[k] for k in before}
    kernels = ("k5", "k6", "k9", "k10")
    assert all(runs[k] > 0 for k in kernels) and runs["plain"] == 0
    assert sum(runs.values()) == sum(runs[k] for k in kernels)
    with pytest.raises(ValueError, match="environment-map"):
        cuda_diff.make_cuda_render_fn(sd, cam, 32, 24, spp=1, engine="fused")


def _fused_bounce(cuda, case):
    """``_grad_bounce``'s bounce, its stream's buffer to copy from, and
    K11's keyword arguments and tree."""
    wf, t, meta, b, kw, args = _grad_bounce(cuda, case)
    return wf, t, meta, b, kw, args, b["buf"].clone()


def _fresh(wf, base):
    b = base.clone()
    return b[:wf.N_CH], b[wf.N_CH:].view(torch.int32)


@pytest.mark.parametrize("case", ["scene200", "padding"])
@pytest.mark.parametrize("precull", [True, False])
def test_k11_matches_plain_and_split(cuda, case, precull):
    """K11 in the render's form (the list sweep culled by the leaf blocks'
    boxes, or the walk) against its plain version at K1's bar and K11g's
    record equal to the plain K11g's; K11 and K11g give one state bit for
    bit; on the 200-sphere scene, where no ray wins a padding slot, K11
    equals K6+K7 bit for bit and K11g's record K6's residual and K9's
    verdict."""
    from spt_tpu_torch.kernels import wavefront_grad as wg
    wf, t, meta, b, kw, args, base = _fused_bounce(cuda, case)
    n = b["n"]
    kw = dict(kw, precull=precull, boxes=wf.leaf_boxes(
        *wf._leaf_block_bounds(t["prims"].reshape(-1, 5, kw["block"]))))
    fargs = (t["blob"], meta, t["lsb"], t["nodef"], t["nodei"], t["prims"],
             t["mtypes"], b["cand"], b["ctn"])
    st, ids = _fresh(wf, base)
    before = dict(mk.LAUNCHES)
    wf.bounce(*fargs, st, ids, n, **kw)
    out_g, res_g = wg.bounce_fwd(*fargs, *_fresh(wf, base), n, **kw)
    assert mk.LAUNCHES == dict(before, k11=before["k11"] + 1,
                               k11g=before["k11g"] + 1)
    assert torch.equal(out_g.view(torch.int32), st.view(torch.int32))
    st_p, ids_p = _fresh(wf, base)
    wf.bounce_plain(*fargs, st_p, ids_p, n, **kw)
    _, res_p = wg.bounce_fwd_plain(*fargs, *_fresh(wf, base), n, **kw)
    assert torch.equal(res_g.view(torch.int32), res_p.view(torch.int32))
    got, want = st.cpu().numpy(), st_p.cpu().numpy()
    assert np.isfinite(got).all()
    assert np.isclose(got, want, rtol=RTOL, atol=ATOL).mean() >= MIN_CLOSE
    padding = int(((b["res"][4] < 0) & (b["res"][5] >= 0)).sum())
    assert (padding > 0) == (case == "padding")
    if case == "scene200":
        kw7 = {a: v for a, v in kw.items() if a not in ("precull", "boxes")}
        st7, ids7 = _fresh(wf, base)
        out9, blocked = wg.shade_fwd(*args, st7, ids7, b["res"], n, **kw7)
        wf.shade(*args, st7, ids7, b["res"], n, **kw7)
        assert torch.equal(st.view(torch.int32), st7.view(torch.int32))
        assert torch.equal(res_g[:7], b["res"][:7])
        assert torch.equal(res_g[7], blocked) and float(blocked.sum()) > 0


@pytest.mark.parametrize("case", ["scene200", "padding"])
def test_k11_culled_sweep_matches_plain(cuda, case):
    """K11 and K11g with the list sweep culled by the leaf blocks' boxes
    (the render's form) against their plain versions with the same boxes:
    the record bit for bit, the state at K1's bar; against the plain
    unculled sweep, lanes part only where a winner ties exactly in t or is
    a padding slot.  Given the lists without the boxes, K11 refuses."""
    from spt_tpu_torch.kernels import wavefront_grad as wg
    wf, t, meta, b, kw, _, base = _fused_bounce(cuda, case)
    n = b["n"]
    boxes = wf.leaf_boxes(*wf._leaf_block_bounds(
        t["prims"].reshape(-1, 5, kw["block"])))
    fargs = (t["blob"], meta, t["lsb"], t["nodef"], t["nodei"], t["prims"],
             t["mtypes"], b["cand"], b["ctn"])
    st, ids = _fresh(wf, base)
    wf.bounce(*fargs, st, ids, n, precull=True, boxes=boxes, **kw)
    out_g, res_g = wg.bounce_fwd(*fargs, *_fresh(wf, base), n, precull=True,
                                 boxes=boxes, **kw)
    assert torch.equal(out_g.view(torch.int32), st.view(torch.int32))
    st_p, ids_p = _fresh(wf, base)
    wf.bounce_plain(*fargs, st_p, ids_p, n, precull=True, boxes=boxes, **kw)
    _, res_p = wg.bounce_fwd_plain(*fargs, *_fresh(wf, base), n,
                                   precull=True, boxes=boxes, **kw)
    assert torch.equal(res_g.view(torch.int32), res_p.view(torch.int32))
    got, want = st.cpu().numpy(), st_p.cpu().numpy()
    assert np.isclose(got, want, rtol=RTOL, atol=ATOL).mean() >= MIN_CLOSE
    _, res_u = wg.bounce_fwd_plain(*fargs, *_fresh(wf, base), n,
                                   precull=True, **kw)
    with pytest.raises(ValueError, match="boxes"):
        wf.bounce(*fargs, *_fresh(wf, base), n, precull=True, **kw)
    head = base[:wf.N_CH, :n]
    pad = ((res_u[4] < 0) & (res_u[5] >= 0)) | ((res_g[4] < 0)
                                                & (res_g[5] >= 0))
    tie = (wf.winner_t(head, res_u) == wf.winner_t(head, res_g)) & ~pad
    differ = (res_u.view(torch.int32) != res_g.view(torch.int32)).any(0)
    assert not bool((differ & ~pad & ~tie).any())


def test_k6m_k7m_match_plain(cuda):
    """K6m's residual, its sweep culled by the leaf boxes, equals the
    plain K6m's with the same boxes bit for bit on a bounce's per-row
    lists, and parts from the plain unculled sweep only at exact ties and
    box edges; without the boxes K6m refuses.  K7m's verdict pass equals
    the plain pass's verdicts bit for bit, and K7m's state meets K1's bar
    against the plain K7m's."""
    wf, t, meta, b, kw, _, base = _fused_bounce(cuda, "scene200")
    n, st, ids, prims = b["n"], b["st"], b["ids"], t["prims"]
    block = kw["block"]
    lob, hib = wf._leaf_block_bounds(prims.reshape(-1, 5, block))
    cand, ctn = wf.precull_tiles(
        tuple(st[c, :n] for c in range(3)),
        tuple(st[c, :n] for c in range(3, 6)), st[wf.C_ALIVE, :n], None,
        lob, hib, per_row=True)
    bctr, cslot = wf.mxu_tables(dict(prims=prims), block)
    boxes = wf.leaf_boxes(lob, hib)
    before = dict(mk.LAUNCHES)
    res = wf.isect_mxu(prims, cslot, bctr, cand, ctn, st, n, block=block,
                       boxes=boxes)
    assert mk.LAUNCHES == dict(before, k6m=before["k6m"] + 1)
    assert torch.equal(res.view(torch.int32), wf.isect_mxu_plain(
        prims, cslot, bctr, cand, ctn, st, n, block=block,
        boxes=boxes).view(torch.int32))
    assert int((res[4] >= 0).sum()) > 0
    res_u = wf.isect_mxu_plain(prims, cslot, bctr, cand, ctn, st, n,
                               block=block)
    why = cull_differ(torch, wf, st[:, :n], res_u, res, boxes)
    assert why["other"] == why["padding"] == 0, why
    with pytest.raises(ValueError, match="boxes"):
        wf.isect_mxu(prims, cslot, bctr, cand, ctn, st, n, block=block)
    so3, sd3, stmax, sneed = wf.shadow_rays(
        st[:, :n], ids[:, :n], res, t["blob"], t["lsb"], kw["n_light_slots"],
        k=kw["k"], seed=3, n_mats=kw["n_mats"],
        mtypes=[int(v) for v in t["mtypes"].tolist()],
        n_light_slots=kw["n_light_slots"])
    scand, sctn = wf.precull_tiles(so3, sd3, sneed, stmax, lob, hib,
                                   per_row=True)
    args = (t["blob"], meta, t["lsb"], prims, cslot, bctr, t["mtypes"], scand,
            sctn)
    sray = torch.stack([*so3, *sd3, stmax, sneed])
    st_k, ids_k = _fresh(wf, base)
    res_k, res_p = res.clone(), res.clone()
    wf.shade_mxu(*args, st_k, ids_k, res_k, n, sray=sray, **kw)
    assert mk.LAUNCHES["k7m"] == before["k7m"] + 1
    assert mk.LAUNCHES["k7mv"] == before["k7mv"] + 1
    st_p, ids_p = _fresh(wf, base)
    wf.shade_mxu_plain(*args, st_p, ids_p, res_p, n, sray=sray, **kw)
    assert torch.equal(res_k, res_p) and float(res_k[7].sum()) > 0
    got, want = st_k.cpu().numpy(), st_p.cpu().numpy()
    assert np.isfinite(got).all()
    assert np.isclose(got, want, rtol=RTOL, atol=ATOL).mean() >= MIN_CLOSE


@pytest.mark.parametrize("mode", ["fused", "walk", "mxu"])
def test_fused_and_mxu_renders_match_plain(cuda, mode):
    """``render_wavefront(split=False)`` (K11, with the precull or the
    walk) and ``render_wavefront(mxu=True)`` (K6m, K7m) against their plain
    stages at K1's bar; the fused render equal to the split one, the
    matmul form within JAX's bar for it (99.9% of values within 1e-4 +
    1e-3 |a|)."""
    wf, sd, _, _, _ = _wf_case(cuda)
    cam = _scene200_camera(cuda, False)
    kw = dict(max_bounces=8, rr_depth=3, seed=3, sort_min_rays=0,
              **{"fused": dict(split=False), "walk": dict(
                  split=False, precull=False), "mxu": dict(mxu=True)}[mode])
    before = dict(mk.LAUNCHES)
    got = wf.render_wavefront(sd, cam, 48, 40, 0, 2, **kw)
    runs = {k: mk.LAUNCHES[k] - before[k] for k in before}
    want_k = ("k6m", "k7m", "k7mv") if mode == "mxu" else ("k11",)
    assert all(runs[k] > 0 for k in want_k) and runs["plain"] == 0
    assert all(v == 0 for k, v in runs.items() if k not in want_k + ("k5",))
    want = wf._render(sd, cam, 48, 40, 0, 2, stages=wf.PLAIN, **kw)
    got, want = got.cpu().numpy(), want.cpu().numpy()
    assert np.isfinite(got).all() and want.mean() > 0.01
    close = np.isclose(got, want, rtol=RTOL, atol=ATOL).all(axis=-1)
    assert close.mean() >= MIN_CLOSE
    split = wf.render_wavefront(sd, cam, 48, 40, 0, 2, max_bounces=8,
                                rr_depth=3, seed=3, sort_min_rays=0).cpu()
    if mode == "mxu":           # JAX's bar for the matmul form
        a = split.numpy()
        assert (np.abs(got - a) < 1e-4 + 1e-3 * np.abs(a)).mean() > 0.999
    else:
        assert torch.equal(torch.from_numpy(got), split)


def test_fused_wavefront_grad_matches_plain(cuda):
    """``make_wavefront_render_fn(split=False)``: K5 and K11g forward, K10
    backward, against its plain stages (image at K1's bar, gradients at
    GRAD_REL), its value and gradients as the split render's."""
    from spt_tpu_torch.kernels import wavefront_grad as wg
    sd = scene_200(T).compile(device=cuda)
    cam = _scene200_camera(cuda, False)
    ct = _ct(cuda, 48, 40)
    out = []
    for stages, split in ((wg.KERNELS, False), (wg.PLAIN, False),
                          (wg.KERNELS, True)):
        render = wg._make_render_fn(
            sd, cam, 48, 40, stages=stages, spp=2, max_bounces=8, rr_depth=3,
            use_nee=True, use_mis=True, seed=3, sort_min_rays=0,
            chunk_rays=2 << 20, split=split)
        params = {k: v.clone().requires_grad_(True) for k, v in
                  G.get_params(sd, cuda_diff.PARAM_KEYS).items()}
        before = dict(mk.LAUNCHES)
        img = render(params, 0)
        (img * ct).sum().backward()
        runs = {k: mk.LAUNCHES[k] - before[k] for k in before}
        out.append((img.detach(), {k: v.grad for k, v in params.items()},
                    runs))
    (img, grads, runs), (img_p, grads_p, runs_p), (img_s, grads_s, _) = out
    assert runs["k11g"] > 0 and runs["k10"] == runs["k11g"]
    assert runs["k6"] == runs["k9"] == runs["plain"] == 0
    assert runs_p["k11g"] == 0 and runs_p["plain"] > 0
    got, want = img.cpu().numpy(), img_p.cpu().numpy()
    close = np.isclose(got, want, rtol=RTOL, atol=ATOL).all(axis=-1)
    assert close.mean() >= MIN_CLOSE and want.mean() > 0.01
    errs, _ = tail_field_errors(grads, grads_p)
    assert all(e["ok"] for e in errs.values()), errs
    assert torch.equal(img, img_s)
    for k in grads:
        torch.testing.assert_close(grads[k], grads_s[k], rtol=1e-5,
                                   atol=1e-7)


def test_cli_resume_on_the_card(cuda, tmp_path):
    """The CLI through K1: 16 spp with a checkpoint, resumed to 32, equals
    an uninterrupted 32-spp run (rtol 1e-6, atol 1e-7, as the JAX CLI's
    test)."""
    from pathlib import Path

    from spt_tpu_torch.apps import render_cli
    scene = str(Path(__file__).resolve().parent.parent / "scenes"
                / "cornell.json")
    kw = ["--size", "64", "64", "--chunk", "8", "-q"]
    direct, resumed = str(tmp_path / "d.npy"), str(tmp_path / "r.npy")
    state = str(tmp_path / "s.npz")
    before = mk.LAUNCHES["k1"]
    assert render_cli.main([scene, "-o", direct, "--spp", "32", *kw]) == 0
    assert render_cli.main([scene, "-o", str(tmp_path / "p.npy"), "--spp",
                            "16", "--checkpoint", state, *kw]) == 0
    assert render_cli.main([scene, "-o", resumed, "--spp", "32", "--resume",
                            state, *kw]) == 0
    assert mk.LAUNCHES["k1"] - before == 4 + 2 + 2
    np.testing.assert_allclose(np.load(resumed), np.load(direct), rtol=1e-6,
                               atol=1e-7)


def test_reference_mode_on_the_card_matches_cpu(cuda):
    """The reference integrator on demo38 at 64x48, frames 0-3, on the card
    against the CPU at the JAX parity bar (each frame: atol 2e-3, 99.5% of
    pixels within 1e-4); the facade's reference mode launches no kernel."""
    from spt_tpu_torch.engine.integrator import render_reference_sample
    sd_c = T.demo_scene_38_spheres().compile(device=cuda)
    sd_h = T.demo_scene_38_spheres().compile(device="cpu")
    for frame in range(4):
        got = render_reference_sample(sd_c, 64, 48, frame).cpu().numpy()
        want = render_reference_sample(sd_h, 64, 48, frame).numpy()
        np.testing.assert_allclose(got, want, atol=2e-3, rtol=0)
        assert np.all(np.abs(got - want) < 1e-4, axis=-1).mean() > 0.995
        assert want.mean() > 0.1
    tr = T.create_path_tracer("cuda", device=cuda)
    tr.set_scene(T.demo_scene_38_spheres())
    s = T.RenderSettings()
    s.set_resolution(64, 48)
    s.integrator = "reference"
    tr.set_settings(s)
    before = dict(mk.LAUNCHES)
    tr.render(spp=4)
    assert dict(mk.LAUNCHES) == before
    assert tr.get_state()["accum"].device.type == "cuda"


def test_inverse_app_loss_falls_on_the_card(cuda):
    """The inverse-render app at its default scene and size, 60 steps:
    K1 forward and K2 backward each step, and the loss falls: the image
    loss of the result below the start's on the same 16 samples (a step's
    loss is over fresh samples, whose noise outweighs the parameters'
    error)."""
    from spt_tpu_torch.apps import inverse_render
    stats = {}
    before = dict(mk.LAUNCHES)
    assert inverse_render.main(["--steps", "60"], stats=stats) == 0
    runs = {k: mk.LAUNCHES[k] - before[k] for k in before}
    assert runs["k2"] == 60 and runs["k1"] >= 60 and runs["plain"] == 0
    losses = np.asarray(stats["losses"])
    assert np.isfinite(losses).all()
    assert stats["loss_after"] < stats["loss_before"]
