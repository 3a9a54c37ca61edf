"""The wavefront's fused bounce (K11, K11g) and matmul-form sweeps (K6m,
K7m): their plain versions and glue, within the port, on the CPU.

* The fused forward (``render_wavefront(split=False)``) equals the split
  one bit for bit, with either sky, its nearest hit by the precull's lists
  or by the walk, as tests/test_wavefront.py pins JAX's: the nearest winner
  and every shadow verdict are the same however they are found.
* The fused gradient (``make_wavefront_render_fn(split=False)``) equals the
  split one: the value to rtol 1e-6, albedo, centres and radii to rtol
  1e-5, atol 1e-7 (tests/test_wavefront_grad.py's bars for JAX's).
* A ray whose winner is a leaf's padding slot: the fused bounce shades it
  as a hit with no material (JAX's fused rule), where the split one takes
  the sky; every other lane's state is the same bit for bit, and the
  padding lanes take no geometry gradient.
* The matmul form (``mxu=True``) against the split render at JAX's bar for
  it: 99.9% of pixels within 1e-4 + 1e-3 |a| (the expanded quadratic
  rounds otherwise), with either sky.
* The per-row lists: each row's bounds nondecreasing, each row's list
  within its tile's, and the tile's list rebuilt from its rows' equal to
  the per-tile precull bit for bit.
* ``build_cmat`` and ``_seg_blocked`` against the JAX package's on random
  inputs from a numpy seed: the table to 1 ulp, the verdicts exactly.
* Which paths build lists: the split path (forward and gradient) and the
  fused walk none, the fused bounce with ``precull`` the nearest-hit lists,
  the matmul form those and the shadow lists.
* The fused bounce's list sweep culled by the leaf blocks' boxes (the
  render's) against the unculled sweep, on bounces 0 and 1 of the 300-sphere
  scene and bounce 0 of the padding scene: the same state and record bit
  for bit but on lanes whose winner ties exactly in t or is a padding slot.
* K7m's slot-major copy of ``build_cmat``'s tables holds its columns bit
  for bit, built once a packing.
* K7m's verdict pass: its plain version's verdicts equal ``_sweep_anyhit``'s
  with ``mxu=`` on the glue's shadow rays, and the plain K7m (the pass,
  then the bounce reading residual row 7) writes them there.

Config 5 cut to 300 spheres (160 for the gradients), leaf block 8, at most
32x32 pixels, depth 3.  Whole renders against JAX's are in
``test_torch_wavefront_fused_jax.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import spt_tpu_torch
from spt_tpu.kernels import megakernel_bvh as jmbvh
from spt_tpu_torch.diff import gradients as TG
from spt_tpu_torch.kernels import megakernel as tmega
from spt_tpu_torch.kernels import wavefront as twf
from spt_tpu_torch.kernels import wavefront_grad as twg
from chip_smoke import (CAM_10K, PAD_CAM, env_gradient, padding_scene,
                        scene_10k, wf_advance, wf_bounce, wf_inputs)

# One intra-op thread: these tests trace small tensors, where torch's
# idle OpenMP workers would only spin against the other test processes.
torch.set_num_threads(1)

CPU = "cpu"
KW = dict(max_bounces=3, rr_depth=2, use_nee=True, use_mis=True, seed=5,
          block=8, sort_min_rays=0)


def _scene(n, sky="gradient"):
    scene = scene_10k(spt_tpu_torch, n=n)
    if sky == "envmap":
        scene.set_environment_map(env_gradient(16, 32))
    return scene.compile(device=CPU)


def _camera():
    return spt_tpu_torch.Camera.look_at(device=CPU, **CAM_10K)


@pytest.fixture(scope="module")
def split_images():
    return {sky: twf.render_wavefront(_scene(300, sky), _camera(), 32, 32, 0,
                                      1, **KW).numpy()
            for sky in ("gradient", "envmap")}


@pytest.mark.parametrize("sky", ["gradient", "envmap"])
@pytest.mark.parametrize("precull", [True, False])
def test_fused_equals_split(split_images, sky, precull):
    before = dict(tmega.LAUNCHES)
    got = twf.render_wavefront(_scene(300, sky), _camera(), 32, 32, 0, 1,
                               split=False, precull=precull, **KW).numpy()
    # One raygen, one fused bounce a bounce with alive rays, nothing else.
    assert 2 <= tmega.LAUNCHES["plain"] - before["plain"] <= 4
    want = split_images[sky]
    assert np.isfinite(got).all() and want.mean() > 0.05
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("sky", ["gradient", "envmap"])
def test_mxu_matches_split(split_images, sky):
    got = twf.render_wavefront(_scene(300, sky), _camera(), 32, 32, 0, 1,
                               mxu=True, **KW).numpy()
    want = split_images[sky]
    assert np.isfinite(got).all()
    close = np.abs(got - want) < 1e-4 + 1e-3 * np.abs(want)
    assert close.mean() > 0.999, f"only {close.mean():.5f} close"


@pytest.mark.parametrize("precull", [True, False])
def test_fused_grad_equals_split(precull):
    sd = _scene(160)
    kw = dict(max_bounces=3, rr_depth=2, seed=5, sort_min_rays=0)
    out = []
    for split in (True, False):
        render = twg.make_wavefront_render_fn(sd, _camera(), 16, 16, spp=2,
                                              split=split, precull=precull,
                                              **kw)
        params = {k: v.clone().requires_grad_(True) for k, v in
                  TG.get_params(sd, ("albedo", "centers", "radii")).items()}
        value = render(params, 0).sum()
        value.backward()
        out.append((float(value.detach()),
                    {k: p.grad.numpy() for k, p in params.items()}))
    (v_s, g_s), (v_f, g_f) = out
    np.testing.assert_allclose(v_f, v_s, rtol=1e-6)
    assert abs(g_s["albedo"]).sum() > 0 and abs(g_s["centers"]).sum() > 0
    for key in g_s:
        np.testing.assert_allclose(g_f[key], g_s[key], rtol=1e-5, atol=1e-7,
                                   err_msg=key)


def test_padding_winners_fused_rule():
    """One bounce of the padding scene: the fused bounce and K6+K7 agree
    bit for bit on every lane but those whose winner is a padding slot;
    there K7 adds the sky and ends the path, K11 shades a hit with no
    material (no radiance added at a bounce, the path goes on), and K11g's
    record gives K6's residual (id -1, the slot's block) on which K10
    gives them no geometry cotangent."""
    sd = padding_scene(spt_tpu_torch).compile(device=CPU)
    cam = spt_tpu_torch.Camera.look_at(device=CPU, **PAD_CAM)
    t, stc, meta = wf_inputs(torch, twf, twf, sd, cam, 4)
    b = wf_bounce(torch, twf, t, stc, meta, 16, 16, 0, 4)
    n, res = b["n"], b["res"]
    padding = ((res[4] < 0) & (res[5] >= 0))[:n]
    assert int(padding.sum()) > 0
    kw = dict(k=0, block=stc["block"], n_mats=stc["n_mats"],
              n_light_slots=stc["n_light_slots"], rr_depth=5, use_nee=True,
              use_mis=True, sky_mode=sd.sky_mode)
    base = b["buf"].clone()
    st7, ids = base[:twf.N_CH].clone(), base[twf.N_CH:].view(torch.int32)
    twf.shade_plain(t["blob"], meta, t["lsb"], t["prims"], t["mtypes"],
                    b["scand"], b["sctn"], st7, ids, res, n, **kw)
    st11, rec = twg.bounce_fwd_plain(
        t["blob"], meta, t["lsb"], t["nodef"], t["nodei"], t["prims"],
        t["mtypes"], b["cand"], b["ctn"], base[:twf.N_CH], ids, n,
        precull=True, **kw)
    assert torch.equal(rec[:7], res[:7])
    a, c = st11[:, :n].view(torch.int32), st7[:, :n].view(torch.int32)
    assert torch.equal(a[:, ~padding], c[:, ~padding])
    pre = base[:twf.N_CH, :n]
    rad = slice(twf.C_LR, twf.C_LB + 1)
    assert torch.equal(st11[rad, :n][:, padding], pre[rad][:, padding])
    assert bool((st7[rad, :n][:, padding] > pre[rad][:, padding]).all())
    assert not bool(st7[twf.C_ALIVE, :n][padding].any())
    assert bool(st11[twf.C_ALIVE, :n][padding].any())
    ct = torch.from_numpy(np.random.default_rng(7).normal(
        size=tuple(st7.shape)).astype(np.float32))
    _, dgeo, _ = twg.bounce_bwd_plain(
        t["blob"], meta, t["lsb"], t["mtypes"], base[:twf.N_CH], ids, rec,
        ct, n, **{k: v for k, v in kw.items() if k != "block"})
    assert float(dgeo[:, padding].abs().sum()) == 0.0
    assert float(dgeo[:, ~padding].abs().sum()) > 0.0


def test_per_row_lists():
    sd = _scene(300)
    t, stc, meta = wf_inputs(torch, twf, twf, sd, _camera(), 5)
    b = wf_bounce(torch, twf, t, stc, meta, 64, 32, 0, 5)
    st, n = b["st"], b["n"]
    lob, hib = twf._leaf_block_bounds(t["prims"].reshape(-1, 5, 8))
    rays = (tuple(st[c, :n] for c in range(3)),
            tuple(st[c, :n] for c in range(3, 6)), st[twf.C_ALIVE, :n],
            None, lob, hib)
    cand, ctn = twf.precull_tiles(*rays)
    rcand, rctn = twf.precull_tiles(*rays, per_row=True)
    nb = lob.shape[0]
    assert rcand.shape == (n // twf.TILE, 8, nb + 1)
    assert rctn.shape == (n // twf.TILE, 8, nb)
    assert int((rcand[:, :, 0] > 0).sum()) > 0
    assert bool((rctn[..., 1:] >= rctn[..., :-1]).all())
    # Each block's least row bound is its tile bound: the tile's list.
    bound = torch.full((n // twf.TILE, nb + 1), twf.BIG)
    ids = torch.where(rcand[..., 1:] >= 0, rcand[..., 1:].long(), nb)
    for r in range(8):
        bound = bound.scatter_reduce(1, ids[:, r], rctn[:, r], "amin")
    tile = torch.full_like(bound, twf.BIG).scatter_(
        1, torch.where(cand[:, 0, 1:] >= 0, cand[:, 0, 1:].long(), nb),
        ctn[:, 0])
    assert torch.equal(bound[:, :nb], tile[:, :nb])
    assert torch.equal((bound[:, :nb] < twf.BIG).sum(1).int(), cand[:, 0, 0])


def test_build_cmat_matches_jax():
    rng = np.random.default_rng(17)
    prims = rng.uniform(-50.0, 50.0, (12, 5, 8)).astype(np.float32)
    prims[:, 3] = rng.uniform(0.2, 0.9, (12, 8))
    prims[:, 4] = rng.integers(0, 4, (12, 8))
    prims[3:, 4, 5:] = -1.0                   # underfull blocks
    prims[3:, :4, 5:] = 0.0
    prims[7, 4] = -1.0                        # an empty block
    prims[7, :4] = 0.0
    cm, ctr = twf.build_cmat(torch.from_numpy(prims))
    cm_j, ctr_j = jmbvh.build_cmat(jnp.asarray(prims))
    np.testing.assert_array_equal(ctr.numpy(), np.asarray(ctr_j))
    np.testing.assert_array_max_ulp(cm.numpy(), np.asarray(cm_j), maxulp=1)
    assert cm.shape == (12, 8, 16)


def test_seg_blocked_matches_jax():
    rng = np.random.default_rng(23)
    b = rng.normal(0.0, 3.0, 20000).astype(np.float32)
    cterm = (b * b - rng.normal(0.0, 2.0, 20000)).astype(np.float32)
    tmax = rng.uniform(-1.0, 6.0, 20000).astype(np.float32)
    b[:200] = 1e-3                            # the strict edges
    tmax[200:400] = b[200:400]
    got = twf._seg_blocked(*(torch.from_numpy(a) for a in (b, cterm, tmax)))
    want = jmbvh._seg_blocked(jnp.asarray(b), jnp.asarray(cterm),
                              jnp.asarray(tmax), jnp.ones(20000, bool))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert 0 < int(got.sum()) < 20000


@pytest.mark.parametrize("path,precull,shadow", [
    ("split", 0, 0), ("split_grad", 0, 0), ("fused_walk", 0, 0),
    ("fused", 1, 0), ("mxu", 2, 1)])
def test_which_paths_build_lists(path, precull, shadow):
    """The split path, forward and under grad, walks the tree and calls
    neither ``precull_tiles`` nor ``shadow_rays`` (``GLUE_CALLS``); a
    bounce of the fused bounce with ``precull`` builds the nearest-hit
    lists and without it none, one of the matmul form both lists."""
    sd = _scene(160)
    before = dict(twf.GLUE_CALLS)
    if path == "split_grad":
        render = twg.make_wavefront_render_fn(
            sd, _camera(), 16, 16, spp=1, max_bounces=2, rr_depth=2, seed=5,
            sort_min_rays=0)
        params = {k: v.clone().requires_grad_(True) for k, v in
                  TG.get_params(sd, ("albedo", "centers")).items()}
        render(params, 0).sum().backward()
    else:
        opts = {"split": {}, "fused_walk": dict(split=False, precull=False),
                "fused": dict(split=False), "mxu": dict(mxu=True)}[path]
        twf.render_wavefront(sd, _camera(), 16, 16, 0, 1, **dict(
            KW, max_bounces=2), **opts)
    calls = {k: twf.GLUE_CALLS[k] - before[k] for k in before}
    bounces = 2
    assert calls == {"precull": bounces * precull,
                     "shadow_rays": bounces * shadow}, calls


@pytest.mark.parametrize("case", ["config5_300", "padding"])
def test_culled_sweep_equals_unculled(case):
    """K11's plain version with the leaf blocks' boxes (each lane skips a
    candidate its ray misses or enters past its nearest t) against it
    without them (every candidate taken is swept): the state and K11g's
    record equal bit for bit but on lanes where the two winners tie
    exactly in t or one is a padding slot, which the boxes leave out."""
    if case == "padding":
        sd = padding_scene(spt_tpu_torch).compile(device=CPU)
        cam = spt_tpu_torch.Camera.look_at(device=CPU, **PAD_CAM)
        seed, bounces = 4, (0,)
    else:
        sd, cam, seed, bounces = _scene(300), _camera(), 5, (0, 1)
    t, stc, meta = wf_inputs(torch, twf, twf, sd, cam, seed)
    boxes = twf.leaf_boxes(*twf._leaf_block_bounds(
        t["prims"].reshape(-1, 5, stc["block"])))
    b = wf_bounce(torch, twf, t, stc, meta, 16, 16, 0, seed)
    culled = 0
    for k in bounces:
        if k:
            b = wf_advance(torch, twf, t, stc, meta, b, k - 1, seed,
                           sd.sky_mode)
        n, ids = b["n"], b["ids"]
        kw = dict(k=k, block=stc["block"], n_mats=stc["n_mats"],
                  n_light_slots=stc["n_light_slots"], rr_depth=2,
                  use_nee=True, use_mis=True, sky_mode=sd.sky_mode,
                  precull=True)
        outs = []
        for bx in (None, boxes):
            stats = {}
            st, rec = twg.bounce_fwd_plain(
                t["blob"], meta, t["lsb"], t["nodef"], t["nodei"],
                t["prims"], t["mtypes"], b["cand"], b["ctn"], b["st"], ids,
                n, boxes=bx, stats=stats, **kw)
            outs.append((st[:, :n], rec, stats))
        (st_u, rec_u, s_u), (st_c, rec_c, s_c) = outs
        culled += s_c["culled_blocks"]
        # The unculled sweep takes the same candidates: the culled ones and
        # the ones swept add up to them.
        assert s_c["blocks"] + s_c["culled_blocks"] == s_u["blocks"]
        assert "culled_blocks" not in s_u
        head = b["st"][:, :n]
        pad = ((rec_u[4] < 0) & (rec_u[5] >= 0)) | ((rec_c[4] < 0)
                                                    & (rec_c[5] >= 0))
        tie = (twf.winner_t(head, rec_u) == twf.winner_t(head, rec_c)) & ~pad
        differ = ((st_u.view(torch.int32) != st_c.view(torch.int32)).any(0)
                  | (rec_u.view(torch.int32)
                     != rec_c.view(torch.int32)).any(0))
        assert not bool((differ & ~pad & ~tie).any()), \
            f"bounce {k}: {int((differ & ~pad & ~tie).sum())} lanes differ"
        if case == "config5_300":
            assert int(differ.sum()) == 0
    if case == "config5_300":
        assert culled > 0


def test_slot_major_table():
    """``mxu_tables``: ``build_cmat``'s tables and K7m's slot-major copy,
    column c of block b the 8 floats of ``cmat[b, :, c]`` bit for bit,
    built once and kept with the packing."""
    t, stc, _ = wf_inputs(torch, twf, twf, _scene(160), _camera(), 5)
    t = dict(t)
    cmat, bctr, cslot = twf.mxu_tables(t, stc["block"])
    want, want_c = twf.build_cmat(t["prims"].reshape(-1, 5, stc["block"]))
    assert torch.equal(cmat, want) and torch.equal(bctr, want_c)
    nb, block = cmat.shape[0], stc["block"]
    assert cslot.shape == (nb, 2 * block, 8) and cslot.is_contiguous()
    assert torch.equal(cslot.view(torch.int32),
                       cmat.transpose(1, 2).contiguous().view(torch.int32))
    assert torch.equal(cslot[1, 2 * block - 1], cmat[1, :, 2 * block - 1])
    assert twf.mxu_tables(t, block)[2] is cslot


def test_mxu_verdict_pass_plain():
    """The plain K7m on a bounce of the 300-sphere scene: the verdicts its
    pass sweeps (``mxu_verdicts_plain``, reading the slot-major copy) are
    ``_sweep_anyhit``'s with ``mxu=`` on ``build_cmat``'s tables, on the
    glue's shadow rays over the per-row lists; they fill every lane, land in
    residual row 7, and some rays are blocked and some not; without the
    rays it refuses to shade with NEE."""
    sd = _scene(300)
    t, stc, meta = wf_inputs(torch, twf, twf, sd, _camera(), 5)
    b = wf_bounce(torch, twf, t, stc, meta, 16, 16, 0, 5)
    n, st, ids, block = b["n"], b["st"], b["ids"], stc["block"]
    cmat, bctr, cslot = twf.mxu_tables(dict(prims=t["prims"]), block)
    lob, hib = twf._leaf_block_bounds(t["prims"].reshape(-1, 5, block))
    cand, ctn = twf.precull_tiles(
        tuple(st[c, :n] for c in range(3)),
        tuple(st[c, :n] for c in range(3, 6)), st[twf.C_ALIVE, :n], None,
        lob, hib, per_row=True)
    res = twf.isect_mxu(t["prims"], cmat, bctr, cand, ctn, st, n, block=block)
    nls = stc["n_light_slots"]
    so3, sd3, stmax, sneed = twf.shadow_rays(
        st[:, :n], ids[:, :n], res, t["blob"], t["lsb"], nls, k=0, seed=5,
        n_mats=stc["n_mats"], mtypes=stc["mtypes"], n_light_slots=nls)
    scand, sctn = twf.precull_tiles(so3, sd3, sneed, stmax, lob, hib,
                                    per_row=True)
    sray = torch.stack([*so3, *sd3, stmax, sneed])
    got = torch.full((n,), -1.0)
    twf.mxu_verdicts_plain(t["prims"], cslot, bctr, scand, sctn, sray, got, n,
                           block=block)
    want = twf._sweep_anyhit(t["prims"].reshape(-1, 5, block), scand, sctn,
                             so3, sd3, stmax, sneed > 0.5,
                             mxu=(cmat, bctr))
    assert torch.equal(got, want.to(torch.float32))
    assert 0 < int(got.sum()) < int((sneed > 0.5).sum())
    kw = dict(k=0, block=block, n_mats=stc["n_mats"], n_light_slots=nls,
              rr_depth=2, use_nee=True, use_mis=True, sky_mode=sd.sky_mode)
    buf, rec = b["buf"].clone(), res.clone()
    twf.shade_mxu(t["blob"], meta, t["lsb"], t["prims"], cslot, bctr,
                  t["mtypes"], scand, sctn, buf[:twf.N_CH],
                  buf[twf.N_CH:].view(torch.int32), rec, n, sray=sray, **kw)
    assert torch.equal(rec[7], got) and torch.equal(rec[:7], res[:7])
    with pytest.raises(ValueError, match="sray"):
        twf.shade_mxu(t["blob"], meta, t["lsb"], t["prims"], cslot, bctr,
                      t["mtypes"], scand, sctn, buf[:twf.N_CH],
                      buf[twf.N_CH:].view(torch.int32), rec, n, sray=None,
                      **kw)
