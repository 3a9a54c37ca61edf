"""The sorted wavefront's plain versions and glue against the JAX package.

* K5's plain version against JAX's raygen kernel (interpret mode): ids,
  flags, throughput and radiance channels and pinhole origins equal bit for
  bit; directions (and thin-lens origins) to 5e-7.  JAX normalizes with
  ``lax.rsqrt``, which XLA's CPU backend computes approximately (about a
  third of its values lie 1-3 ulp from the rounded 1/sqrt that the port
  and its kernels compute, as K1 has since it was ported), and XLA's sin
  and cos round otherwise than PyTorch's.
* The sort key, the leaf-block boxes, the precull's candidate lists (ids
  and bounds) and the image scatter equal JAX's bit for bit on the same
  numpy-made inputs.  The shadow rays rebuilt from a residual: the lanes
  that need one equal; directions to 2e-6, origins to a relative 1e-6 and
  t_max to 2e-5, and all bit for bit on 95% of the lanes (the shading
  normal and the light sample's frame go through the same rsqrt, sin and
  cos, and t_max cancels where a shadow ray grazes its light).
* The plain K6's winner equals brute force over every sphere exactly, over
  the lists (its per-lane early exit included) and by its walk of the tree
  (its tree mode, the split path's); the walk and the lists part only at
  exact t-ties and padding winners; what the sweeps read of the lists (the
  kernels' byte counts) equals a walk of each lane on its own.
* K8's plain version (the bounce's shadow verdicts, each ray walking a
  tree) equals the glue's shadow rays walked by ``_Walk.anyhit``, on the
  whole tree and on each prim=2 shard's.
* The plain wavefront against the plain K3 at the JAX suite's bar (97% of
  pixels ``isclose(rtol=2e-3, atol=2e-4)``, means within 1%); and, as
  tests/test_wavefront.py pins JAX's, exactly invariant to the sort, to
  the tiered prefix sorts and to chunking, at two samples a pixel in a
  chunk (two values add exactly in any order; with more, a sort changes
  the order of the scatter's sums, by up to 8e-6 at four).

Whole renders against JAX's ``render_wavefront`` are in
``test_torch_wavefront_jax.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import spt_tpu
import spt_tpu_torch
from spt_tpu.kernels import megakernel_bvh as jmbvh
from spt_tpu.kernels import physics as jphys
from spt_tpu.kernels import wavefront as jwf
from spt_tpu_torch.kernels import megakernel as tmega
from spt_tpu_torch.kernels import megakernel_bvh as tmbvh
from spt_tpu_torch.kernels import wavefront as twf
from chip_smoke import (CAM_10K, PAD_CAM, env_gradient, padding_scene,
                        route_differ, scene_10k, wf_bounce, wf_inputs)
from test_torch_bvh import big_camera, big_scene

# One intra-op thread: these tests trace small tensors, where torch's
# idle OpenMP workers would only spin against the other test processes.
torch.set_num_threads(1)

CPU = "cpu"
BLOCK = 8
KW = dict(max_bounces=3, rr_depth=2, seed=5)
DIR_ATOL = 5e-7       # about 4 ulp of a unit vector's largest component
SHADOW_DIR_ATOL = 2e-6   # the light cone's frame amplifies an ulp of its axis


def _assert_images_agree(got, want):
    assert got.shape == want.shape and np.isfinite(got).all()
    close = np.isclose(got, want, rtol=2e-3, atol=2e-4).all(axis=-1)
    assert close.mean() >= 0.97, f"{(~close).sum()} px diverge"
    assert abs(got.mean() - want.mean()) <= 0.01 * abs(want.mean())


def _bits_equal(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8))


@pytest.fixture(scope="module")
def big():
    """The 202-sphere test scene packed for both packages (leaf block 8)."""
    sdj = big_scene(spt_tpu).compile()
    cam = big_camera(spt_tpu)
    blob, meta3, nodef, nodei, prims, static = jmbvh._packed(sdj, cam, BLOCK)
    t = {k: torch.from_numpy(np.array(v)) for k, v in
         (("blob", blob), ("nodef", nodef), ("nodei", nodei),
          ("prims", prims))}
    t["lsb"] = torch.from_numpy(np.array(jphys.lsel_bounds_from_prims(prims)))
    return dict(j=(blob, nodef, prims), t=t, static=static,
                nl=int(meta3[2]))


def _stream(big, w=32, h=32, spp=1):
    """A raygen stream of the big scene from the port, as numpy."""
    t = big["t"]
    st, ids = twf.raygen_plain(t["blob"], torch.tensor([0, 5, big["nl"]],
                                                       dtype=torch.int32),
                               width=w, height=h, chunk_spp=spp, dof=False)
    return st.numpy().copy(), ids.numpy().copy()


@pytest.mark.parametrize("size,lens", [((40, 24), False), ((32, 32), False),
                                       ((40, 24), True), ((32, 32), True)])
def test_raygen_plain_matches_jax(size, lens):
    w, h = size
    cam_kw = dict(aperture=0.3, focus_dist=14.0) if lens else {}
    sdj = big_scene(spt_tpu).compile()
    blob, meta3, *_ = jmbvh._packed(sdj, big_camera(spt_tpu, **cam_kw),
                                    BLOCK)
    meta = np.asarray([3, 5, int(meta3[2])], np.int32)
    st_j, ids_j, n_tiles = jwf._raygen_launch(
        jnp.asarray(meta), blob, width=w, height=h, chunk_spp=2, dof=lens,
        interpret=True)
    before = dict(tmega.LAUNCHES)
    st, ids = twf.raygen(torch.from_numpy(np.array(blob)),
                         torch.from_numpy(meta), width=w, height=h,
                         chunk_spp=2, dof=lens)
    assert tmega.LAUNCHES == dict(before, plain=before["plain"] + 1)
    st_j = np.asarray(st_j).reshape(twf.N_CH, -1)
    assert st.shape == st_j.shape == (twf.N_CH, (n_tiles + 1) * twf.TILE)
    _bits_equal(ids.numpy(), np.asarray(ids_j).reshape(2, -1))
    _bits_equal(st.numpy()[6:], st_j[6:])
    exact = 0 if lens else 3
    _bits_equal(st.numpy()[:exact], st_j[:exact])
    np.testing.assert_allclose(st.numpy()[exact:6], st_j[exact:6], rtol=1e-6,
                               atol=DIR_ATOL)
    # The pad tile and the ragged edge: neither alive nor in the image.
    img = st.numpy()[twf.C_INIMG].reshape(-1, twf.TILE)
    assert not img[-1].any()
    assert img.sum() == 2 * w * h


def test_coherence_key_and_leaf_bounds_match_jax(big):
    blob, nodef, prims = big["j"]
    lo_j, hi_j = jwf._leaf_block_bounds(prims)
    lo_t, hi_t = twf._leaf_block_bounds(big["t"]["prims"])
    _bits_equal(lo_t.numpy(), lo_j)
    _bits_equal(hi_t.numpy(), hi_j)
    st, _ = _stream(big, 40, 24)
    r = np.random.default_rng(2)
    n = st.shape[1]
    st[0:3] += r.normal(0, 6, (3, n)).astype(np.float32)   # spread origins
    st[twf.C_ALIVE] *= r.random(n) < 0.6                    # some dead
    key_j = jwf._coherence_key(jnp.asarray(st),
                               *jwf._scene_sort_bounds(nodef), 4,
                               dir_major=True, dbits=0)
    key_t = twf._coherence_key(torch.from_numpy(st),
                               *twf._scene_sort_bounds(big["t"]["nodef"]), 4)
    _bits_equal(key_t.numpy(), key_j)
    kinds = np.unique(key_t.numpy() >> twf._live_bits(4))
    assert list(kinds) == [0, 1, 2]       # alive, dead, pad lanes all there


@pytest.mark.parametrize("kind", ["nearest", "shadow"])
def test_precull_lists_match_jax(big, kind):
    blob, nodef, prims = big["j"]
    st, _ = _stream(big, 40, 24)
    n = st.shape[1]
    n_tiles = n // twf.TILE - 1
    r = np.random.default_rng(3)
    # Bounce-1-like rays: origins scattered through the scene, some on one
    # point inside several boxes (entry 0 ties), random directions.
    st[0:3] = np.stack([r.uniform(-8, 8, n), r.uniform(-1, 5, n),
                        r.uniform(6, 22, n)])
    st[0:3, :700] = np.array([0.5, 0.2, 12.0], np.float32)[:, None]
    d = r.normal(size=(3, n))
    st[3:6] = d / np.linalg.norm(d, axis=0)
    act = (st[twf.C_ALIVE] * (r.random(n) < 0.8)).astype(np.float32)
    tmax = (r.uniform(0.2, 6.0, n).astype(np.float32) if kind == "shadow"
            else None)
    lo_j, hi_j = jwf._leaf_block_bounds(prims)
    cand_j, ctn_j = jwf._precull_rays(
        tuple(jnp.asarray(st[a]) for a in range(3)),
        tuple(jnp.asarray(st[3 + a]) for a in range(3)), jnp.asarray(act),
        None if tmax is None else jnp.asarray(tmax), lo_j, hi_j, n_tiles)
    lo_t, hi_t = twf._leaf_block_bounds(big["t"]["prims"])
    cand, ctn = twf.precull_tiles(
        tuple(torch.from_numpy(st[a]) for a in range(3)),
        tuple(torch.from_numpy(st[3 + a]) for a in range(3)),
        torch.from_numpy(act), None if tmax is None
        else torch.from_numpy(tmax), lo_t, hi_t)
    _bits_equal(cand.numpy(), cand_j)
    _bits_equal(ctn.numpy(), ctn_j)
    counts = cand.numpy()[:, 0, 0]
    assert counts[-1] == 0 and 0 < counts[:-1].min()    # the pad tile: none


def _one_bounce(big):
    """Bounce 0 of a 32x32 stream of the big scene: preculled and swept by
    the plain K6.  Returns (st, ids, res) as tensors."""
    st, ids = (torch.from_numpy(a) for a in _stream(big))
    t = big["t"]
    n = st.shape[1]
    lob, hib = twf._leaf_block_bounds(t["prims"])
    cand, ctn = twf.precull_tiles(tuple(st[c] for c in range(3)),
                                  tuple(st[3 + c] for c in range(3)),
                                  st[twf.C_ALIVE], None, lob, hib)
    res = twf.isect(t["prims"], cand, ctn, st, n, block=BLOCK)
    return st, ids, res


@pytest.mark.parametrize("k", [0, 2])
def test_shadow_rays_match_jax(big, k):
    blob, nodef, prims = big["j"]
    st, ids, res = _one_bounce(big)
    s = big["static"]
    kw = dict(k=k, seed=5, n_mats=s["n_mats"], mtypes=s["mtypes"],
              n_light_slots=s["n_light_slots"])
    o_j, d_j, tmax_j, need_j = jwf._shadow_rays_xla(
        jnp.asarray(st.numpy()), jnp.asarray(ids.numpy()),
        jnp.asarray(res.numpy()), blob, jnp.asarray(big["t"]["lsb"].numpy()),
        jnp.int32(big["nl"]), **kw)
    o, d, tmax, need = twf.shadow_rays(st, ids, res, big["t"]["blob"],
                                       big["t"]["lsb"], big["nl"], **kw)
    _bits_equal(need.numpy(), need_j)
    m = need.numpy() > 0.5
    assert 0.3 < m.mean() < 1.0
    same = np.ones(m.sum(), bool)
    for a in range(3):
        got, want = o[a].numpy()[m], np.asarray(o_j[a])[m]
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(d[a].numpy()[m], np.asarray(d_j[a])[m],
                                   rtol=0, atol=SHADOW_DIR_ATOL)
        same &= got == want
    # t_max = b - sqrt(b^2 - c) cancels where a ray grazes its light.
    got, want = tmax.numpy()[m], np.asarray(tmax_j)[m]
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=1e-7)
    same &= got == want
    assert same.mean() > 0.95     # the rest: an ulp from a shading normal


def test_scatter_image_matches_jax():
    r = np.random.default_rng(4)
    w, h = 40, 24
    n = 3 * twf.TILE
    st = np.zeros((twf.N_CH, n), np.float32)
    st[twf.C_LR:twf.C_LB + 1] = r.uniform(0, 3, (3, n))
    st[twf.C_INIMG] = r.random(n) < 0.9
    # Two samples of every pixel, in a shuffled order, and padding lanes.
    pid = np.concatenate([np.arange(w * h), np.arange(w * h)])
    ids = np.stack([np.resize(r.permutation(pid), n),
                    r.integers(0, 9, n)]).astype(np.int32)
    st[twf.C_INIMG, 2 * w * h:] = 0.0
    want = jwf._scatter_image(jnp.asarray(st.reshape(twf.N_CH, -1, 128)),
                              jnp.asarray(ids.reshape(2, -1, 128)), w, h)
    got = twf._scatter_image(torch.from_numpy(st), torch.from_numpy(ids), w,
                             h)
    _bits_equal(got.numpy(), want)


@pytest.mark.parametrize("mode", ["lists", "tree"])
def test_isect_plain_matches_brute_force(big, mode):
    """4,096 random rays: the plain K6's winner and its distance, over the
    tiles' lists or by each lane's walk of the tree (its tree mode), are
    brute force's over every valid sphere, exactly."""
    sd = big_scene(spt_tpu_torch).compile(device=CPU)
    t = big["t"]
    r = np.random.default_rng(11)
    n = 4 * twf.TILE
    st = torch.zeros(twf.N_CH, n)
    st[0:3] = torch.from_numpy(np.stack([
        r.uniform(-9, 9, n), r.uniform(-1, 6, n),
        r.uniform(5, 23, n)]).astype(np.float32))
    d = r.normal(size=(3, n))
    st[3:6] = torch.from_numpy((d / np.linalg.norm(d, axis=0))
                               .astype(np.float32))
    st[twf.C_ALIVE] = torch.from_numpy((r.random(n) < 0.9)
                                       .astype(np.float32))
    lob, hib = twf._leaf_block_bounds(t["prims"])
    cand, ctn = twf.precull_tiles(tuple(st[c] for c in range(3)),
                                  tuple(st[3 + c] for c in range(3)),
                                  st[twf.C_ALIVE], None, lob, hib)
    stats = {}
    res = twf.isect_plain(t["prims"], cand, ctn, st, n, block=BLOCK,
                          stats=stats, tree=None if mode == "lists" else
                          (t["nodef"], t["nodei"]))
    spheres = torch.cat([sd.centers, sd.radii[:, None]], 1)[sd.prim_valid]
    tj, ok = tmbvh.physics._sphere_t(spheres, *st[0:3], *st[3:6])
    t_bf, j_bf = torch.where(ok, tj, tmbvh.BIG).min(dim=0)
    alive = st[twf.C_ALIVE] > 0.5
    found = alive & (t_bf < tmbvh.BIG)
    assert 0.2 < float(found.float().mean()) < 0.9
    assert torch.equal(res[4] >= 0, found)
    want = spheres[j_bf]
    for a in range(4):
        assert torch.equal(res[a][found], want[found, a])
    mid = sd.mat_id[sd.prim_valid][j_bf].to(torch.float32)
    assert torch.equal(res[4][found], mid[found])
    if mode == "tree":      # a walk tests fewer nodes than the tree has
        assert stats["alive"] == int(alive.sum())
        assert stats["alive"] < stats["nodes"] < stats["alive"] * (
            t["nodef"].numel() // 64)
        return
    # The early exit stops sweeps: fewer blocks than the lists hold.
    listed = int(cand[torch.arange(n) // twf.TILE, 0, 0][alive].sum())
    assert 0 < stats["blocks"] < listed


@pytest.mark.parametrize("case", ["scene300", "padding"])
def test_isect_walk_matches_lists(case):
    """K6's plain tree mode against its plain list sweep on one sorted
    bounce (16x16 x 2 spp, leaf block 32): every lane whose winner differs
    is an exact t-tie or a padding winner (``route_differ``), and none
    differs on the 300-sphere scene; the padding scene's rays win padding
    slots either way."""
    if case == "padding":
        sd = padding_scene(spt_tpu_torch).compile(device=CPU)
        cam = spt_tpu_torch.Camera.look_at(device=CPU, **PAD_CAM)
    else:
        sd = scene_10k(spt_tpu_torch, n=300).compile(device=CPU)
        cam = spt_tpu_torch.Camera.look_at(device=CPU, **CAM_10K)
    t, stc, meta = wf_inputs(torch, twf, twf, sd, cam, 5)
    b = wf_bounce(torch, twf, t, stc, meta, 16, 16, 0, 5)
    n, res_t, res = b["n"], b["res_t"], b["res"]
    route = route_differ(torch, twf, b["st"][:, :n], res_t, res)
    assert route["other"] == 0, route
    assert int((res_t[4] >= 0).sum()) > 0
    padding = int(((res_t[4] < 0) & (res_t[5] >= 0)).sum())
    if case == "padding":
        assert padding > 0
    else:
        assert route["lanes"] == 0 and padding == 0


@pytest.mark.parametrize("k", [0, 1])
def test_shadow_verdicts_match_glue_and_walk(k):
    """K8's plain version (the bounce on K6's winner, each shadow ray
    walking the tree, the verdict kept) against the route it replaces on
    the prim path: the shadow rays rebuilt by the glue (``shadow_rays``)
    and walked by ``_Walk.anyhit``, on bounces 0 and 1 of the 300-sphere
    scene (16x16 x 2 spp, leaf block 32): equal on every lane, on the
    whole tree and on each prim=2 shard's tree, whose MAX is the whole's;
    the stream is left as it was."""
    from spt_tpu_torch.parallel import wavefront_prim as wp
    from chip_smoke import RR, wf_advance
    sd = scene_10k(spt_tpu_torch, n=300).compile(device=CPU)
    cam = spt_tpu_torch.Camera.look_at(device=CPU, **CAM_10K)
    t, stc, meta = wf_inputs(torch, twf, twf, sd, cam, 5)
    b = wf_bounce(torch, twf, t, stc, meta, 16, 16, 0, 5)
    if k:
        b = wf_advance(torch, twf, t, stc, meta, b, 0, 5, sd.sky_mode)
    n, st, ids, res = b["n"], b["st"], b["ids"], b["res_t"]
    block, nls = stc["block"], stc["n_light_slots"]
    prims = t["prims"].reshape(-1, 5, block)
    so3, sd3, stmax, sneed = twf.shadow_rays(
        st[:, :n], ids[:, :n], res, t["blob"], t["lsb"], nls, k=k, seed=5,
        n_mats=stc["n_mats"], mtypes=stc["mtypes"], n_light_slots=nls)
    kw = dict(k=k, block=block, n_mats=stc["n_mats"], n_light_slots=nls,
              rr_depth=RR, use_nee=True, use_mis=True, sky_mode=sd.sky_mode)
    before = b["buf"].clone()
    got = []
    nb = prims.shape[0]
    half = -(-nb // 2)
    for lo, hi in ((0, nb), (0, half), (half, nb)):
        local = prims[lo:hi].contiguous()
        tree = wp._shard_tree(t, stc, lo, hi)
        want = twf._tree_walk(tree, local, block).anyhit(
            so3, sd3, stmax, sneed > 0.5)[0]
        plain = tmega.LAUNCHES["plain"]
        v = twf.shadow_verdicts(t["blob"], meta, t["lsb"], local,
                                t["mtypes"], st, ids, res, n, tree=tree, **kw)
        assert tmega.LAUNCHES["plain"] == plain + 1
        assert torch.equal(v, want.to(torch.float32))
        got.append(v)
    assert torch.equal(b["buf"], before)
    whole, a, c = got
    assert 0 < float(whole.sum()) < float(sneed.sum())
    assert torch.equal(torch.maximum(a, c), whole)


def test_sweep_list_reads_match_per_lane_walk():
    """``_sweep_lanes``' per-tile reads and ``_list_reads``' words and
    blocks equal those of each lane walking its tile's list alone."""
    r = np.random.default_rng(4)
    n_tiles, nb = 3, 6
    n = n_tiles * twf.TILE
    ncand = np.array([4, 0, 6])
    cand = np.full((n_tiles, 1, nb + 1), -1, np.int32)
    ctn = np.full((n_tiles, 1, nb), twf.BIG, np.float32)
    for tt, c in enumerate(ncand):
        cand[tt, 0, 0] = c
        cand[tt, 0, 1:1 + c] = r.permutation(nb)[:c]
        ctn[tt, 0, :c] = np.sort(r.uniform(0, 10, c))
    bound = r.uniform(0, 12, n).astype(np.float32)
    lanes = r.random(n) < 0.8
    lanes[2 * twf.TILE:] &= r.random(twf.TILE) < 0.01
    stop_at = r.random((n, nb)) < 0.3

    def step(idx, blk):
        return torch.from_numpy(stop_at[idx.numpy(), blk.numpy()])

    tile = torch.arange(n) // twf.TILE
    args = (torch.from_numpy(cand), tile, torch.from_numpy(lanes))
    read, taken = twf._sweep_lanes(args[0], torch.from_numpy(ctn), tile,
                                   torch.from_numpy(bound), args[2], step)
    want_read, want_taken = np.zeros(n_tiles, int), np.zeros(n_tiles, int)
    for lane in np.nonzero(lanes)[0]:
        tt = lane // twf.TILE
        for i in range(ncand[tt]):
            want_read[tt] = max(want_read[tt], i + 1)
            if not ctn[tt, 0, i] < bound[lane]:
                break
            want_taken[tt] = max(want_taken[tt], i + 1)
            if stop_at[lane, cand[tt, 0, 1 + i]]:
                break
    assert read.tolist() == want_read.tolist()
    assert taken.tolist() == want_taken.tolist()
    assert 0 < want_taken.sum() < ncand.sum()
    words, blocks = twf._list_reads(*args, read, taken)
    swept = sum(lanes[tt * twf.TILE:(tt + 1) * twf.TILE].any()
                for tt in range(n_tiles))
    assert words == swept + want_read.sum() + want_taken.sum()
    assert blocks == len({int(cand[tt, 0, 1 + i]) for tt in range(n_tiles)
                          for i in range(want_taken[tt])})


def _render(sd, cam, w, h, spp, **kw):
    return twf.render_wavefront(sd, cam, w, h, 0, spp, block=BLOCK,
                                **dict(KW, **kw))


@pytest.fixture(scope="module")
def scene300():
    sd = scene_10k(spt_tpu_torch, n=300).compile(device=CPU)
    return sd, spt_tpu_torch.Camera.look_at(device=CPU, **CAM_10K)


def test_wavefront_matches_plain_k3(scene300):
    sd, cam = scene300
    before = dict(tmega.LAUNCHES)
    got = _render(sd, cam, 16, 16, 2)
    after = dict(tmega.LAUNCHES)
    assert after["plain"] - before["plain"] == 1 + 2 * KW["max_bounces"]
    assert all(after[k] == before[k] for k in ("k1", "k3", "k5", "k6", "k7"))
    want = tmbvh.render_tiles_bvh(sd, cam, 16, 16, 0, 2, block=BLOCK, **KW)
    _assert_images_agree(got.numpy(), want.numpy())
    assert float(want.mean()) > 0.05


def test_wavefront_ragged_matches_plain_k3():
    sd = big_scene(spt_tpu_torch).compile(device=CPU)
    cam = big_camera(spt_tpu_torch)
    got = _render(sd, cam, 40, 24, 1)
    want = tmbvh.render_tiles_bvh(sd, cam, 40, 24, 0, 1, block=BLOCK, **KW)
    assert got.shape == (24, 40, 3)
    _assert_images_agree(got.numpy(), want.numpy())


def test_sort_is_invisible():
    sd = big_scene(spt_tpu_torch).compile(device=CPU)
    cam = big_camera(spt_tpu_torch)
    on = _render(sd, cam, 32, 32, 2, sort_min_rays=0)
    off = _render(sd, cam, 32, 32, 2, sort_min_rays=1 << 30)
    assert float(on.mean()) > 0.05
    assert torch.equal(on, off)


def test_tiered_prefix_sorts_invisible(monkeypatch):
    """Prefix sorts (only the first half or quarter of the stream once the
    alive rays fit there) against full-stream sorts of every bounce
    (``compact=False``); roulette from bounce 1 thins the stream fast
    enough that the tiers engage."""
    sd = big_scene(spt_tpu_torch).compile(device=CPU)
    cam = big_camera(spt_tpu_torch)
    lanes = []
    sort = twf._sort_rays

    def spy(buf, n_lanes, *a):
        lanes.append((n_lanes, buf.shape[1]))
        return sort(buf, n_lanes, *a)

    monkeypatch.setattr(twf, "_sort_rays", spy)
    kw = dict(rr_depth=1, max_bounces=6, sort_min_rays=0)
    tiered = _render(sd, cam, 64, 32, 2, **kw)       # 4 tiles + the pad
    assert any(n < total for n, total in lanes)
    full = _render(sd, cam, 64, 32, 2, compact=False, **kw)
    assert torch.equal(tiered, full)


def test_chunking_is_invisible(scene300):
    sd, cam = scene300
    rays_per_img = twf.TILE          # 16x16 fits one tile
    one = _render(sd, cam, 16, 16, 2, chunk_rays=rays_per_img)
    both = _render(sd, cam, 16, 16, 2, chunk_rays=2 * rays_per_img)
    assert torch.equal(one, both)


def test_env_map_sort_invisible():
    scene = scene_10k(spt_tpu_torch, n=150)
    scene.set_environment_map(env_gradient(16, 32))
    sd = scene.compile(device=CPU)
    cam = spt_tpu_torch.Camera.look_at(device=CPU, **CAM_10K)
    on = _render(sd, cam, 32, 32, 1, sort_min_rays=0)
    off = _render(sd, cam, 32, 32, 1, sort_min_rays=1 << 30)
    assert float(on.mean()) > 0.1        # the env map lights the image
    assert torch.equal(on, off)
