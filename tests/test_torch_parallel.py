"""The distribution layer (``spt_tpu_torch.parallel``) on the CPU.

One spawned group of four gloo ranks (``tools/dist_worker.launch``, one
process a rank, a ``file://`` rendezvous in a temporary directory, a time
limit that kills the group) runs every sharded case once; the tests read
its reports.  Setup: config 5's scene cut to 300 spheres (52 leaf blocks of
8) and to 310 (51 blocks, which neither 2 nor 4 divides), 32x32, depth 3,
the plain versions of the kernels.  The references are the unsharded
wavefront and its gradient in this process, on the same samples.

* Samples over ``data`` (``render_wavefront_sharded``, data=2, 2 spp):
  equal to the unsharded render bit for bit: a pixel sums two samples, and
  two floats add alike in either order.
* Leaf blocks over ``prim`` (``render_wavefront_prim_sharded``): at prim=1
  bit-equal to the unsharded render at 1 spp (one sample a pixel, so the
  scatter's order cannot show); at prim=2, at prim=4 on 51 blocks, at
  data=2 x prim=2 and under an environment map, every pixel that differs
  is one where a lane's nearest hits on two prim ranks lay at the same
  distance (the ranks report those lanes), and the streams were held
  bit-identical over ``prim`` after every bounce; no rank built lists.
* The DP gradient (``make_wavefront_dp_render_fn``, data=2) and
  ``make_dp_grad_step`` (data=2) against one process's gradient over the
  same samples: every field within ``GRAD_REL`` relative L2.
* Without processes: the rank grid's layout, a spp that the data axis does
  not divide, K8l's plain version against a brute-force any-hit, the halves
  of a leaf table against the whole, K7 reading a verdict against K7
  sweeping, ``winner_t`` against brute force, the padding blocks, and each
  prim shard's tree (``shard_tree``) against brute force over its blocks.
"""

import numpy as np
import pytest
import torch

import spt_tpu_torch as T
from chip_smoke import (CAM_10K, GRAD_REL, env_gradient, scene_10k,
                        shadow_sray, wf_bounce)
from spt_tpu_torch.diff import gradients as G
from spt_tpu_torch.kernels import megakernel as tmega
from spt_tpu_torch.kernels import megakernel_bvh as tmb
from spt_tpu_torch.kernels import wavefront as twf
from spt_tpu_torch.kernels import wavefront_grad as twg
from spt_tpu_torch.parallel import mesh as M
from spt_tpu_torch.parallel import sharding as S
from spt_tpu_torch.parallel import wavefront_prim as wp
from spt_tpu_torch.parallel import wavefront_sharded as ws
from spt_tpu_torch.tools import dist_worker

# One intra-op thread: these tests trace small tensors, where torch's
# idle OpenMP workers would only spin against the other test processes.
torch.set_num_threads(1)

CPU = "cpu"
BLOCK = 8
W = H = 32
KW = dict(max_bounces=3, rr_depth=2, use_nee=True, use_mis=True, seed=5,
          sort_min_rays=0)
KEYS = ("albedo", "emission", "roughness", "centers", "radii")
WORLD = 4
# Seconds the spawned group may take, start to end (about 5 here).
GROUP_TIMEOUT = 240.0


def _camera():
    return T.Camera.look_at(device=CPU, **CAM_10K)


def _scenes():
    env = scene_10k(T, n=300)
    env.set_environment_map(env_gradient(16, 32))
    return {"s300": scene_10k(T, n=300).compile(device=CPU),
            "s310": scene_10k(T, n=310).compile(device=CPU),
            "s300env": env.compile(device=CPU)}


PRIM_CASES = {
    "prim1": dict(data=1, prim=1, scene="s300", spp=1),
    "prim2": dict(data=1, prim=2, scene="s300", spp=1),
    "prim4_51_blocks": dict(data=1, prim=4, scene="s310", spp=1),
    "data2_prim2": dict(data=2, prim=2, scene="s300", spp=2),
    "prim2_envmap": dict(data=1, prim=2, scene="s300env", spp=1),
}


@pytest.fixture(scope="module")
def group():
    """Every case, run once on one spawned group of four gloo ranks:
    label -> rank 0's report, and the scenes."""
    scenes = _scenes()
    cam = _camera()
    kw = dict(KW, block=BLOCK)
    cases = {"data2": dict(case="forward", data=2, prim=1, scene="s300",
                           spp=2, kw=kw)}
    cases.update({k: dict(v, case="prim_forward", kw=kw)
                  for k, v in PRIM_CASES.items()})
    cases["dp_grad"] = dict(case="dp_grad", data=2, prim=1, scene="s300",
                            spp=2, kw=KW, fields=KEYS, ct_seed=7)
    cases["dp_step"] = dict(case="dp_step", data=2, prim=1, scene="s300",
                            spd=1, step_idx=1, kw=KW,
                            fields=("albedo", "centers"), ct_seed=8)
    for c in cases.values():
        c.update(width=W, height=H)
    reports = dist_worker.launch(
        list(cases.values()), WORLD,
        scenes={k: (v, cam) for k, v in scenes.items()}, backend="gloo",
        device=CPU, timeout=GROUP_TIMEOUT)
    return dict(zip(cases, reports)), scenes


def _unsharded(sd, spp):
    return twf.render_wavefront(sd, _camera(), W, H, 0, spp, block=BLOCK,
                                **KW).numpy()


def test_sample_sharded_forward_matches_unsharded(group):
    reports, scenes = group
    rep = reports["data2"]
    assert rep["backend"] == "gloo" and len(rep["walls_s"]) == 2
    want = _unsharded(scenes["s300"], 2)
    assert np.isfinite(rep["image"]).all() and want.mean() > 0.05
    np.testing.assert_array_equal(rep["image"], want)
    # Each rank: one raygen and two plain kernels a bounce, walking the
    # tree: no lists built.
    assert rep["launches"]["plain"] >= 2 * (1 + 2)
    assert not any(rep["glue_calls"].values()), rep["glue_calls"]


@pytest.mark.parametrize("label", list(PRIM_CASES))
def test_prim_sharded_matches_unsharded(group, label):
    reports, scenes = group
    rep, case = reports[label], PRIM_CASES[label]
    sd = scenes[case["scene"]]
    nb = twf.packed(sd, _camera(), BLOCK)[1]["n_blocks"]
    if label == "prim4_51_blocks":
        assert nb % 4 != 0
    want = _unsharded(sd, case["spp"])
    got = rep["image"]
    assert got.shape == want.shape and np.isfinite(got).all()
    assert want.mean() > 0.05
    n_ranks = case["data"] * case["prim"]
    assert len(rep["stream_checks"]) == n_ranks
    assert all(c == KW["max_bounces"] for c in rep["stream_checks"])
    # Each rank: a raygen, then K6 and K8 walking its shard's tree and K7
    # reading the merged verdict a bounce; no lists built.
    assert rep["launches"]["plain"] == n_ranks * (1 + 3 * KW["max_bounces"])
    assert not any(rep["glue_calls"].values()), rep["glue_calls"]
    differ = np.flatnonzero((got != want).any(-1))
    if case["prim"] == 1:
        np.testing.assert_array_equal(got, want)
    not_ties = sorted(set(differ.tolist()) - set(rep["tie_pixels"]))
    assert not not_ties, (f"{len(differ)} pixels differ, {len(not_ties)} "
                          f"without a cross-shard tie: {not_ties[:10]}")


def _grads(render, sd, fields, ct, start=0):
    params = {k: v.clone().requires_grad_(True)
              for k, v in G.get_params(sd, fields).items()}
    img = render(params, start)
    (img * ct).sum().backward()
    return img.detach().numpy(), {k: p.grad.numpy() for k, p in
                                  params.items()}


def _ct(seed):
    return torch.from_numpy(np.random.default_rng(seed).uniform(
        0.5, 1.5, (H, W, 3)).astype(np.float32))


def _rel(a, b):
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


def test_dp_gradient_matches_single_process(group):
    reports, scenes = group
    rep = reports["dp_grad"]
    sd = scenes["s300"]
    render = twg.make_wavefront_render_fn(sd, _camera(), W, H, spp=2, **KW)
    img, grads = _grads(render, sd, KEYS, _ct(7))
    np.testing.assert_array_equal(rep["image"], img)
    for k in KEYS:
        assert np.abs(grads[k]).sum() > 0, k
        assert _rel(rep[f"grad.{k}"], grads[k]) <= GRAD_REL, k
    # One all-reduce of the flat parameter vector, on each backward.
    assert rep["grad_vector_numel"] == sum(g.size for g in grads.values())
    assert rep["launches"]["plain"] > 0
    assert not any(rep["glue_calls"].values()), rep["glue_calls"]


def test_dp_grad_step_matches_single_process(group):
    """Step 1 at one sample a rank: ranks 0 and 1 take samples 2 and 3;
    the loss and gradients are their means."""
    reports, scenes = group
    rep = reports["dp_step"]
    sd = scenes["s300"]
    render = twg.make_wavefront_render_fn(sd, _camera(), W, H, spp=1, **KW)
    target = _ct(8)
    losses, grads = [], []
    for sample in (2, 3):
        params = {k: v.clone().requires_grad_(True) for k, v in
                  G.get_params(sd, ("albedo", "centers")).items()}
        loss = torch.mean((render(params, sample) - target) ** 2)
        loss.backward()
        losses.append(float(loss.detach()))
        grads.append({k: p.grad.numpy() for k, p in params.items()})
    np.testing.assert_allclose(rep["loss"], np.mean(losses), rtol=1e-6)
    for k in ("albedo", "centers"):
        want = (grads[0][k] + grads[1][k]) / 2
        assert np.abs(want).sum() > 0
        assert _rel(rep[f"grad.{k}"], want) <= GRAD_REL, k


def test_rank_grid_layout():
    """JAX's layout rules: host-major ranks, prim groups within a host."""
    np.testing.assert_array_equal(M.rank_grid(8, data=4, prim=2, hosts=2),
                                  np.arange(8).reshape(4, 2))
    np.testing.assert_array_equal(M.rank_grid(8, prim=4),
                                  np.arange(8).reshape(2, 4))
    np.testing.assert_array_equal(M.rank_grid(4, data=1, prim=2),
                                  [[0, 1]])
    with pytest.raises(ValueError, match="straddle hosts"):
        M.rank_grid(8, data=2, prim=4, hosts=4)     # 2 ranks/host < prim
    with pytest.raises(ValueError, match="exceeds"):
        M.rank_grid(4, data=2, prim=4)
    with pytest.raises(ValueError, match="not divisible"):
        M.rank_grid(6, prim=4)


def test_launch_runs_on_the_card_unless_asked_for_the_cpu():
    """The launcher's device defaults to the card, as every entry point's:
    with no card here it raises before it spawns a rank.  Its backend
    defaults to gloo on the CPU and where ranks share the card, NCCL for
    one rank on the card."""
    if torch.cuda.is_available():
        pytest.skip("checks the launcher on a machine without a card")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        dist_worker.launch([], 2, scenes={})
    assert dist_worker.default_backend(torch.device(CPU), 4) == "gloo"
    assert dist_worker.default_backend(torch.device("cuda", 0), 1) == "nccl"
    assert dist_worker.default_backend(torch.device("cuda"), 2) == "gloo"


def test_spp_must_divide_the_data_axis():
    mesh = M.RenderMesh(data=2, prim=1, data_idx=0, prim_idx=0,
                        data_group=None, prim_group=None,
                        device=torch.device(CPU), backend="gloo")
    sd = scene_10k(T, n=40).compile(device=CPU)
    cam = _camera()
    for call in (
            lambda: ws.render_wavefront_sharded(sd, cam, 8, 8, 0, 3, mesh),
            lambda: ws.make_wavefront_dp_render_fn(sd, cam, 8, 8, spp=3,
                                                   mesh=mesh),
            lambda: wp.render_wavefront_prim_sharded(sd, cam, 8, 8, 0, 3,
                                                     mesh)):
        with pytest.raises(ValueError, match="not divisible"):
            call()


@pytest.fixture(scope="module")
def bounce():
    """Bounce 1 of the 300-sphere scene at 64x32 x 2 spp on the CPU, as
    ``render_wavefront`` makes it: the stream, K6's residual over the whole
    table, the shadow rays and their lists."""
    sd = scene_10k(T, n=300).compile(device=CPU)
    t, stc = twf.packed(sd, _camera(), BLOCK)
    meta = torch.tensor([0, 5, stc["n_light_slots"]], dtype=torch.int32)
    b = wf_bounce(torch, twf, t, stc, meta, 64, 32, 1, 5)
    b.update(t=t, stc=stc, meta=meta,
             sray=shadow_sray(torch, twf, t, stc, b, 1, 5))
    return b


def _brute_anyhit(prims, sray, n):
    """Every slot of every leaf block, lane by lane: blocked where some
    sphere test hits at t < tmax (K8's test, without lists or order)."""
    pr = prims.reshape(-1, 5, BLOCK)
    out = torch.zeros(sray.shape[1])
    for i in torch.nonzero(sray[7, :n] > 0.5)[:, 0].tolist():
        rows = [sray[a, i].expand(pr.shape[0]) for a in range(6)]
        tj, ok = tmb._leaf_t(pr, *rows)
        out[i] = float(bool((ok & (tj < sray[6, i])).any()))
    return out


def test_anyhit_plain_matches_brute_force(bounce):
    b = bounce
    prims, n, block = b["t"]["prims"], b["n"], BLOCK
    lob, hib = twf._leaf_block_bounds(prims.reshape(-1, 5, block))
    sray = b["sray"]
    scand, sctn = twf.precull_tiles(tuple(sray[:3]), tuple(sray[3:6]),
                                    sray[7], sray[6], lob, hib)
    before = dict(tmega.LAUNCHES)
    got = twf.anyhit(prims, scand, sctn, sray, n, block=block)
    assert tmega.LAUNCHES == dict(before, plain=before["plain"] + 1)
    want = _brute_anyhit(prims, sray, n)
    assert int(want.sum()) > 0 and int((sray[7] > 0.5).sum()) > want.sum()
    assert torch.equal(got, want)


def test_anyhit_halves_max_equals_whole(bounce):
    """K8 on each half of the leaf table (its own lists), MAX-merged,
    equals K8 on the whole table: the prim merge of the verdicts."""
    b = bounce
    prims = b["t"]["prims"].reshape(-1, 5, BLOCK)
    sray, n = b["sray"], b["n"]
    verdicts = []
    for part in (prims, wp._local_blocks(prims, 2, 0)[0],
                 wp._local_blocks(prims, 2, 1)[0]):
        lob, hib = twf._leaf_block_bounds(part)
        scand, sctn = twf.precull_tiles(tuple(sray[:3]), tuple(sray[3:6]),
                                        sray[7], sray[6], lob, hib)
        verdicts.append(twf.anyhit_plain(part.contiguous(), scand, sctn,
                                         sray, n, block=BLOCK))
    whole, a, c = verdicts
    assert whole.sum() > 0 and a.sum() > 0 and c.sum() > 0
    assert torch.equal(torch.maximum(a, c), whole)


def test_shade_with_verdict_equals_shade_sweeping(bounce):
    """K7's plain version reading K8's verdict from residual row 7 is
    bit-equal to it sweeping the shadow lists itself, and K9's recorded
    verdict equals K8's."""
    b = bounce
    t, stc, n = b["t"], b["stc"], b["n"]
    lob, hib = twf._leaf_block_bounds(t["prims"].reshape(-1, 5, BLOCK))
    sray = b["sray"]
    scand, sctn = twf.precull_tiles(tuple(sray[:3]), tuple(sray[3:6]),
                                    sray[7], sray[6], lob, hib)
    verdict = twf.anyhit_plain(t["prims"], scand, sctn, sray, n, block=BLOCK)
    kw = dict(k=1, block=BLOCK, n_mats=stc["n_mats"],
              n_light_slots=stc["n_light_slots"], rr_depth=2, use_nee=True,
              use_mis=True, sky_mode=T.SKY_GRADIENT)
    args = (t["blob"], b["meta"], t["lsb"], t["prims"], t["mtypes"])
    sweep = b["buf"].clone()
    out, blocked = twg.shade_fwd_plain(
        *args, scand, sctn, sweep[:twf.N_CH], sweep[twf.N_CH:].view(
            torch.int32), b["res"], n, **kw)
    assert torch.equal(blocked, verdict[:n]) and blocked.sum() > 0
    res8 = b["res"].clone()
    res8[7] = verdict
    read = b["buf"].clone()
    none = torch.zeros((1, 1, 1))
    twf.shade(*args, none.int(), none, read[:twf.N_CH],
              read[twf.N_CH:].view(torch.int32), res8, n,
              blocked_in_res=True, **kw)
    assert torch.equal(read[:twf.N_CH].view(torch.int32),
                       out.view(torch.int32))
    assert not torch.equal(read, b["buf"])


def test_winner_t_matches_brute_force(bounce):
    """The winner's distance rebuilt from K6's residual is the least
    sphere distance over every slot (BIG where a lane is dead or missed)."""
    b = bounce
    st, n, res = b["st"][:, :b["n"]], b["n"], b["res"]
    t = twf.winner_t(st, res)
    pr = b["t"]["prims"].reshape(-1, 5, BLOCK)
    alive = st[twf.C_ALIVE] > 0.5
    for i in range(0, n, 97):
        rows = [st[c, i].expand(pr.shape[0]) for c in range(6)]
        tj, ok = tmb._leaf_t(pr, *rows)
        ok &= pr[:, 4, :] >= 0.0
        best = float(torch.where(ok, tj, twf.BIG).min()) if alive[i] \
            else twf.BIG
        assert float(t[i]) == best, i


def test_local_blocks_cut_the_table_in_ranges():
    """Each prim shard holds the range [nb_local * i, min(nb, nb_local *
    (i + 1))) of the leaf table, nb_local = ceil(nb / prim): the ranges
    cover the table once, in order, the last the shortest, and a shard left
    empty raises."""
    sd = scene_10k(T, n=310).compile(device=CPU)
    prims = twf.packed(sd, _camera(), BLOCK)[0]["prims"].reshape(-1, 5,
                                                                 BLOCK)
    nb = prims.shape[0]
    assert nb % 4
    parts = [wp._local_blocks(prims, 4, i) for i in range(4)]
    assert {stride for _, stride in parts} == {-(-nb // 4)}
    assert torch.equal(torch.cat([p for p, _ in parts]), prims)
    assert [p.shape[0] for p, _ in parts] == [13, 13, 13, nb - 39]
    local, stride = wp._local_blocks(prims, 1, 0)
    assert stride == nb and torch.equal(local, prims)
    with pytest.raises(ValueError, match="empty"):
        wp._local_blocks(prims[:9], 4, 3)


def test_shard_scene_prims_pads_to_the_shard_count():
    sd = scene_10k(T, n=40).compile(device=CPU, capacity=50)
    out = S.shard_scene_prims(sd, 8)
    assert out.capacity == 56 and out.num_prims == sd.num_prims
    assert torch.equal(out.centers[:50], sd.centers)
    assert not out.prim_valid[50:].any() and (out.radii[50:] == 0).all()
    assert S.shard_scene_prims(out, 8) is out


def _rays_at(spheres, n, seed):
    """A (17, n) stream of ``n`` alive rays from random points of config
    5's cube, each aimed near a random one of ``spheres`` (m, 4)."""
    r = np.random.default_rng(seed)
    sph = spheres.numpy()[r.integers(0, len(spheres), n)]
    o = r.uniform(-40, 40, (n, 3)) + [0, 0, 60]
    d = sph[:, :3] + r.uniform(-1.5, 1.5, (n, 3)) * sph[:, 3:] - o
    st = torch.zeros(twf.N_CH, n)
    st[0:3] = torch.from_numpy(o.T.astype(np.float32))
    st[3:6] = torch.from_numpy((d / np.linalg.norm(d, axis=1)[:, None])
                               .T.astype(np.float32))
    st[twf.C_ALIVE] = 1.0
    return st


@pytest.mark.parametrize("scene,prim", [("s300", 2), ("s310", 4),
                                        ("s300", "one_leaf")])
def test_shard_tree_matches_brute_force(scene, prim):
    """Each prim shard's tree (``shard_tree``) against brute force over
    its own leaf blocks, 4,096 rays: the walk's nearest distance equals
    the least over every slot of ``local`` exactly, its winner is that
    slot but where two slots tie; and its tables: every local leaf once in
    each octant table, skips forward and in range, each node's box holding
    the boxes below it and its leaves' spheres."""
    sd = scene_10k(T, n=int(scene[1:])).compile(device=CPU)
    t, stc = twf.packed(sd, _camera(), BLOCK)
    prims = t["prims"].reshape(-1, 5, BLOCK)
    nb = prims.shape[0]
    if prim == "one_leaf":
        ranges = [(nb // 2, nb // 2 + 1)]
    else:
        s = -(-nb // prim)
        ranges = [(s * i, min(nb, s * (i + 1))) for i in range(prim)]
        assert [wp._local_blocks(prims, prim, i)[0].shape[0]
                for i in range(prim)] == [hi - lo for lo, hi in ranges]
    n = 4 * twf.TILE
    for lo, hi in ranges:
        local = prims[lo:hi].contiguous()
        filled = local.transpose(1, 2).reshape(-1, 5)
        st = _rays_at(filled[filled[:, 4] >= 0, :4], n, lo)
        o, d = tuple(st[0:3]), tuple(st[3:6])
        nodef, nodei = wp._shard_tree(t, stc, lo, hi)
        m = nodef.shape[0] // 8
        assert m == 2 * (hi - lo) - 1
        walk = twf._tree_walk((nodef, nodei), local, BLOCK)
        t_w, win, _, _ = walk.nearest(o, d, torch.ones(n, dtype=torch.bool))
        tj, ok = tmb._leaf_t(local.reshape(1, -1, 5, BLOCK).transpose(
            1, 2).reshape(1, 5, -1).expand(n, 5, -1), *o, *d)
        tj = torch.where(ok, tj, twf.BIG)
        t_bf, j_bf = tj.min(dim=1)
        assert torch.equal(t_w, t_bf)
        hit = t_bf < twf.BIG
        assert 0.05 < float(hit.float().mean()) < 0.95
        tie = (tj == t_bf[:, None]).sum(dim=1) > 1
        assert torch.equal(win[hit & ~tie], j_bf[hit & ~tie])
        f = nodef.reshape(8, m, 8)
        i = nodei.reshape(8, m, 8).long()
        for table in range(8):
            blk, skip = i[table, :, 1], i[table, :, 0]
            assert sorted(blk[blk >= 0].tolist()) == list(range(hi - lo))
            assert bool(((skip > torch.arange(m)) & (skip <= m)).all())
            for row in range(m):
                below = f[table, row + 1:int(skip[row])]
                box = f[table, row]
                assert bool((below[:, :3] >= box[:3]).all()
                            and (below[:, 3:6] <= box[3:6]).all())
                if blk[row] >= 0:
                    pr = local[int(blk[row])]
                    fill = pr[4] >= 0
                    c, r = pr[:3, fill], pr[3, fill]
                    assert bool(((c - r).T >= box[:3]).all()
                                and ((c + r).T <= box[3:6]).all())
