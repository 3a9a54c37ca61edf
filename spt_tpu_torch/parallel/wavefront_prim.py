"""The sorted wavefront with the scene's leaf blocks sharded over ``prim``.

The port of ``spt_tpu.parallel.wavefront_prim``: the packed leaf-block table
is cut into one range of blocks per prim rank, with the packed tree cut to
that range (``megakernel_bvh.shard_tree``: leaf blocks are numbered in
preorder, so a range is a run of leaves; at prim=1 the packed tree
itself), and every bounce runs the wavefront's kernels on the local range,
merging across ``prim`` with collectives:

per bounce, on every (data, prim) rank
  1. sort the stream (stable: every prim rank holds the same stream and
     applies the same permutation, so lane i is the same ray everywhere;
     the alive prefix is asserted equal over ``prim``);
  2. K6 walking the shard's tree -> the local winner (local block ids);
  3. ``wavefront.winner_t`` and a MIN all-reduce over ``prim``; on equal
     distances the lowest prim index wins (a MIN all-reduce of the index
     where t equals the least), the local block id is rebased to the global
     one (+ nb_local * prim index), and the winner's fields are merged by a
     SUM all-reduce in which exactly one rank contributes;
  4. K8: each lane's bounce on the merged winner, its shadow ray walking
     the shard's tree, keeping only the verdict; the verdicts merged by a
     MAX all-reduce into residual row 7;
  5. K7 reading that verdict (``blocked_in_res``) on the merged winner:
     the same bounce on the same inputs as K8's (so the shadow rays the
     verdicts are for are its own), on every prim rank alike, so the
     stream stays the same on all of them;
  6. the env-map step where the sky is an environment map.

The image is summed over ``data`` only.  Each rank holds a range of
ceil(n_blocks / prim) leaf blocks (the last one the rest): the point is
memory (the scene scales with the prim axis), not less work per rank.
Matches the unsharded wavefront but where a lane's nearest hits on two
shards lie at exactly the same distance (the merge breaks the tie by prim
index, the walk by visit order); ``stats`` records those lanes.  No lists
are built (``wavefront.GLUE_CALLS`` stays 0).  Forward only, as in the JAX
package.
"""

from __future__ import annotations

import functools

import torch
import torch.distributed as dist

from ..core.scene import SKY_ENVMAP, SceneData
from ..kernels import wavefront as wf
from ..kernels.megakernel import _np
from ..kernels.megakernel_bvh import (BLOCK, _N_PRIM_ATTRS, packed,
                                      shard_tree)
from .mesh import RenderMesh, all_reduce

_NO_SHARD = 1 << 30


def _local_blocks(prims: torch.Tensor, n_shards: int,
                  idx: int) -> tuple[torch.Tensor, int]:
    """Shard ``idx``'s range of the packed (n_blocks, 5, block) leaf table
    and the range's stride ``nb_local`` = ceil(n_blocks / n_shards): blocks
    [nb_local * idx, min(n_blocks, nb_local * (idx + 1))), so the last
    shard may hold fewer (ranks are processes and need no equal shapes,
    unlike the JAX package's ``shard_map``, which pads the table).  A local
    block id plus ``nb_local * idx`` is the global one.  Raises ValueError
    if the range is empty."""
    nb = prims.shape[0]
    nb_local = -(-nb // n_shards)
    lo, hi = nb_local * idx, min(nb, nb_local * (idx + 1))
    if lo >= hi:
        raise ValueError(f"{nb} leaf blocks leave prim shard {idx} of "
                         f"{n_shards} empty (stride {nb_local}); use fewer "
                         f"prim shards")
    return prims[lo:hi].contiguous(), nb_local


def _shard_tree(t: dict, static: dict, lo: int, hi: int):
    """(nodef, nodei) on ``t``'s device: the tree over leaf blocks [lo, hi)
    (``shard_tree``; the packed tree itself for the whole table), made once
    per packed scene and kept in its ``static``."""
    if (lo, hi) == (0, static["n_blocks"]):
        return t["nodef"], t["nodei"]
    dev = t["nodef"].device
    trees = static.setdefault("shard_trees", {})
    key = (lo, hi, str(dev))
    if key not in trees:
        trees[key] = tuple(torch.from_numpy(a).to(dev)
                           for a in shard_tree(static, lo, hi))
    return trees[key]


def _same(reduce, values: list, device, what: str) -> None:
    """Raises unless the int64 ``values`` are equal on every prim rank
    (one MIN all-reduce of (v, -v) by ``reduce``)."""
    v = torch.tensor(values, dtype=torch.int64, device=device)
    both = reduce(torch.cat([v, -v]), dist.ReduceOp.MIN)
    if not torch.equal(both[:len(values)], -both[len(values):]):
        raise RuntimeError(f"prim ranks disagree on {what}: {both.tolist()}")


def _checksum(buf: torch.Tensor) -> int:
    """An order-sensitive int64 checksum of the stream buffer's bits, one
    row at a time (a row's int64 bits and weights are the only
    temporaries)."""
    n = buf.shape[1]
    w = torch.arange(1, n + 1, dtype=torch.int64, device=buf.device) \
        * 2654435761
    total = torch.zeros((), dtype=torch.int64, device=buf.device)
    for r in range(buf.shape[0]):
        bits = buf[r].view(torch.int32).to(torch.int64)
        total += (bits * (w + r * n * 2654435761)).sum()
    return int(total)


def render_wavefront_prim_sharded(scene: SceneData, camera, width: int,
                                  height: int, start_sample: int, spp: int,
                                  mesh: RenderMesh, *, max_bounces: int = 8,
                                  rr_depth: int = 3, use_nee: bool = True,
                                  use_mis: bool = True, seed: int = 0,
                                  dof=None, block: int = BLOCK,
                                  sort_min_rays: int = 1 << 17,
                                  chunk_rays: int = 4 << 20,
                                  stats: dict | None = None) -> torch.Tensor:
    """Wavefront forward with samples over ``data`` and leaf blocks over
    ``prim``; the (H, W, 3) radiance sum over ``spp``, on every rank.

    Runs K5, K6 (its tree mode on the shard's tree), K8 and K7
    (``blocked_in_res``) on the scene's device (the plain versions for a
    scene on the CPU), the wavefront's loop and sort
    policy (``sort_min_rays``, the tiered prefix sorts, chunks of
    ``chunk_rays``).  ``stats``, if given, gets ``"tie_pixels"`` (the pixel
    ids of the lanes whose nearest hits on two or more prim ranks lay at the
    same distance, a list), ``"tie_lanes"``, ``"stream_checks"`` (the
    bounces after which the stream's checksum was held equal over
    ``prim``; a difference raises) and the prim collectives' bytes and
    milliseconds (``mesh.all_reduce``'s stats)."""
    spp_rank = mesh.samples_per_rank(spp)
    mesh.check_member()
    t, static = packed(scene, camera, block)
    local, nb_local = _local_blocks(
        t["prims"].reshape(-1, _N_PRIM_ATTRS, block), mesh.prim,
        mesh.prim_idx)
    lo = nb_local * mesh.prim_idx
    tree = _shard_tree(t, static, lo, lo + local.shape[0])
    if dof is None:
        dof = bool(float(_np(camera.aperture)) > 0.0)
    env = scene.env_map if scene.sky_mode == SKY_ENVMAP else None
    if env is not None and env.device != scene.device:
        env = env.to(scene.device)
    reduce = functools.partial(all_reduce, group=mesh.prim_group,
                               backend=mesh.backend, stats=stats)
    if stats is not None:
        stats.setdefault("tie_pixels", [])
        stats.setdefault("tie_lanes", 0)
        stats.setdefault("stream_checks", 0)
    rays_per_img = wf.stream_tiles(width, height, 1)[2] * wf.TILE
    chunk_spp = max(1, min(spp_rank, chunk_rays // rays_per_img))
    base = start_sample + mesh.data_idx * spp_rank
    img = None
    s = 0
    while s < spp_rank:
        n = min(chunk_spp, spp_rank - s)
        meta = torch.tensor([base + s, seed, static["n_light_slots"]],
                            dtype=torch.int32).to(scene.device)
        part = _chunk(t, static, local, tree, nb_local, env, meta, mesh,
                      reduce,
                      stats, width=width, height=height, chunk_spp=n,
                      max_bounces=max_bounces, rr_depth=rr_depth,
                      use_nee=bool(use_nee), use_mis=bool(use_mis),
                      sky_mode=scene.sky_mode, dof=bool(dof),
                      sort_min_rays=sort_min_rays)
        img = part if img is None else img + part
        s += n
    return all_reduce(img, dist.ReduceOp.SUM, mesh.data_group, mesh.backend)


def _chunk(t: dict, static: dict, local, tree, nb_local: int, env, meta,
           mesh: RenderMesh, reduce, stats: dict | None, *, width: int,
           height: int, chunk_spp: int, max_bounces: int, rr_depth: int,
           use_nee: bool, use_mis: bool, sky_mode: int, dof: bool,
           sort_min_rays: int) -> torch.Tensor:
    """One chunk of ``chunk_spp`` images -> this rank's (H, W, 3) radiance
    sum; ``reduce(t, op)`` all-reduces over ``prim``."""
    block, n_mats = static["block"], static["n_mats"]
    n_light_slots = static["n_light_slots"]
    blob, lsb = t["blob"], t["lsb"]
    dev = blob.device
    pidx = mesh.prim_idx
    st, ids = wf.raygen(blob, meta, width=width, height=height,
                        chunk_spp=chunk_spp, dof=dof)
    buf = wf._stream_buffer(st, ids)
    n_tiles = st.shape[1] // wf.TILE - 1
    lo, ext = wf._scene_sort_bounds(t["nodef"])
    shadows = use_nee and n_light_slots > 0
    kw = dict(block=block, n_mats=n_mats, n_light_slots=n_light_slots,
              rr_depth=rr_depth, use_nee=use_nee, use_mis=use_mis,
              sky_mode=sky_mode)
    none_i = torch.zeros((1, 1, 1), dtype=torch.int32, device=dev)
    none_f = torch.zeros((1, 1, 1), dtype=torch.float32, device=dev)
    nalive = n_tiles
    for k in range(max_bounces):
        lanes = wf._sort_span(k, nalive, n_tiles, sort_min_rays, True)
        if lanes is not None:
            nalive = wf._sort_rays(buf, lanes, lo, ext)
            _same(reduce, [nalive], dev, f"the alive prefix before bounce "
                                         f"{k}")
        if nalive == 0:
            break
        n = nalive * wf.TILE
        head = st[:, :n]
        res = wf.isect(local, None, None, st, n, block=block, tree=tree)
        res_m = _merge_winners(head, res, nb_local, pidx, reduce, stats,
                               ids[0, :n])
        if shadows:
            blocked = wf.shadow_verdicts(blob, meta, lsb, local, t["mtypes"],
                                         st, ids, res_m, n, tree=tree, k=k,
                                         **kw)
            res_m[7] = reduce(blocked, dist.ReduceOp.MAX)
        wf.shade(blob, meta, lsb, local, t["mtypes"], none_i, none_f, st, ids,
                 res_m, n, k=k, blocked_in_res=True, **kw)
        if sky_mode == SKY_ENVMAP:
            wf._add_env_radiance(head, env)
        if stats is not None:
            _same(reduce, [_checksum(buf)], dev,
                  f"the stream after bounce {k}")
            stats["stream_checks"] += 1
    return wf._scatter_image(st, ids, width, height)


def _merge_winners(head, res, nb_local: int, pidx: int, reduce,
                   stats: dict | None, pid) -> torch.Tensor:
    """The nearest hit over every prim rank's local K6 residual -> the
    merged (8, n) residual, the same on every prim rank (row 7 zero): the
    least ``winner_t``, on equal distances the lowest prim index, block ids
    global."""
    t = wf.winner_t(head, res)
    tmin = reduce(t.clone(), dist.ReduceOp.MIN)
    hit_eq = (res[4] >= 0.0) & (t == tmin) & (t < wf.BIG)
    sid = reduce(torch.where(hit_eq, pidx, _NO_SHARD).to(torch.int32),
                 dist.ReduceOp.MIN)
    if stats is not None:
        ties = reduce(hit_eq.to(torch.int32), dist.ReduceOp.SUM) > 1
        stats["tie_lanes"] += int(ties.sum())
        stats["tie_pixels"] += pid[ties].tolist()
    pick = (hit_eq & (sid == pidx)).to(torch.float32)
    parts = torch.stack([res[0], res[1], res[2], res[3], res[4],
                         res[5] + float(nb_local * pidx), res[6]]) * pick
    merged = reduce(parts, dist.ReduceOp.SUM)
    merged[4] = torch.where(tmin < wf.BIG, merged[4], -1.0)
    return torch.cat([merged, torch.zeros_like(merged[:1])])
