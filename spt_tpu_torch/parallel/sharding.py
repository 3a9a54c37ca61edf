"""Sharded renders and training steps over the render mesh.

The port of ``spt_tpu.parallel.sharding``.  Ranks are processes on a
(data, prim) grid (``mesh.RenderMesh``); every render returns the whole
(H, W, 3) radiance sum on every rank of the grid, on the scene's device,
and renders through the facade's route (``engine.cuda_backend.
render_route``: K1, K3 or the sorted wavefront) where JAX renders through
its oracle ``integrator_jax.render_megasample``:

* ``render_pixel_sharded``: rows over ``data``.  Each rank renders its band
  with global pixel ids and the full image's camera (the kernels'
  ``row_offset`` and ``full_height``), so the image equals the unsharded
  render bit for bit; one all-gather over ``data`` assembles it.
* ``render_sample_sharded``: sample ids over ``data``; one SUM all-reduce
  adds the partial images (the unsharded render up to the sum's order).
* ``render_prim_sharded``: the scene's primitives over ``prim`` (BASELINE
  config 5), by one of two strategies (``"auto"``: gather while its
  transient copy fits ``transient_budget`` bytes, else the ring), rows
  over ``data * prim`` in both:

  - ``render_prim_sharded_gather``: each prim rank keeps its 1/N slice of
    the primitive arrays; one all-gather per render rebuilds the whole
    table (a transient copy, as ZeRO gathers a layer), cut to the scene's
    own capacity so that it takes the unsharded render's route, and the
    rank renders its band of it;
  - ``render_prim_sharded_ring``: the wavefront over the rank's band, with
    the scene's leaf blocks and their trees travelling around the ``prim``
    group (``mesh.ppermute``): every bounce, one K6 a hop against the
    visiting shard, merged into the running winner, then one K8 a hop for
    the shadow verdicts, then K7b.  No rank holds the whole table on the
    device.

* ``make_dp_grad_step``: the data-parallel gradient step of inverse
  rendering, and ``shard_scene_prims``, which pads the primitive arrays to
  a capacity a shard count divides.

The renders take the route's options (``max_bounces``, ``rr_depth``,
``use_nee``, ``use_mis``, ``seed``, ``dof``); ``render_megasample``'s
others (``jitter``, ``unroll``, the intersection hooks) have no
counterpart and raise ``TypeError``.  Sample ids are a run of consecutive
ids: each kernel renders a window that starts at its first.  ``stats``, a
dict, gets the collectives' milliseconds and bytes (``mesh``'s stats) and,
from the ring, the tie lanes and pixels.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.distributed as dist

from ..core.scene import SKY_ENVMAP, SceneData
from ..engine.cuda_backend import render_route
from ..kernels import megakernel_bvh as mb
from ..kernels import wavefront as wf
from ..kernels.megakernel import _np
from .mesh import RenderMesh, all_gather, all_reduce, ppermute
from .wavefront_prim import _local_blocks, _shard_tree

_ROUTE_KW = ("max_bounces", "rr_depth", "use_nee", "use_mis", "seed", "dof")

# The gather strategy's transient copy, in bytes, above which "auto" takes
# the ring.  The JAX package's number, kept as a copy: it was chosen on a
# TPU and is not measured on the card (ROADMAP.md 6c).
GATHER_TRANSIENT_BUDGET = 64 << 20

# The packed primitive row the gather moves: cx cy cz r mat_id valid.
_PRIM_COLS = 6


def _route_kw(kw: dict) -> dict:
    """The route's options, or TypeError for ``render_megasample``'s
    others, which the kernels do not take."""
    other = sorted(set(kw) - set(_ROUTE_KW))
    if other:
        raise TypeError(f"{other}: the sharded renders take the kernel "
                        f"route's options {_ROUTE_KW}; render_megasample's "
                        f"jitter, unroll and hooks are not ported")
    return kw


def _window(sample_ids) -> tuple[int, int]:
    """(first id, count) of a 1-D run of consecutive sample ids; ValueError
    for anything else."""
    ids = np.asarray(_np(torch.as_tensor(sample_ids)), np.int64)
    if ids.ndim != 1 or ids.size == 0:
        raise ValueError(f"sample_ids must be a non-empty 1-D range, got "
                         f"shape {ids.shape}")
    if (np.diff(ids) != 1).any():
        raise ValueError("sample_ids must be consecutive: the kernels render "
                         "a window of ids that starts at the first")
    return int(ids[0]), int(ids.size)


def _check(scene: SceneData, mesh: RenderMesh) -> None:
    mesh.check_member()
    if scene.device.type != mesh.device.type:
        raise ValueError(f"the scene lies on {scene.device}, the mesh's "
                         f"ranks render on {mesh.device}")


def _rows(height: int, n: int, axes: str) -> int:
    if height % n != 0:
        raise ValueError(f"height {height} not divisible by {axes} = {n}")
    return height // n


def render_pixel_sharded(scene: SceneData, camera, width: int, height: int,
                         sample_ids, mesh: RenderMesh, *,
                         stats: dict | None = None, **kw) -> torch.Tensor:
    """Rows over ``data``: data index i renders rows [i * h, (i + 1) * h)
    (h = height / data, which must divide: ValueError) with global pixel
    ids, and one all-gather over ``data`` assembles the image, equal to the
    unsharded render bit for bit.  No collective inside the render."""
    _check(scene, mesh)
    kw = _route_kw(kw)
    start, spp = _window(sample_ids)
    h_loc = _rows(height, mesh.data, "the data axis")
    band = render_route(scene)(
        scene, camera, width, h_loc, start, spp,
        row_offset=mesh.data_idx * h_loc, full_height=height, **kw)
    return all_gather(band, mesh.data_group, mesh.backend,
                      stats).reshape(height, width, 3)


def render_sample_sharded(scene: SceneData, camera, width: int, height: int,
                          samples_per_device: int, mesh: RenderMesh,
                          start_sample: int = 0, *,
                          stats: dict | None = None, **kw) -> torch.Tensor:
    """Samples over ``data``: data index i renders ids ``start_sample + i *
    spd .. + spd - 1`` (``spd`` = ``samples_per_device``), and one SUM
    all-reduce over ``data`` adds the images."""
    _check(scene, mesh)
    kw = _route_kw(kw)
    spd = int(samples_per_device)
    img = render_route(scene)(
        scene, camera, width, height, start_sample + mesh.data_idx * spd,
        spd, **kw)
    return all_reduce(img, dist.ReduceOp.SUM, mesh.data_group, mesh.backend,
                      stats)


# ---------------------------------------------------------------------------
# Primitive sharding (config 5).
# ---------------------------------------------------------------------------


def shard_scene_prims(scene: SceneData, n_shards: int) -> SceneData:
    """The scene with its primitive arrays padded by invalid rows (zeros,
    ``prim_valid`` False) to a capacity that ``n_shards`` divides."""
    cap = scene.capacity
    new_cap = -(-cap // n_shards) * n_shards
    if new_cap == cap:
        return scene
    pad = new_cap - cap

    def pad0(x):
        return torch.cat([x, torch.zeros((pad,) + tuple(x.shape[1:]),
                                         dtype=x.dtype, device=x.device)])

    return dataclasses.replace(
        scene, centers=pad0(scene.centers), radii=pad0(scene.radii),
        mat_id=pad0(scene.mat_id), prim_valid=pad0(scene.prim_valid))


def _host_packing(scene: SceneData, camera, block: int):
    """``megakernel_bvh.packed`` of the scene on the host: the whole leaf
    table and tree, which the ring's ranks cut their shards from and the
    card never holds."""
    host = dataclasses.replace(
        scene, centers=scene.centers.cpu(), radii=scene.radii.cpu(),
        mat_id=scene.mat_id.cpu(), prim_valid=scene.prim_valid.cpu())
    return mb.packed(host, camera, block)


def gather_transient_bytes(scene: SceneData, camera, n_prim: int,
                           block: int = mb.BLOCK) -> int:
    """The bytes of the gather strategy's transient copy: the gathered
    primitive rows (the capacity padded for ``n_prim`` shards) and the
    whole packed leaf table and tree at the packing's leaf block."""
    t, _ = _host_packing(scene, camera, block)
    cap = -(-scene.capacity // n_prim) * n_prim
    return 4 * cap * _PRIM_COLS + sum(
        t[k].numel() * t[k].element_size() for k in ("prims", "nodef",
                                                       "nodei"))


def render_prim_sharded(scene: SceneData, camera, width: int, height: int,
                        sample_ids, mesh: RenderMesh, strategy: str = "auto",
                        transient_budget: int = GATHER_TRANSIENT_BUDGET, *,
                        stats: dict | None = None, **kw) -> torch.Tensor:
    """Primitive sharding's front door: ``strategy`` "gather", "ring", or
    "auto" (the default): gather while its transient copy
    (``gather_transient_bytes``) fits ``transient_budget`` bytes, the ring
    beyond.  ``stats``, if given, also gets ``"strategy"``, the one that
    ran.  Any other name raises ValueError."""
    if strategy == "auto":
        strategy = ("gather" if gather_transient_bytes(scene, camera,
                                                       mesh.prim)
                    <= transient_budget else "ring")
    if strategy == "gather":
        fn = render_prim_sharded_gather
    elif strategy == "ring":
        fn = render_prim_sharded_ring
    else:
        raise ValueError(f"unknown prim-sharding strategy {strategy!r}")
    if stats is not None:
        stats["strategy"] = strategy
    return fn(scene, camera, width, height, sample_ids, mesh, stats=stats,
              **kw)


def _prim_slice(scene: SceneData, mesh: RenderMesh) -> torch.Tensor:
    """This prim rank's persistent slice of the primitive arrays, packed
    (cap / prim, 6) float32: cx cy cz r mat_id valid, of
    ``shard_scene_prims(scene, prim)``."""
    sp = shard_scene_prims(scene, mesh.prim)
    n = sp.capacity // mesh.prim
    sl = slice(n * mesh.prim_idx, n * (mesh.prim_idx + 1))
    return torch.cat([sp.centers[sl], sp.radii[sl, None],
                      sp.mat_id[sl, None].to(torch.float32),
                      sp.prim_valid[sl, None].to(torch.float32)], dim=1)


def render_prim_sharded_gather(scene: SceneData, camera, width: int,
                               height: int, sample_ids, mesh: RenderMesh, *,
                               stats: dict | None = None,
                               **kw) -> torch.Tensor:
    """Primitive sharding, ZeRO-style.  Each prim rank's persistent
    storage is its 1/N slice of the primitive arrays (``_prim_slice``); one
    all-gather over ``prim`` a render rebuilds the whole table, cut back to
    the scene's own capacity (padding 128 spheres to 129 for prim=3 would
    move the scene from K1 to K3).  Rows go over ``data * prim`` (height
    must divide: ValueError): the rank at (i, j) renders band ``i * prim +
    j`` of the rebuilt scene through the route, and one all-gather over
    the whole mesh assembles the image, equal to the unsharded render."""
    _check(scene, mesh)
    kw = _route_kw(kw)
    start, spp = _window(sample_ids)
    h_loc = _rows(height, mesh.data * mesh.prim, "data * prim")
    table = all_gather(_prim_slice(scene, mesh), mesh.prim_group,
                       mesh.backend, stats).reshape(-1, _PRIM_COLS)
    table = table[:scene.capacity]
    full = dataclasses.replace(
        scene, centers=table[:, 0:3].contiguous(),
        radii=table[:, 3].contiguous(),
        mat_id=table[:, 4].to(scene.mat_id.dtype),
        prim_valid=table[:, 5] > 0.5)
    band_idx = mesh.data_idx * mesh.prim + mesh.prim_idx
    band = render_route(full)(
        full, camera, width, h_loc, start, spp,
        row_offset=band_idx * h_loc, full_height=height, **kw)
    return all_gather(band, mesh.group, mesh.backend,
                      stats).reshape(height, width, 3)


# ---------------------------------------------------------------------------
# The ring.
# ---------------------------------------------------------------------------

# ``wavefront.render_wavefront``'s defaults: the route's options, the
# sort's floor of alive rays and the rays a chunk's stream holds.
_RING_DEFAULTS = dict(max_bounces=8, rr_depth=3, use_nee=True, use_mis=True,
                      seed=0, dof=None)
_SORT_MIN_RAYS = 1 << 17
_CHUNK_RAYS = 4 << 20

# A padding row of a visiting tree: a box at a point past every ray's
# reach (the slab test rejects it), an inner node, its skip the end.
_PAD_BOX = 2e30


def _ring_shards(t: dict, static: dict, n_prim: int):
    """The prim shards of the host packing: per shard its leaf blocks
    (``_local_blocks``; none where the scene has fewer blocks than shards)
    and their tree (``_shard_tree``; None where empty), the stride
    ``nb_local`` (shard s starts at block ``nb_local * s``) and the
    largest tree's rows a table."""
    prims = t["prims"].reshape(-1, mb._N_PRIM_ATTRS, static["block"])
    nb_local = -(-prims.shape[0] // n_prim)
    shards = []
    for s in range(n_prim):
        if nb_local * s >= prims.shape[0]:
            shards.append((prims[:0], None))
            continue
        local, _ = _local_blocks(prims, n_prim, s)
        lo = nb_local * s
        shards.append((local, _shard_tree(t, static, lo,
                                          lo + local.shape[0])))
    rows = max([1] + [tr[0].shape[0] // 8 for _, tr in shards
                      if tr is not None])
    return shards, nb_local, rows


def _visitor(local, tree, nb_max: int, rows: int, block: int,
             device) -> torch.Tensor:
    """One shard as the flat float32 buffer the ring hands on: its block
    table padded to ``nb_max`` blocks of padding slots (material -1), then
    its tree's 8 octant tables padded to ``rows`` rows each (padding rows
    never reached: the exits that ended a table now end at ``rows``), then
    the int32 node table's bits."""
    prims = torch.zeros((nb_max, mb._N_PRIM_ATTRS, block),
                        dtype=torch.float32)
    prims[:, 4] = -1.0
    prims[:local.shape[0]] = local
    nodef = torch.zeros((8, rows, 8), dtype=torch.float32)
    nodef[:, :, 0:6] = _PAD_BOX
    nodei = torch.zeros((8, rows, 8), dtype=torch.int32)
    nodei[:, :, 0] = rows
    nodei[:, :, 1] = -1
    if tree is not None:
        n = tree[0].shape[0] // 8
        nf = tree[0].reshape(8, n, 8)
        ni = tree[1].reshape(8, n, 8).clone()
        ni[:, :, 0] = torch.where(ni[:, :, 0] >= n, rows, ni[:, :, 0])
        nodef[:, :n] = nf
        nodei[:, :n] = ni
    return torch.cat([prims.reshape(-1), nodef.reshape(-1),
                      nodei.reshape(-1).view(torch.float32)]).to(device)


def _unpack_visitor(buf: torch.Tensor, nb_max: int, rows: int, block: int):
    """(prims (nb_max, 5, block), (nodef, nodei) (8 * rows, 8)): views of a
    ``_visitor`` buffer."""
    a = nb_max * mb._N_PRIM_ATTRS * block
    b = a + 64 * rows
    return (buf[:a].view(nb_max, mb._N_PRIM_ATTRS, block),
            (buf[a:b].view(8 * rows, 8),
             buf[b:].view(torch.int32).view(8 * rows, 8)))


def render_prim_sharded_ring(scene: SceneData, camera, width: int,
                             height: int, sample_ids, mesh: RenderMesh, *,
                             stats: dict | None = None,
                             **kw) -> torch.Tensor:
    """Primitive sharding by a ring: the sorted wavefront over the rank's
    band (rows over ``data * prim``, as the gather), the scene's leaf
    blocks cut into one range a prim rank (``wavefront_prim``'s ranges and
    trees) and handed around the ``prim`` group.  Per bounce: the rank
    sorts its own stream; ``prim`` hops of K6 (its tree mode) against the
    visiting shard, each merged into the running winner (the least
    ``wavefront.winner_t``, on equal distances the lowest shard index;
    block ids rebased by the visiting shard's first block), a
    ``ppermute`` after each hop but the last; then ``prim`` hops of K8 on
    the merged winner, their verdicts OR-ed into residual row 7; then K7b
    and the env-map step.  The visiting buffers are padded to the largest
    shard, so every hop moves one shape.  No rank holds the whole table on
    the device: the host packs it, and each rank moves its own shard.

    Serves every scene size (a shard may hold no blocks).  Equals the
    unsharded wavefront but where a lane's nearest hits on two shards lie
    at the same distance; ``stats`` gets those lanes (``"tie_lanes"``) and
    their pixels (``"tie_pixels"``).  The leaf block, the sort's floor and
    the chunks are ``wavefront.render_wavefront``'s defaults (chunks of
    the full image: ``wavefront.band_chunk_spp``)."""
    _check(scene, mesh)
    kw = dict(_RING_DEFAULTS, **_route_kw(kw))
    start, spp = _window(sample_ids)
    h_loc = _rows(height, mesh.data * mesh.prim, "data * prim")
    row_offset = (mesh.data_idx * mesh.prim + mesh.prim_idx) * h_loc
    dev, block = scene.device, mb.BLOCK
    t, static = _host_packing(scene, camera, block)
    shards, nb_local, rows = _ring_shards(t, static, mesh.prim)
    home = _visitor(*shards[mesh.prim_idx], nb_local, rows, block, dev)
    dof = kw["dof"]
    if dof is None:
        dof = bool(float(_np(camera.aperture)) > 0.0)
    env = scene.env_map if scene.sky_mode == SKY_ENVMAP else None
    if env is not None:
        env = env.to(dev)
    if stats is not None:
        stats.setdefault("tie_pixels", [])
        stats.setdefault("tie_lanes", 0)
    ring = _Ring(home, nb_local, rows, block, mesh, stats)
    scene_tabs = dict(blob=t["blob"].to(dev), lsb=t["lsb"].to(dev),
                      mtypes=t["mtypes"].to(dev),
                      sort=tuple(tuple(v.to(dev) for v in part) for part in
                                 wf._scene_sort_bounds(t["nodef"])))
    chunk_spp = wf.band_chunk_spp(width, h_loc, spp, _CHUNK_RAYS, row_offset,
                                  height)
    img = None
    s = 0
    while s < spp:
        n = min(chunk_spp, spp - s)
        meta = torch.tensor([start + s, kw["seed"], static["n_light_slots"]],
                            dtype=torch.int32).to(dev)
        part = _ring_chunk(ring, scene_tabs, static, env, meta, width=width,
                           height=h_loc, row_offset=row_offset,
                           full_height=height, chunk_spp=n,
                           max_bounces=kw["max_bounces"],
                           rr_depth=kw["rr_depth"],
                           use_nee=bool(kw["use_nee"]),
                           use_mis=bool(kw["use_mis"]),
                           sky_mode=scene.sky_mode, dof=bool(dof))
        img = part if img is None else img + part
        s += n
    return all_gather(img, mesh.group, mesh.backend,
                      stats).reshape(height, width, 3)


class _Ring:
    """The shards' ring as one rank sees it: ``hops(fn)`` calls ``fn(prims,
    tree, first_block, shard)`` once for each prim shard, its own first,
    handing the visiting buffer on (``ppermute``) between hops."""

    def __init__(self, home, nb_local: int, rows: int, block: int,
                 mesh: RenderMesh, stats: dict | None):
        self.home, self.nb_local, self.rows = home, nb_local, rows
        self.block, self.mesh, self.stats = block, mesh, stats

    def hops(self, fn) -> None:
        mesh = self.mesh
        buf = self.home
        for h in range(mesh.prim):
            src = (mesh.prim_idx - h) % mesh.prim
            prims, tree = _unpack_visitor(buf, self.nb_local, self.rows,
                                          self.block)
            fn(prims, tree, self.nb_local * src, src)
            if h + 1 < mesh.prim:
                buf = ppermute(buf, mesh.prim_group, mesh.backend,
                               stats=self.stats)


def _ring_chunk(ring: _Ring, tabs: dict, static: dict, env, meta, *,
                width: int, height: int, row_offset: int, full_height: int,
                chunk_spp: int, max_bounces: int, rr_depth: int,
                use_nee: bool, use_mis: bool, sky_mode: int,
                dof: bool) -> torch.Tensor:
    """One chunk of ``chunk_spp`` images of the rank's band -> its (h, W,
    3) radiance sum.  Every prim rank runs the same hops and collectives
    each bounce, whether or not it has rays alive, and the loop ends when
    no rank of the group has."""
    mesh, block = ring.mesh, ring.block
    n_light_slots = static["n_light_slots"]
    blob, lsb, mtypes = tabs["blob"], tabs["lsb"], tabs["mtypes"]
    dev = blob.device
    st, ids = wf.raygen(blob, meta, width=width, height=height,
                        chunk_spp=chunk_spp, dof=dof, row_offset=row_offset,
                        full_height=full_height)
    buf = wf._stream_buffer(st, ids)
    n_tiles = st.shape[1] // wf.TILE - 1
    lo, ext = tabs["sort"]
    shadows = use_nee and n_light_slots > 0
    kw = dict(block=block, n_mats=static["n_mats"],
              n_light_slots=n_light_slots, rr_depth=rr_depth,
              use_nee=use_nee, use_mis=use_mis, sky_mode=sky_mode)
    none_i = torch.zeros((1, 1, 1), dtype=torch.int32, device=dev)
    none_f = torch.zeros((1, 1, 1), dtype=torch.float32, device=dev)
    home_prims = _unpack_visitor(ring.home, ring.nb_local, ring.rows,
                                 block)[0]
    nalive = n_tiles
    for k in range(max_bounces):
        lanes = wf._sort_span(k, nalive, n_tiles, _SORT_MIN_RAYS, True)
        if lanes is not None:
            nalive = wf._sort_rays(buf, lanes, lo, ext)
        most = torch.tensor([nalive], dtype=torch.int64, device=dev)
        if int(all_reduce(most, dist.ReduceOp.MAX, mesh.prim_group,
                          mesh.backend, ring.stats)[0]) == 0:
            break
        n = nalive * wf.TILE
        head = st[:, :n]
        best = torch.zeros((8, n), dtype=torch.float32, device=dev)
        best[4] = -1.0
        t_best = torch.full((n,), wf.BIG, dtype=torch.float32, device=dev)
        s_best = torch.full((n,), mesh.prim, dtype=torch.int32, device=dev)
        ties = torch.zeros((n,), dtype=torch.bool, device=dev)

        def nearest(prims, tree, first, src):
            if n == 0:
                return
            res = wf.isect(prims, None, None, st, n, block=block, tree=tree)
            tv = wf.winner_t(head, res)
            hit = (res[4] >= 0.0) & (tv < wf.BIG)
            ties.logical_or_(hit & (tv == t_best))
            better = hit & ((tv < t_best) | ((tv == t_best) & (src < s_best)))
            res[5] += float(first)
            best[:7] = torch.where(better, res[:7], best[:7])
            t_best.copy_(torch.where(better, tv, t_best))
            s_best.copy_(torch.where(better, src, s_best))

        ring.hops(nearest)
        if ring.stats is not None and n:
            ring.stats["tie_lanes"] += int(ties.sum())
            ring.stats["tie_pixels"] += ids[0, :n][ties].tolist()
        if shadows:
            def verdicts(prims, tree, first, src):
                if n:
                    best[7] = torch.maximum(best[7], wf.shadow_verdicts(
                        blob, meta, lsb, prims, mtypes, st, ids, best, n,
                        tree=tree, k=k, **kw))

            ring.hops(verdicts)
        if n:
            wf.shade(blob, meta, lsb, home_prims, mtypes, none_i, none_f, st,
                     ids, best, n, k=k, blocked_in_res=True, **kw)
            if sky_mode == SKY_ENVMAP:
                wf._add_env_radiance(head, env)
    return wf._scatter_image(st, ids, width, height, row_offset)


# ---------------------------------------------------------------------------
# Data-parallel gradient step for inverse rendering.
# ---------------------------------------------------------------------------


def make_dp_grad_step(loss_fn, mesh: RenderMesh, samples_per_device: int):
    """``step(params, step_idx) -> (loss, grads)``, sample-sharded.

    ``loss_fn(params, sample_ids)`` is a differentiable scalar.  The rank at
    data index i evaluates it on sample ids ``step_idx * N * spd + i * spd +
    arange(spd)`` (``spd`` = ``samples_per_device``, N the data axis), and
    one all-reduce averages the loss and every gradient over ``data``
    (gloo has no average: a SUM, then a division).  ``params``: a dict of
    tensors; ``grads`` has the same keys, the same on every rank."""
    mesh.check_member()
    spd = samples_per_device

    def step(params: dict, step_idx: int):
        keys = list(params)
        leaves = {k: params[k].detach().requires_grad_(True) for k in keys}
        base = int(step_idx) * mesh.data * spd + mesh.data_idx * spd
        ids = torch.arange(base, base + spd)
        loss = loss_fn(leaves, ids)
        grads = torch.autograd.grad(loss, [leaves[k] for k in keys],
                                    allow_unused=True)
        flat = torch.cat([loss.detach().reshape(1).to(torch.float32)] + [
            (torch.zeros_like(leaves[k]) if g is None else g).reshape(-1)
            .to(torch.float32) for k, g in zip(keys, grads)])
        all_reduce(flat, dist.ReduceOp.SUM, mesh.data_group, mesh.backend)
        flat = flat * (1.0 / mesh.data)
        out, at = {}, 1
        for k in keys:
            n = leaves[k].numel()
            out[k] = flat[at:at + n].reshape(leaves[k].shape)
            at += n
        return flat[0], out

    return step
