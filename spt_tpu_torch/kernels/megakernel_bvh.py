"""BVH megakernel K3: the forward render of scenes above 128 spheres.

The port of ``spt_tpu.kernels.megakernel_bvh``'s forward path.  The scene
is packed once on the host (``pack_bvh_scene``): a BVH built with leaves of
``block`` spheres, its leaves' spheres in fixed blocks ``prims`` (n_blocks,
5, block) of cx cy cz r material-id (padding slots: zeros, id -1), eight
copies of the skip-link node table, one per ray-direction octant with the
near child first (``_octant_tables``), and a uniform blob of camera, sky,
material table and light slots.  Every sample of every pixel then runs the
bounce loop of K1 (``physics.trace_bounce``), with the nearest hit and the
shadow test taken by walking the tree instead of testing every sphere.

* ``megakernel_bvh_fwd`` is the kernel's wrapper.  On CUDA tensors it
  launches the hand-written kernel ``csrc/megakernel_bvh.cu`` and raises if
  it cannot; on CPU tensors it runs ``render_tiles_bvh_plain``.
* ``render_tiles_bvh_plain`` is the plain PyTorch version.  Its intersector
  is the kernel's walk done per lane in lockstep: each ray walks its own
  octant's table (chosen by the signs of dx, dy, dz) with one node pointer,
  slab-tests the node's box against its own nearest distance so far, tests
  a hit leaf's ``block`` slots in order with a strict ``<``, and goes on to
  ``skip``.  Shadow rays walk the same way and stop at their first blocker.
  Same visit order as the kernel, so ties resolve alike.  It counts node and
  sphere tests for the bound (``stats``).
* ``render_tiles_bvh`` packs a scene and camera (cached by content) and
  calls the wrapper; it is what the engine calls.

A winner in a padding slot (material id -1) takes K1's row for an invalid
sphere: Lambert, black, ior 1.5, so K3 and K1 agree on it too.
``LAUNCHES["k3"]`` (in ``megakernel``) counts K3 launches.
"""

from __future__ import annotations

import ctypes
import hashlib
import time

import numpy as np
import torch

from ..core.bvh import build_bvh
from ..core.materials import DIELECTRIC, LAMBERT, METAL
from ..core.scene import SceneData
from . import physics
from .megakernel import (K1_OPS, LAUNCHES, PlainScene, _SKY_OFF, _check, _f32,
                         _np, render_paths_plain)

BLOCK = 32       # spheres per BVH leaf block

TMIN = physics.TMIN
BIG = physics.BIG

# blob layout: camera (15) + sky (6) as in K1, then the material table and
# the light slots.
_MAT_OFF = 21
_MAT_STRIDE = 8    # ar ag ab  er eg eb  rough ior
_LIGHT_STRIDE = 7  # cx cy cz r  er eg eb
_N_PRIM_ATTRS = 5  # cx cy cz r mid

def _octant_tables(nodef, nodei):
    """Eight octant-ordered preorder layouts of one skip-link BVH.

    A ray whose direction lies in an octant wants the NEAR child first, so
    an early hit tightens its nearest distance and prunes the far subtree;
    a skip-link layout bakes the visit order into memory, so there is one
    preorder per octant (near child = the smaller centroid along the axis
    that separates the children most, for a positive direction sign).
    Children come from the skip links (child1 = i+1, child2 = skip[child1]).
    Returns stacked (8n, 8) float32 / int32 tables (table ``o`` starts at
    row ``o*n``, its skip pointers table-local) and ``perm`` (8, n): the
    original preorder index of each table row.  Any table is correct for
    any ray; the order only decides how much is culled."""
    n = nodef.shape[0]
    perm = np.zeros((8, n), np.int32)
    skip = nodei[:, 0]
    blockid = nodei[:, 1]
    cent = (nodef[:, 0:3] + nodef[:, 3:6]) * 0.5
    outf = np.zeros((8, n, 8), np.float32)
    outi = np.zeros((8, n, 8), np.int32)
    children = [None] * n        # (c1, c2), (c1, -1), or None for leaves
    for i in range(n):
        if blockid[i] >= 0:
            continue
        c1 = i + 1
        if c1 >= n:
            continue
        c2 = int(skip[c1])
        children[i] = (c1, c2) if (c2 < int(skip[i]) and c2 < n) else (c1, -1)
    for o in range(8):
        neg = ((o >> 2) & 1, (o >> 1) & 1, o & 1)   # (dx<0, dy<0, dz<0)
        pos = 0
        # Iterative preorder; (node, -1) emits, (node, row) patches the
        # row's skip once the subtree is out.
        stack = [(0, -1)]
        while stack:
            i, patch = stack.pop()
            if patch >= 0:
                outi[o, patch, 0] = pos
                continue
            me = pos
            pos += 1
            outf[o, me] = nodef[i]
            outi[o, me, 1] = blockid[i]
            perm[o, me] = i
            stack.append((i, me))
            ch = children[i]
            if ch is None:
                continue
            c1, c2 = ch
            if c2 < 0:
                stack.append((c1, -1))
                continue
            axis = int(np.argmax(np.abs(cent[c2] - cent[c1])))
            first, second = c1, c2
            if (cent[c2][axis] > cent[c1][axis]) == bool(neg[axis]):
                first, second = c2, c1
            stack.append((second, -1))      # LIFO: first child emits first
            stack.append((first, -1))
    return outf.reshape(8 * n, 8), outi.reshape(8 * n, 8), perm


def pack_bvh_scene(scene: SceneData, camera, block: int = BLOCK):
    """Host-side packing: BVH + leaf-blocked prim table + uniform blob, as
    numpy arrays bit-equal to the JAX package's.

    Returns (blob, meta_fixed, nodef8, nodei8, prims, static); ``static``
    holds the ints and tables that parameterize the kernel (``n_mats``,
    ``mtypes``, ``n_light_slots``, ``block``, ``n_nodes`` per table,
    ``n_blocks``, ``block_prim_ids``, ``light_prims``, ``node_cover``,
    ``octant_perm``, ``tree``: the (n_nodes, 8) preorder ``nodef`` and
    ``nodei`` the octant tables were made from), ``builder``, the BVH
    builder that ran, and ``seconds``: host time of the BVH build, the
    octant tables and all."""
    t0 = time.perf_counter()
    centers = _np(scene.centers).astype(np.float32)
    radii = _np(scene.radii).astype(np.float32)
    valid = _np(scene.prim_valid).astype(bool)
    mat_id = _np(scene.mat_id).astype(np.int32)

    bvh = build_bvh(centers, radii, valid=valid, max_leaf=block)
    t_bvh = time.perf_counter() - t0
    node_min, node_max = bvh.node_min.numpy(), bvh.node_max.numpy()
    node_skip, node_first = bvh.node_skip.numpy(), bvh.node_first.numpy()
    node_count, prim_idx = bvh.node_count.numpy(), bvh.prim_idx.numpy()
    n_nodes = bvh.n_nodes

    nodef = np.zeros((n_nodes, 8), np.float32)
    nodef[:, 0:3] = node_min
    nodef[:, 3:6] = node_max
    nodei = np.zeros((n_nodes, 8), np.int32)
    nodei[:, 0] = node_skip
    nodei[:, 1] = -1

    # Leaves into fixed blocks (leaf order == preorder == spatial).
    leaf_nodes = np.nonzero(node_count > 0)[0]
    n_blocks = max(len(leaf_nodes), 1)
    prims = np.zeros((n_blocks, _N_PRIM_ATTRS, block), np.float32)
    prims[:, 4, :] = -1.0  # material-id sentinel of padding slots
    block_prim_ids = np.full((n_blocks, block), -1, np.int32)
    for b, ni in enumerate(leaf_nodes):
        nodei[ni, 1] = b
        first, count = int(node_first[ni]), int(node_count[ni])
        ids = prim_idx[first:first + count]
        prims[b, 0, :count] = centers[ids, 0]
        prims[b, 1, :count] = centers[ids, 1]
        prims[b, 2, :count] = centers[ids, 2]
        prims[b, 3, :count] = radii[ids]
        prims[b, 4, :count] = mat_id[ids].astype(np.float32)
        block_prim_ids[b, :count] = ids

    # Uniform blob: camera + sky + material table + light slots.
    mats = scene.materials
    albedo = _np(mats.albedo).astype(np.float32)
    emission = _np(mats.emission).astype(np.float32)
    rough = _np(mats.roughness).astype(np.float32)
    ior = _np(mats.ior).astype(np.float32)
    mtype = _np(mats.mtype).astype(np.int32)
    n_mats = len(rough)
    light_prims = [int(p) for p, ok in zip(_np(scene.light_idx),
                                           _np(scene.light_valid)) if ok]
    n_lights = len(light_prims)
    light_off = _MAT_OFF + _MAT_STRIDE * n_mats
    blob = np.zeros(light_off + _LIGHT_STRIDE * max(n_lights, 1), np.float32)
    blob[0:3] = _np(camera.position)
    blob[3:6] = _np(camera.right)
    blob[6:9] = _np(camera.up)
    blob[9:12] = _np(camera.forward)
    blob[12] = float(_np(camera.tan_half_fov))
    blob[13] = float(_np(camera.aperture))
    blob[14] = float(_np(camera.focus_dist))
    sky = _np(scene.sky_params).astype(np.float32)
    blob[_SKY_OFF:_SKY_OFF + 3] = sky[0]
    blob[_SKY_OFF + 3:_SKY_OFF + 6] = sky[1]
    for m in range(n_mats):
        off = _MAT_OFF + _MAT_STRIDE * m
        blob[off:off + 3] = albedo[m]
        blob[off + 3:off + 6] = emission[m]
        blob[off + 6] = rough[m]
        blob[off + 7] = max(ior[m], 1.001)
    for l, p in enumerate(light_prims):
        off = light_off + _LIGHT_STRIDE * l
        blob[off:off + 3] = centers[p]
        blob[off + 3] = radii[p]
        blob[off + 4:off + 7] = emission[mat_id[p]]

    # Refit metadata: node_cover[i, b] = leaf block b lies in original-
    # preorder node i's subtree; octant_perm maps table rows back to it.
    leaf_pos = np.full(n_blocks, -1, np.int64)
    leaf_pos[nodei[leaf_nodes, 1]] = leaf_nodes
    node_cover = ((leaf_pos[None, :] >= np.arange(n_nodes)[:, None])
                  & (leaf_pos[None, :] < node_skip[:, None]))

    static = dict(n_mats=n_mats, mtypes=tuple(int(t) for t in mtype),
                  n_light_slots=n_lights, block=block, n_nodes=n_nodes,
                  n_blocks=n_blocks, block_prim_ids=block_prim_ids,
                  light_prims=light_prims, node_cover=node_cover,
                  tree=(nodef, nodei), builder=bvh.builder)
    t1 = time.perf_counter()
    nodef8, nodei8, perm = _octant_tables(nodef, nodei)
    static["octant_perm"] = perm
    static["seconds"] = dict(bvh_build=t_bvh,
                             octant_tables=time.perf_counter() - t1,
                             pack=time.perf_counter() - t0)
    return (blob, np.asarray([0, 0, n_lights], np.int32), nodef8, nodei8,
            prims, static)


def shard_tree(static, lo: int, hi: int):
    """The packed tree cut to the leaf blocks [lo, hi) -> its 8 octant
    tables (nodef8, nodei8), as ``pack_bvh_scene`` makes the whole tree's:
    the tree a prim shard walks over its range of the leaf table.

    Leaf blocks are numbered in preorder, so a range is a run of
    consecutive leaves, and a node's subtree holds one of them where it
    meets the run's span of rows.  Kept: each such node, but for an inner
    node with one such child (its box would be that child's), so a
    one-leaf range is a tree of one leaf.  Preorder stays; a kept node's
    skip is the count of kept nodes before the end of its subtree; its box
    the union of its kept leaves' build boxes (their rows of ``nodef``);
    block ids local (block - lo).  The whole range [0, n_blocks) gives the
    packed tree's own tables.  Raises ValueError on an empty range."""
    nodef, nodei = static["tree"]
    leaves = np.flatnonzero(nodei[:, 1] >= 0)    # block b at row leaves[b]
    if not 0 <= lo < hi <= len(leaves):
        raise ValueError(f"leaf blocks [{lo}, {hi}) of {len(leaves)}")
    rows = np.arange(nodef.shape[0])
    skip = nodei[:, 0].astype(np.int64)
    first, last = leaves[lo], leaves[hi - 1]
    holds = (rows <= last) & (skip > first)
    c1 = np.minimum(rows + 1, len(rows) - 1)
    c2 = np.minimum(skip[c1], len(rows) - 1)
    two = (rows + 1 < len(rows)) & (skip[c1] < skip)
    inner = nodei[:, 1] < 0
    one_child = inner & (holds[c1] != (two & holds[c2]))
    keep = holds & ~one_child
    before = np.concatenate([[0], np.cumsum(keep)])  # kept rows before a row
    kept = np.flatnonzero(keep)
    span = leaves[lo:hi]
    out_f = np.zeros((len(kept), 8), np.float32)
    out_i = np.zeros((len(kept), 8), np.int32)
    for r, i in enumerate(kept):
        own = nodef[span[np.searchsorted(span, i):np.searchsorted(span,
                                                                 skip[i])]]
        out_f[r, 0:3] = own[:, 0:3].min(axis=0)
        out_f[r, 3:6] = own[:, 3:6].max(axis=0)
    out_i[:, 0] = before[skip[kept]]
    out_i[:, 1] = np.where(inner[kept], -1, nodei[kept, 1] - lo)
    nodef8, nodei8, _ = _octant_tables(out_f, out_i)
    return nodef8, nodei8


# ---------------------------------------------------------------------------
# Differentiable packing: the blob and the prim table from scene tensors.
# ---------------------------------------------------------------------------


def pack_blob_torch(scene: SceneData, camera, static) -> torch.Tensor:
    """``pack_bvh_scene``'s blob (camera, sky, material table, light slots)
    as tensor ops on the scene's device, differentiable with respect to the
    scene's tensors: the port of JAX's ``megakernel_bvh.pack_blob_jnp``,
    bit for bit.  The ior is ``maximum(ior, 1.001)``, whose cotangent
    splits at a tie as JAX's does (``physics._max``)."""
    dev = scene.device

    def field(v):
        if not isinstance(v, torch.Tensor):
            v = torch.from_numpy(np.array(v, np.float32))
        return v.to(dev, torch.float32).reshape(-1)

    cam = torch.cat([field(getattr(camera, f)) for f in (
        "position", "right", "up", "forward", "tan_half_fov", "aperture",
        "focus_dist")])
    mats = scene.materials
    table = torch.cat([mats.albedo, mats.emission, mats.roughness[:, None],
                       physics._max(mats.ior, 1.001)[:, None]], dim=1)
    parts = [cam, scene.sky_params.reshape(-1).to(torch.float32),
             table.reshape(-1).to(torch.float32)]
    lp = static["light_prims"]
    if lp:
        idx = torch.tensor(lp, dtype=torch.long, device=dev)
        rows = torch.cat([scene.centers[idx], scene.radii[idx][:, None],
                          mats.emission[scene.mat_id[idx].long()]], dim=1)
        parts.append(rows.reshape(-1).to(torch.float32))
    else:
        parts.append(torch.zeros(_LIGHT_STRIDE, dtype=torch.float32,
                                 device=dev))
    return torch.cat(parts)


def _block_index(static, device):
    """(ok, idx): the leaf slots that hold a prim, and its index (0 for a
    padding slot), both (n_blocks, block), from the static block map."""
    ids = torch.from_numpy(np.asarray(static["block_prim_ids"])).to(device)
    return ids >= 0, torch.clamp_min(ids, 0).long()


def pack_prims_torch(scene: SceneData, static) -> torch.Tensor:
    """``pack_bvh_scene``'s (n_blocks, 5, block) prim table gathered from the
    scene's tensors by the static block map (padding slots zero with id
    -1), differentiable in the centres and radii: JAX's ``pack_prims_jnp``,
    bit for bit."""
    ok, idx = _block_index(static, scene.device)
    okf = ok.to(torch.float32)
    rows = [scene.centers[idx, a] * okf for a in range(3)]
    rows.append(scene.radii[idx] * okf)
    rows.append(torch.where(ok, scene.mat_id[idx].to(torch.float32), -1.0))
    return torch.stack(rows, dim=1).to(torch.float32)


def refit_nodef_torch(scene: SceneData, static) -> torch.Tensor:
    """The 8 stacked octant node tables' boxes refit to the scene's current
    centres and radii over the static topology (8 n_nodes, 8), detached:
    JAX's ``refit_nodef_jnp``, bit for bit.  Each leaf block's box is the
    union of its prims' boxes; each node's the union of the blocks it
    covers (``node_cover``); the octant tables gather them by
    ``octant_perm``.  Without it the walk would cull against the build's
    boxes and miss a sphere moved out of its own."""
    ok, idx = _block_index(static, scene.device)
    c = scene.centers.detach()[idx]                      # (nb, block, 3)
    r = scene.radii.detach()[idx][..., None]
    lo_b = torch.where(ok[..., None], c - r, 3e38).amin(dim=1)
    hi_b = torch.where(ok[..., None], c + r, -3e38).amax(dim=1)
    cover = torch.from_numpy(np.asarray(static["node_cover"])).to(
        scene.device)                                    # (n_nodes, nb)
    nmin = torch.where(cover[:, :, None], lo_b[None], 3e38).amin(dim=1)
    nmax = torch.where(cover[:, :, None], hi_b[None], -3e38).amax(dim=1)
    nodef = torch.cat([nmin, nmax, torch.zeros(
        (static["n_nodes"], 2), dtype=torch.float32, device=scene.device)],
        dim=1)
    perm = torch.from_numpy(np.asarray(static["octant_perm"]).reshape(-1))
    return nodef[perm.long().to(scene.device)].contiguous()


# ---------------------------------------------------------------------------
# The plain version: K3's walk per lane, in lockstep.
# ---------------------------------------------------------------------------


def _safe_inv(v):
    """1/v, with 3e38 where |v| <= 1e-20 (the slab test's convention)."""
    ok = torch.abs(v) > 1e-20
    return torch.where(ok, 1.0 / torch.where(ok, v, 1.0), 3e38)


def _slab(nf, ox, oy, oz, ivx, ivy, ivz, tmax):
    """Per-lane slab test of (n, 8) node rows against the lanes' rays."""
    t0 = (nf[:, 0] - ox) * ivx
    t1 = (nf[:, 3] - ox) * ivx
    tn = torch.minimum(t0, t1)
    tf = torch.maximum(t0, t1)
    t0 = (nf[:, 1] - oy) * ivy
    t1 = (nf[:, 4] - oy) * ivy
    tn = torch.maximum(tn, torch.minimum(t0, t1))
    tf = torch.minimum(tf, torch.maximum(t0, t1))
    t0 = (nf[:, 2] - oz) * ivz
    t1 = (nf[:, 5] - oz) * ivz
    tn = torch.maximum(tn, torch.minimum(t0, t1))
    tf = torch.minimum(tf, torch.maximum(t0, t1))
    return (tn <= tf) & (tf > TMIN) & (tn < tmax)


def _leaf_t(pr, ox, oy, oz, dx, dy, dz):
    """(m, block) entry distances of m lanes into their leaf's (m, 5,
    block) slots, and where they count (disc > 0 and t > TMIN): the
    kernel's quadratic."""
    cx, cy, cz, r = pr[:, 0], pr[:, 1], pr[:, 2], pr[:, 3]
    ocx, ocy, ocz = cx - ox[:, None], cy - oy[:, None], cz - oz[:, None]
    b = dx[:, None] * ocx + dy[:, None] * ocy + dz[:, None] * ocz
    c = ocx * ocx + ocy * ocy + ocz * ocz - r * r
    disc = b * b - c
    pos = disc > 0.0
    sq = torch.sqrt(physics._max(torch.where(pos, disc, 1.0), 1e-12))
    tj = torch.where(b - sq > TMIN, b - sq, b + sq)
    return tj, pos & (tj > TMIN)


class _Walk:
    """The packed tree, walked per lane: ``nearest`` and ``anyhit``.  Each
    returns the number of node and sphere tests the data needs: a hit
    leaf's filled slots, not its padding (which K3 tests too)."""

    def __init__(self, nodef, nodei, prims, block: int):
        self.nodef, self.nodei, self.prims = nodef, nodei, prims
        self.n_nodes = nodef.shape[0] // 8
        self.block = block
        self.filled = (prims[:, 4, :] >= 0.0).sum(dim=1)   # per leaf block

    def _start(self, dx, dy, dz, lanes):
        octant = ((dx < 0.0).long() * 4 + (dy < 0.0).long() * 2
                  + (dz < 0.0).long())
        ptr = torch.where(lanes, 0, self.n_nodes)
        return octant * self.n_nodes, ptr, torch.nonzero(lanes)[:, 0]

    def _step(self, base, ptr, idx, o, iv, tmax):
        """One node per live lane: (hit box, block id, next pointer)."""
        p = ptr[idx]
        row = base[idx] + p
        ni = self.nodei[row]
        hit = _slab(self.nodef[row], *(a[idx] for a in o),
                    *(a[idx] for a in iv), tmax)
        blk = ni[:, 1]
        nxt = torch.where(hit & (blk < 0), p + 1, ni[:, 0].long())
        return hit, blk, nxt

    def nearest(self, o, d, active):
        """(t, slot): nearest distance (BIG on a miss) and global slot
        ``block_id * block + j`` of the winner (-1 on a miss)."""
        n = o[0].shape[0]
        t = torch.full((n,), BIG, dtype=torch.float32, device=o[0].device)
        win = torch.full((n,), -1, dtype=torch.int64, device=o[0].device)
        iv = tuple(_safe_inv(a) for a in d)
        base, ptr, idx = self._start(*d, active)
        nodes = spheres = 0
        while idx.numel():
            hit, blk, nxt = self._step(base, ptr, idx, o, iv, t[idx])
            nodes += idx.numel()
            leaf = hit & (blk >= 0)
            li = idx[leaf]
            if li.numel():
                lb = blk[leaf].long()
                tj, ok = _leaf_t(self.prims[lb], *(a[li] for a in o),
                                 *(a[li] for a in d))
                tmin, j = torch.where(ok, tj, BIG).min(dim=1)
                better = tmin < t[li]
                t[li] = torch.where(better, tmin, t[li])
                win[li] = torch.where(better, lb * self.block + j, win[li])
                spheres += int(self.filled[lb].sum())
            ptr[idx] = nxt
            idx = idx[nxt < self.n_nodes]
        return t, win, nodes, spheres

    def anyhit(self, o, d, tmax, need):
        """Blocked lanes: a sphere with TMIN < t < tmax.  A lane stops at
        its first blocker, and its sphere tests are counted up to it (or
        over the leaf's filled slots where none blocks)."""
        blocked = torch.zeros_like(need)
        iv = tuple(_safe_inv(a) for a in d)
        base, ptr, idx = self._start(*d, need)
        nodes = spheres = 0
        while idx.numel():
            hit, blk, nxt = self._step(base, ptr, idx, o, iv, tmax[idx])
            nodes += idx.numel()
            leaf = hit & (blk >= 0)
            li = idx[leaf]
            if li.numel():
                lb = blk[leaf].long()
                tj, ok = _leaf_t(self.prims[lb], *(a[li] for a in o),
                                 *(a[li] for a in d))
                hits = ok & (tj < tmax[li][:, None])
                any_hit = hits.any(dim=1)
                first = torch.where(any_hit, hits.int().argmax(dim=1) + 1,
                                    self.filled[lb])
                spheres += int(first.sum())
                blocked[li] = any_hit
                nxt[leaf] = torch.where(any_hit, self.n_nodes, nxt[leaf])
            ptr[idx] = nxt
            idx = idx[nxt < self.n_nodes]
        return blocked, nodes, spheres


def _resolve(walk: _Walk, mats, mtypes, t, win):
    """The winner's attributes, keyed as ``intersect_spheres_unrolled``'s,
    and its material masks: centre and radius from its slot, the rest from
    the material table by its id."""
    found = t < BIG
    slot = torch.clamp_min(win, 0)
    row = walk.prims[slot // walk.block, :, slot % walk.block]   # (N, 5)
    mid = torch.where(found, row[:, 4], -1.0).long()
    own = found & (mid >= 0)
    m = torch.clamp_min(mid, 0)
    h = {}
    for a, key in enumerate(("cx", "cy", "cz", "r")):
        h[key] = torch.where(found, row[:, a], 0.0)
    for a, key in enumerate(("ar", "ag", "ab", "er", "eg", "eb", "rough",
                             "ior")):
        h[key] = torch.where(own, mats[m, a], 1.5 if key == "ior" else 0.0)
    mt = mtypes[m]
    m_lam = found & ((mid < 0) | (mt == LAMBERT))   # padding: K1's invalid row
    return h, m_lam, own & (mt == METAL), own & (mt == DIELECTRIC)


_STAT_KEYS = ("nodes", "spheres", "shadow_nodes", "shadow_spheres")


def render_tiles_bvh_plain(blob: torch.Tensor, meta: torch.Tensor,
                           lsb: torch.Tensor, nodef: torch.Tensor,
                           nodei: torch.Tensor, prims: torch.Tensor,
                           mtypes: torch.Tensor, *, width: int, height: int,
                           spp: int, block: int, n_mats: int,
                           n_light_slots: int, max_bounces: int,
                           rr_depth: int, use_nee: bool, use_mis: bool,
                           sky_mode: int, dof: bool,
                           stats: dict | None = None) -> torch.Tensor:
    """Plain PyTorch version of K3 -> (H, W, 3) radiance sum of samples
    ``meta[0] .. meta[0] + spp - 1``.

    ``stats``, if given, receives ``render_samples_plain``'s counts and, per
    bounce, ``"nodes"`` and ``"spheres"`` tested by the nearest-hit walks
    and ``"shadow_nodes"`` / ``"shadow_spheres"`` by the shadow walks."""
    LAUNCHES["plain"] += 1
    light_off = _MAT_OFF + _MAT_STRIDE * n_mats
    lights = blob[light_off:light_off + _LIGHT_STRIDE * n_light_slots] \
        .reshape(n_light_slots, _LIGHT_STRIDE)
    sc = PlainScene(blob, meta, lsb, 0, n_light_slots, lights=lights)
    mats = blob[_MAT_OFF:light_off].reshape(n_mats, _MAT_STRIDE)
    mtypes = mtypes.long()
    walk = _Walk(nodef.reshape(-1, 8), nodei.reshape(-1, 8).long(),
                 prims.reshape(-1, _N_PRIM_ATTRS, block), block)
    work = {key: [0] * max_bounces for key in _STAT_KEYS}

    def geometry(k):
        def intersect(ox, oy, oz, dx, dy, dz, active):
            t, win, nodes, spheres = walk.nearest((ox, oy, oz), (dx, dy, dz),
                                                  active)
            work["nodes"][k] += nodes
            work["spheres"][k] += spheres
            return (t, *_resolve(walk, mats, mtypes, t, win))

        def occluded(ox, oy, oz, dx, dy, dz, tmax, need):
            blocked, nodes, spheres = walk.anyhit((ox, oy, oz), (dx, dy, dz),
                                                  tmax, need)
            work["shadow_nodes"][k] += nodes
            work["shadow_spheres"][k] += spheres
            return blocked
        return intersect, occluded

    start = int(_np(meta[0]))
    img = render_paths_plain(
        blob, sc, [start + s for s in range(spp)], width=width,
        height=height, n_light_slots=n_light_slots, max_bounces=max_bounces,
        rr_depth=rr_depth, use_nee=use_nee, use_mis=use_mis,
        sky_mode=sky_mode, dof=dof, stats=stats, geometry=geometry)
    if stats is not None:
        stats.update(work)
    return img


# fp32 operations of K3 (csrc/megakernel_bvh.cu, csrc/physics.cuh), counted
# by hand as K1_OPS are: the bounce's shading is K1's; a walk adds the
# safe inverse of the direction (abs, compare, divide per axis) and, per
# node, the slab test (per axis 2 sub, 2 mul, min, max; 4 min/max to
# combine; 3 compares).  A lower count of what the data needs: sphere tests
# are a hit leaf's filled slots (``_Walk``), though K3 tests its padding too.
K3_OPS = dict(K1_OPS, walk_setup=9, node_test=25)


def k3_op_count(stats: dict) -> int:
    """Lower count of K3's fp32 operations for the work in ``stats``
    (``render_tiles_bvh_plain(..., stats=...)`` on the same inputs)."""
    active, hit, shadow = (sum(stats[k]) for k in ("active", "hit", "shadow"))
    nodes = sum(stats["nodes"]) + sum(stats["shadow_nodes"])
    spheres = sum(stats["spheres"]) + sum(stats["shadow_spheres"])
    return (stats["paths"] * K3_OPS["raygen"]
            + (active + shadow) * K3_OPS["walk_setup"]
            + nodes * K3_OPS["node_test"]
            + spheres * K3_OPS["sphere_test"]
            + (active - hit) * K3_OPS["miss"]
            + hit * K3_OPS["hit"]
            + shadow * K3_OPS["shadow"])


def megakernel_bvh_fwd(blob: torch.Tensor, meta: torch.Tensor,
                       lsb: torch.Tensor, nodef: torch.Tensor,
                       nodei: torch.Tensor, prims: torch.Tensor,
                       mtypes: torch.Tensor, *, width: int, height: int,
                       spp: int, block: int, n_mats: int, n_light_slots: int,
                       max_bounces: int, rr_depth: int, use_nee: bool,
                       use_mis: bool, sky_mode: int,
                       dof: bool) -> torch.Tensor:
    """K3's wrapper: (H, W, 3) float32 radiance sum over ``spp`` samples.

    CUDA tensors launch the CUDA kernel on the current stream; CPU tensors
    take ``render_tiles_bvh_plain``."""
    kw = dict(width=width, height=height, spp=spp, block=block,
              n_mats=n_mats, n_light_slots=n_light_slots,
              max_bounces=max_bounces, rr_depth=rr_depth, use_nee=use_nee,
              use_mis=use_mis, sky_mode=sky_mode, dof=dof)
    args = (blob, meta, lsb, nodef, nodei, prims, mtypes)
    if blob.device.type == "cpu":
        return render_tiles_bvh_plain(*args, **kw)
    if blob.device.type != "cuda":
        raise NotImplementedError(f"K3 has no kernel for {blob.device}")
    if any(a.device != blob.device for a in args):
        raise ValueError("K3's inputs must lie on one device")
    n_rows = nodef.numel() // 8
    if n_rows == 0 or n_rows % 8 or block <= 0 \
            or prims.numel() % (_N_PRIM_ATTRS * block):
        raise ValueError(f"K3: nodef of {nodef.numel()} floats and prims of "
                         f"{prims.numel()} floats at block {block}")
    n_blocks = prims.numel() // (_N_PRIM_ATTRS * block)
    _check(blob, "blob", torch.float32, _MAT_OFF + _MAT_STRIDE * n_mats
           + _LIGHT_STRIDE * max(n_light_slots, 1))
    _check(meta, "meta", torch.int32, 3)
    _check(lsb, "lsb", torch.float32, 6)
    _check(nodef, "nodef", torch.float32, 8 * n_rows)
    _check(nodei, "nodei", torch.int32, 8 * n_rows)
    _check(prims, "prims", torch.float32, _N_PRIM_ATTRS * block * n_blocks)
    _check(mtypes, "mtypes", torch.int32, n_mats)
    if nodef.data_ptr() % 16 or nodei.data_ptr() % 8:
        raise ValueError("K3 reads node rows as float4 / int2: nodef must be "
                         "16-byte and nodei 8-byte aligned")
    from ._build import load_library
    lib = load_library("megakernel_bvh")
    out = torch.empty((height, width, 3), dtype=torch.float32,
                      device=blob.device)
    with torch.cuda.device(blob.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.spt_megakernel_bvh_fwd(
            out.data_ptr(), *(a.data_ptr() for a in args), width, height,
            spp, n_rows // 8, block, n_mats, n_light_slots,
            max_bounces, rr_depth, int(bool(use_nee)), int(bool(use_mis)),
            int(sky_mode), int(bool(dof)), ctypes.c_float(_f32(1.0 / width)),
            ctypes.c_float(_f32(1.0 / height)),
            ctypes.c_float(_f32(width / height)), stream)
    if err != 0:
        raise RuntimeError(f"K3 launch failed: CUDA error {err}")
    LAUNCHES["k3"] += 1
    return out


# Packed tables by a content fingerprint of scene + camera (object ids
# alias after garbage collection and would keep old tensors alive).
_PACK_CACHE: dict = {}


def _pack_fingerprint(scene: SceneData, camera, block: int):
    h = hashlib.blake2b(digest_size=16)
    mats = scene.materials
    for a in (scene.centers, scene.radii, scene.mat_id, scene.prim_valid,
              mats.albedo, mats.emission, mats.roughness, mats.ior,
              mats.mtype, scene.sky_params):
        h.update(np.ascontiguousarray(_np(a)).tobytes())
    for v in (camera.position, camera.right, camera.up, camera.forward,
              camera.tan_half_fov, camera.aperture, camera.focus_dist):
        h.update(np.asarray(_np(v), np.float32).tobytes())
    return (h.digest(), scene.capacity, scene.sky_mode, block,
            str(scene.device))


def packed(scene: SceneData, camera, block: int = BLOCK):
    """(tensors, static): K3's inputs on the scene's device, ``tensors`` a
    dict of ``blob``, ``nodef``, ``nodei``, ``prims``, ``mtypes`` and
    ``lsb``, packed once per scene and camera content."""
    key = _pack_fingerprint(scene, camera, block)
    hit = _PACK_CACHE.get(key)
    if hit is None:
        blob, _, nodef, nodei, prims, static = pack_bvh_scene(scene, camera,
                                                              block)
        dev = scene.device
        tensors = {name: torch.from_numpy(a).to(dev) for name, a in (
            ("blob", blob), ("nodef", nodef), ("nodei", nodei),
            ("prims", prims),
            ("mtypes", np.asarray(static["mtypes"], np.int32)))}
        tensors["lsb"] = physics.lsel_bounds_from_prims(tensors["prims"])
        hit = (tensors, static)
        if len(_PACK_CACHE) > 8:
            _PACK_CACHE.clear()
        _PACK_CACHE[key] = hit
    return hit


def render_tiles_bvh(scene: SceneData, camera, width: int, height: int,
                     start_sample: int, spp: int, *, max_bounces=8,
                     rr_depth=3, use_nee=True, use_mis=True, seed=0,
                     dof=None, block: int = BLOCK) -> torch.Tensor:
    """Render ``spp`` samples with K3; returns the (H, W, 3) radiance sum.

    Runs on the scene's device: the CUDA kernel for a scene on the card,
    the plain version for a scene on the CPU.  ``dof=None`` takes the
    thin lens iff the camera has an aperture."""
    t, static = packed(scene, camera, block)
    if dof is None:
        dof = bool(float(_np(camera.aperture)) > 0.0)
    meta = torch.tensor([start_sample, seed, static["n_light_slots"]],
                        dtype=torch.int32).to(scene.device)
    return megakernel_bvh_fwd(
        t["blob"], meta, t["lsb"], t["nodef"], t["nodei"], t["prims"],
        t["mtypes"], width=width, height=height, spp=spp, block=block,
        n_mats=static["n_mats"], n_light_slots=static["n_light_slots"],
        max_bounces=max_bounces, rr_depth=rr_depth, use_nee=bool(use_nee),
        use_mis=bool(use_mis), sky_mode=scene.sky_mode, dof=bool(dof))
