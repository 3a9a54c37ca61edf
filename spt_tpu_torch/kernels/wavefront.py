"""The sorted wavefront: the forward render of env-map skies and of scenes
above 2048 spheres.

The port of ``spt_tpu.kernels.wavefront``'s split-bounce engine.  The render
keeps every ray's state in device memory between kernels and splits each
bounce at its hit:

  K5 raygen -> [ sort by a coherence key (not at bounce 0)
                 -> K6 intersect: each ray's nearest hit by a walk of the
                    packed tree (one thread a ray) -> residual
                 -> K7 shade: ``trace_bounce`` on the rebuilt hit, each
                    shadow ray walking the tree; state in place
                 -> env-map radiance on the lanes that missed
               ] x depth -> scatter-add by pixel id

The JAX package culls each tile's rays against every leaf block's box
first and sweeps per-tile candidate lists, because a TPU walks a packet
behind one scalar node pointer; a thread of the card walks its own ray,
so the split path builds no lists, and neither does the prim-sharded
render, whose shards walk their own trees.  The lists (``precull_tiles``,
and ``shadow_rays`` rebuilt from K6's residual and culled too) remain
where JAX's form is the point: ``mxu=True`` and ``split=False`` with
``precull``.  ``GLUE_CALLS`` counts their calls.

The stream is one float32 (19, R) buffer: the 17 state channels (``C_*``)
and, bit for bit, the int32 pixel and sample ids.  R counts 1024-lane tiles
of 32x32 swizzled pixels, ``chunk_spp`` images of them and one all-pad tile.
Every random draw is keyed on the ids the ray carries, so no permutation of
the stream changes a ray's result: the sort is invisible to the estimator.
After a sort the alive rays form a prefix; the kernels and the preculls run
over that prefix only, its length read to the host once per bounce.  The
JAX package's A/B knobs set the sort (``sort_every``, ``qbits``,
``dir_major``, ``dbits``, ``rowsort``) and the list sweeps' t exits
(``tcull``); none changes the image (``render_wavefront``).

Two other forms of a bounce, as in the JAX package (neither the default):

* ``split=False``: the fused bounce, K11, one kernel a bounce.  Its
  nearest hit sweeps the precull's lists as K6 does, each lane skipping a
  candidate whose leaf box (``leaf_boxes``) its own ray misses
  (``precull``, the default), or walks the tree as K3 does
  (``precull=False``: no precull at all); its shadow rays always walk the
  tree, so there is no shadow stage:

    K5 raygen -> [ sort -> (precull) -> K11 bounce -> env map ] x depth

* ``mxu=True``: K6m and K7m in place of K6 and K7, over per-row lists
  (``precull_tiles(per_row=True)``, a list a 128-lane row) with the
  sphere quadratic in the expanded, block-centred form the TPU ran as a
  matmul (``build_cmat``'s tables, read from their slot-major copy, built
  once a packing by ``mxu_tables``; K7m's shadow test without a square
  root, ``_seg_blocked``).  K6m's sweep skips each candidate whose leaf
  box its lane's ray misses, as K11's does.

Each kernel has a wrapper and a plain PyTorch version: ``raygen`` /
``raygen_plain`` (K5), ``isect`` / ``isect_plain`` (K6), ``shade`` /
``shade_plain`` (K7), ``bounce`` / ``bounce_plain`` (K11), ``isect_mxu``
/ ``isect_mxu_plain`` (K6m), ``shade_mxu`` / ``shade_mxu_plain`` (K7m).
K6 and K7 take the tree (``tree=(nodef, nodei)``: the walks) or lists
(K6 the tiles' candidate lists, K7 the shadow lists).  A wrapper runs the
plain version for CPU tensors and launches the hand-written kernel
(``csrc/wavefront.cu``) for CUDA tensors, or raises.  The glue between
them (sort, precull, shadow rays, env map, scatter) is torch ops, as it
was XLA around the TPU kernels.  ``LAUNCHES["k5"]``, ``["k6"]``,
``["k7"]``, ``["k11"]``, ``["k6m"]`` and ``["k7m"]`` count the kernels'
launches (K6 and K7 walking the tree; over lists ``["k6l"]`` and
``["k7l"]``);
``LAUNCHES["plain"]`` counts one per call of any plain version, so a
wavefront render on the CPU adds one per chunk for raygen and two per
bounce that has alive rays.

The primitive-sharded render (``parallel/wavefront_prim.py``) runs K6's
tree mode on its shard's tree (``megakernel_bvh.shard_tree``) and adds
two: K8, ``shadow_verdicts`` / ``shadow_verdicts_plain``, K9's bounce on
the merged winner with its shadow ray walking the shard's tree, keeping
the verdict and not the path (``LAUNCHES["k8"]``), and K7 reading the
verdict merged over the shards from residual row 7 instead of tracing
(``shade(..., blocked_in_res=True)``, ``LAUNCHES["k7b"]``); ``winner_t``
rebuilds each lane's nearest distance for the merge.  K8's list form,
``anyhit`` / ``anyhit_plain``, K7's shadow sweep alone over given shadow
rays and lists (``LAUNCHES["k8l"]``), is on no render path.

A padding slot of a leaf block (centre 0, radius 0, id -1) can win K6's
sweep where the float quadratic says a ray through the origin hits it;
its id -1 then reads as no hit and the lane takes the sky, as in the JAX
package's split wavefront.  The fused bounce follows JAX's fused one: a
hit with no material (``_fused_intersect``).  The two K3s resolve it
otherwise again (ROADMAP.md).
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import math

import numpy as np
import torch

from ..core import rng
from ..core.materials import DIELECTRIC, LAMBERT, METAL
from ..core.scene import SKY_ENVMAP, SceneData
from . import physics
from .megakernel import (K1_OPS, LAUNCHES, PlainScene, _check, _f32, _np,
                         band_height, camera_rays)
from .megakernel_bvh import (BLOCK, K3_OPS, _LIGHT_STRIDE, _MAT_OFF,
                             _MAT_STRIDE, _N_PRIM_ATTRS, _Walk, _leaf_t,
                             _safe_inv, _slab, packed)

TMIN = physics.TMIN
BIG = physics.BIG

TILE = 1024          # lanes of a stream tile
ROW = 128            # lanes of a row: the per-row lists' group (K6m, K7m)
TW = TH = 32         # its pixels, swizzled 32 x 32

# State channels (float32).
C_OX, C_OY, C_OZ, C_DX, C_DY, C_DZ = range(6)
C_TR, C_TG, C_TB = 6, 7, 8
C_LR, C_LG, C_LB = 9, 10, 11
C_PDF = 12
C_ALIVE, C_SPEC, C_INIMG = 13, 14, 15
C_MISS = 16          # missed this bounce: the env-map step reads and clears it
N_CH = 17
N_IDS = 2            # pixel id, sample id (int32, rows 17 and 18 of the buffer)
N_RES = 8            # K6's residual: hcx hcy hcz hr hmid hblk hslot 0

# Sort-key bits: morton bits per origin axis, and fine direction bits (the
# JAX package's defaults off the TPU; ``render_wavefront``'s ``qbits`` and
# ``dbits``).
Q_BITS = 4
D_BITS = 0

PRECULL_TILE_CHUNK = 64   # tiles per precull step: bounds the (chunk, 1024,
                          # n_blocks) intermediates

# Calls of the list-building glue: ``precull_tiles`` and ``shadow_rays``.
GLUE_CALLS = {"precull": 0, "shadow_rays": 0}


def _live_bits(qbits: int, dbits: int = D_BITS) -> int:
    """Bits of an alive lane's key: octant, direction bits, morton code."""
    bits = 3 * qbits + 3 + 3 * dbits
    if bits + 2 > 31:
        raise ValueError(
            f"sort key needs {bits}+2 bits; qbits+dbits must be <= 8 "
            f"(got qbits={qbits}, dbits={dbits})")
    return bits


def _dead_key(qbits: int, dbits: int = D_BITS) -> int:
    """The key of a dead in-image lane: after every live key, whatever the
    key width, so the alive count is the number of keys below it."""
    return 1 << _live_bits(qbits, dbits)


def _pad_key(qbits: int, dbits: int = D_BITS) -> int:
    """The key of an out-of-image lane: after the dead ones too."""
    return 1 << (_live_bits(qbits, dbits) + 1)


def check_knobs(*, sort_every: int = 1, qbits: int = Q_BITS,
                dir_major: bool = True, dbits: int = D_BITS) -> None:
    """Raises ValueError where the sort's knobs make no key: ``sort_every``
    below 0, ``qbits`` below 1, ``dbits`` below 0, or a key wider than 31
    bits (``qbits + dbits > 8``; ``dbits`` counts only ``dir_major``)."""
    if sort_every < 0:
        raise ValueError(f"sort_every must be >= 0 (got {sort_every})")
    if qbits < 1 or dbits < 0:
        raise ValueError(f"qbits must be >= 1 and dbits >= 0 (got "
                         f"qbits={qbits}, dbits={dbits})")
    _live_bits(qbits, dbits if dir_major else 0)


def stream_tiles(width: int, height: int, chunk_spp: int):
    """(tiles_x, tiles per image, real tiles of the stream)."""
    tiles_x = -(-width // TW)
    tiles_per_img = tiles_x * -(-height // TH)
    return tiles_x, tiles_per_img, tiles_per_img * chunk_spp


def _stream_buffer(st: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """The (19, R) buffer whose rows are ``st`` and then ``ids``."""
    r = st.shape[1]
    buf = st.as_strided((N_CH + N_IDS, r), (r, 1))
    if ids.data_ptr() != buf[N_CH:].data_ptr():
        raise ValueError("st and ids must be one (19, R) stream buffer")
    return buf


def _new_stream(n_lanes: int, device):
    """A (19, n_lanes) float32 buffer as its (17, R) state and (2, R) int32
    id views."""
    buf = torch.empty((N_CH + N_IDS, n_lanes), dtype=torch.float32,
                      device=device)
    return buf[:N_CH], buf[N_CH:].view(torch.int32)


# ---------------------------------------------------------------------------
# K5: raygen
# ---------------------------------------------------------------------------


def raygen_plain(blob: torch.Tensor, meta: torch.Tensor, *, width: int,
                 height: int, chunk_spp: int, dof: bool, row_offset: int = 0,
                 full_height: int | None = None):
    """Plain version of K5 -> (st (17, R), ids (2, R) int32), views of one
    (19, R) buffer.  Tile ``t`` of the stream is pixel tile ``t %
    tiles_per_img`` of sample ``meta[0] + t // tiles_per_img``; lane ``l``
    of a tile is its pixel (l % 32, l // 32).  The last tile pads: no lane
    of it, nor any lane off the image, is alive or in the image.  With
    ``row_offset`` and ``full_height`` the images are the band of
    ``height`` rows from row ``row_offset`` of a ``full_height``-row image:
    tiles cover the band, and a lane's pixel id (``ids[0]``) and camera ray
    are the full image's."""
    full = band_height(height, row_offset, full_height)
    LAUNCHES["plain"] += 1
    dev = blob.device
    tiles_x, tiles_per_img, n_tiles = stream_tiles(width, height, chunk_spp)
    n = (n_tiles + 1) * TILE
    meta_h = _np(meta).astype(np.int64)
    lane = torch.arange(n, dtype=torch.int64, device=dev)
    tile, lin = lane // TILE, lane % TILE
    timg = tile % tiles_per_img
    px = (timg % tiles_x) * TW + lin % TW
    py = (timg // tiles_x) * TH + lin // TW
    in_image = (px < width) & (py < height) & (tile < n_tiles)
    pxc = torch.clamp_max(px, width - 1)
    pyc = torch.clamp_max(py, height - 1) + row_offset
    pid = pyc * width + pxc
    sample = (int(meta_h[0]) + tile // tiles_per_img) & rng.MASK32
    rays = camera_rays(blob, pid, pxc.to(torch.float32),
                       pyc.to(torch.float32), sample, width=width,
                       height=full, seed=int(meta_h[1]) & rng.MASK32,
                       dof=dof)
    st, ids = _new_stream(n, dev)
    img = in_image.to(torch.float32)
    one, zero = torch.ones_like(img), torch.zeros_like(img)
    for c, v in enumerate((*rays, one, one, one, zero, zero, zero, zero, img,
                           one, img, zero)):
        st[c] = v
    ids[0] = pid.to(torch.int32)
    ids[1] = rng.to_int32_bits(sample)
    return st, ids


def raygen(blob: torch.Tensor, meta: torch.Tensor, *, width: int,
           height: int, chunk_spp: int, dof: bool, row_offset: int = 0,
           full_height: int | None = None):
    """K5's wrapper: ``raygen_plain``'s stream, on the blob's device (a
    band with ``row_offset`` and ``full_height``, as there)."""
    full = band_height(height, row_offset, full_height)
    kw = dict(width=width, height=height, chunk_spp=chunk_spp, dof=dof,
              row_offset=row_offset, full_height=full_height)
    if blob.device.type == "cpu":
        return raygen_plain(blob, meta, **kw)
    if blob.device.type != "cuda":
        raise NotImplementedError(f"K5 has no kernel for {blob.device}")
    if meta.device != blob.device:
        raise ValueError("K5's inputs must lie on one device")
    if blob.dtype != torch.float32 or blob.numel() < 15 \
            or not blob.is_contiguous():
        raise ValueError("K5: blob must be a contiguous float32 tensor "
                         "holding the camera")
    _check(meta, "meta", torch.int32, 3)
    tiles_x, tiles_per_img, n_tiles = stream_tiles(width, height, chunk_spp)
    n = (n_tiles + 1) * TILE
    st, ids = _new_stream(n, blob.device)
    from ._build import load_library
    lib = load_library("wavefront")
    with torch.cuda.device(blob.device):
        err = lib.spt_wavefront_raygen(
            st.data_ptr(), ids.data_ptr(), blob.data_ptr(), meta.data_ptr(),
            width, height, tiles_x, tiles_per_img, n_tiles, n,
            int(bool(dof)), int(row_offset), ctypes.c_float(_f32(1.0 / width)),
            ctypes.c_float(_f32(1.0 / full)),
            ctypes.c_float(_f32(width / full)),
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"K5 launch failed: CUDA error {err}")
    LAUNCHES["k5"] += 1
    return st, ids


# ---------------------------------------------------------------------------
# Glue: precull
# ---------------------------------------------------------------------------


def _leaf_block_bounds(prims: torch.Tensor):
    """Per-leaf-block boxes (n_blocks, 3) lo and hi from the packed prim
    table; padding slots (id -1) are left out, so an underfull block's box
    is tight."""
    valid = prims[:, 4, :] >= 0.0
    c = prims[:, 0:3, :]
    r = prims[:, 3:4, :]
    lo = torch.where(valid[:, None, :], c - r, 3e38).amin(dim=2)
    hi = torch.where(valid[:, None, :], c + r, -3e38).amax(dim=2)
    return lo, hi


def leaf_boxes(lob: torch.Tensor, hib: torch.Tensor) -> torch.Tensor:
    """The leaf blocks' boxes as K11's list sweep reads them: (n_blocks, 8)
    float32 rows lo xyz, hi xyz, 0 0, a tree node's row (``_slab``'s)."""
    return torch.cat([lob, hib, torch.zeros_like(lob[:, :2])],
                     dim=1).contiguous()


def _box_cull(boxes: torch.Tensor, o, d):
    """K11's cull: ``cull(idx, blk, tmax)`` -> whether lane ``idx[m]``'s ray
    meets the box of its block ``blk[m]`` below ``tmax[m]`` (``_slab``, the
    tree walk's node test, on ``leaf_boxes``' rows)."""
    iv = tuple(_safe_inv(a) for a in d)

    def cull(idx, blk, tmax):
        return _slab(boxes[blk], *(a[idx] for a in o), *(a[idx] for a in iv),
                     tmax)
    return cull


def _empty_lists(n_tiles: int, nb: int, device, n_grp: int = 1):
    cand = torch.full((n_tiles, n_grp, nb + 1), -1, dtype=torch.int32,
                      device=device)
    cand[:, :, 0] = 0
    ctn = torch.full((n_tiles, n_grp, nb), BIG, dtype=torch.float32,
                     device=device)
    return cand, ctn


def precull_tiles(o3, d3, act, tmax, lob, hib, per_row: bool = False):
    """Per-tile candidate lists of rays given as flat tensors of whole
    tiles: ``o3``, ``d3`` their origin and direction components, ``act``
    0/1 where a ray is traced, ``tmax`` an upper bound on the t that counts
    (None for nearest-hit rays).  A block is a candidate of a tile iff the
    slab test of some traced ray of the tile against its box passes.

    Returns ``cand`` (tiles, 1, n_blocks + 1) int32, the count then the
    candidate ids nearest-first (-1 past the count), and ``ctn`` (tiles,
    1, n_blocks) float32, each candidate's least entry distance over the
    tile's rays that pass (clamped at 0; BIG past the count), nondecreasing.
    Chunks of ``PRECULL_TILE_CHUNK`` tiles without a traced ray are not
    tested (one read of which are live).

    ``per_row`` (the matmul-form sweeps K6m and K7m) makes one list per
    row of ``ROW`` lanes in place of one per tile: (tiles, 8, n_blocks +
    1) and (tiles, 8, n_blocks), row ``r`` of tile ``t`` the list of lanes
    ``t * TILE + r * ROW ..``, as the JAX package's ``_precull_rays(
    per_row=True)`` lays them out."""
    GLUE_CALLS["precull"] += 1
    nb = lob.shape[0]
    n_tiles = act.numel() // TILE
    dev = act.device
    n_grp = TILE // ROW if per_row else 1
    cand, ctn = _empty_lists(n_tiles, nb, dev, n_grp)
    chunk = PRECULL_TILE_CHUNK
    n_chunks = -(-n_tiles // chunk)
    pad = n_chunks * chunk * TILE - act.numel()
    live = torch.nn.functional.pad(act, (0, pad)).reshape(n_chunks, -1) \
        .gt(0.5).any(dim=1).tolist()
    iv3 = tuple(_safe_inv(d) for d in d3)
    for c in range(n_chunks):
        if not live[c]:
            continue
        a, b = c * chunk * TILE, min((c + 1) * chunk * TILE, act.numel())
        ct = (b - a) // TILE

        def grab(v):
            return v[a:b].reshape(ct, TILE, 1)

        tn = tf = None
        for ax in range(3):
            o, iv = grab(o3[ax]), grab(iv3[ax])
            t0 = (lob[:, ax] - o) * iv
            t1 = (hib[:, ax] - o) * iv
            lo_t, hi_t = torch.minimum(t0, t1), torch.maximum(t0, t1)
            del t0, t1
            if tn is None:
                tn = torch.clamp_min(lo_t, -BIG)
                tf = torch.clamp_max(hi_t, BIG)
            else:
                tn = torch.maximum(tn, lo_t)
                tf = torch.minimum(tf, hi_t)
            del lo_t, hi_t
        hit = (tn <= tf) & (tf > TMIN) & (grab(act) > 0.5)
        del tf
        if tmax is not None:
            hit &= tn < grab(tmax)
        grp = torch.where(hit, torch.clamp_min(tn, 0.0), BIG).reshape(
            ct, n_grp, TILE // n_grp, nb).amin(dim=2)
        del tn, hit
        order = torch.argsort(grp, dim=-1, stable=True)
        s_tn = torch.gather(grp, -1, order)
        n_cand = (grp < BIG).sum(dim=-1, dtype=torch.int32)
        ids = torch.where(s_tn < BIG, order.to(torch.int32), -1)
        rows = slice(c * chunk, c * chunk + ct)
        cand[rows, :, 0] = n_cand
        cand[rows, :, 1:] = ids
        ctn[rows] = s_tn
    return cand, ctn


# ---------------------------------------------------------------------------
# Glue: the coherence sort
# ---------------------------------------------------------------------------


def _part1by2(x, nbits: int):
    """Spread the low ``nbits`` of ``x``: bit b -> bit 3*b (morton)."""
    out = x & 1
    for b in range(1, nbits):
        out = out | ((x & (1 << b)) << (2 * b))
    return out


def _coherence_key(stf, lo, ext, qbits: int = Q_BITS, dir_major: bool = True,
                   dbits: int = D_BITS):
    """The sort key, int32, JAX's bit for bit.  Direction-major (the
    default): octant (3 bits), then ``dbits`` bits a direction axis of
    ``|d|``, morton-interleaved, then the origin's morton code (``qbits``
    per axis), for alive lanes; else ``(morton << 3) | octant``, ``dbits``
    ignored.  Dead in-image lanes take ``_dead_key`` and the rest
    ``_pad_key``, of the same width.  A tile of sorted rays then shares an
    octant and a run of origin cells.  ``lo``, ``ext``: the scene box's
    corner and extent (3 0-d tensors)."""
    n = float(1 << qbits)
    q = []
    for c, lo_a, e in zip((C_OX, C_OY, C_OZ), lo, ext):
        q.append(torch.clamp((stf[c] - lo_a) * (n / e), 0.0, n - 1.0)
                 .to(torch.int32))
    morton = ((_part1by2(q[0], qbits) << 2) | (_part1by2(q[1], qbits) << 1)
              | _part1by2(q[2], qbits))
    octant = ((stf[C_DX] < 0).to(torch.int32) * 4
              + (stf[C_DY] < 0).to(torch.int32) * 2
              + (stf[C_DZ] < 0).to(torch.int32))
    if dir_major:
        dirfine = torch.zeros_like(octant)
        if dbits:
            nd = float(1 << dbits)
            qd = [torch.clamp(torch.abs(stf[c]) * nd, 0.0, nd - 1.0)
                  .to(torch.int32) for c in (C_DX, C_DY, C_DZ)]
            dirfine = ((_part1by2(qd[0], dbits) << 2)
                       | (_part1by2(qd[1], dbits) << 1)
                       | _part1by2(qd[2], dbits))
        key = ((octant << (3 * dbits + 3 * qbits))
               | (dirfine << (3 * qbits)) | morton)
    else:
        dbits = 0
        key = (morton << 3) | octant
    return torch.where(stf[C_ALIVE] > 0.5, key,
                       torch.where(stf[C_INIMG] > 0.5, _dead_key(qbits, dbits),
                                   _pad_key(qbits, dbits)).to(torch.int32))


def _sort_order(buf: torch.Tensor, n_lanes: int, lo, ext, qbits: int,
                dir_major: bool, dbits: int, rowsort: bool):
    """(order, alive prefix in tiles) of lanes [0, n_lanes) of the stream
    by ``_coherence_key``: ``order`` the stable sort's lane permutation, or
    with ``rowsort`` (JAX's, ``n_lanes`` whole rows) each ``ROW``-lane row
    kept whole and the rows ordered by their least member key, so a row
    with an alive lane sorts into the prefix; its alive prefix is the rows
    below the dead key, rounded up to tiles."""
    key = _coherence_key(buf[:, :n_lanes], lo, ext, qbits, dir_major, dbits)
    dead = _dead_key(qbits, dbits if dir_major else 0)
    if not rowsort:
        n_alive = int((key < dead).sum())
        return torch.sort(key, stable=True).indices, -(-n_alive // TILE)
    row_key = key.reshape(-1, ROW).amin(dim=1)
    rows = torch.sort(row_key, stable=True).indices
    order = (rows[:, None] * ROW + torch.arange(ROW, device=key.device)) \
        .reshape(-1)
    n_rows = int((row_key < dead).sum())
    return order, -(-n_rows // (TILE // ROW))


def _sort_rays(buf: torch.Tensor, n_lanes: int, lo, ext, qbits: int = Q_BITS,
               dir_major: bool = True, dbits: int = D_BITS,
               rowsort: bool = False) -> int:
    """Sort lanes [0, n_lanes) of the (19, R) stream buffer by
    ``_coherence_key`` (whole rows with ``rowsort``: ``_sort_order``), in
    place: one sort of the key, then one gather of all 19 rows.  Returns
    the alive prefix in tiles (read to the host).  The sort is stable:
    equal keys keep their lane order, so equal streams sort alike wherever
    they are sorted (the prim-sharded render's ranks rely on it)."""
    part = buf[:, :n_lanes]
    order, n_alive_tiles = _sort_order(buf, n_lanes, lo, ext, qbits,
                                       dir_major, dbits, rowsort)
    part.copy_(part.index_select(1, order))
    return n_alive_tiles


def _sort_span(k: int, nalive: int, n_tiles: int, sort_min_rays: int,
               compact: bool, sort_every: int = 1,
               rowsort: bool = False) -> int | None:
    """The lanes to sort before bounce ``k``, or None for no sort: a sort
    is considered before bounces 1, 1 + sort_every, ... (none with
    ``sort_every`` 0, as JAX's) and skipped once at most ``sort_min_rays``
    rays are alive; after the first (always at bounce 1, so ``k > 1``),
    once the alive prefix fits in the stream's first half or quarter, only
    that part is sorted (the suffix is dead and stays in place), but not
    by whole rows (JAX's tiers)."""
    if not sort_every or not k or (k - 1) % sort_every \
            or nalive * TILE <= sort_min_rays:
        return None
    lanes = (n_tiles + 1) * TILE
    if compact and not rowsort and k > 1:
        t_half = max(1, (n_tiles + 1) // 2)
        t_quarter = max(1, (n_tiles + 1) // 4)
        if nalive <= t_quarter:
            lanes = t_quarter * TILE
        elif nalive <= t_half:
            lanes = t_half * TILE
    return lanes


def _scene_sort_bounds(nodef: torch.Tensor):
    """The sort key's origin box: the root node's box, each extent at least
    1e-5."""
    nodef = nodef.reshape(-1, 8)
    lo = tuple(nodef[0, a] for a in range(3))
    ext = tuple(physics._max(nodef[0, 3 + a] - nodef[0, a], 1e-5)
                for a in range(3))
    return lo, ext


# ---------------------------------------------------------------------------
# K6: intersect
# ---------------------------------------------------------------------------


def _sweep_lanes(cand, ctn, tile, bound, lanes, step, tcull: bool = True):
    """Per-lane sweep of each lane's tile list in order: lane l takes
    candidate i while ``ctn[tile, i] < bound[l]`` and i is below its
    tile's count; ``step(idx, blk)`` tests block ``blk[m]`` for lanes
    ``idx[m]`` and returns the lanes that stop there.  ``bound`` is read
    again at each step, so a lane whose bound drops stops sooner.  With
    ``tcull`` False the bounds are not read: a lane takes every candidate.

    Returns ``(read, taken)``, (tiles,) int64: per tile, how many entry
    bounds some lane read, and how many candidates some lane took."""
    read = torch.zeros(cand.shape[0], dtype=torch.int64, device=cand.device)
    taken = torch.zeros_like(read)
    ncand = cand[:, 0, 0].long()[tile]
    idx = torch.nonzero(lanes & (ncand > 0))[:, 0]
    i = 0
    while idx.numel():
        if tcull:
            read[tile[idx]] = i + 1
            idx = idx[ctn[tile[idx], 0, i] < bound[idx]]
        if not idx.numel():
            break
        taken[tile[idx]] = i + 1
        stop = step(idx, cand[tile[idx], 0, 1 + i].long())
        i += 1
        idx = idx[~stop & (ncand[idx] > i)]
    return read, taken


def _list_reads(cand, tile, lanes, read, taken) -> tuple[int, int]:
    """What a kernel's sweep reads of the lists, each word once: (words of
    the lists: a tile's count where some lane sweeps, the entry bounds
    read and the candidates taken; distinct leaf blocks taken)."""
    swept = torch.zeros(cand.shape[0], dtype=torch.bool, device=cand.device)
    swept[tile[lanes]] = True
    nb = cand.shape[2] - 1
    first = torch.arange(nb, device=cand.device) < taken[:, None]
    blocks = torch.unique(cand[:, 0, 1:][first]).numel()
    return int(swept.sum() + read.sum() + taken.sum()), blocks


def _flat_lists(cand, ctn):
    """Candidate lists of any grouping (a tile's or a row's) as (groups, 1,
    .) tensors: one list a group, as ``_sweep_lanes`` reads them."""
    return (cand.reshape(-1, 1, cand.shape[-1]),
            ctn.reshape(-1, 1, ctn.shape[-1]))


def _compact_test(prims, o, d):
    """The sphere tests of K6 and K7: ``test(idx, blk)`` -> (tj, ok) (m,
    block) of lanes ``idx`` against the slots of their blocks ``blk``,
    ``_leaf_t``'s quadratic on the centre and radius."""
    def test(idx, blk):
        return _leaf_t(prims[blk], *(a[idx] for a in o),
                       *(a[idx] for a in d))
    return test


def _nearest_sweep(test, prims, cand, ctn, alive, glen: int,
                   stats: dict | None, cull=None, tcull: bool = True):
    """Each alive lane's nearest hit over its group's list (``glen`` lanes
    a group: a tile's or a row's), candidates in order, a block's slots in
    order with a strict ``<``, stopping once the next candidate's bound
    reaches its nearest distance.  With ``cull`` (``_box_cull``: K11's
    sweep) a lane skips a candidate whose box its ray misses or enters at or
    past its nearest distance so far.  ``tcull`` False (JAX's): neither t
    test, every candidate swept and only a box the ray misses skipped.
    Returns (t (n,), BIG on a miss; win
    (n,) int64, the global slot ``block_id * block + j``, -1 on a miss);
    ``prims`` (n_blocks, 5, block); ``stats`` as ``isect_plain``'s, and with
    ``cull`` also ``"culled_blocks"`` and ``"culled_spheres"``: the
    candidates skipped and their filled slots, which the unculled sweep
    would have tested."""
    n = alive.numel()
    dev = alive.device
    block = prims.shape[2]
    filled = (prims[:, 4, :] >= 0.0).sum(dim=1)
    t = torch.full((n,), BIG, dtype=torch.float32, device=dev)
    win = torch.full((n,), -1, dtype=torch.int64, device=dev)
    work = torch.zeros(4, dtype=torch.int64, device=dev)

    def step(idx, blk):
        stop = torch.zeros_like(idx, dtype=torch.bool)   # the sweep goes on
        if cull is not None:
            keep = cull(idx, blk, t[idx] if tcull
                        else torch.full_like(t[idx], BIG))
            work[2] += (~keep).sum()
            work[3] += filled[blk[~keep]].sum()
            idx, blk = idx[keep], blk[keep]
        tj, ok = test(idx, blk)
        tmin, j = torch.where(ok, tj, BIG).min(dim=1)
        better = tmin < t[idx]
        t[idx] = torch.where(better, tmin, t[idx])
        win[idx] = torch.where(better, blk * block + j, win[idx])
        work[0] += filled[blk].sum()
        work[1] += idx.numel()
        return stop

    cand, ctn = _flat_lists(cand, ctn)
    group = torch.arange(n, device=dev) // glen
    reach = _sweep_lanes(cand, ctn, group, t, alive, step, tcull)
    if stats is not None:
        stats["spheres"] = stats.get("spheres", 0) + int(work[0])
        stats["blocks"] = stats.get("blocks", 0) + int(work[1])
        if cull is not None:
            _add_stats(stats, dict(culled_blocks=int(work[2]),
                                   culled_spheres=int(work[3])))
        words, blocks = _list_reads(cand, group, alive, *reach)
        for name, v in (("alive", int(alive.sum())), ("list_words", words),
                        ("blocks_read", blocks)):
            stats[name] = stats.get(name, 0) + v
    return t, win


def _winner_res(prims, t, win, block: int) -> torch.Tensor:
    """K6's residual (8, n) of each lane's winner: its centre, radius and
    material id (-1 on a miss), its leaf block and slot (-1 -1 on a miss),
    and a zero row 7."""
    found = t < BIG
    slot = torch.clamp_min(win, 0)
    row = prims[slot // block, :, slot % block]              # (n, 5)
    res = torch.zeros((N_RES, t.numel()), dtype=torch.float32,
                      device=t.device)
    for a in range(4):
        res[a] = torch.where(found, row[:, a], 0.0)
    res[4] = torch.where(found, row[:, 4], -1.0)
    res[5] = torch.where(found, (slot // block).to(torch.float32), -1.0)
    res[6] = torch.where(found, (slot % block).to(torch.float32), -1.0)
    return res


def _isect_lanes(test, prims, cand, ctn, st, n: int, block: int, glen: int,
                 stats: dict | None, cull=None, tcull: bool = True):
    """(t, residual) of K6's sweep (or K6m's, by ``test``; K11's, by
    ``cull``) over lanes [0, n) of the stream (``tcull``:
    ``_nearest_sweep``'s)."""
    prims = prims.reshape(-1, _N_PRIM_ATTRS, block)
    t, win = _nearest_sweep(test, prims, cand, ctn, st[C_ALIVE, :n] > 0.5,
                            glen, stats, cull, tcull)
    return t, _winner_res(prims, t, win, block)


def _tree_walk(tree, prims, block: int) -> _Walk:
    """The plain walk of the packed tree ``tree`` = (nodef, nodei) over the
    leaf blocks ``prims``."""
    nodef, nodei = tree
    return _Walk(nodef.reshape(-1, 8), nodei.reshape(-1, 8).long(),
                 prims.reshape(-1, _N_PRIM_ATTRS, block), block)


def _walk_lanes(walk: _Walk, st, n: int, block: int, stats: dict | None):
    """(t, residual) of K6's tree mode over lanes [0, n) of the stream: each
    alive lane's nearest hit by its walk of the tree (``_Walk.nearest``),
    its winner's record by ``_winner_res``.  ``stats``, if given, gets
    ``"alive"`` (lanes walked) and the walk's ``"nodes"`` and ``"spheres"``
    added."""
    alive = st[C_ALIVE, :n] > 0.5
    t, win, nodes, spheres = walk.nearest(
        tuple(st[c, :n] for c in (C_OX, C_OY, C_OZ)),
        tuple(st[c, :n] for c in (C_DX, C_DY, C_DZ)), alive)
    if stats is not None:
        _add_stats(stats, dict(alive=int(alive.sum()), nodes=nodes,
                               spheres=spheres))
    return t, _winner_res(walk.prims, t, win, block)


def isect_plain(prims: torch.Tensor, cand: torch.Tensor | None,
                ctn: torch.Tensor | None, st: torch.Tensor, n_lanes: int, *,
                block: int, stats: dict | None = None,
                tree=None, tcull: bool = True) -> torch.Tensor:
    """Plain version of K6 -> residual (8, n_lanes) of lanes [0, n_lanes)
    of the stream ``st`` (17, R).  With ``tree`` = (nodef, nodei), K6's
    tree mode: each alive lane's nearest hit by its walk of the tree
    (``_walk_lanes``; ``cand`` and ``ctn`` are not read).  Else the
    nearest hit over their tiles' lists, each lane testing its candidates
    in order, a block's ``block`` slots in order with a strict ``<``, and
    stopping once the next candidate's bound reaches its nearest distance.
    ``stats``, if given, gets ``"alive"`` (lanes walked or swept) and the
    walk's ``"nodes"`` and ``"spheres"``, or the sweep's ``"spheres"``
    (filled slots of the blocks tested), ``"blocks"``, ``"list_words"``
    and ``"blocks_read"`` (``_list_reads``) added.  ``tcull`` False (the
    lists only): every candidate of the list swept, no stop by the
    bounds."""
    LAUNCHES["plain"] += 1
    n = n_lanes
    if tree is not None:
        return _walk_lanes(_tree_walk(tree, prims, block), st, n, block,
                           stats)[1]
    o = tuple(st[c, :n] for c in (C_OX, C_OY, C_OZ))
    d = tuple(st[c, :n] for c in (C_DX, C_DY, C_DZ))
    return _isect_lanes(_compact_test(prims.reshape(-1, _N_PRIM_ATTRS, block),
                                      o, d),
                        prims, cand, ctn, st, n, block, TILE, stats,
                        tcull=tcull)[1]


def _check_lists(cand, ctn, n_tiles, nb):
    _check(cand, "cand", torch.int32, n_tiles * (nb + 1))
    _check(ctn, "ctn", torch.float32, n_tiles * nb)


def _check_stream(st, ids=None):
    if st.dtype != torch.float32 or st.dim() != 2 or st.shape[0] != N_CH \
            or not st.is_contiguous() or st.shape[1] % TILE:
        raise ValueError(f"st: want a contiguous (17, R) float32 stream, R "
                         f"a multiple of {TILE}; got {st.dtype} "
                         f"{tuple(st.shape)}")
    if ids is not None and (ids.dtype != torch.int32
                            or tuple(ids.shape) != (N_IDS, st.shape[1])
                            or not ids.is_contiguous()):
        raise ValueError(f"ids: want a contiguous (2, {st.shape[1]}) int32 "
                         f"tensor, got {ids.dtype} {tuple(ids.shape)}")


def isect(prims: torch.Tensor, cand: torch.Tensor | None,
          ctn: torch.Tensor | None, st: torch.Tensor, n_lanes: int, *,
          block: int, tree=None, tcull: bool = True) -> torch.Tensor:
    """K6's wrapper: ``isect_plain``'s residual, on the stream's device
    (``tree`` = (nodef, nodei): the tree mode, ``cand`` and ``ctn`` unread;
    else the lists, ``tcull`` as there)."""
    if st.device.type == "cpu":
        return isect_plain(prims, cand, ctn, st, n_lanes, block=block,
                           tree=tree, tcull=tcull)
    return _isect_launch("K6", prims, cand, ctn, st, n_lanes, block, None,
                         tree, tcull)


def _ptr(a) -> int:
    return 0 if a is None else a.data_ptr()


def _check_tree(name: str, nodef, nodei) -> int:
    """Checks the packed tree a kernel walks -> its rows a table."""
    n_nodes = nodef.numel() // 64
    _check(nodef, "nodef", torch.float32, 64 * n_nodes)
    _check(nodei, "nodei", torch.int32, 64 * n_nodes)
    if nodef.data_ptr() % 16 or nodei.data_ptr() % 8:
        raise ValueError(f"{name} reads node rows as float4 / int2: nodef "
                         "must be 16-byte and nodei 8-byte aligned")
    return n_nodes


def _isect_launch(name, prims, cand, ctn, st, n_lanes: int, block: int,
                  mxu, tree=None, tcull: bool = True) -> torch.Tensor:
    """Checks and launches K6's kernel on CUDA tensors (its tree mode with
    ``tree`` = (nodef, nodei); K6m's, on per-row lists, with ``mxu`` =
    (cslot, bctr, boxes); the lists' sweeps without their t exits with
    ``tcull`` False) -> the residual (8, n_lanes)."""
    if st.device.type != "cuda":
        raise NotImplementedError(f"{name} has no kernel for {st.device}")
    inputs = (prims, *((cand, ctn) if tree is None else tree), *(mxu or ()))
    if any(a.device != st.device for a in inputs):
        raise ValueError(f"{name}'s inputs must lie on one device")
    _check_stream(st)
    nb = prims.numel() // (_N_PRIM_ATTRS * block)
    if not 0 <= n_lanes <= st.shape[1] or n_lanes % TILE:
        raise ValueError(f"{name}: {n_lanes} lanes of a stream of "
                         f"{st.shape[1]}")
    _check(prims, "prims", torch.float32, _N_PRIM_ATTRS * block * nb)
    n_nodes = 0
    if tree is not None:
        n_nodes = _check_tree(name, *tree)
        cand = ctn = None
    else:
        _check_lists(cand, ctn, n_lanes // (TILE if mxu is None else ROW),
                     nb)
    if mxu is not None:
        cslot, bctr, boxes = mxu
        _check(cslot, "cslot", torch.float32, nb * 16 * block)
        _check(bctr, "bctr", torch.float32, nb * 3)
        _check(boxes, "boxes", torch.float32, 8 * nb)
        if cslot.data_ptr() % 16 or boxes.data_ptr() % 16:
            raise ValueError(f"{name} reads cslot and boxes as float4: both "
                             "must be 16-byte aligned")
    res = torch.empty((N_RES, n_lanes), dtype=torch.float32, device=st.device)
    from ._build import load_library
    lib = load_library("wavefront")
    with torch.cuda.device(st.device):
        err = lib.spt_wavefront_isect(
            *(_ptr(a) for a in (res, st, prims, cand, ctn,
                                *(mxu or (None, None, None)),
                                *(tree or (None, None)))),
            st.shape[1], n_lanes, nb, block, n_nodes, int(bool(tcull)),
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")
    LAUNCHES["k6m" if mxu is not None else "k6" if tree is not None
             else "k6l"] += 1
    return res


# ---------------------------------------------------------------------------
# Glue: shadow rays
# ---------------------------------------------------------------------------


def _lights(blob: torch.Tensor, n_mats: int, n_light_slots: int):
    off = _MAT_OFF + _MAT_STRIDE * n_mats
    return blob[off:off + _LIGHT_STRIDE * n_light_slots].reshape(
        n_light_slots, _LIGHT_STRIDE)


def _winner_quadratic(st, res):
    """(hit lanes: alive and K6 found a sphere, the distance to the winner
    by K6's quadratic on the same floats, as K7 rebuilds it)."""
    ox, oy, oz = st[C_OX], st[C_OY], st[C_OZ]
    dx, dy, dz = st[C_DX], st[C_DY], st[C_DZ]
    hcx, hcy, hcz, hr, hmid = res[0], res[1], res[2], res[3], res[4]
    hit = (st[C_ALIVE] > 0.5) & (hmid >= 0.0)
    ocx, ocy, ocz = hcx - ox, hcy - oy, hcz - oz
    b = dx * ocx + dy * ocy + dz * ocz
    cterm = ocx * ocx + ocy * ocy + ocz * ocz - hr * hr
    disc = b * b - cterm
    pos = disc > 0.0
    sq = torch.sqrt(physics._max(torch.where(pos, disc, 1.0), 1e-12))
    return hit, torch.where(b - sq > TMIN, b - sq, b + sq)


def winner_t(st, res) -> torch.Tensor:
    """Each lane's distance to its K6 winner, rebuilt from the residual by
    the sweep's quadratic (``wavefront._winner_t`` of the JAX package); BIG
    where the lane is dead or missed.  The prim-sharded render takes the
    least of these over the shards."""
    hit, t = _winner_quadratic(st, res)
    return torch.where(hit, t, BIG)


def _winner_hit(st, res):
    """Hit lanes (alive, K6 found a sphere) and their hit points and
    shading normals, by K6's quadratic on the winner (as K7 rebuilds it)."""
    ox, oy, oz = st[C_OX], st[C_OY], st[C_OZ]
    dx, dy, dz = st[C_DX], st[C_DY], st[C_DZ]
    hcx, hcy, hcz = res[0], res[1], res[2]
    hit, t = _winner_quadratic(st, res)
    t_safe = torch.where(hit, t, 1.0)
    hx, hy, hz = ox + t_safe * dx, oy + t_safe * dy, oz + t_safe * dz
    ngx, ngy, ngz = physics._normalize(hx - hcx, hy - hcy, hz - hcz)
    front = -dx * ngx + -dy * ngy + -dz * ngz > 0.0
    sgn = torch.where(front, 1.0, -1.0)
    return hit, (hx, hy, hz), (ngx * sgn, ngy * sgn, ngz * sgn)


def shadow_rays(st, ids, res, blob, lsb, nl: int, *, k: int, seed: int,
                n_mats: int, mtypes, n_light_slots: int):
    """Every lane's NEE shadow ray, rebuilt from K6's residual by the same
    float operations K7 runs (``physics.nee_shadow_setup`` on the winner's
    hit): ``(o3, d3, tmax, need01)`` for ``precull_tiles``.  ``need`` marks
    the lanes whose shadow ray K7 traces (a hit that is not dielectric);
    elsewhere the values are unused.  ``mtypes``: material types, one int
    per material."""
    GLUE_CALLS["shadow_rays"] += 1
    hit, (hx, hy, hz), (nsx, nsy, nsz) = _winner_hit(st, res)
    mt = torch.tensor(list(mtypes) + [0], dtype=torch.int32,
                      device=st.device)[torch.clamp(
                          res[4].to(torch.int32), 0, max(n_mats, 1))]
    need = hit & (mt != DIELECTRIC)
    pid = ids[0].to(torch.int64) & rng.MASK32
    sample = ids[1].to(torch.int64) & rng.MASK32
    kd = k * physics.N_DIMS
    u = dict(lu1=rng.counter_uniform(pid, sample, kd + physics.DIM_LU1, seed),
             lu2=rng.counter_uniform(pid, sample, kd + physics.DIM_LU2, seed),
             lsel_lo=tuple(lsb[a] for a in range(3)),
             lsel_ext=tuple(lsb[3 + a] for a in range(3)),
             sample=sample, seed=seed)
    nlf = max(float(nl), 1.0)
    (pox, poy, poz, ldx, ldy, ldz, t_l, *_rest) = physics.nee_shadow_setup(
        st[C_OX], st[C_OY], st[C_OZ], hx, hy, hz, nsx, nsy, nsz, u,
        _lights(blob, n_mats, n_light_slots), nl, nlf, k)
    return ((pox, poy, poz), (ldx, ldy, ldz), t_l - 1e-3,
            need.to(torch.float32))


# ---------------------------------------------------------------------------
# K7: shade
# ---------------------------------------------------------------------------


def _rebuilt_intersect(mats, mtypes, res):
    """``trace_bounce``'s intersector for K7's plain version: the nearest
    hit rebuilt from K6's residual (no hit where its id is negative)."""
    hcx, hcy, hcz, hr, hmid = res[0], res[1], res[2], res[3], res[4]

    def intersect(ox, oy, oz, dx, dy, dz, active):
        found = hmid >= 0.0
        ocx, ocy, ocz = hcx - ox, hcy - oy, hcz - oz
        b = dx * ocx + dy * ocy + dz * ocz
        cterm = ocx * ocx + ocy * ocy + ocz * ocz - hr * hr
        disc = b * b - cterm
        pos = found & (disc > 0.0)
        sq = torch.sqrt(physics._max(torch.where(pos, disc, 1.0), 1e-12))
        t = torch.where(b - sq > TMIN, b - sq, b + sq)
        t = torch.where(pos, t, BIG)
        m = torch.clamp_min(hmid, 0.0).long()
        h = dict(cx=hcx, cy=hcy, cz=hcz, r=hr)
        for a, key in enumerate(("ar", "ag", "ab", "er", "eg", "eb", "rough",
                                 "ior")):
            h[key] = torch.where(found, mats[m, a], 1.5 if key == "ior"
                                 else 0.0)
        mt = mtypes[m]
        return (t, h, found & (mt == LAMBERT), found & (mt == METAL),
                found & (mt == DIELECTRIC))
    return intersect


def _sweep_anyhit(prims, scand, sctn, o, d, tmax, need, stats=None,
                  mxu=None):
    """The shadow sweep of K7 and K8 on lanes given as flat tensors of
    whole tiles: each lane with ``need`` tests its tile's shadow list in
    order, a block's slots in order, and stops at its first blocker (a hit
    with t < ``tmax``) or once the next candidate's bound reaches its
    ``tmax``.  With ``mxu`` = (cmat, bctr) it is K7m's sweep: each lane
    takes its row's list (``precull_tiles(per_row=True)``) and a slot
    blocks by ``_seg_blocked`` on the expanded quadratic
    (``_expanded_quadratic``).  Returns the (n,) bool verdict; ``stats``,
    if given, gets the sweep's ``"shadow_spheres"`` (filled slots tested,
    up to the blocker), ``"shadow_blocks"``, ``"shadow_list_words"`` and
    ``"shadow_blocks_read"`` (``_list_reads``) added."""
    n = need.numel()
    dev = need.device
    group = torch.arange(n, device=dev) // (TILE if mxu is None else ROW)
    filled = (prims[:, 4, :] >= 0.0).sum(dim=1)
    work = torch.zeros(2, dtype=torch.int64, device=dev)
    verdict = torch.zeros_like(need)

    def step(idx, blk):
        oi, di = tuple(a[idx] for a in o), tuple(a[idx] for a in d)
        if mxu is None:
            tj, ok = _leaf_t(prims[blk], *oi, *di)
            hits = ok & (tj < tmax[idx][:, None])
        else:
            hits = _seg_blocked(*_expanded_quadratic(
                mxu[0][blk], mxu[1][blk], oi, di), tmax[idx][:, None])
        stop = hits.any(dim=1)
        first = torch.where(stop, hits.int().argmax(dim=1) + 1, filled[blk])
        work[0] += first.sum()
        work[1] += idx.numel()
        verdict[idx] = stop
        return stop

    scand, sctn = _flat_lists(scand, sctn)
    reach = _sweep_lanes(scand, sctn, group, tmax, need, step)
    if stats is not None:
        words, blocks = _list_reads(scand, group, need, *reach)
        for name, v in zip(("shadow_spheres", "shadow_blocks",
                            "shadow_list_words", "shadow_blocks_read"),
                           (*work.tolist(), words, blocks)):
            stats[name] = stats.get(name, 0) + v
    return verdict


def _trace_lanes(blob, meta, lsb, st, ids, n: int, intersect, occluded, *,
                 k: int, n_mats: int, n_light_slots: int, rr_depth: int,
                 use_nee: bool, use_mis: bool, sky_mode: int,
                 stats: dict | None) -> None:
    """``trace_bounce`` of bounce ``k`` on lanes [0, n) of the stream, in
    place, with the intersector and shadow test given (as
    ``physics.trace_bounce`` takes them).  Dead lanes keep their state; the
    miss flag is set where an alive lane missed under an env-map sky,
    cleared elsewhere.  ``stats``, if given, gets ``render_samples_plain``'s
    per-bounce counts (``"active"``, ``"hit"``, ``"shadow"``, ``"lit"``)
    added."""
    sc = PlainScene(blob, meta, lsb, 0, n_light_slots,
                    lights=_lights(blob, n_mats, n_light_slots))
    part = st[:, :n]
    pid = ids[0, :n].to(torch.int64) & rng.MASK32
    sample = ids[1, :n].to(torch.int64) & rng.MASK32
    want_miss = sky_mode == SKY_ENVMAP
    cfg = physics.BounceCfg(
        mtypes=(), k=k, rr_depth=rr_depth, use_nee=use_nee, use_mis=use_mis,
        sky_mode=sky_mode, n_light_slots=n_light_slots, want_miss=want_miss)
    alive = part[C_ALIVE] > 0.5
    state, aux, tape = physics.trace_bounce_tape(
        sc.theta, tuple(part[c] for c in range(C_PDF + 1)),
        (alive, part[C_SPEC] > 0.5), sc.uniforms(pid, sample, k), sc.nl, cfg,
        intersect, occluded)
    for c, v in enumerate(state):
        part[c] = v
    part[C_ALIVE] = aux[0].to(torch.float32)
    part[C_SPEC] = aux[1].to(torch.float32)
    part[C_MISS] = (aux[2] if want_miss
                    else torch.zeros_like(alive)).to(torch.float32)
    if stats is not None:
        nee = use_nee and n_light_slots > 0 and sc.nl > 0
        zero = torch.zeros_like(alive)
        counts = torch.stack([
            alive, tape.hit, tape.hit & ~tape.m_die if nee else zero,
            tape.nee.nee_ok if nee else zero]).sum(1).tolist()
        for name, v in zip(("active", "hit", "shadow", "lit"), counts):
            stats[name] = stats.get(name, 0) + v


def _add_stats(stats: dict | None, work: dict) -> None:
    if stats is not None:
        for name, v in work.items():
            stats[name] = stats.get(name, 0) + v


def shade_plain(blob, meta, lsb, prims, mtypes, scand, sctn, st, ids, res,
                n_lanes: int, *, k: int, block: int, n_mats: int,
                n_light_slots: int, rr_depth: int, use_nee: bool,
                use_mis: bool, sky_mode: int, stats: dict | None = None,
                blocked: torch.Tensor | None = None,
                blocked_in_res: bool = False, tree=None) -> None:
    """Plain version of K7: bounce ``k`` of lanes [0, n_lanes) of the
    stream, in place.  ``trace_bounce`` on the hit rebuilt from ``res``;
    with ``tree`` = (nodef, nodei) each shadow ray walks the tree and stops
    at its first blocker (``_Walk.anyhit``); else it tests its tile's
    shadow list in order and stops at its first blocker or once the next
    candidate's bound reaches its t_max (``_sweep_anyhit``).  With
    ``blocked_in_res`` (K7's mode for the prim-sharded render, and K7m's
    after its verdict pass) nothing is
    traced: a shadow ray is blocked where residual row 7 holds more than
    0.5, and ``scand``, ``sctn``, ``tree`` and ``prims`` are not read.
    Dead lanes keep their state; the miss flag is set where an alive lane
    missed under an env-map sky, cleared elsewhere.  ``stats``, if given,
    gets ``render_samples_plain``'s per-bounce counts of this bounce
    (``"active"``, ``"hit"``, ``"shadow"``, ``"lit"``) and the shadow
    test's counts added: the walks' ``"shadow_nodes"`` and
    ``"shadow_spheres"``, or the sweep's ``"shadow_spheres"``,
    ``"shadow_blocks"``, ``"shadow_list_words"`` and
    ``"shadow_blocks_read"`` (zero with ``blocked_in_res``).  ``blocked``,
    if given, (n_lanes,) float32, receives the NEE shadow verdict: 1 where
    a traced shadow ray is blocked, 0 elsewhere (K9's record,
    ``wavefront_grad.shade_fwd_plain``)."""
    LAUNCHES["plain"] += 1
    n = n_lanes
    prims = prims.reshape(-1, _N_PRIM_ATTRS, block)
    mats = blob[_MAT_OFF:_MAT_OFF + _MAT_STRIDE * n_mats].reshape(
        n_mats, _MAT_STRIDE)
    walk = None if tree is None or blocked_in_res else \
        _tree_walk(tree, prims, block)
    sweep_stats = dict.fromkeys(
        ("shadow_nodes", "shadow_spheres") if walk is not None else
        ("shadow_spheres", "shadow_blocks", "shadow_list_words",
         "shadow_blocks_read"), 0)

    def occluded(ox, oy, oz, dx, dy, dz, tmax, need):
        if blocked_in_res:
            verdict = need & (res[7, :n] > 0.5)
        elif walk is not None:
            verdict, nodes, spheres = walk.anyhit((ox, oy, oz), (dx, dy, dz),
                                                  tmax, need)
            sweep_stats["shadow_nodes"] += nodes
            sweep_stats["shadow_spheres"] += spheres
        else:
            verdict = _sweep_anyhit(prims, scand, sctn, (ox, oy, oz),
                                    (dx, dy, dz), tmax, need, sweep_stats)
        if blocked is not None:
            blocked.copy_(verdict)
        return verdict

    _trace_lanes(blob, meta, lsb, st, ids, n,
                 _rebuilt_intersect(mats, mtypes.long(), res), occluded,
                 k=k, n_mats=n_mats, n_light_slots=n_light_slots,
                 rr_depth=rr_depth, use_nee=use_nee, use_mis=use_mis,
                 sky_mode=sky_mode, stats=stats)
    _add_stats(stats, sweep_stats)


def shade(blob, meta, lsb, prims, mtypes, scand, sctn, st, ids, res,
          n_lanes: int, *, k: int, block: int, n_mats: int,
          n_light_slots: int, rr_depth: int, use_nee: bool, use_mis: bool,
          sky_mode: int, blocked_in_res: bool = False, tree=None) -> None:
    """K7's wrapper: ``shade_plain``'s bounce, in place, on the stream's
    device.  Without NEE, with ``tree`` (the shadow walks) or with
    ``blocked_in_res`` (the shadow verdict read from residual row 7;
    ``LAUNCHES["k7b"]`` counts these launches), ``scand`` and ``sctn`` are
    not read."""
    kw = dict(k=k, block=block, n_mats=n_mats, n_light_slots=n_light_slots,
              rr_depth=rr_depth, use_nee=use_nee, use_mis=use_mis,
              sky_mode=sky_mode, blocked_in_res=blocked_in_res, tree=tree)
    args = (blob, meta, lsb, prims, mtypes, scand, sctn, st, ids, res)
    if st.device.type == "cpu":
        return shade_plain(*args, n_lanes, **kw)
    _shade_launch("K7", args, n_lanes, None, **kw)
    LAUNCHES["k7b" if blocked_in_res else "k7" if tree is not None
             else "k7l"] += 1


def _shade_launch(name, args, n_lanes: int, blocked, *, k: int, block: int,
                  n_mats: int, n_light_slots: int, rr_depth: int,
                  use_nee: bool, use_mis: bool, sky_mode: int,
                  blocked_in_res: bool = False, tree=None,
                  store: bool = True) -> None:
    """Checks and launches K7's kernel on CUDA tensors: K7 itself with
    ``blocked`` None, K9 (which also writes the (n_lanes,) shadow verdict
    into ``blocked``) otherwise, and without ``store`` K8, which writes
    the verdicts and not the stream; with ``tree`` = (nodef, nodei) each
    shadow ray walks the tree; with ``blocked_in_res`` (K7b, K7m) the
    kernel reads each verdict from residual row 7; else it sweeps the
    shadow lists."""
    blob, meta, lsb, prims, mtypes, scand, sctn, st, ids, res = args
    if st.device.type != "cuda":
        raise NotImplementedError(f"{name} has no kernel for {st.device}")
    walk = tree is not None and not blocked_in_res
    inputs = (*args[:5], *(tree if walk else (scand, sctn)), *args[7:])
    if any(a is not None and a.device != st.device for a in inputs):
        raise ValueError(f"{name}'s inputs must lie on one device")
    _check_stream(st, ids)
    if not 0 <= n_lanes <= st.shape[1] or n_lanes % TILE:
        raise ValueError(f"{name}: {n_lanes} lanes of a stream of "
                         f"{st.shape[1]}")
    nb = prims.numel() // (_N_PRIM_ATTRS * block)
    _check(blob, "blob", torch.float32, _MAT_OFF + _MAT_STRIDE * n_mats
           + _LIGHT_STRIDE * max(n_light_slots, 1))
    _check(meta, "meta", torch.int32, 3)
    _check(lsb, "lsb", torch.float32, 6)
    _check(prims, "prims", torch.float32, _N_PRIM_ATTRS * block * nb)
    _check(mtypes, "mtypes", torch.int32, n_mats)
    _check(res, "res", torch.float32, N_RES * n_lanes)
    n_nodes = 0
    if walk:
        n_nodes = _check_tree(name, *tree)
        scand = sctn = None
    elif use_nee and n_light_slots > 0 and not blocked_in_res:
        _check_lists(scand, sctn, n_lanes // TILE, nb)
    if blocked is not None:
        _check(blocked, "blocked", torch.float32, n_lanes)
    from ._build import load_library
    lib = load_library("wavefront")
    with torch.cuda.device(st.device):
        err = lib.spt_wavefront_shade(
            *(_ptr(a) for a in (st, ids, res, blob, meta, lsb, prims,
                                mtypes, scand, sctn, blocked)),
            *((a.data_ptr() for a in tree) if walk else (0, 0)),
            st.shape[1], n_lanes, nb, block, n_mats, n_light_slots, k,
            rr_depth, int(bool(use_nee)), int(bool(use_mis)), int(sky_mode),
            int(bool(blocked_in_res)), n_nodes, int(bool(store)),
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")


# ---------------------------------------------------------------------------
# K8: the shadow verdicts of one prim shard
# ---------------------------------------------------------------------------


def shadow_verdicts_plain(blob, meta, lsb, prims, mtypes, st, ids, res,
                          n_lanes: int, *, tree, k: int, block: int,
                          n_mats: int, n_light_slots: int, rr_depth: int,
                          use_nee: bool, use_mis: bool, sky_mode: int,
                          stats: dict | None = None) -> torch.Tensor:
    """Plain version of K8 -> (n_lanes,) float32 verdicts: bounce ``k`` of
    lanes [0, n_lanes) on the winner rebuilt from ``res`` (the residual
    merged over the prim shards), each shadow ray walking ``tree`` =
    (nodef, nodei), one shard's tree over its leaf blocks ``prims``; 1
    where a traced shadow ray is blocked, 0 elsewhere.  K9's plain walk
    (``shade_plain`` with ``tree`` and ``blocked``) on a copy of the lanes
    that is thrown away, so the rays are the ones K7 traces on the same
    inputs.  ``stats`` as ``shade_plain``'s."""
    n = n_lanes
    verdict = torch.zeros(n, dtype=torch.float32, device=st.device)
    shade_plain(blob, meta, lsb, prims, mtypes, None, None,
                st[:, :n].clone(), ids[:, :n], res, n, k=k, block=block,
                n_mats=n_mats, n_light_slots=n_light_slots,
                rr_depth=rr_depth, use_nee=use_nee, use_mis=use_mis,
                sky_mode=sky_mode, stats=stats, blocked=verdict, tree=tree)
    return verdict


def shadow_verdicts(blob, meta, lsb, prims, mtypes, st, ids, res,
                    n_lanes: int, *, tree, k: int, block: int, n_mats: int,
                    n_light_slots: int, rr_depth: int, use_nee: bool,
                    use_mis: bool, sky_mode: int) -> torch.Tensor:
    """K8's wrapper: ``shadow_verdicts_plain``'s verdicts, on the stream's
    device.  The kernel is K9's (``shade_kernel``) built to keep the
    verdict and not store the path, so its shadow rays are K7b's bit for
    bit; the stream is read, not written."""
    kw = dict(k=k, block=block, n_mats=n_mats, n_light_slots=n_light_slots,
              rr_depth=rr_depth, use_nee=use_nee, use_mis=use_mis,
              sky_mode=sky_mode)
    if st.device.type == "cpu":
        return shadow_verdicts_plain(blob, meta, lsb, prims, mtypes, st, ids,
                                     res, n_lanes, tree=tree, **kw)
    verdict = torch.empty(n_lanes, dtype=torch.float32, device=st.device)
    _shade_launch("K8", (blob, meta, lsb, prims, mtypes, None, None, st, ids,
                         res), n_lanes, verdict, tree=tree, store=False, **kw)
    LAUNCHES["k8"] += 1
    return verdict


N_SRAY = 8           # K8l's shadow rays: pox poy poz ldx ldy ldz tmax need


def anyhit_plain(prims: torch.Tensor, scand: torch.Tensor, sctn: torch.Tensor,
                 sray: torch.Tensor, n_lanes: int, *, block: int,
                 stats: dict | None = None) -> torch.Tensor:
    """Plain version of K8's list form (K8l) -> (R,) float32 verdicts of
    the shadow rays ``sray`` (8, R) against the leaf blocks ``prims``: for
    lanes [0, n_lanes) with ``need`` (row 7 above 0.5), K7's shadow sweep
    of their tiles' lists (``_sweep_anyhit``), 1 where the ray is blocked;
    0 on the other lanes and past ``n_lanes``.  ``stats``, if given, gets
    ``"shadow"`` (the lanes swept) and the sweep's counts added."""
    LAUNCHES["plain"] += 1
    n = n_lanes
    need = sray[7, :n] > 0.5
    verdict = _sweep_anyhit(prims.reshape(-1, _N_PRIM_ATTRS, block), scand,
                            sctn, tuple(sray[a, :n] for a in range(3)),
                            tuple(sray[a, :n] for a in range(3, 6)),
                            sray[6, :n], need, stats)
    if stats is not None:
        stats["shadow"] = stats.get("shadow", 0) + int(need.sum())
    out = torch.zeros(sray.shape[1], dtype=torch.float32, device=sray.device)
    out[:n] = verdict.to(torch.float32)
    return out


def anyhit(prims: torch.Tensor, scand: torch.Tensor, sctn: torch.Tensor,
           sray: torch.Tensor, n_lanes: int, *, block: int) -> torch.Tensor:
    """K8l's wrapper: ``anyhit_plain``'s verdicts, on the rays' device."""
    if sray.device.type == "cpu":
        return anyhit_plain(prims, scand, sctn, sray, n_lanes, block=block)
    if sray.device.type != "cuda":
        raise NotImplementedError(f"K8l has no kernel for {sray.device}")
    if any(a.device != sray.device for a in (prims, scand, sctn)):
        raise ValueError("K8l's inputs must lie on one device")
    r = sray.shape[1] if sray.dim() == 2 else -1
    if sray.dtype != torch.float32 or sray.dim() != 2 \
            or sray.shape[0] != N_SRAY or not sray.is_contiguous() \
            or r % TILE:
        raise ValueError(f"sray: want a contiguous (8, R) float32 tensor, R "
                         f"a multiple of {TILE}; got {sray.dtype} "
                         f"{tuple(sray.shape)}")
    if not 0 <= n_lanes <= r or n_lanes % TILE:
        raise ValueError(f"K8l: {n_lanes} lanes of {r} shadow rays")
    nb = prims.numel() // (_N_PRIM_ATTRS * block)
    _check(prims, "prims", torch.float32, _N_PRIM_ATTRS * block * nb)
    _check_lists(scand, sctn, n_lanes // TILE, nb)
    out = torch.empty(r, dtype=torch.float32, device=sray.device)
    from ._build import load_library
    lib = load_library("wavefront")
    with torch.cuda.device(sray.device):
        err = lib.spt_wavefront_anyhit(
            out.data_ptr(), sray.data_ptr(), prims.data_ptr(),
            scand.data_ptr(), sctn.data_ptr(), r, n_lanes, nb, block,
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"K8l launch failed: CUDA error {err}")
    LAUNCHES["k8l"] += 1
    return out


# ---------------------------------------------------------------------------
# K6m and K7m: the matmul-form sweeps
# ---------------------------------------------------------------------------


def build_cmat(prims: torch.Tensor):
    """K6m's and K7m's per-block tables (the JAX package's ``build_cmat``)
    -> (cmat (n_blocks, 8, 2 block), bctr (n_blocks, 3)).  ``bctr`` is the
    centre of the box of a block's filled slots' centres (0 for a block
    with none); with c' = c - bctr, column j < block of ``cmat`` is (c'x,
    c'y, c'z, 0, 0, 0, 0, 0) and column block + j is (0, 0, 0, 0, -2 c'x,
    -2 c'y, -2 c'z, |c'|^2 - r^2); a padding slot's columns are 0 but the
    last, 3e38, so its discriminant is always negative.  Computed from
    ``prims`` alone: the only state the matmul form adds."""
    valid = prims[:, 4, :] >= 0.0
    c = prims[:, 0:3, :]
    r = prims[:, 3, :]
    lo = torch.where(valid[:, None, :], c, 3e38).amin(dim=2)
    hi = torch.where(valid[:, None, :], c, -3e38).amax(dim=2)
    ctr = torch.where(valid.any(dim=1)[:, None], 0.5 * (lo + hi), 0.0)
    cp = torch.where(valid[:, None, :], c - ctr[:, :, None], 0.0)
    c2r2 = torch.where(valid, cp[:, 0] * cp[:, 0] + cp[:, 1] * cp[:, 1]
                       + cp[:, 2] * cp[:, 2] - r * r, 3e38)
    zero = torch.zeros_like(cp[:, :1])
    top = torch.cat([cp, zero, zero, zero, zero, zero], dim=1)
    bot = torch.cat([zero, zero, zero, zero, -2.0 * cp, c2r2[:, None, :]],
                    dim=1)
    return torch.cat([top, bot], dim=2).contiguous(), ctr.contiguous()


def slot_major(cmat: torch.Tensor) -> torch.Tensor:
    """K6m's and K7m's copy of ``build_cmat``'s tables, (n_blocks, 2 block,
    8): slot column c of block b at row (b, c), its 8 floats adjacent, so
    the kernels read a column in two 16-byte loads.  The same floats."""
    return cmat.transpose(1, 2).contiguous()


def mxu_tables(t: dict, block: int):
    """(bctr, cslot) of the packed leaf blocks ``t["prims"]``: the centres
    and the ``slot_major`` copy of ``build_cmat``'s tables, which K6m and
    K7m read (``_cmat_of`` gives back ``build_cmat``'s layout), built on
    first use and kept in the packing's tensors ``t`` (``packed``'s,
    cached by the scene's content)."""
    if "cslot" not in t:
        cmat, bctr = build_cmat(t["prims"].reshape(-1, _N_PRIM_ATTRS, block))
        t.update(bctr=bctr, cslot=slot_major(cmat))
    return t["bctr"], t["cslot"]


def _expanded_quadratic(cm, ctr, o, d):
    """(b, cterm) (m, block) of m lanes against their blocks' slots in the
    expanded, block-centred form (the JAX package's ``_row_quadratic``):
    with o' = o - ctr and A = (dx, dy, dz, 0, o'x, o'y, o'z, 1), column j
    of ``cm`` (m, 8, 2 block) dotted with A, its 8 products summed in order,
    gives b + d.o' (j < block) and cterm - |o'|^2 (j >= block).  Spelled
    out elementwise in the kernels' order, so K6m and K7m can equal it bit
    for bit."""
    op = tuple(a - ctr[:, i] for i, a in enumerate(o))
    zero, one = torch.zeros_like(op[0]), torch.ones_like(op[0])
    acc = None
    for a, v in enumerate((*d, zero, *op, one)):
        term = cm[:, a, :] * v[:, None]
        acc = term if acc is None else acc + term
    dor = d[0] * op[0] + d[1] * op[1] + d[2] * op[2]
    o2 = op[0] * op[0] + op[1] * op[1] + op[2] * op[2]
    block = cm.shape[2] // 2
    return acc[:, :block] - dor[:, None], acc[:, block:] + o2[:, None]


def _expanded_test(cmat, bctr, o, d):
    """K6m's sphere tests: ``_compact_test``'s contract on the expanded
    quadratic (the root choice and the TMIN test as K6's)."""
    def test(idx, blk):
        b, cterm = _expanded_quadratic(cmat[blk], bctr[blk],
                                       tuple(a[idx] for a in o),
                                       tuple(a[idx] for a in d))
        disc = b * b - cterm
        pos = disc > 0.0
        sq = torch.sqrt(physics._max(torch.where(pos, disc, 1.0), 1e-12))
        t0 = b - sq
        tj = torch.where(t0 > TMIN, t0, b + sq)
        return tj, pos & (tj > TMIN)
    return test


def _seg_blocked(b, cterm, tmax):
    """K7m's any-hit test without a square root (the JAX package's
    ``_seg_blocked``, strict inequalities as written there): whether the
    root ``trace_bounce`` would take, t0 = b - sqrt(disc) if it passes
    TMIN else t1 = b + sqrt(disc), lies in (TMIN, tmax)."""
    disc = b * b - cterm
    pos = disc > 0.0
    p = b - TMIN
    q = b - tmax
    pp = p * p
    qq = q * q
    t0_gt = (p > 0.0) & (disc < pp)
    t0_lt = (q < 0.0) | (disc > qq)
    t1_ok = ((p > 0.0) | (disc > pp)) & ((q < 0.0) & (disc < qq))
    return pos & ((t0_gt & t0_lt) | (~t0_gt & t1_ok))


def _cmat_of(cslot: torch.Tensor, block: int) -> torch.Tensor:
    """``build_cmat``'s (n_blocks, 8, 2 block) layout of its ``slot_major``
    copy: the same floats, a view."""
    return cslot.reshape(-1, 2 * block, 8).transpose(1, 2)


def isect_mxu_plain(prims: torch.Tensor, cslot: torch.Tensor,
                    bctr: torch.Tensor, cand: torch.Tensor, ctn: torch.Tensor,
                    st: torch.Tensor, n_lanes: int, *, block: int,
                    boxes: torch.Tensor | None = None,
                    stats: dict | None = None,
                    tcull: bool = True) -> torch.Tensor:
    """Plain version of K6m -> K6's residual (8, n_lanes): ``isect_plain``
    over each lane's row list (``precull_tiles(per_row=True)``), a slot's
    distance by the expanded quadratic on ``build_cmat``'s tables (read
    back from their slot-major copy ``cslot``, ``mxu_tables``'); the
    winner's attributes read from ``prims``.  With ``boxes``
    (``leaf_boxes``, the render's) a lane skips each candidate whose box
    its ray misses or enters at or past its nearest distance so far
    (``_box_cull``, K11's cull), without them it sweeps every candidate it
    takes.  ``stats`` as K6's, with ``boxes`` also ``_nearest_sweep``'s
    ``"culled_blocks"`` and ``"culled_spheres"``.  ``tcull`` False: no
    stop by the bounds, and the box test without its t limit
    (``_nearest_sweep``)."""
    LAUNCHES["plain"] += 1
    n = n_lanes
    o = tuple(st[c, :n] for c in (C_OX, C_OY, C_OZ))
    d = tuple(st[c, :n] for c in (C_DX, C_DY, C_DZ))
    return _isect_lanes(_expanded_test(_cmat_of(cslot, block),
                                       bctr.reshape(-1, 3), o, d),
                        prims, cand, ctn, st, n, block, ROW, stats,
                        None if boxes is None else _box_cull(boxes, o, d),
                        tcull)[1]


def isect_mxu(prims: torch.Tensor, cslot: torch.Tensor, bctr: torch.Tensor,
              cand: torch.Tensor, ctn: torch.Tensor, st: torch.Tensor,
              n_lanes: int, *, block: int,
              boxes: torch.Tensor | None = None,
              tcull: bool = True) -> torch.Tensor:
    """K6m's wrapper: ``isect_mxu_plain``'s residual on the stream's
    device (``tcull`` as there).  On the card it needs the leaf blocks'
    ``boxes``: its sweep always culls by them."""
    if st.device.type == "cpu":
        return isect_mxu_plain(prims, cslot, bctr, cand, ctn, st, n_lanes,
                               block=block, boxes=boxes, tcull=tcull)
    if boxes is None:
        raise ValueError("K6m's sweep culls by the leaf blocks' boxes: give "
                         "boxes")
    return _isect_launch("K6m", prims, cand, ctn, st, n_lanes, block,
                         (cslot, bctr, boxes), None, tcull)


def mxu_verdicts_plain(prims, cslot, bctr, scand, sctn, sray, out,
                       n_lanes: int, *, block: int,
                       stats: dict | None = None) -> None:
    """Plain version of K7m's verdict pass: ``out[:n_lanes]`` (float32)
    gets 1 where the shadow ray ``sray`` (8, R; ``shadow_rays``' pox poy
    poz ldx ldy ldz tmax need) of a lane that needs one is blocked, by
    K7m's sweep of its row's shadow list (``_sweep_anyhit`` with ``mxu=``
    on ``build_cmat``'s layout, read back from its ``slot_major`` copy
    ``cslot``); 0 elsewhere.  ``stats`` as ``_sweep_anyhit``'s."""
    LAUNCHES["plain"] += 1
    n = n_lanes
    out[:n] = _sweep_anyhit(
        prims.reshape(-1, _N_PRIM_ATTRS, block), scand, sctn,
        tuple(sray[a, :n] for a in range(3)),
        tuple(sray[a, :n] for a in range(3, 6)), sray[6, :n],
        sray[7, :n] > 0.5, stats, (_cmat_of(cslot, block),
                                   bctr.reshape(-1, 3)))


def mxu_verdicts(prims, cslot, bctr, scand, sctn, sray, out, n_lanes: int,
                 *, block: int) -> None:
    """K7m's verdict pass's wrapper: ``mxu_verdicts_plain``'s verdicts into
    ``out`` on the rays' device, the kernel reading the tables'
    ``slot_major`` copy ``cslot`` (``mxu_tables``');
    ``LAUNCHES["k7mv"]`` counts its launches."""
    if sray.device.type == "cpu":
        return mxu_verdicts_plain(prims, cslot, bctr, scand, sctn, sray, out,
                                  n_lanes, block=block)
    if sray.device.type != "cuda":
        raise NotImplementedError(f"K7m's verdict pass has no kernel for "
                                  f"{sray.device}")
    if any(a.device != sray.device for a in (cslot, bctr, scand, sctn, out)):
        raise ValueError("K7m's verdict pass: inputs on one device")
    nb = bctr.numel() // 3
    if not 0 <= n_lanes <= sray.shape[-1] or n_lanes % TILE:
        raise ValueError(f"K7m's verdict pass: {n_lanes} lanes")
    _check(sray, "sray", torch.float32, N_SRAY * n_lanes)
    _check(cslot, "cslot", torch.float32, nb * 16 * block)
    _check(bctr, "bctr", torch.float32, nb * 3)
    _check_lists(scand, sctn, n_lanes // ROW, nb)
    if (out.dtype != torch.float32 or not out.is_contiguous()
            or out.numel() < n_lanes):
        raise ValueError(f"K7m's verdict pass: out must be contiguous "
                         f"float32 of at least {n_lanes}")
    from ._build import load_library
    lib = load_library("wavefront")
    with torch.cuda.device(sray.device):
        err = lib.spt_wavefront_mxu_verdicts(
            out.data_ptr(), sray.data_ptr(), cslot.data_ptr(),
            bctr.data_ptr(), scand.data_ptr(), sctn.data_ptr(), n_lanes, nb,
            block, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"K7m's verdict pass failed: CUDA error {err}")
    LAUNCHES["k7mv"] += 1


def shade_mxu_plain(blob, meta, lsb, prims, cslot, bctr, mtypes, scand, sctn,
                    st, ids, res, n_lanes: int, *, sray,
                    stats: dict | None = None, **kw) -> None:
    """Plain version of K7m: its verdict pass, then K7b's bounce.  Each
    lane's shadow ray ``sray`` (8, R: ``shadow_rays``' stacked, the rays
    the row lists ``scand``, ``sctn`` were culled for; None without NEE)
    is swept over its row's list in the expanded form
    (``mxu_verdicts_plain`` on ``mxu_tables``' ``cslot``, ``bctr``) into
    residual row 7, which ``shade_plain``'s bounce reads
    (``blocked_in_res``): the bounce traces the same rays, so this is the
    bounce with K7m's sweep in it.  ``stats`` as ``shade_plain``'s, the
    shadow sweep's counts the pass's."""
    n = n_lanes
    sweep = {}
    if sray is not None:
        mxu_verdicts_plain(prims, cslot, bctr, scand, sctn, sray, res[7], n,
                           block=kw["block"], stats=sweep)
    elif kw["use_nee"] and kw["n_light_slots"] > 0:
        raise ValueError("K7m traces shadow rays: give their sray")
    shade_plain(blob, meta, lsb, prims, mtypes, None, None, st, ids, res, n,
                blocked_in_res=True, stats=stats, **kw)
    if stats is not None:
        stats.update(sweep)


def shade_mxu(blob, meta, lsb, prims, cslot, bctr, mtypes, scand, sctn, st,
              ids, res, n_lanes: int, *, sray, **kw) -> None:
    """K7m's wrapper: ``shade_mxu_plain``'s bounce, in place, on the
    stream's device: the verdict pass (``mxu_verdicts``) writes residual
    row 7, then K7b's kernel runs the bounce on it (``LAUNCHES["k7m"]``
    counts these)."""
    if st.device.type == "cpu":
        return shade_mxu_plain(blob, meta, lsb, prims, cslot, bctr, mtypes,
                               scand, sctn, st, ids, res, n_lanes, sray=sray,
                               **kw)
    if sray is not None:
        mxu_verdicts(prims, cslot, bctr, scand, sctn, sray, res[7], n_lanes,
                     block=kw["block"])
    elif kw["use_nee"] and kw["n_light_slots"] > 0:
        raise ValueError("K7m traces shadow rays: give their sray")
    _shade_launch("K7m", (blob, meta, lsb, prims, mtypes, None, None, st, ids,
                          res), n_lanes, None, blocked_in_res=True, **kw)
    LAUNCHES["k7m"] += 1


# ---------------------------------------------------------------------------
# K11: the fused bounce
# ---------------------------------------------------------------------------


def _fused_intersect(mats, mtypes, t, res):
    """``trace_bounce``'s intersector for K11's plain version: the winner
    found before the bounce (``t``, K6's residual ``res``), resolved as the
    JAX package's fused bounce resolves it (``_make_intersectors``' loop
    over the material table): a padding slot (id -1) is a hit with no
    material, black, ior 1.5, none of the three types."""
    def intersect(*_ray):
        found = t < BIG
        mid = res[4].long()
        own = found & (mid >= 0)
        m = torch.clamp_min(mid, 0)
        h = dict(cx=res[0], cy=res[1], cz=res[2], r=res[3])
        for a, key in enumerate(("ar", "ag", "ab", "er", "eg", "eb", "rough",
                                 "ior")):
            h[key] = torch.where(own, mats[m, a], 1.5 if key == "ior"
                                 else 0.0)
        mt = mtypes[m]
        return (t, h, own & (mt == LAMBERT), own & (mt == METAL),
                own & (mt == DIELECTRIC))
    return intersect


def bounce_plain(blob, meta, lsb, nodef, nodei, prims, mtypes, cand, ctn, st,
                 ids, n_lanes: int, *, k: int, block: int, n_mats: int,
                 n_light_slots: int, rr_depth: int, use_nee: bool,
                 use_mis: bool, sky_mode: int, precull: bool,
                 boxes: torch.Tensor | None = None,
                 stats: dict | None = None,
                 record: torch.Tensor | None = None,
                 tcull: bool = True) -> None:
    """Plain version of K11: bounce ``k`` of lanes [0, n_lanes) of the
    stream, in place, in one step.  The nearest hit by K6's sweep of the
    tiles' lists ``cand``, ``ctn`` when ``precull``, else by K3's walk of
    the tree (``megakernel_bvh._Walk``: each lane its own octant table);
    with ``boxes`` (``leaf_boxes``, the render's) the sweep skips each
    candidate whose box the lane's ray misses or enters at or past its
    nearest distance so far (``_box_cull``), without them it tests every
    candidate it takes, as K6's list mode does; ``tcull`` False sweeps
    the whole list, the box test without its t limit (``_nearest_sweep``).
    ``trace_bounce`` on it, a
    padding winner resolved as ``_fused_intersect`` says; each shadow ray
    walks the tree and stops at its first blocker.  Dead lanes keep their
    state; the miss flag as K7's.  ``record``, if given, (8, n_lanes)
    float32, receives K11g's residual: K6's winner record and, in row 7,
    the shadow verdict (1 where a traced shadow ray is blocked).
    ``stats``, if given, gets K7's per-bounce counts, the nearest hit's
    (K6's sweep counts, with ``boxes`` also the candidates culled:
    ``_nearest_sweep``'s; or ``"nodes"`` and ``"spheres"`` of the walk)
    and the shadow walks' ``"shadow_nodes"`` and ``"shadow_spheres"``
    added."""
    LAUNCHES["plain"] += 1
    n = n_lanes
    prims = prims.reshape(-1, _N_PRIM_ATTRS, block)
    mats = blob[_MAT_OFF:_MAT_OFF + _MAT_STRIDE * n_mats].reshape(
        n_mats, _MAT_STRIDE)
    walk = _tree_walk((nodef, nodei), prims, block)
    o = tuple(st[c, :n] for c in (C_OX, C_OY, C_OZ))
    d = tuple(st[c, :n] for c in (C_DX, C_DY, C_DZ))
    work = {}
    if precull:
        t, res = _isect_lanes(
            _compact_test(prims, o, d), prims, cand, ctn, st, n, block, TILE,
            work, None if boxes is None else _box_cull(boxes, o, d), tcull)
    else:
        t, res = _walk_lanes(walk, st, n, block, work)
    work.update(shadow_nodes=0, shadow_spheres=0)

    def occluded(ox, oy, oz, dx, dy, dz, tmax, need):
        verdict, nodes, spheres = walk.anyhit((ox, oy, oz), (dx, dy, dz),
                                              tmax, need)
        work["shadow_nodes"] += nodes
        work["shadow_spheres"] += spheres
        res[7] = verdict.to(torch.float32)
        return verdict

    _trace_lanes(blob, meta, lsb, st, ids, n,
                 _fused_intersect(mats, mtypes.long(), t, res), occluded,
                 k=k, n_mats=n_mats, n_light_slots=n_light_slots,
                 rr_depth=rr_depth, use_nee=use_nee, use_mis=use_mis,
                 sky_mode=sky_mode, stats=stats)
    _add_stats(stats, work)
    if record is not None:
        record.copy_(res)


def bounce(blob, meta, lsb, nodef, nodei, prims, mtypes, cand, ctn, st, ids,
           n_lanes: int, **kw) -> None:
    """K11's wrapper: ``bounce_plain``'s bounce, in place, on the stream's
    device.  On the card ``precull`` needs the ``boxes`` (its list sweep
    always culls by them); without ``precull``, ``cand``, ``ctn`` and
    ``boxes`` are not read."""
    if st.device.type == "cpu":
        return bounce_plain(blob, meta, lsb, nodef, nodei, prims, mtypes,
                            cand, ctn, st, ids, n_lanes, **kw)
    _bounce_launch("K11", (blob, meta, lsb, nodef, nodei, prims, mtypes,
                           cand, ctn, st, ids), n_lanes, None, **kw)
    LAUNCHES["k11"] += 1


def _bounce_launch(name, args, n_lanes: int, record, *, k: int, block: int,
                   n_mats: int, n_light_slots: int, rr_depth: int,
                   use_nee: bool, use_mis: bool, sky_mode: int,
                   precull: bool, boxes: torch.Tensor | None = None,
                   tcull: bool = True) -> None:
    """Checks and launches K11's kernel on CUDA tensors: K11 with
    ``record`` None, K11g (which also writes the (8, n_lanes) residual into
    ``record``) otherwise; with ``precull`` its list sweep culls by the
    leaf blocks' ``boxes``, which it then needs (``tcull`` False: the
    sweep without its t exits)."""
    blob, meta, lsb, nodef, nodei, prims, mtypes, cand, ctn, st, ids = args
    if st.device.type != "cuda":
        raise NotImplementedError(f"{name} has no kernel for {st.device}")
    if not precull:
        boxes = None
    elif boxes is None:
        raise ValueError(f"{name}'s list sweep culls by the leaf blocks' "
                         f"boxes: give boxes")
    if any(a.device != st.device for a in args) or (
            boxes is not None and boxes.device != st.device):
        raise ValueError(f"{name}'s inputs must lie on one device")
    _check_stream(st, ids)
    if not 0 <= n_lanes <= st.shape[1] or n_lanes % TILE:
        raise ValueError(f"{name}: {n_lanes} lanes of a stream of "
                         f"{st.shape[1]}")
    nb = prims.numel() // (_N_PRIM_ATTRS * block)
    _check(blob, "blob", torch.float32, _MAT_OFF + _MAT_STRIDE * n_mats
           + _LIGHT_STRIDE * max(n_light_slots, 1))
    _check(meta, "meta", torch.int32, 3)
    _check(lsb, "lsb", torch.float32, 6)
    n_nodes = _check_tree(name, nodef, nodei)
    _check(prims, "prims", torch.float32, _N_PRIM_ATTRS * block * nb)
    _check(mtypes, "mtypes", torch.int32, n_mats)
    if precull:
        _check_lists(cand, ctn, n_lanes // TILE, nb)
        _check(boxes, "boxes", torch.float32, 8 * nb)
    if record is not None:
        _check(record, "record", torch.float32, N_RES * n_lanes)
    from ._build import load_library
    lib = load_library("wavefront")
    with torch.cuda.device(st.device):
        err = lib.spt_wavefront_bounce(
            *(a.data_ptr() for a in (st, ids, blob, meta, lsb, nodef, nodei,
                                     prims, mtypes, cand, ctn)),
            _ptr(boxes), _ptr(record),
            st.shape[1], n_lanes, n_nodes, nb, block, n_mats, n_light_slots,
            k, rr_depth, int(bool(use_nee)), int(bool(use_mis)),
            int(sky_mode), int(bool(precull)), int(bool(tcull)),
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")


# ---------------------------------------------------------------------------
# Glue: environment map and image
# ---------------------------------------------------------------------------


def sample_env_map(env: torch.Tensor, dx, dy, dz):
    """Bilinear lookup of an equirectangular (He, We, 3) map in direction
    (dx, dy, dz) -> (r, g, b): the JAX package's
    ``integrator_jax.sample_env_map_soa``, its division by pi rounded once
    (a 0-d tensor divisor, as ``physics._div``)."""
    he, we = env.shape[0], env.shape[1]
    flat = env.reshape(he * we, 3)
    u = (torch.atan2(dx, dz) * _f32(0.5 / math.pi) + 0.5) * we - 0.5
    v = physics._div(torch.arccos(torch.clamp(dy, -1.0, 1.0)), math.pi) \
        * he - 0.5
    v = torch.clamp(v, 0.0, he - 1.0)
    u0, v0 = torch.floor(u), torch.floor(v)
    fu, fv = u - u0, v - v0
    u0i = torch.remainder(u0.to(torch.int32), we)
    u1i = torch.remainder(u0i + 1, we)
    v0i = torch.clamp(v0.to(torch.int32), 0, he - 1)
    v1i = torch.clamp(v0i + 1, 0, he - 1)
    idx = [(a * we + b).long() for a, b in ((v0i, u0i), (v0i, u1i),
                                            (v1i, u0i), (v1i, u1i))]
    out = []
    for c in range(3):
        tab = flat[:, c]
        c00, c01, c10, c11 = (tab[i] for i in idx)
        out.append((c00 * (1 - fu) + c01 * fu) * (1 - fv)
                   + (c10 * (1 - fu) + c11 * fu) * fv)
    return tuple(out)


def _add_env_radiance(st: torch.Tensor, env: torch.Tensor) -> None:
    """Radiance += throughput * env(direction) on the lanes whose miss flag
    is set, which is then cleared; in place.  A lane that missed still
    holds the direction and throughput it missed with."""
    miss = st[C_MISS] > 0.5
    rgb = sample_env_map(env, st[C_DX], st[C_DY], st[C_DZ])
    for c, th, e in zip((C_LR, C_LG, C_LB), (C_TR, C_TG, C_TB), rgb):
        st[c] += torch.where(miss, st[th] * e, 0.0)
    st[C_MISS] = 0.0


def _scatter_image(st, ids, width: int, height: int,
                   row_offset: int = 0) -> torch.Tensor:
    """(H, W, 3) sum of the stream's radiance by pixel id, less the band's
    first id (``row_offset * width``); lanes off the image add into a
    discard slot."""
    idx = torch.where(st[C_INIMG] > 0.5, ids[0].long() - row_offset * width,
                      width * height)
    rad = torch.stack([st[C_LR], st[C_LG], st[C_LB]], dim=-1)
    img = torch.zeros((width * height + 1, 3), dtype=torch.float32,
                      device=st.device).index_add_(0, idx, rad)
    return img[:width * height].reshape(height, width, 3)


# ---------------------------------------------------------------------------
# The render
# ---------------------------------------------------------------------------


def _launch_wavefront(t: dict, static: dict, env, meta, *, width: int,
                      height: int, chunk_spp: int, max_bounces: int,
                      rr_depth: int, use_nee: bool, use_mis: bool,
                      sky_mode: int, dof: bool, compact: bool,
                      sort_min_rays: int, split: bool, precull: bool,
                      mxu: bool, stages: tuple, times: dict | None,
                      alive: list | None = None, row_offset: int = 0,
                      full_height: int | None = None, sort_every: int = 1,
                      qbits: int = Q_BITS, dir_major: bool = True,
                      dbits: int = D_BITS, rowsort: bool = False,
                      tcull: bool = True) -> torch.Tensor:
    """One chunk of ``chunk_spp`` images -> (H, W, 3) radiance sum (of the
    band from row ``row_offset`` of a ``full_height``-row image).  The
    split bounce walks the tree (K6's tree mode, K7's shadow walks) and
    builds no lists; the lists are built for ``mxu`` and for the fused
    bounce with ``precull``.  ``alive[k]``, if given, gains the lanes alive
    when bounce k starts.  The knobs as ``render_wavefront``'s."""
    k5, k6, k7, k11, k6m, k7m = stages
    block, n_mats = static["block"], static["n_mats"]
    n_light_slots = static["n_light_slots"]
    blob, prims = t["blob"], t["prims"]
    tree = (t["nodef"], t["nodei"])
    clock = functools.partial(_timed, times, device=blob.device)
    with clock("raygen"):
        st, ids = k5(blob, meta, width=width, height=height,
                     chunk_spp=chunk_spp, dof=dof, row_offset=row_offset,
                     full_height=full_height)
    buf = _stream_buffer(st, ids)
    n_tiles = st.shape[1] // TILE - 1
    lo, ext = _scene_sort_bounds(t["nodef"])
    mxu = mxu and split
    lists = mxu or (precull and not split)
    boxes = None
    if lists:
        lob, hib = _leaf_block_bounds(prims.reshape(-1, _N_PRIM_ATTRS, block))
        boxes = leaf_boxes(lob, hib)
    if mxu:
        bctr, cslot = mxu_tables(t, block)
    nl = int(_np(meta[2]))
    seed = int(_np(meta[1])) & rng.MASK32
    shadows = use_nee and n_light_slots > 0
    none_i = torch.zeros((1, 1, 1), dtype=torch.int32, device=blob.device)
    none_f = torch.zeros((1, 1, 1), dtype=torch.float32, device=blob.device)
    kw = dict(block=block, n_mats=n_mats, n_light_slots=n_light_slots,
              rr_depth=rr_depth, use_nee=use_nee, use_mis=use_mis,
              sky_mode=sky_mode)
    nalive = n_tiles
    for k in range(max_bounces):
        lanes = _sort_span(k, nalive, n_tiles, sort_min_rays, compact,
                           sort_every, rowsort)
        if lanes is not None:
            with clock("sort"):
                na = _sort_rays(buf, lanes, lo, ext, qbits, dir_major, dbits,
                                rowsort)
            if compact:
                nalive = na
        if nalive == 0:
            break
        n = nalive * TILE
        if alive is not None:
            alive[k] += int((st[C_ALIVE, :n] > 0.5).sum())
        cand, ctn = none_i, none_f
        if lists:
            with clock("precull"):
                cand, ctn = precull_tiles(
                    tuple(st[c, :n] for c in (C_OX, C_OY, C_OZ)),
                    tuple(st[c, :n] for c in (C_DX, C_DY, C_DZ)),
                    st[C_ALIVE, :n], None, lob, hib, per_row=mxu)
        if not split:
            with clock("k11"):
                k11(blob, meta, t["lsb"], t["nodef"], t["nodei"], prims,
                    t["mtypes"], cand, ctn, st, ids, n, k=k,
                    precull=precull, boxes=boxes, tcull=tcull, **kw)
        elif mxu:
            with clock("k6m"):
                res = k6m(prims, cslot, bctr, cand, ctn, st, n,
                          block=block, boxes=boxes, tcull=tcull)
            scand, sctn = none_i, none_f
            if shadows:
                with clock("shadow"):
                    so3, sd3, stmax, sneed = shadow_rays(
                        st[:, :n], ids[:, :n], res, blob, t["lsb"], nl, k=k,
                        seed=seed, n_mats=n_mats, mtypes=static["mtypes"],
                        n_light_slots=n_light_slots)
                    scand, sctn = precull_tiles(so3, sd3, sneed, stmax, lob,
                                                hib, per_row=True)
                    sray = torch.stack([*so3, *sd3, stmax, sneed])
            with clock("k7m"):
                k7m(blob, meta, t["lsb"], prims, cslot, bctr, t["mtypes"],
                    scand, sctn, st, ids, res, n, k=k,
                    sray=sray if shadows else None, **kw)
        else:
            with clock("k6"):
                res = k6(prims, None, None, st, n, block=block, tree=tree)
            with clock("k7"):
                k7(blob, meta, t["lsb"], prims, t["mtypes"], None, None, st,
                   ids, res, n, k=k, tree=tree, **kw)
        if sky_mode == SKY_ENVMAP:
            with clock("env"):
                _add_env_radiance(st[:, :n], env)
    with clock("scatter"):
        return _scatter_image(st, ids, width, height, row_offset)


def band_chunk_spp(width: int, height: int, spp: int, chunk_rays: int,
                   row_offset: int = 0, full_height: int | None = None) -> int:
    """The samples a chunk of the render holds: as many whole images of
    the full image's stream (``full_height`` rows) as ``chunk_rays``
    holds, so a band groups each pixel's samples into the chunks the
    unsharded render groups them into.  On the card the scatter adds a
    chunk's lanes by atomics, in no fixed order: with at most two samples
    of a pixel in a chunk, 0 + a + b is the same float either way, and the
    band's pixels equal the full render's bit for bit."""
    full = band_height(height, row_offset, full_height)
    rays_per_img = stream_tiles(width, full, 1)[2] * TILE
    return max(1, min(spp, chunk_rays // rays_per_img))


@contextlib.contextmanager
def _timed(times, stage: str, device):
    """Adds the stage's CUDA-event time (ms) to ``times[stage]`` when
    ``times`` is given and the stream lies on the card."""
    if times is None or device.type != "cuda":
        yield
        return
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    yield
    end.record()
    end.synchronize()
    times.setdefault(stage, []).append(start.elapsed_time(end))


def render_wavefront(scene: SceneData, camera, width: int, height: int,
                     start_sample: int, spp: int, *, max_bounces=8,
                     rr_depth=3, use_nee=True, use_mis=True, seed=0,
                     dof=None, block: int = BLOCK, compact: bool = True,
                     precull: bool = True, split: bool = True,
                     mxu: bool = False, sort_min_rays: int = 1 << 17,
                     chunk_rays: int = 4 << 20,
                     alive: list | None = None, row_offset: int = 0,
                     full_height: int | None = None, sort_every: int = 1,
                     qbits: int = Q_BITS, dir_major: bool = True,
                     dbits: int = D_BITS, rowsort: bool = False,
                     tcull: bool = True) -> torch.Tensor:
    """Render ``spp`` samples with the sorted wavefront; returns the (H, W,
    3) radiance sum.  With ``row_offset`` and ``full_height``: that of the
    band of ``height`` rows from row ``row_offset`` of a
    ``full_height``-row image (K5 keys each lane on its global pixel id).

    Runs on the scene's device: the kernels for a scene on the card, their
    plain versions for a scene on the CPU.  The stream holds at most
    ``chunk_rays`` rays: samples go in chunks of as many whole images (of
    the full image, for a band: ``band_chunk_spp``).  A
    sort runs before bounces 1.. while more than ``sort_min_rays`` rays
    were alive; ``compact=False`` keeps every lane in every launch and
    sorts the whole stream (for tests).  ``dof=None`` takes the thin lens
    iff the camera has an aperture.

    Each bounce is split by default: K6 intersects, K7 shades, each ray's
    nearest hit and shadow ray walking the tree.  ``split=False`` runs it
    as one kernel, K11, whose shadow rays walk the tree too; there
    ``precull=False`` finds the nearest hit by the walk, where ``precull``
    (the default) sweeps the tiles' candidate lists (JAX's form).
    ``mxu=True`` runs the split bounce's sweeps in their matmul form, K6m
    and K7m, over per-row lists.  As in the JAX package, ``precull`` acts
    on the fused bounce only and ``mxu`` on the split bounce only.  Either
    way the image is the same but at knife edges: the walk and the lists
    find the same winners but where two spheres tie exactly in t; the
    fused bounce equals the split one bit for bit where no ray wins a
    leaf's padding slot (the fused bounce shades such a winner, the split
    one takes the sky); the matmul form rounds otherwise.

    ``alive``, if given (a list), is set to ``max_bounces`` counts: the
    lanes alive when each bounce starts, summed over the chunks (one host
    read a bounce; ``utils.profiling.measure_occupancy`` reads them).

    The JAX package's A/B knobs, at its defaults off the TPU; none changes
    the image (a permutation of the stream, or a sweep's stopping rule):
    ``sort_every`` sorts before bounces 1, 1 + sort_every, ... (0: never;
    the alive prefix then stays the whole stream); ``qbits`` origin bits
    an axis of the key; ``dir_major`` puts the octant, and ``dbits``
    direction bits an axis, above the origin's morton code (else the
    morton code above the octant, ``dbits`` unused); ``rowsort`` permutes
    whole 128-lane rows by their least key (no prefix sorts then).
    ``tcull=False`` sweeps every candidate of a list, and the per-ray box
    test keeps its miss test but not its t limit: it acts where lists are
    swept, the fused bounce with ``precull`` (K11) and ``mxu`` (K6m); the
    split bounce walks the tree, as the ``precull`` and ``mxu`` notes say.
    Raises ValueError on ``sort_every < 0``, ``qbits < 1``, ``dbits < 0``
    or ``qbits + dbits > 8`` (``check_knobs``) before any launch."""
    return _render(scene, camera, width, height, start_sample, spp,
                   max_bounces=max_bounces, rr_depth=rr_depth,
                   use_nee=use_nee, use_mis=use_mis, seed=seed, dof=dof,
                   block=block, compact=compact, precull=precull, split=split,
                   mxu=mxu, sort_min_rays=sort_min_rays,
                   chunk_rays=chunk_rays, alive=alive, row_offset=row_offset,
                   full_height=full_height, sort_every=sort_every,
                   qbits=qbits, dir_major=dir_major, dbits=dbits,
                   rowsort=rowsort, tcull=tcull)


KERNELS = (raygen, isect, shade, bounce, isect_mxu, shade_mxu)
PLAIN = (raygen_plain, isect_plain, shade_plain, bounce_plain,
         isect_mxu_plain, shade_mxu_plain)


def _render(scene: SceneData, camera, width: int, height: int,
            start_sample: int, spp: int, *, stages: tuple = KERNELS,
            times: dict | None = None, max_bounces=8, rr_depth=3,
            use_nee=True, use_mis=True, seed=0, dof=None, block: int = BLOCK,
            compact: bool = True, precull: bool = True, split: bool = True,
            mxu: bool = False, sort_min_rays: int = 1 << 17,
            chunk_rays: int = 4 << 20, alive: list | None = None,
            row_offset: int = 0, full_height: int | None = None,
            sort_every: int = 1, qbits: int = Q_BITS, dir_major: bool = True,
            dbits: int = D_BITS, rowsort: bool = False,
            tcull: bool = True) -> torch.Tensor:
    """``render_wavefront`` with its stages given (``KERNELS``, or
    ``PLAIN`` to run the plain versions on either device, to hold the
    kernels against them on the card).  ``times``, if given, gets each
    stage's device milliseconds (CUDA events; it synchronizes after every
    stage); ``alive`` as in ``render_wavefront``."""
    check_knobs(sort_every=sort_every, qbits=qbits, dir_major=dir_major,
                dbits=dbits)
    if alive is not None:
        alive[:] = [0] * max_bounces
    t, static = packed(scene, camera, block)
    if dof is None:
        dof = bool(float(_np(camera.aperture)) > 0.0)
    env = scene.env_map
    if env is None or scene.sky_mode != SKY_ENVMAP:
        env = None
    elif env.device != scene.device:
        env = env.to(scene.device)
    chunk_spp = band_chunk_spp(width, height, spp, chunk_rays, row_offset,
                               full_height)
    img = None
    s = 0
    while s < spp:
        n = min(chunk_spp, spp - s)
        meta = torch.tensor([start_sample + s, seed, static["n_light_slots"]],
                            dtype=torch.int32).to(scene.device)
        part = _launch_wavefront(
            t, static, env, meta, width=width, height=height, chunk_spp=n,
            max_bounces=max_bounces, rr_depth=rr_depth, use_nee=bool(use_nee),
            use_mis=bool(use_mis), sky_mode=scene.sky_mode, dof=bool(dof),
            compact=compact, sort_min_rays=sort_min_rays, split=bool(split),
            precull=bool(precull), mxu=bool(mxu), stages=stages, times=times,
            alive=alive, row_offset=row_offset, full_height=full_height,
            sort_every=int(sort_every), qbits=int(qbits),
            dir_major=bool(dir_major), dbits=int(dbits),
            rowsort=bool(rowsort), tcull=bool(tcull))
        img = part if img is None else img + part
        s += n
    return img


# fp32 operations of K6 and K7 (csrc/wavefront.cu), counted by hand as
# K1_OPS are: a sphere test is K1's; over lists K6 and K7 add one compare
# per candidate block a lane takes (its bound against the lane's
# distance); a walk costs K3's per-ray setup and per-node slab test
# (K3_OPS).  K7's bounce is K1's (hit, miss, shadow) less its nearest-hit
# sweep, plus the rebuilt winner (a sphere test and the root choice, 20).
WF_OPS = dict(K1_OPS, block=1, rebuild=20)
# K6m and K7m per lane and block swept: o' = o - bctr, d.o' and |o'|^2
# (13); per slot, its two table columns of 8 products summed (30) and
# shifted by d.o' and |o'|^2 (2), then the root and its tests (12: the
# nearest root's, or ``_seg_blocked``'s squares and compares).  Every slot
# of a block is computed, padding too.
MXU_OPS = dict(block=13, slot=44)


def k6_op_count(stats: dict) -> int:
    """Lower count of K6's fp32 operations for ``isect_plain``'s stats:
    filled slots tested, and the candidates taken (list mode) or each
    walk's setup and node tests (tree mode, whose stats hold
    ``"nodes"``)."""
    if "nodes" in stats:
        return (stats["alive"] * K3_OPS["walk_setup"]
                + stats["nodes"] * K3_OPS["node_test"]
                + stats["spheres"] * WF_OPS["sphere_test"])
    return (stats["spheres"] * WF_OPS["sphere_test"]
            + stats["blocks"] * WF_OPS["block"])


def k7_op_count(stats: dict) -> int:
    """Lower count of K7's fp32 operations for ``shade_plain``'s stats: the
    bounce on the rebuilt winner and the shadow rays' walks (stats with
    ``"shadow_nodes"``) or sweeps."""
    if "shadow_nodes" in stats:
        shadow = (stats["shadow"] * K3_OPS["walk_setup"]
                  + stats["shadow_nodes"] * K3_OPS["node_test"])
    else:
        shadow = stats["shadow_blocks"] * WF_OPS["block"]
    return ((stats["active"] - stats["hit"]) * WF_OPS["miss"]
            + stats["hit"] * (WF_OPS["hit"] + WF_OPS["rebuild"])
            + stats["shadow"] * WF_OPS["shadow"]
            + stats["shadow_spheres"] * WF_OPS["sphere_test"] + shadow)


def k8_op_count(stats: dict) -> int:
    """Lower count of K8's fp32 operations for ``shadow_verdicts_plain``'s
    stats: the winner rebuilt on each hit, each shadow ray's setup and its
    walk of the shard's tree (the rest of the bounce, which K8 runs and
    throws away, is not counted)."""
    return (stats["hit"] * WF_OPS["rebuild"]
            + stats["shadow"] * (WF_OPS["shadow"] + K3_OPS["walk_setup"])
            + stats["shadow_nodes"] * K3_OPS["node_test"]
            + stats["shadow_spheres"] * WF_OPS["sphere_test"])


def k8_byte_count(stats: dict, n_lanes: int, tree_words: int) -> int:
    """Bytes K8 must move, each word once, for ``shadow_verdicts_plain``'s
    stats: every lane reads its alive flag and writes its verdict, an alive
    lane reads its origin, direction, ids and 5 residual channels, plus the
    shard's tree (``tree_words``: nodef, nodei and prims)."""
    return 4 * (2 * n_lanes + (6 + N_IDS + 5) * stats["active"]
                + tree_words)


def k8l_op_count(stats: dict) -> int:
    """Lower count of K8l's fp32 operations for ``anyhit_plain``'s stats:
    K7's shadow sweep alone."""
    return (stats["shadow_spheres"] * WF_OPS["sphere_test"]
            + stats["shadow_blocks"] * WF_OPS["block"])


def k8l_byte_count(stats: dict, n_lanes: int, block: int) -> int:
    """Bytes K8l must move, each word once, for ``anyhit_plain``'s stats:
    every lane reads its need flag and writes its verdict, a lane that
    needs one reads its 7 other ray channels, plus the shadow list words
    read and the four float rows of each distinct leaf block swept."""
    return 4 * (2 * n_lanes + 7 * stats["shadow"]
                + stats["shadow_list_words"]
                + 4 * block * stats["shadow_blocks_read"])


def k7b_op_count(stats: dict) -> int:
    """Lower count of the fp32 operations of K7 reading its verdict
    (``blocked_in_res``): K7's without the shadow sweep."""
    return k7_op_count(dict(stats, shadow_spheres=0, shadow_blocks=0))


def k7b_byte_count(stats: dict, n_lanes: int) -> int:
    """Bytes of K7 reading its verdict, each word once: K7's per-lane
    words (``k7_byte_count``) and the verdict of each shadow ray traced,
    and no list or leaf block."""
    return k7_byte_count(dict(stats, shadow_list_words=0,
                              shadow_blocks_read=0), n_lanes, 0) \
        + 4 * stats["shadow"]


def k6_byte_count(stats: dict, n_lanes: int, block: int,
                  tree_words: int = 0) -> int:
    """Bytes K6 must move, each word once, for ``isect_plain``'s stats:
    every lane reads its alive flag and writes its residual, an alive lane
    reads its origin and direction, plus, in list mode, the list words read
    and the four float rows of each distinct leaf block swept, or in tree
    mode the tree (``tree_words``: nodef, nodei and prims, as K11's
    count reads them)."""
    lists = stats.get("list_words", 0) + 4 * block * stats.get(
        "blocks_read", 0)
    return 4 * ((1 + N_RES) * n_lanes + 6 * stats["alive"] + lists
                + tree_words)


def k7_byte_count(stats: dict, n_lanes: int, block: int,
                  tree_words: int = 0) -> int:
    """Bytes K7 must move, each word once, for ``shade_plain``'s stats: an
    alive lane reads 15 state channels (all but in_image and miss), its ids
    and 5 residual channels and writes 16 channels; a dead lane reads its
    alive flag and writes its miss flag; plus the shadow list words read
    and the four float rows of each distinct leaf block swept, or the tree
    the shadow rays walk (``tree_words``)."""
    a = stats["active"]
    return 4 * ((15 + N_IDS + 5 + 16) * a + 2 * (n_lanes - a)
                + stats.get("shadow_list_words", 0)
                + 4 * block * stats.get("shadow_blocks_read", 0)
                + tree_words)


def k6m_op_count(stats: dict, block: int, culled: bool = False) -> int:
    """Lower count of K6m's fp32 operations for ``isect_mxu_plain``'s
    stats: every slot of each block a lane sweeps, in the expanded form.
    ``culled`` counts the culled sweep's work, the least the function
    needs and what K6m's bound counts: the blocks it sweeps and a slab
    test (K3's node test) a candidate taken.  Else the unculled sweep's
    (the culled candidates added back), the work K6m did before it
    culled."""
    per_block = WF_OPS["block"] + MXU_OPS["block"] + block * MXU_OPS["slot"]
    skipped = stats.get("culled_blocks", 0)
    if culled:
        return (stats["blocks"] * per_block
                + (stats["blocks"] + skipped) * K3_OPS["node_test"])
    return (stats["blocks"] + skipped) * per_block


def k6m_byte_count(stats: dict, n_lanes: int, block: int) -> int:
    """Bytes K6m must move, each word once: K6's, with each distinct block
    taken read as its (8, 2 block) table and centre in place of its slots,
    and its leaf box where the sweep culls (a lower count: the winners'
    rows of ``prims`` are left out)."""
    box = 8 if "culled_blocks" in stats else 0
    return 4 * ((1 + N_RES) * n_lanes + 6 * stats["alive"]
                + stats["list_words"]
                + (16 * block + 3 + box) * stats["blocks_read"])


def k7mv_op_count(stats: dict, block: int) -> int:
    """Lower count of the fp32 operations of K7m's verdict pass for
    ``shade_mxu_plain``'s stats: each candidate a shadow ray takes, its
    bound compared and every slot of its block in the expanded form.  (K7m's
    bounce is K7b's: ``k7b_op_count``.)"""
    return stats["shadow_blocks"] * (WF_OPS["block"] + MXU_OPS["block"]
                                     + block * MXU_OPS["slot"])


def k7mv_byte_count(stats: dict, n_lanes: int, block: int) -> int:
    """Bytes K7m's verdict pass must move, each word once: every lane reads
    its need flag and writes its verdict, a lane that needs one reads its 7
    other ray channels, plus the shadow list words read and each distinct
    block swept as its table and centre."""
    return 4 * (2 * n_lanes + 7 * stats["shadow"]
                + stats["shadow_list_words"]
                + (16 * block + 3) * stats["shadow_blocks_read"])


def k11_op_count(stats: dict, culled: bool = False) -> int:
    """Lower count of K11's fp32 operations for ``bounce_plain``'s stats:
    K7's bounce on a winner it found itself (no rebuild), its nearest hit
    by K6's sweep or by K3's walk (per lane the walk's setup, per node the
    slab test), and every shadow ray's walk.  A sweep culled by the boxes
    is counted unculled (each candidate taken swept, the culled ones
    added back), the work every earlier K11 did; ``culled`` counts the
    culled sweep's own work, the least the function needs and what K11's
    bound counts: the blocks it sweeps and a slab test a candidate
    taken."""
    walk = K3_OPS["walk_setup"]
    skipped = stats.get("culled_blocks", 0)
    if "nodes" in stats:
        nearest = (stats["active"] * walk + stats["nodes"]
                   * K3_OPS["node_test"] + stats["spheres"]
                   * WF_OPS["sphere_test"])
    elif culled:
        nearest = (k6_op_count(stats)
                   + (stats["blocks"] + skipped) * K3_OPS["node_test"])
    else:
        nearest = k6_op_count(dict(
            stats, blocks=stats["blocks"] + skipped,
            spheres=stats["spheres"] + stats.get("culled_spheres", 0)))
    return (nearest + (stats["active"] - stats["hit"]) * WF_OPS["miss"]
            + stats["hit"] * WF_OPS["hit"]
            + stats["shadow"] * (WF_OPS["shadow"] + walk)
            + stats["shadow_nodes"] * K3_OPS["node_test"]
            + stats["shadow_spheres"] * WF_OPS["sphere_test"])


def k11_byte_count(stats: dict, n_lanes: int, tree_words: int,
                   record: bool = False) -> int:
    """Bytes K11 must move, each word once: an alive lane reads 15 state
    channels and its ids and writes 16 channels, a dead lane reads its
    alive flag and writes its miss flag, the list words read where it
    sweeps lists, and the tree (``tree_words``: nodef, nodei and prims, as
    K3's count reads each input once).  K11g (``record``) also writes its
    8-row residual."""
    a = stats["active"]
    return 4 * ((15 + N_IDS + 16) * a + 2 * (n_lanes - a)
                + stats.get("list_words", 0) + tree_words
                + (N_RES * n_lanes if record else 0))
