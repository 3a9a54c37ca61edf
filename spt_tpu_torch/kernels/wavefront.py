"""The sorted wavefront: the forward render of env-map skies and of scenes
above 2048 spheres.

The port of ``spt_tpu.kernels.wavefront``'s split-bounce engine.  The render
keeps every ray's state in device memory between kernels and splits each
bounce at its hit:

  K5 raygen -> [ sort by a coherence key (not at bounce 0)
                 -> precull: each tile's rays slab-tested against every
                    leaf block's box -> per-tile candidate lists
                 -> K6 intersect: nearest hit over the lists -> residual
                 -> shadow rays rebuilt from the residual
                    (``physics.nee_shadow_setup``) and preculled
                 -> K7 shade: ``trace_bounce`` on the rebuilt hit, any-hit
                    sweep of the shadow lists; state in place
                 -> env-map radiance on the lanes that missed
               ] x depth -> scatter-add by pixel id

The stream is one float32 (19, R) buffer: the 17 state channels (``C_*``)
and, bit for bit, the int32 pixel and sample ids.  R counts 1024-lane tiles
of 32x32 swizzled pixels, ``chunk_spp`` images of them and one all-pad tile.
Every random draw is keyed on the ids the ray carries, so no permutation of
the stream changes a ray's result: the sort is invisible to the estimator.
After a sort the alive rays form a prefix; K6, K7 and the preculls run over
that prefix only, its length read to the host once per bounce.

Each kernel has a wrapper and a plain PyTorch version: ``raygen`` /
``raygen_plain`` (K5), ``isect`` / ``isect_plain`` (K6), ``shade`` /
``shade_plain`` (K7).  A wrapper runs the plain version for CPU tensors and
launches the hand-written kernel (``csrc/wavefront.cu``) for CUDA tensors,
or raises.  The glue between them (sort, precull, shadow rays, env map,
scatter) is torch ops, as it was XLA around the TPU kernels.
``LAUNCHES["k5"]``, ``["k6"]`` and ``["k7"]`` count the kernels' launches;
``LAUNCHES["plain"]`` counts one per call of any plain version, so a
wavefront render on the CPU adds one per chunk for raygen and two per
bounce that has alive rays.

A padding slot of a leaf block (centre 0, radius 0, id -1) can win K6's
sweep where the float quadratic says a ray through the origin hits it;
its id -1 then reads as no hit and the lane takes the sky, as in the JAX
package's wavefront (its K3 and this port's K3 resolve it otherwise; see
ROADMAP.md).
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
                         camera_rays)
from .megakernel_bvh import (BLOCK, _LIGHT_STRIDE, _MAT_OFF, _MAT_STRIDE,
                             _N_PRIM_ATTRS, _leaf_t, _safe_inv, packed)

TMIN = physics.TMIN
BIG = physics.BIG

TILE = 1024          # lanes of a stream tile
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
# JAX package's defaults off the TPU; only 0 direction bits are ported).
Q_BITS = 4
D_BITS = 0

PRECULL_TILE_CHUNK = 64   # tiles per precull step: bounds the (chunk, 1024,
                          # n_blocks) intermediates


def _live_bits(qbits: int) -> int:
    """Bits of an alive lane's key: octant, direction bits, morton code."""
    bits = 3 * qbits + 3 + 3 * D_BITS
    if bits + 2 > 31:
        raise ValueError(f"sort key needs {bits}+2 bits; qbits must be <= "
                         f"{8 - D_BITS} (got {qbits})")
    return bits


def _dead_key(qbits: int) -> int:
    """The key of a dead in-image lane: after every live key, whatever the
    key width, so the alive count is the number of keys below it."""
    return 1 << _live_bits(qbits)


def _pad_key(qbits: int) -> int:
    """The key of an out-of-image lane: after the dead ones too."""
    return 1 << (_live_bits(qbits) + 1)


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
                 height: int, chunk_spp: int, dof: bool):
    """Plain version of K5 -> (st (17, R), ids (2, R) int32), views of one
    (19, R) buffer.  Tile ``t`` of the stream is pixel tile ``t %
    tiles_per_img`` of sample ``meta[0] + t // tiles_per_img``; lane ``l``
    of a tile is its pixel (l % 32, l // 32).  The last tile pads: no lane
    of it, nor any lane off the image, is alive or in the image."""
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
    pyc = torch.clamp_max(py, height - 1)
    pid = pyc * width + pxc
    sample = (int(meta_h[0]) + tile // tiles_per_img) & rng.MASK32
    rays = camera_rays(blob, pid, pxc.to(torch.float32),
                       pyc.to(torch.float32), sample, width=width,
                       height=height, seed=int(meta_h[1]) & rng.MASK32,
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
           height: int, chunk_spp: int, dof: bool):
    """K5's wrapper: ``raygen_plain``'s stream, on the blob's device."""
    kw = dict(width=width, height=height, chunk_spp=chunk_spp, dof=dof)
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
            int(bool(dof)), ctypes.c_float(_f32(1.0 / width)),
            ctypes.c_float(_f32(1.0 / height)),
            ctypes.c_float(_f32(width / height)),
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


def _empty_lists(n_tiles: int, nb: int, device):
    cand = torch.full((n_tiles, 1, nb + 1), -1, dtype=torch.int32,
                      device=device)
    cand[:, :, 0] = 0
    ctn = torch.full((n_tiles, 1, nb), BIG, dtype=torch.float32,
                     device=device)
    return cand, ctn


def precull_tiles(o3, d3, act, tmax, lob, hib):
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
    tested (one read of which are live)."""
    nb = lob.shape[0]
    n_tiles = act.numel() // TILE
    dev = act.device
    cand, ctn = _empty_lists(n_tiles, nb, dev)
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
        grp = torch.where(hit, torch.clamp_min(tn, 0.0), BIG).amin(dim=1)
        del tn, hit
        order = torch.argsort(grp, dim=-1, stable=True)
        s_tn = torch.gather(grp, -1, order)
        n_cand = (grp < BIG).sum(dim=-1, dtype=torch.int32)
        ids = torch.where(s_tn < BIG, order.to(torch.int32), -1)
        rows = slice(c * chunk, c * chunk + ct)
        cand[rows, 0, 0] = n_cand
        cand[rows, 0, 1:] = ids
        ctn[rows, 0] = s_tn
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


def _coherence_key(stf, lo, ext, qbits: int = Q_BITS):
    """The direction-major sort key, int32: octant (3 bits) above the
    origin's morton code (``qbits`` per axis) for alive lanes, then
    ``_dead_key`` for dead in-image lanes and ``_pad_key`` for the rest.
    A tile of sorted rays then shares an octant and a run of origin cells.
    ``lo``, ``ext``: the scene box's corner and extent (3 0-d tensors)."""
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
    key = (octant << (3 * qbits)) | morton
    return torch.where(stf[C_ALIVE] > 0.5, key,
                       torch.where(stf[C_INIMG] > 0.5, _dead_key(qbits),
                                   _pad_key(qbits)).to(torch.int32))


def _sort_rays(buf: torch.Tensor, n_lanes: int, lo, ext) -> int:
    """Sort lanes [0, n_lanes) of the (19, R) stream buffer by
    ``_coherence_key``, in place: one sort of the key, then one gather of
    all 19 rows.  Returns the alive prefix in tiles (read to the host).
    Equal keys land in any order, which no ray's result can see."""
    part = buf[:, :n_lanes]
    key = _coherence_key(part, lo, ext)
    n_alive = int((key < _dead_key(Q_BITS)).sum())
    order = torch.sort(key, stable=False).indices
    part.copy_(part.index_select(1, order))
    return -(-n_alive // TILE)


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


def _sweep_lanes(cand, ctn, tile, bound, lanes, step):
    """Per-lane sweep of each lane's tile list in order: lane l takes
    candidate i while ``ctn[tile, i] < bound[l]`` and i is below its
    tile's count; ``step(idx, blk)`` tests block ``blk[m]`` for lanes
    ``idx[m]`` and returns the lanes that stop there.  ``bound`` is read
    again at each step, so a lane whose bound drops stops sooner.

    Returns ``(read, taken)``, (tiles,) int64: per tile, how many entry
    bounds some lane read, and how many candidates some lane took."""
    read = torch.zeros(cand.shape[0], dtype=torch.int64, device=cand.device)
    taken = torch.zeros_like(read)
    ncand = cand[:, 0, 0].long()[tile]
    idx = torch.nonzero(lanes & (ncand > 0))[:, 0]
    i = 0
    while idx.numel():
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


def isect_plain(prims: torch.Tensor, cand: torch.Tensor, ctn: torch.Tensor,
                st: torch.Tensor, n_lanes: int, *, block: int,
                stats: dict | None = None) -> torch.Tensor:
    """Plain version of K6 -> residual (8, n_lanes): for lanes [0, n_lanes)
    of the stream ``st`` (17, R), the nearest hit over their tiles' lists,
    each lane testing its candidates in order, a block's ``block`` slots in
    order with a strict ``<``, and stopping once the next candidate's bound
    reaches its nearest distance.  ``stats``, if given, gets ``"spheres"``
    (filled slots of the blocks tested), ``"blocks"``, ``"alive"`` (lanes
    swept), ``"list_words"`` and ``"blocks_read"`` (``_list_reads``)
    added."""
    LAUNCHES["plain"] += 1
    dev = st.device
    n = n_lanes
    prims = prims.reshape(-1, _N_PRIM_ATTRS, block)
    o = tuple(st[c, :n] for c in (C_OX, C_OY, C_OZ))
    d = tuple(st[c, :n] for c in (C_DX, C_DY, C_DZ))
    tile = torch.arange(n, device=dev) // TILE
    t = torch.full((n,), BIG, dtype=torch.float32, device=dev)
    win = torch.full((n,), -1, dtype=torch.int64, device=dev)
    work = torch.zeros(2, dtype=torch.int64, device=dev)
    filled = (prims[:, 4, :] >= 0.0).sum(dim=1)

    def step(idx, blk):
        tj, ok = _leaf_t(prims[blk], *(a[idx] for a in o),
                         *(a[idx] for a in d))
        tmin, j = torch.where(ok, tj, BIG).min(dim=1)
        better = tmin < t[idx]
        t[idx] = torch.where(better, tmin, t[idx])
        win[idx] = torch.where(better, blk * block + j, win[idx])
        work[0] += filled[blk].sum()
        work[1] += idx.numel()
        return torch.zeros_like(better)

    alive = st[C_ALIVE, :n] > 0.5
    reach = _sweep_lanes(cand, ctn, tile, t, alive, step)
    found = t < BIG
    slot = torch.clamp_min(win, 0)
    row = prims[slot // block, :, slot % block]              # (n, 5)
    res = torch.zeros((N_RES, n), dtype=torch.float32, device=dev)
    for a in range(4):
        res[a] = torch.where(found, row[:, a], 0.0)
    res[4] = torch.where(found, row[:, 4], -1.0)
    res[5] = torch.where(found, (slot // block).to(torch.float32), -1.0)
    res[6] = torch.where(found, (slot % block).to(torch.float32), -1.0)
    if stats is not None:
        stats["spheres"] = stats.get("spheres", 0) + int(work[0])
        stats["blocks"] = stats.get("blocks", 0) + int(work[1])
        words, blocks = _list_reads(cand, tile, alive, *reach)
        for name, v in (("alive", int(alive.sum())), ("list_words", words),
                        ("blocks_read", blocks)):
            stats[name] = stats.get(name, 0) + v
    return res


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


def isect(prims: torch.Tensor, cand: torch.Tensor, ctn: torch.Tensor,
          st: torch.Tensor, n_lanes: int, *, block: int) -> torch.Tensor:
    """K6's wrapper: ``isect_plain``'s residual, on the stream's device."""
    if st.device.type == "cpu":
        return isect_plain(prims, cand, ctn, st, n_lanes, block=block)
    if st.device.type != "cuda":
        raise NotImplementedError(f"K6 has no kernel for {st.device}")
    if any(a.device != st.device for a in (prims, cand, ctn)):
        raise ValueError("K6's inputs must lie on one device")
    _check_stream(st)
    nb = prims.numel() // (_N_PRIM_ATTRS * block)
    n_tiles = -(-n_lanes // TILE)
    if not 0 <= n_lanes <= st.shape[1] or n_lanes % TILE:
        raise ValueError(f"K6: {n_lanes} lanes of a stream of {st.shape[1]}")
    _check(prims, "prims", torch.float32, _N_PRIM_ATTRS * block * nb)
    _check_lists(cand, ctn, n_tiles, nb)
    res = torch.empty((N_RES, n_lanes), dtype=torch.float32, device=st.device)
    from ._build import load_library
    lib = load_library("wavefront")
    with torch.cuda.device(st.device):
        err = lib.spt_wavefront_isect(
            res.data_ptr(), st.data_ptr(), prims.data_ptr(), cand.data_ptr(),
            ctn.data_ptr(), st.shape[1], n_lanes, nb, block,
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"K6 launch failed: CUDA error {err}")
    LAUNCHES["k6"] += 1
    return res


# ---------------------------------------------------------------------------
# Glue: shadow rays
# ---------------------------------------------------------------------------


def _lights(blob: torch.Tensor, n_mats: int, n_light_slots: int):
    off = _MAT_OFF + _MAT_STRIDE * n_mats
    return blob[off:off + _LIGHT_STRIDE * n_light_slots].reshape(
        n_light_slots, _LIGHT_STRIDE)


def _winner_hit(st, res):
    """Hit lanes (alive, K6 found a sphere) and their hit points and
    shading normals, by K6's quadratic on the winner (as K7 rebuilds it)."""
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
    t = torch.where(b - sq > TMIN, b - sq, b + sq)
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


def shade_plain(blob, meta, lsb, prims, mtypes, scand, sctn, st, ids, res,
                n_lanes: int, *, k: int, block: int, n_mats: int,
                n_light_slots: int, rr_depth: int, use_nee: bool,
                use_mis: bool, sky_mode: int, stats: dict | None = None,
                blocked: torch.Tensor | None = None) -> None:
    """Plain version of K7: bounce ``k`` of lanes [0, n_lanes) of the
    stream, in place.  ``trace_bounce`` on the hit rebuilt from ``res``;
    each shadow ray tests its tile's shadow list in order and stops at its
    first blocker or once the next candidate's bound reaches its t_max.
    Dead lanes keep their state; the miss flag is set where an alive lane
    missed under an env-map sky, cleared elsewhere.  ``stats``, if given,
    gets ``render_samples_plain``'s per-bounce counts of this bounce
    (``"active"``, ``"hit"``, ``"shadow"``, ``"lit"``) and the shadow
    sweep's ``"shadow_spheres"``, ``"shadow_blocks"``,
    ``"shadow_list_words"`` and ``"shadow_blocks_read"`` added.
    ``blocked``, if given, (n_lanes,) float32, receives the NEE shadow
    verdict: 1 where a traced shadow ray is blocked, 0 elsewhere (K9's
    record, ``wavefront_grad.shade_fwd_plain``)."""
    LAUNCHES["plain"] += 1
    dev = st.device
    n = n_lanes
    prims = prims.reshape(-1, _N_PRIM_ATTRS, block)
    mats = blob[_MAT_OFF:_MAT_OFF + _MAT_STRIDE * n_mats].reshape(
        n_mats, _MAT_STRIDE)
    sc = PlainScene(blob, meta, lsb, 0, n_light_slots,
                    lights=_lights(blob, n_mats, n_light_slots))
    part = st[:, :n]
    pid = ids[0, :n].to(torch.int64) & rng.MASK32
    sample = ids[1, :n].to(torch.int64) & rng.MASK32
    tile = torch.arange(n, device=dev) // TILE
    filled = (prims[:, 4, :] >= 0.0).sum(dim=1)
    work = torch.zeros(2, dtype=torch.int64, device=dev)
    lists = []

    def occluded(ox, oy, oz, dx, dy, dz, tmax, need):
        verdict = torch.zeros_like(need)
        o, d = (ox, oy, oz), (dx, dy, dz)

        def step(idx, blk):
            tj, ok = _leaf_t(prims[blk], *(a[idx] for a in o),
                             *(a[idx] for a in d))
            hits = ok & (tj < tmax[idx][:, None])
            stop = hits.any(dim=1)
            first = torch.where(stop, hits.int().argmax(dim=1) + 1,
                                filled[blk])
            work[0] += first.sum()
            work[1] += idx.numel()
            verdict[idx] = stop
            return stop

        lists.append(_list_reads(
            scand, tile, need, *_sweep_lanes(scand, sctn, tile, tmax, need,
                                             step)))
        if blocked is not None:
            blocked.copy_(verdict)
        return verdict

    want_miss = sky_mode == SKY_ENVMAP
    cfg = physics.BounceCfg(
        mtypes=(), k=k, rr_depth=rr_depth, use_nee=use_nee, use_mis=use_mis,
        sky_mode=sky_mode, n_light_slots=n_light_slots, want_miss=want_miss)
    alive = part[C_ALIVE] > 0.5
    state, aux, tape = physics.trace_bounce_tape(
        sc.theta, tuple(part[c] for c in range(C_PDF + 1)),
        (alive, part[C_SPEC] > 0.5), sc.uniforms(pid, sample, k), sc.nl, cfg,
        _rebuilt_intersect(mats, mtypes.long(), res), occluded)
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
        w = work.tolist()
        stats["shadow_spheres"] = stats.get("shadow_spheres", 0) + w[0]
        stats["shadow_blocks"] = stats.get("shadow_blocks", 0) + w[1]
        for name, v in zip(("shadow_list_words", "shadow_blocks_read"),
                           lists[0] if lists else (0, 0)):
            stats[name] = stats.get(name, 0) + v


def shade(blob, meta, lsb, prims, mtypes, scand, sctn, st, ids, res,
          n_lanes: int, *, k: int, block: int, n_mats: int,
          n_light_slots: int, rr_depth: int, use_nee: bool, use_mis: bool,
          sky_mode: int) -> None:
    """K7's wrapper: ``shade_plain``'s bounce, in place, on the stream's
    device.  Without NEE ``scand`` and ``sctn`` are not read."""
    kw = dict(k=k, block=block, n_mats=n_mats, n_light_slots=n_light_slots,
              rr_depth=rr_depth, use_nee=use_nee, use_mis=use_mis,
              sky_mode=sky_mode)
    args = (blob, meta, lsb, prims, mtypes, scand, sctn, st, ids, res)
    if st.device.type == "cpu":
        return shade_plain(*args, n_lanes, **kw)
    _shade_launch("K7", args, n_lanes, None, **kw)
    LAUNCHES["k7"] += 1


def _shade_launch(name, args, n_lanes: int, blocked, *, k: int, block: int,
                  n_mats: int, n_light_slots: int, rr_depth: int,
                  use_nee: bool, use_mis: bool, sky_mode: int) -> None:
    """Checks and launches K7's kernel on CUDA tensors: K7 itself with
    ``blocked`` None, K9 (which also writes the (n_lanes,) shadow verdict
    into ``blocked``) otherwise."""
    blob, meta, lsb, prims, mtypes, scand, sctn, st, ids, res = args
    if st.device.type != "cuda":
        raise NotImplementedError(f"{name} has no kernel for {st.device}")
    if any(a.device != st.device for a in args):
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
    if use_nee and n_light_slots > 0:
        _check_lists(scand, sctn, n_lanes // TILE, nb)
    if blocked is not None:
        _check(blocked, "blocked", torch.float32, n_lanes)
    from ._build import load_library
    lib = load_library("wavefront")
    with torch.cuda.device(st.device):
        err = lib.spt_wavefront_shade(
            *(a.data_ptr() for a in (st, ids, res, blob, meta, lsb, prims,
                                     mtypes, scand, sctn)),
            0 if blocked is None else blocked.data_ptr(),
            st.shape[1], n_lanes, nb, block, n_mats, n_light_slots, k,
            rr_depth, int(bool(use_nee)), int(bool(use_mis)), int(sky_mode),
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


def _scatter_image(st, ids, width: int, height: int) -> torch.Tensor:
    """(H, W, 3) sum of the stream's radiance by pixel id; lanes off the
    image add into a discard slot."""
    idx = torch.where(st[C_INIMG] > 0.5, ids[0].long(), width * height)
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
                      sort_min_rays: int, stages: tuple,
                      times: dict | None) -> torch.Tensor:
    """One chunk of ``chunk_spp`` images -> (H, W, 3) radiance sum."""
    k5, k6, k7 = stages
    block, n_mats = static["block"], static["n_mats"]
    n_light_slots = static["n_light_slots"]
    blob, prims = t["blob"], t["prims"]
    clock = functools.partial(_timed, times, device=blob.device)
    with clock("raygen"):
        st, ids = k5(blob, meta, width=width, height=height,
                     chunk_spp=chunk_spp, dof=dof)
    buf = _stream_buffer(st, ids)
    n_tiles = st.shape[1] // TILE - 1
    lo, ext = _scene_sort_bounds(t["nodef"])
    lob, hib = _leaf_block_bounds(prims.reshape(-1, _N_PRIM_ATTRS, block))
    nl = int(_np(meta[2]))
    seed = int(_np(meta[1])) & rng.MASK32
    shadows = use_nee and n_light_slots > 0
    none_i = torch.zeros((1, 1, 1), dtype=torch.int32, device=blob.device)
    none_f = torch.zeros((1, 1, 1), dtype=torch.float32, device=blob.device)
    nalive = n_tiles
    t_half = max(1, (n_tiles + 1) // 2)
    t_quarter = max(1, (n_tiles + 1) // 4)
    for k in range(max_bounces):
        if k and nalive * TILE > sort_min_rays:
            # No sort at bounce 0; later, once the alive prefix fits in the
            # stream's first half or quarter, only that part is sorted (the
            # suffix is dead and stays in place).
            lanes = st.shape[1]
            if compact and k > 1:
                if nalive <= t_quarter:
                    lanes = t_quarter * TILE
                elif nalive <= t_half:
                    lanes = t_half * TILE
            with clock("sort"):
                na = _sort_rays(buf, lanes, lo, ext)
            if compact:
                nalive = na
        if nalive == 0:
            break
        n = nalive * TILE
        with clock("precull"):
            cand, ctn = precull_tiles(
                tuple(st[c, :n] for c in (C_OX, C_OY, C_OZ)),
                tuple(st[c, :n] for c in (C_DX, C_DY, C_DZ)),
                st[C_ALIVE, :n], None, lob, hib)
        with clock("k6"):
            res = k6(prims, cand, ctn, st, n, block=block)
        scand, sctn = none_i, none_f
        if shadows:
            with clock("shadow"):
                so3, sd3, stmax, sneed = shadow_rays(
                    st[:, :n], ids[:, :n], res, blob, t["lsb"], nl, k=k,
                    seed=seed, n_mats=n_mats, mtypes=static["mtypes"],
                    n_light_slots=n_light_slots)
                scand, sctn = precull_tiles(so3, sd3, sneed, stmax, lob, hib)
        with clock("k7"):
            k7(blob, meta, t["lsb"], prims, t["mtypes"], scand, sctn, st, ids,
               res, n, k=k, block=block, n_mats=n_mats,
               n_light_slots=n_light_slots, rr_depth=rr_depth,
               use_nee=use_nee, use_mis=use_mis, sky_mode=sky_mode)
        if sky_mode == SKY_ENVMAP:
            with clock("env"):
                _add_env_radiance(st[:, :n], env)
    with clock("scatter"):
        return _scatter_image(st, ids, width, height)


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
                     sort_min_rays: int = 1 << 17,
                     chunk_rays: int = 4 << 20) -> torch.Tensor:
    """Render ``spp`` samples with the sorted wavefront; returns the (H, W,
    3) radiance sum.

    Runs on the scene's device: K5-K7 for a scene on the card, their plain
    versions for a scene on the CPU.  The stream holds at most
    ``chunk_rays`` rays: samples go in chunks of as many whole images.  A
    sort runs before bounces 1.. while more than ``sort_min_rays`` rays
    were alive; ``compact=False`` keeps every lane in every launch and
    sorts the whole stream (for tests).  ``dof=None`` takes the thin lens
    iff the camera has an aperture."""
    return _render(scene, camera, width, height, start_sample, spp,
                   max_bounces=max_bounces, rr_depth=rr_depth,
                   use_nee=use_nee, use_mis=use_mis, seed=seed, dof=dof,
                   block=block, compact=compact, sort_min_rays=sort_min_rays,
                   chunk_rays=chunk_rays)


KERNELS = (raygen, isect, shade)
PLAIN = (raygen_plain, isect_plain, shade_plain)


def _render(scene: SceneData, camera, width: int, height: int,
            start_sample: int, spp: int, *, stages: tuple = KERNELS,
            times: dict | None = None, max_bounces=8, rr_depth=3,
            use_nee=True, use_mis=True, seed=0, dof=None, block: int = BLOCK,
            compact: bool = True, sort_min_rays: int = 1 << 17,
            chunk_rays: int = 4 << 20) -> torch.Tensor:
    """``render_wavefront`` with its K5-K7 stages given (``PLAIN`` runs
    the plain versions on either device, to hold the kernels against them
    on the card).  ``times``, if given, gets each stage's device
    milliseconds (CUDA events; it synchronizes after every stage)."""
    t, static = packed(scene, camera, block)
    if dof is None:
        dof = bool(float(_np(camera.aperture)) > 0.0)
    env = scene.env_map
    if env is None or scene.sky_mode != SKY_ENVMAP:
        env = None
    elif env.device != scene.device:
        env = env.to(scene.device)
    rays_per_img = stream_tiles(width, height, 1)[2] * TILE
    chunk_spp = max(1, min(spp, chunk_rays // rays_per_img))
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
            compact=compact, sort_min_rays=sort_min_rays, stages=stages,
            times=times)
        img = part if img is None else img + part
        s += n
    return img


# fp32 operations of K6 and K7 (csrc/wavefront.cu), counted by hand as
# K1_OPS are: a sphere test is K1's; K6 and K7 add one compare per
# candidate block a lane takes (its bound against the lane's distance).
# K7's bounce is K1's (hit, miss, shadow) less its nearest-hit sweep, plus
# the rebuilt winner (a sphere test and the root choice, 20).
WF_OPS = dict(K1_OPS, block=1, rebuild=20)


def k6_op_count(stats: dict) -> int:
    """Lower count of K6's fp32 operations for ``isect_plain``'s stats:
    filled slots tested, and the candidates taken."""
    return (stats["spheres"] * WF_OPS["sphere_test"]
            + stats["blocks"] * WF_OPS["block"])


def k7_op_count(stats: dict) -> int:
    """Lower count of K7's fp32 operations for ``shade_plain``'s stats."""
    return ((stats["active"] - stats["hit"]) * WF_OPS["miss"]
            + stats["hit"] * (WF_OPS["hit"] + WF_OPS["rebuild"])
            + stats["shadow"] * WF_OPS["shadow"]
            + stats["shadow_spheres"] * WF_OPS["sphere_test"]
            + stats["shadow_blocks"] * WF_OPS["block"])


def k6_byte_count(stats: dict, n_lanes: int, block: int) -> int:
    """Bytes K6 must move, each word once, for ``isect_plain``'s stats:
    every lane reads its alive flag and writes its residual, an alive lane
    reads its origin and direction, plus the list words read and the four
    float rows of each distinct leaf block swept."""
    return 4 * ((1 + N_RES) * n_lanes + 6 * stats["alive"]
                + stats["list_words"] + 4 * block * stats["blocks_read"])


def k7_byte_count(stats: dict, n_lanes: int, block: int) -> int:
    """Bytes K7 must move, each word once, for ``shade_plain``'s stats: an
    alive lane reads 15 state channels (all but in_image and miss), its ids
    and 5 residual channels and writes 16 channels; a dead lane reads its
    alive flag and writes its miss flag; plus the shadow list words read
    and the four float rows of each distinct leaf block swept."""
    a = stats["active"]
    return 4 * ((15 + N_IDS + 5 + 16) * a + 2 * (n_lanes - a)
                + stats["shadow_list_words"]
                + 4 * block * stats["shadow_blocks_read"])
