"""The differentiable sorted wavefront: large-scene gradients above 2048 prims.

The port of ``spt_tpu.kernels.wavefront_grad``.  Each bounce of the
wavefront (``wavefront.py``) becomes differentiable with respect to the
packed blob (sky, material table, light slots) and prim table (centres and
radii), and so, through ``megakernel_bvh.pack_blob_torch`` and
``pack_prims_torch``, to the scene's parameters:

  K5 raygen -> [ sort (a permutation under autograd)
                 -> K6 (its walk of the tree): on detached values, it only
                    selects
                 -> shade op: K9 forward (K7, its shadow rays walking the
                    tree, recording the NEE verdict), K10 backward (the
                    bounce's adjoint on the recorded winner, its per-prim
                    cotangents summed by the winner's (block, slot))
                 -> env-map radiance, out of place
               ] x depth -> scatter-add by pixel id

The walks take the tree refit to the parameters' centres and radii, so
the winners and verdicts are the ones the current spheres give.

The forward is K7's bounce on K6's winner, so a render equals the forward
wavefront's; the backward never traverses.  Each bounce keeps its
pre-bounce stream, ids and residual until ``backward``.  With
``split=False`` a bounce's forward is the fused bounce K11g instead (K11
recording K6's residual and the shadow verdict: no K6; its nearest hit by
the tiles' lists or, ``precull=False``, by a walk of the refit tree), the
same K10 backward:

  K5 raygen -> [ sort -> (precull) -> bounce op: K11g forward, K10
                 backward -> env-map radiance ] x depth -> scatter

* ``shade_fwd`` / ``shade_fwd_plain`` (K9): K7 out of place, plus the
  (n,) blocked mask.  ``bounce_fwd`` / ``bounce_fwd_plain`` (K11g): K11
  out of place, plus the (8, n) residual.  ``bounce_bwd_plain`` (K10's
  plain version): one bounce's adjoint from the saved state and residual
  -> d(state_in) (17, R), the per-lane d(centre, radius) (4, n) and the
  scalar gradients (n_scal,); ``bounce_bwd`` (K10's wrapper) gives
  d(centre, radius) summed into the prim table instead (the kernel adds
  each winner's into it; on the CPU ``bounce_bwd_scattered``: the plain
  version and ``_grads_from_bwd``'s scatter).  A wrapper runs the plain
  version for CPU tensors and launches the hand-written kernel
  (``csrc/wavefront.cu``) for CUDA tensors, or raises.
  ``LAUNCHES["k9"]`` (``["k9l"]`` over the shadow lists), ``["k10"]`` and
  ``["k11g"]`` count them.
* ``make_wavefront_render_fn`` returns ``render(params, start_sample)``.

Lanes past the alive prefix are neither shaded nor replayed: their state
and cotangent pass through, as the TPU kernels' aliases pass them.
"""

from __future__ import annotations

import torch

from ..core import rng
from ..core.scene import SKY_ENVMAP, SceneData
from . import physics
from .megakernel import K1_OPS, LAUNCHES, PlainScene, _SKY_OFF, _check, _np
from .megakernel_bvh import (BLOCK, _LIGHT_STRIDE, _MAT_OFF, _MAT_STRIDE,
                             _N_PRIM_ATTRS, pack_blob_torch, pack_prims_torch,
                             packed, refit_nodef_torch)
from .megakernel_grad import K2_OPS, N_SKY_ATTRS, N_STATE
from .megakernel_bvh_grad import n_scalars
from .physics_adjoint import rebuilt_bounce_vjp
from .wavefront import (C_ALIVE, C_DX, C_DY, C_DZ, C_LB, C_LG, C_LR,
                        C_MISS, C_SPEC, C_TB, C_TG, C_TR, D_BITS, N_CH, N_IDS,
                        N_RES, Q_BITS, TILE, WF_OPS, _bounce_launch,
                        _check_stream, _leaf_block_bounds, _lights,
                        _scatter_image, _scene_sort_bounds, _shade_launch,
                        _sort_order, _sort_span, bounce_plain, check_knobs,
                        isect, isect_plain, leaf_boxes, precull_tiles, raygen,
                        raygen_plain, sample_env_map, shade_plain,
                        stream_tiles)

# ---------------------------------------------------------------------------
# K9: shade, recording the shadow verdict
# ---------------------------------------------------------------------------


def shade_fwd_plain(blob, meta, lsb, prims, mtypes, scand, sctn, st, ids, res,
                    n_lanes: int, **kw):
    """Plain version of K9 -> (new stream (17, R), blocked (n_lanes,)):
    ``shade_plain``'s bounce on a copy of ``st`` (its shadow rays walking
    ``tree=`` or sweeping the lists), and its NEE shadow verdict (residual
    channel 7 of the backward)."""
    out = st.clone()
    blocked = torch.zeros(n_lanes, dtype=torch.float32, device=st.device)
    shade_plain(blob, meta, lsb, prims, mtypes, scand, sctn, out, ids, res,
                n_lanes, blocked=blocked, **kw)
    return out, blocked


def shade_fwd(blob, meta, lsb, prims, mtypes, scand, sctn, st, ids, res,
              n_lanes: int, **kw):
    """K9's wrapper: ``shade_fwd_plain``'s outputs on the stream's device
    (K7's kernel on a copy of the stream, writing the verdict too)."""
    if st.device.type == "cpu":
        return shade_fwd_plain(blob, meta, lsb, prims, mtypes, scand, sctn,
                               st, ids, res, n_lanes, **kw)
    out = st.clone()
    blocked = torch.empty(n_lanes, dtype=torch.float32, device=st.device)
    _shade_launch("K9", (blob, meta, lsb, prims, mtypes, scand, sctn, out,
                         ids, res), n_lanes, blocked, **kw)
    LAUNCHES["k9" if kw.get("tree") is not None else "k9l"] += 1
    return out, blocked


# ---------------------------------------------------------------------------
# K11g: the fused bounce, recording its winner and shadow verdict
# ---------------------------------------------------------------------------


def bounce_fwd_plain(blob, meta, lsb, nodef, nodei, prims, mtypes, cand, ctn,
                     st, ids, n_lanes: int, **kw):
    """Plain version of K11g -> (new stream (17, R), residual (8,
    n_lanes)): ``bounce_plain``'s bounce on a copy of ``st``, and its
    record, K6's winner residual with the shadow verdict in row 7 (what
    K10 replays)."""
    out = st.clone()
    res = torch.empty((N_RES, n_lanes), dtype=torch.float32, device=st.device)
    bounce_plain(blob, meta, lsb, nodef, nodei, prims, mtypes, cand, ctn, out,
                 ids, n_lanes, record=res, **kw)
    return out, res


def bounce_fwd(blob, meta, lsb, nodef, nodei, prims, mtypes, cand, ctn, st,
               ids, n_lanes: int, **kw):
    """K11g's wrapper: ``bounce_fwd_plain``'s outputs on the stream's
    device (K11's kernel on a copy of the stream, writing the residual
    too)."""
    if st.device.type == "cpu":
        return bounce_fwd_plain(blob, meta, lsb, nodef, nodei, prims, mtypes,
                                cand, ctn, st, ids, n_lanes, **kw)
    out = st.clone()
    res = torch.empty((N_RES, n_lanes), dtype=torch.float32, device=st.device)
    _bounce_launch("K11g", (blob, meta, lsb, nodef, nodei, prims, mtypes,
                            cand, ctn, out, ids), n_lanes, res, **kw)
    LAUNCHES["k11g"] += 1
    return out, res


# ---------------------------------------------------------------------------
# K10: one bounce's adjoint
# ---------------------------------------------------------------------------


def bounce_bwd_plain(blob, meta, lsb, mtypes, st, ids, res, ct, n_lanes: int,
                     *, k: int, n_mats: int, n_light_slots: int,
                     rr_depth: int, use_nee: bool, use_mis: bool,
                     sky_mode: int):
    """Plain version of K10 -> (din (17, R), dgeo (4, n_lanes), dscal
    (n_scal,)).  Lanes [0, n_lanes) of the pre-bounce stream ``st`` replay
    bounce ``k`` through ``physics_adjoint.rebuilt_bounce_vjp`` on their
    residual ``res`` (8, n_lanes; channel 7 the blocked mask), taking the
    post-bounce cotangent ``ct`` (17, R) to the pre-bounce one; the flags'
    cotangents are zero but in_image's, which passes.  Lanes past
    ``n_lanes`` pass ``ct`` through.  ``dgeo``: each lane's cotangent of
    its winner's centre and radius; ``dscal``: sky, material rows and light
    slots, summed over the lanes."""
    LAUNCHES["plain"] += 1
    n = n_lanes
    din = ct.clone()
    sc = PlainScene(blob, meta, lsb, 0, n_light_slots,
                    lights=_lights(blob, n_mats, n_light_slots))
    mats = blob[_MAT_OFF:_MAT_OFF + _MAT_STRIDE * n_mats].reshape(
        n_mats, _MAT_STRIDE)
    part = st[:, :n]
    pid = ids[0, :n].to(torch.int64) & rng.MASK32
    sample = ids[1, :n].to(torch.int64) & rng.MASK32
    cfg = physics.BounceCfg(
        mtypes=(), k=k, rr_depth=rr_depth, use_nee=use_nee, use_mis=use_mis,
        sky_mode=sky_mode, n_light_slots=n_light_slots,
        want_miss=sky_mode == SKY_ENVMAP)
    sky_ct, mats_ct, lights_ct, dgeo, st_ct = rebuilt_bounce_vjp(
        sc.theta[1], mats, mtypes, sc.theta[2], res[:, :n],
        tuple(part[c] for c in range(N_STATE)),
        (part[C_ALIVE] > 0.5, part[C_SPEC] > 0.5),
        sc.uniforms(pid, sample, k), sc.nl, cfg,
        tuple(ct[c, :n] for c in range(N_STATE)))
    din[:N_STATE, :n] = torch.stack(st_ct)
    for c in (C_ALIVE, C_SPEC, C_MISS):
        din[c, :n] = 0.0
    dscal = torch.cat([sky_ct, mats_ct.reshape(-1), lights_ct.reshape(-1)])
    return din, dgeo, dscal


def bounce_bwd_scattered(blob, meta, lsb, mtypes, st, ids, res, ct,
                         n_lanes: int, *, n_blocks: int, block: int, **kw):
    """K10's wrapper's outputs by its plain version: ``bounce_bwd_plain``,
    its per-lane d(centre, radius) scattered into the prim table by
    ``_grads_from_bwd`` -> (din (17, R), d_prims (n_blocks, 5, block),
    dscal (n_scal,)).  ``kw``: ``bounce_bwd_plain``'s keywords."""
    din, dgeo, dscal = bounce_bwd_plain(blob, meta, lsb, mtypes, st, ids, res,
                                        ct, n_lanes, **kw)
    _, d_prims = _grads_from_bwd(blob, res, dgeo, dscal, n_mats=kw["n_mats"],
                                 n_light_slots=kw["n_light_slots"],
                                 n_blocks=n_blocks, block=block)
    return din, d_prims, dscal


def bounce_bwd(blob, meta, lsb, mtypes, st, ids, res, ct, n_lanes: int, *,
               k: int, n_mats: int, n_light_slots: int, rr_depth: int,
               use_nee: bool, use_mis: bool, sky_mode: int, n_blocks: int,
               block: int):
    """K10's wrapper -> (din (17, R), d_prims (n_blocks, 5, block), dscal
    (n_scal,)): ``bounce_bwd_plain``'s din and dscal, and its lanes'
    d(centre, radius) summed into the prim table at each lane's winner's
    (block, slot), as ``_grads_from_bwd`` sums them.  On the CPU
    ``bounce_bwd_scattered``; on the card the kernel adds into the table
    itself."""
    kw = dict(k=k, n_mats=n_mats, n_light_slots=n_light_slots,
              rr_depth=rr_depth, use_nee=use_nee, use_mis=use_mis,
              sky_mode=sky_mode)
    args = (blob, meta, lsb, mtypes, st, ids, res, ct)
    if st.device.type == "cpu":
        return bounce_bwd_scattered(*args, n_lanes, n_blocks=n_blocks,
                                    block=block, **kw)
    if st.device.type != "cuda":
        raise NotImplementedError(f"K10 has no kernel for {st.device}")
    if any(a.device != st.device for a in args):
        raise ValueError("K10's inputs must lie on one device")
    _check_stream(st, ids)
    _check_stream(ct)
    r = st.shape[1]
    if ct.shape[1] != r or not 0 <= n_lanes <= r or n_lanes % TILE:
        raise ValueError(f"K10: {n_lanes} lanes of a stream of {r}, "
                         f"cotangent of {ct.shape[1]}")
    if n_blocks <= 0 or block <= 0:
        raise ValueError(f"K10: a prim table of {n_blocks} blocks of "
                         f"{block}")
    _check(blob, "blob", torch.float32, _MAT_OFF + _MAT_STRIDE * n_mats
           + _LIGHT_STRIDE * max(n_light_slots, 1))
    _check(meta, "meta", torch.int32, 3)
    _check(lsb, "lsb", torch.float32, 6)
    _check(mtypes, "mtypes", torch.int32, n_mats)
    _check(res, "res", torch.float32, N_RES * n_lanes)
    din = torch.empty_like(ct)
    d_prims = torch.zeros((n_blocks + 1, _N_PRIM_ATTRS, block),
                          dtype=torch.float32, device=st.device)
    dscal = torch.zeros(n_scalars(n_mats, n_light_slots),
                        dtype=torch.float32, device=st.device)
    from ._build import load_library
    lib = load_library("wavefront")
    with torch.cuda.device(st.device):
        err = lib.spt_wavefront_bounce_bwd(
            *(a.data_ptr() for a in (din, d_prims, dscal, st, ids, res, ct,
                                     blob, meta, lsb, mtypes)),
            r, n_lanes, n_mats, n_light_slots, k, rr_depth,
            int(bool(use_nee)), int(bool(use_mis)), int(sky_mode), n_blocks,
            block, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"K10 launch failed: CUDA error {err}")
    LAUNCHES["k10"] += 1
    return din, d_prims[:n_blocks], dscal


# ---------------------------------------------------------------------------
# Glue under autograd
# ---------------------------------------------------------------------------


class _PermuteLanes(torch.autograd.Function):
    """x (C, n) -> x[:, order] for a permutation ``order``.  The cotangent
    goes back by a gather too, at the inverse permutation, so each lane's
    comes back unchanged; ``index_select``'s own backward would add it
    into zeros with an ``index_add_``."""

    @staticmethod
    def forward(ctx, x, order):
        ctx.save_for_backward(order)
        return x.index_select(1, order)

    @staticmethod
    def backward(ctx, ct):
        order, = ctx.saved_tensors
        inverse = torch.empty_like(order)
        inverse[order] = torch.arange(order.numel(), device=order.device)
        return ct.index_select(1, inverse), None


def _sort_rays_diff(st, ids, n_lanes: int, lo, ext, qbits: int = Q_BITS,
                    dir_major: bool = True, dbits: int = D_BITS,
                    rowsort: bool = False):
    """``wavefront._sort_rays`` out of place and under autograd: lanes [0,
    n_lanes) of ``st`` (17, R) and ``ids`` (2, R) gathered by the sort of
    the coherence key (the knobs ``wavefront._sort_order``'s), the rest
    kept.  The gather's cotangent goes back by the inverse permutation
    (``_PermuteLanes``; a row permutation is a lane permutation too), so
    it is exact.  Returns (st, ids, alive prefix in tiles)."""
    part = st[:, :n_lanes]
    order, n_alive_tiles = _sort_order(part.detach(), n_lanes, lo, ext,
                                       qbits, dir_major, dbits, rowsort)
    st_s = _PermuteLanes.apply(part, order)
    ids_s = ids[:, :n_lanes].index_select(1, order)
    if n_lanes < st.shape[1]:
        st_s = torch.cat([st_s, st[:, n_lanes:]], dim=1)
        ids_s = torch.cat([ids_s, ids[:, n_lanes:]], dim=1)
    return st_s, ids_s, n_alive_tiles


def _add_env_radiance_diff(st, env, n_lanes: int):
    """``wavefront._add_env_radiance`` on lanes [0, n_lanes), out of place
    (autograd keeps the stream it read): radiance += throughput *
    env(direction) where the miss flag is set, which is then cleared."""
    head = st[:, :n_lanes]
    miss = head[C_MISS].detach() > 0.5
    rgb = sample_env_map(env, head[C_DX], head[C_DY], head[C_DZ])
    rows = list(head.unbind(0))
    for c, th, e in zip((C_LR, C_LG, C_LB), (C_TR, C_TG, C_TB), rgb):
        rows[c] = rows[c] + torch.where(miss, rows[th] * e, 0.0)
    rows[C_MISS] = torch.zeros_like(rows[C_MISS])
    out = torch.stack(rows)
    if n_lanes < st.shape[1]:
        out = torch.cat([out, st[:, n_lanes:]], dim=1)
    return out


def _blob_grad(blob, dscal, *, n_mats: int, n_light_slots: int):
    """K10's scalar gradients on the blob: its sky, material and light rows
    (the camera carries none)."""
    light_off = _MAT_OFF + _MAT_STRIDE * n_mats
    d_blob = torch.zeros_like(blob)
    d_blob[_SKY_OFF:_SKY_OFF + N_SKY_ATTRS] = dscal[:N_SKY_ATTRS]
    d_blob[_MAT_OFF:light_off] = dscal[N_SKY_ATTRS:N_SKY_ATTRS
                                       + _MAT_STRIDE * n_mats]
    if n_light_slots:
        d_blob[light_off:light_off + _LIGHT_STRIDE * n_light_slots] = \
            dscal[N_SKY_ATTRS + _MAT_STRIDE * n_mats:]
    return d_blob


def _grads_from_bwd(blob, res, dgeo, dscal, *, n_mats: int,
                    n_light_slots: int, n_blocks: int, block: int):
    """The plain K10's raw outputs -> (d_blob, d_prims (n_blocks, 5,
    block)).  The scalar gradients land on the blob (``_blob_grad``); each
    lane's d(centre, radius) is added at its winner's (block, slot) of the
    prim table, one ``index_add_`` of a flat (block, attribute, slot)
    index.  Lanes without a winner of their own (``hmid < 0``: a miss or a
    padding slot) add into a discard slot.  The kernel adds into the table
    itself (``bounce_bwd``)."""
    d_blob = _blob_grad(blob, dscal, n_mats=n_mats,
                        n_light_slots=n_light_slots)
    ok = res[4] >= 0.0
    blk = torch.where(ok, torch.clamp(res[5].long(), 0, max(n_blocks - 1, 0)),
                      n_blocks)
    slot = torch.clamp(res[6].long(), 0, block - 1)
    base = blk * _N_PRIM_ATTRS * block + slot
    d_prims = torch.zeros((n_blocks + 1) * _N_PRIM_ATTRS * block,
                          dtype=torch.float32, device=blob.device)
    d_prims.index_add_(0, torch.cat([base + a * block for a in range(4)]),
                       torch.where(ok, dgeo, 0.0).reshape(-1))
    return d_blob, d_prims.reshape(n_blocks + 1, _N_PRIM_ATTRS,
                                   block)[:n_blocks]


class _BounceOp(torch.autograd.Function):
    """(blob, prims, st) -> the stream after one bounce.  Forward:
    ``cfg["forward"](blob, prims, st)`` -> (new stream, residual with the
    shadow verdict in row 7): K9 on K6's winner (the split bounce) or K11g
    (the fused one).  Backward: K10 replays the bounce from ``st`` and the
    residual, both saved, and gives d(prims) summed by winner; on the CPU,
    and with the ``PLAIN`` stages, the plain version and
    ``_grads_from_bwd``'s scatter.  The lists, ids and residual come from
    detached values and carry no gradient."""

    @staticmethod
    def forward(ctx, blob, prims, st, cfg):
        out, res8 = cfg["forward"](blob, prims, st)
        ctx.save_for_backward(blob, st, res8)
        ctx.cfg = cfg
        return out

    @staticmethod
    def backward(ctx, ct):
        blob, st, res8 = ctx.saved_tensors
        cfg = ctx.cfg
        kw = cfg["kw"]
        din, d_prims, dscal = cfg["bounce_bwd"](
            blob, cfg["meta"], cfg["lsb"], cfg["mtypes"], st, cfg["ids"],
            res8, ct.contiguous(), cfg["n_lanes"], n_blocks=cfg["n_blocks"],
            **kw)
        d_blob = _blob_grad(blob, dscal, n_mats=kw["n_mats"],
                            n_light_slots=kw["n_light_slots"])
        return d_blob, d_prims, din, None


# ---------------------------------------------------------------------------
# The render
# ---------------------------------------------------------------------------


def _run_wavefront_diff(blob, meta, nodef, nodei, prims, env, static, *,
                        width: int, height: int, chunk_spp: int,
                        max_bounces: int, rr_depth: int, use_nee: bool,
                        use_mis: bool, sky_mode: int, dof: bool,
                        sort_min_rays: int, split: bool, precull: bool,
                        stages: tuple, sort_every: int = 1,
                        qbits: int = Q_BITS, dir_major: bool = True,
                        dbits: int = D_BITS, compact: bool = True,
                        tcull: bool = True):
    """One differentiable chunk of ``chunk_spp`` images -> (H, W, 3)
    radiance sum, the forward wavefront's loop with each bounce behind
    ``_BounceOp``: K6 and K9 walking the tree ``nodef``, ``nodei``
    (``split``), or K11g with its own walk or list sweep (``precull``;
    ``tcull`` as K11's).  The sort's knobs and ``compact`` as the forward
    wavefront's (no ``rowsort``, as in JAX's)."""
    k5, k6, k9, k10 = stages[:4]
    block, n_mats = static["block"], static["n_mats"]
    n_light_slots = static["n_light_slots"]
    blob_d, prims_d = blob.detach(), prims.detach()
    lsb = physics.lsel_bounds_from_prims(prims_d)
    mtypes = torch.tensor(static["mtypes"], dtype=torch.int32,
                          device=blob.device)
    st, ids = k5(blob_d, meta, width=width, height=height,
                 chunk_spp=chunk_spp, dof=dof)
    n_tiles = st.shape[1] // TILE - 1
    tree = (nodef.detach(), nodei)
    lo, ext = _scene_sort_bounds(tree[0])
    boxes = None
    if precull and not split:
        lob, hib = _leaf_block_bounds(prims_d.reshape(-1, _N_PRIM_ATTRS,
                                                      block))
        boxes = leaf_boxes(lob, hib)
    none_i = torch.zeros((1, 1, 1), dtype=torch.int32, device=blob.device)
    none_f = torch.zeros((1, 1, 1), dtype=torch.float32, device=blob.device)
    nalive = n_tiles
    for k in range(max_bounces):
        lanes = _sort_span(k, nalive, n_tiles, sort_min_rays, compact,
                           sort_every)
        if lanes is not None:
            st, ids, na = _sort_rays_diff(st, ids, lanes, lo, ext, qbits,
                                          dir_major, dbits)
            if compact:
                nalive = na
        if nalive == 0:
            break
        n = nalive * TILE
        st_d = st.detach()
        kw = dict(k=k, block=block, n_mats=n_mats,
                  n_light_slots=n_light_slots, rr_depth=rr_depth,
                  use_nee=use_nee, use_mis=use_mis, sky_mode=sky_mode)
        if split:
            res = k6(prims_d, None, None, st_d, n, block=block, tree=tree)

            def forward(blob_, prims_, st_, res=res, ids=ids, n=n, kw=kw):
                out, blocked = k9(blob_, meta, lsb, prims_, mtypes, None,
                                  None, st_, ids, res, n, tree=tree, **kw)
                res8 = res.clone()
                res8[7] = blocked
                return out, res8
        else:
            cand, ctn = none_i, none_f
            if precull:
                cand, ctn = precull_tiles(
                    tuple(st_d[c, :n] for c in range(3)),
                    tuple(st_d[c, :n] for c in range(3, 6)),
                    st_d[C_ALIVE, :n], None, lob, hib)

            def forward(blob_, prims_, st_, cand=cand, ctn=ctn, ids=ids, n=n,
                        kw=kw):
                return stages[4](blob_, meta, lsb, tree[0], nodei, prims_,
                                 mtypes, cand, ctn, st_, ids, n,
                                 precull=precull, boxes=boxes, tcull=tcull,
                                 **kw)
        cfg = dict(forward=forward, bounce_bwd=k10, meta=meta, lsb=lsb,
                   mtypes=mtypes, ids=ids, n_lanes=n,
                   n_blocks=prims.shape[0], kw=kw)
        st = _BounceOp.apply(blob, prims, st, cfg)
        if sky_mode == SKY_ENVMAP:
            st = _add_env_radiance_diff(st, env, n)
    return _scatter_image(st, ids, width, height)


KERNELS = (raygen, isect, shade_fwd, bounce_bwd, bounce_fwd)
PLAIN = (raygen_plain, isect_plain, shade_fwd_plain, bounce_bwd_scattered,
         bounce_fwd_plain)


def make_wavefront_render_fn(scene: SceneData, camera, width: int,
                             height: int, *, spp: int, max_bounces: int = 8,
                             rr_depth: int = 3, use_nee: bool = True,
                             use_mis: bool = True, seed: int = 0,
                             sort_every: int = 1, qbits: int = Q_BITS,
                             dir_major: bool = True, dbits: int = D_BITS,
                             block: int = BLOCK, compact: bool = True,
                             tcull: bool = True, split: bool = True,
                             precull: bool = True,
                             sort_min_rays: int = 1 << 17,
                             chunk_rays: int = 2 << 20):
    """render(params, start_sample) -> (H, W, 3) mean radiance of samples
    ``start_sample .. start_sample + spp - 1``, differentiable with
    ``torch.autograd`` (K5, K6, K9 forward, K10 backward, on the scene's
    device; their plain versions for a scene on the CPU).

    ``params`` may hold any subset of ``diff.cuda_diff.PARAM_KEYS``;
    centres or radii refit the tree's boxes (``refit_nodef_torch``) each
    call, and K6 and K9 walk the refit tree.  Samples go in chunks of as many whole images as ``chunk_rays``
    rays hold (JAX's grad default, one 1080p image a chunk); every chunk's
    bounces stay saved until ``backward``.  ``split=False`` runs each
    bounce's forward as the fused bounce K11g (its nearest hit by the
    tiles' lists, or with ``precull=False`` by a walk of the refit tree;
    its shadow rays walk the tree) and K10 backward; ``precull`` acts on
    the fused bounce only, as in the JAX package.  The two give the same
    value and gradients but where a ray wins a leaf's padding slot.

    JAX's knobs, at its defaults off the TPU: ``sort_every``, ``qbits``,
    ``dir_major`` and ``dbits`` as ``wavefront.render_wavefront``'s (no
    ``rowsort``: JAX's gradient has none), ``block`` the leaf width,
    ``compact=False`` every lane in every launch and whole-stream sorts,
    ``tcull`` as the forward's (K11g's list sweep: ``split=False`` with
    ``precull``).  None changes the value; the gradients only by the order
    of K10's sums.  Raises ValueError as ``wavefront.check_knobs`` does,
    here."""
    return _make_render_fn(scene, camera, width, height, stages=KERNELS,
                           spp=spp, max_bounces=max_bounces,
                           rr_depth=rr_depth, use_nee=use_nee,
                           use_mis=use_mis, seed=seed, split=split,
                           precull=precull, sort_min_rays=sort_min_rays,
                           chunk_rays=chunk_rays, block=block,
                           sort_every=sort_every, qbits=qbits,
                           dir_major=dir_major, dbits=dbits, compact=compact,
                           tcull=tcull)


def _make_render_fn(scene: SceneData, camera, width: int, height: int, *,
                    stages: tuple, spp: int, max_bounces: int, rr_depth: int,
                    use_nee: bool, use_mis: bool, seed: int,
                    sort_min_rays: int, chunk_rays: int, block: int = BLOCK,
                    split: bool = True, precull: bool = True,
                    sort_every: int = 1, qbits: int = Q_BITS,
                    dir_major: bool = True, dbits: int = D_BITS,
                    compact: bool = True, tcull: bool = True):
    """``make_wavefront_render_fn`` with its stages given: K5, K6, K9, K10
    and K11g (``PLAIN`` runs the plain versions on either device, to hold
    the kernels against them on the card; the split bounce reads only the
    first four)."""
    from ..diff import gradients as G
    check_knobs(sort_every=sort_every, qbits=qbits, dir_major=dir_major,
                dbits=dbits)
    t, static = packed(scene, camera, block)
    nodef0, nodei = t["nodef"], t["nodei"]
    dof = bool(float(_np(camera.aperture)) > 0.0)
    env = scene.env_map
    if env is None or scene.sky_mode != SKY_ENVMAP:
        env = None
    elif env.device != scene.device:
        env = env.to(scene.device)
    rays_per_img = stream_tiles(width, height, 1)[2] * TILE
    chunk_spp = max(1, min(spp, chunk_rays // rays_per_img))
    kw = dict(width=width, height=height, max_bounces=max_bounces,
              rr_depth=rr_depth, use_nee=bool(use_nee),
              use_mis=bool(use_mis), sky_mode=scene.sky_mode, dof=dof,
              sort_min_rays=sort_min_rays, split=bool(split),
              precull=bool(precull), stages=stages,
              sort_every=int(sort_every), qbits=int(qbits),
              dir_major=bool(dir_major), dbits=int(dbits),
              compact=bool(compact), tcull=bool(tcull))

    def render(params: dict, start_sample) -> torch.Tensor:
        sc = G.apply_params(scene, params)
        nodef = refit_nodef_torch(sc, static) \
            if ("centers" in params or "radii" in params) else nodef0
        blob = pack_blob_torch(sc, camera, static)
        prims = pack_prims_torch(sc, static)
        img = None
        s = 0
        while s < spp:
            n = min(chunk_spp, spp - s)
            meta = torch.tensor([int(start_sample) + s, seed,
                                 static["n_light_slots"]],
                                dtype=torch.int32).to(scene.device)
            part = _run_wavefront_diff(blob, meta, nodef, nodei, prims, env,
                                       static, chunk_spp=n, **kw)
            img = part if img is None else img + part
            s += n
        return img * (1.0 / spp)

    return render


# fp32 operations and bytes of K9 and K10 (csrc/wavefront.cu), counted by
# hand as WF_OPS are, from ``shade_plain``'s stats of the same bounce.  K9
# is K7 and writes the verdict.  K10 replays every alive lane's bounce on
# its residual (K7's shading, no sweep) and runs its adjoint at K2's
# per-lane counts; a lower count of what the data needs.


def k10_op_count(stats: dict) -> int:
    """Lower count of K10's fp32 operations for ``shade_plain``'s stats."""
    return ((stats["active"] - stats["hit"]) * WF_OPS["miss"]
            + stats["hit"] * (WF_OPS["hit"] + WF_OPS["rebuild"]
                              + K2_OPS["hit"])
            + stats["shadow"] * K1_OPS["shadow"]
            + stats["lit"] * K2_OPS["lit"])


def k10_byte_count(stats: dict, n_lanes: int, n_stream: int, n_scal: int,
                   n_blocks: int, block: int) -> int:
    """Bytes K10 must move, each word once: an alive lane reads 15 state
    channels, its ids, 6 residual channels (winner and verdict), where it
    hit the winner's block and slot, and 14 cotangent channels (13 and
    in_image), and writes 17; a dead lane of the prefix reads its alive
    flag and 14 cotangent channels and writes 17; a lane past the prefix
    copies 17; the scalar gradients and the prim table's centre and radius
    rows (4 of each block's 5) are written once."""
    a = stats["active"]
    return 4 * ((15 + N_IDS + 6 + 14 + N_CH) * a + 2 * stats["hit"]
                + (1 + 14 + N_CH) * (n_lanes - a)
                + 2 * N_CH * (n_stream - n_lanes) + n_scal
                + 4 * n_blocks * block)
