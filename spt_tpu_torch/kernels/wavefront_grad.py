"""The differentiable sorted wavefront: large-scene gradients above 2048 prims.

The port of ``spt_tpu.kernels.wavefront_grad``'s split path.  Each bounce of
the wavefront (``wavefront.py``) becomes differentiable with respect to the
packed blob (sky, material table, light slots) and prim table (centres and
radii), and so, through ``megakernel_bvh.pack_blob_torch`` and
``pack_prims_torch``, to the scene's parameters:

  K5 raygen -> [ sort (a permutation under autograd)
                 -> precull, K6, shadow rays, shadow precull: on detached
                    values, they only select
                 -> shade op: K9 forward (K7 recording the NEE verdict),
                    K10 backward (the bounce's adjoint on the recorded
                    winner), per-prim cotangents scattered by the winner's
                    (block, slot)
                 -> env-map radiance, out of place
               ] x depth -> scatter-add by pixel id

The forward is K7's bounce on K6's winner, so a render equals the forward
wavefront's; the backward never traverses.  Each bounce keeps its
pre-bounce stream, ids and residual until ``backward``.

* ``shade_fwd`` / ``shade_fwd_plain`` (K9): K7 out of place, plus the
  (n,) blocked mask.  ``bounce_bwd`` / ``bounce_bwd_plain`` (K10): one
  bounce's adjoint from the saved state and residual -> d(state_in) (17,
  R), the per-lane d(centre, radius) (4, n) and the scalar gradients
  (n_scal,).  A wrapper runs the plain version for CPU tensors and
  launches the hand-written kernel (``csrc/wavefront.cu``) for CUDA
  tensors, or raises.  ``LAUNCHES["k9"]`` and ``["k10"]`` count them.
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
                        C_MISS, C_SPEC, C_TB, C_TG, C_TR, N_CH, N_IDS,
                        N_RES, Q_BITS, TILE, WF_OPS, _check_stream,
                        _coherence_key, _dead_key, _leaf_block_bounds,
                        _lights, _scatter_image, _scene_sort_bounds,
                        _shade_launch, isect, isect_plain, precull_tiles,
                        raygen, raygen_plain, sample_env_map, shade_plain,
                        shadow_rays, stream_tiles)

# ---------------------------------------------------------------------------
# K9: shade, recording the shadow verdict
# ---------------------------------------------------------------------------


def shade_fwd_plain(blob, meta, lsb, prims, mtypes, scand, sctn, st, ids, res,
                    n_lanes: int, **kw):
    """Plain version of K9 -> (new stream (17, R), blocked (n_lanes,)):
    ``shade_plain``'s bounce on a copy of ``st``, and its NEE shadow
    verdict (residual channel 7 of the backward)."""
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
    LAUNCHES["k9"] += 1
    return out, blocked


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


def bounce_bwd(blob, meta, lsb, mtypes, st, ids, res, ct, n_lanes: int, *,
               k: int, n_mats: int, n_light_slots: int, rr_depth: int,
               use_nee: bool, use_mis: bool, sky_mode: int):
    """K10's wrapper: ``bounce_bwd_plain``'s outputs on the stream's
    device."""
    kw = dict(k=k, n_mats=n_mats, n_light_slots=n_light_slots,
              rr_depth=rr_depth, use_nee=use_nee, use_mis=use_mis,
              sky_mode=sky_mode)
    args = (blob, meta, lsb, mtypes, st, ids, res, ct)
    if st.device.type == "cpu":
        return bounce_bwd_plain(*args, n_lanes, **kw)
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
    _check(blob, "blob", torch.float32, _MAT_OFF + _MAT_STRIDE * n_mats
           + _LIGHT_STRIDE * max(n_light_slots, 1))
    _check(meta, "meta", torch.int32, 3)
    _check(lsb, "lsb", torch.float32, 6)
    _check(mtypes, "mtypes", torch.int32, n_mats)
    _check(res, "res", torch.float32, N_RES * n_lanes)
    din = torch.empty_like(ct)
    dgeo = torch.empty((4, n_lanes), dtype=torch.float32, device=st.device)
    dscal = torch.zeros(n_scalars(n_mats, n_light_slots),
                        dtype=torch.float32, device=st.device)
    from ._build import load_library
    lib = load_library("wavefront")
    with torch.cuda.device(st.device):
        err = lib.spt_wavefront_bounce_bwd(
            *(a.data_ptr() for a in (din, dgeo, dscal, st, ids, res, ct,
                                     blob, meta, lsb, mtypes)),
            r, n_lanes, n_mats, n_light_slots, k, rr_depth,
            int(bool(use_nee)), int(bool(use_mis)), int(sky_mode),
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"K10 launch failed: CUDA error {err}")
    LAUNCHES["k10"] += 1
    return din, dgeo, dscal


# ---------------------------------------------------------------------------
# Glue under autograd
# ---------------------------------------------------------------------------


def _sort_rays_diff(st, ids, n_lanes: int, lo, ext):
    """``wavefront._sort_rays`` out of place and under autograd: lanes [0,
    n_lanes) of ``st`` (17, R) and ``ids`` (2, R) gathered by the sort of
    the coherence key, the rest kept.  The gather's cotangent goes back by
    the same permutation (``index_select``'s backward adds each value into
    a zero), so it is exact.  Returns (st, ids, alive prefix in tiles)."""
    part = st[:, :n_lanes]
    key = _coherence_key(part.detach(), lo, ext)
    n_alive = int((key < _dead_key(Q_BITS)).sum())
    order = torch.sort(key, stable=False).indices
    st_s = part.index_select(1, order)
    ids_s = ids[:, :n_lanes].index_select(1, order)
    if n_lanes < st.shape[1]:
        st_s = torch.cat([st_s, st[:, n_lanes:]], dim=1)
        ids_s = torch.cat([ids_s, ids[:, n_lanes:]], dim=1)
    return st_s, ids_s, -(-n_alive // TILE)


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


def _grads_from_bwd(blob, res, dgeo, dscal, *, n_mats: int,
                    n_light_slots: int, n_blocks: int, block: int):
    """K10's raw outputs -> (d_blob, d_prims (n_blocks, 5, block)).  The
    scalar gradients land on the blob's sky, material and light rows (the
    camera carries none); each lane's d(centre, radius) is added at its
    winner's (block, slot) of the prim table, one ``index_add_`` of a flat
    (block, attribute, slot) index.  Lanes without a winner of their own
    (``hmid < 0``: a miss or a padding slot) add into a discard slot."""
    light_off = _MAT_OFF + _MAT_STRIDE * n_mats
    d_blob = torch.zeros_like(blob)
    d_blob[_SKY_OFF:_SKY_OFF + N_SKY_ATTRS] = dscal[:N_SKY_ATTRS]
    d_blob[_MAT_OFF:light_off] = dscal[N_SKY_ATTRS:N_SKY_ATTRS
                                       + _MAT_STRIDE * n_mats]
    if n_light_slots:
        d_blob[light_off:light_off + _LIGHT_STRIDE * n_light_slots] = \
            dscal[N_SKY_ATTRS + _MAT_STRIDE * n_mats:]
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


class _ShadeOp(torch.autograd.Function):
    """(blob, prims, st) -> the stream after one bounce: K9 forward, K10
    backward.  ``st`` is saved with the residual and the blocked mask; the
    lists, ids and residual come from detached values and carry no
    gradient."""

    @staticmethod
    def forward(ctx, blob, prims, st, ids, res, scand, sctn, cfg):
        out, blocked = cfg["shade_fwd"](
            blob, cfg["meta"], cfg["lsb"], prims, cfg["mtypes"], scand, sctn,
            st, ids, res, cfg["n_lanes"], **cfg["kw"])
        res8 = res.clone()
        res8[7] = blocked
        ctx.save_for_backward(blob, st, ids, res8)
        ctx.cfg = cfg
        return out

    @staticmethod
    def backward(ctx, ct):
        blob, st, ids, res8 = ctx.saved_tensors
        cfg = ctx.cfg
        kw = dict(cfg["kw"])
        block = kw.pop("block")
        din, dgeo, dscal = cfg["bounce_bwd"](
            blob, cfg["meta"], cfg["lsb"], cfg["mtypes"], st, ids, res8,
            ct.contiguous(), cfg["n_lanes"], **kw)
        d_blob, d_prims = _grads_from_bwd(
            blob, res8, dgeo, dscal, n_mats=kw["n_mats"],
            n_light_slots=kw["n_light_slots"], n_blocks=cfg["n_blocks"],
            block=block)
        return d_blob, d_prims, din, None, None, None, None, None


# ---------------------------------------------------------------------------
# The render
# ---------------------------------------------------------------------------


def _run_wavefront_diff(blob, meta, nodef, prims, env, static, *, width: int,
                        height: int, chunk_spp: int, max_bounces: int,
                        rr_depth: int, use_nee: bool, use_mis: bool,
                        sky_mode: int, dof: bool, sort_min_rays: int,
                        stages: tuple):
    """One differentiable chunk of ``chunk_spp`` images -> (H, W, 3)
    radiance sum, the forward wavefront's loop with each bounce's shading
    behind ``_ShadeOp``."""
    k5, k6, k9, k10 = stages
    block, n_mats = static["block"], static["n_mats"]
    n_light_slots = static["n_light_slots"]
    blob_d, prims_d = blob.detach(), prims.detach()
    lsb = physics.lsel_bounds_from_prims(prims_d)
    mtypes = torch.tensor(static["mtypes"], dtype=torch.int32,
                          device=blob.device)
    st, ids = k5(blob_d, meta, width=width, height=height,
                 chunk_spp=chunk_spp, dof=dof)
    n_tiles = st.shape[1] // TILE - 1
    lo, ext = _scene_sort_bounds(nodef)
    lob, hib = _leaf_block_bounds(prims_d.reshape(-1, _N_PRIM_ATTRS, block))
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
            lanes = st.shape[1]
            if k > 1:
                if nalive <= t_quarter:
                    lanes = t_quarter * TILE
                elif nalive <= t_half:
                    lanes = t_half * TILE
            st, ids, nalive = _sort_rays_diff(st, ids, lanes, lo, ext)
        if nalive == 0:
            break
        n = nalive * TILE
        st_d = st.detach()
        cand, ctn = precull_tiles(
            tuple(st_d[c, :n] for c in range(3)),
            tuple(st_d[c, :n] for c in range(3, 6)), st_d[C_ALIVE, :n],
            None, lob, hib)
        res = k6(prims_d, cand, ctn, st_d, n, block=block)
        scand, sctn = none_i, none_f
        if shadows:
            so3, sd3, stmax, sneed = shadow_rays(
                st_d[:, :n], ids[:, :n], res, blob_d, lsb, nl, k=k,
                seed=seed, n_mats=n_mats, mtypes=static["mtypes"],
                n_light_slots=n_light_slots)
            scand, sctn = precull_tiles(so3, sd3, sneed, stmax, lob, hib)
        cfg = dict(shade_fwd=k9, bounce_bwd=k10, meta=meta, lsb=lsb,
                   mtypes=mtypes, n_lanes=n, n_blocks=prims.shape[0],
                   kw=dict(k=k, block=block, n_mats=n_mats,
                           n_light_slots=n_light_slots, rr_depth=rr_depth,
                           use_nee=use_nee, use_mis=use_mis,
                           sky_mode=sky_mode))
        st = _ShadeOp.apply(blob, prims, st, ids, res, scand, sctn, cfg)
        if sky_mode == SKY_ENVMAP:
            st = _add_env_radiance_diff(st, env, n)
    return _scatter_image(st, ids, width, height)


KERNELS = (raygen, isect, shade_fwd, bounce_bwd)
PLAIN = (raygen_plain, isect_plain, shade_fwd_plain, bounce_bwd_plain)


def make_wavefront_render_fn(scene: SceneData, camera, width: int,
                             height: int, *, spp: int, max_bounces: int = 8,
                             rr_depth: int = 3, use_nee: bool = True,
                             use_mis: bool = True, seed: int = 0,
                             split: bool = True,
                             sort_min_rays: int = 1 << 17,
                             chunk_rays: int = 2 << 20):
    """render(params, start_sample) -> (H, W, 3) mean radiance of samples
    ``start_sample .. start_sample + spp - 1``, differentiable with
    ``torch.autograd`` (K5, K6, K9 forward, K10 backward, on the scene's
    device; their plain versions for a scene on the CPU).

    ``params`` may hold any subset of ``diff.cuda_diff.PARAM_KEYS``;
    centres or radii refit the tree's boxes (``refit_nodef_torch``) each call.  Samples go
    in chunks of as many whole images as ``chunk_rays`` rays hold (JAX's
    grad default, one 1080p image a chunk); every chunk's bounces stay
    saved until ``backward``.  ``split=False`` (the fused bounce K11) is
    not ported."""
    if not split:
        raise NotImplementedError(
            "split=False: the fused wavefront bounce K11 is ROADMAP.md item "
            "15, not ported yet")
    return _make_render_fn(scene, camera, width, height, stages=KERNELS,
                           spp=spp, max_bounces=max_bounces,
                           rr_depth=rr_depth, use_nee=use_nee,
                           use_mis=use_mis, seed=seed,
                           sort_min_rays=sort_min_rays, chunk_rays=chunk_rays)


def _make_render_fn(scene: SceneData, camera, width: int, height: int, *,
                    stages: tuple, spp: int, max_bounces: int, rr_depth: int,
                    use_nee: bool, use_mis: bool, seed: int,
                    sort_min_rays: int, chunk_rays: int, block: int = BLOCK):
    """``make_wavefront_render_fn`` with its K5, K6, K9 and K10 stages given
    (``PLAIN`` runs the plain versions on either device, to hold the
    kernels against them on the card)."""
    from ..diff import gradients as G
    t, static = packed(scene, camera, block)
    nodef0 = t["nodef"]
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
              sort_min_rays=sort_min_rays, stages=stages)

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
            part = _run_wavefront_diff(blob, meta, nodef, prims, env, static,
                                       chunk_spp=n, **kw)
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


def k10_byte_count(stats: dict, n_lanes: int, n_stream: int,
                   n_scal: int) -> int:
    """Bytes K10 must move, each word once: an alive lane reads 15 state
    channels, its ids, 6 residual channels (winner and verdict) and 14
    cotangent channels (13 and in_image) and writes 17 and its 4 geometry
    cotangents; a dead lane of the prefix reads its alive flag and 14
    cotangent channels and writes 17 and 4; a lane past the prefix copies
    17; the scalar gradients are written once."""
    a = stats["active"]
    return 4 * ((15 + N_IDS + 6 + 14 + N_CH + 4) * a
                + (1 + 14 + N_CH + 4) * (n_lanes - a)
                + 2 * N_CH * (n_stream - n_lanes) + n_scal)
