"""Fused forward+backward BVH kernel K4: large-scene gradients, 129-2048 prims.

The port of ``spt_tpu.kernels.megakernel_bvh_grad``.  One launch renders
``spp`` samples of every pixel exactly as K3 does (the radiance sum) and
returns the gradient of ``sum(ct * image)`` with respect to the scalar
uniforms (``grad_s``: sky, material table, light slots, in the blob's order)
and to every leaf slot's centre and radius (``grad_g``, (n_blocks, 8,
block), rows cx cy cz r).  The forward sweep walks the tree as K3 does and
records each bounce's entry state, its winner (centre, radius, material
id, leaf block and slot) and its NEE shadow verdict.  The backward sweep
never walks: it replays each bounce through the adjoint of a bounce whose
hit is rebuilt from the recorded winner (``physics_adjoint.
rebuilt_bounce_vjp``; the TPU's ``_rebuilt_intersect`` under ``jax.vjp``)
and adds the winner's geometry cotangent at its (block, slot).

A padding slot that wins takes K1's row of an invalid sphere, as in K3
(``megakernel_bvh._resolve``); it is recorded as material ``n_mats`` and
gets no geometry gradient.

* ``megakernel_bvh_grad`` is the kernel's wrapper.  On CUDA tensors it
  launches ``csrc/megakernel_bvh_grad.cu`` and raises if it cannot; on CPU
  tensors it runs ``render_and_grad_bvh_plain``.
* ``render_and_grad_bvh`` runs it on a scene and a camera and maps the raw
  gradients to the scene's parameters by hand (``map_raw_grads``: the
  leaf slots back to their spheres, each light slot folded into its
  sphere and its material's emission), as JAX's does.  Under autograd the
  raw gradients reach the parameters through the packers instead
  (``diff/cuda_diff.py``, ``megakernel_bvh.pack_blob_torch`` and
  ``pack_prims_torch``): ``make_cuda_render_fn(..., engine="fused")`` and
  ``.backward()``.
* ``swizzle_ct`` lays an (H, W, 3) cotangent out in the kernel's 32x32
  pixel tiles, as JAX's does.

``megakernel.LAUNCHES["k4"]`` counts K4 launches; plain runs count under
``"plain"``.
"""

from __future__ import annotations

import ctypes

import torch

from ..core import rng
from ..core.scene import SKY_ENVMAP, SceneData
from . import physics
from .megakernel import (K1_OPS, LAUNCHES, PlainScene, _check, _f32,
                         camera_paths)
from .megakernel_bvh import (BIG, BLOCK, _LIGHT_STRIDE, _MAT_OFF,
                             _MAT_STRIDE, _N_PRIM_ATTRS, _Walk, k3_op_count,
                             packed)
from .megakernel_grad import K2_OPS, MAX_DEPTH, N_SKY_ATTRS, N_STATE
from .physics_adjoint import rebuilt_bounce_vjp, winner_tables

N_HIT = 8            # recorded per bounce: hcx hcy hcz hr hmid hblk hslot blocked
TILE_ROWS, TILE_LANES = 8, 128   # the cotangent's layout: one 32x32 pixel
TW = TH = 32                     # tile per 8 x 128 rows, as JAX's


def swizzle_ct(ct_image, width: int, height: int) -> torch.Tensor:
    """(H, W, 3) cotangent image -> (3, tiles * 8, 128): pixel tiles of
    32x32 in row-major tile order, each tile's pixels row by row.  JAX's
    ``swizzle_ct``, bit for bit."""
    tiles_x, tiles_y = -(-width // TW), -(-height // TH)
    ct = torch.as_tensor(ct_image, dtype=torch.float32).permute(2, 0, 1)
    ct = torch.nn.functional.pad(ct, (0, tiles_x * TW - width,
                                      0, tiles_y * TH - height))
    ct = ct.reshape(3, tiles_y, TH, tiles_x, TW).permute(0, 1, 3, 2, 4)
    return ct.reshape(3, tiles_y * tiles_x * TILE_ROWS,
                      TILE_LANES).contiguous()


def _ct_pixels(ct, width: int, height: int) -> torch.Tensor:
    """The swizzled cotangent's (3, H * W) values by pixel id."""
    tiles_x = -(-width // TW)
    pid = torch.arange(width * height, device=ct.device)
    px, py = pid % width, pid // width
    lane = ((py // TH) * tiles_x + px // TW) * (TW * TH) \
        + (py % TH) * TW + px % TW
    return ct.reshape(3, -1)[:, lane]


def n_scalars(n_mats: int, n_light_slots: int) -> int:
    """Length of ``grad_s``: sky, material rows, light slots."""
    return N_SKY_ATTRS + _MAT_STRIDE * n_mats + _LIGHT_STRIDE * n_light_slots


def _record(walk: _Walk, t, win, n_mats: int) -> torch.Tensor:
    """The (8, N) winner record of a nearest-hit walk: centre, radius,
    material id (-1 on a miss, ``n_mats`` for a padding slot), leaf block,
    slot; row 7 (the blocked mask) zero."""
    found = t < BIG
    slot = torch.clamp_min(win, 0)
    blk, j = slot // walk.block, slot % walk.block
    row = walk.prims[blk, :, j]                              # (N, 5)
    res = torch.zeros((N_HIT, t.shape[0]), dtype=torch.float32,
                      device=t.device)
    for a in range(4):
        res[a] = torch.where(found, row[:, a], 0.0)
    mid = torch.where(row[:, 4] < 0.0, float(n_mats), row[:, 4])
    res[4] = torch.where(found, mid, -1.0)
    res[5] = torch.where(found, blk.to(torch.float32), -1.0)
    res[6] = torch.where(found, j.to(torch.float32), -1.0)
    return res


def render_and_grad_bvh_plain(blob: torch.Tensor, meta: torch.Tensor,
                              lsb: torch.Tensor, nodef: torch.Tensor,
                              nodei: torch.Tensor, prims: torch.Tensor,
                              mtypes: torch.Tensor, ct: torch.Tensor, *,
                              width: int, height: int, spp: int, block: int,
                              n_mats: int, n_light_slots: int,
                              max_bounces: int, rr_depth: int, use_nee: bool,
                              use_mis: bool, sky_mode: int, dof: bool,
                              stats: dict | None = None):
    """Plain PyTorch version of K4 -> (image (H, W, 3) radiance sum, grad_s
    (n_scal,), grad_g (n_blocks, 8, block)), the gradients of ``sum(ct *
    image)``; ``ct`` in ``swizzle_ct``'s layout.  The image is
    ``render_tiles_bvh_plain``'s, bit for bit: the recorded winner's
    quadratic gives the walk's distance again.  ``stats``, if given, gets
    ``"winners"`` (recorded hits) and ``"padding_winners"`` (hits on a
    padding slot) added."""
    from .wavefront import _rebuilt_intersect
    LAUNCHES["plain"] += 1
    dev = blob.device
    light_off = _MAT_OFF + _MAT_STRIDE * n_mats
    lights = blob[light_off:light_off + _LIGHT_STRIDE * n_light_slots] \
        .reshape(n_light_slots, _LIGHT_STRIDE)
    sc = PlainScene(blob, meta, lsb, 0, n_light_slots, lights=lights)
    sky = blob[15:21]
    mats = blob[_MAT_OFF:light_off].reshape(n_mats, _MAT_STRIDE)
    mtypes = mtypes.long()
    mats_x, mtypes_x = winner_tables(mats, mtypes)
    walk = _Walk(nodef.reshape(-1, 8), nodei.reshape(-1, 8).long(),
                 prims.reshape(-1, _N_PRIM_ATTRS, block), block)
    n_blocks = walk.prims.shape[0]
    n_pix = width * height
    acc = torch.zeros(3, n_pix, dtype=torch.float32, device=dev)
    ct_pix = _ct_pixels(ct.to(torch.float32), width, height)
    sky_ct = torch.zeros(N_SKY_ATTRS, dtype=torch.float32, device=dev)
    mats_ct = torch.zeros_like(mats)
    lights_ct = torch.zeros_like(lights)
    grad_g = torch.zeros((n_blocks + 1) * 8 * block, dtype=torch.float32,
                         device=dev)
    for s in range(spp):
        sample = (sc.start_sample + s) & rng.MASK32
        pid, state, aux = camera_paths(blob, sample, width=width,
                                       height=height, seed=sc.seed, dof=dof)
        kept = []
        for k in range(max_bounces):
            cfg = physics.BounceCfg(
                mtypes=(), k=k, rr_depth=rr_depth, use_nee=use_nee,
                use_mis=use_mis, sky_mode=sky_mode,
                n_light_slots=n_light_slots)
            u = sc.uniforms(pid, sample, k)
            rec = {}

            def intersect(ox, oy, oz, dx, dy, dz, active, rec=rec):
                t, win, _, _ = walk.nearest((ox, oy, oz), (dx, dy, dz),
                                            active)
                rec["res"] = _record(walk, t, win, n_mats)
                return _rebuilt_intersect(mats_x, mtypes_x, rec["res"])(
                    ox, oy, oz, dx, dy, dz, active)

            def occluded(ox, oy, oz, dx, dy, dz, tmax, need, rec=rec):
                rec["blocked"] = walk.anyhit((ox, oy, oz), (dx, dy, dz),
                                             tmax, need)[0]
                return rec["blocked"]

            new_state, new_aux = physics.trace_bounce(
                sc.theta, state, aux, u, sc.nl, cfg, intersect, occluded)
            res = rec["res"]
            if stats is not None:
                for name, lanes in (("winners", res[4] >= 0.0),
                                    ("padding_winners", res[4] == n_mats)):
                    stats[name] = stats.get(name, 0) + int(lanes.sum())
            if "blocked" in rec:
                res[7] = rec["blocked"].to(torch.float32)
            kept.append((state, aux, u, cfg, res))
            state, aux = new_state, new_aux
        acc[0] += state[9]
        acc[1] += state[10]
        acc[2] += state[11]
        zero = torch.zeros_like(state[0])
        state_ct = [zero] * N_STATE
        state_ct[9:12] = ct_pix
        for st_k, aux_k, u, cfg, res in reversed(kept):
            d_sky, d_mats, d_lights, dgeo, state_ct = rebuilt_bounce_vjp(
                sky, mats, mtypes, lights, res, st_k, aux_k, u, sc.nl, cfg,
                state_ct)
            sky_ct += d_sky
            mats_ct += d_mats
            lights_ct += d_lights
            own = (res[4] >= 0.0) & (res[4] < n_mats)
            blk = torch.where(own, res[5].long(), n_blocks)
            base = blk * 8 * block + res[6].long().clamp_min(0)
            for a in range(4):
                grad_g.index_add_(0, base + a * block, dgeo[a])
    grad_s = torch.cat([sky_ct, mats_ct.reshape(-1), lights_ct.reshape(-1)])
    return (acc.T.reshape(height, width, 3), grad_s,
            grad_g.reshape(n_blocks + 1, 8, block)[:n_blocks])


def megakernel_bvh_grad(blob: torch.Tensor, meta: torch.Tensor,
                        lsb: torch.Tensor, nodef: torch.Tensor,
                        nodei: torch.Tensor, prims: torch.Tensor,
                        mtypes: torch.Tensor, ct: torch.Tensor, *,
                        width: int, height: int, spp: int, block: int,
                        n_mats: int, n_light_slots: int, max_bounces: int,
                        rr_depth: int, use_nee: bool, use_mis: bool,
                        sky_mode: int, dof: bool):
    """K4's wrapper -> (image (H, W, 3) radiance sum over ``spp`` samples,
    grad_s (n_scal,), grad_g (n_blocks, 8, block)).  ``ct`` is the image's
    cotangent in ``swizzle_ct``'s layout.

    CUDA tensors launch the CUDA kernel on the current stream; CPU tensors
    take ``render_and_grad_bvh_plain``.  Depth above ``MAX_DEPTH`` raises."""
    kw = dict(width=width, height=height, spp=spp, block=block,
              n_mats=n_mats, n_light_slots=n_light_slots,
              max_bounces=max_bounces, rr_depth=rr_depth, use_nee=use_nee,
              use_mis=use_mis, sky_mode=sky_mode, dof=dof)
    args = (blob, meta, lsb, nodef, nodei, prims, mtypes, ct)
    if max_bounces > MAX_DEPTH:
        raise ValueError(f"K4 keeps at most {MAX_DEPTH} bounces per path, "
                         f"got max_bounces={max_bounces}")
    if blob.device.type == "cpu":
        return render_and_grad_bvh_plain(*args, **kw)
    if blob.device.type != "cuda":
        raise NotImplementedError(f"K4 has no kernel for {blob.device}")
    if any(a.device != blob.device for a in args):
        raise ValueError("K4's inputs must lie on one device")
    n_rows = nodef.numel() // 8
    if n_rows == 0 or n_rows % 8 or block <= 0 \
            or prims.numel() % (_N_PRIM_ATTRS * block):
        raise ValueError(f"K4: nodef of {nodef.numel()} floats and prims of "
                         f"{prims.numel()} floats at block {block}")
    n_blocks = prims.numel() // (_N_PRIM_ATTRS * block)
    n_tiles = -(-width // TW) * -(-height // TH)
    _check(blob, "blob", torch.float32, _MAT_OFF + _MAT_STRIDE * n_mats
           + _LIGHT_STRIDE * max(n_light_slots, 1))
    _check(meta, "meta", torch.int32, 3)
    _check(lsb, "lsb", torch.float32, 6)
    _check(nodef, "nodef", torch.float32, 8 * n_rows)
    _check(nodei, "nodei", torch.int32, 8 * n_rows)
    _check(prims, "prims", torch.float32, _N_PRIM_ATTRS * block * n_blocks)
    _check(mtypes, "mtypes", torch.int32, n_mats)
    _check(ct, "ct", torch.float32, 3 * n_tiles * TW * TH)
    if nodef.data_ptr() % 16 or nodei.data_ptr() % 8:
        raise ValueError("K4 reads node rows as float4 / int2: nodef must be "
                         "16-byte and nodei 8-byte aligned")
    from ._build import load_library
    lib = load_library("megakernel_bvh_grad")
    img = torch.empty((height, width, 3), dtype=torch.float32,
                      device=blob.device)
    grad_s = torch.zeros(n_scalars(n_mats, n_light_slots),
                         dtype=torch.float32, device=blob.device)
    grad_g = torch.zeros((n_blocks, 8, block), dtype=torch.float32,
                         device=blob.device)
    with torch.cuda.device(blob.device):
        err = lib.spt_megakernel_bvh_grad(
            img.data_ptr(), grad_s.data_ptr(), grad_g.data_ptr(),
            *(a.data_ptr() for a in args), width, height, spp, n_rows // 8,
            block, n_mats, n_light_slots, max_bounces, rr_depth,
            int(bool(use_nee)), int(bool(use_mis)), int(sky_mode),
            int(bool(dof)), ctypes.c_float(_f32(1.0 / width)),
            ctypes.c_float(_f32(1.0 / height)),
            ctypes.c_float(_f32(width / height)),
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"K4 launch failed: CUDA error {err}")
    LAUNCHES["k4"] += 1
    return img, grad_s, grad_g


def render_and_grad_bvh(scene: SceneData, camera, width: int, height: int,
                        start_sample: int, spp: int, *, ct_image=None,
                        max_bounces: int = 8, rr_depth: int = 3,
                        use_nee: bool = True, use_mis: bool = True,
                        seed: int = 0, dof=None, block: int = BLOCK):
    """K3's render and K4's backward in one launch on the scene's device
    -> (radiance sum (H, W, 3), grads): the gradients of ``sum(ct_image *
    radiance_sum)`` (``ct_image`` (H, W, 3), ones by default), keyed as
    JAX's: ``"centers"`` (P, 3), ``"radii"`` (P,), ``"albedo"`` and
    ``"emission"`` (M, 3), ``"roughness"`` and ``"ior"`` (M,),
    ``"sky_params"`` (2, 3).  ``dof=None`` takes the thin lens iff the
    camera has an aperture.  On the CPU the plain version runs.

    K3 and K4 shade a miss by the sky's formula: a scene under an
    environment map raises ValueError (JAX's K4 drops the map)."""
    if scene.sky_mode == SKY_ENVMAP:
        raise ValueError("render_and_grad_bvh cannot render an environment-"
                         "map sky: K3 and K4 shade a miss by the sky's "
                         "formula; make_cuda_render_fn routes such a scene "
                         "to the differentiable wavefront")
    t, static = packed(scene, camera, block)
    if dof is None:
        dof = bool(float(camera.aperture) > 0.0)
    dev = scene.device
    meta = torch.tensor([start_sample, seed, static["n_light_slots"]],
                        dtype=torch.int32).to(dev)
    if ct_image is None:
        ct_image = torch.ones((height, width, 3), dtype=torch.float32)
    ct = swizzle_ct(torch.as_tensor(ct_image).to(dev), width, height)
    img, grad_s, grad_g = megakernel_bvh_grad(
        t["blob"], meta, t["lsb"], t["nodef"], t["nodei"], t["prims"],
        t["mtypes"], ct, width=width, height=height, spp=spp, block=block,
        n_mats=static["n_mats"], n_light_slots=static["n_light_slots"],
        max_bounces=max_bounces, rr_depth=rr_depth, use_nee=bool(use_nee),
        use_mis=bool(use_mis), sky_mode=scene.sky_mode, dof=bool(dof))
    return img, map_raw_grads(scene, static, grad_s, grad_g)


def map_raw_grads(scene: SceneData, static: dict, grad_s: torch.Tensor,
                  grad_g: torch.Tensor) -> dict:
    """K4's raw gradients -> the scene parameters' (JAX's
    ``map_raw_grads``): the sky and material rows of ``grad_s`` as they
    lie; each filled leaf slot's centre and radius of ``grad_g`` added to
    its sphere (``static["block_prim_ids"]``); each light slot's centre
    and radius added to its sphere and its emission to its material's."""
    n_mats, n_l = static["n_mats"], static["n_light_slots"]
    dev = grad_s.device
    sky = grad_s[:N_SKY_ATTRS].reshape(2, 3)
    mats = grad_s[N_SKY_ATTRS:N_SKY_ATTRS + _MAT_STRIDE * n_mats].reshape(
        n_mats, _MAT_STRIDE)
    emission = mats[:, 3:6].clone()
    ids = torch.as_tensor(static["block_prim_ids"], dtype=torch.int64,
                          device=dev).reshape(-1)
    ok = ids >= 0
    geo = grad_g[:, 0:4].permute(0, 2, 1).reshape(-1, 4)[ok]
    per_prim = torch.zeros((scene.capacity, 4), dtype=torch.float32,
                           device=dev).index_add_(0, ids[ok], geo)
    if n_l:
        lights = grad_s[N_SKY_ATTRS + _MAT_STRIDE * n_mats:].reshape(
            n_l, _LIGHT_STRIDE)
        prims = torch.as_tensor(static["light_prims"], dtype=torch.int64,
                                device=dev)
        per_prim.index_add_(0, prims, lights[:, 0:4])
        emission.index_add_(0, scene.mat_id[prims].long(), lights[:, 4:7])
    return {"centers": per_prim[:, 0:3], "radii": per_prim[:, 3],
            "albedo": mats[:, 0:3], "emission": emission,
            "roughness": mats[:, 6], "ior": mats[:, 7], "sky_params": sky}


# fp32 operations of K4 (csrc/megakernel_bvh_grad.cu), counted by hand as
# K2_OPS are: K3's forward sweep; then, for every bounce a path ran, the
# bounce again on its recorded winner (K1's shading, the rebuilt winner's
# quadratic, no walk) and its adjoint, at K2's per-lane counts.  A lower
# count of what the data needs.
K4_OPS = dict(rebuild=20)


def k4_op_count(stats: dict) -> int:
    """Lower count of K4's fp32 operations for the work in ``stats``
    (``megakernel_bvh.render_tiles_bvh_plain(..., stats=...)`` on the same
    inputs)."""
    active, hit, shadow, lit = (sum(stats[k]) for k in
                                ("active", "hit", "shadow", "lit"))
    replay = ((active - hit) * K1_OPS["miss"]
              + hit * (K1_OPS["hit"] + K4_OPS["rebuild"])
              + shadow * K1_OPS["shadow"])
    return (k3_op_count(stats) + replay + hit * K2_OPS["hit"]
            + lit * K2_OPS["lit"])
