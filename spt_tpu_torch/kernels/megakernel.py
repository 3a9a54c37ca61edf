"""Forward megakernel K1: fused render of scenes of at most 128 spheres.

The port of ``spt_tpu.kernels.megakernel``.  One launch renders ``spp``
samples of every pixel: jittered pinhole or thin-lens raygen, then
``max_bounces`` bounces of ``physics.trace_bounce`` (nearest sphere,
emission + MIS, NEE with a sphere-cone light sample and a shadow test,
Lambert / GGX / dielectric, Russian roulette), summed over the samples in
order s = 0 … spp-1.

* ``megakernel_fwd`` is the kernel's wrapper.  On CUDA tensors it launches
  the hand-written kernel ``csrc/megakernel.cu`` and raises if it cannot;
  on CPU tensors it runs ``render_tiles_plain``.
* ``render_tiles_plain`` is the plain PyTorch version: the same raygen as
  the kernel, then ``physics.trace_bounce``.
* ``render_tiles`` packs a scene and camera and calls the wrapper; it is
  what the engine calls.

``LAUNCHES`` counts K1 launches (``"k1"``) and plain-version runs
(``"plain"``), so a caller can see which path a render took.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..core import rng
from ..core.scene import SceneData
from . import physics

_NDIMS = physics.N_DIMS
_CAM_SLOT = 0xFFFF * _NDIMS

# blob layout: camera at 0 (pos3, right3, up3, fwd3, tan_half_fov,
# aperture, focus_dist -> 15), then:
_SKY_OFF = 15         # horizon3, zenith3 -> 6
_SPH_OFF = 21         # per sphere: cx,cy,cz,r, ar,ag,ab, er,eg,eb, rough,ior
_SPH_STRIDE = 12
# meta layout: [start_sample, seed, n_lights, mtype*P, light_prim*max(L,1)]
_META_FIXED = 3

# The largest capacity K1 takes: its scene uniforms live in shared memory
# and every ray tests every sphere.
MAX_PRIMS = 128

LAUNCHES = {"k1": 0, "plain": 0}


def reset_launch_counts() -> None:
    for key in LAUNCHES:
        LAUNCHES[key] = 0


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def pack_scene_static(scene: SceneData):
    """Host-side static metadata: per-sphere material types + light prims."""
    valid = _np(scene.prim_valid)
    mat_id = _np(scene.mat_id)
    mtype = _np(scene.materials.mtype)
    mtypes = [int(mtype[mat_id[i]]) if valid[i] else 0
              for i in range(scene.capacity)]
    light_prims = [int(p) for p, ok in
                   zip(_np(scene.light_idx), _np(scene.light_valid)) if ok]
    return mtypes, light_prims


def pack_scene(scene: SceneData, camera):
    """Host-side packing of scene+camera uniforms -> (blob, mtypes, lights)."""
    cap = scene.capacity
    blob = np.zeros(_SPH_OFF + _SPH_STRIDE * cap, np.float32)
    blob[0:3] = _np(camera.position)
    blob[3:6] = _np(camera.right)
    blob[6:9] = _np(camera.up)
    blob[9:12] = _np(camera.forward)
    blob[12] = float(_np(camera.tan_half_fov))
    blob[13] = float(_np(getattr(camera, "aperture", 0.0)))
    blob[14] = float(_np(getattr(camera, "focus_dist", 1.0)))
    sky = _np(scene.sky_params)
    blob[_SKY_OFF:_SKY_OFF + 3] = sky[0]
    blob[_SKY_OFF + 3:_SKY_OFF + 6] = sky[1]
    centers, radii = _np(scene.centers), _np(scene.radii)
    valid, mat_id = _np(scene.prim_valid), _np(scene.mat_id)
    albedo = _np(scene.materials.albedo)
    emission = _np(scene.materials.emission)
    rough = _np(scene.materials.roughness)
    ior = _np(scene.materials.ior)
    for i in range(cap):
        off = _SPH_OFF + _SPH_STRIDE * i
        if valid[i]:
            m = int(mat_id[i])
            blob[off:off + 4] = [centers[i, 0], centers[i, 1], centers[i, 2],
                                 radii[i]]
            blob[off + 4:off + 7] = albedo[m]
            blob[off + 7:off + 10] = emission[m]
            blob[off + 10] = rough[m]
            blob[off + 11] = ior[m]
        else:
            blob[off + 11] = 1.5
    mtypes, light_prims = pack_scene_static(scene)
    return blob, mtypes, light_prims


def pack_meta(start_sample: int, seed: int, mtypes, light_prims) -> np.ndarray:
    """The int32 meta vector: [start_sample, seed, n_lights, mtypes, lights]."""
    n_prims = len(mtypes)
    meta = np.zeros(_META_FIXED + n_prims + max(len(light_prims), 1), np.int32)
    meta[0] = start_sample
    meta[1] = seed
    meta[2] = len(light_prims)
    meta[_META_FIXED:_META_FIXED + n_prims] = np.asarray(mtypes, np.int32)
    for i, p in enumerate(light_prims):
        meta[_META_FIXED + n_prims + i] = p
    return meta


def _f32(x: float) -> float:
    """The float32 rounding of a Python double, as JAX folds constants."""
    return float(np.float32(x))


def render_tiles_plain(blob: torch.Tensor, meta: torch.Tensor,
                       lsb: torch.Tensor, *, width: int, height: int,
                       spp: int, n_prims: int, n_light_slots: int,
                       max_bounces: int, rr_depth: int, use_nee: bool,
                       use_mis: bool, sky_mode: int, dof: bool,
                       stats: dict | None = None) -> torch.Tensor:
    """Plain PyTorch version of K1 on the packed uniforms -> (H, W, 3).

    ``stats``, if given, receives per-bounce counts summed over the samples
    (lists of ints): ``"active"`` rays traced, ``"hit"`` rays that hit, and
    ``"shadow"`` shadow rays K1 traces (NEE on a non-dielectric hit); and
    ``"paths"``, the number of camera paths."""
    LAUNCHES["plain"] += 1
    dev = blob.device
    meta_h = _np(meta).astype(np.int64)
    start_sample, seed, nl = int(meta_h[0]), int(meta_h[1]) & rng.MASK32, \
        int(meta_h[2])
    mtypes = meta[_META_FIXED:_META_FIXED + n_prims].to(torch.int32)
    spheres = blob[_SPH_OFF:_SPH_OFF + _SPH_STRIDE * n_prims].reshape(
        n_prims, _SPH_STRIDE)
    sky = blob[_SKY_OFF:_SKY_OFF + 6]
    lprims = meta[_META_FIXED + n_prims:
                  _META_FIXED + n_prims + n_light_slots].long()
    lights = spheres[lprims][:, list(physics.LIGHT_TO_SPHERE_ATTR)]
    theta = (spheres, sky, lights)
    lsel_lo = tuple(lsb[a] for a in range(3))
    lsel_ext = tuple(lsb[3 + a] for a in range(3))

    n_pix = width * height
    pid = torch.arange(n_pix, dtype=torch.int64, device=dev)
    px = (pid % width).to(torch.float32)
    py = (pid // width).to(torch.float32)
    aspect, inv_w, inv_h = (_f32(width / height), _f32(1.0 / width),
                            _f32(1.0 / height))
    tanf = blob[12]
    acc = torch.zeros(3, n_pix, dtype=torch.float32, device=dev)
    if stats is not None:
        act_n, hit_n, shadow_n = (
            torch.zeros(max_bounces, dtype=torch.int64, device=dev)
            for _ in range(3))

    for s in range(spp):
        sample = (start_sample + s) & rng.MASK32

        def u(dim):
            return rng.counter_uniform(pid, sample, dim, seed)

        # Camera ray generation, as the kernel does it (1/width multiply).
        jx, jy = u(_CAM_SLOT + 0), u(_CAM_SLOT + 1)
        sx = (px + jx) * inv_w
        sy = (py + jy) * inv_h
        ndc_x = (2.0 * sx - 1.0) * aspect * tanf
        ndc_y = (1.0 - 2.0 * sy) * tanf
        dx = ndc_x * blob[3] + ndc_y * blob[6] + blob[9]
        dy = ndc_x * blob[4] + ndc_y * blob[7] + blob[10]
        dz = ndc_x * blob[5] + ndc_y * blob[8] + blob[11]
        dx, dy, dz = physics._normalize(dx, dy, dz)
        ox, oy, oz = (blob[a].expand(n_pix) for a in range(3))
        if dof:
            lu, lv = u(_CAM_SLOT + 2), u(_CAM_SLOT + 3)
            r = blob[13] * torch.sqrt(lu)
            phi = _f32(2.0 * np.pi) * lv
            cphi, sphi = torch.cos(phi), torch.sin(phi)
            offx = r * (cphi * blob[3] + sphi * blob[6])
            offy = r * (cphi * blob[4] + sphi * blob[7])
            offz = r * (cphi * blob[5] + sphi * blob[8])
            denom = torch.clamp_min(
                dx * blob[9] + dy * blob[10] + dz * blob[11], 1e-6)
            tf = blob[14] / denom
            fx, fy, fz = ox + dx * tf, oy + dy * tf, oz + dz * tf
            ox, oy, oz = ox + offx, oy + offy, oz + offz
            dx, dy, dz = physics._normalize(fx - ox, fy - oy, fz - oz)

        ones = torch.ones_like(dx)
        zero = torch.zeros_like(dx)
        state = (ox, oy, oz, dx, dy, dz, ones, ones, ones, zero, zero, zero,
                 zero)
        aux = (torch.ones(n_pix, dtype=torch.bool, device=dev),
               torch.ones(n_pix, dtype=torch.bool, device=dev))
        for k in range(max_bounces):
            uni = dict(rr=u(k * _NDIMS + physics.DIM_RR),
                       u1=u(k * _NDIMS + physics.DIM_U1),
                       u2=u(k * _NDIMS + physics.DIM_U2),
                       lobe=u(k * _NDIMS + physics.DIM_LOBE),
                       lu1=u(k * _NDIMS + physics.DIM_LU1),
                       lu2=u(k * _NDIMS + physics.DIM_LU2),
                       lsel_lo=lsel_lo, lsel_ext=lsel_ext,
                       sample=sample, seed=seed)
            cfg = physics.BounceCfg(
                mtypes=mtypes, k=k, rr_depth=rr_depth, use_nee=use_nee,
                use_mis=use_mis, sky_mode=sky_mode,
                n_light_slots=n_light_slots)
            if stats is not None:
                t, _, _, _, m_die, _ = physics.intersect_spheres_unrolled(
                    spheres, mtypes, *state[:6])
                hit = aux[0] & (t < physics.BIG)
                act_n[k] += aux[0].sum()
                hit_n[k] += hit.sum()
                shadow_n[k] += (hit & ~m_die).sum()
            state, aux = physics.trace_bounce(theta, state, aux, uni, nl, cfg)
        acc[0] += state[9]
        acc[1] += state[10]
        acc[2] += state[11]

    if stats is not None:
        nee = use_nee and n_light_slots > 0 and nl > 0
        stats["active"] = act_n.tolist()
        stats["hit"] = hit_n.tolist()
        stats["shadow"] = shadow_n.tolist() if nee else [0] * max_bounces
        stats["paths"] = n_pix * spp
    return acc.T.reshape(height, width, 3)


# fp32 operations of K1 (csrc/megakernel.cu, csrc/physics.cuh), counted by
# hand from the code: add, sub, mul, div, sqrt, sin, cos, min/max and
# compare each count one.  Only the work every instance of a step does is
# counted (e.g. a sphere test whose discriminant is negative stops after 18
# operations), so the total is a lower count of what the data needs.
K1_OPS = dict(
    raygen=38,          # jitter, NDC, basis, normalize (pinhole)
    sphere_test=18,     # one ray against one sphere, up to the disc test
    miss=6,             # radiance += throughput * sky
    hit=116,            # hit point, normal, emission test, ONB, Lambert
                        # sample and pdf, throughput, next origin
    shadow=142,         # light-cell key, light pick, cone sample, ONB,
                        # shadow ray and its t_max (sphere tests apart)
)


def k1_op_count(stats: dict, n_prims: int) -> int:
    """Lower count of K1's fp32 operations for the work in ``stats``
    (``render_tiles_plain(..., stats=...)`` on the same inputs)."""
    active, hit, shadow = (sum(stats[k]) for k in ("active", "hit", "shadow"))
    return (stats["paths"] * K1_OPS["raygen"]
            + active * n_prims * K1_OPS["sphere_test"]
            + (active - hit) * K1_OPS["miss"]
            + hit * K1_OPS["hit"]
            + shadow * (K1_OPS["shadow"] + n_prims * K1_OPS["sphere_test"]))


def _check(t: torch.Tensor, name: str, dtype, numel: int) -> None:
    if t.dtype != dtype or t.numel() != numel or not t.is_contiguous():
        raise ValueError(f"{name}: want a contiguous {dtype} tensor of "
                         f"{numel} elements, got {t.dtype} {tuple(t.shape)}")


def megakernel_fwd(blob: torch.Tensor, meta: torch.Tensor, lsb: torch.Tensor,
                   *, width: int, height: int, spp: int, n_prims: int,
                   n_light_slots: int, max_bounces: int, rr_depth: int,
                   use_nee: bool, use_mis: bool, sky_mode: int,
                   dof: bool) -> torch.Tensor:
    """K1's wrapper: (H, W, 3) float32 radiance sum over ``spp`` samples.

    CUDA tensors launch the CUDA kernel on the current stream; CPU tensors
    take ``render_tiles_plain``."""
    kw = dict(width=width, height=height, spp=spp, n_prims=n_prims,
              n_light_slots=n_light_slots, max_bounces=max_bounces,
              rr_depth=rr_depth, use_nee=use_nee, use_mis=use_mis,
              sky_mode=sky_mode, dof=dof)
    if blob.device.type == "cpu":
        return render_tiles_plain(blob, meta, lsb, **kw)
    if blob.device.type != "cuda":
        raise NotImplementedError(f"K1 has no kernel for {blob.device}")
    if not (meta.device == blob.device == lsb.device):
        raise ValueError("blob, meta and lsb must lie on one device")
    if n_prims > MAX_PRIMS:
        raise ValueError(f"K1 takes at most {MAX_PRIMS} spheres, got {n_prims}")
    _check(blob, "blob", torch.float32, _SPH_OFF + _SPH_STRIDE * n_prims)
    _check(meta, "meta", torch.int32,
           _META_FIXED + n_prims + max(n_light_slots, 1))
    _check(lsb, "lsb", torch.float32, 6)
    from ._build import load_library
    lib = load_library()
    out = torch.empty((height, width, 3), dtype=torch.float32,
                      device=blob.device)
    with torch.cuda.device(blob.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.spt_megakernel_fwd(
            out.data_ptr(), blob.data_ptr(), meta.data_ptr(), lsb.data_ptr(),
            width, height, spp, n_prims, n_light_slots, max_bounces,
            rr_depth, int(bool(use_nee)), int(bool(use_mis)), int(sky_mode),
            int(bool(dof)), ctypes.c_float(_f32(1.0 / width)),
            ctypes.c_float(_f32(1.0 / height)),
            ctypes.c_float(_f32(width / height)), stream)
    if err != 0:
        raise RuntimeError(f"K1 launch failed: CUDA error {err}")
    LAUNCHES["k1"] += 1
    return out


def counter_bits_cuda(pixel: torch.Tensor, sample: torch.Tensor,
                      dim: torch.Tensor, seed: torch.Tensor) -> torch.Tensor:
    """K1's ``__device__`` counter hash over CUDA tensors of uint32 values
    (as int64), for checking its bits against ``rng.counter_bits``."""
    args = [rng.to_int32_bits(t).contiguous() for t in (pixel, sample, dim,
                                                        seed)]
    if any(a.device.type != "cuda" or a.shape != args[0].shape for a in args):
        raise ValueError("counter_bits_cuda takes CUDA tensors of one shape")
    from ._build import load_library
    lib = load_library()
    out = torch.empty_like(args[0])
    with torch.cuda.device(out.device):
        err = lib.spt_counter_bits(
            out.data_ptr(), *(a.data_ptr() for a in args), out.numel(),
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"spt_counter_bits launch failed: CUDA error {err}")
    return out.to(torch.int64) & rng.MASK32


def pack_uniforms(scene: SceneData, camera, start_sample: int, seed: int):
    """(blob, meta, lsb) tensors on the scene's device + static ints."""
    blob, mtypes, light_prims = pack_scene(scene, camera)
    meta = pack_meta(start_sample, seed, mtypes, light_prims)
    dev = scene.device
    lsb = physics.lsel_bounds(scene.centers, scene.radii, scene.prim_valid)
    return (torch.from_numpy(blob).to(dev), torch.from_numpy(meta).to(dev),
            lsb.to(dev), dict(n_prims=scene.capacity,
                              n_light_slots=len(light_prims)))


def render_tiles(scene: SceneData, camera, width: int, height: int,
                 start_sample: int, spp: int, *, max_bounces=8, rr_depth=3,
                 use_nee=True, use_mis=True, seed=0, dof=None) -> torch.Tensor:
    """Render ``spp`` samples with K1; returns the (H, W, 3) radiance sum.

    Runs on the scene's device: the CUDA kernel for a scene on the card,
    the plain version for a scene on the CPU."""
    blob, meta, lsb, static = pack_uniforms(scene, camera, start_sample, seed)
    if dof is None:  # auto: thin-lens iff the camera has a real aperture
        dof = bool(float(_np(camera.aperture)) > 0.0)
    return megakernel_fwd(
        blob, meta, lsb, width=width, height=height, spp=spp,
        max_bounces=max_bounces, rr_depth=rr_depth, use_nee=bool(use_nee),
        use_mis=bool(use_mis), sky_mode=scene.sky_mode, dof=bool(dof),
        **static)
