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
  the kernel, then ``physics.trace_bounce``.  ``render_samples_plain`` is
  the same over any list of sample ids, and is differentiable with respect
  to the blob.
* ``render_tiles`` packs a scene and camera and calls the wrapper; it is
  what the engine calls.  ``pack_blob_torch`` packs the blob with tensor
  ops, for gradients with respect to the scene.
* The kernel is persistent and regenerates paths (``csrc/regen.cuh``).
  ``launch`` makes one launch from a given library (the tools build other
  sources), ``launch_config`` says its grid (asked once, as is the batch
  counter), ``lane_counts`` counts how busy K1 or K3 keeps its lanes (its
  counting instantiation), and
  ``lanes_busy`` estimates that share for one thread a pixel from the
  plain version's path lengths.

``LAUNCHES`` counts K1 launches (``"k1"``), K2 launches (``"k2"``, see
``megakernel_grad``), K3 launches (``"k3"``, see ``megakernel_bvh``), K4
launches (``"k4"``, see ``megakernel_bvh_grad``), the wavefront's K5, K6
and K7 launches (``"k5"``, ``"k6"``, ``"k7"``: K6's tree mode and K7's
shadow walks, the split path's; see ``wavefront``), its gradient's K9 and
K10 launches (``"k9"``, ``"k10"``, see ``wavefront_grad``), K6, K7, K8
and K9 over lists (``"k6l"``, ``"k7l"``, ``"k8l"``, ``"k9l"``), the
prim-sharded wavefront's K8 (its shadow verdicts, walking the shard's
tree, ``"k8"``) and K7 reading the verdicts merged over the shards
(``"k7b"``, see ``wavefront``),
the wavefront's matmul-form sweeps (``"k6m"``, ``"k7m"``, and
``"k7mv"`` K7m's verdict pass) and fused bounce
(``"k11"``, see ``wavefront``) and the fused bounce under grad
(``"k11g"``, see ``wavefront_grad``), and plain-version runs of any of them (``"plain"``: one per
call of a plain version, so a wavefront render on the CPU adds one per
raygen and two per bounce), so a caller can see which path a render took.
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

LAUNCHES = {"k1": 0, "k2": 0, "k3": 0, "k4": 0, "k5": 0, "k6": 0, "k7": 0,
            "k7b": 0, "k8": 0, "k9": 0, "k10": 0, "k6m": 0, "k7m": 0,
            "k7mv": 0, "k11": 0, "k11g": 0, "k6l": 0, "k7l": 0, "k8l": 0,
            "k9l": 0, "plain": 0}


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


def pack_blob_torch(scene: SceneData, camera) -> torch.Tensor:
    """The uniform blob (camera, sky, one 12-float row per sphere) as tensor
    ops on the scene's device, differentiable with respect to the scene's
    tensors: the counterpart of JAX's ``pack_blob_jnp``, and bit for bit
    its ``pack_scene`` blob.  Material rows are gathered by ``mat_id`` and
    multiplied by ``valid``; an invalid row holds ior 1.5.  Camera fields
    may be tensors or arrays."""
    dev = scene.device

    def field(v):
        if not isinstance(v, torch.Tensor):
            v = torch.from_numpy(np.array(v, np.float32))
        return v.to(dev, torch.float32).reshape(-1)

    cam = torch.cat([field(getattr(camera, f)) for f in (
        "position", "right", "up", "forward", "tan_half_fov", "aperture",
        "focus_dist")])
    valid = scene.prim_valid.to(torch.float32)[:, None]
    m = scene.mat_id.long()
    mats = scene.materials
    ior = torch.where(scene.prim_valid, mats.ior[m], 1.5)[:, None]
    rows = torch.cat([scene.centers * valid, scene.radii[:, None] * valid,
                      mats.albedo[m] * valid, mats.emission[m] * valid,
                      mats.roughness[m][:, None] * valid, ior], dim=1)
    return torch.cat([cam, scene.sky_params.reshape(-1), rows.reshape(-1)])


def pack_scene(scene: SceneData, camera):
    """Host-side packing of scene+camera uniforms -> (blob, mtypes, lights)."""
    mtypes, light_prims = pack_scene_static(scene)
    return _np(pack_blob_torch(scene, camera)), mtypes, light_prims


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


class PlainScene:
    """The packed uniforms as the plain versions read them: ``theta``
    (spheres (P, 12), sky (6,), lights (L, 7) gathered from the spheres),
    the live light count, seed, start sample and per-sphere material types,
    and the light-cell grid bounds.  ``lights`` (L, 7), where given, replaces
    the rows gathered from the spheres (the BVH blob keeps its own)."""

    def __init__(self, blob, meta, lsb, n_prims: int, n_light_slots: int,
                 lights=None):
        meta_h = _np(meta).astype(np.int64)
        self.start_sample = int(meta_h[0])
        self.seed = int(meta_h[1]) & rng.MASK32
        self.nl = int(meta_h[2])
        self.mtypes = meta[_META_FIXED:_META_FIXED + n_prims].to(torch.int32)
        self.light_prims = [int(p) for p in meta_h[
            _META_FIXED + n_prims:_META_FIXED + n_prims + n_light_slots]]
        spheres = blob[_SPH_OFF:_SPH_OFF + _SPH_STRIDE * n_prims].reshape(
            n_prims, _SPH_STRIDE)
        if lights is None:
            lights = spheres[self.light_prims][:, list(
                physics.LIGHT_TO_SPHERE_ATTR)]
        self.theta = (spheres, blob[_SKY_OFF:_SKY_OFF + 6], lights)
        self.lsel_lo = tuple(lsb[a] for a in range(3))
        self.lsel_ext = tuple(lsb[3 + a] for a in range(3))

    def uniforms(self, pid, sample, k: int) -> dict:
        """Bounce k's uniforms, keyed as K1 and K2 key them."""
        def u(dim):
            return rng.counter_uniform(pid, sample, k * _NDIMS + dim,
                                       self.seed)
        return dict(rr=u(physics.DIM_RR), u1=u(physics.DIM_U1),
                    u2=u(physics.DIM_U2), lobe=u(physics.DIM_LOBE),
                    lu1=u(physics.DIM_LU1), lu2=u(physics.DIM_LU2),
                    lsel_lo=self.lsel_lo, lsel_ext=self.lsel_ext,
                    sample=sample, seed=self.seed)


def camera_rays(blob, pid, px, py, sample, *, width: int, height: int,
                seed: int, dof: bool):
    """K1's jittered pinhole or thin-lens camera ray of each lane: pixel id
    ``pid`` (uint32 values as int64) at column ``px`` and row ``py``
    (float32), sample id ``sample`` (an int or per-lane values).  Returns
    (ox, oy, oz, dx, dy, dz)."""
    aspect, inv_w, inv_h = (_f32(width / height), _f32(1.0 / width),
                            _f32(1.0 / height))

    def u(dim):
        return rng.counter_uniform(pid, sample, dim, seed)

    # Camera ray generation, as the kernel does it (1/width multiply).
    tanf = blob[12]
    jx, jy = u(_CAM_SLOT + 0), u(_CAM_SLOT + 1)
    sx = (px + jx) * inv_w
    sy = (py + jy) * inv_h
    ndc_x = (2.0 * sx - 1.0) * aspect * tanf
    ndc_y = (1.0 - 2.0 * sy) * tanf
    dx = ndc_x * blob[3] + ndc_y * blob[6] + blob[9]
    dy = ndc_x * blob[4] + ndc_y * blob[7] + blob[10]
    dz = ndc_x * blob[5] + ndc_y * blob[8] + blob[11]
    dx, dy, dz = physics._normalize(dx, dy, dz)
    ox, oy, oz = (blob[a].expand(dx.shape) for a in range(3))
    if dof:
        lu, lv = u(_CAM_SLOT + 2), u(_CAM_SLOT + 3)
        r = blob[13] * torch.sqrt(lu)
        phi = _f32(2.0 * np.pi) * lv
        cphi, sphi = torch.cos(phi), torch.sin(phi)
        offx = r * (cphi * blob[3] + sphi * blob[6])
        offy = r * (cphi * blob[4] + sphi * blob[7])
        offz = r * (cphi * blob[5] + sphi * blob[8])
        denom = physics._max(
            dx * blob[9] + dy * blob[10] + dz * blob[11], 1e-6)
        tf = blob[14] / denom
        fx, fy, fz = ox + dx * tf, oy + dy * tf, oz + dz * tf
        ox, oy, oz = ox + offx, oy + offy, oz + offz
        dx, dy, dz = physics._normalize(fx - ox, fy - oy, fz - oz)
    return ox, oy, oz, dx, dy, dz


def camera_paths(blob, sample: int, *, width: int, height: int, seed: int,
                 dof: bool):
    """Entry state and masks of bounce 0 for every pixel of one sample:
    K1's jittered pinhole or thin-lens raygen.  Returns (pid, state, aux)."""
    dev = blob.device
    n_pix = width * height
    pid = torch.arange(n_pix, dtype=torch.int64, device=dev)
    px = (pid % width).to(torch.float32)
    py = (pid // width).to(torch.float32)
    rays = camera_rays(blob, pid, px, py, sample, width=width, height=height,
                       seed=seed, dof=dof)
    ones = torch.ones_like(rays[3])
    zero = torch.zeros_like(rays[3])
    state = (*rays, ones, ones, ones, zero, zero, zero, zero)
    aux = (torch.ones(n_pix, dtype=torch.bool, device=dev),
           torch.ones(n_pix, dtype=torch.bool, device=dev))
    return pid, state, aux


def render_samples_plain(blob: torch.Tensor, meta: torch.Tensor,
                         lsb: torch.Tensor, samples, *, width: int,
                         height: int, n_prims: int, n_light_slots: int,
                         max_bounces: int, rr_depth: int, use_nee: bool,
                         use_mis: bool, sky_mode: int, dof: bool,
                         stats: dict | None = None) -> torch.Tensor:
    """Plain PyTorch version of K1 over the given sample ids (uint32 values)
    -> (H, W, 3) radiance sum, samples added in the order given.

    Differentiable with ``torch.autograd`` with respect to ``blob``.
    ``stats``, if given, receives per-bounce counts summed over the samples
    (lists of ints): ``"active"`` rays traced, ``"hit"`` rays that hit,
    ``"shadow"`` shadow rays K1 traces (NEE on a non-dielectric hit) and
    ``"lit"`` lanes whose light sample arrives; and ``"paths"``, the number
    of camera paths; and ``"lengths"``, the bounces each path ran, a
    (samples, H, W) uint8 tensor (``lanes_busy`` reads it).  The counts are
    summed on the tensors' device."""
    LAUNCHES["plain"] += 1
    sc = PlainScene(blob, meta, lsb, n_prims, n_light_slots)
    return render_paths_plain(
        blob, sc, samples, width=width, height=height,
        n_light_slots=n_light_slots, max_bounces=max_bounces,
        rr_depth=rr_depth, use_nee=use_nee, use_mis=use_mis,
        sky_mode=sky_mode, dof=dof, stats=stats)


def render_paths_plain(blob: torch.Tensor, sc: PlainScene, samples, *,
                       width: int, height: int, n_light_slots: int,
                       max_bounces: int, rr_depth: int, use_nee: bool,
                       use_mis: bool, sky_mode: int, dof: bool,
                       stats: dict | None = None,
                       geometry=None) -> torch.Tensor:
    """The render loop of the plain versions: camera paths of every sample
    id, ``max_bounces`` bounces of ``physics.trace_bounce`` each, summed in
    the order given -> (H, W, 3).  ``geometry(k)``, where given, returns
    bounce k's ``(intersect_fn, occluded_fn)``; without it the bounce tests
    ``sc``'s sphere list.  ``stats`` as ``render_samples_plain``."""
    n_pix = width * height
    acc = torch.zeros(3, n_pix, dtype=torch.float32, device=blob.device)
    counts = None if stats is None else torch.zeros(
        max_bounces, 4, dtype=torch.int64, device=blob.device)
    lengths = None if stats is None else torch.zeros(
        len(samples), n_pix, dtype=torch.uint8, device=blob.device)
    nee = use_nee and n_light_slots > 0 and sc.nl > 0
    for i, s in enumerate(samples):
        sample = int(s) & rng.MASK32
        pid, state, aux = camera_paths(blob, sample, width=width,
                                       height=height, seed=sc.seed, dof=dof)
        for k in range(max_bounces):
            cfg = physics.BounceCfg(
                mtypes=sc.mtypes, k=k, rr_depth=rr_depth, use_nee=use_nee,
                use_mis=use_mis, sky_mode=sky_mode,
                n_light_slots=n_light_slots)
            active = aux[0]
            plug = (None, None) if geometry is None else geometry(k)
            state, aux, tape = physics.trace_bounce_tape(
                sc.theta, state, aux, sc.uniforms(pid, sample, k), sc.nl,
                cfg, *plug)
            if counts is not None:
                lengths[i] += active
                zero = torch.zeros_like(tape.hit)
                counts[k] += torch.stack([
                    active, tape.hit, tape.hit & ~tape.m_die if nee else zero,
                    tape.nee.nee_ok if nee else zero]).sum(1)
        acc[0] += state[9]
        acc[1] += state[10]
        acc[2] += state[11]
    if stats is not None:
        for name, row in zip(("active", "hit", "shadow", "lit"),
                             counts.T.tolist()):
            stats[name] = row
        stats["paths"] = n_pix * len(samples)
        stats["lengths"] = lengths.reshape(len(samples), height, width)
    return acc.T.reshape(height, width, 3)


def render_tiles_plain(blob: torch.Tensor, meta: torch.Tensor,
                       lsb: torch.Tensor, *, spp: int,
                       **kw) -> torch.Tensor:
    """Plain PyTorch version of K1 on the packed uniforms -> (H, W, 3):
    samples ``meta[0] .. meta[0] + spp - 1``, as the kernel renders them.
    Keywords and ``stats`` as ``render_samples_plain``."""
    start = int(_np(meta[0]))
    return render_samples_plain(blob, meta, lsb,
                                [start + s for s in range(spp)], **kw)


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


def lanes_busy(lengths: torch.Tensor, tile=None) -> dict:
    """How busy a warp's lanes keep when a warp runs its 32 lanes' paths of
    one sample together and waits for the longest, as K1 and K3 did before
    path regeneration: the lane-iterations that run a bounce (``busy``)
    against the 32 lanes times the iterations the warps run
    (``lane_slots``), and their ratio (``share``).

    ``lengths`` (samples, H, W): the bounces each path ran (the plain
    version's ``stats["lengths"]``).  ``tile=None`` groups 32 consecutive
    pixel ids into a warp (K1: a thread a pixel); ``tile=(8, 4)`` an 8x4
    pixel tile (K3).  Lanes past the image's edge are idle lanes of their
    warp."""
    n_s, h, w = lengths.shape
    runs = lengths.to(torch.int64)
    if tile is None:
        flat = runs.reshape(n_s, h * w)
        warps = torch.nn.functional.pad(flat, (0, -(h * w) % 32)).reshape(
            n_s, -1, 32)
    else:
        tw, th = tile
        if tw * th != 32:
            raise ValueError(f"a tile of {tw}x{th} is not a warp of 32")
        g = torch.nn.functional.pad(runs, (0, -w % tw, 0, -h % th))
        warps = g.reshape(n_s, g.shape[1] // th, th, g.shape[2] // tw,
                          tw).permute(0, 1, 3, 2, 4).reshape(n_s, -1, 32)
    busy = int(runs.sum())
    slots = 32 * int(warps.amax(-1).sum())
    return dict(busy=busy, lane_slots=slots,
                share=busy / slots if slots else None)


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
    out = launch(load_library(), blob, meta, lsb, **kw)
    LAUNCHES["k1"] += 1
    return out


# The persistent grids, per (library, device, C entry, scene shape), and
# the counters their launches hand pixel batches out from, per (device,
# stream): each asked for or made once.
_GRIDS: dict = {}
_COUNTERS: dict = {}


def grid_config(lib, entry: str, device, *shape: int) -> dict:
    """A persistent kernel's grid from ``lib`` (``entry``: its C entry,
    e.g. ``spt_megakernel_fwd``) for a scene whose shared memory the ints
    ``shape`` size: threads a block, blocks an SM at its launch bound (the
    occupancy calculator), SMs, and ``blocks`` = SMs x blocks an SM, the
    most a launch runs (fewer where an image has fewer 8x4-pixel batches
    than the grid has warps)."""
    dev = torch.device(device)
    idx = torch.cuda.current_device() if dev.index is None else dev.index
    key = (lib, idx, entry, shape)
    got = _GRIDS.get(key)
    if got is None:
        with torch.cuda.device(idx):
            bps = getattr(lib, f"{entry}_blocks_per_sm")(*shape)
        if bps <= 0:
            raise RuntimeError(f"{entry}: no block fits an SM ({bps})")
        sms = torch.cuda.get_device_properties(idx).multi_processor_count
        got = _GRIDS[key] = dict(threads=getattr(lib, f"{entry}_threads")(),
                                 blocks_per_sm=bps, sms=sms,
                                 blocks=sms * bps)
    return got


def batch_counter(device) -> torch.Tensor:
    """The uint32 scratch from which a persistent launch on ``device``'s
    current stream hands out its pixel batches; each launch zeroes it on
    the stream first, so launches on one stream share it."""
    stream = torch.cuda.current_stream(device)
    key = (stream.device_index, stream.cuda_stream)
    got = _COUNTERS.get(key)
    if got is None:
        got = _COUNTERS[key] = torch.empty(1, dtype=torch.int32,
                                           device=device)
    return got


def launch(lib, blob, meta, lsb, *, width: int, height: int, spp: int,
           n_prims: int, n_light_slots: int, max_bounces: int, rr_depth: int,
           use_nee: bool, use_mis: bool, sky_mode: int, dof: bool,
           counts: torch.Tensor | None = None) -> torch.Tensor:
    """One launch of K1 from the library ``lib`` (the package's build, or a
    tool's build of other sources) on the current stream -> (H, W, 3).
    ``counts`` (two int64 on the card), where given, takes the counting
    instantiation's lane slots and busy lanes (``lane_counts``)."""
    dev = blob.device
    out = torch.empty((height, width, 3), dtype=torch.float32, device=dev)
    grid = launch_config(lib, dev, n_prims=n_prims,
                         n_light_slots=n_light_slots)
    with torch.cuda.device(dev):
        err = lib.spt_megakernel_fwd(
            out.data_ptr(), blob.data_ptr(), meta.data_ptr(), lsb.data_ptr(),
            batch_counter(dev).data_ptr(),
            None if counts is None else counts.data_ptr(),
            width, height, spp, n_prims, n_light_slots, max_bounces,
            rr_depth, int(bool(use_nee)), int(bool(use_mis)), int(sky_mode),
            int(bool(dof)), grid["blocks"],
            ctypes.c_float(_f32(1.0 / width)),
            ctypes.c_float(_f32(1.0 / height)),
            ctypes.c_float(_f32(width / height)),
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"K1 launch failed: CUDA error {err}")
    return out


def launch_config(lib, device, *, n_prims: int, n_light_slots: int) -> dict:
    """K1's persistent grid from ``lib`` (``grid_config``)."""
    return grid_config(lib, "spt_megakernel_fwd", device, n_prims,
                       n_light_slots)


def lane_counts(kernel: str, *args, **kw) -> dict:
    """How busy K1 (``kernel="k1"``) or K3 (``"k3"``) keeps its lanes: one
    launch of the package's counting instantiation (the same schedule;
    each warp adds up its iterations that run a bounce) on CUDA tensors,
    inputs and keywords as ``megakernel_fwd``'s or ``megakernel_bvh_fwd``'s
    -> ``lane_slots`` (32 a warp's such iteration), ``busy`` (lanes that
    ran a bounce in them) and their ratio ``share``.  Counted in
    ``LAUNCHES[kernel]``."""
    from ._build import load_library
    if kernel == "k1":
        launch_fn, library = launch, "megakernel"
    elif kernel == "k3":
        from .megakernel_bvh import launch as launch_fn
        library = "megakernel_bvh"
    else:
        raise ValueError(f"lane counts are K1's or K3's, not {kernel!r}")
    if args[0].device.type != "cuda":
        raise ValueError("the lane counts come from the kernel: they take "
                         "CUDA tensors")
    counts = torch.zeros(2, dtype=torch.int64, device=args[0].device)
    launch_fn(load_library(library), *args, counts=counts, **kw)
    LAUNCHES[kernel] += 1
    slots, busy = counts.tolist()
    return dict(lane_slots=slots, busy=busy,
                share=busy / slots if slots else None)


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
    mtypes, light_prims = pack_scene_static(scene)
    meta = pack_meta(start_sample, seed, mtypes, light_prims)
    dev = scene.device
    lsb = physics.lsel_bounds(scene.centers, scene.radii, scene.prim_valid)
    return (pack_blob_torch(scene, camera).detach(),
            torch.from_numpy(meta).to(dev), lsb.to(dev),
            dict(n_prims=scene.capacity, n_light_slots=len(light_prims)))


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
