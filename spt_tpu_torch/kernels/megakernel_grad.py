"""Fused forward+backward kernel K2: an image and its gradient in one launch.

The port of ``spt_tpu.kernels.megakernel_grad``.  One launch renders ``spp``
samples of every pixel exactly as K1 does and returns, beside the radiance
sum, ``gvec``: the gradient of ``sum(ct * image)`` with respect to every
sphere's 12 attributes (cx cy cz r, albedo rgb, emission rgb, roughness,
ior) and the 6 sky floats, laid out as ``blob[21:]`` then ``blob[15:21]``.
Per sample, the forward sweep keeps each bounce's entry state (13 floats
and 2 masks); the backward sweep replays the bounces in reverse through
``physics_adjoint.trace_bounce_vjp`` (path replay: the counter RNG
recomputes every uniform).  A light slot's cotangent belongs to the sphere
that owns it and is folded into that sphere's row.

* ``megakernel_grad`` is the kernel's wrapper.  On CUDA tensors it launches
  the hand-written kernel ``csrc/megakernel_grad.cu`` and raises if it
  cannot; on CPU tensors it runs ``render_and_grad_plain``.
* ``render_and_grad_plain`` is the plain PyTorch version.
* ``render_and_grad`` packs a scene and camera, calls the wrapper and maps
  ``gvec`` to the scene's parameters, as JAX's ``render_and_grad`` does.
* ``bounce_vjp`` runs one bounce's adjoint over given lanes, K2's per-lane
  code on the card (``spt_bounce_vjp``) or ``bounce_vjp_plain`` on the CPU,
  so the two can be compared.
* ``record_bounce`` and ``recorded_geometry`` are the plain forms of K2's
  two geometries: the forward sweep that records each lane's nearest
  sphere and shadow verdict, and the replay that rebuilds the hit from
  them without sweeping (``bounce_vjp_recorded_plain``).

``megakernel.LAUNCHES["k2"]`` counts K2 launches; plain runs count under
``"plain"``.
"""

from __future__ import annotations

import ctypes

import torch

from ..core import rng
from ..core.scene import SceneData
from . import physics
from .megakernel import (_META_FIXED, _SPH_STRIDE, LAUNCHES, MAX_PRIMS,
                         K1_OPS, PlainScene, _check, _f32, _np, camera_paths,
                         k1_op_count, pack_uniforms)
from .physics_adjoint import trace_bounce_vjp

N_STATE = 13
# K2 keeps a path's bounce-entry states in a per-thread array of this many.
MAX_DEPTH = 16
N_SPHERE_ATTRS, N_SKY_ATTRS = _SPH_STRIDE, 6


def fold_lights(theta_ct, light_prims, nl: int) -> torch.Tensor:
    """(spheres_ct, sky_ct, lights_ct) -> gvec: light slot l < nl adds into
    its owning sphere's row (``LIGHT_TO_SPHERE_ATTR``), then the sky."""
    spheres_ct, sky_ct, lights_ct = theta_ct
    spheres_ct = spheres_ct.clone()
    cols = list(physics.LIGHT_TO_SPHERE_ATTR)
    for l, p in enumerate(light_prims[:nl]):
        spheres_ct[p, cols] += lights_ct[l]
    return torch.cat([spheres_ct.reshape(-1), sky_ct])


def render_and_grad_plain(blob: torch.Tensor, meta: torch.Tensor,
                          lsb: torch.Tensor, ct: torch.Tensor, *, width: int,
                          height: int, spp: int, n_prims: int,
                          n_light_slots: int, max_bounces: int, rr_depth: int,
                          use_nee: bool, use_mis: bool, sky_mode: int,
                          dof: bool):
    """Plain PyTorch version of K2 -> (image (H, W, 3), gvec (12 P + 6,)).

    The image is ``render_tiles_plain``'s, bit for bit."""
    LAUNCHES["plain"] += 1
    sc = PlainScene(blob, meta, lsb, n_prims, n_light_slots)
    n_pix = width * height
    acc = torch.zeros(3, n_pix, dtype=torch.float32, device=blob.device)
    ct_pix = ct.reshape(n_pix, 3).T.to(torch.float32)
    theta_ct = [torch.zeros_like(t) for t in sc.theta]
    for s in range(spp):
        sample = (sc.start_sample + s) & rng.MASK32
        pid, state, aux = camera_paths(blob, sample, width=width,
                                       height=height, seed=sc.seed, dof=dof)
        entries = []
        for k in range(max_bounces):
            cfg = physics.BounceCfg(
                mtypes=sc.mtypes, k=k, rr_depth=rr_depth, use_nee=use_nee,
                use_mis=use_mis, sky_mode=sky_mode,
                n_light_slots=n_light_slots)
            u = sc.uniforms(pid, sample, k)
            entries.append((state, aux, u, cfg))
            state, aux = physics.trace_bounce(sc.theta, state, aux, u, sc.nl,
                                              cfg)
        acc[0] += state[9]
        acc[1] += state[10]
        acc[2] += state[11]
        zero = torch.zeros_like(state[0])
        state_ct = [zero] * N_STATE
        state_ct[9:12] = ct_pix
        for st_k, aux_k, u, cfg in reversed(entries):
            th_k, state_ct = trace_bounce_vjp(sc.theta, st_k, aux_k, u,
                                              sc.nl, cfg, state_ct)
            for acc_ct, t in zip(theta_ct, th_k):
                acc_ct += t
    gvec = fold_lights(theta_ct, sc.light_prims, sc.nl)
    return acc.T.reshape(height, width, 3), gvec


def _plain_bounce(blob, meta, lsb, pid, sample, *, k: int, n_prims: int,
                  n_light_slots: int, rr_depth: int, use_nee: bool,
                  use_mis: bool, sky_mode: int):
    """The packed scene, bounce k's configuration and its counter uniforms
    for the lanes (pid, sample), as the plain per-lane adjoints take them."""
    sc = PlainScene(blob, meta, lsb, n_prims, n_light_slots)
    cfg = physics.BounceCfg(
        mtypes=sc.mtypes, k=k, rr_depth=rr_depth, use_nee=use_nee,
        use_mis=use_mis, sky_mode=sky_mode, n_light_slots=n_light_slots)
    return sc, cfg, sc.uniforms(pid, sample, k)


def bounce_vjp_plain(blob, meta, lsb, state, aux, pid, sample, state_ct,
                     **kw):
    """Plain version of ``bounce_vjp``: ``trace_bounce_vjp`` on the lanes,
    with bounce k's counter uniforms, theta's cotangent folded as in gvec.
    Keywords as ``bounce_vjp``'s."""
    sc, cfg, u = _plain_bounce(blob, meta, lsb, pid, sample, **kw)
    th_ct, st_ct = trace_bounce_vjp(sc.theta, tuple(state), tuple(aux), u,
                                    sc.nl, cfg, tuple(state_ct))
    return fold_lights(th_ct, sc.light_prims, sc.nl), torch.stack(st_ct)


def record_bounce(theta, state, aux, u, nl: int, cfg: physics.BounceCfg):
    """K2's forward geometry (``RecordingList``), plain: ``trace_bounce``
    over the sphere list -> (ids (N,) int64, each lane's nearest sphere, -1
    on a miss; blocked (N,) bool, its NEE shadow verdict, False where it
    traced none)."""
    spheres = theta[0]
    rec = {}

    def intersect(ox, oy, oz, dx, dy, dz, active):
        t, h, m_lam, m_met, m_die, j = physics.intersect_spheres_unrolled(
            spheres, cfg.mtypes, ox, oy, oz, dx, dy, dz)
        rec["ids"] = torch.where(t < physics.BIG, j.long(), -1)
        return t, h, m_lam, m_met, m_die

    def occluded(ox, oy, oz, dx, dy, dz, tmax, need):
        rec["blocked"] = physics.occluded_unrolled(spheres, ox, oy, oz, dx,
                                                   dy, dz, tmax)
        return rec["blocked"]

    physics.trace_bounce(theta, state, aux, u, nl, cfg, intersect, occluded)
    ids = rec["ids"]
    return ids, rec.get("blocked", torch.zeros_like(ids, dtype=torch.bool))


def recorded_geometry(spheres, mtypes, ids, blocked):
    """K2's replay geometry (``RecordedSphere``), plain: ``trace_bounce``'s
    (intersect_fn, occluded_fn) with each lane's hit rebuilt from the
    sphere ``ids`` records by ``physics._sphere_t`` on that row alone (the
    sweep's expression, so the same distance bits) and the recorded shadow
    verdict."""
    found = ids >= 0
    j = ids.clamp_min(0)
    rows = spheres[j]                                     # (N, 12)

    def intersect(ox, oy, oz, dx, dy, dz, active):
        tj, _ = physics._sphere_t(rows, *(a[:, None] for a in
                                          (ox, oy, oz, dx, dy, dz)))
        t = torch.where(found, tj[:, 0], physics.BIG)
        h = {key: torch.where(found, rows[:, a], 1.5 if key == "ior" else 0.0)
             for a, key in enumerate(physics._H_KEYS)}
        mt = torch.as_tensor(mtypes, dtype=torch.int32, device=ox.device)[j]
        return (t, h, found & (mt == physics.LAMBERT),
                found & (mt == physics.METAL),
                found & (mt == physics.DIELECTRIC))

    return intersect, lambda *a: blocked


def bounce_vjp_recorded_plain(blob, meta, lsb, state, aux, pid, sample,
                              state_ct, **kw):
    """``bounce_vjp_plain`` as K2's per-lane code computes it: the bounce
    forward with the recording geometry, then its adjoint against the
    recorded hit and verdict, the lanes' rows added into their spheres."""
    sc, cfg, u = _plain_bounce(blob, meta, lsb, pid, sample, **kw)
    state, aux = tuple(state), tuple(aux)
    ids, blocked = record_bounce(sc.theta, state, aux, u, sc.nl, cfg)
    (rows, sky_ct, lights_ct), st_ct = trace_bounce_vjp(
        sc.theta, state, aux, u, sc.nl, cfg, tuple(state_ct),
        recorded_geometry(sc.theta[0], sc.mtypes, ids, blocked))
    spheres_ct = torch.zeros_like(sc.theta[0]).index_add_(
        0, ids.clamp_min(0), rows)
    return (fold_lights((spheres_ct, sky_ct, lights_ct), sc.light_prims,
                        sc.nl), torch.stack(st_ct))


def bounce_vjp(blob, meta, lsb, state, aux, pid, sample, state_ct, *, k: int,
               n_prims: int, n_light_slots: int, rr_depth: int, use_nee: bool,
               use_mis: bool, sky_mode: int):
    """One bounce's adjoint over N given lanes -> (gvec, state_in_ct).

    ``state`` and ``state_ct`` are (13, N) float32, ``aux`` (2, N) bool,
    ``pid`` and ``sample`` (N,) uint32 values as int64; the uniforms are
    the counter streams of bounce ``k`` (seed ``meta[1]``).  On CUDA tensors
    this runs K2's per-lane code (``spt_bounce_vjp``: the bounce with K2's
    recording geometry, then its adjoint against the recorded hit into K2's
    sink), on CPU tensors ``bounce_vjp_plain``."""
    kw = dict(k=k, n_prims=n_prims, n_light_slots=n_light_slots,
              rr_depth=rr_depth, use_nee=use_nee, use_mis=use_mis,
              sky_mode=sky_mode)
    if blob.device.type == "cpu":
        return bounce_vjp_plain(blob, meta, lsb, state, aux, pid, sample,
                                state_ct, **kw)
    n = state.shape[1]
    _check_cuda(blob, meta, lsb, n_prims, n_light_slots)
    for t, name in ((state, "state"), (state_ct, "state_ct")):
        _check(t, name, torch.float32, N_STATE * n)
    gvec = torch.zeros(N_SPHERE_ATTRS * n_prims + N_SKY_ATTRS,
                       dtype=torch.float32, device=blob.device)
    out = torch.empty_like(state_ct)
    aux_i = aux.to(torch.int32).contiguous()
    pid_i = rng.to_int32_bits(pid).contiguous()
    sample_i = rng.to_int32_bits(sample).contiguous()
    from ._build import load_library
    lib = load_library("megakernel_grad")
    with torch.cuda.device(blob.device):
        err = lib.spt_bounce_vjp(
            gvec.data_ptr(), out.data_ptr(), state_ct.data_ptr(),
            state.data_ptr(), aux_i.data_ptr(), pid_i.data_ptr(),
            sample_i.data_ptr(), blob.data_ptr(), meta.data_ptr(),
            lsb.data_ptr(), n, n_prims, n_light_slots, k, rr_depth,
            int(bool(use_nee)), int(bool(use_mis)), int(sky_mode),
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"spt_bounce_vjp launch failed: CUDA error {err}")
    return gvec, out


def blocks_per_sm(n_prims: int, n_light_slots: int) -> int:
    """Blocks of K2 that share an SM for a scene of ``n_prims`` spheres
    (CUDA's occupancy calculator on the kernel as built; needs the card)."""
    from ._build import load_library
    return load_library("megakernel_grad").spt_megakernel_grad_blocks_per_sm(
        n_prims, n_light_slots)


def _check_cuda(blob, meta, lsb, n_prims: int, n_light_slots: int) -> None:
    if blob.device.type != "cuda":
        raise NotImplementedError(f"K2 has no kernel for {blob.device}")
    if not (meta.device == blob.device == lsb.device):
        raise ValueError("blob, meta and lsb must lie on one device")
    if n_prims > MAX_PRIMS:
        raise ValueError(f"K2 takes at most {MAX_PRIMS} spheres, "
                         f"got {n_prims}")
    _check(blob, "blob", torch.float32, 21 + _SPH_STRIDE * n_prims)
    _check(meta, "meta", torch.int32,
           _META_FIXED + n_prims + max(n_light_slots, 1))
    _check(lsb, "lsb", torch.float32, 6)


def megakernel_grad(blob: torch.Tensor, meta: torch.Tensor, lsb: torch.Tensor,
                    ct: torch.Tensor, *, width: int, height: int, spp: int,
                    n_prims: int, n_light_slots: int, max_bounces: int,
                    rr_depth: int, use_nee: bool, use_mis: bool,
                    sky_mode: int, dof: bool):
    """K2's wrapper -> (image (H, W, 3) radiance sum over ``spp`` samples,
    gvec (12 P + 6,) gradient of sum(ct * image)).

    CUDA tensors launch the CUDA kernel on the current stream; CPU tensors
    take ``render_and_grad_plain``.  Depth above ``MAX_DEPTH`` raises."""
    kw = dict(width=width, height=height, spp=spp, n_prims=n_prims,
              n_light_slots=n_light_slots, max_bounces=max_bounces,
              rr_depth=rr_depth, use_nee=use_nee, use_mis=use_mis,
              sky_mode=sky_mode, dof=dof)
    if max_bounces > MAX_DEPTH:
        raise ValueError(f"K2 keeps at most {MAX_DEPTH} bounces per path, "
                         f"got max_bounces={max_bounces}")
    if blob.device.type == "cpu":
        return render_and_grad_plain(blob, meta, lsb, ct, **kw)
    _check_cuda(blob, meta, lsb, n_prims, n_light_slots)
    if ct.device != blob.device:
        raise ValueError("ct must lie on the blob's device")
    _check(ct, "ct", torch.float32, width * height * 3)
    from ._build import load_library
    lib = load_library("megakernel_grad")
    img = torch.empty((height, width, 3), dtype=torch.float32,
                      device=blob.device)
    gvec = torch.zeros(N_SPHERE_ATTRS * n_prims + N_SKY_ATTRS,
                       dtype=torch.float32, device=blob.device)
    with torch.cuda.device(blob.device):
        err = lib.spt_megakernel_grad(
            img.data_ptr(), gvec.data_ptr(), blob.data_ptr(),
            meta.data_ptr(), lsb.data_ptr(), ct.data_ptr(), width, height,
            spp, n_prims, n_light_slots, max_bounces, rr_depth,
            int(bool(use_nee)), int(bool(use_mis)), int(sky_mode),
            int(bool(dof)), ctypes.c_float(_f32(1.0 / width)),
            ctypes.c_float(_f32(1.0 / height)),
            ctypes.c_float(_f32(width / height)),
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"K2 launch failed: CUDA error {err}")
    LAUNCHES["k2"] += 1
    return img, gvec


def render_and_grad(scene: SceneData, camera, width: int, height: int,
                    start_sample: int, spp: int, *, ct_image=None,
                    max_bounces: int = 8, rr_depth: int = 3,
                    use_nee: bool = True, use_mis: bool = True, seed: int = 0,
                    dof=None):
    """Fused forward+backward on the scene's device -> (radiance sum image,
    grads).

    grads: 'centers' (P, 3), 'radii' (P,), 'albedo' / 'emission' (M, 3),
    'roughness' / 'ior' (M,), 'sky_params' (2, 3): gradients of
    ``sum(ct_image * radiance_sum)`` (ct defaults to ones).  Material
    gradients sum over the valid spheres that use each material."""
    blob, meta, lsb, static = pack_uniforms(scene, camera, start_sample, seed)
    if dof is None:  # auto: thin-lens iff the camera has a real aperture
        dof = bool(float(_np(camera.aperture)) > 0.0)
    ct = (torch.ones(height, width, 3, device=scene.device)
          if ct_image is None else
          torch.as_tensor(ct_image, dtype=torch.float32).to(
              scene.device).reshape(height, width, 3).contiguous())
    img, gvec = megakernel_grad(
        blob, meta, lsb, ct, width=width, height=height, spp=spp,
        max_bounces=max_bounces, rr_depth=rr_depth, use_nee=bool(use_nee),
        use_mis=bool(use_mis), sky_mode=scene.sky_mode, dof=bool(dof),
        **static)
    P = scene.capacity
    A = N_SPHERE_ATTRS
    valid = scene.prim_valid.to(torch.float32)[:, None]
    sph = gvec[:P * A].reshape(P, A) * valid
    one_hot = torch.nn.functional.one_hot(
        scene.mat_id.long(), scene.materials.num_materials).to(
            torch.float32) * valid                                # (P, M)
    grads = {
        "centers": sph[:, 0:3],
        "radii": sph[:, 3],
        "albedo": one_hot.T @ sph[:, 4:7],
        "emission": one_hot.T @ sph[:, 7:10],
        "roughness": one_hot.T @ sph[:, 10],
        "ior": one_hot.T @ sph[:, 11],
        "sky_params": gvec[P * A:P * A + N_SKY_ATTRS].reshape(2, 3),
    }
    return img, grads


# fp32 operations of K2 (csrc/megakernel_grad.cu, csrc/physics_adj.cuh),
# counted by hand from the code as K1_OPS is.  K2 runs K1's forward sweep,
# then for every bounce a path ran it recomputes that bounce (K1's
# per-bounce work again, without raygen) and runs its adjoint.  The adjoint
# counts are those of the cheapest branch a lane can take, Lambert's: the
# metal and glass branches, emission, MIS weights, Russian roulette and the
# sky add more, so the total is a lower count of what the data needs.
K2_OPS = dict(              # adjoint operations per lane
    hit=270,            # output seeds, throughput, Lambert sample and pdf,
                        # ONB adjoint, normal, hit point, the winner's
                        # distance and its 12 gradient adds
    lit=280,            # NEE on a lit Lambert hit: radiance, pdf and BSDF
                        # terms, cone sample, ONB adjoint, light geometry
)


def k2_op_count(stats: dict, n_prims: int) -> int:
    """Lower count of K2's fp32 operations for the work in ``stats``
    (``render_tiles_plain(..., stats=...)`` on the same inputs): the
    forward sweep, the recompute of every bounce, and the adjoint."""
    hit, lit = sum(stats["hit"]), sum(stats["lit"])
    fwd = k1_op_count(stats, n_prims)
    recompute = fwd - stats["paths"] * K1_OPS["raygen"]
    return (fwd + recompute + hit * K2_OPS["hit"]
            + lit * K2_OPS["lit"])
