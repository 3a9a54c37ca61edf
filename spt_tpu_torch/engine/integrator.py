"""The reference-semantics integrator, as torch ops.

The port of ``spt_tpu/engine/integrator_jax.py``'s ``render_reference_sample``
and the helpers it needs (``scene_intersect``, ``scene_occluded``,
``sample_sky``, ``sample_env_map``).  It reproduces the reference C++
renderer: a hard-coded pinhole +z camera with no jitter, 1 spp per call,
a fixed 0.7 albedo, sky-only lighting, 4 bounces, Russian roulette after
bounce 2, and its stateful per-pixel RNG (``core.rng.ref_seed`` /
``ref_next``, bit for bit).  The per-pixel loop is a masked batch: every
bounce intersects the whole ray batch (brute force, or the BVH walk of
``core.bvh.intersect_bvh`` on a scene compiled with a tree) and lanes drop
out on a miss or a roulette kill.  JAX's version is ``jnp`` code with no
Pallas kernel; this one runs on the scene's device.
"""

from __future__ import annotations

import math

import torch

from ..core import intersect, rng, sampling
from ..core.bvh import intersect_bvh
from ..core.camera import ReferenceCamera
from ..core.scene import SKY_CONSTANT, SKY_ENVMAP, SKY_GRADIENT, SceneData
from ..kernels.physics import _div

EPS_OFFSET = 1e-4  # the reference's surface offset


def scene_intersect(scene: SceneData, o, d, tmax=math.inf):
    """Nearest hit: the BVH walk when the compiled scene carries a tree,
    the brute-force sweep otherwise."""
    if scene.bvh is not None:
        return intersect_bvh(o, d, scene.centers, scene.radii, scene.bvh,
                             tmax=tmax)
    return intersect.intersect_spheres(
        o, d, scene.centers, scene.radii, scene.prim_valid, tmax=tmax)


def scene_occluded(scene: SceneData, o, d, tmax):
    """Any-hit shadow test with tmax, via the BVH or brute force."""
    if scene.bvh is not None:
        _, hid = intersect_bvh(o, d, scene.centers, scene.radii, scene.bvh,
                               tmax=tmax)
        return hid >= 0
    return intersect.occluded(o, d, scene.centers, scene.radii,
                              scene.prim_valid, tmax)


def sample_sky(d, scene: SceneData):
    """Environment radiance for direction batch ``d``.

    The gradient sky is the reference's: mix(horizon, zenith,
    0.5 * (dir.y + 1)).
    """
    if scene.sky_mode == SKY_GRADIENT:
        t = 0.5 * (d[..., 1:2] + 1.0)
        horizon = scene.sky_params[0]
        zenith = scene.sky_params[1]
        return horizon * (1.0 - t) + zenith * t
    if scene.sky_mode == SKY_CONSTANT:
        return torch.broadcast_to(scene.sky_params[0], d.shape)
    if scene.sky_mode == SKY_ENVMAP and scene.env_map is not None:
        return sample_env_map(scene.env_map, d)
    return torch.zeros_like(d)


def sample_env_map(env, d):
    """Equirectangular lookup: dir -> (u, v) -> bilinear radiance sample."""
    he, we = env.shape[0], env.shape[1]
    # atan2 and arccos in float64, rounded once: the same bits on the card
    # and the CPU (as core.sampling takes sin and cos).
    u = (torch.atan2(d[..., 0].double(), d[..., 2].double()).to(d.dtype)
         * (0.5 / math.pi) + 0.5) * we - 0.5
    v = _div(torch.arccos(torch.clamp(d[..., 1], -1.0, 1.0).double())
             .to(d.dtype), math.pi) * he - 0.5
    v = torch.clamp(v, 0.0, he - 1.0)  # clamp-to-edge at the poles
    u0 = torch.floor(u)
    v0 = torch.floor(v)
    fu = (u - u0)[..., None]
    fv = (v - v0)[..., None]
    u0i = torch.remainder(u0.to(torch.int32), we).long()
    u1i = torch.remainder(u0i + 1, we)
    v0i = torch.clamp(v0.to(torch.int32), 0, he - 1).long()
    v1i = torch.clamp(v0i + 1, 0, he - 1)
    c00 = env[v0i, u0i]
    c01 = env[v0i, u1i]
    c10 = env[v1i, u0i]
    c11 = env[v1i, u1i]
    return ((c00 * (1 - fu) + c01 * fu) * (1 - fv)
            + (c10 * (1 - fu) + c11 * fu) * fv)


def render_reference_sample(scene: SceneData, width: int, height: int,
                            frame: int) -> torch.Tensor:
    """One progressive sample with the reference's exact semantics, on the
    scene's device.

    Returns (H, W, 3) radiance for frame index ``frame`` (0-based; the
    reference seeds with frame + 1).  Adding successive frames and
    dividing reproduces its progressive accumulation.
    """
    dev = scene.device
    px = torch.arange(width, dtype=torch.int64, device=dev)[None, :] \
        .expand(height, width).reshape(-1)
    py = torch.arange(height, dtype=torch.int64, device=dev)[:, None] \
        .expand(height, width).reshape(-1)
    state = rng.ref_seed(px, py, width, frame + 1)

    o, d = ReferenceCamera().generate_rays(px, py, width, height)
    radiance = torch.zeros_like(d)
    throughput = torch.ones_like(d)
    active = torch.ones(px.shape, dtype=torch.bool, device=dev)

    # 4 bounces, hard-coded; Russian roulette applies when the
    # post-increment bounce count exceeds 2, i.e. at iterations k >= 2.
    for k in range(4):
        t, hit_id = scene_intersect(scene, o, d)
        hit = active & (hit_id >= 0)
        miss = active & (hit_id < 0)

        radiance = torch.where(miss[:, None],
                               radiance + throughput * sample_sky(d, scene),
                               radiance)
        active = hit

        t_safe = torch.where(hit, t, torch.ones_like(t))[:, None]
        p = o + t_safe * d
        centers_hit = scene.centers[torch.clamp_min(hit_id, 0).long()]
        n = intersect.sphere_normal(p, centers_hit)

        throughput = torch.where(hit[:, None], throughput * 0.7, throughput)

        if k >= 2:
            new_state, u_rr = rng.ref_next(state)
            state = torch.where(hit, new_state, state)
            p_cont = torch.amax(throughput, dim=-1)
            survive = u_rr <= p_cont
            active = active & survive
            throughput = torch.where(
                active[:, None],
                throughput / torch.clamp_min(p_cont, 1e-12)[:, None],
                throughput)

        new_state, u1 = rng.ref_next(state)
        state = torch.where(active, new_state, state)
        new_state, u2 = rng.ref_next(state)
        state = torch.where(active, new_state, state)

        d_new = sampling.cosine_hemisphere(n, u1, u2)
        d = torch.where(active[:, None], d_new, d)
        o = torch.where(active[:, None], p + EPS_OFFSET * n, o)

    return radiance.reshape(height, width, 3)
