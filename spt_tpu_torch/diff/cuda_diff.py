"""Differentiable rendering through the kernels.

The port of ``spt_tpu.diff.pallas_diff``.  ``make_cuda_render_fn`` returns
a function ``render(params, start_sample) -> image`` whose forward and
backward are kernels, joined by a ``torch.autograd.Function``: the
backward's gradient of the packed tables flows back through the packers to
the parameters, so it composes with ``torch.autograd`` and ``torch.optim``
as the plain render does.  Routed by scene size as JAX routes it:

* at most ``SMEM_PRIM_CAP`` spheres: K1 forward, one K2 launch backward
  (the blob packed by ``megakernel.pack_blob_torch``);
* up to ``FUSED_GRAD_PRIM_CAP``: K3 forward, one K4 launch backward over a
  BVH packed once (``megakernel_bvh.pack_blob_torch``,
  ``pack_prims_torch``; centres or radii refit its boxes);
* above, or ``engine="wavefront"``: the differentiable sorted wavefront
  (``kernels/wavefront_grad.py``: K5, K6, K9 forward, K10 backward).

A scene under an environment-map sky goes to the wavefront at every
capacity, as the forward facade routes it (``engine/cuda_backend.py``):
only the wavefront adds the map (between its kernels); K1-K4 would shade
every miss black.  ``engine="fused"`` refuses such a scene.  The JAX
package's ``make_pallas_render_fn`` routes by capacity alone and drops the
map at 2048 spheres or fewer; the port does not copy that.

On CPU tensors the kernels' wrappers take their plain versions.  Gradients
reach albedo, emission, roughness, centers and radii (``PARAM_KEYS``).
"""

from __future__ import annotations

import torch

from ..core.scene import SKY_ENVMAP, SceneData
from ..kernels import (megakernel, megakernel_bvh, megakernel_bvh_grad,
                       megakernel_grad, physics)
from . import gradients as G

PARAM_KEYS = ("albedo", "emission", "roughness", "centers", "radii")

# Above this the scene's uniforms no longer sit in the kernels' shared
# memory: the BVH kernels K3 and K4 take the scene.
SMEM_PRIM_CAP = 128

# Above this JAX's fused BVH gradient lost to its differentiable wavefront
# on the TPU; the port keeps JAX's threshold.  On an H100 at 700 W
# (chip_smoke.py's grad_crossover) one 1920x1080 x 4 spp forward and
# backward of config 5 cut to 2,000 spheres took 65-68 ms through K3/K4
# and 646-1050 ms through the wavefront; moving it waits for a benchmark
# with cells on both sides.
FUSED_GRAD_PRIM_CAP = 2048


class _KernelRender(torch.autograd.Function):
    """blob -> mean radiance (H, W, 3): K1 forward, K2 backward."""

    @staticmethod
    def forward(ctx, blob, meta, lsb, kw):
        ctx.save_for_backward(blob, meta, lsb)
        ctx.kw = kw
        return megakernel.megakernel_fwd(blob, meta, lsb, **kw) \
            * (1.0 / kw["spp"])

    @staticmethod
    def backward(ctx, ct):
        blob, meta, lsb = ctx.saved_tensors
        kw = ctx.kw
        _, gvec = megakernel_grad.megakernel_grad(
            blob, meta, lsb, (ct * (1.0 / kw["spp"])).contiguous(), **kw)
        n_sph = megakernel_grad.N_SPHERE_ATTRS * kw["n_prims"]
        d_blob = torch.zeros_like(blob)      # the camera carries no gradient
        d_blob[megakernel._SPH_OFF:] = gvec[:n_sph]
        d_blob[megakernel._SKY_OFF:megakernel._SPH_OFF] = gvec[n_sph:]
        return d_blob, None, None, None


class _BvhKernelRender(torch.autograd.Function):
    """(blob, prims) -> mean radiance (H, W, 3): K3 forward, K4 backward.
    The tree's node tables and ``kw`` ride in ``tables``."""

    @staticmethod
    def forward(ctx, blob, prims, tables):
        nodef, nodei, meta, mtypes, kw = tables
        lsb = physics.lsel_bounds_from_prims(prims)
        ctx.save_for_backward(blob, prims, lsb)
        ctx.tables = tables
        return megakernel_bvh.megakernel_bvh_fwd(
            blob, meta, lsb, nodef, nodei, prims, mtypes, **kw) \
            * (1.0 / kw["spp"])

    @staticmethod
    def backward(ctx, ct):
        blob, prims, lsb = ctx.saved_tensors
        nodef, nodei, meta, mtypes, kw = ctx.tables
        ct_sw = megakernel_bvh_grad.swizzle_ct(
            ct * (1.0 / kw["spp"]), kw["width"], kw["height"])
        _, grad_s, grad_g = megakernel_bvh_grad.megakernel_bvh_grad(
            blob, meta, lsb, nodef, nodei, prims, mtypes, ct_sw, **kw)
        d_blob = torch.zeros_like(blob)      # the camera carries no gradient
        d_blob[megakernel._SKY_OFF:megakernel._SKY_OFF + grad_s.numel()] = \
            grad_s
        d_prims = torch.zeros_like(prims)
        d_prims[:, 0:4] = grad_g[:, 0:4]
        return d_blob, d_prims, None


def _make_bvh_render_fn(scene: SceneData, camera, width: int, height: int,
                        *, spp: int, max_bounces: int, rr_depth: int,
                        use_nee: bool, use_mis: bool, seed: int,
                        block: int = megakernel_bvh.BLOCK):
    """The render through K3 and K4 (129-2048 prims).  The tree is built
    and packed once from the closure scene; each call packs the blob and
    the prim table from ``params`` (differentiable gathers), and centres or
    radii refit the node boxes over the fixed topology."""
    t, static = megakernel_bvh.packed(scene, camera, block)
    kw = dict(width=width, height=height, spp=spp, block=block,
              n_mats=static["n_mats"], n_light_slots=static["n_light_slots"],
              max_bounces=max_bounces, rr_depth=rr_depth,
              use_nee=bool(use_nee), use_mis=bool(use_mis),
              sky_mode=scene.sky_mode,
              dof=bool(float(megakernel._np(camera.aperture)) > 0.0))

    def render(params: dict, start_sample) -> torch.Tensor:
        sc = G.apply_params(scene, params)
        nodef = megakernel_bvh.refit_nodef_torch(sc, static) \
            if ("centers" in params or "radii" in params) else t["nodef"]
        meta = torch.tensor([int(start_sample), seed,
                             static["n_light_slots"]],
                            dtype=torch.int32).to(scene.device)
        tables = (nodef, t["nodei"], meta, t["mtypes"], kw)
        return _BvhKernelRender.apply(
            megakernel_bvh.pack_blob_torch(sc, camera, static),
            megakernel_bvh.pack_prims_torch(sc, static), tables)

    return render


def make_cuda_render_fn(scene: SceneData, camera, width: int, height: int,
                        *, spp: int, max_bounces: int = 6, rr_depth: int = 3,
                        use_nee: bool = True, use_mis: bool = True,
                        seed: int = 0, engine: str = "auto"):
    """render(params, start_sample) -> (H, W, 3) mean radiance of samples
    ``start_sample .. start_sample + spp - 1``, differentiable.

    ``params`` may hold any subset of ``PARAM_KEYS``; the rest of the scene
    is closed over.  The camera renders through its lens when its aperture
    is above 0.  ``engine``: "auto" routes by capacity (K1/K2 up to
    ``SMEM_PRIM_CAP``, K3/K4 up to ``FUSED_GRAD_PRIM_CAP``, the wavefront
    above) and sends every environment-map scene to the wavefront;
    "fused" never takes the wavefront (and raises on an environment map,
    which only the wavefront renders), "wavefront" always does.  The
    wavefront packs the tree it walks from the scene's spheres, so a scene
    compiled without a BVH takes it too."""
    if engine not in ("auto", "fused", "wavefront"):
        raise ValueError(f"unknown engine {engine!r}")
    envmap = scene.sky_mode == SKY_ENVMAP
    if envmap and engine == "fused":
        raise ValueError(
            "engine='fused' cannot render an environment-map sky: K1-K4 "
            "shade a miss by the sky's formula, which has no map; use "
            "engine='auto' or 'wavefront'")
    if engine == "wavefront" or (engine == "auto" and (
            envmap or scene.capacity > FUSED_GRAD_PRIM_CAP)):
        from ..kernels import wavefront_grad
        make = wavefront_grad.make_wavefront_render_fn
    elif scene.capacity > SMEM_PRIM_CAP:
        make = _make_bvh_render_fn
    else:
        make = _make_smem_render_fn
    inner = make(scene, camera, width, height, spp=spp,
                 max_bounces=max_bounces, rr_depth=rr_depth, use_nee=use_nee,
                 use_mis=use_mis, seed=seed)

    def render(params: dict, start_sample) -> torch.Tensor:
        unknown = sorted(set(params) - set(PARAM_KEYS))
        if unknown:
            raise KeyError(f"{unknown}: the kernel render differentiates "
                           f"only {PARAM_KEYS}")
        return inner(params, start_sample)

    return render


def _make_smem_render_fn(scene: SceneData, camera, width: int, height: int,
                         *, spp: int, max_bounces: int, rr_depth: int,
                         use_nee: bool, use_mis: bool, seed: int):
    """The render through K1 and K2 (at most ``SMEM_PRIM_CAP`` spheres)."""
    mtypes, light_prims = megakernel.pack_scene_static(scene)
    kw = dict(width=width, height=height, spp=spp, n_prims=scene.capacity,
              n_light_slots=len(light_prims), max_bounces=max_bounces,
              rr_depth=rr_depth, use_nee=bool(use_nee),
              use_mis=bool(use_mis), sky_mode=scene.sky_mode,
              dof=bool(float(megakernel._np(camera.aperture)) > 0.0))

    def render(params: dict, start_sample) -> torch.Tensor:
        sc = G.apply_params(scene, params)
        meta = torch.from_numpy(megakernel.pack_meta(
            int(start_sample), seed, mtypes, light_prims)).to(scene.device)
        lsb = physics.lsel_bounds(sc.centers.detach(), sc.radii.detach(),
                                  sc.prim_valid)
        return _KernelRender.apply(megakernel.pack_blob_torch(sc, camera),
                                   meta, lsb, kw)

    return render
