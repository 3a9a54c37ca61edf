"""Differentiable rendering through the fused kernels K1 and K2.

The port of ``spt_tpu.diff.pallas_diff``'s branch for scenes of at most
``SMEM_PRIM_CAP`` spheres.  ``make_cuda_render_fn`` returns a function
``render(params, start_sample) -> image`` whose forward is K1 and whose
backward is one K2 launch, joined by a ``torch.autograd.Function``: K2's
gradient of the packed uniform blob flows back through ``pack_blob_torch``
to the parameters, so it composes with ``torch.autograd`` and
``torch.optim`` as the plain render does.  On CPU tensors the two kernels'
wrappers take their plain versions.

Gradients reach albedo, emission, roughness, centers and radii
(``PARAM_KEYS``).
"""

from __future__ import annotations

import torch

from ..core.scene import SceneData
from ..kernels import megakernel, megakernel_grad, physics
from . import gradients as G

PARAM_KEYS = ("albedo", "emission", "roughness", "centers", "radii")

# Above this the scene's uniforms no longer sit in the kernels' shared
# memory; larger scenes need the BVH kernels (not ported yet).
SMEM_PRIM_CAP = 128


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


def make_cuda_render_fn(scene: SceneData, camera, width: int, height: int,
                        *, spp: int, max_bounces: int = 6, rr_depth: int = 3,
                        use_nee: bool = True, use_mis: bool = True,
                        seed: int = 0, engine: str = "auto"):
    """render(params, start_sample) -> (H, W, 3) mean radiance of samples
    ``start_sample .. start_sample + spp - 1``, differentiable.

    ``params`` may hold any subset of ``PARAM_KEYS``; the rest of the scene
    is closed over.  The camera renders through its lens when its aperture
    is above 0.  ``engine`` "auto" takes the fused kernels; the large-scene
    engines are not ported yet."""
    if engine in ("fused", "wavefront") or scene.capacity > SMEM_PRIM_CAP:
        raise NotImplementedError(
            f"engine={engine!r} with capacity {scene.capacity}: scenes above "
            f"{SMEM_PRIM_CAP} spheres need the BVH gradient kernel (K4, "
            "ROADMAP.md item 7) or the wavefront gradient (K9/K10, "
            "ROADMAP.md item 8), not ported yet")
    if engine != "auto":
        raise ValueError(f"unknown engine {engine!r}")
    mtypes, light_prims = megakernel.pack_scene_static(scene)
    kw = dict(width=width, height=height, spp=spp, n_prims=scene.capacity,
              n_light_slots=len(light_prims), max_bounces=max_bounces,
              rr_depth=rr_depth, use_nee=bool(use_nee),
              use_mis=bool(use_mis), sky_mode=scene.sky_mode,
              dof=bool(float(megakernel._np(camera.aperture)) > 0.0))

    def render(params: dict, start_sample) -> torch.Tensor:
        unknown = sorted(set(params) - set(PARAM_KEYS))
        if unknown:
            raise KeyError(f"{unknown}: the kernel render differentiates "
                           f"only {PARAM_KEYS}")
        sc = G.apply_params(scene, params)
        meta = torch.from_numpy(megakernel.pack_meta(
            int(start_sample), seed, mtypes, light_prims)).to(scene.device)
        lsb = physics.lsel_bounds(sc.centers.detach(), sc.radii.detach(),
                                  sc.prim_valid)
        return _KernelRender.apply(megakernel.pack_blob_torch(sc, camera),
                                   meta, lsb, kw)

    return render
