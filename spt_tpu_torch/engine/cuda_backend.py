"""The "cuda" backend: the progressive facade over the forward kernels.

Routed as the JAX package's "pallas" backend routes
(``spt_tpu/engine/pallas_backend.py``): every environment-map scene, and
every scene whose capacity is above ``WAVEFRONT_MIN_PRIMS``, goes to the
sorted wavefront (``wavefront.render_wavefront``: K5-K7); capacities from
129 to 2048 to ``megakernel_bvh.render_tiles_bvh`` (K3, the BVH walk); the
rest to ``megakernel.render_tiles`` (K1).  On the card each runs its CUDA
kernels, on the CPU their plain versions.  The ``"reference"`` integrator
(the reference renderer's semantics: fixed camera, 0.7 albedo, sky light
only) sums ``engine.integrator.render_reference_sample`` over the chunk's
frames, torch ops on the scene's device, as the JAX package's ``"jax"``
backend does (``spt_tpu/engine/api.py``).
"""

from __future__ import annotations

import torch

from ..core.scene import SKY_ENVMAP
from ..kernels import megakernel, megakernel_bvh, wavefront
from . import integrator
from .api import PathTracerBase, camera_has_dof, register_backend

# Above this capacity scenes go to the wavefront, as in the JAX package
# (where the number has no measurement behind it; ROADMAP.md keeps moving it
# for a benchmark with cells on both sides).
WAVEFRONT_MIN_PRIMS = 2048


def render_route(scene):
    """The forward render the facade routes ``scene`` to: every
    environment-map scene and every capacity above ``WAVEFRONT_MIN_PRIMS``
    to ``wavefront.render_wavefront``, capacities above
    ``megakernel.MAX_PRIMS`` (128) to ``megakernel_bvh.render_tiles_bvh``,
    the rest to ``megakernel.render_tiles``.  Each takes ``(scene, camera,
    width, height, start_sample, spp, *, max_bounces, rr_depth, use_nee,
    use_mis, seed, dof, row_offset, full_height)`` and returns the (H, W,
    3) radiance sum; the sharded renders (``parallel.sharding``) route
    their bands and sample windows through it too."""
    if scene.sky_mode == SKY_ENVMAP or scene.capacity > WAVEFRONT_MIN_PRIMS:
        return wavefront.render_wavefront
    if scene.capacity > megakernel.MAX_PRIMS:
        return megakernel_bvh.render_tiles_bvh
    return megakernel.render_tiles


class CudaPathTracer(PathTracerBase):
    backend_name = "cuda"

    def _render_samples(self, start_sample: int, spp: int) -> torch.Tensor:
        s = self._settings
        sd = self._scene_data
        if s.integrator == "reference":
            out = self._zeros(s)
            for f in range(start_sample, start_sample + spp):
                out = out + integrator.render_reference_sample(
                    sd, s.width, s.height, f)
            return out
        camera = self._camera or self._default_camera()
        return render_route(sd)(
            sd, camera, s.width, s.height, start_sample, spp,
            max_bounces=s.max_bounces, rr_depth=s.russian_roulette_depth,
            use_nee=s.use_nee, use_mis=s.use_mis, seed=s.seed,
            dof=camera_has_dof(camera))


register_backend("cuda", CudaPathTracer)
