"""The "cuda" backend: the progressive facade over the forward megakernels.

Scenes of at most ``megakernel.MAX_PRIMS`` (128) spheres go to
``megakernel.render_tiles`` (kernel K1 on the card, its plain version on
the CPU); larger ones to ``megakernel_bvh.render_tiles_bvh`` (K3, the BVH
walk).  Every size goes to K3: the sorted wavefront that the JAX package
takes above 2048 spheres is not ported.  Other routes raise
``NotImplementedError`` naming the ROADMAP.md item that ports them.
"""

from __future__ import annotations

import torch

from ..core.scene import SKY_ENVMAP
from ..kernels import megakernel, megakernel_bvh
from .api import PathTracerBase, camera_has_dof, register_backend


class CudaPathTracer(PathTracerBase):
    backend_name = "cuda"

    def _render_samples(self, start_sample: int, spp: int) -> torch.Tensor:
        s = self._settings
        sd = self._scene_data
        if s.integrator == "reference":
            raise NotImplementedError(
                "integrator='reference' is not ported yet: ROADMAP.md "
                "item 13, 'The \"reference\" integrator mode'")
        if sd.sky_mode == SKY_ENVMAP:
            raise NotImplementedError(
                "environment-map skies need the sorted wavefront (K5-K7), "
                "not ported yet: ROADMAP.md item 6, 'Sorted wavefront "
                "forward'")
        camera = self._camera or self._default_camera()
        render = (megakernel_bvh.render_tiles_bvh
                  if sd.capacity > megakernel.MAX_PRIMS
                  else megakernel.render_tiles)
        return render(
            sd, camera, s.width, s.height, start_sample, spp,
            max_bounces=s.max_bounces, rr_depth=s.russian_roulette_depth,
            use_nee=s.use_nee, use_mis=s.use_mis, seed=s.seed,
            dof=camera_has_dof(camera))


register_backend("cuda", CudaPathTracer)
