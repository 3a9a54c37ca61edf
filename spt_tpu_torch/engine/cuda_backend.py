"""The "cuda" backend: the progressive facade over the forward megakernel.

Scenes of at most ``megakernel.MAX_PRIMS`` (128) spheres go to
``megakernel.render_tiles`` (kernel K1 on the card, its plain version on
the CPU).  The 128 is K1's own limit, kept only because K1 is the one
engine ported so far; every other route raises ``NotImplementedError``
naming the ROADMAP.md item that ports it.
"""

from __future__ import annotations

import torch

from ..core.scene import SKY_ENVMAP
from ..kernels import megakernel
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
        if sd.capacity > megakernel.MAX_PRIMS:
            raise NotImplementedError(
                f"scenes above {megakernel.MAX_PRIMS} spheres need the BVH "
                "megakernel (K3), not ported yet: ROADMAP.md item 5, "
                "'BVH megakernel (K3)'")
        camera = self._camera or self._default_camera()
        return megakernel.render_tiles(
            sd, camera, s.width, s.height, start_sample, spp,
            max_bounces=s.max_bounces, rr_depth=s.russian_roulette_depth,
            use_nee=s.use_nee, use_mis=s.use_mis, seed=s.seed,
            dof=camera_has_dof(camera))


register_backend("cuda", CudaPathTracer)
