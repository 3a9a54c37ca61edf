"""spt_tpu_torch — the path tracer on PyTorch and CUDA for NVIDIA Hopper.

The port of ``spt_tpu`` (JAX on a TPU), which stays beside it as the
reference.  Ported so far, each hand-written CUDA kernel for ``sm_90a``
beside its plain PyTorch version for the CPU:

* slice 1: the progressive render facade (``create_path_tracer("cuda")``)
  over the forward megakernel K1;
* slice 2: the differentiable render of scenes of up to 128 spheres
  (``diff``): the fused forward+backward kernel K2 with a hand-written
  adjoint of the bounce, a ``torch.autograd.Function`` with K1 forward and
  K2 backward, and ``diff.gradients.InverseRenderer``;
* slice 3: the forward render of scenes above 128 spheres through the
  same facade: a BVH (``core.bvh``), its packing, and K3, which walks it
  per pixel;
* slice 4: the sorted wavefront (``kernels.wavefront``: K5 raygen, K6
  intersect, K7 shade, with torch-op glue between them), which the facade
  takes for environment-map skies and scenes above 2048 spheres;
* slice 5: the gradients of large scenes (``diff.cuda_diff``): K3 forward
  and K4, its fused backward, up to 2048 spheres, and the differentiable
  wavefront (``kernels.wavefront_grad``: K5, K6, K9 forward, K10 backward)
  above it and for environment-map skies;
* slice 6: distribution over ``torch.distributed`` (``parallel``): the
  sample-sharded wavefront and its data-parallel gradient, and the
  primitive-sharded wavefront over K8 (any-hit) and K7 reading the shadow
  verdict merged over the shards; ``tools/dist_worker.py`` spawns ranks;
* slice 7: the wavefront's other bounce forms, the fused bounce K11 (K11g
  under grad) and the matmul-form sweeps K6m and K7m;
* PRs 8-14 redesigned the kernels for Hopper (K1 and K3 persistent and
  regenerating paths, K2, K4 and K10 summing by warp, K6 and K7/K9 and K8
  walking the tree, K6m, K7m, K11 and K11g culling per ray, K7b inlined);
* the I/O, utilities and applications: scene files (``io.scene_json``),
  image writers (``io.image``, ``io.hdr``, ``io.exr``, the native display
  bridge ``io.native_display``), checkpoints (``io.checkpoint``),
  profiling on torch.profiler (``utils.profiling``), invariant checks
  (``utils.assertions``), the CLI renderer and the inverse-render demo
  (``python -m spt_tpu_torch.apps.render_cli`` / ``.inverse_render``);
  and the ``"reference"`` integrator (``engine.integrator``, torch ops over
  ``core.sampling``, ``core.intersect`` and ``core.bvh.intersect_bvh``),
  which the facade runs for ``RenderSettings.integrator = "reference"``.

Entry points run on the card unless the caller passes ``device="cpu"``
(the applications: ``--device cpu``).  See ROADMAP.md for what comes next.
"""

from .core.camera import Camera, ReferenceCamera
from .core.materials import (DIELECTRIC, LAMBERT, METAL, MaterialBuilder,
                             MaterialTable)
from .core.scene import (SKY_CONSTANT, SKY_ENVMAP, SKY_GRADIENT, SKY_NONE,
                         NodeType, Scene, SceneData, SceneNode, SphereObject,
                         Transform, demo_scene_38_spheres)
from .core.settings import RenderSettings
from . import diff
from .engine.api import RenderResult, create_path_tracer
from .utils.log import Level, Log, install_console_sink

__version__ = "0.1.0"

__all__ = [
    "Camera", "ReferenceCamera", "DIELECTRIC", "LAMBERT", "METAL",
    "MaterialBuilder", "MaterialTable", "NodeType", "Scene", "SceneData",
    "SceneNode", "SphereObject", "Transform", "demo_scene_38_spheres",
    "SKY_CONSTANT", "SKY_ENVMAP", "SKY_GRADIENT", "SKY_NONE",
    "RenderSettings", "RenderResult", "create_path_tracer", "Level", "Log",
    "install_console_sink", "diff",
]
