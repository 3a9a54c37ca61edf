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
  per pixel.

Entry points run on the card unless the caller passes ``device="cpu"``.
See ROADMAP.md for what comes next.
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
