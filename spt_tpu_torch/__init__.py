"""spt_tpu_torch — the path tracer on PyTorch and CUDA for NVIDIA Hopper.

The port of ``spt_tpu`` (JAX on a TPU), which stays beside it as the
reference.  Ported so far: the progressive render facade over the forward
megakernel K1, a hand-written CUDA kernel for ``sm_90a``, with its plain
PyTorch version for the CPU.  Entry points run on the card unless the
caller passes ``device="cpu"``.  See ROADMAP.md for what comes next.
"""

from .core.camera import Camera, ReferenceCamera
from .core.materials import (DIELECTRIC, LAMBERT, METAL, MaterialBuilder,
                             MaterialTable)
from .core.scene import (SKY_CONSTANT, SKY_ENVMAP, SKY_GRADIENT, SKY_NONE,
                         NodeType, Scene, SceneData, SceneNode, SphereObject,
                         Transform, demo_scene_38_spheres)
from .core.settings import RenderSettings
from .engine.api import RenderResult, create_path_tracer
from .utils.log import Level, Log, install_console_sink

__version__ = "0.1.0"

__all__ = [
    "Camera", "ReferenceCamera", "DIELECTRIC", "LAMBERT", "METAL",
    "MaterialBuilder", "MaterialTable", "NodeType", "Scene", "SceneData",
    "SceneNode", "SphereObject", "Transform", "demo_scene_38_spheres",
    "SKY_CONSTANT", "SKY_ENVMAP", "SKY_GRADIENT", "SKY_NONE",
    "RenderSettings", "RenderResult", "create_path_tracer", "Level", "Log",
    "install_console_sink",
]
