"""Engine facade: the PathTracer contract + backend factory.

A progressive render session with the invalidation protocol

  * scene dirty       -> reset accumulation, recompile scene buffers
  * settings dirty    -> reset accumulation
  * resolution change -> reallocate + reset
  * frame_count == 0  -> zero the accumulation buffer

shared by every backend; a backend supplies only ``_render_samples``.  The
session lives on one device: the card unless the caller asks for the CPU.
Unknown backends raise ``ValueError``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from ..core import color
from ..core.camera import Camera
from ..core.scene import NodeType, Scene, SceneData
from ..core.settings import RenderSettings
from ..utils.device import DeviceLike, resolve_device
from ..utils.log import Log


@dataclasses.dataclass
class RenderResult:
    """The packed display image plus the float image."""

    image_buffer: torch.Tensor  # (H, W) uint32 RGBA8888, R in high byte
    width: int
    height: int
    image_f32: torch.Tensor     # (H, W, 3) float display image in [0, 1]


class PathTracerBase:
    """Backend-agnostic progressive render session on one device."""

    backend_name = "base"

    def __init__(self, device: DeviceLike = None):
        self.device = resolve_device(device)
        self._scene: Optional[Scene] = None
        self._scene_data: Optional[SceneData] = None
        self._settings = RenderSettings()
        self._camera: Optional[Camera] = None
        self._accum: Optional[torch.Tensor] = None  # (H, W, 3) radiance sum
        self._frame_count: int = 0                  # samples accumulated
        self._accum_shape = (0, 0)

    # -- the PathTracer contract -------------------------------------------
    def set_scene(self, scene: Scene) -> None:
        self._scene = scene

    def set_settings(self, settings: RenderSettings) -> None:
        self._settings = settings

    def get_settings(self) -> RenderSettings:
        return self._settings

    def set_camera(self, camera: Camera) -> None:
        self._camera = camera
        self.reset_accumulation()

    def get_backend_name(self) -> str:
        return self.backend_name

    def reset_accumulation(self) -> None:
        self._frame_count = 0

    @property
    def frame_count(self) -> int:
        return self._frame_count

    @property
    def scene_data(self) -> Optional[SceneData]:
        return self._scene_data

    def _zeros(self, s: RenderSettings) -> torch.Tensor:
        return torch.zeros((s.height, s.width, 3), dtype=torch.float32,
                           device=self.device)

    # -- invalidation protocol ---------------------------------------------
    def _invalidate(self) -> None:
        s = self._settings
        if self._scene is None:
            raise RuntimeError("Scene not set before rendering")
        needs_rebuild = self._scene_data is None
        if self._scene.has_changes():
            self._frame_count = 0
            needs_rebuild = True
        if s.is_dirty():
            self._frame_count = 0
            s.clear_dirty()
        if self._accum_shape != (s.height, s.width):
            self._accum_shape = (s.height, s.width)
            self._accum = self._zeros(s)
            self._frame_count = 0
        if self._frame_count == 0:
            self._accum = self._zeros(s)
        if needs_rebuild:
            capacity = None
            if self._scene_data is not None:
                # Keep the capacity bucket if it still fits.
                live = sum(1 for n in self._scene.get_all_nodes().values()
                           if n.node_type == NodeType.SPHERE_OBJECT)
                if live <= self._scene_data.capacity:
                    capacity = self._scene_data.capacity
            self._scene_data = self._scene.compile(capacity=capacity,
                                                   device=self.device)
            self._scene.mark_changes_processed()
            Log.info(f"Recompiled scene: {self._scene_data.num_prims} prims, "
                     f"{self._scene_data.num_lights} lights, "
                     f"capacity {self._scene_data.capacity}")

    # -- rendering ----------------------------------------------------------
    def render(self, spp: Optional[int] = None) -> None:
        """Trace one progressive chunk (default: 1 spp when progressive,
        else all samples_per_pixel)."""
        self._invalidate()
        s = self._settings
        if spp is None:
            spp = 1 if s.progressive else s.samples_per_pixel
        start = self._frame_count
        chunk = self._render_samples(start, spp)
        self._accum = self._accum + chunk
        self._frame_count += spp

    def render_to_completion(self, chunk_spp: Optional[int] = None) -> None:
        """Accumulate until samples_per_pixel is reached: chunks of 32 spp
        when progressive, else one launch."""
        self._invalidate()
        target = self._settings.samples_per_pixel
        if chunk_spp is None:
            chunk_spp = 32 if self._settings.progressive else max(target, 1)
        while self._frame_count < target:
            self.render(spp=min(chunk_spp, target - self._frame_count))

    def _render_samples(self, start_sample: int, spp: int) -> torch.Tensor:
        raise NotImplementedError

    def get_render_result(self) -> RenderResult:
        if self._frame_count <= 0:
            raise RuntimeError("No frames rendered yet")
        s = self._settings
        img = color.finalize_image(
            self._accum, self._frame_count, exposure=s.exposure,
            tonemap=s.tonemap, gamma=s.gamma, auto_exposure=s.auto_exposure,
            target_exposure=s.target_exposure)
        return RenderResult(image_buffer=color.pack_rgba8(img),
                            width=s.width, height=s.height, image_f32=img)

    # -- checkpoint of progressive state -----------------------------------
    def get_state(self) -> dict:
        return {"accum": self._accum, "frame_count": self._frame_count}

    def set_state(self, state: dict) -> None:
        self._invalidate()
        self._accum = torch.as_tensor(state["accum"], dtype=torch.float32,
                                      device=self.device)
        self._accum_shape = tuple(self._accum.shape[:2])
        self._frame_count = int(state["frame_count"])

    def _default_camera(self) -> Camera:
        return Camera.look_at((0.0, 0.0, 0.0), (0.0, 0.0, 1.0),
                              fov_degrees=90.0, device=self.device)


def camera_has_dof(camera) -> bool:
    """Thin-lens iff the camera has a real aperture (host-known value)."""
    ap = getattr(camera, "aperture", None)
    return ap is not None and float(ap) > 0.0


_BACKENDS: Dict[str, type] = {}


def register_backend(name: str, cls: type) -> None:
    _BACKENDS[name] = cls


def create_path_tracer(backend: str = "cuda",
                       device: DeviceLike = None) -> PathTracerBase:
    """Backend factory; raises ValueError on an unknown backend.

    ``device`` defaults to the card; pass ``"cpu"`` to run the plain
    PyTorch versions of the kernels."""
    from . import cuda_backend  # noqa: F401  (registers "cuda")
    if backend not in _BACKENDS:
        raise ValueError(f"Unsupported backend type: {backend!r} "
                         f"(available: {sorted(_BACKENDS)})")
    tracer = _BACKENDS[backend](device)
    Log.info(f"Created path tracer backend '{backend}' on {tracer.device}")
    return tracer
