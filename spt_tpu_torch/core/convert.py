"""Build the port's scene and camera from plain numpy arrays.

The arrays are the fields of the JAX package's ``SceneData`` and ``Camera``
(materials as ``materials.<field>``), so a test can hand one scene to both
packages and compare like with like.  ``Scene.compile`` goes through the
same function.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from .camera import Camera
from .materials import MaterialTable

_MATERIAL_FIELDS = ("albedo", "emission", "roughness", "ior", "mtype")
_DTYPES = dict(centers=np.float32, radii=np.float32, mat_id=np.int32,
               prim_valid=bool, light_idx=np.int32, light_valid=bool,
               sky_params=np.float32, albedo=np.float32,
               emission=np.float32, roughness=np.float32, ior=np.float32,
               mtype=np.int32)


def _tensor(name: str, value, device) -> torch.Tensor:
    a = np.ascontiguousarray(np.asarray(value, _DTYPES[name]))
    return torch.from_numpy(a.copy()).to(device)


def scene_data_from_arrays(arrays: Mapping[str, np.ndarray], *,
                           num_prims: int, num_lights: int, sky_mode: int,
                           device):
    """SceneData on ``device`` from numpy arrays named as its fields."""
    from .scene import SceneData
    materials = MaterialTable(**{
        f: _tensor(f, arrays[f"materials.{f}"], device)
        for f in _MATERIAL_FIELDS})
    env = arrays.get("env_map")
    return SceneData(
        **{f: _tensor(f, arrays[f], device)
           for f in ("centers", "radii", "mat_id", "prim_valid",
                     "light_idx", "light_valid", "sky_params")},
        materials=materials,
        env_map=(None if env is None else torch.from_numpy(
            np.asarray(env, np.float32).copy()).to(device)),
        num_prims=int(num_prims), num_lights=int(num_lights),
        sky_mode=int(sky_mode))


def camera_from_arrays(arrays: Mapping[str, np.ndarray], *, device) -> Camera:
    """Camera on ``device`` from numpy arrays named as its fields."""
    return Camera(**{
        f: torch.from_numpy(np.array(arrays[f], np.float32)).to(device)
        for f in ("position", "forward", "right", "up", "tan_half_fov",
                  "aperture", "focus_dist")})
