"""Material system: a flat SoA material table, one row per material.

Shading is branchless over material types; primitives carry integer
material ids into the table.

  LAMBERT     — albedo/π diffuse, cosine-sampled.
  METAL       — GGX conductor, Schlick F with f0 = albedo.
  DIELECTRIC  — smooth glass, exact Fresnel, reflect/refract, tint = albedo.
  Any material may also emit (emission > 0) — emitters drive NEE.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

LAMBERT = 0
METAL = 1
DIELECTRIC = 2

_TYPE_NAMES = {"lambert": LAMBERT, "diffuse": LAMBERT,
               "metal": METAL, "ggx": METAL,
               "dielectric": DIELECTRIC, "glass": DIELECTRIC}


@dataclasses.dataclass(frozen=True)
class MaterialTable:
    """SoA material table; all tensors share leading dim M (num materials)."""

    albedo: torch.Tensor     # (M, 3) f32 — diffuse albedo / metal f0 / glass tint
    emission: torch.Tensor   # (M, 3) f32 — emitted radiance
    roughness: torch.Tensor  # (M,)  f32 — GGX perceptual roughness
    ior: torch.Tensor        # (M,)  f32 — dielectric index of refraction
    mtype: torch.Tensor      # (M,)  i32 — LAMBERT / METAL / DIELECTRIC

    @property
    def num_materials(self) -> int:
        return self.albedo.shape[0]


class MaterialBuilder:
    """Host-side accumulation of materials into a MaterialTable."""

    def __init__(self):
        self._rows: list[tuple] = []

    def add(self, kind: str = "lambert", albedo=(0.7, 0.7, 0.7),
            emission=(0.0, 0.0, 0.0), roughness: float = 0.5,
            ior: float = 1.5) -> int:
        mtype = _TYPE_NAMES[kind.lower()]
        idx = len(self._rows)
        self._rows.append((tuple(albedo), tuple(emission), float(roughness),
                           float(ior), mtype))
        return idx

    def build_arrays(self) -> dict:
        """The table as numpy arrays (the bit-exact host form)."""
        if not self._rows:
            self.add()  # default 0.7 Lambertian (the reference's one material)
        return dict(
            albedo=np.array([r[0] for r in self._rows], np.float32),
            emission=np.array([r[1] for r in self._rows], np.float32),
            roughness=np.array([r[2] for r in self._rows], np.float32),
            ior=np.array([r[3] for r in self._rows], np.float32),
            mtype=np.array([r[4] for r in self._rows], np.int32))

    def build(self, device="cpu") -> MaterialTable:
        return MaterialTable(**{k: torch.from_numpy(v).to(device)
                                for k, v in self.build_arrays().items()})


def default_table(device="cpu") -> MaterialTable:
    """The reference's implicit material: 0.7 gray Lambertian for everything."""
    b = MaterialBuilder()
    b.add("lambert", albedo=(0.7, 0.7, 0.7))
    return b.build(device)
