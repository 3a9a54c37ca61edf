"""Render settings with dirty-flag tracking.

Mirrors the reference renderer's ``render::RenderSettings`` API surface
(its render/Types.h and RenderSettings.cpp): width/height (512×512), progressive (True),
samples_per_pixel (64), max_bounces (8), russian_roulette_depth (3),
exposure (1.0), auto_exposure (False, target 0.18); every setter marks the
object dirty only when the value actually changes, and the engine resets
progressive accumulation when it observes the dirty bit.

Unlike the reference — which stores but *ignores* spp / max_bounces / RR
depth / exposure (SURVEY.md §2.1/C4) — this framework honors every field.
Fields added beyond the reference: tonemap / gamma (the reference's planned
post-processing, Math.h stub), rng ("counter" native vs "reference"
bit-exact), and backend selection lives on the engine instead.
"""

from __future__ import annotations

import dataclasses
from typing import Any


@dataclasses.dataclass
class RenderSettings:
    width: int = 512
    height: int = 512
    progressive: bool = True
    samples_per_pixel: int = 64
    max_bounces: int = 8
    russian_roulette_depth: int = 3
    exposure: float = 1.0
    auto_exposure: bool = False
    target_exposure: float = 0.18
    # Framework extensions (not in the reference's struct):
    tonemap: str = "none"        # "none" | "reinhard" | "aces"
    gamma: float = 1.0           # 1.0 = no correction (reference behavior)
    use_nee: bool = True         # next-event estimation for area lights
    use_mis: bool = True         # MIS between BSDF and light sampling
    rng: str = "counter"         # "counter" (native) | "reference" (bit-exact)
    integrator: str = "full"     # "full" (NEE/MIS/materials) | "reference"
    seed: int = 0

    def __post_init__(self):
        object.__setattr__(self, "_dirty", True)

    # -- dirty protocol (RenderSettings.cpp:5-55 semantics) -----------------
    def __setattr__(self, name: str, value: Any) -> None:
        if not name.startswith("_") and hasattr(self, name):
            if getattr(self, name) != value:
                object.__setattr__(self, "_dirty", True)
            else:
                return
        object.__setattr__(self, name, value)

    def is_dirty(self) -> bool:
        return self._dirty

    def clear_dirty(self) -> None:
        object.__setattr__(self, "_dirty", False)

    def mark_dirty(self) -> None:
        object.__setattr__(self, "_dirty", True)

    # -- setter aliases mirroring the reference's camelCase API -------------
    def set_resolution(self, width: int, height: int) -> None:
        self.width = width
        self.height = height

    def get_width(self) -> int:
        return self.width

    def get_height(self) -> int:
        return self.height
