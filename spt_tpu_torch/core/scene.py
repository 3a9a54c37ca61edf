"""Scene graph and its compiled tensor form.

The host-side graph (integer node ids from a per-scene counter, ``NodeType``,
``Transform``, ``SceneNode`` / ``SphereObject``, a ``Scene`` registry with a
coarse dirty bit, per-node material ids, sky configuration, emissive spheres
as area lights) is the same as ``spt_tpu.core.scene``'s.

``Scene.compile()`` lowers the graph to ``SceneData``: flat SoA tensors on
an explicit device, sphere centers/radii/material ids padded to a
power-of-two capacity, the material table, the light index list, the sky
parameters and, for large scenes, a BVH (``core/bvh.py``).  The arrays are
built in numpy with the same code as the JAX package, so both packages
compile a scene to the same bits.
"""

from __future__ import annotations

import dataclasses
from enum import IntEnum
from typing import Dict, Optional

import numpy as np
import torch

from ..utils.device import DeviceLike, resolve_device
from .bvh import BVH
from .materials import MaterialBuilder, MaterialTable

# Scenes larger than this get a BVH at compile time; smaller ones use the
# brute-force sphere list.
BVH_AUTO_THRESHOLD = 512

# Sky modes.
SKY_NONE = 0
SKY_GRADIENT = 1   # the reference's sample_sky gradient
SKY_CONSTANT = 2
SKY_ENVMAP = 3     # equirectangular HDR environment map (IBL)


class NodeType(IntEnum):
    SCENE_ROOT = 0
    SPHERE_OBJECT = 1
    MATERIAL = 2
    GROUP = 3


def _quat_mul(q1, q2):
    w1, x1, y1, z1 = q1
    w2, x2, y2, z2 = q2
    return (
        w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
    )


@dataclasses.dataclass
class Transform:
    """Position / rotation (quaternion wxyz) / scale."""

    position: tuple = (0.0, 0.0, 0.0)
    rotation: tuple = (1.0, 0.0, 0.0, 0.0)
    scale: tuple = (1.0, 1.0, 1.0)

    def __mul__(self, other: "Transform") -> "Transform":
        # Positions add, rotations multiply, scales multiply componentwise.
        return Transform(
            position=tuple(a + b for a, b in zip(self.position, other.position)),
            rotation=_quat_mul(self.rotation, other.rotation),
            scale=tuple(a * b for a, b in zip(self.scale, other.scale)),
        )


class SceneNode:
    """Base node: id, name, type, local transform."""

    def __init__(self, name: str = "", node_type: NodeType = NodeType.GROUP):
        self.id: int = 0  # assigned by Scene.create_node
        self.name = name
        self.node_type = node_type
        self.transform = Transform()
        self._scene: Optional["Scene"] = None

    def get_id(self) -> int:
        return self.id

    def get_name(self) -> str:
        return self.name

    def get_type(self) -> NodeType:
        return self.node_type

    def set_position(self, x, y, z) -> None:
        self.transform.position = (float(x), float(y), float(z))
        if self._scene is not None:
            self._scene.mark_changed()

    def get_position(self) -> tuple:
        return self.transform.position


class SphereObject(SceneNode):
    """Sphere primitive node with a material binding."""

    def __init__(self, name: str = "sphere", radius: float = 1.0,
                 material: int = 0):
        super().__init__(name, NodeType.SPHERE_OBJECT)
        self.radius = float(radius)
        self.material = int(material)

    def get_radius(self) -> float:
        return self.radius

    def set_radius(self, r: float) -> None:
        self.radius = float(r)
        if self._scene is not None:
            self._scene.mark_changed()


@dataclasses.dataclass(frozen=True)
class SceneData:
    """Compiled scene: flat SoA tensors on one device, statically padded.

    ``prim_valid`` masks padding rows, so the capacity bucket (next power of
    two), not the live count, sets the shapes.
    """

    centers: torch.Tensor     # (P, 3) f32
    radii: torch.Tensor       # (P,)  f32
    mat_id: torch.Tensor      # (P,)  i32
    prim_valid: torch.Tensor  # (P,)  bool
    materials: MaterialTable
    light_idx: torch.Tensor    # (L,) i32 — prim indices of emissive spheres
    light_valid: torch.Tensor  # (L,) bool
    sky_params: torch.Tensor   # (2, 3) f32 — [horizon/constant, zenith]
    bvh: Optional[BVH]         # None for small scenes
    env_map: Optional[torch.Tensor]  # (He, We, 3) f32 equirect radiance
    num_prims: int
    num_lights: int
    sky_mode: int

    @property
    def capacity(self) -> int:
        return self.centers.shape[0]

    @property
    def device(self) -> torch.device:
        return self.centers.device


def _pad_pow2(n: int, minimum: int = 8) -> int:
    c = minimum
    while c < n:
        c *= 2
    return c


class Scene:
    """Node registry with the dirty protocol."""

    def __init__(self):
        self._nodes: Dict[int, SceneNode] = {}
        self._next_id = 1
        self._has_changes = True  # scenes start dirty
        self.materials = MaterialBuilder()
        self.sky_mode = SKY_GRADIENT
        # Horizon white -> zenith light blue.
        self.sky_horizon = (1.0, 1.0, 1.0)
        self.sky_zenith = (0.5, 0.7, 1.0)
        self.env_map = None       # (He, We, 3) float radiance, equirectangular
        self.env_map_path = None  # source file of env_map, if loaded from one

    # -- node management ----------------------------------------------------
    def create_node(self, node: SceneNode) -> SceneNode:
        node.id = self._next_id
        self._next_id += 1
        node._scene = self
        self._nodes[node.id] = node
        self._has_changes = True
        return node

    def create_sphere(self, name="sphere", position=(0.0, 0.0, 0.0),
                      radius=1.0, material=0) -> SphereObject:
        sphere = SphereObject(name, radius, material)
        self.create_node(sphere)
        sphere.set_position(*position)
        return sphere

    def delete_node(self, node_id: int) -> bool:
        if node_id in self._nodes:
            self._nodes.pop(node_id)._scene = None
            self._has_changes = True
            return True
        return False

    def find_node(self, key) -> Optional[SceneNode]:
        """Find by id (int) or by name (str)."""
        if isinstance(key, int):
            return self._nodes.get(key)
        for node in self._nodes.values():
            if node.name == key:
                return node
        return None

    def get_all_nodes(self) -> Dict[int, SceneNode]:
        return dict(self._nodes)

    # -- materials / sky ----------------------------------------------------
    def add_material(self, kind="lambert", **kwargs) -> int:
        self._has_changes = True
        return self.materials.add(kind, **kwargs)

    def set_sky(self, mode=SKY_GRADIENT, horizon=None, zenith=None):
        self.sky_mode = mode
        if horizon is not None:
            self.sky_horizon = tuple(horizon)
        if zenith is not None:
            self.sky_zenith = tuple(zenith)
        self._has_changes = True

    def set_environment_map(self, image, path: Optional[str] = None) -> None:
        """Image-based lighting from an equirectangular radiance map."""
        self.env_map = np.asarray(image, np.float32)
        if self.env_map.ndim != 3 or self.env_map.shape[2] != 3:
            raise ValueError("environment map must be (H, W, 3)")
        self.sky_mode = SKY_ENVMAP
        self.env_map_path = path
        self._has_changes = True

    # -- dirty protocol -----------------------------------------------------
    def has_changes(self) -> bool:
        return self._has_changes

    def mark_changed(self) -> None:
        self._has_changes = True

    def mark_changes_processed(self) -> None:
        self._has_changes = False

    # -- compile ------------------------------------------------------------
    def compile_arrays(self, capacity: Optional[int] = None,
                       light_capacity: Optional[int] = None) -> dict:
        """The compiled scene as numpy arrays, named as SceneData's fields
        (materials as ``materials.<field>``), plus its static ints."""
        spheres = [n for n in self._nodes.values()
                   if n.node_type == NodeType.SPHERE_OBJECT]
        spheres.sort(key=lambda n: n.id)  # deterministic order
        n = len(spheres)
        cap = capacity or _pad_pow2(max(n, 1))
        if cap < n:
            raise ValueError(f"capacity {cap} < {n} spheres")

        centers = np.zeros((cap, 3), np.float32)
        radii = np.zeros((cap,), np.float32)
        mat_id = np.zeros((cap,), np.int32)
        valid = np.zeros((cap,), bool)
        for i, s in enumerate(spheres):
            centers[i] = s.transform.position
            # Uniform scale multiplies the radius; nonuniform is out of scope.
            radii[i] = s.radius * float(s.transform.scale[0])
            mat_id[i] = s.material
            valid[i] = True

        # An empty builder yields default_table's 0.7 gray Lambertian.
        mats = (self.materials if self.materials._rows
                else MaterialBuilder()).build_arrays()
        is_light = valid & (mats["emission"][mat_id].sum(-1) > 0.0)
        light_indices = np.nonzero(is_light)[0].astype(np.int32)
        nl = len(light_indices)
        lcap = light_capacity or _pad_pow2(max(nl, 1), minimum=4)
        light_idx = np.zeros((lcap,), np.int32)
        light_valid = np.zeros((lcap,), bool)
        light_idx[:nl] = light_indices
        light_valid[:nl] = True

        arrays = dict(centers=centers, radii=radii, mat_id=mat_id,
                      prim_valid=valid, light_idx=light_idx,
                      light_valid=light_valid,
                      sky_params=np.array([self.sky_horizon, self.sky_zenith],
                                          np.float32))
        arrays.update({f"materials.{k}": v for k, v in mats.items()})
        if self.env_map is not None:
            arrays["env_map"] = self.env_map
        return dict(arrays=arrays, num_prims=n, num_lights=nl,
                    sky_mode=self.sky_mode)

    def compile(self, capacity: Optional[int] = None,
                light_capacity: Optional[int] = None,
                use_bvh: Optional[bool] = None,
                device: DeviceLike = None) -> SceneData:
        """Compile to ``SceneData`` on ``device`` (default: the card)."""
        device = resolve_device(device)
        out = self.compile_arrays(capacity, light_capacity)
        if use_bvh is None:
            use_bvh = out["num_prims"] > BVH_AUTO_THRESHOLD
        from .convert import scene_data_from_arrays
        sd = scene_data_from_arrays(
            out["arrays"], num_prims=out["num_prims"],
            num_lights=out["num_lights"], sky_mode=out["sky_mode"],
            device=device)
        if not use_bvh:
            return sd
        from .bvh import MAX_LEAF, build_bvh
        a = out["arrays"]
        return dataclasses.replace(sd, bvh=build_bvh(
            a["centers"], a["radii"], valid=a["prim_valid"],
            max_leaf=MAX_LEAF, device=device))


def demo_scene_38_spheres() -> Scene:
    """The reference app's demo scene.

    Sphere r=1 at (0,−1,5); ground sphere r=100 at (0,−102,5); 6×6 grid of
    r=0.5 spheres at x,y ∈ {−5,−3,−1,1,3,5}, z=10 — 38 spheres total.
    """
    scene = Scene()
    m = scene.add_material("lambert", albedo=(0.7, 0.7, 0.7))
    scene.create_sphere("sphere", (0.0, -1.0, 5.0), 1.0, m)
    scene.create_sphere("ground", (0.0, -102.0, 5.0), 100.0, m)
    for ix, x in enumerate((-5.0, -3.0, -1.0, 1.0, 3.0, 5.0)):
        for iy, y in enumerate((-5.0, -3.0, -1.0, 1.0, 3.0, 5.0)):
            scene.create_sphere(f"grid_{ix}_{iy}", (x, y, 10.0), 0.5, m)
    return scene
