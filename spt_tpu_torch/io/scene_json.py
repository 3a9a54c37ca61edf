"""JSON scene format: loader and writer.

The port of ``spt_tpu/io/scene_json.py``, over this package's ``Scene``,
``Camera`` and ``RenderSettings``: the same schema, so a file either
package writes loads in the other.  Top-level ``scene`` (camera /
environment / objects / materials), ``render`` (samples / maxBounces /
resolution / ...) and ``postProcess`` (tonemap / exposure / gamma) blocks.
Material types: ``lambert`` (also ``diffuse``), ``metal`` / ``metallic`` /
``ggx``, ``dielectric`` / ``glass``; any material may carry ``emission``.
Environment types: ``gradient`` (horizon/zenith), ``constant``, ``none``,
and ``hdri``, an equirectangular radiance map loaded from ``path`` (.npy
float, .hdr Radiance RGBE, or an LDR image Pillow reads, sRGB-decoded to
linear) scaled by ``intensity``.
"""

from __future__ import annotations

import json
from typing import Optional, Tuple

import numpy as np

from ..core.camera import Camera
from ..core.scene import (SKY_CONSTANT, SKY_ENVMAP, SKY_GRADIENT, SKY_NONE,
                          NodeType, Scene)
from ..core.settings import RenderSettings
from ..utils.device import DeviceLike
from ..utils.log import Log

_MAT_KIND = {"lambert": "lambert", "diffuse": "lambert",
             "metal": "metal", "metallic": "metal", "ggx": "metal",
             "dielectric": "glass", "glass": "glass"}


def load_env_map(path: str) -> np.ndarray:
    """Load an equirectangular radiance map: .npy (float), .hdr (Radiance
    RGBE), or an LDR image Pillow reads (sRGB-decoded to linear; without
    Pillow that raises ImportError)."""
    if path.endswith(".npy"):
        arr = np.load(path).astype(np.float32)
    elif path.lower().endswith(".hdr"):
        from .hdr import read_hdr
        arr = read_hdr(path)
    else:
        from PIL import Image
        arr = np.asarray(Image.open(path).convert("RGB"), np.float32) / 255.0
        arr = arr ** 2.2  # sRGB-ish decode to linear radiance
    if arr.ndim != 3 or arr.shape[2] != 3:
        raise ValueError(f"environment map {path!r} must decode to (H, W, 3)")
    return arr


def load_scene(path_or_dict, device: DeviceLike = None
               ) -> Tuple[Scene, Optional[Camera], RenderSettings]:
    """Load a scene file; returns (scene, camera_or_None, settings).  The
    camera's tensors lie on ``device`` (the card unless the caller asks
    for the CPU); the scene compiles onto a device of its own choosing."""
    if isinstance(path_or_dict, dict):
        doc = path_or_dict
    else:
        with open(path_or_dict) as f:
            doc = json.load(f)

    sc = doc.get("scene", doc)
    scene = Scene()

    # Materials.
    name_to_id = {}
    for name, m in sc.get("materials", {}).items():
        kind = _MAT_KIND.get(str(m.get("type", "lambert")).lower())
        if kind is None:
            raise ValueError(f"unknown material type {m.get('type')!r} "
                             f"for material {name!r}")
        name_to_id[name] = scene.add_material(
            kind,
            albedo=tuple(m.get("albedo", (0.7, 0.7, 0.7))),
            emission=tuple(m.get("emission", (0.0, 0.0, 0.0))),
            roughness=float(m.get("roughness", 0.5)),
            ior=float(m.get("ior", 1.5)))
    default_mat = None

    # Objects.
    for i, obj in enumerate(sc.get("objects", [])):
        typ = str(obj.get("type", "sphere")).lower()
        if typ != "sphere":
            raise ValueError(f"unsupported object type {typ!r} (objects[{i}])")
        mref = obj.get("material")
        if mref is None:
            if default_mat is None:
                default_mat = scene.add_material("lambert")
            mat = default_mat
        elif isinstance(mref, str):
            if mref not in name_to_id:
                raise ValueError(f"objects[{i}] references unknown material "
                                 f"{mref!r}")
            mat = name_to_id[mref]
        else:
            mat = int(mref)
        scene.create_sphere(
            obj.get("name", f"sphere_{i}"),
            tuple(obj.get("center", (0.0, 0.0, 0.0))),
            float(obj.get("radius", 1.0)), mat)

    # Environment.
    env = sc.get("environment", {})
    etype = str(env.get("type", "gradient")).lower()
    if etype == "gradient":
        scene.set_sky(SKY_GRADIENT,
                      horizon=env.get("horizon", (1.0, 1.0, 1.0)),
                      zenith=env.get("zenith", (0.5, 0.7, 1.0)))
    elif etype == "constant":
        c = env.get("color", (1.0, 1.0, 1.0))
        inten = float(env.get("intensity", 1.0))
        scene.set_sky(SKY_CONSTANT, horizon=[x * inten for x in c])
    elif etype == "none":
        scene.set_sky(SKY_NONE)
    elif etype == "hdri":
        path = env.get("path")
        inten = float(env.get("intensity", 1.0))
        if path:
            scene.set_environment_map(load_env_map(path) * inten, path=path)
        else:
            Log.warn("hdri environment without 'path'; using constant "
                     "intensity fallback")
            scene.set_sky(SKY_CONSTANT, horizon=(inten,) * 3)
    else:
        raise ValueError(f"unknown environment type {etype!r}")

    # Camera.
    camera = None
    cam = sc.get("camera")
    if cam is not None:
        camera = Camera.look_at(
            tuple(cam.get("position", (0.0, 0.0, 0.0))),
            tuple(cam.get("target", (0.0, 0.0, 1.0))),
            up=tuple(cam.get("up", (0.0, 1.0, 0.0))),
            fov_degrees=float(cam.get("fov", 45.0)),
            aperture=float(cam.get("aperture", 0.0)),
            focus_dist=cam.get("focusDistance"), device=device)

    # Render + post-process settings.
    settings = RenderSettings()
    rnd = doc.get("render", {})
    res = rnd.get("resolution")
    if res:
        settings.set_resolution(int(res[0]), int(res[1]))
    if "samples" in rnd:
        settings.samples_per_pixel = int(rnd["samples"])
    if "maxBounces" in rnd:
        settings.max_bounces = int(rnd["maxBounces"])
    if "russianRouletteDepth" in rnd:
        settings.russian_roulette_depth = int(rnd["russianRouletteDepth"])
    if "seed" in rnd:
        settings.seed = int(rnd["seed"])
    if "nee" in rnd:
        settings.use_nee = bool(rnd["nee"])
    if "mis" in rnd:
        settings.use_mis = bool(rnd["mis"])
    post = doc.get("postProcess", {})
    if "tonemap" in post:
        settings.tonemap = str(post["tonemap"]).lower()
    if "exposure" in post:
        settings.exposure = float(post["exposure"])
    if "gamma" in post:
        settings.gamma = float(post["gamma"])
    return scene, camera, settings


def _floats(t) -> list:
    """A camera tensor (any device) as a list of Python floats."""
    return [float(x) for x in np.asarray(t.detach().cpu().numpy(),
                                         np.float32).reshape(-1)]


def save_scene(path: str, scene: Scene, camera: Optional[Camera] = None,
               settings: Optional[RenderSettings] = None) -> None:
    """Serialize a Scene (+camera/settings) back to the JSON schema.  An
    environment map with no source file (``Scene.env_map_path``) is written
    beside the scene as ``<path>.envmap.hdr`` (Radiance RGBE, about 1%
    precision)."""
    mats = {}
    kind_names = {0: "lambert", 1: "metal", 2: "dielectric"}
    for i, (albedo, emission, roughness, ior, mtype) in enumerate(
            scene.materials._rows):
        mats[f"m{i}"] = {
            "type": kind_names[mtype], "albedo": list(albedo),
            "emission": list(emission), "roughness": roughness, "ior": ior}
    objects = []
    for node in scene.get_all_nodes().values():
        if node.node_type == NodeType.SPHERE_OBJECT:
            objects.append({
                "type": "sphere", "name": node.name,
                "center": list(node.transform.position),
                "radius": node.radius, "material": f"m{node.material}"})
    if scene.sky_mode == SKY_ENVMAP:
        # Round-trip the map: reuse the source path when the scene remembers
        # one, otherwise dump the radiance array next to the scene file.
        env_path = scene.env_map_path
        if env_path is None:
            env_path = path + ".envmap.hdr"
            from .hdr import write_hdr
            write_hdr(env_path, scene.env_map)
        env = {"type": "hdri", "path": env_path}
    else:
        env = {"type": {SKY_GRADIENT: "gradient", SKY_CONSTANT: "constant",
                        SKY_NONE: "none"}[scene.sky_mode],
               "horizon": list(scene.sky_horizon),
               "zenith": list(scene.sky_zenith)}
    doc = {"scene": {"materials": mats, "objects": objects,
                     "environment": env}}
    if camera is not None:
        pos = np.asarray(_floats(camera.position), np.float32)
        fwd = np.asarray(_floats(camera.forward), np.float32)
        fov = float(np.degrees(2.0 * np.arctan(
            _floats(camera.tan_half_fov)[0])))
        doc["scene"]["camera"] = {
            "position": [float(x) for x in pos],
            "target": [float(x) for x in pos + fwd],
            "fov": fov}
        aperture = _floats(camera.aperture)[0]
        if aperture > 0.0:
            doc["scene"]["camera"]["aperture"] = aperture
            doc["scene"]["camera"]["focusDistance"] = \
                _floats(camera.focus_dist)[0]
    if settings is not None:
        doc["render"] = {
            "resolution": [settings.width, settings.height],
            "samples": settings.samples_per_pixel,
            "maxBounces": settings.max_bounces,
            "nee": settings.use_nee, "mis": settings.use_mis,
            "seed": settings.seed}
        doc["postProcess"] = {"tonemap": settings.tonemap,
                              "exposure": settings.exposure,
                              "gamma": settings.gamma}
    with open(path, "w") as f:
        json.dump(doc, f, indent=2)
