"""Scenes and camera poses of the benchmark's configurations, from the
configuration file and the run's seed.

``describe(config, seed)`` returns the scene as plain numpy arrays
(spheres, materials, sky), the description that both sides are handed:
``port_scene`` builds the program's ``Scene`` from it through the port's
own API, and the reference (``reference/render.py``) builds its tables
from it.  Two kinds of scene are known:

* ``"spheres"``: the spheres and materials listed in the file;
* ``"random_spheres"``: a cloud of ``count`` spheres drawn from the
  configuration's ``layout_seed`` as ``bench_suite.py``'s ``scene_10k``
  draws it (numpy's ``default_rng``, the same distributions and order of
  draws: the Lambert albedos, then the centres, then the radii), with an
  emitter on every ``emit_every``-th sphere.  The layout is the
  deployment's, the same in every run, so that runs of different seeds do
  the same work.

``pose(config, seed, index)`` is the camera pose {position, target,
fov_degrees} of image ``index``: the configuration's pose with every
coordinate moved uniformly within ``position_jitter`` and
``target_jitter``, drawn from the seed and the index.
"""

from __future__ import annotations

import numpy as np

MTYPES = {"lambert": 0, "metal": 1, "glass": 2}
SKY_MODES = {"none": 0, "gradient": 1, "constant": 2}


def seed_words(seed: int, *more: int) -> list:
    """Nonnegative words for numpy's SeedSequence from any whole seed."""
    return [int(seed) & 0xFFFFFFFF, (int(seed) >> 32) & 0xFFFFFFFF,
            1 if seed < 0 else 0, *more]


def _material_rows(mats: list) -> dict:
    return dict(
        albedo=np.array([m["albedo"] for m in mats], np.float32),
        emission=np.array([m.get("emission", (0.0, 0.0, 0.0))
                           for m in mats], np.float32),
        roughness=np.array([m.get("roughness", 0.5) for m in mats],
                           np.float32),
        ior=np.array([m.get("ior", 1.5) for m in mats], np.float32),
        mtype=np.array([MTYPES[m["kind"]] for m in mats], np.int32))


def _sky(spec: dict) -> dict:
    return dict(sky_mode=SKY_MODES[spec["mode"]],
                sky=np.array([spec.get("horizon", (1.0, 1.0, 1.0)),
                              spec.get("zenith", (0.5, 0.7, 1.0))],
                             np.float32))


def describe(config: dict, seed: int) -> dict:
    """The scene of ``config`` for ``seed`` as numpy arrays: centers (P,
    3), radii (P,), mat_id (P,), albedo / emission (M, 3), roughness, ior,
    mtype (M,), sky (2, 3), sky_mode, and the materials' kinds."""
    spec = config["scene"]
    if spec["kind"] == "spheres":
        mats = spec["materials"]
        names = [m["name"] for m in mats]
        rows = spec["spheres"]
        centers = np.array([r["center"] for r in rows], np.float32)
        radii = np.array([r["radius"] for r in rows], np.float32)
        mat_id = np.array([names.index(r["material"]) for r in rows],
                          np.int32)
    elif spec["kind"] == "random_spheres":
        rng = np.random.default_rng(spec["layout_seed"])
        lam = spec["lambert"]
        mats = [dict(kind="lambert",
                     albedo=tuple(rng.uniform(*lam["albedo"], 3)))
                for _ in range(lam["count"])]
        mats += spec["other_materials"]
        mats.append(spec["emitter"])
        n = spec["count"]
        lo, hi = spec["box"]
        centers = rng.uniform(lo, hi, (n, 3)).astype(np.float32)
        centers[:, 2] += spec["z_offset"]
        radii = rng.uniform(*spec["radius"], n).astype(np.float32)
        emitter, n_other = len(mats) - 1, len(mats) - 1
        mat_id = np.array([emitter if i % spec["emit_every"] == 0
                           else i % n_other for i in range(n)], np.int32)
    else:
        raise ValueError(f"unknown scene kind {spec['kind']!r}")
    out = dict(centers=centers, radii=radii, mat_id=mat_id,
               kinds=[m["kind"] for m in mats], **_material_rows(mats),
               **_sky(spec["sky"]))
    return out


def with_materials(desc: dict, albedo, roughness) -> dict:
    """``desc`` with its material albedos and roughnesses replaced."""
    return dict(desc, albedo=np.asarray(albedo, np.float32),
                roughness=np.asarray(roughness, np.float32))


def port_scene(T, desc: dict):
    """The program's ``Scene`` (package ``T``) holding ``desc``: its
    materials in order, its spheres in order (so sphere i is prim i), its
    sky."""
    scene = T.Scene()
    for i, kind in enumerate(desc["kinds"]):
        scene.add_material(
            kind, albedo=tuple(float(x) for x in desc["albedo"][i]),
            emission=tuple(float(x) for x in desc["emission"][i]),
            roughness=float(desc["roughness"][i]),
            ior=float(desc["ior"][i]))
    horizon, zenith = (tuple(float(x) for x in row) for row in desc["sky"])
    scene.set_sky(int(desc["sky_mode"]), horizon=horizon, zenith=zenith)
    for i in range(len(desc["radii"])):
        scene.create_sphere(f"s{i}",
                            tuple(float(x) for x in desc["centers"][i]),
                            float(desc["radii"][i]), int(desc["mat_id"][i]))
    return scene


def pose(config: dict, seed: int, index: int) -> dict:
    """Camera pose ``index`` of a run with ``seed``: position and target
    moved uniformly within their jitter, as Python floats (the values both
    sides turn into float32)."""
    cam = config["camera"]
    rng = np.random.default_rng(seed_words(seed, 0x9E37, index))
    out = {}
    for key in ("position", "target"):
        centre = np.asarray(cam[key], np.float64)
        jitter = np.asarray(cam[f"{key}_jitter"], np.float64)
        out[key] = tuple(float(x) for x in
                         centre + rng.uniform(-1.0, 1.0, 3) * jitter)
    out["fov_degrees"] = float(cam["fov_degrees"])
    return out


def home_pose(config: dict) -> dict:
    """The configuration's own pose, unmoved (the warm-up's)."""
    cam = config["camera"]
    return dict(position=tuple(float(x) for x in cam["position"]),
                target=tuple(float(x) for x in cam["target"]),
                fov_degrees=float(cam["fov_degrees"]))
