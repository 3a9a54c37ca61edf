"""Differentiable rendering: pixel gradients with respect to scene parameters.

The port of ``spt_tpu.diff.gradients``.  Because the RNG is counter-based,
a render with fixed sample ids is a deterministic, almost everywhere
differentiable function of the scene, and its gradient is the path-replay
gradient: the backward replays the same sampling chain.  Continuous
reparametrisations (GGX roughness, normals, cone light sampling) are
differentiated through; discrete events (hit selection, Russian roulette,
lobe choice) are piecewise constant and their boundary terms are ignored.

* ``get_params`` / ``apply_params`` / ``clip_params``: a dict of parameter
  tensors, swapped into the frozen ``SceneData`` with
  ``dataclasses.replace``, and projected back to their domains.
* ``make_render_fn``: ``torch.autograd`` through the plain render, over any
  sample ids (the counterpart of the JAX package's SoA backend); under an
  environment-map sky through the wavefront's plain stages, which add the
  map.
* ``InverseRenderer``: Adam on an L2 image loss, with the kernel render
  (``backend="cuda"``: ``cuda_diff.make_cuda_render_fn``, routed by scene
  size, K1/K2, K3/K4 or the wavefront, and every environment-map scene to
  the wavefront) or the plain one.
"""

from __future__ import annotations

import dataclasses

import torch

from ..core.scene import SKY_ENVMAP, SceneData
from ..kernels import megakernel, physics

PARAM_FIELDS = ("albedo", "emission", "roughness", "ior",
                "centers", "radii", "sky_params")
_MAT_FIELDS = ("albedo", "emission", "roughness", "ior")
_SCENE_FIELDS = ("centers", "radii", "sky_params")


def get_params(scene: SceneData, fields=("albedo", "roughness")) -> dict:
    """The named parameter tensors of a compiled scene."""
    out = {}
    for f in fields:
        if f in _MAT_FIELDS:
            out[f] = getattr(scene.materials, f)
        elif f in _SCENE_FIELDS:
            out[f] = getattr(scene, f)
        else:
            raise ValueError(f"unknown param field {f!r}")
    return out


def apply_params(scene: SceneData, params: dict) -> SceneData:
    """The scene with parameter tensors swapped in (differentiable)."""
    mats = scene.materials
    mat_updates = {k: v for k, v in params.items() if k in _MAT_FIELDS}
    if mat_updates:
        mats = dataclasses.replace(mats, **mat_updates)
    scene_updates = {k: v for k, v in params.items() if k in _SCENE_FIELDS}
    return dataclasses.replace(scene, materials=mats, **scene_updates)


def clip_params(params: dict) -> dict:
    """Parameters projected back to their physical domains."""
    out = dict(params)
    if "albedo" in out:
        out["albedo"] = torch.clamp(out["albedo"], 0.0, 1.0)
    if "roughness" in out:
        out["roughness"] = torch.clamp(out["roughness"], 0.02, 1.0)
    if "emission" in out:
        out["emission"] = torch.clamp_min(out["emission"], 0.0)
    if "radii" in out:
        out["radii"] = torch.clamp_min(out["radii"], 1e-3)
    if "ior" in out:
        out["ior"] = torch.clamp(out["ior"], 1.001, 3.0)
    if "sky_params" in out:
        out["sky_params"] = torch.clamp_min(out["sky_params"], 0.0)
    return out


def make_render_fn(scene: SceneData, camera, width: int, height: int, *,
                   max_bounces: int = 4, rr_depth: int = 100,
                   use_nee: bool = True, use_mis: bool = True, seed: int = 0):
    """render(params, sample_ids) -> (H, W, 3) mean radiance over the given
    1-D sample ids, differentiable through the plain render.

    ``rr_depth`` defaults beyond ``max_bounces``: Russian roulette off, as
    its accept boundaries add discontinuities for no variance benefit at
    optimization depths.

    Under an environment-map sky the render goes through the sorted
    wavefront's plain stages (``wavefront_grad``, its plain K9 and K10
    behind ``torch.autograd``), the one plain render that adds the map:
    one render a run of consecutive sample ids.  It packs its own tree, so
    the scene needs no BVH."""
    if scene.sky_mode == SKY_ENVMAP:
        return _make_envmap_render_fn(
            scene, camera, width, height, max_bounces=max_bounces,
            rr_depth=rr_depth, use_nee=use_nee, use_mis=use_mis, seed=seed)
    mtypes, light_prims = megakernel.pack_scene_static(scene)
    kw = dict(width=width, height=height, n_prims=scene.capacity,
              n_light_slots=len(light_prims), max_bounces=max_bounces,
              rr_depth=rr_depth, use_nee=bool(use_nee),
              use_mis=bool(use_mis), sky_mode=scene.sky_mode,
              dof=bool(float(megakernel._np(camera.aperture)) > 0.0))
    meta = torch.from_numpy(megakernel.pack_meta(0, seed, mtypes,
                                                 light_prims))

    def render(params: dict, sample_ids) -> torch.Tensor:
        sc = apply_params(scene, params)
        lsb = physics.lsel_bounds(sc.centers.detach(), sc.radii.detach(),
                                  sc.prim_valid)
        ids = [int(i) for i in torch.as_tensor(sample_ids).reshape(-1)]
        img = megakernel.render_samples_plain(
            megakernel.pack_blob_torch(sc, camera), meta.to(scene.device),
            lsb, ids, **kw)
        return img / len(ids)
    return render


def _make_envmap_render_fn(scene: SceneData, camera, width: int,
                           height: int, **kw):
    """``make_render_fn`` under an environment-map sky: the wavefront's
    plain stages over each run of consecutive sample ids, weighted by its
    length."""
    from ..kernels import wavefront_grad as wg
    fns = {}

    def render(params: dict, sample_ids) -> torch.Tensor:
        ids = [int(i) for i in torch.as_tensor(sample_ids).reshape(-1)]
        runs, total = [], None
        for i in ids:
            if runs and i == runs[-1][0] + runs[-1][1]:
                runs[-1][1] += 1
            else:
                runs.append([i, 1])
        for start, n in runs:
            if n not in fns:
                fns[n] = wg._make_render_fn(
                    scene, camera, width, height, stages=wg.PLAIN, spp=n,
                    sort_min_rays=1 << 17, chunk_rays=2 << 20, **kw)
            part = fns[n](params, start) * n
            total = part if total is None else total + part
        return total / len(ids)
    return render


def make_loss_fn(render_fn, target):
    """L2 image loss against a target (H, W, 3) image."""
    target = torch.as_tensor(target)

    def loss(params, sample_ids):
        return torch.mean((render_fn(params, sample_ids) - target) ** 2)
    return loss


@dataclasses.dataclass
class InverseRenderer:
    """Gradient-descent recovery of scene parameters from a target image.

    Renders the current estimate, compares it with the target, and takes an
    Adam step (``torch.optim.Adam``: eps 1e-8 after the square root,
    bias-corrected, as ``optax.adam``), then clips the parameters to their
    domains.  Sample ids rotate per step unless ``rotate_samples`` is False
    (then ids 0 .. spp-1 every step: a deterministic loss, right when the
    target was rendered with the same ids).

    ``backend``: "cuda" renders and differentiates with the kernels on the
    scene's device (their plain versions on the CPU), routed by
    ``make_cuda_render_fn``: by scene size, K1/K2 up to 128 spheres, K3/K4
    up to 2048, the differentiable wavefront above, and every
    environment-map scene to the wavefront; it keeps that function's
    ``rr_depth=3``.  "plain" is autograd through the plain render
    (``make_render_fn``, Russian roulette off; the wavefront's plain stages
    under an environment map).
    """

    scene: SceneData
    camera: object
    target: torch.Tensor              # (H, W, 3)
    fields: tuple = ("albedo", "roughness")
    spp_per_step: int = 8
    learning_rate: float = 0.02
    max_bounces: int = 4
    use_nee: bool = True
    seed: int = 0
    rotate_samples: bool = True
    backend: str = "cuda"

    def __post_init__(self):
        h, w = self.target.shape[:2]
        if self.backend == "cuda":
            from .cuda_diff import make_cuda_render_fn
            pr = make_cuda_render_fn(
                self.scene, self.camera, w, h, spp=self.spp_per_step,
                max_bounces=self.max_bounces, use_nee=self.use_nee,
                seed=self.seed)
            self.render_fn = lambda p, ids: pr(p, int(ids[0]))
        elif self.backend == "plain":
            self.render_fn = make_render_fn(
                self.scene, self.camera, w, h, max_bounces=self.max_bounces,
                use_nee=self.use_nee, seed=self.seed)
        else:
            raise ValueError(f"unknown backend {self.backend!r}: "
                             "'cuda' or 'plain'")
        self.loss_fn = make_loss_fn(self.render_fn, self.target)
        self.params = {k: v.detach().clone().requires_grad_(True)
                       for k, v in get_params(self.scene,
                                              self.fields).items()}
        self.opt = torch.optim.Adam(list(self.params.values()),
                                    lr=self.learning_rate, eps=1e-8)
        self.step_count = 0

    def step(self) -> float:
        base = self.step_count * self.spp_per_step if self.rotate_samples \
            else 0
        ids = torch.arange(base, base + self.spp_per_step)
        self.opt.zero_grad(set_to_none=True)
        loss = self.loss_fn(self.params, ids)
        loss.backward()
        self.opt.step()
        with torch.no_grad():
            for k, v in clip_params(self.params).items():
                self.params[k].copy_(v)
        self.step_count += 1
        return float(loss.detach())

    def run(self, n_steps: int, log_every: int = 0) -> list:
        from ..utils.log import Log
        losses = []
        for i in range(n_steps):
            losses.append(self.step())
            if log_every and (i + 1) % log_every == 0:
                Log.info(f"inverse render step {i + 1}/{n_steps} "
                         f"loss={losses[-1]:.6f}")
        return losses
