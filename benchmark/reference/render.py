"""The benchmark's plain reference renderer: any pixels of an image at any
sample ids, and the L2 loss and its gradient with respect to the
materials by ``torch.autograd``.

It reads only the benchmark's own scene description (``scenes.py``):
spheres, materials, sky and camera pose, never a table that the program
packed.  The camera ray is a frozen copy of ``camera_rays`` and the camera
basis of ``Camera.look_at`` (``spt_tpu_torch/kernels/megakernel.py``,
``spt_tpu_torch/core/camera.py``), the sphere rows of ``pack_blob_torch``
and the light list of ``Scene.compile_arrays``, all at commit
1ae0631e9a6a2afc017f1275ca928f65cb92b419.  Every path is keyed on
(pixel id, sample id, bounce * 8 + dim, seed), so a subset of pixels is
recomputed exactly as the whole image renders it.

``lowp`` is the control: the scene's tables and every path's state rounded
to bfloat16 at the start of each bounce, the precision below the float32
that the configurations state.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import physics, rng

_CAM_SLOT = 0xFFFF * physics.N_DIMS


def _f32(x: float) -> float:
    return float(np.float32(x))


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).to(torch.float32)


@dataclasses.dataclass
class Tables:
    """The scene as the bounce reads it."""
    spheres: torch.Tensor    # (P, 12)
    sky: torch.Tensor        # (6,)
    lights: torch.Tensor     # (L, 7)
    mtypes: torch.Tensor     # (P,) int64
    lsel: torch.Tensor       # (6,)
    sky_mode: int

    @property
    def nl(self) -> int:
        return self.lights.shape[0]


def scene_tables(desc: dict, device, params: dict | None = None,
                 lowp: bool = False) -> Tables:
    """``desc`` (numpy arrays: centers, radii, mat_id, albedo, emission,
    roughness, ior, mtype, sky, sky_mode) -> Tables on ``device``.
    ``params`` may replace ``albedo`` and ``roughness`` with tensors
    (differentiable)."""
    f32 = dict(dtype=torch.float32, device=device)
    mats = {k: torch.as_tensor(np.asarray(desc[k], np.float32), **f32)
            for k in ("albedo", "emission", "roughness", "ior")}
    if params:
        mats.update(params)
    centers = torch.as_tensor(np.asarray(desc["centers"], np.float32), **f32)
    radii = torch.as_tensor(np.asarray(desc["radii"], np.float32), **f32)
    mid = torch.as_tensor(np.asarray(desc["mat_id"], np.int64),
                          device=device)
    spheres = torch.cat([centers, radii[:, None], mats["albedo"][mid],
                         mats["emission"][mid],
                         mats["roughness"][mid][:, None],
                         mats["ior"][mid][:, None]], dim=1)
    emission = np.asarray(desc["emission"], np.float32)[
        np.asarray(desc["mat_id"])]
    light_prims = np.nonzero(emission.sum(-1) > 0.0)[0]
    lights = spheres[torch.as_tensor(light_prims, device=device)][
        :, [0, 1, 2, 3, 7, 8, 9]]
    sky = torch.as_tensor(np.asarray(desc["sky"], np.float32).reshape(-1),
                          **f32)
    mtypes = torch.as_tensor(np.asarray(desc["mtype"], np.int64)[
        np.asarray(desc["mat_id"])], device=device)
    lsel = physics.lsel_bounds(centers, radii)
    if lowp:
        spheres, sky, lights = _bf16(spheres), _bf16(sky), _bf16(lights)
    return Tables(spheres=spheres, sky=sky, lights=lights, mtypes=mtypes,
                  lsel=lsel, sky_mode=int(desc["sky_mode"]))


def camera_blob(pose: dict, device) -> torch.Tensor:
    """(15,) position, right, up, forward, tan(fov / 2), aperture, focus
    distance, from a pose {position, target, fov_degrees}: the port's
    ``Camera.look_at`` arithmetic (world up +y, a pinhole)."""
    f32 = dict(dtype=torch.float32, device=device)
    position = torch.as_tensor(pose["position"], **f32)
    target = torch.as_tensor(pose["target"], **f32)
    world_up = torch.as_tensor((0.0, 1.0, 0.0), **f32)
    fwd = target - position
    dist = torch.linalg.vector_norm(fwd)
    fwd = fwd / torch.clamp_min(dist, 1e-12)
    right = torch.linalg.cross(world_up, fwd)
    right = right / torch.clamp_min(torch.linalg.vector_norm(right), 1e-12)
    cam_up = torch.linalg.cross(fwd, right)
    fov = torch.as_tensor(pose["fov_degrees"], **f32)
    tanf = torch.tan(torch.deg2rad(fov) * 0.5)
    return torch.cat([position, right, cam_up, fwd, tanf.reshape(1),
                      torch.zeros(1, **f32), dist.reshape(1)])


def camera_rays(blob, pid, sample, *, width: int, height: int, seed: int):
    """The jittered pinhole ray of each lane (pixel id ``pid``, sample id
    ``sample``)."""
    aspect, inv_w, inv_h = (_f32(width / height), _f32(1.0 / width),
                            _f32(1.0 / height))
    px = (pid % width).to(torch.float32)
    py = (pid // width).to(torch.float32)

    def u(dim):
        return rng.counter_uniform(pid, sample, dim, seed)

    tanf = blob[12]
    jx, jy = u(_CAM_SLOT + 0), u(_CAM_SLOT + 1)
    sx = (px + jx) * inv_w
    sy = (py + jy) * inv_h
    ndc_x = (2.0 * sx - 1.0) * aspect * tanf
    ndc_y = (1.0 - 2.0 * sy) * tanf
    dx = ndc_x * blob[3] + ndc_y * blob[6] + blob[9]
    dy = ndc_x * blob[4] + ndc_y * blob[7] + blob[10]
    dz = ndc_x * blob[5] + ndc_y * blob[8] + blob[11]
    dx, dy, dz = physics.normalize(dx, dy, dz)
    ox, oy, oz = (blob[a].expand(dx.shape) for a in range(3))
    return ox, oy, oz, dx, dy, dz


@dataclasses.dataclass(frozen=True)
class Settings:
    width: int
    height: int
    max_bounces: int
    rr_depth: int
    use_nee: bool
    use_mis: bool
    seed: int


def trace_lanes(tab: Tables, blob, pid, sample, st: Settings,
                lowp: bool = False, counts: list | None = None):
    """Radiance (N, 3) of the paths of lanes (pixel id, sample id).
    ``counts``, where given, gets per bounce [rays, hits, shadow rays,
    lit] added (Python ints)."""
    seed = int(st.seed) & rng.MASK32
    rays = camera_rays(blob, pid, sample, width=st.width, height=st.height,
                       seed=seed)
    ones = torch.ones_like(rays[3])
    zero = torch.zeros_like(rays[3])
    state = (*rays, ones, ones, ones, zero, zero, zero, zero)
    n = pid.numel()
    aux = (torch.ones(n, dtype=torch.bool, device=pid.device),
           torch.ones(n, dtype=torch.bool, device=pid.device))
    theta = (tab.spheres, tab.sky, tab.lights)
    lo = tuple(tab.lsel[a] for a in range(3))
    ext = tuple(tab.lsel[3 + a] for a in range(3))
    for k in range(st.max_bounces):
        if not bool(aux[0].any()):
            break
        if lowp:
            state = tuple(_bf16(x) for x in state)

        def u(dim):
            return rng.counter_uniform(pid, sample,
                                       k * physics.N_DIMS + dim, seed)
        uni = dict(rr=u(physics.DIM_RR), u1=u(physics.DIM_U1),
                   u2=u(physics.DIM_U2), lobe=u(physics.DIM_LOBE),
                   lu1=u(physics.DIM_LU1), lu2=u(physics.DIM_LU2),
                   lsel_lo=lo, lsel_ext=ext, sample=sample, seed=seed)
        state, aux, c = physics.trace_bounce(
            theta, tab.mtypes, state, aux, uni, tab.nl, k,
            rr_depth=st.rr_depth, use_nee=st.use_nee, use_mis=st.use_mis,
            sky_mode=tab.sky_mode, n_light_slots=tab.nl)
        if counts is not None:
            while len(counts) <= k:
                counts.append([0, 0, 0, 0])
            for a, v in enumerate(c):
                counts[k][a] += int(v)
    return torch.stack(state[9:12], dim=1)


def _lanes(pids: torch.Tensor, samples: torch.Tensor):
    """Every (pixel, sample) pair, sample-major."""
    n_s = samples.numel()
    pid = pids.repeat(n_s)
    sample = samples.repeat_interleave(pids.numel())
    return pid, sample


def render_pixels(tab: Tables, blob, pids: torch.Tensor, samples, st: Settings,
                  *, lowp: bool = False, lane_chunk: int = 1 << 22,
                  counts: list | None = None) -> torch.Tensor:
    """(len(pids), 3) radiance sums of pixels ``pids`` over sample ids
    ``samples``, without gradients."""
    dev = pids.device
    samples = torch.as_tensor(samples, dtype=torch.int64, device=dev) \
        & rng.MASK32
    out = torch.zeros(pids.numel(), 3, dtype=torch.float32, device=dev)
    per = max(1, lane_chunk // max(pids.numel(), 1))
    with torch.no_grad():
        for a in range(0, samples.numel(), per):
            s = samples[a:a + per]
            pid, sample = _lanes(pids, s)
            rad = trace_lanes(tab, blob, pid, sample, st, lowp=lowp,
                              counts=counts)
            out += rad.reshape(s.numel(), pids.numel(), 3).sum(0)
    return out


def render_image(tab: Tables, blob, samples, st: Settings, **kw):
    """(H, W, 3) mean radiance of the whole image over ``samples``."""
    dev = tab.spheres.device
    pids = torch.arange(st.width * st.height, dtype=torch.int64, device=dev)
    n = len(samples) if not isinstance(samples, torch.Tensor) \
        else samples.numel()
    return (render_pixels(tab, blob, pids, samples, st, **kw) / n).reshape(
        st.height, st.width, 3)


def loss_and_grad(desc: dict, params: dict, pose: dict, target, samples,
                  st: Settings, *, lowp: bool = False,
                  lane_chunk: int = 1 << 21, counts: list | None = None):
    """L2 loss mean((image - target)**2) of the image of ``samples`` ids
    rendered with material ``params`` ({name: (M, ...) tensor}), and its
    gradient {name: tensor}, by autograd in blocks of lanes: a pass without
    gradients for the image, then per block the backward of the image's
    share weighted by d(loss)/d(image)."""
    dev = target.device
    blob = camera_blob(pose, dev)
    pids = torch.arange(st.width * st.height, dtype=torch.int64, device=dev)
    samples = torch.as_tensor(samples, dtype=torch.int64, device=dev) \
        & rng.MASK32
    n_s = samples.numel()
    detached = {k: v.detach() for k, v in params.items()}
    img = render_image(scene_tables(desc, dev, detached, lowp=lowp), blob,
                       samples, st, lowp=lowp, lane_chunk=lane_chunk,
                       counts=counts)
    diff = img - target
    loss = torch.mean(diff * diff)
    weight = (2.0 * diff / diff.numel()).reshape(-1, 3)
    leaves = {k: v.detach().clone().requires_grad_(True)
              for k, v in params.items()}
    grads = {k: torch.zeros_like(v) for k, v in leaves.items()}
    per = max(1, lane_chunk // pids.numel())
    for a in range(0, n_s, per):
        s = samples[a:a + per]
        tab = scene_tables(desc, dev, leaves, lowp=lowp)
        pid, sample = _lanes(pids, s)
        rad = trace_lanes(tab, blob, pid, sample, st, lowp=lowp)
        part = rad.reshape(s.numel(), pids.numel(), 3).sum(0) / n_s
        got = torch.autograd.grad((part * weight).sum(),
                                  list(leaves.values()), allow_unused=True)
        for (k, _), g in zip(leaves.items(), got):
            if g is not None:
                grads[k] += g
    return loss, grads
