"""Inverse-rendering demo (BASELINE config 4) on the card: recover the
albedo and roughness of a sphere scene from a target image by gradient
descent.

The port of the JAX package's ``apps/inverse_render.py``: the same scene
from the same seed (the same numpy draws in the same order), a target
rendered through K1 (``cuda_diff.make_cuda_render_fn``), the parameters
perturbed, then recovered by ``InverseRenderer(backend="cuda")`` (K1
forward, K2 backward; their plain versions with ``--device cpu``).

Usage (from the repo root):
  python -m spt_tpu_torch.apps.inverse_render --spheres 32 --steps 200 \\
      --out recovery.png
"""

from __future__ import annotations

import argparse
import sys
import time
from typing import Optional

import numpy as np
import torch

import spt_tpu_torch as T
from spt_tpu_torch.diff import cuda_diff, gradients as G
from spt_tpu_torch.io.image import write_png
from spt_tpu_torch.utils.device import resolve_device


def build_scene(spheres: int, rng) -> T.Scene:
    """The demo scene: a floor, a lamp and ``spheres`` spheres on three
    rings, each a Lambert or GGX metal of random albedo and roughness."""
    scene = T.Scene()
    scene.set_sky(T.SKY_NONE)
    lamp = scene.add_material("lambert", albedo=(0.8,) * 3,
                              emission=(12.0,) * 3)
    floor = scene.add_material("lambert", albedo=(0.55, 0.55, 0.55))
    scene.create_sphere("floor", (0, -1000, 8), 1000.0, floor)
    scene.create_sphere("lamp", (0, 9, 8), 2.5, lamp)
    for i in range(spheres):
        kind = "metal" if rng.uniform() < 0.4 else "lambert"
        m = scene.add_material(
            kind, albedo=tuple(rng.uniform(0.15, 0.9, 3)),
            roughness=float(rng.uniform(0.1, 0.8)))
        ang = 2 * np.pi * i / spheres
        ring = 2.0 + 2.5 * (i % 3)
        pos = (float(ring * np.cos(ang)), float(0.6 + 1.3 * (i % 4)),
               float(8.0 + ring * np.sin(ang)))
        scene.create_sphere(f"s{i}", pos, 0.6, m)
    return scene


def main(argv=None, stats: Optional[dict] = None) -> int:
    """Run the demo on ``argv``; returns the exit code.  ``stats``, if
    given, receives ``losses`` (every step's), ``loss_before`` and
    ``loss_after`` (the start's and the result's image loss on the same
    samples, 0-15), ``err_start`` and ``err_end`` (each field's mean
    absolute error), ``step_s`` (host seconds a step, ending in a device
    sync) and ``inv`` (the InverseRenderer)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--spheres", type=int, default=32)
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--size", type=int, nargs=2, default=(96, 72))
    ap.add_argument("--spp", type=int, default=8)
    ap.add_argument("--target-spp", type=int, default=64)
    ap.add_argument("--lr", type=float, default=0.03)
    ap.add_argument("--fields", nargs="+", default=["albedo", "roughness"])
    ap.add_argument("--out", default=None, help="write before/after/target PNG")
    ap.add_argument("--device", default=None, choices=["cpu", "cuda"],
                    help="device to run on (default: the card)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    rng = np.random.default_rng(args.seed)
    scene = build_scene(args.spheres, rng)
    sd = scene.compile(device=device)
    cam = T.Camera.look_at((0, 3.5, -4.0), (0, 1.5, 8.0), fov_degrees=60,
                           device=device)
    w, h = args.size

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    def render(params, spp):
        fn = cuda_diff.make_cuda_render_fn(sd, cam, w, h, spp=spp,
                                           max_bounces=4)
        with torch.no_grad():
            return fn(params, 0)

    true_params = {k: v.detach().clone() for k, v in
                   G.get_params(sd, tuple(args.fields)).items()}
    print(f"rendering target ({args.target_spp} spp)...")
    target = render(true_params, args.target_spp)

    inv = G.InverseRenderer(sd, cam, target, fields=tuple(args.fields),
                            spp_per_step=args.spp, learning_rate=args.lr,
                            max_bounces=4, seed=args.seed, backend="cuda")
    # Perturb the start.
    start = {k: v.detach().clone() for k, v in inv.params.items()}
    if "albedo" in start:
        start["albedo"] = torch.clamp(start["albedo"] + torch.as_tensor(
            rng.uniform(-0.3, 0.3, tuple(start["albedo"].shape)),
            dtype=torch.float32, device=device), 0.0, 1.0)
    if "roughness" in start:
        start["roughness"] = torch.clamp(start["roughness"] + torch.as_tensor(
            rng.uniform(-0.3, 0.3, tuple(start["roughness"].shape)),
            dtype=torch.float32, device=device), 0.02, 1.0)
    with torch.no_grad():
        for k, v in start.items():
            inv.params[k].copy_(v)
    before = render(inv.params, 16)

    def mean_err(params):
        return {k: float(torch.abs(params[k].detach() - true_params[k])
                         .mean()) for k in params}

    losses, step_s = [], []
    t0 = time.perf_counter()
    for i in range(args.steps):
        ts = time.perf_counter()
        loss = inv.step()          # float(): waits for the card
        sync()
        step_s.append(time.perf_counter() - ts)
        losses.append(loss)
        if (i + 1) % max(args.steps // 10, 1) == 0:
            err = mean_err(inv.params)
            print(f"step {i+1:4d} loss={loss:.6f} "
                  + " ".join(f"{k}_err={v:.4f}" for k, v in err.items()))
    print(f"optimized {args.steps} steps in {time.perf_counter()-t0:.1f}s")

    err_start, err_end = mean_err(start), mean_err(inv.params)
    for k in inv.params:
        e0, e1 = err_start[k], err_end[k]
        print(f"  {k}: mean abs error {e0:.4f} -> {e1:.4f} "
              f"({100*(1-e1/max(e0,1e-9)):.0f}% recovered)")

    # Each step's loss is over fresh samples, and at 8 spp their noise
    # outweighs the parameters' error; the same 16 samples before and
    # after show the fall.
    after = render(inv.params, 16)
    loss_before = float(torch.mean((before - target) ** 2))
    loss_after = float(torch.mean((after - target) ** 2))
    print(f"  image loss on samples 0-15: {loss_before:.6f} -> "
          f"{loss_after:.6f}")
    if args.out:
        strip = torch.cat([before, after, target], dim=1)
        write_png(args.out, torch.clamp(strip, 0, 1) ** (1 / 2.2))
        print(f"wrote {args.out} (before | after | target)")
    if stats is not None:
        stats.update(losses=losses, loss_before=loss_before,
                     loss_after=loss_after, err_start=err_start,
                     err_end=err_end, step_s=step_s, inv=inv)
    return 0


if __name__ == "__main__":
    sys.exit(main())
