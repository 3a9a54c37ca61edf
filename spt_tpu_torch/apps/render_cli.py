"""CLI renderer: scene.json -> image, on the card.

The port of the JAX package's ``apps/render_cli.py``: progressive chunked
rendering through ``create_path_tracer("cuda")`` with status lines,
periodic preview writes, checkpoint/resume, and a torch.profiler trace.

Usage (from the repo root):
  python -m spt_tpu_torch.apps.render_cli scenes/cornell.json -o out.png
  python -m spt_tpu_torch.apps.render_cli scenes/cornell.json -o out.png \\
      --spp 64 --checkpoint state.npz
  python -m spt_tpu_torch.apps.render_cli scenes/cornell.json -o out.png \\
      --resume state.npz
  python -m spt_tpu_torch.apps.render_cli scenes/cornell.json -o out.png \\
      --device cpu --size 64 64 --spp 4

The flags are the JAX CLI's but for ``--backend`` (``cuda`` only) and
``--device`` (``cpu`` or ``cuda``; default the card).
"""

from __future__ import annotations

import argparse
import contextlib
import sys
import time
from typing import Optional

import torch

import spt_tpu_torch
from spt_tpu_torch.io import checkpoint as ckpt
from spt_tpu_torch.io.image import write_image
from spt_tpu_torch.io.scene_json import load_scene
from spt_tpu_torch.utils.device import resolve_device
from spt_tpu_torch.utils.profiling import (capture_trace, measure_occupancy,
                                           trace_scope)


def main(argv=None, stats: Optional[dict] = None) -> int:
    """Run the CLI on ``argv`` (default ``sys.argv[1:]``); returns the exit
    code.  ``stats``, if given, receives the run's numbers: ``chunk_s``
    (host seconds a chunk, ending in a device sync), ``total_s``, the
    tracer (``tracer``) and, with ``--profile``, ``occupancy``."""
    ap = argparse.ArgumentParser(description="spt_tpu_torch CLI renderer")
    ap.add_argument("scene", help="scene JSON file")
    ap.add_argument("-o", "--output", required=True,
                    help="output image (.png/.ppm/.npy/.hdr/.exr)")
    ap.add_argument("--backend", default="cuda", choices=["cuda"])
    ap.add_argument("--spp", type=int, default=None,
                    help="override samples per pixel")
    ap.add_argument("--size", type=int, nargs=2, default=None,
                    metavar=("W", "H"), help="override resolution")
    ap.add_argument("--max-bounces", type=int, default=None)
    ap.add_argument("--chunk", type=int, default=16,
                    help="samples per progressive chunk")
    ap.add_argument("--preview-every", type=int, default=0,
                    help="write preview image every N chunks (0=off)")
    ap.add_argument("--checkpoint", default=None,
                    help="write progressive state here after each chunk")
    ap.add_argument("--resume", default=None,
                    help="resume from a saved state file")
    ap.add_argument("--device", default=None, choices=["cpu", "cuda"],
                    help="device to render on (default: the card)")
    ap.add_argument("--seed", type=int, default=None)
    ap.add_argument("--profile", default=None, metavar="DIR",
                    help="write a torch.profiler trace of the render into "
                         "DIR and print the active-lane occupancy per "
                         "bounce")
    ap.add_argument("-q", "--quiet", action="store_true")
    args = ap.parse_args(argv)

    if not args.quiet:
        spt_tpu_torch.install_console_sink()

    device = resolve_device(args.device)
    try:
        scene, camera, settings = load_scene(args.scene, device=device)
    except (OSError, ValueError) as e:
        print(f"render_cli: cannot load {args.scene}: {e}", file=sys.stderr)
        return 1
    if args.size:
        settings.set_resolution(*args.size)
    if args.spp is not None:
        settings.samples_per_pixel = args.spp
    if args.max_bounces is not None:
        settings.max_bounces = args.max_bounces
    if args.seed is not None:
        settings.seed = args.seed

    tracer = spt_tpu_torch.create_path_tracer(args.backend, device=device)
    tracer.set_scene(scene)
    tracer.set_settings(settings)
    if camera is not None:
        tracer.set_camera(camera)

    if args.resume:
        ckpt.load_render_state(args.resume, tracer)
        print(f"resumed at {tracer.frame_count} spp from {args.resume}")

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    target = settings.samples_per_pixel
    chunk_s = []
    t_start = time.perf_counter()
    chunk_i = 0
    profiler = capture_trace(args.profile) if args.profile \
        else contextlib.nullcontext()
    with profiler:
        while tracer.frame_count < target:
            n = min(args.chunk, target - tracer.frame_count)
            t0 = time.perf_counter()
            with trace_scope(f"render_chunk_{chunk_i}"):
                tracer.render(spp=n)
                sync()
            dt = time.perf_counter() - t0
            chunk_s.append(dt)
            chunk_i += 1
            done = tracer.frame_count
            paths = settings.width * settings.height * n
            if not args.quiet:
                print(f"  [{done:5d}/{target} spp] chunk {dt:8.4f}s "
                      f"({paths / dt / 1e6:7.1f}M paths/s)")
            if args.checkpoint:
                ckpt.save_render_state(args.checkpoint, tracer)
            if args.preview_every and chunk_i % args.preview_every == 0:
                write_image(args.output, tracer.get_render_result().image_f32)
    occ = None
    if args.profile:
        # Per-bounce lane occupancy: the wavefront-compaction diagnostic.
        occ = measure_occupancy(
            tracer.scene_data, tracer._camera or tracer._default_camera(),
            min(settings.width, 128), min(settings.height, 128),
            spp=4, max_bounces=settings.max_bounces,
            rr_depth=settings.russian_roulette_depth,
            use_nee=settings.use_nee, use_mis=settings.use_mis,
            seed=settings.seed)
        if not args.quiet:
            print(f"profiler trace written to {args.profile}")
            print("active-lane occupancy per bounce: "
                  + " ".join(f"{x:.3f}" for x in occ))

    write_image(args.output, tracer.get_render_result().image_f32)
    total = time.perf_counter() - t_start
    print(f"wrote {args.output} ({settings.width}x{settings.height}, "
          f"{tracer.frame_count} spp, {total:.3f}s, backend={args.backend}, "
          f"device={device})")
    if stats is not None:
        stats.update(chunk_s=chunk_s, total_s=total, tracer=tracer,
                     occupancy=occ)
    return 0


if __name__ == "__main__":
    sys.exit(main())
