#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds every CUDA kernel of the port from spt_tpu_torch/csrc with nvcc,
holds each against its plain PyTorch version on the card, drives the three
main paths (the progressive render facade, ``create_path_tracer("cuda")``,
through K1 at the repo's headline size; inverse rendering,
``InverseRenderer(backend="cuda")``, through K1 forward and K2 backward;
and the facade on the repo's large scene, 10,000 spheres at 1920x1080,
through K3), and times the kernels.  Each phase prints one JSON line; any
failure exits nonzero and prints no result.  The last two lines are the
kernels table and ``{"ok": true, "device": {...}}``.

Exits nonzero without a CUDA device, and when the package is not beside it.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
import traceback
from concurrent.futures import ThreadPoolExecutor

import numpy as np

# The headline configuration: Cornell box, 512x512, depth 8, RR 3, NEE+MIS,
# seed 3, 256-spp launches.
W = H = 512
DEPTH, RR, SEED, SPP = 8, 3, 3, 256
FP32_PEAK = 67e12        # H100 SXM fp32 FLOP/s outside the tensor cores
HBM_RATE = 3.35e12       # H100 SXM HBM3 bytes/s
# K1 against its plain version on the card: pixels isclose(rtol=2e-3,
# atol=2e-4), as the JAX suite holds two implementations (tests/
# test_pallas.py), but on 99.9% of pixels (not 97%) with means within 0.1%
# (not 1%).  Both round alike (same libdevice, --fmad=false) and have
# agreed bit for bit on an H100; the slack is for a kernel that reorders.
RTOL, ATOL, MIN_CLOSE, MAX_MEAN_REL = 2e-3, 2e-4, 0.999, 1e-3
# K2's gradient against its plain version: every field (12 sphere attributes
# over all spheres, and the sky) within 1e-3 relative L2, or 1e-6 absolute
# where the plain field is 0.  K2 sums lanes with float atomics in an order
# that changes from run to run, and its adjoint associates some products
# otherwise than the plain version; both are float32 rounding.
GRAD_REL, GRAD_ABS = 1e-3, 1e-6
# One bounce's adjoint, K2's per-lane code against the plain version: state
# cotangents allclose(rtol 1e-3, atol 1e-4 times the channel's largest
# magnitude) on at least 99.9% of lanes.
VJP_RTOL, VJP_ATOL_REL, VJP_MIN_CLOSE = 1e-3, 1e-4, 0.999
TRAIN_SPP, TRAIN_STEPS, TRAIN_LR, K2_SPP = 16, 10, 0.02, 1024
# The large scene (BASELINE config 5, bench_suite.py's scene_10k): 10,000
# spheres, 1920x1080, 4 spp, depth 8, RR 3, NEE+MIS, seed 5.
BIG_W, BIG_H, BIG_SPP, BIG_SEED = 1920, 1080, 4, 5
CAM_10K = dict(position=(0, 0, -10), target=(0, 0, 60), fov_degrees=65)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


class PhaseFailed(Exception):
    pass


def check(cond, msg) -> None:
    if not cond:
        raise PhaseFailed(msg)


def cornell(pkg):
    """bench.py's Cornell box through the port's own Scene API."""
    scene = pkg.Scene()
    scene.set_sky(pkg.SKY_NONE)
    white = scene.add_material("lambert", albedo=(0.73, 0.73, 0.73))
    red = scene.add_material("lambert", albedo=(0.65, 0.05, 0.05))
    green = scene.add_material("lambert", albedo=(0.12, 0.45, 0.15))
    light = scene.add_material("lambert", albedo=(0.78,) * 3,
                               emission=(15.0,) * 3)
    metal = scene.add_material("metal", albedo=(0.8, 0.85, 0.9), roughness=0.2)
    glass = scene.add_material("glass", albedo=(0.97,) * 3, ior=1.5)
    R = 1000.0
    for nm, pos, r, m in [
            ("floor", (0, -R, 3), R, white), ("ceil", (0, R + 2, 3), R, white),
            ("left", (-R - 2, 1, 3), R, red), ("right", (R + 2, 1, 3), R, green),
            ("back", (0, 1, R + 5), R, white), ("lamp", (0, 2.55, 3), 0.6, light),
            ("ball", (-0.7, 0.5, 3.4), 0.5, metal),
            ("gball", (0.7, 0.45, 2.8), 0.45, glass)]:
        scene.create_sphere(nm, pos, r, m)
    return scene


def grad_scene(pkg):
    """tests/test_pallas_grad.py's scene under a gradient sky: Lambert,
    GGX metal, a lamp, and glass of albedo exactly 0.95 (a unit throughput
    refracting there puts Russian roulette's clip on its bound)."""
    scene = pkg.Scene()
    scene.set_sky(pkg.SKY_GRADIENT, horizon=(0.9, 0.9, 1.0),
                  zenith=(0.3, 0.5, 1.0))
    white = scene.add_material("lambert", albedo=(0.7, 0.65, 0.6))
    lamp = scene.add_material("lambert", albedo=(0.8,) * 3,
                              emission=(11.0,) * 3)
    metal = scene.add_material("metal", albedo=(0.85, 0.85, 0.9),
                               roughness=0.3)
    glass = scene.add_material("glass", albedo=(0.95,) * 3, ior=1.5)
    scene.create_sphere("floor", (0, -1000, 4), 1000.0, white)
    scene.create_sphere("lamp", (0, 2.8, 4), 0.7, lamp)
    scene.create_sphere("m", (-0.6, 0.6, 4.0), 0.6, metal)
    scene.create_sphere("g", (0.7, 0.5, 3.6), 0.5, glass)
    return scene


def scene_10k(pkg, n=10_000, seed=42):
    """bench_suite.py's scene_10k (BASELINE config 5) through the port's
    Scene API, from the same numpy seed: n spheres in an 80-unit cube
    centred 60 ahead, 8 Lambert materials, a metal, a glass, an emitter on
    every 500th sphere, sky gradient."""
    rng = np.random.default_rng(seed)
    scene = pkg.Scene()
    scene.set_sky(pkg.SKY_GRADIENT)
    mats = [scene.add_material("lambert",
                               albedo=tuple(rng.uniform(0.2, 0.9, 3)))
            for _ in range(8)]
    mats += [scene.add_material("metal", albedo=(0.85, 0.85, 0.9),
                                roughness=0.25),
             scene.add_material("glass", albedo=(0.97,) * 3, ior=1.5)]
    emit_m = scene.add_material("lambert", albedo=(0.8,) * 3,
                                emission=(40.0, 36.0, 30.0))
    pos = rng.uniform(-40, 40, (n, 3)).astype(np.float32)
    pos[:, 2] += 60.0
    rad = rng.uniform(0.2, 0.9, n).astype(np.float32)
    for i in range(n):
        m = emit_m if i % 500 == 0 else mats[i % len(mats)]
        scene.create_sphere(f"s{i}", tuple(pos[i]), float(rad[i]), m)
    return scene


def scene_200(pkg, n=200, seed=9):
    """tests/test_pallas_bvh.py's large-scene test: n random spheres, a
    ground sphere and two lamps."""
    rng = np.random.default_rng(seed)
    scene = pkg.Scene()
    scene.set_sky(pkg.SKY_GRADIENT)
    mats = [scene.add_material("lambert",
                               albedo=tuple(rng.uniform(0.2, 0.9, 3)))
            for _ in range(5)]
    mats.append(scene.add_material("metal", albedo=(0.85, 0.85, 0.9),
                                   roughness=0.3))
    mats.append(scene.add_material("glass", albedo=(0.97,) * 3, ior=1.5))
    emit_m = scene.add_material("lambert", albedo=(0.8,) * 3,
                                emission=(22.0, 18.0, 14.0))
    scene.create_sphere("ground", (0, -101.0, 12), 100.0, mats[0])
    pos = rng.uniform(-8, 8, (n, 3)).astype(np.float32)
    pos[:, 1] = rng.uniform(-0.8, 5.0, n)
    pos[:, 2] += 14.0
    rad = rng.uniform(0.25, 0.8, n).astype(np.float32)
    for i in range(n):
        scene.create_sphere(f"s{i}", tuple(pos[i]), float(rad[i]),
                            mats[i % len(mats)])
    scene.create_sphere("lampA", (-4, 7, 12), 1.2, emit_m)
    scene.create_sphere("lampB", (5, 6, 18), 1.0, emit_m)
    return scene


def vjp_lanes(torch, dev, n, seed):
    """Random bounce-entry lanes around grad_scene's spheres: (state (13, n),
    aux (2, n), pid, sample, state_ct (13, n)).  A quarter carry a unit
    throughput, so glass refractions land on the roulette clip's bound."""
    r = np.random.default_rng(seed)
    o = np.stack([r.uniform(-1.5, 1.5, n), r.uniform(0.2, 2.0, n),
                  r.uniform(2.0, 5.0, n)])
    d = r.normal(size=(3, n))
    d /= np.linalg.norm(d, axis=0)
    th = np.where(r.random(n) < 0.25, 1.0, r.uniform(0.2, 1.0, (3, n)))
    state = np.concatenate([o, d, th, r.uniform(0, 1, (3, n)),
                            np.where(r.random(n) < 0.2, 0.0,
                                     r.uniform(0, 2, n))[None]])
    aux = np.stack([r.random(n) < 0.9, r.random(n) < 0.3])
    ids = r.integers(0, 2**32, (2, n), dtype=np.uint64).astype(np.int64)
    ct = r.normal(size=(13, n))
    t = [torch.from_numpy(a).to(dev) for a in (state.astype(np.float32), aux,
                                               ids[0], ids[1],
                                               ct.astype(np.float32))]
    return t[0].contiguous(), t[1], t[2], t[3], t[4].contiguous()


def grad_errors(got, want, n_prims):
    """Per field of gvec (12 sphere attributes over the spheres, then the
    sky): relative L2 error, or absolute where the plain field is 0."""
    got, want = got.double().cpu().numpy(), want.double().cpu().numpy()
    fields = [(got[a:12 * n_prims:12], want[a:12 * n_prims:12])
              for a in range(12)] + [(got[12 * n_prims:], want[12 * n_prims:])]
    out = []
    for g, w in fields:
        norm, err = np.linalg.norm(w), np.linalg.norm(g - w)
        out.append(dict(rel=err / norm if norm > 0 else None, abs=err,
                        ok=bool(np.isfinite(g).all()) and (
                            err <= GRAD_REL * norm if norm > 0
                            else err <= GRAD_ABS)))
    return out, float(np.abs(got - want).max())


def cuda_ms(torch, fn):
    """(result, milliseconds) of fn() between two CUDA events."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


def profiled(torch, fn, kernel):
    """fn() under torch.profiler: its wall, the device time (the sum of the
    self times of the events that ran on the card: kernels and copies; a
    host-side op or autograd node that launched them would count them
    twice), their ratio (the device busy share of that one run), the named
    kernel's part, and the top five."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def dev_us(e):
        if e.device_type != DeviceType.CUDA:
            return 0
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0)) or 0

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    avg = prof.key_averages()
    busy_ms = 1e-3 * sum(dev_us(e) for e in avg)
    kernel_ms = 1e-3 * sum(dev_us(e) for e in avg if kernel in e.key)
    return dict(profiled_wall_ms=wall_ms, device_busy_ms=busy_ms or None,
                device_busy_share=busy_ms / wall_ms if busy_ms else None,
                kernel=kernel, kernel_device_ms=kernel_ms or None,
                top=[(e.key[:60], dev_us(e) * 1e-3, e.count) for e in
                     sorted(avg, key=dev_us, reverse=True)[:5]])


def compare(got, want):
    got, want = got.cpu().numpy(), want.cpu().numpy()
    close = np.isclose(got, want, rtol=RTOL, atol=ATOL).all(axis=-1)
    mean_rel = abs(float(got.mean()) - float(want.mean())) / max(
        abs(float(want.mean())), 1e-12)
    return dict(max_abs_err=float(np.abs(got - want).max()),
                frac_close=float(close.mean()), mean_rel=mean_rel,
                finite=bool(np.isfinite(got).all()))


def run() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    import spt_tpu_torch as T
    from spt_tpu_torch.core import rng
    from spt_tpu_torch.kernels import _build, megakernel as mk

    t_all = time.perf_counter()
    dev = torch.device("cuda")
    name = torch.cuda.get_device_name(0)

    # 1. Device ---------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()
    card = smi[0] if smi else "unknown"
    print(card, flush=True)
    emit(dict(phase="device", name=name, count=torch.cuda.device_count(),
              nvidia_smi=card, torch=torch.__version__,
              cuda=torch.version.cuda))

    # 2. Build: one nvcc per source, all started together ----------------
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(_build.ENTRIES)) as pool:
        list(pool.map(_build.build, _build.ENTRIES))
    for lib in _build.ENTRIES:
        _build.load_library(lib)
    from spt_tpu_torch.core import bvh
    emit(dict(phase="build", seconds=time.perf_counter() - t0,
              libraries={k: dict(seconds=v["seconds"], cached=v["cached"],
                                 ptxas=v["ptxas"])
                         for k, v in _build.BUILD_INFO.items()},
              bvh_builder="native" if bvh._load_native() else "numpy"))

    # 3. RNG bits: kernel hash == plain hash, exactly ---------------------
    r = np.random.default_rng(SEED)
    n = 1 << 20
    cols = [r.integers(0, 2**32, n, dtype=np.uint64).astype(np.int64)
            for _ in range(4)]
    for c in cols:
        c[:4] = [0, 2**32 - 1, 0, 2**32 - 1]
    cols[0][:2], cols[1][2:4] = [0, 0], [2**32 - 1, 0]
    args = [torch.from_numpy(c).to(dev) for c in cols]
    got = mk.counter_bits_cuda(*args)
    want = rng.counter_bits(*args)
    torch.cuda.synchronize()
    mismatches = int((got != want).sum())
    check(mismatches == 0, f"RNG bits differ in {mismatches} of {n}")
    emit(dict(phase="rng", tuples=n, mismatches=mismatches))

    # 4. K1 against its plain version, both on the card -------------------
    cam_cornell = dict(position=(0, 1.0, -1.5), target=(0, 1.0, 3.0),
                       fov_degrees=55)
    cam_demo = dict(position=(0, 0, 0), target=(0, 0, 1), fov_degrees=90)
    cases = [
        ("cornell", cornell(T), {}, cam_cornell, 64, 8),
        ("demo38", T.demo_scene_38_spheres(), dict(capacity=64), cam_demo,
         64, 8),
        ("cornell", cornell(T), {}, cam_cornell, W, 4),
        ("demo38", T.demo_scene_38_spheres(), dict(capacity=64), cam_demo,
         W, 4),
        ("cornell_thin_lens", cornell(T), {},
         dict(cam_cornell, aperture=0.15, focus_dist=4.5), 64, 8),
    ]
    max_abs_err = 0.0
    plain_ms_4spp = None
    for label, scene, ckw, camkw, size, spp in cases:
        sd = scene.compile(device=dev, **ckw)
        cam = T.Camera.look_at(device=dev, **camkw)
        blob, meta, lsb, static = mk.pack_uniforms(sd, cam, 0, SEED)
        kw = dict(width=size, height=size, spp=spp, max_bounces=DEPTH,
                  rr_depth=RR, use_nee=True, use_mis=True,
                  sky_mode=sd.sky_mode, dof=float(cam.aperture) > 0, **static)
        got, k_ms = cuda_ms(torch, lambda: mk.megakernel_fwd(
            blob, meta, lsb, **kw))
        want, p_ms = cuda_ms(torch, lambda: mk.render_tiles_plain(
            blob, meta, lsb, **kw))
        res = compare(got, want)
        emit(dict(phase="k1_vs_plain", case=label, size=size, spp=spp,
                  k1_ms=k_ms, plain_ms=p_ms, **res))
        check(res["finite"], f"{label}: K1 image not finite")
        check(res["frac_close"] >= MIN_CLOSE,
              f"{label}: {res['frac_close']:.4f} of pixels close")
        check(res["mean_rel"] <= MAX_MEAN_REL,
              f"{label}: means differ by {res['mean_rel']:.4f}")
        check(float(want.mean()) > 0.01, f"{label}: plain image is black")
        max_abs_err = max(max_abs_err, res["max_abs_err"])
        if label == "cornell" and size == W:
            plain_ms_4spp = p_ms

    # 5. Main path: the facade, counted --------------------------------------
    def cornell_tracer():
        tracer = T.create_path_tracer("cuda")
        tracer.set_scene(cornell(T))
        tracer.set_camera(T.Camera.look_at(device=dev, **cam_cornell))
        s = T.RenderSettings()
        s.set_resolution(W, H)
        s.samples_per_pixel = SPP
        s.max_bounces, s.russian_roulette_depth = DEPTH, RR
        s.use_nee = s.use_mis = True
        s.seed = SEED
        tracer.set_settings(s)
        return tracer

    mk.reset_launch_counts()
    t0 = time.perf_counter()
    tracer = cornell_tracer()
    tracer.render_to_completion()      # 256 spp in 32-spp chunks
    img = tracer.get_render_result().image_f32
    torch.cuda.synchronize()
    cornell_s = time.perf_counter() - t0
    launches_cornell = mk.LAUNCHES["k1"]

    t0 = time.perf_counter()
    demo = T.create_path_tracer("cuda")
    demo.set_scene(T.demo_scene_38_spheres())
    s2 = T.RenderSettings()
    s2.set_resolution(W, H)
    demo.set_settings(s2)
    for _ in range(8):          # one render() per frame, 1 spp each
        demo.render()
    img2 = demo.get_render_result().image_f32
    torch.cuda.synchronize()
    demo_s = time.perf_counter() - t0
    counts = dict(mk.LAUNCHES)
    emit(dict(phase="main_path", cornell_wall_s=cornell_s,
              cornell_spp=tracer.frame_count,
              cornell_k1_launches=launches_cornell, demo38_wall_s=demo_s,
              demo38_frames=demo.frame_count, launches=counts,
              cornell_mean=float(img.mean()), demo38_mean=float(img2.mean())))
    check(counts["k1"] > 0, "K1 was not launched on the main path")
    check(counts["k2"] == 0, "K2 was launched by a forward render")
    check(counts["k3"] == 0, "K3 was launched for a small scene")
    check(counts["plain"] == 0, "the plain version ran on the main path")
    check(tracer.frame_count == SPP and demo.frame_count == 8,
          "frame counts")
    for label, im in (("cornell", img), ("demo38", img2)):
        check(tuple(im.shape) == (H, W, 3), f"{label}: shape {im.shape}")
        check(bool(torch.isfinite(im).all()), f"{label}: not finite")
        check(float(im.mean()) > 0.01, f"{label}: image is black")

    # Where the Cornell render's time goes: the same render again under
    # torch.profiler; device time is the sum of the kernels' self times.
    def cornell_again():
        again = cornell_tracer()
        again.render_to_completion()
        again.get_render_result()

    prof = profiled(torch, cornell_again, "megakernel_fwd_kernel")
    emit(dict(phase="main_path_profile", unprofiled_wall_ms=1e3 * cornell_s,
              **prof))

    # 6. Timing at the headline size ------------------------------------------
    sd = cornell(T).compile(device=dev)
    cam = T.Camera.look_at(device=dev, **cam_cornell)
    blob, meta, lsb, static = mk.pack_uniforms(sd, cam, 0, SEED)
    kw = dict(width=W, height=H, spp=SPP, max_bounces=DEPTH, rr_depth=RR,
              use_nee=True, use_mis=True, sky_mode=sd.sky_mode, dof=False,
              **static)
    mk.megakernel_fwd(blob, meta, lsb, **kw)          # warm-up
    k1_ms = min(cuda_ms(torch, lambda: mk.megakernel_fwd(
        blob, meta, lsb, **kw))[1] for _ in range(3))
    # The plain version on the same inputs, timed; its counters give the
    # work of exactly these launches (they add 4 sums to each bounce's
    # some 2000 ops).
    stats = {}
    _, plain_ms = cuda_ms(torch, lambda: mk.render_tiles_plain(
        blob, meta, lsb, stats=stats, **kw))
    ops = mk.k1_op_count(stats, static["n_prims"])
    n_bytes = 4 * (blob.numel() + meta.numel() + lsb.numel() + W * H * 3)
    bound_ms = 1e3 * max(ops / FP32_PEAK, n_bytes / HBM_RATE)
    segments = sum(stats["active"]) + sum(stats["hit"])
    paths = stats["paths"]
    emit(dict(phase="timing", card=card, k1_ms=k1_ms, plain_ms=plain_ms,
              plain_ms_4spp=plain_ms_4spp,
              pixel_samples_per_s=paths / (k1_ms * 1e-3),
              segments_per_path=segments / paths,
              path_segments_per_path=sum(stats["active"]) / paths,
              jax_record_segments_per_path=9.07,
              k1_shadow_rays_per_path=sum(stats["shadow"]) / paths,
              active_per_bounce=stats["active"], hit_per_bounce=stats["hit"],
              fp32_ops=ops, bytes=n_bytes, bound_ms=bound_ms,
              ops_per_path=ops / paths))

    k1_bound_by = "operations" if ops / FP32_PEAK >= n_bytes / HBM_RATE \
        else "bytes"
    k2 = run_k2_phases(torch, T, mk, dev, card, cam_cornell, (blob, stats))
    k3 = run_k3_phases(torch, T, mk, dev, card, cam_cornell, cam_demo)
    k1_launches = {"render": counts["k1"], "train": k2["k1_train"],
                   "bvh": k3["launches"]["k1"]}
    k2_launches = {"render": counts["k2"], "train": k2["k2_train"],
                   "bvh": k3["launches"]["k2"]}
    k3_launches = {"render": counts["k3"], "train": k2["k3_train"],
                   "bvh": k3["launches"]["k3"]}

    # 16. Kernels line, then the result ---------------------------------------
    emit({"kernels": [
        dict(name="K1 megakernel_fwd", route="cuda",
             source="spt_tpu_torch/csrc/megakernel.cu",
             replaces="spt_tpu/kernels/megakernel.py:194::_kernel",
             launches=sum(k1_launches.values()),
             launches_by_path=k1_launches, max_abs_err=max_abs_err,
             ms=k1_ms, plain_ms=plain_ms,
             plain_size=f"{W}x{H} x {SPP} spp (Cornell, counting its work)",
             bound_ms=bound_ms,
             bound_by=k1_bound_by, library_ms=None,
             checked_against_plain=True),
        dict(name="K2 megakernel_grad", route="cuda",
             source="spt_tpu_torch/csrc/megakernel_grad.cu",
             replaces="spt_tpu/kernels/megakernel_grad.py:121::_kernel_grad",
             launches=sum(k2_launches.values()),
             launches_by_path=k2_launches,
             max_abs_err=k2["max_abs_err"], ms=k2["ms"],
             plain_ms=k2["plain_ms"], plain_size=k2["plain_size"],
             bound_ms=k2["bound_ms"], bound_by=k2["bound_by"],
             library_ms=None, checked_against_plain=True),
        dict(name="K3 megakernel_bvh_fwd", route="cuda",
             source="spt_tpu_torch/csrc/megakernel_bvh.cu",
             replaces="spt_tpu/kernels/megakernel_bvh.py:1137::_kernel_bvh",
             launches=sum(k3_launches.values()),
             launches_by_path=k3_launches,
             max_abs_err=k3["max_abs_err"], ms=k3["ms"],
             plain_ms=k3["plain_ms"], plain_size=k3["plain_size"],
             bound_ms=k3["bound_ms"], bound_by=k3["bound_by"],
             library_ms=None, checked_against_plain=True)]})
    emit(dict(phase="done", seconds=time.perf_counter() - t_all))
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


def run_k2_phases(torch, T, mk, dev, card, cam_cornell, k1_work) -> dict:
    """K2 against its plain version, the training main path, and K2's
    timing.  ``k1_work`` is the headline Cornell blob and the plain
    version's work counts of its samples 0..255.  Returns the numbers the
    kernels line needs."""
    from spt_tpu_torch.diff import cuda_diff, gradients as G
    from spt_tpu_torch.kernels import megakernel_grad as mg

    # 7. One bounce's adjoint: K2's per-lane code against the plain one ------
    sd = grad_scene(T).compile(device=dev)
    cam = T.Camera.look_at((0, 1.0, -1.2), (0, 0.8, 4.0), fov_degrees=55,
                           device=dev)
    blob, meta, lsb, static = mk.pack_uniforms(sd, cam, 0, SEED)
    max_abs_err = 0.0
    for k in (0, RR):            # Russian roulette off, then on
        state, aux, pid, sample, ct = vjp_lanes(torch, dev, 1 << 16, 10 + k)
        kw = dict(k=k, rr_depth=RR, use_nee=True, use_mis=True,
                  sky_mode=sd.sky_mode, **static)
        g_k, ct_k = mg.bounce_vjp(blob, meta, lsb, state, aux, pid, sample,
                                  ct, **kw)
        g_p, ct_p = mg.bounce_vjp_plain(blob, meta, lsb, state, aux, pid,
                                        sample, ct, **kw)
        torch.cuda.synchronize()
        a, b = ct_k.cpu().numpy(), ct_p.cpu().numpy()
        close = np.isclose(a, b, rtol=VJP_RTOL, atol=VJP_ATOL_REL
                           * np.abs(b).max(axis=1, keepdims=True)).all(0)
        errs, g_err = grad_errors(g_k, g_p, static["n_prims"])
        emit(dict(phase="k2_bounce_vs_plain", k=k, lanes=int(a.shape[1]),
                  frac_close=float(close.mean()),
                  finite=bool(np.isfinite(a).all()), gvec_max_abs_err=g_err,
                  gvec_rel=[e["rel"] for e in errs]))
        check(bool(np.isfinite(a).all()), f"bounce k={k}: not finite")
        check(close.mean() >= VJP_MIN_CLOSE,
              f"bounce k={k}: {close.mean():.5f} of lanes close")
        check(all(e["ok"] for e in errs), f"bounce k={k}: gvec {errs}")
        check(float(g_p.abs().sum()) > 0, f"bounce k={k}: zero gradient")

    # 8. K2 against its plain version, both on the card -----------------------
    cam_demo = dict(position=(0, 0, 0), target=(0, 0, 1), fov_degrees=90)
    ct_imgs = {size: torch.from_numpy(np.random.default_rng(SEED).uniform(
        0.5, 1.5, (size, size, 3)).astype(np.float32)).to(dev)
        for size in (64, W)}
    plain_ms = None
    # The last case is the training main path's launch shape.
    cases = [("cornell", cornell(T), {}, cam_cornell, 64, {}),
             ("demo38", T.demo_scene_38_spheres(), dict(capacity=64),
              cam_demo, 64, {}),
             ("cornell_thin_lens", cornell(T), {},
              dict(cam_cornell, aperture=0.15, focus_dist=4.5), 64, {}),
             ("cornell_nee_off", cornell(T), {}, cam_cornell, 64,
              dict(use_nee=False)),
             ("cornell_mis_off", cornell(T), {}, cam_cornell, 64,
              dict(use_mis=False)),
             ("cornell", cornell(T), {}, cam_cornell, W, {})]
    for label, scene, ckw, camkw, size, opt in cases:
        sd = scene.compile(device=dev, **ckw)
        cam = T.Camera.look_at(device=dev, **camkw)
        blob, meta, lsb, static = mk.pack_uniforms(sd, cam, 0, SEED)
        kw = dict(dict(width=size, height=size, spp=4, max_bounces=DEPTH,
                       rr_depth=RR, use_nee=True, use_mis=True,
                       sky_mode=sd.sky_mode,
                       dof=float(cam.aperture) > 0, **static), **opt)
        ct_img = ct_imgs[size]
        img_k, g_k = mg.megakernel_grad(blob, meta, lsb, ct_img, **kw)
        (img_p, g_p), p_ms = cuda_ms(torch, lambda: mg.render_and_grad_plain(
            blob, meta, lsb, ct_img, **kw))
        img_1 = mk.megakernel_fwd(blob, meta, lsb, **kw)
        torch.cuda.synchronize()
        res = compare(img_k, img_1)
        errs, g_err = grad_errors(g_k, g_p, static["n_prims"])
        out = dict(phase="k2_vs_plain", case=label, size=size, spp=4,
                   image_equals_k1=bool(torch.equal(img_k, img_1)),
                   image_vs_plain=compare(img_k, img_p), image_vs_k1=res,
                   gvec_max_abs_err=g_err, plain_ms=p_ms,
                   gvec_rel=[e["rel"] for e in errs],
                   gvec_norm=float(g_p.norm()))
        if label == "cornell" and size == W:
            plain_ms = p_ms
        if label == "cornell" and size == 64:
            # Autograd of the plain K1 itself, which does not go through the
            # hand adjoint: a derivation error shared by both adjoints shows.
            b = blob.clone().requires_grad_(True)
            loss = (mk.render_tiles_plain(b, meta, lsb, **kw)
                    * ct_img).sum()
            (d_blob,) = torch.autograd.grad(loss, b)
            auto = torch.cat([d_blob[21:], d_blob[15:21]])
            a_errs, _ = grad_errors(g_k, auto, static["n_prims"])
            out["gvec_rel_vs_autograd"] = [e["rel"] for e in a_errs]
            check(all(e["ok"] for e in a_errs),
                  f"{label}: gvec vs autograd {a_errs}")
        emit(out)
        check(res["finite"] and bool(torch.isfinite(g_k).all()),
              f"{label}: K2 output not finite")
        check(out["image_equals_k1"], f"{label}: K2 image against K1 {res}")
        check(all(e["ok"] for e in errs), f"{label}: gvec {errs}")
        check(float(g_p.abs().sum()) > 0, f"{label}: zero gradient")
        if label == "demo38":
            n_sph = 12 * static["n_prims"]
            check(float(g_p[n_sph:].abs().sum()) > 0, "demo38: no sky grad")
        max_abs_err = max(max_abs_err, g_err, res["max_abs_err"])

    # 9. Training main path: InverseRenderer through K1 and K2, counted ------
    sd = cornell(T).compile(device=dev)
    cam = T.Camera.look_at(device=dev, **cam_cornell)
    true_p = G.get_params(sd, ("albedo", "roughness"))
    r = np.random.default_rng(SEED)
    albedo0 = torch.clamp(true_p["albedo"] + torch.from_numpy(r.uniform(
        -0.2, 0.2, tuple(true_p["albedo"].shape)).astype(np.float32)).to(dev),
        0.0, 1.0)
    sd0 = G.apply_params(sd, {"albedo": albedo0})

    def inverse_renderer(target):
        return G.InverseRenderer(sd0, cam, target, spp_per_step=TRAIN_SPP,
                                 learning_rate=TRAIN_LR, max_bounces=DEPTH,
                                 seed=SEED, rotate_samples=False,
                                 backend="cuda")

    mk.reset_launch_counts()
    t0 = time.perf_counter()
    render = cuda_diff.make_cuda_render_fn(sd, cam, W, H, spp=TRAIN_SPP,
                                           max_bounces=DEPTH, seed=SEED)
    with torch.no_grad():
        target = render(true_p, 0)
    inv = inverse_renderer(target)
    err0 = float((inv.params["albedo"].detach() - true_p["albedo"]).abs()
                 .mean())
    losses, step_s = [], []
    for _ in range(TRAIN_STEPS):
        t1 = time.perf_counter()
        losses.append(inv.step())          # float(loss) waits for the card
        step_s.append(time.perf_counter() - t1)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    counts = dict(mk.LAUNCHES)
    err1 = float((inv.params["albedo"].detach() - true_p["albedo"]).abs()
                 .mean())
    # Where the steps' time goes: 10 steps of a second renderer, built
    # before the profile starts, under torch.profiler.  The busy share is
    # that run's device time over that run's wall.
    inv_p = inverse_renderer(target)
    prof = profiled(torch, lambda: inv_p.run(TRAIN_STEPS),
                    "megakernel_grad_kernel")
    emit(dict(phase="train_main_path", size=W, spp_per_step=TRAIN_SPP,
              steps=TRAIN_STEPS, losses=losses, albedo_err_start=err0,
              albedo_err_end=err1, wall_s=train_s, step_s=step_s,
              wall_per_step_ms=1e3 * sum(step_s) / TRAIN_STEPS,
              launches=counts, k1_outside_steps=1,
              profiled_wall_per_step_ms=prof["profiled_wall_ms"] / TRAIN_STEPS,
              **prof))
    check(all(np.isfinite(losses)), "training loss not finite")
    check(losses[-1] < losses[0], "training did not lower the loss")
    check(err1 < err0, "training did not lower the albedo error")
    check(counts["k2"] == TRAIN_STEPS, f"K2 launches {counts['k2']}")
    check(counts["k1"] == TRAIN_STEPS + 1, f"K1 launches {counts['k1']}")
    check(counts["plain"] == 0, "the plain version ran on the training path")
    check(counts["k3"] == 0, "K3 was launched on the training path")

    # 10. K2 at the headline size: one 1024-spp render_and_grad launch -------
    blob, meta, lsb, static = mk.pack_uniforms(sd, cam, 0, SEED)
    kw = dict(width=W, height=H, spp=K2_SPP, max_bounces=DEPTH, rr_depth=RR,
              use_nee=True, use_mis=True, sky_mode=sd.sky_mode, dof=False,
              **static)
    ones = torch.ones(H, W, 3, device=dev)
    mg.megakernel_grad(blob, meta, lsb, ones, **kw)        # warm-up
    k2_ms = min(cuda_ms(torch, lambda: mg.megakernel_grad(
        blob, meta, lsb, ones, **kw))[1] for _ in range(3))
    k1_ms = min(cuda_ms(torch, lambda: mk.megakernel_fwd(
        blob, meta, lsb, **kw))[1] for _ in range(3))
    # The work of samples 0..1023: the plain version's counts of samples
    # 0..255 from the K1 timing (67M paths), times 4.  An average over 67M
    # paths moves far less than the bound's own looseness.
    blob_256, stats_256 = k1_work
    check(torch.equal(blob, blob_256), "K1 and K2 timings differ in scene")
    scale = K2_SPP // SPP
    stats = {k: (v * scale if k == "paths" else [a * scale for a in v])
             for k, v in stats_256.items()}
    ops = mg.k2_op_count(stats, static["n_prims"])
    n_bytes = 4 * (blob.numel() + meta.numel() + lsb.numel()
                   + 2 * W * H * 3 + 12 * static["n_prims"] + 6)
    bound_ms = 1e3 * max(ops / FP32_PEAK, n_bytes / HBM_RATE)
    paths = stats["paths"]
    emit(dict(phase="k2_timing", card=card, size=W, spp=K2_SPP, k2_ms=k2_ms,
              k1_ms_same_spp=k1_ms, k2_over_k1=k2_ms / k1_ms,
              pixel_samples_per_s=paths / (k2_ms * 1e-3), fp32_ops=ops,
              bytes=n_bytes, bound_ms=bound_ms, ops_per_path=ops / paths,
              lit_per_path=sum(stats["lit"]) / paths,
              plain_ms=plain_ms, plain_size=f"{W}x{H} x 4 spp (Cornell)"))
    return dict(k1_train=counts["k1"], k2_train=counts["k2"],
                k3_train=counts["k3"],
                max_abs_err=max_abs_err, ms=k2_ms, plain_ms=plain_ms,
                plain_size=f"{W}x{H} x 4 spp", bound_ms=bound_ms,
                bound_by="operations" if ops / FP32_PEAK >= n_bytes / HBM_RATE
                else "bytes")


def k3_inputs(torch, mb, sd, cam, seed, block=None):
    """K3's packed inputs for a compiled scene and camera (samples from 0),
    its keywords and the packing's static dict."""
    block = block or mb.BLOCK
    t, st = mb.packed(sd, cam, block)
    meta = torch.tensor([0, seed, st["n_light_slots"]], dtype=torch.int32,
                        device=sd.device)
    args = (t["blob"], meta, t["lsb"], t["nodef"], t["nodei"], t["prims"],
            t["mtypes"])
    return args, dict(block=block, n_mats=st["n_mats"],
                      n_light_slots=st["n_light_slots"]), st


def run_k3_phases(torch, T, mk, dev, card, cam_cornell, cam_demo) -> dict:
    """K3 against K1 and against its plain version, the large-scene main
    path, and K3's timing.  Returns the numbers the kernels line needs."""
    from spt_tpu_torch.kernels import megakernel_bvh as mb

    def check_close(res, label):
        check(res["finite"], f"{label}: K3 image not finite")
        check(res["frac_close"] >= MIN_CLOSE,
              f"{label}: {res['frac_close']:.4f} of pixels close")
        check(res["mean_rel"] <= MAX_MEAN_REL,
              f"{label}: means differ by {res['mean_rel']:.4f}")

    # 12. K3 against K1 on the small scenes, packed for the BVH walk -------
    max_abs_err = 0.0
    for label, scene, ckw, camkw, size, spp in [
            ("cornell", cornell(T), {}, cam_cornell, 64, 8),
            ("demo38", T.demo_scene_38_spheres(), dict(capacity=64),
             cam_demo, 64, 8),
            ("cornell", cornell(T), {}, cam_cornell, W, 4),
            ("demo38", T.demo_scene_38_spheres(), dict(capacity=64),
             cam_demo, W, 4)]:
        sd = scene.compile(device=dev, **ckw)
        cam = T.Camera.look_at(device=dev, **camkw)
        blob, meta, lsb, static = mk.pack_uniforms(sd, cam, 0, SEED)
        kw = dict(width=size, height=size, spp=spp, max_bounces=DEPTH,
                  rr_depth=RR, use_nee=True, use_mis=True,
                  sky_mode=sd.sky_mode, dof=False)
        want = mk.megakernel_fwd(blob, meta, lsb, **kw, **static)
        args, k3kw, st = k3_inputs(torch, mb, sd, cam, SEED)
        got = mb.megakernel_bvh_fwd(*args, **kw, **k3kw)
        torch.cuda.synchronize()
        res = compare(got, want)
        emit(dict(phase="k3_vs_k1", case=label, size=size, spp=spp,
                  n_blocks=st["n_blocks"],
                  pixels_differ=int((got != want).any(-1).sum()), **res))
        check_close(res, f"{label} K3 vs K1")
        check(float(want.mean()) > 0.01, f"{label}: K1 image is black")
        max_abs_err = max(max_abs_err, res["max_abs_err"])

    # 13. K3 against its plain version, both on the card -------------------
    cam10 = T.Camera.look_at(device=dev, **CAM_10K)
    sd10 = scene_10k(T).compile(device=dev)
    cam200 = T.Camera.look_at((0, 2.0, -4.0), (0, 1.0, 14.0), fov_degrees=60,
                              aperture=0.3, focus_dist=14.0, device=dev)
    plain_small = {}
    for label, sd, cam, w, h, spp, seed in [
            ("config5", sd10, cam10, 240, 136, 2, BIG_SEED),
            ("scene200_thin_lens", scene_200(T).compile(device=dev), cam200,
             64, 64, 8, SEED)]:
        args, k3kw, st = k3_inputs(torch, mb, sd, cam, seed)
        kw = dict(width=w, height=h, spp=spp, max_bounces=DEPTH, rr_depth=RR,
                  use_nee=True, use_mis=True, sky_mode=sd.sky_mode,
                  dof=float(cam.aperture) > 0)
        got, k_ms = cuda_ms(torch, lambda: mb.megakernel_bvh_fwd(
            *args, **kw, **k3kw))
        want, p_ms = cuda_ms(torch, lambda: mb.render_tiles_bvh_plain(
            *args, **kw, **k3kw))
        res = compare(got, want)
        emit(dict(phase="k3_vs_plain", case=label, width=w, height=h,
                  spp=spp, k3_ms=k_ms, plain_ms=p_ms, n_nodes=st["n_nodes"],
                  n_blocks=st["n_blocks"], builder=st["builder"],
                  pixels_differ=int((got != want).any(-1).sum()), **res))
        check_close(res, f"{label} K3 vs plain")
        check(float(want.mean()) > 0.01, f"{label}: plain image is black")
        max_abs_err = max(max_abs_err, res["max_abs_err"])
        plain_small[label] = p_ms

    # 14. Main path: the facade on config 5 at 1920x1080, counted ----------
    def big_tracer(scene):
        tracer = T.create_path_tracer("cuda")
        tracer.set_scene(scene)
        tracer.set_camera(T.Camera.look_at(device=dev, **CAM_10K))
        s = T.RenderSettings()
        s.set_resolution(BIG_W, BIG_H)
        s.samples_per_pixel = BIG_SPP
        s.max_bounces, s.russian_roulette_depth = DEPTH, RR
        s.use_nee = s.use_mis = True
        s.seed = BIG_SEED
        tracer.set_settings(s)
        return tracer

    mb._PACK_CACHE.clear()           # the facade packs its scene afresh
    mk.reset_launch_counts()
    t0 = time.perf_counter()
    scene = scene_10k(T)
    scene_s = time.perf_counter() - t0
    tracer = big_tracer(scene)
    tracer.render_to_completion()
    img = tracer.get_render_result().image_f32
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    counts = dict(mk.LAUNCHES)
    sd = tracer.scene_data
    pack = mb.packed(sd, cam10)[1]["seconds"]    # the facade's own pack
    emit(dict(phase="bvh_main_path", wall_s=wall_s, scene_build_s=scene_s,
              compile_s=tracer.compile_seconds,
              compile_bvh_build_s=sd.bvh.seconds, bvh_builder=sd.bvh.builder,
              pack_s=pack["pack"], pack_bvh_build_s=pack["bvh_build"],
              pack_octant_tables_s=pack["octant_tables"],
              rest_s=wall_s - scene_s - tracer.compile_seconds - pack["pack"],
              launches=counts, spp=tracer.frame_count, capacity=sd.capacity,
              mean=float(img.mean())))
    check(counts["k3"] > 0, "K3 was not launched on the large-scene path")
    check(counts["k1"] == 0 and counts["k2"] == 0,
          "K1 or K2 was launched on the large-scene path")
    check(counts["plain"] == 0, "the plain version ran on the large path")
    check(tracer.frame_count == BIG_SPP, "frame count")
    check(tuple(img.shape) == (BIG_H, BIG_W, 3), f"config5: shape {img.shape}")
    check(bool(torch.isfinite(img).all()), "config5: image not finite")
    check(float(img.mean()) > 0.01, "config5: image is black")

    def big_again():
        again = big_tracer(scene)
        again.render_to_completion()
        again.get_render_result()

    prof = profiled(torch, big_again, "megakernel_bvh_kernel")
    emit(dict(phase="bvh_main_path_profile", unprofiled_wall_ms=1e3 * wall_s,
              packing_cached=True, **prof))

    # 15. K3 at the full size: one 4-spp launch ------------------------------
    kw = dict(width=BIG_W, height=BIG_H, spp=BIG_SPP, max_bounces=DEPTH,
              rr_depth=RR, use_nee=True, use_mis=True, sky_mode=sd.sky_mode,
              dof=False)
    args, k3kw, st = k3_inputs(torch, mb, sd, cam10, BIG_SEED)
    mb.megakernel_bvh_fwd(*args, **kw, **k3kw)          # warm-up
    k3_ms = min(cuda_ms(torch, lambda: mb.megakernel_bvh_fwd(
        *args, **kw, **k3kw))[1] for _ in range(3))
    # The plain version's counts of sample 0 of the four (2.07M paths),
    # times 4; the run is timed, in inference mode.  Its image holds K3's
    # launch of that sample at the main path's full size.
    one = {}
    kw1 = dict(kw, spp=1)
    with torch.inference_mode():
        want, plain_ms = cuda_ms(torch, lambda: mb.render_tiles_bvh_plain(
            *args, **kw1, **k3kw, stats=one))
    got = mb.megakernel_bvh_fwd(*args, **kw1, **k3kw)
    torch.cuda.synchronize()
    res = compare(got, want)
    emit(dict(phase="k3_vs_plain", case="config5_full", width=BIG_W,
              height=BIG_H, spp=1, plain_ms=plain_ms, n_nodes=st["n_nodes"],
              n_blocks=st["n_blocks"], builder=st["builder"],
              pixels_differ=int((got != want).any(-1).sum()), **res))
    check_close(res, "config5_full K3 vs plain")
    check(float(want.mean()) > 0.01, "config5_full: plain image is black")
    max_abs_err = max(max_abs_err, res["max_abs_err"])
    del got, want
    stats = {k: (v * BIG_SPP if k == "paths" else [a * BIG_SPP for a in v])
             for k, v in one.items()}
    ops = mb.k3_op_count(stats)
    n_bytes = 4 * (sum(a.numel() for a in args) + BIG_W * BIG_H * 3)
    bound_ms = 1e3 * max(ops / FP32_PEAK, n_bytes / HBM_RATE)
    paths = stats["paths"]
    nodes = sum(stats["nodes"]) + sum(stats["shadow_nodes"])
    spheres = sum(stats["spheres"]) + sum(stats["shadow_spheres"])
    block_ms = {}
    for block in (8, 128):
        args_b, kw_b, st_b = k3_inputs(torch, mb, sd, cam10, BIG_SEED, block)
        mb.megakernel_bvh_fwd(*args_b, **kw, **kw_b)
        block_ms[block] = dict(n_nodes=st_b["n_nodes"],
                               n_blocks=st_b["n_blocks"], ms=min(
            cuda_ms(torch, lambda: mb.megakernel_bvh_fwd(
                *args_b, **kw, **kw_b))[1] for _ in range(3)))
    emit(dict(phase="k3_timing", card=card, size=f"{BIG_W}x{BIG_H}",
              spp=BIG_SPP, block=mb.BLOCK, k3_ms=k3_ms,
              pixel_samples_per_s=paths / (k3_ms * 1e-3),
              segments_per_path=(sum(stats["active"]) + sum(stats["hit"]))
              / paths,
              path_segments_per_path=sum(stats["active"]) / paths,
              shadow_rays_per_path=sum(stats["shadow"]) / paths,
              node_tests_per_path=nodes / paths,
              sphere_tests_per_path=spheres / paths,
              nearest_nodes_per_bounce=stats["nodes"],
              shadow_nodes_per_bounce=stats["shadow_nodes"],
              active_per_bounce=stats["active"],
              # node rows (40 bytes read) and filled leaf slots (16) the
              # walks need, served by L1/L2: not the bound's bytes
              walk_bytes=40 * nodes + 16 * spheres,
              fp32_ops=ops, bytes=n_bytes, bound_ms=bound_ms,
              ops_per_path=ops / paths, plain_ms_1spp=plain_ms,
              plain_ms_small=plain_small, n_nodes=st["n_nodes"],
              n_blocks=st["n_blocks"], other_blocks=block_ms))
    return dict(launches=counts, max_abs_err=max_abs_err, ms=k3_ms,
                plain_ms=plain_ms,
                plain_size=f"{BIG_W}x{BIG_H} x 1 spp (config 5, counting "
                           "its work)",
                bound_ms=bound_ms,
                bound_by="operations" if ops / FP32_PEAK >= n_bytes / HBM_RATE
                else "bytes")


def main() -> int:
    try:
        return run()
    except ImportError as e:
        print(f"chip_smoke: cannot import the port ({e})", file=sys.stderr)
        return 2
    except Exception:   # any phase: report it and exit nonzero
        traceback.print_exc()
        return 1


if __name__ == "__main__":
    sys.exit(main())
