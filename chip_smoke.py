#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds every CUDA kernel of the port from spt_tpu_torch/csrc with nvcc,
holds each against its plain PyTorch version on the card, drives the main
paths (the progressive render facade, ``create_path_tracer("cuda")``,
through K1 at the repo's headline size; inverse rendering,
``InverseRenderer(backend="cuda")``, through K1 forward and K2 backward;
the facade at 1920x1080 on the repo's large scene cut to 2,000 spheres,
through K3; and the facade on the large scene itself, 10,000 spheres, with
its gradient sky and with an environment map, through the sorted
wavefront's K5, K6 and K7, whose rays walk the tree (no lists built); and
the large-scene gradients at 1920x1080 x 4
spp, one backward and 3 ``InverseRenderer`` steps each: config 5 cut to
2,000 spheres through K3 forward and K4 backward, and config 5 itself
through the differentiable wavefront, K5, K6 and K9 forward and K10
backward; and config 5 through the prim-sharded wavefront, K5, K6, K8 and
K7 reading the merged shadow verdict, under NCCL at world size 1, then on 2
spawned gloo ranks on the one card prim-sharded, sample-sharded and its
data-parallel gradient; and config 5 through the wavefront's other bounce
forms, each against the split form: the fused bounce K11 with the
precull's lists (culled per ray by the leaf boxes) and with the walk, the
matmul-form sweeps K6m (its row lists culled per ray by the leaf boxes,
held against the unculled sweep too) and K7m (its verdict pass, then
K7b's kernel), and
the fused gradient, K11g forward and K10 backward), and times the kernels
and the wavefront's glue.  Last it drives the applications: the CLI
renderer (``python -m spt_tpu_torch.apps.render_cli``, in process through
``main(argv)`` and once as a fresh process) on ``scenes/cornell.json`` at
the file's settings (K1; checkpoint and resume, the image formats, a
torch.profiler trace), on ``scenes/demo38.json`` (K1) and on scenes saved
with ``save_scene`` and loaded back (200 spheres through K3; config 5 with
its environment map through the wavefront), each image equal to the
facade's; the inverse-render app at its defaults (K1 forward, K2
backward); and the facade's "reference" integrator (torch ops) on demo38,
its frames held against the CPU at the JAX parity bar.
Each phase prints one JSON line; any
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
# The rate at which the card issues fp32 operations that are not fused
# multiply-adds: FP32_PEAK counts an FMA as two.  The port builds with
# --fmad=false, so none of its operations is fused.
FP32_ISSUE = FP32_PEAK / 2
HBM_RATE = 3.35e12       # H100 SXM HBM3 bytes/s
# K1's bar, for the kernels held to a bar against their plain versions on
# the card: pixels isclose(rtol=2e-3, atol=2e-4), as the JAX suite holds
# two implementations (tests/test_pallas.py), but on 99.9% of pixels (not
# 97%) with means within 0.1% (not 1%).  K1 and K3 themselves are held to
# more: both round as their plain versions do (same libdevice,
# --fmad=false) and each path runs the plain version's operations, so
# every value of their images equals the plain version's (values_differ).
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
# The large-scene gradients (K4, K10, the wavefront's) have heavy tails:
# their checks scale by a typical magnitude (the median of the nonzero
# ones) in place of the largest, and hold a field's body and its tail
# above this quantile apart (tail_field_errors, lanes_close).
TAIL_Q = 0.99
# K10 against its plain version entry by entry on that typical scale: on
# at least 99.5% of lanes, the bar of the plain adjoint against jax.vjp
# (tests/test_torch_grad.py).  On about 0.2% of a config-5 bounce's lanes
# the two adjoints, which associate sums otherwise, part by 0.1-1% of a
# typical value, where a cotangent is a small difference of large terms.
K10_MIN_CLOSE = 0.995
TRAIN_SPP, TRAIN_STEPS, TRAIN_LR, K2_SPP = 16, 10, 0.02, 1024
# InverseRenderer steps of each large-scene gradient main path.
GRAD_STEPS = 3
# The large scene (BASELINE config 5, bench_suite.py's scene_10k): 10,000
# spheres, 1920x1080, 4 spp, depth 8, RR 3, NEE+MIS, seed 5.
BIG_W, BIG_H, BIG_SPP, BIG_SEED = 1920, 1080, 4, 5
CAM_10K = dict(position=(0, 0, -10), target=(0, 0, 60), fov_degrees=65)
# Config 5 cut to the largest capacity the facade still gives K3 (2048):
# K3's main path since the wavefront takes capacities above it.
K3_MAIN_SPHERES = 2000
# K1's and K3's ragged image (width, height): a width not a multiple of 32,
# a height not a multiple of 8, and 3,700 pixels, not a multiple of a
# warp's batch of 32.
RAGGED = (100, 37)


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


def k2_capacity_scene(pkg, seed=8):
    """K2 at its capacity, 128 spheres: a floor and a 16 x 8 grid of 127
    small spheres in four Lambert materials, a metal and a glass, 7 of them
    lamps in two emissions (7 light slots), under a gradient sky, so that
    many sphere rows and several light rows meet in one warp."""
    r = np.random.default_rng(seed)
    scene = pkg.Scene()
    scene.set_sky(pkg.SKY_GRADIENT, horizon=(0.8, 0.85, 0.9),
                  zenith=(0.2, 0.35, 0.7))
    mats = [scene.add_material("lambert",
                               albedo=tuple(r.uniform(0.2, 0.9, 3)))
            for _ in range(4)]
    mats.append(scene.add_material("metal", albedo=(0.9, 0.8, 0.7),
                                   roughness=0.25))
    mats.append(scene.add_material("glass", albedo=(0.95,) * 3, ior=1.5))
    lamps = [scene.add_material("lambert", albedo=(0.8,) * 3,
                                emission=tuple(r.uniform(3.0, 8.0, 3)))
             for _ in range(2)]
    scene.create_sphere("floor", (0, -1000, 0), 1000.0, mats[0])
    for i in range(127):
        pos = (-4.5 + 0.6 * (i % 16), 0.25 + 0.35 * r.random(),
               2.0 + 0.6 * (i // 16))
        m = lamps[i % 2] if i % 21 == 0 else mats[i % len(mats)]
        scene.create_sphere(f"s{i}", pos, 0.22, m)
    return scene


K2_CAPACITY_CAM = dict(position=(0, 2.2, -3.0), target=(0, 0.3, 4.5),
                       fov_degrees=60)


def enclosure_scene(pkg):
    """A room that is one sphere: the camera inside a white sphere of
    radius 20 with one lamp, so at every bounce all 32 lanes of most warps
    hit the same sphere, and every lit bounce adds to the lamp's row."""
    scene = pkg.Scene()
    scene.set_sky(pkg.SKY_NONE)
    white = scene.add_material("lambert", albedo=(0.75, 0.75, 0.75))
    lamp = scene.add_material("lambert", albedo=(0.8,) * 3,
                              emission=(20.0,) * 3)
    scene.create_sphere("room", (0, 0, 0), 20.0, white)
    scene.create_sphere("lamp", (0, 12, 8), 2.0, lamp)
    return scene


ENCLOSURE_CAM = dict(position=(0, 0, 0), target=(0, 0, 1), fov_degrees=60)


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


def big_tracer(pkg, dev, scene, spp=BIG_SPP):
    """The facade at config 5's settings (1920x1080, depth 8, RR 3,
    NEE+MIS, seed 5, its camera) on ``scene``."""
    tracer = pkg.create_path_tracer("cuda")
    tracer.set_scene(scene)
    tracer.set_camera(pkg.Camera.look_at(device=dev, **CAM_10K))
    s = pkg.RenderSettings()
    s.set_resolution(BIG_W, BIG_H)
    s.samples_per_pixel = spp
    s.max_bounces, s.russian_roulette_depth = DEPTH, RR
    s.use_nee = s.use_mis = True
    s.seed = BIG_SEED
    tracer.set_settings(s)
    return tracer


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


def padding_scene(pkg, n=150, seed=12):
    """A scene whose camera rays win padding slots: leaf padding (centre 0,
    radius 0) lies at the origin, and ``PAD_CAM`` looks at it through a
    0.02-degree field, so the float quadratic finds a positive
    discriminant on about half its rays; a sphere behind the origin puts
    a leaf holding padding on every ray.  About 145 spheres (capacity
    256: the BVH kernels' range), none near the view axis, and a lamp."""
    rng = np.random.default_rng(seed)
    scene = pkg.Scene()
    scene.set_sky(pkg.SKY_GRADIENT)
    mats = [scene.add_material("lambert",
                               albedo=tuple(rng.uniform(0.2, 0.9, 3)))
            for _ in range(3)]
    emit_m = scene.add_material("lambert", albedo=(0.8,) * 3,
                                emission=(12.0, 10.0, 8.0))
    scene.create_sphere("back", (0.0, 0.0, 6.0), 2.0, mats[0])
    pos = rng.uniform(-12, 12, (n, 3)).astype(np.float32)
    pos[:, 2] = rng.uniform(2.0, 20.0, n)
    for i, p in enumerate(pos[np.hypot(pos[:, 0], pos[:, 1]) > 3.0]):
        scene.create_sphere(f"s{i}", tuple(p), 0.5, mats[i % 3])
    scene.create_sphere("lamp", (0, 8, 4), 1.5, emit_m)
    return scene


PAD_CAM = dict(position=(1.3, -0.7, -7.1), target=(0.0, 0.0, 0.0),
               fov_degrees=0.02)


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
    """field_errors per field of gvec (12 sphere attributes over the
    spheres, then the sky), as a list."""
    def fields(g):
        return dict({a: g[a:12 * n_prims:12] for a in range(12)},
                    sky=g[12 * n_prims:])
    errs, worst = field_errors(fields(got), fields(want))
    return list(errs.values()), worst


def field_errors(got: dict, want: dict):
    """Per named gradient field: relative L2 error, or absolute where the
    plain field is 0, and ok against GRAD_REL / GRAD_ABS; and the largest
    absolute difference."""
    out, worst = {}, 0.0
    for key, w in want.items():
        g = got[key].double().cpu().numpy()
        w = w.double().cpu().numpy()
        norm, err = np.linalg.norm(w), np.linalg.norm(g - w)
        out[key] = dict(rel=err / norm if norm > 0 else None, abs=err,
                        ok=bool(np.isfinite(g).all()) and (
                            err <= GRAD_REL * norm if norm > 0
                            else err <= GRAD_ABS))
        if g.size:
            worst = max(worst, float(np.abs(g - w).max()))
    return out, worst


def _typical(mag):
    """The median of the nonzero magnitudes: a typical entry's scale (0
    where every entry is 0)."""
    nz = mag[mag > 0]
    return float(np.median(nz)) if nz.size else 0.0


def tail_field_errors(got: dict, want: dict):
    """The large-scene gradients' field check.  Their fields have heavy
    tails: a grazing hit gives one lane or sphere 1e5-1e7 times a typical
    value, enough to carry a field's whole norm, so one relative L2 (as in
    field_errors) would see only those entries.  Each field must hold
    three ways: split at the ``TAIL_Q`` quantile of the plain field's
    magnitudes, its body and its tail each within GRAD_REL relative L2 (or
    GRAD_ABS where that part of the plain field is 0); and entry by entry,
    isclose(rtol GRAD_REL, atol GRAD_REL times the typical nonzero
    magnitude) on at least VJP_MIN_CLOSE of the entries.  Also gives each
    field's scales (typical, quantile, largest) and the parts' sizes."""
    out, worst = {}, 0.0
    for key, w in want.items():
        g = got[key].double().cpu().numpy().reshape(-1)
        w = w.double().cpu().numpy().reshape(-1)
        mag = np.abs(w)
        cut = float(np.quantile(mag, TAIL_Q)) if w.size else 0.0
        typ = _typical(mag)
        parts = {}
        for part, sel in (("body", mag <= cut), ("tail", mag > cut)):
            norm = np.linalg.norm(w[sel])
            err = np.linalg.norm(g[sel] - w[sel])
            parts[part] = dict(n=int(sel.sum()),
                               rel=err / norm if norm > 0 else None,
                               ok=bool(err <= GRAD_REL * norm if norm > 0
                                       else err <= GRAD_ABS))
        close = np.isclose(g, w, rtol=GRAD_REL, atol=GRAD_REL * typ) \
            if typ > 0 else np.abs(g - w) <= GRAD_ABS
        frac = float(close.mean()) if w.size else 1.0
        out[key] = dict(
            body_rel=parts["body"]["rel"], tail_rel=parts["tail"]["rel"],
            n_body=parts["body"]["n"], n_tail=parts["tail"]["n"],
            frac_close=frac, not_close=int((~close).sum()), typical=typ,
            q99=cut, max=float(mag.max()) if w.size else 0.0,
            ok=bool(np.isfinite(g).all()) and parts["body"]["ok"]
            and parts["tail"]["ok"] and frac >= VJP_MIN_CLOSE)
        if g.size:
            worst = max(worst, float(np.abs(g - w).max()))
    return out, worst


def lanes_close(got, want):
    """K10's per-lane cotangents (channels, lanes) against the plain
    K10's.  Entry by entry, isclose(rtol VJP_RTOL, atol VJP_ATOL_REL times
    the channel's typical nonzero magnitude; the largest, as K2's bar
    takes it, is a grazing lane's 1e7 here, loose enough to pass a wrong
    kernel) on at least K10_MIN_CLOSE of the lanes; and the lanes split
    into body and tail (a lane with any channel above its ``TAIL_Q``
    quantile), each within GRAD_REL relative L2.  Returns a dict: the
    fraction of lanes close on every channel, the parts' errors and sizes,
    per channel its typical, quantile and largest magnitude and its lanes
    not close, and ``ok``."""
    got, want = got.double().cpu().numpy(), want.double().cpu().numpy()
    close = np.ones(want.shape[1], bool)
    tail = np.zeros(want.shape[1], bool)
    channels = []
    for a, b in zip(got, want):
        mag = np.abs(b)
        typ, q = _typical(mag), float(np.quantile(mag, TAIL_Q))
        ok = np.isclose(a, b, rtol=VJP_RTOL, atol=VJP_ATOL_REL * typ)
        close &= ok
        tail |= mag > q
        channels.append(dict(typical=typ, q99=q, max=float(mag.max()),
                             not_close=int((~ok).sum())))
    out = dict(frac_close=float(close.mean()), n_tail_lanes=int(tail.sum()),
               channels=channels)
    ok = bool(np.isfinite(got).all()) and out["frac_close"] >= K10_MIN_CLOSE
    for part, sel in (("body", ~tail), ("tail", tail)):
        norm = np.linalg.norm(want[:, sel])
        err = np.linalg.norm(got[:, sel] - want[:, sel])
        out[f"{part}_rel"] = err / norm if norm > 0 else None
        ok = ok and bool(err <= GRAD_REL * norm if norm > 0
                         else err <= GRAD_ABS)
    out["ok"] = ok
    return out


def raw_fields(grad_s, grad_g, n_mats):
    """K4's raw gradients (or K10's scalars and per-lane geometry) as named
    fields: sky, material rows, light slots, geometry."""
    return dict(sky=grad_s[:6], materials=grad_s[6:6 + 8 * n_mats],
                lights=grad_s[6 + 8 * n_mats:], geometry=grad_g)


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
    kernel's part, the top five, and ``index_add_``'s calls and whether its
    kernel is among them.  On the card's timeline it also
    counts the host reads (device-to-host copies: each makes the host wait
    for the card) and the card's idle time right after them, before its
    next operation, beside its idle time in all."""
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
    reads, idle_us, read_idle_us = 0, 0.0, 0.0
    end, after_read = None, False
    for e in sorted((e for e in prof.events()
                     if e.device_type == DeviceType.CUDA),
                    key=lambda e: e.time_range.start):
        gap = 0.0 if end is None else e.time_range.start - end
        if gap > 0:
            idle_us += gap
            read_idle_us += gap if after_read else 0.0
        is_read = "DtoH" in e.name
        reads += is_read
        if end is None or e.time_range.end >= end:
            end, after_read = e.time_range.end, is_read
    kernel_ms = 1e-3 * sum(dev_us(e) for e in avg if kernel in e.key)
    top = [(e.key[:60], dev_us(e) * 1e-3, e.count) for e in
           sorted(avg, key=dev_us, reverse=True)[:5]]
    return dict(profiled_wall_ms=wall_ms, device_busy_ms=busy_ms or None,
                device_busy_share=busy_ms / wall_ms if busy_ms else None,
                kernel=kernel, kernel_device_ms=kernel_ms or None,
                host_reads=reads, idle_after_host_reads_ms=1e-3 * read_idle_us,
                device_idle_ms=1e-3 * idle_us, top=top,
                # index_add_'s calls, and whether its kernel (PyTorch's
                # indexFunc*Index) is among the top five device items
                index_add_calls=sum(e.count for e in avg
                                    if e.key == "aten::index_add_"),
                index_add_in_top5=any("indexFunc" in k for k, _, _ in top))


def compare(got, want):
    got, want = got.cpu().numpy(), want.cpu().numpy()
    close = np.isclose(got, want, rtol=RTOL, atol=ATOL).all(axis=-1)
    mean_rel = abs(float(got.mean()) - float(want.mean())) / max(
        abs(float(want.mean())), 1e-12)
    return dict(max_abs_err=float(np.abs(got - want).max()),
                frac_close=float(close.mean()), mean_rel=mean_rel,
                finite=bool(np.isfinite(got).all()),
                values_differ=int((got != want).sum()))


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
    thin = dict(cam_cornell, aperture=0.15, focus_dist=4.5)
    # (label, scene, compile kw, camera, (width, height), spp, start
    # sample); the ragged cases (RAGGED) leave part of a warp's batch and
    # of the last batches empty.
    cases = [
        ("cornell", cornell(T), {}, cam_cornell, (64, 64), 8, 0),
        ("demo38", T.demo_scene_38_spheres(), dict(capacity=64), cam_demo,
         (64, 64), 8, 0),
        ("cornell", cornell(T), {}, cam_cornell, (W, H), 4, 0),
        ("demo38", T.demo_scene_38_spheres(), dict(capacity=64), cam_demo,
         (W, H), 4, 0),
        ("cornell_thin_lens", cornell(T), {}, thin, (64, 64), 8, 0),
        ("cornell_ragged", cornell(T), {}, cam_cornell, RAGGED, 3, 7),
        ("demo38_ragged", T.demo_scene_38_spheres(), dict(capacity=64),
         cam_demo, RAGGED, 1, 0),
        ("cornell_thin_lens_ragged", cornell(T), {}, thin, RAGGED, 1, 5),
    ]
    max_abs_err = 0.0
    plain_ms_4spp = None
    for label, scene, ckw, camkw, (w, h), spp, start in cases:
        sd = scene.compile(device=dev, **ckw)
        cam = T.Camera.look_at(device=dev, **camkw)
        blob, meta, lsb, static = mk.pack_uniforms(sd, cam, start, SEED)
        kw = dict(width=w, height=h, spp=spp, max_bounces=DEPTH,
                  rr_depth=RR, use_nee=True, use_mis=True,
                  sky_mode=sd.sky_mode, dof=float(cam.aperture) > 0, **static)
        got, k_ms = cuda_ms(torch, lambda: mk.megakernel_fwd(
            blob, meta, lsb, **kw))
        want, p_ms = cuda_ms(torch, lambda: mk.render_tiles_plain(
            blob, meta, lsb, **kw))
        res = compare(got, want)
        emit(dict(phase="k1_vs_plain", case=label, width=w, height=h,
                  spp=spp, start_sample=start, k1_ms=k_ms, plain_ms=p_ms,
                  **res))
        check(res["finite"], f"{label}: K1 image not finite")
        check(res["values_differ"] == 0,
              f"{label}: {res['values_differ']} values differ from plain")
        check(float(want.mean()) > 0.01, f"{label}: plain image is black")
        max_abs_err = max(max_abs_err, res["max_abs_err"])
        if label == "cornell" and w == W:
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
    check(all(counts[k] == 0 for k in ("k3", "k4", "k5", "k6", "k7", "k9",
                                       "k10")),
          "K3, K4 or the wavefront ran for a small scene")
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
    k1_render_ms = prof["kernel_device_ms"] / launches_cornell \
        if prof["kernel_device_ms"] else None

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
    bound_unfused_ms = 1e3 * max(ops / FP32_ISSUE, n_bytes / HBM_RATE)
    segments = sum(stats["active"]) + sum(stats["hit"])
    paths = stats["paths"]
    # How busy the lanes keep: counted by K1's counting instantiation, and
    # estimated for one thread a pixel from the plain paths' lengths.
    lanes = mk.lane_counts("k1", blob, meta, lsb, **kw)
    lanes_old = mk.lanes_busy(stats.pop("lengths"))
    emit(dict(phase="timing", card=card, k1_ms=k1_ms, plain_ms=plain_ms,
              plain_ms_4spp=plain_ms_4spp,
              pixel_samples_per_s=paths / (k1_ms * 1e-3),
              segments_per_path=segments / paths,
              path_segments_per_path=sum(stats["active"]) / paths,
              jax_record_segments_per_path=9.07,
              k1_shadow_rays_per_path=sum(stats["shadow"]) / paths,
              active_per_bounce=stats["active"], hit_per_bounce=stats["hit"],
              fp32_ops=ops, bytes=n_bytes, bound_ms=bound_ms,
              bound_unfused_ms=bound_unfused_ms,
              ops_per_path=ops / paths, lanes_busy=lanes,
              lanes_busy_thread_a_pixel=lanes_old,
              launch=mk.launch_config(_build.load_library(), dev, **{
                  k: static[k] for k in ("n_prims", "n_light_slots")})))

    k1_bound_by = "operations" if ops / FP32_PEAK >= n_bytes / HBM_RATE \
        else "bytes"
    k2 = run_k2_phases(torch, T, mk, dev, card, cam_cornell,
                       (blob, stats, bound_ms))
    k3 = run_k3_phases(torch, T, mk, dev, card, cam_cornell, cam_demo)
    wf = run_wf_phases(torch, T, mk, dev, card, k3)
    gr = run_grad_phases(torch, T, mk, dev, card, k3)
    pr = run_prim_phases(torch, T, mk, dev, card, k3)
    ds = run_dist_phases(torch, T, mk, dev, card, k3, pr)
    fu = run_fused_phases(torch, T, mk, dev, card, k3)
    ap = run_app_phases(torch, T, mk, dev, card)
    paths = {"render": counts, "train": k2["launches"],
             "bvh": k3["launches"], "wavefront": wf["launches"],
             "grad_bvh": gr["launches"]["bvh"],
             "grad_wavefront": gr["launches"]["wavefront"],
             "prim": pr["launches"], "dist": ds["launches"],
             "fused": fu["launches"]["fused"],
             "fused_grad": fu["launches"]["fused_grad"],
             "mxu": fu["launches"]["mxu"], **ap["launches"]}

    def by_path(key):
        return {path: c[key] for path, c in paths.items()}

    k1_launches, k2_launches, k3_launches = (by_path(k) for k in
                                             ("k1", "k2", "k3"))

    # 16. Kernels line, then the result ---------------------------------------
    emit({"kernels": [
        dict(name="K1 megakernel_fwd", route="cuda",
             source="spt_tpu_torch/csrc/megakernel.cu",
             replaces="spt_tpu/kernels/megakernel.py:194::_kernel",
             launches=sum(k1_launches.values()),
             launches_by_path=k1_launches, max_abs_err=max_abs_err,
             ms=k1_ms, plain_ms=plain_ms,
             plain_size=f"{W}x{H} x {SPP} spp (Cornell, counting its work)",
             bound_ms=bound_ms, bound_unfused_ms=bound_unfused_ms,
             bound_by=k1_bound_by, library_ms=None,
             at_launch=dict(
                 render=dict(size=f"{W}x{H} x {SPP // launches_cornell} spp",
                             ms=k1_render_ms,
                             bound_ms=bound_ms / launches_cornell),
                 train=k2["at_launch"]["k1"]),
             checked_against_plain=True),
        dict(name="K2 megakernel_grad", route="cuda",
             source="spt_tpu_torch/csrc/megakernel_grad.cu",
             replaces="spt_tpu/kernels/megakernel_grad.py:121::_kernel_grad",
             launches=sum(k2_launches.values()),
             launches_by_path=k2_launches,
             max_abs_err=k2["max_abs_err"], ms=k2["ms"],
             plain_ms=k2["plain_ms"], plain_size=k2["plain_size"],
             bound_ms=k2["bound_ms"], bound_by=k2["bound_by"],
             library_ms=None, at_launch=dict(train=k2["at_launch"]["k2"]),
             checked_against_plain=True),
        dict(name="K3 megakernel_bvh_fwd", route="cuda",
             source="spt_tpu_torch/csrc/megakernel_bvh.cu",
             replaces="spt_tpu/kernels/megakernel_bvh.py:1137::_kernel_bvh",
             launches=sum(k3_launches.values()),
             launches_by_path=k3_launches,
             max_abs_err=k3["max_abs_err"], ms=k3["ms"],
             plain_ms=k3["plain_ms"], plain_size=k3["plain_size"],
             bound_ms=k3["bound_ms"],
             bound_unfused_ms=k3["bound_unfused_ms"], bound_by=k3["bound_by"],
             library_ms=None, checked_against_plain=True)]
        + [dict(name=f"K{i} wavefront {fn}", route="cuda",
                source="spt_tpu_torch/csrc/wavefront.cu",
                replaces=f"spt_tpu/kernels/wavefront.py:{line}::{tpu}",
                launches=sum(by_path(f"k{i}").values()),
                launches_by_path=by_path(f"k{i}"), **wf[f"k{i}"],
                library_ms=None, checked_against_plain=True)
           for i, fn, line, tpu in ((5, "raygen", 154, "_raygen_kernel"),
                                    (6, "isect", 490, "_isect_kernel"),
                                    (7, "shade", 582, "_shade_kernel"))]
        + [dict(name="K6l wavefront isect, lists (on no render path)",
                route="cuda", source="spt_tpu_torch/csrc/wavefront.cu",
                replaces="spt_tpu/kernels/wavefront.py:490::_isect_kernel "
                         "(the list form)",
                launches=sum(by_path("k6l").values()),
                launches_by_path=by_path("k6l"), **wf["k6l"],
                library_ms=None, checked_against_plain=True)]
        + [dict(name=name, route="cuda", source=f"spt_tpu_torch/csrc/{src}",
                replaces=replaces, launches=sum(by_path(key).values()),
                launches_by_path=by_path(key), **gr[key], library_ms=None,
                checked_against_plain=True)
           for key, name, src, replaces in (
               ("k4", "K4 megakernel_bvh_grad", "megakernel_bvh_grad.cu",
                "spt_tpu/kernels/megakernel_bvh_grad.py:108::"
                "_kernel_bvh_grad"),
               ("k9", "K9 wavefront shade_fwd", "wavefront.cu",
                "spt_tpu/kernels/wavefront_grad.py:264::_shade_fwd_kernel"),
               ("k10", "K10 wavefront bounce_bwd", "wavefront.cu",
                "spt_tpu/kernels/wavefront_grad.py:171::"
                "_bounce_bwd_kernel"))]
        + [dict(name=name, route="cuda", source="spt_tpu_torch/csrc/"
                "wavefront.cu", replaces=replaces,
                launches=sum(by_path(key).values()),
                launches_by_path=by_path(key), **pr[key], library_ms=None,
                checked_against_plain=True)
           for key, name, replaces in (
               ("k8", "K8 wavefront shadow verdicts, walking a prim "
                "shard's tree",
                "spt_tpu/kernels/wavefront.py:556::_anyhit_kernel "
                "(spt_tpu/parallel/wavefront_prim.py:195)"),
               ("k8l", "K8l wavefront anyhit, lists (on no render path)",
                "spt_tpu/kernels/wavefront.py:556::_anyhit_kernel "
                "(the list form)"),
               ("k7b", "K7b wavefront shade, blocked_in_res",
                "spt_tpu/kernels/wavefront.py:582::_shade_kernel "
                "(blocked_in_res=True; spt_tpu/parallel/wavefront_prim.py"
                ":214)"))]
        + [dict(name=name, route="cuda", source="spt_tpu_torch/csrc/"
                "wavefront.cu", replaces=replaces,
                launches=sum(by_path(key).values()),
                launches_by_path=by_path(key), **fu[key], library_ms=None,
                checked_against_plain=True)
           for key, name, replaces in (
               ("k6m", "K6m wavefront isect, matmul form",
                "spt_tpu/kernels/wavefront.py:524::_isect_kernel_mxu"),
               ("k7m", "K7m wavefront shade, matmul form: the bounce on "
                "its verdicts (K7b's kernel)",
                "spt_tpu/kernels/wavefront.py:668::_shade_kernel_mxu"),
               ("k7mv", "K7m wavefront shade, matmul form: the verdict pass",
                "spt_tpu/kernels/wavefront.py:668::_shade_kernel_mxu "
                "(its shadow sweep)"),
               ("k11", "K11 wavefront fused bounce",
                "spt_tpu/kernels/wavefront.py:194::_bounce_kernel"),
               ("k11g", "K11g wavefront fused bounce, recording",
                "spt_tpu/kernels/wavefront_grad.py:86::"
                "_bounce_fwd_kernel"))]})
    emit(dict(phase="done", seconds=time.perf_counter() - t_all))
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


def run_k2_phases(torch, T, mk, dev, card, cam_cornell, k1_work) -> dict:
    """K2 against its plain version, the training main path, and K2's
    timing.  ``k1_work`` is the headline Cornell blob, the plain version's
    work counts of its samples 0..255 and K1's bound for them.  Returns
    the numbers the kernels line needs."""
    from spt_tpu_torch.diff import cuda_diff, gradients as G
    from spt_tpu_torch.kernels import _build, megakernel_grad as mg

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
             ("capacity_128", k2_capacity_scene(T), {}, K2_CAPACITY_CAM, 64,
              {}),
             ("enclosure", enclosure_scene(T), {}, ENCLOSURE_CAM, 64, {}),
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
        if label in ("demo38", "capacity_128"):
            n_sph = 12 * static["n_prims"]
            check(float(g_p[n_sph:].abs().sum()) > 0, f"{label}: no sky grad")
        if label == "capacity_128":
            check(static["n_prims"] == mk.MAX_PRIMS
                  and static["n_light_slots"] >= 4,
                  f"capacity_128: {static} is not at K2's capacity")
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
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
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
    train_peak = torch.cuda.max_memory_allocated()
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
              peak_bytes=train_peak, launches=counts, k1_outside_steps=1,
              profiled_wall_per_step_ms=prof["profiled_wall_ms"] / TRAIN_STEPS,
              **prof))
    check(all(np.isfinite(losses)), "training loss not finite")
    check(losses[-1] < losses[0], "training did not lower the loss")
    check(err1 < err0, "training did not lower the albedo error")
    check(counts["k2"] == TRAIN_STEPS, f"K2 launches {counts['k2']}")
    check(counts["k1"] == TRAIN_STEPS + 1, f"K1 launches {counts['k1']}")
    check(counts["plain"] == 0, "the plain version ran on the training path")
    check(all(counts[k] == 0 for k in ("k3", "k4", "k5", "k6", "k7", "k9",
                                       "k10")),
          "K3, K4 or the wavefront ran on the training path")

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
    blob_256, stats_256, _ = k1_work
    check(torch.equal(blob, blob_256), "K1 and K2 timings differ in scene")
    scale = K2_SPP // SPP
    stats = {k: (v * scale if k == "paths" else [a * scale for a in v])
             for k, v in stats_256.items()}
    ops = mg.k2_op_count(stats, static["n_prims"])
    n_bytes = 4 * (blob.numel() + meta.numel() + lsb.numel()
                   + 2 * W * H * 3 + 12 * static["n_prims"] + 6)
    bound_ms = 1e3 * max(ops / FP32_PEAK, n_bytes / HBM_RATE)
    paths = stats["paths"]
    # Ray segments: the forward's path segments and NEE shadow rays (the
    # replay traces no ray: it rebuilds each hit from the recorded sphere).
    rays = sum(stats["active"]) + sum(stats["shadow"])
    emit(dict(phase="k2_timing", card=card, size=W, spp=K2_SPP, k2_ms=k2_ms,
              k1_ms_same_spp=k1_ms, k2_over_k1=k2_ms / k1_ms,
              pixel_samples_per_s=paths / (k2_ms * 1e-3),
              ray_segments_per_s=rays / (k2_ms * 1e-3),
              ray_segments_per_path=rays / paths, fp32_ops=ops,
              bytes=n_bytes, bound_ms=bound_ms, bound_share=bound_ms / k2_ms,
              ops_per_path=ops / paths,
              lit_per_path=sum(stats["lit"]) / paths,
              ptxas=ptxas_of(_build.BUILD_INFO, "megakernel_grad",
                             "megakernel_grad_kernel"),
              blocks_per_sm=mg.blocks_per_sm(static["n_prims"],
                                             static["n_light_slots"]),
              train_wall_per_step_ms=1e3 * sum(step_s) / TRAIN_STEPS,
              train_device_busy_share=prof["device_busy_share"],
              train_peak_bytes=train_peak,
              plain_ms=plain_ms, plain_size=f"{W}x{H} x 4 spp (Cornell)"))
    # The training path's own launches (16 spp), from its profile: K2's
    # device time a launch, and K1's, beside their bounds at that size.
    k1_train = [ms / n for name, ms, n in prof["top"]
                if "megakernel_fwd_kernel" in name]
    at_launch = dict(
        k2=dict(size=f"{W}x{H} x {TRAIN_SPP} spp",
                ms=(prof["kernel_device_ms"] / counts["k2"]
                    if prof["kernel_device_ms"] else None),
                bound_ms=bound_ms * TRAIN_SPP / K2_SPP),
        k1=dict(size=f"{W}x{H} x {TRAIN_SPP} spp",
                ms=k1_train[0] if k1_train else None,
                bound_ms=k1_work[2] * TRAIN_SPP / SPP))
    return dict(launches=counts, max_abs_err=max_abs_err, ms=k2_ms,
                plain_ms=plain_ms, plain_size=f"{W}x{H} x 4 spp",
                bound_ms=bound_ms, at_launch=at_launch,
                bound_by="operations" if ops / FP32_PEAK >= n_bytes / HBM_RATE
                else "bytes")


def k3_inputs(torch, mb, sd, cam, seed, block=None, start=0):
    """K3's packed inputs for a compiled scene and camera (samples from
    ``start``), its keywords and the packing's static dict."""
    block = block or mb.BLOCK
    t, st = mb.packed(sd, cam, block)
    meta = torch.tensor([start, seed, st["n_light_slots"]], dtype=torch.int32,
                        device=sd.device)
    args = (t["blob"], meta, t["lsb"], t["nodef"], t["nodei"], t["prims"],
            t["mtypes"])
    return args, dict(block=block, n_mats=st["n_mats"],
                      n_light_slots=st["n_light_slots"]), st


def run_k3_phases(torch, T, mk, dev, card, cam_cornell, cam_demo) -> dict:
    """K3 against K1 and against its plain version, the large-scene main
    path, and K3's timing.  Returns the numbers the kernels line needs."""
    from spt_tpu_torch.kernels import _build, megakernel_bvh as mb

    def check_equal(res, label):
        check(res["finite"], f"{label}: K3 image not finite")
        check(res["values_differ"] == 0,
              f"{label}: {res['values_differ']} values differ")

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
        check_equal(res, f"{label} K3 vs K1")
        check(float(want.mean()) > 0.01, f"{label}: K1 image is black")
        max_abs_err = max(max_abs_err, res["max_abs_err"])

    # 13. K3 against its plain version, both on the card -------------------
    cam10 = T.Camera.look_at(device=dev, **CAM_10K)
    sd10 = scene_10k(T).compile(device=dev)
    cam200 = T.Camera.look_at((0, 2.0, -4.0), (0, 1.0, 14.0), fov_degrees=60,
                              aperture=0.3, focus_dist=14.0, device=dev)
    pin200 = T.Camera.look_at((0, 2.0, -4.0), (0, 1.0, 14.0), fov_degrees=60,
                              device=dev)
    sd200 = scene_200(T).compile(device=dev)
    sdp = padding_scene(T).compile(device=dev)
    cam_pad = T.Camera.look_at(device=dev, **PAD_CAM)
    plain_small = {}
    # (label, scene, camera, width, height, spp, seed, start sample); the
    # padding scene's rays win leaf padding slots (K1's invalid row).
    for label, sd, cam, w, h, spp, seed, start in [
            ("config5", sd10, cam10, 240, 136, 2, BIG_SEED, 0),
            ("scene200_thin_lens", sd200, cam200, 64, 64, 8, SEED, 0),
            ("scene200_ragged", sd200, pin200, *RAGGED, 3, SEED, 7),
            ("scene200_thin_lens_ragged", sd200, cam200, *RAGGED, 1, SEED,
             5),
            ("padding", sdp, cam_pad, 240, 136, 2, SEED, 0),
            ("padding_ragged", sdp, cam_pad, *RAGGED, 3, SEED, 3)]:
        args, k3kw, st = k3_inputs(torch, mb, sd, cam, seed, start=start)
        kw = dict(width=w, height=h, spp=spp, max_bounces=DEPTH, rr_depth=RR,
                  use_nee=True, use_mis=True, sky_mode=sd.sky_mode,
                  dof=float(cam.aperture) > 0)
        got, k_ms = cuda_ms(torch, lambda: mb.megakernel_bvh_fwd(
            *args, **kw, **k3kw))
        want, p_ms = cuda_ms(torch, lambda: mb.render_tiles_bvh_plain(
            *args, **kw, **k3kw))
        res = compare(got, want)
        emit(dict(phase="k3_vs_plain", case=label, width=w, height=h,
                  spp=spp, start_sample=start, k3_ms=k_ms, plain_ms=p_ms,
                  n_nodes=st["n_nodes"], n_blocks=st["n_blocks"],
                  builder=st["builder"],
                  pixels_differ=int((got != want).any(-1).sum()), **res))
        check_equal(res, f"{label} K3 vs plain")
        check(float(want.mean()) > 0.01, f"{label}: plain image is black")
        max_abs_err = max(max_abs_err, res["max_abs_err"])
        plain_small[label] = p_ms

    # 14. Main path: the facade at 1920x1080 on config 5 cut to the largest
    # capacity the facade gives K3 (2,000 spheres, capacity 2048), counted
    mb._PACK_CACHE.clear()           # the facade packs its scene afresh
    mk.reset_launch_counts()
    t0 = time.perf_counter()
    scene = scene_10k(T, n=K3_MAIN_SPHERES)
    scene_s = time.perf_counter() - t0
    tracer = big_tracer(T, dev, scene)
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
    check(all(counts[k] == 0 for k in ("k4", "k5", "k6", "k7", "k9",
                                       "k10")),
          "K4 or the wavefront ran for a scene K3 takes")
    check(counts["plain"] == 0, "the plain version ran on the large path")
    check(tracer.frame_count == BIG_SPP, "frame count")
    check(tuple(img.shape) == (BIG_H, BIG_W, 3), f"config5: shape {img.shape}")
    check(bool(torch.isfinite(img).all()), "config5: image not finite")
    check(float(img.mean()) > 0.01, "config5: image is black")

    def big_again():
        again = big_tracer(T, dev, scene)
        again.render_to_completion()
        again.get_render_result()

    prof = profiled(torch, big_again, "megakernel_bvh_kernel")
    emit(dict(phase="bvh_main_path_profile", unprofiled_wall_ms=1e3 * wall_s,
              packing_cached=True, **prof))

    # 15. K3 at the full size: one 4-spp launch on config 5 ---------------
    sd = sd10
    kw = dict(width=BIG_W, height=BIG_H, spp=BIG_SPP, max_bounces=DEPTH,
              rr_depth=RR, use_nee=True, use_mis=True, sky_mode=sd.sky_mode,
              dof=False)
    args, k3kw, st = k3_inputs(torch, mb, sd, cam10, BIG_SEED)
    mb.megakernel_bvh_fwd(*args, **kw, **k3kw)          # warm-up
    k3_ms = min(cuda_ms(torch, lambda: mb.megakernel_bvh_fwd(
        *args, **kw, **k3kw))[1] for _ in range(3))
    # The plain version's run of the same launch (8.3M paths), timed, in
    # inference mode, with its counts: K3's image must equal it at the
    # main path's full size and sample count (the one-thread-a-pixel K3
    # equalled it at 1 spp and parted at 4).
    stats = {}
    with torch.inference_mode():
        want, plain_ms = cuda_ms(torch, lambda: mb.render_tiles_bvh_plain(
            *args, **kw, **k3kw, stats=stats))
    got = mb.megakernel_bvh_fwd(*args, **kw, **k3kw)
    torch.cuda.synchronize()
    res = compare(got, want)
    emit(dict(phase="k3_vs_plain", case="config5_full", width=BIG_W,
              height=BIG_H, spp=BIG_SPP, plain_ms=plain_ms,
              n_nodes=st["n_nodes"], n_blocks=st["n_blocks"],
              builder=st["builder"],
              pixels_differ=int((got != want).any(-1).sum()), **res))
    check_equal(res, "config5_full K3 vs plain")
    check(float(want.mean()) > 0.01, "config5_full: plain image is black")
    max_abs_err = max(max_abs_err, res["max_abs_err"])
    del got, want
    lanes_old = mk.lanes_busy(stats.pop("lengths"), (8, 4))
    lanes = mk.lane_counts("k3", *args, **kw, **k3kw)
    ops = mb.k3_op_count(stats)
    n_bytes = 4 * (sum(a.numel() for a in args) + BIG_W * BIG_H * 3)
    bound_ms = 1e3 * max(ops / FP32_PEAK, n_bytes / HBM_RATE)
    bound_unfused_ms = 1e3 * max(ops / FP32_ISSUE, n_bytes / HBM_RATE)
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
              bound_unfused_ms=bound_unfused_ms,
              ops_per_path=ops / paths, plain_ms=plain_ms,
              plain_ms_small=plain_small, n_nodes=st["n_nodes"],
              n_blocks=st["n_blocks"], other_blocks=block_ms,
              lanes_busy=lanes, lanes_busy_thread_a_pixel=lanes_old,
              launch=mb.launch_config(
                  _build.load_library("megakernel_bvh"), dev,
                  n_mats=k3kw["n_mats"],
                  n_light_slots=k3kw["n_light_slots"])))
    return dict(launches=counts, max_abs_err=max_abs_err, ms=k3_ms,
                plain_ms=plain_ms, sd10=sd10, cam10=cam10,
                plain_size=f"{BIG_W}x{BIG_H} x {BIG_SPP} spp (config 5, "
                           "counting its work)",
                bound_ms=bound_ms, bound_unfused_ms=bound_unfused_ms,
                bound_by="operations" if ops / FP32_PEAK >= n_bytes / HBM_RATE
                else "bytes")


# The environment map of the wavefront's main path: tests/test_wavefront.py's
# smooth gradient at 512x1024, made here (no file to read).
ENV_H, ENV_W = 512, 1024
# The crossover scenes: config 5 at fewer spheres, K3 against the wavefront.
CROSSOVER_SPHERES = (2_500, 5_000)


def env_gradient(he=ENV_H, we=ENV_W):
    """A smooth anisotropic (he, we, 3) environment map."""
    v = np.linspace(0.0, 1.0, he, dtype=np.float32)[:, None]
    u = np.linspace(0.0, 1.0, we, dtype=np.float32)[None, :]
    r = 0.2 + 0.8 * v * np.ones_like(u)
    g = 0.3 + 0.5 * np.sin(2 * np.pi * u) ** 2 * np.ones_like(v)
    b = 0.6 + 0.4 * u * np.ones_like(v)
    return np.stack([r, g, b], axis=-1)


def wf_inputs(torch, wf, mb, sd, cam, seed):
    """The wavefront's packed tensors, static dict and meta (samples from
    0) for a compiled scene and camera."""
    t, st = mb.packed(sd, cam, wf.BLOCK)
    meta = torch.tensor([0, seed, st["n_light_slots"]], dtype=torch.int32,
                        device=sd.device)
    return t, st, meta


def wf_lists(torch, wf, t, stc, st, ids, n, k, seed):
    """Bounce ``k``'s inputs of the list route over lanes [0, n) of a
    sorted stream: the nearest-hit lists (the precull), K6's list-mode
    residual and the shadow lists (the prim-sharded render's, K8's and
    K7b's inputs; the split path walks the tree instead).  Also K6's tree
    mode's residual (``res_t``) and the tree (``tree``)."""
    block, prims = stc["block"], t["prims"]
    lob, hib = wf._leaf_block_bounds(prims.reshape(-1, 5, block))
    cand, ctn = wf.precull_tiles(
        tuple(st[c, :n] for c in range(3)),
        tuple(st[c, :n] for c in range(3, 6)), st[wf.C_ALIVE, :n], None,
        lob, hib)
    res = wf.isect(prims, cand, ctn, st, n, block=block)
    tree = (t["nodef"], t["nodei"])
    res_t = wf.isect(prims, None, None, st, n, block=block, tree=tree)
    nls = stc["n_light_slots"]
    so3, sd3, stmax, sneed = wf.shadow_rays(
        st[:, :n], ids[:, :n], res, t["blob"], t["lsb"], nls, k=k,
        seed=seed, n_mats=stc["n_mats"], mtypes=stc["mtypes"],
        n_light_slots=nls)
    scand, sctn = wf.precull_tiles(so3, sd3, sneed, stmax, lob, hib)
    return dict(cand=cand, ctn=ctn, res=res, scand=scand, sctn=sctn,
                res_t=res_t, tree=tree)


def wf_bounce(torch, wf, t, stc, meta, width, height, k, seed):
    """The inputs of one wavefront bounce's kernels, 2 spp of a scene after
    raygen (K5) and a sort: the stream and its alive prefix ``n`` (lanes)
    and ``wf_lists``' residuals and lists.  Returns a dict."""
    st, ids = wf.raygen(t["blob"], meta, width=width, height=height,
                        chunk_spp=2, dof=False)
    buf = wf._stream_buffer(st, ids)
    n = wf._sort_rays(buf, buf.shape[1], *wf._scene_sort_bounds(
        t["nodef"])) * wf.TILE
    return dict(st=st, ids=ids, buf=buf, n=n,
                **wf_lists(torch, wf, t, stc, st, ids, n, k, seed))


def wf_advance(torch, wf, t, stc, meta, b, k, seed, sky_mode):
    """Shade bounce ``k`` of ``wf_bounce``'s (or this function's) inputs
    ``b`` in place with K7 on K6's tree-mode winner, its shadow rays
    walking the tree, as ``render_wavefront`` does, and return the inputs
    of bounce k + 1: a sort and ``wf_lists``."""
    st, ids, buf, n = b["st"], b["ids"], b["buf"], b["n"]
    wf.shade(t["blob"], meta, t["lsb"], t["prims"], t["mtypes"], None, None,
             st, ids, b["res_t"], n, k=k, block=stc["block"],
             n_mats=stc["n_mats"], n_light_slots=stc["n_light_slots"],
             rr_depth=RR, use_nee=True, use_mis=True, sky_mode=sky_mode,
             tree=b["tree"])
    n = wf._sort_rays(buf, buf.shape[1], *wf._scene_sort_bounds(
        t["nodef"])) * wf.TILE
    return dict(st=st, ids=ids, buf=buf, n=n,
                **wf_lists(torch, wf, t, stc, st, ids, n, k + 1, seed))


def route_differ(torch, wf, st, res_t, res_l):
    """Lanes where K6's tree mode and its list mode part, by cause: an
    exact tie (both winners at the same rebuilt t) or a padding winner on
    either side; ``other`` counts the rest (none may be)."""
    differ = (res_t.view(torch.int32) != res_l.view(torch.int32)).any(0)
    pad = ((res_t[4] < 0) & (res_t[5] >= 0)) | ((res_l[4] < 0)
                                                 & (res_l[5] >= 0))
    tie = (wf.winner_t(st, res_t) == wf.winner_t(st, res_l)) & ~pad
    return dict(lanes=int(differ.sum()), ties=int((differ & tie).sum()),
                padding=int((differ & pad).sum()),
                other=int((differ & ~tie & ~pad).sum()))


def cull_differ(torch, wf, st, res_u, res_c, boxes):
    """Lanes where a sweep culled by the leaf ``boxes`` (residual
    ``res_c``) parts from the unculled one (``res_u``) over the same
    lists, by cause: an exact tie (both winners at the same rebuilt t), a
    padding winner on either side, or a box edge (the unculled winner's
    hit lies outside its block's box by float error: the box test at that
    t fails); ``other`` counts the rest (none may be).  ``st`` (17, n)."""
    differ = (res_u.view(torch.int32) != res_c.view(torch.int32)).any(0)
    pad = ((res_u[4] < 0) & (res_u[5] >= 0)) | ((res_c[4] < 0)
                                                 & (res_c[5] >= 0))
    t_u = wf.winner_t(st, res_u)
    tie = (t_u == wf.winner_t(st, res_c)) & ~pad
    lanes = torch.arange(st.shape[1], device=st.device)
    inside = wf._box_cull(boxes, tuple(st[c] for c in range(3)),
                          tuple(st[c] for c in range(3, 6)))(
        lanes, res_u[5].long().clamp_min(0),
        torch.nextafter(t_u, torch.full_like(t_u, wf.BIG)))
    edge = (res_u[5] >= 0) & ~inside & ~tie & ~pad
    return dict(lanes=int(differ.sum()), ties=int((differ & tie).sum()),
                padding=int((differ & pad).sum()),
                box_edge=int((differ & edge).sum()),
                other=int((differ & ~tie & ~pad & ~edge).sum()))


def shadow_sray(torch, wf, t, stc, b, k, seed):
    """A bounce's shadow rays as K8 takes them: (8, n), pox poy poz ldx
    ldy ldz tmax need."""
    n, nls = b["n"], stc["n_light_slots"]
    so3, sd3, stmax, sneed = wf.shadow_rays(
        b["st"][:, :n], b["ids"][:, :n], b["res"], t["blob"], t["lsb"], nls,
        k=k, seed=seed, n_mats=stc["n_mats"], mtypes=stc["mtypes"],
        n_light_slots=nls)
    return torch.stack([*so3, *sd3, stmax, sneed])


def sort_rays_unstable(torch, wf):
    """``wavefront._sort_rays`` with ``torch.sort(stable=False)``: the
    coherence sort as the wavefront ran it before every path sorted
    stably.  Equal keys may land in any order."""
    def sort(buf, n_lanes, lo, ext):
        part = buf[:, :n_lanes]
        key = wf._coherence_key(part, lo, ext)
        n_alive = int((key < wf._dead_key(wf.Q_BITS)).sum())
        order = torch.sort(key, stable=False).indices
        part.copy_(part.index_select(1, order))
        return -(-n_alive // wf.TILE)
    return sort


def sort_stability(torch, wf, mb, sd, cam, kw, reps=5):
    """Whether the coherence sort's stability costs anything at config 5:
    the key of a 1080p x 2 spp stream before bounce 1 sorted by
    ``torch.sort`` with stable=False and stable=True (the permutations
    compared, each sort and its gather of the 19 rows timed by CUDA events,
    ``reps`` alternating times), then whole renders (4 spp) with the stable
    and the unstable sort alternating, their images and stage times."""
    t, stc, meta = wf_inputs(torch, wf, mb, sd, cam, BIG_SEED)
    b = wf_bounce(torch, wf, t, stc, meta, BIG_W, BIG_H, 0, BIG_SEED)
    wf.shade(t["blob"], meta, t["lsb"], t["prims"], t["mtypes"], None, None,
             b["st"], b["ids"], b["res_t"], b["n"], k=0, block=stc["block"],
             n_mats=stc["n_mats"], n_light_slots=stc["n_light_slots"],
             rr_depth=RR, use_nee=True, use_mis=True, sky_mode=sd.sky_mode,
             tree=b["tree"])
    buf = b["buf"]
    key = wf._coherence_key(buf, *wf._scene_sort_bounds(t["nodef"]))
    orders, ms = {}, {False: [], True: []}
    for _ in range(reps):
        for stable in (False, True):
            def go():
                order = torch.sort(key, stable=stable).indices
                return order, buf.index_select(1, order)
            (order, _), t_ms = cuda_ms(torch, go)
            orders[stable] = order
            ms[stable].append(t_ms)
    sort_out = dict(lanes=key.numel(),
                    distinct_keys=int(torch.unique(key).numel()),
                    permutations_equal=bool(torch.equal(orders[False],
                                                        orders[True])),
                    sort_gather_ms_unstable=ms[False],
                    sort_gather_ms_stable=ms[True])
    del b, buf, key, orders
    stable_sort = wf._sort_rays
    renders = {"stable": [], "unstable": []}
    images = {}
    try:
        for label in ("stable", "unstable", "stable", "unstable"):
            wf._sort_rays = stable_sort if label == "stable" else \
                sort_rays_unstable(torch, wf)
            times = {}
            t0 = time.perf_counter()
            images[label] = wf._render(sd, cam, BIG_W, BIG_H, 0, BIG_SPP,
                                       times=times, **kw)
            renders[label].append(dict(
                wall_ms_synced=1e3 * (time.perf_counter() - t0),
                sort_ms=sum(times.get("sort", [])),
                k7_ms=sum(times["k7"]), k6_ms=sum(times["k6"])))
    finally:
        wf._sort_rays = stable_sort
    return dict(sort_out, renders=renders, images_pixels_differ=int(
        (images["stable"] != images["unstable"]).any(-1).sum()))


def reset_glue(wf):
    """Zero the counts of the list-building glue's calls."""
    wf.GLUE_CALLS.update(dict.fromkeys(wf.GLUE_CALLS, 0))


def bound(ops, n_bytes):
    """(bound_ms, bound_by) of fp32 operations and bytes on one H100."""
    t_ops, t_bytes = ops / FP32_PEAK, n_bytes / HBM_RATE
    return 1e3 * max(t_ops, t_bytes), "operations" if t_ops >= t_bytes \
        else "bytes"


def walk_case(torch, wf, t, stc, meta, b, k, label, skies, reps):
    """K6's tree mode and K7's shadow walk on one bounce ``b``
    (``wf_bounce``'s or ``wf_advance``'s) against their plain walks, bit
    for bit, and against the list route (``route_differ``; K7 over the
    shadow lists on K6's list-mode winner), K7 under each sky of
    ``skies``.  Returns the times and the plain walks' counts (K7's of
    the first sky)."""
    block, prims, n, st, tree = (stc["block"], t["prims"], b["n"], b["st"],
                                 b["tree"])
    k6_ms = min(cuda_ms(torch, lambda: wf.isect(
        prims, None, None, st, n, block=block, tree=tree))[1]
        for _ in range(reps))
    res_t = b["res_t"]
    k6_stats = {}
    with torch.inference_mode():
        res_p, k6_plain_ms = cuda_ms(torch, lambda: wf.isect_plain(
            prims, None, None, st, n, block=block, stats=k6_stats, tree=tree))
    differ = bits_differ(torch, res_t, res_p)
    route = route_differ(torch, wf, st[:, :n], res_t, b["res"])
    padding = int(((res_t[4] < 0) & (res_t[5] >= 0)).sum())
    alive = max(k6_stats["alive"], 1)
    emit(dict(phase="k6_vs_plain", case=label, mode="tree", lanes=n,
              lanes_differ=differ, hits=int((res_t[4] >= 0).sum()),
              padding_winners=padding, k6_ms=k6_ms, plain_ms=k6_plain_ms,
              nodes_per_lane=k6_stats["nodes"] / alive,
              spheres_per_lane=k6_stats["spheres"] / alive,
              differ_from_lists=route))
    check(differ == 0, f"{label}: K6's tree mode differs from its plain "
                       f"walk on {differ} lanes")
    check(route["other"] == 0,
          f"{label}: K6's tree mode and list mode part on {route['other']} "
          "lanes without a tie or a padding winner")
    check(int((res_t[4] >= 0).sum()) > 0, f"{label}: K6 found no hit")
    del res_p
    base = b["buf"].clone()
    args7 = (t["blob"], meta, t["lsb"], prims, t["mtypes"])
    kw = dict(k=k, block=block, n_mats=stc["n_mats"],
              n_light_slots=stc["n_light_slots"], rr_depth=RR, use_nee=True,
              use_mis=True)
    first = None
    for sky in skies:
        kw7 = dict(kw, sky_mode=sky)
        got = base.clone()
        ms = []
        for _ in range(reps):
            got.copy_(base)
            ms.append(cuda_ms(torch, lambda: wf.shade(
                *args7, None, None, *stream_of(torch, wf, got), res_t, n,
                tree=tree, **kw7))[1])
        plain, lists = base.clone(), base.clone()
        stats = {}
        with torch.inference_mode():
            _, p_ms = cuda_ms(torch, lambda: wf.shade_plain(
                *args7, None, None, *stream_of(torch, wf, plain), res_t, n,
                stats=stats, tree=tree, **kw7))
        wf.shade(*args7, b["scand"], b["sctn"], *stream_of(torch, wf, lists),
                 b["res"], n, **kw7)
        a, c = got[:wf.N_CH, :n], plain[:wf.N_CH, :n]
        res = state_close(torch, wf, a, c)
        misses = int((a[wf.C_MISS] > 0.5).sum())
        row = dict(lanes=n, lanes_differ=bits_differ(torch, a, c),
                   lanes_differ_from_lists=bits_differ(
                       torch, a, lists[:wf.N_CH, :n]),
                   misses=misses,
                   alive_after=int((a[wf.C_ALIVE] > 0.5).sum()), k7_ms=ms,
                   plain_ms=p_ms, shadow_rays=stats["shadow"],
                   shadow_nodes_per_ray=stats["shadow_nodes"]
                   / max(stats["shadow"], 1),
                   shadow_spheres_per_ray=stats["shadow_spheres"]
                   / max(stats["shadow"], 1), **res)
        emit(dict(phase="k7_vs_plain", case=label, sky_mode=sky,
                  mode="walk", **row))
        check(row["lanes_differ"] == 0,
              f"{label}: K7's shadow walk differs from its plain walk on "
              f"{row['lanes_differ']} lanes")
        check(misses > 0 if sky == wf.SKY_ENVMAP else misses == 0,
              f"{label}: {misses} lanes flagged as missed")
        check(row["alive_after"] > 0, f"{label}: K7 left no ray alive")
        if first is None:
            first = dict(k7_ms=min(ms), k7_plain_ms=p_ms, k7_stats=stats,
                         k7_err=res["max_abs_err"])
        del got, plain, lists
    return dict(first, n=n, k6_ms=k6_ms, k6_plain_ms=k6_plain_ms,
                k6_stats=k6_stats, k6_route=route, k6_padding=padding)


def run_wf_phases(torch, T, mk, dev, card, k3) -> dict:
    """The sorted wavefront (K5-K7): each kernel against its plain version,
    the whole render against its plain version and against K3, the facade
    on config 5 with its gradient sky and with an environment map, and the
    timing.  Returns the launch counts of the facade runs and the kernels
    line's numbers."""
    from spt_tpu_torch.kernels import _build, megakernel_bvh as mb
    from spt_tpu_torch.kernels import wavefront as wf

    def check_close(res, label):
        check(res["finite"], f"{label}: not finite")
        check(res["frac_close"] >= MIN_CLOSE,
              f"{label}: {res['frac_close']:.5f} close")
        check(res["mean_rel"] <= MAX_MEAN_REL,
              f"{label}: means differ by {res['mean_rel']:.5f}")

    info = _build.BUILD_INFO["wavefront"]
    emit(dict(phase="wf_build", seconds=info["seconds"],
              cached=info["cached"], ptxas=info["ptxas"]))
    sd10, cam10 = k3["sd10"], k3["cam10"]
    out = {}

    # 17. K5 against its plain version, bit for bit -------------------------
    cam_lens = T.Camera.look_at(device=dev, aperture=0.5, focus_dist=50.0,
                                **CAM_10K)
    for label, cam, w, h in (("config5", cam10, BIG_W, BIG_H),
                             ("config5_thin_lens", cam_lens, 240, 136)):
        t, st, meta = wf_inputs(torch, wf, mb, sd10, cam, BIG_SEED)
        kw = dict(width=w, height=h, chunk_spp=2,
                  dof=float(cam.aperture) > 0)
        (st_k, ids_k), k_ms = cuda_ms(torch, lambda: wf.raygen(
            t["blob"], meta, **kw))
        (st_p, ids_p), p_ms = cuda_ms(torch, lambda: wf.raygen_plain(
            t["blob"], meta, **kw))
        a = wf._stream_buffer(st_k, ids_k).view(torch.int32)
        b = wf._stream_buffer(st_p, ids_p).view(torch.int32)
        differ = int((a != b).any(dim=0).sum())
        emit(dict(phase="k5_vs_plain", case=label, width=w, height=h, spp=2,
                  lanes=a.shape[1], lanes_differ=differ, k5_ms=k_ms,
                  plain_ms=p_ms))
        check(differ == 0, f"{label}: K5 differs on {differ} lanes")
        if label == "config5":
            lanes = a.shape[1]
            k5_ms = min(cuda_ms(torch, lambda: wf.raygen(
                t["blob"], meta, **kw))[1] for _ in range(3))
            out["k5"] = dict(ms=k5_ms, plain_ms=p_ms, max_abs_err=0.0,
                             plain_size=f"{w}x{h} x 2 spp (config 5)",
                             lanes=lanes)
            out["k5"]["bound_ms"], out["k5"]["bound_by"] = bound(
                0, 4 * (wf.N_CH + wf.N_IDS) * lanes + 4 * (15 + 3))
        del st_k, ids_k, st_p, ids_p, a, b

    # 18. Config-5 bounces 0 and 1 at full size (1920x1080 x 2 spp) and a
    # bounce of the padding scene: K6's tree mode and K7's shadow walk
    # against their plain walks, bit for bit (K7 with either sky), and
    # against the list route, the differing lanes counted; K6's list mode
    # (the prim shards') against its plain version, bit for bit ----------
    t, stc, meta = wf_inputs(torch, wf, mb, sd10, cam10, BIG_SEED)
    block, prims = stc["block"], t["prims"]
    b0 = wf_bounce(torch, wf, t, stc, meta, BIG_W, BIG_H, 0, BIG_SEED)
    st, n, cand, ctn, res_k = (b0[k] for k in ("st", "n", "cand", "ctn",
                                               "res"))
    k6l_ms = min(cuda_ms(torch, lambda: wf.isect(
        prims, cand, ctn, st, n, block=block))[1] for _ in range(3))
    k6l_stats = {}
    with torch.inference_mode():
        res_p, k6l_plain_ms = cuda_ms(torch, lambda: wf.isect_plain(
            prims, cand, ctn, st, n, block=block, stats=k6l_stats))
    differ = bits_differ(torch, res_k, res_p)
    n_cand = cand[:, 0, 0].double()
    emit(dict(phase="k6_vs_plain", case="config5_bounce0", mode="lists",
              lanes=n, lanes_differ=differ, hits=int((res_k[4] >= 0).sum()),
              padding_winners=int(((res_k[4] < 0) & (res_k[5] >= 0)).sum()),
              k6_ms=k6l_ms, plain_ms=k6l_plain_ms,
              candidates_per_tile=float(n_cand.mean()),
              blocks_swept_per_lane=k6l_stats["blocks"] / n,
              spheres_per_lane=k6l_stats["spheres"] / n))
    check(differ == 0, f"K6's list mode differs from its plain version on "
                       f"{differ} lanes")
    ops = wf.k6_op_count(k6l_stats)
    n_bytes = wf.k6_byte_count(k6l_stats, n, block)
    out["k6l"] = dict(ms=k6l_ms, plain_ms=k6l_plain_ms, max_abs_err=0.0,
                      plain_size=f"{n} rays (config 5, bounce 0, the "
                                 "lists, counting its work)",
                      fp32_ops=ops, bytes=n_bytes)
    out["k6l"]["bound_ms"], out["k6l"]["bound_by"] = bound(ops, n_bytes)
    del res_p, st, cand, ctn, res_k
    nums, b = {}, b0
    for k in (0, 1):
        if k:
            b = wf_advance(torch, wf, t, stc, meta, b, 0, BIG_SEED,
                           sd10.sky_mode)
        nums[k] = walk_case(torch, wf, t, stc, meta, b, k,
                            f"config5_bounce{k}",
                            (sd10.sky_mode, wf.SKY_ENVMAP), 3 if k == 0 else 1)
    del b, b0
    torch.cuda.empty_cache()
    sdpad = padding_scene(T).compile(device=dev)
    campad = T.Camera.look_at(device=dev, **PAD_CAM)
    tp, stp, metap = wf_inputs(torch, wf, mb, sdpad, campad, BIG_SEED)
    bp = wf_bounce(torch, wf, tp, stp, metap, 240, 136, 0, BIG_SEED)
    pad = walk_case(torch, wf, tp, stp, metap, bp, 0, "padding_bounce0",
                    (sdpad.sky_mode,), 1)
    check(pad["k6_route"]["padding"] > 0 or pad["k6_padding"] > 0,
          "padding: no lane won a padding slot")
    del bp
    tree_words = sum(t[k].numel() for k in ("nodef", "nodei", "prims"))
    uniform_bytes = 4 * (t["blob"].numel() + t["lsb"].numel() + meta.numel()
                         + stc["n_mats"])
    n0, s6, s7 = nums[0]["n"], nums[0]["k6_stats"], nums[0]["k7_stats"]
    k6_ops = wf.k6_op_count(s6)
    k6_bytes = wf.k6_byte_count(s6, n0, block, tree_words)
    out["k6"] = dict(ms=nums[0]["k6_ms"], plain_ms=nums[0]["k6_plain_ms"],
                     max_abs_err=0.0,
                     plain_size=f"{n0} rays (config 5, bounce 0, the walk, "
                                "counting its work)", fp32_ops=k6_ops,
                     bytes=k6_bytes)
    out["k6"]["bound_ms"], out["k6"]["bound_by"] = bound(k6_ops, k6_bytes)
    k7_ops = wf.k7_op_count(s7)
    k7_bytes = wf.k7_byte_count(s7, n0, block, tree_words) + uniform_bytes
    out["k7"] = dict(ms=nums[0]["k7_ms"], plain_ms=nums[0]["k7_plain_ms"],
                     max_abs_err=max(v["k7_err"] for v in (nums[0], nums[1],
                                                           pad)),
                     plain_size=f"{n0} rays (config 5, bounce 0, the shadow "
                                "walks, counting its work)", fp32_ops=k7_ops,
                     bytes=k7_bytes)
    out["k7"]["bound_ms"], out["k7"]["bound_by"] = bound(k7_ops, k7_bytes)
    emit(dict(phase="k6_k7_timing", card=card,
              k6_ms={k: v["k6_ms"] for k, v in nums.items()},
              k7_ms={k: v["k7_ms"] for k, v in nums.items()},
              k6_lists_ms=k6l_ms,
              k6=dict(ptxas_of(_build.BUILD_INFO, "wavefront",
                               "12isect_kernel"),
                      **{k: out["k6"][k] for k in ("fp32_ops", "bytes",
                                                   "bound_ms", "bound_by")}),
              k7=dict(ptxas_of(_build.BUILD_INFO, "wavefront",
                               "shade_kernelILb0ELb1E"),
                      **{k: out["k7"][k] for k in ("fp32_ops", "bytes",
                                                   "bound_ms", "bound_by")})))
    del nums, pad, tp
    torch.cuda.empty_cache()

    # 19. The whole wavefront against its plain version ---------------------
    cam200 = T.Camera.look_at((0, 2.0, -4.0), (0, 1.0, 14.0), fov_degrees=60,
                              aperture=0.3, focus_dist=14.0, device=dev)
    scene_env = scene_10k(T)
    scene_env.set_environment_map(env_gradient())
    for label, sd, cam, w, h, spp, seed in [
            ("config5", sd10, cam10, 240, 136, 2, BIG_SEED),
            ("config5_envmap", scene_env.compile(device=dev), cam10, 240,
             136, 2, BIG_SEED),
            ("scene200_thin_lens", scene_200(T).compile(device=dev), cam200,
             64, 64, 8, SEED)]:
        kw = dict(max_bounces=DEPTH, rr_depth=RR, seed=seed, sort_min_rays=0)
        got, k_ms = cuda_ms(torch, lambda: wf.render_wavefront(
            sd, cam, w, h, 0, spp, **kw))
        want, p_ms = cuda_ms(torch, lambda: wf._render(
            sd, cam, w, h, 0, spp, stages=wf.PLAIN, **kw))
        res = compare(got, want)
        emit(dict(phase="wf_vs_plain", case=label, width=w, height=h,
                  spp=spp, wavefront_ms=k_ms, plain_ms=p_ms,
                  pixels_differ=int((got != want).any(-1).sum()), **res))
        check_close(res, f"{label} wavefront vs plain")
        check(float(want.mean()) > 0.01, f"{label}: plain image is black")
        out["k7"]["max_abs_err"] = max(out["k7"]["max_abs_err"],
                                       res["max_abs_err"])

    # 20. The wavefront against K3 on config 5, 1920x1080 x 1 spp ----------
    kw = dict(max_bounces=DEPTH, rr_depth=RR, seed=BIG_SEED)
    got = wf.render_wavefront(sd10, cam10, BIG_W, BIG_H, 0, 1, **kw)
    args, k3kw, _ = k3_inputs(torch, mb, sd10, cam10, BIG_SEED)
    want = mb.megakernel_bvh_fwd(
        *args, width=BIG_W, height=BIG_H, spp=1, max_bounces=DEPTH,
        rr_depth=RR, use_nee=True, use_mis=True, sky_mode=sd10.sky_mode,
        dof=False, **k3kw)
    torch.cuda.synchronize()
    res = compare(got, want)
    emit(dict(phase="wf_vs_k3", case="config5_full", width=BIG_W,
              height=BIG_H, spp=1,
              pixels_differ=int((got != want).any(-1).sum()), **res))
    check_close(res, "wavefront vs K3")
    del got, want

    # 21. Main path: the facade on config 5, with its gradient sky and with
    # an environment map, 4 spp at 1920x1080, counted (the kernels, and the
    # list-building glue, which the split path does not call) -------------
    out["launches"] = {k: 0 for k in mk.LAUNCHES}
    walls = {}
    for label in ("config5", "config5_envmap"):
        mb._PACK_CACHE.clear()       # the facade packs its scene afresh
        mk.reset_launch_counts()
        reset_glue(wf)
        t0 = time.perf_counter()
        scene = scene_10k(T)
        if label == "config5_envmap":
            scene.set_environment_map(env_gradient())
        scene_s = time.perf_counter() - t0
        tracer = big_tracer(T, dev, scene)
        tracer.render_to_completion()
        img = tracer.get_render_result().image_f32
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        counts = dict(mk.LAUNCHES)
        glue = dict(wf.GLUE_CALLS)
        sd = tracer.scene_data
        pack = mb.packed(sd, cam10)[1]["seconds"]
        walls[label] = wall_s
        emit(dict(phase="wf_main_path", case=label, wall_s=wall_s,
                  scene_build_s=scene_s, compile_s=tracer.compile_seconds,
                  pack_s=pack["pack"], launches=counts, glue_calls=glue,
                  spp=tracer.frame_count, capacity=sd.capacity,
                  sky_mode=sd.sky_mode, mean=float(img.mean())))
        check(not any(glue.values()),
              f"{label}: the split path built lists: {glue}")
        check(all(counts[k] > 0 for k in ("k5", "k6", "k7")),
              f"{label}: K5, K6 or K7 was not launched")
        check(counts["k5"] == 2, f"{label}: {counts['k5']} raygen launches")
        check(all(counts[k] == 0 for k in ("k1", "k2", "k3", "k4", "k9",
                                           "k10", "k6l", "k7l")),
              f"{label}: K1-K4, K9, K10 or a list mode was launched")
        check(counts["plain"] == 0, f"{label}: a plain version ran")
        check(tracer.frame_count == BIG_SPP, f"{label}: frame count")
        check(tuple(img.shape) == (BIG_H, BIG_W, 3), f"{label}: shape")
        check(bool(torch.isfinite(img).all()), f"{label}: not finite")
        check(float(img.mean()) > 0.01, f"{label}: image is black")
        for k, v in counts.items():
            out["launches"][k] += v

    def wf_again():
        again = big_tracer(T, dev, scene)
        again.render_to_completion()
        again.get_render_result()

    prof = profiled(torch, wf_again, "shade_kernel")
    emit(dict(phase="wf_main_path_profile", case="config5_envmap",
              unprofiled_wall_ms=1e3 * walls["config5_envmap"],
              packing_cached=True, **prof))

    # 22. Timing: each stage of a config-5 render, and K3 against the
    # wavefront on the crossover scenes -----------------------------------
    sd_env = tracer.scene_data
    for label, sd in (("config5", sd10), ("config5_envmap", sd_env)):
        times = {}
        t0 = time.perf_counter()
        wf._render(sd, cam10, BIG_W, BIG_H, 0, BIG_SPP, times=times, **kw)
        wall_ms = 1e3 * (time.perf_counter() - t0)
        emit(dict(phase="wf_timing", case=label, card=card,
                  spp=BIG_SPP, wall_ms_synced=wall_ms,
                  stage_ms={k: sum(v) for k, v in times.items()},
                  per_launch_ms=times))
        check("precull" not in times and "shadow" not in times,
              f"{label}: a precull or shadow stage ran: {sorted(times)}")
    emit(dict(phase="wf_sort_stability", case="config5", card=card,
              **sort_stability(torch, wf, mb, sd10, cam10, kw)))
    crossover = {}
    for n_sph in CROSSOVER_SPHERES + (10_000,):
        sd = sd10 if n_sph == 10_000 else \
            scene_10k(T, n=n_sph).compile(device=dev)
        args, k3kw, st3 = k3_inputs(torch, mb, sd, cam10, BIG_SEED)
        k3kw.update(width=BIG_W, height=BIG_H, spp=BIG_SPP,
                    max_bounces=DEPTH, rr_depth=RR, use_nee=True,
                    use_mis=True, sky_mode=sd.sky_mode, dof=False)
        mb.megakernel_bvh_fwd(*args, **k3kw)
        k3_ms = cuda_ms(torch, lambda: mb.megakernel_bvh_fwd(
            *args, **k3kw))[1]
        t0 = time.perf_counter()
        wf.render_wavefront(sd, cam10, BIG_W, BIG_H, 0, BIG_SPP, **kw)
        torch.cuda.synchronize()
        crossover[n_sph] = dict(k3_ms=k3_ms, n_blocks=st3["n_blocks"],
                                wavefront_ms=1e3 * (time.perf_counter() - t0))
    emit(dict(phase="wf_crossover", card=card, size=f"{BIG_W}x{BIG_H}",
              spp=BIG_SPP, scenes=crossover))
    return out


def ptxas_of(build_info, lib, kernel):
    """Registers, stack frame and spill bytes of one kernel from its
    library's ``-Xptxas -v`` lines."""
    out, entry, props = {}, False, False
    for line in build_info[lib]["ptxas"]:
        if "Compiling entry function" in line:
            entry = props = kernel in line
        elif "Function properties for" in line:
            props = kernel in line
        elif props and "stack frame" in line:
            words = line.split()
            out.update(stack_bytes=int(words[0]),
                       spill_store_bytes=int(words[4]),
                       spill_load_bytes=int(words[8]))
        elif entry and "registers" in line:
            out["registers"] = int(line.split("Used")[1].split()[0])
    return out


def ct_image(torch, dev, w, h, seed=SEED):
    """A fixed random cotangent image (H, W, 3) on the card."""
    return torch.from_numpy(np.random.default_rng(seed).uniform(
        0.5, 1.5, (h, w, 3)).astype(np.float32)).to(dev)


def k10_vs_plain(torch, wg, t, stc, bargs, kw10, reps=1):
    """K10 on one bounce (``bargs``: the wrapper's positional inputs, the
    residual with its verdicts at 6, the lanes last), its d(prims) summed
    in the kernel, against the plain K10 and ``_grads_from_bwd``'s scatter:
    din by ``lanes_close``, d(prims) and dscal by ``tail_field_errors``,
    the flags' and the suffix's cotangents equal, and no gradient on a
    padding slot.  Checks each; returns (row, numbers)."""
    block, n, res8 = stc["block"], bargs[-1], bargs[6]
    gkw = dict(n_blocks=t["prims"].numel() // (5 * block), block=block)
    ms = []
    for _ in range(reps):
        (din, d_prims, dscal), m = cuda_ms(
            torch, lambda: wg.bounce_bwd(*bargs, **kw10, **gkw))
        ms.append(m)
    with torch.inference_mode():
        (din_p, dgeo_p, dscal_p), p_ms = cuda_ms(
            torch, lambda: wg.bounce_bwd_plain(*bargs, **kw10))
        (_, d_prims_p), scatter_ms = cuda_ms(
            torch, lambda: wg._grads_from_bwd(
                t["blob"], res8, dgeo_p, dscal_p, n_mats=kw10["n_mats"],
                n_light_slots=kw10["n_light_slots"], **gkw))
    lanes = lanes_close(din[:13, :n], din_p[:13, :n])
    errs, g_err = tail_field_errors({"d_prims": d_prims, "dscal": dscal},
                                    {"d_prims": d_prims_p, "dscal": dscal_p})
    flags_equal = bool(torch.equal(din[13:], din_p[13:])
                       and torch.equal(din[:, n:], din_p[:, n:]))
    pad = t["prims"].reshape(-1, 5, block)[:, 4, :] < 0
    pad_grad = float(d_prims[:, :4].abs().sum(1)[pad].sum()
                     + d_prims_p[:, :4].abs().sum(1)[pad].sum())
    row = dict(lanes=n, din_vs_plain=lanes, flags_and_suffix_equal=flags_equal,
               padding_slot_grad=pad_grad, d_prims=errs["d_prims"],
               dscal=errs["dscal"], grad_max_abs_err=g_err, k10_ms=ms,
               plain_ms=p_ms, plain_scatter_ms=scatter_ms)
    check(lanes["ok"], f"K10 din vs plain: {lanes}")
    check(flags_equal, "K10 flag or suffix cotangents differ")
    check(all(e["ok"] for e in errs.values()), f"K10 vs plain: {errs}")
    check(float(d_prims_p.abs().sum()) > 0, "plain K10: zero d(prims)")
    check(pad_grad == 0.0, "K10: a padding slot has a gradient")
    err = max(g_err, float((din[:13, :n] - din_p[:13, :n]).abs().max()))
    return row, dict(ms=min(ms), p_ms=p_ms + scatter_ms, err=err)


def run_grad_phases(torch, T, mk, dev, card, k3) -> dict:
    """The large-scene gradients: K4 against its plain version and against
    K3, K9 against K7 and its plain version and K10 against its plain
    version on a full config-5 bounce, the differentiable wavefront
    against its plain stages, both full-width gradient main paths (one
    backward and 3 InverseRenderer steps each), the kernels' timing and K4
    against the wavefront at 2,000 spheres.  Returns the launch counts of
    the main paths and the kernels line's numbers."""
    from spt_tpu_torch.diff import cuda_diff, gradients as G
    from spt_tpu_torch.kernels import _build, megakernel_bvh as mb
    from spt_tpu_torch.kernels import megakernel_bvh_grad as mbg
    from spt_tpu_torch.kernels import wavefront as wf
    from spt_tpu_torch.kernels import wavefront_grad as wg

    out = {}
    sd10, cam10 = k3["sd10"], k3["cam10"]
    sd2k = scene_10k(T, n=K3_MAIN_SPHERES).compile(device=dev)
    sdpad = padding_scene(T).compile(device=dev)
    campad = T.Camera.look_at(device=dev, **PAD_CAM)

    # 23. K4 against K3 (its image, every value) and its plain version
    # (its gradients): config 5 cut to 2,000 spheres at 240x136 x 1 spp and
    # at the main path's width (1920x1080 x 1 spp), the padding scene (rays
    # that win padding slots), and, as K1 and K3 are held, a ragged 100x37
    # image at 1 and 3 spp from start samples 3-7, with a thin lens and on
    # the padding scene ------------------------------------------------------
    sd200 = scene_200(T).compile(device=dev)
    cam200 = T.Camera.look_at((0, 2.0, -4.0), (0, 1.0, 14.0), fov_degrees=60,
                              aperture=0.3, focus_dist=14.0, device=dev)
    pin200 = T.Camera.look_at((0, 2.0, -4.0), (0, 1.0, 14.0), fov_degrees=60,
                              device=dev)
    k4_err = 0.0
    for label, sd, cam, w, h, spp, seed, start in (
            ("config5_2000", sd2k, cam10, 240, 136, 1, BIG_SEED, 0),
            ("config5_2000_1080p", sd2k, cam10, BIG_W, BIG_H, 1, BIG_SEED,
             0),
            ("padding", sdpad, campad, 240, 136, 2, BIG_SEED, 0),
            ("scene200_ragged", sd200, pin200, *RAGGED, 3, SEED, 7),
            ("scene200_thin_lens_ragged", sd200, cam200, *RAGGED, 1, SEED,
             5),
            ("padding_ragged", sdpad, campad, *RAGGED, 3, SEED, 3)):
        args, k3kw, st = k3_inputs(torch, mb, sd, cam, seed, start=start)
        kw = dict(width=w, height=h, spp=spp, max_bounces=DEPTH,
                  rr_depth=RR, use_nee=True, use_mis=True,
                  sky_mode=sd.sky_mode, dof=float(cam.aperture) > 0,
                  **k3kw)
        ct = mbg.swizzle_ct(ct_image(torch, dev, w, h), w, h)
        (img, gs, gg), k_ms = cuda_ms(torch, lambda: mbg.megakernel_bvh_grad(
            *args, ct, **kw))
        img3 = mb.megakernel_bvh_fwd(*args, **kw)
        wins = {}
        with torch.inference_mode():
            (_, p_gs, p_gg), p_ms = cuda_ms(
                torch, lambda: mbg.render_and_grad_bvh_plain(
                    *args, ct, **kw, stats=wins))
        res = compare(img, img3)
        errs, g_err = tail_field_errors(raw_fields(gs, gg, k3kw["n_mats"]),
                                        raw_fields(p_gs, p_gg,
                                                   k3kw["n_mats"]))
        # A padding slot (material id < 0) takes no geometry gradient.
        pad = (args[5].reshape(-1, 5, k3kw["block"])[:, 4, :] < 0)
        pad_grad = float(gg[:, :4].abs().sum(1)[pad].sum()
                         + p_gg[:, :4].abs().sum(1)[pad].sum())
        emit(dict(phase="k4_vs_plain", case=label, width=w, height=h,
                  spp=spp, start_sample=start, k4_ms=k_ms, plain_ms=p_ms,
                  n_blocks=st["n_blocks"], **wins,
                  image_pixels_differ_from_k3=int((img != img3).any(-1)
                                                  .sum()),
                  image_vs_k3=res, grad_max_abs_err=g_err,
                  padding_slot_grad=pad_grad, grad=errs))
        check(res["finite"] and res["values_differ"] == 0,
              f"{label}: K4 image vs K3: {res}")
        check(all(e["ok"] for e in errs.values()),
              f"{label}: K4 vs plain: {errs}")
        check(float(p_gg.abs().sum()) > 0 and float(p_gs.abs().sum()) > 0,
              f"{label}: plain K4: zero gradient")
        check(pad_grad == 0.0, f"{label}: a padding slot has a gradient")
        if label.startswith("padding"):
            check(wins["padding_winners"] > 0,
                  f"{label}: no ray won a padding slot")
        k4_err = max(k4_err, g_err, res["max_abs_err"])
        if label == "config5_2000_1080p":
            out["k4"] = dict(plain_ms=p_ms,
                             plain_size=f"{w}x{h} x 1 spp (config 5 cut to "
                                        f"{K3_MAIN_SPHERES} spheres)")
        del img, gs, gg, img3, p_gs, p_gg
        torch.cuda.empty_cache()
    out["k4"]["max_abs_err"] = k4_err

    # 24. K9 (its shadow rays walking the tree, on K6's tree-mode winner)
    # and K10 on full config-5 bounces 0 and 1 (gradient sky, env map), and
    # on a bounce of the padding scene (lanes whose winner is a padding
    # slot: K6 stores hmid -1 and a block; their slots get no gradient); K9's
    # verdicts against the list route's (K9 over the shadow lists on K6's
    # list-mode winner), the differing lanes counted ----------------------
    def k9_k10_case(label, t, stc, meta, b0, k, sky_mode, reps):
        n, res_k, tree = b0["n"], b0["res_t"], b0["tree"]
        base = b0["buf"].clone()
        args9 = (t["blob"], meta, t["lsb"], t["prims"], t["mtypes"])

        def fresh():
            b = base.clone()
            return b[:wf.N_CH], b[wf.N_CH:].view(torch.int32)

        kw9 = dict(k=k, block=stc["block"], n_mats=stc["n_mats"],
                   n_light_slots=stc["n_light_slots"], rr_depth=RR,
                   use_nee=True, use_mis=True, sky_mode=sky_mode)
        st_in, ids = fresh()
        ms = []
        for _ in range(reps):
            (out9, blocked), m = cuda_ms(torch, lambda: wg.shade_fwd(
                *args9, None, None, st_in, ids, res_k, n, tree=tree, **kw9))
            ms.append(m)
        st7, _ = fresh()
        wf.shade(*args9, None, None, st7, ids, res_k, n, tree=tree, **kw9)
        _, blocked_l = wg.shade_fwd(*args9, b0["scand"], b0["sctn"], st_in,
                                    ids, b0["res"], n, **kw9)
        stats = {}
        with torch.inference_mode():
            (out_p, blocked_p), p9_ms = cuda_ms(
                torch, lambda: wg.shade_fwd_plain(
                    *args9, None, None, st_in, ids, res_k, n, stats=stats,
                    tree=tree, **kw9))
        bits = out9.view(torch.int32)
        k7_differ = int((bits != st7.view(torch.int32)).any(0).sum())
        plain_differ = int((bits[:, :n] != out_p.view(torch.int32)[:, :n])
                           .any(0).sum())
        blocked_differ = int((blocked != blocked_p).sum())
        route = route_differ(torch, wf, st_in[:, :n], res_k, b0["res"])
        padding = (res_k[4] < 0) & (res_k[5] >= 0)
        emit(dict(phase="k9_vs_plain", case=label, mode="walk", lanes=n,
                  hits=int((res_k[4] >= 0).sum()),
                  padding_winners=int(padding.sum()),
                  lanes_differ_from_k7=k7_differ,
                  lanes_differ_from_plain=plain_differ,
                  blocked_differ=blocked_differ,
                  blocked_differ_from_lists=int((blocked != blocked_l).sum()),
                  k6_differ_from_lists=route,
                  blocked=int(blocked.sum()), k9_ms=ms, plain_ms=p9_ms))
        check(k7_differ == 0, f"{label}: K9 differs from K7 on {k7_differ}")
        check(plain_differ == 0,
              f"{label}: K9 differs from its plain walk on {plain_differ}")
        check(blocked_differ == 0,
              f"{label}: blocked mask differs on {blocked_differ} lanes")
        check(int(blocked.sum()) > 0, f"{label}: no shadow ray blocked")
        del blocked_l

        # K10 on this bounce, at full width.
        res8 = res_k.clone()
        res8[7] = blocked
        ctb = torch.from_numpy(np.random.default_rng(11).normal(
            size=tuple(st_in.shape)).astype(np.float32)).to(dev)
        kw10 = {k: v for k, v in kw9.items() if k != "block"}
        bargs = (t["blob"], meta, t["lsb"], t["mtypes"], st_in, ids, res8,
                 ctb, n)
        row10, n10 = k10_vs_plain(torch, wg, t, stc, bargs, kw10, reps)
        emit(dict(phase="k10_vs_plain", case=label,
                  padding_winners=int(padding.sum()), **row10))
        a, b = out9[:, :n], out_p[:, :n]
        nums = dict(
            k9_ms=min(ms), k10_ms=n10["ms"], p9_ms=p9_ms, p10_ms=n10["p_ms"],
            stats=stats, n=n, n_lanes=st_in.shape[1],
            padding=int(padding.sum()), route=route,
            k9_err=float((a - b).abs().max()), k10_err=n10["err"])
        del out9, out_p, st7, ctb, res8, base
        return nums

    t, stc, meta = wf_inputs(torch, wf, mb, sd10, cam10, BIG_SEED)
    b0 = wf_bounce(torch, wf, t, stc, meta, BIG_W, BIG_H, 0, BIG_SEED)
    c5 = k9_k10_case("config5_bounce0", t, stc, meta, b0, 0, sd10.sky_mode,
                     3)
    k9_k10_case("config5_bounce0_envmap", t, stc, meta, b0, 0,
                wf.SKY_ENVMAP, 1)
    b1 = wf_advance(torch, wf, t, stc, meta, b0, 0, BIG_SEED, sd10.sky_mode)
    c51 = k9_k10_case("config5_bounce1", t, stc, meta, b1, 1, sd10.sky_mode,
                      1)
    k9_k10_case("config5_bounce1_envmap", t, stc, meta, b1, 1,
                wf.SKY_ENVMAP, 1)
    del b0, b1
    torch.cuda.empty_cache()
    tp, stp, metap = wf_inputs(torch, wf, mb, sdpad, campad, BIG_SEED)
    bp = wf_bounce(torch, wf, tp, stp, metap, 240, 136, 0, BIG_SEED)
    pad = k9_k10_case("padding_bounce0", tp, stp, metap, bp, 0,
                      sdpad.sky_mode, 1)
    check(pad["padding"] > 0 or pad["route"]["padding"] > 0,
          "padding: no lane won a padding slot")
    del bp
    stats, n = c5["stats"], c5["n"]
    tree_words = sum(t[k].numel() for k in ("nodef", "nodei", "prims"))
    k9_bytes = wf.k7_byte_count(stats, n, stc["block"], tree_words) + 4 * n \
        + 4 * (t["blob"].numel() + t["lsb"].numel() + meta.numel()
               + stc["n_mats"])
    n_blocks = t["prims"].numel() // (5 * stc["block"])
    k10_bytes = wg.k10_byte_count(
        stats, n, c5["n_lanes"],
        mbg.n_scalars(stc["n_mats"], stc["n_light_slots"]), n_blocks,
        stc["block"])
    for key, bytes_, ops in (("k9", k9_bytes, wf.k7_op_count(stats)),
                             ("k10", k10_bytes, wg.k10_op_count(stats))):
        out[key] = dict(ms=c5[f"{key}_ms"], plain_ms=c5[f"p{key[1:]}_ms"],
                        max_abs_err=max(c5[f"{key}_err"], c51[f"{key}_err"],
                                        pad[f"{key}_err"]),
                        plain_size=f"{n} rays (config 5, bounce 0)",
                        fp32_ops=ops, bytes=bytes_)
        out[key]["bound_ms"], out[key]["bound_by"] = bound(ops, bytes_)
    winfo = _build.BUILD_INFO["wavefront"]
    emit(dict(phase="k9_timing", card=card, k9_ms=c5["k9_ms"],
              k9_bounce1_ms=c51["k9_ms"], alive=stats["active"],
              **ptxas_of(_build.BUILD_INFO, "wavefront",
                         "shade_kernelILb0ELb1E"),
              **{k: out["k9"][k] for k in ("fp32_ops", "bytes", "bound_ms",
                                           "bound_by", "plain_ms")}))
    emit(dict(phase="k10_timing", card=card, k10_ms=c5["k10_ms"],
              k10_bounce1_ms=c51["k10_ms"], hits=stats["hit"],
              lit=stats["lit"],
              blocks_per_sm=_build.load_library("wavefront")
              .spt_wavefront_bounce_bwd_blocks_per_sm(
                  stc["n_mats"], stc["n_light_slots"]),
              **ptxas_of(_build.BUILD_INFO, "wavefront", "bounce_bwd_kernel"),
              **{k: out["k10"][k] for k in ("fp32_ops", "bytes", "bound_ms",
                                            "bound_by", "plain_ms")},
              build_seconds=winfo["seconds"]))
    del c5, c51, pad, t, tp
    torch.cuda.empty_cache()

    # 25. The differentiable wavefront against its plain stages -------------
    keys = cuda_diff.PARAM_KEYS
    w, h = 240, 136
    ctw = ct_image(torch, dev, w, h)
    runs = []
    for stages in (wg.KERNELS, wg.PLAIN):
        render = wg._make_render_fn(
            sd10, cam10, w, h, stages=stages, spp=2, max_bounces=DEPTH,
            rr_depth=RR, use_nee=True, use_mis=True, seed=BIG_SEED,
            sort_min_rays=0, chunk_rays=2 << 20)
        params = {k: v.clone().requires_grad_(True)
                  for k, v in G.get_params(sd10, keys).items()}
        (img, ms) = cuda_ms(torch, lambda: render(params, 0))
        (img * ctw).sum().backward()
        torch.cuda.synchronize()
        runs.append((img.detach(), {k: p.grad for k, p in params.items()},
                     ms))
    (img, grads, w_ms), (img_p, grads_p, p_ms) = runs
    res = compare(img, img_p)
    errs, g_err = tail_field_errors(grads, grads_p)
    emit(dict(phase="wfgrad_vs_plain", case="config5", width=w, height=h,
              spp=2, forward_ms=w_ms, plain_forward_ms=p_ms,
              pixels_differ=int((img != img_p).any(-1).sum()), **res,
              grad_max_abs_err=g_err, grad=errs))
    check(res["finite"] and res["frac_close"] >= MIN_CLOSE
          and res["mean_rel"] <= MAX_MEAN_REL, f"wavefront grad image {res}")
    check(all(e["ok"] for e in errs.values()), f"wavefront grad {errs}")

    # 26. Main paths: one backward of sum(ct * image) and 3 InverseRenderer
    # steps at config 5's settings, on 2,000 spheres (K3/K4) and on 10,000
    # (the wavefront: K5, K6, K9, K10) --------------------------------------
    ct_big = ct_image(torch, dev, BIG_W, BIG_H)
    out["launches"] = {}
    for label, sd, want, kernel in (
            ("bvh", sd2k, ("k3", "k4"), "megakernel_bvh_grad_kernel"),
            ("wavefront", sd10, ("k5", "k6", "k9", "k10"),
             "bounce_bwd_kernel")):
        mb._PACK_CACHE.clear()           # the render fn packs afresh
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        mk.reset_launch_counts()
        reset_glue(wf)
        t0 = time.perf_counter()
        render = cuda_diff.make_cuda_render_fn(
            sd, cam10, BIG_W, BIG_H, spp=BIG_SPP, max_bounces=DEPTH,
            rr_depth=RR, seed=BIG_SEED)
        params = {k: v.clone().requires_grad_(True)
                  for k, v in G.get_params(sd, keys).items()}
        img = render(params, 0)
        torch.cuda.synchronize()
        fwd_s = time.perf_counter() - t0
        (img * ct_big).sum().backward()
        torch.cuda.synchronize()
        backward_wall_s = time.perf_counter() - t0
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        for k, p in params.items():
            check(bool(torch.isfinite(p.grad).all()), f"{label}: {k} grad")
        check(float(params["albedo"].grad.abs().sum()) > 0
              and float(params["centers"].grad.abs().sum()) > 0,
              f"{label}: zero gradient")
        img_mean = float(img.detach().mean())
        del img, params
        true_p = G.get_params(sd, ("albedo",))
        with torch.no_grad():
            target = render(true_p, 0)
        r = np.random.default_rng(SEED)
        albedo0 = torch.clamp(true_p["albedo"] + torch.from_numpy(r.uniform(
            -0.2, 0.2, tuple(true_p["albedo"].shape)).astype(np.float32))
            .to(dev), 0.0, 1.0)
        inv = G.InverseRenderer(
            G.apply_params(sd, {"albedo": albedo0}), cam10, target,
            fields=("albedo", "roughness", "centers", "radii"),
            spp_per_step=BIG_SPP, learning_rate=TRAIN_LR,
            max_bounces=DEPTH, seed=BIG_SEED, rotate_samples=False,
            backend="cuda")
        err0 = float((inv.params["albedo"].detach() - true_p["albedo"])
                     .abs().mean())
        losses, step_s = [], []
        for _ in range(GRAD_STEPS):
            t1 = time.perf_counter()
            losses.append(inv.step())        # float(loss) waits for the card
            step_s.append(time.perf_counter() - t1)
        torch.cuda.synchronize()
        counts = dict(mk.LAUNCHES)
        glue = dict(wf.GLUE_CALLS)
        peak_gb = max(peak_gb, torch.cuda.max_memory_allocated() / 1e9)
        err1 = float((inv.params["albedo"].detach() - true_p["albedo"])
                     .abs().mean())
        prof = profiled(torch, inv.step, kernel)
        emit(dict(phase="grad_main_path", case=label, capacity=sd.capacity,
                  size=f"{BIG_W}x{BIG_H}", spp=BIG_SPP, depth=DEPTH,
                  forward_wall_s=fwd_s, forward_backward_wall_s=
                  backward_wall_s, image_mean=img_mean, losses=losses,
                  step_s=step_s, wall_per_step_s=sum(step_s) / GRAD_STEPS,
                  albedo_err_start=err0, albedo_err_end=err1,
                  peak_memory_gb=peak_gb, launches=counts, glue_calls=glue,
                  profiled_step_wall_ms=prof["profiled_wall_ms"], **prof))
        check(not any(glue.values()), f"{label}: lists were built: {glue}")
        check(all(np.isfinite(losses)), f"{label}: loss not finite")
        check(err1 < err0, f"{label}: the albedo error did not fall")
        check(all(counts[k] > 0 for k in want),
              f"{label}: {want} not all launched: {counts}")
        check(all(v == 0 for k, v in counts.items() if k not in want),
              f"{label}: other kernels or plain versions ran: {counts}")
        out["launches"][label] = counts
        del render, inv, target
        torch.cuda.empty_cache()

    # 27. Timing: K4 at the K4 main path's shape (2,000 spheres, 1080p x 4
    # spp); its bound from the plain K3's work of the same launch ---------
    args, k3kw, st = k3_inputs(torch, mb, sd2k, cam10, BIG_SEED)
    kw = dict(width=BIG_W, height=BIG_H, spp=BIG_SPP, max_bounces=DEPTH,
              rr_depth=RR, use_nee=True, use_mis=True, sky_mode=sd2k.sky_mode,
              dof=False, **k3kw)
    ct = mbg.swizzle_ct(ct_big, BIG_W, BIG_H)
    mbg.megakernel_bvh_grad(*args, ct, **kw)          # warm-up
    runs = [cuda_ms(torch, lambda: mbg.megakernel_bvh_grad(*args, ct, **kw))
            for _ in range(2)]
    k4_ms = min(ms for _, ms in runs)
    img4 = runs[-1][0][0]
    del runs
    img3, k3_ms = cuda_ms(torch, lambda: mb.megakernel_bvh_fwd(*args, **kw))
    k3_ms = min(k3_ms, cuda_ms(torch, lambda: mb.megakernel_bvh_fwd(
        *args, **kw))[1])
    # The main path's launch: K4's image must equal K3's on it, and K3's
    # its plain version's, every value (K4 keeps one thread a pixel, whose
    # K3 with a called bounce parted from the plain version at 4 spp).
    # The plain run's counts give the bound.
    res = compare(img4, img3)
    k4_differ = int((img4 != img3).any(-1).sum())
    check(res["finite"] and res["values_differ"] == 0,
          f"K4 image vs K3 at {BIG_W}x{BIG_H} x {BIG_SPP} spp: {res}")
    stats = {}
    with torch.inference_mode():
        want = mb.render_tiles_bvh_plain(*args, **kw, stats=stats)
    res3 = compare(img3, want)
    check(res3["finite"] and res3["values_differ"] == 0,
          f"K3 vs plain at {BIG_W}x{BIG_H} x {BIG_SPP} spp, "
          f"{K3_MAIN_SPHERES} spheres: {res3}")
    del img4, img3, want
    # One thread a pixel: a warp waits for its longest path in the forward
    # sweep and again in the replay, which runs the same bounces back.
    lanes = mk.lanes_busy(stats.pop("lengths"), (8, 4))
    ops = mbg.k4_op_count(stats)
    n_scal = mbg.n_scalars(k3kw["n_mats"], k3kw["n_light_slots"])
    n_bytes = 4 * (sum(a.numel() for a in args) + ct.numel()
                   + 3 * BIG_W * BIG_H + n_scal
                   + st["n_blocks"] * 8 * k3kw["block"])
    out["k4"].update(ms=k4_ms, fp32_ops=ops, bytes=n_bytes)
    out["k4"]["bound_ms"], out["k4"]["bound_by"] = bound(ops, n_bytes)
    emit(dict(phase="k4_timing", card=card, size=f"{BIG_W}x{BIG_H}",
              spp=BIG_SPP, spheres=K3_MAIN_SPHERES, k4_ms=k4_ms,
              k3_ms_same_launch=k3_ms, k4_over_k3=k4_ms / k3_ms,
              image_pixels_differ_from_k3=k4_differ, image_vs_k3=res,
              k3_vs_plain=res3, lanes_busy=lanes,
              pixel_samples_per_s=stats["paths"] / (k4_ms * 1e-3),
              fp32_ops=ops, bytes=n_bytes, bound_ms=out["k4"]["bound_ms"],
              bound_by=out["k4"]["bound_by"],
              blocks_per_sm=_build.load_library("megakernel_bvh_grad")
              .spt_megakernel_bvh_grad_blocks_per_sm(
                  k3kw["n_mats"], k3kw["n_light_slots"]),
              **ptxas_of(_build.BUILD_INFO, "megakernel_bvh_grad",
                         "megakernel_bvh_grad_kernel"),
              build_seconds=_build.BUILD_INFO["megakernel_bvh_grad"][
                  "seconds"]))

    # 28. K4 against the differentiable wavefront at 2,000 spheres, both
    # forced, one forward+backward each, in turns --------------------------
    walls = {"fused": [], "wavefront": []}
    for engine in ("fused", "wavefront", "wavefront", "fused"):
        render = cuda_diff.make_cuda_render_fn(
            sd2k, cam10, BIG_W, BIG_H, spp=BIG_SPP, max_bounces=DEPTH,
            rr_depth=RR, seed=BIG_SEED, engine=engine)
        params = {k: v.clone().requires_grad_(True)
                  for k, v in G.get_params(sd2k, keys).items()}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        (render(params, 0) * ct_big).sum().backward()
        torch.cuda.synchronize()
        walls[engine].append(1e3 * (time.perf_counter() - t0))
    emit(dict(phase="grad_crossover", card=card, spheres=K3_MAIN_SPHERES,
              size=f"{BIG_W}x{BIG_H}", spp=BIG_SPP,
              fused_k3_k4_ms=walls["fused"],
              wavefront_ms=walls["wavefront"],
              wavefront_over_fused=min(walls["wavefront"])
              / min(walls["fused"])))
    return out


# The prim-sharded wavefront's checks and main paths (slice 6).  The main
# path runs it under NCCL at world size 1 (one card, one rank: data=1,
# prim=1); the distributed path spawns 2 gloo ranks on the one card (NCCL
# takes no two ranks on one device), prim=2 or data=2.
DIST_RANKS = 2
DIST_TIMEOUT = 600.0
# The kernels of the prim-sharded path: raygen, K6 walking the shard's
# tree, K8 and K7 reading the merged verdict.
PRIM_KERNELS = ("k5", "k6", "k8", "k7b")
GRAD_KEYS = ("albedo", "emission", "roughness", "centers", "radii")


def brute_blocked(torch, wf, mb, local, sray, lanes):
    """Whether each of ``lanes`` (indices) of the shadow rays ``sray`` has
    a blocker among every slot of the leaf blocks ``local``: a sphere test
    with TMIN < t < tmax, no box or list culling any."""
    pr = local.transpose(1, 2).reshape(1, -1, 5).transpose(1, 2)
    out = []
    for chunk in lanes.split(256):
        m = chunk.numel()
        tj, ok = mb._leaf_t(pr.expand(m, -1, -1),
                            *(sray[a, chunk] for a in range(6)))
        out.append((ok & (tj < sray[6, chunk][:, None])).any(dim=1))
    return torch.cat(out) if out else torch.zeros(0, dtype=torch.bool,
                                                  device=sray.device)


def prim_shard_case(torch, wf, wg, mb, t, stc, meta, b, k, skies, label,
                    reps):
    """The prim-sharded path's kernels on one bounce ``b`` (``wf_bounce``'s
    or ``wf_advance``'s), on the whole tree and on each prim=2 shard's
    (``shard_tree``), the merged winner being K6's tree-mode winner over
    the whole table: K6's tree mode on each shard's tree and K8 (under
    each sky of ``skies``) against their plain versions, bit for bit; K8l
    on the glue's shadow rays and each part's lists against its plain
    version, bit for bit.  Against the list route it counts the lanes
    where K6 on a shard's tree parts from K6l on the shard's lists
    (``route_differ``: none but exact ties and padding winners) and the
    verdicts where K8 parts from K8l, each of which must be a blocker that
    one route's box test culled (a grazing ray: brute force over the
    part's slots finds the blocker).  The shards' MAX against the whole's
    verdicts and K9's.  Returns the whole tree's K8 and K8l numbers, K6's
    on shard 0, and K9's verdicts."""
    from spt_tpu_torch.parallel.wavefront_prim import _shard_tree
    block, n, st, ids, res = (stc["block"], b["n"], b["st"], b["ids"],
                              b["res_t"])
    prims = t["prims"].reshape(-1, 5, block)
    nb = prims.shape[0]
    half = -(-nb // 2)
    sray = shadow_sray(torch, wf, t, stc, dict(b, res=res), k, BIG_SEED)
    args = (t["blob"], meta, t["lsb"])
    kw = dict(k=k, block=block, n_mats=stc["n_mats"],
              n_light_slots=stc["n_light_slots"], rr_depth=RR, use_nee=True,
              use_mis=True)
    head = st[:, :n]
    rows, out, verdicts = {}, {}, {}
    for part, (lo, hi) in (("whole", (0, nb)), ("shard0", (0, half)),
                           ("shard1", (half, nb))):
        local = prims[lo:hi].contiguous()
        tree = _shard_tree(t, stc, lo, hi)
        lob, hib = wf._leaf_block_bounds(local)
        row = dict(blocks=hi - lo, nodes=tree[0].shape[0] // 8)
        if part != "whole":
            k6_ms = min(cuda_ms(torch, lambda: wf.isect(
                local, None, None, st, n, block=block, tree=tree))[1]
                for _ in range(reps))
            res_s = wf.isect(local, None, None, st, n, block=block,
                             tree=tree)
            k6_stats = {}
            with torch.inference_mode():
                res_p, k6_p_ms = cuda_ms(torch, lambda: wf.isect_plain(
                    local, None, None, st, n, block=block, stats=k6_stats,
                    tree=tree))
            cand, ctn = wf.precull_tiles(
                tuple(head[c] for c in range(3)),
                tuple(head[c] for c in range(3, 6)), head[wf.C_ALIVE],
                None, lob, hib)
            k6l_ms = min(cuda_ms(torch, lambda: wf.isect(
                local, cand, ctn, st, n, block=block))[1]
                for _ in range(reps))
            res_l = wf.isect(local, cand, ctn, st, n, block=block)
            route = route_differ(torch, wf, head, res_s, res_l)
            differ = bits_differ(torch, res_s, res_p)
            row.update(k6_ms=k6_ms, k6_plain_ms=k6_p_ms, k6_lanes_differ=differ,
                       k6l_ms=k6l_ms, k6_differ_from_lists=route,
                       k6_nodes_per_lane=k6_stats["nodes"]
                       / max(k6_stats["alive"], 1))
            check(differ == 0, f"{label} {part}: K6 on the shard's tree "
                               f"differs from its plain walk on {differ} "
                               "lanes")
            check(route["other"] == 0,
                  f"{label} {part}: K6 on the shard's tree and K6l part on "
                  f"{route['other']} lanes without a tie or a padding "
                  "winner")
            if part == "shard0":
                out["k6"] = dict(ms=k6_ms, plain_ms=k6_p_ms, stats=k6_stats,
                                 tree_words=sum(a.numel() for a in tree)
                                 + local.numel())
            del res_s, res_p, res_l, cand, ctn
        for sky in skies:
            kw8 = dict(kw, sky_mode=sky)
            ms = [cuda_ms(torch, lambda: wf.shadow_verdicts(
                *args, local, t["mtypes"], st, ids, res, n, tree=tree,
                **kw8))[1] for _ in range(reps)]
            got = wf.shadow_verdicts(*args, local, t["mtypes"], st, ids, res,
                                     n, tree=tree, **kw8)
            stats = {}
            with torch.inference_mode():
                want, p_ms = cuda_ms(torch, lambda: wf.shadow_verdicts_plain(
                    *args, local, t["mtypes"], st, ids, res, n, tree=tree,
                    stats=stats, **kw8))
            differ = int((got != want).sum())
            row[f"k8_sky{sky}"] = dict(k8_ms=ms, plain_ms=p_ms,
                                       lanes_differ=differ,
                                       blocked=int(got.sum()),
                                       shadow_rays=stats["shadow"])
            check(differ == 0, f"{label} {part} sky {sky}: K8 differs from "
                               f"its plain version on {differ} lanes")
            if sky == skies[0]:
                verdicts[part] = got
                if part == "whole":
                    out["k8"] = dict(ms=min(ms), plain_ms=p_ms, stats=stats,
                                     tree_words=sum(a.numel() for a in tree)
                                     + local.numel())
        scand, sctn = wf.precull_tiles(tuple(sray[:3]), tuple(sray[3:6]),
                                       sray[7], sray[6], lob, hib)
        l_ms = min(cuda_ms(torch, lambda: wf.anyhit(
            local, scand, sctn, sray, n, block=block))[1]
            for _ in range(reps))
        got_l = wf.anyhit(local, scand, sctn, sray, n, block=block)
        l_stats = {}
        with torch.inference_mode():
            want_l, l_p_ms = cuda_ms(torch, lambda: wf.anyhit_plain(
                local, scand, sctn, sray, n, block=block, stats=l_stats))
        differ = int((got_l != want_l).sum())
        check(differ == 0, f"{label} {part}: K8l differs from its plain "
                           f"version on {differ} lanes")
        parted = torch.nonzero(verdicts[part] != got_l[:n])[:, 0]
        real = brute_blocked(torch, wf, mb, local, sray, parted)
        row.update(k8l_ms=l_ms, k8l_plain_ms=l_p_ms, k8l_lanes_differ=differ,
                   k8_differ_from_lists=int(parted.numel()),
                   k8_differ_lists_culled=int(
                       (real & (got_l[parted] < 0.5)).sum()),
                   k8_differ_walk_culled=int(
                       (real & (verdicts[part][parted] < 0.5)).sum()))
        check(bool(real.all()), f"{label} {part}: K8 and K8l part on "
                                f"{int((~real).sum())} rays with no blocker")
        if part == "whole":
            out["k8l"] = dict(ms=l_ms, plain_ms=l_p_ms, stats=l_stats)
        rows[part] = row
        del scand, sctn, got_l, want_l
    merged = torch.maximum(verdicts["shard0"], verdicts["shard1"])
    _, blocked9 = wg.shade_fwd(*args, t["prims"], t["mtypes"], None, None,
                               st, ids, res, n, tree=b["tree"],
                               sky_mode=skies[0], **kw)
    max_differ = int((merged != verdicts["whole"]).sum())
    k9_differ = int((verdicts["whole"] != blocked9).sum())
    emit(dict(phase="prim_shard_vs_plain", case=label, lanes=n,
              need=int((sray[7] > 0.5).sum()), **rows,
              shards_max_differ_from_whole=max_differ,
              whole_differ_from_k9=k9_differ))
    check(max_differ == 0 and k9_differ == 0,
          f"{label}: the shards' MAX differs from the whole tree's K8 on "
          f"{max_differ} lanes, the whole's from K9's verdict on {k9_differ}")
    check(int(verdicts["whole"].sum()) > 0, f"{label}: no shadow ray blocked")
    out["blocked9"] = blocked9
    return out


def run_prim_phases(torch, T, mk, dev, card, k3) -> dict:
    """K6 on the prim shards' trees, K8, K8l and K7's ``blocked_in_res``
    mode against their plain versions on config-5 bounces and the padding
    scene (``prim_shard_case``), and the prim-sharded wavefront's main path
    under NCCL at world size 1 (config 5, 1920x1080 x 4 spp, both skies)
    against the facade's render of the same samples: K5, K6, K8 and K7b
    only, no lists built, the image equal to the facade's.  Returns the
    launch counts, the kernels line's numbers and the facade's images."""
    import tempfile
    import torch.distributed as dist
    from spt_tpu_torch.diff import gradients as G
    from spt_tpu_torch.kernels import _build, megakernel_bvh as mb
    from spt_tpu_torch.kernels import wavefront as wf
    from spt_tpu_torch.kernels import wavefront_grad as wg
    from spt_tpu_torch.parallel import mesh as pm
    from spt_tpu_torch.parallel.wavefront_prim import \
        render_wavefront_prim_sharded

    out = {}
    sd10, cam10 = k3["sd10"], k3["cam10"]
    block = wf.BLOCK

    # 29. K6 on each prim=2 shard's tree, K8 on the whole tree and on each
    # shard's, and K8l on the glue's rays and lists, on config-5 bounces 0
    # and 1 (1920x1080 x 2 spp, both skies) and on the padding scene --------
    t, stc, meta = wf_inputs(torch, wf, mb, sd10, cam10, BIG_SEED)
    b0 = wf_bounce(torch, wf, t, stc, meta, BIG_W, BIG_H, 0, BIG_SEED)
    base0 = b0["buf"].clone()
    sky = sd10.sky_mode
    skies = (sky, wf.SKY_ENVMAP)
    k8 = prim_shard_case(torch, wf, wg, mb, t, stc, meta, b0, 0, skies,
                         "config5_bounce0", 3)

    # 30. K7 reading K9's verdict (blocked_in_res) against K7 walking, on
    # every lane of the same bounce, with either sky ----------------------
    res8 = b0["res_t"].clone()
    res8[7] = k8["blocked9"]
    args = (t["blob"], meta, t["lsb"], t["prims"], t["mtypes"])
    none = torch.zeros((1, 1, 1), device=dev)
    n = b0["n"]
    for label, sky_k7 in (("config5_bounce0", sky),
                          ("config5_bounce0_envmap", wf.SKY_ENVMAP)):
        kw7 = dict(k=0, block=block, n_mats=stc["n_mats"],
                   n_light_slots=stc["n_light_slots"], rr_depth=RR,
                   use_nee=True, use_mis=True, sky_mode=sky_k7)
        walk, read, plain = base0.clone(), base0.clone(), base0.clone()
        wf.shade(*args, None, None, *stream_of(torch, wf, walk),
                 b0["res_t"], n, tree=b0["tree"], **kw7)
        ms = []
        for _ in range(3):
            read.copy_(base0)
            ms.append(cuda_ms(torch, lambda: wf.shade(
                *args, none.int(), none, *stream_of(torch, wf, read), res8,
                n, blocked_in_res=True, **kw7))[1])
        stats = {}
        with torch.inference_mode():
            _, p_ms = cuda_ms(torch, lambda: wf.shade_plain(
                *args, none.int(), none, *stream_of(torch, wf, plain), res8,
                n, blocked_in_res=True, stats=stats, **kw7))
        differ = bits_differ(torch, read, walk)
        res = compare(read[:wf.N_CH, :n].T, plain[:wf.N_CH, :n].T)
        emit(dict(phase="k7b_vs_plain", case=label, lanes=n,
                  lanes_differ_from_k7=differ, k7b_ms=ms, plain_ms=p_ms,
                  shadow_rays=stats["shadow"], **res))
        check(differ == 0, f"{label}: K7 reading the verdict differs from "
                           f"K7 walking on {differ} lanes")
        check(res["finite"] and res["frac_close"] >= MIN_CLOSE,
              f"{label}: K7b against its plain version: {res}")
        if label == "config5_bounce0":
            ops = wf.k7b_op_count(stats)
            n_bytes = wf.k7b_byte_count(stats, n) + 4 * (
                t["blob"].numel() + t["lsb"].numel() + meta.numel()
                + stc["n_mats"])
            out["k7b"] = dict(ms=min(ms), plain_ms=p_ms,
                              max_abs_err=res["max_abs_err"],
                              plain_size=f"{n} rays (config 5, bounce 0, "
                                         "counting its work)",
                              fp32_ops=ops, bytes=n_bytes)
            out["k7b"]["bound_ms"], out["k7b"]["bound_by"] = bound(ops,
                                                                   n_bytes)
        del walk, read, plain
    k8_1 = prim_shard_case(
        torch, wf, wg, mb, t, stc, meta,
        wf_advance(torch, wf, t, stc, meta, b0, 0, BIG_SEED, sky), 1,
        skies, "config5_bounce1", 1)
    uniform_bytes = 4 * (t["blob"].numel() + t["lsb"].numel() + meta.numel()
                         + stc["n_mats"])
    s8, s8l, s6 = k8["k8"]["stats"], k8["k8l"]["stats"], k8["k6"]["stats"]
    ops, n_bytes = wf.k8_op_count(s8), wf.k8_byte_count(
        s8, n, k8["k8"]["tree_words"]) + uniform_bytes
    out["k8"] = dict(ms=k8["k8"]["ms"], plain_ms=k8["k8"]["plain_ms"],
                     max_abs_err=0.0,
                     plain_size=f"{n} rays (config 5, bounce 0, the whole "
                                "tree, counting its work)",
                     fp32_ops=ops, bytes=n_bytes)
    out["k8"]["bound_ms"], out["k8"]["bound_by"] = bound(ops, n_bytes)
    ops, n_bytes = wf.k8l_op_count(s8l), wf.k8l_byte_count(s8l, n, block)
    out["k8l"] = dict(ms=k8["k8l"]["ms"], plain_ms=k8["k8l"]["plain_ms"],
                      max_abs_err=0.0,
                      plain_size=f"{n} rays (config 5, bounce 0, whole "
                                 "table, counting its work)",
                      fp32_ops=ops, bytes=n_bytes)
    out["k8l"]["bound_ms"], out["k8l"]["bound_by"] = bound(ops, n_bytes)
    ops = wf.k6_op_count(s6)
    n_bytes = wf.k6_byte_count(s6, n, block, k8["k6"]["tree_words"])
    k6_shard_bound = bound(ops, n_bytes)
    emit(dict(phase="prim_kernels_timing", card=card,
              k8_ms=k8["k8"]["ms"], k8_ms_bounce1=k8_1["k8"]["ms"],
              k8l_ms=k8["k8l"]["ms"], k8l_ms_bounce1=k8_1["k8l"]["ms"],
              k6_shard0_ms=k8["k6"]["ms"],
              k6_shard0_ms_bounce1=k8_1["k6"]["ms"],
              k6_shard0_bound_ms=k6_shard_bound[0],
              k6_shard0_bound_by=k6_shard_bound[1],
              shadow_rays=s8["shadow"],
              k8=dict(ptxas_of(_build.BUILD_INFO, "wavefront",
                               "shade_kernelILb0ELb0E"),
                      **{k: out["k8"][k] for k in (
                          "fp32_ops", "bytes", "bound_ms", "bound_by",
                          "plain_ms")}),
              k8l=dict(ptxas_of(_build.BUILD_INFO, "wavefront",
                                "anyhit_kernel"),
                       **{k: out["k8l"][k] for k in (
                           "fp32_ops", "bytes", "bound_ms", "bound_by",
                           "plain_ms")})))
    del b0, base0, res8, k8, k8_1, t
    torch.cuda.empty_cache()
    sdpad = padding_scene(T).compile(device=dev)
    tp, stp, metap = wf_inputs(torch, wf, mb, sdpad, T.Camera.look_at(
        device=dev, **PAD_CAM), BIG_SEED)
    prim_shard_case(torch, wf, wg, mb, tp, stp, metap,
                    wf_bounce(torch, wf, tp, stp, metap, 240, 136, 0,
                              BIG_SEED), 0, (sdpad.sky_mode, wf.SKY_ENVMAP),
                    "padding_bounce0", 1)
    del tp

    # 31. Main path: the prim-sharded wavefront under NCCL at world size 1,
    # config 5 at 1920x1080 x 4 spp with its sky and with the env map,
    # counted; against the facade's render of the same samples -----------
    rdzv = tempfile.mkdtemp(prefix="spt_nccl_")
    pm.init_distributed("nccl", f"file://{rdzv}/rendezvous", 1, 0, 300.0)
    try:
        mesh = pm.make_render_mesh(data=1, prim=1, device=dev)
        # NCCL makes its communicator at the first collective: that one,
        # timed alone, so the renders' walls leave it out.
        t0 = time.perf_counter()
        pm.all_reduce(torch.zeros(1, device=dev), dist.ReduceOp.SUM,
                      mesh.prim_group, "nccl")
        torch.cuda.synchronize()
        emit(dict(phase="nccl_first_collective",
                  seconds=time.perf_counter() - t0))
        kw = dict(max_bounces=DEPTH, rr_depth=RR, seed=BIG_SEED)
        out["launches"] = {k: 0 for k in mk.LAUNCHES}
        out["facade"] = {}
        for label in ("config5", "config5_envmap"):
            scene = scene_10k(T)
            if label == "config5_envmap":
                scene.set_environment_map(env_gradient())
            sd = scene.compile(device=dev)
            mb._PACK_CACHE.clear()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            mk.reset_launch_counts()
            reset_glue(wf)
            t0 = time.perf_counter()
            img = render_wavefront_prim_sharded(sd, cam10, BIG_W, BIG_H, 0,
                                                BIG_SPP, mesh, **kw)
            torch.cuda.synchronize()
            wall_s = time.perf_counter() - t0
            counts = dict(mk.LAUNCHES)
            glue = dict(wf.GLUE_CALLS)
            peak = torch.cuda.max_memory_allocated() / 1e9
            tracer = big_tracer(T, dev, scene)
            tracer.render_to_completion()
            want = tracer.get_state()["accum"]
            torch.cuda.synchronize()
            out["facade"][label] = (scene, sd, want)
            res = compare(img, want)
            differ = int((img != want).any(-1).sum())
            emit(dict(phase="prim_main_path", case=label, backend="nccl",
                      world_size=1, data=1, prim=1, size=f"{BIG_W}x{BIG_H}",
                      spp=BIG_SPP, wall_s=wall_s, peak_memory_gb=peak,
                      launches=counts, glue_calls=glue,
                      pixels_differ_from_facade=differ,
                      vs_facade=res, mean=float(img.mean()) / BIG_SPP))
            check(all(counts[k] > 0 for k in PRIM_KERNELS),
                  f"{label}: K5, K6, K8 or K7b was not launched: {counts}")
            check(all(v == 0 for k, v in counts.items()
                      if k not in PRIM_KERNELS),
                  f"{label}: other kernels, a list form or a plain version "
                  f"ran: {counts}")
            check(not any(glue.values()),
                  f"{label}: the prim path built lists: {glue}")
            check(differ == 0, f"{label}: the prim=1 image differs from the "
                               f"facade's on {differ} pixels")
            check(tuple(img.shape) == (BIG_H, BIG_W, 3), f"{label}: shape")
            check(res["finite"] and res["frac_close"] >= MIN_CLOSE
                  and res["mean_rel"] <= MAX_MEAN_REL,
                  f"{label}: prim-sharded render against the facade {res}")
            check(float(want.mean()) > 0.01, f"{label}: image is black")
            for k, v in counts.items():
                out["launches"][k] += v
            del img
        # The gradient all-reduce of config 5's parameter vector, alone,
        # under NCCL at world size 1 (CUDA events, 10 launches).
        numel = sum(v.numel()
                    for v in G.get_params(sd10, GRAD_KEYS).values())
        vec = torch.ones(numel, device=dev)
        pm.all_reduce(vec, dist.ReduceOp.SUM, mesh.data_group, "nccl")
        _, ms = cuda_ms(torch, lambda: [pm.all_reduce(
            vec, dist.ReduceOp.SUM, mesh.data_group, "nccl")
            for _ in range(10)])
        out["nccl_allreduce_ms"] = ms / 10
        out["grad_numel"] = numel
        emit(dict(phase="grad_allreduce", backend="nccl", world_size=1,
                  numel=numel, ms=ms / 10))
    finally:
        dist.destroy_process_group()
    return out


def run_dist_phases(torch, T, mk, dev, card, k3, prim) -> dict:
    """The distributed paths on 2 gloo ranks spawned on the one card
    (``tools/dist_worker``): config 5 at 1920x1080 x 4 spp prim-sharded
    (prim=2, both skies: the pixels that differ from the unsharded render,
    each a cross-shard t-tie), sample-sharded (data=2) against the
    unsharded render, and the DP gradient (one backward and 3 Adam steps
    through make_wavefront_dp_render_fn) against one process's wavefront
    gradient.  Returns the launch counts."""
    from spt_tpu_torch.diff import gradients as G
    from spt_tpu_torch.kernels import wavefront_grad as wg
    from spt_tpu_torch.tools import dist_worker

    sd10, cam10 = k3["sd10"], k3["cam10"]
    facade = prim["facade"]
    sd_env = facade["config5_envmap"][1]
    kw = dict(max_bounces=DEPTH, rr_depth=RR, seed=BIG_SEED)
    size = dict(width=BIG_W, height=BIG_H, spp=BIG_SPP)
    cases = {
        "prim2": dict(case="prim_forward", data=1, prim=2, scene="config5",
                      kw=kw, **size),
        "prim2_envmap": dict(case="prim_forward", data=1, prim=2,
                             scene="config5_envmap", kw=kw, **size),
        "data2": dict(case="forward", data=2, prim=1, scene="config5", kw=kw,
                      **size),
        "dp_grad": dict(case="dp_grad", data=2, prim=1, scene="config5",
                        kw=kw, fields=GRAD_KEYS, ct_seed=SEED,
                        steps=GRAD_STEPS, perturb=0.2, lr=TRAIN_LR,
                        step_fields=("albedo", "roughness", "centers",
                                     "radii"), **size),
    }
    t0 = time.perf_counter()
    try:
        reports = dict(zip(cases, dist_worker.launch(
            list(cases.values()), DIST_RANKS,
            scenes={"config5": (sd10, cam10),
                    "config5_envmap": (sd_env, cam10)},
            backend="gloo", device="cuda", timeout=DIST_TIMEOUT)))
    except (RuntimeError, TimeoutError) as e:
        raise PhaseFailed(f"dist_main_path: {e}") from e
    wall_s = time.perf_counter() - t0
    launches = {k: 0 for k in mk.LAUNCHES}
    for label, rep in reports.items():
        for k, v in rep["launches"].items():
            launches[k] += v
        check(rep["backend"] == "gloo" and rep["device"].startswith("cuda"),
              f"{label}: ran on {rep['backend']} / {rep['device']}")
        check(rep["launches"]["plain"] == 0, f"{label}: a plain version ran")

    # The prim=2 renders: every differing pixel a cross-shard t-tie.
    for label, want_key in (("prim2", "config5"),
                            ("prim2_envmap", "config5_envmap")):
        rep = reports[label]
        want = facade[want_key][2].cpu().numpy()
        got = rep["image"]
        differ = np.flatnonzero((got != want).any(-1))
        not_ties = sorted(set(differ.tolist()) - set(rep["tie_pixels"]))
        res = compare(torch.from_numpy(got), torch.from_numpy(want))
        emit(dict(phase="dist_main_path", case=label, backend="gloo",
                  ranks=DIST_RANKS, data=1, prim=2, size=f"{BIG_W}x{BIG_H}",
                  spp=BIG_SPP, walls_s=rep["walls_s"],
                  peak_memory_gb=rep["peak_memory_gb"],
                  launches=rep["launches"], glue_calls=rep["glue_calls"],
                  pixels_differ=len(differ),
                  tie_pixels=len(rep["tie_pixels"]),
                  tie_lanes=rep["tie_lanes"],
                  differing_pixels_without_a_tie=len(not_ties),
                  stream_checks=rep["stream_checks"],
                  collectives=rep["collectives"],
                  collective_mb=[b / 1e6 for b in rep["collective_bytes"]],
                  collective_ms=rep["collective_ms"], vs_unsharded=res))
        check(all(rep["launches"][k] > 0 for k in PRIM_KERNELS),
              f"{label}: K5, K6, K8 or K7b was not launched")
        check(all(v == 0 for k, v in rep["launches"].items()
                  if k not in PRIM_KERNELS),
              f"{label}: other kernels, a list form or a plain version ran: "
              f"{rep['launches']}")
        check(not any(rep["glue_calls"].values()),
              f"{label}: the prim path built lists: {rep['glue_calls']}")
        check(not not_ties, f"{label}: {len(not_ties)} of {len(differ)} "
                            f"differing pixels had no cross-shard tie")
        check(res["finite"] and res["frac_close"] >= MIN_CLOSE,
              f"{label}: against the unsharded render {res}")

    # The sample-sharded forward against the unsharded render.
    rep = reports["data2"]
    want = facade["config5"][2].cpu().numpy()
    res = compare(torch.from_numpy(rep["image"]), torch.from_numpy(want))
    emit(dict(phase="dist_main_path", case="data2", backend="gloo",
              ranks=DIST_RANKS, data=2, prim=1, size=f"{BIG_W}x{BIG_H}",
              spp=BIG_SPP, walls_s=rep["walls_s"],
              peak_memory_gb=rep["peak_memory_gb"], launches=rep["launches"],
              glue_calls=rep["glue_calls"],
              pixels_differ=int((rep["image"] != want).any(-1).sum()),
              vs_unsharded=res))
    for label in ("data2", "dp_grad"):
        check(not any(reports[label]["glue_calls"].values()),
              f"{label}: the split path built lists: "
              f"{reports[label]['glue_calls']}")
    check(res["finite"] and res["frac_close"] >= MIN_CLOSE
          and res["mean_rel"] <= MAX_MEAN_REL,
          f"data2: against the unsharded render {res}")

    # The DP gradient against one process's wavefront gradient.
    rep = reports["dp_grad"]
    render = wg.make_wavefront_render_fn(sd10, cam10, BIG_W, BIG_H,
                                         spp=BIG_SPP, **kw)
    params = {k: v.clone().requires_grad_(True)
              for k, v in G.get_params(sd10, GRAD_KEYS).items()}
    img = render(params, 0)
    (img * ct_image(torch, dev, BIG_W, BIG_H)).sum().backward()
    errs, g_err = tail_field_errors(
        {k: torch.from_numpy(rep[f"grad.{k}"]) for k in GRAD_KEYS},
        {k: p.grad for k, p in params.items()})
    res = compare(torch.from_numpy(rep["image"]), img.detach())
    emit(dict(phase="dist_main_path", case="dp_grad", backend="gloo",
              ranks=DIST_RANKS, data=2, prim=1, size=f"{BIG_W}x{BIG_H}",
              spp=BIG_SPP, walls_s=rep["walls_s"],
              peak_memory_gb=rep["peak_memory_gb"], launches=rep["launches"],
              glue_calls=rep["glue_calls"], losses=rep["losses"],
              step_s=rep["step_s"],
              albedo_err_start=rep["albedo_err_start"],
              albedo_err_end=rep["albedo_err_end"],
              grad_allreduce_ms=rep["grad_allreduce_ms"],
              grad_vector_numel=rep["grad_vector_numel"],
              image_vs_single=res, grad_max_abs_err=g_err, grad=errs))
    check(all(rep["launches"][k] > 0 for k in ("k5", "k6", "k9", "k10")),
          "dp_grad: K5, K6, K9 or K10 was not launched")
    check(all(e["ok"] for e in errs.values()), f"dp_grad: {errs}")
    check(res["frac_close"] >= MIN_CLOSE, f"dp_grad image: {res}")
    check(all(np.isfinite(rep["losses"])), "dp_grad: loss not finite")
    check(rep["albedo_err_end"] < rep["albedo_err_start"],
          "dp_grad: the albedo error did not fall")
    emit(dict(phase="grad_allreduce", backend="gloo", world_size=DIST_RANKS,
              numel=rep["grad_vector_numel"], ms=rep["grad_allreduce_ms"],
              nccl_world1_ms=prim["nccl_allreduce_ms"]))
    emit(dict(phase="dist_wall", seconds=wall_s, backend="gloo",
              ranks=DIST_RANKS, device=card))
    del render, params, img
    torch.cuda.empty_cache()
    return dict(launches=launches)


# The fused bounce (K11, K11g) and the matmul-form sweeps (K6m, K7m),
# slice 7: each against its plain version on config-5 bounces, then the
# main paths that run them: render_wavefront(split=False), with the
# precull and with the walk, render_wavefront(mxu=True), and
# make_wavefront_render_fn(split=False).
# The matmul form against the split render at config 5: the expanded
# quadratic rounds otherwise, and at config 5's distances that flips 0.06%
# of K6's winners and 0.5% of K7's shadow verdicts at bounce 0 (knife
# edges; ROADMAP.md), so 3.0% of the image's values lie outside JAX's
# bar for it, 1e-4 + 1e-3 |a|, which JAX set on a 300-sphere scene and
# the port's tests hold there.  Held here: means within MAX_MEAN_REL and
# at least this share of values within that bar (0.9695 on an H100; the
# render is deterministic).
MXU_MIN_CLOSE = 0.95
FUSED_MODES = (("fused", dict(split=False)),
               ("fused_walk", dict(split=False, precull=False)),
               ("mxu", dict(mxu=True)))


def stream_of(torch, wf, buf):
    """The (17, R) state and (2, R) ids of a (19, R) stream buffer."""
    return buf[:wf.N_CH], buf[wf.N_CH:].view(torch.int32)


def bits_differ(torch, a, b):
    """Lanes (columns) where two float tensors differ in any bit."""
    return int((a.view(torch.int32) != b.view(torch.int32)).any(dim=0).sum())


def state_close(torch, wf, a, b):
    """K1's comparison of two (17, n) states: every value, and the means of
    the throughput and radiance channels."""
    close = torch.isclose(a, b, rtol=RTOL, atol=ATOL)
    mean_rel = max(abs(float(a[c].double().mean() - b[c].double().mean()))
                   / max(abs(float(b[c].double().mean())), 1e-12)
                   for c in range(wf.C_TR, wf.C_LB + 1))
    return dict(max_abs_err=float((a - b).abs().max()),
                frac_close=float(close.double().mean()), mean_rel=mean_rel,
                finite=bool(torch.isfinite(a).all()))


def check_state(res, label):
    check(res["finite"], f"{label}: not finite")
    check(res["frac_close"] >= MIN_CLOSE,
          f"{label}: {res['frac_close']:.5f} close")
    check(res["mean_rel"] <= MAX_MEAN_REL,
          f"{label}: means differ by {res['mean_rel']:.5f}")


def k11_case(torch, wf, wg, t, stc, meta, b, k, precull, sky, reps,
             boxes):
    """K11 and K11g on one config-5 bounce from the same state, against
    the plain K11 (its record the plain K11g's) and against the split
    bounce (K6's tree-mode winner, K7's state, K9's verdict, the shadow
    rays walking the tree); with ``precull`` their list sweep culled by
    ``boxes``, as the render runs it.  Returns the numbers and K11g's
    outputs."""
    n, base = b["n"], b["buf"].clone()
    kw = dict(k=k, block=stc["block"], n_mats=stc["n_mats"],
              n_light_slots=stc["n_light_slots"], rr_depth=RR, use_nee=True,
              use_mis=True, sky_mode=sky, boxes=boxes)
    fargs = (t["blob"], meta, t["lsb"], t["nodef"], t["nodei"], t["prims"],
             t["mtypes"], b["cand"], b["ctn"])
    args7 = (t["blob"], meta, t["lsb"], t["prims"], t["mtypes"], None, None)
    split = base.clone()
    kw7 = {a: v for a, v in kw.items() if a != "boxes"}
    wf.shade(*args7, *stream_of(torch, wf, split), b["res_t"], n,
             tree=b["tree"], **kw7)
    _, blocked9 = wg.shade_fwd(*args7, *stream_of(torch, wf, base),
                               b["res_t"], n, tree=b["tree"], **kw7)
    got = base.clone()
    ms = []
    for _ in range(reps):
        got.copy_(base)
        ms.append(cuda_ms(torch, lambda: wf.bounce(
            *fargs, *stream_of(torch, wf, got), n, precull=precull,
            **kw))[1])
    ms_g = []
    for _ in range(reps):
        (out_g, res_g), m = cuda_ms(torch, lambda: wg.bounce_fwd(
            *fargs, *stream_of(torch, wf, base), n, precull=precull, **kw))
        ms_g.append(m)
    plain, rec = base.clone(), torch.empty_like(res_g)
    stats = {}
    with torch.inference_mode():
        _, p_ms = cuda_ms(torch, lambda: wf.bounce_plain(
            *fargs, *stream_of(torch, wf, plain), n, precull=precull,
            stats=stats, record=rec, **kw))
    a, c = got[:wf.N_CH, :n], plain[:wf.N_CH, :n]
    res = state_close(torch, wf, a, c)
    padding = int(((b["res_t"][4] < 0) & (b["res_t"][5] >= 0)).sum())
    # Lanes where K11 parts from its plain version, by cause: an exact
    # t-tie or a padding winner on either side of K11g's and the plain
    # record (route_differ's classes); "other" must be 0.
    differ = ((a.view(torch.int32) != c.view(torch.int32)).any(0)
              | (res_g.view(torch.int32) != rec.view(torch.int32)).any(0))
    why = route_differ(torch, wf, base[:wf.N_CH, :n], res_g, rec)
    why["other"] += int((differ & ~(res_g.view(torch.int32)
                                    != rec.view(torch.int32)).any(0)).sum())
    row = dict(
        lanes=n, alive=stats["active"], padding_winners=padding,
        lanes_differ=bits_differ(torch, a, c), plain_differ_by_cause=why,
        k11g_lanes_differ_from_k11=bits_differ(torch, out_g[:, :n], a),
        winner_lanes_differ=bits_differ(torch, res_g[:7], rec[:7]),
        verdict_lanes_differ=int((res_g[7] != rec[7]).sum()),
        lanes_differ_from_split=bits_differ(torch, a, split[:wf.N_CH, :n]),
        winner_lanes_differ_from_k6=bits_differ(torch, res_g[:7],
                                                 b["res_t"][:7]),
        verdict_lanes_differ_from_k9=int((res_g[7] != blocked9).sum()),
        k11_ms=ms, k11g_ms=ms_g, plain_ms=p_ms,
        nodes_per_lane=stats.get("nodes", 0) / n,
        blocks_swept_per_lane=stats.get("blocks", 0) / max(stats["active"],
                                                            1),
        blocks_culled_per_lane=stats.get("culled_blocks", 0)
        / max(stats["active"], 1),
        shadow_nodes_per_ray=stats["shadow_nodes"] / max(stats["shadow"], 1),
        **res)
    label = f"K11 at bounce {k}, precull={precull}"
    check_state(res, label)
    check(why["other"] == 0, f"{label}: {why} lanes differ from the plain "
                             "K11 but at no tie or padding winner")
    check(row["k11g_lanes_differ_from_k11"] == 0,
          f"{label}: K11g's state differs from K11's")
    check(row["winner_lanes_differ"] == 0,
          f"{label}: K11g's winners differ from the plain record's")
    check(row["verdict_lanes_differ"] <= (1.0 - MIN_CLOSE) * n,
          f"{label}: {row['verdict_lanes_differ']} verdicts differ")
    if padding == 0:
        check(row["lanes_differ_from_split"] == 0,
              f"{label}: {row['lanes_differ_from_split']} lanes differ from "
              f"the split bounce")
    return row, dict(stats=stats, ms=min(ms), ms_g=min(ms_g), p_ms=p_ms,
                     res_g=res_g, err=res["max_abs_err"])


def k6m_case(torch, wf, t, stc, b, cslot, bctr, boxes, reps, label):
    """K6m on one bounce's stream, on per-row lists made from it, culling
    by the leaf ``boxes`` as the render runs it: its residual against the
    plain K6m with the same boxes (bit for bit) and against the plain
    unculled sweep (``cull_differ``: ties and box edges counted, no other
    lane), and against K6's list mode.  Returns (row, residual, lists,
    numbers)."""
    block, prims, n, st = stc["block"], t["prims"], b["n"], b["st"]
    lob, hib = wf._leaf_block_bounds(prims.reshape(-1, 5, block))
    cand, ctn = wf.precull_tiles(
        tuple(st[c, :n] for c in range(3)),
        tuple(st[c, :n] for c in range(3, 6)), st[wf.C_ALIVE, :n], None,
        lob, hib, per_row=True)
    ms6 = [cuda_ms(torch, lambda: wf.isect_mxu(
        prims, cslot, bctr, cand, ctn, st, n, block=block, boxes=boxes))[1]
        for _ in range(reps)]
    res = wf.isect_mxu(prims, cslot, bctr, cand, ctn, st, n, block=block,
                       boxes=boxes)
    s6, s6u = {}, {}
    with torch.inference_mode():
        res_p, p6_ms = cuda_ms(torch, lambda: wf.isect_mxu_plain(
            prims, cslot, bctr, cand, ctn, st, n, block=block, boxes=boxes,
            stats=s6))
        res_u = wf.isect_mxu_plain(prims, cslot, bctr, cand, ctn, st, n,
                                   block=block, stats=s6u)
    alive = max(s6["alive"], 1)
    why = cull_differ(torch, wf, st[:, :n], res_u, res, boxes)
    row = dict(lanes=n, alive=s6["alive"],
               lanes_differ=bits_differ(torch, res, res_p),
               hits=int((res[4] >= 0).sum()),
               lanes_differ_from_unculled=why,
               winner_lanes_differ_from_k6=bits_differ(
                   torch, res[:7], b["res"][:7]),
               rows_candidates=float(cand[:, :, 0].double().mean()),
               tile_candidates=float(b["cand"][:, 0, 0].double().mean()),
               blocks_swept_per_lane=s6["blocks"] / alive,
               blocks_culled_per_lane=s6["culled_blocks"] / alive,
               unculled_blocks_per_lane=s6u["blocks"] / alive,
               k6m_ms=ms6, plain_ms=p6_ms)
    check(row["lanes_differ"] == 0,
          f"K6m {label}: {row['lanes_differ']} residual lanes differ")
    check(row["hits"] > 0, f"K6m {label}: no hit")
    check(why["other"] == 0, f"K6m {label}: {why} lanes part from the "
                             "unculled sweep at no tie, box edge or padding "
                             "winner")
    return row, res, (lob, hib), dict(s6=s6, s6u=s6u, n=n, ms6=min(ms6),
                                      p6_ms=p6_ms)


def k6m_k7m_case(torch, wf, t, stc, meta, b, k, sky, cslot, bctr, boxes,
                 reps):
    """K6m and K7m on one config-5 bounce, on per-row lists made from its
    stream, against their plain versions (``k6m_case``; K7m's state at
    K1's bar) and against K6 and K7."""
    block, prims, n, st = stc["block"], t["prims"], b["n"], b["st"]
    row6, res, (lob, hib), nums6 = k6m_case(
        torch, wf, t, stc, b, cslot, bctr, boxes, reps, f"at bounce {k}")
    nls = stc["n_light_slots"]
    so3, sd3, stmax, sneed = wf.shadow_rays(
        st[:, :n], b["ids"][:, :n], res, t["blob"], t["lsb"], nls, k=k,
        seed=BIG_SEED, n_mats=stc["n_mats"], mtypes=stc["mtypes"],
        n_light_slots=nls)
    scand, sctn = wf.precull_tiles(so3, sd3, sneed, stmax, lob, hib,
                                   per_row=True)
    sray = torch.stack([*so3, *sd3, stmax, sneed])
    kw = dict(k=k, block=block, n_mats=stc["n_mats"], n_light_slots=nls,
              rr_depth=RR, use_nee=True, use_mis=True, sky_mode=sky)
    args = (t["blob"], meta, t["lsb"], prims, cslot, bctr, t["mtypes"], scand,
            sctn)
    base = b["buf"].clone()
    got = base.clone()
    # K7m as the render launches it (its verdict pass, then K7b's kernel
    # on the verdicts), then each launch alone.
    res_k7, res_p7 = res.clone(), res.clone()
    ms7, msv, msb = [], [], []
    for _ in range(reps):
        got.copy_(base)
        ms7.append(cuda_ms(torch, lambda: wf.shade_mxu(
            *args, *stream_of(torch, wf, got), res_k7, n, sray=sray,
            **kw))[1])
    verdict, verdict_p = (torch.full((n,), -1.0, device=st.device)
                          for _ in range(2))
    for _ in range(reps):
        msv.append(cuda_ms(torch, lambda: wf.mxu_verdicts(
            prims, cslot, bctr, scand, sctn, sray, verdict, n,
            block=block))[1])
    bounce_only = base.clone()
    for _ in range(reps):
        bounce_only.copy_(base)
        msb.append(cuda_ms(torch, lambda: wf.shade(
            t["blob"], meta, t["lsb"], prims, t["mtypes"], None, None,
            *stream_of(torch, wf, bounce_only), res_k7, n,
            blocked_in_res=True, **kw))[1])
    plain, plain_b, k7 = base.clone(), base.clone(), base.clone()
    s7, sv, sb = {}, {}, {}
    with torch.inference_mode():
        _, p7_ms = cuda_ms(torch, lambda: wf.shade_mxu_plain(
            *args, *stream_of(torch, wf, plain), res_p7, n, sray=sray,
            stats=s7, **kw))
        _, pv_ms = cuda_ms(torch, lambda: wf.mxu_verdicts_plain(
            prims, cslot, bctr, scand, sctn, sray, verdict_p, n, block=block,
            stats=sv))
        _, pb_ms = cuda_ms(torch, lambda: wf.shade_plain(
            t["blob"], meta, t["lsb"], prims, t["mtypes"], None, None,
            *stream_of(torch, wf, plain_b), res_p7, n, blocked_in_res=True,
            stats=sb, **kw))
    wf.shade(t["blob"], meta, t["lsb"], prims, t["mtypes"], b["scand"],
             b["sctn"], *stream_of(torch, wf, k7), b["res"], n, **kw)
    a, c = got[:wf.N_CH, :n], plain[:wf.N_CH, :n]
    res7 = state_close(torch, wf, a, c)
    row7 = dict(lanes=n, lanes_differ=bits_differ(torch, a, c),
                lanes_differ_from_k7=bits_differ(torch, a, k7[:wf.N_CH, :n]),
                verdicts_differ=int((verdict != verdict_p).sum()),
                render_verdicts_differ=int((res_k7[7] != res_p7[7]).sum()),
                bounce_only_lanes_differ=bits_differ(
                    torch, bounce_only[:wf.N_CH, :n], a),
                shadow_rays=s7["shadow"],
                shadow_blocks_per_ray=s7["shadow_blocks"]
                / max(s7["shadow"], 1), k7m_ms=ms7, verdict_pass_ms=msv,
                bounce_ms=msb, plain_ms=p7_ms, verdict_pass_plain_ms=pv_ms,
                bounce_plain_ms=pb_ms, **res7)
    check_state(res7, f"K7m at bounce {k}")
    check(row7["verdicts_differ"] == 0 and row7["render_verdicts_differ"] == 0,
          f"K7m's verdict pass at bounce {k}: {row7['verdicts_differ']} / "
          f"{row7['render_verdicts_differ']} verdicts differ from the plain "
          "pass's")
    check(row7["bounce_only_lanes_differ"] == 0,
          f"K7m at bounce {k}: its bounce alone parts from the entry's")
    return row6, row7, dict(nums6, s7=s7, sv=sv, sb=sb, ms7=min(ms7),
                            msv=min(msv), msb=min(msb), p7_ms=p7_ms,
                            pv_ms=pv_ms, pb_ms=pb_ms,
                            err=res7["max_abs_err"])


def run_fused_phases(torch, T, mk, dev, card, k3) -> dict:
    """K11, K11g, K6m and K7m against their plain versions on config-5
    bounces (1920x1080 x 2 spp, bounces 0 and 1), K10 on K11g's record,
    their timing, and the main paths that run them at config 5 (1920x1080
    x 4 spp, both skies): the fused render with the precull and with the
    walk and the matmul-form render against the split render, and one
    backward of the fused gradient against the split one.  Returns the
    launch counts of the main paths and the kernels line's numbers."""
    from spt_tpu_torch.diff import cuda_diff, gradients as G
    from spt_tpu_torch.kernels import _build, megakernel_bvh as mb
    from spt_tpu_torch.kernels import wavefront as wf
    from spt_tpu_torch.kernels import wavefront_grad as wg

    out = {}
    sd10, cam10 = k3["sd10"], k3["cam10"]
    sky = sd10.sky_mode
    t, stc, meta = wf_inputs(torch, wf, mb, sd10, cam10, BIG_SEED)
    block = stc["block"]
    uniform_bytes = 4 * (t["blob"].numel() + t["lsb"].numel() + meta.numel()
                         + stc["n_mats"])
    tree_words = sum(t[k].numel() for k in ("nodef", "nodei", "prims"))
    bctr, cslot = wf.mxu_tables(t, block)
    boxes = wf.leaf_boxes(*wf._leaf_block_bounds(
        t["prims"].reshape(-1, 5, block)))
    scene_env = scene_10k(T)
    scene_env.set_environment_map(env_gradient())
    sd_env = scene_env.compile(device=dev)

    # 33. K11, K11g (with either nearest hit), K6m and K7m on config-5
    # bounces 0 and 1, each against its plain version ------------------
    b = wf_bounce(torch, wf, t, stc, meta, BIG_W, BIG_H, 0, BIG_SEED)
    n0 = b["n"]
    nums = {}
    for k in (0, 1):
        if k:
            b = wf_advance(torch, wf, t, stc, meta, b, 0, BIG_SEED, sky)
        reps = 3 if k == 0 else 1
        for precull in (True, False):
            row, nums[k, precull] = k11_case(torch, wf, wg, t, stc, meta, b,
                                             k, precull, sky, reps, boxes)
            emit(dict(phase="k11_vs_plain", case=f"config5_bounce{k}",
                      precull=precull, **row))
        row6, row7, nums[k, "mxu"] = k6m_k7m_case(
            torch, wf, t, stc, meta, b, k, sky, cslot, bctr, boxes, reps)
        emit(dict(phase="k6m_vs_plain", case=f"config5_bounce{k}", **row6))
        emit(dict(phase="k7m_vs_plain", case=f"config5_bounce{k}", **row7))
        if k == 0:
            # K10 on K11g's record (the fused gradient's backward).
            res8, n = nums[0, True]["res_g"], b["n"]
            ctb = torch.from_numpy(np.random.default_rng(11).normal(
                size=(wf.N_CH, b["st"].shape[1])).astype(np.float32)).to(dev)
            kw10 = dict(k=0, n_mats=stc["n_mats"],
                        n_light_slots=stc["n_light_slots"], rr_depth=RR,
                        use_nee=True, use_mis=True, sky_mode=sky)
            bargs = (t["blob"], meta, t["lsb"], t["mtypes"], b["st"],
                     b["ids"], res8, ctb, n)
            row10, _ = k10_vs_plain(torch, wg, t, stc, bargs, kw10)
            emit(dict(phase="k11g_k10_vs_plain", case="config5_bounce0",
                      **row10))
            del res8, ctb
    del b
    torch.cuda.empty_cache()
    # K6m with the env map's sky (bounces 0 and 1) and on the padding
    # scene (bounce 0, 240x136), against its plain versions as above
    t_e, stc_e, meta_e = wf_inputs(torch, wf, mb, sd_env, cam10, BIG_SEED)
    bctr_e, cslot_e = wf.mxu_tables(t_e, block)
    boxes_e = wf.leaf_boxes(*wf._leaf_block_bounds(
        t_e["prims"].reshape(-1, 5, block)))
    b = wf_bounce(torch, wf, t_e, stc_e, meta_e, BIG_W, BIG_H, 0, BIG_SEED)
    for k in (0, 1):
        if k:
            b = wf_advance(torch, wf, t_e, stc_e, meta_e, b, 0, BIG_SEED,
                           wf.SKY_ENVMAP)
        row6, *_, nums[k, "mxu_env"] = k6m_case(
            torch, wf, t_e, stc_e, b, cslot_e, bctr_e, boxes_e, 1,
            f"with the env map at bounce {k}")
        emit(dict(phase="k6m_vs_plain", case=f"config5_envmap_bounce{k}",
                  **row6))
    del b, t_e
    sdpad = padding_scene(T).compile(device=dev)
    tp, stp, metap = wf_inputs(torch, wf, mb, sdpad, T.Camera.look_at(
        device=dev, **PAD_CAM), BIG_SEED)
    bctr_p, cslot_p = wf.mxu_tables(tp, block)
    boxes_p = wf.leaf_boxes(*wf._leaf_block_bounds(
        tp["prims"].reshape(-1, 5, block)))
    bp = wf_bounce(torch, wf, tp, stp, metap, 240, 136, 0, BIG_SEED)
    row6, *_ = k6m_case(torch, wf, tp, stp, bp, cslot_p, bctr_p, boxes_p, 1,
                        "on the padding scene")
    emit(dict(phase="k6m_vs_plain", case="padding_bounce0",
              padding_winners=int(((bp["res_t"][4] < 0)
                                   & (bp["res_t"][5] >= 0)).sum()), **row6))
    del bp, tp
    torch.cuda.empty_cache()
    s11, s11w, sm = nums[0, True], nums[0, False], nums[0, "mxu"]
    for key, st_, ms, p_ms, record in (("k11", s11, s11["ms"], s11["p_ms"],
                                        False),
                                       ("k11g", s11, s11["ms_g"],
                                        s11["p_ms"], True)):
        # The bound counts the culled sweep's work, what the function
        # needs; the unculled sweep's beside it.
        ops = wf.k11_op_count(st_["stats"], culled=True)
        n_bytes = wf.k11_byte_count(st_["stats"], n0, tree_words,
                                    record) + uniform_bytes
        out[key] = dict(ms=ms, plain_ms=p_ms, max_abs_err=st_["err"],
                        plain_size=f"{n0} lanes (config 5, bounce 0, "
                                   "the precull's lists, counting its "
                                   "work)",
                        fp32_ops=ops, bytes=n_bytes,
                        unculled_fp32_ops=wf.k11_op_count(st_["stats"]))
        out[key]["bound_ms"], out[key]["bound_by"] = bound(ops, n_bytes)
    walk_ops = wf.k11_op_count(s11w["stats"])
    unculled_ops = out["k11"]["unculled_fp32_ops"]
    lib = _build.load_library("wavefront")
    smem11 = 4 * (t["blob"].numel() + 8 + 6 + 3 + stc["n_mats"])
    emit(dict(phase="k11_timing", card=card, k11_ms=s11["ms"],
              k11g_ms=s11["ms_g"], k11_walk_ms=s11w["ms"],
              k11g_walk_ms=s11w["ms_g"], k11_bounce1_ms=nums[1, True]["ms"],
              k11_walk_bounce1_ms=nums[1, False]["ms"],
              k11g_bounce1_ms=nums[1, True]["ms_g"],
              k11g_walk_bounce1_ms=nums[1, False]["ms_g"],
              unculled_fp32_ops=unculled_ops,
              unculled_bound_ms=bound(unculled_ops, out["k11"]["bytes"])[0],
              fp32_ops_bounce1=wf.k11_op_count(nums[1, True]["stats"],
                                               culled=True),
              unculled_fp32_ops_bounce1=wf.k11_op_count(
                  nums[1, True]["stats"]),
              walk_fp32_ops=walk_ops,
              walk_bound_ms=bound(walk_ops, wf.k11_byte_count(
                  s11w["stats"], n0, tree_words) + uniform_bytes)[0],
              k11=dict(ptxas_of(_build.BUILD_INFO, "wavefront",
                                "bounce_kernelILb0"),
                       blocks_per_sm=lib.spt_wavefront_blocks_per_sm(
                           2, smem11)),
              k11g=dict(ptxas_of(_build.BUILD_INFO, "wavefront",
                                 "bounce_kernelILb1"),
                        blocks_per_sm=lib.spt_wavefront_blocks_per_sm(
                            7, smem11)),
              **{k: out["k11"][k] for k in ("fp32_ops", "bytes", "bound_ms",
                                            "bound_by", "plain_ms")}))
    ops6 = wf.k6m_op_count(sm["s6"], block, culled=True)
    unculled6 = wf.k6m_op_count(sm["s6"], block)
    ops6_1 = wf.k6m_op_count(nums[1, "mxu"]["s6"], block, culled=True)
    bytes6_1 = wf.k6m_byte_count(nums[1, "mxu"]["s6"], nums[1, "mxu"]["n"],
                                 block)
    bytes6 = wf.k6m_byte_count(sm["s6"], n0, block)
    ops7 = wf.k7b_op_count(sm["sb"])
    bytes7 = wf.k7b_byte_count(sm["sb"], n0) + uniform_bytes
    opsv = wf.k7mv_op_count(sm["sv"], block)
    bytesv = wf.k7mv_byte_count(dict(sm["sv"], shadow=sm["s7"]["shadow"]),
                                n0, block)
    out["k6m"] = dict(ms=sm["ms6"], plain_ms=sm["p6_ms"], max_abs_err=0.0,
                      plain_size=f"{n0} rays (config 5, bounce 0, per-row "
                                 "lists, counting its work)",
                      fp32_ops=ops6, bytes=bytes6,
                      unculled_fp32_ops=unculled6)
    # K7m's two launches, each beside its own plain step: the bounce (K7b's
    # kernel on the verdicts) and the verdict pass.
    out["k7m"] = dict(ms=sm["msb"], plain_ms=sm["pb_ms"],
                      max_abs_err=max(sm["err"], nums[1, "mxu"]["err"]),
                      plain_size=f"{n0} rays (config 5, bounce 0, the "
                                 "verdicts read, counting its work)",
                      fp32_ops=ops7, bytes=bytes7)
    out["k7mv"] = dict(ms=sm["msv"], plain_ms=sm["pv_ms"], max_abs_err=0.0,
                       plain_size=f"{n0} rays (config 5, bounce 0, per-row "
                                  "shadow lists, counting its work)",
                       fp32_ops=opsv, bytes=bytesv)
    for key, ops, n_bytes in (("k6m", ops6, bytes6), ("k7m", ops7, bytes7),
                              ("k7mv", opsv, bytesv)):
        out[key]["bound_ms"], out[key]["bound_by"] = bound(ops, n_bytes)
    emit(dict(phase="k6m_k7m_timing", card=card, k6m_ms=sm["ms6"],
              k7m_ms=sm["ms7"], k6m_bounce1_ms=nums[1, "mxu"]["ms6"],
              k6m_envmap_ms=nums[0, "mxu_env"]["ms6"],
              k6m_envmap_bounce1_ms=nums[1, "mxu_env"]["ms6"],
              k6m_unculled_fp32_ops=unculled6,
              k6m_unculled_bound_ms=bound(unculled6, bytes6)[0],
              k6m_fp32_ops_bounce1=ops6_1, k6m_bytes_bounce1=bytes6_1,
              k6m_bound_bounce1=bound(ops6_1, bytes6_1),
              k6m_unculled_fp32_ops_bounce1=wf.k6m_op_count(
                  nums[1, "mxu"]["s6"], block),
              k7m_bounce1_ms=nums[1, "mxu"]["ms7"],
              k7m_verdict_pass_ms=sm["msv"], k7m_bounce_ms=sm["msb"],
              k7m_verdict_pass_bounce1_ms=nums[1, "mxu"]["msv"],
              k7m_bounce_bounce1_ms=nums[1, "mxu"]["msb"],
              k7m_plain_ms=sm["p7_ms"],
              k6m=dict(ptxas_of(_build.BUILD_INFO, "wavefront",
                                "isect_mxu_kernel"),
                       blocks_of_128_per_sm=lib
                       .spt_wavefront_isect_mxu_blocks_per_sm(block),
                       **{k: out["k6m"][k] for k in (
                           "fp32_ops", "bytes", "bound_ms", "bound_by")}),
              k7m=dict(ptxas_of(_build.BUILD_INFO, "wavefront",
                                "shade_kernelILb1ELb1E"),
                       blocks_per_sm=lib.spt_wavefront_blocks_per_sm(
                           6, smem11 - 32),
                       **{k: out["k7m"][k] for k in (
                           "fp32_ops", "bytes", "bound_ms", "bound_by")}),
              k7mv=dict(ptxas_of(_build.BUILD_INFO, "wavefront",
                                 "mxu_verdict_kernel"),
                        blocks_per_sm=lib
                        .spt_wavefront_mxu_verdicts_blocks_per_sm(block),
                        **{k: out["k7mv"][k] for k in (
                            "fp32_ops", "bytes", "bound_ms", "bound_by")})))
    # K7b's kernel as K7m's bounce (on K7m's verdicts), its build
    emit(dict(phase="k7b_timing", card=card, case="as K7m's bounce",
              bounce0_ms=sm["msb"], bounce1_ms=nums[1, "mxu"]["msb"],
              **ptxas_of(_build.BUILD_INFO, "wavefront",
                         "shade_kernelILb1ELb1E"),
              blocks_per_sm=lib.spt_wavefront_blocks_per_sm(
                  6, smem11 - 32)))
    del nums, s11, s11w, sm
    torch.cuda.empty_cache()

    # 34. Main paths: render_wavefront(split=False), with the precull and
    # with the walk, and render_wavefront(mxu=True) on config 5 at
    # 1920x1080 x 4 spp, with its sky and with the env map, counted, each
    # against the split render of the same samples; the stage times of
    # each on the gradient sky ----------------------------------------
    kw = dict(max_bounces=DEPTH, rr_depth=RR, seed=BIG_SEED)
    out["launches"] = {m: {k: 0 for k in mk.LAUNCHES}
                       for m in ("fused", "mxu")}
    want_k = {"fused": ("k5", "k11"), "fused_walk": ("k5", "k11"),
              "mxu": ("k5", "k6m", "k7m", "k7mv")}
    for label, sd in (("config5", sd10), ("config5_envmap", sd_env)):
        t0 = time.perf_counter()
        split_img = wf.render_wavefront(sd, cam10, BIG_W, BIG_H, 0, BIG_SPP,
                                        **kw)
        torch.cuda.synchronize()
        split_s = time.perf_counter() - t0
        for mode, opts in FUSED_MODES:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            mk.reset_launch_counts()
            t0 = time.perf_counter()
            img = wf.render_wavefront(sd, cam10, BIG_W, BIG_H, 0, BIG_SPP,
                                      **opts, **kw)
            torch.cuda.synchronize()
            wall_s = time.perf_counter() - t0
            counts = dict(mk.LAUNCHES)
            peak = torch.cuda.max_memory_allocated() / 1e9
            a, c = img.cpu().numpy(), split_img.cpu().numpy()
            differ = int((a != c).any(-1).sum())
            close = float((np.abs(a - c) < 1e-4 + 1e-3 * np.abs(c)).mean())
            mean_rel = abs(float(a.mean()) - float(c.mean())) / float(
                c.mean())
            row = dict(phase=f"{mode.split('_')[0]}_main_path", case=label,
                       mode=mode, size=f"{BIG_W}x{BIG_H}", spp=BIG_SPP,
                       wall_s=wall_s, split_wall_s=split_s,
                       peak_memory_gb=peak, launches=counts,
                       pixels_differ_from_split=differ,
                       frac_close_to_split=close,
                       mean_rel_to_split=mean_rel, mean=float(img.mean()))
            if label == "config5":
                times = {}
                t0 = time.perf_counter()
                wf._render(sd, cam10, BIG_W, BIG_H, 0, BIG_SPP, times=times,
                           **opts, **kw)
                row.update(wall_ms_synced=1e3 * (time.perf_counter() - t0),
                           stage_ms={k: sum(v) for k, v in times.items()})
            emit(row)
            check(all(counts[k] > 0 for k in want_k[mode]),
                  f"{label} {mode}: {want_k[mode]} not all launched")
            check(all(v == 0 for k, v in counts.items()
                      if k not in want_k[mode]),
                  f"{label} {mode}: other kernels or plain versions ran: "
                  f"{counts}")
            check(bool(np.isfinite(a).all()) and a.mean() > 0.01,
                  f"{label} {mode}: image not finite or black")
            if mode == "mxu":
                check(mean_rel <= MAX_MEAN_REL and close >= MXU_MIN_CLOSE,
                      f"{label} mxu: {close:.5f} close to the split render, "
                      f"means {mean_rel:.2e} apart")
            else:
                check(differ == 0, f"{label} {mode}: {differ} pixels differ "
                                   "from the split render")
            for k, v in counts.items():
                out["launches"][mode.split("_")[0]][k] += v
        del split_img, img

    def fused_again():
        wf.render_wavefront(sd10, cam10, BIG_W, BIG_H, 0, BIG_SPP,
                            split=False, **kw)

    prof = profiled(torch, fused_again, "bounce_kernel")
    emit(dict(phase="fused_main_path_profile", case="config5", **prof))

    # 35. Main path: one backward of sum(ct * image) through
    # make_wavefront_render_fn(split=False) at config 5 (1920x1080 x 4
    # spp), counted, against the split gradient ---------------------------
    ct_big = ct_image(torch, dev, BIG_W, BIG_H)
    runs = {}
    for split in (True, False):
        mb._PACK_CACHE.clear()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        mk.reset_launch_counts()
        t0 = time.perf_counter()
        render = wg.make_wavefront_render_fn(
            sd10, cam10, BIG_W, BIG_H, spp=BIG_SPP, max_bounces=DEPTH,
            rr_depth=RR, seed=BIG_SEED, split=split)
        params = {k: v.clone().requires_grad_(True) for k, v in
                  G.get_params(sd10, cuda_diff.PARAM_KEYS).items()}
        img = render(params, 0)
        (img * ct_big).sum().backward()
        torch.cuda.synchronize()
        runs[split] = dict(wall_s=time.perf_counter() - t0,
                           peak=torch.cuda.max_memory_allocated() / 1e9,
                           counts=dict(mk.LAUNCHES), img=img.detach(),
                           grads={k: p.grad for k, p in params.items()})
        del render, params, img
    fused, split = runs[False], runs[True]
    errs, g_err = tail_field_errors(fused["grads"], split["grads"])
    counts = fused["counts"]
    emit(dict(phase="fused_grad_main_path", case="config5",
              size=f"{BIG_W}x{BIG_H}", spp=BIG_SPP, depth=DEPTH,
              forward_backward_wall_s=fused["wall_s"],
              split_forward_backward_wall_s=split["wall_s"],
              peak_memory_gb=fused["peak"], split_peak_memory_gb=split["peak"],
              launches=counts,
              pixels_differ_from_split=int((fused["img"] != split["img"])
                                           .any(-1).sum()),
              grad_max_abs_err=g_err, grad=errs))
    want = ("k5", "k11g", "k10")
    check(all(counts[k] > 0 for k in want), f"fused grad: {counts}")
    check(all(v == 0 for k, v in counts.items() if k not in want),
          f"fused grad: other kernels or plain versions ran: {counts}")
    check(all(e["ok"] for e in errs.values()), f"fused grad vs split {errs}")
    check(all(bool(torch.isfinite(g).all()) for g in fused["grads"].values()),
          "fused grad: not finite")
    out["launches"]["fused_grad"] = counts
    del runs, fused, split
    torch.cuda.empty_cache()
    return out


# The applications and the reference integrator: the CLI renderer on the
# repo's scene files and on scenes saved with ``save_scene``, the
# inverse-render demo at its defaults, and the facade's "reference"
# integrator.  The CLI renders in chunks of CLI_CHUNK spp.
CLI_CHUNK = 32
# An RGBE (.hdr) value lies within 1/128 of its pixel's largest channel.
RGBE_REL = 1.0 / 128.0 + 1e-3
# The JAX parity bar of the reference integrator
# (tests/test_reference_parity.py): every value within 2e-3, and 99.5% of
# pixels within 1e-4 on every channel.
REF_ATOL, REF_TIGHT, REF_MIN_TIGHT = 2e-3, 1e-4, 0.995


def read_png_rgb8(path):
    """(H, W, 3) uint8 of an 8-bit RGB PNG whose rows all use filter 0, as
    the port's PNG writers (native and pure Python) write them."""
    import struct
    import zlib
    with open(path, "rb") as f:
        buf = f.read()
    check(buf[:8] == b"\x89PNG\r\n\x1a\n", f"{path}: no PNG signature")
    pos, idat, w, h = 8, b"", 0, 0
    while pos < len(buf):
        (n,) = struct.unpack(">I", buf[pos:pos + 4])
        tag, data = buf[pos + 4:pos + 8], buf[pos + 8:pos + 8 + n]
        if tag == b"IHDR":
            w, h, depth, ctype = struct.unpack(">IIBB", data[:10])
            check(depth == 8 and ctype == 2, f"{path}: not 8-bit RGB")
        elif tag == b"IDAT":
            idat += data
        pos += 12 + n
    raw = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, 1 + 3 * w)
    check(bool((raw[:, 0] == 0).all()), f"{path}: a row filter is not 0")
    return raw[:, 1:].reshape(h, w, 3)


def facade_of(T, dev, path):
    """The facade's image of a scene file: ``load_scene``, then
    ``render_to_completion`` in CLI_CHUNK-spp chunks, the CLI's loop."""
    from spt_tpu_torch.io.scene_json import load_scene
    scene, camera, settings = load_scene(path, device=dev)
    tracer = T.create_path_tracer("cuda", device=dev)
    tracer.set_scene(scene)
    tracer.set_settings(settings)
    if camera is not None:
        tracer.set_camera(camera)
    tracer.render_to_completion(chunk_spp=CLI_CHUNK)
    return tracer.get_render_result().image_f32.cpu().numpy()


def ref_parity(got, want):
    """The reference integrator's parity numbers of two (H, W, 3) frames."""
    got, want = got.cpu().numpy(), want.cpu().numpy()
    err = np.abs(got - want)
    return dict(max_abs_err=float(err.max()),
                frac_tight=float(np.all(err < REF_TIGHT, axis=-1).mean()),
                mean=float(want.mean()), finite=bool(np.isfinite(got).all()))


def check_ref(res, label):
    check(res["finite"], f"{label}: not finite")
    check(res["max_abs_err"] <= REF_ATOL,
          f"{label}: {res['max_abs_err']} above {REF_ATOL}")
    check(res["frac_tight"] > REF_MIN_TIGHT,
          f"{label}: {res['frac_tight']} of pixels within {REF_TIGHT}")
    check(res["mean"] > 0.01, f"{label}: the frame is black")


def run_app_phases(torch, T, mk, dev, card) -> dict:
    """The CLI (``cli_main_path``, scene files, profile, a fresh process),
    the inverse-render app (``inverse_main_path``) and the reference
    integrator (``reference_main_path``).  Each run through an entry point
    starts with every launch count at 0 and is read right after."""
    import glob
    import gzip
    import os
    import tempfile
    from spt_tpu_torch.apps import inverse_render, render_cli
    from spt_tpu_torch.engine import integrator
    from spt_tpu_torch.io import exr, hdr, native_display
    from spt_tpu_torch.io.image import to_uint8, write_image
    from spt_tpu_torch.io.scene_json import save_scene

    root = os.path.dirname(os.path.abspath(__file__))
    cornell_json = os.path.join(root, "scenes", "cornell.json")
    demo_json = os.path.join(root, "scenes", "demo38.json")
    launches = {}
    with tempfile.TemporaryDirectory() as tmp:
        def out(name):
            return os.path.join(tmp, name)

        def cli(args, label, quiet=True):
            stats = {}
            mk.reset_launch_counts()
            code = render_cli.main(
                args + ["--chunk", str(CLI_CHUNK)] + (["-q"] if quiet else []),
                stats=stats)
            counts = dict(mk.LAUNCHES)
            check(code == 0, f"{label}: the CLI exited {code}")
            return stats, counts

        def others(counts, *keys):
            return sum(v for k, v in counts.items() if k not in keys)

        # 1. Cornell at the file's settings, uninterrupted; resumed; the
        # facade; the image formats.
        full, launches["cli"] = cli([cornell_json, "-o", out("full.npy")],
                                    "cornell")
        img = np.load(out("full.npy"))
        t_half = time.perf_counter()
        half, c_half = cli([cornell_json, "-o", out("half.npy"), "--spp",
                            "128", "--checkpoint", out("state.npz")],
                           "cornell to 128 spp")
        resumed, c_res = cli([cornell_json, "-o", out("resumed.npy"),
                              "--resume", out("state.npz")],
                             "cornell resumed")
        resume_wall = time.perf_counter() - t_half
        got = np.load(out("resumed.npy"))
        resume_close = bool(np.allclose(got, img, rtol=1e-6, atol=1e-7))
        resume_differ = int((got != img).sum())
        facade_differ = int((facade_of(T, dev, cornell_json) != img).sum())
        formats = {}
        image_f32 = full["tracer"].get_render_result().image_f32
        for ext in ("png", "npy", "hdr", "exr"):
            path = out(f"cornell.{ext}")
            write_image(path, image_f32)
            if ext == "png":
                formats["png_values_differ"] = int(
                    (read_png_rgb8(path) != to_uint8(img)).sum())
            elif ext == "npy":
                formats["npy_values_differ"] = int((np.load(path) != img)
                                                   .sum())
            elif ext == "exr":
                formats["exr_values_differ"] = int(
                    (exr.read_exr(path) != img).sum())
            else:
                rel = np.abs(hdr.read_hdr(path) - img) / np.maximum(
                    img.max(-1, keepdims=True), 1e-9)
                formats["hdr_max_rel_err"] = float(rel.max())
        emit(dict(phase="cli_main_path", scene="scenes/cornell.json",
                  size=f"{img.shape[1]}x{img.shape[0]}",
                  spp=full["tracer"].frame_count, chunk_spp=CLI_CHUNK,
                  launches=launches["cli"], chunk_s=full["chunk_s"],
                  wall_s=full["total_s"], resume_wall_s=resume_wall,
                  resume_launches=dict(half=c_half["k1"], resumed=c_res["k1"]),
                  resumed_from=half["tracer"].frame_count,
                  resume_close=resume_close,
                  resume_values_differ=resume_differ,
                  facade_values_differ=facade_differ,
                  native_display=native_display.available(),
                  mean=float(img.mean()), **formats))
        check(full["tracer"].frame_count == SPP and img.shape == (H, W, 3),
              "cornell: spp or shape")
        check(launches["cli"]["k1"] == SPP // CLI_CHUNK
              and others(launches["cli"], "k1") == 0,
              f"cornell: launches {launches['cli']}")
        check(c_half["k1"] == 4 and c_res["k1"] == 4,
              "the resumed run did not continue at 128 spp")
        check(resume_close, "the resumed render is not the uninterrupted one")
        check(facade_differ == 0,
              f"cornell: {facade_differ} values differ from the facade")
        check(formats["png_values_differ"] == 0
              and formats["npy_values_differ"] == 0
              and formats["exr_values_differ"] == 0, f"formats {formats}")
        check(formats["hdr_max_rel_err"] < RGBE_REL, "hdr beyond RGBE")
        check(bool(np.isfinite(img).all()) and img.mean() > 0.01,
              "cornell image")

        # 2. More scene files: demo38 (K1); scene_200 through save_scene
        # (K3); config 5 with its environment map through save_scene (the
        # .envmap.hdr beside it; the wavefront).
        files = []
        p200 = out("scene200.json")
        s = T.RenderSettings()
        s.set_resolution(W, H)
        s.samples_per_pixel, s.max_bounces, s.seed = 16, DEPTH, SEED
        save_scene(p200, scene_200(T), T.Camera.look_at(
            (0, 2.0, -4.0), (0, 1.0, 14.0), fov_degrees=60, aperture=0.3,
            focus_dist=14.0, device=dev), s)
        p5 = out("config5.json")
        t0 = time.perf_counter()
        sc5 = scene_10k(T)
        sc5.set_environment_map(env_gradient())
        s = T.RenderSettings()
        s.set_resolution(BIG_W, BIG_H)
        s.samples_per_pixel, s.max_bounces, s.seed = BIG_SPP, DEPTH, BIG_SEED
        save_scene(p5, sc5, T.Camera.look_at(device=dev, **CAM_10K), s)
        save5_s = time.perf_counter() - t0
        check(os.path.exists(p5 + ".envmap.hdr"), "no .envmap.hdr written")
        for key, label, path, route in (
                ("cli_demo38", "demo38", demo_json, ("k1",)),
                ("cli_bvh", "scene_200 saved", p200, ("k3",)),
                ("cli_envmap", "config5 env map saved", p5,
                 ("k5", "k6", "k7"))):
            stats, counts = cli([path, "-o", out("scene.npy")], label)
            got = np.load(out("scene.npy"))
            differ = int((facade_of(T, dev, path) != got).sum())
            launches[key] = counts
            files.append(dict(scene=label, size=f"{got.shape[1]}x"
                              f"{got.shape[0]}",
                              spp=stats["tracer"].frame_count,
                              launches=counts, chunk_s=stats["chunk_s"],
                              wall_s=stats["total_s"],
                              facade_values_differ=differ,
                              mean=float(got.mean())))
            check(all(counts[k] > 0 for k in route)
                  and others(counts, *route) == 0,
                  f"{label}: launches {counts}")
            check(differ == 0, f"{label}: {differ} values differ from the "
                               "facade")
            check(bool(np.isfinite(got).all()) and got.mean() > 0.01,
                  f"{label}: image")
        emit(dict(phase="cli_scene_files", files=files,
                  config5_build_and_save_s=save5_s))

        # 3. A profiled run: the trace names the chunk span and K1.
        pdir = out("profile")
        prof, c_prof = cli([cornell_json, "-o", out("prof.png"), "--spp",
                            "32", "--profile", pdir], "profile", quiet=False)
        traces = glob.glob(os.path.join(pdir, "*.pt.trace.json*"))
        check(len(traces) == 1, f"profile: {len(traces)} trace files")
        opener = gzip.open if traces[0].endswith(".gz") else open
        with opener(traces[0], "rt") as f:
            text = f.read()
        occ = prof["occupancy"]
        emit(dict(phase="cli_profile", trace_bytes=len(text),
                  names_chunk_span="render_chunk_0" in text,
                  names_k1="megakernel_fwd_kernel" in text,
                  occupancy_per_bounce=occ, launches=c_prof,
                  wall_s=prof["total_s"]))
        check("render_chunk_0" in text and "megakernel_fwd_kernel" in text,
              "profile: the trace lacks the chunk span or K1")
        check(len(occ) == DEPTH and all(0.0 <= x <= 1.0 for x in occ)
              and all(a >= b for a, b in zip(occ, occ[1:])),
              f"profile: occupancy {occ}")

        # 4. A fresh process through ``python -m``.
        t0 = time.perf_counter()
        r = subprocess.run(
            [sys.executable, "-m", "spt_tpu_torch.apps.render_cli",
             "scenes/cornell.json", "-o", out("fresh.png"), "--spp", "16"],
            cwd=root, capture_output=True, text=True, timeout=600)
        fresh_s = time.perf_counter() - t0
        emit(dict(phase="cli_fresh_process", returncode=r.returncode,
                  wall_s=fresh_s, last_line=r.stdout.strip()[-200:]))
        check(r.returncode == 0, f"fresh process: {r.stderr[-2000:]}")
        read_png_rgb8(out("fresh.png"))

    # 5. The inverse-render app at its defaults (K1 forward, K2 backward).
    stats = {}
    mk.reset_launch_counts()
    t0 = time.perf_counter()
    code = inverse_render.main([], stats=stats)
    wall = time.perf_counter() - t0
    launches["inverse"] = dict(mk.LAUNCHES)
    losses = stats.get("losses", [])
    step_ms = sorted(1e3 * x for x in stats.get("step_s", []))
    emit(dict(phase="inverse_main_path", spheres=32, size="96x72", spp=8,
              target_spp=64, steps=len(losses),
              launches=launches["inverse"],
              first_loss=losses[0] if losses else None,
              last_loss=losses[-1] if losses else None,
              loss_before=stats.get("loss_before"),
              loss_after=stats.get("loss_after"),
              err_start=stats.get("err_start"), err_end=stats.get("err_end"),
              step_ms_median=step_ms[len(step_ms) // 2] if step_ms else None,
              step_ms_mean=sum(step_ms) / len(step_ms) if step_ms else None,
              wall_s=wall))
    check(code == 0 and len(losses) == 200, "inverse app")
    check(launches["inverse"]["k1"] > 0 and launches["inverse"]["k2"] == 200
          and launches["inverse"]["plain"] == 0,
          f"inverse app launches {launches['inverse']}")
    # A step's loss is over fresh samples, whose noise at 8 spp outweighs
    # the parameters' error (on an H100: first 0.02316, last 0.02323 while
    # the albedo error fell 29%); the loss of the start and of the result
    # on the same 16 samples is held instead.
    check(bool(np.isfinite(losses).all())
          and stats["loss_after"] < stats["loss_before"],
          "the inverse app's loss did not fall")

    # 6. The reference integrator through the facade on the card; frames
    # 0 and 3 against the same function on the CPU; one frame of scene_200
    # through the BVH walk.
    tracer = T.create_path_tracer("cuda")
    tracer.set_scene(T.demo_scene_38_spheres())
    s = T.RenderSettings()
    s.set_resolution(W, H)
    s.integrator = "reference"
    tracer.set_settings(s)
    mk.reset_launch_counts()
    t0 = time.perf_counter()
    for _ in range(8):
        tracer.render()
    img = tracer.get_render_result().image_f32
    torch.cuda.synchronize()
    frames_s = time.perf_counter() - t0
    launches["reference"] = dict(mk.LAUNCHES)
    sd_c = T.demo_scene_38_spheres().compile(device=dev)
    sd_h = T.demo_scene_38_spheres().compile(device="cpu")
    frame_ms = min(cuda_ms(torch, lambda: integrator.render_reference_sample(
        sd_c, W, H, 5))[1] for _ in range(3))
    frames = {}
    for f in (0, 3):
        frames[f] = ref_parity(
            integrator.render_reference_sample(sd_c, W, H, f),
            integrator.render_reference_sample(sd_h, W, H, f))
    sd_c = scene_200(T).compile(device=dev, use_bvh=True)
    sd_h = scene_200(T).compile(device="cpu", use_bvh=True)
    got, bvh_ms = cuda_ms(torch, lambda: integrator.render_reference_sample(
        sd_c, 128, 128, 0))
    bvh = ref_parity(got, integrator.render_reference_sample(sd_h, 128, 128,
                                                             0))
    emit(dict(phase="reference_main_path", scene="demo38", size=f"{W}x{H}",
              frames=tracer.frame_count, wall_s=frames_s,
              ms_per_frame=1e3 * frames_s / 8, frame_ms_cuda_events=frame_ms,
              launches=launches["reference"], mean=float(img.mean()),
              vs_cpu=frames, bvh_scene_200=dict(size="128x128", frame_ms=bvh_ms,
                                                nodes=sd_c.bvh.n_nodes, **bvh)))
    check(tracer.frame_count == 8 and tuple(img.shape) == (H, W, 3),
          "reference: frames or shape")
    check(bool(torch.isfinite(img).all()) and float(img.mean()) > 0.01,
          "reference: image")
    check(sum(launches["reference"].values()) == 0,
          "the reference integrator launched a kernel")
    for f, res in frames.items():
        check_ref(res, f"reference frame {f}")
    check_ref(bvh, "reference scene_200 (BVH walk)")
    return dict(launches=launches)


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
