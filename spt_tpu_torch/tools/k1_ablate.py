#!/usr/bin/env python3
"""Where K1's and K3's time goes: both built from copies of their sources
with one edit each, timed on the launches the main paths make.

    python3 spt_tpu_torch/tools/k1_ablate.py [--old CSRC_DIR] [--reps N]
        [--only TAG ...] [--timeout SECONDS]

Times, for K1 and K3 as built by the package and for copies of ``csrc``
with one edit (``VARIANTS``: ``__launch_bounds__`` of (threads, blocks an
SM) per kernel, K1's shadow test stopping at its first blocker, K3's leaf
loops stopping at a block's first padding slot; K3's bounce called as a
``__noinline__`` function is ``k3_build_bits.py``'s), these launches
(``make_cases``):

* ``k1_cornell_256``: K1's headline launch, chip_smoke.py's Cornell
  512x512 x 256 spp, depth 8, RR 3, NEE+MIS, seed 3;
* ``k1_cornell_32``, ``k1_demo38_1``: the first launch of the facade's
  Cornell render (32 spp) and of its demo38 frame (1 spp), as the facade
  makes them;
* ``k3_config5``: K3 on BASELINE config 5, 1920x1080 x 4 spp, seed 5;
* ``k3_2000``: the facade's launch on config 5 cut to 2,000 spheres;
* ``k3_padding``: chip_smoke.padding_scene, whose rays win leaf padding
  slots, 480x272 x 2 spp (bits only: where a prune could part);
* ``*_lambert``: the headline and config-5 launches with every material
  type set to Lambert (timed only: what material divergence costs).

``--old`` names the ``csrc`` directory of an earlier K1 and K3 (for example
the parent commit's, unpacked with ``git archive``), built as it is
(``old``) and with the same kinds of edit (``OLD_VARIANTS``).

Each build runs in a process of its own (a launch that faults leaves its
process's CUDA context unusable; such a build is reported ``faulted``,
one that has not ended in ``--timeout`` seconds ``hung``),
the reference build first and again last: the package's, or ``old``
where the package's is not built.  Prints the card, then per build one
JSON line: registers and spill bytes (``-Xptxas -v``), threads and blocks
an SM (the occupancy calculator), and per case the least of ``--reps``
launches' milliseconds (CUDA events, after one untimed launch) and
whether its image equals the reference build's bit for bit.  Then the
lanes-busy shares: the old design's estimated from the plain versions'
path lengths (``megakernel.lanes_busy``; samples 0-15 of the headline
launch, sample 0 of the K3 launches), and the package's counted by its
kernels (``megakernel.lane_counts``).
Needs one CUDA card and nvcc; builds go to spt_tpu_torch/_build/.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import shutil
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
KERNELS = ("megakernel", "megakernel_bvh")
# The package's launch bounds, and an earlier design's (one thread a
# pixel, the compiler's own occupancy).
_K1_BOUNDS = ("constexpr int kThreads = ", "constexpr int kMinBlocks = ")
_K3_BOUNDS = ("constexpr int kThreadsBvh = ",
              "constexpr int kMinBlocksBvh = ")
_OLD_K1 = "__launch_bounds__(kThreads) megakernel_fwd_kernel"
_OLD_K3 = "__launch_bounds__(kThreadsBvh)\n    megakernel_bvh_kernel"
# A leaf's slot loops (nearest hit and shadow test), the same text twice.
_SLOTS = ("        for (int j = 0; j < block; ++j) {\n"
          "          float tj;\n")
_PRUNE = ("        for (int j = 0; j < block; ++j) {\n"
          "          if (__ldg(pb + 4 * block + j) < 0.0f) break;\n"
          "          float tj;\n")
_OCCLUDED = ("    if (sphere_t(sc.blob + kSphOff + kSphStride * j, ox, oy, "
                 "oz, dx, dy, dz, tj)\n        && tj < tmax)\n"
                 "      blocked = true;\n")
BOUNDS = ((128, 1), (128, 2), (128, 3), (128, 4), (128, 5), (128, 6),
          (256, 1), (256, 2), (256, 3))


def _bounds(name: str, threads: int, blocks: int):
    """The package's kernel ``name`` at __launch_bounds__(threads,
    blocks): its two constants' lines as the sources have them."""
    text = (ROOT / "spt_tpu_torch" / "csrc" / f"{name}.cu").read_text()
    edits = []
    for prefix, value in zip(_K1_BOUNDS if name == "megakernel"
                             else _K3_BOUNDS, (threads, blocks)):
        line = next(ln for ln in text.splitlines() if ln.startswith(prefix))
        edits.append((f"{name}.cu", line, f"{prefix}{value};"))
    return ((name,), edits)


def _old_bounds(name: str, threads: int, blocks: int):
    bound, key = ((_OLD_K1, "kThreads") if name == "megakernel"
                  else (_OLD_K3, "kThreadsBvh"))
    return ((name,), [
        (f"{name}.cu", bound, bound.replace(f"({key})",
                                            f"({key}, {blocks})")),
        (f"{name}.cu", f"constexpr int {key} = 128;",
         f"constexpr int {key} = {threads};")])


# tag -> (kernels built, [(file, old, new)]) on the package's sources
VARIANTS = {
    "default": (KERNELS, []),
    # K1's shadow test stopping at the first blocker (the same boolean)
    "first_blocker": (("megakernel",), [
        ("physics.cuh", _OCCLUDED,
         _OCCLUDED.replace("blocked = true;", "return true;"))]),
    # K3's leaf loops stopping at the first padding slot (material id -1;
    # a block's padding slots come last)
    "pad_prune": (("megakernel_bvh",), [("bvh.cuh", _SLOTS, _PRUNE)]),
    **{f"{k}_lb_{t}_{b}": _bounds(name, t, b) for t, b in BOUNDS
       for k, name in (("k1", "megakernel"), ("k3", "megakernel_bvh"))},
}
# tag -> (kernels built, [(file, old, new)]) on an earlier design's sources
OLD_VARIANTS = {
    "old": (KERNELS, []),
    # its shadow test stopping at the first blocker (the same boolean)
    "old_first_blocker": (("megakernel",), [
        ("physics.cuh", _OCCLUDED,
         _OCCLUDED.replace("blocked = true;", "return true;"))]),
    "old_pad_prune": (("megakernel_bvh",), [("bvh.cuh", _SLOTS, _PRUNE)]),
    **{f"old_{k}_lb_{t}_{b}": _old_bounds(name, t, b)
       for t, b in ((128, 4), (128, 6), (256, 2), (256, 3))
       for k, name in (("k1", "megakernel"), ("k3", "megakernel_bvh"))},
}

# The C entries of a design that launches one thread a pixel.
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
OLD_ENTRIES = {
    "megakernel": ("spt_megakernel_fwd",
                   [_P, _P, _P, _P] + [_I] * 11 + [_F, _F, _F, _P]),
    "megakernel_bvh": ("spt_megakernel_bvh_fwd",
                       [_P] * 8 + [_I] * 13 + [_F, _F, _F, _P]),
}
# Appended to an earlier design's source: its blocks an SM.
_OLD_PROBE = """
extern "C" int spt_tool_blocks_per_sm(int threads, int smem) {
  int blocks = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, spt::%s, threads,
                                                smem);
  return blocks;
}
"""
_OLD_KERNEL = {"megakernel": "megakernel_fwd_kernel",
               "megakernel_bvh": "megakernel_bvh_kernel"}
# The production instantiation's name in ptxas' output (the counting one
# is ...ILb1E).
_NEW_KERNEL = {"megakernel": "megakernel_fwd_kernelILb0E",
               "megakernel_bvh": "megakernel_bvh_kernelILb0E"}


def _is_new(src: Path, name: str) -> bool:
    return "regen.cuh" in (src / f"{name}.cu").read_text()


def _lib_path(tag: str, name: str) -> Path:
    from spt_tpu_torch.kernels import _build
    return _build.BUILD_DIR / f"libk1ab_{tag}_{name}.so"


def build_one(tag: str, csrc: Path, edits, kernels):
    """Copy ``csrc``, apply ``edits``, build ``kernels`` with the package's
    nvcc flags -> (tag, {name: facts})."""
    from spt_tpu_torch.kernels import _build
    from spt_tpu_torch.tools.k2_ablate import ptxas
    src = _build.BUILD_DIR / f"k1ab_{tag}"
    shutil.rmtree(src, ignore_errors=True)
    shutil.copytree(csrc, src)
    for name, old, new in edits:
        text = (src / name).read_text()
        count = text.count(old)
        if count == 0 or (count > 1 and old != _SLOTS):
            raise RuntimeError(f"{tag}: {name} has no single {old!r}")
        (src / name).write_text(text.replace(old, new))
    out = {}
    for name in kernels:
        new = _is_new(src, name)
        if not new:
            with open(src / f"{name}.cu", "a") as f:
                f.write(_OLD_PROBE % _OLD_KERNEL[name])
        proc = subprocess.run([_build.find_nvcc(), *_build.NVCC_FLAGS,
                               "-o",
                               str(_lib_path(tag, name)),
                               str(src / f"{name}.cu")],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"{tag}: nvcc failed for {name}\n"
                               f"{proc.stderr}")
        kernel = (_NEW_KERNEL if new else _OLD_KERNEL)[name]
        facts = dict(ptxas((proc.stdout + proc.stderr).splitlines(), kernel),
                     design="regeneration" if new else "thread a pixel")
        if not new:
            facts["threads"] = _old_threads(tag, name)
        out[name] = facts
    return tag, out


def _old_threads(tag: str, name: str) -> int:
    """Threads a block of an earlier design's build, from its sources."""
    from spt_tpu_torch.kernels import _build
    key = "kThreads" if name == "megakernel" else "kThreadsBvh"
    text = (_build.BUILD_DIR / f"k1ab_{tag}" / f"{name}.cu").read_text()
    line = next(ln for ln in text.splitlines()
                if ln.startswith(f"constexpr int {key} ="))
    return int(line.split("=")[1].strip(" ;"))


def load_built(tag: str, name: str):
    """A build's library, its entries typed."""
    from spt_tpu_torch.kernels import _build
    lib = ctypes.CDLL(str(_lib_path(tag, name)))
    if hasattr(lib, "spt_tool_blocks_per_sm"):
        fn, argtypes = OLD_ENTRIES[name]
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int
        lib.spt_tool_blocks_per_sm.argtypes = [_I, _I]
        lib.spt_tool_blocks_per_sm.restype = ctypes.c_int
    else:
        for fn, argtypes in _build.ENTRIES[name].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
    return lib


def _old_launch(lib, name, case, torch):
    """One launch of an earlier design's kernel on a case's inputs."""
    from spt_tpu_torch.kernels.megakernel import _f32
    a, kw = case["args"], case["kw"]
    w, h = kw["width"], kw["height"]
    out = torch.empty(h, w, 3, device=a[0].device)
    floats = [ctypes.c_float(_f32(1.0 / w)), ctypes.c_float(_f32(1.0 / h)),
              ctypes.c_float(_f32(w / h))]
    flags = [int(bool(kw["use_nee"])), int(bool(kw["use_mis"])),
             int(kw["sky_mode"]), int(bool(kw["dof"]))]
    stream = torch.cuda.current_stream().cuda_stream
    if name == "megakernel":
        err = lib.spt_megakernel_fwd(
            out.data_ptr(), *(t.data_ptr() for t in a), w, h, kw["spp"],
            kw["n_prims"], kw["n_light_slots"], kw["max_bounces"],
            kw["rr_depth"], *flags, *floats, stream)
    else:
        err = lib.spt_megakernel_bvh_fwd(
            out.data_ptr(), *(t.data_ptr() for t in a), w, h, kw["spp"],
            a[3].numel() // 64, kw["block"], kw["n_mats"],
            kw["n_light_slots"], kw["max_bounces"], kw["rr_depth"], *flags,
            *floats, stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")
    return out


def _smem(name, case):
    kw = case["kw"]
    if name == "megakernel":
        return 4 * (case["args"][0].numel() + 6 + case["args"][1].numel())
    return 4 * (case["args"][0].numel() + 8 + 6 + 3 + kw["n_mats"])


def make_cases(torch, dev) -> dict:
    """The launches timed, as the package's wrappers take them: label ->
    dict(kernel, args, kw)."""
    import chip_smoke as cs
    import spt_tpu_torch as T
    from spt_tpu_torch.kernels import megakernel as mk
    from spt_tpu_torch.kernels import megakernel_bvh as mb
    cases = {}

    def capture(module, fn_name, drive):
        """The first launch's inputs of a facade render, which gets zeros
        in place of the kernel's images."""
        real, got = getattr(module, fn_name), []

        def spy(*a, **kw):
            if not got:
                got.append((a, dict(kw)))
            return torch.zeros(kw["height"], kw["width"], 3, device=dev)
        setattr(module, fn_name, spy)
        try:
            drive()
        finally:
            setattr(module, fn_name, real)
        return got[0]

    cam_cornell = dict(position=(0, 1.0, -1.5), target=(0, 1.0, 3.0),
                       fov_degrees=55)
    sd = cs.cornell(T).compile(device=dev)
    cam = T.Camera.look_at(device=dev, **cam_cornell)
    blob, meta, lsb, static = mk.pack_uniforms(sd, cam, 0, cs.SEED)
    kw = dict(width=cs.W, height=cs.H, spp=cs.SPP,
              max_bounces=cs.DEPTH, rr_depth=cs.RR, use_nee=True,
              use_mis=True, sky_mode=sd.sky_mode, dof=False, **static)
    cases["k1_cornell_256"] = dict(kernel="megakernel",
                                   args=(blob, meta, lsb), kw=kw)
    cam10 = T.Camera.look_at(device=dev, **cs.CAM_10K)
    sd10 = cs.scene_10k(T).compile(device=dev)
    a10, k3kw, _ = cs.k3_inputs(torch, mb, sd10, cam10, cs.BIG_SEED)
    kw10 = dict(width=cs.BIG_W, height=cs.BIG_H,
                spp=cs.BIG_SPP, max_bounces=cs.DEPTH,
                rr_depth=cs.RR, use_nee=True, use_mis=True,
                sky_mode=sd10.sky_mode, dof=False, **k3kw)
    cases["k3_config5"] = dict(kernel="megakernel_bvh", args=a10, kw=kw10)
    lam = meta.clone()
    lam[3:3 + static["n_prims"]] = 0
    cases["k1_cornell_256_lambert"] = dict(kernel="megakernel",
                                           args=(blob, lam, lsb), kw=kw)

    def cornell_render():
        tr = T.create_path_tracer("cuda")
        tr.set_scene(cs.cornell(T))
        tr.set_camera(T.Camera.look_at(device=dev, **cam_cornell))
        s = T.RenderSettings()
        s.set_resolution(cs.W, cs.H)
        s.samples_per_pixel = cs.SPP
        s.max_bounces, s.russian_roulette_depth = cs.DEPTH, cs.RR
        s.seed = cs.SEED
        tr.set_settings(s)
        tr.render_to_completion()

    def demo_frame():
        tr = T.create_path_tracer("cuda")
        tr.set_scene(T.demo_scene_38_spheres())
        s = T.RenderSettings()
        s.set_resolution(cs.W, cs.H)
        tr.set_settings(s)
        tr.render()

    for label, drive in (("k1_cornell_32", cornell_render),
                         ("k1_demo38_1", demo_frame)):
        a, kw = capture(mk, "megakernel_fwd", drive)
        cases[label] = dict(kernel="megakernel", args=a, kw=kw)
    lam10 = list(a10)
    lam10[6] = torch.zeros_like(a10[6])
    cases["k3_config5_lambert"] = dict(kernel="megakernel_bvh",
                                       args=tuple(lam10), kw=kw10)
    a, kw = capture(mb, "megakernel_bvh_fwd", lambda: cs.big_tracer(
        T, dev, cs.scene_10k(T, n=cs.K3_MAIN_SPHERES)).render_to_completion())
    cases["k3_2000"] = dict(kernel="megakernel_bvh", args=a, kw=kw)
    sdp = cs.padding_scene(T).compile(device=dev)
    ap_, kwp, _ = cs.k3_inputs(torch, mb, sdp,
                               T.Camera.look_at(device=dev, **cs.PAD_CAM),
                               cs.SEED)
    cases["k3_padding"] = dict(kernel="megakernel_bvh", args=ap_, kw=dict(
        width=480, height=272, spp=2, max_bounces=cs.DEPTH, rr_depth=cs.RR,
        use_nee=True, use_mis=True, sky_mode=sdp.sky_mode, dof=False, **kwp))
    return cases


def launch(lib, name, case, torch):
    """One launch of a build's kernel on a case."""
    from spt_tpu_torch.kernels import megakernel as mk
    from spt_tpu_torch.kernels import megakernel_bvh as mb
    if hasattr(lib, "spt_tool_blocks_per_sm"):
        return _old_launch(lib, name, case, torch)
    mod = mk if name == "megakernel" else mb
    return mod.launch(lib, *case["args"], **case["kw"])


def time_build(tag: str, kernels, ref_dir: Path, is_ref: bool,
               reps: int) -> dict:
    """One build's launches, in a process of its own (a launch that faults
    leaves its process's CUDA context unusable): each case launched once
    and synchronized, its image saved (``is_ref``) or held against the
    reference build's, then ``reps`` timed launches."""
    import torch
    import chip_smoke as cs
    from spt_tpu_torch.kernels import megakernel as mk
    from spt_tpu_torch.kernels import megakernel_bvh as mb
    dev = torch.device("cuda")
    libs = {name: load_built(tag, name) for name in kernels}
    row = {}
    cases = make_cases(torch, dev)
    for label, case in cases.items():
        name = case["kernel"]
        if name not in libs:
            continue
        got = launch(libs[name], name, case, torch)
        torch.cuda.synchronize()
        ref = ref_dir / f"{label}.pt"
        res = {}
        if is_ref:
            torch.save(got.cpu(), ref)
        elif ref.exists():
            want = torch.load(ref).to(dev)
            res = dict(equals_ref=bool(torch.equal(got, want)),
                       pixels_differ=int((got != want).any(-1).sum()))
        if label != "k3_padding":
            res["ms_all"] = [cs.cuda_ms(torch, lambda: launch(
                libs[name], name, case, torch))[1] for _ in range(reps)]
            res["ms"] = min(res["ms_all"])
        row[label] = res
    for name, lib in libs.items():
        case = cases["k1_cornell_256" if name == "megakernel"
                     else "k3_config5"]
        if hasattr(lib, "spt_tool_blocks_per_sm"):
            row[f"{name}_blocks_per_sm"] = lib.spt_tool_blocks_per_sm(
                _old_threads(tag, name), _smem(name, case))
        else:
            mod = mk if name == "megakernel" else mb
            row[f"{name}_launch"] = mod.launch_config(lib, dev, **{
                k: v for k, v in case["kw"].items()
                if k in ("n_prims", "n_mats", "n_light_slots")})
    return row


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--old", type=Path, default=None,
                    help="csrc directory of an earlier K1 and K3")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--only", nargs="*", default=None,
                    help="build and time only these variants")
    ap.add_argument("--timeout", type=float, default=300.0,
                    help="seconds a build's process may take (else: hung)")
    # --time TAG REF_DIR IS_REF KERNEL...: one build's launches (time_build)
    ap.add_argument("--time", nargs="+", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("k1_ablate: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    if args.time:
        tag, ref_dir, is_ref, *kernels = args.time
        print(json.dumps(time_build(tag, kernels, Path(ref_dir),
                                    is_ref == "1", args.reps)))
        return 0
    from spt_tpu_torch.kernels import _build, megakernel as mk
    from spt_tpu_torch.kernels import megakernel_bvh as mb

    t0 = time.perf_counter()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    print(card, flush=True)
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = [(tag, _build.CSRC, edits, ks)
            for tag, (ks, edits) in VARIANTS.items()]
    if args.old is not None:
        jobs += [(tag, args.old, edits, ks)
                 for tag, (ks, edits) in OLD_VARIANTS.items()]
    if args.only:
        jobs = [j for j in jobs if j[0] in args.only]
    with ThreadPoolExecutor(len(jobs)) as pool:
        facts = dict(pool.map(lambda j: build_one(*j), jobs))
    print(json.dumps(dict(phase="build", seconds=time.perf_counter() - t0,
                          builds=list(facts))), flush=True)

    # Each build in a process of its own, the reference build (the
    # package's, else the earlier design's) first and again last.
    ref_tag = "default" if "default" in facts else "old"
    ref_dir = _build.BUILD_DIR / "k1ab_images"
    shutil.rmtree(ref_dir, ignore_errors=True)
    ref_dir.mkdir(parents=True)
    order = [ref_tag] + [t for t in facts if t != ref_tag] + [ref_tag]
    for n, tag in enumerate(order):
        row = dict(variant=tag, card=card, run=n, **{
            name: f for name, f in facts[tag].items()})
        try:
            proc = subprocess.run(
                [sys.executable, __file__, "--reps", str(args.reps),
                 "--time", tag, str(ref_dir),
                 "1" if n == 0 else "0", *facts[tag]],
                capture_output=True, text=True, timeout=args.timeout)
        except subprocess.TimeoutExpired as e:
            row.update(hung=True, log=str(e.stdout)[-800:])
        else:
            if proc.returncode != 0:
                row.update(faulted=True,
                           log=(proc.stdout + proc.stderr)[-1500:])
            else:
                row.update(json.loads(proc.stdout.strip().splitlines()[-1]))
        print(json.dumps(row), flush=True)

    # Lanes busy: the old design's estimate from the plain paths' lengths,
    # and the package's count where its kernels count.
    dev = torch.device("cuda")
    cases = make_cases(torch, dev)
    busy = {}
    with torch.inference_mode():
        for label, tile, spp in (("k1_cornell_256", None, 16),
                                 ("k1_demo38_1", None, 1),
                                 ("k3_config5", (8, 4), 1),
                                 ("k3_2000", (8, 4), 1)):
            case = cases[label]
            stats = {}
            kw = dict(case["kw"], spp=spp)
            plain = (mk.render_tiles_plain if case["kernel"] == "megakernel"
                     else mb.render_tiles_bvh_plain)
            plain(*case["args"], stats=stats, **kw)
            row = dict(old_estimate=mk.lanes_busy(stats["lengths"], tile),
                       estimate_spp=spp)
            del stats
            if ref_tag == "default":
                row["counted"] = mk.lane_counts(
                    "k1" if case["kernel"] == "megakernel" else "k3",
                    *case["args"], **case["kw"])
            busy[label] = row
    print(json.dumps(dict(lanes_busy=busy)), flush=True)
    print(json.dumps(dict(seconds=time.perf_counter() - t0)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
