#!/usr/bin/env python3
"""K3 built other ways, held against its plain version.

    python3 spt_tpu_torch/tools/k3_build_bits.py

Renders BASELINE config 5 (chip_smoke.scene_10k, 1920x1080, 1 spp) with the
plain K3 and with K3 built several ways: the port's own flags
(``_build.NVCC_FLAGS``); the same with ``-Xptxas -O0`` or ``-Xcicc -O0``;
as PTX only (``code=compute_90a``), which the driver's own compiler turns
into machine code when the library loads; and from copies of the sources
with one edit that keeps what the kernel computes (the bounce inlined into
the sample loop, as K3 had it first; the shadow walk not inlined), or, for
``no_shadow_test``, with the shadow test removed, held against a plain
version whose shadow walk never blocks.  For each case (depth 8 with
NEE+MIS, depth 8 without NEE, depth 3, and Russian roulette from bounce 0)
it prints one JSON line with the number of pixels where each build's image
differs from its plain one at all, and whether two launches of the default
build agree; then each build's time for the first case (min of 3
launches, CUDA events).  Needs one CUDA card and nvcc; builds go to
spt_tpu_torch/_build/.
"""

from __future__ import annotations

import ctypes
import json
import shutil
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
_BOUNCE = "__device__ __noinline__ void bvh_bounce("
_OCCLUDED = ("  __device__ __forceinline__ bool occluded(float ox, float oy, "
             "float oz,\n")
_SHADOW = ("    bool blocked = geo.occluded(pox, poy, poz, ldx, ldy, ldz, "
           "t_l - 1e-3f);")
# tag -> (extra nvcc flags, None for PTX only), [(file, old, new)]
VARIANTS = {
    "ptxas_O0": (["-Xptxas", "-O0"], []),
    "cicc_O0": (["-Xcicc", "-O0"], []),
    "driver_jit": (None, []),
    "bounce_inlined": ([], [("bvh.cuh", _BOUNCE, _BOUNCE.replace(
        "__noinline__", "__forceinline__"))]),
    "occluded_noinline": ([], [("bvh.cuh", _OCCLUDED,
                                _OCCLUDED.replace("__forceinline__",
                                                  "__noinline__"))]),
    "no_shadow_test": ([], [("physics.cuh", _SHADOW,
                             "    bool blocked = false;")]),
}
CASES = [dict(max_bounces=8, rr_depth=3, use_nee=True, use_mis=True),
         dict(max_bounces=8, rr_depth=3, use_nee=False, use_mis=False),
         dict(max_bounces=3, rr_depth=3, use_nee=True, use_mis=True),
         dict(max_bounces=8, rr_depth=0, use_nee=True, use_mis=True)]


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("k3_build_bits: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    import spt_tpu_torch as T
    from spt_tpu_torch.kernels import _build, megakernel_bvh as mb
    from spt_tpu_torch.kernels.megakernel import _f32

    t0 = time.perf_counter()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)

    def build(tag):
        extra, edits = VARIANTS[tag]
        src = _build.CSRC
        if edits:
            src = _build.BUILD_DIR / f"k3_{tag}"
            shutil.rmtree(src, ignore_errors=True)
            shutil.copytree(_build.CSRC, src)
            for name, old, new in edits:
                text = (src / name).read_text()
                if text.count(old) != 1:
                    raise RuntimeError(f"{tag}: {name} has no single {old!r}")
                (src / name).write_text(text.replace(old, new))
        flags = list(_build.NVCC_FLAGS)
        if extra is None:             # PTX only: the driver compiles it
            flags[flags.index("arch=compute_90a,code=sm_90a")] = \
                "arch=compute_90a,code=compute_90a"
        else:
            flags += extra
        out = _build.BUILD_DIR / f"libk3_{tag}.so"
        proc = subprocess.run([_build.find_nvcc(), *flags, "-o", str(out),
                               str(src / "megakernel_bvh.cu")],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(proc.stderr)
        return tag, out, [ln.strip() for ln in
                          (proc.stdout + proc.stderr).splitlines()
                          if "registers" in ln]

    with ThreadPoolExecutor(len(VARIANTS) + 1) as pool:
        default = pool.submit(_build.build, "megakernel_bvh")
        builds = list(pool.map(build, VARIANTS))
    libs = {tag: ctypes.CDLL(str(out)) for tag, out, _ in builds}
    print(json.dumps(dict(card=card, ptxas={t: u for t, _, u in builds},
                          default=str(default.result().name))), flush=True)

    dev = torch.device("cuda")
    sd = cs.scene_10k(T).compile(device=dev)
    cam = T.Camera.look_at(device=dev, **cs.CAM_10K)
    args, k3kw, st = cs.k3_inputs(torch, mb, sd, cam, cs.BIG_SEED)
    W, H = cs.BIG_W, cs.BIG_H
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float

    def launch(lib, c):
        out = torch.empty(H, W, 3, device=dev)
        err = lib.spt_megakernel_bvh_fwd(
            P(out.data_ptr()), *(P(a.data_ptr()) for a in args), I(W), I(H),
            I(1), I(st["n_nodes"]), I(k3kw["block"]), I(k3kw["n_mats"]),
            I(k3kw["n_light_slots"]), I(c["max_bounces"]), I(c["rr_depth"]),
            I(int(c["use_nee"])), I(int(c["use_mis"])), I(sd.sky_mode), I(0),
            F(_f32(1.0 / W)), F(_f32(1.0 / H)), F(_f32(W / H)),
            P(torch.cuda.current_stream().cuda_stream))
        torch.cuda.synchronize()
        if err != 0:
            raise RuntimeError(f"K3 launch failed: CUDA error {err}")
        return out

    def differ(a, b):
        m = (a != b).any(-1).reshape(-1)
        idx = torch.nonzero(m)[:, 0].tolist()
        return dict(pixels=len(idx), first=[(q // W, q % W) for q in idx[:4]])

    def plain_without_shadow_test(kw):
        walk_anyhit = mb._Walk.anyhit
        mb._Walk.anyhit = lambda self, o, d, tmax, need: (
            torch.zeros_like(need), 0, 0)
        try:
            return mb.render_tiles_bvh_plain(*args, **kw)
        finally:
            mb._Walk.anyhit = walk_anyhit

    with torch.inference_mode():
        for c in CASES:
            kw = dict(width=W, height=H, spp=1, sky_mode=sd.sky_mode,
                      dof=False, **c, **k3kw)
            plain = mb.render_tiles_bvh_plain(*args, **kw)
            k3 = mb.megakernel_bvh_fwd(*args, **kw)
            again = mb.megakernel_bvh_fwd(*args, **kw)
            res = dict(case=c, default=differ(k3, plain),
                       default_twice_equal=bool(torch.equal(k3, again)))
            for tag, lib in libs.items():
                want = plain_without_shadow_test(kw) \
                    if tag == "no_shadow_test" else plain
                res[tag] = differ(launch(lib, c), want)
            print(json.dumps(res), flush=True)

        def ms(fn):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            return start.elapsed_time(end)

        kw = dict(width=W, height=H, spp=1, sky_mode=sd.sky_mode, dof=False,
                  **CASES[0], **k3kw)
        times = {"default": min(ms(lambda: mb.megakernel_bvh_fwd(
            *args, **kw)) for _ in range(3))}
        for tag, lib in libs.items():
            times[tag] = min(ms(lambda: launch(lib, CASES[0]))
                             for _ in range(3))
        print(json.dumps(dict(case=CASES[0], spp=1, ms=times)), flush=True)
    print(json.dumps(dict(seconds=time.perf_counter() - t0)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
