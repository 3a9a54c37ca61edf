#!/usr/bin/env python3
"""K3 built other ways, held against its plain version.

    python3 spt_tpu_torch/tools/k3_build_bits.py [--size WxH] [--spp N]
        [--only TAG ...] [--timeout SECONDS]

Renders BASELINE config 5 (chip_smoke.scene_10k, 1920x1080 unless
``--size``, 1 spp unless ``--spp``) with the plain K3 and with K3 built
several ways: the port's own flags (``_build.NVCC_FLAGS``, ``default``);
the same with ``-Xptxas -O0`` or ``-Xcicc -O0``; as PTX only
(``code=compute_90a``), which the driver's own compiler turns into machine
code when the library loads; and from copies of the sources with one edit
that keeps what the kernel computes (the bounce called, a ``__noinline__``
``bvh_bounce``, as the one-thread-a-pixel K3 and the first K4 had it,
also at ``-Xptxas -O0``; the shadow walk not inlined), or, for
``no_shadow_test``, with the shadow test removed, held against a plain
version whose shadow walk never blocks.  For each case (depth 8 with
NEE+MIS, depth 8 without NEE, depth 3, and Russian roulette from bounce 0)
it prints one JSON line with the number of pixels where each build's image
differs from its plain one at all, and whether two launches of the build
agree; then each build's time for the first case (min of 3 launches, CUDA
events).  Each build runs in a process of its own, given ``--timeout``
seconds: a build whose launch faults or does not end is reported so
(``faulted``, ``hung``) and the others go on.  Needs one CUDA card and
nvcc; builds go to spt_tpu_torch/_build/.
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
_INLINED = "        trace_bounce(sc, geo, p,"
_OCCLUDED = ("  __device__ __forceinline__ bool occluded(float ox, float oy, "
             "float oz,\n")
_SHADOW = ("    bool blocked = geo.occluded(pox, poy, poz, ldx, ldy, ldz, "
           "t_l - 1e-3f);")
# K3's bounce called as a __noinline__ function, as the one-thread-a-pixel
# K3 and the first K4 called it.
_KERNEL = "template <bool kCount>\n__global__"
_CALLED = """template <bool kRecord>
__device__ __noinline__ void bvh_bounce(const SceneView& sc,
                                        const BvhWalk<kRecord>& geo, Path& p,
                                        uint32_t pid, uint32_t sample,
                                        uint32_t seed, int k, int rr_depth,
                                        bool use_nee, bool use_mis) {
  trace_bounce(sc, geo, p, pid, sample, seed, k, rr_depth, use_nee, use_mis);
}

"""
_BOUNCE_CALLED = [
    ("megakernel_bvh.cu", _KERNEL, _CALLED + _KERNEL),
    ("megakernel_bvh.cu", _INLINED, _INLINED.replace("trace_bounce",
                                                     "bvh_bounce"))]
# tag -> (extra nvcc flags, None for PTX only), [(file, old, new)]
VARIANTS = {
    "default": ([], []),
    "ptxas_O0": (["-Xptxas", "-O0"], []),
    "cicc_O0": (["-Xcicc", "-O0"], []),
    "driver_jit": (None, []),
    "bounce_called": ([], _BOUNCE_CALLED),
    "bounce_called_O0": (["-Xptxas", "-O0"], _BOUNCE_CALLED),
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


def _lib_path(tag: str) -> Path:
    from spt_tpu_torch.kernels import _build
    return _build.BUILD_DIR / f"libk3_{tag}.so"


def build(tag: str):
    """Build variant ``tag`` -> (tag, ptxas register lines)."""
    from spt_tpu_torch.kernels import _build
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
    proc = subprocess.run([_build.find_nvcc(), *flags, "-o",
                           str(_lib_path(tag)),
                           str(src / "megakernel_bvh.cu")],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(proc.stderr)
    return tag, [ln.strip() for ln in (proc.stdout + proc.stderr).splitlines()
                 if "registers" in ln]


def _inputs(torch, size: str, spp: int):
    import chip_smoke as cs
    import spt_tpu_torch as T
    from spt_tpu_torch.kernels import megakernel_bvh as mb
    dev = torch.device("cuda")
    sd = cs.scene_10k(T).compile(device=dev)
    cam = T.Camera.look_at(device=dev, **cs.CAM_10K)
    args, k3kw, _ = cs.k3_inputs(torch, mb, sd, cam, cs.BIG_SEED)
    w, h = (int(v) for v in size.split("x"))
    return args, dict(width=w, height=h, spp=spp,
                      sky_mode=sd.sky_mode, dof=False, **k3kw)


def run_build(tag: str, plain_dir: Path, size: str, spp: int) -> dict:
    """One build's launches, in a process of its own: per case the pixels
    that differ from the plain images in ``plain_dir``, whether two
    launches agree, and the first case's time."""
    import torch
    import chip_smoke as cs
    from spt_tpu_torch.kernels import _build, megakernel_bvh as mb
    lib = ctypes.CDLL(str(_lib_path(tag)))
    for fn, argtypes in _build.ENTRIES["megakernel_bvh"].items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int
    args, kw0 = _inputs(torch, size, spp)
    row = {}
    for i, c in enumerate(CASES):
        kw = dict(kw0, **c)
        got = mb.launch(lib, *args, **kw)
        again = mb.launch(lib, *args, **kw)
        torch.cuda.synchronize()
        want = torch.load(plain_dir / f"{i}{'_ns' * (tag == 'no_shadow_test')}"
                          ".pt").to(got.device)
        m = (got != want).any(-1).reshape(-1)
        idx = torch.nonzero(m)[:, 0].tolist()
        row[f"case{i}"] = dict(
            pixels=len(idx), first=[(q // kw["width"], q % kw["width"])
                                    for q in idx[:4]],
            twice_equal=bool(torch.equal(got, again)))
        if i == 0:
            row["ms"] = min(cs.cuda_ms(torch, lambda: mb.launch(
                lib, *args, **kw))[1] for _ in range(3))
    return row


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--timeout", type=float, default=240.0,
                    help="seconds a build's process may take (else: hung)")
    ap.add_argument("--size", default=None,
                    help="WxH (default chip_smoke's 1920x1080)")
    ap.add_argument("--spp", type=int, default=1)
    ap.add_argument("--only", nargs="*", default=None,
                    help="build and run only these variants")
    ap.add_argument("--build", nargs=2, default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("k3_build_bits: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    if args.size is None:
        import chip_smoke as cs
        args.size = f"{cs.BIG_W}x{cs.BIG_H}"
    if args.build:           # TAG PLAIN_DIR: one build's launches
        print(json.dumps(run_build(args.build[0], Path(args.build[1]),
                                   args.size, args.spp)))
        return 0
    tags = [t for t in VARIANTS if args.only is None or t in args.only]
    from spt_tpu_torch.kernels import _build, megakernel_bvh as mb

    t0 = time.perf_counter()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with ThreadPoolExecutor(len(tags)) as pool:
        ptxas = dict(pool.map(build, tags))
    print(json.dumps(dict(card=card, ptxas=ptxas)), flush=True)

    # The plain images, once, for every build's process to load.
    plain_dir = _build.BUILD_DIR / "k3_plain_images"
    shutil.rmtree(plain_dir, ignore_errors=True)
    plain_dir.mkdir(parents=True)
    in_args, kw0 = _inputs(torch, args.size, args.spp)
    walk_anyhit = mb._Walk.anyhit
    with torch.inference_mode():
        for i, c in enumerate(CASES):
            kw = dict(kw0, **c)
            torch.save(mb.render_tiles_bvh_plain(*in_args, **kw).cpu(),
                       plain_dir / f"{i}.pt")
            mb._Walk.anyhit = lambda self, o, d, tmax, need: (
                torch.zeros_like(need), 0, 0)
            try:
                torch.save(mb.render_tiles_bvh_plain(*in_args, **kw).cpu(),
                           plain_dir / f"{i}_ns.pt")
            finally:
                mb._Walk.anyhit = walk_anyhit

    for tag in tags:
        row = dict(variant=tag)
        try:
            proc = subprocess.run([sys.executable, __file__, "--build", tag,
                                   str(plain_dir), "--size", args.size,
                                   "--spp", str(args.spp)],
                                  capture_output=True,
                                  text=True, timeout=args.timeout)
        except subprocess.TimeoutExpired:
            row["hung"] = True
        else:
            if proc.returncode != 0:
                row.update(faulted=True,
                           log=(proc.stdout + proc.stderr)[-800:])
            else:
                row.update(json.loads(proc.stdout.strip().splitlines()[-1]))
        print(json.dumps(row), flush=True)
    print(json.dumps(dict(cases=CASES, size=args.size, spp=args.spp,
                          seconds=time.perf_counter() - t0)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
