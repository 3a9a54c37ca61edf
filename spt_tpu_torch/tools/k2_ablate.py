#!/usr/bin/env python3
"""Where K2's time goes: K2 built from copies of its sources with one edit.

    python3 spt_tpu_torch/tools/k2_ablate.py [--old CSRC_DIR] [--reps N]

Times K2's headline launch (chip_smoke.py's: Cornell 512x512 x 1024 spp,
depth 8, RR 3, NEE+MIS, seed 3, a cotangent of ones) for K2 as built by
the package and for copies of ``csrc`` with one edit each (``VARIANTS``:
one copy of the block's gradient or one a lane, the adds as stores, the
replay sweeping the sphere list, no replay, no NEE adjoint, fast sin/cos,
and ``__launch_bounds__`` of (threads, blocks an SM)), built beside it with
the package's nvcc flags.  ``--old`` names the ``csrc`` directory of an
earlier K2 (for example the parent commit's, unpacked with ``git
archive``), timed as it is (``old``), with its adds as stores
(``old_stores``) and at the same launch bounds (``old_lb_*``).

Prints the card, then per build one JSON line: registers, stack and spill
bytes (``-Xptxas -v``), machine instructions (``cuobjdump``), blocks an SM
(the occupancy calculator, where the build exports it), the launch's
milliseconds (the least of ``--reps`` launches, CUDA events, builds taken
in turns), whether its image equals K1's bit for bit, and its gradient's
largest per-field relative L2 error against the package's build. Needs one CUDA card and nvcc; builds go to
spt_tpu_torch/_build/.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import shutil
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]

_ADD = "  if (v != 0.0f) atomicAdd(g + i, v);\n"   # a per-lane shared atomic
_OWN_ADD = "      for (int c = 0; c < N; ++c) row[col[c]] += v[c];\n"
_COPIES = "  int c = kThreadsGrad;\n"
_REPLAY = "bounce_vjp(sc, kept_geometry(sc, kept[k]), sink,"
_REPLAY_CALL = ("      bounce_vjp(sc, kept_geometry(sc, kept[k]), sink, "
                "kept_path(kept[k]),\n"
                "                 pid, sample, seed, k, prm.rr_depth, "
                "prm.use_nee,\n"
                "                 prm.use_mis, ct);\n")
_THREADS = "constexpr int kThreadsGrad = 128;"
_BLOCKS = "constexpr int kBlocksGrad = 4;"
_OLD_BOUNDS = "__launch_bounds__(kThreadsGrad)\n    megakernel_grad_kernel"


def _bounds(threads: int, blocks: int):
    """K2 at __launch_bounds__(threads, blocks), its shared-memory budget
    for the gradient's copies with it."""
    return [("megakernel_grad.cu", _THREADS,
             _THREADS.replace("128", str(threads))),
            ("megakernel_grad.cu", _BLOCKS, _BLOCKS.replace("4", str(blocks)))]


def _old_bounds(threads: int, blocks: int):
    return [("megakernel_grad.cu", _OLD_BOUNDS,
             _OLD_BOUNDS.replace("(kThreadsGrad)",
                                 f"(kThreadsGrad, {blocks})")),
            ("megakernel_grad.cu", _THREADS,
             _THREADS.replace("128", str(threads)))]


# tag -> [(file, old, new)] on the package's sources
VARIANTS = {
    "default": [],
    # one copy of the block's gradient for every lane, adding with shared
    # atomics, as K2 did before its copies; 32, one for each lane of a warp
    "one_copy": [("megakernel_grad.cu", _COPIES, "  int c = 1;\n")],
    "lane_copies": [("megakernel_grad.cu", _COPIES, "  int c = 32;\n")],
    # the adds as plain shared stores: a time bound only (the gradient is
    # wrong; the stores keep the adjoint from being removed)
    "stores": [("physics_adj.cuh", _OWN_ADD,
                _OWN_ADD.replace("+=", "="))],
    # the replay sweeps the sphere list again for the nearest hit and the
    # shadow test instead of reading the recorded ones
    "sweep_replay": [("megakernel_grad.cu", _REPLAY,
                      "bounce_vjp(sc, SphereList{sc}, sink,")],
    # the forward sweep and its records only: the replay reads them back
    "no_replay": [("megakernel_grad.cu", _REPLAY_CALL,
                   "      ct[0] += kept[k].ox + (float)kept[k].word;\n"
                   "    sink.sky(0, ct[0]);\n")],
    # no recompute or adjoint of the light sample's contribution
    "no_nee_adjoint": [("physics_adj.cuh", "    if (lit) {\n",
                        "    if (false) {\n")],
    # the replay's sin/cos by the hardware approximation (a time probe:
    # its recompute no longer has the forward's bits)
    "fast_sincos": [("physics_adj.cuh", "    cphi = cosf(phi);\n"
                     "    sphi = sinf(phi);\n",
                     "    cphi = __cosf(phi);\n    sphi = __sinf(phi);\n"),
                    ("physics_adj.cuh",
                     "const float cpl = cosf(phil), spl = sinf(phil);",
                     "const float cpl = __cosf(phil), spl = __sinf(phil);")],
    # the replay's sin and cos of one angle by one sincosf
    "sincosf": [("physics_adj.cuh", "    cphi = cosf(phi);\n"
                 "    sphi = sinf(phi);\n",
                 "    sincosf(phi, &sphi, &cphi);\n"),
                ("physics_adj.cuh",
                 "const float cpl = cosf(phil), spl = sinf(phil);",
                 "float cpl, spl;\n    sincosf(phil, &spl, &cpl);")],
    **{f"lb_{t}_{b}": _bounds(t, b)
       for t, b in ((128, 2), (128, 3), (128, 5), (64, 4))},
}
# tag -> [(file, old, new)] on an earlier K2's sources (--old)
OLD_VARIANTS = {
    "old": [],
    "old_stores": [("physics_adj.cuh", _ADD, "  if (v != 0.0f) g[i] = v;\n")],
    **{f"old_lb_{t}_{b}": _old_bounds(t, b)
       for t, b in ((128, 2), (128, 3), (64, 4))},
}


def sass_instructions(lib: Path, kernel="megakernel_grad_kernel"):
    """Machine instructions of ``kernel`` in a built library (cuobjdump
    -sass), or None where the toolkit has no cuobjdump."""
    tool = Path(_nvcc()).with_name("cuobjdump")
    if not tool.exists():
        return None
    text = subprocess.run([str(tool), "-sass", str(lib)], capture_output=True,
                          text=True).stdout
    count, inside = 0, False
    for line in text.splitlines():
        if "Function :" in line:
            inside = kernel in line
        elif inside and re.search(r"/\*[0-9a-f]{4,}\*/\s", line):
            count += 1
    return count


def _nvcc():
    from spt_tpu_torch.kernels import _build
    return _build.find_nvcc()


def ptxas(lines, kernel="megakernel_grad_kernel"):
    """Registers, stack and spill bytes of ``kernel`` from -Xptxas -v."""
    out, entry, props = {}, False, False
    for line in lines:
        if "Compiling entry function" in line:
            entry = props = kernel in line
        elif "Function properties for" in line:
            props = kernel in line
        elif props and "stack frame" in line:
            w = line.split()
            out.update(stack_bytes=int(w[0]), spill_store_bytes=int(w[4]),
                       spill_load_bytes=int(w[8]))
        elif entry and "registers" in line:
            out["registers"] = int(line.split("Used")[1].split()[0])
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--old", type=Path, default=None,
                    help="csrc directory of an earlier K2 to time beside")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--only", nargs="*", default=None,
                    help="build and time only these variants")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("k2_ablate: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    import spt_tpu_torch as T
    from spt_tpu_torch.kernels import _build, megakernel as mk
    from spt_tpu_torch.kernels.megakernel import _f32

    t0 = time.perf_counter()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    print(card, flush=True)
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = [(tag, _build.CSRC, edits) for tag, edits in VARIANTS.items()]
    if args.old is not None:
        jobs += [(tag, args.old, edits) for tag, edits in OLD_VARIANTS.items()]
    if args.only:
        jobs = [j for j in jobs if j[0] in args.only or j[0] == "default"]

    def build(job):
        tag, csrc, edits = job
        src = _build.BUILD_DIR / f"k2_{tag}"
        shutil.rmtree(src, ignore_errors=True)
        shutil.copytree(csrc, src)
        for name, old, new in edits:
            text = (src / name).read_text()
            if text.count(old) != 1:
                raise RuntimeError(f"{tag}: {name} has no single {old!r}")
            (src / name).write_text(text.replace(old, new))
        out = _build.BUILD_DIR / f"libk2_{tag}.so"
        proc = subprocess.run([_build.find_nvcc(), *_build.NVCC_FLAGS, "-o",
                               str(out), str(src / "megakernel_grad.cu")],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"{tag}: nvcc failed\n{proc.stderr}")
        lib = ctypes.CDLL(str(out))
        for fn, argtypes in _build.ENTRIES["megakernel_grad"].items():
            if hasattr(lib, fn):
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
        return tag, lib, dict(
            ptxas((proc.stdout + proc.stderr).splitlines()),
            sass_instructions=sass_instructions(out))

    with ThreadPoolExecutor(len(jobs)) as pool:
        builds = list(pool.map(build, jobs))
    k1_sass = sass_instructions(_build.build("megakernel"),
                                "megakernel_fwd_kernel")
    print(json.dumps(dict(phase="build", seconds=time.perf_counter() - t0,
                          k1_sass_instructions=k1_sass)), flush=True)

    dev = torch.device("cuda")
    sd = cs.cornell(T).compile(device=dev)
    cam = T.Camera.look_at(device=dev, **dict(
        position=(0, 1.0, -1.5), target=(0, 1.0, 3.0), fov_degrees=55))
    blob, meta, lsb, static = mk.pack_uniforms(sd, cam, 0, cs.SEED)
    W, H, spp = cs.W, cs.H, cs.K2_SPP
    kw = dict(width=W, height=H, spp=spp, max_bounces=cs.DEPTH,
              rr_depth=cs.RR, use_nee=True, use_mis=True,
              sky_mode=sd.sky_mode, dof=False, **static)
    ones = torch.ones(H, W, 3, device=dev)
    n_grad = 12 * static["n_prims"] + 6

    def launch(lib):
        img = torch.empty(H, W, 3, device=dev)
        gvec = torch.zeros(n_grad, device=dev)
        err = lib.spt_megakernel_grad(
            img.data_ptr(), gvec.data_ptr(), blob.data_ptr(),
            meta.data_ptr(), lsb.data_ptr(), ones.data_ptr(), W, H, spp,
            static["n_prims"], static["n_light_slots"], cs.DEPTH, cs.RR, 1,
            1, sd.sky_mode, 0, ctypes.c_float(_f32(1.0 / W)),
            ctypes.c_float(_f32(1.0 / H)), ctypes.c_float(_f32(W / H)),
            torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"K2 launch failed: CUDA error {err}")
        return img, gvec

    k1 = mk.megakernel_fwd(blob, meta, lsb, **kw)
    first = {tag: launch(lib) for tag, lib, _ in builds}   # also a warm-up
    torch.cuda.synchronize()
    ref = first["default"][1]
    times = {tag: [] for tag, _, _ in builds}
    for _ in range(args.reps):                  # builds in turns
        for tag, lib, _ in builds:
            times[tag].append(cs.cuda_ms(torch, lambda: launch(lib))[1])
    for tag, lib, regs in builds:
        img, gvec = first[tag]
        if hasattr(lib, "spt_megakernel_grad_blocks_per_sm"):
            regs["blocks_per_sm"] = lib.spt_megakernel_grad_blocks_per_sm(
                static["n_prims"], static["n_light_slots"])
        errs, _ = cs.grad_errors(gvec, ref, static["n_prims"])
        rel = [e["rel"] for e in errs if e["rel"] is not None]
        print(json.dumps(dict(
            variant=tag, card=card, size=W, spp=spp, ms=min(times[tag]),
            ms_all=times[tag], image_equals_k1=bool(torch.equal(img, k1)),
            grad_max_rel_vs_default=max(rel) if rel else None, **regs)),
            flush=True)
    print(json.dumps(dict(seconds=time.perf_counter() - t0)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
