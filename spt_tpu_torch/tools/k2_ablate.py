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

    python3 spt_tpu_torch/tools/k2_ablate.py --k4 [--old CSRC_DIR]
        [--reps N] [--only TAG ...] [--timeout SECONDS]

does the same for K4, the fused BVH backward (``K4_VARIANTS`` on the
package's sources: launch bounds, equal winners merged before grad_g's
atomics, the warp sums' adds as stores, the regenerating loop;
``K4_OLD_VARIANTS`` on an earlier K4's: the bounce inlined, the sink's
adds as stores, K2's per-thread copies, grad_g's atomics merged within a
warp, launch bounds).  Its launches: K4's main one (chip_smoke.py's
gradient path: config 5 cut to 2,000 spheres, 1920x1080 x 4 spp, seed
5), the padding scene (240x136 x 2 spp) and a ragged thin-lens one
(scene_200, 100x37 x 3 spp from sample 7).  The parent process renders
each with the package's K3 and the plain K4 and saves them; each build
then runs in a process of its own (``faulted``, ``hung`` past
``--timeout``), the reference build first and again last, and prints its
registers, stack, spills, blocks an SM, the main launch's milliseconds
(least of ``--reps``), the values of each image that differ from K3's
and its gradients' errors against the plain K4 (chip_smoke's
``tail_field_errors``).  Last, the lanes busy in the forward sweep and
the replay of one thread a pixel, from the plain K3's path lengths
(sample 0 of the main launch; ``megakernel.lanes_busy``).
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
                    help="csrc directory of an earlier K2 (K4) to time beside")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--only", nargs="*", default=None,
                    help="build and time only these variants")
    ap.add_argument("--k4", action="store_true",
                    help="K4, the fused BVH backward, in place of K2")
    ap.add_argument("--timeout", type=float, default=300.0,
                    help="seconds a K4 build's process may take (else: hung)")
    # --time-k4 TAG REF_DIR: one K4 build's launches (time_k4)
    ap.add_argument("--time-k4", nargs=2, default=None,
                    help=argparse.SUPPRESS)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("k2_ablate: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    if args.time_k4:
        tag, ref_dir = args.time_k4
        print(json.dumps(time_k4(tag, Path(ref_dir), args.reps)))
        return 0
    if args.k4:
        return main_k4(args)
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


# ---------------------------------------------------------------------------
# K4
# ---------------------------------------------------------------------------

_K4 = "megakernel_bvh_grad.cu"
_K4_BLOCKS = "constexpr int kMinBlocksK4 = 5;"
_K4_MERGE = ("      flush_geometry<false>(key, sink.dgeo, prm.grad_g, "
             "prm.block);")
_K4_FLUSH = ("  flush_row(sink.row, sink.v, sink.row == 0 ? 6 : 8, g);\n"
             "  flush_row(sink.light_row, sink.lv, 7, g);\n")
# An earlier K4 (one thread a pixel, the called bounce, a shared atomic per
# lane and value, a global atomic per lane and winner).
_OLD_K4_BOUNDS = "__launch_bounds__(kThreadsK4)\n    megakernel_bvh_grad_kernel"
_OLD_K4_CALL = "      bvh_bounce(sc, w, p, pid, sample, seed, k,"
_OLD_K4_ZERO = ("  for (int i = threadIdx.x; i < prm.n_scal; i += blockDim.x) "
                "s_grad[i] = 0.0f;\n")
_OLD_K4_PIXEL = "    bvh_grad_pixel(prm, sc, walk, s_invalid, s_grad, x, y);\n"
_OLD_K4_OUT = ("  for (int i = threadIdx.x; i < prm.n_scal; i += blockDim.x)\n"
               "    if (s_grad[i] != 0.0f) atomicAdd(prm.grad_s + i, "
               "s_grad[i]);\n")
_OLD_K4_SMEM = "                                       3 + n_mats + prm.n_scal);\n"
_OLD_K4_FN = "__device__ __forceinline__ void bvh_grad_pixel("
_OLD_K4_REPLAY = """    for (int k = n_run - 1; k >= 0; --k) {
      const float* r = rec[k];"""
_OLD_K4_GEO = """      if (hmid >= 0.0f && hmid < (float)prm.n_mats) {
        float* g = prm.grad_g + (size_t)r[5] * 8 * prm.block + (int)r[6];
        for (int a = 0; a < 4; ++a)
          if (sink.dgeo[a] != 0.0f) atomicAdd(g + a * prm.block, sink.dgeo[a]);
      }
"""
# grad_g's atomics merged within a warp: the replay in step across the
# lanes that entered the pixel loop (from the warp's longest path down),
# lanes of one (block, slot) summed by a log-step shuffle, one atomic a
# sum.
_OLD_MERGE_FN = """__device__ __forceinline__ void merged_add(unsigned act, int key,
                                           const float (&d)[4], float* g,
                                           int block) {
  float s[4] = {d[0], d[1], d[2], d[3]};
  const unsigned lane = threadIdx.x & 31u;
  const unsigned peers = __match_any_sync(act, key);
  unsigned rank = __popc(peers & ((1u << lane) - 1u));
  unsigned above = peers & (0xFFFFFFFEu << lane);
  while (__any_sync(act, above != 0u)) {
    const int next = __ffs(above) - 1;
    for (int a = 0; a < 4; ++a) {
      const float t = __shfl_sync(act, s[a], next < 0 ? (int)lane : next);
      if (next >= 0) s[a] += t;
    }
    above &= ~__ballot_sync(act, (rank & 1u) != 0u);
    rank >>= 1;
  }
  if (key < 0 || (int)lane != __ffs(peers) - 1) return;
  for (int a = 0; a < 4; ++a)
    if (s[a] != 0.0f) atomicAdd(g + key + (size_t)a * block, s[a]);
}

"""
_OLD_MERGE_REPLAY = """    const unsigned act = __activemask();
    for (int k = __reduce_max_sync(act, n_run) - 1; k >= 0; --k) {
      int key = -1;
      float dg[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      if (k < n_run) {
      const float* r = rec[k];"""
_OLD_MERGE_GEO = """      if (hmid >= 0.0f && hmid < (float)prm.n_mats) {
        key = (int)r[5] * 8 * prm.block + (int)r[6];
        for (int a = 0; a < 4; ++a) dg[a] = sink.dgeo[a];
      }
      }
      merged_add(act, key, dg, prm.grad_g, prm.block);
"""


# K4 with regenerating paths, as K1 and K3 run (csrc/regen.cuh's loop,
# with a replay phase): a persistent grid takes 8x4-pixel batches from a
# counter; each iteration a lane runs one forward bounce or one replayed
# bounce of its path, and a lane whose replay has ended starts its
# pixel's next sample, or its warp's next pixel, in the same iteration.
# The warp sums each iteration's shares as the package's K4 does.
_K4_REGEN_KERNEL = r"""__device__ unsigned k4_next_batch;

__global__ void __launch_bounds__(kThreadsK4, kMinBlocksK4)
    megakernel_bvh_grad_regen_kernel(K4Params prm) {
  extern __shared__ float smem[];
  float* s_blob = smem;
  float* s_invalid = s_blob + prm.blob_len;
  float* s_lsb = s_invalid + kMatStride;
  int* s_meta = reinterpret_cast<int*>(s_lsb + 6);
  int* s_mtypes = s_meta + 3;
  float* s_grad = reinterpret_cast<float*>(s_mtypes + prm.n_mats);
  for (int i = threadIdx.x; i < prm.blob_len; i += blockDim.x)
    s_blob[i] = prm.blob[i];
  for (int i = threadIdx.x; i < prm.n_mats; i += blockDim.x)
    s_mtypes[i] = prm.mtypes[i];
  for (int i = threadIdx.x; i < prm.copies * prm.n_scal; i += blockDim.x)
    s_grad[i] = 0.0f;
  if (threadIdx.x < kMatStride)
    s_invalid[threadIdx.x] = threadIdx.x == kMatStride - 1 ? 1.5f : 0.0f;
  if (threadIdx.x < 6) s_lsb[threadIdx.x] = prm.lsb[threadIdx.x];
  if (threadIdx.x < 3) s_meta[threadIdx.x] = prm.meta[threadIdx.x];
  __syncthreads();
  const SceneView sc{s_blob, s_meta, s_lsb, 0, prm.n_light_slots,
                     s_meta[2], prm.sky_mode};
  const float* mats = s_blob + kMatOff;
  const BvhGeometry walk{prm.nodef, prm.nodei, prm.prims, mats, s_mtypes,
                         s_invalid, mats + kMatStride * prm.n_mats,
                         prm.n_nodes, prm.block, nullptr};
  float* grad = s_grad + ((threadIdx.x >> 5) % prm.copies) * prm.n_scal;
  const uint32_t start = (uint32_t)s_meta[0], seed = (uint32_t)s_meta[1];
  const int lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1u;
  const int tiles_x = (prm.width + 7) / 8;
  const int n_batches = tiles_x * ((prm.height + 3) / 4);
  const size_t n_ct = (size_t)prm.tiles_x * ((prm.height + kCtTile - 1) /
                                             kCtTile) * kCtTile * kCtTile;
  int batch = 0, handed = 32;
  bool exhausted = false, fwd = false, rev = false;
  int pix = -1, s = 0, k = 0, x = 0, y = 0;
  float acc_r = 0.0f, acc_g = 0.0f, acc_b = 0.0f;
  float ct_r = 0.0f, ct_g = 0.0f, ct_b = 0.0f;
  float ct[13];
  Path p;
  Kept4 kept[kMaxDepth4];
  while (true) {
    LaneSink sink{prm.n_mats};
    int key = -1;
    bool ended = false;
    const uint32_t sample = start + (uint32_t)s;
    if (fwd) {
      if (k < prm.max_bounces) {
        kept[k].p = p;
        const RecordingWalk w{walk};
        trace_bounce(sc, w, p, (uint32_t)pix, sample, seed, k, prm.rr_depth,
                     prm.use_nee, prm.use_mis);
        kept[k].slot = w.slot;
        kept[k].blocked = w.blocked;
        ++k;
      }
      if (!p.active || k >= prm.max_bounces) {
        fwd = false;
        acc_r += p.rad_r;
        acc_g += p.rad_g;
        acc_b += p.rad_b;
        for (int c = 0; c < 13; ++c) ct[c] = 0.0f;
        ct[9] = ct_r;
        ct[10] = ct_g;
        ct[11] = ct_b;
        rev = k > 0;
        ended = !rev;
        --k;
      }
    } else if (rev) {
      const Kept4& e = kept[k];
      bounce_vjp(sc, replay_geometry(prm, walk, e), sink, e.p, (uint32_t)pix,
                 sample, seed, k, prm.rr_depth, prm.use_nee, prm.use_mis,
                 ct);
      if (sink.geo)
        key = (e.slot / prm.block) * 8 * prm.block + e.slot % prm.block;
      if (--k < 0) {
        rev = false;
        ended = true;
      }
    }
    flush_scalars(sink, grad);
    flush_geometry<false>(key, sink.dgeo, prm.grad_g, prm.block);
    if (ended && ++s >= prm.spp) {
      prm.img[3 * pix + 0] = acc_r;
      prm.img[3 * pix + 1] = acc_g;
      prm.img[3 * pix + 2] = acc_b;
      pix = -1;
    }
    while (!exhausted) {
      const unsigned need = __ballot_sync(kWarpMask, pix < 0);
      if (need == 0) break;
      if (handed == 32) {
        unsigned b = 0;
        if (lane == 0) b = atomicAdd(&k4_next_batch, 1u);
        b = __shfl_sync(kWarpMask, b, 0);
        if (b >= (unsigned)n_batches) {
          exhausted = true;
          break;
        }
        batch = (int)b;
        handed = 0;
      }
      const int slot = handed + __popc(need & below);
      if (pix < 0 && slot < 32) {
        const int xx = (batch % tiles_x) * 8 + (slot & 7);
        const int yy = (batch / tiles_x) * 4 + slot / 8;
        if (xx < prm.width && yy < prm.height) {
          x = xx;
          y = yy;
          pix = y * prm.width + x;
          s = 0;
          acc_r = acc_g = acc_b = 0.0f;
          const size_t cl =
              ((size_t)(y / kCtTile) * prm.tiles_x + x / kCtTile) *
                  (kCtTile * kCtTile) +
              (y % kCtTile) * kCtTile + x % kCtTile;
          ct_r = prm.ct[cl];
          ct_g = prm.ct[n_ct + cl];
          ct_b = prm.ct[2 * n_ct + cl];
        }
      }
      handed = min(32, handed + __popc(need));
    }
    if (pix >= 0 && !fwd && !rev) {
      raygen(sc.blob, prm.inv_w, prm.inv_h, prm.aspect, prm.dof,
             (uint32_t)pix, (float)x, (float)y, start + (uint32_t)s, seed, p);
      k = 0;
      fwd = true;
    }
    if (!__any_sync(kWarpMask, fwd || rev)) break;
  }
  flush_block(s_grad, prm.copies, prm.n_scal, prm.grad_s);
}

"""
_K4_GRID = """  const dim3 grid((width + spt::kTileW4 - 1) / spt::kTileW4,
                  (height + spt::kTileH4 - 1) / spt::kTileH4);
  spt::megakernel_bvh_grad_kernel<<<grid, spt::kThreadsK4, smem,
                                    static_cast<cudaStream_t>(stream)>>>(prm);
"""
_K4_REGEN_GRID = """  int dev = 0, sms = 0, per_sm = 0;
  void* next = nullptr;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, spt::megakernel_bvh_grad_regen_kernel, spt::kThreadsK4, smem);
  cudaGetSymbolAddress(&next, spt::k4_next_batch);
  cudaMemsetAsync(next, 0, sizeof(unsigned),
                  static_cast<cudaStream_t>(stream));
  const int need = (((width + 7) / 8) * ((height + 3) / 4) + 3) / 4;
  const int grid = need < sms * per_sm ? need : sms * per_sm;
  spt::megakernel_bvh_grad_regen_kernel<<<grid, spt::kThreadsK4, smem,
      static_cast<cudaStream_t>(stream)>>>(prm);
"""


def _k4_bounds(blocks: int):
    """K4 built for ``blocks`` blocks an SM (1: the compiler's own count)."""
    return [(_K4, _K4_BLOCKS, _K4_BLOCKS.replace("5;", f"{blocks};"))]


def _old_k4_bounds(blocks: int):
    return [(_K4, _OLD_K4_BOUNDS, _OLD_K4_BOUNDS.replace(
        "(kThreadsK4)", f"(kThreadsK4, {blocks})"))]


# tag -> [(file, old, new)] on the package's K4
K4_VARIANTS = {
    "k4": [],
    # a warp sums the cotangents of lanes that share a winner before
    # grad_g's atomics, as K10 does
    "k4_merge": [(_K4, _K4_MERGE, _K4_MERGE.replace("<false>", "<true>"))],
    # the scalar gradient's warp sums dropped: each lane stores its own
    # row into its warp's copy (a time bound only; the gradient is wrong)
    "k4_stores": [("physics_adj.cuh", _K4_FLUSH,
                   "  if (sink.row >= 0)\n"
                   "    for (int a = 0; a < 8; ++a) g[sink.row + a] = "
                   "sink.v[a];\n"
                   "  if (sink.light_row >= 0)\n"
                   "    for (int a = 0; a < 7; ++a) g[sink.light_row + a] = "
                   "sink.lv[a];\n")],
    **{f"k4_lb_128_{b}": _k4_bounds(b) for b in (1, 2, 3, 4, 6)},
    # the regenerating loop, at the compiler's own bound and at 3 blocks
    "k4_regen": [(_K4, "inline int k4_blob_len(",
                  _K4_REGEN_KERNEL + "inline int k4_blob_len("),
                 (_K4, _K4_GRID, _K4_REGEN_GRID)],
    "k4_regen_lb_128_3": [(_K4, "inline int k4_blob_len(",
                           _K4_REGEN_KERNEL + "inline int k4_blob_len("),
                          (_K4, _K4_GRID, _K4_REGEN_GRID)] + _k4_bounds(3),
}
# tag -> [(file, old, new)] on an earlier K4's sources (--old)
K4_OLD_VARIANTS = {
    "old": [],
    # the bounce inlined in place of bvh.cuh's called bvh_bounce
    "old_inline": [(_K4, _OLD_K4_CALL,
                    _OLD_K4_CALL.replace("bvh_bounce", "trace_bounce"))],
    # the sink's shared atomics as plain stores (a time bound only)
    "old_stores": [("physics_adj.cuh", _ADD,
                    "  if (v != 0.0f) g[i] = v;\n")],
    # K2's per-thread copies of the scalar vector: plain adds, summed once
    # a block (stride n_scal | 1, so one entry of the copies falls in
    # distinct banks)
    "old_copies": [
        ("physics_adj.cuh", _ADD, "  if (v != 0.0f) g[i] += v;\n"),
        (_K4, _OLD_K4_ZERO, _OLD_K4_ZERO.replace(
            "i < prm.n_scal", "i < kThreadsK4 * (prm.n_scal | 1)")),
        (_K4, _OLD_K4_PIXEL, _OLD_K4_PIXEL.replace(
            "s_grad, x, y", "s_grad + threadIdx.x * (prm.n_scal | 1), x, y")),
        (_K4, _OLD_K4_OUT,
         "  for (int i = threadIdx.x; i < prm.n_scal; i += blockDim.x) {\n"
         "    float v = 0.0f;\n"
         "    for (int c = 0; c < kThreadsK4; ++c) v += "
         "s_grad[c * (prm.n_scal | 1) + i];\n"
         "    if (v != 0.0f) atomicAdd(prm.grad_s + i, v);\n"
         "  }\n"),
        (_K4, _OLD_K4_SMEM,
         "                                       3 + n_mats + spt::kThreadsK4 "
         "* (prm.n_scal | 1));\n"
         "  cudaFuncSetAttribute(spt::megakernel_bvh_grad_kernel,\n"
         "                       cudaFuncAttributeMaxDynamicSharedMemorySize,"
         "\n                       (int)smem);\n")],
    "old_merge": [(_K4, _OLD_K4_FN, _OLD_MERGE_FN + _OLD_K4_FN),
                  (_K4, _OLD_K4_REPLAY, _OLD_MERGE_REPLAY),
                  (_K4, _OLD_K4_GEO, _OLD_MERGE_GEO)],
    **{f"old_lb_128_{b}": _old_k4_bounds(b) for b in (2, 4, 5)},
}
# Appended to an earlier K4's source: its blocks an SM.
_K4_PROBE = """
extern "C" int spt_tool_blocks_per_sm(int smem) {
  int blocks = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, spt::megakernel_bvh_grad_kernel, spt::kThreadsK4, smem);
  return blocks;
}
"""
K4_MAIN = "k4_2000"


def _k4_lib(tag: str) -> Path:
    from spt_tpu_torch.kernels import _build
    return _build.BUILD_DIR / f"libk2ab_{tag}.so"


def build_k4(tag: str, csrc: Path, edits) -> tuple:
    """Copy ``csrc``, apply ``edits``, build K4 -> (tag, ptxas facts)."""
    from spt_tpu_torch.kernels import _build
    src = _build.BUILD_DIR / f"k2ab_{tag}"
    shutil.rmtree(src, ignore_errors=True)
    shutil.copytree(csrc, src)
    for name, old, new in edits:
        text = (src / name).read_text()
        if text.count(old) != 1:
            raise RuntimeError(f"{tag}: {name} has no single {old!r}")
        (src / name).write_text(text.replace(old, new))
    if "blocks_per_sm" not in (src / _K4).read_text():
        with open(src / _K4, "a") as f:
            f.write(_K4_PROBE)
    proc = subprocess.run([_build.find_nvcc(), *_build.NVCC_FLAGS, "-o",
                           str(_k4_lib(tag)), str(src / _K4)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"{tag}: nvcc failed\n{proc.stderr}")
    return tag, dict(ptxas((proc.stdout + proc.stderr).splitlines(),
                           "megakernel_bvh_grad_kernel"),
                     sass_instructions=sass_instructions(
                         _k4_lib(tag), "megakernel_bvh_grad_kernel"))


def k4_cases(torch, dev) -> dict:
    """label -> (K3's args, keywords, swizzled cotangent)."""
    import chip_smoke as cs
    import spt_tpu_torch as T
    from spt_tpu_torch.kernels import megakernel_bvh as mb
    from spt_tpu_torch.kernels import megakernel_bvh_grad as mbg
    cam10 = T.Camera.look_at(device=dev, **cs.CAM_10K)
    cam200 = T.Camera.look_at((0, 2.0, -4.0), (0, 1.0, 14.0), fov_degrees=60,
                              aperture=0.3, focus_dist=14.0, device=dev)
    out = {}
    for label, sd, cam, (w, h), spp, seed, start in (
            (K4_MAIN, cs.scene_10k(T, n=cs.K3_MAIN_SPHERES).compile(
                device=dev), cam10, (cs.BIG_W, cs.BIG_H), cs.BIG_SPP,
             cs.BIG_SEED, 0),
            ("k4_padding", cs.padding_scene(T).compile(device=dev),
             T.Camera.look_at(device=dev, **cs.PAD_CAM), (240, 136), 2,
             cs.BIG_SEED, 0),
            ("k4_ragged_thin_lens", cs.scene_200(T).compile(device=dev),
             cam200, cs.RAGGED, 3, cs.SEED, 7)):
        args, k3kw, _ = cs.k3_inputs(torch, mb, sd, cam, seed, start=start)
        kw = dict(width=w, height=h, spp=spp, max_bounces=cs.DEPTH,
                  rr_depth=cs.RR, use_nee=True, use_mis=True,
                  sky_mode=sd.sky_mode, dof=float(cam.aperture) > 0, **k3kw)
        out[label] = (args, kw, mbg.swizzle_ct(cs.ct_image(torch, dev, w, h),
                                               w, h))
    return out


def time_k4(tag: str, ref_dir: Path, reps: int) -> dict:
    """One K4 build's launches, in a process of its own: each case once,
    its image held against K3's and its gradients against the plain K4's
    (both saved by the parent), then ``reps`` timed main launches."""
    import torch
    import chip_smoke as cs
    from spt_tpu_torch.kernels import _build
    from spt_tpu_torch.kernels import megakernel_bvh_grad as mbg
    dev = torch.device("cuda")
    lib = ctypes.CDLL(str(_k4_lib(tag)))
    for fn, argtypes in _build.ENTRIES["megakernel_bvh_grad"].items():
        if hasattr(lib, fn):
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
    _build._LOADED["megakernel_bvh_grad"] = lib
    row = {}
    for label, (args, kw, ct) in k4_cases(torch, dev).items():
        img, gs, gg = mbg.megakernel_bvh_grad(*args, ct, **kw)
        torch.cuda.synchronize()
        ref = torch.load(ref_dir / f"{label}.pt")
        k3 = ref["k3"].to(dev)
        errs, _ = cs.tail_field_errors(
            cs.raw_fields(gs, gg, kw["n_mats"]),
            cs.raw_fields(ref["gs"].to(dev), ref["gg"].to(dev),
                          kw["n_mats"]))
        res = dict(values_differ_from_k3=int((img != k3).sum()),
                   pixels_differ_from_k3=int((img != k3).any(-1).sum()),
                   grad_ok=all(e["ok"] for e in errs.values()),
                   grad_worst_rel=max(
                       max(e["body_rel"] or 0.0, e["tail_rel"] or 0.0)
                       for e in errs.values()))
        if label == K4_MAIN:
            res["ms_all"] = [cs.cuda_ms(torch, lambda: mbg.megakernel_bvh_grad(
                *args, ct, **kw))[1] for _ in range(reps)]
            res["ms"] = min(res["ms_all"])
            n_mats, nls = kw["n_mats"], kw["n_light_slots"]
            if hasattr(lib, "spt_megakernel_bvh_grad_blocks_per_sm"):
                row["blocks_per_sm"] = \
                    lib.spt_megakernel_bvh_grad_blocks_per_sm(n_mats, nls)
            else:
                lib.spt_tool_blocks_per_sm.argtypes = [ctypes.c_int]
                n_scal = mbg.n_scalars(n_mats, nls)
                fixed = (args[0].numel() + 8 + 6 + 3 + n_mats)
                copies = 128 * (n_scal | 1) if tag == "old_copies" else n_scal
                row["blocks_per_sm"] = lib.spt_tool_blocks_per_sm(
                    4 * (fixed + copies))
        row[label] = res
    return row


def main_k4(args) -> int:
    """Build K4's variants, save the references, time each build in a
    process of its own, then the lanes-busy shares."""
    import torch
    import chip_smoke as cs
    from spt_tpu_torch.kernels import _build, megakernel as mk
    from spt_tpu_torch.kernels import megakernel_bvh as mb
    from spt_tpu_torch.kernels import megakernel_bvh_grad as mbg

    t0 = time.perf_counter()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    print(card, flush=True)
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = [(tag, _build.CSRC, edits) for tag, edits in K4_VARIANTS.items()]
    if args.old is not None:
        jobs += [(tag, args.old, edits)
                 for tag, edits in K4_OLD_VARIANTS.items()]
    if args.only:
        jobs = [j for j in jobs if j[0] in args.only]
    with ThreadPoolExecutor(len(jobs)) as pool:
        facts = dict(pool.map(lambda j: build_k4(*j), jobs))
    print(json.dumps(dict(phase="build", seconds=time.perf_counter() - t0,
                          builds=list(facts))), flush=True)

    # The references: the package's K3 and the plain K4, each case.
    dev = torch.device("cuda")
    ref_dir = _build.BUILD_DIR / "k2ab_refs"
    shutil.rmtree(ref_dir, ignore_errors=True)
    ref_dir.mkdir(parents=True)
    cases = k4_cases(torch, dev)
    busy = {}
    with torch.inference_mode():
        for label, (a, kw, ct) in cases.items():
            _, gs, gg = mbg.render_and_grad_bvh_plain(*a, ct, **kw)
            torch.save(dict(k3=mb.megakernel_bvh_fwd(*a, **kw).cpu(),
                            gs=gs.cpu(), gg=gg.cpu()),
                       ref_dir / f"{label}.pt")
        # One thread a pixel: a warp's lanes wait for its longest path in
        # the forward sweep and again in the replay, which runs the same
        # bounces backwards.
        a, kw, _ = cases[K4_MAIN]
        stats = {}
        mb.render_tiles_bvh_plain(*a, **dict(kw, spp=1), stats=stats)
        busy = mk.lanes_busy(stats["lengths"], (8, 4))
    del cases
    torch.cuda.empty_cache()
    print(json.dumps(dict(phase="references",
                          seconds=time.perf_counter() - t0)), flush=True)

    ref_tag = next(t for t in ("k4", "old") if t in facts)
    order = [ref_tag] + [t for t in facts if t != ref_tag] + [ref_tag]
    for n, tag in enumerate(order):
        row = dict(variant=tag, card=card, run=n, **facts[tag])
        try:
            proc = subprocess.run(
                [sys.executable, __file__, "--reps", str(args.reps),
                 "--time-k4", tag, str(ref_dir)],
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
    print(json.dumps(dict(lanes_busy=dict(
        forward=busy, replay=busy, size=f"{cs.BIG_W}x{cs.BIG_H}",
        sample=0, spheres=cs.K3_MAIN_SPHERES))), flush=True)
    print(json.dumps(dict(seconds=time.perf_counter() - t0)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
