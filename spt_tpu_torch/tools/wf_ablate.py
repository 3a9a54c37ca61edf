#!/usr/bin/env python3
"""Where the split wavefront's time goes: K6 and K7/K9 in their forms, and
the list-building glue, at every bounce of one config-5 chunk; with
``--prim``, the same for the prim-sharded wavefront's K6 and K8.

    python3 spt_tpu_torch/tools/wf_ablate.py [--reps N] [--only TAG ...]
    python3 spt_tpu_torch/tools/wf_ablate.py --prim [--reps N] [--only ...]

Runs one chunk of BASELINE config 5 (``chip_smoke.scene_10k``: 10,000
spheres, 466 leaf blocks of 32; 1920x1080 x 2 spp, the wavefront's chunk
at its default 4M rays; depth 8, RR 3, NEE+MIS, seed 5) with its gradient
sky and with ``chip_smoke.env_gradient``'s map, the stream advanced by
K7's walk form as ``render_wavefront`` advances it.  At every bounce, on
the same inputs, it times (CUDA events, the least of ``--reps``):

* ``precull``: the tiles' candidate lists (``precull_tiles``), which only
  K6's list mode needs;
* K6 in three forms: ``k6_lists`` (the lists), ``k6_walk`` (the tree
  mode as built) and ``k6_walk_smem`` (the ``k6_smem`` build: each block
  stages its first lane's octant table in shared memory, and lanes of
  another octant read the tree from global memory);
* ``shadow``: the shadow rays rebuilt from K6's residual and culled
  (``shadow_rays`` and ``precull_tiles``), which only K7's list mode
  needs;
* K7 and K9 in two forms: ``k7_lists``, ``k9_lists`` (the shadow lists)
  and ``k7_walk``, ``k9_walk`` (the shadow walks), each on a copy of the
  stream; K7's walk form in the other ``k7_*`` builds: ``k7_lb_b``
  (``shade_kernel`` built for b blocks an SM, where the package builds it
  for ``kShadeMinBlocks``; 1 is no bound), ``k7_no_lists`` and
  ``k7_no_walk`` (no bound, and without the list sweep's branch or
  without the walk: which sets the registers the compiler takes alone;
  without the walk its shadow rays see nothing); and K6's tree mode in
  the ``k6_lb_b`` builds (``isect_kernel`` built for b blocks an SM).

It checks that ``k6_walk_smem`` equals ``k6_walk`` bit for bit, and counts
the lanes where the walk and the list routes part: K6's winners (each
differing lane an exact tie in t or a padding winner), and K7's state and
K9's verdicts.

With ``--prim`` it runs the same chunk on one process as the prim-sharded
render runs it, at prim=1 (the whole leaf table, the packed tree) and on
each prim=2 shard's range of the table (``shard_tree``'s tree), the
merged winner being K6's walk of the whole tree (the prim merge's but at
cross-shard ties), the stream advanced by K7's walk form.  At every
bounce, for each of the three parts, it times: ``precull`` (the part's
lists for K6l), ``k6_lists`` (K6l), ``k6_walk`` (K6 on the part's tree),
``shadow_rays`` (the glue's shadow rays from the merged winner, alone),
``shadow_precull`` (their lists), ``k8_lists`` (K8l on them) and
``k8_walk`` (K8, which traces its own shadow rays), and K8 in the
``k8_lb_b`` builds (built for b blocks an SM); it counts the lanes where
K6's walk parts from K6l and the verdicts where K8 parts from K8l.

Prints the card, then one JSON line per build (registers, stack, spills
from ``-Xptxas -v``, blocks an SM by the occupancy calculator), one per
sky and bounce, and one with the sums over the bounces.  Needs one CUDA
card and nvcc; builds go to spt_tpu_torch/_build/.

    python3 spt_tpu_torch/tools/wf_ablate.py --k10 [--old CSRC_DIR]
        [--reps N] [--only TAG ...] [--timeout SECONDS]

times K10, the bounce's adjoint, on config 5's bounces 0 and 1 (its
gradient sky; the stream as chip_smoke.py's ``k10_vs_plain`` makes it:
raygen, a sort, K6's walk, K9's verdicts, a random cotangent), built from
the package's sources and from copies with one edit (``K10_VARIANTS``:
``__launch_bounds__`` of 1-4 blocks an SM, no merge of equal winners
before d(prims)'s atomics, the warp sums' adds as stores) and, with
``--old``, an earlier K10's sources (``K10_OLD_VARIANTS``: as built,
launch bounds, the sink's shared atomics as stores), whose per-lane
d(centre, radius) the step scatters with ``_grads_from_bwd`` (timed
beside it).  Each build runs in a process of its own (``faulted``,
``hung`` past ``--timeout``), the reference first and again last, and
prints its registers, spills and blocks an SM, and per bounce the least
of ``--reps`` launches' milliseconds (with the wrapper's zeroed outputs)
and its din (``lanes_close``), d(prims) and dscal (``tail_field_errors``)
against the plain K10 and ``_grads_from_bwd``.

    python3 spt_tpu_torch/tools/wf_ablate.py --k11 --k7m [--old CSRC_DIR]
        [--reps N] [--only TAG ...] [--timeout SECONDS]

times K11 and K11g, the fused bounce, and K7m, the matmul-form shade, on
config 5's bounces 0 and 1 with either sky (the stream and the lists made
by the package's kernels and glue as chip_smoke.py makes them), built
from the package's sources and from copies with one edit
(``K11_VARIANTS``: ``__launch_bounds__`` of 2-6 blocks an SM, the bounce
called; ``K7M_VARIANTS``: as built) and, with ``--old``, an earlier
design's sources with one edit (``K11_OLD_VARIANTS``: the bounce inlined,
launch bounds, the package's list sweep culled per ray by the leaf boxes;
``K7M_OLD_VARIANTS``: launch bounds, the table read slot-major, both).  K11 is timed with the lists (culled per ray by the
leaf boxes), the lists unculled (a null box table, where the build takes
one) and the walk, K11g at bounce 0; K7m as built is its
verdict pass and K7b's kernel (``pass_ms``: the pass alone), an earlier
K7m its sweep inside the bounce.  Each build runs in a process of its own
(``faulted``, ``hung`` past ``--timeout``), the reference first and again
last, and prints its registers, spills and blocks an SM, and per case the
least of ``--reps`` launches' milliseconds and the lanes whose state
differs from the package's own launch on the same inputs (K11's with the
boxes, so the unculled forms' differing lanes are the cull's).
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

_SHADE_BLOCKS = "constexpr int kShadeMinBlocks = 4;"
_VERDICT_BLOCKS = "constexpr int kVerdictMinBlocks = 4;"
_ISECT = "__global__ void __launch_bounds__(kThreadsWf) isect_kernel("
_ISECT_LAUNCH = """  else
    spt::isect_kernel<false><<<spt::blocks_for(n_lanes), spt::kThreadsWf, 0,
                               s>>>(prm);
"""
_BLOCKS_FOR = "inline unsigned blocks_for(int n) {"
_SWEEP = "                : sweep(ox, oy, oz, dx, dy, dz, tmax);"
_WALK = """        : nodef ? BvhWalk<false>{nodef, nodei, prims, nullptr, nullptr,
                                 nullptr, nullptr, n_nodes, block, nullptr}
                      .any_hit(ox, oy, oz, dx, dy, dz, tmax)
"""
_OCC_K6 = "case 0: fn = reinterpret_cast<const void*>(isect_kernel<false>);"

# K6's tree mode with the block's octant table in shared memory: the
# octant of the block's first lane (the sort is octant-major), its n_nodes
# rows of nodef (32 B) and of nodei's (skip, block) pair (8 B), staged once
# a block; each lane of that octant walks the staged rows, any other lane
# the tree in global memory.  The slab test and the sphere sweep are
# BvhWalk's, so the residual is the tree mode's bit for bit.
_SMEM_KERNEL = """// K6's tree mode, its block's octant table staged in shared memory.
__global__ void __launch_bounds__(kThreadsWf)
    isect_tree_smem_kernel(IsectParams prm) {
  extern __shared__ float4 s_rows[];                  // 2 a node
  int2* s_links = reinterpret_cast<int2*>(s_rows + 2 * prm.n_nodes);
  const size_t s = (size_t)prm.stride;
  const int i0 = blockIdx.x * blockDim.x;
  const int first = i0 < prm.n_lanes ? i0 : 0;
  const float* st0 = prm.st + first;
  const int oct = (st0[3 * s] < 0.0f ? 4 : 0) + (st0[4 * s] < 0.0f ? 2 : 0) +
                  (st0[5 * s] < 0.0f ? 1 : 0);
  const float4* gf = reinterpret_cast<const float4*>(prm.nodef) +
                     2 * (size_t)oct * prm.n_nodes;
  const int2* gi = reinterpret_cast<const int2*>(prm.nodei) +
                   4 * (size_t)oct * prm.n_nodes;
  for (int r = threadIdx.x; r < 2 * prm.n_nodes; r += blockDim.x)
    s_rows[r] = __ldg(gf + r);
  for (int r = threadIdx.x; r < prm.n_nodes; r += blockDim.x)
    s_links[r] = __ldg(gi + 4 * r);
  __syncthreads();
  const int i = i0 + threadIdx.x;
  if (i >= prm.n_lanes) return;
  const float* st = prm.st + i;
  float t = kBig;
  int win_blk = -1, win_j = 0;
  if (st[kChAlive * s] > 0.5f) {
    const float ox = st[0], oy = st[s], oz = st[2 * s];
    const float dx = st[3 * s], dy = st[4 * s], dz = st[5 * s];
    const BvhWalk<false> walk{prm.nodef, prm.nodei, prm.prims, nullptr,
                              nullptr, nullptr, nullptr, prm.n_nodes,
                              prm.block, nullptr};
    if (walk.table(dx, dy, dz) == oct * prm.n_nodes) {
      const float ivx = safe_inv(dx), ivy = safe_inv(dy), ivz = safe_inv(dz);
      int ptr = 0;
      while (ptr < prm.n_nodes) {
        const float4 a = s_rows[2 * ptr], b = s_rows[2 * ptr + 1];
        const int2 ni = s_links[ptr];
        float t0 = (a.x - ox) * ivx, t1 = (a.w - ox) * ivx;
        float tn = fminf(t0, t1), tf = fmaxf(t0, t1);
        t0 = (a.y - oy) * ivy;
        t1 = (b.x - oy) * ivy;
        tn = fmaxf(tn, fminf(t0, t1));
        tf = fminf(tf, fmaxf(t0, t1));
        t0 = (a.z - oz) * ivz;
        t1 = (b.y - oz) * ivz;
        tn = fmaxf(tn, fminf(t0, t1));
        tf = fminf(tf, fmaxf(t0, t1));
        if (tn <= tf && tf > kTmin && tn < t) {
          if (ni.y < 0) {
            ++ptr;
            continue;
          }
          const float* pb = prm.prims + (size_t)ni.y * kPrimAttrs * prm.block;
          for (int j = 0; j < prm.block; ++j) {
            float tj;
            if (walk.sphere(pb, j, ox, oy, oz, dx, dy, dz, tj) && tj < t) {
              t = tj;
              win_blk = ni.y;
              win_j = j;
            }
          }
        }
        ptr = ni.x;
      }
    } else {
      win_blk = walk.nearest_slot(ox, oy, oz, dx, dy, dz, t, win_j);
    }
  }
  const size_t n = (size_t)prm.n_lanes;
  float* out = prm.res + i;
  if (win_blk >= 0) {
    const float* pb =
        prm.prims + (size_t)win_blk * kWfPrimAttrs * prm.block + win_j;
    for (int a = 0; a < kWfPrimAttrs; ++a)
      out[a * n] = __ldg(pb + a * prm.block);
    out[5 * n] = (float)win_blk;
    out[6 * n] = (float)win_j;
  } else {
    for (int a = 0; a < 4; ++a) out[a * n] = 0.0f;
    out[4 * n] = -1.0f;
    out[5 * n] = -1.0f;
    out[6 * n] = -1.0f;
  }
  out[7 * n] = 0.0f;
}

"""


def _shade_bounds(blocks: int):
    """K7 and K9 built for ``blocks`` blocks an SM (1: no bound)."""
    return [("wavefront.cu", _SHADE_BLOCKS,
             _SHADE_BLOCKS.replace("4", str(blocks)))]


def _verdict_bounds(blocks: int):
    """K8 built for ``blocks`` blocks an SM (1: no bound)."""
    return [("wavefront.cu", _VERDICT_BLOCKS,
             _VERDICT_BLOCKS.replace("4", str(blocks)))]


def _isect_bounds(blocks: int):
    """K6 built for ``blocks`` blocks an SM (as built: no bound)."""
    return [("wavefront.cu", _ISECT, _ISECT.replace(
        "(kThreadsWf)", f"(kThreadsWf, kMxu ? 1 : {blocks})"))]


# tag -> [(file, old, new)] on the package's sources
VARIANTS = {
    "default": [],
    "k6_smem": [
        ("wavefront.cu", _BLOCKS_FOR, _SMEM_KERNEL + _BLOCKS_FOR),
        ("wavefront.cu", _ISECT_LAUNCH,
         "  else if (nodef)\n"
         "    spt::isect_tree_smem_kernel<<<spt::blocks_for(n_lanes),\n"
         "                                  spt::kThreadsWf,\n"
         "                                  40 * n_nodes, s>>>(prm);\n"
         + _ISECT_LAUNCH),
        ("wavefront.cu", _OCC_K6,
         "case 0: fn = reinterpret_cast<const void*>("
         "isect_tree_smem_kernel);")],
    **{f"k7_lb_{b}": _shade_bounds(b) for b in (1, 2, 3)},
    **{f"k6_lb_{b}": _isect_bounds(b) for b in (6, 8)},
    **{f"k8_lb_{b}": _verdict_bounds(b) for b in (1, 2, 3)},
    # K7 without a bound and without its list sweep, or without its walk
    # (a time probe: its shadow rays then see nothing): which branch sets
    # the registers the compiler takes alone
    "k7_no_lists": _shade_bounds(1) + [
        ("wavefront.cu", _SWEEP, "                : false;")],
    "k7_no_walk": _shade_bounds(1) + [
        ("wavefront.cu", _WALK, "        : nodef ? false\n")],
}


def ptxas(lines, kernel):
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


# The kernels reported per build: ptxas name, occupancy index.
KERNELS = {"k6": ("isect_kernelILb0", 0),
           "k7": ("shade_kernelILb0ELb1E", 1),
           "k11": ("bounce_kernelILb0", 2), "k8l": ("anyhit_kernel", 3),
           "k10": ("bounce_bwd_kernel", 4),
           "k8": ("shade_kernelILb0ELb0E", 5),
           "k7b": ("shade_kernelILb1ELb1E", 6)}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--only", nargs="*", default=None,
                    help="build and time only these variants")
    ap.add_argument("--prim", action="store_true",
                    help="time the prim-sharded path's K6 and K8")
    ap.add_argument("--k10", action="store_true",
                    help="time K10, the bounce's adjoint, in its builds")
    ap.add_argument("--k11", action="store_true",
                    help="time K11 and K11g, the fused bounce, in its builds")
    ap.add_argument("--k7m", action="store_true",
                    help="time K7m, the matmul-form shade, in its builds")
    ap.add_argument("--old", type=Path, default=None,
                    help="with --k10, --k11, --k7m: csrc directory of an "
                         "earlier design")
    ap.add_argument("--timeout", type=float, default=300.0,
                    help="seconds a build's timing process may take")
    # --time-k10 TAG OLD: one K10 build's launches (time_k10)
    ap.add_argument("--time-k10", nargs=2, default=None,
                    help=argparse.SUPPRESS)
    # --time-fused KIND TAG: one K11 or K7m build's launches (time_fused)
    ap.add_argument("--time-fused", nargs=2, default=None,
                    help=argparse.SUPPRESS)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("wf_ablate: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    if args.time_k10:
        print(json.dumps(time_k10(args.time_k10[0], args.time_k10[1] == "1",
                                  args.reps)))
        return 0
    if args.time_fused:
        print(json.dumps(time_fused(*args.time_fused, args.reps)))
        return 0
    if args.k10:
        return main_k10(args)
    if args.k11 or args.k7m:
        return main_fused(args, [k for k in ("k11", "k7m")
                                 if getattr(args, k)])
    import chip_smoke as cs
    import spt_tpu_torch as T
    from spt_tpu_torch.kernels import _build, megakernel_bvh as mb
    from spt_tpu_torch.kernels import wavefront as wf
    from spt_tpu_torch.kernels import wavefront_grad as wg

    t_all = time.perf_counter()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    print(card, flush=True)
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tags = [t for t in VARIANTS if t == "default" or (
        t in args.only if args.only else t.startswith("k8_") == args.prim)]

    def build(tag):
        src = _build.BUILD_DIR / f"wf_{tag}"
        shutil.rmtree(src, ignore_errors=True)
        shutil.copytree(_build.CSRC, src)
        for name, old, new in VARIANTS[tag]:
            text = (src / name).read_text()
            if text.count(old) != 1:
                raise RuntimeError(f"{tag}: {name} has no single {old!r}")
            (src / name).write_text(text.replace(old, new))
        out = _build.BUILD_DIR / f"libwf_{tag}.so"
        proc = subprocess.run([_build.find_nvcc(), *_build.NVCC_FLAGS, "-o",
                               str(out), str(src / "wavefront.cu")],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"{tag}: nvcc failed\n{proc.stderr}")
        lib = ctypes.CDLL(str(out))
        for fn, argtypes in _build.ENTRIES["wavefront"].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        return tag, lib, (proc.stdout + proc.stderr).splitlines()

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(tags)) as pool:
        builds = {tag: (lib, lines) for tag, lib, lines in
                  pool.map(build, tags)}
    print(json.dumps(dict(phase="build", seconds=time.perf_counter() - t0,
                          builds=tags)), flush=True)

    dev = torch.device("cuda")
    n_nodes = cs.wf_inputs(torch, wf, mb, cs.scene_10k(T).compile(
        device=dev), T.Camera.look_at(device=dev, **cs.CAM_10K),
        cs.BIG_SEED)[0]["nodef"].numel() // 64
    for tag, (lib, lines) in builds.items():
        row = dict(build=tag, card=card)
        for key, (kname, which) in KERNELS.items():
            smem = 40 * n_nodes if (tag == "k6_smem" and key == "k6") else 0
            row[key] = dict(ptxas(lines, kname),
                            blocks_per_sm=lib.spt_wavefront_blocks_per_sm(
                                which, smem))
        print(json.dumps(row), flush=True)
    (run_prim_bounces if args.prim else run_bounces)(builds, dev, card,
                                                      args.reps)
    print(json.dumps(dict(seconds=time.perf_counter() - t_all)), flush=True)
    return 0


def run_bounces(builds: dict, dev, card: str, reps: int) -> None:
    """The per-bounce timings of one chunk with each sky (the module's
    docstring), each of ``builds`` (tag -> (library, ptxas lines)) loaded
    in its turn.  Prints a line a bounce and the sums."""
    import torch
    import chip_smoke as cs
    import spt_tpu_torch as T
    from spt_tpu_torch.kernels import _build, megakernel_bvh as mb
    from spt_tpu_torch.kernels import wavefront as wf
    from spt_tpu_torch.kernels import wavefront_grad as wg

    sd10 = cs.scene_10k(T).compile(device=dev)
    scene_env = cs.scene_10k(T)
    scene_env.set_environment_map(cs.env_gradient())
    sd_env = scene_env.compile(device=dev)
    cam = T.Camera.look_at(device=dev, **cs.CAM_10K)
    t, stc, meta = cs.wf_inputs(torch, wf, mb, sd10, cam, cs.BIG_SEED)

    def use(tag):
        _build._LOADED["wavefront"] = builds[tag][0]

    def timed(fn):
        best, out = None, None
        for _ in range(reps):
            out, ms = cs.cuda_ms(torch, fn)
            best = ms if best is None else min(best, ms)
        return out, best

    block, prims = stc["block"], t["prims"]
    tree = (t["nodef"], t["nodei"])
    lob, hib = wf._leaf_block_bounds(prims.reshape(-1, 5, block))
    nls = stc["n_light_slots"]
    lo, ext = wf._scene_sort_bounds(t["nodef"])
    totals = {}
    for sky, sd in (("gradient", sd10), ("envmap", sd_env)):
        env = sd.env_map.to(dev) if sky == "envmap" else None
        use("default")
        st, ids = wf.raygen(t["blob"], meta, width=cs.BIG_W,
                            height=cs.BIG_H, chunk_spp=2, dof=False)
        buf = wf._stream_buffer(st, ids)
        n_tiles = st.shape[1] // wf.TILE - 1
        nalive = n_tiles
        kw = dict(block=block, n_mats=stc["n_mats"], n_light_slots=nls,
                  rr_depth=cs.RR, use_nee=True, use_mis=True,
                  sky_mode=sd.sky_mode)
        for k in range(cs.DEPTH):
            use("default")
            lanes = wf._sort_span(k, nalive, n_tiles, 1 << 17, True)
            if lanes is not None:
                nalive = wf._sort_rays(buf, lanes, lo, ext)
            if nalive == 0:
                break
            n = nalive * wf.TILE
            ms = {}
            rays = (tuple(st[c, :n] for c in range(3)),
                    tuple(st[c, :n] for c in range(3, 6)),
                    st[wf.C_ALIVE, :n], None, lob, hib)
            (cand, ctn), ms["precull"] = timed(
                lambda: wf.precull_tiles(*rays))
            res_l, ms["k6_lists"] = timed(
                lambda: wf.isect(prims, cand, ctn, st, n, block=block))
            res_w, ms["k6_walk"] = timed(
                lambda: wf.isect(prims, None, None, st, n, block=block,
                                 tree=tree))
            row = dict(sky=sky, bounce=k, lanes=n,
                       alive=int((st[wf.C_ALIVE, :n] > 0.5).sum()))
            for tag in builds:
                if tag.startswith("k6_"):
                    use(tag)
                    res_s, ms[f"k6_walk_{tag[3:]}"] = timed(
                        lambda: wf.isect(prims, None, None, st, n,
                                         block=block, tree=tree))
                    row[f"{tag}_lanes_differ"] = cs.bits_differ(torch, res_s,
                                                                res_w)
            use("default")
            differ = (res_w.view(torch.int32)
                      != res_l.view(torch.int32)).any(0)
            pad = lambda r: (r[4] < 0) & (r[5] >= 0)   # noqa: E731
            t_w = wf.winner_t(st[:, :n], res_w)
            t_l = wf.winner_t(st[:, :n], res_l)
            ties = differ & ~pad(res_w) & ~pad(res_l) & (t_w == t_l)
            row.update(k6_lanes_differ_from_lists=int(differ.sum()),
                       k6_differ_ties=int(ties.sum()),
                       k6_differ_padding=int((differ & (pad(res_w)
                                                        | pad(res_l))).sum()))

            def shadow_lists(res):
                so3, sd3, stmax, sneed = wf.shadow_rays(
                    st[:, :n], ids[:, :n], res, t["blob"], t["lsb"], nls,
                    k=k, seed=cs.BIG_SEED, n_mats=stc["n_mats"],
                    mtypes=stc["mtypes"], n_light_slots=nls)
                return wf.precull_tiles(so3, sd3, sneed, stmax, lob, hib)

            (scand, sctn), ms["shadow"] = timed(lambda: shadow_lists(res_l))
            base = buf.clone()
            args7 = (t["blob"], meta, t["lsb"], prims, t["mtypes"])
            outs = {}
            for form, res, lists, tr in (
                    ("lists", res_l, (scand, sctn), None),
                    ("walk", res_w, (None, None), tree)):
                work = base.clone()

                def k7():
                    work.copy_(base)
                    wf.shade(*args7, *lists, *cs.stream_of(torch, wf, work),
                             res, n, k=k, tree=tr, **kw)
                _, ms[f"k7_{form}"] = timed(k7)
                outs[form] = work[:wf.N_CH, :n].clone()
                (out9, blocked), ms[f"k9_{form}"] = timed(
                    lambda: wg.shade_fwd(*args7, *lists,
                                         *cs.stream_of(torch, wf, base),
                                         res, n, k=k, tree=tr, **kw))
                outs[f"v_{form}"] = blocked
                outs[f"k9_{form}"] = out9[:, :n]
            row.update(
                k7_lanes_differ_from_lists=cs.bits_differ(
                    torch, outs["walk"], outs["lists"]),
                k9_verdicts_differ_from_lists=int(
                    (outs["v_walk"] != outs["v_lists"]).sum()),
                k9_walk_lanes_differ_from_k7=cs.bits_differ(
                    torch, outs["k9_walk"], outs["walk"]))
            for tag in builds:
                if tag.startswith("k7_"):
                    use(tag)
                    work = base.clone()

                    def k7b():
                        work.copy_(base)
                        wf.shade(*args7, None, None,
                                 *cs.stream_of(torch, wf, work), res_w, n,
                                 k=k, tree=tree, **kw)
                    _, ms[f"k7_walk_{tag[3:]}"] = timed(k7b)
                    row[f"{tag}_lanes_differ"] = cs.bits_differ(
                        torch, work[:wf.N_CH, :n], outs["walk"])
            use("default")
            # Advance the stream as render_wavefront does.
            buf.copy_(base)
            wf.shade(*args7, None, None, st, ids, res_w, n, k=k, tree=tree,
                     **kw)
            if env is not None:
                wf._add_env_radiance(st[:, :n], env)
            for key, v in ms.items():
                totals.setdefault(sky, {}).setdefault(key, 0.0)
                totals[sky][key] += v
            print(json.dumps(dict(row, card=card, ms=ms)), flush=True)
            del cand, ctn, scand, sctn, res_l, res_w, base, outs
        del st, ids, buf
        torch.cuda.empty_cache()
    print(json.dumps(dict(phase="sums_over_bounces", card=card,
                          chunk=f"{cs.BIG_W}x{cs.BIG_H} x 2 spp",
                          ms=totals)), flush=True)


def run_prim_bounces(builds: dict, dev, card: str, reps: int) -> None:
    """The per-bounce timings of the prim-sharded path's kernels and glue
    (the module's docstring, ``--prim``), each of ``builds`` loaded in its
    turn.  Prints a line a sky and bounce and the sums."""
    import torch
    import chip_smoke as cs
    import spt_tpu_torch as T
    from spt_tpu_torch.kernels import _build, megakernel_bvh as mb
    from spt_tpu_torch.kernels import wavefront as wf
    from spt_tpu_torch.parallel.wavefront_prim import _shard_tree

    sd10 = cs.scene_10k(T).compile(device=dev)
    scene_env = cs.scene_10k(T)
    scene_env.set_environment_map(cs.env_gradient())
    sd_env = scene_env.compile(device=dev)
    cam = T.Camera.look_at(device=dev, **cs.CAM_10K)
    t, stc, meta = cs.wf_inputs(torch, wf, mb, sd10, cam, cs.BIG_SEED)

    def use(tag):
        _build._LOADED["wavefront"] = builds[tag][0]

    def timed(fn):
        best, out = None, None
        for _ in range(reps):
            out, ms = cs.cuda_ms(torch, fn)
            best = ms if best is None else min(best, ms)
        return out, best

    block, prims = stc["block"], t["prims"].reshape(-1, 5, stc["block"])
    nb = prims.shape[0]
    half = -(-nb // 2)
    parts = {}
    for part, (lo, hi) in (("prim1", (0, nb)), ("prim2_shard0", (0, half)),
                           ("prim2_shard1", (half, nb))):
        local = prims[lo:hi].contiguous()
        parts[part] = (local, _shard_tree(t, stc, lo, hi),
                       wf._leaf_block_bounds(local))
    tree = parts["prim1"][1]
    nls = stc["n_light_slots"]
    lo, ext = wf._scene_sort_bounds(t["nodef"])
    totals = {}
    for sky, sd in (("gradient", sd10), ("envmap", sd_env)):
        env = sd.env_map.to(dev) if sky == "envmap" else None
        use("default")
        st, ids = wf.raygen(t["blob"], meta, width=cs.BIG_W,
                            height=cs.BIG_H, chunk_spp=2, dof=False)
        buf = wf._stream_buffer(st, ids)
        n_tiles = st.shape[1] // wf.TILE - 1
        nalive = n_tiles
        kw = dict(block=block, n_mats=stc["n_mats"], n_light_slots=nls,
                  rr_depth=cs.RR, use_nee=True, use_mis=True,
                  sky_mode=sd.sky_mode)
        args8 = (t["blob"], meta, t["lsb"])
        for k in range(cs.DEPTH):
            use("default")
            lanes = wf._sort_span(k, nalive, n_tiles, 1 << 17, True)
            if lanes is not None:
                nalive = wf._sort_rays(buf, lanes, lo, ext)
            if nalive == 0:
                break
            n = nalive * wf.TILE
            head = st[:, :n]
            res_m = wf.isect(t["prims"], None, None, st, n, block=block,
                             tree=tree)
            row = dict(sky=sky, bounce=k, lanes=n,
                       alive=int((head[wf.C_ALIVE] > 0.5).sum()))
            for part, (local, ptree, (lob, hib)) in parts.items():
                ms = {}
                rays = (tuple(head[c] for c in range(3)),
                        tuple(head[c] for c in range(3, 6)),
                        head[wf.C_ALIVE], None, lob, hib)
                (cand, ctn), ms["precull"] = timed(
                    lambda: wf.precull_tiles(*rays))
                res_l, ms["k6_lists"] = timed(
                    lambda: wf.isect(local, cand, ctn, st, n, block=block))
                res_w, ms["k6_walk"] = timed(
                    lambda: wf.isect(local, None, None, st, n, block=block,
                                     tree=ptree))
                (so3, sd3, stmax, sneed), ms["shadow_rays"] = timed(
                    lambda: wf.shadow_rays(
                        head, ids[:, :n], res_m, t["blob"], t["lsb"], nls,
                        k=k, seed=cs.BIG_SEED, n_mats=stc["n_mats"],
                        mtypes=stc["mtypes"], n_light_slots=nls))
                (scand, sctn), ms["shadow_precull"] = timed(
                    lambda: wf.precull_tiles(so3, sd3, sneed, stmax, lob,
                                             hib))
                sray = torch.stack([*so3, *sd3, stmax, sneed])
                v_l, ms["k8_lists"] = timed(
                    lambda: wf.anyhit(local, scand, sctn, sray, n,
                                      block=block))
                v_w, ms["k8_walk"] = timed(
                    lambda: wf.shadow_verdicts(*args8, local, t["mtypes"],
                                               st, ids, res_m, n, tree=ptree,
                                               k=k, **kw))
                out = dict(ms=ms, k6_differ_from_lists=cs.route_differ(
                    torch, wf, head, res_w, res_l),
                    k8_differ_from_lists=int((v_w != v_l).sum()),
                    shadow_rays=int((sneed > 0.5).sum()))
                for tag in builds:
                    if tag.startswith("k8_"):
                        use(tag)
                        v_b, ms[f"k8_walk_{tag[3:]}"] = timed(
                            lambda: wf.shadow_verdicts(
                                *args8, local, t["mtypes"], st, ids, res_m,
                                n, tree=ptree, k=k, **kw))
                        out[f"{tag}_differ"] = int((v_b != v_w).sum())
                        use("default")
                row[part] = out
                for key, v in ms.items():
                    acc = totals.setdefault(sky, {}).setdefault(part, {})
                    acc[key] = acc.get(key, 0.0) + v
                del cand, ctn, res_l, res_w, scand, sctn, sray, v_l, v_w
            # Advance the stream as render_wavefront does (and as the prim
            # render does, but at cross-shard ties).
            wf.shade(t["blob"], meta, t["lsb"], t["prims"], t["mtypes"], None,
                     None, st, ids, res_m, n, k=k, tree=tree, **kw)
            if env is not None:
                wf._add_env_radiance(head, env)
            print(json.dumps(dict(row, card=card)), flush=True)
        del st, ids, buf
        torch.cuda.empty_cache()
    print(json.dumps(dict(phase="sums_over_bounces", card=card,
                          chunk=f"{cs.BIG_W}x{cs.BIG_H} x 2 spp",
                          ms=totals)), flush=True)


# ---------------------------------------------------------------------------
# K10
# ---------------------------------------------------------------------------

_BWD_BLOCKS = "constexpr int kBwdMinBlocks = 2;"
_BWD_GEO = "  flush_geometry<true>(key, sink.dgeo, prm.dprims, prm.block);"
_FLUSH = ("  flush_row(sink.row, sink.v, sink.row == 0 ? 6 : 8, g);\n"
          "  flush_row(sink.light_row, sink.lv, 7, g);\n")
_OLD_BWD = "__launch_bounds__(kThreadsWf)\n    bounce_bwd_kernel("
_OLD_ADD = "  if (v != 0.0f) atomicAdd(g + i, v);\n"

# tag -> [(file, old, new)] on the package's K10
K10_VARIANTS = {
    "k10": [],
    **{f"k10_lb_{b}": [("wavefront.cu", _BWD_BLOCKS,
                        _BWD_BLOCKS.replace("2;", f"{b};"))]
       for b in (1, 3, 4)},
    # each lane adds its own winner's cotangent into d(prims)
    "k10_no_merge": [("wavefront.cu", _BWD_GEO,
                      _BWD_GEO.replace("<true>", "<false>"))],
    # the scalar gradient's warp sums dropped: each lane stores its own
    # row (a time bound only; the gradient is wrong)
    "k10_stores": [("physics_adj.cuh", _FLUSH,
                    "  if (sink.row >= 0)\n"
                    "    for (int a = 0; a < 8; ++a) g[sink.row + a] = "
                    "sink.v[a];\n"
                    "  if (sink.light_row >= 0)\n"
                    "    for (int a = 0; a < 7; ++a) g[sink.light_row + a] = "
                    "sink.lv[a];\n")],
}
# tag -> [(file, old, new)] on an earlier K10's sources (--old)
K10_OLD_VARIANTS = {
    "old": [],
    **{f"old_lb_{b}": [("wavefront.cu", _OLD_BWD, _OLD_BWD.replace(
        "(kThreadsWf)", f"(kThreadsWf, {b})"))] for b in (2, 3, 4)},
    # the sink's shared atomics as plain stores (a time bound only)
    "old_stores": [("physics_adj.cuh", _OLD_ADD,
                    "  if (v != 0.0f) g[i] = v;\n")],
}
_P, _I = ctypes.c_void_p, ctypes.c_int
# An earlier K10's entry: din, dgeo, dscal, st, ids, res, ct, blob, meta,
# lsb, mtypes, stride, n_lanes, n_mats, n_light_slots, k, rr_depth,
# use_nee, use_mis, sky_mode, stream.
OLD_K10_ENTRY = [_P] * 11 + [_I] * 9 + [_P]


def _k10_lib(tag: str) -> Path:
    from spt_tpu_torch.kernels import _build
    return _build.BUILD_DIR / f"libwfk10_{tag}.so"


def build_k10(tag: str, csrc: Path, edits) -> tuple:
    """Copy ``csrc``, apply ``edits``, build the wavefront's kernels ->
    (tag, K10's ptxas facts)."""
    from spt_tpu_torch.kernels import _build
    src = _build.BUILD_DIR / f"wfk10_{tag}"
    shutil.rmtree(src, ignore_errors=True)
    shutil.copytree(csrc, src)
    for name, old, new in edits:
        text = (src / name).read_text()
        if text.count(old) != 1:
            raise RuntimeError(f"{tag}: {name} has no single {old!r}")
        (src / name).write_text(text.replace(old, new))
    proc = subprocess.run([_build.find_nvcc(), *_build.NVCC_FLAGS, "-o",
                           str(_k10_lib(tag)), str(src / "wavefront.cu")],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"{tag}: nvcc failed\n{proc.stderr}")
    return tag, ptxas((proc.stdout + proc.stderr).splitlines(),
                      "bounce_bwd_kernel")


def time_k10(tag: str, old: bool, reps: int) -> dict:
    """One K10 build's launches on config 5's bounces 0 and 1, in a
    process of its own; the stream made by the package's kernels."""
    import numpy as np
    import torch
    import chip_smoke as cs
    import spt_tpu_torch as T
    from spt_tpu_torch.kernels import _build, megakernel_bvh as mb
    from spt_tpu_torch.kernels import wavefront as wf
    from spt_tpu_torch.kernels import wavefront_grad as wg
    dev = torch.device("cuda")
    lib = ctypes.CDLL(str(_k10_lib(tag)))
    fn = lib.spt_wavefront_bounce_bwd
    fn.argtypes = OLD_K10_ENTRY if old else \
        _build.ENTRIES["wavefront"]["spt_wavefront_bounce_bwd"]
    fn.restype = ctypes.c_int
    sd = cs.scene_10k(T).compile(device=dev)
    cam = T.Camera.look_at(device=dev, **cs.CAM_10K)
    t, stc, meta = cs.wf_inputs(torch, wf, mb, sd, cam, cs.BIG_SEED)
    block, n_mats, nls = stc["block"], stc["n_mats"], stc["n_light_slots"]
    n_blocks = t["prims"].numel() // (5 * block)
    n_scal = wg.n_scalars(n_mats, nls)
    if old:     # its shared memory: uniforms, one copy of the vector
        lib.spt_wavefront_blocks_per_sm.argtypes = [_I, _I]
        row = dict(blocks_per_sm=lib.spt_wavefront_blocks_per_sm(
            4, 4 * (t["blob"].numel() + 8 + 6 + 3 + n_mats + n_scal)))
    else:
        fn_b = lib.spt_wavefront_bounce_bwd_blocks_per_sm
        fn_b.argtypes = [_I, _I]
        row = dict(blocks_per_sm=fn_b(n_mats, nls))
    b = cs.wf_bounce(torch, wf, t, stc, meta, cs.BIG_W, cs.BIG_H, 0,
                     cs.BIG_SEED)
    stream = torch.cuda.current_stream().cuda_stream
    for k in (0, 1):
        n, res_k, tree = b["n"], b["res_t"], b["tree"]
        st, ids = b["st"], b["ids"]
        kw9 = dict(k=k, block=block, n_mats=n_mats, n_light_slots=nls,
                   rr_depth=cs.RR, use_nee=True, use_mis=True,
                   sky_mode=sd.sky_mode)
        _, blocked = wg.shade_fwd(t["blob"], meta, t["lsb"], t["prims"],
                                  t["mtypes"], None, None, st, ids, res_k, n,
                                  tree=tree, **kw9)
        res8 = res_k.clone()
        res8[7] = blocked
        ct = torch.from_numpy(np.random.default_rng(11).normal(
            size=tuple(st.shape)).astype(np.float32)).to(dev)
        kw10 = {a: v for a, v in kw9.items() if a != "block"}
        bargs = (t["blob"], meta, t["lsb"], t["mtypes"], st, ids, res8, ct,
                 n)
        gkw = dict(n_mats=n_mats, n_light_slots=nls, n_blocks=n_blocks,
                   block=block)
        with torch.inference_mode():
            din_p, dgeo_p, dscal_p = wg.bounce_bwd_plain(*bargs, **kw10)
            _, dpr_p = wg._grads_from_bwd(t["blob"], res8, dgeo_p, dscal_p,
                                          **gkw)

        def launch():
            din = torch.empty_like(ct)
            dscal = torch.zeros(n_scal, device=dev)
            out = (torch.empty((4, n), device=dev) if old else
                   torch.zeros((n_blocks + 1, 5, block), device=dev))
            ptrs = [a.data_ptr() for a in (din, out, dscal, st, ids, res8,
                                           ct, t["blob"], meta, t["lsb"],
                                           t["mtypes"])]
            ints = [st.shape[1], n, n_mats, nls, k, cs.RR, 1, 1,
                    sd.sky_mode] + ([] if old else [n_blocks, block])
            if fn(*ptrs, *ints, stream) != 0:
                raise RuntimeError(f"{tag}: K10 launch failed")
            return din, out, dscal

        din, out, dscal = launch()
        torch.cuda.synchronize()
        res = dict(lanes=n, ms_all=[cs.cuda_ms(torch, launch)[1]
                                    for _ in range(reps)])
        res["ms"] = min(res["ms_all"])
        if old:
            scatter = [cs.cuda_ms(torch, lambda: wg._grads_from_bwd(
                t["blob"], res8, out, dscal, **gkw))[1] for _ in range(reps)]
            res.update(scatter_ms=min(scatter),
                       k10_and_scatter_ms=res["ms"] + min(scatter))
            out = wg._grads_from_bwd(t["blob"], res8, out, dscal, **gkw)[1]
        else:
            out = out[:n_blocks]
        errs, _ = cs.tail_field_errors({"d_prims": out, "dscal": dscal},
                                       {"d_prims": dpr_p, "dscal": dscal_p})
        lanes = cs.lanes_close(din[:13, :n], din_p[:13, :n])
        res.update(din_ok=lanes["ok"], din_frac_close=lanes["frac_close"],
                   grad_ok=all(e["ok"] for e in errs.values()),
                   grad=dict((key, dict(body_rel=e["body_rel"],
                                        tail_rel=e["tail_rel"],
                                        frac_close=e["frac_close"]))
                             for key, e in errs.items()),
                   flags_equal=bool(torch.equal(din[13:], din_p[13:])
                                    and torch.equal(din[:, n:],
                                                    din_p[:, n:])))
        row[f"bounce{k}"] = res
        del din_p, dgeo_p, dpr_p, din, out, ct
        if k == 0:
            b = cs.wf_advance(torch, wf, t, stc, meta, b, 0, cs.BIG_SEED,
                              sd.sky_mode)
    return row


def main_k10(args) -> int:
    """Build K10's variants, then time each build in a process of its own,
    the reference first and again last."""
    from spt_tpu_torch.kernels import _build
    t0 = time.perf_counter()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    print(card, flush=True)
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    _build.build("wavefront")       # the package's, which makes the stream
    jobs = [(tag, _build.CSRC, edits) for tag, edits in K10_VARIANTS.items()]
    if args.old is not None:
        jobs += [(tag, args.old, edits)
                 for tag, edits in K10_OLD_VARIANTS.items()]
    if args.only:
        jobs = [j for j in jobs if j[0] in args.only]
    with ThreadPoolExecutor(len(jobs)) as pool:
        facts = dict(pool.map(lambda j: build_k10(*j), jobs))
    print(json.dumps(dict(phase="build", seconds=time.perf_counter() - t0,
                          builds=list(facts))), flush=True)
    ref_tag = next(t for t in ("k10", "old") if t in facts)
    order = [ref_tag] + [t for t in facts if t != ref_tag] + [ref_tag]
    for n, tag in enumerate(order):
        row = dict(variant=tag, card=card, run=n, **facts[tag])
        try:
            proc = subprocess.run(
                [sys.executable, __file__, "--reps", str(args.reps),
                 "--time-k10", tag, "1" if tag.startswith("old") else "0"],
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
    print(json.dumps(dict(seconds=time.perf_counter() - t0)), flush=True)
    return 0

# ---------------------------------------------------------------------------
# K11, K11g and K7m
# ---------------------------------------------------------------------------

_OLD_CALL = "    const bool missed = wf_bounce(sc, geo, p, (uint32_t)prm.ids[i],\n"
_OLD_K11 = ("__global__ void __launch_bounds__(kThreadsWf) bounce_kernel("
            "BounceParams prm) {")
_OLD_K7M = "                                  kMxu || kVerdict ? 1\n"
_OLD_COLUMN = """  __device__ __forceinline__ float column(int c) const {
    float sum = __ldg(cb + c) * a[0];
    for (int r = 1; r < 8; ++r) sum = sum + __ldg(cb + r * 2 * block + c) * a[r];
    return sum;
  }
"""
# Column c of the slot-major table (n_blocks, 2 block, 8): two 16-byte
# loads, its 8 products summed in the same order.
_SLOT_COLUMN = """  __device__ __forceinline__ float column(int c) const {
    const float4* q = reinterpret_cast<const float4*>(cb + 8 * c);
    const float4 u = __ldg(q), v = __ldg(q + 1);
    float sum = u.x * a[0];
    sum = sum + u.y * a[1];
    sum = sum + u.z * a[2];
    sum = sum + u.w * a[3];
    sum = sum + v.x * a[4];
    sum = sum + v.y * a[5];
    sum = sum + v.z * a[6];
    sum = sum + v.w * a[7];
    return sum;
  }
"""
_SHADOW_DOC = ("// Whether a shadow ray is blocked before tmax: the list in "
               "order, stopping\n")


def _package_cull() -> str:
    """The package's ``box_hit`` and box-taking ``list_nearest`` as its
    ``wavefront.cu`` has them, for an earlier design's sources: there the
    6-argument ``list_nearest`` overloads that design's own."""
    text = (ROOT / "spt_tpu_torch" / "csrc" / "wavefront.cu").read_text()
    start = text.index("// A leaf block's box, row blk of `boxes`")
    return text[start:text.index(_SHADOW_DOC, start)]


def _old_cull() -> list:
    """The edits that give an earlier K11 (before the boxes) the package's
    culled list sweep, its box table passed after ctn."""
    return [
        ("wavefront.cu", _SHADOW_DOC, _package_cull() + _SHADOW_DOC),
        ("wavefront.cu", "  float* res;           // K11g: (8, n_lanes) "
         "residual; K11: null\n", "  const float* boxes;   // precull: "
         "(n_blocks, 8)\n  float* res;           // K11g: (8, n_lanes) "
         "residual; K11: null\n"),
        ("wavefront.cu", "  const float* tl;      // its entry bounds\n",
         "  const float* tl;      // its entry bounds\n  const float* "
         "boxes;\n"),
        ("wavefront.cu", "      const int win_blk = list_nearest(cl, tl, "
         "slots, t, win_j);\n", "      const int win_blk = list_nearest(cl, "
         "tl, boxes, slots, t, win_j);\n"),
        ("wavefront.cu", "        prm.precull ? prm.ctn + (size_t)tile * "
         "prm.n_blocks : nullptr};\n", "        prm.precull ? prm.ctn + "
         "(size_t)tile * prm.n_blocks : nullptr,\n        prm.boxes};\n"),
        ("wavefront.cu", "    const void* mtypes, const void* cand, const "
         "void* ctn, void* res,\n", "    const void* mtypes, const void* "
         "cand, const void* ctn, const void* boxes,\n    void* res,\n"),
        ("wavefront.cu", "  prm.ctn = static_cast<const float*>(ctn);\n  "
         "prm.res = static_cast<float*>(res);\n", "  prm.ctn = "
         "static_cast<const float*>(ctn);\n  prm.boxes = static_cast<const "
         "float*>(boxes);\n  prm.res = static_cast<float*>(res);\n"),
    ]


# Appended to every build: blocks an SM of K11 (0), K11g (1) and, in a
# build before K7m's verdict pass, K7m (2), with `smem` bytes of dynamic
# shared memory, by the occupancy calculator.
_OCC_FN = """
extern "C" int spt_ablate_blocks_per_sm(int which, int smem) {
  using namespace spt;
  const void* fn =
      which == 0 ? reinterpret_cast<const void*>(bounce_kernel<false>)
                 : reinterpret_cast<const void*>(bounce_kernel<true>);
  KERNEL_K7M
  int blocks = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn, kThreadsWf,
                                                    smem) != cudaSuccess)
    return -1;
  return blocks;
}
"""
_OCC_K7M = ("if (which == 2)\n    fn = reinterpret_cast<const void*>("
            "shade_kernel<true, false>);")

# tag -> [(file, old, new)] on an earlier design's sources (--old): K11
# and K11g (bounce_kernel) as built, its bounce inlined, built for b
# blocks an SM, and with the package's culled list sweep.
K11_OLD_VARIANTS = {
    "old": [],
    "old_inline": [("wavefront.cu", _OLD_CALL,
                    _OLD_CALL.replace("wf_bounce", "trace_bounce"))],
    **{f"old_lb_{b}": [("wavefront.cu", _OLD_K11, _OLD_K11.replace(
        "(kThreadsWf)", f"(kThreadsWf, {b})"))] for b in (2, 3, 4, 5, 6)},
    "old_cull": _old_cull(),
}
# K7m (shade_kernel<true, false>) as built, built for b blocks an SM, read
# from the slot-major copy of the table, and both.
K7M_OLD_VARIANTS = {
    "old": [],
    **{f"old_lb_{b}": [("wavefront.cu", _OLD_K7M, _OLD_K7M.replace(
        "kMxu || kVerdict ? 1", f"kMxu ? {b} : kVerdict ? 1"))]
       for b in (2, 3, 4)},
    "old_slot": [("wavefront.cu", _OLD_COLUMN, _SLOT_COLUMN)],
    **{f"old_slot_lb_{b}": [("wavefront.cu", _OLD_COLUMN, _SLOT_COLUMN),
                            ("wavefront.cu", _OLD_K7M, _OLD_K7M.replace(
                                "kMxu || kVerdict ? 1",
                                f"kMxu ? {b} : kVerdict ? 1"))]
       for b in (2, 3, 4)},
}
_K11_BLOCKS = "constexpr int kBounceMinBlocks = 5;"
_INLINE = "    const bool missed = trace_bounce(sc, geo, p, (uint32_t)prm.ids[i],\n"
# tag -> [(file, old, new)] on the package's sources: K11 and K11g built
# for b blocks an SM, and with the bounce called (wf_bounce, __noinline__)
# as before; K7m (its verdict pass and K7b's kernel) as built.  Each K11
# build is also timed with its list sweep unculled (a null box table).
K11_VARIANTS = {
    "k11": [],
    **{f"k11_lb_{b}": [("wavefront.cu", _K11_BLOCKS, _K11_BLOCKS.replace(
        "5;", f"{b};"))] for b in (2, 3, 4, 6)},
    "k11_called": [("wavefront.cu", _INLINE,
                    _INLINE.replace("trace_bounce", "wf_bounce"))],
}
K7M_VARIANTS = {"k7m": []}
FUSED = {"k11": (K11_VARIANTS, K11_OLD_VARIANTS),
         "k7m": (K7M_VARIANTS, K7M_OLD_VARIANTS)}


def _fused_dir(kind: str, tag: str) -> Path:
    from spt_tpu_torch.kernels import _build
    return _build.BUILD_DIR / f"wf{kind}_{tag}"


def build_fused(kind: str, tag: str, csrc: Path, edits) -> tuple:
    """Copy ``csrc``, apply ``edits`` (and the occupancy entry), build the
    wavefront's kernels -> (tag, ptxas facts of K11 and K11g, or K7m)."""
    from spt_tpu_torch.kernels import _build
    src = _fused_dir(kind, tag)
    shutil.rmtree(src, ignore_errors=True)
    shutil.copytree(csrc, src)
    for name, old, new in edits:
        text = (src / name).read_text()
        if text.count(old) != 1:
            raise RuntimeError(f"{tag}: {name} has no single {old!r}")
        (src / name).write_text(text.replace(old, new))
    verdict_pass = "mxu_verdict_kernel" in (src / "wavefront.cu").read_text()
    with open(src / "wavefront.cu", "a") as f:
        f.write(_OCC_FN.replace("KERNEL_K7M", "" if verdict_pass
                                else _OCC_K7M))
    proc = subprocess.run([_build.find_nvcc(), *_build.NVCC_FLAGS, "-o",
                           str(src / "lib.so"), str(src / "wavefront.cu")],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"{tag}: nvcc failed\n{proc.stderr[-3000:]}")
    lines = (proc.stdout + proc.stderr).splitlines()
    if kind == "k11":
        return tag, dict(k11=ptxas(lines, "bounce_kernelILb0"),
                         k11g=ptxas(lines, "bounce_kernelILb1"))
    if verdict_pass:     # K7m: the verdict pass, then K7b's kernel
        return tag, dict(k7mv=ptxas(lines, "mxu_verdict_kernel"),
                         k7m=ptxas(lines, "shade_kernelILb1ELb1E"))
    return tag, dict(k7m=ptxas(lines, "shade_kernelILb1ELb0"))


def _fused_inputs(torch, cs, T, wf, mb, dev):
    """Config 5 with each sky: (sky, scene, packed tensors, static, meta)."""
    sd10 = cs.scene_10k(T).compile(device=dev)
    scene_env = cs.scene_10k(T)
    scene_env.set_environment_map(cs.env_gradient())
    sd_env = scene_env.compile(device=dev)
    cam = T.Camera.look_at(device=dev, **cs.CAM_10K)
    out = []
    for sky, sd in (("gradient", sd10), ("envmap", sd_env)):
        out.append((sky, sd, *cs.wf_inputs(torch, wf, mb, sd, cam,
                                            cs.BIG_SEED)))
    return out


def time_fused(kind: str, tag: str, reps: int) -> dict:
    """One build's K11 and K11g (``kind`` "k11") or K7m launches on config
    5's bounces 0 and 1 with either sky, in a process of its own; the
    stream made by the package's kernels as chip_smoke.py's checks make it.
    Each state is compared with the package's own launch on the same
    inputs (lanes whose bits differ)."""
    import torch
    import chip_smoke as cs
    import spt_tpu_torch as T
    from spt_tpu_torch.kernels import _build, megakernel_bvh as mb
    from spt_tpu_torch.kernels import wavefront as wf
    dev = torch.device("cuda")
    src_dir = _fused_dir(kind, tag)
    text = (src_dir / "wavefront.cu").read_text()
    lib = ctypes.CDLL(str(src_dir / "lib.so"))
    fn_b = lib.spt_ablate_blocks_per_sm
    fn_b.argtypes = [_I, _I]
    boxes_arg = "const void* boxes" in text
    slot_major = "cb + 8 * c" in text
    verdict_pass = "mxu_verdict_kernel" in text
    stream = torch.cuda.current_stream().cuda_stream
    row = {}
    for sky, sd, t, stc, meta in _fused_inputs(torch, cs, T, wf, mb, dev):
        block, n_mats, nls = stc["block"], stc["n_mats"], stc["n_light_slots"]
        prims = t["prims"]
        nb = prims.numel() // (5 * block)
        smem = 4 * (t["blob"].numel() + 8 + 6 + 3 + n_mats)
        lob, hib = wf._leaf_block_bounds(prims.reshape(-1, 5, block))
        boxes = wf.leaf_boxes(lob, hib)
        if kind == "k11":
            row["blocks_per_sm"] = dict(k11=fn_b(0, smem), k11g=fn_b(1, smem))
        else:
            if verdict_pass:
                lib.spt_wavefront_blocks_per_sm.argtypes = [_I, _I]
                fn_v = lib.spt_wavefront_mxu_verdicts_blocks_per_sm
                fn_v.argtypes = [_I]
                row["blocks_per_sm"] = dict(
                    k7m=lib.spt_wavefront_blocks_per_sm(6, smem - 32),
                    k7mv=fn_v(block))
            else:
                row["blocks_per_sm"] = dict(k7m=fn_b(2, smem - 32))
            cmat, bctr, cslot = wf.mxu_tables(dict(prims=prims), block)
            table = cslot if slot_major else cmat
        b = cs.wf_bounce(torch, wf, t, stc, meta, cs.BIG_W, cs.BIG_H, 0,
                         cs.BIG_SEED)
        for k in (0, 1):
            if k:
                b = cs.wf_advance(torch, wf, t, stc, meta, b, 0, cs.BIG_SEED,
                                  sd.sky_mode)
            n, st, ids, base = b["n"], b["st"], b["ids"], b["buf"].clone()
            kw = dict(k=k, block=block, n_mats=n_mats, n_light_slots=nls,
                      rr_depth=cs.RR, use_nee=True, use_mis=True,
                      sky_mode=sd.sky_mode)
            ints = [n, nb, block, n_mats, nls, k, cs.RR, 1, 1, sd.sky_mode]
            work = base.clone()
            w_st, w_ids = cs.stream_of(torch, wf, work)

            def run(case, launch, package):
                ms = []
                for _ in range(reps):
                    work.copy_(base)
                    ms.append(cs.cuda_ms(torch, launch)[1])
                got = work[:wf.N_CH, :n].clone()
                work.copy_(base)
                package()
                row[f"{sky}_bounce{k}_{case}"] = dict(
                    lanes=n, ms=min(ms), ms_all=ms,
                    lanes_differ_from_package=cs.bits_differ(
                        torch, got, work[:wf.N_CH, :n]))

            if kind == "k11":
                fn = lib.spt_wavefront_bounce
                fn.argtypes = [_P] * (13 if boxes_arg else 12) + [_I] * 13 \
                    + [_P]
                fn.restype = ctypes.c_int
                forms = [("lists", True, True), ("walk", False, False)]
                if boxes_arg:
                    forms.append(("lists_unculled", True, False))
                for form, precull, cull in forms:
                    recs = (False, True) if (sky, k) == ("gradient", 0) \
                        and form != "lists_unculled" else (False,)
                    for rec in recs:
                        res = torch.empty((8, n), device=dev) if rec else None
                        ptrs = [a.data_ptr() for a in (
                            w_st, w_ids, t["blob"], meta, t["lsb"],
                            t["nodef"], t["nodei"], prims, t["mtypes"],
                            b["cand"], b["ctn"])]
                        if boxes_arg:
                            ptrs.append(boxes.data_ptr() if cull else 0)
                        ptrs.append(0 if res is None else res.data_ptr())
                        args_k = (*ptrs, w_st.shape[1], n,
                                  t["nodef"].numel() // 64, *ints[1:],
                                  int(precull), stream)

                        def launch(args_k=args_k):
                            err = fn(*args_k)
                            if err:
                                raise RuntimeError(f"{tag}: launch {err}")

                        def package(precull=precull):
                            wf.bounce(t["blob"], meta, t["lsb"], t["nodef"],
                                      t["nodei"], prims, t["mtypes"],
                                      b["cand"], b["ctn"], w_st, w_ids, n,
                                      precull=precull, boxes=boxes, **kw)
                        run(form + ("_k11g" if rec else ""), launch, package)
                        del res
            else:
                fn = lib.spt_wavefront_shade
                fn.argtypes = [_P] * (13 if verdict_pass else 15) \
                    + [_I] * 14 + [_P]
                fn.restype = ctypes.c_int
                lists = wf.precull_tiles(
                    tuple(st[c, :n] for c in range(3)),
                    tuple(st[c, :n] for c in range(3, 6)),
                    st[wf.C_ALIVE, :n], None, lob, hib, per_row=True)
                res = wf.isect_mxu(prims, cmat, bctr, *lists, st, n,
                                   block=block)
                so3, sd3, stmax, sneed = wf.shadow_rays(
                    st[:, :n], ids[:, :n], res, t["blob"], t["lsb"], nls,
                    k=k, seed=cs.BIG_SEED, n_mats=n_mats,
                    mtypes=stc["mtypes"], n_light_slots=nls)
                scand, sctn = wf.precull_tiles(so3, sd3, sneed, stmax, lob,
                                               hib, per_row=True)
                sray = torch.stack([*so3, *sd3, stmax, sneed])
                res_v = res.clone()

                def package():
                    wf.shade_mxu(t["blob"], meta, t["lsb"], prims, cslot,
                                 bctr, t["mtypes"], scand, sctn, w_st, w_ids,
                                 res_v, n, sray=sray, **kw)
                if verdict_pass:
                    # The verdict pass, then K7b's kernel reading them.
                    fn_p = lib.spt_wavefront_mxu_verdicts
                    fn_p.argtypes = [_P] * 6 + [_I] * 3 + [_P]
                    fn_p.restype = ctypes.c_int
                    ptrs_v = (res_v[7].data_ptr(), sray.data_ptr(),
                              table.data_ptr(), bctr.data_ptr(),
                              scand.data_ptr(), sctn.data_ptr(), n, nb,
                              block, stream)
                    ptrs_b = [a.data_ptr() for a in (
                        w_st, w_ids, res_v, t["blob"], meta, t["lsb"],
                        prims, t["mtypes"])]
                    args_b = (*ptrs_b, 0, 0, 0, 0, 0, w_st.shape[1],
                              *ints, 1, 0, 1, stream)

                    def pass_only():
                        err = fn_p(*ptrs_v)
                        if err:
                            raise RuntimeError(f"{tag}: verdicts {err}")

                    def launch():
                        pass_only()
                        err = fn(*args_b)
                        if err:
                            raise RuntimeError(f"{tag}: K7b launch {err}")
                    run("verdict_pass", launch, package)
                    row[f"{sky}_bounce{k}_verdict_pass"]["pass_ms"] = min(
                        cs.cuda_ms(torch, pass_only)[1] for _ in range(reps))
                else:
                    # An earlier K7m: the sweep inside the bounce.
                    ptrs = [a.data_ptr() for a in (
                        w_st, w_ids, res, t["blob"], meta, t["lsb"], prims,
                        t["mtypes"], scand, sctn)]
                    args_k = (*ptrs, 0, table.data_ptr(), bctr.data_ptr(), 0,
                              0, w_st.shape[1], *ints, 0, 0, 1, stream)

                    def launch():
                        err = fn(*args_k)
                        if err:
                            raise RuntimeError(f"{tag}: launch {err}")
                    run("lists", launch, package)
                del lists, res, res_v, scand, sctn, sray
            del base, work
        del b
        torch.cuda.empty_cache()
    return row


def main_fused(args, kinds) -> int:
    """Build K11's or K7m's variants, then time each build in a process of
    its own, the reference first and again last."""
    from spt_tpu_torch.kernels import _build
    t0 = time.perf_counter()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    print(card, flush=True)
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    _build.build("wavefront")       # the package's, which makes the stream
    jobs = []
    for kind in kinds:
        ours, old = FUSED[kind]
        jobs += [(kind, tag, _build.CSRC, edits)
                 for tag, edits in ours.items()]
        if args.old is not None:
            jobs += [(kind, tag, args.old, edits)
                     for tag, edits in old.items()]
    if args.only:
        jobs = [j for j in jobs if j[1] in args.only]
    with ThreadPoolExecutor(len(jobs)) as pool:
        facts = {(kind, tag): f for (kind, *_), (tag, f) in zip(
            jobs, pool.map(lambda j: build_fused(*j), jobs))}
    print(json.dumps(dict(phase="build", seconds=time.perf_counter() - t0,
                          builds=[f"{k}:{t}" for k, t in facts])), flush=True)
    for kind in kinds:
        tags = [t for k, t in facts if k == kind]
        if not tags:
            continue
        ref = tags[0]
        for n, tag in enumerate([ref] + tags[1:] + [ref]):
            row = dict(kernel=kind, variant=tag, card=card, run=n,
                       **facts[kind, tag])
            try:
                proc = subprocess.run(
                    [sys.executable, __file__, "--reps", str(args.reps),
                     "--time-fused", kind, tag],
                    capture_output=True, text=True, timeout=args.timeout)
            except subprocess.TimeoutExpired as e:
                row.update(hung=True, log=str(e.stdout)[-800:])
            else:
                if proc.returncode != 0:
                    row.update(faulted=True,
                               log=(proc.stdout + proc.stderr)[-1500:])
                else:
                    row.update(json.loads(
                        proc.stdout.strip().splitlines()[-1]))
            print(json.dumps(row), flush=True)
    print(json.dumps(dict(seconds=time.perf_counter() - t0)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
