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
           "k7": ("shade_kernelILb0ELb0ELb1E", 1),
           "k11": ("bounce_kernelILb0", 2), "k8l": ("anyhit_kernel", 3),
           "k10": ("bounce_bwd_kernel", 4),
           "k8": ("shade_kernelILb0ELb0ELb0E", 5),
           "k7b": ("shade_kernelILb0ELb1E", 6)}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--only", nargs="*", default=None,
                    help="build and time only these variants")
    ap.add_argument("--prim", action="store_true",
                    help="time the prim-sharded path's K6 and K8")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("wf_ablate: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
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


if __name__ == "__main__":
    sys.exit(main())
