// The sorted wavefront's kernels, for environment-map skies and scenes
// above 2048 spheres: K5 (raygen), K6 (intersect) and K7 (shade), their
// matmul forms K6m and K7m, the fused bounce K11, and K8-K10 and K11g for
// the sharded and differentiable renders.
//
// The wavefront keeps every ray's state in device memory between kernels,
// channel-major: a (17, R) float32 stream (o, d, throughput, radiance,
// prev_pdf, alive, spec, in_image, miss; wavefront.py's C_* map) and two
// int32 id rows (pixel id, sample id), stored as rows 17 and 18 of one
// (19, R) buffer so that the sort between bounces gathers all of them at
// once.  R is a multiple of the 1024-lane tile.  Between the kernels the
// glue (torch ops in kernels/wavefront.py) sorts the stream by a coherence
// key.  On the split path K6 and K7 walk the packed tree one thread a ray
// (BvhWalk, bvh.cuh, as K3 and K11 do), and on the prim-sharded path K6
// and K8 walk the shard's tree (the packed tree cut to its leaf blocks,
// megakernel_bvh.py::shard_tree), so the glue builds no lists there; the
// matmul form and the fused bounce with its precull still cull each
// tile's (or row's) rays against every leaf block's box (the precull: one
// candidate list a group, nearest-first), and K8's and K7's list forms,
// which the tools and checks still launch, sweep shadow rays rebuilt and
// culled by the glue.
//
// * K5 replaces spt_tpu/kernels/wavefront.py::_raygen_kernel (launched by
//   _raygen_launch): the initial state of every lane of chunk_spp images
//   in 32x32 swizzled pixel tiles, plus one all-pad tile.  One thread per
//   lane.  Bound: bytes, the 76 bytes it writes per lane.  Neighbouring
//   threads store neighbouring addresses of each channel.
// * K6 replaces wavefront.py::_isect_kernel (and the sweep it calls,
//   megakernel_bvh.py::_cand_sweep_nearest): every ray's nearest hit,
//   written as an 8-channel residual (hcx hcy hcz hr hmid hblk hslot 0;
//   hmid -1 where nothing was hit, or where a leaf's padding slot won).  One
//   thread per ray.  Tree mode (the split path, and on the prim-sharded
//   path the shard's tree, whose block ids are local): each thread walks
//   the tree (BvhWalk::nearest_slot), stack-free, its octant's table, a
//   slab test a node; the residual is the one K11g's walk records.  The TPU
//   walked a 1024-ray packet behind one scalar node pointer, a serial
//   chain on its scalar unit, and so took lists instead; a thread walks its
//   own ray here.  List mode (K6l; the tools and checks launch it): the
//   tile's candidate blocks in order, the 1024 threads of a tile reading
//   the same entries and blocks (broadcast loads through L1); the TPU kernel
//   stops a whole packet once the next candidate's entry bound passes the
//   packet's worst winner, each thread here stops on its own once the bound
//   passes its own winner (a later block cannot hold a nearer hit: t >= box
//   entry >= ctn[i] >= t_lane), so no thread waits for its tile and the
//   block needs no syncs.  Bound: fp32 operations of the node and sphere
//   tests.
// * K7 replaces wavefront.py::_shade_kernel: trace_bounce (physics.cuh) on
//   every alive ray, its nearest hit rebuilt from K6's residual (the TPU's
//   megakernel_bvh_grad.py::_rebuilt_intersect) and its shadow ray walking
//   the tree (BvhWalk::any_hit, as K11's shadow rays do), each thread
//   stopping at its first blocker below the light distance trace_bounce
//   gives it; without the tree (a wrapper given lists) the tile's shadow
//   candidate list in place of the walk (megakernel_bvh.py::
//   _cand_sweep_anyhit), stopping at the first blocker or once the next
//   candidate's entry bound passes the light distance.  Updates the stream
//   in place (the TPU kernel's alias); a dead lane keeps its state and has
//   its miss flag cleared.  Bound: fp32 operations of the bounce and the
//   shadow walks, or the bytes, 152 an alive ray (15 state channels read,
//   all but in_image and miss, its two ids and 5 residual channels, hcx hcy
//   hcz hr hmid, and 16 channels written, all but in_image), and the tree.
//   One thread per ray, its state in registers; the scene uniforms sit in
//   shared memory.
//
//   With blocked_in_res (K7's mode for the prim-sharded render, the TPU
//   kernel's blocked_in_res=True, launched at spt_tpu/parallel/
//   wavefront_prim.py:214) nothing is swept: each shadow verdict is read
//   from residual row 7, where the glue put the MAX over the prim shards of
//   K8's verdicts.  Bound: K7's bytes less the tree, plus 4 bytes a shadow
//   ray.
// * K8 replaces wavefront.py::_anyhit_kernel (launched at spt_tpu/parallel/
//   wavefront_prim.py:195): the occlusion verdicts of one prim shard's
//   leaf blocks.  The TPU kernel took shadow rays that XLA glue rebuilt
//   from the merged winner and swept the precull's lists; here K8 is K9
//   (shade_kernel, kStore false): each thread runs its lane's bounce on the
//   merged winner (the same called wf_bounce as K7b, so the shadow ray is
//   K7b's bit for bit), its shadow ray walking the shard's tree
//   (BvhWalk::any_hit), and writes the verdict, not the path: 1 where
//   blocked, 0 where no shadow ray was traced or it was not blocked.  No
//   glue, no shadow-ray tensor, no lists.  Bound: fp32 operations of the
//   shadow setup and walks, or the bytes (the ray, ids and winner in, the
//   verdict out, the shard's tree).
//   K8l, its list form (anyhit_kernel; on no render path): verdicts of
//   shadow rays given as 8 channels (pox poy poz ldx ldy ldz tmax need),
//   by K7's sweep (WavefrontGeometry::sweep) of the tile's shadow list.
//   One thread per lane, no shared memory, no syncs.
// * K9 replaces spt_tpu/kernels/wavefront_grad.py::_shade_fwd_kernel
//   (launched by _shade_op): K7 on a copy of the stream (kernels/
//   wavefront_grad.py clones it, since the backward keeps the pre-bounce
//   state), also writing each lane's NEE shadow verdict, the one record
//   the backward needs that K6 does not make.  The same kernel and the same
//   called bounce as K7, given a verdict row, so K9's state is K7's bit
//   for bit.  Bound: K7's bytes and 4 more a lane.
// * K10 replaces wavefront_grad.py::_bounce_bwd_kernel (launched by
//   _bwd_pallas_call): one bounce's adjoint.  One thread per lane replays
//   its bounce through bounce_vjp (physics_adj.cuh) on the winner rebuilt
//   from the residual and the recorded verdict (RebuiltGeometry), taking
//   the post-bounce cotangent to the pre-bounce one.  Each lane keeps its
//   share of theta's cotangent in registers (LaneSink); its warp sums the
//   shares of lanes that meet on a sky, material or light row into the
//   warp's copy of the scalar vector in shared memory, added to the
//   global vector once a block, and sums the winners' centre and radius
//   cotangents of lanes that share a leaf slot (neighbours of the sorted
//   stream often do), one lane adding each sum into the prim table
//   d(prims) by a global atomic.  So the step scatters no per-lane
//   cotangents after the kernel, as the TPU kernel's caller does, and no
//   lane waits on another's shared atomic.
//   Bound: the bytes, about 200 an alive lane (the replay's fp32
//   operations come close); built for kBwdMinBlocks blocks an SM.
// * K6m and K7m replace wavefront.py::_isect_kernel_mxu (:524) and
//   _shade_kernel_mxu (:668; both launched only with mxu=True): K6's and
//   K7's contracts over per-row lists (a list per 128-lane row), a slot's
//   quadratic in the expanded, block-centred form of megakernel_bvh.py::
//   _row_quadratic (16 products of the block's (8, 2 block) build_cmat
//   table and the ray a slot, 2.4 times the compact form's operations),
//   K7m's shadow test without a square root (_seg_blocked).  The TPU ran
//   the products on its matrix unit at Precision.HIGHEST and took the
//   winner's attributes by a one-hot product; here each thread does them
//   in float32 on the CUDA cores, in the plain version's order, and reads
//   the winner from prims: the same values, bit for bit with the plain
//   version.  Tensor cores would round to TF32 (ROADMAP.md, item 14).
//   Bound: fp32 operations of the expanded tests.  K6m is K6's kernel, the
//   form a template parameter.  K7m is two launches: a verdict pass
//   (mxu_verdict_kernel), writing K6m's residual row 7, and K7b's kernel
//   reading its verdicts there.  Swept
//   inside the bounce, as K7's lists are, the shadow test was bound by
//   latency: the row's lanes reached it at different points of a
//   divergent bounce, each slot's columns 16 dependent loads 2 block
//   floats apart, one block of 154 registers an SM.  The pass takes the
//   shadow rays the glue built the row lists for, and a row's four warps
//   sweep its list together over each candidate's table, staged once in
//   shared memory by cp.async from a slot-major copy (two buffers, the
//   next candidate's copy in flight), a column two 16-byte reads, the 8
//   products in the plain version's order, so the same bits.
// * K11 replaces wavefront.py::_bounce_kernel (:194, launched at :1139
//   with split=False), K11g wavefront_grad.py::_bounce_fwd_kernel (:86,
//   launched at :573): the whole bounce in one kernel, in place on the
//   stream.  The nearest hit by K6's sweep of the tile's list (precull) or
//   by K6's walk of the tree (BvhWalk, a node pointer per thread, where
//   the TPU walked a packet behind one scalar pointer and a frustum test:
//   pruning only, no result changes); every shadow ray walks the tree, as
//   K7's do; trace_bounce on the winner, a padding
//   winner resolved as JAX's fused bounce resolves it (kNoMaterial).
//   K11g (kRecord) writes K6's residual and the shadow verdict in row 7,
//   which K10 replays.  One thread per ray, its walk stack-free.  A tile's
//   list is the union over 1024 rays; after bounce 0 their directions
//   scatter, and a ray swept every slot of blocks its own ray misses.  So
//   the list sweep tests each candidate's box (the leaf blocks' boxes the
//   glue culls with, passed in) against the lane's own ray first and skips
//   a block the ray misses or enters past its nearest t so far
//   (list_nearest given the boxes); the plain version skips the same
//   blocks.  The bounce is inlined (trace_bounce, as K3 and K4 have it)
//   and the kernel built for kBounceMinBlocks blocks an SM.  Bound: fp32
//   operations of the walks and the bounce (the bytes: the state, the
//   lists, the tree).
//
// Lanes past the alive prefix (the sorted stream's dead suffix) are not
// launched: K6, K7, K9 and K11 take the prefix length, where the TPU kernels
// redirect those grid steps to the pad tile.  K10 copies their cotangent
// through, as the TPU kernel's alias does.
//
// Built with nvcc for sm_90a without --use_fast_math and with --fmad=false
// (see kernels/_build.py); entries return cudaGetLastError().

#include <cuda_runtime.h>

#include <cstdint>

#include "bvh.cuh"
#include "camera.cuh"
#include "physics.cuh"
#include "physics_adj.cuh"
#include "rng.cuh"

namespace spt {

constexpr int kTile = 1024;                // lanes of a stream tile
constexpr int kRow = 128;                  // lanes of a row (K6m's, K7m's lists)
constexpr int kTileW = 32;                 // its pixels: 32 x 32, swizzled
constexpr int kThreadsWf = 256;
// Blocks an SM that K7 and K9 (shade_kernel<false, true>) are built for:
// 64 registers with 132 B of spills, where the compiler alone takes 120
// registers and 2 blocks; on an H100 23% faster over a config-5 chunk,
// the same bits (tools/wf_ablate.py's k7_lb_* builds; PERF.md).  K7
// reading its verdicts runs 2.6 times slower so built, and is not.
constexpr int kShadeMinBlocks = 4;
// Blocks an SM that K8 (shade_kernel<false, false>) is built for.
constexpr int kVerdictMinBlocks = 4;
// Blocks an SM that K10 (bounce_bwd_kernel) is built for: 2, 128
// registers with 172 B of spills; on an H100 30% faster at config-5
// bounce 0 than the compiler's own 154 registers and 1 block, and 1, 3
// or 4 blocks were all slower (tools/wf_ablate.py --k10; PERF.md).
constexpr int kBwdMinBlocks = 2;
// Blocks an SM that K11 and K11g (bounce_kernel) are built for: 5, 48
// registers with 312 B of spills; on an H100 at config-5 bounces 0 and 1
// 5-7% faster than 2 or 3 blocks (80 registers), 4 and 6 within 1%
// (tools/wf_ablate.py --k11; PERF.md).
constexpr int kBounceMinBlocks = 5;
constexpr int kNCh = 17;                   // float channels of the stream
constexpr int kChAlive = 13, kChSpec = 14, kChInimg = 15, kChMiss = 16;
constexpr int kWfMatOff = 21;              // blob: camera 15, sky 6, mats
constexpr int kWfMatStride = 8;            // ar ag ab er eg eb rough ior
constexpr int kWfLightStride = 7;          // cx cy cz r er eg eb
constexpr int kWfPrimAttrs = 5;            // cx cy cz r material-id
constexpr int kSkyEnvmap = 3;

// ---------------------------------------------------------------------------
// K5: raygen.
// ---------------------------------------------------------------------------

struct RaygenParams {
  float* st;            // (17, R)
  int* ids;             // (2, R), row stride R
  const float* blob;    // camera at 0..14
  const int* meta;      // start_sample, seed, n_lights
  int width, height, tiles_x, tiles_per_img, n_tiles, n_lanes;
  bool dof;
  float inv_w, inv_h, aspect;
};

__global__ void __launch_bounds__(kThreadsWf) raygen_kernel(RaygenParams prm) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= prm.n_lanes) return;
  const int tile = i / kTile, lin = i % kTile;
  const int s_idx = tile / prm.tiles_per_img;
  const int timg = tile % prm.tiles_per_img;
  const int px = (timg % prm.tiles_x) * kTileW + lin % kTileW;
  const int py = (timg / prm.tiles_x) * kTileW + lin / kTileW;
  const bool in_image =
      px < prm.width && py < prm.height && tile < prm.n_tiles;
  const int pxc = min(px, prm.width - 1), pyc = min(py, prm.height - 1);
  const uint32_t pid = (uint32_t)(pyc * prm.width + pxc);
  const uint32_t sample = (uint32_t)(__ldg(prm.meta) + s_idx);
  const uint32_t seed = (uint32_t)__ldg(prm.meta + 1);
  float cam[15];
  for (int a = 0; a < 15; ++a) cam[a] = __ldg(prm.blob + a);
  Path p;
  raygen(cam, prm.inv_w, prm.inv_h, prm.aspect, prm.dof, pid, (float)pxc,
         (float)pyc, sample, seed, p);
  const float img = in_image ? 1.0f : 0.0f;
  const float v[kNCh] = {p.ox, p.oy, p.oz, p.dx, p.dy, p.dz, 1.0f, 1.0f,
                         1.0f, 0.0f, 0.0f, 0.0f, 0.0f, img, 1.0f, img, 0.0f};
  const size_t n = (size_t)prm.n_lanes;
  for (int c = 0; c < kNCh; ++c) prm.st[c * n + i] = v[c];
  prm.ids[i] = (int)pid;
  prm.ids[n + i] = (int)sample;
}

// ---------------------------------------------------------------------------
// The candidate-list sweeps, over a ray's sphere tests in one of two forms.
// ---------------------------------------------------------------------------

// A ray against the slots of one leaf block at a time, in the compact form
// of K6, K7 and K8: the quadratic on each slot's centre and radius.
struct CompactSlots {
  const float* prims;   // (n_blocks, 5, block)
  int block;
  float ox, oy, oz, dx, dy, dz;
  const float* pb;      // the block begun

  __device__ __forceinline__ void begin(int blk) {
    pb = prims + (size_t)blk * kWfPrimAttrs * block;
  }
  // Slot j's root past TMIN, where the ray meets its sphere.
  __device__ __forceinline__ bool hit(int j, float& tj) const {
    return sphere_t4(__ldg(pb + j), __ldg(pb + block + j),
                     __ldg(pb + 2 * block + j), __ldg(pb + 3 * block + j), ox,
                     oy, oz, dx, dy, dz, tj);
  }
  __device__ __forceinline__ bool blocks(int j, float tmax) const {
    float tj;
    return hit(j, tj) && tj < tmax;
  }
};

// The same in the expanded, block-centred form of K6m and K7m (the JAX
// package's _row_quadratic, a matmul on the TPU): with o' = o - bctr[blk]
// and A = (dx, dy, dz, 0, o'x, o'y, o'z, 1), column c of the block's
// (8, 2 block) table (build_cmat) dotted with A, its 8 products summed in
// order, is b + d.o' (c = j) and cterm - |o'|^2 (c = block + j).  Float32
// on the CUDA cores, in the plain version's order.  kStaged (K7m's
// verdict pass): the block's table is begun where the pass staged it in
// shared memory, from the table's slot-major copy, (n_blocks, 2 block,
// 8): a column is 8 adjacent floats, two 16-byte reads, where
// build_cmat's layout (K6m's, read from global memory) puts them 2 block
// floats apart.
template <bool kStaged>
struct ExpandedSlots {
  const float* cmat;    // K6m: (n_blocks, 8, 2 block); staged: unread
  const float* bctr;    // (n_blocks, 3)
  int block;
  float ox, oy, oz, dx, dy, dz;
  const float* cb;      // the block begun: its table, its A, d.o', |o'|^2
  float a[8];
  float dor, o2;

  __device__ __forceinline__ void begin(int blk) {
    begin_at(cmat + (size_t)blk * 16 * block, blk);
  }
  // Block blk, its table read at `table`.
  __device__ __forceinline__ void begin_at(const float* table, int blk) {
    cb = table;
    const float opx = ox - __ldg(bctr + 3 * blk);
    const float opy = oy - __ldg(bctr + 3 * blk + 1);
    const float opz = oz - __ldg(bctr + 3 * blk + 2);
    a[0] = dx;
    a[1] = dy;
    a[2] = dz;
    a[3] = 0.0f;
    a[4] = opx;
    a[5] = opy;
    a[6] = opz;
    a[7] = 1.0f;
    dor = dx * opx + dy * opy + dz * opz;
    o2 = opx * opx + opy * opy + opz * opz;
  }
  __device__ __forceinline__ float column(int c) const {
    if constexpr (kStaged) {
      const float4* q = reinterpret_cast<const float4*>(cb + 8 * c);
      const float4 u = q[0], v = q[1];
      float sum = u.x * a[0];
      sum = sum + u.y * a[1];
      sum = sum + u.z * a[2];
      sum = sum + u.w * a[3];
      sum = sum + v.x * a[4];
      sum = sum + v.y * a[5];
      sum = sum + v.z * a[6];
      sum = sum + v.w * a[7];
      return sum;
    } else {
      float sum = __ldg(cb + c) * a[0];
      for (int r = 1; r < 8; ++r)
        sum = sum + __ldg(cb + r * 2 * block + c) * a[r];
      return sum;
    }
  }
  __device__ __forceinline__ bool hit(int j, float& tj) const {
    const float b = column(j) - dor;
    const float cterm = column(block + j) + o2;
    const float disc = b * b - cterm;
    if (!(disc > 0.0f)) return false;
    const float sq = sqrtf(fmaxf(disc, 1e-12f));
    const float t0 = b - sq;
    tj = (t0 > kTmin) ? t0 : b + sq;
    return tj > kTmin;
  }
  // The JAX package's _seg_blocked: the root trace_bounce takes lies in
  // (TMIN, tmax), decided without a square root, its strict inequalities
  // as written there.
  __device__ __forceinline__ bool blocks(int j, float tmax) const {
    const float b = column(j) - dor;
    const float cterm = column(block + j) + o2;
    const float disc = b * b - cterm;
    const float p = b - kTmin, q = b - tmax;
    const float pp = p * p, qq = q * q;
    const bool t0_gt = p > 0.0f && disc < pp;
    const bool t0_lt = q < 0.0f || disc > qq;
    const bool t1_ok = (p > 0.0f || disc > pp) && (q < 0.0f && disc < qq);
    return disc > 0.0f && ((t0_gt && t0_lt) || (!t0_gt && t1_ok));
  }
};

// A leaf block's box, row blk of `boxes` (8 floats a row: lo xyz, hi xyz,
// 2 pad, as a tree node's row), against the ray: BvhWalk::node's slab
// test and its arithmetic, below tmax.
__device__ __forceinline__ bool box_hit(const float* boxes, int blk,
                                        float ox, float oy, float oz,
                                        float ivx, float ivy, float ivz,
                                        float tmax) {
  const float4* f = reinterpret_cast<const float4*>(boxes) + 2 * blk;
  const float4 a = __ldg(f), b = __ldg(f + 1);
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
  return tn <= tf && tf > kTmin && tn < tmax;
}

// A ray's nearest hit over its list (cl: count, block ids; tl: their entry
// bounds, nondecreasing): candidates in order, a block's slots in order
// with a strict '<', stopping once the next candidate's bound reaches the
// nearest distance so far (a later block cannot hold a nearer hit: t >=
// box entry >= bound >= t_lane).  t: kBig or less in, the nearest out.
// Returns the winner's block, -1 for none, and its slot in win_j.
// With boxes (K11's sweep) each candidate's box is tested against the
// lane's own ray first, and a block the ray misses, or enters at or past
// the nearest t so far, is skipped: the winner stays the same but where
// the float slab test and quadratic disagree at a box's edge, or a padding
// slot (outside its block's box) would have won.  A warp skips a block
// that none of its lanes needs.  Without boxes (null: K6's and K6m's
// lists) the box test compiles away.
template <class Slots>
__device__ __forceinline__ int list_nearest(const int* cl, const float* tl,
                                            const float* boxes, Slots& s,
                                            float& t, int& win_j) {
  const float ivx = safe_inv(s.dx), ivy = safe_inv(s.dy),
              ivz = safe_inv(s.dz);
  int win_blk = -1;
  const int ncand = __ldg(cl);
  for (int c = 0; c < ncand; ++c) {
    if (__ldg(tl + c) >= t) break;        // no nearer hit in what is left
    const int blk = __ldg(cl + 1 + c);
    if (boxes && !box_hit(boxes, blk, s.ox, s.oy, s.oz, ivx, ivy, ivz, t))
      continue;
    s.begin(blk);
    for (int j = 0; j < s.block; ++j) {
      float tj;
      if (s.hit(j, tj) && tj < t) {
        t = tj;
        win_blk = blk;
        win_j = j;
      }
    }
  }
  return win_blk;
}

// Whether a shadow ray is blocked before tmax: the list in order, stopping
// at the first blocker or once the next candidate's bound reaches tmax
// (every later box is past the light).
template <class Slots>
__device__ __forceinline__ bool list_anyhit(const int* cl, const float* tl,
                                            Slots& s, float tmax) {
  const int ncand = __ldg(cl);
  for (int c = 0; c < ncand; ++c) {
    if (__ldg(tl + c) >= tmax) break;
    s.begin(__ldg(cl + 1 + c));
    for (int j = 0; j < s.block; ++j)
      if (s.blocks(j, tmax)) return true;
  }
  return false;
}

// A lane's state in and out of registers.
__device__ __forceinline__ void load_path(const float* st, size_t s, Path& p) {
  p.ox = st[0];
  p.oy = st[s];
  p.oz = st[2 * s];
  p.dx = st[3 * s];
  p.dy = st[4 * s];
  p.dz = st[5 * s];
  p.th_r = st[6 * s];
  p.th_g = st[7 * s];
  p.th_b = st[8 * s];
  p.rad_r = st[9 * s];
  p.rad_g = st[10 * s];
  p.rad_b = st[11 * s];
  p.prev_pdf = st[12 * s];
  p.active = true;
  p.prev_spec = st[kChSpec * s] > 0.5f;
}

// All channels but in_image: the miss flag set where the path missed under
// an environment-map sky.
__device__ __forceinline__ void store_path(float* st, size_t s, const Path& p,
                                           bool missed, int sky_mode) {
  st[0] = p.ox;
  st[s] = p.oy;
  st[2 * s] = p.oz;
  st[3 * s] = p.dx;
  st[4 * s] = p.dy;
  st[5 * s] = p.dz;
  st[6 * s] = p.th_r;
  st[7 * s] = p.th_g;
  st[8 * s] = p.th_b;
  st[9 * s] = p.rad_r;
  st[10 * s] = p.rad_g;
  st[11 * s] = p.rad_b;
  st[12 * s] = p.prev_pdf;
  st[kChAlive * s] = p.active ? 1.0f : 0.0f;
  st[kChSpec * s] = p.prev_spec ? 1.0f : 0.0f;
  st[kChMiss * s] = (missed && sky_mode == kSkyEnvmap) ? 1.0f : 0.0f;
}

// ---------------------------------------------------------------------------
// K6 and K6m: intersect.
// ---------------------------------------------------------------------------

struct IsectParams {
  float* res;           // (8, n_lanes)
  const float* st;      // channel stride `stride`
  const float* prims;   // (n_blocks, 5, block)
  const int* cand;      // (groups, n_blocks + 1): count, block ids
  const float* ctn;     // (groups, n_blocks): entry bounds, nondecreasing
  const float* cmat;    // K6m: (n_blocks, 8, 2 block); K6: null
  const float* bctr;    // K6m: (n_blocks, 3)
  const float* nodef;   // K6's tree mode: 8 tables x n_nodes rows of 8;
  const int* nodei;     //   cand, ctn unread.  Null: the lists
  int stride, n_lanes, n_blocks, block, n_nodes;
};

// K6 (kMxu false: the tree, or a list a tile, the compact form) and K6m (a
// list a row, the expanded form): the winner's attributes read from prims
// either way.
template <bool kMxu>
__global__ void __launch_bounds__(kThreadsWf) isect_kernel(IsectParams prm) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= prm.n_lanes) return;
  const size_t s = (size_t)prm.stride;
  const float* st = prm.st + i;
  float t = kBig;
  int win_blk = -1, win_j = 0;
  if (st[kChAlive * s] > 0.5f) {
    const float ox = st[0], oy = st[s], oz = st[2 * s];
    const float dx = st[3 * s], dy = st[4 * s], dz = st[5 * s];
    const int group = kMxu ? i / kRow : i / kTile;
    const int* cl = prm.cand + (size_t)group * (prm.n_blocks + 1);
    const float* tl = prm.ctn + (size_t)group * prm.n_blocks;
    if constexpr (kMxu) {
      ExpandedSlots<false> slots{prm.cmat, prm.bctr, prm.block, ox, oy, oz,
                                 dx, dy, dz};
      win_blk = list_nearest(cl, tl, nullptr, slots, t, win_j);
    } else if (prm.nodef) {
      const BvhWalk<false> walk{prm.nodef, prm.nodei, prm.prims, nullptr,
                                nullptr, nullptr, nullptr, prm.n_nodes,
                                prm.block, nullptr};
      win_blk = walk.nearest_slot(ox, oy, oz, dx, dy, dz, t, win_j);
    } else {
      CompactSlots slots{prm.prims, prm.block, ox, oy, oz, dx, dy, dz};
      win_blk = list_nearest(cl, tl, nullptr, slots, t, win_j);
    }
  }
  const size_t n = (size_t)prm.n_lanes;
  float* out = prm.res + i;
  if (win_blk >= 0) {
    const float* pb =
        prm.prims + (size_t)win_blk * kWfPrimAttrs * prm.block + win_j;
    for (int a = 0; a < kWfPrimAttrs; ++a) out[a * n] = __ldg(pb + a * prm.block);
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

// ---------------------------------------------------------------------------
// K7: shade.
// ---------------------------------------------------------------------------

// K7's geometry: the lane's nearest hit rebuilt from K6's winner, and its
// shadow test: a walk of the tree (nodef non-null), or its tile's shadow
// candidate list, or the verdict read from the residual (blocked_in_res:
// K7b's and K7m's).  With `blocked` (K9) the shadow test also writes its
// verdict there.
struct WavefrontGeometry {
  static constexpr int kLightEmit = 4;
  float hcx, hcy, hcz, hr, hmid;
  const float* prims;   // (n_blocks, 5, block)
  const int* scl;       // the lane's shadow list: count, block ids
  const float* stl;     // its entry bounds
  const float* mats;    // n_mats rows of kWfMatStride
  const int* mtypes;    // n_mats
  const float* lights;  // kWfLightStride per slot
  int block;
  float* blocked;       // K9: this lane's verdict; K7: null
  const float* verdict; // blocked_in_res: residual row 7 at this lane; else
                        // null (sweep the shadow list)
  const float* nodef;   // the tree (shadow rays walk it), or null (lists)
  const int* nodei;
  int n_nodes;

  // The winner's quadratic again, on the same floats K6 used (the TPU's
  // _rebuilt_intersect); no hit where K6 found none (hmid < 0, which is
  // also a padding slot's id).
  __device__ __forceinline__ bool nearest(float ox, float oy, float oz,
                                          float dx, float dy, float dz,
                                          float& t, Hit& h) const {
    if (!(hmid >= 0.0f)) return false;
    const float ocx = hcx - ox, ocy = hcy - oy, ocz = hcz - oz;
    const float b = dot3(dx, dy, dz, ocx, ocy, ocz);
    const float cterm = dot3(ocx, ocy, ocz, ocx, ocy, ocz) - hr * hr;
    const float disc = b * b - cterm;
    if (!(disc > 0.0f)) return false;
    const float sq = sqrtf(fmaxf(disc, 1e-12f));
    t = (b - sq > kTmin) ? b - sq : b + sq;
    const int mid = (int)hmid;
    h.cx = hcx;
    h.cy = hcy;
    h.cz = hcz;
    h.r = hr;
    h.mat = mats + kWfMatStride * mid;
    h.mtype = mtypes[mid];
    return true;
  }

  __device__ __forceinline__ bool occluded(float ox, float oy, float oz,
                                           float dx, float dy, float dz,
                                           float tmax) const {
    const bool hit =
        verdict ? *verdict > 0.5f
        : nodef ? BvhWalk<false>{nodef, nodei, prims, nullptr, nullptr,
                                 nullptr, nullptr, n_nodes, block, nullptr}
                      .any_hit(ox, oy, oz, dx, dy, dz, tmax)
                : sweep(ox, oy, oz, dx, dy, dz, tmax);
    if (blocked) *blocked = hit ? 1.0f : 0.0f;
    return hit;
  }

  __device__ __forceinline__ bool sweep(float ox, float oy, float oz,
                                        float dx, float dy, float dz,
                                        float tmax) const {
    CompactSlots slots{prims, block, ox, oy, oz, dx, dy, dz};
    return list_anyhit(scl, stl, slots, tmax);
  }

  __device__ __forceinline__ const float* light(int l) const {
    return lights + kWfLightStride * l;
  }
};

// One bounce, called rather than inlined, by shade_kernel (K7, K7b, K7m,
// K8, K9): K8 traces the shadow rays K7b's bounce would, bit for bit,
// through this same call, and K7's list form sweeps lists the glue culled
// for its shadow rays.  K11 and K11g inline their bounce, as K3 and K4
// do; each is held bit for bit against its plain version and the split
// bounce (chip_smoke.py).
template <class Geometry>
__device__ __noinline__ bool wf_bounce(const SceneView& sc,
                                       const Geometry& geo, Path& p,
                                       uint32_t pid, uint32_t sample,
                                       uint32_t seed, int k, int rr_depth,
                                       bool use_nee, bool use_mis) {
  return trace_bounce(sc, geo, p, pid, sample, seed, k, rr_depth, use_nee,
                      use_mis);
}

struct ShadeParams {
  float* st;            // (17, stride), updated in place
  const int* ids;       // (2, stride)
  const float* res;     // (8, n_lanes)
  const float* blob;    // 21 + 8 * n_mats + 7 * max(n_light_slots, 1)
  const int* meta;      // start_sample, seed, n_lights
  const float* lsb;     // 6
  const float* prims;
  const int* mtypes;    // n_mats
  const int* scand;     // (groups, n_blocks + 1), unread without NEE, with
  const float* sctn;    // (groups, n_blocks)       the tree or the verdicts
  float* blocked;       // K9: (n_lanes,) shadow verdicts; K7: null
  const float* nodef;   // the shadow walk's tree: 8 tables x n_nodes rows;
  const int* nodei;     //   null: the lists
  int stride, n_lanes, n_blocks, block, n_mats, n_light_slots, k, rr_depth;
  int sky_mode, blob_len, n_nodes;
  bool use_nee, use_mis;
};

// K7 and K9 (the shadow walk or a tile's shadow list), K7's
// blocked_in_res mode (kVerdict: the verdicts; K7b, and K7m after its
// verdict pass), and K8 (kStore false: K9's verdicts alone, the stream
// read and not written).
template <bool kVerdict, bool kStore = true>
__global__ void __launch_bounds__(kThreadsWf,
                                  kVerdict ? 1
                                  : kStore ? kShadeMinBlocks
                                           : kVerdictMinBlocks)
    shade_kernel(ShadeParams prm) {
  extern __shared__ float smem[];
  float* s_blob = smem;
  float* s_lsb = s_blob + prm.blob_len;                 // 6
  int* s_meta = reinterpret_cast<int*>(s_lsb + 6);      // 3
  int* s_mtypes = s_meta + 3;                           // n_mats
  for (int a = threadIdx.x; a < prm.blob_len; a += blockDim.x)
    s_blob[a] = prm.blob[a];
  for (int a = threadIdx.x; a < prm.n_mats; a += blockDim.x)
    s_mtypes[a] = prm.mtypes[a];
  if (threadIdx.x < 6) s_lsb[threadIdx.x] = prm.lsb[threadIdx.x];
  if (threadIdx.x < 3) s_meta[threadIdx.x] = prm.meta[threadIdx.x];
  __syncthreads();

  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= prm.n_lanes) return;
  const size_t s = (size_t)prm.stride;
  float* st = prm.st + i;
  if (prm.blocked) prm.blocked[i] = 0.0f;
  if (!(st[kChAlive * s] > 0.5f)) {
    if constexpr (kStore) st[kChMiss * s] = 0.0f;
    return;
  }
  Path p;
  load_path(st, s, p);

  const size_t n = (size_t)prm.n_lanes;
  const float* res = prm.res + i;
  const int tile = i / kTile;
  const bool lists = prm.use_nee && prm.n_light_slots > 0 && !kVerdict &&
                     !prm.nodef;
  const float* mats = s_blob + kWfMatOff;
  const WavefrontGeometry geo{
      res[0], res[n], res[2 * n], res[3 * n], res[4 * n], prm.prims,
      lists ? prm.scand + (size_t)tile * (prm.n_blocks + 1) : prm.scand,
      lists ? prm.sctn + (size_t)tile * prm.n_blocks : prm.sctn, mats,
      s_mtypes, mats + kWfMatStride * prm.n_mats, prm.block,
      prm.blocked ? prm.blocked + i : nullptr,
      kVerdict ? res + 7 * n : nullptr, kVerdict ? nullptr : prm.nodef,
      prm.nodei, prm.n_nodes};
  const SceneView sc{s_blob, s_meta, s_lsb, 0, prm.n_light_slots, s_meta[2],
                     prm.sky_mode};
  const uint32_t pid = (uint32_t)prm.ids[i];
  const uint32_t sample = (uint32_t)prm.ids[s + i];
  const bool missed = wf_bounce(sc, geo, p, pid, sample, (uint32_t)s_meta[1],
                                prm.k, prm.rr_depth, prm.use_nee,
                                prm.use_mis);
  if constexpr (kStore) store_path(st, s, p, missed, prm.sky_mode);
}

// ---------------------------------------------------------------------------
// K8: any-hit.
// ---------------------------------------------------------------------------

struct AnyhitParams {
  float* blocked;       // (stride,)
  const float* sray;    // (8, stride): pox poy poz ldx ldy ldz tmax need
  const float* prims;   // (n_blocks, 5, block): this shard's leaf blocks
  const int* scand;     // (tiles, 1, n_blocks + 1): count, block ids
  const float* sctn;    // (tiles, 1, n_blocks): entry bounds, nondecreasing
  int stride, n_lanes, n_blocks, block;
};

__global__ void __launch_bounds__(kThreadsWf) anyhit_kernel(AnyhitParams prm) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= prm.stride) return;
  const size_t s = (size_t)prm.stride;
  const float* r = prm.sray + i;
  bool hit = false;
  if (i < prm.n_lanes && r[7 * s] > 0.5f) {
    const int tile = i / kTile;
    const WavefrontGeometry geo{
        0.0f, 0.0f, 0.0f, 0.0f, -1.0f, prm.prims,
        prm.scand + (size_t)tile * (prm.n_blocks + 1),
        prm.sctn + (size_t)tile * prm.n_blocks, nullptr, nullptr, nullptr,
        prm.block, nullptr, nullptr, nullptr, nullptr, 0};
    hit = geo.sweep(r[0], r[s], r[2 * s], r[3 * s], r[4 * s], r[5 * s],
                    r[6 * s]);
  }
  prm.blocked[i] = hit ? 1.0f : 0.0f;
}

// ---------------------------------------------------------------------------
// K7m's verdict pass.
// ---------------------------------------------------------------------------

struct MxuVerdictParams {
  float* verdict;       // (n_lanes,): residual row 7
  const float* sray;    // (8, n_lanes): pox poy poz ldx ldy ldz tmax need
  const float* cslot;   // (n_blocks, 2 block, 8): build_cmat's, slot-major
  const float* bctr;    // (n_blocks, 3)
  const int* scand;     // (rows, n_blocks + 1): count, block ids
  const float* sctn;    // (rows, n_blocks): entry bounds, nondecreasing
  int n_lanes, n_blocks, block;
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending));
}

// One block a 128-lane row: the row's lanes sweep its shadow list together,
// each candidate's table staged once in shared memory by cp.async for the
// row's four warps, the next candidate's copy in flight while the lanes
// test this one (two buffers).  Each lane: the candidates in order, a
// block's slots in order, stopping at its first blocker (verdict 1) or
// once the next candidate's bound reaches its tmax (the plain version's
// _sweep_anyhit with mxu=); the row stops when every lane has.
__global__ void __launch_bounds__(kRow) mxu_verdict_kernel(
    MxuVerdictParams prm) {
  extern __shared__ float4 s_tab[];                   // 2 x 4 block
  const int row = blockIdx.x;
  const int i = row * kRow + threadIdx.x;
  const size_t n = (size_t)prm.n_lanes;
  const float* r = prm.sray + i;
  const float tmax = r[6 * n];
  bool done = !(r[7 * n] > 0.5f), hit = false;
  ExpandedSlots<true> slots{nullptr,  prm.bctr, prm.block, r[0],    r[n],
                            r[2 * n], r[3 * n], r[4 * n],  r[5 * n]};
  const int* cl = prm.scand + (size_t)row * (prm.n_blocks + 1);
  const float* tl = prm.sctn + (size_t)row * prm.n_blocks;
  const int ncand = __ldg(cl);
  const int quads = 4 * prm.block;                    // a table's float4s
  auto stage = [&](int c) {
    const float4* src = reinterpret_cast<const float4*>(prm.cslot) +
                        (size_t)__ldg(cl + 1 + c) * quads;
    float4* dst = s_tab + (c & 1) * quads;
    for (int a = threadIdx.x; a < quads; a += blockDim.x)
      cp_async16(dst + a, src + a);
    cp_async_commit();
  };
  if (ncand > 0) stage(0);
  for (int c = 0; c < ncand; ++c) {
    if (!done && __ldg(tl + c) >= tmax) done = true;
    // Every lane is past candidate c - 1, so its buffer may be refilled.
    if (!__syncthreads_or(!done)) break;
    if (c + 1 < ncand) {
      stage(c + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();                                  // candidate c staged
    if (!done) {
      slots.begin_at(reinterpret_cast<const float*>(s_tab + (c & 1) * quads),
                     __ldg(cl + 1 + c));
      for (int j = 0; j < prm.block; ++j)
        if (slots.blocks(j, tmax)) {
          hit = done = true;
          break;
        }
    }
  }
  cp_async_wait<0>();
  prm.verdict[i] = hit ? 1.0f : 0.0f;
}

// ---------------------------------------------------------------------------
// K11 and K11g: the fused bounce.
// ---------------------------------------------------------------------------

// K11's geometry: the lane's nearest hit by K6's sweep of its tile's list
// (cl non-null: the precull), each candidate's box tested against the
// lane's ray first (boxes non-null), or by K3's walk of the tree, resolved
// as the JAX package's fused bounce resolves it: a padding winner
// (material id -1) has no material (kNoMaterial; K3 gives it K1's invalid
// row instead).
// Every shadow ray walks the tree (BvhWalk::any_hit) with the tmax
// trace_bounce gives it.  With kRecord (K11g) the walk writes the lane's
// residual: K6's winner record, the shadow verdict at rec[7].
template <bool kRecord>
struct FusedGeometry {
  static constexpr int kLightEmit = 4;
  static constexpr bool kNoMaterialHits = true;
  BvhWalk<kRecord> walk;
  const int* cl;        // the tile's list (count, block ids), or null
  const float* tl;      // its entry bounds
  const float* boxes;   // the leaf blocks' boxes, or null

  __device__ __forceinline__ bool nearest(float ox, float oy, float oz,
                                          float dx, float dy, float dz,
                                          float& t, Hit& h) const {
    bool found;
    if (cl) {
      CompactSlots slots{walk.prims, walk.block, ox, oy, oz, dx, dy, dz};
      t = kBig;
      int win_j = 0;
      const int win_blk = list_nearest(cl, tl, boxes, slots, t, win_j);
      found = win_blk >= 0;
      if (found)
        walk.winner(win_blk, win_j, h);
      else
        walk.no_winner();
    } else {
      found = walk.nearest(ox, oy, oz, dx, dy, dz, t, h);
    }
    if (found && h.id < 0) h.mtype = kNoMaterial;
    return found;
  }

  __device__ __forceinline__ bool occluded(float ox, float oy, float oz,
                                           float dx, float dy, float dz,
                                           float tmax) const {
    return walk.occluded(ox, oy, oz, dx, dy, dz, tmax);
  }

  __device__ __forceinline__ const float* light(int l) const {
    return walk.light(l);
  }
};

struct BounceParams {
  float* st;            // (17, stride), updated in place
  const int* ids;       // (2, stride)
  const float* blob;    // 21 + 8 * n_mats + 7 * max(n_light_slots, 1)
  const int* meta;      // start_sample, seed, n_lights
  const float* lsb;     // 6
  const float* nodef;   // 8 tables x n_nodes rows of 8
  const int* nodei;     // 8 tables x n_nodes rows of 8
  const float* prims;   // (n_blocks, 5, block)
  const int* mtypes;    // n_mats
  const int* cand;      // precull: (tiles, n_blocks + 1); else unread
  const float* ctn;     // precull: (tiles, n_blocks)
  const float* boxes;   // precull: (n_blocks, 8) leaf boxes, or null (the
                        // list sweep unculled)
  float* res;           // K11g: (8, n_lanes) residual; K11: null
  int stride, n_lanes, n_nodes, n_blocks, block, n_mats, n_light_slots, k;
  int rr_depth, sky_mode, blob_len;
  bool use_nee, use_mis, precull;
};

// K11 (kRecord false) and K11g (true): one bounce of every alive lane in
// one kernel, in place; a dead lane keeps its state and has its miss flag
// cleared (K11g: residual 0 0 0 0 -1 -1 -1 0, as K6 writes it).
template <bool kRecord>
__global__ void __launch_bounds__(kThreadsWf, kBounceMinBlocks)
    bounce_kernel(BounceParams prm) {
  extern __shared__ float smem[];
  float* s_blob = smem;
  float* s_invalid = s_blob + prm.blob_len;             // 8
  float* s_lsb = s_invalid + kWfMatStride;              // 6
  int* s_meta = reinterpret_cast<int*>(s_lsb + 6);      // 3
  int* s_mtypes = s_meta + 3;                           // n_mats
  for (int a = threadIdx.x; a < prm.blob_len; a += blockDim.x)
    s_blob[a] = prm.blob[a];
  for (int a = threadIdx.x; a < prm.n_mats; a += blockDim.x)
    s_mtypes[a] = prm.mtypes[a];
  if (threadIdx.x < kWfMatStride)
    s_invalid[threadIdx.x] = threadIdx.x == kWfMatStride - 1 ? 1.5f : 0.0f;
  if (threadIdx.x < 6) s_lsb[threadIdx.x] = prm.lsb[threadIdx.x];
  if (threadIdx.x < 3) s_meta[threadIdx.x] = prm.meta[threadIdx.x];
  __syncthreads();

  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= prm.n_lanes) return;
  const size_t s = (size_t)prm.stride;
  float* st = prm.st + i;
  float rec[8] = {0.0f, 0.0f, 0.0f, 0.0f, -1.0f, -1.0f, -1.0f, 0.0f};
  if (!(st[kChAlive * s] > 0.5f)) {
    st[kChMiss * s] = 0.0f;
  } else {
    Path p;
    load_path(st, s, p);
    const int tile = i / kTile;
    const float* mats = s_blob + kWfMatOff;
    const FusedGeometry<kRecord> geo{
        {prm.nodef, prm.nodei, prm.prims, mats, s_mtypes, s_invalid,
         mats + kWfMatStride * prm.n_mats, prm.n_nodes, prm.block, rec},
        prm.precull ? prm.cand + (size_t)tile * (prm.n_blocks + 1) : nullptr,
        prm.precull ? prm.ctn + (size_t)tile * prm.n_blocks : nullptr,
        prm.boxes};
    const SceneView sc{s_blob, s_meta, s_lsb, 0, prm.n_light_slots,
                       s_meta[2], prm.sky_mode};
    const bool missed = trace_bounce(sc, geo, p, (uint32_t)prm.ids[i],
                                     (uint32_t)prm.ids[s + i],
                                     (uint32_t)s_meta[1], prm.k,
                                     prm.rr_depth, prm.use_nee, prm.use_mis);
    store_path(st, s, p, missed, prm.sky_mode);
  }
  if constexpr (kRecord) {
    const size_t n = (size_t)prm.n_lanes;
    for (int c = 0; c < 8; ++c) prm.res[c * n + i] = rec[c];
  }
}

// ---------------------------------------------------------------------------
// K10: one bounce's adjoint.
// ---------------------------------------------------------------------------

struct BounceBwdParams {
  float* din;           // (17, stride): cotangent of the pre-bounce stream
  float* dprims;        // (n_blocks + 1, 5, block): winners' d(cx cy cz r)
  float* dscal;         // sky 6, materials 8 n_mats, lights 7 L; zeroed
  const float* st;      // (17, stride): the pre-bounce stream
  const int* ids;       // (2, stride)
  const float* res;     // (8, n_lanes): winner record, verdict in row 7
  const float* ct;      // (17, stride): cotangent of the post-bounce stream
  const float* blob;    // 21 + 8 * n_mats + 7 * max(n_light_slots, 1)
  const int* meta;      // start_sample, seed, n_lights
  const float* lsb;     // 6
  const int* mtypes;    // n_mats
  int stride, n_lanes, n_mats, n_light_slots, k, rr_depth, sky_mode;
  int n_blocks, block;
  int blob_len, n_scal, copies;
  bool use_nee, use_mis;
};

__global__ void __launch_bounds__(kThreadsWf, kBwdMinBlocks)
    bounce_bwd_kernel(BounceBwdParams prm) {
  extern __shared__ float smem[];
  float* s_blob = smem;
  float* s_invalid = s_blob + prm.blob_len;             // 8
  float* s_lsb = s_invalid + kWfMatStride;              // 6
  int* s_meta = reinterpret_cast<int*>(s_lsb + 6);      // 3
  int* s_mtypes = s_meta + 3;                           // n_mats
  // copies x n_scal: the warps' copies of the scalar gradient
  float* s_grad = reinterpret_cast<float*>(s_mtypes + prm.n_mats);
  for (int a = threadIdx.x; a < prm.blob_len; a += blockDim.x)
    s_blob[a] = prm.blob[a];
  for (int a = threadIdx.x; a < prm.n_mats; a += blockDim.x)
    s_mtypes[a] = prm.mtypes[a];
  for (int a = threadIdx.x; a < prm.copies * prm.n_scal; a += blockDim.x)
    s_grad[a] = 0.0f;
  if (threadIdx.x < kWfMatStride)
    s_invalid[threadIdx.x] = threadIdx.x == kWfMatStride - 1 ? 1.5f : 0.0f;
  if (threadIdx.x < 6) s_lsb[threadIdx.x] = prm.lsb[threadIdx.x];
  if (threadIdx.x < 3) s_meta[threadIdx.x] = prm.meta[threadIdx.x];
  __syncthreads();

  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const size_t s = (size_t)prm.stride;
  LaneSink sink{prm.n_mats};
  int key = -1;   // the winner's first entry in dprims; -1: none of its own
  if (i < prm.n_lanes) {
    const float* st = prm.st + i;
    const float* cti = prm.ct + i;
    float ct[13];
    for (int c = 0; c < 13; ++c) ct[c] = cti[c * s];
    if (st[kChAlive * s] > 0.5f) {
      Path p;
      load_path(st, s, p);
      const size_t n = (size_t)prm.n_lanes;
      const float* res = prm.res + i;
      const float* mats = s_blob + kWfMatOff;
      const RebuiltGeometry geo{res[0],     res[n],       res[2 * n],
                                res[3 * n], res[4 * n],   res[7 * n] > 0.5f,
                                mats,       s_mtypes,     s_invalid,
                                mats + kWfMatStride * prm.n_mats, prm.n_mats};
      const SceneView sc{s_blob, s_meta, s_lsb, 0, prm.n_light_slots,
                         s_meta[2], prm.sky_mode};
      bounce_vjp(sc, geo, sink, p, (uint32_t)prm.ids[i],
                 (uint32_t)prm.ids[s + i], (uint32_t)s_meta[1], prm.k,
                 prm.rr_depth, prm.use_nee, prm.use_mis, ct);
      // A winner of its own, its slot clamped into the table as
      // kernels/wavefront_grad.py::_grads_from_bwd clamps it.
      if (sink.geo)
        key = min(max((int)res[5 * n], 0), prm.n_blocks - 1) * kWfPrimAttrs *
                  prm.block +
              min(max((int)res[6 * n], 0), prm.block - 1);
    }
    float* din = prm.din + i;
    for (int c = 0; c < 13; ++c) din[c * s] = ct[c];
    din[kChAlive * s] = 0.0f;
    din[kChSpec * s] = 0.0f;
    din[kChInimg * s] = cti[kChInimg * s];
    din[kChMiss * s] = 0.0f;
  } else if (i < prm.stride) {
    for (int c = 0; c < kNCh; ++c) prm.din[c * s + i] = prm.ct[c * s + i];
  }
  flush_scalars(sink, s_grad + ((threadIdx.x >> 5) % prm.copies) *
                                   prm.n_scal);
  flush_geometry<true>(key, sink.dgeo, prm.dprims, prm.block);
  flush_block(s_grad, prm.copies, prm.n_scal, prm.dscal);
}

// K10's shared memory: the uniforms, then the scalar gradient's copies.
inline int bwd_fixed(int n_mats, int n_light_slots) {
  return kWfMatOff + kWfMatStride * n_mats +
         kWfLightStride * (n_light_slots > 1 ? n_light_slots : 1) +
         kWfMatStride + 6 + 3 + n_mats;
}

inline int bwd_n_scal(int n_mats, int n_light_slots) {
  return 6 + kWfMatStride * n_mats + kWfLightStride * n_light_slots;
}

inline size_t bwd_smem(int n_mats, int n_light_slots, int copies) {
  return sizeof(float) * (bwd_fixed(n_mats, n_light_slots) +
                          (size_t)copies * bwd_n_scal(n_mats, n_light_slots));
}

inline unsigned blocks_for(int n) {
  return (unsigned)((n + kThreadsWf - 1) / kThreadsWf);
}

}  // namespace spt

extern "C" int spt_wavefront_raygen(void* st, void* ids, const void* blob,
                                    const void* meta, int width, int height,
                                    int tiles_x, int tiles_per_img,
                                    int n_tiles, int n_lanes, int dof,
                                    float inv_w, float inv_h, float aspect,
                                    void* stream) {
  spt::RaygenParams prm;
  prm.st = static_cast<float*>(st);
  prm.ids = static_cast<int*>(ids);
  prm.blob = static_cast<const float*>(blob);
  prm.meta = static_cast<const int*>(meta);
  prm.width = width;
  prm.height = height;
  prm.tiles_x = tiles_x;
  prm.tiles_per_img = tiles_per_img;
  prm.n_tiles = n_tiles;
  prm.n_lanes = n_lanes;
  prm.dof = dof != 0;
  prm.inv_w = inv_w;
  prm.inv_h = inv_h;
  prm.aspect = aspect;
  if (n_lanes <= 0) return 0;
  spt::raygen_kernel<<<spt::blocks_for(n_lanes), spt::kThreadsWf, 0,
                       static_cast<cudaStream_t>(stream)>>>(prm);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int spt_wavefront_isect(void* res, const void* st,
                                   const void* prims, const void* cand,
                                   const void* ctn, const void* cmat,
                                   const void* bctr, const void* nodef,
                                   const void* nodei, int stride, int n_lanes,
                                   int n_blocks, int block, int n_nodes,
                                   void* stream) {
  spt::IsectParams prm;
  prm.res = static_cast<float*>(res);
  prm.st = static_cast<const float*>(st);
  prm.prims = static_cast<const float*>(prims);
  prm.cand = static_cast<const int*>(cand);
  prm.ctn = static_cast<const float*>(ctn);
  prm.cmat = static_cast<const float*>(cmat);
  prm.bctr = static_cast<const float*>(bctr);
  prm.nodef = static_cast<const float*>(nodef);
  prm.nodei = static_cast<const int*>(nodei);
  prm.stride = stride;
  prm.n_lanes = n_lanes;
  prm.n_blocks = n_blocks;
  prm.block = block;
  prm.n_nodes = n_nodes;
  if (n_lanes <= 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (cmat)
    spt::isect_kernel<true><<<spt::blocks_for(n_lanes), spt::kThreadsWf, 0,
                              s>>>(prm);
  else
    spt::isect_kernel<false><<<spt::blocks_for(n_lanes), spt::kThreadsWf, 0,
                               s>>>(prm);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int spt_wavefront_shade(
    void* st, const void* ids, const void* res, const void* blob,
    const void* meta, const void* lsb, const void* prims, const void* mtypes,
    const void* scand, const void* sctn, void* blocked, const void* nodef,
    const void* nodei, int stride, int n_lanes, int n_blocks, int block,
    int n_mats, int n_light_slots, int k, int rr_depth, int use_nee,
    int use_mis, int sky_mode, int blocked_in_res, int n_nodes,
    int store_path, void* stream) {
  spt::ShadeParams prm;
  prm.st = static_cast<float*>(st);
  prm.ids = static_cast<const int*>(ids);
  prm.res = static_cast<const float*>(res);
  prm.blob = static_cast<const float*>(blob);
  prm.meta = static_cast<const int*>(meta);
  prm.lsb = static_cast<const float*>(lsb);
  prm.prims = static_cast<const float*>(prims);
  prm.mtypes = static_cast<const int*>(mtypes);
  prm.scand = static_cast<const int*>(scand);
  prm.sctn = static_cast<const float*>(sctn);
  prm.blocked = static_cast<float*>(blocked);
  prm.nodef = static_cast<const float*>(nodef);
  prm.nodei = static_cast<const int*>(nodei);
  prm.n_nodes = n_nodes;
  prm.stride = stride;
  prm.n_lanes = n_lanes;
  prm.n_blocks = n_blocks;
  prm.block = block;
  prm.n_mats = n_mats;
  prm.n_light_slots = n_light_slots;
  prm.k = k;
  prm.rr_depth = rr_depth;
  prm.sky_mode = sky_mode;
  prm.use_nee = use_nee != 0;
  prm.use_mis = use_mis != 0;
  prm.blob_len = spt::kWfMatOff + spt::kWfMatStride * n_mats +
                 spt::kWfLightStride * (n_light_slots > 1 ? n_light_slots : 1);
  if (n_lanes <= 0) return 0;
  const size_t smem = sizeof(float) * (prm.blob_len + 6 + 3 + n_mats);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned grid = spt::blocks_for(n_lanes);
  if (blocked_in_res)
    spt::shade_kernel<true><<<grid, spt::kThreadsWf, smem, s>>>(prm);
  else if (!store_path)
    spt::shade_kernel<false, false><<<grid, spt::kThreadsWf, smem, s>>>(prm);
  else
    spt::shade_kernel<false><<<grid, spt::kThreadsWf, smem, s>>>(prm);
  return static_cast<int>(cudaGetLastError());
}

// K7m's verdict pass: verdict (n_lanes,) float32, 1 where the lane's shadow
// ray (sray, the glue's) is blocked; n_lanes a multiple of kRow.
extern "C" int spt_wavefront_mxu_verdicts(void* verdict, const void* sray,
                                          const void* cslot, const void* bctr,
                                          const void* scand, const void* sctn,
                                          int n_lanes, int n_blocks, int block,
                                          void* stream) {
  spt::MxuVerdictParams prm;
  prm.verdict = static_cast<float*>(verdict);
  prm.sray = static_cast<const float*>(sray);
  prm.cslot = static_cast<const float*>(cslot);
  prm.bctr = static_cast<const float*>(bctr);
  prm.scand = static_cast<const int*>(scand);
  prm.sctn = static_cast<const float*>(sctn);
  prm.n_lanes = n_lanes;
  prm.n_blocks = n_blocks;
  prm.block = block;
  if (n_lanes <= 0) return 0;
  if (n_lanes % spt::kRow) return static_cast<int>(cudaErrorInvalidValue);
  spt::mxu_verdict_kernel<<<n_lanes / spt::kRow, spt::kRow,
                            2 * 16 * block * sizeof(float),
                            static_cast<cudaStream_t>(stream)>>>(prm);
  return static_cast<int>(cudaGetLastError());
}

// Blocks of kRow threads an SM holds of K7m's verdict pass, for leaf
// blocks of `block` slots (two staged tables), by the occupancy
// calculator.
extern "C" int spt_wavefront_mxu_verdicts_blocks_per_sm(int block) {
  int blocks = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &blocks, spt::mxu_verdict_kernel, spt::kRow,
          2 * 16 * block * sizeof(float)) != cudaSuccess)
    return -1;
  return blocks;
}

extern "C" int spt_wavefront_bounce(
    void* st, const void* ids, const void* blob, const void* meta,
    const void* lsb, const void* nodef, const void* nodei, const void* prims,
    const void* mtypes, const void* cand, const void* ctn,
    const void* boxes, void* res,
    int stride, int n_lanes, int n_nodes, int n_blocks, int block,
    int n_mats, int n_light_slots, int k, int rr_depth, int use_nee,
    int use_mis, int sky_mode, int precull, void* stream) {
  spt::BounceParams prm;
  prm.st = static_cast<float*>(st);
  prm.ids = static_cast<const int*>(ids);
  prm.blob = static_cast<const float*>(blob);
  prm.meta = static_cast<const int*>(meta);
  prm.lsb = static_cast<const float*>(lsb);
  prm.nodef = static_cast<const float*>(nodef);
  prm.nodei = static_cast<const int*>(nodei);
  prm.prims = static_cast<const float*>(prims);
  prm.mtypes = static_cast<const int*>(mtypes);
  prm.cand = static_cast<const int*>(cand);
  prm.ctn = static_cast<const float*>(ctn);
  prm.boxes = static_cast<const float*>(boxes);
  prm.res = static_cast<float*>(res);
  prm.stride = stride;
  prm.n_lanes = n_lanes;
  prm.n_nodes = n_nodes;
  prm.n_blocks = n_blocks;
  prm.block = block;
  prm.n_mats = n_mats;
  prm.n_light_slots = n_light_slots;
  prm.k = k;
  prm.rr_depth = rr_depth;
  prm.sky_mode = sky_mode;
  prm.use_nee = use_nee != 0;
  prm.use_mis = use_mis != 0;
  prm.precull = precull != 0;
  prm.blob_len = spt::kWfMatOff + spt::kWfMatStride * n_mats +
                 spt::kWfLightStride * (n_light_slots > 1 ? n_light_slots : 1);
  if (n_lanes <= 0) return 0;
  const size_t smem = sizeof(float) * (prm.blob_len + spt::kWfMatStride + 6 +
                                       3 + n_mats);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (res)
    spt::bounce_kernel<true><<<spt::blocks_for(n_lanes), spt::kThreadsWf,
                               smem, s>>>(prm);
  else
    spt::bounce_kernel<false><<<spt::blocks_for(n_lanes), spt::kThreadsWf,
                                smem, s>>>(prm);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int spt_wavefront_anyhit(void* blocked, const void* sray,
                                    const void* prims, const void* scand,
                                    const void* sctn, int stride, int n_lanes,
                                    int n_blocks, int block, void* stream) {
  spt::AnyhitParams prm;
  prm.blocked = static_cast<float*>(blocked);
  prm.sray = static_cast<const float*>(sray);
  prm.prims = static_cast<const float*>(prims);
  prm.scand = static_cast<const int*>(scand);
  prm.sctn = static_cast<const float*>(sctn);
  prm.stride = stride;
  prm.n_lanes = n_lanes;
  prm.n_blocks = n_blocks;
  prm.block = block;
  if (stride <= 0) return 0;
  spt::anyhit_kernel<<<spt::blocks_for(stride), spt::kThreadsWf, 0,
                       static_cast<cudaStream_t>(stream)>>>(prm);
  return static_cast<int>(cudaGetLastError());
}

// dprims: (n_blocks + 1) x 5 x block floats, zeroed: each alive lane's
// winner's d(cx cy cz r) is added at its (block, slot) (the last block
// row, a discard row of _grads_from_bwd's, is never reached).
extern "C" int spt_wavefront_bounce_bwd(
    void* din, void* dprims, void* dscal, const void* st, const void* ids,
    const void* res, const void* ct, const void* blob, const void* meta,
    const void* lsb, const void* mtypes, int stride, int n_lanes, int n_mats,
    int n_light_slots, int k, int rr_depth, int use_nee, int use_mis,
    int sky_mode, int n_blocks, int block, void* stream) {
  spt::BounceBwdParams prm;
  prm.din = static_cast<float*>(din);
  prm.dprims = static_cast<float*>(dprims);
  prm.dscal = static_cast<float*>(dscal);
  prm.st = static_cast<const float*>(st);
  prm.ids = static_cast<const int*>(ids);
  prm.res = static_cast<const float*>(res);
  prm.ct = static_cast<const float*>(ct);
  prm.blob = static_cast<const float*>(blob);
  prm.meta = static_cast<const int*>(meta);
  prm.lsb = static_cast<const float*>(lsb);
  prm.mtypes = static_cast<const int*>(mtypes);
  prm.stride = stride;
  prm.n_lanes = n_lanes;
  prm.n_mats = n_mats;
  prm.n_light_slots = n_light_slots;
  prm.k = k;
  prm.rr_depth = rr_depth;
  prm.sky_mode = sky_mode;
  prm.n_blocks = n_blocks;
  prm.block = block;
  prm.use_nee = use_nee != 0;
  prm.use_mis = use_mis != 0;
  prm.blob_len = spt::kWfMatOff + spt::kWfMatStride * n_mats +
                 spt::kWfLightStride * (n_light_slots > 1 ? n_light_slots : 1);
  prm.n_scal = spt::bwd_n_scal(n_mats, n_light_slots);
  if (stride <= 0) return 0;
  prm.copies = spt::scalar_copies(spt::bwd_fixed(n_mats, n_light_slots),
                                  prm.n_scal, spt::kThreadsWf);
  const size_t smem = spt::bwd_smem(n_mats, n_light_slots, prm.copies);
  spt::bounce_bwd_kernel<<<spt::blocks_for(stride), spt::kThreadsWf, smem,
                           static_cast<cudaStream_t>(stream)>>>(prm);
  return static_cast<int>(cudaGetLastError());
}

// K10's blocks an SM for the scene's shared memory (the occupancy
// calculator).
extern "C" int spt_wavefront_bounce_bwd_blocks_per_sm(int n_mats,
                                                      int n_light_slots) {
  using namespace spt;
  const int copies = scalar_copies(bwd_fixed(n_mats, n_light_slots),
                                   bwd_n_scal(n_mats, n_light_slots),
                                   kThreadsWf);
  int blocks = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &blocks, bounce_bwd_kernel, kThreadsWf,
          bwd_smem(n_mats, n_light_slots, copies)) != cudaSuccess)
    return -1;
  return blocks;
}

// Blocks of kThreadsWf threads an SM holds of kernel `which` (0: K6, 1: K7
// and K9, 2: K11, 3: K8l, 4: K10, 5: K8, 6: K7b and K7m's bounce, 7:
// K11g) with `smem` bytes of dynamic shared memory, by the occupancy
// calculator; tools/wf_ablate.py and chip_smoke.py report it.
extern "C" int spt_wavefront_blocks_per_sm(int which, int smem) {
  using namespace spt;
  const void* fn = nullptr;
  switch (which) {
    case 0: fn = reinterpret_cast<const void*>(isect_kernel<false>); break;
    case 1: fn = reinterpret_cast<const void*>(shade_kernel<false>); break;
    case 2: fn = reinterpret_cast<const void*>(bounce_kernel<false>); break;
    case 3: fn = reinterpret_cast<const void*>(anyhit_kernel); break;
    case 4: fn = reinterpret_cast<const void*>(bounce_bwd_kernel); break;
    case 5:
      fn = reinterpret_cast<const void*>(shade_kernel<false, false>);
      break;
    case 6: fn = reinterpret_cast<const void*>(shade_kernel<true>); break;
    case 7: fn = reinterpret_cast<const void*>(bounce_kernel<true>); break;
    default: return -1;
  }
  int blocks = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn, kThreadsWf,
                                                    smem) != cudaSuccess)
    return -1;
  return blocks;
}
