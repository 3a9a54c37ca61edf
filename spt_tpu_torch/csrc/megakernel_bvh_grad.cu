// K4: the fused forward+backward BVH megakernel, 129-2048 prims.
//
// Replaces spt_tpu/kernels/megakernel_bvh_grad.py::_kernel_bvh_grad (the
// Pallas TPU kernel launched by _launch_bvh_grad).  Computes what it
// computes: for every pixel, spp samples rendered exactly as K3 renders
// them (the radiance sum), and the gradient of sum(ct * image) with
// respect to the scalar uniforms (grad_s: sky, material rows, light slots)
// and to every leaf slot's centre and radius (grad_g, (n_blocks, 8, block),
// rows cx cy cz r).  The forward sweep is K3's per-thread walk and K3's
// bounce, recording for each bounce its entry state, the winner's leaf
// slot and the NEE shadow verdict.  The backward sweep never walks: it
// replays each bounce in reverse through bounce_vjp (physics_adj.cuh) on
// the winner rebuilt from its slot (RebuiltGeometry: the TPU kernel's
// _rebuilt_intersect under jax.vjp) and the recorded verdict.
//
// What bounds it on an H100: fp32 issue, divergence and register pressure,
// as for K2 and K3: it reads the tree, the leaf blocks and the cotangent
// image once and writes the image and the two gradients, while each path
// segment costs K3's walk, the bounce again and its adjoint.
//
// The first design called a __noinline__ bounce, replayed each lane's
// path on its own, summed the scalar gradient with a shared atomic per
// lane and value into one vector a block, kept 32 bytes of winner record
// a bounce in local memory, and ran at the compiler's 168 registers, 3
// blocks an SM.
//
// What this design does about it: one thread per pixel in K3's old layout
// (blocks of 16x8 pixels, a warp on 8x4), its samples in order, so the
// image keeps K3's summation order and bits.  The bounce is inlined, as in
// K3 (trace_bounce on the walk), where the called one parted K3 from its
// plain version (PERF.md).  A bounce's record is its entry state, the
// winner's leaf slot and the verdict (Kept4); the replay reads the
// winner's centre, radius and material from the leaf table.  The replay
// runs in step across the warp, bounce by bounce from the warp's longest
// path down, and each lane keeps its share of a bounce's theta cotangent
// in registers (LaneSink); after each bounce the warp sums the shares of
// the lanes that meet on one sky, material or light row (flush_scalars:
// __match_any_sync and a log-step shuffle sum), and one lane adds each sum
// into the warp's copy of the scalar vector in shared memory; the copies
// are summed and added into grad_s once a block.  Each lane adds its
// winner's centre and radius cotangent into grad_g by a global atomic.
// Built for 5 blocks an SM.  On an H100 (700 W) the gradient path's
// launch (2,000 spheres, 1080p x 4 spp) takes 17.9-18.2 ms where the
// first design took 35.8-36.2, the regenerating loop of K3 (csrc/regen.cuh
// with a replay phase) 26.5: a warp that mixes forward and replayed
// bounces runs both (PERF.md).  A padding slot that wins takes K1's
// invalid row, as in K3, and gets no gradient.  Float atomics order the
// gradients' sums differently from run to run; the image is exact.
//
// Built with nvcc for sm_90a with --fmad=false and without fast math
// (kernels/_build.py); entries return cudaGetLastError().

#include <cuda_runtime.h>

#include <cstdint>

#include "bvh.cuh"
#include "camera.cuh"
#include "physics.cuh"
#include "physics_adj.cuh"
#include "rng.cuh"

namespace spt {

constexpr int kThreadsK4 = 128;
// Blocks an SM K4 is built for (__launch_bounds__): 5, 96 registers with
// some 600 B of spills, where the compiler alone takes 178 registers and
// 2 blocks; on an H100 30% faster at the gradient path's launch, the same
// image (tools/k2_ablate.py --k4; PERF.md).
constexpr int kMinBlocksK4 = 5;
constexpr int kTileW4 = 16, kTileH4 = 8;  // a block's pixels, as K3's were
constexpr int kMaxDepth4 = 16;            // kernels/megakernel_grad.py::MAX_DEPTH
constexpr int kCtTile = 32;               // the cotangent's 32x32 pixel tiles

struct K4Params {
  float* img;            // (H, W, 3) radiance sum
  float* grad_s;         // 6 + 8 n_mats + 7 n_light_slots, zeroed
  float* grad_g;         // (n_blocks, 8, block), zeroed
  const float* blob;     // 21 + 8 * n_mats + 7 * max(n_light_slots, 1)
  const int* meta;       // start_sample, seed, n_lights
  const float* lsb;      // 6
  const float* nodef;    // 8 * n_nodes * 8
  const int* nodei;      // 8 * n_nodes * 8
  const float* prims;    // n_blocks * 5 * block
  const int* mtypes;     // n_mats
  const float* ct;       // (3, tiles * 1024): swizzle_ct's layout
  int width, height, spp, n_nodes, block, n_mats, n_light_slots;
  int max_bounces, rr_depth, sky_mode, tiles_x;
  bool use_nee, use_mis, dof;
  float inv_w, inv_h, aspect;
  int blob_len, n_scal, copies;
};

// K4's forward geometry: K3's walk, remembering the winner's leaf slot
// (block * block size + slot; -1: a miss) and the NEE shadow verdict.
struct RecordingWalk : BvhGeometry {
  mutable int slot = -1;
  mutable bool blocked = false;

  __device__ __forceinline__ bool nearest(float ox, float oy, float oz,
                                          float dx, float dy, float dz,
                                          float& t, Hit& h) const {
    int j = 0;
    const int blk = nearest_slot(ox, oy, oz, dx, dy, dz, t, j);
    if (blk < 0) return false;
    winner(blk, j, h);
    slot = blk * block + j;
    return true;
  }

  __device__ __forceinline__ bool occluded(float ox, float oy, float oz,
                                           float dx, float dy, float dz,
                                           float tmax) const {
    blocked = any_hit(ox, oy, oz, dx, dy, dz, tmax);
    return blocked;
  }
};

// A bounce as the forward sweep keeps it for the replay.
struct Kept4 {
  Path p;        // the entry state
  int slot;      // RecordingWalk's
  bool blocked;
};

// The replay's geometry: the winner read back from its leaf slot.  A
// padding slot (material id -1) is material n_mats: K1's invalid row.
__device__ __forceinline__ RebuiltGeometry replay_geometry(
    const K4Params& prm, const BvhGeometry& walk, const Kept4& e) {
  float c[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  float hmid = -1.0f;
  if (e.slot >= 0) {
    const float* pb = prm.prims +
                      (size_t)(e.slot / prm.block) * kPrimAttrs * prm.block +
                      e.slot % prm.block;
    for (int a = 0; a < 4; ++a) c[a] = __ldg(pb + a * prm.block);
    const float mid = __ldg(pb + 4 * prm.block);
    hmid = mid < 0.0f ? (float)prm.n_mats : mid;
  }
  return RebuiltGeometry{c[0], c[1], c[2], c[3], hmid, e.blocked,
                         walk.mats, walk.mtypes, walk.invalid, walk.lights,
                         prm.n_mats};
}

// One pixel (x, y), or a lane past the image's edge that only keeps its
// warp's collectives company: spp samples, each a forward sweep that keeps
// its bounces, then the replay in step across the warp into the warp's
// copy of the scalar gradient (grad) and into grad_g.
__device__ __forceinline__ void bvh_grad_pixel(const K4Params& prm,
                                               const SceneView& sc,
                                               const BvhGeometry& walk,
                                               float* grad, int x, int y) {
  const bool in_image = x < prm.width && y < prm.height;
  const uint32_t start = (uint32_t)sc.meta[0];
  const uint32_t seed = (uint32_t)sc.meta[1];
  const int pix = y * prm.width + x;
  const uint32_t pid = (uint32_t)pix;
  float ct_r = 0.0f, ct_g = 0.0f, ct_b = 0.0f;
  if (in_image) {
    const size_t n_ct = (size_t)prm.tiles_x * ((prm.height + kCtTile - 1) /
                                               kCtTile) * kCtTile * kCtTile;
    const size_t lane = ((size_t)(y / kCtTile) * prm.tiles_x + x / kCtTile) *
                            (kCtTile * kCtTile) +
                        (y % kCtTile) * kCtTile + x % kCtTile;
    ct_r = prm.ct[lane];
    ct_g = prm.ct[n_ct + lane];
    ct_b = prm.ct[2 * n_ct + lane];
  }
  float acc_r = 0.0f, acc_g = 0.0f, acc_b = 0.0f;
  Kept4 kept[kMaxDepth4];
  for (int smp = 0; smp < prm.spp; ++smp) {
    const uint32_t sample = start + (uint32_t)smp;
    int n_run = 0;
    if (in_image) {
      Path p;
      raygen(sc.blob, prm.inv_w, prm.inv_h, prm.aspect, prm.dof, pid,
             (float)x, (float)y, sample, seed, p);
      for (int k = 0; k < prm.max_bounces && p.active; ++k) {
        kept[k].p = p;
        const RecordingWalk w{walk};
        trace_bounce(sc, w, p, pid, sample, seed, k, prm.rr_depth,
                     prm.use_nee, prm.use_mis);
        kept[k].slot = w.slot;
        kept[k].blocked = w.blocked;
        n_run = k + 1;
      }
      acc_r += p.rad_r;
      acc_g += p.rad_g;
      acc_b += p.rad_b;
    }
    // Bounces a path did not run are the identity: a lane replays only
    // its own, the warp from its longest path's last bounce down.
    float ct[13] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f,
                    0.0f, 0.0f, ct_r, ct_g, ct_b, 0.0f};
    for (int k = __reduce_max_sync(kWarpMask, n_run) - 1; k >= 0; --k) {
      LaneSink sink{prm.n_mats};
      int key = -1;
      if (k < n_run) {
        const Kept4& e = kept[k];
        bounce_vjp(sc, replay_geometry(prm, walk, e), sink, e.p, pid,
                   sample, seed, k, prm.rr_depth, prm.use_nee, prm.use_mis,
                   ct);
        if (sink.geo)
          key = (e.slot / prm.block) * 8 * prm.block + e.slot % prm.block;
      }
      flush_scalars(sink, grad);
      // Lanes of one winner are not summed first: on an H100 that made K4
      // 1-2% slower at 2 and at 5 blocks an SM (K10 sums them; PERF.md).
      flush_geometry<false>(key, sink.dgeo, prm.grad_g, prm.block);
    }
  }
  if (in_image) {
    prm.img[3 * pix + 0] = acc_r;
    prm.img[3 * pix + 1] = acc_g;
    prm.img[3 * pix + 2] = acc_b;
  }
}

__global__ void __launch_bounds__(kThreadsK4, kMinBlocksK4)
    megakernel_bvh_grad_kernel(K4Params prm) {
  extern __shared__ float smem[];
  float* s_blob = smem;
  float* s_invalid = s_blob + prm.blob_len;         // kMatStride
  float* s_lsb = s_invalid + kMatStride;            // 6
  int* s_meta = reinterpret_cast<int*>(s_lsb + 6);  // 3
  int* s_mtypes = s_meta + 3;                       // n_mats
  // copies x n_scal: the warps' copies of the scalar gradient
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

  // A warp covers 8x4 pixels of the block's 16x8.
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int x = blockIdx.x * kTileW4 + (warp & 1) * 8 + (lane & 7);
  const int y = blockIdx.y * kTileH4 + (warp >> 1) * 4 + (lane >> 3);
  const SceneView sc{s_blob, s_meta, s_lsb, 0, prm.n_light_slots,
                     s_meta[2], prm.sky_mode};
  const float* mats = s_blob + kMatOff;
  const BvhGeometry walk{prm.nodef, prm.nodei, prm.prims, mats, s_mtypes,
                         s_invalid, mats + kMatStride * prm.n_mats,
                         prm.n_nodes, prm.block, nullptr};
  bvh_grad_pixel(prm, sc, walk, s_grad + (warp % prm.copies) * prm.n_scal,
                 x, y);
  flush_block(s_grad, prm.copies, prm.n_scal, prm.grad_s);
}

inline int k4_blob_len(int n_mats, int n_light_slots) {
  return kMatOff + kMatStride * n_mats +
         kLightStride * (n_light_slots > 1 ? n_light_slots : 1);
}

inline int k4_n_scal(int n_mats, int n_light_slots) {
  return 6 + kMatStride * n_mats + kLightStride * n_light_slots;
}

// Shared memory before the scalar gradient's copies, in floats.
inline int k4_fixed(int n_mats, int n_light_slots) {
  return k4_blob_len(n_mats, n_light_slots) + kMatStride + 6 + 3 + n_mats;
}

inline int k4_copies(int n_mats, int n_light_slots) {
  return scalar_copies(k4_fixed(n_mats, n_light_slots),
                       k4_n_scal(n_mats, n_light_slots), kThreadsK4);
}

inline size_t k4_smem(int n_mats, int n_light_slots) {
  return sizeof(float) *
         (k4_fixed(n_mats, n_light_slots) +
          (size_t)k4_copies(n_mats, n_light_slots) *
              k4_n_scal(n_mats, n_light_slots));
}

}  // namespace spt

// K4's blocks an SM for the scene's shared memory (the occupancy
// calculator).
extern "C" int spt_megakernel_bvh_grad_blocks_per_sm(int n_mats,
                                                     int n_light_slots) {
  int blocks = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &blocks, spt::megakernel_bvh_grad_kernel, spt::kThreadsK4,
          spt::k4_smem(n_mats, n_light_slots)) != cudaSuccess)
    return -1;
  return blocks;
}

extern "C" int spt_megakernel_bvh_grad(
    void* img, void* grad_s, void* grad_g, const void* blob, const void* meta,
    const void* lsb, const void* nodef, const void* nodei, const void* prims,
    const void* mtypes, const void* ct, int width, int height, int spp,
    int n_nodes, int block, int n_mats, int n_light_slots, int max_bounces,
    int rr_depth, int use_nee, int use_mis, int sky_mode, int dof,
    float inv_w, float inv_h, float aspect, void* stream) {
  if (max_bounces > spt::kMaxDepth4)
    return static_cast<int>(cudaErrorInvalidValue);
  spt::K4Params prm;
  prm.img = static_cast<float*>(img);
  prm.grad_s = static_cast<float*>(grad_s);
  prm.grad_g = static_cast<float*>(grad_g);
  prm.blob = static_cast<const float*>(blob);
  prm.meta = static_cast<const int*>(meta);
  prm.lsb = static_cast<const float*>(lsb);
  prm.nodef = static_cast<const float*>(nodef);
  prm.nodei = static_cast<const int*>(nodei);
  prm.prims = static_cast<const float*>(prims);
  prm.mtypes = static_cast<const int*>(mtypes);
  prm.ct = static_cast<const float*>(ct);
  prm.width = width;
  prm.height = height;
  prm.spp = spp;
  prm.n_nodes = n_nodes;
  prm.block = block;
  prm.n_mats = n_mats;
  prm.n_light_slots = n_light_slots;
  prm.max_bounces = max_bounces;
  prm.rr_depth = rr_depth;
  prm.sky_mode = sky_mode;
  prm.tiles_x = (width + spt::kCtTile - 1) / spt::kCtTile;
  prm.use_nee = use_nee != 0;
  prm.use_mis = use_mis != 0;
  prm.dof = dof != 0;
  prm.inv_w = inv_w;
  prm.inv_h = inv_h;
  prm.aspect = aspect;
  prm.blob_len = spt::k4_blob_len(n_mats, n_light_slots);
  prm.n_scal = spt::k4_n_scal(n_mats, n_light_slots);
  prm.copies = spt::k4_copies(n_mats, n_light_slots);
  if (width <= 0 || height <= 0) return 0;
  const size_t smem = spt::k4_smem(n_mats, n_light_slots);
  const dim3 grid((width + spt::kTileW4 - 1) / spt::kTileW4,
                  (height + spt::kTileH4 - 1) / spt::kTileH4);
  spt::megakernel_bvh_grad_kernel<<<grid, spt::kThreadsK4, smem,
                                    static_cast<cudaStream_t>(stream)>>>(prm);
  return static_cast<int>(cudaGetLastError());
}
