// K4: the fused forward+backward BVH megakernel, 129-2048 prims.
//
// Replaces spt_tpu/kernels/megakernel_bvh_grad.py::_kernel_bvh_grad (the
// Pallas TPU kernel launched by _launch_bvh_grad).  Computes what it
// computes: for every pixel, spp samples rendered exactly as K3 renders
// them (the radiance sum), and the gradient of sum(ct * image) with
// respect to the scalar uniforms (grad_s: sky, material rows, light slots)
// and to every leaf slot's centre and radius (grad_g, (n_blocks, 8, block),
// rows cx cy cz r).  The forward sweep is K3's per-thread walk and K3's
// __noinline__ bounce (bvh.cuh), recording for each bounce the entry state
// (13 floats, 2 flags), the winner (cx cy cz r, material id, leaf block,
// slot) and the NEE shadow verdict.  The backward sweep never walks: it
// replays each bounce in reverse through bounce_vjp (physics_adj.cuh) on
// the winner rebuilt from its record (RebuiltGeometry: the TPU kernel's
// _rebuilt_intersect under jax.vjp) and the recorded verdict.
//
// What bounds it on an H100: fp32 issue, divergence and register pressure,
// as for K2 and K3: it reads the tree, the leaf blocks and the cotangent
// image once and writes the image and the two gradients, while each path
// segment costs K3's walk, the bounce again and its adjoint.
//
// What this simple design does about it: one thread per pixel in K3's layout
// (a warp on 8x4 pixels), so the image keeps K3's summation order and bits. A
// path's records (up to 16 bounces of 13 floats, 2 flags and 8 record floats)
// live in per-thread arrays in local memory. The scalar gradient is summed
// per block in shared memory with shared atomics and added to the global
// vector once a block, as K2 does. Each lane's winner cotangent goes by a
// global atomicAdd straight to its recorded (block, slot) of grad_g: the TPU
// kernel scans every leaf block for presence each bounce, which a GPU does
// not need. A padding slot that wins takes K1's invalid row, as in K3, and is
// recorded as material n_mats: it gets no gradient. Float atomics order the
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
constexpr int kTileW4 = 16, kTileH4 = 8;  // a block's pixels, as K3's
constexpr int kMaxDepth4 = 16;            // kernels/megakernel_grad.py::MAX_DEPTH
constexpr int kRec = 8;                   // hcx hcy hcz hr hmid hblk hslot blocked
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
  int blob_len, n_scal;
};

// One pixel: spp samples, each a forward sweep that records its bounces,
// then the reverse replay into the block's scalar gradient and grad_g.
__device__ __forceinline__ void bvh_grad_pixel(
    const K4Params& prm, const SceneView& sc, const BvhWalk<true>& walk,
    const float* invalid, float* grad, int x, int y) {
  const uint32_t start = (uint32_t)sc.meta[0];
  const uint32_t seed = (uint32_t)sc.meta[1];
  const int pix = y * prm.width + x;
  const uint32_t pid = (uint32_t)pix;
  const size_t n_ct = (size_t)prm.tiles_x * ((prm.height + kCtTile - 1) /
                                             kCtTile) * kCtTile * kCtTile;
  const size_t lane = ((size_t)(y / kCtTile) * prm.tiles_x + x / kCtTile) *
                          (kCtTile * kCtTile) +
                      (y % kCtTile) * kCtTile + x % kCtTile;
  const float ct_r = prm.ct[lane], ct_g = prm.ct[n_ct + lane],
              ct_b = prm.ct[2 * n_ct + lane];
  const float* mats = sc.blob + kMatOff;
  const float* lights = mats + kMatStride * prm.n_mats;
  float acc_r = 0.0f, acc_g = 0.0f, acc_b = 0.0f;
  Path kept[kMaxDepth4];
  float rec[kMaxDepth4][kRec];
  for (int smp = 0; smp < prm.spp; ++smp) {
    const uint32_t sample = start + (uint32_t)smp;
    Path p;
    raygen(sc.blob, prm.inv_w, prm.inv_h, prm.aspect, prm.dof, pid, (float)x,
           (float)y, sample, seed, p);
    int n_run = 0;
    for (int k = 0; k < prm.max_bounces && p.active; ++k) {
      kept[k] = p;
      rec[k][7] = 0.0f;
      BvhWalk<true> w = walk;
      w.rec = rec[k];
      bvh_bounce(sc, w, p, pid, sample, seed, k, prm.rr_depth, prm.use_nee,
                 prm.use_mis);
      n_run = k + 1;
    }
    acc_r += p.rad_r;
    acc_g += p.rad_g;
    acc_b += p.rad_b;
    // Bounces a path did not run are the identity: replay only the others.
    float ct[13] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f,
                    0.0f, 0.0f, ct_r, ct_g, ct_b, 0.0f};
    for (int k = n_run - 1; k >= 0; --k) {
      const float* r = rec[k];
      // A padding winner (a slot with id -1 in a real block) is material
      // n_mats: K1's invalid row, and no gradient.
      const float hmid =
          (r[4] < 0.0f && r[5] >= 0.0f) ? (float)prm.n_mats : r[4];
      const RebuiltGeometry geo{r[0], r[1],  r[2],    r[3],    hmid,
                                r[7] > 0.5f, mats, walk.mtypes, invalid,
                                lights, prm.n_mats};
      ScalarSink sink{grad, prm.n_mats, {0.0f, 0.0f, 0.0f, 0.0f}};
      bounce_vjp(sc, geo, sink, kept[k], pid, sample, seed, k, prm.rr_depth,
                 prm.use_nee, prm.use_mis, ct);
      if (hmid >= 0.0f && hmid < (float)prm.n_mats) {
        float* g = prm.grad_g + (size_t)r[5] * 8 * prm.block + (int)r[6];
        for (int a = 0; a < 4; ++a)
          if (sink.dgeo[a] != 0.0f) atomicAdd(g + a * prm.block, sink.dgeo[a]);
      }
    }
  }
  prm.img[3 * pix + 0] = acc_r;
  prm.img[3 * pix + 1] = acc_g;
  prm.img[3 * pix + 2] = acc_b;
}

__global__ void __launch_bounds__(kThreadsK4)
    megakernel_bvh_grad_kernel(K4Params prm) {
  extern __shared__ float smem[];
  float* s_blob = smem;
  float* s_invalid = s_blob + prm.blob_len;         // kMatStride
  float* s_lsb = s_invalid + kMatStride;            // 6
  int* s_meta = reinterpret_cast<int*>(s_lsb + 6);  // 3
  int* s_mtypes = s_meta + 3;                       // n_mats
  float* s_grad = reinterpret_cast<float*>(s_mtypes + prm.n_mats);  // n_scal
  for (int i = threadIdx.x; i < prm.blob_len; i += blockDim.x)
    s_blob[i] = prm.blob[i];
  for (int i = threadIdx.x; i < prm.n_mats; i += blockDim.x)
    s_mtypes[i] = prm.mtypes[i];
  for (int i = threadIdx.x; i < prm.n_scal; i += blockDim.x) s_grad[i] = 0.0f;
  if (threadIdx.x < kMatStride)
    s_invalid[threadIdx.x] = threadIdx.x == kMatStride - 1 ? 1.5f : 0.0f;
  if (threadIdx.x < 6) s_lsb[threadIdx.x] = prm.lsb[threadIdx.x];
  if (threadIdx.x < 3) s_meta[threadIdx.x] = prm.meta[threadIdx.x];
  __syncthreads();

  // A warp covers 8x4 pixels of the block's 16x8, as in K3.
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int x = blockIdx.x * kTileW4 + (warp & 1) * 8 + (lane & 7);
  const int y = blockIdx.y * kTileH4 + (warp >> 1) * 4 + (lane >> 3);
  if (x < prm.width && y < prm.height) {
    const SceneView sc{s_blob, s_meta, s_lsb, 0, prm.n_light_slots,
                       s_meta[2], prm.sky_mode};
    const float* mats = s_blob + kMatOff;
    const BvhWalk<true> walk{prm.nodef, prm.nodei, prm.prims, mats,
                             s_mtypes, s_invalid,
                             mats + kMatStride * prm.n_mats, prm.n_nodes,
                             prm.block, nullptr};
    bvh_grad_pixel(prm, sc, walk, s_invalid, s_grad, x, y);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < prm.n_scal; i += blockDim.x)
    if (s_grad[i] != 0.0f) atomicAdd(prm.grad_s + i, s_grad[i]);
}

}  // namespace spt

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
  prm.blob_len = spt::kMatOff + spt::kMatStride * n_mats +
                 spt::kLightStride * (n_light_slots > 1 ? n_light_slots : 1);
  prm.n_scal = 6 + spt::kMatStride * n_mats + spt::kLightStride * n_light_slots;
  if (width <= 0 || height <= 0) return 0;
  const size_t smem = sizeof(float) * (prm.blob_len + spt::kMatStride + 6 +
                                       3 + n_mats + prm.n_scal);
  const dim3 grid((width + spt::kTileW4 - 1) / spt::kTileW4,
                  (height + spt::kTileH4 - 1) / spt::kTileH4);
  spt::megakernel_bvh_grad_kernel<<<grid, spt::kThreadsK4, smem,
                                    static_cast<cudaStream_t>(stream)>>>(prm);
  return static_cast<int>(cudaGetLastError());
}
