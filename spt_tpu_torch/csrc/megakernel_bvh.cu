// K3: the forward megakernel for scenes of more than 128 spheres.
//
// Replaces spt_tpu/kernels/megakernel_bvh.py::_kernel_bvh (the Pallas TPU
// kernel launched by _launch_bvh).  Computes what it computes: for every
// pixel, spp samples of K1's raygen followed by max_bounces bounces of
// trace_bounce (csrc/physics.cuh), summed in order s = 0..spp-1, with the
// nearest hit and the shadow test taken by walking a skip-link BVH instead
// of testing every sphere.
//
// The TPU kernel walks a whole 1024-ray packet behind one scalar node
// pointer, with a scalar frustum filter at bounce 0, because the TPU has no
// per-lane gathers.  Here each thread walks for its own ray: its own node
// pointer, stackless, over the node table of its direction's octant (near
// child first), slab-testing each box against its own nearest distance so
// far, testing a hit leaf's `block` slots in order with a strict '<' and
// going on to the node's skip link.  A shadow ray walks the same way and
// stops at its first blocker.  The winner's centre and radius come from
// its slot and the rest from the material table by its id, so a hit
// carries the same floats as K1's.
//
// What bounds it on an H100: fp32 issue and divergence, as in K1, plus the
// node and leaf reads.  Inputs are read once, but each path segment reads
// some tens of 48-byte node rows and 640-byte leaf blocks; node tables and
// blocks (1 MB at config 5) stay in global memory, read through the
// read-only path, and live in the 50 MB L2.  Camera, sky, material table,
// light slots and material types are in shared memory.
//
// Built one thread a pixel, a warp also waited at every sample for its
// longest path, while the lanes whose paths had ended idled (PERF.md).
//
// What this design does about it: persistent threads that regenerate paths
// (csrc/regen.cuh): as many blocks as the SMs hold take 8x4-pixel batches
// from a counter, a warp a batch, so a warp's primary rays walk alike; a
// lane whose path ends starts its pixel's next sample, or its warp's next
// pixel, in the same iteration.  The bounce is inlined: called
// (__noinline__, as the old loop did), this loop hung at config 5
// when ptxas optimized it, and the old loop with the call parted from the
// plain version on 998 pixels at config 5, 4 spp, where this one equals it
// on every pixel (PERF.md).  The image is written unswizzled
// (H, W, 3).  Packet culling and ray sorting are left for later.  On an
// H100 (700 W) the lanes do a bounce in 97% of the lane slots (one thread a
// pixel: 48%), and config 5 (1080p x 4 spp) takes 64.1-65.4 ms where one
// thread a pixel took 75.9-76.2.  What is left is the walks: how far the
// lanes of a warp, now at different bounces, part in them, and their node
// reads, not yet measured apart (PERF.md).
//
// Built with nvcc for sm_90a without --use_fast_math and with
// --fmad=false (see kernels/_build.py); entries return cudaGetLastError().

#include <cuda_runtime.h>

#include <cstdint>

#include "bvh.cuh"
#include "camera.cuh"
#include "physics.cuh"
#include "regen.cuh"
#include "rng.cuh"

namespace spt {

constexpr int kThreadsBvh = 128;
// Blocks an SM K3 is built for (__launch_bounds__): 1, the compiler's own
// count (96 registers, 5 blocks).  Every other bound, 2-6 blocks of 128 and
// 2-3 of 256, was 8-20% slower at config 5, even at the same 96 registers
// (tools/k1_ablate.py, PERF.md).
constexpr int kMinBlocksBvh = 1;

struct K3Params {
  RegenArgs run;
  const float* blob;     // 21 + 8 * n_mats + 7 * max(n_light_slots, 1)
  const int* meta;       // start_sample, seed, n_lights
  const float* lsb;      // 6
  const float* nodef;    // 8 * n_nodes * 8
  const int* nodei;      // 8 * n_nodes * 8
  const float* prims;    // n_blocks * 5 * block
  const int* mtypes;     // n_mats
  int n_nodes, block, n_mats, n_light_slots;
  int rr_depth, sky_mode;
  bool use_nee, use_mis;
  int blob_len;
};

template <bool kCount>
__global__ void __launch_bounds__(kThreadsBvh, kMinBlocksBvh)
    megakernel_bvh_kernel(K3Params prm) {
  if (prm.run.spp <= 0) {
    zero_image(prm.run);
    return;
  }
  extern __shared__ float smem[];
  float* s_blob = smem;
  float* s_invalid = s_blob + prm.blob_len;      // kMatStride
  float* s_lsb = s_invalid + kMatStride;         // 6
  int* s_meta = reinterpret_cast<int*>(s_lsb + 6);  // 3
  int* s_mtypes = s_meta + 3;                    // n_mats
  for (int i = threadIdx.x; i < prm.blob_len; i += blockDim.x)
    s_blob[i] = prm.blob[i];
  for (int i = threadIdx.x; i < prm.n_mats; i += blockDim.x)
    s_mtypes[i] = prm.mtypes[i];
  if (threadIdx.x < kMatStride)
    s_invalid[threadIdx.x] = threadIdx.x == kMatStride - 1 ? 1.5f : 0.0f;
  if (threadIdx.x < 6) s_lsb[threadIdx.x] = prm.lsb[threadIdx.x];
  if (threadIdx.x < 3) s_meta[threadIdx.x] = prm.meta[threadIdx.x];
  __syncthreads();

  const SceneView sc{s_blob, s_meta, s_lsb, 0, prm.n_light_slots, s_meta[2],
                     prm.sky_mode};
  const float* mats = s_blob + kMatOff;
  const BvhGeometry geo{prm.nodef, prm.nodei, prm.prims, mats, s_mtypes,
                        s_invalid, mats + kMatStride * prm.n_mats,
                        prm.n_nodes, prm.block};
  const uint32_t seed = (uint32_t)s_meta[1];
  const int rr_depth = prm.rr_depth;
  const bool use_nee = prm.use_nee, use_mis = prm.use_mis;
  regen_paths<kCount>(
      prm.run, s_blob, (uint32_t)s_meta[0], seed,
      [&](Path& p, uint32_t pid, uint32_t sample, int k) {
        trace_bounce(sc, geo, p, pid, sample, seed, k, rr_depth, use_nee,
                     use_mis);
      });
}

inline size_t k3_smem(int n_mats, int n_light_slots) {
  const int blob_len = kMatOff + kMatStride * n_mats +
                       kLightStride * (n_light_slots > 1 ? n_light_slots : 1);
  return sizeof(float) * (blob_len + kMatStride + 6 + 3 + n_mats);
}

}  // namespace spt

// K3's blocks an SM at its launch bound, for the scene's shared memory.
extern "C" int spt_megakernel_bvh_fwd_blocks_per_sm(int n_mats,
                                                    int n_light_slots) {
  int blocks = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &blocks, spt::megakernel_bvh_kernel<false>, spt::kThreadsBvh,
          spt::k3_smem(n_mats, n_light_slots)) != cudaSuccess)
    return -1;
  return blocks;
}

extern "C" int spt_megakernel_bvh_fwd_threads() { return spt::kThreadsBvh; }

// next: one uint32 of scratch (zeroed here, on the stream); counts: null,
// or two uint64 that the counting instantiation adds its lanes to;
// row_offset: the first row of the band that out holds (inv_h and aspect
// are the full image's); max_blocks: the grid the card holds, SMs x
// blocks an SM (the caller asks spt_megakernel_bvh_fwd_blocks_per_sm
// once).
extern "C" int spt_megakernel_bvh_fwd(
    void* out, const void* blob, const void* meta, const void* lsb,
    const void* nodef, const void* nodei, const void* prims,
    const void* mtypes, void* next, void* counts, int width, int height,
    int spp, int n_nodes, int block, int n_mats, int n_light_slots,
    int max_bounces, int rr_depth, int use_nee, int use_mis, int sky_mode,
    int dof, int row_offset, int max_blocks, float inv_w, float inv_h,
    float aspect, void* stream) {
  spt::K3Params prm;
  prm.run.out = static_cast<float*>(out);
  prm.run.next = static_cast<unsigned*>(next);
  prm.run.counts = static_cast<unsigned long long*>(counts);
  prm.run.width = width;
  prm.run.height = height;
  prm.run.spp = spp;
  prm.run.max_bounces = max_bounces;
  prm.run.dof = dof != 0;
  prm.run.row_offset = row_offset;
  prm.run.inv_w = inv_w;
  prm.run.inv_h = inv_h;
  prm.run.aspect = aspect;
  prm.blob = static_cast<const float*>(blob);
  prm.meta = static_cast<const int*>(meta);
  prm.lsb = static_cast<const float*>(lsb);
  prm.nodef = static_cast<const float*>(nodef);
  prm.nodei = static_cast<const int*>(nodei);
  prm.prims = static_cast<const float*>(prims);
  prm.mtypes = static_cast<const int*>(mtypes);
  prm.n_nodes = n_nodes;
  prm.block = block;
  prm.n_mats = n_mats;
  prm.n_light_slots = n_light_slots;
  prm.rr_depth = rr_depth;
  prm.sky_mode = sky_mode;
  prm.use_nee = use_nee != 0;
  prm.use_mis = use_mis != 0;
  prm.blob_len = spt::kMatOff + spt::kMatStride * n_mats +
                 spt::kLightStride * (n_light_slots > 1 ? n_light_slots : 1);
  if (width <= 0 || height <= 0) return 0;
  const auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(next, 0, sizeof(unsigned), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = spt::k3_smem(n_mats, n_light_slots);
  const int grid =
      spt::regen_grid(max_blocks, spt::kThreadsBvh, width, height);
  if (counts != nullptr)
    spt::megakernel_bvh_kernel<true>
        <<<grid, spt::kThreadsBvh, smem, s>>>(prm);
  else
    spt::megakernel_bvh_kernel<false>
        <<<grid, spt::kThreadsBvh, smem, s>>>(prm);
  return static_cast<int>(cudaGetLastError());
}
