// K1: the forward megakernel for scenes of at most 128 spheres.
//
// Replaces spt_tpu/kernels/megakernel.py::_kernel (the Pallas TPU kernel
// launched by _launch).  Computes what it computes: for every pixel, spp
// samples of jittered pinhole or thin-lens raygen followed by max_bounces
// bounces of trace_bounce (csrc/physics.cuh), summed in order s = 0..spp-1.
//
// What bounds it on an H100: fp32 issue and warp divergence, not bytes.
// It reads a few KB of scene uniforms and writes 12 bytes per pixel, while
// each path segment costs a test against every sphere plus shading and a
// shadow ray.  Built one thread a pixel, a warp waited at every sample for
// its longest path: in the Cornell box Russian roulette from bounce 3 makes
// most paths 4 to 8 bounces long, and the lanes whose paths had ended
// idled.  The lanes did a
// bounce in 58% of a warp's lane slots at the headline launch (Cornell
// 512x512 x 256 spp; tools/k1_ablate.py, from the plain version's path
// lengths).
//
// What this design does about it: persistent threads that regenerate paths
// (csrc/regen.cuh).  As many blocks as the SMs hold take 8x4-pixel batches
// from a counter; a lane whose path ends starts its pixel's next sample, or
// its warp's next pixel, in the same iteration, so the lanes stay busy until
// the image runs out.  The scene uniforms (blob, meta, light grid bounds)
// are copied to shared memory once a block; the threads of a warp read the
// same sphere at the same time, which is a broadcast.  A hit evaluates only
// its own material's branch.  A shadow test that stops at its first
// blocker gained nothing and is not taken.  On an H100 (700 W) the lanes
// now do a bounce in 98% of the lane slots, and the headline launch takes
// 29.3 ms where one thread a pixel took 44.3-44.7, the same bits
// (PERF.md).
//
// Built with nvcc for sm_90a without --use_fast_math and with
// --fmad=false (see kernels/_build.py); entries return cudaGetLastError().

#include <cuda_runtime.h>

#include <cstdint>

#include "camera.cuh"
#include "physics.cuh"
#include "regen.cuh"
#include "rng.cuh"

namespace spt {

constexpr int kThreads = 128;
// Blocks an SM K1 is built for (__launch_bounds__): 80 registers with 40 B
// of spills, where the compiler alone takes 104 and 4 blocks; on an H100
// 10% faster at the headline launch (29.2 against 32.6 ms; (256, 3) the
// same, 4 or 5 blocks 7-11% slower; tools/k1_ablate.py, PERF.md).
constexpr int kMinBlocks = 6;

struct K1Params {
  RegenArgs run;
  const float* blob;    // 21 + 12 * n_prims
  const int* meta;      // 3 + n_prims + max(n_light_slots, 1)
  const float* lsb;     // 6
  int n_prims, n_light_slots, rr_depth;
  int sky_mode;
  bool use_nee, use_mis;
  int blob_len, meta_len;
};

template <bool kCount>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    megakernel_fwd_kernel(K1Params prm) {
  if (prm.run.spp <= 0) {
    zero_image(prm.run);
    return;
  }
  extern __shared__ float smem[];
  float* s_blob = smem;
  float* s_lsb = smem + prm.blob_len;
  int* s_meta = reinterpret_cast<int*>(s_lsb + 6);
  for (int i = threadIdx.x; i < prm.blob_len; i += blockDim.x) s_blob[i] = prm.blob[i];
  for (int i = threadIdx.x; i < prm.meta_len; i += blockDim.x) s_meta[i] = prm.meta[i];
  if (threadIdx.x < 6) s_lsb[threadIdx.x] = prm.lsb[threadIdx.x];
  __syncthreads();

  const SceneView sc{s_blob, s_meta, s_lsb, prm.n_prims, prm.n_light_slots,
                     s_meta[2], prm.sky_mode};
  const uint32_t seed = (uint32_t)s_meta[1];
  const int rr_depth = prm.rr_depth;
  const bool use_nee = prm.use_nee, use_mis = prm.use_mis;
  regen_paths<kCount>(
      prm.run, s_blob, (uint32_t)s_meta[0], seed,
      [&](Path& p, uint32_t pid, uint32_t sample, int k) {
        trace_bounce(sc, p, pid, sample, seed, k, rr_depth, use_nee,
                     use_mis);
      });
}

__global__ void counter_bits_kernel(uint32_t* out, const uint32_t* pixel,
                                    const uint32_t* sample, const uint32_t* dim,
                                    const uint32_t* seed, int n) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) out[i] = counter_bits(pixel[i], sample[i], dim[i], seed[i]);
}

inline size_t k1_smem(int n_prims, int n_light_slots) {
  const int blob_len = kSphOff + kSphStride * n_prims;
  const int meta_len =
      kMetaFixed + n_prims + (n_light_slots > 1 ? n_light_slots : 1);
  return sizeof(float) * (blob_len + 6 + meta_len);
}

}  // namespace spt

// K1's blocks an SM at its launch bound, for the scene's shared memory.
extern "C" int spt_megakernel_fwd_blocks_per_sm(int n_prims,
                                                int n_light_slots) {
  int blocks = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &blocks, spt::megakernel_fwd_kernel<false>, spt::kThreads,
          spt::k1_smem(n_prims, n_light_slots)) != cudaSuccess)
    return -1;
  return blocks;
}

extern "C" int spt_megakernel_fwd_threads() { return spt::kThreads; }

// next: one uint32 of scratch (zeroed here, on the stream); counts: null,
// or two uint64 that the counting instantiation adds its lanes to;
// row_offset: the first row of the band that out holds (inv_h and aspect
// are the full image's); max_blocks: the grid the card holds, SMs x
// blocks an SM (the caller asks spt_megakernel_fwd_blocks_per_sm once).
extern "C" int spt_megakernel_fwd(void* out, const void* blob, const void* meta,
                                  const void* lsb, void* next, void* counts,
                                  int width, int height, int spp, int n_prims,
                                  int n_light_slots, int max_bounces,
                                  int rr_depth, int use_nee, int use_mis,
                                  int sky_mode, int dof, int row_offset,
                                  int max_blocks,
                                  float inv_w, float inv_h, float aspect,
                                  void* stream) {
  spt::K1Params prm;
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
  prm.n_prims = n_prims;
  prm.n_light_slots = n_light_slots;
  prm.rr_depth = rr_depth;
  prm.sky_mode = sky_mode;
  prm.use_nee = use_nee != 0;
  prm.use_mis = use_mis != 0;
  prm.blob_len = spt::kSphOff + spt::kSphStride * n_prims;
  prm.meta_len = spt::kMetaFixed + n_prims + (n_light_slots > 1 ? n_light_slots : 1);
  if (width <= 0 || height <= 0) return 0;
  const auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(next, 0, sizeof(unsigned), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = spt::k1_smem(n_prims, n_light_slots);
  const int grid = spt::regen_grid(max_blocks, spt::kThreads, width, height);
  if (counts != nullptr)
    spt::megakernel_fwd_kernel<true><<<grid, spt::kThreads, smem, s>>>(prm);
  else
    spt::megakernel_fwd_kernel<false><<<grid, spt::kThreads, smem, s>>>(prm);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int spt_counter_bits(void* out, const void* pixel, const void* sample,
                                const void* dim, const void* seed, int n,
                                void* stream) {
  if (n <= 0) return 0;
  const int threads = 256;
  spt::counter_bits_kernel<<<(n + threads - 1) / threads, threads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint32_t*>(out), static_cast<const uint32_t*>(pixel),
      static_cast<const uint32_t*>(sample), static_cast<const uint32_t*>(dim),
      static_cast<const uint32_t*>(seed), n);
  return static_cast<int>(cudaGetLastError());
}
