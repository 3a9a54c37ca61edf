// K1: the forward megakernel for scenes of at most 128 spheres.
//
// Replaces spt_tpu/kernels/megakernel.py::_kernel (the Pallas TPU kernel
// launched by _launch).  Computes what it computes: for every pixel, spp
// samples of jittered pinhole or thin-lens raygen followed by max_bounces
// bounces of trace_bounce (csrc/physics.cuh), summed in order s = 0..spp-1.
//
// What bounds it on an H100: fp32 ALU issue and warp divergence, not bytes.
// It reads a few KB of scene uniforms and writes 12 bytes per pixel, while
// each path segment costs a test against every sphere plus shading and a
// shadow ray, and the threads of a warp leave their paths at different
// bounces and take different material branches.
//
// What this simple design does about it: one thread per pixel in blocks of
// 128, each thread looping over its samples and summing them in a register
// (the TPU's sequential spp grid axis turned into a loop, so nothing crosses
// blocks and no atomics are needed).  The scene uniforms (blob, meta, light
// grid bounds) are copied to shared memory at block start; the threads of a
// warp read the same sphere at the same time, which is a broadcast.  A path
// that ends leaves the bounce loop, and a hit evaluates only its own
// material's branch.  Coherence work (ray sorting, persistent threads) is
// left for later.
//
// Built with nvcc for sm_90a without --use_fast_math and with
// --fmad=false (see kernels/_build.py); entries return cudaGetLastError().

#include <cuda_runtime.h>

#include <cstdint>

#include "physics.cuh"
#include "rng.cuh"

namespace spt {

constexpr int kThreads = 128;
constexpr uint32_t kCamSlot = 0xFFFFu * kNDims;

struct K1Params {
  float* out;           // (H, W, 3) radiance sum
  const float* blob;    // 21 + 12 * n_prims
  const int* meta;      // 3 + n_prims + max(n_light_slots, 1)
  const float* lsb;     // 6
  int width, height, spp, n_prims, n_light_slots, max_bounces, rr_depth;
  int sky_mode;
  bool use_nee, use_mis, dof;
  float inv_w, inv_h, aspect;  // f32(1/width), f32(1/height), f32(W/H)
  int blob_len, meta_len;
};

// Jittered pinhole (or thin-lens) primary ray, as the TPU kernel makes it.
__device__ __forceinline__ void raygen(const K1Params& prm, const float* cam,
                                       uint32_t pid, float px, float py,
                                       uint32_t sample, uint32_t seed,
                                       Path& p) {
  float jx = counter_uniform(pid, sample, kCamSlot + 0u, seed);
  float jy = counter_uniform(pid, sample, kCamSlot + 1u, seed);
  float tanf = cam[12];
  float sx = (px + jx) * prm.inv_w;
  float sy = (py + jy) * prm.inv_h;
  float ndc_x = (2.0f * sx - 1.0f) * prm.aspect * tanf;
  float ndc_y = (1.0f - 2.0f * sy) * tanf;
  float dx = ndc_x * cam[3] + ndc_y * cam[6] + cam[9];
  float dy = ndc_x * cam[4] + ndc_y * cam[7] + cam[10];
  float dz = ndc_x * cam[5] + ndc_y * cam[8] + cam[11];
  normalize3(dx, dy, dz);
  float ox = cam[0], oy = cam[1], oz = cam[2];
  if (prm.dof) {
    float lu = counter_uniform(pid, sample, kCamSlot + 2u, seed);
    float lv = counter_uniform(pid, sample, kCamSlot + 3u, seed);
    float r = cam[13] * sqrtf(lu);
    float phi = kTwoPi * lv;
    float cphi = cosf(phi), sphi = sinf(phi);
    float offx = r * (cphi * cam[3] + sphi * cam[6]);
    float offy = r * (cphi * cam[4] + sphi * cam[7]);
    float offz = r * (cphi * cam[5] + sphi * cam[8]);
    float denom = fmaxf(dx * cam[9] + dy * cam[10] + dz * cam[11], 1e-6f);
    float tf = cam[14] / denom;
    float fx = ox + dx * tf, fy = oy + dy * tf, fz = oz + dz * tf;
    ox = ox + offx;
    oy = oy + offy;
    oz = oz + offz;
    dx = fx - ox;
    dy = fy - oy;
    dz = fz - oz;
    normalize3(dx, dy, dz);
  }
  p.ox = ox; p.oy = oy; p.oz = oz;
  p.dx = dx; p.dy = dy; p.dz = dz;
  p.th_r = p.th_g = p.th_b = 1.0f;
  p.rad_r = p.rad_g = p.rad_b = 0.0f;
  p.prev_pdf = 0.0f;
  p.active = true;
  p.prev_spec = true;  // the camera vertex counts as specular
}

__global__ void __launch_bounds__(kThreads) megakernel_fwd_kernel(K1Params prm) {
  extern __shared__ float smem[];
  float* s_blob = smem;
  float* s_lsb = smem + prm.blob_len;
  int* s_meta = reinterpret_cast<int*>(s_lsb + 6);
  for (int i = threadIdx.x; i < prm.blob_len; i += blockDim.x) s_blob[i] = prm.blob[i];
  for (int i = threadIdx.x; i < prm.meta_len; i += blockDim.x) s_meta[i] = prm.meta[i];
  if (threadIdx.x < 6) s_lsb[threadIdx.x] = prm.lsb[threadIdx.x];
  __syncthreads();

  const int n_pix = prm.width * prm.height;
  const int pix = blockIdx.x * blockDim.x + threadIdx.x;
  if (pix >= n_pix) return;
  const SceneView sc{s_blob, s_meta, s_lsb, prm.n_prims, prm.n_light_slots,
                     s_meta[2], prm.sky_mode};
  const uint32_t start = (uint32_t)s_meta[0];
  const uint32_t seed = (uint32_t)s_meta[1];
  const uint32_t pid = (uint32_t)pix;
  const float px = (float)(pix % prm.width);
  const float py = (float)(pix / prm.width);

  float acc_r = 0.0f, acc_g = 0.0f, acc_b = 0.0f;
  for (int s = 0; s < prm.spp; ++s) {
    const uint32_t sample = start + (uint32_t)s;
    Path p;
    raygen(prm, s_blob, pid, px, py, sample, seed, p);
    for (int k = 0; k < prm.max_bounces && p.active; ++k)
      trace_bounce(sc, p, pid, sample, seed, k, prm.rr_depth, prm.use_nee,
                   prm.use_mis);
    acc_r += p.rad_r;
    acc_g += p.rad_g;
    acc_b += p.rad_b;
  }
  prm.out[3 * pix + 0] = acc_r;
  prm.out[3 * pix + 1] = acc_g;
  prm.out[3 * pix + 2] = acc_b;
}

__global__ void counter_bits_kernel(uint32_t* out, const uint32_t* pixel,
                                    const uint32_t* sample, const uint32_t* dim,
                                    const uint32_t* seed, int n) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) out[i] = counter_bits(pixel[i], sample[i], dim[i], seed[i]);
}

}  // namespace spt

extern "C" int spt_megakernel_fwd(void* out, const void* blob, const void* meta,
                                  const void* lsb, int width, int height,
                                  int spp, int n_prims, int n_light_slots,
                                  int max_bounces, int rr_depth, int use_nee,
                                  int use_mis, int sky_mode, int dof,
                                  float inv_w, float inv_h, float aspect,
                                  void* stream) {
  spt::K1Params prm;
  prm.out = static_cast<float*>(out);
  prm.blob = static_cast<const float*>(blob);
  prm.meta = static_cast<const int*>(meta);
  prm.lsb = static_cast<const float*>(lsb);
  prm.width = width;
  prm.height = height;
  prm.spp = spp;
  prm.n_prims = n_prims;
  prm.n_light_slots = n_light_slots;
  prm.max_bounces = max_bounces;
  prm.rr_depth = rr_depth;
  prm.sky_mode = sky_mode;
  prm.use_nee = use_nee != 0;
  prm.use_mis = use_mis != 0;
  prm.dof = dof != 0;
  prm.inv_w = inv_w;
  prm.inv_h = inv_h;
  prm.aspect = aspect;
  prm.blob_len = spt::kSphOff + spt::kSphStride * n_prims;
  prm.meta_len = spt::kMetaFixed + n_prims + (n_light_slots > 1 ? n_light_slots : 1);
  const int n_pix = width * height;
  if (n_pix <= 0) return 0;
  const size_t smem = sizeof(float) * (prm.blob_len + 6 + prm.meta_len);
  const int blocks = (n_pix + spt::kThreads - 1) / spt::kThreads;
  spt::megakernel_fwd_kernel<<<blocks, spt::kThreads, smem,
                               static_cast<cudaStream_t>(stream)>>>(prm);
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
