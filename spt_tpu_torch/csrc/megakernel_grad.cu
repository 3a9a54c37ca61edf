// K2: the fused forward+backward megakernel for scenes of at most 128 spheres.
//
// Replaces spt_tpu/kernels/megakernel_grad.py::_kernel_grad (the Pallas TPU
// kernel launched by _launch_grad).  Computes what it computes: for every
// pixel, spp samples rendered exactly as K1 renders them (the radiance sum),
// and gvec, the gradient of sum(ct * image) with respect to every sphere's
// 12 attributes and the 6 sky floats.  Per sample the forward sweep keeps
// each bounce's entry state; the backward sweep replays the bounces in
// reverse through bounce_vjp (physics_adj.cuh), the hand-written adjoint of
// trace_bounce, recomputing each bounce's forward and its uniforms (counter
// RNG) from the kept state.
//
// What bounds it on an H100: fp32 ALU issue, warp divergence and register
// pressure, not bytes.  It reads a few KB of uniforms and the cotangent
// image and writes the image and 12 P + 6 floats, while each path segment
// costs K1's work, then the replay: the bounce again and an adjoint of
// several hundred operations, in the material branch each lane takes.
//
// What the design does about it: one thread per pixel in blocks of 128
// loops over its samples as K1 does, so the image keeps K1's summation
// order and bits.  The forward sweep keeps, per bounce, the entry state (13
// floats) and one word holding the entry's prev_spec flag, the sphere it
// hit and the NEE shadow verdict (RecordingList), in a per-thread array of
// kMaxDepth in local memory; the replay rebuilds the hit from that sphere's
// row alone and takes the recorded verdict (RecordedSphere), so it sweeps no
// sphere list.  Scene uniforms are copied to shared memory.  The gradient
// is summed per block in shared memory, in a copy of the vector of 12 P + 6
// floats for each thread where the scene is small enough (for fewer, larger
// ones, one per few lanes), so lanes that meet on one sphere row, as every
// lit lane of a warp meets on the lamp's, do not serialise on its
// addresses; the copies are summed and added into the zeroed global vector
// with one atomicAdd per entry per block.  The adjoint takes next-event
// estimation before the sample's recompute (physics_adj.cuh), which keeps
// its register peak down, and __launch_bounds__ caps registers at 128 so
// that four blocks share an SM.  Float atomics make the gradient's
// summation order vary from run to run; the image is exact.
//
// Built with nvcc for sm_90a with --fmad=false and without fast math, as K1
// (kernels/_build.py); entries return cudaGetLastError().

#include <cuda_runtime.h>

#include <cstdint>

#include "camera.cuh"
#include "physics.cuh"
#include "physics_adj.cuh"
#include "rng.cuh"

namespace spt {

constexpr int kThreadsGrad = 128;
constexpr int kMaxDepth = 16;  // kernels/megakernel_grad.py::MAX_DEPTH

struct K2Params {
  float* img;           // (H, W, 3) radiance sum
  float* gvec;          // 12 * n_prims + 6, zeroed by the caller
  const float* blob;    // 21 + 12 * n_prims
  const int* meta;      // 3 + n_prims + max(n_light_slots, 1)
  const float* lsb;     // 6
  const float* ct;      // (H, W, 3) cotangent of the image
  int width, height, spp, n_prims, n_light_slots, max_bounces, rr_depth;
  int sky_mode;
  bool use_nee, use_mis, dof;
  float inv_w, inv_h, aspect;
  int blob_len, meta_len, grad_len, copies;
};

// The block keeps its gradient vector (grad_len floats) in `copies`
// copies, a power of two up to kThreadsGrad: thread t adds into copy
// t % copies.  The host takes the most copies for which the block's shared
// memory still lets kBlocksGrad blocks share an SM.  Where every thread has
// a copy (Cornell's 8 spheres: 128 copies of 102 floats) it adds with
// plain loads and stores; where the scene is larger, threads t, t + copies,
// ... share one with shared atomics (8 copies at 128 spheres: 4 lanes of a
// warp a copy).  A copy takes gstride = grad_len | 1 floats, so that one
// entry of the copies falls in distinct banks.
constexpr int kBlocksGrad = 4;
constexpr size_t kSmemGrad = 227 * 1024 / kBlocksGrad - 1024;

__host__ inline int copies_for(int blob_len, int meta_len, int grad_len) {
  const size_t fixed = sizeof(float) * (blob_len + 6 + meta_len);
  int c = kThreadsGrad;
  while (c > 1 && fixed + sizeof(float) * c * (grad_len | 1) > kSmemGrad)
    c >>= 1;
  return c;
}

// Shared memory: blob, lsb (6), meta, then the gradient's copies.
struct Smem {
  float* blob;
  float* lsb;
  int* meta;
  float* grad;
};

__host__ inline size_t smem_bytes(int blob_len, int meta_len, int grad_len,
                                  int copies) {
  return sizeof(float) * (blob_len + 6 + meta_len + copies * (grad_len | 1));
}

__device__ __forceinline__ Smem load_smem(float* smem, const float* blob,
                                          const int* meta, const float* lsb,
                                          int blob_len, int meta_len,
                                          int grad_len, int copies) {
  Smem s;
  s.blob = smem;
  s.lsb = smem + blob_len;
  s.meta = reinterpret_cast<int*>(s.lsb + 6);
  s.grad = reinterpret_cast<float*>(s.meta + meta_len);
  for (int i = threadIdx.x; i < blob_len; i += blockDim.x) s.blob[i] = blob[i];
  for (int i = threadIdx.x; i < meta_len; i += blockDim.x) s.meta[i] = meta[i];
  for (int i = threadIdx.x; i < copies * (grad_len | 1); i += blockDim.x)
    s.grad[i] = 0.0f;
  if (threadIdx.x < 6) s.lsb[threadIdx.x] = lsb[threadIdx.x];
  __syncthreads();
  return s;
}

// This thread's sink: its copy of the gradient.
__device__ __forceinline__ SphereSink block_sink(const Smem& s,
                                                 const SceneView& sc,
                                                 int grad_len, int copies) {
  return SphereSink{
      s.grad + (threadIdx.x & (copies - 1)) * (grad_len | 1),
      copies == kThreadsGrad, sc};
}

// The copies summed into gvec: one atomicAdd per nonzero entry per block.
__device__ __forceinline__ void flush_grad(const Smem& s, float* gvec,
                                           int grad_len, int copies) {
  __syncthreads();
  for (int i = threadIdx.x; i < grad_len; i += blockDim.x) {
    float v = 0.0f;
    for (int c = 0; c < copies; ++c) v += s.grad[c * (grad_len | 1) + i];
    if (v != 0.0f) atomicAdd(gvec + i, v);
  }
}

// A bounce as the forward sweep keeps it for the replay: the entry state's
// 13 floats, and one word with the entry's prev_spec flag (bit 0), the NEE
// shadow verdict (bit 1) and 1 + the sphere hit (bits 2 and up; 0: a miss).
struct Kept {
  float ox, oy, oz, dx, dy, dz, th_r, th_g, th_b, rad_r, rad_g, rad_b;
  float prev_pdf;
  uint32_t word;
};

__device__ __forceinline__ void keep_state(Kept& e, const Path& p) {
  e.ox = p.ox; e.oy = p.oy; e.oz = p.oz;
  e.dx = p.dx; e.dy = p.dy; e.dz = p.dz;
  e.th_r = p.th_r; e.th_g = p.th_g; e.th_b = p.th_b;
  e.rad_r = p.rad_r; e.rad_g = p.rad_g; e.rad_b = p.rad_b;
  e.prev_pdf = p.prev_pdf;
}

__device__ __forceinline__ uint32_t kept_word(bool prev_spec,
                                              const RecordingList& rec) {
  return (prev_spec ? 1u : 0u) | (rec.blocked ? 2u : 0u) |
         ((uint32_t)(rec.id + 1) << 2);
}

__device__ __forceinline__ Path kept_path(const Kept& e) {
  Path p;
  p.ox = e.ox; p.oy = e.oy; p.oz = e.oz;
  p.dx = e.dx; p.dy = e.dy; p.dz = e.dz;
  p.th_r = e.th_r; p.th_g = e.th_g; p.th_b = e.th_b;
  p.rad_r = e.rad_r; p.rad_g = e.rad_g; p.rad_b = e.rad_b;
  p.prev_pdf = e.prev_pdf;
  p.active = true;
  p.prev_spec = (e.word & 1u) != 0u;
  return p;
}

__device__ __forceinline__ RecordedSphere kept_geometry(const SceneView& sc,
                                                        const Kept& e) {
  return RecordedSphere{{sc}, (int)(e.word >> 2) - 1, (e.word & 2u) != 0u};
}

// One pixel: spp samples, each a forward sweep that keeps the bounces,
// then the reverse replay into the block's gradient vector.
__device__ __forceinline__ void grad_pixel(const K2Params& prm,
                                           const SceneView& sc,
                                           const SphereSink& sink,
                                           int pix) {
  const uint32_t start = (uint32_t)sc.meta[0];
  const uint32_t seed = (uint32_t)sc.meta[1];
  const uint32_t pid = (uint32_t)pix;
  const float px = (float)(pix % prm.width);
  const float py = (float)(pix / prm.width);
  const float ct_r = prm.ct[3 * pix + 0], ct_g = prm.ct[3 * pix + 1],
              ct_b = prm.ct[3 * pix + 2];
  float acc_r = 0.0f, acc_g = 0.0f, acc_b = 0.0f;
  Kept kept[kMaxDepth];
  for (int smp = 0; smp < prm.spp; ++smp) {
    const uint32_t sample = start + (uint32_t)smp;
    Path p;
    raygen(sc.blob, prm.inv_w, prm.inv_h, prm.aspect, prm.dof, pid, px, py,
           sample, seed, p);
    int n_run = 0;
    for (int k = 0; k < prm.max_bounces && p.active; ++k) {
      keep_state(kept[k], p);
      const bool prev_spec = p.prev_spec;
      const RecordingList rec{{sc}};
      trace_bounce(sc, rec, p, pid, sample, seed, k, prm.rr_depth,
                   prm.use_nee, prm.use_mis);
      kept[k].word = kept_word(prev_spec, rec);
      n_run = k + 1;
    }
    acc_r += p.rad_r;
    acc_g += p.rad_g;
    acc_b += p.rad_b;
    // Bounces a path did not run are the identity: replay only the others.
    float ct[13] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f,
                    0.0f, 0.0f, ct_r, ct_g, ct_b, 0.0f};
    for (int k = n_run - 1; k >= 0; --k)
      bounce_vjp(sc, kept_geometry(sc, kept[k]), sink, kept_path(kept[k]),
                 pid, sample, seed, k, prm.rr_depth, prm.use_nee,
                 prm.use_mis, ct);
  }
  prm.img[3 * pix + 0] = acc_r;
  prm.img[3 * pix + 1] = acc_g;
  prm.img[3 * pix + 2] = acc_b;
}

__global__ void __launch_bounds__(kThreadsGrad, kBlocksGrad)
    megakernel_grad_kernel(K2Params prm) {
  extern __shared__ float smem[];
  const Smem s = load_smem(smem, prm.blob, prm.meta, prm.lsb, prm.blob_len,
                           prm.meta_len, prm.grad_len, prm.copies);
  const SceneView sc{s.blob, s.meta, s.lsb, prm.n_prims, prm.n_light_slots,
                     s.meta[2], prm.sky_mode};
  const int pix = blockIdx.x * blockDim.x + threadIdx.x;
  if (pix < prm.width * prm.height)
    grad_pixel(prm, sc, block_sink(s, sc, prm.grad_len, prm.copies), pix);
  flush_grad(s, prm.gvec, prm.grad_len, prm.copies);
}

// One bounce's adjoint over n given lanes, for holding K2's per-lane code
// against its plain version: each lane runs the bounce forward with K2's
// recording geometry, then its adjoint with the recorded hit and verdict,
// into K2's sink.  state and state_ct are (13, n), aux (2, n) as int.
__global__ void __launch_bounds__(kThreadsGrad)
    bounce_vjp_kernel(float* gvec, float* out_ct, const float* state_ct,
                      const float* state, const int* aux, const uint32_t* pid,
                      const uint32_t* sample, const float* blob,
                      const int* meta, const float* lsb, int n, int n_prims,
                      int n_light_slots, int k, int rr_depth, bool use_nee,
                      bool use_mis, int sky_mode, int blob_len, int meta_len,
                      int grad_len, int copies) {
  extern __shared__ float smem[];
  const Smem s = load_smem(smem, blob, meta, lsb, blob_len, meta_len,
                           grad_len, copies);
  const SceneView sc{s.blob, s.meta, s.lsb, n_prims, n_light_slots,
                     s.meta[2], sky_mode};
  const SphereSink sink = block_sink(s, sc, grad_len, copies);
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) {
    const uint32_t seed = (uint32_t)s.meta[1];
    float ct[13];
    for (int c = 0; c < 13; ++c) ct[c] = state_ct[c * n + i];
    if (aux[i] != 0) {
      Path p;
      p.ox = state[0 * n + i]; p.oy = state[1 * n + i]; p.oz = state[2 * n + i];
      p.dx = state[3 * n + i]; p.dy = state[4 * n + i]; p.dz = state[5 * n + i];
      p.th_r = state[6 * n + i]; p.th_g = state[7 * n + i];
      p.th_b = state[8 * n + i];
      p.rad_r = state[9 * n + i]; p.rad_g = state[10 * n + i];
      p.rad_b = state[11 * n + i];
      p.prev_pdf = state[12 * n + i];
      p.active = true;
      p.prev_spec = aux[n + i] != 0;
      Path q = p;
      const RecordingList rec{{sc}};
      trace_bounce(sc, rec, q, pid[i], sample[i], seed, k, rr_depth, use_nee,
                   use_mis);
      bounce_vjp(sc, RecordedSphere{{sc}, rec.id, rec.blocked}, sink, p,
                 pid[i], sample[i], seed, k, rr_depth, use_nee, use_mis, ct);
    }
    for (int c = 0; c < 13; ++c) out_ct[c * n + i] = ct[c];
  }
  flush_grad(s, gvec, grad_len, copies);
}

__host__ inline int meta_len_of(int n_prims, int n_light_slots) {
  return kMetaFixed + n_prims + (n_light_slots > 1 ? n_light_slots : 1);
}

}  // namespace spt

extern "C" int spt_megakernel_grad(void* img, void* gvec, const void* blob,
                                   const void* meta, const void* lsb,
                                   const void* ct, int width, int height,
                                   int spp, int n_prims, int n_light_slots,
                                   int max_bounces, int rr_depth, int use_nee,
                                   int use_mis, int sky_mode, int dof,
                                   float inv_w, float inv_h, float aspect,
                                   void* stream) {
  if (max_bounces > spt::kMaxDepth) return static_cast<int>(cudaErrorInvalidValue);
  spt::K2Params prm;
  prm.img = static_cast<float*>(img);
  prm.gvec = static_cast<float*>(gvec);
  prm.blob = static_cast<const float*>(blob);
  prm.meta = static_cast<const int*>(meta);
  prm.lsb = static_cast<const float*>(lsb);
  prm.ct = static_cast<const float*>(ct);
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
  prm.meta_len = spt::meta_len_of(n_prims, n_light_slots);
  prm.grad_len = spt::kSphStride * n_prims + 6;
  prm.copies = spt::copies_for(prm.blob_len, prm.meta_len, prm.grad_len);
  const int n_pix = width * height;
  if (n_pix <= 0) return 0;
  const size_t smem = spt::smem_bytes(prm.blob_len, prm.meta_len,
                                      prm.grad_len, prm.copies);
  cudaFuncSetAttribute(spt::megakernel_grad_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem);
  const int blocks = (n_pix + spt::kThreadsGrad - 1) / spt::kThreadsGrad;
  spt::megakernel_grad_kernel<<<blocks, spt::kThreadsGrad, smem,
                                static_cast<cudaStream_t>(stream)>>>(prm);
  return static_cast<int>(cudaGetLastError());
}

// Blocks of K2 that share an SM for a scene of n_prims spheres (the CUDA
// occupancy calculator on the kernel as built), or -1 on an error.
extern "C" int spt_megakernel_grad_blocks_per_sm(int n_prims,
                                                 int n_light_slots) {
  const int blob_len = spt::kSphOff + spt::kSphStride * n_prims;
  const int meta_len = spt::meta_len_of(n_prims, n_light_slots);
  const int grad_len = spt::kSphStride * n_prims + 6;
  const size_t smem = spt::smem_bytes(
      blob_len, meta_len, grad_len,
      spt::copies_for(blob_len, meta_len, grad_len));
  cudaFuncSetAttribute(spt::megakernel_grad_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem);
  int blocks = -1;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &blocks, spt::megakernel_grad_kernel, spt::kThreadsGrad, smem) !=
      cudaSuccess)
    return -1;
  return blocks;
}

extern "C" int spt_bounce_vjp(void* gvec, void* out_ct, const void* state_ct,
                              const void* state, const void* aux,
                              const void* pid, const void* sample,
                              const void* blob, const void* meta,
                              const void* lsb, int n, int n_prims,
                              int n_light_slots, int k, int rr_depth,
                              int use_nee, int use_mis, int sky_mode,
                              void* stream) {
  if (n <= 0) return 0;
  const int blob_len = spt::kSphOff + spt::kSphStride * n_prims;
  const int meta_len = spt::meta_len_of(n_prims, n_light_slots);
  const int grad_len = spt::kSphStride * n_prims + 6;
  const int copies = spt::copies_for(blob_len, meta_len, grad_len);
  const size_t smem = spt::smem_bytes(blob_len, meta_len, grad_len, copies);
  cudaFuncSetAttribute(spt::bounce_vjp_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem);
  const int blocks = (n + spt::kThreadsGrad - 1) / spt::kThreadsGrad;
  spt::bounce_vjp_kernel<<<blocks, spt::kThreadsGrad, smem,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(gvec), static_cast<float*>(out_ct),
      static_cast<const float*>(state_ct), static_cast<const float*>(state),
      static_cast<const int*>(aux), static_cast<const uint32_t*>(pid),
      static_cast<const uint32_t*>(sample), static_cast<const float*>(blob),
      static_cast<const int*>(meta), static_cast<const float*>(lsb), n,
      n_prims, n_light_slots, k, rr_depth, use_nee != 0, use_mis != 0,
      sky_mode, blob_len, meta_len, grad_len, copies);
  return static_cast<int>(cudaGetLastError());
}
