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
// What this simple design does about it: a warp's 32 threads cover an 8x4
// pixel block (a block of 128 threads 16x8), so primary rays of a warp walk
// alike; the image is written unswizzled (H, W, 3).  Packet culling,
// persistent threads and ray sorting are left for later.
//
// Built with nvcc for sm_90a without --use_fast_math and with
// --fmad=false (see kernels/_build.py); entries return cudaGetLastError().

#include <cuda_runtime.h>

#include <cstdint>

#include "bvh.cuh"
#include "camera.cuh"
#include "physics.cuh"
#include "rng.cuh"

namespace spt {

constexpr int kThreadsBvh = 128;
constexpr int kTileW = 16, kTileH = 8;   // a block's pixels

struct K3Params {
  float* out;            // (H, W, 3) radiance sum
  const float* blob;     // 21 + 8 * n_mats + 7 * max(n_light_slots, 1)
  const int* meta;       // start_sample, seed, n_lights
  const float* lsb;      // 6
  const float* nodef;    // 8 * n_nodes * 8
  const int* nodei;      // 8 * n_nodes * 8
  const float* prims;    // n_blocks * 5 * block
  const int* mtypes;     // n_mats
  int width, height, spp, n_nodes, block, n_mats, n_light_slots;
  int max_bounces, rr_depth, sky_mode;
  bool use_nee, use_mis, dof;
  float inv_w, inv_h, aspect;  // f32(1/width), f32(1/height), f32(W/H)
  int blob_len;
};

__global__ void __launch_bounds__(kThreadsBvh)
    megakernel_bvh_kernel(K3Params prm) {
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

  // A warp covers 8x4 pixels of the block's 16x8.
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int x = blockIdx.x * kTileW + (warp & 1) * 8 + (lane & 7);
  const int y = blockIdx.y * kTileH + (warp >> 1) * 4 + (lane >> 3);
  if (x >= prm.width || y >= prm.height) return;
  const int pix = y * prm.width + x;
  const SceneView sc{s_blob, s_meta, s_lsb, 0, prm.n_light_slots, s_meta[2],
                     prm.sky_mode};
  const float* mats = s_blob + kMatOff;
  const BvhGeometry geo{prm.nodef, prm.nodei, prm.prims, mats, s_mtypes,
                        s_invalid, mats + kMatStride * prm.n_mats,
                        prm.n_nodes, prm.block};
  const uint32_t start = (uint32_t)s_meta[0];
  const uint32_t seed = (uint32_t)s_meta[1];
  const uint32_t pid = (uint32_t)pix;

  float acc_r = 0.0f, acc_g = 0.0f, acc_b = 0.0f;
  for (int s = 0; s < prm.spp; ++s) {
    const uint32_t sample = start + (uint32_t)s;
    Path p;
    raygen(s_blob, prm.inv_w, prm.inv_h, prm.aspect, prm.dof, pid, (float)x,
           (float)y, sample, seed, p);
    for (int k = 0; k < prm.max_bounces && p.active; ++k)
      bvh_bounce(sc, geo, p, pid, sample, seed, k, prm.rr_depth,
                 prm.use_nee, prm.use_mis);
    acc_r += p.rad_r;
    acc_g += p.rad_g;
    acc_b += p.rad_b;
  }
  prm.out[3 * pix + 0] = acc_r;
  prm.out[3 * pix + 1] = acc_g;
  prm.out[3 * pix + 2] = acc_b;
}

}  // namespace spt

extern "C" int spt_megakernel_bvh_fwd(
    void* out, const void* blob, const void* meta, const void* lsb,
    const void* nodef, const void* nodei, const void* prims,
    const void* mtypes, int width, int height, int spp, int n_nodes,
    int block, int n_mats, int n_light_slots, int max_bounces, int rr_depth,
    int use_nee, int use_mis, int sky_mode, int dof, float inv_w, float inv_h,
    float aspect, void* stream) {
  spt::K3Params prm;
  prm.out = static_cast<float*>(out);
  prm.blob = static_cast<const float*>(blob);
  prm.meta = static_cast<const int*>(meta);
  prm.lsb = static_cast<const float*>(lsb);
  prm.nodef = static_cast<const float*>(nodef);
  prm.nodei = static_cast<const int*>(nodei);
  prm.prims = static_cast<const float*>(prims);
  prm.mtypes = static_cast<const int*>(mtypes);
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
  prm.use_nee = use_nee != 0;
  prm.use_mis = use_mis != 0;
  prm.dof = dof != 0;
  prm.inv_w = inv_w;
  prm.inv_h = inv_h;
  prm.aspect = aspect;
  prm.blob_len = spt::kMatOff + spt::kMatStride * n_mats +
                 spt::kLightStride * (n_light_slots > 1 ? n_light_slots : 1);
  if (width <= 0 || height <= 0) return 0;
  const size_t smem =
      sizeof(float) * (prm.blob_len + spt::kMatStride + 6 + 3 + n_mats);
  const dim3 grid((width + spt::kTileW - 1) / spt::kTileW,
                  (height + spt::kTileH - 1) / spt::kTileH);
  spt::megakernel_bvh_kernel<<<grid, spt::kThreadsBvh, smem,
                               static_cast<cudaStream_t>(stream)>>>(prm);
  return static_cast<int>(cudaGetLastError());
}
