// The sorted wavefront's three kernels: K5 (raygen), K6 (intersect) and K7
// (shade), for environment-map skies and scenes above 2048 spheres.
//
// The wavefront keeps every ray's state in device memory between kernels,
// channel-major: a (17, R) float32 stream (o, d, throughput, radiance,
// prev_pdf, alive, spec, in_image, miss; wavefront.py's C_* map) and two
// int32 id rows (pixel id, sample id), stored as rows 17 and 18 of one
// (19, R) buffer so that the sort between bounces gathers all of them at
// once.  R is a multiple of the 1024-lane tile.  Between the kernels the
// glue (torch ops in kernels/wavefront.py) sorts the stream by a coherence
// key, culls each tile's rays against every leaf block's box (the precull:
// one candidate list per tile, nearest-first), rebuilds the shadow rays and
// culls them too.
//
// * K5 replaces spt_tpu/kernels/wavefront.py::_raygen_kernel (launched by
//   _raygen_launch): the initial state of every lane of chunk_spp images
//   in 32x32 swizzled pixel tiles, plus one all-pad tile.  One thread per
//   lane.  Bound: bytes, the 76 bytes it writes per lane.  Neighbouring
//   threads store neighbouring addresses of each channel.
// * K6 replaces wavefront.py::_isect_kernel (and the sweep it calls,
//   megakernel_bvh.py::_cand_sweep_nearest): every ray's nearest hit over
//   its tile's candidate blocks, written as an 8-channel residual (hcx hcy
//   hcz hr hmid hblk hslot 0; hmid -1 where nothing was hit).  One thread
//   per ray; the 1024 threads of a tile read the same list entries and leaf
//   blocks (broadcast loads through L1).  Bound: fp32 operations of the
//   sphere tests.  The TPU kernel stops a whole 1024-ray packet once the
//   next candidate's entry bound passes the packet's worst winner; here each
//   thread stops on its own once the bound passes its own winner (a later
//   block cannot hold a nearer hit: t >= box entry >= ctn[i] >= t_lane), so
//   no thread waits for its tile and the block needs no syncs.
// * K7 replaces wavefront.py::_shade_kernel: trace_bounce (physics.cuh) on
//   every alive ray, its nearest hit rebuilt from K6's residual (the TPU's
//   megakernel_bvh_grad.py::_rebuilt_intersect) and its shadow ray tested
//   against the tile's shadow candidate list (megakernel_bvh.py::
//   _cand_sweep_anyhit), each thread stopping at its first blocker or once
//   the next candidate's entry bound passes its light distance.  Updates
//   the stream in place (the TPU kernel's alias); a dead lane keeps its
//   state and has its miss flag cleared.  Bound: bytes, 152 a ray: an
//   alive ray reads 15 state channels (all but in_image and miss), its two
//   ids and 5 residual channels (hcx hcy hcz hr hmid) and writes 16
//   channels (all but in_image); the fp32 operations of the bounce and the
//   shadow tests come close.  One thread per ray, its state in registers;
//   the scene uniforms sit in shared memory.
//
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
//   the post-bounce cotangent to the pre-bounce one, and writes its
//   winner's centre and radius cotangent; the sky, material and light
//   gradients are summed per block in shared memory (shared atomics) and
//   added to the global vector once a block, as K2 adds them.  Bound: fp32
//   operations of the replay and its adjoint (the bytes, some 230 a lane,
//   come close).
//
// Lanes past the alive prefix (the sorted stream's dead suffix) are not
// launched: K6, K7 and K9 take the prefix length, where the TPU kernels
// redirect those grid steps to the pad tile.  K10 copies their cotangent
// through, as the TPU kernel's alias does.
//
// Built with nvcc for sm_90a without --use_fast_math and with --fmad=false
// (see kernels/_build.py); entries return cudaGetLastError().

#include <cuda_runtime.h>

#include <cstdint>

#include "camera.cuh"
#include "physics.cuh"
#include "physics_adj.cuh"
#include "rng.cuh"

namespace spt {

constexpr int kTile = 1024;                // lanes of a stream tile
constexpr int kTileW = 32;                 // its pixels: 32 x 32, swizzled
constexpr int kThreadsWf = 256;
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
// K6: intersect.
// ---------------------------------------------------------------------------

struct IsectParams {
  float* res;           // (8, n_lanes)
  const float* st;      // channel stride `stride`
  const float* prims;   // (n_blocks, 5, block)
  const int* cand;      // (tiles, 1, n_blocks + 1): count, block ids
  const float* ctn;     // (tiles, 1, n_blocks): entry bounds, nondecreasing
  int stride, n_lanes, n_blocks, block;
};

__global__ void __launch_bounds__(kThreadsWf) isect_kernel(IsectParams prm) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= prm.n_lanes) return;
  const size_t s = (size_t)prm.stride;
  const float* st = prm.st + i;
  float t = kBig, hcx = 0.0f, hcy = 0.0f, hcz = 0.0f, hr = 0.0f;
  float hmid = -1.0f, hblk = -1.0f, hslot = -1.0f;
  if (st[kChAlive * s] > 0.5f) {
    const float ox = st[0], oy = st[s], oz = st[2 * s];
    const float dx = st[3 * s], dy = st[4 * s], dz = st[5 * s];
    const int tile = i / kTile;
    const int* cl = prm.cand + (size_t)tile * (prm.n_blocks + 1);
    const float* tl = prm.ctn + (size_t)tile * prm.n_blocks;
    const int ncand = __ldg(cl);
    for (int c = 0; c < ncand; ++c) {
      if (__ldg(tl + c) >= t) break;      // no nearer hit in what is left
      const int blk = __ldg(cl + 1 + c);
      const float* pb = prm.prims + (size_t)blk * kWfPrimAttrs * prm.block;
      for (int j = 0; j < prm.block; ++j) {
        const float cx = __ldg(pb + j), cy = __ldg(pb + prm.block + j);
        const float cz = __ldg(pb + 2 * prm.block + j);
        const float r = __ldg(pb + 3 * prm.block + j);
        float tj;
        if (sphere_t4(cx, cy, cz, r, ox, oy, oz, dx, dy, dz, tj) && tj < t) {
          t = tj;
          hcx = cx;
          hcy = cy;
          hcz = cz;
          hr = r;
          hmid = __ldg(pb + 4 * prm.block + j);
          hblk = (float)blk;
          hslot = (float)j;
        }
      }
    }
  }
  const size_t n = (size_t)prm.n_lanes;
  float* out = prm.res + i;
  out[0] = hcx;
  out[n] = hcy;
  out[2 * n] = hcz;
  out[3 * n] = hr;
  out[4 * n] = t < kBig ? hmid : -1.0f;
  out[5 * n] = hblk;
  out[6 * n] = hslot;
  out[7 * n] = 0.0f;
}

// ---------------------------------------------------------------------------
// K7: shade.
// ---------------------------------------------------------------------------

// K7's geometry: the lane's nearest hit rebuilt from K6's winner, and its
// tile's shadow candidate list.  With `blocked` (K9) the shadow test also
// writes its verdict there.
struct WavefrontGeometry {
  static constexpr int kLightEmit = 4;
  float hcx, hcy, hcz, hr, hmid;
  const float* prims;   // (n_blocks, 5, block)
  const int* scl;       // the tile's shadow list: count, block ids
  const float* stl;     // its entry bounds
  const float* mats;    // n_mats rows of kWfMatStride
  const int* mtypes;    // n_mats
  const float* lights;  // kWfLightStride per slot
  int block;
  float* blocked;       // K9: this lane's verdict; K7: null

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
    const bool hit = sweep(ox, oy, oz, dx, dy, dz, tmax);
    if (blocked) *blocked = hit ? 1.0f : 0.0f;
    return hit;
  }

  __device__ __forceinline__ bool sweep(float ox, float oy, float oz,
                                        float dx, float dy, float dz,
                                        float tmax) const {
    const int ncand = __ldg(scl);
    for (int c = 0; c < ncand; ++c) {
      if (__ldg(stl + c) >= tmax) break;  // every later box is past the light
      const int blk = __ldg(scl + 1 + c);
      const float* pb = prims + (size_t)blk * kWfPrimAttrs * block;
      for (int j = 0; j < block; ++j) {
        float tj;
        if (sphere_t4(__ldg(pb + j), __ldg(pb + block + j),
                      __ldg(pb + 2 * block + j), __ldg(pb + 3 * block + j),
                      ox, oy, oz, dx, dy, dz, tj) &&
            tj < tmax)
          return true;
      }
    }
    return false;
  }

  __device__ __forceinline__ const float* light(int l) const {
    return lights + kWfLightStride * l;
  }
};

// One bounce, called rather than inlined, as K3 calls its bounce: an
// inlined bounce in K3 parted from the plain version on a few NEE shadow
// decisions at config 5 (ROADMAP.md), and K7's shadow rays must be the ones
// the glue culled for.
__device__ __noinline__ bool wf_bounce(const SceneView& sc,
                                       const WavefrontGeometry& geo, Path& p,
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
  const int* scand;     // (tiles, 1, n_blocks + 1), unread without NEE
  const float* sctn;    // (tiles, 1, n_blocks)
  float* blocked;       // K9: (n_lanes,) shadow verdicts; K7: null
  int stride, n_lanes, n_blocks, block, n_mats, n_light_slots, k, rr_depth;
  int sky_mode, blob_len;
  bool use_nee, use_mis;
};

__global__ void __launch_bounds__(kThreadsWf) shade_kernel(ShadeParams prm) {
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
    st[kChMiss * s] = 0.0f;
    return;
  }
  Path p;
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

  const size_t n = (size_t)prm.n_lanes;
  const float* res = prm.res + i;
  const int tile = i / kTile;
  const bool nee = prm.use_nee && prm.n_light_slots > 0;
  const float* mats = s_blob + kWfMatOff;
  const WavefrontGeometry geo{
      res[0], res[n], res[2 * n], res[3 * n], res[4 * n], prm.prims,
      nee ? prm.scand + (size_t)tile * (prm.n_blocks + 1) : prm.scand,
      nee ? prm.sctn + (size_t)tile * prm.n_blocks : prm.sctn, mats,
      s_mtypes, mats + kWfMatStride * prm.n_mats, prm.block,
      prm.blocked ? prm.blocked + i : nullptr};
  const SceneView sc{s_blob, s_meta, s_lsb, 0, prm.n_light_slots, s_meta[2],
                     prm.sky_mode};
  const uint32_t pid = (uint32_t)prm.ids[i];
  const uint32_t sample = (uint32_t)prm.ids[s + i];
  const bool missed = wf_bounce(sc, geo, p, pid, sample, (uint32_t)s_meta[1],
                                prm.k, prm.rr_depth, prm.use_nee,
                                prm.use_mis);
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
  st[kChMiss * s] = (missed && prm.sky_mode == kSkyEnvmap) ? 1.0f : 0.0f;
}

// ---------------------------------------------------------------------------
// K10: one bounce's adjoint.
// ---------------------------------------------------------------------------

struct BounceBwdParams {
  float* din;           // (17, stride): cotangent of the pre-bounce stream
  float* dgeo;          // (4, n_lanes): d(cx, cy, cz, r) of each winner
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
  int blob_len, n_scal;
  bool use_nee, use_mis;
};

__global__ void __launch_bounds__(kThreadsWf)
    bounce_bwd_kernel(BounceBwdParams prm) {
  extern __shared__ float smem[];
  float* s_blob = smem;
  float* s_invalid = s_blob + prm.blob_len;             // 8
  float* s_lsb = s_invalid + kWfMatStride;              // 6
  int* s_meta = reinterpret_cast<int*>(s_lsb + 6);      // 3
  int* s_mtypes = s_meta + 3;                           // n_mats
  float* s_grad = reinterpret_cast<float*>(s_mtypes + prm.n_mats);  // n_scal
  for (int a = threadIdx.x; a < prm.blob_len; a += blockDim.x)
    s_blob[a] = prm.blob[a];
  for (int a = threadIdx.x; a < prm.n_mats; a += blockDim.x)
    s_mtypes[a] = prm.mtypes[a];
  for (int a = threadIdx.x; a < prm.n_scal; a += blockDim.x)
    s_grad[a] = 0.0f;
  if (threadIdx.x < kWfMatStride)
    s_invalid[threadIdx.x] = threadIdx.x == kWfMatStride - 1 ? 1.5f : 0.0f;
  if (threadIdx.x < 6) s_lsb[threadIdx.x] = prm.lsb[threadIdx.x];
  if (threadIdx.x < 3) s_meta[threadIdx.x] = prm.meta[threadIdx.x];
  __syncthreads();

  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const size_t s = (size_t)prm.stride;
  if (i < prm.n_lanes) {
    const float* st = prm.st + i;
    const float* cti = prm.ct + i;
    float ct[13];
    for (int c = 0; c < 13; ++c) ct[c] = cti[c * s];
    float dgeo[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    if (st[kChAlive * s] > 0.5f) {
      Path p;
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
      const size_t n = (size_t)prm.n_lanes;
      const float* res = prm.res + i;
      const float* mats = s_blob + kWfMatOff;
      const RebuiltGeometry geo{res[0],     res[n],       res[2 * n],
                                res[3 * n], res[4 * n],   res[7 * n] > 0.5f,
                                mats,       s_mtypes,     s_invalid,
                                mats + kWfMatStride * prm.n_mats, prm.n_mats};
      const SceneView sc{s_blob, s_meta, s_lsb, 0, prm.n_light_slots,
                         s_meta[2], prm.sky_mode};
      ScalarSink sink{s_grad, prm.n_mats, {0.0f, 0.0f, 0.0f, 0.0f}};
      bounce_vjp(sc, geo, sink, p, (uint32_t)prm.ids[i],
                 (uint32_t)prm.ids[s + i], (uint32_t)s_meta[1], prm.k,
                 prm.rr_depth, prm.use_nee, prm.use_mis, ct);
      for (int a = 0; a < 4; ++a) dgeo[a] = sink.dgeo[a];
    }
    float* din = prm.din + i;
    for (int c = 0; c < 13; ++c) din[c * s] = ct[c];
    din[kChAlive * s] = 0.0f;
    din[kChSpec * s] = 0.0f;
    din[kChInimg * s] = cti[kChInimg * s];
    din[kChMiss * s] = 0.0f;
    for (int a = 0; a < 4; ++a) prm.dgeo[a * (size_t)prm.n_lanes + i] = dgeo[a];
  } else if (i < prm.stride) {
    for (int c = 0; c < kNCh; ++c) prm.din[c * s + i] = prm.ct[c * s + i];
  }
  __syncthreads();
  for (int a = threadIdx.x; a < prm.n_scal; a += blockDim.x)
    if (s_grad[a] != 0.0f) atomicAdd(prm.dscal + a, s_grad[a]);
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
                                   const void* ctn, int stride, int n_lanes,
                                   int n_blocks, int block, void* stream) {
  spt::IsectParams prm;
  prm.res = static_cast<float*>(res);
  prm.st = static_cast<const float*>(st);
  prm.prims = static_cast<const float*>(prims);
  prm.cand = static_cast<const int*>(cand);
  prm.ctn = static_cast<const float*>(ctn);
  prm.stride = stride;
  prm.n_lanes = n_lanes;
  prm.n_blocks = n_blocks;
  prm.block = block;
  if (n_lanes <= 0) return 0;
  spt::isect_kernel<<<spt::blocks_for(n_lanes), spt::kThreadsWf, 0,
                      static_cast<cudaStream_t>(stream)>>>(prm);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int spt_wavefront_shade(
    void* st, const void* ids, const void* res, const void* blob,
    const void* meta, const void* lsb, const void* prims, const void* mtypes,
    const void* scand, const void* sctn, void* blocked, int stride,
    int n_lanes,
    int n_blocks, int block, int n_mats, int n_light_slots, int k,
    int rr_depth, int use_nee, int use_mis, int sky_mode, void* stream) {
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
  spt::shade_kernel<<<spt::blocks_for(n_lanes), spt::kThreadsWf, smem,
                      static_cast<cudaStream_t>(stream)>>>(prm);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int spt_wavefront_bounce_bwd(
    void* din, void* dgeo, void* dscal, const void* st, const void* ids,
    const void* res, const void* ct, const void* blob, const void* meta,
    const void* lsb, const void* mtypes, int stride, int n_lanes, int n_mats,
    int n_light_slots, int k, int rr_depth, int use_nee, int use_mis,
    int sky_mode, void* stream) {
  spt::BounceBwdParams prm;
  prm.din = static_cast<float*>(din);
  prm.dgeo = static_cast<float*>(dgeo);
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
  prm.use_nee = use_nee != 0;
  prm.use_mis = use_mis != 0;
  prm.blob_len = spt::kWfMatOff + spt::kWfMatStride * n_mats +
                 spt::kWfLightStride * (n_light_slots > 1 ? n_light_slots : 1);
  prm.n_scal = 6 + spt::kWfMatStride * n_mats + spt::kWfLightStride *
                                                    n_light_slots;
  if (stride <= 0) return 0;
  const size_t smem = sizeof(float) * (prm.blob_len + spt::kWfMatStride + 6 +
                                       3 + n_mats + prm.n_scal);
  spt::bounce_bwd_kernel<<<spt::blocks_for(stride), spt::kThreadsWf, smem,
                           static_cast<cudaStream_t>(stream)>>>(prm);
  return static_cast<int>(cudaGetLastError());
}
