// The packed BVH walked per thread, and the bounce over it: K3's geometry
// (csrc/megakernel_bvh.cu), shared with K4 (csrc/megakernel_bvh_grad.cu),
// whose forward sweep is K3's and records each bounce's winner and shadow
// verdict for its backward sweep.  See megakernel_bvh.cu for the design.
#pragma once

#include <cstdint>

#include "physics.cuh"

namespace spt {

constexpr int kMatOff = 21;              // blob: camera 15, sky 6, materials
constexpr int kMatStride = 8;            // ar ag ab er eg eb rough ior
constexpr int kLightStride = 7;          // cx cy cz r er eg eb
constexpr int kPrimAttrs = 5;            // cx cy cz r material-id

// 1/v, with 3e38 where |v| <= 1e-20 (the slab test's convention).
__device__ __forceinline__ float safe_inv(float v) {
  return fabsf(v) > 1e-20f ? 1.0f / v : 3e38f;
}

// K3's geometry: the packed BVH, walked per thread.  With kRecord (K4's
// forward sweep) it also writes the bounce's record to rec: the winner's
// cx cy cz r, its material id (-1 for a padding slot), leaf block and slot
// (-1 -1 on a miss), and the shadow verdict at rec[7] where a shadow ray
// is traced.  Without it (K3) the code is the walk alone.
template <bool kRecord>
struct BvhWalk {
  static constexpr int kLightEmit = 4;
  const float* nodef;    // 8 tables x n_nodes rows: min3 max3 pad2
  const int* nodei;      // 8 tables x n_nodes rows: skip, block id, pad6
  const float* prims;    // (n_blocks, 5, block)
  const float* mats;     // n_mats rows of kMatStride
  const int* mtypes;     // n_mats
  const float* invalid;  // K1's row of an invalid sphere, for a padding slot
  const float* lights;   // kLightStride per slot
  int n_nodes, block;
  float* rec;            // kRecord: this bounce's 8 floats

  // Slab test of table row `row` against the ray, below tmax; its skip
  // link and block id (-1 for an inner node) out.
  __device__ __forceinline__ bool node(int row, float ox, float oy, float oz,
                                       float ivx, float ivy, float ivz,
                                       float tmax, int& skip,
                                       int& blk) const {
    const float4* f = reinterpret_cast<const float4*>(nodef) + 2 * row;
    const float4 a = __ldg(f), b = __ldg(f + 1);
    const int2 ni = __ldg(reinterpret_cast<const int2*>(nodei) + 4 * row);
    skip = ni.x;
    blk = ni.y;
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

  // Row 0 of the table of the ray's direction octant, as the plain
  // version's _Walk._start orders them.
  __device__ __forceinline__ int table(float dx, float dy, float dz) const {
    return ((dx < 0.0f ? 4 : 0) + (dy < 0.0f ? 2 : 0) + (dz < 0.0f ? 1 : 0)) *
           n_nodes;
  }

  __device__ __forceinline__ bool sphere(const float* pb, int j, float ox,
                                         float oy, float oz, float dx,
                                         float dy, float dz, float& tj) const {
    return sphere_t4(__ldg(pb + j), __ldg(pb + block + j),
                     __ldg(pb + 2 * block + j), __ldg(pb + 3 * block + j), ox,
                     oy, oz, dx, dy, dz, tj);
  }

  __device__ __forceinline__ bool nearest(float ox, float oy, float oz,
                                          float dx, float dy, float dz,
                                          float& t, Hit& h) const {
    int win_j = 0;
    const int win_blk = nearest_slot(ox, oy, oz, dx, dy, dz, t, win_j);
    if (win_blk < 0) {
      no_winner();
      return false;
    }
    winner(win_blk, win_j, h);
    return true;
  }

  // The walk of nearest() alone: t the nearest distance (kBig on a miss),
  // the winner's leaf block returned (-1 for none), its slot in win_j.
  // K6's tree mode writes its residual from these.
  __device__ __forceinline__ int nearest_slot(float ox, float oy, float oz,
                                              float dx, float dy, float dz,
                                              float& t, int& win_j) const {
    const float ivx = safe_inv(dx), ivy = safe_inv(dy), ivz = safe_inv(dz);
    const int base = table(dx, dy, dz);
    t = kBig;
    int win_blk = -1;
    int ptr = 0;
    while (ptr < n_nodes) {
      int skip, blk;
      if (node(base + ptr, ox, oy, oz, ivx, ivy, ivz, t, skip, blk)) {
        if (blk < 0) {
          ++ptr;
          continue;
        }
        const float* pb = prims + (size_t)blk * kPrimAttrs * block;
        for (int j = 0; j < block; ++j) {
          float tj;
          if (sphere(pb, j, ox, oy, oz, dx, dy, dz, tj) && tj < t) {
            t = tj;
            win_blk = blk;
            win_j = j;
          }
        }
      }
      ptr = skip;
    }
    return win_blk;
  }

  // The winner, slot j of leaf block blk, into h (and the record).
  __device__ __forceinline__ void winner(int blk, int j, Hit& h) const {
    const float* pb = prims + (size_t)blk * kPrimAttrs * block + j;
    h.cx = __ldg(pb);
    h.cy = __ldg(pb + block);
    h.cz = __ldg(pb + 2 * block);
    h.r = __ldg(pb + 3 * block);
    const int mid = (int)__ldg(pb + 4 * block);
    h.mat = mid < 0 ? invalid : mats + kMatStride * mid;
    h.mtype = mid < 0 ? kLambert : mtypes[mid];
    h.id = mid;
    if constexpr (kRecord) {
      rec[0] = h.cx;
      rec[1] = h.cy;
      rec[2] = h.cz;
      rec[3] = h.r;
      rec[4] = (float)mid;
      rec[5] = (float)blk;
      rec[6] = (float)j;
    }
  }

  __device__ __forceinline__ void no_winner() const {
    if constexpr (kRecord) {
      rec[4] = -1.0f;
      rec[5] = -1.0f;
      rec[6] = -1.0f;
    }
  }

  __device__ __forceinline__ bool occluded(float ox, float oy, float oz,
                                           float dx, float dy, float dz,
                                           float tmax) const {
    const bool blocked = any_hit(ox, oy, oz, dx, dy, dz, tmax);
    if constexpr (kRecord) rec[7] = blocked ? 1.0f : 0.0f;
    return blocked;
  }

  __device__ __forceinline__ bool any_hit(float ox, float oy, float oz,
                                          float dx, float dy, float dz,
                                          float tmax) const {
    const float ivx = safe_inv(dx), ivy = safe_inv(dy), ivz = safe_inv(dz);
    const int base = table(dx, dy, dz);
    int ptr = 0;
    while (ptr < n_nodes) {
      int skip, blk;
      if (node(base + ptr, ox, oy, oz, ivx, ivy, ivz, tmax, skip, blk)) {
        if (blk < 0) {
          ++ptr;
          continue;
        }
        const float* pb = prims + (size_t)blk * kPrimAttrs * block;
        for (int j = 0; j < block; ++j) {
          float tj;
          if (sphere(pb, j, ox, oy, oz, dx, dy, dz, tj) && tj < tmax)
            return true;
        }
      }
      ptr = skip;
    }
    return false;
  }

  __device__ __forceinline__ const float* light(int l) const {
    return lights + kLightStride * l;
  }
};

using BvhGeometry = BvhWalk<false>;

// One bounce, called rather than inlined into the sample loop.  Inlined,
// the optimizing back end (ptxas at -O1 and above, and the driver's own
// compile of the PTX) gave images that part from the plain version's on 16
// of 2,073,600 pixels at config 5 (NEE shadow decisions only; the PTX is
// all round-to-nearest operations); built at -O0, or with this call, K3
// equals the plain version on every pixel.  The cause is not known;
// spt_tpu_torch/tools/k3_build_bits.py measures both forms.
template <bool kRecord>
__device__ __noinline__ void bvh_bounce(const SceneView& sc,
                                        const BvhWalk<kRecord>& geo, Path& p,
                                        uint32_t pid, uint32_t sample,
                                        uint32_t seed, int k, int rr_depth,
                                        bool use_nee, bool use_mis) {
  trace_bounce(sc, geo, p, pid, sample, seed, k, rr_depth, use_nee, use_mis);
}

}  // namespace spt
