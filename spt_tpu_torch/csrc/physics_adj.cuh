// The adjoint of one bounce for one ray, as __device__ code.
//
// The per-thread transcription of spt_tpu_torch/kernels/physics_adjoint.py
// ::trace_bounce_vjp, term for term: the reverse mode of trace_bounce
// (physics.cuh), which is JAX's jax.vjp of spt_tpu/kernels/physics.py::
// trace_bounce.  It recomputes the bounce's forward from the entry state with
// physics.cuh's own expressions (so every discrete choice and every tie test
// sees the forward sweep's bits), then runs it in reverse:
//  * discrete choices carry no gradient (nearest hit, lobe, reflect or
//    refract, the roulette kill, the light pick, the shadow verdict);
//  * max / min / clip split the cotangent at an exact tie, as jax.vjp does
//    (dmax, dclip), and the forward's floors bound every local derivative;
//  * p_cont is detached for the kill test only, 1/p_cont is differentiated.
// Where the plain version evaluates every material's branch and masks, this
// code takes the hit material's branch only; the others contribute zero.
//
// bounce_vjp is generic in its geometry, as trace_bounce is, and in where
// theta's cotangent goes (a sink): K2 rebuilds the hit from the sphere its
// forward sweep recorded, takes the recorded shadow verdict and adds into
// sphere rows of its thread's copy of the gradient (RecordedSphere,
// SphereSink); K4 and K10 rebuild the hit from a recorded
// winner, take the recorded shadow verdict and keep the lane's sky, material
// row, light slot and winner cotangents in registers for a warp sum
// (RebuiltGeometry, LaneSink).
#pragma once

#include <cstdint>

#include "physics.cuh"
#include "rng.cuh"

namespace spt {

struct V3 {
  float x, y, z;
};

__device__ __forceinline__ V3 operator+(V3 a, V3 b) {
  return {a.x + b.x, a.y + b.y, a.z + b.z};
}
__device__ __forceinline__ V3 operator-(V3 a, V3 b) {
  return {a.x - b.x, a.y - b.y, a.z - b.z};
}
__device__ __forceinline__ V3 operator-(V3 a) { return {-a.x, -a.y, -a.z}; }
__device__ __forceinline__ V3 operator*(float s, V3 a) {
  return {s * a.x, s * a.y, s * a.z};
}
__device__ __forceinline__ V3 operator*(V3 a, V3 b) {
  return {a.x * b.x, a.y * b.y, a.z * b.z};
}
__device__ __forceinline__ V3& operator+=(V3& a, V3 b) {
  a = a + b;
  return a;
}
__device__ __forceinline__ V3& operator-=(V3& a, V3 b) {
  a = a - b;
  return a;
}
// Summed in dot3's order, so a tie test on it sees the forward's bits.
__device__ __forceinline__ float dot(V3 a, V3 b) {
  return a.x * b.x + a.y * b.y + a.z * b.z;
}
__device__ __forceinline__ V3 cross(V3 a, V3 b) {
  return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x};
}
__device__ __forceinline__ float sum3(V3 a) { return a.x + a.y + a.z; }

// d maximum(x, c) / dx as JAX takes it: 1 above c, 0.5 at c, 0 below.
__device__ __forceinline__ float dmax(float x, float c) {
  return x > c ? 1.0f : (x == c ? 0.5f : 0.0f);
}
__device__ __forceinline__ float dmin(float x, float c) {
  return x < c ? 1.0f : (x == c ? 0.5f : 0.0f);
}
// d clip(x, lo, hi) / dx, clip = minimum(maximum(x, lo), hi).
__device__ __forceinline__ float dclip(float x, float lo, float hi) {
  return dmax(x, lo) * dmin(fmaxf(x, lo), hi);
}
// Cotangent of x for y = sqrt(x).
__device__ __forceinline__ float sqrt_adj(float y, float yb) {
  return yb * (0.5f / y);
}

// Cotangent of v for n = v * rsqrt(max(v.v, floor)); floor < 0: plain rsqrt.
__device__ __forceinline__ V3 normalize_adj(V3 v, V3 nb, float floor) {
  float n2 = dot(v, v);
  float m = floor < 0.0f ? n2 : fmaxf(n2, floor);
  float inv = 1.0f / sqrtf(m);
  float k = inv / m * dot(v, nb);
  if (floor >= 0.0f) k = k * dmax(n2, floor);
  return inv * nb - k * v;
}

// Cotangent of n for (t, b) = onb(n): t = normalize(u x n), b = n x t.
__device__ __forceinline__ V3 onb_adj(V3 n, V3 tb, V3 bb) {
  bool use_z = fabsf(n.z) < 0.999f;
  V3 u = {use_z ? 0.0f : 1.0f, 0.0f, use_z ? 1.0f : 0.0f};
  V3 t_raw = cross(u, n);
  V3 t = (1.0f / sqrtf(fmaxf(dot(t_raw, t_raw), 1e-20f))) * t_raw;
  V3 traw_b = normalize_adj(t_raw, tb + cross(bb, n), 1e-20f);
  return cross(t, bb) + cross(traw_b, u);
}

// f = f0 + (1 - f0) m^5, m = clip(1 - c, 0, 1): adds f0's cotangent to f0b,
// returns c's.
__device__ __forceinline__ float schlick_adj(float c, V3 f0, V3 fb, V3& f0b) {
  float x = 1.0f - c;
  float m = clampf(x, 0.0f, 1.0f);
  float m2 = m * m;
  float m5 = m2 * m2 * m;
  f0b += V3{fb.x * (1.0f - m5), fb.y * (1.0f - m5), fb.z * (1.0f - m5)};
  V3 mb = (5.0f * m2 * m2) * (fb * V3{1.0f - f0.x, 1.0f - f0.y, 1.0f - f0.z});
  return -sum3(mb) * dclip(x, 0.0f, 1.0f);
}

// g1 = x / (x (1 - kg) + kg).
__device__ __forceinline__ void g1_adj(float x, float kg, float gb, float& xb,
                                       float& kgb) {
  float den = x * (1.0f - kg) + kg;
  float den2 = den * den;
  xb += gb * kg / den2;
  kgb += -gb * x * (1.0f - x) / den2;
}

// D = a2g / max(pi q^2, 1e-12), q = nh^2 (a2g - 1) + 1.
__device__ __forceinline__ void ggx_d_adj(float nh, float a2g, float db,
                                          float& nhb, float& a2gb) {
  float q = nh * nh * (a2g - 1.0f) + 1.0f;
  float qq = kPi * (q * q);
  float m = fmaxf(qq, 1e-12f);
  float qb = (-db * a2g / (m * m)) * dmax(qq, 1e-12f) * kTwoPi * q;
  nhb += qb * 2.0f * nh * (a2g - 1.0f);
  a2gb += db / m + qb * nh * nh;
}

// The sphere-cone pdf 1 / max(2 pi (1 - cosm), 1e-9) / nlf, with cosm =
// sqrt(1 - clip(r r / d2, 0, 1)) (0 where the clip reaches 1): (r, d2)
// cotangents from the pdf's and a further cotangent of cosm.
__device__ __forceinline__ void cone_adj(float r, float d2, float cosm,
                                         bool deg, float pdf_b, float cosm_b,
                                         float nlf, float& rb, float& d2b) {
  float x = kTwoPi * (1.0f - cosm);
  float m = fmaxf(x, 1e-9f);
  cosm_b = cosm_b + kTwoPi * (pdf_b / nlf) / (m * m) * dmax(x, 1e-9f);
  float sin2_b = deg ? 0.0f : -sqrt_adj(cosm, cosm_b);
  float q = r * r / d2;
  float qb = sin2_b * dclip(q, 0.0f, 1.0f);
  rb += 2.0f * r * qb / d2;
  d2b += -qb * q / d2;
}

__device__ __forceinline__ void grad_add(float* g, int i, float v) {
  if (v != 0.0f) atomicAdd(g + i, v);
}

// K2's forward geometry: the sphere list, remembering the nearest hit's
// sphere (-1: none) and the shadow verdict, for the replay.
struct RecordingList : SphereList {
  mutable int id = -1;
  mutable bool blocked = false;

  __device__ __forceinline__ bool nearest(float ox, float oy, float oz,
                                          float dx, float dy, float dz,
                                          float& t, Hit& h) const {
    const bool found = SphereList::nearest(ox, oy, oz, dx, dy, dz, t, h);
    id = found ? h.id : -1;
    return found;
  }

  __device__ __forceinline__ bool occluded(float ox, float oy, float oz,
                                           float dx, float dy, float dz,
                                           float tmax) const {
    blocked = SphereList::occluded(ox, oy, oz, dx, dy, dz, tmax);
    return blocked;
  }
};

// K2's replay geometry: the hit rebuilt from the sphere the forward sweep
// recorded (id < 0: no hit) by sphere_t, the expression intersect took its
// distance from, so t has the forward's bits without sweeping the list; the
// recorded shadow verdict.
struct RecordedSphere : SphereList {
  int id;
  bool blocked;

  __device__ __forceinline__ bool nearest(float ox, float oy, float oz,
                                          float dx, float dy, float dz,
                                          float& t, Hit& h) const {
    if (id < 0) return false;
    const float* s = sc.blob + kSphOff + kSphStride * id;
    sphere_t(s, ox, oy, oz, dx, dy, dz, t);
    h.cx = s[0];
    h.cy = s[1];
    h.cz = s[2];
    h.r = s[3];
    h.mat = s + 4;
    h.mtype = sc.meta[kMetaFixed + id];
    h.id = id;
    return true;
  }

  __device__ __forceinline__ bool occluded(float, float, float, float, float,
                                           float, float) const {
    return blocked;
  }
};

// K2's sink: theta's cotangent into g, this thread's copy of the block's
// gradient vector in shared memory (megakernel_grad.cu keeps a copy per
// thread where the scene is small enough, else one per few lanes): sphere
// j's 12 attributes at 12 j, the sky at 12 n_prims; a light slot's
// attributes go to its owning sphere's row.  A copy of the thread's own
// (own) takes plain adds of every value, with no test and no atomic; a
// shared one a shared atomic per nonzero value.
struct SphereSink {
  float* g;
  bool own;
  const SceneView& sc;

  template <int N>
  __device__ __forceinline__ void add(float* row, const int (&col)[N],
                                      const float (&v)[N]) const {
    if (own) {
      for (int c = 0; c < N; ++c) row[col[c]] += v[c];
    } else {
      for (int c = 0; c < N; ++c) grad_add(row, col[c], v[c]);
    }
  }
  __device__ __forceinline__ void sky(int i, float v) const {
    add<1>(g + kSphStride * sc.n_prims + i, {0}, {v});
  }
  __device__ __forceinline__ void light(int l, V3 toc_b, float lrr_b,
                                        V3 le_b) const {
    add<7>(g + kSphStride * sc.meta[kMetaFixed + sc.n_prims + l],
           {0, 1, 2, 3, 7, 8, 9},
           {toc_b.x, toc_b.y, toc_b.z, lrr_b, le_b.x, le_b.y, le_b.z});
  }
  __device__ __forceinline__ void hit(int j, V3 C_b, float r_b, V3 a_b,
                                      V3 e_b, float rough_b,
                                      float ior_b) const {
    add<12>(g + kSphStride * j, {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11},
            {C_b.x, C_b.y, C_b.z, r_b, a_b.x, a_b.y, a_b.z, e_b.x, e_b.y,
             e_b.z, rough_b, ior_b});
  }
};

// A winner recorded by a forward sweep (K4's walk, K6), rebuilt: the
// plain version's wavefront._rebuilt_intersect.  hmid < 0: no hit;
// hmid == n_mats: a padding slot, which takes K1's row of an invalid
// sphere as K3 does.  The shadow verdict is the recorded one.
struct RebuiltGeometry {
  static constexpr int kLightEmit = 4;
  float hcx, hcy, hcz, hr, hmid;
  bool blocked;
  const float* mats;     // n_mats rows of 8
  const int* mtypes;     // n_mats
  const float* invalid;  // K1's invalid row
  const float* lights;   // 7 per slot
  int n_mats;

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
    h.mat = mid < n_mats ? mats + 8 * mid : invalid;
    h.mtype = mid < n_mats ? mtypes[mid] : kLambert;
    h.id = mid;
    return true;
  }

  __device__ __forceinline__ bool occluded(float, float, float, float, float,
                                           float, float) const {
    return blocked;
  }

  __device__ __forceinline__ const float* light(int l) const {
    return lights + 7 * l;
  }
};

// K4's and K10's sink: one lane's share of one bounce's theta cotangent,
// kept in registers for its warp to sum (flush_scalars, flush_geometry)
// where the old sink added each value with a shared atomic of its own, so
// that the lanes of a warp, which meet on the few rows of the sky, a
// material and a light, waited on each other's addresses.  It keeps the
// sky's floats or the winner's material row (a bounce either misses or
// hits, never both), the light slot's 7 floats, and the winner's centre
// and radius; each row by its offset in the scalar vector (sky 6, then 8
// per material, then 7 per light slot, the blob's order from its sky on;
// -1: nothing).  A padding winner (id n_mats) gets nothing.
struct LaneSink {
  int n_mats;
  int row = -1;
  float v[8] = {};
  int light_row = -1;
  float lv[7] = {};
  bool geo = false;    // dgeo is the winner's own
  float dgeo[4] = {};

  __device__ __forceinline__ void sky(int i, float x) {
    row = 0;
    v[i] += x;
  }
  __device__ __forceinline__ void light(int l, V3 toc_b, float lrr_b,
                                        V3 le_b) {
    light_row = 6 + 8 * n_mats + 7 * l;
    lv[0] = toc_b.x;
    lv[1] = toc_b.y;
    lv[2] = toc_b.z;
    lv[3] = lrr_b;
    lv[4] = le_b.x;
    lv[5] = le_b.y;
    lv[6] = le_b.z;
  }
  __device__ __forceinline__ void hit(int m, V3 C_b, float r_b, V3 a_b,
                                      V3 e_b, float rough_b, float ior_b) {
    if (m >= n_mats) return;
    geo = true;
    dgeo[0] = C_b.x;
    dgeo[1] = C_b.y;
    dgeo[2] = C_b.z;
    dgeo[3] = r_b;
    row = 6 + 8 * m;
    v[0] = a_b.x;
    v[1] = a_b.y;
    v[2] = a_b.z;
    v[3] = e_b.x;
    v[4] = e_b.y;
    v[5] = e_b.z;
    v[6] = rough_b;
    v[7] = ior_b;
  }
};

// Sums x over each group of lanes that hold one key (peers: the lane's
// group, as __match_any_sync gives it) into the group's lowest lane, in
// log2(group size) rounds of one shuffle a value: each round every lane
// adds its next remaining peer's partial sum, then the lanes of odd rank
// drop out (E. Westphal's reduction of peers, NVIDIA developer blog, 2015).
// The other lanes' x end as partial sums.  Every lane of the warp calls it.
template <int N>
__device__ __forceinline__ void sum_peers(unsigned peers, float (&x)[N]) {
  const unsigned lane = threadIdx.x & 31u;
  unsigned rank = __popc(peers & ((1u << lane) - 1u));
  unsigned above = peers & (0xFFFFFFFEu << lane);
  while (__any_sync(kWarpMask, above != 0u)) {
    const int next = __ffs(above) - 1;       // -1: no peer left above
    const int from = next < 0 ? (int)lane : next;
    for (int a = 0; a < N; ++a) {
      const float t = __shfl_sync(kWarpMask, x[a], from);
      if (next >= 0) x[a] += t;
    }
    above &= ~__ballot_sync(kWarpMask, (rank & 1u) != 0u);
    rank >>= 1;
  }
}

// Whether this lane is the lowest of its peers.
__device__ __forceinline__ bool leads(unsigned peers) {
  return (int)(threadIdx.x & 31u) == __ffs(peers) - 1;
}

// One row of N floats of every lane of the warp, summed by the row's key
// (offset; -1: none), each sum added by one lane into g (the warp's copy
// of the scalar vector in shared memory) with an atomic a nonzero value.
template <int N>
__device__ __forceinline__ void flush_row(int key, const float (&x)[N],
                                          int n, float* g) {
  if (!__any_sync(kWarpMask, key >= 0)) return;
  float s[N];
  for (int a = 0; a < N; ++a) s[a] = x[a];
  const unsigned peers = __match_any_sync(kWarpMask, key);
  sum_peers(peers, s);
  if (key >= 0 && leads(peers))
    for (int a = 0; a < n; ++a)
      if (s[a] != 0.0f) atomicAdd(g + key + a, s[a]);
}

// The warp's lane sinks summed into g by row: sky, material and light rows.
__device__ __forceinline__ void flush_scalars(const LaneSink& sink,
                                              float* g) {
  flush_row(sink.row, sink.v, sink.row == 0 ? 6 : 8, g);
  flush_row(sink.light_row, sink.lv, 7, g);
}

// The warp's winners' centre and radius cotangents added into a prim
// table of rows of `block` floats: `key` the index of the winner's first
// row entry (-1: no winner of its own), attribute a at key + a * block.
// With kMerge the lanes of one winner are summed first and one lane adds
// (a sorted stream's neighbours, and a pixel tile's primary rays, share
// winners); else each lane adds its own.
template <bool kMerge>
__device__ __forceinline__ void flush_geometry(int key, const float (&d)[4],
                                               float* table, int block) {
  float s[4] = {d[0], d[1], d[2], d[3]};
  if constexpr (kMerge) {
    if (!__any_sync(kWarpMask, key >= 0)) return;
    const unsigned peers = __match_any_sync(kWarpMask, key);
    sum_peers(peers, s);
    if (!leads(peers)) return;
  }
  if (key < 0) return;
  for (int a = 0; a < 4; ++a)
    if (s[a] != 0.0f) atomicAdd(table + key + (size_t)a * block, s[a]);
}

// The copies of the scalar vector (n_scal floats) a block of `threads`
// keeps after `fixed` floats of shared memory: one a warp where they fit
// in the 48 KB a block gets without asking, else one.
inline int scalar_copies(int fixed, int n_scal, int threads) {
  const int warps = threads / 32;
  return sizeof(float) * (fixed + (size_t)warps * n_scal) <= 48 * 1024
             ? warps
             : 1;
}

// The block's copies of the scalar vector (n floats each) summed into
// out, one atomic a nonzero entry.
__device__ __forceinline__ void flush_block(const float* g, int copies, int n,
                                            float* out) {
  __syncthreads();
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    float v = 0.0f;
    for (int c = 0; c < copies; ++c) v += g[c * n + i];
    if (v != 0.0f) atomicAdd(out + i, v);
  }
}

// Reverse mode of trace_bounce for an active path p (its entry state) at
// bounce k, against geometry geo.  ct holds the cotangent of the 13 output
// channels (o, d, throughput, radiance, prev_pdf) and receives that of the
// entry channels.  theta's cotangent goes to sink: sky(i, v) for sky float
// i, light(l, ...) for light slot l's centre, radius and emission, hit(id,
// ...) for the winner's centre, radius and material row.
template <class Geometry, class Sink>
__device__ void bounce_vjp(const SceneView& sc, const Geometry& geo,
                           Sink& sink, const Path& p, uint32_t pid,
                           uint32_t sample, uint32_t seed, int k,
                           int rr_depth, bool use_nee, bool use_mis,
                           float* ct) {
  const uint32_t kdim = (uint32_t)(k * kNDims);
  const V3 o = {p.ox, p.oy, p.oz}, d = {p.dx, p.dy, p.dz};
  const V3 th = {p.th_r, p.th_g, p.th_b};
  const V3 o_o = {ct[0], ct[1], ct[2]}, d_o = {ct[3], ct[4], ct[5]};
  const V3 th_o = {ct[6], ct[7], ct[8]}, rad_o = {ct[9], ct[10], ct[11]};
  const float pdf_o = ct[12];
  const float* sky = sc.blob + 15;

  float t;
  Hit hit;
  if (!geo.nearest(p.ox, p.oy, p.oz, p.dx, p.dy, p.dz, t, hit)) {
    // Miss: the outputs pass through, radiance gains throughput * sky.
    V3 th_ct = th_o, d_ct = d_o;
    if (sc.sky_mode == kSkyGradient || sc.sky_mode == kSkyConstant) {
      V3 sk;
      sky_radiance(sc, p.dy, sk.x, sk.y, sk.z);
      th_ct += rad_o * sk;
      V3 sk_b = rad_o * th;
      if (sc.sky_mode == kSkyGradient) {
        float ts = 0.5f * (p.dy + 1.0f);
        sink.sky(0, sk_b.x * (1.0f - ts));
        sink.sky(1, sk_b.y * (1.0f - ts));
        sink.sky(2, sk_b.z * (1.0f - ts));
        sink.sky(3, sk_b.x * ts);
        sink.sky(4, sk_b.y * ts);
        sink.sky(5, sk_b.z * ts);
        float ts_b = sk_b.x * (sky[3] - sky[0]) + sk_b.y * (sky[4] - sky[1])
                     + sk_b.z * (sky[5] - sky[2]);
        d_ct.y += 0.5f * ts_b;
      } else {
        sink.sky(0, sk_b.x);
        sink.sky(1, sk_b.y);
        sink.sky(2, sk_b.z);
      }
    }
    ct[3] = d_ct.x; ct[4] = d_ct.y; ct[5] = d_ct.z;
    ct[6] = th_ct.x; ct[7] = th_ct.y; ct[8] = th_ct.z;
    return;
  }

  // ---- forward recompute: physics.cuh's expressions, kept ------------------
  const float* s = hit.mat;      // ar ag ab er eg eb rough ior
  const V3 C = {hit.cx, hit.cy, hit.cz};
  const float r = hit.r;
  const V3 alb = {s[0], s[1], s[2]}, emi = {s[3], s[4], s[5]};
  const int mtype = hit.mtype;
  const V3 h = {p.ox + t * p.dx, p.oy + t * p.dy, p.oz + t * p.dz};
  V3 ng = h - C;
  normalize3(ng.x, ng.y, ng.z);
  const V3 wo = -d;
  const float wo_ng = dot(wo, ng);
  const bool nee = use_nee && sc.n_light_slots > 0 && sc.nl > 0;
  const float nlf = fmaxf((float)sc.nl, 1.0f);
  const bool emitting = (emi.x + emi.y + emi.z) > 0.0f && wo_ng > 0.0f;
  const bool front = wo_ng > 0.0f;
  const float sgn = front ? 1.0f : -1.0f;
  const V3 ns = sgn * ng;
  const V3 zero3 = {0.0f, 0.0f, 0.0f};
  // The metal terms that do not depend on the sample (NEE reads them too).
  float alpha = 0.0f, a2g = 0.0f, kg = 0.0f, g1v = 0.0f, ndotv = 0.0f;
  if (mtype == kMetal) {
    alpha = fmaxf(s[6] * s[6], 1e-4f);
    a2g = alpha * alpha;
    ndotv = fmaxf(dot(ns, wo), 1e-6f);
    kg = alpha * 0.5f;
    g1v = ndotv / (ndotv * (1.0f - kg) + kg);
  }
  const bool spec_new = mtype == kDielectric;

  V3 h_nee = zero3, th_nee = zero3, ns_b = zero3, wo_b = zero3, a_b = zero3;
  float a2g_b = 0.0f, kg_b = 0.0f, g1v_b = 0.0f, ndotv_b = 0.0f;

  // ---- next-event estimation: recompute, then reverse ------------------------
  // Before the sample's recompute, so that none of the sample's terms is
  // live across it; it reads only the hit, the frame's normal and the metal
  // terms above, and sums into its own throughput and hit-point cotangents.
  if (nee && !spec_new) {
    uint32_t cell = (k == 0) ? lsel_cell(sc.lsb, h.x, h.y, h.z)
                             : lsel_cell(sc.lsb, p.ox, p.oy, p.oz);
    float ul = counter_uniform(cell, sample, kdim + kDimLsel, seed);
    int li = min((int)(ul * nlf), sc.nl - 1);
    int lslot = -1;
    V3 lc = zero3, le = zero3;
    float lrr = 0.0f;
    for (int l = 0; l < sc.n_light_slots; ++l) {
      if (li == l && l < sc.nl) {
        lslot = l;
        const float* ls = geo.light(l);
        constexpr int e = Geometry::kLightEmit;
        lc = {ls[0], ls[1], ls[2]};
        lrr = ls[3];
        le = {ls[e], ls[e + 1], ls[e + 2]};
      }
    }
    const float lu1 = counter_uniform(pid, sample, kdim + kDimLU1, seed);
    const float lu2 = counter_uniform(pid, sample, kdim + kDimLU2, seed);
    const V3 po = {h.x + kEps * ns.x, h.y + kEps * ns.y, h.z + kEps * ns.z};
    const V3 toc = lc - po;
    const float d2 = fmaxf(dot(toc, toc), 1e-12f);
    const float dist = sqrtf(d2);
    const bool inside_l = dist <= lrr;
    const float sin2m = clampf(lrr * lrr / d2, 0.0f, 1.0f);
    const bool degm = sin2m >= 1.0f;
    const float cosm_l = degm ? 0.0f : sqrtf(1.0f - sin2m);
    const float ctl = 1.0f - lu1 * (1.0f - cosm_l);
    const float stl = sqrtf(fmaxf(1.0f - ctl * ctl, 1e-12f));
    const float phil = kTwoPi * lu2;
    const V3 wl = {toc.x / dist, toc.y / dist, toc.z / dist};
    V3 lt, lb;
    onb(wl.x, wl.y, wl.z, lt.x, lt.y, lt.z, lb.x, lb.y, lb.z);
    const float cpl = cosf(phil), spl = sinf(phil);
    const V3 ld = {stl * cpl * lt.x + stl * spl * lb.x + ctl * wl.x,
                   stl * cpl * lt.y + stl * spl * lb.y + ctl * wl.y,
                   stl * cpl * lt.z + stl * spl * lb.z + ctl * wl.z};
    float pdf_l = 1.0f / fmaxf(kTwoPi * (1.0f - cosm_l), 1e-9f);
    pdf_l = pdf_l / nlf;
    const float bl = dot(ld, toc);
    const float cl = dot(toc, toc) - lrr * lrr;
    const float discl = fmaxf(bl * bl - cl, 0.0f);
    const float t_l = bl - sqrtf(fmaxf(discl, 1e-20f));
    const bool blocked =
        geo.occluded(po.x, po.y, po.z, ld.x, ld.y, ld.z, t_l - 1e-3f);
    const bool lit = !blocked && !inside_l && t_l > kTmin && pdf_l > 0.0f;
    if (lit) {
      const float ndotl = fmaxf(dot(ns, ld), 0.0f);
      V3 base = zero3, fm = zero3, hs = zero3, hh = zero3;
      float pdf_b, spec_e = 0.0f, ndoth_e = 0.0f, odoth_e = 0.0f;
      float dggx_e = 0.0f, ndotl_c = 0.0f, g1l_e = 0.0f, g_e = 0.0f;
      bool h_ok = false;
      if (mtype == kLambert) {
        base = {alb.x * kInvPi, alb.y * kInvPi, alb.z * kInvPi};
        pdf_b = ndotl * kInvPi;
      } else {
        hs = wo + ld;
        const float hlen2 = hs.x * hs.x + hs.y * hs.y + hs.z * hs.z;
        h_ok = hlen2 > 1e-12f;
        const float hinv = 1.0f / sqrtf(h_ok ? hlen2 : 1.0f);
        hh = {(h_ok ? hs.x : 0.0f) * hinv, (h_ok ? hs.y : 0.0f) * hinv,
              (h_ok ? hs.z : 0.0f) * hinv};
        ndoth_e = fmaxf(dot(ns, hh), 1e-6f);
        odoth_e = fmaxf(dot(wo, hh), 1e-6f);
        const float qe = ndoth_e * ndoth_e * (a2g - 1.0f) + 1.0f;
        dggx_e = a2g / fmaxf(kPi * (qe * qe), 1e-12f);
        ndotl_c = fmaxf(ndotl, 1e-6f);
        g1l_e = ndotl_c / (ndotl_c * (1.0f - kg) + kg);
        g_e = g1v * g1l_e;
        spec_e = h_ok ? dggx_e * g_e / (4.0f * ndotv * ndotl_c) : 0.0f;
        fm = {schlick1(odoth_e, alb.x), schlick1(odoth_e, alb.y),
              schlick1(odoth_e, alb.z)};
        base = spec_e * fm;
        pdf_b = h_ok ? dggx_e * ndoth_e / (4.0f * odoth_e) : 0.0f;
      }
      float w_nee = 1.0f;
      const float pl2 = pdf_l * pdf_l;
      if (use_mis) w_nee = pl2 / fmaxf(pl2 + pdf_b * pdf_b, 1e-20f);
      const float scale = w_nee / fmaxf(pdf_l, 1e-12f);
      const V3 fcos = ndotl * base;

      // Reverse: radiance += th * fcos * le * scale.
      th_nee = scale * (rad_o * fcos * le);
      const V3 fcos_b = scale * (rad_o * th * le);
      const V3 le_b = scale * (rad_o * th * fcos);
      const float scale_b = dot(rad_o * th * fcos, le);
      const float ml = fmaxf(pdf_l, 1e-12f);
      const float wnee_b = scale_b / ml;
      float pdfl_b = -scale_b * w_nee / (ml * ml) * dmax(pdf_l, 1e-12f);
      float pb_b = 0.0f;
      if (use_mis) {
        const float s2 = pl2 + pdf_b * pdf_b;
        const float den = fmaxf(s2, 1e-20f);
        const float den_b = -wnee_b * w_nee / den * dmax(s2, 1e-20f);
        pdfl_b += 2.0f * pdf_l * (wnee_b / den + den_b);
        pb_b = 2.0f * pdf_b * den_b;
      }
      const V3 base_b = ndotl * fcos_b;
      float ndotl_b = dot(fcos_b, base);
      V3 ld_b = zero3;
      if (mtype == kLambert) {
        ndotl_b += pb_b * kInvPi;
        a_b += kInvPi * base_b;
      } else {
        const float pbm_b = h_ok ? pb_b : 0.0f;
        const float spec_b = h_ok ? dot(base_b, fm) : 0.0f;
        float odothe_b = schlick_adj(odoth_e, alb, spec_e * base_b, a_b);
        float dggxe_b = pbm_b * ndoth_e / (4.0f * odoth_e);
        float ndothe_b = pbm_b * dggx_e / (4.0f * odoth_e);
        odothe_b -= pbm_b * pdf_b / odoth_e;
        const float den = 4.0f * ndotv * ndotl_c;
        dggxe_b += spec_b * g_e / den;
        const float ge_b = spec_b * dggx_e / den;
        const float den_b = -spec_b * spec_e / den;
        ndotv_b += den_b * 4.0f * ndotl_c;
        g1v_b += ge_b * g1l_e;
        float x_b = 0.0f;
        g1_adj(ndotl_c, kg, ge_b * g1v, x_b, kg_b);
        ndotl_b += (den_b * 4.0f * ndotv + x_b) * dmax(ndotl, 1e-6f);
        ggx_d_adj(ndoth_e, a2g, dggxe_b, ndothe_b, a2g_b);
        const float x = ndothe_b * dmax(dot(ns, hh), 1e-6f);
        const float y = odothe_b * dmax(dot(wo, hh), 1e-6f);
        ns_b += x * hh;
        const V3 hs_b =
            h_ok ? normalize_adj(hs, x * ns + y * wo, -1.0f) : zero3;
        wo_b += y * hh + hs_b;
        ld_b = hs_b;
      }
      const float xl = ndotl_b * dmax(dot(ns, ld), 0.0f);
      ns_b += xl * ld;
      ld_b += xl * ns;
      // The cone sample and its pdf, back to the light and the point.
      const float stl_b = cpl * dot(lt, ld_b) + spl * dot(lb, ld_b);
      const float ctl_b = dot(wl, ld_b) - 2.0f * ctl * sqrt_adj(stl, stl_b)
                          * dmax(1.0f - ctl * ctl, 1e-12f);
      const V3 wl_b = ctl * ld_b
                      + onb_adj(wl, (stl * cpl) * ld_b, (stl * spl) * ld_b);
      float lrr_b = 0.0f, d2_b = 0.0f;
      cone_adj(lrr, d2, cosm_l, degm, pdfl_b, ctl_b * lu1, nlf, lrr_b, d2_b);
      d2_b += sqrt_adj(dist, -dot(toc, wl_b) / (dist * dist));
      const V3 toc_b =
          (1.0f / dist) * wl_b + (2.0f * d2_b * dmax(dot(toc, toc), 1e-12f))
                                     * toc;
      h_nee = -toc_b;
      ns_b -= kEps * toc_b;
      if (lslot >= 0) sink.light(lslot, toc_b, lrr_b, le_b);
    }
  }

  // ---- the material's sample: recompute -------------------------------------
  V3 T, B;
  onb(ns.x, ns.y, ns.z, T.x, T.y, T.z, B.x, B.y, B.z);
  V3 nd = zero3, w = zero3, dl = zero3, hw = zero3, dm = zero3;
  V3 dt_raw = zero3;
  float pdf_new = 0.0f, off_sign = 1.0f;
  float u1 = 0.0f, cphi = 0.0f, sphi = 0.0f, st = 0.0f, ctv = 0.0f;
  float cos2h = 0.0f, cth = 0.0f, sth = 0.0f, odoth = 0.0f, ndoth = 0.0f;
  float ndotl_m = 0.0f, ndotl_mc = 0.0f, g1l = 0.0f, gterm = 0.0f;
  float wms = 0.0f, dggx = 0.0f;
  V3 f_met = {0.0f, 0.0f, 0.0f};
  float ior = 0.0f, eta = 0.0f, cos_i = 0.0f, sin2_t = 0.0f, cos_t = 0.0f;
  float safe = 0.0f, kk = 0.0f;
  bool dead = false, refl = false;
  if (mtype == kLambert || mtype == kMetal) {
    u1 = counter_uniform(pid, sample, kdim + kDimU1, seed);
    const float u2 = counter_uniform(pid, sample, kdim + kDimU2, seed);
    const float phi = kTwoPi * u2;
    cphi = cosf(phi);
    sphi = sinf(phi);
    if (mtype == kLambert) {
      ctv = sqrtf(u1);
      st = sqrtf(fmaxf(0.0f, 1.0f - u1));
      dl = {st * cphi * T.x + st * sphi * B.x + ctv * ns.x,
            st * cphi * T.y + st * sphi * B.y + ctv * ns.y,
            st * cphi * T.z + st * sphi * B.z + ctv * ns.z};
      nd = dl;
      pdf_new = fmaxf(dot(ns, dl), 0.0f) * kInvPi;
      w = alb;
    } else {
      cos2h = (1.0f - u1) / (1.0f + (a2g - 1.0f) * u1);
      cth = sqrtf(fmaxf(cos2h, 0.0f));
      sth = sqrtf(fmaxf(1.0f - cos2h, 1e-12f));
      hw = {sth * cphi * T.x + sth * sphi * B.x + cth * ns.x,
            sth * cphi * T.y + sth * sphi * B.y + cth * ns.y,
            sth * cphi * T.z + sth * sphi * B.z + cth * ns.z};
      odoth = fmaxf(dot(wo, hw), 1e-6f);
      dm = {2.0f * odoth * hw.x - wo.x, 2.0f * odoth * hw.y - wo.y,
            2.0f * odoth * hw.z - wo.z};
      nd = dm;
      ndotl_m = dot(ns, dm);
      ndoth = fmaxf(dot(ns, hw), 1e-6f);
      ndotl_mc = fmaxf(ndotl_m, 1e-6f);
      g1l = ndotl_mc / (ndotl_mc * (1.0f - kg) + kg);
      gterm = g1v * g1l;
      const bool met_ok = ndotl_m > 1e-6f;
      wms = met_ok ? gterm * odoth / (ndotv * ndoth) : 0.0f;
      f_met = {schlick1(odoth, alb.x), schlick1(odoth, alb.y),
               schlick1(odoth, alb.z)};
      w = wms * f_met;
      const float q = ndoth * ndoth * (a2g - 1.0f) + 1.0f;
      dggx = a2g / fmaxf(kPi * (q * q), 1e-12f);
      pdf_new = dggx * ndoth / (4.0f * odoth);
      dead = !met_ok;
    }
  } else {
    const float u_lobe = counter_uniform(pid, sample, kdim + kDimLobe, seed);
    ior = fmaxf(s[7], 1.001f);
    eta = front ? 1.0f / ior : ior;
    cos_i = fmaxf(dot(wo, ns), 1e-6f);
    const float f_die = fresnel_dielectric(cos_i, 1.0f / eta);
    sin2_t = eta * eta * fmaxf(0.0f, 1.0f - cos_i * cos_i);
    const bool tir = sin2_t >= 1.0f;
    refl = (u_lobe < f_die) || tir;
    if (refl) {
      nd = {2.0f * cos_i * ns.x - wo.x, 2.0f * cos_i * ns.y - wo.y,
            2.0f * cos_i * ns.z - wo.z};
      w = {1.0f, 1.0f, 1.0f};
    } else {
      safe = 1.0f - sin2_t;
      cos_t = sqrtf(fmaxf(safe, 1e-12f));
      kk = eta * cos_i - cos_t;
      dt_raw = {eta * (-wo.x) + kk * ns.x, eta * (-wo.y) + kk * ns.y,
                eta * (-wo.z) + kk * ns.z};
      nd = dt_raw;
      normalize3(nd.x, nd.y, nd.z);
      w = alb;
      off_sign = -1.0f;
    }
  }
  V3 thn = th * w;
  bool active_n = !dead;
  float p_cont = 1.0f;
  if (k >= rr_depth) {
    p_cont = clampf(fmaxf(thn.x, fmaxf(thn.y, thn.z)), 0.05f, 0.95f);
    const float u_rr = counter_uniform(pid, sample, kdim + kDimRR, seed);
    active_n = active_n && !(u_rr > p_cont);
  }

  // ---- reverse: the outputs ------------------------------------------------
  V3 o_ct = o_o, d_ct = d_o, th_ct = th_o;
  float pdf_ct = pdf_o;
  V3 h_b = h_nee, nd_b = zero3, thn_b = zero3;
  float pdfn_b = 0.0f;
  if (active_n) {
    o_ct = d_ct = th_ct = zero3;
    pdf_ct = 0.0f;
    h_b = o_o + h_nee;
    ns_b += (kEps * off_sign) * o_o;
    nd_b = d_o;
    thn_b = th_o;
    pdfn_b = pdf_o;
    if (k >= rr_depth) {
      const float inv_p = 1.0f / p_cont;
      const float p_b = -dot(thn_b, thn) / (p_cont * p_cont);
      thn_b = inv_p * thn_b;
      const float m1 = fmaxf(thn.y, thn.z);
      const float m0_b = p_b * dclip(fmaxf(thn.x, m1), 0.05f, 0.95f);
      const float m1_b = m0_b * dmax(m1, thn.x);
      thn_b += V3{m0_b * dmax(thn.x, m1), m1_b * dmax(thn.y, thn.z),
                  m1_b * dmax(thn.z, thn.y)};
    }
  }
  th_ct += thn_b * w;
  th_ct += th_nee;
  const V3 w_b = thn_b * th;

  V3 T_b = zero3, B_b = zero3, C_b = zero3, e_b = zero3;
  float r_b = 0.0f, rough_b = 0.0f, ior_b = 0.0f;

  // ---- the material's sample, in reverse -------------------------------------
  if (mtype == kLambert) {
    const float x = pdfn_b * kInvPi * dmax(dot(ns, dl), 0.0f);
    a_b += w_b;
    const V3 dl_b = nd_b + x * ns;
    ns_b += x * dl + ctv * dl_b;
    T_b += (st * cphi) * dl_b;
    B_b += (st * sphi) * dl_b;
  } else if (mtype == kMetal) {
    const float wms_b = ndotl_m > 1e-6f ? dot(w_b, f_met) : 0.0f;
    const float den = ndotv * ndoth;
    const float gterm_b = wms_b * odoth / den;
    float odoth_b = wms_b * gterm / den;
    const float den_b = -wms_b * wms / den;
    ndotv_b += den_b * ndoth;
    float ndoth_b = den_b * ndotv;
    odoth_b += schlick_adj(odoth, alb, wms * w_b, a_b);
    ndoth_b += pdfn_b * dggx / (4.0f * odoth);
    ggx_d_adj(ndoth, a2g, pdfn_b * ndoth / (4.0f * odoth), ndoth_b, a2g_b);
    odoth_b -= pdfn_b * pdf_new / odoth;
    g1v_b += gterm_b * g1l;
    float x_b = 0.0f;
    g1_adj(ndotl_mc, kg, gterm_b * g1v, x_b, kg_b);
    const float ndotlm_b = x_b * dmax(ndotl_m, 1e-6f);
    g1_adj(ndotv, kg, g1v_b, ndotv_b, kg_b);
    ns_b += ndotlm_b * dm;
    const V3 dm_b = nd_b + ndotlm_b * ns;
    odoth_b += 2.0f * dot(hw, dm_b);
    const float x = ndotv_b * dmax(dot(ns, wo), 1e-6f);
    const float y = ndoth_b * dmax(dot(ns, hw), 1e-6f);
    const float z = odoth_b * dmax(dot(wo, hw), 1e-6f);
    ns_b += x * wo + y * hw;
    wo_b += x * ns + z * hw - dm_b;
    const V3 hw_b = (2.0f * odoth) * dm_b + y * ns + z * wo;
    const float sth_b = cphi * dot(T, hw_b) + sphi * dot(B, hw_b);
    T_b += (sth * cphi) * hw_b;
    B_b += (sth * sphi) * hw_b;
    ns_b += cth * hw_b;
    const float cos2h_b =
        (cth > 0.0f ? sqrt_adj(cth, dot(ns, hw_b)) : 0.0f) * dmax(cos2h, 0.0f)
        - sqrt_adj(sth, sth_b) * dmax(1.0f - cos2h, 1e-12f);
    a2g_b -= cos2h_b * cos2h / (1.0f + (a2g - 1.0f) * u1) * u1;
    const float alpha_b = 0.5f * kg_b + 2.0f * alpha * a2g_b;
    rough_b = alpha_b * 2.0f * s[6] * dmax(s[6] * s[6], 1e-4f);
  } else {
    float cosi_b = 0.0f;
    if (refl) {
      cosi_b = 2.0f * dot(ns, nd_b);
      ns_b += (2.0f * cos_i) * nd_b;
      wo_b -= nd_b;
    } else {
      a_b += w_b;
      const V3 dtr_b = normalize_adj(dt_raw, nd_b, 1e-20f);
      const float kk_b = dot(ns, dtr_b);
      const float sin2t_b = sqrt_adj(cos_t, kk_b) * dmax(safe, 1e-12f);
      const float mm_arg = 1.0f - cos_i * cos_i;
      const float eta_b = -dot(wo, dtr_b) + cos_i * kk_b
                          + sin2t_b * fmaxf(mm_arg, 0.0f) * 2.0f * eta;
      cosi_b = eta * kk_b
               - 2.0f * cos_i * (sin2t_b * eta * eta) * dmax(mm_arg, 0.0f);
      ior_b = (front ? -eta_b / (ior * ior) : eta_b) * dmax(s[7], 1.001f);
      ns_b += kk * dtr_b;
      wo_b -= eta * dtr_b;
    }
    const float x = cosi_b * dmax(dot(wo, ns), 1e-6f);
    ns_b += x * wo;
    wo_b += x * ns;
  }

  // ---- the shading frame -----------------------------------------------------
  ns_b += onb_adj(ns, T_b, B_b);

  // ---- emission, MIS-weighted against the last light sample ------------------
  if (emitting) {
    float w_emit = 1.0f;
    if (nee && !p.prev_spec) {
      if (use_mis) {
        const V3 toc = C - o;
        const float d2 = fmaxf(dot(toc, toc), 1e-12f);
        const float sin2 = clampf(r * r / d2, 0.0f, 1.0f);
        const bool deg = sin2 >= 1.0f;
        const float cosm = deg ? 0.0f : sqrtf(1.0f - sin2);
        float pdf_lh = 1.0f / fmaxf(kTwoPi * (1.0f - cosm), 1e-9f);
        pdf_lh = pdf_lh / nlf;
        const float pp2 = p.prev_pdf * p.prev_pdf;
        const float s2 = pp2 + pdf_lh * pdf_lh;
        const float den = fmaxf(s2, 1e-20f);
        w_emit = pp2 / den;
        const float wb_b = dot(rad_o * th, emi);
        const float den_b = -wb_b * w_emit / den * dmax(s2, 1e-20f);
        pdf_ct += 2.0f * p.prev_pdf * (wb_b / den + den_b);
        float d2_b = 0.0f;
        cone_adj(r, d2, cosm, deg, 2.0f * pdf_lh * den_b, 0.0f, nlf, r_b, d2_b);
        const V3 toc_b = (2.0f * d2_b * dmax(dot(toc, toc), 1e-12f)) * toc;
        C_b += toc_b;
        o_ct -= toc_b;
      } else {
        w_emit = 0.0f;
      }
    }
    th_ct += w_emit * (rad_o * emi);
    e_b = w_emit * (rad_o * th);
  }

  // ---- normal, hit point, and the winner's distance ----------------------------
  const V3 v_b = normalize_adj(h - C, sgn * ns_b, 1e-20f);
  h_b += v_b;
  C_b -= v_b;
  d_ct -= wo_b;
  const float t_b = dot(h_b, d);
  o_ct += h_b;
  d_ct += t * h_b;
  const V3 oc = C - o;
  const float b = dot(d, oc);
  const float disc = b * b - (dot(oc, oc) - r * r);
  const float sq = sqrtf(fmaxf(disc, 1e-12f));
  const float disc_b = sqrt_adj(sq, (b - sq > kTmin ? -1.0f : 1.0f) * t_b)
                       * dmax(disc, 1e-12f);
  const float b_b = t_b + 2.0f * b * disc_b;
  const V3 oc_b = (-2.0f * disc_b) * oc + b_b * d;
  r_b += 2.0f * r * disc_b;
  d_ct += b_b * oc;
  C_b += oc_b;
  o_ct -= oc_b;

  // ---- theta: the winner's row -----------------------------------------------
  sink.hit(hit.id, C_b, r_b, a_b, e_b, rough_b, ior_b);

  ct[0] = o_ct.x; ct[1] = o_ct.y; ct[2] = o_ct.z;
  ct[3] = d_ct.x; ct[4] = d_ct.y; ct[5] = d_ct.z;
  ct[6] = th_ct.x; ct[7] = th_ct.y; ct[8] = th_ct.z;
  ct[12] = pdf_ct;
}

}  // namespace spt
