// One bounce of the forward path tracer for one ray, as __device__ code.
//
// The per-thread form of spt_tpu_torch/kernels/physics.py::trace_bounce
// (itself the port of spt_tpu/kernels/physics.py).  Every float expression
// keeps that code's operation order and float32 constants, and the library
// is built with --fmad=false, so kernel and plain version round alike.
// Where the plain version evaluates every material branch and selects, this
// code takes the one branch the hit's material needs; the selected values
// are the same.  trace_bounce takes its geometry (nearest hit, shadow test,
// light slots) as a template parameter: SphereList for K1 and K2, the BVH
// walk for K3 (megakernel_bvh.cu).
#pragma once

#include <cstdint>

#include "rng.cuh"

namespace spt {

constexpr unsigned kWarpMask = 0xFFFFFFFFu;   // every lane of a warp

// float32 roundings of the constants the JAX package folds.
constexpr float kTmin = 1e-3f;
constexpr float kEps = 1e-4f;
constexpr float kBig = 1e30f;
constexpr float kTwoPi = 6.28318548e+00f;    // f32(2*pi)
constexpr float kPi = 3.14159274e+00f;       // f32(pi)
constexpr float kInvPi = 3.18309873e-01f;    // f32(1/pi)

constexpr int kNDims = 8;
constexpr int kDimRR = 0, kDimU1 = 1, kDimU2 = 2, kDimLsel = 3, kDimLU1 = 4,
              kDimLU2 = 5, kDimLobe = 6;
constexpr int kLselCells = 16;

constexpr int kSphOff = 21;      // blob: camera 15, sky 6, then spheres
constexpr int kSphStride = 12;   // cx cy cz r ar ag ab er eg eb rough ior
constexpr int kMetaFixed = 3;    // meta: start_sample, seed, n_lights

constexpr int kLambert = 0, kMetal = 1, kDielectric = 2;
// A winner with no material of its own: a leaf's padding slot (material id
// -1) as the fused wavefront bounce resolves it (K11), after the JAX
// package's loop over the material table, which matches no type: it
// scatters as a dielectric of albedo 0 and ior 1.5 would, but stays
// non-specular (its shadow ray is traced, adds nothing), and leaves
// outward, never offset inward.
constexpr int kNoMaterial = 3;
constexpr int kSkyGradient = 1, kSkyConstant = 2;

// Scene uniforms, in shared memory.
struct SceneView {
  const float* blob;
  const int* meta;
  const float* lsb;     // light-cell grid: lo3, ext3
  int n_prims;
  int n_light_slots;
  int nl;               // live light count
  int sky_mode;
};

struct Path {
  float ox, oy, oz, dx, dy, dz;
  float th_r, th_g, th_b;
  float rad_r, rad_g, rad_b;
  float prev_pdf;
  bool active, prev_spec;
};

__device__ __forceinline__ float dot3(float ax, float ay, float az, float bx,
                                      float by, float bz) {
  return ax * bx + ay * by + az * bz;
}

__device__ __forceinline__ void normalize3(float& x, float& y, float& z) {
  float inv = 1.0f / sqrtf(fmaxf(x * x + y * y + z * z, 1e-20f));
  x = x * inv;
  y = y * inv;
  z = z * inv;
}

// Reference ONB: up = +z unless |n.z| >= 0.999, else +x.
__device__ __forceinline__ void onb(float nx, float ny, float nz, float& tx,
                                    float& ty, float& tz, float& bx, float& by,
                                    float& bz) {
  bool use_z = fabsf(nz) < 0.999f;
  float ux = use_z ? 0.0f : 1.0f, uy = 0.0f, uz = use_z ? 1.0f : 0.0f;
  tx = uy * nz - uz * ny;
  ty = uz * nx - ux * nz;
  tz = ux * ny - uy * nx;
  normalize3(tx, ty, tz);
  bx = ny * tz - nz * ty;
  by = nz * tx - nx * tz;
  bz = nx * ty - ny * tx;
}

__device__ __forceinline__ float clampf(float x, float lo, float hi) {
  return fminf(fmaxf(x, lo), hi);
}

__device__ __forceinline__ float schlick1(float cos_i, float f0) {
  float m = clampf(1.0f - cos_i, 0.0f, 1.0f);
  float m2 = m * m;
  return f0 + (1.0f - f0) * m2 * m2 * m;
}

__device__ __forceinline__ float fresnel_dielectric(float cos_i, float eta_ti) {
  cos_i = clampf(cos_i, 0.0f, 1.0f);
  float sin2_t = (1.0f / (eta_ti * eta_ti)) * fmaxf(0.0f, 1.0f - cos_i * cos_i);
  if (sin2_t >= 1.0f) return 1.0f;
  float cos_t = sqrtf(fmaxf(1.0f - sin2_t, 1e-12f));
  float rs = (cos_i - eta_ti * cos_t) / fmaxf(cos_i + eta_ti * cos_t, 1e-8f);
  float rp = (eta_ti * cos_i - cos_t) / fmaxf(eta_ti * cos_i + cos_t, 1e-8f);
  return 0.5f * (rs * rs + rp * rp);
}

// Entry distance tj along (o, d) into the sphere (c, r); false if the ray
// misses it or tj <= kTmin.
__device__ __forceinline__ bool sphere_t4(float cx, float cy, float cz,
                                          float r, float ox, float oy,
                                          float oz, float dx, float dy,
                                          float dz, float& tj) {
  float ocx = cx - ox, ocy = cy - oy, ocz = cz - oz;
  float b = dot3(dx, dy, dz, ocx, ocy, ocz);
  float c = dot3(ocx, ocy, ocz, ocx, ocy, ocz) - r * r;
  float disc = b * b - c;
  if (!(disc > 0.0f)) return false;
  float sq = sqrtf(fmaxf(disc, 1e-12f));
  float t0 = b - sq;
  float t1 = b + sq;
  tj = (t0 > kTmin) ? t0 : t1;
  return tj > kTmin;
}

// The same for sphere row s (cx cy cz r ...).
__device__ __forceinline__ bool sphere_t(const float* s, float ox, float oy,
                                         float oz, float dx, float dy, float dz,
                                         float& tj) {
  return sphere_t4(s[0], s[1], s[2], s[3], ox, oy, oz, dx, dy, dz, tj);
}

// Nearest sphere; strict '<' so ties go to the lowest index.  -1 on a miss.
__device__ __forceinline__ int intersect(const SceneView& sc, float ox, float oy,
                                         float oz, float dx, float dy, float dz,
                                         float& t_best) {
  t_best = kBig;
  int j_best = -1;
  for (int j = 0; j < sc.n_prims; ++j) {
    float tj;
    if (sphere_t(sc.blob + kSphOff + kSphStride * j, ox, oy, oz, dx, dy, dz, tj)
        && tj < t_best) {
      t_best = tj;
      j_best = j;
    }
  }
  return j_best;
}

// Any sphere between TMIN and tmax.  Tests every sphere, as the plain
// version does.
__device__ __forceinline__ bool occluded(const SceneView& sc, float ox, float oy,
                                         float oz, float dx, float dy, float dz,
                                         float tmax) {
  bool blocked = false;
  for (int j = 0; j < sc.n_prims; ++j) {
    float tj;
    if (sphere_t(sc.blob + kSphOff + kSphStride * j, ox, oy, oz, dx, dy, dz, tj)
        && tj < tmax)
      blocked = true;
  }
  return blocked;
}

// A bounce's nearest hit, as a geometry reports it: the sphere's centre and
// radius, its material row (ar ag ab er eg eb rough ior) and type, and the
// row's id where the adjoint adds its gradient (SphereList: the sphere's
// index; a recorded winner: its material's).
struct Hit {
  float cx, cy, cz, r;
  const float* mat;
  int mtype;
  int id;
};

// The geometry of K1 and K2: every sphere row of the blob, tested in index
// order.  A geometry gives trace_bounce its nearest hit, its shadow test
// and the light slots (cx cy cz r at 0..3, emission at kLightEmit..+2).
struct SphereList {
  static constexpr int kLightEmit = 7;
  const SceneView& sc;

  __device__ __forceinline__ bool nearest(float ox, float oy, float oz,
                                          float dx, float dy, float dz,
                                          float& t, Hit& h) const {
    const int j = intersect(sc, ox, oy, oz, dx, dy, dz, t);
    if (j < 0) return false;
    const float* s = sc.blob + kSphOff + kSphStride * j;
    h.cx = s[0];
    h.cy = s[1];
    h.cz = s[2];
    h.r = s[3];
    h.mat = s + 4;
    h.mtype = sc.meta[kMetaFixed + j];
    h.id = j;
    return true;
  }

  __device__ __forceinline__ bool occluded(float ox, float oy, float oz,
                                           float dx, float dy, float dz,
                                           float tmax) const {
    return spt::occluded(sc, ox, oy, oz, dx, dy, dz, tmax);
  }

  __device__ __forceinline__ const float* light(int l) const {
    return sc.blob + kSphOff +
           kSphStride * sc.meta[kMetaFixed + sc.n_prims + l];
  }
};

// Quantized shading-point cell: the light pick's stream key.
__device__ __forceinline__ uint32_t lsel_cell(const float* lsb, float hx,
                                              float hy, float hz) {
  const float h[3] = {hx, hy, hz};
  int cell = 0;
  for (int a = 0; a < 3; ++a) {
    float scale = (float)kLselCells / lsb[3 + a];
    int q = (int)clampf((h[a] - lsb[a]) * scale, 0.0f, kLselCells - 1.0f);
    cell = a == 0 ? q : cell * kLselCells + q;
  }
  return (uint32_t)cell;
}

__device__ __forceinline__ void sky_radiance(const SceneView& sc, float dy,
                                             float& r, float& g, float& b) {
  const float* sky = sc.blob + 15;
  if (sc.sky_mode == kSkyGradient) {
    float t = 0.5f * (dy + 1.0f);
    r = sky[0] * (1.0f - t) + sky[3] * t;
    g = sky[1] * (1.0f - t) + sky[4] * t;
    b = sky[2] * (1.0f - t) + sky[5] * t;
  } else if (sc.sky_mode == kSkyConstant) {
    r = sky[0];
    g = sky[1];
    b = sky[2];
  } else {
    r = g = b = 0.0f;
  }
}

// Whether a geometry can report kNoMaterial hits: its kNoMaterialHits,
// false where it declares none.  Only then does trace_bounce compile the
// two tests such a hit needs, so the other geometries' code is unchanged.
template <class G, class = void>
struct NoMaterialHits {
  static constexpr bool value = false;
};
template <class G>
struct NoMaterialHits<G, decltype(void(G::kNoMaterialHits))> {
  static constexpr bool value = G::kNoMaterialHits;
};

// One bounce of an active path against geometry geo (SphereList, K3's BVH
// walk or K7's rebuilt winner).  Leaves p.active false when the path ends.
// Returns whether the path missed every sphere this bounce: the plain
// version's want_miss flag, which the wavefront turns into environment-map
// radiance between its kernels (K1-K3 drop it).
template <class Geometry>
__device__ bool trace_bounce(const SceneView& sc, const Geometry& geo, Path& p,
                             uint32_t pid, uint32_t sample, uint32_t seed,
                             int k, int rr_depth, bool use_nee, bool use_mis) {
  const uint32_t kdim = (uint32_t)(k * kNDims);
  float t;
  Hit hit;
  if (!geo.nearest(p.ox, p.oy, p.oz, p.dx, p.dy, p.dz, t, hit)) {
    float sr, sg, sb;
    sky_radiance(sc, p.dy, sr, sg, sb);
    p.rad_r = p.rad_r + p.th_r * sr;
    p.rad_g = p.rad_g + p.th_g * sg;
    p.rad_b = p.rad_b + p.th_b * sb;
    p.active = false;
    return true;
  }
  const float* mat = hit.mat;
  const float cx = hit.cx, cy = hit.cy, cz = hit.cz, cr = hit.r;
  const float ar = mat[0], ag = mat[1], ab = mat[2];
  const float er = mat[3], eg = mat[4], eb = mat[5];
  const int mtype = hit.mtype;

  float hx = p.ox + t * p.dx;
  float hy = p.oy + t * p.dy;
  float hz = p.oz + t * p.dz;
  float ngx = hx - cx, ngy = hy - cy, ngz = hz - cz;
  normalize3(ngx, ngy, ngz);
  float wox = -p.dx, woy = -p.dy, woz = -p.dz;
  float wo_ng = dot3(wox, woy, woz, ngx, ngy, ngz);

  // Emission, MIS-weighted against the light sample of the last vertex.
  const bool nee = use_nee && sc.n_light_slots > 0;
  const float nlf = fmaxf((float)sc.nl, 1.0f);
  if ((er + eg + eb) > 0.0f && wo_ng > 0.0f) {
    float w_emit = 1.0f;
    if (nee && sc.nl > 0 && !p.prev_spec) {
      if (use_mis) {
        float tocx = cx - p.ox, tocy = cy - p.oy, tocz = cz - p.oz;
        float d2 = fmaxf(dot3(tocx, tocy, tocz, tocx, tocy, tocz), 1e-12f);
        float sin2 = clampf(cr * cr / d2, 0.0f, 1.0f);
        float cosm = sin2 >= 1.0f ? 0.0f : sqrtf(1.0f - sin2);
        float pdf_lh = 1.0f / fmaxf(kTwoPi * (1.0f - cosm), 1e-9f);
        pdf_lh = pdf_lh / nlf;
        float pp2 = p.prev_pdf * p.prev_pdf;
        w_emit = pp2 / fmaxf(pp2 + pdf_lh * pdf_lh, 1e-20f);
      } else {
        w_emit = 0.0f;
      }
    }
    p.rad_r = p.rad_r + p.th_r * er * w_emit;
    p.rad_g = p.rad_g + p.th_g * eg * w_emit;
    p.rad_b = p.rad_b + p.th_b * eb * w_emit;
  }

  const bool front = wo_ng > 0.0f;
  const float sgn = front ? 1.0f : -1.0f;
  const float nsx = ngx * sgn, nsy = ngy * sgn, nsz = ngz * sgn;
  float tx, ty, tz, bx, by, bz;
  onb(nsx, nsy, nsz, tx, ty, tz, bx, by, bz);

  // BSDF sample of the hit's material.
  float nd_x, nd_y, nd_z, w_r, w_g, w_b, pdf_new, off_sign = 1.0f;
  bool dead = false;
  const bool spec_new = mtype == kDielectric;
  float alpha = 0.0f, a2g = 0.0f, kg = 0.0f, g1v = 0.0f, ndotv = 0.0f;
  if (mtype == kLambert || mtype == kMetal) {
    const float u1 = counter_uniform(pid, sample, kdim + kDimU1, seed);
    const float u2 = counter_uniform(pid, sample, kdim + kDimU2, seed);
    const float phi = kTwoPi * u2;
    const float cphi = cosf(phi), sphi = sinf(phi);
    if (mtype == kLambert) {
      float ct = sqrtf(u1);
      float st = sqrtf(fmaxf(0.0f, 1.0f - u1));
      nd_x = st * cphi * tx + st * sphi * bx + ct * nsx;
      nd_y = st * cphi * ty + st * sphi * by + ct * nsy;
      nd_z = st * cphi * tz + st * sphi * bz + ct * nsz;
      pdf_new = fmaxf(dot3(nsx, nsy, nsz, nd_x, nd_y, nd_z), 0.0f) * kInvPi;
      w_r = ar;
      w_g = ag;
      w_b = ab;
    } else {
      const float rough = mat[6];
      alpha = fmaxf(rough * rough, 1e-4f);
      a2g = alpha * alpha;
      float cos2h = (1.0f - u1) / (1.0f + (a2g - 1.0f) * u1);
      float cth = sqrtf(fmaxf(cos2h, 0.0f));
      float sth = sqrtf(fmaxf(1.0f - cos2h, 1e-12f));
      float hwx = sth * cphi * tx + sth * sphi * bx + cth * nsx;
      float hwy = sth * cphi * ty + sth * sphi * by + cth * nsy;
      float hwz = sth * cphi * tz + sth * sphi * bz + cth * nsz;
      float odoth = fmaxf(dot3(wox, woy, woz, hwx, hwy, hwz), 1e-6f);
      nd_x = 2.0f * odoth * hwx - wox;
      nd_y = 2.0f * odoth * hwy - woy;
      nd_z = 2.0f * odoth * hwz - woz;
      float ndotl_m = dot3(nsx, nsy, nsz, nd_x, nd_y, nd_z);
      ndotv = fmaxf(dot3(nsx, nsy, nsz, wox, woy, woz), 1e-6f);
      float ndoth = fmaxf(dot3(nsx, nsy, nsz, hwx, hwy, hwz), 1e-6f);
      kg = alpha * 0.5f;
      g1v = ndotv / (ndotv * (1.0f - kg) + kg);
      float ndotl_mc = fmaxf(ndotl_m, 1e-6f);
      float g1l = ndotl_mc / (ndotl_mc * (1.0f - kg) + kg);
      float gterm = g1v * g1l;
      bool met_ok = ndotl_m > 1e-6f;
      float w_met_scale = met_ok ? gterm * odoth / (ndotv * ndoth) : 0.0f;
      w_r = schlick1(odoth, ar) * w_met_scale;
      w_g = schlick1(odoth, ag) * w_met_scale;
      w_b = schlick1(odoth, ab) * w_met_scale;
      float q = ndoth * ndoth * (a2g - 1.0f) + 1.0f;
      float dggx = a2g / fmaxf(kPi * (q * q), 1e-12f);
      pdf_new = dggx * ndoth / (4.0f * odoth);
      dead = !met_ok;
    }
  } else {
    const float u_lobe = counter_uniform(pid, sample, kdim + kDimLobe, seed);
    float ior = fmaxf(mat[7], 1.001f);
    float eta = front ? 1.0f / ior : ior;
    float cos_i = fmaxf(dot3(wox, woy, woz, nsx, nsy, nsz), 1e-6f);
    float f_die = fresnel_dielectric(cos_i, 1.0f / eta);
    float sin2_t = eta * eta * fmaxf(0.0f, 1.0f - cos_i * cos_i);
    bool tir = sin2_t >= 1.0f;
    bool refl = (u_lobe < f_die) || tir;
    if (refl) {
      nd_x = 2.0f * cos_i * nsx - wox;
      nd_y = 2.0f * cos_i * nsy - woy;
      nd_z = 2.0f * cos_i * nsz - woz;
      w_r = w_g = w_b = 1.0f;
    } else {
      float cos_t = sqrtf(fmaxf(1.0f - sin2_t, 1e-12f));
      nd_x = eta * (-wox) + (eta * cos_i - cos_t) * nsx;
      nd_y = eta * (-woy) + (eta * cos_i - cos_t) * nsy;
      nd_z = eta * (-woz) + (eta * cos_i - cos_t) * nsz;
      normalize3(nd_x, nd_y, nd_z);
      w_r = ar;
      w_g = ag;
      w_b = ab;
      if constexpr (NoMaterialHits<Geometry>::value) {
        if (mtype == kDielectric) off_sign = -1.0f;
      } else {
        off_sign = -1.0f;
      }
    }
    pdf_new = 0.0f;
  }

  // Next-event estimation: one light picked by the shading cell, one
  // sphere-cone sample, one shadow ray.  Skipped on a dielectric hit, where
  // it adds nothing.
  if (nee && sc.nl > 0 && !spec_new) {
    uint32_t cell = (k == 0) ? lsel_cell(sc.lsb, hx, hy, hz)
                             : lsel_cell(sc.lsb, p.ox, p.oy, p.oz);
    float ul = counter_uniform(cell, sample, kdim + kDimLsel, seed);
    int li = min((int)(ul * nlf), sc.nl - 1);
    float lcx = 0.0f, lcy = 0.0f, lcz = 0.0f, lrr = 0.0f;
    float ler = 0.0f, leg = 0.0f, leb = 0.0f;
    for (int l = 0; l < sc.n_light_slots; ++l) {
      if (li == l && l < sc.nl) {
        const float* ls = geo.light(l);
        constexpr int e = Geometry::kLightEmit;
        lcx = ls[0]; lcy = ls[1]; lcz = ls[2]; lrr = ls[3];
        ler = ls[e]; leg = ls[e + 1]; leb = ls[e + 2];
      }
    }
    const float lu1 = counter_uniform(pid, sample, kdim + kDimLU1, seed);
    const float lu2 = counter_uniform(pid, sample, kdim + kDimLU2, seed);
    float pox = hx + kEps * nsx;
    float poy = hy + kEps * nsy;
    float poz = hz + kEps * nsz;
    float tocx = lcx - pox, tocy = lcy - poy, tocz = lcz - poz;
    float d2 = fmaxf(dot3(tocx, tocy, tocz, tocx, tocy, tocz), 1e-12f);
    float dist = sqrtf(d2);
    bool inside_l = dist <= lrr;
    float sin2m = clampf(lrr * lrr / d2, 0.0f, 1.0f);
    float cosm_l = sin2m >= 1.0f ? 0.0f : sqrtf(1.0f - sin2m);
    float ctl = 1.0f - lu1 * (1.0f - cosm_l);
    float stl = sqrtf(fmaxf(1.0f - ctl * ctl, 1e-12f));
    float phil = kTwoPi * lu2;
    float wlx = tocx / dist, wly = tocy / dist, wlz = tocz / dist;
    float ltx, lty, ltz, lbx, lby, lbz;
    onb(wlx, wly, wlz, ltx, lty, ltz, lbx, lby, lbz);
    float cpl = cosf(phil), spl = sinf(phil);
    float ldx = stl * cpl * ltx + stl * spl * lbx + ctl * wlx;
    float ldy = stl * cpl * lty + stl * spl * lby + ctl * wly;
    float ldz = stl * cpl * ltz + stl * spl * lbz + ctl * wlz;
    float pdf_l = 1.0f / fmaxf(kTwoPi * (1.0f - cosm_l), 1e-9f);
    pdf_l = pdf_l / nlf;
    float bl = dot3(ldx, ldy, ldz, tocx, tocy, tocz);
    float cl = dot3(tocx, tocy, tocz, tocx, tocy, tocz) - lrr * lrr;
    float discl = fmaxf(bl * bl - cl, 0.0f);
    float t_l = bl - sqrtf(fmaxf(discl, 1e-20f));
    bool blocked = geo.occluded(pox, poy, poz, ldx, ldy, ldz, t_l - 1e-3f);
    bool lit = !blocked && !inside_l && t_l > kTmin && pdf_l > 0.0f;
    if constexpr (NoMaterialHits<Geometry>::value) {
      lit = lit && mtype != kNoMaterial;   // it would add 0
    }
    if (lit) {
      float ndotl = fmaxf(dot3(nsx, nsy, nsz, ldx, ldy, ldz), 0.0f);
      float fr, fg, fb, pdf_b;
      if (mtype == kLambert) {
        fr = ar * kInvPi * ndotl;
        fg = ag * kInvPi * ndotl;
        fb = ab * kInvPi * ndotl;
        pdf_b = ndotl * kInvPi;
      } else {
        float hsx = wox + ldx, hsy = woy + ldy, hsz = woz + ldz;
        float hlen2 = hsx * hsx + hsy * hsy + hsz * hsz;
        bool h_ok = hlen2 > 1e-12f;
        float hinv = 1.0f / sqrtf(h_ok ? hlen2 : 1.0f);
        float hhx = (h_ok ? hsx : 0.0f) * hinv;
        float hhy = (h_ok ? hsy : 0.0f) * hinv;
        float hhz = (h_ok ? hsz : 0.0f) * hinv;
        float ndoth_e = fmaxf(dot3(nsx, nsy, nsz, hhx, hhy, hhz), 1e-6f);
        float odoth_e = fmaxf(dot3(wox, woy, woz, hhx, hhy, hhz), 1e-6f);
        float qe = ndoth_e * ndoth_e * (a2g - 1.0f) + 1.0f;
        float dggx_e = a2g / fmaxf(kPi * (qe * qe), 1e-12f);
        float ndotl_c = fmaxf(ndotl, 1e-6f);
        float g1l_e = ndotl_c / (ndotl_c * (1.0f - kg) + kg);
        float g_e = g1v * g1l_e;
        float spec_e = h_ok ? dggx_e * g_e / (4.0f * ndotv * ndotl_c) : 0.0f;
        fr = schlick1(odoth_e, ar) * spec_e * ndotl;
        fg = schlick1(odoth_e, ag) * spec_e * ndotl;
        fb = schlick1(odoth_e, ab) * spec_e * ndotl;
        pdf_b = h_ok ? dggx_e * ndoth_e / (4.0f * odoth_e) : 0.0f;
      }
      float w_nee = 1.0f;
      if (use_mis) {
        float pl2 = pdf_l * pdf_l;
        w_nee = pl2 / fmaxf(pl2 + pdf_b * pdf_b, 1e-20f);
      }
      float scale = w_nee / fmaxf(pdf_l, 1e-12f);
      p.rad_r = p.rad_r + p.th_r * fr * ler * scale;
      p.rad_g = p.rad_g + p.th_g * fg * leg * scale;
      p.rad_b = p.rad_b + p.th_b * fb * leb * scale;
    }
  }

  // Throughput update + Russian roulette.
  float th_r_n = p.th_r * w_r;
  float th_g_n = p.th_g * w_g;
  float th_b_n = p.th_b * w_b;
  bool active_n = !dead;
  if (k >= rr_depth) {
    float p_cont = clampf(fmaxf(th_r_n, fmaxf(th_g_n, th_b_n)), 0.05f, 0.95f);
    const float u_rr = counter_uniform(pid, sample, kdim + kDimRR, seed);
    active_n = active_n && !(u_rr > p_cont);
    float inv_p = 1.0f / p_cont;
    th_r_n = th_r_n * inv_p;
    th_g_n = th_g_n * inv_p;
    th_b_n = th_b_n * inv_p;
  }
  if (!active_n) {
    p.active = false;
    return false;
  }
  const float eo = kEps * off_sign;
  p.ox = hx + eo * nsx;
  p.oy = hy + eo * nsy;
  p.oz = hz + eo * nsz;
  p.dx = nd_x;
  p.dy = nd_y;
  p.dz = nd_z;
  p.th_r = th_r_n;
  p.th_g = th_g_n;
  p.th_b = th_b_n;
  p.prev_pdf = pdf_new;
  p.prev_spec = spec_new;
  return false;
}

// K1's and K2's bounce: trace_bounce over the sphere list.
__device__ __forceinline__ void trace_bounce(const SceneView& sc, Path& p,
                                             uint32_t pid, uint32_t sample,
                                             uint32_t seed, int k,
                                             int rr_depth, bool use_nee,
                                             bool use_mis) {
  trace_bounce(sc, SphereList{sc}, p, pid, sample, seed, k, rr_depth,
               use_nee, use_mis);
}

}  // namespace spt
