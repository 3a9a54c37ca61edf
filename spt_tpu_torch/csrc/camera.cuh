// Camera ray generation shared by K1 and K2: the jittered pinhole or
// thin-lens primary ray of spt_tpu/kernels/megakernel.py, with the same
// float32 expressions as the plain version (kernels/megakernel.py::
// camera_paths).
#pragma once

#include <cstdint>

#include "physics.cuh"
#include "rng.cuh"

namespace spt {

constexpr uint32_t kCamSlot = 0xFFFFu * kNDims;

// cam: blob[0:15] (pos3, right3, up3, fwd3, tan_half_fov, aperture,
// focus_dist); inv_w = f32(1/width), inv_h = f32(1/height), aspect =
// f32(width/height).  Leaves p at the start of bounce 0.
__device__ __forceinline__ void raygen(const float* cam, float inv_w,
                                       float inv_h, float aspect, bool dof,
                                       uint32_t pid, float px, float py,
                                       uint32_t sample, uint32_t seed,
                                       Path& p) {
  float jx = counter_uniform(pid, sample, kCamSlot + 0u, seed);
  float jy = counter_uniform(pid, sample, kCamSlot + 1u, seed);
  float tanf = cam[12];
  float sx = (px + jx) * inv_w;
  float sy = (py + jy) * inv_h;
  float ndc_x = (2.0f * sx - 1.0f) * aspect * tanf;
  float ndc_y = (1.0f - 2.0f * sy) * tanf;
  float dx = ndc_x * cam[3] + ndc_y * cam[6] + cam[9];
  float dy = ndc_x * cam[4] + ndc_y * cam[7] + cam[10];
  float dz = ndc_x * cam[5] + ndc_y * cam[8] + cam[11];
  normalize3(dx, dy, dz);
  float ox = cam[0], oy = cam[1], oz = cam[2];
  if (dof) {
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

}  // namespace spt
