// Persistent threads with path regeneration: the sample loop of K1
// (megakernel.cu) and K3 (megakernel_bvh.cu).
//
// A grid of as many blocks as the SMs hold takes the image in batches of
// 32 pixels, an 8x4 tile each, from a counter in device memory (`next`,
// zeroed on the launch's stream before the launch).  A warp takes a batch
// at a time, so its primary rays stay neighbours.  Each lane owns one
// pixel at a time and runs its samples s = 0..spp-1 one after another.
//
// The loop is flat: each iteration runs one bounce of every lane's live
// path.  A lane whose path has ended adds its radiance to its pixel's sum,
// and in the same iteration starts the pixel's next sample, or, after the
// last, stores the sum and takes the next pixel of its warp's batch; a
// warp whose batch is handed out takes the next batch.  So a warp waits
// only for the work left, not for its longest path at every sample.  At 1
// spp it regenerates across pixels.
//
// Each path runs the operations of the one-thread-a-pixel loop it replaces
// (raygen, then bounces k = 0.. while the path lives and k < max_bounces)
// and one lane adds a pixel's samples in order s = 0..spp-1, so the image
// is the same to the bit.  No atomics touch the image.
//
// A launch may render a band of a taller image: `height` rows starting at
// row `row_offset` of a `full_height`-row image (the caller's inv_h and
// aspect are the full image's).  Batches tile the band; a lane keys its
// random numbers and its camera ray on the global pixel id
// (y + row_offset) * width + x and stores the band's local pixel, so a
// band equals the same rows of the full render to the bit.
#pragma once

#include <cstdint>

#include "camera.cuh"
#include "physics.cuh"

namespace spt {

constexpr int kBatchW = 8, kBatchH = 4;   // a warp's batch: an 8x4 tile

struct RegenArgs {
  float* out;             // (H, W, 3) radiance sum
  unsigned* next;         // the next batch to hand out
  unsigned long long* counts;  // kCount: lane slots, busy lanes
  int width, height, spp, max_bounces;
  int row_offset;         // the band's first row in the full image
  bool dof;
  float inv_w, inv_h, aspect;  // f32(1/width), f32(1/full_height),
                               // f32(width/full_height)
};

// Runs every pixel of the image: `bounce(p, pid, sample, k)` is one bounce
// of path p.  With kCount each warp adds the lane slots of its bounce
// iterations and the lanes that ran a bounce in them to a.counts.
template <bool kCount, class Bounce>
__device__ __forceinline__ void regen_paths(const RegenArgs& a,
                                            const float* cam,
                                            uint32_t start, uint32_t seed,
                                            const Bounce& bounce) {
  const int lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1u;
  const int tiles_x = (a.width + kBatchW - 1) / kBatchW;
  const int n_batches = tiles_x * ((a.height + kBatchH - 1) / kBatchH);
  // The warp's batch and the slots of it handed out (the same in every
  // lane), and whether the counter has run out.
  int batch = 0, handed = 32;
  bool exhausted = false;
  // The lane's global pixel id (-1: none), its sample, the path's bounce.
  int pix = -1, s = 0, k = 0;
  float px = 0.0f, py = 0.0f;
  float acc_r = 0.0f, acc_g = 0.0f, acc_b = 0.0f;
  bool live = false;
  Path p;
  p.active = false;
  unsigned long long slots = 0, busy = 0;
  while (true) {
    if constexpr (kCount) {   // iterations that run a bounce
      const unsigned ran =
          __ballot_sync(kWarpMask, live && k < a.max_bounces);
      slots += ran ? 32 : 0;
      busy += __popc(ran);
    }
    // One bounce of every live path.
    if (live && k < a.max_bounces) {
      bounce(p, (uint32_t)pix, start + (uint32_t)s, k);
      ++k;
    }
    // A path that ended adds its radiance; the pixel's last one stores.
    if (live && (!p.active || k >= a.max_bounces)) {
      acc_r += p.rad_r;
      acc_g += p.rad_g;
      acc_b += p.rad_b;
      live = false;
      if (++s >= a.spp) {
        const int local = pix - a.row_offset * a.width;
        a.out[3 * local + 0] = acc_r;
        a.out[3 * local + 1] = acc_g;
        a.out[3 * local + 2] = acc_b;
        pix = -1;
      }
    }
    // Lanes with no pixel take the batch's next slots, in lane order; a
    // slot past the image's edge leaves its lane asking again.
    while (!exhausted) {
      const unsigned need = __ballot_sync(kWarpMask, pix < 0);
      if (need == 0) break;
      if (handed == 32) {
        unsigned b = 0;
        if (lane == 0) b = atomicAdd(a.next, 1u);
        b = __shfl_sync(kWarpMask, b, 0);
        if (b >= (unsigned)n_batches) {
          exhausted = true;
          break;
        }
        batch = (int)b;
        handed = 0;
      }
      const int slot = handed + __popc(need & below);
      if (pix < 0 && slot < 32) {
        const int x = (batch % tiles_x) * kBatchW + (slot & (kBatchW - 1));
        const int y = (batch / tiles_x) * kBatchH + slot / kBatchW;
        if (x < a.width && y < a.height) {
          pix = (y + a.row_offset) * a.width + x;
          px = (float)x;
          py = (float)(y + a.row_offset);
          s = 0;
          acc_r = acc_g = acc_b = 0.0f;
        }
      }
      handed = min(32, handed + __popc(need));
    }
    // Every lane that holds a pixel and no path starts its next sample.
    if (pix >= 0 && !live) {
      raygen(cam, a.inv_w, a.inv_h, a.aspect, a.dof, (uint32_t)pix, px, py,
             start + (uint32_t)s, seed, p);
      k = 0;
      live = true;
    }
    if (!__any_sync(kWarpMask, live)) break;
  }
  if constexpr (kCount) {
    if (lane == 0) {
      atomicAdd(a.counts, slots);
      atomicAdd(a.counts + 1, busy);
    }
  }
}

// A zero image where there are no samples to add (spp <= 0).
__device__ __forceinline__ void zero_image(const RegenArgs& a) {
  const int n = 3 * a.width * a.height;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += gridDim.x * blockDim.x)
    a.out[i] = 0.0f;
}

// The batches a launch hands out, and the blocks a persistent grid needs:
// as many as the card holds (max_blocks), but no more than the batches
// fill.
inline int regen_batches(int width, int height) {
  return ((width + kBatchW - 1) / kBatchW) *
         ((height + kBatchH - 1) / kBatchH);
}

inline int regen_grid(int max_blocks, int threads, int width, int height) {
  const int warps = threads / 32;
  const int need = (regen_batches(width, height) + warps - 1) / warps;
  const int fit = max_blocks > 0 ? max_blocks : 1;
  return need < fit ? need : fit;
}

}  // namespace spt
