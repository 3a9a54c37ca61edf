// Counter-based RNG: the same uint32 pipeline as spt_tpu_torch/core/rng.py.
//
// Every sampling site draws counter_uniform(pixel, sample, bounce*8+dim,
// seed), a stateless hash, so the kernel and the plain PyTorch version
// consume bit-identical streams.
#pragma once

#include <cstdint>

namespace spt {

__device__ __forceinline__ uint32_t hash_u32(uint32_t x) {
  uint32_t state = x * 747796405u + 2891336453u;
  uint32_t shift = (state >> 28) + 4u;
  uint32_t r = ((state >> shift) ^ state) * 277803737u;
  return (r >> 22) ^ r;
}

__device__ __forceinline__ uint32_t mix(uint32_t h, uint32_t k) {
  k *= 0x85EBCA6Bu;
  k = (k << 15) | (k >> 17);
  k *= 0xC2B2AE35u;
  h ^= k;
  h = (h << 13) | (h >> 19);
  return h * 5u + 0xE6546B64u;
}

__device__ __forceinline__ uint32_t counter_bits(uint32_t pixel, uint32_t sample,
                                                 uint32_t bounce_dim, uint32_t seed) {
  uint32_t h = seed ^ 0x9E3779B9u;
  h = mix(h, pixel);
  h = mix(h, sample);
  h = mix(h, bounce_dim);
  return hash_u32(h);
}

// Top 24 bits -> exactly representable float in [0, 1).
__device__ __forceinline__ float counter_uniform(uint32_t pixel, uint32_t sample,
                                                 uint32_t bounce_dim, uint32_t seed) {
  uint32_t bits = counter_bits(pixel, sample, bounce_dim, seed);
  return (float)(int)(bits >> 8) * 0x1p-24f;
}

}  // namespace spt
