// JAX's threefry2x32 stream on the card, shared by kernels M and Q
// (quantize.cu) and GW (goss.cu): element i of jax.random.uniform(key,
// (n,)) hashes its own index, so each thread draws its own row's number
// in registers, bit for bit the plain version's (ops/rng.py).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) {
  return (x << r) | (x >> (32 - r));
}

// threefry2x32, 20 rounds (jax/_src/prng.py _threefry2x32_lowering)
__device__ __forceinline__ void threefry2x32(uint32_t k0, uint32_t k1,
                                             uint32_t& x0, uint32_t& x1) {
  const uint32_t ks[3] = {k0, k1, k0 ^ k1 ^ 0x1BD11BDAu};
  const int rot[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
  x0 += k0;
  x1 += k1;
#pragma unroll
  for (int i = 0; i < 5; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      x0 += x1;
      x1 = rotl(x1, rot[i % 2][j]);
      x1 ^= x0;
    }
    x0 += ks[(i + 1) % 3];
    x1 += ks[(i + 2) % 3] + (uint32_t)(i + 1);
  }
}

// element i (< 2^31) of jax.random.uniform(key, (n,)), f32
__device__ __forceinline__ float uniform_at(uint32_t k0, uint32_t k1,
                                            int i) {
  uint32_t x0 = 0u, x1 = (uint32_t)i;
  threefry2x32(k0, k1, x0, x1);
  const uint32_t bits = ((x0 ^ x1) >> 9) | 0x3F800000u;
  return fmaxf(0.f, __fsub_rn(__uint_as_float(bits), 1.f));
}

}  // namespace
