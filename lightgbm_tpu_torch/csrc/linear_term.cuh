// The linear term of a piecewise-linear leaf, shared by kernel LA
// (linear.cu) and K1's linear forests (forest_walk.cu).
//
// lin = sum_j coeff[j] * x[feat[j]] over the leaf's k slots, in the
// order XLA's CPU backend adds jnp.einsum("nk,nk->n", ...) at
// precision HIGHEST (lightgbm_tpu/ops/predict.py:163 and
// linear/solver.py:143): for k == 2 the second product is fused with
// the first, fma(c1, x1, c0 * x0); otherwise the first eight products
// are rounded and added one at a time from 0, and each later one is
// fused into the sum, acc = fma(c_j, x_j, acc) for j >= 8 (probed
// bitwise for k = 1..100 against jnp.einsum; ops/linear.py
// linear_dot_plain is the same order in torch ops). A padded slot
// (feat < 0) contributes 0 * 0. `ok` is false when a live slot's value
// is not finite: the caller then takes the intercept alone. A
// subnormal value counts as a signed zero, as on the JAX package's
// backends.

#pragma once

#include <math.h>

namespace lgbt_linear {

constexpr float kF32Tiny = 1.17549435e-38f;  // smallest normal float
// slots XLA's dot adds unfused before it fuses the rest (k != 2)
constexpr int kUnfusedSlots = 8;

__device__ __forceinline__ float flush_subnormal(float x) {
  return fabsf(x) < kF32Tiny ? copysignf(0.f, x) : x;
}

// a live slot's value as the dot takes it: 0 (and ok = false) when it
// is not finite, subnormals flushed
__device__ __forceinline__ float slot_value(float v, bool& ok) {
  if (!isfinite(v)) {
    ok = false;
    return 0.f;
  }
  return flush_subnormal(v);
}

// slot j of k added to the running sum in XLA's order
__device__ __forceinline__ void add_slot(float& acc, float& first, float c,
                                         float x, int j, int k) {
  if (k == 2) {
    if (j == 0) {
      first = __fmul_rn(c, x);
    } else {
      acc = __fmaf_rn(c, x, first);
    }
  } else if (j < kUnfusedSlots) {
    acc = __fadd_rn(acc, __fmul_rn(c, x));
  } else {
    acc = __fmaf_rn(c, x, acc);
  }
}

__device__ __forceinline__ float linear_term(const float* __restrict__ row,
                                             const float* __restrict__ coeff,
                                             const int* __restrict__ feat,
                                             int k, bool& ok) {
  ok = true;
  float acc = 0.f, first = 0.f;
  for (int j = 0; j < k; ++j) {
    const int f = __ldg(feat + j);
    const float x = f >= 0 ? slot_value(__ldg(row + f), ok) : 0.f;
    add_slot(acc, first, __ldg(coeff + j), x, j, k);
  }
  return acc;
}

// The same sum over K values already in registers, a padded slot's
// value being 0 (so every slot is taken as live); c may be shared memory.
template <int K>
__device__ __forceinline__ float linear_term_values(const float (&v)[K],
                                                    const float* c,
                                                    bool& ok) {
  ok = true;
  float acc = 0.f, first = 0.f;
#pragma unroll
  for (int j = 0; j < K; ++j) {
    add_slot(acc, first, c[j], slot_value(v[j], ok), j, K);
  }
  return acc;
}

}  // namespace lgbt_linear
