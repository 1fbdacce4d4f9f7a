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

__device__ __forceinline__ float linear_term(const float* __restrict__ row,
                                             const float* __restrict__ coeff,
                                             const int* __restrict__ feat,
                                             int k, bool& ok) {
  ok = true;
  float acc = 0.f, first = 0.f;
  for (int j = 0; j < k; ++j) {
    const int f = __ldg(feat + j);
    float x = 0.f;
    if (f >= 0) {
      const float v = __ldg(row + f);
      if (isfinite(v)) {
        x = flush_subnormal(v);
      } else {
        ok = false;
      }
    }
    const float c = __ldg(coeff + j);
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
  return acc;
}

}  // namespace lgbt_linear
