// The raw-feature tree walk shared by the forest kernels of
// lightgbm_tpu_torch: K1, K2 and ES (forest_walk.cu) and QW
// (forest_quant.cu). The Forest struct mirrors ops/predict.py's Forest
// (node arrays [T, M], leaf values [T, L], categorical bitsets per
// tree); `walk` follows one row down one tree, with the numeric
// decision given by the caller (raw f32 threshold for K1, code compare
// for QW) and the categorical one K1's bitset test.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "linear_term.cuh"

namespace lgbt_forest {

constexpr unsigned kCategoricalBit = 1u;
constexpr unsigned kDefaultLeftBit = 2u;
constexpr int kMissingZero = 1;
constexpr int kMissingNan = 2;
constexpr float kZeroThreshold = 1e-35f;

enum Epilogue { kRaw = 0, kIdentity = 1, kSigmoid = 2 };

struct Forest {
  const int* num_leaves;         // [T]
  const int* split_feature;      // [T, M]
  const float* threshold;        // [T, M]
  const uint8_t* decision;       // [T, M] bit0 cat, bit1 default_left, bits2-3 missing
  const int* left_child;         // [T, M]
  const int* right_child;        // [T, M]
  const int* cat_boundaries;     // [T, C]
  const uint32_t* cat_bitset;    // [T, W]
  const void* leaf_value;        // [T, L] f32, or f16 in the f16 layout
  const float* leaf_coeff;       // [T, L, K] (K = 0: constant leaves)
  const int* leaf_feat;          // [T, L, K] real columns, -1 padded
  int num_trees, max_nodes, max_leaves, cat_stride, bitset_stride,
      linear_k;
};

inline Forest make_forest(const int* num_leaves, const int* split_feature,
                          const float* threshold, const uint8_t* decision,
                          const int* left_child, const int* right_child,
                          const int* cat_boundaries,
                          const uint32_t* cat_bitset, const void* leaf_value,
                          const float* leaf_coeff, const int* leaf_feat,
                          int num_trees, int max_nodes, int max_leaves,
                          int cat_stride, int bitset_stride, int linear_k) {
  return Forest{num_leaves,  split_feature,  threshold,  decision,
                left_child,  right_child,    cat_boundaries, cat_bitset,
                leaf_value,  leaf_coeff,     leaf_feat,  num_trees,
                max_nodes,   max_leaves,     cat_stride, bitset_stride,
                linear_k};
}

// A subnormal value compares as a signed zero, as in the JAX package,
// whose backends flush subnormals (the stacked thresholds are flushed on
// the host). Explicit, so it holds whatever the floating-point mode.
using lgbt_linear::flush_subnormal;

// _in_bitset on a raw category: floor(x) in the node's bitset words.
// NaN, negative values and categories beyond the bitset go right.
__device__ __forceinline__ bool category_left(const Forest& f, int t,
                                              float threshold, float x) {
  if (isnan(x)) return false;
  const float cat = floorf(x);
  const int* bounds = f.cat_boundaries + (size_t)t * f.cat_stride;
  const int idx = (int)threshold;  // a categorical node stores its cat_idx
  const int lo = __ldg(bounds + idx);
  const int words = __ldg(bounds + idx + 1) - lo;
  if (!(cat >= 0.f) || cat >= 32.f * (float)words) return false;
  const int v = (int)cat;
  const uint32_t word =
      __ldg(f.cat_bitset + (size_t)t * f.bitset_stride + lo + (v >> 5));
  return (word >> (v & 31)) & 1u;
}

// _decide_raw on a numeric node: a missing value (NaN under MISSING_NAN;
// NaN or |x| <= 1e-35 under MISSING_ZERO) takes default_left; otherwise
// NaN counts as 0 and the row goes left when x <= threshold (f32).
__device__ __forceinline__ bool numeric_left(unsigned decision,
                                             float threshold, float x) {
  const bool nan = isnan(x);
  const int missing = (decision >> 2) & 3;
  const bool is_missing = (missing == kMissingNan && nan) ||
                          (missing == kMissingZero &&
                           (nan || fabsf(x) <= kZeroThreshold));
  if (is_missing) return decision & kDefaultLeftBit;
  return (nan ? 0.f : x) <= threshold;
}

// The leaf of tree t that the row reaches; `numeric(i, feature,
// decision)` decides a numeric node i (its flat index in [T, M]). A
// one-leaf tree starts at node -1, i.e. leaf 0; children hold ~leaf for
// leaves.
template <typename Numeric>
__device__ __forceinline__ int walk(const Forest& f, int t,
                                    const float* __restrict__ row,
                                    Numeric numeric) {
  if (__ldg(f.num_leaves + t) <= 1) return 0;
  const size_t base = (size_t)t * f.max_nodes;
  int node = 0;
  while (node >= 0) {
    const size_t i = base + node;
    const int feature = __ldg(f.split_feature + i);
    const unsigned decision = __ldg(f.decision + i);
    const bool left =
        (decision & kCategoricalBit)
            ? category_left(f, t, __ldg(f.threshold + i),
                            flush_subnormal(__ldg(row + feature)))
            : numeric(i, feature, decision);
    node = left ? __ldg(f.left_child + i) : __ldg(f.right_child + i);
  }
  return ~node;
}

// K1's walk: raw f32 thresholds.
__device__ __forceinline__ int leaf_of(const Forest& f, int t,
                                       const float* __restrict__ row) {
  return walk(f, t, row, [&](size_t i, int feature, unsigned decision) {
    return numeric_left(decision, __ldg(f.threshold + i),
                        flush_subnormal(__ldg(row + feature)));
  });
}

// Tree t's value for the row at `leaf`: the f32 leaf value plus, in a
// linear forest, the leaf's linear term (0 when a slot is not finite).
__device__ __forceinline__ float tree_value(const Forest& f, int t,
                                            int leaf_index,
                                            const float* __restrict__ row) {
  const size_t leaf = (size_t)t * f.max_leaves + leaf_index;
  float v = __ldg(static_cast<const float*>(f.leaf_value) + leaf);
  if (f.linear_k > 0) {
    bool ok;
    const float lin = lgbt_linear::linear_term(
        row, f.leaf_coeff + leaf * f.linear_k,
        f.leaf_feat + leaf * f.linear_k, f.linear_k, ok);
    v = __fadd_rn(v, ok ? lin : 0.f);
  }
  return v;
}

// The single-class output epilogue: convert(raw / denom + bias).
__device__ __forceinline__ float epilogue_of(float acc, int epilogue,
                                             float denom, float bias,
                                             float sigmoid) {
  if (epilogue != kRaw) {
    acc = acc / denom + bias;
    if (epilogue == kSigmoid) acc = 1.f / (1.f + expf(-sigmoid * acc));
  }
  return acc;
}

}  // namespace lgbt_forest
