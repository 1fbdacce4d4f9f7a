// Forest-walk kernels of lightgbm_tpu_torch (K1 forest_value_walk,
// K2 forest_leaf_walk), built for sm_90a by ops/_build.py and called
// through ctypes from ops/predict.py.
//
// Replaces, in lightgbm_tpu/ops/predict.py: the walk predict_forest_raw
// (:305) / predict_value_raw (:193) / predict_leaf_raw (:135) /
// _decide_raw (:118) / _in_bitset (:63), and the layouts the TPU serves
// with, predict_forest_raw_matmul (:585) / _one_tree_match (:517) /
// predict_forest_leaf_matmul (:629) / predict_forest_leaf_raw (:656).
// The TPU walks every row through every tree in lockstep ([T, N]
// gathers) or turns each tree into three matmuls, because gathers are
// what its hardware does worst. A GPU thread can simply chase the
// pointers of its own row: one thread per row, trees in order 0..T-1,
// no atomics, so a row's sum is the same f32 sum in the same order on
// every run (and the same as the plain version's).
//
// What bounds it on an H100 SXM, at the chip_smoke shape (262,144 rows x
// 500 trees x 255 leaves x 28 features, seed-0 synthetic forest): bytes
// are the rows (29 MB) plus the outputs (1 MB for K1, 524 MB for K2)
// plus the 3 MB forest, 0.010 ms (K1) or 0.17 ms (K2) at 3.35 TB/s.
// Instruction issue is larger: the run's rows x trees x depth came to
// 1,095,422,768 node visits (mean depth 8.4) at >= 8 instructions a
// visit (load feature id, threshold, decision byte and feature value,
// compare, select, load child, loop test), over 33.5e12 instructions/s
// (132 SMs x 128 lanes x 1.98 GHz), 0.262 ms (chip_smoke.py on an NVIDIA
// H100 80GB HBM3, 700 W; PERF.md). So both kernels are bound by
// operations, and by the latency of each level's dependent loads
// before that: the design keeps the node arrays read-only
// (__ldg) so a tree's ~6 KB stays in L1 while a block walks it (all
// threads of a block visit the trees in the same order), and keeps
// 128 threads a block so many warps hide each other's load latency.
// Divergence is the other cost: a warp walks a tree for as many levels
// as its deepest row needs. wgmma and TMA have no part in a walk.
//
// Linear forests (linear_tree=true, k > 0 coefficient slots a leaf):
// K1 adds, at the leaf each tree's walk reaches, the leaf's linear term
// (linear_term.cuh; the value of lightgbm_tpu/ops/predict.py
// predict_value_raw :193 with linear_leaf_addend :163): the row's k
// values at the leaf's real feature columns times its coefficients, or
// nothing when one of them is not finite. k more loads a (row, tree).

#include <cuda_runtime.h>
#include <stdint.h>

#include "linear_term.cuh"

namespace {

constexpr int kBlock = 128;
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
  const float* leaf_value;       // [T, L]
  const float* leaf_coeff;       // [T, L, K] (K = 0: constant leaves)
  const int* leaf_feat;          // [T, L, K] real columns, -1 padded
  int num_trees, max_nodes, max_leaves, cat_stride, bitset_stride,
      linear_k;
};

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

// A subnormal value compares as a signed zero, as in the JAX package,
// whose backends flush subnormals (the stacked thresholds are flushed on
// the host). Explicit, so it holds whatever the floating-point mode.
using lgbt_linear::flush_subnormal;

// The leaf of tree t that the row reaches. A one-leaf tree starts at
// node -1, i.e. leaf 0; children hold ~leaf for leaves.
__device__ __forceinline__ int leaf_of(const Forest& f, int t,
                                       const float* __restrict__ row) {
  if (__ldg(f.num_leaves + t) <= 1) return 0;
  const size_t base = (size_t)t * f.max_nodes;
  int node = 0;
  while (node >= 0) {
    const size_t i = base + node;
    const float x = flush_subnormal(__ldg(row + __ldg(f.split_feature + i)));
    const unsigned decision = __ldg(f.decision + i);
    const float threshold = __ldg(f.threshold + i);
    const bool left = (decision & kCategoricalBit)
                          ? category_left(f, t, threshold, x)
                          : numeric_left(decision, threshold, x);
    node = left ? __ldg(f.left_child + i) : __ldg(f.right_child + i);
  }
  return ~node;
}

// K1: out[r] = sum over t = 0..T-1 of leaf_value[t, leaf_t(row r)], in
// f32 and in tree order; with an epilogue, convert(out / denom + bias).
__global__ void __launch_bounds__(kBlock)
value_walk_kernel(Forest f, const float* __restrict__ x, int n, int nf,
                  int epilogue, float denom, float bias, float sigmoid,
                  float* __restrict__ out) {
  const int r = blockIdx.x * kBlock + threadIdx.x;
  if (r >= n) return;
  const float* row = x + (size_t)r * nf;
  float acc = 0.f;
  for (int t = 0; t < f.num_trees; ++t) {
    const size_t leaf = (size_t)t * f.max_leaves + leaf_of(f, t, row);
    float v = __ldg(f.leaf_value + leaf);
    if (f.linear_k > 0) {
      bool ok;
      const float lin = lgbt_linear::linear_term(
          row, f.leaf_coeff + leaf * f.linear_k,
          f.leaf_feat + leaf * f.linear_k, f.linear_k, ok);
      v = __fadd_rn(v, ok ? lin : 0.f);
    }
    acc = __fadd_rn(acc, v);
  }
  if (epilogue != kRaw) {
    acc = acc / denom + bias;
    if (epilogue == kSigmoid) acc = 1.f / (1.f + expf(-sigmoid * acc));
  }
  out[r] = acc;
}

// K2: leaf[r, t] = leaf_t(row r), int32, [N, T] row-major.
__global__ void __launch_bounds__(kBlock)
leaf_walk_kernel(Forest f, const float* __restrict__ x, int n, int nf,
                 int* __restrict__ leaf) {
  const int r = blockIdx.x * kBlock + threadIdx.x;
  if (r >= n) return;
  const float* row = x + (size_t)r * nf;
  int* out = leaf + (size_t)r * f.num_trees;
  for (int t = 0; t < f.num_trees; ++t) out[t] = leaf_of(f, t, row);
}

Forest make_forest(const int* num_leaves, const int* split_feature,
                   const float* threshold, const uint8_t* decision,
                   const int* left_child, const int* right_child,
                   const int* cat_boundaries, const uint32_t* cat_bitset,
                   const float* leaf_value, const float* leaf_coeff,
                   const int* leaf_feat, int num_trees, int max_nodes,
                   int max_leaves, int cat_stride, int bitset_stride,
                   int linear_k) {
  return Forest{num_leaves,  split_feature,  threshold,  decision,
                left_child,  right_child,    cat_boundaries, cat_bitset,
                leaf_value,  leaf_coeff,     leaf_feat,  num_trees,
                max_nodes,   max_leaves,     cat_stride, bitset_stride,
                linear_k};
}

}  // namespace

// C interface. Pointers are device pointers; `stream` is the caller's
// cudaStream_t. Each returns cudaGetLastError() after its launch (0 on
// success); nothing synchronises and nothing is allocated here.
extern "C" int lgbt_forest_value_walk(
    const float* x, int n, int nf, const int* num_leaves,
    const int* split_feature, const float* threshold,
    const uint8_t* decision, const int* left_child, const int* right_child,
    const int* cat_boundaries, const uint32_t* cat_bitset,
    const float* leaf_value, const float* leaf_coeff, const int* leaf_feat,
    int num_trees, int max_nodes, int max_leaves, int cat_stride,
    int bitset_stride, int linear_k, int epilogue, float denom,
    float bias, float sigmoid, float* out, void* stream) {
  const Forest f = make_forest(num_leaves, split_feature, threshold,
                               decision, left_child, right_child,
                               cat_boundaries, cat_bitset, leaf_value,
                               leaf_coeff, leaf_feat, num_trees, max_nodes,
                               max_leaves, cat_stride, bitset_stride,
                               linear_k);
  const int blocks = (n + kBlock - 1) / kBlock;
  value_walk_kernel<<<blocks, kBlock, 0, (cudaStream_t)stream>>>(
      f, x, n, nf, epilogue, denom, bias, sigmoid, out);
  return (int)cudaGetLastError();
}

extern "C" int lgbt_forest_leaf_walk(
    const float* x, int n, int nf, const int* num_leaves,
    const int* split_feature, const float* threshold,
    const uint8_t* decision, const int* left_child, const int* right_child,
    const int* cat_boundaries, const uint32_t* cat_bitset,
    const float* leaf_value, const float* leaf_coeff, const int* leaf_feat,
    int num_trees, int max_nodes, int max_leaves, int cat_stride,
    int bitset_stride, int linear_k, int* leaf, void* stream) {
  const Forest f = make_forest(num_leaves, split_feature, threshold,
                               decision, left_child, right_child,
                               cat_boundaries, cat_bitset, leaf_value,
                               leaf_coeff, leaf_feat, num_trees, max_nodes,
                               max_leaves, cat_stride, bitset_stride,
                               linear_k);
  const int blocks = (n + kBlock - 1) / kBlock;
  leaf_walk_kernel<<<blocks, kBlock, 0, (cudaStream_t)stream>>>(f, x, n, nf,
                                                                leaf);
  return (int)cudaGetLastError();
}

extern "C" const char* lgbt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
