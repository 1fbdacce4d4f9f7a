// Forest-walk kernels of lightgbm_tpu_torch (K1 forest_value_walk and
// its f16-leaf mode, K2 forest_leaf_walk, ES forest_early_stop_walk),
// built for sm_90a by ops/_build.py and called through ctypes from
// ops/predict.py. The walk itself is forest_node.cuh's.
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

// K1's f16-leaf mode (tpu_predict_quantize=f16): the same walk over a
// stack whose leaf values are stored as f16 (rounded f64 -> f32 -> f16 on
// the host, as the JAX package rounds them), widened with __half2float.
// Replaces predict_forest_f16 (:934) / _one_tree_match_f16 (:905). The
// sum follows the JAX function's order: trees in batches of tree_batch
// (10), each batch summed from 0 in tree order and then added to the
// row's total (`acc + vmap(one)(batch).sum(axis=0)`, a sequential reduce
// for batches of up to 32 on XLA's CPU backend). Bound as K1, with 2-byte
// leaf loads.
//
// ES forest_early_stop_walk: margin-based per-row early stop over a
// [K, T] stack (K classes, T iterations; tree (c, t) at c * T + t).
// Replaces predict_forest_raw_early_stop (:957), a lax.while_loop that
// walks iteration t's K trees for all rows in lockstep, freezes a row
// whose margin exceeds `margin` after every freq-th iteration (2|raw|
// for K = 1, top-1 minus top-2 of the K sums for K >= 2) and stops when
// every row is frozen. Here each thread keeps its row's K sums in
// registers (local memory past a few classes), adds iteration t's K tree
// values in class order, checks the margin after iterations freq,
// 2 freq, ... and returns as soon as its row is frozen: each row exits on
// its own, and there is no global loop. A frozen row's sums are exactly
// the JAX function's (it adds 0.0 to a frozen row, which leaves an f32
// sum that cannot be -0 unchanged), so the two agree bitwise. Linear
// forests add the leaf's linear term (linear_term.cuh), as
// predict_value_raw (:193) does. Bound as K1 over the trees each row
// actually walks (data dependent): the row's iterations until it froze
// times K.

#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "forest_node.cuh"

namespace {

using namespace lgbt_forest;

constexpr int kBlock = 128;
// the widest [K, T] stack ES takes (its per-row class sums;
// ops/predict.py MAX_EARLY_STOP_CLASSES)
constexpr int kMaxClasses = 32;

// K1: out[r] = sum over t = 0..T-1 of tree t's value for row r, in f32
// and in tree order; with an epilogue, convert(out / denom + bias).
__global__ void __launch_bounds__(kBlock)
value_walk_kernel(Forest f, const float* __restrict__ x, int n, int nf,
                  int epilogue, float denom, float bias, float sigmoid,
                  float* __restrict__ out) {
  const int r = blockIdx.x * kBlock + threadIdx.x;
  if (r >= n) return;
  const float* row = x + (size_t)r * nf;
  float acc = 0.f;
  for (int t = 0; t < f.num_trees; ++t) {
    acc = __fadd_rn(acc, tree_value(f, t, leaf_of(f, t, row), row));
  }
  out[r] = epilogue_of(acc, epilogue, denom, bias, sigmoid);
}

// K1's f16-leaf mode: f16 leaves widened, summed in batches of
// tree_batch trees (see the note at the top).
__global__ void __launch_bounds__(kBlock)
value_walk_f16_kernel(Forest f, const float* __restrict__ x, int n, int nf,
                      int tree_batch, int epilogue, float denom, float bias,
                      float sigmoid, float* __restrict__ out) {
  const int r = blockIdx.x * kBlock + threadIdx.x;
  if (r >= n) return;
  const float* row = x + (size_t)r * nf;
  const __half* leaf_value = static_cast<const __half*>(f.leaf_value);
  float acc = 0.f, part = 0.f;
  for (int t = 0; t < f.num_trees; ++t) {
    const int leaf = leaf_of(f, t, row);
    part = __fadd_rn(
        part, __half2float(leaf_value[(size_t)t * f.max_leaves + leaf]));
    if ((t + 1) % tree_batch == 0 || t + 1 == f.num_trees) {
      acc = __fadd_rn(acc, part);
      part = 0.f;
    }
  }
  out[r] = epilogue_of(acc, epilogue, denom, bias, sigmoid);
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

// ES: out [K, N] f32, the row's class sums when it froze or after all T
// iterations; `iters` [N] i32, the iterations the row walked.
__global__ void __launch_bounds__(kBlock)
early_stop_kernel(Forest f, const float* __restrict__ x, int n, int nf,
                  int k, int t_iters, float margin, int freq,
                  float* __restrict__ out, int* __restrict__ iters) {
  const int r = blockIdx.x * kBlock + threadIdx.x;
  if (r >= n) return;
  const float* row = x + (size_t)r * nf;
  float acc[kMaxClasses];
  for (int c = 0; c < k; ++c) acc[c] = 0.f;
  int t = 0;
  while (t < t_iters) {
    for (int c = 0; c < k; ++c) {
      const int tree = c * t_iters + t;
      acc[c] = __fadd_rn(acc[c], tree_value(f, tree, leaf_of(f, tree, row),
                                            row));
    }
    ++t;
    if (t % freq == 0) {
      float m;
      if (k == 1) {
        m = 2.f * fabsf(acc[0]);
      } else {
        float top1 = -INFINITY, top2 = -INFINITY;
        for (int c = 0; c < k; ++c) {
          if (acc[c] > top1) {
            top2 = top1;
            top1 = acc[c];
          } else if (acc[c] > top2) {
            top2 = acc[c];
          }
        }
        m = __fsub_rn(top1, top2);
      }
      if (!(m <= margin)) break;
    }
  }
  for (int c = 0; c < k; ++c) out[(size_t)c * n + r] = acc[c];
  iters[r] = t;
}

}  // namespace

#define LGBT_FOREST_ARGS                                                    \
  const float *x, int n, int nf, const int *num_leaves,                    \
      const int *split_feature, const float *threshold,                    \
      const uint8_t *decision, const int *left_child,                      \
      const int *right_child, const int *cat_boundaries,                   \
      const uint32_t *cat_bitset, const void *leaf_value,                  \
      const float *leaf_coeff, const int *leaf_feat, int num_trees,        \
      int max_nodes, int max_leaves, int cat_stride, int bitset_stride,    \
      int linear_k
#define LGBT_MAKE_FOREST                                                    \
  make_forest(num_leaves, split_feature, threshold, decision, left_child,  \
              right_child, cat_boundaries, cat_bitset, leaf_value,         \
              leaf_coeff, leaf_feat, num_trees, max_nodes, max_leaves,     \
              cat_stride, bitset_stride, linear_k)

// C interface. Pointers are device pointers; `stream` is the caller's
// cudaStream_t. Each returns cudaGetLastError() after its launch (0 on
// success); nothing synchronises and nothing is allocated here.
extern "C" int lgbt_forest_value_walk(LGBT_FOREST_ARGS, int epilogue,
                                      float denom, float bias,
                                      float sigmoid, float* out,
                                      void* stream) {
  const int blocks = (n + kBlock - 1) / kBlock;
  value_walk_kernel<<<blocks, kBlock, 0, (cudaStream_t)stream>>>(
      LGBT_MAKE_FOREST, x, n, nf, epilogue, denom, bias, sigmoid, out);
  return (int)cudaGetLastError();
}

extern "C" int lgbt_forest_value_walk_f16(LGBT_FOREST_ARGS, int tree_batch,
                                          int epilogue, float denom,
                                          float bias, float sigmoid,
                                          float* out, void* stream) {
  if (tree_batch < 1) return (int)cudaErrorInvalidValue;
  const int blocks = (n + kBlock - 1) / kBlock;
  value_walk_f16_kernel<<<blocks, kBlock, 0, (cudaStream_t)stream>>>(
      LGBT_MAKE_FOREST, x, n, nf, tree_batch, epilogue, denom, bias, sigmoid,
      out);
  return (int)cudaGetLastError();
}

extern "C" int lgbt_forest_leaf_walk(LGBT_FOREST_ARGS, int* leaf,
                                     void* stream) {
  const int blocks = (n + kBlock - 1) / kBlock;
  leaf_walk_kernel<<<blocks, kBlock, 0, (cudaStream_t)stream>>>(
      LGBT_MAKE_FOREST, x, n, nf, leaf);
  return (int)cudaGetLastError();
}

extern "C" int lgbt_forest_early_stop_walk(LGBT_FOREST_ARGS, int k,
                                           float margin, int freq,
                                           float* out, int* iters,
                                           void* stream) {
  if (k < 1 || k > kMaxClasses || freq < 1 || num_trees % k != 0) {
    return (int)cudaErrorInvalidValue;
  }
  const int blocks = (n + kBlock - 1) / kBlock;
  early_stop_kernel<<<blocks, kBlock, 0, (cudaStream_t)stream>>>(
      LGBT_MAKE_FOREST, x, n, nf, k, num_trees / k, margin, freq, out,
      iters);
  return (int)cudaGetLastError();
}

extern "C" const char* lgbt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
