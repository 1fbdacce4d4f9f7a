// The fixed-point serving kernels of lightgbm_tpu_torch
// (tpu_predict_quantize=int8), built for sm_90a by ops/_build.py and
// called through ctypes from ops/predict.py.
//
// QC quant_codes: codes[r, f] = 1 + #{bounds of feature f < x[r, f]}
// over the feature's sorted, +inf-padded grid of the forest's distinct
// f32 split thresholds; NaN counts as 0.0; -1 for a row that is missing
// under the feature's missing type (NaN under MISSING_NAN, NaN or
// |x| <= 1e-35 under MISSING_ZERO) when the forest has missing-typed
// numeric splits; 1 for a column past the grid. Replaces quant_codes,
// lightgbm_tpu/ops/predict.py:820, which compares every (row, feature,
// bound) triple ([N, F, K] booleans summed over K) because the TPU has
// no cheap branch. Here one thread takes one (row, feature) and finds
// the count by a branch-free binary search of the grid row (at most 8
// steps for 255 bounds), x and the bounds flushed to zero where
// subnormal as XLA's backends flush them, and -0 < +0 false as IEEE has
// it. Codes run from -1 to 256, 258 values, so they are stored as int16.
// Bound on an H100 SXM: 4 bytes read and 2 written a (row, feature), and
// the grid (28 x 255 floats, L1/L2 resident): 262,144 x 28 cells move
// 44 MB, 0.013 ms at 3.35 TB/s; about 40 instructions a cell (load,
// flush, 8 search steps of load, compare and add, the missing test),
// 0.009 ms at 33.5e12 a second. Bytes bound it.
//
// QW forest_quant_walk: the forest walked on the codes. A numeric node
// goes left iff lo <= code <= thr_code (thr_code = 1 + the threshold's
// index in its feature's grid; lo = -2 for a default-left node, else 0,
// so the -1 sentinel goes the default way); a categorical node goes left
// through the tree's bitset on the raw value, as K1 walks it. Leaf
// values are f16, widened with __half2float and summed in batches of
// tree_batch trees as K1's f16 mode sums them. Replaces
// _one_tree_match_quant (:846), predict_forest_quant (:882) and
// _leaf_value_reduce (:870): the TPU evaluates each tree as three
// matmuls over one-hot path tensors because gathers are what it does
// worst; a GPU thread chases its own row's pointers (forest_node.cuh).
// QW and K1's f16 mode make the same decisions over the same f16 leaves
// in the same sum order, so they agree bitwise. Bound as K1 (operations:
// node visits), with 2-byte code loads in place of 4-byte values.

#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "forest_node.cuh"

namespace {

using namespace lgbt_forest;

constexpr int kBlock = 128;
constexpr int kMissNanBit = 1;
constexpr int kMissZeroBit = 2;

__global__ void __launch_bounds__(kBlock)
codes_kernel(const float* __restrict__ x, int n, int nf,
             const float* __restrict__ grid, int grid_features, int bounds,
             const uint8_t* __restrict__ miss, int16_t* __restrict__ codes) {
  const size_t cell = (size_t)blockIdx.x * kBlock + threadIdx.x;
  if (cell >= (size_t)n * nf) return;
  const int f = (int)(cell % nf);
  if (f >= grid_features) {
    codes[cell] = 1;
    return;
  }
  const float raw = __ldg(x + cell);
  const bool nan = isnan(raw);
  const float v = flush_subnormal(nan ? 0.f : raw);
  const int m = miss == nullptr ? 0 : __ldg(miss + f);
  if (((m & kMissNanBit) && nan) ||
      ((m & kMissZeroBit) && (nan || fabsf(v) <= kZeroThreshold))) {
    codes[cell] = -1;
    return;
  }
  // the number of bounds below v: binary lifting over the sorted row
  const float* g = grid + (size_t)f * bounds;
  int count = 0;
  for (int step = 1 << (31 - __clz(bounds)); step > 0; step >>= 1) {
    const int j = count + step - 1;
    if (j < bounds && flush_subnormal(__ldg(g + j)) < v) count += step;
  }
  codes[cell] = (int16_t)(1 + count);
}

__global__ void __launch_bounds__(kBlock)
quant_walk_kernel(Forest f, const int16_t* __restrict__ thr_code,
                  const int16_t* __restrict__ lo,
                  const int16_t* __restrict__ codes,
                  const float* __restrict__ x, int n, int nf, int tree_batch,
                  int epilogue, float denom, float bias, float sigmoid,
                  float* __restrict__ out) {
  const int r = blockIdx.x * kBlock + threadIdx.x;
  if (r >= n) return;
  const float* row = x + (size_t)r * nf;
  const int16_t* code_row = codes + (size_t)r * nf;
  const __half* leaf_value = static_cast<const __half*>(f.leaf_value);
  float acc = 0.f, part = 0.f;
  for (int t = 0; t < f.num_trees; ++t) {
    const int leaf = walk(f, t, row, [&](size_t i, int feature, unsigned) {
      const int c = __ldg(code_row + feature);
      return __ldg(lo + i) <= c && c <= __ldg(thr_code + i);
    });
    part = __fadd_rn(
        part, __half2float(leaf_value[(size_t)t * f.max_leaves + leaf]));
    if ((t + 1) % tree_batch == 0 || t + 1 == f.num_trees) {
      acc = __fadd_rn(acc, part);
      part = 0.f;
    }
  }
  out[r] = epilogue_of(acc, epilogue, denom, bias, sigmoid);
}

}  // namespace

// x [n, nf] f32; grid [grid_features, bounds] f32 sorted, +inf padded;
// miss [grid_features] u8 (bit 0 NaN, bit 1 zero) or null when the
// forest has no missing-typed numeric split; codes [n, nf] int16 out.
extern "C" int lgbt_quant_codes(const float* x, int n, int nf,
                                const float* grid, int grid_features,
                                int bounds, const uint8_t* miss,
                                int16_t* codes, void* stream) {
  const size_t cells = (size_t)n * nf;
  if (cells == 0) return 0;
  if (bounds < 1) return (int)cudaErrorInvalidValue;
  const size_t blocks = (cells + kBlock - 1) / kBlock;
  codes_kernel<<<(unsigned)blocks, kBlock, 0, (cudaStream_t)stream>>>(
      x, n, nf, grid, grid_features, bounds, miss, codes);
  return (int)cudaGetLastError();
}

// The forest's node arrays and f16 leaves as K1 takes them (the
// categorical bitsets read the raw rows x), thr_code and lo [T, M]
// int16, the codes [n, nf] int16 of the same rows; out [n] f32.
extern "C" int lgbt_forest_quant_walk(
    const float* x, int n, int nf, const int* num_leaves,
    const int* split_feature, const float* threshold,
    const uint8_t* decision, const int* left_child, const int* right_child,
    const int* cat_boundaries, const uint32_t* cat_bitset,
    const void* leaf_value, const float* leaf_coeff, const int* leaf_feat,
    int num_trees, int max_nodes, int max_leaves, int cat_stride,
    int bitset_stride, int linear_k, const int16_t* thr_code,
    const int16_t* lo, const int16_t* codes, int tree_batch, int epilogue,
    float denom, float bias, float sigmoid, float* out, void* stream) {
  if (tree_batch < 1 || linear_k != 0) return (int)cudaErrorInvalidValue;
  const Forest f = make_forest(num_leaves, split_feature, threshold,
                               decision, left_child, right_child,
                               cat_boundaries, cat_bitset, leaf_value,
                               leaf_coeff, leaf_feat, num_trees, max_nodes,
                               max_leaves, cat_stride, bitset_stride,
                               linear_k);
  const int blocks = (n + kBlock - 1) / kBlock;
  quant_walk_kernel<<<blocks, kBlock, 0, (cudaStream_t)stream>>>(
      f, thr_code, lo, codes, x, n, nf, tree_batch, epilogue, denom, bias,
      sigmoid, out);
  return (int)cudaGetLastError();
}

extern "C" const char* lgbt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
