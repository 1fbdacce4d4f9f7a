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
// no cheap branch. x and the bounds are flushed to zero where subnormal
// as XLA's backends flush them, and -0 < +0 is false as IEEE has it.
// Codes run from -1 to 256, 258 values, so they are stored as int16.
//
// Design: one block of 1,024 threads an SM first stages the whole grid
// into shared memory, flushed, each feature's row padded with +inf to
// 2^k - 1 entries and laid out transposed (entry j of feature f at j * fs
// + f, fs the features rounded up to 32), with the missing-type bytes
// beside it; then each warp takes 128 cells a turn, lane l the cells l,
// l + 32, l + 64 and l + 96 of it. So each load of x and store of codes
// is one contiguous 128- or 64-byte run of the warp, the feature of a
// lane's next cell comes by one add and compare (no modulo a cell), and
// the 32 lanes of a probe hold 32 consecutive features, whose entries sit
// in 32 distinct banks, wherever each lane's search has got to. The count
// is a branch-free binary search of the staged row (8 probes for 255
// bounds), four independent searches a lane. A grid past 48 KB of shared
// memory (more than 32 features of 255 bounds) is searched in device
// memory instead, by the same code. Four consecutive cells a thread
// (16-byte loads) would put a probe's 32 lanes on 7 of 28 features, at
// entries that collide in banks.
// Bound on an H100 SXM: 4 bytes read and 2 written a (row, feature), and
// the grid (28 x 237 floats at the main path's forest, from L2 once an
// SM): 262,144 x 28 cells move 44 MB, 0.013 ms at 3.35 TB/s; about
// 40 instructions a cell (the flush and missing test, 8 probes of load,
// compare and add), 0.009 ms at 33.5e12 a second. Bytes bound it.
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
// worst; a GPU thread chases its own row's pointers. QW and K1's f16
// mode make the same decisions over the same f16 leaves in the same sum
// order, so they agree bitwise.
//
// Design: QW is K1's walk (forest_records.cuh) instantiated on
// CodeDecision. Its records are K1's with the first word of a numeric
// node holding thr_code | lo << 16 (ops/predict.py quant_records, built
// once a stack), so a level is one 16-byte load in place of the six
// scattered [T, M] loads (feature, decision, lo, thr_code, left, right)
// of the thread-a-row walk it replaces; K1's two modes and plan: a block
// a row with its trees in parallel up to TREE_PARALLEL_MAX_ROWS rows,
// past that a row a thread over the rows' int16 codes staged
// feature-major (two codes a bank word, half K1's shared memory a row)
// and double-buffered record chunks. A categorical node reads the row's
// raw value from device memory (its line is in L1 after the first).
// Bound as K1 (operations: node visits x 8 instructions; 0.2609 ms at
// 262,144 rows x 500 binned trees), with 2-byte code loads in place of
// 4-byte values: bytes are the codes (15 MB), the rows a categorical
// node reads, 2 MB of records and 1 MB out.

#include <cuda_runtime.h>
#include <stdint.h>

#include "forest_node.cuh"
#include "forest_records.cuh"

namespace {

using namespace lgbt_forest;

constexpr int kMissNanBit = 1;
constexpr int kMissZeroBit = 2;
constexpr int kCodesThreads = 1024;
// QC's staged grid and missing bytes: the default 48 KB a block
constexpr int kCodesSmem = 48 * 1024;
// QC's cells a call: their 32-bit indices never wrap
constexpr size_t kMaxCells = ((size_t)1 << 32) - 256;

// the code of one value of feature f (f < the grid's features): `g`
// points at the feature's first entry, `at` apart (staged: flushed, +inf
// past `bounds`; in device memory: `bounds` raw entries), `half` = 2^k /
// 2 with 2^k - 1 >= bounds
template <bool kStaged>
__device__ __forceinline__ int code_of(float raw, int m, const float* g,
                                       int at, int bounds, int half) {
  const bool nan = isnan(raw);
  const float v = flush_subnormal(nan ? 0.f : raw);
  if (((m & kMissNanBit) && nan) ||
      ((m & kMissZeroBit) && (nan || fabsf(v) <= kZeroThreshold))) {
    return -1;
  }
  int count = 0;  // the number of bounds below v, by binary lifting
  for (int step = half; step > 0; step >>= 1) {
    const int j = count + step - 1;
    if (kStaged) {
      if (g[j * at] < v) count += step;
    } else if (j < bounds && flush_subnormal(__ldg(g + j)) < v) {
      count += step;
    }
  }
  return 1 + count;
}

// x [cells / nf, nf] f32 row-major, codes the same int16 (cells below
// kMaxCells, so no cell index of a turn wraps);
// staged: entry j of feature f at j * fs + f (fs = the features rounded
// up to 32)
template <bool kStaged>
__global__ void __launch_bounds__(kCodesThreads)
codes_kernel(const float* __restrict__ x, uint32_t cells, int nf,
             const float* __restrict__ grid, int grid_features, int bounds,
             int half, int fs, const uint8_t* __restrict__ miss,
             int16_t* __restrict__ codes) {
  extern __shared__ float staged[];
  const int entries = 2 * half - 1;
  uint8_t* sm = reinterpret_cast<uint8_t*>(staged + entries * fs);
  if (kStaged) {
    // read in the grid's order (coalesced); the transposed writes
    // conflict, once a block
    for (int e = threadIdx.x; e < grid_features * entries;
         e += blockDim.x) {
      const int f = e / entries, j = e - f * entries;
      staged[j * fs + f] =
          j < bounds ? flush_subnormal(__ldg(grid + (size_t)f * bounds + j))
                     : __int_as_float(0x7f800000);  // +inf
    }
    for (int f = threadIdx.x; f < grid_features; f += blockDim.x) {
      sm[f] = miss == nullptr ? 0 : __ldg(miss + f);
    }
    __syncthreads();
  }
  const int lane = threadIdx.x % 32;
  const int warps = blockDim.x / 32;
  const int wrap = 32 % nf;  // the feature 32 cells on
  // a warp takes 128 cells a turn, lane l cells l, l + 32, l + 64 and
  // l + 96: each load and store of the warp is one contiguous run, and
  // the lanes of a probe hold 32 consecutive features, whose staged
  // entries sit in distinct banks (two lanes share one where a row
  // wraps)
  const uint32_t turns = cells / 128 + (cells % 128 != 0);
  for (uint32_t t = blockIdx.x * warps + threadIdx.x / 32; t < turns;
       t += gridDim.x * warps) {
    const uint32_t c0 = t * 128 + lane;
    float v[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const uint32_t c = c0 + 32 * u;
      v[u] = c < cells ? __ldg(x + c) : 0.f;
    }
    int f = (int)(c0 % (uint32_t)nf);
    short code[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      if (f >= grid_features) {
        code[u] = 1;
      } else if (kStaged) {
        code[u] = (short)code_of<true>(v[u], sm[f], staged + f, fs, bounds,
                                       half);
      } else {
        code[u] = (short)code_of<false>(
            v[u], miss == nullptr ? 0 : __ldg(miss + f),
            grid + (size_t)f * bounds, 1, bounds, half);
      }
      f += wrap;
      f = f >= nf ? f - nf : f;
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const uint32_t c = c0 + 32 * u;
      if (c < cells) codes[c] = code[u];
    }
  }
}

template <bool kStaged>
int launch_codes(const float* x, uint32_t cells, int nf, const float* grid,
                 int grid_features, int bounds, int half, int fs,
                 const uint8_t* miss, int16_t* codes, size_t smem,
                 cudaStream_t s) {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess) {
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    }
    if (err != cudaSuccess) return (int)err;
  }
  // one block an SM at most: each block stages the grid once
  const uint32_t turns = cells / 128 + (cells % 128 != 0);
  const uint32_t per_block = kCodesThreads / 32;
  uint32_t blocks = (turns + per_block - 1) / per_block;
  blocks = blocks > (uint32_t)sms ? (uint32_t)sms : blocks;
  codes_kernel<kStaged><<<blocks, kCodesThreads, smem, s>>>(
      x, cells, nf, grid, grid_features, bounds, half, fs, miss, codes);
  return (int)cudaGetLastError();
}

}  // namespace

// x [n, nf] f32; grid [grid_features, bounds] f32 sorted, +inf padded;
// miss [grid_features] u8 (bit 0 NaN, bit 1 zero) or null when the
// forest has no missing-typed numeric split; codes [n, nf] int16 out;
// n * nf below kMaxCells (ops/predict.py QUANT_MAX_CELLS).
extern "C" int lgbt_quant_codes(const float* x, int n, int nf,
                                const float* grid, int grid_features,
                                int bounds, const uint8_t* miss,
                                int16_t* codes, void* stream) {
  const size_t cells = (size_t)n * nf;
  if (cells == 0) return 0;
  if (bounds < 1 || nf < 1 || cells >= kMaxCells) {
    return (int)cudaErrorInvalidValue;
  }
  int half = 1;
  while (2 * half - 1 < bounds) half *= 2;
  const int fs = (grid_features + 31) / 32 * 32;
  const size_t smem = (size_t)(2 * half - 1) * fs * 4 + grid_features;
  const cudaStream_t s = (cudaStream_t)stream;
  if (smem <= (size_t)kCodesSmem) {
    return launch_codes<true>(x, (uint32_t)cells, nf, grid, grid_features,
                              bounds, half, fs, miss, codes, smem, s);
  }
  return launch_codes<false>(x, (uint32_t)cells, nf, grid, grid_features,
                             bounds, half, fs, miss, codes, 0, s);
}

// The forest's node arrays and f16 leaves as K1 takes them (the
// categorical bitsets read the raw rows x), QW's records [T, M, 4] int32
// (ops/predict.py quant_records), the codes [n, nf] int16 of the same
// rows and K1's launch plan (ops/predict.py walk_plan with 2-byte
// values); out [n] f32.
extern "C" int lgbt_forest_quant_walk(
    const float* x, int n, int nf, const int* num_leaves,
    const int* split_feature, const float* threshold,
    const uint8_t* decision, const int* left_child, const int* right_child,
    const int* cat_boundaries, const uint32_t* cat_bitset,
    const void* leaf_value, const float* leaf_coeff, const int* leaf_feat,
    int num_trees, int max_nodes, int max_leaves, int cat_stride,
    int bitset_stride, int linear_k, const void* records,
    const int16_t* codes, int mode, int threads, int chunk_trees,
    int staged_features, int smem, int tree_batch, int epilogue,
    float denom, float bias, float sigmoid, float* out, void* stream) {
  using namespace lgbt_records;
  if (linear_k != 0) return (int)cudaErrorInvalidValue;
  const Forest f = make_forest(num_leaves, split_feature, threshold,
                               decision, left_child, right_child,
                               cat_boundaries, cat_bitset, leaf_value,
                               leaf_coeff, leaf_feat, num_trees, max_nodes,
                               max_leaves, cat_stride, bitset_stride,
                               linear_k);
  const WalkArgs a{static_cast<const int4*>(records), x, n, nf, threads,
                   chunk_trees, staged_features, smem, tree_batch, epilogue,
                   denom, bias, sigmoid, out, (cudaStream_t)stream};
  const int err = plan_error<int16_t>(f, mode, a);
  if (err != 0) return err;
  return (int)launch_mode<CodeDecision, true>(mode, CodeDecision{codes}, f,
                                              a);
}

extern "C" const char* lgbt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
