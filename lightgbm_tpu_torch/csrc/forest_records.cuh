// The value walk over 16-byte node records, shared by K1 and its
// f16-leaf mode (forest_walk.cu) and QW (forest_quant.cu): one set of
// kernels, templated on the node decision.
//
// A node is one 16-byte record (ops/predict.py node_records and
// quant_records): word 0 the node's test (K1: the threshold's f32 bits;
// QW: thr_code | lo << 16 on a numeric node; both: the cat_idx as f32
// bits on a categorical one), word 1 feature | decision << 24, words 2
// and 3 the left and right child. One ld.global.nc.v4 or ld.shared.v4 a
// level, where the thread-a-row walk of the [T, M] arrays loaded five or
// six scattered words.
//
// A Decision D names the row values the walk reads (D::Value: K1's f32
// values, QW's int16 codes), how one is loaded (D::load, a cell of the
// [n, nf] row matrix) and which way a record sends it (D::left, given
// the row's raw f32 values too: QW decides a categorical node on them).
//
// Two modes, chosen on the host by the row count (ops/predict.py
// walk_plan):
//
// "trees" (few rows, n <= TREE_PARALLEL_MAX_ROWS): a block a row, its
// threads walk the row's trees in parallel (one tree a thread, records
// from device memory, the row's values from L1), each tree's value to
// shared memory, then one thread adds them in tree order 0..T-1: the
// same adds as a serial walk. One row's latency is one tree's walk plus
// T adds, not T walks.
//
// "rows" (bulk): a block of ROWS_THREADS (512) threads walks a row a
// thread. It stages its rows' values once in shared memory feature-major
// (column j of local row i at j * stride + i, stride the threads + 1 for
// 4-byte values and + 2 for 2-byte ones, so each feature's column starts
// on a 4-byte word), so a warp's lanes, on consecutive rows, read one
// bank each (two 2-byte values a bank) whatever features they split on,
// and the staging stores are conflict-free too. The records go through
// two shared buffers a chunk of trees at a time (4 trees of 255 leaves
// in 16 KB), the next chunk copied by 16-byte cp.async while the block
// walks this one, every warp on the same chunk. Where one padded tree is
// larger than a buffer the block reads the records from device memory
// instead (ld.global.nc.v4), and where the staged values and the buffers
// exceed 227 KB (wide rows) it reads the values from device memory:
// paths of the same kernel, planned on the host.
//
// Shared on purpose: on the card (PERF.md, PR 13) K1-f16 timed 3.7%
// slower on these kernels than on a copy of its own (K1 0.2%), while QW
// on a copy of its own, the same code written for the codes alone, timed
// 17% slower than on these (2.33 against 1.99 ms at 262,144 rows).
//
// Leaf values: f32 (plus the linear term in a linear forest, K1 only)
// summed in tree order, or f16 (K1's f16 mode and QW) widened and summed
// in batches of tree_batch trees, each batch from 0 and then added to
// the row's total, as the JAX package's predict_forest_f16 and
// predict_forest_quant sum them; the batch count runs on across chunks
// and passes.

#pragma once

#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "forest_node.cuh"

namespace lgbt_records {

using namespace lgbt_forest;

constexpr int kFeatureBits = 24;
constexpr int kFeatureMask = (1 << kFeatureBits) - 1;
// dynamic shared memory one block may use (H100: 227 KB)
constexpr int kSharedBudget = 232448;
constexpr int kModeTrees = 0, kModeRows = 1;

__device__ __forceinline__ int rec_feature(int4 r) {
  return r.y & kFeatureMask;
}

__device__ __forceinline__ unsigned rec_decision(int4 r) {
  return (unsigned)r.y >> kFeatureBits;
}

// K1: word 0 is the threshold's f32 bits; _decide_raw's numeric rules or
// the categorical bitset test on the flushed f32 value
struct RawDecision {
  using Value = float;
  const float* x;
  __device__ __forceinline__ Value load(size_t cell) const {
    return __ldg(x + cell);
  }
  __device__ __forceinline__ bool left(const Forest& f, int t, int4 r,
                                       Value v, const float*) const {
    v = flush_subnormal(v);
    const unsigned decision = rec_decision(r);
    const float threshold = __int_as_float(r.x);
    return (decision & kCategoricalBit)
               ? category_left(f, t, threshold, v)
               : numeric_left(decision, threshold, v);
  }
};

// QW: a numeric node's word 0 is thr_code | lo << 16 and the row's code
// goes left iff lo <= code <= thr_code (lo = -2 sends the -1 missing
// sentinel left); a categorical node tests the row's raw value, read
// from device memory, against the tree's bitset as K1 does
struct CodeDecision {
  using Value = int16_t;
  const int16_t* codes;
  __device__ __forceinline__ Value load(size_t cell) const {
    return __ldg(codes + cell);
  }
  __device__ __forceinline__ bool left(const Forest& f, int t, int4 r,
                                       Value code,
                                       const float* __restrict__ row) const {
    if (rec_decision(r) & kCategoricalBit) {
      return category_left(f, t, __int_as_float(r.x),
                           flush_subnormal(__ldg(row + rec_feature(r))));
    }
    const int c = code;
    return (r.x >> 16) <= c && c <= (int)(int16_t)(r.x & 0xFFFF);
  }
};

// the staged values' row stride for `threads` rows: each feature's
// column starts on a 4-byte word
template <typename Value>
__host__ __device__ constexpr int staged_stride(int threads) {
  return threads + (sizeof(Value) == 4 ? 1 : 2);
}

// tree t's value at `leaf`: the f16 leaf widened, or the f32 leaf plus
// the linear term (forest_node.cuh tree_value)
template <bool kF16>
__device__ __forceinline__ float leaf_value_of(const Forest& f, int t,
                                               int leaf,
                                               const float* __restrict__ row) {
  if (kF16) {
    return __half2float(static_cast<const __half*>(
        f.leaf_value)[(size_t)t * f.max_leaves + leaf]);
  }
  return tree_value(f, t, leaf, row);
}

// one tree's value into the row's sum: in tree order, or (f16) into the
// batch's partial, which joins the total every tree_batch trees
template <bool kF16>
__device__ __forceinline__ void add_tree(float& acc, float& part, float v,
                                         bool batch_end) {
  if (kF16) {
    part = __fadd_rn(part, v);
    if (batch_end) {
      acc = __fadd_rn(acc, part);
      part = 0.f;
    }
  } else {
    acc = __fadd_rn(acc, v);
  }
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}

// `count` records from src to dst by the block, one commit group
__device__ __forceinline__ void stage_records(int4* dst,
                                              const int4* __restrict__ src,
                                              int count) {
  for (int e = threadIdx.x; e < count; e += blockDim.x) {
    cp_async16(dst + e, src + e);
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int kPending>
__device__ __forceinline__ void wait_records() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending));
}

// "trees" mode: block r walks row r, a tree a thread, `chunk` trees a
// pass; thread 0 adds each pass's values in tree order.
template <class D, bool kF16>
__global__ void __launch_bounds__(512)
value_trees_kernel(D d, Forest f, const int4* __restrict__ rec,
                   const float* __restrict__ x, int nf, int chunk,
                   int tree_batch, int epilogue, float denom, float bias,
                   float sigmoid, float* __restrict__ out) {
  extern __shared__ float vals[];
  const size_t cell0 = (size_t)blockIdx.x * nf;
  const float* row = x + cell0;
  const int T = f.num_trees, M = f.max_nodes;
  float acc = 0.f, part = 0.f;
  int in_batch = 0;
  for (int t0 = 0; t0 < T; t0 += chunk) {
    const int cn = min(chunk, T - t0);
    for (int i = threadIdx.x; i < cn; i += blockDim.x) {
      const int t = t0 + i;
      const int4* tree = rec + (size_t)t * M;
      int node = __ldg(f.num_leaves + t) <= 1 ? -1 : 0;
      while (node >= 0) {
        const int4 r = __ldg(tree + node);
        node = d.left(f, t, r, d.load(cell0 + rec_feature(r)), row) ? r.z
                                                                    : r.w;
      }
      vals[i] = leaf_value_of<kF16>(f, t, ~node, row);
    }
    __syncthreads();
    if (threadIdx.x == 0) {
#pragma unroll 8
      for (int i = 0; i < cn; ++i) {
        const bool end = ++in_batch == tree_batch;
        if (end) in_batch = 0;
        add_tree<kF16>(acc, part, vals[i], end);
      }
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    if (kF16 && in_batch > 0) acc = __fadd_rn(acc, part);
    out[blockIdx.x] = epilogue_of(acc, epilogue, denom, bias, sigmoid);
  }
}

// "rows" mode: a block walks blockDim.x rows, a thread one; kRows: the
// rows' first nfs columns staged in shared memory feature-major; kTrees:
// the records through two shared buffers of chunk_trees trees.
template <class D, bool kF16, bool kRows, bool kTrees>
__global__ void __launch_bounds__(512)
value_rows_kernel(D d, Forest f, const int4* __restrict__ rec,
                  const float* __restrict__ x, int n, int nf, int nfs,
                  int chunk_trees, int tree_batch, int epilogue, float denom,
                  float bias, float sigmoid, float* __restrict__ out) {
  using Value = typename D::Value;
  extern __shared__ __align__(16) unsigned char smem[];
  const int T = f.num_trees, M = f.max_nodes;
  const int row0 = blockIdx.x * blockDim.x;
  const int rows_here = min((int)blockDim.x, n - row0);
  const int C = kTrees ? chunk_trees : T;
  const int buf_records = kTrees ? C * M : 0;
  int4* buf = reinterpret_cast<int4*>(smem);
  Value* xs = reinterpret_cast<Value*>(smem + 32 * (size_t)buf_records);
  const int stride = staged_stride<Value>(blockDim.x);
  if (kTrees) stage_records(buf, rec, min(C, T) * M);
  if (kRows) {
    for (int e = threadIdx.x; e < rows_here * nfs; e += blockDim.x) {
      const int i = e / nfs, j = e - i * nfs;
      xs[j * stride + i] = d.load((size_t)(row0 + i) * nf + j);
    }
    if (!kTrees) __syncthreads();
  }
  const bool valid = (int)threadIdx.x < rows_here;
  const size_t cell0 = (size_t)(row0 + (valid ? threadIdx.x : 0)) * nf;
  const float* row = x + cell0;
  float acc = 0.f, part = 0.f;
  int in_batch = 0;
  const int chunks = (T + C - 1) / C;
  for (int c = 0; c < chunks; ++c) {
    const int t0 = c * C, cn = min(C, T - t0);
    const int4* recs;
    if (kTrees) {
      if (c + 1 < chunks) {
        stage_records(buf + ((c + 1) & 1) * buf_records,
                      rec + (size_t)(t0 + C) * M, min(C, T - t0 - C) * M);
        wait_records<1>();
      } else {
        wait_records<0>();
      }
      __syncthreads();
      recs = buf + (c & 1) * buf_records;
    } else {
      recs = rec + (size_t)t0 * M;
    }
    for (int tt = 0; tt < cn; ++tt) {
      const int t = t0 + tt;
      const int4* tree = recs + tt * M;
      int node = (valid && __ldg(f.num_leaves + t) > 1) ? 0 : -1;
      while (node >= 0) {
        const int4 r = kTrees ? tree[node] : __ldg(tree + node);
        const int feature = rec_feature(r);
        const Value v =
            kRows ? xs[feature * stride + threadIdx.x] : d.load(cell0 + feature);
        node = d.left(f, t, r, v, row) ? r.z : r.w;
      }
      const bool end = ++in_batch == tree_batch;
      if (end) in_batch = 0;
      add_tree<kF16>(acc, part, leaf_value_of<kF16>(f, t, ~node, row), end);
    }
    if (kTrees) __syncthreads();
  }
  if (kF16 && in_batch > 0) acc = __fadd_rn(acc, part);
  if (valid) {
    out[row0 + threadIdx.x] = epilogue_of(acc, epilogue, denom, bias,
                                          sigmoid);
  }
}

template <typename Kernel>
cudaError_t allow_shared(Kernel kernel, int smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

// The walk's arguments past the decision and the forest.
struct WalkArgs {
  const int4* rec;
  const float* x;
  int n, nf, threads, chunk_trees, staged_features, smem, tree_batch,
      epilogue;
  float denom, bias, sigmoid;
  float* out;
  cudaStream_t stream;
};

template <class D, bool kF16, bool kRows, bool kTrees>
cudaError_t launch_rows(const D& d, const Forest& f, const WalkArgs& a) {
  auto kernel = value_rows_kernel<D, kF16, kRows, kTrees>;
  cudaError_t err = allow_shared(kernel, a.smem);
  if (err != cudaSuccess) return err;
  kernel<<<(a.n + a.threads - 1) / a.threads, a.threads, a.smem,
           a.stream>>>(d, f, a.rec, a.x, a.n, a.nf, a.staged_features,
                       a.chunk_trees, a.tree_batch, a.epilogue, a.denom,
                       a.bias, a.sigmoid, a.out);
  return cudaGetLastError();
}

template <class D, bool kF16>
cudaError_t launch_mode(int mode, const D& d, const Forest& f,
                        const WalkArgs& a) {
  if (mode == kModeTrees) {
    value_trees_kernel<D, kF16><<<a.n, a.threads, a.smem, a.stream>>>(
        d, f, a.rec, a.x, a.nf, a.chunk_trees, a.tree_batch, a.epilogue,
        a.denom, a.bias, a.sigmoid, a.out);
    return cudaGetLastError();
  }
  const bool staged_rows = a.staged_features >= 0;
  const bool staged_trees = a.chunk_trees > 0;
  auto launch = staged_rows
                    ? (staged_trees ? launch_rows<D, kF16, true, true>
                                    : launch_rows<D, kF16, true, false>)
                    : (staged_trees ? launch_rows<D, kF16, false, true>
                                    : launch_rows<D, kF16, false, false>);
  return launch(d, f, a);
}

// 0 when a plan (ops/predict.py WalkPlan) fits the kernels' limits for
// values of type Value, else the error code to return without a launch.
template <typename Value>
int plan_error(const Forest& f, int mode, const WalkArgs& a) {
  if (a.threads < 32 || a.threads > 512 || a.threads % 32 != 0 ||
      a.smem < 0 || a.smem > kSharedBudget || a.tree_batch < 1 ||
      a.chunk_trees < 0) {
    return (int)cudaErrorInvalidValue;
  }
  if (mode == kModeTrees) {
    return a.chunk_trees < 1 || a.smem < a.chunk_trees * 4
               ? (int)cudaErrorInvalidValue
               : 0;
  }
  if (mode != kModeRows) return (int)cudaErrorInvalidValue;
  const long need =
      (a.chunk_trees > 0 ? 2L * a.chunk_trees * f.max_nodes * 16 : 0) +
      (a.staged_features >= 0 ? (long)sizeof(Value) * a.staged_features *
                                    staged_stride<Value>(a.threads)
                              : 0);
  return need > a.smem || a.staged_features > a.nf
             ? (int)cudaErrorInvalidValue
             : 0;
}

}  // namespace lgbt_records
