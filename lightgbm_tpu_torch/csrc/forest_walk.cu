// Forest-walk kernels of lightgbm_tpu_torch (K1 forest_value_walk and
// its f16-leaf mode, K2 forest_leaf_walk, ES forest_early_stop_walk),
// built for sm_90a by ops/_build.py and called through ctypes from
// ops/predict.py.
//
// Replaces, in lightgbm_tpu/ops/predict.py: the walk predict_forest_raw
// (:305) / predict_value_raw (:193) / predict_leaf_raw (:135) /
// _decide_raw (:118) / _in_bitset (:63), and the layouts the TPU serves
// with, predict_forest_raw_matmul (:585) / _one_tree_match (:517) /
// predict_forest_leaf_matmul (:629) / predict_forest_leaf_raw (:656).
// The TPU walks every row through every tree in lockstep ([T, N]
// gathers) or turns each tree into three matmuls, because gathers are
// what its hardware does worst. A GPU thread can simply chase the
// pointers of its own row, and K2 and ES do: one thread per row, trees
// in order 0..T-1 (forest_node.cuh's walk over the [T, M] arrays). K2's
// bytes at the chip_smoke shape are its 524 MB of leaf indices, 0.17 ms
// at 3.35 TB/s, below the 0.262 ms of operations counted for K1 below.
//
// K1 sums a row's tree values in f32 in tree order, with the linear term
// added at each tree's leaf and the epilogue after the last tree, so
// its bits are the plain version's (ops/predict.py
// forest_value_walk_plain). Its design answers what held the
// thread-a-row walk at 25x its bound (6.38 ms at 262,144 rows x 500
// trees, 1.77 ms on one row, on an H100 80GB HBM3 at 700 W; PERF.md):
// - a row's walk is a chain of T x depth dependent levels (4,200 at 500
//   trees of mean depth 8.4), each several dependent loads from L2;
// - a level read five [T, M] arrays (feature, decision, threshold, left,
//   right), scattered over five sectors;
// - lanes read their rows' features 112 B apart, a sector each.
// So each node is one 16-byte record (ops/predict.py node_records:
// threshold bits, feature | decision << 24, left, right), one
// ld.global.nc.v4 or ld.shared.v4 a level, and K1 has two modes, chosen
// on the host by the row count (ops/predict.py walk_plan):
//
// "trees" (few rows, n <= TREE_PARALLEL_MAX_ROWS): a block a row, its
// threads walk the row's trees in parallel (one tree a thread, records
// from device memory, the row's 28 values from L1), each tree's value
// to shared memory, then one thread adds them in tree order 0..T-1:
// the same adds as the serial walk. One row's latency is one tree's
// walk plus T adds, not T walks.
//
// "rows" (bulk): a block of ROWS_THREADS (512) threads walks a row a
// thread. It stages its rows once in shared memory feature-major
// (column j of local row i at j * (threads + 1) + i), so a warp's lanes,
// on consecutive rows, read one bank each whatever features they split
// on, and the staging stores are conflict-free too. The forest's
// records go through two shared buffers a chunk of trees at a time (4
// trees of 255 leaves in 16 KB), the next chunk copied by 16-byte
// cp.async while the block walks this one, every warp on the same
// chunk. Where one padded tree is larger than a buffer the block reads
// the records from device memory instead (ld.global.nc.v4), and where
// the staged rows and the buffers exceed 227 KB (wide rows) it reads
// the rows from device memory: paths of the same kernel, planned on the
// host.
//
// What bounds it on an H100 SXM, at the chip_smoke shape (262,144 rows
// x 500 trees x 255 leaves x 28 features, seed-0 synthetic forest):
// bytes are the rows (29 MB), the outputs (1 MB) and the 2 MB of
// records, 0.010 ms at 3.35 TB/s. Instruction issue is larger: the
// run's 1,095,422,768 node visits (mean depth 8.4) at >= 8 instructions
// a visit over 33.5e12 instructions/s, 0.262 ms. What holds the kernel
// at about 10x that is, as far as the variants timed on the card show
// (PERF.md), the shared-memory pipe: once a warp's lanes part
// ways, its 16-byte record load is four quarter-warp phases with bank
// conflicts inside each, some ten wavefronts a level beside the row
// value's one, and a warp walks a tree for as many levels as its
// deepest row needs. Fewer threads a block, more blocks an SM, two to
// four rows a thread, records read through L1 instead of a shared
// chunk, and a short path for a numeric node's ordinary value beside
// the missing-value rules all timed the same or slower.
//
// Linear forests (linear_tree=true, k > 0 coefficient slots a leaf):
// K1 adds, at the leaf each tree's walk reaches, the leaf's linear term
// (linear_term.cuh; the value of lightgbm_tpu/ops/predict.py
// predict_value_raw :193 with linear_leaf_addend :163): the row's k
// values at the leaf's real feature columns, read from device memory,
// times its coefficients, or nothing when one of them is not finite.
// In rows mode a linear forest's block stages neither rows nor records
// (walk_plan): the linear term reads the row at every tree, which keeps
// its line in L1 for the walk, and staging timed slower (PERF.md).
//
// K1's f16-leaf mode (tpu_predict_quantize=f16): the same walks over a
// stack whose leaf values are stored as f16 (rounded f64 -> f32 -> f16 on
// the host, as the JAX package rounds them), widened with __half2float.
// Replaces predict_forest_f16 (:934) / _one_tree_match_f16 (:905). The
// sum follows the JAX function's order: trees in batches of tree_batch
// (10), each batch summed from 0 in tree order and then added to the
// row's total (`acc + vmap(one)(batch).sum(axis=0)`, a sequential reduce
// for batches of up to 32 on XLA's CPU backend). Bound as K1.
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

// ---------------------------------------------------------------------
// K1: the 16-byte node record (ops/predict.py node_records)
constexpr int kFeatureBits = 24;
constexpr int kFeatureMask = (1 << kFeatureBits) - 1;
// dynamic shared memory one block may use (H100: 227 KB)
constexpr int kSharedBudget = 232448;
constexpr int kModeTrees = 0, kModeRows = 1;

__device__ __forceinline__ int rec_feature(int4 r) {
  return r.y & kFeatureMask;
}

// the child of record r (of tree t) for the row's value x: _decide_raw's
// numeric rules or the categorical bitset test, on the flushed value
__device__ __forceinline__ int rec_child(const Forest& f, int t, int4 r,
                                         float x) {
  x = flush_subnormal(x);
  const unsigned decision = (unsigned)r.y >> kFeatureBits;
  const float threshold = __int_as_float(r.x);
  const bool left = (decision & kCategoricalBit)
                        ? category_left(f, t, threshold, x)
                        : numeric_left(decision, threshold, x);
  return left ? r.z : r.w;
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

// K1 "trees" mode: block r walks row r, a tree a thread, `chunk` trees
// a pass; thread 0 adds each pass's values in tree order.
template <bool kF16>
__global__ void __launch_bounds__(512)
value_trees_kernel(Forest f, const int4* __restrict__ rec,
                   const float* __restrict__ x, int nf, int chunk,
                   int tree_batch, int epilogue, float denom, float bias,
                   float sigmoid, float* __restrict__ out) {
  extern __shared__ float vals[];
  const float* row = x + (size_t)blockIdx.x * nf;
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
        node = rec_child(f, t, r, __ldg(row + rec_feature(r)));
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

// K1 "rows" mode: a block walks blockDim.x rows, a thread one; kRows:
// the rows' first nfs columns staged in shared memory feature-major;
// kTrees: the records through two shared buffers of chunk_trees trees.
// See the note at the top.
template <bool kF16, bool kRows, bool kTrees>
__global__ void __launch_bounds__(512)
value_rows_kernel(Forest f, const int4* __restrict__ rec,
                  const float* __restrict__ x, int n, int nf, int nfs,
                  int chunk_trees, int tree_batch, int epilogue, float denom,
                  float bias, float sigmoid, float* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int T = f.num_trees, M = f.max_nodes;
  const int row0 = blockIdx.x * blockDim.x;
  const int rows_here = min((int)blockDim.x, n - row0);
  const int C = kTrees ? chunk_trees : T;
  const int buf_records = kTrees ? C * M : 0;
  int4* buf = reinterpret_cast<int4*>(smem);
  float* xs = reinterpret_cast<float*>(smem) + 8 * buf_records;
  const int stride = blockDim.x + 1;
  if (kTrees) stage_records(buf, rec, min(C, T) * M);
  if (kRows) {
    for (int e = threadIdx.x; e < rows_here * nfs; e += blockDim.x) {
      const int i = e / nfs, j = e - i * nfs;
      xs[j * stride + i] = __ldg(x + (size_t)(row0 + i) * nf + j);
    }
    if (!kTrees) __syncthreads();
  }
  const bool valid = (int)threadIdx.x < rows_here;
  const float* row = x + (size_t)(row0 + (valid ? threadIdx.x : 0)) * nf;
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
        node = rec_child(f, t, r,
                         kRows ? xs[feature * stride + threadIdx.x]
                               : __ldg(row + feature));
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

template <bool kF16, bool kRows, bool kTrees>
cudaError_t launch_rows(const Forest& f, const int4* rec, const float* x,
                        int n, int nf, int threads, int chunk, int nfs,
                        int smem, int tree_batch, int epilogue, float denom,
                        float bias, float sigmoid, float* out,
                        cudaStream_t stream) {
  auto kernel = value_rows_kernel<kF16, kRows, kTrees>;
  cudaError_t err = allow_shared(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<(n + threads - 1) / threads, threads, smem, stream>>>(
      f, rec, x, n, nf, nfs, chunk, tree_batch, epilogue, denom, bias,
      sigmoid, out);
  return cudaGetLastError();
}

// the four staging variants of one leaf type
template <bool kF16>
cudaError_t launch_rows_any(bool staged_rows, bool staged_trees,
                            const Forest& f, const int4* rec, const float* x,
                            int n, int nf, int threads, int chunk, int nfs,
                            int smem, int tree_batch, int epilogue,
                            float denom, float bias, float sigmoid,
                            float* out, cudaStream_t stream) {
  auto launch = staged_rows
                    ? (staged_trees ? launch_rows<kF16, true, true>
                                    : launch_rows<kF16, true, false>)
                    : (staged_trees ? launch_rows<kF16, false, true>
                                    : launch_rows<kF16, false, false>);
  return launch(f, rec, x, n, nf, threads, chunk, nfs, smem, tree_batch,
                epilogue, denom, bias, sigmoid, out, stream);
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
extern "C" int lgbt_forest_value_walk(LGBT_FOREST_ARGS, const void* records,
                                      int mode, int threads, int chunk_trees,
                                      int staged_features, int smem,
                                      int f16, int tree_batch, int epilogue,
                                      float denom, float bias,
                                      float sigmoid, float* out,
                                      void* stream) {
  const Forest f = LGBT_MAKE_FOREST;
  const int4* rec = static_cast<const int4*>(records);
  const cudaStream_t s = (cudaStream_t)stream;
  if (threads < 32 || threads > 512 || threads % 32 != 0 || smem < 0 ||
      smem > kSharedBudget || tree_batch < 1 || chunk_trees < 0) {
    return (int)cudaErrorInvalidValue;
  }
  if (mode == kModeTrees) {
    if (chunk_trees < 1 || smem < chunk_trees * 4) {
      return (int)cudaErrorInvalidValue;
    }
    if (f16) {
      value_trees_kernel<true><<<n, threads, smem, s>>>(
          f, rec, x, nf, chunk_trees, tree_batch, epilogue, denom, bias,
          sigmoid, out);
    } else {
      value_trees_kernel<false><<<n, threads, smem, s>>>(
          f, rec, x, nf, chunk_trees, tree_batch, epilogue, denom, bias,
          sigmoid, out);
    }
    return (int)cudaGetLastError();
  }
  if (mode != kModeRows) return (int)cudaErrorInvalidValue;
  const bool staged_trees = chunk_trees > 0;
  const bool staged_rows = staged_features >= 0;
  const long need =
      (staged_trees ? 2L * chunk_trees * max_nodes * 16 : 0) +
      (staged_rows ? 4L * staged_features * (threads + 1) : 0);
  if (need > smem || staged_features > nf) return (int)cudaErrorInvalidValue;
  return (int)(f16 ? launch_rows_any<true> : launch_rows_any<false>)(
      staged_rows, staged_trees, f, rec, x, n, nf, threads, chunk_trees,
      staged_features, smem, tree_batch, epilogue, denom, bias, sigmoid, out,
      s);
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
