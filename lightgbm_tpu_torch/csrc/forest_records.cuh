// The walks over 16-byte node records, shared by K1 and its f16-leaf
// mode, K2 (the leaf indices) and ES (early stop) in forest_walk.cu and
// QW in forest_quant.cu: one set of kernels, templated on the node
// decision and on what a walk writes.
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
// from device memory, the row's values from L1). K1 and QW put each
// tree's value in shared memory and one thread adds them in tree order
// 0..T-1: the same adds as a serial walk. K2 writes each tree's leaf
// straight to out[row * T + t], consecutive threads on consecutive
// words. ES walks a pass of iterations (K trees each) in parallel, then
// one thread adds them in iteration and class order, checks the margin
// at every freq-th iteration and ends the row's walk at its freeze, so
// no later pass is walked. One row's latency is one tree's walk plus T
// adds, not T walks.
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
// K2 in rows mode puts each chunk's leaves in a shared [rows, tile]
// tile (8 trees a row, a 32-byte sector of int32, where the chunk
// allows) and the block writes the tile out row after row, consecutive
// threads on consecutive words of a row, instead of a lane a sector.
//
// ES in rows mode (early_stop_rows_kernel) streams the records as K1
// does, the K trees of an iteration at c * T + t, so a chunk of
// iterations is K strided runs. Each row's K sums live in shared memory,
// not in the thread that walks it. After each chunk the block compacts
// the local indices of its live rows into a shared list (a ballot a warp
// and a prefix over the warps), and thread i walks row list[i]: the
// warps past the live count sit the chunk out. A block that kept its
// rows to the end would live as long as its longest-lived row, with ever
// fewer warps live, so the walk runs in rounds of a few dozen
// iterations, a launch each: a round's blocks take the rows the last
// round left live, compacted over the whole launch (an atomicAdd a
// block), and their sums from device memory. Once few rows are live at a
// round's start (ES_TAIL_ROWS), too few to fill the SMs a row a thread,
// early_stop_trees_kernel takes them on from there, a block a row with
// the row's trees in parallel. A row's adds do not depend on the thread,
// block or launch that makes them, so the sums are the plain version's
// bits.
//
// Shared on purpose: on the card (PERF.md, PR 13) K1-f16 timed 3.7%
// slower on these kernels than on a copy of its own (K1 0.2%), while QW
// on a copy of its own, the same code written for the codes alone, timed
// 17% slower than on these (2.33 against 1.99 ms at 262,144 rows).
//
// Leaf values: f32 (plus the linear term in a linear forest, K1 and ES)
// summed in tree order, or f16 (K1's f16 mode and QW) widened and summed
// in batches of tree_batch trees, each batch from 0 and then added to
// the row's total, as the JAX package's predict_forest_f16 and
// predict_forest_quant sum them; the batch count runs on across chunks
// and passes.

#pragma once

#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "forest_node.cuh"

namespace lgbt_records {

using namespace lgbt_forest;

constexpr int kFeatureBits = 24;
constexpr int kFeatureMask = (1 << kFeatureBits) - 1;
// dynamic shared memory one block may use (H100: 227 KB)
constexpr int kSharedBudget = 232448;
constexpr int kModeTrees = 0, kModeRows = 1;
// the widest [K, T] stack ES takes (ops/predict.py MAX_EARLY_STOP_CLASSES)
constexpr int kMaxClasses = 32;
// ES rows mode's warp totals (512 threads at most)
constexpr int kMaxWarps = 16;

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

// The leaf (>= 0) a row reaches in tree t whose records start at `tree`.
// kShared: the records are a shared buffer's; kRows: the row's values
// are column `li` of the staged xs, else cells cell0 + feature of the
// row matrix. `valid` false walks nothing (leaf 0).
template <class D, bool kShared, bool kRows>
__device__ __forceinline__ int walk_tree(
    const D& d, const Forest& f, int t, const int4* __restrict__ tree,
    const typename D::Value* xs, int stride, int li, size_t cell0,
    const float* __restrict__ row, bool valid) {
  int node = (valid && __ldg(f.num_leaves + t) > 1) ? 0 : -1;
  while (node >= 0) {
    const int4 r = kShared ? tree[node] : __ldg(tree + node);
    const int feature = rec_feature(r);
    const typename D::Value v =
        kRows ? xs[feature * stride + li] : d.load(cell0 + feature);
    node = d.left(f, t, r, v, row) ? r.z : r.w;
  }
  return ~node;
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

// ES's margin of a row's K sums (sums[c * stride]): 2|sum| for K = 1,
// top-1 minus top-2 for K >= 2 (predict_forest_raw_early_stop)
__device__ __forceinline__ float class_margin(const float* sums, int k,
                                              int stride) {
  if (k == 1) return 2.f * fabsf(sums[0]);
  float top1 = -INFINITY, top2 = -INFINITY;
  for (int c = 0; c < k; ++c) {
    const float v = sums[c * stride];
    if (v > top1) {
      top2 = top1;
      top1 = v;
    } else if (v > top2) {
      top2 = v;
    }
  }
  return __fsub_rn(top1, top2);
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

// `runs` runs of `count` records, run c from src + c * src_stride to
// dst + c * dst_stride, by the block: one commit group
__device__ __forceinline__ void stage_runs(int4* dst,
                                           const int4* __restrict__ src,
                                           int runs, int count,
                                           int dst_stride,
                                           size_t src_stride) {
  for (int e = threadIdx.x; e < runs * count; e += blockDim.x) {
    const int c = e / count, i = e - c * count;
    cp_async16(dst + c * dst_stride + i, src + c * src_stride + i);
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int kPending>
__device__ __forceinline__ void wait_records() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending));
}

// "trees" mode: block r walks row r, a tree a thread. K1 and QW: `chunk`
// trees a pass, thread 0 adds each pass's values in tree order. kLeaf
// (K2): `out` holds the [n, T] int32 leaves and each tree's leaf goes to
// out[r * T + t], nothing summed. (K2 shares K1's signature and K1's
// code is the same text as before K2 joined, so K1's build does not
// move.)
template <class D, bool kF16, bool kLeaf = false>
__global__ void __launch_bounds__(512)
value_trees_kernel(D d, Forest f, const int4* __restrict__ rec,
                   const float* __restrict__ x, int nf, int chunk,
                   int tree_batch, int epilogue, float denom, float bias,
                   float sigmoid, float* __restrict__ out) {
  extern __shared__ float vals[];
  const size_t cell0 = (size_t)blockIdx.x * nf;
  const float* row = x + cell0;
  const int T = f.num_trees, M = f.max_nodes;
  if constexpr (kLeaf) {
    int* leaves = reinterpret_cast<int*>(out) + (size_t)blockIdx.x * T;
    for (int t = threadIdx.x; t < T; t += blockDim.x) {
      leaves[t] = walk_tree<D, false, false>(d, f, t, rec + (size_t)t * M,
                                             nullptr, 0, 0, cell0, row,
                                             true);
    }
  } else {
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
}

// "rows" mode: a block walks blockDim.x rows, a thread one; kRows: the
// rows' first nfs columns staged in shared memory feature-major; kTrees:
// the records through two shared buffers of chunk_trees trees. kLeaf
// (K2): `out` holds the [n, T] int32 leaves and tree_batch the trees a
// row of a shared tile takes (a multiple of the chunk; the chunk itself
// where the records are not staged); each tree's leaf goes to the tile,
// which the block writes out when it is full or at the end. (K1's code
// is the same text as before K2 joined.)
template <class D, bool kF16, bool kRows, bool kTrees, bool kLeaf = false>
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
  const int tile_trees = tree_batch;
  const int C = kTrees ? chunk_trees : (kLeaf ? tile_trees : T);
  const int buf_records = kTrees ? C * M : 0;
  // the tile's row stride: odd, so a warp's stores, a row a lane, take
  // one bank each
  const int tile_stride = tile_trees + 1;
  int4* buf = reinterpret_cast<int4*>(smem);
  int* tile = reinterpret_cast<int*>(smem + 32 * (size_t)buf_records);
  Value* xs = reinterpret_cast<Value*>(
      smem + 32 * (size_t)buf_records +
      (kLeaf ? 4 * (size_t)blockDim.x * tile_stride : 0));
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
      if constexpr (kLeaf) {
        tile[threadIdx.x * tile_stride + t % tile_trees] = ~node;
      } else {
        const bool end = ++in_batch == tree_batch;
        if (end) in_batch = 0;
        add_tree<kF16>(acc, part, leaf_value_of<kF16>(f, t, ~node, row),
                       end);
      }
    }
    if (kTrees || kLeaf) __syncthreads();
    if constexpr (kLeaf) {
      const int end = t0 + cn;
      if (end % tile_trees == 0 || end == T) {
        int* leaves = reinterpret_cast<int*>(out);
        const int tb = (end - 1) / tile_trees * tile_trees, w = end - tb;
        for (int e = threadIdx.x; e < rows_here * w; e += blockDim.x) {
          const int i = e / w, j = e - i * w;
          leaves[(size_t)(row0 + i) * T + tb + j] = tile[i * tile_stride + j];
        }
        if (!kTrees) __syncthreads();
      }
    }
  }
  if constexpr (!kLeaf) {
    if (kF16 && in_batch > 0) acc = __fadd_rn(acc, part);
    if (valid) {
      out[row0 + threadIdx.x] = epilogue_of(acc, epilogue, denom, bias,
                                            sigmoid);
    }
  }
}

// ES's arguments: K classes over t_iters iterations (tree (c, t) at
// c * t_iters + t), the margin and the check period; out [K, n] f32,
// iters [n] i32.
struct EarlyStop {
  int k, t_iters, freq;
  float margin;
  float* out;
  int* iters;
};

// the first check at or after iteration t0 + 1 (checks follow
// iterations freq, 2 freq, ...)
__device__ __forceinline__ int next_check(int t0, int freq) {
  return (t0 / freq + 1) * freq;
}

// ES "trees" mode: a block walks a row at a time, `chunk` iterations'
// K trees a pass, a tree a thread; thread 0 adds the pass in iteration
// and class order into the K sums (a register for K = 1, else shared
// memory after the pass's values), checks the margin after every
// freq-th iteration and stops the row at its freeze. On its own (list
// null) block r takes row r from iteration 0. As the tail of rows mode
// it takes the rows of `list` (*count_in of them, and only when they are
// at most tail_rows: rows mode walked them otherwise), block after block
// over a fixed grid, from iteration `start` and the sums in es.out.
template <class D, bool kBinary>
__global__ void __launch_bounds__(512)
early_stop_trees_kernel(D d, Forest f, const int4* __restrict__ rec,
                        const float* __restrict__ x, int n, int nf,
                        int chunk, int start, const int* __restrict__ list,
                        const int* __restrict__ count_in, int tail_rows,
                        EarlyStop es) {
  extern __shared__ float vals[];
  __shared__ int frozen_at;
  const int K = kBinary ? 1 : es.k;
  float* sums = vals + K * chunk;
  const int M = f.max_nodes;
  const int count = list == nullptr ? n : *count_in;
  if (list != nullptr && count > tail_rows) return;
  for (int v = blockIdx.x; v < count; v += gridDim.x) {
    const int g = list == nullptr ? v : __ldg(list + v);
    const size_t cell0 = (size_t)g * nf;
    const float* row = x + cell0;
    float acc = 0.f;
    if (threadIdx.x == 0) {
      frozen_at = 0;
      if (kBinary) {
        acc = start == 0 ? 0.f : es.out[g];
      } else {
        for (int c = 0; c < K; ++c) {
          sums[c] = start == 0 ? 0.f : es.out[(size_t)c * n + g];
        }
      }
    }
    __syncthreads();
    for (int t0 = start; t0 < es.t_iters; t0 += chunk) {
      const int cn = min(chunk, es.t_iters - t0);
      for (int i = threadIdx.x; i < K * cn; i += blockDim.x) {
        const int c = kBinary ? 0 : i / cn;
        const int t = c * es.t_iters + t0 + (i - c * cn);
        const int leaf = walk_tree<D, false, false>(
            d, f, t, rec + (size_t)t * M, nullptr, 0, 0, cell0, row, true);
        vals[i] = tree_value(f, t, leaf, row);
      }
      __syncthreads();
      if (threadIdx.x == 0) {
        int check = next_check(t0, es.freq);
        for (int tt = 0; tt < cn; ++tt) {
          if (kBinary) {
            acc = __fadd_rn(acc, vals[tt]);
          } else {
            for (int c = 0; c < K; ++c) {
              sums[c] = __fadd_rn(sums[c], vals[c * cn + tt]);
            }
          }
          if (t0 + tt + 1 == check) {
            check += es.freq;
            const float m =
                kBinary ? 2.f * fabsf(acc) : class_margin(sums, K, 1);
            if (!(m <= es.margin)) {
              frozen_at = t0 + tt + 1;
              break;
            }
          }
        }
      }
      __syncthreads();
      if (frozen_at) break;
    }
    if (threadIdx.x == 0) {
      if (kBinary) {
        es.out[g] = acc;
      } else {
        for (int c = 0; c < K; ++c) es.out[(size_t)c * n + g] = sums[c];
      }
      es.iters[g] = frozen_at ? frozen_at : es.t_iters;
    }
    __syncthreads();
  }
}

// ES "rows" mode, one round: the iterations [round * round_iters,
// + round_iters) of the rows still live. Round 0 takes every row, a
// block blockDim.x of them in order; a later round takes its rows from
// list_in, whose length the last round counted in *count_in (blocks past
// it return at once, and all of them when that length is at most
// tail_rows: the trees-mode tail takes those rows on from here). A block
// stages its rows (kRows: their first nfs columns, feature-major), loads
// their K sums from es.out, and walks the live ones a thread each,
// `chunk` iterations at a time (kTrees: their K runs of records through
// two shared buffers; else read from device memory, freq iterations a
// chunk). After each chunk every thread whose row is still live writes
// it to the other local list at its rank (its lane's in the warp's
// ballot, after the live rows of the warps before), so the list keeps
// its order and the warps past the live count sit the next chunk out.
// At the round's end the block writes its sums back and appends its
// live rows to list_out (*count_out counts them), or, after the last
// iteration, marks them as having walked every iteration. A frozen row's
// iteration count goes to es.iters as it freezes. Rounds keep a block's
// life to the rows that are live in its window, so blocks of the rows
// still live fill the SMs again each round. Shared: [records][sums K x
// threads][row ids][two local lists][warp totals][staged rows].
template <class D, bool kRows, bool kTrees>
__global__ void __launch_bounds__(512)
early_stop_rows_kernel(D d, Forest f, const int4* __restrict__ rec,
                       const float* __restrict__ x, int n, int nf, int nfs,
                       int chunk, int round, int round_iters,
                       int tail_rows, const int* __restrict__ list_in,
                       const int* __restrict__ count_in,
                       int* __restrict__ list_out, int* __restrict__ count_out,
                       EarlyStop es) {
  using Value = typename D::Value;
  extern __shared__ __align__(16) unsigned char smem[];
  const int R = blockDim.x, M = f.max_nodes, K = es.k;
  const int first = blockIdx.x * R;
  const int count = round == 0 ? n : *count_in;
  if (first >= count || (round > 0 && count <= tail_rows)) return;
  const int rows_here = min(R, count - first);
  const int a = round * round_iters;
  const int b = min(es.t_iters, a + round_iters);
  const int C = kTrees ? chunk : min(es.freq, es.t_iters);
  const int buf_records = kTrees ? K * C * M : 0;
  int4* buf = reinterpret_cast<int4*>(smem);
  float* sums = reinterpret_cast<float*>(smem + 32 * (size_t)buf_records);
  int* ids = reinterpret_cast<int*>(sums + (size_t)K * R);
  int* lists = ids + R;
  int* warp_live = lists + 2 * R;
  Value* xs = reinterpret_cast<Value*>(warp_live + kMaxWarps);
  const int stride = staged_stride<Value>(R);
  if (kTrees) {
    stage_runs(buf, rec + (size_t)a * M, K, min(C, b - a) * M, C * M,
               (size_t)es.t_iters * M);
  }
  const int i0 = threadIdx.x;
  const int g0 = i0 < rows_here
                     ? (round == 0 ? first + i0 : __ldg(list_in + first + i0))
                     : 0;
  ids[i0] = g0;
  lists[i0] = i0;
  for (int c = 0; c < K; ++c) {
    sums[c * R + i0] =
        round == 0 || i0 >= rows_here ? 0.f : es.out[(size_t)c * n + g0];
  }
  __syncthreads();
  if (kRows) {
    for (int e = threadIdx.x; e < rows_here * nfs; e += R) {
      const int i = e / nfs, j = e - i * nfs;
      xs[j * stride + i] = d.load((size_t)ids[i] * nf + j);
    }
    __syncthreads();
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  int live = rows_here, cur = 0;
  const int chunks = (b - a + C - 1) / C;
  for (int ci = 0; ci < chunks && live > 0; ++ci) {
    const int t0 = a + ci * C, cn = min(C, b - t0);
    const int4* recs = rec;
    if (kTrees) {
      if (ci + 1 < chunks) {
        stage_runs(buf + ((ci + 1) & 1) * buf_records,
                   rec + (size_t)(t0 + C) * M, K,
                   min(C, b - t0 - C) * M, C * M, (size_t)es.t_iters * M);
        wait_records<1>();
      } else {
        wait_records<0>();
      }
      __syncthreads();
      recs = buf + (ci & 1) * buf_records;
    }
    const int* list = lists + cur * R;
    int* next = lists + (cur ^ 1) * R;
    const bool has_row = (int)threadIdx.x < live;
    const int r = has_row ? list[threadIdx.x] : 0;
    bool alive = has_row;
    if (has_row) {
      const size_t cell0 = (size_t)ids[r] * nf;
      const float* row = x + cell0;
      int check = next_check(t0, es.freq);
      for (int tt = 0; tt < cn; ++tt) {
        for (int c = 0; c < K; ++c) {
          const int t = c * es.t_iters + t0 + tt;
          const int4* tree = kTrees ? recs + (size_t)(c * C + tt) * M
                                    : recs + (size_t)t * M;
          const int leaf = walk_tree<D, kTrees, kRows>(
              d, f, t, tree, xs, stride, r, cell0, row, true);
          float& sum = sums[c * R + r];
          sum = __fadd_rn(sum, tree_value(f, t, leaf, row));
        }
        if (t0 + tt + 1 == check) {
          check += es.freq;
          if (!(class_margin(sums + r, K, R) <= es.margin)) {
            es.iters[ids[r]] = t0 + tt + 1;
            alive = false;
            break;
          }
        }
      }
    }
    // the live rows' ranks: a lane's in its warp's ballot, after the
    // live rows of the warps before
    const unsigned ballot = __ballot_sync(0xffffffffu, alive);
    if (lane == 0) warp_live[warp] = __popc(ballot);
    __syncthreads();
    int at = __popc(ballot & ((1u << lane) - 1u));
    live = 0;
    for (int w = 0; w < (R >> 5); ++w) {
      const int cnt = warp_live[w];
      at += w < warp ? cnt : 0;
      live += cnt;
    }
    if (alive) next[at] = r;
    cur ^= 1;
    __syncthreads();
  }
  if (kTrees) wait_records<0>();
  if (i0 < rows_here) {
    for (int c = 0; c < K; ++c) es.out[(size_t)c * n + g0] = sums[c * R + i0];
  }
  if (live == 0) return;
  const int* list = lists + cur * R;
  if (b == es.t_iters) {
    for (int v = threadIdx.x; v < live; v += R) es.iters[ids[list[v]]] = b;
    return;
  }
  __shared__ int base;
  if (threadIdx.x == 0) base = atomicAdd(count_out, live);
  __syncthreads();
  for (int v = threadIdx.x; v < live; v += R) {
    list_out[base + v] = ids[list[v]];
  }
}

template <typename Kernel>
cudaError_t allow_shared(Kernel kernel, int smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

// The walk's arguments past the decision and the forest. `leaf` and
// `tile_trees`: K2's output and its rows-mode tile (null and 0 for K1
// and QW).
struct WalkArgs {
  const int4* rec;
  const float* x;
  int n, nf, threads, chunk_trees, staged_features, smem, tree_batch,
      epilogue;
  float denom, bias, sigmoid;
  float* out;
  cudaStream_t stream;
  int* leaf = nullptr;
  int tile_trees = 0;
};

// the kernels' `out` and `tree_batch`: K2's leaves and tile trees
template <bool kLeaf>
float* out_of(const WalkArgs& a) {
  return kLeaf ? reinterpret_cast<float*>(a.leaf) : a.out;
}

template <class D, bool kF16, bool kRows, bool kTrees, bool kLeaf>
cudaError_t launch_rows(const D& d, const Forest& f, const WalkArgs& a) {
  auto kernel = value_rows_kernel<D, kF16, kRows, kTrees, kLeaf>;
  cudaError_t err = allow_shared(kernel, a.smem);
  if (err != cudaSuccess) return err;
  kernel<<<(a.n + a.threads - 1) / a.threads, a.threads, a.smem,
           a.stream>>>(d, f, a.rec, a.x, a.n, a.nf, a.staged_features,
                       a.chunk_trees, kLeaf ? a.tile_trees : a.tree_batch,
                       a.epilogue, a.denom, a.bias, a.sigmoid,
                       out_of<kLeaf>(a));
  return cudaGetLastError();
}

// K1 and QW (kLeaf false) or K2 (kLeaf true, f32 leaves unread)
template <class D, bool kF16, bool kLeaf = false>
cudaError_t launch_mode(int mode, const D& d, const Forest& f,
                        const WalkArgs& a) {
  if (mode == kModeTrees) {
    value_trees_kernel<D, kF16, kLeaf><<<a.n, a.threads, a.smem, a.stream>>>(
        d, f, a.rec, a.x, a.nf, a.chunk_trees, a.tree_batch, a.epilogue,
        a.denom, a.bias, a.sigmoid, out_of<kLeaf>(a));
    return cudaGetLastError();
  }
  const bool staged_rows = a.staged_features >= 0;
  const bool staged_trees = a.chunk_trees > 0;
  auto launch =
      staged_rows
          ? (staged_trees ? launch_rows<D, kF16, true, true, kLeaf>
                          : launch_rows<D, kF16, true, false, kLeaf>)
          : (staged_trees ? launch_rows<D, kF16, false, true, kLeaf>
                          : launch_rows<D, kF16, false, false, kLeaf>);
  return launch(d, f, a);
}

// The multiprocessors of the current device (read once).
inline int device_sms(int& sms) {
  static int cached = 0;
  if (cached == 0) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess) {
      err = cudaDeviceGetAttribute(&cached, cudaDevAttrMultiProcessorCount,
                                   dev);
    }
    if (err != cudaSuccess) return (int)err;
  }
  sms = cached;
  return 0;
}

// ES's rows-mode rounds and the tail that takes their rows on.
struct EarlyStopRounds {
  int round_iters;   // iterations a rows-mode launch walks
  int tail_rows;     // live rows at a round's start the tail takes on
  int tail_threads;  // the tail's threads a block
  int tail_chunk;    // the tail's iterations a pass
  int* scratch;      // two lists of n row ids, then a count a round
};

// ES's rows mode: the rounds of round_iters iterations, a rows-mode
// launch each and, from round 1, a trees-mode launch that takes the
// round's rows on once they are few (one of the two finds nothing to do;
// a persistent grid of blocks a multiprocessor); the counts zeroed first.
template <class D, bool kRows, bool kTrees>
cudaError_t launch_es_rows(const D& d, const Forest& f, const WalkArgs& a,
                           const EarlyStop& es, const EarlyStopRounds& q) {
  auto kernel = early_stop_rows_kernel<D, kRows, kTrees>;
  cudaError_t err = allow_shared(kernel, a.smem);
  if (err != cudaSuccess) return err;
  auto tail = es.k == 1 ? early_stop_trees_kernel<D, true>
                        : early_stop_trees_kernel<D, false>;
  const int tail_smem = (es.k * q.tail_chunk + es.k) * 4;
  err = allow_shared(tail, tail_smem);
  if (err != cudaSuccess) return err;
  int sms = 0;
  const int sm_err = device_sms(sms);
  if (sm_err != 0) return (cudaError_t)sm_err;
  const int tail_blocks = sms * (2048 / q.tail_threads);
  const int rounds = (es.t_iters + q.round_iters - 1) / q.round_iters;
  int* lists[2] = {q.scratch, q.scratch + a.n};
  int* counts = q.scratch + 2 * (size_t)a.n;
  err = cudaMemsetAsync(counts, 0, sizeof(int) * rounds, a.stream);
  if (err != cudaSuccess) return err;
  const int blocks = (a.n + a.threads - 1) / a.threads;
  for (int r = 0; r < rounds; ++r) {
    kernel<<<blocks, a.threads, a.smem, a.stream>>>(
        d, f, a.rec, a.x, a.n, a.nf, a.staged_features, a.chunk_trees, r,
        q.round_iters, q.tail_rows, lists[r & 1],
        counts + (r > 0 ? r - 1 : 0), lists[(r + 1) & 1], counts + r, es);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    if (r == 0) continue;
    tail<<<tail_blocks, q.tail_threads, tail_smem, a.stream>>>(
        d, f, a.rec, a.x, a.n, a.nf, q.tail_chunk, r * q.round_iters,
        lists[r & 1], counts + r - 1, q.tail_rows, es);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

// ES in the plan's mode (chunk_trees: iterations a pass or a chunk)
template <class D>
cudaError_t launch_early_stop(int mode, const D& d, const Forest& f,
                              const WalkArgs& a, const EarlyStop& es,
                              const EarlyStopRounds& q) {
  if (mode == kModeTrees) {
    auto kernel = es.k == 1 ? early_stop_trees_kernel<D, true>
                            : early_stop_trees_kernel<D, false>;
    cudaError_t err = allow_shared(kernel, a.smem);
    if (err != cudaSuccess) return err;
    kernel<<<a.n, a.threads, a.smem, a.stream>>>(
        d, f, a.rec, a.x, a.n, a.nf, a.chunk_trees, 0, nullptr, nullptr, 0,
        es);
    return cudaGetLastError();
  }
  const bool staged_rows = a.staged_features >= 0;
  const bool staged_trees = a.chunk_trees > 0;
  auto launch = staged_rows
                    ? (staged_trees ? launch_es_rows<D, true, true>
                                    : launch_es_rows<D, true, false>)
                    : (staged_trees ? launch_es_rows<D, false, true>
                                    : launch_es_rows<D, false, false>);
  return launch(d, f, a, es, q);
}

// 0 when a plan (ops/predict.py WalkPlan) fits the kernels' limits for
// values of type Value, else the error code to return without a launch.
// K2's plan (a.leaf set) has no trees-mode shared memory and a rows-mode
// tile of tile_trees leaves a row (a multiple of a staged chunk).
template <typename Value>
int plan_error(const Forest& f, int mode, const WalkArgs& a) {
  if (a.threads < 32 || a.threads > 512 || a.threads % 32 != 0 ||
      a.smem < 0 || a.smem > kSharedBudget || a.tree_batch < 1 ||
      a.chunk_trees < 0) {
    return (int)cudaErrorInvalidValue;
  }
  const bool leaf = a.leaf != nullptr;
  if (mode == kModeTrees) {
    return a.chunk_trees < 1 || (!leaf && a.smem < a.chunk_trees * 4)
               ? (int)cudaErrorInvalidValue
               : 0;
  }
  if (mode != kModeRows) return (int)cudaErrorInvalidValue;
  if (leaf && (a.tile_trees < 1 ||
               (a.chunk_trees > 0 && a.tile_trees % a.chunk_trees != 0))) {
    return (int)cudaErrorInvalidValue;
  }
  const long need =
      (a.chunk_trees > 0 ? 2L * a.chunk_trees * f.max_nodes * 16 : 0) +
      (leaf ? 4L * a.threads * (a.tile_trees + 1) : 0) +
      (a.staged_features >= 0 ? (long)sizeof(Value) * a.staged_features *
                                    staged_stride<Value>(a.threads)
                              : 0);
  return need > a.smem || a.staged_features > a.nf
             ? (int)cudaErrorInvalidValue
             : 0;
}

// 0 when ES's plan and arguments fit early_stop_*_kernel, else the error
// code to return without a launch
inline int early_stop_plan_error(const Forest& f, int mode,
                                 const WalkArgs& a, const EarlyStop& es,
                                 const EarlyStopRounds& q) {
  if (es.k < 1 || es.k > kMaxClasses || es.freq < 1 || es.t_iters < 1 ||
      es.k * es.t_iters != f.num_trees || a.threads < 32 ||
      a.threads > 32 * kMaxWarps || a.threads % 32 != 0 || a.smem < 0 ||
      a.smem > kSharedBudget || a.chunk_trees < 0) {
    return (int)cudaErrorInvalidValue;
  }
  if (mode == kModeTrees) {
    return a.chunk_trees < 1 || a.smem < (es.k * a.chunk_trees + es.k) * 4
               ? (int)cudaErrorInvalidValue
               : 0;
  }
  if (mode != kModeRows || q.round_iters < 1 || q.scratch == nullptr ||
      q.tail_rows < 0 || q.tail_threads < 32 || q.tail_threads > 512 ||
      q.tail_threads % 32 != 0 || q.tail_chunk < 1 ||
      (es.k * q.tail_chunk + es.k) * 4 > kSharedBudget) {
    return (int)cudaErrorInvalidValue;
  }
  const long need =
      (a.chunk_trees > 0 ? 2L * es.k * a.chunk_trees * f.max_nodes * 16
                         : 0) +
      4L * (es.k + 3) * a.threads + 4L * kMaxWarps +
      (a.staged_features >= 0
           ? 4L * a.staged_features * staged_stride<float>(a.threads)
           : 0);
  return need > a.smem || a.staged_features > a.nf
             ? (int)cudaErrorInvalidValue
             : 0;
}

}  // namespace lgbt_records
