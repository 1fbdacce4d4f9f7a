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
// pointers of its own row, and all three kernels do, over the Forest's
// 16-byte node records in the two modes of forest_records.cuh.
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
// So each node is one 16-byte record and K1 has two modes, a block a
// row with its trees in parallel ("trees") and a row a thread over rows
// and records staged in shared memory ("rows"): the kernels of
// forest_records.cuh, instantiated here on RawDecision (the f32
// threshold in the record's first word, the rows' f32 values), which QW
// instantiates on the codes.
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
// K2 forest_leaf_walk: the [N, T] int32 leaf of every (row, tree), the
// same walks with a leaf output (value_*_kernel's kLeaf): in trees mode
// each thread stores its tree's leaf at out[row * T + t], so a warp's
// stores are consecutive words; in rows mode the block collects a
// chunk's leaves in a shared tile and writes it out a row at a time,
// where the thread-a-row walk of the [T, M] arrays stored a lane a
// sector (2,000 B apart at T = 500). Bound, at the chip_smoke shape: the
// walk's operations as K1's (0.262 ms) over its 524 MB of leaves
// (0.157 ms at 3.35 TB/s).
//
// ES forest_early_stop_walk: margin-based per-row early stop over a
// [K, T] stack (K classes, T iterations; tree (c, t) at c * T + t).
// Replaces predict_forest_raw_early_stop (:957), a lax.while_loop that
// walks iteration t's K trees for all rows in lockstep, freezes a row
// whose margin exceeds `margin` after every freq-th iteration (2|raw|
// for K = 1, top-1 minus top-2 of the K sums for K >= 2) and stops when
// every row is frozen. Here a row adds iteration t's K tree values in
// class order, checks the margin after iterations freq, 2 freq, ... and
// stops at its freeze (forest_records.cuh early_stop_*_kernel: a block a
// row with a pass of iterations walked in parallel, or a row a thread
// over staged rows and records with the live rows compacted after every
// chunk). A frozen row's sums are exactly the JAX function's (it adds
// 0.0 to a frozen row, which leaves an f32 sum that cannot be -0
// unchanged), so the two agree bitwise. Linear forests add the leaf's
// linear term (linear_term.cuh), as predict_value_raw (:193) does, and
// stage nothing in rows mode (K1's rule). Bound as K1 over the trees
// each row actually walks (data dependent): the row's iterations until
// it froze times K. The thread-a-row walk of the [T, M] arrays it
// replaces kept a warp until its last row froze and took 4.95 ms at the
// chip_smoke shape (31% of K1's node visits; PERF.md).

#include <cuda_runtime.h>
#include <stdint.h>

#include "forest_node.cuh"
#include "forest_records.cuh"

using namespace lgbt_forest;

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
  using namespace lgbt_records;
  const Forest f = LGBT_MAKE_FOREST;
  const WalkArgs a{static_cast<const int4*>(records), x, n, nf, threads,
                   chunk_trees, staged_features, smem, tree_batch, epilogue,
                   denom, bias, sigmoid, out, (cudaStream_t)stream};
  const int err = plan_error<float>(f, mode, a);
  if (err != 0) return err;
  const RawDecision d{x};
  return (int)(f16 ? launch_mode<RawDecision, true>(mode, d, f, a)
                   : launch_mode<RawDecision, false>(mode, d, f, a));
}

// K2: leaf [n, T] i32; the plan's tile_trees leaves a row a rows-mode
// tile (ops/predict.py walk_plan(..., output="leaf")).
extern "C" int lgbt_forest_leaf_walk(LGBT_FOREST_ARGS, const void* records,
                                     int mode, int threads, int chunk_trees,
                                     int staged_features, int smem,
                                     int tile_trees, int* leaf,
                                     void* stream) {
  using namespace lgbt_records;
  const Forest f = LGBT_MAKE_FOREST;
  WalkArgs a{static_cast<const int4*>(records), x, n, nf, threads,
             chunk_trees, staged_features, smem, 1, kRaw, 1.f, 0.f, 1.f,
             nullptr, (cudaStream_t)stream};
  a.leaf = leaf;
  a.tile_trees = tile_trees;
  if (leaf == nullptr) return (int)cudaErrorInvalidValue;
  const int err = plan_error<float>(f, mode, a);
  if (err != 0) return err;
  return (int)launch_mode<RawDecision, false, true>(mode, RawDecision{x}, f,
                                                    a);
}

// ES: out [k, n] f32, iters [n] i32 over a [k, T / k] stack; the plan's
// chunk_trees counts iterations; in rows mode round_iters the
// iterations of a launch and the trees-mode tail's row count, threads
// and pass (ops/predict.py walk_plan(..., output="early_stop")), and
// scratch 2 n + rounds ints; scratch null in trees mode.
extern "C" int lgbt_forest_early_stop_walk(LGBT_FOREST_ARGS,
                                           const void* records, int mode,
                                           int threads, int chunk_trees,
                                           int staged_features, int smem,
                                           int round_iters, int tail_rows,
                                           int tail_threads, int tail_chunk,
                                           int k, float margin, int freq,
                                           float* out, int* iters,
                                           int* scratch, void* stream) {
  using namespace lgbt_records;
  const Forest f = LGBT_MAKE_FOREST;
  const WalkArgs a{static_cast<const int4*>(records), x, n, nf, threads,
                   chunk_trees, staged_features, smem, 1, kRaw, 1.f, 0.f,
                   1.f, out, (cudaStream_t)stream};
  if (k < 1 || num_trees % k != 0) return (int)cudaErrorInvalidValue;
  const EarlyStop es{k, num_trees / k, freq, margin, out, iters};
  const EarlyStopRounds q{round_iters, tail_rows, tail_threads, tail_chunk,
                          scratch};
  const int err = early_stop_plan_error(f, mode, a, es, q);
  if (err != 0) return err;
  return (int)launch_early_stop(mode, RawDecision{x}, f, a, es, q);
}

extern "C" const char* lgbt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
