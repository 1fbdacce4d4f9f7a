// Kernel W, tree_value_walk_binned, of lightgbm_tpu_torch: add one
// tree's value to every row's score, walking the tree in bin space,
// built for sm_90a by ops/_build.py and called through ctypes from
// ops/predict.py.
//
// Replaces lightgbm_tpu/ops/predict.py predict_value_binned (:182) with
// predict_leaf_binned (:87) and _decide_binned (:75), which the JAX
// trainer runs once per tree on every valid set (and on the train set
// to roll a tree back). The TPU walks all rows in lockstep, one gather
// per level; here one thread walks its row down the tree, reading the
// row's group bin at each node, decoding the feature's bin out of its
// EFB group, and deciding as _decide_binned does (NaN / zero missing to
// default_left, categorical bitsets in bin space, else bin <=
// threshold). It then adds the leaf's f32 value to the row's score: one
// add, the same the plain version makes, so the two agree exactly.
//
// Bound on an H100 (3.35 TB/s): read G bytes of bins a row (only the
// depth-many the walk touches, one 32-byte sector each), read and write
// the f32 score; the tree itself (a few KB) stays in L1. For the
// 262,144-row valid set of the main path: 262,144 x (28 + 8) bytes,
// 9.4 MB, 0.003 ms.
//
// Leaf mode (leaf_out not NULL): the same walk writes each row's leaf
// index instead of adding a value, for linear trees, whose valid-set
// value LA then computes from the leaf and the row's raw values
// (lightgbm_tpu/boosting/gbdt.py:1563-1581: predict_leaf_binned, then
// linear_leaf_addend). Bound: G bytes of bins read, 4 written a row.
//
// A uint16 matrix (groups past 256 bins) takes the same walk on two-byte
// bins (walk_kernel<uint16_t>), in both modes. For the Bosch valid set
// (100,000 rows x 338 groups) the bound counts the bins the walk reads
// (depth-many a row), the score read and written, or the leaf written:
// chip_smoke.py computes it from the run's own trees.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 256;
constexpr int kMissingZero = 1;
constexpr int kMissingNan = 2;
// node record fields (int32, kFields a node)
enum {
  kGroup, kOffset, kNumBin, kBundled, kDefaultBin, kNanBin, kMissing,
  kThreshold, kFlags, kLeft, kRight, kFields
};
constexpr int kDefaultLeftFlag = 1;
constexpr int kCategoricalFlag = 2;

template <typename BinT>
__global__ void walk_kernel(const BinT* __restrict__ binned, int G, int n,
                            const int* __restrict__ nodes, int num_leaves,
                            const int* __restrict__ cat_bounds,
                            const uint32_t* __restrict__ cat_bits,
                            int cat_words,
                            const float* __restrict__ leaf_value,
                            float* __restrict__ score,
                            int* __restrict__ leaf_out) {
  const int r = blockIdx.x * kBlock + threadIdx.x;
  if (r >= n) return;
  const BinT* row = binned + (size_t)r * G;
  int node = num_leaves > 1 ? 0 : -1;
  while (node >= 0) {
    const int* nd = nodes + node * kFields;
    int bin = __ldg(row + __ldg(nd + kGroup));
    if (__ldg(nd + kBundled)) {
      const int off = __ldg(nd + kOffset);
      bin = (bin >= off && bin < off + __ldg(nd + kNumBin))
                ? bin - off
                : __ldg(nd + kDefaultBin);
    }
    const int flags = __ldg(nd + kFlags);
    const int thr = __ldg(nd + kThreshold);
    bool left;
    if (flags & kCategoricalFlag) {
      const int idx = thr > 0 ? thr : 0;
      const int lo = __ldg(cat_bounds + idx);
      const int words = __ldg(cat_bounds + idx + 1) - lo;
      const int w = bin >> 5;
      left = false;
      if (w < words) {
        int at = lo + w;
        at = at < 0 ? 0 : (at >= cat_words ? cat_words - 1 : at);
        left = (__ldg(cat_bits + at) >> (bin & 31)) & 1u;
      }
    } else {
      const int missing = __ldg(nd + kMissing);
      const bool is_missing =
          (missing == kMissingNan && bin == __ldg(nd + kNanBin)) ||
          (missing == kMissingZero && bin == __ldg(nd + kDefaultBin));
      left = is_missing ? (flags & kDefaultLeftFlag) != 0 : bin <= thr;
    }
    node = left ? __ldg(nd + kLeft) : __ldg(nd + kRight);
  }
  if (leaf_out) {
    leaf_out[r] = ~node;
  } else {
    score[r] += __ldg(leaf_value + ~node);
  }
}

}  // namespace

// binned [n, G] u8, or u16 when u16 != 0; nodes [max(num_leaves-1, 1), 11] int32 records;
// cat_bounds [C+2] / cat_bits [W] the bin-space bitsets; leaf_value
// [num_leaves] f32; score [n] f32, added to in place; or, when
// leaf_out [n] i32 is not NULL, the rows' leaves written there and
// score untouched.
extern "C" int lgbt_tree_value_walk_binned(
    const void* binned, int G, int u16, int n, const int* nodes,
    int num_leaves, const int* cat_bounds, const uint32_t* cat_bits,
    int cat_words, const float* leaf_value, float* score, int* leaf_out,
    void* stream) {
  if (n <= 0) return 0;
  const int blocks = (n + kBlock - 1) / kBlock;
  cudaStream_t s = (cudaStream_t)stream;
  if (u16) {
    walk_kernel<uint16_t><<<blocks, kBlock, 0, s>>>(
        static_cast<const uint16_t*>(binned), G, n, nodes, num_leaves,
        cat_bounds, cat_bits, cat_words, leaf_value, score, leaf_out);
  } else {
    walk_kernel<uint8_t><<<blocks, kBlock, 0, s>>>(
        static_cast<const uint8_t*>(binned), G, n, nodes, num_leaves,
        cat_bounds, cat_bits, cat_words, leaf_value, score, leaf_out);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* lgbt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
