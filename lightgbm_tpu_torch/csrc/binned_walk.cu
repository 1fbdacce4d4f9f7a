// Kernel W, tree_value_walk_binned, of lightgbm_tpu_torch: add one
// tree's value to every row's score, or write every row's leaf, walking
// the tree in the stored-group bin space of a binned matrix; built for
// sm_90a by ops/_build.py and called through ctypes from ops/predict.py.
//
// Replaces lightgbm_tpu/ops/predict.py predict_value_binned (:182) and
// predict_leaf_binned (:87) with _decide_binned (:75) and _in_bitset
// (:63), which the JAX trainer runs once per tree on every valid set
// (boosting/gbdt.py:1563-1581), and on the train set to drop, re-weigh
// or roll back a tree and to replay a loaded model.
//
// A node is one 16-byte record (ops/predict.py walk_records), its EFB
// decode folded into group-bin space when the tree is packed on the
// host: x the group | flags << 28, y the node's bin range lo | span <<
// 16, z its test, w the children (int16 each, ~leaf below 0). A group
// bin b is in range when r = b - lo, unsigned, is at most span: a
// bundled feature's slice [offset, offset + num_bin), all of it for an
// unbundled numeric one. Out of range the node sends b where
// _decide_binned sends the feature's default bin (kOutLeft). In range, a
// numeric node (z = t | s << 16) sends r to default_left when r is its
// missing bin s, else left when r <= t (kNoneLeft: no bin goes left); a
// categorical one reads bit r of its own bitset (z its first word), a
// copy of the tree's bin-space bitset re-based to the range and padded
// with zeros, or of z itself where the range holds at most 32 bins
// (kInline, the bit kNoneLeft is on a numeric node). So each decision is
// the JAX function's for every group bin (tests/test_torch_walk_plan.py
// pins it over all of them) with one 16-byte load a level, where the
// record of eleven int32 fields cost eleven scattered loads and the
// decode a level.
//
// Each block first copies the tree's records and bitsets into shared
// memory (4 KB for 255 leaves), so a level's record load is one
// ld.shared.v4 whatever node each lane is at; a tree past the plan's
// budget is read from device memory (ld.global.nc.v4) instead. A thread
// walks one row. The bins come row-major or column-major (group g of row
// r at r * row_stride + g * group_stride). Where rows are wide the
// callers hand W a column-major copy (ops/predict.py walk_layout: the
// booster's of each valid set, the grower's of the train matrix), where
// the lanes of a warp at the same node read one group's bins of 32
// consecutive rows, a sector or two, instead of a sector a row: on the
// Bosch valid set (676-byte rows, a 255-leaf tree 48 levels deep, 23 on
// average) that halves the time. A narrow row (HIGGS' 28 bytes) stays
// row-major: its sector stays in L1 for the whole walk, where a column
// costs a sector a level. Speculating a level ahead (both children's
// bins loaded before the decision), staging the rows in shared memory
// and two rows a thread were timed on the card too, and were slower or
// no faster (PERF.md, PR 18).
//
// The value is added as the plain version adds it, score[r] +=
// leaf_value[leaf], one f32 add, so the two agree bitwise; leaf mode
// writes the leaf.
//
// Bound on an H100 (3.35 TB/s): the bins the walk must read (one group
// bin a level of each row's path) and the f32 score read and written
// (value mode) or the int32 leaf written (leaf mode); chip_smoke.py
// counts it from the run's trees and rows. For the HIGGS valid set
// (262,144 rows x 28 uint8 groups, 9.1 levels a row): 262,144 x (9.1 +
// 8) bytes, 4.5 MB, 0.0013 ms.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr uint32_t kGroupMask = (1u << 28) - 1;
constexpr uint32_t kCat = 1u << 31;
constexpr uint32_t kDefaultLeft = 1u << 30;
constexpr uint32_t kOutLeft = 1u << 29;
constexpr uint32_t kNoneLeft = 1u << 28;
constexpr uint32_t kInline = kNoneLeft;  // on a categorical node

// which way record rec sends group bin b (the words of the node's
// bitsets from `bits`)
__device__ __forceinline__ bool goes_left(const uint4 rec, int b,
                                          const uint32_t* bits) {
  const uint32_t r = (uint32_t)b - (rec.y & 0xFFFFu);
  if (r > (rec.y >> 16)) return (rec.x & kOutLeft) != 0;
  if (rec.x & kCat) {
    const uint32_t word =
        (rec.x & kInline) ? rec.z : bits[rec.z + (r >> 5)];
    return (word >> (r & 31)) & 1u;
  }
  if (r == (rec.z >> 16)) return (rec.x & kDefaultLeft) != 0;
  return r <= (rec.z & 0xFFFFu) && !(rec.x & kNoneLeft);
}

__device__ __forceinline__ int child(const uint4 rec, bool left) {
  return left ? (int)(int16_t)(rec.w & 0xFFFFu)
              : (int)(int16_t)(rec.w >> 16);
}

// kShared: the tree's records and bitsets staged in shared memory
template <typename BinT, bool kShared>
__global__ void __launch_bounds__(kThreads)
walk_kernel(const BinT* __restrict__ binned, long long row_stride,
            long long group_stride, int n, const uint4* __restrict__ recs,
            int num_rec, const uint32_t* __restrict__ bits, int num_bits,
            const float* __restrict__ leaf_value, float* __restrict__ score,
            int* __restrict__ leaf_out) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint4* s_rec = reinterpret_cast<uint4*>(smem);
  uint32_t* s_bits = reinterpret_cast<uint32_t*>(s_rec + num_rec);
  if (kShared) {
    for (int i = threadIdx.x; i < num_rec; i += kThreads)
      s_rec[i] = __ldg(recs + i);
    for (int i = threadIdx.x; i < num_bits; i += kThreads)
      s_bits[i] = __ldg(bits + i);
    __syncthreads();
  }
  const uint4* rec_at = kShared ? s_rec : recs;
  const uint32_t* bits_at = kShared ? s_bits : bits;
  const long long r = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (r >= n) return;
  const BinT* row = binned + r * row_stride;
  int node = num_rec > 0 ? 0 : -1;
  if (node == 0) {
    uint4 rec = rec_at[0];
    while (true) {
      const int b = (int)__ldg(row + (rec.x & kGroupMask) * group_stride);
      node = child(rec, goes_left(rec, b, bits_at));
      if (node < 0) break;
      rec = rec_at[node];
    }
  }
  if (leaf_out) {
    leaf_out[r] = ~node;
  } else {
    score[r] += __ldg(leaf_value + ~node);
  }
}

template <typename BinT, bool kShared>
int launch(const void* binned, long long row_stride, long long group_stride,
           int n, const uint4* recs, int num_rec, const uint32_t* bits,
           int num_bits, int smem_bytes, const float* leaf_value,
           float* score, int* leaf_out, cudaStream_t s) {
  auto kernel = walk_kernel<BinT, kShared>;
  if (smem_bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (err != cudaSuccess) return (int)err;
  }
  const int blocks = (int)(((long long)n + kThreads - 1) / kThreads);
  kernel<<<blocks, kThreads, smem_bytes, s>>>(
      static_cast<const BinT*>(binned), row_stride, group_stride, n, recs,
      num_rec, bits, num_bits, leaf_value, score, leaf_out);
  return (int)cudaGetLastError();
}

template <typename BinT>
int launch_any(const void* binned, long long row_stride,
               long long group_stride, int n, const uint4* recs, int num_rec,
               const uint32_t* bits, int num_bits, int smem_bytes,
               const float* leaf_value, float* score, int* leaf_out,
               cudaStream_t s) {
  return smem_bytes > 0
             ? launch<BinT, true>(binned, row_stride, group_stride, n, recs,
                                  num_rec, bits, num_bits, smem_bytes,
                                  leaf_value, score, leaf_out, s)
             : launch<BinT, false>(binned, row_stride, group_stride, n, recs,
                                   num_rec, bits, num_bits, 0, leaf_value,
                                   score, leaf_out, s);
}

}  // namespace

// binned: u8, or u16 when u16 != 0, group g of row r at r * row_stride +
// g * group_stride (elements); recs [num_rec] 16-byte records (num_rec
// 0: a one-leaf tree); bits [num_bits] the nodes' re-based bitsets;
// smem_bytes: the records and bitsets staged in that much dynamic
// shared memory, or read from device memory when 0 (ops/predict.py
// binned_walk_plan); leaf_value [L] f32; score [n] f32, added to in
// place; or, when leaf_out [n] i32 is not NULL, the rows' leaves written
// there and score untouched. Returns cudaGetLastError().
extern "C" int lgbt_tree_value_walk_binned(
    const void* binned, long long row_stride, long long group_stride,
    int u16, int n, const int* recs, int num_rec, const uint32_t* bits,
    int num_bits, int smem_bytes, const float* leaf_value, float* score,
    int* leaf_out, void* stream) {
  if (n <= 0) return 0;
  const uint4* r4 = reinterpret_cast<const uint4*>(recs);
  cudaStream_t s = (cudaStream_t)stream;
  return u16 ? launch_any<uint16_t>(binned, row_stride, group_stride, n, r4,
                                    num_rec, bits, num_bits, smem_bytes,
                                    leaf_value, score, leaf_out, s)
             : launch_any<uint8_t>(binned, row_stride, group_stride, n, r4,
                                   num_rec, bits, num_bits, smem_bytes,
                                   leaf_value, score, leaf_out, s);
}

extern "C" const char* lgbt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
