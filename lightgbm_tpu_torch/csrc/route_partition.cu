// Kernel R, route_partition, of lightgbm_tpu_torch: apply one split to
// the rows of a leaf, and the train-score update, built for sm_90a by
// ops/_build.py and called through ctypes from ops/route.py.
//
// Replaces lightgbm_tpu/learner/grow.py expand.route (:1037-1072) and
// the score update of lightgbm_tpu/boosting/gbdt.py:185-190. The JAX
// grower relabels every row of the matrix with a vectorised where per
// split; the port keeps the reference's DataPartition instead
// (data_partition.hpp:94-170): a permutation of the row ids in which
// each leaf owns a contiguous segment. A split touches only its leaf's
// segment: per row, decode the feature's bin from its EFB group, take
// go_left exactly as grow.py:1052-1065 (categorical equality, NaN / zero
// missing to default_left, else bin <= threshold), write leaf_id = left
// or right slot, and reorder the segment stably, left rows first.
//
// One launch a split (partition_kernel), cooperative, so that all its
// blocks are resident at once (the grid is capped at what fits the
// card: cudaLaunchCooperativeKernel refuses more). Block b owns a
// contiguous run of the segment's rows, a multiple of 32, one pass of
// kThreads rows unless the segment is larger than the resident blocks'
// one pass each:
// 1. route: per row, the bin read and go_left; leaf_id written; a warp's
//    32 left flags become one ballot word, stored to a bit array; the
//    block's left count goes to block_left[b];
// 2. one grid-wide barrier, none for a grid of one block (a 64-bit word,
//    generation << 32 | arrivals, integer atomics after __threadfence;
//    the last arrival zeroes the count and moves the generation in one
//    add, so the word needs no reset between launches);
// 3. each block adds block_left[0..b) (its left rows' first place) and
//    all of them (the segment's left count, written to count_out by
//    block 0), in block order;
// 4. scatter: the block walks its rows again in the same order (the row
//    ids read again, mostly from L2), a row's place from its warp's
//    ballot word (popcounts of the warps before it and of the lanes
//    before the row); left rows go to [0, left), right rows after them
//    in order, into the destination segment.
// Everything is integer, so the result is exact and the same every run.
// The destination is another buffer than the source (a barrier cannot
// order one block's writes before another block's reads of the same
// rows without a second one): the grower keeps two permutation buffers
// and tracks which one holds each leaf's segment (learner/grow.py); the
// in-place entry of ops/route.py scatters into a temporary and copies
// back. The bins are read at binned + r * row_stride + group *
// group_stride, so a row-major [N, G] matrix and a column-major copy
// (the JAX grower's binned_T) go through the same code.
//
// Bound on an H100 (3.35 TB/s), per split of an m-row segment: read m
// row ids and m group bins, write m row ids and m leaf ids, 13 bytes a
// row with uint8 bins (26 MB, 0.0078 ms, for the root's 2,000,000 rows;
// chip_smoke.py counts the same), 14 with uint16 (Bosch root, 500,000
// rows: 7 MB, 0.0021 ms). The old route, scan, scatter and copy read
// the leaf ids back and copied the segment once more (12 bytes a row),
// in four device operations. What bounds it now (PERF.md): at a large
// segment the bin read, one byte or two gathered a row, a 32-byte sector
// a row in a row-major matrix wherever the rows are dense (the root: the
// whole 56 MB HIGGS matrix; a column-major copy reads m bytes there); at
// a small one, most of a tree's splits, the launch and a chain of
// dependent loads (ids, bins, then the barrier's and the counts'
// round trips through L2).
//
// The score update adds leaf_value[leaf_id[r]] * shrinkage to score[r]
// as one fused multiply-add, rounded once: the JAX package computes it
// inside one XLA program (gbdt.py:185-190), whose CPU backend contracts
// the multiply and the add. The plain version rounds the same way
// (ops/route.py fma_f32).
//
// The average mode of the score update (RF) replaces the running average
// of lightgbm_tpu/boosting/rf.py:87-96, score = (score * t + contrib) /
// (t + 1), contrib = leaf_value[leaf_id[r]] for the train score, or a
// row's value from W (into a zero buffer) for a valid score. The JAX
// package runs it eagerly: each *, + and / is its own XLA call and is
// rounded on its own. So the kernel rounds each one (__fmul_rn,
// __fadd_rn, __fdiv_rn, and -fmad=false for the rest): bitwise the JAX
// expression and the plain version. Bound: 12 bytes a row with leaf ids
// (score read and written, leaf id read), 24 MB at 2,000,000 rows,
// 0.0072 ms; a division a row is far below the card's rate.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
// the most blocks a launch takes (block_left's length in the scratch)
constexpr int kMaxBlocks = 4096;
// scratch ints before the flags: the barrier's two words, block_left
constexpr int kScratchHead = 2 + kMaxBlocks;
constexpr int kMissingZero = 1;
constexpr int kMissingNan = 2;
// the score updates' block
constexpr int kScoreThreads = 256;

struct Split {
  int group, offset, num_bin, default_bin, missing, bundled;
  int threshold, default_left, is_cat, left_slot, right_slot;
};

__device__ __forceinline__ bool go_left(const Split& s, int col) {
  if (s.bundled) {
    const bool in_slice = col >= s.offset && col < s.offset + s.num_bin;
    col = in_slice ? col - s.offset : s.default_bin;
  }
  if (s.is_cat) return col == s.threshold;
  const bool missing = (s.missing == kMissingNan && col == s.num_bin - 1) ||
                       (s.missing == kMissingZero && col == s.default_bin);
  return missing ? s.default_left != 0 : col <= s.threshold;
}

// Every block of the (cooperative, so co-resident) grid waits here until
// all have arrived. bar: generation << 32 | arrivals; the last to arrive
// sets the arrivals back to 0 and moves the generation on in one add, so
// the word needs no reset between launches.
__device__ __forceinline__ void grid_barrier(unsigned long long* bar) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    const unsigned long long old = atomicAdd(bar, 1ull);
    if ((unsigned)old == gridDim.x - 1) {
      atomicAdd(bar, (1ull << 32) - gridDim.x);
    } else {
      volatile unsigned long long* word = bar;
      while ((*word >> 32) == (old >> 32)) __nanosleep(32);
    }
    __threadfence();
  }
  __syncthreads();
}

// The sum of v over the block's threads (integer: any order is exact).
__device__ __forceinline__ int block_sum(int v, int* warp_part) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(~0u, v, o);
  __syncthreads();
  if (threadIdx.x % 32 == 0) warp_part[threadIdx.x / 32] = v;
  __syncthreads();
  int total = 0;
  for (int w = 0; w < kWarps; ++w) total += warp_part[w];
  return total;
}

// src: the segment's m row ids; dst: where the reordered segment goes
// (not src); block b owns rows [b * per_block, (b + 1) * per_block),
// per_block a multiple of 32; flags: one bit a row; block_left: a left
// count a block; bar: the barrier's word.
template <typename BinT>
__global__ void __launch_bounds__(kThreads)
partition_kernel(const BinT* __restrict__ binned, long long row_stride,
                 long long group_stride, const int* __restrict__ src,
                 int* __restrict__ dst, int m, Split s,
                 int* __restrict__ leaf_id, int* block_left,
                 unsigned* flags, unsigned long long* bar, int* count_out,
                 int per_block) {
  __shared__ int warp_part[kWarps];
  __shared__ int warp_cnt[kWarps];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int r0 = blockIdx.x * per_block;
  const int r1 = min(m, r0 + per_block);
  const BinT* col = binned + (long long)s.group * group_stride;
  // 1. route, flags, the block's left count
  int mine = 0;
  for (int i0 = r0; i0 < r1; i0 += kThreads) {
    const int i = i0 + threadIdx.x;
    bool left = false;
    if (i < r1) {
      const int r = __ldg(src + i);
      left = go_left(s, __ldg(col + (long long)r * row_stride));
      leaf_id[r] = left ? s.left_slot : s.right_slot;
    }
    const unsigned word = __ballot_sync(~0u, left);
    const int w0 = i0 + warp * 32;
    if (lane == 0 && w0 < r1) flags[w0 / 32] = word;
    mine += left ? 1 : 0;
  }
  const int total_here = block_sum(mine, warp_part);
  // 2-3. every block's count in place; the left rows before this block
  // and the segment's left count (a grid of one block has them)
  int before = 0, all = total_here;
  if (gridDim.x > 1) {
    if (threadIdx.x == 0) block_left[blockIdx.x] = total_here;
    grid_barrier(bar);
    all = 0;
    for (int j = threadIdx.x; j < (int)gridDim.x; j += kThreads) {
      const int v = __ldcg(block_left + j);
      all += v;
      before += j < (int)blockIdx.x ? v : 0;
    }
    before = block_sum(before, warp_part);
    all = block_sum(all, warp_part);
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) *count_out = all;
  // 4. scatter, a pass of kThreads rows at a time in row order
  for (int i0 = r0; i0 < r1; i0 += kThreads) {
    const int i = i0 + threadIdx.x;
    const int w0 = i0 + warp * 32;
    const unsigned word = w0 < r1 ? flags[w0 / 32] : 0u;
    if (lane == 0) warp_cnt[warp] = __popc(word);
    __syncthreads();
    int lb = before;
    for (int w = 0; w < warp; ++w) lb += warp_cnt[w];
    lb += __popc(word & ((1u << lane) - 1u));
    if (i < r1) {
      const int r = __ldg(src + i);
      dst[(word >> lane) & 1u ? lb : all + (i - lb)] = r;
    }
    for (int w = 0; w < kWarps; ++w) before += warp_cnt[w];
    __syncthreads();
  }
}

__global__ void score_kernel(float* __restrict__ score,
                             const int* __restrict__ leaf_id,
                             const float* __restrict__ value,
                             float shrinkage, int n) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r < n) {
    score[r] = __fmaf_rn(__ldg(value + __ldg(leaf_id + r)), shrinkage,
                         score[r]);
  }
}

// score[r] = (score[r] * t + c) / (t + 1), c = value[leaf_id[r]], or
// value[r] when leaf_id is NULL; each operation rounded on its own
__global__ void score_average_kernel(float* __restrict__ score,
                                     const int* __restrict__ leaf_id,
                                     const float* __restrict__ value,
                                     float t, float t1, int n) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r < n) {
    const float c = __ldg(value + (leaf_id ? __ldg(leaf_id + r) : r));
    score[r] = __fdiv_rn(__fadd_rn(__fmul_rn(score[r], t), c), t1);
  }
}

// The most co-resident blocks of partition_kernel<BinT> on the current
// card (0 when the card cannot launch it cooperatively), found once.
template <typename BinT>
int resident_blocks() {
  static int blocks = -1;
  if (blocks < 0) {
    int dev = 0, sms = 0, per_sm = 0, coop = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess ||
        cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev) !=
            cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, partition_kernel<BinT>, kThreads, 0) != cudaSuccess) {
      return 0;
    }
    blocks = coop ? min(sms * per_sm, kMaxBlocks) : 0;
  }
  return blocks;
}

template <typename BinT>
int launch_partition(const void* binned, long long row_stride,
                     long long group_stride, const int* src, int* dst, int m,
                     const Split& s, int* leaf_id, int* scratch,
                     int* count_out, cudaStream_t st) {
  const int cap = resident_blocks<BinT>();
  if (cap < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  // a pass of kThreads rows a block at the least (more blocks timed
  // faster than each block's rows loaded in several passes at once);
  // more rows a block where the segment exceeds what the resident blocks
  // hold in one pass
  int blocks = min((m + kThreads - 1) / kThreads, cap);
  const int per_block = ((m + blocks - 1) / blocks + 31) / 32 * 32;
  blocks = (m + per_block - 1) / per_block;
  const BinT* bins = static_cast<const BinT*>(binned);
  unsigned long long* bar = reinterpret_cast<unsigned long long*>(scratch);
  int* block_left = scratch + 2;
  unsigned* flags = reinterpret_cast<unsigned*>(scratch + kScratchHead);
  void* args[] = {&bins,       &row_stride, &group_stride,
                  &src,        &dst,        &m,
                  const_cast<Split*>(&s),   &leaf_id,
                  &block_left, &flags,      &bar,
                  &count_out,  const_cast<int*>(&per_block)};
  return (int)cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(partition_kernel<BinT>), blocks,
      kThreads, args, 0, st);
}

}  // namespace

// The scratch ints one split of up to m rows takes: the barrier's word
// (two ints, 0 before the first launch; each launch leaves the count at
// 0), a left count a block, then a flag bit a row.
extern "C" int lgbt_route_scratch_ints(int m) {
  return kScratchHead + (m + 31) / 32;
}

// binned: u8 or (u16 != 0) u16 bins, group g of row r at binned + r *
// row_stride + g * group_stride (elements). Split the segment src[0, m)
// (row ids) by the split s: leaf_id of its rows becomes left_slot or
// right_slot, and dst[0, m) (another buffer) receives the segment
// reordered stably, left rows first. The left count goes to *count_out.
// scratch: lgbt_route_scratch_ints(m) ints, its first two words 0 when
// first used. One cooperative launch; nothing synchronises.
extern "C" int lgbt_route_partition(
    const void* binned, long long row_stride, long long group_stride,
    int u16, const int* src, int* dst, int m, int group, int offset,
    int num_bin, int default_bin, int missing, int bundled, int threshold,
    int default_left, int is_cat, int left_slot, int right_slot,
    int* leaf_id, int* scratch, int* count_out, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (m <= 0) return (int)cudaMemsetAsync(count_out, 0, sizeof(int), st);
  if (src == dst) return (int)cudaErrorInvalidValue;
  const Split s{group,     offset,       num_bin, default_bin,
                missing,   bundled,      threshold, default_left,
                is_cat,    left_slot,    right_slot};
  return u16 ? launch_partition<uint16_t>(binned, row_stride, group_stride,
                                          src, dst, m, s, leaf_id, scratch,
                                          count_out, st)
             : launch_partition<uint8_t>(binned, row_stride, group_stride,
                                         src, dst, m, s, leaf_id, scratch,
                                         count_out, st);
}

// score[r] = fma(value[leaf_id[r]], shrinkage, score[r]) for r < n
// (value: the tree's f32 leaf values before shrinkage).
extern "C" int lgbt_score_update(float* score, const int* leaf_id,
                                 const float* value, float shrinkage, int n,
                                 void* stream) {
  if (n <= 0) return 0;
  score_kernel<<<(n + kScoreThreads - 1) / kScoreThreads, kScoreThreads,
                 0, (cudaStream_t)stream>>>(score, leaf_id, value,
                                            shrinkage, n);
  return (int)cudaGetLastError();
}

// score[r] = (score[r] * t + c) / t1 for r < n, with t1 = t + 1 in f32
// and c = value[leaf_id[r]], or value[r] when leaf_id is NULL.
extern "C" int lgbt_score_average(float* score, const int* leaf_id,
                                  const float* value, float t, float t1,
                                  int n, void* stream) {
  if (n <= 0) return 0;
  score_average_kernel<<<(n + kScoreThreads - 1) / kScoreThreads,
                         kScoreThreads, 0, (cudaStream_t)stream>>>(
      score, leaf_id, value, t, t1, n);
  return (int)cudaGetLastError();
}

extern "C" const char* lgbt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
