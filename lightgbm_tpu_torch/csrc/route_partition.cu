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
// segment:
// 1. route: per row of the segment, decode the feature's bin from its
//    EFB group, take go_left exactly as grow.py:1052-1065 (categorical
//    equality, NaN / zero missing to default_left, else bin <=
//    threshold), write leaf_id = left or right slot, and count the
//    left rows of each tile;
// 2. a single block scans the tile counts (exclusive, in tile order);
// 3. each tile scans its rows' left flags (warp ballots, then the warps
//    in order) and writes the row ids to their stable places, left rows
//    first, into a scratch segment, which is then copied back.
// Everything is integer, so the result is exact and the same every run.
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
//
// Bound on an H100 (3.35 TB/s), per split of an m-row segment: read m
// row ids, m group bins and m leaf ids, write m leaf ids and 2m row ids,
// ~21 bytes a row (42 MB, 0.013 ms, for the root's 2,000,000 rows). The
// bin reads gather one byte a row with a stride of G, so they cost a
// 32-byte sector each: the kernel sits well above that bound until the
// matrix is kept column-major as well.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 2048;  // rows of the segment a block owns
constexpr int kMissingZero = 1;
constexpr int kMissingNan = 2;

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

__global__ void route_kernel(const uint8_t* __restrict__ binned, int G,
                             const int* __restrict__ perm, int begin, int m,
                             Split s, int* __restrict__ leaf_id,
                             int* __restrict__ tile_left) {
  __shared__ int warp_sum[kThreads / 32];
  const int t0 = blockIdx.x * kTile;
  int mine = 0;
  for (int i = t0 + threadIdx.x; i < min(m, t0 + kTile); i += kThreads) {
    const int r = __ldg(perm + begin + i);
    const bool left = go_left(s, __ldg(binned + (size_t)r * G + s.group));
    leaf_id[r] = left ? s.left_slot : s.right_slot;
    mine += left ? 1 : 0;
  }
  for (int o = 16; o > 0; o >>= 1) mine += __shfl_down_sync(~0u, mine, o);
  if (threadIdx.x % 32 == 0) warp_sum[threadIdx.x / 32] = mine;
  __syncthreads();
  if (threadIdx.x == 0) {
    int total = 0;
    for (int w = 0; w < kThreads / 32; ++w) total += warp_sum[w];
    tile_left[blockIdx.x] = total;
  }
}

// exclusive prefix of the tile counts, in tile order; tile_left[tiles]
// (and *count_out, when given) receives the segment's left count
__global__ void scan_tiles_kernel(int* __restrict__ tile_left, int tiles,
                                  int* __restrict__ count_out) {
  if (threadIdx.x != 0) return;
  int run = 0;
  for (int t = 0; t < tiles; ++t) {
    const int v = tile_left[t];
    tile_left[t] = run;
    run += v;
  }
  tile_left[tiles] = run;
  if (count_out) *count_out = run;
}

__global__ void scatter_kernel(const int* __restrict__ perm, int begin,
                               int m, int left_slot,
                               const int* __restrict__ leaf_id,
                               const int* __restrict__ tile_left, int tiles,
                               int* __restrict__ out) {
  __shared__ int warp_cnt[kThreads / 32];
  __shared__ int base_left;
  const int t0 = blockIdx.x * kTile;
  const int total_left = tile_left[tiles];
  if (threadIdx.x == 0) base_left = tile_left[blockIdx.x];
  __syncthreads();
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  // rows t0 + k*kThreads + threadIdx.x, k = 0.. in order; running left
  // count of the rows before this pass kept in base_left
  for (int k0 = t0; k0 < min(m, t0 + kTile); k0 += kThreads) {
    const int i = k0 + threadIdx.x;
    const bool valid = i < m;
    int r = 0;
    bool left = false;
    if (valid) {
      r = __ldg(perm + begin + i);
      left = leaf_id[r] == left_slot;
    }
    const unsigned ballot = __ballot_sync(~0u, left);
    const int before_in_warp = __popc(ballot & ((1u << lane) - 1u));
    if (lane == 0) warp_cnt[warp] = __popc(ballot);
    __syncthreads();
    int before = base_left;
    for (int w = 0; w < warp; ++w) before += warp_cnt[w];
    before += before_in_warp;
    if (valid) {
      // left rows before i: before; right rows before i: i - before
      const int pos = left ? before : total_left + (i - before);
      out[pos] = r;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      int add = 0;
      for (int w = 0; w < kThreads / 32; ++w) add += warp_cnt[w];
      base_left += add;
    }
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

}  // namespace

extern "C" int lgbt_route_tiles(int m) { return (m + kTile - 1) / kTile; }

// Split the segment perm[begin, begin+m) by the split s: leaf_id of its
// rows becomes left_slot or right_slot, and the segment is reordered
// stably, left rows first. scratch: tiles + 1 ints for the counts, then
// m ints for the reordered segment. The left count ends in
// scratch[tiles] and, when count_out is not NULL, in *count_out.
extern "C" int lgbt_route_partition(
    const uint8_t* binned, int G, int* perm, int begin, int m, int group,
    int offset, int num_bin, int default_bin, int missing, int bundled,
    int threshold, int default_left, int is_cat, int left_slot,
    int right_slot, int* leaf_id, int* scratch, int* count_out,
    void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (m <= 0) {
    if (count_out) return (int)cudaMemsetAsync(count_out, 0, sizeof(int), st);
    return 0;
  }
  const Split s{group,     offset,       num_bin, default_bin,
                missing,   bundled,      threshold, default_left,
                is_cat,    left_slot,    right_slot};
  const int tiles = lgbt_route_tiles(m);
  int* tile_left = scratch;
  int* seg = scratch + tiles + 1;
  route_kernel<<<tiles, kThreads, 0, st>>>(binned, G, perm, begin, m, s,
                                           leaf_id, tile_left);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  scan_tiles_kernel<<<1, 32, 0, st>>>(tile_left, tiles, count_out);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  scatter_kernel<<<tiles, kThreads, 0, st>>>(perm, begin, m, left_slot,
                                             leaf_id, tile_left, tiles, seg);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  err = cudaMemcpyAsync(perm + begin, seg, (size_t)m * sizeof(int),
                        cudaMemcpyDeviceToDevice, st);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// score[r] = fma(value[leaf_id[r]], shrinkage, score[r]) for r < n
// (value: the tree's f32 leaf values before shrinkage).
extern "C" int lgbt_score_update(float* score, const int* leaf_id,
                                 const float* value, float shrinkage, int n,
                                 void* stream) {
  if (n <= 0) return 0;
  score_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0,
                 (cudaStream_t)stream>>>(score, leaf_id, value, shrinkage,
                                         n);
  return (int)cudaGetLastError();
}

// score[r] = (score[r] * t + c) / t1 for r < n, with t1 = t + 1 in f32
// and c = value[leaf_id[r]], or value[r] when leaf_id is NULL.
extern "C" int lgbt_score_average(float* score, const int* leaf_id,
                                  const float* value, float t, float t1,
                                  int n, void* stream) {
  if (n <= 0) return 0;
  score_average_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0,
                         (cudaStream_t)stream>>>(score, leaf_id, value, t,
                                                 t1, n);
  return (int)cudaGetLastError();
}

extern "C" const char* lgbt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
