// Kernel H, leaf_histogram, of lightgbm_tpu_torch: per (group, bin) the
// sums (g*w, h*w, count of rows with w > 0) over a set of rows of a
// uint8 or uint16 binned matrix, built for sm_90a by ops/_build.py and
// called through ctypes from ops/histogram.py.
//
// Replaces, in lightgbm_tpu/ops/histogram.py: leaf_histogram (:333, all
// rows), gathered_leaves_histogram (:474, a compacted row list) and
// batched_leaves_histogram (:402, rows whose leaf_id is one of C ids;
// with _contract_blocks / _accumulate_chunks / _onehot, :230-282): the
// serial grower keeps each leaf's rows contiguous in its permutation, so
// the rows of one leaf id reach the kernel as a row list. The TPU turns
// the scatter-add into a one-hot matmul because its matrix unit is what
// it has; on a GPU the scatter-add itself is cheap when it lands in
// shared memory without contention, so the kernel scatters.
//
// Design (the same bits on every run, no float atomics; ops/histogram.py
// hist_plan and hist_wide_plan compute the launch plans on the host from
// the shape alone, and leaf_histogram_order replays the summation order
// in torch ops). Every sum is an f64 chain of the rows' values (g*w and
// h*w in f32 mode; in hi+lo mode hi + lo, which f64 holds exactly, so one
// chain sums both halves), rounded to f32 once; counts are integers. Two
// passes read the rows, one a kind of group, then at most one reduction:
// - lane-private (hist_lane_kernel; every group of a uint8 matrix, and
//   a uint16 matrix's groups of at most 351 bins, hist_layout's
//   `narrow`): a block takes warps * run consecutive
//   positions of the row sequence (0..n-1, or rows[0..n-1]) and a slice
//   of up to 32 groups; its warp w takes a run of `run` positions, and
//   lane l of the warp owns group l of the slice. Per 32 positions the
//   lanes read the 32 rows' channels once and broadcast them by
//   shuffles; each owner lane reads its group's bin of every row (a warp
//   reads a row's bins as one contiguous run) and adds the row into its
//   own column of the warp's shared histogram ([ch][bins + 1][gw lanes],
//   20 bytes a slot: g and h in f64, a uint32 count), four rows'
//   read-add-writes at once in row order; a row a lane does not add goes
//   to the column's sentinel bin. The block adds its warps in warp order.
//   The row blocks are sized so that all slices together make about one
//   block an SM (at the Bosch root 126 blocks and 6.1 MB of partials: as
//   many a slice would write 57 MB);
// - warp-shared (hist_claim_kernel; a uint16 matrix's groups too wide
//   for 32 private columns, up to 2,048 bins: Bosch's 631, max_bin=1023):
//   block (tile, slice) takes a tile of positions and a slice of W
//   groups; warp w owns group w of the slice and ONE histogram of it (24
//   bytes a bin: g and h in f64, a uint32 count and a claim word). The
//   block stages 256 rows at a time in shared memory (the slice's bins of
//   a row read together, and each row's two values and count flag, split
//   and added back in f64 once a row), the next chunk's loads in flight
//   while this one is added; per 32 staged rows the warp's lanes claim
//   their bins in rounds (an integer atomicMin of the lane into the bin's
//   claim word), and the lowest pending lane of each bin adds, so each
//   (tile, group, bin) adds the tile's rows in row order. Short tiles
//   (below 8,192 rows, hist_wide_plan) go in thread-block clusters of up
//   to 8 tiles of a slice, which add their histograms through
//   distributed shared memory in rank order before writing one partial.
//   The plan gives a block as many groups as keep the most warps on an
//   SM (two blocks an SM) and the grid to about one wave, so a tile's
//   slices read its rows out of L2 together, and a row's sector and
//   channels are read once a slice of groups, not once a group;
// - a path of one row block (one cluster) writes its sums, rounded, into
//   the output at once; otherwise the blocks (clusters) write f64
//   partials (lane: [blocks][3][bw][slices * gw]; warp-shared:
//   [clusters][group][3][wide_w]) and one launch of hist_sum_kernel adds
//   both paths' partials: a warp takes four adjacent words of one path,
//   its lane 4s + j adds blocks s, s + 8, ... of word j in order (chain
//   s, from +0), and the chains close in the shuffle tree ((0+4)+(2+6)) +
//   ((1+5)+(3+7)); every SM takes part. On a uint16 matrix the output is
//   first zeroed (cudaMemsetAsync): the bins past each group's width stay
//   0.
// So a call is one to three kernels (and the memset on a uint16 matrix).
//
// Bound on an H100 SXM (3.35 TB/s): every input byte read once: the
// group bins of the rows (G bytes a row, 2 G on a uint16 matrix), 12
// bytes of channels a row, 4 more a row for a row list, and the [G, B,
// 3] output: at the HIGGS root (2,000,000 rows x 28 groups) 80 MB, 0.024
// ms; at the Bosch root (500,000 x 338, B 631) 344 MB, 0.1035 ms; at the
// max_bin=1023 root (2,000,000 x 28, B 1023) 136 MB, 0.0407 ms.
// chip_smoke.py computes the bound of each measured call from its own
// shape. What sets the time instead (PERF.md): the lane kernel's
// serial chains of shared read-add-writes over the few warps whose f64
// columns fit an SM; the warp-shared kernel's claim rounds, which are
// bound by shared-memory wavefronts (random bins conflict in the banks:
// an atomic, a claim read and write and four f64 accesses a round), and,
// on small calls, each launch's fixed cost.
//
// The hi+lo mode (tpu_hist_bf16, the JAX package's default): the bf16
// branch of the same three functions, with _hi_lo (:52). Each row's g*w
// and h*w are split into hi = bf16(v) and lo = bf16(v - f32(hi)), rounded
// as XLA's CPU backend rounds (ops/histogram.py hi_lo); the JAX package
// sums the halves apart in f32 and adds them after all rows (:394-396),
// the port adds hi + lo a row in f64. The split reads no more bytes, so
// the bound is H's.
//
// The uint16 modes (groups of more than 256 bins, the JAX package's
// uint16 matrix: efb.py:96-99, ingest/build.py:116; its H functions are
// dtype-generic and pad every group to the widest): the same sums in
// both modes, with each group at its own width (group_num_bin).
//
// Kernel HQ, leaf_histogram_i32, the quantized-training mode
// (tpu_hist_quantize=int8|int16): per (group, bin) the int32 sums
// (q_g*w01, q_h*w01, w01) of the quantizer's int16 codes over a set of
// rows. Replaces, in lightgbm_tpu/ops/histogram.py, the quantized
// channels of leaf_histogram (:333) and gathered_leaves_histogram
// (:474): _quant_u (:291) splits int16 codes into base-256 bf16 digits
// so the TPU's matrix unit sums them exactly, and _quant_merge (:316)
// recombines the digits in int32. Hopper adds int32 natively, so HQ adds
// the codes themselves.
//
// Design (no thread reads a row at a stride of G, and no block flushes a
// slice of groups for every few thousand rows):
// - a plan made once for a Dataset (ops/histogram.py i32_plan) cuts the
//   groups into slices of consecutive groups whose int32 histogram fits
//   100 KB of shared memory (two blocks of 8 warps an SM): groups of at
//   most 266 bins interleaved by lane (a bin's words of 32 lanes in 32
//   banks), wider ones packed at their own widths; and it picks each
//   group's skipped bin, the one most rows hold;
// - the grid is (slices) x (row blocks), about 264 blocks (ops/histogram
//   i32_grid), each row block a contiguous run of at least 512 positions
//   of the row sequence, and only as many as keep the partials below
//   twice the rows' bytes, so a small row list launches few blocks. In a
//   block a lane owns a slot (a group) of the slice: a warp takes 32 rows
//   a turn, lane j loads row j's codes and w01 (and id, from a row list)
//   once and the lanes broadcast them by shuffles, then, 32 groups at a
//   time, each lane loads its group's bin of the rows (a warp reads a
//   row's bins of 32 groups as one contiguous run) and adds every row
//   outside its group's skipped bin into the block's histogram with
//   shared integer atomics, three a row: no lane shares a word with
//   another at once in the interleaved layout, and a row the lane does
//   not add goes to three spare words of its own, so no atomic is under
//   a branch. A slice of at most 16 (8) groups takes 2 (4) rows at once,
//   a phase of its lanes each, so few groups still fill the warp;
// - the skipped bin: every row holds one bin of each group below the
//   group's width, so in int32 that bin is exactly the rows' totals
//   (sum q_g, sum q_h, count), which the block sums once a row, minus the
//   group's other bins;
// - each block writes its histogram once, in the shared layout, to its
//   row block's partial, and a second kernel adds the row blocks'
//   partials (coalesced reads, an xs-way split of the row blocks) into
//   the zeroed [G, B, 3] output with integer atomics.
// What sets the time: the instructions a (row, 32 groups) takes, a bin
// load, two shuffles, the tests and the three atomics, not the bytes
// (chip_smoke.py phase 41 times it against its bound).
// Integer addition is associative, so the result has the same bits on
// every run; the caller keeps qmax * rows below 2^31 (train_qmax), so
// nothing overflows. Bound on an H100 SXM (3.35 TB/s): G bytes of bins
// (2 G on a uint16 matrix), 4 bytes of codes and 4 of w01 a row (4 more
// for a row list) and the [G, B, 3] output: at the HIGGS root
// (2,000,000 x 28 uint8) 72 MB, 0.021 ms; at the Bosch root (500,000 x
// 338 uint16, B 631) 342 MB, 0.102 ms; at the max_bin=1023 root
// (2,000,000 x 28 uint16) 128 MB, 0.038 ms.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kLanes = 32;
// the shared memory a block of the lane-private kernel may take
// (ops/histogram.py HIST_SMEM_BYTES): 5 warps at B = 64 (41.6 KB a warp)
constexpr int kHistSmem = 220 * 1024;
// warps of a lane-private block at most (HIST_MAX_WARPS)
constexpr int kMaxWarps = 8;
// the warp-shared kernel: groups (warps) a block at most, rows staged a
// chunk and the shared memory a block may take (HIST_WIDE_WARPS,
// HIST_STAGE_ROWS, HIST_WIDE_SMEM_BYTES: the card's 227 KB)
constexpr int kWideWarps = 16;
constexpr int kStageRows = 256;
constexpr int kStageData = kStageRows / kLanes;  // rows a staging thread
constexpr int kWideSmem = 227 * 1024;
// tiles a cluster at most (HIST_MAX_CLUSTER)
constexpr int kMaxCluster = 8;
// the reduction: chains a sum (HIST_CHAINS), words a warp, threads a block
constexpr int kChains = 8;
constexpr int kQuad = kLanes / kChains;
constexpr int kSumThreads = 256;

constexpr float kF32MinNormal = 1.17549435e-38f;

// a subnormal as the zero of its sign, as XLA's CPU backend reads and
// writes them in arithmetic
__device__ __forceinline__ float flush_subnormal(float x) {
  return fabsf(x) < kF32MinNormal ? __fmul_rn(x, 0.f) : x;
}

// f32 -> bf16 -> f32 as XLA's CPU convert rounds it: to nearest, ties to
// even, subnormals kept, overflow to inf, a NaN to the quiet NaN of its
// sign (ops/histogram.py bf16_round)
__device__ __forceinline__ float bf16_round(float x) {
  const uint32_t u = __float_as_uint(x);
  if (isnan(x)) return __uint_as_float((u & 0x80000000u) | 0x7FC00000u);
  return __uint_as_float((u + 0x7FFFu + ((u >> 16) & 1u)) & 0xFFFF0000u);
}

// lightgbm_tpu/ops/histogram.py _hi_lo (:52) as XLA's CPU backend
// computes it (ops/histogram.py hi_lo)
__device__ __forceinline__ void hi_lo(float w, float& hi, float& lo) {
  hi = bf16_round(w);
  lo = bf16_round(flush_subnormal(
      __fsub_rn(flush_subnormal(w), flush_subnormal(hi))));
}

// a row's g*w or h*w as the sums add it: in f64, and in hi+lo mode as
// f64(hi) + f64(lo), which is exact
template <bool HILO>
__device__ __forceinline__ double row_value(float v) {
  if constexpr (HILO) {
    float hi, lo;
    hi_lo(v, hi, lo);
    return (double)hi + (double)lo;
  } else {
    return (double)v;
  }
}

// The lane-private scheme (every group of a uint8 matrix; a uint16
// matrix's groups narrow enough, hist_layout's `narrow`): block (x, y)
// takes the row positions [x * warps * run, (x + 1) * warps * run) of the
// row sequence and slice y of the group list, groups y * gw ..
// y * gw + gw - 1 of it; warp w takes the run of `run` positions from
// (x * warps + w) * run on, and its lane l owns the slice's group l
// (lanes gw..31 own none when gw < 32). Per 32 positions, lane j reads
// the row of position j (its channels, split into hi and lo halves once
// in hi+lo mode), the lanes broadcast them in turn, and each owner lane
// adds the row into its group's column of the warp's shared histogram,
// rows in order: one f64 chain a (run, group, bin), and the lanes never
// collide because they own different columns. A warp's histogram
// is [2][words] f64 sums, then [words] uint32 counts; words = (bw + 1) *
// gw rounded up to even, 20 bytes a slot (ops/histogram.py
// HIST_SLOT_BYTES). Then the warps' histograms are added in warp order,
// in f64: with one row block (gridDim.x == 1) rounded into out at once,
// else into the block's partial, f64 words laid out [blocks][3][bw][nsp]
// (nsp = slices * gw, the count last) so that both the writes here and
// the reduction's reads are coalesced.
template <bool HILO, typename BinT>
__global__ void __launch_bounds__(kMaxWarps * kLanes)
hist_lane_kernel(const BinT* __restrict__ binned, int G,
                 const float* __restrict__ w3, const int* __restrict__ rows,
                 int n, const int* __restrict__ glist, int n_list,
                 const int* __restrict__ widths, int bw, int gw, int run,
                 int B, double* __restrict__ part, float* __restrict__ out) {
  constexpr int kAcc = 2;    // g and h
  constexpr int kGroup = 4;  // rows whose read-add-writes overlap
  extern __shared__ __align__(16) unsigned char smem[];
  const int warps = blockDim.x / kLanes;
  const int warp = threadIdx.x / kLanes;
  const int lane = threadIdx.x % kLanes;
  // one channel of one warp: bw bins and a sentinel bin that takes the
  // rows a lane does not add, so every add below is unconditional
  const int words = ((bw + 1) * gw + 1) / 2 * 2;
  const size_t warp_bytes = (size_t)words * (kAcc * 8 + 4);
  double* h = reinterpret_cast<double*>(smem + warp * warp_bytes);
  uint32_t* hc = reinterpret_cast<uint32_t*>(h + kAcc * words);
  {
    // zero every warp's histogram, 16 bytes a store and a 4-byte tail
    const int all = (int)(warps * warp_bytes / 4);
    float* hist = reinterpret_cast<float*>(smem);
    for (int e = threadIdx.x; e < all / 4; e += blockDim.x) {
      reinterpret_cast<float4*>(hist)[e] = make_float4(0.f, 0.f, 0.f, 0.f);
    }
    for (int e = all / 4 * 4 + threadIdx.x; e < all; e += blockDim.x) {
      hist[e] = 0.f;
    }
  }
  const int slot = blockIdx.y * gw + lane;
  const bool owner = lane < gw && slot < n_list;
  const int g = owner ? (glist ? __ldg(glist + slot) : slot) : 0;
  const int width = owner ? (widths ? __ldg(widths + g) : bw) : 0;
  const int col = lane & (gw - 1);  // a lane past gw adds to a sentinel
  __syncthreads();

  const long long begin = ((long long)blockIdx.x * warps + warp) * run;
  const long long end = min((long long)n, begin + run);
  // the row of position p, clamped into the run: every load below is
  // unconditional, so all of a turn's loads can be in flight at once,
  // and the positions past the run are masked where they are added
  auto row_of = [&](long long p) {
    p = min(p, end - 1);
    return rows ? __ldg(rows + p) : (int)p;
  };
  // lane j's row's channels, and every owner's bin of the 32 rows
  auto load = [&](int r, float (&w)[3], int (&bin)[kLanes]) {
    const float* p = w3 + (size_t)r * 3;
    w[0] = __ldg(p);
    w[1] = __ldg(p + 1);
    w[2] = __ldg(p + 2);
#pragma unroll
    for (int j = 0; j < kLanes; ++j) {
      const int rj = __shfl_sync(~0u, r, j);
      bin[j] = (int)__ldg(binned + (size_t)rj * G + g);
    }
  };
  if (begin < end) {
    // software pipelined: the next 32 rows' loads are in flight while
    // this 32's are added, and a row list's ids two turns ahead
    float wc[3], wn[3];
    int bc[kLanes], bn[kLanes];
    int r_next = row_of(begin + kLanes + lane);
    load(row_of(begin + lane), wc, bc);
    for (long long base = begin; base < end; base += kLanes) {
      load(r_next, wn, bn);
      r_next = row_of(base + 2 * kLanes + lane);
      const int m = (int)min((long long)kLanes, end - base);
      // lane j's row: its g and h as the sums add them
      double v[kAcc];
#pragma unroll
      for (int c = 0; c < kAcc; ++c) v[c] = row_value<HILO>(wc[c]);
      const uint32_t k = lane < m && wc[2] > 0.f ? 1u : 0u;
      // four rows at a time: their four words are read together, then
      // added in row order, a row whose bin an earlier one of the four
      // holds taking that row's sum (the same adds in the same order as
      // one row at a time), and written back in row order, so the last
      // write of a word is its latest sum
#pragma unroll
      for (int q = 0; q < kLanes; q += kGroup) {
        double x[kGroup][kAcc], o[kGroup][kAcc];
        uint32_t kx[kGroup], ko[kGroup];
        int e[kGroup];
#pragma unroll
        for (int i = 0; i < kGroup; ++i) {
          const int j = q + i;
#pragma unroll
          for (int c = 0; c < kAcc; ++c) {
            x[i][c] = __shfl_sync(~0u, v[c], j);
          }
          kx[i] = __shfl_sync(~0u, k, j);
          const int b = owner && j < m && bc[j] < width ? bc[j] : bw;
          e[i] = b * gw + col;
        }
#pragma unroll
        for (int i = 0; i < kGroup; ++i) {
#pragma unroll
          for (int c = 0; c < kAcc; ++c) o[i][c] = h[c * words + e[i]];
          ko[i] = hc[e[i]];
        }
        const bool s10 = e[1] == e[0], s21 = e[2] == e[1];
        const bool s20 = e[2] == e[0], s32 = e[3] == e[2];
        const bool s31 = e[3] == e[1], s30 = e[3] == e[0];
#pragma unroll
        for (int c = 0; c < kAcc; ++c) {
          const double a0 = o[0][c] + x[0][c];
          const double a1 = (s10 ? a0 : o[1][c]) + x[1][c];
          const double a2 = (s21 ? a1 : s20 ? a0 : o[2][c]) + x[2][c];
          const double a3 =
              (s32 ? a2 : s31 ? a1 : s30 ? a0 : o[3][c]) + x[3][c];
          h[c * words + e[0]] = a0;
          h[c * words + e[1]] = a1;
          h[c * words + e[2]] = a2;
          h[c * words + e[3]] = a3;
        }
        const uint32_t c0 = ko[0] + kx[0];
        const uint32_t c1 = (s10 ? c0 : ko[1]) + kx[1];
        const uint32_t c2 = (s21 ? c1 : s20 ? c0 : ko[2]) + kx[2];
        const uint32_t c3 = (s32 ? c2 : s31 ? c1 : s30 ? c0 : ko[3]) + kx[3];
        hc[e[0]] = c0;
        hc[e[1]] = c1;
        hc[e[2]] = c2;
        hc[e[3]] = c3;
      }
#pragma unroll
      for (int j = 0; j < kLanes; ++j) bc[j] = bn[j];
      wc[0] = wn[0];
      wc[1] = wn[1];
      wc[2] = wn[2];
    }
  }
  __syncthreads();

  // the warps' histograms added in warp order, in f64 (the sentinel bins
  // left out): into out when this is the only row block, else into the
  // block's partial
  const int nsp = gridDim.y * gw;
  const int gshift = __ffs(gw) - 1;  // gw is a power of two
  const bool direct = gridDim.x == 1;
  const size_t chan = (size_t)bw * nsp;
  double* const dst =
      direct ? nullptr
             : part + (size_t)blockIdx.x * (kAcc + 1) * chan + blockIdx.y * gw;
  for (int e = threadIdx.x; e < bw * gw; e += blockDim.x) {
    const int b = e >> gshift, l = e & (gw - 1);
    double sum[kAcc];
#pragma unroll
    for (int c = 0; c < kAcc; ++c) {
      sum[c] = 0.0;
      for (int w = 0; w < warps; ++w) {
        sum[c] += reinterpret_cast<const double*>(
            smem + w * warp_bytes)[c * words + e];
      }
    }
    uint32_t count = 0u;
    for (int w = 0; w < warps; ++w) {
      count += reinterpret_cast<const uint32_t*>(
          smem + w * warp_bytes + kAcc * words * 8)[e];
    }
    if (direct) {
      const int s = blockIdx.y * gw + l;
      if (s < n_list) {
        float* o = out + ((size_t)(glist ? __ldg(glist + s) : s) * B + b) * 3;
        o[0] = __double2float_rn(sum[0]);
        o[1] = __double2float_rn(sum[1]);
        o[2] = __uint2float_rn(count);
      }
    } else {
      const size_t at = (size_t)b * nsp + l;
      dst[at] = sum[0];
      dst[chan + at] = sum[1];
      dst[kAcc * chan + at] = (double)count;
    }
  }
}

// The warp-shared scheme, for a uint16 matrix's groups too wide for 32
// private columns: block (tile, slice y) = blockIdx, in clusters of C =
// clusterDim.x consecutive tiles of one slice; W = blockDim.x / 32 warps,
// and warp w owns group wide[y * W + w] and ONE histogram of it,
// [2][wide_w] f64 sums, [wide_w] uint32 counts and [wide_w] claim words,
// all in shared memory. The block stages the tile's positions
// kStageRows at a time: thread t loads group t % W of rows t / W + 32k
// (the slice's groups of a row read together), and the threads of slots
// 0-2 (all three with fewer) also channel t % W of those rows, the value
// as the sums add it and the count flag (w > 0); the next chunk's loads
// are in flight while this one is added. Per 32 staged rows the lanes
// claim their bins in rounds (an integer atomicMin of the lane into the
// bin's claim word): the lowest pending lane of a bin adds its row and
// frees the claim, so each (tile, group, bin) is one f64 chain in row
// order; a round adds one row a bin. A row whose bin is at or past its
// group's width adds nothing. Then the blocks of a cluster add their
// histograms through distributed shared memory, word by word in rank
// order from +0 in f64 (rank r of C takes a C-th of the words), into
// the cluster's partial [clusters][group][3][wide_w] or, with one
// cluster, rounded into out at once: a C-th of the partial bytes that
// tiles of their own would write.
template <bool HILO>
__global__ void __launch_bounds__(kWideWarps * kLanes)
hist_claim_kernel(const uint16_t* __restrict__ binned, int G,
                  const float* __restrict__ w3, const int* __restrict__ rows,
                  int n, const int* __restrict__ wide, int n_wide,
                  const int* __restrict__ widths, int wide_w, int tile_rows,
                  int B, double* __restrict__ part, float* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int W = blockDim.x / kLanes;
  const int warp = threadIdx.x / kLanes;
  const int lane = threadIdx.x % kLanes;
  const int tile = blockIdx.x;
  const int y = blockIdx.y;
  const int hw = W * wide_w;
  double* const hist = reinterpret_cast<double*>(smem);
  uint32_t* const cnt = reinterpret_cast<uint32_t*>(hist + 2 * (size_t)hw);
  int* const claims = reinterpret_cast<int*>(cnt + hw);
  // 24 hw bytes so far, so the staged f64 values stay aligned
  double* const sv = reinterpret_cast<double*>(claims + hw);  // [2][S]
  uint32_t* const sk = reinterpret_cast<uint32_t*>(sv + 2 * kStageRows);
  uint16_t* const sb = reinterpret_cast<uint16_t*>(sk + kStageRows);
  for (int e = threadIdx.x; e < 2 * hw; e += blockDim.x) hist[e] = 0.0;
  for (int e = threadIdx.x; e < hw; e += blockDim.x) {
    cnt[e] = 0u;
    claims[e] = kLanes;
  }
  const int slot = y * W + warp;
  const bool live = slot < n_wide;
  const int g = live ? __ldg(wide + slot) : 0;
  const int width = live ? __ldg(widths + g) : 0;
  double* const h = hist + (size_t)warp * 2 * wide_w;
  uint32_t* const hc = cnt + (size_t)warp * wide_w;
  int* const claim = claims + (size_t)warp * wide_w;
  const int fk = threadIdx.x % W;  // this thread's slot of the slice
  const int p0 = threadIdx.x / W;  // and its first row of a chunk
  const int gs = y * W + fk < n_wide ? __ldg(wide + y * W + fk) : -1;
  const long long begin = (long long)tile * tile_rows;
  const int m =
      (int)max(0LL, min((long long)n, begin + tile_rows) - begin);
  int rd[kStageData], db[kStageData];
  float dw[kStageData][3];
  auto load_ids = [&](int c0) {
#pragma unroll
    for (int k = 0; k < kStageData; ++k) {
      const int p = c0 + p0 + k * kLanes;
      rd[k] = p < m ? (rows ? __ldg(rows + begin + p) : (int)(begin + p))
                    : -1;
    }
  };
  auto load_data = [&]() {
#pragma unroll
    for (int k = 0; k < kStageData; ++k) {
      const bool ok = rd[k] >= 0;
      db[k] = ok && gs >= 0 ? (int)__ldg(binned + (size_t)rd[k] * G + gs)
                            : 0xFFFF;
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        const int c = fk + j * W;
        dw[k][j] = ok && c < 3 ? __ldg(w3 + (size_t)rd[k] * 3 + c) : 0.f;
      }
    }
  };
  auto store = [&]() {
#pragma unroll
    for (int k = 0; k < kStageData; ++k) {
      const int p = p0 + k * kLanes;
      sb[fk * (kStageRows + 2) + p] = (uint16_t)db[k];
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        const int c = fk + j * W;
        if (c < 2) {
          sv[c * kStageRows + p] = row_value<HILO>(dw[k][j]);
        } else if (c == 2) {
          sk[p] = dw[k][j] > 0.f ? 1u : 0u;
        }
      }
    }
  };
  const int chunks = (m + kStageRows - 1) / kStageRows;
  if (chunks > 0) {
    load_ids(0);
    load_data();
    if (chunks > 1) load_ids(kStageRows);
  }
  const uint16_t* const bins = sb + warp * (kStageRows + 2);
  for (int ci = 0; ci < chunks; ++ci) {
    __syncthreads();  // the zeroing, and the last chunk's adds, are done
    store();
    __syncthreads();
    if (ci + 1 < chunks) load_data();
    if (ci + 2 < chunks) load_ids((ci + 2) * kStageRows);
    if (!live) continue;
    const int np = min(kStageRows, m - ci * kStageRows);
    for (int q = 0; q < np; q += kLanes) {
      const int p = q + lane;
      const int bin = p < np ? (int)bins[p] : width;
      const double vg = sv[p], vh = sv[kStageRows + p];
      const uint32_t k = sk[p];
      // rounds of claims: the lowest pending lane of each bin adds its
      // row and frees the bin's claim for the next, so the rows of one
      // bin add in row order
      bool pending = bin < width;
      while (__any_sync(~0u, pending)) {
        if (pending) atomicMin(claim + bin, lane);
        __syncwarp();
        const bool first = pending && claim[bin] == lane;
        __syncwarp();
        if (first) {
          h[bin] += vg;
          h[wide_w + bin] += vh;
          hc[bin] += k;
          claim[bin] = kLanes;
          pending = false;
        }
        __syncwarp();
      }
    }
  }
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.dim_blocks().x;
  const int clusters = gridDim.x / C;
  if (C == 1) {
    // a tile alone: its warps write their own histograms
    if (!live) return;
    __syncwarp();
    if (clusters == 1) {
      for (int b = lane; b < width; b += kLanes) {
        float* o = out + ((size_t)g * B + b) * 3;
        o[0] = __double2float_rn(h[b]);
        o[1] = __double2float_rn(h[wide_w + b]);
        o[2] = __uint2float_rn(hc[b]);
      }
    } else {
      double* const pw = part + ((size_t)tile * n_wide + slot) * 3 * wide_w;
      for (int b = lane; b < wide_w; b += kLanes) {
        pw[b] = h[b];
        pw[wide_w + b] = h[wide_w + b];
        pw[2 * wide_w + b] = (double)hc[b];
      }
    }
    return;
  }
  // the cluster's histograms added rank by rank, a C-th of the (warp,
  // bin) pairs a rank; every rank waits for the others' adds before, and
  // for their reads after
  cluster.sync();
  const int rank = (int)cluster.block_rank();
  const int pairs = W * wide_w;
  const int share = (pairs + C - 1) / C;
  for (int e = rank * share + threadIdx.x;
       e < min(pairs, (rank + 1) * share); e += blockDim.x) {
    const int wl = e / wide_w, b = e % wide_w;
    const int s = y * W + wl;
    if (s >= n_wide) continue;
    double a0 = 0.0, a1 = 0.0, a2 = 0.0;
    for (int q = 0; q < C; ++q) {
      const unsigned char* r = cluster.map_shared_rank(smem, q);
      const double* rh =
          reinterpret_cast<const double*>(r) + (size_t)wl * 2 * wide_w;
      a0 += rh[b];
      a1 += rh[wide_w + b];
      a2 += (double)reinterpret_cast<const uint32_t*>(
          r + 16 * (size_t)hw)[(size_t)wl * wide_w + b];
    }
    if (clusters == 1) {
      const int gq = __ldg(wide + s);
      if (b < __ldg(widths + gq)) {
        float* o = out + ((size_t)gq * B + b) * 3;
        o[0] = __double2float_rn(a0);
        o[1] = __double2float_rn(a1);
        o[2] = __double2float_rn(a2);
      }
    } else {
      double* const pw =
          part + ((size_t)(tile / C) * n_wide + s) * 3 * wide_w;
      pw[b] = a0;
      pw[wide_w + b] = a1;
      pw[2 * wide_w + b] = a2;
    }
  }
  cluster.sync();
}

// out[g, b, :] from both paths' f64 partials, rounded to f32 once: a
// warp takes kQuad adjacent words of one path (the lane-private path's
// first), and its lane kQuad * s + j adds the blocks (clusters) s, s + 8,
// ... of word j in order from +0 (a block past the last adds +0, which
// leaves the chain as it is: a chain never holds -0); the eight chains
// close in the shuffle tree ((0+4)+(2+6)) + ((1+5)+(3+7)). A word of a
// bin at or past its group's width is not written.
__global__ void __launch_bounds__(kSumThreads)
hist_sum_kernel(const double* __restrict__ lpart, int l_blocks,
                int l_words, int bw, int nsp, const int* __restrict__ lane,
                int n_lane, const double* __restrict__ wpart, int w_parts,
                int w_words, int wide_w, const int* __restrict__ wide,
                const int* __restrict__ widths, int B,
                float* __restrict__ out) {
  const int wid = (int)((blockIdx.x * (size_t)blockDim.x + threadIdx.x)
                        / kLanes);
  const int j = threadIdx.x % kQuad;
  const int s = threadIdx.x % kLanes / kQuad;
  const int lq = lpart ? (l_words + kQuad - 1) / kQuad : 0;
  const bool wpath = wid >= lq;
  const int q = wpath ? wid - lq : wid;
  const int words = wpath ? w_words : l_words;
  // warp-uniform: whole warps leave together
  if (wpath && (!wpart || q >= (w_words + kQuad - 1) / kQuad)) return;
  const int P = wpath ? w_parts : l_blocks;
  const int word = q * kQuad + j;
  const double* const p =
      (wpath ? wpart : lpart) + (word < words ? word : 0);
  const int chains = (P + kChains - 1) / kChains;
  double a = 0.0;
  // four of a chain's loads in flight at once, added in order
  for (int i0 = 0; i0 < chains; i0 += 4) {
    double v[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int blk = s + kChains * (i0 + u);
      v[u] = blk < P ? __ldg(p + (size_t)blk * words) : 0.0;
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) a += v[u];
  }
  a += __shfl_down_sync(~0u, a, 4 * kQuad);
  a += __shfl_down_sync(~0u, a, 2 * kQuad);
  a += __shfl_down_sync(~0u, a, kQuad);
  if (s != 0 || word >= words) return;
  int g, b, c;
  if (wpath) {
    const int slot = word / (3 * wide_w), r = word % (3 * wide_w);
    g = __ldg(wide + slot);
    c = r / wide_w;
    b = r % wide_w;
    if (b >= __ldg(widths + g)) return;
  } else {
    const int plane = bw * nsp;
    c = word / plane;
    b = word % plane / nsp;
    const int slot = word % nsp;
    if (slot >= n_lane) return;
    g = lane ? __ldg(lane + slot) : slot;
    if (b >= (widths ? __ldg(widths + g) : bw)) return;
  }
  out[((size_t)g * B + b) * 3 + c] = __double2float_rn(a);
}

// HQ's shared int32 histogram a block at most, in words (ops/histogram.py
// HIST_I32_WORDS): two blocks of 8 warps an SM
constexpr int kWordsI32 = 100 * 1024 / 4;
constexpr int kThreadsI32 = 256;

// a slice of gc groups: its row phases P, 4 up to 8 groups, 2 up to 16,
// else 1; its slots take S = 32 / P lanes
__device__ __forceinline__ int row_phases(int gc) {
  return gc <= kLanes / 4 ? 4 : gc <= kLanes / 2 ? 2 : 1;
}

// HQ. Block (y, x) sums the rows of positions [x * chunk, (x + 1) *
// chunk) of the row sequence over slice y of the groups, slices[y] =
// (g0, gc, wn, words): groups g0 .. g0 + gc - 1 in `words` shared int32
// words, with P = row_phases(gc) row phases (hq_block, compiled for each
// P).
// Lane l of a warp takes slot l % S of the slice (group g0 + slot), in
// item s / S for slot s, and the rows of phase l / S of a turn of 32
// rows. Bin b, channel ch of lane l's slot is the word
// - ((item * 3 + ch) * wn + b) * 32 + l where wn > 0 (interleaved:
//   groups of at most HQ_INTERLEAVE_BINS bins, a lane's words in its own
//   bank; a slot has a column for each phase),
// - woff[g] + 3 * b + ch where wn == 0 (packed at the group's width,
//   shared by the phases).
// A warp takes 32 rows a turn: lane j loads row j's codes and w01 (and
// id, from a row list) once and the lanes broadcast them by shuffles;
// then, item by item, each lane loads its slot's bin of its phase's rows
// (a warp reads a row's bins of up to 32 groups as one contiguous run;
// all rows are consecutive positions, so the lanes compute a row's
// address, and a row list's ids are broadcast) and adds every row that
// lies outside its group's skipped bin, skip[g], with shared integer
// atomics. The loads
// are software pipelined: the next item's bins, the next turn's codes and
// w01 and the one after's row ids are in flight while an item's rows are
// added. A row a lane does not add goes to three spare words of the
// lane, so no atomic is under a branch. The block also sums its rows'
// (q_g, q_h, 1), and the skipped bin is filled after the rows as those
// totals minus the group's other bins: exact in int32, since every row
// holds one bin of each group below the group's width. Integer sums do
// not depend on their order, so the result has the same bits on every
// run. The block's histogram goes to its row block's partial,
// part[x][sbase[y] ...], in the shared layout.
template <typename BinT, bool kList, int P>
__device__ __forceinline__ void hq_block(
    const BinT* __restrict__ binned, int G, const int* __restrict__ codes,
    const float* __restrict__ w01, const int* __restrict__ rows, int n,
    int chunk, int y, int4 sl, const int* __restrict__ sbase,
    const int* __restrict__ widths, const int* __restrict__ woff,
    const int* __restrict__ skip, int hist_words, int part_words,
    int* __restrict__ part) {
  constexpr int S = kLanes / P;   // slot lanes
  constexpr int NR = kLanes / P;  // rows of a turn a lane adds
  extern __shared__ __align__(16) int sh[];
  __shared__ int s_tot[3];
  const int g0 = sl.x, gc = sl.y, wn = sl.z, words = sl.w;
  const int warps = blockDim.x / kLanes;
  const int warp = threadIdx.x / kLanes;
  const int lane = threadIdx.x % kLanes;
  for (int e = threadIdx.x; e < words / 4; e += blockDim.x) {
    reinterpret_cast<int4*>(sh)[e] = make_int4(0, 0, 0, 0);
  }
  if (threadIdx.x < 3) s_tot[threadIdx.x] = 0;
  __syncthreads();
  const int items = (gc + S - 1) / S;
  const int phase = lane / S;
  // the lane's three spare words, after the largest slice's histogram
  int* const spare = sh + hist_words + lane;
  // a lane's distance between two bins' words and two channels' words
  const int bstride = wn ? kLanes : 3;
  const int cstride = wn ? wn * kLanes : 1;
  const int begin = blockIdx.y * chunk;
  const int end = min(n, begin + chunk);
  const int step = warps * kLanes;
  // lane's row of the turn of positions from b (-1 past the block's)
  auto row_id = [&](int b) {
    const int p = b + lane;
    return p < end ? (kList ? __ldg(rows + p) : p) : -1;
  };
  // the bins of the slot gi * S + lane % S of the lane's NR rows of the
  // turn of positions from b (lane j's row r)
  auto load_bins = [&](int (&bin)[NR], int r, int b, int gi) {
    const int slot = gi * S + lane % S;
    const BinT* const col = binned + g0 + (slot < gc ? slot : 0);
#pragma unroll
    for (int i = 0; i < NR; ++i) {
      const int j = phase + P * i;
      const int rj = kList ? max(__shfl_sync(~0u, r, j), 0)
                           : min(b + j, end - 1);
      bin[i] = (int)__ldg(col + (size_t)rj * G);
    }
  };
  int tg = 0, th = 0, tc = 0;
  int base = begin + warp * kLanes;
  if (base < end) {
    int r = row_id(base), rn = row_id(base + step);
    int q = r >= 0 ? __ldg(codes + r) : 0;  // (q_g, q_h) as int16 halves
    bool live = r >= 0 && __ldg(w01 + r) > 0.f;
    int bin[NR], nxt[NR];
    load_bins(bin, r, base, 0);
    for (;;) {
      const int rnn = row_id(base + 2 * step);
      const int qn = rn >= 0 ? __ldg(codes + rn) : 0;
      const bool ln = rn >= 0 && __ldg(w01 + rn) > 0.f;
      tg += live ? (int)(short)(q & 0xFFFF) : 0;
      th += live ? q >> 16 : 0;
      tc += live ? 1 : 0;
      const unsigned m = __ballot_sync(~0u, live);
      const bool more = base + step < end;
      for (int gi = 0; gi < items; ++gi) {
        if (gi + 1 < items) {
          load_bins(nxt, r, base, gi + 1);
        } else if (more) {
          load_bins(nxt, rn, base + step, 0);
        }
        const int slot = gi * S + lane % S;
        const bool mine = slot < gc;
        const int g = g0 + (mine ? slot : 0);
        const int k = __ldg(skip + g);
        const int W = mine ? __ldg(widths + g) : 0;
        int* const col =
            sh + (wn ? gi * 3 * wn * kLanes + lane : __ldg(woff + g));
#pragma unroll
        for (int i = 0; i < NR; ++i) {
          const int j = phase + P * i;
          const int qj = __shfl_sync(~0u, q, j);
          const int b = bin[i];
          const bool add = ((m >> j) & 1u) && b != k && b < W;
          int* const w = add ? col + b * bstride : spare;
          const int cs = add ? cstride : kLanes;
          atomicAdd(w, (int)(short)(qj & 0xFFFF));
          atomicAdd(w + cs, qj >> 16);
          atomicAdd(w + 2 * cs, 1);
        }
#pragma unroll
        for (int i = 0; i < NR; ++i) bin[i] = nxt[i];
      }
      base += step;
      if (!more) break;
      r = rn;
      rn = rnn;
      q = qn;
      live = ln;
    }
  }
  tg = __reduce_add_sync(~0u, tg);
  th = __reduce_add_sync(~0u, th);
  tc = __reduce_add_sync(~0u, tc);
  if (lane == 0) {
    atomicAdd(s_tot, tg);
    atomicAdd(s_tot + 1, th);
    atomicAdd(s_tot + 2, tc);
  }
  __syncthreads();
  // each group's skipped bin: the block's totals minus the other bins (a
  // thread a group where interleaved, summing its P columns; a warp a
  // group where packed), so the reads do not share a bank
  if (wn) {
    for (int slot = threadIdx.x; slot < gc; slot += blockDim.x) {
      const int g = g0 + slot, W = widths[g], k = skip[g];
      int* const col = sh + slot / S * 3 * wn * kLanes + slot % S;
      for (int ch = 0; ch < 3; ++ch) {
        unsigned sum = 0u;
        for (int ph = 0; ph < P; ++ph) {
          for (int b = 0; b < W; ++b) {
            sum += (unsigned)col[ph * S + ch * cstride + b * kLanes];
          }
        }
        col[ch * cstride + k * kLanes] = (int)((unsigned)s_tot[ch] - sum);
      }
    }
  } else {
    for (int slot = warp; slot < gc; slot += warps) {
      const int g = g0 + slot, W = widths[g], k = skip[g];
      int* const col = sh + woff[g];
      for (int ch = 0; ch < 3; ++ch) {
        unsigned sum = 0u;
        for (int b = lane; b < W; b += kLanes) sum += (unsigned)col[3 * b + ch];
        sum = __reduce_add_sync(~0u, sum);
        if (lane == 0) col[3 * k + ch] = (int)((unsigned)s_tot[ch] - sum);
      }
    }
  }
  __syncthreads();
  int4* const dst = reinterpret_cast<int4*>(
      part + (size_t)blockIdx.y * part_words + sbase[y]);
  for (int e = threadIdx.x; e < words / 4; e += blockDim.x) {
    dst[e] = reinterpret_cast<const int4*>(sh)[e];
  }
}

template <typename BinT, bool kList>
__global__ void __launch_bounds__(kThreadsI32, 2)
hist_i32_kernel(const BinT* __restrict__ binned, int G,
                const int* __restrict__ codes, const float* __restrict__ w01,
                const int* __restrict__ rows, int n, int chunk,
                const int4* __restrict__ slices,
                const int* __restrict__ sbase,
                const int* __restrict__ widths,
                const int* __restrict__ woff, const int* __restrict__ skip,
                int hist_words, int part_words, int* __restrict__ part) {
  const int y = blockIdx.x;
  const int4 sl = slices[y];
  switch (row_phases(sl.y)) {
    case 4:
      hq_block<BinT, kList, 4>(binned, G, codes, w01, rows, n, chunk, y, sl,
                               sbase, widths, woff, skip, hist_words,
                               part_words, part);
      break;
    case 2:
      hq_block<BinT, kList, 2>(binned, G, codes, w01, rows, n, chunk, y, sl,
                               sbase, widths, woff, skip, hist_words,
                               part_words, part);
      break;
    default:
      hq_block<BinT, kList, 1>(binned, G, codes, w01, rows, n, chunk, y, sl,
                               sbase, widths, woff, skip, hist_words,
                               part_words, part);
  }
}

// HQ's main kernel for bin type BinT, with or without a row list
template <typename BinT>
cudaError_t launch_i32(const BinT* binned, int G, const int* codes,
                       const float* w01, const int* rows, int n, int chunk,
                       const int4* sl, const int* sbase, const int* widths,
                       const int* woff, const int* skip, int hist_words,
                       int part_words, int* part, dim3 grid, size_t smem,
                       cudaStream_t s) {
  auto kernel = rows ? hist_i32_kernel<BinT, true>
                     : hist_i32_kernel<BinT, false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kThreadsI32, smem, s>>>(binned, G, codes, w01, rows, n,
                                         chunk, sl, sbase, widths, woff, skip,
                                         hist_words, part_words, part);
  return cudaGetLastError();
}

// out[g, b, ch] += the row blocks' partial words of slice y: thread e of
// the slice sums blocks z, z + xs, ... (z = blockIdx.z) and adds the sum
// into out, which is zeroed, with an integer atomic. Coalesced reads; a
// word past its group's width (or past the slice's groups) is left out.
__global__ void hist_i32_reduce_kernel(const int* __restrict__ part,
                                       int blocks, int part_words,
                                       const int4* __restrict__ slices,
                                       const int* __restrict__ sbase,
                                       const int* __restrict__ widths,
                                       const int* __restrict__ woff, int B,
                                       int* __restrict__ out) {
  const int4 sl = slices[blockIdx.y];
  const int g0 = sl.x, gc = sl.y, wn = sl.z;
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= sl.w) return;
  int slot, b, ch;
  if (wn) {
    // column l of item t / 3: slot (t / 3) * S + l % S (a phase's column)
    const int S = kLanes / row_phases(gc);
    int t = e / kLanes;
    b = t % wn;
    t /= wn;
    ch = t % 3;
    slot = t / 3 * S + e % kLanes % S;
  } else {
    // the group of word e: the last of the slice whose first word is at
    // or before it
    int lo = g0, hi = g0 + gc - 1;
    while (lo < hi) {
      const int mid = (lo + hi + 1) >> 1;
      if (woff[mid] <= e) {
        lo = mid;
      } else {
        hi = mid - 1;
      }
    }
    slot = lo - g0;
    b = (e - woff[lo]) / 3;
    ch = (e - woff[lo]) % 3;
  }
  if (slot >= gc) return;
  const int g = g0 + slot;
  if (b >= widths[g]) return;
  const int* p = part + sbase[blockIdx.y] + e;
  int sum = 0;
  for (int x = blockIdx.z; x < blocks; x += gridDim.z) {
    sum += __ldg(p + (size_t)x * part_words);
  }
  if (sum != 0) atomicAdd(out + ((size_t)g * B + b) * 3 + ch, sum);
}

}  // namespace

namespace {

// hist_claim_kernel's shared memory: W histograms of wide_w bins (24
// bytes a bin) and a staged chunk (20 bytes a row, 2 a bin of W groups;
// ops/histogram.py _wide_smem)
size_t wide_smem(int W, int wide_w) {
  return (size_t)24 * W * wide_w + (size_t)20 * kStageRows +
         (size_t)2 * W * (kStageRows + 2);
}

template <bool HILO>
int launch_histogram(const void* binned, int G, int u16, const float* w3,
                     const int* rows, int n, int B, const int* lane,
                     int n_lane, const int* widths, int lane_w, int gw,
                     int warps, int run, int blocks, const int* wide,
                     int n_wide, int wide_w, int wwarps, int wslices,
                     int tile_rows, int tiles, int wcluster, double* scratch,
                     float* out, cudaStream_t s) {
  double* lpart = nullptr;
  double* wpart = nullptr;
  int l_words = 0, w_words = 0, nsp = 0, clusters = 0;
  cudaError_t err;
  if (u16) {
    // a uint16 matrix's groups stop at their own widths: the bins past
    // them are 0
    err = cudaMemsetAsync(out, 0, (size_t)G * B * 3 * sizeof(float), s);
    if (err != cudaSuccess) return (int)err;
  }
  if (n_lane > 0) {
    if (gw < 1 || gw > kLanes || kLanes % gw || warps < 1 ||
        warps > kMaxWarps || run < kLanes || run % kLanes || blocks < 1 ||
        lane_w < 1 || lane_w > B || (!widths && lane_w != B)) {
      return (int)cudaErrorInvalidValue;
    }
    // 20 bytes a slot in either mode (ops/histogram.py _warp_bytes)
    const size_t smem =
        (size_t)warps * (((size_t)(lane_w + 1) * gw + 1) / 2 * 2) * 20;
    if (smem > (size_t)kHistSmem) return (int)cudaErrorInvalidValue;
    const int slices = (n_lane + gw - 1) / gw;
    nsp = slices * gw;
    l_words = 3 * lane_w * nsp;
    if (blocks > 1) {
      lpart = scratch;
      scratch += (size_t)blocks * l_words;
    }
    dim3 grid(blocks, slices);
    if (u16) {
      err = cudaFuncSetAttribute(hist_lane_kernel<HILO, uint16_t>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)smem);
      if (err != cudaSuccess) return (int)err;
      hist_lane_kernel<HILO, uint16_t><<<grid, warps * kLanes, smem, s>>>(
          static_cast<const uint16_t*>(binned), G, w3, rows, n, lane, n_lane,
          widths, lane_w, gw, run, B, lpart, out);
    } else {
      err = cudaFuncSetAttribute(hist_lane_kernel<HILO, uint8_t>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)smem);
      if (err != cudaSuccess) return (int)err;
      hist_lane_kernel<HILO, uint8_t><<<grid, warps * kLanes, smem, s>>>(
          static_cast<const uint8_t*>(binned), G, w3, rows, n, lane, n_lane,
          widths, lane_w, gw, run, B, lpart, out);
    }
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  if (n_wide > 0) {
    if (!u16 || !widths || wwarps < 1 || wwarps > kWideWarps ||
        wslices < 1 || (long long)wslices * wwarps < n_wide ||
        (wslices - 1) * wwarps >= n_wide || wide_w < 1 || wide_w > B ||
        tile_rows < kStageRows || tile_rows % kStageRows || tiles < 1 ||
        (long long)tiles * tile_rows < n || wcluster < 1 ||
        wcluster > kMaxCluster || (wcluster & (wcluster - 1)) ||
        tiles % wcluster ||
        (long long)(tiles - wcluster) * tile_rows >= (n > 0 ? n : 1)) {
      return (int)cudaErrorInvalidValue;
    }
    const size_t smem = wide_smem(wwarps, wide_w);
    if (smem > (size_t)kWideSmem) return (int)cudaErrorInvalidValue;
    w_words = 3 * wide_w * n_wide;
    clusters = tiles / wcluster;
    if (clusters > 1) wpart = scratch;
    err = cudaFuncSetAttribute(hist_claim_kernel<HILO>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(tiles, wslices);
    cfg.blockDim = dim3(wwarps * kLanes);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = s;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = wcluster;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    err = cudaLaunchKernelEx(&cfg, hist_claim_kernel<HILO>,
                             static_cast<const uint16_t*>(binned), G, w3,
                             rows, n, wide, n_wide, widths, wide_w, tile_rows,
                             B, wpart, out);
    if (err != cudaSuccess) return (int)err;
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  const long long quads = (lpart ? (l_words + kQuad - 1) / kQuad : 0) +
                          (wpart ? (w_words + kQuad - 1) / kQuad : 0);
  if (quads > 0) {
    const long long per = kSumThreads / kLanes;
    hist_sum_kernel<<<(unsigned)((quads + per - 1) / per), kSumThreads, 0,
                      s>>>(lpart, blocks, l_words, lane_w, nsp, lane,
                           n_lane, wpart, clusters, w_words, wide_w, wide,
                           widths, B, out);
    return (int)cudaGetLastError();
  }
  return 0;
}

}  // namespace

// binned [N, G] row-major, u8 or (u16 != 0) u16; w3 [N, 3] f32 = (g*w,
// h*w, w); rows: a row list of n entries or NULL for rows 0..n-1; hilo:
// 1 for the hi+lo mode; out [G, B, 3] f32. The lane-private groups:
// lane[n_lane] (NULL: groups 0..n_lane-1, every group of a u8 matrix),
// each widths[g] bins wide (NULL: lane_w = B), summed by the plan of
// ops/histogram.py hist_plan: gw groups a warp, warps a block, runs of
// `run` positions, `blocks` row blocks. The warp-shared groups of a u16
// matrix (hist_layout): wide[n_wide], at most wide_w bins, by the plan of
// hist_wide_plan: wwarps groups a block in wslices slices, tiles of
// tile_rows positions in clusters of wcluster. scratch: f64, the lane
// partials (blocks * 3 * lane_w * ceil(n_lane / gw) * gw words, when
// blocks > 1), then the warp-shared ones (tiles / wcluster * n_wide * 3 *
// wide_w, when more than one cluster). Returns cudaGetLastError().
extern "C" int lgbt_leaf_histogram(const void* binned, int G, int u16,
                                   const float* w3, const int* rows, int n,
                                   int B, int hilo, const int* lane,
                                   int n_lane, const int* widths, int lane_w,
                                   int gw, int warps, int run, int blocks,
                                   const int* wide, int n_wide, int wide_w,
                                   int wwarps, int wslices, int tile_rows,
                                   int tiles, int wcluster, void* scratch,
                                   float* out, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  double* part = (double*)scratch;
  return hilo ? launch_histogram<true>(binned, G, u16, w3, rows, n, B, lane,
                                       n_lane, widths, lane_w, gw, warps,
                                       run, blocks, wide, n_wide, wide_w,
                                       wwarps, wslices, tile_rows, tiles,
                                       wcluster, part, out, s)
              : launch_histogram<false>(binned, G, u16, w3, rows, n, B, lane,
                                        n_lane, widths, lane_w, gw, warps,
                                        run, blocks, wide, n_wide, wide_w,
                                        wwarps, wslices, tile_rows, tiles,
                                        wcluster, part, out, s);
}

// binned [N, G] row-major, u8 or (u16 != 0) u16; codes [N] short2 (q_g,
// q_h) read as one int32; w01 [N] f32; rows: a row list of n entries or
// NULL for rows 0..n-1; out [G, B, 3] int32. The plan (ops/histogram.py
// i32_plan, i32_grid): slices [n_slices] int4 (g0, gc, wn, words), the
// largest slice_words;
// sbase [n_slices] each slice's first word in a row block's partial of
// part_words; widths, woff, skip [G]; `blocks` row blocks of `chunk`
// positions, the reduction's xs-way split of them. part: blocks *
// part_words int32 words. Returns cudaGetLastError().
extern "C" int lgbt_leaf_histogram_i32(
    const void* binned, int G, int u16, const int* codes, const float* w01,
    const int* rows, int n, int B, const int* slices, int n_slices,
    int slice_words, const int* sbase, int part_words, const int* widths,
    const int* woff, const int* skip, int blocks, int chunk, int xs,
    int* part, int* out, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err =
      cudaMemsetAsync(out, 0, (size_t)G * B * 3 * sizeof(int), s);
  if (err != cudaSuccess) return (int)err;
  if (n <= 0 || G <= 0) return 0;
  if (slice_words < 4 || slice_words > kWordsI32 || slice_words % 4 ||
      part_words % 4 || blocks < 1 || chunk < 1 || xs < 1 || n_slices < 1) {
    return (int)cudaErrorInvalidValue;
  }
  // the largest slice's histogram and 3 spare words a lane
  const size_t smem = ((size_t)slice_words + 3 * kLanes) * sizeof(int);
  const int4* sl = reinterpret_cast<const int4*>(slices);
  const dim3 grid(n_slices, blocks);
  if (u16) {
    err = launch_i32(static_cast<const uint16_t*>(binned), G, codes, w01,
                     rows, n, chunk, sl, sbase, widths, woff, skip,
                     slice_words, part_words, part, grid, smem, s);
  } else {
    err = launch_i32(static_cast<const uint8_t*>(binned), G, codes, w01,
                     rows, n, chunk, sl, sbase, widths, woff, skip,
                     slice_words, part_words, part, grid, smem, s);
  }
  if (err != cudaSuccess) return (int)err;
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int threads = 256;
  hist_i32_reduce_kernel<<<dim3((slice_words + threads - 1) / threads,
                                n_slices, xs),
                           threads, 0, s>>>(part, blocks, part_words, sl,
                                            sbase, widths, woff, B, out);
  return (int)cudaGetLastError();
}

extern "C" const char* lgbt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
