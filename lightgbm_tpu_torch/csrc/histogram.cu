// Kernel H, leaf_histogram, of lightgbm_tpu_torch: per (group, bin) the
// sums (g*w, h*w, count of rows with w > 0) over a set of rows of a
// uint8 or uint16 binned matrix, built
// for sm_90a by ops/_build.py and called through ctypes from
// ops/histogram.py.
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
// hist_plan computes the launch plan on the host and leaf_histogram_order
// replays the summation order in torch ops):
// - one pass over the rows: a block takes warps * run consecutive
//   positions of the row sequence (0..n-1, or rows[0..n-1]) and a slice of
//   up to 32 groups; its warp w takes a run of `run` positions, and lane l
//   of the warp owns group l of the slice. Per 32 positions the lanes read
//   the 32 rows' channels (12 bytes each, 4 more for a row list) once,
//   split g and h into their hi and lo halves once (hi+lo mode), and
//   broadcast them by shuffles; each owner lane reads its group's byte of
//   every row (a warp reads a row's bins as one contiguous run) and adds
//   the row into its own column of the warp's [ch][bins + 1][32 lanes]
//   shared histogram. Columns never collide, and lane l's words sit in
//   bank l (two banks for an f64 word). The next 32 rows' loads are in
//   flight while these are added;
// - so a warp holds ONE copy of each of its groups' histograms (41.6 KB
//   for 32 groups at B = 64: 20 bytes a slot, g and h in f64 in f32 mode,
//   the four bf16 halves in f32 in hi+lo mode, and a uint32 count), a
//   block 5 warps, and the rows of a run are added in order: one chain a
//   (run, group, bin) of at most HIST_MAX_RUN = 4,096 rows;
// - the read-add-write of a shared word is a chain of latencies, so the
//   rows go four at a time: the four words are read together, added in
//   row order (a row whose bin an earlier one of the four holds takes
//   that row's sum: the same adds in the same order), and written back
//   in row order. A row a lane does not add goes to the column's extra
//   sentinel bin, so no add is under a branch;
// - the warps' histograms are added in warp order, in f64, into the
//   block's partial ([blocks][ch][bins][slots] f64, written coalesced),
//   and a second kernel adds the blocks' partials, one thread a (bin,
//   group), in eight interleaved f64 chains and a fixed tree, and rounds
//   each sum to f32 once. About 132 blocks at the HIGGS root: 10.8 MB of
//   partials in hi+lo mode, 6.5 MB in f32, against 80 MB of input. f32
//   sums of f32 values over a 2,000,000-row root of cancelling gradients
//   miss 1e-5 * max(1, |sum|) in any order of f32 chains (the earlier
//   2,048-row tiles' too); the f64 sums hold that input to about one
//   rounding (chip_smoke.py phase 10's cancelling input).
// Counts are integers throughout. At B = 256 a warp takes 16 groups (82
// KB), so a block still holds two warps.
//
// Bound on an H100 SXM (3.35 TB/s): every input byte read once: the
// group bins of the rows (G bytes a row), 12 bytes of channels a row,
// 4 more a row for a row list, and the [G, B, 3] output.
// At the root of the main path (2,000,000 rows x 28 groups) that is
// 80 MB, 0.024 ms; chip_smoke.py computes the bound of each measured
// call from its own shape. What sets the time instead (by design
// estimate) is each column's serial chain of shared-memory read, add and
// write, some 30 cycles a row, over the few warps whose histograms fit
// an SM.
//
// The hi+lo mode (tpu_hist_bf16, the JAX package's default): the bf16
// branch of the same three functions, with _hi_lo (:52). Each row's g*w
// and h*w are split into hi = bf16(v) and lo = bf16(v - f32(hi)), rounded
// as XLA's CPU backend rounds (ops/histogram.py hi_lo), and the four
// halves are summed apart in f32 in the same order; the reduction adds
// hi + lo once, after all rows (the JAX merge at :394-396). The split
// reads no more bytes, so the bound is H's.
//
// The uint16 modes (groups of more than 256 bins, the JAX package's
// uint16 matrix: efb.py:96-99, ingest/build.py:116; its H functions are
// dtype-generic and pad every group to the widest): the same sums in
// both modes, with each group at its own width (group_num_bin), the
// warp-shared groups' tiles' partials laid out at those widths, and
// tiles of 2,048 << k rows, the least k that keeps the partials' traffic
// under a quarter of the input's bytes (ops/histogram.py hist_layout,
// hist_tile_rows: at the Bosch root 16,384 rows, 31 tiles, in both
// modes). A group narrow enough that two warps of 16 such columns fit
// the block's budget (at most 351 bins, 20 bytes a slot) takes
// the lane-private scheme above, in columns as wide as the widest of
// them; a wider one (up to 2,048 bins; Bosch's 631) goes warp-shared
// (hist_wide_kernel): ONE histogram a warp, the
// lanes that hold the same bin (__match_any_sync) combined in a fixed
// tree over their rank before their lowest lane's single add. Chosen
// over bin-range passes, which read each tile once a range: the sums
// need one pass, and the combining costs a few shuffles a turn only
// where lanes share a bin. Bound at the Bosch root (500,000 rows x 338
// groups, B 631; chip_smoke.py phases 30-35): 500,000 x (676 + 12)
// bytes in, the [338, 631, 3] histogram out, 0.1035 ms.
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

#include <cuda_runtime.h>
#include <stdint.h>

#include "warp_rank.cuh"

namespace {

constexpr int kLanes = 32;
constexpr int kUnroll = 4;  // rows a lane of the warp-shared kernel has in flight
// the shared memory a block of H may take (ops/histogram.py
// HIST_SMEM_BYTES): 5 warps of the lane-private kernel at B = 64 (41.6
// KB a warp)
constexpr int kHistSmem = 220 * 1024;
// ... and of the warp-shared kernel
constexpr int kWideSmem = 160 * 1024;
// warps of a lane-private block at most (HIST_MAX_WARPS)
constexpr int kMaxWarps = 8;
// warps of a warp-shared block (uint16 groups wider than the lanes'
// private copies allow): 8 at 1,024 bins in hi+lo mode (160 KB)
constexpr int kWideWarps = 8;

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
// collide because they own different columns. The value added is g*w
// (h*w) in f32 mode and hi + lo in hi+lo mode, which f64 holds exactly,
// so the chain sums the hi and the lo halves at once. A warp's histogram
// is [2][words] f64 sums, then [words] uint32 counts; words = (bw + 1) *
// gw rounded up to even, 20 bytes a slot (ops/histogram.py
// HIST_SLOT_BYTES). Then the warps' histograms are added in warp order,
// in f64, into the block's partial, f64 words laid out
// [blocks][3][bw][nsp] (nsp = slices * gw, the count last) so that both
// the writes here and the reduction's reads are coalesced.
template <bool HILO, typename BinT>
__global__ void __launch_bounds__(kMaxWarps * kLanes)
hist_lane_kernel(const BinT* __restrict__ binned, int G,
                 const float* __restrict__ w3, const int* __restrict__ rows,
                 int n, const int* __restrict__ glist, int n_list,
                 const int* __restrict__ widths, int bw, int gw, int run,
                 double* __restrict__ part) {
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
      // lane j's row: its g and h, in hi+lo mode split into their hi
      // and lo halves once and added back in f64 (exactly)
      double v[kAcc];
#pragma unroll
      for (int c = 0; c < kAcc; ++c) {
        if constexpr (HILO) {
          float hi, lo;
          hi_lo(wc[c], hi, lo);
          v[c] = (double)hi + (double)lo;
        } else {
          v[c] = (double)wc[c];
        }
      }
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

  // the warps' histograms added in warp order, in f64, into the block's
  // partial (the sentinel bins left out)
  const int nsp = gridDim.y * gw;
  const int gshift = __ffs(gw) - 1;  // gw is a power of two
  const size_t chan = (size_t)bw * nsp;
  double* const out = part + (size_t)blockIdx.x * (kAcc + 1) * chan +
                      blockIdx.y * gw;
  for (int e = threadIdx.x; e < bw * gw; e += blockDim.x) {
    const size_t at = (size_t)(e >> gshift) * nsp + (e & (gw - 1));
#pragma unroll
    for (int c = 0; c < kAcc; ++c) {
      double sum = 0.0;
      for (int w = 0; w < warps; ++w) {
        sum += reinterpret_cast<const double*>(
            smem + w * warp_bytes)[c * words + e];
      }
      out[c * chan + at] = sum;
    }
    uint32_t count = 0u;
    for (int w = 0; w < warps; ++w) {
      count += reinterpret_cast<const uint32_t*>(
          smem + w * warp_bytes + kAcc * words * 8)[e];
    }
    out[kAcc * chan + at] = (double)count;
  }
}

// out[g, b, :] for the lane-private groups from the blocks' f64
// partials: one thread a (bin, slot), slots adjacent so the reads
// coalesce; the blocks are added in eight interleaved f64 chains (chain
// s adds blocks s, s + 8, ... in order) and the chains in the fixed tree
// ((0+4)+(2+6)) + ((1+5)+(3+7)), and each sum is rounded to f32 once. A
// bin at or past its group's width is written 0.
__global__ void hist_lane_reduce_kernel(const double* __restrict__ part,
                                        int blocks, int bw, int nsp,
                                        const int* __restrict__ glist,
                                        int n_list,
                                        const int* __restrict__ widths,
                                        int B, float* __restrict__ out) {
  constexpr int kCh = 3;  // g, h and the count
  constexpr int kChains = 8;
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n_list * B) return;
  const int b = e / n_list, slot = e % n_list;
  const int g = glist ? glist[slot] : slot;
  const int width = widths ? widths[g] : bw;
  float* o = out + ((size_t)g * B + b) * 3;
  if (b >= width) {
    o[0] = 0.f;
    o[1] = 0.f;
    o[2] = 0.f;
    return;
  }
  double a[kChains][kCh];
#pragma unroll
  for (int s = 0; s < kChains; ++s) {
#pragma unroll
    for (int c = 0; c < kCh; ++c) a[s][c] = 0.0;
  }
  const size_t chan = (size_t)bw * nsp;
  const size_t off = (size_t)b * nsp + slot;
  // two blocks a chain a turn, all their loads in flight together; a
  // block past the last adds +0, which leaves a chain's sum as it is
  // (a sum from +0 is never -0)
  for (int b0 = 0; b0 < blocks; b0 += 2 * kChains) {
    double t[2 * kChains][kCh];
#pragma unroll
    for (int s = 0; s < 2 * kChains; ++s) {
      const bool live = b0 + s < blocks;
      const double* p =
          part + (size_t)(live ? b0 + s : 0) * kCh * chan + off;
#pragma unroll
      for (int c = 0; c < kCh; ++c) {
        const double v = p[c * chan];  // unconditional: block 0 is read
        t[s][c] = live ? v : 0.0;
      }
    }
#pragma unroll
    for (int s = 0; s < 2 * kChains; ++s) {
#pragma unroll
      for (int c = 0; c < kCh; ++c) a[s % kChains][c] += t[s][c];
    }
  }
#pragma unroll
  for (int c = 0; c < kCh; ++c) {
    const double t0 = a[0][c] + a[4][c], t1 = a[1][c] + a[5][c];
    const double t2 = a[2][c] + a[6][c], t3 = a[3][c] + a[7][c];
    o[c] = __double2float_rn((t0 + t2) + (t1 + t3));
  }
}

// The warp-shared scheme, for groups too wide for 32 private copies
// (uint16 matrices): block (tile, y) takes group glist[y]; its warps
// take the tile's rows in turns of 32 (warp w rows begin + 32 * (w +
// warps * k) + lane), and each warp keeps ONE [ch][W] histogram. In each
// turn the lanes that hold the same bin (__match_any_sync) add their
// values in a fixed tree over their rank among those lanes, and the
// lowest of them adds the sum to the shared bin: the leaders of one turn
// hold distinct bins, so no two lanes write one word, and no float
// atomics are needed. The warps' histograms are then added in warp order
// into the tile's partial. Every order depends on the rows' bins only.
template <bool HILO>
__global__ void hist_wide_kernel(const uint16_t* __restrict__ binned, int G,
                                 const float* __restrict__ w3,
                                 const int* __restrict__ rows, int n,
                                 int tile_rows,
                                 const int* __restrict__ glist,
                                 const int* __restrict__ widths,
                                 const int* __restrict__ poff, int elems,
                                 int wmax, float* __restrict__ part) {
  constexpr int kCh = HILO ? 5 : 3;
  extern __shared__ unsigned char smem[];
  const int tile = blockIdx.x;
  const int warps = blockDim.x / kLanes;
  const int warp = threadIdx.x / kLanes;
  const int lane = threadIdx.x % kLanes;
  const int g = glist[blockIdx.y];
  const int W = widths[g];
  // warp w's channels: [kCh][wmax] words at w * kCh * wmax
  float* h = reinterpret_cast<float*>(smem) + (size_t)warp * kCh * wmax;
  for (int e = threadIdx.x; e < warps * kCh * wmax; e += blockDim.x) {
    reinterpret_cast<float*>(smem)[e] = 0.f;
  }
  __syncthreads();
  const int begin = tile * tile_rows;
  const int end = min(n, begin + tile_rows);
  const unsigned below = (1u << lane) - 1u;
  for (int i0 = begin + warp * kLanes + lane; i0 - lane < end;
       i0 += warps * kLanes * kUnroll) {
    int bin[kUnroll];
    float vg[kUnroll], vh[kUnroll];
    uint32_t vc[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int i = i0 + u * warps * kLanes;
      bin[u] = W;
      vg[u] = vh[u] = 0.f;
      vc[u] = 0u;
      if (i < end) {
        const int r = rows ? __ldg(rows + i) : i;
        bin[u] = __ldg(binned + (size_t)r * G + g);
        const float* w = w3 + (size_t)r * 3;
        vg[u] = __ldg(w);
        vh[u] = __ldg(w + 1);
        vc[u] = __ldg(w + 2) > 0.f ? 1u : 0u;
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      float v[kCh];
      if (HILO) {
        hi_lo(vg[u], v[0], v[3]);
        hi_lo(vh[u], v[1], v[4]);
      } else {
        v[0] = vg[u];
        v[1] = vh[u];
      }
      uint32_t k = vc[u];
      const unsigned peers = __match_any_sync(~0u, bin[u]);
      const int rank = __popc(peers & below);
      const int cnt = __popc(peers);
      const int most = __reduce_max_sync(~0u, cnt);
      // pairwise by rank: at step s, rank r (a multiple of 2s) adds the
      // sum held by rank r + s
      for (int s = 1; s < most; s <<= 1) {
        const bool take = (rank % (2 * s)) == 0 && rank + s < cnt;
        const int src = take ? nth_set_lane(peers, rank + s) : lane;
#pragma unroll
        for (int c = 0; c < kCh; ++c) {
          if (c != 2) {
            const float o = __shfl_sync(~0u, v[c], src);
            if (take) v[c] += o;
          }
        }
        const uint32_t ko = __shfl_sync(~0u, k, src);
        if (take) k += ko;
      }
      if (rank == 0 && bin[u] < W) {
#pragma unroll
        for (int c = 0; c < kCh; ++c) {
          if (c != 2) h[c * wmax + bin[u]] += v[c];
        }
        reinterpret_cast<uint32_t*>(h)[2 * wmax + bin[u]] += k;
      }
      __syncwarp();
    }
  }
  __syncthreads();
  // the warps' histograms added in warp order into the tile's partial
  const size_t out0 = (size_t)tile * elems + poff[g];
  const size_t chan = (size_t)gridDim.x * elems;
  const float* all = reinterpret_cast<const float*>(smem);
  for (int b = threadIdx.x; b < W; b += blockDim.x) {
#pragma unroll
    for (int c = 0; c < kCh; ++c) {
      if (c == 2) {
        uint32_t k = 0u;
        for (int w = 0; w < warps; ++w) {
          k += reinterpret_cast<const uint32_t*>(all)[
              ((size_t)w * kCh + 2) * wmax + b];
        }
        reinterpret_cast<uint32_t*>(part)[2 * chan + out0 + b] = k;
      } else {
        float v = 0.f;
        for (int w = 0; w < warps; ++w) {
          v += all[((size_t)w * kCh + c) * wmax + b];
        }
        part[c * chan + out0 + b] = v;
      }
    }
  }
}

// out[g, b, :] of the warp-shared groups wide[0..n_wide-1] = the sum
// over tiles of their partials, one warp per element: lane l adds tiles
// l, l+32, ... in order, then the lanes are added in a fixed tree. Same
// order every run. In hi+lo mode the hi and lo sums are added here, once,
// after all rows. A bin past its group's width is written 0.
template <bool HILO>
__global__ void hist_reduce_kernel(const float* __restrict__ part,
                                   int tiles, int elems, int B,
                                   const int* __restrict__ wide, int n_wide,
                                   const int* __restrict__ widths,
                                   const int* __restrict__ poff,
                                   float* __restrict__ out) {
  constexpr int kCh = HILO ? 5 : 3;
  const int e = blockIdx.x * (blockDim.x / kLanes) + threadIdx.x / kLanes;
  const int lane = threadIdx.x % kLanes;
  if (e >= n_wide * B) return;  // whole warps leave together
  const int g = wide[e / B], b = e % B;
  float* o = out + ((size_t)g * B + b) * 3;
  if (b >= widths[g]) {
    if (lane == 0) {
      o[0] = 0.f;
      o[1] = 0.f;
      o[2] = 0.f;
    }
    return;
  }
  const int src = poff[g] + b;  // the element's word in a tile's partial
  const size_t chan = (size_t)tiles * elems;
  float v[kCh];
#pragma unroll
  for (int c = 0; c < kCh; ++c) v[c] = 0.f;
  uint32_t k = 0u;
  for (int t = lane; t < tiles; t += kLanes) {
    const size_t i = (size_t)t * elems + src;
#pragma unroll
    for (int c = 0; c < kCh; ++c) {
      if (c != 2) v[c] += part[c * chan + i];
    }
    k += reinterpret_cast<const uint32_t*>(part)[2 * chan + i];
  }
  for (int o2 = kLanes / 2; o2 > 0; o2 >>= 1) {
#pragma unroll
    for (int c = 0; c < kCh; ++c) {
      if (c != 2) v[c] += __shfl_down_sync(~0u, v[c], o2);
    }
    k += __shfl_down_sync(~0u, k, o2);
  }
  if (lane == 0) {
    o[0] = HILO ? __fadd_rn(v[0], v[3]) : v[0];
    o[1] = HILO ? __fadd_rn(v[1], v[4]) : v[1];
    o[2] = (float)k;
  }
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

template <bool HILO>
int launch_histogram(const void* binned, int G, int u16, const float* w3,
                     const int* rows, int n, int B, const int* lane,
                     int n_lane, const int* widths, int lane_w, int gw,
                     int warps, int run, int blocks, const int* wide,
                     int n_wide, int wide_w, const int* poff, int elems,
                     int tile_rows, float* scratch, float* out,
                     cudaStream_t s) {
  constexpr int kCh = HILO ? 5 : 3;
  if (n_lane > 0) {
    if (gw < 1 || gw > kLanes || kLanes % gw || warps < 1 ||
        warps > kMaxWarps || run < kLanes || run % kLanes || blocks < 1 ||
        lane_w < 1 || lane_w > B) {
      return (int)cudaErrorInvalidValue;
    }
    // 20 bytes a slot in either mode (ops/histogram.py _warp_bytes)
    const size_t smem =
        (size_t)warps * (((size_t)(lane_w + 1) * gw + 1) / 2 * 2) * 20;
    if (smem > (size_t)kHistSmem) return (int)cudaErrorInvalidValue;
    double* const part = reinterpret_cast<double*>(scratch);
    const int slices = (n_lane + gw - 1) / gw;
    dim3 grid(blocks, slices);
    cudaError_t err;
    if (u16) {
      err = cudaFuncSetAttribute(hist_lane_kernel<HILO, uint16_t>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)smem);
      if (err != cudaSuccess) return (int)err;
      hist_lane_kernel<HILO, uint16_t><<<grid, warps * kLanes, smem, s>>>(
          static_cast<const uint16_t*>(binned), G, w3, rows, n, lane, n_lane,
          widths, lane_w, gw, run, part);
    } else {
      err = cudaFuncSetAttribute(hist_lane_kernel<HILO, uint8_t>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)smem);
      if (err != cudaSuccess) return (int)err;
      hist_lane_kernel<HILO, uint8_t><<<grid, warps * kLanes, smem, s>>>(
          static_cast<const uint8_t*>(binned), G, w3, rows, n, lane, n_lane,
          widths, lane_w, gw, run, part);
    }
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    const int threads = 256;
    const int outs = n_lane * B;
    hist_lane_reduce_kernel<<<(outs + threads - 1) / threads, threads, 0,
                              s>>>(part, blocks, lane_w, slices * gw, lane,
                                   n_lane, widths, B, out);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    // the f64 lane partials take two f32 words each
    scratch += 2 * (size_t)blocks * 3 * lane_w * slices * gw;
  }
  if (n_wide > 0) {
    const int tiles = n > 0 ? (n + tile_rows - 1) / tile_rows : 1;
    const size_t warp_bytes = (size_t)kCh * wide_w * 4;
    int wwarps = (int)(kWideSmem / warp_bytes);
    wwarps = wwarps < 1 ? 1 : (wwarps > kWideWarps ? kWideWarps : wwarps);
    const size_t smem = warp_bytes * wwarps;
    cudaError_t err = cudaFuncSetAttribute(
        hist_wide_kernel<HILO>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
    dim3 grid(tiles, n_wide);
    hist_wide_kernel<HILO><<<grid, wwarps * kLanes, smem, s>>>(
        static_cast<const uint16_t*>(binned), G, w3, rows, n, tile_rows,
        wide, widths, poff, elems, wide_w, scratch);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    const int per_block = 8;  // warps, one element each
    const size_t outs = (size_t)n_wide * B;
    hist_reduce_kernel<HILO><<<(int)((outs + per_block - 1) / per_block),
                               per_block * kLanes, 0, s>>>(
        scratch, tiles, elems, B, wide, n_wide, widths, poff, out);
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
// matrix (hist_layout): wide[n_wide] (at most wide_w bins), their first
// words poff [G] in a tile's partial of elems words, tiles of tile_rows
// rows (hist_tile_rows). scratch: the lane partials, blocks * ch * lane_w
// * ceil(n_lane / gw) * gw f64 words, then the wide ones, ch * tiles *
// elems f32 words (ch = 5 in hi+lo mode, else 3). Returns
// cudaGetLastError().
extern "C" int lgbt_leaf_histogram(const void* binned, int G, int u16,
                                   const float* w3, const int* rows, int n,
                                   int B, int hilo, const int* lane,
                                   int n_lane, const int* widths, int lane_w,
                                   int gw, int warps, int run, int blocks,
                                   const int* wide, int n_wide, int wide_w,
                                   const int* poff, int elems, int tile_rows,
                                   void* scratch, float* out, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  float* part = (float*)scratch;
  return hilo ? launch_histogram<true>(binned, G, u16, w3, rows, n, B, lane,
                                       n_lane, widths, lane_w, gw, warps,
                                       run, blocks, wide, n_wide, wide_w,
                                       poff, elems, tile_rows, part, out, s)
              : launch_histogram<false>(binned, G, u16, w3, rows, n, B, lane,
                                        n_lane, widths, lane_w, gw, warps,
                                        run, blocks, wide, n_wide, wide_w,
                                        poff, elems, tile_rows, part, out, s);
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
