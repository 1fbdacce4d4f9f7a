// Kernel LM, leaf_moments, of lightgbm_tpu_torch: per (leaf id, feature,
// bin) the raw-value moments (sum x*m, sum x^2*m, sum x*g*m, sum x*h*m)
// of the rows whose leaf id is one of C ids, built for sm_90a by
// ops/_build.py and called through ctypes from ops/histogram.py.
//
// Replaces, in lightgbm_tpu/ops/histogram.py: batched_leaves_moments
// (:679, rows whose leaf_id is one of C ids), the mode
// lightgbm_tpu/linear/stats.py:34 leaf_feature_moments runs, and with
// it leaf_moments (:622, all rows: one id over a constant leaf_id) and
// gathered_leaves_moments (:726), with _moment_channels (:596) and
// _contract_moment_block_parts (:558). The TPU contracts a one-hot
// weighted by x (and x^2) against the (m, g*m, h*m) channels on its
// matrix unit; here the rows are sorted by leaf and each leaf's rows
// are added as kernel H adds a leaf's: a row read once a slice of
// features, its terms added into private shared-memory sums in f64.
//
// One C entry, lgbt_leaf_moments, launches everything on the caller's
// stream; nothing is read back to the host between the launches. The
// same bits every launch and no float atomics:
// - the sort, a stable counting sort of the rows by slot (the c with
//   ids[c] == leaf_id[r], by binary search in the ids sorted on the
//   host; rows of no id are dropped), all in integers. Count: one warp a
//   sort tile of rows, four turns of 32 rows loaded at once, counts its
//   rows of each slot (in shared memory while C <= kSortSlots) into
//   cnt[s * T + t] (slot-major, so the scan runs in memory order). Scan:
//   blocks of kScanChunk counters sum theirs and the last block to
//   finish (a ticket, as in split_scan.cu) scans the block sums; then
//   each block rescans its chunk into exclusive offsets, slot c's rows
//   starting at begin[c], and the last block to finish builds the tile
//   table: slot c's segment cut into ceil(rows / tile) tiles of `tile`
//   rows from its start (ops/histogram.py segment_tiles' cut), its first
//   tile (a scan) and, for a slot of two tiles or more, its first
//   partial. Scatter: each warp writes its rows, in row order, to their
//   slots' segments. T is sized so that C x T stays at most
//   MOMENT_MAX_SORT_CELLS (1 MB of counters for 255 ids over 2,000,000
//   rows).
// - the moments: a grid of ceil(n / tile) + C tiles (a bound on the
//   table's count) by feature slices, the slice fastest so that a tile's
//   slices read its rows out of L2 together; a block finds its (slot,
//   first, rows) in the table by binary search, and a block past the
//   table's count exits. Each term is formed in f32 as the JAX package
//   forms it (x*m, (x*x)*m, x*(g*m), x*(h*m), x 0 when not finite) and
//   added in f64 from +0, one chain a (feature, bin) in row order.
//   uint8 bins, moment_lane_kernel (H's hist_lane_kernel): warp w adds
//   positions w * run .. (w + 1) * run - 1 of the tile, lane l owns
//   feature y * gw + l and a column of the warp's [4][B + 1][gw] sums (a
//   sentinel bin takes what is not added, so every add is
//   unconditional); per 32 rows lane j reads row j's order entry and
//   channels once, shuffles hand them to the other lanes, and each lane
//   reads its feature's bin and value (a row's F bytes and 4F bytes read
//   together); four rows' read-add-writes overlap, in row order; then
//   the warps are added in warp order. uint16 bins (up to
//   MAX_GROUP_BINS), moment_wide_kernel: a lane's [4][B] f64 column does
//   not fit, so a warp owns one feature's histogram and its lanes take
//   32 rows at a time, staged by the block; the lanes of one bin add in
//   lane order, by rounds of integer claims. A slot of one tile is
//   rounded to f32 into the output at once; a slot of more tiles writes
//   f64 partials that moment_reduce_kernel adds in tile order and rounds
//   once (a slot of no rows gets 0). ops/histogram.py
//   leaf_moments_order replays this order bit for bit.
// x is aligned column for column with the bins: the caller resolves
// EFB, as lightgbm_tpu/ops/histogram.py:622-640 documents.
//
// Bound on an H100 SXM (3.35 TB/s): every input byte read once, a row's
// F bins (1 or 2 bytes each), F raw values (4 bytes each), 12 bytes of
// channels and 4 of leaf id, and the [C, F, B, 4] f32 output written
// once: for the 255 leaves of a main-path tree (2,000,000 rows x 28
// features, B 64) 156 bytes a row and 7 MB of output, 0.095 ms; at
// max_bin=1023 (B 1024, uint16) 184 bytes a row and 117 MB, 0.145 ms.
// The sort adds 20 bytes a row (slot and order written and read, the
// leaf id read twice), a multi-tile slot's partials 32 bytes a (feature,
// bin) a tile written and read. What bounds it now is latency, not
// bytes: the rows are gathered through the sorted order (a leaf's rows
// far apart, whole 32-byte sectors a row), and the f64 sums cap the
// warps an SM holds: the lane-private kernel's 66.5 KB a warp at B 64
// leave 3 warps an SM, each waiting on its gathers and on its shared
// read-add-writes in turn; the warp-shared kernel's 32 KB a warp at B
// 1024 leave two blocks of two warps an SM, and a row's order entry and
// channels are read once a slice of two features (14 slices at 28
// features), its random bins cost bank conflicts on every f64
// read-add-write, and the claims a round of shared atomics a turn.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 32;
constexpr int kChannels = 4;
constexpr int kSortWarps = 4;      // sort tiles (one warp each) a block
constexpr int kSortSlots = 2048;   // slots a warp counts in shared memory
constexpr int kTurns = 4;          // turns of 32 rows a sort warp loads at once
constexpr int kScanThreads = 256;
constexpr int kScanChunk = 4096;   // counters a scan block (MOMENT_SCAN_CHUNK)
constexpr int kGroup = 4;          // rows whose read-add-writes overlap
// rows the warp-shared kernel stages (ops/histogram.py MOMENT_STAGE_ROWS)
constexpr int kStageRows = 256;
constexpr int kStageData = kStageRows / kLanes;  // rows a staging thread
constexpr int kReduceThreads = 256;
constexpr int kReduceWords = 4;    // output words a reduction thread
constexpr int kReduceBatch = 8;    // tiles a reduction thread loads at once

// the block's exclusive prefix of one int a thread (blockDim.x a
// multiple of 32) and, in *total, the block's sum; every thread calls it
__device__ int block_exclusive(int v, int* total) {
  __shared__ int sums[kLanes];
  const int lane = threadIdx.x % kLanes;
  const int warp = threadIdx.x / kLanes;
  const int warps = blockDim.x / kLanes;
  int incl = v;
  for (int o = 1; o < kLanes; o <<= 1) {
    const int u = __shfl_up_sync(~0u, incl, o);
    if (lane >= o) incl += u;
  }
  if (lane == kLanes - 1) sums[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    int s = lane < warps ? sums[lane] : 0;
    for (int o = 1; o < kLanes; o <<= 1) {
      const int u = __shfl_up_sync(~0u, s, o);
      if (lane >= o) s += u;
    }
    sums[lane] = s;
  }
  __syncthreads();
  const int base = warp ? sums[warp - 1] : 0;
  *total = sums[warps - 1];
  __syncthreads();  // sums is free for the next call
  return base + incl - v;
}

// the first j with sid[j] >= v (sid sorted ascending, C entries), for
// kTurns values at once so that their loads overlap; steps = the
// highest power of two <= C
__device__ __forceinline__ void lower_bounds(const int (&v)[kTurns],
                                             const int* __restrict__ sid,
                                             int C, int steps,
                                             int (&pos)[kTurns]) {
#pragma unroll
  for (int u = 0; u < kTurns; ++u) pos[u] = 0;
  for (int k = steps; k > 0; k >>= 1) {
#pragma unroll
    for (int u = 0; u < kTurns; ++u) {
      if (pos[u] + k <= C && __ldg(sid + pos[u] + k - 1) < v[u]) pos[u] += k;
    }
  }
}

// a warp's running count of each slot: in shared memory when the C
// slots fit (kSortSlots), else the tile's column of cnt itself
struct SlotCounts {
  int* at;
  int step;
  __device__ int& operator[](int s) const { return at[(size_t)s * step]; }
};

__device__ SlotCounts slot_counts(int* smem, int* cnt, int C, int T, int t,
                                  int warp) {
  if (C <= kSortSlots) return SlotCounts{smem + warp * C, 1};
  return SlotCounts{cnt + t, T};
}

// one warp a sort tile, kTurns turns of 32 rows at a time: slot[i] of
// its rows, and cnt[s * T + t] the number of its rows of slot s (cnt
// zeroed before; counted in shared memory when the slots fit)
__global__ void moment_count_kernel(const int* __restrict__ leaf_id, int n,
                                    const int* __restrict__ sid,
                                    const int* __restrict__ sslot, int C,
                                    int steps, int T, int tile_rows,
                                    int* __restrict__ slot,
                                    int* __restrict__ cnt) {
  extern __shared__ int sort_smem[];
  const int warp = threadIdx.x / kLanes;
  const int t = blockIdx.x * kSortWarps + warp;
  const int lane = threadIdx.x % kLanes;
  if (t >= T) return;  // whole warps; no block-wide barrier follows
  const SlotCounts run = slot_counts(sort_smem, cnt, C, T, t, warp);
  if (run.step == 1) {
    for (int s = lane; s < C; s += kLanes) run[s] = 0;
    __syncwarp();
  }
  const long long begin = (long long)t * tile_rows;
  const long long end = min((long long)n, begin + tile_rows);
  for (long long i0 = begin; i0 < end; i0 += kTurns * kLanes) {
    int v[kTurns], pos[kTurns];
#pragma unroll
    for (int u = 0; u < kTurns; ++u) {
      const long long i = i0 + u * kLanes + lane;
      v[u] = i < end ? __ldg(leaf_id + i) : 0;
    }
    lower_bounds(v, sid, C, steps, pos);
#pragma unroll
    for (int u = 0; u < kTurns; ++u) {
      const long long i = i0 + u * kLanes + lane;
      const int s = i < end && pos[u] < C && __ldg(sid + pos[u]) == v[u]
                        ? __ldg(sslot + pos[u]) : -1;
      if (i < end) slot[i] = s;
      const unsigned group = __match_any_sync(~0u, s);
      if (s >= 0 && lane == __ffs(group) - 1) {
        if (run.step == 1) {
          run[s] += __popc(group);
        } else {
          atomicAdd(&run[s], __popc(group));
        }
      }
      __syncwarp();
    }
  }
  if (run.step == 1) {
    for (int s = lane; s < C; s += kLanes) cnt[(size_t)s * T + t] = run[s];
  }
}

// block b sums cnt[b * kScanChunk ..] into bsum[b]; the last block to
// finish turns bsum into exclusive offsets and writes the total
__global__ void moment_scan_kernel(const int* __restrict__ cnt, int M,
                                   int* __restrict__ bsum,
                                   int* __restrict__ ticket,
                                   int* __restrict__ total_out) {
  __shared__ bool last;
  const int lo = blockIdx.x * kScanChunk;
  const int hi = min(M, lo + kScanChunk);
  int s = 0;
  for (int i = lo + threadIdx.x; i < hi; i += blockDim.x) s += cnt[i];
  int tot;
  block_exclusive(s, &tot);
  if (threadIdx.x == 0) {
    bsum[blockIdx.x] = tot;
    __threadfence();
    last = atomicAdd(ticket, 1) == (int)gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  int carry = 0;
  for (int b0 = 0; b0 < (int)gridDim.x; b0 += blockDim.x) {
    const int b = b0 + threadIdx.x;
    const int v = b < (int)gridDim.x ? __ldcg(bsum + b) : 0;
    int seg;
    const int ex = block_exclusive(v, &seg);
    if (b < (int)gridDim.x) bsum[b] = carry + ex;
    carry += seg;
  }
  if (threadIdx.x == 0) {
    *total_out = carry;
    *ticket = 0;  // for the next launch
  }
}

// block b rescans its chunk of cnt into exclusive offsets (in place;
// table[s] = begin[s], the offset of (s, 0)); the last block to finish
// builds the tile table after begin [C + 1]: tile_first [C], tile_count
// [C], pfirst [C] and the tile total
__global__ void moment_offset_kernel(int* __restrict__ cnt, int M, int T,
                                     int C, const int* __restrict__ bsum,
                                     int* __restrict__ ticket, int tile_rows,
                                     int* __restrict__ table) {
  __shared__ bool last;
  const int lo = blockIdx.x * kScanChunk;
  const int hi = min(M, lo + kScanChunk);
  int carry = bsum[blockIdx.x];
  for (int seg = lo; seg < hi; seg += blockDim.x) {
    const int i = seg + threadIdx.x;
    const int v = i < hi ? cnt[i] : 0;
    int segsum;
    const int ex = block_exclusive(v, &segsum);
    if (i < hi) {
      cnt[i] = carry + ex;
      if (i % T == 0) table[i / T] = carry + ex;
    }
    carry += segsum;
  }
  if (threadIdx.x == 0) {
    __threadfence();
    last = atomicAdd(ticket, 1) == (int)gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  int* first = table + C + 1;
  int* count = first + C;
  int* pfirst = count + C;
  int c1 = 0, c2 = 0;
  for (int s0 = 0; s0 < C; s0 += blockDim.x) {
    const int s = s0 + threadIdx.x;
    const int rows =
        s < C ? __ldcg(table + s + 1) - __ldcg(table + s) : 0;
    const int nt = (rows + tile_rows - 1) / tile_rows;
    int t1, t2;
    const int e1 = block_exclusive(nt, &t1);
    const int e2 = block_exclusive(nt >= 2 ? nt : 0, &t2);
    if (s < C) {
      first[s] = c1 + e1;
      count[s] = nt;
      pfirst[s] = c2 + e2;
    }
    c1 += t1;
    c2 += t2;
  }
  if (threadIdx.x == 0) {
    table[4 * C + 1] = c1;
    *ticket = 0;  // for the next launch
  }
}

// one warp a sort tile, kTurns turns at a time: its rows of slot s, in
// row order, from the offset cnt[s * T + t] on (advanced as they are
// written, in shared memory when the slots fit)
__global__ void moment_scatter_kernel(const int* __restrict__ slot, int n,
                                      int C, int T, int tile_rows,
                                      int* __restrict__ cnt,
                                      int* __restrict__ order) {
  extern __shared__ int sort_smem[];
  const int warp = threadIdx.x / kLanes;
  const int t = blockIdx.x * kSortWarps + warp;
  const int lane = threadIdx.x % kLanes;
  if (t >= T) return;
  const SlotCounts run = slot_counts(sort_smem, cnt, C, T, t, warp);
  if (run.step == 1) {
    for (int s = lane; s < C; s += kLanes) run[s] = cnt[(size_t)s * T + t];
    __syncwarp();
  }
  const long long begin = (long long)t * tile_rows;
  const long long end = min((long long)n, begin + tile_rows);
  const unsigned below = (1u << lane) - 1u;
  for (long long i0 = begin; i0 < end; i0 += kTurns * kLanes) {
    int sl[kTurns];
#pragma unroll
    for (int u = 0; u < kTurns; ++u) {
      const long long i = i0 + u * kLanes + lane;
      sl[u] = i < end ? __ldg(slot + i) : -1;
    }
#pragma unroll
    for (int u = 0; u < kTurns; ++u) {
      const int s = sl[u];
      const unsigned group = __match_any_sync(~0u, s);
      const int leader = __ffs(group) - 1;
      const int cur = (s >= 0 && lane == leader) ? run[s] : 0;
      const int base = __shfl_sync(~0u, cur, leader);
      if (s >= 0) {
        order[base + __popc(group & below)] = (int)(i0 + u * kLanes + lane);
        if (lane == leader) run[s] = cur + __popc(group);
      }
      __syncwarp();
    }
  }
}

// a moment tile: its slot, first position in order, rows, and its
// partial (-1: the slot's only tile, rounded into the output at once)
struct Tile {
  int slot, first, rows, part;
};

// tile e of the table (begin [C + 1], tile_first, tile_count, pfirst
// [C] each, total): false past the total. Its slot is the largest s
// with tile_first[s] <= e, which holds rows when e < total.
__device__ bool tile_of(int e, const int* __restrict__ table, int C,
                        int tile_rows, Tile& t) {
  const int* first = table + C + 1;
  const int* count = first + C;
  const int* pfirst = count + C;
  if (e >= __ldg(table + 4 * C + 1)) return false;
  int lo = 0, hi = C - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (__ldg(first + mid) <= e) {
      lo = mid;
    } else {
      hi = mid - 1;
    }
  }
  const int j = e - __ldg(first + lo);
  const int seg = __ldg(table + lo + 1) - __ldg(table + lo);
  t.slot = lo;
  t.first = __ldg(table + lo) + j * tile_rows;
  t.rows = min(tile_rows, seg - j * tile_rows);
  t.part = __ldg(count + lo) > 1 ? __ldg(pfirst + lo) + j : -1;
  return true;
}

// the four f32 terms of value v with channels (g*m, h*m, m), as the JAX
// package forms them; a non-finite v adds 0
__device__ __forceinline__ void terms(float v, float gm, float hm, float m,
                                      float (&t)[kChannels]) {
  const float xv = isfinite(v) ? v : 0.f;
  t[0] = __fmul_rn(xv, m);
  t[1] = __fmul_rn(__fmul_rn(xv, xv), m);
  t[2] = __fmul_rn(xv, gm);
  t[3] = __fmul_rn(xv, hm);
}

// uint8 bins: block (tile e, slice y) = blockIdx.x / slices, % slices.
// Warp w adds positions w * run .. of the tile, lane l feature y * gw +
// l, into the warp's [4][(B + 1) * gw] f64 sums (bin b of lane l's
// column at b * gw + l, bin B the sentinel); then the warps are added in
// warp order into the tile's words of the slice, [F][B][4] a slot.
__global__ void __launch_bounds__(8 * kLanes)
moment_lane_kernel(const uint8_t* __restrict__ binned, int F,
                   const float* __restrict__ x, const float* __restrict__ w3,
                   const int* __restrict__ order,
                   const int* __restrict__ table, int C, int B, int gw,
                   int run, int slices, double* __restrict__ part,
                   float* __restrict__ out) {
  extern __shared__ __align__(16) double hist[];
  const int warps = blockDim.x / kLanes;
  const int warp = threadIdx.x / kLanes;
  const int lane = threadIdx.x % kLanes;
  const int y = blockIdx.x % slices;
  Tile tl;
  if (!tile_of(blockIdx.x / slices, table, C, warps * run, tl)) return;
  const int words = (B + 1) * gw;
  double* h = hist + (size_t)warp * kChannels * words;
  {
    const int all = warps * kChannels * words / 2;  // words * 4 is even
    for (int e = threadIdx.x; e < all; e += blockDim.x) {
      reinterpret_cast<double2*>(hist)[e] = make_double2(0.0, 0.0);
    }
  }
  const int f = y * gw + lane;
  const bool owner = lane < gw && f < F;
  const int fo = owner ? f : 0;  // a lane past the slice reads feature 0
  const int col = lane & (gw - 1);
  __syncthreads();

  const int lo = warp * run;
  const int hi = min(tl.rows, lo + run);
  if (lo < hi) {
    const int* ord = order + tl.first;
    // the row of position p, clamped into the run: every load below is
    // unconditional, and positions past the run add to the sentinel
    auto row_of = [&](int p) { return __ldg(ord + min(p, hi - 1)); };
    // lane j's row's channels, and each lane's bin and value of the 32
    // rows
    auto load = [&](int r, float (&w)[3], int (&bin)[kLanes],
                    float (&v)[kLanes]) {
      const float* p = w3 + (size_t)r * 3;
      w[0] = __ldg(p);
      w[1] = __ldg(p + 1);
      w[2] = __ldg(p + 2);
#pragma unroll
      for (int j = 0; j < kLanes; ++j) {
        const size_t at = (size_t)__shfl_sync(~0u, r, j) * F + fo;
        bin[j] = (int)__ldg(binned + at);
        v[j] = __ldg(x + at);
      }
    };
    // software pipelined: the next 32 rows' loads are in flight while
    // this 32's are added, and the order entries two turns ahead
    float wc[3], wn[3];
    int bc[kLanes], bn[kLanes];
    float vc[kLanes], vn[kLanes];
    int r_next = row_of(lo + kLanes + lane);
    load(row_of(lo + lane), wc, bc, vc);
    for (int base = lo; base < hi; base += kLanes) {
      load(r_next, wn, bn, vn);
      r_next = row_of(base + 2 * kLanes + lane);
      const int m = min(kLanes, hi - base);
      // four rows at a time: their words are read together, added in
      // row order (a row whose word an earlier one of the four holds
      // takes that row's sum) and written back in row order, so the
      // last write of a word is its latest sum
#pragma unroll
      for (int q = 0; q < kLanes; q += kGroup) {
        float t[kGroup][kChannels];
        int e[kGroup];
#pragma unroll
        for (int i = 0; i < kGroup; ++i) {
          const int j = q + i;
          terms(vc[j], __shfl_sync(~0u, wc[0], j),
                __shfl_sync(~0u, wc[1], j), __shfl_sync(~0u, wc[2], j),
                t[i]);
          const int b = owner && j < m && bc[j] < B ? bc[j] : B;
          e[i] = b * gw + col;
        }
        double o[kGroup][kChannels];
#pragma unroll
        for (int i = 0; i < kGroup; ++i) {
#pragma unroll
          for (int c = 0; c < kChannels; ++c) o[i][c] = h[c * words + e[i]];
        }
        const bool s10 = e[1] == e[0], s21 = e[2] == e[1];
        const bool s20 = e[2] == e[0], s32 = e[3] == e[2];
        const bool s31 = e[3] == e[1], s30 = e[3] == e[0];
#pragma unroll
        for (int c = 0; c < kChannels; ++c) {
          const double a0 = o[0][c] + (double)t[0][c];
          const double a1 = (s10 ? a0 : o[1][c]) + (double)t[1][c];
          const double a2 =
              (s21 ? a1 : s20 ? a0 : o[2][c]) + (double)t[2][c];
          const double a3 =
              (s32 ? a2 : s31 ? a1 : s30 ? a0 : o[3][c]) + (double)t[3][c];
          h[c * words + e[0]] = a0;
          h[c * words + e[1]] = a1;
          h[c * words + e[2]] = a2;
          h[c * words + e[3]] = a3;
        }
      }
#pragma unroll
      for (int j = 0; j < kLanes; ++j) {
        bc[j] = bn[j];
        vc[j] = vn[j];
      }
      wc[0] = wn[0];
      wc[1] = wn[1];
      wc[2] = wn[2];
    }
  }
  __syncthreads();
  // the warps added in warp order into the slice's words of the tile:
  // consecutive threads on consecutive words of [F][B][4]
  const int nf = min(gw, F - y * gw);
  const size_t slot_words = (size_t)F * B * kChannels;
  for (int fl = 0; fl < nf; ++fl) {
    const size_t at = (size_t)(y * gw + fl) * B * kChannels;
    for (int i = threadIdx.x; i < B * kChannels; i += blockDim.x) {
      const int b = i >> 2, c = i & 3;
      double a = 0.0;
      for (int w = 0; w < warps; ++w) {
        a += hist[((size_t)w * kChannels + c) * words + b * gw + fl];
      }
      if (tl.part < 0) {
        out[tl.slot * slot_words + at + i] = __double2float_rn(a);
      } else {
        part[tl.part * slot_words + at + i] = a;
      }
    }
  }
}

// uint16 bins, W warps a block: block (tile e, slice y) = blockIdx.x /
// slices, % slices; warp w owns feature y * W + w, a [4][B] f64
// histogram and a claim word a bin. The block stages kStageRows rows at
// a time (values [W][kStageRows + 1], channels [kStageRows][3], bins
// [W][kStageRows + 2]), the next chunk's loads in flight while this one
// is added and its order entries a chunk further ahead; thread t loads
// feature t % W of rows t / W + 32k, and the threads of features 0-2
// also the channels of those rows. Per 32 staged rows the lanes claim
// their bins in rounds (an integer atomicMin of the lane into the bin's
// claim): the lowest pending lane of a bin adds its terms and frees the
// claim, so each (feature, bin) adds the tile's rows in row order, one
// f64 chain as in the uint8 kernel; a round adds one row a bin, and
// most turns of 32 rows over hundreds of bins need one.
template <int W>
__global__ void __launch_bounds__(W * kLanes)
moment_wide_kernel(const uint16_t* __restrict__ binned, int F,
                   const float* __restrict__ x, const float* __restrict__ w3,
                   const int* __restrict__ order,
                   const int* __restrict__ table, int C, int B,
                   int tile_rows, int slices, double* __restrict__ part,
                   float* __restrict__ out) {
  // a thread's channel words: (row, channel) of channels c, c + W, ...
  // below 3 of its rows, for its feature c
  constexpr int kChan = (3 + W - 1) / W;
  extern __shared__ __align__(16) double hist[];
  const int warp = threadIdx.x / kLanes;
  const int lane = threadIdx.x % kLanes;
  const int y = blockIdx.x % slices;
  Tile tl;
  if (!tile_of(blockIdx.x / slices, table, C, tile_rows, tl)) return;
  const int f0 = y * W;
  const int f = f0 + warp;
  double* h = hist + (size_t)warp * kChannels * B;
  float* sx = reinterpret_cast<float*>(hist + (size_t)W * kChannels * B);
  float* sw = sx + W * (kStageRows + 1);
  int* claims = reinterpret_cast<int*>(sw + kStageRows * 3);
  int* claim = claims + (size_t)warp * B;
  uint16_t* sb = reinterpret_cast<uint16_t*>(claims + W * B);
  for (int e = threadIdx.x; e < W * kChannels * B / 2; e += W * kLanes) {
    reinterpret_cast<double2*>(hist)[e] = make_double2(0.0, 0.0);
  }
  for (int e = threadIdx.x; e < W * B; e += W * kLanes) claims[e] = kLanes;
  const int* ord = order + tl.first;
  const int rows = tl.rows;
  const int fk = threadIdx.x % W;      // this thread's feature of the slice
  const int p0 = threadIdx.x / W;      // and its first row of a chunk
  const bool feat = f0 + fk < F;
  int rd[kStageData], db[kStageData];
  float dx[kStageData], dw[kStageData][kChan];
  auto load_order = [&](int c0) {
#pragma unroll
    for (int k = 0; k < kStageData; ++k) {
      const int p = c0 + p0 + k * kLanes;
      rd[k] = p < rows ? __ldg(ord + p) : -1;
    }
  };
  auto load_data = [&]() {
#pragma unroll
    for (int k = 0; k < kStageData; ++k) {
      const bool ok = rd[k] >= 0;
      const size_t at = ok && feat ? (size_t)rd[k] * F + f0 + fk : 0;
      db[k] = ok && feat ? (int)__ldg(binned + at) : B;
      dx[k] = ok && feat ? __ldg(x + at) : 0.f;
#pragma unroll
      for (int j = 0; j < kChan; ++j) {
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
      sx[fk * (kStageRows + 1) + p] = dx[k];
#pragma unroll
      for (int j = 0; j < kChan; ++j) {
        const int c = fk + j * W;
        if (c < 3) sw[p * 3 + c] = dw[k][j];
      }
    }
  };
  const int chunks = (rows + kStageRows - 1) / kStageRows;
  load_order(0);
  load_data();
  if (chunks > 1) load_order(kStageRows);
  for (int ci = 0; ci < chunks; ++ci) {
    __syncthreads();  // the zeroing, and the last chunk's adds, are done
    store();
    __syncthreads();
    if (ci + 1 < chunks) load_data();
    if (ci + 2 < chunks) load_order((ci + 2) * kStageRows);
    const int np = min(kStageRows, rows - ci * kStageRows);
    if (f >= F) continue;
    for (int q = 0; q < np; q += kLanes) {
      const int p = q + lane;
      const int bin = p < np ? (int)sb[warp * (kStageRows + 2) + p] : B;
      float t[kChannels];
      terms(sx[warp * (kStageRows + 1) + p], sw[p * 3], sw[p * 3 + 1],
            sw[p * 3 + 2], t);
      double d[kChannels];
#pragma unroll
      for (int c = 0; c < kChannels; ++c) d[c] = (double)t[c];
      // rounds of claims: the lowest pending lane of each bin adds its
      // terms and frees the bin's claim for the next, so the rows of one
      // bin add in row order
      bool pending = bin < B;
      while (__any_sync(~0u, pending)) {
        if (pending) atomicMin(claim + bin, lane);
        __syncwarp();
        const bool first = pending && claim[bin] == lane;
        __syncwarp();
        if (first) {
#pragma unroll
          for (int c = 0; c < kChannels; ++c) h[c * B + bin] += d[c];
          claim[bin] = kLanes;
          pending = false;
        }
        __syncwarp();
      }
    }
  }
  __syncthreads();
  if (f >= F) return;
  const size_t slot_words = (size_t)F * B * kChannels;
  const size_t at0 = (size_t)f * B * kChannels;
  for (int b = lane; b < B; b += kLanes) {
    const double a0 = h[b], a1 = h[B + b], a2 = h[2 * B + b],
                 a3 = h[3 * B + b];
    if (tl.part < 0) {
      reinterpret_cast<float4*>(out + tl.slot * slot_words + at0)[b] =
          make_float4(__double2float_rn(a0), __double2float_rn(a1),
                      __double2float_rn(a2), __double2float_rn(a3));
    } else {
      double2* pw = reinterpret_cast<double2*>(
          part + tl.part * slot_words + at0 + (size_t)b * kChannels);
      pw[0] = make_double2(a0, a1);
      pw[1] = make_double2(a2, a3);
    }
  }
}

// out[s] = its tiles' partials added in tile order in f64 and rounded
// once, for a slot of no tile (0) or of two or more; blocks (slot, chunk
// of kReduceWords * kReduceThreads words); kReduceBatch tiles' loads in
// flight at once, added in order
__global__ void moment_reduce_kernel(const double* __restrict__ part,
                                     const int* __restrict__ table, int C,
                                     int words, int per,
                                     float* __restrict__ out) {
  const int s = blockIdx.x / per;
  const int chunk = blockIdx.x % per;
  const int count = __ldg(table + 2 * C + 1 + s);
  if (count == 1) return;  // written by its tile
  const double* p = part + (size_t)__ldg(table + 3 * C + 1 + s) * words;
  const int w0 = chunk * kReduceWords * kReduceThreads + threadIdx.x;
  double a[kReduceWords];
#pragma unroll
  for (int k = 0; k < kReduceWords; ++k) a[k] = 0.0;
  for (int j0 = 0; j0 < count; j0 += kReduceBatch) {
    double v[kReduceBatch][kReduceWords];
#pragma unroll
    for (int j = 0; j < kReduceBatch; ++j) {
#pragma unroll
      for (int k = 0; k < kReduceWords; ++k) {
        const int w = w0 + k * kReduceThreads;
        v[j][k] = j0 + j < count && w < words
                      ? __ldg(p + (size_t)(j0 + j) * words + w) : 0.0;
      }
    }
#pragma unroll
    for (int j = 0; j < kReduceBatch; ++j) {
#pragma unroll
      for (int k = 0; k < kReduceWords; ++k) {
        if (j0 + j < count) a[k] += v[j][k];
      }
    }
  }
#pragma unroll
  for (int k = 0; k < kReduceWords; ++k) {
    const int w = w0 + k * kReduceThreads;
    if (w < words) out[(size_t)s * words + w] = __double2float_rn(a[k]);
  }
}

// moment_wide_kernel<W>'s launch
template <int W>
cudaError_t wide(const void* binned, int F, const float* x, const float* w3,
                 const int* order, const int* table, int C, int B,
                 int tile_rows, int slices, double* part, float* out,
                 unsigned grid, int smem, cudaStream_t s) {
  cudaError_t err = cudaFuncSetAttribute(
      moment_wide_kernel<W>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  moment_wide_kernel<W><<<grid, W * kLanes, smem, s>>>(
      static_cast<const uint16_t*>(binned), F, x, w3, order, table, C, B,
      tile_rows, slices, part, out);
  return cudaGetLastError();
}

}  // namespace

// binned [n, F] u8 or (u16 != 0) u16 (per-feature bins); x [n, F] f32
// aligned with them; w3 [n, 3] f32 = (g*m, h*m, m); leaf_id [n] i32;
// keys [2C] i32: the ids sorted ascending (distinct), then their slots
// (positions in ids); out [C, F, B, 4] f32. The plan (ops/histogram.py
// moment_plan): T sort tiles, P scan blocks (ceil(C * T / kScanChunk)),
// tiles of tile_rows rows (warps * run for uint8 bins), gw features a
// warp (uint8) and warps a block, slices of features, max_tiles (at
// least the table's count), smem bytes a block. iscratch: 2 + C * T + P +
// 4C + 2 + 2n int32; part: the partials, f64 (F * B * 4 a tile).
extern "C" int lgbt_leaf_moments(const void* binned, int n, int F, int u16,
                                 const float* x, const float* w3,
                                 const int* leaf_id, const int* keys, int C,
                                 int B, int T, int P, int tile_rows, int gw,
                                 int warps, int slices, int max_tiles,
                                 int smem, int* iscratch, double* part,
                                 float* out, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (C <= 0) return 0;
  const size_t words = (size_t)F * B * kChannels;
  if (n <= 0 || F <= 0) {
    return (int)cudaMemsetAsync(out, 0, C * words * sizeof(float), s);
  }
  int* tickets = iscratch;
  int* cnt = tickets + 2;
  int* bsum = cnt + (size_t)C * T;
  int* table = bsum + P;
  int* slot = table + 4 * C + 2;
  int* order = slot + n;
  cudaError_t err = cudaMemsetAsync(
      iscratch, 0, (2 + (size_t)C * T) * sizeof(int), s);
  if (err != cudaSuccess) return (int)err;
  const int sort_rows = (n + T - 1) / T;
  const int sort_blocks = (T + kSortWarps - 1) / kSortWarps;
  const size_t sort_smem =
      C <= kSortSlots ? (size_t)kSortWarps * C * sizeof(int) : 0;
  int steps = 1;
  while (2 * steps <= C) steps *= 2;
  moment_count_kernel<<<sort_blocks, kSortWarps * kLanes, sort_smem, s>>>(
      leaf_id, n, keys, keys + C, C, steps, T, sort_rows, slot, cnt);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  moment_scan_kernel<<<P, kScanThreads, 0, s>>>(cnt, C * T, bsum, tickets,
                                                table + C);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  moment_offset_kernel<<<P, kScanThreads, 0, s>>>(
      cnt, C * T, T, C, bsum, tickets + 1, tile_rows, table);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  moment_scatter_kernel<<<sort_blocks, kSortWarps * kLanes, sort_smem, s>>>(
      slot, n, C, T, sort_rows, cnt, order);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const unsigned grid = (unsigned)max_tiles * (unsigned)slices;
  if (u16) {
    // MOMENT_WIDE_WARPS (ops/histogram.py) warps a block at most
    if (warps == 1) {
      err = wide<1>(binned, F, x, w3, order, table, C, B, tile_rows, slices,
                    part, out, grid, smem, s);
    } else if (warps == 2) {
      err = wide<2>(binned, F, x, w3, order, table, C, B, tile_rows, slices,
                    part, out, grid, smem, s);
    } else {
      return (int)cudaErrorInvalidValue;
    }
    if (err != cudaSuccess) return (int)err;
  } else {
    err = cudaFuncSetAttribute(moment_lane_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return (int)err;
    moment_lane_kernel<<<grid, warps * kLanes, smem, s>>>(
        static_cast<const uint8_t*>(binned), F, x, w3, order, table, C, B,
        gw, tile_rows / warps, slices, part, out);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int per = (int)((words + kReduceWords * kReduceThreads - 1)
                        / (kReduceWords * kReduceThreads));
  moment_reduce_kernel<<<(unsigned)C * per, kReduceThreads, 0, s>>>(
      part, table, C, (int)words, per, out);
  return (int)cudaGetLastError();
}

extern "C" const char* lgbt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
