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
// matrix unit; here the rows are first sorted by leaf, then each lane
// scatters a leaf's rows into private shared-memory histograms, as in
// kernel H's row-list mode.
//
// Design (the same bits every launch, no float atomics):
// - lgbt_moment_sort, a stable counting sort of the rows by slot (the
//   c with ids[c] == leaf_id[r], found by binary search in the sorted
//   ids; rows of no id are dropped): one warp a sort tile of rows counts
//   its rows of each slot (moment_count_kernel), one block of 32 warps
//   turns the [C, T] counts into exclusive offsets in slot-major order
//   (moment_scan_kernel), and each warp writes its rows, in row order,
//   to their slots' segments (moment_scatter_kernel). Every count and
//   offset is an integer, so the order is the same on every launch;
// - the caller reads the C + 1 segment starts back and cuts every
//   slot's segment into tiles of kTileRows rows;
// - moment_tile_kernel, grid (tiles, blocks of features): each warp of
//   a block takes one feature and each lane owns private [B bins]
//   histograms of the four channels (laid out [bin][lane]: lane l's
//   words sit in bank l), adding its rows l, l+32, ... of the tile in
//   order; x is the feature's raw value, 0 when it is not finite, and
//   the terms are formed in f32 as the JAX package forms them: x*m,
//   (x*x)*m, x*(g*m), x*(h*m). The lanes' histograms are added in a
//   fixed tree into the tile's partial;
// - moment_reduce_kernel: one thread an output word adds its slot's
//   tiles in order.
// x is aligned column for column with the bins: the caller resolves
// EFB, as ops/histogram.py:622-640 of the JAX package documents.
//
// Bound on an H100 SXM (3.35 TB/s): every input byte read once: a row's
// F bins (1 byte each), F raw values (4 bytes each), 12 bytes of
// channels and 4 of leaf id, and the [C, F, B, 4] output. For the 255
// leaves of a main-path tree (2,000,000 rows x 28 features) about 156
// bytes a row and 7 MB of output, 0.095 ms. The sort adds 16 bytes a
// row of its own (slot and row order, each written and read once).
//
// LM's uint16 mode (features of more than 256 bins, up to 2,048,
// e.g. max_bin=1023): each lane's private [B] x 4 f32 histograms take
// 32 x B x 16 bytes a warp, 512 KB at B = 1,024, far past shared memory.
// moment_wide_kernel takes H's warp-shared scheme (hist_wide_kernel)
// rather than bin-range passes, which would read each tile once a range:
// each warp keeps ONE [4][B] histogram, its lanes take the tile's rows in
// turns of 32, the lanes that hold one bin (__match_any_sync) add their
// terms in a fixed tree over their rank and the lowest adds the sum, so
// no float atomics and the same bits every launch; the warps' histograms
// are added in warp order into the tile's partial. Tiles hold
// kWideTileRows rows, so the partials (written and read once, 16 B a
// (feature, bin)) stay near one a leaf. The output stays [C, F, B, 4]
// f32, as the plain version and the JAX function give it. A uint8 matrix
// keeps moment_tile_kernel and its bits. Bound at max_bin=1023 over 255
// ids (2,000,000 x 28): (56 B of bins + 112 of x + 12 of channels + 4 of
// leaf id) a row and 117 MB of output, 0.145 ms; the sort adds 16 B a
// row.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "warp_rank.cuh"

namespace {

constexpr int kLanes = 32;
constexpr int kChannels = 4;
constexpr int kTileRows = 2048;   // rows of a moment tile
constexpr int kWideTileRows = 16384;  // rows of a uint16 moment tile
constexpr int kWideSmem = 160 * 1024;  // a warp-shared block's budget
constexpr int kWideWarps = 8;
constexpr int kSortRows = 1024;   // rows of a sort tile (one warp)
constexpr int kMaxSortCells = 1 << 24;  // C * T counters at most
constexpr int kScanWarps = 32;
constexpr int kUnroll = 4;        // rows a lane loads before it adds them

// the slot of leaf id v: sslot[j] for the j with sid[j] == v (sid sorted
// ascending, distinct), or -1
__device__ int slot_of(int v, const int* __restrict__ sid,
                       const int* __restrict__ sslot, int C) {
  int lo = 0, hi = C;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (__ldg(sid + mid) < v) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return (lo < C && __ldg(sid + lo) == v) ? __ldg(sslot + lo) : -1;
}

// one warp a sort tile: slot[i] of its rows, and cnt[s * T + t] the
// number of its rows of slot s (cnt zeroed before)
__global__ void moment_count_kernel(const int* __restrict__ leaf_id, int n,
                                    const int* __restrict__ sid,
                                    const int* __restrict__ sslot, int C,
                                    int T, int tile_rows,
                                    int* __restrict__ slot,
                                    int* __restrict__ cnt) {
  const int t = blockIdx.x;
  const int lane = threadIdx.x;
  const int begin = t * tile_rows;
  const int end = min(n, begin + tile_rows);
  for (int i0 = begin; i0 < end; i0 += kLanes) {
    const int i = i0 + lane;
    const int s = i < end ? slot_of(__ldg(leaf_id + i), sid, sslot, C) : -1;
    if (i < end) slot[i] = s;
    const unsigned group = __match_any_sync(~0u, s);
    if (s >= 0 && lane == __ffs(group) - 1) {
      cnt[(size_t)s * T + t] += __popc(group);
    }
    __syncwarp();
  }
}

// cnt [M = C * T] in place into exclusive offsets (slot-major), begin[s]
// the offset of (s, 0) and begin[C] the total; one block, each warp a
// contiguous run of cnt, its lanes reading consecutive words
__global__ void moment_scan_kernel(int* __restrict__ cnt, int M, int C,
                                   int T, int* __restrict__ begin) {
  __shared__ int sums[kScanWarps];
  const int warp = threadIdx.x / kLanes;
  const int lane = threadIdx.x % kLanes;
  const int per = (M + kScanWarps - 1) / kScanWarps;
  const int lo = min(M, warp * per);
  const int hi = min(M, lo + per);
  int s = 0;
  for (int i = lo + lane; i < hi; i += kLanes) s += cnt[i];
  for (int o = kLanes / 2; o > 0; o >>= 1) s += __shfl_xor_sync(~0u, s, o);
  if (lane == 0) sums[warp] = s;
  __syncthreads();
  int run = 0;
  for (int w = 0; w < warp; ++w) run += sums[w];
  for (int i0 = lo; i0 < hi; i0 += kLanes) {
    const int i = i0 + lane;
    const int c = i < hi ? cnt[i] : 0;
    int incl = c;
    for (int o = 1; o < kLanes; o <<= 1) {
      const int v = __shfl_up_sync(~0u, incl, o);
      if (lane >= o) incl += v;
    }
    if (i < hi) {
      cnt[i] = run + incl - c;
      if (i % T == 0) begin[i / T] = run + incl - c;
    }
    run += __shfl_sync(~0u, incl, kLanes - 1);
  }
  if (threadIdx.x == 0) {
    int total = 0;
    for (int w = 0; w < kScanWarps; ++w) total += sums[w];
    begin[C] = total;
  }
}

// one warp a sort tile: its rows of slot s, in row order, from the
// offset cnt[s * T + t] on (cnt advanced as they are written)
__global__ void moment_scatter_kernel(const int* __restrict__ slot, int n,
                                      int T, int tile_rows,
                                      int* __restrict__ cnt,
                                      int* __restrict__ order) {
  const int t = blockIdx.x;
  const int lane = threadIdx.x;
  const int begin = t * tile_rows;
  const int end = min(n, begin + tile_rows);
  const unsigned below = (1u << lane) - 1u;
  for (int i0 = begin; i0 < end; i0 += kLanes) {
    const int i = i0 + lane;
    const int s = i < end ? slot[i] : -1;
    const unsigned group = __match_any_sync(~0u, s);
    const int leader = __ffs(group) - 1;
    const int cur = (s >= 0 && lane == leader) ? cnt[(size_t)s * T + t] : 0;
    const int base = __shfl_sync(~0u, cur, leader);
    if (s >= 0) {
      order[base + __popc(group & below)] = i;
      if (lane == leader) cnt[(size_t)s * T + t] = cur + __popc(group);
    }
    __syncwarp();
  }
}

// tiles [T2, 3] = (slot, first position in order, rows); part layout
// [T2, F, B, 4]
__global__ void moment_tile_kernel(const uint8_t* __restrict__ binned, int F,
                                   const float* __restrict__ x,
                                   const float* __restrict__ w3,
                                   const int* __restrict__ order,
                                   const int* __restrict__ tiles, int B,
                                   int warps, float* __restrict__ part) {
  extern __shared__ float smem[];
  const int tile = blockIdx.x;
  const int warp = threadIdx.x / kLanes;
  const int lane = threadIdx.x % kLanes;
  const int f = blockIdx.y * warps + warp;  // this warp's feature
  const int per_warp = kLanes * B;
  float* h[kChannels];
#pragma unroll
  for (int ch = 0; ch < kChannels; ++ch) {
    h[ch] = smem + (size_t)(ch * warps + warp) * per_warp;
  }
  if (f >= F) return;  // whole warps; no block-wide barrier follows
  for (int e = lane; e < per_warp; e += kLanes) {
#pragma unroll
    for (int ch = 0; ch < kChannels; ++ch) h[ch][e] = 0.f;
  }
  __syncwarp();
  const int first = __ldg(tiles + 3 * tile + 1);
  const int rows = __ldg(tiles + 3 * tile + 2);
  for (int j0 = lane; j0 < rows; j0 += kLanes * kUnroll) {
    int bin[kUnroll];
    float v[kUnroll], gm[kUnroll], hm[kUnroll], m[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int j = j0 + u * kLanes;
      bin[u] = B;
      if (j < rows) {
        const int r = __ldg(order + first + j);
        bin[u] = __ldg(binned + (size_t)r * F + f);
        v[u] = __ldg(x + (size_t)r * F + f);
        gm[u] = __ldg(w3 + (size_t)r * 3);
        hm[u] = __ldg(w3 + (size_t)r * 3 + 1);
        m[u] = __ldg(w3 + (size_t)r * 3 + 2);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (bin[u] >= B) continue;
      const float xv = isfinite(v[u]) ? v[u] : 0.f;
      const int at = bin[u] * kLanes + lane;
      h[0][at] = __fadd_rn(h[0][at], __fmul_rn(xv, m[u]));
      h[1][at] = __fadd_rn(h[1][at], __fmul_rn(__fmul_rn(xv, xv), m[u]));
      h[2][at] = __fadd_rn(h[2][at], __fmul_rn(xv, gm[u]));
      h[3][at] = __fadd_rn(h[3][at], __fmul_rn(xv, hm[u]));
    }
  }
  __syncwarp();
  // the lanes' histograms added in a fixed tree into the tile's partial
  const size_t out0 = ((size_t)tile * F + f) * B;
  for (int b = 0; b < B; ++b) {
#pragma unroll
    for (int ch = 0; ch < kChannels; ++ch) {
      float a = h[ch][b * kLanes + lane];
      for (int o = kLanes / 2; o > 0; o >>= 1) {
        a = __fadd_rn(a, __shfl_down_sync(~0u, a, o));
      }
      if (lane == 0) part[(out0 + b) * kChannels + ch] = a;
    }
  }
}

// uint16 bins: block (tile, f); warp w takes rows 32 * (w + warps * k) +
// lane of the tile and keeps ONE [4][B] histogram; the lanes of one bin
// add their terms in a fixed tree over their rank (at step s the lane of
// rank r, a multiple of 2s, adds the sum of rank r + s) and the lowest
// adds the sum to the shared bin. The warps' histograms are added in
// warp order into the tile's partial [T2, F, B, 4].
__global__ void moment_wide_kernel(const uint16_t* __restrict__ binned,
                                   int F, const float* __restrict__ x,
                                   const float* __restrict__ w3,
                                   const int* __restrict__ order,
                                   const int* __restrict__ tiles, int B,
                                   float* __restrict__ part) {
  extern __shared__ float smem[];
  const int tile = blockIdx.x;
  const int f = blockIdx.y;
  const int warps = blockDim.x / kLanes;
  const int warp = threadIdx.x / kLanes;
  const int lane = threadIdx.x % kLanes;
  float* h = smem + (size_t)warp * kChannels * B;  // [4][B]
  for (int e = threadIdx.x; e < warps * kChannels * B; e += blockDim.x) {
    smem[e] = 0.f;
  }
  __syncthreads();
  const int first = __ldg(tiles + 3 * tile + 1);
  const int rows = __ldg(tiles + 3 * tile + 2);
  const unsigned below = (1u << lane) - 1u;
  for (int j0 = warp * kLanes; j0 < rows; j0 += warps * kLanes) {
    const int j = j0 + lane;
    int bin = B;
    float t[kChannels] = {0.f, 0.f, 0.f, 0.f};
    if (j < rows) {
      const int r = __ldg(order + first + j);
      bin = __ldg(binned + (size_t)r * F + f);
      const float v = __ldg(x + (size_t)r * F + f);
      const float xv = isfinite(v) ? v : 0.f;
      const float m = __ldg(w3 + (size_t)r * 3 + 2);
      t[0] = __fmul_rn(xv, m);
      t[1] = __fmul_rn(__fmul_rn(xv, xv), m);
      t[2] = __fmul_rn(xv, __ldg(w3 + (size_t)r * 3));
      t[3] = __fmul_rn(xv, __ldg(w3 + (size_t)r * 3 + 1));
    }
    const unsigned peers = __match_any_sync(~0u, bin);
    const int rank = __popc(peers & below);
    const int cnt = __popc(peers);
    const int most = __reduce_max_sync(~0u, cnt);
    for (int s = 1; s < most; s <<= 1) {
      const bool take = (rank % (2 * s)) == 0 && rank + s < cnt;
      const int src = take ? nth_set_lane(peers, rank + s) : lane;
#pragma unroll
      for (int ch = 0; ch < kChannels; ++ch) {
        const float o = __shfl_sync(~0u, t[ch], src);
        if (take) t[ch] = __fadd_rn(t[ch], o);
      }
    }
    if (rank == 0 && bin < B) {
#pragma unroll
      for (int ch = 0; ch < kChannels; ++ch) {
        h[ch * B + bin] = __fadd_rn(h[ch * B + bin], t[ch]);
      }
    }
    __syncwarp();
  }
  __syncthreads();
  const size_t out0 = ((size_t)tile * F + f) * B;
  for (int b = threadIdx.x; b < B; b += blockDim.x) {
#pragma unroll
    for (int ch = 0; ch < kChannels; ++ch) {
      float a = 0.f;
      for (int w = 0; w < warps; ++w) {
        a = __fadd_rn(a, smem[((size_t)w * kChannels + ch) * B + b]);
      }
      part[(out0 + b) * kChannels + ch] = a;
    }
  }
}

// out[c, e] = the sum over slot c's tiles, in order, of part[t, e]
// (0 for a slot with no rows); one thread an output word
__global__ void moment_reduce_kernel(const float* __restrict__ part,
                                     const int* __restrict__ tile_first,
                                     const int* __restrict__ tile_count,
                                     int C, size_t per_slot,
                                     float* __restrict__ out) {
  const size_t w = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (w >= (size_t)C * per_slot) return;
  const int c = (int)(w / per_slot);
  const size_t e = w - (size_t)c * per_slot;
  const int t0 = __ldg(tile_first + c);
  const int tn = __ldg(tile_count + c);
  float a = 0.f;
  for (int t = t0; t < t0 + tn; ++t) {
    a = __fadd_rn(a, part[(size_t)t * per_slot + e]);
  }
  out[w] = a;
}

}  // namespace

// The sort's tile count for n rows and C slots: kSortRows-row tiles, or
// longer ones when C * T would pass kMaxSortCells.
extern "C" int lgbt_moment_sort_tiles(int n, int C) {
  if (n <= 0) return 0;
  int tiles = (n + kSortRows - 1) / kSortRows;
  const int most = kMaxSortCells / (C > 0 ? C : 1);
  if (tiles > most) tiles = most > 0 ? most : 1;
  return tiles;
}

// rows of a moment tile: kTileRows for uint8 bins, kWideTileRows for
// uint16 (u16 != 0)
extern "C" int lgbt_moment_tile_rows(int u16) {
  return u16 ? kWideTileRows : kTileRows;
}

// leaf_id [n] i32; sid [C] the ids sorted ascending (distinct), sslot
// [C] their positions in ids; T = lgbt_moment_sort_tiles(n, C); scratch
// slot [n] and cnt [C * T] i32; begin [C + 1] i32 out: slot c's rows
// are order[begin[c] .. begin[c + 1]); order [n] i32 out.
extern "C" int lgbt_moment_sort(const int* leaf_id, int n, const int* sid,
                                const int* sslot, int C, int T, int* slot,
                                int* cnt, int* begin, int* order,
                                void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int tile_rows = (n + T - 1) / T;
  cudaError_t err =
      cudaMemsetAsync(cnt, 0, (size_t)C * T * sizeof(int), s);
  if (err != cudaSuccess) return (int)err;
  moment_count_kernel<<<T, kLanes, 0, s>>>(leaf_id, n, sid, sslot, C, T,
                                           tile_rows, slot, cnt);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  moment_scan_kernel<<<1, kScanWarps * kLanes, 0, s>>>(cnt, C * T, C, T,
                                                      begin);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  moment_scatter_kernel<<<T, kLanes, 0, s>>>(slot, n, T, tile_rows, cnt,
                                             order);
  return (int)cudaGetLastError();
}

// binned [N, F] u8 or (u16 != 0) u16 (per-feature bins); x [N, F] f32
// aligned with them; w3 [N, 3] f32 = (g*m, h*m, m); order: the sorted
// rows; tiles [T2, 3] i32 (slot, first position in order, rows), slot by
// slot, of at most lgbt_moment_tile_rows(u16) rows; tile_first /
// tile_count [C] i32 each slot's tile range; part: T2 * F * B * 4 floats
// of scratch; out [C, F, B, 4] f32.
extern "C" int lgbt_leaf_moments(const void* binned, int F, int u16,
                                 const float* x, const float* w3,
                                 const int* order, const int* tiles, int T2,
                                 const int* tile_first,
                                 const int* tile_count, int C, int B,
                                 float* part, float* out, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (T2 > 0 && u16) {
    const size_t warp_bytes = (size_t)kChannels * B * sizeof(float);
    int warps = (int)(kWideSmem / warp_bytes);
    warps = warps < 1 ? 1 : (warps > kWideWarps ? kWideWarps : warps);
    const size_t smem = warp_bytes * warps;
    cudaError_t err = cudaFuncSetAttribute(
        moment_wide_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
    moment_wide_kernel<<<dim3(T2, F), warps * kLanes, smem, s>>>(
        static_cast<const uint16_t*>(binned), F, x, w3, order, tiles, B,
        part);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  } else if (T2 > 0) {
    const size_t warp_bytes =
        (size_t)kLanes * B * kChannels * sizeof(float);
    int warps = (int)((96 * 1024) / warp_bytes);
    warps = warps < 1 ? 1 : (warps > 4 ? 4 : warps);
    if (warps > F) warps = F;
    const size_t smem = warp_bytes * warps;
    cudaError_t err = cudaFuncSetAttribute(
        moment_tile_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
    dim3 grid(T2, (F + warps - 1) / warps);
    moment_tile_kernel<<<grid, warps * kLanes, smem, s>>>(
        static_cast<const uint8_t*>(binned), F, x, w3, order, tiles, B,
        warps, part);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  const size_t per_slot = (size_t)F * B * kChannels;
  const size_t words = (size_t)C * per_slot;
  if (words == 0) return 0;
  const int threads = 256;
  moment_reduce_kernel<<<(unsigned)((words + threads - 1) / threads),
                         threads, 0, s>>>(part, tile_first, tile_count, C,
                                          per_slot, out);
  return (int)cudaGetLastError();
}

extern "C" const char* lgbt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
