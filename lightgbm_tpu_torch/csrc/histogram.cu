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
// Design (the same bits on every run, no float atomics):
// - grid (tiles, blocks of groups); a tile is kTileRows rows of the
//   row sequence (0..n-1, or rows[0..n-1]); each warp of a block takes
//   one group;
// - each lane of a warp owns a private [B bins] histogram of its group
//   in shared memory (laid out [bin][lane], so lane l's words sit in
//   bank l and the lanes' adds never conflict) and adds its rows, l,
//   l+32, ..., in order, four rows' loads in flight;
// - the lanes' histograms are added in a fixed tree into the tile's
//   partial in device memory, and a second kernel adds the tiles, each
//   lane a fixed residue of tiles, then the lanes in a fixed tree.
//   Counts are integers throughout.
// The result depends only on the inputs and the tile size, never on
// timing.
//
// Bound on an H100 SXM (3.35 TB/s): every input byte read once: the
// group bins of the rows (G bytes a row), 12 bytes of channels a row,
// 4 more a row for a row list, and the [G, B, 3] output.
// At the root of the main path (2,000,000 rows x 28 groups) that is
// 80 MB, 0.024 ms; chip_smoke.py computes the bound of each measured
// call from its own shape. The per-row work is a handful of
// instructions a (row, group), so bytes bound it.
//
// The hi+lo mode (tpu_hist_bf16, the JAX package's default): the bf16
// branch of the same three functions, with _hi_lo (:52). Each row's g*w
// and h*w are split in registers into hi = bf16(v) and lo = bf16(v -
// f32(hi)), rounded as XLA's CPU backend rounds (ops/histogram.py
// hi_lo), and the four halves are summed apart in f32 in the same fixed
// lane and tile trees; the reduce kernel adds hi + lo once, after all
// rows (the JAX merge at :394-396). The split reads no more bytes, so
// the bound is H's. The trap is shared memory: five words a (lane, bin)
// instead of three, 40 KB a warp at B = 64 and 160 KB at B = 256. A
// block takes as many warps (at most 4) as fit in 160 KB, so at max_bin
// 255 a block holds one warp, which keeps one pass over the rows; a
// second pass for the lo halves would read every row twice.
//
// The uint16 modes (groups of more than 256 bins, the JAX package's
// uint16 matrix: efb.py:96-99, ingest/build.py:116; its H functions are
// dtype-generic and pad every group to the widest): the same sums in
// both modes, with each group at its own width (group_num_bin), the
// tiles' partials laid out at those widths, and tiles of 2,048 << k
// rows, the least k that keeps the partials' traffic under a quarter of
// the input's bytes (ops/histogram.py hist_layout, hist_tile_rows: at
// the Bosch root 16,384 rows, 31 tiles, in both modes). A group whose 32
// private copies fit 64 KB a warp (at most 170 bins in f32 mode, 102
// in hi+lo) keeps the lane-private scheme above; a wider one (up to
// 2,048 bins) cannot (631 bins: 242 KB a warp in f32, 404 KB in hi+lo)
// and goes warp-shared (hist_wide_kernel): ONE histogram a warp, the
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
// Design: the same grid as H (row tiles of the row sequence x blocks of
// groups); each block keeps an int32 [groups, B, 3] histogram in shared
// memory, its threads add their rows into it with integer atomicAdd,
// and the block adds its nonzero words into the zeroed output with
// atomicAdd. Integer addition is associative, so the result has the
// same bits on every run without H's fixed-order reduction trees; the
// caller keeps qmax * rows below 2^31 (train_qmax), so nothing
// overflows. Bound on an H100 SXM: G bytes of bins, 4 bytes of codes and
// 4 of w01 a row (4 more for a row list) and the [G, B, 3] output; at
// the root of the main path 72 MB, 0.021 ms.
//
// HQ's uint16 mode (the same quantized channels on groups of more
// than 256 bins, up to 2,048): the kernel is templated on the bin type
// as H's is. Padded to B, the 96 KB shared budget takes 12 groups of 631
// bins (29 blocks of groups at Bosch) and 4 of 2,048, so the groups are
// packed by their own widths (H's hist_layout: widths, poff) into slices
// whose words fit the budget (hist_layout's slices: at Bosch 338 groups,
// 61,054 bins, 733 KB in all, 8 slices; grid tiles x slices). Sparse data puts most rows of a
// warp in one bin of a group (the default bin of a one-hot bundle), and
// 32 integer adds to one shared word serialize: the lanes of one bin
// (__match_any_sync) sum their codes (__reduce_add_sync) and the lowest
// adds once, as H's hist_wide_kernel combines its lanes. The output stays
// the padded [G, B, 3] int32 that S reads, zeroed first (2.56 MB at
// Bosch). Bound: 500,000 x (676 B of bins + 4 of codes + 4 of w01) =
// 342 MB at the Bosch root, 0.102 ms (a row list adds 4 B a row);
// 2,000,000 x 64 B at the max_bin=1023 root, 0.038 ms.

#include <cuda_runtime.h>
#include <stdint.h>

#include "warp_rank.cuh"

namespace {

constexpr int kTileRows = 2048;
constexpr int kLanes = 32;
constexpr int kUnroll = 4;  // rows a lane has in flight
// the shared memory a block of H may take: 4 warps of f32 mode at
// B = 64 (96 KB) or of hi+lo mode (160 KB); above the budget of one warp
// a block holds that one warp (hi+lo at B = 256: 160 KB)
constexpr int kHistSmem = 160 * 1024;
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

// partial layout: per channel [tiles, elems] words, elems = the sum of
// the groups' widths, group g's bins at poff[g] within a tile (the
// uint8 path: every group B wide at g * B), so the tile reduction reads
// coalesced runs of bins. f32 mode: g, h (float) and count (uint32);
// hi+lo mode (HILO): g_hi, h_hi, count, g_lo, h_lo.
//
// The lane-private scheme: warp w of block y takes group glist[y *
// warps + w] (group y * warps + w without a list) of width widths[g]
// (B without widths).
template <bool HILO, typename BinT>
__global__ void hist_tile_kernel(const BinT* __restrict__ binned, int G,
                                 const float* __restrict__ w3,
                                 const int* __restrict__ rows, int n,
                                 int tile_rows, int B,
                                 const int* __restrict__ glist, int n_list,
                                 const int* __restrict__ widths,
                                 const int* __restrict__ poff, int elems,
                                 int warps, float* __restrict__ part) {
  constexpr int kCh = HILO ? 5 : 3;
  extern __shared__ unsigned char smem[];
  const int tile = blockIdx.x;
  const int warp = threadIdx.x / kLanes;
  const int lane = threadIdx.x % kLanes;
  const int slot = blockIdx.y * warps + warp;  // this warp's group
  if (slot >= n_list) return;  // whole warps; no block-wide barrier follows
  const int g = glist ? glist[slot] : slot;
  const int W = widths ? widths[g] : B;
  const int per_warp = kLanes * B;  // B: the widest group of the list
  // this warp's [W bins][32 lanes] histograms: lane l's words all in
  // bank l, so the lanes' adds never conflict
  float* hg = reinterpret_cast<float*>(smem) + warp * per_warp;
  float* hh = reinterpret_cast<float*>(smem) + (warps + warp) * per_warp;
  uint32_t* hc = reinterpret_cast<uint32_t*>(smem) +
                 (2 * warps + warp) * per_warp;
  float* lg = reinterpret_cast<float*>(smem) + (3 * warps + warp) * per_warp;
  float* lh = reinterpret_cast<float*>(smem) + (4 * warps + warp) * per_warp;
  for (int e = lane; e < kLanes * W; e += kLanes) {
    hg[e] = 0.f;
    hh[e] = 0.f;
    hc[e] = 0u;
    if (HILO) {
      lg[e] = 0.f;
      lh[e] = 0.f;
    }
  }
  __syncwarp();

  const int begin = tile * tile_rows;
  const int end = min(n, begin + tile_rows);
  // lane l takes rows begin+l, begin+l+32, ... in order, kUnroll of
  // them loaded before any is added
  for (int i0 = begin + lane; i0 < end; i0 += kLanes * kUnroll) {
    int bin[kUnroll];
    float vg[kUnroll], vh[kUnroll];
    uint32_t vc[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int i = i0 + u * kLanes;
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
      if (bin[u] < W) {
        const int e = bin[u] * kLanes + lane;
        if (HILO) {
          // the split costs registers only: no more bytes are read
          float ghi, glo, hhi, hlo;
          hi_lo(vg[u], ghi, glo);
          hi_lo(vh[u], hhi, hlo);
          hg[e] += ghi;
          hh[e] += hhi;
          lg[e] += glo;
          lh[e] += hlo;
        } else {
          hg[e] += vg[u];
          hh[e] += vh[u];
        }
        hc[e] += vc[u];
      }
    }
  }
  __syncwarp();

  // the lanes' histograms added in a fixed tree into the tile's partial
  const size_t out0 = (size_t)tile * elems + (poff ? poff[g] : (size_t)g * B);
  const size_t chan = (size_t)gridDim.x * elems;  // one channel's words
  for (int b = 0; b < W; ++b) {
    float v[kCh];
    v[0] = hg[b * kLanes + lane];
    v[1] = hh[b * kLanes + lane];
    uint32_t k = hc[b * kLanes + lane];
    if (HILO) {
      v[3] = lg[b * kLanes + lane];
      v[4] = lh[b * kLanes + lane];
    }
    for (int o = kLanes / 2; o > 0; o >>= 1) {
#pragma unroll
      for (int c = 0; c < kCh; ++c) {
        if (c != 2) v[c] += __shfl_down_sync(~0u, v[c], o);
      }
      k += __shfl_down_sync(~0u, k, o);
    }
    if (lane == 0) {
#pragma unroll
      for (int c = 0; c < kCh; ++c) {
        if (c != 2) part[c * chan + out0 + b] = v[c];
      }
      reinterpret_cast<uint32_t*>(part)[2 * chan + out0 + b] = k;
    }
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

// out[g, b, :] = the sum over tiles of the partials, one warp per
// element: lane l adds tiles l, l+32, ... in order, then the lanes are
// added in a fixed tree. Same order every run. In hi+lo mode the hi and
// lo sums are added here, once, after all rows. With widths, out is
// [G, B, 3] and a bin past its group's width is written 0.
template <bool HILO>
__global__ void hist_reduce_kernel(const float* __restrict__ part,
                                   int tiles, int elems, int G, int B,
                                   const int* __restrict__ widths,
                                   const int* __restrict__ poff,
                                   float* __restrict__ out) {
  constexpr int kCh = HILO ? 5 : 3;
  const int e = blockIdx.x * (blockDim.x / kLanes) + threadIdx.x / kLanes;
  const int lane = threadIdx.x % kLanes;
  if (e >= G * B) return;  // whole warps leave together
  int src = e;  // the element's word in a tile's partial
  if (widths) {
    const int g = e / B, b = e % B;
    if (b >= widths[g]) {
      if (lane == 0) {
        out[(size_t)e * 3] = 0.f;
        out[(size_t)e * 3 + 1] = 0.f;
        out[(size_t)e * 3 + 2] = 0.f;
      }
      return;
    }
    src = poff[g] + b;
  }
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
  for (int o = kLanes / 2; o > 0; o >>= 1) {
#pragma unroll
    for (int c = 0; c < kCh; ++c) {
      if (c != 2) v[c] += __shfl_down_sync(~0u, v[c], o);
    }
    k += __shfl_down_sync(~0u, k, o);
  }
  if (lane == 0) {
    out[(size_t)e * 3] = HILO ? __fadd_rn(v[0], v[3]) : v[0];
    out[(size_t)e * 3 + 1] = HILO ? __fadd_rn(v[1], v[4]) : v[1];
    out[(size_t)e * 3 + 2] = (float)k;
  }
}

constexpr int kTileRowsI32 = 4096;
constexpr int kThreadsI32 = 512;
constexpr int kSmemI32 = 96 * 1024;  // the shared histogram's budget

// HQ. Block (tile, y) holds an int32 [words / 3, 3] histogram of its
// slice of groups in shared memory: on a uint8 matrix the gpb groups
// from y * gpb, each B bins wide (slices NULL); on a uint16 matrix the
// groups slices[y] .. slices[y + 1] - 1, each at its own width widths[g]
// from word poff[g] - poff[slices[y]] on. out [G, B, 3] int32, zeroed.
//
// uint8: a thread a row, its adds straight into the shared words.
// uint16 (Bosch: most rows sit in the default bin of most groups): the
// lanes of a warp that hold the same bin of a group (__match_any_sync)
// sum their codes first (__reduce_add_sync) and the lowest of them adds
// the sums, so 32 lanes on one bin cost one add a word, not 32
// serialized ones. Integer sums: the bits are the same either way.
template <typename BinT>
__global__ void hist_i32_kernel(const BinT* __restrict__ binned, int G,
                                const short2* __restrict__ codes,
                                const float* __restrict__ w01,
                                const int* __restrict__ rows, int n, int B,
                                int gpb, const int* __restrict__ slices,
                                const int* __restrict__ widths,
                                const int* __restrict__ poff,
                                int* __restrict__ out) {
  constexpr bool kWide = sizeof(BinT) == 2;
  extern __shared__ int sh[];
  int g0, gc, base, words;
  if (kWide) {
    g0 = slices[blockIdx.y];
    gc = slices[blockIdx.y + 1] - g0;
    base = poff[g0];
    words = (poff[g0 + gc - 1] + widths[g0 + gc - 1] - base) * 3;
  } else {
    g0 = blockIdx.y * gpb;
    gc = min(gpb, G - g0);
    base = 0;
    words = gc * B * 3;
  }
  for (int e = threadIdx.x; e < words; e += blockDim.x) sh[e] = 0;
  __syncthreads();
  const int begin = blockIdx.x * kTileRowsI32;
  const int end = min(n, begin + kTileRowsI32);
  if (!kWide) {
    for (int i = begin + threadIdx.x; i < end; i += blockDim.x) {
      const int r = rows ? __ldg(rows + i) : i;
      if (!(__ldg(w01 + r) > 0.f)) continue;
      const short2 q = codes[r];
      const BinT* b = binned + (size_t)r * G + g0;
      for (int g = 0; g < gc; ++g) {
        const int bin = __ldg(b + g);
        if (bin >= B) continue;
        int* cell = sh + (g * B + bin) * 3;
        atomicAdd(cell, (int)q.x);
        atomicAdd(cell + 1, (int)q.y);
        atomicAdd(cell + 2, 1);
      }
    }
  } else {
    const int lane = threadIdx.x % kLanes;
    // whole warps take a turn together: i0 - lane is the warp's first row
    for (int i0 = begin + threadIdx.x; i0 - lane < end; i0 += blockDim.x) {
      bool live = i0 < end;
      const int r = live ? (rows ? __ldg(rows + i0) : i0) : 0;
      live = live && __ldg(w01 + r) > 0.f;
      const short2 q = live ? codes[r] : make_short2(0, 0);
      const BinT* b = binned + (size_t)r * G + g0;
      for (int j = 0; j < gc; ++j) {
        const int W = __ldg(widths + g0 + j);
        const int bin = live ? (int)__ldg(b + j) : W;
        const int key = bin < W ? bin : -1;
        const unsigned peers = __match_any_sync(~0u, key);
        const int sg = __reduce_add_sync(peers, (int)q.x);
        const int sq = __reduce_add_sync(peers, (int)q.y);
        if (key >= 0 && lane == __ffs(peers) - 1) {
          int* cell = sh + (__ldg(poff + g0 + j) - base + key) * 3;
          atomicAdd(cell, sg);
          atomicAdd(cell + 1, sq);
          atomicAdd(cell + 2, __popc(peers));
        }
      }
    }
  }
  __syncthreads();
  for (int e = threadIdx.x; e < words; e += blockDim.x) {
    const int v = sh[e];
    if (v == 0) continue;
    size_t at;
    if (kWide) {
      // the group of word e: the last of the slice whose first word is
      // at or before it
      const int k = e / 3 + base;
      int lo = g0, hi = g0 + gc - 1;
      while (lo < hi) {
        const int mid = (lo + hi + 1) >> 1;
        if (__ldg(poff + mid) <= k) {
          lo = mid;
        } else {
          hi = mid - 1;
        }
      }
      at = ((size_t)lo * B + (k - __ldg(poff + lo))) * 3 + e % 3;
    } else {
      at = (size_t)g0 * B * 3 + e;
    }
    atomicAdd(out + at, v);
  }
}

}  // namespace

extern "C" int lgbt_hist_tiles(int n) {
  return n > 0 ? (n + kTileRows - 1) / kTileRows : 1;
}

namespace {

// the per-lane kernel over n_list groups of at most B bins
template <bool HILO, typename BinT>
int launch_lanes(const BinT* binned, int G, const float* w3,
                 const int* rows, int n, int tile_rows, int tiles, int B,
                 const int* glist, int n_list, const int* widths,
                 const int* poff, int elems, float* part, cudaStream_t s) {
  const size_t warp_bytes = (size_t)kLanes * B * 4 * (HILO ? 5 : 3);
  int warps = (int)(kHistSmem / warp_bytes);
  warps = warps < 1 ? 1 : (warps > 4 ? 4 : warps);
  if (warps > n_list) warps = n_list;
  const size_t smem = warp_bytes * warps;
  cudaError_t err = cudaFuncSetAttribute(
      hist_tile_kernel<HILO, BinT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(tiles, (n_list + warps - 1) / warps);
  hist_tile_kernel<HILO, BinT><<<grid, warps * kLanes, smem, s>>>(
      binned, G, w3, rows, n, tile_rows, B, glist, n_list, widths, poff,
      elems, warps, part);
  return (int)cudaGetLastError();
}

template <bool HILO>
int launch_histogram(const void* binned, int G, int u16, const float* w3,
                     const int* rows, int n, int B, const int* widths,
                     const int* poff, const int* narrow, int n_narrow,
                     int narrow_w, const int* wide, int n_wide, int wide_w,
                     int tile_rows, int elems, float* part, float* out,
                     cudaStream_t s) {
  const int tiles = n > 0 ? (n + tile_rows - 1) / tile_rows : 1;
  int rc = 0;
  if (!u16) {
    rc = launch_lanes<HILO, uint8_t>(
        static_cast<const uint8_t*>(binned), G, w3, rows, n, tile_rows,
        tiles, B, nullptr, G, nullptr, nullptr, G * B, part, s);
  } else {
    const uint16_t* b16 = static_cast<const uint16_t*>(binned);
    if (n_narrow > 0) {
      rc = launch_lanes<HILO, uint16_t>(b16, G, w3, rows, n, tile_rows,
                                        tiles, narrow_w, narrow, n_narrow,
                                        widths, poff, elems, part, s);
    }
    if (rc == 0 && n_wide > 0) {
      constexpr int kCh = HILO ? 5 : 3;
      const size_t warp_bytes = (size_t)kCh * wide_w * 4;
      int warps = (int)(kHistSmem / warp_bytes);
      warps = warps < 1 ? 1 : (warps > kWideWarps ? kWideWarps : warps);
      const size_t smem = warp_bytes * warps;
      cudaError_t err = cudaFuncSetAttribute(
          hist_wide_kernel<HILO>, cudaFuncAttributeMaxDynamicSharedMemorySize,
          (int)smem);
      if (err != cudaSuccess) return (int)err;
      dim3 grid(tiles, n_wide);
      hist_wide_kernel<HILO><<<grid, warps * kLanes, smem, s>>>(
          b16, G, w3, rows, n, tile_rows, wide, widths, poff, elems, wide_w,
          part);
      rc = (int)cudaGetLastError();
    }
  }
  if (rc != 0) return rc;
  const int per_block = 8;  // warps, one element each
  const size_t outs = (size_t)G * B;
  hist_reduce_kernel<HILO><<<(int)((outs + per_block - 1) / per_block),
                             per_block * kLanes, 0, s>>>(
      part, tiles, elems, G, B, u16 ? widths : nullptr,
      u16 ? poff : nullptr, out);
  return (int)cudaGetLastError();
}

}  // namespace

// binned [N, G] row-major, u8 or (u16 != 0) u16; w3 [N, 3] f32 = (g*w,
// h*w, w); rows: a row list of n entries or NULL for rows 0..n-1; hilo:
// 1 for the hi+lo mode; out [G, B, 3] f32. A u8 matrix takes rows in
// tiles of kTileRows, every group B wide and lane-private (the other
// arguments unread). A u16 matrix takes the layout of ops/histogram.py
// hist_layout, on the device: widths [G] (each group's own bins), poff [G]
// (its first word in a tile's partial), the lane-private groups
// narrow[n_narrow] (at most narrow_w bins) and the warp-shared ones
// wide[n_wide] (at most wide_w), elems (a tile's words a channel), and
// tile_rows (hist_tile_rows). scratch: (hilo ? 5 : 3) * tiles * elems words. Returns
// cudaGetLastError().
extern "C" int lgbt_leaf_histogram(const void* binned, int G, int u16,
                                   const float* w3, const int* rows, int n,
                                   int B, int hilo, const int* widths,
                                   const int* poff, const int* narrow,
                                   int n_narrow, int narrow_w,
                                   const int* wide, int n_wide, int wide_w,
                                   int tile_rows, int elems, void* scratch,
                                   float* out, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  float* part = (float*)scratch;
  if (!u16) {
    tile_rows = kTileRows;
    elems = G * B;
  }
  return hilo ? launch_histogram<true>(binned, G, u16, w3, rows, n, B,
                                       widths, poff, narrow, n_narrow,
                                       narrow_w, wide, n_wide, wide_w,
                                       tile_rows, elems, part, out, s)
              : launch_histogram<false>(binned, G, u16, w3, rows, n, B,
                                        widths, poff, narrow, n_narrow,
                                        narrow_w, wide, n_wide, wide_w,
                                        tile_rows, elems, part, out, s);
}

// binned [N, G] row-major, u8 or (u16 != 0) u16; codes [N] short2 (q_g,
// q_h); w01 [N] f32; rows: a row list of n entries or NULL for rows
// 0..n-1; out [G, B, 3] int32. A u16 matrix takes its groups' widths
// [G] and first words poff [G] (ops/histogram.py hist_layout) and the
// slices of groups whose words fit a block, slices [n_slices + 1] (group
// bounds), the widest holding slice_words int32 words. Returns
// cudaGetLastError().
extern "C" int lgbt_leaf_histogram_i32(const void* binned, int G, int u16,
                                       const short2* codes,
                                       const float* w01, const int* rows,
                                       int n, int B, const int* slices,
                                       int n_slices, int slice_words,
                                       const int* widths, const int* poff,
                                       int* out, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err =
      cudaMemsetAsync(out, 0, (size_t)G * B * 3 * sizeof(int), s);
  if (err != cudaSuccess) return (int)err;
  if (n <= 0 || G <= 0) return 0;
  const int tiles = (n + kTileRowsI32 - 1) / kTileRowsI32;
  if (u16) {
    const size_t smem = (size_t)slice_words * sizeof(int);
    err = cudaFuncSetAttribute(hist_i32_kernel<uint16_t>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    hist_i32_kernel<uint16_t><<<dim3(tiles, n_slices), kThreadsI32, smem,
                                s>>>(
        static_cast<const uint16_t*>(binned), G, codes, w01, rows, n, B, 0,
        slices, widths, poff, out);
    return (int)cudaGetLastError();
  }
  int gpb = kSmemI32 / (B * 3 * (int)sizeof(int));
  gpb = gpb < 1 ? 1 : (gpb > G ? G : gpb);
  const size_t smem = (size_t)gpb * B * 3 * sizeof(int);
  err = cudaFuncSetAttribute(hist_i32_kernel<uint8_t>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  hist_i32_kernel<uint8_t><<<dim3(tiles, (G + gpb - 1) / gpb), kThreadsI32,
                             smem, s>>>(
      static_cast<const uint8_t*>(binned), G, codes, w01, rows, n, B, gpb,
      nullptr, nullptr, nullptr, out);
  return (int)cudaGetLastError();
}

extern "C" const char* lgbt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
