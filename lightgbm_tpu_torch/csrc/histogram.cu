// Kernel H, leaf_histogram, of lightgbm_tpu_torch: per (group, bin) the
// sums (g*w, h*w, count of rows with w > 0) over a set of rows, built
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
// The result depends only on the inputs and kTileRows, never on timing.
//
// Bound on an H100 SXM (3.35 TB/s): every input byte read once: the
// group bins of the rows (G bytes a row), 12 bytes of channels a row,
// 4 more a row for a row list, and the [G, B, 3] output.
// At the root of the main path (2,000,000 rows x 28 groups) that is
// 80 MB, 0.024 ms; chip_smoke.py computes the bound of each measured
// call from its own shape. The per-row work is a handful of
// instructions a (row, group), so bytes bound it.
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

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTileRows = 2048;
constexpr int kLanes = 32;
constexpr int kUnroll = 4;  // rows a lane has in flight

// partial layout: [tiles, G, B] for each of g, h (float) and count
// (uint32), so the tile reduction reads coalesced runs of bins.
__global__ void hist_tile_kernel(const uint8_t* __restrict__ binned, int G,
                                 const float* __restrict__ w3,
                                 const int* __restrict__ rows, int n,
                                 int B,
                                 int warps, float* __restrict__ part_g,
                                 float* __restrict__ part_h,
                                 uint32_t* __restrict__ part_c) {
  extern __shared__ unsigned char smem[];
  const int tile = blockIdx.x;
  const int warp = threadIdx.x / kLanes;
  const int lane = threadIdx.x % kLanes;
  const int g = blockIdx.y * warps + warp;  // this warp's group
  const int per_warp = kLanes * B;
  // this warp's [B bins][32 lanes] histograms: lane l's words all in
  // bank l, so the lanes' adds never conflict
  float* hg = reinterpret_cast<float*>(smem) + warp * per_warp;
  float* hh = reinterpret_cast<float*>(smem) + (warps + warp) * per_warp;
  uint32_t* hc = reinterpret_cast<uint32_t*>(smem) +
                 (2 * warps + warp) * per_warp;
  if (g >= G) return;  // whole warps; no block-wide barrier follows
  for (int e = lane; e < per_warp; e += kLanes) {
    hg[e] = 0.f;
    hh[e] = 0.f;
    hc[e] = 0u;
  }
  __syncwarp();

  const int begin = tile * kTileRows;
  const int end = min(n, begin + kTileRows);
  // lane l takes rows begin+l, begin+l+32, ... in order, kUnroll of
  // them loaded before any is added
  for (int i0 = begin + lane; i0 < end; i0 += kLanes * kUnroll) {
    int bin[kUnroll];
    float vg[kUnroll], vh[kUnroll];
    uint32_t vc[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int i = i0 + u * kLanes;
      bin[u] = B;
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
      if (bin[u] < B) {
        hg[bin[u] * kLanes + lane] += vg[u];
        hh[bin[u] * kLanes + lane] += vh[u];
        hc[bin[u] * kLanes + lane] += vc[u];
      }
    }
  }
  __syncwarp();

  // the lanes' histograms added in a fixed tree into the tile's partial
  const size_t out0 = ((size_t)tile * G + g) * B;
  for (int b = 0; b < B; ++b) {
    float a = hg[b * kLanes + lane];
    float h = hh[b * kLanes + lane];
    uint32_t k = hc[b * kLanes + lane];
    for (int o = kLanes / 2; o > 0; o >>= 1) {
      a += __shfl_down_sync(~0u, a, o);
      h += __shfl_down_sync(~0u, h, o);
      k += __shfl_down_sync(~0u, k, o);
    }
    if (lane == 0) {
      part_g[out0 + b] = a;
      part_h[out0 + b] = h;
      part_c[out0 + b] = k;
    }
  }
}

// out[g, b, :] = the sum over tiles of the partials, one warp per
// element: lane l adds tiles l, l+32, ... in order, then the lanes are
// added in a fixed tree. Same order every run.
__global__ void hist_reduce_kernel(const float* __restrict__ part_g,
                                   const float* __restrict__ part_h,
                                   const uint32_t* __restrict__ part_c,
                                   int tiles, int elems,
                                   float* __restrict__ out) {
  const int e = blockIdx.x * (blockDim.x / kLanes) + threadIdx.x / kLanes;
  const int lane = threadIdx.x % kLanes;
  if (e >= elems) return;  // whole warps leave together
  float a = 0.f, b = 0.f;
  uint32_t k = 0u;
  for (int t = lane; t < tiles; t += kLanes) {
    const size_t i = (size_t)t * elems + e;
    a += part_g[i];
    b += part_h[i];
    k += part_c[i];
  }
  for (int o = kLanes / 2; o > 0; o >>= 1) {
    a += __shfl_down_sync(~0u, a, o);
    b += __shfl_down_sync(~0u, b, o);
    k += __shfl_down_sync(~0u, k, o);
  }
  if (lane == 0) {
    out[(size_t)e * 3] = a;
    out[(size_t)e * 3 + 1] = b;
    out[(size_t)e * 3 + 2] = (float)k;
  }
}

constexpr int kTileRowsI32 = 4096;
constexpr int kThreadsI32 = 512;
constexpr int kSmemI32 = 96 * 1024;  // the shared histogram's budget

// gpb groups from blockIdx.y * gpb; out [G, B, 3] int32, zeroed
__global__ void hist_i32_kernel(const uint8_t* __restrict__ binned, int G,
                                const short2* __restrict__ codes,
                                const float* __restrict__ w01,
                                const int* __restrict__ rows, int n, int B,
                                int gpb, int* __restrict__ out) {
  extern __shared__ int sh[];  // [gc, B, 3]
  const int g0 = blockIdx.y * gpb;
  const int gc = min(gpb, G - g0);
  const int words = gc * B * 3;
  for (int e = threadIdx.x; e < words; e += blockDim.x) sh[e] = 0;
  __syncthreads();
  const int begin = blockIdx.x * kTileRowsI32;
  const int end = min(n, begin + kTileRowsI32);
  for (int i = begin + threadIdx.x; i < end; i += blockDim.x) {
    const int r = rows ? __ldg(rows + i) : i;
    if (!(__ldg(w01 + r) > 0.f)) continue;
    const short2 q = codes[r];
    const uint8_t* b = binned + (size_t)r * G + g0;
    for (int g = 0; g < gc; ++g) {
      const int bin = __ldg(b + g);
      if (bin >= B) continue;
      int* cell = sh + (g * B + bin) * 3;
      atomicAdd(cell, (int)q.x);
      atomicAdd(cell + 1, (int)q.y);
      atomicAdd(cell + 2, 1);
    }
  }
  __syncthreads();
  int* o = out + (size_t)g0 * B * 3;
  for (int e = threadIdx.x; e < words; e += blockDim.x) {
    const int v = sh[e];
    if (v != 0) atomicAdd(o + e, v);
  }
}

}  // namespace

extern "C" int lgbt_hist_tiles(int n) {
  return n > 0 ? (n + kTileRows - 1) / kTileRows : 1;
}

// binned [N, G] u8 row-major; w3 [N, 3] f32 = (g*w, h*w, w); rows: a row
// list of n entries or NULL for rows 0..n-1; scratch: 3 * tiles * G * B
// words; out [G, B, 3] f32. Returns cudaGetLastError().
extern "C" int lgbt_leaf_histogram(const uint8_t* binned, int G,
                                   const float* w3, const int* rows, int n,
                                   int B, void* scratch, float* out,
                                   void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int tiles = lgbt_hist_tiles(n);
  const size_t warp_bytes = (size_t)kLanes * B * 12;
  int warps = (int)((96 * 1024) / warp_bytes);
  warps = warps < 1 ? 1 : (warps > 4 ? 4 : warps);
  if (warps > G) warps = G;
  const size_t smem = warp_bytes * warps;
  cudaError_t err = cudaFuncSetAttribute(
      hist_tile_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const size_t elems = (size_t)G * B;
  float* part_g = (float*)scratch;
  float* part_h = part_g + (size_t)tiles * elems;
  uint32_t* part_c = (uint32_t*)(part_h + (size_t)tiles * elems);
  dim3 grid(tiles, (G + warps - 1) / warps);
  hist_tile_kernel<<<grid, warps * kLanes, smem, s>>>(
      binned, G, w3, rows, n, B, warps, part_g, part_h, part_c);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int per_block = 8;  // warps, one element each
  hist_reduce_kernel<<<(int)((elems + per_block - 1) / per_block),
                       per_block * kLanes, 0, s>>>(part_g, part_h, part_c,
                                                   tiles, (int)elems, out);
  return (int)cudaGetLastError();
}

// binned [N, G] u8 row-major; codes [N] short2 (q_g, q_h); w01 [N] f32;
// rows: a row list of n entries or NULL for rows 0..n-1; out [G, B, 3]
// int32. Returns cudaGetLastError().
extern "C" int lgbt_leaf_histogram_i32(const uint8_t* binned, int G,
                                       const short2* codes,
                                       const float* w01, const int* rows,
                                       int n, int B, int* out,
                                       void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err =
      cudaMemsetAsync(out, 0, (size_t)G * B * 3 * sizeof(int), s);
  if (err != cudaSuccess) return (int)err;
  if (n <= 0 || G <= 0) return 0;
  int gpb = kSmemI32 / (B * 3 * (int)sizeof(int));
  gpb = gpb < 1 ? 1 : (gpb > G ? G : gpb);
  const size_t smem = (size_t)gpb * B * 3 * sizeof(int);
  err = cudaFuncSetAttribute(hist_i32_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((n + kTileRowsI32 - 1) / kTileRowsI32, (G + gpb - 1) / gpb);
  hist_i32_kernel<<<grid, kThreadsI32, smem, s>>>(binned, G, codes, w01,
                                                  rows, n, B, gpb, out);
  return (int)cudaGetLastError();
}

extern "C" const char* lgbt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
