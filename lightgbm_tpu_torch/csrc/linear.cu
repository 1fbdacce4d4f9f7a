// Linear-leaf kernels of lightgbm_tpu_torch (linear_tree=true), built
// for sm_90a by ops/_build.py and called through ctypes from
// ops/linear.py:
//
// LF linear_normal_eq: per leaf, the normal equations of its ridge fit.
// Replaces the accumulation of lightgbm_tpu/linear/solver.py fit_leaves
// (:54, with _gather_z :35): for the rows r of leaf l with design vector
// z = [x at the leaf's k path features, 1] and w = 0 where a live slot
// is not finite,
//     A[l] = sum w*h * z z^T (d x d, d = k + 1), b[l] = sum w*g * z,
//     cnt[l] = #{rows with w > 0}.
// The TPU builds these as one-hot matmuls over all rows and all leaves.
// The port's grower keeps each leaf's rows as one contiguous segment of
// its permutation (DataPartition), so here a leaf's segment is cut into
// tiles of `tile_rows` rows (a tile never spans two leaves; each block
// finds its tile from the segments on the card). Each term is formed in
// f32 as the JAX package forms it (z_i * z_j, then times w*h) and added
// exactly in f64. Two ways, by the E = d(d+1)/2 + d + 1 sums (A's upper
// triangle, b, cnt):
// - E <= 32 (k <= 5, the main path's k 5): normal_eq_rows_kernel<D>, a
//   lane a row. Each of the block's 256 threads gathers its rows (row r
//   of the tile on lane r % 256, two rows in flight) straight into
//   registers and holds all E sums there; then each sum goes through a
//   fixed f64 shuffle tree over the warp's lanes and the 8 warps are
//   added in warp order. Every thread is busy, and nothing waits at a
//   barrier while rows arrive.
// - E > 32: normal_eq_wide_kernel, a lane up to 16 sums. A block takes
//   4,096 of the sums (a grid layer for each further 4,096), and the tile's
//   rows come in chunks gathered through perm by cp.async into a ring of
//   kBufs buffers in shared memory that all of the block's sums read (a
//   chunk gathered once for them), the next chunks' gathers overlapping
//   this one's adds; each sum adds the tile's rows in order.
// A second kernel adds a leaf's tiles in tile order and rounds once to
// f32. Fixed order throughout (ops/linear.py linear_normal_eq_order
// replays it): the same bits every launch, no atomics.
// Bound on an H100 (3.35 TB/s): each row of the leaves reads its perm
// entry (4 B), g, h and w (12 B) and its k gathered values (4 B each);
// at 2,000,000 rows and k = 5, 36 B a row, 72 MB, 0.021 ms. A leaf's
// rows are scattered over x, so each gathered value costs a 32-byte
// sector in practice; the f32 -> f64 conversions (16 a clock an SM) and
// the f64 adds are the arithmetic.
//
// LS linear_solve: per leaf, the ridge and pad diagonals, the identity
// for a leaf that is not `enough` (cnt < 2d), then A beta = -b solved in
// f32 by LU with partial pivoting in LAPACK sgetrf's order (the pivot is
// the largest |a| of the column, the first on a tie), forward and back
// substitution in sgetrs's column order, and the fallback of
// solver.py:122-140: a leaf whose solution is not finite (an exactly
// singular system gives 0 pivots and so inf or NaN) keeps its constant
// with zero slopes. Replaces the batched jnp.linalg.solve of
// fit_leaves. One block (a warp) per leaf, A in shared memory; the lanes
// update the rows below the pivot. Launch-bound: 255 leaves x d^3/3
// multiply-adds is 18,360 operations at d = 6.
//
// LA linear_addend: score[r] += s * (value[l] + row_ok * lin), l =
// leaf_id[r], lin the linear term of linear_term.cuh. Replaces
// linear/solver.py linear_row_values (:143) and ops/predict.py
// linear_leaf_addend (:163): the train-score update (s = shrinkage,
// unshrunk fit, gbdt.py:1297-1301), the valid-set update (s = 1,
// shrunk tables) and rollback (s = -1). A grid of at most kBlocksLA
// blocks an SM walks the rows, a row a thread and two rows in flight;
// each block first stages the leaves' values, coefficients and features
// in shared memory, so a row's only dependent global read is its leaf
// id. The k slots are unrolled (templated up to kMaxKLA) so that a row's
// k loads, and the next row's, are all in flight before the first add.
// Tables past kTableBytes, or k past the unrolled widths, take one kernel
// that reads them from global memory in the same order.
// Bound: leaf id 4 B, k values 4k B, score in and out 8 B; at k 5 32
// bytes a row, 64 MB at 2,000,000 rows, 0.0191 ms at 3.35 TB/s. But a
// row's k scattered features touch about 3 of its 32-byte sectors of the
// row-major x [n, F] (at F = 28 and k = 5, 105 bytes a row, 0.063 ms at
// 2,000,000 rows): the sector floor of row-major x, which LF shares. LF
// storing each row's k values for LA to read in row order (32 bytes a
// row) was measured slower for the pair: LF's scattered store costs more
// than the gather saves (PERF.md §6).
//
// Everything is f32 (f64 sums in LF) with -fmad=false, so each kernel is
// bitwise equal to its plain version in ops/linear.py, except LF's f64
// sums, which may round differently in the last f32 bit (LF is bitwise
// its order replay, linear_normal_eq_order).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "linear_term.cuh"

namespace {

using lgbt_linear::linear_term;

constexpr int kThreadsLF = 256;
constexpr int kWarpsLF = kThreadsLF / 32;
constexpr int kRowsMaxD = 6;     // the rows kernel up to d = 6 (E = 28)
constexpr int kWidePer = 16;     // most sums a lane holds (wide kernel)
constexpr int kBufs = 3;         // gathered chunks in flight (wide kernel)
constexpr int kThreadsLA = 512;
constexpr int kBlocksLA = 2;        // LA blocks an SM (its launch bounds)
constexpr int kRowsLA = 2;          // rows a thread has in flight (LA)
constexpr int kMaxKLA = 8;          // slots LA unrolls
constexpr size_t kTableBytes = 48 * 1024;  // LA's staged leaf tables
// an entry's kind and columns: (kind << 24) | (j << 12) | i
constexpr int kEntryA = 0, kEntryB = 1, kEntryCnt = 2, kEntryNone = 3;

// Entry e of the E sums: (i, j) of A's upper triangle for e < d(d+1)/2,
// then b's d entries, then cnt.
__device__ __forceinline__ void entry_of(int e, int d, int& i, int& j) {
  i = 0;
  int row_len = d;
  while (e >= row_len) {
    e -= row_len;
    ++i;
    --row_len;
  }
  j = i + e;
}

__device__ __forceinline__ int entry_code(int e, int d) {
  const int n_a = d * (d + 1) / 2;
  if (e < n_a) {
    int i, j;
    entry_of(e, d, i, j);
    return (kEntryA << 24) | (j << 12) | i;
  }
  if (e < n_a + d) return (kEntryB << 24) | (e - n_a);
  return (e == n_a + d ? kEntryCnt : kEntryNone) << 24;
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_pending() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kBufs - 2));
}

// the exclusive sum of v over the block's threads, and the total
__device__ __forceinline__ int block_scan(int v, int* warp_tot, int& total) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  int x = v;
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(~0u, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) warp_tot[w] = x;
  __syncthreads();
  int before = 0;
  total = 0;
  for (int i = 0; i < kWarpsLF; ++i) {
    before += i < w ? warp_tot[i] : 0;
    total += warp_tot[i];
  }
  __syncthreads();
  return before + x - v;
}

// This block's tile: leaf l of the segments seg [2, L] (first perm
// position, rows) has ceil(rows / tile_rows) tiles, leaf by leaf. Sets
// leaf (or -1: no such tile), the tile's first perm position and rows;
// block (0, 0) writes table [2, L] (each leaf's first tile and count).
__device__ __forceinline__ void find_tile(const int* __restrict__ seg, int L,
                                          int tile_rows, int* table,
                                          int* scan, int& leaf, int& pos0,
                                          int& m) {
  const int t = threadIdx.x, tile = blockIdx.x;
  if (t == 0) scan[kWarpsLF] = -1;
  int run = 0;
  for (int l0 = 0; l0 < L; l0 += kThreadsLF) {
    const int l = l0 + t;
    const int rows = l < L ? seg[L + l] : 0;
    const int count = (rows + tile_rows - 1) / tile_rows;
    int total;
    const int first = run + block_scan(count, scan, total);
    if (l < L) {
      if (blockIdx.x == 0 && blockIdx.y == 0) {
        table[l] = first;
        table[L + l] = count;
      }
      if (first <= tile && tile < first + count) {
        scan[kWarpsLF] = l;
        scan[kWarpsLF + 1] = tile - first;
      }
    }
    run += total;
  }
  __syncthreads();
  leaf = scan[kWarpsLF];
  if (leaf < 0) return;
  const int ti = scan[kWarpsLF + 1];
  pos0 = seg[leaf] + ti * tile_rows;
  m = min(tile_rows, seg[L + leaf] - ti * tile_rows);
}

// A row's design values as the JAX package takes them: a non-finite live
// value drops the row (w = 0), subnormals count as signed zeros, padded
// slots (feature < 0) are 0 (linear_term.cuh slot_value).
using lgbt_linear::slot_value;

// E <= 32: a lane a row, all D(D+1)/2 + D + 1 sums in registers. Grid
// (max tiles); part [T, E].
template <int D>
__global__ void __launch_bounds__(kThreadsLF, 2) normal_eq_rows_kernel(
    const float* __restrict__ x, int F, const float* __restrict__ grad,
    const float* __restrict__ hess, const float* __restrict__ weight,
    const int* __restrict__ perm, const int* __restrict__ seg, int L,
    const int* __restrict__ feats, int tile_rows, int* __restrict__ table,
    double* __restrict__ part) {
  constexpr int K = D - 1;
  constexpr int E = D * (D + 1) / 2 + D + 1;
  constexpr int kAhead = 2;  // rows a thread has in flight
  __shared__ double wsum[kWarpsLF][E];
  __shared__ int scan[kWarpsLF + 2];
  const int t = threadIdx.x, lane = t & 31, w = t >> 5;
  int leaf, pos0, m;
  find_tile(seg, L, tile_rows, table, scan, leaf, pos0, m);
  if (leaf < 0) return;
  int lf[K];
#pragma unroll
  for (int j = 0; j < K; ++j) lf[j] = __ldg(feats + (size_t)leaf * K + j);

  double acc[E];
#pragma unroll
  for (int e = 0; e < E; ++e) acc[e] = 0.0;
  for (int base = t; base < m; base += kThreadsLF * kAhead) {
    float v[kAhead][K], gv[kAhead], hv[kAhead], wv[kAhead];
    int r[kAhead];
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      const int rr = base + u * kThreadsLF;
      r[u] = rr < m ? __ldg(perm + pos0 + rr) : -1;
    }
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      if (r[u] >= 0) {
        const float* xr = x + (size_t)r[u] * F;
#pragma unroll
        for (int j = 0; j < K; ++j) v[u][j] = lf[j] >= 0 ? __ldg(xr + lf[j]) : 0.f;
        gv[u] = __ldg(grad + r[u]);
        hv[u] = __ldg(hess + r[u]);
        wv[u] = __ldg(weight + r[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      if (r[u] < 0) continue;
      float z[D];
      bool ok = true;
#pragma unroll
      for (int j = 0; j < K; ++j) z[j] = lf[j] >= 0 ? slot_value(v[u][j], ok) : 0.f;
      z[K] = 1.f;
      const float wt = ok ? wv[u] : 0.f;
      const double wh = (double)__fmul_rn(wt, hv[u]);
      const double wg = (double)__fmul_rn(wt, gv[u]);
      int e = 0;
#pragma unroll
      for (int a = 0; a < D; ++a) {
#pragma unroll
        for (int b = a; b < D; ++b, ++e) {
          acc[e] = __fma_rn(wh, (double)__fmul_rn(z[a], z[b]), acc[e]);
        }
      }
#pragma unroll
      for (int a = 0; a < D; ++a, ++e) {
        acc[e] = __fma_rn(wg, (double)z[a], acc[e]);
      }
      acc[e] = acc[e] + (wt > 0.f ? 1.0 : 0.0);
    }
  }
  // each sum over the warp's lanes by a fixed tree, then the warps in
  // warp order
#pragma unroll
  for (int e = 0; e < E; ++e) {
    double s = acc[e];
    for (int o = 16; o > 0; o >>= 1) s = s + __shfl_down_sync(~0u, s, o);
    if (lane == 0) wsum[w][e] = s;
  }
  __syncthreads();
  if (t < E) {
    double s = wsum[0][t];
    for (int g = 1; g < kWarpsLF; ++g) s = s + wsum[g][t];
    part[(size_t)blockIdx.x * E + t] = s;
  }
}

// The wide kernel's shared memory: the tile scan's words, the leaf's
// features, a flag a row of the ring (its live values all finite), a
// chunk's rows' weights in f64 (w*h, w*g, live, a pad), and the ring of
// gathered rows.
__host__ __device__ __forceinline__ size_t wide_flags_at(int k) {
  return (size_t)(kWarpsLF + 2 + k) * 4;
}
__host__ __device__ __forceinline__ size_t wide_rowd_at(int k, int chunk) {
  return (wide_flags_at(k) + (size_t)kBufs * chunk * 4 + 15) & ~(size_t)15;
}
__host__ __device__ __forceinline__ size_t wide_ring_at(int k, int chunk) {
  return wide_rowd_at(k, chunk) + (size_t)chunk * 32;
}

// E > 32: a lane up to P sums (thread t of grid layer y: sums
// 256 P y + t + 256 u), each over the tile's rows in order; the rows in
// chunks of `chunk` staged by cp.async. Every sum adds weight x (z_i z_j)
// in one form: A's (i, j) with w*h; b's (i, k) with w*g, z_k being 1;
// cnt's (k, k) with live (0 or 1); the products by 1 are exact, so each
// is the term as the JAX package forms it. Grid (max tiles, E / (256 P)).
template <int P>
__global__ void __launch_bounds__(kThreadsLF, 2) normal_eq_wide_kernel(
    const float* __restrict__ x, int F, const float* __restrict__ grad,
    const float* __restrict__ hess, const float* __restrict__ weight,
    const int* __restrict__ perm, const int* __restrict__ seg, int L,
    const int* __restrict__ feats, int k, int tile_rows, int chunk,
    int* __restrict__ table, double* __restrict__ part) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int d = k + 1;
  const int E = d * (d + 1) / 2 + d + 1;
  const int stride = (d + 3) | 1;
  int* scan = reinterpret_cast<int*>(smem);       // [kWarpsLF + 2]
  int* lf = scan + kWarpsLF + 2;                   // [k]
  int* row_ok = reinterpret_cast<int*>(smem + wide_flags_at(k));
  double* rowd = reinterpret_cast<double*>(smem + wide_rowd_at(k, chunk));
  float* ring = reinterpret_cast<float*>(smem + wide_ring_at(k, chunk));
  const int t = threadIdx.x;
  int leaf, pos0, m;
  find_tile(seg, L, tile_rows, table, scan, leaf, pos0, m);
  if (leaf < 0) return;
  for (int j = t; j < k; j += kThreadsLF) lf[j] = feats[(size_t)leaf * k + j];
  const int e0 = blockIdx.y * kThreadsLF * P;
  const int per = min(P, (E - e0 + kThreadsLF - 1) / kThreadsLF);
  int zi[P], zj[P], wk[P];  // columns of z and the weight of each sum
  double acc[P];
#pragma unroll
  for (int u = 0; u < P; ++u) {
    const int e = e0 + t + u * kThreadsLF;
    const int code = e < E ? entry_code(e, d) : kEntryNone << 24;
    const int kind = code >> 24;
    zi[u] = kind == kEntryCnt ? k : code & 0xfff;
    zj[u] = kind == kEntryA ? (code >> 12) & 0xfff : k;
    wk[u] = kind == kEntryA ? 0 : kind == kEntryB ? 1 : 2;
    acc[u] = 0.0;
  }
  __syncthreads();

  const int tpr = max(1, kThreadsLF / chunk);  // threads a gathered row
  const int g_row = t / tpr, g_part = t % tpr;
  const int nch = (m + chunk - 1) / chunk;
  auto gather = [&](int c, int r) {
    if (c < nch && g_row < min(chunk, m - c * chunk)) {
      const int slot = (c % kBufs) * chunk + g_row;
      float* z = ring + (size_t)slot * stride;
      const float* xr = x + (size_t)r * F;
      for (int j = g_part; j < k; j += tpr) {
        const int f = lf[j];
        if (f >= 0) {
          cp_async4(z + j, xr + f);
        } else {
          z[j] = 0.f;
        }
      }
      if (g_part == 0) {
        row_ok[slot] = 1;
        cp_async4(z + d, hess + r);
        cp_async4(z + d + 1, grad + r);
        cp_async4(z + d + 2, weight + r);
      }
    }
    cp_async_commit();
  };
  auto row_of = [&](int c) {
    return c < nch && g_row < min(chunk, m - c * chunk)
               ? __ldg(perm + pos0 + c * chunk + g_row)
               : 0;
  };
  for (int c = 0; c < kBufs - 1; ++c) gather(c, row_of(c));
  int r_next = row_of(kBufs - 1);
  for (int c = 0; c < nch; ++c) {
    cp_async_wait_pending();
    __syncthreads();
    gather(c + kBufs - 1, r_next);
    r_next = row_of(c + kBufs);
    const int base = (c % kBufs) * chunk;
    float* zc = ring + (size_t)base * stride;
    const int mc = min(chunk, m - c * chunk);
    // the chunk's live values, all threads: a non-finite one drops its
    // row (w = 0), subnormals count as signed zeros
    for (int cell = t; cell < mc * k; cell += kThreadsLF) {
      const int row = cell / k, j = cell - row * k;
      float* z = zc + (size_t)row * stride;
      bool ok = true;
      z[j] = slot_value(z[j], ok);
      if (!ok) row_ok[base + row] = 0;
    }
    __syncthreads();
    if (t < mc) {
      float* z = zc + (size_t)t * stride;
      const float wt = row_ok[base + t] ? z[d + 2] : 0.f;
      rowd[4 * t] = (double)__fmul_rn(wt, z[d]);
      rowd[4 * t + 1] = (double)__fmul_rn(wt, z[d + 1]);
      rowd[4 * t + 2] = wt > 0.f ? 1.0 : 0.0;
      z[k] = 1.f;
    }
    __syncthreads();
    for (int rr = 0; rr < mc; ++rr) {
      const float* z = zc + (size_t)rr * stride;
      const double* wr = rowd + 4 * rr;
#pragma unroll
      for (int u = 0; u < P; ++u) {
        if (u < per) {
          acc[u] = __fma_rn(wr[wk[u]], (double)__fmul_rn(z[zi[u]], z[zj[u]]),
                            acc[u]);
        }
      }
    }
  }
#pragma unroll
  for (int u = 0; u < P; ++u) {
    const int e = e0 + t + u * kThreadsLF;
    if (u < per && e < E) part[(size_t)blockIdx.x * E + e] = acc[u];
  }
}

// A thread a (leaf, sum), grid (L, sums / 128): the leaf's tiles
// table[l] .. + table[L + l] added in order, eight loads in flight,
// rounded to f32; A written symmetric.
__global__ void normal_eq_reduce_kernel(const double* __restrict__ part,
                                        const int* __restrict__ table,
                                        int L, int k, float* __restrict__ A,
                                        float* __restrict__ b,
                                        float* __restrict__ cnt) {
  const int l = blockIdx.x;
  const int d = k + 1;
  const int n_a = d * (d + 1) / 2;
  const int E = n_a + d + 1;
  const int e = blockIdx.y * blockDim.x + threadIdx.x;
  if (e >= E) return;
  const int t0 = table[l], t1 = t0 + table[L + l];
  double s = 0.0;
  int t = t0;
  for (; t + 8 <= t1; t += 8) {
    double v[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) v[u] = part[(size_t)(t + u) * E + e];
#pragma unroll
    for (int u = 0; u < 8; ++u) s += v[u];
  }
  for (; t < t1; ++t) s += part[(size_t)t * E + e];
  const float v = (float)s;
  if (e < n_a) {
    int i, j;
    entry_of(e, d, i, j);
    A[((size_t)l * d + i) * d + j] = v;
    A[((size_t)l * d + j) * d + i] = v;
  } else if (e < n_a + d) {
    b[(size_t)l * d + (e - n_a)] = v;
  } else {
    cnt[l] = v;
  }
}

// One warp per leaf; a [d, d] and rhs [d] in shared memory.
__global__ void solve_kernel(const float* __restrict__ A,
                             const float* __restrict__ b,
                             const float* __restrict__ cnt,
                             const int* __restrict__ feats,
                             const float* __restrict__ leaf_const, float lam,
                             int k, float* __restrict__ value,
                             float* __restrict__ coeff,
                             uint8_t* __restrict__ fitted) {
  extern __shared__ float sm[];
  __shared__ int pivot;
  const int l = blockIdx.x, lane = threadIdx.x;
  const int d = k + 1;
  float* a = sm;
  float* rhs = sm + d * d;
  const int* lf = feats + (size_t)l * k;
  const bool enough = cnt[l] >= 2.f * (float)d;
  for (int e = lane; e < d * d; e += 32) {
    const int i = e / d, j = e % d;
    float v = A[(size_t)l * d * d + e];
    if (i == j && i < k) v = __fadd_rn(v, lf[i] < 0 ? 1.f : lam);
    if (!enough) v = i == j ? 1.f : 0.f;
    a[e] = v;
  }
  for (int i = lane; i < d; i += 32) rhs[i] = -b[(size_t)l * d + i];
  __syncwarp();
  for (int c = 0; c < d; ++c) {
    if (lane == 0) {
      // the first largest |a|, NaN counting as largest (torch.argmax)
      int p = c;
      float best = fabsf(a[c * d + c]);
      for (int i = c + 1; i < d; ++i) {
        const float v = fabsf(a[i * d + c]);
        if (!isnan(best) && (isnan(v) || v > best)) {
          best = v;
          p = i;
        }
      }
      pivot = p;
    }
    __syncwarp();
    const int p = pivot;
    if (p != c) {
      for (int j = lane; j < d; j += 32) {
        const float t = a[c * d + j];
        a[c * d + j] = a[p * d + j];
        a[p * d + j] = t;
      }
      if (lane == 0) {
        const float t = rhs[c];
        rhs[c] = rhs[p];
        rhs[p] = t;
      }
    }
    __syncwarp();
    const float piv = a[c * d + c];
    for (int i = c + 1 + lane; i < d; i += 32) {
      const float m = __fdiv_rn(a[i * d + c], piv);
      a[i * d + c] = m;
      for (int j = c + 1; j < d; ++j) {
        a[i * d + j] = __fsub_rn(a[i * d + j], __fmul_rn(m, a[c * d + j]));
      }
      rhs[i] = __fsub_rn(rhs[i], __fmul_rn(m, rhs[c]));
    }
    __syncwarp();
  }
  for (int j = d - 1; j >= 0; --j) {
    if (lane == 0) rhs[j] = __fdiv_rn(rhs[j], a[j * d + j]);
    __syncwarp();
    for (int i = lane; i < j; i += 32) {
      rhs[i] = __fsub_rn(rhs[i], __fmul_rn(rhs[j], a[i * d + j]));
    }
    __syncwarp();
  }
  if (lane == 0) {
    bool fin = enough;
    for (int j = 0; j < d; ++j) fin = fin && isfinite(rhs[j]);
    value[l] = fin ? rhs[k] : leaf_const[l];
    for (int j = 0; j < k; ++j) {
      coeff[(size_t)l * k + j] = (fin && lf[j] >= 0) ? rhs[j] : 0.f;
    }
    fitted[l] = fin ? 1 : 0;
  }
}

// LA over staged tables: K slots a row unrolled, gathered from x [n, F]
// by the leaf's features; rows r = block * threads + t + i * grid
// threads, kRowsLA of them in flight a thread. Dynamic shared memory:
// value [L], coeff [L, K] and feats [L, K].
template <int K>
__global__ void __launch_bounds__(kThreadsLA, kBlocksLA) addend_kernel(
    const float* __restrict__ x, int F, int n,
    const int* __restrict__ leaf_id, const float* __restrict__ value,
    const float* __restrict__ coeff, const int* __restrict__ feats, int L,
    float scale, float* __restrict__ score) {
  extern __shared__ __align__(16) float tab[];
  float* s_value = tab;
  float* s_coeff = tab + L;
  int* s_feat = reinterpret_cast<int*>(tab + L + L * K);
  for (int i = threadIdx.x; i < L; i += kThreadsLA) {
    s_value[i] = __ldg(value + i);
  }
  for (int i = threadIdx.x; i < L * K; i += kThreadsLA) {
    s_coeff[i] = __ldg(coeff + i);
    s_feat[i] = __ldg(feats + i);
  }
  __syncthreads();
  const long long step = (long long)gridDim.x * kThreadsLA;
  for (long long r0 = (long long)blockIdx.x * kThreadsLA + threadIdx.x;
       r0 < n; r0 += kRowsLA * step) {
    int l[kRowsLA];
    float sc[kRowsLA], v[kRowsLA][K];
#pragma unroll
    for (int u = 0; u < kRowsLA; ++u) {
      const long long r = r0 + u * step;
      l[u] = r < n ? __ldg(leaf_id + r) : 0;
      sc[u] = r < n ? score[r] : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kRowsLA; ++u) {
      const long long r = r0 + u * step;
      const float* row = x + (size_t)(r < n ? r : 0) * F;
#pragma unroll
      for (int j = 0; j < K; ++j) {
        const int f = s_feat[l[u] * K + j];
        v[u][j] = (r < n && f >= 0) ? __ldg(row + f) : 0.f;
      }
    }
#pragma unroll
    for (int u = 0; u < kRowsLA; ++u) {
      const long long r = r0 + u * step;
      if (r >= n) continue;
      bool ok;
      const float lin =
          lgbt_linear::linear_term_values<K>(v[u], s_coeff + l[u] * K, ok);
      const float t = __fadd_rn(s_value[l[u]], ok ? lin : 0.f);
      score[r] = __fadd_rn(sc[u], __fmul_rn(scale, t));
    }
  }
}

// LA at any k and table size: a row a thread, tables from global memory,
// the same order (linear_term.cuh).
__global__ void __launch_bounds__(kThreadsLA) addend_any_kernel(
    const float* __restrict__ x, int F, int n,
    const int* __restrict__ leaf_id, const float* __restrict__ value,
    const float* __restrict__ coeff, const int* __restrict__ feats, int k,
    float scale, float* __restrict__ score) {
  const long long r = (long long)blockIdx.x * kThreadsLA + threadIdx.x;
  if (r >= n) return;
  const int l = __ldg(leaf_id + r);
  bool ok;
  const float lin = linear_term(x + (size_t)r * F, coeff + (size_t)l * k,
                                feats + (size_t)l * k, k, ok);
  const float t = __fadd_rn(__ldg(value + l), ok ? lin : 0.f);
  score[r] = __fadd_rn(score[r], __fmul_rn(scale, t));
}

// the SM count of the current card, read once
int sm_count() {
  static int sms = -1;
  if (sms < 0) {
    int dev = 0, v = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&v, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess)
      return 0;
    sms = v;
  }
  return sms;
}

template <int K>
cudaError_t launch_addend(const float* x, int F, int n,
                          const int* leaf_id, const float* value,
                          const float* coeff, const int* feats, int L,
                          float scale, float* score, size_t smem,
                          cudaStream_t s) {
  const long long want =
      ((long long)n + kThreadsLA * kRowsLA - 1) / (kThreadsLA * kRowsLA);
  const long long cap = (long long)kBlocksLA * sm_count();
  const int blocks = (int)(want < cap ? want : (cap > 0 ? cap : want));
  addend_kernel<K><<<blocks, kThreadsLA, smem, s>>>(
      x, F, n, leaf_id, value, coeff, feats, L, scale, score);
  return cudaGetLastError();
}

cudaError_t launch_addend_k(int k, const float* x, int F, int n,
                            const int* leaf_id, const float* value,
                            const float* coeff, const int* feats, int L,
                            float scale, float* score, cudaStream_t s) {
  const size_t smem = (size_t)L * (1 + 2 * k) * sizeof(float);
  if (k <= kMaxKLA && smem <= kTableBytes) {
#define LGBT_ADDEND_K(KK)                                             \
  case KK:                                                            \
    return launch_addend<KK>(x, F, n, leaf_id, value, coeff, feats, L, \
                             scale, score, smem, s);
    switch (k) {
      LGBT_ADDEND_K(1)
      LGBT_ADDEND_K(2)
      LGBT_ADDEND_K(3)
      LGBT_ADDEND_K(4)
      LGBT_ADDEND_K(5)
      LGBT_ADDEND_K(6)
      LGBT_ADDEND_K(7)
      LGBT_ADDEND_K(8)
      default:
        break;
    }
#undef LGBT_ADDEND_K
  }
  const int blocks = (int)(((long long)n + kThreadsLA - 1) / kThreadsLA);
  addend_any_kernel<<<blocks, kThreadsLA, 0, s>>>(
      x, F, n, leaf_id, value, coeff, feats, k, scale, score);
  return cudaGetLastError();
}

template <int P>
cudaError_t launch_wide(size_t smem, int max_tiles, int E, cudaStream_t s,
                        const float* x, int F, const float* grad,
                        const float* hess, const float* weight,
                        const int* perm, const int* seg, int L,
                        const int* feats, int k, int tile_rows, int chunk,
                        int* table, double* part) {
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        normal_eq_wide_kernel<P>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
  }
  const int layer = kThreadsLF * P;
  normal_eq_wide_kernel<P>
      <<<dim3(max_tiles, (E + layer - 1) / layer), kThreadsLF, smem, s>>>(
          x, F, grad, hess, weight, perm, seg, L, feats, k, tile_rows, chunk,
          table, part);
  return cudaGetLastError();
}

}  // namespace

// x [N, F] f32; grad/hess/weight [N] f32; perm [N] i32; seg [2, L] i32
// (each leaf's first perm position, its rows); feats [L, k] i32; the
// plan of ops/linear.py normal_eq_plan: tile_rows, chunk (a power of two
// up to 256; the wide kernel's), max_tiles (at least the tiles there
// are); table: 2L ints and part: max_tiles * E doubles of scratch; A [L,
// d, d], b [L, d], cnt [L] f32, written for every leaf.
extern "C" int lgbt_linear_normal_eq(
    const float* x, int F, const float* grad, const float* hess,
    const float* weight, const int* perm, const int* seg, int L,
    const int* feats, int k, int tile_rows, int chunk, int max_tiles,
    int* table, void* part, float* A, float* b, float* cnt, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (L <= 0) return 0;
  const int d = k + 1;
  const int E = d * (d + 1) / 2 + d + 1;
  const int stride = (d + 3) | 1;
  if (k < 1 || k >= 4095 || chunk < 1 || chunk > kThreadsLF ||
      (chunk & (chunk - 1)) || tile_rows < 1 || max_tiles < 1)
    return (int)cudaErrorInvalidValue;
  double* pt = (double*)part;
  switch (d) {
    case 2:
      normal_eq_rows_kernel<2><<<max_tiles, kThreadsLF, 0, s>>>(
          x, F, grad, hess, weight, perm, seg, L, feats, tile_rows, table, pt);
      break;
    case 3:
      normal_eq_rows_kernel<3><<<max_tiles, kThreadsLF, 0, s>>>(
          x, F, grad, hess, weight, perm, seg, L, feats, tile_rows, table, pt);
      break;
    case 4:
      normal_eq_rows_kernel<4><<<max_tiles, kThreadsLF, 0, s>>>(
          x, F, grad, hess, weight, perm, seg, L, feats, tile_rows, table, pt);
      break;
    case 5:
      normal_eq_rows_kernel<5><<<max_tiles, kThreadsLF, 0, s>>>(
          x, F, grad, hess, weight, perm, seg, L, feats, tile_rows, table, pt);
      break;
    case 6:
      normal_eq_rows_kernel<6><<<max_tiles, kThreadsLF, 0, s>>>(
          x, F, grad, hess, weight, perm, seg, L, feats, tile_rows, table, pt);
      break;
    default: {
      const size_t smem = wide_ring_at(k, chunk) +
                          (size_t)kBufs * chunk * stride * sizeof(float);
      const int per = (E + kThreadsLF - 1) / kThreadsLF;
      cudaError_t err = cudaSuccess;
      if (per <= 4) {
        err = launch_wide<4>(smem, max_tiles, E, s, x, F, grad, hess, weight,
                             perm, seg, L, feats, k, tile_rows, chunk, table,
                             pt);
      } else if (per <= 8) {
        err = launch_wide<8>(smem, max_tiles, E, s, x, F, grad, hess, weight,
                             perm, seg, L, feats, k, tile_rows, chunk, table,
                             pt);
      } else if (per <= 12) {
        err = launch_wide<12>(smem, max_tiles, E, s, x, F, grad, hess,
                              weight, perm, seg, L, feats, k, tile_rows,
                              chunk, table, pt);
      } else {
        err = launch_wide<kWidePer>(smem, max_tiles, E, s, x, F, grad, hess,
                                    weight, perm, seg, L, feats, k,
                                    tile_rows, chunk, table, pt);
      }
      if (err != cudaSuccess) return (int)err;
    }
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  normal_eq_reduce_kernel<<<dim3(L, (E + 127) / 128), 128, 0, s>>>(
      pt, table, L, k, A, b, cnt);
  return (int)cudaGetLastError();
}

// The rows kernel takes d up to this (the wide kernel past it).
extern "C" int lgbt_linear_rows_max_d() { return kRowsMaxD; }

// A [L, d, d], b [L, d], cnt [L] f32; feats [L, k] i32; leaf_const [L]
// f32; value [L], coeff [L, k] f32 and fitted [L] u8 out.
extern "C" int lgbt_linear_solve(const float* A, const float* b,
                                 const float* cnt, const int* feats,
                                 const float* leaf_const, float lam, int L,
                                 int k, float* value, float* coeff,
                                 uint8_t* fitted, void* stream) {
  if (L <= 0) return 0;
  const int d = k + 1;
  const size_t smem = (size_t)(d * d + d) * sizeof(float);
  if (smem > 48 * 1024) {  // k > 109
    cudaError_t err = cudaFuncSetAttribute(
        solve_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  solve_kernel<<<L, 32, smem, (cudaStream_t)stream>>>(
      A, b, cnt, feats, leaf_const, lam, k, value, coeff, fitted);
  return (int)cudaGetLastError();
}

// x [n, F] f32; leaf_id [n] i32; value [L], coeff [L, k] f32; feats [L,
// k] i32 columns of x, -1 padded; score [n] f32, added to in place.
extern "C" int lgbt_linear_addend(const float* x, int n, int F,
                                  const int* leaf_id, const float* value,
                                  const float* coeff, const int* feats,
                                  int L, int k, float scale, float* score,
                                  void* stream) {
  if (n <= 0) return 0;
  if (L < 1 || k < 1) return (int)cudaErrorInvalidValue;
  return (int)launch_addend_k(k, x, F, n, leaf_id, value, coeff, feats, L,
                              scale, score, (cudaStream_t)stream);
}

extern "C" const char* lgbt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
