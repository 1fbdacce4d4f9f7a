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
// fit_leaves. Every element goes through the plain version's operations
// in its order (a rounded multiply, then a rounded subtract; a correctly
// rounded division), so LS is bitwise its plain version; the pivot is
// the first NaN, else the first largest |a|, as torch.argmax picks it
// (pivot_key). One launch, in one of two modes by d alone (ops/linear.py
// solve_plan):
// - d <= kSolveRegsMaxD (16; the main path's k 5): solve_regs_kernel<D>,
//   a lane a row of [A | rhs] with the row in registers, d rounded up to
//   a power of two lanes a leaf (8 at d = 6: four leaves a warp). A
//   column costs a shuffle max of (|a|'s bits, ~row) over the leaf's
//   lanes, rows c and p exchanged and the pivot row broadcast by
//   shuffles, one division a lane and the row's update; the back-
//   substitution one broadcast and one division a column. (A thread a
//   leaf, the whole system in one thread's registers and the swap by
//   selects, is slower: its chain of about d^3/3 dependent operations
//   sits on one lane.)
// - past it: solve_block_kernel<kShared, R>, a block a leaf, [A | rhs]
//   in shared memory at an odd row stride (in a global scratch past
//   227 KB, any k). The rows are pivoted through a permutation of row
//   slots, so no row moves and a column costs one barrier: warp 0, its
//   lane holding positions lane + 32q (q < R) with their slots, column
//   values and multipliers in registers, updates the next column, finds
//   its pivot by two warp max-reductions, swaps two slots and divides,
//   and writes the slots and multipliers into second buffers, while the
//   other warps update the rest of the trailing matrix (a warp two rows
//   at a time, a lane a column, the pivot row in registers). Warp 0 then
//   back-substitutes, a column's rhs and diagonal broadcast and one
//   division a column.
// Every lane divides (a division under a divergent branch costs several
// uniform ones), and div_rn answers a zero dividend without the
// division's slow path. Bound: 255 leaves x d^3/3 multiply-adds is
// 18,360 operations at d = 6, under a microsecond: LS is launch-bound at
// the main path's width (the floor of an empty kernel in a CUDA graph:
// PERF.md §6), and past 16 bound by the d dependent pivot steps of one
// leaf, not by its operations.
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
constexpr int kSolveRegsMaxD = 16;  // LS's register mode up to this d
constexpr int kSolveRegsThreads = 64;  // its threads a block
constexpr int kSolveMaxThreads = 512;  // LS's block mode, at most
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

// LS's pivot key: |v|'s bits, which order |v|, with every NaN as one
// value above +inf; a larger key is a better pivot. With ~row in the low
// word, the largest key of a column is torch.argmax's pick: the first
// NaN, else the first largest |a|.
__device__ __forceinline__ unsigned long long pivot_key(float v, int row) {
  const float a = fabsf(v);
  const uint32_t hi = isnan(a) ? 0x7FC00000u : __float_as_uint(a);
  return ((unsigned long long)hi << 32) | (uint32_t)~row;
}

// __fdiv_rn(a, b), but a zero dividend over a finite nonzero divisor is
// answered as the product a * b (the same signed zero) without the
// division's slow path, which a zero dividend takes at several times a
// division's cost: padded slots and under-populated leaves divide zeros
// in every column. Every other case is __fdiv_rn's.
__device__ __forceinline__ float div_rn(float a, float b) {
  const bool zero = a == 0.f && b != 0.f && isfinite(b);
  const float q = __fdiv_rn(zero ? 1.f : a, b);
  return zero ? __fmul_rn(a, b) : q;
}

// v[q] for a q known only at run time, by selects (v stays in registers)
template <int R, typename T>
__device__ __forceinline__ T pick(const T (&v)[R], int q) {
  T out = v[0];
#pragma unroll
  for (int s = 1; s < R; ++s) out = q == s ? v[s] : out;
  return out;
}

// The lanes a leaf takes in the register mode: d rounded up to a power
// of two.
__host__ __device__ constexpr int solve_lanes(int d) {
  return d <= 2 ? 2 : d <= 4 ? 4 : d <= 8 ? 8 : d <= 16 ? 16 : 32;
}

// LS, register mode: a lane a row of [A | rhs], solve_lanes(D) lanes a
// leaf, the row in registers. A column: its pivot by a shuffle max over
// the leaf's lanes, rows c and p exchanged by shuffles, the pivot row
// broadcast by shuffles, one division a lane and the row's update; the
// back-substitution one division and one shuffle a column.
template <int D>
__global__ void __launch_bounds__(kSolveRegsThreads) solve_regs_kernel(
    const float* __restrict__ A, const float* __restrict__ b,
    const float* __restrict__ cnt, const int* __restrict__ feats,
    const float* __restrict__ leaf_const, float lam, int L,
    float* __restrict__ value, float* __restrict__ coeff,
    uint8_t* __restrict__ fitted) {
  constexpr int K = D - 1;
  constexpr int W = solve_lanes(D);
  const int lane = threadIdx.x & 31;
  const int r = lane & (W - 1);           // this lane's row of its leaf
  const int base = lane & ~(W - 1);       // the leaf's first lane
  const int l = (blockIdx.x * kSolveRegsThreads + threadIdx.x) / W;
  const bool live = l < L && r < D;
  // lanes of no row (and of leaves past L) read row 0 of the last leaf
  const int lr = l < L ? l : L - 1, rr = r < D ? r : 0;
  float row[D + 1];
  const float* ar = A + ((size_t)lr * D + rr) * D;
#pragma unroll
  for (int j = 0; j < D; ++j) row[j] = ar[j];
  row[D] = -b[(size_t)lr * D + rr];
  const int f = r < K ? feats[(size_t)lr * K + r] : 0;
  const bool enough = cnt[lr] >= 2.f * (float)D;
  const float konst = leaf_const[lr];
#pragma unroll
  for (int j = 0; j < D; ++j) {
    float v = row[j];
    if (j == r && r < K) v = __fadd_rn(v, f < 0 ? 1.f : lam);
    row[j] = enough ? v : (j == r ? 1.f : 0.f);
  }
#pragma unroll
  for (int c = 0; c < D; ++c) {
    unsigned long long key =
        live && r >= c ? pivot_key(row[c], r) : 0ull;
#pragma unroll
    for (int o = W / 2; o > 0; o >>= 1) {
      const unsigned long long other = __shfl_xor_sync(0xffffffffu, key, o);
      key = other > key ? other : key;
    }
    const int p = (int)~(uint32_t)key;
    // rows c and p exchange; the pivot row, old row p, to every lane
    const int src = base + (r == c ? p : (r == p ? c : r));
    float u[D + 1];
#pragma unroll
    for (int j = c; j <= D; ++j) {
      u[j] = __shfl_sync(0xffffffffu, row[j], base + p);
      row[j] = __shfl_sync(0xffffffffu, row[j], src);
    }
    // every lane divides (a division under a divergent branch costs
    // several uniform ones); the rows below the pivot keep it
    const float m = div_rn(row[c], u[c]);
    if (r > c) {
#pragma unroll
      for (int j = c + 1; j <= D; ++j)
        row[j] = __fsub_rn(row[j], __fmul_rn(m, u[j]));
    }
  }
  // back-substitution: row j's rhs and diagonal to every lane, which
  // all divide
#pragma unroll
  for (int j = D - 1; j >= 0; --j) {
    const float xr = __shfl_sync(0xffffffffu, row[D], base + j);
    const float ujj = __shfl_sync(0xffffffffu, row[j], base + j);
    const float xj = div_rn(xr, ujj);
    if (r == j) row[D] = xj;
    if (r < j) row[D] = __fsub_rn(row[D], __fmul_rn(xj, row[j]));
  }
  const uint32_t bad =
      __ballot_sync(0xffffffffu, live && !isfinite(row[D]));
  const uint32_t mine = W == 32 ? 0xffffffffu : ((1u << W) - 1) << base;
  const bool fin = enough && (bad & mine) == 0;
  if (!live) return;
  if (r < K) coeff[(size_t)l * K + r] = (fin && f >= 0) ? row[D] : 0.f;
  if (r == K) {
    value[l] = fin ? row[D] : konst;
    fitted[l] = fin ? 1 : 0;
  }
}

// LS, block mode: a block a leaf. Logical row i of [A | rhs] (d rows of
// d + 1 words at the odd stride S) lives in row slot[i]. Warp 0's lane
// holds positions lane + 32q (q < R, d <= 32R): their slots, column
// values and multipliers in registers; the other warps read the slots
// and multipliers from double-buffered shared tables ([2][d] each),
// which warp 0 writes for the next column while they update this one.
// kShared: the system in dynamic shared memory, else in `sys` (d x S
// words a leaf); the tables are in shared memory either way.
template <bool kShared, int R>
__global__ void __launch_bounds__(kSolveMaxThreads) solve_block_kernel(
    const float* __restrict__ A, const float* __restrict__ b,
    const float* __restrict__ cnt, const int* __restrict__ feats,
    const float* __restrict__ leaf_const, float lam, int k,
    float* __restrict__ sys, float* __restrict__ value,
    float* __restrict__ coeff, uint8_t* __restrict__ fitted) {
  extern __shared__ __align__(16) float sm[];
  const int l = blockIdx.x, d = k + 1, S = (d + 1) | 1;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int bulk = (blockDim.x >> 5) - 1;  // the warps of the update
  float* const M = kShared ? sm : sys + (size_t)l * d * S;
  float* const mult = kShared ? sm + (size_t)d * S : sm;
  int* const slot = reinterpret_cast<int*>(mult + 2 * d);
  const int* lf = feats + (size_t)l * k;
  const bool enough = cnt[l] >= 2.f * (float)d;
  const float* al = A + (size_t)l * d * d;
  for (int e = tid; e < d * d; e += blockDim.x) {
    const int i = e / d, j = e - i * d;
    float v = al[e];
    if (i == j && i < k) v = __fadd_rn(v, lf[i] < 0 ? 1.f : lam);
    M[i * S + j] = enough ? v : (i == j ? 1.f : 0.f);
  }
  for (int i = tid; i < d; i += blockDim.x) M[i * S + d] = -b[(size_t)l * d + i];
  __syncthreads();
  int rs[R];           // warp 0: the slots of positions lane + 32q
  float m[R];          // and their multipliers for the current column
#pragma unroll
  for (int q = 0; q < R; ++q) {
    rs[q] = lane + 32 * q < d ? lane + 32 * q : 0;
    m[q] = 0.f;
  }
  int prow = 0;        // warp 0: the slot of the pivot row, position c
  int cur = 0;
  // step c eliminates column c (c >= 0) and pivots column col = c + 1
  for (int c = -1; c < d - 1; ++c) {
    const int col = c + 1;
    if (warp == 0) {
      int* sn = slot + (cur ^ 1) * d;
      float* mn = mult + (cur ^ 1) * d;
      // column col for positions >= col: every load, then the updates
      // and keys, then the stores, so the positions' chains overlap (a
      // store could alias a later load); the branches on q are the
      // warp's (positions lane + 32q past d are skipped whole), the rest
      // is predicated
      const float u = c >= 0 ? M[prow * S + col] : 0.f;
      float v[R];
#pragma unroll
      for (int q = 0; q < R; ++q)
        v[q] = 32 * q < d ? M[rs[q] * S + col] : 0.f;
      unsigned long long best = 0ull;
#pragma unroll
      for (int q = 0; q < R; ++q) {
        if (32 * q >= d) continue;
        const int i = lane + 32 * q;
        if (c >= 0) v[q] = __fsub_rn(v[q], __fmul_rn(m[q], u));
        const unsigned long long key =
            i >= col && i < d ? pivot_key(v[q], i) : 0ull;
        best = key > best ? key : best;
      }
      if (c >= 0) {
#pragma unroll
        for (int q = 0; q < R; ++q) {
          const int i = lane + 32 * q;
          if (32 * q < d && i >= col && i < d) M[rs[q] * S + col] = v[q];
        }
      }
      const uint32_t hi =
          __reduce_max_sync(0xffffffffu, (uint32_t)(best >> 32));
      const uint32_t lo = __reduce_max_sync(
          0xffffffffu, (uint32_t)(best >> 32) == hi ? (uint32_t)best : 0u);
      const int p = (int)~lo;
      const float piv = __shfl_sync(0xffffffffu, pick(v, p >> 5), p & 31);
      const int slot_p = __shfl_sync(0xffffffffu, pick(rs, p >> 5), p & 31);
      const float v_col = __shfl_sync(0xffffffffu, pick(v, col >> 5),
                                      col & 31);
      const int slot_col = __shfl_sync(0xffffffffu, pick(rs, col >> 5),
                                       col & 31);
#pragma unroll
      for (int q = 0; q < R; ++q) {
        const int i = lane + 32 * q;
        if (i == p) {
          rs[q] = slot_col;
          v[q] = v_col;
        }
        if (i == col) rs[q] = slot_p;
      }
      // every lane divides (a division under a divergent branch costs
      // several uniform ones); the positions below the pivot keep it
      float mq[R];
#pragma unroll
      for (int q = 0; q < R; ++q)
        mq[q] = 32 * q < d ? div_rn(v[q], piv) : 0.f;
#pragma unroll
      for (int q = 0; q < R; ++q)
        if (lane + 32 * q > col) m[q] = mq[q];
#pragma unroll
      for (int q = 0; q < R; ++q) {
        const int i = lane + 32 * q;
        if (32 * q < d && i >= col && i < d) {
          sn[i] = rs[q];
          if (i > col) mn[i] = m[q];
        }
      }
      prow = slot_p;
    } else if (c >= 0) {
      // rows col.. (a warp a row) minus their multiple of the pivot row,
      // columns col + 1..d (a lane a column); the pivot row's values
      // stay in registers, the next row's slot and multiplier are read
      // before this row's stores
      const int* sc = slot + cur * d;
      const float* mc = mult + cur * d;
      const float* pr = M + sc[c] * S;
      const int width = d - col;   // columns col + 1..d
      float pu[R + 1];
#pragma unroll
      for (int s = 0; s <= R; ++s) {
        const int j = col + 1 + lane + 32 * s;
        pu[s] = 32 * s < width && j <= d ? pr[j] : 0.f;
      }
      for (int i = col + warp - 1; i < d; i += 2 * bulk) {
        const int i2 = i + bulk;
        const bool two = i2 < d;
        float* row1 = M + sc[i] * S;
        float* row2 = M + (two ? sc[i2] : sc[i]) * S;
        const float m1 = mc[i], m2 = two ? mc[i2] : 0.f;
        float a1[R + 1], a2[R + 1];
#pragma unroll
        for (int s = 0; s <= R; ++s) {
          if (32 * s >= width) continue;
          const int j = col + 1 + lane + 32 * s;
          a1[s] = j <= d ? row1[j] : 0.f;
          a2[s] = j <= d ? row2[j] : 0.f;
        }
#pragma unroll
        for (int s = 0; s <= R; ++s) {
          if (32 * s >= width) continue;
          const int j = col + 1 + lane + 32 * s;
          if (j <= d) {
            row1[j] = __fsub_rn(a1[s], __fmul_rn(m1, pu[s]));
            if (two) row2[j] = __fsub_rn(a2[s], __fmul_rn(m2, pu[s]));
          }
        }
      }
    }
    __syncthreads();
    cur ^= 1;
  }
  if (warp != 0) return;
  // back-substitution: lane i % 32 holds position i's rhs and diagonal;
  // a column's rhs and diagonal go to every lane, which all divide
  float x[R], diag[R];
#pragma unroll
  for (int q = 0; q < R; ++q) {
    const int i = lane + 32 * q;
    x[q] = i < d ? M[rs[q] * S + d] : 0.f;
    diag[q] = i < d ? M[rs[q] * S + i] : 1.f;
  }
  for (int j = d - 1; j >= 0; --j) {
    const int qj = j >> 5, lj = j & 31;
    float uij[R];
#pragma unroll
    for (int q = 0; q < R; ++q)
      uij[q] = 32 * q < d ? M[rs[q] * S + j] : 0.f;
    const float xr = __shfl_sync(0xffffffffu, pick(x, qj), lj);
    const float ujj = __shfl_sync(0xffffffffu, pick(diag, qj), lj);
    const float xj = div_rn(xr, ujj);
#pragma unroll
    for (int q = 0; q < R; ++q) {
      const int i = lane + 32 * q;
      if (i == j) x[q] = xj;
      if (i < j) x[q] = __fsub_rn(x[q], __fmul_rn(xj, uij[q]));
    }
  }
  bool fin = enough;
#pragma unroll
  for (int q = 0; q < R; ++q)
    if (lane + 32 * q < d) fin = fin && isfinite(x[q]);
  fin = __all_sync(0xffffffffu, fin);
#pragma unroll
  for (int q = 0; q < R; ++q) {
    const int i = lane + 32 * q;
    if (i < k) coeff[(size_t)l * k + i] = (fin && lf[i] >= 0) ? x[q] : 0.f;
    if (i == k) {
      value[l] = fin ? x[q] : leaf_const[l];
      fitted[l] = fin ? 1 : 0;
    }
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

// LS's register mode takes d up to this (the block mode past it).
extern "C" int lgbt_linear_solve_regs_max_d() { return kSolveRegsMaxD; }

template <int D>
static cudaError_t launch_solve_regs(int L, int threads, int smem,
                                    cudaStream_t s, const float* A,
                                    const float* b, const float* cnt,
                                    const int* feats, const float* leaf_const,
                                    float lam, float* value, float* coeff,
                                    uint8_t* fitted) {
  if (threads != kSolveRegsThreads || smem != 0) return cudaErrorInvalidValue;
  const long long lanes = (long long)L * solve_lanes(D);
  solve_regs_kernel<D>
      <<<(int)((lanes + threads - 1) / threads), threads, 0, s>>>(
          A, b, cnt, feats, leaf_const, lam, L, value, coeff, fitted);
  return cudaGetLastError();
}

template <bool kShared, int R>
static cudaError_t launch_solve_block(int L, int k, int threads, size_t smem,
                                     cudaStream_t s, const float* A,
                                     const float* b, const float* cnt,
                                     const int* feats,
                                     const float* leaf_const, float lam,
                                     float* sys, float* value, float* coeff,
                                     uint8_t* fitted) {
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        solve_block_kernel<kShared, R>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  solve_block_kernel<kShared, R><<<L, threads, smem, s>>>(
      A, b, cnt, feats, leaf_const, lam, k, sys, value, coeff, fitted);
  return cudaGetLastError();
}

// A [L, d, d], b [L, d], cnt [L] f32; feats [L, k] i32; leaf_const [L]
// f32; the plan of ops/linear.py solve_plan: mode (0 registers, 1 a
// block a leaf), threads and dynamic shared bytes; sys: L x d x ((d + 1)
// | 1) f32 of scratch where the block mode's system does not fit in
// shared memory, else null; value [L], coeff [L, k] f32 and fitted [L]
// (one byte, 0 or 1: a torch.bool tensor) out.
extern "C" int lgbt_linear_solve(const float* A, const float* b,
                                 const float* cnt, const int* feats,
                                 const float* leaf_const, float lam, int L,
                                 int k, int mode, int threads, int smem,
                                 float* sys, float* value, float* coeff,
                                 uint8_t* fitted, void* stream) {
  if (L <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  const int d = k + 1;
  if (k < 1 || threads < 32 || threads % 32 || smem < 0)
    return (int)cudaErrorInvalidValue;
  if (mode == 0) {
    cudaError_t err = cudaErrorInvalidValue;
#define LGBT_SOLVE_D(DD)                                                  \
  case DD:                                                                \
    err = launch_solve_regs<DD>(L, threads, smem, s, A, b, cnt, feats,    \
                                leaf_const, lam, value, coeff, fitted);   \
    break;
    switch (d) {
      LGBT_SOLVE_D(2)
      LGBT_SOLVE_D(3)
      LGBT_SOLVE_D(4)
      LGBT_SOLVE_D(5)
      LGBT_SOLVE_D(6)
      LGBT_SOLVE_D(7)
      LGBT_SOLVE_D(8)
      LGBT_SOLVE_D(9)
      LGBT_SOLVE_D(10)
      LGBT_SOLVE_D(11)
      LGBT_SOLVE_D(12)
      LGBT_SOLVE_D(13)
      LGBT_SOLVE_D(14)
      LGBT_SOLVE_D(15)
      LGBT_SOLVE_D(16)
      default:
        break;
    }
#undef LGBT_SOLVE_D
    static_assert(kSolveRegsMaxD == 16, "the cases run to kSolveRegsMaxD");
    return (int)err;
  }
  if (mode != 1 || threads < 128 || threads > kSolveMaxThreads ||
      d > 32 * 128)
    return (int)cudaErrorInvalidValue;
  const size_t system = (size_t)d * ((d + 1) | 1) * sizeof(float);
  const size_t buffers = (size_t)4 * d * sizeof(float);
  if (smem != (int)(buffers + (sys == nullptr ? system : 0)))
    return (int)cudaErrorInvalidValue;
  cudaError_t err;
#define LGBT_SOLVE_BLOCK(SH, RR)                                          \
  err = launch_solve_block<SH, RR>(L, k, threads, smem, s, A, b, cnt,     \
                                   feats, leaf_const, lam, sys, value,    \
                                   coeff, fitted)
  if (sys == nullptr) {
    if (d <= 32) LGBT_SOLVE_BLOCK(true, 1);
    else if (d <= 64) LGBT_SOLVE_BLOCK(true, 2);
    else if (d <= 128) LGBT_SOLVE_BLOCK(true, 4);
    else LGBT_SOLVE_BLOCK(true, 8);
  } else {
    if (d <= 256) LGBT_SOLVE_BLOCK(false, 8);
    else if (d <= 1024) LGBT_SOLVE_BLOCK(false, 32);
    else LGBT_SOLVE_BLOCK(false, 128);
  }
#undef LGBT_SOLVE_BLOCK
  return (int)err;
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
