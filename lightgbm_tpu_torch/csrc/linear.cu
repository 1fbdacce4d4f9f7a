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
// tiles of kTileRows rows (a tile never spans two leaves). A block takes
// one tile and one slice of kEntriesPerBlock of the E = d(d+1)/2 + d + 1
// sums (the upper triangle of A, then b, then cnt): its threads first
// gather a chunk of rows' z, w*h, w*g and live flag into shared memory
// (one row a thread), then each thread owns up to kEntriesPerThread
// sums of its slice and adds the chunk's rows into them in row order.
// A leaf needs ceil(E / kEntriesPerBlock) slices (1 up to k = 42, 3 at
// k = 64), the grid's second dimension; every slice gathers the same
// rows again, and each sum keeps its own row order, so its bits do not
// depend on how the sums are sliced. Each term is formed in f32 as the JAX package forms
// it (z_i * z_j, then times w*h) and added exactly in f64; a second
// kernel adds each leaf's tile sums in tile order and rounds once to
// f32. Fixed order throughout: the same bits every launch, no atomics.
// Bound on an H100 (3.35 TB/s): each row of the leaves reads its perm
// entry (4 B), g, h and w (12 B) and its k gathered values (4 B each,
// one 32-byte sector each in practice); at 2,000,000 rows and k = 5,
// 36 B a row, 72 MB, 0.021 ms. The tile sums and the outputs are KBs.
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
// shrunk tables) and rollback (s = -1). One thread a row. Bound: leaf
// id, score in and out and k gathered values a row (12 + 4k bytes).
//
// Everything is f32 (f64 sums in LF) with -fmad=false, so each kernel is
// bitwise equal to its plain version in ops/linear.py, except LF's f64
// sums, which may round differently in the last f32 bit.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "linear_term.cuh"

namespace {

using lgbt_linear::flush_subnormal;
using lgbt_linear::linear_term;

constexpr int kTileRows = 1024;
constexpr int kThreadsLF = 256;
constexpr int kEntriesPerThread = 4;
constexpr int kEntriesPerBlock = kThreadsLF * kEntriesPerThread;
// shared memory a tile block may take for its gathered chunk: it holds
// chunk x (d + 3) floats, 256 rows up to k = 92, fewer beyond
constexpr int kChunkBytes = 96 * 1024;
constexpr int kThreadsLA = 256;
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

// tiles [T, 3] = (leaf, first position in perm, rows)
__global__ void __launch_bounds__(kThreadsLF) normal_eq_tile_kernel(
    const float* __restrict__ x, int F, const float* __restrict__ grad,
    const float* __restrict__ hess, const float* __restrict__ weight,
    const int* __restrict__ perm, const int* __restrict__ tiles,
    const int* __restrict__ feats, int k, int chunk_rows,
    double* __restrict__ part) {
  extern __shared__ float smem[];
  const int d = k + 1;
  const int n_a = d * (d + 1) / 2;
  const int E = n_a + d + 1;
  float* z = smem;                          // [chunk_rows, d]
  float* wh = z + chunk_rows * d;           // [chunk_rows]
  float* wg = wh + chunk_rows;
  float* live = wg + chunk_rows;
  const int t = blockIdx.x;
  const int e0 = blockIdx.y * kEntriesPerBlock;  // this block's slice
  const int leaf = tiles[t * 3], first = tiles[t * 3 + 1],
            rows = tiles[t * 3 + 2];
  const int* lf = feats + (size_t)leaf * k;

  double acc[kEntriesPerThread];
  int ei[kEntriesPerThread], ej[kEntriesPerThread];
#pragma unroll
  for (int u = 0; u < kEntriesPerThread; ++u) {
    acc[u] = 0.0;
    const int e = e0 + threadIdx.x + u * kThreadsLF;
    ei[u] = ej[u] = -1;
    if (e < n_a) entry_of(e, d, ei[u], ej[u]);
  }
  for (int c0 = 0; c0 < rows; c0 += chunk_rows) {
    const int m = min(chunk_rows, rows - c0);
    if (threadIdx.x < m) {
      const int i = threadIdx.x;
      const int r = __ldg(perm + first + c0 + i);
      const float* xr = x + (size_t)r * F;
      bool ok = true;
      for (int j = 0; j < k; ++j) {
        const int f = __ldg(lf + j);
        float v = 0.f;
        if (f >= 0) {
          v = __ldg(xr + f);
          if (!isfinite(v)) {
            ok = false;
            v = 0.f;
          }
          v = flush_subnormal(v);
        }
        z[i * d + j] = v;
      }
      z[i * d + k] = 1.f;
      const float w = ok ? __ldg(weight + r) : 0.f;
      wh[i] = __fmul_rn(w, __ldg(hess + r));
      wg[i] = __fmul_rn(w, __ldg(grad + r));
      live[i] = w > 0.f ? 1.f : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int u = 0; u < kEntriesPerThread; ++u) {
      const int e = e0 + threadIdx.x + u * kThreadsLF;
      if (e >= E) continue;
      double s = acc[u];
      if (e < n_a) {
        const int a = ei[u], b = ej[u];
        for (int i = 0; i < m; ++i) {
          const float zz = __fmul_rn(z[i * d + a], z[i * d + b]);
          s += (double)wh[i] * (double)zz;
        }
      } else if (e < n_a + d) {
        const int a = e - n_a;
        for (int i = 0; i < m; ++i) s += (double)wg[i] * (double)z[i * d + a];
      } else {
        for (int i = 0; i < m; ++i) s += (double)live[i];
      }
      acc[u] = s;
    }
    __syncthreads();
  }
#pragma unroll
  for (int u = 0; u < kEntriesPerThread; ++u) {
    const int e = e0 + threadIdx.x + u * kThreadsLF;
    if (e < E) part[(size_t)t * E + e] = acc[u];
  }
}

// One block per leaf: its tiles tile_first[l] .. + tile_count[l] added in
// order, rounded to f32; A written symmetric.
__global__ void normal_eq_reduce_kernel(const double* __restrict__ part,
                                        const int* __restrict__ tile_first,
                                        const int* __restrict__ tile_count,
                                        int k, float* __restrict__ A,
                                        float* __restrict__ b,
                                        float* __restrict__ cnt) {
  const int l = blockIdx.x;
  const int d = k + 1;
  const int n_a = d * (d + 1) / 2;
  const int E = n_a + d + 1;
  const int t0 = tile_first[l], tc = tile_count[l];
  for (int e = threadIdx.x; e < E; e += blockDim.x) {
    double s = 0.0;
    for (int t = t0; t < t0 + tc; ++t) s += part[(size_t)t * E + e];
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

__global__ void __launch_bounds__(kThreadsLA) addend_kernel(
    const float* __restrict__ x, int n, int F,
    const int* __restrict__ leaf_id, const float* __restrict__ value,
    const float* __restrict__ coeff, const int* __restrict__ feats, int k,
    float scale, float* __restrict__ score) {
  const int r = blockIdx.x * kThreadsLA + threadIdx.x;
  if (r >= n) return;
  const int l = __ldg(leaf_id + r);
  bool ok;
  const float lin = linear_term(x + (size_t)r * F, coeff + (size_t)l * k,
                                feats + (size_t)l * k, k, ok);
  const float t = __fadd_rn(__ldg(value + l), ok ? lin : 0.f);
  score[r] = __fadd_rn(score[r], __fmul_rn(scale, t));
}

}  // namespace

// The entry counts and shared-memory sizes the wrapper allocates for.
extern "C" int lgbt_linear_tile_rows() { return kTileRows; }

// x [N, F] f32; grad/hess/weight [N] f32; perm [N] i32; tiles [T, 3] i32
// (leaf, first perm position, rows); tile_first/tile_count [L] i32;
// feats [L, k] i32; part: T * E doubles of scratch; A [L, d, d], b [L,
// d], cnt [L] f32, written for every leaf.
extern "C" int lgbt_linear_normal_eq(
    const float* x, int F, const float* grad, const float* hess,
    const float* weight, const int* perm, const int* tiles, int T,
    const int* tile_first, const int* tile_count, int L, const int* feats,
    int k, void* part, float* A, float* b, float* cnt, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int d = k + 1;
  const int E = d * (d + 1) / 2 + d + 1;
  const int chunk_rows =
      min(kThreadsLF, kChunkBytes / ((d + 3) * (int)sizeof(float)));
  if (chunk_rows < 1) return (int)cudaErrorInvalidValue;
  if (T > 0) {
    const size_t smem = ((size_t)chunk_rows * (d + 3)) * sizeof(float);
    if (smem > 48 * 1024) {
      cudaError_t err = cudaFuncSetAttribute(
          normal_eq_tile_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          (int)smem);
      if (err != cudaSuccess) return (int)err;
    }
    const dim3 grid(T, (E + kEntriesPerBlock - 1) / kEntriesPerBlock);
    normal_eq_tile_kernel<<<grid, kThreadsLF, smem, s>>>(
        x, F, grad, hess, weight, perm, tiles, feats, k, chunk_rows,
        (double*)part);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  normal_eq_reduce_kernel<<<L, 128, 0, s>>>((const double*)part, tile_first,
                                            tile_count, k, A, b, cnt);
  return (int)cudaGetLastError();
}

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
// k] i32 columns of x; score [n] f32, added to in place.
extern "C" int lgbt_linear_addend(const float* x, int n, int F,
                                  const int* leaf_id, const float* value,
                                  const float* coeff, const int* feats,
                                  int k, float scale, float* score,
                                  void* stream) {
  if (n <= 0) return 0;
  addend_kernel<<<(n + kThreadsLA - 1) / kThreadsLA, kThreadsLA, 0,
                  (cudaStream_t)stream>>>(x, n, F, leaf_id, value, coeff,
                                          feats, k, scale, score);
  return (int)cudaGetLastError();
}

extern "C" const char* lgbt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
