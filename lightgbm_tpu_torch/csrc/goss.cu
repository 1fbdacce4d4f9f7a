// Kernels GT (goss_threshold) and GW (goss_weights) of
// lightgbm_tpu_torch: GOSS's row weights, built for sm_90a by
// ops/_build.py (with -fmad=false) and called through ctypes from
// ops/goss.py.
//
// Replace lightgbm_tpu/boosting/goss.py _goss_impl (:59), which takes
// mag = |g*h| per row, its top_k-th largest value from a device sort
// (thresh = -sort(-mag)[top_k - 1]), and weighs a row 1 if mag >=
// thresh, else (n - top_k) / other_k if its threefry uniform (one (n,)
// draw of fold_in(PRNGKey(bagging_seed), iter)) is below other_k / (n -
// top_k), else 0.
//
// GT: the threshold by a radix select on the f32 bits, no sort. mag >= 0
// (fabs clears the sign), so its bits order as unsigned ints; the select
// key is bits + 1, and 0 for a NaN, which the JAX sort puts after every
// number. Four passes of 8-bit digits, most significant first: each
// counts the digit of the keys that match the prefix chosen so far
// (shared-memory integer histograms, then integer atomics into 256
// device words), and one block picks the digit where the running count
// from the top reaches the remaining k. Integer counts do not depend on
// the order of the adds, so the threshold has the same bits every run,
// and it is exactly the top_k-th largest key: -sort(-mag)[top_k - 1].
// The first pass also writes mag, which the later passes and GW read.
// The prefix, the remaining k and the threshold stay on the card: no
// host read.
//
// GW: one thread a row, the weight from mag, the threshold, and M's
// threefry draw (threefry.cuh); rest_p and multiply come as f32, as
// JAX's weak-typed Python floats meet its f32 arrays.
//
// Bound on an H100 SXM (3.35 TB/s): the function reads g and h (8 bytes
// a row) and writes w (4): 24 MB at 2,000,000 rows, 0.0072 ms. Split
// between the two without the intermediate mag: GT reads g and h
// (0.0048 ms), GW writes w (0.0024 ms) and draws a threefry uniform a
// row (80 operations, 0.0048 ms at 33.5e12 a second). The
// kernels move 32 bytes a row (g, h and mag in the first pass, mag in
// three more and in GW, w) over 9 launches; the per-pass launches and
// the one-block digit picks, not the bytes, set their time at this size.

#include <cuda_runtime.h>
#include <stdint.h>

#include "threefry.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kDigits = 256;

// the select key of a mag: its bits + 1, 0 for a NaN
__device__ __forceinline__ uint32_t select_key(float m) {
  return isnan(m) ? 0u : __float_as_uint(m) + 1u;
}

// state (device words): [0] the key prefix chosen so far, [1] the
// remaining k; pass 0 starts from prefix 0 and k = top_k.
// pass p of the select: count digit p (bits 24 - 8p .. 31 - 8p) of the
// keys whose higher digits equal the prefix's; pass 0 computes mag
__global__ void gt_count_kernel(const float* __restrict__ grad,
                                const float* __restrict__ hess,
                                float* __restrict__ mag, int n, int pass,
                                const uint32_t* __restrict__ state,
                                uint32_t* __restrict__ counts) {
  __shared__ uint32_t hist[kDigits];
  for (int d = threadIdx.x; d < kDigits; d += blockDim.x) hist[d] = 0u;
  __syncthreads();
  const int shift = 24 - 8 * pass;
  const uint32_t prefix = pass == 0 ? 0u : state[0];
  for (int r = blockIdx.x * blockDim.x + threadIdx.x; r < n;
       r += gridDim.x * blockDim.x) {
    float m;
    if (pass == 0) {
      m = fabsf(__fmul_rn(__ldg(grad + r), __ldg(hess + r)));
      mag[r] = m;
    } else {
      m = mag[r];
    }
    const uint32_t key = select_key(m);
    if (pass == 0 || ((key ^ prefix) >> (shift + 8)) == 0u)
      atomicAdd(&hist[(key >> shift) & 0xFFu], 1u);
  }
  __syncthreads();
  for (int d = threadIdx.x; d < kDigits; d += blockDim.x) {
    if (hist[d]) atomicAdd(counts + d, hist[d]);
  }
}

// one block: the digit of pass p where the count from the top reaches
// the remaining k; zeroes the counts for the next pass; after the last
// pass writes the threshold
__global__ void gt_pick_kernel(int pass, int top_k,
                               uint32_t* __restrict__ state,
                               uint32_t* __restrict__ counts,
                               float* __restrict__ thresh) {
  __shared__ uint32_t c[kDigits];
  for (int d = threadIdx.x; d < kDigits; d += blockDim.x) {
    c[d] = counts[d];
    counts[d] = 0u;
  }
  __syncthreads();
  if (threadIdx.x != 0) return;
  const int shift = 24 - 8 * pass;
  uint32_t k = pass == 0 ? (uint32_t)top_k : state[1], above = 0u;
  int d = kDigits - 1;
  for (; d > 0; --d) {
    if (above + c[d] >= k) break;
    above += c[d];
  }
  const uint32_t prefix = (pass == 0 ? 0u : state[0]) |
                          ((uint32_t)d << shift);
  state[0] = prefix;
  state[1] = k - above;
  if (pass == 3) {
    thresh[0] = prefix == 0u ? __uint_as_float(0x7FC00000u)
                             : __uint_as_float(prefix - 1u);
  }
}

__global__ void gw_kernel(const float* __restrict__ mag,
                          const float* __restrict__ thresh, int n,
                          uint32_t k0, uint32_t k1, float rest_p,
                          float multiply, float* __restrict__ w) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= n) return;
  const float t = __ldg(thresh);
  w[r] = mag[r] >= t ? 1.f
                     : (uniform_at(k0, k1, r) < rest_p ? multiply : 0.f);
}

int count_blocks(int n) {
  int b = (n + kThreads - 1) / kThreads;
  return b < 1 ? 1 : (b > 132 * 8 ? 132 * 8 : b);
}

}  // namespace

// grad, hess [n] f32; 1 <= top_k <= n; mag [n] f32 (written); work:
// 2 + 256 words; thresh [1] f32: the top_k-th largest |g*h|. Returns
// cudaGetLastError().
extern "C" int lgbt_goss_threshold(const float* grad, const float* hess,
                                   int n, int top_k, float* mag,
                                   uint32_t* work, float* thresh,
                                   void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  uint32_t* state = work;
  uint32_t* counts = work + 2;
  cudaError_t err = cudaMemsetAsync(counts, 0, kDigits * sizeof(uint32_t),
                                    s);
  if (err != cudaSuccess) return (int)err;
  for (int pass = 0; pass < 4; ++pass) {
    gt_count_kernel<<<count_blocks(n), kThreads, 0, s>>>(
        grad, hess, mag, n, pass, state, counts);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    gt_pick_kernel<<<1, kDigits, 0, s>>>(pass, top_k, state, counts,
                                         thresh);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

// mag [n] f32 and thresh [1] f32 from GT; w[r] = 1 if mag[r] >= thresh,
// else multiply if uniform(key, r) < rest_p, else 0. Returns
// cudaGetLastError().
extern "C" int lgbt_goss_weights(const float* mag, const float* thresh,
                                 int n, uint32_t k0, uint32_t k1,
                                 float rest_p, float multiply, float* w,
                                 void* stream) {
  if (n <= 0) return 0;
  gw_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0,
              (cudaStream_t)stream>>>(mag, thresh, n, k0, k1, rest_p,
                                      multiply, w);
  return (int)cudaGetLastError();
}

extern "C" const char* lgbt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
