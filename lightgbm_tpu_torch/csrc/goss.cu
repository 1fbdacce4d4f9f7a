// Kernels GT (goss_threshold) and GW (goss_weights) of
// lightgbm_tpu_torch: GOSS's row weights, built for sm_90a by
// ops/_build.py (with -fmad=false) and called through ctypes from
// ops/goss.py.
//
// Replace lightgbm_tpu/boosting/goss.py _goss_impl (:59), which takes
// mag = |g*h| per row (under XLA: subnormal inputs and products flushed
// to zero, as `magnitude` does here), its top_k-th largest value from a
// device sort (thresh = -sort(-mag)[top_k - 1]), and weighs a row 1 if
// mag >= thresh, else (n - top_k) / other_k if its threefry uniform (one
// (n,) draw of fold_in(PRNGKey(bagging_seed), iter)) is below other_k /
// (n - top_k), else 0.
//
// GT: the threshold by a radix select on the f32 bits, no sort, in one
// cooperative launch (gt_select_kernel). mag >= 0 (fabs clears the
// sign), so its bits order as unsigned ints; the select key is bits + 1,
// and 0 for a NaN, which the JAX sort puts after every number. Three
// passes of 11, 11 and 10-bit digits, most significant first. The first
// computes mag once, writes it for GW, and keeps each thread's keys in
// registers (a block of 1,024 threads an SM, kGtKeys keys a thread:
// 2,000,000 rows fit the co-resident grid; rows past that are read back
// from mag each pass). Each pass counts the digit of the keys that match
// the prefix chosen so far into a shared histogram, then into 2,048
// device words with integer atomics; a grid barrier; then
// every block reads the counts and picks the digit itself, where the
// running count from the top reaches the remaining k (a suffix scan over
// the block's threads), so no one-block pick launch sits between the
// passes. Integer counts do not depend on the order of the adds, so the
// threshold has the same bits every run, and it is exactly the top_k-th
// largest key: -sort(-mag)[top_k - 1]. The prefix and the remaining k
// live in every block's registers; the threshold stays on the card.
//
// The three count buffers need no memset: a launch finds the first two
// zero and leaves them so. Block 0 zeroes the third before the first
// barrier (it is first added to after the second), the first once every
// block has read it (after the second barrier), and the second after the
// last. The barrier word counts generations and needs no reset either.
// So a scratch zeroed once (ops/goss.py keeps one a device and stream)
// serves every call, and GT is one launch where it was a memset and
// eight launches. Blocks of 512 threads, two an SM, and a warp's equal
// digits added once (__match_any_sync) timed slower on the card (PERF.md,
// PR 18): shared-memory atomics on one word cost less than the match.

// GW: one thread a row, the weight from mag, the threshold, and M's
// threefry draw (threefry.cuh); rest_p and multiply come as f32, as
// JAX's weak-typed Python floats meet its f32 arrays.
//
// Bound on an H100 SXM (3.35 TB/s): the function reads g and h (8 bytes
// a row) and writes w (4): 24 MB at 2,000,000 rows, 0.0072 ms. Split
// between the two without the intermediate mag: GT reads g and h
// (0.0048 ms), GW writes w (0.0024 ms) and draws a threefry uniform a
// row (80 operations, 0.0048 ms at 33.5e12 a second). GT also writes mag
// (4 bytes a row) and reads nothing twice: 12 bytes a row, 0.0072 ms;
// its three grid barriers and picks, a few microseconds each, are not
// in the bound.

#include <cuda_runtime.h>
#include <stdint.h>

#include "threefry.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kGtThreads = 1024;
// keys a thread keeps in registers across the passes
constexpr int kGtKeys = 16;
constexpr int kBins = 2048;
constexpr int kPer = kBins / kGtThreads;   // bins a thread picks over
constexpr int kPasses = 3;
// scratch (32-bit words): the barrier's two, then a count buffer a pass
constexpr int kScratchHead = 2;

constexpr float kF32Tiny = 1.17549435e-38f;  // the smallest normal f32

__device__ __forceinline__ float flush(float v) {
  return fabsf(v) < kF32Tiny ? 0.f : v;
}

// |g*h| as XLA computes it (ops/goss.py goss_magnitude): subnormal
// inputs read as zero, a subnormal product written as zero, a NaN as the
// quiet NaN 0x7FC00000
__device__ __forceinline__ float magnitude(float g, float h) {
  const float m = fabsf(__fmul_rn(flush(g), flush(h)));
  return isnan(m) ? __uint_as_float(0x7FC00000u) : (m < kF32Tiny ? 0.f : m);
}

// the select key of a mag: its bits + 1, 0 for a NaN
__device__ __forceinline__ uint32_t select_key(float m) {
  return isnan(m) ? 0u : __float_as_uint(m) + 1u;
}

// pass p's digit is the key's bits from digit_shift(p) up to the last
// pass's shift (or the top): 31-21, 20-10, 9-0
__device__ __forceinline__ int digit_shift(int pass) {
  return pass == 0 ? 21 : (pass == 1 ? 10 : 0);
}

// whether key's digits above pass p's equal the prefix's
__device__ __forceinline__ bool matches(uint32_t key, uint32_t prefix,
                                        int pass) {
  return pass == 0 || (key >> digit_shift(pass - 1)) ==
                          (prefix >> digit_shift(pass - 1));
}

// Every block of the (cooperative, so co-resident) grid waits here until
// all have arrived. bar: generation << 32 | arrivals; the last to arrive
// sets the arrivals back to 0 and moves the generation on in one add, so
// the word needs no reset between launches.
__device__ __forceinline__ void grid_barrier(unsigned long long* bar) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    const unsigned long long old = atomicAdd(bar, 1ull);
    if ((unsigned)old == gridDim.x - 1) {
      atomicAdd(bar, (1ull << 32) - gridDim.x);
    } else {
      volatile unsigned long long* word = bar;
      while ((*word >> 32) == (old >> 32)) __nanosleep(32);
    }
    __threadfence();
  }
  __syncthreads();
}

__device__ __forceinline__ void zero_counts(uint32_t* c) {
  for (int d = threadIdx.x; d < kBins; d += kGtThreads) c[d] = 0u;
}

__global__ void __launch_bounds__(kGtThreads, 1)
gt_select_kernel(const float* __restrict__ grad,
                 const float* __restrict__ hess, float* __restrict__ mag,
                 int n, int top_k, uint32_t* __restrict__ counts,
                 unsigned long long* bar, float* __restrict__ thresh) {
  __shared__ uint32_t hist[kBins];
  __shared__ uint32_t warp_total[kGtThreads / 32];
  __shared__ uint32_t pick[2];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long stride = (long long)gridDim.x * kGtThreads;
  const long long tid = (long long)blockIdx.x * kGtThreads + threadIdx.x;
  uint32_t key[kGtKeys];
#pragma unroll
  for (int i = 0; i < kGtKeys; ++i) {
    const long long r = tid + i * stride;
    key[i] = 0u;
    if (r < n) {
      const float m = magnitude(__ldg(grad + r), __ldg(hess + r));
      mag[r] = m;
      key[i] = select_key(m);
    }
  }
  uint32_t prefix = 0u, k = (uint32_t)top_k;
  for (int pass = 0; pass < kPasses; ++pass) {
    const int shift = digit_shift(pass);
    for (int d = threadIdx.x; d < kBins; d += kGtThreads) hist[d] = 0u;
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kGtKeys; ++i) {
      const bool take = tid + i * stride < n && matches(key[i], prefix, pass);
      if (take) atomicAdd(&hist[(key[i] >> shift) & (kBins - 1)], 1u);
    }
    for (long long r = tid + kGtKeys * stride; r < n; r += stride) {
      uint32_t kr;
      if (pass == 0) {
        const float m = magnitude(__ldg(grad + r), __ldg(hess + r));
        mag[r] = m;
        kr = select_key(m);
      } else {
        kr = select_key(mag[r]);
      }
      if (matches(kr, prefix, pass))
        atomicAdd(&hist[(kr >> shift) & (kBins - 1)], 1u);
    }
    __syncthreads();
    uint32_t* c = counts + pass * kBins;
    for (int d = threadIdx.x; d < kBins; d += kGtThreads) {
      if (hist[d]) atomicAdd(c + d, hist[d]);
    }
    if (blockIdx.x == 0 && pass == 0) zero_counts(counts + 2 * kBins);
    if (blockIdx.x == 0 && pass == 2) zero_counts(counts);
    grid_barrier(bar);
    // the digit where the count from the top reaches k: thread t holds
    // bins kPer t .. kPer t + kPer - 1, `above` the count in the bins
    // above them
    uint32_t cnt[kPer], own = 0u;
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      cnt[j] = __ldcg(c + kPer * threadIdx.x + j);
      own += cnt[j];
    }
    uint32_t incl = own;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const uint32_t v = __shfl_down_sync(~0u, incl, o);
      if (lane + o < 32) incl += v;
    }
    if (lane == 0) warp_total[warp] = incl;
    __syncthreads();
    uint32_t above = incl - own;
    for (int w = warp + 1; w < kGtThreads / 32; ++w) above += warp_total[w];
    if (above < k && above + own >= k) {
      uint32_t run = above;
      for (int j = kPer - 1; j >= 0; --j) {
        if (run + cnt[j] >= k) {
          pick[0] = kPer * threadIdx.x + j;
          pick[1] = k - run;
          break;
        }
        run += cnt[j];
      }
    }
    __syncthreads();
    prefix |= pick[0] << shift;
    k = pick[1];
  }
  if (blockIdx.x == 0) {
    zero_counts(counts + kBins);
    if (threadIdx.x == 0) {
      thresh[0] = prefix == 0u ? __uint_as_float(0x7FC00000u)
                               : __uint_as_float(prefix - 1u);
    }
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

// The most co-resident blocks of gt_select_kernel on the current card
// (0 when the card cannot launch it cooperatively), found once.
int resident_blocks() {
  static int blocks = -1;
  if (blocks < 0) {
    int dev = 0, sms = 0, per_sm = 0, coop = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess ||
        cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev) !=
            cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, gt_select_kernel, kGtThreads, 0) != cudaSuccess) {
      return 0;
    }
    blocks = coop ? sms * per_sm : 0;
  }
  return blocks;
}

}  // namespace

// The scratch words GT takes: the barrier's two, then three count
// buffers of 2,048; zeroed once before the first call.
extern "C" int lgbt_goss_scratch_ints() {
  return kScratchHead + kPasses * kBins;
}

// grad, hess [n] f32; 1 <= top_k <= n; mag [n] f32 (written); scratch:
// lgbt_goss_scratch_ints() words, zero before the first call and left
// so by each (one scratch a stream); thresh [1] f32: the top_k-th
// largest |g*h|. One cooperative launch; returns its error.
extern "C" int lgbt_goss_threshold(const float* grad, const float* hess,
                                   int n, int top_k, float* mag,
                                   uint32_t* scratch, float* thresh,
                                   void* stream) {
  const int cap = resident_blocks();
  if (cap < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  const int want = (n + kGtThreads - 1) / kGtThreads;
  int blocks = want < cap ? want : cap;
  if (blocks < 1) blocks = 1;
  unsigned long long* bar = reinterpret_cast<unsigned long long*>(scratch);
  uint32_t* counts = scratch + kScratchHead;
  void* args[] = {&grad, &hess, &mag, &n, &top_k, &counts, &bar, &thresh};
  return (int)cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(gt_select_kernel), blocks, kGtThreads,
      args, 0, (cudaStream_t)stream);
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
