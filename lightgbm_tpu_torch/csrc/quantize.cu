// Kernels M (bagging_mask) and Q (quantize_gradients) of
// lightgbm_tpu_torch, built for sm_90a by ops/_build.py (with
// -fmad=false) and called through ctypes from ops/rng.py and
// ops/histogram.py.
//
// Both draw JAX's threefry2x32 stream (jax_threefry_partitionable, the
// default of JAX 0.9): element i of jax.random.uniform(key, (n,)) hashes
// its own index, (o0, o1) = threefry2x32(key, (i >> 32, i & 0xffffffff)),
// bits = o0 ^ o1, u = max(0, bitcast_f32((bits >> 9) | 0x3F800000) - 1).
// So every thread draws its own row's number in registers; the result
// equals the plain version's (ops/rng.py) and JAX's bit for bit.
//
// M replaces lightgbm_tpu/boosting/gbdt.py _bagging_mask_impl (:311):
// out[i] = u_i < fraction as f32 0/1, one thread a row. Bound on an H100
// SXM: 4 bytes written a row (8 MB at 2,000,000 rows, 0.0024 ms at
// 3.35 TB/s) against ~130 integer instructions a row for the 20 rounds
// and key injections (2.6e8 at 2,000,000 rows, 0.0078 ms at 33.5e12
// instructions/s): operations bound it.
//
// Q replaces lightgbm_tpu/ops/histogram.py quantize_gradients (:127)
// with stochastic_round (:105), in two launches:
//  (a) the maxima of |grad*w| and |hess*w|: per-block maxima by warp
//      shuffles, then atomicMax on the bit patterns, which order like
//      the non-negative floats they are; a maximum does not depend on
//      the order, so the bits are the same every run;
//  (b) one thread a row: scale = max(m, 1e-30) / qmax, x = gw / scale
//      (IEEE division), q = floor(x) + (u < x - floor(x)) clipped to
//      +-qmax, the JAX expressions operation for operation; with
//      hess_const q_h = qmax * w01 and no draw. It writes the codes as
//      int16 pairs, w01 as f32 and the [3] scale, with no host read.
// Bound: 12 bytes read a row in each launch and 8 written by (b) (64 MB
// at 2,000,000 rows, 0.019 ms) against two threefry hashes a row in (b)
// (~260 instructions, 5.2e8, 0.016 ms): about even.

#include <cuda_runtime.h>
#include <stdint.h>

#include "threefry.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void bag_kernel(uint32_t k0, uint32_t k1, float fraction, int n,
                           float* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) out[i] = uniform_at(k0, k1, i) < fraction ? 1.f : 0.f;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_down_sync(~0u, v, o));
  return v;
}

// (a): maxbits[0] = bits of max |grad*w|, maxbits[1] of max |hess*w|;
// maxbits starts at 0 (the bits of +0.0)
__global__ void absmax_kernel(const float* __restrict__ grad,
                              const float* __restrict__ hess,
                              const float* __restrict__ w, int n,
                              unsigned int* __restrict__ maxbits) {
  __shared__ float sg[kThreads / 32], sh[kThreads / 32];
  float mg = 0.f, mh = 0.f;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += gridDim.x * blockDim.x) {
    const float wi = w[i];
    mg = fmaxf(mg, fabsf(__fmul_rn(grad[i], wi)));
    mh = fmaxf(mh, fabsf(__fmul_rn(hess[i], wi)));
  }
  mg = warp_max(mg);
  mh = warp_max(mh);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) {
    sg[warp] = mg;
    sh[warp] = mh;
  }
  __syncthreads();
  if (warp == 0) {
    mg = lane < kThreads / 32 ? sg[lane] : 0.f;
    mh = lane < kThreads / 32 ? sh[lane] : 0.f;
    mg = warp_max(mg);
    mh = warp_max(mh);
    if (lane == 0) {
      atomicMax(maxbits, __float_as_uint(mg));
      atomicMax(maxbits + 1, __float_as_uint(mh));
    }
  }
}

__device__ __forceinline__ float sround_clip(float x, float u, float qm) {
  const float f = floorf(x);
  const float q = __fadd_rn(f, u < __fsub_rn(x, f) ? 1.f : 0.f);
  return fminf(fmaxf(q, -qm), qm);
}

// (b)
__global__ void quantize_kernel(const float* __restrict__ grad,
                                const float* __restrict__ hess,
                                const float* __restrict__ w, int n, int qmax,
                                uint32_t kg0, uint32_t kg1, uint32_t kh0,
                                uint32_t kh1, int hess_const,
                                const unsigned int* __restrict__ maxbits,
                                short2* __restrict__ codes,
                                float* __restrict__ w01,
                                float* __restrict__ qscale) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const float qm = (float)qmax;
  const float g_scale = __fdiv_rn(fmaxf(__uint_as_float(maxbits[0]), 1e-30f),
                                  qm);
  const float h_scale = __fdiv_rn(fmaxf(__uint_as_float(maxbits[1]), 1e-30f),
                                  qm);
  if (i == 0) {
    qscale[0] = g_scale;
    qscale[1] = h_scale;
    qscale[2] = 1.f;
  }
  if (i >= n) return;
  const float wi = w[i];
  const float in_bag = wi > 0.f ? 1.f : 0.f;
  const float qg = sround_clip(__fdiv_rn(__fmul_rn(grad[i], wi), g_scale),
                               uniform_at(kg0, kg1, i), qm);
  const float qh = hess_const
      ? __fmul_rn(qm, in_bag)
      : sround_clip(__fdiv_rn(__fmul_rn(hess[i], wi), h_scale),
                    uniform_at(kh0, kh1, i), qm);
  codes[i] = make_short2((short)qg, (short)qh);
  w01[i] = in_bag;
}

}  // namespace

// out[i] = uniform(key, i) < fraction, f32 0/1, for i < n. Returns
// cudaGetLastError().
extern "C" int lgbt_bagging_mask(uint32_t k0, uint32_t k1, float fraction,
                                 int n, float* out, void* stream) {
  if (n <= 0) return 0;
  bag_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0,
               (cudaStream_t)stream>>>(k0, k1, fraction, n, out);
  return (int)cudaGetLastError();
}

// grad, hess, w [n] f32; scratch: 2 words; codes [n] short2 (q_g, q_h);
// w01 [n] f32; qscale [3] f32. Returns cudaGetLastError().
extern "C" int lgbt_quantize_gradients(
    const float* grad, const float* hess, const float* w, int n, int qmax,
    uint32_t kg0, uint32_t kg1, uint32_t kh0, uint32_t kh1, int hess_const,
    unsigned int* scratch, short2* codes, float* w01, float* qscale,
    void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = cudaMemsetAsync(scratch, 0, 2 * sizeof(unsigned int), s);
  if (err != cudaSuccess) return (int)err;
  int blocks = (n + kThreads - 1) / kThreads;
  blocks = blocks < 1 ? 1 : (blocks > 1024 ? 1024 : blocks);
  absmax_kernel<<<blocks, kThreads, 0, s>>>(grad, hess, w, n, scratch);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int rows_blocks = n > 0 ? (n + kThreads - 1) / kThreads : 1;
  quantize_kernel<<<rows_blocks, kThreads, 0, s>>>(
      grad, hess, w, n, qmax, kg0, kg1, kh0, kh1, hess_const, scratch, codes,
      w01, qscale);
  return (int)cudaGetLastError();
}

extern "C" const char* lgbt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
