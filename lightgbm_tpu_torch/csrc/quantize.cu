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
// with stochastic_round (:105), in one cooperative launch
// (quantize_kernel) where it was a memset and two launches. A thread
// takes groups of kQGroup consecutive rows, groups t, t + T, t + 2T, ...
// of the grid's T threads (ops/histogram.py quantize_plan), by 16-byte
// loads and stores where grad, hess, w, the codes and w01 all start on
// 16 bytes, else a row at a time (a row of a [2, n] tensor, as the
// lambdarank gradients come, starts 4n bytes in):
//  (1) it reads each of its groups once: gw = grad*w, hw = hess*w, w01
//      written. Its first group's products and both threefry uniforms
//      stay in registers across the barrier, drawn while that group's
//      rows arrive (a draw depends only on the key and the row, not on
//      the scale). The maxima of |gw| and |hw| are taken on their
//      unsigned bit patterns, which order like the non-negative floats
//      they are, with a NaN above inf: the maximum does not depend on the
//      order, so its bits are the same every run, and a NaN propagates
//      as in jnp.max and the plain version's .max(). Per-block maxima by
//      warp reductions, then one atomicMax a block.
//  (2) a grid barrier; every block reads the two maxima and forms the
//      scales: scale = max(m, 1e-30) / qmax (or, with recip,
//      max(m, 1e-30) * f32(1 / qmax), as XLA computes it in the JAX
//      package's jitted training program), the floor keeping a NaN as
//      jnp.maximum does; x = gw / scale (IEEE division), q = floor(x) +
//      (u < x - floor(x)) clipped to +-qmax, the JAX expressions
//      operation for operation (a NaN x, where the scale or gw is NaN or
//      both are inf, gives -qmax; the plain version leaves that code to
//      its cast); with hess_const q_h = qmax * w01 and no draw. Groups
//      past the first are read again and drawn here. It writes the codes
//      as int16 pairs and the [3] scale, with no host read.
// The maxima need no memset: a scratch of a barrier word and two pairs
// of maxima, zeroed once (ops/histogram.py keeps one a device and
// stream). A launch takes the pair of its barrier generation's parity,
// and block 0 zeroes the other pair, which the launch before used and
// the next one takes.
// Bound on an H100 SXM: 12 bytes read a row and 8 written (40 MB at
// 2,000,000 rows, 0.0119 ms at 3.35 TB/s) against two threefry draws a
// row (~80 integer operations each, 3.2e8, 0.0096 ms at 33.5e12 a
// second). On the card the draws take about as long as the memory
// passes, and the two overlap only in part (PERF.md §6).

#include <cuda_runtime.h>
#include <stdint.h>

#include "threefry.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kQThreads = 1024;  // Q: a block of 1,024 threads an SM
constexpr int kQGroup = 4;       // Q: rows a thread takes at once
constexpr int kQScratchHead = 2; // Q's scratch: the barrier's two words

__global__ void bag_kernel(uint32_t k0, uint32_t k1, float fraction, int n,
                           float* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) out[i] = uniform_at(k0, k1, i) < fraction ? 1.f : 0.f;
}

__device__ __forceinline__ float sround_clip(float x, float u, float qm) {
  const float f = floorf(x);
  const float q = __fadd_rn(f, u < __fsub_rn(x, f) ? 1.f : 0.f);
  return fminf(fmaxf(q, -qm), qm);
}

// The bits of |v|: they order like the float, a NaN's above inf's.
__device__ __forceinline__ unsigned abs_bits(float v) {
  return __float_as_uint(v) & 0x7FFFFFFFu;
}

// max(m, 1e-30) as jnp.maximum takes it: a NaN m stays NaN
__device__ __forceinline__ float scale_floor(float m) {
  return isnan(m) ? m : fmaxf(m, 1e-30f);
}

// Every block of the (cooperative, so co-resident) grid waits here until
// all have arrived. bar: generation << 32 | arrivals; the last to arrive
// sets the arrivals back to 0 and moves the generation on in one add, so
// the word needs no reset between launches (goss.cu's barrier).
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

// q's four rows of p (rows 4q .. 4q + 3; past n as 0): one 16-byte load
// where all four are rows and kVec, else one a row. cg: from L2 (the
// re-read).
template <bool kCg, bool kVec>
__device__ __forceinline__ void load_group(const float* __restrict__ p,
                                           long long q, long long n,
                                           float (&v)[kQGroup]) {
  const long long r0 = kQGroup * q;
  if (kVec && r0 + kQGroup <= n) {
    const float4* p4 = reinterpret_cast<const float4*>(p) + q;
    const float4 t = kCg ? __ldcg(p4) : __ldg(p4);
    v[0] = t.x;
    v[1] = t.y;
    v[2] = t.z;
    v[3] = t.w;
  } else {
#pragma unroll
    for (int j = 0; j < kQGroup; ++j)
      v[j] = r0 + j < n ? (kCg ? __ldcg(p + r0 + j) : __ldg(p + r0 + j)) : 0.f;
  }
}

// the uniforms of a group's rows; a row past n draws row n - 1's, unused
// (no branch among the draws)
__device__ __forceinline__ void draw_group(uint32_t k0, uint32_t k1,
                                           long long q, long long n,
                                           float (&u)[kQGroup]) {
#pragma unroll
  for (int j = 0; j < kQGroup; ++j) {
    const long long r = kQGroup * q + j;
    u[j] = uniform_at(k0, k1, (int)(r < n ? r : n - 1));
  }
}

// a group's codes (ug, uh: the draws, or with hess_const uh = w01) as
// int16 pairs, q_g in the low half: one 16-byte store where all four
// are rows and kVec
template <bool kDrawH, bool kVec>
__device__ __forceinline__ void emit_group(
    long long q, long long n, const float (&gw)[kQGroup],
    const float (&hw)[kQGroup], const float (&ug)[kQGroup],
    const float (&uh)[kQGroup], float g_scale, float h_scale, float qm,
    short2* __restrict__ codes) {
  int c[kQGroup];
#pragma unroll
  for (int j = 0; j < kQGroup; ++j) {
    const float qg = sround_clip(__fdiv_rn(gw[j], g_scale), ug[j], qm);
    const float qh = kDrawH
        ? sround_clip(__fdiv_rn(hw[j], h_scale), uh[j], qm)
        : __fmul_rn(qm, uh[j]);
    c[j] = (int)(unsigned short)(short)qg |
           ((int)(unsigned short)(short)qh << 16);
  }
  const long long r0 = kQGroup * q;
  if (kVec && r0 + kQGroup <= n) {
    reinterpret_cast<int4*>(codes)[q] = make_int4(c[0], c[1], c[2], c[3]);
  } else {
    int* one = reinterpret_cast<int*>(codes) + r0;
    for (int j = 0; j < kQGroup && r0 + j < n; ++j) one[j] = c[j];
  }
}

// a group's rows below n into the maxima of |gw| and |hw|, and its w01
// written: one 16-byte store where all four are rows and kVec
template <bool kVec>
__device__ __forceinline__ void observe_group(
    long long q, long long n, const float (&gw)[kQGroup],
    const float (&hw)[kQGroup], const float (&bag)[kQGroup],
    float* __restrict__ w01, unsigned& mg, unsigned& mh) {
  const long long r0 = kQGroup * q;
#pragma unroll
  for (int j = 0; j < kQGroup; ++j) {
    if (r0 + j < n) {
      mg = max(mg, abs_bits(gw[j]));
      mh = max(mh, abs_bits(hw[j]));
    }
  }
  if (kVec && r0 + kQGroup <= n) {
    reinterpret_cast<float4*>(w01)[q] =
        make_float4(bag[0], bag[1], bag[2], bag[3]);
  } else {
    for (int j = 0; j < kQGroup && r0 + j < n; ++j) w01[r0 + j] = bag[j];
  }
}

// kDrawH: the hessians drawn (else hess_const: q_h = qmax * w01); kVec:
// every array starts on 16 bytes (16-byte loads and stores)
template <bool kDrawH, bool kVec>
__global__ void __launch_bounds__(kQThreads, 1)
quantize_kernel(const float* __restrict__ grad,
                const float* __restrict__ hess, const float* __restrict__ w,
                int n, int qmax, uint32_t kg0, uint32_t kg1, uint32_t kh0,
                uint32_t kh1, int recip,
                uint32_t* __restrict__ scratch, short2* __restrict__ codes,
                float* __restrict__ w01, float* __restrict__ qscale) {
  __shared__ unsigned warp_g[kQThreads / 32], warp_h[kQThreads / 32];
  unsigned long long* bar = reinterpret_cast<unsigned long long*>(scratch);
  // this launch's pair of maxima and the other, by the barrier's parity
  // (no block has arrived yet, so all read the same generation)
  const unsigned gen =
      (unsigned)(*reinterpret_cast<volatile unsigned long long*>(bar) >> 32);
  unsigned* cur = scratch + kQScratchHead + 2 * (gen & 1u);
  unsigned* other = scratch + kQScratchHead + 2 * ((gen + 1u) & 1u);
  const long long step = (long long)gridDim.x * kQThreads;
  const long long tid = (long long)blockIdx.x * kQThreads + threadIdx.x;
  const long long groups = ((long long)n + kQGroup - 1) / kQGroup;

  // (1) the thread's first group: its loads, both draws while they
  // arrive, the products kept; then every further group's products for
  // the maxima and w01
  float gw[kQGroup], hw[kQGroup], ug[kQGroup], uh[kQGroup];
  unsigned mg = 0u, mh = 0u;
  if (tid < groups) {
    float wv[kQGroup];
    load_group<false, kVec>(grad, tid, n, gw);
    load_group<false, kVec>(hess, tid, n, hw);
    load_group<false, kVec>(w, tid, n, wv);
    draw_group(kg0, kg1, tid, n, ug);
    if (kDrawH) draw_group(kh0, kh1, tid, n, uh);
    float bag[kQGroup];
#pragma unroll
    for (int j = 0; j < kQGroup; ++j) {
      gw[j] = __fmul_rn(gw[j], wv[j]);
      hw[j] = __fmul_rn(hw[j], wv[j]);
      bag[j] = wv[j] > 0.f ? 1.f : 0.f;
      if (!kDrawH) uh[j] = bag[j];
    }
    observe_group<kVec>(tid, n, gw, hw, bag, w01, mg, mh);
  }
  for (long long q = tid + step; q < groups; q += step) {
    float gv[kQGroup], hv[kQGroup], wv[kQGroup], bag[kQGroup];
    load_group<false, kVec>(grad, q, n, gv);
    load_group<false, kVec>(hess, q, n, hv);
    load_group<false, kVec>(w, q, n, wv);
#pragma unroll
    for (int j = 0; j < kQGroup; ++j) {
      gv[j] = __fmul_rn(gv[j], wv[j]);
      hv[j] = __fmul_rn(hv[j], wv[j]);
      bag[j] = wv[j] > 0.f ? 1.f : 0.f;
    }
    observe_group<kVec>(q, n, gv, hv, bag, w01, mg, mh);
  }
  mg = __reduce_max_sync(~0u, mg);
  mh = __reduce_max_sync(~0u, mh);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) {
    warp_g[warp] = mg;
    warp_h[warp] = mh;
  }
  __syncthreads();
  if (warp == 0) {
    mg = __reduce_max_sync(~0u, warp_g[lane]);
    mh = __reduce_max_sync(~0u, warp_h[lane]);
    if (lane == 0) {
      atomicMax(cur, mg);
      atomicMax(cur + 1, mh);
      if (blockIdx.x == 0) {
        other[0] = 0u;
        other[1] = 0u;
      }
    }
  }
  grid_barrier(bar);

  // (2) the scales, then the codes
  const float qm = (float)qmax;
  const float inv = __fdiv_rn(1.f, qm);
  const float gm = scale_floor(__uint_as_float(__ldcg(cur)));
  const float hm = scale_floor(__uint_as_float(__ldcg(cur + 1)));
  const float g_scale = recip ? __fmul_rn(gm, inv) : __fdiv_rn(gm, qm);
  const float h_scale = recip ? __fmul_rn(hm, inv) : __fdiv_rn(hm, qm);
  if (tid == 0) {
    qscale[0] = g_scale;
    qscale[1] = h_scale;
    qscale[2] = 1.f;
  }
  if (tid < groups) {
    emit_group<kDrawH, kVec>(tid, n, gw, hw, ug, uh, g_scale, h_scale, qm,
                             codes);
  }
  for (long long q = tid + step; q < groups; q += step) {
    // a group past the registers: read again, drawn now
    float gv[kQGroup], hv[kQGroup], wv[kQGroup], u1[kQGroup], u2[kQGroup];
    load_group<true, kVec>(grad, q, n, gv);
    load_group<true, kVec>(hess, q, n, hv);
    load_group<true, kVec>(w, q, n, wv);
    draw_group(kg0, kg1, q, n, u1);
    if (kDrawH) draw_group(kh0, kh1, q, n, u2);
#pragma unroll
    for (int j = 0; j < kQGroup; ++j) {
      gv[j] = __fmul_rn(gv[j], wv[j]);
      hv[j] = __fmul_rn(hv[j], wv[j]);
      if (!kDrawH) u2[j] = wv[j] > 0.f ? 1.f : 0.f;
    }
    emit_group<kDrawH, kVec>(q, n, gv, hv, u1, u2, g_scale, h_scale, qm,
                             codes);
  }
}

// The most co-resident blocks of quantize_kernel on the current card (0
// when the card cannot launch it cooperatively), found once.
int resident_blocks() {
  static int blocks = -1;
  if (blocks < 0) {
    int dev = 0, sms = 0, coop = 0, per[4] = {0, 0, 0, 0};
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess ||
        cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev) !=
            cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per[0], quantize_kernel<true, true>, kQThreads, 0) !=
            cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per[1], quantize_kernel<true, false>, kQThreads, 0) !=
            cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per[2], quantize_kernel<false, true>, kQThreads, 0) !=
            cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per[3], quantize_kernel<false, false>, kQThreads, 0) !=
            cudaSuccess) {
      return 0;
    }
    int least = per[0];
    for (int i = 1; i < 4; ++i) least = per[i] < least ? per[i] : least;
    blocks = coop ? sms * least : 0;
  }
  return blocks;
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

// The scratch words Q takes: the barrier's two, then two pairs of
// maxima; zeroed once before the first call.
extern "C" int lgbt_quantize_scratch_ints() { return kQScratchHead + 4; }

// The most blocks a launch may take (all co-resident); 0 when the card
// cannot launch Q cooperatively.
extern "C" int lgbt_quantize_resident_blocks() { return resident_blocks(); }

// grad, hess, w [n] f32; recip: 1 for scales by the reciprocal of qmax;
// blocks: 1 to lgbt_quantize_resident_blocks() (ops/histogram.py
// quantize_plan); scratch: lgbt_quantize_scratch_ints() words, zero
// before the first call and left so by each (one scratch a stream);
// codes [n] short2 (q_g, q_h); w01 [n] f32; qscale [3] f32; any
// alignment of the arrays (16-byte loads where all allow them). One
// cooperative launch; returns its error.
extern "C" int lgbt_quantize_gradients(
    const float* grad, const float* hess, const float* w, int n, int qmax,
    uint32_t kg0, uint32_t kg1, uint32_t kh0, uint32_t kh1, int hess_const,
    int recip, int blocks, uint32_t* scratch, short2* codes, float* w01,
    float* qscale, void* stream) {
  const int cap = resident_blocks();
  if (cap < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  if (blocks < 1 || blocks > cap || n < 0) return (int)cudaErrorInvalidValue;
  void* args[] = {&grad, &hess, &w, &n, &qmax, &kg0, &kg1, &kh0, &kh1,
                  &recip, &scratch, &codes, &w01, &qscale};
  const bool vec = ((uintptr_t)grad | (uintptr_t)hess | (uintptr_t)w |
                    (uintptr_t)codes | (uintptr_t)w01) % 16 == 0;
  const void* kernel =
      hess_const
          ? (vec ? reinterpret_cast<const void*>(quantize_kernel<false, true>)
                 : reinterpret_cast<const void*>(quantize_kernel<false, false>))
          : (vec ? reinterpret_cast<const void*>(quantize_kernel<true, true>)
                 : reinterpret_cast<const void*>(quantize_kernel<true, false>));
  return (int)cudaLaunchCooperativeKernel(kernel, blocks, kQThreads, args, 0,
                                          (cudaStream_t)stream);
}

extern "C" const char* lgbt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
