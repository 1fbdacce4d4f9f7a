// Kernel L, lambdarank_grads, of lightgbm_tpu_torch: the pairwise
// lambdarank gradients and hessians of every document, built for
// sm_90a by ops/_build.py and called through ctypes from ops/rank.py.
//
// Replaces lightgbm_tpu/objectives.py _lambdarank_pair_grads (:438) and
// _lambdarank_bucket_grads (:472). The TPU version pads queries into
// power-of-two length buckets, builds dense [Qb, D, D] pair tensors for
// the matrix and vector units and scatter-adds each document's lambda
// into flat arrays; a 100-doc query pads to 128, a 1,251-doc one to
// 2,048. Here the reference's own per-query O(cnt^2) loop
// (rank_objective.hpp:83-160) maps onto the card directly: one thread
// block per query, one thread per document, no padding and no scatter.
//
// For each query the block stages score, label and gain in shared
// memory (queries up to kStageCap docs; a longer one reads them from
// global memory and keeps its discounts in the caller's scratch, in
// the same kernel), then each thread, for each of its docs d:
//   rank_d = #{e: s_e > s_d} + #{e < d: s_e == s_d}   (the stable
//            descending argsort rank of objectives.py:447-448; -0.0
//            equals 0.0),
//   disc_d = 1 / log2(rank_d + 2).
// The block ORs "some score differs from the first" into norm (max !=
// min). Then each thread walks j = 0..cnt-1 in index order and adds,
// for every pair with differing labels, the pair's terms in its role
// (high: label_d > label_j, or low) to its own doc's grad and hess in
// registers:
//   delta = (gain_hi - gain_lo) * |disc_hi - disc_lo| * inv_max_dcg_q,
//           / (0.01 + |s_hi - s_lo|) when norm,
//   p     = 2 / (1 + exp(2 sigma (s_hi - s_lo))),
//   grad  += -delta p (high) or +delta p (low), hess += 2 delta p (2-p),
// in the JAX function's operation order, built with -fmad=false. It
// writes each doc's grad and hess once, times the row weight when there
// is one. No atomics and no sum across threads: every run gives the
// same bits. The JAX function sums the high role and the low role
// apart and subtracts, so the two agree to f32 reassociation.
//
// Bound on an H100: the pair loop is arithmetic. For each query cnt^2
// rank compares (a shared-memory load, two compares, an add: 4
// instructions) and, for each (high, low) pair with differing labels,
// about 24 instructions (three loads, subtractions, the division, exp,
// the products and two adds), at 33.5e12 instructions/s; the bytes
// (score, label, gain in, grad and hess out: 20 bytes a doc) are far
// fewer. For the 500,000-row protocol (5,000 queries of 100 docs, 25 of
// each label 1-4): 5e7 compares and 1.875e7 pairs, about 0.02 ms. L
// computes each pair twice, once for each of its two docs, so that no
// thread adds into another's sums.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 128;
constexpr int kStageCap = 2048;  // docs a query stages in shared memory

__global__ void __launch_bounds__(kBlock) lambdarank_kernel(
    const float* __restrict__ score, const int* __restrict__ qb,
    const int* __restrict__ label, const float* __restrict__ gain,
    const float* __restrict__ inv_max_dcg, float two_sigma,
    const float* __restrict__ weights, float* __restrict__ disc_buf,
    float* __restrict__ grad, float* __restrict__ hess) {
  __shared__ float s_score[kStageCap];
  __shared__ int s_label[kStageCap];
  __shared__ float s_gain[kStageCap];
  __shared__ float s_disc[kStageCap];
  const int q = blockIdx.x;
  const int begin = qb[q];
  const int cnt = qb[q + 1] - begin;
  if (cnt <= 0) return;

  const float* sc;
  const int* lb;
  const float* gn;
  float* dc;
  if (cnt <= kStageCap) {
    for (int d = threadIdx.x; d < cnt; d += kBlock) {
      s_score[d] = score[begin + d];
      s_label[d] = label[begin + d];
      s_gain[d] = gain[begin + d];
    }
    sc = s_score;
    lb = s_label;
    gn = s_gain;
    dc = s_disc;
  } else {
    sc = score + begin;
    lb = label + begin;
    gn = gain + begin;
    dc = disc_buf + begin;
  }
  __syncthreads();

  // ranks, discounts, and whether the query's scores are not all equal
  const float first = sc[0];
  int differs = 0;
  for (int d = threadIdx.x; d < cnt; d += kBlock) {
    const float s = sc[d];
    int rank = 0;
    for (int e = 0; e < cnt; ++e) {
      const float t = sc[e];
      rank += (t > s) | ((t == s) & (e < d));
    }
    differs |= (s != first);
    dc[d] = 1.0f / log2f((float)rank + 2.0f);
  }
  // a barrier too: every discount is written before the pair loop
  const bool norm = __syncthreads_or(differs) != 0;

  const float inv = inv_max_dcg[q];
  for (int d = threadIdx.x; d < cnt; d += kBlock) {
    const float sd = sc[d];
    const float gd = gn[d];
    const float dd = dc[d];
    const int ld = lb[d];
    float g = 0.0f;
    float h = 0.0f;
    for (int j = 0; j < cnt; ++j) {
      const int lj = lb[j];
      if (lj == ld) continue;
      const bool high = ld > lj;
      const float sj = sc[j];
      const float gj = gn[j];
      const float dj = dc[j];
      const float ds = high ? sd - sj : sj - sd;
      const float gap = high ? gd - gj : gj - gd;
      float delta = gap * fabsf(high ? dd - dj : dj - dd) * inv;
      if (norm) delta = delta / (0.01f + fabsf(ds));
      const float p = 2.0f / (1.0f + expf(two_sigma * ds));
      const float lam = -delta * p;
      h += 2.0f * delta * (p * (2.0f - p));
      g += high ? lam : -lam;
    }
    if (weights != nullptr) {
      const float w = weights[begin + d];
      g = g * w;
      h = h * w;
    }
    grad[begin + d] = g;
    hess[begin + d] = h;
  }
}

}  // namespace

// score [n] f32; qb [nq+1] int32 query boundaries (0 .. n, non-
// decreasing); label [n] int32; gain [n] f32 (label_gain of the clipped
// label); inv_max_dcg [nq] f32; two_sigma = f32(2 * sigmoid); weights
// [n] f32 or null; disc_buf [n] f32 scratch for queries longer than
// lgbt_lambdarank_stage_cap(); grad, hess [n] f32 out.
extern "C" int lgbt_lambdarank_grads(const float* score, const int* qb,
                                     int nq, const int* label,
                                     const float* gain,
                                     const float* inv_max_dcg,
                                     float two_sigma, const float* weights,
                                     float* disc_buf, float* grad,
                                     float* hess, void* stream) {
  if (nq <= 0) return 0;
  lambdarank_kernel<<<nq, kBlock, 0, (cudaStream_t)stream>>>(
      score, qb, label, gain, inv_max_dcg, two_sigma, weights, disc_buf,
      grad, hess);
  return (int)cudaGetLastError();
}

extern "C" int lgbt_lambdarank_stage_cap() { return kStageCap; }

extern "C" const char* lgbt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
