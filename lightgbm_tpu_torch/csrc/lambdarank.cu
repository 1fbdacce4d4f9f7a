// Kernel L, lambdarank_grads, of lightgbm_tpu_torch: the pairwise
// lambdarank gradients and hessians of every document, built for
// sm_90a by ops/_build.py and called through ctypes from ops/rank.py.
//
// Replaces lightgbm_tpu/objectives.py _lambdarank_pair_grads (:438) and
// _lambdarank_bucket_grads (:472). The TPU version pads queries into
// power-of-two length buckets, builds dense [Qb, D, D] pair tensors for
// the matrix and vector units and scatter-adds each document's lambda
// into flat arrays. Here each pair of a query with differing labels is
// computed once, in shared memory, and handed to both of its documents.
//
// The function, per query: rank_d = the stable descending rank of the
// doc's score (#{e: s_e > s_d} + #{e < d: s_e == s_d}, -0.0 equal to
// 0.0), disc_d = 1 / log2(rank_d + 2), norm = the scores are not all
// equal, and for every pair with differing labels, hi the higher label:
//   delta = (gain_hi - gain_lo) * |disc_hi - disc_lo| * inv_max_dcg_q,
//           / (0.01 + |s_hi - s_lo|) when norm,
//   p     = 2 / (1 + exp(2 sigma (s_hi - s_lo))),
//   lam   = -delta p (hi adds lam, lo adds -lam), h = 2 delta p (2 - p)
// to both docs, in the JAX function's operation order under -fmad=false,
// then times the row weight.
//
// Bound on an H100: the pairs are arithmetic (two divisions and an exp
// each, about 24 instructions at 33.5e12/s); the bytes (score, label,
// gain in, grad and hess out: 20 a doc) are far fewer. The protocol's
// 500,000 docs in 100-doc queries of four equal label shares have
// 1.875e7 such pairs: about 0.02 ms.
//
// The design, planned once per query layout by ops/rank.py
// lambdarank_plan (the queries are fixed for a whole training):
// - rank_fit_kernel: queries of up to kFitDocs docs, several packed into
//   a 256-thread block up to kFitDocs docs in all. The block sorts its
//   docs' (query, score, index) keys with a bitonic network (shuffles,
//   and shared memory across warps) for the ranks, then walks the pairs
//   i < j of every query a warp at a time, consecutive lanes on
//   consecutive pairs (row R and row n - 2 - R of a query form one row of
//   n pairs); the pairs whose labels differ queue up in the warp and are
//   computed 32 at a time, each once: i's signed lambda goes to M[i][j]
//   and h to M[j][i] of a zeroed [cnt][cnt | 1] matrix (a pair of equal
//   labels leaves its +0). Then a thread a doc adds its terms in j
//   order, as the reference's loop does: -M[j][d], M[d][j] for j < d;
//   M[d][j], M[j][d] for j > d. Adding +0 leaves a sum that starts at +0
//   (and so is never -0) unchanged, so each doc's sum is the
//   one-thread-a-doc kernel's, bit for bit.
// - longer queries: rank_sort_kernel ranks each once (a bitonic sort of
//   up to kSortCap keys in shared memory, a count past that) into a
//   discount scratch; rank_tile_kernel computes each tile of kTile x kTile
//   docs (I <= J) once, its pairs as above, and each doc's partial over the
//   tile's other side in order into a scratch slot per (doc, partner
//   block); rank_finish_kernel adds a doc's partials in block order. The
//   longest query's tiles go first.
// Shared memory is sized to the plan. No float atomics: every launch
// gives the same bits. ops/rank.py lambdarank_grads_order replays this
// order in torch ops.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 256;      // fit and tile kernels
constexpr int kFitDocs = 128;    // docs of a fit block, and of a fit query
constexpr int kTile = 64;        // docs on a side of a long query's tile
constexpr int kTileStride = kTile + 1;
constexpr int kRankBlock = 256;
constexpr int kSortCap = 4096;   // rank_sort_kernel sorts up to this many docs

struct Doc {
  float s, gain, disc;
  int lab;
};

// ascending in the key = descending in the score; -0.0 ranks as 0.0
__device__ __forceinline__ unsigned desc_key(float s) {
  const unsigned u = __float_as_uint(s == 0.f ? 0.f : s);
  return (u & 0x80000000u) ? u : ~(u | 0x80000000u);
}

__device__ __forceinline__ float discount(int rank) {
  return 1.0f / log2f((float)rank + 2.0f);
}

// a's signed lambda and the pair's h for docs a and b, formed as
// _lambdarank_pair_grads forms them with the higher label's doc first;
// +0 and +0 when the labels are equal
__device__ __forceinline__ float pair_terms(const Doc& a, const Doc& b,
                                            float inv, bool norm,
                                            float two_sigma, float& h) {
  const bool high = a.lab > b.lab;
  const float ds = high ? a.s - b.s : b.s - a.s;
  const float gap = high ? a.gain - b.gain : b.gain - a.gain;
  float delta = gap * fabsf(high ? a.disc - b.disc : b.disc - a.disc) * inv;
  if (norm) delta = delta / (0.01f + fabsf(ds));
  const float p = 2.0f / (1.0f + expf(two_sigma * ds));
  const float lam = -delta * p;
  const bool differ = a.lab != b.lab;
  h = differ ? 2.0f * delta * (p * (2.0f - p)) : 0.0f;
  return differ ? (high ? lam : -lam) : 0.0f;
}

// Pair r of an n-doc triangle (pairs i < j): row R and row n - 2 - R
// hold n pairs together, so pair r is the (r % n)-th of combined row
// r / n (inv_n about 1 / n).
__device__ __forceinline__ void triangle_pair(int n, float inv_n, int r,
                                              int& i, int& j) {
  int R = (int)((float)r * inv_n);
  int k = r - R * n;
  if (k < 0) {
    --R;
    k += n;
  } else if (k >= n) {
    ++R;
    k -= n;
  }
  const int first = n - 1 - R;  // row R's pairs
  if (k < first) {
    i = R;
    j = R + 1 + k;
  } else {
    i = n - 2 - R;
    j = i + 1 + (k - first);
  }
}

// Doc d's sums over the other docs of an n-doc triangle M, in j order.
__device__ __forceinline__ void triangle_sums(const float* M, int S, int n,
                                              int d, float& g, float& h) {
  g = 0.0f;
  h = 0.0f;
#pragma unroll 4
  for (int j = 0; j < d; ++j) {
    g = g - M[j * S + d];
    h = h + M[d * S + j];
  }
#pragma unroll 4
  for (int j = d + 1; j < n; ++j) {
    g = g + M[d * S + j];
    h = h + M[j * S + d];
  }
}

// Bitonic sort of the first kFitDocs threads' keys, ascending by thread:
// shuffles within a warp, shared memory (xbuf) across warps, which meet
// at named barrier 1 (the block's other threads go on).
__device__ __forceinline__ unsigned long long sort_keys(
    unsigned long long key, unsigned long long* xbuf) {
  const int t = threadIdx.x;
  for (int k = 2; k <= kFitDocs; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      unsigned long long other;
      if (j >= 32) {
        xbuf[t] = key;
        asm volatile("bar.sync 1, %0;" ::"n"(kFitDocs) : "memory");
        other = xbuf[t ^ j];
        asm volatile("bar.sync 1, %0;" ::"n"(kFitDocs) : "memory");
      } else {
        other = __shfl_xor_sync(0xffffffffu, key, j);
      }
      const bool take_min = ((t & j) == 0) == ((t & k) == 0);
      key = take_min ? (key < other ? key : other)
                     : (key > other ? key : other);
    }
  }
  return key;
}

// Walks candidate pairs c = 0 .. n - 1 a warp at a time (warp w takes
// c = 32 w + lane, then 32 nwarps further on): decode(c, packed) says
// whether the pair's labels differ and packs it; the pairs that differ
// queue up in the warp's 64-entry `queue` and are computed 32 at a time,
// compute(packed) on every lane, so that no lane idles on a pair of equal
// labels. Which lane computes a pair moves no bits: each pair's terms go
// to their own places.
template <typename Decode, typename Compute>
__device__ __forceinline__ void differing_pairs(int n, unsigned* queue,
                                                Decode decode,
                                                Compute compute) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  unsigned* wq = queue + w * 64;
  const unsigned below = (1u << lane) - 1u;
  int qn = 0;
  for (int base = w * 32; base < n; base += kBlock) {
    unsigned packed = 0;
    const bool differ = base + lane < n && decode(base + lane, packed);
    const unsigned m = __ballot_sync(~0u, differ);
    if (differ) wq[qn + __popc(m & below)] = packed;
    qn += __popc(m);
    __syncwarp();
    if (qn >= 32) {
      const unsigned e = wq[lane], rest = wq[32 + lane];
      __syncwarp();
      if (lane < qn - 32) wq[lane] = rest;
      qn -= 32;
      __syncwarp();
      compute(e);
    }
  }
  if (lane < qn) compute(wq[lane]);
}

// ---------------------------------------------------------------- fit
// fit_block [B, 7]: first slot, slots, docs, pairs i < j, M floats, and
// the first slot's query and first doc; fit_slot [S, 6]: query, first
// doc, docs, first local doc, first float of M, first pair
__global__ void __launch_bounds__(kBlock) rank_fit_kernel(
    const float* __restrict__ score, const int* __restrict__ label,
    const float* __restrict__ gain, const float* __restrict__ inv_max_dcg,
    float two_sigma, const float* __restrict__ weights,
    const int* __restrict__ fit_block, const int* __restrict__ fit_slot,
    int max_slots, float* __restrict__ grad, float* __restrict__ hess) {
  extern __shared__ __align__(16) unsigned char smem[];
  Doc* docs = reinterpret_cast<Doc*>(smem);                // [kFitDocs]
  unsigned* queue = reinterpret_cast<unsigned*>(docs + kFitDocs);
  int* q_begin = reinterpret_cast<int*>(queue + kBlock * 2);  // [max_slots]
  int* q_cnt = q_begin + max_slots;
  int* q_off = q_cnt + max_slots;
  int* q_moff = q_off + max_slots;
  int* q_coff = q_moff + max_slots;
  int* q_norm = q_coff + max_slots;
  float* q_inv = reinterpret_cast<float*>(q_norm + max_slots);
  unsigned char* slot_of = reinterpret_cast<unsigned char*>(
      q_inv + max_slots);                                  // [kFitDocs]
  unsigned char* sorted = slot_of + kFitDocs;               // [kFitDocs]
  float* M = reinterpret_cast<float*>(
      smem + (((size_t)(sorted + kFitDocs - smem) + 15) & ~(size_t)15));
  const int t = threadIdx.x;
  const int* fb = fit_block + (size_t)blockIdx.x * 7;
  const int s0 = fb[0], nslots = fb[1], ndocs = fb[2], npairs = fb[3],
            mfloats = fb[4];

  // the slots' tables (one slot: from the block's own record)
  if (nslots == 1) {
    if (t == 0) {
      q_begin[0] = fb[6];
      q_cnt[0] = ndocs;
      q_off[0] = q_moff[0] = q_coff[0] = 0;
      q_inv[0] = inv_max_dcg[fb[5]];
    }
  } else {
    for (int sl = t; sl < nslots; sl += kBlock) {
      const int* fs = fit_slot + (size_t)(s0 + sl) * 6;
      q_begin[sl] = fs[1];
      q_cnt[sl] = fs[2];
      q_off[sl] = fs[3];
      q_moff[sl] = fs[4];
      q_coff[sl] = fs[5];
      q_inv[sl] = inv_max_dcg[fs[0]];
    }
    __syncthreads();
    for (int sl = t; sl < nslots; sl += kBlock) {
      for (int d = 0; d < q_cnt[sl]; ++d) slot_of[q_off[sl] + d] = sl;
    }
  }
  __syncthreads();
  // stage the docs, sort their (slot, score, index) keys: the ranks
  unsigned long long key = ~0ull;
  if (t < ndocs) {
    const int sl = nslots == 1 ? 0 : slot_of[t];
    const int r = q_begin[sl] + t - q_off[sl];
    const float s = score[r];
    docs[t] = Doc{s, gain[r], 0.0f, label[r]};
    key = ((unsigned long long)sl << 39) |
          ((unsigned long long)desc_key(s) << 7) | (unsigned)t;
  }
  if (t < kFitDocs) {
    key = sort_keys(key, reinterpret_cast<unsigned long long*>(M));
  }
  if (t < ndocs) sorted[t] = (unsigned char)(key & 127u);
  __syncthreads();
  if (t < ndocs) {
    const int l = (int)(key & 127u);
    const int sl = (int)(key >> 39);
    const int first = q_off[sl];
    docs[l].disc = discount(t - first);
    if (t == first) {  // the query's highest and lowest scores
      q_norm[sl] = docs[l].s != docs[sorted[first + q_cnt[sl] - 1]].s;
    }
  }
  // zero the pair matrices: a pair of equal labels leaves its +0
  float4* m4 = reinterpret_cast<float4*>(M);
  for (int i = t; i < mfloats / 4; i += kBlock) {
    m4[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  __syncthreads();

  // the pairs i < j of every slot whose labels differ
  const auto compute = [&](unsigned e) {
    const int sl = e >> 16, a = (e >> 8) & 0xff, b = e & 0xff;
    const int o = q_off[sl], S = q_cnt[sl] | 1;
    float h;
    float* Mq = M + q_moff[sl];
    Mq[(a - o) * S + (b - o)] = pair_terms(docs[a], docs[b], q_inv[sl],
                                           q_norm[sl] != 0, two_sigma, h);
    Mq[(b - o) * S + (a - o)] = h;
  };
  if (nslots == 1) {
    const float inv_n = __fdividef(1.0f, (float)ndocs);
    differing_pairs(
        npairs, queue,
        [&](int c, unsigned& packed) {
          int i, j;
          triangle_pair(ndocs, inv_n, c, i, j);
          packed = (i << 8) | j;
          return docs[i].lab != docs[j].lab;
        },
        compute);
  } else {
    int sl_walk = 0;
    differing_pairs(
        npairs, queue,
        [&](int c, unsigned& packed) {
          while (sl_walk + 1 < nslots && q_coff[sl_walk + 1] <= c) ++sl_walk;
          const int n = q_cnt[sl_walk], o = q_off[sl_walk];
          int i, j;
          triangle_pair(n, __fdividef(1.0f, (float)n), c - q_coff[sl_walk],
                        i, j);
          packed = ((unsigned)sl_walk << 16) | ((o + i) << 8) | (o + j);
          return docs[o + i].lab != docs[o + j].lab;
        },
        compute);
  }
  __syncthreads();

  if (t < ndocs) {
    const int sl = nslots == 1 ? 0 : slot_of[t];
    const int n = q_cnt[sl], d = t - q_off[sl];
    float g, h;
    triangle_sums(M + q_moff[sl], n | 1, n, d, g, h);
    const int r = q_begin[sl] + d;
    if (weights != nullptr) {
      const float w = weights[r];
      g = g * w;
      h = h * w;
    }
    grad[r] = g;
    hess[r] = h;
  }
}

// ---------------------------------------------------------------- long
// long_q [Lq, 5]: query, first slot of its discount scratch, first slot
// of its partial scratch (cnt floats a partner block), first doc, docs
__global__ void __launch_bounds__(kRankBlock) rank_sort_kernel(
    const float* __restrict__ score, const int* __restrict__ long_q,
    float* __restrict__ disc,
    int* __restrict__ norm_out) {
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned long long* keys = reinterpret_cast<unsigned long long*>(smem);
  const int lq = blockIdx.x, t = threadIdx.x;
  const int dbase = long_q[lq * 5 + 1], begin = long_q[lq * 5 + 3],
            cnt = long_q[lq * 5 + 4];
  const float* sc = score + begin;
  if (cnt <= kSortCap) {
    int P = 1;
    while (P < cnt) P <<= 1;
    for (int i = t; i < P; i += kRankBlock) {
      keys[i] = i < cnt ? ((unsigned long long)desc_key(sc[i]) << 32) |
                              (unsigned)i
                        : ~0ull;
    }
    __syncthreads();
    for (int k = 2; k <= P; k <<= 1) {
      for (int j = k >> 1; j > 0; j >>= 1) {
        for (int i = t; i < P; i += kRankBlock) {
          const int l = i ^ j;
          if (l > i) {
            const unsigned long long a = keys[i], b = keys[l];
            if ((a > b) == ((i & k) == 0)) {
              keys[i] = b;
              keys[l] = a;
            }
          }
        }
        __syncthreads();
      }
    }
    for (int p = t; p < cnt; p += kRankBlock) {
      disc[dbase + (int)(keys[p] & 0xffffffffu)] = discount(p);
    }
    if (t == 0) {
      norm_out[lq] = sc[(int)(keys[0] & 0xffffffffu)] !=
                     sc[(int)(keys[cnt - 1] & 0xffffffffu)];
    }
    return;
  }
  // past the sort cap: count, reading the scores from global memory
  const float first = sc[0];
  int differs = 0;
  for (int d = t; d < cnt; d += kRankBlock) {
    const float s = sc[d];
    int rank = 0;
    for (int e = 0; e < cnt; ++e) {
      const float v = sc[e];
      rank += (v > s) | ((v == s) & (e < d));
    }
    differs |= (s != first);
    disc[dbase + d] = discount(rank);
  }
  const int any = __syncthreads_or(differs);
  if (t == 0) norm_out[lq] = any != 0;
}

// tiles [T, 8]: query, long query, first doc, docs, row block I, column
// block J (I <= J), first discount slot, first partial slot
__global__ void __launch_bounds__(kBlock) rank_tile_kernel(
    const float* __restrict__ score, const int* __restrict__ label,
    const float* __restrict__ gain, const float* __restrict__ inv_max_dcg,
    float two_sigma, const int* __restrict__ tiles,
    const float* __restrict__ disc, const int* __restrict__ norm_in,
    float* __restrict__ part_g, float* __restrict__ part_h) {
  extern __shared__ __align__(16) unsigned char smem[];
  Doc* docs = reinterpret_cast<Doc*>(smem);       // A [kTile], B [kTile]
  unsigned* queue = reinterpret_cast<unsigned*>(docs + 2 * kTile);
  float* G = reinterpret_cast<float*>(queue + kBlock * 2);  // [kTile][65]
  float* H = G + kTile * kTileStride;
  const int t = threadIdx.x;
  const int* tr = tiles + (size_t)blockIdx.x * 8;
  const int q = tr[0], lq = tr[1], begin = tr[2], cnt = tr[3], I = tr[4],
            J = tr[5], dbase = tr[6], pbase = tr[7];
  const int a0 = I * kTile, b0 = J * kTile;
  const int nA = min(kTile, cnt - a0), nB = min(kTile, cnt - b0);
  const bool diag = I == J;
  const float inv = inv_max_dcg[q];
  const bool norm = norm_in[lq] != 0;
  {
    const int side = t / kTile, k = t % kTile;
    const int d = (side ? b0 : a0) + k;
    if (side < 2 && k < (side ? nB : nA) && !(diag && side)) {
      docs[t] = Doc{score[begin + d], gain[begin + d], disc[dbase + d],
                    label[begin + d]};
    }
  }
  // zero the tile: a pair of equal labels leaves its +0
  float4* g4 = reinterpret_cast<float4*>(G);
  for (int i = t; i < 2 * kTile * kTileStride / 4; i += kBlock) {
    g4[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  __syncthreads();

  // every pair whose labels differ, once
  const Doc* A = docs;
  if (diag) {
    const float inv_n = __fdividef(1.0f, (float)nA);
    differing_pairs(
        nA * (nA - 1) / 2, queue,
        [&](int c, unsigned& packed) {
          int i, j;
          triangle_pair(nA, inv_n, c, i, j);
          packed = (i << 8) | j;
          return A[i].lab != A[j].lab;
        },
        [&](unsigned e) {
          const int i = e >> 8, j = e & 0xff;
          float h;
          G[i * kTileStride + j] = pair_terms(A[i], A[j], inv, norm,
                                              two_sigma, h);
          G[j * kTileStride + i] = h;
        });
  } else {
    const Doc* B = docs + kTile;
    differing_pairs(
        nA * kTile, queue,
        [&](int c, unsigned& packed) {
          const int i = c / kTile, j = c % kTile;
          packed = (i << 8) | j;
          return j < nB && A[i].lab != B[j].lab;
        },
        [&](unsigned e) {
          const int i = e >> 8, j = e & 0xff;
          float h;
          G[i * kTileStride + j] = pair_terms(A[i], B[j], inv, norm,
                                              two_sigma, h);
          H[i * kTileStride + j] = h;
        });
  }
  __syncthreads();

  // each doc's partial over the tile's other side, in order
  float g = 0.f, h = 0.f;
  int d = -1, P = 0;
  if (diag) {
    if (t < nA) {
      triangle_sums(G, kTileStride, nA, t, g, h);
      d = a0 + t;
      P = I;
    }
  } else if (t < kTile) {
    if (t < nA) {
      for (int j = 0; j < nB; ++j) {
        g = g + G[t * kTileStride + j];
        h = h + H[t * kTileStride + j];
      }
      d = a0 + t;
      P = J;
    }
  } else if (t < 2 * kTile && t - kTile < nB) {
    const int b = t - kTile;
    for (int i = 0; i < nA; ++i) {
      g = g - G[i * kTileStride + b];
      h = h + H[i * kTileStride + b];
    }
    d = b0 + b;
    P = I;
  }
  if (d >= 0) {
    part_g[pbase + (size_t)P * cnt + d] = g;
    part_h[pbase + (size_t)P * cnt + d] = h;
  }
}

// finish [F, 4]: first doc, docs, doc block, first partial slot; a
// doc's partials in block order
__global__ void __launch_bounds__(kTile) rank_finish_kernel(
    const int* __restrict__ finish, const float* __restrict__ part_g,
    const float* __restrict__ part_h, const float* __restrict__ weights,
    float* __restrict__ grad, float* __restrict__ hess) {
  const int* fr = finish + (size_t)blockIdx.x * 4;
  const int begin = fr[0], cnt = fr[1], I = fr[2], pbase = fr[3];
  const int d = I * kTile + threadIdx.x;
  if (d >= cnt) return;
  const int nb = (cnt + kTile - 1) / kTile;
  float g = 0.f, h = 0.f;
  for (int P = 0; P < nb; ++P) {
    g = g + part_g[pbase + (size_t)P * cnt + d];
    h = h + part_h[pbase + (size_t)P * cnt + d];
  }
  if (weights != nullptr) {
    const float w = weights[begin + d];
    g = g * w;
    h = h * w;
  }
  grad[begin + d] = g;
  hess[begin + d] = h;
}

cudaError_t smem_attr(const void* kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

}  // namespace

// The plan's constants, for ops/rank.py to check against its own:
// fit docs, tile docs, sort cap, threads a fit or tile block.
extern "C" int lgbt_lambdarank_layout(int which) {
  return which == 0 ? kFitDocs : which == 1 ? kTile : which == 2 ? kSortCap
                                                                  : kBlock;
}

// score [n] f32; label [n] int32; gain [n] f32 (label_gain of the
// clipped label); inv_max_dcg [nq] f32; two_sigma = f32(2 * sigmoid);
// weights [n] f32 or null; the plan of ops/rank.py lambdarank_plan:
// fit_block [n_fit, 7] (its first n_fit_large blocks launched with
// fit_smem_large shared bytes, the rest with fit_smem), fit_slot [., 6]
// and most slots a block; long_q [n_long, 5], tiles [n_tiles, 8], finish [n_finish, 4],
// the sort kernel's shared bytes and the tile kernel's; scratch disc (the
// long queries' docs), norm [n_long] int32, part_g and part_h; grad,
// hess [n] f32 out.
extern "C" int lgbt_lambdarank_grads(
    const float* score, const int* label, const float* gain,
    const float* inv_max_dcg, float two_sigma, const float* weights,
    const int* fit_block, const int* fit_slot, int n_fit, int n_fit_large,
    int fit_smem_large, int fit_smem, int max_slots, const int* long_q, int n_long, const int* tiles,
    int n_tiles, const int* finish, int n_finish, int rank_smem,
    int tile_smem, float* disc, int* norm, float* part_g, float* part_h,
    float* grad, float* hess, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err;
  if (n_long > 0) {
    if ((err = smem_attr((const void*)rank_sort_kernel, rank_smem)) != cudaSuccess)
      return (int)err;
    rank_sort_kernel<<<n_long, kRankBlock, rank_smem, s>>>(score, long_q,
                                                           disc, norm);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    if ((err = smem_attr((const void*)rank_tile_kernel, tile_smem)) != cudaSuccess)
      return (int)err;
    rank_tile_kernel<<<n_tiles, kBlock, tile_smem, s>>>(
        score, label, gain, inv_max_dcg, two_sigma, tiles, disc, norm, part_g,
        part_h);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    rank_finish_kernel<<<n_finish, kTile, 0, s>>>(finish, part_g, part_h,
                                                  weights, grad, hess);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  // the fit blocks in two launches, each with the shared memory its
  // blocks need: the large ones (first in the plan), then the rest
  const int parts[2][3] = {{0, n_fit_large, fit_smem_large},
                           {n_fit_large, n_fit - n_fit_large, fit_smem}};
  for (const auto& part : parts) {
    if (part[1] <= 0) continue;
    if ((err = smem_attr((const void*)rank_fit_kernel, part[2])) !=
        cudaSuccess)
      return (int)err;
    rank_fit_kernel<<<part[1], kBlock, part[2], s>>>(
        score, label, gain, inv_max_dcg, two_sigma, weights,
        fit_block + (size_t)part[0] * 7, fit_slot, max_slots, grad, hess);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  return 0;
}

extern "C" const char* lgbt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
