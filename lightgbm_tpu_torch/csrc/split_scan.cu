// Kernel S, split_scan, of lightgbm_tpu_torch: the best split of each of
// C leaves from its [G, B, 3] stored-group histogram, built for sm_90a
// by ops/_build.py and called through ctypes from ops/split.py.
//
// Replaces lightgbm_tpu/ops/split.py find_best_splits (:80) with the
// per-leaf pick of lightgbm_tpu/learner/grow.py _extract_feature_hist
// (:343) and _leaf_best_split (:367), serial part. Per (leaf, feature):
// - takes the feature's bins out of its group (EFB offset) and, for a
//   bundled feature, rebuilds the default bin as leaf totals minus the
//   other bins (FixHistogram, dataset.cpp:747-767), a compensated
//   (Kahan) sum over the feature's FB scan slots in bin order;
// - scans the bins for the inclusive sums of (g, h, count) in the order
//   of XLA's CPU cumsum: running sums within blocks of 16 bins plus the
//   running sum of the earlier blocks' totals, which past 16 blocks are
//   scanned in blocks of 16 again (ops/split.py xla_cumsum): on
//   dequantized histograms (quantized training) the scans equal the JAX
//   package's bitwise, and on f32 ones a tie that exact arithmetic makes
//   is decided as the JAX package decides it;
// - evaluates at each threshold the default-left and default-right
//   variants (split.py:117-174) and the one-vs-rest categorical variant
//   (split.py:176-195), with K_EPSILON on the parent and left hessians
//   and the min_data / min_sum_hessian guards;
// - keeps the first best of each variant and resolves ties left, then
//   right, then categorical: the lowest index of the JAX package's argmax
//   over [left(B), right(B), cat(B)] (split.py:197-205).
// Then the feature mask, the max_depth guard and the 1e30 clamp, and the
// lowest-index argmax over features (grow.py:386-393).
//
// Design: a grid of (tile of features) x (leaf), the tiles from
// ops/split.py split_plan: `per` consecutive features a block, one warp
// each, about 66 tiles a leaf where there are that many features (a
// leaf pair fills the 132 SMs), fewer features a tile where the warps'
// shared regions would not fit. A warp:
// - stages its feature's [bins, 3] slice of the leaf's histogram into
//   its own region of shared memory with cp.async, 16 bytes a copy (4
//   at an unaligned head or tail), so every serial step below waits on
//   shared, not device, memory;
// - lane 0 runs the Kahan chain of a bundled feature, serially, as the
//   plain version does;
// - lane b runs the running sum of block b of 16 bins (lanes b + 32, ...
//   past 32 blocks), lane 0 then carries the blocks' totals in XLA's
//   order (one level, or two past 16 blocks) into each block's prefix,
//   and every lane adds its block's prefix: the same adds, in the same
//   order, as one lane walking the bins, so the bits do not change;
// - the 32 lanes evaluate the thresholds and a warp reduction keeps the
//   first best, which lane 0 writes to the leaf's row of feat_gain and
//   of a scratch table of the features' bests.
// The last block of a leaf to finish (a per-leaf ticket, an integer
// atomic after a __threadfence, set back to 0 for the next launch) takes
// the masked, depth-guarded, clamped, lowest-index argmax over the F
// features, which does not depend on the blocks' order, and writes the
// leaf's out_f / out_i.
//
// Arithmetic is f32 in the JAX package's order; the library is built
// with -fmad=false so no multiply-add is fused, which keeps the kernel
// bitwise equal to its plain version. Bound on an H100 (3.35 TB/s):
// the features' slices of C*G*B*12 bytes of histogram in; at Bosch (968
// features of at most 64 bins, a leaf pair) 5.1 MB, 0.0015 ms; at the
// HIGGS pair (28 features, 64 bins) 43 KB, 0.00001 ms. What sets the
// time: the launch, the staging's one round trip to device memory, and
// each warp's serial steps (Kahan over FB slots, 16 bins a block, the
// blocks' totals), a few microseconds.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kEpsilon = 1e-15f;
constexpr float kGainClamp = 1e30f;
// warps (features) of a block at most (ops/split.py SPLIT_MAX_WARPS)
constexpr int kMaxWarps = 8;
// the dynamic shared memory a block may take (an SM gives 227 KB;
// ops/split.py SPLIT_SMEM_BYTES)
constexpr size_t kSmemBudget = 200 * 1024;
constexpr int kMissingNone = 0;
constexpr int kMissingZero = 1;
constexpr int kMissingNan = 2;
// a feature's best in the scratch table: gain's companions lg, lh_eff,
// lc, thr, variant
constexpr int kBestWords = 5;

// XLA's CPU backend scans in blocks of this many bins (ops/split.py)
constexpr int kXlaScanBase = 16;

struct Params {
  float l1, l2, min_gain_to_split, min_sum_hessian;
  int min_data, max_depth;
};

__device__ __forceinline__ float split_gain(float g, float h, float l1,
                                            float l2) {
  const float reg = fmaxf(fabsf(g) - l1, 0.f);
  return (reg * reg) / (h + l2);
}

// one compensated (Kahan) add; -fmad=false keeps it exact as written
__device__ __forceinline__ void kahan_add(float& total, float& comp,
                                          float v) {
  const float y = v - comp;
  const float t = total + y;
  comp = (t - total) - y;
  total = t;
}

struct Best {
  float gain, lg, lh_eff, lc;
  int thr;
};

__device__ __forceinline__ void consider(Best& b, float gain, int t, float lg,
                                         float lh_eff, float lc) {
  if (gain > b.gain) {
    b.gain = gain;
    b.thr = t;
    b.lg = lg;
    b.lh_eff = lh_eff;
    b.lc = lc;
  }
}

// the JAX eval_variant on one threshold: -inf unless valid and above
// min_gain_shift
__device__ __forceinline__ float variant_gain(const Params& p, float pg,
                                              float ph, float pc, float lg,
                                              float lh_eff, float lc,
                                              float shift) {
  const float rg = pg - lg;
  const float rh = ph - lh_eff;
  const float rc = pc - lc;
  const bool ok = lc >= (float)p.min_data && rc >= (float)p.min_data &&
                  lh_eff >= p.min_sum_hessian && rh >= p.min_sum_hessian;
  const float gains =
      split_gain(lg, lh_eff, p.l1, p.l2) + split_gain(rg, rh, p.l1, p.l2);
  return (ok && gains > shift) ? gains : -INFINITY;
}

// the better of two candidates: larger gain, ties to the lower bin,
// i.e. the first maximum of the bin-ordered scan
__device__ __forceinline__ void warp_best(Best& b) {
  for (int o = 16; o > 0; o >>= 1) {
    Best x;
    x.gain = __shfl_down_sync(~0u, b.gain, o);
    x.thr = __shfl_down_sync(~0u, b.thr, o);
    x.lg = __shfl_down_sync(~0u, b.lg, o);
    x.lh_eff = __shfl_down_sync(~0u, b.lh_eff, o);
    x.lc = __shfl_down_sync(~0u, b.lc, o);
    if (x.gain > b.gain || (x.gain == b.gain && x.thr < b.thr)) b = x;
  }
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}

// n floats from src to dst by the 32 lanes of a warp; dst and src agree
// modulo 16 bytes, so the body goes in 16-byte copies
__device__ __forceinline__ void warp_stage(float* dst, const float* src,
                                           int n, int lane) {
  const int head =
      min(n, (int)((16u - ((uintptr_t)src & 15u)) & 15u) / 4);
  const int body = (n - head) / 4;
  for (int i = lane; i < head; i += 32) cp_async4(dst + i, src + i);
  for (int i = lane; i < body; i += 32) {
    cp_async16(dst + head + 4 * i, src + head + 4 * i);
  }
  for (int i = head + 4 * body + lane; i < n; i += 32) {
    cp_async4(dst + i, src + i);
  }
  asm volatile("cp.async.wait_all;\n" ::);
  __syncwarp();
}

// one warp's shared region, in floats: the staged slice (3 * FB words
// and 3 of alignment, rounded up to 4), the scans (3 * FB), the blocks'
// totals then prefixes (3 * blocks), rounded up to 4
__host__ __device__ __forceinline__ int region_words(int FB) {
  const int blocks = (FB + kXlaScanBase - 1) / kXlaScanBase;
  return ((3 * FB + 6) / 4 * 4 + 3 * FB + 3 * blocks + 3) / 4 * 4;
}

__global__ void __launch_bounds__(kMaxWarps * 32) split_scan_kernel(
    const float* __restrict__ hist, int G, int B, int F, int FB, int per,
    const float* __restrict__ sums, const int* __restrict__ depth,
    const int* __restrict__ num_bin, const int* __restrict__ missing,
    const int* __restrict__ default_bin, const uint8_t* __restrict__ is_cat,
    const int* __restrict__ group, const int* __restrict__ offset,
    const uint8_t* __restrict__ bundled, const uint8_t* __restrict__ mask,
    Params p, float* __restrict__ feat_gain, float* __restrict__ best_tab,
    int* __restrict__ tickets, float* __restrict__ out_f,
    int* __restrict__ out_i) {
  extern __shared__ __align__(16) float smem[];
  __shared__ int s_last;
  __shared__ float s_gain[kMaxWarps];
  __shared__ int s_feat[kMaxWarps];
  const int c = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int f = blockIdx.x * per + warp;
  const int blocks = (FB + kXlaScanBase - 1) / kXlaScanBase;
  const int stage_words = (3 * FB + 6) / 4 * 4;
  float* const stage = smem + (size_t)warp * region_words(FB);
  float* const scan = stage + stage_words;
  float* const tot = scan + 3 * FB;
  const float* h = hist + (size_t)c * G * B * 3;
  const float pg = sums[c * 3];
  const float ph_in = sums[c * 3 + 1];
  const float pc = sums[c * 3 + 2];
  const float ph = ph_in + 2.f * kEpsilon;
  const float shift = split_gain(pg, ph, p.l1, p.l2) + p.min_gain_to_split;

  if (f < F) {
    const int nb = num_bin[f], mt = missing[f], dbin = default_bin[f];
    const int nbe = min(nb, FB);  // the bins the scan reads
    const bool cat = is_cat[f] != 0;
    const bool bun = bundled[f] != 0;
    const bool dual = nb > 2 && mt != kMissingNone;
    const bool skip_default = dual && mt == kMissingZero;
    const bool use_na = dual && mt == kMissingNan;
    const int nan_bin = nb - 1;
    // the feature's bins: bin t channel k at v[3 * t + k]
    const float* src = h + ((size_t)group[f] * B + offset[f]) * 3;
    float* const v = stage + (((uintptr_t)src >> 2) & 3u);
    warp_stage(v, src, 3 * nbe, lane);

    // FixHistogram default bin: one lane, in bin order over the FB slots
    float rest_g = 0.f, rest_h = 0.f, rest_c = 0.f;
    if (bun && lane == 0) {
      float sg = 0.f, sh = 0.f, sc = 0.f, kg = 0.f, kh = 0.f, kc = 0.f;
      for (int t = 0; t < FB; ++t) {
        const bool in = t < nbe;
        kahan_add(sg, kg, in ? v[3 * t] : 0.f);
        kahan_add(sh, kh, in ? v[3 * t + 1] : 0.f);
        kahan_add(sc, kc, in ? v[3 * t + 2] : 0.f);
      }
      rest_g = pg - sg;
      rest_h = ph_in - sh;
      rest_c = pc - sc;
    }
    rest_g = __shfl_sync(~0u, rest_g, 0);
    rest_h = __shfl_sync(~0u, rest_h, 0);
    rest_c = __shfl_sync(~0u, rest_c, 0);
    // bin t of this feature (0 beyond num_bin; FixHistogram default)
    auto bin_at = [&](int t, float& bg, float& bh, float& bc) {
      if (t >= nbe) {
        bg = bh = bc = 0.f;
      } else if (bun && t == dbin) {
        bg = rest_g;
        bh = rest_h;
        bc = rest_c;
      } else {
        bg = v[3 * t];
        bh = v[3 * t + 1];
        bc = v[3 * t + 2];
      }
    };

    // running sums within each block of kXlaScanBase bins, a lane a block
    for (int b = lane; b < blocks; b += 32) {
      float rg = 0.f, rh = 0.f, rc = 0.f;
      const int t1 = min(FB, (b + 1) * kXlaScanBase);
      for (int t = b * kXlaScanBase; t < t1; ++t) {
        float vg, vh, vc;
        bin_at(t, vg, vh, vc);
        const bool zero_it =
            (skip_default && t == dbin) || (use_na && t == nan_bin);
        rg = rg + (zero_it ? 0.f : vg);
        rh = rh + (zero_it ? 0.f : vh);
        rc = rc + (zero_it ? 0.f : vc);
        scan[t] = rg;
        scan[FB + t] = rh;
        scan[2 * FB + t] = rc;
      }
      tot[b] = rg;
      tot[blocks + b] = rh;
      tot[2 * blocks + b] = rc;
    }
    __syncwarp();
    if (lane == 0) {
      // block b's prefix X[b - 1] (0 for block 0), X the XLA scan of the
      // blocks' totals: up to kXlaScanBase blocks a running sum (w);
      // past that the totals are scanned in blocks of kXlaScanBase too,
      // a running sum within each (w) plus the running sum of the
      // finished super-blocks' totals (y), which at FB <= 4096 (the
      // wrapper takes at most 2048) are at most kXlaScanBase
      const bool two = blocks > kXlaScanBase;
      float wg = 0.f, wh = 0.f, wc = 0.f, yg = 0.f, yh = 0.f, yc = 0.f;
      float xg = 0.f, xh = 0.f, xc = 0.f, ug = 0.f, uh = 0.f, uc = 0.f;
      for (int b = 0; b < blocks; ++b) {
        if (b > 0) {
          const int k = b - 1;  // the block just finished, total (ug, ...)
          if (two && k > 0 && k % kXlaScanBase == 0) {
            yg = yg + wg;
            yh = yh + wh;
            yc = yc + wc;
            wg = wh = wc = 0.f;
          }
          wg = wg + ug;
          wh = wh + uh;
          wc = wc + uc;
          xg = two ? wg + yg : wg;
          xh = two ? wh + yh : wh;
          xc = two ? wc + yc : wc;
        }
        ug = tot[b];
        uh = tot[blocks + b];
        uc = tot[2 * blocks + b];
        tot[b] = xg;
        tot[blocks + b] = xh;
        tot[2 * blocks + b] = xc;
      }
    }
    __syncwarp();
    for (int b = lane; b < blocks; b += 32) {
      const float xg = tot[b], xh = tot[blocks + b], xc = tot[2 * blocks + b];
      const int t1 = min(FB, (b + 1) * kXlaScanBase);
      for (int t = b * kXlaScanBase; t < t1; ++t) {
        scan[t] = scan[t] + xg;
        scan[FB + t] = scan[FB + t] + xh;
        scan[2 * FB + t] = scan[2 * FB + t] + xc;
      }
    }
    __syncwarp();
    float eg = 0.f, eh = 0.f, ec = 0.f;  // mass that follows default-left
    if (use_na || skip_default) bin_at(use_na ? nan_bin : dbin, eg, eh, ec);
    const bool right_ok = dual || (mt == kMissingNan && nb <= 2);
    const bool left_ok = dual || !(mt == kMissingNan && nb <= 2);
    const int left_tmax = use_na ? nb - 3 : nb - 2;
    const int used_bin = nb - 1 + (mt == kMissingNone ? 1 : 0);

    // each lane evaluates thresholds lane, lane + 32, ... in order
    Best bl{-INFINITY, 0.f, 0.f, 0.f, 0};
    Best br{-INFINITY, 0.f, 0.f, 0.f, 0};
    Best bc{-INFINITY, 0.f, 0.f, 0.f, 0};
    for (int t = lane; t < FB; t += 32) {
      const float cg = scan[t], ch = scan[FB + t], cc = scan[2 * FB + t];
      if (!cat) {
        {  // default-left: the missing mass joins the left side
          const float lg = cg + eg, lh = ch + eh, lc = cc + ec;
          const float lh_eff = lh + kEpsilon;
          const bool valid = t <= left_tmax && left_ok;
          const float gain =
              valid ? variant_gain(p, pg, ph, pc, lg, lh_eff, lc, shift)
                    : -INFINITY;
          consider(bl, gain, t, lg, lh_eff, lc);
        }
        {
          const float lh_eff = ch + kEpsilon;
          const bool valid = t <= nb - 2 && right_ok;
          const float gain =
              valid ? variant_gain(p, pg, ph, pc, cg, lh_eff, cc, shift)
                    : -INFINITY;
          consider(br, gain, t, cg, lh_eff, cc);
        }
      } else {
        float vg, vh, vc;
        bin_at(t, vg, vh, vc);
        const float lh_eff = vh + kEpsilon;
        const float gain =
            t < used_bin ? variant_gain(p, pg, ph, pc, vg, lh_eff, vc, shift)
                         : -INFINITY;
        consider(bc, gain, t, vg, lh_eff, vc);
      }
    }
    warp_best(bl);
    warp_best(br);
    warp_best(bc);
    if (lane == 0) {
      // the lowest flat index of the JAX argmax over [left, right, cat]
      Best best = bl;
      int var = 0;
      if (br.gain > best.gain) { best = br; var = 1; }
      if (bc.gain > best.gain) { best = bc; var = 2; }
      if (best.gain == -INFINITY) {
        // no valid split: the JAX argmax lands on flat index 0, the
        // default-left variant at bin 0, whatever the feature's kind
        best.lg = scan[0] + eg;
        best.lh_eff = (scan[FB] + eh) + kEpsilon;
        best.lc = scan[2 * FB] + ec;
        best.thr = 0;
        var = 0;
      }
      const size_t at = (size_t)c * F + f;
      feat_gain[at] = best.gain > -INFINITY ? best.gain - shift : -INFINITY;
      float* const bt = best_tab + at * kBestWords;
      bt[0] = best.lg;
      bt[1] = best.lh_eff;
      bt[2] = best.lc;
      bt[3] = __int_as_float(best.thr);
      bt[4] = __int_as_float(var);
      __threadfence();
    }
  }

  // the last block of leaf c to finish picks the leaf's feature
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    s_last = atomicAdd(tickets + c, 1) == (int)gridDim.x - 1;
  }
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  const bool too_deep = p.max_depth > 0 && depth[c] + 1 > p.max_depth;
  float bg = -INFINITY;
  int bf = F;  // ties (and F gains of -inf) go to the lowest feature
  for (int e = threadIdx.x; e < F; e += blockDim.x) {
    float g = mask[e] ? __ldcg(feat_gain + (size_t)c * F + e) : -INFINITY;
    if (too_deep) g = -INFINITY;
    g = fminf(g, kGainClamp);
    if (g > bg || (g == bg && e < bf)) {
      bg = g;
      bf = e;
    }
  }
  for (int o = 16; o > 0; o >>= 1) {
    const float og = __shfl_down_sync(~0u, bg, o);
    const int of = __shfl_down_sync(~0u, bf, o);
    if (og > bg || (og == bg && of < bf)) {
      bg = og;
      bf = of;
    }
  }
  if (lane == 0) {
    s_gain[warp] = bg;
    s_feat[warp] = bf;
  }
  __syncthreads();
  if (threadIdx.x != 0) return;
  for (int w = 1; w < (int)blockDim.x / 32; ++w) {
    if (s_gain[w] > bg || (s_gain[w] == bg && s_feat[w] < bf)) {
      bg = s_gain[w];
      bf = s_feat[w];
    }
  }
  const float* bt = best_tab + ((size_t)c * F + bf) * kBestWords;
  const int var = __float_as_int(__ldcg(bt + 4));
  float* of = out_f + (size_t)c * 4;
  int* oi = out_i + (size_t)c * 4;
  of[0] = bg;
  of[1] = __ldcg(bt);
  of[2] = __ldcg(bt + 1) - kEpsilon;
  of[3] = __ldcg(bt + 2);
  oi[0] = bf;
  oi[1] = __float_as_int(__ldcg(bt + 3));
  oi[2] = var == 0;  // default_left
  oi[3] = var == 2;  // is_categorical
  tickets[c] = 0;    // for the next launch
}

}  // namespace

// hist [C, G, B, 3] f32; sums [C, 3] (g, h, count) of each leaf; depth
// [C]; feature metadata [F] (num_bin, missing_type, default_bin,
// is_categorical, group, offset, is_bundled, feature mask); FB: the
// per-feature scan width; per: features a block (ops/split.py
// split_plan). feat_gain [C, F] f32; out_f [C, 4] = (gain, left_sum_g,
// left_sum_h, left_count); out_i [C, 4] = (feature, threshold,
// default_left, is_categorical). Scratch: best_tab, C * F * 5 words;
// tickets, C int32 words, 0 before the launch and after it. FB <= 2048
// (the wrapper checks); cudaErrorInvalidValue when `per` warps' regions
// do not fit kSmemBudget.
extern "C" int lgbt_split_scan(
    const float* hist, int C, int G, int B, int F, int FB, int per,
    const float* sums, const int* depth, const int* num_bin,
    const int* missing, const int* default_bin, const uint8_t* is_cat,
    const int* group, const int* offset, const uint8_t* bundled,
    const uint8_t* mask, float l1, float l2, float min_gain_to_split,
    int min_data, float min_sum_hessian, int max_depth, float* best_tab,
    int* tickets, float* feat_gain, float* out_f, int* out_i,
    void* stream) {
  Params p{l1,       l2,        min_gain_to_split, min_sum_hessian,
           min_data, max_depth};
  const size_t smem = (size_t)per * region_words(FB) * sizeof(float);
  if (per < 1 || per > kMaxWarps || FB < 1 || F < 1 || C < 1 ||
      smem > kSmemBudget) {
    return (int)cudaErrorInvalidValue;
  }
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        split_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((F + per - 1) / per, C);
  split_scan_kernel<<<grid, per * 32, smem, (cudaStream_t)stream>>>(
      hist, G, B, F, FB, per, sums, depth, num_bin, missing, default_bin,
      is_cat, group, offset, bundled, mask, p, feat_gain, best_tab, tickets,
      out_f, out_i);
  return (int)cudaGetLastError();
}

extern "C" const char* lgbt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
