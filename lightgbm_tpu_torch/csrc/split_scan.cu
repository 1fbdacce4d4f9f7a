// Kernel S, split_scan, of lightgbm_tpu_torch: the best split of each of
// C leaves from its [G, B, 3] stored-group histogram, built for sm_90a
// by ops/_build.py and called through ctypes from ops/split.py.
//
// Replaces lightgbm_tpu/ops/split.py find_best_splits (:80) with the
// per-leaf pick of lightgbm_tpu/learner/grow.py _extract_feature_hist
// (:343) and _leaf_best_split (:367), serial part. Per (leaf, feature):
// - takes the feature's bins out of its group (EFB offset) and, for a
//   bundled feature, rebuilds the default bin as leaf totals minus the
//   other bins (FixHistogram, dataset.cpp:747-767);
// - scans the bins once, in bin order, for the inclusive sums of
//   (g, h, count) in the order of XLA's CPU cumsum, running sums over
//   blocks of 16 bins plus the running sum of the earlier blocks'
//   totals (ops/split.py xla_cumsum): on dequantized histograms
//   (quantized training) the scans equal the JAX package's bitwise, and
//   on f32 ones a tie that exact arithmetic makes is decided as the JAX
//   package decides it;
// - evaluates at each threshold the default-left and default-right
//   variants (split.py:117-174) and the one-vs-rest categorical variant
//   (split.py:176-195), with K_EPSILON on the parent and left hessians
//   and the min_data / min_sum_hessian guards;
// - keeps the first best of each variant and resolves ties left, then
//   right, then categorical: the lowest index of the JAX package's argmax
//   over [left(B), right(B), cat(B)] (split.py:197-205).
// Then thread 0 applies the feature mask, the max_depth guard and the
// 1e30 clamp and takes the lowest-index argmax over features
// (grow.py:386-393). One block per leaf, so both children of a split
// are scanned in one launch, and one warp per feature: its first lane
// carries the scans, then the 32 lanes evaluate the thresholds and a
// warp reduction keeps the first best. The leaf's histogram is first
// copied to shared memory (when it fits), so that lane's serial walk
// waits on shared memory, not on device memory.
//
// Arithmetic is f32 in the JAX package's order; the library is built
// with -fmad=false so no multiply-add is fused, which keeps the kernel
// bitwise equal to its plain version. Bound on an H100: C*G*B*12 bytes
// of histogram in (43 KB for two children of the main path, 0.00001 ms
// at 3.35 TB/s); the time is launch latency and the one lane's serial
// scan over B bins, a few microseconds.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kEpsilon = 1e-15f;
constexpr float kGainClamp = 1e30f;
constexpr int kMaxWarps = 16;
constexpr int kMissingNone = 0;
constexpr int kMissingZero = 1;
constexpr int kMissingNan = 2;

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

__global__ void __launch_bounds__(kMaxWarps * 32) split_scan_kernel(
    const float* __restrict__ hist, int G, int B, int F, int FB,
    const float* __restrict__ sums, const int* __restrict__ depth,
    const int* __restrict__ num_bin, const int* __restrict__ missing,
    const int* __restrict__ default_bin, const uint8_t* __restrict__ is_cat,
    const int* __restrict__ group, const int* __restrict__ offset,
    const uint8_t* __restrict__ bundled, const uint8_t* __restrict__ mask,
    Params p, int staged, float* __restrict__ feat_gain,
    float* __restrict__ out_f, int* __restrict__ out_i) {
  extern __shared__ float sgain[];
  const int c = blockIdx.x;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int warps = blockDim.x / 32;
  const float* h = hist + (size_t)c * G * B * 3;
  const float pg = sums[c * 3];
  const float ph_in = sums[c * 3 + 1];
  const float pc = sums[c * 3 + 2];
  const float ph = ph_in + 2.f * kEpsilon;
  const float shift = split_gain(pg, ph, p.l1, p.l2) + p.min_gain_to_split;
  // per feature: gain, lg, lh_eff, lc, thr, variant; then each warp's
  // inclusive scans of (g, h, count) over the bins
  float* s_lg = sgain + F;
  float* s_lh = s_lg + F;
  float* s_lc = s_lh + F;
  int* s_thr = reinterpret_cast<int*>(s_lc + F);
  int* s_var = s_thr + F;
  float* scan = reinterpret_cast<float*>(s_var + F) + warp * 3 * FB;
  if (staged) {
    // the leaf's histogram into shared memory, so the serial scans below
    // wait on shared, not device, memory
    float* s_hist = reinterpret_cast<float*>(s_var + F) + warps * 3 * FB;
    for (int e = threadIdx.x; e < G * B * 3; e += blockDim.x) {
      s_hist[e] = h[e];
    }
    __syncthreads();
    h = s_hist;
  }

  for (int f = warp; f < F; f += warps) {
    const int nb = num_bin[f], mt = missing[f], dbin = default_bin[f];
    const bool cat = is_cat[f] != 0;
    const float* gh = h + (size_t)group[f] * B * 3;
    const int off = offset[f];
    const bool bun = bundled[f] != 0;
    const bool dual = nb > 2 && mt != kMissingNone;
    const bool skip_default = dual && mt == kMissingZero;
    const bool use_na = dual && mt == kMissingNan;
    const int nan_bin = nb - 1;
    // FixHistogram default bin and the scans: one lane, in bin order
    float rest_g = 0.f, rest_h = 0.f, rest_c = 0.f;
    if (lane == 0) {
      if (bun) {
        float sg = 0.f, sh = 0.f, sc = 0.f, kg = 0.f, kh = 0.f, kc = 0.f;
        for (int t = 0; t < FB; ++t) {
          const float* v = gh + (size_t)(off + t) * 3;
          kahan_add(sg, kg, t < nb ? v[0] : 0.f);
          kahan_add(sh, kh, t < nb ? v[1] : 0.f);
          kahan_add(sc, kc, t < nb ? v[2] : 0.f);
        }
        rest_g = pg - sg;
        rest_h = ph_in - sh;
        rest_c = pc - sc;
      }
    }
    rest_g = __shfl_sync(~0u, rest_g, 0);
    rest_h = __shfl_sync(~0u, rest_h, 0);
    rest_c = __shfl_sync(~0u, rest_c, 0);
    // bin t of this feature (0 beyond num_bin; FixHistogram default)
    auto bin_at = [&](int t, float& bg, float& bh, float& bc) {
      if (t >= nb) {
        bg = bh = bc = 0.f;
      } else if (bun && t == dbin) {
        bg = rest_g;
        bh = rest_h;
        bc = rest_c;
      } else {
        const float* v = gh + (size_t)(off + t) * 3;
        bg = v[0];
        bh = v[1];
        bc = v[2];
      }
    };
    if (lane == 0) {
      // running sums within blocks of kXlaScanBase bins (rg, rh, rc),
      // plus the running sum of the finished blocks' totals (bg_, ...);
      // FB <= 256 (the wrapper checks), so at most 16 blocks, whose
      // totals XLA also adds one at a time
      float rg = 0.f, rh = 0.f, rc = 0.f, bg_ = 0.f, bh_ = 0.f, bc_ = 0.f;
      for (int t = 0; t < FB; ++t) {
        if (t > 0 && t % kXlaScanBase == 0) {
          bg_ = bg_ + rg;
          bh_ = bh_ + rh;
          bc_ = bc_ + rc;
          rg = rh = rc = 0.f;
        }
        float vg, vh, vc;
        bin_at(t, vg, vh, vc);
        const bool zero_it =
            (skip_default && t == dbin) || (use_na && t == nan_bin);
        rg = rg + (zero_it ? 0.f : vg);
        rh = rh + (zero_it ? 0.f : vh);
        rc = rc + (zero_it ? 0.f : vc);
        scan[t] = rg + bg_;
        scan[FB + t] = rh + bh_;
        scan[2 * FB + t] = rc + bc_;
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
      const float gain =
          best.gain > -INFINITY ? best.gain - shift : -INFINITY;
      feat_gain[(size_t)c * F + f] = gain;
      sgain[f] = gain;
      s_lg[f] = best.lg;
      s_lh[f] = best.lh_eff;
      s_lc[f] = best.lc;
      s_thr[f] = best.thr;
      s_var[f] = var;
    }
    __syncwarp();
  }
  __syncthreads();
  if (threadIdx.x != 0) return;
  const bool too_deep = p.max_depth > 0 && depth[c] + 1 > p.max_depth;
  int bf = 0;
  float bg = -INFINITY;
  for (int f = 0; f < F; ++f) {
    float g = mask[f] ? sgain[f] : -INFINITY;
    if (too_deep) g = -INFINITY;
    g = fminf(g, kGainClamp);
    if (f == 0 || g > bg) {
      bg = g;
      bf = f;
    }
  }
  float* of = out_f + (size_t)c * 4;
  int* oi = out_i + (size_t)c * 4;
  of[0] = bg;
  of[1] = s_lg[bf];
  of[2] = s_lh[bf] - kEpsilon;
  of[3] = s_lc[bf];
  oi[0] = bf;
  oi[1] = s_thr[bf];
  oi[2] = s_var[bf] == 0;  // default_left
  oi[3] = s_var[bf] == 2;  // is_categorical
}

}  // namespace

// hist [C, G, B, 3] f32; sums [C, 3] (g, h, count) of each leaf; depth
// [C]; feature metadata [F] (num_bin, missing_type, default_bin,
// is_categorical, group, offset, is_bundled, feature mask); FB: the
// per-feature scan width. feat_gain [C, F] f32; out_f [C, 4] = (gain,
// left_sum_g, left_sum_h, left_count); out_i [C, 4] = (feature,
// threshold, default_left, is_categorical). FB <= 256 (the wrapper
// checks).
extern "C" int lgbt_split_scan(
    const float* hist, int C, int G, int B, int F, int FB, const float* sums,
    const int* depth, const int* num_bin, const int* missing,
    const int* default_bin, const uint8_t* is_cat, const int* group,
    const int* offset, const uint8_t* bundled, const uint8_t* mask, float l1,
    float l2, float min_gain_to_split, int min_data, float min_sum_hessian,
    int max_depth, float* feat_gain, float* out_f,
    int* out_i, void* stream) {
  Params p{l1,       l2,        min_gain_to_split, min_sum_hessian,
           min_data, max_depth};
  // a warp per feature at a time; 16 warps of at most 128 registers a
  // thread fit the SM's 65,536 registers
  const int warps = F < kMaxWarps ? F : kMaxWarps;
  size_t smem = ((size_t)F * 6 + (size_t)warps * 3 * FB) * 4;
  const size_t hist_bytes = (size_t)G * B * 3 * 4;
  const int staged = smem + hist_bytes <= 160 * 1024;
  if (staged) smem += hist_bytes;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        split_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  split_scan_kernel<<<C, warps * 32, smem, (cudaStream_t)stream>>>(
      hist, G, B, F, FB, sums, depth, num_bin, missing, default_bin, is_cat,
      group, offset, bundled, mask, p, staged, feat_gain, out_f, out_i);
  return (int)cudaGetLastError();
}

extern "C" const char* lgbt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
