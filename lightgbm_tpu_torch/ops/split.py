"""Best-split finding: kernel S's wrapper and its plain PyTorch version.

Counterpart of `lightgbm_tpu/ops/split.py` `find_best_splits` (:80)
together with the per-leaf pick of `lightgbm_tpu/learner/grow.py`
`_extract_feature_hist` (:343) and `_leaf_best_split` (:367, serial
part): from a leaf's stored-group histogram, each feature's best
threshold over the default-left, default-right and one-vs-rest
categorical variants, then the best feature under the feature mask,
the max_depth guard and the 1e30 gain clamp. `leaf_split_gain` and
`leaf_output` are the reference's GetLeafSplitGain /
CalculateSplittedLeafOutput (feature_histogram.hpp:206-225).

Every gain is f32 arithmetic in the JAX package's operation order. The
plain version walks the bins in order like the kernel
(`csrc/split_scan.cu`), so the two agree bitwise. Both scan the bins
in the order of XLA's CPU cumsum (`xla_cumsum`), as the JAX package's
`jnp.cumsum` adds them. On dequantized histograms (quantized training),
whose bins equal the JAX package's bitwise, the scans and the child
totals taken from them equal the JAX package's bitwise. On f32
histograms, whose bins differ from XLA's in the last bits, a tie that
exact arithmetic makes (a bin that holds only rows of weight 0, as GOSS
and bagging leave many) is decided as the JAX package decides it; a
compensated scan, closer to the exact sums, decided such ties
otherwise. Against the JAX package the choice agrees wherever the top
two gains are apart by more than f32 round-off.

`split_scan` launches the kernel for CUDA tensors (or raises) and runs
the plain version for CPU tensors; it counts launches in
`split_scan.launches`.
"""
from __future__ import annotations

import ctypes
import threading
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..binning import MISSING_NAN, MISSING_NONE, MISSING_ZERO
from ..log import LightGBMError
from . import _build

K_EPSILON = 1e-15
GAIN_CLAMP = 1e30
_launch_lock = threading.Lock()

FMETA_KEYS = ("num_bin", "missing_type", "default_bin", "is_categorical",
              "group", "offset", "is_bundled")


def dequantize_hist(hist: torch.Tensor,
                    qscale: Optional[torch.Tensor]) -> torch.Tensor:
    """Quantized training's seam (lightgbm_tpu/ops/split.py:50): an int32
    histogram or total [..., 3] back in real units, `hist.float() *
    qscale` with the [3] scale (g_scale, h_scale, 1.0) of the quantizer;
    None (the f32 path) returns `hist` as it is."""
    if qscale is None:
        return hist
    return hist.to(torch.float32) * qscale


def leaf_split_gain(sum_g, sum_h, l1, l2):
    """Reference GetLeafSplitGain (feature_histogram.hpp:206-212), on
    tensors."""
    reg = torch.clamp(torch.abs(sum_g) - l1, min=0.0)
    return (reg * reg) / (sum_h + l2)


def leaf_output(sum_g, sum_h, l1, l2):
    """Reference CalculateSplittedLeafOutput (feature_histogram.hpp:
    220-225), in f32 on numpy scalars: -sign(g) * max(|g|-l1, 0) / (h+l2)."""
    g = np.float32(sum_g)
    reg = np.maximum(np.abs(g) - np.float32(l1), np.float32(0.0))
    return np.float32(-np.sign(g) * reg / (np.float32(sum_h)
                                           + np.float32(l2)))


@dataclass(frozen=True)
class SplitParams:
    lambda_l1: float
    lambda_l2: float
    min_gain_to_split: float
    min_data_in_leaf: int
    min_sum_hessian_in_leaf: float
    max_depth: int


def device_fmeta(fm: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    """Dataset.feature_meta_arrays() as the kernel's tensors: int32
    fields and uint8 flags on `device`."""
    out = {}
    for k in FMETA_KEYS:
        v = np.asarray(fm[k])
        dt = np.uint8 if v.dtype == bool else np.int32
        out[k] = torch.from_numpy(np.ascontiguousarray(v.astype(dt))).to(device)
    return out


def _const(x, like: torch.Tensor):
    return torch.tensor(x, dtype=like.dtype, device=like.device)


def _kahan(total, comp, v):
    """One compensated (Kahan) add, in the kernel's operation order."""
    y = v - comp
    t = total + y
    return t, (t - total) - y


# XLA's CPU backend rewrites the reduce_window that `jnp.cumsum` lowers
# to (ReduceWindowRewriter) into blocks of this many elements
XLA_SCAN_BASE = 16


def _sequential_cumsum(x: torch.Tensor) -> torch.Tensor:
    """Inclusive running sum along the last axis, one add at a time."""
    out = torch.empty_like(x)
    acc = torch.zeros_like(x[..., 0])
    for i in range(x.shape[-1]):
        acc = acc + x[..., i]
        out[..., i] = acc
    return out


def xla_cumsum(x: torch.Tensor) -> torch.Tensor:
    """`jnp.cumsum(x, axis=-1)` as XLA's CPU backend adds it, bit for
    bit: up to XLA_SCAN_BASE elements a running sum; past that the axis
    is zero-padded to blocks of XLA_SCAN_BASE, each block gets its own
    running sum, and each element then adds the running sum of the
    totals of the blocks before its own (an exclusive scan that is
    itself this function's order, for more than XLA_SCAN_BASE blocks)."""
    n = x.shape[-1]
    base = XLA_SCAN_BASE
    if n <= base:
        return _sequential_cumsum(x)
    nb = -(-n // base)
    xp = torch.nn.functional.pad(x, (0, nb * base - n))
    within = _sequential_cumsum(xp.reshape(*x.shape[:-1], nb, base))
    before = torch.nn.functional.pad(
        xla_cumsum(within[..., -1])[..., :-1], (1, 0))
    return (within + before[..., None]).reshape(
        *x.shape[:-1], nb * base)[..., :n]


def split_scan_plain(hist: torch.Tensor, sums: torch.Tensor,
                     depth: torch.Tensor, fmeta: Dict[str, torch.Tensor],
                     mask: torch.Tensor, params: SplitParams,
                     feature_bins: int
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The kernel's arithmetic in torch ops, vectorised over (leaf,
    feature) and walking the bins in order. Returns (out_f [C, 4] =
    gain, left_g, left_h, left_count; out_i [C, 4] = feature,
    threshold, default_left, is_categorical; feat_gain [C, F]). The
    arithmetic runs in hist's dtype: f32 is the kernel's, f64 an oracle."""
    dev, dt = hist.device, hist.dtype
    c_cnt, g_cnt, b_cnt, _ = hist.shape
    fb = int(feature_bins)
    sums = sums.to(dt)
    l1, l2 = _const(params.lambda_l1, hist), _const(params.lambda_l2, hist)
    min_gain = _const(params.min_gain_to_split, hist)
    min_hess = _const(params.min_sum_hessian_in_leaf, hist)
    min_data = _const(float(params.min_data_in_leaf), hist)
    eps, zero = _const(K_EPSILON, hist), _const(0.0, hist)
    ninf = _const(float("-inf"), hist)
    nb = fmeta["num_bin"].long()[None, :]                    # [1, F]
    mt = fmeta["missing_type"].long()[None, :]
    dbin = fmeta["default_bin"].long()[None, :]
    cat = (fmeta["is_categorical"] != 0)[None, :]
    bun = (fmeta["is_bundled"] != 0)[None, :]
    grp = fmeta["group"].long()
    off = fmeta["offset"].long()
    f_cnt = grp.shape[0]
    pg = sums[:, 0:1]
    ph_in = sums[:, 1:2]
    pc = sums[:, 2:3]
    ph = ph_in + 2.0 * eps
    shift = leaf_split_gain(pg, ph, l1, l2) + min_gain        # [C, 1]

    # the feature's bins t = 0..fb-1 out of its group, [C, F, fb, 3]
    t_idx = torch.arange(fb, device=dev)
    slot = (off[:, None] + t_idx[None, :]).clamp(max=b_cnt - 1)
    fh = hist[:, grp[:, None], slot]                          # [C,F,fb,3]
    in_range = (t_idx[None, :] < nb.t()).view(1, f_cnt, fb, 1)
    fh = torch.where(in_range, fh, zero)
    rest = torch.stack([pg, ph_in, pc], dim=-1)               # [C,1,3]
    acc = torch.zeros(c_cnt, f_cnt, 3, dtype=dt, device=dev)
    comp = torch.zeros_like(acc)
    for t in range(fb):
        acc, comp = _kahan(acc, comp, fh[:, :, t])
    rest = rest - acc
    fix = (bun.unsqueeze(-1) & (t_idx.view(1, 1, fb) == dbin.unsqueeze(-1))
           ).unsqueeze(-1)                                    # [1,F,fb,1]
    fh = torch.where(fix, rest.unsqueeze(2), fh)

    dual = (nb > 2) & (mt != MISSING_NONE)
    skip_default = dual & (mt == MISSING_ZERO)
    use_na = dual & (mt == MISSING_NAN)
    nan_bin = nb - 1
    e_bin = torch.where(use_na, nan_bin, dbin).clamp(0, fb - 1)
    extra = fh.gather(2, e_bin.view(1, f_cnt, 1, 1).expand(
        c_cnt, f_cnt, 1, 3)).squeeze(2)
    extra = torch.where((use_na | skip_default).unsqueeze(-1), extra, zero)
    right_ok = dual | ((mt == MISSING_NAN) & (nb <= 2))
    left_ok = dual | ~((mt == MISSING_NAN) & (nb <= 2))
    left_tmax = torch.where(use_na, nb - 3, nb - 2)
    used_bin = nb - 1 + (mt == MISSING_NONE).long()

    # the inclusive scans, bin by bin as the kernel carries them
    t_all = torch.arange(fb, device=dev).view(1, 1, fb)
    zero_all = ((skip_default.unsqueeze(-1) & (dbin.unsqueeze(-1) == t_all))
                | (use_na.unsqueeze(-1) & (nan_bin.unsqueeze(-1) == t_all)))
    adj = torch.where(zero_all.unsqueeze(-1), zero, fh)        # [C,F,fb,3]
    scan = xla_cumsum(adj.transpose(2, 3)).transpose(2, 3)

    # every threshold of every variant at once (elementwise, so the same
    # bits as the kernel's per-threshold evaluation)
    pg3, ph3, pc3 = pg.unsqueeze(-1), ph.unsqueeze(-1), pc.unsqueeze(-1)
    shift3 = shift.unsqueeze(-1)

    def variant(lg, lh_eff, lc, valid):
        rg, rh, rc = pg3 - lg, ph3 - lh_eff, pc3 - lc
        ok = (valid & (lc >= min_data) & (rc >= min_data)
              & (lh_eff >= min_hess) & (rh >= min_hess))
        gains = (leaf_split_gain(lg, lh_eff, l1, l2)
                 + leaf_split_gain(rg, rh, l1, l2))
        return torch.where(ok & (gains > shift3), gains, ninf)

    cat3 = cat.unsqueeze(-1)
    left = scan + extra.unsqueeze(2)
    cand = [  # (lg, lh_eff, lc, gains) per variant: left, right, cat
        (left[..., 0], left[..., 1] + eps, left[..., 2]),
        (scan[..., 0], scan[..., 1] + eps, scan[..., 2]),
        (fh[..., 0], fh[..., 1] + eps, fh[..., 2])]
    valid = [(left_tmax.unsqueeze(-1) >= t_all) & left_ok.unsqueeze(-1)
             & ~cat3,
             (nb.unsqueeze(-1) - 2 >= t_all) & right_ok.unsqueeze(-1) & ~cat3,
             (used_bin.unsqueeze(-1) > t_all) & cat3]
    best = []
    for (lg, lh_eff, lc), ok in zip(cand, valid):
        gains = variant(lg, lh_eff, lc, ok)
        # first maximal threshold, as the kernel's strict > keeps it
        t_best = torch.argmax(gains, dim=2, keepdim=True)
        best.append([gains.gather(2, t_best)[..., 0], t_best[..., 0],
                     lg.gather(2, t_best)[..., 0],
                     lh_eff.gather(2, t_best)[..., 0],
                     lc.gather(2, t_best)[..., 0]])
    first = (cand[0][0][..., 0], cand[0][1][..., 0], cand[0][2][..., 0])
    shape = (c_cnt, f_cnt)
    out = [x.clone() for x in best[0]]
    var = torch.zeros(shape, dtype=torch.long, device=dev)
    for v in (1, 2):
        up = best[v][0] > out[0]
        var = torch.where(up, v, var)
        out = [torch.where(up, b, o) for b, o in zip(best[v], out)]
    none = out[0] == float("-inf")
    var = torch.where(none, 0, var)
    out[1] = torch.where(none, 0, out[1])
    for k in range(3):
        out[2 + k] = torch.where(none, first[k], out[2 + k])
    feat_gain = torch.where(none, ninf, out[0] - shift)

    gains = torch.where(mask[None, :] != 0, feat_gain, ninf)
    if params.max_depth > 0:
        gains = torch.where((depth + 1 > params.max_depth)[:, None], ninf,
                            gains)
    gains = torch.clamp(gains, max=GAIN_CLAMP)
    bf = torch.argmax(torch.where(torch.isnan(gains), ninf, gains), dim=1)
    # torch.argmax returns the first maximal index, like the kernel
    pick = lambda a: a.gather(1, bf[:, None])[:, 0]           # noqa: E731
    out_f = torch.stack([pick(gains), pick(out[2]), pick(out[3]) - eps,
                         pick(out[4])], dim=1)
    out_i = torch.stack([bf, pick(out[1]), (pick(var) == 0).long(),
                         (pick(var) == 2).long()], dim=1).to(torch.int32)
    return out_f, out_i, feat_gain


def split_scan(hist: torch.Tensor, sums: torch.Tensor, depth: torch.Tensor,
               fmeta: Dict[str, torch.Tensor], mask: torch.Tensor,
               params: SplitParams, feature_bins: int,
               out: Optional[Tuple[torch.Tensor, torch.Tensor,
                                   torch.Tensor]] = None
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """S: the best split of each of the C leaves whose histograms
    [C, G, B, 3], totals [C, 3] (g, h, count) and depths [C] are given;
    see split_scan_plain for the outputs, which go into `out` (out_f,
    out_i, feat_gain: contiguous, those shapes and dtypes) when given."""
    c_cnt, g_cnt, b_cnt, three = hist.shape
    f_cnt = int(fmeta["num_bin"].shape[0])
    if three != 3 or sums.shape != (c_cnt, 3) or depth.shape != (c_cnt,):
        raise LightGBMError("split_scan takes hist [C, G, B, 3], sums "
                            "[C, 3] and depth [C]")
    if mask.shape != (f_cnt,) or f_cnt == 0:
        raise LightGBMError("split_scan: mask must have one entry per "
                            "feature, and there must be one feature")
    tensors = [hist, sums, depth, mask, *fmeta.values()]
    if any(t.device != hist.device for t in tensors):
        raise LightGBMError("split_scan: inputs on different devices")
    if out is not None:
        want = (((c_cnt, 4), torch.float32), ((c_cnt, 4), torch.int32),
                ((c_cnt, f_cnt), torch.float32))
        if any(tuple(t.shape) != shp or t.dtype != dt or t.device != hist.device
               or not t.is_contiguous() for t, (shp, dt) in zip(out, want)):
            raise LightGBMError("split_scan: out must be contiguous "
                                "(out_f [C, 4] f32, out_i [C, 4] int32, "
                                "feat_gain [C, F] f32) on %s" % hist.device)
    if hist.device.type == "cpu":
        res = split_scan_plain(hist, sums, depth, fmeta, mask, params,
                               feature_bins)
        if out is None:
            return res
        for dst, src in zip(out, res):
            dst.copy_(src)
        return out
    if hist.device.type != "cuda":
        raise LightGBMError("split_scan runs on cpu or cuda, not %s"
                            % hist.device)
    if hist.dtype != torch.float32 or sums.dtype != torch.float32 \
            or depth.dtype != torch.int32 or mask.dtype != torch.uint8:
        raise LightGBMError("split_scan takes f32 hist/sums, int32 depth "
                            "and a uint8 mask")
    if any(not t.is_contiguous() for t in tensors):
        raise LightGBMError("split_scan takes contiguous tensors")
    if feature_bins > XLA_SCAN_BASE ** 2:
        raise LightGBMError("split_scan: the XLA scan order takes at most "
                            "%d bins a feature (got %d)"
                            % (XLA_SCAN_BASE ** 2, feature_bins))
    lib = _build.load_library("split")
    dev = hist.device
    if out is None:
        out = (torch.empty((c_cnt, 4), dtype=torch.float32, device=dev),
               torch.empty((c_cnt, 4), dtype=torch.int32, device=dev),
               torch.empty((c_cnt, f_cnt), dtype=torch.float32, device=dev))
    out_f, out_i, feat_gain = out
    p = ctypes.c_void_p
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.lgbt_split_scan(
            p(hist.data_ptr()), c_cnt, g_cnt, b_cnt, f_cnt, int(feature_bins),
            p(sums.data_ptr()), p(depth.data_ptr()),
            *[p(fmeta[k].data_ptr()) for k in FMETA_KEYS],
            p(mask.data_ptr()), float(params.lambda_l1),
            float(params.lambda_l2), float(params.min_gain_to_split),
            int(params.min_data_in_leaf),
            float(params.min_sum_hessian_in_leaf), int(params.max_depth),
            p(feat_gain.data_ptr()), p(out_f.data_ptr()),
            p(out_i.data_ptr()), p(stream))
    if rc != 0:
        raise LightGBMError("split_scan launch failed: CUDA error %d (%s)"
                            % (rc, lib.lgbt_error_string(rc).decode()))
    with _launch_lock:
        split_scan.launches += 1
    return out_f, out_i, feat_gain


split_scan.launches = 0
