"""Leaf histograms: kernel H's wrapper, its plain PyTorch version, and
the sibling subtraction.

Counterpart of `lightgbm_tpu/ops/histogram.py` on the f32 path:
`leaf_histogram` (:333, all rows) and `gathered_leaves_histogram` (:474,
a compacted row list), plus `subtract` (:785). Both compute

    hist[g, b] = sum over rows r in the set
                 of 1[bin[r, g] == b] * (g_r*w_r, h_r*w_r, 1[w_r > 0])

from the channel matrix w3 = [N, 3] (g*w, h*w, w). The JAX package's
`batched_leaves_histogram` (:402) computes the same sum over the rows
whose `leaf_id` is one id; the serial grower keeps each leaf's rows
contiguous in its permutation, so it passes them as a row list.

Two modes of the g and h sums, as the JAX package's `bf16` argument
(`tpu_hist_bf16`, true by default) chooses them:
- f32 (`bf16=False`): the f32 values g*w and h*w are summed;
- hi+lo (`bf16=True`): each value v is split as `_hi_lo` (:52) splits
  it, hi = bf16(v) and lo = bf16(v - f32(hi)), rounded as XLA's CPU
  backend rounds (`hi_lo`); the hi and the lo halves are summed apart
  in f32 and added once, after all rows, into the [G, B, 3] histogram
  (`leaf_histogram` :379-396). hi + lo keeps about 16 bits of v, so the
  two modes grow different trees wherever a split is decided in the
  low bits, and the port grows the JAX package's under either setting.
The count channel is exact in both. Siblings subtract on the merged
histogram (`subtract`, :785).

On a CUDA tensor `leaf_histogram` launches the hand-written kernel
(`csrc/histogram.cu`) or raises; on a CPU tensor it runs the plain
version. The wrapper counts its launches in `leaf_histogram.launches`,
and those in hi+lo mode also in `leaf_histogram.launches_hilo`.

Quantized training (`tpu_hist_quantize=int8|int16`, the JAX section at
:60-156 and `_quant_u`/`_quant_merge` :291-330) adds two kernels:

- Q, `quantize_gradients` (`csrc/quantize.cu`): the gradients and
  hessians, scaled by their absolute maxima and stochastically rounded
  with JAX's threefry stream (`ops/rng.py`) to integer codes in
  [-qmax, qmax], the 0/1 in-bag weight and the [3] dequantization scale;
- HQ, `leaf_histogram_i32` (`csrc/histogram.cu`): the [G, B, 3] int32
  histogram (sum q_g*w01, sum q_h*w01, sum w01) of those codes. The TPU
  splits int16 codes into base-256 bf16 digits so its matrix unit sums
  them exactly and merges the digits in int32; integer sums do not
  depend on their order, so the port's histogram equals the merged JAX
  one bitwise. Siblings subtract in int32 through `subtract`.

Linear trees add kernel LM, `leaf_moments` (`csrc/moments.cu`): per
(leaf id, feature, bin) the raw-value moments (sum x*m, sum x^2*m, sum
x*g*m, sum x*h*m) of the rows whose leaf id is one of C ids: the JAX
package's `batched_leaves_moments` (:679), the mode `linear/stats.py`
runs and sums over bins. Its all-rows `leaf_moments` (:622) is one id
over a constant leaf_id; its row-list `gathered_leaves_moments` (:726)
has no caller there.
"""
from __future__ import annotations

import ctypes
import threading
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..log import LightGBMError
from . import _build
from .rng import Key, uniform

_launch_lock = threading.Lock()


def _check(binned, w3, num_bins, rows, n_rows):
    if binned.dim() != 2 or w3.shape != (binned.shape[0], 3):
        raise LightGBMError("leaf_histogram takes binned [N, G] and w3 "
                            "[N, 3] (got %s and %s)"
                            % (tuple(binned.shape), tuple(w3.shape)))
    if w3.dtype != torch.float32:
        raise LightGBMError("leaf_histogram takes f32 channels")
    if rows is not None and (n_rows is None or n_rows > rows.shape[0]):
        raise LightGBMError("leaf_histogram: a row list needs n_rows <= "
                            "its length")
    tensors = [t for t in (binned, w3, rows) if t is not None]
    if any(t.device != binned.device for t in tensors):
        raise LightGBMError("leaf_histogram: inputs on different devices")
    if num_bins < 1:
        raise LightGBMError("leaf_histogram: num_bins must be >= 1")


_F32_MIN_NORMAL = float(np.finfo(np.float32).tiny)


def flush_subnormal(x: torch.Tensor) -> torch.Tensor:
    """An f32 subnormal as the zero of its sign, as XLA's CPU backend
    reads and writes them in arithmetic."""
    return torch.where(x.abs() < _F32_MIN_NORMAL, x * 0.0, x)


def bf16_round(x: torch.Tensor) -> torch.Tensor:
    """f32 -> bf16 -> f32 as XLA's CPU `convert` rounds: to nearest, ties
    to even, subnormals kept, overflow to inf, and a NaN to the quiet NaN
    of its sign (0x7fc0 or 0xffc0). In integer ops, so it gives the same
    bits on every device."""
    u = x.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    r = (u + 0x7FFF + ((u >> 16) & 1)) & 0xFFFF0000
    r = torch.where(torch.isnan(x), (u & 0x80000000) | 0x7FC00000, r)
    return torch.where(r >= 2 ** 31, r - 2 ** 32, r).to(torch.int32).view(
        torch.float32)


def hi_lo(w: torch.Tensor):
    """lightgbm_tpu/ops/histogram.py `_hi_lo` (:52) as XLA's CPU backend
    computes it: hi = bf16(w), lo = bf16(w - f32(hi)), the subtraction
    reading subnormal operands as zero and flushing a subnormal
    difference to the zero of its sign. Both as f32 values."""
    hi = bf16_round(w)
    lo = bf16_round(flush_subnormal(flush_subnormal(w)
                                    - flush_subnormal(hi)))
    return hi, lo


def leaf_histogram_plain(binned: torch.Tensor, w3: torch.Tensor,
                         num_bins: int, rows: Optional[torch.Tensor] = None,
                         n_rows: Optional[int] = None,
                         bf16: bool = False) -> torch.Tensor:
    """[G, B, 3] by index_add over the flattened (group, bin) axis,
    summed in f64 and rounded to f32 once: within f32 round-off of the
    kernel's f32 sums, whichever order either takes. Counts are exact.
    With `bf16` the hi and lo halves of g and h are summed apart, each
    rounded to f32, and added in f32."""
    g_cnt = binned.shape[1]
    if rows is not None:
        sel = rows[:n_rows].long()
        bins, w = binned[sel], w3[sel]
    else:
        bins, w = binned, w3
    cnt = (w[:, 2] > 0).to(torch.float32)
    if bf16:
        hi, lo = hi_lo(w[:, :2].contiguous())
        chans = torch.cat([hi, cnt[:, None], lo], dim=1)
    else:
        chans = torch.stack([w[:, 0], w[:, 1], cnt], dim=1)
    c = chans.shape[1]
    flat = (torch.arange(g_cnt, device=binned.device) * num_bins)[None, :] \
        + bins.long()
    vals = chans[:, None, :].expand(-1, g_cnt, c).reshape(-1, c)
    h = torch.zeros(g_cnt * num_bins, c, dtype=torch.float64,
                    device=binned.device)
    h.index_add_(0, flat.reshape(-1), vals.double())
    h = h.float()
    if bf16:
        h = torch.cat([h[:, :2] + h[:, 3:], h[:, 2:3]], dim=1)
    return h.view(g_cnt, num_bins, 3)


def leaf_histogram(binned: torch.Tensor, w3: torch.Tensor, num_bins: int,
                   rows: Optional[torch.Tensor] = None,
                   n_rows: Optional[int] = None,
                   out: Optional[torch.Tensor] = None,
                   bf16: bool = False) -> torch.Tensor:
    """H: the [G, B, 3] f32 histogram of the rows 0..N-1, or of
    rows[:n_rows]; written into `out` (contiguous, that shape) when
    given; g and h summed in hi+lo halves when `bf16`."""
    _check(binned, w3, num_bins, rows, n_rows)
    shape = (binned.shape[1], num_bins, 3)
    if out is not None and (tuple(out.shape) != shape
                            or out.dtype != torch.float32
                            or not out.is_contiguous()
                            or out.device != binned.device):
        raise LightGBMError("leaf_histogram: out must be a contiguous f32 "
                            "%s tensor on %s" % (shape, binned.device))
    if binned.device.type == "cpu":
        hist = leaf_histogram_plain(binned, w3, num_bins, rows, n_rows,
                                    bf16)
        return hist if out is None else out.copy_(hist)
    if binned.device.type != "cuda":
        raise LightGBMError("leaf_histogram runs on cpu or cuda, not %s"
                            % binned.device)
    if binned.dtype != torch.uint8 or num_bins > 256:
        raise LightGBMError("the leaf_histogram kernel takes uint8 bins "
                            "(at most 256 a group)")
    for t in (binned, w3, rows):
        if t is not None and not t.is_contiguous():
            raise LightGBMError("leaf_histogram takes contiguous tensors")
    if rows is not None and rows.dtype != torch.int32:
        raise LightGBMError("leaf_histogram takes int32 rows")
    n = binned.shape[0] if rows is None else int(n_rows)
    g_cnt = binned.shape[1]
    lib = _build.load_library("histogram")
    tiles = lib.lgbt_hist_tiles(n)
    scratch = torch.empty((5 if bf16 else 3) * tiles * g_cnt * num_bins,
                          dtype=torch.float32, device=binned.device)
    if out is None:
        out = torch.empty(shape, dtype=torch.float32, device=binned.device)

    def ptr(t):
        return ctypes.c_void_p(None if t is None else t.data_ptr())

    with torch.cuda.device(binned.device):
        stream = torch.cuda.current_stream(binned.device).cuda_stream
        rc = lib.lgbt_leaf_histogram(
            ptr(binned), g_cnt, ptr(w3), ptr(rows), n, num_bins,
            int(bool(bf16)), ptr(scratch), ptr(out), ctypes.c_void_p(stream))
    if rc != 0:
        raise LightGBMError("leaf_histogram launch failed: CUDA error %d "
                            "(%s)" % (rc, lib.lgbt_error_string(rc).decode()))
    with _launch_lock:
        leaf_histogram.launches += 1
        if bf16:
            leaf_histogram.launches_hilo += 1
    return out


# all launches of H, and those in hi+lo mode among them
leaf_histogram.launches = 0
leaf_histogram.launches_hilo = 0


def subtract(parent: torch.Tensor, child: torch.Tensor,
             out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Larger-child histogram = parent - smaller child, into `out` when
    given (lightgbm_tpu/ops/histogram.py:785; reference
    FeatureHistogram::Subtract, feature_histogram.hpp:64-70)."""
    return torch.sub(parent, child, out=out)


# ---------------------------------------------------------------------------
# quantized-gradient training (tpu_hist_quantize)
# ---------------------------------------------------------------------------

TRAIN_QUANTIZE_MODES = ("none", "int16", "int8")

_TRAIN_QMAX = {"int8": 127, "int16": 32767}

# scale floor of an all-zero gradient vector (lightgbm_tpu/ops/
# histogram.py _SCALE_FLOOR)
_SCALE_FLOOR = 1e-30


def train_qmax(mode: str, n: int) -> int:
    """The clip magnitude of quantized training at n rows
    (lightgbm_tpu/ops/histogram.py:75-92): a bin holding every row at
    full magnitude must stay below 2^31 in int32, qmax * n < 2^31, with
    the JAX package's 256 of headroom for its int16 digit carry."""
    cap = (2 ** 31 - 1) // max(1, int(n)) - 256
    return max(1, min(_TRAIN_QMAX[mode], cap))


class QuantGradients(NamedTuple):
    """Q's outputs: codes [N, 2] int16 (q_g, q_h), w01 [N] f32 (the 0/1
    in-bag weight) and qscale [3] f32 (g_scale, h_scale, 1.0)."""
    codes: torch.Tensor
    w01: torch.Tensor
    qscale: torch.Tensor


def stochastic_round(x: torch.Tensor, key: Key) -> torch.Tensor:
    """floor(x) + (u < x - floor(x)) with u = uniform(key, (n,)), f32
    (lightgbm_tpu/ops/histogram.py:105; the port has no padding rows)."""
    u = uniform(key, x.shape[0], x.device)
    f = torch.floor(x)
    return f + (u < (x - f)).to(torch.float32)


def quantize_gradients_plain(grad: torch.Tensor, hess: torch.Tensor,
                             row_weight: torch.Tensor, qmax: int,
                             key_g: Key, key_h: Key,
                             hess_const: bool = False) -> QuantGradients:
    """lightgbm_tpu/ops/histogram.py:127-156 in the same f32 operations.
    The constants are 0-dim tensors on the inputs' device: PyTorch
    divides a CUDA tensor by a host scalar as a multiply by its
    reciprocal, which is not the quotient JAX computes."""
    dev = grad.device
    qm = torch.tensor(float(qmax), dtype=torch.float32, device=dev)
    floor = torch.tensor(_SCALE_FLOOR, dtype=torch.float32, device=dev)
    w01 = (row_weight > 0).to(torch.float32)
    gw = grad * row_weight
    hw = hess * row_weight
    g_scale = torch.maximum(gw.abs().max(), floor) / qm
    h_scale = torch.maximum(hw.abs().max(), floor) / qm
    q_g = torch.clamp(stochastic_round(gw / g_scale, key_g), -qm, qm)
    if hess_const:
        q_h = qm * w01
    else:
        q_h = torch.clamp(stochastic_round(hw / h_scale, key_h), -qm, qm)
    codes = torch.stack([q_g, q_h], 1).to(torch.int16)
    qscale = torch.stack([g_scale, h_scale, torch.ones_like(g_scale)])
    return QuantGradients(codes, w01, qscale)


def quantize_gradients(grad: torch.Tensor, hess: torch.Tensor,
                       row_weight: torch.Tensor, *, qmax: int, key_g: Key,
                       key_h: Key, hess_const: bool = False
                       ) -> QuantGradients:
    """Q: one iteration's gradients and hessians [N] f32 with the row
    weight [N] f32 folded in (gw = grad * w) as integer codes, the 0/1
    in-bag weight and the dequantization scale, all on the inputs'
    device (no host read). With `hess_const` q_h = qmax * w01 exactly and
    takes no draw."""
    n = grad.shape[0]
    for t in (grad, hess, row_weight):
        if t.shape != (n,) or t.dtype != torch.float32:
            raise LightGBMError("quantize_gradients takes f32 [N] grad, "
                                "hess and row weight")
        if t.device != grad.device:
            raise LightGBMError("quantize_gradients: inputs on different "
                                "devices")
    if not 1 <= qmax <= 32767:
        raise LightGBMError("quantize_gradients: qmax must be in "
                            "[1, 32767] (got %d)" % qmax)
    if grad.device.type == "cpu":
        return quantize_gradients_plain(grad, hess, row_weight, qmax,
                                        key_g, key_h, hess_const)
    if grad.device.type != "cuda":
        raise LightGBMError("quantize_gradients runs on cpu or cuda, not %s"
                            % grad.device)
    if not all(t.is_contiguous() for t in (grad, hess, row_weight)):
        raise LightGBMError("quantize_gradients takes contiguous tensors")
    dev = grad.device
    codes = torch.empty((n, 2), dtype=torch.int16, device=dev)
    w01 = torch.empty(n, dtype=torch.float32, device=dev)
    qscale = torch.empty(3, dtype=torch.float32, device=dev)
    scratch = torch.empty(2, dtype=torch.int32, device=dev)
    lib = _build.load_library("quantize")

    def ptr(t):
        return ctypes.c_void_p(t.data_ptr())

    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.lgbt_quantize_gradients(
            ptr(grad), ptr(hess), ptr(row_weight), n, qmax, key_g[0],
            key_g[1], key_h[0], key_h[1], int(bool(hess_const)),
            ptr(scratch), ptr(codes), ptr(w01), ptr(qscale),
            ctypes.c_void_p(stream))
    if rc != 0:
        raise LightGBMError("quantize_gradients launch failed: CUDA error "
                            "%d (%s)" % (rc, lib.lgbt_error_string(rc)
                                         .decode()))
    with _launch_lock:
        quantize_gradients.launches += 1
    return QuantGradients(codes, w01, qscale)


quantize_gradients.launches = 0


def _check_i32(binned, codes, w01, num_bins, rows, n_rows):
    n = binned.shape[0]
    if binned.dim() != 2 or codes.shape != (n, 2) or w01.shape != (n,):
        raise LightGBMError("leaf_histogram_i32 takes binned [N, G], codes "
                            "[N, 2] and w01 [N] (got %s, %s and %s)"
                            % (tuple(binned.shape), tuple(codes.shape),
                               tuple(w01.shape)))
    if codes.dtype != torch.int16 or w01.dtype != torch.float32:
        raise LightGBMError("leaf_histogram_i32 takes int16 codes and f32 "
                            "w01")
    if rows is not None and (n_rows is None or n_rows > rows.shape[0]):
        raise LightGBMError("leaf_histogram_i32: a row list needs n_rows "
                            "<= its length")
    tensors = [t for t in (binned, codes, w01, rows) if t is not None]
    if any(t.device != binned.device for t in tensors):
        raise LightGBMError("leaf_histogram_i32: inputs on different "
                            "devices")
    if num_bins < 1:
        raise LightGBMError("leaf_histogram_i32: num_bins must be >= 1")


def leaf_histogram_i32_plain(binned: torch.Tensor, codes: torch.Tensor,
                             w01: torch.Tensor, num_bins: int,
                             rows: Optional[torch.Tensor] = None,
                             n_rows: Optional[int] = None) -> torch.Tensor:
    """[G, B, 3] int32 by an int64 index_add over the flattened (group,
    bin) axis."""
    g_cnt = binned.shape[1]
    if rows is not None:
        sel = rows[:n_rows].long()
        bins, q, w = binned[sel], codes[sel], w01[sel]
    else:
        bins, q, w = binned, codes, w01
    c = (w > 0).to(torch.int64)
    chans = torch.stack([q[:, 0].long() * c, q[:, 1].long() * c, c], 1)
    flat = (torch.arange(g_cnt, device=binned.device) * num_bins)[None, :] \
        + bins.long()
    vals = chans[:, None, :].expand(-1, g_cnt, 3).reshape(-1, 3)
    h = torch.zeros(g_cnt * num_bins, 3, dtype=torch.int64,
                    device=binned.device)
    h.index_add_(0, flat.reshape(-1), vals)
    return h.to(torch.int32).view(g_cnt, num_bins, 3)


def leaf_histogram_i32(binned: torch.Tensor, codes: torch.Tensor,
                       w01: torch.Tensor, num_bins: int,
                       rows: Optional[torch.Tensor] = None,
                       n_rows: Optional[int] = None,
                       out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """HQ: the [G, B, 3] int32 histogram (sum q_g*w01, sum q_h*w01, sum
    w01) of the rows 0..N-1, or of rows[:n_rows]; written into `out`
    (contiguous, that shape) when given. The caller keeps qmax * N below
    2^31 (`train_qmax`), so no sum overflows."""
    _check_i32(binned, codes, w01, num_bins, rows, n_rows)
    shape = (binned.shape[1], num_bins, 3)
    if out is not None and (tuple(out.shape) != shape
                            or out.dtype != torch.int32
                            or not out.is_contiguous()
                            or out.device != binned.device):
        raise LightGBMError("leaf_histogram_i32: out must be a contiguous "
                            "int32 %s tensor on %s" % (shape, binned.device))
    if binned.device.type == "cpu":
        hist = leaf_histogram_i32_plain(binned, codes, w01, num_bins, rows,
                                        n_rows)
        return hist if out is None else out.copy_(hist)
    if binned.device.type != "cuda":
        raise LightGBMError("leaf_histogram_i32 runs on cpu or cuda, not %s"
                            % binned.device)
    if binned.dtype != torch.uint8 or num_bins > 256:
        raise LightGBMError("the leaf_histogram_i32 kernel takes uint8 bins "
                            "(at most 256 a group)")
    for t in (binned, codes, w01, rows):
        if t is not None and not t.is_contiguous():
            raise LightGBMError("leaf_histogram_i32 takes contiguous "
                                "tensors")
    if rows is not None and rows.dtype != torch.int32:
        raise LightGBMError("leaf_histogram_i32 takes int32 rows")
    n = binned.shape[0] if rows is None else int(n_rows)
    lib = _build.load_library("histogram")
    if out is None:
        out = torch.empty(shape, dtype=torch.int32, device=binned.device)

    def ptr(t):
        return ctypes.c_void_p(None if t is None else t.data_ptr())

    with torch.cuda.device(binned.device):
        stream = torch.cuda.current_stream(binned.device).cuda_stream
        rc = lib.lgbt_leaf_histogram_i32(
            ptr(binned), binned.shape[1], ptr(codes), ptr(w01), ptr(rows),
            n, num_bins, ptr(out), ctypes.c_void_p(stream))
    if rc != 0:
        raise LightGBMError("leaf_histogram_i32 launch failed: CUDA error "
                            "%d (%s)" % (rc, lib.lgbt_error_string(rc)
                                         .decode()))
    with _launch_lock:
        leaf_histogram_i32.launches += 1
    return out


leaf_histogram_i32.launches = 0


# ---------------------------------------------------------------------------
# per-bin raw-feature moments (linear trees; lightgbm_tpu/linear/stats.py)
# ---------------------------------------------------------------------------

def leaf_moments_plain(binned: torch.Tensor, x: torch.Tensor,
                       w3: torch.Tensor, num_bins: int,
                       leaf_id: torch.Tensor,
                       ids: torch.Tensor) -> torch.Tensor:
    """[C, F, B, 4] by an f64 index_add over the flattened (id, feature,
    bin) axis of the f32 terms (x*m, (x*x)*m, x*(g*m), x*(h*m)), rounded
    to f32 once."""
    f_cnt = binned.shape[1]
    c_cnt = ids.shape[0]
    match = leaf_id.long()[:, None] == ids.long()[None, :]
    hit = match.any(dim=1)
    sel = torch.nonzero(hit)[:, 0]
    slot = match[hit].int().argmax(dim=1)
    xv = x[sel]
    xv = torch.where(torch.isfinite(xv), xv, torch.zeros_like(xv))
    w = w3[sel]
    gm, hm, m = w[:, 0:1], w[:, 1:2], w[:, 2:3]
    terms = torch.stack([xv * m, (xv * xv) * m, xv * gm, xv * hm], dim=-1)
    flat = (slot[:, None] * f_cnt
            + torch.arange(f_cnt, device=binned.device)[None, :]) \
        * num_bins + binned[sel].long()
    keep = binned[sel].long() < num_bins
    out = torch.zeros((c_cnt * f_cnt * num_bins, 4), dtype=torch.float64,
                      device=binned.device)
    out.index_add_(0, flat[keep], terms[keep].to(torch.float64))
    return out.float().view(c_cnt, f_cnt, num_bins, 4)


def leaf_moments(binned: torch.Tensor, x: torch.Tensor, w3: torch.Tensor,
                 num_bins: int, leaf_id: torch.Tensor,
                 ids: torch.Tensor) -> torch.Tensor:
    """LM: the [C, F, B, 4] f32 moments (sum x*m, sum x^2*m, sum x*g*m,
    sum x*h*m) per (leaf id, feature, bin) of the rows whose leaf_id [N]
    is ids[c]. binned [N, F] holds per-feature bins and x [N, F] the raw
    values aligned with them (the caller resolves EFB); w3 [N, 3] =
    (g*m, h*m, m); a non-finite x adds nothing; the ids are distinct.
    All rows are one id over a constant leaf_id. Counterpart of lightgbm_tpu/ops/histogram.py
    batched_leaves_moments (:679)."""
    n, f_cnt = binned.shape
    if x.shape != (n, f_cnt) or w3.shape != (n, 3) \
            or leaf_id.shape != (n,) or ids.dim() != 1:
        raise LightGBMError("leaf_moments takes binned and x [N, F], w3 "
                            "[N, 3], leaf_id [N] and ids [C]")
    tensors = (binned, x, w3, leaf_id, ids)
    if any(t.device != binned.device for t in tensors):
        raise LightGBMError("leaf_moments: inputs on different devices")
    ids_host = ids.cpu().numpy()
    if len(np.unique(ids_host)) != len(ids_host):
        raise LightGBMError("leaf_moments takes distinct ids")
    if binned.device.type == "cpu":
        return leaf_moments_plain(binned, x, w3, num_bins, leaf_id, ids)
    if binned.device.type != "cuda":
        raise LightGBMError("leaf_moments runs on cpu or cuda, not %s"
                            % binned.device)
    if binned.dtype != torch.uint8 or not 1 <= num_bins <= 256 \
            or x.dtype != torch.float32 or w3.dtype != torch.float32:
        raise LightGBMError("the leaf_moments kernel takes uint8 bins (at "
                            "most 256), f32 x and f32 w3")
    if not all(t.is_contiguous() for t in tensors):
        raise LightGBMError("leaf_moments takes contiguous tensors")
    if leaf_id.dtype != torch.int32 or ids.dtype != torch.int32:
        raise LightGBMError("leaf_moments takes int32 leaf ids and ids")
    c_cnt = len(ids_host)
    dev = binned.device
    lib = _build.load_library("moments")
    out = torch.empty((c_cnt, f_cnt, num_bins, 4), dtype=torch.float32,
                      device=dev)
    # the rows sorted by slot (the c with ids[c] == leaf_id[r]), then each
    # slot's segment cut into tiles
    begin = np.zeros(c_cnt + 1, np.int64)
    order = torch.empty(max(n, 1), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)
        sort_t = lib.lgbt_moment_sort_tiles(n, c_cnt)
        if sort_t and c_cnt:
            by_id = np.argsort(ids_host, kind="stable")
            keys = torch.from_numpy(np.concatenate(
                [ids_host[by_id], by_id]).astype(np.int32)).to(dev)
            work = torch.empty(n + c_cnt * sort_t + c_cnt + 1,
                               dtype=torch.int32, device=dev)
            starts = work[n + c_cnt * sort_t:]
            _moments_ok(lib.lgbt_moment_sort(
                _ptr(leaf_id), n, _ptr(keys), _ptr(keys[c_cnt:]), c_cnt,
                sort_t, _ptr(work), _ptr(work[n:]), _ptr(starts),
                _ptr(order), stream), lib)
            begin = starts.cpu().numpy().astype(np.int64)
        meta, n_tiles = segment_tiles(begin[:-1], np.diff(begin),
                                      lib.lgbt_moment_tile_rows())
        meta = torch.from_numpy(meta).to(dev)
        part = torch.empty(max(n_tiles, 1) * f_cnt * num_bins * 4,
                           dtype=torch.float32, device=dev)
        _moments_ok(lib.lgbt_leaf_moments(
            _ptr(binned), f_cnt, _ptr(x), _ptr(w3), _ptr(order), _ptr(meta),
            n_tiles, _ptr(meta[3 * n_tiles:]),
            _ptr(meta[3 * n_tiles + c_cnt:]), c_cnt, num_bins, _ptr(part),
            _ptr(out), stream), lib)
    with _launch_lock:
        leaf_moments.launches += 1
    return out


def segment_tiles(begin: np.ndarray, rows: np.ndarray, tile: int):
    """Cut each of the C segments (begin[c], rows[c]) of a row sequence
    into tiles of at most `tile` rows, segment by segment. Returns the
    int32 array [(segment, first position, rows) per tile..., each
    segment's first tile [C], its tile count [C]] and the tile count."""
    rows = np.asarray(rows, np.int64)
    count = (rows + tile - 1) // tile
    first = np.concatenate([[0], np.cumsum(count)[:-1]]).astype(np.int64)
    of = np.repeat(np.arange(len(rows)), count)
    step = (np.arange(len(of)) - first[of]) * tile
    tiles = np.stack([of, np.asarray(begin, np.int64)[of] + step,
                      np.minimum(tile, rows[of] - step)], 1)
    return (np.concatenate([tiles.reshape(-1), first, count]).astype(
        np.int32), len(of))


def _ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def _moments_ok(rc: int, lib) -> None:
    if rc != 0:
        raise LightGBMError("leaf_moments launch failed: CUDA error %d (%s)"
                            % (rc, lib.lgbt_error_string(rc).decode()))


leaf_moments.launches = 0
