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
contiguous in its permutation, so it passes them as a row list. The
JAX package contracts a one-hot in bf16 hi+lo halves by default
(`tpu_hist_bf16`); the port accumulates in f32 and counts in integers,
so it takes that key and ignores it.

On a CUDA tensor `leaf_histogram` launches the hand-written kernel
(`csrc/histogram.cu`) or raises; on a CPU tensor it runs the plain
version. The wrapper counts its launches in `leaf_histogram.launches`.
"""
from __future__ import annotations

import ctypes
import threading
from typing import Optional

import torch

from ..log import LightGBMError
from . import _build

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


def leaf_histogram_plain(binned: torch.Tensor, w3: torch.Tensor,
                         num_bins: int, rows: Optional[torch.Tensor] = None,
                         n_rows: Optional[int] = None) -> torch.Tensor:
    """[G, B, 3] by index_add over the flattened (group, bin) axis,
    summed in f64 and rounded to f32 once: within f32 round-off of the
    kernel's f32 sums, whichever order either takes. Counts are exact."""
    g_cnt = binned.shape[1]
    if rows is not None:
        sel = rows[:n_rows].long()
        bins, w = binned[sel], w3[sel]
    else:
        bins, w = binned, w3
    chans = torch.stack([w[:, 0], w[:, 1],
                         (w[:, 2] > 0).to(torch.float32)], dim=1)
    flat = (torch.arange(g_cnt, device=binned.device) * num_bins)[None, :] \
        + bins.long()
    vals = chans[:, None, :].expand(-1, g_cnt, 3).reshape(-1, 3)
    h = torch.zeros(g_cnt * num_bins, 3, dtype=torch.float64,
                    device=binned.device)
    h.index_add_(0, flat.reshape(-1), vals.double())
    return h.float().view(g_cnt, num_bins, 3)


def leaf_histogram(binned: torch.Tensor, w3: torch.Tensor, num_bins: int,
                   rows: Optional[torch.Tensor] = None,
                   n_rows: Optional[int] = None,
                   out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """H: the [G, B, 3] f32 histogram of the rows 0..N-1, or of
    rows[:n_rows]; written into `out` (contiguous, that shape) when
    given."""
    _check(binned, w3, num_bins, rows, n_rows)
    shape = (binned.shape[1], num_bins, 3)
    if out is not None and (tuple(out.shape) != shape
                            or out.dtype != torch.float32
                            or not out.is_contiguous()
                            or out.device != binned.device):
        raise LightGBMError("leaf_histogram: out must be a contiguous f32 "
                            "%s tensor on %s" % (shape, binned.device))
    if binned.device.type == "cpu":
        hist = leaf_histogram_plain(binned, w3, num_bins, rows, n_rows)
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
    scratch = torch.empty(3 * tiles * g_cnt * num_bins,
                          dtype=torch.float32, device=binned.device)
    if out is None:
        out = torch.empty(shape, dtype=torch.float32, device=binned.device)

    def ptr(t):
        return ctypes.c_void_p(None if t is None else t.data_ptr())

    with torch.cuda.device(binned.device):
        stream = torch.cuda.current_stream(binned.device).cuda_stream
        rc = lib.lgbt_leaf_histogram(
            ptr(binned), g_cnt, ptr(w3), ptr(rows), n, num_bins,
            ptr(scratch), ptr(out), ctypes.c_void_p(stream))
    if rc != 0:
        raise LightGBMError("leaf_histogram launch failed: CUDA error %d "
                            "(%s)" % (rc, lib.lgbt_error_string(rc).decode()))
    with _launch_lock:
        leaf_histogram.launches += 1
    return out


leaf_histogram.launches = 0


def subtract(parent: torch.Tensor, child: torch.Tensor,
             out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Larger-child histogram = parent - smaller child, into `out` when
    given (lightgbm_tpu/ops/histogram.py:785; reference
    FeatureHistogram::Subtract, feature_histogram.hpp:64-70)."""
    return torch.sub(parent, child, out=out)
