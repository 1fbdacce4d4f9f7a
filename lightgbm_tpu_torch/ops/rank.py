"""Pairwise lambdarank gradients: kernel L's wrapper and its plain
PyTorch version.

Counterpart of `lightgbm_tpu/objectives.py` `_lambdarank_pair_grads`
(:438) and `_lambdarank_bucket_grads` (:472): for each query, each
document's rank by score (stable, descending, ties by index), its
discount 1/log2(rank + 2), and the reference's pairwise lambdas
(rank_objective.hpp:83-160) summed into every document's grad and hess,
then times the row weight. Both take unpadded queries as boundaries.

On CUDA tensors `lambdarank_grads` launches `csrc/lambdarank.cu` or
raises; on CPU tensors it runs `lambdarank_grads_plain`, which computes
the same function over padded [Qb, D, D] query batches, D the next power
of two of the query length, under a pair budget. Launches are counted
in `lambdarank_grads.launches`.
"""
from __future__ import annotations

import ctypes
import threading
from typing import Optional, Tuple

import numpy as np
import torch

from ..log import LightGBMError
from . import _build

_launch_lock = threading.Lock()

# most elements of one [Qb, D, D] pair tensor of the plain version
PAIR_BUDGET = 1 << 22
_MIN_BUCKET = 16


def _batch_grads(s, lab, gain, mask, inv, two_sigma):
    """One padded batch [B, D] -> per-doc (lam, hess) [B, D], in the JAX
    function's operation order. Pads are masked out of the ranks and
    the pairs; their outputs are dropped by the caller."""
    d = s.shape[1]
    s = torch.where(mask, s, torch.zeros_like(s))
    m_e = mask[:, None, :]
    # [B, doc, other]: rank = #(other scores above) + #(equal, earlier)
    above = (s[:, None, :] > s[:, :, None]) & m_e
    earlier = torch.arange(d, device=s.device)[None, :] \
        < torch.arange(d, device=s.device)[:, None]
    tied = (s[:, None, :] == s[:, :, None]) & m_e & earlier[None]
    rank = above.sum(2) + tied.sum(2)
    del above, tied
    disc = 1.0 / torch.log2(rank.to(torch.float32) + 2.0)
    norm = ((s != s[:, :1]) & mask).any(1)[:, None, None]
    # pair tensors [B, i, j], i the high doc
    ds = s[:, :, None] - s[:, None, :]
    valid = (mask[:, :, None] & mask[:, None, :]
             & (lab[:, :, None] > lab[:, None, :]))
    delta = (gain[:, :, None] - gain[:, None, :]) \
        * torch.abs(disc[:, :, None] - disc[:, None, :]) * inv[:, None, None]
    delta = torch.where(norm, delta / (0.01 + torch.abs(ds)), delta)
    p = 2.0 / (1.0 + torch.exp(two_sigma * ds))
    zero = torch.zeros((), dtype=torch.float32, device=s.device)
    lam_pair = torch.where(valid, -delta * p, zero)
    hess_pair = torch.where(valid, 2.0 * delta * (p * (2.0 - p)), zero)
    return (lam_pair.sum(2) - lam_pair.sum(1),
            hess_pair.sum(2) + hess_pair.sum(1))


def lambdarank_grads_plain(score: torch.Tensor, query_boundaries: torch.Tensor,
                           label: torch.Tensor, gain: torch.Tensor,
                           inv_max_dcg: torch.Tensor, sigmoid: float,
                           weights: Optional[torch.Tensor] = None
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """L's function in PyTorch ops on the inputs' device: queries padded
    to power-of-two lengths (at least 16) in batches of at most
    PAIR_BUDGET pair elements. Queries of 0 or 1 docs have no pairs."""
    dev = score.device
    qb = query_boundaries.cpu().numpy().astype(np.int64)
    sizes = np.diff(qb)
    n = score.shape[0]
    grad = torch.zeros(n, dtype=torch.float32, device=dev)
    hess = torch.zeros(n, dtype=torch.float32, device=dev)
    two_sigma = float(np.float32(2.0 * sigmoid))
    width = np.maximum(_MIN_BUCKET, 2 ** np.ceil(
        np.log2(np.maximum(sizes, 1))).astype(np.int64))
    for d in sorted(set(width[sizes > 1].tolist())):
        qs = np.nonzero((width == d) & (sizes > 1))[0]
        per = max(1, PAIR_BUDGET // (d * d))
        offs = np.arange(d)
        for lo in range(0, len(qs), per):
            batch = qs[lo:lo + per]
            mask_np = offs[None, :] < sizes[batch][:, None]
            idx_np = np.where(mask_np, qb[batch][:, None] + offs[None, :], 0)
            idx = torch.from_numpy(idx_np).to(dev)
            mask = torch.from_numpy(mask_np).to(dev)
            qi = torch.from_numpy(batch).to(dev)
            lam, hs = _batch_grads(score[idx], label[idx], gain[idx], mask,
                                   inv_max_dcg[qi], two_sigma)
            rows = idx[mask]
            grad[rows] = lam[mask]
            hess[rows] = hs[mask]
    if weights is not None:
        grad = grad * weights
        hess = hess * weights
    return grad, hess


def lambdarank_grads(score: torch.Tensor, query_boundaries: torch.Tensor,
                     label: torch.Tensor, gain: torch.Tensor,
                     inv_max_dcg: torch.Tensor, sigmoid: float,
                     weights: Optional[torch.Tensor] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """L: (grad, hess) f32 [n] of the lambdarank objective.

    score f32 [n]; query_boundaries int32 [nq+1], non-decreasing from 0
    to n; label int32 [n] (the labels, compared as they are); gain f32
    [n] (label_gain of the label clipped to the table); inv_max_dcg f32
    [nq]; weights f32 [n] or None."""
    n = score.shape[0]
    nq = query_boundaries.shape[0] - 1
    tensors = [score, query_boundaries, label, gain, inv_max_dcg] + (
        [] if weights is None else [weights])
    if score.dim() != 1 or query_boundaries.dim() != 1 or nq < 0 \
            or label.shape != (n,) or gain.shape != (n,) \
            or inv_max_dcg.shape != (nq,) \
            or (weights is not None and weights.shape != (n,)):
        raise LightGBMError("lambdarank_grads takes score, label, gain and "
                            "weights [n], query_boundaries [nq+1] and "
                            "inv_max_dcg [nq]")
    if any(t.device != score.device for t in tensors):
        raise LightGBMError("lambdarank_grads: inputs on different devices")
    if score.device.type == "cpu":
        return lambdarank_grads_plain(score, query_boundaries, label, gain,
                                      inv_max_dcg, sigmoid, weights)
    if score.device.type != "cuda":
        raise LightGBMError("lambdarank_grads runs on cpu or cuda, not %s"
                            % score.device)
    if any(t.dtype != torch.float32 for t in (score, gain, inv_max_dcg)) \
            or query_boundaries.dtype != torch.int32 \
            or label.dtype != torch.int32 \
            or (weights is not None and weights.dtype != torch.float32):
        raise LightGBMError("lambdarank_grads takes f32 score, gain, "
                            "inv_max_dcg and weights, int32 boundaries and "
                            "labels")
    if not all(t.is_contiguous() for t in tensors):
        raise LightGBMError("lambdarank_grads takes contiguous tensors")
    lib = _build.load_library("rank")
    grad = torch.empty(n, dtype=torch.float32, device=score.device)
    hess = torch.empty(n, dtype=torch.float32, device=score.device)
    # discounts of queries too long to stage in shared memory
    disc = torch.empty(n, dtype=torch.float32, device=score.device)
    p = ctypes.c_void_p
    with torch.cuda.device(score.device):
        stream = torch.cuda.current_stream(score.device).cuda_stream
        rc = lib.lgbt_lambdarank_grads(
            p(score.data_ptr()), p(query_boundaries.data_ptr()), nq,
            p(label.data_ptr()), p(gain.data_ptr()),
            p(inv_max_dcg.data_ptr()), float(np.float32(2.0 * sigmoid)),
            p(None if weights is None else weights.data_ptr()),
            p(disc.data_ptr()), p(grad.data_ptr()), p(hess.data_ptr()),
            p(stream))
    if rc != 0:
        raise LightGBMError("lambdarank_grads launch failed: CUDA error %d "
                            "(%s)" % (rc, lib.lgbt_error_string(rc).decode()))
    if nq:
        with _launch_lock:
            lambdarank_grads.launches += 1
    return grad, hess


def stage_cap() -> int:
    """Docs a query may have for L to stage it in shared memory; longer
    ones read global memory (needs the built library)."""
    return int(_build.load_library("rank").lgbt_lambdarank_stage_cap())


lambdarank_grads.launches = 0
