"""Pairwise lambdarank gradients: kernel L's wrapper, its launch plan,
its plain PyTorch version and a replay of its summation order.

Counterpart of `lightgbm_tpu/objectives.py` `_lambdarank_pair_grads`
(:438) and `_lambdarank_bucket_grads` (:472): for each query, each
document's rank by score (stable, descending, ties by index), its
discount 1/log2(rank + 2), and the reference's pairwise lambdas
(rank_objective.hpp:83-160) summed into every document's grad and hess,
then times the row weight. Both take unpadded queries as boundaries.

On CUDA tensors `lambdarank_grads` launches `csrc/lambdarank.cu` or
raises, on the plan `lambdarank_plan` made once for the query layout
(`LambdarankNDCG.init` keeps it); on CPU tensors it runs
`lambdarank_grads_plain`, which computes the same function over padded
[Qb, D, D] query batches, D the next power of two of the query length,
under a pair budget. `lambdarank_grads_order` adds each doc's terms in
the kernel's order: a query of up to FIT_DOCS docs in j order (the
reference's loop), a longer one by TILE-doc partner blocks, each block
in j order, then the blocks in order. Launches are counted in
`lambdarank_grads.launches`.
"""
from __future__ import annotations

import ctypes
import functools
import threading
from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

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


def _pair_terms(s, lab, gain, mask, inv, two_sigma):
    """Per doc of a padded batch [B, D]: its signed lambda and its h
    against every other doc [B, doc, other] (0 where the labels are
    equal or a side is padding), each pair's terms formed as kernel L
    forms them (objectives.py:454-467, the high doc first)."""
    d = s.shape[1]
    key = torch.where(mask, -s, torch.full_like(s, float("inf")))
    order = torch.sort(key, dim=1, stable=True).indices
    rank = torch.empty_like(order)
    rank.scatter_(1, order, torch.arange(d, device=s.device).expand_as(
        order).contiguous())
    disc = 1.0 / torch.log2(rank.to(torch.float32) + 2.0)
    big = torch.where(mask, s, torch.full_like(s, -float("inf")))
    small = torch.where(mask, s, torch.full_like(s, float("inf")))
    norm = (big.max(1).values != small.min(1).values)[:, None, None]
    # [B, i, j]: the pair with i as the high doc
    ds = s[:, :, None] - s[:, None, :]
    delta = (gain[:, :, None] - gain[:, None, :]) \
        * torch.abs(disc[:, :, None] - disc[:, None, :]) * inv[:, None, None]
    delta = torch.where(norm, delta / (0.01 + torch.abs(ds)), delta)
    p = 2.0 / (1.0 + torch.exp(two_sigma * ds))
    lam = -delta * p
    h = 2.0 * delta * (p * (2.0 - p))
    both = mask[:, :, None] & mask[:, None, :]
    high = (lab[:, :, None] > lab[:, None, :]) & both
    low = (lab[:, :, None] < lab[:, None, :]) & both
    zero = torch.zeros((), dtype=torch.float32, device=s.device)
    term = torch.where(high, lam, torch.where(low, -lam.transpose(1, 2),
                                              zero))
    hterm = torch.where(high, h, torch.where(low, h.transpose(1, 2), zero))
    return term, hterm


def lambdarank_grads_order(score: torch.Tensor,
                           query_boundaries: torch.Tensor,
                           label: torch.Tensor, gain: torch.Tensor,
                           inv_max_dcg: torch.Tensor, sigmoid: float,
                           weights: Optional[torch.Tensor] = None
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """L's function in torch ops on the inputs' device, each doc's f32
    sum in the kernel's order: from 0, over the query's other docs in
    index order when the query has at most FIT_DOCS docs; past that,
    each TILE-doc block of partners in index order from 0, then the
    blocks' partials in block order from 0. (A sum that starts at +0
    never becomes -0, so adding the +0 of a pair of equal labels leaves
    it as it is.) Then times the row weight."""
    dev = score.device
    qb = query_boundaries.cpu().numpy().astype(np.int64)
    sizes = np.diff(qb)
    n = score.shape[0]
    grad = torch.zeros(n, dtype=torch.float32, device=dev)
    hess = torch.zeros(n, dtype=torch.float32, device=dev)
    two_sigma = float(np.float32(2.0 * sigmoid))
    fit = sizes <= FIT_DOCS
    width = np.where(fit, np.maximum(_MIN_BUCKET, 2 ** np.ceil(np.log2(
        np.maximum(sizes, 1))).astype(np.int64)),
        -(-sizes // TILE) * TILE)
    for d in sorted(set(width[sizes > 1].tolist())):
        qs = np.nonzero((width == d) & (sizes > 1))[0]
        block = d if d <= FIT_DOCS else TILE
        per = max(1, PAIR_BUDGET // (d * d))
        offs = np.arange(d)
        for lo in range(0, len(qs), per):
            batch = qs[lo:lo + per]
            mask_np = offs[None, :] < sizes[batch][:, None]
            idx_np = np.where(mask_np, qb[batch][:, None] + offs[None, :], 0)
            idx = torch.from_numpy(idx_np).to(dev)
            mask = torch.from_numpy(mask_np).to(dev)
            qi = torch.from_numpy(batch).to(dev)
            term, hterm = _pair_terms(score[idx], label[idx], gain[idx], mask,
                                      inv_max_dcg[qi], two_sigma)
            g = torch.zeros(len(batch), d, dtype=torch.float32, device=dev)
            h = torch.zeros_like(g)
            for b0 in range(0, d, block):
                pg = torch.zeros_like(g)
                ph = torch.zeros_like(g)
                for j in range(b0, b0 + block):
                    pg = pg + term[:, :, j]
                    ph = ph + hterm[:, :, j]
                g = g + pg
                h = h + ph
            rows = idx[mask]
            grad[rows] = g[mask]
            hess[rows] = h[mask]
    if weights is not None:
        grad = grad * weights
        hess = hess * weights
    return grad, hess


# ----------------------------------------------------------------------
# kernel L's launch plan
#: queries of up to FIT_DOCS docs: one pair tile in a fit block, packed
#: up to FIT_DOCS docs a block; longer ones: TILE x TILE tiles, ranked
#: by a sort of up to SORT_CAP keys in shared memory (a count past it);
#: BLOCK threads a fit or tile block. csrc/lambdarank.cu has the same
#: constants (checked at each launch).
FIT_DOCS, TILE, SORT_CAP, BLOCK = 128, 64, 4096, 256
#: the largest dynamic shared memory a block takes on an H100
SMEM_LIMIT = 232_448
# a fit block's shared header: its docs, each warp's queue of 64 pairs,
# the docs' slot ids and sort order; and seven words a slot
_FIT_HEADER = FIT_DOCS * 16 + BLOCK * 8 + 2 * FIT_DOCS
# the fit blocks launched apart when their matrices pass this many floats
SMALL_M = 10_240
_SLOT_BYTES = 28
# a tile block's: both sides' docs, the warps' queues, the two matrices
_TILE_SMEM = 2 * TILE * 16 + BLOCK * 8 + 2 * TILE * (TILE + 1) * 4


@dataclass
class RankPlan:
    """Kernel L's work for one query layout (`lambdarank_plan`): host
    arrays, and on a CUDA plan their device copies and the scratch the
    long queries use. A plan serves one stream at a time."""
    sizes: np.ndarray       # [nq] docs a query
    fit_block: np.ndarray   # [B, 7] first slot, slots, docs, pairs, M
                            # floats; the first slot's query and first doc
    fit_slot: np.ndarray    # [S, 6] query, first doc, docs, first local
                            # doc, first M float, first pair
    long_q: np.ndarray      # [Lq, 5] query, first disc slot, first
                            # partial slot, first doc, docs
    tiles: np.ndarray       # [T, 8] query, long query, first doc, docs,
                            # row block, column block, disc and partial
                            # slots (the long query's)
    finish: np.ndarray      # [F, 4] first doc, docs, doc block, first
                            # partial slot (the long query's)
    fit_smem: int           # shared bytes of the fit blocks past n_large
    fit_smem_large: int     # and of the first n_large (more M floats)
    n_large: int
    max_slots: int
    rank_smem: int
    tile_smem: int
    device: Optional[torch.device] = None
    dev: Dict[str, torch.Tensor] = field(default_factory=dict)


def _pack_fit(sizes: np.ndarray, starts: np.ndarray):
    """Next-fit packing of the fit queries, longest first, up to
    FIT_DOCS docs a block: (fit_block, fit_slot, most slots a block,
    most M floats a block)."""
    qs = np.nonzero((sizes >= 1) & (sizes <= FIT_DOCS))[0]
    qs = qs[np.argsort(-sizes[qs], kind="stable")]
    blocks, slots = [], []
    docs = FIT_DOCS + 1
    for q in qs.tolist():
        c = int(sizes[q])
        if docs + c > FIT_DOCS:
            blocks.append([len(slots), 0, 0, 0, 0, q, int(starts[q])])
            docs = 0
        b = blocks[-1]
        slots.append([q, int(starts[q]), c, b[2], b[4], b[3]])
        b[1] += 1
        b[2] += c
        b[3] += c * (c - 1) // 2
        b[4] += c * (c | 1)
        docs += c
    fit_block = np.array(blocks, np.int64).reshape(-1, 7)
    fit_block[:, 4] = -(-fit_block[:, 4] // 4) * 4
    fit_slot = np.array(slots, np.int64).reshape(-1, 6)
    most_slots = int(fit_block[:, 1].max()) if len(blocks) else 0
    most_m = int(fit_block[:, 4].max()) if len(blocks) else 0
    return fit_block, fit_slot, most_slots, most_m


def lambdarank_plan(query_boundaries, device=None) -> RankPlan:
    """Kernel L's plan for a query layout (boundaries, host array or
    tensor): queries of up to FIT_DOCS docs packed into fit blocks,
    longest first; longer ones, longest first, as a rank item each,
    their TILE x TILE tiles (row block <= column block) and a finish
    item a doc block. On a CUDA `device` the arrays and the scratch go
    there once."""
    qb = np.asarray(query_boundaries.cpu() if torch.is_tensor(
        query_boundaries) else query_boundaries, np.int64)
    sizes = np.diff(qb)
    fit_block, fit_slot, max_slots, most_m = _pack_fit(sizes, qb[:-1])
    # two launches: the blocks whose matrices pass SMALL_M floats first,
    # so that the rest fit five blocks to an SM; M holds the sort's
    # exchange buffer first (FIT_DOCS 8-byte keys)
    header = -(-(_FIT_HEADER + _SLOT_BYTES * max_slots) // 16) * 16
    large = fit_block[:, 4] > SMALL_M
    fit_block = np.concatenate([fit_block[large], fit_block[~large]])
    n_large = int(large.sum())
    fit_smem = header + 4 * max(int(fit_block[n_large:, 4].max(initial=0)),
                                2 * FIT_DOCS)
    fit_smem_large = header + 4 * max(most_m, 2 * FIT_DOCS)
    lq = np.nonzero(sizes > FIT_DOCS)[0]
    lq = lq[np.argsort(-sizes[lq], kind="stable")]
    cnt = sizes[lq]
    nb = -(-cnt // TILE)
    long_q = np.stack([lq, np.concatenate([[0], np.cumsum(cnt)[:-1]]),
                       np.concatenate([[0], np.cumsum(cnt * nb)[:-1]]),
                       qb[lq], cnt], 1) if len(lq) \
        else np.zeros((0, 5), np.int64)
    tiles, finish = [], []
    for i, b in enumerate(nb.tolist()):
        q, dbase, pbase, first, c = long_q[i].tolist()
        rows, cols = np.triu_indices(b)
        tiles.append(np.stack([np.full(len(rows), q), np.full(len(rows), i),
                               np.full(len(rows), first),
                               np.full(len(rows), c), rows, cols,
                               np.full(len(rows), dbase),
                               np.full(len(rows), pbase)], 1))
        finish.append(np.stack([np.full(b, first), np.full(b, c),
                                np.arange(b), np.full(b, pbase)], 1))
    tiles = np.concatenate(tiles) if tiles else np.zeros((0, 8), np.int64)
    finish = np.concatenate(finish) if finish else np.zeros((0, 4),
                                                             np.int64)
    sorted_cnt = cnt[cnt <= SORT_CAP]
    rank_smem = 8 * (1 << int(np.ceil(np.log2(sorted_cnt.max())))) \
        if len(sorted_cnt) else 0
    plan = RankPlan(sizes, fit_block, fit_slot, long_q, tiles, finish,
                    int(fit_smem), int(fit_smem_large), n_large, max_slots,
                    rank_smem, _TILE_SMEM)
    if device is not None and torch.device(device).type == "cuda":
        dev = torch.device(device)
        plan.device = dev
        for name in ("fit_block", "fit_slot", "long_q", "tiles", "finish"):
            arr = getattr(plan, name)
            plan.dev[name] = torch.from_numpy(np.ascontiguousarray(
                arr.reshape(-1) if arr.size else np.zeros(1), np.int32)).to(
                dev)
        n_long = int(cnt.sum())
        plan.dev["disc"] = torch.empty(max(n_long, 1), dtype=torch.float32,
                                       device=dev)
        plan.dev["norm"] = torch.empty(max(len(lq), 1), dtype=torch.int32,
                                       device=dev)
        n_part = int((cnt * nb).sum())
        plan.dev["part"] = torch.empty((2, max(n_part, 1)),
                                       dtype=torch.float32, device=dev)
    return plan


def lambdarank_grads(score: torch.Tensor, query_boundaries: torch.Tensor,
                     label: torch.Tensor, gain: torch.Tensor,
                     inv_max_dcg: torch.Tensor, sigmoid: float,
                     weights: Optional[torch.Tensor] = None,
                     plan: Optional[RankPlan] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """L: (grad, hess) f32 [n] of the lambdarank objective.

    score f32 [n]; query_boundaries int32 [nq+1], non-decreasing from 0
    to n; label int32 [n] (the labels, compared as they are); gain f32
    [n] (label_gain of the label clipped to the table); inv_max_dcg f32
    [nq]; weights f32 [n] or None; plan: `lambdarank_plan` of the
    boundaries on the card (made here, reading them back, when None)."""
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
    if plan is None:
        plan = lambdarank_plan(query_boundaries, score.device)
    if plan.device != score.device or len(plan.sizes) != nq \
            or int(plan.sizes.sum()) != n:
        raise LightGBMError("lambdarank_grads: the plan is for %d queries of "
                            "%d docs on %s, not %d of %d on %s"
                            % (len(plan.sizes), int(plan.sizes.sum()),
                               plan.device, nq, n, score.device))
    lib = _build.load_library("rank")
    _check_layout(FIT_DOCS, TILE, SORT_CAP, BLOCK)
    out = torch.empty((2, n), dtype=torch.float32, device=score.device)
    p = ctypes.c_void_p
    dv = plan.dev
    with torch.cuda.device(score.device):
        stream = torch.cuda.current_stream(score.device).cuda_stream
        rc = lib.lgbt_lambdarank_grads(
            p(score.data_ptr()), p(label.data_ptr()), p(gain.data_ptr()),
            p(inv_max_dcg.data_ptr()), float(np.float32(2.0 * sigmoid)),
            p(None if weights is None else weights.data_ptr()),
            p(dv["fit_block"].data_ptr()), p(dv["fit_slot"].data_ptr()),
            len(plan.fit_block), plan.n_large, plan.fit_smem_large,
            plan.fit_smem, plan.max_slots,
            p(dv["long_q"].data_ptr()), len(plan.long_q),
            p(dv["tiles"].data_ptr()), len(plan.tiles),
            p(dv["finish"].data_ptr()), len(plan.finish), plan.rank_smem,
            plan.tile_smem, p(dv["disc"].data_ptr()),
            p(dv["norm"].data_ptr()), p(dv["part"][0].data_ptr()),
            p(dv["part"][1].data_ptr()), p(out[0].data_ptr()),
            p(out[1].data_ptr()), p(stream))
    if rc != 0:
        raise LightGBMError("lambdarank_grads launch failed: CUDA error %d "
                            "(%s)" % (rc, lib.lgbt_error_string(rc).decode()))
    if nq:
        with _launch_lock:
            lambdarank_grads.launches += 1
    return out[0], out[1]


@functools.lru_cache(maxsize=None)
def _check_layout(*layout) -> None:
    """The built library's constants are the plan's (FIT_DOCS, TILE,
    SORT_CAP, BLOCK)."""
    lib = _build.load_library("rank")
    if [lib.lgbt_lambdarank_layout(i) for i in range(4)] != list(layout):
        raise LightGBMError("lambdarank_grads: csrc/lambdarank.cu's layout "
                            "differs from ops/rank.py's")


lambdarank_grads.launches = 0
