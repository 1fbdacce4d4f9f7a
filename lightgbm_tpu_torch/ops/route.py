"""Applying a split to the rows, and the train-score update: kernel R's
wrappers and their plain PyTorch versions.

Counterpart of `lightgbm_tpu/learner/grow.py` `expand.route`
(:1037-1072) and the score update at `lightgbm_tpu/boosting/gbdt.py`
:185-190. The port keeps the reference's DataPartition
(data_partition.hpp:94-170): `perm` is a permutation of the row ids in
which each leaf owns a contiguous segment. `route_partition` decides
go_left for each row of a leaf's segment exactly as the JAX grower does
(EFB decode, NaN / zero missing to default_left, categorical equality,
else bin <= threshold), writes the rows' new leaf slot and reorders the
segment stably, left rows first (in place, or into another buffer: the
grower keeps two and tracks which one holds each leaf's segment).
`score_update` adds each row's leaf value times the shrinkage to its
score as one fused multiply-add, as the JAX package's fused
grow-and-update program does. All outputs but
the score are integers and equal the plain versions exactly; the score
is rounded once a row either way (`fma_f32`). `score_average`, R's
average mode, is RF's running average (`lightgbm_tpu/boosting/rf.py`
:87-96), score = (score * t + contrib) / (t + 1), each operation
rounded on its own as JAX's eager calls round them, with contrib the
leaf value of each row's leaf id or a given per-row value.

On CUDA tensors each launches `csrc/route_partition.cu` or raises; on
CPU tensors they run the plain versions. `route_partition` takes a
uint8 matrix or a uint16 one (groups of more than 256 bins), the same
partition either way. Launches are counted in
`route_partition.launches` (those on uint16 bins also in
`route_partition.launches_u16`, those on a categorical split in
`route_partition.launches_cat`), `score_update.launches` and
`score_average.launches`.
"""
from __future__ import annotations

import ctypes
import threading
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..binning import MISSING_NAN, MISSING_ZERO
from ..log import LightGBMError
from . import _build
from .histogram import take_bins

_launch_lock = threading.Lock()
# rows a block of R routes a pass (csrc/route_partition.cu kThreads): a
# segment of more rows takes several blocks
PASS_ROWS = 512


@dataclass(frozen=True)
class SplitRule:
    """One split in the stored-group bin space: the feature's group,
    EFB offset, bin count, default bin, missing type and bundled flag,
    then the threshold bin, default_left, is_categorical, and the leaf
    slots of the two children."""
    group: int
    offset: int
    num_bin: int
    default_bin: int
    missing_type: int
    bundled: bool
    threshold: int
    default_left: bool
    is_cat: bool
    left_slot: int
    right_slot: int

    def args(self):
        return (self.group, self.offset, self.num_bin, self.default_bin,
                self.missing_type, int(self.bundled), self.threshold,
                int(self.default_left), int(self.is_cat), self.left_slot,
                self.right_slot)


def go_left_plain(rule: SplitRule, col: torch.Tensor) -> torch.Tensor:
    """grow.py:1052-1065 on a column of group bins."""
    col = col.to(torch.int32)
    if rule.bundled:
        in_slice = (col >= rule.offset) & (col < rule.offset + rule.num_bin)
        col = torch.where(in_slice, col - rule.offset,
                          torch.full_like(col, rule.default_bin))
    if rule.is_cat:
        return col == rule.threshold
    is_missing = (((rule.missing_type == MISSING_NAN)
                   & (col == rule.num_bin - 1))
                  | ((rule.missing_type == MISSING_ZERO)
                     & (col == rule.default_bin)))
    return torch.where(is_missing, torch.full_like(col, rule.default_left,
                                                   dtype=torch.bool),
                       col <= rule.threshold)


def route_partition_plain(binned: torch.Tensor, perm: torch.Tensor,
                          begin: int, count: int, rule: SplitRule,
                          leaf_id: torch.Tensor,
                          count_out: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """In place on perm[begin:begin+count] and leaf_id; returns the
    number of left rows as a 0-dim int32 tensor (also written to
    count_out[0] when given)."""
    seg = perm[begin:begin + count].long()
    left = go_left_plain(rule, take_bins(binned[:, rule.group], seg))
    leaf_id[seg] = torch.where(left, rule.left_slot,
                               rule.right_slot).to(torch.int32)
    perm[begin:begin + count] = torch.cat([seg[left], seg[~left]]).to(
        torch.int32)
    n_left = left.sum().to(torch.int32)
    if count_out is not None:
        count_out[0] = n_left
    return n_left


def route_scratch(rows: int, device: torch.device) -> torch.Tensor:
    """R's scratch for splits of up to `rows` rows on a CUDA device: its
    barrier words (zero), a left count a block and a flag bit a row
    (`csrc/route_partition.cu`). The grower makes one per Dataset."""
    return torch.zeros(_lib().lgbt_route_scratch_ints(rows),
                       dtype=torch.int32, device=device)


_route_lib = None


def _lib():
    global _route_lib
    if _route_lib is None:
        _route_lib = _build.load_library("route")
    return _route_lib


def route_partition(binned: torch.Tensor, perm: torch.Tensor, begin: int,
                    count: int, rule: SplitRule, leaf_id: torch.Tensor,
                    count_out: Optional[torch.Tensor] = None,
                    out: Optional[torch.Tensor] = None,
                    scratch: Optional[torch.Tensor] = None
                    ) -> torch.Tensor:
    """R: route the rows perm[begin:begin+count] of one leaf by `rule`:
    leaf_id of those rows, and the segment reordered stably, left rows
    first, in place or, with `out` (another int32 [N] buffer), into
    out[begin:begin+count] with perm left as it is (one kernel launch on
    the card; in place adds a copy back). Returns the left row count as
    a 0-dim int32 tensor on the same device, and writes it to
    count_out[0] (an int32 tensor) when given. binned [N, G] is
    row-major or column-major (a transposed copy's view). `scratch`: the
    grower's `route_scratch` of at least `count` rows; made per call
    when None."""
    if binned.dim() != 2 or perm.dim() != 1 or leaf_id.shape != perm.shape \
            or (out is not None and (out.shape != perm.shape
                                     or out.data_ptr() == perm.data_ptr())):
        raise LightGBMError("route_partition takes binned [N, G], perm "
                            "[N], leaf_id [N] and out [N] apart from perm")
    if begin < 0 or count < 0 or begin + count > perm.shape[0]:
        raise LightGBMError("route_partition: segment out of range")
    dev = binned.device
    if any(t.device != dev for t in (perm, leaf_id)) or (
            count_out is not None and (count_out.device != dev
                                       or count_out.dtype != torch.int32)) \
            or (out is not None and out.device != dev):
        raise LightGBMError("route_partition: inputs on different devices "
                            "or a count_out that is not int32")
    if dev.type == "cpu":
        if out is None:
            return route_partition_plain(binned, perm, begin, count, rule,
                                         leaf_id, count_out)
        out[begin:begin + count] = perm[begin:begin + count]
        return route_partition_plain(binned, out, begin, count, rule,
                                     leaf_id, count_out)
    if dev.type != "cuda":
        raise LightGBMError("route_partition runs on cpu or cuda, not %s"
                            % dev)
    u16 = binned.dtype == torch.uint16
    if binned.dtype not in (torch.uint8, torch.uint16) \
            or perm.dtype != torch.int32 or leaf_id.dtype != torch.int32 \
            or (out is not None and out.dtype != torch.int32):
        raise LightGBMError("route_partition takes uint8 or uint16 bins and "
                            "int32 perm/leaf_id/out")
    if not ((binned.is_contiguous() or binned.t().is_contiguous())
            and perm.is_contiguous() and leaf_id.is_contiguous()
            and (out is None or out.is_contiguous())):
        raise LightGBMError("route_partition takes contiguous tensors "
                            "(binned row- or column-major)")
    lib = _lib()
    if scratch is None:
        scratch = route_scratch(count, dev)
    elif scratch.dtype != torch.int32 or scratch.device != dev \
            or scratch.numel() < lib.lgbt_route_scratch_ints(count):
        raise LightGBMError("route_partition: scratch is not an int32 "
                            "route_scratch of %d rows on %s" % (count, dev))
    if count_out is None:
        count_out = torch.empty(1, dtype=torch.int32, device=dev)
    if out is None:
        seg = torch.empty(count, dtype=torch.int32, device=dev)
        dst = seg.data_ptr()
    else:
        dst = out.data_ptr() + 4 * begin
    p = ctypes.c_void_p
    args = (p(binned.data_ptr()), binned.stride(0), binned.stride(1),
            int(u16), p(perm.data_ptr() + 4 * begin), p(dst), count,
            *rule.args(), p(leaf_id.data_ptr()), p(scratch.data_ptr()),
            p(count_out.data_ptr()))
    # no device switch when the card is already the current one (the
    # grower calls R once a split)
    if torch.cuda.current_device() == dev.index:
        rc = lib.lgbt_route_partition(
            *args, p(torch.cuda.current_stream().cuda_stream))
    else:
        with torch.cuda.device(dev):
            rc = lib.lgbt_route_partition(
                *args, p(torch.cuda.current_stream().cuda_stream))
    if rc != 0:
        raise LightGBMError("route_partition launch failed: CUDA error %d "
                            "(%s)" % (rc, lib.lgbt_error_string(rc).decode()))
    if count:
        if out is None:
            perm[begin:begin + count].copy_(seg)
        with _launch_lock:
            route_partition.launches += 1
            if u16:
                route_partition.launches_u16 += 1
            if rule.is_cat:
                route_partition.launches_cat += 1
    return count_out[0]


def fma_f32(a: torch.Tensor, b: torch.Tensor,
            c: torch.Tensor) -> torch.Tensor:
    """a * b + c for f32 tensors, rounded once to f32 as a fused
    multiply-add rounds it. The product is exact in f64; the f64 sum is
    rounded to odd (its TwoSum error decides the last bit), which makes
    the final rounding to f32 the correctly rounded one."""
    p = a.double() * b.double()
    cd = c.double()
    t = p + cd
    bv = t - p
    err = (p - (t - bv)) + (cd - bv)
    even = (t.view(torch.int64) & 1) == 0
    toward = torch.where(err > 0, float("inf"), float("-inf")).to(t)
    t = torch.where((err != 0) & even, torch.nextafter(t, toward), t)
    return t.float()


def score_update_plain(score: torch.Tensor, leaf_id: torch.Tensor,
                       value: torch.Tensor, shrinkage: float) -> None:
    s = torch.tensor(shrinkage, dtype=torch.float32, device=score.device)
    score.copy_(fma_f32(value[leaf_id.long()], s, score))


def score_update(score: torch.Tensor, leaf_id: torch.Tensor,
                 value: torch.Tensor, shrinkage: float) -> None:
    """R's second entry: score[r] = fma(value[leaf_id[r]], shrinkage,
    score[r]) in place (value: the tree's f32 leaf values before
    shrinkage; shrinkage rounded to f32)."""
    if score.shape != leaf_id.shape or score.dtype != torch.float32 \
            or value.dtype != torch.float32:
        raise LightGBMError("score_update takes f32 score [N], leaf_id [N] "
                            "and f32 values")
    if any(t.device != score.device for t in (leaf_id, value)):
        raise LightGBMError("score_update: inputs on different devices")
    if score.device.type == "cpu":
        return score_update_plain(score, leaf_id, value, shrinkage)
    if score.device.type != "cuda":
        raise LightGBMError("score_update runs on cpu or cuda, not %s"
                            % score.device)
    if leaf_id.dtype != torch.int32 or not (
            score.is_contiguous() and leaf_id.is_contiguous()
            and value.is_contiguous()):
        raise LightGBMError("score_update takes contiguous tensors and "
                            "int32 leaf ids")
    lib = _build.load_library("route")
    p = ctypes.c_void_p
    with torch.cuda.device(score.device):
        stream = torch.cuda.current_stream(score.device).cuda_stream
        rc = lib.lgbt_score_update(p(score.data_ptr()), p(leaf_id.data_ptr()),
                                   p(value.data_ptr()), float(shrinkage),
                                   score.shape[0], p(stream))
    if rc != 0:
        raise LightGBMError("score_update launch failed: CUDA error %d (%s)"
                            % (rc, lib.lgbt_error_string(rc).decode()))
    with _launch_lock:
        score_update.launches += 1


def score_average_plain(score: torch.Tensor, leaf_id: Optional[torch.Tensor],
                        value: torch.Tensor, t: int) -> None:
    dev = score.device
    tf = torch.tensor(float(t), dtype=torch.float32, device=dev)
    t1 = torch.tensor(float(t) + 1.0, dtype=torch.float32, device=dev)
    c = value if leaf_id is None else value[leaf_id.long()]
    score.copy_((score * tf + c) / t1)


def score_average(score: torch.Tensor, leaf_id: Optional[torch.Tensor],
                  value: torch.Tensor, t: int) -> None:
    """R's average mode: score[r] = (score[r] * t + c[r]) / (t + 1) in
    place, c[r] = value[leaf_id[r]] (the tree's f32 leaf values), or
    value[r] when leaf_id is None (a per-row f32 [N]); t and t + 1 in
    f32."""
    n = score.shape[0]
    if score.dim() != 1 or score.dtype != torch.float32 \
            or value.dtype != torch.float32 or (
                leaf_id is None and value.shape != score.shape) or (
                leaf_id is not None and leaf_id.shape != score.shape):
        raise LightGBMError("score_average takes f32 score [N] with leaf_id "
                            "[N] and f32 leaf values, or f32 values [N]")
    tensors = [t_ for t_ in (leaf_id, value) if t_ is not None]
    if any(t_.device != score.device for t_ in tensors):
        raise LightGBMError("score_average: inputs on different devices")
    if score.device.type == "cpu":
        return score_average_plain(score, leaf_id, value, t)
    if score.device.type != "cuda":
        raise LightGBMError("score_average runs on cpu or cuda, not %s"
                            % score.device)
    if (leaf_id is not None and leaf_id.dtype != torch.int32) or not all(
            t_.is_contiguous() for t_ in [score] + tensors):
        raise LightGBMError("score_average takes contiguous tensors and "
                            "int32 leaf ids")
    lib = _build.load_library("route")
    p = ctypes.c_void_p
    with torch.cuda.device(score.device):
        stream = torch.cuda.current_stream(score.device).cuda_stream
        rc = lib.lgbt_score_average(
            p(score.data_ptr()),
            p(None if leaf_id is None else leaf_id.data_ptr()),
            p(value.data_ptr()), float(t), float(np.float32(float(t) + 1.0)),
            n, p(stream))
    if rc != 0:
        raise LightGBMError("score_average launch failed: CUDA error %d (%s)"
                            % (rc, lib.lgbt_error_string(rc).decode()))
    with _launch_lock:
        score_average.launches += 1


route_partition.launches = 0
route_partition.launches_u16 = 0
route_partition.launches_cat = 0
score_update.launches = 0
score_average.launches = 0
