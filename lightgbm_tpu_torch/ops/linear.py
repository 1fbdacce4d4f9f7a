"""Linear leaves: kernels LF, LS and LA, their wrappers and plain
PyTorch versions.

Counterpart of `lightgbm_tpu/linear/solver.py` `fit_leaves` (:54, with
`_gather_z` :35) and `linear_row_values` (:143), and of
`lightgbm_tpu/ops/predict.py` `linear_leaf_addend` (:163):

- LF `linear_normal_eq`: per leaf, over the rows of its segment of the
  grower's permutation, A = sum w*h * z z^T, b = sum w*g * z and cnt =
  #{w > 0}, with z = [x at the leaf's k features, 1] and w = 0 for a row
  with a non-finite value in a live slot;
- LS `linear_solve`: the ridge on the live slopes (none on the
  intercept), 1 on the diagonal of a padded slot, the identity for a
  leaf with cnt < 2(k+1), A beta = -b by LU with partial pivoting, and
  the fallback to the grower's constant with zero slopes when the leaf
  is not fitted or its solution is not finite; one launch, in one of two
  modes by d = k + 1 alone (`solve_plan`): up to d = LS_REGS_MAX_D (16;
  the main path's k 5) a lane a row with the system in registers, d
  rounded up to a power of two lanes a leaf; past it a block a leaf, the
  system in shared memory (in a global scratch past 227 KB) and warp 0
  pivoting through row slots. At the main path's width LS is
  launch-bound: its 18,360 operations take far less than the launch of
  an empty kernel (PERF.md §6);
- LA `linear_addend`: score[r] += s * (value[l] + row_ok * lin) with l =
  leaf_id[r] and lin the leaf's coefficients times the row's values
  (`linear_dot_plain`), for the train score (s = shrinkage), valid sets
  (s = 1) and rollback (s = -1).

On a CUDA tensor each wrapper launches its kernel (`csrc/linear.cu`) or
raises; on a CPU tensor it runs the plain version. LS and LA equal their
plain versions bitwise; LF forms each term in f32 as the JAX package
does and sums it in f64 (kernel and plain alike), rounding once to f32,
so the two agree up to the last f32 bit. Launches are counted in
`linear_normal_eq.launches`, `linear_solve.launches` (of them, the
block mode's in `linear_solve.launches_block`) and
`linear_addend.launches`.

Feature columns: `feats` index the columns of `x`, whatever space that
is (training: the inner space of `Dataset.raw`; serving: real columns).
A subnormal value counts as a signed zero, as on the JAX package's
backends.
"""
from __future__ import annotations

import ctypes
import functools
import threading
from typing import Tuple

import numpy as np
import torch

from ..log import LightGBMError
from . import _build
from .histogram import segment_tiles

_launch_lock = threading.Lock()
_F32_TINY = float(np.finfo(np.float32).tiny)
#: XLA's CPU dot rounds and adds the first 8 products of a row one at a
#: time, then fuses each later product into the sum (probed bitwise for
#: k = 1..100, tests/test_torch_xla_order.py)
XLA_UNFUSED_SLOTS = 8

def check_linear_features(k: int) -> None:
    """LF splits a leaf's d(d+1)/2 + d + 1 sums (d = k + 1) over as many
    blocks as they need and LS keeps the d x d system in registers, in
    shared memory or, past its 227 KB, in a global scratch
    (`solve_plan`), so any k >= 1 is taken, as the JAX package takes
    it."""
    if k < 1:
        raise LightGBMError(
            "tpu_linear_max_features=%d: the linear-leaf kernels take 1 or "
            "more features a leaf" % k)


def flush_subnormal(x: torch.Tensor) -> torch.Tensor:
    return torch.where(x.abs() < _F32_TINY, x * 0.0, x)


def gather_values(x: torch.Tensor, rows: torch.Tensor,
                  feats: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The [n, k] values x[rows[i], feats[i, j]] with padded slots
    (feats < 0) and non-finite values as 0 (subnormals flushed), and
    row_ok [n]: no live slot non-finite (`_gather_z`)."""
    pad = feats < 0
    xv = x[rows[:, None], feats.clamp(min=0).long()]
    finite = torch.isfinite(xv) | pad
    row_ok = finite.all(dim=1)
    xv = torch.where(pad | ~finite, torch.zeros_like(xv), xv)
    return flush_subnormal(xv), row_ok


def linear_dot_plain(coeff: torch.Tensor, xv: torch.Tensor) -> torch.Tensor:
    """sum_j coeff[:, j] * xv[:, j] in the order XLA's CPU backend adds
    jnp.einsum("nk,nk->n", ..., precision=HIGHEST): for k == 2 the second
    product fused with the first (one rounding); else the first
    XLA_UNFUSED_SLOTS products rounded and added one at a time from 0,
    and each later one fused into the sum (csrc/linear_term.cuh)."""
    from .route import fma_f32
    k = coeff.shape[1]
    if k == 2:
        return fma_f32(coeff[:, 1], xv[:, 1], coeff[:, 0] * xv[:, 0])
    acc = torch.zeros(coeff.shape[0], dtype=torch.float32,
                      device=coeff.device)
    for j in range(k):
        if j < XLA_UNFUSED_SLOTS:
            acc = acc + coeff[:, j] * xv[:, j]
        else:
            acc = fma_f32(coeff[:, j], xv[:, j], acc)
    return acc


def _launch(wrapper, entry: str, device: torch.device, *args) -> None:
    lib = _build.load_library("linear")
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = getattr(lib, entry)(*args, ctypes.c_void_p(stream))
    if rc != 0:
        raise LightGBMError("%s launch failed: CUDA error %d (%s)" % (
            entry, rc, lib.lgbt_error_string(rc).decode()))
    with _launch_lock:
        wrapper.launches += 1


def _ptr(t):
    return ctypes.c_void_p(None if t is None else t.data_ptr())


def _on_cuda(name: str, tensors, dtypes) -> None:
    for t, dt in zip(tensors, dtypes):
        if t.device.type != "cuda":
            raise LightGBMError("%s runs on cpu or cuda, not %s"
                                % (name, t.device))
        if t.dtype != dt or not t.is_contiguous():
            raise LightGBMError("%s takes contiguous %s tensors (got %s)"
                                % (name, dt, t.dtype))


# ----------------------------------------------------------------------
# LF
def segments_of(leaf_id: torch.Tensor, num_leaves: int):
    """(perm [N] i32, begin [L] int64, rows [L] int64): the rows ordered
    by leaf slot (stably), as the grower's partition holds them, for a
    caller that has leaf ids but no partition."""
    lid = leaf_id.long()
    perm = torch.sort(lid, stable=True).indices.to(torch.int32)
    rows = torch.bincount(lid, minlength=num_leaves)[:num_leaves] \
        .cpu().numpy().astype(np.int64)
    begin = np.concatenate([[0], np.cumsum(rows)[:-1]]).astype(np.int64)
    return perm.contiguous(), begin, rows


def linear_normal_eq_plain(x, grad, hess, weight, perm, leaf_begin,
                           leaf_rows, feats):
    num_leaves, k = feats.shape
    d = k + 1
    dev = x.device
    pos_leaf = torch.full((perm.shape[0],), -1, dtype=torch.long,
                          device=dev)
    for leaf in range(num_leaves):
        b, m = int(leaf_begin[leaf]), int(leaf_rows[leaf])
        if m:
            pos_leaf[b:b + m] = leaf
    sel = pos_leaf >= 0
    rows = perm[sel].long()
    lid = pos_leaf[sel]
    xv, ok = gather_values(x, rows, feats[lid])
    z = torch.cat([xv, torch.ones_like(xv[:, :1])], dim=1)
    w = torch.where(ok, weight[rows], torch.zeros_like(weight[rows]))
    wh, wg = w * hess[rows], w * grad[rows]
    zz = (z[:, :, None] * z[:, None, :]).reshape(-1, d * d)
    f64 = torch.float64
    a = torch.zeros((num_leaves, d * d), dtype=f64, device=dev)
    a.index_add_(0, lid, wh.to(f64)[:, None] * zz.to(f64))
    bv = torch.zeros((num_leaves, d), dtype=f64, device=dev)
    bv.index_add_(0, lid, wg.to(f64)[:, None] * z.to(f64))
    cnt = torch.zeros(num_leaves, dtype=f64, device=dev)
    cnt.index_add_(0, lid, (w > 0).to(f64))
    return (a.float().view(num_leaves, d, d), bv.float(), cnt.float())


#: LF's layout (csrc/linear.cu): the rows kernel takes d = k + 1 up to
#: LF_ROWS_MAX_D (E <= 32 sums, all in a lane's registers, a lane a row
#: of LF_THREADS); past it the wide kernel, a lane 4, 8, 12 or up to
#: LF_WIDE_PER sums over LF_BUFS gathered chunks in flight within
#: LF_RING_BYTES
LF_ROWS_MAX_D, LF_THREADS, LF_WIDE_PER, LF_BUFS = 6, 256, 16, 3
LF_RING_BYTES = 56 * 1024


@functools.lru_cache(maxsize=None)
def normal_eq_plan(k: int) -> dict:
    """LF's launch plan at k features a leaf (E = d(d+1)/2 + d + 1 sums,
    d = k + 1). Rows kernel (d <= LF_ROWS_MAX_D): tiles of 2,048 rows,
    row r of a tile on lane r % 256, the 8 warps' sums added in warp
    order (`lanes` 256, `per_slice` 8). Wide kernel: a lane up to
    LF_WIDE_PER sums, every sum over the tile's rows in order (`lanes`
    1, `per_slice` 1), rows gathered in chunks of `chunk` (a power of
    two); tiles of 256 rows, to fill the grid (a tile's sums take one
    block up to LF_THREADS x LF_WIDE_PER of them)."""
    d = k + 1
    entries = d * (d + 1) // 2 + d + 1
    if d <= LF_ROWS_MAX_D:
        return {"entries": entries, "kernel": "rows", "tile_rows": 2048,
                "lanes": LF_THREADS, "per_slice": LF_THREADS // 32,
                "chunk": LF_THREADS}
    stride = (d + 3) | 1
    chunk = LF_THREADS
    while chunk > 1 and LF_BUFS * chunk * stride * 4 > LF_RING_BYTES:
        chunk //= 2
    return {"entries": entries, "kernel": "wide", "tile_rows": 256,
            "lanes": 1, "per_slice": 1, "chunk": chunk}


def _check_normal_eq(x, grad, hess, weight, perm, leaf_begin, leaf_rows,
                     feats):
    n = x.shape[0]
    num_leaves, k = feats.shape
    check_linear_features(k)
    if any(t.shape != (n,) for t in (grad, hess, weight, perm)) \
            or len(leaf_begin) != num_leaves or len(leaf_rows) != num_leaves:
        raise LightGBMError("linear_normal_eq takes x [N, F], grad/hess/"
                            "weight/perm [N] and [L] segments for feats "
                            "[L, k]")
    if any(t.device != x.device for t in (grad, hess, weight, perm, feats)):
        raise LightGBMError("linear_normal_eq: inputs on different devices")


def linear_normal_eq_order(x, grad, hess, weight, perm, leaf_begin,
                           leaf_rows, feats):
    """LF's sums in torch ops on the inputs' device, in the kernel's
    order (`normal_eq_plan`): each term formed in f32 as the JAX package
    forms it and taken exactly into f64; within a tile of a leaf's
    segment, lane r % lanes adds its rows r in order from 0; each sum
    over a warp's 32 lanes by the shuffle tree (lane l takes lane l + o,
    o = 16, 8, 4, 2, 1); the warps in warp order; a leaf's tiles in
    order from 0; rounded once to f32. (The wide kernel's one lane a
    sum is this with lanes = 1: the tree and the warps add zeros.)"""
    _check_normal_eq(x, grad, hess, weight, perm, leaf_begin, leaf_rows,
                     feats)
    num_leaves, k = feats.shape
    d = k + 1
    plan = normal_eq_plan(k)
    rows_t, lanes, per = plan["tile_rows"], plan["lanes"], plan["per_slice"]
    dev = x.device
    f64 = torch.float64
    meta, n_tiles = segment_tiles(leaf_begin, leaf_rows, rows_t)
    tiles = torch.from_numpy(meta[:3 * n_tiles].reshape(n_tiles, 3)
                             .astype(np.int64)).to(dev)
    first = meta[3 * n_tiles:3 * n_tiles + num_leaves].astype(np.int64)
    count = meta[3 * n_tiles + num_leaves:].astype(np.int64)
    offs = torch.arange(rows_t, device=dev)
    valid = offs[None, :] < tiles[:, 2:3]                   # [T, R]
    pos = torch.where(valid, tiles[:, 1:2] + offs[None, :], 0)
    rows = perm[pos.reshape(-1)].long()
    leaf = tiles[:, :1].expand(-1, rows_t).reshape(-1)
    xv, ok = gather_values(x, rows, feats[leaf])
    z = torch.cat([xv, torch.ones_like(xv[:, :1])], dim=1)
    w = torch.where(ok, weight[rows], torch.zeros_like(weight[rows]))
    w = torch.where(valid.reshape(-1), w, torch.zeros_like(w))
    wh, wg = w * hess[rows], w * grad[rows]
    ia, ja = np.triu_indices(d)
    zz = z[:, torch.from_numpy(ia).to(dev)] * z[:, torch.from_numpy(ja)
                                               .to(dev)]
    terms = torch.cat([wh.to(f64)[:, None] * zz.to(f64),
                       wg.to(f64)[:, None] * z.to(f64),
                       (w > 0).to(f64)[:, None]], dim=1)
    entries = terms.shape[1]
    terms = torch.where(valid.reshape(-1, 1), terms,
                        torch.zeros((), dtype=f64, device=dev))
    terms = terms.view(n_tiles, rows_t // lanes, lanes, entries)
    acc = torch.zeros((n_tiles, lanes, entries), dtype=f64, device=dev)
    for i in range(rows_t // lanes):
        acc = acc + terms[:, i]
    warp = torch.zeros((n_tiles, 32 * per, entries), dtype=f64, device=dev)
    warp[:, :lanes] = acc
    warp = warp.view(n_tiles, per, 32, entries)
    for o in (16, 8, 4, 2, 1):
        warp = warp[:, :, :o] + warp[:, :, o:2 * o]
    part = warp[:, 0, 0]
    for g in range(1, per):
        part = part + warp[:, g, 0]
    out = torch.zeros((num_leaves, entries), dtype=f64, device=dev)
    for j in range(int(count.max()) if num_leaves else 0):
        has = np.nonzero(count > j)[0]
        at = torch.from_numpy(has).to(dev)
        out[at] = out[at] + part[torch.from_numpy(first[has] + j).to(dev)]
    out = out.float()
    n_a = d * (d + 1) // 2
    a = torch.zeros((num_leaves, d, d), dtype=torch.float32, device=dev)
    a[:, ia, ja] = out[:, :n_a]
    a[:, ja, ia] = out[:, :n_a]
    return a, out[:, n_a:n_a + d].contiguous(), out[:, n_a + d].contiguous()


# the segments of the last calls on the card, by content: a call with
# the same segments (a timing loop, a CUDA graph's capture) copies none
_SEGMENTS_KEPT = 8
_segment_cache: dict = {}


def _segments(leaf_begin, leaf_rows, dev: torch.device) -> torch.Tensor:
    """[2, L] int32 on `dev`: each leaf's first perm position and rows
    (2L words: one small copy up); the card cuts them into tiles."""
    host = np.concatenate([leaf_begin, leaf_rows]).astype(np.int32)
    key = (dev.index, host.tobytes())
    with _launch_lock:
        seg = _segment_cache.get(key)
    if seg is None:
        seg = torch.from_numpy(host).to(dev)
        with _launch_lock:
            _segment_cache[key] = seg
            while len(_segment_cache) > _SEGMENTS_KEPT:
                del _segment_cache[next(iter(_segment_cache))]
    return seg


def linear_normal_eq(x: torch.Tensor, grad: torch.Tensor,
                     hess: torch.Tensor, weight: torch.Tensor,
                     perm: torch.Tensor, leaf_begin: np.ndarray,
                     leaf_rows: np.ndarray, feats: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """LF: (A [L, d, d], b [L, d], cnt [L]) f32 of every leaf slot, from
    x [N, F], grad/hess/weight [N] f32, the partition perm [N] i32 with
    each leaf's segment (leaf_begin, leaf_rows: host int [L]) and the
    leaves' feature columns feats [L, k] i32 (-1 padded)."""
    _check_normal_eq(x, grad, hess, weight, perm, leaf_begin, leaf_rows,
                     feats)
    if x.device.type == "cpu":
        return linear_normal_eq_plain(x, grad, hess, weight, perm,
                                      leaf_begin, leaf_rows, feats)
    _on_cuda("linear_normal_eq", (x, grad, hess, weight, perm, feats),
             (torch.float32,) * 4 + (torch.int32,) * 2)
    n, nf = x.shape
    num_leaves, k = feats.shape
    d = k + 1
    plan = normal_eq_plan(k)
    dev = x.device
    seg = _segments(leaf_begin, leaf_rows, dev)
    max_tiles = -(-n // plan["tile_rows"]) + num_leaves
    # scratch: the tiles' f64 sums, then each leaf's first tile and count
    part_bytes = max_tiles * plan["entries"] * 8
    scratch = torch.empty(part_bytes + 8 * num_leaves, dtype=torch.uint8,
                          device=dev)
    out = torch.empty(num_leaves * (d * d + d + 1), dtype=torch.float32,
                      device=dev)
    a = out[:num_leaves * d * d].view(num_leaves, d, d)
    bv = out[num_leaves * d * d:num_leaves * (d * d + d)].view(num_leaves, d)
    cnt = out[num_leaves * (d * d + d):]
    _check_rows_kernel()
    _launch(linear_normal_eq, "lgbt_linear_normal_eq", dev,
            _ptr(x), nf, _ptr(grad), _ptr(hess), _ptr(weight), _ptr(perm),
            _ptr(seg), num_leaves, _ptr(feats), k, plan["tile_rows"],
            plan["chunk"], max_tiles, ctypes.c_void_p(scratch.data_ptr()
                                                      + part_bytes),
            _ptr(scratch), _ptr(a), _ptr(bv), _ptr(cnt))
    return a, bv, cnt


@functools.lru_cache(maxsize=None)
def _check_rows_kernel() -> None:
    """The built library's rows kernel takes the d the plan gives it."""
    if _build.load_library("linear").lgbt_linear_rows_max_d() \
            != LF_ROWS_MAX_D:
        raise LightGBMError("linear_normal_eq: csrc/linear.cu's rows kernel "
                            "differs from ops/linear.py's plan")


# ----------------------------------------------------------------------
# LS
#: LS's layout (csrc/linear.cu): up to d = k + 1 = LS_REGS_MAX_D a lane a
#: row of [A | rhs] in registers, d rounded up to a power of two lanes a
#: leaf, LS_REGS_THREADS threads a block; past it a block a leaf of 32 x
#: (1 + bulk) threads, bulk warps (LS_BULK_WARPS) updating the trailing
#: matrix a row each, the system in shared memory up to LS_SMEM_MAX
#: bytes, else in a global scratch
LS_REGS_MAX_D, LS_REGS_THREADS = 16, 64
LS_BULK_WARPS = (3, 15)
LS_SMEM_MAX = 227 * 1024


@functools.lru_cache(maxsize=None)
def solve_plan(k: int) -> dict:
    """LS's launch plan at k features a leaf (d = k + 1): `mode` "regs"
    (a lane a row, `lanes` lanes a leaf, `threads` a block, no shared
    memory) or "block" (a block of `threads` threads a leaf; [A | rhs]
    in rows of `stride` words, odd, in shared memory or, where
    `sys_words` > 0, that many words a leaf of global scratch; two
    buffers of d multipliers and two of d row slots); `smem` the dynamic
    shared bytes."""
    d = k + 1
    if d <= LS_REGS_MAX_D:
        lanes = 1 << (d - 1).bit_length()
        return {"mode": "regs", "threads": LS_REGS_THREADS,
                "lanes": max(lanes, 2), "smem": 0, "sys_words": 0}
    lo, hi = LS_BULK_WARPS
    bulk = min(hi, max(lo, -(-(d - 1) // 4)))
    stride = (d + 1) | 1
    buffers = 4 * d * 4
    system = d * stride * 4
    in_smem = system + buffers <= LS_SMEM_MAX
    return {"mode": "block", "threads": 32 * (1 + bulk), "stride": stride,
            "smem": buffers + (system if in_smem else 0),
            "sys_words": 0 if in_smem else d * stride}


@functools.lru_cache(maxsize=None)
def _check_solve_kernel() -> None:
    """The built library's register mode takes the d the plan gives it."""
    if _build.load_library("linear").lgbt_linear_solve_regs_max_d() \
            != LS_REGS_MAX_D:
        raise LightGBMError("linear_solve: csrc/linear.cu's register mode "
                            "differs from ops/linear.py's plan")


def linear_solve_plain(a_sum, b_sum, cnt, feats, leaf_const, linear_lambda):
    num_leaves, d = b_sum.shape
    k = d - 1
    dev = a_sum.device
    pad = feats < 0
    lam = torch.tensor(float(linear_lambda), dtype=torch.float32,
                       device=dev)
    a = a_sum.clone()
    for i in range(k):
        a[:, i, i] = a[:, i, i] + torch.where(pad[:, i], 1.0, lam)
    enough = cnt >= 2.0 * d
    eye = torch.eye(d, dtype=torch.float32, device=dev).expand_as(a)
    a = torch.where(enough[:, None, None], a, eye).clone()
    rhs = -b_sum
    rows = torch.arange(num_leaves, device=dev)
    for c in range(d):
        p = c + torch.argmax(a[:, c:, c].abs(), dim=1)
        top, prow = a[rows, c].clone(), a[rows, p].clone()
        a[rows, c], a[rows, p] = prow, top
        top, prow = rhs[rows, c].clone(), rhs[rows, p].clone()
        rhs[rows, c], rhs[rows, p] = prow, top
        piv = a[:, c, c]
        for i in range(c + 1, d):
            m = a[:, i, c] / piv
            a[:, i, c] = m
            a[:, i, c + 1:] = a[:, i, c + 1:] - m[:, None] * a[:, c, c + 1:]
            rhs[:, i] = rhs[:, i] - m * rhs[:, c]
    for j in reversed(range(d)):
        rhs[:, j] = rhs[:, j] / a[:, j, j]
        for i in range(j):
            rhs[:, i] = rhs[:, i] - rhs[:, j] * a[:, i, j]
    fitted = enough & torch.isfinite(rhs).all(dim=1)
    coeff = torch.where(fitted[:, None] & ~pad, rhs[:, :k],
                        torch.zeros_like(rhs[:, :k]))
    value = torch.where(fitted, rhs[:, k], leaf_const)
    return value, coeff, fitted


def linear_solve(a_sum: torch.Tensor, b_sum: torch.Tensor, cnt: torch.Tensor,
                 feats: torch.Tensor, leaf_const: torch.Tensor,
                 linear_lambda: float
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """LS: (leaf_value [L] f32, leaf_coeff [L, k] f32, fitted [L] bool)
    from LF's sums, the leaves' feature slots feats [L, k] (-1: padded)
    and the grower's constants leaf_const [L] f32. On the card one
    launch, which writes all three (fitted as bytes 0 or 1 of the bool
    tensor), bitwise the plain version."""
    num_leaves, d = b_sum.shape
    k = d - 1
    check_linear_features(k)
    if a_sum.shape != (num_leaves, d, d) or cnt.shape != (num_leaves,) \
            or feats.shape != (num_leaves, k) \
            or leaf_const.shape != (num_leaves,):
        raise LightGBMError("linear_solve takes A [L, d, d], b [L, d], cnt "
                            "[L], feats [L, d-1] and leaf_const [L]")
    if any(t.device != a_sum.device
           for t in (b_sum, cnt, feats, leaf_const)):
        raise LightGBMError("linear_solve: inputs on different devices")
    if a_sum.device.type == "cpu":
        return linear_solve_plain(a_sum, b_sum, cnt, feats, leaf_const,
                                  linear_lambda)
    _on_cuda("linear_solve", (a_sum, b_sum, cnt, feats, leaf_const),
             (torch.float32,) * 3 + (torch.int32, torch.float32))
    dev = a_sum.device
    plan = solve_plan(k)
    value = torch.empty(num_leaves, dtype=torch.float32, device=dev)
    coeff = torch.empty((num_leaves, k), dtype=torch.float32, device=dev)
    fitted = torch.empty(num_leaves, dtype=torch.bool, device=dev)
    sys = (torch.empty(num_leaves * plan["sys_words"], dtype=torch.float32,
                       device=dev) if plan["sys_words"] else None)
    _check_solve_kernel()
    _launch(linear_solve, "lgbt_linear_solve", dev, _ptr(a_sum),
            _ptr(b_sum), _ptr(cnt), _ptr(feats), _ptr(leaf_const),
            float(linear_lambda), num_leaves, k,
            0 if plan["mode"] == "regs" else 1, plan["threads"],
            plan["smem"], _ptr(sys), _ptr(value), _ptr(coeff), _ptr(fitted))
    if plan["mode"] == "block":
        with _launch_lock:
            linear_solve.launches_block += 1
    return value, coeff, fitted


# ----------------------------------------------------------------------
# LA
def linear_addend_plain(x, leaf_id, value, coeff, feats, score, scale):
    lid = leaf_id.long()
    rows = torch.arange(x.shape[0], device=x.device)
    xv, ok = gather_values(x, rows, feats[lid])
    lin = linear_dot_plain(coeff[lid], xv)
    s = torch.tensor(float(scale), dtype=torch.float32, device=x.device)
    t = value[lid] + torch.where(ok, lin, torch.zeros_like(lin))
    score += s * t


def linear_addend(x: torch.Tensor, leaf_id: torch.Tensor,
                  value: torch.Tensor, coeff: torch.Tensor,
                  feats: torch.Tensor, score: torch.Tensor,
                  scale: float = 1.0) -> None:
    """LA, in place: score[r] += scale * (value[l] + row_ok * lin) with
    l = leaf_id[r], over x [N, F]; value [L], coeff [L, k] f32 and feats
    [L, k] i32 (columns of x, -1 padded)."""
    n, nf = x.shape
    num_leaves, k = coeff.shape
    if leaf_id.shape != (n,) or score.shape != (n,) \
            or value.shape != (num_leaves,) or feats.shape != (num_leaves, k):
        raise LightGBMError("linear_addend takes x [N, F], leaf_id/score "
                            "[N], value [L], coeff and feats [L, k]")
    if score.dtype != torch.float32 or x.dtype != torch.float32:
        raise LightGBMError("linear_addend takes f32 rows and score")
    if any(t.device != x.device
           for t in (leaf_id, value, coeff, feats, score)):
        raise LightGBMError("linear_addend: inputs on different devices")
    if x.device.type == "cpu":
        return linear_addend_plain(x, leaf_id, value, coeff, feats, score,
                                   scale)
    _on_cuda("linear_addend", (x, leaf_id, value, coeff, feats, score),
             (torch.float32, torch.int32, torch.float32, torch.float32,
              torch.int32, torch.float32))
    if n == 0:
        return None
    _launch(linear_addend, "lgbt_linear_addend", x.device, _ptr(x), n, nf,
            _ptr(leaf_id), _ptr(value), _ptr(coeff), _ptr(feats), num_leaves,
            k, float(scale), _ptr(score))
    return None


linear_normal_eq.launches = 0
linear_solve.launches = 0
linear_solve.launches_block = 0   # of them, the block mode's
linear_addend.launches = 0
