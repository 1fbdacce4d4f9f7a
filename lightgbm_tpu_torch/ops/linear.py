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
  is not fitted or its solution is not finite;
- LA `linear_addend`: score[r] += s * (value[l] + row_ok * lin) with l =
  leaf_id[r] and lin the leaf's coefficients times the row's values
  (`linear_dot_plain`), for the train score (s = shrinkage), valid sets
  (s = 1) and rollback (s = -1).

On a CUDA tensor each wrapper launches its kernel (`csrc/linear.cu`) or
raises; on a CPU tensor it runs the plain version. LS and LA equal their
plain versions bitwise; LF forms each term in f32 as the JAX package
does and sums it in f64 (kernel and plain alike), rounding once to f32,
so the two agree up to the last f32 bit. Launches are counted in
`linear_normal_eq.launches`, `linear_solve.launches` and
`linear_addend.launches`.

Feature columns: `feats` index the columns of `x`, whatever space that
is (training: the inner space of `Dataset.raw`; serving: real columns).
A subnormal value counts as a signed zero, as on the JAX package's
backends.
"""
from __future__ import annotations

import ctypes
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
    blocks as they need and LS keeps the d x d system in shared memory,
    so any k >= 1 is taken, as the JAX package takes it."""
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


def linear_normal_eq(x: torch.Tensor, grad: torch.Tensor,
                     hess: torch.Tensor, weight: torch.Tensor,
                     perm: torch.Tensor, leaf_begin: np.ndarray,
                     leaf_rows: np.ndarray, feats: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """LF: (A [L, d, d], b [L, d], cnt [L]) f32 of every leaf slot, from
    x [N, F], grad/hess/weight [N] f32, the partition perm [N] i32 with
    each leaf's segment (leaf_begin, leaf_rows: host int [L]) and the
    leaves' feature columns feats [L, k] i32 (-1 padded)."""
    n, nf = x.shape
    num_leaves, k = feats.shape
    check_linear_features(k)
    if any(t.shape != (n,) for t in (grad, hess, weight, perm)) \
            or len(leaf_begin) != num_leaves or len(leaf_rows) != num_leaves:
        raise LightGBMError("linear_normal_eq takes x [N, F], grad/hess/"
                            "weight/perm [N] and [L] segments for feats "
                            "[L, k]")
    if any(t.device != x.device for t in (grad, hess, weight, perm, feats)):
        raise LightGBMError("linear_normal_eq: inputs on different devices")
    if x.device.type == "cpu":
        return linear_normal_eq_plain(x, grad, hess, weight, perm,
                                      leaf_begin, leaf_rows, feats)
    _on_cuda("linear_normal_eq", (x, grad, hess, weight, perm, feats),
             (torch.float32,) * 4 + (torch.int32,) * 2)
    lib = _build.load_library("linear")
    tile = lib.lgbt_linear_tile_rows()
    d = k + 1
    entries = d * (d + 1) // 2 + d + 1
    # each leaf's segment cut into tiles of `tile` rows, leaf by leaf:
    # (leaf, first position, rows) a tile, and each leaf's tile range
    meta, n_tiles = segment_tiles(leaf_begin, leaf_rows, tile)
    dev = x.device
    meta = torch.from_numpy(meta).to(dev)
    part = torch.empty(max(n_tiles, 1) * entries, dtype=torch.float64,
                       device=dev)
    a = torch.empty((num_leaves, d, d), dtype=torch.float32, device=dev)
    bv = torch.empty((num_leaves, d), dtype=torch.float32, device=dev)
    cnt = torch.empty(num_leaves, dtype=torch.float32, device=dev)
    t3 = meta[:3 * n_tiles]
    _launch(linear_normal_eq, "lgbt_linear_normal_eq", dev,
            _ptr(x), nf, _ptr(grad), _ptr(hess), _ptr(weight), _ptr(perm),
            _ptr(t3), n_tiles, _ptr(meta[3 * n_tiles:]),
            _ptr(meta[3 * n_tiles + num_leaves:]), num_leaves, _ptr(feats),
            k, _ptr(part), _ptr(a), _ptr(bv), _ptr(cnt))
    return a, bv, cnt


# ----------------------------------------------------------------------
# LS
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
    and the grower's constants leaf_const [L] f32."""
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
    value = torch.empty(num_leaves, dtype=torch.float32, device=dev)
    coeff = torch.empty((num_leaves, k), dtype=torch.float32, device=dev)
    fitted = torch.empty(num_leaves, dtype=torch.uint8, device=dev)
    _launch(linear_solve, "lgbt_linear_solve", dev, _ptr(a_sum),
            _ptr(b_sum), _ptr(cnt), _ptr(feats), _ptr(leaf_const),
            float(linear_lambda), num_leaves, k, _ptr(value), _ptr(coeff),
            _ptr(fitted))
    return value, coeff, fitted.bool()


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
            _ptr(leaf_id), _ptr(value), _ptr(coeff), _ptr(feats), k,
            float(scale), _ptr(score))
    return None


linear_normal_eq.launches = 0
linear_solve.launches = 0
linear_addend.launches = 0
