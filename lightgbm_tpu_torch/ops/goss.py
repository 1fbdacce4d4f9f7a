"""GOSS row weights: kernels GT and GW's wrappers and their plain
PyTorch versions.

Counterpart of `lightgbm_tpu/boosting/goss.py` `_goss_impl` (:59) for
one tree an iteration: mag = |g*h| per row, thresh = the top_k-th
largest mag, and the weight of a row 1 if mag >= thresh (every row tied
at the threshold is a top row), else `multiply` if its uniform of JAX's
threefry stream, `uniform(key, (n,))` with key = fold_in(PRNGKey(
bagging_seed), iteration) (`ops/rng.py`), is below `rest_p`, else 0.
The JAX package computes rest_p = other_k / max(1, n - top_k) and
multiply = (n - top_k) / other_k as Python floats that meet its f32
arrays as weak types, so they round to f32 first: `goss_rates` rounds
them, once, and both versions of GW take those f32 values.

- GT, `goss_threshold`: mag and the threshold, by a radix select on
  mag's bits on the card (`csrc/goss.cu`: one cooperative launch, three
  passes of 11, 11 and 10-bit digits over a scratch of counts zeroed
  once a device and stream, `_gt_scratch`), exactly -sort(-mag)[top_k -
  1] (a NaN mag sorts after every number, as in JAX's sort);
  `goss_threshold_order` replays the select's passes in torch ops;
- GW, `goss_weights`: the [n] f32 weights from mag and the threshold.

On a CUDA tensor each wrapper launches its kernel or raises; on a CPU
tensor it runs the plain version. Launches are counted in
`goss_threshold.launches` and `goss_weights.launches`.
"""
from __future__ import annotations

import ctypes
import threading
from typing import Tuple

import numpy as np
import torch

from ..log import LightGBMError
from . import _build
from .rng import Key, uniform

_launch_lock = threading.Lock()


def goss_rates(n: int, top_k: int, other_k: int) -> Tuple[float, float]:
    """(rest_p, multiply) of _goss_impl (goss.py:79-80), each rounded to
    f32 as a weak-typed Python float is where it meets an f32 array."""
    rest_p = other_k / max(1, n - top_k)
    multiply = (n - top_k) / other_k
    return float(np.float32(rest_p)), float(np.float32(multiply))


# smallest normal f32: the JAX package's f32 arithmetic runs with
# subnormals flushed to zero on XLA's CPU backend and on the TPU
_F32_TINY = float(np.finfo(np.float32).tiny)
# the quiet NaN XLA's CPU backend gives |0 * inf|
_QUIET_NAN = 0x7FC00000


def goss_magnitude(grad: torch.Tensor, hess: torch.Tensor) -> torch.Tensor:
    """mag = |g*h| [n] as `_goss_impl` computes it under XLA: a subnormal
    g or h is read as zero and a subnormal product written as zero (so
    no mag is subnormal), and a NaN mag is the quiet NaN 0x7FC00000;
    GT's kernel computes the same bits."""
    zero = torch.zeros((), dtype=torch.float32, device=grad.device)
    g = torch.where(grad.abs() < _F32_TINY, zero, grad)
    h = torch.where(hess.abs() < _F32_TINY, zero, hess)
    mag = (g * h).abs()
    mag = torch.where(mag < _F32_TINY, zero, mag)
    return torch.where(torch.isnan(mag), _quiet_nan(grad.device), mag)


def _quiet_nan(device: torch.device) -> torch.Tensor:
    return torch.tensor([_QUIET_NAN], dtype=torch.int32).view(
        torch.float32).to(device)


def goss_threshold_plain(grad: torch.Tensor, hess: torch.Tensor,
                         top_k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(mag [n], thresh [1]): |g*h| (`goss_magnitude`) and
    -sort(-mag)[top_k - 1], a NaN the quiet NaN (the card's negation
    may give another)."""
    mag = goss_magnitude(grad, hess)
    thresh = -torch.sort(-mag).values[top_k - 1:top_k]
    return mag, torch.where(torch.isnan(thresh), _quiet_nan(grad.device),
                            thresh)


# GT's digits, most significant first: (shift, width) of pass p
GT_DIGITS = ((21, 11), (10, 11), (0, 10))


def goss_threshold_order(grad: torch.Tensor, hess: torch.Tensor,
                         top_k: int) -> torch.Tensor:
    """[1] f32: GT's select replayed in torch ops, pass by pass as
    csrc/goss.cu counts and picks: the select key bits + 1 of mag
    (`goss_magnitude`; 0 for a NaN), a digit a pass counted over the
    keys that match the prefix so far, the digit where the count from
    the top reaches the remaining k; the key found, less one, is the
    threshold's bits (a NaN for key 0)."""
    mag = goss_magnitude(grad, hess)
    bits = mag.view(torch.int32).long() & 0xFFFFFFFF
    key = torch.where(torch.isnan(mag), torch.zeros_like(bits), bits + 1)
    prefix, k = 0, int(top_k)
    for p, (shift, width) in enumerate(GT_DIGITS):
        if p:
            above = GT_DIGITS[p - 1][0]
            live = key[(key >> above) == (prefix >> above)]
        else:
            live = key
        counts = torch.bincount((live >> shift) & ((1 << width) - 1),
                                minlength=1 << width)
        from_top = counts.flip(0).cumsum(0).flip(0)   # count of digits >= d
        d = int((from_top >= k).nonzero().max())
        k -= int(from_top[d] - counts[d])
        prefix |= d << shift
    if prefix == 0:
        return _quiet_nan(grad.device)
    return torch.tensor([prefix - 1], dtype=torch.int32).view(
        torch.float32).to(grad.device)


def goss_weights_plain(mag: torch.Tensor, thresh: torch.Tensor, key: Key,
                       rest_p: float, multiply: float,
                       out: torch.Tensor) -> torch.Tensor:
    dev = mag.device
    u = uniform(key, mag.shape[0], dev)
    rp = torch.tensor(rest_p, dtype=torch.float32, device=dev)
    mul = torch.tensor(multiply, dtype=torch.float32, device=dev)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    one = torch.ones((), dtype=torch.float32, device=dev)
    return out.copy_(torch.where(mag >= thresh, one,
                                 torch.where(u < rp, mul, zero)))


_gt_scratches = {}


def _gt_scratch(lib, dev: torch.device, stream: int) -> torch.Tensor:
    """GT's scratch for one device and stream: its barrier word and count
    buffers, zeroed once here; each launch leaves them as it found them
    (csrc/goss.cu), so no call zeroes them again."""
    key = (dev.index, stream)
    with _launch_lock:
        t = _gt_scratches.get(key)
        if t is None:
            t = torch.zeros(lib.lgbt_goss_scratch_ints(), dtype=torch.int32,
                            device=dev)
            _gt_scratches[key] = t
    return t


def _ok(rc: int, lib, what: str) -> None:
    if rc != 0:
        raise LightGBMError("%s launch failed: CUDA error %d (%s)"
                            % (what, rc, lib.lgbt_error_string(rc).decode()))


def _ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def goss_threshold(grad: torch.Tensor, hess: torch.Tensor,
                   top_k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """GT: mag = |grad * hess| [n] f32 and the top_k-th largest mag as a
    [1] f32 tensor on the inputs' device (no host read)."""
    n = grad.shape[0]
    for t in (grad, hess):
        if t.shape != (n,) or t.dtype != torch.float32:
            raise LightGBMError("goss_threshold takes f32 [n] grad and "
                                "hess")
    if hess.device != grad.device:
        raise LightGBMError("goss_threshold: inputs on different devices")
    if not 1 <= top_k <= n:
        raise LightGBMError("goss_threshold: top_k must be in [1, n] (got "
                            "%d of %d rows)" % (top_k, n))
    if grad.device.type == "cpu":
        return goss_threshold_plain(grad, hess, top_k)
    if grad.device.type != "cuda":
        raise LightGBMError("goss_threshold runs on cpu or cuda, not %s"
                            % grad.device)
    if not (grad.is_contiguous() and hess.is_contiguous()):
        raise LightGBMError("goss_threshold takes contiguous tensors")
    dev = grad.device
    mag = torch.empty(n, dtype=torch.float32, device=dev)
    thresh = torch.empty(1, dtype=torch.float32, device=dev)
    lib = _build.load_library("goss")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        scratch = _gt_scratch(lib, dev, stream)
        rc = lib.lgbt_goss_threshold(_ptr(grad), _ptr(hess), n, top_k,
                                     _ptr(mag), _ptr(scratch), _ptr(thresh),
                                     ctypes.c_void_p(stream))
    _ok(rc, lib, "goss_threshold")
    with _launch_lock:
        goss_threshold.launches += 1
    return mag, thresh


def goss_weights(mag: torch.Tensor, thresh: torch.Tensor, key: Key,
                 rest_p: float, multiply: float,
                 out: torch.Tensor) -> torch.Tensor:
    """GW: out[r] = 1 if mag[r] >= thresh, else multiply if uniform(key,
    (n,))[r] < rest_p, else 0 (f32 [n], contiguous); rest_p and multiply
    are the f32 values of `goss_rates`."""
    n = mag.shape[0]
    if mag.shape != (n,) or out.shape != (n,) or thresh.shape != (1,) \
            or any(t.dtype != torch.float32 for t in (mag, thresh, out)):
        raise LightGBMError("goss_weights takes f32 mag [n], thresh [1] "
                            "and out [n]")
    if any(t.device != mag.device for t in (thresh, out)):
        raise LightGBMError("goss_weights: inputs on different devices")
    if any(float(np.float32(v)) != v for v in (rest_p, multiply)):
        raise LightGBMError("goss_weights takes rest_p and multiply as f32 "
                            "values (goss_rates)")
    if mag.device.type == "cpu":
        return goss_weights_plain(mag, thresh, key, rest_p, multiply, out)
    if mag.device.type != "cuda":
        raise LightGBMError("goss_weights runs on cpu or cuda, not %s"
                            % mag.device)
    if not (mag.is_contiguous() and out.is_contiguous()):
        raise LightGBMError("goss_weights takes contiguous tensors")
    lib = _build.load_library("goss")
    with torch.cuda.device(mag.device):
        stream = torch.cuda.current_stream(mag.device).cuda_stream
        rc = lib.lgbt_goss_weights(
            _ptr(mag), _ptr(thresh), n, key[0], key[1],
            rest_p, multiply, _ptr(out), ctypes.c_void_p(stream))
    _ok(rc, lib, "goss_weights")
    with _launch_lock:
        goss_weights.launches += 1
    return out


goss_threshold.launches = 0
goss_weights.launches = 0
