"""JAX's threefry2x32 random stream, bit for bit, and kernel M's wrapper.

The JAX package draws its bagging mask (`lightgbm_tpu/boosting/gbdt.py`
`_bagging_mask_impl`, :311) and the stochastic rounding of quantized
training (`lightgbm_tpu/ops/histogram.py` `stochastic_round`, :105) from
`jax.random`. Trees of the port equal the reference's only if its random
numbers do, so this module computes JAX's `PRNGKey(seed)`,
`fold_in(key, data)` and `uniform(key, (n,))` exactly, in the form JAX
0.9 uses by default (`jax_threefry_partitionable=True`, 32-bit seeds):

- a key is two uint32 words; `PRNGKey(s) = (0, s mod 2**32)` (without
  `jax_enable_x64` JAX casts the seed to int32 first, so the high word
  is 0);
- `fold_in(k, d) = threefry2x32(k, (0, d mod 2**32))`;
- element i of an (n,) draw hashes its own index:
  `(o0, o1) = threefry2x32(k, (i >> 32, i mod 2**32))`, `bits = o0 ^ o1`,
  and the float is `max(0, bitcast_f32((bits >> 9) | 0x3F800000) - 1)`.

Each element depends only on (key, i), so the kernel draws row i in
its own thread. The plain version runs the 20 rounds on int64 tensors
holding uint32 words (any device); `threefry2x32` also takes plain
Python ints, which is how keys are folded on the host.

`bagging_mask` (kernel M, `csrc/quantize.cu`) writes `uniform(key, i) <
fraction` as f32 0/1: on a CUDA tensor it launches the kernel or
raises, on a CPU tensor it runs the plain version. It counts its
launches in `bagging_mask.launches`.
"""
from __future__ import annotations

import ctypes
import threading
from typing import Tuple

import numpy as np
import torch

from ..log import LightGBMError
from . import _build

_M32 = 0xFFFFFFFF
_PARITY = 0x1BD11BDA
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))

Key = Tuple[int, int]

_launch_lock = threading.Lock()


def threefry2x32(k0, k1, x0, x1):
    """Threefry-2x32, 20 rounds (jax/_src/prng.py
    `_threefry2x32_lowering`), on uint32 words held in Python ints or
    int64 tensors. Returns (o0, o1)."""
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + k0) & _M32
    x1 = (x1 + k1) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = ((x1 << r) & _M32) | (x1 >> (32 - r))
            x1 = x1 ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _M32
    return x0, x1


def prng_key(seed: int) -> Key:
    """`jax.random.PRNGKey(seed)` with 32-bit seeds (JAX's default)."""
    return 0, int(seed) & _M32


def fold_in(key: Key, data: int) -> Key:
    """`jax.random.fold_in(key, data)`."""
    return threefry2x32(key[0], key[1], 0, int(data) & _M32)


def uniform(key: Key, n: int, device=None) -> torch.Tensor:
    """`jax.random.uniform(key, (n,))`: [n] f32 in [0, 1)."""
    i = torch.arange(n, dtype=torch.int64, device=device)
    o0, o1 = threefry2x32(key[0], key[1], i >> 32, i & _M32)
    bits = ((o0 ^ o1) >> 9) | 0x3F800000
    return torch.clamp_min(bits.to(torch.int32).view(torch.float32) - 1.0,
                           0.0)


def bagging_mask_plain(key: Key, fraction: float,
                       out: torch.Tensor) -> torch.Tensor:
    """out[i] = 1.0 where uniform(key)[i] < fraction (compared in f32),
    else 0.0."""
    u = uniform(key, out.shape[0], out.device)
    frac = torch.tensor(np.float32(fraction), device=out.device)
    return out.copy_((u < frac).to(torch.float32))


def bagging_mask(key: Key, fraction: float,
                 out: torch.Tensor) -> torch.Tensor:
    """M: the [n] f32 0/1 in-bag mask of `lightgbm_tpu/boosting/gbdt.py`
    `_bagging_mask_impl` drawn into `out` (contiguous f32 [n])."""
    if out.dim() != 1 or out.dtype != torch.float32 \
            or not out.is_contiguous():
        raise LightGBMError("bagging_mask writes a contiguous f32 [n] "
                            "tensor")
    if out.device.type == "cpu":
        return bagging_mask_plain(key, fraction, out)
    if out.device.type != "cuda":
        raise LightGBMError("bagging_mask runs on cpu or cuda, not %s"
                            % out.device)
    lib = _build.load_library("quantize")
    with torch.cuda.device(out.device):
        stream = torch.cuda.current_stream(out.device).cuda_stream
        rc = lib.lgbt_bagging_mask(key[0], key[1], float(np.float32(fraction)),
                                   out.shape[0], ctypes.c_void_p(out.data_ptr()),
                                   ctypes.c_void_p(stream))
    if rc != 0:
        raise LightGBMError("bagging_mask launch failed: CUDA error %d (%s)"
                            % (rc, lib.lgbt_error_string(rc).decode()))
    with _launch_lock:
        bagging_mask.launches += 1
    return out


bagging_mask.launches = 0
