"""GT's select (`lightgbm_tpu_torch/ops/goss.py`) against the JAX package,
on the CPU.

GT (`csrc/goss.cu`) finds GOSS's threshold, the top_k-th largest |g*h|,
by a radix select of three digit passes in one cooperative launch;
`goss_threshold_order` replays those passes in torch ops. Held here, on
seeded gradients with ties at the k-th value, NaN, zero and subnormal
magnitudes (and subnormal g and h, which XLA reads as zero), all-equal
magnitudes, top_k = 1 and top_k = n:

- the replay's threshold, the plain version's (`goss_threshold` on the
  CPU) and the JAX package's, `_goss_impl`'s mag and -sort(-mag)[top_k -
  1] under jit, have the same bits;
- the magnitudes (`goss_magnitude`) are the JAX package's bits;
- `_goss_impl`'s weights equal GT and GW's plain versions bit for bit
  on the subnormal cases, where XLA flushes;
- the digits cover the key: 11 + 11 + 10 bits, most significant first.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from lightgbm_tpu.boosting.goss import _goss_impl
from lightgbm_tpu_torch.ops.goss import (GT_DIGITS, goss_magnitude,
                                         goss_rates, goss_threshold,
                                         goss_threshold_order,
                                         goss_weights)
from lightgbm_tpu_torch.ops.rng import fold_in, prng_key

torch.set_num_threads(1)
N = 4099


@jax.jit
def jax_mag(g, h):
    """`_goss_impl`'s mag for one class (goss.py:66-68)."""
    n = g.shape[0]
    return jnp.abs(g.reshape(1, n) * h.reshape(1, n)).sum(axis=0)


def jax_threshold(g, h, top_k):
    """`_goss_impl`'s threshold, -sort(-mag)[top_k - 1] (goss.py:70)."""
    mag = jax_mag(jnp.asarray(g), jnp.asarray(h))
    return np.asarray(-jnp.sort(-mag)[top_k - 1]).reshape(1)


_jit_goss = jax.jit(_goss_impl, static_argnames=(
    "seed", "k", "n", "n_pad", "top_k", "other_k"))


def gradients(kind, n=N, seed=0):
    rng = np.random.RandomState(seed)
    g = rng.randn(n).astype(np.float32)
    h = (rng.rand(n) * 0.25).astype(np.float32)
    tiny = np.finfo(np.float32).tiny
    if kind == "ties":
        g = np.round(g * 2) / 2
        h[:] = 0.25
    elif kind == "nan":
        g[rng.rand(n) < 0.2] = np.nan
        h[rng.rand(n) < 0.05] = np.inf
        g[rng.rand(n) < 0.05] = 0.0      # 0 * inf: NaN too
    elif kind == "zeros":
        g[rng.rand(n) < 0.7] = 0.0
        g[rng.rand(n) < 0.1] = -0.0
    elif kind == "subnormal_products":
        # normal g and h whose products are subnormal
        small = rng.rand(n) < 0.5
        g[small] = (rng.rand(int(small.sum())) * 1e-20).astype(np.float32)
        h[small] = (rng.rand(int(small.sum())) * 1e-19).astype(np.float32)
    elif kind == "subnormal_inputs":
        # subnormal g or h: XLA reads them as zero
        sub = rng.rand(n) < 0.3
        g[sub] = (rng.rand(int(sub.sum())) * tiny).astype(np.float32)
        h[rng.rand(n) < 0.3] = np.float32(tiny / 4)
        h[:5] = np.inf
        g[:5] = np.float32(tiny / 2)
    elif kind == "all_equal":
        g[:] = -0.5
        h[:] = 0.125
    return g.astype(np.float32), h.astype(np.float32)


KINDS = ["random", "ties", "nan", "zeros", "subnormal_products",
         "subnormal_inputs", "all_equal"]


def top_ks(g, h):
    """1, n, and the k-th values around the middle and at each edge of
    a run of ties."""
    n = len(g)
    ks = {1, 2, n - 1, n, n // 2, n // 5}
    mag = np.asarray(jax_mag(jnp.asarray(g), jnp.asarray(h)))
    order = -np.sort(-mag)
    for k in list(ks):
        v = order[k - 1]
        tied = np.flatnonzero((order == v) | (np.isnan(order) & np.isnan(v)))
        ks |= {int(tied[0]) + 1, int(tied[-1]) + 1}
    return sorted(ks)


def bits(t):
    return np.asarray(t, np.float32).view(np.uint32)


@pytest.mark.parametrize("kind", KINDS)
def test_the_replayed_select_is_the_jax_threshold_bitwise(kind):
    g, h = gradients(kind)
    tg, th = torch.from_numpy(g), torch.from_numpy(h)
    assert np.array_equal(bits(goss_magnitude(tg, th).numpy()),
                          bits(jax_mag(jnp.asarray(g), jnp.asarray(h))))
    for k in top_ks(g, h):
        want = bits(jax_threshold(g, h, k))
        assert np.array_equal(bits(goss_threshold_order(tg, th, k)), want), k
        mag, thresh = goss_threshold(tg, th, k)
        assert np.array_equal(bits(thresh.numpy()), want), k


@pytest.mark.parametrize("kind", ["subnormal_products", "subnormal_inputs",
                                  "nan"])
def test_goss_weights_equal_goss_impl_where_xla_flushes(kind):
    g, h = gradients(kind)
    n = len(g)
    rest_p, multiply = goss_rates(n, n // 5, n // 10)
    for top_k in (n // 5, n - 1):
        ref = np.asarray(_jit_goss(jnp.asarray(g), jnp.asarray(h),
                                   jnp.int32(12), seed=5, k=1, n=n, n_pad=n,
                                   top_k=top_k, other_k=n // 10))
        rest_p, multiply = goss_rates(n, top_k, n // 10)
        mag, thresh = goss_threshold(torch.from_numpy(g),
                                     torch.from_numpy(h), top_k)
        out = torch.empty(n, dtype=torch.float32)
        goss_weights(mag, thresh, fold_in(prng_key(5), 12), rest_p,
                     multiply, out)
        assert np.array_equal(bits(out.numpy()), bits(ref)), top_k


def test_the_digits_cover_the_key_most_significant_first():
    covered = 0
    top = 32
    for shift, width in GT_DIGITS:
        assert shift + width == top
        covered += width
        top = shift
    assert covered == 32 and top == 0
