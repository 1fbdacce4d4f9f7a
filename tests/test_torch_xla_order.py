"""The port's plain versions add in the order XLA's CPU backend adds.

Where the port's inputs equal the JAX package's bitwise, its sums can
too, if they add in XLA's order:

- `jnp.cumsum` lowers to a reduce_window that XLA's CPU backend rewrites
  into running sums over blocks of 16 elements plus the running sum of
  the earlier blocks' totals (`ops/split.xla_cumsum`). The split scan of
  quantized training (dequantized bins, equal to the JAX package's)
  scans in that order, so its gains and child sums equal the JAX
  package's bitwise;
- the train-score update of the JAX package runs inside one XLA
  program, which contracts `score + value * shrinkage` into a fused
  multiply-add (`ops/route.fma_f32`);
- `jnp.einsum("nk,nk->n")` at precision HIGHEST, the linear leaves'
  term, rounds and adds the first 8 products one at a time and fuses
  each later one into the sum, except for k = 2, where the second
  product is fused with the first (`ops/linear.linear_dot_plain`; LA and
  K1's linear term, bitwise against `linear_leaf_addend` for k = 9, 16,
  64);
- `jnp.exp` in f32 is XLA's Cephes polynomial with fused multiply-adds
  and a flushed subnormal result (`objectives.xla_exp_f32`, bitwise on
  2^24 inputs over [-104, 89] and the special values), so the binary
  objective's gradients equal the JAX package's bitwise;
- a sum over the leading axis of a [T, N] array (the JAX package's
  init-model replay, `vals.sum(axis=0)`) adds in order up to 32 rows
  and, from 33 to 64, sums two halves of ceil(T / 2) and the rest first
  (engine._replay_sum).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from lightgbm_tpu.ops.predict import linear_leaf_addend
from lightgbm_tpu.ops.split import find_best_splits
from lightgbm_tpu_torch.engine import _XLA_SEQUENTIAL_SUM
from lightgbm_tpu_torch.objectives import xla_exp_f32
from lightgbm_tpu_torch.ops.linear import linear_addend, linear_dot_plain
from lightgbm_tpu_torch.ops.route import fma_f32
from lightgbm_tpu_torch.ops.split import (SplitParams, split_scan_plain,
                                          xla_cumsum)

torch.set_num_threads(1)


def _bits(a):
    return np.asarray(a, np.float32).view(np.int32)


# the scan widths of the fixtures (max_bin 31 and 63, with and without
# the NaN bin), the block edges around them, and wide features
@pytest.mark.parametrize("bins", [1, 15, 16, 17, 31, 32, 63, 64, 255, 256,
                                  257, 300])
def test_xla_cumsum_equals_jnp_cumsum_bitwise(bins):
    rng = np.random.RandomState(bins)
    # dequantized bins (integer codes times an f32 scale), as the
    # quantized split scan sees them, and f32 values of spread magnitude
    codes = rng.randint(-5000, 5000, (28, bins)).astype(np.float32)
    scale = np.float32(rng.rand() / 127.0)
    spread = (rng.randn(28, bins) * np.exp(rng.randn(28, bins) * 4)
              ).astype(np.float32)
    cumsum = jax.jit(lambda a: jnp.cumsum(a, axis=1))
    for x in (codes * scale, spread):
        ref = np.asarray(cumsum(x))
        got = xla_cumsum(torch.from_numpy(x)).numpy()
        assert np.array_equal(_bits(ref), _bits(got))


def test_a_sequential_sum_is_not_the_xla_order():
    """The probe that tells the orders apart: past 16 bins a running sum
    differs from XLA's in some elements."""
    x = (np.random.RandomState(0).randn(28, 63) * 1e3).astype(np.float32)
    ref = np.asarray(jnp.cumsum(x, axis=1))
    seq = np.cumsum(x, axis=1, dtype=np.float32)
    for i in range(1, 63):
        seq[:, i] = seq[:, i - 1] + x[:, i]
    assert not np.array_equal(ref, seq)
    assert np.array_equal(ref, xla_cumsum(torch.from_numpy(x)).numpy())


@pytest.mark.parametrize("missing", [0, 1, 2])
def test_quantized_split_scan_gains_equal_the_jax_ones(missing):
    """split_scan_plain in XLA's order on a dequantized histogram: every
    feature's gain and the chosen split's left sums bitwise equal to
    lightgbm_tpu.ops.split.find_best_splits."""
    rng = np.random.RandomState(7 + missing)
    f, b = 6, 64
    num_bin = np.array([64, 63, 40, 17, 3, 64], np.int32)
    counts = rng.randint(0, 40, (f, b))
    counts[np.arange(b)[None, :] >= num_bin[:, None]] = 0
    q = np.stack([rng.randint(-120, 121, (f, b)) * counts,
                  rng.randint(1, 121, (f, b)) * counts, counts], -1)
    q = q.astype(np.int32)
    qscale = np.array([0.0123, 0.0071, 1.0], np.float32)
    hist = q.astype(np.float32) * qscale
    tot = q[0].sum(0).astype(np.float32) * qscale
    fm = {"num_bin": num_bin, "missing_type": np.full(f, missing, np.int32),
          "default_bin": np.array([0, 5, 3, 1, 0, 7], np.int32),
          "is_categorical": np.zeros(f, bool)}
    for k in range(f):
        hist[k, num_bin[k]:] = 0.0
    gp = dict(lambda_l1=0.0, lambda_l2=0.5, min_gain_to_split=0.0,
              min_data_in_leaf=3, min_sum_hessian_in_leaf=1e-3)
    ref = find_best_splits(jnp.asarray(hist), jnp.float32(tot[0]),
                           jnp.float32(tot[1]), jnp.float32(tot[2]),
                           *[jnp.asarray(fm[k]) for k in (
                               "num_bin", "missing_type", "default_bin",
                               "is_categorical")], **gp)
    fmeta = {k: torch.from_numpy(np.asarray(v, np.uint8 if v.dtype == bool
                                            else np.int32))
             for k, v in dict(fm, group=np.arange(f, dtype=np.int32),
                              offset=np.zeros(f, np.int32),
                              is_bundled=np.zeros(f, bool)).items()}
    params = SplitParams(0.0, 0.5, 0.0, 3, 1e-3, -1)
    out_f, out_i, feat_gain = split_scan_plain(
        torch.from_numpy(hist)[None], torch.from_numpy(tot)[None],
        torch.zeros(1, dtype=torch.int32), fmeta,
        torch.ones(f, dtype=torch.uint8), params, b)
    assert np.array_equal(_bits(ref.gain), _bits(feat_gain[0].numpy()))
    best = int(out_i[0, 0])
    assert int(ref.threshold[best]) == int(out_i[0, 1])
    assert np.array_equal(_bits([ref.left_sum_g[best], ref.left_count[best]]),
                          _bits([out_f[0, 1], out_f[0, 3]]))


def test_score_update_is_the_fused_multiply_add_of_xla():
    rng = np.random.RandomState(1)
    score = (rng.randn(20000) * 3).astype(np.float32)
    value = rng.randn(20000).astype(np.float32)
    lr = np.float32(0.1)
    fused = jax.jit(lambda s, v, r: s + v * r)
    ref = np.asarray(fused(score, value, lr))
    got = fma_f32(torch.from_numpy(value), torch.tensor(lr),
                  torch.from_numpy(score)).numpy()
    assert np.array_equal(_bits(ref), _bits(got))
    assert not np.array_equal(ref, score + value * lr)


@pytest.mark.parametrize("k", [1, 2, 3, 4, 5, 6, 7, 8, 9, 16, 64])
def test_linear_dot_equals_jnp_einsum_bitwise(k):
    rng = np.random.RandomState(k)
    c = (rng.randn(5000, k) * np.exp(rng.randn(5000, k) * 3)).astype(
        np.float32)
    x = (rng.randn(5000, k) * np.exp(rng.randn(5000, k) * 3)).astype(
        np.float32)
    ref = np.asarray(jax.jit(lambda a, b: jnp.einsum(
        "nk,nk->n", a, b, precision=jax.lax.Precision.HIGHEST))(c, x))
    got = linear_dot_plain(torch.from_numpy(c), torch.from_numpy(x)).numpy()
    assert np.array_equal(_bits(ref), _bits(got))


@pytest.mark.parametrize("k", [9, 16, 64])
def test_linear_addend_equals_jax_linear_leaf_addend_bitwise(k):
    """LA's plain version (the valid-set update, scale 1, from a zero
    score) against the JAX package's leaf value plus linear_leaf_addend
    in one XLA program, with padded slots and non-finite rows."""
    rng = np.random.RandomState(100 + k)
    n, f, leaves = 4000, k + 6, 5
    x = (rng.randn(n, f) * np.exp(rng.randn(n, f) * 2)).astype(np.float32)
    x[rng.rand(n) < 0.01, 3] = np.nan
    lid = rng.randint(0, leaves, n).astype(np.int32)
    feats = np.stack([rng.choice(f, k, replace=False)
                      for _ in range(leaves)]).astype(np.int32)
    feats[2, k // 2:] = -1
    coeff = (rng.randn(leaves, k) * 3).astype(np.float32)
    coeff[feats < 0] = 0.0
    value = rng.randn(leaves).astype(np.float32)
    ref = np.asarray(jax.jit(lambda v, c, fe, l, d: v[l] + linear_leaf_addend(
        c, fe, l, d))(value, coeff, feats, lid, x))
    score = torch.zeros(n)
    linear_addend(*(torch.from_numpy(a) for a in (x, lid, value, coeff,
                                                   feats)), score, 1.0)
    assert np.array_equal(_bits(ref), _bits(score.numpy()))


def test_xla_exp_equals_jnp_exp_bitwise():
    edges = np.array([0.0, -0.0, 1e-45, -1e-45, 1e-40, -1e-40, np.inf,
                      -np.inf, np.nan, 88.72283, 88.72284, 88.8, 89.0,
                      -87.33654, -87.33655, -87.8, -88.0, -103.97,
                      -104.0, 3e38, -3e38, 1.0, -1.0], np.float32)
    lo, hi = np.float32(-104.0), np.float32(89.0)
    grid = np.linspace(lo, hi, 1 << 24, dtype=np.float32)
    exp = jax.jit(jnp.exp)
    for chunk in [edges] + np.split(grid, 16):
        ref = np.asarray(exp(chunk))
        got = xla_exp_f32(torch.from_numpy(chunk)).numpy()
        assert np.array_equal(_bits(ref), _bits(got))
    # torch's own exp is not XLA's
    sample = grid[::97]
    assert not np.array_equal(
        _bits(np.asarray(exp(sample))),
        _bits(torch.exp(torch.from_numpy(sample)).numpy()))


def _xla_axis0_sum(v):
    if len(v) > _XLA_SEQUENTIAL_SUM:
        half = -(-len(v) // 2)
        return _xla_axis0_sum(v[:half]) + _xla_axis0_sum(v[half:])
    acc = np.zeros(v.shape[1], np.float32)
    for row in v:
        acc = acc + row
    return acc


@pytest.mark.parametrize("trees", [3, 10, 32, 33, 40, 64])
def test_the_replay_sum_order_is_xla_axis0_sum(trees):
    rng = np.random.RandomState(trees)
    v = (rng.randn(trees, 3000) * np.exp(rng.randn(trees, 3000) * 3)
         ).astype(np.float32)
    ref = np.asarray(jax.jit(lambda a: a.sum(axis=0))(v))
    assert np.array_equal(_bits(ref), _bits(_xla_axis0_sum(v)))
