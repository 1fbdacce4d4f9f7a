"""H's hi+lo mode (`tpu_hist_bf16`, the JAX package's default) against
the JAX package.

- `ops/histogram.bf16_round` equals `jnp.asarray(x).astype(
  jnp.bfloat16)` and `hi_lo` equals the JAX package's jitted `_hi_lo`
  bit for bit on a sweep of f32 bit patterns: every exponent with
  mantissas at and around the rounding boundaries, the subnormals, +-0,
  +-inf and NaN. XLA's CPU backend rounds to nearest even and keeps
  subnormals in the convert, but its subtraction reads subnormal
  operands as zero and flushes a subnormal difference (to the zero of
  its sign), and it makes every NaN the quiet NaN of its sign; torch's
  own conversion does neither.
- H's plain hi+lo version against `leaf_histogram` with `bf16=True`, all
  rows and a row list (the id-masked `gathered_leaves_histogram`):
  counts exact, g and h within 1e-5 * max(1, |ref|) (f32 reassociation
  of the hi and lo sums) and as close to a float64 sum of the exact
  halves.
- Training with the default params (hi+lo on both sides) and with
  `tpu_hist_bf16=false`, weighted and unweighted, on the CPU: the same
  trees as the JAX package, raw predictions within 1e-5 * max(1, |ref|).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import lightgbm_tpu as jlgb
import lightgbm_tpu_torch as tlgb
from lightgbm_tpu.ops import histogram as jh
from lightgbm_tpu_torch.ops.histogram import (bf16_round, hi_lo,
                                              leaf_histogram,
                                              leaf_histogram_plain)

torch.set_num_threads(1)

_MANTISSAS = [0, 1, 2, 0x7FFF, 0x8000, 0x8001, 0xFFFF, 0x10000, 0x17FFF,
              0x18000, 0x18001, 0x123456, 0x3FFFFF, 0x400000, 0x7F7FFF,
              0x7F8000, 0x7FC000, 0x7FFFFF]


def sweep() -> np.ndarray:
    """f32 bit patterns: every exponent (0 = zero and subnormals, 255 =
    inf and NaN) times the mantissas, both signs."""
    e = np.arange(256, dtype=np.uint32)
    m = np.asarray(_MANTISSAS, np.uint32)
    bits = (e[:, None] << 23 | m[None, :]).ravel()
    return np.concatenate([bits, bits | 0x80000000]).view(np.float32)


def bits16(x) -> np.ndarray:
    return np.asarray(x).view(np.uint16)


def port_bits16(t: torch.Tensor) -> np.ndarray:
    u = t.view(torch.int32).numpy().view(np.uint32)
    assert not np.any(u & 0xFFFF), "not a bf16 value"
    return (u >> 16).astype(np.uint16)


def test_bf16_round_is_xla_convert_bitwise():
    x = sweep()
    ref = bits16(jnp.asarray(x).astype(jnp.bfloat16))
    got = port_bits16(bf16_round(torch.from_numpy(x.copy())))
    assert np.array_equal(got, ref)
    assert {int(v) for v in ref[np.isnan(x)]} == {0x7FC0, 0xFFC0}


def test_hi_lo_is_the_jax_split_bitwise():
    x = sweep()
    jhi, jlo = jax.jit(jh._hi_lo)(jnp.asarray(x))
    hi, lo = hi_lo(torch.from_numpy(x.copy()))
    assert np.array_equal(port_bits16(hi), bits16(jhi))
    assert np.array_equal(port_bits16(lo), bits16(jlo))
    # the cases where torch's own arithmetic gives other bits
    sub = (np.abs(x) < np.finfo(np.float32).tiny) & (x != 0)
    assert sub.sum() > 0 and not np.any(bits16(jlo)[sub] & 0x7F)


N, G, B, CHUNK = 4096, 5, 32, 512


def inputs(seed):
    rng = np.random.RandomState(seed)
    binned = rng.randint(0, B, (N, G)).astype(np.uint8)
    binned[:, 4] = rng.randint(0, 3, N)
    w = np.where(np.arange(N) % 3 == 0, 0.5, 1.0).astype(np.float32)
    w[rng.rand(N) < 0.1] = 0.0
    grad = (rng.randn(N) * 0.7).astype(np.float32)
    hess = (rng.rand(N) * 0.25 + 1e-3).astype(np.float32)
    w3 = np.stack([grad * w, hess * w, w], 1).astype(np.float32)
    return binned, w3, rng.randint(0, 4, N).astype(np.int32)


def halves_oracle(binned, w3, rows):
    """float64 sums of the exact hi + lo values of the given rows."""
    hi, lo = hi_lo(torch.from_numpy(w3[:, :2].copy()))
    v = hi.double().numpy() + lo.double().numpy()
    out = np.zeros((G, B, 3))
    for g in range(G):
        b = binned[rows, g].astype(np.int64)
        for c in range(2):
            np.add.at(out[g, :, c], b, v[rows, c])
        np.add.at(out[g, :, 2], b, (w3[rows, 2] > 0).astype(np.float64))
    return out


def close(port, ref, oracle):
    port = np.asarray(port, np.float64)
    ref = np.asarray(ref, np.float64)
    assert np.array_equal(port[..., 2], ref[..., 2])
    assert np.array_equal(port[..., 2], oracle[..., 2])
    for other in (ref, oracle):
        bound = 1e-5 * np.maximum(1.0, np.abs(other[..., :2]))
        assert np.all(np.abs(port[..., :2] - other[..., :2]) <= bound)


@pytest.mark.parametrize("mode", ["all_rows", "row_list"])
def test_plain_hi_lo_histogram_against_the_jax_bf16_histogram(mode):
    binned, w3, leaf_id = inputs(3)
    tb, tw = torch.from_numpy(binned), torch.from_numpy(w3)
    # the JAX grower's count channel is 1[w > 0] (learner/grow.py:778-779)
    jw3 = w3.copy()
    jw3[:, 2] = w3[:, 2] > 0
    if mode == "all_rows":
        ref = jh.leaf_histogram(jnp.asarray(binned), jnp.asarray(jw3), B,
                                chunk=CHUNK, bf16=True)
        got = leaf_histogram(tb, tw, B, bf16=True)
        rows = np.arange(N)
    else:
        rows = np.flatnonzero(leaf_id == 2).astype(np.int32)
        cap = -(-len(rows) // CHUNK) * CHUNK
        buf = np.zeros(cap, np.int32)
        buf[:len(rows)] = rows
        ref = jh.gathered_leaves_histogram(
            jnp.asarray(binned), jnp.asarray(jw3), jnp.asarray(leaf_id),
            jnp.asarray(buf), jnp.asarray([2], jnp.int32), B, chunk=CHUNK,
            bf16=True, n_valid=len(rows))[0]
        got = leaf_histogram(tb, tw, B, rows=torch.from_numpy(buf),
                             n_rows=len(rows), bf16=True)
    oracle = halves_oracle(binned, w3, rows)
    close(got, ref, oracle)
    # the f32 mode sums other values: the two modes differ in the low bits
    f32 = leaf_histogram_plain(tb, tw, B, bf16=False)
    assert not torch.equal(f32, leaf_histogram_plain(tb, tw, B, bf16=True))


def make(seed, n):
    r = np.random.RandomState(seed)
    x = r.randn(n, 7)
    x[r.rand(n) < 0.1, 2] = np.nan
    x[r.rand(n) < 0.3, 3] = 0.0
    f = (x[:, 0] + 0.8 * np.nan_to_num(x[:, 2]) - 0.5 * x[:, 3] * x[:, 4]
         + np.sin(2 * x[:, 1]))
    return x, f + 0.8 * r.randn(n)


X, F = make(0, 3000)
XV, FV = make(1, 1000)
Y = (F > 0).astype(float)
WEIGHT = np.where(np.arange(len(X)) % 3 == 0, 0.5, 1.0)


def assert_same_trees(jb, tb):
    jt, tt = jb._inner.models, tb._inner.models
    assert len(jt) == len(tt) > 0
    for i, (a, b) in enumerate(zip(jt, tt)):
        m = a.num_leaves - 1
        assert a.num_leaves == b.num_leaves, i
        for k in ("split_feature", "threshold_in_bin", "decision_type",
                  "left_child", "right_child"):
            assert np.array_equal(getattr(a, k)[:m], getattr(b, k)[:m]), \
                (i, k)
        assert np.array_equal(a.leaf_count, b.leaf_count), i


@pytest.mark.parametrize("weighted", [False, True],
                         ids=["unweighted", "weighted"])
@pytest.mark.parametrize("bf16", [True, False],
                         ids=["default_hi_lo", "tpu_hist_bf16_false"])
def test_training_grows_the_jax_trees_under_either_setting(bf16, weighted):
    params = {"objective": "binary", "num_leaves": 15, "max_bin": 63,
              "learning_rate": 0.3, "min_data_in_leaf": 10,
              "min_sum_hessian_in_leaf": 1.0, "verbose": -1}
    if not bf16:
        params["tpu_hist_bf16"] = False
    w = WEIGHT if weighted else None
    jb = jlgb.train(dict(params), jlgb.Dataset(X, Y, weight=w), 8)
    tb = tlgb.train(dict(params), tlgb.Dataset(X, Y, weight=w), 8,
                    device="cpu")
    assert tb._inner._grower.cfg.hist_bf16 is bf16
    assert_same_trees(jb, tb)
    ref = jb.predict(XV, raw_score=True)
    got = tb.predict(XV, raw_score=True)
    assert np.all(np.abs(got - ref) <= 1e-5 * np.maximum(1.0, np.abs(ref)))
