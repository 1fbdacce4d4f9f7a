"""The quantized leaf arithmetic of lightgbm_tpu_torch against
lightgbm_tpu, bit for bit.

The JAX package quantizes a training iteration's gradients inside a
jitted program (`boosting/gbdt.py` `_quantize_iter_device`) with qmax
static, and XLA's algebraic simplifier turns the scale's division by the
constant qmax into a multiply by its f32 reciprocal: g_scale = max|gw| *
f32(1 / qmax). Its quantize gate calls `ops/histogram.quantize_gradients`
op by op and divides. The two scales differ in the last bit for some
maxima, and every dequantized sum, gain and leaf carries the scale's
bits, so the port computes each where the JAX package does
(`quantize_gradients(reciprocal_scale=...)`). Before it did, the
`regression_int16_bagging` run of tests/test_torch_quant_train.py left
tree 10's leaves 1e-6 to 6e-6 off the JAX package's when trained
through `Booster.update`, with equal scores, gradients and codes up to
that iteration. These tests pin the repair: the scales, the leaf output
from hand-made int32 sums, and every leaf of that run on both of the
JAX package's training paths.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import lightgbm_tpu as jlgb
import lightgbm_tpu_torch as tlgb
from lightgbm_tpu.boosting.gbdt import _quantize_iter_device
from lightgbm_tpu.ops import histogram as jh
from lightgbm_tpu.ops import split as jsplit
from lightgbm_tpu_torch.ops import histogram as th
from lightgbm_tpu_torch.ops import rng
from lightgbm_tpu_torch.ops.split import dequantize_hist, leaf_output

import test_torch_quant_train as fixture

torch.set_num_threads(1)

SEED, IT = 11, 3


def _maxima_that_differ(qmax, count):
    """f32 maxima whose quotient by qmax and product by f32(1 / qmax)
    differ in the last bit."""
    qm = np.float32(qmax)
    m = np.random.RandomState(qmax).uniform(0.5, 8.0, 100000).astype(
        np.float32)
    m = m[(m / qm) != (m * (np.float32(1.0) / qm))]
    assert len(m) >= count
    return m[:count]


def _gradients(peak, n=1201, bag=True):
    rs = np.random.RandomState(int(peak * 1e6) % 2 ** 31)
    g = (rs.uniform(-1, 1, n) * peak).astype(np.float32)
    g[rs.randint(n)] = -peak
    h = (rs.rand(n) + 0.1).astype(np.float32)
    w = (rs.rand(n) < 0.7).astype(np.float32) if bag \
        else np.ones(n, np.float32)
    w[np.argmax(np.abs(g))] = 1.0
    return g, h, w


def _port(g, h, w, qmax, hess_const, reciprocal):
    kc = rng.fold_in(rng.fold_in(rng.prng_key(SEED), IT), 0)
    return th.quantize_gradients(
        torch.from_numpy(g), torch.from_numpy(h), torch.from_numpy(w),
        qmax=qmax, key_g=rng.fold_in(kc, 0), key_h=rng.fold_in(kc, 1),
        hess_const=hess_const, reciprocal_scale=reciprocal)


def _bits(a):
    return np.asarray(a, np.float32).view(np.int32)


@pytest.mark.parametrize("mode", ["int8", "int16"])
@pytest.mark.parametrize("hess_const", [False, True])
def test_training_scales_are_the_jitted_programs(mode, hess_const):
    n = 1201
    qmax = th.train_qmax(mode, n)
    for peak in _maxima_that_differ(qmax, 3):
        g, h, w = _gradients(float(peak), n)
        qg, qh, w01, qs = _quantize_iter_device(
            jnp.asarray(g)[None], jnp.asarray(h)[None], jnp.asarray(w), IT,
            seed=SEED, n=n, qmax=qmax, hess_const=hess_const)
        got = _port(g, h, w, qmax, hess_const, True)
        assert np.array_equal(_bits(got.qscale.numpy()), _bits(qs[0]))
        assert np.array_equal(got.codes[:, 0].numpy(), np.asarray(qg[0]))
        assert np.array_equal(got.codes[:, 1].numpy(), np.asarray(qh[0]))
        assert np.array_equal(got.w01.numpy(), np.asarray(w01))
        # the gate's op-by-op call divides, and here the two differ
        kc = jax.random.fold_in(jax.random.fold_in(
            jax.random.PRNGKey(SEED), IT), 0)
        eager = jh.quantize_gradients(
            jnp.asarray(g), jnp.asarray(h), jnp.asarray(w), n=n, qmax=qmax,
            key_g=jax.random.fold_in(kc, 0), key_h=jax.random.fold_in(kc, 1),
            hess_const=hess_const)
        div = _port(g, h, w, qmax, hess_const, False)
        assert np.array_equal(_bits(div.qscale.numpy()), _bits(eager[3]))
        assert _bits(div.qscale.numpy())[0] != _bits(got.qscale.numpy())[0]


@pytest.mark.parametrize("l1,l2", [(0.0, 0.0), (0.0, 1.0), (0.5, 2.0)])
@pytest.mark.parametrize("reciprocal", [False, True])
def test_leaf_output_of_int32_sums_is_the_jax_functions(l1, l2, reciprocal):
    """Leaf values from hand-made int32 (sum q_g, sum q_h, count) totals,
    dequantized by either scale, through the port's host arithmetic and
    the JAX package's jitted dequantize + leaf_output."""
    rs = np.random.RandomState(5)
    qmax = 32767
    tot = np.stack([rs.randint(-2 ** 30, 2 ** 30, 400),
                    rs.randint(1, 2 ** 30, 400),
                    rs.randint(1, 60000, 400)], 1).astype(np.int32)
    tot[:4, 0] = (0, 1, -1, 2 ** 31 - 1)
    qm = np.float32(qmax)
    peaks = _maxima_that_differ(qmax, 400)
    inv = np.float32(1.0) / qm
    scale = peaks * inv if reciprocal else peaks / qm
    qs = np.stack([scale, np.full(400, inv, np.float32),
                   np.ones(400, np.float32)], 1)

    @jax.jit
    def ref(t, s):
        d = jsplit.dequantize_hist(t, s)
        return jsplit.leaf_output(d[:, 0], d[:, 1], l1, l2)

    want = np.asarray(ref(jnp.asarray(tot), jnp.asarray(qs)))
    got = np.empty(400, np.float32)
    for i in range(400):
        d = dequantize_hist(torch.from_numpy(tot[i]),
                            torch.from_numpy(qs[i])).numpy()
        got[i] = leaf_output(d[0], d[1], l1, l2)
    assert np.array_equal(_bits(got), _bits(want))


def _leaves(pkg, path):
    params, rounds, _ = fixture.RUNS["regression_int16_bagging"]
    y, yv = fixture.LABELS["regression"]
    kw = {} if pkg is jlgb else {"device": "cpu"}
    p = dict(fixture.BASE, **params)
    ds = pkg.Dataset(fixture.X, y)
    if path == "train":
        booster = pkg.train(p, ds, rounds,
                            valid_sets=[ds.create_valid(fixture.XV, yv)],
                            verbose_eval=False, **kw)
    else:
        # no valid set: the JAX package takes its pipelined iteration
        booster = pkg.Booster(p, train_set=ds, **kw)
        for _ in range(rounds):
            booster.update()
        if pkg is jlgb:
            booster._inner.finalize_training()
    return booster._inner.models


@pytest.mark.parametrize("path", ["train", "update"])
def test_int16_bagging_leaves_are_bitwise_the_jax_packages(path):
    jt, tt = _leaves(jlgb, path), _leaves(tlgb, path)
    assert len(jt) == len(tt) == fixture.RUNS["regression_int16_bagging"][1]
    for i, (a, b) in enumerate(zip(jt, tt)):
        m = a.num_leaves - 1
        assert a.num_leaves == b.num_leaves, i
        for k in ("split_feature", "threshold_in_bin", "left_child",
                  "right_child"):
            assert np.array_equal(getattr(a, k)[:m], getattr(b, k)[:m]), \
                (i, k)
        assert np.array_equal(a.leaf_value, b.leaf_value), i
        assert np.array_equal(a.internal_value[:m], b.internal_value[:m]), i
