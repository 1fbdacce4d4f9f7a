"""GOSS (boosting=goss) of lightgbm_tpu_torch against the JAX package.

- The row weights of GT and GW's plain versions (`ops/goss.py`) equal
  `lightgbm_tpu.boosting.goss._goss_impl` bit for bit, given the same
  gradients: with ties at the threshold (every tied row is a top row),
  with zero magnitudes, at top_k 1 and n - 1, and through the GOSS
  engine's own hook before int(1 / learning_rate) (no weights) and after
  it.
- GOSS training on the CPU, f32 under both `tpu_hist_bf16` settings,
  int8 and with `linear_tree`, and through `LGBMClassifier(
  boosting_type="goss")`: the same trees as the JAX package (split
  features, bin thresholds, decision types, children, leaf counts) and
  raw predictions within 1e-5 * max(1, |ref|).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import lightgbm_tpu as jlgb
import lightgbm_tpu_torch as tlgb
from lightgbm_tpu.boosting.goss import _goss_impl
from lightgbm_tpu_torch.ops.goss import (goss_rates, goss_threshold,
                                         goss_weights)
from lightgbm_tpu_torch.ops.rng import fold_in, prng_key

torch.set_num_threads(1)

_jit_goss = jax.jit(_goss_impl, static_argnames=(
    "seed", "k", "n", "n_pad", "top_k", "other_k"))


def jax_weights(g, h, it, seed, top_k, other_k):
    n = len(g)
    return np.asarray(_jit_goss(jnp.asarray(g), jnp.asarray(h),
                                jnp.int32(it), seed=seed, k=1, n=n,
                                n_pad=n, top_k=top_k, other_k=other_k))


def port_weights(g, h, it, seed, top_k, other_k):
    n = len(g)
    mag, thresh = goss_threshold(torch.from_numpy(g), torch.from_numpy(h),
                                 top_k)
    rest_p, multiply = goss_rates(n, top_k, other_k)
    out = torch.empty(n, dtype=torch.float32)
    goss_weights(mag, thresh, fold_in(prng_key(seed), it), rest_p,
                 multiply, out)
    return out.numpy(), float(thresh[0]), mag.numpy()


def gradients(kind, n, seed=0):
    rng = np.random.RandomState(seed)
    g = rng.randn(n).astype(np.float32)
    h = (rng.rand(n) * 0.25).astype(np.float32)
    if kind == "ties":
        g = np.round(g * 2) / 2
        h = np.full(n, 0.25, np.float32)
    elif kind == "zeros":
        g[rng.rand(n) < 0.6] = 0.0
    elif kind == "all_zero":
        g[:] = 0.0
    elif kind == "all_equal":
        g[:] = -0.5
        h[:] = 0.125
    return g.astype(np.float32), h.astype(np.float32)


CASES = [("random", 0.2, 0.1), ("ties", 0.2, 0.1), ("zeros", 0.3, 0.2),
         ("all_zero", 0.2, 0.1), ("all_equal", 0.2, 0.1),
         ("random", "1", 0.1), ("random", "n-1", 0.5),
         ("ties", "n-1", 0.3)]


@pytest.mark.parametrize("kind,top,other", CASES,
                         ids=["%s-top%s-other%s" % c for c in CASES])
def test_goss_weights_equal_goss_impl_bitwise(kind, top, other):
    n = 3001
    g, h = gradients(kind, n)
    top_k = {"1": 1, "n-1": n - 1}.get(top) if isinstance(top, str) \
        else max(1, int(n * top))
    other_k = max(1, int(n * other))
    for it in (10, 11):
        ref = jax_weights(g, h, it, 3, top_k, other_k)
        got, thresh, mag = port_weights(g, h, it, 3, top_k, other_k)
        assert np.array_equal(got.view(np.uint32), ref.view(np.uint32)), it
        assert np.float32(thresh) == -np.sort(-mag)[top_k - 1]
        assert np.float32(thresh) == np.partition(mag, n - top_k)[n - top_k]
        # rows tied at the threshold are all top rows
        assert np.all(got[mag >= thresh] == 1.0)
    assert set(np.unique(got)) <= {0.0, 1.0,
                                   np.float32((n - top_k) / other_k)}


def test_the_engine_weighs_rows_from_int_one_over_lr_on():
    """GOSS._bagging_weights: None before iteration int(1 / lr) (the
    rounds are unweighted), then _goss_impl's weights bitwise."""
    x, y = make(5, 2000)
    params = dict(BASE, objective="binary", boosting="goss",
                  learning_rate=0.3, bagging_seed=11)
    b = tlgb.Booster(params, train_set=tlgb.Dataset(x, (y > 0) * 1.0),
                     device="cpu")
    g, h = gradients("random", 2000, seed=7)
    tg, th = torch.from_numpy(g), torch.from_numpy(h)
    for it in (0, 2):
        assert b._inner._bagging_weights(it, tg, th) is None
    n = 2000
    top_k, other_k = int(n * 0.2), int(n * 0.1)
    for it in (3, 9):
        got = b._inner._bagging_weights(it, tg, th).numpy()
        ref = jax_weights(g, h, it, 11, top_k, other_k)
        assert np.array_equal(got.view(np.uint32), ref.view(np.uint32))


BASE = {"num_leaves": 15, "max_bin": 63, "learning_rate": 0.3,
        "min_data_in_leaf": 10, "min_sum_hessian_in_leaf": 1.0,
        "verbose": -1}


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
Y, YV = (F > 0).astype(float), (FV > 0).astype(float)

RUNS = {
    "f32_hi_lo": {"objective": "binary"},
    "f32_tpu_hist_bf16_false": {"objective": "binary",
                                "tpu_hist_bf16": False},
    "int8": {"objective": "binary", "tpu_hist_quantize": "int8"},
    "linear_tree": {"objective": "regression", "linear_tree": True,
                    "linear_lambda": 0.01},
}


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


@pytest.mark.parametrize("name", sorted(RUNS))
def test_goss_training_grows_the_jax_trees(name):
    params = dict(BASE, boosting="goss", **RUNS[name])
    y = Y if params["objective"] == "binary" else F
    trained = []
    for pkg, kw in ((jlgb, {}), (tlgb, {"device": "cpu"})):
        ds = pkg.Dataset(X, y, params=dict(params))
        trained.append(pkg.train(dict(params), ds, 8, **kw))
    jb, tb = trained
    assert tb.model_to_string().splitlines()[0] == "goss"
    assert_same_trees(jb, tb)
    ref = jb.predict(XV, raw_score=True)
    got = tb.predict(XV, raw_score=True)
    assert np.all(np.abs(got - ref) <= 1e-5 * np.maximum(1.0, np.abs(ref)))


def test_the_classifier_trains_goss():
    kw = dict(boosting_type="goss", n_estimators=6, num_leaves=15,
              learning_rate=0.3, min_child_samples=10, max_bin=63)
    jm = jlgb.LGBMClassifier(**kw).fit(X, Y)
    tm = tlgb.LGBMClassifier(device="cpu", **kw).fit(X, Y)
    assert_same_trees(jm.booster_, tm.booster_)
    ref = jm.predict_proba(XV)[:, 1]
    assert np.all(np.abs(tm.predict_proba(XV)[:, 1] - ref) <= 1e-5)
