"""DART (boosting=dart) of lightgbm_tpu_torch against the JAX package.

Both packages train the same seeded data on the CPU through
`Booster.update`, with a valid set, in the default mode, with
`uniform_drop` and with `xgboost_dart_mode`. The drops draw from
`np.random.RandomState(drop_seed)` in the JAX package's order, so every
iteration drops the same trees, and the ledger of tree weights is the
JAX package's, equal by `repr`. Tolerances: the same trees, raw
predictions and valid scores within 1e-5 * max(1, |ref|). A DART model
trained by the port loads into the JAX package with the same ledger and
text, and one trained by the JAX package loads into the port so.
"""
import numpy as np
import pytest
import torch

import lightgbm_tpu as jlgb
import lightgbm_tpu_torch as tlgb

torch.set_num_threads(1)

BASE = {"objective": "binary", "num_leaves": 15, "max_bin": 63,
        "learning_rate": 0.3, "min_data_in_leaf": 10,
        "min_sum_hessian_in_leaf": 1.0, "verbose": -1, "boosting": "dart",
        "drop_rate": 0.3, "skip_drop": 0.3}


def make(seed, n):
    r = np.random.RandomState(seed)
    x = r.randn(n, 7)
    x[r.rand(n) < 0.1, 2] = np.nan
    x[r.rand(n) < 0.3, 3] = 0.0
    f = (x[:, 0] + 0.8 * np.nan_to_num(x[:, 2]) - 0.5 * x[:, 3] * x[:, 4]
         + np.sin(2 * x[:, 1]))
    return x, f + 0.8 * r.randn(n)


X, F = make(0, 2500)
XV, FV = make(1, 800)
Y, YV = (F > 0).astype(float), (FV > 0).astype(float)
ROUNDS = 10

MODES = {"default": {}, "uniform_drop": {"uniform_drop": True},
         "xgboost_dart_mode": {"xgboost_dart_mode": True}}


def run(pkg, params, **kw):
    ds = pkg.Dataset(X, Y)
    b = pkg.Booster(dict(params), train_set=ds, **kw)
    b.add_valid(ds.create_valid(XV, YV), "valid")
    drops = []
    for _ in range(ROUNDS):
        b.update()
        drops.append(list(b._inner.drop_index))
    return b, drops


@pytest.fixture(scope="module")
def runs():
    out = {}
    for name, extra in MODES.items():
        p = dict(BASE, **extra)
        out[name] = (run(jlgb, p), run(tlgb, p, device="cpu"))
    return out


def assert_same_trees(jt, tt):
    assert len(jt) == len(tt) > 0
    for i, (a, b) in enumerate(zip(jt, tt)):
        m = a.num_leaves - 1
        assert a.num_leaves == b.num_leaves, i
        for k in ("split_feature", "threshold_in_bin", "decision_type",
                  "left_child", "right_child"):
            assert np.array_equal(getattr(a, k)[:m], getattr(b, k)[:m]), \
                (i, k)


@pytest.mark.parametrize("mode", sorted(MODES))
def test_dart_drops_and_ledger_equal_the_jax_package(runs, mode):
    (jb, jdrops), (tb, tdrops) = runs[mode]
    assert tdrops == jdrops
    assert sum(len(d) for d in tdrops) > 0, "no tree was ever dropped"
    assert repr(tb._inner.tree_weight) == repr(jb._inner.tree_weight)
    assert repr(tb._inner.sum_weight) == repr(jb._inner.sum_weight)
    assert_same_trees(jb._inner.models, tb._inner.models)
    ref = jb.predict(XV, raw_score=True)
    got = tb.predict(XV, raw_score=True)
    assert np.all(np.abs(got - ref) <= 1e-5 * np.maximum(1.0, np.abs(ref)))
    vref = np.asarray(jb._inner._valid_score[0][0], np.float64)
    vgot = tb._inner.valid_score(0)
    assert np.all(np.abs(vgot - vref) <= 1e-5 * np.maximum(1.0,
                                                           np.abs(vref)))
    # the valid scores W kept are the model's raw predictions
    assert np.all(np.abs(vgot - got) <= 1e-5 * np.maximum(1.0,
                                                          np.abs(got)))


@pytest.mark.parametrize("direction", ["port_to_jax", "jax_to_port"])
def test_a_dart_model_moves_between_the_packages(runs, direction):
    (jb, _), (tb, _) = runs["default"]
    src, pkg, kw = ((tb, jlgb, {}) if direction == "port_to_jax"
                    else (jb, tlgb, {"device": "cpu"}))
    text = src.model_to_string()
    assert text.splitlines()[0] == "dart"
    loaded = pkg.Booster(model_str=text, **kw)
    assert repr(loaded._inner.tree_weight) == repr(src._inner.tree_weight)
    assert loaded.model_to_string() == text
    ref = src.predict(XV, raw_score=True)
    got = loaded.predict(XV, raw_score=True)
    assert np.all(np.abs(got - ref) <= 1e-5 * np.maximum(1.0, np.abs(ref)))
