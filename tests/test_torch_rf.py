"""Random forests (boosting=rf) of lightgbm_tpu_torch against the JAX
package.

The JAX package's own RF setting (tests/test_engine.py:212-214):
bagging_fraction 0.7, bagging_freq 1, feature_fraction 0.7. Both
packages train the same seeded data on the CPU. Every tree grows from
the gradients of the zero score; the train and valid scores are the
running average of the trees, (score * t + tree) / (t + 1), each
operation rounded as JAX's eager calls round it (R's average mode).
Tolerances: the same trees, train scores, valid scores and raw
predictions within 1e-5 * max(1, |ref|). The model text says `tree` and
`average_output` and loads into the JAX package. A valid set added
after training replays the trees into a zero sum that is averaged, then
added to the set's scores once (gbdt.py:1097-1107).
"""
import numpy as np
import pytest
import torch

import lightgbm_tpu as jlgb
import lightgbm_tpu_torch as tlgb

torch.set_num_threads(1)

RF = {"boosting": "rf", "bagging_fraction": 0.7, "bagging_freq": 1,
      "feature_fraction": 0.7, "num_leaves": 15, "max_bin": 63,
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


X, F = make(0, 2500)
XV, FV = make(1, 800)
LABELS = {"binary": ((F > 0).astype(float), (FV > 0).astype(float)),
          "regression": (F, FV)}
ROUNDS = 8


def train(pkg, objective, **kw):
    y, yv = LABELS[objective]
    ds = pkg.Dataset(X, y)
    b = pkg.Booster(dict(RF, objective=objective), train_set=ds, **kw)
    b.add_valid(ds.create_valid(XV, yv), "valid")
    for _ in range(ROUNDS):
        b.update()
    return b


@pytest.fixture(scope="module")
def pairs():
    return {obj: (train(jlgb, obj), train(tlgb, obj, device="cpu"))
            for obj in LABELS}


def within(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape
    assert np.all(np.abs(got - ref) <= 1e-5 * np.maximum(1.0, np.abs(ref)))


@pytest.mark.parametrize("objective", sorted(LABELS))
def test_rf_scores_and_trees_equal_the_jax_package(pairs, objective):
    jb, tb = pairs[objective]
    jt, tt = jb._inner.models, tb._inner.models
    assert len(jt) == len(tt) == ROUNDS
    for i, (a, b) in enumerate(zip(jt, tt)):
        m = a.num_leaves - 1
        assert a.num_leaves == b.num_leaves, i
        assert np.array_equal(a.split_feature[:m], b.split_feature[:m]), i
        assert np.array_equal(a.threshold_in_bin[:m],
                              b.threshold_in_bin[:m]), i
        assert np.array_equal(a.leaf_count, b.leaf_count), i
    n = len(X)
    within(tb._inner._train_score_unpadded(),
           np.asarray(jb._inner._score)[0, :n])
    within(tb._inner.valid_score(0), np.asarray(jb._inner._valid_score[0])[0])
    within(tb.predict(XV, raw_score=True), jb.predict(XV, raw_score=True))
    # the averaged valid scores are the model's raw predictions
    within(tb._inner.valid_score(0), tb.predict(XV, raw_score=True))


def test_rf_model_text_says_average_output(pairs):
    _, tb = pairs["binary"]
    text = tb.model_to_string()
    lines = text.splitlines()
    assert lines[0] == "tree" and "average_output" in lines
    assert not any(ln.startswith("init_score_bias") for ln in lines)
    jb = jlgb.Booster(model_str=text)
    assert jb.model_to_string() == text
    within(tb.predict(XV), jb.predict(XV))
    back = tlgb.Booster(model_str=text, device="cpu")
    assert np.array_equal(back.predict(XV), tb.predict(XV))


@pytest.mark.parametrize("objective", sorted(LABELS))
def test_a_valid_set_added_after_training(pairs, objective):
    jb, tb = pairs[objective]
    y = LABELS[objective][1]
    jb.add_valid(jlgb.Dataset(XV[:300], y[:300], reference=jb.train_set),
                 "late")
    tb.add_valid(tlgb.Dataset(XV[:300], y[:300], reference=tb.train_set),
                 "late")
    got = tb._inner.valid_score(1)
    within(got, np.asarray(jb._inner._valid_score[1])[0])
    within(got, tb.predict(XV[:300], raw_score=True))


def test_the_classifier_trains_rf():
    kw = dict(boosting_type="rf", n_estimators=5, num_leaves=15,
              subsample=0.7, subsample_freq=1, colsample_bytree=0.7,
              min_child_samples=10, max_bin=63)
    y = LABELS["binary"][0]
    jm = jlgb.LGBMClassifier(**kw).fit(X, y)
    tm = tlgb.LGBMClassifier(device="cpu", **kw).fit(X, y)
    assert tm.booster_.model_to_string().splitlines()[0] == "tree"
    ref = jm.predict_proba(XV)[:, 1]
    assert np.all(np.abs(tm.predict_proba(XV)[:, 1] - ref) <= 1e-5)
