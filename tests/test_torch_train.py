"""lightgbm_tpu_torch.train end to end against lightgbm_tpu.train.

Both packages train on the same seeded numpy data (NaN and zero-heavy
columns) on the CPU, both with `tpu_hist_bf16=false`, so both sum
histograms in f32 (tests/test_torch_hist_bf16.py holds the default
hi+lo sums); the port runs the plain versions of its kernels
(`device="cpu"`). Each JAX model is trained once per module.
Tolerances: the same tree structure (split features, bin thresholds,
decision types, children), raw predictions within 1e-5 * max(1, |ref|),
every recorded metric within 2e-3, and the same best_iteration under
early stopping. The JAX run without a valid set takes its pipelined
path (`_train_one_iter_pipelined`), the port its synchronous one: the
trees must still be the same. The port's model text must load into
`lightgbm_tpu.Booster` and predict what the port predicts (1e-5 *
max(1, |ref|)), and what the slice does not carry must raise by name.
"""
import numpy as np
import pytest
import torch

import lightgbm_tpu as jlgb
import lightgbm_tpu_torch as tlgb
from lightgbm_tpu_torch import LightGBMError

torch.set_num_threads(1)

BASE = {"num_leaves": 15, "max_bin": 63, "learning_rate": 0.3,
        "min_data_in_leaf": 10, "min_sum_hessian_in_leaf": 1.0,
        "verbose": -1, "tpu_hist_bf16": False}


def make(seed, n):
    rng = np.random.RandomState(seed)
    x = rng.randn(n, 7)
    x[rng.rand(n) < 0.1, 2] = np.nan
    x[rng.rand(n) < 0.3, 3] = 0.0
    f = (x[:, 0] + 0.8 * np.nan_to_num(x[:, 2]) - 0.5 * x[:, 3] * x[:, 4]
         + np.sin(2 * x[:, 1]))
    return x, f + 0.8 * rng.randn(n)


X, F = make(0, 3000)
XV, FV = make(1, 1000)
LABELS = {"binary": ((F > 0).astype(float), (FV > 0).astype(float)),
          "regression": (F, FV)}
RUNS = {
    "binary": ({"objective": "binary", "metric": "auc,binary_logloss"},
               40, 3, True),
    "regression": ({"objective": "regression", "metric": "l2"}, 40, 3, True),
    "binary_no_valid": ({"objective": "binary"}, 6, None, False),
    "regression_lr_schedule": ({"objective": "regression",
                                "metric": "rmse", "feature_fraction": 0.7},
                               6, None, True),
}


def train_with(pkg, name, **kw):
    params, rounds, esr, with_valid = RUNS[name]
    y, yv = LABELS[params["objective"]]
    ds = pkg.Dataset(X, y)
    extra = dict(kw)
    if with_valid:
        extra["valid_sets"] = [ds.create_valid(XV, yv)]
        extra["valid_names"] = ["valid"]
    if name == "regression_lr_schedule":
        extra["learning_rates"] = [0.3, 0.2, 0.2, 0.1, 0.1, 0.05]
    evals = {}
    booster = pkg.train(dict(BASE, **params), ds, rounds,
                        early_stopping_rounds=esr, evals_result=evals,
                        verbose_eval=False, **extra)
    return booster, evals


@pytest.fixture(scope="module")
def pairs():
    return {name: (train_with(jlgb, name), train_with(tlgb, name,
                                                       device="cpu"))
            for name in RUNS}


def assert_same_structure(jb, tb):
    jt, tt = jb._inner.models, tb._inner.models
    assert len(jt) == len(tt) > 0
    for i, (a, b) in enumerate(zip(jt, tt)):
        assert a.num_leaves == b.num_leaves, i
        m = a.num_leaves - 1
        for k in ("split_feature", "threshold_in_bin", "decision_type",
                  "left_child", "right_child"):
            assert np.array_equal(getattr(a, k)[:m], getattr(b, k)[:m]), \
                (i, k)
        assert np.array_equal(a.threshold[:m], b.threshold[:m]), i
        assert np.array_equal(a.leaf_count, b.leaf_count), i


@pytest.mark.parametrize("name", sorted(RUNS))
def test_same_trees_and_predictions(pairs, name):
    (jb, _), (tb, _) = pairs[name]
    assert_same_structure(jb, tb)
    ref = jb.predict(XV, raw_score=True)
    got = tb.predict(XV, raw_score=True)
    assert np.all(np.abs(got - ref) <= 1e-5 * np.maximum(1.0, np.abs(ref)))
    if RUNS[name][0]["objective"] == "binary":
        p_ref, p = jb.predict(XV), tb.predict(XV)
        assert np.all(np.abs(p - p_ref) <= 1e-5)


@pytest.mark.parametrize("name", ["binary", "regression",
                                  "regression_lr_schedule"])
def test_metrics_and_early_stopping(pairs, name):
    (jb, jev), (tb, tev) = pairs[name]
    assert sorted(jev) == sorted(tev) == ["valid"]
    assert sorted(jev["valid"]) == sorted(tev["valid"])
    for metric, series in jev["valid"].items():
        assert len(series) == len(tev["valid"][metric])
        assert np.all(np.abs(np.asarray(series)
                             - np.asarray(tev["valid"][metric])) <= 2e-3)
    assert tb.best_iteration == jb.best_iteration
    if RUNS[name][2]:
        assert 0 < tb.best_iteration < RUNS[name][1], "did not stop early"
        for metric, value in jb.best_score["valid"].items():
            assert abs(tb.best_score["valid"][metric] - value) <= 2e-3


@pytest.mark.parametrize("name", ["binary", "regression"])
def test_model_text_loads_into_the_jax_booster(pairs, name):
    _, (tb, _) = pairs[name]
    text = tb.model_to_string()
    jb = jlgb.Booster(model_str=text)
    assert jb.model_to_string() == text
    for raw in (True, False):
        ref = jb.predict(XV, raw_score=raw)
        got = tb.predict(XV, raw_score=raw)
        assert np.all(np.abs(got - ref) <= 1e-5 * np.maximum(1.0,
                                                             np.abs(ref)))
    back = tlgb.Booster(model_str=text, device="cpu")
    assert np.array_equal(back.predict(XV), tb.predict(XV))


def test_rollback_and_train_metric():
    y, _ = LABELS["binary"]
    ds = tlgb.Dataset(X[:1200], y[:1200])
    vs = ds.create_valid(XV, LABELS["binary"][1])
    b = tlgb.Booster(dict(BASE, objective="binary", metric="binary_error"),
                     train_set=ds, device="cpu")
    b.add_valid(vs, "v")
    for _ in range(4):
        assert not b.update()
    before = b._inner.valid_score(0).copy()
    assert b.update() is False
    b.rollback_one_iter()
    assert b.current_iteration() == 4 and b.num_trees() == 4
    assert np.allclose(b._inner.valid_score(0), before, atol=1e-6)
    train_raw = b.predict(X[:1200], raw_score=True)
    assert np.allclose(b._inner._train_score_unpadded(), train_raw,
                       atol=1e-5)
    (name, metric, value, bigger), = b.eval_train()
    assert (name, metric, bigger) == ("training", "binary_error", False)
    assert 0.0 <= value < 0.5


def test_valid_set_holding_the_train_set_reports_a_train_metric():
    y, yv = LABELS["regression"]
    ds = tlgb.Dataset(X[:800], y[:800])
    ev = {}
    tlgb.train(dict(BASE, objective="regression", metric="l2"), ds, 3,
               valid_sets=[ds], valid_names=["train"], evals_result=ev,
               verbose_eval=False, device="cpu")
    assert list(ev) == ["train"] and len(ev["train"]["l2"]) == 3
    assert ev["train"]["l2"][2] < ev["train"]["l2"][0]


# (params, the word the error names, test id): bagging, quantized
# histograms, goss, dart and rf train now; with what is still refused
# they raise by the refused thing's name
REFUSED = [
    ({"linear_tree": True, "boosting": "rf", "bagging_fraction": 0.5,
      "bagging_freq": 1}, "linear_tree supports boosting=gbdt/goss",
     "bagging"),
    ({"boosting": "goss", "bagging_fraction": 0.5, "bagging_freq": 1},
     "Cannot use bagging in GOSS", "goss_with_bagging"),
    ({"boosting": "goss", "top_rate": 0.0}, "GOSS requires top_rate > 0",
     "goss_top_rate_0"),
    ({"boosting": "rf"}, "RF mode requires bagging", "rf_without_bagging"),
    ({"boosting": "rf", "bagging_fraction": 0.5, "bagging_freq": 1,
      "feature_fraction": 1.0}, "RF mode requires feature_fraction",
     "rf_feature_fraction_1"),
    ({"linear_tree": True, "boosting": "dart"}, "linear_tree",
     "linear_tree"),
    ({"objective": "multiclass", "num_class": 3}, "multiclass",
     "multiclass"),
    ({"tree_learner": "data"}, "tree_learner", "tree_learner"),
    ({"metric": "ndcg"}, "ndcg", "ndcg"),
]


@pytest.mark.parametrize("params,word", [r[:2] for r in REFUSED],
                         ids=[r[2] for r in REFUSED])
def test_what_the_slice_does_not_carry_raises_by_name(params, word):
    y, _ = LABELS["binary"]
    ds = tlgb.Dataset(X[:300], y[:300])
    with pytest.raises(LightGBMError, match=word):
        tlgb.train(dict(BASE, **{"objective": "binary", **params}), ds, 2,
                   verbose_eval=False, device="cpu")


# (params, test id): refused by name before GOSS, DART and RF training
# were ported; each trains now and its model predicts
NOW_TRAINED = [
    ({"boosting": "goss", "learning_rate": 0.5}, "goss"),
    ({"boosting": "dart"}, "dart"),
    ({"boosting": "rf", "bagging_fraction": 0.5, "bagging_freq": 1,
      "feature_fraction": 0.7}, "rf"),
    ({"boosting": "goss", "learning_rate": 0.5, "tpu_hist_quantize": "int8"},
     "tpu_hist_quantize"),
]


@pytest.mark.parametrize("params", [r[0] for r in NOW_TRAINED],
                         ids=[r[1] for r in NOW_TRAINED])
def test_what_the_slice_now_trains(params):
    y, _ = LABELS["binary"]
    b = tlgb.train(dict(BASE, objective="binary", **params),
                   tlgb.Dataset(X[:600], y[:600]), 4, verbose_eval=False,
                   device="cpu")
    assert b.num_trees() == 4
    p = b.predict(XV[:50])
    assert np.isfinite(p).all() and ((p > 0) & (p < 1)).all()


SCHEDULE_KEYS = [("tpu_batch_k", 3),
                 ("tpu_hist_subtract", False), ("tpu_hist_compact", False),
                 ("tpu_compact_threshold", 0.0),
                 ("tpu_compact_threshold", 1.0), ("tpu_hist_chunk", 512)]


@pytest.mark.parametrize("key,value", SCHEDULE_KEYS,
                         ids=["%s=%s" % kv for kv in SCHEDULE_KEYS])
def test_the_jax_schedule_keys_are_taken_and_ignored(key, value):
    """They shape the JAX package's TPU programs; the port's trees do not
    depend on them."""
    y, _ = LABELS["binary"]
    p = dict(BASE, objective="binary")
    base = tlgb.train(p, tlgb.Dataset(X[:600], y[:600]), 3,
                      verbose_eval=False, device="cpu")
    got = tlgb.train(dict(p, **{key: value}), tlgb.Dataset(X[:600], y[:600]),
                     3, verbose_eval=False, device="cpu")
    assert got.model_to_string() == base.model_to_string()


def test_train_arguments_the_slice_refuses():
    y, _ = LABELS["binary"]
    ds = tlgb.Dataset(X[:300], y[:300])
    p = dict(BASE, objective="binary")
    with pytest.raises(LightGBMError, match="fobj"):
        tlgb.train(p, ds, 2, fobj=lambda s, d: (s, s), device="cpu")
    with pytest.raises(LightGBMError, match="feval"):
        tlgb.train(p, ds, 2, feval=lambda s, d: ("m", 0.0, False),
                   device="cpu")
    with pytest.raises(LightGBMError, match="categorical"):
        tlgb.train(p, tlgb.Dataset(X[:300], y[:300],
                                   categorical_feature=[1]), 2,
                   device="cpu")


def test_default_device_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")
    y, _ = LABELS["binary"]
    with pytest.raises(LightGBMError, match="device='cpu'"):
        tlgb.train(dict(BASE, objective="binary"),
                   tlgb.Dataset(X[:300], y[:300]), 2, verbose_eval=False)


def test_a_constructed_dataset_keeps_its_bins_and_says_so():
    """max_bin given to train() reaches a Dataset not yet constructed; a
    constructed one keeps its bins and warns, as the JAX package does."""
    y, _ = LABELS["binary"]
    lazy = tlgb.Dataset(X[:400], y[:400])
    built = tlgb.Dataset(X[:400], y[:400]).construct()
    lines = []
    tlgb.log.register_callback(lines.append)
    try:
        for ds in (lazy, built):
            tlgb.train(dict(BASE, objective="binary", max_bin=15), ds, 1,
                       verbose_eval=False, device="cpu")
    finally:
        tlgb.log.register_callback(None)
    assert lazy._inner.max_num_bin() <= 15 < built._inner.max_num_bin()
    assert sum("already constructed with max_bin=255" in ln
               for ln in lines) == 1
