"""Linear-tree training of lightgbm_tpu_torch against lightgbm_tpu.train.

Both packages train `linear_tree=true` models on the CPU (the port with
`device="cpu"`, the plain versions of kernels LF, LS, LA, W and K1), on
`_linear_problem` of tests/test_linear_tree.py with its parameters
(regression, 15 leaves, learning rate 0.5, linear_lambda 0.01, 10
rounds) and a second draw as the valid set; the JAX package with
`tpu_hist_bf16=false` on both sides. Runs: f32 regression, binary (labels drawn from
a logistic of the target), int8 regression and bagged regression.

Tolerances: the same tree structure every round and the same leaf
features; leaf values and coefficients within 1e-4 * max(1, |ref|);
raw predictions within 1e-5 * max(1, |ref|) (binary: 1e-4); metrics
within 2e-3. The leaves stay within 1e-4, not 1e-5 (measured up to
6.5e-5, bagged): the JAX package sums each leaf's normal equations in
f32 in the order of its one-hot matmul, the port sums the same f32
terms in f64 and rounds once, and the solve of a leaf with few rows or
close features lifts that round-off; the binary run's ten trees add up
to 1.1e-5 in its raw predictions (ROADMAP.md queue C).
"""
import numpy as np
import pytest
import torch

import lightgbm_tpu as jlgb
import lightgbm_tpu_torch as tlgb
from lightgbm_tpu_torch import LightGBMError
from lightgbm_tpu_torch.convert import booster_from_numpy

torch.set_num_threads(1)


def _linear_problem(n=800, f=6, seed=3):
    """tests/test_linear_tree.py:35: a steep slope on one feature plus a
    step on another."""
    rng = np.random.RandomState(seed)
    X = rng.uniform(-1.0, 1.0, (n, f))
    y = 4.0 * X[:, 1] + 2.0 * (X[:, 0] > 0) + 0.05 * rng.randn(n)
    return X.astype(np.float32), y.astype(np.float32)


X, Y = _linear_problem()
XV, YV = _linear_problem(seed=4)
MID = float(np.median(Y))


def _coin(y, seed):
    p = 1.0 / (1.0 + np.exp(-2.0 * (y - MID)))
    return (np.random.RandomState(seed).rand(len(y)) < p).astype(np.float32)


LABELS = {"regression": (Y, YV), "binary": (_coin(Y, 5), _coin(YV, 6))}
BASE = {"objective": "regression", "metric": "l2", "num_leaves": 15,
        "learning_rate": 0.5, "min_data_in_leaf": 5, "max_bin": 63,
        "verbose": -1, "linear_tree": True, "linear_lambda": 0.01,
        "tpu_hist_bf16": False}
ROUNDS = 10
RUNS = {"f32": {},
        "binary": {"objective": "binary", "metric": "auc,binary_logloss"},
        "int8": {"tpu_hist_quantize": "int8"},
        "bagged": {"bagging_fraction": 0.7, "bagging_freq": 1,
                   "bagging_seed": 3}}
TOL_LEAF = 1e-4
TOL_PRED = {"f32": 1e-5, "binary": 1e-4, "int8": 1e-5, "bagged": 1e-5}


def train_with(pkg, name, **kw):
    params = dict(BASE, **RUNS[name])
    y, yv = LABELS[params["objective"]]
    ds = pkg.Dataset(X, y, params=dict(params))
    evals = {}
    booster = pkg.train(params, ds, ROUNDS,
                        valid_sets=[ds.create_valid(XV, yv)],
                        valid_names=["valid"], evals_result=evals,
                        verbose_eval=False, **kw)
    return booster, evals


@pytest.fixture(scope="module")
def pairs():
    return {name: (train_with(jlgb, name), train_with(tlgb, name,
                                                       device="cpu"))
            for name in RUNS}


def _close(got, ref, tol):
    return np.all(np.abs(got - ref) <= tol * np.maximum(1.0, np.abs(ref)))


@pytest.mark.parametrize("name", sorted(RUNS))
def test_same_trees_leaves_coefficients_and_predictions(pairs, name):
    (jb, _), (tb, _) = pairs[name]
    jt, tt = jb._inner.models, tb._inner.models
    assert len(jt) == len(tt) == ROUNDS
    assert all(t.is_linear for t in tt)
    for i, (a, b) in enumerate(zip(jt, tt)):
        assert a.num_leaves == b.num_leaves, i
        m = a.num_leaves - 1
        for k in ("split_feature", "threshold_in_bin", "decision_type",
                  "left_child", "right_child"):
            assert np.array_equal(getattr(a, k)[:m], getattr(b, k)[:m]), \
                (i, k)
        assert np.array_equal(a.leaf_count, b.leaf_count), i
        assert np.array_equal(a.leaf_features, b.leaf_features), i
        assert np.array_equal(a.leaf_features_inner,
                              b.leaf_features_inner), i
        assert _close(b.leaf_value, a.leaf_value, TOL_LEAF), i
        assert _close(b.leaf_coeff, a.leaf_coeff, TOL_LEAF), i
    ref = jb.predict(XV, raw_score=True)
    assert _close(tb.predict(XV, raw_score=True), ref, TOL_PRED[name])
    assert _close(tb.predict(XV), jb.predict(XV), TOL_PRED[name])


@pytest.mark.parametrize("name", sorted(RUNS))
def test_metrics_within_2e_3(pairs, name):
    (_, jev), (_, tev) = pairs[name]
    assert sorted(jev["valid"]) == sorted(tev["valid"])
    for metric, series in jev["valid"].items():
        assert len(series) == len(tev["valid"][metric]) == ROUNDS
        assert np.all(np.abs(np.asarray(series)
                             - np.asarray(tev["valid"][metric])) <= 2e-3)


def test_the_valid_scores_are_what_serving_gives(pairs):
    """W's leaf mode + LA kept the valid scores; K1 serves the same."""
    tb = pairs["f32"][1][0]
    assert _close(tb.predict(XV, raw_score=True),
                  tb._inner.valid_score(0), 1e-6)


def test_linear_beats_constant_on_linear_data(pairs):
    tb = pairs["f32"][1][0]
    const = tlgb.train(dict(BASE, linear_tree=False),
                       tlgb.Dataset(X, Y), ROUNDS, verbose_eval=False,
                       device="cpu")
    mse_c = float(np.mean((const.predict(X) - Y) ** 2))
    mse_l = float(np.mean((tb.predict(X) - Y) ** 2))
    assert mse_l < 0.5 * mse_c, (mse_l, mse_c)


def test_model_text_round_trip_exact(pairs):
    (jb, _), (tb, _) = pairs["f32"]
    text = tb.model_to_string()
    assert "tpu_leaf_coeff=" in text and "tpu_leaf_features=" in text
    again = tlgb.Booster(model_str=text, device="cpu")
    assert again.model_to_string() == text
    assert np.array_equal(again.predict(XV), tb.predict(XV))
    # the JAX package reads the port's text and serves the same
    assert _close(jlgb.Booster(model_str=text).predict(XV, raw_score=True),
                  tb.predict(XV, raw_score=True), TOL_PRED["f32"])


def test_a_jax_linear_model_through_convert(pairs):
    jb = pairs["bagged"][0][0]
    inner = jb._inner
    arrays = [{k: np.asarray(v) for k, v in vars(t).items()}
              for t in inner.models]
    header = {"num_class": 1, "num_tree_per_iteration": 1,
              "max_feature_idx": inner.max_feature_idx,
              "objective": inner.objective.to_string(),
              "init_score_bias": inner.init_score_bias,
              "feature_names": inner.feature_names}
    port = booster_from_numpy(header, arrays, device="cpu")
    for a, b in zip(inner.models, port._inner.models):
        for k in ("leaf_coeff", "leaf_features", "leaf_features_inner"):
            assert np.array_equal(getattr(a, k), getattr(b, k)), k
    ref = jb.predict(XV, raw_score=True)
    assert _close(port.predict(XV, raw_score=True), ref, TOL_PRED["bagged"])


def test_rollback_takes_the_linear_tree_off(pairs):
    """Four iterations then a rollback: every score as the JAX package's
    after the same, and as the port's own after three."""
    params = dict(BASE)
    out = []
    for pkg, kw in ((jlgb, {}), (tlgb, {"device": "cpu"})):
        ds = pkg.Dataset(X, Y, params=dict(params))
        b = pkg.Booster(dict(params), train_set=ds, **kw)
        b.add_valid(ds.create_valid(XV, YV), "valid")
        for _ in range(3):
            b.update()
        before = (np.asarray(b._inner._score).ravel()[:len(Y)].copy(),
                  np.asarray(b._inner._valid_score[0]).ravel().copy())
        b.update()
        b.rollback_one_iter()
        after = (np.asarray(b._inner._score).ravel()[:len(Y)],
                 np.asarray(b._inner._valid_score[0]).ravel())
        out.append((b, before, after))
    (jb, _, j_after), (tb, t_before, t_after) = out
    assert tb.current_iteration() == 3 and tb.num_trees() == 3
    for got, ref in zip(t_after, j_after):
        assert _close(got, ref, TOL_PRED["f32"])
    for got, ref in zip(t_after, t_before):
        assert _close(got, ref, 1e-5)


def test_two_runs_are_byte_identical():
    a = train_with(tlgb, "bagged", device="cpu")[0]
    b = train_with(tlgb, "bagged", device="cpu")[0]
    assert a.model_to_string() == b.model_to_string()


def test_the_estimator_trains_linear_trees():
    reg = tlgb.LGBMRegressor(linear_tree=True, linear_lambda=0.01,
                             n_estimators=ROUNDS, num_leaves=15,
                             learning_rate=0.5, min_child_samples=5,
                             max_bin=63, verbose=-1, device="cpu")
    reg.fit(X, Y)
    mse = float(np.mean((reg.predict(X) - Y) ** 2))
    assert mse < 0.1, mse
    assert "tpu_leaf_coeff" in reg.booster_.model_to_string()


@pytest.mark.parametrize("extra,match", [
    ({"boosting": "dart"}, "linear_tree supports boosting=gbdt/goss"),
    ({"boosting": "rf", "bagging_fraction": 0.5, "bagging_freq": 1},
     "linear_tree supports boosting=gbdt/goss"),
    # linear GOSS trains now (tests/test_torch_goss.py); GOSS with bagging
    # is refused, under the id this case has always had
    pytest.param({"boosting": "goss", "bagging_fraction": 0.5,
                  "bagging_freq": 1}, "Cannot use bagging in GOSS",
                 id="extra2-boosting=goss training is not ported"),
    ({"objective": "multiclass", "num_class": 3},
     "linear_tree does not support multiclass"),
    ({"tree_learner": "data", "num_machines": 2},
     "linear_tree does not support multi-host"),
    # any width >= 1 trains now (queue C repair); zero is refused, under
    # the id this case has always had
    pytest.param({"tpu_linear_max_features": 0},
                 "tpu_linear_max_features must be >= 1",
                 id="extra5-tpu_linear_max_features=43"),
])
def test_training_refusals_by_name(extra, match):
    params = dict(BASE, **extra)
    y = (np.arange(len(Y)) % 3).astype(np.float32) \
        if "num_class" in extra else Y
    with pytest.raises(LightGBMError, match=match):
        tlgb.train(params, tlgb.Dataset(X, y, params=dict(params)), 2,
                   verbose_eval=False, device="cpu")


def test_raw_values_are_required_by_name():
    params = dict(BASE)
    with pytest.raises(LightGBMError, match="keep_raw"):
        tlgb.Booster(dict(params), train_set=tlgb.Dataset(X, Y),
                     device="cpu")
    ds = tlgb.Dataset(X, Y, params=dict(params))
    booster = tlgb.Booster(dict(params), train_set=ds, device="cpu")
    with pytest.raises(LightGBMError, match="keep_raw"):
        booster.add_valid(tlgb.Dataset(XV, YV, reference=ds), "bare")


@pytest.mark.parametrize("kw,match", [
    ({"pred_contrib": True}, "predict_contrib does not support linear_tree"),
])
def test_serving_refusals_by_name(pairs, kw, match):
    tb = pairs["f32"][1][0]
    with pytest.raises(LightGBMError, match=match):
        tb.predict(XV[:16], **kw)


@pytest.mark.parametrize("mode", ["f16", "int8"])
def test_quantized_serving_refuses_linear_by_name(pairs, mode):
    tb = pairs["f32"][1][0]
    clone = tlgb.Booster(model_str=tb.model_to_string(), device="cpu",
                         params={"tpu_predict_quantize": mode,
                                 "verbose": -1})
    with pytest.raises(LightGBMError, match="linear_tree leaf coefficients"):
        clone.predict(XV[:16])


def test_attach_bin_metadata_remaps_the_linear_features(pairs):
    """A linear tree loaded from text gets its inner feature slots back
    from a Dataset's used features (lightgbm_tpu/tree.py:253-267), and a
    regressor absent from the Dataset is refused by name."""
    tb = pairs["f32"][1][0]
    ds = tlgb.Dataset(X, Y, params=dict(BASE))._lazy_init()
    loaded = tlgb.Booster(model_str=tb.model_to_string(), device="cpu")
    for got, want in zip(loaded._inner.models, tb._inner.models):
        got.leaf_features_inner = np.full_like(got.leaf_features_inner, 7)
        got.attach_bin_metadata(ds)
        assert np.array_equal(got.leaf_features_inner,
                              want.leaf_features_inner)
    # a regressor the Dataset drops (a constant column) that no split of
    # the tree reads
    tree = min(loaded._inner.models,
               key=lambda t: len(set(t.split_feature[:t.num_leaves - 1])))
    unused = sorted(set(range(X.shape[1]))
                    - set(tree.split_feature[:tree.num_leaves - 1]))
    assert unused
    lone = unused[0]
    tree.leaf_features[0, 0] = lone
    x2 = X.copy()
    x2[:, lone] = 1.0
    with pytest.raises(LightGBMError, match="regresses on feature %d"
                       % lone):
        tree.attach_bin_metadata(
            tlgb.Dataset(x2, Y, params=dict(BASE))._lazy_init())
