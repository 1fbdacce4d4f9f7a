"""lightgbm_tpu_torch.train with objective=lambdarank end to end against
lightgbm_tpu.train.

Both packages train on the same seeded ragged query data (8 features,
60 queries of 1-150 docs, a grouped valid set) on the CPU, the JAX
package with `tpu_hist_bf16=false` so both accumulate histograms in f32;
the port runs the plain versions of its kernels (`device="cpu"`). Each
JAX model is trained once per module. Tolerances: the same tree
structure (split features, bin thresholds, decision types, children),
leaf values and raw predictions within 1e-4 * max(1, |ref|), valid
ndcg@k and map@k within 2e-3 at every round, and the same
best_iteration under early stopping on ndcg@3. A JAX lambdarank model
text must load into the port and predict within 1e-5 * max(1, |ref|).
"""
import numpy as np
import pytest
import torch

import lightgbm_tpu as jlgb
import lightgbm_tpu_torch as tlgb
from lightgbm_tpu_torch import LightGBMError
from lightgbm_tpu_torch.convert import dataset_from_numpy

torch.set_num_threads(1)

BASE = {"objective": "lambdarank", "num_leaves": 15, "max_bin": 63,
        "learning_rate": 0.3, "min_data_in_leaf": 5,
        "min_sum_hessian_in_leaf": 1e-3, "verbose": -1,
        "tpu_hist_bf16": False}


def make(seed, nq):
    """Ragged queries of 1-150 docs; labels 0-4 from a noisy score."""
    rng = np.random.RandomState(seed)
    sizes = rng.randint(1, 151, size=nq)
    n = int(sizes.sum())
    x = rng.randn(n, 8)
    x[rng.rand(n) < 0.1, 5] = np.nan
    rel = x[:, 0] * 1.2 + 0.6 * x[:, 1] - 0.4 * x[:, 2] * x[:, 3] \
        + 0.6 * rng.randn(n)
    return x, np.clip(np.rint(rel + 1.0), 0, 4), sizes


X, Y, G = make(0, 60)
XV, YV, GV = make(1, 20)
RUNS = {
    # name -> (params, rounds, early_stopping_rounds)
    "ndcg_map": ({"metric": "ndcg,map", "ndcg_eval_at": [1, 3, 5]}, 5, None),
    "early_stop": ({"metric": "ndcg", "ndcg_eval_at": [3, 10]}, 40, 3),
}


def train_with(pkg, name, **kw):
    params, rounds, esr = RUNS[name]
    ds = pkg.Dataset(X, Y, group=G)
    evals = {}
    booster = pkg.train(dict(BASE, **params), ds, rounds,
                        valid_sets=[ds.create_valid(XV, YV, group=GV)],
                        valid_names=["valid"], early_stopping_rounds=esr,
                        evals_result=evals, verbose_eval=False, **kw)
    return booster, evals


@pytest.fixture(scope="module")
def pairs():
    return {name: (train_with(jlgb, name), train_with(tlgb, name,
                                                       device="cpu"))
            for name in RUNS}


def assert_same_trees(jb, tb):
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
        assert np.all(np.abs(b.leaf_value - a.leaf_value)
                      <= 1e-4 * np.maximum(1.0, np.abs(a.leaf_value))), i


@pytest.mark.parametrize("name", sorted(RUNS))
def test_same_trees_and_predictions(pairs, name):
    (jb, _), (tb, _) = pairs[name]
    assert_same_trees(jb, tb)
    ref = jb.predict(XV, raw_score=True)
    for raw in (True, False):
        got = tb.predict(XV, raw_score=raw)
        assert np.all(np.abs(got - ref) <= 1e-4 * np.maximum(1.0,
                                                             np.abs(ref)))


@pytest.mark.parametrize("name", sorted(RUNS))
def test_ranking_metrics_every_round_and_early_stopping(pairs, name):
    (jb, jev), (tb, tev) = pairs[name]
    assert sorted(jev["valid"]) == sorted(tev["valid"])
    for metric, series in jev["valid"].items():
        assert len(series) == len(tev["valid"][metric]) > 0
        assert np.all(np.abs(np.asarray(series)
                             - np.asarray(tev["valid"][metric])) <= 2e-3)
    assert tb.best_iteration == jb.best_iteration
    if RUNS[name][2]:
        assert 0 < tb.best_iteration < RUNS[name][1], "did not stop early"
        assert list(tev["valid"])[0] == "ndcg@3"
        for metric, value in jb.best_score["valid"].items():
            assert abs(tb.best_score["valid"][metric] - value) <= 2e-3


def test_jax_model_text_loads_and_serves(pairs):
    (jb, _), _ = pairs["ndcg_map"]
    text = jb.model_to_string()
    assert "objective=lambdarank" in text
    tb = tlgb.Booster(model_str=text, device="cpu")
    assert tb.model_to_string() == text
    for raw in (True, False):
        ref = jb.predict(XV, raw_score=raw)
        got = tb.predict(XV, raw_score=raw)
        assert np.all(np.abs(got - ref) <= 1e-5 * np.maximum(1.0,
                                                             np.abs(ref)))


def test_port_model_text_round_trips(pairs, tmp_path):
    _, (tb, _) = pairs["ndcg_map"]
    path = tmp_path / "ranker.txt"
    tb.save_model(str(path))
    back = tlgb.Booster(model_file=str(path), device="cpu")
    assert back.model_to_string() == tb.model_to_string()
    assert np.array_equal(back.predict(XV), tb.predict(XV))
    jb = jlgb.Booster(model_file=str(path))
    assert np.all(np.abs(jb.predict(XV) - tb.predict(XV)) <= 1e-5 * np.maximum(
        1.0, np.abs(tb.predict(XV))))


def test_same_bins_same_trees_through_convert():
    """The JAX Dataset's bins and query groups handed to the port
    (`convert.dataset_from_numpy`) grow the JAX package's trees."""
    params = dict(BASE, metric="ndcg")
    jds = jlgb.Dataset(X[:2000], Y[:2000], group=[100] * 20,
                       params=params).construct()
    jb = jlgb.train(params, jds, 3, verbose_eval=False)
    inner = jds._inner
    tin = dataset_from_numpy({
        "binned": np.asarray(inner.binned),
        "mappers": [m.to_dict() for m in inner.mappers],
        "groups": inner.groups.to_dict(), "label": inner.metadata.label,
        "query_boundaries": inner.metadata.query_boundaries,
        "feature_meta": inner.feature_meta_arrays(),
        "feature_names": inner.feature_names, "max_bin": inner.max_bin})
    assert np.array_equal(tin.metadata.query_boundaries,
                          inner.metadata.query_boundaries)
    tds = tlgb.Dataset(X[:2000], Y[:2000], group=[100] * 20, params=params)
    tds._inner = tin
    tb = tlgb.train(params, tds, 3, verbose_eval=False, device="cpu")
    assert_same_trees(jb, tb)


def test_group_api_and_fields():
    ds = tlgb.Dataset(X[:300], Y[:300], group=[100, 150, 50],
                      weight=np.linspace(0.5, 1.5, 300))
    assert ds.get_group() == [100, 150, 50]
    assert ds.get_field("group").tolist() == [100, 150, 50]
    assert np.allclose(ds.get_field("weight")[:2], [0.5, 0.5 + 1 / 299])
    meta = ds._inner.metadata
    assert meta.num_queries == 3
    assert np.allclose(meta.query_weights,
                       [np.linspace(0.5, 1.5, 300)[a:b].mean()
                        for a, b in ((0, 100), (100, 250), (250, 300))])
    ds.set_group([300])
    assert ds.get_field("group").tolist() == [300]
    ds.set_field("group", [200, 0, 100])
    assert meta.query_boundaries.tolist() == [0, 200, 200, 300]
    with pytest.raises(LightGBMError, match="Sum of query counts"):
        ds.set_field("group", [10, 20])
    with pytest.raises(LightGBMError, match="Unknown field"):
        ds.get_field("position")


def test_missing_groups_raise_by_name():
    with pytest.raises(LightGBMError,
                       match="Lambdarank tasks require query information"):
        tlgb.train(dict(BASE), tlgb.Dataset(X, Y), 2, verbose_eval=False,
                   device="cpu")
    ds = tlgb.Dataset(X, Y, group=G)
    with pytest.raises(LightGBMError, match="metric ndcg requires query"):
        tlgb.train(dict(BASE, metric="ndcg"), ds, 2,
                   valid_sets=[ds.create_valid(XV, YV)], verbose_eval=False,
                   device="cpu")


def test_default_device_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")
    with pytest.raises(LightGBMError, match="device='cpu'"):
        tlgb.train(dict(BASE), tlgb.Dataset(X, Y, group=G), 2,
                   verbose_eval=False)
    with pytest.raises(LightGBMError, match="device='cpu'"):
        tlgb.Booster(model_str="tree\nobjective=lambdarank\n")
