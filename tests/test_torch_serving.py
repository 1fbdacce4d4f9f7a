"""The lightgbm_tpu_torch serving slice as a whole, on device="cpu":
Booster.predict and the serving Predictor against the JAX package's
Booster on the same model text, the refusals of what the slice does not
carry, and the device rule.

Tolerances: leaf indices exact; raw scores 1e-5 * max(1, |ref|) (f32
sums in another order); sigmoid outputs 1e-6 absolute.
"""
import threading

import numpy as np
import pytest
import torch

import lightgbm_tpu as jlgb
import lightgbm_tpu_torch as tlgb
from lightgbm_tpu_torch.testing.synth import (edge_case_rows,
                                              synthetic_forest_text)

torch.set_num_threads(1)

_PARAMS = {"verbose": -1, "num_leaves": 31, "min_data_in_leaf": 5}


def _rows(seed, n):
    rng = np.random.RandomState(seed)
    x = rng.randn(n, 6)
    x[rng.rand(n) < 0.1, 2] = np.nan
    x[rng.rand(n) < 0.2, 3] = 0.0
    return x


@pytest.fixture(scope="module")
def models():
    """name -> (model text, rows): a binary and a regression model
    trained by the JAX package, rows half ordinary, half edge cases."""
    x = _rows(0, 500)
    y = x[:, 0] + np.nan_to_num(x[:, 2]) + 0.3 * x[:, 1] ** 2
    out = {}
    for name, label in (("binary", (y > 0.3).astype(float)),
                        ("regression", y)):
        booster = jlgb.train(dict(_PARAMS, objective=name),
                             jlgb.Dataset(x, label), num_boost_round=15,
                             verbose_eval=False)
        text = booster.model_to_string()
        rows = np.concatenate([_rows(1, 200), edge_case_rows(
            booster._inner.models, 6, 2, 300)]).astype(np.float64)
        out[name] = (text, rows)
    return out


def _close(got, ref, kind):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape
    if kind == "leaf":
        np.testing.assert_array_equal(got, ref)
    elif kind == "sigmoid":
        assert np.abs(got - ref).max() <= 1e-6
    else:
        assert np.all(np.abs(got - ref) <= 1e-5 * np.maximum(1.0,
                                                             np.abs(ref)))


MODES = {"value": {}, "raw_score": {"raw_score": True},
         "pred_leaf": {"pred_leaf": True},
         "num_iteration": {"num_iteration": 5},
         "leaf_num_iteration": {"pred_leaf": True, "num_iteration": 5}}


@pytest.mark.parametrize("name", ["binary", "regression"])
@pytest.mark.parametrize("mode", list(MODES))
def test_booster_predict_matches_jax(models, name, mode):
    text, rows = models[name]
    kw = MODES[mode]
    got = tlgb.Booster(model_str=text, device="cpu").predict(rows, **kw)
    ref = jlgb.Booster(model_str=text).predict(rows, **kw)
    kind = ("leaf" if kw.get("pred_leaf") else
            "sigmoid" if name == "binary" and not kw.get("raw_score")
            else "raw")
    _close(got, ref, kind)


def test_predictor_paths_answer_as_predict(models):
    text, rows = models["binary"]
    booster = tlgb.Booster(model_str=text, device="cpu")
    ref = booster.predict(rows)
    predictor = booster.serving_predictor()
    warm = predictor.warmup()
    assert warm["seconds"] >= 0
    ones = [predictor.predict_one(r) for r in rows[:8]]
    np.testing.assert_array_equal(ones, ref[:8])
    futures = [None] * 32

    def submit(k):
        for i in range(k, 32, 4):
            futures[i] = predictor.submit(rows[i])

    threads = [threading.Thread(target=submit, args=(k,)) for k in range(4)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=60)
    assert not any(th.is_alive() for th in threads)
    got = [f.result(timeout=60) for f in futures]
    np.testing.assert_array_equal(got, ref[:32])
    stats = predictor.stats()
    assert stats["requests"] >= 8 + 1 and stats["stack_restacks"] == 1
    assert stats["micro_rows"] == 32 and stats["p99_latency_ms"] > 0
    predictor.close()
    with pytest.raises(tlgb.serving.PredictorShutdown):
        predictor.submit(rows[0])
    leaf = booster.serving_predictor(pred_leaf=True)
    np.testing.assert_array_equal(leaf.predict(rows[:4]),
                                  booster.predict(rows[:4], pred_leaf=True))


def test_stack_cache_evicts_and_restacks_the_same_forest(models):
    text, rows = models["binary"]
    booster = tlgb.Booster(model_str=text, device="cpu")
    cache = booster._inner._compiled_forest
    ref = booster.predict(rows)
    leaf = booster.predict(rows, pred_leaf=True)
    assert cache.stats["restacks"] == 1 and cache.stats["hits"] == 1
    held = cache.device_bytes()
    assert held > 0
    version = cache.version
    assert cache.evict_entries() == held
    assert cache.device_bytes() == 0 and cache.stats["evictions"] == 1
    assert cache.version == version
    np.testing.assert_array_equal(booster.predict(rows), ref)
    np.testing.assert_array_equal(booster.predict(rows, pred_leaf=True),
                                  leaf)
    assert cache.stats["restacks"] == 2 and cache.device_bytes() == held


def test_synthetic_forest_predicts_the_same_in_both_packages():
    text = synthetic_forest_text(11, 12, 31, 8, cat_features=2)
    jax_booster = jlgb.Booster(model_str=text)
    assert jax_booster.model_to_string() == text
    port = tlgb.Booster(model_str=text, device="cpu")
    rows = np.concatenate([
        np.random.RandomState(3).randn(100, 8),
        edge_case_rows(port._inner.models, 8, 4, 200, cat_features=2)])
    _close(port.predict(rows), jax_booster.predict(rows), "sigmoid")
    _close(port.predict(rows, raw_score=True),
           jax_booster.predict(rows, raw_score=True), "raw")
    _close(port.predict(rows, pred_leaf=True),
           jax_booster.predict(rows, pred_leaf=True), "leaf")


def _multiclass_text(text):
    return text.replace("num_class=1\n", "num_class=3\n").replace(
        "num_tree_per_iteration=1\n", "num_tree_per_iteration=3\n").replace(
        "objective=binary sigmoid:1\n", "")


def _linear_text(text):
    """One leaf of the first tree given a slope on feature 0."""
    head, rest = text.split("Tree=0\n", 1)
    block, tail = rest.split("\n\n", 1)
    nl = int(block.split("num_leaves=", 1)[1].split("\n", 1)[0])
    linear = ("tpu_linear_k=1\ntpu_leaf_features=" + " ".join(["0"] * nl)
              + "\ntpu_leaf_features_inner=" + " ".join(["0"] * nl)
              + "\ntpu_leaf_coeff=" + " ".join(["0.5"] * nl))
    return head + "Tree=0\n" + block + "\n" + linear + "\n\n" + tail


@pytest.mark.parametrize("case,match", [
    ("pred_contrib", "pred_contrib"),
    ("pred_early_stop", "pred_early_stop"),
    ("quantize_f16", "tpu_predict_quantize=f16"),
    ("quantize_int8", "tpu_predict_quantize=int8"),
    ("linear", "linear_tree"),
    ("multiclass", "multiclass"),
    ("objective", "objective regression_l1 is not ported"),
    ("training", "training is not ported"),
    ("data_file", "data file"),
])
def test_unsupported_options_raise_named_errors(models, case, match):
    text, rows = models["binary"]
    rows = rows[:4]
    with pytest.raises(tlgb.LightGBMError, match=match):
        if case == "training":
            tlgb.Booster({"objective": "binary"}, train_set=object(),
                         device="cpu")
        elif case == "objective":
            tlgb.Booster(model_str=text.replace(
                "objective=binary sigmoid:1", "objective=regression_l1"),
                device="cpu")
        else:
            params = {"tpu_predict_quantize": case[len("quantize_"):]} \
                if case.startswith("quantize") else {}
            if case == "linear":
                # linear models serve; the quantized layouts refuse them
                params = {"tpu_predict_quantize": "int8"}
            model = {"linear": _linear_text,
                     "multiclass": _multiclass_text}.get(case, str)(text)
            booster = tlgb.Booster(params, model_str=model, device="cpu")
            kw = {case: True} if case.startswith("pred_") else {}
            booster.predict("rows.tsv" if case == "data_file" else rows,
                            **kw)


def test_linear_text_helper_makes_a_linear_model(models):
    """The refusal above is for a real linear-leaf model: the JAX package
    reads the edited text as one."""
    text, _ = models["binary"]
    jax_booster = jlgb.Booster(model_str=_linear_text(text))
    assert jax_booster._inner.models[0].is_linear


def test_a_linear_forest_serves_as_the_jax_package_does(models):
    """A forest of one linear tree among constant ones (K1's plain
    version adds the linear term where a tree has one), with NaN rows
    that take the intercept alone."""
    text, rows = models["binary"]
    model = _linear_text(text)
    rows = np.array(rows[:64], np.float64)
    rows[::7, 0] = np.nan
    port = tlgb.Booster(model_str=model, device="cpu")
    jax_booster = jlgb.Booster(model_str=model)
    assert port.model_to_string() == model
    _close(port.predict(rows, raw_score=True),
           jax_booster.predict(rows, raw_score=True), "raw")
    _close(port.predict(rows), jax_booster.predict(rows), "sigmoid")
    assert not np.array_equal(port.predict(rows, raw_score=True),
                              tlgb.Booster(model_str=text, device="cpu")
                              .predict(rows, raw_score=True))


def test_no_device_means_cuda_and_never_falls_back(models, monkeypatch):
    text, _ = models["binary"]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(tlgb.LightGBMError, match="device='cpu'"):
        tlgb.Booster(model_str=text)
    with pytest.raises(tlgb.LightGBMError, match="CUDA is not available"):
        tlgb.Booster(model_str=text, device="cuda")
    assert tlgb.Booster(model_str=text, device="cpu").device.type == "cpu"


def test_zero_tree_model_predicts_the_transformed_prior(models):
    text, rows = models["binary"]
    empty = text.split("Tree=0\n", 1)[0] + "end of trees\n"
    port = tlgb.Booster(model_str=empty, device="cpu")
    ref = jlgb.Booster(model_str=empty)
    _close(port.predict(rows[:5]), ref.predict(rows[:5]), "sigmoid")
    _close(port.predict(rows[:5], raw_score=True),
           ref.predict(rows[:5], raw_score=True), "raw")
    assert port.predict(rows[:5], pred_leaf=True).shape == (5, 0)
