"""The model API around serving, port against the JAX package on the CPU:

- `Booster.dump_model` equals the JAX package's dict on the same model
  text (constant, categorical and linear trees);
- `predict(pred_contrib=True)` (the port's copy of the host TreeSHAP,
  `lightgbm_tpu_torch/shap.py`) equals `lightgbm_tpu.shap.
  predict_contrib`, and each row's contributions sum to its raw score;
- `io.parser.load_data_file` equals the JAX package's for tsv, csv and
  libsvm files, and `Booster.predict(path)` equals the array call;
- continued training from a model file (`train(..., init_model=)`):
  the replayed train score equals the JAX package's replay bitwise (W
  sums each class's trees into a zero buffer in XLA's order, then one
  add), for 10 and for 40 trees (XLA sums more than 32 by halves); the
  continued model's 20 trees have the JAX package's structure, and
  leaves and raw predictions within 1e-4 * max(1, |ref|), ROADMAP C's
  margin for f32 sums: every tree from the same scores as the JAX
  package's, but f32 training sums each histogram bin in another order
  than XLA (the port's fixed lane and tile trees, the JAX package's
  one-hot contraction over row chunks), and one leaf of a small
  hessian (tree 15) lifts that round-off to 6.4e-6, the
  cause of ROADMAP C's f32 + bagging entry (the other continued trees
  stay within 2.4e-6, the raw predictions within 7.3e-6); a replay from the
  model trained on the same data reproduces its raw predictions (the
  check of tests/test_engine.py test_continued_training_binned_replay_
  exact); a linear init_model replays within 1e-5 of the JAX package's
  replay (LA's sums are JAX's; the tree's f32 leaves take the fit's
  round-off, ROADMAP C) and is refused without linear_tree, with the
  JAX package's words.
"""
import json

import numpy as np
import pytest
import torch

import lightgbm_tpu as jlgb
import lightgbm_tpu_torch as tlgb
from lightgbm_tpu.io.parser import load_data_file as jax_load
from lightgbm_tpu.shap import predict_contrib as jax_contrib
from lightgbm_tpu_torch.io.parser import detect_format, load_data_file
from lightgbm_tpu_torch.testing.synth import synthetic_forest_text

torch.set_num_threads(1)

BINARY = {"objective": "binary", "verbose": -1, "num_leaves": 15,
          "min_data_in_leaf": 5, "max_bin": 63}


def _bits(a):
    return np.asarray(a, np.float32).view(np.int32)


def _data(seed=0, n=1200, f=8):
    rng = np.random.RandomState(seed)
    x = rng.randn(n, f)
    x[rng.rand(n) < 0.05, 3] = np.nan
    y = (x[:, 0] - x[:, 1] + 0.5 * np.nan_to_num(x[:, 3])
         + 0.3 * rng.randn(n) > 0).astype(float)
    return x, y


def _categorical_text():
    rng = np.random.RandomState(1)
    x = rng.randn(500, 6)
    x[:, 5] = rng.randint(0, 9, 500)
    y = (x[:, 0] + (x[:, 5] % 3 == 0) > 0.4).astype(float)
    return jlgb.train(dict(BINARY), jlgb.Dataset(
        x, y, categorical_feature=[5]), 6,
        verbose_eval=False).model_to_string()


def _linear_text():
    x, y = _data(2, 600, 5)
    params = dict(BINARY, linear_tree=True, linear_lambda=0.01)
    return jlgb.train(params, jlgb.Dataset(x, y), 5,
                      verbose_eval=False).model_to_string()


@pytest.mark.parametrize("kind", ["constant", "categorical", "linear",
                                  "synthetic"])
def test_dump_model_equals_jax(kind):
    text = {"constant": lambda: jlgb.train(
                dict(BINARY), jlgb.Dataset(*_data()), 5,
                verbose_eval=False).model_to_string(),
            "categorical": _categorical_text, "linear": _linear_text,
            "synthetic": lambda: synthetic_forest_text(2, 6, 15, 8, 2)}[
        kind]()
    ref = jlgb.Booster(model_str=text).dump_model()
    got = tlgb.Booster(model_str=text, device="cpu").dump_model()
    assert json.dumps(got, sort_keys=True) == json.dumps(ref, sort_keys=True)
    assert len(got["tree_info"]) > 0
    capped = tlgb.Booster(model_str=text, device="cpu").dump_model(2)
    assert len(capped["tree_info"]) == 2


@pytest.mark.parametrize("kind", ["trained", "categorical"])
def test_pred_contrib_equals_jax(kind):
    x, y = _data(3, 400)
    if kind == "trained":
        text = jlgb.train(dict(BINARY), jlgb.Dataset(x, y), 8,
                          verbose_eval=False).model_to_string()
    else:
        text = _categorical_text()
        x = x[:, :6].copy()
        x[:, 5] = np.random.RandomState(4).randint(-1, 10, len(x))
    jb = jlgb.Booster(model_str=text)
    tb = tlgb.Booster(model_str=text, device="cpu")
    ref = jb.predict(x, pred_contrib=True)
    got = tb.predict(x, pred_contrib=True)
    assert got.shape == (len(x), x.shape[1] + 1)
    assert np.array_equal(got, ref)
    assert np.array_equal(got, jax_contrib(jb._inner, x))
    raw = tb.predict(x, raw_score=True)
    assert np.all(np.abs(got.sum(axis=1) - raw)
                  <= 1e-5 * np.maximum(1, np.abs(raw)))


def test_pred_contrib_refuses_linear_by_name():
    tb = tlgb.Booster(model_str=_linear_text(), device="cpu")
    with pytest.raises(tlgb.LightGBMError,
                       match="predict_contrib does not support linear_tree"):
        tb.predict(np.zeros((2, 5)), pred_contrib=True)


def _write(path, fmt, y, x):
    if fmt == "libsvm":
        with open(path, "w") as fh:
            for label, row in zip(y, x):
                cells = " ".join("%d:%.6g" % (j, v) for j, v in
                                 enumerate(row) if v != 0)
                fh.write("%g %s\n" % (label, cells))
    else:
        np.savetxt(path, np.column_stack([y, x]),
                   delimiter="\t" if fmt == "tsv" else ",", fmt="%.7g")


@pytest.mark.parametrize("fmt", ["tsv", "csv", "libsvm"])
def test_load_data_file_equals_jax(tmp_path, fmt):
    x, y = _data(5, 300, 6)
    if fmt == "libsvm":
        x = np.nan_to_num(x)
        x[:, 4] = 0.0
        x[:, 5] = np.where(np.arange(300) % 3 == 0, x[:, 5], 0.0)
    path = str(tmp_path / ("data." + fmt))
    _write(path, fmt, y, x)
    assert detect_format(path) == fmt
    got_x, got_y = load_data_file(path)
    ref_x, ref_y = jax_load(path)
    np.testing.assert_array_equal(got_x, ref_x)
    np.testing.assert_array_equal(got_y, ref_y)
    assert got_x.dtype == np.float64 and got_x.shape[0] == 300


def test_predict_from_a_data_file_equals_the_array_call(tmp_path):
    x, y = _data(6, 300, 8)
    text = jlgb.train(dict(BINARY), jlgb.Dataset(x, y), 5,
                      verbose_eval=False).model_to_string()
    path = str(tmp_path / "valid.tsv")
    _write(path, "tsv", y, x)
    arr, _ = load_data_file(path)
    tb = tlgb.Booster(model_str=text, device="cpu")
    assert np.array_equal(tb.predict(path), tb.predict(arr))
    assert np.array_equal(tb.predict(path, raw_score=True),
                          jlgb.Booster(model_str=text).predict(
                              path, raw_score=True))


def _continue(pkg, params, x, y, path, rounds, **kw):
    booster = pkg.train(dict(params), pkg.Dataset(x, y), rounds,
                        init_model=path, verbose_eval=False, **kw)
    return booster


@pytest.mark.parametrize("first_rounds", [10, 40])
def test_continued_training_matches_jax(tmp_path, first_rounds):
    x, y = _data(7)
    path = str(tmp_path / "model.txt")
    jlgb.train(dict(BINARY), jlgb.Dataset(x, y), first_rounds,
               verbose_eval=False).save_model(path)
    # the replay alone: 0 further rounds
    jb0 = _continue(jlgb, BINARY, x, y, path, 0)
    tb0 = _continue(tlgb, BINARY, x, y, path, 0, device="cpu")
    assert np.array_equal(_bits(tb0._inner._train_score_unpadded()),
                          _bits(jb0._inner._train_score_unpadded()))
    assert tb0.num_trees() == first_rounds
    if first_rounds > 10:
        return
    jb = _continue(jlgb, BINARY, x, y, path, 10)
    tb = _continue(tlgb, BINARY, x, y, path, 10, device="cpu")
    jt, tt = jb._inner.models, tb._inner.models
    assert len(jt) == len(tt) == 20 and tb.current_iteration() == 20
    for i, (a, b) in enumerate(zip(jt, tt)):
        m = a.num_leaves - 1
        assert a.num_leaves == b.num_leaves, i
        for k in ("split_feature", "threshold_in_bin", "decision_type",
                  "left_child", "right_child"):
            assert np.array_equal(getattr(a, k)[:m], getattr(b, k)[:m]), \
                (i, k)
        assert np.all(np.abs(b.leaf_value - a.leaf_value)
                      <= 1e-4 * np.maximum(1.0, np.abs(a.leaf_value))), i
    ref = jb.predict(x, raw_score=True)
    got = tb.predict(x, raw_score=True)
    assert np.all(np.abs(got - ref) <= 1e-4 * np.maximum(1.0, np.abs(ref)))


def test_continued_training_binned_replay_exact():
    """tests/test_engine.py:431: the replay of a model trained on the same
    data reproduces its raw predictions; a Booster serves as init_model
    too, and carries its best iteration."""
    x, y = _data(8, 600)
    gbm1 = tlgb.train(dict(BINARY, metric="binary_logloss"),
                      tlgb.Dataset(x[:400], y[:400]), 8,
                      valid_sets=[tlgb.Dataset(x[400:], y[400:])],
                      early_stopping_rounds=2, verbose_eval=False,
                      device="cpu")
    gbm2 = tlgb.train(dict(BINARY), tlgb.Dataset(x[:400], y[:400]), 0,
                      init_model=tlgb.Booster(
                          model_str=gbm1.model_to_string(), device="cpu"),
                      verbose_eval=False, device="cpu")
    replayed = gbm2._inner._train_score_unpadded()
    predicted = gbm1.predict(x[:400], raw_score=True)
    assert np.allclose(replayed, predicted, atol=1e-4)
    gbm3 = tlgb.train(dict(BINARY), tlgb.Dataset(x[:400], y[:400]), 1,
                      init_model=gbm1, verbose_eval=False, device="cpu")
    assert gbm3.best_iteration == gbm1.best_iteration
    assert gbm3.best_score == gbm1.best_score
    assert gbm3.num_trees() == gbm1.num_trees() + 1


def test_linear_init_model_replays_as_jax(tmp_path):
    x, y = _data(9, 600, 5)
    params = dict(BINARY, linear_tree=True, linear_lambda=0.01)
    path = str(tmp_path / "linear.txt")
    jlgb.train(dict(params), jlgb.Dataset(x, y), 5,
               verbose_eval=False).save_model(path)
    jb = jlgb.train(dict(params), jlgb.Dataset(x, y), 0, init_model=path,
                    verbose_eval=False)
    tb = tlgb.train(dict(params), tlgb.Dataset(x, y, params=dict(params)),
                    0, init_model=path, verbose_eval=False, device="cpu")
    ref = jb._inner._train_score_unpadded()
    got = tb._inner._train_score_unpadded()
    assert np.all(np.abs(got - ref) <= 1e-5 * np.maximum(1, np.abs(ref)))
    more = tlgb.train(dict(params), tlgb.Dataset(x, y, params=dict(params)),
                      2, init_model=path, verbose_eval=False, device="cpu")
    assert more.num_trees() == 7 and all(t.is_linear
                                         for t in more._inner.models)
    with pytest.raises(tlgb.LightGBMError,
                       match="requires linear_tree=true in the continuing"):
        tlgb.train(dict(BINARY), tlgb.Dataset(x, y), 1, init_model=path,
                   verbose_eval=False, device="cpu")
