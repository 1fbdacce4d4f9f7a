"""Prediction early stop (kernel ES's plain version and the Booster
route) against the JAX package, on the CPU.

`forest_early_stop_walk_plain` over the port's [K, T] stack must equal
`lightgbm_tpu.ops.predict.predict_forest_raw_early_stop` over the JAX
package's early-stop stack **bitwise**: each iteration adds the K class
trees' f32 values to the active rows in the same order, and a frozen row
keeps its sums, so no tolerance is needed. Cases: K = 1 (a JAX-trained
model with NaN-missing and categorical splits, a synthetic forest of
every missing type), K = 3 (three synthetic class forests stacked
iteration-major) and a JAX-trained linear forest, at freq {1, 3, 10} and
margins {0, the median final margin, 1e30}.

`Booster.predict(pred_early_stop=True)` of the port against the JAX
package on the same trained binary model (the counterparts of
tests/test_engine.py test_pred_early_stop and tests/test_serving.py
test_pred_early_stop_bit_identical): raw scores bitwise, outputs within
1e-6 (both sigmoids are f32, computed by different exp routines); a
regression model ignores the option, as in the JAX package.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import lightgbm_tpu as jlgb
import lightgbm_tpu_torch as tlgb
from lightgbm_tpu.ops.predict import predict_forest_raw_early_stop
from lightgbm_tpu.serving.forest import CompiledForest as JaxCache
from lightgbm_tpu_torch.ops.predict import (forest_early_stop_walk,
                                            forest_early_stop_walk_plain,
                                            stack_trees_early_stop)
from lightgbm_tpu_torch.testing.synth import (edge_case_rows,
                                              synthetic_forest_text,
                                              synthetic_rows)

torch.set_num_threads(1)
CPU = torch.device("cpu")
# one trace per (stack, freq): the margin is an argument
jax_early_stop = jax.jit(predict_forest_raw_early_stop,
                         static_argnames=("freq",))


def _bits(a):
    return np.asarray(a, np.float32).view(np.int32)


def _trained_text(linear=False):
    rng = np.random.RandomState(0)
    x = rng.randn(600, 8)
    x[:, 6] = rng.randint(0, 12, 600)
    x[rng.rand(600) < 0.1, 2] = np.nan
    y = (x[:, 0] + np.nan_to_num(x[:, 2]) + (x[:, 6] % 3 == 0) > 0.5)
    params = {"objective": "binary", "verbose": -1, "num_leaves": 15,
              "min_data_in_leaf": 5}
    cats = [6]
    if linear:
        params.update(linear_tree=True, linear_lambda=0.01)
        cats = "auto"
        x[:, 6] = rng.randn(600)
    booster = jlgb.train(params, jlgb.Dataset(x, y.astype(float),
                                              categorical_feature=cats),
                         num_boost_round=12, verbose_eval=False)
    return booster.model_to_string(), 8


def _models(text):
    return (jlgb.Booster(model_str=text)._inner.models,
            tlgb.Booster(model_str=text, device="cpu")._inner.models)


@pytest.fixture(scope="module")
def stacks():
    """name -> (JAX trees, port trees, K, rows)."""
    out = {}
    for name, (text, nf) in (("trained", _trained_text()),
                             ("synthetic", (synthetic_forest_text(
                                 3, 20, 31, 10), 10)),
                             ("linear", _trained_text(linear=True))):
        jt, tt = _models(text)
        rows = np.concatenate([synthetic_rows(5, 150, nf),
                               edge_case_rows(tt, nf, 6, 250)])
        out[name] = (jt, tt, 1, rows)
    # K = 3: three class forests of 9 trees, stored iteration-major
    per_class = [_models(synthetic_forest_text(10 + c, 9, 15, 10))
                 for c in range(3)]
    jt = [per_class[c][0][t] for t in range(9) for c in range(3)]
    tt = [per_class[c][1][t] for t in range(9) for c in range(3)]
    rows = np.concatenate([synthetic_rows(7, 150, 10),
                           edge_case_rows(tt, 10, 8, 250)])
    out["three_classes"] = (jt, tt, 3, rows)
    return out


def _median_margin(stack_port, x, k):
    full, _ = forest_early_stop_walk_plain(stack_port, x, 1e30, 1)
    if k == 1:
        return float(np.median(2.0 * np.abs(full[0].numpy())))
    top = np.sort(full.numpy().T, axis=1)
    return float(np.median(top[:, -1] - top[:, -2]))


@pytest.mark.parametrize("freq", [1, 3, 10])
@pytest.mark.parametrize("name", ["trained", "synthetic", "linear",
                                  "three_classes"])
def test_plain_equals_jax_early_stop_bitwise(stacks, name, freq):
    jt, tt, k, rows = stacks[name]
    t_iters = len(tt) // k
    port = stack_trees_early_stop(tt, k, t_iters, CPU)
    jax_stack = JaxCache().early_stop_stacks(jt, k, t_iters)
    x = torch.from_numpy(rows)
    if name == "linear":
        assert port.linear_k > 0
    for margin in (0.0, _median_margin(port, x, k), 1e30):
        ref = np.asarray(jax_early_stop(
            jax_stack, jnp.asarray(rows), jnp.float32(margin), freq=freq))
        got, iters = forest_early_stop_walk_plain(port, x, margin, freq)
        assert got.shape == (k, len(rows))
        assert np.array_equal(_bits(got.numpy()), _bits(ref)), margin
        it = iters.numpy()
        assert it.min() >= min(freq, t_iters) and it.max() <= t_iters
        if margin == 1e30:
            assert (it == t_iters).all()
        if margin == 0.0 and freq <= t_iters:
            # every row with a non-zero margin freezes at the first check
            assert (it == freq).mean() > 0.9


def test_wrapper_on_cpu_runs_the_plain_version(stacks):
    jt, tt, k, rows = stacks["three_classes"]
    port = stack_trees_early_stop(tt, k, len(tt) // k, CPU)
    x = torch.from_numpy(rows)
    before = forest_early_stop_walk.launches
    out, iters = forest_early_stop_walk(port, x, 0.5, 2, return_iters=True)
    ref, ref_iters = forest_early_stop_walk_plain(port, x, 0.5, 2)
    assert torch.equal(out, ref) and torch.equal(iters, ref_iters)
    assert forest_early_stop_walk.launches == before
    with pytest.raises(tlgb.LightGBMError, match="pred_early_stop_freq"):
        forest_early_stop_walk(port, x, 0.5, 0)


@pytest.fixture(scope="module")
def binary_pair():
    rng = np.random.RandomState(1)
    x = rng.randn(400, 6)
    y = (x[:, 0] - x[:, 1] + 0.3 * rng.randn(400) > 0).astype(float)
    params = {"objective": "binary", "verbose": -1, "num_leaves": 15}
    jb = jlgb.train(params, jlgb.Dataset(x, y), num_boost_round=20,
                    verbose_eval=False)
    tb = tlgb.Booster(model_str=jb.model_to_string(), device="cpu")
    return jb, tb, x


@pytest.mark.parametrize("freq,margin", [(5, 1e30), (1, 0.0), (2, 1e9),
                                         (2, 0.0), (5, 4.0)])
def test_booster_early_stop_equals_jax(binary_pair, freq, margin):
    jb, tb, x = binary_pair
    kw = dict(pred_early_stop=True, pred_early_stop_freq=freq,
              pred_early_stop_margin=margin)
    ref = jb.predict(x, raw_score=True, **kw)
    got = tb.predict(x, raw_score=True, **kw)
    assert np.array_equal(_bits(got), _bits(ref))
    assert np.abs(tb.predict(x, **kw) - jb.predict(x, **kw)).max() <= 1e-6
    full = tb.predict(x, raw_score=True)
    if margin == 1e30:
        assert np.array_equal(got, full)
    if margin == 0.0 and freq == 1:
        assert np.array_equal(got, tb.predict(x, raw_score=True,
                                              num_iteration=1))
        assert not np.allclose(full, got)


def test_predictor_passes_early_stop_through(binary_pair):
    _, tb, x = binary_pair
    kw = dict(pred_early_stop=True, pred_early_stop_freq=2,
              pred_early_stop_margin=1.0)
    pred = tb.serving_predictor(raw_score=True, **kw)
    pred.warmup()
    assert np.array_equal(pred.predict(x[:40]),
                          tb.predict(x[:40], raw_score=True, **kw))
    pred.close()


def test_regression_ignores_early_stop():
    rng = np.random.RandomState(2)
    x = rng.randn(300, 5)
    y = x[:, 0] * 2 + rng.randn(300) * 0.1
    jb = jlgb.train({"objective": "regression", "verbose": -1,
                     "num_leaves": 7}, jlgb.Dataset(x, y), 10,
                    verbose_eval=False)
    tb = tlgb.Booster(model_str=jb.model_to_string(), device="cpu")
    kw = dict(pred_early_stop=True, pred_early_stop_freq=1,
              pred_early_stop_margin=0.0)
    assert np.array_equal(tb.predict(x, **kw), tb.predict(x))
    assert np.array_equal(tb.predict(x, raw_score=True, **kw),
                          tb.predict(x, raw_score=True))
    assert np.abs(tb.predict(x, **kw) - jb.predict(x, **kw)).max() <= 1e-5
    assert tb._inner._compiled_forest.stats["restacks"] == 1
