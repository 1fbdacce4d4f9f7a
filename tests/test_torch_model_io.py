"""lightgbm_tpu_torch model IO against the JAX package.

Models are trained once per module with the JAX package on the CPU at
fixture scale; the port must load their text, write the same bytes back
(`tpu_*` metadata lines included), hold the same tree arrays, and build
the same model from the trees' arrays (`convert`) as from their text.
"""
import numpy as np
import pytest
import torch

import lightgbm_tpu as jlgb
import lightgbm_tpu_torch as tlgb
from lightgbm_tpu_torch.convert import booster_from_numpy, trees_from_numpy

torch.set_num_threads(1)

_BASE = {"verbose": -1, "num_leaves": 31, "min_data_in_leaf": 5}
# name -> (params, categorical columns, rounds); every model reads all
# eight columns, so the NaN column makes NaN-missing splits everywhere
MODELS = {
    "binary": ({"objective": "binary"}, "auto", 12),
    "regression": ({"objective": "regression"}, "auto", 12),
    "zero_missing": ({"objective": "regression", "zero_as_missing": True},
                     "auto", 12),
    "categorical": ({"objective": "binary"}, [6], 12),
    "dart": ({"objective": "binary", "boosting": "dart", "drop_rate": 0.5,
              "skip_drop": 0.0}, "auto", 6),
}


def make_data(seed, n=500):
    """Rows with a NaN-missing column (2), a column with many exact
    zeros (3) and an integer category column (6)."""
    rng = np.random.RandomState(seed)
    x = rng.randn(n, 8)
    x[:, 6] = rng.randint(0, 12, n)
    x[rng.rand(n) < 0.1, 2] = np.nan
    x[rng.rand(n) < 0.2, 3] = 0.0
    y = (x[:, 0] + 0.5 * np.nan_to_num(x[:, 2]) + (x[:, 6] % 3 == 0)
         + 0.3 * rng.randn(n))
    return x, y


def train_jax(name, seed=0):
    params, cats, rounds = MODELS[name]
    x, y = make_data(seed)
    label = (y > 0.5).astype(float) if params["objective"] == "binary" else y
    ds = jlgb.Dataset(x, label, categorical_feature=cats)
    return jlgb.train(dict(_BASE, **params), ds, num_boost_round=rounds,
                      verbose_eval=False)


@pytest.fixture(scope="module")
def jax_boosters():
    return {name: train_jax(name) for name in MODELS}


def _tree_arrays(tree):
    return {k: np.asarray(v) for k, v in vars(tree).items()}


def _assert_same_trees(a_trees, b_trees):
    assert len(a_trees) == len(b_trees)
    for a, b in zip(a_trees, b_trees):
        for key, value in vars(b).items():
            np.testing.assert_array_equal(
                np.asarray(getattr(a, key)), np.asarray(value), err_msg=key)


@pytest.mark.parametrize("name", list(MODELS))
def test_model_text_round_trips_byte_for_byte(jax_boosters, name):
    text = jax_boosters[name].model_to_string()
    assert "tpu_threshold_in_bin=" in text and "tpu_node_group=" in text
    port = tlgb.Booster(model_str=text, device="cpu")
    assert port.model_to_string() == text
    assert port.num_trees() == jax_boosters[name].num_trees()
    assert port.num_feature() == jax_boosters[name].num_feature()
    if name == "dart":
        assert text.startswith("dart\n") and "tpu_dart_tree_weights=" in text
    if name == "categorical":
        assert any(t.num_cat > 0 for t in port._inner.models)


@pytest.mark.parametrize("name", list(MODELS))
def test_tree_arrays_equal_jax(jax_boosters, name):
    """Every attribute of every port Tree equals the JAX Tree's, both the
    trained trees and the JAX package's own load of the same text (the
    port rebuilds node_missing from decision_type as the JAX load does)."""
    text = jax_boosters[name].model_to_string()
    port = tlgb.Booster(model_str=text, device="cpu")._inner.models
    _assert_same_trees(jax_boosters[name]._inner.models, port)
    _assert_same_trees(jlgb.Booster(model_str=text)._inner.models, port)


@pytest.mark.parametrize("name", list(MODELS))
def test_convert_arrays_route_equals_text_route(jax_boosters, name):
    jb = jax_boosters[name]
    inner = jb._inner
    arrays = [_tree_arrays(t) for t in inner.models]
    text = jb.model_to_string()
    by_text = tlgb.Booster(model_str=text, device="cpu")
    _assert_same_trees(by_text._inner.models, trees_from_numpy(arrays))
    header = {"num_class": inner.num_class,
              "num_tree_per_iteration": inner.num_tree_per_iteration,
              "max_feature_idx": inner.max_feature_idx,
              "objective": inner.objective.to_string(),
              "init_score_bias": inner.init_score_bias,
              "average_output": inner.average_output,
              "feature_names": inner.feature_names,
              "feature_infos": getattr(inner, "feature_infos_", None),
              "boosting": inner.model_name().replace("tree", "gbdt")}
    by_arrays = booster_from_numpy(header, arrays, device="cpu")
    if name == "dart":
        by_arrays._inner.tree_weight = list(inner.tree_weight)
        by_arrays._inner.sum_weight = inner.sum_weight
    assert by_arrays.model_to_string() == text
    x, _ = make_data(1, n=200)
    np.testing.assert_array_equal(by_arrays.predict(x), by_text.predict(x))


def test_convert_refuses_unknown_fields():
    with pytest.raises(tlgb.LightGBMError, match="unknown Tree field"):
        trees_from_numpy([{"num_leaves": 1, "leaf_values": [0.0]}])


def test_fixture_models_carry_every_node_kind(jax_boosters):
    """The fixtures exercise what the loader must carry: NaN-missing and
    zero-missing numeric splits, both default directions, categorical
    bitsets."""
    def decisions(name):
        return np.concatenate([t.decision_type[:t.num_leaves - 1]
                               for t in jax_boosters[name]._inner.models])
    binary = decisions("binary")
    assert ((binary >> 2) & 3 == 2).any() and (binary & 2).any()
    assert ((decisions("zero_missing") >> 2) & 3 == 1).any()
    assert (decisions("categorical") & 1).any()
