"""lightgbm_tpu_torch ops/predict.py against the JAX package's forest
kernels, on the CPU (the plain versions of K1 forest_value_walk and K2
forest_leaf_walk; the CUDA kernels are held against these on the card by
chip_smoke.py).

Tolerances: leaf indices are exact. Raw sums are f32 sums in another
order (the JAX matmul path adds trees in batches of 5, ops/predict.py
:585-626), so |delta| <= 1e-5 * max(1, |ref|). The output epilogue is f32
on both sides: 1e-6 absolute.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lightgbm_tpu as jlgb
import lightgbm_tpu_torch as tlgb
from lightgbm_tpu.config import Config as JaxConfig
from lightgbm_tpu.objectives import create_objective as jax_objective
from lightgbm_tpu.ops.predict import (predict_forest_leaf_matmul,
                                      predict_forest_leaf_raw,
                                      predict_forest_raw,
                                      predict_forest_raw_matmul,
                                      stack_trees_matmul, stack_trees_raw)
from lightgbm_tpu.tree import Tree as JaxTree
from lightgbm_tpu_torch.ops import _build
from lightgbm_tpu_torch.ops.predict import (OutputTransform,
                                            apply_output_plain,
                                            forest_leaf_walk,
                                            forest_leaf_walk_plain,
                                            forest_value_walk,
                                            forest_value_walk_plain,
                                            stack_trees)
from lightgbm_tpu_torch.testing.synth import (edge_case_rows,
                                              synthetic_forest_text,
                                              synthetic_rows)
from lightgbm_tpu_torch.tree import Tree

torch.set_num_threads(1)

CPU = torch.device("cpu")


def _trained_categorical_text():
    rng = np.random.RandomState(0)
    x = rng.randn(500, 8)
    x[:, 6] = rng.randint(0, 12, 500)
    x[rng.rand(500) < 0.1, 2] = np.nan
    y = (x[:, 0] + np.nan_to_num(x[:, 2]) + (x[:, 6] % 3 == 0) > 0.5)
    booster = jlgb.train(
        {"objective": "binary", "verbose": -1, "num_leaves": 31,
         "min_data_in_leaf": 5},
        jlgb.Dataset(x, y.astype(float), categorical_feature=[6]),
        num_boost_round=15, verbose_eval=False)
    return booster.model_to_string()


@pytest.fixture(scope="module")
def forests():
    """name -> (model text, rows): a JAX-trained model (NaN-missing and
    categorical splits) and two seeded synthetic forests (all missing
    types, categorical bitsets of one and two words). Rows are half
    ordinary, half steered edge cases."""
    texts = {
        "trained": (_trained_categorical_text(), 8, 0),
        "synthetic": (synthetic_forest_text(3, 20, 31, 10), 10, 0),
        "synthetic_cat": (synthetic_forest_text(4, 16, 31, 10, 3), 10, 3),
    }
    out = {}
    for name, (text, nf, cats) in texts.items():
        trees = tlgb.Booster(model_str=text, device="cpu")._inner.models
        rows = np.concatenate([synthetic_rows(5, 200, nf, cats),
                               edge_case_rows(trees, nf, 6, 400, cats)])
        out[name] = (text, rows)
    return out


def _both(text):
    return (jlgb.Booster(model_str=text)._inner.models,
            tlgb.Booster(model_str=text, device="cpu")._inner.models)


NAMES = ["trained", "synthetic", "synthetic_cat"]


@pytest.mark.parametrize("name", NAMES)
def test_leaf_walk_plain_equals_jax_walk_and_matmul(forests, name):
    text, rows = forests[name]
    jax_trees, port_trees = _both(text)
    got = forest_leaf_walk_plain(stack_trees(port_trees, CPU),
                                 torch.from_numpy(rows)).numpy()
    xj = jnp.asarray(rows)
    np.testing.assert_array_equal(
        got, np.asarray(predict_forest_leaf_raw(stack_trees_raw(jax_trees),
                                                xj)))
    np.testing.assert_array_equal(
        got, np.asarray(predict_forest_leaf_matmul(
            stack_trees_matmul(jax_trees), xj)))


@pytest.mark.parametrize("name", NAMES)
def test_value_walk_plain_matches_jax_walk_and_matmul(forests, name):
    text, rows = forests[name]
    jax_trees, port_trees = _both(text)
    got = forest_value_walk_plain(stack_trees(port_trees, CPU),
                                  torch.from_numpy(rows)).numpy()
    xj = jnp.asarray(rows)
    for ref in (predict_forest_raw(stack_trees_raw(jax_trees), xj),
                predict_forest_raw_matmul(stack_trees_matmul(jax_trees), xj)):
        ref = np.asarray(ref, np.float64)
        assert np.all(np.abs(got - ref) <= 1e-5 * np.maximum(1.0,
                                                             np.abs(ref)))


@pytest.mark.parametrize("kind,params", [
    ("sigmoid", {"objective": "binary"}),
    ("sigmoid", {"objective": "binary", "sigmoid": 0.7}),
    ("identity", {"objective": "regression"}),
])
def test_epilogue_matches_jax_convert_output(kind, params):
    raw = np.random.RandomState(7).standard_normal(257).astype(np.float32) * 4
    obj = jax_objective(JaxConfig.from_params(dict(params)))
    denom, bias = 3.0, 0.25
    ref = np.asarray(obj.convert_output(
        jnp.asarray(raw) / jnp.float32(denom) + jnp.float32(bias)))
    got = apply_output_plain(
        torch.from_numpy(raw),
        OutputTransform(kind, denom=denom, bias=bias,
                        sigmoid=params.get("sigmoid", 1.0))).numpy()
    assert np.abs(got - ref).max() <= 1e-6


def test_wrappers_on_cpu_tensors_run_the_plain_versions(forests):
    text, rows = forests["synthetic_cat"]
    forest = stack_trees(tlgb.Booster(model_str=text,
                                      device="cpu")._inner.models, CPU)
    x = torch.from_numpy(rows)
    before = (forest_value_walk.launches, forest_leaf_walk.launches)
    tr = OutputTransform("sigmoid", denom=2.0, bias=0.5)
    assert torch.equal(forest_value_walk(forest, x, tr),
                       forest_value_walk_plain(forest, x, tr))
    assert torch.equal(forest_leaf_walk(forest, x),
                       forest_leaf_walk_plain(forest, x))
    assert (forest_value_walk.launches, forest_leaf_walk.launches) == before


def test_wrappers_refuse_inputs_the_kernels_do_not_take(forests):
    text, rows = forests["synthetic"]
    forest = stack_trees(tlgb.Booster(model_str=text,
                                      device="cpu")._inner.models, CPU)
    x = torch.from_numpy(rows)
    for bad in (x.double(), x[:, :3].contiguous(), x.t().contiguous().t(),
                x[0]):
        with pytest.raises(tlgb.LightGBMError):
            forest_value_walk(forest, bad)
        with pytest.raises(tlgb.LightGBMError):
            forest_leaf_walk(forest, bad)


def test_stack_padding_matches_jax_and_pads_add_nothing(forests):
    """Trees of different sizes plus a one-leaf tree: pad nodes have
    children -1, cat_boundaries pad with their last offset, the node
    arrays equal the JAX stack's, and the one-leaf tree adds its leaf 0
    to every row."""
    text, rows = forests["synthetic_cat"]
    port_trees = tlgb.Booster(model_str=text, device="cpu")._inner.models
    stub = Tree(1)
    stub.leaf_value[0] = 0.375
    port_trees = port_trees[:3] + [stub] + port_trees[3:6]
    jax_trees = [JaxTree.from_string(t.to_string()) for t in port_trees]
    forest = stack_trees(port_trees, CPU)
    ref = stack_trees_raw(jax_trees)
    for field, jax_field in (("split_feature", "split_feature"),
                             ("threshold", "threshold_real"),
                             ("left_child", "left_child"),
                             ("right_child", "right_child"),
                             ("cat_boundaries", "cat_boundaries"),
                             ("leaf_value", "leaf_value"),
                             ("num_leaves", "num_leaves")):
        np.testing.assert_array_equal(getattr(forest, field).numpy(),
                                      np.asarray(getattr(ref, jax_field)),
                                      err_msg=field)
    np.testing.assert_array_equal(
        forest.cat_bitset.numpy().view(np.uint32), np.asarray(ref.cat_bitset))
    decision = (np.asarray(ref.is_categorical).astype(np.uint8)
                | (np.asarray(ref.default_left).astype(np.uint8) << 1)
                | (np.asarray(ref.node_missing).astype(np.uint8) << 2))
    m = forest.decision.shape[1]
    real = np.arange(m)[None, :] < (forest.num_leaves.numpy()[:, None] - 1)
    np.testing.assert_array_equal(forest.decision.numpy()[real],
                                  decision[real])
    assert (forest.left_child.numpy()[~real] == -1).all()
    x = torch.from_numpy(rows)
    leaf = forest_leaf_walk_plain(forest, x).numpy()
    assert (leaf[:, 3] == 0).all()
    with_stub = forest_value_walk_plain(forest, x).numpy()
    without = forest_value_walk_plain(
        stack_trees(port_trees[:3] + port_trees[4:], CPU), x).numpy()
    np.testing.assert_allclose(with_stub - without, 0.375, atol=1e-6)


def _fake_nvcc(tmp_path, body):
    script = tmp_path / "nvcc"
    script.write_text("#!/bin/sh\n" + body)
    script.chmod(0o755)
    return str(script)


def test_build_failure_raises_with_nvcc_stderr(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_nvcc", lambda: _fake_nvcc(
        tmp_path, "echo 'forest_walk.cu(1): error: no sm_90a here' >&2\n"
        "exit 2\n"))
    with pytest.raises(tlgb.LightGBMError, match="no sm_90a here"):
        _build.build("forest")
    assert not (tmp_path / "build" / "libforest.so").exists()


def test_build_is_stamped_by_source_hash(tmp_path, monkeypatch):
    """A second build of the same source is skipped; an edited source is
    rebuilt. The fake compiler records its arguments."""
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "forest_walk.cu").write_text("// v1\n")
    monkeypatch.setattr(_build, "CSRC", csrc)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    log = tmp_path / "calls"
    monkeypatch.setattr(_build, "_nvcc", lambda: _fake_nvcc(
        tmp_path, 'echo "$@" >> %s\nwhile [ "$1" != "-o" ]; do shift; done\n'
        'touch "$2"\n' % log))
    first = _build.build("forest")
    assert first.compiled and first.path.exists()
    assert "arch=compute_90a,code=sm_90a" in log.read_text()
    assert not _build.build("forest").compiled
    (csrc / "forest_walk.cu").write_text("// v2\n")
    assert _build.build("forest").compiled
    assert len(log.read_text().splitlines()) == 2
