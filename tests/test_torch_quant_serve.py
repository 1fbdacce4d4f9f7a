"""Quantized serving layouts (tpu_predict_quantize=f16|int8) of
lightgbm_tpu_torch against the JAX package, on the CPU.

- `stack_trees_quant`: the per-feature grids, each numeric node's
  thr_code and lo, and the missing flags equal the JAX package's
  (`lightgbm_tpu.ops.predict.stack_trees_quant`), on a trained model
  with NaN-missing and categorical splits, one trained with
  zero_as_missing, and a synthetic forest that mixes every missing type;
- QC's plain version equals `quant_codes` exactly on rows built from the
  edge values: every grid bound and its nextafter neighbours, +-0,
  subnormals, +-inf and NaN, under every missing type;
- QW's and K1's f16 mode's plain versions equal `predict_forest_quant`
  and `predict_forest_f16` bitwise (the latter on rows without an
  infinite value: the JAX layout selects each node's value through a
  one-hot product, where inf * 0 makes every node's value NaN, while
  K1 walks on the value itself): the decisions are the same and both
  sides add the f16 leaves (rounded f64 -> f32 -> f16) in batches of 10
  trees, summed from 0 and then added (the order XLA gives
  `acc + vmap(one)(batch).sum(axis=0)`). QW and K1-f16 equal each other
  bitwise wherever the nodes of a feature share one missing type: on a
  trained model's every row, and on the synthetic forest's rows that
  hold no missing candidate (the fixed-point layout takes a feature's
  missing type from its first node, as the JAX package's does);
- `Booster.predict` with either layout equals the JAX package's, and the
  accuracy gate refuses, caches, re-judges and waits out
  `Predictor.warmup` as tests/test_quantize.py:198-305 has it; past 255
  thresholds a feature and for linear leaves the layouts are refused by
  name.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import lightgbm_tpu as jlgb
from lightgbm_tpu.ops import predict as jp
from lightgbm_tpu.serving.forest import _stacks_to_f16
import lightgbm_tpu_torch as tlgb
from lightgbm_tpu_torch.binning import MISSING_NONE
from lightgbm_tpu_torch.ops import predict as tp
from lightgbm_tpu_torch.testing.synth import (edge_case_rows,
                                              grid_edge_rows,
                                              synthetic_forest_text,
                                              synthetic_rows)
from lightgbm_tpu_torch.tree import Tree

torch.set_num_threads(1)
CPU = torch.device("cpu")
TOL = 0.01  # the default tpu_predict_quantize_tol (relative)


def _bits(a):
    return np.asarray(a, np.float32).view(np.int32)


def _trained_text(zero_as_missing=False):
    rng = np.random.RandomState(0)
    x = rng.randn(600, 8)
    x[:, 6] = rng.randint(0, 12, 600)
    x[rng.rand(600) < 0.1, 2] = 0.0 if zero_as_missing else np.nan
    y = (x[:, 0] + x[:, 2] + (x[:, 6] % 3 == 0) > 0.5).astype(float)
    params = {"objective": "binary", "verbose": -1, "num_leaves": 15,
              "min_data_in_leaf": 5, "zero_as_missing": zero_as_missing}
    booster = jlgb.train(params, jlgb.Dataset(
        x, y, categorical_feature=[6], params=dict(params)),
        num_boost_round=14, verbose_eval=False)
    return booster.model_to_string()


@pytest.fixture(scope="module")
def forests():
    """name -> (model text, JAX trees, port trees, rows, consistent):
    `consistent` says whether a feature's nodes share one missing type."""
    out = {}
    for name, text, nf, cats, consistent in (
            ("trained", _trained_text(), 8, 0, True),
            ("zero_missing", _trained_text(True), 8, 0, True),
            ("synthetic", synthetic_forest_text(3, 23, 31, 10), 10, 0,
             False),
            ("synthetic_cat", synthetic_forest_text(4, 16, 31, 10, 3), 10,
             3, False)):
        jt = jlgb.Booster(model_str=text)._inner.models
        tt = tlgb.Booster(model_str=text, device="cpu")._inner.models
        rows = np.concatenate([synthetic_rows(5, 150, nf, cats),
                               edge_case_rows(tt, nf, 6, 150, cats),
                               grid_edge_rows(tt, nf, 7, 200)])
        out[name] = (text, jt, tt, rows, consistent)
    return out


NAMES = ["trained", "zero_missing", "synthetic", "synthetic_cat"]


@pytest.mark.parametrize("name", NAMES)
def test_stack_trees_quant_fields_equal_jax(forests, name):
    _, jt, tt, _, _ = forests[name]
    ref = jp.stack_trees_quant(jt)
    got = tp.stack_trees_quant(tt, CPU)
    assert np.array_equal(np.asarray(ref.grid), got.grid.numpy())
    for ti, t in enumerate(tt):
        m = t.num_leaves - 1
        assert np.array_equal(np.asarray(ref.thr_code[ti, :m]),
                              got.thr_code[ti, :m].numpy()), ti
        assert np.array_equal(np.asarray(ref.lo[ti, :m]),
                              got.lo[ti, :m].numpy()), ti
    assert (ref.miss_nan is None) == (got.miss is None)
    if got.miss is not None:
        miss = got.miss.numpy()
        assert np.array_equal(np.asarray(ref.miss_nan), (miss & 1) != 0)
        assert np.array_equal(np.asarray(ref.miss_zero), (miss & 2) != 0)
    assert got.walk.leaf_value.dtype == torch.float16


def test_the_fixtures_cover_every_missing_type(forests):
    types = {name: {t.missing_type_node(i) for t in forests[name][2]
                    for i in range(t.num_leaves - 1)
                    if not t.is_categorical_node(i)} for name in NAMES}
    assert types["trained"] >= {2} and types["zero_missing"] >= {1}
    assert types["synthetic"] == {MISSING_NONE, 1, 2}
    assert any(t.is_categorical_node(i) for t in forests["trained"][2]
               for i in range(t.num_leaves - 1))


@pytest.mark.parametrize("name", NAMES)
def test_codes_equal_jax_on_edge_values(forests, name):
    _, jt, tt, rows, _ = forests[name]
    ref = np.asarray(jp.quant_codes(jp.stack_trees_quant(jt),
                                    jnp.asarray(rows))[0])
    qf = tp.stack_trees_quant(tt, CPU)
    got = tp.quant_codes_plain(qf, torch.from_numpy(rows))
    assert got.dtype == torch.int16
    assert np.array_equal(got.numpy().astype(np.float32), ref)
    assert got.min() >= -1 and got.max() <= 256
    before = tp.quant_codes.launches
    assert torch.equal(tp.quant_codes(qf, torch.from_numpy(rows)), got)
    assert tp.quant_codes.launches == before


@pytest.mark.parametrize("name", NAMES)
def test_quant_and_f16_walks_equal_jax_bitwise(forests, name):
    _, jt, tt, rows, consistent = forests[name]
    x = torch.from_numpy(rows)
    xj = jnp.asarray(rows)
    qf = tp.stack_trees_quant(tt, CPU)
    q = tp.forest_quant_walk_plain(qf, tp.quant_codes_plain(qf, x), x)
    ref_q = np.asarray(jp.predict_forest_quant(jp.stack_trees_quant(jt), xj))
    assert np.array_equal(_bits(q.numpy()), _bits(ref_q))
    f16 = tp.to_f16(tp.stack_trees(tt, CPU))
    h = tp.forest_value_walk_plain(f16, x)
    mf = _stacks_to_f16(jp.stack_trees_matmul(jt), None)[0]
    ref_h = np.asarray(jp.predict_forest_f16(mf, xj))
    # the JAX layout selects each node's value by a one-hot product, in
    # which an infinite value times 0 turns every node's value of the
    # row into NaN; K1's walk reads the value itself
    finite = ~np.isinf(rows).any(axis=1)
    assert finite.sum() > 300
    assert np.array_equal(_bits(h.numpy()[finite]), _bits(ref_h[finite]))
    # the two layouts against each other
    clean = ~(np.isnan(rows) | (np.abs(rows) <= 1e-35)).any(axis=1)
    rows_ok = np.ones(len(rows), bool) if consistent else clean
    assert rows_ok.sum() > 100
    assert np.array_equal(_bits(q.numpy()[rows_ok]),
                          _bits(h.numpy()[rows_ok]))
    # the wrappers on CPU tensors run the plain versions, uncounted
    before = (tp.forest_quant_walk.launches,
              tp.forest_value_walk_f16.launches)
    tr = tp.OutputTransform("sigmoid", bias=0.25)
    assert torch.equal(tp.forest_quant_walk(qf, tp.quant_codes(qf, x), x,
                                            tr),
                       tp.apply_output_plain(q, tr))
    assert torch.equal(tp.forest_value_walk_f16(f16, x),  h)
    assert (tp.forest_quant_walk.launches,
            tp.forest_value_walk_f16.launches) == before


def test_leaves_round_through_f32_to_f16(forests):
    _, _, tt, _, _ = forests["synthetic"]
    got = tp.to_f16(tp.stack_trees(tt, CPU)).leaf_value
    for ti, t in enumerate(tt):
        want = t.leaf_value.astype(np.float32).astype(np.float16)
        assert np.array_equal(got[ti, :t.num_leaves].numpy(), want)


def _clone(text, mode, **extra):
    return tlgb.Booster(model_str=text, device="cpu",
                        params=dict({"tpu_predict_quantize": mode}, **extra))


@pytest.mark.parametrize("mode", ["f16", "int8"])
def test_booster_quantized_predict_equals_jax(forests, mode):
    text, _, _, rows, _ = forests["trained"]
    if mode == "f16":   # see the module docstring: inf * 0 in the JAX layout
        rows = rows[~np.isinf(rows).any(axis=1)]
    jb = jlgb.Booster(model_str=text,
                      params={"tpu_predict_quantize": mode})
    tb = _clone(text, mode)
    ref = jb.predict(rows, raw_score=True)
    got = tb.predict(rows, raw_score=True)
    assert np.array_equal(_bits(got), _bits(ref))
    assert np.abs(tb.predict(rows) - jb.predict(rows)).max() <= 1e-6
    f32 = tlgb.Booster(model_str=text, device="cpu").predict(rows,
                                                             raw_score=True)
    scale = max(1.0, float(np.abs(f32).max()))
    assert np.abs(got - f32).max() / scale <= TOL
    key = ("value", tb.num_trees(), 1, mode)
    delta = tb._inner._compiled_forest.gate_delta(key)
    assert delta is not None and 0 <= delta <= TOL


def test_pred_early_stop_ignores_quantize(forests):
    text, _, _, rows, _ = forests["trained"]
    kw = {"pred_early_stop": True, "pred_early_stop_freq": 2,
          "pred_early_stop_margin": 0.0, "raw_score": True}
    ref = tlgb.Booster(model_str=text, device="cpu").predict(rows, **kw)
    for mode in ("f16", "int8"):
        assert np.array_equal(_clone(text, mode).predict(rows, **kw), ref)


def test_gate_refuses_below_measured_delta(forests):
    text, _, _, rows, _ = forests["trained"]
    for mode in ("f16", "int8"):
        q = _clone(text, mode, tpu_predict_quantize_tol=1e-12)
        with pytest.raises(tlgb.LightGBMError, match="refused"):
            q.predict(rows[:50])


def test_gate_delta_cached_and_rejudged_per_tolerance(forests):
    text, _, _, rows, _ = forests["trained"]
    q = _clone(text, "f16")
    q.predict(rows[:50])
    cache = q._inner._compiled_forest
    key = ("value", q.num_trees(), 1, "f16")
    delta = cache.gate_delta(key)
    assert delta is not None and 0 < delta <= TOL
    restacks = cache.stats["restacks"]
    q._inner.config.io.tpu_predict_quantize_tol = min(delta / 2, 1e-12)
    with pytest.raises(tlgb.LightGBMError, match="refused"):
        q.predict(rows[:50])
    assert cache.gate_delta(key) == delta
    assert cache.stats["restacks"] == restacks


def test_f32_and_quantized_stacks_coexist(forests):
    text, _, _, rows, _ = forests["trained"]
    b = tlgb.Booster(model_str=text, device="cpu")
    inner = b._inner
    stats = inner._compiled_forest.stats
    b.predict(rows[:20])
    r0 = stats["restacks"]
    inner.config.io.tpu_predict_quantize = "f16"
    b.predict(rows[:20])
    assert stats["restacks"] == r0 + 1
    inner.config.io.tpu_predict_quantize = "int8"
    b.predict(rows[:20])
    assert stats["restacks"] == r0 + 2
    inner.config.io.tpu_predict_quantize = "none"
    b.predict(rows[:20])
    inner.config.io.tpu_predict_quantize = "f16"
    b.predict(rows[:20])
    assert stats["restacks"] == r0 + 2
    assert stats["bytes"] > 0


def test_int8_refuses_overflowing_code_space():
    trees = []
    for i in range(260):
        t = Tree(2)
        t.split_feature = np.asarray([0], np.int32)
        t.threshold = np.asarray([i * 0.5], np.float64)
        t.decision_type = np.zeros(1, np.int8)
        t.left_child = np.asarray([-1], np.int32)
        t.right_child = np.asarray([-2], np.int32)
        t.leaf_value = np.asarray([0.1, -0.1], np.float64)
        trees.append(t)
    with pytest.raises(tp.QuantRefused, match="distinct"):
        tp.stack_trees_quant(trees, CPU)
    tp.stack_trees_quant(trees[:255], CPU)


def test_gate_defers_past_warmup(forests):
    text, _, _, rows, _ = forests["trained"]
    q = _clone(text, "f16", tpu_predict_quantize_tol=1e-12)
    pred = q.serving_predictor(raw_score=True)
    pred.warmup()
    key = ("value", q.num_trees(), 1, "f16")
    assert q._inner._compiled_forest.gate_delta(key) is None
    with pytest.raises(tlgb.LightGBMError, match="refused"):
        pred.predict(rows[:50])
    assert pred.stats()["quantize"] == "f16"
    pred.close()


@pytest.mark.parametrize("mode", ["f16", "int8"])
def test_linear_forests_are_refused_by_name(mode):
    rng = np.random.RandomState(3)
    x = rng.randn(300, 4)
    y = x[:, 0] + 0.5 * x[:, 1]
    params = {"objective": "regression", "linear_tree": True,
              "num_leaves": 7, "verbose": -1}
    jb = jlgb.train(params, jlgb.Dataset(x, y), 3, verbose_eval=False)
    tb = _clone(jb.model_to_string(), mode)
    with pytest.raises(tlgb.LightGBMError,
                       match="tpu_predict_quantize=%s refused for this "
                             "model: linear_tree leaf coefficients have "
                             "no %s layout" % (mode, mode)):
        tb.predict(x[:8])
    with pytest.raises(tp.QuantRefused, match="linear_tree"):
        tp.stack_trees_quant(tb._inner.models, CPU)
