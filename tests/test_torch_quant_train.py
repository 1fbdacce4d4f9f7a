"""Quantized-gradient and bagged training of lightgbm_tpu_torch against
lightgbm_tpu.train.

Both packages train on the same seeded numpy data on the CPU (the port
with `device="cpu"`, its kernels' plain versions), the JAX package with
`tpu_hist_bf16=false` so that its gate's f32 tree sums in f32 as the
port's does. The port draws JAX's threefry stream (ops/rng.py), so its
bag masks and rounding codes are JAX's, and its int32 histograms equal
JAX's exactly. Tolerances: the same tree structure every round (split
features, bin thresholds, decision types, children, leaf counts), every
recorded metric within 2e-3, the same best_iteration under early
stopping, the quantize gate's delta within 1e-5 relative of the JAX
one, and leaf values and raw predictions within TOL[run] * max(1,
|ref|):

- 1e-5 where the two packages' leaves stay within f32 round-off. The
  int8 regression run's leaves equal the JAX package's bitwise in all
  30 trees: its codes are JAX's every round, the quantized split scan
  adds the dequantized bins in XLA's cumsum order (ops/split.py
  xla_cumsum) and the score update is the fused multiply-add of JAX's
  grow-and-update program (ops/route.py fma_f32). The int8 binary run
  takes its gradients through XLA's exp (objectives.xla_exp_f32, bitwise
  jnp.exp), and its leaves stay within 2.1e-6 of the JAX package's over
  its 20 trees (it was 2.6e-4 with torch's exp, which left 1,688 of
  3,000 gradients an ulp apart by iteration 28);
- 1e-4 for f32 with bagging: both packages take a child's totals as
  its parent's minus its sibling's, from split scans (in XLA's cumsum
  order on both sides) of f32 bins whose rows sum in different orders
  (the port's fixed lane and tile trees, the JAX package's one-hot
  contraction over row chunks), and in leaves of a small hessian the
  cancellation lifts that round-off to 1.4e-5
  (measured, tree 3 of the bagged run; predictions 1.0e-5).

tests/quant_parity_report.py prints these numbers.
"""
import numpy as np
import pytest
import torch

import lightgbm_tpu as jlgb
import lightgbm_tpu.telemetry as jtelemetry
import lightgbm_tpu_torch as tlgb
from lightgbm_tpu_torch import LightGBMError
from lightgbm_tpu_torch.ops import histogram, rng

torch.set_num_threads(1)

BASE = {"num_leaves": 15, "max_bin": 63, "learning_rate": 0.3,
        "min_data_in_leaf": 10, "min_sum_hessian_in_leaf": 1.0,
        "verbose": -1, "tpu_hist_bf16": False}


def make(seed, n):
    r = np.random.RandomState(seed)
    x = r.randn(n, 7)
    x[r.rand(n) < 0.1, 2] = np.nan
    x[r.rand(n) < 0.3, 3] = 0.0
    f = (x[:, 0] + 0.8 * np.nan_to_num(x[:, 2]) - 0.5 * x[:, 3] * x[:, 4]
         + np.sin(2 * x[:, 1]))
    return x, f + 0.8 * r.randn(n)


X, F = make(0, 3000)
XV, FV = make(1, 1000)
LABELS = {"binary": ((F > 0).astype(float), (FV > 0).astype(float)),
          "regression": (F, FV)}
BINARY = {"objective": "binary", "metric": "auc,binary_logloss"}
REGRESSION = {"objective": "regression", "metric": "l2"}
BAG = {"bagging_fraction": 0.7, "bagging_freq": 2, "bagging_seed": 5}
# name: (params, rounds, early_stopping_rounds)
RUNS = {
    "binary_int8": (dict(BINARY, tpu_hist_quantize="int8"), 30, 3),
    "binary_int16": (dict(BINARY, tpu_hist_quantize="int16"), 12, None),
    "regression_int8": (dict(REGRESSION, tpu_hist_quantize="int8"), 30, 3),
    "binary_f32_bagging": (dict(BINARY, **BAG), 12, None),
    "binary_int8_bagging": (dict(BINARY, tpu_hist_quantize="int8",
                                 bagging_fraction=0.8, bagging_freq=1),
                            12, None),
    "regression_int16_bagging": (dict(REGRESSION, tpu_hist_quantize="int16",
                                      **BAG), 12, None),
}
TOL = {"binary_int8": 1e-5, "binary_int16": 1e-5, "regression_int8": 1e-5,
       "binary_f32_bagging": 1e-4, "binary_int8_bagging": 1e-5,
       "regression_int16_bagging": 1e-5}


def train_with(pkg, name, **kw):
    params, rounds, esr = RUNS[name]
    y, yv = LABELS[params["objective"]]
    ds = pkg.Dataset(X, y)
    evals = {}
    booster = pkg.train(dict(BASE, **params), ds, rounds,
                        valid_sets=[ds.create_valid(XV, yv)],
                        valid_names=["valid"], early_stopping_rounds=esr,
                        evals_result=evals, verbose_eval=False, **kw)
    return booster, evals


@pytest.fixture(scope="module")
def pairs():
    out = {}
    gauges = []
    real = jtelemetry.gauge_set
    jtelemetry.gauge_set = lambda name, value, labels=None: (
        gauges.append(value) if name == "train/hist_quantize_gate_delta"
        else real(name, value, labels))
    try:
        for name in RUNS:
            del gauges[:]
            jax_run = train_with(jlgb, name)
            jax_delta = gauges[0] if gauges else None
            out[name] = (jax_run, train_with(tlgb, name, device="cpu"),
                         jax_delta)
    finally:
        jtelemetry.gauge_set = real
    return out


@pytest.mark.parametrize("name", sorted(RUNS))
def test_same_trees_leaves_and_predictions(pairs, name):
    ((jb, _), (tb, _), _) = pairs[name]
    tol = TOL[name]
    jt, tt = jb._inner.models, tb._inner.models
    assert len(jt) == len(tt) > 0
    for i, (a, b) in enumerate(zip(jt, tt)):
        assert a.num_leaves == b.num_leaves, i
        m = a.num_leaves - 1
        for k in ("split_feature", "threshold_in_bin", "decision_type",
                  "left_child", "right_child"):
            assert np.array_equal(getattr(a, k)[:m], getattr(b, k)[:m]), \
                (i, k)
        assert np.array_equal(a.leaf_count, b.leaf_count), i
        assert np.all(np.abs(b.leaf_value - a.leaf_value)
                      <= tol * np.maximum(1.0, np.abs(a.leaf_value))), i
    ref = jb.predict(XV, raw_score=True)
    got = tb.predict(XV, raw_score=True)
    assert np.all(np.abs(got - ref) <= tol * np.maximum(1.0, np.abs(ref)))


@pytest.mark.parametrize("name", sorted(RUNS))
def test_metrics_and_best_iteration(pairs, name):
    ((jb, jev), (tb, tev), _) = pairs[name]
    assert sorted(jev["valid"]) == sorted(tev["valid"])
    for metric, series in jev["valid"].items():
        assert len(series) == len(tev["valid"][metric])
        assert np.all(np.abs(np.asarray(series)
                             - np.asarray(tev["valid"][metric])) <= 2e-3)
    assert tb.best_iteration == jb.best_iteration
    if RUNS[name][2]:
        assert 0 < tb.best_iteration < RUNS[name][1], "did not stop early"


@pytest.mark.parametrize("name", sorted(n for n in RUNS if "int" in n))
def test_the_gate_delta_is_the_jax_one(pairs, name):
    (_, (tb, _), jax_delta) = pairs[name]
    assert jax_delta is not None
    got = tb._inner.quant_gate_delta
    assert abs(got - jax_delta) <= 1e-5 * max(1.0, abs(jax_delta))
    assert got <= BASE.get("tpu_hist_quantize_tol", 0.5)


def test_the_quantized_runs_use_the_jax_qmax(pairs):
    for name in ("binary_int8", "binary_int16"):
        tb = pairs[name][1][0]
        mode = RUNS[name][0]["tpu_hist_quantize"]
        assert tb._inner._quant_qmax == histogram.train_qmax(mode, len(X))
        assert tb._inner._grower.cfg.hist_quantize == mode
    assert pairs["regression_int8"][1][0]._inner._quant_hess_const
    assert not pairs["binary_int8"][1][0]._inner._quant_hess_const


def test_an_overtight_gate_refuses_by_name():
    """The fixture of tests/test_quant_train.py's gate test: regression
    gradients are continuous at iteration 0, so int8 codes carry rounding
    noise above tpu_hist_quantize_tol=1e-12."""
    r = np.random.RandomState(3)
    x = np.asarray(r.randn(900, 10), np.float32)
    yr = (x[:, 0] + 0.25 * x[:, 2]).astype(np.float32)
    params = dict(objective="regression", num_leaves=15, max_bin=63,
                  verbosity=-1, min_data_in_leaf=5, learning_rate=0.15,
                  seed=7, tpu_hist_quantize="int8",
                  tpu_hist_quantize_tol=1e-12)
    with pytest.raises(jlgb.basic.LightGBMError,
                       match="tpu_hist_quantize_tol"):
        jlgb.train(dict(params), jlgb.Dataset(x, yr), num_boost_round=2)
    with pytest.raises(LightGBMError, match="tpu_hist_quantize_tol"):
        tlgb.train(dict(params), tlgb.Dataset(x, yr), num_boost_round=2,
                   device="cpu")


def test_the_gate_calibrates_on_the_leading_chunk():
    """tpu_hist_chunk sizes the calibration slice, as in the JAX package
    (900 rows: a 1,024-row chunk covers them all; 256 rows of 512)."""
    y, _ = LABELS["binary"]
    for chunk, n, rows in ((65536, 900, 900), (512, 3000, 512)):
        b = tlgb.Booster(dict(BASE, **BINARY, tpu_hist_quantize="int8",
                              tpu_hist_chunk=chunk),
                         train_set=tlgb.Dataset(X[:n], y[:n]), device="cpu")
        assert min(b._inner._n, b._inner._chunk) == rows


def test_two_runs_are_byte_identical():
    a = train_with(tlgb, "binary_int8_bagging", device="cpu")[0]
    b = train_with(tlgb, "binary_int8_bagging", device="cpu")[0]
    assert a.model_to_string() == b.model_to_string()


def test_bagging_freq_0_is_no_bagging():
    y, _ = LABELS["binary"]
    p = dict(BASE, objective="binary")
    plain = tlgb.train(p, tlgb.Dataset(X[:1500], y[:1500]), 4,
                       device="cpu")
    off = tlgb.train(dict(p, bagging_fraction=0.5, bagging_freq=0),
                     tlgb.Dataset(X[:1500], y[:1500]), 4, device="cpu")
    assert off.model_to_string() == plain.model_to_string()
    on = tlgb.train(dict(p, bagging_fraction=0.5, bagging_freq=1),
                    tlgb.Dataset(X[:1500], y[:1500]), 4, device="cpu")
    assert on.model_to_string() != plain.model_to_string()


def test_the_bag_is_redrawn_every_bagging_freq_iterations():
    y, _ = LABELS["binary"]
    b = tlgb.Booster(dict(BASE, objective="binary", **BAG),
                     train_set=tlgb.Dataset(X, y), device="cpu")
    masks = []
    for it in range(5):
        masks.append(b._inner._bagging_weights(it).clone())
    seed, freq = BAG["bagging_seed"], BAG["bagging_freq"]
    for it, m in enumerate(masks):
        ref = rng.bagging_mask_plain(rng.fold_in(rng.prng_key(seed),
                                                 it // freq),
                                     BAG["bagging_fraction"],
                                     torch.empty(len(X)))
        assert torch.equal(m, ref), it
    assert torch.equal(masks[0], masks[1])
    assert not torch.equal(masks[1], masks[2])


@pytest.mark.parametrize("extra", [{}, {"tpu_hist_quantize": "int8"}])
def test_classifier_subsample_is_bagging(extra):
    y = (F > 0).astype(int)
    kw = {"n_estimators": 4, "num_leaves": 7, "learning_rate": 0.2,
          "min_child_samples": 5, "max_bin": 31, "device": "cpu"}
    est = tlgb.LGBMClassifier(subsample=0.8, subsample_freq=1, **kw,
                              **extra).fit(X, y)
    params = dict({"objective": "binary", "num_leaves": 7,
                   "learning_rate": 0.2, "min_data_in_leaf": 5,
                   "min_sum_hessian_in_leaf": 1e-3, "max_bin": 31,
                   "verbose": -1, "bagging_fraction": 0.8,
                   "bagging_freq": 1}, **extra)
    ref = tlgb.train(params, tlgb.Dataset(X, y, params=dict(params)), 4,
                     verbose_eval=False, device="cpu")
    assert est.booster_.model_to_string() == ref.model_to_string()
    unbagged = tlgb.LGBMClassifier(**kw, **extra).fit(X, y)
    assert unbagged.booster_.model_to_string() != ref.model_to_string()


def test_lambdarank_trains_quantized_and_bagged():
    """Lambdarank goes through the same path; its gradients differ from
    the JAX package's by reassociation, so it is held to training, not
    tree for tree."""
    sizes = [50] * 40
    y = np.clip(np.rint(F[:2000] + 1.5), 0, 4)
    ds = tlgb.Dataset(X[:2000], y, group=sizes)
    valid = ds.create_valid(XV[:500], np.clip(np.rint(FV[:500] + 1.5), 0,
                                               4), group=[50] * 10)
    evals = {}
    tlgb.train(dict(BASE, objective="lambdarank", metric="ndcg",
                    ndcg_eval_at=[5], tpu_hist_quantize="int16",
                    bagging_fraction=0.8, bagging_freq=1), ds, 6,
               valid_sets=[valid], evals_result=evals, verbose_eval=False,
               device="cpu")
    ndcg = evals["valid_0"]["ndcg@5"]
    assert len(ndcg) == 6 and np.all(np.isfinite(ndcg))
    assert ndcg[-1] > ndcg[0]
