"""Categorical features in the port against the JAX package, on the CPU.

The fixture is bench.py's Expo shape (`testing.synth.synth_expo`, 8
categorical columns of 12-96 categories and 32 numerics) at 3,000
training and 1,000 valid rows, with two more categorical columns: a copy
of column 1 with 1% of its rows at category -1 (a negative category,
read as missing with a warning) and one of 60 common categories and 60
rare ones, the rarest past the 99% cut (max_bin 63 keeps them out).

Held here:
- `synth_expo` bitwise bench.py's;
- the bin mappers (`bin_2_categorical`, `categorical_2_bin`,
  `default_bin`, `missing_type`, `num_bin`), the EFB groups, the binned
  matrix and `feature_meta_arrays` equal the JAX package's, the negative
  category warned about in both;
- S's plain version on categorical histograms choosing the JAX split
  finder's split wherever the top two gains are further apart than the
  f32 tolerance of tests/test_torch_split.py;
- R's and W's plain versions bitwise the JAX routing (each node of the
  JAX trees, through `predict_leaf_binned`) and `predict_value_binned`;
- `train` for 5 rounds with tpu_hist_bf16 true and false: the same
  trees, every line of the model text that is not an f32 sum (the
  categorical bitsets in category and bin space among them) byte for
  byte the JAX package's, the sums (leaf and internal values and
  weights) within 1e-5 * max(1, |ref|), the split gains within 1e-4 *
  max(1, |ref|) (a gain squares a sum of gradients that cancels, which
  lifts the sums' last-bit differences to 1.2e-5 of it at tree 1, node
  4), raw predictions within 1e-5 * max(1, |ref|). The f32 histograms add their bins in
  another order than the JAX package's one-hot contraction (ROADMAP
  queue C), so their last bits differ; quantized training, whose int32
  histograms equal the JAX package's bitwise, gives the JAX package's
  model text byte for byte (int8 regression);
- every form of `categorical_column` (an index string, a `name:` list,
  an int, a list of indices or names, the constructor's
  `categorical_feature`), an unmatched name warned about and ignored as
  the JAX package does, `Dataset(path)` with `categorical_column`, and
  the estimators' `fit(..., categorical_feature=)`;
- `pred_leaf`, `pred_contrib`, `dump_model` and a continued run on a
  categorical model equal to the JAX package's.
"""
import json

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import bench
import lightgbm_tpu as jlgb
import lightgbm_tpu_torch as tlgb
from lightgbm_tpu import log as jlog
from lightgbm_tpu.dataset import Dataset as JaxDataset
from lightgbm_tpu.learner import grow as jgrow
from lightgbm_tpu.ops import histogram as jh
from lightgbm_tpu.ops import predict as jpredict
from lightgbm_tpu.ops import split as jsplit
from lightgbm_tpu_torch import log as tlog
from lightgbm_tpu_torch.binning import BIN_CATEGORICAL
from lightgbm_tpu_torch.dataset import Dataset as TorchDataset
from lightgbm_tpu_torch.ops.predict import (binned_tree,
                                            tree_leaf_walk_binned,
                                            tree_value_walk_binned)
from lightgbm_tpu_torch.ops.route import SplitRule, route_partition
from lightgbm_tpu_torch.ops.split import (FMETA_KEYS, SplitParams,
                                          device_fmeta, split_scan,
                                          split_scan_plain)
from lightgbm_tpu_torch.testing.synth import synth_expo

torch.set_num_threads(1)
CPU = torch.device("cpu")
ROWS, VALID_ROWS, ROUNDS = 3000, 1000, 5
PARAMS = {"objective": "binary", "metric": "auc", "max_bin": 63,
          "num_leaves": 7, "learning_rate": 0.2, "min_data_in_leaf": 5,
          "min_sum_hessian_in_leaf": 1.0, "verbose": -1}
# model text lines that hold f32 sums of the histograms
SUM_KEYS = ("split_gain", "leaf_value", "leaf_weight", "internal_value",
            "internal_weight")


def expo(n, seed):
    """synth_expo plus a negative-category column (40) and a column (41)
    whose rarest categories fall past the 99% cut."""
    x, y, cats = synth_expo(n, seed=seed)
    rng = np.random.RandomState(seed + 100)
    neg = x[:, 1].copy()
    neg[rng.rand(n) < 0.01] = -1.0
    tail = rng.randint(0, 60, n).astype(np.float32)
    rare = rng.rand(n) < 0.02
    tail[rare] = 60 + rng.randint(0, 60, int(rare.sum()))
    return np.column_stack([x, neg, tail]), y, cats + [40, 41]


X, Y, CATS = expo(ROWS + VALID_ROWS, 13)
X, XV, Y, YV = X[:ROWS], X[ROWS:], Y[:ROWS], Y[ROWS:]
CAT_PARAMS = dict(PARAMS, categorical_feature=CATS)


@pytest.mark.parametrize("n,seed", [(500, 3), (4000, 13)])
def test_synth_expo_is_bench_synth_expo_bitwise(n, seed):
    got, ref = synth_expo(n, seed=seed), bench.synth_expo(n, seed=seed)
    assert got[0].dtype == ref[0].dtype and got[1].dtype == ref[1].dtype
    assert np.array_equal(got[0].view(np.int32), ref[0].view(np.int32))
    assert np.array_equal(got[1], ref[1]) and got[2] == ref[2]


def _warnings(logmod, build):
    lines = []
    logmod.register_callback(lines.append)
    level = logmod.get_level()
    logmod.set_level(logmod.WARNING)
    try:
        out = build()
    finally:
        logmod.set_level(level)
        logmod.register_callback(None)
    return out, "".join(lines)


def test_bin_mappers_groups_and_feature_meta_equal_the_jax_package():
    jds, jwarn = _warnings(jlog, lambda: JaxDataset.from_numpy(
        X, Y, max_bin=63, categorical_features=CATS))
    tds, twarn = _warnings(tlog, lambda: TorchDataset.from_numpy(
        X, Y, max_bin=63, categorical_features=CATS))
    assert "Met negative value in categorical features" in jwarn
    assert "Met negative value in categorical features" in twarn
    assert len(jds.mappers) == len(tds.mappers) == X.shape[1]
    for j, (a, b) in enumerate(zip(jds.mappers, tds.mappers)):
        for k in ("bin_type", "num_bin", "missing_type", "default_bin",
                  "is_trivial", "bin_2_categorical", "categorical_2_bin",
                  "sparse_rate", "min_val", "max_val"):
            assert getattr(a, k) == getattr(b, k), (j, k)
        assert (b.bin_type == BIN_CATEGORICAL) == (j in CATS), j
    neg, tail = tds.mappers[40], tds.mappers[41]
    assert -1 not in neg.bin_2_categorical and neg.missing_type == 2
    present = set(np.unique(X[:, 41]).astype(int))
    dropped = present - set(tail.bin_2_categorical)
    assert tail.num_bin > 63 and len(dropped) > 0 and min(dropped) >= 60
    assert tds.used_features == jds.used_features
    assert [list(g) for g in tds.groups.groups] == \
        [list(g) for g in jds.groups.groups]
    assert np.array_equal(tds.groups.group_num_bin, jds.groups.group_num_bin)
    assert tds.binned.dtype == jds.binned.dtype
    assert np.array_equal(tds.binned, jds.binned)
    jf, tf = jds.feature_meta_arrays(), tds.feature_meta_arrays()
    assert sorted(jf) == sorted(tf)
    for k in jf:
        assert np.array_equal(np.asarray(jf[k]), np.asarray(tf[k])), k
    assert int(np.sum(tf["is_categorical"])) == len(CATS)


def _jax_pick(hist, tot, fm, cfg):
    gp = jgrow.GrowParams.from_config(cfg)
    fmeta = {k: jnp.asarray(fm[k]) for k in FMETA_KEYS}
    mask = jnp.ones(len(fm["num_bin"]), bool)
    vals = jgrow._leaf_best_split(
        jnp.asarray(hist), jnp.float32(tot[0]), jnp.float32(tot[1]),
        jnp.float32(tot[2]), jnp.int32(0), mask, fmeta, cfg, gp)
    fh = jgrow._extract_feature_hist(jnp.asarray(hist), tot[0], tot[1],
                                     tot[2], fmeta, cfg)
    res = jsplit.find_best_splits(
        fh, jnp.float32(tot[0]), jnp.float32(tot[1]), jnp.float32(tot[2]),
        fmeta["num_bin"], fmeta["missing_type"], fmeta["default_bin"],
        fmeta["is_categorical"], lambda_l1=cfg.lambda_l1,
        lambda_l2=cfg.lambda_l2, min_gain_to_split=cfg.min_gain_to_split,
        min_data_in_leaf=cfg.min_data_in_leaf,
        min_sum_hessian_in_leaf=cfg.min_sum_hessian_in_leaf)
    return [np.asarray(v) for v in vals], np.asarray(res.gain)


@pytest.fixture(scope="module")
def dataset():
    return JaxDataset.from_numpy(X, Y, max_bin=63, categorical_features=CATS)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_split_scan_picks_the_jax_split_on_categorical_histograms(dataset,
                                                                   seed):
    ds = dataset
    rng = np.random.RandomState(seed)
    n = ds.binned.shape[0]
    # gradients that favour categories of the categorical columns
    grad = (rng.randn(n) + np.sin(X[:, 0] * 1.7) + (X[:, 3] % 5 == 0)
            ).astype(np.float32)
    hess = (rng.rand(n) * 0.5 + 0.25).astype(np.float32)
    sel = np.ones(n, bool) if seed == 0 else rng.rand(n) < 0.3 * seed
    w3 = np.stack([grad, hess, np.ones(n, np.float32)], 1) * sel[:, None]
    fm = ds.feature_meta_arrays()
    nb = int(ds.num_bins_per_feature().max())
    B = ds.max_num_bin()
    cfg = jgrow.GrowerConfig(
        num_leaves=8, max_bins=B, chunk=1000, lambda_l1=0.0, lambda_l2=0.0,
        min_gain_to_split=0.0, min_data_in_leaf=5,
        min_sum_hessian_in_leaf=1e-3, max_depth=-1, feature_bins=nb)
    params = SplitParams(0.0, 0.0, 0.0, 5, 1e-3, -1)
    hist = np.array(jh.leaf_histogram(jnp.asarray(ds.binned),
                                      jnp.asarray(w3), B, 1000, bf16=False))
    tot = hist[0].sum(axis=0).astype(np.float32)
    jv, jgain = _jax_pick(hist, tot, fm, cfg)
    args = (torch.from_numpy(tot)[None], torch.zeros(1, dtype=torch.int32),
            device_fmeta(fm, CPU),
            torch.ones(ds.num_features, dtype=torch.uint8), params, nb)
    out_f, out_i, fgain = split_scan(torch.tensor(hist)[None], *args)
    oracle = split_scan_plain(torch.tensor(hist, dtype=torch.float64)[None],
                              args[0].double(), *args[1:])[2][0].numpy()
    fgain = fgain[0].numpy()
    cat = np.asarray(fm["is_categorical"], bool)
    assert np.isfinite(jgain[cat]).any()
    assert np.array_equal(np.isfinite(fgain), np.isfinite(jgain))
    fin = np.isfinite(jgain)
    parent = float(tot[0]) ** 2 / (float(tot[1]) + 2e-15)
    jerr = np.zeros_like(oracle)
    jerr[fin] = np.abs(jgain[fin] - oracle[fin])
    tol = jerr + 1e-5 * np.maximum(1.0, np.abs(oracle) + parent)
    assert np.all(np.abs(fgain[fin] - oracle[fin]) <= jerr[fin] + tol[fin])
    order = np.sort(jgain[fin])[::-1]
    if order[0] - order[1] > 2 * tol[fin].max():
        assert out_i[0, 0].item() == int(jv[1])
        assert out_i[0, 1].item() == int(jv[2])
        assert bool(out_i[0, 2].item()) == bool(jv[3])
        assert bool(out_i[0, 3].item()) == bool(jv[4])
        ref = np.array([jv[5], jv[6], jv[7]], np.float64)
        got = out_f[0, 1:].numpy().astype(np.float64)
        assert np.all(np.abs(got - ref) <= 1e-5 * np.maximum(1.0,
                                                             np.abs(ref)))


_trained = {}


def trained(key):
    """(JAX booster, port booster, port Dataset) of one training run on
    the fixture, made once: "hi_lo" (the default tpu_hist_bf16), "f32"
    and "int8" regression."""
    if key not in _trained:
        params, y = dict(CAT_PARAMS), Y
        if key == "f32":
            params["tpu_hist_bf16"] = False
        elif key == "int8":
            params.update(objective="regression", metric="l2",
                          tpu_hist_quantize=key)
            y = Y + 0.3 * X[:, 9]
        jb = jlgb.train(dict(params), jlgb.Dataset(X, y, params=dict(
            params)), ROUNDS, verbose_eval=False)
        tds = tlgb.Dataset(X, y, params=dict(params))
        tb = tlgb.train(dict(params), tds, ROUNDS, device="cpu")
        _trained[key] = (jb, tb, tds)
    return _trained[key]


def subtree_leaves(tree, node):
    out, stack = [], [node]
    while stack:
        k = stack.pop()
        if k < 0:
            out.append(~k)
        else:
            stack += [tree.left_child[k], tree.right_child[k]]
    return out


def test_route_and_walk_on_categorical_nodes_equal_the_jax_routing():
    jb, tb, tds = trained("hi_lo")
    inner = tds._lazy_init()
    binned = torch.from_numpy(inner.binned)
    n = binned.shape[0]
    fm = inner.feature_meta_arrays()
    routed = 0
    for jt, tt in zip(jb._inner.models, tb._inner.models):
        jleaf = np.asarray(jpredict.predict_leaf_binned(
            jt.to_device(), jnp.asarray(inner.binned)))
        bt = binned_tree(tt, CPU)
        assert np.array_equal(tree_leaf_walk_binned(bt, binned).numpy(),
                              jleaf)
        score = torch.zeros(n)
        tree_value_walk_binned(binned_tree(tt, CPU, jt.leaf_value), binned,
                               score)
        jval = np.asarray(jpredict.predict_value_binned(
            jt.to_device(), jnp.asarray(inner.binned)))
        assert np.array_equal(score.numpy(), jval)
        for k in range(tt.num_leaves - 1):
            if not tt.is_categorical_node(k):
                continue
            # one-vs-rest: the node's bin-space bitset holds one bin
            c = int(tt.threshold_in_bin[k])
            lo, hi = tt.cat_boundaries_inner[c], tt.cat_boundaries_inner[
                c + 1]
            bits = np.flatnonzero(np.unpackbits(
                tt.cat_threshold_inner[lo:hi].astype("<u4").view(np.uint8),
                bitorder="little"))
            assert len(bits) == 1
            at = np.flatnonzero(np.isin(jleaf, subtree_leaves(jt, k)))
            left = np.isin(jleaf, subtree_leaves(jt, jt.left_child[k]))
            f = int(tt.split_feature_inner[k])
            rule = SplitRule(
                group=int(fm["group"][f]), offset=int(fm["offset"][f]),
                num_bin=int(fm["num_bin"][f]),
                default_bin=int(fm["default_bin"][f]),
                missing_type=int(fm["missing_type"][f]),
                bundled=bool(fm["is_bundled"][f]), threshold=int(bits[0]),
                default_left=bool(tt.default_left_node(k)), is_cat=True,
                left_slot=1, right_slot=2)
            perm = torch.arange(n, dtype=torch.int32)
            perm[:len(at)] = torch.from_numpy(at.astype(np.int32))
            leaf_id = torch.zeros(n, dtype=torch.int32)
            n_left = int(route_partition(binned, perm, 0, len(at), rule,
                                         leaf_id))
            assert n_left == int(left[at].sum())
            assert np.array_equal(np.sort(perm[:n_left].numpy()),
                                  at[left[at]])
            assert np.array_equal(leaf_id[at].numpy(),
                                  np.where(left[at], 1, 2))
            routed += 1
    assert routed > 0


def _blocks(text):
    """Model text as its lines outside the trees and, per tree, its
    key -> value lines."""
    rest, trees = [], []
    for line in text.splitlines():
        if line.startswith("Tree="):
            trees.append({})
        if trees and "=" in line and not line.startswith("end of trees"):
            key, value = line.split("=", 1)
            trees[-1][key] = value
        else:
            rest.append(line)
    return rest, trees


def _floats(value):
    return np.array(value.split(), np.float64)


@pytest.mark.parametrize("key", ["hi_lo", "f32"])
def test_training_grows_the_jax_trees_and_model_text(key):
    jb, tb, _ = trained(key)
    assert tb._inner._grower.cfg.hist_bf16 is (key == "hi_lo")
    (jrest, jtrees), (trest, ttrees) = _blocks(jb.model_to_string()), \
        _blocks(tb.model_to_string())
    assert trest == jrest and len(ttrees) == len(jtrees) == ROUNDS
    cat_nodes = 0
    for jt, tt in zip(jtrees, ttrees):
        assert sorted(jt) == sorted(tt)
        for k in jt:
            if k not in SUM_KEYS:
                assert tt[k] == jt[k], k
                continue
            ref, got = _floats(jt[k]), _floats(tt[k])
            # a gain squares an f32 sum of g that cancels: its last bits
            # lift to 1.2e-5 of the gain (tree 1, node 4 with tpu_hist_bf16)
            tol = 1e-4 if k == "split_gain" else 1e-5
            assert np.all(np.abs(got - ref)
                          <= tol * np.maximum(1.0, np.abs(ref))), k
        cat_nodes += int(jt["num_cat"])
    assert cat_nodes > 0
    ref = jb.predict(XV, raw_score=True)
    got = tb.predict(XV, raw_score=True)
    assert np.all(np.abs(got - ref) <= 1e-5 * np.maximum(1.0, np.abs(ref)))


def test_quantized_categorical_model_text_is_byte_identical():
    jb, tb, _ = trained("int8")
    text = tb.model_to_string()
    assert "num_cat=" in text and "cat_threshold=" in text
    assert text == jb.model_to_string()


def _cat_flags(ds):
    inner = ds._lazy_init()
    return [inner.feature_mapper(j).bin_type == BIN_CATEGORICAL
            for j in range(inner.num_features)]


NAMES = ["f%d" % j for j in range(X.shape[1])]
FORMS = {
    "index string": ({"categorical_column": "0,1,2,3,4,5,6,7,40,41"},
                     {}),
    "name list": ({"categorical_column": "name:" + ",".join(
        NAMES[c] for c in CATS)}, {"feature_name": NAMES}),
    "int": ({"cat_feature": 3}, {}),
    "list of indices": ({"categorical_feature": CATS}, {}),
    "list of names": ({"categorical_column": [NAMES[c] for c in CATS]},
                      {"feature_name": NAMES}),
    "constructor": ({}, {"categorical_feature": [NAMES[c] for c in CATS[:4]]
                         + CATS[4:], "feature_name": NAMES}),
}


@pytest.mark.parametrize("form", sorted(FORMS))
def test_each_form_of_categorical_column_resolves_as_in_the_jax_package(
        form):
    params, kw = FORMS[form]
    rows = slice(0, 600)
    jd = jlgb.Dataset(X[rows], Y[rows], params=dict(params, max_bin=63),
                      **kw)._lazy_init()
    td = tlgb.Dataset(X[rows], Y[rows], params=dict(params, max_bin=63),
                      **kw)
    flags = _cat_flags(td)
    assert flags == [jd.feature_mapper(j).bin_type == BIN_CATEGORICAL
                     for j in range(jd.num_features)]
    want = [3] if form == "int" else CATS
    assert [j for j, c in enumerate(flags) if c] == want
    assert np.array_equal(td._lazy_init().binned, jd.binned)


def test_an_unmatched_name_is_warned_about_and_ignored():
    params = {"categorical_column": ["f3", "nope"], "max_bin": 63}
    jd, jwarn = _warnings(jlog, lambda: jlgb.Dataset(
        X[:600], Y[:600], params=dict(params),
        feature_name=NAMES)._lazy_init())
    td = tlgb.Dataset(X[:600], Y[:600], params=dict(params),
                      feature_name=NAMES)
    _, twarn = _warnings(tlog, td._lazy_init)
    for warn in (jwarn, twarn):
        assert "categorical_column entry 'nope' does not match any " \
               "feature name; ignored" in warn
    assert [j for j, c in enumerate(_cat_flags(td)) if c] == [3]
    with pytest.raises(tlgb.LightGBMError, match="cannot parse 'x'"):
        tlgb.Dataset(X[:50], Y[:50], params={
            "categorical_column": "1,x"})._lazy_init()


@pytest.mark.parametrize("kind", ["classifier", "regressor", "ranker"])
def test_estimators_pass_categorical_feature(kind):
    rows = slice(0, 1200)
    est = {"classifier": tlgb.LGBMClassifier, "regressor":
           tlgb.LGBMRegressor, "ranker": tlgb.LGBMRanker}[kind](
        n_estimators=3, num_leaves=7, max_bin=63, min_child_samples=5,
        device="cpu")
    y = Y[rows] if kind != "ranker" else (X[rows, 3] % 4).astype(float)
    fit = {"group": [100] * 12} if kind == "ranker" else {}
    est.fit(X[rows], y, categorical_feature=CATS, **fit)
    params = est._train_params()
    ds = tlgb.Dataset(X[rows], y, params=dict(params), group=fit.get(
        "group"), categorical_feature=CATS)
    ref = tlgb.train(dict(params), ds, 3, device="cpu")
    text = est.booster_.model_to_string()
    assert text == ref.model_to_string()
    assert "num_cat=" in text


def test_dataset_from_a_file_with_categorical_column(tmp_path):
    path = str(tmp_path / "expo.tsv")
    rows = slice(0, 1500)
    np.savetxt(path, np.column_stack([Y[rows], X[rows]]), fmt="%.17g",
               delimiter="\t")
    params = dict(PARAMS, categorical_column="0,1,2,3,4,5,6,7,40,41")
    td = tlgb.Dataset(path, params=dict(params))
    ta = tlgb.Dataset(X[rows], Y[rows], params=dict(params))
    jd = jlgb.Dataset(path, params=dict(params))._lazy_init()
    assert [j for j, c in enumerate(_cat_flags(td)) if c] == CATS
    assert np.array_equal(td._lazy_init().binned, ta._lazy_init().binned)
    assert np.array_equal(td._lazy_init().binned, jd.binned)
    texts = [tlgb.train(dict(params), d, 3, device="cpu").model_to_string()
             for d in (td, ta)]
    assert texts[0] == texts[1] and "num_cat=" in texts[0]


def test_pred_leaf_contrib_and_dump_of_a_categorical_model_equal_jax():
    jb, _, _ = trained("hi_lo")
    text = jb.model_to_string()
    jm = jlgb.Booster(model_str=text)
    tm = tlgb.Booster(model_str=text, device="cpu")
    xv = XV.copy()
    xv[:20, 0] = -3.0        # a negative category
    xv[20:40, 6] = 500.0     # a category the training data never had
    xv[40:60, 7] = np.nan
    assert np.array_equal(tm.predict(xv, pred_leaf=True),
                          jm.predict(xv, pred_leaf=True))
    got, ref = tm.predict(xv, pred_contrib=True), jm.predict(
        xv, pred_contrib=True)
    assert np.array_equal(got, ref)
    raw = tm.predict(xv, raw_score=True)
    assert np.all(np.abs(raw - jm.predict(xv, raw_score=True))
                  <= 1e-5 * np.maximum(1.0, np.abs(raw)))
    assert json.dumps(tm.dump_model(), sort_keys=True) == json.dumps(
        jm.dump_model(), sort_keys=True)


def test_a_continued_categorical_run_grows_the_jax_trees(tmp_path):
    jb, _, _ = trained("hi_lo")
    path = str(tmp_path / "cat_model.txt")
    jb.save_model(path)
    jc = jlgb.train(dict(CAT_PARAMS), jlgb.Dataset(
        X, Y, params=dict(CAT_PARAMS)), 3, init_model=path,
        verbose_eval=False)
    tc = tlgb.train(dict(CAT_PARAMS), tlgb.Dataset(
        X, Y, params=dict(CAT_PARAMS)), 3, init_model=path, device="cpu")
    assert tc.num_trees() == jc.num_trees() == ROUNDS + 3
    for a, b in zip(jc._inner.models, tc._inner.models):
        assert a.num_leaves == b.num_leaves
        m = a.num_leaves - 1
        for k in ("split_feature", "threshold_in_bin", "decision_type",
                  "left_child", "right_child"):
            assert np.array_equal(getattr(a, k)[:m], getattr(b, k)[:m]), k
        assert np.array_equal(a.cat_boundaries, b.cat_boundaries)
        assert np.array_equal(a.cat_threshold, b.cat_threshold)
        assert np.all(np.abs(b.leaf_value - a.leaf_value)
                      <= 1e-5 * np.maximum(1.0, np.abs(a.leaf_value)))
    ref = jc.predict(XV, raw_score=True)
    got = tc.predict(XV, raw_score=True)
    assert np.all(np.abs(got - ref) <= 1e-5 * np.maximum(1.0, np.abs(ref)))
