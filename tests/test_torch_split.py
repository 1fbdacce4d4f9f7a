"""Kernel S's plain version (lightgbm_tpu_torch/ops/split.py) against
the JAX package's split finding.

Real histograms (the JAX package's f32 `leaf_histogram` over datasets
binned by `lightgbm_tpu.dataset.Dataset.from_numpy`, with seeded
gradients) go through `lightgbm_tpu.learner.grow._leaf_best_split`
(`_extract_feature_hist` + `ops/split.find_best_splits`) and through the
port's `split_scan` on the CPU, for NaN, zero and no missing values, a
bundled feature, a categorical feature, the feature mask and the
max_depth guard. Tolerances: each feature's gain is finite exactly when
the JAX one is; it is as close to a float64 oracle (the plain scan run
in f64 on the same histogram) as the JAX gain is, within twice the JAX
error plus tol = 1e-5 * max(1, |oracle| + parent gain) (a reported gain
is (left + right) - parent gain, each term with f32 round-off of its own
size); the chosen feature, threshold, default_left and is_categorical
are the same wherever the two best features' gains differ by more than
2 * (JAX error + tol) (f32 scans summed in another order may swap closer
ones); the left sums of the chosen split within 1e-5 * max(1, |ref|).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from lightgbm_tpu.dataset import Dataset as JaxDataset
from lightgbm_tpu.learner import grow as jgrow
from lightgbm_tpu.ops import histogram as jh
from lightgbm_tpu.ops import split as jsplit
from lightgbm_tpu_torch.ops.split import (FMETA_KEYS, SplitParams,
                                          device_fmeta, split_scan,
                                          split_scan_plain)

torch.set_num_threads(1)
CPU = torch.device("cpu")


def data(kind, seed, n=1024):
    rng = np.random.RandomState(seed)
    x = rng.randn(n, 6)
    kw = {"max_bin": 31}
    if kind == "nan":
        x[rng.rand(n) < 0.2, 1] = np.nan
        x[rng.rand(n) < 0.1, 4] = np.nan
    elif kind == "zero":
        x[rng.rand(n) < 0.3, 1] = 0.0
        x[rng.rand(n) < 0.3, 2] = 0.0
        kw["zero_as_missing"] = True
    elif kind == "none":
        kw["use_missing"] = False
    elif kind == "bundled":
        x[:, 2:] = 0.0
        owner = rng.randint(2, 6, n)
        live = rng.rand(n) < 0.6
        x[np.arange(n)[live], owner[live]] = rng.rand(live.sum()) + 0.5
    elif kind == "categorical":
        x[:, 3] = rng.randint(0, 7, n)
        kw["categorical_features"] = [3]
    ds = JaxDataset.from_numpy(x, np.zeros(n), **kw)
    grad = (rng.randn(n) + 0.8 * np.nan_to_num(x[:, 1])
            + (x[:, 3] == 2)).astype(np.float32)
    hess = (rng.rand(n) * 0.5 + 0.25).astype(np.float32)
    w3 = np.stack([grad, hess, np.ones(n, np.float32)], 1)
    return ds, w3


def jax_pick(hist, tot, depth, mask, fm, cfg):
    gp = jgrow.GrowParams.from_config(cfg)
    fmeta = {k: jnp.asarray(fm[k]) for k in FMETA_KEYS}
    vals = jgrow._leaf_best_split(
        jnp.asarray(hist), jnp.float32(tot[0]), jnp.float32(tot[1]),
        jnp.float32(tot[2]), jnp.int32(depth), jnp.asarray(mask), fmeta,
        cfg, gp)
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


CASES = [("nan", {}), ("zero", {}), ("none", {}), ("bundled", {}),
         ("categorical", {}), ("nan", {"lambda_l1": 0.5, "lambda_l2": 2.0,
                                       "min_gain_to_split": 0.1}),
         ("zero", {"min_data_in_leaf": 200}),
         ("none", {"min_sum_hessian_in_leaf": 60.0})]


@pytest.mark.parametrize("kind,extra", CASES,
                         ids=[f"{k}-{i}" for i, (k, _) in enumerate(CASES)])
def test_choice_equals_the_jax_split_finder(kind, extra):
    ds, w3 = data(kind, seed=len(extra))
    if kind == "bundled":
        assert ds.has_bundles
    fm = ds.feature_meta_arrays()
    nb = int(ds.num_bins_per_feature().max())
    B = ds.max_num_bin()
    cfg = jgrow.GrowerConfig(
        num_leaves=8, max_bins=B, chunk=256,
        lambda_l1=extra.get("lambda_l1", 0.0),
        lambda_l2=extra.get("lambda_l2", 0.0),
        min_gain_to_split=extra.get("min_gain_to_split", 0.0),
        min_data_in_leaf=extra.get("min_data_in_leaf", 5),
        min_sum_hessian_in_leaf=extra.get("min_sum_hessian_in_leaf", 1e-3),
        max_depth=-1, feature_bins=nb)
    params = SplitParams(cfg.lambda_l1, cfg.lambda_l2, cfg.min_gain_to_split,
                         cfg.min_data_in_leaf, cfg.min_sum_hessian_in_leaf,
                         cfg.max_depth)
    binned = ds.binned
    n = binned.shape[0]
    rng = np.random.RandomState(9)
    member = [np.ones(n, bool), rng.rand(n) < 0.3]
    for sel in member:
        w = w3 * sel[:, None]
        hist = np.array(jh.leaf_histogram(
            jnp.asarray(binned), jnp.asarray(w), B, 256, bf16=False))
        tot = hist[0].sum(axis=0).astype(np.float32)
        mask = np.ones(ds.num_features, bool)
        jv, jgain = jax_pick(hist, tot, 0, mask, fm, cfg)
        out_f, out_i, fgain = split_scan(
            torch.tensor(hist)[None], torch.from_numpy(tot)[None],
            torch.zeros(1, dtype=torch.int32), device_fmeta(fm, CPU),
            torch.ones(ds.num_features, dtype=torch.uint8), params, nb)
        fgain = fgain[0].numpy()
        assert np.array_equal(np.isfinite(fgain), np.isfinite(jgain))
        fin = np.isfinite(jgain)
        oracle = split_scan_plain(
            torch.tensor(hist, dtype=torch.float64)[None],
            torch.from_numpy(tot.astype(np.float64))[None],
            torch.zeros(1, dtype=torch.int32), device_fmeta(fm, CPU),
            torch.ones(ds.num_features, dtype=torch.uint8), params,
            nb)[2][0].numpy()
        h_eff = np.float64(tot[1]) + 2e-15 + cfg.lambda_l2
        parent = max(abs(tot[0]) - cfg.lambda_l1, 0.0) ** 2 / h_eff
        jerr = np.zeros_like(oracle)
        jerr[fin] = np.abs(jgain[fin] - oracle[fin])
        tol = jerr + 1e-5 * np.maximum(1.0, np.abs(oracle) + parent)
        assert np.all(np.abs(fgain[fin] - oracle[fin])
                      <= jerr[fin] + tol[fin])
        order = np.sort(jgain[fin])[::-1]
        if len(order) == 0:
            assert not np.isfinite(out_f[0, 0].item())
            continue
        gap = order[0] - (order[1] if len(order) > 1 else -np.inf)
        if gap > 2 * tol[fin].max():
            assert out_i[0, 0].item() == int(jv[1])
            assert out_i[0, 1].item() == int(jv[2])
            assert bool(out_i[0, 2].item()) == bool(jv[3])
            assert bool(out_i[0, 3].item()) == bool(jv[4])
            ref = np.array([jv[5], jv[6], jv[7]], np.float64)
            got = out_f[0, 1:].numpy().astype(np.float64)
            assert np.all(np.abs(got - ref)
                          <= 1e-5 * np.maximum(1.0, np.abs(ref)))
            assert abs(out_f[0, 0].item() - float(jv[0])) <= tol[fin].max()
        if kind == "categorical":
            assert np.isfinite(fgain[3])


def test_mask_and_depth_guard():
    ds, w3 = data("nan", 11)
    fm = ds.feature_meta_arrays()
    B, nb = ds.max_num_bin(), int(ds.num_bins_per_feature().max())
    hist = np.array(jh.leaf_histogram(jnp.asarray(ds.binned),
                                      jnp.asarray(w3), B, 256, bf16=False))
    tot = hist[0].sum(axis=0).astype(np.float32)
    mask = np.array([False, True, True, False, True, True])
    for max_depth, depth in ((-1, 0), (3, 1), (3, 2)):
        cfg = jgrow.GrowerConfig(
            num_leaves=8, max_bins=B, chunk=256, lambda_l1=0.0,
            lambda_l2=0.0, min_gain_to_split=0.0, min_data_in_leaf=5,
            min_sum_hessian_in_leaf=1e-3, max_depth=max_depth,
            feature_bins=nb)
        jv, _ = jax_pick(hist, tot, depth, mask, fm, cfg)
        out_f, out_i, _ = split_scan(
            torch.tensor(hist)[None], torch.from_numpy(tot)[None],
            torch.tensor([depth], dtype=torch.int32), device_fmeta(fm, CPU),
            torch.from_numpy(mask.astype(np.uint8)),
            SplitParams(0.0, 0.0, 0.0, 5, 1e-3, max_depth), nb)
        assert out_i[0, 0].item() == int(jv[1])
        assert mask[out_i[0, 0].item()] or not np.isfinite(jv[0])
        if depth + 1 > max_depth > 0:
            assert out_f[0, 0].item() == float("-inf") == float(jv[0])
        else:
            parent = float(tot[0]) ** 2 / (float(tot[1]) + 2e-15)
            assert abs(out_f[0, 0].item() - float(jv[0])) <= 1e-5 * max(
                1.0, abs(float(jv[0])) + parent)


def test_two_leaves_in_one_call_equal_two_calls():
    ds, w3 = data("zero", 12)
    fm = device_fmeta(ds.feature_meta_arrays(), CPU)
    B, nb = ds.max_num_bin(), int(ds.num_bins_per_feature().max())
    h = np.stack([np.asarray(jh.leaf_histogram(
        jnp.asarray(ds.binned), jnp.asarray(w3 * s), B, 256, bf16=False))
        for s in (1.0, 0.5)])
    tot = h[:, 0].sum(axis=1).astype(np.float32)
    args = (fm, torch.ones(ds.num_features, dtype=torch.uint8),
            SplitParams(0.0, 1.0, 0.0, 5, 1e-3, -1), nb)
    both = split_scan_plain(torch.from_numpy(h), torch.from_numpy(tot),
                            torch.zeros(2, dtype=torch.int32), *args)
    for c in range(2):
        one = split_scan_plain(torch.from_numpy(h[c:c + 1]),
                               torch.from_numpy(tot[c:c + 1]),
                               torch.zeros(1, dtype=torch.int32), *args)
        for a, b in zip(both, one):
            assert torch.equal(a[c], b[0])
