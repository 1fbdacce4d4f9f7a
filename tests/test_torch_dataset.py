"""lightgbm_tpu_torch dataset construction against the JAX package.

The same seeded numpy matrices go through `lightgbm_tpu.dataset.Dataset
.from_numpy` and the port's `Dataset.from_numpy`. Tolerance: none. The
binned matrix, every mapper's `to_dict()`, the EFB groups and
`feature_meta_arrays()` must be exactly equal, for fixtures with NaN,
exact zeros, a constant column and sparse columns that bundle, and for a
valid set binned through `reference=`. `convert.dataset_from_numpy`
must rebuild the same Dataset from the JAX one's arrays.
"""
import json

import numpy as np
import pytest
import torch

from lightgbm_tpu.dataset import Dataset as JaxDataset
from lightgbm_tpu_torch import LightGBMError
from lightgbm_tpu_torch.convert import dataset_from_numpy
from lightgbm_tpu_torch.dataset import Dataset

torch.set_num_threads(1)


def dense(seed, n=1500):
    """NaN column 1, exact zeros in column 2, a constant column 3, a
    heavy-tailed column 4 and a few-valued column 5."""
    rng = np.random.RandomState(seed)
    x = rng.randn(n, 7)
    x[rng.rand(n) < 0.15, 1] = np.nan
    x[rng.rand(n) < 0.4, 2] = 0.0
    x[:, 3] = 2.5
    x[:, 4] = rng.standard_cauchy(n)
    x[:, 5] = rng.randint(0, 4, n)
    return x


def sparse(seed, n=1200):
    """Two dense columns and eight mutually exclusive sparse ones, which
    EFB bundles."""
    rng = np.random.RandomState(seed)
    x = np.zeros((n, 10))
    x[:, :2] = rng.randn(n, 2)
    owner = rng.randint(2, 10, n)
    live = rng.rand(n) < 0.5
    x[np.arange(n)[live], owner[live]] = rng.rand(live.sum()) * 5 + 0.1
    return x


CASES = {
    "dense": (dense, {}),
    "dense_bins15": (dense, {"max_bin": 15}),
    "zero_as_missing": (dense, {"zero_as_missing": True}),
    "no_missing": (dense, {"use_missing": False}),
    "sparse_bundles": (sparse, {"max_bin": 63}),
    "sparse_unbundled": (sparse, {"max_bin": 63, "enable_bundle": False}),
}


def build_both(name, seed=0, **extra):
    make, kw = CASES[name]
    x = make(seed)
    y = np.random.RandomState(seed + 7).rand(x.shape[0])
    kw = dict(kw, **extra)
    return (JaxDataset.from_numpy(x, y, **kw),
            Dataset.from_numpy(x, y, **kw), x, y, kw)


def mapper_dicts(ds):
    """to_dict() of every mapper, with the NaN bound made comparable."""
    return json.dumps([m.to_dict() for m in ds.mappers])


def assert_same(j, t):
    assert np.array_equal(j.binned, t.binned)
    assert j.binned.dtype == t.binned.dtype
    assert mapper_dicts(j) == mapper_dicts(t)
    assert j.used_features == t.used_features
    assert j.groups.to_dict() == t.groups.to_dict()
    for k in ("group_of", "offset_of", "is_bundled", "group_num_bin"):
        assert np.array_equal(getattr(j.groups, k), getattr(t.groups, k)), k
    jm, tm = j.feature_meta_arrays(), t.feature_meta_arrays()
    assert sorted(jm) == sorted(tm)
    for k in jm:
        assert np.array_equal(jm[k], tm[k]), k
        assert jm[k].dtype == tm[k].dtype, k
    assert j.feature_infos() == t.feature_infos()
    assert j.max_num_bin() == t.max_num_bin()
    assert np.array_equal(j.num_bins_per_feature(), t.num_bins_per_feature())
    assert np.array_equal(j.metadata.label, t.metadata.label)


@pytest.mark.parametrize("name", sorted(CASES))
def test_binning_equals_the_jax_package(name):
    j, t, _, _, _ = build_both(name)
    assert_same(j, t)


def test_the_fixtures_cover_what_they_claim():
    j, t, _, _, _ = build_both("dense")
    types = [m.missing_type for m in t.mappers]
    assert types[1] == 2                      # NaN column
    assert t.mappers[3].is_trivial and 3 not in t.used_features
    assert t.mappers[5].num_bin == 4
    _, tz, _, _, _ = build_both("zero_as_missing")
    assert tz.mappers[2].missing_type == 1    # zero column, as missing
    _, ts, _, _, _ = build_both("sparse_bundles")
    assert ts.has_bundles and ts.num_groups < ts.num_features


@pytest.mark.parametrize("name", ["dense", "sparse_bundles"])
def test_valid_set_through_reference(name):
    j, t, _, _, kw = build_both(name)
    make = CASES[name][0]
    xv = make(5, n=400)
    yv = np.arange(400, dtype=np.float64)
    jv = JaxDataset.from_numpy(xv, yv, reference=j, **kw)
    tv = Dataset.from_numpy(xv, yv, reference=t, **kw)
    assert np.array_equal(jv.binned, tv.binned)
    assert tv.mappers is t.mappers and tv.groups is t.groups


def test_weights_and_init_score_carry():
    x = dense(3)
    w = np.random.RandomState(1).rand(x.shape[0])
    j = JaxDataset.from_numpy(x, np.zeros(len(x)), weight=w,
                              init_score=np.ones(len(x)))
    t = Dataset.from_numpy(x, np.zeros(len(x)), weight=w,
                           init_score=np.ones(len(x)))
    assert np.array_equal(j.metadata.weights, t.metadata.weights)
    assert np.array_equal(j.metadata.init_score, t.metadata.init_score)


def test_sampled_bounds_on_more_rows_than_the_sample():
    """bin_construct_sample_cnt below the row count: both sample the same
    rows with the same RandomState."""
    j, t, _, _, _ = build_both("dense", bin_construct_sample_cnt=500,
                               chunk_rows=333)
    assert_same(j, t)


@pytest.mark.parametrize("name", ["dense", "sparse_bundles"])
def test_dataset_from_numpy_rebuilds_the_jax_dataset(name):
    j, t, _, _, _ = build_both(name)
    carried = dataset_from_numpy({
        "binned": j.binned, "mappers": [m.to_dict() for m in j.mappers],
        "groups": j.groups.to_dict(),
        "feature_meta": j.feature_meta_arrays(),
        "label": j.metadata.label})
    assert_same(j, carried)
    assert_same(t, carried)


def test_dataset_from_numpy_refuses_inconsistent_meta():
    j, _, _, _, _ = build_both("dense")
    meta = j.feature_meta_arrays()
    meta["default_bin"] = meta["default_bin"] + 1
    with pytest.raises(LightGBMError, match="default_bin"):
        dataset_from_numpy({
            "binned": j.binned,
            "mappers": [m.to_dict() for m in j.mappers],
            "groups": j.groups.to_dict(), "feature_meta": meta,
            "label": j.metadata.label})
