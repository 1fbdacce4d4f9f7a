"""The port's serial grower (lightgbm_tpu_torch/learner/grow.py, plain
versions of kernels H, S and R on the CPU) against the JAX
`lightgbm_tpu.learner.grow.grow_tree` (f32 histograms, sibling
subtraction and small-node compaction on, as the GBDT layer runs it;
the port always histograms the smaller child from its row list).

The same binned matrix (built by the JAX package), gradients and
feature mask go to both. Tolerances: the node arrays (feature,
threshold, default_left, is_cat, left, right), the number of leaves,
`leaf_id`, and the leaf and node counts exactly; the leaf values within
1e-5 * max(1, |ref|); the node gains within 1e-4 * max(1, |ref|). The
fixtures keep every committed gain apart from its rivals by more than
f32 round-off, so the best-first order is the same (ties would be broken
by leaf slot here and by node-table slot in the JAX grower).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from lightgbm_tpu.dataset import Dataset as JaxDataset
from lightgbm_tpu.learner import grow as jgrow
from lightgbm_tpu_torch.convert import dataset_from_numpy
from lightgbm_tpu_torch.dataset import Dataset
from lightgbm_tpu_torch.learner.grow import GrowerConfig, SerialGrower

torch.set_num_threads(1)
N = 2048


def data(kind, seed):
    rng = np.random.RandomState(seed)
    x = rng.randn(N, 6)
    kw = {"max_bin": 31}
    if kind == "nan":
        x[rng.rand(N) < 0.15, 1] = np.nan
    elif kind == "zero":
        x[rng.rand(N) < 0.3, 1] = 0.0
        kw["zero_as_missing"] = True
    elif kind == "bundled":
        x[:, 2:] = 0.0
        owner = rng.randint(2, 6, N)
        live = rng.rand(N) < 0.7
        x[np.arange(N)[live], owner[live]] = rng.rand(live.sum()) * 3 + 0.5
    y = (np.nan_to_num(x[:, 0]) * 1.5 + np.sin(2 * np.nan_to_num(x[:, 1]))
         + x[:, 2] - 0.7 * x[:, 4] + 0.2 * rng.randn(N))
    return x, y, kw


CASES = {
    "nan": ("nan", {}),
    "zero": ("zero", {}),
    "bundled": ("bundled", {}),
    "regularised": ("nan", {"lambda_l1": 0.3, "lambda_l2": 1.5,
                            "min_gain_to_split": 0.05}),
    "max_depth": ("zero", {"max_depth": 3}),
    "min_data": ("nan", {"min_data_in_leaf": 150}),
    "feature_mask": ("bundled", {"mask": [True, False, True, True, False,
                                          True]}),
}


def jax_grow(jds, grad, hess, mask, opts, num_leaves):
    fm = jds.feature_meta_arrays()
    cfg = jgrow.GrowerConfig(
        num_leaves=num_leaves, max_bins=jds.max_num_bin(), chunk=256,
        lambda_l1=opts.get("lambda_l1", 0.0),
        lambda_l2=opts.get("lambda_l2", 0.0),
        min_gain_to_split=opts.get("min_gain_to_split", 0.0),
        min_data_in_leaf=opts.get("min_data_in_leaf", 10),
        min_sum_hessian_in_leaf=1e-3, max_depth=opts.get("max_depth", -1),
        batch_k=12, hist_bf16=False, hist_subtract=True, hist_compact=True,
        feature_bins=int(jds.num_bins_per_feature().max()),
        group_widths=tuple(int(b) for b in jds.groups.group_num_bin))
    st = jgrow.grow_tree(
        jnp.asarray(jds.binned), jnp.asarray(grad), jnp.asarray(hess),
        jnp.ones(N, jnp.float32), jnp.asarray(mask),
        *[jnp.asarray(fm[k]) for k in jgrow.FMETA_KEYS], cfg)
    return {k: np.asarray(v) for k, v in st._asdict().items()}


def port_grower(ds, opts, num_leaves):
    cfg = GrowerConfig(
        num_leaves=num_leaves, lambda_l1=opts.get("lambda_l1", 0.0),
        lambda_l2=opts.get("lambda_l2", 0.0),
        min_gain_to_split=opts.get("min_gain_to_split", 0.0),
        min_data_in_leaf=opts.get("min_data_in_leaf", 10),
        min_sum_hessian_in_leaf=1e-3, max_depth=opts.get("max_depth", -1))
    return SerialGrower(torch.from_numpy(ds.binned),
                        ds.feature_meta_arrays(), cfg, ds.max_num_bin(),
                        int(ds.num_bins_per_feature().max()))


def channels(grad, hess):
    return torch.from_numpy(np.stack([grad, hess, np.ones(N, np.float32)],
                                     1))


def port_grow(ds, grad, hess, mask, opts, num_leaves):
    return port_grower(ds, opts, num_leaves).grow(channels(grad, hess),
                                                  np.asarray(mask))


def assert_same_tree(ref, st):
    nl = st.num_leaves_used
    assert int(ref["num_leaves_used"]) == nl
    m = nl - 1
    for k in ("node_feature", "node_threshold", "node_default_left",
              "node_is_cat", "node_left", "node_right"):
        assert np.array_equal(ref[k][:m], getattr(st, k)[:m]), k
    assert np.array_equal(ref["leaf_id"][:N], st.leaf_id.numpy())
    assert np.array_equal(ref["count"][:nl], st.count[:nl])
    assert np.array_equal(ref["node_count"][:m], st.node_count[:m])
    lv = ref["leaf_value"][:nl]
    assert np.all(np.abs(st.leaf_value[:nl] - lv)
                  <= 1e-5 * np.maximum(1.0, np.abs(lv)))
    g = ref["node_gain"][:m]
    assert np.all(np.abs(st.node_gain[:m] - g)
                  <= 1e-4 * np.maximum(1.0, np.abs(g)))
    assert np.array_equal(ref["leaf_depth"][:nl], st.leaf_depth[:nl])
    assert np.array_equal(ref["leaf_parent"][:nl], st.leaf_parent[:nl])


@pytest.mark.parametrize("case", sorted(CASES))
def test_tree_equals_the_jax_grower(case):
    kind, opts = CASES[case]
    x, y, kw = data(kind, seed=len(case))
    jds = JaxDataset.from_numpy(x, y, **kw)
    ds = Dataset.from_numpy(x, y, **kw)
    grad = (0.0 - y).astype(np.float32)          # L2 at score 0
    hess = np.ones(N, np.float32)
    mask = np.asarray(opts.get("mask", [True] * ds.num_features))
    ref = jax_grow(jds, grad, hess, mask, opts, 31)
    st = port_grow(ds, grad, hess, mask, opts, 31)
    assert st.num_leaves_used >= 8
    assert_same_tree(ref, st)
    if "mask" in opts:
        assert all(mask[f] for f in st.node_feature[:st.num_leaves_used - 1])
    if "max_depth" in opts:
        assert st.leaf_depth[:st.num_leaves_used].max() <= opts["max_depth"]


def test_binary_gradients_and_a_bundled_split():
    x, y, kw = data("bundled", 3)
    ds = Dataset.from_numpy(x, y, **kw)
    jds = JaxDataset.from_numpy(x, y, **kw)
    p = 1 / (1 + np.exp(-0.3 * y))
    lab = (y > 0).astype(np.float32)
    grad = (p - lab).astype(np.float32)
    hess = (p * (1 - p)).astype(np.float32)
    mask = np.ones(ds.num_features, bool)
    ref = jax_grow(jds, grad, hess, mask, {}, 15)
    st = port_grow(ds, grad, hess, mask, {}, 15)
    assert_same_tree(ref, st)
    fm = ds.feature_meta_arrays()
    used = st.node_feature[:st.num_leaves_used - 1]
    assert fm["is_bundled"][used].any()


def test_a_reused_grower_grows_each_tree_afresh():
    """The grower keeps its row permutation, leaf ids and result buffers
    across trees; a tree grown after another must be the tree a fresh
    grower grows from the same inputs."""
    x, y, kw = data("nan", 4)
    ds = Dataset.from_numpy(x, y, **kw)
    hess = np.ones(N, np.float32)
    mask = np.ones(ds.num_features, bool)
    first = (0.0 - y).astype(np.float32)
    second = (0.5 * np.sign(y) - y).astype(np.float32)
    reused = port_grower(ds, {}, 31)
    reused.grow(channels(first, hess), mask)
    a = reused.grow(channels(second, hess), mask)
    a_leaf_id = a.leaf_id.clone()
    b = port_grow(ds, second, hess, mask, {}, 31)
    assert a.num_leaves_used == b.num_leaves_used > 8
    for k in ("node_feature", "node_threshold", "node_default_left",
              "node_left", "node_right", "leaf_value", "count", "sum_g"):
        assert np.array_equal(getattr(a, k), getattr(b, k)), k
    assert torch.equal(a_leaf_id, b.leaf_id)


def test_a_jax_dataset_carried_across_grows_the_same_tree():
    x, y, kw = data("bundled", 5)
    jds = JaxDataset.from_numpy(x, y, **kw)
    carried = dataset_from_numpy({
        "binned": jds.binned, "mappers": [m.to_dict() for m in jds.mappers],
        "groups": jds.groups.to_dict(),
        "feature_meta": jds.feature_meta_arrays(), "label": y})
    own = Dataset.from_numpy(x, y, **kw)
    grad = (0.0 - y).astype(np.float32)
    hess = np.ones(N, np.float32)
    mask = np.ones(own.num_features, bool)
    a = port_grow(carried, grad, hess, mask, {}, 31)
    b = port_grow(own, grad, hess, mask, {}, 31)
    assert a.num_leaves_used == b.num_leaves_used > 8
    for k in ("node_feature", "node_threshold", "node_default_left",
              "node_left", "node_right", "leaf_value", "count"):
        assert np.array_equal(getattr(a, k), getattr(b, k)), k
    assert torch.equal(a.leaf_id, b.leaf_id)


def test_no_split_leaves_a_single_leaf():
    x, y, kw = data("nan", 6)
    ds = Dataset.from_numpy(x, y, **kw)
    grad = (0.0 - y).astype(np.float32)
    st = port_grow(ds, grad, np.ones(N, np.float32),
                   np.ones(ds.num_features, bool),
                   {"min_gain_to_split": 1e12}, 31)
    assert st.num_leaves_used == 1
    assert (st.leaf_id.numpy() == 0).all()
    assert st.count[0] == N
