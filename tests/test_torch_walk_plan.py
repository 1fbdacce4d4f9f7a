"""W's 16-byte records and launch plan (`lightgbm_tpu_torch/ops/predict.py`
`walk_records`, `walk_decide`, `walk_leaves_replay`, `binned_walk_smem`)
against the JAX package, on the CPU.

W folds each node's EFB decode into group-bin space when a tree is
packed, so the kernel (`csrc/binned_walk.cu`) decides a node from the
stored group bin with one record. Held here, on trees the port trains
(the JAX package's own trees, given the same data) over four fixtures:
uint8 bins with NaN-missing features and an EFB bundle of sparse ones,
the same data with zero_as_missing (zero-missing nodes), uint16 bins
(Bosch-like one-hot blocks bundled past 256 bins) and categorical
features:

- for every node and every value a bin of the matrix's type can take,
  the record's decision (`walk_decide`, the kernel's `goes_left` in
  numpy) equals the JAX package's: `predict_leaf_binned` (its decode,
  then `_decide_binned`) run on a one-node tree holding that node;
- the same over nodes edited to the edges the trees do not reach
  (negative and past-the-range thresholds, a missing bin outside the
  range, no bitset words);
- the replay of the walk over the records (`walk_leaves_replay`) equals
  `predict_leaf_binned`'s leaves on the training rows, on rows of another
  seed binned with the training mappers and on seeded random group bins;
  so do the plain versions' leaves and values (`tree_leaf_walk_binned`,
  `tree_value_walk_binned` on the CPU);
- `binned_walk_smem` stages the tree in shared memory within its
  budget; wide rows are walked column-major on the card
  (`walk_by_columns`, `walk_layout`), and the walk takes column-major
  bins as it takes row-major ones;
- a tree past the record's 32,768 leaves is refused by name.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import lightgbm_tpu_torch as tlgb
from lightgbm_tpu.ops import predict as jpredict
from lightgbm_tpu.tree import Tree as JaxTree
from lightgbm_tpu_torch.log import LightGBMError
from lightgbm_tpu_torch.ops import predict as P
from lightgbm_tpu_torch.testing.synth import synth_expo
from lightgbm_tpu_torch.tree import Tree

torch.set_num_threads(1)
CPU = torch.device("cpu")
ROUNDS = 4
PARAMS = {"objective": "binary", "num_leaves": 15, "learning_rate": 0.3,
          "min_data_in_leaf": 10, "min_sum_hessian_in_leaf": 1.0,
          "max_bin": 63, "verbose": -1}


def numeric(n, seed):
    """Dense features, two with NaNs, and three mutually exclusive sparse
    ones that EFB bundles into one uint8 group."""
    rng = np.random.RandomState(seed)
    x = rng.randn(n, 8).astype(np.float32)
    x[rng.rand(n) < 0.15, 1] = np.nan
    x[rng.rand(n) < 0.05, 4] = np.nan
    # at most one of 5, 6, 7 non-zero in a row: one EFB group
    pick = rng.randint(0, 12, size=n)
    x[:, 5:8] = 0.0
    on = pick < 3
    x[np.flatnonzero(on), 5 + pick[on]] = rng.randn(int(on.sum())) + 2.0
    score = (x[:, 0] - np.nan_to_num(x[:, 1]) + 0.7 * x[:, 2] * x[:, 3]
             + x[:, 5] - 2 * x[:, 6] + np.nan_to_num(x[:, 4]) * x[:, 7])
    y = (score + 0.5 * rng.logistic(size=n) > 0).astype(np.float32)
    return x, y


def bosch_like(n, seed, blocks=6, f=68):
    """bench.py's Bosch shape cut to `blocks` one-hot blocks of 10 and
    f - 10 * blocks sparse numerics: uint16 groups of 631 bins."""
    rng = np.random.RandomState(seed)
    x = np.zeros((n, f), np.float32)
    for b in range(blocks):
        pick = rng.randint(0, 10, size=n)
        x[np.arange(n), b * 10 + pick] = rng.rand(n).astype(np.float32) + 0.1
    rest = rng.randn(n, f - blocks * 10).astype(np.float32)
    rest[rng.rand(n, f - blocks * 10) < 0.8] = 0.0
    x[:, blocks * 10:] = rest
    score = (x[:, 0] * 2.0 - x[:, 10] + x[:, 60] - 0.5 * x[:, 61]
             + x[:, 20] * x[:, 62])
    y = (score + 0.5 * rng.logistic(size=n) > 0.3).astype(np.float32)
    return x, y


def expo(n, seed):
    x, y, _ = synth_expo(n, seed=seed)
    return x, y


FIXTURES = {
    "u8_nan": (numeric, {}),
    "u8_zero": (numeric, {"zero_as_missing": True}),
    "u16": (bosch_like, {}),
    "cat": (expo, {"categorical_feature": list(range(8))}),
}
_trained = {}


def trained(name):
    """(port booster, its Dataset, held-out rows binned by its mappers)."""
    if name not in _trained:
        make, extra = FIXTURES[name]
        x, y = make(2500, 0)
        xv, yv = make(800, 1)
        params = dict(PARAMS, **extra)
        ds = tlgb.Dataset(x, y, params=dict(params))
        booster = tlgb.train(dict(params), ds, ROUNDS, device="cpu")
        inner = ds._lazy_init()
        valid = tlgb.Dataset(xv, yv, reference=ds)._lazy_init()
        _trained[name] = (booster, inner, valid.binned)
    return _trained[name]


def jax_tree(tree):
    """The JAX package's DeviceTree of a port tree (the model text both
    packages read)."""
    return JaxTree.from_string(tree.to_string()).to_device()


_NODE_ARRAYS = ("split_feature", "threshold_bin", "threshold_real",
                "default_left", "is_categorical", "node_missing",
                "node_nan_bin", "node_default_bin", "node_group",
                "node_offset", "node_bundled", "node_num_bin", "split_gain",
                "internal_value", "internal_count")


def jax_decisions(dtree, node, values, groups):
    """[V] bool: the JAX package's decision of `node` for each group bin
    in `values`: predict_leaf_binned on a tree whose root is the node and
    whose children are leaves 0 (left) and 1."""
    stump = dtree._replace(
        num_leaves=jnp.int32(2),
        left_child=jnp.asarray([-1], jnp.int32),
        right_child=jnp.asarray([-2], jnp.int32),
        **{k: getattr(dtree, k)[node:node + 1] for k in _NODE_ARRAYS})
    g = int(np.asarray(dtree.node_group)[node])
    binned = np.zeros((len(values), groups), values.dtype)
    binned[:, g] = values
    leaf = np.asarray(jpredict.predict_leaf_binned(stump, jnp.asarray(
        binned)))
    return leaf == 0


def every_value(dtype):
    return np.arange(np.iinfo(dtype).max + 1).astype(dtype)


def assert_nodes_decide_as_jax(tree, groups, dtype):
    recs, bits = P.walk_records(tree)
    dtree = jax_tree(tree)
    values = every_value(dtype)
    for k in range(tree.num_leaves - 1):
        want = jax_decisions(dtree, k, values, groups)
        got = P.walk_decide(recs, bits, np.full(len(values), k),
                            values.astype(np.int64))
        assert np.array_equal(got, want), "node %d" % k


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_every_record_decides_every_bin_as_decide_binned(name):
    booster, inner, _ = trained(name)
    dtype = inner.binned.dtype
    kinds = set()
    for tree in booster._inner.models:
        assert_nodes_decide_as_jax(tree, inner.binned.shape[1], dtype)
        m = tree.num_leaves - 1
        kinds |= {("bundled", bool(b)) for b in tree.node_bundled[:m]}
        kinds |= {("missing", int(t >> 2) & 3)
                  for t in tree.decision_type[:m]}
        kinds |= {("cat", bool(t & 1)) for t in tree.decision_type[:m]}
    # the fixtures reach what they are for
    want = {"u8_nan": {("missing", 2), ("bundled", True)},
            "u8_zero": {("missing", 1)},
            "u16": {("bundled", True)},
            "cat": {("cat", True)}}[name]
    assert want <= kinds, kinds
    assert (dtype == np.uint16) == (name == "u16")


@pytest.mark.parametrize("name", ["u8_nan", "u8_zero", "u16", "cat"])
def test_records_at_the_edges_decide_as_decide_binned(name):
    """Thresholds below and past the range, a missing bin outside it,
    a default bin outside the bitset and a node with no bitset words:
    edits the trained trees do not make, decided as the JAX package
    decides them for every value."""
    booster, inner, _ = trained(name)
    tree = Tree.from_string(booster._inner.models[0].to_string())
    m = tree.num_leaves - 1
    rng = np.random.RandomState(7)
    for k in range(m):
        choice = rng.randint(5)
        if tree.decision_type[k] & 1:
            if choice == 0:
                tree.node_default_bin[k] = tree.node_num_bin[k] + 40
            elif choice == 1:
                tree.threshold_in_bin[k] = tree.num_cat + 3
        elif choice == 0:
            tree.threshold_in_bin[k] = -1
        elif choice == 1:
            tree.threshold_in_bin[k] = tree.node_num_bin[k] + 70000
        elif choice == 2:
            tree.node_nan_bin[k] = tree.node_num_bin[k] + 5
        elif choice == 3:
            tree.node_default_bin[k] = -3
    assert_nodes_decide_as_jax(tree, inner.binned.shape[1],
                               inner.binned.dtype)


def random_bins(inner, n, seed):
    """Seeded group bins, each column uniform over its group's bins."""
    rng = np.random.RandomState(seed)
    widths = np.asarray(inner.groups.group_num_bin)
    return (rng.rand(n, len(widths)) * widths).astype(inner.binned.dtype)


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_the_walk_over_records_gives_predict_leaf_binned_leaves(name):
    booster, inner, valid = trained(name)
    mats = [inner.binned, valid, random_bins(inner, 3000, 3)]
    for tree in booster._inner.models:
        recs, bits = P.walk_records(tree)
        dtree = jax_tree(tree)
        bt = P.binned_tree(tree, CPU)
        for mat in mats:
            want = np.asarray(jpredict.predict_leaf_binned(
                dtree, jnp.asarray(mat)))
            assert np.array_equal(P.walk_leaves_replay(recs, bits, mat),
                                  want)
            t = torch.from_numpy(mat)
            assert np.array_equal(P.tree_leaf_walk_binned(bt, t).numpy(),
                                  want)
            score = torch.zeros(mat.shape[0])
            P.tree_value_walk_binned(bt, t, score)
            assert np.array_equal(score.numpy(), np.asarray(
                jpredict.predict_value_binned(dtree, jnp.asarray(mat))))


def test_a_one_leaf_tree_walks_to_leaf_zero():
    tree = Tree(1)
    tree.leaf_value[:] = 0.25
    recs, bits = P.walk_records(tree)
    assert recs.shape == (0, 4)
    mat = np.zeros((5, 3), np.uint8)
    assert np.array_equal(P.walk_leaves_replay(recs, bits, mat),
                          np.zeros(5, np.int32))
    bt = P.binned_tree(tree, CPU)
    score = torch.ones(5)
    P.tree_value_walk_binned(bt, torch.from_numpy(mat), score)
    assert np.array_equal(score.numpy(), np.full(5, 1.25, np.float32))


def test_binned_tree_packs_one_buffer_beside_the_plain_fields():
    booster, _, _ = trained("cat")
    tree = booster._inner.models[0]
    bt = P.binned_tree(tree, CPU, -tree.leaf_value)
    recs, bits = P.walk_records(tree)
    assert np.array_equal(bt.recs.numpy(), recs)
    assert np.array_equal(bt.bits.numpy().view(np.uint32), bits)
    assert bt.categorical and bt.num_leaves == tree.num_leaves
    assert np.array_equal(bt.leaf_value.numpy(),
                          (-tree.leaf_value).astype(np.float32))
    base = bt.recs.untyped_storage().data_ptr()
    for t in (bt.bits, bt.nodes, bt.cat_bounds, bt.cat_bits, bt.leaf_value):
        assert t.untyped_storage().data_ptr() == base


@pytest.mark.parametrize("recs,bits,smem", [
    (0, 1, 16),                 # a one-leaf tree
    (1, 1, 32),
    (254, 1, 4080),             # 255 leaves, numeric
    (254, 300, 5264),           # 255 leaves, categorical bitsets
    (4095, 1, 65536),           # 4,096 leaves: the budget
    (4095, 5, 0),               # past it: from device memory
    (4096, 1, 0),
    (32767, 9, 0),
])
def test_the_tree_is_staged_in_shared_memory_within_its_budget(recs, bits,
                                                               smem):
    assert P.binned_walk_smem(recs, bits) == smem
    assert smem <= P.WALK_TREE_SMEM_BYTES


class _OnCard:
    """The shape, type and device type walk_by_columns reads, of a
    matrix on the card."""
    def __init__(self, groups, dtype):
        self.shape = (1000, groups)
        self.device = torch.device("cuda", 0)
        self._itemsize = torch.empty(0, dtype=dtype).element_size()

    def element_size(self):
        return self._itemsize


@pytest.mark.parametrize("groups,dtype,columns", [
    (28, torch.uint8, False),     # HIGGS
    (40, torch.uint8, False),     # the categorical protocol
    (64, torch.uint8, False),
    (65, torch.uint8, True),
    (32, torch.uint16, False),
    (33, torch.uint16, True),
    (338, torch.uint16, True),    # Bosch
])
def test_wide_rows_are_walked_column_major_on_the_card(groups, dtype,
                                                       columns):
    assert P.walk_by_columns(_OnCard(groups, dtype)) is columns
    on_cpu = torch.zeros((4, groups), dtype=torch.uint8)
    assert not P.walk_by_columns(on_cpu)
    assert P.walk_layout(on_cpu) is on_cpu


@pytest.mark.parametrize("name", ["u16", "cat"])
def test_the_plain_walk_takes_column_major_bins(name):
    """W takes bins of any strides: the booster hands it a column-major
    copy of wide rows on the card (`walk_layout`)."""
    booster, inner, valid = trained(name)
    rows = torch.from_numpy(valid)
    cols = rows.t().contiguous().t()
    assert cols.stride() == (1, rows.shape[0])
    for tree in booster._inner.models:
        bt = P.binned_tree(tree, CPU)
        assert torch.equal(P.tree_leaf_walk_binned(bt, cols),
                           P.tree_leaf_walk_binned(bt, rows))


def test_a_tree_past_the_record_is_refused_by_name():
    tree = Tree(P.WALK_MAX_NODES + 2)
    with pytest.raises(LightGBMError, match="at most 32768 leaves"):
        P.walk_records(tree)
    tree = Tree(P.WALK_MAX_NODES + 1)
    tree.left_child[:] = -1
    tree.right_child[:] = -2
    recs, _ = P.walk_records(tree)
    assert recs.shape == (P.WALK_MAX_NODES, 4)


def test_the_record_layout():
    """One bundled numeric node with a NaN bin, read back field by
    field as the kernel reads it."""
    tree = Tree(2)
    tree.decision_type[0] = 2 | (2 << 2)      # default left, NaN missing
    tree.node_group[0], tree.node_offset[0] = 5, 100
    tree.node_num_bin[0], tree.node_bundled[0] = 20, True
    tree.node_default_bin[0], tree.node_nan_bin[0] = 0, 19
    tree.threshold_in_bin[0] = 7
    tree.left_child[0], tree.right_child[0] = -1, -2
    recs, _ = P.walk_records(tree)
    x, y, z, w = recs.view(np.uint32)[0].astype(np.int64)
    assert x & ((1 << P.WALK_GROUP_BITS) - 1) == 5
    assert x & P.WALK_DEFAULT_LEFT and not x & P.WALK_CAT
    # out of range the decode gives bin 0 <= 7: left
    assert x & P.WALK_OUT_LEFT and not x & P.WALK_NONE_LEFT
    assert (y & 0xFFFF, y >> 16) == (100, 19)
    assert (z & 0xFFFF, z >> 16) == (7, 19)
    assert w == 0xFFFEFFFF
    got = P.walk_decide(recs, np.zeros(1, np.uint32), np.zeros(6, int),
                        np.array([99, 100, 107, 108, 119, 120]))
    assert got.tolist() == [True, True, True, False, True, True]
