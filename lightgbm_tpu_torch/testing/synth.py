"""Seeded synthetic forests and rows.

A machine without JAX cannot train a model to serve, so the card's smoke
run and the tests make one from a seed instead:

- `synthetic_rows` draws HIGGS-shaped rows (standard-normal numeric
  features with a share of NaN and exact zeros, integer categories);
- `synthetic_forest_text` grows leaf-wise trees over such rows and writes
  them as model text in the format `GBDT.save_model_to_string` writes:
  thresholds are quantiles of the rows that reach the node (so every
  region is reached), numeric nodes mix the three missing types and both
  default directions, categorical nodes carry bitsets, and the objective
  is `binary sigmoid:1`;
- `edge_case_rows` builds rows that reach chosen nodes with the values a
  walk is easiest to get wrong there: the node's f32 threshold and one
  ulp either side, NaN, exact and signed zero, +-1e-36 and 1e-35, and
  negative, non-member and beyond-the-bitset categories.

- `grid_edge_rows` fills every cell with a value the fixed-point codes
  of `tpu_predict_quantize=int8` are easiest to get wrong on: one of
  the column's f32 split thresholds (a grid bound) or one ulp either
  side, +-0, subnormals, +-inf and NaN.

`edge_case_rows` reads only `num_leaves`, `split_feature`, `threshold`,
`decision_type`, `left_child`, `right_child`, `cat_boundaries` and
`cat_threshold`, so it takes the trees of either package.

`synth_higgs` draws labelled HIGGS-shaped training data with the
generator of the repo's bench.py, for training runs. `rank_data` draws
the repo's ranking protocol (fixed-length queries, graded labels), and
`mslr_like_groups` the query layout of MSLR-WEB30K (ragged lengths up
to 1,251 docs, labels 0-4 mostly 0 and 1) from its published shape.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np

from ..binning import MISSING_NAN, MISSING_NONE, MISSING_ZERO
from ..convert import booster_from_numpy
from ..tree import Tree

CARDINALITY = 40          # categories 0..39: bitsets of one or two words
_SAMPLE_ROWS = 4096       # rows a synthetic tree is grown over
_MIN_SPLIT_ROWS = 4


def synthetic_rows(seed: int, n: int, num_features: int,
                   cat_features: int = 0) -> np.ndarray:
    """[n, num_features] f32; the last `cat_features` columns hold
    integer categories, the others N(0, 1) with 2% NaN and 2% zeros."""
    rng = np.random.RandomState(seed)
    x = rng.standard_normal((n, num_features)).astype(np.float32)
    numeric = num_features - cat_features
    u = rng.random_sample((n, numeric))
    block = x[:, :numeric]
    block[u < 0.02] = np.nan
    block[(u >= 0.02) & (u < 0.04)] = 0.0
    x[:, numeric:] = rng.randint(0, CARDINALITY, (n, cat_features))
    return x


def _numeric_left(vals, thr, missing, default_left):
    nan = np.isnan(vals)
    is_missing = ((missing == MISSING_NAN) & nan) | (
        (missing == MISSING_ZERO) & (nan | (np.abs(vals) <= 1e-35)))
    return np.where(is_missing, default_left,
                    np.where(nan, 0.0, vals) <= thr)


def _grow_tree(rng, sample, num_leaves, num_features, cat_features,
               binned=None):
    """One leaf-wise tree as a dict of Tree attribute arrays: the leaf
    to split is drawn in proportion to its rows, as a best-first grower
    keeps splitting where the data is. `binned` = (grids, missing): each
    numeric threshold is moved up to the feature's next grid bound and
    each numeric node takes its feature's missing type."""
    first_cat = num_features - cat_features
    leaves = [np.arange(sample.shape[0])]
    parent = [None]                       # leaf -> (node, is_left)
    node_arrays: Dict[str, list] = {k: [] for k in (
        "split_feature", "threshold", "decision_type", "left_child",
        "right_child", "split_gain", "internal_value", "internal_count")}
    cat_boundaries, cat_words = [0], []
    while len(leaves) < num_leaves:
        counts = np.array([len(r) for r in leaves], np.float64)
        counts[counts < _MIN_SPLIT_ROWS] = 0
        if not counts.any():
            break
        leaf = rng.choice(len(leaves), p=counts / counts.sum())
        rows = leaves[leaf]
        feat = rng.randint(num_features)
        vals = sample[rows, feat]
        if feat >= first_cat:
            present = np.unique(vals)
            members = present[rng.random_sample(len(present)) < 0.5]
            words = Tree._bitset(members.astype(np.int64))
            threshold = float(len(cat_boundaries) - 1)    # the cat_idx
            cat_words.extend(int(w) for w in words)
            cat_boundaries.append(cat_boundaries[-1] + len(words))
            decision = 1 | (MISSING_NAN << 2)
            go_left = np.isin(vals, members)
        else:
            missing = rng.choice([MISSING_NONE, MISSING_ZERO, MISSING_NAN])
            default_left = bool(rng.randint(2))
            finite = vals[~np.isnan(vals)]
            if finite.size == 0:
                continue
            threshold = float(np.quantile(finite, rng.uniform(0.2, 0.8),
                                          method="lower"))
            if binned is not None:
                grid = binned[0][feat]
                threshold = float(grid[min(np.searchsorted(grid, threshold),
                                           len(grid) - 1)])
                missing = binned[1][feat]
            decision = (2 if default_left else 0) | (int(missing) << 2)
            go_left = _numeric_left(vals, threshold, missing, default_left)
        node = len(node_arrays["split_feature"])
        if parent[leaf] is not None:
            p, is_left = parent[leaf]
            node_arrays["left_child" if is_left else "right_child"][p] = node
        right = len(leaves)
        for key, value in (("split_feature", feat), ("threshold", threshold),
                           ("decision_type", decision),
                           ("left_child", ~leaf), ("right_child", ~right),
                           ("split_gain", rng.exponential(10.0)),
                           ("internal_value", rng.normal(0.0, 0.05)),
                           ("internal_count", len(rows))):
            node_arrays[key].append(value)
        leaves[leaf], parent[leaf] = rows[go_left], (node, True)
        leaves.append(rows[~go_left])
        parent.append((node, False))
    nl = len(leaves)
    tree = {k: np.asarray(v) for k, v in node_arrays.items()}
    tree["split_feature_inner"] = tree["split_feature"]
    tree.update(
        num_leaves=nl, shrinkage=1.0,
        leaf_value=rng.normal(0.0, 0.05, nl),
        leaf_count=np.array([len(r) for r in leaves]),
        num_cat=len(cat_boundaries) - 1,
        cat_boundaries=np.asarray(cat_boundaries),
        cat_threshold=np.asarray(cat_words, np.uint32))
    return tree


def synthetic_forest_text(seed: int, num_trees: int, num_leaves: int,
                          num_features: int, cat_features: int = 0,
                          max_bin: int = 0) -> str:
    """Model text of a seeded binary forest (see the module docstring).
    With `max_bin`, the forest has the two properties of a model trained
    at that max_bin that the fixed-point serving layout needs: each
    numeric feature's thresholds come from at most max_bin - 1 bin bounds
    (quantiles of the sample) and its nodes share one missing type; the
    trees' shapes and leaves are drawn as without it."""
    rng = np.random.RandomState(seed)
    sample = synthetic_rows(seed + 1, _SAMPLE_ROWS, num_features,
                            cat_features)
    binned = None
    if max_bin:
        side = np.random.RandomState(seed + 7919)
        levels = np.linspace(0.0, 1.0, max_bin + 1)[1:-1]
        grids = []
        for f in range(num_features):
            finite = sample[:, f][~np.isnan(sample[:, f])]
            grids.append(np.unique(np.quantile(finite, levels,
                                               method="lower")))
        missing = side.choice([MISSING_NONE, MISSING_ZERO, MISSING_NAN],
                              num_features)
        binned = (grids, missing)
    trees = [_grow_tree(rng, sample, num_leaves, num_features, cat_features,
                        binned)
             for _ in range(num_trees)]
    header = {"num_class": 1, "num_tree_per_iteration": 1,
              "max_feature_idx": num_features - 1,
              "objective": "binary sigmoid:1"}
    return booster_from_numpy(header, trees, device="cpu").model_to_string()


# ----------------------------------------------------------------------
def _parents(tree) -> Dict[int, tuple]:
    out = {}
    for node in range(tree.num_leaves - 1):
        for child, left in ((tree.left_child[node], True),
                            (tree.right_child[node], False)):
            if child >= 0:
                out[int(child)] = (node, left)
    return out


def _cat_words(tree, node) -> np.ndarray:
    idx = int(tree.threshold[node])
    lo, hi = tree.cat_boundaries[idx], tree.cat_boundaries[idx + 1]
    return np.asarray(tree.cat_threshold[lo:hi], np.uint32)


def _members(words) -> List[int]:
    return [w * 32 + b for w in range(len(words)) for b in range(32)
            if (int(words[w]) >> b) & 1]


def _f32_threshold(tree, node) -> np.float32:
    fmax = np.finfo(np.float32).max
    return np.float32(np.clip(tree.threshold[node], -fmax, fmax))


def _steer(row, tree, node, left: bool) -> None:
    """Set the row's value at `node`'s feature so the node sends it
    `left` (best effort: a later ancestor on the same feature wins)."""
    f = int(tree.split_feature[node])
    if tree.decision_type[node] & 1:
        members = _members(_cat_words(tree, node))
        row[f] = float(members[0]) if left and members else -1.0
    else:
        thr = _f32_threshold(tree, node)
        row[f] = thr if left else np.nextafter(thr, np.float32(np.inf))


def _special_values(tree, node) -> List[float]:
    if tree.decision_type[node] & 1:
        words = _cat_words(tree, node)
        members = _members(words)
        outside = [c for c in range(len(words) * 32) if c not in members]
        nbits = float(len(words) * 32)
        return ([float(members[0])] if members else []) + (
            [float(outside[0])] if outside else []) + [
            -1.0, -0.5, nbits, nbits + 5.0, 1000.0, np.nan]
    thr = _f32_threshold(tree, node)
    return [thr, np.nextafter(thr, np.float32(np.inf)),
            np.nextafter(thr, np.float32(-np.inf)), np.nan, 0.0, -0.0,
            1e-36, -1e-36, 1e-35]


def edge_case_rows(trees, num_features: int, seed: int, n: int,
                   cat_features: int = 0) -> np.ndarray:
    """[n, num_features] f32 rows, each steered down to a randomly
    chosen internal node and given one of its special values there."""
    rng = np.random.RandomState(seed)
    rows = synthetic_rows(seed + 1, n, num_features, cat_features)
    split_trees = [t for t in trees if t.num_leaves > 1]
    if not split_trees:
        return rows
    parents = {}
    for r in range(n):
        ti = rng.randint(len(split_trees))
        tree = split_trees[ti]
        if ti not in parents:
            parents[ti] = _parents(tree)
        node = rng.randint(tree.num_leaves - 1)
        path, cur = [], node
        while cur in parents[ti]:
            cur, left = parents[ti][cur]
            path.append((cur, left))
        for anc, left in reversed(path):
            _steer(rows[r], tree, anc, left)
        values = _special_values(tree, node)
        rows[r, int(tree.split_feature[node])] = values[
            rng.randint(len(values))]
    return rows


def grid_edge_rows(trees, num_features: int, seed: int,
                   n: int) -> np.ndarray:
    """[n, num_features] f32 rows whose every cell is one of its column's
    edge values: a numeric split threshold of the forest (f32, clipped to
    the f32 range) or its nextafter neighbours, +-0, +-1e-40, 1e-36,
    +-inf, NaN, +-1 or a small integer category."""
    rng = np.random.RandomState(seed)
    fmax = np.finfo(np.float32).max
    special = np.array([0.0, -0.0, 1e-40, -1e-40, 1e-36, np.inf, -np.inf,
                        np.nan, 1.0, -1.0, 0.0, 1.0, 2.0, 3.0], np.float32)
    cols = []
    for f in range(num_features):
        thr = np.asarray(
            [np.clip(t.threshold[i], -fmax, fmax) for t in trees
             for i in range(t.num_leaves - 1)
             if int(t.split_feature[i]) == f
             and not int(t.decision_type[i]) & 1], np.float32)
        pool = np.concatenate([special, thr,
                               np.nextafter(thr, np.float32(np.inf)),
                               np.nextafter(thr, np.float32(-np.inf))])
        cols.append(rng.choice(pool.astype(np.float32), n))
    return np.stack(cols, axis=1)


def synth_higgs(n: int, f: int = 28, seed: int = 0):
    """HIGGS-shaped training data, the generator of the repo's bench.py
    (`synth_higgs`): dense N(0, 1) f32 features and a binary label from a
    nonlinear score plus logistic noise. Returns (X [n, f] f32, y [n] f32)."""
    rng = np.random.RandomState(seed)
    x = rng.randn(n, f).astype(np.float32)
    score = (x[:, 0] * 1.2 - x[:, 1] + 0.8 * x[:, 2] * x[:, 3]
             + 0.5 * np.abs(x[:, 4]) + 0.3 * x[:, 5] ** 2)
    y = (score + rng.logistic(size=n) > 0.5).astype(np.float32)
    return x, y


def rank_data(n: int, f: int = 28, qlen: int = 100, seed: int = 0):
    """The ranking protocol's data, the generator of the repo's
    scripts/measure_parity_sweep.py (`_rank_data`): dense N(0, 1) f32
    features, queries of `qlen` docs, and labels 1-4 from each query's
    rank of a noisy score. Returns (X [n, f] f32, y [n] f32, number of
    queries, qlen); rows past the last whole query keep label 0."""
    rng = np.random.RandomState(seed)
    x = rng.randn(n, f).astype(np.float32)
    score = x[:, 0] * 1.5 + x[:, 1] - 0.5 * x[:, 2] * x[:, 3]
    nq = n // qlen
    y = np.zeros(n, np.float32)
    for q in range(nq):
        s = slice(q * qlen, (q + 1) * qlen)
        ranks = np.argsort(np.argsort(-(score[s] + rng.randn(qlen))))
        y[s] = np.clip(4 - ranks // 25, 0, 4)
    return x, y, nq, qlen


# MSLR-WEB30K: 31,531 queries, 3,771,125 docs (mean 119.6 a query, the
# longest 1,251), relevance 0-4 in about these shares
MSLR_QUERIES = 31_531
MSLR_MAX_DOCS = 1_251
_MSLR_LABEL_SHARE = (0.515, 0.325, 0.134, 0.018, 0.008)


def mslr_like_groups(seed: int = 0):
    """An MSLR-WEB30K-shaped query layout: 31,531 queries of log-normal
    lengths, mean about 120, clipped to 1-1,251; the first query exactly
    1,251 docs, then three empty queries and four of one doc. Returns
    (sizes int64 [31,531], labels int32 [sum of sizes] in 0-4)."""
    rng = np.random.RandomState(seed)
    sizes = np.clip(np.rint(rng.lognormal(np.log(100.0), 0.6,
                                          MSLR_QUERIES)),
                    1, MSLR_MAX_DOCS).astype(np.int64)
    sizes[0] = MSLR_MAX_DOCS
    sizes[1:4] = 0
    sizes[4:8] = 1
    labels = rng.choice(5, size=int(sizes.sum()),
                        p=_MSLR_LABEL_SHARE).astype(np.int32)
    return sizes, labels
