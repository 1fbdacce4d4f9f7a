"""TreeSHAP feature contributions, vectorized over rows: the port's own
copy of `lightgbm_tpu/shap.py` (`predict_contrib` :161), numpy on the
host over the port's `Tree` (the JAX module imports nothing of JAX
either, but the port imports nothing of the JAX package).

Re-implements the reference's `Tree::PredictContrib` path
(`src/io/tree.cpp:522-633`, the Lundberg & Lee TreeSHAP recursion with the
EXTEND/UNWIND path algebra — validated against brute-force Shapley
enumeration in tests). The reference recurses once per ROW per tree; here
the key observation is that the recursion's branching structure is
row-independent — only the hot/cold ("one") fractions differ per row — so
ONE walk of the tree carries [num_rows] vectors through the path algebra,
replacing the O(rows) Python recursions per tree with numpy elementwise
ops (100-1000x at MSLR/Higgs scale).

Output layout matches the reference / python-package: per row,
`num_features + 1` values per model-per-iteration (last column is the
expected value / bias).
"""
from __future__ import annotations

from typing import List

import numpy as np

from . import log
from .binning import MISSING_NAN, MISSING_ZERO
from .tree import Tree


def _decision_vec(tree: Tree, node: int, data: np.ndarray) -> np.ndarray:
    """Vectorized go-left decision of one node for all rows [n]."""
    fval = data[:, tree.split_feature[node]]
    if tree.is_categorical_node(node):
        idx = int(tree.threshold[node])
        lo, hi = tree.cat_boundaries[idx], tree.cat_boundaries[idx + 1]
        words = tree.cat_threshold[lo:hi]
        v = np.where(np.isnan(fval), -1, fval).astype(np.int64)
        word_i = v // 32
        valid = (v >= 0) & (word_i < len(words))
        bits = np.zeros(len(fval), bool)
        if len(words):
            wi = np.clip(word_i, 0, len(words) - 1)
            bits = (words[wi] >> (v % 32).astype(np.uint32)) & 1 == 1
        return valid & bits
    mt = tree.missing_type_node(node)
    if mt == MISSING_NAN:
        is_missing = np.isnan(fval)
    elif mt == MISSING_ZERO:
        is_missing = np.isnan(fval) | (np.abs(fval) <= 1e-35)
    else:
        is_missing = np.zeros(len(fval), bool)
    numeric = fval <= tree.threshold[node]
    return np.where(is_missing, tree.default_left_node(node), numeric)


def _tree_shap_batch(tree: Tree, data: np.ndarray, phi: np.ndarray) -> None:
    """Accumulate one tree's SHAP values for ALL rows into
    phi[n, num_features + 1]."""
    n = data.shape[0]
    counts = tree.leaf_count[:tree.num_leaves].astype(np.float64)
    total_count = max(counts.sum(), 1.0)
    # bias = count-weighted expectation of the tree output (efficiency:
    # sum(phi) == f(x) exactly)
    phi[:, -1] += float((tree.leaf_value[:tree.num_leaves] * counts).sum()
                        / total_count)
    if tree.num_leaves <= 1:
        return

    def cnt(node: int) -> float:
        return float(tree.leaf_count[~node]) if node < 0 \
            else float(tree.internal_count[node])

    go_left_cache = {}

    def rec(node: int, ud: int, m_d: List[int], m_z: List[np.ndarray],
            m_o: List[np.ndarray], m_w: List[np.ndarray],
            pz: np.ndarray, po: np.ndarray, pf: int) -> None:
        # copy the path state (EXTEND mutates it)
        m_d = list(m_d[:ud]) + [pf]
        m_z = [a.copy() for a in m_z[:ud]] + [pz]
        m_o = [a.copy() for a in m_o[:ud]] + [po]
        m_w = [a.copy() for a in m_w[:ud]] + [
            np.ones(n) if ud == 0 else np.zeros(n)]
        # EXTEND (tree.cpp:560-575), elementwise over rows
        for i in range(ud - 1, -1, -1):
            m_w[i + 1] += po * m_w[i] * (i + 1) / (ud + 1)
            m_w[i] = pz * m_w[i] * (ud - i) / (ud + 1)

        if node < 0:
            leaf_value = float(tree.leaf_value[~node])
            for i in range(1, ud + 1):
                # UNWOUND PATH SUM (tree.cpp:599-615)
                one = m_o[i]
                zero = m_z[i]
                nn = m_w[ud].copy()
                total = np.zeros(n)
                for j in range(ud - 1, -1, -1):
                    safe_one = np.where(one != 0, one, 1.0)
                    tmp = nn * (ud + 1) / ((j + 1) * safe_one)
                    with_one = tmp
                    with_zero = m_w[j] / (zero * (ud - j) / (ud + 1))
                    total += np.where(one != 0, with_one, with_zero)
                    nn = m_w[j] - tmp * zero * (ud - j) / (ud + 1)
                phi[:, m_d[i]] += total * (one - zero) * leaf_value
            return

        f = int(tree.split_feature[node])
        if node not in go_left_cache:
            go_left_cache[node] = _decision_vec(tree, node, data)
        go_left = go_left_cache[node]
        left, right = int(tree.left_child[node]), int(tree.right_child[node])
        denom = max(cnt(node), 1.0)
        iz = np.ones(n)
        io = np.ones(n)
        pi_found = -1
        for i in range(1, ud + 1):
            if m_d[i] == f:
                pi_found = i
                break
        if pi_found >= 0:
            iz = m_z[pi_found].copy()
            io = m_o[pi_found].copy()
            # UNWIND (tree.cpp:577-597), elementwise over rows
            one = m_o[pi_found]
            zero = m_z[pi_found]
            nn = m_w[ud].copy()
            for j in range(ud - 1, -1, -1):
                safe_one = np.where(one != 0, one, 1.0)
                new_w_one = nn * (ud + 1) / ((j + 1) * safe_one)
                new_w_zero = m_w[j] * (ud + 1) / (zero * (ud - j))
                tmp = m_w[j].copy()
                m_w[j] = np.where(one != 0, new_w_one, new_w_zero)
                nn = tmp - m_w[j] * zero * (ud - j) / (ud + 1)
            for j in range(pi_found, ud):
                m_d[j] = m_d[j + 1]
                m_z[j] = m_z[j + 1]
                m_o[j] = m_o[j + 1]
                # weights stay in place
            m_d = m_d[:ud]
            m_z = m_z[:ud]
            m_o = m_o[:ud]
            m_w = m_w[:ud]
            ud -= 1

        # each child is visited once; the per-row hot/cold split lives in
        # the "one" fraction: rows that went to this child carry io, the
        # rest 0 (the reference's hot/cold recursion collapses into this)
        for child, went in ((left, go_left), (right, ~go_left)):
            cz = cnt(child) / denom
            rec(child, ud + 1, m_d, m_z, m_o, m_w,
                cz * iz, np.where(went, io, 0.0), f)

    rec(0, 0, [-1], [np.ones(n)], [np.ones(n)], [np.ones(n)],
        np.ones(n), np.ones(n), -1)


def _tree_shap(tree: Tree, row: np.ndarray, phi: np.ndarray) -> None:
    """Single-row convenience wrapper over the batched recursion."""
    out = phi[None, :].copy()
    _tree_shap_batch(tree, row[None, :], out)
    phi[:] = out[0]


def predict_contrib(booster, data: np.ndarray, num_iteration: int = -1) -> np.ndarray:
    """SHAP contributions for every row (reference: PredictContrib path via
    c_api predict_type=C_API_PREDICT_CONTRIB)."""
    data = np.atleast_2d(np.asarray(data, np.float64))
    n = data.shape[0]
    nf = booster.max_feature_idx + 1
    k = booster.num_tree_per_iteration
    total = len(booster.models)
    if num_iteration > 0:
        total = min(total, num_iteration * k)
    if any(getattr(booster.models[i], "is_linear", False)
           for i in range(total)):
        raise log.LightGBMError(
            "predict_contrib does not support linear_tree models: the "
            "TreeSHAP recursion attributes constant leaf outputs only "
            "and would silently drop the per-leaf linear terms; use "
            "predict() or retrain with linear_tree=false")
    out = np.zeros((n, k, nf + 1))
    for i in range(total):
        tree = booster.models[i]
        cls = i % k
        _tree_shap_batch(tree, data, out[:, cls])
    if booster.average_output and total > 0:
        out /= max(total // k, 1)
    out[:, :, -1] += booster.init_score_bias
    return out.reshape(n, k * (nf + 1)) if k > 1 else out.reshape(n, nf + 1)
