"""The weighted max_bin-255 run of tests/test_torch_example.py at tree 9,
node 26, where the JAX package splits feature 20 at bin 69 and the port
at bin 68: a tie of the two thresholds' gains in f32, not a fault.

Both packages train advanced_example.py's data (examples/gen_data.py
`binary`, 5,000 x 28 training rows, weights 0.5 / 1, 31 leaves, the
default tpu_hist_bf16) on the CPU. Trees 0-8 and tree 9 above node 26
are the same, so the same rows reach node 26. Each package's own
histogram of those rows (the JAX package's `leaf_histogram`, bf16 hi+lo,
from its own scores and gradients after 9 trees; the port's H from its
own) gives the gains of feature 20's thresholds in f32 in the split
scan's operation order (XLA's cumsum order, `ops/split.py`). In each
package bins 68 and 69 are the top two thresholds and their gains are
within the parity rule's f32 tolerance, 1e-5 * max(1, |gain| + parent
gain) (tests/test_torch_split.py). Bin 69 holds none of the leaf's
rows, so the two thresholds send the same rows left and tie in exact
arithmetic; the growers' own sums (the JAX package's batched one-hot
order, with parent - sibling round-off left in empty bins, against the
port's) break the tie differently, and a valid row between the two
thresholds goes left in one package and right in the other. Run with -s
to print the four gains.
"""
import importlib.util
import pathlib

import numpy as np
import torch

import jax.numpy as jnp

import lightgbm_tpu as jlgb
import lightgbm_tpu_torch as tlgb
from lightgbm_tpu.ops import histogram as jh
from lightgbm_tpu.ops import predict as jpredict
from lightgbm_tpu_torch.ops.histogram import leaf_histogram
from lightgbm_tpu_torch.ops.split import (K_EPSILON, leaf_split_gain,
                                          xla_cumsum)

torch.set_num_threads(1)
EXAMPLES = pathlib.Path(__file__).resolve().parent.parent / "examples"
PARAMS = {"boosting_type": "gbdt", "objective": "binary",
          "metric": "binary_logloss", "num_leaves": 31, "verbose": -1}
TREE, NODE, FEATURE = 9, 26, 20
CHUNK = 512


def example_data(root):
    spec = importlib.util.spec_from_file_location(
        "gen_data", EXAMPLES / "gen_data.py")
    gen = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(gen)
    gen.HERE = str(root)
    gen.binary()
    train = np.loadtxt(root / "binary_classification" / "binary.train",
                       delimiter="\t")
    y, x = train[:, 0], train[:, 1:]
    return x, y, np.where(np.arange(len(y)) % 3 == 0, 0.5, 1.0)


def subtree_leaves(tree, node):
    out, stack = [], [node]
    while stack:
        k = stack.pop()
        if k < 0:
            out.append(~k)
        else:
            stack += [tree.left_child[k], tree.right_child[k]]
    return out


def threshold_gains(hist):
    """Gains of every threshold t of one feature's [B, 3] f32 histogram,
    no missing values: left = XLA-order inclusive sums up to t, right =
    totals - left, with K_EPSILON as the scan adds it; returns (gains
    [B - 1] minus the parent's, parent gain)."""
    h = torch.from_numpy(np.array(hist, np.float32))
    tot = h.sum(0, dtype=torch.float64).float()
    eps = torch.tensor(K_EPSILON, dtype=torch.float32)
    zero = torch.tensor(0.0)
    pg, ph = tot[0], tot[1] + 2.0 * eps
    shift = leaf_split_gain(pg, ph, zero, zero)
    scan = xla_cumsum(h.t()).t()
    lg, lh = scan[:-1, 0], scan[:-1, 1] + eps
    gains = (leaf_split_gain(lg, lh, zero, zero)
             + leaf_split_gain(pg - lg, ph - lh, zero, zero))
    return (gains - shift).numpy(), float(shift)


def test_tree9_node26_is_a_gain_tie_in_both_packages(tmp_path):
    x, y, w = example_data(tmp_path)
    n = len(y)
    jds, tds = jlgb.Dataset(x, y, weight=w), tlgb.Dataset(x, y, weight=w)
    jb = jlgb.train(dict(PARAMS), jds, TREE + 1)
    tb = tlgb.train(dict(PARAMS), tds, TREE + 1, device="cpu")
    jt, tt = jb._inner.models[TREE], tb._inner.models[TREE]
    for a, b in zip(jb._inner.models[:TREE], tb._inner.models[:TREE]):
        assert np.array_equal(a.split_feature, b.split_feature)
        assert np.array_equal(a.threshold_in_bin, b.threshold_in_bin)
    assert np.array_equal(jt.split_feature[:NODE], tt.split_feature[:NODE])
    assert np.array_equal(jt.threshold_in_bin[:NODE],
                          tt.threshold_in_bin[:NODE])
    assert jt.split_feature_inner[NODE] == tt.split_feature_inner[NODE] \
        == FEATURE
    picked = {"jax": int(jt.threshold_in_bin[NODE]),
              "port": int(tt.threshold_in_bin[NODE])}
    assert set(picked.values()) <= {68, 69}

    binned = jds._inner.binned
    assert np.array_equal(binned, tds._inner.binned)
    leaf = np.asarray(jpredict.predict_leaf_binned(jt.to_device(),
                                                   jnp.asarray(binned)))
    at = np.isin(leaf, subtree_leaves(jt, NODE))
    b = jds._inner.max_num_bin()

    # each package's gradients from its own f32 scores after 9 trees (a
    # run of 9 rounds grows the same 9 trees)
    jgb = jlgb.train(dict(PARAMS), jds, TREE)._inner
    tgb = tlgb.train(dict(PARAMS), tds, TREE, device="cpu")._inner
    jg, jhess = (np.asarray(v)[:n] for v in jgb.objective.get_gradients(
        jgb._score[0]))
    tg, thess = (v.numpy() for v in tgb.objective.get_gradients(
        tgb._score[0]))
    pad = -(-n // CHUNK) * CHUNK - n
    jw3 = np.stack([jg, jhess, np.ones(n)], 1).astype(np.float32) \
        * at[:, None]
    hist_j = np.asarray(jh.leaf_histogram(
        jnp.asarray(np.pad(binned, ((0, pad), (0, 0)))),
        jnp.asarray(np.pad(jw3, ((0, pad), (0, 0)))), b, chunk=CHUNK,
        bf16=True))[FEATURE]
    rows = torch.from_numpy(np.flatnonzero(at).astype(np.int32))
    tw3 = torch.from_numpy(np.stack([tg, thess, np.ones(n)], 1).astype(
        np.float32))
    hist_t = leaf_histogram(torch.from_numpy(binned), tw3, b, rows=rows,
                            n_rows=len(rows), bf16=True)[FEATURE].numpy()
    assert np.array_equal(hist_j[:, 2], hist_t[:, 2])
    # no row of the leaf is in bin 69: both thresholds send the same rows
    # left, so their gains tie in exact arithmetic
    assert hist_j[69, 2] == 0 and hist_j[68, 2] > 0

    for label, hist in (("jax", hist_j), ("port", hist_t)):
        gains, parent = threshold_gains(hist)
        top = np.argsort(-gains, kind="stable")[:2]
        g68, g69 = float(gains[68]), float(gains[69])
        print("tree %d node %d, %s histogram: gain at bin 68 %.9g, at bin "
              "69 %.9g (difference %.3g, relative %.3g); picked %d"
              % (TREE, NODE, label, g68, g69, g69 - g68,
                 abs(g69 - g68) / abs(g69), picked[label]))
        assert sorted(top.tolist()) == [68, 69]
        assert abs(g68 - g69) <= 1e-5 * max(1.0, abs(g69) + parent)

