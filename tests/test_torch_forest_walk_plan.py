"""K1's node records, its two launch orders and its launch plan
(lightgbm_tpu_torch/ops/predict.py; the CUDA kernels are held against
the plain version on the card by chip_smoke.py), on the CPU.

- The 16-byte node records (`node_records`) decode back to the Forest's
  [T, M] arrays bit for bit, on seeded forests with categorical nodes,
  every missing type, trees of different sizes (padded nodes), a
  one-leaf tree and f16 leaves (`to_f16` keeps the f32 stack's records).
- A scalar replay of the kernel's walk over the records, summed in the
  order of either mode (trees mode: a pass of `chunk` trees' values,
  then one thread adds them in tree order; rows mode: a row's trees
  chunk by chunk), equals `forest_value_walk_plain` bitwise, f16
  batches of 10 and linear leaves included; the leaves it reaches equal
  the plain walk's.
- That replay agrees with the JAX package's `predict_forest_raw` within
  tests/test_torch_predict.py's 1e-5 * max(1, |ref|) (an f32 sum in
  another order), and its f16 mode equals `predict_forest_f16` bitwise
  on rows without an infinite value (tests/test_torch_quant_serve.py
  says why).
- `walk_plan` picks the mode by the row count and stays within the
  card's shared memory for small, large, wide and one-tree forests; a
  linear forest's rows mode stages nothing.
- The wrappers refuse by name a forest whose feature index or node
  count does not fit the record.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightgbm_tpu.ops import predict as jp
from lightgbm_tpu.serving.forest import _stacks_to_f16
from lightgbm_tpu.tree import Tree as JaxTree
import lightgbm_tpu_torch as tlgb
from lightgbm_tpu_torch.binning import MISSING_NAN, MISSING_ZERO
from lightgbm_tpu_torch.ops import predict as tp
from lightgbm_tpu_torch.testing.synth import (edge_case_rows,
                                              synthetic_forest_text,
                                              synthetic_rows)
from lightgbm_tpu_torch.tree import Tree

torch.set_num_threads(1)
CPU = torch.device("cpu")
F32_TINY = np.float32(np.finfo(np.float32).tiny)


def decode_records(nodes):
    """The [T, M] arrays K1's records hold: the threshold's bits, the
    feature in the low 24 bits of the second word with the decision
    byte above them, the left child, the right child."""
    word = nodes[..., 1].to(torch.int64) & 0xFFFFFFFF
    return dict(
        split_feature=(word & tp.RECORD_MAX_FEATURE).to(torch.int32),
        threshold=nodes[..., 0].contiguous().view(torch.float32),
        decision=(word >> tp.RECORD_FEATURE_BITS).to(torch.uint8),
        left_child=nodes[..., 2].contiguous(),
        right_child=nodes[..., 3].contiguous())


def _trees(text):
    return tlgb.Booster(model_str=text, device="cpu")._inner.models


def _with_stub(trees):
    """The trees with a one-leaf tree third, so the stack pads it."""
    stub = Tree(1)
    stub.leaf_value[0] = -0.125
    return trees[:2] + [stub] + trees[2:]


def _linear(trees, seed, nf, k=3):
    """Copies of the trees with k seeded linear slots a leaf (the last
    one padded with column -1 on every other leaf)."""
    rng = np.random.RandomState(seed)
    out = []
    for t in trees:
        t = Tree.from_string(t.to_string())
        feats = rng.randint(0, nf, (t.num_leaves, k)).astype(np.int32)
        feats[::2, -1] = -1
        t.leaf_coeff = rng.normal(0.0, 0.3, (t.num_leaves, k))
        t.leaf_features = feats
        out.append(t)
    return out


@pytest.fixture(scope="module")
def forests():
    """name -> (trees, rows [N, F] f32): seeded forests with every
    missing type, categorical bitsets of one and two words, a one-leaf
    tree, trees of 31 and 7 leaves stacked together, and a linear one;
    half their rows steered onto thresholds and special values."""
    plain = _trees(synthetic_forest_text(3, 23, 31, 10))
    cat = _trees(synthetic_forest_text(4, 16, 31, 10, 3))
    small = _trees(synthetic_forest_text(8, 12, 7, 10, 2))
    out = {}
    for name, trees, cats in (
            ("numeric", _with_stub(plain), 0),
            ("categorical", _with_stub(cat), 3),
            ("mixed_sizes", cat[:6] + small + cat[6:], 3),
            ("linear", _linear(plain[:12], 9, 10), 0)):
        rows = np.concatenate([
            synthetic_rows(5, 150, 10, cats),
            edge_case_rows(trees, 10, 6, 250, cats)]).astype(np.float32)
        out[name] = (trees, rows)
    return out


NAMES = ["numeric", "categorical", "mixed_sizes", "linear"]


@pytest.mark.parametrize("name", NAMES)
def test_records_decode_to_the_forest_arrays(forests, name):
    trees, _ = forests[name]
    forest = tp.stack_trees(trees, CPU)
    t, m = forest.split_feature.shape
    assert forest.nodes.shape == (t, m, 4)
    assert forest.nodes.dtype == torch.int32
    decoded = decode_records(forest.nodes)
    for field, got in decoded.items():
        ref = getattr(forest, field)
        assert got.dtype == ref.dtype, field
        assert torch.equal(got.view(torch.int32) if got.is_floating_point()
                           else got, ref.view(torch.int32)
                           if ref.is_floating_point() else ref), field
    # the padded nodes and the stub's root: children -1, so any row that
    # reached one would land on leaf 0
    real = (torch.arange(m)[None, :]
            < (forest.num_leaves[:, None] - 1).clamp(min=0))
    assert (forest.nodes[..., 2:][~real] == -1).all()
    if name in ("numeric", "categorical"):
        assert (forest.num_leaves == 1).any()
    # every missing type and both kinds of node are in the records
    decision = decoded["decision"].to(torch.int32)[real]
    missing = set(((decision >> 2) & 3).tolist())
    assert {MISSING_NAN, MISSING_ZERO} <= missing
    assert ((decision & 1) == 1).any() == (name in ("categorical",
                                                    "mixed_sizes"))


def test_f16_stack_keeps_the_f32_records(forests):
    trees, _ = forests["categorical"]
    forest = tp.stack_trees(trees, CPU)
    f16 = tp.to_f16(forest)
    assert f16.nodes is forest.nodes
    assert f16.leaf_value.dtype == torch.float16
    assert f16.nbytes() - forest.nbytes() == -2 * forest.leaf_value.numel()


def _leaf_by_records(forest, d, row, t):
    """One row down tree t over the decoded records `d`, as rec_child
    decides: the flushed value, _decide_raw's rules, the bitset test."""
    if int(forest.num_leaves[t]) <= 1:
        return 0
    bounds = forest.cat_boundaries.numpy()[t]
    bits = forest.cat_bitset.numpy()[t].view(np.uint32)
    node = 0
    while node >= 0:
        x = np.float32(row[d["split_feature"][t, node]])
        if abs(x) < F32_TINY:
            x = np.copysign(np.float32(0.0), x)
        thr = d["threshold"][t, node]
        dec = int(d["decision"][t, node])
        if dec & 1:
            left = False
            if not np.isnan(x):
                cat = np.floor(x)
                lo = bounds[int(thr)]
                words = bounds[int(thr) + 1] - lo
                if cat >= 0 and cat < 32 * words:
                    v = int(cat)
                    left = bool((bits[lo + (v >> 5)] >> (v & 31)) & 1)
        else:
            miss = (dec >> 2) & 3
            nan = np.isnan(x)
            is_missing = ((miss == MISSING_NAN and nan)
                          or (miss == MISSING_ZERO
                              and (nan or abs(x) <= np.float32(1e-35))))
            left = (bool(dec & 2) if is_missing
                    else (np.float32(0) if nan else x) <= thr)
        node = int(d["left_child"][t, node] if left
                   else d["right_child"][t, node])
    return ~node


def _replay(forest, x, chunk):
    """[N] f32: the records walked row by row, each tree's value
    (`_tree_values_plain` at the replayed leaves) added in tree order a
    chunk of `chunk` trees at a time, as either mode adds them ("trees":
    a pass's values, then one thread adds them; "rows": a row's trees,
    a shared chunk at a time), f16 leaves in batches of
    QUANT_TREE_BATCH whose count carries over the chunks. Also returns
    the [T, N] leaves."""
    rows = x.numpy()
    nt = forest.num_trees
    d = {k: v.numpy() for k, v in decode_records(forest.nodes).items()}
    leaves = torch.tensor([[_leaf_by_records(forest, d, r, t) for r in rows]
                           for t in range(nt)], dtype=torch.int64)
    vals = tp._tree_values_plain(forest, x, leaves).numpy()
    f16 = forest.leaf_value.dtype == torch.float16
    batch = tp.QUANT_TREE_BATCH
    out = np.zeros(len(rows), np.float32)
    for i in range(len(rows)):
        acc = part = np.float32(0.0)
        in_batch = 0
        for t0 in range(0, nt, chunk):
            for t in range(t0, min(nt, t0 + chunk)):
                v = vals[t, i]
                in_batch += 1
                if f16:
                    part = np.float32(part + v)
                    if in_batch == batch:
                        acc, part, in_batch = np.float32(acc + part), \
                            np.float32(0.0), 0
                else:
                    acc = np.float32(acc + v)
        if f16 and in_batch:
            acc = np.float32(acc + part)
        out[i] = acc
    return torch.from_numpy(out), leaves


# chunks: trees mode's pass of PAIRS_CHUNK trees and a short one, rows
# mode's 4 trees of 255 leaves a buffer and a chunk that splits batches
@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("chunk", [tp.PAIRS_CHUNK, 7, 4, 3])
def test_replayed_orders_equal_the_plain_walk_bitwise(forests, name, chunk):
    trees, rows = forests[name]
    x = torch.from_numpy(rows[::3].copy())
    stacks = [tp.stack_trees(trees, CPU)]
    if name != "linear":
        stacks.append(tp.to_f16(stacks[0]))
    for forest in stacks:
        got, leaves = _replay(forest, x, chunk)
        assert torch.equal(leaves, tp._leaves_plain(forest, x))
        ref = tp.forest_value_walk_plain(forest, x)
        assert torch.equal(got.view(torch.int32), ref.view(torch.int32))


@pytest.mark.parametrize("name", ["numeric", "categorical", "mixed_sizes"])
def test_replay_agrees_with_the_jax_walks(forests, name):
    trees, rows = forests[name]
    x = torch.from_numpy(rows)
    jax_trees = [JaxTree.from_string(t.to_string()) for t in trees]
    xj = jnp.asarray(rows)
    got, _ = _replay(tp.stack_trees(trees, CPU), x, 2048)
    ref = np.asarray(jp.predict_forest_raw(jp.stack_trees_raw(jax_trees),
                                           xj), np.float64)
    assert np.all(np.abs(got.numpy() - ref)
                  <= 1e-5 * np.maximum(1.0, np.abs(ref)))
    got16, _ = _replay(tp.to_f16(tp.stack_trees(trees, CPU)), x, 4)
    mf = _stacks_to_f16(jp.stack_trees_matmul(jax_trees), None)[0]
    ref16 = np.asarray(jp.predict_forest_f16(mf, xj))
    finite = ~np.isinf(rows).any(axis=1)
    assert finite.sum() > 300
    assert np.array_equal(got16.numpy()[finite].view(np.int32),
                          ref16[finite].view(np.int32))


@pytest.mark.parametrize("trees,leaves,features", [
    (1, 2, 1), (10, 7, 10), (500, 255, 28), (500, 255, 40), (10, 63, 968),
    (3, 4096, 28), (2000, 31, 200), (1, 1, 0), (5000, 1024, 5000)])
@pytest.mark.parametrize("n", [1, 7, 512, 513, 32_768, 32_769, 262_144])
def test_plan_picks_the_mode_by_rows_within_shared_memory(trees, leaves,
                                                          features, n):
    m = max(leaves - 1, 1)
    plan = tp.walk_plan(trees, m, features, n)
    assert plan == tp.walk_plan(trees, m, features, n)
    assert 0 <= plan.shared_bytes <= tp.SHARED_BYTES
    assert 32 <= plan.threads <= 512 and plan.threads % 32 == 0
    if n <= tp.TREE_PARALLEL_MAX_ROWS:
        assert plan.mode == "trees"
        assert 1 <= plan.chunk_trees <= min(trees, tp.PAIRS_CHUNK)
        assert plan.shared_bytes == 4 * plan.chunk_trees
        assert plan.threads == min(
            tp.PAIRS_THREADS_FEW if n <= tp.PAIRS_WIDE_ROWS
            else tp.PAIRS_THREADS_MANY, -(-plan.chunk_trees // 32) * 32)
        return
    assert plan.mode == "rows" and plan.threads == tp.ROWS_THREADS
    tree_bytes = m * tp.RECORD_BYTES
    assert plan.chunk_trees * tree_bytes <= tp.CHUNK_BYTES
    # a chunk holds every tree that fits a buffer, none when one does not
    assert plan.chunk_trees == (0 if tree_bytes > tp.CHUNK_BYTES
                                else min(trees,
                                         tp.CHUNK_BYTES // tree_bytes))
    tree_smem = 2 * plan.chunk_trees * tree_bytes
    row_smem = 4 * features * (plan.threads + 1)
    if plan.staged_features >= 0:
        assert plan.staged_features == features
        assert plan.shared_bytes == tree_smem + row_smem
    else:
        assert tree_smem + row_smem > tp.SHARED_BYTES
        assert plan.shared_bytes == tree_smem


def test_main_path_plans():
    """The shapes chip_smoke drives: HIGGS-shaped 500 x 255 forests stage
    4 trees a buffer and their rows; one row walks its trees in
    parallel; a Bosch-wide forest reads its rows from device memory; a
    4,096-leaf tree reads its records from device memory; so does a
    linear forest, its rows too."""
    assert tp.walk_plan(500, 254, 28, 131_072) == tp.WalkPlan(
        "rows", 512, 4, 28, 2 * 4 * 254 * 16 + 4 * 28 * 513)
    assert tp.walk_plan(500, 254, 28, 1) == tp.WalkPlan(
        "trees", 512, 500, -1, 2000)
    assert tp.walk_plan(10, 62, 968, 100_000).staged_features == -1
    assert tp.walk_plan(3, 4095, 28, 262_144).chunk_trees == 0
    # a linear forest's rows mode stages neither rows nor records
    assert tp.walk_plan(10, 254, 28, 131_072, linear=True) == tp.WalkPlan(
        "rows", 512, 0, -1, 0)
    assert tp.walk_plan(10, 254, 28, 1, linear=True) == tp.walk_plan(
        10, 254, 28, 1)


def _oversized(feature):
    t = Tree(2)
    t.split_feature[0] = feature
    t.split_feature_inner[0] = feature
    t.threshold[0] = 0.5
    t.left_child[0], t.right_child[0] = -1, -2
    t.leaf_value[:] = [0.25, -0.25]
    return tp.stack_trees([t], CPU)


def test_wrappers_refuse_a_forest_the_record_cannot_hold():
    fits = _oversized(tp.RECORD_MAX_FEATURE)
    assert fits.nodes is not None
    big = _oversized(tp.RECORD_MAX_FEATURE + 1)
    assert big.nodes is None
    x = torch.zeros((2, 4), dtype=torch.float32)
    for walk, forest in ((tp.forest_value_walk, big),
                         (tp.forest_value_walk_f16, tp.to_f16(big))):
        with pytest.raises(tlgb.LightGBMError,
                           match=r"%s: feature index 16777216 does not fit "
                                 r"the 16-byte node record"
                           % walk.__name__):
            walk(forest, x)
    assert "node count 65536 x 32768" in tp.record_misfit(7, 65536, 32768)
    assert tp.record_misfit(7, 65536, 32767) is None
    assert tp.record_misfit(tp.RECORD_MAX_FEATURE, 1, 1) is None
