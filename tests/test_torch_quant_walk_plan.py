"""QW's node records, its two launch orders and its launch plan
(lightgbm_tpu_torch/ops/predict.py; the CUDA kernels are held against
the plain version on the card by chip_smoke.py), on the CPU.

- QW's 16-byte node records (`quant_records`) decode back, bit for bit,
  to `thr_code` and `lo` on numeric nodes, to the categorical nodes'
  cat_idx and to K1's words 1-3 (feature | decision << 24, left,
  right), on binned forests with categorical nodes, every missing type,
  a one-leaf tree and trees of different sizes (padded nodes).
- A scalar replay of QW's walk over those records, on the codes (the
  raw value at a categorical node), summed in the order of either mode
  (trees mode: a pass of `chunk` trees' values, then one thread adds
  them; rows mode: a row's trees chunk by chunk; f16 leaves in batches
  of QUANT_TREE_BATCH whose count carries over the chunks), equals
  `forest_quant_walk_plain` bitwise, and its leaves the plain walk's.
- That replay equals the JAX package's `predict_forest_quant` bitwise,
  the tolerance tests/test_torch_quant_serve.py holds QW's plain
  version to.
- `walk_plan` with 2-byte values stays within the card's shared memory,
  and stages columns of codes where K1's 4-byte values would not fit.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightgbm_tpu.ops import predict as jp
from lightgbm_tpu.tree import Tree as JaxTree
import lightgbm_tpu_torch as tlgb
from lightgbm_tpu_torch.binning import MISSING_NAN, MISSING_ZERO
from lightgbm_tpu_torch.ops import predict as tp
from lightgbm_tpu_torch.testing.synth import (edge_case_rows,
                                              grid_edge_rows,
                                              synthetic_forest_text,
                                              synthetic_rows)
from lightgbm_tpu_torch.tree import Tree

torch.set_num_threads(1)
CPU = torch.device("cpu")
F32_TINY = np.float32(np.finfo(np.float32).tiny)


def _trees(text):
    return tlgb.Booster(model_str=text, device="cpu")._inner.models


def _with_stub(trees):
    """The trees with a one-leaf tree third, so the stack pads it."""
    stub = Tree(1)
    stub.leaf_value[0] = -0.125
    return trees[:2] + [stub] + trees[2:]


@pytest.fixture(scope="module")
def forests():
    """name -> (trees, rows [N, F] f32): binned seeded forests (at most
    254 thresholds a feature, as a model trained at max_bin 255 has)
    with every missing type, categorical bitsets, a one-leaf tree, and
    trees of 31 and 7 leaves stacked together; rows steered onto the
    thresholds, the grid bounds and special values."""
    plain = _trees(synthetic_forest_text(3, 23, 31, 10, max_bin=255))
    cat = _trees(synthetic_forest_text(4, 16, 31, 10, 3, max_bin=255))
    small = _trees(synthetic_forest_text(8, 12, 7, 10, 2, max_bin=255))
    out = {}
    for name, trees, cats in (("numeric", _with_stub(plain), 0),
                              ("categorical", _with_stub(cat), 3),
                              ("mixed_sizes", cat[:6] + small + cat[6:], 3)):
        rows = np.concatenate([
            synthetic_rows(5, 120, 10, cats),
            edge_case_rows(trees, 10, 6, 150, cats),
            grid_edge_rows(trees, 10, 7, 150)]).astype(np.float32)
        out[name] = (trees, rows)
    return out


NAMES = ["numeric", "categorical", "mixed_sizes"]


def decode(nodes):
    """The fields QW's records hold: word 0 as (thr_code, lo) and as
    f32 bits, the feature and decision of word 1, the children."""
    w0 = nodes[..., 0].to(torch.int64)
    w1 = nodes[..., 1].to(torch.int64) & 0xFFFFFFFF
    thr = w0 & 0xFFFF
    return dict(thr_code=torch.where(thr >= 0x8000, thr - 0x10000,
                                     thr).to(torch.int16),
                lo=(w0 >> 16).to(torch.int16),
                cat_idx=nodes[..., 0].contiguous().view(torch.float32),
                split_feature=(w1 & tp.RECORD_MAX_FEATURE).to(torch.int32),
                decision=(w1 >> tp.RECORD_FEATURE_BITS).to(torch.uint8),
                left_child=nodes[..., 2].contiguous(),
                right_child=nodes[..., 3].contiguous())


@pytest.mark.parametrize("name", NAMES)
def test_records_decode_to_the_quant_fields(forests, name):
    trees, _ = forests[name]
    qf = tp.stack_trees_quant(trees, CPU)
    walk = qf.walk
    t, m = walk.split_feature.shape
    assert qf.nodes.shape == (t, m, 4) and qf.nodes.dtype == torch.int32
    d = decode(qf.nodes)
    is_cat = (walk.decision & 1) != 0
    assert torch.equal(d["thr_code"][~is_cat], qf.thr_code[~is_cat])
    assert torch.equal(d["lo"][~is_cat], qf.lo[~is_cat])
    assert torch.equal(d["cat_idx"][is_cat], walk.threshold[is_cat])
    for field in ("split_feature", "decision", "left_child", "right_child"):
        assert torch.equal(d[field], getattr(walk, field)), field
    # words 1-3 are K1's own records' words
    assert torch.equal(qf.nodes[..., 1:], walk.nodes[..., 1:])
    real = (torch.arange(m)[None, :]
            < (walk.num_leaves[:, None] - 1).clamp(min=0))
    assert (qf.nodes[..., 2:][~real] == -1).all()
    assert (walk.num_leaves == 1).any() or name == "mixed_sizes"
    assert int(walk.num_leaves.min()) < int(walk.num_leaves.max())
    decision = walk.decision.to(torch.int32)[real]
    assert {MISSING_NAN, MISSING_ZERO} <= set(((decision >> 2) & 3).tolist())
    assert bool(((qf.lo == -2) & ~is_cat & real).any())
    assert bool(is_cat[real].any()) == (name != "numeric")
    assert qf.nbytes() > qf.walk.nbytes() + qf.nodes.numel() * 4


def _leaf_by_records(qf, d, code_row, raw_row, t):
    """One row down tree t over QW's decoded records: lo <= code <=
    thr_code at a numeric node, the bitset test on the flushed raw value
    at a categorical one."""
    walk = qf.walk
    if int(walk.num_leaves[t]) <= 1:
        return 0
    bounds = walk.cat_boundaries.numpy()[t]
    bits = walk.cat_bitset.numpy()[t].view(np.uint32)
    node = 0
    while node >= 0:
        f = d["split_feature"][t, node]
        if int(d["decision"][t, node]) & 1:
            x = np.float32(raw_row[f])
            if abs(x) < F32_TINY:
                x = np.copysign(np.float32(0.0), x)
            left = False
            idx = int(d["cat_idx"][t, node])
            lo, words = bounds[idx], bounds[idx + 1] - bounds[idx]
            cat = np.floor(x)
            if cat >= 0 and cat < np.float32(32 * words):
                v = int(cat)
                left = bool((bits[lo + (v >> 5)] >> (v & 31)) & 1)
        else:
            c = int(code_row[f])
            left = int(d["lo"][t, node]) <= c <= int(d["thr_code"][t, node])
        node = int(d["left_child"][t, node] if left
                   else d["right_child"][t, node])
    return ~node


def _replay(qf, codes, x, chunk):
    """[N] f32: QW's records walked row by row, each tree's f16 leaf
    widened and added in batches of QUANT_TREE_BATCH, a chunk of `chunk`
    trees at a time (the count carries over the chunks), as either mode
    adds them; and the [T, N] leaves."""
    walk = qf.walk
    rows, crow = x.numpy(), codes.numpy()
    nt = walk.num_trees
    d = {k: v.numpy() for k, v in decode(qf.nodes).items()}
    leaves = torch.tensor([[_leaf_by_records(qf, d, crow[i], rows[i], t)
                            for i in range(len(rows))] for t in range(nt)],
                          dtype=torch.int64)
    vals = walk.leaf_value.gather(1, leaves).float().numpy()
    out = np.zeros(len(rows), np.float32)
    for i in range(len(rows)):
        acc = part = np.float32(0.0)
        in_batch = 0
        for t0 in range(0, nt, chunk):
            for t in range(t0, min(nt, t0 + chunk)):
                part = np.float32(part + vals[t, i])
                in_batch += 1
                if in_batch == tp.QUANT_TREE_BATCH:
                    acc, part, in_batch = np.float32(acc + part), \
                        np.float32(0.0), 0
        if in_batch:
            acc = np.float32(acc + part)
        out[i] = acc
    return torch.from_numpy(out), leaves


# chunks: trees mode's pass and a short one, rows mode's 4 trees of 255
# leaves a buffer and a chunk that splits the batches of 10
@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("chunk", [tp.PAIRS_CHUNK, 7, 4, 3])
def test_replayed_orders_equal_the_plain_walk_bitwise(forests, name, chunk):
    trees, rows = forests[name]
    x = torch.from_numpy(rows[::2].copy())
    qf = tp.stack_trees_quant(trees, CPU)
    codes = tp.quant_codes_plain(qf, x)
    got, leaves = _replay(qf, codes, x, chunk)
    assert torch.equal(leaves, tp._leaves_plain(
        qf.walk, x, (qf.thr_code, qf.lo, codes)))
    ref = tp.forest_quant_walk_plain(qf, codes, x)
    assert torch.equal(got.view(torch.int32), ref.view(torch.int32))


@pytest.mark.parametrize("name", NAMES)
def test_replay_equals_the_jax_quant_walk_bitwise(forests, name):
    trees, rows = forests[name]
    x = torch.from_numpy(rows)
    qf = tp.stack_trees_quant(trees, CPU)
    got, _ = _replay(qf, tp.quant_codes_plain(qf, x), x, 4)
    jax_trees = [JaxTree.from_string(t.to_string()) for t in trees]
    ref = np.asarray(jp.predict_forest_quant(jp.stack_trees_quant(jax_trees),
                                             jnp.asarray(rows)))
    assert np.array_equal(got.numpy().view(np.int32),
                          ref.astype(np.float32).view(np.int32))


@pytest.mark.parametrize("trees,leaves,features", [
    (1, 2, 1), (50, 63, 28), (500, 255, 28), (500, 255, 180),
    (10, 63, 968), (3, 4096, 28), (5000, 1024, 5000)])
@pytest.mark.parametrize("n", [1, 512, 32_768, 32_769, 262_144])
def test_plan_with_codes_stays_within_shared_memory(trees, leaves, features,
                                                    n):
    m = max(leaves - 1, 1)
    plan = tp.walk_plan(trees, m, features, n, value_bytes=2)
    assert 0 <= plan.shared_bytes <= tp.SHARED_BYTES
    k1 = tp.walk_plan(trees, m, features, n)
    assert (plan.mode, plan.threads, plan.chunk_trees) == (
        k1.mode, k1.threads, k1.chunk_trees)
    if plan.mode == "trees":
        assert plan == k1
        return
    tree_smem = 2 * plan.chunk_trees * m * tp.RECORD_BYTES
    row_smem = 2 * features * tp.staged_stride(plan.threads, 2)
    if plan.staged_features >= 0:
        assert plan.staged_features == features
        assert plan.shared_bytes == tree_smem + row_smem
    else:
        assert tree_smem + row_smem > tp.SHARED_BYTES
        assert plan.shared_bytes == tree_smem
    # 2-byte codes stage whatever 4-byte values do, and 180 columns of
    # codes where K1 reads its rows from device memory
    assert plan.staged_features >= k1.staged_features
    if (trees, leaves, features) == (500, 255, 180):
        assert (k1.staged_features, plan.staged_features) == (-1, 180)


def test_main_path_plan_and_refusal():
    """The served 500 x 255 x 28 forest: one row walks its trees in
    parallel, a 131,072-row chunk stages 4 trees a buffer and 28 columns
    of codes; a forest whose records do not fit is refused by name."""
    assert tp.walk_plan(500, 254, 28, 1, value_bytes=2) == tp.WalkPlan(
        "trees", 512, 500, -1, 2000)
    assert tp.walk_plan(500, 254, 28, 131_072, value_bytes=2) == \
        tp.WalkPlan("rows", 512, 4, 28, 2 * 4 * 254 * 16 + 2 * 28 * 514)
    t = Tree(2)
    t.split_feature[0] = t.split_feature_inner[0] = tp.RECORD_MAX_FEATURE + 1
    t.threshold[0] = 0.5
    t.left_child[0], t.right_child[0] = -1, -2
    t.leaf_value[:] = [0.25, -0.25]
    qf = tp.stack_trees_quant([t], CPU)
    assert qf.nodes is None
    x = torch.zeros((2, 4), dtype=torch.float32)
    with pytest.raises(tlgb.LightGBMError,
                       match=r"forest_quant_walk: feature index 16777216 "
                             r"does not fit the 16-byte node record"):
        tp.forest_quant_walk(qf, torch.zeros((2, 4), dtype=torch.int16), x)
