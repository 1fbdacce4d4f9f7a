"""R's one-launch partition (lightgbm_tpu_torch/csrc/route_partition.cu,
held against the plain version on the card by chip_smoke.py) and the
grower's two permutation buffers, on the CPU.

- A replay of the kernel's one pass (each block's run of rows, a multiple
  of 32, routed and its left flags packed 32 to a word; the blocks' left
  counts; each block's exclusive prefix and the total, in block order;
  the stable scatter, pass by pass, from the words' popcounts) equals
  `route_partition_plain` exactly: the same leaf ids, the same segment
  order and left count. Segments of 0, 1, 31, 32, 33, 511, 512, 513 and
  several passes of rows, at several block runs; all-left and all-right
  splits, bundled features, both missing types, categorical splits,
  uint8 and uint16 bins.
- The leaf ids equal the JAX grower's route logic (the expressions of
  lightgbm_tpu/learner/grow.py:1044-1068, in jnp) on the same column.
- The wrapper's `out=` mode (the segment written into another buffer,
  perm left as it is) equals the in-place one, on row-major bins and on
  a column-major copy's view.
- A grown tree's partition (`perm`, `leaf_begin`, `leaf_rows`,
  `leaf_id`), which the grower builds over two buffers and joins at the
  end, equals the one a single buffer gets from the same splits applied
  in place in split order.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lightgbm_tpu_torch as tlgb
from lightgbm_tpu_torch.binning import MISSING_NAN, MISSING_NONE, \
    MISSING_ZERO
from lightgbm_tpu_torch.learner.grow import GrowerConfig, SerialGrower
from lightgbm_tpu_torch.ops.route import (PASS_ROWS, SplitRule,
                                          go_left_plain, route_partition,
                                          route_partition_plain)

torch.set_num_threads(1)
N = 4096
# a block's run of rows is a multiple of 32 (a ballot word)


def replay_partition(col, seg, rule, per_block):
    """The kernel's one pass over the segment `seg` (row ids) of the
    group column `col`: (leaf ids of its rows, the reordered segment,
    the left count)."""
    m = len(seg)
    left = go_left_plain(rule, torch.from_numpy(col[seg])).numpy() \
        if m else np.zeros(0, bool)
    words = np.zeros((m + 31) // 32, np.uint64)
    for i in np.flatnonzero(left):
        words[i // 32] |= np.uint64(1) << np.uint64(i % 32)
    blocks = -(-m // per_block) if m else 0
    block_left = [int(left[b * per_block:(b + 1) * per_block].sum())
                  for b in range(blocks)]
    total = sum(block_left)
    out = np.full(m, -1, np.int64)
    for b in range(blocks):
        before = sum(block_left[:b])
        r0, r1 = b * per_block, min(m, (b + 1) * per_block)
        for i0 in range(r0, r1, PASS_ROWS):
            counts = [bin(int(words[w0 // 32])).count("1") if w0 < r1 else 0
                      for w0 in range(i0, i0 + PASS_ROWS, 32)]
            for i in range(i0, min(r1, i0 + PASS_ROWS)):
                w = (i - i0) // 32
                word = int(words[i // 32])
                lb = before + sum(counts[:w]) + bin(
                    word & ((1 << (i % 32)) - 1)).count("1")
                out[lb if (word >> (i % 32)) & 1 else total + i - lb] = seg[i]
            before += sum(counts)
    assert (out >= 0).all()
    lid = np.where(left, rule.left_slot, rule.right_slot)
    return lid, out, total


def bins(dtype, seed):
    """[N, 6] bins: group 0 a plain feature of 64 bins, group 1 a bundle
    (two features at offsets 1 and 33 of 32 bins each, bin 0 shared),
    group 2 up to 631 bins in uint16 (63 in uint8)."""
    rng = np.random.RandomState(seed)
    top = 631 if dtype == np.uint16 else 63
    b = np.stack([rng.randint(0, 64, N), rng.randint(0, 65, N),
                  rng.randint(0, top, N), rng.randint(0, 16, N),
                  rng.randint(0, 2, N), rng.randint(0, 64, N)], 1)
    return b.astype(dtype)


RULES = {
    "numeric": SplitRule(0, 0, 64, 0, MISSING_NONE, False, 20, False, False,
                         0, 1),
    "nan_missing": SplitRule(0, 0, 64, 0, MISSING_NAN, False, 40, True,
                             False, 3, 8),
    "zero_missing": SplitRule(5, 0, 64, 7, MISSING_ZERO, False, 12, True,
                              False, 2, 5),
    "bundled": SplitRule(1, 33, 32, 0, MISSING_ZERO, True, 9, False, False,
                         4, 6),
    "categorical": SplitRule(3, 0, 16, 0, MISSING_NONE, False, 5, False,
                             True, 1, 2),
    "wide_group": SplitRule(2, 0, 631, 0, MISSING_NAN, False, 300, False,
                            False, 0, 9),
    "all_left": SplitRule(4, 0, 2, 0, MISSING_NONE, False, 1, False, False,
                          0, 1),
    "all_right": SplitRule(4, 0, 2, 0, MISSING_NONE, False, -1, False,
                           False, 0, 1),
}
SIZES = [0, 1, 31, 32, 33, 511, 512, 513, 3 * PASS_ROWS + 77, N - 100]


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
@pytest.mark.parametrize("rule", sorted(RULES))
def test_replayed_one_pass_equals_the_plain_partition(dtype, rule):
    b = bins(dtype, 3)
    r = RULES[rule]
    if dtype == np.uint8 and rule == "wide_group":
        r = SplitRule(2, 0, 63, 0, MISSING_NAN, False, 30, False, False,
                      0, 9)
    binned = torch.from_numpy(b)
    rng = np.random.RandomState(7)
    for m in SIZES:
        seg = np.sort(rng.choice(N, m, replace=False)).astype(np.int32)
        perm = torch.arange(N, dtype=torch.int32)
        begin = 50
        perm[begin:begin + m] = torch.from_numpy(seg)
        perm[begin + m:] = torch.arange(begin + m, N, dtype=torch.int32)
        lid = torch.full((N,), -7, dtype=torch.int32)
        ref = perm.clone()
        n_left = int(route_partition_plain(binned, ref, begin, m, r, lid))
        for per_block in (32, 96, PASS_ROWS, 1024, -(-max(m, 1) // 32) * 32):
            got_lid, got, total = replay_partition(b[:, r.group], seg, r,
                                                   per_block)
            assert total == n_left
            assert np.array_equal(got, ref[begin:begin + m].numpy())
            assert np.array_equal(got_lid, lid.numpy()[seg])
        if rule == "all_left":
            assert n_left == m
        if rule == "all_right":
            assert n_left == 0


def jax_route(col, rule):
    """lightgbm_tpu/learner/grow.py:1044-1068 for one split, in jnp."""
    col = jnp.asarray(col).astype(jnp.int32)
    in_slice = (col >= rule.offset) & (col < rule.offset + rule.num_bin)
    decoded = jnp.where(in_slice, col - rule.offset, rule.default_bin)
    col = jnp.where(rule.bundled, decoded, col)
    nan_bin = rule.num_bin - 1
    is_missing = (((rule.missing_type == MISSING_NAN) & (col == nan_bin))
                  | ((rule.missing_type == MISSING_ZERO)
                     & (col == rule.default_bin)))
    go_left = jnp.where(rule.is_cat, col == rule.threshold,
                        jnp.where(is_missing, rule.default_left,
                                  col <= rule.threshold))
    return np.asarray(jnp.where(go_left, rule.left_slot, rule.right_slot))


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
def test_leaf_ids_equal_the_jax_route(dtype):
    b = bins(dtype, 5)
    binned = torch.from_numpy(b)
    for name, r in RULES.items():
        lid = torch.zeros(N, dtype=torch.int32)
        perm = torch.arange(N, dtype=torch.int32)
        route_partition(binned, perm, 0, N, r, lid)
        assert np.array_equal(lid.numpy(), jax_route(b[:, r.group], r)), name


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
def test_out_mode_and_layouts_equal_in_place(dtype):
    b = torch.from_numpy(bins(dtype, 9))
    cols = b.t().contiguous().t()
    assert cols.stride() == (1, N)
    rng = np.random.RandomState(4)
    for name, r in RULES.items():
        perm = torch.from_numpy(rng.permutation(N).astype(np.int32))
        ref, lid_ref = perm.clone(), torch.zeros(N, dtype=torch.int32)
        n_ref = int(route_partition(b, ref, 100, 2000, r, lid_ref))
        for mat in (b, cols):
            out = torch.full((N,), -1, dtype=torch.int32)
            lid = torch.zeros(N, dtype=torch.int32)
            cnt = torch.zeros(1, dtype=torch.int32)
            before = perm.clone()
            n = int(route_partition(mat, perm, 100, 2000, r, lid,
                                    count_out=cnt, out=out))
            assert n == n_ref == int(cnt[0]), name
            assert torch.equal(perm, before)
            assert torch.equal(out[100:2100], ref[100:2100])
            assert (out[:100] == -1).all() and (out[2100:] == -1).all()
            assert torch.equal(lid, lid_ref)
    with pytest.raises(Exception, match="apart from perm"):
        route_partition(b, perm, 0, 10, RULES["numeric"],
                        torch.zeros(N, dtype=torch.int32), out=perm)


def _slot_of(node, node_left):
    """The leaf slot node `node` split: its left child keeps the slot,
    so follow left children down to a leaf."""
    while node >= 0:
        node = int(node_left[node])
    return ~node


@pytest.mark.parametrize("kind", ["nan", "bundled"])
def test_grown_partition_equals_a_single_buffer(kind):
    rng = np.random.RandomState(11)
    x = rng.randn(N, 6)
    if kind == "nan":
        x[rng.rand(N) < 0.15, 1] = np.nan
    else:
        x[:, 2:] = 0.0
        owner = rng.randint(2, 6, N)
        live = rng.rand(N) < 0.7
        x[np.arange(N)[live], owner[live]] = rng.rand(live.sum()) * 3 + 0.5
    y = np.nan_to_num(x[:, 0]) + np.sin(np.nan_to_num(x[:, 1])) + x[:, 2]
    ds = tlgb.Dataset(x, y, params={"max_bin": 31,
                                    "verbose": -1})._lazy_init()
    fm = ds.feature_meta_arrays()
    cfg = GrowerConfig(num_leaves=31, min_data_in_leaf=10, hist_bf16=False)
    binned = torch.from_numpy(ds.binned)
    grower = SerialGrower(binned, fm, cfg, ds.max_num_bin(),
                          int(ds.num_bins_per_feature().max()))
    grad = (0.5 - y).astype(np.float32)
    w3 = torch.from_numpy(np.stack([grad, np.ones(N, np.float32),
                                    np.ones(N, np.float32)], 1))
    st = grower.grow(w3, np.ones(6, bool))
    used = st.num_leaves_used
    assert used > 8 and st.leaf_depth[:used].max() >= 3
    # the same splits, in split order, on one buffer in place
    perm = torch.arange(N, dtype=torch.int32)
    lid = torch.zeros(N, dtype=torch.int32)
    begin, rows = np.zeros(used, np.int64), np.zeros(used, np.int64)
    rows[0] = N
    for node in range(used - 1):
        slot, new = _slot_of(node, st.node_left), node + 1
        f = int(st.node_feature[node])
        rule = SplitRule(
            int(fm["group"][f]), int(fm["offset"][f]), int(fm["num_bin"][f]),
            int(fm["default_bin"][f]), int(fm["missing_type"][f]),
            bool(fm["is_bundled"][f]), int(st.node_threshold[node]),
            bool(st.node_default_left[node]), bool(st.node_is_cat[node]),
            slot, new)
        n_left = int(route_partition_plain(binned, perm, int(begin[slot]),
                                           int(rows[slot]), rule, lid))
        begin[new], rows[new] = begin[slot] + n_left, rows[slot] - n_left
        rows[slot] = n_left
    assert np.array_equal(st.leaf_begin[:used], begin)
    assert np.array_equal(st.leaf_rows[:used], rows)
    assert torch.equal(st.perm, perm) and st.perm is grower.perm
    assert torch.equal(st.leaf_id, lid)
