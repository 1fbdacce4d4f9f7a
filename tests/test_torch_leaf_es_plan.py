"""K2's and ES's orders over the node records and their launch plans
(lightgbm_tpu_torch/ops/predict.py, csrc/forest_records.cuh; the CUDA
kernels are held against the plain versions on the card by
chip_smoke.py), on the CPU.

- A scalar replay of K2 (`forest_leaf_walk`) over K1's node records in
  either mode: trees mode's leaf a thread stored at row * T + t; rows
  mode's blocks of rows, record chunks and shared tiles written out a
  row at a time, with a last partial block, chunk and tile. Every cell
  is written once, and the leaves equal `forest_leaf_walk_plain` and the
  JAX package's `predict_forest_leaf_raw` exactly.
- A scalar replay of ES (`forest_early_stop_walk`) in either mode: trees
  mode's passes of iterations, added by one thread in iteration and
  class order and stopped at the freeze; rows mode's rounds (a launch
  each, over the rows the last round left live), chunks with the live
  rows compacted after each, and the trees-mode tail that takes the
  rows on once few are live (rows that freeze at the first check, at
  later ones and never). Sums and iteration counts equal
  `forest_early_stop_walk_plain` and the JAX package's
  `predict_forest_raw_early_stop` bitwise, at K = 1 and 3, freq 1, 3 and
  10, margins 0, the median and 1e30, and on a linear forest.
- `walk_plan`'s K2 and ES cases (K2's tile, ES's K sums for K up to 32)
  stay within the card's shared memory and are deterministic in their
  arguments; the main path's plans are pinned.
- K2 and ES refuse by name a forest that has no node records.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightgbm_tpu.ops import predict as jp
from lightgbm_tpu.serving.forest import CompiledForest as JaxCache
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
jax_early_stop = jax.jit(jp.predict_forest_raw_early_stop,
                         static_argnames=("freq",))


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
    """name -> (trees, K, rows [N, F] f32): seeded forests with every
    missing type, categorical bitsets, a one-leaf tree, trees of 31 and
    7 leaves stacked together, a linear one and three class forests
    stored iteration-major; a third of the rows steered onto thresholds
    and special values."""
    plain = _trees(synthetic_forest_text(3, 23, 31, 10))
    cat = _trees(synthetic_forest_text(4, 16, 31, 10, 3))
    small = _trees(synthetic_forest_text(8, 12, 7, 10, 2))
    per_class = [_trees(synthetic_forest_text(10 + c, 9, 15, 10))
                 for c in range(3)]
    out = {}
    for name, trees, k, cats in (
            ("numeric", _with_stub(plain), 1, 0),
            ("categorical", _with_stub(cat), 1, 3),
            ("mixed_sizes", cat[:6] + small + cat[6:], 1, 3),
            ("linear", _linear(plain[:12], 9, 10), 1, 0),
            ("three_classes", [per_class[c][t] for t in range(9)
                               for c in range(3)], 3, 0)):
        rows = np.concatenate([
            synthetic_rows(5, 140, 10, cats),
            edge_case_rows(trees, 10, 6, 70, cats)]).astype(np.float32)
        out[name] = (trees, k, rows)
    return out


def _decoded(forest):
    """The [T, M] fields K1's records hold, as numpy arrays."""
    nodes = forest.nodes
    word = nodes[..., 1].to(torch.int64) & 0xFFFFFFFF
    return dict(
        split_feature=(word & tp.RECORD_MAX_FEATURE).numpy(),
        threshold=nodes[..., 0].contiguous().view(torch.float32).numpy(),
        decision=(word >> tp.RECORD_FEATURE_BITS).numpy(),
        left_child=nodes[..., 2].numpy(), right_child=nodes[..., 3].numpy())


def _leaf_by_records(forest, d, row, t):
    """One row down tree t over the decoded records, as walk_tree decides
    (RawDecision): the flushed value, _decide_raw's rules, the bitset."""
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
            cat = np.floor(x)
            lo = bounds[int(thr)]
            words = bounds[int(thr) + 1] - lo
            if not np.isnan(x) and cat >= 0 and cat < 32 * words:
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


class Records:
    """A row's leaf in a tree over the records, walked once and kept."""

    def __init__(self, forest, rows):
        self.forest, self.rows = forest, rows
        self.d = _decoded(forest)
        self.memo = {}

    def leaf(self, r, t):
        key = (r, t)
        if key not in self.memo:
            self.memo[key] = _leaf_by_records(self.forest, self.d,
                                              self.rows[r], t)
        return self.memo[key]


def _k2_trees_replay(forest, rows, threads):
    """K2's trees mode: block r walks row r, thread i trees i, i +
    threads, ...; each leaf stored at r * T + t."""
    walk = Records(forest, rows)
    nt = forest.num_trees
    out = np.full(len(rows) * nt, -99, np.int64)
    for r in range(len(rows)):
        for i in range(threads):
            for t in range(i, nt, threads):
                assert out[r * nt + t] == -99
                out[r * nt + t] = walk.leaf(r, t)
    return out.reshape(len(rows), nt)


def _k2_rows_replay(forest, rows, threads, chunk, tile):
    """K2's rows mode: blocks of `threads` rows; chunks of `chunk` trees
    (0: records from device memory, chunks of `tile`); thread i puts row
    i's leaf of tree t at tile[i * (tile + 1) + t % tile]; when a tile
    is full or the trees end, thread e of the block writes cell e of the
    tile's rows_here x w cells, row by row."""
    walk = Records(forest, rows)
    n, nt = len(rows), forest.num_trees
    big = chunk if chunk else tile
    assert tile % big == 0
    stride = tile + 1
    out = np.full(n * nt, -99, np.int64)
    for row0 in range(0, n, threads):
        here = min(threads, n - row0)
        shared = np.full(threads * stride, -77, np.int64)
        for t0 in range(0, nt, big):
            cn = min(big, nt - t0)
            for i in range(threads):
                for t in range(t0, t0 + cn):
                    shared[i * stride + t % tile] = (
                        walk.leaf(row0 + i, t) if i < here else 0)
            end = t0 + cn
            if end % tile == 0 or end == nt:
                tb = (end - 1) // tile * tile
                w = end - tb
                for e in range(here * w):
                    i, j = divmod(e, w)
                    cell = (row0 + i) * nt + tb + j
                    assert out[cell] == -99, "a cell written twice"
                    out[cell] = shared[i * stride + j]
    assert (out != -99).all(), "a cell never written"
    return out.reshape(n, nt)


NAMES_K2 = ["numeric", "categorical", "mixed_sizes"]


@pytest.mark.parametrize("name", NAMES_K2)
def test_k2_trees_mode_replay_equals_plain_and_jax(forests, name):
    trees, _, rows = forests[name]
    forest = tp.stack_trees(trees, CPU)
    ref = tp.forest_leaf_walk_plain(forest, torch.from_numpy(rows)).numpy()
    jax_trees = [JaxTree.from_string(t.to_string()) for t in trees]
    jref = np.asarray(jp.predict_forest_leaf_raw(
        jp.stack_trees_raw(jax_trees), jnp.asarray(rows)))
    assert np.array_equal(ref, jref)
    for threads in (512, 7):
        assert np.array_equal(_k2_trees_replay(forest, rows, threads), ref)


# (threads, chunk, tile): the main path's 4-tree chunks in 8-tree
# tiles, 3-tree chunks in 6-tree tiles, 5-tree tiles of 5-tree chunks
# (the last partial), one-tree chunks, and records read from device
# memory (chunk 0) in 8-tree tiles; blocks of 8, 5 and 64 rows (a last
# partial block)
@pytest.mark.parametrize("name", NAMES_K2)
@pytest.mark.parametrize("threads,chunk,tile", [
    (8, 4, 8), (5, 3, 6), (8, 5, 5), (64, 1, 8), (5, 0, 8)])
def test_k2_rows_mode_tiles_equal_plain(forests, name, threads, chunk,
                                        tile):
    trees, _, rows = forests[name]
    forest = tp.stack_trees(trees, CPU)
    sub = rows[::2].copy()
    ref = tp.forest_leaf_walk_plain(forest, torch.from_numpy(sub)).numpy()
    assert len(sub) % threads or threads == 5
    got = _k2_rows_replay(forest, sub, threads, chunk, tile)
    assert np.array_equal(got, ref)


def _es_values(forest, x):
    """[T, N] f32 values of every tree at the leaves the records give."""
    rows = x.numpy()
    walk = Records(forest, rows)
    leaves = torch.tensor([[walk.leaf(r, t) for r in range(len(rows))]
                           for t in range(forest.num_trees)],
                          dtype=torch.int64)
    assert torch.equal(leaves, tp._leaves_plain(forest, x))
    return tp._tree_values_plain(forest, x, leaves).numpy()


def _margin(sums, k):
    """class_margin: 2|s| for K = 1, else top-1 minus top-2 in f32."""
    if k == 1:
        return np.float32(2.0) * np.float32(abs(sums[0]))
    top1 = top2 = np.float32(-np.inf)
    for v in sums:
        if v > top1:
            top1, top2 = v, top1
        elif v > top2:
            top2 = v
    return np.float32(top1 - top2)


def _es_trees_replay(vals, k, margin, freq, chunk):
    """ES's trees mode: block r walks passes of `chunk` iterations (their
    K trees in parallel); thread 0 adds each pass in iteration order,
    classes in order, checks after every freq-th iteration and ends the
    row at its freeze. vals [K * T, N]."""
    t_iters, n = vals.shape[0] // k, vals.shape[1]
    lim = np.float32(margin)
    out = np.zeros((k, n), np.float32)
    iters = np.full(n, t_iters, np.int32)
    for r in range(n):
        sums = np.zeros(k, np.float32)
        frozen = 0
        for t0 in range(0, t_iters, chunk):
            cn = min(chunk, t_iters - t0)
            # the pass: every thread's value, speculative past a freeze
            passed = [[vals[c * t_iters + t0 + tt, r] for tt in range(cn)]
                      for c in range(k)]
            for tt in range(cn):
                for c in range(k):
                    sums[c] = np.float32(sums[c] + passed[c][tt])
                walked = t0 + tt + 1
                if walked % freq == 0 and not _margin(sums, k) <= lim:
                    frozen = walked
                    break
            if frozen:
                break
        out[:, r] = sums
        iters[r] = frozen or t_iters
    return out, iters


def _es_rows_replay(vals, k, margin, freq, threads, chunk, round_iters,
                    tail_rows=0, tail_chunk=4):
    """ES's rows mode: rounds of `round_iters` iterations, one launch
    each. Round 0 takes every row in order, a later round the rows the
    last one left live, in the order its blocks appended them; a block
    takes `threads` of them, loads their sums, and walks chunks of
    `chunk` iterations (0: records from device memory, freq iterations a
    chunk) clipped to the round. Live row v of the block's local list
    goes to thread v, which adds each iteration's K values into the
    row's sums and checks after every freq-th iteration (a frozen row
    stores its iteration count); after each chunk the live rows keep
    their order at the front of the list. At the round's end the block
    appends its live rows to the next round's list (blocks in their
    launch order here; on the card in the order their atomicAdds land,
    which moves no row's sums), or marks them as having walked every
    iteration. From round 1 on, once at most `tail_rows` rows are live
    at a round's start, the trees-mode tail takes each of them from
    there to its freeze, `tail_chunk` iterations a pass (a block a row,
    the pass's values added by one thread). Returns the outputs and the
    rows each round took."""
    t_iters, n = vals.shape[0] // k, vals.shape[1]
    lim = np.float32(margin)
    c_len = chunk if chunk else min(freq, t_iters)
    out = np.zeros((k, n), np.float32)
    iters = np.full(n, -1, np.int32)
    order = list(range(n))
    taken = []
    for a in range(0, t_iters, round_iters):
        b = min(t_iters, a + round_iters)
        taken.append(len(order))
        if a and len(order) <= tail_rows:
            for g in order:
                sums = out[:, [g]].copy()
                frozen = 0
                for t0 in range(a, t_iters, tail_chunk):
                    for tt in range(min(tail_chunk, t_iters - t0)):
                        for c in range(k):
                            sums[c, 0] = np.float32(
                                sums[c, 0] + vals[c * t_iters + t0 + tt, g])
                        done = t0 + tt + 1
                        if done % freq == 0 and not _margin(sums[:, 0],
                                                            k) <= lim:
                            frozen = done
                            break
                    if frozen:
                        break
                out[:, g] = sums[:, 0]
                iters[g] = frozen or t_iters
            break
        survivors = []
        for first in range(0, len(order), threads):
            ids = order[first:first + threads]
            sums = out[:, ids].copy()
            live_rows = list(range(len(ids)))
            for t0 in range(a, b, c_len):
                cn = min(c_len, b - t0)
                if not live_rows:
                    break
                kept = []
                for r in live_rows:
                    alive = True
                    for tt in range(cn):
                        for c in range(k):
                            sums[c, r] = np.float32(
                                sums[c, r] + vals[c * t_iters + t0 + tt,
                                                  ids[r]])
                        done = t0 + tt + 1
                        if done % freq == 0 and not _margin(sums[:, r],
                                                            k) <= lim:
                            assert iters[ids[r]] == -1
                            iters[ids[r]] = done
                            alive = False
                            break
                    if alive:
                        kept.append(r)
                live_rows = kept
            out[:, ids] = sums
            for r in live_rows:
                if b == t_iters:
                    iters[ids[r]] = t_iters
                else:
                    survivors.append(ids[r])
        order = survivors
        if not order:
            break
    assert (iters >= 1).all()
    return out, iters, taken


def _median_margin(stack, x, k):
    full, _ = tp.forest_early_stop_walk_plain(stack, x, 1e30, 1)
    if k == 1:
        return float(np.median(2.0 * np.abs(full[0].numpy())))
    top = np.sort(full.numpy().T, axis=1)
    return float(np.median(top[:, -1] - top[:, -2]))


NAMES_ES = ["numeric", "categorical", "linear", "three_classes"]


@pytest.fixture(scope="module")
def es_cases(forests):
    """name -> (port stack, JAX stack, K, rows, [K * T, N] values)."""
    out = {}
    for name in NAMES_ES:
        trees, k, rows = forests[name]
        t_iters = len(trees) // k
        stack = tp.stack_trees_early_stop(trees, k, t_iters, CPU)
        jax_trees = [JaxTree.from_string(t.to_string()) for t in trees]
        jax_stack = JaxCache().early_stop_stacks(jax_trees, k, t_iters)
        x = torch.from_numpy(rows)
        out[name] = (stack, jax_stack, k, rows, _es_values(stack, x))
    return out


@pytest.mark.parametrize("name", NAMES_ES)
@pytest.mark.parametrize("freq", [1, 3, 10])
def test_es_replays_equal_plain_and_jax_bitwise(es_cases, name, freq):
    stack, jax_stack, k, rows, vals = es_cases[name]
    x = torch.from_numpy(rows)
    if name == "linear":
        assert stack.linear_k > 0
    t_iters = stack.num_trees // k
    seen = set()
    for margin in (0.0, _median_margin(stack, x, k), 1e30):
        ref, ref_iters = tp.forest_early_stop_walk_plain(stack, x, margin,
                                                         freq)
        jref = np.asarray(jax_early_stop(jax_stack, jnp.asarray(rows),
                                         jnp.float32(margin), freq=freq))
        assert np.array_equal(ref.numpy().view(np.int32),
                              jref.astype(np.float32).view(np.int32))
        bits = ref.numpy().view(np.int32)
        it = ref_iters.numpy()
        for chunk in (1, 4, 170):
            got, iters = _es_trees_replay(vals, k, margin, freq, chunk)
            assert np.array_equal(got.view(np.int32), bits), chunk
            assert np.array_equal(iters, it), chunk
        for case in ((32, 4, 8, 0), (32, 3, 40, 0), (64, 0, 7, 100),
                     (96, 4, 1000, 0), (512, 4, 40, 0), (32, 4, 4, 150)):
            got, iters, _ = _es_rows_replay(vals, k, margin, freq, *case)
            assert np.array_equal(got.view(np.int32), bits), case
            assert np.array_equal(iters, it), case
        seen.update(np.unique(it).tolist())
    # rows froze at the first check, at later checks, and never
    if freq < t_iters:
        assert min(freq, t_iters) in seen and t_iters in seen
        assert len(seen) >= 3 or freq * 2 > t_iters


def test_es_rows_rounds_take_only_the_live_rows(es_cases):
    """At the median margin each round takes fewer rows than the last, so
    its blocks are full of live rows; at 1e30 every round takes all of
    them; at margin 0 the rows freeze at the first check and the first
    round is the only one."""
    stack, _, k, rows, vals = es_cases["numeric"]
    x = torch.from_numpy(rows)
    med = _median_margin(stack, x, k)
    t_iters = stack.num_trees // k
    _, _, taken = _es_rows_replay(vals, k, med, 1, 32, 2, 4)
    assert taken[0] == len(rows)
    assert all(a > b for a, b in zip(taken, taken[1:]))
    assert len(taken) > 1
    _, _, never = _es_rows_replay(vals, k, 1e30, 1, 32, 2, 4)
    assert never == [len(rows)] * (-(-t_iters // 4))
    _, _, at_once = _es_rows_replay(vals, k, 0.0, 1, 32, 2, 4)
    assert at_once == [len(rows)]
    # the tail takes the rows on at the first round that starts with at
    # most tail_rows live, and is the last round
    few = taken[2]
    _, _, tailed = _es_rows_replay(vals, k, med, 1, 32, 2, 4, few)
    assert tailed == taken[:3]


@pytest.mark.parametrize("trees,leaves,features", [
    (1, 2, 1), (10, 7, 10), (500, 255, 28), (500, 255, 40),
    (10, 63, 968), (3, 4096, 28), (2000, 31, 200), (5000, 1024, 5000)])
@pytest.mark.parametrize("n", [1, 513, 32_768, 32_769, 262_144])
def test_leaf_plan_within_shared_memory(trees, leaves, features, n):
    m = max(leaves - 1, 1)
    plan = tp.walk_plan(trees, m, features, n, output="leaf")
    assert plan == tp.walk_plan(trees, m, features, n, output="leaf")
    assert plan == tp.walk_plan(trees, m, features, n, linear=True,
                                output="leaf")
    assert 0 <= plan.shared_bytes <= tp.SHARED_BYTES
    assert plan.threads % 32 == 0 and 32 <= plan.threads <= 512
    k1 = tp.walk_plan(trees, m, features, n)
    assert plan.mode == k1.mode
    if plan.mode == "trees":
        assert (plan.threads, plan.chunk_trees, plan.shared_bytes,
                plan.tile_trees) == (k1.threads, k1.chunk_trees, 0, 0)
        return
    assert plan.chunk_trees <= tp.LEAF_TILE_TREES
    assert plan.tile_trees >= 1
    if plan.chunk_trees:
        assert plan.tile_trees % plan.chunk_trees == 0
        assert plan.tile_trees <= tp.LEAF_TILE_TREES
    tile_smem = 4 * plan.threads * (plan.tile_trees + 1)
    tree_smem = 2 * plan.chunk_trees * m * tp.RECORD_BYTES + tile_smem
    row_smem = 4 * features * tp.staged_stride(plan.threads, 4)
    if plan.staged_features >= 0:
        assert plan.shared_bytes == tree_smem + row_smem
    else:
        assert tree_smem + row_smem > tp.SHARED_BYTES
        assert plan.shared_bytes == tree_smem


@pytest.mark.parametrize("k", [1, 2, 3, 8, 32])
@pytest.mark.parametrize("leaves,features,linear", [
    (255, 28, False), (63, 968, False), (4096, 28, False), (2, 1, False),
    (255, 28, True)])
@pytest.mark.parametrize("n", [1, 513, 32_768, 32_769, 262_144])
def test_early_stop_plan_within_shared_memory(k, leaves, features, linear,
                                              n):
    m = max(leaves - 1, 1)
    t_iters = 100
    args = (k * t_iters, m, features, n, linear)
    plan = tp.walk_plan(*args, output="early_stop", classes=k)
    assert plan == tp.walk_plan(*args, output="early_stop", classes=k)
    assert 0 <= plan.shared_bytes <= tp.SHARED_BYTES
    assert plan.threads % 32 == 0 and 32 <= plan.threads <= 512
    assert plan.tile_trees == 0
    if plan.mode == "trees":
        assert plan.rounds_args() == (0, 0, 0, 0)
        assert n <= tp.TREE_PARALLEL_MAX_ROWS
        assert 1 <= plan.chunk_trees <= t_iters
        assert plan.shared_bytes == (k * plan.chunk_trees + k) * 4
        assert plan.threads >= min(k * plan.chunk_trees, plan.threads)
        return
    assert plan.threads <= 32 * tp.ES_MAX_WARPS
    assert isinstance(plan, tp.EarlyStopPlan)
    assert plan.round_iters == min(t_iters, tp.ES_ROUND_ITERS)
    tail = tp.walk_plan(*args[:3], tp.ES_TAIL_ROWS, linear,
                        output="early_stop", classes=k)
    assert tail.mode == "trees" and plan.tail_rows == tp.ES_TAIL_ROWS
    assert (plan.tail_threads, plan.tail_chunk) == (tail.threads,
                                                    tail.chunk_trees)
    state = 4 * (k + 3) * plan.threads + 4 * tp.ES_MAX_WARPS
    tree_smem = 2 * plan.chunk_trees * k * m * tp.RECORD_BYTES
    assert tree_smem <= 2 * tp.CHUNK_BYTES
    if linear:
        assert (plan.chunk_trees, plan.staged_features) == (0, -1)
    row_smem = 4 * features * tp.staged_stride(plan.threads, 4)
    if plan.staged_features >= 0:
        assert plan.shared_bytes == tree_smem + state + row_smem
    else:
        assert plan.shared_bytes == tree_smem + state


def test_main_path_plans_and_refusals():
    """The served 500 x 255 x 28 forest: K2 on a 131,072-row chunk walks
    4-tree record chunks into 8-tree tiles; ES there rounds of
    ES_ROUND_ITERS iterations in 4-iteration chunks with 28 staged
    columns, and a tail of 128-iteration passes; one row walks its trees
    in parallel (K2 without shared memory, ES a pass of all 500
    iterations)."""
    assert tp.walk_plan(500, 254, 28, 131_072, output="leaf") == \
        tp.WalkPlan("rows", 512, 4, 28,
                    2 * 4 * 254 * 16 + 512 * 9 * 4 + 28 * 513 * 4, 8)
    assert tp.walk_plan(500, 254, 28, 1, output="leaf") == \
        tp.WalkPlan("trees", 512, 500, -1, 0)
    assert tp.walk_plan(500, 254, 28, 131_072, output="early_stop") == \
        tp.EarlyStopPlan("rows", 512, 4, 28,
                         2 * 4 * 254 * 16 + 512 * 4 * 4 + 64 + 28 * 513 * 4,
                         round_iters=tp.ES_ROUND_ITERS,
                         tail_rows=tp.ES_TAIL_ROWS, tail_threads=128,
                         tail_chunk=128)
    assert tp.walk_plan(500, 254, 28, 1, output="early_stop") == \
        tp.EarlyStopPlan("trees", 512, 500, -1, 501 * 4)
    with pytest.raises(tlgb.LightGBMError, match="no \\[K, T\\] stack"):
        tp.walk_plan(10, 254, 28, 1, output="early_stop", classes=3)
    with pytest.raises(tlgb.LightGBMError, match="output"):
        tp.walk_plan(10, 254, 28, 1, output="leaves")
    t = Tree(2)
    t.split_feature[0] = t.split_feature_inner[0] = tp.RECORD_MAX_FEATURE + 1
    t.threshold[0] = 0.5
    t.left_child[0], t.right_child[0] = -1, -2
    t.leaf_value[:] = [0.25, -0.25]
    forest = tp.stack_trees([t], CPU)
    assert forest.nodes is None
    x = torch.zeros((2, 4), dtype=torch.float32)
    with pytest.raises(tlgb.LightGBMError,
                       match=r"forest_leaf_walk: feature index 16777216 "
                             r"does not fit the 16-byte node record"):
        tp.forest_leaf_walk(forest, x)
    stack = tp.stack_trees_early_stop([t], 1, 1, CPU)
    with pytest.raises(tlgb.LightGBMError,
                       match=r"forest_early_stop_walk: feature index "
                             r"16777216 does not fit"):
        tp.forest_early_stop_walk(stack, x, 1.0, 1)


def test_wrappers_on_cpu_count_no_launch(forests):
    trees, k, rows = forests["three_classes"]
    stack = tp.stack_trees_early_stop(trees, k, len(trees) // k, CPU)
    x = torch.from_numpy(rows)
    before = {w: (w.launches, w.launches_rows) for w in (
        tp.forest_leaf_walk, tp.forest_early_stop_walk)}
    assert torch.equal(tp.forest_leaf_walk(stack, x),
                       tp.forest_leaf_walk_plain(stack, x))
    got = tp.forest_early_stop_walk(stack, x, 0.5, 3, return_iters=True)
    ref = tp.forest_early_stop_walk_plain(stack, x, 0.5, 3)
    assert all(torch.equal(a, b) for a, b in zip(got, ref))
    assert before == {w: (w.launches, w.launches_rows) for w in before}
