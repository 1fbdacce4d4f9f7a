"""Kernel LF's launch plan and the replay of its summation order
(lightgbm_tpu_torch/ops/linear.py `normal_eq_plan`,
`linear_normal_eq_order`), on the CPU at fixture scale.

The replay forms each term in f32 as the JAX package forms it, takes it
exactly into f64 and adds it in the kernel's order: a lane's rows of a
tile in order, the warp's shuffle tree, the slice's warps, a leaf's
tiles. It is held within 1e-5 * max(1, sum |terms|) of the plain
version and of a float64 oracle, with counts exact; its A and b, solved
by `linear_solve_plain`, match the JAX package's `fit_leaves` within
tests/test_torch_linear.py's tolerance (1e-4 * max(1, |ref|)). Inputs
are made with numpy from a seed.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightgbm_tpu.linear.solver import fit_leaves as jax_fit
from lightgbm_tpu_torch.ops import linear
from lightgbm_tpu_torch.ops.histogram import segment_tiles

torch.set_num_threads(1)

#: the most dynamic shared memory a block takes on an H100
SMEM_LIMIT = 227 * 1024
F = 70


def oracle(x, g, h, w, perm, begin, rows, feats):
    """f64 sums of every leaf's terms and of their absolute values."""
    num_leaves, k = feats.shape
    d = k + 1
    a = np.zeros((2, num_leaves, d, d))
    b = np.zeros((2, num_leaves, d))
    cnt = np.zeros(num_leaves)
    for leaf in range(num_leaves):
        r = perm[begin[leaf]:begin[leaf] + rows[leaf]]
        f = feats[leaf]
        xv = np.where(f >= 0, x[r][:, np.clip(f, 0, None)], 0.0)
        ok = np.isfinite(xv).all(1)
        xv = np.where(np.isfinite(xv), xv, 0.0).astype(np.float32)
        xv = np.where(np.abs(xv) < np.finfo(np.float32).tiny, 0.0, xv)
        z = np.concatenate([xv, np.ones((len(r), 1), np.float32)], 1)
        ww = np.where(ok, w[r], 0.0).astype(np.float32)
        wh = (ww * h[r]).astype(np.float64)
        wg = (ww * g[r]).astype(np.float64)
        zz = (z[:, :, None] * z[:, None, :]).astype(np.float64)
        terms_a = wh[:, None, None] * zz
        terms_b = wg[:, None] * z.astype(np.float64)
        a[0, leaf], a[1, leaf] = terms_a.sum(0), np.abs(terms_a).sum(0)
        b[0, leaf], b[1, leaf] = terms_b.sum(0), np.abs(terms_b).sum(0)
        cnt[leaf] = (ww > 0).sum()
    return a, b, cnt


def problem(k, case, seed=0):
    """x [n, 70], g, h, w and the segments of `leaves` leaves: slot 1 of
    no rows, slot 2 of one row, slot 0 of a tile plus one row; NaN, inf
    and subnormal values in live slots, out-of-bag rows, padded slots."""
    plan = linear.normal_eq_plan(k)
    rng = np.random.RandomState(seed + k)
    sizes = [plan["tile_rows"] + 1, 0, 1] + list(rng.randint(5, 300, 3))
    if case == "one_leaf":
        sizes = [3 * plan["tile_rows"] - 7]
    n = int(np.sum(sizes)) + 11           # rows of no leaf
    x = rng.randn(n, F).astype(np.float32)
    num_leaves = len(sizes)
    feats = np.stack([rng.choice(F, k, replace=False)
                      for _ in range(num_leaves)]).astype(np.int32)
    if k > 2:
        feats[-1, -2:] = -1
    if case == "edge_values":
        live = feats[0, 0]
        x[rng.rand(n) < 0.05, live] = np.nan
        x[rng.rand(n) < 0.05, feats[0, k - 1]] = np.inf
        x[rng.rand(n) < 0.05, live] = 3e-41          # subnormal
        x[rng.rand(n) < 0.05, feats[-1, 0]] = -1e-45
    g = rng.randn(n).astype(np.float32)
    h = rng.uniform(0.1, 1.5, n).astype(np.float32)
    w = (rng.rand(n) < 0.85).astype(np.float32)      # out of the bag: 0
    perm = rng.permutation(n).astype(np.int32)
    begin = np.concatenate([[0], np.cumsum(sizes)[:-1]]).astype(np.int64)
    rows = np.asarray(sizes, np.int64)
    for leaf in range(num_leaves):                   # rows ascending
        seg = slice(begin[leaf], begin[leaf] + rows[leaf])
        perm[seg] = np.sort(perm[seg])
    return x, g, h, w, perm, begin, rows, feats


def as_torch(x, g, h, w, perm, begin, rows, feats):
    return (torch.from_numpy(x), torch.from_numpy(g), torch.from_numpy(h),
            torch.from_numpy(w), torch.from_numpy(perm), begin, rows,
            torch.from_numpy(feats))


KS = [1, 5, 42, 43, 64]
CASES = ["mixed", "edge_values", "one_leaf"]


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("k", KS)
def test_order_replay_matches_plain_and_the_f64_oracle(k, case):
    p = problem(k, case)
    args = as_torch(*p)
    a, b, cnt = linear.linear_normal_eq_order(*args)
    pa, pb, pc = linear.linear_normal_eq_plain(*args)
    (oa, oa_abs), (ob, ob_abs), oc = oracle(*p)
    assert torch.equal(cnt, pc) and np.array_equal(cnt.numpy(), oc)
    for got, ref, ref64, scale in ((a, pa, oa, oa_abs), (b, pb, ob, ob_abs)):
        tol = 1e-5 * np.maximum(1.0, scale)
        got = got.numpy().astype(np.float64)
        assert np.all(np.abs(got - ref.numpy()) <= tol)
        assert np.all(np.abs(got - ref64) <= tol)
    assert torch.equal(a, a.transpose(1, 2))
    if case != "one_leaf":
        assert cnt[1] == 0 and not a[1].any() and not b[1].any()
        assert cnt[2] <= 1


@pytest.mark.parametrize("k", KS)
def test_order_replay_repeats_its_bits(k):
    args = as_torch(*problem(k, "edge_values"))
    one = linear.linear_normal_eq_order(*args)
    two = linear.linear_normal_eq_order(*args)
    assert all(torch.equal(u.view(torch.int32), v.view(torch.int32))
               for u, v in zip(one, two))


@pytest.mark.parametrize("k", [1, 5, 43])
def test_the_solve_of_the_replay_matches_jax_fit_leaves(k):
    x, g, h, w, perm, begin, rows, feats = problem(k, "mixed", seed=3)
    num_leaves = len(rows)
    lid = np.full(len(x), num_leaves, np.int32)
    for leaf in range(num_leaves):
        lid[perm[begin[leaf]:begin[leaf] + rows[leaf]]] = leaf
    w = np.where(lid < num_leaves, w, 0.0).astype(np.float32)
    lid = np.minimum(lid, num_leaves - 1)
    const = np.random.RandomState(k).randn(num_leaves).astype(np.float32)
    jv, jc, jf = (np.asarray(t) for t in jax_fit(
        *(jnp.asarray(t) for t in (x, g, h, w, lid, feats, const)),
        jnp.float32(0.01), num_leaves))
    a, b, cnt = linear.linear_normal_eq_order(
        *as_torch(x, g, h, w, perm, begin, rows, feats))
    tv, tc, tf = (t.numpy() for t in linear.linear_solve_plain(
        a, b, cnt, torch.from_numpy(feats), torch.from_numpy(const), 0.01))
    assert np.array_equal(tf, jf) and tf[0] and not tf[1]
    assert np.all(np.abs(tv - jv) <= 1e-4 * np.maximum(1, np.abs(jv)))
    assert np.all(np.abs(tc - jc) <= 1e-4 * np.maximum(1, np.abs(jc)))


@pytest.mark.parametrize("k", [1, 2, 5, 6, 9, 10, 14, 20, 21, 42, 43, 64,
                               100, 237])
def test_the_plan_fits_shared_memory_and_splits_rows_evenly(k):
    p = linear.normal_eq_plan(k)
    d = k + 1
    assert p["entries"] == d * (d + 1) // 2 + d + 1
    if p["kernel"] == "rows":
        # every sum in a lane's registers: at most 32 of them
        assert d <= linear.LF_ROWS_MAX_D and p["entries"] <= 32
        assert p["lanes"] == linear.LF_THREADS == 32 * p["per_slice"]
    else:
        assert d > linear.LF_ROWS_MAX_D
        assert p["lanes"] == p["per_slice"] == 1
        assert p["chunk"] & (p["chunk"] - 1) == 0 and 1 <= p["chunk"] <= 256
        ring = linear.LF_BUFS * p["chunk"] * ((d + 3) | 1) * 4
        assert ring <= linear.LF_RING_BYTES
        # the wide kernel's header: the tile scan's words and the features
        assert (10 + k) * 4 + 16 + ring <= SMEM_LIMIT
    assert p["tile_rows"] % p["lanes"] == 0


@pytest.mark.parametrize("k", [5, 64])
def test_the_kernels_tile_table_covers_each_segment_in_order(k):
    """The table the kernel builds on the card: a leaf's tiles of
    tile_rows rows, leaf by leaf, within the grid the wrapper launches
    (ceil(N / tile_rows) + L tiles)."""
    x, g, h, w, perm, begin, rows, feats = problem(k, "mixed")
    p = linear.normal_eq_plan(k)
    meta, n_tiles = segment_tiles(begin, rows, p["tile_rows"])
    assert n_tiles <= -(-len(x) // p["tile_rows"]) + len(rows)
    tiles = meta[:3 * n_tiles].reshape(-1, 3)
    first = meta[3 * n_tiles:3 * n_tiles + len(rows)]
    count = meta[3 * n_tiles + len(rows):]
    assert np.array_equal(count, -(-rows // p["tile_rows"]))
    for leaf in range(len(rows)):
        own = tiles[first[leaf]:first[leaf] + count[leaf]]
        assert np.all(own[:, 0] == leaf) and own[:, 2].sum() == rows[leaf]
        assert np.array_equal(own[:, 1], begin[leaf] + p["tile_rows"]
                              * np.arange(count[leaf]))
