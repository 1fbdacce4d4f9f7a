"""The linear-leaf modules of lightgbm_tpu_torch against lightgbm_tpu.

The same seeded numpy inputs go to the JAX function and to the port's
plain version (the CPU path of kernels LF, LS, LA and LM):

- `learner/grow.leaf_path_features`: exactly equal, on the port
  grower's own trees;
- `linear.fit_leaves`: `fitted` exactly equal; leaf values and
  coefficients within 1e-4 * max(1, |ref|) of the JAX package's, and no
  further from an f64 numpy oracle than the JAX package's are, up to
  f32 round-off of the solve (8 ulps of max(1, |oracle|)); cases: a leaf
  whose system is exactly singular at linear_lambda = 0, a leaf with
  fewer than 2(k+1) weighted rows, padded slots, rows with NaN and bag
  weights;
- `linear.linear_row_values` and `ops/linear.linear_addend` against
  `linear_row_values` and `ops/predict.linear_leaf_addend`: within
  1e-6 * max(1, |ref|);
- `linear.leaf_feature_moments`: the per-(leaf, feature) moments within
  1e-5 of direct numpy sums, as tests/test_linear_tree.py holds the JAX
  package's, and within 1e-5 of the JAX package's.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from lightgbm_tpu.learner.grow import leaf_path_features as jax_paths
from lightgbm_tpu.linear.solver import fit_leaves as jax_fit
from lightgbm_tpu.linear.solver import linear_row_values as jax_rows
from lightgbm_tpu.linear.stats import leaf_feature_moments as jax_moments
from lightgbm_tpu.ops.predict import linear_leaf_addend as jax_addend
from lightgbm_tpu_torch import LightGBMError
from lightgbm_tpu_torch.dataset import Dataset
from lightgbm_tpu_torch.learner.grow import (GrowerConfig, SerialGrower,
                                             leaf_path_features)
from lightgbm_tpu_torch.linear import (fit_leaves, leaf_feature_moments,
                                       linear_row_values)
from lightgbm_tpu_torch.ops import histogram, linear

torch.set_num_threads(1)

EPS = float(np.finfo(np.float32).eps)


def grown(seed, leaves):
    """A tree of the port's grower on seeded data: its GrowerState."""
    rng = np.random.RandomState(seed)
    x = rng.randn(2000, 6)
    y = x[:, 0] + np.sin(2 * x[:, 1]) - 0.5 * x[:, 2] * x[:, 3]
    ds = Dataset.from_numpy(x, label=y, max_bin=31)
    binned = torch.from_numpy(ds.binned)
    grower = SerialGrower(binned, ds.feature_meta_arrays(),
                          GrowerConfig(num_leaves=leaves,
                                       min_data_in_leaf=5),
                          ds.max_num_bin(),
                          int(ds.num_bins_per_feature().max()))
    g = torch.from_numpy((-y).astype(np.float32))
    w3 = torch.stack([g, torch.ones_like(g), torch.ones_like(g)], 1)
    return grower.grow(w3.contiguous(), np.ones(ds.num_features, bool))


@pytest.mark.parametrize("seed,leaves,k", [(0, 15, 1), (0, 15, 3),
                                           (1, 31, 5), (2, 63, 8),
                                           (3, 2, 5)])
def test_leaf_path_features_equal(seed, leaves, k):
    st = grown(seed, leaves)
    args = (st.leaf_parent, st.node_feature, st.node_left, st.node_right,
            st.num_leaves_used)
    ref = np.asarray(jax_paths(*[jnp.asarray(a) for a in args], k))
    got = leaf_path_features(*args, k)
    assert got.dtype == np.int32 and got.shape == (leaves, k)
    assert np.array_equal(got, ref)


N, F, L, K = 3000, 6, 15, 3


def problem(seed=0):
    """Rows, gradients, bag weights and per-leaf features with the cases
    the fit must get right."""
    rng = np.random.RandomState(seed)
    x = rng.uniform(-1, 1, (N, F)).astype(np.float32)
    lid = rng.randint(0, L - 1, N).astype(np.int32)   # slot 14 stays empty
    feats = np.stack([rng.choice(F, K, replace=False)
                      for _ in range(L)]).astype(np.int32)
    feats[3, 2] = -1                   # a padded slot
    feats[5, :] = -1                   # all slots padded: intercept only
    x[lid == 2, feats[2, 0]] = 0.5     # constant in leaf 2: singular at 0
    lid[lid == 4] = 6
    lid[:5] = 4                        # 5 rows < 2(k+1): not fitted
    x[rng.rand(N) < 0.03, feats[7, 1]] = np.nan   # rows left out
    g = (x[:, 0] * 2 + np.nan_to_num(x[:, 1]) + rng.randn(N) * 0.3).astype(
        np.float32)
    h = rng.uniform(0.5, 1.5, N).astype(np.float32)
    w = (rng.rand(N) < 0.8).astype(np.float32)
    const = rng.randn(L).astype(np.float32)
    return x, g, h, w, lid, feats, const


def oracle(x, g, h, w, lid, feats, lam):
    """The f64 solve of every leaf's ridge system (nan where the JAX
    package does not fit)."""
    val = np.full(L, np.nan)
    coef = np.zeros((L, K))
    for leaf in range(L):
        r = lid == leaf
        xv = np.where(feats[leaf] >= 0,
                      x[r][:, np.clip(feats[leaf], 0, None)], 0.0)
        ok = np.isfinite(xv).all(1)
        z = np.concatenate([xv[ok], np.ones((ok.sum(), 1))], 1)
        ww = (w[r][ok]).astype(np.float64)
        a = (z.T * (ww * h[r][ok])) @ z
        a[np.arange(K), np.arange(K)] += np.where(feats[leaf] < 0, 1.0,
                                                  float(np.float32(lam)))
        if (ww > 0).sum() < 2 * (K + 1) or abs(np.linalg.det(a)) < 1e-12:
            continue
        beta = np.linalg.solve(a, -(z.T * (ww * g[r][ok])).sum(1))
        val[leaf], coef[leaf] = beta[K], np.where(feats[leaf] >= 0,
                                                  beta[:K], 0.0)
    return val, coef


@pytest.mark.parametrize("lam", [0.0, 0.01, 1.0])
def test_fit_leaves_matches_jax_and_the_oracle(lam):
    x, g, h, w, lid, feats, const = problem()
    jv, jc, jf = (np.asarray(a) for a in jax_fit(
        jnp.asarray(x), jnp.asarray(g), jnp.asarray(h), jnp.asarray(w),
        jnp.asarray(lid), jnp.asarray(feats), jnp.asarray(const),
        jnp.float32(lam), L))
    tv, tc, tf = (a.numpy() for a in fit_leaves(*(torch.from_numpy(a) for a in (
        x, g, h, w, lid, feats, const)), lam, L))
    assert np.array_equal(tf, jf)
    assert not tf[4] and not tf[14] and tf[5] and tf[3]
    assert tf[2] == (lam > 0)
    assert np.all(np.abs(tv - jv) <= 1e-4 * np.maximum(1, np.abs(jv)))
    assert np.all(np.abs(tc - jc) <= 1e-4 * np.maximum(1, np.abs(jc)))
    assert np.all(tc[5] == 0) and tc[3, 2] == 0
    assert np.array_equal(tv[~tf], const[~tf])
    ov, oc = oracle(x, g, h, w, lid, feats, lam)
    fit = np.isfinite(ov)
    assert np.array_equal(fit, tf)
    for got, ref, want in ((tv[fit], jv[fit], ov[fit]),
                           (tc[fit], jc[fit], oc[fit])):
        slack = 8 * EPS * np.maximum(1, np.abs(want))
        assert np.all(np.abs(got - want) <= np.abs(ref - want) + slack)


def test_fit_leaves_from_the_partition_equals_from_leaf_ids():
    x, g, h, w, lid, feats, const = problem(1)
    t = [torch.from_numpy(a) for a in (x, g, h, w, lid, feats, const)]
    by_id = fit_leaves(*t, 0.01, L)
    perm, begin, rows = linear.segments_of(t[4], L)
    shuffled = torch.from_numpy(np.random.RandomState(2).permutation(L))
    # the grower's segments come in any order: move them around
    order = torch.cat([perm[int(begin[s]):int(begin[s] + rows[s])]
                       for s in shuffled])
    start = np.zeros(L, np.int64)
    pos = 0
    for s in shuffled.tolist():
        start[s] = pos
        pos += rows[s]
    by_part = fit_leaves(*t[:4], None, *t[5:], 0.01, L, perm=order,
                         leaf_begin=start, leaf_rows=rows)
    for a, b in zip(by_id, by_part):
        assert torch.equal(a, b)


def test_linear_solve_singular_and_unfitted_leaves_fall_back():
    d = K + 1
    a = torch.eye(d).repeat(3, 1, 1) * 4.0
    a[0] = 1.0                                        # rank one
    b = torch.ones(3, d)
    cnt = torch.tensor([100.0, 7.0, 100.0])           # leaf 1: 7 < 8
    feats = torch.tensor([[0, 1, 2]] * 3, dtype=torch.int32)
    const = torch.tensor([0.5, -0.25, 2.0])
    v, c, fitted = linear.linear_solve(a, b, cnt, feats, const, 0.0)
    assert fitted.tolist() == [False, False, True]
    assert v[:2].tolist() == [0.5, -0.25] and c[:2].abs().sum() == 0
    assert torch.allclose(v[2], torch.tensor(-0.25))


def test_wider_designs_are_refused_by_name():
    with pytest.raises(LightGBMError, match="tpu_linear_max_features"):
        linear.check_linear_features(linear.MAX_LINEAR_FEATURES + 1)


def test_linear_row_values_and_addend_match_jax():
    x, g, h, w, lid, feats, const = problem(3)
    rng = np.random.RandomState(4)
    coeff = rng.randn(L, K).astype(np.float32)
    coeff[feats < 0] = 0.0
    x[:7, feats[lid[:7], 0]] = 1e-40                  # subnormals
    ref = np.asarray(jax_rows(jnp.asarray(x), jnp.asarray(lid),
                              jnp.asarray(const), jnp.asarray(coeff),
                              jnp.asarray(feats)))
    tx, tl, tf = (torch.from_numpy(a) for a in (x, lid, feats))
    got = linear_row_values(tx, tl, torch.from_numpy(const),
                            torch.from_numpy(coeff), tf).numpy()
    assert np.all(np.abs(got - ref) <= 1e-6 * np.maximum(1, np.abs(ref)))
    add = np.asarray(jax_addend(jnp.asarray(coeff), jnp.asarray(feats),
                                jnp.asarray(lid), jnp.asarray(x)))
    score = torch.zeros(N)
    linear.linear_addend(tx, tl, torch.zeros(L), torch.from_numpy(coeff),
                         tf, score, 1.0)
    assert np.all(np.abs(score.numpy() - add)
                  <= 1e-6 * np.maximum(1, np.abs(add)))
    # scale -1 takes the same value off
    linear.linear_addend(tx, tl, torch.zeros(L), torch.from_numpy(coeff),
                         tf, score, -1.0)
    assert score.abs().max() == 0


def test_leaf_feature_moments_match_numpy_and_jax():
    """tests/test_linear_tree.py's moment test, run against both."""
    rng = np.random.RandomState(7)
    n, f, b, chunk = 256, 4, 16, 64
    binned = rng.randint(0, b, (n, f)).astype(np.uint8)
    x = rng.randn(n, f).astype(np.float32)
    x[3, 1] = np.nan
    g = rng.randn(n).astype(np.float32)
    h = np.abs(rng.randn(n)).astype(np.float32)
    m = (rng.rand(n) < 0.8).astype(np.float32)
    ids = np.array([0, 1, 2], np.int32)
    leaf_id = rng.randint(0, 3, n).astype(np.int32)
    weights = np.stack([g * m, h * m, m], axis=1)
    got = leaf_feature_moments(torch.from_numpy(binned), torch.from_numpy(x),
                               torch.from_numpy(weights),
                               torch.from_numpy(leaf_id), ids, b,
                               chunk=chunk).numpy()
    ref = np.asarray(jax_moments(jnp.asarray(binned), jnp.asarray(x),
                                 jnp.asarray(weights), jnp.asarray(leaf_id),
                                 ids, b, chunk=chunk))
    assert got.shape == ref.shape == (3, f, 4)
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
    xz = np.where(np.isfinite(x), x, 0.0)
    for c, lid in enumerate(ids):
        wl = m * (leaf_id == lid)
        for j in range(f):
            want = np.array([(wl * xz[:, j]).sum(),
                             (wl * xz[:, j] ** 2).sum(),
                             (wl * g * xz[:, j]).sum(),
                             (wl * h * xz[:, j]).sum()], np.float32)
            np.testing.assert_allclose(got[c, j], want, rtol=1e-5,
                                       atol=1e-5)


def test_moments_row_list_equals_leaf_ids_and_b_of_the_solver():
    """LM by leaf id over every leaf equals LM over one leaf's row list
    (its rows taken out, one id over a constant leaf_id), and its
    bin-summed sum w g x is the solver's b entry of that feature."""
    x, g, h, w, lid, feats, const = problem(5)
    x = np.nan_to_num(x)
    binned = np.clip((x + 1) * 16, 0, 31).astype(np.uint8)
    t = [torch.from_numpy(a) for a in (x, g, h, w, lid, feats)]
    w3 = torch.stack([t[1] * t[3], t[2] * t[3], t[3]], 1).contiguous()
    perm, begin, rows = linear.segments_of(t[4], L)
    leaf = 6
    sel = perm[int(begin[leaf]):int(begin[leaf] + rows[leaf])].long()
    by_rows = histogram.leaf_moments(
        torch.from_numpy(binned)[sel], t[0][sel], w3[sel], 32,
        leaf_id=torch.zeros(len(sel), dtype=torch.int32),
        ids=torch.zeros(1, dtype=torch.int32))
    by_id = histogram.leaf_moments(
        torch.from_numpy(binned), t[0], w3, 32, leaf_id=t[4],
        ids=torch.arange(L, dtype=torch.int32))
    assert torch.equal(by_rows[0], by_id[leaf])
    _, b_sum, _ = linear.linear_normal_eq(t[0], t[1], t[2], t[3], perm,
                                          begin, rows, t[5])
    sums = by_id.sum(dim=2)[leaf]
    for j in range(K):
        f = int(feats[leaf, j])
        assert abs(float(sums[f, 2] - b_sum[leaf, j])) <= 1e-5 * max(
            1.0, float(b_sum[leaf, j].abs()))


def test_moments_refuse_repeated_ids_by_name():
    """LM sorts the rows into one segment an id, so an id may appear
    once."""
    n = 16
    binned = torch.zeros((n, 2), dtype=torch.uint8)
    with pytest.raises(LightGBMError, match="distinct ids"):
        histogram.leaf_moments(binned, torch.ones(n, 2), torch.ones(n, 3), 4,
                               torch.zeros(n, dtype=torch.int32),
                               torch.tensor([0, 0], dtype=torch.int32))


@pytest.mark.parametrize("tile", [1, 3, 2048])
def test_segment_tiles_cover_each_segment_in_order(tile):
    """The tile table LF and LM launch over: each segment cut into runs
    of at most `tile` rows, in order, empty segments holding none."""
    rng = np.random.RandomState(tile)
    rows = rng.randint(0, 7000, 9)
    rows[[2, 5]] = 0
    begin = np.concatenate([[0], np.cumsum(rows)[:-1]])
    meta, n_tiles = histogram.segment_tiles(begin, rows, tile)
    tiles = meta[:3 * n_tiles].reshape(-1, 3)
    first, count = meta[3 * n_tiles:].reshape(2, -1)
    assert n_tiles == int(((rows + tile - 1) // tile).sum())
    for c in range(len(rows)):
        own = tiles[first[c]:first[c] + count[c]]
        assert (own[:, 0] == c).all() and (own[:, 2] <= tile).all()
        covered = np.concatenate([np.arange(s, s + r) for _, s, r in own]) \
            if len(own) else np.zeros(0, int)
        assert np.array_equal(covered, np.arange(begin[c],
                                                 begin[c] + rows[c]))
