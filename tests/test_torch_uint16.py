"""uint16 group bins (groups of more than 256 bins) in the port against
the JAX package, on the CPU.

Two fixtures give uint16 matrices, as the JAX package builds them:
- Bosch-like: 3,000 rows x 68 features, 6 mutually exclusive one-hot
  blocks of 10 and 8 sparse numerics, max_bin 63; EFB bundles each block
  into one group of 631 bins, 14 groups in all;
- max_bin=1023: 2,000 rows x 4 dense features, single-feature groups of
  667 bins, the only features S scans past 256 bins.

Held here:
- the binned matrices equal the JAX package's bit for bit;
- H's plain version, f32 and hi+lo, against the JAX `leaf_histogram`
  and `gathered_leaves_histogram`: counts exact, g/h within 1e-5 *
  max(1, |ref|) (f32 sums in another order);
- H's uint16 layout and plans (`hist_layout`, `hist_plan`,
  `hist_wide_plan`): the narrow groups keep the lane-private scheme, the
  wide ones go a warp a group, and the partials' traffic stays at most a
  quarter of the input's bytes at the Bosch shape;
- S's plain version at 667 bins a feature choosing the JAX split wherever
  the top two gains are further apart than the f32 tolerance;
- R's and W's plain versions bitwise the JAX routing (each node of the
  JAX trees, through `predict_leaf_binned`) and `predict_value_binned`;
- `train` on both fixtures under tpu_hist_bf16 true and false: the same
  trees, raw predictions within 1e-5 * max(1, |ref|);
- `testing.synth.synth_bosch` bitwise bench.py's `synth_bosch`.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import bench
import lightgbm_tpu as jlgb
import lightgbm_tpu_torch as tlgb
from lightgbm_tpu.dataset import Dataset as JaxDataset
from lightgbm_tpu.learner import grow as jgrow
from lightgbm_tpu.ops import histogram as jh
from lightgbm_tpu.ops import predict as jpredict
from lightgbm_tpu.ops import split as jsplit
from lightgbm_tpu_torch.dataset import Dataset as TorchDataset
from lightgbm_tpu_torch.learner.grow import GrowerConfig, SerialGrower
from lightgbm_tpu_torch.log import LightGBMError
from lightgbm_tpu_torch.ops.histogram import (HIST_MIN_TILE_ROWS,
                                              hist_layout, hist_plan,
                                              hist_wide_plan, leaf_histogram,
                                              leaf_histogram_plain)
from lightgbm_tpu_torch.ops.predict import (binned_tree,
                                            tree_leaf_walk_binned,
                                            tree_value_walk_binned)
from lightgbm_tpu_torch.ops.route import SplitRule, route_partition
from lightgbm_tpu_torch.ops.split import (FMETA_KEYS, SplitParams,
                                          device_fmeta, split_scan,
                                          split_scan_plain)
from lightgbm_tpu_torch.testing.synth import synth_bosch

torch.set_num_threads(1)
CPU = torch.device("cpu")
CHUNK = 512


def bosch_like(n, seed, blocks=6, f=68):
    """bench.py's Bosch shape cut to `blocks` one-hot blocks of 10 and
    f - 10 * blocks sparse numerics."""
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


def wide_bins(n, seed):
    rng = np.random.RandomState(seed)
    x = rng.randn(n, 4)
    x[rng.rand(n) < 0.1, 1] = np.nan
    y = (x[:, 0] + 0.5 * np.nan_to_num(x[:, 1]) - x[:, 2] * x[:, 3]
         + 0.5 * rng.randn(n) > 0).astype(np.float32)
    return x, y


FIXTURES = {"bosch": (bosch_like, 3000, 63), "max_bin_1023":
            (wide_bins, 2000, 1023)}


def datasets(name):
    make, n, max_bin = FIXTURES[name]
    x, y = make(n, 0)
    return (x, y, max_bin,
            JaxDataset.from_numpy(x, y, max_bin=max_bin),
            TorchDataset.from_numpy(x, y, max_bin=max_bin))


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_binned_matrix_equals_the_jax_one_bitwise(name):
    _, _, _, jd, td = datasets(name)
    assert td.binned.dtype == np.uint16 == jd.binned.dtype
    assert np.array_equal(td.binned, jd.binned)
    assert np.array_equal(td.groups.group_num_bin, jd.groups.group_num_bin)
    widths = td.groups.group_num_bin
    if name == "bosch":
        assert td.num_groups == 14 and widths.max() == 631
    else:
        assert td.num_groups == 4 and widths.min() > 256


def channels(n, seed):
    rng = np.random.RandomState(seed)
    w = np.where(np.arange(n) % 3 == 0, 0.5, 1.0).astype(np.float32)
    w[rng.rand(n) < 0.1] = 0.0
    grad = (rng.randn(n) * 0.7).astype(np.float32)
    hess = (rng.rand(n) * 0.25 + 1e-3).astype(np.float32)
    return np.stack([grad * w, hess * w, w], 1).astype(np.float32)


def close(got, ref):
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    assert np.array_equal(got[..., 2], ref[..., 2])
    bound = 1e-5 * np.maximum(1.0, np.abs(ref[..., :2]))
    assert np.all(np.abs(got[..., :2] - ref[..., :2]) <= bound)


@pytest.mark.parametrize("bf16", [True, False], ids=["hi_lo", "f32"])
@pytest.mark.parametrize("mode", ["all_rows", "row_list"])
def test_histogram_on_uint16_bins_against_the_jax_histogram(mode, bf16):
    _, _, _, jd, td = datasets("bosch")
    binned = td.binned
    n = binned.shape[0] - binned.shape[0] % CHUNK
    binned = binned[:n]
    w3 = channels(n, 4)
    b = int(td.groups.group_num_bin.max())
    jw3 = w3.copy()
    jw3[:, 2] = w3[:, 2] > 0
    tb, tw = torch.from_numpy(binned), torch.from_numpy(w3)
    if mode == "all_rows":
        ref = jh.leaf_histogram(jnp.asarray(binned), jnp.asarray(jw3), b,
                                chunk=CHUNK, bf16=bf16)
        got = leaf_histogram(tb, tw, b, bf16=bf16, layout=hist_layout(
            td.groups.group_num_bin, bf16))
    else:
        leaf_id = np.random.RandomState(5).randint(0, 4, n).astype(np.int32)
        rows = np.flatnonzero(leaf_id == 1).astype(np.int32)
        buf = np.zeros(-(-len(rows) // CHUNK) * CHUNK, np.int32)
        buf[:len(rows)] = rows
        ref = jh.gathered_leaves_histogram(
            jnp.asarray(binned), jnp.asarray(jw3), jnp.asarray(leaf_id),
            jnp.asarray(buf), jnp.asarray([1], jnp.int32), b, chunk=CHUNK,
            bf16=bf16, n_valid=len(rows))[0]
        got = leaf_histogram(tb, tw, b, rows=torch.from_numpy(buf),
                             n_rows=len(rows), bf16=bf16)
    close(got, ref)
    # a bin past a group's own width holds nothing
    narrow = td.groups.group_num_bin < b
    assert not np.asarray(got)[narrow, 63:].any()
    assert np.asarray(got)[~narrow, 600:, 2].sum() > 0


def test_uint16_plan_keeps_narrow_groups_lane_private_and_partials_small():
    # 4,000 rows give the Bosch groups' widths (every one-hot block 631
    # bins wide); the plan is checked at the Bosch root's 500,000
    x, _ = synth_bosch(4_000)
    ds = TorchDataset.from_numpy(x, np.zeros(len(x)), max_bin=63)
    widths = ds.groups.group_num_bin
    assert ds.binned.dtype == np.uint16 and ds.num_groups == 338
    assert (widths == 631).sum() == 70 and (widths <= 64).sum() == 268
    n, g = 500_000, ds.num_groups
    for bf16 in (True, False):
        lay = hist_layout(widths, bf16)
        assert set(lay.wide) == set(np.flatnonzero(widths == 631))
        assert lay.narrow_w <= 64 and lay.wide_w == 631
        assert lay.dev[0][:-1].tolist() == widths.tolist()
        # the Bosch root: the 70 wide groups 7 a block in 10 slices, 26
        # tiles of 19,456 rows, the same in both modes
        wp = hist_wide_plan(n, len(lay.wide), lay.wide_w)
        assert wp[:5] == (7, 10, 19456, 26, 1)
        lp = hist_plan(n, len(lay.narrow), lay.narrow_w)
        for rows in (False, True):
            in_bytes = n * (2 * g + 12 + 4 * rows)
            # f64 partials, each written once and read once
            traffic = (lp.partial_words + wp.partial_words) * 8 * 2
            assert traffic * 4 <= in_bytes
        # a small leaf is one cluster of tiles of the least size, written
        # out at once; a larger one writes its clusters' partials
        assert hist_wide_plan(1000, 70, 631)[2:5] == (HIST_MIN_TILE_ROWS, 4,
                                                      4)
        assert hist_wide_plan(1000, 70, 631).partial_words == 0
        assert hist_wide_plan(4096, 70, 631)[2:5] == (HIST_MIN_TILE_ROWS, 16,
                                                      8)
    # plain versions read uint16 bins as their values
    tb = torch.from_numpy(ds.binned[:512].copy())
    w3 = torch.from_numpy(channels(512, 1))
    h = leaf_histogram_plain(tb, w3, 631)
    on = w3[:, 2].numpy() > 0
    ref = np.stack([np.bincount(ds.binned[:512, k], weights=on,
                                minlength=631) for k in range(g)])
    assert np.array_equal(h[..., 2].numpy(), ref)


def jax_pick(hist, tot, fm, cfg):
    fmeta = {k: jnp.asarray(fm[k]) for k in FMETA_KEYS}
    vals = jgrow._leaf_best_split(
        jnp.asarray(hist), jnp.float32(tot[0]), jnp.float32(tot[1]),
        jnp.float32(tot[2]), jnp.int32(0),
        jnp.ones(len(fm["num_bin"]), bool), fmeta, cfg,
        jgrow.GrowParams.from_config(cfg))
    fh = jgrow._extract_feature_hist(jnp.asarray(hist), tot[0], tot[1],
                                     tot[2], fmeta, cfg)
    res = jsplit.find_best_splits(
        fh, jnp.float32(tot[0]), jnp.float32(tot[1]), jnp.float32(tot[2]),
        fmeta["num_bin"], fmeta["missing_type"], fmeta["default_bin"],
        fmeta["is_categorical"], lambda_l1=cfg.lambda_l1,
        lambda_l2=cfg.lambda_l2, min_gain_to_split=cfg.min_gain_to_split,
        min_data_in_leaf=cfg.min_data_in_leaf,
        min_sum_hessian_in_leaf=cfg.min_sum_hessian_in_leaf)
    return [np.asarray(v) for v in vals], np.asarray(res.gain)


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_split_scan_past_256_bins_chooses_the_jax_split(name):
    _, _, _, jd, td = datasets(name)
    fm = td.feature_meta_arrays()
    nb = int(td.num_bins_per_feature().max())
    b = td.max_num_bin()
    if name == "max_bin_1023":
        assert nb == 667
    cfg = jgrow.GrowerConfig(
        num_leaves=8, max_bins=b, chunk=CHUNK, lambda_l1=0.0,
        lambda_l2=0.0, min_gain_to_split=0.0, min_data_in_leaf=5,
        min_sum_hessian_in_leaf=1e-3, max_depth=-1, feature_bins=nb)
    params = SplitParams(0.0, 0.0, 0.0, 5, 1e-3, -1)
    n = td.num_data - td.num_data % CHUNK
    binned = td.binned[:n]
    rng = np.random.RandomState(9)
    w3 = channels(n, 2)
    w3[:, 2] = 1.0
    _, y = FIXTURES[name][0](FIXTURES[name][1], 0)
    w3[:, 0] += (y[:n] - 0.5).astype(np.float32)
    checked = 0
    for sel in (np.ones(n, bool), rng.rand(n) < 0.4):
        w = w3 * sel[:, None]
        hist = np.array(jh.leaf_histogram(
            jnp.asarray(binned), jnp.asarray(w), b, CHUNK, bf16=False))
        tot = hist[0].sum(axis=0).astype(np.float32)
        jv, jgain = jax_pick(hist, tot, fm, cfg)
        args = (torch.zeros(1, dtype=torch.int32), device_fmeta(fm, CPU),
                torch.ones(td.num_features, dtype=torch.uint8), params, nb)
        out_f, out_i, fgain = split_scan(
            torch.tensor(hist)[None], torch.from_numpy(tot)[None], *args)
        fgain = fgain[0].numpy()
        assert np.array_equal(np.isfinite(fgain), np.isfinite(jgain))
        fin = np.isfinite(jgain)
        oracle = split_scan_plain(
            torch.tensor(hist, dtype=torch.float64)[None],
            torch.from_numpy(tot.astype(np.float64))[None], *args)[2][0]
        oracle = oracle.numpy()
        parent = float(tot[0]) ** 2 / (float(tot[1]) + 2e-15)
        jerr = np.abs(jgain[fin] - oracle[fin])
        tol = jerr + 1e-5 * np.maximum(1.0, np.abs(oracle[fin]) + parent)
        assert np.all(np.abs(fgain[fin] - oracle[fin]) <= jerr + tol)
        order = np.sort(jgain[fin])[::-1]
        if len(order) > 1 and order[0] - order[1] > 2 * tol.max():
            assert out_i[0, 0].item() == int(jv[1])
            assert out_i[0, 1].item() == int(jv[2])
            assert bool(out_i[0, 2].item()) == bool(jv[3])
            checked += 1
    assert checked >= 1


PARAMS = {"objective": "binary", "num_leaves": 15, "learning_rate": 0.3,
          "min_data_in_leaf": 10, "min_sum_hessian_in_leaf": 1.0,
          "verbose": -1}


def assert_same_trees(jb, tb):
    jt, tt = jb._inner.models, tb._inner.models
    assert len(jt) == len(tt) > 0
    for i, (a, b) in enumerate(zip(jt, tt)):
        m = a.num_leaves - 1
        assert a.num_leaves == b.num_leaves, i
        for k in ("split_feature", "threshold_in_bin", "decision_type",
                  "left_child", "right_child"):
            assert np.array_equal(getattr(a, k)[:m], getattr(b, k)[:m]), \
                (i, k)
        assert np.array_equal(a.leaf_count, b.leaf_count), i


_trained = {}


def trained(name, bf16):
    key = (name, bf16)
    if key not in _trained:
        make, n, max_bin = FIXTURES[name]
        x, y = make(n, 0)
        params = dict(PARAMS, max_bin=max_bin)
        if not bf16:
            params["tpu_hist_bf16"] = False
        rounds = 4
        jb = jlgb.train(dict(params), jlgb.Dataset(x, y), rounds)
        tds = tlgb.Dataset(x, y)
        tb = tlgb.train(dict(params), tds, rounds, device="cpu")
        _trained[key] = (x, y, jb, tb, tds)
    return _trained[key]


@pytest.mark.parametrize("bf16", [True, False], ids=["hi_lo", "f32"])
@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_training_on_uint16_bins_grows_the_jax_trees(name, bf16):
    x, _, jb, tb, tds = trained(name, bf16)
    assert tds._lazy_init().binned.dtype == np.uint16
    assert tb._inner._binned.dtype == torch.uint16
    assert tb._inner._grower.cfg.hist_bf16 is bf16
    assert_same_trees(jb, tb)
    xv, _ = FIXTURES[name][0](500, 1)
    ref = jb.predict(xv, raw_score=True)
    got = tb.predict(xv, raw_score=True)
    assert np.all(np.abs(got - ref) <= 1e-5 * np.maximum(1.0, np.abs(ref)))


def subtree_leaves(tree, node):
    """The leaf indices under internal node `node`."""
    out, stack = [], [node]
    while stack:
        k = stack.pop()
        if k < 0:
            out.append(~k)
        else:
            stack += [tree.left_child[k], tree.right_child[k]]
    return out


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_route_and_walk_on_uint16_bins_equal_the_jax_routing(name):
    x, _, jb, tb, tds = trained(name, True)
    inner = tds._lazy_init()
    binned = torch.from_numpy(inner.binned)
    n = binned.shape[0]
    fm = inner.feature_meta_arrays()
    routed = 0
    for jt, tt in zip(jb._inner.models, tb._inner.models):
        jleaf = np.asarray(jpredict.predict_leaf_binned(
            jt.to_device(), jnp.asarray(inner.binned)))
        bt = binned_tree(tt, CPU)
        assert np.array_equal(tree_leaf_walk_binned(bt, binned).numpy(),
                              jleaf)
        # the JAX tree's leaf values (the port's own are within 1e-5)
        score = torch.zeros(n)
        tree_value_walk_binned(binned_tree(tt, CPU, jt.leaf_value), binned,
                               score)
        jval = np.asarray(jpredict.predict_value_binned(
            jt.to_device(), jnp.asarray(inner.binned)))
        assert np.array_equal(score.numpy(), jval)
        # each node's split, applied by R to the rows that reach it
        for k in range(tt.num_leaves - 1):
            at = np.flatnonzero(np.isin(jleaf, subtree_leaves(jt, k)))
            left = np.isin(jleaf, subtree_leaves(jt, jt.left_child[k]))
            f = int(tt.split_feature_inner[k])
            rule = SplitRule(
                group=int(fm["group"][f]), offset=int(fm["offset"][f]),
                num_bin=int(fm["num_bin"][f]),
                default_bin=int(fm["default_bin"][f]),
                missing_type=int(fm["missing_type"][f]),
                bundled=bool(fm["is_bundled"][f]),
                threshold=int(tt.threshold_in_bin[k]),
                default_left=bool(tt.default_left_node(k)),
                is_cat=False, left_slot=1, right_slot=2)
            perm = torch.arange(n, dtype=torch.int32)
            perm[:len(at)] = torch.from_numpy(at.astype(np.int32))
            leaf_id = torch.zeros(n, dtype=torch.int32)
            n_left = int(route_partition(binned, perm, 0, len(at), rule,
                                         leaf_id))
            assert n_left == int(left[at].sum())
            assert np.array_equal(np.sort(perm[:n_left].numpy()),
                                  at[left[at]])
            assert np.array_equal(leaf_id[at].numpy(),
                                  np.where(left[at], 1, 2))
            routed += bool(fm["is_bundled"][f])
    if name == "bosch":
        assert routed > 0  # splits on features inside 631-bin groups


def test_synth_bosch_is_bench_synth_bosch_bitwise():
    for n, seed in ((257, 2), (1000, 5)):
        x, y = synth_bosch(n, seed=seed)
        bx, by = bench.synth_bosch(n, seed=seed)
        assert x.dtype == bx.dtype and y.dtype == by.dtype
        assert np.array_equal(x.view(np.int32), bx.view(np.int32))
        assert np.array_equal(y, by)


@pytest.mark.parametrize("bf16", [True, False], ids=["hi_lo", "f32"])
def test_grower_makes_the_uint16_layout_once_from_the_group_widths(bf16):
    td = datasets("bosch")[4]
    binned = torch.from_numpy(td.binned)
    widths = td.groups.group_num_bin
    cfg = GrowerConfig(num_leaves=7, hist_bf16=bf16)
    args = (binned, td.feature_meta_arrays(), cfg, int(widths.max()),
            int(td.num_bins_per_feature().max()))
    lay = SerialGrower(*args, widths).hist_layout
    assert lay.bf16 == bf16 and np.array_equal(lay.widths, widths)
    assert np.array_equal(lay.dev[0].numpy()[:-1], widths)
    assert np.array_equal(lay.dev[1].numpy()[:-1], lay.narrow)
    assert np.array_equal(lay.dev[2].numpy()[:-1], lay.wide)
    with pytest.raises(LightGBMError, match="group_bins"):
        SerialGrower(*args)
    # a uint8 matrix keeps its path: no layout
    x, y = bosch_like(600, 1)
    small = TorchDataset.from_numpy(x[:, 60:], y, max_bin=15)
    assert small.binned.dtype == np.uint8
    assert SerialGrower(torch.from_numpy(small.binned),
                        small.feature_meta_arrays(), cfg,
                        small.max_num_bin(),
                        int(small.num_bins_per_feature().max()),
                        small.groups.group_num_bin).hist_layout is None
