"""Kernel S's grid of feature tiles and its block decomposition of the
scan (lightgbm_tpu_torch/ops/split.py split_plan, csrc/split_scan.cu),
on the CPU.

- The tile plan: every feature in exactly one tile, in order, at most
  SPLIT_MAX_WARPS a tile, the warps' shared regions within
  SPLIT_SMEM_BYTES, each region holding the staged [FB, 3] slice (and 3
  words of 16-byte alignment), the scans and the blocks' totals; checked
  on the feature metadata of Bosch-shaped, HIGGS, max_bin=1023 and
  categorical (Expo) Datasets from lightgbm_tpu_torch/testing/synth.py.
- The scan as the kernel splits it (a lane a block of 16 bins; the
  blocks' totals carried in lane order, in XLA's blocks of 16 again past
  16 blocks; each block's prefix added to its running sums), written in
  torch: bitwise equal to ops/split.py xla_cumsum and to the JAX
  package's jnp.cumsum (XLA's CPU backend) at FB 16, 64, 256, 1,023 and
  2,048, on values with cancellations, zeros and wide exponents.
- S's plain version on a Bosch-shaped leaf pair, with a feature mask,
  with a max_depth that blocks one leaf and with a leaf of no rows (no
  split valid: the flat-index-0 pick), against the JAX package's
  find_best_splits through lightgbm_tpu/learner/grow.py _leaf_best_split:
  the same feature, threshold and variant for each leaf where the two
  best gains are more than 1e-5 relative apart, and the same -inf and
  pick where no feature may split (the split values themselves are held
  by tests/test_torch_split.py and tests/test_torch_uint16.py).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from lightgbm_tpu.learner import grow as jgrow
from lightgbm_tpu.ops import split as jsplit
from lightgbm_tpu_torch.dataset import Dataset as TorchDataset
from lightgbm_tpu_torch.ops import histogram as th
from lightgbm_tpu_torch.ops import split
from lightgbm_tpu_torch.testing.synth import (synth_bosch, synth_expo,
                                              synth_higgs)

torch.set_num_threads(1)
CPU = torch.device("cpu")


def _bosch():
    x, y = synth_bosch(1500)
    return TorchDataset.from_numpy(x, y, max_bin=63)


def _higgs(max_bin):
    x, y = synth_higgs(1500)
    return TorchDataset.from_numpy(x, y, max_bin=max_bin)


def _expo():
    x, y, cats = synth_expo(1500, seed=13)
    return TorchDataset.from_numpy(x, y, max_bin=63,
                                   categorical_features=cats)


MAKERS = {"bosch": _bosch, "higgs": lambda: _higgs(63),
          "max_bin_1023": lambda: _higgs(1023), "expo": _expo}
_made = {}


def dataset(name):
    if name not in _made:
        _made[name] = MAKERS[name]()
    return _made[name]


@pytest.mark.parametrize("name", sorted(MAKERS))
def test_tile_plan_covers_every_feature_in_order_within_the_budget(name):
    ds = dataset(name)
    fm = ds.feature_meta_arrays()
    f_cnt = len(fm["num_bin"])
    fb = int(ds.num_bins_per_feature().max())
    plan = split.split_plan(f_cnt, fb)
    # block t of a leaf takes features t * per .. t * per + per - 1
    bounds = np.minimum(np.arange(plan.tiles + 1) * plan.per, f_cnt)
    assert bounds[0] == 0 and bounds[-1] == f_cnt
    sizes = np.diff(bounds)
    assert np.all(sizes >= 1) and np.all(sizes <= plan.per)
    assert plan.per <= split.SPLIT_MAX_WARPS
    assert len(sizes) == plan.tiles == -(-f_cnt // plan.per)
    # every feature in exactly one tile, in order
    tiles = np.repeat(np.arange(plan.tiles), sizes)
    assert np.array_equal(tiles, np.arange(f_cnt) // plan.per)
    # a warp's region: the staged slice with 3 words of alignment, the
    # scans and the blocks' totals, in 16-byte units
    blocks = -(-fb // split.XLA_SCAN_BASE)
    assert plan.region % 4 == 0
    assert plan.region >= (3 * fb + 3) + 3 * fb + 3 * blocks
    assert plan.smem == plan.per * plan.region * 4 <= split.SPLIT_SMEM_BYTES
    # as many tiles a leaf as the features allow, up to the target
    assert plan.tiles >= min(f_cnt, split.SPLIT_TARGET_TILES) or \
        plan.per == split.SPLIT_MAX_WARPS
    if name == "bosch":
        assert f_cnt == 968 and plan.per == split.SPLIT_MAX_WARPS


@pytest.mark.parametrize("fb", [1, 2048])
def test_tile_plan_at_the_scan_widths_s_takes(fb):
    plan = split.split_plan(968, fb)
    assert plan.smem <= split.SPLIT_SMEM_BYTES and plan.per >= 1
    with pytest.raises(split.LightGBMError):
        split.split_plan(968, split.MAX_FEATURE_BINS + 1)
    with pytest.raises(split.LightGBMError):
        split.split_plan(0, fb)


def block_scan(x: torch.Tensor) -> torch.Tensor:
    """The kernel's inclusive scan of x [..., FB]: lane b runs the running
    sum of block b of 16 bins; lane 0 carries the blocks' totals T in
    XLA's order into each block's prefix X[b - 1] (one running sum up to
    16 blocks; past that a running sum within each super-block of 16 plus
    the running sum of the finished super-blocks' totals); each lane adds
    its block's prefix to its running sums."""
    fb = x.shape[-1]
    base = split.XLA_SCAN_BASE
    blocks = -(-fb // base)
    out = torch.empty_like(x)
    totals = []
    for b in range(blocks):  # the lanes
        run = torch.zeros_like(x[..., 0])
        for t in range(b * base, min(fb, (b + 1) * base)):
            run = run + x[..., t]
            out[..., t] = run
        totals.append(run)
    two = blocks > base
    w = torch.zeros_like(x[..., 0])
    y = torch.zeros_like(w)
    prefix = [torch.zeros_like(w)]
    for b in range(1, blocks):  # lane 0, in lane order
        k = b - 1
        if two and k > 0 and k % base == 0:
            y = y + w
            w = torch.zeros_like(w)
        w = w + totals[k]
        prefix.append(w + y if two else w)
    for b in range(blocks):
        t0, t1 = b * base, min(fb, (b + 1) * base)
        out[..., t0:t1] = out[..., t0:t1] + prefix[b][..., None]
    return out


@pytest.mark.parametrize("fb", [16, 64, 256, 1023, 2048])
def test_block_scan_is_xla_cumsum_bitwise(fb):
    rng = np.random.RandomState(fb)
    x = (rng.randn(3, fb) * np.exp2(rng.randint(-20, 20, (3, fb)))).astype(
        np.float32)
    x[0, ::7] = 0.0
    half = x[1, 1::2].shape[-1]
    x[1, 1::2] = -x[1, ::2][:half]  # cancellations
    tx = torch.from_numpy(x)
    got = block_scan(tx)
    assert torch.equal(got.view(torch.int32),
                       split.xla_cumsum(tx).view(torch.int32))
    ref = np.asarray(jax.jit(lambda v: jnp.cumsum(v, axis=-1))(x))
    assert np.array_equal(got.numpy().view(np.int32), ref.view(np.int32))


def _pair(ds, rng):
    """A leaf pair of a seeded third of the rows and the rest: f32
    histograms [2, G, B, 3] and the totals [2, 3] added over group 0."""
    n = ds.binned.shape[0]
    grad = (rng.randn(n) * 0.5).astype(np.float32)
    hess = (rng.rand(n) * 0.25 + 0.05).astype(np.float32)
    w3 = torch.from_numpy(np.stack([grad, hess, np.ones(n, np.float32)], 1))
    perm = torch.from_numpy(rng.permutation(n).astype(np.int32))
    k = n // 3
    nb = int(ds.max_num_bin())
    hs = [th.leaf_histogram_plain(torch.from_numpy(ds.binned), w3, nb,
                                  rows=perm[a:], n_rows=c)
          for a, c in ((0, k), (k, n - k))]
    tot = []
    for h in hs:
        acc = np.zeros(3, np.float32)
        for row in h[0].numpy():
            acc = acc + row
        tot.append(acc)
    return torch.stack(hs), np.stack(tot)


CASES = ["pair", "feature_mask", "max_depth", "empty_leaf"]


def jax_pick(hist, tot, depth, mask, fm, cfg):
    """The JAX package's pick for one leaf (gain, feature, threshold,
    default_left, is_categorical, ...) and its features' gains."""
    gp = jgrow.GrowParams.from_config(cfg)
    fmeta = {k: jnp.asarray(fm[k]) for k in split.FMETA_KEYS}
    vals = jgrow._leaf_best_split(
        jnp.asarray(hist), jnp.float32(tot[0]), jnp.float32(tot[1]),
        jnp.float32(tot[2]), jnp.int32(depth), jnp.asarray(mask), fmeta,
        cfg, gp)
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


@pytest.mark.parametrize("case", CASES)
def test_plain_scan_picks_the_jax_split_on_a_bosch_pair(case):
    ds = dataset("bosch")
    fm = ds.feature_meta_arrays()
    f_cnt = len(fm["num_bin"])
    fb = int(ds.num_bins_per_feature().max())
    hist, tot = _pair(ds, np.random.RandomState(5))
    mask = np.ones(f_cnt, bool)
    depth = np.array([1, 1], np.int32)
    max_depth = -1
    if case == "feature_mask":
        mask = np.random.RandomState(11).rand(f_cnt) < 0.5
    elif case == "max_depth":
        max_depth = 2
        depth = np.array([0, 2], np.int32)
    elif case == "empty_leaf":
        hist[1].zero_()
        tot[1] = 0.0
    cfg = jgrow.GrowerConfig(
        num_leaves=31, max_bins=int(ds.max_num_bin()), chunk=256,
        lambda_l1=0.0, lambda_l2=0.0, min_gain_to_split=0.0,
        min_data_in_leaf=1, min_sum_hessian_in_leaf=1.0,
        max_depth=max_depth, feature_bins=fb)
    params = split.SplitParams(0.0, 0.0, 0.0, 1, 1.0, max_depth)
    out_f, out_i, _ = split.split_scan(
        hist, torch.from_numpy(tot), torch.from_numpy(depth),
        split.device_fmeta(fm, CPU),
        torch.from_numpy(mask.astype(np.uint8)), params, fb)
    for c in range(2):
        jv, jgain = jax_pick(hist[c].numpy(), tot[c], depth[c], mask, fm,
                             cfg)
        got = float(out_f[c, 0])
        assert np.isfinite(got) == np.isfinite(float(jv[0])), c
        if not np.isfinite(got):
            # no feature to split on: feature 0, at its own pick
            assert out_i[c, :2].tolist() == [int(jv[1]), int(jv[2])] and \
                int(jv[1]) == 0, c
            continue
        live = np.sort(jgain[mask & np.isfinite(jgain)])[::-1]
        gap = live[0] - (live[1] if len(live) > 1 else -np.inf)
        if gap > 1e-5 * max(1.0, abs(live[0])):
            assert out_i[c].tolist()[:3] == [int(jv[1]), int(jv[2]),
                                             int(bool(jv[3]))], c
    if case in ("max_depth", "empty_leaf"):
        assert float(out_f[1, 0]) == float("-inf")
    if case == "empty_leaf":
        # no split valid anywhere: the flat-index-0 pick, bin 0
        assert out_i[1, :2].tolist() == [0, 0]
