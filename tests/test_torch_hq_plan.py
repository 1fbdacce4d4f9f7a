"""Kernel HQ's plan and its skipped-bin identity (lightgbm_tpu_torch/
ops/histogram.py i32_plan, i32_slices, i32_grid; csrc/histogram.cu
hist_i32_kernel), on the CPU.

- The skipped-bin identity, in torch: every row holds one bin of each
  group below the group's width, so in int32 a group's skipped bin is
  the rows' totals (sum q_g * c, sum q_h * c, sum c) minus the group's
  other bins. Summing every row outside its group's skipped bin, block
  by block of HQ's row blocks (i32_grid), filling each block's skipped
  bins from its totals and adding the blocks gives exactly
  leaf_histogram_i32_plain and the JAX package's quantized
  leaf_histogram / gathered_leaves_histogram: on sparse Bosch-shaped
  uint16 bins and on dense uint8 bins, with w01 zeros (bagging), all
  rows and row lists, int8 and int16 codes, under the plan's skipped
  bins (the bin most rows hold) and under skipped bins no row holds.
- The plan against its budgets: slices of consecutive groups of one
  kind, in order, covering every group; interleaved slices only of
  groups up to HQ_INTERLEAVE_BINS bins and packed ones of wider groups,
  each within HIST_I32_WORDS words and no slice able to take its next
  group; packed groups' first words; the partial's layout; the skipped
  bin the most-held one; the row blocks' grid.
- A plan of another matrix is refused by name, as the card's kernel
  refuses it.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from lightgbm_tpu.ops import histogram as jh
from lightgbm_tpu_torch.dataset import Dataset as TorchDataset
from lightgbm_tpu_torch.log import LightGBMError
from lightgbm_tpu_torch.ops import histogram as th
from lightgbm_tpu_torch.ops.rng import fold_in, prng_key
from lightgbm_tpu_torch.testing.synth import synth_bosch, synth_higgs

torch.set_num_threads(1)
CHUNK = 500
_made = {}


def matrix(name):
    """(binned, group widths or None, num_bins): a Bosch-shaped uint16
    matrix (synth_bosch, 968 features in 338 EFB groups) or a dense
    uint8 one (synth_higgs at max_bin 63)."""
    if name not in _made:
        if name == "bosch_u16":
            x, y = synth_bosch(2000)
            td = TorchDataset.from_numpy(x, y, max_bin=63)
            assert td.binned.dtype == np.uint16
            _made[name] = (td.binned, td.groups.group_num_bin.copy(),
                           int(td.max_num_bin()))
        else:
            x, y = synth_higgs(2000)
            td = TorchDataset.from_numpy(x, y, max_bin=63)
            assert td.binned.dtype == np.uint8
            _made[name] = (td.binned, None, int(td.max_num_bin()))
    return _made[name]


def codes_of(n, mode, seed):
    """The quantizer's codes and 0/1 weight of seeded gradients, a fifth
    of the rows out of the bag; and the JAX package's w3 of them."""
    rng = np.random.RandomState(seed)
    grad = torch.from_numpy((rng.randn(n) * 0.7).astype(np.float32))
    hess = torch.from_numpy((rng.rand(n) * 0.25 + 1e-3).astype(np.float32))
    w = torch.from_numpy((rng.rand(n) >= 0.2).astype(np.float32))
    key = fold_in(prng_key(seed), 0)
    q = th.quantize_gradients(grad, hess, w, qmax=th.train_qmax(mode, n),
                              key_g=fold_in(key, 0), key_h=fold_in(key, 1),
                              reciprocal_scale=False)
    w01 = q.w01.numpy()
    codes = q.codes.numpy().astype(np.float32)
    w3 = np.stack([codes[:, 0] * w01, codes[:, 1] * w01, w01], 1)
    return q.codes, q.w01, w3


def skip_identity(binned, codes, w01, num_bins, plan, rows=None,
                  n_rows=None):
    """HQ's arithmetic in torch: per row block of i32_grid, the int32 sums
    of the rows outside their group's skipped bin, the skipped bin filled
    as the block's totals minus its other bins; the blocks added."""
    tb = torch.from_numpy(binned)
    sel = torch.arange(binned.shape[0]) if rows is None \
        else rows[:n_rows].long()
    n, g_cnt = len(sel), binned.shape[1]
    blocks, chunk, _ = th.i32_grid(plan, n, 8)
    skip = torch.from_numpy(plan.skip.astype(np.int64))
    widths = torch.from_numpy(plan.widths.astype(np.int64))
    out = torch.zeros((g_cnt, num_bins, 3), dtype=torch.int32)
    for x in range(blocks):
        part = sel[x * chunk:(x + 1) * chunk]
        bins = th.take_bins(tb, part)
        c = (w01[part] > 0).to(torch.int64)
        vals = torch.stack([codes[part, 0].long() * c,
                            codes[part, 1].long() * c, c], 1)
        keep = (bins != skip[None, :]) & (bins < widths[None, :])
        flat = (torch.arange(g_cnt) * num_bins)[None, :] + bins
        h = torch.zeros(g_cnt * num_bins, 3, dtype=torch.int64)
        h.index_add_(0, flat[keep], vals[:, None, :].expand(
            -1, g_cnt, 3)[keep])
        h = h.view(g_cnt, num_bins, 3)
        totals = vals.sum(0)
        rest = totals[None, :] - h.sum(1)
        h[torch.arange(g_cnt), skip] = rest
        out += h.to(torch.int32)
    return out


@pytest.mark.parametrize("skipped", ["most_held", "held_by_none"])
@pytest.mark.parametrize("rows", ["all_rows", "row_list"])
@pytest.mark.parametrize("mode", ["int8", "int16"])
@pytest.mark.parametrize("name", ["bosch_u16", "higgs_u8"])
def test_skipped_bin_identity_is_the_int32_histogram(name, mode, rows,
                                                     skipped):
    binned, widths, nb = matrix(name)
    n = binned.shape[0]
    codes, w01, w3 = codes_of(n, mode, 5)
    tb = torch.from_numpy(binned)
    plan = th.i32_plan(tb, nb, widths)
    sel = cnt = None
    if rows == "row_list":
        sel = torch.from_numpy(np.random.RandomState(6).permutation(n)[
            :n // 3].astype(np.int32))
        cnt = n // 3
    if skipped == "held_by_none":
        held = th.leaf_histogram_i32_plain(
            tb, codes, torch.ones(n), nb, sel, cnt)[..., 2].numpy()
        skip = plan.skip.copy()
        for g, w in enumerate(plan.widths):
            none = np.flatnonzero(held[g, :w] == 0)
            if len(none):
                skip[g] = none[0]
        assert np.any(skip != plan.skip)
        plan = th.i32_plan(tb, nb, widths, skip=skip)
    got = skip_identity(binned, codes, w01, nb, plan, sel, cnt)
    ref = th.leaf_histogram_i32_plain(tb, codes, w01, nb, sel, cnt)
    assert got.dtype == torch.int32 and torch.equal(got, ref)
    gw = None if widths is None else tuple(int(w) for w in widths)
    if rows == "all_rows":
        jref = np.asarray(jh.leaf_histogram(
            jnp.asarray(binned), jnp.asarray(w3), nb, CHUNK, quantize=mode,
            group_widths=gw))
    else:
        leaf_id = np.zeros(n, np.int32)
        leaf_id[sel.numpy()] = 1
        member = np.flatnonzero(leaf_id == 1)
        buf = np.zeros(-(-len(member) // CHUNK) * CHUNK, np.int32)
        buf[:len(member)] = member
        jref = np.asarray(jh.gathered_leaves_histogram(
            jnp.asarray(binned), jnp.asarray(w3), jnp.asarray(leaf_id),
            jnp.asarray(buf), jnp.asarray(np.array([1], np.int32)), nb,
            CHUNK, n_valid=len(member), quantize=mode, group_widths=gw))[0]
    assert np.array_equal(got.numpy(), jref)


@pytest.mark.parametrize("name", ["bosch_u16", "higgs_u8"])
def test_plan_slices_and_skipped_bins_within_their_budgets(name):
    binned, widths, nb = matrix(name)
    tb = torch.from_numpy(binned)
    plan = th.i32_plan(tb, nb, widths)
    g_cnt = binned.shape[1]
    w = plan.widths.astype(np.int64)
    if widths is None:
        assert np.all(w == nb)
    s = plan.slices
    # consecutive groups, in order, every group once
    assert s[0, 0] == 0 and s[-1, 0] + s[-1, 1] == g_cnt
    assert np.all(s[1:, 0] == s[:-1, 0] + s[:-1, 1]) and np.all(s[:, 1] >= 1)
    words = []
    for g0, gc, wn, wd in s:
        grp = w[g0:g0 + gc]
        if wn:
            assert grp.max() <= th.HQ_INTERLEAVE_BINS and wn == grp.max()
            assert wd == 96 * wn * -(-gc // 32)
        else:
            assert grp.min() > th.HQ_INTERLEAVE_BINS
            assert np.array_equal(plan.woff[g0:g0 + gc],
                                  np.concatenate([[0], np.cumsum(3 * grp)
                                                  [:-1]]))
            assert wd == (3 * grp.sum() + 3) // 4 * 4
        assert wd <= th.HIST_I32_WORDS and wd % 4 == 0
        words.append(int(wd))
    # no slice could have taken its next group of the same kind
    for (g0, gc, wn, wd), nxt in zip(s[:-1], s[1:]):
        g = g0 + gc
        if (w[g] <= th.HQ_INTERLEAVE_BINS) == bool(wn):
            grown = (96 * max(wn, w[g]) * -(-(gc + 1) // 32) if wn
                     else (3 * (w[g0:g + 1]).sum() + 3) // 4 * 4)
            assert grown > th.HIST_I32_WORDS
    assert np.array_equal(plan.sbase, np.concatenate([[0], np.cumsum(
        words)[:-1]]))
    assert plan.part_words == sum(words) and plan.slice_words == max(words)
    # the skipped bin: the one most rows hold, the lowest of equal counts
    counts = th.group_counts(tb, w)
    assert np.array_equal(plan.skip, counts.argmax(1))
    assert np.all(plan.skip < w)
    if name == "bosch_u16":
        # the sparse numerics' zero bin holds most of their rows
        narrow = w <= th.HQ_INTERLEAVE_BINS
        share = counts[np.arange(g_cnt), plan.skip] / binned.shape[0]
        assert share[narrow].mean() > 0.5
        assert len(s) > 1 and {bool(x) for x in s[:, 2]} == {True, False}


def test_row_blocks_grid():
    binned, widths, nb = matrix("bosch_u16")
    plan = th.i32_plan(torch.from_numpy(binned), nb, widths)
    row_bytes = 2 * binned.shape[1] + 8
    for n in (1, 1000, 39_589, 500_000):
        blocks, chunk, xs = th.i32_grid(plan, n, row_bytes)
        assert chunk % 32 == 0 and blocks * chunk >= n
        assert (blocks - 1) * chunk < n
        assert blocks * len(plan.slices) <= max(
            th.HQ_TARGET_BLOCKS + len(plan.slices), len(plan.slices))
        assert blocks == 1 or chunk >= th.HQ_MIN_ROWS
        assert 1 <= xs <= blocks
    assert th.i32_grid(plan, 1000, row_bytes)[0] == 1


def test_plan_of_another_matrix_is_refused_by_name():
    binned = torch.zeros((8, 3), dtype=torch.uint16)
    plan = th.i32_plan(binned, 631, [631, 63, 63])
    th.check_i32_plan(binned, 631, plan)
    for bad in (None, th.i32_plan(binned[:, :2], 631, [631, 63])):
        with pytest.raises(LightGBMError,
                           match="leaf_histogram_i32: the card's kernel "
                           "takes the i32_plan"):
            th.check_i32_plan(binned, 631, bad)
    with pytest.raises(LightGBMError, match="takes the i32_plan"):
        th.check_i32_plan(binned, 600, plan)
    u8 = torch.zeros((8, 3), dtype=torch.uint8)
    with pytest.raises(LightGBMError, match="takes the i32_plan"):
        th.check_i32_plan(u8, 64, th.i32_plan(u8, 32))
    with pytest.raises(LightGBMError, match="skipped bin"):
        th.i32_plan(binned, 631, [631, 63, 63], skip=[0, 63, 0])
