"""H's warp-shared pass and its reduction, on the CPU.

On a uint16 matrix kernel H (csrc/histogram.cu) sums the groups of at
most 351 bins lane-private (hist_lane_kernel, `hist_plan`) and the wider
ones a warp a group over staged rows (hist_claim_kernel,
`hist_wide_plan`); a path of more than one row block (tile) writes f64
partials that one launch adds in eight chains and a fixed tree
(hist_sum_kernel). `leaf_histogram_order` replays both passes, which
chip_smoke.py holds the kernel to bit for bit on the card. Here the
replay is held to a scalar numpy walk of the order as the kernel's
source states it (bit for bit), to its own repeat, to
`leaf_histogram_plain` and to the JAX package's `leaf_histogram` and
`gathered_leaves_histogram` (counts exact, g/h within 1e-5 * max(1,
|ref|)), on row lists at the chunk's and the tile's edges, at the
narrow/wide edge and up to 2,048 bins, in both modes; to an f64 sum on
cancelling gradients of a wide group, where f32 chains miss; and the
plans are held to the card's shared memory and grid limits.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from lightgbm_tpu.ops import histogram as jh
from lightgbm_tpu_torch.ops.histogram import (
    HIST_CHAINS, HIST_CLUSTER_TILE_ROWS, HIST_MAX_CLUSTER,
    HIST_MIN_TILE_ROWS, HIST_SMEM_BYTES,
    HIST_STAGE_ROWS, HIST_TARGET_BLOCKS, HIST_WIDE_BLOCKS_PER_SM,
    HIST_WIDE_SMEM_BYTES, HIST_WIDE_WARPS,
    MAX_GROUP_BINS, hi_lo, hist_layout, hist_plan, hist_wide_plan,
    leaf_histogram_order, leaf_histogram_plain)

torch.set_num_threads(1)

# the card's shared memory a block may take (H100: 227 KB) and its grid
CARD_SMEM = 232_448
GRID_Y = 65_535
# the narrow/wide edge and the widths past it the kernel takes
WIDTHS = (5, 63, 351, 352, 631, 1023, 2048)
# the rows of a cluster of the least tiles
CLUSTER_ROWS = HIST_MAX_CLUSTER * HIST_MIN_TILE_ROWS


def inputs(seed, n, widths, scale=False):
    rs = np.random.RandomState(seed)
    bins = np.stack([rs.randint(0, w, n) for w in widths], 1) if n else \
        np.zeros((0, len(widths)), np.int64)
    w = (rs.rand(n) < 0.85).astype(np.float32)
    g = rs.randn(n) * 3
    if scale:  # a tenth of the rows +-2^60: which small values a bin's
        # f64 sum keeps depends on its order, and the f32 result shows it
        big = rs.rand(n) < 0.1
        g = np.where(big, np.sign(g) * 2.0 ** 60, g)
    w3 = np.stack([g * w, (rs.rand(n) + 0.01) * w, w], 1)
    return (torch.from_numpy(bins.astype(np.uint16)),
            torch.from_numpy(w3.astype(np.float32)))


def held(got, ref):
    got, ref = torch.as_tensor(np.asarray(got)), torch.as_tensor(
        np.asarray(ref))
    assert torch.equal(got[..., 2], ref[..., 2])
    d = (got[..., :2].double() - ref[..., :2].double()).abs()
    assert bool((d <= 1e-5 * ref[..., :2].double().abs().clamp(min=1.0))
                .all())


def scalar_order(bins, w3, widths, num_bins, bf16, lay):
    """The kernel's order as its source states it, one f64 add at a
    time: the lane-private pass, warp w of block x adding positions (x *
    warps + w) * run .. in order into its (group, bin) from +0 and the
    block adding its warps in order; the warp-shared pass, the warp of a
    group adding tile t's positions in order from +0 and cluster x adding
    its tiles x * C .. x * C + C - 1 in order; each output adding blocks
    (clusters) s, s + 8, ... in chain s and the chains in ((0+4)+(2+6)) +
    ((1+5)+(3+7)), rounded to f32 once."""
    f32, f64 = np.float32, np.float64
    n, g_all = bins.shape
    if bf16:
        hi, lo = hi_lo(torch.from_numpy(w3[:, :2].copy()))
        vals = hi.numpy().astype(f64) + lo.numpy().astype(f64)
    else:
        vals = w3[:, :2].astype(f64)
    out = np.zeros((g_all, num_bins, 3), f32)
    passes = []
    if len(lay.narrow):
        p = hist_plan(n, len(lay.narrow), lay.narrow_w)
        passes.append((lay.narrow, p.blocks, p.warps, p.run))
    if len(lay.wide):
        p = hist_wide_plan(n, len(lay.wide), lay.wide_w)
        passes.append((lay.wide, p.tiles // p.cluster, p.cluster,
                       p.tile_rows))
    for groups, blocks, warps, run in passes:
        gl, cols = len(groups), np.arange(len(groups))
        part = np.zeros((blocks, gl, num_bins, 2), f64)
        for x in range(blocks):
            for w in range(warps):
                acc = np.zeros((gl, num_bins, 2), f64)
                lo_ = (x * warps + w) * run
                for p in range(lo_, min(n, lo_ + run)):
                    b = bins[p, groups]
                    acc[cols, b] = acc[cols, b] + vals[p]
                part[x] = part[x] + acc
        a = np.zeros((HIST_CHAINS, gl, num_bins, 2), f64)
        for x in range(blocks):
            a[x % 8] = a[x % 8] + part[x]
        v = (((a[0] + a[4]) + (a[2] + a[6]))
             + ((a[1] + a[5]) + (a[3] + a[7]))).astype(f32)
        for i, g in enumerate(groups):
            out[g, :, :2] = v[i]
            out[g, :, 2] = np.bincount(bins[:, g], weights=w3[:, 2] > 0,
                                       minlength=num_bins)
            out[g, widths[g]:] = 0
    return out


@pytest.mark.parametrize("bf16", [False, True])
def test_replay_is_the_stated_order_bit_for_bit(bf16):
    """Both passes past eight blocks (clusters), so every chain and the
    tree are walked, and each repeats its bits."""
    widths = np.array([8, 5, 631, 3, 400])
    binned, w3 = inputs(11, 40_000, widths, scale=True)
    lay = hist_layout(widths, bf16)
    assert list(lay.wide) == [2, 4]
    assert hist_plan(40_000, 3, 8).blocks > 8
    wp = hist_wide_plan(40_000, 2, 631)
    assert wp.tiles // wp.cluster > 8 and wp.cluster > 1
    got = leaf_histogram_order(binned, w3, 631, bf16=bf16, layout=lay)
    want = scalar_order(binned.numpy().astype(np.int64), w3.numpy(),
                        widths, 631, bf16, lay)
    assert np.array_equal(got.numpy().view(np.int32), want.view(np.int32))
    again = leaf_histogram_order(binned, w3, 631, bf16=bf16, layout=lay)
    assert torch.equal(got.view(torch.int32), again.view(torch.int32))


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("m", [0, 1, 37, HIST_STAGE_ROWS - 1,
                               HIST_STAGE_ROWS + 1, CLUSTER_ROWS - 1,
                               CLUSTER_ROWS + 1])
def test_row_lists_at_the_chunk_and_tile_edges(m, bf16):
    """Row lists of 0, 1 and 37 rows, a chunk (the least tile) +- 1
    and a cluster of the least tiles +- 1: one cluster written out at
    once, or two clusters' partials added."""
    if m >= CLUSTER_ROWS - 1:
        wp = hist_wide_plan(m, 4, 2048)
        assert (wp.tiles // wp.cluster > 1) == (m > CLUSTER_ROWS)
    widths = np.array(WIDTHS)
    binned, w3 = inputs(m + 3, 6000, widths)
    lay = hist_layout(widths, bf16)
    rows = torch.from_numpy(np.random.RandomState(m).permutation(6000)
                            [:m + 5].astype(np.int32))
    got = leaf_histogram_order(binned, w3, 2048, rows=rows, n_rows=m,
                               bf16=bf16, layout=lay)
    held(got, leaf_histogram_plain(binned, w3, 2048, rows=rows, n_rows=m,
                                   bf16=bf16))
    for g, w in enumerate(widths):
        assert not got[g, w:].any()
    if m == 0:
        assert not got.any()


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "hi_lo"])
@pytest.mark.parametrize("mode", ["all_rows", "row_list"])
def test_replay_against_the_jax_histograms(mode, bf16):
    """The JAX package on the same seeded inputs (it pads every group to
    the widest): counts exact, g/h within 1e-5 * max(1, |ref|)."""
    chunk, n = 512, 5120
    widths = np.array(WIDTHS)
    binned, w3 = inputs(7, n, widths)
    jw3 = w3.numpy().copy()
    jw3[:, 2] = jw3[:, 2] > 0
    lay = hist_layout(widths, bf16)
    if mode == "all_rows":
        ref = jh.leaf_histogram(jnp.asarray(binned.numpy()), jnp.asarray(jw3),
                                2048, chunk=chunk, bf16=bf16)
        got = leaf_histogram_order(binned, w3, 2048, bf16=bf16, layout=lay)
    else:
        leaf_id = np.random.RandomState(5).randint(0, 3, n).astype(np.int32)
        rows = np.flatnonzero(leaf_id == 1).astype(np.int32)
        buf = np.zeros(-(-len(rows) // chunk) * chunk, np.int32)
        buf[:len(rows)] = rows
        ref = jh.gathered_leaves_histogram(
            jnp.asarray(binned.numpy()), jnp.asarray(jw3),
            jnp.asarray(leaf_id), jnp.asarray(buf),
            jnp.asarray([1], jnp.int32), 2048, chunk=chunk, bf16=bf16,
            n_valid=len(rows))[0]
        got = leaf_histogram_order(binned, w3, 2048,
                                   rows=torch.from_numpy(buf),
                                   n_rows=len(rows), bf16=bf16, layout=lay)
    held(got, np.array(ref))


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("edge", [351, 352, 631, 1023, 2048])
def test_each_width_against_the_plain_sums(edge, bf16):
    widths = np.array([edge, 63, edge, 2])
    binned, w3 = inputs(edge, 4099, widths)
    lay = hist_layout(widths, bf16)
    assert (list(lay.wide) == [0, 2]) == (edge > 351)
    got = leaf_histogram_order(binned, w3, edge, bf16=bf16, layout=lay)
    held(got, leaf_histogram_plain(binned, w3, edge, bf16=bf16))


@pytest.mark.parametrize("bf16", [False, True])
def test_a_wide_group_holds_cancelling_gradients(bf16):
    """60,000 rows in four bins of a 631-bin group, g ~ N(0, 0.5) less
    each bin's mean, so each bin sums to nearly 0: f32 chains of the
    values (as a warp-shared sum in f32 would add them) miss 1e-5 of
    the f64 sum; the replay's f64 chains hold it."""
    n, rs = 60_000, np.random.RandomState(17)
    bins = rs.randint(0, 4, n) * 157
    x = rs.randn(n) * 0.5
    x -= (np.bincount(bins, x, 631) / np.maximum(
        np.bincount(bins, minlength=631), 1))[bins]
    w3 = np.stack([x, rs.rand(n) * 0.25, np.ones(n)], 1).astype(np.float32)
    tw = torch.from_numpy(w3)
    lay = hist_layout([631], bf16)
    assert list(lay.wide) == [0]
    got = leaf_histogram_order(torch.from_numpy(bins.astype(np.uint16)[:,
                                                                    None]),
                               tw, 631, bf16=bf16, layout=lay).numpy()
    if bf16:
        hi, lo = hi_lo(tw[:, :2].contiguous())
        parts = [hi.numpy(), lo.numpy()]
    else:
        parts = [w3[:, :2]]
    ref = sum(np.stack([np.bincount(bins, p[:, c].astype(np.float64), 631)
                        for c in (0, 1)], 1) for p in parts)
    assert np.abs(ref[:, 0]).max() < 1.0
    assert np.all(np.abs(got[0, :, :2] - ref) <= 1e-5 * np.maximum(
        1.0, np.abs(ref)))
    chain = max(abs(float(np.cumsum(sum(p[bins == b, 0] for p in parts),
                                    dtype=np.float32)[-1]) - ref[b, 0])
                for b in (0, 157, 314, 471))
    assert chain > 1e-5


@pytest.mark.parametrize("groups", [1, 2, 3, 7, 8, 9, 28, 70, 338, 2048])
def test_wide_plan_stays_in_its_budgets(groups):
    for width in range(352, MAX_GROUP_BINS + 1):
        for n in (0, 1, 2049, 500_000, 2_000_000, 10_000_000):
            p = hist_wide_plan(n, groups, width)
            assert p.smem <= HIST_WIDE_SMEM_BYTES <= CARD_SMEM
            assert 1 <= p.warps <= HIST_WIDE_WARPS
            assert p.slices * p.warps >= groups > (p.slices - 1) * p.warps
            assert p.slices <= GRID_Y
            assert p.tile_rows % HIST_STAGE_ROWS == 0
            assert p.tile_rows >= HIST_MIN_TILE_ROWS
            # a whole number of clusters of the portable size at most,
            # the last one holding rows
            assert p.cluster in (1, 2, 4, HIST_MAX_CLUSTER)
            assert p.tiles % p.cluster == 0
            assert p.tiles * p.tile_rows >= n
            assert (p.tiles - p.cluster) * p.tile_rows < max(n, 1)
            # about two blocks an SM's worth of tiles over the slices;
            # clusters only of short tiles
            assert p.tiles - p.cluster < max(
                1, HIST_WIDE_BLOCKS_PER_SM * HIST_TARGET_BLOCKS // p.slices)
            assert p.cluster == 1 or p.tile_rows < HIST_CLUSTER_TILE_ROWS
            clusters = p.tiles // p.cluster
            assert p.partial_words == (clusters * groups * 3 * width
                                       if clusters > 1 else 0)


@pytest.mark.parametrize("groups", [1, 28, 268, 2048])
def test_lane_plan_stays_in_its_budgets(groups):
    for width in range(1, 352):
        for n in (0, 1, 21_856, 500_000, 10_000_000):
            p = hist_plan(n, groups, width)
            assert p.smem <= HIST_SMEM_BYTES <= CARD_SMEM
            assert p.slices <= GRID_Y
            assert p.blocks * p.warps * p.run >= n


def test_the_main_path_plans():
    # Bosch: 268 narrow groups of at most 63 bins, 70 of 631
    bosch = hist_layout([63] * 268 + [631] * 70, True)
    assert len(bosch.narrow) == 268 and len(bosch.wide) == 70
    assert hist_plan(500_000, 268, bosch.narrow_w)[:5] == (32, 5, 7168, 14,
                                                            9)
    # the root: 7 groups a block (two blocks an SM) in 10 slices, 26
    # tiles of 19,456 rows, each its own partial (260 blocks)
    wp = hist_wide_plan(500_000, 70, bosch.wide_w)
    assert wp[:5] == (7, 10, 19456, 26, 1) and wp.smem == 114_740
    # its root's smaller child as a row list: 22 tiles of 1,024 rows in 3
    # clusters; a few rows: a block a group, written out at once
    assert hist_wide_plan(21_856, 70, 631)[:5] == (7, 10, 1024, 24, 8)
    wp = hist_wide_plan(37, 70, 631)
    assert wp[:5] == (1, 70, HIST_MIN_TILE_ROWS, 1, 1)
    assert wp.partial_words == 0
    # max_bin=1023: 28 warp-shared groups, 4 a block (two blocks an SM)
    # in 7 slices, 37 tiles
    wp = hist_wide_plan(2_000_000, 28, 1023)
    assert wp[:5] == (4, 7, 54272, 37, 1) and wp.smem == 105_392
    # 2,048 bins: two groups a block, two blocks an SM (four fit one)
    assert hist_wide_plan(10 ** 6, 8, 2048)[:2] == (2, 4)
