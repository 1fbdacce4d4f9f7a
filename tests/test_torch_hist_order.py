"""H's summation order and launch plan, on the CPU.

Kernel H's lane-private mode (csrc/histogram.cu hist_lane_kernel) sums
in a fixed order that depends on the launch plan only:
`ops/histogram.hist_plan` computes the plan on the host and
`leaf_histogram_order` replays the order in torch ops, which chip_smoke.py
holds the kernel to bit for bit on the card. Here the replay is held to
`leaf_histogram_plain` (f64 sums rounded once): counts exact, g/h within
1e-5 * max(1, |ref|), the kernel's check against its plain version; and
to a scalar numpy walk of the order as the kernel's source states it, bit
for bit. The plan is checked against its budgets, and the longest run it
makes against cancelling gradients, where f32 chains of f32 values miss
that check in any order.
"""
import numpy as np
import pytest
import torch

from lightgbm_tpu_torch.log import LightGBMError
from lightgbm_tpu_torch.ops.histogram import (
    HIST_MAX_RUN, HIST_MAX_WARPS, HIST_MIN_GROUPS, HIST_MIN_RUN,
    HIST_SLOT_BYTES, HIST_SMEM_BYTES, HIST_TARGET_BLOCKS, hi_lo,
    hist_layout, hist_plan,
    leaf_histogram_order, leaf_histogram_plain)

torch.set_num_threads(1)


def inputs(seed, n, g, b, dtype=np.uint8, widths=None, skew=False):
    rs = np.random.RandomState(seed)
    hi = np.full(g, b) if widths is None else np.asarray(widths)
    bins = np.stack([rs.randint(0, w, n) for w in hi], 1) if n else \
        np.zeros((0, g), np.int64)
    if skew and n:
        bins[rs.rand(n, g) < 0.8] = 0
    w = (rs.rand(n) < 0.85).astype(np.float32)
    w3 = np.stack([rs.randn(n) * 3 * w, (rs.rand(n) + 0.01) * w, w], 1)
    return (torch.from_numpy(bins.astype(dtype)),
            torch.from_numpy(w3.astype(np.float32)))


def held(got, ref):
    assert torch.equal(got[..., 2], ref[..., 2])
    d = (got[..., :2] - ref[..., :2]).abs()
    assert bool((d <= 1e-5 * ref[..., :2].abs().clamp(min=1.0)).all())


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("n,g,b", [
    (0, 28, 64), (1, 28, 64), (31, 1, 2), (33, 33, 64), (3001, 28, 64),
    (5123, 40, 64), (2111, 28, 256), (4099, 33, 256), (777, 1, 256),
    (9000, 40, 2)])
def test_replay_is_within_the_plain_sums(n, g, b, bf16):
    binned, w3 = inputs(n + g + b, n, g, b)
    got = leaf_histogram_order(binned, w3, b, bf16=bf16)
    assert got.shape == (g, b, 3)
    held(got, leaf_histogram_plain(binned, w3, b, bf16=bf16))


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("m", [0, 1, 37, 2500])
def test_row_lists_including_empty(m, bf16):
    binned, w3 = inputs(5, 6000, 28, 64)
    rows = torch.from_numpy(np.random.RandomState(m).permutation(6000)
                            [:m + 3].astype(np.int32))
    got = leaf_histogram_order(binned, w3, 64, rows=rows, n_rows=m,
                               bf16=bf16)
    ref = leaf_histogram_plain(binned, w3, 64, rows=rows, n_rows=m,
                               bf16=bf16)
    held(got, ref)
    if m == 0:
        assert not got.any()


@pytest.mark.parametrize("bf16", [False, True])
def test_uint16_narrow_groups(bf16):
    """Bosch-like widths: the lane-private groups are replayed, each at
    its own width, and so are the warp-shared (631-bin) groups."""
    rs = np.random.RandomState(3)
    widths = rs.randint(2, 64, 40)
    widths[[3, 17, 30]] = 631
    binned, w3 = inputs(7, 7000, 40, 631, np.uint16, widths, skew=True)
    lay = hist_layout(widths, bf16)
    assert sorted(lay.wide) == [3, 17, 30]
    got = leaf_histogram_order(binned, w3, 631, bf16=bf16, layout=lay)
    ref = leaf_histogram_plain(binned, w3, 631, bf16=bf16)
    held(got, ref)
    assert got[lay.wide].any()
    for g in range(40):
        assert not got[g, widths[g]:].any()
    rows = torch.from_numpy(rs.permutation(7000)[:3001].astype(np.int32))
    held(leaf_histogram_order(binned, w3, 631, rows=rows, n_rows=3001,
                              bf16=bf16, layout=lay),
         leaf_histogram_plain(binned, w3, 631, rows=rows, n_rows=3001,
                              bf16=bf16))
    with pytest.raises(LightGBMError, match="hist_layout"):
        leaf_histogram_order(binned, w3, 631, bf16=bf16)


def scalar_order(bins, w3, b, bf16, plan):
    """The kernel's order as its source states it, one f64 add at a
    time: warp w of block x adds the values (hi + lo in hi+lo mode) of
    positions (x * warps + w) * run .. in order into its (group, bin)
    from +0; the block adds its warps in order; each output adds blocks
    s, s + 8, ... in chain s and the chains in ((0+4)+(2+6)) +
    ((1+5)+(3+7)), rounded to f32 once."""
    f32, f64 = np.float32, np.float64
    n, g = bins.shape
    if bf16:
        hi, lo = hi_lo(torch.from_numpy(w3[:, :2].copy()))
        vals = hi.numpy().astype(f64) + lo.numpy().astype(f64)
    else:
        vals = w3[:, :2].astype(f64)
    cf = vals.shape[1]
    part = np.zeros((plan.blocks, g, b, cf), f64)
    cols = np.arange(g)
    for x in range(plan.blocks):
        for w in range(plan.warps):
            acc = np.zeros((g, b, cf), f64)
            lo_ = (x * plan.warps + w) * plan.run
            for p in range(lo_, min(n, lo_ + plan.run)):
                acc[cols, bins[p]] = acc[cols, bins[p]] + vals[p]
            part[x] = part[x] + acc
    chains = np.zeros((8, g, b, cf), f64)
    for x in range(plan.blocks):
        chains[x % 8] = chains[x % 8] + part[x]
    a = chains
    v = (((a[0] + a[4]) + (a[2] + a[6])) + ((a[1] + a[5]) + (a[3] + a[7]))
         ).astype(f32)
    cnt = np.zeros((g, b), f32)
    for k in range(g):
        cnt[k] = np.bincount(bins[:, k], weights=w3[:, 2] > 0, minlength=b)
    return np.concatenate([v, cnt[..., None]], -1)


@pytest.mark.parametrize("bf16", [False, True])
def test_replay_is_the_stated_order_bit_for_bit(bf16):
    """More than eight blocks of the plan, so every chain and the tree
    are walked; the values span magnitudes so the order shows."""
    n, g, b = 40_000, 3, 8
    binned, w3 = inputs(11, n, g, b)
    w3[:, 0] *= torch.from_numpy(
        10.0 ** np.random.RandomState(2).randint(-3, 4, n)).float()
    plan = hist_plan(n, g, b)
    assert plan.blocks > 8
    got = leaf_histogram_order(binned, w3, b, bf16=bf16).numpy()
    want = scalar_order(binned.numpy().astype(np.int64), w3.numpy(), b,
                        bf16, plan)
    assert np.array_equal(got.view(np.int32), want.view(np.int32))


@pytest.mark.parametrize("n", [0, 1, 1000, 65_536, 262_144, 966_119,
                               2_000_000, 10_000_000])
@pytest.mark.parametrize("g,b", [(1, 2), (28, 64), (33, 64), (40, 64),
                                 (28, 256), (268, 64), (5, 320)])
def test_plan_stays_in_its_budgets(n, g, b):
    plan = hist_plan(n, g, b)
    slots = plan.gw * (b + 1)
    assert plan.smem == plan.warps * (slots + slots % 2) * HIST_SLOT_BYTES
    assert plan.smem <= HIST_SMEM_BYTES <= 227 * 1024
    assert 1 <= plan.warps <= HIST_MAX_WARPS
    assert plan.gw in (1, 2, 4, 8, 16, 32)
    assert plan.slices * plan.gw >= g > (plan.slices - 1) * plan.gw
    assert plan.run % 32 == 0
    assert HIST_MIN_RUN <= plan.run <= HIST_MAX_RUN
    assert plan.blocks * plan.warps * plan.run >= n
    assert (plan.blocks - 1) * plan.warps * plan.run < max(n, 1)
    # one row block writes the output itself, more write f64 partials
    assert plan.partial_words == (plan.blocks * 3 * b * plan.slices
                                  * plan.gw if plan.blocks > 1 else 0)
    # about one block an SM over all the slices, unless the runs are capped
    assert plan.run == HIST_MAX_RUN or plan.blocks <= max(
        1, -(-HIST_TARGET_BLOCKS // plan.slices))
    if n >= HIST_TARGET_BLOCKS * plan.warps * HIST_MAX_RUN:
        assert plan.run == HIST_MAX_RUN
    # two warps at the least where a warp takes its 16 groups or more
    if plan.gw >= HIST_MIN_GROUPS:
        assert plan.warps >= 2


def test_the_main_path_plans():
    # the HIGGS root: 2,000,000 rows x 28 groups at B 64
    # (the same in both modes, 20 bytes a slot)
    assert hist_plan(2_000_000, 28, 64)[:5] == (32, 5, 3040, 132, 1)
    # max_bin 255: 16 groups a warp, two warps a block
    assert hist_plan(65_536, 28, 256)[:2] == (16, 2)
    # a small row list: runs of one turn, spread over blocks
    assert hist_plan(1000, 28, 64)[2:4] == (32, 7)
    # the Bosch root's 268 narrow groups: 9 slices of 32, 14 row blocks
    # of 5 warps a slice (about one block an SM over all the slices)
    assert hist_plan(500_000, 268, 63)[:5] == (32, 5, 7168, 14, 9)
    with pytest.raises(LightGBMError):
        hist_plan(10, 0, 64)


@pytest.mark.parametrize("bf16,edge", [(True, 351), (False, 351)])
def test_the_lane_private_width_limit(bf16, edge):
    lay = hist_layout([edge, edge + 1, 2, 631], bf16)
    assert list(lay.narrow) == [0, 2] and list(lay.wide) == [1, 3]
    assert lay.narrow_w == edge
    plan = hist_plan(1000, len(lay.narrow), lay.narrow_w)
    assert plan.warps >= 2


@pytest.mark.parametrize("bf16", [False, True])
def test_the_longest_run_holds_cancelling_gradients(bf16):
    """At HIST_MAX_RUN rows a warp (the plan's cap) and 4 bins a chain adds
    about 1,000 rows, and the gradients of each bin (either sign, 0.5
    spread) sum to nearly 0: the check then asks for 1e-5 absolute, which
    f32 chains of f32 values, or of the bf16 halves, miss at this run
    length; the kernel's f64 sums hold it."""
    b = 4
    warps = hist_plan(10 ** 7, 1, b).warps
    n = HIST_TARGET_BLOCKS * warps * HIST_MAX_RUN
    assert hist_plan(n, 1, b).run == HIST_MAX_RUN
    rs = np.random.RandomState(17)
    bins = rs.randint(0, b, n)
    x = rs.randn(n) * 0.5
    x -= (np.bincount(bins, x, b) / np.bincount(bins, minlength=b))[bins]
    w3 = torch.from_numpy(np.stack([x, rs.rand(n) * 0.25, np.ones(n)], 1)
                          .astype(np.float32))
    binned = torch.from_numpy(bins.astype(np.uint8)[:, None])
    got = leaf_histogram_order(binned, w3, b, bf16=bf16)
    ref = leaf_histogram_plain(binned, w3, b, bf16=bf16)
    assert float(ref[..., 0].abs().max()) < 1.0
    held(got, ref)
