"""LM's launch plan, sort, tile table and summation order, on the CPU.

Kernel LM (csrc/moments.cu) sorts the rows by leaf id, cuts each id's
segment into tiles on the card and sums in a fixed order that depends on
its plan only: `ops/histogram.moment_plan` computes the plan on the
host, `moment_tiles` is the tile table as the kernel builds and reads
it, and `leaf_moments_order` replays the sums in torch ops, which
chip_smoke.py holds the kernel to bit for bit on the card. Here:

- the replay within 1e-5 * max(1, sum of its terms' |values|) of
  `leaf_moments_plain` (f64 sums rounded once) and of the JAX package's
  `batched_leaves_moments` / `leaf_moments`, the kernel's tolerance, on
  uint8 and uint16 bins up to MAX_GROUP_BINS, F of 1, 28, 32, 33 and 70,
  non-finite values, rows of no id, ids out of order, an id with no
  rows, bins past B and one id over a constant leaf_id; with small runs
  and tiles, so that several warps, tiles and slices add, and with the
  kernel's own plan; and a second replay repeating its bits;
- the tile table cutting segments of 0, 1, tile - 1, tile, tile + 1 and
  several tiles of rows as `segment_tiles` does, its partials in range;
- the sort's kernels (count, slot-major scan in blocks, scatter in
  turns of 32) replayed in numpy, equal to a stable argsort by slot;
- the plan's shared memory within the card's 227 KB at every B and F
  the wrapper takes.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from lightgbm_tpu.ops import histogram as jh
from lightgbm_tpu_torch.log import LightGBMError
from lightgbm_tpu_torch.ops.histogram import (
    MAX_GROUP_BINS, MOMENT_MAX_SORT_CELLS,
    MOMENT_MAX_WARPS, MOMENT_SCAN_CHUNK, MOMENT_SMEM_BYTES,
    leaf_moments_ids, leaf_moments_order, leaf_moments_plain, moment_plan,
    moment_tiles, segment_tiles)

torch.set_num_threads(1)

# the shared memory a block of an H100 may take (227 KB)
CARD_SMEM_BYTES = 232448


def inputs(seed, n, f, b, c, u16=False, one=False):
    """Seeded bins (some past b), values (some NaN or inf), channels with
    a tenth of the rows masked, and leaf ids: c ids in shuffled order,
    the last of which holds no row, and a few rows of no id; one=True:
    one id over a constant leaf_id."""
    rs = np.random.RandomState(seed)
    hi = b + 2 if u16 or b + 2 <= 256 else 256
    bins = rs.randint(0, hi, (n, f)).astype(np.uint16 if u16 else np.uint8)
    x = rs.randn(n, f).astype(np.float32)
    x[rs.rand(n, f) < 0.03] = np.nan
    x[rs.rand(n, f) < 0.02] = -np.inf
    m = (rs.rand(n) < 0.9).astype(np.float32)
    w3 = np.stack([rs.randn(n) * m, (rs.rand(n) + 0.1) * m, m],
                  1).astype(np.float32)
    if one:
        ids = np.array([3], np.int32)
        leaf = np.full(n, 3, np.int32)
    else:
        ids = (rs.permutation(c) * 3 + 1).astype(np.int32)
        leaf = ids[rs.randint(0, max(c - 1, 1), n)]
        leaf[rs.rand(n) < 0.05] = -7
    return bins, x, w3, leaf, ids


def torch_args(bins, x, w3, leaf, ids, b):
    return (torch.from_numpy(bins), torch.from_numpy(x),
            torch.from_numpy(w3), b, torch.from_numpy(leaf),
            torch.from_numpy(ids))


def term_scale(bins, x, w3, leaf, ids, b):
    """[C, F, B, 4] f64: the sums of the terms' absolute values."""
    xv = np.where(np.isfinite(x), x, 0.0).astype(np.float64)
    w = w3.astype(np.float64)
    t = np.abs(np.stack([xv * w[:, 2:3], xv * xv * w[:, 2:3],
                         xv * w[:, 0:1], xv * w[:, 1:2]], -1))
    out = np.zeros((len(ids), x.shape[1], b, 4))
    fr = np.arange(x.shape[1])
    for c, v in enumerate(ids):
        rows = np.flatnonzero(leaf == v)
        bb = bins[rows].astype(np.int64)
        keep = bb < b
        np.add.at(out[c], (np.broadcast_to(fr, bb.shape)[keep], bb[keep]),
                  t[rows][keep])
    return out


def held(got, ref, scale):
    got = np.asarray(got, np.float64)
    assert got.shape == ref.shape
    assert np.all(np.abs(got - ref) <= 1e-5 * np.maximum(1.0, scale))


# (u16, n, f, b, c, run, wide_tile): small runs and tiles, so that a
# tile has several warps, a slot several tiles and F several slices
CASES = [
    (False, 1500, 1, 64, 5, 32, 0),
    (False, 3000, 28, 64, 16, 64, 0),
    (False, 2000, 32, 2, 7, 32, 0),
    (False, 2500, 33, 256, 6, 64, 0),
    (False, 1200, 70, 64, 4, 32, 0),
    (True, 1500, 1, 300, 5, 0, 96),
    (True, 3000, 28, 1024, 16, 0, 256),
    (True, 1000, 33, 2048, 3, 0, 160),
    (True, 900, 70, 257, 4, 0, 128),
]


@pytest.mark.parametrize("u16,n,f,b,c,run,tile", CASES)
def test_replay_is_within_the_plain_sums_and_repeats(u16, n, f, b, c, run,
                                                      tile):
    data = inputs(n + f + b, n, f, b, c, u16)
    args = torch_args(*data, b)
    plan = moment_plan(n, f, b, c, u16, run=run or 1024,
                       wide_tile=tile or 32768)
    assert plan.slices * plan.width >= f
    got = leaf_moments_order(*args, plan=plan)
    assert torch.equal(got, leaf_moments_order(*args, plan=plan))
    scale = term_scale(*data, b)
    held(got, leaf_moments_plain(*args).double().numpy(), scale)
    # the last id holds no row
    assert c == 1 or not got[-1].any()


@pytest.mark.parametrize("u16,b", [(False, 64), (True, 1024)])
def test_replay_with_the_kernel_plan(u16, b):
    n, f, c = 5000, 28, 9
    data = inputs(b, n, f, b, c, u16)
    args = torch_args(*data, b)
    got = leaf_moments_order(*args)
    held(got, leaf_moments_plain(*args).double().numpy(),
         term_scale(*data, b))


@pytest.mark.parametrize("u16,n,f,b,c", [
    (False, 1024, 28, 64, 5), (False, 1024, 33, 16, 3),
    (True, 1024, 3, 2048, 4)])
def test_replay_is_within_the_jax_moments(u16, n, f, b, c):
    bins, x, w3, leaf, ids = inputs(7 * b + f, n, f, b, c, u16)
    ref = np.asarray(jh.batched_leaves_moments(
        jnp.asarray(bins), jnp.asarray(x), jnp.asarray(w3),
        jnp.asarray(leaf), jnp.asarray(ids), b, chunk=512))
    plan = moment_plan(n, f, b, c, u16, run=32, wide_tile=128)
    got = leaf_moments_order(*torch_args(bins, x, w3, leaf, ids, b),
                             plan=plan)
    held(got, ref.astype(np.float64), term_scale(bins, x, w3, leaf, ids, b))


@pytest.mark.parametrize("u16,b", [(False, 64), (True, 1500)])
def test_one_id_over_a_constant_leaf_id_is_the_jax_leaf_moments(u16, b):
    n, f = 1024, 4
    bins, x, w3, leaf, ids = inputs(b, n, f, b, 1, u16, one=True)
    ref = np.asarray(jh.leaf_moments(jnp.asarray(bins), jnp.asarray(x),
                                     jnp.asarray(w3), b, chunk=512))
    plan = moment_plan(n, f, b, 1, u16, run=32, wide_tile=96)
    got = leaf_moments_order(*torch_args(bins, x, w3, leaf, ids, b),
                             plan=plan)
    assert got.shape == (1, f, b, 4)
    held(got[0], ref.astype(np.float64),
         term_scale(bins, x, w3, leaf, ids, b)[0])


@pytest.mark.parametrize("tile", [1, 7, 192, 3072])
def test_tile_table_cuts_segments_as_segment_tiles(tile):
    rows = np.array([0, 1, tile - 1, tile, tile + 1, 3 * tile + 5, 0,
                     2 * tile, 5], np.int64)
    begin = np.concatenate([[0], np.cumsum(rows)])
    n, c = int(rows.sum()), len(rows)
    max_tiles = -(-n // tile) + c
    tiles, first, count, pfirst = moment_tiles(begin, tile, max_tiles)
    meta, n_tiles = segment_tiles(begin[:-1], rows, tile)
    assert len(tiles) == n_tiles <= max_tiles
    assert np.array_equal(tiles[:, :3], meta[:3 * n_tiles].reshape(-1, 3))
    assert np.array_equal(first, meta[3 * n_tiles:3 * n_tiles + c])
    assert np.array_equal(count, meta[3 * n_tiles + c:])
    # a slot of one tile writes the output; the others' tiles take
    # distinct partials, fewer than ceil(2n / tile)
    part = tiles[:, 3]
    assert np.array_equal(part < 0, count[tiles[:, 0]] == 1)
    assert len(set(part[part >= 0])) == int((part >= 0).sum())
    assert part.max(initial=-1) < max(1, -(-2 * n // tile))
    for s in np.flatnonzero(count > 1):
        own = part[first[s]:first[s] + count[s]]
        assert np.array_equal(own, pfirst[s] + np.arange(count[s]))


def sort_replay(slot, c_cnt, sort_tiles):
    """The sort's kernels in numpy: per sort tile (a warp) its rows'
    counts by slot; the slot-major exclusive scan in blocks of
    MOMENT_SCAN_CHUNK counters (block sums scanned by the last block,
    then each block's chunk); per tile, in turns of 32, each row written
    at its slot's offset plus its rank among the turn's lanes of that
    slot."""
    n = len(slot)
    rows = -(-n // sort_tiles)
    cnt = np.zeros((c_cnt, sort_tiles), np.int64)
    for t in range(sort_tiles):
        seg = slot[t * rows:(t + 1) * rows]
        np.add.at(cnt[:, t], seg[seg >= 0], 1)
    flat = cnt.reshape(-1)
    blocks = -(-len(flat) // MOMENT_SCAN_CHUNK)
    bsum = np.array([flat[b * MOMENT_SCAN_CHUNK:(b + 1) * MOMENT_SCAN_CHUNK]
                     .sum() for b in range(blocks)])
    bbase = np.concatenate([[0], np.cumsum(bsum)[:-1]])
    off = np.zeros_like(flat)
    for b in range(blocks):
        chunk = flat[b * MOMENT_SCAN_CHUNK:(b + 1) * MOMENT_SCAN_CHUNK]
        off[b * MOMENT_SCAN_CHUNK:b * MOMENT_SCAN_CHUNK + len(chunk)] = \
            bbase[b] + np.cumsum(chunk) - chunk
    off = off.reshape(c_cnt, sort_tiles)
    begin = np.append(off[:, 0], bsum.sum())
    order = np.full(int(bsum.sum()), -1, np.int64)
    for t in range(sort_tiles):
        for i0 in range(t * rows, min(n, (t + 1) * rows), 32):
            lanes = slot[i0:min(n, (t + 1) * rows, i0 + 32)]
            for lane, s in enumerate(lanes):
                if s >= 0:
                    order[off[s, t] + np.sum(lanes[:lane] == s)] = i0 + lane
            for s in np.unique(lanes[lanes >= 0]):
                off[s, t] += np.sum(lanes == s)
    return order, begin


@pytest.mark.parametrize("n,c", [(1, 1), (100, 3), (5000, 9), (6000, 2000),
                                 (4097, 1)])
def test_sort_replay_is_a_stable_argsort_by_slot(n, c):
    rs = np.random.RandomState(n + c)
    slot = rs.randint(-1, c, n)
    plan = moment_plan(n, 3, 64, c, False)
    assert plan.sort_tiles * c <= MOMENT_MAX_SORT_CELLS
    assert plan.scan_blocks == -(-plan.sort_tiles * c // MOMENT_SCAN_CHUNK)
    order, begin = sort_replay(slot, c, plan.sort_tiles)
    keep = np.flatnonzero(slot >= 0)
    assert np.array_equal(order, keep[np.argsort(slot[keep],
                                                 kind="stable")])
    assert np.array_equal(begin, np.concatenate(
        [[0], np.cumsum(np.bincount(slot[keep], minlength=c))]))


def test_sort_tiles_stay_under_the_counter_cap():
    for n, c in ((2_000_000, 255), (2_000_000, 131_072), (10 ** 8, 4096),
                 (5, 3_000_000)):
        plan = moment_plan(n, 28, 64, c, False)
        assert 1 <= plan.sort_tiles and plan.sort_tiles * c <= max(
            MOMENT_MAX_SORT_CELLS, c)
        assert -(-n // plan.sort_tiles) * plan.sort_tiles >= n


def test_plan_fits_the_card_at_every_width():
    for wide, widths in ((False, range(1, 257)),
                         (True, range(1, MAX_GROUP_BINS + 1))):
        for b in widths:
            for f in (1, 2, 3, 28, 32, 33, 70, 1000):
                p = moment_plan(2_000_000, f, b, 255, wide)
                assert p.smem <= MOMENT_SMEM_BYTES <= CARD_SMEM_BYTES
                assert 1 <= p.warps <= MOMENT_MAX_WARPS
                assert p.gw & (p.gw - 1) == 0 and p.gw <= 32
                assert p.slices * p.width >= f > (p.slices - 1) * p.width
                if wide:
                    assert p.gw == 1 and p.warps == p.width <= f
                else:
                    assert p.width == p.gw and p.tile % 32 == 0


def test_host_ids_refuse_repeats_and_equal_tensor_ids():
    bins, x, w3, leaf, ids = inputs(1, 300, 3, 16, 4)
    args = torch_args(bins, x, w3, leaf, ids, 16)
    with pytest.raises(LightGBMError, match="distinct ids"):
        leaf_moments_ids(*args[:5], [1, 4, 1])
    assert torch.equal(leaf_moments_ids(*args[:5], list(ids)),
                       leaf_moments_plain(*args))
