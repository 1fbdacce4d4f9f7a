"""Leaf histograms: kernel H's wrapper, its plain PyTorch version, and
the sibling subtraction.

Counterpart of `lightgbm_tpu/ops/histogram.py` on the f32 path:
`leaf_histogram` (:333, all rows) and `gathered_leaves_histogram` (:474,
a compacted row list), plus `subtract` (:785). Both compute

    hist[g, b] = sum over rows r in the set
                 of 1[bin[r, g] == b] * (g_r*w_r, h_r*w_r, 1[w_r > 0])

from the channel matrix w3 = [N, 3] (g*w, h*w, w). The JAX package's
`batched_leaves_histogram` (:402) computes the same sum over the rows
whose `leaf_id` is one id; the serial grower keeps each leaf's rows
contiguous in its permutation, so it passes them as a row list.

Two modes of the g and h sums, as the JAX package's `bf16` argument
(`tpu_hist_bf16`, true by default) chooses them:
- f32 (`bf16=False`): the f32 values g*w and h*w are summed;
- hi+lo (`bf16=True`): each value v is split as `_hi_lo` (:52) splits
  it, hi = bf16(v) and lo = bf16(v - f32(hi)), rounded as XLA's CPU
  backend rounds (`hi_lo`); the hi and the lo halves are summed apart
  in f32 and added once, after all rows, into the [G, B, 3] histogram
  (`leaf_histogram` :379-396). hi + lo keeps about 16 bits of v, so the
  two modes grow different trees wherever a split is decided in the
  low bits, and the port grows the JAX package's under either setting.
The count channel is exact in both. Siblings subtract on the merged
histogram (`subtract`, :785).

On a CUDA tensor `leaf_histogram` launches the hand-written kernel
(`csrc/histogram.cu`) or raises; on a CPU tensor it runs the plain
version. The kernel sums in f64 in a fixed order that depends on its
launch plans only (`hist_plan`, `hist_wide_plan`, computed here on the
host); `leaf_histogram_order` replays that order in torch ops. A uint16
matrix (groups of more than 256 bins, up to 2,048) takes the kernel's
uint16 modes: each group at its own width (`hist_layout`, made once for
a grower), the groups too wide for a lane-private column summed
warp-shared, a warp a group, in tiles of rows. The wrapper counts its
launches in `leaf_histogram.launches`, and those in hi+lo mode also in
`leaf_histogram.launches_hilo`, those on uint16 bins in
`leaf_histogram.launches_u16`. HQ and LM take uint16 bins too (their
uint16 modes count in `leaf_histogram_i32.launches_u16` and
`leaf_moments.launches_u16`): HQ reads the groups by its own plan
(`i32_plan`: slices of groups at their own widths and each group's
skipped bin, made once for a Dataset) and LM adds a warp's lanes of
one bin in lane order, by rounds of integer claims.

Quantized training (`tpu_hist_quantize=int8|int16`, the JAX section at
:60-156 and `_quant_u`/`_quant_merge` :291-330) adds two kernels:

- Q, `quantize_gradients` (`csrc/quantize.cu`): the gradients and
  hessians, scaled by their absolute maxima and stochastically rounded
  with JAX's threefry stream (`ops/rng.py`) to integer codes in
  [-qmax, qmax], the 0/1 in-bag weight and the [3] dequantization scale,
  in one cooperative launch (`quantize_plan`) over a scratch zeroed once
  a device and stream;
- HQ, `leaf_histogram_i32` (`csrc/histogram.cu`): the [G, B, 3] int32
  histogram (sum q_g*w01, sum q_h*w01, sum w01) of those codes. The TPU
  splits int16 codes into base-256 bf16 digits so its matrix unit sums
  them exactly and merges the digits in int32; integer sums do not
  depend on their order, so the port's histogram equals the merged JAX
  one bitwise. Siblings subtract in int32 through `subtract`.

Linear trees add kernel LM, `leaf_moments` (`csrc/moments.cu`): per
(leaf id, feature, bin) the raw-value moments (sum x*m, sum x^2*m, sum
x*g*m, sum x*h*m) of the rows whose leaf id is one of C ids: the JAX
package's `batched_leaves_moments` (:679), the mode `linear/stats.py`
runs and sums over bins. Its all-rows `leaf_moments` (:622) is one id
over a constant leaf_id; its row-list `gathered_leaves_moments` (:726)
has no caller there. One launch sequence sorts the rows by id, cuts each
id's rows into tiles and sums them in f64 on the card (`moment_plan`,
`moment_tiles`); `leaf_moments_order` replays its summation order.
"""
from __future__ import annotations

import ctypes
import functools
import threading
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..log import LightGBMError
from . import _build
from .rng import Key, uniform

_launch_lock = threading.Lock()

# the widest group H, R and W take: the EFB bundle cap (efb.py
# pick_max_group_bins); a feature S scans is at most this wide too
MAX_GROUP_BINS = 2048


def widen_bins(binned: torch.Tensor) -> torch.Tensor:
    """Bins as a type torch computes on: uint16 (which has no arithmetic
    and, on the card, no indexing) as int32 through its int16 view;
    other types as they are."""
    if binned.dtype == torch.uint16:
        return binned.view(torch.int16).to(torch.int32) & 0xFFFF
    return binned


def take_bins(binned: torch.Tensor, sel=None) -> torch.Tensor:
    """The rows `sel` (all when None) of a binned matrix, or of one of
    its columns, as int64."""
    if sel is None:
        return widen_bins(binned).long()
    if binned.device.type == "cpu":
        return widen_bins(binned[sel]).long()
    return widen_bins(binned)[sel].long()


def _check(binned, w3, num_bins, rows, n_rows):
    if binned.dim() != 2 or w3.shape != (binned.shape[0], 3):
        raise LightGBMError("leaf_histogram takes binned [N, G] and w3 "
                            "[N, 3] (got %s and %s)"
                            % (tuple(binned.shape), tuple(w3.shape)))
    if w3.dtype != torch.float32:
        raise LightGBMError("leaf_histogram takes f32 channels")
    if rows is not None and (n_rows is None or n_rows > rows.shape[0]):
        raise LightGBMError("leaf_histogram: a row list needs n_rows <= "
                            "its length")
    tensors = [t for t in (binned, w3, rows) if t is not None]
    if any(t.device != binned.device for t in tensors):
        raise LightGBMError("leaf_histogram: inputs on different devices")
    if num_bins < 1:
        raise LightGBMError("leaf_histogram: num_bins must be >= 1")


_F32_MIN_NORMAL = float(np.finfo(np.float32).tiny)


def flush_subnormal(x: torch.Tensor) -> torch.Tensor:
    """An f32 subnormal as the zero of its sign, as XLA's CPU backend
    reads and writes them in arithmetic."""
    return torch.where(x.abs() < _F32_MIN_NORMAL, x * 0.0, x)


def bf16_round(x: torch.Tensor) -> torch.Tensor:
    """f32 -> bf16 -> f32 as XLA's CPU `convert` rounds: to nearest, ties
    to even, subnormals kept, overflow to inf, and a NaN to the quiet NaN
    of its sign (0x7fc0 or 0xffc0). In integer ops, so it gives the same
    bits on every device."""
    u = x.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    r = (u + 0x7FFF + ((u >> 16) & 1)) & 0xFFFF0000
    r = torch.where(torch.isnan(x), (u & 0x80000000) | 0x7FC00000, r)
    return torch.where(r >= 2 ** 31, r - 2 ** 32, r).to(torch.int32).view(
        torch.float32)


def hi_lo(w: torch.Tensor):
    """lightgbm_tpu/ops/histogram.py `_hi_lo` (:52) as XLA's CPU backend
    computes it: hi = bf16(w), lo = bf16(w - f32(hi)), the subtraction
    reading subnormal operands as zero and flushing a subnormal
    difference to the zero of its sign. Both as f32 values."""
    hi = bf16_round(w)
    lo = bf16_round(flush_subnormal(flush_subnormal(w)
                                    - flush_subnormal(hi)))
    return hi, lo


def leaf_histogram_plain(binned: torch.Tensor, w3: torch.Tensor,
                         num_bins: int, rows: Optional[torch.Tensor] = None,
                         n_rows: Optional[int] = None,
                         bf16: bool = False) -> torch.Tensor:
    """[G, B, 3] by index_add over the flattened (group, bin) axis,
    summed in f64 and rounded to f32 once: within f32 round-off of the
    kernel's f32 sums, whichever order either takes. Counts are exact.
    With `bf16` the hi and lo halves of g and h are summed apart, each
    rounded to f32, and added in f32."""
    g_cnt = binned.shape[1]
    if rows is not None:
        sel = rows[:n_rows].long()
        bins, w = take_bins(binned, sel), w3[sel]
    else:
        bins, w = take_bins(binned), w3
    cnt = (w[:, 2] > 0).to(torch.float32)
    if bf16:
        hi, lo = hi_lo(w[:, :2].contiguous())
        chans = torch.cat([hi, cnt[:, None], lo], dim=1)
    else:
        chans = torch.stack([w[:, 0], w[:, 1], cnt], dim=1)
    c = chans.shape[1]
    flat = (torch.arange(g_cnt, device=binned.device) * num_bins)[None, :] \
        + bins
    vals = chans[:, None, :].expand(-1, g_cnt, c).reshape(-1, c)
    h = torch.zeros(g_cnt * num_bins, c, dtype=torch.float64,
                    device=binned.device)
    h.index_add_(0, flat.reshape(-1), vals.double())
    h = h.float()
    if bf16:
        h = torch.cat([h[:, :2] + h[:, 3:], h[:, 2:3]], dim=1)
    return h.view(g_cnt, num_bins, 3)


# H (csrc/histogram.cu) sums every (group, bin) in f64 chains of the rows'
# values (g*w and h*w; in hi+lo mode hi + lo, which f64 holds exactly)
# and rounds each sum to f32 once: f32 sums of f32 values over millions
# of cancelling gradients miss 1e-5 * max(1, |sum|) in any order of f32
# chains. Every plan, and so every summation order, depends only on the
# shape.
# The lane-private kernel (hist_lane_kernel): a warp owns up to 32
# groups, one shared column a group (its bins and a sentinel bin), and
# adds a run of rows in order; a block holds up to HIST_MAX_WARPS such
# warps in HIST_SMEM_BYTES. A (group, bin) slot takes HIST_SLOT_BYTES (g
# and h in f64, a uint32 count); a warp's slots are rounded up to an even
# number so its f64 words stay aligned. A warp takes fewer groups (16)
# where two warps of 32 would not fit, and a group is lane-private while
# two warps of HIST_MIN_GROUPS such columns fit (at most 351 bins). The
# row blocks are sized so that all the group slices together make about
# HIST_TARGET_BLOCKS blocks (the H100's SMs) of whole warps, with runs of
# at least HIST_MIN_RUN rows (one turn of 32) and at most HIST_MAX_RUN
# (past that, more blocks rather than longer runs).
HIST_SMEM_BYTES = 220 * 1024
HIST_SLOT_BYTES = 20
HIST_MAX_WARPS = 8
HIST_MIN_GROUPS = 16
HIST_TARGET_BLOCKS = 132
HIST_MIN_RUN = 32
HIST_MAX_RUN = 8192
# The warp-shared kernel (hist_claim_kernel; uint16 groups too wide for
# the above): a block takes a slice of at most HIST_WIDE_WARPS groups, a
# warp each with one histogram of HIST_WIDE_BIN_BYTES a bin (g and h in
# f64, a uint32 count, a claim word), and stages HIST_STAGE_ROWS rows at
# a time (HIST_STAGE_ROW_BYTES a row: the two values in f64 and a count
# flag, and 2 bytes a group), all in HIST_WIDE_SMEM_BYTES (the card's 227
# KB). Tiles of whole chunks, at least HIST_MIN_TILE_ROWS, sized so that
# the slices together make about HIST_TARGET_BLOCKS blocks an SM's worth
# (`hist_wide_plan`).
HIST_WIDE_WARPS = 16
HIST_WIDE_BIN_BYTES = 24
HIST_STAGE_ROWS = 256
HIST_STAGE_ROW_BYTES = 20
HIST_WIDE_SMEM_BYTES = 227 * 1024
HIST_MIN_TILE_ROWS = 256
# an SM's shared memory (228 KB) and what each resident block reserves of
# it, which bound the warp-shared kernel's blocks an SM, and the most of
# them a plan counts on
HIST_SM_SMEM_BYTES = 228 * 1024
HIST_BLOCK_SMEM_RESERVE = 1024
HIST_WIDE_BLOCKS_PER_SM = 2
# Tiles of fewer than HIST_CLUSTER_TILE_ROWS rows, whose partials would
# outweigh the rows they read, go in clusters of up to HIST_MAX_CLUSTER
# blocks of a slice, which add their histograms in shared memory before
# anything is written; longer tiles keep a partial each.
HIST_MAX_CLUSTER = 8
HIST_CLUSTER_TILE_ROWS = 8192
# The reduction (hist_sum_kernel) of a path of more than one row block
# (cluster): each word adds them in HIST_CHAINS interleaved chains
# (chain s: blocks s, s + 8, ... from +0) closed in the fixed tree ((0+4)
# + (2+6)) + ((1+5) + (3+7)).
HIST_CHAINS = 8
# HQ (csrc/histogram.cu hist_i32_kernel), two blocks of 8 warps an SM: a
# block's shared int32 histogram of a slice of groups takes at most
# HIST_I32_WORDS words. A slice is a run of consecutive groups of one
# kind: groups of at most HQ_INTERLEAVE_BINS bins interleaved by lane (an
# item of 32 such groups, 3 x 32 words a bin, fits the budget), wider ones
# packed at their own widths. Row blocks: about HQ_TARGET_BLOCKS blocks
# over the slices, at least HQ_MIN_ROWS rows each, and so few that their
# partials (written once, read once) take at most twice the bytes the
# rows read; the reduction of the partials splits the row blocks into up to
# xs interleaved sums so that it runs about HQ_REDUCE_THREADS threads.
HIST_I32_WORDS = 100 * 1024 // 4
HQ_INTERLEAVE_BINS = HIST_I32_WORDS // (3 * 32)
HQ_TARGET_BLOCKS = 264
HQ_MIN_ROWS = 512
HQ_REDUCE_THREADS = 262144
# rows a pass of the bin count over the matrix
_MODE_ROWS = 65536


class HistPlan(NamedTuple):
    """The launch plan of H's lane-private kernel over n positions and
    `groups` groups in columns of `width` bins: `gw` groups a warp (a
    power of two up to 32), `warps` a block, runs of `run` positions a
    warp, `blocks` row blocks by `slices` group slices, the block's
    shared bytes `smem` and the partials' f64 words `partial_words` (0
    with one row block: its sums go to the output at once)."""
    gw: int
    warps: int
    run: int
    blocks: int
    slices: int
    smem: int
    partial_words: int


def hist_plan(n: int, groups: int, width: int) -> HistPlan:
    """H's lane-private plan (see the constants above), the same in
    both modes; its summation order is `leaf_histogram_order`'s."""
    if groups < 1 or not 1 <= width <= MAX_GROUP_BINS:
        raise LightGBMError("hist_plan: groups >= 1 and 1..%d bins"
                            % MAX_GROUP_BINS)
    gw = min(32, 1 << (int(groups) - 1).bit_length())
    while gw > 1 and 2 * _warp_bytes(gw, width) > HIST_SMEM_BYTES:
        gw //= 2
    warp_bytes = _warp_bytes(gw, width)
    warps = max(1, min(HIST_MAX_WARPS, HIST_SMEM_BYTES // warp_bytes))
    slices = -(-int(groups) // gw)
    target = max(1, HIST_TARGET_BLOCKS // slices)
    per = -(-max(int(n), 1) // (warps * target))
    run = min(HIST_MAX_RUN, max(HIST_MIN_RUN, -(-per // 32) * 32))
    blocks = max(1, -(-int(n) // (warps * run)))
    return HistPlan(gw, warps, run, blocks, slices, warps * warp_bytes,
                    blocks * 3 * width * slices * gw if blocks > 1 else 0)


def _warp_bytes(gw: int, width: int) -> int:
    """One warp's shared histogram: gw columns of width bins and a
    sentinel, the slots rounded up to an even number."""
    return (gw * (width + 1) + 1) // 2 * 2 * HIST_SLOT_BYTES


class WidePlan(NamedTuple):
    """The launch plan of H's warp-shared kernel over n positions and
    `groups` groups of at most `width` bins: `warps` groups a block (a
    warp each) in `slices` slices, tiles of `tile_rows` positions,
    `tiles` of them (a whole number of clusters, the last ones possibly
    empty) in clusters of `cluster`, the block's shared bytes `smem` and
    the partials' f64 words `partial_words` (0 with one cluster: it
    writes the output itself)."""
    warps: int
    slices: int
    tile_rows: int
    tiles: int
    cluster: int
    smem: int
    partial_words: int


def _wide_smem(warps: int, width: int) -> int:
    """hist_claim_kernel's shared bytes: `warps` histograms of `width`
    bins and a staged chunk (csrc/histogram.cu wide_smem)."""
    return (HIST_WIDE_BIN_BYTES * warps * width
            + HIST_STAGE_ROW_BYTES * HIST_STAGE_ROWS
            + 2 * warps * (HIST_STAGE_ROWS + 2))


@functools.lru_cache(maxsize=None)
def _wide_warps(groups: int, width: int, cap: int) -> tuple:
    """(warps a block, blocks an SM) of the warp-shared kernel: the warps,
    at most `cap`, spread evenly over the slices of `groups` groups, that
    keep the most warps on an SM, then the most blocks (a call's host time
    pays for this search once a shape)."""
    best = (0, 0, 1)  # warps an SM, blocks an SM, warps a block
    for w in range(1, cap + 1):
        if _wide_smem(w, width) > HIST_WIDE_SMEM_BYTES:
            break
        even = -(-groups // -(-groups // w))
        blocks = min(HIST_WIDE_BLOCKS_PER_SM, HIST_SM_SMEM_BYTES // (
            _wide_smem(even, width) + HIST_BLOCK_SMEM_RESERVE))
        best = max(best, (even * blocks, blocks, even))
    return best[2], best[1]


def hist_wide_plan(n: int, groups: int, width: int) -> WidePlan:
    """H's warp-shared plan (see the constants above). Groups a block
    (warps): at most as many as let the slices times the tiles n allows
    (of at least HIST_MIN_TILE_ROWS) reach HIST_TARGET_BLOCKS, so a short
    row sequence spreads its groups (whose histograms each block zeroes
    and writes) over many blocks; among those, the count, spread evenly
    over the slices, that keeps the most warps on an SM, then the most
    blocks (two blocks an SM overlap each other's barriers). Tiles of
    whole chunks for about HIST_TARGET_BLOCKS blocks an SM's worth; short
    ones (below HIST_CLUSTER_TILE_ROWS) a whole number of clusters of up
    to HIST_MAX_CLUSTER, the last cluster padded with empty tiles."""
    if groups < 1 or not 1 <= width <= MAX_GROUP_BINS:
        raise LightGBMError("hist_wide_plan: groups >= 1 and 1..%d bins"
                            % MAX_GROUP_BINS)
    groups = int(groups)
    cap = min(HIST_WIDE_WARPS, groups, max(1, -(-groups * max(
        1, -(-int(n) // HIST_MIN_TILE_ROWS)) // HIST_TARGET_BLOCKS)))
    warps, per_sm = _wide_warps(groups, int(width), cap)
    slices = -(-groups // warps)
    target = max(1, HIST_TARGET_BLOCKS * per_sm // slices)

    def rows_a_tile(tiles):
        per = -(-max(int(n), 1) // tiles)
        return max(HIST_MIN_TILE_ROWS,
                   -(-per // HIST_STAGE_ROWS) * HIST_STAGE_ROWS)
    tile_rows, cluster = rows_a_tile(target), 1
    if tile_rows < HIST_CLUSTER_TILE_ROWS and target >= HIST_MAX_CLUSTER:
        tile_rows = rows_a_tile(target - target % HIST_MAX_CLUSTER)
    tiles = max(1, -(-int(n) // tile_rows))
    if tile_rows < HIST_CLUSTER_TILE_ROWS:
        cluster = min(HIST_MAX_CLUSTER, 1 << (tiles - 1).bit_length())
    clusters = -(-tiles // cluster)
    return WidePlan(warps, slices, tile_rows, clusters * cluster, cluster,
                    _wide_smem(warps, width),
                    clusters * groups * 3 * width if clusters > 1 else 0)


class HistLayout(NamedTuple):
    """How H lays out a uint16 matrix's histogram in one mode: `widths`
    [G] (each group's own bins), the lane-private groups `narrow` (at most
    `narrow_w` bins) and the warp-shared `wide` (at most `wide_w`), all
    int32; `bf16` (the mode it is for); and `dev`, the three arrays on
    the device (each with a trailing 0, so none is empty)."""
    widths: np.ndarray
    narrow: np.ndarray
    wide: np.ndarray
    narrow_w: int
    wide_w: int
    bf16: bool
    dev: tuple


def hist_layout(group_bins, bf16: bool, device="cpu") -> HistLayout:
    """H's layout of a uint16 matrix whose groups have `group_bins`
    bins, made once for a grower: groups whose columns fit two warps of
    HIST_MIN_GROUPS in HIST_SMEM_BYTES stay lane-private, the others go
    warp-shared."""
    widths = np.asarray(group_bins, np.int32)
    if widths.ndim != 1 or widths.min(initial=1) < 1 \
            or widths.max(initial=1) > MAX_GROUP_BINS:
        raise LightGBMError("hist_layout: each group takes 1..%d bins"
                            % MAX_GROUP_BINS)
    lane = 2 * HIST_MIN_GROUPS * (widths.astype(np.int64) + 1) \
        * HIST_SLOT_BYTES <= HIST_SMEM_BYTES
    narrow = np.flatnonzero(lane).astype(np.int32)
    wide = np.flatnonzero(~lane).astype(np.int32)
    dev = tuple(torch.from_numpy(np.concatenate([a, [0]]).astype(np.int32))
                .to(device) for a in (widths, narrow, wide))
    return HistLayout(widths, narrow, wide,
                      int(widths[narrow].max(initial=1)),
                      int(widths[wide].max(initial=1)), bool(bf16), dev)


def check_layout(name: str, binned: torch.Tensor, num_bins: int,
                 layout: Optional[HistLayout],
                 bf16: Optional[bool] = None) -> None:
    """Raise unless `layout` is the hist_layout of the uint16 matrix
    `binned` (its groups at most `num_bins` wide, on its device; for H
    also of the mode `bf16`): the card's kernels lay a uint16 matrix's
    sums out by it."""
    g_cnt = binned.shape[1]
    if layout is None or layout.widths.shape != (g_cnt,) \
            or (bf16 is not None and layout.bf16 != bool(bf16)) \
            or int(layout.widths.max(initial=1)) > num_bins \
            or layout.dev[0].device != binned.device:
        raise LightGBMError(
            "%s: a uint16 matrix on the card takes the hist_layout of its "
            "%d groups (at most %d bins each)%s on %s"
            % (name, g_cnt, num_bins, "" if bf16 is None else
               " for bf16=%s" % bool(bf16), binned.device))


def _paths(binned, num_bins, n, layout):
    """H's passes over n positions of `binned`: (groups, each one's
    width, the pass's column width, blocks, warps, run) for the
    lane-private pass and, on a uint16 matrix, the warp-shared one; a
    pass of no groups is left out."""
    if binned.dtype != torch.uint16:
        g_all = binned.shape[1]
        plan = hist_plan(n, g_all, num_bins)
        return [(np.arange(g_all), np.full(g_all, num_bins), num_bins,
                 plan.blocks, plan.warps, plan.run)]
    out = []
    if len(layout.narrow):
        plan = hist_plan(n, len(layout.narrow), layout.narrow_w)
        out.append((layout.narrow, layout.widths[layout.narrow],
                    layout.narrow_w, plan.blocks, plan.warps, plan.run))
    if len(layout.wide):
        wp = hist_wide_plan(n, len(layout.wide), layout.wide_w)
        out.append((layout.wide, layout.widths[layout.wide], layout.wide_w,
                    wp.tiles // wp.cluster, wp.cluster, wp.tile_rows))
    return out


def leaf_histogram_order(binned: torch.Tensor, w3: torch.Tensor,
                         num_bins: int, rows: Optional[torch.Tensor] = None,
                         n_rows: Optional[int] = None, bf16: bool = False,
                         layout: Optional[HistLayout] = None
                         ) -> torch.Tensor:
    """H in its own summation order, replayed in torch ops on the
    inputs' device, bit for bit the kernel's, on every group. Each pass
    cuts the positions into blocks of warps of runs: the lane-private
    pass by `hist_plan` (warp w of block x takes positions (x * warps +
    w) * run .. + run - 1), the warp-shared pass of a uint16 matrix (with
    its `layout`) by `hist_wide_plan` (a "block" a cluster of tiles, a
    "warp" a tile's warp of one group, which takes the whole tile). A
    warp adds its positions' values (g*w and h*w; in hi+lo mode hi + lo)
    in order into each (group, bin) from +0 in f64, a block adds its
    warps in order from +0, and each output adds the
    blocks in eight f64 chains (chain s: blocks s, s + 8, ... from +0) and
    the tree ((0+4)+(2+6)) + ((1+5)+(3+7)), rounded to f32 once. Counts
    exact; a bin at or past its group's width is 0. [G, B, 3]."""
    dev = binned.device
    out = torch.zeros((binned.shape[1], num_bins, 3), dtype=torch.float32,
                      device=dev)
    if binned.dtype == torch.uint16 and layout is None:
        raise LightGBMError("leaf_histogram_order: a uint16 matrix takes "
                            "its hist_layout")
    n = binned.shape[0] if rows is None else int(n_rows)
    sel = torch.arange(n, device=dev) if rows is None else rows[:n].long()
    w = w3[sel]
    if bf16:
        hi, lo = hi_lo(w[:, :2].contiguous())
        vals = hi.double() + lo.double()
    else:
        vals = w[:, :2].double()
    wide_bins = widen_bins(binned).to(torch.int32)
    for groups, widths, width, blocks, warps, run in _paths(
            binned, num_bins, n, layout):
        groups = torch.from_numpy(np.asarray(groups, np.int64)).to(dev)
        widths = torch.from_numpy(np.asarray(widths, np.int64)).to(dev)
        bins = wide_bins.index_select(1, groups).index_select(0, sel)
        bins = torch.where(bins < widths[None, :], bins, width)
        v = _ordered_sums(bins, vals, blocks, warps, run, width)
        gl = groups.shape[0]
        live = (bins < width) & (w[:, 2:3] > 0)
        flat = torch.arange(gl, device=dev)[None, :] * (width + 1) \
            + bins.long()
        cnt = torch.zeros(gl * (width + 1), dtype=torch.int64, device=dev)
        cnt.index_add_(0, flat[live], torch.ones_like(flat[live]))
        cnt = cnt.view(gl, width + 1)[:, :width].to(torch.float32)
        out[groups, :width] = torch.cat([v, cnt[..., None]], -1)
    return out


def _ordered_sums(bins, vals, blocks, warps, run, width):
    """[groups, width, 2] f32: the sums of `vals` [n, 2] f64 into `bins`
    [n, groups] (width: the sentinel) in H's order for the positions cut
    into blocks x warps x runs."""
    n, gl = bins.shape
    cf = vals.shape[1]
    total = blocks * warps * run
    bins = torch.nn.functional.pad(bins, (0, 0, 0, total - n), value=width)
    vals = torch.nn.functional.pad(vals, (0, 0, 0, total - n))
    bins = bins.view(blocks, warps, run, gl)
    vals = vals.view(blocks, warps, run, cf)
    acc = torch.zeros((blocks, warps, gl, width + 1, cf),
                      dtype=torch.float64, device=bins.device)
    shape = (blocks, warps, gl, 1, cf)
    for k in range(run):
        acc.scatter_add_(3, bins[:, :, k, :, None, None].long().expand(shape),
                         vals[:, :, k, None, None, :].expand(shape))
    part = torch.zeros_like(acc[:, 0, :, :width])
    for wi in range(warps):
        part = part + acc[:, wi, :, :width]
    del acc
    chains = -(-blocks // HIST_CHAINS)
    part = torch.nn.functional.pad(
        part, (0, 0, 0, 0, 0, 0, 0, chains * HIST_CHAINS - blocks))
    part = part.view(chains, HIST_CHAINS, gl, width, cf)
    a = torch.zeros_like(part[0])
    for j in range(chains):
        a = a + part[j]
    return ((a[0] + a[4] + (a[2] + a[6])) + (a[1] + a[5] + (a[3] + a[7]))
            ).float()


def leaf_histogram(binned: torch.Tensor, w3: torch.Tensor, num_bins: int,
                   rows: Optional[torch.Tensor] = None,
                   n_rows: Optional[int] = None,
                   out: Optional[torch.Tensor] = None,
                   bf16: bool = False,
                   layout: Optional[HistLayout] = None) -> torch.Tensor:
    """H: the [G, B, 3] f32 histogram of the rows 0..N-1, or of
    rows[:n_rows]; written into `out` (contiguous, that shape) when
    given; g and h summed in hi+lo halves when `bf16`. On the card a
    uint16 matrix (groups past 256 bins) takes its `hist_layout` for
    this mode, each group at its own width; a bin past it is 0."""
    _check(binned, w3, num_bins, rows, n_rows)
    shape = (binned.shape[1], num_bins, 3)
    if out is not None and (tuple(out.shape) != shape
                            or out.dtype != torch.float32
                            or not out.is_contiguous()
                            or out.device != binned.device):
        raise LightGBMError("leaf_histogram: out must be a contiguous f32 "
                            "%s tensor on %s" % (shape, binned.device))
    if binned.device.type == "cpu":
        hist = leaf_histogram_plain(binned, w3, num_bins, rows, n_rows,
                                    bf16)
        return hist if out is None else out.copy_(hist)
    if binned.device.type != "cuda":
        raise LightGBMError("leaf_histogram runs on cpu or cuda, not %s"
                            % binned.device)
    u16 = binned.dtype == torch.uint16
    if not ((binned.dtype == torch.uint8 and num_bins <= 256)
            or (u16 and num_bins <= MAX_GROUP_BINS)):
        raise LightGBMError("the leaf_histogram kernel takes uint8 bins (at "
                            "most 256 a group) or uint16 bins (at most %d)"
                            % MAX_GROUP_BINS)
    for t in (binned, w3, rows):
        if t is not None and not t.is_contiguous():
            raise LightGBMError("leaf_histogram takes contiguous tensors")
    if rows is not None and rows.dtype != torch.int32:
        raise LightGBMError("leaf_histogram takes int32 rows")
    n = binned.shape[0] if rows is None else int(n_rows)
    g_cnt = binned.shape[1]
    if u16:
        check_layout("leaf_histogram", binned, num_bins, layout, bf16)
        widths, lane, wide = layout.dev
        n_lane, lane_w = len(layout.narrow), layout.narrow_w
        n_wide, wide_w = len(layout.wide), layout.wide_w
    else:
        widths = lane = wide = None
        n_lane, lane_w, n_wide, wide_w = g_cnt, num_bins, 0, 0
    plan = hist_plan(n, n_lane, lane_w) if n_lane else None
    wplan = hist_wide_plan(n, n_wide, wide_w) if n_wide else None
    # the lane partials' f64 words, then the warp-shared ones
    words = (plan.partial_words if plan else 0) \
        + (wplan.partial_words if wplan else 0)
    scratch = torch.empty(max(words, 1), dtype=torch.float64,
                          device=binned.device)
    if out is None:
        out = torch.empty(shape, dtype=torch.float32, device=binned.device)

    def ptr(t):
        return None if t is None else t.data_ptr()

    lib = _build.load_library("histogram")
    with torch.cuda.device(binned.device):
        stream = torch.cuda.current_stream(binned.device).cuda_stream
        rc = lib.lgbt_leaf_histogram(
            ptr(binned), g_cnt, int(u16), ptr(w3), ptr(rows), n, num_bins,
            int(bool(bf16)), ptr(lane), n_lane, ptr(widths), lane_w,
            *((plan.gw, plan.warps, plan.run, plan.blocks) if plan
              else (0, 0, 0, 0)),
            ptr(wide), n_wide, wide_w,
            *((wplan.warps, wplan.slices, wplan.tile_rows, wplan.tiles,
               wplan.cluster) if wplan else (0, 0, 0, 0, 0)),
            ptr(scratch), ptr(out), stream)
    if rc != 0:
        raise LightGBMError("leaf_histogram launch failed: CUDA error %d "
                            "(%s)" % (rc, lib.lgbt_error_string(rc).decode()))
    with _launch_lock:
        leaf_histogram.launches += 1
        if bf16:
            leaf_histogram.launches_hilo += 1
        if u16:
            leaf_histogram.launches_u16 += 1
    return out


# all launches of H, those in hi+lo mode and those on uint16 bins among
# them
leaf_histogram.launches = 0
leaf_histogram.launches_hilo = 0
leaf_histogram.launches_u16 = 0


def subtract(parent: torch.Tensor, child: torch.Tensor,
             out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Larger-child histogram = parent - smaller child, into `out` when
    given (lightgbm_tpu/ops/histogram.py:785; reference
    FeatureHistogram::Subtract, feature_histogram.hpp:64-70)."""
    return torch.sub(parent, child, out=out)


# ---------------------------------------------------------------------------
# quantized-gradient training (tpu_hist_quantize)
# ---------------------------------------------------------------------------

TRAIN_QUANTIZE_MODES = ("none", "int16", "int8")

_TRAIN_QMAX = {"int8": 127, "int16": 32767}

# scale floor of an all-zero gradient vector (lightgbm_tpu/ops/
# histogram.py _SCALE_FLOOR)
_SCALE_FLOOR = 1e-30


def train_qmax(mode: str, n: int) -> int:
    """The clip magnitude of quantized training at n rows
    (lightgbm_tpu/ops/histogram.py:75-92): a bin holding every row at
    full magnitude must stay below 2^31 in int32, qmax * n < 2^31, with
    the JAX package's 256 of headroom for its int16 digit carry."""
    cap = (2 ** 31 - 1) // max(1, int(n)) - 256
    return max(1, min(_TRAIN_QMAX[mode], cap))


class QuantGradients(NamedTuple):
    """Q's outputs: codes [N, 2] int16 (q_g, q_h), w01 [N] f32 (the 0/1
    in-bag weight) and qscale [3] f32 (g_scale, h_scale, 1.0)."""
    codes: torch.Tensor
    w01: torch.Tensor
    qscale: torch.Tensor


def stochastic_round(x: torch.Tensor, key: Key) -> torch.Tensor:
    """floor(x) + (u < x - floor(x)) with u = uniform(key, (n,)), f32
    (lightgbm_tpu/ops/histogram.py:105; the port has no padding rows)."""
    u = uniform(key, x.shape[0], x.device)
    f = torch.floor(x)
    return f + (u < (x - f)).to(torch.float32)


def quantize_gradients_plain(grad: torch.Tensor, hess: torch.Tensor,
                             row_weight: torch.Tensor, qmax: int,
                             key_g: Key, key_h: Key,
                             hess_const: bool = False, *,
                             reciprocal_scale: bool) -> QuantGradients:
    """lightgbm_tpu/ops/histogram.py:127-156 in the same f32 operations.
    The constants are 0-dim tensors on the inputs' device: PyTorch
    divides a CUDA tensor by a host scalar as a multiply by its
    reciprocal, which is not the quotient JAX computes. With
    `reciprocal_scale` each scale is max * f32(1 / qmax), as XLA computes
    it where qmax is a constant of a compiled program (see
    `quantize_gradients`)."""
    dev = grad.device
    qm = torch.tensor(float(qmax), dtype=torch.float32, device=dev)
    floor = torch.tensor(_SCALE_FLOOR, dtype=torch.float32, device=dev)
    w01 = (row_weight > 0).to(torch.float32)
    gw = grad * row_weight
    hw = hess * row_weight
    if reciprocal_scale:
        inv = torch.tensor(1.0, dtype=torch.float32, device=dev) / qm
        g_scale = torch.maximum(gw.abs().max(), floor) * inv
        h_scale = torch.maximum(hw.abs().max(), floor) * inv
    else:
        g_scale = torch.maximum(gw.abs().max(), floor) / qm
        h_scale = torch.maximum(hw.abs().max(), floor) / qm
    q_g = torch.clamp(stochastic_round(gw / g_scale, key_g), -qm, qm)
    if hess_const:
        q_h = qm * w01
    else:
        q_h = torch.clamp(stochastic_round(hw / h_scale, key_h), -qm, qm)
    codes = torch.stack([q_g, q_h], 1).to(torch.int16)
    qscale = torch.stack([g_scale, h_scale, torch.ones_like(g_scale)])
    return QuantGradients(codes, w01, qscale)


def quantize_gradients(grad: torch.Tensor, hess: torch.Tensor,
                       row_weight: torch.Tensor, *, qmax: int, key_g: Key,
                       key_h: Key, hess_const: bool = False,
                       reciprocal_scale: bool) -> QuantGradients:
    """Q: one iteration's gradients and hessians [N] f32 with the row
    weight [N] f32 folded in (gw = grad * w) as integer codes, the 0/1
    in-bag weight and the dequantization scale, all on the inputs'
    device (no host read). With `hess_const` q_h = qmax * w01 exactly and
    takes no draw.

    The scales, which the caller must choose: max|gw| / qmax as the JAX
    function computes it when it runs op by op (its quantize gate,
    gbdt.py:1025); with `reciprocal_scale`, max|gw| * f32(1 / qmax) as
    its training program
    computes it (`_quantize_iter_device`, gbdt.py:363, jitted with qmax
    static: XLA's algebraic simplifier turns a division by a constant
    into a multiply by its reciprocal). The two differ in the last bit
    for some maxima (1 in 23 at qmax 127), and every dequantized sum,
    gain and leaf carries the scale's bits."""
    n = grad.shape[0]
    for t in (grad, hess, row_weight):
        if t.shape != (n,) or t.dtype != torch.float32:
            raise LightGBMError("quantize_gradients takes f32 [N] grad, "
                                "hess and row weight")
        if t.device != grad.device:
            raise LightGBMError("quantize_gradients: inputs on different "
                                "devices")
    if not 1 <= qmax <= 32767:
        raise LightGBMError("quantize_gradients: qmax must be in "
                            "[1, 32767] (got %d)" % qmax)
    if grad.device.type == "cpu":
        return quantize_gradients_plain(grad, hess, row_weight, qmax,
                                        key_g, key_h, hess_const,
                                        reciprocal_scale=reciprocal_scale)
    if grad.device.type != "cuda":
        raise LightGBMError("quantize_gradients runs on cpu or cuda, not %s"
                            % grad.device)
    if not all(t.is_contiguous() for t in (grad, hess, row_weight)):
        raise LightGBMError("quantize_gradients takes contiguous tensors")
    dev = grad.device
    codes = torch.empty((n, 2), dtype=torch.int16, device=dev)
    w01 = torch.empty(n, dtype=torch.float32, device=dev)
    qscale = torch.empty(3, dtype=torch.float32, device=dev)
    lib = _build.load_library("quantize")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        plan = quantize_plan(n, _q_resident(lib, dev))
        rc = lib.lgbt_quantize_gradients(
            _ptr(grad), _ptr(hess), _ptr(row_weight), n, qmax, key_g[0],
            key_g[1], key_h[0], key_h[1], int(bool(hess_const)),
            int(bool(reciprocal_scale)), plan["blocks"],
            _ptr(_q_scratch(lib, dev, stream)), _ptr(codes), _ptr(w01),
            _ptr(qscale), ctypes.c_void_p(stream))
    if rc != 0:
        raise LightGBMError("quantize_gradients launch failed: CUDA error "
                            "%d (%s)" % (rc, lib.lgbt_error_string(rc)
                                         .decode()))
    with _launch_lock:
        quantize_gradients.launches += 1
    return QuantGradients(codes, w01, qscale)


#: Q's launch (csrc/quantize.cu): blocks of Q_THREADS, a thread taking
#: groups of Q_GROUP consecutive rows, its first group's products and
#: draws kept in registers across the grid barrier
Q_THREADS, Q_GROUP = 1024, 4


def quantize_plan(n: int, resident: int) -> dict:
    """Q's grid at n rows when `resident` blocks fit on the card at once
    (a cooperative launch takes no more): a block per Q_THREADS groups of
    Q_GROUP rows up to that, at least one. Group g (rows Q_GROUP g ..
    Q_GROUP g + Q_GROUP - 1) belongs to thread g % (blocks x Q_THREADS);
    each thread's first group (`kept` rows in all) stays in registers
    across the barrier, the rest (`reread`) are read again after it."""
    if resident < 1:
        raise LightGBMError("quantize_gradients: the card cannot launch Q "
                            "cooperatively")
    groups = -(-n // Q_GROUP)
    blocks = max(1, min(resident, -(-groups // Q_THREADS)))
    kept = min(n, blocks * Q_THREADS * Q_GROUP)
    return {"blocks": blocks, "kept": kept, "reread": n - kept}


_q_residents: dict = {}
_q_scratches: dict = {}


def _q_resident(lib, dev: torch.device) -> int:
    with _launch_lock:
        got = _q_residents.get(dev.index)
    if got is None:
        got = int(lib.lgbt_quantize_resident_blocks())
        with _launch_lock:
            _q_residents[dev.index] = got
    return got


def _q_scratch(lib, dev: torch.device, stream: int) -> torch.Tensor:
    """Q's scratch for one device and stream: its barrier word and two
    pairs of maxima, zeroed once here; each launch leaves them fit for
    the next (csrc/quantize.cu), so no call zeroes them again."""
    key = (dev.index, stream)
    with _launch_lock:
        t = _q_scratches.get(key)
        if t is None:
            t = torch.zeros(lib.lgbt_quantize_scratch_ints(),
                            dtype=torch.int32, device=dev)
            _q_scratches[key] = t
    return t


quantize_gradients.launches = 0


def _check_i32(binned, codes, w01, num_bins, rows, n_rows):
    n = binned.shape[0]
    if binned.dim() != 2 or codes.shape != (n, 2) or w01.shape != (n,):
        raise LightGBMError("leaf_histogram_i32 takes binned [N, G], codes "
                            "[N, 2] and w01 [N] (got %s, %s and %s)"
                            % (tuple(binned.shape), tuple(codes.shape),
                               tuple(w01.shape)))
    if codes.dtype != torch.int16 or w01.dtype != torch.float32:
        raise LightGBMError("leaf_histogram_i32 takes int16 codes and f32 "
                            "w01")
    if rows is not None and (n_rows is None or n_rows > rows.shape[0]):
        raise LightGBMError("leaf_histogram_i32: a row list needs n_rows "
                            "<= its length")
    tensors = [t for t in (binned, codes, w01, rows) if t is not None]
    if any(t.device != binned.device for t in tensors):
        raise LightGBMError("leaf_histogram_i32: inputs on different "
                            "devices")
    if num_bins < 1:
        raise LightGBMError("leaf_histogram_i32: num_bins must be >= 1")


class I32Plan(NamedTuple):
    """HQ's plan over a matrix's G groups, made once for a Dataset
    (`i32_plan`): `widths` [G] (each group's bins), `skip` [G] (the bin of
    each group that the kernel does not add rows into: by default the one
    most of the matrix's rows hold), `slices` [S, 4] (first group, groups,
    interleave width or 0 where packed, shared words), `sbase` [S] (each
    slice's first word in a row block's partial of `part_words`), `woff`
    [G] (a packed group's first word in its slice, else 0), all int32;
    `slice_words` (the largest slice's words) and `dev`, the arrays
    slices, sbase, widths, woff and skip on the matrix's device."""
    widths: np.ndarray
    skip: np.ndarray
    slices: np.ndarray
    sbase: np.ndarray
    woff: np.ndarray
    part_words: int
    slice_words: int
    dev: tuple


def i32_slices(widths) -> tuple:
    """HQ's slices of groups of `widths` bins: runs of consecutive groups
    of one kind, in order, each within HIST_I32_WORDS words. Interleaved
    (widths up to HQ_INTERLEAVE_BINS): an item of 32 lanes, one column a
    (slot, row phase), takes 3 * 32 * wn words, wn the slice's widest
    group. Packed: each group 3 * width words from its `woff`, the slice
    rounded up to 4 words. Returns (slices [S, 4], woff [G])."""
    widths = np.asarray(widths, np.int64)
    woff = np.zeros(len(widths), np.int32)
    out = []
    g0 = gc = wn = pw = 0
    il = True

    def words(il, wn, gc, pw):
        return 96 * wn * -(-gc // 32) if il else (pw + 3) // 4 * 4

    for g, w in enumerate(widths):
        w = int(w)
        kind = w <= HQ_INTERLEAVE_BINS
        if gc and kind == il and words(
                il, max(wn, w), gc + 1, pw + 3 * w) <= HIST_I32_WORDS:
            gc += 1
        else:
            if gc:
                out.append((g0, gc, wn if il else 0, words(il, wn, gc, pw)))
            g0, gc, wn, pw, il = g, 1, 0, 0, kind
        wn = max(wn, w)
        if not kind:
            woff[g] = pw
            pw += 3 * w
    if gc:
        out.append((g0, gc, wn if il else 0, words(il, wn, gc, pw)))
    return np.asarray(out, np.int32).reshape(-1, 4), woff


def group_counts(binned: torch.Tensor, widths) -> np.ndarray:
    """How many rows of `binned` [N, G] hold each bin of each group,
    counted on the matrix's device in passes of _MODE_ROWS rows; bins at
    or past a group's width are not counted. int64 [G, max width]."""
    g_cnt = binned.shape[1]
    widths = torch.as_tensor(np.asarray(widths, np.int64),
                             device=binned.device)
    wmax = int(widths.max()) if g_cnt else 1
    counts = torch.zeros(g_cnt * wmax + 1, dtype=torch.int64,
                         device=binned.device)
    base = torch.arange(g_cnt, device=binned.device) * wmax
    for r0 in range(0, binned.shape[0], _MODE_ROWS):
        bins = widen_bins(binned[r0:r0 + _MODE_ROWS]).long()
        flat = torch.where(bins < widths[None, :], base[None, :] + bins,
                           g_cnt * wmax)
        counts += torch.bincount(flat.reshape(-1), minlength=len(counts))
    return counts[:-1].view(g_cnt, wmax).cpu().numpy()


def i32_plan(binned: torch.Tensor, num_bins: int,
             group_bins=None, skip=None) -> I32Plan:
    """HQ's plan for the binned matrix [N, G] (uint8, or uint16 with each
    group's own bin count `group_bins`; a uint8 matrix's groups are all
    `num_bins` wide): its slices, and the skipped bin of each group,
    `skip` when given, else the one most of the matrix's rows hold (the
    lowest of equal counts)."""
    g_cnt = binned.shape[1]
    widths = np.full(g_cnt, int(num_bins), np.int32) if group_bins is None \
        else np.asarray(group_bins, np.int32)
    if widths.shape != (g_cnt,) or widths.min(initial=1) < 1 \
            or widths.max(initial=1) > min(int(num_bins), MAX_GROUP_BINS):
        raise LightGBMError("i32_plan: each of the %d groups takes 1..%d "
                            "bins" % (g_cnt, min(int(num_bins),
                                                 MAX_GROUP_BINS)))
    counts = group_counts(binned, widths)
    skip = counts.argmax(1).astype(np.int32) if skip is None \
        else np.asarray(skip, np.int32)
    if skip.shape != (g_cnt,) or np.any(skip < 0) or np.any(skip >= widths):
        raise LightGBMError("i32_plan: a skipped bin lies in its group")
    slices, woff = i32_slices(widths)
    sbase = np.concatenate([[0], np.cumsum(slices[:, 3])[:-1]]).astype(
        np.int32)
    dev = tuple(torch.from_numpy(np.ascontiguousarray(
        np.concatenate([a.reshape(-1), [0]]).astype(np.int32))).to(
            binned.device) for a in (slices, sbase, widths, woff, skip))
    return I32Plan(widths, skip, slices, sbase, woff,
                   int(slices[:, 3].sum()), int(slices[:, 3].max(initial=4)),
                   dev)


def i32_grid(plan: I32Plan, n: int, row_bytes: int) -> tuple:
    """HQ's row blocks over n positions that read `row_bytes` a row
    (bins, codes, w01 and a row list's id): (blocks, chunk, xs), `chunk`
    positions a block (a multiple of 32) and the reduction's split."""
    n = max(int(n), 1)
    blocks = max(1, min(-(-HQ_TARGET_BLOCKS // len(plan.slices)),
                        -(-n // HQ_MIN_ROWS),
                        n * int(row_bytes) // (4 * plan.part_words)))
    chunk = -(-(-(-n // blocks)) // 32) * 32
    blocks = -(-n // chunk)
    xs = max(1, min(blocks, -(-HQ_REDUCE_THREADS // plan.part_words)))
    return blocks, chunk, xs


def check_i32_plan(binned: torch.Tensor, num_bins: int,
                   plan: Optional[I32Plan]) -> None:
    """Raise unless `plan` is an i32_plan of the matrix `binned` (its
    groups, at most `num_bins` wide, uint8 ones all that wide, on its
    device): the card's HQ reads the groups by it."""
    g_cnt = binned.shape[1]
    if plan is None or plan.widths.shape != (g_cnt,) \
            or int(plan.widths.max(initial=1)) > num_bins \
            or (binned.dtype == torch.uint8
                and np.any(plan.widths != num_bins)) \
            or plan.dev[0].device != binned.device:
        raise LightGBMError(
            "leaf_histogram_i32: the card's kernel takes the i32_plan of "
            "its matrix's %d groups (at most %d bins each) on %s"
            % (g_cnt, num_bins, binned.device))


def leaf_histogram_i32_plain(binned: torch.Tensor, codes: torch.Tensor,
                             w01: torch.Tensor, num_bins: int,
                             rows: Optional[torch.Tensor] = None,
                             n_rows: Optional[int] = None) -> torch.Tensor:
    """[G, B, 3] int32 by an int64 index_add over the flattened (group,
    bin) axis."""
    g_cnt = binned.shape[1]
    if rows is not None:
        sel = rows[:n_rows].long()
        bins, q, w = take_bins(binned, sel), codes[sel], w01[sel]
    else:
        bins, q, w = take_bins(binned), codes, w01
    c = (w > 0).to(torch.int64)
    chans = torch.stack([q[:, 0].long() * c, q[:, 1].long() * c, c], 1)
    flat = (torch.arange(g_cnt, device=binned.device) * num_bins)[None, :] \
        + bins
    vals = chans[:, None, :].expand(-1, g_cnt, 3).reshape(-1, 3)
    h = torch.zeros(g_cnt * num_bins, 3, dtype=torch.int64,
                    device=binned.device)
    h.index_add_(0, flat.reshape(-1), vals)
    return h.to(torch.int32).view(g_cnt, num_bins, 3)


def leaf_histogram_i32(binned: torch.Tensor, codes: torch.Tensor,
                       w01: torch.Tensor, num_bins: int,
                       rows: Optional[torch.Tensor] = None,
                       n_rows: Optional[int] = None,
                       out: Optional[torch.Tensor] = None,
                       plan: Optional[I32Plan] = None) -> torch.Tensor:
    """HQ: the [G, B, 3] int32 histogram (sum q_g*w01, sum q_h*w01, sum
    w01) of the rows 0..N-1, or of rows[:n_rows]; written into `out`
    (contiguous, that shape) when given. The caller keeps qmax * N below
    2^31 (`train_qmax`), so no sum overflows. On the card the matrix
    takes its `i32_plan` (a uint16 one with each group's own width; a
    bin past it is 0), and its rows hold each group's bin below that
    width, as a Dataset's do: the kernel fills each group's skipped bin
    from the rows' totals."""
    _check_i32(binned, codes, w01, num_bins, rows, n_rows)
    shape = (binned.shape[1], num_bins, 3)
    if out is not None and (tuple(out.shape) != shape
                            or out.dtype != torch.int32
                            or not out.is_contiguous()
                            or out.device != binned.device):
        raise LightGBMError("leaf_histogram_i32: out must be a contiguous "
                            "int32 %s tensor on %s" % (shape, binned.device))
    if binned.device.type == "cpu":
        hist = leaf_histogram_i32_plain(binned, codes, w01, num_bins, rows,
                                        n_rows)
        return hist if out is None else out.copy_(hist)
    if binned.device.type != "cuda":
        raise LightGBMError("leaf_histogram_i32 runs on cpu or cuda, not %s"
                            % binned.device)
    u16 = binned.dtype == torch.uint16
    if not ((binned.dtype == torch.uint8 and num_bins <= 256)
            or (u16 and num_bins <= MAX_GROUP_BINS)):
        raise LightGBMError("the leaf_histogram_i32 kernel takes uint8 bins "
                            "(at most 256 a group) or uint16 bins (at most "
                            "%d)" % MAX_GROUP_BINS)
    g_cnt = binned.shape[1]
    check_i32_plan(binned, num_bins, plan)
    for t in (binned, codes, w01, rows):
        if t is not None and not t.is_contiguous():
            raise LightGBMError("leaf_histogram_i32 takes contiguous "
                                "tensors")
    if rows is not None and rows.dtype != torch.int32:
        raise LightGBMError("leaf_histogram_i32 takes int32 rows")
    n = binned.shape[0] if rows is None else int(n_rows)
    lib = _build.load_library("histogram")
    if out is None:
        out = torch.empty(shape, dtype=torch.int32, device=binned.device)
    blocks, chunk, xs = i32_grid(
        plan, n, g_cnt * binned.element_size() + 8
        + (4 if rows is not None else 0))
    part = torch.empty(blocks * plan.part_words, dtype=torch.int32,
                       device=binned.device)

    def ptr(t):
        return ctypes.c_void_p(None if t is None else t.data_ptr())

    with torch.cuda.device(binned.device):
        stream = torch.cuda.current_stream(binned.device).cuda_stream
        slices, sbase, widths, woff, skip = plan.dev
        rc = lib.lgbt_leaf_histogram_i32(
            ptr(binned), g_cnt, int(u16), ptr(codes), ptr(w01), ptr(rows),
            n, num_bins, ptr(slices), len(plan.slices), plan.slice_words,
            ptr(sbase), plan.part_words, ptr(widths), ptr(woff), ptr(skip),
            blocks, chunk, xs, ptr(part), ptr(out),
            ctypes.c_void_p(stream))
    if rc != 0:
        raise LightGBMError("leaf_histogram_i32 launch failed: CUDA error "
                            "%d (%s)" % (rc, lib.lgbt_error_string(rc)
                                         .decode()))
    with _launch_lock:
        leaf_histogram_i32.launches += 1
        if u16:
            leaf_histogram_i32.launches_u16 += 1
    return out


# all launches of HQ, and those on uint16 bins among them
leaf_histogram_i32.launches = 0
leaf_histogram_i32.launches_u16 = 0


# ---------------------------------------------------------------------------
# per-bin raw-feature moments (linear trees; lightgbm_tpu/linear/stats.py)
# ---------------------------------------------------------------------------

def leaf_moments_plain(binned: torch.Tensor, x: torch.Tensor,
                       w3: torch.Tensor, num_bins: int,
                       leaf_id: torch.Tensor,
                       ids: torch.Tensor) -> torch.Tensor:
    """[C, F, B, 4] by an f64 index_add over the flattened (id, feature,
    bin) axis of the f32 terms (x*m, (x*x)*m, x*(g*m), x*(h*m)), rounded
    to f32 once."""
    f_cnt = binned.shape[1]
    c_cnt = ids.shape[0]
    match = leaf_id.long()[:, None] == ids.long()[None, :]
    hit = match.any(dim=1)
    sel = torch.nonzero(hit)[:, 0]
    slot = match[hit].int().argmax(dim=1)
    xv = x[sel]
    xv = torch.where(torch.isfinite(xv), xv, torch.zeros_like(xv))
    w = w3[sel]
    gm, hm, m = w[:, 0:1], w[:, 1:2], w[:, 2:3]
    terms = torch.stack([xv * m, (xv * xv) * m, xv * gm, xv * hm], dim=-1)
    flat = (slot[:, None] * f_cnt
            + torch.arange(f_cnt, device=binned.device)[None, :]) \
        * num_bins + take_bins(binned, sel)
    keep = take_bins(binned, sel) < num_bins
    out = torch.zeros((c_cnt * f_cnt * num_bins, 4), dtype=torch.float64,
                      device=binned.device)
    out.index_add_(0, flat[keep], terms[keep].to(torch.float64))
    return out.float().view(c_cnt, f_cnt, num_bins, 4)


# LM's launch plan (csrc/moments.cu). The sort: tiles of
# MOMENT_SORT_ROWS rows (a warp each), fewer and longer where C x T would
# pass MOMENT_MAX_SORT_CELLS counters; scan blocks of MOMENT_SCAN_CHUNK
# counters. uint8 bins (moment_lane_kernel): a warp owns gw features (a
# power of two up to 32, so that a column's f64 words sit in bank pairs
# of their own), each a column of its B bins and a sentinel in four f64
# channels (MOMENT_SLOT_BYTES a slot); a warp takes fewer where two
# warps of gw would not fit MOMENT_SMEM_BYTES, a block holds up to
# MOMENT_MAX_WARPS such warps, and each warp adds a run of `run` rows of
# a tile of warps x run. uint16 bins (moment_wide_kernel): a warp a
# feature, its [4][B] f64 histogram and [B] int32 claims, beside
# MOMENT_STAGE_ROWS staged rows (a 2-byte bin and a value a feature,
# padded, and three channels); MOMENT_WIDE_WARPS warps a block, so that
# two blocks share an SM and one adds while the other waits on its
# staged rows, in tiles of `wide_tile` rows. The plan, and so the
# summation order, depends only on the shape.
MOMENT_SMEM_BYTES = 220 * 1024
MOMENT_SLOT_BYTES = 32
MOMENT_MAX_WARPS = 8
MOMENT_RUN = 1024
MOMENT_WIDE_WARPS = 2
MOMENT_WIDE_TILE = 16384
MOMENT_STAGE_ROWS = 256
MOMENT_SORT_ROWS = 2048
MOMENT_MAX_SORT_CELLS = 1 << 21
MOMENT_SCAN_CHUNK = 4096


class MomentPlan(NamedTuple):
    """LM's launch plan: `wide` (uint16 bins, the warp-shared kernel),
    `gw` features a warp, `warps` a block, slices of `width` features
    (`slices` of them), tiles of `tile` rows, `smem` shared bytes a
    block; the sort's `sort_tiles` and `scan_blocks`; the grid's
    `max_tiles` (ceil(n / tile) + C, at least the table's count) and the
    partials' `part_tiles` (ceil(2n / tile): a slot of two tiles or more
    has more than `tile` rows, so its tiles number under twice its rows
    over `tile`)."""
    wide: bool
    gw: int
    warps: int
    width: int
    slices: int
    tile: int
    smem: int
    sort_tiles: int
    scan_blocks: int
    max_tiles: int
    part_tiles: int


def _stage_bytes(warps: int, num_bins: int) -> int:
    """moment_wide_kernel's staged rows, values [warps][R + 1] f32,
    channels [R][3] f32 and bins [warps][R + 2] uint16, and each warp's
    [B] int32 claims."""
    r = MOMENT_STAGE_ROWS
    return warps * (4 * (r + 1) + 4 * num_bins + 2 * (r + 2)) + 12 * r


def _lane_warp_bytes(gw: int, num_bins: int) -> int:
    return MOMENT_SLOT_BYTES * (num_bins + 1) * gw


def moment_plan(n: int, f_cnt: int, num_bins: int, c_cnt: int, wide: bool,
                run: int = MOMENT_RUN,
                wide_tile: int = MOMENT_WIDE_TILE) -> MomentPlan:
    """LM's plan (see the constants above) for n rows of f_cnt features
    of num_bins bins and c_cnt ids; `run` and `wide_tile` as the kernel
    takes them (other values only replay another order)."""
    if f_cnt < 1 or not 1 <= num_bins <= MAX_GROUP_BINS or c_cnt < 0 \
            or n < 0:
        raise LightGBMError("moment_plan: features >= 1 and 1..%d bins"
                            % MAX_GROUP_BINS)
    if wide:
        hist = MOMENT_SLOT_BYTES * num_bins
        fits = [w for w in range(1, MOMENT_WIDE_WARPS + 1)
                if w * hist + _stage_bytes(w, num_bins) <= MOMENT_SMEM_BYTES]
        warps = min(max(fits, default=1), f_cnt)
        gw, width, tile = 1, warps, int(wide_tile)
        smem = warps * hist + _stage_bytes(warps, num_bins)
    else:
        gw = min(32, 1 << (int(f_cnt) - 1).bit_length())
        while gw > 1 and 2 * _lane_warp_bytes(gw, num_bins) \
                > MOMENT_SMEM_BYTES:
            gw //= 2
        wb = _lane_warp_bytes(gw, num_bins)
        warps = max(1, min(MOMENT_MAX_WARPS, MOMENT_SMEM_BYTES // wb))
        width, tile, smem = gw, warps * int(run), warps * wb
    slices = -(-int(f_cnt) // width)
    sort_tiles = scan_blocks = 0
    if n and c_cnt:
        sort_tiles = min(-(-int(n) // MOMENT_SORT_ROWS),
                         max(1, MOMENT_MAX_SORT_CELLS // int(c_cnt)))
        scan_blocks = -(-(int(c_cnt) * sort_tiles) // MOMENT_SCAN_CHUNK)
    return MomentPlan(bool(wide), gw, warps, width, slices, tile, smem,
                      sort_tiles, scan_blocks,
                      -(-int(n) // tile) + int(c_cnt),
                      max(1, -(-2 * int(n) // tile)))


def moment_tiles(begin: np.ndarray, tile: int, max_tiles: int):
    """LM's tile table as the last block of moment_offset_kernel builds
    it from the slots' segment starts begin [C + 1], and each tile as a
    block reads it (tile_of): slot c's count ceil(rows / tile), its
    first tile (an exclusive scan of the counts) and its first partial
    (an exclusive scan of the counts of two or more); block e < total
    takes the largest slot whose first tile is at most e. Returns the
    int64 arrays tiles [total, 4] (slot, first position, rows, partial or
    -1 for a slot's only tile), first, count, pfirst [C]; blocks e of
    total <= e < max_tiles exit."""
    begin = np.asarray(begin, np.int64)
    rows = np.diff(begin)
    count = (rows + tile - 1) // tile
    first = np.concatenate([[0], np.cumsum(count)[:-1]]).astype(np.int64)
    multi = np.where(count >= 2, count, 0)
    pfirst = np.concatenate([[0], np.cumsum(multi)[:-1]]).astype(np.int64)
    total = int(count.sum())
    if total > max_tiles:
        raise LightGBMError("moment_tiles: %d tiles past the grid's %d"
                            % (total, max_tiles))
    tiles = np.zeros((total, 4), np.int64)
    for e in range(total):
        lo, hi = 0, len(rows) - 1
        while lo < hi:
            mid = (lo + hi + 1) >> 1
            if first[mid] <= e:
                lo = mid
            else:
                hi = mid - 1
        j = e - first[lo]
        tiles[e] = (lo, begin[lo] + j * tile, min(tile, rows[lo] - j * tile),
                    pfirst[lo] + j if count[lo] > 1 else -1)
    return tiles, first, count, pfirst


def _slots(leaf_id: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """[N] int64: the c with ids[c] == leaf_id[r], or -1 (ids not
    empty)."""
    sid, by_id = torch.sort(ids.long(), stable=True)
    at = torch.searchsorted(sid, leaf_id.long()).clamp(max=len(sid) - 1)
    return torch.where(sid[at] == leaf_id.long(), by_id[at], -1)


def leaf_moments_order(binned: torch.Tensor, x: torch.Tensor,
                       w3: torch.Tensor, num_bins: int,
                       leaf_id: torch.Tensor, ids: torch.Tensor,
                       plan: Optional[MomentPlan] = None) -> torch.Tensor:
    """LM in its own summation order, replayed in torch ops on the
    inputs' device, bit for bit the kernel's (with the kernel's plan,
    `moment_plan`'s): the rows sorted stably by slot, each slot's
    segment cut into tiles (`moment_tiles`), each term formed in f32
    and summed in f64 from +0, a chain a (feature, bin) in position
    order: uint8 bins, warp w of a tile over its run of positions, the
    warps then added in warp order; uint16 bins, over all of the tile's
    positions. A slot's tiles are added in tile order from +0 and
    rounded to f32 once. [C, F, B, 4]."""
    n, f_cnt = binned.shape
    c_cnt = ids.shape[0]
    dev = binned.device
    wide = binned.dtype == torch.uint16
    if plan is None:
        plan = moment_plan(n, f_cnt, num_bins, c_cnt, wide)
    out = torch.zeros((c_cnt, f_cnt, num_bins, 4), dtype=torch.float32,
                      device=dev)
    if n == 0 or c_cnt == 0:
        return out
    slot = _slots(leaf_id, ids)
    sel = torch.nonzero(slot >= 0)[:, 0]
    order = sel[torch.argsort(slot[sel], stable=True)]
    begin = np.concatenate([[0], np.cumsum(torch.bincount(
        slot[sel], minlength=c_cnt).cpu().numpy())])
    tiles, first, count, _ = moment_tiles(begin, plan.tile, plan.max_tiles)
    if not len(tiles):
        return out
    t_dev = torch.from_numpy(tiles).to(dev)
    e_cnt = len(tiles)
    bins_all = widen_bins(binned)
    fr = torch.arange(f_cnt, device=dev)

    def gather(pos, valid):
        """bins (B where not valid or past B), f64 terms [.., F, 4]."""
        r = order[(t_dev[:, 1:2] + pos).clamp(max=len(order) - 1)]
        b = bins_all[r].long()
        b = torch.where(valid[..., None] & (b < num_bins), b, num_bins)
        v = x[r]
        v = torch.where(torch.isfinite(v), v, torch.zeros_like(v))
        w = w3[r]
        gm, hm, m = w[..., 0:1], w[..., 1:2], w[..., 2:3]
        t = torch.stack([v * m, (v * v) * m, v * gm, v * hm], -1)
        return b, t.double()

    # uint8: warp w of a tile adds its run of positions; uint16: one warp
    # a feature adds all of the tile's
    warps = 1 if wide else plan.warps
    run = plan.tile // warps
    acc = torch.zeros((e_cnt, warps, f_cnt, num_bins + 1, 4),
                      dtype=torch.float64, device=dev)
    wbase = torch.arange(warps, device=dev)[None, :] * run
    for k in range(min(run, int(tiles[:, 2].max()))):
        pos = wbase + k
        b, t = gather(pos, pos < t_dev[:, 2:3])
        acc.scatter_add_(3, b[:, :, :, None, None].expand(
            e_cnt, warps, f_cnt, 1, 4), t[:, :, :, None, :])
    sums = torch.zeros_like(acc[:, 0, :, :num_bins])
    for wi in range(warps):
        sums = sums + acc[:, wi, :, :num_bins]
    a = torch.zeros((c_cnt, f_cnt, num_bins, 4), dtype=torch.float64,
                    device=dev)
    first_t = torch.from_numpy(first).to(dev)
    count_t = torch.from_numpy(count).to(dev)
    for j in range(int(count.max())):
        has = count_t > j
        at = torch.where(has, first_t + j, 0)
        a = a + torch.where(has[:, None, None, None], sums[at],
                            torch.zeros_like(a))
    return a.float()


def leaf_moments(binned: torch.Tensor, x: torch.Tensor, w3: torch.Tensor,
                 num_bins: int, leaf_id: torch.Tensor,
                 ids: torch.Tensor) -> torch.Tensor:
    """LM: the [C, F, B, 4] f32 moments (sum x*m, sum x^2*m, sum x*g*m,
    sum x*h*m) per (leaf id, feature, bin) of the rows whose leaf_id [N]
    is ids[c]. binned [N, F] holds per-feature bins (uint8, or uint16 for
    features of more than 256 bins) and x [N, F] the raw
    values aligned with them (the caller resolves EFB); w3 [N, 3] =
    (g*m, h*m, m); a non-finite x adds nothing; the ids are distinct.
    All rows are one id over a constant leaf_id. Counterpart of
    lightgbm_tpu/ops/histogram.py batched_leaves_moments (:679). The ids
    are checked and sorted on the host, so ids on the card are read
    back once (`leaf_moments_ids` takes them from the host)."""
    return _leaf_moments(binned, x, w3, num_bins, leaf_id, ids)


def leaf_moments_ids(binned: torch.Tensor, x: torch.Tensor,
                     w3: torch.Tensor, num_bins: int, leaf_id: torch.Tensor,
                     ids) -> torch.Tensor:
    """`leaf_moments` with the ids as host integers (a sequence or an
    array; a tensor of them is read back once): the same checks and
    result, and no read back from the card; the sorted ids go up once a
    set (`_moment_keys`). On the card the call reads nothing back, so a
    CUDA graph can capture it."""
    if isinstance(ids, torch.Tensor):
        ids = ids.cpu().numpy()
    return _leaf_moments(binned, x, w3, num_bins, leaf_id,
                         np.asarray(ids, dtype=np.int64).reshape(-1))


def _leaf_moments(binned, x, w3, num_bins, leaf_id, ids):
    n, f_cnt = binned.shape
    host = isinstance(ids, np.ndarray)
    if x.shape != (n, f_cnt) or w3.shape != (n, 3) \
            or leaf_id.shape != (n,) or ids.ndim != 1:
        raise LightGBMError("leaf_moments takes binned and x [N, F], w3 "
                            "[N, 3], leaf_id [N] and ids [C]")
    tensors = (binned, x, w3, leaf_id) + (() if host else (ids,))
    if any(t.device != binned.device for t in tensors):
        raise LightGBMError("leaf_moments: inputs on different devices")
    ids_host = ids if host else ids.cpu().numpy()
    if len(np.unique(ids_host)) != len(ids_host):
        raise LightGBMError("leaf_moments takes distinct ids")
    if binned.device.type == "cpu":
        return leaf_moments_plain(binned, x, w3, num_bins, leaf_id,
                                  torch.from_numpy(ids_host) if host
                                  else ids)
    if binned.device.type != "cuda":
        raise LightGBMError("leaf_moments runs on cpu or cuda, not %s"
                            % binned.device)
    u16 = binned.dtype == torch.uint16
    if not ((binned.dtype == torch.uint8 and 1 <= num_bins <= 256)
            or (u16 and 1 <= num_bins <= MAX_GROUP_BINS)) \
            or x.dtype != torch.float32 or w3.dtype != torch.float32:
        raise LightGBMError("the leaf_moments kernel takes uint8 bins (at "
                            "most 256), or uint16 bins (at most %d), f32 x "
                            "and f32 w3" % MAX_GROUP_BINS)
    if not all(t.is_contiguous() for t in tensors):
        raise LightGBMError("leaf_moments takes contiguous tensors")
    if leaf_id.dtype != torch.int32 or (
            ids.dtype != torch.int32 if not host else
            len(ids_host) and (ids_host.min() < -2 ** 31
                               or ids_host.max() >= 2 ** 31)):
        raise LightGBMError("leaf_moments takes int32 leaf ids and ids")
    c_cnt = len(ids_host)
    dev = binned.device
    plan = moment_plan(n, f_cnt, num_bins, c_cnt, u16)
    out = torch.empty((c_cnt, f_cnt, num_bins, 4), dtype=torch.float32,
                      device=dev)
    keys = _moment_keys(ids_host.astype(np.int32), dev) if c_cnt else None
    iscratch = torch.empty(
        2 + c_cnt * plan.sort_tiles + plan.scan_blocks + 4 * c_cnt + 2
        + 2 * n, dtype=torch.int32, device=dev)
    part = torch.empty(plan.part_tiles * f_cnt * num_bins * 4,
                       dtype=torch.float64, device=dev)
    lib = _build.load_library("moments")
    args = (_ptr(binned), n, f_cnt, int(u16), _ptr(x), _ptr(w3),
            _ptr(leaf_id), ctypes.c_void_p(None if keys is None
                                           else keys.data_ptr()),
            c_cnt, num_bins, plan.sort_tiles, plan.scan_blocks, plan.tile,
            plan.gw, plan.warps, plan.slices, plan.max_tiles, plan.smem,
            _ptr(iscratch), _ptr(part), _ptr(out))
    # no device switch when the inputs' card is already the current one
    if torch.cuda.current_device() == dev.index:
        rc = lib.lgbt_leaf_moments(*args, ctypes.c_void_p(
            torch.cuda.current_stream().cuda_stream))
    else:
        with torch.cuda.device(dev):
            rc = lib.lgbt_leaf_moments(*args, ctypes.c_void_p(
                torch.cuda.current_stream().cuda_stream))
    _moments_ok(rc, lib)
    with _launch_lock:
        leaf_moments.launches += 1
        if u16:
            leaf_moments.launches_u16 += 1
    return out


# the ids sorted ascending and their slots, on the card: a set uploaded
# once (pinned, without waiting on the stream) and kept for its next call
_MOMENT_KEYS_KEPT = 16
_moment_key_cache: dict = {}


def _moment_keys(ids_host: np.ndarray, dev: torch.device) -> torch.Tensor:
    key = (dev.index, ids_host.tobytes())
    with _launch_lock:
        keys = _moment_key_cache.get(key)
    if keys is None:
        by_id = np.argsort(ids_host, kind="stable")
        keys = torch.from_numpy(np.concatenate(
            [ids_host[by_id], by_id]).astype(np.int32)).pin_memory().to(
            dev, non_blocking=True)
        with _launch_lock:
            _moment_key_cache[key] = keys
            while len(_moment_key_cache) > _MOMENT_KEYS_KEPT:
                del _moment_key_cache[next(iter(_moment_key_cache))]
    return keys


def segment_tiles(begin: np.ndarray, rows: np.ndarray, tile: int):
    """Cut each of the C segments (begin[c], rows[c]) of a row sequence
    into tiles of at most `tile` rows, segment by segment. Returns the
    int32 array [(segment, first position, rows) per tile..., each
    segment's first tile [C], its tile count [C]] and the tile count."""
    rows = np.asarray(rows, np.int64)
    count = (rows + tile - 1) // tile
    first = np.concatenate([[0], np.cumsum(count)[:-1]]).astype(np.int64)
    of = np.repeat(np.arange(len(rows)), count)
    step = (np.arange(len(of)) - first[of]) * tile
    tiles = np.stack([of, np.asarray(begin, np.int64)[of] + step,
                      np.minimum(tile, rows[of] - step)], 1)
    return (np.concatenate([tiles.reshape(-1), first, count]).astype(
        np.int32), len(of))


def _ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def _moments_ok(rc: int, lib) -> None:
    if rc != 0:
        raise LightGBMError("leaf_moments launch failed: CUDA error %d (%s)"
                            % (rc, lib.lgbt_error_string(rc).decode()))


# all launches of LM, and those on uint16 bins among them
leaf_moments.launches = 0
leaf_moments.launches_u16 = 0
