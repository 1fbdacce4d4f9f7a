"""Serial leaf-wise tree growth on the card: best-first, one split at a
time, the reference's SerialTreeLearner
(`src/treelearner/serial_tree_learner.cpp:152-583`) over kernels H, S
and R.

Counterpart of `lightgbm_tpu/learner/grow.py` `grow_tree` with
`data_axis` and `feature_axis` None, on f32 histograms summed in f32 or
in bf16 hi+lo halves (`hist_bf16`, the JAX package's `tpu_hist_bf16`,
grow.py:130-131, :152) or on quantized ones. The JAX grower
runs the split loop as one jitted program and expands a speculative
node table in batches to fill the TPU's matrix unit; its docstring
(:46-52) states that the trees it commits are those of a sequential
best-first grower, which is what this one is:

- rows live in a DataPartition (`perm`, each leaf a contiguous
  segment, data_partition.hpp:94-170) and carry their leaf slot in
  `leaf_id`;
- the root histogram is one all-rows pass of H; the root totals are
  the sum over the bins of group 0 (grow.py:849);
- each commit pops the leaf of largest cached gain (ties: the lowest
  leaf slot, where the JAX grower breaks them by node-table slot,
  grow.py:1209-1210), routes its segment with R (left child keeps the
  slot, right child takes `num_leaves_used`, grow.py:1218-1254), builds
  the SMALLER child's histogram with H from its row segment and the
  larger as parent - smaller, and scans both children with one S
  launch;
- a child's (sum_g, sum_h, count) come from the parent's scan, the
  right child's as parent - left (grow.py:1134-1140), never re-summed;
- S scans the bins in the order of XLA's CPU cumsum (`ops/split.py`
  `xla_cumsum`), as the JAX grower's `jnp.cumsum` adds them: where a
  split is decided in the last bits (a bin that holds only rows of
  weight 0 ties two thresholds), the port then decides as the JAX
  package does.

The host reads the two children's best splits back after each split
(one small device-to-host copy); leaf values and the tree arrays are
f32 numpy on the host, in the JAX grower's operation order.

Quantized training (`hist_quantize` int8 or int16, grow.py:212-227):
the rows carry the quantizer's integer codes and 0/1 in-bag weight
(`ops/histogram.quantize_gradients`), histograms are int32 (kernel HQ)
and the cache holds them, so parent - smaller child is exact; the root
totals are the int32 sum over group 0's bins (grow.py:849-852), and
both they and each histogram S scans are dequantized (`hist * qscale`,
`ops/split.dequantize_hist`) right before use (grow.py:1143-1145).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np
import torch

from ..log import LightGBMError
from ..ops.histogram import (hist_layout, i32_plan, leaf_histogram,
                              leaf_histogram_i32, subtract)
from ..ops.route import SplitRule, route_partition, route_scratch
from ..ops.split import (SplitParams, dequantize_hist, device_fmeta,
                         leaf_output, split_scan)

_F32 = np.float32


@dataclass(frozen=True)
class GrowerConfig:
    num_leaves: int
    lambda_l1: float = 0.0
    lambda_l2: float = 0.0
    min_gain_to_split: float = 0.0
    min_data_in_leaf: int = 20
    min_sum_hessian_in_leaf: float = 1e-3
    max_depth: int = -1
    # quantized training: "none" | "int16" | "int8", and the quantizer's
    # clip magnitude (ops/histogram.train_qmax)
    hist_quantize: str = "none"
    hist_qmax: int = 0
    # f32 histograms: g and h summed in bf16 hi+lo halves (H's hi+lo
    # mode), as tpu_hist_bf16 (true by default) chooses
    hist_bf16: bool = True

    def split_params(self) -> SplitParams:
        return SplitParams(self.lambda_l1, self.lambda_l2,
                           self.min_gain_to_split, self.min_data_in_leaf,
                           self.min_sum_hessian_in_leaf, self.max_depth)


@dataclass
class GrowerState:
    """What one tree growth returns: the TreeGrowerState fields the
    boosting layer reads (lightgbm_tpu/boosting/gbdt.py:156-160), host
    numpy, and `leaf_id` [N] i32 (leaf slot of each row) on the device:
    the grower's own buffer, valid until its next `grow`."""
    leaf_id: torch.Tensor
    num_leaves_used: int
    sum_g: np.ndarray
    sum_h: np.ndarray
    count: np.ndarray
    leaf_value: np.ndarray
    leaf_depth: np.ndarray
    leaf_parent: np.ndarray
    node_feature: np.ndarray
    node_threshold: np.ndarray
    node_default_left: np.ndarray
    node_is_cat: np.ndarray
    node_left: np.ndarray
    node_right: np.ndarray
    node_gain: np.ndarray
    node_value: np.ndarray
    node_count: np.ndarray
    # the DataPartition: perm [N] i32 on the device (the grower's own
    # buffer, like leaf_id) and each leaf slot's segment of it, host
    # int64 [L] (leaf_rows 0 for an unused slot)
    perm: Optional[torch.Tensor] = None
    leaf_begin: Optional[np.ndarray] = None
    leaf_rows: Optional[np.ndarray] = None


class _LeafTable:
    """Per leaf slot: its totals, depth and cached best split."""

    def __init__(self, L: int):
        self.sum = np.zeros((L, 3), _F32)     # g, h, count
        self.depth = np.zeros(L, np.int32)
        self.gain = np.full(L, -np.inf, _F32)
        self.feature = np.zeros(L, np.int32)
        self.threshold = np.zeros(L, np.int32)
        self.default_left = np.zeros(L, bool)
        self.is_cat = np.zeros(L, bool)
        self.left = np.zeros((L, 3), _F32)    # left g, h, count

    def take(self, slot: int, out_f: np.ndarray, out_i: np.ndarray) -> None:
        self.gain[slot] = out_f[0]
        self.left[slot] = out_f[1:4]
        self.feature[slot] = out_i[0]
        self.threshold[slot] = out_i[1]
        self.default_left[slot] = bool(out_i[2])
        self.is_cat[slot] = bool(out_i[3])


class SerialGrower:
    """Grows trees over one device-resident binned matrix.

    binned: [N, G] stored-group bins on the device, uint8, or uint16
    where a group has more than 256 bins (every kernel takes the
    matrix's type from the tensor); fmeta: Dataset.feature_meta_arrays();
    num_bins: the histogram width (widest group); feature_bins: the
    per-feature scan width; group_bins: each group's own bin count [G],
    which H lays a uint16 matrix's sums out by (required for one; its
    `hist_layout` is made here, once). Quantized growth on the card makes
    HQ's `i32_plan` here too, once: its slices and each group's skipped
    bin, counted over the matrix's rows."""

    def __init__(self, binned: torch.Tensor, fmeta: Dict[str, np.ndarray],
                 cfg: GrowerConfig, num_bins: int, feature_bins: int,
                 group_bins: Optional[np.ndarray] = None):
        if cfg.num_leaves < 2:
            raise LightGBMError("num_leaves must be >= 2")
        self.binned = binned
        self.device = binned.device
        self.cfg = cfg
        self.params = cfg.split_params()
        self.num_bins = int(num_bins)
        self.feature_bins = int(feature_bins)
        self.hist_layout = None
        if binned.dtype == torch.uint16:
            if group_bins is None:
                raise LightGBMError("SerialGrower: a uint16 matrix takes "
                                    "each group's own bin count "
                                    "(group_bins)")
            self.hist_layout = hist_layout(group_bins, cfg.hist_bf16,
                                           self.device)
        self.fmeta = {k: np.asarray(v) for k, v in fmeta.items()}
        self.fmeta_dev = device_fmeta(fmeta, self.device)
        n = binned.shape[0]
        self.n = n
        self.quantized = cfg.hist_quantize != "none"
        if self.quantized and not 1 <= cfg.hist_qmax <= (2 ** 31 - 1) // \
                max(1, n):
            raise LightGBMError(
                "hist_quantize=%s: qmax %d at %d rows can overflow the int32 "
                "histograms (ops/histogram.train_qmax caps it)"
                % (cfg.hist_quantize, cfg.hist_qmax, n))
        self.hq_plan = None
        if self.quantized and self.device.type == "cuda":
            self.hq_plan = i32_plan(
                binned, self.num_bins,
                group_bins if binned.dtype == torch.uint16 else None)
        # the DataPartition's two buffers: R reads a leaf's segment from
        # one and writes its children's into the other (grow tracks which
        # holds each leaf's); `perm` is whole again when grow ends
        self.perm = torch.empty(n, dtype=torch.int32, device=self.device)
        self._perm_b = torch.empty_like(self.perm)
        self.leaf_id = torch.empty(n, dtype=torch.int32, device=self.device)
        # R reads one group's column a split: on the card from a
        # column-major copy of the bins (the JAX grower's binned_T), where
        # a dense segment's bins are contiguous (PERF.md, PR 13)
        on_card = self.device.type == "cuda"
        self._route_scratch = route_scratch(n, self.device) if on_card \
            else None
        self._route_bins = binned.t().contiguous().t() if on_card \
            else binned
        L = cfg.num_leaves
        dev = self.device
        # per-split buffers, reused: S's outputs for two leaves in one
        # int32 block (one device-to-host copy a split), the children's
        # depths as a device table, their totals through a pinned host
        # buffer (an asynchronous copy), and R's left counts, read back
        # once a tree
        self._res = torch.empty(16, dtype=torch.int32, device=dev)
        self._out = (self._res[:8].view(torch.float32).view(2, 4),
                     self._res[8:].view(2, 4),
                     torch.empty((2, len(self.fmeta["num_bin"])),
                                 dtype=torch.float32, device=dev))
        depths = np.repeat(np.arange(L + 1, dtype=np.int32)[:, None], 2, 1)
        self._depths = torch.from_numpy(depths).to(dev)
        self._sums_host = torch.empty((2, 3), dtype=torch.float32,
                                      pin_memory=dev.type == "cuda")
        self._sums_dev = torch.empty((2, 3), dtype=torch.float32, device=dev)
        self._left_dev = torch.empty(L, dtype=torch.int32, device=dev)

    # ------------------------------------------------------------------
    def _scan(self, hists, sums, depth, mask_dev) -> np.ndarray:
        """S on C = len(sums) leaves at one depth; returns the host copy
        of the result block (out_f as f32 in [:4C], out_i in [8:8+4C])."""
        c = len(sums)
        self._sums_host[:c].numpy()[:] = sums
        self._sums_dev[:c].copy_(self._sums_host[:c], non_blocking=True)
        split_scan(hists, self._sums_dev[:c], self._depths[depth, :c],
                   self.fmeta_dev, mask_dev, self.params, self.feature_bins,
                   out=tuple(t[:c] for t in self._out))
        return self._res.cpu().numpy()

    def _histogram(self, chans, rows=None, n_rows=None, out=None):
        """H on f32 channels, or HQ on (codes, w01) when quantized."""
        if self.quantized:
            codes, w01 = chans
            return leaf_histogram_i32(self.binned, codes, w01, self.num_bins,
                                      rows=rows, n_rows=n_rows, out=out,
                                      plan=self.hq_plan)
        return leaf_histogram(self.binned, chans, self.num_bins, rows=rows,
                              n_rows=n_rows, out=out,
                              bf16=self.cfg.hist_bf16,
                              layout=self.hist_layout)

    def grow(self, chans, feature_mask: np.ndarray,
             qscale: Optional[torch.Tensor] = None,
             bagged: bool = False) -> GrowerState:
        """One tree under the per-tree feature mask [F] bool, from the
        channels w3 [N, 3] = (g*w, h*w, w) or, when quantized, from the
        quantizer's (codes [N, 2] int16, w01 [N] f32) and its [3] scale
        `qscale` on the device. `bagged`: some rows weigh 0, so a leaf
        holds more rows than its count channel says and each split reads
        R's count of the rows it sent left back to the host (one more
        blocking copy a split); otherwise that count is the scan's, and
        R's counts are checked against it once a tree. Row weights
        other than 0/1 (GOSS) scale g and h; the count channel counts the
        rows of weight > 0."""
        if self.quantized != (qscale is not None):
            raise LightGBMError("grow: quantized growth takes (codes, w01) "
                                "and qscale, f32 growth w3 and no qscale")
        cfg, L, n = self.cfg, self.cfg.num_leaves, self.n
        l1, l2 = cfg.lambda_l1, cfg.lambda_l2
        mask_dev = torch.from_numpy(
            np.asarray(feature_mask, np.uint8)).to(self.device)
        self.perm.copy_(torch.arange(n, dtype=torch.int32,
                                     device=self.device))
        self.leaf_id.zero_()
        begin = np.zeros(L, np.int64)
        rows = np.zeros(L, np.int64)
        rows[0] = n
        bufs = (self.perm, self._perm_b)
        side = np.zeros(L, np.int8)   # the buffer holding each segment
        t = _LeafTable(L)
        st = GrowerState(
            leaf_id=self.leaf_id, num_leaves_used=1,
            sum_g=np.zeros(L, _F32), sum_h=np.zeros(L, _F32),
            count=np.zeros(L, _F32), leaf_value=np.zeros(L, _F32),
            leaf_depth=np.zeros(L, np.int32),
            leaf_parent=np.full(L, -1, np.int32),
            node_feature=np.zeros(L - 1, np.int32),
            node_threshold=np.zeros(L - 1, np.int32),
            node_default_left=np.zeros(L - 1, bool),
            node_is_cat=np.zeros(L - 1, bool),
            node_left=np.zeros(L - 1, np.int32),
            node_right=np.zeros(L - 1, np.int32),
            node_gain=np.zeros(L - 1, _F32),
            node_value=np.zeros(L - 1, _F32),
            node_count=np.zeros(L - 1, _F32))
        hist = [None] * L

        # ---- root (BeforeTrain, serial_tree_learner.cpp:234-323)
        root = self._histogram(chans)
        if self.quantized:
            # the exact int32 total, dequantized (grow.py:849-852)
            acc = dequantize_hist(root[0].sum(0, dtype=torch.int32),
                                  qscale).cpu().numpy()
        else:
            tot = root[0].cpu().numpy()                      # [B, 3]
            acc = np.zeros(3, _F32)
            for b in range(tot.shape[0]):
                acc = acc + tot[b]
        t.sum[0] = acc
        st.sum_g[0], st.sum_h[0], st.count[0] = acc
        st.leaf_value[0] = leaf_output(acc[0], acc[1], l1, l2)
        hist[0] = root
        host = self._scan(dequantize_hist(root[None], qscale), acc[None, :],
                          0, mask_dev)
        t.take(0, host[:4].view(np.float32), host[8:12])
        expected_left = np.zeros(L, np.int32)

        used = 1
        while used < L:
            live = t.gain[:used]
            slot = int(np.argmax(live))
            if not live[slot] > 0.0:
                break
            node, new = used - 1, used
            pg, ph, pc = t.sum[slot]
            lg, lh, lc = t.left[slot]
            rg, rh, rc = pg - lg, ph - lh, pc - lc
            # tree bookkeeping (Tree::Split, tree.cpp:50-69)
            parent = st.leaf_parent[slot]
            if parent >= 0:
                if st.node_left[parent] == ~slot:
                    st.node_left[parent] = node
                else:
                    st.node_right[parent] = node
            st.node_left[node], st.node_right[node] = ~slot, ~new
            f = int(t.feature[slot])
            st.node_feature[node] = f
            st.node_threshold[node] = t.threshold[slot]
            st.node_default_left[node] = t.default_left[slot]
            st.node_is_cat[node] = t.is_cat[slot]
            st.node_gain[node] = t.gain[slot]
            st.node_value[node] = leaf_output(pg, ph, l1, l2)
            st.node_count[node] = pc
            depth = int(t.depth[slot]) + 1
            for s, (g, h, c) in ((slot, (lg, lh, lc)), (new, (rg, rh, rc))):
                st.sum_g[s], st.sum_h[s], st.count[s] = g, h, c
                st.leaf_value[s] = leaf_output(g, h, l1, l2)
                st.leaf_depth[s] = depth
                st.leaf_parent[s] = node
                t.sum[s] = (g, h, c)
                t.depth[s] = depth
            used += 1

            # route the parent's rows (R) and split its segment
            fm = self.fmeta
            rule = SplitRule(
                group=int(fm["group"][f]), offset=int(fm["offset"][f]),
                num_bin=int(fm["num_bin"][f]),
                default_bin=int(fm["default_bin"][f]),
                missing_type=int(fm["missing_type"][f]),
                bundled=bool(fm["is_bundled"][f]),
                threshold=int(t.threshold[slot]),
                default_left=bool(t.default_left[slot]),
                is_cat=bool(t.is_cat[slot]), left_slot=slot, right_slot=new)
            b0, m = int(begin[slot]), int(rows[slot])
            src = int(side[slot])
            route_partition(self._route_bins, bufs[src], b0, m, rule,
                            self.leaf_id,
                            count_out=self._left_dev[node:node + 1],
                            out=bufs[1 - src], scratch=self._route_scratch)
            side[slot] = side[new] = 1 - src
            if bagged:
                n_left = int(self._left_dev[node])
            else:
                n_left = int(round(float(lc)))
                expected_left[node] = n_left
            begin[new], rows[new] = b0 + n_left, m - n_left
            rows[slot] = n_left
            t.gain[slot] = t.gain[new] = -np.inf
            if used == L:
                break

            # the smaller child's histogram (H), the larger by subtraction
            small_left = lc * _F32(2.0) <= pc
            small = slot if small_left else new
            i_small = 0 if small_left else 1
            pair = torch.empty((2,) + tuple(hist[slot].shape),
                               dtype=hist[slot].dtype, device=self.device)
            self._histogram(chans,
                            rows=bufs[side[small]][int(begin[small]):],
                            n_rows=int(rows[small]), out=pair[i_small])
            subtract(hist[slot], pair[i_small], out=pair[1 - i_small])
            if not self.quantized:
                # a bin no row of the larger child reaches holds no
                # gradient; f32 subtraction leaves round-off there
                big = pair[1 - i_small]
                big[..., :2].masked_fill_(big[..., 2:] == 0, 0.0)
            hist[slot], hist[new] = pair[0], pair[1]
            host = self._scan(dequantize_hist(pair, qscale),
                              t.sum[[slot, new]], depth, mask_dev)
            hf = host[:8].view(np.float32).reshape(2, 4)
            hi = host[8:16].reshape(2, 4)
            t.take(slot, hf[0], hi[0])
            t.take(new, hf[1], hi[1])

        st.num_leaves_used = used
        self._join_segments(begin, rows, side, used)
        st.perm, st.leaf_begin, st.leaf_rows = self.perm, begin, rows
        if bagged:
            return st
        got = self._left_dev[:used - 1].cpu().numpy()
        bad = np.flatnonzero(got != expected_left[:used - 1])
        if len(bad):
            raise LightGBMError(
                "route_partition sent %d rows left at node %d where the "
                "split scan counted %d" % (got[bad[0]], bad[0],
                                           expected_left[bad[0]]))
        return st

    def _join_segments(self, begin: np.ndarray, rows: np.ndarray,
                       side: np.ndarray, used: int) -> None:
        """One gather a tree: the segments that the last splits left in
        the second buffer are taken into `perm`, which then holds every
        leaf's segment, the partition a single buffer would hold."""
        if not side[:used].any():
            return
        order = np.argsort(begin[:used], kind="stable")
        mask = torch.repeat_interleave(
            torch.from_numpy(side[:used][order] != 0).to(self.device),
            torch.from_numpy(rows[:used][order]).to(self.device),
            output_size=self.n)
        torch.where(mask, self._perm_b, self.perm, out=self.perm)


def leaf_path_features(leaf_parent: np.ndarray, node_feature: np.ndarray,
                       node_left: np.ndarray, node_right: np.ndarray,
                       num_leaves_used: int, k: int) -> np.ndarray:
    """Per leaf slot, the first `k` DISTINCT split features on its path
    from the leaf up to the root, nearest the leaf first: the candidate
    regressors of a linear leaf (lightgbm_tpu/learner/grow.py:1358).

    Host numpy over the grower's node arrays: `leaf_parent[l]` is the
    node whose split made leaf slot l (-1 for unused slots and the
    one-leaf tree), children encode leaves as `~slot`, features are in
    the inner space. Returns [L, k] int32, -1-padded."""
    m = len(node_left)
    node_parent = np.full(m, -1, np.int64)
    for node in range(max(int(num_leaves_used) - 1, 0)):
        for child in (node_left[node], node_right[node]):
            if child >= 0:
                node_parent[child] = node
    out = np.full((len(leaf_parent), k), -1, np.int32)
    for leaf, node in enumerate(leaf_parent):
        cnt = 0
        node = int(node)
        while node >= 0 and cnt < k:
            f = int(node_feature[node])
            if f not in out[leaf, :cnt]:
                out[leaf, cnt] = f
                cnt += 1
            node = int(node_parent[node])
    return out
