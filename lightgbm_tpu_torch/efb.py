"""Exclusive Feature Bundling (EFB): the port's own copy of
`lightgbm_tpu/efb.py` (reference: `src/io/dataset.cpp:66-211`,
FindGroups + FastFeatureBundling).

Mutually-(almost-)exclusive sparse features share one stored column of
the `[rows, groups]` uint8 matrix. Per multi-feature group:
  bin 0                                  = every member at its default
  bins [offset_j, offset_j + num_bin_j)  = feature j's own bins
Feature j's histogram is the group histogram's slice; its default-bin
mass is rebuilt from leaf totals (FixHistogram, dataset.cpp:747-767,
done by the split-scan kernel, ops/split.py). Single-feature groups
store the feature's bins unshifted.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np

from . import log

DEFAULT_MAX_GROUP_BINS = 256  # uint8 storage; reference GPU has the same cap


def pick_max_group_bins(num_bins: np.ndarray) -> int:
    """Bundle-capacity heuristic. The reference CPU bundles without a bin
    cap (uint16/uint32 Bin variants); its GPU caps at 256. We pay for the
    histogram width of the WIDEST group on every group (padded one-hot), so
    the cap trades bundle count against padding waste: allow ~16 features
    per bundle, minimum 256 (uint8), capped at 2048 (uint16)."""
    if len(num_bins) == 0:
        return DEFAULT_MAX_GROUP_BINS
    return int(max(DEFAULT_MAX_GROUP_BINS,
                   min(2048, 16 * (int(num_bins.max()) + 1))))


class FeatureGroups:
    """Static feature->group layout.

    Attributes (F = number of used features, G = number of groups):
      group_of:    [F] group index of each feature
      offset_of:   [F] bin offset of the feature inside its group
      is_bundled:  [F] True when the feature shares its group (histogram
                   default-bin mass must be reconstructed)
      group_num_bin: [G] total bins of each group
      groups:      list of member-feature lists
    """

    def __init__(self, groups: List[List[int]], num_bins: np.ndarray):
        f = int(num_bins.shape[0])
        self.groups = groups
        self.group_of = np.zeros(f, np.int32)
        self.offset_of = np.zeros(f, np.int32)
        self.is_bundled = np.zeros(f, bool)
        self.group_num_bin = np.zeros(len(groups), np.int32)
        for g, members in enumerate(groups):
            if len(members) == 1:
                j = members[0]
                self.group_of[j] = g
                self.offset_of[j] = 0
                self.group_num_bin[g] = num_bins[j]
                continue
            off = 1  # bin 0 = all members at default
            for j in members:
                self.group_of[j] = g
                self.offset_of[j] = off
                self.is_bundled[j] = True
                off += int(num_bins[j])
            self.group_num_bin[g] = off

    @property
    def num_groups(self) -> int:
        return len(self.groups)

    def to_dict(self) -> dict:
        return {"groups": [[int(j) for j in g] for g in self.groups],
                "num_bins": [0] * 0}  # groups are sufficient to rebuild

    # ------------------------------------------------------------------
    def bundle_rows(self, feature_bins: List[np.ndarray],
                    default_bins: np.ndarray) -> np.ndarray:
        """Build the [N, G] group-bin matrix from per-feature bin columns.

        feature_bins[j]: [N] integer bins of used feature j.
        """
        n = len(feature_bins[0]) if feature_bins else 0
        dtype = np.uint8 if int(self.group_num_bin.max(initial=1)) <= 256 \
            else np.uint16
        out = np.zeros((n, self.num_groups), dtype)
        for g, members in enumerate(self.groups):
            if len(members) == 1:
                j = members[0]
                out[:, g] = feature_bins[j].astype(dtype)
                continue
            col = np.zeros(n, np.int32)
            for j in members:
                nz = feature_bins[j] != default_bins[j]
                # conflict rule: later member wins (bounded by
                # max_conflict_rate at grouping time)
                col[nz] = self.offset_of[j] + feature_bins[j][nz]
            out[:, g] = col.astype(dtype)
        return out


EFB_SAMPLE_CNT = 50_000


def efb_sample_indices(n: int, sample_cnt: int = EFB_SAMPLE_CNT,
                       seed: int = 1) -> Optional[np.ndarray]:
    """The sorted row indices sampled to estimate feature exclusivity,
    or None when every row is used (n <= sample_cnt). The ingest pass-1
    sketch (ingest/sketch.py) gathers exactly these rows from the chunk
    stream."""
    if n <= sample_cnt:
        return None
    rng = np.random.RandomState(seed)
    sample = rng.choice(n, size=sample_cnt, replace=False)
    sample.sort()
    return sample


def find_groups_sampled(sample_bins: List[np.ndarray],
                        default_bins: np.ndarray, num_bins: np.ndarray, *,
                        enable_bundle: bool = True,
                        max_conflict_rate: float = 0.0,
                        sparse_threshold: float = 0.8,
                        max_group_bins: Optional[int] = None
                        ) -> FeatureGroups:
    """The grouping core over an ALREADY-SAMPLED set of binned rows
    (`sample_bins[j]` holds feature j's bins for the sampled rows only):
    the rows `efb_sample_indices` names, gathered by the ingest pass-1
    sketch."""
    f = len(sample_bins)
    if f == 0:
        return FeatureGroups([], num_bins)
    if not enable_bundle or f == 1:
        return FeatureGroups([[j] for j in range(f)], num_bins)
    if max_group_bins is None:
        max_group_bins = pick_max_group_bins(num_bins)

    s = len(sample_bins[0])

    nz_masks = [sample_bins[j] != default_bins[j] for j in range(f)]
    nz_counts = np.asarray([int(m.sum()) for m in nz_masks])

    dense = nz_counts > (1.0 - sparse_threshold) * s
    budget = max_conflict_rate * s

    # bigger-nonzero-count-first ordering (the reference tries natural and
    # count order and keeps the smaller grouping, dataset.cpp:174-178; the
    # count order wins in practice)
    order = np.argsort(-nz_counts, kind="stable")
    groups: List[List[int]] = []
    gmasks: List[np.ndarray] = []
    gconflict: List[float] = []
    gbins: List[int] = []
    gnz: List[int] = []
    for j in order:
        j = int(j)
        if dense[j]:
            groups.append([j])
            gmasks.append(None)
            gconflict.append(np.inf)
            gbins.append(int(num_bins[j]))
            gnz.append(s)
            continue
        placed = False
        for g in range(len(groups)):
            if gmasks[g] is None:
                continue
            if gbins[g] + int(num_bins[j]) > max_group_bins:
                continue
            # exclusivity budget (dataset.cpp:89-91): the group's total
            # non-default rows may not exceed the sample (+ tolerated error)
            if gnz[g] + int(nz_counts[j]) > s + budget:
                continue
            overlap = int((gmasks[g] & nz_masks[j]).sum())
            if gconflict[g] + overlap <= budget:
                groups[g].append(j)
                gmasks[g] = gmasks[g] | nz_masks[j]
                gconflict[g] += overlap
                gbins[g] += int(num_bins[j])
                gnz[g] += int(nz_counts[j]) - overlap
                placed = True
                break
        if not placed:
            groups.append([j])
            gmasks.append(nz_masks[j].copy())
            gconflict.append(0.0)
            gbins.append(1 + int(num_bins[j]))
            gnz.append(int(nz_counts[j]))

    # demote 1-member "bundles" to plain groups (no reserved bin 0)
    fg = FeatureGroups(groups, num_bins)
    n_bundled = sum(1 for g in groups if len(g) > 1)
    if n_bundled:
        log.info("EFB bundled %d features into %d groups "
                 "(%d multi-feature bundles)",
                 f, fg.num_groups, n_bundled)
    return fg
