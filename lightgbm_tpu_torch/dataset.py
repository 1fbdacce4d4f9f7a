"""Binned training matrix and its metadata (host numpy).

The port's copy of `lightgbm_tpu/dataset.py` (reference Dataset,
`include/LightGBM/dataset.h:280-570`): the whole training set is ONE
dense `[num_data, num_groups]` uint8 matrix of bin indices (uint16 where
a group has more than 256 bins), which the
trainer copies to the card once (`boosting/gbdt.py`); trivial features
are dropped and sparse ones bundled (`efb.py`). Metadata mirrors
`dataset.h:36-248`: label, weights, init score and, for ranking, the
query boundaries and per-query weights.
"""
from __future__ import annotations

import json
import struct
from typing import Dict, List, Optional, Sequence

import numpy as np

from . import log
from .binning import BIN_CATEGORICAL, BinMapper

# the JAX package's first binary format (lightgbm_tpu/dataset.py:29),
# still read
_BINARY_MAGIC = b"lightgbm_tpu.dataset.v1\n"


class Metadata:
    """Labels, weights, init score and query groups (reference:
    dataset.h:36-248; lightgbm_tpu/dataset.py:28-93)."""

    def __init__(self, num_data: int = 0):
        self.num_data = num_data
        self.label: Optional[np.ndarray] = None
        self.weights: Optional[np.ndarray] = None
        self.init_score: Optional[np.ndarray] = None
        self.query_boundaries: Optional[np.ndarray] = None
        self.query_weights: Optional[np.ndarray] = None

    def set_label(self, label: Sequence[float]) -> None:
        arr = np.asarray(label, dtype=np.float32).ravel()
        if self.num_data and len(arr) != self.num_data:
            log.fatal("Length of label (%d) != num_data (%d)"
                      % (len(arr), self.num_data))
        self.label = arr
        self.num_data = len(arr)

    def set_weights(self, weights: Optional[Sequence[float]]) -> None:
        if weights is None:
            self.weights = None
            return
        arr = np.asarray(weights, dtype=np.float32).ravel()
        if self.num_data and len(arr) != self.num_data:
            log.fatal("Length of weights (%d) != num_data (%d)"
                      % (len(arr), self.num_data))
        self.weights = arr
        self._update_query_weights()

    def set_group(self, group: Optional[Sequence[int]]) -> None:
        """`group` is per-query sizes (zero allowed), converted to
        boundaries (reference: Metadata::SetQuery, metadata.cpp;
        lightgbm_tpu/dataset.py:60-73)."""
        if group is None:
            self.query_boundaries = None
            self.query_weights = None
            return
        sizes = np.asarray(group, dtype=np.int64).ravel()
        bounds = np.zeros(len(sizes) + 1, dtype=np.int64)
        np.cumsum(sizes, out=bounds[1:])
        if self.num_data and bounds[-1] != self.num_data:
            log.fatal("Sum of query counts (%d) != num_data (%d)"
                      % (bounds[-1], self.num_data))
        self.query_boundaries = bounds
        self._update_query_weights()

    def _update_query_weights(self) -> None:
        """The mean row weight of each query, 0 for an empty one
        (lightgbm_tpu/dataset.py:81-89)."""
        if self.weights is not None and self.query_boundaries is not None:
            qb = self.query_boundaries
            qw = np.zeros(len(qb) - 1, dtype=np.float32)
            for i in range(len(qb) - 1):
                s, e = qb[i], qb[i + 1]
                qw[i] = self.weights[s:e].mean() if e > s else 0.0
            self.query_weights = qw

    @property
    def num_queries(self) -> int:
        return 0 if self.query_boundaries is None \
            else len(self.query_boundaries) - 1

    def set_init_score(self, init_score: Optional[Sequence[float]]) -> None:
        if init_score is None:
            self.init_score = None
            return
        self.init_score = np.asarray(init_score, dtype=np.float64).ravel()


class Dataset:
    """The binned training matrix (reference: Dataset, dataset.h:280-570).

    Attributes:
      binned:  `[num_data, num_groups]` uint8 (uint16 past 256 group
        bins) stored-group bin indices
      mappers: per-feature BinMapper, in ORIGINAL column order
      used_features: original indices of the non-trivial features
      groups: efb.FeatureGroups over the used features
      raw:     `[num_data, num_features]` f32 values of the used features
        (the inner space), kept when built with `keep_raw` (linear trees
        regress on them; lightgbm_tpu/basic.py:307-320)
    """

    def __init__(self):
        self.binned: Optional[np.ndarray] = None
        self.raw: Optional[np.ndarray] = None
        self.mappers: List[BinMapper] = []
        self.metadata = Metadata()
        self.feature_names: List[str] = []
        self.used_features: List[int] = []
        self.num_total_features: int = 0
        self.max_bin: int = 255
        self.groups = None

    @classmethod
    def from_numpy(cls, data: np.ndarray,
                   label: Optional[Sequence[float]] = None,
                   max_bin: int = 255, min_data_in_bin: int = 3,
                   min_split_data: int = 0,
                   bin_construct_sample_cnt: int = 200000,
                   data_random_seed: int = 1,
                   categorical_features: Optional[Sequence[int]] = None,
                   use_missing: bool = True, zero_as_missing: bool = False,
                   feature_names: Optional[Sequence[str]] = None,
                   weight: Optional[Sequence[float]] = None,
                   group: Optional[Sequence[int]] = None,
                   init_score: Optional[Sequence[float]] = None,
                   reference: Optional["Dataset"] = None,
                   enable_bundle: bool = True,
                   max_conflict_rate: float = 0.0,
                   sparse_threshold: float = 0.8,
                   mappers: Optional[List[BinMapper]] = None,
                   chunk_rows: int = 65536,
                   keep_raw: bool = False) -> "Dataset":
        """Build from a dense float matrix through the two-pass ingest
        (lightgbm_tpu/dataset.py:159-176). With `reference`, its mappers
        and groups are reused, so a validation set lands in the training
        set's bin space (reference: Dataset::CreateValid). `keep_raw`
        keeps the used features' f32 values as `raw`."""
        data = np.asarray(data)
        if data.ndim != 2:
            log.fatal("Dataset data must be 2-dimensional")
        from .ingest import ArraySource, build_inner
        return build_inner(
            ArraySource(data, chunk_rows),
            max_bin=max_bin, min_data_in_bin=min_data_in_bin,
            min_split_data=min_split_data,
            bin_construct_sample_cnt=bin_construct_sample_cnt,
            data_random_seed=data_random_seed,
            categorical_features=categorical_features,
            use_missing=use_missing, zero_as_missing=zero_as_missing,
            feature_names=feature_names, label=label, weight=weight,
            group=group, init_score=init_score, reference=reference,
            mappers=mappers,
            enable_bundle=enable_bundle,
            max_conflict_rate=max_conflict_rate,
            sparse_threshold=sparse_threshold, keep_raw=keep_raw)

    # ------------------------------------------------------------------
    @property
    def num_data(self) -> int:
        return 0 if self.binned is None else self.binned.shape[0]

    @property
    def num_features(self) -> int:
        """Used (non-trivial) LOGICAL features; the stored width is
        num_groups <= num_features after EFB."""
        return len(self.used_features)

    @property
    def num_groups(self) -> int:
        return 0 if self.binned is None else self.binned.shape[1]

    @property
    def has_bundles(self) -> bool:
        return self.groups is not None and bool(self.groups.is_bundled.any())

    def feature_mapper(self, inner_idx: int) -> BinMapper:
        return self.mappers[self.used_features[inner_idx]]

    def feature_infos(self) -> List[str]:
        """Per-ORIGINAL-column `feature_infos=` entries of the model
        text header (reference: Dataset::feature_infos)."""
        used = set(self.used_features)
        return [self.mappers[j].bin_info() if j in used else "none"
                for j in range(self.num_total_features)]

    def real_feature_index(self, inner_idx: int) -> int:
        return self.used_features[inner_idx]

    def num_bins_per_feature(self) -> np.ndarray:
        return np.asarray([self.feature_mapper(j).num_bin
                           for j in range(self.num_features)], np.int32)

    def max_num_bin(self) -> int:
        """Histogram width: the widest stored group."""
        if self.groups is not None and self.groups.num_groups:
            return int(self.groups.group_num_bin.max())
        nb = self.num_bins_per_feature()
        return int(nb.max()) if len(nb) else 1

    def feature_meta_arrays(self) -> Dict[str, np.ndarray]:
        """Static per-feature metadata the split scan and the router
        read, with the EFB layout: `group` / `offset` locate a feature's
        bins in the stored groups; `is_bundled` marks features whose
        default-bin mass is rebuilt from leaf totals."""
        f = self.num_features
        num_bin = np.zeros(f, np.int32)
        missing_type = np.zeros(f, np.int32)
        default_bin = np.zeros(f, np.int32)
        is_categorical = np.zeros(f, bool)
        for j in range(f):
            m = self.feature_mapper(j)
            num_bin[j] = m.num_bin
            missing_type[j] = m.missing_type
            default_bin[j] = m.default_bin
            is_categorical[j] = m.bin_type == BIN_CATEGORICAL
        if self.groups is not None and f:
            group = self.groups.group_of.astype(np.int32)
            offset = self.groups.offset_of.astype(np.int32)
            is_bundled = self.groups.is_bundled.copy()
        else:
            group = np.arange(f, dtype=np.int32)
            offset = np.zeros(f, np.int32)
            is_bundled = np.zeros(f, bool)
        return {"num_bin": num_bin, "missing_type": missing_type,
                "default_bin": default_bin, "is_categorical": is_categorical,
                "group": group, "offset": offset, "is_bundled": is_bundled}

    # ------------------------------------------------------------------
    # the binary file (lightgbm_tpu/dataset.py:262-319): written as the
    # v2 ingest cache (ingest/cache.py); the v1 reader stays for older
    # files
    def save_binary(self, filename: str, fingerprint: str = "") -> None:
        from .ingest import save_cache
        save_cache(self, filename, fingerprint=fingerprint)

    @classmethod
    def load_binary(cls, filename: str,
                    expected_fingerprint=None) -> "Dataset":
        from .ingest import CACHE_MAGIC, load_cache
        with open(filename, "rb") as fh:
            head = fh.read(max(len(CACHE_MAGIC), len(_BINARY_MAGIC)))
        if head.startswith(CACHE_MAGIC):
            return load_cache(filename,
                              expected_fingerprint=expected_fingerprint)
        return cls._load_binary_v1(filename)

    @classmethod
    def _load_binary_v1(cls, filename: str) -> "Dataset":
        ds = cls()
        with open(filename, "rb") as fh:
            if fh.read(len(_BINARY_MAGIC)) != _BINARY_MAGIC:
                log.fatal("%s is not a lightgbm_tpu binary dataset"
                          % filename)
            (mlen,) = struct.unpack("<q", fh.read(8))
            meta = json.loads(fh.read(mlen).decode())
            ds.feature_names = meta["feature_names"]
            ds.used_features = [int(x) for x in meta["used_features"]]
            ds.num_total_features = int(meta["num_total_features"])
            ds.max_bin = int(meta["max_bin"])
            ds.mappers = [BinMapper.from_dict(d) for d in meta["mappers"]]
            if meta.get("groups") is not None:
                from .efb import FeatureGroups
                num_bins = np.asarray([ds.mappers[j].num_bin
                                       for j in ds.used_features], np.int32)
                ds.groups = FeatureGroups(
                    [[int(j) for j in g] for g in meta["groups"]], num_bins)
            arrays = []
            for _ in range(5):
                code = fh.read(1)
                arrays.append(None if code == b"N"
                              else np.load(fh, allow_pickle=False))
        ds.binned, label, weights, qb, init = arrays
        ds.metadata = Metadata(0 if ds.binned is None
                               else ds.binned.shape[0])
        if label is not None:
            ds.metadata.set_label(label)
        if weights is not None:
            ds.metadata.set_weights(weights)
        if qb is not None:
            ds.metadata.query_boundaries = qb
            ds.metadata._update_query_weights()
        if init is not None:
            ds.metadata.set_init_score(init)
        return ds
