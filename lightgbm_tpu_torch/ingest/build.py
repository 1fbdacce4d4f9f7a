"""The two-pass build: an in-memory matrix -> Dataset (the port's copy
of `lightgbm_tpu/ingest/build.py` `build_inner`, in-memory source and
host landing only).

Pass 1 (`sketch.sketch_pass`) freezes the bin mappers from the row
samples; pass 2 re-streams the row chunks, bins each against the frozen
bounds, bundles it (EFB) and writes it into a preallocated host matrix.
Every decision that shapes the result (row samples, bounds, bundle
layout, per-row bins) is made by the same functions on the same rows
as in the JAX package, so both build the same matrix.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

from .. import log
from .sketch import (DEFAULT_CHUNK_ROWS, bin_sample_columns, row_chunks,
                     sketch_pass)

#: parallel per-feature binning inside a chunk above these sizes
_POOL_MIN_FEATURES = 4
_POOL_MIN_ROWS = 100_000


def build_inner(data: np.ndarray, *,
                chunk_rows: int = DEFAULT_CHUNK_ROWS,
                max_bin: int = 255, min_data_in_bin: int = 3,
                min_split_data: int = 0,
                bin_construct_sample_cnt: int = 200000,
                data_random_seed: int = 1,
                categorical_features: Optional[Sequence[int]] = None,
                use_missing: bool = True, zero_as_missing: bool = False,
                feature_names: Optional[Sequence[str]] = None,
                label=None, weight=None, group=None, init_score=None,
                reference=None, mappers=None,
                enable_bundle: bool = True,
                max_conflict_rate: float = 0.0,
                sparse_threshold: float = 0.8, keep_raw: bool = False):
    """Build a `dataset.Dataset` by streaming the `[n, f]` matrix twice
    in chunks of `chunk_rows` rows.

    `reference`: reuse a training set's mappers and groups (a validation
    set). `mappers`: preset BinMappers. `keep_raw`: also keep the f32
    values of the used features (`Dataset.raw`, linear trees)."""
    from ..dataset import Dataset, Metadata
    from ..efb import find_groups_sampled

    data = np.asarray(data)
    if data.ndim != 2:
        log.fatal("build_inner needs a 2-dimensional matrix")
    # float64 once (copy only if the dtype differs), chunk views after
    data = data.astype(np.float64, copy=False)
    n, f = data.shape
    ds = Dataset()
    ds.num_total_features = f
    ds.max_bin = max_bin if reference is None else reference.max_bin
    ds.feature_names = list(feature_names) if feature_names is not None \
        else [f"Column_{i}" for i in range(f)]

    # ------------------------------------------------------------- pass 1
    if reference is not None:
        if f != reference.num_total_features:
            log.fatal("Validation data feature count (%d) != train (%d)"
                      % (f, reference.num_total_features))
        ds.mappers = reference.mappers
        ds.used_features = reference.used_features
        ds.groups = reference.groups
        sketch = None
    else:
        sketch = sketch_pass(
            data, max_bin=max_bin, chunk_rows=chunk_rows,
            min_data_in_bin=min_data_in_bin,
            min_split_data=min_split_data,
            bin_construct_sample_cnt=bin_construct_sample_cnt,
            seed=data_random_seed,
            categorical_features=categorical_features,
            use_missing=use_missing, zero_as_missing=zero_as_missing,
            mappers=list(mappers) if mappers is not None else None)
        ds.mappers = sketch.mappers
        ds.used_features = [j for j, m in enumerate(ds.mappers)
                            if not m.is_trivial]
        if not ds.used_features and mappers is None:
            log.warning("All features are trivial (constant); "
                        "model will predict a constant")

    used = ds.used_features
    num_bins = np.asarray([ds.mappers[j].num_bin for j in used], np.int32)
    default_bins = np.asarray([ds.mappers[j].default_bin for j in used],
                              np.int32)

    # ------------------------------------------------ EFB bundle layout
    if ds.groups is None:
        ds.groups = find_groups_sampled(
            bin_sample_columns(sketch, used), default_bins, num_bins,
            enable_bundle=enable_bundle,
            max_conflict_rate=max_conflict_rate,
            sparse_threshold=sparse_threshold)
    if sketch is not None:
        sketch.efb_rows = None  # free the sample before landing rows

    # ------------------------------------------------------------- pass 2
    groups = ds.groups
    g_cnt = groups.num_groups
    max_group_bin = int(groups.group_num_bin.max(initial=1)) \
        if g_cnt else 1
    out_dtype = np.uint8 if max_group_bin <= 256 else np.uint16
    binned = np.zeros((n, g_cnt), out_dtype)

    pool = None
    if len(used) > _POOL_MIN_FEATURES and n > _POOL_MIN_ROWS:
        from concurrent.futures import ThreadPoolExecutor
        pool = ThreadPoolExecutor(max_workers=8)
    try:
        for lo, chunk in row_chunks(data, chunk_rows):
            if not used:
                break

            def _bin_col(j, chunk=chunk):
                return ds.mappers[j].values_to_bins(chunk[:, j])
            cols: List[np.ndarray] = (list(pool.map(_bin_col, used))
                                      if pool is not None
                                      else [_bin_col(j) for j in used])
            binned[lo:lo + len(chunk)] = groups.bundle_rows(cols,
                                                            default_bins)
    finally:
        if pool is not None:
            pool.shutdown()
    ds.binned = binned
    if keep_raw:
        ds.raw = np.ascontiguousarray(data[:, used], np.float32)

    # ----------------------------------------------------------- metadata
    ds.metadata = Metadata(n)
    if label is not None:
        ds.metadata.set_label(label)
    if weight is not None:
        ds.metadata.set_weights(weight)
    if init_score is not None:
        ds.metadata.set_init_score(init_score)
    if group is not None:
        ds.metadata.set_group(group)
    return ds
