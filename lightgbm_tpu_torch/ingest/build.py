"""The two-pass build: a chunk source -> Dataset (the port's copy of
`lightgbm_tpu/ingest/build.py` `build_inner`, host landing only).

Pass 1 (`sketch.sketch_pass`) freezes the bin mappers from the row
samples; pass 2 re-streams the row chunks, bins each against the frozen
bounds, bundles it (EFB) and writes it into a preallocated host matrix.
Every decision that shapes the result (row samples, bounds, bundle
layout, per-row bins) is made by the same functions on the same rows
as in the JAX package, so both build the same matrix, and a file
streamed at any chunk size gives the matrix of the same rows held in
memory.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

from .. import log
from .sketch import bin_sample_columns, sketch_pass
from .sources import ArraySource, ChunkSource

#: parallel per-feature binning inside a chunk above these sizes
_POOL_MIN_FEATURES = 4
_POOL_MIN_ROWS = 100_000


def build_inner(source: ChunkSource, *,
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
    """Build a `dataset.Dataset` by streaming `source` twice
    (lightgbm_tpu/ingest/build.py:33). A source with a label column
    gives the labels unless `label` is passed.

    `reference`: reuse a training set's mappers and groups (a validation
    set). `mappers`: preset BinMappers. `keep_raw`: also keep the f32
    values of the used features (`Dataset.raw`, linear trees)."""
    from ..dataset import Dataset, Metadata
    from ..efb import find_groups_sampled

    f, n = source.num_cols(), source.num_rows()
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
            source, max_bin=max_bin, min_data_in_bin=min_data_in_bin,
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
    labels_out = None if label is not None or not source.has_labels \
        else np.zeros(n, np.float64)
    # an ArraySource holds the matrix already: its raw values are a view
    collect_raw = keep_raw and not isinstance(source, ArraySource)
    raw_blocks: List[np.ndarray] = []

    pool = None
    if len(used) > _POOL_MIN_FEATURES and n > _POOL_MIN_ROWS:
        from concurrent.futures import ThreadPoolExecutor
        pool = ThreadPoolExecutor(max_workers=8)
    try:
        lo = 0
        for chunk, chunk_labels in source.chunks():
            m = len(chunk)
            if used:
                def _bin_col(j, chunk=chunk):
                    return ds.mappers[j].values_to_bins(chunk[:, j])
                cols = (list(pool.map(_bin_col, used)) if pool is not None
                        else [_bin_col(j) for j in used])
                binned[lo:lo + m] = groups.bundle_rows(cols, default_bins)
            if labels_out is not None and chunk_labels is not None:
                labels_out[lo:lo + m] = chunk_labels
            if collect_raw:
                raw_blocks.append(np.asarray(chunk[:, used], np.float32))
            lo += m
        if lo != n:
            log.fatal("Source reported %d rows but streamed %d" % (n, lo))
    finally:
        if pool is not None:
            pool.shutdown()
    ds.binned = binned
    if keep_raw:
        ds.raw = np.ascontiguousarray(source.data[:, used], np.float32) \
            if isinstance(source, ArraySource) else (
                np.concatenate(raw_blocks, axis=0) if raw_blocks
                else np.zeros((n, len(used)), np.float32))

    # ----------------------------------------------------------- metadata
    ds.metadata = Metadata(n)
    if label is None and labels_out is not None:
        label = labels_out
    if label is not None:
        ds.metadata.set_label(label)
    if weight is not None:
        ds.metadata.set_weights(weight)
    if init_score is not None:
        ds.metadata.set_init_score(init_score)
    if group is not None:
        ds.metadata.set_group(group)
    return ds
