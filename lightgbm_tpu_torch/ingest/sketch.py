"""Pass 1: stream a source's row chunks once, gather the two row
samples, sketch bins (the port's copy of `lightgbm_tpu/ingest/sketch.py`).

The rows gathered are exactly `binning.sample_row_indices` (bin
finding) and `efb.efb_sample_indices` (EFB exclusivity), both
deterministic in (n, seed), so the bounds and the bundle layout equal
the JAX package's bit for bit.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

from .. import log
from ..binning import BinMapper, mappers_from_sample, sample_row_indices
from ..efb import EFB_SAMPLE_CNT, efb_sample_indices
from .sources import ChunkSource


class _RowGatherer:
    """Collect the rows of a sorted global-index set from a chunk stream."""

    def __init__(self, indices: Optional[np.ndarray]):
        self.indices = indices  # None = gather every row
        self._cursor = 0
        self.blocks: List[np.ndarray] = []

    def feed(self, global_lo: int, chunk: np.ndarray) -> None:
        if self.indices is None:
            self.blocks.append(np.array(chunk, np.float64))
            return
        hi = global_lo + len(chunk)
        c = self._cursor
        e = c + np.searchsorted(self.indices[c:], hi, side="left")
        if e > c:
            local = self.indices[c:e] - global_lo
            self.blocks.append(np.array(chunk[local], np.float64))
            self._cursor = e

    def rows(self, num_cols: int) -> np.ndarray:
        if not self.blocks:
            return np.zeros((0, num_cols), np.float64)
        return np.concatenate(self.blocks, axis=0)


class SketchResult:
    """What pass 2 needs: frozen mappers and the raw EFB sample rows."""

    def __init__(self, mappers: List[BinMapper], efb_rows: np.ndarray):
        self.mappers = mappers
        self.efb_rows = efb_rows  # [s, num_cols] raw sampled rows


def sketch_pass(source: ChunkSource, *, max_bin: int,
                min_data_in_bin: int = 3, min_split_data: int = 0,
                bin_construct_sample_cnt: int = 200000, seed: int = 1,
                categorical_features: Optional[Sequence[int]] = None,
                use_missing: bool = True, zero_as_missing: bool = False,
                efb_sample_cnt: int = EFB_SAMPLE_CNT,
                mappers: Optional[List[BinMapper]] = None) -> SketchResult:
    """Stream the source once (lightgbm_tpu/ingest/sketch.py:68); return
    frozen BinMappers and the EFB sample. With `mappers` preset only the
    EFB rows are gathered."""
    n, f = source.num_rows(), source.num_cols()
    bin_gather = None if mappers is not None else _RowGatherer(
        sample_row_indices(n, bin_construct_sample_cnt, seed))
    efb_gather = _RowGatherer(efb_sample_indices(n, efb_sample_cnt, seed))

    lo = 0
    for chunk, _labels in source.chunks():
        if chunk.shape[1] != f:
            log.fatal("Chunk at row %d has %d columns, expected %d"
                      % (lo, chunk.shape[1], f))
        if bin_gather is not None:
            bin_gather.feed(lo, chunk)
        efb_gather.feed(lo, chunk)
        lo += len(chunk)
    if lo != n:
        log.fatal("Source reported %d rows but streamed %d" % (n, lo))
    if mappers is None:
        sample = bin_gather.rows(f)
        total = n if bin_gather.indices is None \
            else int(len(bin_gather.indices))
        mappers = mappers_from_sample(
            sample, total, max_bin, min_data_in_bin, min_split_data,
            categorical_features, use_missing, zero_as_missing)
        del sample
    return SketchResult(mappers, efb_gather.rows(f))


def bin_sample_columns(sketch: SketchResult,
                       used: Sequence[int]) -> List[np.ndarray]:
    """Bin the gathered EFB sample rows for the used features (the
    columns `efb.find_groups_sampled` consumes)."""
    return [sketch.mappers[j].values_to_bins(sketch.efb_rows[:, j])
            for j in used]
