"""Two-pass chunked dataset construction: the port's copy of the host
half of `lightgbm_tpu/ingest` that `Dataset.from_numpy` runs.

- `sketch`: pass 1, stream the matrix's row chunks, gather the
  bin-finding and EFB row samples and freeze the bin mappers;
- `build`: pass 2, bin each chunk, bundle it (EFB) and write it into
  the preallocated host matrix.

The JAX package's chunk sources (files, the binary cache) and landings
(device shards) wait for a later slice of the port, with a second
source or landing to abstract over.
"""
from .build import build_inner
from .sketch import (DEFAULT_CHUNK_ROWS, SketchResult, bin_sample_columns,
                     sketch_pass)

__all__ = ["DEFAULT_CHUNK_ROWS", "SketchResult", "bin_sample_columns",
           "build_inner", "sketch_pass"]
