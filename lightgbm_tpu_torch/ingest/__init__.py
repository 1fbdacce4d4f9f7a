"""Two-pass chunked dataset construction and the binary dataset cache:
the port's copy of the host half of `lightgbm_tpu/ingest`.

- `sources`: re-iterable chunk streams (`ArraySource`, `ChunksSource`,
  `FileSource` for CSV / TSV files);
- `sketch`: pass 1, stream a source's row chunks, gather the
  bin-finding and EFB row samples and freeze the bin mappers;
- `build`: pass 2, bin each chunk, bundle it (EFB) and write it into
  the preallocated host matrix;
- `cache`: the versioned, checksummed, memory-mapped binary dataset
  file, in the JAX package's format.

The JAX package's device landings (per-device row shards) are not
ported: the port trains on one card.
"""
from .build import build_inner
from .cache import (CacheCorrupt, CacheMismatch,
                    FORMAT_VERSION as CACHE_FORMAT_VERSION,
                    MAGIC as CACHE_MAGIC, ingest_fingerprint, load_cache,
                    save_cache)
from .sketch import SketchResult, bin_sample_columns, sketch_pass
from .sources import (ArraySource, ChunkSource, ChunksSource,
                      DEFAULT_CHUNK_ROWS, FileSource)

__all__ = ["ArraySource", "CACHE_FORMAT_VERSION", "CACHE_MAGIC",
           "CacheCorrupt", "CacheMismatch", "ChunkSource", "ChunksSource",
           "DEFAULT_CHUNK_ROWS", "FileSource", "SketchResult",
           "bin_sample_columns", "build_inner", "ingest_fingerprint", "load_cache", "save_cache",
           "sketch_pass"]
