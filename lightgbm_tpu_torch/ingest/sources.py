"""Chunk sources: what the two-pass build streams (the port's copy of
`lightgbm_tpu/ingest/sources.py`).

A `ChunkSource` streams `[rows, features]` float64 blocks, with an
optional per-chunk label column, as many times as asked, the same rows
in the same order each time: pass 1 (`sketch.sketch_pass`) streams it to
sketch the bin bounds and pass 2 (`build.build_inner`) again to bin the
rows, so a file is never held whole as floats.

- `ArraySource` (:65): an in-memory matrix served as row views;
- `ChunksSource` (:89): a held list of row blocks;
- `FileSource` (:153): a delimited text file (CSV / TSV, label in column
  0 by default) parsed chunk by chunk with the `io.parser` float rules.
  LibSVM rows need the whole file to size their dense matrix, so it is
  refused here and `basic.Dataset` loads it whole instead.
"""
from __future__ import annotations

import os
from typing import Iterator, List, Optional, Tuple

import numpy as np

from .. import log

DEFAULT_CHUNK_ROWS = 65536

#: (features [m, F] float64, labels [m] float64 or None)
Chunk = Tuple[np.ndarray, Optional[np.ndarray]]


class ChunkSource:
    """A re-iterable stream of row chunks (lightgbm_tpu/ingest/sources.py
    :39): `num_rows()` and `num_cols()` are known before the first full
    stream, and every `chunks()` yields the same rows in the same
    order."""

    has_labels: bool = False

    def num_rows(self) -> int:
        raise NotImplementedError

    def num_cols(self) -> int:
        raise NotImplementedError

    def chunks(self) -> Iterator[Chunk]:
        raise NotImplementedError

    def describe(self) -> dict:
        """Identity facts for the binary cache's fingerprint."""
        return {"kind": type(self).__name__,
                "rows": self.num_rows(), "cols": self.num_cols()}


class ArraySource(ChunkSource):
    """An in-memory `[n, f]` matrix as row-slice views."""

    def __init__(self, data: np.ndarray,
                 chunk_rows: int = DEFAULT_CHUNK_ROWS):
        data = np.asarray(data)
        if data.ndim != 2:
            log.fatal("ArraySource needs a 2-dimensional matrix")
        # float64 once (a copy only if the dtype differs), views after
        self.data = data.astype(np.float64, copy=False)
        self.chunk_rows = max(1, int(chunk_rows))

    def num_rows(self) -> int:
        return self.data.shape[0]

    def num_cols(self) -> int:
        return self.data.shape[1]

    def chunks(self) -> Iterator[Chunk]:
        for lo in range(0, self.data.shape[0], self.chunk_rows):
            yield self.data[lo:lo + self.chunk_rows], None


class ChunksSource(ChunkSource):
    """A held list of row blocks, in order."""

    def __init__(self, blocks: List[np.ndarray]):
        if not blocks:
            log.fatal("ChunksSource needs at least one row block")
        self.blocks = [np.asarray(b, np.float64) for b in blocks]
        cols = {b.shape[1] for b in self.blocks}
        if len(cols) != 1:
            log.fatal("ChunksSource blocks disagree on column count: %s"
                      % sorted(cols))

    def num_rows(self) -> int:
        return sum(b.shape[0] for b in self.blocks)

    def num_cols(self) -> int:
        return self.blocks[0].shape[1]

    def chunks(self) -> Iterator[Chunk]:
        for b in self.blocks:
            yield b, None


def _parse_lines(lines: List[str], delim: Optional[str]) -> np.ndarray:
    """One chunk of data lines: numpy's tokenizer, and the io.parser
    float rules line by line for a chunk it refuses (na, ?, empty
    tokens, ragged rows)."""
    try:
        return np.loadtxt(lines, delimiter=delim, comments=None,
                          dtype=np.float64, ndmin=2)
    except ValueError:
        from ..io.parser import _parse_float
        return np.asarray(
            [[_parse_float(p) for p in
              (line.split(delim) if delim else line.split())]
             for line in lines], np.float64)


def iter_raw_file_chunks(path: str, has_header: bool = False,
                         chunk_rows: int = DEFAULT_CHUNK_ROWS,
                         delim: Optional[str] = None
                         ) -> Iterator[np.ndarray]:
    """`[<= chunk_rows, cols]` float64 blocks of a delimited file, the
    label column included; blank lines are skipped."""
    with open(path) as fh:
        if has_header:
            fh.readline()
        block: List[str] = []
        for line in fh:
            line = line.strip()
            if not line:
                continue
            block.append(line)
            if len(block) >= chunk_rows:
                yield _parse_lines(block, delim)
                block = []
        if block:
            yield _parse_lines(block, delim)


class FileSource(ChunkSource):
    """A delimited data file parsed chunk by chunk, the label column split
    out of every chunk. Raises ValueError for a LibSVM file."""

    has_labels = True

    def __init__(self, path: str, chunk_rows: int = DEFAULT_CHUNK_ROWS,
                 has_header: bool = False, label_column: int = 0):
        from ..io.parser import detect_format
        self.path = path
        self.chunk_rows = max(1, int(chunk_rows))
        self.has_header = bool(has_header)
        self.label_column = int(label_column)
        fmt = detect_format(path, has_header)
        if fmt == "libsvm":
            raise ValueError("streamed ingest takes delimited files only "
                             "(libsvm rows need a global column count)")
        self._delim = "," if fmt == "csv" else None
        self._n: Optional[int] = None
        self._f: Optional[int] = None

    def _count(self) -> None:
        n = 0
        with open(self.path) as fh:
            if self.has_header:
                fh.readline()
            for line in fh:
                if line.strip():
                    n += 1
        self._n = n
        if self._f is None:
            for block, _ in self.chunks(max_chunks=1):
                self._f = block.shape[1]
            if self._f is None:
                log.fatal("Data file %s is empty" % self.path)

    def num_rows(self) -> int:
        if self._n is None:
            self._count()
        return int(self._n)

    def num_cols(self) -> int:
        if self._f is None:
            self._count()
        return int(self._f)

    def chunks(self, max_chunks: Optional[int] = None) -> Iterator[Chunk]:
        emitted = 0
        for raw in iter_raw_file_chunks(self.path, self.has_header,
                                        self.chunk_rows, self._delim):
            yield self._split(raw)
            emitted += 1
            if max_chunks is not None and emitted >= max_chunks:
                return

    def _split(self, raw: np.ndarray) -> Chunk:
        labels = raw[:, self.label_column].copy()
        feats = np.ascontiguousarray(
            np.delete(raw, self.label_column, axis=1))
        return feats, labels

    def describe(self) -> dict:
        st = os.stat(self.path)
        return {"kind": "file", "path": os.path.abspath(self.path),
                "size": int(st.st_size), "mtime_ns": int(st.st_mtime_ns),
                "has_header": self.has_header,
                "label_column": self.label_column}
