"""Data-file parsing: CSV / TSV / LibSVM with format auto-detection.

The port's copy of the Python path of `lightgbm_tpu/io/parser.py`
(:20-171; reference `src/io/parser.cpp:1-258`): the format is detected
from the first lines (tab/comma separated vs `idx:value` pairs), the
label is column 0 by default, and LibSVM sparse rows are densified. The
JAX package's native parser (`native/parser_native.so`) is a host-side
speed-up that falls back to this same code; the port does not carry it.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from .. import log


def detect_format(path: str, has_header: bool = False) -> str:
    """Reference: Parser::CreateParser autodetect (parser.cpp:200-258)."""
    with open(path) as fh:
        lines = []
        for _ in range(32):
            line = fh.readline()
            if not line:
                break
            if line.strip():
                lines.append(line.strip())
    if has_header and lines:
        lines = lines[1:]
    if not lines:
        log.fatal("Data file %s is empty" % path)
    sample = lines[0]
    tokens = sample.replace("\t", " ").replace(",", " ").split()
    colon = sum(1 for t in tokens if ":" in t)
    if colon >= max(1, len(tokens) - 1):
        return "libsvm"
    if "\t" in sample:
        return "tsv"
    if "," in sample:
        return "csv"
    return "tsv"  # whitespace separated


def load_data_file(path: str, has_header: bool = False,
                   label_column: int = 0
                   ) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """Load a data file into (features, label), f64 (the parsing stage of
    DatasetLoader::LoadFromFile, dataset_loader.cpp:159-217)."""
    fmt = detect_format(path, has_header)
    if fmt == "libsvm":
        return _load_libsvm(path)
    delim = "," if fmt == "csv" else None
    rows: List[List[float]] = []
    labels: List[float] = []
    with open(path) as fh:
        if has_header:
            fh.readline()
        for line in fh:
            line = line.strip()
            if not line:
                continue
            parts = line.split(delim) if delim else line.split()
            vals = [_parse_float(p) for p in parts]
            labels.append(vals[label_column])
            rows.append(vals[:label_column] + vals[label_column + 1:])
    data = np.asarray(rows, np.float64)
    return data, np.asarray(labels, np.float64)


def _parse_float(tok: str) -> float:
    tok = tok.strip()
    if not tok or tok.lower() in ("na", "nan", "null", "none", "?"):
        return float("nan")
    try:
        return float(tok)
    except ValueError:
        return float("nan")


def _load_libsvm(path: str) -> Tuple[np.ndarray, np.ndarray]:
    labels: List[float] = []
    rows: List[List[Tuple[int, float]]] = []
    max_idx = -1
    with open(path) as fh:
        for line in fh:
            line = line.split("#", 1)[0].strip()
            if not line:
                continue
            parts = line.split()
            labels.append(_parse_float(parts[0]))
            row = []
            for tok in parts[1:]:
                if ":" not in tok:
                    continue
                idx_s, val_s = tok.split(":", 1)
                # qid tokens are query markers, not features
                if idx_s == "qid":
                    continue
                idx = int(idx_s)
                row.append((idx, _parse_float(val_s)))
                max_idx = max(max_idx, idx)
            rows.append(row)
    n = len(rows)
    data = np.zeros((n, max_idx + 1), np.float64)
    for i, row in enumerate(rows):
        for idx, val in row:
            data[i, idx] = val
    return data, np.asarray(labels, np.float64)
