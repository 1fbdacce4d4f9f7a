"""The binary dataset cache: versioned, checksummed, memory-mapped (the
port's copy of `lightgbm_tpu/ingest/cache.py`, in the same file format,
so either package loads the other's files):

    magic  b"lightgbm_tpu.dsetcache.v2\\n"
    <q     header length
    JSON   header, keys sorted: format version, fingerprint (source and
           binning params), the dataset's schema (bin bounds, EFB
           bundles, feature names), and one descriptor per array {name,
           dtype, shape, offset, nbytes, crc32}
    ...    the arrays' little-endian C-order bytes, 64-byte aligned

Loading parses the header, checks every CRC and maps the binned matrix
read-only, so a run that loads a cache skips both passes of the build.
A caller that knows what it is about to build passes the expected
fingerprint, and a cache built from another source or with other
binning params is refused (`CacheMismatch`). A file that fails its
checks is quarantined (renamed `*.corrupt`) and `CacheCorrupt` raised,
so the next run rebuilds from source. Writes are atomic (tmp + fsync +
rename, `durable.atomic_write_via`).
"""
from __future__ import annotations

import hashlib
import json
import os
import struct
import zlib
from typing import Any, Dict, Optional

import numpy as np

from .. import durable, log

MAGIC = b"lightgbm_tpu.dsetcache.v2\n"
FORMAT_VERSION = 2
_ALIGN = 64

#: the arrays stored, in file order
_ARRAY_FIELDS = ("binned", "label", "weights", "query_boundaries",
                 "init_score")


class CacheMismatch(log.LightGBMError):
    """The cache's fingerprint is not the one the caller was about to
    build."""


class CacheCorrupt(log.LightGBMError):
    """The cache failed a check (checksum, truncation, garbled header);
    it has been quarantined by the time this is raised."""


def ingest_fingerprint(source_desc: Optional[Dict[str, Any]],
                       params: Dict[str, Any]) -> str:
    """Hex SHA-256 of (source identity, binning params), the things that
    decide a binned dataset's content (lightgbm_tpu/ingest/cache.py:59)."""
    payload = {"source": source_desc or {},
               "params": {str(k): params[k] for k in sorted(params)}}
    blob = json.dumps(payload, sort_keys=True, default=str).encode()
    return hashlib.sha256(blob).hexdigest()


def _crc(arr: np.ndarray) -> int:
    """CRC32 of an array's bytes, without a copy of a contiguous one."""
    return zlib.crc32(memoryview(np.ascontiguousarray(arr)).cast("B")) \
        & 0xFFFFFFFF


def save_cache(inner, path: str, fingerprint: str = "") -> None:
    """Write a `dataset.Dataset` as a v2 cache file, atomically
    (lightgbm_tpu/ingest/cache.py:100)."""
    if inner.binned is None:
        raise log.LightGBMError("Cannot save a binary dataset cache: the "
                                "dataset has no binned matrix")
    meta = {
        "feature_names": list(inner.feature_names),
        "used_features": [int(j) for j in inner.used_features],
        "num_total_features": int(inner.num_total_features),
        "max_bin": int(inner.max_bin),
        "mappers": [m.to_dict() for m in inner.mappers],
        "groups": ([[int(j) for j in g] for g in inner.groups.groups]
                   if inner.groups is not None else None),
    }
    arrays = {"binned": inner.binned, "label": inner.metadata.label,
              "weights": inner.metadata.weights,
              "query_boundaries": inner.metadata.query_boundaries,
              "init_score": inner.metadata.init_score}
    descs, payloads = [], []
    for name in _ARRAY_FIELDS:
        arr = arrays[name]
        if arr is None:
            continue
        a = np.ascontiguousarray(arr)
        payloads.append(a)
        descs.append({"name": name, "dtype": a.dtype.str,
                      "shape": list(a.shape), "offset": 0,
                      "nbytes": int(a.nbytes), "crc32": _crc(a)})

    def render(ds):
        header = {"format": FORMAT_VERSION, "fingerprint": fingerprint,
                  "meta": meta, "arrays": ds}
        return json.dumps(header, sort_keys=True).encode()

    # the header's length depends on the offsets and they on it: measure
    # with placeholder offsets, then pad to a fixed length
    hlen = len(render(descs)) + 256
    base = len(MAGIC) + 8 + hlen
    off = ((base + _ALIGN - 1) // _ALIGN) * _ALIGN
    for d, a in zip(descs, payloads):
        d["offset"] = off
        off = ((off + a.nbytes + _ALIGN - 1) // _ALIGN) * _ALIGN
    blob = render(descs)
    if len(blob) > hlen:
        log.fatal("cache header overflow")
    blob = blob + b" " * (hlen - len(blob))

    def _body(fh):
        fh.write(MAGIC)
        fh.write(struct.pack("<q", hlen))
        fh.write(blob)
        for d, a in zip(descs, payloads):
            fh.seek(d["offset"])
            fh.write(memoryview(a).cast("B"))

    durable.atomic_write_via(path, _body)
    log.info("Saved binary dataset cache to %s (%d arrays, fingerprint "
             "%s)", path, len(descs), fingerprint[:12] or "<none>")


def _quarantine_and_raise(path: str, what: str) -> None:
    durable.quarantine(path, reason=what)
    raise CacheCorrupt(
        "Dataset cache %s %s; the file was quarantined as %s.corrupt: "
        "re-bin from the source data" % (path, what, path))


def load_cache(path: str, expected_fingerprint: Optional[str] = None):
    """A v2 cache file as a `dataset.Dataset` (lightgbm_tpu/ingest/
    cache.py:186). `expected_fingerprint` refuses (CacheMismatch) a cache
    built from another source or with other binning params. The binned
    matrix is mapped read-only, the other arrays read. A failed check quarantines the file and raises CacheCorrupt."""
    from ..binning import BinMapper
    from ..dataset import Dataset, Metadata
    from ..efb import FeatureGroups

    with open(path, "rb") as fh:
        if fh.read(len(MAGIC)) != MAGIC:
            raise log.LightGBMError(
                "%s is not a lightgbm_tpu v2 dataset cache" % path)
        try:
            (hlen,) = struct.unpack("<q", fh.read(8))
            if hlen <= 0 or hlen > os.path.getsize(path):
                raise ValueError("implausible header length %d" % hlen)
            header = json.loads(fh.read(hlen).decode())
        except (struct.error, ValueError, UnicodeDecodeError) as exc:
            _quarantine_and_raise(path, "has a garbled header (%s)" % exc)
    if int(header.get("format", 0)) > FORMAT_VERSION:
        raise log.LightGBMError(
            "Dataset cache %s has format %s; this build supports <= %d"
            % (path, header.get("format"), FORMAT_VERSION))
    fp = header.get("fingerprint", "")
    if expected_fingerprint is not None and not fp:
        log.warning("Dataset cache %s carries no fingerprint; cannot verify "
                    "it matches the data file and binning parameters of "
                    "this run", path)
    if expected_fingerprint is not None and fp \
            and fp != expected_fingerprint:
        raise CacheMismatch(
            "Dataset cache %s was built from a different source or with "
            "different binning parameters (cache fingerprint %s..., "
            "expected %s...). Delete the cache to re-bin."
            % (path, fp[:12], expected_fingerprint[:12]))

    meta = header["meta"]
    ds = Dataset()
    ds.feature_names = list(meta["feature_names"])
    ds.used_features = [int(x) for x in meta["used_features"]]
    ds.num_total_features = int(meta["num_total_features"])
    ds.max_bin = int(meta["max_bin"])
    ds.mappers = [BinMapper.from_dict(d) for d in meta["mappers"]]
    if meta.get("groups") is not None:
        num_bins = np.asarray(
            [ds.mappers[j].num_bin for j in ds.used_features], np.int32)
        ds.groups = FeatureGroups(
            [[int(j) for j in g] for g in meta["groups"]], num_bins)

    arrays: Dict[str, np.ndarray] = {}
    with open(path, "rb") as fh:
        for d in header["arrays"]:
            name = d["name"]
            shape = tuple(int(s) for s in d["shape"])
            dtype = np.dtype(d["dtype"])
            if name == "binned":
                try:
                    arr = np.memmap(path, dtype=dtype, mode="r",
                                    offset=int(d["offset"]), shape=shape)
                except ValueError as exc:  # the file is shorter
                    _quarantine_and_raise(path, "is truncated (array %s: "
                                          "%s)" % (name, exc))
                crc = _crc(arr)
            else:
                fh.seek(int(d["offset"]))
                raw = fh.read(int(d["nbytes"]))
                if len(raw) != int(d["nbytes"]):
                    _quarantine_and_raise(path, "is truncated (array %s)"
                                          % name)
                crc = zlib.crc32(raw) & 0xFFFFFFFF
                arr = np.frombuffer(raw, dtype=dtype).reshape(shape)
            if crc != int(d["crc32"]):
                arr = None  # unmap before the rename
                _quarantine_and_raise(path, "failed its checksum (array "
                                      "%s)" % name)
            arrays[name] = arr

    ds.binned = arrays.get("binned")
    n = 0 if ds.binned is None else ds.binned.shape[0]
    ds.metadata = Metadata(n)
    if arrays.get("label") is not None:
        ds.metadata.set_label(arrays["label"])
    if arrays.get("weights") is not None:
        ds.metadata.set_weights(arrays["weights"])
    if arrays.get("query_boundaries") is not None:
        ds.metadata.query_boundaries = np.asarray(
            arrays["query_boundaries"], np.int64)
        ds.metadata._update_query_weights()
    if arrays.get("init_score") is not None:
        ds.metadata.set_init_score(arrays["init_score"])
    log.info("Loaded binary dataset cache %s (%d rows; pass 1+2 skipped)",
             path, n)
    return ds
