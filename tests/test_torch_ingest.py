"""Data files and the binary dataset cache in the port, on the CPU.

The port's counterparts of tests/test_ingest.py's file and cache tests:
a file streamed in chunks equals the file loaded whole (matrix, labels,
model text); chunk sources agree; a cache round trip trains the same
model; loading a cache runs neither pass of the build; a mismatched
fingerprint is refused; a corrupted cache is caught and quarantined; a
v1 file still loads.

Across the two packages: `Dataset(path)` gives the JAX package's binned
matrix (uint16 on a Bosch-like file) and trees; a cache the JAX package
wrote loads in the port and trains the JAX package's trees; a cache the
port wrote loads in the JAX package's `load_cache`; and both packages
write byte-identical files for the same Dataset and fingerprint.
"""
import json
import os
import struct

import numpy as np
import pytest
import torch

import lightgbm_tpu as jlgb
import lightgbm_tpu_torch as tlgb
from lightgbm_tpu.basic import Dataset as JaxPyDataset
from lightgbm_tpu.dataset import Dataset as JaxInner
from lightgbm_tpu.ingest import load_cache as jax_load_cache
from lightgbm_tpu_torch.dataset import _BINARY_MAGIC
from lightgbm_tpu_torch.dataset import Dataset as TorchInner
from lightgbm_tpu_torch.ingest import (ArraySource, CacheCorrupt,
                                       CacheMismatch, ChunksSource,
                                       FileSource, build_inner,
                                       ingest_fingerprint, load_cache)
from lightgbm_tpu_torch.ingest import build as tbuild

torch.set_num_threads(1)
PARAMS = {"objective": "binary", "num_leaves": 15, "verbose": -1}


def write_tsv(path, x, y):
    np.savetxt(path, np.column_stack([y, x]), delimiter="\t", fmt="%.8g")
    return str(path)


def sparse_rows(n, seed):
    """A Bosch-like file's rows: 3 one-hot blocks of 10 (EFB bundles each
    into a group of more than 256 bins at max_bin 63) and 5 sparse
    numerics."""
    rng = np.random.RandomState(seed)
    x = np.zeros((n, 35))
    for b in range(3):
        x[np.arange(n), b * 10 + rng.randint(0, 10, n)] = rng.rand(n) + 0.1
    rest = rng.randn(n, 5)
    rest[rng.rand(n, 5) < 0.8] = 0.0
    x[:, 30:] = rest
    y = (x[:, 0] * 2 - x[:, 10] + x[:, 30] + 0.3 * rng.randn(n) > 0.2)
    return x, y.astype(float)


def model_text(params, ds, rounds=5):
    return tlgb.train(dict(params), ds, rounds,
                      device="cpu").model_to_string()


def test_file_stream_matches_in_memory(tmp_path):
    rng = np.random.RandomState(3)
    n, f = 3000, 5
    x = rng.randn(n, f)
    x[rng.rand(n, f) < 0.2] = 0.0
    y = (x[:, 0] * 2 + x[:, 1] + 0.1 * rng.randn(n) > 0).astype(float)
    path = write_tsv(tmp_path / "d.tsv", x, y)
    streamed = tlgb.Dataset(path, params={"tpu_ingest_chunk_rows": 257})
    whole = tlgb.Dataset(path, params={"tpu_ingest": False})
    np.testing.assert_array_equal(streamed._lazy_init().binned,
                                  whole._lazy_init().binned)
    np.testing.assert_array_equal(streamed._lazy_init().metadata.label,
                                  whole._lazy_init().metadata.label)
    assert model_text(PARAMS, streamed) == model_text(PARAMS, whole)
    # the rows themselves, held in memory, give the same matrix
    parsed = np.loadtxt(path)
    arr = tlgb.Dataset(parsed[:, 1:], parsed[:, 0])
    np.testing.assert_array_equal(arr._lazy_init().binned,
                                  streamed._lazy_init().binned)


def test_header_and_csv_files_stream(tmp_path):
    x, y = sparse_rows(700, 1)
    path = str(tmp_path / "h.csv")
    np.savetxt(path, np.column_stack([y, x]), delimiter=",", fmt="%.8g",
               header=",".join(["label"] + ["f%d" % i for i in range(35)]),
               comments="")
    ds = tlgb.Dataset(path, params={"has_header": True,
                                    "tpu_ingest_chunk_rows": 128})
    inner = ds._lazy_init()
    assert inner.num_data == 700 and inner.num_total_features == 35
    np.testing.assert_array_equal(inner.metadata.label, y.astype(np.float32))


def test_chunk_source_and_array_source_agree():
    x = np.random.RandomState(5).randn(1500, 4)
    a = build_inner(ArraySource(x, chunk_rows=333), max_bin=63)
    b = build_inner(ChunksSource([x[:400], x[400:401], x[401:]]),
                    max_bin=63)
    np.testing.assert_array_equal(a.binned, b.binned)


def test_libsvm_file_loads_whole(tmp_path):
    path = str(tmp_path / "d.svm")
    with open(path, "w") as fh:
        for i in range(300):
            fh.write("%d 1:%g 3:%g\n" % (i % 2, i * 0.1, (i % 7) * 1.5))
    with pytest.raises(ValueError):
        FileSource(path)
    inner = tlgb.Dataset(path)._lazy_init()
    assert inner.num_data == 300 and inner.metadata.label[1] == 1.0


def test_cache_round_trip_trains_identically(tmp_path):
    rng = np.random.RandomState(2)
    x = rng.randn(2500, 6)
    y = (x[:, 0] > 0).astype(float)
    ds = tlgb.Dataset(x, label=y)
    ref = model_text(PARAMS, ds)
    path = str(tmp_path / "c.bin")
    ds._inner.save_binary(path, fingerprint="fp-test")
    loaded = TorchInner.load_binary(path, expected_fingerprint="fp-test")
    assert isinstance(loaded.binned, np.memmap)
    np.testing.assert_array_equal(np.asarray(loaded.binned), ds._inner.binned)
    assert model_text(PARAMS, tlgb.Dataset._from_inner(loaded)) == ref


def test_cache_load_skips_both_passes(tmp_path, monkeypatch):
    x = np.random.RandomState(4).randn(1200, 4)
    inner = TorchInner.from_numpy(x, (x[:, 0] > 0).astype(float))
    path = str(tmp_path / "c2.bin")
    inner.save_binary(path)

    def refuse(*args, **kwargs):
        raise AssertionError("a pass of the build ran")
    monkeypatch.setattr(tbuild, "sketch_pass", refuse)
    monkeypatch.setattr(ArraySource, "chunks", refuse)
    loaded = TorchInner.load_binary(path)
    np.testing.assert_array_equal(np.asarray(loaded.binned), inner.binned)
    with pytest.raises(AssertionError, match="a pass"):
        TorchInner.from_numpy(x)


def test_cache_refuses_a_mismatched_fingerprint(tmp_path):
    inner = TorchInner.from_numpy(np.random.RandomState(6).randn(500, 3))
    path = str(tmp_path / "c3.bin")
    inner.save_binary(path, fingerprint="the-real-build")
    with pytest.raises(CacheMismatch):
        TorchInner.load_binary(path, expected_fingerprint="something-else")
    TorchInner.load_binary(path)  # no expectation: loads, CRCs checked


def test_cache_corruption_is_caught_and_quarantined(tmp_path):
    inner = TorchInner.from_numpy(np.random.RandomState(8).randn(800, 3))
    path = str(tmp_path / "c4.bin")
    inner.save_binary(path)
    with open(path, "r+b") as fh:
        fh.seek(-16, os.SEEK_END)
        fh.write(b"\xff" * 8)
    with pytest.raises(CacheCorrupt, match="checksum"):
        TorchInner.load_binary(path)
    assert not os.path.exists(path) and os.path.exists(path + ".corrupt")
    # a garbled header is quarantined too, and older quarantined files
    # pruned to the newest
    inner.save_binary(path)
    with open(path, "r+b") as fh:
        fh.seek(len(b"lightgbm_tpu.dsetcache.v2\n") + 8)
        fh.write(b"\x00\xff\x00")
    with pytest.raises(CacheCorrupt, match="garbled header"):
        load_cache(path)
    assert sorted(os.listdir(tmp_path)) == ["c4.bin.corrupt"]


def test_cache_v1_artifacts_still_load(tmp_path):
    x = np.random.RandomState(9).randn(700, 4)
    inner = TorchInner.from_numpy(x, (x[:, 0] > 0).astype(float))
    path = str(tmp_path / "v1.bin")
    meta = {"feature_names": inner.feature_names,
            "used_features": inner.used_features,
            "num_total_features": inner.num_total_features,
            "max_bin": inner.max_bin,
            "mappers": [m.to_dict() for m in inner.mappers],
            "groups": [[int(j) for j in g] for g in inner.groups.groups]}
    blob = json.dumps(meta).encode()
    with open(path, "wb") as fh:
        fh.write(_BINARY_MAGIC)
        fh.write(struct.pack("<q", len(blob)))
        fh.write(blob)
        for arr, code in [(inner.binned, b"B"), (inner.metadata.label, b"L"),
                          (None, b"W"), (None, b"Q"), (None, b"I")]:
            if arr is None:
                fh.write(b"N")
                continue
            fh.write(code)
            np.save(fh, np.asarray(arr), allow_pickle=False)
    loaded = TorchInner.load_binary(path)
    np.testing.assert_array_equal(loaded.binned, inner.binned)
    np.testing.assert_array_equal(loaded.metadata.label,
                                  inner.metadata.label)


# ---------------------------------------------------------------------------
# across the two packages
# ---------------------------------------------------------------------------

def assert_same_models(jb, tb, xv):
    jt, tt = jb._inner.models, tb._inner.models
    assert len(jt) == len(tt) > 0
    for i, (a, b) in enumerate(zip(jt, tt)):
        m = a.num_leaves - 1
        assert a.num_leaves == b.num_leaves, i
        for k in ("split_feature", "threshold_in_bin", "left_child",
                  "right_child"):
            assert np.array_equal(getattr(a, k)[:m], getattr(b, k)[:m]), \
                (i, k)
    ref = jb.predict(xv, raw_score=True)
    got = tb.predict(xv, raw_score=True)
    assert np.all(np.abs(got - ref) <= 1e-5 * np.maximum(1.0, np.abs(ref)))


@pytest.mark.parametrize("stream", [True, False], ids=["streamed", "whole"])
def test_file_dataset_equals_the_jax_one(tmp_path, stream):
    x, y = sparse_rows(2000, 0)
    path = write_tsv(tmp_path / "bosch.tsv", x, y)
    params = dict(PARAMS, max_bin=63, tpu_ingest=stream,
                  tpu_ingest_chunk_rows=300)
    jd = jlgb.Dataset(path, params=dict(params))
    td = tlgb.Dataset(path, params=dict(params))
    jb = jlgb.train(dict(params), jd, 3)
    tb = tlgb.train(dict(params), td, 3, device="cpu")
    assert td._inner.binned.dtype == np.uint16
    np.testing.assert_array_equal(td._inner.binned, jd._inner.binned)
    np.testing.assert_array_equal(td._inner.metadata.label,
                                  jd._inner.metadata.label)
    assert_same_models(jb, tb, sparse_rows(300, 1)[0])


def test_a_jax_cache_loads_in_the_port_and_trains_the_jax_trees(tmp_path):
    x, y = sparse_rows(1500, 2)
    jd = JaxInner.from_numpy(x, y, max_bin=63)
    path = str(tmp_path / "jax.bin")
    fp = ingest_fingerprint({"kind": "test"}, {"max_bin": 63})
    jd.save_binary(path, fingerprint=fp)
    loaded = TorchInner.load_binary(path, expected_fingerprint=fp)
    np.testing.assert_array_equal(np.asarray(loaded.binned), jd.binned)
    jb = jlgb.train(dict(PARAMS), JaxPyDataset._from_inner(jd), 3)
    tb = tlgb.train(dict(PARAMS), tlgb.Dataset._from_inner(loaded), 3,
                    device="cpu")
    assert_same_models(jb, tb, sparse_rows(300, 3)[0])


def test_a_port_cache_loads_in_the_jax_package(tmp_path):
    x, y = sparse_rows(1500, 4)
    td = TorchInner.from_numpy(x, y, max_bin=63, weight=np.linspace(
        0.5, 1.5, 1500), init_score=np.full(1500, 0.25))
    path = str(tmp_path / "port.bin")
    td.save_binary(path, fingerprint="fp")
    jd = jax_load_cache(path, expected_fingerprint="fp")
    np.testing.assert_array_equal(np.asarray(jd.binned), td.binned)
    for k in ("label", "weights", "init_score"):
        np.testing.assert_array_equal(getattr(jd.metadata, k),
                                      getattr(td.metadata, k))
    assert jd.groups.groups == td.groups.groups


def test_both_packages_write_byte_identical_caches(tmp_path):
    x, y = sparse_rows(1200, 5)
    group = [300, 500, 400]
    jd = JaxInner.from_numpy(x, y, max_bin=63, group=group)
    td = TorchInner.from_numpy(x, y, max_bin=63, group=group)
    fp = ingest_fingerprint({"kind": "file", "rows": 1200}, {"max_bin": 63})
    jd.save_binary(str(tmp_path / "j.bin"), fingerprint=fp)
    td.save_binary(str(tmp_path / "t.bin"), fingerprint=fp)
    a = (tmp_path / "j.bin").read_bytes()
    b = (tmp_path / "t.bin").read_bytes()
    assert len(a) > 1200 * 5 and a == b
