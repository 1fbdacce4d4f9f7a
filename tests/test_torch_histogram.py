"""Kernel H's plain version (lightgbm_tpu_torch/ops/histogram.py)
against the JAX package's f32 histograms.

The same seeded bins and channels go through `leaf_histogram`,
`batched_leaves_histogram` and `gathered_leaves_histogram` of
`lightgbm_tpu.ops.histogram` with `bf16=False` and through the port's
`leaf_histogram` in its two modes (all rows, a row list) on the CPU; an
id-masked JAX histogram is matched by the row list of that id's rows,
which is how the port's grower passes one leaf. Tolerances: the count
channel exactly; the g and h sums within 1e-5 * max(1, |ref|) of the
JAX sums, and within the same bound of a float64 numpy oracle (as close
as the JAX sums are). The larger
child by `subtract` must equal parent - smaller elementwise.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from lightgbm_tpu.ops import histogram as jh
from lightgbm_tpu_torch import LightGBMError
from lightgbm_tpu_torch.ops.histogram import (leaf_histogram,
                                              leaf_histogram_plain, subtract)

torch.set_num_threads(1)

N, G, B, CHUNK = 2048, 6, 16, 256


def inputs(seed, zero_weight=0.1):
    rng = np.random.RandomState(seed)
    binned = rng.randint(0, B, (N, G)).astype(np.uint8)
    binned[:, 5] = rng.randint(0, 3, N)            # a narrow group
    w = (rng.rand(N) >= zero_weight).astype(np.float32)
    grad = (rng.randn(N) * 3).astype(np.float32)
    hess = (rng.rand(N) + 0.05).astype(np.float32)
    w3 = np.stack([grad * w, hess * w, w], 1).astype(np.float32)
    leaf_id = rng.randint(0, 5, N).astype(np.int32)
    return binned, w3, leaf_id


def oracle(binned, w3, member):
    """float64 numpy histogram of the member rows."""
    out = np.zeros((G, B, 3))
    rows = np.flatnonzero(member)
    for g in range(G):
        b = binned[rows, g].astype(np.int64)
        np.add.at(out[g, :, 0], b, w3[rows, 0].astype(np.float64))
        np.add.at(out[g, :, 1], b, w3[rows, 1].astype(np.float64))
        np.add.at(out[g, :, 2], b, (w3[rows, 2] > 0).astype(np.float64))
    return out


def check(port, ref, exact):
    port, ref = np.asarray(port, np.float64), np.asarray(ref, np.float64)
    assert port.shape == ref.shape
    assert np.array_equal(port[..., 2], ref[..., 2])
    assert np.array_equal(port[..., 2], exact[..., 2])
    bound = 1e-5 * np.maximum(1.0, np.abs(ref[..., :2]))
    assert np.all(np.abs(port[..., :2] - ref[..., :2]) <= bound)
    assert np.all(np.abs(port[..., :2] - exact[..., :2])
                  <= 1e-5 * np.maximum(1.0, np.abs(exact[..., :2])))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_all_rows_equals_leaf_histogram(seed):
    binned, w3, _ = inputs(seed)
    ref = jh.leaf_histogram(jnp.asarray(binned), jnp.asarray(w3), B, CHUNK,
                            bf16=False)
    got = leaf_histogram(torch.from_numpy(binned), torch.from_numpy(w3), B)
    assert got.shape == (G, B, 3) and got.dtype == torch.float32
    check(got.numpy(), np.asarray(ref),
          oracle(binned, w3, np.ones(N, bool)))


@pytest.mark.parametrize("seed", [0, 3])
def test_row_list_equals_batched_leaves_histogram(seed):
    binned, w3, leaf_id = inputs(seed)
    ids = np.array([4, 1, 2], np.int32)
    ref = jh.batched_leaves_histogram(
        jnp.asarray(binned), jnp.asarray(w3), jnp.asarray(leaf_id),
        jnp.asarray(ids), B, CHUNK, bf16=False)
    for c, key in enumerate(ids):
        rows = np.flatnonzero(leaf_id == key).astype(np.int32)
        got = leaf_histogram(torch.from_numpy(binned), torch.from_numpy(w3),
                             B, rows=torch.from_numpy(rows),
                             n_rows=len(rows))
        check(got.numpy(), np.asarray(ref[c]),
              oracle(binned, w3, leaf_id == key))


@pytest.mark.parametrize("n_valid", [1, 300, 700])
def test_row_list_equals_gathered_leaves_histogram(n_valid):
    binned, w3, leaf_id = inputs(4)
    member = np.flatnonzero(leaf_id == 2)
    cap = 768
    rows = np.zeros(cap, np.int32)
    rows[:min(n_valid, len(member))] = member[:n_valid]
    n_valid = min(n_valid, len(member))
    ids = np.array([2], np.int32)
    ref = jh.gathered_leaves_histogram(
        jnp.asarray(binned), jnp.asarray(w3), jnp.asarray(leaf_id),
        jnp.asarray(rows), jnp.asarray(ids), B, CHUNK, bf16=False,
        n_valid=n_valid)
    got = leaf_histogram(torch.from_numpy(binned), torch.from_numpy(w3), B,
                         rows=torch.from_numpy(rows), n_rows=n_valid)
    sel = np.zeros(N, bool)
    sel[rows[:n_valid]] = True
    check(got.numpy(), np.asarray(ref[0]), oracle(binned, w3, sel))


def test_subtract_gives_the_sibling():
    binned, w3, leaf_id = inputs(5, zero_weight=0.0)
    tb, tw = torch.from_numpy(binned), torch.from_numpy(w3)
    parent = leaf_histogram(tb, tw, B)
    rows = torch.from_numpy(np.flatnonzero(leaf_id < 2).astype(np.int32))
    small = leaf_histogram(tb, tw, B, rows=rows, n_rows=len(rows))
    large = subtract(parent, small)
    assert torch.equal(large, parent - small)
    ref = oracle(binned, w3, leaf_id >= 2)
    assert np.array_equal(large[..., 2].numpy(), ref[..., 2])
    assert np.all(np.abs(large[..., :2].numpy() - ref[..., :2])
                  <= 1e-4 * np.maximum(1.0, np.abs(ref[..., :2])))


def test_cpu_tensors_run_the_plain_version_uncounted():
    binned, w3, _ = inputs(6)
    before = leaf_histogram.launches
    a = leaf_histogram(torch.from_numpy(binned), torch.from_numpy(w3), B)
    b = leaf_histogram_plain(torch.from_numpy(binned), torch.from_numpy(w3),
                             B)
    assert torch.equal(a, b) and leaf_histogram.launches == before


def test_bad_inputs_raise_by_name():
    binned, w3, leaf_id = inputs(7)
    tb, tw = torch.from_numpy(binned), torch.from_numpy(w3)
    with pytest.raises(LightGBMError, match="num_bins"):
        leaf_histogram(tb, tw, 0)
    with pytest.raises(LightGBMError, match="out must be"):
        leaf_histogram(tb, tw, B, out=torch.empty(1, G, B, 3))
    with pytest.raises(LightGBMError, match="n_rows"):
        leaf_histogram(tb, tw, B, rows=torch.zeros(4, dtype=torch.int32),
                       n_rows=9)
    with pytest.raises(LightGBMError, match="w3"):
        leaf_histogram(tb, tw[:, :2], B)
