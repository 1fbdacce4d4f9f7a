"""Quantized-gradient training's pieces against the JAX package: the
clip magnitude `train_qmax`, kernel Q's plain version
(`quantize_gradients`), kernel HQ's plain version (`leaf_histogram_i32`)
against the JAX int32 histograms (`leaf_histogram` and
`gathered_leaves_histogram` with `quantize=int8|int16`) on the same
codes, the int32 sibling subtraction and `dequantize_hist`.

Tolerance: none. Codes, in-bag weights, scales, histograms and
dequantized values are compared bit for bit: integer sums do not depend
on their order, and the quantizer repeats the JAX package's f32
operations.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from lightgbm_tpu.ingest.landing import plan_row_layout
from lightgbm_tpu.ops import histogram as jh
from lightgbm_tpu.ops import split as jsplit
from lightgbm_tpu_torch import LightGBMError
from lightgbm_tpu_torch.ingest.landing import hist_chunk
from lightgbm_tpu_torch.learner.grow import GrowerConfig, SerialGrower
from lightgbm_tpu_torch.ops import histogram as th
from lightgbm_tpu_torch.ops import rng
from lightgbm_tpu_torch.ops.split import dequantize_hist

torch.set_num_threads(1)

N, G, B, CHUNK = 2048, 5, 16, 256


def test_train_qmax_equals_the_jax_one():
    for mode in ("int8", "int16"):
        for n in (1, 900, 65_536, 65_537, 500_000, 2_000_000, 10 ** 8):
            assert th.train_qmax(mode, n) == jh.train_qmax(mode, n)
    # at HIGGS's 2,000,000 rows the int16 codes are capped at 817
    assert th.train_qmax("int8", 2_000_000) == 127
    assert th.train_qmax("int16", 2_000_000) == 817
    assert th.TRAIN_QUANTIZE_MODES == jh.TRAIN_QUANTIZE_MODES


@pytest.mark.parametrize("mode", ["int8", "int16"])
def test_train_qmax_keeps_a_full_bin_inside_int32(mode):
    # around the row counts where the cap starts to bind
    edge = (2 ** 31 - 1) // (jh._TRAIN_QMAX[mode] + 256)
    for n in (edge - 1, edge, edge + 1, 16 * edge, 2 ** 31 // 300):
        q = th.train_qmax(mode, n)
        assert q * n < 2 ** 31
        # below the type's range only where the cap binds, and then the
        # largest qmax whose full bin keeps the JAX package's headroom
        assert q == jh._TRAIN_QMAX[mode] or (q + 257) * n > 2 ** 31 - 1
    assert th.train_qmax(mode, edge) == jh._TRAIN_QMAX[mode]
    assert th.train_qmax(mode, edge + 1) < jh._TRAIN_QMAX[mode]


@pytest.mark.parametrize("n,groups,bins", [
    (900, 7, 64), (3000, 7, 64), (2_000_000, 28, 64), (10 ** 7, 2000, 256),
    (1, 1, 2)])
def test_the_gate_chunk_is_the_jax_plan_chunk(n, groups, bins):
    for chunk in (65536, 512, 1 << 22):
        assert hist_chunk(n, groups, bins, chunk) == plan_row_layout(
            n, groups, bins, tpu_hist_chunk=chunk).chunk
    # HIGGS at full width calibrates on 65,536 rows
    assert hist_chunk(2_000_000, 28, 64) == 65536


def gradients(seed, n, bag):
    rs = np.random.RandomState(seed)
    g = (rs.randn(n) * 3).astype(np.float32)
    g[rs.rand(n) < 0.05] = 0.0
    h = (rs.rand(n) + 0.02).astype(np.float32)
    w = (rs.rand(n) < 0.6).astype(np.float32) if bag \
        else np.ones(n, np.float32)
    return g, h, w


def quantize_both(g, h, w, mode, hess_const, seed=7, it=2):
    n = len(g)
    qmax = th.train_qmax(mode, n)
    jb = jax.random.fold_in(jax.random.fold_in(
        jax.random.PRNGKey(seed), it), 0)
    ref = jh.quantize_gradients(
        jnp.asarray(g), jnp.asarray(h), jnp.asarray(w), n=n, qmax=qmax,
        key_g=jax.random.fold_in(jb, 0), key_h=jax.random.fold_in(jb, 1),
        hess_const=hess_const)
    tb = rng.fold_in(rng.fold_in(rng.prng_key(seed), it), 0)
    got = th.quantize_gradients(
        torch.from_numpy(g), torch.from_numpy(h), torch.from_numpy(w),
        qmax=qmax, key_g=rng.fold_in(tb, 0), key_h=rng.fold_in(tb, 1),
        hess_const=hess_const, reciprocal_scale=False)
    return [np.asarray(r) for r in ref], got, qmax


@pytest.mark.parametrize("mode", ["int8", "int16"])
@pytest.mark.parametrize("hess_const", [False, True])
@pytest.mark.parametrize("bag", [False, True])
def test_quantize_gradients_is_bitwise_jax(mode, hess_const, bag):
    g, h, w = gradients(1, 3001, bag)
    if hess_const:
        h = np.full_like(h, 0.25)
    (q_g, q_h, w01, qscale), got, qmax = quantize_both(g, h, w, mode,
                                                       hess_const)
    assert got.codes.dtype == torch.int16 and got.codes.shape == (3001, 2)
    assert np.array_equal(got.codes[:, 0].numpy().astype(np.float32), q_g)
    assert np.array_equal(got.codes[:, 1].numpy().astype(np.float32), q_h)
    assert np.array_equal(got.w01.numpy(), w01)
    assert np.array_equal(got.qscale.numpy().view(np.int32),
                          qscale.view(np.int32))
    assert np.abs(got.codes.numpy()).max() <= qmax
    if hess_const:
        assert np.array_equal(got.codes[:, 1].numpy(), qmax * w01)


def test_quantize_gradients_of_zeros_and_the_plain_version():
    g = np.zeros(100, np.float32)
    h = np.ones(100, np.float32)
    (q_g, _, _, qscale), got, _ = quantize_both(g, h, np.ones(100, np.float32),
                                                "int8", False)
    assert not got.codes[:, 0].any() and not q_g.any()
    assert np.array_equal(got.qscale.numpy(), qscale)
    before = th.quantize_gradients.launches
    args = [torch.from_numpy(a) for a in gradients(3, 500, True)]
    a = th.quantize_gradients(*args, qmax=127, key_g=(0, 1), key_h=(0, 2),
                              reciprocal_scale=False)
    b = th.quantize_gradients_plain(*args, 127, (0, 1), (0, 2),
                                    reciprocal_scale=False)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert th.quantize_gradients.launches == before


def test_quantize_gradients_refuses_bad_inputs():
    t = torch.ones(8)
    with pytest.raises(LightGBMError, match="f32"):
        th.quantize_gradients(t.double(), t, t, qmax=127, key_g=(0, 0),
                              key_h=(0, 1), reciprocal_scale=False)
    with pytest.raises(LightGBMError, match="qmax"):
        th.quantize_gradients(t, t, t, qmax=40000, key_g=(0, 0),
                              key_h=(0, 1), reciprocal_scale=False)


def codes_and_bins(seed, mode, bag=True):
    rs = np.random.RandomState(seed)
    binned = rs.randint(0, B, (N, G)).astype(np.uint8)
    binned[:, 4] = rs.randint(0, 3, N)
    g, h, w = gradients(seed, N, bag)
    _, got, _ = quantize_both(g, h, w, mode, False, seed=seed)
    codes, w01 = got.codes, got.w01
    w3 = np.stack([codes[:, 0].numpy() * w01.numpy(),
                   codes[:, 1].numpy() * w01.numpy(),
                   w01.numpy()], 1).astype(np.float32)
    return binned, codes, w01, w3


@pytest.mark.parametrize("mode", ["int8", "int16"])
@pytest.mark.parametrize("seed", [0, 1])
def test_int32_histogram_is_the_jax_histogram(mode, seed):
    binned, codes, w01, w3 = codes_and_bins(seed, mode)
    ref = np.asarray(jh.leaf_histogram(jnp.asarray(binned), jnp.asarray(w3),
                                       B, CHUNK, quantize=mode))
    assert ref.dtype == np.int32
    got = th.leaf_histogram_i32(torch.from_numpy(binned), codes, w01, B)
    assert got.dtype == torch.int32 and got.shape == (G, B, 3)
    assert np.array_equal(got.numpy(), ref)


@pytest.mark.parametrize("mode", ["int8", "int16"])
@pytest.mark.parametrize("n_valid", [1, 300, 700])
def test_row_list_is_the_jax_gathered_histogram(mode, n_valid):
    binned, codes, w01, w3 = codes_and_bins(2, mode)
    leaf_id = np.random.RandomState(5).randint(0, 4, N).astype(np.int32)
    member = np.flatnonzero(leaf_id == 2)
    rows = np.zeros(768, np.int32)
    n_valid = min(n_valid, len(member))
    rows[:n_valid] = member[:n_valid]
    ref = np.asarray(jh.gathered_leaves_histogram(
        jnp.asarray(binned), jnp.asarray(w3), jnp.asarray(leaf_id),
        jnp.asarray(rows), jnp.asarray(np.array([2], np.int32)), B, CHUNK,
        n_valid=n_valid, quantize=mode))[0]
    got = th.leaf_histogram_i32(torch.from_numpy(binned), codes, w01, B,
                                rows=torch.from_numpy(rows), n_rows=n_valid)
    assert np.array_equal(got.numpy(), ref)


def test_int32_subtraction_gives_the_sibling_exactly():
    binned, codes, w01, _ = codes_and_bins(3, "int16")
    tb = torch.from_numpy(binned)
    member = np.random.RandomState(1).rand(N) < 0.3
    small = torch.from_numpy(np.flatnonzero(member).astype(np.int32))
    large = torch.from_numpy(np.flatnonzero(~member).astype(np.int32))
    parent = th.leaf_histogram_i32(tb, codes, w01, B)
    h_small = th.leaf_histogram_i32(tb, codes, w01, B, rows=small,
                                    n_rows=len(small))
    h_large = th.leaf_histogram_i32(tb, codes, w01, B, rows=large,
                                    n_rows=len(large))
    sib = th.subtract(parent, h_small)
    assert sib.dtype == torch.int32 and torch.equal(sib, h_large)
    assert torch.equal(h_small + h_large, parent)


def test_a_full_bin_at_the_cap_sums_exactly():
    """65,536 rows in one bin, every code at the int16 cap: the sum sits
    just below 2^31 and must come out exact in int32 (JAX and port)."""
    n = 65_536
    qmax = th.train_qmax("int16", n)
    assert qmax * n < 2 ** 31 <= (qmax + 256) * n + n
    binned = np.zeros((n, 2), np.uint8)
    codes = torch.full((n, 2), qmax, dtype=torch.int16)
    codes[:, 1] = -qmax
    w01 = torch.ones(n)
    got = th.leaf_histogram_i32(torch.from_numpy(binned), codes, w01, 4)
    assert got[0, 0].tolist() == [qmax * n, -qmax * n, n]
    w3 = np.stack([np.full(n, qmax), np.full(n, -qmax), np.ones(n)],
                  1).astype(np.float32)
    ref = np.asarray(jh.leaf_histogram(jnp.asarray(binned), jnp.asarray(w3),
                                       4, 16384, quantize="int16"))
    assert np.array_equal(got.numpy(), ref)


def test_the_grower_refuses_a_qmax_past_the_cap():
    binned = torch.zeros((10, 1), dtype=torch.uint8)
    fmeta = {"num_bin": np.array([2]), "missing_type": np.array([0]),
             "default_bin": np.array([0]), "is_categorical": np.array([0]),
             "group": np.array([0]), "offset": np.array([0]),
             "is_bundled": np.array([0])}
    cfg = GrowerConfig(num_leaves=4, hist_quantize="int8",
                       hist_qmax=2 ** 31 // 10 + 1)
    with pytest.raises(LightGBMError, match="overflow"):
        SerialGrower(binned, fmeta, cfg, 2, 2)


def test_leaf_histogram_i32_plain_and_refusals():
    binned, codes, w01, _ = codes_and_bins(4, "int8")
    tb = torch.from_numpy(binned)
    before = th.leaf_histogram_i32.launches
    assert torch.equal(th.leaf_histogram_i32(tb, codes, w01, B),
                       th.leaf_histogram_i32_plain(tb, codes, w01, B))
    assert th.leaf_histogram_i32.launches == before
    with pytest.raises(LightGBMError, match="int16"):
        th.leaf_histogram_i32(tb, codes.int(), w01, B)
    with pytest.raises(LightGBMError, match="out must be"):
        th.leaf_histogram_i32(tb, codes, w01, B, out=torch.empty(G, B, 3))
    with pytest.raises(LightGBMError, match="n_rows"):
        th.leaf_histogram_i32(tb, codes, w01, B,
                              rows=torch.zeros(3, dtype=torch.int32),
                              n_rows=5)


def test_dequantize_hist_is_bitwise_jax():
    binned, codes, w01, _ = codes_and_bins(5, "int16")
    hist = th.leaf_histogram_i32(torch.from_numpy(binned), codes, w01, B)
    qscale = np.array([3.1e-4, 7.7e-3, 1.0], np.float32)
    ref = np.asarray(jsplit.dequantize_hist(jnp.asarray(hist.numpy()),
                                            jnp.asarray(qscale)))
    got = dequantize_hist(hist, torch.from_numpy(qscale))
    assert got.dtype == torch.float32
    assert np.array_equal(got.numpy().view(np.int32), ref.view(np.int32))
    tot = hist[0].sum(0, dtype=torch.int32)
    assert np.array_equal(
        dequantize_hist(tot, torch.from_numpy(qscale)).numpy(),
        np.asarray(jsplit.dequantize_hist(
            jnp.asarray(hist.numpy())[0].sum(0), jnp.asarray(qscale))))
    assert dequantize_hist(hist, None) is hist
