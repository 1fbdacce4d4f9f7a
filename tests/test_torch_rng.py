"""The port's threefry stream (lightgbm_tpu_torch/ops/rng.py) against
jax.random, and kernel M's plain version against the JAX package's
bagging mask.

The port pins the form JAX 0.9 uses by default: partitionable threefry
(`jax_threefry_partitionable=True`) and 32-bit seeds (no
`jax_enable_x64`); the guard test fails loudly if either default
changes. Tolerance: none; keys, uniforms and masks are compared bit for
bit.
"""
import numpy as np
import pytest
import torch

import jax
from lightgbm_tpu.boosting import gbdt as jgbdt
from lightgbm_tpu_torch import LightGBMError
from lightgbm_tpu_torch.ops import rng

torch.set_num_threads(1)

SEEDS = [0, 1, 3, 2 ** 31 - 1, 2 ** 40 + 5]
SIZES = [1, 7, 4097, 2 ** 17 + 3]


def words(key):
    return tuple(int(v) for v in np.asarray(key))


def test_the_jax_form_the_port_pins():
    assert jax.config.jax_threefry_partitionable is True
    assert jax.config.jax_enable_x64 is False


@pytest.mark.parametrize("seed", SEEDS)
def test_prng_key_and_fold_in_chains(seed):
    jk, tk = jax.random.PRNGKey(seed), rng.prng_key(seed)
    assert words(jk) == tk
    for data in (0, 1, 9, 2 ** 31 - 1, 2 ** 32 - 1):
        assert words(jax.random.fold_in(jk, data)) == rng.fold_in(tk, data)
    # the quantizer's chain: fold_in(fold_in(fold_in(key, it), 0), 0|1)
    for it in (0, 1, 17):
        jc = jax.random.fold_in(jax.random.fold_in(jk, it), 0)
        tc = rng.fold_in(rng.fold_in(tk, it), 0)
        for last in (0, 1):
            assert words(jax.random.fold_in(jc, last)) == \
                rng.fold_in(tc, last)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("n", SIZES)
def test_uniform_is_bitwise_jax_uniform(seed, n):
    key = rng.fold_in(rng.prng_key(seed), 3)
    ref = np.asarray(jax.random.uniform(
        jax.random.fold_in(jax.random.PRNGKey(seed), 3), (n,)))
    got = rng.uniform(key, n)
    assert got.dtype == torch.float32 and got.shape == (n,)
    assert np.array_equal(got.numpy().view(np.int32), ref.view(np.int32))


def test_threefry_on_ints_equals_threefry_on_tensors():
    x = torch.tensor([0, 1, 2 ** 32 - 1, 123456789], dtype=torch.int64)
    o0, o1 = rng.threefry2x32(7, 2 ** 32 - 3, torch.zeros_like(x), x)
    for i, v in enumerate(x.tolist()):
        assert rng.threefry2x32(7, 2 ** 32 - 3, 0, v) == \
            (int(o0[i]), int(o1[i]))


@pytest.mark.parametrize("seed,refresh,fraction,n", [
    (3, 0, 0.8, 5000), (3, 4, 0.5, 4097), (11, 2, 0.1, 777)])
def test_bagging_mask_is_the_jax_mask(seed, refresh, fraction, n):
    ref = np.asarray(jgbdt._bagging_mask_impl(
        refresh, seed=seed, n=n, n_pad=n, fraction=fraction))
    key = rng.fold_in(rng.prng_key(seed), refresh)
    out = torch.empty(n)
    before = rng.bagging_mask.launches
    got = rng.bagging_mask(key, fraction, out)
    assert got is out and rng.bagging_mask.launches == before
    assert np.array_equal(got.numpy(), ref)
    plain = rng.bagging_mask_plain(key, fraction, torch.empty(n))
    assert torch.equal(plain, got)


def test_bagging_mask_refuses_other_outputs():
    with pytest.raises(LightGBMError, match="f32"):
        rng.bagging_mask((0, 1), 0.5, torch.empty(8, dtype=torch.float64))
    with pytest.raises(LightGBMError, match="f32"):
        rng.bagging_mask((0, 1), 0.5, torch.empty(4, 2))
