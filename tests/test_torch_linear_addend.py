"""Kernel LA (lightgbm_tpu_torch/ops/linear.py `linear_addend`) against
the JAX package's `linear_row_values`, on the CPU at fixture scale.

For k 1 to 8 (the widths the kernel unrolls) and 12 (its any-k kernel),
with NaN, inf, subnormal and negative-zero values in live slots, padded
slots and an intercept-only leaf, the wrapper and its plain version give
score + f32(scale) * linear_row_values bit for bit. Inputs are made with
numpy from a seed.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightgbm_tpu.linear.solver import linear_row_values as jax_rows
from lightgbm_tpu_torch.ops import linear

torch.set_num_threads(1)

F = 14


def problem(k, seed=0, n=2500, leaves=12):
    """Rows in `leaves` leaf slots (the last one empty) with NaN, inf,
    subnormal and negative-zero values in live slots, padded slots, an
    intercept-only leaf, and the leaves' tables."""
    rng = np.random.RandomState(seed + 10 * k)
    x = rng.randn(n, F).astype(np.float32)
    lid = rng.randint(0, leaves - 1, n).astype(np.int32)
    feats = np.stack([rng.choice(F, k, replace=False)
                      for _ in range(leaves)]).astype(np.int32)
    if k > 1:
        feats[1, -1] = -1
    feats[2, :] = -1                                  # intercept alone
    x[rng.rand(n) < 0.04, feats[0, 0]] = np.nan
    x[rng.rand(n) < 0.04, feats[3, k - 1]] = np.inf
    x[rng.rand(n) < 0.04, feats[4, 0]] = -np.inf
    x[rng.rand(n) < 0.05, feats[5, 0]] = 3e-41        # subnormal
    x[rng.rand(n) < 0.05, feats[6, k - 1]] = -1e-45
    x[rng.rand(n) < 0.05, feats[7, 0]] = -0.0
    value = rng.randn(leaves).astype(np.float32)
    coeff = rng.randn(leaves, k).astype(np.float32)
    coeff[feats < 0] = 0.0
    score0 = rng.randn(n).astype(np.float32)
    return x, lid, value, coeff, feats, score0


@pytest.mark.parametrize("k", [1, 2, 3, 4, 5, 6, 7, 8, 12])
@pytest.mark.parametrize("scale", [0.1, 1.0, -1.0])
def test_la_is_the_jax_update_bit_for_bit(k, scale):
    x, lid, value, coeff, feats, score0 = problem(k)
    t = [torch.from_numpy(a) for a in (x, lid, value, coeff, feats)]
    vals = np.asarray(jax_rows(*(jnp.asarray(a) for a in (x, lid, value,
                                                           coeff, feats))))
    ref = score0 + np.float32(scale) * vals
    assert np.isnan(x).any() and not np.isnan(ref).any()
    for fn in (linear.linear_addend, linear.linear_addend_plain):
        score = torch.from_numpy(score0.copy())
        fn(*t, score, scale)
        assert np.array_equal(score.numpy().view(np.int32),
                              ref.view(np.int32))
