"""Kernel Q's launch plan and its non-finite scales
(lightgbm_tpu_torch/ops/histogram.py `quantize_plan`,
`quantize_gradients`), on the CPU at fixture scale.

- The plan: one cooperative grid of at most the co-resident blocks;
  every row falls to exactly one thread, in its registers (`kept`) or
  read again after the barrier (`reread`), from one row to the int32
  limit.
- A NaN or an inf in gw = grad * w (or in hw) gives the scales the JAX
  package's `quantize_gradients` gives: NaN where its scale is NaN, inf
  where it is inf (the maximum propagates a NaN, as jnp.max and
  jnp.maximum do); the codes equal JAX's wherever gw / scale is a
  number.
- The wrapper takes inputs that do not start on 16 bytes at row counts
  that are not multiples of 4 (the gradients and hessians as the rows of
  one [2, n] tensor, as the lambdarank objective returns them) and gives
  the JAX package's codes, w01 and scales.
Inputs are made with numpy from a seed.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightgbm_tpu.ops import histogram as jh
from lightgbm_tpu_torch import LightGBMError
from lightgbm_tpu_torch.ops import histogram as th
from lightgbm_tpu_torch.ops import rng

torch.set_num_threads(1)

#: co-resident blocks of 1,024 threads on an H100 (132 SMs, one each)
H100_RESIDENT = 132
INT32_MAX = 2 ** 31 - 1


@pytest.mark.parametrize("n", [1, 255, 1024, 4097, 500_000, 2_000_000,
                               2_000_003, INT32_MAX - 1, INT32_MAX])
@pytest.mark.parametrize("resident", [1, 7, H100_RESIDENT])
def test_plan_covers_every_row_once(n, resident):
    plan = th.quantize_plan(n, resident)
    threads = plan["blocks"] * th.Q_THREADS
    groups = -(-n // th.Q_GROUP)
    assert 1 <= plan["blocks"] <= resident
    assert plan["blocks"] == min(resident, -(-groups // th.Q_THREADS))
    assert plan["kept"] + plan["reread"] == n
    # thread t takes groups t, t + threads, ...; its first stays in
    # registers: the rows of groups below `threads`
    assert plan["kept"] == min(n, threads * th.Q_GROUP)
    turns = -(-groups // threads)
    assert (turns - 1) * threads < groups <= turns * threads
    if n <= 2_000_003:
        rows = np.arange(n, dtype=np.int64)
        group = rows // th.Q_GROUP
        owner, turn = group % threads, group // threads
        # each group is one (thread, turn), of at most Q_GROUP rows
        assert (owner < threads).all() and (turn < turns).all()
        assert np.array_equal(owner + turn * threads, group)
        assert np.bincount(group).max() <= th.Q_GROUP
        assert int((turn == 0).sum()) == plan["kept"]
    else:
        # the row index passes the int32 range only in 64 bits: the
        # kernel's long long indices
        assert turns * threads * th.Q_GROUP >= INT32_MAX


def test_plan_refuses_a_card_without_cooperative_launch():
    with pytest.raises(LightGBMError, match="cooperatively"):
        th.quantize_plan(100, 0)


def non_finite(case, n=3001, seed=3):
    rs = np.random.RandomState(seed)
    g = (rs.randn(n) * 3).astype(np.float32)
    h = (rs.rand(n) + 0.02).astype(np.float32)
    w = (rs.rand(n) < 0.7).astype(np.float32)
    live = np.nonzero(w)[0]
    if case == "nan_grad":
        g[live[5]] = np.nan
    elif case == "inf_grad":
        g[live[7]] = np.inf
    elif case == "neg_inf_grad":
        g[live[9]] = -np.inf
    elif case == "nan_hess":
        h[live[11]] = np.nan
    elif case == "inf_hess":
        h[live[13]] = np.inf
    elif case == "nan_weight":
        w[2] = np.nan
    elif case == "out_of_bag_nan":
        g[np.nonzero(w == 0)[0][0]] = np.nan      # 0 * NaN is NaN
    return g, h, w


@pytest.mark.parametrize("case", ["nan_grad", "inf_grad", "neg_inf_grad",
                                  "nan_hess", "inf_hess", "nan_weight",
                                  "out_of_bag_nan"])
@pytest.mark.parametrize("hess_const", [False, True])
def test_non_finite_scales_are_the_jax_scales(case, hess_const):
    g, h, w = non_finite(case)
    n = len(g)
    qmax = th.train_qmax("int8", n)
    jb = jax.random.fold_in(jax.random.fold_in(jax.random.PRNGKey(7), 2),
                            0)
    ref = [np.asarray(a) for a in jh.quantize_gradients(
        jnp.asarray(g), jnp.asarray(h), jnp.asarray(w), n=n, qmax=qmax,
        key_g=jax.random.fold_in(jb, 0), key_h=jax.random.fold_in(jb, 1),
        hess_const=hess_const)]
    tb = rng.fold_in(rng.fold_in(rng.prng_key(7), 2), 0)
    with np.errstate(invalid="ignore"):
        got = th.quantize_gradients(
            torch.from_numpy(g), torch.from_numpy(h), torch.from_numpy(w),
            qmax=qmax, key_g=rng.fold_in(tb, 0), key_h=rng.fold_in(tb, 1),
            hess_const=hess_const, reciprocal_scale=False)
    scale, jscale = got.qscale.numpy(), ref[3]
    assert np.array_equal(np.isnan(scale), np.isnan(jscale))
    assert np.array_equal(scale[~np.isnan(scale)],
                          jscale[~np.isnan(jscale)])
    assert np.isnan(scale).any() or np.isinf(scale).any()
    assert np.array_equal(got.w01.numpy(), ref[2])
    # the codes, wherever the quantized value is a number
    for c, (q, s, v) in enumerate(((ref[0], scale[0], g * w),
                                   (ref[1], scale[1], h * w))):
        with np.errstate(invalid="ignore"):
            defined = ~np.isnan(v / s) & ~np.isnan(q)
        if hess_const and c == 1:
            defined = np.ones(n, bool)
        assert np.array_equal(got.codes[:, c].numpy()[defined],
                              q[defined].astype(np.int16))


@pytest.mark.parametrize("recip", [False, True])
def test_plain_scale_keeps_a_nan_in_either_mode(recip):
    g, h, w = non_finite("nan_grad")
    got = th.quantize_gradients_plain(
        torch.from_numpy(g), torch.from_numpy(h), torch.from_numpy(w), 127,
        (0, 1), (0, 2), reciprocal_scale=recip)
    assert bool(torch.isnan(got.qscale[0]))
    assert bool(torch.isfinite(got.qscale[1:]).all())
    g, h, w = non_finite("inf_grad")
    got = th.quantize_gradients_plain(
        torch.from_numpy(g), torch.from_numpy(h), torch.from_numpy(w), 127,
        (0, 1), (0, 2), reciprocal_scale=recip)
    assert float(got.qscale[0]) == float("inf")
    finite = np.isfinite(g * w)
    assert not got.codes[:, 0].numpy()[finite].any()


@pytest.mark.parametrize("n", [1, 3, 5, 1001])
@pytest.mark.parametrize("hess_const", [False, True])
def test_inputs_off_16_bytes_give_the_jax_codes(n, hess_const):
    rs = np.random.RandomState(n)
    gh = np.stack([(rs.randn(n) * 3).astype(np.float32),
                   (rs.rand(n) + 0.02).astype(np.float32)])
    wb = np.concatenate([[1.0], (rs.rand(n) < 0.7)]).astype(np.float32)
    tgh, twb = torch.from_numpy(gh), torch.from_numpy(wb)
    g, h, w = tgh[0], tgh[1], twb[1:]
    assert h.data_ptr() % 16 and w.data_ptr() % 16
    qmax = th.train_qmax("int8", n)
    jb = jax.random.PRNGKey(n)
    ref = [np.asarray(a) for a in jh.quantize_gradients(
        jnp.asarray(gh[0]), jnp.asarray(gh[1]), jnp.asarray(wb[1:]), n=n,
        qmax=qmax, key_g=jax.random.fold_in(jb, 0),
        key_h=jax.random.fold_in(jb, 1), hess_const=hess_const)]
    tb = rng.prng_key(n)
    got = th.quantize_gradients(g, h, w, qmax=qmax,
                                key_g=rng.fold_in(tb, 0),
                                key_h=rng.fold_in(tb, 1),
                                hess_const=hess_const,
                                reciprocal_scale=False)
    assert np.array_equal(got.codes.numpy(),
                          np.stack([ref[0], ref[1]], 1).astype(np.int16))
    assert np.array_equal(got.w01.numpy(), ref[2])
    assert np.array_equal(got.qscale.numpy().view(np.int32),
                          ref[3].view(np.int32))
