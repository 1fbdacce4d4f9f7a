"""Quantized histograms (HQ) and leaf moments (LM) on uint16 group bins
in the port against the JAX package, on the CPU.

The fixtures are tests/test_torch_uint16.py's, which give uint16
matrices as the JAX package builds them:
- Bosch-like: 3,000 rows x 68 features, 6 one-hot blocks of 10 and 8
  sparse numerics, max_bin 63; EFB bundles each block into one group of
  631 bins, 14 groups in all;
- max_bin=1023: 2,000 rows x 4 dense features, single-feature groups of
  667 bins.

Held here:
- HQ's plain version on uint16 bins equal to the JAX quantized
  `leaf_histogram` and `gathered_leaves_histogram` (int8 and int16
  codes from the JAX quantizer's stream), bitwise in int32;
- HQ's slices of the groups (`i32_slices`): whole groups of one kind
  in order, each slice within the shared budget, 9 at the Bosch widths;
  a uint16 matrix without H's layout is refused by name, as the card's
  kernels refuse it;
- `train` with int8, int16 and int8 + bagging on the Bosch-like fixture
  (7 leaves, 4 rounds): the same trees as the JAX package, leaf
  values and raw predictions within the tolerances
  tests/test_torch_quant_train.py holds the same modes to (1e-5 *
  max(1, |ref|));
- LM's plain version on uint16 bins within 1e-5 * max(1, |ref|) of the
  JAX `batched_leaves_moments` (f32 sums in another order), and
  `linear.leaf_feature_moments` within 1e-5 * max(1, sum of the terms'
  absolute values) of the JAX one (a leaf's sum over its bins cancels,
  as chip_smoke.py's LM checks scale it).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import lightgbm_tpu as jlgb
import lightgbm_tpu_torch as tlgb
from lightgbm_tpu.dataset import Dataset as JaxDataset
from lightgbm_tpu.linear import stats as jstats
from lightgbm_tpu.ops import histogram as jh
from lightgbm_tpu_torch.dataset import Dataset as TorchDataset
from lightgbm_tpu_torch.linear import leaf_feature_moments
from lightgbm_tpu_torch.log import LightGBMError
from lightgbm_tpu_torch.ops import histogram as th
from lightgbm_tpu_torch.ops.rng import fold_in, prng_key

torch.set_num_threads(1)
CHUNK = 500


def bosch_like(n, seed, blocks=6, f=68):
    """bench.py's Bosch shape cut to `blocks` one-hot blocks of 10 and
    f - 10 * blocks sparse numerics."""
    rng = np.random.RandomState(seed)
    x = np.zeros((n, f), np.float32)
    for b in range(blocks):
        pick = rng.randint(0, 10, size=n)
        x[np.arange(n), b * 10 + pick] = rng.rand(n).astype(np.float32) + 0.1
    rest = rng.randn(n, f - blocks * 10).astype(np.float32)
    rest[rng.rand(n, f - blocks * 10) < 0.8] = 0.0
    x[:, blocks * 10:] = rest
    score = (x[:, 0] * 2.0 - x[:, 10] + x[:, 60] - 0.5 * x[:, 61]
             + x[:, 20] * x[:, 62])
    y = (score + 0.5 * rng.logistic(size=n) > 0.3).astype(np.float32)
    return x, y


def wide_bins(n, seed):
    rng = np.random.RandomState(seed)
    x = rng.randn(n, 4)
    x[rng.rand(n) < 0.1, 1] = np.nan
    y = (x[:, 0] + 0.5 * np.nan_to_num(x[:, 1]) - x[:, 2] * x[:, 3]
         + 0.5 * rng.randn(n) > 0).astype(np.float32)
    return x, y


FIXTURES = {"bosch": (bosch_like, 3000, 63), "max_bin_1023":
            (wide_bins, 2000, 1023)}
_datasets = {}


def datasets(name):
    if name not in _datasets:
        make, n, max_bin = FIXTURES[name]
        x, y = make(n, 0)
        td = TorchDataset.from_numpy(x, y, max_bin=max_bin, keep_raw=True)
        _datasets[name] = (x, y, max_bin, td)
    return _datasets[name]


def codes_of(n, mode, seed):
    """int8 or int16 codes and the 0/1 weight from the quantizer (bitwise
    the JAX one, tests/test_torch_quantize.py) of seeded gradients, with
    a fifth of the rows out of the bag."""
    rng = np.random.RandomState(seed)
    grad = torch.from_numpy((rng.randn(n) * 0.7).astype(np.float32))
    hess = torch.from_numpy((rng.rand(n) * 0.25 + 1e-3).astype(np.float32))
    w = torch.from_numpy((rng.rand(n) >= 0.2).astype(np.float32))
    key = fold_in(prng_key(seed), 0)
    q = th.quantize_gradients(grad, hess, w, qmax=th.train_qmax(mode, n),
                              key_g=fold_in(key, 0), key_h=fold_in(key, 1),
                              reciprocal_scale=False)
    w01 = q.w01.numpy()
    w3 = np.stack([q.codes[:, 0].numpy() * w01, q.codes[:, 1].numpy() * w01,
                   w01], 1).astype(np.float32)
    return q.codes, q.w01, w3


@pytest.mark.parametrize("rows", ["all_rows", "row_list"])
@pytest.mark.parametrize("mode", ["int8", "int16"])
@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_hq_on_uint16_bins_is_the_jax_int32_histogram(name, mode, rows):
    _, _, _, td = datasets(name)
    binned = td.binned
    assert binned.dtype == np.uint16
    n = binned.shape[0]
    widths = tuple(int(w) for w in td.groups.group_num_bin)
    b = max(widths)
    codes, w01, w3 = codes_of(n, mode, 3 if mode == "int8" else 4)
    tb = torch.from_numpy(binned)
    if rows == "all_rows":
        ref = np.asarray(jh.leaf_histogram(
            jnp.asarray(binned), jnp.asarray(w3), b, CHUNK, quantize=mode,
            group_widths=widths))
        got = th.leaf_histogram_i32(tb, codes, w01, b)
    else:
        leaf_id = np.random.RandomState(5).randint(0, 3, n).astype(np.int32)
        member = np.flatnonzero(leaf_id == 1)
        buf = np.zeros(-(-len(member) // CHUNK) * CHUNK, np.int32)
        buf[:len(member)] = member
        ref = np.asarray(jh.gathered_leaves_histogram(
            jnp.asarray(binned), jnp.asarray(w3), jnp.asarray(leaf_id),
            jnp.asarray(buf), jnp.asarray(np.array([1], np.int32)), b, CHUNK,
            n_valid=len(member), quantize=mode, group_widths=widths))[0]
        got = th.leaf_histogram_i32(tb, codes, w01, b,
                                    rows=torch.from_numpy(buf),
                                    n_rows=len(member))
    assert ref.dtype == np.int32 and got.dtype == torch.int32
    assert np.array_equal(got.numpy(), ref)
    assert np.abs(ref[..., :2]).max() > 127


def test_hq_slices_pack_whole_groups_under_the_shared_budget():
    # the Bosch widths: 268 sparse numerics of 63 bins, then 70 one-hot
    # bundles of 631 (61,054 bins); HQ interleaves the narrow groups by
    # lane (3 x 32 words a bin a turn of 32 groups) and packs the wide
    # ones at their widths
    bosch = np.array([63] * 268 + [631] * 70)
    for widths, count in ((datasets("bosch")[3].groups.group_num_bin, None),
                          (bosch, 9), (np.full(5, 2048), 2)):
        s, woff = th.i32_slices(widths)
        widths = np.asarray(widths, np.int64)
        assert s[0, 0] == 0 and s[-1, 0] + s[-1, 1] == len(widths)
        assert np.all(s[1:, 0] == s[:-1, 0] + s[:-1, 1])
        words = []
        for g0, gc, wn, wd in s:
            grp = widths[g0:g0 + gc]
            # whole groups of one kind, within the shared budget
            assert (grp <= th.HQ_INTERLEAVE_BINS).all() == bool(wn)
            assert (grp > th.HQ_INTERLEAVE_BINS).all() == (not wn)
            assert wd == (96 * wn * -(-gc // 32) if wn
                          else (3 * grp.sum() + 3) // 4 * 4)
            words.append(wd)
        assert max(words) <= th.HIST_I32_WORDS
        # no packed slice could have taken the next group too
        for (g0, gc, wn, wd), z in zip(s[:-1], s[1:, 0]):
            if not wn and widths[z] > th.HQ_INTERLEAVE_BINS:
                assert wd + 3 * widths[z] > th.HIST_I32_WORDS
        if count is not None:
            assert len(s) == count


def test_a_uint16_matrix_without_its_layout_is_refused_by_name():
    binned = torch.zeros((8, 3), dtype=torch.uint16)
    lay = th.hist_layout([631, 63, 63], False)
    th.check_layout("leaf_histogram_i32", binned, 631, lay)
    for bad, args in ((None, ()), (th.hist_layout([631, 63], False), ()),
                      (lay, (True,))):
        with pytest.raises(LightGBMError, match="leaf_histogram_i32: a "
                           "uint16 matrix on the card takes the hist_layout"):
            th.check_layout("leaf_histogram_i32", binned, 631, bad, *args)
    with pytest.raises(LightGBMError, match="takes the hist_layout"):
        th.check_layout("leaf_histogram_i32", binned, 600, lay)


PARAMS = {"objective": "binary", "num_leaves": 7, "learning_rate": 0.3,
          "min_data_in_leaf": 10, "min_sum_hessian_in_leaf": 1.0,
          "verbose": -1, "tpu_hist_bf16": False}
RUNS = {"int8": {"tpu_hist_quantize": "int8"},
        "int16": {"tpu_hist_quantize": "int16"},
        "int8_bagging": {"tpu_hist_quantize": "int8",
                         "bagging_fraction": 0.8, "bagging_freq": 1}}


@pytest.mark.parametrize("run", sorted(RUNS))
def test_quantized_training_on_uint16_bins_grows_the_jax_trees(run):
    name = "bosch"
    x, y, max_bin, _ = datasets(name)
    params = dict(PARAMS, max_bin=max_bin, **RUNS[run])
    jb = jlgb.train(dict(params), jlgb.Dataset(x, y), 4, verbose_eval=False)
    tds = tlgb.Dataset(x, y)
    tb = tlgb.train(dict(params), tds, 4, device="cpu")
    assert tb._inner._binned.dtype == torch.uint16
    assert tb._inner._grower.quantized
    jt, tt = jb._inner.models, tb._inner.models
    assert len(jt) == len(tt) == 4
    for i, (a, b) in enumerate(zip(jt, tt)):
        assert a.num_leaves == b.num_leaves > 1, i
        m = a.num_leaves - 1
        for k in ("split_feature", "threshold_in_bin", "decision_type",
                  "left_child", "right_child"):
            assert np.array_equal(getattr(a, k)[:m], getattr(b, k)[:m]), \
                (i, k)
        assert np.array_equal(a.leaf_count, b.leaf_count), i
        assert np.all(np.abs(b.leaf_value - a.leaf_value)
                      <= 1e-5 * np.maximum(1.0, np.abs(a.leaf_value))), i
    xv, _ = FIXTURES[name][0](500, 1)
    ref = jb.predict(xv, raw_score=True)
    got = tb.predict(xv, raw_score=True)
    assert np.all(np.abs(got - ref) <= 1e-5 * np.maximum(1.0, np.abs(ref)))


def moment_inputs(seed):
    _, _, _, td = datasets("max_bin_1023")
    binned, raw = td.binned, td.raw
    n = binned.shape[0]
    rng = np.random.RandomState(seed)
    m = (rng.rand(n) < 0.9).astype(np.float32)
    w3 = np.stack([rng.randn(n) * m, (rng.rand(n) + 0.1) * m, m],
                  1).astype(np.float32)
    leaf_id = rng.randint(0, 7, n).astype(np.int32)
    return binned, raw, w3, leaf_id, int(td.groups.group_num_bin.max())


def test_lm_on_uint16_bins_against_the_jax_moments():
    binned, raw, w3, leaf_id, b = moment_inputs(6)
    assert binned.dtype == np.uint16 and b > 256
    ids = np.array([5, 0, 3, 6], np.int32)
    ref = np.asarray(jh.batched_leaves_moments(
        jnp.asarray(binned), jnp.asarray(raw), jnp.asarray(w3),
        jnp.asarray(leaf_id), jnp.asarray(ids), b, chunk=CHUNK))
    got = th.leaf_moments(torch.from_numpy(binned), torch.from_numpy(raw),
                          torch.from_numpy(w3), b,
                          torch.from_numpy(leaf_id), torch.from_numpy(ids))
    assert got.shape == ref.shape == (4, binned.shape[1], b, 4)
    assert np.all(np.abs(got.numpy() - ref)
                  <= 1e-5 * np.maximum(1.0, np.abs(ref)))
    assert np.count_nonzero(ref) > 1000


def test_leaf_feature_moments_on_uint16_bins_equal_the_jax_ones():
    binned, raw, w3, leaf_id, b = moment_inputs(7)
    ids = list(range(7))
    ref = np.asarray(jstats.leaf_feature_moments(
        jnp.asarray(binned), jnp.asarray(raw), jnp.asarray(w3),
        jnp.asarray(leaf_id), ids, b, chunk=CHUNK))
    got = leaf_feature_moments(torch.from_numpy(binned),
                               torch.from_numpy(raw), torch.from_numpy(w3),
                               torch.from_numpy(leaf_id), ids, b)
    assert got.shape == ref.shape == (7, binned.shape[1], 4)
    # a leaf's sum over its bins cancels: held to its terms' |sum|
    x = np.where(np.isfinite(raw), raw, 0.0).astype(np.float64)
    terms = np.abs(np.stack([x * w3[:, 2:3], x * x * w3[:, 2:3],
                             x * w3[:, 0:1], x * w3[:, 1:2]], -1))
    scale = np.stack([terms[leaf_id == c].sum(0) for c in ids])
    assert np.all(np.abs(got.numpy() - ref)
                  <= 1e-5 * np.maximum(1.0, scale))
