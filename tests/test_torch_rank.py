"""lightgbm_tpu_torch's lambdarank gradients (kernel L's plain version,
through `LambdarankNDCG.get_gradients` on the CPU) against the JAX
package's bucketed `LambdarankNDCG` and a float64 per-query oracle of
the reference's pair loop (rank_objective.hpp:83-160).

Both objectives take the same seeded numpy labels, groups, weights and
f32 scores. Tolerance, per doc and for grad and hess apart:
|port - JAX| <= 1e-5 * max(1, A_d), with A_d the doc's sum of absolute
pair terms from the oracle (the two sum a doc's terms in other orders,
and its net value can cancel); and the port no further from the oracle
than JAX plus that bound.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightgbm_tpu.config import Config as JConfig
from lightgbm_tpu.dataset import Metadata as JMetadata
from lightgbm_tpu.objectives import LambdarankNDCG as JLambdarank
from lightgbm_tpu_torch import LightGBMError
from lightgbm_tpu_torch.config import Config as TConfig
from lightgbm_tpu_torch.dataset import Metadata as TMetadata
from lightgbm_tpu_torch.objectives import LambdarankNDCG as TLambdarank
from lightgbm_tpu_torch.objectives import create_objective
from lightgbm_tpu_torch.ops import rank
from lightgbm_tpu_torch.testing.synth import mslr_like_groups

torch.set_num_threads(1)

DEFAULT_GAIN = [float((1 << i) - 1) for i in range(31)]


def _ragged(seed=3, nq=40, top=60):
    rng = np.random.RandomState(seed)
    sizes = rng.randint(0, top + 1, size=nq)
    n = int(sizes.sum())
    return rng, sizes, rng.randint(0, 5, size=n), rng.randn(n)


def case(name):
    """(sizes, labels, f32 scores, weights or None, params)."""
    params = {"objective": "lambdarank"}
    weights = None
    rng, sizes, labels, score = _ragged()
    if name == "long_query":
        sizes = np.array([7, 1250, 0, 3])
        labels = rng.randint(0, 5, size=int(sizes.sum()))
        score = rng.randn(len(labels))
    elif name == "iteration_zero":
        score = np.zeros(len(score))
    elif name == "tied_scores":
        # a tenth of a unit apart at most: many exact ties, and signed
        # zeros, which rank as equal
        score = np.round(score * 3) / 10.0
        score[score == 0] = rng.choice([0.0, -0.0], size=(score == 0).sum())
    elif name == "equal_labels":
        labels[:sizes[0] + sizes[1]] = 2
    elif name == "single_doc":
        sizes = np.concatenate([[1], sizes, [1]])
        labels = np.concatenate([[3], labels, [1]])
        score = np.concatenate([[0.5], score, [-1.0]])
    elif name == "empty_queries":
        sizes = np.concatenate([[0, 0], sizes[:10], [0], sizes[10:], [0]])
    elif name == "row_weights":
        weights = rng.uniform(0.2, 3.0, size=len(labels))
    elif name == "label_gain_max_position":
        params.update(label_gain=[0.0, 1.0, 2.5, 3.0, 20.0], max_position=3)
    elif name == "labels_above_30":
        labels = rng.randint(0, 41, size=len(labels))
    elif name == "mslr_shaped":
        # the first 60 queries of the MSLR-WEB30K-shaped layout: the
        # 1,251-doc query, empty and one-doc ones, labels mostly 0 and 1
        sizes, labels = mslr_like_groups(0)
        sizes = sizes[:60]
        labels = labels[:int(sizes.sum())]
        score = rng.randn(len(labels))
    elif name != "ragged":
        raise KeyError(name)
    return sizes, labels, score.astype(np.float32), weights, params


CASES = ["ragged", "long_query", "iteration_zero", "tied_scores",
         "equal_labels", "single_doc", "empty_queries", "row_weights",
         "label_gain_max_position", "labels_above_30", "mslr_shaped"]


def oracle(sizes, labels, score, weights, params):
    """The pair loop in float64 numpy, query by query: (grad, hess,
    A_grad, A_hess), A the sums of absolute pair terms a doc takes."""
    gains = np.asarray(params.get("label_gain", DEFAULT_GAIN), np.float64)
    max_pos = params.get("max_position", 20)
    qb = np.concatenate([[0], np.cumsum(sizes)])
    n = int(qb[-1])
    out = np.zeros((4, n))
    for q in range(len(sizes)):
        lo, hi = qb[q], qb[q + 1]
        if hi - lo < 2:
            continue
        s = score[lo:hi].astype(np.float64)
        lab = labels[lo:hi]
        gain = gains[np.clip(lab, 0, len(gains) - 1)]
        ideal = np.sort(gain)[::-1][:max_pos]
        dcg = np.sum(ideal / np.log2(np.arange(len(ideal)) + 2.0))
        inv = 1.0 / dcg if dcg > 0 else 0.0
        rank_ = np.empty(len(s), np.int64)
        rank_[np.argsort(-s, kind="stable")] = np.arange(len(s))
        disc = 1.0 / np.log2(rank_ + 2.0)
        ds = s[:, None] - s[None, :]
        delta = ((gain[:, None] - gain[None, :])
                 * np.abs(disc[:, None] - disc[None, :]) * inv)
        if s.max() != s.min():
            delta = delta / (0.01 + np.abs(ds))
        p = 2.0 / (1.0 + np.exp(2.0 * ds))
        valid = lab[:, None] > lab[None, :]
        lam = np.where(valid, -delta * p, 0.0)
        hp = np.where(valid, 2.0 * delta * p * (2.0 - p), 0.0)
        out[0, lo:hi] = lam.sum(1) - lam.sum(0)
        out[1, lo:hi] = hp.sum(1) + hp.sum(0)
        out[2, lo:hi] = np.abs(lam).sum(1) + np.abs(lam).sum(0)
        out[3, lo:hi] = np.abs(hp).sum(1) + np.abs(hp).sum(0)
    if weights is not None:
        out *= weights[None, :]
        out[2:] = np.abs(out[2:])
    return out


def both(sizes, labels, score, weights, params):
    """(JAX grad, hess), (port grad, hess) as f64 numpy."""
    n = len(labels)
    jmd, tmd = JMetadata(n), TMetadata(n)
    for md in (jmd, tmd):
        md.set_label(labels.astype(np.float32))
        md.set_group(sizes)
        md.set_weights(weights)
    jobj = JLambdarank(JConfig.from_params(params))
    jobj.init(jmd, n)
    jg, jh = jobj.get_gradients(jnp.asarray(score))
    tobj = create_objective(TConfig.from_params(params))
    tobj.init(tmd, n, torch.device("cpu"))
    tg, th = tobj.get_gradients(torch.from_numpy(score))
    return ((np.asarray(jg, np.float64), np.asarray(jh, np.float64)),
            (tg.numpy().astype(np.float64), th.numpy().astype(np.float64)))


@pytest.mark.parametrize("name", CASES)
def test_gradients_match_jax_and_the_f64_oracle(name):
    sizes, labels, score, weights, params = case(name)
    ref = oracle(sizes, labels, score, weights, params)
    jax_out, port = both(sizes, labels, score, weights, params)
    for k in (0, 1):
        tol = 1e-5 * np.maximum(1.0, ref[2 + k])
        assert np.all(np.abs(port[k] - jax_out[k]) <= tol), (name, k)
        assert np.all(np.abs(port[k] - ref[k])
                      <= np.abs(jax_out[k] - ref[k]) + tol), (name, k)
    assert np.all(np.isfinite(port[0])) and np.all(port[1] >= 0)
    qb = np.concatenate([[0], np.cumsum(sizes)])
    for q in np.nonzero(sizes <= 1)[0]:
        assert not port[0][qb[q]:qb[q + 1]].any()
    if name == "iteration_zero":
        # one big tie: the gradients are not all zero, the ranks follow
        # the docs' order
        assert np.abs(port[0]).max() > 0
    if name == "equal_labels":
        assert not port[0][:sizes[0] + sizes[1]].any()


def test_plain_version_takes_a_query_longer_than_its_pair_budget(
        monkeypatch):
    """The plain version pads each query to a power of two of at least
    16 docs and batches queries under PAIR_BUDGET; a query whose own
    padded pairs exceed the budget still gets its full pair set."""
    monkeypatch.setattr(rank, "PAIR_BUDGET", 32 * 32)
    sizes = np.array([5, 200, 40, 17, 33, 0, 1])
    rng = np.random.RandomState(4)
    labels = rng.randint(0, 5, size=int(sizes.sum()))
    score = rng.randn(len(labels)).astype(np.float32)
    params = {"objective": "lambdarank"}
    ref = oracle(sizes, labels, score, None, params)
    _, port = both(sizes, labels, score, None, params)
    for k in (0, 1):
        tol = 1e-5 * np.maximum(1.0, ref[2 + k])
        assert np.all(np.abs(port[k] - ref[k]) <= tol)


def test_mslr_shaped_layout():
    sizes, labels = mslr_like_groups(0)
    assert len(sizes) == 31_531 and sizes.max() == 1_251 == sizes[0]
    assert 3_700_000 < sizes.sum() == len(labels) < 3_850_000
    assert (sizes == 0).sum() == 3 and (sizes == 1).sum() >= 4
    share = np.bincount(labels, minlength=5) / len(labels)
    assert share[0] > 0.5 and share[:2].sum() > 0.8 and labels.max() == 4


def _inputs(n=10, nq=2):
    qb = torch.tensor([0, 4, n], dtype=torch.int32)[:nq + 1]
    return (torch.zeros(n), qb, torch.zeros(n, dtype=torch.int32),
            torch.zeros(n), torch.ones(nq))


@pytest.mark.parametrize("bad", ["label_shape", "inv_shape", "weights",
                                 "device"])
def test_the_wrapper_refuses_what_the_kernel_does_not_take(bad):
    score, qb, label, gain, inv = _inputs()
    weights = None
    if bad == "label_shape":
        label = label[:5]
    elif bad == "inv_shape":
        inv = torch.ones(3)
    elif bad == "weights":
        weights = torch.ones(4)
    else:
        score = score.to("meta")
    with pytest.raises(LightGBMError, match="lambdarank_grads"):
        rank.lambdarank_grads(score, qb, label, gain, inv, 1.0, weights)


def test_the_wrapper_runs_the_plain_version_on_cpu_tensors_uncounted():
    sizes, labels, score, _, params = case("ragged")
    tmd = TMetadata(len(labels))
    tmd.set_label(labels.astype(np.float32))
    tmd.set_group(sizes)
    obj = TLambdarank(TConfig.from_params(params))
    obj.init(tmd, len(labels), torch.device("cpu"))
    before = rank.lambdarank_grads.launches
    args = (torch.from_numpy(score), obj.query_boundaries, obj.label_int,
            obj.gain, obj.inv_max_dcg, obj.sigmoid)
    got = rank.lambdarank_grads(*args)
    plain = rank.lambdarank_grads_plain(*args)
    assert all(torch.equal(a, b) for a, b in zip(got, plain))
    assert rank.lambdarank_grads.launches == before


def test_objective_needs_query_information():
    md = TMetadata(4)
    md.set_label(np.array([1, 0, 2, 1], np.float32))
    obj = TLambdarank(TConfig.from_params({"objective": "lambdarank"}))
    with pytest.raises(LightGBMError,
                       match="Lambdarank tasks require query information"):
        obj.init(md, 4)
    with pytest.raises(LightGBMError, match="Sum of query counts"):
        md.set_group([1, 2])
