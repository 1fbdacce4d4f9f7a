"""Kernel L's launch plan and the replay of its summation order
(lightgbm_tpu_torch/ops/rank.py `lambdarank_plan`,
`lambdarank_grads_order`), on the CPU at fixture scale.

The replay adds each doc's pair terms in the kernel's order: in index
order for a query of up to FIT_DOCS docs, by TILE-doc partner blocks
past that. It is held, per doc and for grad and hess apart, within
1e-5 * max(1, A_d) of the JAX package's bucketed gradients
(`_lambdarank_bucket_grads` through its `LambdarankNDCG`), of the plain
version and of a float64 oracle of the reference's pair loop, A_d the
doc's sum of absolute pair terms: the three sum a doc's terms in other
orders. Inputs are made with numpy from a seed.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightgbm_tpu.config import Config as JConfig
from lightgbm_tpu.dataset import Metadata as JMetadata
from lightgbm_tpu.objectives import LambdarankNDCG as JLambdarank
from lightgbm_tpu_torch.config import Config as TConfig
from lightgbm_tpu_torch.dataset import Metadata as TMetadata
from lightgbm_tpu_torch.objectives import LambdarankNDCG as TLambdarank
from lightgbm_tpu_torch.ops import rank
from lightgbm_tpu_torch.testing.synth import mslr_like_groups

torch.set_num_threads(1)

GAINS = np.array([float((1 << i) - 1) for i in range(31)])
#: the most dynamic shared memory a block takes on an H100
SMEM_LIMIT = 227 * 1024


def oracle(sizes, labels, score, weights):
    """The pair loop in float64 numpy: (grad, hess, A_grad, A_hess)."""
    qb = np.concatenate([[0], np.cumsum(sizes)])
    out = np.zeros((4, int(qb[-1])))
    for q in range(len(sizes)):
        lo, hi = qb[q], qb[q + 1]
        if hi - lo < 2:
            continue
        s = score[lo:hi].astype(np.float64)
        lab = labels[lo:hi]
        gain = GAINS[np.clip(lab, 0, 30)]
        ideal = np.sort(gain)[::-1][:20]
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


def case(name):
    """(sizes, labels, f32 scores, weights or None)."""
    rng = np.random.RandomState(11)
    sizes = rng.randint(2, 40, size=12)
    weights = None
    if name == "empty_one_doc_equal_scores":
        sizes = np.array([0, 1, 6, 0, 1, 9, 3])
    elif name == "tied_signed_zeros":
        sizes = np.array([30, 17, 64, 5])
    elif name == "past_the_pair_tile":
        sizes = np.array([128, 129, 200, 3, 300, 1])
    elif name == "mslr_longest_query":
        sizes, labels = mslr_like_groups(0)
        sizes = sizes[:9]
        labels = labels[:int(sizes.sum())]
    elif name == "row_weights":
        sizes = np.array([50, 140, 7])
        weights = rng.uniform(0.2, 3.0, size=int(sizes.sum()))
    elif name != "ragged":
        raise KeyError(name)
    n = int(sizes.sum())
    if name != "mslr_longest_query":
        labels = rng.randint(0, 5, size=n)
    score = rng.randn(n)
    if name == "empty_one_doc_equal_scores":
        qb = np.concatenate([[0], np.cumsum(sizes)])
        score[qb[2]:qb[3]] = 0.25     # a query of one score: norm false
        labels[qb[5]:qb[6]] = 1       # a query of one label: no pairs
    elif name == "tied_signed_zeros":
        score = np.round(score * 2) / 4.0
        zero = score == 0
        score[zero] = rng.choice([0.0, -0.0], size=zero.sum())
    return sizes, labels, score.astype(np.float32), weights


CASES = ["ragged", "empty_one_doc_equal_scores", "tied_signed_zeros",
         "past_the_pair_tile", "mslr_longest_query", "row_weights"]


def port_args(sizes, labels, score, weights):
    n = len(labels)
    md = TMetadata(n)
    md.set_label(labels.astype(np.float32))
    md.set_group(sizes)
    obj = TLambdarank(TConfig.from_params({"objective": "lambdarank"}))
    obj.init(md, n, torch.device("cpu"))
    return (torch.from_numpy(score), obj.query_boundaries, obj.label_int,
            obj.gain, obj.inv_max_dcg, obj.sigmoid,
            None if weights is None else torch.from_numpy(
                weights.astype(np.float32)))


def jax_grads(sizes, labels, score, weights):
    n = len(labels)
    md = JMetadata(n)
    md.set_label(labels.astype(np.float32))
    md.set_group(sizes)
    md.set_weights(None if weights is None else weights.astype(np.float32))
    obj = JLambdarank(JConfig.from_params({"objective": "lambdarank"}))
    obj.init(md, n)
    g, h = obj.get_gradients(jnp.asarray(score))
    return np.asarray(g, np.float64), np.asarray(h, np.float64)


@pytest.mark.parametrize("name", CASES)
def test_order_replay_matches_jax_plain_and_the_f64_oracle(name):
    sizes, labels, score, weights = case(name)
    w32 = None if weights is None else weights.astype(np.float32)
    ref = oracle(sizes, labels, score, w32)
    args = port_args(sizes, labels, score, weights)
    got = [t.numpy().astype(np.float64)
           for t in rank.lambdarank_grads_order(*args)]
    plain = [t.numpy().astype(np.float64)
             for t in rank.lambdarank_grads_plain(*args)]
    jax_out = jax_grads(sizes, labels, score, weights)
    for k in (0, 1):
        tol = 1e-5 * np.maximum(1.0, ref[2 + k])
        for other in (jax_out[k], plain[k], ref[k]):
            assert np.all(np.abs(got[k] - other) <= tol), (name, k)
    qb = np.concatenate([[0], np.cumsum(sizes)])
    for q in np.nonzero(sizes <= 1)[0]:
        assert not got[0][qb[q]:qb[q + 1]].any()
    if name == "empty_one_doc_equal_scores":
        assert np.abs(got[0][qb[2]:qb[3]]).max() > 0   # norm false, ranks
        assert not got[0][qb[5]:qb[6]].any()           # by index


@pytest.mark.parametrize("name", CASES)
def test_order_replay_repeats_its_bits(name):
    args = port_args(*case(name))
    one = rank.lambdarank_grads_order(*args)
    two = rank.lambdarank_grads_order(*args)
    assert all(torch.equal(a.view(torch.int32), b.view(torch.int32))
               for a, b in zip(one, two))


def test_a_fit_query_adds_its_terms_in_index_order():
    """A query of up to FIT_DOCS docs: each doc's f32 sum from 0 over the
    other docs in index order (the one-thread-a-doc loop), here summed
    one term at a time in numpy f32 from the replay's own pair terms."""
    sizes, labels, score, _ = case("ragged")
    args = port_args(sizes, labels, score, None)
    got = rank.lambdarank_grads_order(*args)
    n = int(sizes[0])
    lab = args[2][:n][None]
    term, hterm = rank._pair_terms(
        args[0][:n][None], lab, args[3][:n][None],
        torch.ones((1, n), dtype=torch.bool), args[4][:1],
        float(np.float32(2.0 * args[5])))
    for d in range(n):
        g = h = np.float32(0.0)
        for j in range(n):
            g = np.float32(g + term[0, d, j].numpy())
            h = np.float32(h + hterm[0, d, j].numpy())
        assert g.view(np.int32) == got[0][d].numpy().view(np.int32)
        assert h.view(np.int32) == got[1][d].numpy().view(np.int32)


def test_a_long_query_adds_tile_partials_in_block_order():
    """Past FIT_DOCS docs: a doc's partial over each TILE-doc block of
    partners in index order, then the partials in block order."""
    sizes, labels, score, _ = case("past_the_pair_tile")
    args = port_args(sizes, labels, score, None)
    got = rank.lambdarank_grads_order(*args)
    lo = int(sizes[0])
    n = int(sizes[1])                      # 129 docs: three blocks
    sl = slice(lo, lo + n)
    term, _ = rank._pair_terms(
        args[0][sl][None], args[2][sl][None], args[3][sl][None],
        torch.ones((1, n), dtype=torch.bool), args[4][1:2],
        float(np.float32(2.0 * args[5])))
    t = term[0].numpy()
    for d in (0, 64, 128):
        total = np.float32(0.0)
        for b0 in range(0, n, rank.TILE):
            part = np.float32(0.0)
            for j in range(b0, min(n, b0 + rank.TILE)):
                part = np.float32(part + t[d, j])
            total = np.float32(total + part)
        assert total.view(np.int32) == got[0][lo + d].numpy().view(np.int32)


LAYOUTS = {
    "protocol": np.full(5000, 100),
    "mslr": mslr_like_groups(0)[0],
    "long": np.array([4096 + 1000, 7, 4097, 300, 129, 0, 1, 128, 2]),
    "every_length": np.arange(0, 1400),
}


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_the_plan_covers_every_doc_once_within_shared_memory(layout):
    sizes = LAYOUTS[layout]
    qb = np.concatenate([[0], np.cumsum(sizes)])
    plan = rank.lambdarank_plan(qb)
    n = int(qb[-1])
    seen = np.zeros(n, np.int64)
    # fit blocks: whole queries of 1..FIT_DOCS docs, up to FIT_DOCS docs
    # a block, their slots' docs, pairs and M floats in order
    for s0, ns, nd, npairs, mf, q0, b0 in plan.fit_block.tolist():
        slots = plan.fit_slot[s0:s0 + ns]
        cnt = sizes[slots[:, 0]]
        assert q0 == slots[0, 0] and b0 == qb[q0]
        assert np.array_equal(slots[:, 1], qb[slots[:, 0]])
        assert np.array_equal(slots[:, 2], cnt)
        assert 1 <= cnt.min() and cnt.max() <= rank.FIT_DOCS
        assert nd == cnt.sum() <= rank.FIT_DOCS
        assert np.array_equal(slots[:, 3], np.cumsum(cnt) - cnt)
        assert np.array_equal(slots[:, 4],
                              np.cumsum(cnt * (cnt | 1)) - cnt * (cnt | 1))
        tri = cnt * (cnt - 1) // 2
        assert np.array_equal(slots[:, 5], np.cumsum(tri) - tri)
        assert npairs == tri.sum() and mf % 4 == 0
        assert mf >= (cnt * (cnt | 1)).sum()
        for q in slots[:, 0]:
            seen[qb[q]:qb[q + 1]] += 1
    # long queries: finish items a TILE-doc block each, every tile once
    assert np.all(sizes[plan.long_q[:, 0]] > rank.FIT_DOCS)
    for i, (q, doff, poff, first, c) in enumerate(plan.long_q.tolist()):
        assert first == qb[q] and c == sizes[q]
        nb = -(-sizes[q] // rank.TILE)
        fin = plan.finish[plan.finish[:, 0] == first]
        assert np.array_equal(fin[:, 2], np.arange(nb))
        assert np.all(fin[:, 1] == c) and np.all(fin[:, 3] == poff)
        til = plan.tiles[plan.tiles[:, 1] == i]
        assert np.all(til[:, [0, 2, 3, 6, 7]] == [q, first, c, doff, poff])
        til = til[:, 4:6]
        assert len(til) == nb * (nb + 1) // 2 and np.all(til[:, 0] <= til[:, 1])
        assert len({tuple(x) for x in til.tolist()}) == len(til)
        seen[qb[q]:qb[q + 1]] += 1
    assert np.array_equal(seen, np.ones(n, np.int64))
    # the longest work first
    assert np.all(np.diff(sizes[plan.long_q[:, 0]]) <= 0)
    first = sizes[plan.fit_slot[plan.fit_block[:, 0], 0]]
    assert np.all(np.diff(first) <= 0)
    for smem in (plan.fit_smem, plan.fit_smem_large, plan.rank_smem,
                 plan.tile_smem):
        assert smem <= SMEM_LIMIT
    # the large blocks first, launched apart; the rest five to an SM
    big = plan.fit_block[:, 4] > rank.SMALL_M
    assert not big[plan.n_large:].any() and big[:plan.n_large].all()
    assert 5 * (plan.fit_smem + 1024) <= 228 * 1024


def test_the_plan_ranks_past_the_stage_cap_by_counting(monkeypatch):
    """rank_kernel's shared memory holds the sort keys of the longest
    long query up to the stage cap; longer ones count instead."""
    monkeypatch.setattr(rank, "SORT_CAP", 256)
    sizes = np.array([300, 200, 129, 5])
    plan = rank.lambdarank_plan(np.concatenate([[0], np.cumsum(sizes)]))
    assert plan.rank_smem == 8 * 256
    plan = rank.lambdarank_plan(np.concatenate([[0], [0, 700]]))
    assert plan.rank_smem == 0 and len(plan.long_q) == 1


def test_the_protocol_is_one_query_a_block_at_five_blocks_an_sm():
    """The ranking protocol's 100-doc queries: one a fit block, and the
    block's shared memory lets five blocks share an SM (228 KB, 1 KB
    each reserved); tile blocks six."""
    plan = rank.lambdarank_plan(np.arange(0, 500_001, 100))
    assert len(plan.fit_block) == 5000 and len(plan.long_q) == 0
    assert np.all(plan.fit_block[:, 1] == 1)
    assert 5 * (plan.fit_smem + 1024) <= 228 * 1024
    assert 6 * (plan.tile_smem + 1024) <= 228 * 1024
