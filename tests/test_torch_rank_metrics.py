"""lightgbm_tpu_torch's NDCG and MAP metrics against the JAX package's.

Both take the same seeded labels, groups, row weights (so query
weights) and scores; each reported value must agree within 1e-9 (both
run in float64 numpy). Cases: several eval_at cut-offs, query weights,
empty and one-doc queries, queries with no relevant doc, tied scores,
and a custom label_gain.
"""
import numpy as np
import pytest
import torch

from lightgbm_tpu.config import Config as JConfig
from lightgbm_tpu.dataset import Metadata as JMetadata
from lightgbm_tpu.metrics import create_metric as jcreate
from lightgbm_tpu_torch import LightGBMError
from lightgbm_tpu_torch.config import Config as TConfig
from lightgbm_tpu_torch.dataset import Metadata as TMetadata
from lightgbm_tpu_torch.metrics import (create_metric as tcreate,
                                        default_metric_for_objective,
                                        query_layout, segment_sum)

torch.set_num_threads(1)


def case(name):
    """(sizes, labels, scores, weights, params)."""
    rng = np.random.RandomState(11)
    sizes = rng.randint(1, 40, size=30)
    params = {"objective": "lambdarank", "ndcg_eval_at": [1, 3, 5, 10]}
    weights = None
    n = int(sizes.sum())
    labels = rng.randint(0, 5, size=n)
    score = rng.randn(n)
    if name == "query_weights":
        weights = rng.uniform(0.1, 2.0, size=n)
    elif name == "empty_and_single":
        sizes = np.concatenate([[0, 1], sizes[:5], [0], sizes[5:], [1, 0]])
        n = int(sizes.sum())
        labels = rng.randint(0, 5, size=n)
        score = rng.randn(n)
    elif name == "no_relevant_doc":
        labels[:sizes[0] + sizes[1]] = 0
    elif name == "tied_scores":
        score = np.round(score)
    elif name == "label_gain":
        params["label_gain"] = [0.0, 2.0, 3.0, 10.0, 11.0]
    elif name == "eval_at_default":
        params.pop("ndcg_eval_at")
    elif name != "plain":
        raise KeyError(name)
    return sizes, labels.astype(np.float32), score, weights, params


CASES = ["plain", "query_weights", "empty_and_single", "no_relevant_doc",
         "tied_scores", "label_gain", "eval_at_default"]


@pytest.mark.parametrize("metric", ["ndcg", "map", "lambdarank",
                                    "mean_average_precision"])
@pytest.mark.parametrize("name", CASES)
def test_ranking_metrics_match_jax(metric, name):
    sizes, labels, score, weights, params = case(name)
    params = dict(params, metric=metric)
    out = []
    for cfg, md, create in (
            (JConfig.from_params(params), JMetadata(len(labels)), jcreate),
            (TConfig.from_params(params), TMetadata(len(labels)), tcreate)):
        md.set_label(labels)
        md.set_weights(weights)
        md.set_group(sizes)
        m = create(metric, cfg)
        m.init(md, len(labels))
        assert m.is_bigger_better
        out.append(m.eval(score, None))
    (ref, got) = out
    assert [k for k, _ in got] == [k for k, _ in ref]
    for (_, a), (_, b) in zip(ref, got):
        assert abs(a - b) <= 1e-9
    if weights is not None:
        bounds = np.concatenate([[0], np.cumsum(sizes)])
        assert np.allclose(md.query_weights,
                           [weights[lo:hi].mean() if hi > lo else 0.0
                            for lo, hi in zip(bounds[:-1], bounds[1:])])


def test_layout_helpers_tolerate_empty_queries():
    qb = np.array([0, 2, 2, 5, 5])
    qid, pos = query_layout(qb)
    assert qid.tolist() == [0, 0, 2, 2, 2]
    assert pos.tolist() == [0, 1, 0, 1, 2]
    assert segment_sum(np.arange(5.0), qb).tolist() == [1.0, 0.0, 9.0, 0.0]


def test_ranking_metrics_need_query_information():
    md = TMetadata(3)
    md.set_label(np.array([1.0, 0.0, 2.0], np.float32))
    cfg = TConfig.from_params({"objective": "lambdarank"})
    for name in ("ndcg", "map"):
        with pytest.raises(LightGBMError, match="requires query information"):
            tcreate(name, cfg).init(md, 3)
    assert default_metric_for_objective("lambdarank") == "ndcg"
