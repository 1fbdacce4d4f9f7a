"""Evaluation metrics (host numpy, float64).

The port's copy of the regression, binary and ranking metrics of
`lightgbm_tpu/metrics.py` (reference: `src/metric/metric.cpp:11-46`,
regression_metric.hpp, binary_metric.hpp, rank_metric.hpp,
map_metric.hpp): `l2`, `rmse`, `binary_logloss`, `binary_error`, `auc`,
`ndcg` and `map`. Scores arrive on the host; the output transform runs
through the port's objective in f32, as the JAX package runs it through
its own. Other metric names are refused by name until their slice.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from . import log
from .config import Config


class Metric:
    name: List[str] = []
    is_bigger_better = False

    def init(self, metadata, num_data: int) -> None:
        self.num_data = num_data
        self.label = None if metadata.label is None else \
            np.asarray(metadata.label, np.float64)
        self.weights = None if metadata.weights is None else \
            np.asarray(metadata.weights, np.float64)
        self.sum_weights = float(self.weights.sum()) \
            if self.weights is not None else float(num_data)

    def eval(self, score: np.ndarray, objective) -> List[Tuple[str, float]]:
        raise NotImplementedError

    def _avg(self, losses: np.ndarray) -> float:
        if self.weights is not None:
            return float(np.sum(losses * self.weights) / self.sum_weights)
        return float(np.mean(losses))


def _convert(score, objective) -> np.ndarray:
    """The objective's output transform on f32 scores (the JAX package
    converts through jnp, in f32)."""
    if objective is None:
        return np.asarray(score)
    raw = torch.from_numpy(np.asarray(score, np.float32))
    return objective.convert_output(raw).numpy()


class L2Metric(Metric):
    """reference: regression_metric.hpp (L2/MSE)."""

    def __init__(self, config=None):
        self.name = ["l2"]

    def eval(self, score, objective):
        pred = _convert(score, objective)
        return [(self.name[0], self._avg((self.label - pred) ** 2))]


class RMSEMetric(L2Metric):
    def __init__(self, config=None):
        self.name = ["rmse"]

    def eval(self, score, objective):
        pred = _convert(score, objective)
        return [(self.name[0],
                 float(np.sqrt(self._avg((self.label - pred) ** 2))))]


class BinaryLoglossMetric(Metric):
    """reference: binary_metric.hpp (log loss of the sigmoid probability)."""

    def __init__(self, config=None):
        self.name = ["binary_logloss"]

    def eval(self, score, objective):
        prob = _convert(score, objective)
        eps = 1e-15
        prob = np.clip(prob, eps, 1 - eps)
        is_pos = self.label > 0
        loss = np.where(is_pos, -np.log(prob), -np.log(1 - prob))
        return [(self.name[0], self._avg(loss))]


class BinaryErrorMetric(Metric):
    def __init__(self, config=None):
        self.name = ["binary_error"]

    def eval(self, score, objective):
        prob = _convert(score, objective)
        err = ((prob > 0.5) != (self.label > 0)).astype(np.float64)
        return [(self.name[0], self._avg(err))]


class AUCMetric(Metric):
    """reference: binary_metric.hpp:160-266 (weighted rank-sum AUC with
    ties split evenly)."""
    is_bigger_better = True

    def __init__(self, config=None):
        self.name = ["auc"]

    def eval(self, score, objective):
        # AUC is invariant under the monotone output transform
        score = np.asarray(score, np.float64)
        w = self.weights if self.weights is not None else np.ones_like(score)
        order = np.argsort(score, kind="mergesort")
        s, lab, ww = score[order], self.label[order], w[order]
        pos_w = np.where(lab > 0, ww, 0.0)
        neg_w = np.where(lab > 0, 0.0, ww)
        total_pos = pos_w.sum()
        total_neg = neg_w.sum()
        if total_pos == 0 or total_neg == 0:
            return [(self.name[0], 1.0)]
        _, idx_start = np.unique(s, return_index=True)
        grp_pos = np.add.reduceat(pos_w, idx_start)
        grp_neg = np.add.reduceat(neg_w, idx_start)
        cum_neg_before = np.concatenate([[0.0], np.cumsum(grp_neg)[:-1]])
        auc = np.sum(grp_pos * (cum_neg_before + 0.5 * grp_neg))
        return [(self.name[0], float(auc / (total_pos * total_neg)))]


def query_layout(qb: np.ndarray):
    """(qid, pos) row layout for query-contiguous arrays: qid[r] = query of
    row r, pos[r] = row r's offset inside its query. Tolerates zero-size
    queries (np.repeat skips them)."""
    sizes = np.diff(qb)
    qid = np.repeat(np.arange(len(sizes)), sizes)
    pos = np.arange(int(qb[-1])) - np.repeat(qb[:-1], sizes)
    return qid, pos


def segment_sum(arr: np.ndarray, qb: np.ndarray) -> np.ndarray:
    """Per-query sums of a query-contiguous array via exclusive-cumsum
    differences: unlike np.add.reduceat this is right for zero-size
    queries (their sum is 0) and for qb entries equal to len(arr)."""
    csum = np.concatenate([[0], np.cumsum(arr, dtype=np.float64)])
    return csum[qb[1:]] - csum[qb[:-1]]


class _RankMetric(Metric):
    """The query layout the ranking metrics share; `eval_at` from
    `ndcg_eval_at`."""
    is_bigger_better = True
    prefix = ""

    def __init__(self, config: Config):
        self.eval_at = list(config.metric.ndcg_eval_at) or [1, 2, 3, 4, 5]
        self.name = [f"{self.prefix}@{k}" for k in self.eval_at]

    def init(self, metadata, num_data):
        super().init(metadata, num_data)
        if metadata.query_boundaries is None:
            log.fatal("metric %s requires query information (a Dataset "
                      "with group=)" % self.prefix)
        self.query_boundaries = np.asarray(metadata.query_boundaries)
        self.query_weights = metadata.query_weights
        self._qid, self._pos = query_layout(self.query_boundaries)

    def _weighted_mean(self, results: np.ndarray) -> List[Tuple[str, float]]:
        nq = len(self.query_boundaries) - 1
        qw = self.query_weights if self.query_weights is not None \
            else np.ones(nq)
        sum_w = qw.sum()
        return [(self.name[ki], float(np.sum(results[ki] * qw) / sum_w))
                for ki in range(len(self.eval_at))]


class NDCGMetric(_RankMetric):
    """reference: rank_metric.hpp + dcg_calculator.cpp (NDCG at eval_at;
    lightgbm_tpu/metrics.py:263-320)."""
    prefix = "ndcg"

    def __init__(self, config: Config):
        super().__init__(config)
        gains = config.objective_config.label_gain or \
            [float((1 << i) - 1) for i in range(31)]
        self.label_gain = np.asarray(gains, np.float64)

    def init(self, metadata, num_data):
        super().init(metadata, num_data)
        qb = self.query_boundaries
        # everything score-independent once: per-row gains and
        # discounts, and the per-k max DCG (the label order is fixed)
        lab = np.asarray(metadata.label).astype(int)
        self._gain = self.label_gain[
            np.clip(lab, 0, len(self.label_gain) - 1)]
        self._disc = 1.0 / np.log2(self._pos + 2.0)
        by_label = np.lexsort((-lab, self._qid))
        self._max_dcg = {
            k: segment_sum(self._gain[by_label] * self._disc
                           * (self._pos < k), qb)
            for k in self.eval_at}

    def eval(self, score, objective):
        score = np.asarray(score, np.float64)
        qb = self.query_boundaries
        # rows sorted by (query, -score) stay query-contiguous, so DCG@k
        # is a per-query segment sum of masked discounted gains
        by_score = np.lexsort((-score, self._qid))
        gain_sorted = self._gain[by_score] * self._disc
        results = np.zeros((len(self.eval_at), len(qb) - 1))
        for ki, k in enumerate(self.eval_at):
            dcg = segment_sum(gain_sorted * (self._pos < k), qb)
            max_dcg = self._max_dcg[k]
            # a query with no positive doc counts as 1 (the reference's)
            results[ki] = np.where(max_dcg > 0,
                                   dcg / np.maximum(max_dcg, 1e-300), 1.0)
        return self._weighted_mean(results)


class MAPMetric(_RankMetric):
    """reference: map_metric.hpp (mean average precision at k;
    lightgbm_tpu/metrics.py:323-365)."""
    prefix = "map"

    def init(self, metadata, num_data):
        super().init(metadata, num_data)
        qb = self.query_boundaries
        self._rel_raw = (np.asarray(metadata.label) > 0).astype(np.float64)
        self._row_start = np.repeat(qb[:-1], np.diff(qb))

    def eval(self, score, objective):
        score = np.asarray(score, np.float64)
        qb = self.query_boundaries
        by_score = np.lexsort((-score, self._qid))
        rel = self._rel_raw[by_score]
        # the within-query running hit count: the inclusive cumsum less
        # the exclusive cumsum at the query's start
        excl = np.concatenate([[0.0], np.cumsum(rel)])
        hits = excl[1:] - excl[self._row_start]
        prec_rel = (hits / (self._pos + 1.0)) * rel
        results = np.zeros((len(self.eval_at), len(qb) - 1))
        for ki, k in enumerate(self.eval_at):
            at_k = self._pos < k
            ap_sum = segment_sum(prec_rel * at_k, qb)
            num_rel = segment_sum(rel * at_k, qb)
            # a query with no relevant doc in its top k counts as 0
            results[ki] = np.where(num_rel > 0,
                                   ap_sum / np.maximum(num_rel, 1e-300), 0.0)
        return self._weighted_mean(results)


_METRICS = {
    "l2": L2Metric, "mse": L2Metric, "mean_squared_error": L2Metric,
    "regression": L2Metric, "regression_l2": L2Metric,
    "rmse": RMSEMetric, "l2_root": RMSEMetric,
    "root_mean_squared_error": RMSEMetric,
    "binary_logloss": BinaryLoglossMetric, "binary": BinaryLoglossMetric,
    "binary_error": BinaryErrorMetric,
    "auc": AUCMetric,
    "ndcg": NDCGMetric, "lambdarank": NDCGMetric,
    "map": MAPMetric, "mean_average_precision": MAPMetric,
}


def create_metric(name: str, config: Optional[Config] = None
                  ) -> Optional[Metric]:
    """Factory (reference: Metric::CreateMetric, metric.cpp:11-46)."""
    name = name.strip().lower()
    if name in ("", "none", "null", "na"):
        return None
    if name not in _METRICS:
        log.fatal("metric %s is not ported to lightgbm_tpu_torch yet "
                  "(ported: %s)" % (name, ", ".join(sorted(_METRICS))))
    return _METRICS[name](config)


def default_metric_for_objective(objective: str) -> str:
    """The metric an unset `metric` implies (config.cpp)."""
    return {"binary": "binary_logloss", "rmse": "rmse",
            "l2_root": "rmse", "lambdarank": "ndcg"}.get(objective, "l2")
