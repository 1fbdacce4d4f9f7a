"""Evaluation metrics for the training slice (host numpy, float64).

The port's copy of the regression and binary metrics of
`lightgbm_tpu/metrics.py` (reference: `src/metric/metric.cpp:11-46`,
regression_metric.hpp, binary_metric.hpp): `l2`, `rmse`,
`binary_logloss`, `binary_error` and `auc`. Scores arrive on the host;
the output transform runs through the port's objective in f32, as the
JAX package runs it through its own. Other metric names are refused by
name until their slice.
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


_METRICS = {
    "l2": L2Metric, "mse": L2Metric, "mean_squared_error": L2Metric,
    "regression": L2Metric, "regression_l2": L2Metric,
    "rmse": RMSEMetric, "l2_root": RMSEMetric,
    "root_mean_squared_error": RMSEMetric,
    "binary_logloss": BinaryLoglossMetric, "binary": BinaryLoglossMetric,
    "binary_error": BinaryErrorMetric,
    "auc": AUCMetric,
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
            "l2_root": "rmse"}.get(objective, "l2")
