"""Random forest mode.

Counterpart of `lightgbm_tpu/boosting/rf.py` (reference:
src/boosting/rf.hpp): bagged trees without shrinkage, every one grown
from the gradients of the zero score, computed once (rf.hpp:83-89) after
the boost-from-average bias the base init applied is taken off again;
each iteration draws a fresh bag (kernel M) and feature mask, and the
train and valid scores are the running average of the trees' values,
score = (score * t + tree) / (t + 1) (R's average mode, rf.py:87-96; a
valid set's values come from W into a zero buffer). The model text says
`tree` and `average_output`. Its refusals (no bagging, a
feature_fraction outside (0, 1)) are `refuse_unported_training`'s.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import log
from ..ops.predict import binned_tree, tree_value_walk_binned
from ..ops.route import score_average
from .gbdt import GBDT


class RF(GBDT):
    def __init__(self, config, device):
        super().__init__(config, device)
        self.average_output = True

    def model_name(self) -> str:
        return "tree"  # RF serialises as 'tree' with average_output

    def init(self, train_data, objective, metric_names=()) -> None:
        super().init(train_data, objective, metric_names)
        self.shrinkage_rate = 1.0
        # the gradients of the zero score (rf.py:37-53): the bias the
        # base init added comes off the scores again
        if self.init_score_bias != 0.0:
            self._score -= self.init_score_bias
            self.init_score_bias = 0.0
        self._pending_bias = 0.0
        zero = torch.zeros(self._n, dtype=torch.float32, device=self.device)
        self._rf_grad, self._rf_hess = objective.get_gradients(zero)
        self._check_gradients(self._rf_grad, self._rf_hess)

    def train_one_iter(self) -> bool:
        """rf.py:62-106: one tree on a fresh bag and feature mask, its
        values averaged into the train and valid scores."""
        grad, hess = self._rf_grad, self._rf_hess
        weight = self._bagging_weights(self.iter_, grad, hess)
        state, tree = self._grow_tree(grad, hess, weight,
                                      self._feature_mask())
        t = self.iter_
        if tree.num_leaves > 1:
            values = torch.from_numpy(
                tree.leaf_value.astype(np.float32)).to(self.device)
            score_average(self._score[0], state.leaf_id, values, t)
            bt = binned_tree(tree, self.device)
            for vi, vb in enumerate(self._valid_binned):
                vadd = torch.zeros(vb.shape[0], dtype=torch.float32,
                                   device=self.device)
                tree_value_walk_binned(bt, vb, vadd)
                score_average(self._valid_score[vi][0], None, vadd, t)
        self.models.append(tree)
        self._bump_model_version()
        self.iter_ += 1
        if tree.num_leaves <= 1:
            self.models.pop()
            self.iter_ -= 1
            log.warning("Stopped training: no more valid splits")
            return True
        return False
